"""multinn_torch.utils.profiling on the CPU, as tests/test_profiling.py
pins the JAX package's: ``force`` accepts any tree and leaves its values
as they were, ``timeit`` returns positive times, ``StepTimer`` laps and
rates. The CUDA-event paths run in tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import torch

from multinn_torch.utils.profiling import StepTimer, force, timeit


@dataclasses.dataclass
class _State:
    h: torch.Tensor
    rest: tuple


def test_force_accepts_any_tree():
    force(None)
    force({})
    force(torch.tensor(1.5))
    force((torch.zeros(3), {"a": torch.ones(100, 7),
                            "b": [torch.arange(4)]}))
    force(_State(h=torch.ones(2), rest=(None, [torch.zeros(1)])))
    # numpy leaves (already on the host) pass through
    force({"x": np.ones(5)})


def test_force_does_not_mutate_result():
    x = torch.eye(8)
    out = (x @ x, x.sum())
    force(out)
    assert float(out[1]) == 8.0
    np.testing.assert_allclose(out[0].numpy(), np.eye(8))


def test_timeit_returns_positive_times():
    r = timeit(lambda x: x @ x, torch.eye(16), iters=3, warmup=1)
    assert r["iters"] == 3
    assert 0 < r["min_s"] <= r["mean_s"]


def test_step_timer_laps_and_rate():
    t = StepTimer()
    t.start()
    out = torch.ones(4) * 2.0
    dt = t.lap(out)
    assert dt > 0
    t.lap(out)
    assert t.mean > 0 and t.rate(10.0) > 0
