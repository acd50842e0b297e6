"""``portbench/spans.py``, the report of multinn_torch's own spans over a
run of a benchmark cell, on the CPU: its reductions on synthetic spans
(the card's wait and the drain per batch, late batches, the card's gaps
by host span, a group's card and host time), and whole runs of the
benchmark's tiny cells with the recorder on and off."""

import numpy as np
import pytest

pytest.importorskip("torch")

from multinn_torch.utils.profiling import Span  # noqa: E402
from portbench import spans as report  # noqa: E402
from portbench.tests.conftest import _tiny_copy  # noqa: E402

MS = 1_000_000


def _s(name, a, b, ident, thread, parent=None):
    return Span(name, int(a * MS), int(b * MS), ident, parent, thread)


def _batch(i, t_take, dispatch_end, card, resolve_end):
    return [_s("serve.take", t_take - 1, t_take, i, "d"),
            _s("serve.dispatch", t_take, dispatch_end, i, "d"),
            _s("serve.card", card[0], card[1], i, "card"),
            _s("serve.drain", card[1], resolve_end, i, "r"),
            _s("serve.drain.resolve", resolve_end - 1, resolve_end, i, "r",
               i)]


def _serve_spans():
    return (_batch(0, 1, 2, (2, 12), 16)
            + _batch(1, 3, 4, (12.01, 22), 25)       # 10 us after: on time
            + _batch(2, 13, 14, (23, 33), 40)        # 1 ms after: late
            + [_s("serve.inflight", 21, 23.2, 2, "d", 2),
               _s("serve.drain.fetch", 22.5, 24, 1, "r", 1),
               _s("warm-up", 0, 50, None, "main")])  # no batch: left out


def test_serve_numbers_per_batch():
    out = report.serve_numbers(_serve_spans())
    assert (out["batches"], out["timed_batches"]) == (3, 3)
    assert out["card_wait_p50_ms"] == pytest.approx(8.01)
    assert out["drain_p95_ms"] == pytest.approx(np.percentile([4, 3, 7], 95))
    assert out["late_batch_share"] == pytest.approx(50.0)
    # 22 -> 23 ms: the warm-up, the inflight wait and batch 1's drain
    # cover it all, the shortest of them wins; 12 -> 12.01: batch 2's
    # take, shorter than batch 0's drain and the warm-up
    gaps = out["card_gaps_ms"]
    assert list(gaps) == ["d/serve.inflight", "d/serve.take"]
    assert gaps == pytest.approx({"d/serve.inflight": 1.0,
                                  "d/serve.take": 0.01})
    assert out["lengths"]["serve.card"]["n"] == 3
    assert "warm-up" not in out["lengths"]


def test_serve_gaps_go_to_the_longest_overlap():
    cards = [s for s in _serve_spans() if s.name == "serve.card"]
    host = [_s("serve.drain.fetch", 22.5, 24, 1, "r"),     # 0.5 ms of it
            _s("short", 22, 22.3, None, "d")]               # 0.3 ms
    gaps = report.card_gaps(cards + host, cards)
    assert gaps == pytest.approx({"r/serve.drain.fetch": 1.0,
                                  report.NO_SPAN: 0.01})


def test_serve_numbers_keep_the_window():
    out = report.serve_numbers(_serve_spans(), window=(0, 5 * MS))
    assert (out["batches"], out["timed_batches"]) == (2, 2)
    assert out["late_batch_share"] == 0.0
    assert out["card_wait_p50_ms"] == pytest.approx((0 + 8.01) / 2)


def test_serve_numbers_without_the_card():
    spans = [s for s in _serve_spans() if s.thread != "card"]
    out = report.serve_numbers(spans)
    assert (out["batches"], out["timed_batches"]) == (3, 0)
    assert "card_wait_p50_ms" not in out and "card_gaps_ms" not in out


def test_train_numbers_leave_out_the_capture():
    spans = []
    for g, (host, card) in enumerate([(5000, 1000), (2, 120), (3, 121),
                                      (4, 143)]):
        t = 200 * g
        spans += [_s("train.run_group", t, t + host, g, "main"),
                  _s("train.pin", t, t + 1, g, "main", g),
                  _s("train.card", t + 1, t + 1 + card, g, "card", g)]
    out = report.train_numbers(spans)
    assert out["groups"] == 3
    assert out["group_card_ms_p50"] == pytest.approx(121)
    assert out["run_group_host_ms"] == pytest.approx(3)
    assert out["lengths"]["train.pin"]["n"] == 3
    assert report.train_numbers(spans, skip=0)["groups"] == 4


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return _tiny_copy(tmp_path_factory.mktemp("tiny"))


SEED = 2 ** 31 + 5


@pytest.mark.parametrize("cell", ["tiny_rbm.serve", "tiny_rbm.train"])
def test_a_run_with_the_recorder(tiny_root, cell):
    out = report.report(cell, SEED, 1.5, True, device="cpu", root=tiny_root)
    assert out["correct"] and out["recorder"]
    assert "setup_s" in out["metrics"]
    spans = out["spans"]
    if cell.endswith("serve"):
        assert spans["batches"] > 0 and spans["timed_batches"] == 0
        assert {"serve.take", "serve.inflight", "serve.dispatch",
                "serve.drain", "serve.drain.wait", "serve.drain.fetch",
                "serve.drain.finalize",
                "serve.drain.resolve"} == set(spans["lengths"])
    else:
        assert spans["groups"] > 0 and spans["run_group_host_ms"] > 0
        assert {"train.run_group", "train.pin",
                "train.replay"} == set(spans["lengths"])
    from multinn_torch.utils import profiling
    assert not profiling.recorder.on


def test_a_run_without_the_recorder(tiny_root):
    out = report.report("tiny_nade.serve", SEED, 1.0, False, device="cpu",
                        root=tiny_root)
    assert out["correct"] and not out["recorder"] and "spans" not in out
    from multinn_torch.utils import profiling
    assert profiling.collect() == []


def test_a_cell_on_a_mesh_is_refused(tiny_root):
    with pytest.raises(ValueError, match="mesh"):
        report.report("tiny_rbm.train_data4", SEED, 1.0, True, device="cpu",
                      root=tiny_root)
