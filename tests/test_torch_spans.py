"""The spans multinn_torch records inside its service and trainer
(utils/profiling), on the CPU: every batch of a GenerationService gives
``serve.take``, ``serve.inflight`` and ``serve.dispatch`` on the
dispatcher's thread and ``serve.drain`` around ``serve.drain.wait``,
``.fetch``, ``.finalize`` and ``.resolve`` on the drainer's, identified by
the batch index its requests carry, with a request's ``queue_s`` the take's
end less its enqueue; a group of ``Trainer.run_group``, eager or through
the graph path (a recorder in place of the CUDA graph), gives
``train.run_group`` around ``train.pin`` and ``train.replay``, identified
by the group count. Nothing is recorded while the recorder is off. The
card's intervals (``serve.card``, ``train.card``) are checked on the card,
in tests/test_torch_cuda.py."""

import collections
import itertools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import sampling  # noqa: E402
from multinn_torch.serving import service  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.utils import config, profiling  # noqa: E402
from torch_mesh_ranks import RecorderGraph  # noqa: E402

torch.set_num_threads(1)
K, D = 2, 24
MODEL = dict(n_tracks=K, n_pitches=D, mode="feedback", n_hidden=6, n_rnn=4,
             cd_k=1, gen_k=2, w_std=0.5)
DATA = dict(dataset="synthetic", n_tracks=K, pitch_min=48,
            pitch_max=48 + D - 1, window=6, batch_size=3, synthetic_songs=6,
            synthetic_steps=20, transpose_range=2)
DRAIN = ("serve.drain.wait", "serve.drain.fetch", "serve.drain.finalize",
         "serve.drain.resolve")


@pytest.fixture
def spans_off():
    """The recorder left off, and emptied, after the test."""
    yield
    profiling.collect()


def _service(decoder):
    cfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**dict(MODEL, decoder_type=decoder)),
        data=config.DataConfig(n_tracks=K, pitch_min=48,
                               pitch_max=48 + D - 1),
        generate=config.GenerateConfig(n_steps=4))
    params = multinn.init(cfg.model, torch.Generator().manual_seed(3),
                          device="cpu")
    return service.GenerationService(cfg, params, service.ServeConfig(
        batch=2, n_steps=4, max_wait_ms=1.0, seed=7))


@pytest.mark.parametrize("decoder", ["rnn-rbm", "rnn-nade"])
def test_service_spans_of_every_batch(decoder, spans_off):
    svc = _service(decoder)
    try:
        profiling.enable()
        res = [f.result(timeout=120) for f in svc.submit_many(5)]
    finally:
        svc.close()                       # the drain has recorded it all
    spans = profiling.collect()
    by = collections.defaultdict(dict)
    for s in spans:
        assert s.name not in by[s.ident], (s.name, s.ident)
        by[s.ident][s.name] = s
    batches = sorted({r.batch_index for r in res})
    assert sorted(by) == batches and len(batches) >= 3
    for bi in batches:
        b = by[bi]
        assert set(b) == {"serve.take", "serve.inflight", "serve.dispatch",
                          "serve.drain", *DRAIN}       # no card on the CPU
        take, room, disp = (b["serve.take"], b["serve.inflight"],
                            b["serve.dispatch"])
        assert take.thread == disp.thread == "multinn-serve-dispatch"
        assert take.start_ns <= room.start_ns <= room.end_ns <= take.end_ns
        assert take.end_ns == disp.start_ns <= disp.end_ns
        drain = b["serve.drain"]
        assert drain.thread == "multinn-serve-drain"
        assert disp.end_ns <= drain.start_ns
        t = drain.start_ns
        for name in DRAIN:                 # in order, inside the drain
            s = b[name]
            assert (s.ident, s.parent, s.thread) == (bi, bi, drain.thread)
            assert t <= s.start_ns <= s.end_ns <= drain.end_ns, name
            t = s.end_ns
    for r in res:
        take = by[r.batch_index]["serve.take"]
        # the take ends at the dispatch: enqueue -> take end is queue_s
        assert r.queue_s <= (take.end_ns - take.start_ns) / 1e9 + 2e-6
        if r.row == 0:                   # the batch's oldest request
            assert abs(r.queue_s - (take.end_ns - take.start_ns) / 1e9) \
                < 2e-6


class _Stream:
    """A stand-in for the service's CUDA stream on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)


class _Event:
    """A timing event that reads a counter where a CUDA event reads the
    card's clock."""
    tick = itertools.count()

    def __init__(self, enable_timing=False):
        self.ms = None

    def record(self, stream=None):
        self.ms = float(next(self.tick))

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


@pytest.mark.parametrize("anchored,cards", [
    (None, False), ("cuda:1", False), ("cuda:0", True)])
def test_service_times_the_card_only_where_anchored(monkeypatch, spans_off,
                                                   anchored, cards):
    """A service whose stream is on cuda:0 (a stand-in, on the CPU) with
    the recorder enabled off the card, anchored on another card, or on
    its own: every request is served either way, and only the last gives
    each batch a ``serve.card``. Before this gate, the first two made
    timing events and failed every batch."""
    svc = _service("rnn-rbm")
    svc._stream = _Stream("cuda:0")
    try:
        profiling.enable(device="cpu")
        if anchored is not None:          # as enable() on that card
            monkeypatch.setattr(torch.cuda, "Event", _Event)
            first = _Event()
            first.record()
            profiling.recorder._device = torch.device(anchored)
            profiling.recorder._anchors = [(first, time.time_ns())]
        res = [f.result(timeout=120) for f in svc.submit_many(5)]
    finally:
        svc.close()
    spans = profiling.collect()
    assert svc.stats()["errors"] == 0
    got = {s.ident for s in spans if s.name == "serve.card"}
    want = {r.batch_index for r in res}
    assert got == (want if cards else set())
    assert {s.ident for s in spans if s.name == "serve.take"} == want


def test_service_records_nothing_while_off():
    svc = _service("rnn-rbm")
    try:
        for f in svc.submit_many(3):
            f.result(timeout=120)
    finally:
        svc.close()
    assert not profiling.recorder.on
    assert profiling.collect() == []


def _trainer(run_dir, steps_per_call=2):
    cfg = config.ExperimentConfig(
        name="spans", data=config.DataConfig(**DATA),
        model=multinn.MultINNConfig(**MODEL),
        train=config.TrainConfig(
            epochs=1, lr=3e-3, seed=5, steps_per_call=steps_per_call,
            log_every_steps=2, ckpt_every_steps=0,
            run_dir=str(run_dir))).validate()
    return trainer.Trainer(cfg, device="cpu")


def _group_spans(spans, n_groups):
    groups = [s for s in spans if s.name == "train.run_group"]
    assert [s.ident for s in groups] == list(range(n_groups))
    for g in groups:
        kids = [s for s in spans if s.parent == g.ident]
        assert [s.name for s in kids] == ["train.pin", "train.replay"]
        assert g.start_ns <= kids[0].start_ns <= kids[0].end_ns \
            <= kids[1].start_ns <= kids[1].end_ns <= g.end_ns
        assert all(s.ident == g.ident for s in kids)
    assert len(spans) == 3 * n_groups


@pytest.mark.parametrize("graph", [False, True])
def test_run_group_spans(tmp_path, graph, spans_off):
    tr = _trainer(tmp_path)
    if graph:                              # the graph path, without a card
        tr.capture_groups = True
        tr._new_graph = RecorderGraph
    batches = list(tr.dataset.batches("train", epoch=0))
    stacked = np.stack(batches[:2])
    key = sampling.PRNGKey(9)
    tr.run_group(stacked, key)            # graph: the capture, unrecorded
    profiling.enable()
    for i in range(3):
        tr.run_group(stacked, sampling.fold_in(key, i))
    spans = profiling.collect()
    assert tr.groups_run == 4
    _group_spans([s._replace(ident=s.ident - 1,
                             parent=None if s.parent is None
                             else s.parent - 1) for s in spans], 3)
    tr.run_group(stacked, key)
    assert profiling.collect() == []      # off again after collect()
    tr.close()

