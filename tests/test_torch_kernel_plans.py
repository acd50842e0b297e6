"""The launch plans of the Gibbs chain, the NADE likelihood kernels and the
NADE sampler (ops/gibbs_cuda.launch_plan, ops/nade_ll.fwd_plan and
bwd_plan, ops/nade_cuda.sample_plan) and the arguments their wrappers hand
the ops, checked on the CPU: the ops are replaced by a recorder, so nothing
is built or launched."""

import contextlib
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from multinn_torch.ops import (_build, gibbs_cuda, nade_cuda,  # noqa: E402
                               nade_ll, sampling)

H100_SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "multinn_torch" / "csrc"


@pytest.mark.parametrize("n,plan", [
    (1, (1, 256, 8, 1)), (8, (1, 256, 8, 1)), (13, (1, 256, 8, 1)),
    (396, (1, 256, 8, 1)),               # three rows per SM: still latency
    (397, (8, 256, 1, 1)), (528, (8, 256, 1, 1)), (1024, (8, 256, 1, 1)),
    (1040, (8, 256, 1, 1)),
    (2096, (8, 256, 1, 1)),
    (2097, (16, 256, 1, 1)),             # 132 CTAs of 16 rows: every SM
    (4096, (16, 256, 1, 1)), (4109, (16, 256, 1, 1))])
def test_gibbs_launch_plan(n, plan):
    """(rows per CTA, threads, lanes per dot, W in shared memory) at the
    flagship's D=84, H=150: the scan path's 8 rows one per CTA with 8 lanes
    per dot; CD-1 (N=1024) one row per warp; the k=25 chain (N=4096) 2 rows
    per warp, 256 CTAs; W always in shared memory."""
    assert gibbs_cuda.launch_plan(n, H100_SMS, 84, 150) == plan
    rows, threads, lanes, w_smem = plan
    assert threads % 32 == 0 and lanes in (1, 8) and w_smem == 1
    if lanes == 1:
        assert rows % (threads // 32) == 0
        assert rows // (threads // 32) in (1, 2)


@pytest.mark.parametrize("n,d,h,plan", [
    (8, 84, 600, (1, 256, 8, 1)),       # latency: 216,608 bytes still fit
    (64, 84, 600, (1, 256, 8, 1)),
    (1024, 84, 600, (8, 256, 1, 1)),    # one row a warp: 223,824 bytes fit
    (4096, 84, 600, (16, 256, 1, 0)),   # two rows a warp: W to L2
    (2097, 84, 600, (16, 256, 1, 0)),
    (1, 168, 400, (8, 256, 1, 0)),      # W alone is 269,472 bytes
    (8, 168, 400, (8, 256, 1, 0)),
    (4096, 168, 400, (16, 256, 1, 0)),
    (8, 84, 566, (1, 256, 8, 1)),       # the old limits still fit
    (2000, 84, 540, (8, 256, 1, 1))])
def test_gibbs_plan_keeps_w_in_device_memory_beyond_shared_memory(n, d, h,
                                                                  plan):
    """Where W at its pitch and the plan's rows exceed a CTA's 227 KB, the
    throughput plan with W in device memory: nothing the reference runs is
    refused for want of shared memory."""
    assert gibbs_cuda.launch_plan(n, H100_SMS, d, h) == plan
    assert gibbs_cuda.plan_smem_bytes(plan, d, h) <= 227 * 1024
    if plan[3] == 0:
        smem_plan = (gibbs_cuda.LATENCY_PLAN if n <= 3 * H100_SMS
                     else plan[:3] + (1,))
        assert gibbs_cuda.plan_smem_bytes(smem_plan, d, h) > 227 * 1024


def test_gibbs_plan_counts_the_launchers_bytes_and_raises_beyond():
    """The Python count follows the launcher's (csrc/gibbs_chain.cu); rows
    that do not fit even without W raise before any launch."""
    src = (CSRC / "gibbs_chain.cu").read_text()
    assert "round4(di)) * w_pitch(hi) : 0" in src
    assert "(round4(di) + round4(hi))" in src
    assert gibbs_cuda.plan_smem_bytes((16, 256, 1, 1), 84, 150) == 4 * (
        84 * 153 + 16 * (84 + 152))
    with pytest.raises(ValueError, match="227 KB"):
        gibbs_cuda.launch_plan(4096, H100_SMS, 2000, 2000)


@pytest.mark.parametrize("k,n,ctas", [
    (5, 4096, 52),       # the training shape: 2 CTAs per SM, 264 slots
    (1, 4096, 128),      # one track: every tile its own CTA
    (5, 40, 2),          # fewer tiles than slots
    (5, 1037, 33),       # 33 ragged tiles
    (8, 100000, 33)])
def test_nade_ll_bwd_plan(k, n, ctas):
    assert nade_ll.bwd_plan(k, n, 84, 150, H100_SMS) == (ctas, 150)


def test_nade_ll_bwd_plan_counts_the_kernels_shared_memory():
    """Two CTAs of the flagship's 114,848 bytes fit an SM's 228 KB; a
    wider model's accumulators leave room for one."""
    assert nade_ll.bwd_plan(1, 10 ** 6, 84, 150, 1) == (2, 150)
    assert nade_ll.bwd_plan(1, 10 ** 6, 88, 200, 1) == (1, 200)
    assert nade_ll.bwd_smem_bytes(84, 150) == 114848
    src = (CSRC / "nade_ll.cu").read_text()
    assert "round4(2 * d * chunk)" in src and "sizeof(uint32_t) * 2" in src


@pytest.mark.parametrize("d,h,ctas,chunk", [
    (84, 150, 52, 150),     # the flagship: one chunk, as before
    (84, 600, 13, 300),     # 608 threads and 403 KB: two chunks of 300
    (420, 150, 8, 50),      # the joint width: three chunks of 50 lanes
    (84, 1024, 6, 256),     # four chunks of 256
    (420, 1024, 1, 49)])
def test_nade_ll_bwd_splits_h_into_chunks(d, h, ctas, chunk):
    """The fewest H chunks whose lanes fit 512 threads and whose dV / dW
    accumulators fit a CTA's 227 KB; G fills the card once over the tracks
    and chunks."""
    assert nade_ll.bwd_plan(5, 4096, d, h, H100_SMS) == (ctas, chunk)
    assert chunk <= 512 and nade_ll.bwd_smem_bytes(d, chunk) <= 227 * 1024
    n_chunks = -(-h // chunk)
    if n_chunks > 1:
        bigger = -(-h // (n_chunks - 1))
        assert (bigger > 512
                or nade_ll.bwd_smem_bytes(d, bigger) > 227 * 1024)


@pytest.mark.parametrize("k,n,d,h,plan", [
    (5, 4096, 84, 150, (79, 150)),    # 3 CTAs of 160 threads an SM
    (1, 4096, 84, 150, (128, 150)),   # one track: every tile its own CTA
    (5, 777, 84, 31, (25, 31)),       # ragged: 25 tiles
    (5, 4096, 84, 600, (17, 200)),    # three chunks of 200 lanes
    (5, 4096, 420, 150, (79, 150)),   # the joint width: D costs 8 B a dim
    (5, 4096, 420, 1024, (13, 256)),
    (1, 40, 2000, 150, (2, 150))])
def test_nade_ll_fwd_plan(k, n, d, h, plan):
    """The forward's persistent grid: H in the fewest chunks of at most 256
    lanes; as many CTAs an SM as threads, registers (128 a thread, the
    kernel's launch bound) and shared memory allow; one wave over the
    tracks and chunks, no more than a track's tiles."""
    assert nade_ll.fwd_plan(k, n, d, h, H100_SMS) == plan
    assert nade_ll.fwd_smem_bytes(84, 150) == 4 * 2 * 5 * 32 * 32 + 8 * 84
    src = (CSRC / "nade_ll.cu").read_text()
    assert "__launch_bounds__(kFwdMaxLanes, 2)" in src
    assert nade_ll.FWD_REGS * nade_ll.FWD_MAX_LANES * 2 <= 65536


class _Recorder:
    """Stands in for torch.ops.multinn_torch: records each op's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def op(*args):
            self.calls[name] = args
        return op


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "ops", lambda: rec)
    monkeypatch.setattr(_build, "sm_count", lambda x: H100_SMS)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return rec


def test_nade_ll_bwd_partials_follow_the_plan(recorder):
    """The per-CTA partials are (K, G, D, H) = (5, 52, 84, 150) at the
    training shape, not (K, tiles, D, H) = (5, 128, 84, 150)."""
    k, n, d, h = 5, 4096, 84, 150
    x = torch.zeros(k, n, d)
    w = torch.zeros(k, d, h)
    nade_ll.nade_ll_bwd(x, w, w, x, torch.zeros(k, n, h), want_dx=False)
    dw, dv, dx, dbh, dwp, dvp = recorder.calls["nade_ll_bwd"][:6]
    assert dwp.shape == dvp.shape == (k, 52, d, h)
    assert dw.shape == dv.shape == (k, d, h)
    assert dx.numel() == 0 and dbh.shape == (k, n, h)


@pytest.mark.parametrize("n", [8, 1024, 4096])
def test_gibbs_op_takes_no_transpose(recorder, n):
    """The op reads W (D, H) as given: no W^T argument and no copy of W;
    the launch plan follows the arguments, and the default row map is the
    launch's own rows (0, n, n)."""
    w = torch.randn(84, 150)
    v0 = torch.zeros(n, 84)
    gibbs_cuda.gibbs_chain(sampling.PRNGKey(0), v0, w, torch.zeros(84),
                           torch.zeros(150), 3)
    out, v0_2d, w_arg, bv, bh, seeds, k, bb, *row_map, plan0, plan1, \
        plan2, plan3, stream = recorder.calls["gibbs_chain"]
    plan = (plan0, plan1, plan2, plan3)
    assert w_arg.data_ptr() == w.data_ptr() and w_arg.shape == (84, 150)
    assert tuple(plan) == gibbs_cuda.launch_plan(n, H100_SMS, 84, 150)
    assert (k, bb) == (3, gibbs_cuda.block_rows(n, 84, 150))
    assert tuple(row_map) == (0, n, n)
    assert bv.shape == (n, 84) and bh.shape == (n, 150)
    schema = re.search(r'm\.def\("gibbs_chain\(([^;]*?)\) -> \(\)"\)',
                       (CSRC / "ops.cpp").read_text().replace('"\n        "',
                                                              ""))
    assert schema and "wt" not in schema.group(1)
    assert "wt" not in (CSRC / "launchers.h").read_text().split(
        "launch_gibbs_chain(")[1].split(";")[0]


@pytest.mark.parametrize("n,d,h", [(4096, 84, 600), (8, 168, 400)])
def test_gibbs_device_memory_plan_reaches_the_op(recorder, n, d, h):
    """Beyond shared memory the wrapper launches the device-memory plan
    (never a plain version): the op gets W and the plan with w_smem 0."""
    w = torch.randn(d, h)
    gibbs_cuda.gibbs_chain(sampling.PRNGKey(0), torch.zeros(n, d), w,
                           torch.zeros(d), torch.zeros(h), 2)
    *_, rows, threads, lanes, w_smem, stream = recorder.calls["gibbs_chain"]
    assert (lanes, w_smem) == (1, 0)


@pytest.mark.parametrize("d,h,chunks", [(84, 150, 1), (84, 600, 3),
                                        (84, 1024, 4)])
def test_nade_ll_fwd_args_follow_the_plan(recorder, d, h, chunks):
    """The op gets the plan's CTAs and chunk, and (chunks, K, N, D)
    partial logits only where H is split."""
    k, n = 5, 300
    x = torch.zeros(k, n, d)
    w = torch.zeros(k, d, h)
    nade_ll.nade_ll_fwd(x, w, w, x, torch.zeros(k, n, h))
    logits, a_end, part, *_, ctas, chunk, stream = (
        recorder.calls["nade_ll_fwd"])
    assert (ctas, chunk) == nade_ll.fwd_plan(k, n, d, h, H100_SMS)
    assert -(-h // chunk) == chunks
    assert part.shape == ((chunks, k, n, d) if chunks > 1 else (0,))
    assert logits.shape == (k, n, d) and a_end.shape == (k, n, h)


@pytest.mark.parametrize("want_dx", [True, False])
@pytest.mark.parametrize("d,h", [(84, 150), (84, 600), (420, 150)])
def test_nade_ll_bwd_args_follow_the_chunks(recorder, d, h, want_dx):
    """(K, G, D, H) partials of dW / dV whatever the chunks; dx through
    (chunks, K, N, D) partials only where H is split and dx is wanted."""
    k, n = 5, 300
    x = torch.zeros(k, n, d)
    w = torch.zeros(k, d, h)
    nade_ll.nade_ll_bwd(x, w, w, x, torch.zeros(k, n, h), want_dx=want_dx)
    dw, dv, dx, dbh, dwp, dvp, dxp, *_, chunk, stream = (
        recorder.calls["nade_ll_bwd"])
    ctas, want_chunk = nade_ll.bwd_plan(k, n, d, h, H100_SMS)
    n_chunks = -(-h // chunk)
    assert chunk == want_chunk and dwp.shape == (k, ctas, d, h)
    assert dx.shape == ((k, n, d) if want_dx else (0,))
    assert dxp.shape == ((n_chunks, k, n, d) if want_dx and n_chunks > 1
                         else (0,))


def test_nade_ll_raises_before_launch_beyond_the_plans(recorder):
    """D=2000 needs 320 KB of the backward's shared memory even at one
    hidden lane: a ValueError naming the limit, before the op is called;
    the forward's partials and masks still fit, so it runs."""
    k, n, d, h = 1, 40, 2000, 150
    x = torch.zeros(k, n, d)
    w = torch.zeros(k, d, h)
    with pytest.raises(ValueError, match="227 KB"):
        nade_ll.nade_ll_bwd(x, w, w, x, torch.zeros(k, n, h))
    assert "nade_ll_bwd" not in recorder.calls
    nade_ll.nade_ll_fwd(x, w, w, x, torch.zeros(k, n, h))
    assert "nade_ll_fwd" in recorder.calls
    with pytest.raises(ValueError, match="227 KB"):
        nade_ll.fwd_plan(1, 40, 40000, 150, H100_SMS)


@pytest.mark.parametrize("d,h,plan", [
    (84, 150, 1),             # the flagship: W and V staged (100.8 KB)
    (168, 150, 1),            # 201.6 KB staged
    (168, 400, 0),            # W and V are 537.6 KB: read from L2
    (84, 600, 0),
    (420, 1024, 0)])
def test_nade_sample_plan(d, h, plan):
    """Staged 1 / 0: one CTA a row; W and V in shared memory where they fit
    beside the row's state and are 16-byte aligned, else from L2."""
    assert nade_cuda.sample_plan(d, h) == plan
    assert nade_cuda.sample_plan(d, h, aligned=False) == 0
    assert nade_cuda.sample_smem_bytes(d, h, plan) <= 227 * 1024
    if not plan:
        assert nade_cuda.sample_smem_bytes(d, h, True) > 227 * 1024
    assert nade_cuda.sample_smem_bytes(84, 150, True) == 4 * (
        44 + 2 * 84 * 150 + 2 * 160 + 2 * 84 + 8)
    src = (CSRC / "nade_sample.cu").read_text()
    assert "barrier_floats(d) + 2 * round4(d * h)" in src


def test_nade_sample_args_follow_the_plan(recorder):
    """The op gets the rows, the plan, the stream's key words and the
    default row map (0, rows); a shape whose one row does not fit raises
    before any launch."""
    w = torch.randn(84, 150)
    nade_cuda.nade_sample(sampling.PRNGKey(0), w, w, torch.zeros(84),
                          torch.zeros(150), (16, 5))
    out, w_arg, v_arg, bv, bh, seeds, staged, row0, total, stream = (
        recorder.calls["nade_sample"])
    assert out.shape == bv.shape == (80, 84) and bh.shape == (80, 150)
    assert staged == nade_cuda.sample_plan(84, 150) == 1
    assert (row0, total) == (0, 80)
    recorder.calls.clear()
    with pytest.raises(ValueError, match="227 KB"):
        nade_cuda.nade_sample(sampling.PRNGKey(0), torch.zeros(30000, 2),
                              torch.zeros(30000, 2), torch.zeros(30000),
                              torch.zeros(2), (1,))
    assert not recorder.calls


def test_nade_sample_misaligned_weights_read_from_l2(recorder):
    """W one float into its storage is not 16-byte aligned: the wrapper
    plans the L2 path itself, so the plan it hands the op is the one that
    runs (the launcher refuses a staged plan on such a W)."""
    w = torch.randn(84 * 150 + 1)[1:].view(84, 150)
    assert w.data_ptr() % 16
    nade_cuda.nade_sample(sampling.PRNGKey(0), w, w.clone(), torch.zeros(84),
                          torch.zeros(150), (4,))
    assert recorder.calls["nade_sample"][6] == 0
    src = (CSRC / "nade_sample.cu").read_text()
    assert "a staged plan needs W and V 16-byte aligned" in src


@pytest.mark.parametrize("d,spec,want", [
    (84, None, 0),          # auto: the launcher resolves it
    (84, 4, 4), (84, 2, 2), (84, 1, 1),
    (42, None, 0), (42, 2, 2),
    (21, None, 0), (21, 1, 1)])
def test_nade_wrapper_hands_the_op_the_resolved_depth(recorder, monkeypatch,
                                                      d, spec, want):
    """generate_nade on the CPU through the CUDA path, with the op replaced
    by the recorder: an explicit depth is handed on as asked, None as 0,
    the launcher's auto depth, and no launch plan is queried."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import gen_fused_nade
    monkeypatch.setattr(_build, "impl_for", lambda impl, x: "cuda")
    cfg = multinn.MultINNConfig(n_tracks=5, n_pitches=d, mode="feedback",
                                decoder_type="rnn-nade", n_hidden=150,
                                n_rnn=100)
    params = multinn.init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    st = multinn.init_state(params, 2)
    gen_fused_nade.generate_nade(
        sampling.PRNGKey(0), params.decoder,
        torch.stack([c.h for c in st.decoder.cell]),
        torch.stack([c.c for c in st.decoder.cell]), st.decoder.v_prev, 2,
        spec=spec)
    *_, lstm, got, mask, row0, total, stream = recorder.calls[
        "gen_fused_nade"]
    assert (got, lstm, mask, row0, total) == (want, 1, 0, 0, 2)
    assert set(recorder.calls) == {"gen_fused_nade"}


# -- the cell stack's samples sliced per thread (gen_common.block_slices) -----

def test_block_slices_constants_are_the_kernels():
    """gen_common's mirror of the slicing rule reads the kernel's constants:
    the CTA's threads and the most samples a thread blocks."""
    from multinn_torch.ops import gen_common
    src = (CSRC / "gen_cluster.cuh").read_text()
    assert f"constexpr int kThreads = {gen_common.THREADS};" in src
    assert f"constexpr int kMaxBlock = {gen_common.MAX_BLOCK};" in src


@pytest.mark.parametrize("ns,outputs,want", [
    (1, 400, 1), (2, 400, 1), (6, 400, 1),       # the flagship's gates
    (7, 400, 2), (12, 400, 2), (13, 400, 3),     # at most 6 a slice
    (1, 234, 1), (2, 234, 2), (3, 234, 2),       # #2's biases (D + H)
    (12, 234, 2), (13, 234, 3),
    (4, 32, 4), (20, 32, 16),                    # narrow cells fill
    (5, 800, 1), (13, 800, 3),                   # two track slots
    (7, 0, 7)])
def test_block_slices(ns, outputs, want):
    from multinn_torch.ops import gen_common
    assert gen_common.block_slices(ns, outputs) == want


def _flagship_plan(batch, k=5, clusters=22, s_max=14):
    """The fields of gen_fused_plan for a launch of ``batch`` (the launcher's
    rule: S = ceil(B / the clusters the card holds) within s_max)."""
    c = min(k, 8)
    s = max(1, min(s_max, -(-batch // clusters)))
    return (c, -(-k // c), 7, 0, 0, s_max, s, -(-batch // s), clusters)


def _walk_cell_stack(plan, batch, k, g):
    """(rows, reads) of one layer and step, walked as the kernels' threads
    walk them: every CTA's items (slice, track slot, gate) of
    gates_sliced, or its (sample, gate) items where the slices are its
    samples; a read of a track's Wh is one (slice, track slot) at gate 0."""
    from multinn_torch.ops import gen_common
    c, s, grid = plan[0], plan[6], plan[7]
    rows = reads = 0
    seen = set()
    for cl in range(grid):
        ns = min(s, batch - cl * s)
        for r in range(c):
            ntr = (k - r + c - 1) // c
            slices = gen_common.block_slices(ns, ntr * g)
            for o in range(slices * ntr * g):
                sl, gg = divmod(o, g)
                sl, j = divmod(sl, ntr)
                s0, s1 = sl * ns // slices, (sl + 1) * ns // slices
                assert 1 <= s1 - s0 <= gen_common.MAX_BLOCK
                if gg == 0:
                    reads += 1
                    rows += s1 - s0
                    seen.update((cl * s + b, r + j * c)
                                for b in range(s0, s1))
    assert seen == {(b, t) for b in range(batch) for t in range(k)}
    return rows, reads


@pytest.mark.parametrize("batch", [1, 8, 22, 23, 96, 128, 256, 300])
@pytest.mark.parametrize("k,g", [(5, 400), (5, 100), (1, 400), (10, 400),
                                 (3, 16)])
def test_cell_stack_covers_each_sample_and_track_once(batch, k, g):
    """The kernels' walk of their cell-stack items under a launch's plan
    (LSTM and vanilla gates of the flagship, one track, two track slots a
    CTA, a tiny width) computes every (sample, track) once, in slices of
    at most MAX_BLOCK samples; at B=256 of the flagship a read of Wh
    serves 5.95 samples (the plan's 12 a cluster in two slices, the last
    cluster's 4 in one), at B <= 22 one."""
    plan = _flagship_plan(batch, k)
    rows, reads = _walk_cell_stack(plan, batch, k, g)
    assert rows == batch * k
    if (k, g, batch) == (5, 400, 256):
        assert (rows, reads) == (1280, 215)
    if batch <= 22 and g == 400:
        assert reads == rows


@pytest.mark.parametrize("family,bf16", [("rnn-rbm", False),
                                         ("rnn-rbm", True),
                                         ("rnn-nade", False),
                                         ("rnn-nade", True)])
def test_wrappers_launch_alike_while_the_card_is_timed(recorder, monkeypatch,
                                                       family, bf16):
    """generate_rbm / generate_nade on the CPU through the CUDA path, the
    ops replaced by the recorder: with the span recorder on and timing the
    card they make the same op call, with the same arguments, as with it
    off, and query no launch plan."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import gen_fused_nade, gen_fused_rbm
    from multinn_torch.utils import profiling
    nade = family == "rnn-nade"
    op = "gen_fused_nade" if nade else "gen_fused_rbm"
    asked = []
    recorder.gen_fused_plan = lambda *a: asked.append(a)
    monkeypatch.setattr(_build, "impl_for", lambda impl, x: "cuda")
    cfg = multinn.MultINNConfig(n_tracks=5, n_pitches=84, mode="feedback",
                                decoder_type=family, n_hidden=150,
                                n_rnn=100, rnn_layers=2)
    params = multinn.init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    st = multinn.init_state(params, 3)
    args = (sampling.PRNGKey(0), params.decoder,
            torch.stack([c.h for c in st.decoder.cell]),
            torch.stack([c.c for c in st.decoder.cell]), st.decoder.v_prev,
            6)
    dtype = torch.bfloat16 if bf16 else torch.float32

    def launch():
        if nade:
            gen_fused_nade.generate_nade(*args, aux_dtype=dtype)
        else:
            gen_fused_rbm.generate_rbm(*args, 10, wdtype=dtype)
        return recorder.calls.pop(op)

    off = launch()
    profiling.enable("cpu")
    monkeypatch.setattr(profiling, "card_timing", lambda device: True)
    try:
        on = launch()
    finally:
        profiling.collect()
    assert len(off) == len(on)
    for i, (a, b) in enumerate(zip(off, on)):
        if i < 3:                        # roll, h_out, c_out: unwritten
            assert (a.shape, a.dtype) == (b.shape, b.dtype)
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), i
        else:
            assert a == b, i
    assert not asked and not recorder.calls
