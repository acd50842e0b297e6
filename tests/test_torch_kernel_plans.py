"""The launch plans of the Gibbs chain and of the NADE likelihood backward
(ops/gibbs_cuda.launch_plan, ops/nade_ll.bwd_plan) and the arguments their
wrappers hand the ops, checked on the CPU: the ops are replaced by a
recorder, so nothing is built or launched."""

import contextlib
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from multinn_torch.ops import (_build, gibbs_cuda, nade_ll,  # noqa: E402
                               sampling)

H100_SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "multinn_torch" / "csrc"


@pytest.mark.parametrize("n,plan", [
    (1, (1, 256, 8)), (8, (1, 256, 8)), (13, (1, 256, 8)),
    (396, (1, 256, 8)),                  # three rows per SM: still latency
    (397, (8, 256, 1)), (528, (8, 256, 1)), (1024, (8, 256, 1)),
    (1040, (8, 256, 1)),
    (2096, (8, 256, 1)),
    (2097, (16, 256, 1)),                # 132 CTAs of 16 rows: every SM
    (4096, (16, 256, 1)), (4109, (16, 256, 1))])
def test_gibbs_launch_plan(n, plan):
    """(rows per CTA, threads, lanes per dot): the scan path's 8 rows one
    per CTA with 8 lanes per dot; CD-1 (N=1024) one row per warp; the k=25
    chain (N=4096) 2 rows per warp, 256 CTAs."""
    assert gibbs_cuda.launch_plan(n, H100_SMS) == plan
    rows, threads, lanes = plan
    assert threads % 32 == 0 and lanes in (1, 8)
    if lanes == 1:
        assert rows % (threads // 32) == 0
        assert rows // (threads // 32) in (1, 2)


@pytest.mark.parametrize("k,n,ctas", [
    (5, 4096, 52),       # the training shape: 2 CTAs per SM, 264 slots
    (1, 4096, 128),      # one track: every tile its own CTA
    (5, 40, 2),          # fewer tiles than slots
    (5, 1037, 33),       # 33 ragged tiles
    (8, 100000, 33)])
def test_nade_ll_bwd_plan(k, n, ctas):
    assert nade_ll.bwd_plan(k, n, 84, 150, H100_SMS) == ctas


def test_nade_ll_bwd_plan_counts_the_kernels_shared_memory():
    """Two CTAs of the flagship's 114,848 bytes fit an SM's 228 KB; a
    wider model's accumulators leave room for one."""
    assert nade_ll.bwd_plan(1, 10 ** 6, 84, 150, 1) == 2
    assert nade_ll.bwd_plan(1, 10 ** 6, 88, 200, 1) == 1
    src = (CSRC / "nade_ll.cu").read_text()
    assert "round4(2 * d * h)" in src and "sizeof(uint32_t) * 2" in src


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
    the launch plan follows the arguments."""
    w = torch.randn(84, 150)
    v0 = torch.zeros(n, 84)
    gibbs_cuda.gibbs_chain(sampling.PRNGKey(0), v0, w, torch.zeros(84),
                           torch.zeros(150), 3)
    out, v0_2d, w_arg, bv, bh, seeds, k, bb, *plan, stream = (
        recorder.calls["gibbs_chain"])
    assert w_arg.data_ptr() == w.data_ptr() and w_arg.shape == (84, 150)
    assert tuple(plan) == gibbs_cuda.launch_plan(n, H100_SMS)
    assert (k, bb) == (3, gibbs_cuda.block_rows(n, 84, 150))
    assert bv.shape == (n, 84) and bh.shape == (n, 150)
    schema = re.search(r'm\.def\("gibbs_chain\(([^;]*?)\) -> \(\)"\)',
                       (CSRC / "ops.cpp").read_text().replace('"\n        "',
                                                              ""))
    assert schema and "wt" not in schema.group(1)
    assert "wt" not in (CSRC / "launchers.h").read_text().split(
        "launch_gibbs_chain(")[1].split(";")[0]
