"""Grid-free NADE exact-likelihood logits: the CUDA kernels
(csrc/nade_ll.cu), their plain PyTorch versions and the autograd Function
that binds them — port of multinn_tpu/ops/nade_ll_pallas.py.

    forward   per dim i:  h = sigmoid(a);  logit_i = bv_i + V_i . h;
                          a += x_i W_i                 (a starts at bh)
    backward  one reverse sweep from the saved a_D:
              a_i = a_{i+1} - x_i W_i;  h = sigmoid(a_i)
              dV_i = sum_n g_i h;  dW_i = sum_n x_i r;  dx_i = W_i . r
              r += (V_i g_i) h (1 - h);                dbh = r at the end

Neither direction builds the (N, D, H) activation grid of the parallel
forms (nn/nade.py): the forward saves only a_D, an (N, H) residual, and the
backward recovers each h_i by downdating it. Downdating adds up to D ulps
of a relative to the forward's accumulation; that is the contract that
makes a_D the only residual, and it stays far inside the gradient
tolerance.

The kernels' layout is row-major and track-stacked: x, bv, logits
(K, N, D); bh, a_D (K, N, H); w, v (K, D, H). One launch covers every
track, where the JAX package vmaps the Pallas kernel over tracks, on a
persistent grid whose plan (``fwd_plan``, ``bwd_plan``) splits H into
chunks where a CTA's threads or shared memory need it; a shape no plan can
launch raises a ValueError before any launch. The plain
versions are the same sequential dim loops in torch ops (not autograd of
the cumsum form) and take float64 too, for gradcheck.
"""

from __future__ import annotations

import torch

from multinn_torch.ops import _build

TILE_ROWS = 32     # rows per tile of csrc/nade_ll.cu (one per warp lane)
FWD_MAX_LANES = 256   # forward: hidden lanes per CTA (an H chunk)
BWD_MAX_LANES = 512   # backward: hidden lanes per CTA
FWD_DIMS = 32         # forward: dims per block of warp partials
FWD_REGS = 128        # forward: registers a thread (__launch_bounds__)
# an H100 SM: shared memory, the part reserved per CTA, resident threads and
# registers; a CTA's dynamic shared memory
_SM_SMEM_BYTES = 228 * 1024
_CTA_RESERVED_BYTES = 1024
_SM_THREADS = 2048
_SM_REGS = 65536
CTA_SMEM_LIMIT = 227 * 1024


def _threads(lanes: int) -> int:
    return -(-lanes // 32) * 32


def fwd_smem_bytes(d: int, chunk: int) -> int:
    """csrc/nade_ll.cu fwd_smem_bytes: two blocks of the warps' partials
    and the two x masks per dim."""
    return 4 * 2 * (_threads(chunk) // 32) * FWD_DIMS * TILE_ROWS + 8 * d


def bwd_smem_bytes(d: int, chunk: int) -> int:
    """csrc/nade_ll.cu bwd_smem_bytes: the dV and dW accumulators of the
    chunk's lanes, the tile's g, the row-sum buffer, the x masks."""
    return 4 * (-(-2 * d * chunk // 4) * 4 + (TILE_ROWS + 4) * d
                + 2 * (_threads(chunk) // 32) * TILE_ROWS + 2 * d)


def _chunk(h: int, d: int, max_lanes: int, smem, name: str) -> int:
    """The fewest H chunks whose lanes fit a CTA's threads and whose bytes
    fit its shared memory: the lanes per chunk, or a ValueError before any
    launch when even one lane a CTA does not fit."""
    for n_chunks in range(-(-h // max_lanes), h + 1):
        chunk = -(-h // n_chunks)
        if smem(d, chunk) <= CTA_SMEM_LIMIT:
            return chunk
    raise ValueError(
        f"{name}: D={d}, H={h} needs {smem(d, 1)} bytes of shared memory a "
        f"CTA even with one hidden lane, over the card's {CTA_SMEM_LIMIT} "
        f"(227 KB) limit")


def _grid(k, n, h, chunk, per_sm, sm_count) -> tuple[int, int]:
    """(CTAs per track and chunk, chunk): one wave of the card's resident
    CTA slots across the k tracks and chunks, no more than a track's
    tiles."""
    n_chunks = -(-h // chunk)
    ctas = per_sm * sm_count // (k * n_chunks)
    return max(1, min(-(-n // TILE_ROWS), ctas)), chunk


def fwd_plan(k: int, n: int, d: int, h: int,
             sm_count: int) -> tuple[int, int]:
    """The forward's persistent grid: (CTAs G per track and H chunk, lanes
    per chunk). H is split into the fewest chunks of at most 256 lanes; an
    SM holds as many CTAs as its threads, registers (FWD_REGS a thread) and
    shared memory allow, and G fills the card once."""
    chunk = _chunk(h, d, FWD_MAX_LANES, fwd_smem_bytes, "nade_ll_fwd")
    threads = _threads(chunk)
    per_sm = max(1, min(_SM_THREADS // threads,
                        _SM_REGS // (FWD_REGS * threads),
                        _SM_SMEM_BYTES // (fwd_smem_bytes(d, chunk)
                                           + _CTA_RESERVED_BYTES)))
    return _grid(k, n, h, chunk, per_sm, sm_count)


def bwd_plan(k: int, n: int, d: int, h: int,
             sm_count: int) -> tuple[int, int]:
    """The backward's persistent grid: (CTAs G per track and H chunk, lanes
    per chunk). H is split into the fewest chunks whose lanes fit 512
    threads and whose dV / dW accumulators fit a CTA's shared memory (the
    reverse sweep is independent per lane; only dx sums across chunks, in
    a second pass); G fills the card's resident CTA slots once across the
    tracks and chunks (a CTA's shared memory sets how many fit an SM), but
    no more than a track's tiles."""
    chunk = _chunk(h, d, BWD_MAX_LANES, bwd_smem_bytes, "nade_ll_bwd")
    per_sm = max(1, min(_SM_THREADS // _threads(chunk),
                        _SM_SMEM_BYTES // (bwd_smem_bytes(d, chunk)
                                           + _CTA_RESERVED_BYTES)))
    return _grid(k, n, h, chunk, per_sm, sm_count)


def nade_ll_fwd_plain(x, w, v, bv, bh):
    """Teacher-forced logits (K, N, D) and the final activation a_D
    (K, N, H), by the sequential dim loop."""
    a = bh
    cols = []
    for i in range(w.shape[1]):
        h = torch.sigmoid(a)
        cols.append(bv[..., i] + torch.bmm(h, v[:, i, :, None])[..., 0])
        a = a + x[..., i, None] * w[:, None, i, :]
    return torch.stack(cols, dim=-1), a


def nade_ll_bwd_plain(x, w, v, g, a_end, want_dx: bool = True):
    """The reverse sweep: (dw, dv (K, D, H), dx (K, N, D) or None,
    dbh (K, N, H)) for the cotangent g (K, N, D) of the logits."""
    a, r = a_end, torch.zeros_like(a_end)
    dws, dvs, dxs = [], [], []
    for i in reversed(range(w.shape[1])):
        x_i, g_i = x[..., i], g[..., i]                   # (K, N)
        a = a - x_i[..., None] * w[:, None, i, :]         # a = a_i
        h = torch.sigmoid(a)
        dvs.append(torch.bmm(g_i[:, None, :], h)[:, 0])
        dws.append(torch.bmm(x_i[:, None, :], r)[:, 0])
        if want_dx:
            dxs.append(torch.bmm(r, w[:, i, :, None])[..., 0])
        r = r + (v[:, None, i, :] * g_i[..., None]) * (h - h * h)
    flip = lambda xs, dim: torch.stack(xs[::-1], dim=dim)
    return (flip(dws, 1), flip(dvs, 1),
            flip(dxs, -1) if want_dx else None, r)


def nade_ll_fwd(x, w, v, bv, bh):
    """The forward kernel on the card: float32 CUDA tensors in the layout
    above. Returns (logits, a_D)."""
    k, n, d = x.shape
    ctas, chunk = fwd_plan(k, n, d, w.shape[-1], _build.sm_count(x))
    n_chunks = -(-w.shape[-1] // chunk)
    logits, a_end = torch.empty_like(x), torch.empty_like(bh)
    part = x.new_empty((n_chunks, k, n, d) if n_chunks > 1 else 0)
    with torch.cuda.device(x.device):
        _build.launches["nade_ll_fwd"] += 1
        _build.ops().nade_ll_fwd(logits, a_end, part, x, w, v, bv, bh, ctas,
                                 chunk, _build.stream_of(x))
    return logits, a_end


def nade_ll_bwd(x, w, v, g, a_end, want_dx: bool = True):
    """The backward kernel on the card. Each of its G CTAs per track and H
    chunk sums dW and dV over its tiles; the (K, G, D, H) partials are
    summed over the CTAs in order by a second pass, and dx over the chunks
    in order by a third where there are several, so the result is
    deterministic (no float atomics). Its sigmoid is the card's exp2 and
    reciprocal estimates (a few ulp), well inside the gradients'
    tolerance."""
    k, n, d = x.shape
    h = w.shape[-1]
    ctas, chunk = bwd_plan(k, n, d, h, _build.sm_count(x))
    n_chunks = -(-h // chunk)
    dwp = x.new_empty((k, ctas, *w.shape[1:]))
    dvp = torch.empty_like(dwp)
    dw, dv = torch.empty_like(w), torch.empty_like(v)
    dx = torch.empty_like(x) if want_dx else x.new_empty(0)
    dxp = x.new_empty((n_chunks, k, n, d) if want_dx and n_chunks > 1 else 0)
    dbh = torch.empty_like(a_end)
    with torch.cuda.device(x.device):
        _build.launches["nade_ll_bwd"] += 1
        _build.ops().nade_ll_bwd(dw, dv, dx, dbh, dwp, dvp, dxp, x, w, v, g,
                                 a_end, chunk, _build.stream_of(x))
    return dw, dv, (dx if want_dx else None), dbh


def _unbroadcast(grad: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a full-shape cotangent to a broadcast input's shape: sum the
    prepended dims, then the size-1 dims."""
    extra = grad.dim() - len(shape)
    if extra:
        grad = grad.sum(dim=tuple(range(extra)))
    keep = tuple(ax for ax, s in enumerate(shape) if s == 1)
    if keep:
        grad = grad.sum(dim=keep, keepdim=True)
    return grad.reshape(shape)


class NadeLogits(torch.autograd.Function):
    """Teacher-forced NADE logits with the grid-free backward.

    x (..., D) with w, v (D, H), or x (K, ..., D) with track-stacked w, v
    (K, D, H); bv / bh broadcast against x's shape (..., D) / (..., H).
    ``impl`` "cuda" launches the kernels, "plain" runs their plain
    versions."""

    @staticmethod
    def forward(ctx, x, w, v, bv, bh, impl):
        d, h = w.shape[-2:]
        w3, v3 = (w, v) if w.dim() == 3 else (w[None], v[None])
        k = w3.shape[0]
        x3 = x.reshape(k, -1, d).contiguous()
        bv3 = bv.expand(x.shape).reshape(k, -1, d).contiguous()
        bh3 = bh.expand(*x.shape[:-1], h).reshape(k, -1, h).contiguous()
        w3, v3 = w3.contiguous(), v3.contiguous()
        fwd = nade_ll_fwd if impl == "cuda" else nade_ll_fwd_plain
        logits, a_end = fwd(x3, w3, v3, bv3, bh3)
        ctx.save_for_backward(x3, w3, v3, a_end)
        ctx.meta = (impl, x.shape, w.shape, bv.shape, bh.shape)
        return logits.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x3, w3, v3, a_end = ctx.saved_tensors
        impl, x_shape, w_shape, bv_shape, bh_shape = ctx.meta
        need = ctx.needs_input_grad
        bwd = nade_ll_bwd if impl == "cuda" else nade_ll_bwd_plain
        dw, dv, dx, dbh = bwd(x3, w3, v3, g.reshape(x3.shape).contiguous(),
                              a_end, want_dx=need[0])
        return (dx.reshape(x_shape) if need[0] else None,
                dw.reshape(w_shape) if need[1] else None,
                dv.reshape(w_shape) if need[2] else None,
                _unbroadcast(g, bv_shape) if need[3] else None,
                _unbroadcast(dbh.reshape(*x_shape[:-1], w_shape[-1]),
                             bh_shape) if need[4] else None,
                None)


def nade_logits(x, w, v, bv, bh, impl=None) -> torch.Tensor:
    """All D teacher-forced conditional logits (..., D), grid-free: the
    kernels for CUDA tensors, their plain versions for CPU tensors
    (``impl`` forces one). Reverse-mode differentiable."""
    return NadeLogits.apply(x, w, v, bv, bh, _build.impl_for(impl, x))
