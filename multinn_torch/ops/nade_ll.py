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
track, where the JAX package vmaps the Pallas kernel over tracks. The plain
versions are the same sequential dim loops in torch ops (not autograd of
the cumsum form) and take float64 too, for gradcheck.
"""

from __future__ import annotations

import torch

from multinn_torch.ops import _build

TILE_ROWS = 32     # rows per tile of csrc/nade_ll.cu (one per warp lane)
# an H100 SM: shared memory, the part reserved per CTA, resident threads
_SM_SMEM_BYTES = 228 * 1024
_CTA_RESERVED_BYTES = 1024
_SM_THREADS = 2048


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
    logits, a_end = torch.empty_like(x), torch.empty_like(bh)
    with torch.cuda.device(x.device):
        _build.launches["nade_ll_fwd"] += 1
        _build.ops().nade_ll_fwd(logits, a_end, x, w, v, bv, bh,
                                 _build.stream_of(x))
    return logits, a_end


def bwd_plan(k: int, n: int, d: int, h: int, sm_count: int) -> int:
    """CTAs per track G of the backward's persistent grid: as many as fill
    the card's resident CTA slots once across the k tracks (a CTA's shared
    memory, csrc/nade_ll.cu bwd_smem_bytes, sets how many fit on an SM),
    but no more than the track's tiles."""
    threads = -(-h // 32) * 32
    smem = 4 * (-(-2 * d * h // 4) * 4 + (TILE_ROWS + 4) * d
                + 2 * (threads // 32) * TILE_ROWS + 2 * d)
    per_sm = max(1, min(_SM_THREADS // threads,
                        _SM_SMEM_BYTES // (smem + _CTA_RESERVED_BYTES)))
    return max(1, min(-(-n // TILE_ROWS), per_sm * sm_count // k))


def nade_ll_bwd(x, w, v, g, a_end, want_dx: bool = True):
    """The backward kernel on the card. Each of its G CTAs per track sums
    dW and dV over its tiles; the (K, G, D, H) partials are summed over the
    CTAs in order by a second pass, so the result is deterministic (no
    float atomics). Its sigmoid is the card's exp2 and reciprocal
    estimates (a few ulp), well inside the gradients' tolerance."""
    k, n, d = x.shape
    ctas = bwd_plan(k, n, d, w.shape[-1], _build.sm_count(x))
    dwp = x.new_empty((k, ctas, *w.shape[1:]))
    dvp = torch.empty_like(dwp)
    dw, dv = torch.empty_like(w), torch.empty_like(v)
    dx = torch.empty_like(x) if want_dx else x.new_empty(0)
    dbh = torch.empty_like(a_end)
    with torch.cuda.device(x.device):
        _build.launches["nade_ll_bwd"] += 1
        _build.ops().nade_ll_bwd(dw, dv, dx, dbh, dwp, dvp, x, w, v, g,
                                 a_end, _build.stream_of(x))
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
