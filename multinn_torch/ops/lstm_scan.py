"""The LSTM recurrence of one layer over all T steps as one autograd
Function: the CUDA kernels (csrc/lstm_scan.cu), their plain PyTorch
versions and the Function that binds them.

The hoisted input product ``xz = xs Wx + b`` (T, ..., 4U) stays outside
(nn/rnn.lstm_scan), so its gradients stay autograd's. The Function takes
``xz``, ``wh`` and the carried state (h0, c0) and returns the carries of
every step, ``hbuf`` and ``cbuf`` (T + 1, ..., U), slot 0 the initial
state: h_t is ``hbuf[t + 1]``, the final state ``hbuf[-1]``, ``cbuf[-1]``.

    forward   z_t = xz_t + h_t Wh;  (h_{t+1}, c_{t+1}) = cell(c_t, z_t)
    backward  one reverse sweep over the kept z gives dz (T, ..., 4U), dh0
              and dc0; dWh = sum_t h_t^T dz_t is one batched product, and
              dxz = dz

It saves the pre-activations z in xz's place (the backward reads its gates
from them, and needs no xz), Wh, hbuf and cbuf: as much as the
step-checkpointed loop keeps (xz, h and c of every step), so ``remat`` has
nothing more to drop here. A layer's recurrence on the card
is one ``lstm_scan_fwd`` launch a call and one ``lstm_scan_bwd`` launch a
backward, counted in ``_build.launches``; their plan (``launch_plan``) puts
a track's block of rows on a CTA and Wh in its shared memory where it fits.
The forward kernel's h Wh sums in cuBLAS's order at the RNN-RBM train
step's shape (csrc/lstm_scan.cu), so its h and c are the loop's bits there.

Which inputs the Function takes (``takes``) is read from them: float32
under the f32 matmul policy, outside forward mode (``torch.func.jvp`` and
the other torch.func transforms, and forward-mode duals, run the loop,
whose ops carry the tangents), and Wh (U, 4U) with xz (T, ..., 4U), or
track-stacked (K, U, 4U) with xz (T, K, B, 4U), U at most ``MAX_UNITS``.
Under the bf16 policy the loop keeps its bf16 feeds (ops/precision.py).
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

from multinn_torch.ops import _build, precision

MAX_ROWS = 4          # rows of a CTA (the kernels' template range)
SPLITS = 4            # quarters of the product's contraction: U x 4 threads
MAX_UNITS = 1024 // SPLITS
CTA_SMEM_LIMIT = 227 * 1024


def cell(c, z):
    """One LSTM cell update from the pre-activations z (..., 4U), gate order
    i, f, g, o: (h, c_new)."""
    u = c.shape[-1]
    i, f = z[..., :u], z[..., u:2 * u]
    g, o = z[..., 2 * u:3 * u], z[..., 3 * u:]
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def smem_bytes(u: int, rows: int, w_smem: bool) -> int:
    """csrc/lstm_scan.cu smem_bytes: the staged Wh (16 U^2 bytes) if any,
    and the larger of the forward's (4, rows, U) float4 partials and h, and
    the backward's float partials and (rows, U) float4 dz."""
    w = 16 * u * u if w_smem else 0
    return w + max(16 * (SPLITS * rows * u + u),
                   4 * SPLITS * rows * u + 16 * rows * u)


def launch_plan(k: int, n: int, u: int, sm_count: int):
    """(rows a CTA, Wh in shared memory) for k tracks x n rows of u units:
    the fewest rows (at most MAX_ROWS) that put every (track, block of
    rows) on the card at once, one CTA an SM. Where Wh does not fit in
    shared memory beside the rest, it is read from device memory, and a CTA
    takes the most rows (fewer CTAs read it). U over MAX_UNITS has no plan:
    a ValueError before any launch."""
    if not 1 <= u <= MAX_UNITS:
        raise ValueError(f"lstm_scan: U={u} units need 4 U threads a CTA, "
                         f"U at most {MAX_UNITS}")
    r_cap = max(1, min(MAX_ROWS, n))
    rows = next((r for r in range(1, r_cap + 1)
                 if k * -(-n // r) <= sm_count), r_cap)
    if smem_bytes(u, rows, True) <= CTA_SMEM_LIMIT:
        return rows, True
    return r_cap, False


def lstm_fwd_plain(xz, wh, h0, c0):
    """(hbuf, cbuf) (T + 1, ..., U) and the pre-activations z (T, ...,
    4U) by the step loop, in the ops of nn/rnn.lstm_step under the f32
    policy."""
    h, c = h0, c0
    hs, cs, zs = [h0], [c0], []
    for xz_t in xz:
        zs.append(xz_t + h @ wh)
        h, c = cell(c, zs[-1])
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs), torch.stack(zs)


def lstm_bwd_plain(z, wh, hbuf, cbuf, dhbuf, dcbuf):
    """The reverse sweep: (dz (T, ..., 4U), dh0, dc0) for the carries'
    cotangents dhbuf, dcbuf (T + 1, ..., U), either None for zero."""
    u = wh.shape[-2]
    ig, fg = torch.sigmoid(z[..., :u]), torch.sigmoid(z[..., u:2 * u])
    gg, og = torch.tanh(z[..., 2 * u:3 * u]), torch.sigmoid(z[..., 3 * u:])
    tc = torch.tanh(cbuf[1:])
    wt = wh.transpose(-1, -2)
    dz = torch.empty_like(z)
    rec = torch.zeros_like(hbuf[0])
    carry = torch.zeros_like(cbuf[0])
    for t in reversed(range(z.shape[0])):
        dh = rec if dhbuf is None else dhbuf[t + 1] + rec
        dc = carry if dcbuf is None else carry + dcbuf[t + 1]
        dc = dc + (dh * og[t]) * (1 - tc[t] * tc[t])
        carry = dc * fg[t]
        dz[t, ..., :u] = (dc * gg[t]) * (ig[t] * (1 - ig[t]))
        dz[t, ..., u:2 * u] = (dc * cbuf[t]) * (fg[t] * (1 - fg[t]))
        dz[t, ..., 2 * u:3 * u] = (dc * ig[t]) * (1 - gg[t] * gg[t])
        dz[t, ..., 3 * u:] = (dh * tc[t]) * (og[t] * (1 - og[t]))
        rec = dz[t] @ wt
    return (dz, rec if dhbuf is None else dhbuf[0] + rec,
            carry if dcbuf is None else dcbuf[0] + carry)


def _rows(x, k: int, lead: int):
    """x (*lead dims, ..., X) -> (*lead dims, K, N, X), contiguous: the
    kernels' layout, the batch dims of an unstacked layer one track's
    rows."""
    return x.reshape(*x.shape[:lead], k, -1, x.shape[-1]).contiguous()


def lstm_fwd(xz, wh, h0, c0, keep_z=True):
    """The forward kernel on the card: float32 CUDA tensors xz (T, ..., 4U)
    with wh (U, 4U), or xz (T, K, B, 4U) with track-stacked wh (K, U, 4U);
    h0, c0 (..., U), xz's batch dims. Returns (hbuf, cbuf) (T + 1, ...,
    U) and the pre-activations z (xz's shape), or None without
    ``keep_z``."""
    k = wh.shape[0] if wh.dim() == 3 else 1
    t, u = xz.shape[0], wh.shape[-2]
    x4 = _rows(xz, k, 1)
    n = x4.shape[2]
    rows, w_smem = launch_plan(k, n, u, _build.sm_count(xz))
    hbuf = xz.new_empty((t + 1, *xz.shape[1:-1], u))
    cbuf = torch.empty_like(hbuf)
    z = xz.new_empty(xz.shape) if keep_z else None
    # (K, U', U, 4): the four gates of (u', u) side by side
    wf = wh.reshape(k, u, 4, u).transpose(-1, -2).contiguous()
    with torch.cuda.device(xz.device):
        _build.launches["lstm_scan_fwd"] += 1
        _build.ops().lstm_scan_fwd(
            hbuf.view(t + 1, k, n, u), cbuf.view(t + 1, k, n, u),
            xz.new_empty(0) if z is None else z.view(x4.shape), x4, wf,
            _rows(h0, k, 0), _rows(c0, k, 0), rows, int(w_smem),
            _build.stream_of(xz))
    return hbuf, cbuf, z


def lstm_bwd(z, wh, hbuf, cbuf, dhbuf, dcbuf):
    """The backward kernel on the card, in lstm_fwd's shapes, from the
    kept pre-activations z. Returns (dz, dh0, dc0)."""
    k = wh.shape[0] if wh.dim() == 3 else 1
    t, u = z.shape[0], wh.shape[-2]
    z4 = _rows(z, k, 1)
    n = z4.shape[2]
    rows, w_smem = launch_plan(k, n, u, _build.sm_count(z))
    # (K, U, U', 4): the four gates of Wh[u', g U + u] side by side
    wb = wh.reshape(k, u, 4, u).permute(0, 3, 1, 2).contiguous()
    dz = z.new_empty(z.shape)
    dh0 = z.new_empty(hbuf.shape[1:])
    dc0 = torch.empty_like(dh0)
    absent = z.new_empty(0)
    with torch.cuda.device(z.device):
        _build.launches["lstm_scan_bwd"] += 1
        _build.ops().lstm_scan_bwd(
            dz.view(z4.shape), dh0.view(k, n, u), dc0.view(k, n, u), z4, wb,
            _rows(cbuf, k, 1),
            absent if dhbuf is None else _rows(dhbuf, k, 1),
            absent if dcbuf is None else _rows(dcbuf, k, 1),
            rows, int(w_smem), _build.stream_of(z))
    return dz, dh0, dc0


def _dwh(hprev, dz, wh):
    """sum over steps and rows of hprev^T dz, per track where stacked. A
    stacked layer's is one batched product over (track, quarter of the
    steps), summed over the quarters: one product a track over all T N
    rows leaves most of the card idle (K=5, N=64: 0.208 ms against 0.114
    in four quarters on the H100)."""
    u, g = wh.shape[-2:]
    if wh.dim() == 2:
        return hprev.reshape(-1, u).t() @ dz.reshape(-1, g)
    t, k = dz.shape[:2]
    c = next(c for c in (4, 2, 1) if t % c == 0)
    hp = hprev.reshape(c, t // c, k, -1, u).permute(2, 0, 4, 1, 3)
    dc = dz.reshape(c, t // c, k, -1, g).permute(2, 0, 1, 3, 4)
    return torch.bmm(hp.reshape(k * c, u, -1),
                     dc.reshape(k * c, -1, g)).view(k, c, u, g).sum(1)


class LSTMRecurrence(torch.autograd.Function):
    """(hbuf, cbuf) of the recurrence over xz from (h0, c0); ``impl``
    "cuda" launches the kernels, "plain" runs their plain versions."""

    @staticmethod
    def forward(ctx, xz, wh, h0, c0, impl):
        ctx.set_materialize_grads(False)
        ctx.impl = impl
        if impl == "cuda":      # z only where a backward will read it
            hbuf, cbuf, z = lstm_fwd(xz, wh, h0, c0,
                                     keep_z=any(ctx.needs_input_grad))
        else:
            hbuf, cbuf, z = lstm_fwd_plain(xz, wh, h0, c0)
        ctx.save_for_backward(z, wh, hbuf, cbuf)
        return hbuf, cbuf

    @staticmethod
    def backward(ctx, dhbuf, dcbuf):
        z, wh, hbuf, cbuf = ctx.saved_tensors
        bwd = lstm_bwd if ctx.impl == "cuda" else lstm_bwd_plain
        dz, dh0, dc0 = bwd(z, wh, hbuf, cbuf, dhbuf, dcbuf)
        need = ctx.needs_input_grad
        return (dz if need[0] else None,
                _dwh(hbuf[:-1], dz, wh) if need[1] else None,
                dh0 if need[2] else None, dc0 if need[3] else None, None)


def _forward_mode(tensors) -> bool:
    """Inside a torch.func transform (``jvp``: the Hessian-free step's
    J v), or with forward-mode duals among the inputs: the Function has no
    forward-mode rule."""
    return (torch._C._are_functorch_transforms_active()
            or any(forward_ad.unpack_dual(x).tangent is not None
                   for x in tensors))


def takes(xz, wh, h0, c0) -> bool:
    """Whether ``lstm_recurrence`` takes these inputs (module docstring);
    nn/rnn.lstm_scan runs its loop on the others."""
    tensors = (xz, wh, h0, c0)
    if (precision.matmul_dtype() is not None or _forward_mode(tensors)
            or any(x.dtype != torch.float32 for x in tensors)
            or wh.shape[-2] > MAX_UNITS):
        return False
    if wh.dim() == 3:
        return xz.dim() == 4 and xz.shape[1] == wh.shape[0]
    return wh.dim() == 2 and xz.dim() >= 2


def lstm_recurrence(xz, wh, h0, c0, impl=None):
    """(hbuf, cbuf) (T + 1, ..., U) of the recurrence over the hoisted
    input products xz (T, ..., 4U) from (h0, c0), which broadcast against
    xz's batch dims: the kernels for CUDA tensors, their plain versions for
    CPU tensors (``impl`` forces one). Reverse-mode differentiable."""
    shape = (*xz.shape[1:-1], wh.shape[-2])
    return LSTMRecurrence.apply(xz, wh, h0.expand(shape), c0.expand(shape),
                                _build.impl_for(impl, xz))
