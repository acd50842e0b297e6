"""Shared helpers of the whole-generation kernels — port of
multinn_tpu/ops/gen_common.py.

The kernels run in the decoder's feature space with per-track layouts:
the pianoroll pitches for pass-through encoders, the DBN latents
otherwise (the dispatch decodes the latent roll after the kernel).
``_eff_dims`` is (K, D) as the kernels see them: joint mode collapses to
one track of the joint width, whose layouts are plain dense matrices.
``_decoder_param_shapes`` builds the track-stacked decoder params on the
``meta`` device, so a gate can run the real argument builder and size the
launch without allocating anything. ``_ctx_rows`` and ``_state_rows`` /
``_from_state_rows`` are the layouts both whole-generation kernels read.
``cluster_shape`` and ``sample_bytes`` make the count of
csrc/gen_cluster.cuh's make_plan that the dispatch gates need: a cluster
of min(K, 8) CTAs, CTA r owning tracks r, r + C, ..., and one sample's
state, which must fit a CTA's shared memory. Where the per-step weights
go and how many samples a cluster runs is decided at launch (the
card-only tests read that plan through the gen_fused_plan op).

``block_slices`` mirrors how the kernels' cell stack (and the RBM
kernel's conditioned biases) slice a CTA's samples, a thread per output
for a slice, so that one read of a weight column serves the slice.

``LayoutDims``, ``rbm_layout_bytes``, ``nade_layout_bytes`` and
``storage_dtype`` are the JAX package's storage-dtype contract: which
weights its fused kernels keep in bf16 for a given config and batch.
That is a rule about numerics, not a resource gate of this card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

# dynamic shared memory one CTA may use on Hopper (232,448 bytes)
SMEM_LIMIT_BYTES = 227 * 1024
MAX_CLUSTER = 8             # the portable cluster size


def cluster_shape(k: int) -> Tuple[int, int]:
    """(CTAs per cluster, track slots per CTA) for K tracks."""
    c = min(k, MAX_CLUSTER)
    return c, -(-k // c)


def sample_bytes(k: int, d: int, u: int, n_layers: int, scratch: int) -> int:
    """Shared memory of one sample's state in a CTA: the frames of all
    tracks at t-1 (K*D) f32, per track slot its fresh rows of both step
    parities (2*D), h and c (L*U each) and a scratch row f32, the lists of
    nonzero entries of the K previous and the tpc fresh rows (a count and
    up to D uint16 indices each), 16-byte aligned. The per-track weights
    go to shared memory only beside it, so a launch is possible exactly
    when this fits."""
    tpc = cluster_shape(k)[1]
    row_list = 4 + 2 * (d + d % 2)
    nbytes = (4 * (k * d + tpc * (2 * d + 2 * n_layers * u + scratch))
              + (k + tpc) * row_list)
    return (nbytes + 15) & ~15


THREADS = 512              # a CTA's threads (gen_cluster.cuh's kThreads)
MAX_BLOCK = 6              # the most samples a thread blocks (kMaxBlock)


def block_slices(ns: int, outputs: int) -> int:
    """Slices of a CTA's ``ns`` samples for a phase of ``outputs`` (track
    slot, output) pairs a sample, as gen_cluster.cuh's block_slices: as
    many as keep the CTA's threads busy, at least enough to hold a slice
    within MAX_BLOCK samples, at most ``ns`` (one sample a thread)."""
    fill = THREADS // max(outputs, 1)
    return min(ns, max(fill, -(-ns // MAX_BLOCK)))


def _common_gate(cfg, decoder_type: str) -> bool:
    """Configs the port's kernels take: this decoder family, any encoder
    (a DBN's kernels run at D = feature_dim, the feedback context K
    latents wide), every inter-track mode (joint mode as one track of the
    joint width, _eff_dims)."""
    return cfg.decoder_type == decoder_type


def _given_fits(cfg, n_given: int) -> bool:
    """An accompaniment leaves at least one track to sample. The kernels
    read the given stream from device memory, one row per sample and step,
    so it takes no shared memory and the plan does not change."""
    return 0 <= n_given < cfg.n_tracks


def _eff_dims(cfg):
    """(K, D) as the kernels see them: D is the decoder's feature width.
    Joint mode is one decoder over the concatenated tracks: ONE track of
    the joint feature width (K*D for pass-through encoders)."""
    from multinn_torch.models.multinn import n_decoders
    return n_decoders(cfg), cfg.feature_dim()


def _decoder_param_shapes(cfg, decoder_mod):
    """Track-stacked decoder Params as meta tensors (joint mode: a stack
    of one)."""
    from multinn_torch.models.multinn import n_decoders, stack_trees
    one = decoder_mod.init(cfg.decoder_config(), device="meta")
    return stack_trees([one] * n_decoders(cfg))


def _ctx_rows(wx, d: int):
    """The feedback projection of layer-0 input weights wx (K, D + K*D, G):
    rows [j*D + i] map source v_{j,i}(t-1) to all K target tracks' gates,
    columns [target track k][gate] -> (K*D, K*G); None without context."""
    k, xin_dim, g = wx.shape
    if xin_dim == d:
        return None
    return (wx[:, d:, :].reshape(k, k, d, g).permute(1, 2, 0, 3)
            .reshape(k * d, k * g).contiguous())


def _state_rows(x):
    """Cell state (L, K, B, U) -> the kernels' rows (B, L*K*U), layer-major
    then per-track."""
    return x.movedim(2, 0).reshape(x.shape[2], -1).contiguous()


def _from_state_rows(r, n_layers: int, k: int, u: int):
    """(B, L*K*U) rows -> (L, K, B, U)."""
    return r.reshape(r.shape[0], n_layers, k, u).permute(1, 2, 0, 3)


# ---------------------------------------------------------------------------
# The reference's storage-dtype contract
# ---------------------------------------------------------------------------
#
# The JAX package's fused kernels store some weights in bf16 (the RBM's
# block matrices, the NADE's wuh / wh / layer >= 1 wx) whenever the f32
# layout passes the 10 MiB VMEM budget, which its default dispatch checks
# on every call; past the bf16 budget too, it falls back to its scan
# path, whose weights are f32. So that the port samples what the
# reference samples, its kernels take the same storage dtype. The byte
# counts below are the reference's TPU layouts (multinn_tpu/ops/vmem.py,
# gen_fused_rbm._rbm_args / _rbm_scratch / _rbm_fixed_bytes,
# gen_fused_nade._nade_args / _nade_scratch / _nade_fixed_bytes) in
# closed form: block-diagonal K*X x K*Y matrices, dim blocks padded to 8
# track rows and the activation width to 128 lanes. They describe no
# buffer of this port and bound nothing on the H100: the port's own
# gates are supported / supported_nade.

VMEM_BUDGET_BYTES = 10 * 1024 * 1024   # the reference's vmem.VMEM_BUDGET_BYTES
_KP = 8                                # its dim-block row stride


class LayoutDims(NamedTuple):
    """Sizes of a track-stacked decoder as the kernels see them: K tracks
    (one in joint mode), D features, H hidden, U cell width, G gate width
    (4U | U), L cell layers."""
    k: int
    d: int
    hid: int
    u: int
    g: int
    n_layers: int


def dims_of_cfg(cfg) -> LayoutDims:
    k, d = _eff_dims(cfg)
    u = cfg.n_rnn
    return LayoutDims(k, d, cfg.n_hidden, u,
                      4 * u if cfg.cell == "lstm" else u, cfg.rnn_layers)


def dims_of_params(dec_params) -> LayoutDims:
    """From track-stacked decoder params (real or meta tensors)."""
    k, d, hid = dec_params.w.shape
    wh = dec_params.cell[0].wh
    return LayoutDims(k, d, hid, wh.shape[1], wh.shape[2],
                      len(dec_params.cell))


def _khp(k: int, hid: int) -> int:
    """The reference's lane-padded activation width (128-aligned)."""
    return -(-k * hid // 128) * 128


def rbm_layout_bytes(n: LayoutDims, batch: int, wbytes: int,
                     conditioned: bool = False) -> int:
    """VMEM bytes of the reference's RBM kernel with its five block
    matrices (W, W^T, Wuv, Wuh, Wctx) at ``wbytes`` an element."""
    k, d, hid, u, g, nl = n
    blocks = (2 * (k * d) * (k * hid) + (k * u) * (k * d)
              + (k * u) * (k * hid) + (k * d) * (k * g))
    f32 = (k * d + k * hid + k * d * g + nl * k * u * g + nl * k * g
           + (nl - 1) * k * u * g
           + batch * (2 * nl * k * u + k * d))          # args
    f32 += batch * (2 * nl * k * u + k * d + k * g)     # scratch
    f32 += batch * (2 * k * d + 2 * nl * k * u + 2 * k * (hid + d)
                    + (2 * k * d if conditioned else 0))
    return wbytes * blocks + 4 * f32


def nade_layout_bytes(n: LayoutDims, batch: int, aux_bytes: int,
                      n_given: int = 0, spec: int = 1) -> int:
    """VMEM bytes of the reference's NADE kernel with wuh, wh and the
    layer >= 1 wx at ``aux_bytes`` an element; ``spec`` the speculative
    depth whose bf16 side table it charges."""
    k, d, hid, u, g, nl = n
    khp = _khp(k, hid)
    bf16 = (d * _KP * (khp + k * g) + d * _KP * khp + d * _KP * k * u
            + (k * d) * (k * g))
    aux = k * u * hid + nl * k * u * g + (nl - 1) * k * u * g
    f32 = (d * _KP + k * hid + nl * k * g
           + batch * (2 * nl * k * u) + _KP * batch * d)  # args
    f32 += (batch * 2 * nl * k * u + _KP * batch * d + batch * k * hid
            + 2 * d * _KP * batch + batch * k * g)       # scratch
    f32 += 2 * _KP * batch * d + 2 * batch * nl * k * u
    if n_given:
        f32 += 2 * _KP * batch * d + n_given * d * g
    if spec > 1:
        bf16 += (d // spec) * _KP * khp
    return 2 * bf16 + aux_bytes * aux + 4 * f32


def storage_dtype(need) -> Optional[torch.dtype]:
    """The reference's ladder: ``need(itemsize)`` bytes within the budget
    at 4 (f32), else at 2 (bf16), else None (its scan path)."""
    for dtype in (torch.float32, torch.bfloat16):
        if need(dtype.itemsize) <= VMEM_BUDGET_BYTES:
            return dtype
    return None


def resolve_storage(dtype, rule, what: str) -> torch.dtype:
    """An explicit storage dtype (f32 or bf16) as given; None: ``rule()``,
    the reference's choice, f32 where it falls back to its scan path."""
    if dtype is None:
        dtype = rule()
        return torch.float32 if dtype is None else dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} must be torch.float32 or torch.bfloat16 "
                         f"(None: the reference's rule), got {dtype}")
    return dtype
