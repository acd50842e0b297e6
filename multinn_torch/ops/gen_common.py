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
"""

from __future__ import annotations

from typing import Tuple

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
