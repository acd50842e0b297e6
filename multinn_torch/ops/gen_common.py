"""Shared helpers of the whole-generation kernels — port of
multinn_tpu/ops/gen_common.py.

The kernels run in the decoder's feature space with per-track layouts.
``_decoder_param_shapes`` builds the track-stacked decoder params on the
``meta`` device, so a gate can run the real argument builder and size the
launch without allocating anything. ``_ctx_rows`` and ``_state_rows`` /
``_from_state_rows`` are the layouts both whole-generation kernels read.
"""

from __future__ import annotations


def _common_gate(cfg, decoder_type: str) -> bool:
    """Configs the port's kernels take: this decoder family, pass-through
    encoders, per-track / feedback / hybrid modes (joint mode and DBN
    encoders are not ported yet)."""
    return (cfg.decoder_type == decoder_type and not cfg.encoder_hidden
            and cfg.mode != "joint")


def _eff_dims(cfg):
    """(K, D) as the kernels see them."""
    return cfg.n_tracks, cfg.feature_dim()


def _decoder_param_shapes(cfg, decoder_mod):
    """Track-stacked decoder Params as meta tensors."""
    from multinn_torch.models.multinn import stack_trees
    dcfg = cfg.decoder_config()
    one = decoder_mod.init(dcfg, device="meta")
    return stack_trees([one] * cfg.n_tracks)


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
