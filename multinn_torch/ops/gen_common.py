"""Shared helpers of the whole-generation kernels — port of
multinn_tpu/ops/gen_common.py.

The kernels run in the decoder's feature space with per-track layouts.
``_decoder_param_shapes`` builds the track-stacked decoder params on the
``meta`` device, so a gate can run the real argument builder and size the
launch without allocating anything.
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
