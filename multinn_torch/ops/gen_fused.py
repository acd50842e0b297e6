"""Whole-generation kernels: the stable public surface — port of
multinn_tpu/ops/gen_fused.py (RNN-RBM and RNN-NADE families).
"""

from __future__ import annotations

from multinn_torch.ops.gen_fused_nade import (_resolve_spec, generate_nade,
                                              nade_aux_dtype, supported_nade)
from multinn_torch.ops.gen_fused_rbm import (generate_rbm, rbm_weight_dtype,
                                             supported)

__all__ = ["supported", "rbm_weight_dtype", "generate_rbm", "supported_nade",
           "nade_aux_dtype", "generate_nade"]
