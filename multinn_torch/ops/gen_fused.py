"""Whole-generation kernels: the stable public surface — port of
multinn_tpu/ops/gen_fused.py (RNN-RBM family; the RNN-NADE kernel is not
ported yet, ROADMAP queue 2).
"""

from __future__ import annotations

from multinn_torch.ops.gen_fused_rbm import generate_rbm, supported

__all__ = ["supported", "generate_rbm"]
