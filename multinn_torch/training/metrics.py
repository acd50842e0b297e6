"""Frame-level training metrics — port of multinn_tpu/training/metrics.py.

Transduction metrics over binary pianoroll frames (predictions thresholded
at 0.5), reduced over every axis; an optional frame mask (the inputs' shape
minus the pitch axis) excludes padded frames from every count.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def frame_metrics(pred: torch.Tensor, target: torch.Tensor,
                  threshold: float = 0.5,
                  mask: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    p = (pred >= threshold).float()
    t = (target >= 0.5).float()
    if mask is not None:
        m = mask.float()[..., None]
        p = p * m
        t = t * m
        n_cells = torch.sum(m) * pred.shape[-1]
    tp = torch.sum(p * t)
    fp = torch.sum(p * (1 - t))
    fn = torch.sum((1 - p) * t)
    eps = 1e-8
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    acc_td = tp / (tp + fp + fn + eps)
    if mask is not None:
        agree = torch.sum((p == t).float() * mask.float()[..., None])
        exact = agree / torch.clamp(n_cells, min=1.0)
    else:
        exact = torch.mean((p == t).float())
    return {"precision": precision, "recall": recall, "f1": f1,
            "acc_transduction": acc_td, "acc_elementwise": exact}


def binary_cross_entropy(probs: torch.Tensor, target: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean per-frame BCE (the reconstruction-loss proxy)."""
    eps = 1e-7
    probs = torch.clamp(probs, eps, 1 - eps)
    ce = -(target * torch.log(probs) + (1 - target) * torch.log(1 - probs))
    per_frame = torch.sum(ce, dim=-1)
    if mask is None:
        return torch.mean(per_frame)
    m = mask.float()
    return torch.sum(per_frame * m) / torch.clamp(torch.sum(m), min=1.0)
