"""Frame-level training metrics — port of multinn_tpu/training/metrics.py.

Transduction metrics over binary pianoroll frames (predictions thresholded
at 0.5), reduced over every axis; an optional frame mask (the inputs' shape
minus the pitch axis) excludes padded frames from every count.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

#: the key under which a decoder's loss returns its frame counts when its
#: batch rows are split over ``data`` (a gspmd step): (..., 5), the last
#: axis ``tp, fp, fn, agreed, cells``. The trainer sums them over the data
#: ranks in its metrics reduction and forms the ratios from the sums, the
#: whole batch's metrics as one device computes them.
FRAME_COUNTS = "frame_counts"


def frame_counts(pred: torch.Tensor, target: torch.Tensor,
                 threshold: float = 0.5,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The counts behind ``frame_metrics``: (tp, fp, fn, agreed, cells),
    a (5,) tensor on the device (the cell count a fill, so a captured
    step copies nothing from the host)."""
    p = (pred >= threshold).float()
    t = (target >= 0.5).float()
    agree = (p == t).float()
    if mask is not None:
        m = mask.float()[..., None]
        p = p * m
        t = t * m
        agree = agree * m
        cells = torch.sum(m) * pred.shape[-1]
    else:
        cells = p.new_full((), float(p.numel()))
    return torch.stack([torch.sum(p * t), torch.sum(p * (1 - t)),
                        torch.sum((1 - p) * t), torch.sum(agree), cells])


def frame_ratios(counts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The transduction metrics of ``frame_counts`` (..., 5), one per
    leading index."""
    tp, fp, fn, agreed, cells = counts.unbind(-1)
    eps = 1e-8
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    acc_td = tp / (tp + fp + fn + eps)
    exact = agreed / torch.clamp(cells, min=1.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "acc_transduction": acc_td, "acc_elementwise": exact}


def frame_metrics(pred: torch.Tensor, target: torch.Tensor,
                  threshold: float = 0.5,
                  mask: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    return frame_ratios(frame_counts(pred, target, threshold, mask))


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
