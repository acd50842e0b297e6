"""Traffic kind ``train_groups_nade``: the kind ``train_groups`` (imported,
not edited; its docstring states the input, the window, the metrics and
the check's numbers) for an RNN-NADE decoder, whose training the
reference follows through ``reference/nade_train.py``: the teacher-forced
exact negative log-likelihood, autograd gradients and Adam behind the
clip, from the same weights and global batches as the program's first
group. Nothing is drawn, so the keys play no part.
"""

from __future__ import annotations

from unittest import mock

import numpy as np

from portbench.traffic import train_groups


def run(ctx) -> dict:
    # train_groups looks its check up by name when it builds the result
    with mock.patch.object(train_groups, "_check", _check):
        return train_groups.run(ctx)


def _check(first: dict, dev) -> dict:
    """The reference's steps of the first group against the program's,
    compared as ``train_groups`` compares them."""
    import torch

    from portbench.reference import model as ref
    from portbench.reference import nade_train

    ref.no_tf32()
    if first["decoder"] != "rnn-nade":
        raise ValueError("this check follows RNN-NADE training")
    wts = {n: x.to(dev) for n, x in first["wts"].items()}
    x = torch.from_numpy(first["x"]).to(dev, torch.float32)
    after, opt, losses, norms = nade_train.nade_train(
        wts, list(x), first["lr"], first["clip"])

    def rel(a, b):
        return abs(a - b) / abs(b)

    mom_ref = {n: float(m.norm()) for n, m in opt.mu.items()}
    med = float(np.median(list(mom_ref.values())))
    live = [n for n, v in mom_ref.items() if v >= 1e-3 * med]

    def worst_leaf(prog_norm, ref_norm):
        mid = float(np.median([ref_norm[n] for n in live]))
        return max(abs(prog_norm[n] - ref_norm[n]) / max(ref_norm[n], mid)
                   for n in live)

    change = lambda p: {n: float((p[n].to(dev) - wts[n]).norm())
                        for n in live}
    return {
        "loss_gap": max(rel(first["loss"], losses[-1]),
                        rel(first["loss_mean"], float(np.mean(losses)))),
        "grad_norm_gap": rel(first["grad_norm"], norms[-1]),
        "change_gap": worst_leaf(change(first["params"]), change(after)),
        "moment_gap": worst_leaf(
            {n: float(first["mu"][n].norm()) for n in live}, mom_ref),
        "leaves_left_out": len(mom_ref) - len(live),
        "smallest_moment_share": min(mom_ref.values()) / med,
    }
