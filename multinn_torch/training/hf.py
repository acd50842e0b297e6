"""Hessian-free (truncated-Newton) optimizer for RNN-NADE training — port
of multinn_tpu/training/hf.py (Martens 2010; Martens & Sutskever 2011),
the training regime of the paper's best RNN-NADE numbers.

One macro-step:
  1. g = grad L(theta) on the batch, L the exact NLL (``multinn.loss``:
     on the card the likelihood kernels and their backward).
  2. (G + lam I) delta = -g by ``cg_iters`` conjugate-gradient iterations,
     G the Gauss-Newton matrix of the NLL through the conditional-logit
     map l(theta) (``multinn.conditional_logits``, the cumsum form):
         G v = J^T diag(w s(l)(1 - s(l))) J v,   J = dl/dtheta,
     w the trainer's frame-mask / normalization weights. J v is
     forward-mode (``torch.func.jvp``); J^T u runs backward through the
     logits graph built once per macro-step and kept (``retain_graph``),
     the JAX package's single ``jax.vjp``. CG warm-starts from the
     previous delta scaled by ``cg_warm``.
  3. Levenberg-Marquardt damping: rho = (L(theta + delta) - L(theta)) /
     q(delta), q(delta) = g.delta + delta.(G + lam I)delta / 2; lam times
     2/3 if rho > 3/4, times 3/2 if rho < 1/4, clipped to [lam_min,
     lam_max].
  4. Accept theta + delta iff the loss fell (``torch.where``); delta seeds
     the next warm start either way.

Every quantity stays a device tensor and the CG loop has a fixed trip
count, so a macro-step never reads the host and a group of them can be
captured as one CUDA graph (training/trainer.py). The step works on the
decoder's tensors: a DBN encoder's features are frozen binary targets
(encoders.features), so the encoder's parts of g and of every G v are
zero, as in the JAX package, whose step carries them.

Under a mesh (``red``, a parallel.mesh.Reduce; ``shard`` / ``seq``, the
model's part of the batch, multinn.py) the loss, the gradient and every
Gauss-Newton product are averaged over the mean axes (``data``, and
``seq`` under seqpipe: the reference's pmean over ``axes``), the loss is
summed over a track split, and every dot product sums each tensor's part
over the axes it is split over, so every rank holds the same CG state and
CG solves one global system.

Scope: rnn-nade decoders, every inter-track mode. A CD-trained RBM has no
objective to optimize at second order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from multinn_torch.models import multinn
from multinn_torch.nn import nade as nade_nn
from multinn_torch.ops import precision
from multinn_torch.parallel.mesh import Reduce


@dataclasses.dataclass
class HFState:
    """The optimizer's state: the LM damping, the previous CG solution
    (one tensor per decoder tensor; the warm start) and the count of
    accepted steps. The trainer checkpoints it with the run."""
    lam: torch.Tensor        # () float32
    delta: List[torch.Tensor]
    accepted: torch.Tensor   # () int32


def init_state(params: multinn.MultINNParams, lam0: float = 1.0) -> HFState:
    leaves = multinn.tree_leaves(params.decoder)
    dev = leaves[0].device
    return HFState(lam=torch.tensor(lam0, dtype=torch.float32, device=dev),
                   delta=[torch.zeros_like(t) for t in leaves],
                   accepted=torch.zeros((), dtype=torch.int32, device=dev))


# -- linear algebra over lists of tensors -------------------------------------

def _dot(a, b) -> torch.Tensor:
    """Sum over the tensors of their inner products (a device scalar)."""
    return torch.stack([p.sum() for p in torch._foreach_mul(a, b)]).sum()


def _axpy(alpha, x, y):
    """alpha * x + y."""
    return torch._foreach_add(y, torch._foreach_mul(x, alpha))


def _scale(alpha, x):
    return torch._foreach_mul(x, alpha)


# -- the masked cross-entropy the GGN linearizes ------------------------------

def _ce_weights(cfg, x_shape, frame_mask: Optional[torch.Tensor],
                device=None) -> torch.Tensor:
    """Per-(T, B) weights reproducing the trainer's loss normalization:
    multinn.loss is the mean over K tracks of (-sum ll m / sum m), so as
    one sum over the (K, T, B, F) terms the weight is m_tb / (K sum m);
    joint mode has one decoder (K = 1)."""
    b, t = x_shape[0], x_shape[1]
    k = multinn.n_decoders(cfg)
    if frame_mask is None:
        m_tb = torch.ones((t, b), dtype=torch.float32, device=device)
    else:
        m_tb = frame_mask.t().to(torch.float32)
    return m_tb / (k * torch.clamp(m_tb.sum(), min=1.0))


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor,
             w_tb: torch.Tensor) -> torch.Tensor:
    """Masked Bernoulli cross-entropy under the trainer's normalization;
    equals multinn.loss for rnn-nade. logits / targets (K, T, B, F)."""
    ce = nade_nn.bernoulli_ll(logits, targets)
    return -(ce * w_tb[None, :, :, None]).sum()


# -- one HF macro-step --------------------------------------------------------

def _with_decoder(params: multinn.MultINNParams, leaves):
    """``params`` with the decoder's tensors replaced, in tree_leaves
    order, by ``leaves``."""
    return dataclasses.replace(
        params, decoder=multinn.with_leaves(params.decoder, leaves))


def _ggn_matvec(params, theta, live, x, w_tb, lam, red=None, shard=None,
                seq=None):
    """v -> (G + lam I) v at the decoder tensors ``theta`` (``live``: the
    same values requiring grad). J v is forward-mode through the logits;
    J^T u runs backward through one logits graph, built here and kept.
    Under a mesh G v is averaged over ``red``'s mean axes."""
    red = red or Reduce()
    logits0 = multinn.conditional_logits(_with_decoder(params, live), x,
                                         shard, seq)[0]
    p0 = torch.sigmoid(logits0.detach())
    h_diag = p0 * (1.0 - p0) * w_tb[None, :, :, None]   # PSD CE curvature

    def logits_fn(*leaves):
        return multinn.conditional_logits(_with_decoder(params, leaves),
                                          x, shard, seq)[0]

    def gnvp(v):
        _, jv = torch.func.jvp(logits_fn, tuple(theta), tuple(v))
        gv = torch.autograd.grad(logits0, live, grad_outputs=h_diag * jv,
                                 retain_graph=True)
        return _axpy(lam, v, red.mean([g.detach() for g in gv]))

    return gnvp


def hf_step(params: multinn.MultINNParams, state: HFState, x: torch.Tensor,
            key: torch.Tensor, frame_mask: Optional[torch.Tensor] = None, *,
            cg_iters: int = 25, cg_warm: float = 0.95, lam_min: float = 1e-4,
            lam_max: float = 1e4, red: Optional[Reduce] = None, shard=None,
            seq=None):
    """One Hessian-free macro-step on the batch x (B, T, K, D); a function
    of (params, state, batch) that changes neither. Returns (new_params,
    new_state, metrics): the metrics ``loss`` (after the step's accept),
    ``hf_rho``, ``hf_lambda``, ``hf_q``, ``hf_cg_residual``,
    ``hf_accepted`` and ``grad_norm``, all device scalars.

    The gradient, the losses and the accept test use the true objective
    (multinn.loss); the curvature is the GGN of the logit map. The step
    pins the f32 matmul policy: J v is forward-mode, which the bf16
    policy's autograd Function does not define, and curvature from
    rounded feeds would be dubious anyway. ``red`` / ``shard`` / ``seq``:
    a mesh's reductions and part (module docstring)."""
    w_tb = _ce_weights(params.cfg, x.shape, frame_mask, device=x.device)
    with precision.matmul_precision("f32"):
        return _hf_step_f32(params, state, x, key, w_tb, frame_mask,
                            cg_iters, cg_warm, lam_min, lam_max,
                            red or Reduce(), shard, seq)


def _hf_step_f32(params, state, x, key, w_tb, frame_mask, cg_iters,
                 cg_warm, lam_min, lam_max, red, shard, seq):
    theta = [t.detach() for t in multinn.tree_leaves(params.decoder)]
    live = [t.clone().requires_grad_(True) for t in theta]
    p_live = _with_decoder(params, live)
    _dot = red.dot

    def loss_at(p):
        return multinn.loss(p, key, x, detailed=False,
                            frame_mask=frame_mask, shard=shard, seq=seq)[0]

    share0 = loss_at(p_live)
    g = red.mean(list(torch.autograd.grad(share0, live)))
    loss0 = red.loss(share0)
    lam = state.lam
    gnvp = _ggn_matvec(params, theta, live, x, w_tb, lam, red, shard, seq)

    # CG on (G + lam I) delta = -g, warm-started from the previous delta
    b_rhs = _scale(-1.0, g)
    xk = _scale(cg_warm, state.delta)
    rk = torch._foreach_sub(b_rhs, gnvp(xk))
    pk = list(rk)
    rs = _dot(rk, rk)
    for _ in range(cg_iters):
        ap = gnvp(pk)
        alpha = rs / torch.clamp(_dot(pk, ap), min=1e-30)
        xk = _axpy(alpha, pk, xk)
        rk = _axpy(-alpha, ap, rk)
        rs_new = _dot(rk, rk)
        pk = _axpy(rs_new / torch.clamp(rs, min=1e-30), pk, rk)
        rs = rs_new
    delta = xk

    # quadratic-model decrease q = g.delta + delta.(G + lam I)delta / 2
    q = _dot(g, delta) + 0.5 * _dot(delta, gnvp(delta))
    del gnvp                          # frees the kept logits graph
    new = torch._foreach_add(theta, delta)
    with torch.no_grad():
        loss1 = red.loss(loss_at(_with_decoder(params, new)))
    rho = (loss1 - loss0) / torch.clamp(q, max=-1e-30)
    lam_new = torch.clamp(
        torch.where(rho > 0.75, lam * (2.0 / 3.0),
                    torch.where(rho < 0.25, lam * 1.5, lam)),
        lam_min, lam_max)
    accept = loss1 < loss0
    out = [torch.where(accept, n, o) for n, o in zip(new, theta)]
    metrics = {
        "loss": torch.where(accept, loss1, loss0),
        "hf_rho": rho, "hf_lambda": lam_new, "hf_q": q, "hf_cg_residual": rs,
        "hf_accepted": accept.to(torch.float32),
        "grad_norm": torch.sqrt(_dot(g, g)),
    }
    new_state = HFState(lam=lam_new, delta=[d.detach() for d in delta],
                        accepted=state.accepted + accept.to(torch.int32))
    return _with_decoder(params, out), new_state, metrics
