"""multinn_torch's grid-free NADE likelihood (ops/nade_ll.py) and the NADE
reference forms (nn/nade.py) against the JAX package on the CPU.

The Function's plain path (the sequential dim loops the kernels compute)
is held against ``nade_ll_pallas.nade_logits(..., interpret=True)`` under
``jax.vjp`` — logits and the VJP in every argument — and against
``jax.grad`` of ``nn.nade.log_prob``. Tolerance: rtol 1e-5, atol 2e-6
(float32 sums in other orders; the backward recovers each activation by
downdating a_D, which adds at most D ulps to it). ``gradcheck`` runs the
plain path in float64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.nn import nade as jax_nade  # noqa: E402
from multinn_tpu.ops import nade_ll_pallas  # noqa: E402
from multinn_torch.nn import nade  # noqa: E402
from multinn_torch.ops import _build, nade_ll, nade_ops  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
D, H = 8, 6


def _inputs(lead, bias_lead=None, seed=0, d=D, h=H):
    """x (*lead, D) binary, w / v (D, H), biases (*bias_lead, D / H)."""
    rng = np.random.default_rng(seed)
    bias_lead = lead if bias_lead is None else bias_lead
    x = (rng.random((*lead, d)) < 0.4).astype(np.float32)
    w = rng.normal(0, 0.8, (d, h)).astype(np.float32)
    v = rng.normal(0, 0.8, (d, h)).astype(np.float32)
    bv = rng.normal(0, 0.5, (*bias_lead, d)).astype(np.float32)
    bh = rng.normal(0, 0.5, (*bias_lead, h)).astype(np.float32)
    g = rng.normal(0, 1, (*lead, d)).astype(np.float32)
    return (x, w, v, bv, bh), g


def _torch_vjp(args, g, **kw):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    out = nade_ll.nade_logits(*ts, **kw)
    return out.detach().numpy(), [
        x.numpy() for x in torch.autograd.grad(out, ts, torch.from_numpy(g))]


@pytest.mark.parametrize("lead,bias_lead", [
    ((37,), None),               # odd N: a ragged last tile on the card
    ((4, 5), None),              # time-major (T, B) leading dims
    ((3, 7), ()),                # broadcast (D,) and (H,) biases
    ((2, 5), (1, 5))])           # biases broadcast over the first axis
def test_plain_vjp_matches_pallas_interpret(lead, bias_lead):
    args, g = _inputs(lead, bias_lead)
    out, vjp = jax.vjp(
        lambda *a: nade_ll_pallas.nade_logits(*a, interpret=True),
        *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    got, grads = _torch_vjp(args, g)
    np.testing.assert_allclose(got, np.asarray(out), **TOL)
    for a, b, name in zip(grads, want, ("x", "w", "v", "bv", "bh")):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)


def test_plain_grad_matches_jax_grad_of_log_prob():
    args, _ = _inputs((3, 9), seed=1)

    def jax_ll(*a):
        return jnp.sum(jax_nade.log_prob(*a))

    want = jax.grad(jax_ll, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    ll = nade_ops.nade_log_prob(*ts).sum()
    np.testing.assert_allclose(ll.item(), float(jax_ll(*args)), rtol=1e-5)
    for a, b in zip(torch.autograd.grad(ll, ts), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_track_stacked_matches_vmap():
    """w, v (K, D, H) with x (K, ..., D): one call for every track, as
    jax.vmap of the Pallas kernel over tracks."""
    k = 2
    per = [_inputs((3, 5), seed=s) for s in (2, 3)]
    stack = lambda j: np.stack([p[0][j] for p in per])
    args = tuple(stack(j) for j in range(5))
    g = np.stack([p[1] for p in per])
    out, vjp = jax.vjp(jax.vmap(
        lambda *a: nade_ll_pallas.nade_logits(*a, interpret=True)),
        *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    got, grads = _torch_vjp(args, g)
    assert got.shape == (k, 3, 5, D)
    np.testing.assert_allclose(got, np.asarray(out), **TOL)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    # per-track (K, 1, D) / (K, 1, H) biases against x (K, N, D) reduce
    # back to their shape
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
          for a in (args[0].reshape(k, -1, D), args[1], args[2],
                    args[3][:, :1, 0], args[4][:, :1, 0])]
    out = nade_ll.nade_logits(*ts)
    grads = torch.autograd.grad(out.sum(), ts)
    assert grads[3].shape == (k, 1, D) and grads[4].shape == (k, 1, H)


def test_gradcheck_float64_on_the_plain_path():
    args, _ = _inputs((5,), seed=4, d=5, h=4)
    ts = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
          for a in args]
    assert torch.autograd.gradcheck(
        lambda *a: nade_ll.nade_logits(*a, impl="plain"), ts)
    stacked = [t.detach()[None].expand(2, *t.shape).clone().requires_grad_()
               for t in ts]
    assert torch.autograd.gradcheck(
        lambda *a: nade_ll.nade_logits(*a), stacked)


def test_dx_is_computed_only_when_asked():
    args, _ = _inputs((6,), seed=5)
    x, *rest = (torch.from_numpy(a) for a in args)
    rest = [r.requires_grad_(True) for r in rest]
    calls = []
    real = nade_ll.nade_ll_bwd_plain

    def spy(*a, want_dx=True):
        calls.append(want_dx)
        return real(*a, want_dx=want_dx)

    nade_ll.nade_ll_bwd_plain = spy
    try:
        nade_ll.nade_logits(x, *rest).sum().backward()
        nade_ll.nade_logits(x.clone().requires_grad_(True), *rest
                            ).sum().backward()
    finally:
        nade_ll.nade_ll_bwd_plain = real
    assert calls == [False, True]


def test_plain_versions_invert_each_other():
    """The forward's logits are the parallel form's and its residual is
    a_D = bh + x W; the backward leaves dx out when asked to."""
    args, g = _inputs((7,), seed=6)
    x, w, v, bv, bh = (torch.from_numpy(a)[None] for a in args)
    logits, a_end = nade_ll.nade_ll_fwd_plain(x, w, v, bv, bh)
    np.testing.assert_allclose(
        logits[0].numpy(),
        nade.conditionals_logits(x[0], w[0], v[0], bv[0], bh[0]).numpy(),
        **TOL)
    np.testing.assert_allclose(a_end[0].numpy(),
                               (bh[0] + x[0] @ w[0]).numpy(), **TOL)
    dw, dv, dx, dbh = nade_ll.nade_ll_bwd_plain(
        x, w, v, torch.from_numpy(g)[None], a_end, want_dx=False)
    assert dx is None and dw.shape == w.shape and dbh.shape == bh.shape


def test_dispatch_takes_plain_on_cpu_and_refuses_cuda_there():
    args, _ = _inputs((4,))
    ts = [torch.from_numpy(a) for a in args]
    _build.launches.clear()
    assert torch.equal(nade_ops.nade_conditionals_logits(*ts),
                       nade_ll.nade_logits(*ts, impl="plain"))
    assert not _build.launches
    with pytest.raises(ValueError, match="CUDA"):
        nade_ll.nade_logits(*ts, impl="cuda")


@pytest.mark.parametrize("form", ["cumsum", "tri"])
def test_reference_forms_match_jax(form):
    args, _ = _inputs((3, 4), seed=7)
    np.testing.assert_allclose(
        nade.conditionals_logits(*map(torch.from_numpy, args),
                                 form=form).numpy(),
        np.asarray(jax_nade.conditionals_logits(*args, form=form)), **TOL)
    np.testing.assert_allclose(
        nade_ops.nade_log_prob(*map(torch.from_numpy, args),
                               form=form).numpy(),
        np.asarray(jax_nade.log_prob(*args, form=form)), **TOL)
    with pytest.raises(ValueError):
        nade.conditionals_logits(*map(torch.from_numpy, args), form="scan")


def test_chunked_form_and_bernoulli_ll_match_jax():
    args, _ = _inputs((3, 4), seed=8)
    got = nade_ops.nade_log_prob(*map(torch.from_numpy, args), chunk=4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_nade.log_prob_chunked(*args, chunk=4)),
        **TOL)
    with pytest.raises(ValueError, match="divisible"):
        nade.log_prob_chunked(*map(torch.from_numpy, args), chunk=3)
    logits = np.linspace(-30, 30, 13, dtype=np.float32)
    x = (np.arange(13) % 2).astype(np.float32)
    np.testing.assert_allclose(
        nade.bernoulli_ll(torch.from_numpy(logits),
                          torch.from_numpy(x)).numpy(),
        np.asarray(jax_nade.bernoulli_ll(logits, x)), **TOL)


def test_stacked_reference_forms_match_vmap():
    per = [_inputs((3, 4), seed=s)[0] for s in (9, 10)]
    args = tuple(np.stack([p[j] for p in per]) for j in range(5))
    want = jax.vmap(jax_nade.log_prob)(*args)
    for kw in (dict(form="cumsum"), dict(chunk=2), dict()):
        np.testing.assert_allclose(
            nade_ops.nade_log_prob(*map(torch.from_numpy, args), **kw)
            .numpy(), np.asarray(want), **TOL)
