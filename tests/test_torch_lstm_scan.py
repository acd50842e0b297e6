"""multinn_torch's LSTM recurrence Function (ops/lstm_scan.py) on the CPU.

On CPU tensors ``nn/rnn.lstm_scan`` runs the recurrence through the
Function's plain versions (the step loop forward, one reverse sweep
backward). Held here:

* against autograd through the step loop it replaced (``_loop_scan``,
  with ``remat``'s checkpointing where the case asks): hs, every layer's
  final h and c, and the gradients of xs, Wx, b, Wh, h0 and c0; cases for
  track-stacked and unstacked layers, a carried state, T=1, two layers,
  ``remat`` and an input that needs its gradient (a DBN encoder's);
* against the JAX package's ``stacked_scan`` and ``jax.grad`` of the same
  loss;
* ``gradcheck`` in float64, the plain forward bit-equal to the loop's;
* the dispatch: CPU tensors take the plain Function, ``impl`` forces one,
  the bf16 policy, torch.func transforms (``jvp``) and forward-mode duals
  run the loop, the vanilla cell never meets the Function;
* the kernels' launch plan (pure arithmetic).

Tolerance rtol 1e-5, atol 1e-6 (float32; the reverse sweep sums the
gradients in another order than autograd through the loop)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.nn import rnn as jax_rnn  # noqa: E402
from multinn_torch.nn import rnn  # noqa: E402
from multinn_torch.ops import _build, lstm_scan, precision  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
K, B, U, IN = 3, 4, 5, 7


def _loop_scan(params, state, xs, remat=False):
    """The step loop that ``rnn.lstm_scan`` ran before the Function, under
    autograd: the reference."""
    xz = xs @ params.wx + params.b.unsqueeze(-2)
    h, c = state.h, state.c
    hs = []
    for xz_t in xz:
        if remat:
            h, c = rnn._remat(rnn._lstm_step_hc, c, h, xz_t, params.wh)
        else:
            st = rnn._lstm_gates(c, xz_t + h @ params.wh)
            h, c = st.h, st.c
        hs.append(h)
    return rnn.LSTMState(h=h, c=c), torch.stack(hs)


def _layers(stacked, n_layers, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for i in range(n_layers):
        n_in = IN if i == 0 else U
        shape = (K,) if stacked else ()
        out.append(rnn.LSTMParams(
            wx=0.4 * torch.randn(*shape, n_in, 4 * U, generator=g),
            wh=0.4 * torch.randn(*shape, U, 4 * U, generator=g),
            b=0.2 * torch.randn(*shape, 4 * U, generator=g)))
    return out


def _inputs(stacked, t, carried, n_layers, seed=1):
    g = torch.Generator().manual_seed(seed)
    lead = (K, B) if stacked else (B,)
    xs = torch.randn(t, *lead, IN, generator=g)
    states = [rnn.LSTMState(
        h=(0.5 * torch.randn(*lead, U, generator=g) if carried
           else torch.zeros(*lead, U)),
        c=(0.5 * torch.randn(*lead, U, generator=g) if carried
           else torch.zeros(*lead, U))) for _ in range(n_layers)]
    return xs, states


def _run(scan, layers, states, xs, remat, dxs, carried):
    """Outputs and gradients of a fixed loss of hs and the final states,
    through ``scan`` (one layer's scan) over the stack."""
    leaves = [x.clone().requires_grad_() for p in layers
              for x in (p.wx, p.b, p.wh)]
    params = [rnn.LSTMParams(wx=leaves[3 * i], b=leaves[3 * i + 1],
                             wh=leaves[3 * i + 2])
              for i in range(len(layers))]
    xs = xs.clone().requires_grad_(dxs)
    st = [rnn.LSTMState(h=s.h.clone().requires_grad_(carried),
                        c=s.c.clone().requires_grad_(carried))
          for s in states]
    inp, finals = xs, []
    for p, s in zip(params, st):
        final, inp = scan(p, s, inp, remat=remat)
        finals.append(final)
    w = torch.linspace(-1, 1, inp.numel()).view(inp.shape)
    loss = (inp * w).sum() + sum((0.3 * f.h + 0.7 * f.c).sum()
                                 for f in finals)
    wrt = leaves + ([xs] if dxs else []) + (
        [x for s in st for x in (s.h, s.c)] if carried else [])
    grads = torch.autograd.grad(loss, wrt)
    return [inp, *(x for f in finals for x in (f.h, f.c)), *grads]


CASES = {   # stacked, T, carried, layers, remat, dxs
    "stacked": (True, 6, False, 1, False, False),
    "unstacked": (False, 6, False, 1, False, False),
    "carried": (True, 6, True, 1, False, False),
    "t1": (True, 1, True, 1, False, False),
    "two_layers": (True, 5, True, 2, False, False),
    "remat": (True, 5, False, 1, True, False),
    "dxs": (True, 6, False, 1, False, True),
    "unstacked_all": (False, 4, True, 2, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_autograd_through_the_loop(case, monkeypatch):
    stacked, t, carried, n_layers, remat, dxs = CASES[case]
    layers = _layers(stacked, n_layers)
    xs, states = _inputs(stacked, t, carried, n_layers)
    impls = []
    real = lstm_scan.LSTMRecurrence.apply
    monkeypatch.setattr(lstm_scan.LSTMRecurrence, "apply",
                        lambda *a: impls.append(a[-1]) or real(*a))
    got = _run(rnn.lstm_scan, layers, states, xs, remat, dxs, carried)
    assert impls == ["plain"] * n_layers
    want = _run(_loop_scan, layers, states, xs, remat, dxs, carried)
    assert torch.equal(got[0], want[0])          # the same forward ops
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **TOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_function_matches_jax_stacked_scan(stacked):
    """hs, final states and jax.grad of the same loss (params and xs)
    against the JAX package's stacked_scan, vmapped over tracks where the
    layers are track-stacked."""
    layers = _layers(stacked, 2, seed=3)
    xs, states = _inputs(stacked, 5, True, 2, seed=4)
    got = _run(rnn.lstm_scan, layers, states, xs, False, True, False)
    w = np.linspace(-1, 1, got[0].numel(), dtype=np.float32).reshape(
        got[0].shape)

    def loss(jparams, jxs):
        jstates = tuple(jax_rnn.LSTMState(h=jnp.asarray(s.h.numpy()),
                                          c=jnp.asarray(s.c.numpy()))
                        for s in states)
        if stacked:
            finals, hs = jax.vmap(
                lambda p, s, x: jax_rnn.stacked_scan("lstm", p, s, x),
                in_axes=(0, 0, 1), out_axes=(0, 1))(jparams, jstates, jxs)
        else:
            finals, hs = jax_rnn.stacked_scan("lstm", jparams, jstates, jxs)
        return ((hs * w).sum() + sum((0.3 * f.h + 0.7 * f.c).sum()
                                     for f in finals)), (hs, finals)

    jparams = tuple(jax_rnn.LSTMParams(*(jnp.asarray(getattr(p, f).numpy())
                                         for f in ("wx", "wh", "b")))
                    for p in layers)
    (_, (hs, finals)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(xs.numpy()))
    want = [hs, *(x for f in finals for x in (f.h, f.c)),
            *(x for p in gp for x in (p.wx, p.b, p.wh)), gx]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stacked", [False, True])
def test_gradcheck_float64_on_the_plain_path(stacked):
    g = torch.Generator().manual_seed(5)
    lead = (2, 3) if stacked else (3,)
    xz = torch.randn(4, *lead, 4 * 3, generator=g, dtype=torch.float64)
    wh = 0.5 * torch.randn(*lead[:-1], 3, 12, generator=g,
                           dtype=torch.float64)
    h0, c0 = (torch.randn(*lead, 3, generator=g, dtype=torch.float64)
              for _ in "hc")
    args = [x.requires_grad_() for x in (xz, wh, h0, c0)]
    assert torch.autograd.gradcheck(
        lambda *a: lstm_scan.lstm_recurrence(*a, impl="plain"), args)


def test_plain_forward_bit_equal_to_the_loop():
    layers = _layers(True, 1, seed=6)
    xs, (state,) = _inputs(True, 7, True, 1, seed=7)
    with torch.no_grad():
        f_fun, hs_fun = rnn.lstm_scan(layers[0], state, xs)
        f_loop, hs_loop = _loop_scan(layers[0], state, xs)
    assert torch.equal(hs_fun, hs_loop)
    assert torch.equal(f_fun.h, f_loop.h) and torch.equal(f_fun.c, f_loop.c)


def test_impl_is_chosen_from_the_device_or_forced():
    xz = torch.randn(3, B, 4 * U)
    wh, h0 = torch.randn(U, 4 * U), torch.zeros(B, U)
    hbuf, cbuf = lstm_scan.lstm_recurrence(xz, wh, h0, h0)
    assert hbuf.shape == cbuf.shape == (4, B, U)
    forced = lstm_scan.lstm_recurrence(xz, wh, h0, h0, impl="plain")
    assert torch.equal(forced[0], hbuf) and torch.equal(forced[1], cbuf)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_scan.lstm_recurrence(xz, wh, h0, h0, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        lstm_scan.lstm_recurrence(xz, wh, h0, h0, impl="triton")
    assert _build.launches["lstm_scan_fwd"] == 0


def _spy(monkeypatch):
    calls = []
    real = lstm_scan.LSTMRecurrence.apply
    monkeypatch.setattr(lstm_scan.LSTMRecurrence, "apply",
                        lambda *a: calls.append(a[-1]) or real(*a))
    return calls


def test_bf16_policy_runs_the_loop(monkeypatch):
    """Under the bf16 policy the loop keeps its bf16 feeds: the Function is
    not called, and the result is the loop's to the bit."""
    calls = _spy(monkeypatch)
    layers = _layers(True, 1, seed=8)
    xs, (state,) = _inputs(True, 5, True, 1, seed=9)
    with precision.matmul_precision("bf16"):
        got = rnn.lstm_scan(layers[0], state, xs)[1]
        want = _loop_xz_mm(layers[0], state, xs)
    assert calls == []
    assert torch.equal(got, want)
    rnn.lstm_scan(layers[0], state, xs)
    assert calls == ["plain"]


def _loop_xz_mm(params, state, xs):
    """The loop with the policy's products (precision.mm)."""
    xz = precision.mm(xs, params.wx) + params.b.unsqueeze(-2)
    h, c = state.h, state.c
    hs = []
    for xz_t in xz:
        st = rnn._lstm_gates(c, xz_t + precision.mm(h, params.wh))
        h, c = st.h, st.c
        hs.append(h)
    return torch.stack(hs)


@pytest.mark.parametrize("stacked", [False, True])
def test_jvp_through_lstm_scan_runs_the_loop(stacked, monkeypatch):
    """torch.func.jvp (the Hessian-free step's J v) sees inputs that carry
    tangents and takes the loop, whose ops carry them: the result equals
    jvp through the reference loop, and the Function is never called."""
    calls = _spy(monkeypatch)
    layers = _layers(stacked, 1, seed=10)
    xs, (state,) = _inputs(stacked, 5, True, 1, seed=11)
    p = layers[0]
    tangents = tuple(torch.randn_like(x) for x in (p.wx, p.wh, p.b))

    def via(scan):
        def fn(wx, wh, b):
            final, hs = scan(rnn.LSTMParams(wx=wx, wh=wh, b=b), state, xs)
            return hs, final.c
        return torch.func.jvp(fn, (p.wx, p.wh, p.b), tangents)

    got, want = via(rnn.lstm_scan), via(_loop_scan)
    assert calls == []
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_any_transform_runs_the_loop(monkeypatch):
    """Inside torch.func.jvp the loop runs even where the tangents enter
    elsewhere than the recurrence's inputs: autograd.Function refuses to
    run under a transform without a forward-mode rule."""
    calls = _spy(monkeypatch)
    layers = _layers(True, 1, seed=16)
    xs, (state,) = _inputs(True, 4, False, 1, seed=17)
    a = torch.tensor(2.0)

    def fn(scale):
        return rnn.lstm_scan(layers[0], state, xs)[1].sum() * scale

    out, jv = torch.func.jvp(fn, (a,), (torch.tensor(1.0),))
    assert calls == []
    assert torch.equal(jv, _loop_scan(layers[0], state, xs)[1].sum())


def test_forward_ad_duals_run_the_loop(monkeypatch):
    from torch.autograd import forward_ad
    calls = _spy(monkeypatch)
    layers = _layers(False, 1, seed=12)
    xs, (state,) = _inputs(False, 4, False, 1, seed=13)
    tangent = torch.randn_like(xs)
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(xs, tangent)
        _, hs = rnn.lstm_scan(layers[0], state, dual)
        jv = forward_ad.unpack_dual(hs).tangent
        _, hs_ref = _loop_scan(layers[0], state, forward_ad.make_dual(
            xs, tangent))
        jv_ref = forward_ad.unpack_dual(hs_ref).tangent
    assert calls == []
    assert torch.equal(jv, jv_ref)


def test_vanilla_cell_never_meets_the_function(monkeypatch):
    calls = _spy(monkeypatch)
    g = torch.Generator().manual_seed(14)
    p = rnn.vanilla_init(IN, U, g, w_std=0.5)
    xs = torch.randn(5, B, IN, generator=g)
    final, hs = rnn.vanilla_scan(p, rnn.vanilla_zero_state((B,), U), xs)
    h = torch.zeros(B, U)
    for x in xs:
        h = torch.tanh(x @ p.wx + h @ p.wh + p.b)
    assert calls == []
    np.testing.assert_allclose(hs[-1].numpy(), h.numpy(), **TOL)
    assert torch.equal(final.h, hs[-1])


def test_unsupported_shapes_run_the_loop(monkeypatch):
    """Track-stacked weights against inputs with more leading dims than
    (T, K, B) are not the kernels' layout: the loop runs them."""
    calls = _spy(monkeypatch)
    layers = _layers(True, 1, seed=15)
    xs = torch.randn(3, 2, K, B, IN)
    state = rnn.lstm_zero_state((2, K, B), U)
    _, hs = rnn.lstm_scan(layers[0], state, xs)
    assert calls == [] and hs.shape == (3, 2, K, B, U)


@pytest.mark.parametrize("k,n,u,plan", [
    (5, 16, 100, (1, True)),     # rbm_flagship.train: 80 CTAs
    (5, 64, 100, (3, True)),     # nade_flagship.train: 110 CTAs
    (1, 16, 100, (1, True)),     # joint (K=1, input 420)
    (5, 16, 150, (4, False)),    # the Lakh config: 360 KB of Wh
    (5, 8, 64, (1, True)),       # configs/synthetic_smoke.json
    (5, 256, 100, (4, True)),    # a served batch primed: two waves
    (1, 1, 256, (1, False)),     # the widest: Wh (1 MB) read from L2
])
def test_launch_plan(k, n, u, plan):
    rows, w_smem = lstm_scan.launch_plan(k, n, u, 132)
    assert (rows, w_smem) == plan
    assert rows <= lstm_scan.SPLITS
    assert lstm_scan.smem_bytes(u, rows, w_smem) <= lstm_scan.CTA_SMEM_LIMIT
    if rows < lstm_scan.MAX_ROWS and w_smem:
        assert k * -(-n // rows) <= 132


def test_launch_plan_refuses_wider_than_a_cta():
    with pytest.raises(ValueError, match="257"):
        lstm_scan.launch_plan(1, 4, 257, 132)


def test_units_beyond_a_cta_run_the_loop(monkeypatch):
    """U over MAX_UNITS (4 U threads a CTA) has no launch plan: the loop
    runs it on either device."""
    calls = _spy(monkeypatch)
    u = lstm_scan.MAX_UNITS + 1
    g = torch.Generator().manual_seed(18)
    p = rnn.LSTMParams(wx=0.1 * torch.randn(IN, 4 * u, generator=g),
                       wh=0.1 * torch.randn(u, 4 * u, generator=g),
                       b=torch.zeros(4 * u))
    xs = torch.randn(3, B, IN, generator=g)
    _, hs = rnn.lstm_scan(p, rnn.lstm_zero_state((B,), u), xs)
    assert calls == []
    assert torch.equal(hs, _loop_scan(p, rnn.lstm_zero_state((B,), u),
                                      xs)[1])
