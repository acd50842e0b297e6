"""multinn_torch's Hessian-free optimizer (training/hf.py) and its trainer
wiring against the JAX package's (multinn_tpu/training/hf.py) on the CPU.

* ``_ce_weights`` equal JAX's; ``_ce_loss`` of ``conditional_logits``
  equals the port's ``multinn.loss`` in every mode, with and without a
  frame mask and a DBN encoder (rtol 1e-5).
* The GGN matvec (G + lam I) v on a fixed v equals the JAX package's
  (jvp + vjp through its conditional logits) within 1e-5 of max |ref|,
  and v.Gv >= 0 at lam = 0.
* One ``hf_step`` (cg_iters=5) from the same params, batch and mask: lam
  and ``accepted`` equal, the metrics within rtol 1e-4 (rho is a ratio of
  differences), the params within 1e-5 of max |p|; three in a row agree
  too. A step pins the f32 policy. With a DBN and cg_iters=0 the step's
  gradient norm is the true loss gradient's.
* The Trainer: an RBM is refused; HF train_step equals the JAX trainer's
  HF step; a captured group (a recorder in place of the CUDA graph)
  equals the eager group; checkpoints round-trip the HFState and a
  fault-injected run resumes to the uninterrupted run's tensors
  bit-exactly; ``pretrain_encoders`` under HF with the bf16 policy
  rebuilds the HFState and trains (tests/test_hf.py:178); the CLI trains
  with ``--train.optimizer=hf``.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.training import hf as jax_hf  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import precision, sampling  # noqa: E402
from multinn_torch.training import hf, trainer  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax, to_numpy  # noqa: E402

torch.set_num_threads(1)
K, D, T, B = 3, 10, 6, 4
MASK = (np.arange(T)[None] < np.array([6, 5, 3, 6])[:, None]).astype(
    np.float32)


_jax_init = jax.jit(jax_multinn.init, static_argnums=1)


def _jax_hf_step(cg_iters):
    """The JAX macro-step, jitted (its eager op-by-op form is slow)."""
    return jax.jit(lambda p, s, x, k, m: jax_hf.hf_step(
        p, s, x, k, frame_mask=m, cg_iters=cg_iters))


def _setup(mode="per-track", enc=(), seed=0):
    cfg = jax_multinn.MultINNConfig(n_tracks=K, n_pitches=D, mode=mode,
                                    decoder_type="rnn-nade", n_hidden=12,
                                    n_rnn=8, w_std=0.2, encoder_hidden=enc)
    jp = _jax_init(jax.random.PRNGKey(seed), cfg)
    x = (np.random.default_rng(seed + 1).random((B, T, K, D)) < 0.25
         ).astype(np.float32)
    return jp, from_jax(jp, device="cpu"), x


def _mask(on):
    return torch.from_numpy(MASK) if on else None


@pytest.mark.parametrize("mode", ["per-track", "feedback", "joint",
                                  "hybrid"])
@pytest.mark.parametrize("mask", [False, True])
def test_ce_objective_equals_the_port_loss(mode, mask):
    jp, tp, x = _setup(mode)
    xt = torch.from_numpy(x)
    ref, _ = multinn.loss(tp, sampling.PRNGKey(9), xt, detailed=False,
                          frame_mask=_mask(mask))
    logits, targets = multinn.conditional_logits(tp, xt)
    w_tb = hf._ce_weights(tp.cfg, xt.shape, _mask(mask))
    np.testing.assert_allclose(
        w_tb.numpy(), np.asarray(jax_hf._ce_weights(
            jp.cfg, x.shape, jnp.asarray(MASK) if mask else None)),
        rtol=1e-7)
    got = hf._ce_loss(logits, targets, w_tb)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_ce_objective_with_a_dbn_encoder():
    _, tp, x = _setup("feedback", enc=(6,))
    xt = torch.from_numpy(x)
    ref, _ = multinn.loss(tp, sampling.PRNGKey(0), xt, detailed=False,
                          frame_mask=_mask(True))
    logits, targets = multinn.conditional_logits(tp, xt)
    got = hf._ce_loss(logits, targets,
                      hf._ce_weights(tp.cfg, xt.shape, _mask(True)))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def _port_leaves(tp, leaves):
    """Decoder tensors in tree_leaves order -> to_numpy's decoder tree."""
    it = iter(leaves)
    return to_numpy(dataclasses.replace(
        tp, decoder=multinn.tree_map(lambda _: next(it), tp.decoder))).decoder


def _named_arrays(dec):
    """name -> array over a decoder namespace or JAX Params."""
    out = {n: np.asarray(getattr(dec, n))
           for n in ("w", "v", "bv", "bh", "wuv", "wuh")}
    for i, c in enumerate(dec.cell):
        out.update({f"cell{i}.{n}": np.asarray(getattr(c, n))
                    for n in ("wx", "wh", "b")})
    return out


@pytest.mark.parametrize("mode", ["feedback", "joint"])
def test_ggn_matvec_equals_jax(mode):
    jp, tp, x = _setup(mode, seed=2)
    lam = 0.3
    rng = np.random.default_rng(5)
    v_j = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(0, 1, a.shape), jnp.float32), jp)
    v_t = from_jax(v_j, device="cpu")

    def logits_fn(p):
        return jax_multinn.conditional_logits(p, jnp.asarray(x))[0]

    logits0, vjp_fn = jax.vjp(logits_fn, jp)
    p0 = jax.nn.sigmoid(logits0)
    w_tb = jax_hf._ce_weights(jp.cfg, x.shape, None)
    _, jv = jax.jvp(logits_fn, (jp,), (v_j,))
    (gv,) = vjp_fn(p0 * (1 - p0) * w_tb[None, :, :, None] * jv)
    want = _named_arrays(jax_hf._axpy(lam, v_j, gv).decoder)

    theta = multinn.tree_leaves(tp.decoder)
    live = [t.clone().requires_grad_(True) for t in theta]
    xt = torch.from_numpy(x)
    gnvp = hf._ggn_matvec(tp, theta, live, xt,
                          hf._ce_weights(tp.cfg, xt.shape, None),
                          torch.tensor(lam))
    v = multinn.tree_leaves(v_t.decoder)
    got = _named_arrays(_port_leaves(tp, gnvp(v)))
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
    # PSD at lam = 0, and a second product on the kept graph
    g0 = hf._ggn_matvec(tp, theta, live, xt,
                        hf._ce_weights(tp.cfg, xt.shape, None),
                        torch.tensor(0.0))
    for s in range(2):
        vs = [torch.randn(t.shape, generator=torch.Generator().manual_seed(s))
              for t in theta]
        assert float(hf._dot(vs, g0(vs))) >= -1e-6


@pytest.mark.parametrize("mode", ["per-track", "feedback", "joint"])
def test_hf_steps_equal_jax(mode):
    jp, tp, x = _setup(mode)
    js, ts = jax_hf.init_state(jp, 1.0), hf.init_state(tp, 1.0)
    step = _jax_hf_step(5)
    for _ in range(3):
        jp, js, jm = step(jp, js, jnp.asarray(x), jax.random.PRNGKey(2),
                          jnp.asarray(MASK))
        tp, ts, tm = hf.hf_step(tp, ts, torch.from_numpy(x),
                                sampling.PRNGKey(2),
                                frame_mask=torch.from_numpy(MASK),
                                cg_iters=5)
        assert float(ts.lam) == float(js.lam)
        assert int(ts.accepted) == int(js.accepted)
        for name in ("loss", "hf_rho", "hf_q", "hf_cg_residual",
                     "grad_norm", "hf_accepted", "hf_lambda"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4, atol=1e-7, err_msg=name)
    assert int(ts.accepted) == 3
    got = _named_arrays(to_numpy(tp).decoder)
    want = _named_arrays(jp.decoder)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def test_hf_step_pins_f32_and_gradient_is_the_true_one():
    """Under an outer bf16 policy the step computes in f32 (the same
    numbers as without it); with a DBN encoder and cg_iters=0 the step's
    grad_norm is the norm of the true loss gradient."""
    jp, tp, x = _setup("per-track", enc=(6,), seed=3)
    xt = torch.from_numpy(x)
    st = hf.init_state(tp, 1.0)
    with precision.matmul_precision("bf16"):
        _, _, m16 = hf.hf_step(tp, st, xt, sampling.PRNGKey(2), cg_iters=2)
    _, _, m32 = hf.hf_step(tp, st, xt, sampling.PRNGKey(2), cg_iters=2)
    for name in m32:
        assert torch.equal(m16[name], m32[name]), name
    _, _, m0 = hf.hf_step(tp, st, xt, sampling.PRNGKey(2), cg_iters=0)
    leaves = [t.clone().requires_grad_(True)
              for t in multinn.tree_leaves(tp.decoder)]
    loss = multinn.loss(hf._with_decoder(tp, leaves), sampling.PRNGKey(2),
                        xt, detailed=False)[0]
    g = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(m0["grad_norm"]),
                               float(hf._dot(g, g).sqrt()), rtol=1e-5)
    _, _, jm = _jax_hf_step(0)(jp, jax_hf.init_state(jp, 1.0),
                               jnp.asarray(x), jax.random.PRNGKey(2), None)
    np.testing.assert_allclose(float(m0["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)


DATA = dict(dataset="synthetic", n_tracks=2, pitch_min=48, pitch_max=71,
            window=6, batch_size=3, synthetic_songs=6, synthetic_steps=20)
MODEL = dict(n_tracks=2, n_pitches=24, mode="feedback", n_hidden=6, n_rnn=4,
             decoder_type="rnn-nade", w_std=0.5)


def _cfg(run_dir, model=None, **train):
    return config.ExperimentConfig(
        name="hf", data=config.DataConfig(**DATA),
        model=multinn.MultINNConfig(**(model or MODEL)),
        train=config.TrainConfig(**dict(dict(
            epochs=2, optimizer="hf", hf_cg_iters=4, seed=5,
            steps_per_call=2, log_every_steps=2, ckpt_every_steps=0,
            run_dir=str(run_dir)), **train))).validate()


def test_trainer_hf_step_equals_the_jax_trainer(tmp_path):
    from multinn_tpu.data.datasets import DataConfig, Dataset
    ds = Dataset(DataConfig(**DATA))
    jp = _jax_init(jax.random.PRNGKey(1), jax_multinn.MultINNConfig(**MODEL))
    with pytest.raises(ValueError, match="rnn-nade"):
        trainer.Trainer(_cfg(tmp_path / "rbm", dict(
            MODEL, decoder_type="rnn-rbm")), ds, device="cpu")
    tr = trainer.Trainer(_cfg(tmp_path / "t", hf_lambda0=2.0), ds,
                         params=from_jax(jp, device="cpu"))
    assert isinstance(tr.opt_state, hf.HFState)
    js = jax_hf.init_state(jp, 2.0)
    rng = jax.random.split(jax.random.PRNGKey(5))[0]
    step = _jax_hf_step(4)
    for batch in list(ds.batches("train", epoch=0, augment=True))[:2]:
        rng, k = jax.random.split(rng)
        jp, js, jm = step(jp, js, jnp.asarray(batch, jnp.float32), k, None)
        tr.rng, tk = sampling.split(tr.rng)
        m = tr.train_step(tr._to_device(batch), tk)
        assert set(m) == set(jm)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(tr.opt_state.lam) == float(js.lam)
    got = _named_arrays(to_numpy(tr.params).decoder)
    for name, ref in _named_arrays(jp.decoder).items():
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
    tr.close()


class RecorderGraph:
    """The CudaGraph interface without a card (as test_torch_train_loop's):
    capture runs the group once, replay runs it again and refreshes the
    outputs."""

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        new = self.fn()
        with torch.no_grad():
            for k, v in new.items():
                self.out[k].copy_(v)


def test_captured_hf_group_equals_eager(tmp_path):
    eager = trainer.Trainer(_cfg(tmp_path / "e"), device="cpu")
    graph = trainer.Trainer(_cfg(tmp_path / "g"), params=eager.params)
    graph.capture_groups = True
    graph._new_graph = RecorderGraph
    batches = list(eager.dataset.batches("train", epoch=0))
    state0 = [t.clone() for t in eager._state_tensors()]
    graph.run_group(np.stack(batches[:2]), sampling.PRNGKey(9))  # capture
    eager._load_state_tensors(state0)
    graph._load_state_tensors(state0)
    for i in range(2):
        xs, k = np.stack(batches[i:i + 2]), sampling.PRNGKey(20 + i)
        got, want = graph.run_group(xs, k), eager.run_group(xs, k)
        assert {"hf_rho", "hf_lambda", "hf_q", "hf_cg_residual",
                "hf_accepted", "grad_norm", "loss_mean"} <= set(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
        for a, b in zip(graph._state_tensors(), eager._state_tensors()):
            assert torch.equal(a, b)
    assert int(eager.opt_state.accepted) >= 1
    eager.close()
    graph.close()


def test_checkpoint_round_trip_and_exact_resume(tmp_path):
    whole = trainer.Trainer(_cfg(tmp_path / "whole", ckpt_every_steps=2),
                            device="cpu")
    ev0 = whole.evaluate("valid")
    whole.train()
    ev1 = whole.evaluate("valid")
    assert np.isfinite(ev1["loss"]) and ev1["loss"] < ev0["loss"]
    whole.save_checkpoint()
    whole.ckpt.wait()
    back = trainer.Trainer(_cfg(tmp_path / "whole", ckpt_every_steps=2),
                           device="cpu")
    back.restore()
    for a, b in zip(back._state_tensors(), whole._state_tensors()):
        assert torch.equal(a, b)
    assert isinstance(back.opt_state, hf.HFState)
    cfg = _cfg(tmp_path / "fault", ckpt_every_steps=2, fault_inject_step=3)
    first = trainer.Trainer(cfg, device="cpu")
    with pytest.raises(trainer.FaultInjected):
        first.train()
    again = trainer.Trainer(_cfg(tmp_path / "fault", ckpt_every_steps=2),
                            device="cpu")
    assert again.maybe_resume() and again.step == 2
    again.train()
    assert again.step == whole.step
    for a, b in zip(again._state_tensors(), whole._state_tensors()):
        assert torch.equal(a, b)
    for t in (whole, back, first, again):
        t.close()


def test_hf_with_dbn_pretraining_and_bf16_policy(tmp_path):
    """tests/test_hf.py:178 on the port: pretrain_encoders under HF
    rebuilds the HFState in place (lam back to hf_lambda0, no warm start),
    and HF trains under matmul_dtype='bf16' (the step pins f32)."""
    model = dict(MODEL, encoder_hidden=(10,), matmul_dtype="bf16",
                 n_hidden=16, n_rnn=12)
    tr = trainer.Trainer(_cfg(tmp_path / "dbn", model,
                              pretrain_encoder_epochs=1, hf_lambda0=0.7),
                         device="cpu")
    ids = [id(t) for t in tr._state_tensors()]
    tr.opt_state.lam.fill_(3.0)
    tr.opt_state.delta[0].fill_(1.0)
    tr.pretrain_encoders()
    assert [id(t) for t in tr._state_tensors()] == ids
    assert float(tr.opt_state.lam) == pytest.approx(0.7)
    assert all(float(d.abs().sum()) == 0 for d in tr.opt_state.delta)
    ev0 = tr.evaluate("valid")
    tr.train()
    ev1 = tr.evaluate("valid")
    assert isinstance(tr.opt_state, hf.HFState)
    assert np.isfinite(ev1["loss"]) and ev1["loss"] < ev0["loss"]
    tr.close()


def test_cli_trains_with_hf(tmp_path):
    from multinn_torch import train as train_cli
    run = str(tmp_path / "run")
    assert train_cli.main([
        "--config", "configs/synthetic_smoke.json", "--device", "cpu",
        "--model.decoder_type=rnn-nade", "--train.optimizer=hf",
        "--train.hf_cg_iters=3", "--train.log_every_steps=1",
        "--model.n_hidden=8", "--model.n_rnn=6",
        "--data.window=16", "--data.synthetic_songs=8",
        "--data.synthetic_steps=48", "--train.epochs=1",
        f"--train.run_dir={run}"]) == 0
    with open(os.path.join(run, "metrics.jsonl")) as f:
        text = f.read()
    assert "hf_lambda" in text and "hf_rho" in text
