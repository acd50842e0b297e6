"""Time-axis parallelism (multinn_torch/parallel/seqpipe.py) and the
``model.remat`` flag, on the CPU.

seqpipe runs on a gloo world of 4 CPU ranks as data=2 x seq=2 (spawned by
torch_mesh_ranks under a deadline; rank 0 runs the single-device side),
case by case as tests/test_parallel.py holds the JAX package: the NADE
step in both inter-track modes, the two-layer LSTM with remat, the RBM's
training, evaluation with a short tail and a Hessian-free step, at the
reference's tolerances (loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6;
Hessian-free rtol 1e-3 / atol 1e-5).

remat (nn/rnn.py): checkpointing each step of the recurrence changes no
loss and no gradient, under either matmul policy, saves fewer tensors for
the backward, and the NADE loss and gradients under remat equal
``jax.value_and_grad`` of the JAX model with ``remat=True`` (the flag of
tests/test_longcontext_and_layers.py:68).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_torch.models import base, multinn, rnn_nade, rnn_rbm  # noqa
from multinn_torch.ops import precision, sampling  # noqa: E402
from multinn_torch.parallel import seqpipe  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

STEP_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def w4s(tmp_path_factory):
    out = tmp_path_factory.mktemp("w4s")
    ranks.run_world(out, 4, "w4s")
    return out


def _n(a, prefix):
    return len([k for k in a if k.startswith(prefix)
                and k[len(prefix):].isdigit()])


def _check(out, case, tol=STEP_TOL):
    a = ranks.load(out, case)
    np.testing.assert_allclose(a["loss"], a["ref_loss"], rtol=1e-5)
    n = _n(a, "ref_p")
    assert n == _n(a, "p") > 0
    for i in range(n):
        np.testing.assert_allclose(a[f"p{i}"], a[f"ref_p{i}"], **tol,
                                   err_msg=f"{case} leaf {i}")
    return a


def test_seqpipe_microbatch_autopick():
    assert seqpipe.auto_microbatches(8, 4) == 8       # min(8, 2*4)
    assert seqpipe.auto_microbatches(6, 4) == 6
    assert seqpipe.auto_microbatches(7, 2) == 1       # 7 prime, target 4
    assert seqpipe.auto_microbatches(8, 2, requested=3) == 2  # cap, divisor
    assert seqpipe.auto_microbatches(1, 8) == 1


@pytest.mark.parametrize("mode", ["per-track", "feedback"])
def test_seqpipe_step_matches_single_device(w4s, mode):
    """data=2 x seq=2: the window's halves on two ranks, the RNN carry
    handed over by ppermute in a GPipe schedule (and, in feedback mode,
    the one-frame latent halo); one NADE step equals one device's, on
    every rank."""
    a = _check(w4s, f"seqpipe_{mode}")
    for r in range(1, 4):
        b = ranks.load(w4s, f"seqpipe_{mode}", r)
        for i in range(_n(a, "p")):
            np.testing.assert_array_equal(b[f"p{i}"], a[f"p{i}"])


def test_seqpipe_multilayer_remat_matches_single_device(w4s):
    """Two LSTM layers (the hand-over moves both layers' states) with remat
    inside the pipeline's chunk scans."""
    _check(w4s, "seqpipe_remat")


def test_seqpipe_rbm_training_runs(w4s):
    """The RBM (feedback) under seqpipe, per-shard keys, groups of 2 steps
    run eagerly: two epochs at lr 1e-2 raise the validation
    pseudo-likelihood per frame and the CD loss falls, on every rank."""
    for r in range(4):
        a = ranks.load(w4s, "seqpipe_rbm", r)
        assert np.all(np.isfinite(a["losses"])) and len(a["losses"]) >= 2
        assert a["ll_after"] > a["ll_before"]
        assert a["losses"][-1] < a["losses"][0]
        assert np.isfinite(a["loss_after"])


def test_eval_matches_single_device_with_short_tail_seqpipe(w4s):
    a = ranks.load(w4s, "eval_seqpipe")
    for name in ("loss", "ll_per_frame", "loss_per_track_0",
                 "loss_per_track_1"):
        np.testing.assert_allclose(a[name], a[f"ref_{name}"], rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(a["f1"], a["ref_f1"], rtol=2e-2)


def test_hf_seqpipe_matches_single_device(w4s):
    """The Gauss-Newton products' forward mode passes through the carry's
    ppermute (its jvp) and their transpose through its backward."""
    a = _check(w4s, "hf_seqpipe", tol=dict(rtol=1e-3, atol=1e-5))
    assert a["accepted"] == a["ref_accepted"]


# -- remat --------------------------------------------------------------------

B, T, D = 3, 10, 12


def _decoder_loss(dec, remat, dtype="f32"):
    cfg = base.DecoderConfig(n_visible=D, n_hidden=16, n_rnn=10, remat=remat,
                             gen_k=2)
    params = dec.init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    x = (torch.rand((B, T, D), generator=torch.Generator().manual_seed(1))
         < 0.3).float()
    leaves = [t.requires_grad_(True) for t in multinn.tree_leaves(params)]
    counted = []
    with precision.matmul_precision(dtype), \
            torch.autograd.graph.saved_tensors_hooks(
                lambda t: counted.append(t.numel()) or t, lambda t: t):
        loss, _ = dec.loss(params, sampling.PRNGKey(2), x)
    with precision.matmul_precision(dtype):
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, sum(counted)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dec", [rnn_rbm, rnn_nade])
def test_remat_matches_norematerialization(dec, dtype):
    """Checkpointing changes no loss value and no gradient (the recompute
    runs under the forward's matmul policy)."""
    l0, g0, _ = _decoder_loss(dec, False, dtype)
    l1, g1, _ = _decoder_loss(dec, True, dtype)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dec", [rnn_rbm, rnn_nade])
def test_remat_saves_fewer_tensors(dec):
    """The backward keeps each step's carry and hoisted input product,
    not its gates: fewer saved elements. The step loop (it runs the bf16
    policy) does so under remat only; the LSTM Function (f32) always does,
    so remat changes nothing there, and it keeps no more than the
    checkpointed loop."""
    _, _, loop_plain = _decoder_loss(dec, False, "bf16")
    _, _, loop_remat = _decoder_loss(dec, True, "bf16")
    assert loop_remat < loop_plain, (loop_remat, loop_plain)
    _, _, plain = _decoder_loss(dec, False)
    _, _, remat = _decoder_loss(dec, True)
    assert remat == plain <= loop_remat, (remat, plain, loop_remat)


def test_remat_flag_matches_jax():
    """model.remat=True in both packages: the NADE loss and gradients from
    the same params equal jax.value_and_grad of the JAX model's."""
    cfg = jax_multinn.MultINNConfig(n_tracks=2, n_pitches=D, mode="feedback",
                                    decoder_type="rnn-nade", n_hidden=16,
                                    n_rnn=10, rnn_layers=2, remat=True)
    jparams = jax_multinn.init(jax.random.PRNGKey(0), cfg)
    x = (np.random.default_rng(1).random((B, T, 2, D)) < 0.3).astype(
        np.float32)
    (want, _), jgrads = jax.value_and_grad(
        lambda p: jax_multinn.loss(p, jax.random.PRNGKey(2), jnp.asarray(x),
                                   detailed=False), has_aux=True)(jparams)
    params = from_jax(jparams, device="cpu")
    assert params.cfg.remat and params.decoder.cfg.remat
    leaves = [t.requires_grad_(True)
              for t in multinn.tree_leaves(params.decoder)]
    loss, _ = multinn.loss(params, sampling.PRNGKey(2), torch.from_numpy(x),
                           detailed=False)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads, multinn.tree_leaves(
            from_jax(jgrads, device="cpu").decoder)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
