"""multinn_torch's generation with DBN encoders against the JAX package
on the CPU, at a latent width of 6 (the kernels run at D = feature_dim,
the feedback context K*6 wide):

* the fused path's plain version bit-equal to the Pallas kernels in
  interpret mode for both families and a shared or per-track encoder,
  the latent roll decoded under fold_in(key, 0x5eed) (per-track: split of
  that key over the tracks) at a temperature that also scales the decode
  logits;
* the public ``sample_step`` (the scan path's step, its decode under the
  ``kd`` key) bit-equal to JAX's with the JAX Gibbs chain and NADE
  sampler run as the Pallas kernels in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gibbs_pallas, nade_pallas  # noqa: E402
from multinn_tpu.ops import nade_ops as jax_nade_ops  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import sampling  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
K, D = 2, 24
MODEL = dict(n_tracks=K, n_pitches=D, n_hidden=10, n_rnn=6, cd_k=1, gen_k=2,
             w_std=0.5, encoder_hidden=(6,))
DBN_CASES = [("rnn-nade", "feedback"), ("rnn-rbm", "per-track"),
             ("rnn-nade", "hybrid")]


@pytest.fixture
def interpret_samplers(monkeypatch):
    """The JAX dispatch runs the Pallas Gibbs chain and NADE sampler in
    interpret mode, so it draws the port's stream."""
    chain = gibbs_pallas.gibbs_chain
    monkeypatch.setenv("MULTINN_GIBBS_IMPL", "pallas")
    monkeypatch.setattr(
        gibbs_pallas, "gibbs_chain",
        lambda key, v0, w, bv, bh, k, interpret=True: chain(
            key, v0, w, bv, bh, k, True))
    monkeypatch.setattr(
        jax_nade_ops, "nade_sample",
        lambda key, w, v, bv, bh, batch_shape=(), impl="auto":
            nade_pallas.sample(key, w, v, bv, bh, batch_shape, True))


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _roll(shape, seed, density=0.3):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.float32)


def _jax_params(decoder, mode, seed=0):
    return jax_multinn.init(jax.random.PRNGKey(seed),
                            jax_multinn.MultINNConfig(**dict(
                                MODEL, decoder_type=decoder, mode=mode)))


@pytest.mark.parametrize("decoder,mode", DBN_CASES)
def test_fused_dbn_generation_bit_equal_to_pallas_interpret(decoder, mode):
    """A latent width of 6: the kernels run at D = feature_dim, the
    feedback context K*6 wide; the roll is decoded under fold_in(key,
    0x5eed), per-track encoders on split of that key."""
    jp = _jax_params(decoder, mode, seed=2)
    tp = from_jax(jp, device="cpu")
    seed = _roll((3, 4, K, D), 9)
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, 3),
                           jnp.asarray(seed))
    ts = multinn.prime(tp, multinn.init_state(tp, 3), t(seed))
    temp = 0.7                 # tempers the decoder and the decode logits
    jfin, jroll = jax_multinn._generate_fused(
        jax_multinn.tempered_params(jp, temp), jax.random.PRNGKey(6), js, 7,
        interpret=True, dec_beta=1.0 / temp)
    tfin, troll = multinn._generate_fused(
        multinn.tempered_params(tp, temp), sampling.PRNGKey(6), ts, 7,
        dec_beta=1.0 / temp)
    assert troll.shape == (3, 7, K, D)
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_array_equal(tfin.decoder.v_prev.numpy(),
                                  np.asarray(jfin.decoder.v_prev))
    # generate() picks the kernel and passes the decode temperature
    _, auto = multinn.generate(tp, sampling.PRNGKey(6), ts, 7,
                               temperature=temp)
    np.testing.assert_array_equal(auto.numpy(), troll.numpy())


@pytest.mark.parametrize("decoder,mode", DBN_CASES)
def test_sample_step_matches_jax(decoder, mode, interpret_samplers):
    """The public sample_step (the scan path's step): the track keys and
    the decode key ``kd`` split as JAX's, the same samplers."""
    jp = _jax_params(decoder, mode, seed=3)
    tp = from_jax(jp, device="cpu")
    js, ts = jax_multinn.init_state(jp, 3), multinn.init_state(tp, 3)
    jstep = jax.jit(lambda st, kk: jax_multinn.sample_step(
        jp, kk, st, temperature=0.8))
    for step in range(3):
        js, jf = jstep(js, jax.random.PRNGKey(step))
        ts, tf = multinn.sample_step(tp, sampling.PRNGKey(step), ts,
                                     temperature=0.8)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ts.decoder.v_prev.numpy(),
                                      np.asarray(js.decoder.v_prev))
    _, roll = multinn.generate(tp, sampling.PRNGKey(0), multinn.init_state(
        tp, 3), 3, fused=False)
    assert roll.shape == (3, 3, K, D)
