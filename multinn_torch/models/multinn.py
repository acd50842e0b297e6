"""MultINN — the multi-track model — port of multinn_tpu/models/multinn.py.

Inter-track modes ``per-track``, ``feedback``, ``hybrid`` and ``joint``
(alias ``composer``), pass-through and DBN encoders (one shared encoder in
feedback / hybrid mode, one per track in per-track mode, one over the
concatenated tracks in joint mode), both decoder families, RNN-RBM and
RNN-NADE. Per-track decoder and encoder params are STACKED along a leading
track axis K, as in the JAX package; where it vmaps over tracks the port
batches the same computation over that axis (nn/rnn.py), and loops over
tracks only where a kernel or a function takes one decoder or encoder (the
scan path's Gibbs chain or NADE sweep, the CD chain, a per-track encoder).

Joint mode has ONE decoder over the K*D-wide concatenated frame. The JAX
package keeps it unstacked; the port keeps it as a stack of one track
(leading axis 1, states (1, B, ...)), the layout the whole-generation
kernels take it in (gen_common._eff_dims), so every decoder function runs
unchanged. Its single decoder draws on the step's key itself, not on
``split(key, K)[0]``, as the JAX package's; ``utils/convert.py`` adds and
drops the axis. Accompaniment raises in joint mode.

Generation, accompaniment included, runs in the decoders' feature space;
with a DBN the latent frames are decoded to pianoroll by sampling the
decode conditional. Pianorolls are (B, T, K, D).

Under a mesh (``shard``, a parallel.mesh.Shard of a global-view
computation) x holds this rank's batch rows and tracks, and the decoder
(and per-track encoders) this rank's tracks: the feedback context gathers
the per-frame latents of all K tracks over ``track`` once per window (in
generation once per step), track i draws under ``split(key, K)[i]`` of
the whole K, the per-track metrics are gathered over ``track`` before
their mean, and the returned loss is this rank's share of the mean over
tracks (its tracks' sum / K), whose gradients are its tracks' parameters'.
The samplers draw each row's stream in the whole batch (the row map); a
DBN's decode draws over the whole batch, gathered over ``data`` first.
``seq``: x is this rank's time chunk (parallel/seqpipe.py).

A DBN decode inside a card interval (utils/profiling.card_interval: the
service's ``serve.card`` while the span recorder times its card) records
its own as the span ``gen.dbn_decode``, with the batch's index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from multinn_torch.models import encoders as enc_mod
from multinn_torch.models.base import DecoderConfig, get_decoder
from multinn_torch.models.encoders import EncoderConfig
from multinn_torch.nn import rnn as rnn_nn
from multinn_torch.ops import sampling
from multinn_torch.parallel import comm
from multinn_torch.training.metrics import FRAME_COUNTS
from multinn_torch.utils import profiling
from multinn_torch.utils.device import entry_device

MODES = ("per-track", "feedback", "joint", "hybrid")
MODE_ALIASES = {"jamming": "per-track", "composer": "joint"}


@dataclasses.dataclass(frozen=True)
class MultINNConfig:
    """Experiment-level model config (field names and defaults as the JAX
    package's)."""

    n_tracks: int = 5
    n_pitches: int = 88
    mode: str = "per-track"
    decoder_type: str = "rnn-rbm"
    encoder_hidden: Tuple[int, ...] = ()     # () = pass-through encoder
    n_hidden: int = 150
    n_rnn: int = 100
    cell: str = "lstm"
    rnn_layers: int = 1
    cd_k: int = 1
    gen_k: int = 10
    w_std: float = 0.01
    remat: bool = False
    matmul_dtype: str = "f32"

    def __post_init__(self):
        if self.mode in MODE_ALIASES:
            object.__setattr__(self, "mode", MODE_ALIASES[self.mode])
        if self.mode not in MODES:
            raise ValueError(
                f"mode must be one of {MODES} (aliases: "
                f"{sorted(MODE_ALIASES)}), got {self.mode}")
        if self.matmul_dtype not in ("f32", "float32", "bf16", "bfloat16"):
            raise ValueError(
                f"matmul_dtype must be f32 or bf16, got {self.matmul_dtype}")

    @property
    def shared_encoder(self) -> bool:
        return self.mode in ("feedback", "hybrid")

    def encoder_config(self) -> EncoderConfig:
        n_in = (self.n_pitches * self.n_tracks if self.mode == "joint"
                else self.n_pitches)
        return EncoderConfig(n_in=n_in, hidden_sizes=self.encoder_hidden,
                             w_std=self.w_std)

    def feature_dim(self) -> int:
        return enc_mod.out_dim(self.encoder_config())

    def ctx_dim(self) -> int:
        """Feedback context width: latents of all K tracks, concatenated."""
        return (self.n_tracks * self.feature_dim()
                if self.mode == "feedback" else 0)

    def decoder_config(self) -> DecoderConfig:
        return DecoderConfig(
            n_visible=self.feature_dim(), n_hidden=self.n_hidden,
            n_rnn=self.n_rnn, n_ctx=self.ctx_dim(), cell=self.cell,
            rnn_layers=self.rnn_layers, cd_k=self.cd_k, gen_k=self.gen_k,
            w_std=self.w_std, remat=self.remat)


@dataclasses.dataclass
class MultINNParams:
    encoder: object     # () for pass-through encoders
    decoder: object     # track-stacked rnn_rbm.Params | rnn_nade.Params
    cfg: MultINNConfig


@dataclasses.dataclass
class MultINNState:
    """Generation state: track-stacked decoder states and the feedback
    context (None when unused)."""
    decoder: object
    ctx: Optional[torch.Tensor]


# ---------------------------------------------------------------------------
# trees of tensors (dataclasses / tuples): the port's vmap plumbing
# ---------------------------------------------------------------------------

def tree_map(fn, *trees):
    """Map ``fn`` over the tensors of trees of tuples and (mutable) param /
    state dataclasses; frozen config dataclasses and None pass through."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    if dataclasses.is_dataclass(t0) and not t0.__dataclass_params__.frozen:
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    return t0


def tree_leaves(tree) -> list:
    """The tensors of a tree, in field order (``tree_map``'s traversal)."""
    out = []
    tree_map(out.append, tree)
    return out


def with_leaves(tree, leaves):
    """``tree`` with its tensors replaced, in ``tree_leaves`` order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def stack_trees(trees):
    """Per-track trees -> one tree with a leading track axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def index_tree(tree, i: int):
    """Track ``i`` of a track-stacked tree."""
    return tree_map(lambda x: x[i], tree)


def n_decoders(cfg: MultINNConfig) -> int:
    """Decoders in the stack: one in joint mode, else one per track."""
    return 1 if cfg.mode == "joint" else cfg.n_tracks


def _decoder_keys(cfg: MultINNConfig, key: torch.Tensor,
                  shard=None) -> torch.Tensor:
    """One key per decoder: ``split(key, K)``, or in joint mode the key
    itself (the JAX package's single decoder draws on it); under a track
    split this rank's tracks' keys."""
    if cfg.mode == "joint":
        return key[None]
    keys = sampling.split(key, cfg.n_tracks)
    return keys if _track_group(shard) is None else keys[
        shard.tracks(cfg.n_tracks)]


def _track_group(shard):
    return None if shard is None else shard.track


def _all_tracks(t: torch.Tensor, shard) -> torch.Tensor:
    """Track-major t (K_local, ...) -> every rank's tracks (K, ...)."""
    return comm.all_gather(t, 0, _track_group(shard))


def init(cfg: MultINNConfig, generator: Optional[torch.Generator] = None,
         device=None) -> MultINNParams:
    """Random params with the JAX package's shapes and init distributions
    (normal(0, w_std) weights, zero biases, LSTM forget-gate bias 1),
    drawn on the CPU from ``generator`` (the decoders track by track, then
    the encoder or each track's encoder, so a seed gives the same values on
    every device) and placed on ``device``: the CUDA card when None, which
    raises without one. Joint mode: one decoder (a stack of one) and one
    encoder over K*D pitches."""
    device = entry_device(device)
    dec = get_decoder(cfg.decoder_type)
    dcfg, ecfg = cfg.decoder_config(), cfg.encoder_config()
    decoder = stack_trees([dec.init(dcfg, generator=generator, device="cpu")
                           for _ in range(n_decoders(cfg))])
    if cfg.mode != "per-track":
        encoder = enc_mod.init(ecfg, generator=generator, device="cpu")
    else:
        encoder = stack_trees([enc_mod.init(ecfg, generator=generator,
                                            device="cpu")
                               for _ in range(cfg.n_tracks)])
    move = lambda x: x.to(device)
    return MultINNParams(encoder=tree_map(move, encoder),
                         decoder=tree_map(move, decoder), cfg=cfg)


def _per_track_encoder(params: MultINNParams) -> bool:
    """True when each track has a DBN encoder of its own (stacked)."""
    return bool(params.encoder) and params.cfg.mode == "per-track"


def _encode_tracks(params: MultINNParams, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, K, D) -> decoder-facing features, tracks-first (K, B, T, F):
    the frames for pass-through encoders, binary and detached DBN features
    otherwise (enc_mod.features), one encoder for all tracks or each
    track's own. Joint mode: the concatenated frames (1, B, T, K*D) through
    its one encoder."""
    if params.cfg.mode == "joint":
        b, t, k, d = x.shape
        return enc_mod.features(params.encoder, x.reshape(b, t, k * d))[None]
    xk = x.movedim(2, 0)
    if not _per_track_encoder(params):
        return enc_mod.features(params.encoder, xk)
    return torch.stack([enc_mod.features(index_tree(params.encoder, i),
                                         xk[i])
                        for i in range(xk.shape[0])])


def _decode_sample(encoder, key: torch.Tensor, lat: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    """Latent -> binary pianoroll by sampling the DBN decode conditional
    p(v | h) (a threshold at 0.5 would emit silence for sparse music, whose
    decode probabilities sit far below it). ``beta`` = 1 / temperature
    scales the conditional's logits."""
    logits = enc_mod.decode_logits(encoder, lat)
    if beta != 1.0:
        logits = logits * beta
    return sampling.bernoulli(key, torch.sigmoid(logits))


def _decode_tracks(params: MultINNParams, key: torch.Tensor,
                   lat_k: torch.Tensor, beta: float = 1.0,
                   shard=None) -> torch.Tensor:
    """Track-major latents of all K tracks (K, ...) -> pianoroll frames
    (K, ...): the shared encoder decodes all tracks under ``key``,
    per-track encoders decode track i under ``split(key, K)[i]`` (under a
    track split each rank its tracks, then gathered)."""
    with profiling.card_interval("gen.dbn_decode"):
        if not _per_track_encoder(params):
            return _decode_sample(params.encoder, key, lat_k, beta)
        k = params.cfg.n_tracks
        keys = sampling.split(key, k)
        mine = (range(k) if _track_group(shard) is None
                else range(k)[shard.tracks(k)])
        return _all_tracks(torch.stack([
            _decode_sample(index_tree(params.encoder, j), keys[i], lat_k[i],
                           beta) for j, i in enumerate(mine)]), shard)


def _flatten_latents(vs: torch.Tensor) -> torch.Tensor:
    """Track-major latents (K, B, F) -> feedback-context rows (B, K*F)."""
    k, b, f = vs.shape
    return vs.movedim(0, 1).reshape(b, k * f)


def _feedback_ctx(feats_k: torch.Tensor,
                  prefix: Optional[torch.Tensor] = None,
                  seq=None) -> torch.Tensor:
    """Teacher-forced feedback context: latents of all tracks at t-1.
    feats_k (K, B, T, F) -> (B, T, K*F); row t=0 is ``prefix`` or zeros.
    Under time sharding (``seq``) the shift crosses the chunk boundary
    (seqpipe.shift_right_seq; zeros into the first chunk)."""
    k, b, t, f = feats_k.shape
    lat = feats_k.permute(1, 2, 0, 3).reshape(b, t, k * f)
    if seq is not None:
        if prefix is not None:
            raise ValueError("a prefix context cannot enter a time-sharded "
                             "window: the seqpipe halo starts from zeros")
        from multinn_torch.parallel import seqpipe
        return seqpipe.shift_right_seq(lat, seq)
    first = (torch.zeros_like(lat[:, :1]) if prefix is None
             else prefix[:, None].to(lat.dtype))
    return torch.cat([first, lat[:, :-1]], dim=1)


def _mean_tree(metrics: dict) -> dict:
    """Per-track metrics (K,) -> their mean over tracks."""
    return {k: v.mean(dim=0) for k, v in metrics.items()}


def _track_inputs(params: MultINNParams, x: torch.Tensor, shard=None,
                  seq=None):
    """(B, T, K, D) -> the decoders' features (K, B, T, F) and, in feedback
    mode, each track's teacher-forced context (K, B, T, K*F) — under a
    track split this rank's tracks, their context from every rank's."""
    cfg = params.cfg
    feats_k = _encode_tracks(params, x)
    if cfg.mode != "feedback":
        return feats_k, None
    ctx = _feedback_ctx(_all_tracks(feats_k, shard), seq=seq)
    return feats_k, ctx.expand(feats_k.shape[0], *ctx.shape)


def loss(params: MultINNParams, key: torch.Tensor, x: torch.Tensor,
         detailed: bool = True, frame_mask: Optional[torch.Tensor] = None,
         impl=None, shard=None, seq=None):
    """Teacher-forced loss over all tracks, x (B, T, K, D); frame_mask
    (B, T). Returns (loss, metrics): the metrics averaged over tracks, the
    per-track losses under ``loss_per_track`` ((1,) in joint mode). Track
    i's key is ``split(key, K)[i]`` (joint mode: ``key``).
    ``detailed=False`` is the trainer's hot path; ``impl`` forces the
    decoder's kernels or their plain versions; ``shard`` / ``seq``: a
    mesh's part (module docstring); rows split over ``data`` add every
    track's frame counts, (K, 5) under ``metrics.FRAME_COUNTS``."""
    cfg = params.cfg
    feats_k, ctx = _track_inputs(params, x, shard, seq)
    keys = _decoder_keys(cfg, key, shard)
    losses, metrics = get_decoder(cfg.decoder_type).loss(
        params.decoder, keys, feats_k, ctx=ctx, detailed=detailed,
        frame_mask=frame_mask, impl=impl, shard=shard, seq=seq)
    if _track_group(shard) is not None:
        with torch.no_grad():
            metrics = {k: _all_tracks(v, shard) for k, v in metrics.items()}
            every = _all_tracks(losses.detach(), shard)
        total, value = losses.sum() / cfg.n_tracks, every.mean()
    else:
        every, total = losses.detach(), losses.mean()
        value = total.detach()
    counts = metrics.pop(FRAME_COUNTS, None)        # (K, 5): kept per track
    metrics = _mean_tree(metrics)
    if counts is not None:
        metrics[FRAME_COUNTS] = counts
    metrics["loss_per_track"] = every
    metrics["loss"] = value
    return total, metrics


def log_likelihood(params: MultINNParams, key: torch.Tensor,
                   x: torch.Tensor,
                   frame_mask: Optional[torch.Tensor] = None, shard=None,
                   seq=None) -> torch.Tensor:
    """Per-sequence LL summed over tracks and time, (B,): exact for NADE
    decoders, the pseudo-LL proxy for RBM decoders (under ``seq`` this
    rank's time chunk)."""
    cfg = params.cfg
    feats_k, ctx = _track_inputs(params, x, shard, seq)
    lls = get_decoder(cfg.decoder_type).log_likelihood_proxy(
        params.decoder, _decoder_keys(cfg, key, shard), feats_k, ctx=ctx,
        frame_mask=frame_mask, shard=shard, seq=seq)
    if _track_group(shard) is not None:
        return comm.all_reduce_sum(lls.detach().sum(dim=0), shard.track)
    return lls.sum(dim=0)


def conditional_logits(params: MultINNParams, x: torch.Tensor, shard=None,
                       seq=None):
    """Teacher-forced conditional logits and their targets for NADE
    decoders, both (K, T, B, F) ((1, T, B, K*D) in joint mode; this rank's
    tracks under a track split): the Gauss-Newton linearization point of
    training/hf.py, in the parallel cumsum form."""
    cfg = params.cfg
    if cfg.decoder_type != "rnn-nade":
        raise ValueError("conditional_logits requires an rnn-nade decoder "
                         "(RBM CD training has no GGN linearization)")
    feats_k, ctx = _track_inputs(params, x, shard, seq)
    logits = get_decoder(cfg.decoder_type).conditional_logits(
        params.decoder, feats_k, ctx=ctx, shard=shard, seq=seq)
    return logits.movedim(1, 0), feats_k.transpose(1, 2)


def init_state(params: MultINNParams, batch: int) -> MultINNState:
    """A fresh state for ``batch`` rows of the params' decoders (under a
    track split, this rank's)."""
    cfg = params.cfg
    dec = get_decoder(cfg.decoder_type)
    states = dec.init_state(params.decoder,
                            (params.decoder.w.shape[0], batch))
    ctx = (torch.zeros((batch, cfg.ctx_dim()), device=params.decoder.w.device)
           if cfg.mode == "feedback" else None)
    return MultINNState(decoder=states, ctx=ctx)


def prime(params: MultINNParams, state: MultINNState,
          seed: torch.Tensor, shard=None) -> MultINNState:
    """Advance RNN states over a seed pianoroll (B, T, K, D) (under a
    track split, this rank's tracks of it)."""
    cfg = params.cfg
    dec = get_decoder(cfg.decoder_type)
    feats_k = _encode_tracks(params, seed)               # (K, B, T, F)
    if cfg.mode == "feedback":
        # ctx(t) = latents(t-1); the incoming carried context conditions the
        # first seed frame (zeros for a fresh state)
        every = _all_tracks(feats_k, shard)
        ctx_seq = _feedback_ctx(every, prefix=state.ctx)
        ctx_k = ctx_seq.expand(feats_k.shape[0], *ctx_seq.shape)
        states = dec.prime(params.decoder, state.decoder, feats_k, ctx=ctx_k)
        return MultINNState(decoder=states,
                            ctx=_flatten_latents(every[:, :, -1]))
    return MultINNState(decoder=dec.prime(params.decoder, state.decoder,
                                          feats_k), ctx=None)


def tempered_params(params: MultINNParams,
                    temperature: float) -> MultINNParams:
    """Sampling temperature on the decoder params (exact; T=1 returns
    ``params`` unchanged)."""
    if temperature == 1.0:
        return params
    dec = get_decoder(params.cfg.decoder_type)
    return dataclasses.replace(
        params, decoder=dec.tempered_params(params.decoder, temperature))


def sample_step(params: MultINNParams, key: torch.Tensor,
                state: MultINNState, k: Optional[int] = None,
                temperature: float = 1.0
                ) -> Tuple[MultINNState, torch.Tensor]:
    """One generation step over all tracks -> (state, frame (B, K, D)
    binary pianoroll). ``temperature`` tempers the decoder params and the
    DBN decode conditional's logits; in a loop of your own, temper once
    with ``tempered_params`` and call ``_sample_step`` with the decode beta
    (``generate`` does)."""
    return _sample_step(tempered_params(params, temperature), key, state,
                        k, 1.0 / temperature)


def _sample_step(params: MultINNParams, key: torch.Tensor,
                 state: MultINNState, k: Optional[int] = None,
                 dec_beta: float = 1.0, shard=None, decode: bool = True
                 ) -> Tuple[MultINNState, torch.Tensor]:
    """One generation step over all tracks on already-tempered params ->
    (state, frame (B, K, D)). Keys as the JAX package: ``key, kd =
    split(key)``, one key per decoder from ``key`` (_decoder_keys), and
    ``kd`` for the DBN decode; ``dec_beta`` tempers only that decode.
    ``shard``: this rank samples its tracks (the frames then gathered over
    ``track``) on its rows' streams; ``decode=False`` leaves a DBN's frame
    in latent space, decoder-major (B, K', F)."""
    cfg = params.cfg
    dec = get_decoder(cfg.decoder_type)
    key, kd = sampling.split(key)
    keys = _decoder_keys(cfg, key, shard)
    rows = None if shard is None else shard.rows
    vs = torch.stack([
        dec.sample_frame(index_tree(params.decoder, i), keys[i],
                         index_tree(state.decoder, i), k=k, rows=rows)
        for i in range(params.decoder.w.shape[0])])      # (K, B, F)
    vs = _all_tracks(vs, shard)
    new_state = _forced_step(params, state, vs, shard)
    if cfg.encoder_hidden:
        if not decode:
            return new_state, vs.movedim(0, 1)
        vs = _decode_tracks(params, kd, vs, dec_beta, shard)
    return new_state, _frames(cfg, vs.movedim(0, 1))     # (B, K, D)


def _frames(cfg: MultINNConfig, x: torch.Tensor) -> torch.Tensor:
    """Decoder-major frames (..., K', D') -> pianoroll (..., K, D): joint
    mode's one K*D-wide row split into the tracks."""
    if cfg.mode != "joint":
        return x
    return x.reshape(*x.shape[:-2], cfg.n_tracks, cfg.n_pitches)


def _forced_step(params: MultINNParams, state: MultINNState,
                 vs: torch.Tensor, shard=None) -> MultINNState:
    """Advance every track's decoder on the frame features vs (K, B, F);
    in feedback mode the carried context conditions the advance and vs
    becomes the next context. Under a track split vs holds every track and
    this rank advances its own."""
    cfg = params.cfg
    dec = get_decoder(cfg.decoder_type)
    mine = (vs if _track_group(shard) is None
            else vs[shard.tracks(cfg.n_tracks)])
    if cfg.mode != "feedback":
        return MultINNState(
            decoder=dec.forced_step(params.decoder, state.decoder, mine),
            ctx=None)
    ctx_k = state.ctx.expand(mine.shape[0], *state.ctx.shape)
    return MultINNState(
        decoder=dec.forced_step(params.decoder, state.decoder, mine, ctx_k),
        ctx=_flatten_latents(vs))


def generate(params: MultINNParams, key: torch.Tensor, state: MultINNState,
             n_steps: int, fused: Optional[bool] = None,
             k: Optional[int] = None, temperature: float = 1.0, shard=None,
             latent: bool = False):
    """Autoregressive multi-track generation. Returns (state, pianoroll
    (B, n_steps, K, D) float32); with ``latent`` also, third, the
    decoders' model-space roll (B, n_steps, K', F) that a DBN's decode
    drew the pianoroll from (the roll itself without a DBN; joint mode
    one decoder, K' = 1). The pianoroll is the same bits either way: the
    scan path then decodes after the loop, as under a data split.

    ``fused``: True runs the whole-generation kernel (ops/gen_fused.py; a
    DBN's latent roll is decoded after it), False the step loop (scan
    path: a Gibbs-chain or NADE-sweep launch per track and step); None
    picks the kernel whenever its gate admits the config and batch. On CPU
    tensors each kernel runs as its plain version. ``temperature`` tempers
    the decoder params and the DBN decode conditional's logits.

    ``shard`` (a mesh's part): the state holds this rank's rows (the row
    map) and tracks, and so does the roll, every track gathered; a track
    split runs the scan path, the frames gathered every step."""
    cfg = params.cfg
    batch = state.decoder.v_prev.shape[1]     # (K', B, F) in every mode
    if _track_group(shard) is not None:
        if fused:
            raise ValueError("the whole-generation kernels hold every "
                             "track: a track-split mesh runs the scan path")
        fused = False
    if fused is None:
        from multinn_torch.ops import gen_fused
        fused = (gen_fused.supported(cfg, batch, n_steps, gen_k=k)
                 or gen_fused.supported_nade(cfg, batch, n_steps))
    params = tempered_params(params, temperature)
    dec_beta = 1.0 / temperature
    if fused:
        return _generate_fused(params, key, state, n_steps, k=k,
                               dec_beta=dec_beta, shard=shard, latent=latent)
    # a DBN decode over a data split waits for the whole batch's latents
    later = bool(cfg.encoder_hidden) and (_data_group(shard) is not None
                                          or latent)
    keys = sampling.split(key, n_steps)
    frames = []
    for t in range(n_steps):
        state, frame = _sample_step(params, keys[t], state, k=k,
                                    dec_beta=dec_beta, shard=shard,
                                    decode=not later)
        frames.append(frame)
    roll = lat = torch.stack(frames, dim=1)
    if later:
        roll = _decode_steps_later(params, keys, roll, dec_beta, shard)
    return (state, roll, lat) if latent else (state, roll)


def _data_group(shard):
    return None if shard is None else shard.data


def _decode_whole_batch(decode, lat: torch.Tensor, shard) -> torch.Tensor:
    """``decode`` (latent roll (B, T, K, F) -> pianoroll (B, T, K, D)) on
    the whole batch: this rank's rows gathered over ``data``, decoded
    (every rank alike), and its rows kept."""
    group = _data_group(shard)
    if group is None:
        return decode(lat)
    b = lat.shape[0]
    whole = decode(comm.gather_cat(lat.contiguous(), 0, group))
    return whole[shard.rows[0]:shard.rows[0] + b]


def _decode_steps_later(params: MultINNParams, keys: torch.Tensor,
                        lat: torch.Tensor, dec_beta: float,
                        shard) -> torch.Tensor:
    """The scan path's latent roll (B, T, K', F), each step t decoded
    under the decode key of ``keys[t]`` (as ``_sample_step`` draws it)
    over the whole batch: a deferred decode (a data split's, or one whose
    latents are kept) -> pianoroll (B, T, K, D)."""
    kds = [sampling.split(kt)[1] for kt in keys]

    def decode(whole):
        return torch.stack([_decode_tracks(
            params, kds[t], whole[:, t].movedim(1, 0), dec_beta,
            shard).movedim(0, 1) for t in range(whole.shape[1])], dim=1)
    return _frames(params.cfg, _decode_whole_batch(decode, lat, shard))


def _check_given(cfg: MultINNConfig, given: torch.Tensor,
                 given_tracks) -> Tuple[int, ...]:
    """The accompaniment request's checks (the JAX package's); returns the
    sorted given tracks."""
    if cfg.mode == "joint":
        raise ValueError(
            "accompaniment needs per-track decoders; joint mode has one "
            "decoder over all tracks (within-frame conditional sampling "
            "is not supported)")
    given_tracks = tuple(sorted(set(int(i) for i in given_tracks)))
    if not given_tracks:
        raise ValueError("given_tracks is empty — use generate()")
    if any(not 0 <= i < cfg.n_tracks for i in given_tracks):
        raise ValueError(f"given_tracks {given_tracks} out of range for "
                         f"n_tracks={cfg.n_tracks}")
    if len(given_tracks) == cfg.n_tracks:
        raise ValueError("all tracks given — nothing to sample")
    _, _, kk, d = given.shape
    if kk != cfg.n_tracks or d != cfg.n_pitches:
        raise ValueError(f"given roll (B, T, K, D)={tuple(given.shape)} does "
                         f"not match model (K={cfg.n_tracks}, "
                         f"D={cfg.n_pitches})")
    return given_tracks


def generate_accompaniment(params: MultINNParams, key: torch.Tensor,
                           state: MultINNState, given: torch.Tensor,
                           given_tracks: Tuple[int, ...],
                           k: Optional[int] = None,
                           temperature: float = 1.0,
                           fused: Optional[bool] = None,
                           subset: bool = True, shard=None
                           ) -> Tuple[MultINNState, torch.Tensor]:
    """Track-conditional generation: the tracks in ``given_tracks`` take the
    frames of ``given`` (B, T, K, D) and the others are sampled. Returns
    (state, roll (B, T, K, D)) with roll[:, :, given_tracks] equal to
    given's slices bit for bit (never re-encoded).

    In ``feedback`` mode the given tracks' features enter every track's
    cross-track context each step, so the sampled tracks condition on
    them; in ``per-track`` / ``hybrid`` mode the decoders are independent
    and the given tracks are only merged into the output. ``joint`` mode
    raises.

    Per step every sampled track runs the decoder's ``sample_frame``, the
    given tracks take their teacher-forced features, and all tracks advance
    by ``forced_step``. ``temperature`` tempers the sampled tracks only.
    ``fused`` (None = the kernel when its gate admits the batch): run the
    loop in the whole-generation kernel, the given features streamed into
    it. ``subset`` (scan path): True samples only the sampled tracks,
    False samples all K and keeps the given tracks by a select (the JAX
    package's track-sharded form); the two are bit-equal, since track i
    draws under key i either way.

    ``shard`` (a mesh's part): ``given`` and the state hold this rank's
    rows (the row map) and the roll is this rank's rows, every track. A
    track split runs the scan path in the all-K form: each rank samples
    its tracks, given ones included, under their keys of the whole K,
    selects the given features of its tracks (its own encoders) and
    gathers the frames over ``track`` every step; a DBN's decode over a
    data split waits for the whole batch."""
    cfg = params.cfg
    given_tracks = _check_given(cfg, given, given_tracks)
    b, n_steps = given.shape[:2]
    if _track_group(shard) is not None:
        if fused:
            raise ValueError("the whole-generation kernels hold every "
                             "track: a track-split mesh runs the scan path")
        fused, subset = False, False
    if fused is None:
        from multinn_torch.ops import gen_fused
        fused = (gen_fused.supported(cfg, b, n_steps, gen_k=k,
                                     conditioned=True)
                 or gen_fused.supported_nade(cfg, b, n_steps,
                                             n_given=len(given_tracks)))
    dec = get_decoder(cfg.decoder_type)
    params = tempered_params(params, temperature)
    dec_beta = 1.0 / temperature
    given = given.to(torch.float32)
    if fused:
        return _generate_accomp_fused(params, key, state, given,
                                      given_tracks, k=k, dec_beta=dec_beta,
                                      shard=shard)
    own = (slice(None) if _track_group(shard) is None
           else shard.tracks(cfg.n_tracks))
    mine = range(cfg.n_tracks)[own]                # this rank's tracks
    feats_g = _encode_tracks(params, given[:, :, own])   # (K', B, T, F)
    mask = torch.zeros(cfg.n_tracks, 1, 1, dtype=torch.bool,
                       device=given.device)
    mask[list(given_tracks)] = True
    sampled = [j for j, i in enumerate(mine)
               if not subset or i not in given_tracks]
    rows = None if shard is None else shard.rows
    # a DBN decode over a data split waits for the whole batch's latents
    later = bool(cfg.encoder_hidden) and _data_group(shard) is not None
    keys = sampling.split(key, n_steps)
    rolls = []
    for t in range(n_steps):
        key1, kd = sampling.split(keys[t])
        tkeys = _decoder_keys(cfg, key1, shard)
        vs = list(feats_g[:, :, t])
        for j in sampled:
            vs[j] = dec.sample_frame(index_tree(params.decoder, j), tkeys[j],
                                     index_tree(state.decoder, j), k=k,
                                     rows=rows)
        # select, don't blend: a non-finite sample must not reach a given
        # track
        v_final = _all_tracks(torch.where(mask[own],
                                          feats_g[:, :, t], torch.stack(vs)),
                              shard)
        state = _forced_step(params, state, v_final, shard)
        if cfg.encoder_hidden and not later:
            v_final = torch.where(mask, given[:, t].movedim(1, 0),
                                  _decode_tracks(params, kd, v_final,
                                                 dec_beta, shard))
        rolls.append(v_final)
    roll = torch.stack(rolls).permute(2, 0, 1, 3)          # (B, T, K, ·)
    if later:
        roll = _decode_steps_later(params, keys, roll, dec_beta, shard)
        roll[:, :, list(given_tracks)] = given[:, :, list(given_tracks)]
    return state, roll


def _generate_fused(params: MultINNParams, key: torch.Tensor,
                    state: MultINNState, n_steps: int, impl=None,
                    k: Optional[int] = None, dec_beta: float = 1.0,
                    given: Optional[torch.Tensor] = None,
                    given_tracks: Tuple[int, ...] = (), shard=None,
                    latent: bool = False):
    """Dispatch to the whole-generation kernel and rebuild the state
    contract from its outputs (``params`` already tempered). The kernel
    runs in feature space; with a DBN its latent roll is decoded to
    pianoroll after it, under ``fold_in(key, 0x5eed)`` (per-track encoders:
    ``split`` of that key over the tracks), ``dec_beta`` tempering that
    decode. ``given`` (B, T, K, F) features with ``given_tracks``: those
    tracks' frames in the kernel (accompaniment). Joint mode enters the
    kernels as one track of the joint width; its roll is split into the K
    tracks after the decode. ``shard``: the batch is this rank's rows of a
    data split (the kernels' row map; the decode over the whole batch).
    ``latent``: the kernel's roll is returned too, third (``generate``)."""
    from multinn_torch.ops import gen_fused
    cfg = params.cfg
    vanilla = cfg.cell == "vanilla"
    dec_state = state.decoder
    h0 = torch.stack([st.h for st in dec_state.cell])
    c0 = (torch.zeros_like(h0) if vanilla
          else torch.stack([st.c for st in dec_state.cell]))
    rows = None if shard is None else shard.rows
    if cfg.decoder_type == "rnn-nade":
        roll, h_f, c_f = gen_fused.generate_nade(
            key, params.decoder, h0, c0, dec_state.v_prev, n_steps,
            impl=impl, given=given, given_tracks=given_tracks,
            rows=rows)                                   # (B, T, K, F)
    else:
        roll, h_f, c_f = gen_fused.generate_rbm(
            key, params.decoder, h0, c0, dec_state.v_prev, n_steps,
            cfg.gen_k if k is None else k, impl=impl, given=given,
            given_tracks=given_tracks, rows=rows)
    v_last = roll[:, -1].movedim(0, 1)                   # (K, B, F)

    def cell_state(h, c):
        return (rnn_nn.VanillaRNNState(h=h) if vanilla
                else rnn_nn.LSTMState(h=h, c=c))

    new_dec = get_decoder(cfg.decoder_type).State(
        cell=tuple(cell_state(h_f[l], c_f[l]) for l in range(len(h_f))),
        v_prev=v_last)
    ctx = _flatten_latents(v_last) if cfg.mode == "feedback" else None
    lat = roll
    if cfg.encoder_hidden:
        kd = sampling.fold_in(key, 0x5eed)
        roll = _decode_whole_batch(
            lambda lat: _decode_tracks(params, kd, lat.movedim(2, 0),
                                       dec_beta).movedim(0, 2), roll, shard)
    out = MultINNState(decoder=new_dec, ctx=ctx), _frames(cfg, roll)
    return out + (lat,) if latent else out


def _generate_accomp_fused(params: MultINNParams, key: torch.Tensor,
                           state: MultINNState, given: torch.Tensor,
                           given_tracks: Tuple[int, ...],
                           k: Optional[int] = None, dec_beta: float = 1.0,
                           impl=None, shard=None
                           ) -> Tuple[MultINNState, torch.Tensor]:
    """generate_accompaniment on the whole-generation kernels: the given
    tracks' teacher-forced features stream into the kernel and replace
    those tracks' frames each step (``params`` already tempered). With a
    DBN the decoded roll's given rows then take ``given`` verbatim.
    ``shard``: ``given`` holds this rank's rows of a data split (the
    kernels' row map; a DBN's decode over the whole batch)."""
    feats = _encode_tracks(params, given).permute(1, 2, 0, 3)  # (B, T, K, F)
    state, roll = _generate_fused(params, key, state, given.shape[1],
                                  impl=impl, k=k, dec_beta=dec_beta,
                                  given=feats, given_tracks=given_tracks,
                                  shard=shard)
    if params.cfg.encoder_hidden:
        gt = list(given_tracks)
        roll[:, :, gt] = given[:, :, gt]
    return state, roll
