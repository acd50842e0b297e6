"""MultINN — the multi-track model — port of multinn_tpu/models/multinn.py.

Inter-track modes ``per-track``, ``feedback`` and ``hybrid`` (with the
pass-through encoder, hybrid differs from per-track only in config).
Both decoder families, RNN-RBM and RNN-NADE. Per-track decoder params are
STACKED along a leading track axis K, as in the JAX package; where it vmaps
over tracks the port batches the same computation over that axis
(nn/rnn.py), and loops over tracks only where a kernel takes one decoder
(the scan path's Gibbs chain or NADE sweep, the CD chain). Pianorolls
are (B, T, K, D). ``joint`` mode and accompaniment wait for later slices
(ROADMAP queue 1).
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


def stack_trees(trees):
    """Per-track trees -> one tree with a leading track axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def index_tree(tree, i: int):
    """Track ``i`` of a track-stacked tree."""
    return tree_map(lambda x: x[i], tree)


def _check_mode(cfg: MultINNConfig):
    if cfg.mode == "joint":
        raise NotImplementedError("joint mode is not ported yet (ROADMAP "
                                  "queue 1)")


def init(cfg: MultINNConfig, generator: Optional[torch.Generator] = None,
         device=None) -> MultINNParams:
    """Random params with the JAX package's shapes and init distributions
    (normal(0, w_std) weights, zero biases, LSTM forget-gate bias 1),
    drawn on the CPU from ``generator`` (so a seed gives the same values on
    every device) and placed on ``device``: the CUDA card when None, which
    raises without one."""
    _check_mode(cfg)
    device = entry_device(device)
    dec = get_decoder(cfg.decoder_type)
    dcfg = cfg.decoder_config()
    decoder = stack_trees([dec.init(dcfg, generator=generator, device="cpu")
                           for _ in range(cfg.n_tracks)])
    decoder = tree_map(lambda x: x.to(device), decoder)
    return MultINNParams(encoder=enc_mod.init(cfg.encoder_config()),
                         decoder=decoder, cfg=cfg)


def _encode_tracks(params: MultINNParams, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, K, D) -> decoder-facing features, tracks-first (K, B, T, F)."""
    return enc_mod.features(params.encoder, x.movedim(2, 0))


def _flatten_latents(vs: torch.Tensor) -> torch.Tensor:
    """Track-major latents (K, B, F) -> feedback-context rows (B, K*F)."""
    k, b, f = vs.shape
    return vs.movedim(0, 1).reshape(b, k * f)


def _feedback_ctx(feats_k: torch.Tensor,
                  prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced feedback context: latents of all tracks at t-1.
    feats_k (K, B, T, F) -> (B, T, K*F); row t=0 is ``prefix`` or zeros."""
    k, b, t, f = feats_k.shape
    lat = feats_k.permute(1, 2, 0, 3).reshape(b, t, k * f)
    first = (torch.zeros_like(lat[:, :1]) if prefix is None
             else prefix[:, None].to(lat.dtype))
    return torch.cat([first, lat[:, :-1]], dim=1)


def _mean_tree(metrics: dict) -> dict:
    """Per-track metrics (K,) -> their mean over tracks."""
    return {k: v.mean(dim=0) for k, v in metrics.items()}


def _track_inputs(params: MultINNParams, x: torch.Tensor):
    """(B, T, K, D) -> the decoders' features (K, B, T, F) and, in feedback
    mode, each track's teacher-forced context (K, B, T, K*F)."""
    cfg = params.cfg
    feats_k = _encode_tracks(params, x)
    if cfg.mode != "feedback":
        return feats_k, None
    ctx = _feedback_ctx(feats_k)
    return feats_k, ctx.expand(cfg.n_tracks, *ctx.shape)


def loss(params: MultINNParams, key: torch.Tensor, x: torch.Tensor,
         detailed: bool = True, frame_mask: Optional[torch.Tensor] = None,
         impl=None):
    """Teacher-forced loss over all tracks, x (B, T, K, D); frame_mask
    (B, T). Returns (loss, metrics): the metrics averaged over tracks, the
    per-track losses under ``loss_per_track``. Track i's key is
    ``split(key, K)[i]``. ``detailed=False`` is the trainer's hot path;
    ``impl`` forces the decoder's kernels or their plain versions."""
    cfg = params.cfg
    _check_mode(cfg)
    feats_k, ctx = _track_inputs(params, x)
    keys = sampling.split(key, cfg.n_tracks)
    losses, metrics = get_decoder(cfg.decoder_type).loss(
        params.decoder, keys, feats_k, ctx=ctx, detailed=detailed,
        frame_mask=frame_mask, impl=impl)
    metrics = _mean_tree(metrics)
    metrics["loss_per_track"] = losses.detach()
    total = losses.mean()
    metrics["loss"] = total.detach()
    return total, metrics


def log_likelihood(params: MultINNParams, key: torch.Tensor,
                   x: torch.Tensor,
                   frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sequence LL summed over tracks and time, (B,): exact for NADE
    decoders, the pseudo-LL proxy for RBM decoders."""
    cfg = params.cfg
    _check_mode(cfg)
    feats_k, ctx = _track_inputs(params, x)
    lls = get_decoder(cfg.decoder_type).log_likelihood_proxy(
        params.decoder, sampling.split(key, cfg.n_tracks), feats_k, ctx=ctx,
        frame_mask=frame_mask)
    return lls.sum(dim=0)


def conditional_logits(params: MultINNParams, x: torch.Tensor):
    """Teacher-forced conditional logits and their targets for NADE
    decoders, both (K, T, B, F)."""
    cfg = params.cfg
    if cfg.decoder_type != "rnn-nade":
        raise ValueError("conditional_logits requires an rnn-nade decoder "
                         "(RBM CD training has no GGN linearization)")
    _check_mode(cfg)
    feats_k, ctx = _track_inputs(params, x)
    logits = get_decoder(cfg.decoder_type).conditional_logits(
        params.decoder, feats_k, ctx=ctx)
    return logits.movedim(1, 0), feats_k.transpose(1, 2)


def init_state(params: MultINNParams, batch: int) -> MultINNState:
    cfg = params.cfg
    _check_mode(cfg)
    dec = get_decoder(cfg.decoder_type)
    states = dec.init_state(params.decoder, (cfg.n_tracks, batch))
    ctx = (torch.zeros((batch, cfg.ctx_dim()), device=params.decoder.w.device)
           if cfg.mode == "feedback" else None)
    return MultINNState(decoder=states, ctx=ctx)


def prime(params: MultINNParams, state: MultINNState,
          seed: torch.Tensor) -> MultINNState:
    """Advance RNN states over a seed pianoroll (B, T, K, D)."""
    cfg = params.cfg
    _check_mode(cfg)
    dec = get_decoder(cfg.decoder_type)
    feats_k = _encode_tracks(params, seed)               # (K, B, T, F)
    if cfg.mode == "feedback":
        # ctx(t) = latents(t-1); the incoming carried context conditions the
        # first seed frame (zeros for a fresh state)
        ctx_seq = _feedback_ctx(feats_k, prefix=state.ctx)
        ctx_k = ctx_seq.expand(cfg.n_tracks, *ctx_seq.shape)
        states = dec.prime(params.decoder, state.decoder, feats_k, ctx=ctx_k)
        return MultINNState(decoder=states,
                            ctx=_flatten_latents(feats_k[:, :, -1]))
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


def _sample_step(params: MultINNParams, key: torch.Tensor,
                 state: MultINNState, k: Optional[int] = None
                 ) -> Tuple[MultINNState, torch.Tensor]:
    """One generation step over all tracks on already-tempered params ->
    (state, frame (B, K, D)). Keys as the JAX package: ``key, kd =
    split(key)``, then one key per track."""
    cfg = params.cfg
    dec = get_decoder(cfg.decoder_type)
    key, _ = sampling.split(key)
    keys = sampling.split(key, cfg.n_tracks)
    vs = torch.stack([
        dec.sample_frame(index_tree(params.decoder, i), keys[i],
                         index_tree(state.decoder, i), k=k)
        for i in range(cfg.n_tracks)])                   # (K, B, F)
    if cfg.mode == "feedback":
        ctx_k = state.ctx.expand(cfg.n_tracks, *state.ctx.shape)
        states = dec.forced_step(params.decoder, state.decoder, vs, ctx_k)
        new_state = MultINNState(decoder=states, ctx=_flatten_latents(vs))
    else:
        new_state = MultINNState(
            decoder=dec.forced_step(params.decoder, state.decoder, vs),
            ctx=None)
    return new_state, vs.movedim(0, 1)                   # (B, K, D)


def generate(params: MultINNParams, key: torch.Tensor, state: MultINNState,
             n_steps: int, fused: Optional[bool] = None,
             k: Optional[int] = None, temperature: float = 1.0
             ) -> Tuple[MultINNState, torch.Tensor]:
    """Autoregressive multi-track generation. Returns (state, pianoroll
    (B, n_steps, K, D) float32).

    ``fused``: True runs the whole-generation kernel (ops/gen_fused.py),
    False the step loop (scan path: a Gibbs-chain or NADE-sweep launch per
    track and step); None picks the kernel whenever its gate admits the
    config and batch. On CPU tensors each kernel runs as its plain
    version."""
    cfg = params.cfg
    batch = state.decoder.v_prev.shape[1]
    if fused is None:
        from multinn_torch.ops import gen_fused
        fused = (gen_fused.supported(cfg, batch, n_steps, gen_k=k)
                 or gen_fused.supported_nade(cfg, batch, n_steps))
    params = tempered_params(params, temperature)
    if fused:
        return _generate_fused(params, key, state, n_steps, k=k)
    keys = sampling.split(key, n_steps)
    frames = []
    for t in range(n_steps):
        state, frame = _sample_step(params, keys[t], state, k=k)
        frames.append(frame)
    return state, torch.stack(frames, dim=1)


def _generate_fused(params: MultINNParams, key: torch.Tensor,
                    state: MultINNState, n_steps: int, impl=None,
                    k: Optional[int] = None
                    ) -> Tuple[MultINNState, torch.Tensor]:
    """Dispatch to the whole-generation kernel and rebuild the state
    contract from its outputs (``params`` already tempered)."""
    from multinn_torch.ops import gen_fused
    cfg = params.cfg
    vanilla = cfg.cell == "vanilla"
    dec_state = state.decoder
    h0 = torch.stack([st.h for st in dec_state.cell])
    c0 = (torch.zeros_like(h0) if vanilla
          else torch.stack([st.c for st in dec_state.cell]))
    if cfg.decoder_type == "rnn-nade":
        roll, h_f, c_f = gen_fused.generate_nade(
            key, params.decoder, h0, c0, dec_state.v_prev, n_steps,
            impl=impl)                                   # (B, T, K, D)
    else:
        roll, h_f, c_f = gen_fused.generate_rbm(
            key, params.decoder, h0, c0, dec_state.v_prev, n_steps,
            cfg.gen_k if k is None else k, impl=impl)
    v_last = roll[:, -1].movedim(0, 1)                   # (K, B, D)

    def cell_state(h, c):
        return (rnn_nn.VanillaRNNState(h=h) if vanilla
                else rnn_nn.LSTMState(h=h, c=c))

    new_dec = get_decoder(cfg.decoder_type).State(
        cell=tuple(cell_state(h_f[l], c_f[l]) for l in range(len(h_f))),
        v_prev=v_last)
    ctx = _flatten_latents(v_last) if cfg.mode == "feedback" else None
    return MultINNState(decoder=new_dec, ctx=ctx), roll
