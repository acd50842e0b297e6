"""Generation engine — port of multinn_tpu/training/generator.py (the
generate / generate_async / accompany / accompany_async / fetch_rolls /
finalize surface and the file output: to_midi / write_files /
generate_to_files).

One generation primes the model state on an optional seed roll, runs
``multinn.generate`` (or ``multinn.generate_accompaniment``, which fixes
some tracks to a given roll and samples the rest; the whole-generation
kernel whenever its gate admits the batch) and bit-packs the roll on the
device; the host unpacks it. With ``packed="sparse"`` the device also
compacts the packed roll's nonzero bytes into records (ops/sparsebytes):
the host then reads the count and as many record chunks as it needs, and
reads the packed roll instead when the records overflowed their buffer.

With a ``mesh`` (parallel/mesh.py; every rank of it runs the same calls)
generation shards its batch over ``data``: each rank generates its rows
on the whole-generation kernel where the gate admits it, else on the scan
path, both drawing each row's stream in the whole batch (the kernels' row
map), and the rolls are gathered, so the result is the single-device
result on the same path bit for bit, seeded or not; a batch that does not
divide the data axis runs whole on every rank. With a ``track`` axis the
decoders are split over it and generation runs the scan path, each rank
sampling its tracks under ``split(key1, K)[k]`` and the frames gathered
every step for the feedback context: the single-device scan path bit for
bit. Params split over ``model`` (a gspmd trainer's) are gathered once,
at construction. Accompaniment shards alike: the given roll's (and the
seed's) rows over ``data``, on the whole-generation kernel with the row
map where the gate admits it, and on a track split the scan path, each
rank sampling its tracks (the given ones too, then selected) and the
frames gathered every step; the single-device accompaniment on the same
path bit for bit.

``generate_async`` and ``accompany_async`` enqueue everything on the
caller's current CUDA stream without a host synchronisation (the key is
derived on the card, the seed and given rolls copy from pinned memory
without blocking) and return the packed device tensor with a CUDA event
recorded after it; ``fetch_rolls`` waits on that event only, so a serving
loop can dispatch the next batch while this one runs.

``latent_rows`` asks ``generate_async`` for those rows' model-space
(latent) roll beside the pianoroll: gathered and bit-packed on the
device at the feature width, copied with the roll, and handed back by
``fetch_with_latents``. Asked for nothing, nothing more is done.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multinn_torch.data import pianoroll
from multinn_torch.models import multinn
from multinn_torch.ops import bitpack, sparsebytes
from multinn_torch.parallel import comm
from multinn_torch.parallel import mesh as mesh_mod
from multinn_torch.utils import profiling


class AsyncRolls(NamedTuple):
    """A dispatched generation: the bit-packed roll (B, T, K, ceil(D/8))
    uint8 on the device, the event recorded after its last kernel (None on
    the CPU) and, for the sparse transport, the (cap, 5) uint8 records and
    their int32 count (ops/sparsebytes); where rows were asked for, their
    bit-packed model-space roll (R, T, K', ceil(F/8)) uint8."""
    packed: torch.Tensor
    event: Optional[torch.cuda.Event]
    sparse: Optional[torch.Tensor] = None
    count: Optional[torch.Tensor] = None
    latent: Optional[torch.Tensor] = None


class Generator:
    """Public generator API over a model's params (random from
    ``multinn.init`` or converted with ``utils.convert.from_jax``). It runs
    on the device the params live on. ``mesh``: generate on a process mesh
    (module docstring); ``params`` are then whole, or a gspmd trainer's
    parts (``Trainer.params``), gathered here."""

    def __init__(self, cfg, params: multinn.MultINNParams, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.track_sharded = (mesh is not None
                              and mesh.size(mesh_mod.TRACK_AXIS) > 1)
        if mesh is not None:
            w = params.decoder.w
            split_k = w.shape[0] < multinn.n_decoders(cfg.model)
            split_h = w.shape[-1] < cfg.model.n_hidden
            if split_k or split_h:
                params = mesh_mod.gather_params(params, mesh, split_k,
                                                split_h)
        self.params = mesh_mod.shard_params(params, mesh, self.track_sharded,
                                            model_sharded=False)
        self.device = params.decoder.w.device
        # generate.gibbs_k overrides the model's gen_k (0 = model default)
        self._gibbs_k = getattr(cfg.generate, "gibbs_k", 0) or None
        self._temperature = float(getattr(cfg.generate, "temperature", 1.0))
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # set by sparse fetches: the record count (the next fetch's
        # size_hint) and whether the records overflowed their buffer
        self.last_sparse_count: Optional[int] = None
        self.last_sparse_overflowed = False

    def _to_device(self, seed: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(seed, np.float32))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def generate_async(self, key: torch.Tensor, n_steps: int,
                       batch: int = 1, seed: Optional[np.ndarray] = None,
                       packed=True, latent_rows: Tuple[int, ...] = ()
                       ) -> AsyncRolls:
        """Dispatch one generation without blocking. ``key``: a Threefry key
        (ops/sampling.py); ``seed``: optional (batch, T_seed, K, D)
        model-space priming roll; ``packed``: the transport, True (the
        bit-packed roll) or ``"sparse"`` (its nonzero bytes as records, the
        packed roll kept beside them); ``latent_rows``: rows whose
        model-space roll comes back too (not on a mesh). Returns
        AsyncRolls; decode with fetch_rolls or fetch_with_latents."""
        _check_transport(packed)
        if seed is not None and np.shape(seed)[0] != batch:
            raise ValueError(f"seed batch {np.shape(seed)[0]} != {batch}")
        if self.mesh is not None:
            if latent_rows:
                raise ValueError("latent rows are not gathered on a mesh")
            return self._generate_mesh(key, n_steps, batch, seed, packed)
        with torch.inference_mode():
            state = multinn.init_state(self.params, batch)
            if seed is not None:
                state = multinn.prime(self.params, state,
                                      self._to_device(seed))
            out = multinn.generate(self.params, key.to(self.device), state,
                                   n_steps, k=self._gibbs_k,
                                   temperature=self._temperature,
                                   latent=bool(latent_rows))
            # rows by Python index: an index tensor would be a host copy
            lat = (torch.stack([out[2][r] for r in latent_rows])
                   if latent_rows else None)
            return self._transport(out[1], packed, lat)

    def _mesh_shard(self, batch: int):
        """This rank's Shard of a call over ``batch`` rows (split over
        ``data`` where it divides the axis, else whole on every rank) and
        whether it is split; (None, False) without a mesh."""
        if self.mesh is None:
            return None, False
        n_data = self.mesh.size(mesh_mod.DATA_AXIS)
        split = n_data > 1 and batch % n_data == 0
        return mesh_mod.shard_of(self.mesh, batch if split else None,
                                 self.track_sharded,
                                 model_sharded=False), split

    def _mesh_rows(self, roll: np.ndarray, batch: int, split: bool,
                   shard, tracks: bool) -> torch.Tensor:
        """This rank's rows (and, where ``tracks`` on a track split, its
        tracks) of a host roll (B, T, K, D), on the device (the whole roll
        without a mesh)."""
        mine = np.asarray(roll)[mesh_mod.batch_slice(batch, self.mesh)
                                if split else slice(None)]
        if tracks and self.track_sharded:
            mine = mine[:, :, shard.tracks(self.cfg.model.n_tracks)]
        return self._to_device(mine)

    def _generate_mesh(self, key, n_steps, batch, seed, packed
                       ) -> AsyncRolls:
        """generate_async on the mesh: this rank's rows (and tracks), the
        rolls gathered over ``data`` (every rank holds the whole roll)."""
        shard, split = self._mesh_shard(batch)
        with torch.inference_mode():
            state = multinn.init_state(
                self.params, batch // self.mesh.size(mesh_mod.DATA_AXIS)
                if split else batch)
            if seed is not None:
                state = multinn.prime(self.params, state, self._mesh_rows(
                    seed, batch, split, shard, tracks=True), shard)
            _, roll = multinn.generate(self.params, key.to(self.device),
                                       state, n_steps, k=self._gibbs_k,
                                       temperature=self._temperature,
                                       shard=shard)
            if split:
                roll = comm.gather_cat(roll.contiguous(), 0, shard.data)
            return self._transport(roll, packed)

    def accompany_async(self, key: torch.Tensor, given: np.ndarray,
                        given_tracks, seed: Optional[np.ndarray] = None,
                        packed=True) -> AsyncRolls:
        """Dispatch one track-conditional generation without blocking: the
        tracks ``given_tracks`` take the model-space roll ``given`` (B, T,
        K, D), the others are sampled (multinn.generate_accompaniment);
        ``seed``: optional (B, T_seed, K, D) priming roll; ``packed`` as in
        generate_async. Returns AsyncRolls; decode with fetch_rolls. On a
        mesh: this rank's rows (and tracks), the rolls gathered over
        ``data``, as generate_async."""
        _check_transport(packed)
        batch = np.shape(given)[0]
        if seed is not None and np.shape(seed)[0] != batch:
            raise ValueError(f"seed batch {np.shape(seed)[0]} != given "
                             f"batch {batch}")
        shard, split = self._mesh_shard(batch)
        with torch.inference_mode():
            given_dev = self._mesh_rows(given, batch, split, shard,
                                        tracks=False)
            state = multinn.init_state(self.params, given_dev.shape[0])
            if seed is not None:
                state = multinn.prime(self.params, state, self._mesh_rows(
                    seed, batch, split, shard, tracks=True), shard)
            _, roll = multinn.generate_accompaniment(
                self.params, key.to(self.device), state, given_dev,
                tuple(int(i) for i in given_tracks), k=self._gibbs_k,
                temperature=self._temperature, shard=shard)
            if split:
                roll = comm.gather_cat(roll.contiguous(), 0, shard.data)
            return self._transport(roll, packed)

    def accompany(self, key: torch.Tensor, given: np.ndarray, given_tracks,
                  seed: Optional[np.ndarray] = None) -> np.ndarray:
        """Blocking accompany_async: a binary (B, T, K, D) uint8 pianoroll
        on the host whose given tracks equal ``given`` bit for bit."""
        return self.fetch_rolls(self.accompany_async(key, given, given_tracks,
                                                     seed=seed))

    def _transport(self, roll: torch.Tensor, packed,
                   latent: Optional[torch.Tensor] = None) -> AsyncRolls:
        """The device side of the transport: pack the roll (and the asked
        rows' ``latent`` roll), and for the sparse transport compact the
        roll's nonzero bytes; then the event."""
        out = bitpack.pack_rolls(roll)
        lat = None if latent is None else bitpack.pack_rolls(latent)
        buf = count = None
        if packed == "sparse":
            buf, count = sparsebytes.sparse_pack(
                out, sparsebytes.record_cap(out.numel()))
        event = None
        if out.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return AsyncRolls(out, event, buf, count, lat)

    def _host(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Copies of device tensors on the host, made on the copy stream
        with one synchronisation (the tensors' work has finished)."""
        if self._copy_stream is None:
            return tensors
        with torch.cuda.stream(self._copy_stream):
            host = [t.to("cpu", non_blocking=True) for t in tensors]
        self._copy_stream.synchronize()
        return host

    def generate(self, key: torch.Tensor, n_steps: int,
                 seed: Optional[np.ndarray] = None,
                 batch: Optional[int] = None) -> np.ndarray:
        """Binary pianoroll (batch, n_steps, K, D) uint8 on the host. With a
        ``seed`` the batch defaults to the seed's; a conflicting explicit
        batch raises."""
        if seed is not None:
            if batch is not None and batch != np.shape(seed)[0]:
                raise ValueError(
                    f"seed batch {np.shape(seed)[0]} != batch {batch}")
            batch = np.shape(seed)[0]
        elif batch is None:
            batch = 1
        return self.fetch_rolls(self.generate_async(key, n_steps, batch,
                                                    seed=seed))

    def fetch_rolls(self, out: AsyncRolls, size_hint: Optional[int] = None
                    ) -> np.ndarray:
        """Wait for a dispatched generation and decode it to (batch,
        n_steps, K, D) uint8 on the host — the transport's single decode
        point, for either transport. The copies run on a stream of their
        own once the event fired, so they do not queue behind generations
        dispatched after this one.

        Sparse: the count and the first chunk(s) of records come in one
        copy; ``size_hint`` (a serving loop passes the previous batch's
        count) widens that first copy so a typical batch needs no second
        one. The rest of the chunks the count needs follow; a count over
        the buffer's rows reads the packed roll instead.

        Spans (utils/profiling): ``serve.drain.wait``, the wait for the
        event, and ``serve.drain.fetch``, the copies and the decode."""
        return self.fetch_with_latents(out, size_hint)[0]

    def fetch_with_latents(self, out: AsyncRolls,
                           size_hint: Optional[int] = None
                           ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``fetch_rolls``'s rolls and the asked rows' model-space rolls
        (R, n_steps, K', F) uint8, copied in the same copies (None where
        no rows were asked for)."""
        with profiling.span("serve.drain.wait"):
            if out.event is not None:
                out.event.synchronize()
        with profiling.span("serve.drain.fetch"):
            if out.sparse is not None:
                return self._fetch_sparse_rolls(out, size_hint)
            return self._fetch_packed_rolls(out)

    def _latents(self, host: List[torch.Tensor]) -> Optional[np.ndarray]:
        """The asked rows' unpacked latent roll from the copies' tail."""
        if not host:
            return None
        return bitpack.unpack_rolls(host[0].numpy(),
                                    self.cfg.model.feature_dim())

    def _extra(self, out: AsyncRolls) -> List[torch.Tensor]:
        return [] if out.latent is None else [out.latent]

    def _fetch_packed_rolls(self, out: AsyncRolls):
        host = self._host([out.packed] + self._extra(out))
        return (bitpack.unpack_rolls(host[0].numpy(),
                                     self.cfg.model.n_pitches),
                self._latents(host[1:]))

    def _fetch_sparse_rolls(self, out: AsyncRolls,
                            size_hint: Optional[int]):
        chunk = sparsebytes.FETCH_CHUNK
        cap = out.sparse.shape[0]
        n_pre = (sparsebytes.n_chunks(int(size_hint * 1.25), chunk)
                 if size_hint else 1)
        n_pre = min(n_pre, sparsebytes.n_chunks(cap, chunk))
        got = self._host([out.count, out.sparse[:n_pre * chunk]]
                         + self._extra(out))
        count = int(got[0])
        latents = self._latents(got[2:])
        # an over-cap count is no size hint: it would prefetch the whole
        # buffer before the next overflow shows
        self.last_sparse_overflowed = count > cap
        self.last_sparse_count = None if self.last_sparse_overflowed \
            else count
        if self.last_sparse_overflowed:      # truncated records: frames
            return self._fetch_packed_rolls(out._replace(latent=None))[0], \
                latents
        need = sparsebytes.n_chunks(count, chunk)
        parts = [got[1].numpy()]
        if need > n_pre:
            parts.append(self._host([out.sparse[n_pre * chunk:
                                                need * chunk]])[0].numpy())
        buf = np.concatenate(parts) if len(parts) > 1 else parts[0]
        pk = sparsebytes.sparse_unpack(buf, count, tuple(out.packed.shape))
        return bitpack.unpack_rolls(pk, self.cfg.model.n_pitches), latents

    def finalize(self, rolls: np.ndarray) -> np.ndarray:
        """Model-space rolls -> user-facing frame pianorolls: decode the data
        encoding, then the opt-in gap-fill / min-note post-processing."""
        if self.cfg.data.encoding != "frame":
            rolls = pianoroll.decode_rolls(rolls, self.cfg.data.encoding)
        gcfg = self.cfg.generate
        gap = getattr(gcfg, "gap_fill_steps", 0)
        min_steps = getattr(gcfg, "min_note_steps", 0)
        if gap or min_steps:
            rolls = pianoroll.postprocess_roll(rolls, gap, min_steps)
        return rolls

    def to_midi(self, roll: np.ndarray, path: str,
                bpm: float = 120.0) -> None:
        """Write one frame pianoroll (T, K, D) as a .mid file (finalize()
        model-space rolls first when data.encoding != 'frame')."""
        from multinn_torch.data import midi as midi_mod
        mid = pianoroll.roll_to_midi(roll, self.cfg.data.spec(), bpm=bpm)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        midi_mod.save(mid, path)

    def write_files(self, rolls: np.ndarray, out_dir: str,
                    prefix: str = "sample", bpm: float = 120.0,
                    write_images: bool = True) -> list:
        """Write finalized frame rolls (batch, T, K, D) as MIDI files (and a
        pianoroll PNG each) into ``out_dir``; returns the MIDI paths."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i in range(rolls.shape[0]):
            p = os.path.join(out_dir, f"{prefix}_{i:03d}.mid")
            self.to_midi(rolls[i], p, bpm=bpm)
            paths.append(p)
        if write_images:
            from multinn_torch.utils.images import save_sample_grid
            save_sample_grid(rolls, out_dir, prefix=prefix)
        return paths

    def generate_to_files(self, key: torch.Tensor, out_dir: str,
                          n_samples: int, n_steps: int,
                          seed: Optional[np.ndarray] = None,
                          bpm: float = 120.0,
                          write_images: bool = True
                          ) -> Tuple[np.ndarray, list]:
        """Generate, finalize and write the first ``n_samples`` rolls;
        returns (the finalized frame rolls, the written MIDI paths)."""
        rolls = self.generate(key, n_steps, seed=seed,
                              batch=(seed.shape[0] if seed is not None
                                     else n_samples))
        rolls = self.finalize(rolls)
        paths = self.write_files(rolls[:n_samples], out_dir, bpm=bpm,
                                 write_images=write_images)
        return rolls, paths


def _check_transport(packed) -> None:
    if packed is not True and packed != "sparse":
        raise ValueError(f"packed must be True or 'sparse', got {packed!r}")
