"""Generation engine — port of multinn_tpu/training/generator.py (the
generate / generate_async / accompany / accompany_async / fetch_rolls /
finalize surface).

One generation primes the model state on an optional seed roll, runs
``multinn.generate`` (or ``multinn.generate_accompaniment``, which fixes
some tracks to a given roll and samples the rest; the whole-generation
kernel whenever its gate admits the batch) and bit-packs the roll on the
device; the host unpacks it. The packed transport is the only one for now
(``ops/sparsebytes`` is not ported, ROADMAP queue 1), and mesh generation
waits for a later slice.

``generate_async`` and ``accompany_async`` enqueue everything on the
caller's current CUDA stream without a host synchronisation (the key is
derived on the card, the seed and given rolls copy from pinned memory
without blocking) and return the packed device tensor with a CUDA event
recorded after it; ``fetch_rolls`` waits on that event only, so a serving
loop can dispatch the next batch while this one runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from multinn_torch.data import pianoroll
from multinn_torch.models import multinn
from multinn_torch.ops import bitpack


class AsyncRolls(NamedTuple):
    """A dispatched generation: the bit-packed roll (B, T, K, ceil(D/8))
    uint8 on the device, and the event recorded after its last kernel
    (None on the CPU)."""
    packed: torch.Tensor
    event: Optional[torch.cuda.Event]


class Generator:
    """Public generator API over a model's params (random from
    ``multinn.init`` or converted with ``utils.convert.from_jax``). It runs
    on the device the params live on."""

    def __init__(self, cfg, params: multinn.MultINNParams):
        self.cfg = cfg
        self.params = params
        self.device = params.decoder.w.device
        # generate.gibbs_k overrides the model's gen_k (0 = model default)
        self._gibbs_k = getattr(cfg.generate, "gibbs_k", 0) or None
        self._temperature = float(getattr(cfg.generate, "temperature", 1.0))
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def _to_device(self, seed: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(seed, np.float32))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def generate_async(self, key: torch.Tensor, n_steps: int,
                       batch: int = 1, seed: Optional[np.ndarray] = None
                       ) -> AsyncRolls:
        """Dispatch one generation without blocking. ``key``: a Threefry key
        (ops/sampling.py); ``seed``: optional (batch, T_seed, K, D)
        model-space priming roll. Returns AsyncRolls; decode with
        fetch_rolls."""
        if seed is not None and np.shape(seed)[0] != batch:
            raise ValueError(f"seed batch {np.shape(seed)[0]} != {batch}")
        with torch.inference_mode():
            state = multinn.init_state(self.params, batch)
            if seed is not None:
                state = multinn.prime(self.params, state,
                                      self._to_device(seed))
            _, roll = multinn.generate(self.params, key.to(self.device),
                                       state, n_steps, k=self._gibbs_k,
                                       temperature=self._temperature)
            out = bitpack.pack_rolls(roll)
        return AsyncRolls(out, self._record(out))

    def accompany_async(self, key: torch.Tensor, given: np.ndarray,
                        given_tracks, seed: Optional[np.ndarray] = None
                        ) -> AsyncRolls:
        """Dispatch one track-conditional generation without blocking: the
        tracks ``given_tracks`` take the model-space roll ``given`` (B, T,
        K, D), the others are sampled (multinn.generate_accompaniment);
        ``seed``: optional (B, T_seed, K, D) priming roll. Returns
        AsyncRolls; decode with fetch_rolls."""
        if seed is not None and np.shape(seed)[0] != np.shape(given)[0]:
            raise ValueError(f"seed batch {np.shape(seed)[0]} != given "
                             f"batch {np.shape(given)[0]}")
        with torch.inference_mode():
            given_dev = self._to_device(given)
            state = multinn.init_state(self.params, given_dev.shape[0])
            if seed is not None:
                state = multinn.prime(self.params, state,
                                      self._to_device(seed))
            _, roll = multinn.generate_accompaniment(
                self.params, key.to(self.device), state, given_dev,
                tuple(int(i) for i in given_tracks), k=self._gibbs_k,
                temperature=self._temperature)
            out = bitpack.pack_rolls(roll)
        return AsyncRolls(out, self._record(out))

    def accompany(self, key: torch.Tensor, given: np.ndarray, given_tracks,
                  seed: Optional[np.ndarray] = None) -> np.ndarray:
        """Blocking accompany_async: a binary (B, T, K, D) uint8 pianoroll
        on the host whose given tracks equal ``given`` bit for bit."""
        return self.fetch_rolls(self.accompany_async(key, given, given_tracks,
                                                     seed=seed))

    def _record(self, out: torch.Tensor) -> Optional[torch.cuda.Event]:
        """An event after the work queued for ``out`` (None on the CPU)."""
        if not out.is_cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

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

    def fetch_rolls(self, out: AsyncRolls) -> np.ndarray:
        """Wait for a dispatched generation and decode it to (batch,
        n_steps, K, D) uint8 on the host — the transport's single decode
        point. The copy runs on a stream of its own once the event fired,
        so it does not queue behind generations dispatched after this one."""
        if out.event is not None:
            out.event.synchronize()
            with torch.cuda.stream(self._copy_stream):
                host = out.packed.to("cpu")
        else:
            host = out.packed
        return bitpack.unpack_rolls(host.numpy(), self.cfg.model.n_pitches)

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
