"""Continuous-batching generation service — port of
multinn_tpu/serving/service.py (plain, seeded and accompaniment requests).

A request queue -> ONE dispatcher thread that coalesces up to ``batch``
requests of one kind (plain, seeded or accompaniment) per device call,
waiting at most
``max_wait_ms`` after the first (under-full batches run padded, so the
program shape never changes) -> a bounded window of ``pipeline_depth``
dispatched batches -> ONE drainer thread that waits on each batch's CUDA
event, fetches and decodes it, and resolves the per-request futures.

The dispatcher enqueues its work on a CUDA stream of its own and never
synchronises (keys derive on the card, seeds copy from pinned memory), so
the next batch is queued while the previous one runs; the drainer's copies
run on the generator's copy stream.

RNG contract: batch ``i`` samples under ``fold_in(PRNGKey(seed), i)`` — the
same kernel seeds as the JAX service's batch ``i``; a request's provenance
``(batch_index, row)`` pins its sample stream.

With ``accompany_tracks`` a request may carry a frame-space ``given``
roll: those tracks are fixed and the others sampled
(``Generator.accompany_async``), every roll normalized to
``accompany_steps`` frames, so accompaniment is one more program shape;
such requests have their own queue and never share a batch with plain or
seeded ones.

The device -> host transport (``transport``) is the bit-packed roll
("packed") or its nonzero bytes as records ("sparse", ops/sparsebytes,
with the packed roll as the overflow fallback); "auto" picks sparse for
large packed batches off the card, packed on it (``_resolve_transport``).
Two consecutive overflows demote a sparse service: the drain reads the
packed roll from then on.

With ``latent_rows`` those rows of every plain or seeded batch also come
back in model space (``ServeResult.latent``: the decoders' latent roll
that a DBN's decode drew the pianoroll from), gathered and bit-packed on
the card and copied with the batch's roll in the same drain; the
pianoroll is the same bits with or without it.

With the span recorder on (utils/profiling), each batch records its
spans, identified by its batch index: on the dispatcher ``serve.take``
(the oldest request's enqueue -> the dispatch, so ``queue_s`` is a
request's part of it), ``serve.inflight`` (the wait for room in the
pipeline inside it) and ``serve.dispatch`` (the key and the enqueue);
``serve.card``, the card's interval from a timing event before the
batch's first operation on the service's stream to one after its last;
on the drainer ``serve.drain`` around ``serve.drain.wait`` (the event)
and ``.fetch`` (the copies and the unpack), both recorded by
``Generator.fetch_rolls``, ``.finalize`` and ``.resolve`` (every future
set, callbacks included). ``serve.card`` is a
``profiling.card_interval``, timed only while the recorder times this
service's card (``profiling.card_timing``); a DBN service's decode span
``gen.dbn_decode``, the model's card interval inside it, takes the
batch's index from it.

With a ``mesh`` (parallel/mesh.py) the service's Generator generates on
it. Rank 0 takes the requests; before each of its device calls (the
warm-ups included) it broadcasts the call — its kind, key words and seed
or given roll — to the other ranks, which ``follow()`` it and run the same
call, until ``close()`` broadcasts the end.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from multinn_torch.data import pianoroll
from multinn_torch.ops import sampling
from multinn_torch.parallel import comm
from multinn_torch.utils import profiling

# the calls rank 0 broadcasts to the other ranks of a mesh
_STOP, _PLAIN, _SEEDED, _ACCOMPANY = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Server knobs (field names and defaults as the JAX ServeConfig)."""
    batch: int = 0             # 0 = auto: largest fused-gate-admitted batch
    n_steps: int = 0           # 0 = cfg.generate.n_steps
    max_wait_ms: float = 5.0   # batching window after the first request
    pipeline_depth: int = 3    # max dispatched-but-unfetched device batches
    seed: int = 0              # base RNG seed (batch i uses fold_in(seed, i))
    history: int = 1024        # latency samples kept for percentile stats
    seed_steps: int = 0        # >0 enables seeded requests (seed rolls are
    #                            cropped / left-padded to this many frames)
    accompany_tracks: tuple = ()  # non-empty enables accompaniment requests:
    #                            these tracks of a given roll are fixed, the
    #                            rest sampled
    accompany_steps: int = 0   # accompaniment length (0 = n_steps)
    transport: str = "auto"    # "packed" (bit-packed frames) | "sparse"
    #                            (nonzero packed bytes, packed fallback) |
    #                            "auto" (_resolve_transport)


@dataclasses.dataclass
class ServeResult:
    """Resolved value of one request's future."""
    roll: np.ndarray           # finalized FRAME pianoroll (n_steps, K, D)
    batch_index: int           # provenance: which device batch
    row: int                   # provenance: row within the batch
    queue_s: float             # enqueue -> dispatch
    total_s: float             # enqueue -> resolution
    latent: Optional[np.ndarray] = None   # model-space roll (n_steps, K', F)
    #                            uint8 of a row in the service's
    #                            latent_rows, else None


class _Request:
    __slots__ = ("future", "t_enqueue", "seed", "given")

    def __init__(self, seed: Optional[np.ndarray] = None,
                 given: Optional[np.ndarray] = None):
        self.future = Future()
        self.t_enqueue = time.time()
        self.seed = seed       # normalized model-space (seed_steps, K, D)
        self.given = given     # normalized model-space (accompany_steps,K,D)

    @property
    def kind(self) -> str:
        """One program shape per kind; a batch holds one kind."""
        if self.given is not None:
            return "accompany"
        return "seeded" if self.seed is not None else "plain"


def _resolve_transport(choice: str, cfg, batch: int, n_steps: int,
                       device=None):
    """ServeConfig.transport -> the Generator ``packed`` flag (True or
    "sparse"). "auto" is packed on a CUDA device: its host link moves the
    packed roll faster than the host decodes records (on the H100 the
    sparse drain lost at B=128 even at 1 % of cells on, ROADMAP). Elsewhere
    it is the reference's rule: sparse iff the bit-packed batch is at
    least twice the sparse path's least fetch, one whole record chunk
    (FETCH_CHUNK * RECORD_BYTES = 1.31 MB); below that sparse always moves
    more bytes. ``n_steps`` is the longest program the service runs."""
    if choice not in ("auto", "packed", "sparse"):
        raise ValueError(f"transport must be auto|packed|sparse, "
                         f"got {choice!r}")
    if choice == "auto":
        if device is not None and torch.device(device).type == "cuda":
            return True
        from multinn_torch.ops import bitpack, sparsebytes
        packed_bytes = (batch * n_steps * cfg.model.n_tracks
                        * bitpack.packed_width(cfg.model.n_pitches))
        min_sparse = sparsebytes.FETCH_CHUNK * sparsebytes.RECORD_BYTES
        return "sparse" if packed_bytes >= 2 * min_sparse else True
    return "sparse" if choice == "sparse" else True


def auto_batch(cfg, n_steps: int) -> int:
    """Largest fused-kernel-gate-admitted serving batch for this config,
    from the decoder family's candidates (the JAX service's lists); 8 when
    nothing is admitted (the scan path still serves)."""
    from multinn_torch.ops import gen_fused
    if cfg.model.decoder_type == "rnn-nade":
        cands = (8, 16, 32, 48, 64, 128)
        gate = gen_fused.supported_nade
    else:
        cands = (8, 16, 32, 64, 128, 256)
        gate = gen_fused.supported
    return max((b for b in cands if gate(cfg.model, b, n_steps)), default=8)


class GenerationService:
    """Continuous-batching generation server core (module docstring).
    ``mesh``: generate on a process mesh; on its ranks other than 0 the
    constructor returns at once and ``follow()`` serves rank 0's calls.
    ``latent_rows``: rows of every plain or seeded batch whose model-space
    roll comes back in ``ServeResult.latent`` (not on a mesh, nor with
    ``accompany_tracks``); ServeConfig keeps the JAX service's fields."""

    def __init__(self, cfg, params, serve_cfg: ServeConfig = None,
                 mesh=None, latent_rows: tuple = ()):
        from multinn_torch.training.generator import Generator

        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        self.n_steps = self.serve_cfg.n_steps or cfg.generate.n_steps
        self.batch = self.serve_cfg.batch or auto_batch(cfg, self.n_steps)
        self.generator = Generator(cfg, params, mesh=mesh)
        self.mesh = mesh
        self.rank = 0 if mesh is None else torch.distributed.get_rank()
        self.device = self.generator.device
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._base_key = sampling.PRNGKey(self.serve_cfg.seed,
                                          device=self.device)

        self._accompany_tracks = tuple(
            int(i) for i in self.serve_cfg.accompany_tracks)
        self._accompany_steps = (self.serve_cfg.accompany_steps
                                 or self.n_steps)
        steps_max = max(self.n_steps, self._accompany_steps
                        if self._accompany_tracks else 0)
        self._packed = _resolve_transport(self.serve_cfg.transport, cfg,
                                          self.batch, steps_max, self.device)
        self._latent_rows = tuple(int(r) for r in latent_rows)
        if self._latent_rows and (
                len(set(self._latent_rows)) < len(self._latent_rows)
                or not all(0 <= r < self.batch for r in self._latent_rows)
                or mesh is not None or self._accompany_tracks):
            raise ValueError(
                f"latent_rows {self._latent_rows} must be distinct rows of a "
                f"batch of {self.batch}, on a service without a mesh or "
                f"accompany_tracks")

        self._lock = threading.Condition()
        self._queues = {"plain": collections.deque(),
                        "seeded": collections.deque(),
                        "accompany": collections.deque()}
        self._closed = False
        self._inflight = threading.Semaphore(self.serve_cfg.pipeline_depth)
        self._done_q: collections.deque = collections.deque()
        self._done_cv = threading.Condition()

        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_sparse_overflows = 0   # consecutive; 2 demote to packed
        self._transport_demoted = False
        self._n_batches = 0
        self._n_seeded_batches = 0
        self._n_accompany_batches = 0
        self._n_padded_rows = 0
        self._n_errors = 0
        self._t_started = time.time()
        self._latencies = collections.deque(maxlen=self.serve_cfg.history)
        self._queue_waits = collections.deque(maxlen=self.serve_cfg.history)
        self._done_times = collections.deque(maxlen=self.serve_cfg.history)

        # user-facing seed rolls are FRAME space; the model may be onset_hold
        self._frame_dim = (cfg.model.n_pitches // 2
                           if cfg.data.encoding == "onset_hold"
                           else cfg.model.n_pitches)
        if self.rank != 0:                 # follow() serves rank 0's calls
            self._closed = True
            return

        # warm every program shape before accepting traffic (the first call
        # builds the kernels): one unseeded, plus one seeded iff seed_steps,
        # plus one accompaniment iff accompany_tracks
        self.generator.fetch_rolls(self._dispatch(self._base_key, None))
        frame = (cfg.model.n_tracks, cfg.model.n_pitches)
        if self.serve_cfg.seed_steps > 0:
            zeros = np.zeros((self.batch, self.serve_cfg.seed_steps, *frame),
                             np.float32)
            self.generator.fetch_rolls(self._dispatch(self._base_key, zeros))
        if self._accompany_tracks:
            zeros = np.zeros((self.batch, self._accompany_steps, *frame),
                             np.float32)
            self.generator.fetch_rolls(self._dispatch(self._base_key, None,
                                                      zeros))

        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="multinn-serve-dispatch",
                                            daemon=True)
        self._drainer = threading.Thread(target=self._drain_loop,
                                         name="multinn-serve-drain",
                                         daemon=True)
        self._dispatcher.start()
        self._drainer.start()

    def _dispatch(self, key, seed_arr, given_arr=None):
        if self.mesh is not None:
            self._announce(key, seed_arr, given_arr)
        return self._run(key, seed_arr, given_arr)

    def _run(self, key, seed_arr, given_arr=None):
        with torch.cuda.stream(self._stream):
            if given_arr is not None:
                return self.generator.accompany_async(
                    key, given_arr, self._accompany_tracks,
                    packed=self._packed)
            return self.generator.generate_async(
                key, self.n_steps, self.batch, seed=seed_arr,
                packed=self._packed, latent_rows=self._latent_rows)

    # -- the other ranks of a mesh ---------------------------------------------

    def _frame_shape(self, steps: int):
        return (self.batch, steps, self.cfg.model.n_tracks,
                self.cfg.model.n_pitches)

    def _announce(self, key, seed_arr, given_arr) -> None:
        """Rank 0: broadcast the call (kind, key words, seed or given
        roll) to the other ranks."""
        kind = (_ACCOMPANY if given_arr is not None
                else _SEEDED if seed_arr is not None else _PLAIN)
        words = sampling.key_to_seeds(key).to("cpu", torch.int64)
        comm.broadcast(torch.cat([torch.tensor([kind]), words]))
        arr = given_arr if given_arr is not None else seed_arr
        if arr is not None:
            comm.broadcast(torch.from_numpy(np.ascontiguousarray(
                arr, np.float32)))

    def follow(self) -> int:
        """A rank other than 0: run every call rank 0 broadcasts, until
        it closes; returns the calls run."""
        if self.rank == 0:
            raise RuntimeError("rank 0 takes the requests; follow() is for "
                               "the other ranks of the mesh")
        n = 0
        while True:
            head = comm.broadcast(torch.zeros(3, dtype=torch.int64))
            kind = int(head[0])
            if kind == _STOP:
                return n
            key = head[1:].to(torch.int32).view(torch.uint32).to(self.device)
            seed_arr = given_arr = None
            if kind == _SEEDED:
                seed_arr = comm.broadcast(torch.zeros(self._frame_shape(
                    self.serve_cfg.seed_steps))).numpy()
            elif kind == _ACCOMPANY:
                given_arr = comm.broadcast(torch.zeros(self._frame_shape(
                    self._accompany_steps))).numpy()
            self.generator.fetch_rolls(self._run(key, seed_arr, given_arr))
            n += 1

    # -- front end -----------------------------------------------------------

    def _normalize_seed(self, seed: np.ndarray) -> np.ndarray:
        """User frame-space seed roll (T, K, D_frame) -> model-space
        (seed_steps, K, D_model) float32: encode the full roll, keep the LAST
        seed_steps frames, left-pad zeros."""
        if self.serve_cfg.seed_steps <= 0:
            raise ValueError("this service has seed_steps=0: seeded "
                             "requests are disabled")
        seed = np.asarray(seed)
        k, d = self.cfg.model.n_tracks, self._frame_dim
        if seed.ndim != 3 or seed.shape[1:] != (k, d) or seed.shape[0] < 1:
            raise ValueError(f"seed roll must be (T>=1, {k}, {d}) "
                             f"frame-space, got {seed.shape}")
        enc = (seed > 0).astype(np.uint8)
        if self.cfg.data.encoding != "frame":
            enc = pianoroll.encode_rolls(enc, self.cfg.data.encoding)
        s = self.serve_cfg.seed_steps
        enc = enc[-s:]
        if enc.shape[0] < s:
            pad = np.zeros((s - enc.shape[0],) + enc.shape[1:], enc.dtype)
            enc = np.concatenate([pad, enc], axis=0)
        return enc.astype(np.float32)

    def _normalize_given(self, given: np.ndarray) -> np.ndarray:
        """User frame-space accompaniment roll (T, K, D_frame) ->
        model-space (accompany_steps, K, D) float32: encode the full roll,
        keep the FIRST accompany_steps frames (the given music plays from
        the start), right-pad zeros."""
        if not self._accompany_tracks:
            raise ValueError(
                "this service has no accompany_tracks: accompaniment "
                "requests are disabled")
        given = np.asarray(given)
        k, d = self.cfg.model.n_tracks, self._frame_dim
        if given.ndim != 3 or given.shape[1:] != (k, d) or given.shape[0] < 1:
            raise ValueError(f"accompaniment roll must be (T>=1, {k}, {d}) "
                             f"frame-space, got {given.shape}")
        enc = pianoroll.encode_rolls((given > 0).astype(np.uint8),
                                     self.cfg.data.encoding)
        s = self._accompany_steps
        enc = enc[:s]
        if enc.shape[0] < s:
            pad = np.zeros((s - enc.shape[0],) + enc.shape[1:], enc.dtype)
            enc = np.concatenate([enc, pad], axis=0)
        return enc.astype(np.float32)

    def submit(self, seed: Optional[np.ndarray] = None,
               given: Optional[np.ndarray] = None) -> Future:
        """Enqueue one generation request; returns its future (resolving to
        a ServeResult). ``seed``: optional frame-space roll (T, K, D_frame)
        to prime on (requires ServeConfig.seed_steps > 0). ``given``:
        optional frame-space roll whose ServeConfig.accompany_tracks are
        fixed while the other tracks are sampled."""
        return self.submit_many(1, seed=seed, given=given)[0]

    def submit_many(self, n: int, seed: Optional[np.ndarray] = None,
                    given: Optional[np.ndarray] = None) -> List[Future]:
        """Enqueue ``n`` requests atomically, all with the same seed or
        given roll (or neither). Returns their futures in submission
        order."""
        if seed is not None and given is not None:
            raise ValueError("a request carries either a priming seed or "
                             "an accompaniment roll, not both")
        norm_s = self._normalize_seed(seed) if seed is not None else None
        norm_g = self._normalize_given(given) if given is not None else None
        reqs = [_Request(norm_s, norm_g) for _ in range(n)]
        if not reqs:
            return []
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self._queues[reqs[0].kind].extend(reqs)
            self._lock.notify()
        with self._stats_lock:
            self._n_requests += n
        return [r.future for r in reqs]

    def stats(self) -> dict:
        """Service counters + latency percentiles over the recent window."""
        with self._stats_lock:
            lat = np.asarray(self._latencies, np.float64)
            qw = np.asarray(self._queue_waits, np.float64)
            out = {
                "batch": self.batch,
                "n_steps": self.n_steps,
                "transport": ("sparse" if self._packed == "sparse"
                              else "packed"),
                "transport_demoted": self._transport_demoted,
                "pipeline_depth": self.serve_cfg.pipeline_depth,
                "requests": self._n_requests,
                "batches": self._n_batches,
                "seeded_batches": self._n_seeded_batches,
                "accompany_batches": self._n_accompany_batches,
                "accompany_tracks": list(self._accompany_tracks),
                "seed_steps": self.serve_cfg.seed_steps,
                "padded_rows": self._n_padded_rows,
                "errors": self._n_errors,
                "uptime_s": time.time() - self._t_started,
                "queued": sum(len(q) for q in self._queues.values()),
            }
            if lat.size:
                out["latency_ms"] = {
                    "p50": float(np.percentile(lat, 50)) * 1e3,
                    "p95": float(np.percentile(lat, 95)) * 1e3,
                    "p99": float(np.percentile(lat, 99)) * 1e3,
                    "window": int(lat.size),
                }
                out["queue_wait_ms_p50"] = float(np.percentile(qw, 50)) * 1e3
                if len(self._done_times) >= 2:
                    span = self._done_times[-1] - self._done_times[0]
                    out["songs_per_s"] = ((len(self._done_times) - 1)
                                          / max(span, 1e-9))
            return out

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, drain in-flight work, join threads.
        Queued-but-undispatched requests are rejected; on a mesh the other
        ranks' ``follow()`` returns. Idempotent."""
        if self.rank != 0:
            return
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            self._lock.notify_all()
        for req in pending:
            req.future.set_exception(RuntimeError("service closed"))
        with self._done_cv:
            self._done_cv.notify_all()
        self._dispatcher.join(timeout)
        self._drainer.join(timeout)
        if self.mesh is not None:
            comm.broadcast(torch.tensor([_STOP, 0, 0]))

    def _note_sparse_overflow(self, overflowed: bool) -> None:
        """Demote a sparse service after two consecutive overflows (each
        already served through the packed fallback): the model is too
        dense for the records, so the drain reads every later batch's
        packed roll directly. The dispatch keeps computing the records, as
        the reference's does."""
        if not overflowed:
            self._n_sparse_overflows = 0
            return
        self._n_sparse_overflows += 1
        if self._n_sparse_overflows >= 2:
            self._transport_demoted = True

    # -- dispatcher thread ----------------------------------------------------

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until >=1 request, then wait up to max_wait_ms for the batch
        to fill. The oldest queued request picks the kind. None on close."""
        deadline = None
        with self._lock:
            while True:
                live = [q for q in self._queues.values() if q]
                if live:
                    q = min(live, key=lambda q: q[0].t_enqueue)
                    if deadline is None:
                        deadline = (q[0].t_enqueue
                                    + self.serve_cfg.max_wait_ms / 1e3)
                    if len(q) >= self.batch or time.time() >= deadline:
                        return [q.popleft()
                                for _ in range(min(self.batch, len(q)))]
                    self._lock.wait(max(deadline - time.time(), 0.0))
                elif self._closed:
                    return None
                else:
                    deadline = None
                    self._lock.wait(0.1)

    def _rows(self, rolls: List[np.ndarray]) -> np.ndarray:
        """The requests' rolls as one batch, zero rows padding it."""
        out = np.zeros((self.batch,) + rolls[0].shape, np.float32)
        for row, roll in enumerate(rolls):
            out[row] = roll
        return out

    def _dispatch_loop(self) -> None:
        rec = profiling.recorder
        while True:
            reqs = self._take_batch()
            if reqs is None:
                return
            on = rec.on                        # spans of this batch
            if on:
                t_wait = time.time_ns()
            self._inflight.acquire()           # bound dispatched-unfetched
            if on:
                t_room = time.time_ns()
            kind = reqs[0].kind
            with self._stats_lock:
                bi = self._n_batches
                self._n_batches += 1
                self._n_seeded_batches += int(kind == "seeded")
                self._n_accompany_batches += int(kind == "accompany")
                self._n_padded_rows += self.batch - len(reqs)
            seed_arr = given_arr = None
            if kind == "seeded":               # pad rows prime on zeros
                seed_arr = self._rows([r.seed for r in reqs])
            elif kind == "accompany":          # pad rows accompany silence
                given_arr = self._rows([r.given for r in reqs])
            t_dispatch = time.time()
            try:
                with profiling.card_interval("serve.card", bi, self._stream):
                    with torch.cuda.stream(self._stream):
                        key = sampling.fold_in(self._base_key, bi)
                    out = self._dispatch(key, seed_arr, given_arr)
                if on:
                    t_ns = int(t_dispatch * 1e9)
                    profiling.record("serve.take",
                                     int(reqs[0].t_enqueue * 1e9), t_ns, bi)
                    profiling.record("serve.inflight", t_wait, t_room, bi)
                    profiling.record("serve.dispatch", t_ns, time.time_ns(),
                                     bi)
            except Exception as e:            # pragma: no cover - defensive
                self._inflight.release()
                with self._stats_lock:
                    self._n_errors += len(reqs)
                for r in reqs:
                    r.future.set_exception(e)
                continue
            with self._done_cv:
                self._done_q.append((out, reqs, bi, t_dispatch))
                self._done_cv.notify()

    # -- drainer thread --------------------------------------------------------

    def _drain_loop(self) -> None:
        while True:
            with self._done_cv:
                while not self._done_q:
                    if self._closed and not self._dispatcher.is_alive():
                        return
                    self._done_cv.wait(0.1)
                out, reqs, bi, t_dispatch = self._done_q.popleft()
            with profiling.span("serve.drain", bi):
                self._drain(out, reqs, bi, t_dispatch)

    def _drain(self, out, reqs, bi: int, t_dispatch: float) -> None:
        """Wait for one dispatched batch, fetch and finalize its rolls (and
        its latent rows) and resolve its requests' futures."""
        try:
            was_sparse = out.sparse is not None
            if was_sparse and self._transport_demoted:
                out, was_sparse = out._replace(sparse=None,
                                               count=None), False
            hint = (self.generator.last_sparse_count if was_sparse
                    else None)
            # serve.drain.wait and serve.drain.fetch
            rolls, latents = self.generator.fetch_with_latents(
                out, size_hint=hint)
            with profiling.span("serve.drain.finalize"):
                rolls = self.generator.finalize(rolls)
            if was_sparse:
                self._note_sparse_overflow(
                    self.generator.last_sparse_overflowed)
        except Exception as e:
            self._inflight.release()
            with self._stats_lock:
                self._n_errors += len(reqs)
            for r in reqs:
                r.future.set_exception(e)
            return
        self._inflight.release()
        t_done = time.time()
        with self._stats_lock:
            for r in reqs:
                self._latencies.append(t_done - r.t_enqueue)
                self._queue_waits.append(t_dispatch - r.t_enqueue)
                self._done_times.append(t_done)
        kept = ({} if latents is None
                else dict(zip(self._latent_rows, latents)))
        with profiling.span("serve.drain.resolve"):
            for row, r in enumerate(reqs):
                r.future.set_result(ServeResult(
                    roll=rolls[row], batch_index=bi, row=row,
                    queue_s=t_dispatch - r.t_enqueue,
                    total_s=t_done - r.t_enqueue, latent=kept.get(row)))
