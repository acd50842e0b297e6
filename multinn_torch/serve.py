"""Serving entry point of the port — counterpart of the repo's ``serve.py``:
an HTTP generation service over a trained model.

    python -m multinn_torch.serve --run RUN_DIR --port 8787
    python -m multinn_torch.serve --config CONFIG.json --fresh   # no ckpt
    python -m multinn_torch.serve --run RUN_DIR --device cpu

Restores the checkpoint (best by default, latest with --latest; ``--fresh``
serves ``multinn.init`` params seeded with ``train.seed``) and serves
continuous-batching generation (serving/service.py) from a stdlib HTTP
server. Runs on the CUDA card unless ``--device`` names another.

API (the reference's):
  GET  /healthz    -> {"ok": true, "batch": B, "n_steps": N}
  GET  /stats      -> service counters + latency percentiles
  POST /generate   body (optional JSON): {"format": "midi"|"roll"
                                                    |"roll_packed",
                                          "bpm": 120.0,
                                          "n": 1,   (songs, 1..1024)
                                          "seed_b64": base64 MIDI bytes or
                                            npz (key "roll") of a
                                            frame-space (T, K, D) roll to
                                            prime on (needs --seed-steps),
                                          "given_b64": the same kinds of
                                            payload, whose
                                            --accompany-tracks slices are
                                            fixed while the other tracks
                                            are sampled (exclusive with
                                            seed_b64)}
    -> {"format": ..., "shape": [T, K, D], "provenance": {...},
        "latency_ms": {...},
        "midi_b64": ... | "roll_b64": ...(npz, key "roll")
        | "roll_packed_b64": ...(npz, key "packed": the pitch axis
          np.packbits-ed; inverse np.unpackbits(z["packed"],
          axis=-1)[..., :D] with D = shape[-1])}
    n>1: "roll_b64" holds (n, T, K, D); "midi_b64", "provenance" and
         "latency_ms" become lists
  Errors: 400 (bad request), 404 (unknown path), 413 (a body over
  MAX_BODY_BYTES, or a payload roll over its size limit), 503 (service
  closed), 504 (generation timed out), 500 (generation failed).

Hostile payloads are refused before they take memory: the body's length
is checked before it is read, an npz roll's element count is read from its
.npy header before the array is allocated, and a seed MIDI longer than the
quantization cap is refused rather than primed on its first frames.
SIGTERM drains like ctrl-C.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import math
import sys
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

MAX_BODY_BYTES = 64 << 20     # a request body larger than this gets a 413
# payload rolls are read up to max(this, the service's length) steps: a
# seed or given roll of up to 512 bars is accepted whatever the service's
# length (the reference's floor for seed MIDI)
PAYLOAD_STEPS_FLOOR = 8192


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--run", help="run dir (reads its config.json + ckpt/)")
    p.add_argument("--config", help="explicit config JSON (alternative)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: best, else latest)")
    p.add_argument("--latest", action="store_true",
                   help="use latest instead of best checkpoint")
    p.add_argument("--fresh", action="store_true",
                   help="serve freshly-initialized params (no checkpoint; "
                        "smoke/load-testing)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--batch", type=int, default=0,
                   help="serving batch (0 = largest fused-gate batch)")
    p.add_argument("--n-steps", type=int, default=0,
                   help="steps per generation (0 = config generate.n_steps)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batching window after the first queued request")
    p.add_argument("--pipeline-depth", type=int, default=3,
                   help="max dispatched-but-unfetched device batches")
    p.add_argument("--seed-steps", type=int, default=0,
                   help="enable seeded (priming) requests, normalized to "
                        "this many frames (0 = unseeded-only service)")
    p.add_argument("--accompany-tracks", default="",
                   help="comma-separated track indices: enable ACCOMPANIMENT "
                        "requests ('given_b64' MIDI bytes or npz roll) whose "
                        "listed tracks are fixed while the rest are sampled")
    p.add_argument("--transport", default="auto",
                   choices=("auto", "packed", "sparse"),
                   help="device->host roll transport (ServeConfig.transport)")
    p.add_argument("--accompany-steps", type=int, default=0,
                   help="accompaniment output length (0 = n-steps)")
    p.add_argument("--timeout-s", type=float, default=120.0,
                   help="per-request generation timeout")
    p.add_argument("--device", default="cuda",
                   help="the serving device (default cuda; cpu for tests)")
    return p.parse_known_args(argv)


def build_service(args, overrides):
    """Config + params -> (cfg, GenerationService); the checkpoint is
    restored as the generate entry point restores it."""
    import torch

    from multinn_torch.models import multinn
    from multinn_torch.serving.service import GenerationService, ServeConfig
    from multinn_torch.utils import config as cfg_mod
    from multinn_torch.utils.device import entry_device

    cfg = cfg_mod.on_one_device(cfg_mod.load_run_config(
        args.run, args.config, overrides))
    if args.fresh:
        params = multinn.init(
            cfg.model, torch.Generator().manual_seed(cfg.train.seed),
            device=entry_device(args.device))
    else:
        from multinn_torch.data.datasets import Dataset
        from multinn_torch.training.trainer import Trainer
        trainer = Trainer(cfg, dataset=Dataset(cfg.data), device=args.device)
        step = args.step
        if step is None and not args.latest:
            step = trainer.ckpt.best_step()
        trainer.restore(step=step)
        params = trainer.params
        trainer.close()

    accompany_tracks = tuple(int(t) for t in args.accompany_tracks.split(",")
                             if t.strip() != "")
    serve_cfg = ServeConfig(batch=args.batch, n_steps=args.n_steps,
                            max_wait_ms=args.max_wait_ms,
                            pipeline_depth=args.pipeline_depth,
                            seed=cfg.train.seed,
                            seed_steps=args.seed_steps,
                            accompany_tracks=accompany_tracks,
                            accompany_steps=args.accompany_steps,
                            transport=args.transport)
    return cfg, GenerationService(cfg, params, serve_cfg)


class PayloadTooLarge(ValueError):
    """A payload whose decoded roll would exceed its size limit (413)."""


def _npz_roll(raw: bytes, max_elems: int) -> np.ndarray:
    """The ``roll`` array of npz bytes, as ``np.load(...)["roll"]`` reads
    it, after checking its .npy header: more than ``max_elems`` elements,
    or elements wider than 8 bytes, raise PayloadTooLarge before anything
    is allocated."""
    with zipfile.ZipFile(io.BytesIO(raw)) as zf:
        names = zf.namelist()
        name = "roll" if "roll" in names else "roll.npy"
        with zf.open(name) as f:
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, _, dtype = read_header(f)
        if math.prod(shape) > max_elems or dtype.itemsize > 8:
            raise PayloadTooLarge(f"the roll {shape} {dtype} holds more "
                                  f"than {max_elems} cells of at most 8 "
                                  f"bytes")
        with zf.open(name) as f:
            return np.lib.format.read_array(f, allow_pickle=False)


def make_handler(cfg, service, timeout_s: float,
                 max_body: int = MAX_BODY_BYTES):
    from multinn_torch.data import midi as midi_mod
    from multinn_torch.data import pianoroll as pr
    spec = cfg.data.spec()
    frame = (cfg.model.n_tracks, service._frame_dim)

    def decode_roll_payload(b64: str, max_steps: int, keep: str = "first"
                            ) -> np.ndarray:
        """A base64 roll payload: raw MIDI bytes (the SMF 'MThd' magic;
        quantized through the service's grid and track spec, at most
        ``max_steps`` steps) or an npz with key 'roll' (``keep`` the first
        or last ``max_steps`` steps). Untrusted input: an npz roll over
        max(max_steps, PAYLOAD_STEPS_FLOOR) x K x D cells raises
        PayloadTooLarge unread, and a seed (``keep="last"``) MIDI longer
        than ``max_steps`` raises ValueError: the cap keeps its first
        steps, not the last ones a seed primes on. Anything else
        unreadable raises (callers answer 400)."""
        raw = base64.b64decode(b64)
        if raw[:4] == b"MThd":
            mid = midi_mod.loads(raw)
            if keep == "last" and pr.grid_steps(mid, spec) > max_steps:
                raise ValueError(f"the seed MIDI is longer than "
                                 f"{max_steps} steps")
            return pr.midi_to_roll(mid, spec, max_steps=max_steps)
        roll = _npz_roll(raw, max(max_steps, PAYLOAD_STEPS_FLOOR)
                         * math.prod(frame))
        if keep == "last":
            return (roll[:, -max_steps:] if roll.ndim == 4
                    else roll[-max_steps:])
        return roll[:, :max_steps] if roll.ndim == 4 else roll[:max_steps]

    def read_payload(req: dict, name: str, max_steps: int, keep: str):
        """(roll or None, None) or (None, (code, error payload))."""
        if name not in req:
            return None, None
        try:
            return decode_roll_payload(req[name], max_steps, keep), None
        except PayloadTooLarge as e:
            return None, (413, {"error": f"{name}: {e}"})
        except Exception as e:       # untrusted bytes: any failure is a 400
            return None, (400, {"error": f"{name} must be base64 of MIDI "
                                         f"bytes or an npz with key "
                                         f"'roll' ({e})"})

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):          # quiet (stats has the counters)
            pass

        def _send(self, code: int, payload: dict, close: bool = False
                  ) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if close:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "batch": service.batch,
                                 "n_steps": service.n_steps})
            elif self.path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = -1
            if length < 0:                     # the body cannot be framed
                self._send(400, {"error": "bad Content-Length"}, close=True)
                return
            if length > max_body:              # refused unread
                self._send(413, {"error": f"body over {max_body} bytes"},
                           close=True)
                return
            # drain the body whatever the path: under keep-alive an unread
            # body desyncs the connection for the next request
            body = self.rfile.read(length)
            if self.path != "/generate":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                req = json.loads(body or b"{}")
            except ValueError:
                self._send(400, {"error": "body must be JSON"})
                return
            if not isinstance(req, dict):
                self._send(400, {"error": "body must be a JSON object"})
                return
            fmt = req.get("format", "midi")
            if fmt not in ("midi", "roll", "roll_packed"):
                self._send(400, {"error": "format must be 'midi', 'roll' "
                                          "or 'roll_packed'"})
                return
            try:
                bpm = float(req.get("bpm", cfg.generate.bpm))
            except (TypeError, ValueError):
                self._send(400, {"error": "bpm must be a number"})
                return
            scfg = service.serve_cfg
            # a seed keeps its LAST seed_steps frames; MIDI caps count from
            # the front, hence the generous floor
            seed, err = read_payload(req, "seed_b64",
                                     max(PAYLOAD_STEPS_FLOOR,
                                         scfg.seed_steps), "last")
            if err is None:
                given, err = read_payload(
                    req, "given_b64",
                    max(1, scfg.accompany_steps or service.n_steps), "first")
            if err is not None:
                self._send(*err)
                return
            n = req.get("n", 1)
            if type(n) is not int or not 1 <= n <= 1024:
                self._send(400, {"error": "n must be an int in [1, 1024]"})
                return
            try:
                futures = service.submit_many(n, seed=seed, given=given)
            except ValueError as e:            # seed/given validation
                self._send(400, {"error": str(e)})
                return
            except RuntimeError as e:          # service closed
                self._send(503, {"error": str(e)})
                return
            try:
                results = [f.result(timeout=timeout_s) for f in futures]
            except TimeoutError:
                self._send(504, {"error": "generation timed out"})
                return
            except Exception as e:             # drainer-side failure
                self._send(500, {"error": f"generation failed: {e}"})
                return
            prov = [{"batch": r.batch_index, "row": r.row} for r in results]
            lat = [{"queue": round(r.queue_s * 1e3, 2),
                    "total": round(r.total_s * 1e3, 2)} for r in results]
            out = {
                "format": fmt,
                "shape": list(results[0].roll.shape),
                "provenance": prov[0] if n == 1 else prov,
                "latency_ms": lat[0] if n == 1 else lat,
            }
            if fmt == "midi":
                mids = [base64.b64encode(midi_mod.dumps(
                    pr.roll_to_midi(r.roll, spec, bpm=bpm))).decode()
                    for r in results]
                out["midi_b64"] = mids[0] if n == 1 else mids
            else:
                buf = io.BytesIO()
                roll = (results[0].roll if n == 1
                        else np.stack([r.roll for r in results]))
                if fmt == "roll_packed":
                    np.savez_compressed(buf, packed=np.packbits(roll,
                                                                axis=-1))
                    out["roll_packed_b64"] = base64.b64encode(
                        buf.getvalue()).decode()
                else:
                    np.savez_compressed(buf, roll=roll)
                    out["roll_b64"] = base64.b64encode(
                        buf.getvalue()).decode()
                if n > 1:
                    out["shape"] = list(roll.shape)
            self._send(200, out)

    return Handler


def serve(args, overrides, ready_event: threading.Event = None,
          server_box: list = None) -> int:
    """Build the service and serve HTTP until interrupted (ctrl-C, SIGTERM
    when on the main thread, or ``httpd.shutdown()`` of the
    ``(httpd, service)`` pair appended to ``server_box``), then drain."""
    cfg, service = build_service(args, overrides)
    handler = make_handler(cfg, service, args.timeout_s)
    httpd = ThreadingHTTPServer((args.host, args.port), handler)
    is_main = threading.current_thread() is threading.main_thread()
    try:
        # installed inside the try: a TERM in the window below must reach
        # the drain in the finally
        if is_main:
            import signal

            def _term(signum, frame):
                raise KeyboardInterrupt
            signal.signal(signal.SIGTERM, _term)
        if server_box is not None:
            server_box.append((httpd, service))
        print(f"serving {cfg.name} on http://{args.host}:{httpd.server_port}"
              f"  (batch={service.batch}, n_steps={service.n_steps}, "
              f"pipeline_depth={service.serve_cfg.pipeline_depth})",
              flush=True)
        if ready_event is not None:
            ready_event.set()
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # mask both signals before draining, so a repeated ctrl-C or TERM
        # cannot abort the drain or skip service.close()
        if is_main:
            import signal
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        try:                 # a KeyboardInterrupt queued before the masking
            httpd.server_close()
            service.close()
        except KeyboardInterrupt:
            httpd.server_close()
            service.close()
    return 0


def main(argv=None) -> int:
    args, overrides = parse_args(argv)
    try:
        return serve(args, overrides)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
