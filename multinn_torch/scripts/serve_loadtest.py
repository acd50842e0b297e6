"""Serving load test — the port's counterpart of
``scripts/serve_loadtest.py``: saturated throughput and latency
percentiles of the continuous-batching generation service
(``multinn_torch.serving``), in process or through the HTTP front end
(``multinn_torch.serve``).

Measures the END-TO-END serving story that a kernel's time cannot:
request coalescing, the bounded pipeline of dispatched batches, the drain
to host rolls, and (with ``--http``) the stdlib HTTP server, under a
closed-loop load of N concurrent clients.

    python -m multinn_torch.scripts.serve_loadtest \\
        --config configs/jsb_rnnrbm.json --requests 256 --clients 32
    python -m multinn_torch.scripts.serve_loadtest ... --http
    python -m multinn_torch.scripts.serve_loadtest ... --open-loop
    python -m multinn_torch.scripts.serve_loadtest ... --soak 60
    python -m multinn_torch.scripts.serve_loadtest ... --seed-steps 32 \\
        --seeded-frac 0.5
    python -m multinn_torch.scripts.serve_loadtest ... --device cpu

Prints ONE JSON line with the JAX script's keys: songs/s over the
completion window, latency percentiles and the service's own counters.
The service is built as ``multinn_torch.serve`` builds it: fresh
parameters drawn from ``train.seed`` (``serve --fresh``), or ``--run`` to
restore a checkpoint; load numbers do not depend on the weights. Runs on
the CUDA card unless ``--device`` names another. Unknown ``--a.b=c``
arguments are config overrides.
"""

from __future__ import annotations

import argparse
import base64
import http.client
import io
import json
import os
import sys
import threading
import time

import numpy as np

from multinn_torch import serve as serve_mod


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, allow_abbrev=False,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/jsb_rnnrbm.json")
    p.add_argument("--run", default=None, help="run dir w/ checkpoint")
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--clients", type=int, default=32,
                   help="closed-loop concurrent clients")
    p.add_argument("--batch", type=int, default=0)
    p.add_argument("--n-steps", type=int, default=0)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--pipeline-depth", type=int, default=3)
    p.add_argument("--seed-steps", type=int, default=0)
    p.add_argument("--transport", default="auto",
                   choices=("auto", "packed", "sparse"))
    p.add_argument("--payload", default="roll",
                   choices=("roll", "roll_packed", "midi"),
                   help="HTTP response format (--http only): 'roll' npz, "
                        "'roll_packed' (packbits-ed npz — wins on DENSE "
                        "rolls; equal at musical densities), or 'midi'")
    p.add_argument("--seeded-frac", type=float, default=0.0,
                   help="fraction of requests carrying a priming seed")
    p.add_argument("--http", action="store_true",
                   help="drive through multinn_torch.serve's HTTP front "
                        "end instead of the in-process service API")
    p.add_argument("--soak", type=float, default=0.0,
                   help="sustained-load SOAK for this many seconds "
                        "(bounded in-flight open loop) sampling RSS/fd "
                        "stability — overrides --requests/--open-loop")
    p.add_argument("--open-loop", action="store_true",
                   help="submit ALL requests upfront from one thread "
                        "(service-ceiling measurement: no client-thread "
                        "GIL noise; --clients ignored; direct mode only)")
    p.add_argument("--bulk-n", type=int, default=1,
                   help="songs per HTTP POST (the bulk endpoint; --http "
                        "only). --requests still counts SONGS")
    p.add_argument("--device", default="cuda",
                   help="the serving device (default cuda; cpu for tests)")
    return p.parse_known_args(argv)


def percentiles(xs):
    xs = np.asarray(xs, np.float64)
    if not xs.size:
        return {}
    return {f"p{q}": round(float(np.percentile(xs, q)) * 1e3, 2)
            for q in (50, 95, 99)}


def _seed_for(i, seed_roll, seeded_frac):
    """The priming seed of request ``i``: ``seeded_frac`` of each 100."""
    return (seed_roll if seed_roll is not None
            and (i % 100) < seeded_frac * 100 else None)


def run_open_loop(service, n_requests, seed_roll, seeded_frac):
    """Submit everything upfront; the dispatcher coalesces full batches
    back to back — the service's ceiling on this host."""
    t0 = time.time()
    futures = [service.submit(seed=_seed_for(i, seed_roll, seeded_frac))
               for i in range(n_requests)]
    lat, failed = [], 0
    for f in futures:
        try:
            lat.append(f.result(timeout=600).total_s)
        except Exception as e:
            failed += 1
            print(f"request failed: {e!r}", file=sys.stderr)
    return time.time() - t0, lat, failed


def _proc_rss_fds():
    rss = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024
                break
    return rss, len(os.listdir("/proc/self/fd"))


def run_soak(service, duration_s, seed_roll, seeded_frac, depth=256):
    """Sustained load for ``duration_s``: keep up to ``depth`` requests in
    flight, sampling the process's RSS and open-fd counts as it runs. The
    stability report (memory growth after warm-up, fd drift, first- vs
    last-quarter latency drift) is the long-running-service leak check a
    one-shot load test cannot give."""
    t0 = time.time()
    lat, failed, samples = [], 0, []
    inflight = []
    i = 0
    next_sample = t0

    def sample(now):
        rss, fds = _proc_rss_fds()
        samples.append({"t_s": round(now - t0, 1),
                        "rss_mb": round(rss / 1e6, 1), "fds": fds,
                        "done": len(lat)})

    while True:
        now = time.time()
        if now >= next_sample:
            sample(now)
            next_sample = now + 2.0
        live = now - t0 < duration_s
        while live and len(inflight) < depth:
            inflight.append(service.submit(
                seed=_seed_for(i, seed_roll, seeded_frac)))
            i += 1
        if not inflight:
            break
        f = inflight.pop(0)
        try:
            lat.append(f.result(timeout=600).total_s)
        except Exception as e:
            failed += 1
            print(f"request failed: {e!r}", file=sys.stderr)
    sample(time.time())
    return time.time() - t0, lat, failed, samples


def soak_report(lat, samples):
    """Stability summary: RSS growth AFTER the first sample window (start-up
    allocations and kernel builds are expected; steady-state growth is the
    leak signal), fd drift, and latency drift between the first and last
    quarter of completed requests."""
    rss = [s["rss_mb"] for s in samples]
    fds = [s["fds"] for s in samples]
    q = max(1, len(lat) // 4)
    drift = (float(np.mean(lat[-q:])) / float(np.mean(lat[:q]))
             if len(lat) >= 4 else 1.0)
    return {
        "samples": len(samples),
        "rss_mb_first": rss[0] if rss else 0.0,
        "rss_mb_max": max(rss) if rss else 0.0,
        "rss_mb_last": rss[-1] if rss else 0.0,
        "rss_growth_after_warmup_mb": round(
            (rss[-1] - rss[1]) if len(rss) > 1 else 0.0, 1),
        "fds_first": fds[0] if fds else 0,
        "fds_last": fds[-1] if fds else 0,
        "latency_drift_last_vs_first_quarter": round(drift, 3),
    }


def run_direct(service, n_requests, n_clients, seed_roll, seeded_frac):
    """Closed loop over the in-process service API. A failed request is
    COUNTED (songs/s over partial failures would read as healthy
    throughput) and ends its client thread."""
    lat, failed, lock = [], [0], threading.Lock()
    counter = [0]

    def client():
        while True:
            with lock:
                i = counter[0]
                if i >= n_requests:
                    return
                counter[0] += 1
            t0 = time.time()
            try:
                service.submit(seed=_seed_for(i, seed_roll, seeded_frac)
                               ).result(timeout=600)
            except Exception as e:
                with lock:
                    failed[0] += 1
                print(f"request failed: {e!r}", file=sys.stderr)
                return
            with lock:
                lat.append(time.time() - t0)

    t0 = time.time()
    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.time() - t0, lat, failed[0]


def serve_args(args, overrides):
    """The ``multinn_torch.serve`` arguments of this load test."""
    return serve_mod.parse_args(
        (["--config", args.config] if args.config else [])
        + ["--port", "0", "--batch", str(args.batch),
           "--n-steps", str(args.n_steps),
           "--max-wait-ms", str(args.max_wait_ms),
           "--pipeline-depth", str(args.pipeline_depth),
           "--transport", args.transport,
           "--seed-steps", str(args.seed_steps), "--device", args.device]
        + (["--run", args.run] if args.run else ["--fresh"])
        + overrides)


def run_http(args, overrides, n_requests, n_clients, seed_roll, seeded_frac):
    """Closed loop through multinn_torch.serve's ThreadingHTTPServer on
    localhost."""
    sargs, soverrides = serve_args(args, overrides)
    ready, box = threading.Event(), []
    t = threading.Thread(target=serve_mod.serve,
                         args=(sargs, soverrides, ready, box), daemon=True)
    t.start()
    if not ready.wait(timeout=1200):
        raise RuntimeError("server failed to start")
    httpd, service = box[0]
    port = httpd.server_port

    seed_b64 = None
    if seed_roll is not None:
        buf = io.BytesIO()
        np.savez_compressed(buf, roll=seed_roll)
        seed_b64 = base64.b64encode(buf.getvalue()).decode()

    bulk_n = max(1, args.bulk_n)
    lat, failed, lock = [], [0], threading.Lock()
    counter = [0]                              # SONGS claimed so far

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        while True:
            with lock:
                i = counter[0]
                if i >= n_requests:
                    conn.close()
                    return
                take = min(bulk_n, n_requests - i)
                counter[0] += take
            body = {"format": args.payload}
            if take > 1:
                body["n"] = take
            if seed_b64 is not None and (i % 100) < seeded_frac * 100:
                body["seed_b64"] = seed_b64
            t0 = time.time()
            try:
                conn.request("POST", "/generate", body=json.dumps(body))
                resp = conn.getresponse()
                resp.read()
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}")
            except Exception as e:
                with lock:
                    failed[0] += take
                print(f"request failed: {e!r}", file=sys.stderr)
                conn.close()
                return
            with lock:
                lat.extend([time.time() - t0] * take)

    t0 = time.time()
    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.time() - t0
    stats = service.stats()
    httpd.shutdown()
    t.join(timeout=60)           # serve() closes the server and the service
    return wall, lat, failed[0], stats


def main(argv=None) -> int:
    # `kill -USR1 <pid>` dumps every thread's stack to stderr (a closed-loop
    # HTTP run can look stuck while it waits on the service: the dump says
    # where)
    import faulthandler
    import signal as _signal
    if hasattr(_signal, "SIGUSR1"):
        faulthandler.register(_signal.SIGUSR1)
    args, overrides = parse_args(argv)
    if args.http and args.soak > 0:
        # refusing beats silently running a short closed-loop test labelled
        # as a soak: the leak check asked for would never run
        print("--soak drives the in-process service API; it is not "
              "implemented over --http", file=sys.stderr)
        return 2

    def seed_roll_of(cfg):
        if not (args.seed_steps > 0 and args.seeded_frac > 0):
            return None
        d = (cfg.model.n_pitches // 2 if cfg.data.encoding == "onset_hold"
             else cfg.model.n_pitches)
        rng = np.random.RandomState(0)
        return (rng.rand(args.seed_steps, cfg.model.n_tracks, d)
                < 0.05).astype(np.uint8)

    soak = None
    if args.http:
        from multinn_torch.utils import config as cfg_mod
        cfg = cfg_mod.load_run_config(args.run, args.config, overrides)
        wall, lat, failed, stats = run_http(
            args, overrides, args.requests, args.clients, seed_roll_of(cfg),
            args.seeded_frac)
        mode = "http"
    else:
        cfg, service = serve_mod.build_service(*serve_args(args, overrides))
        seed_roll = seed_roll_of(cfg)
        try:
            if args.soak > 0:
                wall, lat, failed, samples = run_soak(
                    service, args.soak, seed_roll, args.seeded_frac)
                soak = soak_report(lat, samples)
                mode = "soak"
            elif args.open_loop:
                wall, lat, failed = run_open_loop(
                    service, args.requests, seed_roll, args.seeded_frac)
                mode = "open-loop"
            else:
                wall, lat, failed = run_direct(
                    service, args.requests, args.clients, seed_roll,
                    args.seeded_frac)
                mode = "direct"
            stats = service.stats()
        finally:
            service.close()

    out = {
        "mode": mode,
        "config": cfg.name,
        "requests": args.requests,
        "clients": args.clients,
        "batch": stats["batch"],
        "n_steps": stats["n_steps"],
        "seeded_batches": stats.get("seeded_batches", 0),
        "wall_s": round(wall, 3),
        "songs_per_s": round(len(lat) / wall, 1),   # COMPLETED songs only
        "completed": len(lat),
        "failed": failed,
        "latency_ms": percentiles(lat),
        "padded_rows": stats["padded_rows"],
        "errors": stats["errors"],
    }
    if args.http and args.bulk_n > 1:
        out["bulk_n"] = args.bulk_n
    if soak is not None:
        out["soak"] = soak
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
