"""The port's serving entry point, ``multinn_torch.serve``, in-process on
the CPU (``--device cpu --fresh``, port 0):

* /healthz, /stats and /generate in every format (midi, roll,
  roll_packed), with n > 1, seeded (npz and MIDI) and accompaniment (npz
  and MIDI) requests; the served rolls equal the service's own generation
  under the batch's key;
* every status code the reference's handler returns (400, 404, 503, 504,
  500) and the three refusals of hostile payloads the port adds: 413 for
  a body over the cap (unread) and for an npz whose .npy header declares
  more cells than the payload limit (nothing allocated), 400 for a seed
  MIDI longer than the quantization cap;
* ``--transport sparse`` serves the rolls ``--transport packed`` serves;
* shutdown: ``httpd.shutdown()`` ends ``serve()`` with the service's
  threads joined, and SIGTERM drains a served process that exits 0.
"""

import base64
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multinn_torch import serve as serve_cli  # noqa: E402
from multinn_torch.data import midi, pianoroll  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import sampling  # noqa: E402
from multinn_torch.utils import config  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, D, T = 3, 16, 8
BASE = ["--fresh", "--device", "cpu", "--port", "0", "--batch", "2",
        "--max-wait-ms", "2"]


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    cfg = config.ExperimentConfig(
        name="serve-cli",
        model=multinn.MultINNConfig(n_tracks=K, n_pitches=D, n_hidden=8,
                                    n_rnn=6, gen_k=2, w_std=0.5),
        data=config.DataConfig(n_tracks=K, pitch_min=40,
                               pitch_max=40 + D - 1),
        generate=config.GenerateConfig(n_steps=T))
    path = str(tmp_path_factory.mktemp("serve") / "cfg.json")
    config.save_json(cfg, path)
    return path


class Server:
    """``serve()`` in a thread; ``post`` / ``get`` return (status, JSON)."""

    def __init__(self, argv):
        args, overrides = serve_cli.parse_args(argv)
        ready, self.box = threading.Event(), []
        self.thread = threading.Thread(
            target=serve_cli.serve, args=(args, overrides, ready, self.box),
            daemon=True)
        self.thread.start()
        assert ready.wait(timeout=120), "server failed to start"
        self.httpd, self.service = self.box[0]
        self.conn = http.client.HTTPConnection(
            "127.0.0.1", self.httpd.server_port, timeout=60)

    def request(self, method, path, body=None, headers=None):
        self.conn.request(method, path, body=body, headers=headers or {})
        resp = self.conn.getresponse()
        return resp.status, json.loads(resp.read())

    def post(self, payload):
        return self.request("POST", "/generate", json.dumps(payload))

    def stop(self):
        self.conn.close()
        self.httpd.shutdown()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()
        assert not self.service._dispatcher.is_alive()
        assert not self.service._drainer.is_alive()


@pytest.fixture(scope="module")
def server(cfg_path):
    srv = Server(["--config", cfg_path, *BASE, "--seed-steps", "4",
                  "--accompany-tracks", "0"])
    yield srv
    srv.stop()


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


def _npz(**arrays) -> str:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return _b64(buf.getvalue())


def _roll(out):
    with np.load(io.BytesIO(base64.b64decode(out["roll_b64"]))) as z:
        return z["roll"]


def _midi_b64(roll, spec):
    return _b64(midi.dumps(pianoroll.roll_to_midi(roll, spec)))


def test_every_format_and_request_kind(server):
    spec = server.service.cfg.data.spec()
    assert server.request("GET", "/healthz") == (
        200, {"ok": True, "batch": 2, "n_steps": T})
    status, out = server.post({"format": "roll", "n": 2})
    assert status == 200 and out["shape"] == [2, T, K, D]
    rolls = _roll(out)
    assert rolls.shape == (2, T, K, D) and set(np.unique(rolls)) <= {0, 1}
    # the rows of one batch: the service's generation under its batch key
    (bi,) = {p["batch"] for p in out["provenance"]}
    gen = server.service.generator
    want = gen.finalize(gen.generate(sampling.fold_in(
        sampling.PRNGKey(server.service.serve_cfg.seed), bi), T, batch=2))
    np.testing.assert_array_equal(rolls, want[[p["row"] for p in
                                              out["provenance"]]])
    status, out = server.post({"format": "roll_packed", "n": 3})
    with np.load(io.BytesIO(base64.b64decode(
            out["roll_packed_b64"]))) as z:
        packed = z["packed"]
    assert status == 200 and out["shape"] == [3, T, K, D]
    assert np.unpackbits(packed, axis=-1)[..., :D].shape == (3, T, K, D)
    assert len(out["provenance"]) == len(out["latency_ms"]) == 3
    status, out = server.post({"format": "midi", "bpm": 90})
    assert status == 200 and out["shape"] == [T, K, D]
    mid = midi.loads(base64.b64decode(out["midi_b64"]))
    assert abs(mid.bpm - 90.0) < 1e-3          # whole microseconds a beat
    status, out = server.post({"format": "midi", "n": 2})
    assert status == 200 and len(out["midi_b64"]) == 2
    seed = np.zeros((6, K, D), np.uint8)
    seed[:, 1, 3] = 1
    given = np.zeros((T, K, D), np.uint8)
    given[::2, 0, 7] = 1
    for payload in ({"seed_b64": _npz(roll=seed)},
                    {"seed_b64": _midi_b64(seed, spec)},
                    {"given_b64": _npz(roll=given), "n": 2},
                    {"given_b64": _midi_b64(given, spec)}):
        status, out = server.post(dict(payload, format="roll"))
        assert status == 200, out
        got = _roll(out)
        if "given_b64" in payload:       # the given track passes through
            rows = got if got.ndim == 4 else got[None]
            for r in rows:
                np.testing.assert_array_equal(r[:, 0], given[:, 0])
    status, st = server.request("GET", "/stats")
    assert status == 200 and st["errors"] == 0
    assert st["seeded_batches"] >= 2 and st["accompany_batches"] >= 2
    assert st["transport"] == "packed" and not st["transport_demoted"]


def test_bad_requests_get_the_reference_codes(server):
    assert server.request("GET", "/nope")[0] == 404
    assert server.request("POST", "/nope", b"{}")[0] == 404
    assert server.request("POST", "/generate", b"{not json")[0] == 400
    for bad in ({"format": "wav"}, {"bpm": "fast"}, {"n": 0},
                {"n": 1025}, {"n": 1.5}, {"seed_b64": "not-base64-npz!"},
                {"given_b64": _b64(b"\x00" * 40)},
                {"seed_b64": _npz(roll=np.zeros((4, K + 1, D)))},
                {"seed_b64": _npz(roll=np.zeros((4, K, D))),
                 "given_b64": _npz(roll=np.zeros((4, K, D)))}):
        status, out = server.post(bad)
        assert status == 400 and "error" in out, bad
    assert server.post({"n": 1})[0] == 200   # still serving


def test_hostile_payloads_are_refused_before_allocation(server):
    # an npz whose header claims 10^9 x K x D cells and holds none
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        with zf.open("roll.npy", "w") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "|u1", "fortran_order": False,
                "shape": (10 ** 9, K, D)})
    status, out = server.post({"seed_b64": _b64(buf.getvalue())})
    assert status == 413 and "cells" in out["error"]
    wide = np.zeros((2, 1), np.dtype("V16"))          # 16-byte cells
    assert server.post({"given_b64": _npz(roll=wide)})[0] == 413
    # a seed MIDI past the cap: its first 8192 steps are not its end
    long = midi.MidiFile(instruments=[midi.Instrument(program=0,
                                                      is_drum=False)])
    long.instruments[0].notes.append(midi.Note(60, 100, 0, 120 * 9000))
    status, out = server.post({"seed_b64": _b64(midi.dumps(long))})
    assert status == 400 and "longer" in out["error"]
    # a body over the cap is refused unread, and the connection closed
    conn = http.client.HTTPConnection("127.0.0.1",
                                      server.httpd.server_port, timeout=30)
    conn.putrequest("POST", "/generate")
    conn.putheader("Content-Length", str(serve_cli.MAX_BODY_BYTES + 1))
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413 and resp.getheader("Connection") == "close"
    resp.read()
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1",
                                      server.httpd.server_port, timeout=30)
    conn.putrequest("POST", "/generate")
    conn.putheader("Content-Length", "-4")
    conn.endheaders()
    assert conn.getresponse().status == 400
    conn.close()
    assert server.post({"n": 1})[0] == 200


def test_timeout_failure_and_closed_service_codes(cfg_path, monkeypatch):
    srv = Server(["--config", cfg_path, *BASE])
    try:
        handler = serve_cli.make_handler(srv.service.cfg, srv.service,
                                         timeout_s=0.0)
        from http.server import ThreadingHTTPServer
        quick = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        t = threading.Thread(target=quick.serve_forever, daemon=True)
        t.start()
        conn = http.client.HTTPConnection("127.0.0.1", quick.server_port,
                                          timeout=30)
        conn.request("POST", "/generate", json.dumps({"n": 4}))
        resp = conn.getresponse()
        assert resp.status == 504 and b"timed out" in resp.read()
        conn.close()
        quick.shutdown()
        quick.server_close()
        t.join(timeout=30)

        def broken(rolls):
            raise RuntimeError("decode failed")
        monkeypatch.setattr(srv.service.generator, "finalize", broken)
        status, out = srv.post({"n": 1})
        assert status == 500 and "decode failed" in out["error"]
        monkeypatch.undo()
        assert srv.post({"n": 1})[0] == 200
        srv.service.close()
        status, out = srv.post({"n": 1})
        assert status == 503 and "closed" in out["error"]
    finally:
        srv.stop()


def test_sparse_transport_serves_the_packed_rolls(cfg_path):
    rolls = {}
    for transport in ("packed", "sparse"):
        srv = Server(["--config", cfg_path, *BASE, "--transport", transport])
        try:
            status, out = srv.post({"format": "roll", "n": 2})
            assert status == 200
            rolls[transport] = _roll(out)
            assert srv.request("GET", "/stats")[1]["transport"] == transport
        finally:
            srv.stop()
    np.testing.assert_array_equal(rolls["sparse"], rolls["packed"])


def test_sigterm_drains_and_exits_0(cfg_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "multinn_torch.serve", "--config", cfg_path,
         *BASE], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving serve-cli on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        conn.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def test_missing_config_exits_2(tmp_path):
    assert serve_cli.main(["--run", str(tmp_path / "none"), "--device",
                           "cpu"]) == 2
