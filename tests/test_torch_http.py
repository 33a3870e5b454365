"""The port's network tier on the CPU: the HTTP front end over the
in-process server, the retrying client, and one worker pool of ``gmm serve
--http 0 --workers 2 --device cpu`` processes.

The routing grammar and the error-to-status taxonomy are the JAX
package's, entry for entry; answers over HTTP (JSON bodies and x-gmm-rows
frames) carry the in-process server's bits; a worker SIGKILLed mid-stream
costs no client request, and SIGTERM drains the pool to exit 75.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.serving import http as jhttp
from cuda_gmm_mpi_tpu_torch import GaussianMixture
from cuda_gmm_mpi_tpu_torch.serving import (GMMClient, GMMClientError,
                                            GMMServer, HTTPFrontEnd,
                                            InprocBackend, ModelRegistry)
from cuda_gmm_mpi_tpu_torch.serving import http as thttp
from cuda_gmm_mpi_tpu_torch.serving import wire
from cuda_gmm_mpi_tpu_torch.telemetry import read_stream
from cuda_gmm_mpi_tpu_torch.telemetry.schema import validate_stream

from .conftest import communicate_or_kill, make_blobs


@pytest.fixture(scope="module")
def model():
    data, _ = make_blobs(np.random.default_rng(1234), n=600, d=4, k=3)
    data = data.astype(np.float32)
    gm = GaussianMixture(3, target_components=3, min_iters=4, max_iters=4,
                         chunk_size=256, device="cpu").fit(data)
    return gm, data


def _post(port, path, body, headers=None, timeout=60.0):
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = (body if isinstance(body, (bytes, bytearray))
                else json.dumps(body).encode("utf-8"))
        conn.request("POST", path, data,
                     {"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        raw = r.read()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        try:
            return r.status, hdrs, json.loads(raw)
        except ValueError:
            return r.status, hdrs, raw
    finally:
        conn.close()


def _get(port, path, timeout=60.0):
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


def test_routing_grammar_and_status_taxonomy_match_jax():
    paths = ["/v1/models/m:predict", "/v1/models/m@3:score_samples",
             "/v1/models/blobs-v2@12:predict_proba", "/v1/models/m:score",
             "/v1/models/m:frobnicate", "/v1/models/m", "/healthz",
             "/v1/models/:predict", "/v2/models/m:predict",
             "/v1/models/m@x:predict", "/v1/models/m@:predict", ""]
    for p in paths:
        assert thttp.parse_model_path(p) == jhttp.parse_model_path(p), p
    tokens = ["overloaded", "shutting_down", "deadline_expired",
              "http_timeout", "circuit_open", "non_finite_scores",
              "bad_request", "bad_frame", "frame_too_large", "bad_json",
              "line_too_long", "unknown model 'x'", "worker_unavailable",
              "something else"]
    for t in tokens:
        assert thttp.status_for_error(t) == jhttp.status_for_error(t), t
    assert thttp.HTTP_OPS == jhttp.HTTP_OPS


@pytest.fixture
def inproc(model, tmp_path):
    gm, data = model
    reg_dir = str(tmp_path / "reg")
    gm.to_registry(reg_dir, "m")
    server = GMMServer(ModelRegistry(reg_dir), device="cpu")
    t = threading.Thread(target=server.run_loop, daemon=True)
    t.start()
    front = HTTPFrontEnd(InprocBackend(server)).start()
    try:
        yield front, server, gm, data
    finally:
        front.stop()
        server._stop.set()
        t.join(timeout=60)
        assert not t.is_alive()


def test_http_answers_carry_the_in_process_bits(inproc):
    """JSON bodies and x-gmm-rows frames over HTTP give the in-process
    server's results for every op; the trace id is echoed; the client
    speaks the same dialect."""
    front, server, gm, data = inproc
    port = front.port
    x = data[:17]
    for op in ("predict", "predict_proba", "score_samples", "score"):
        want = server.handle_requests([{"id": 0, "model": "m", "op": op,
                                        "x": x.tolist()}])[0]["result"]
        st, hdrs, body = _post(port, f"/v1/models/m:{op}", {"x": x.tolist()},
                               headers={"X-GMM-Trace-Id": "t-abc123"})
        assert st == 200 and body["result"] == want, body
        assert hdrs.get("x-gmm-trace-id") == "t-abc123"
        st, _, body = _post(port, f"/v1/models/m@1:{op}",
                            wire.encode_rows(x.astype(np.float64)),
                            headers={"Content-Type": wire.CONTENT_TYPE})
        assert st == 200 and body["result"] == want and body["version"] == 1
    np.testing.assert_allclose(GMMClient(f"127.0.0.1:{port}").score_samples(
        "m", x.tolist()), gm.score_samples(x), rtol=1e-6)


def test_http_errors_map_to_statuses(inproc):
    front, server, _, data = inproc
    port = front.port
    x = data[:4].tolist()
    st, _, body = _post(port, "/v1/models/ghost:predict", {"x": x})
    assert st == 404 and "unknown model" in body["error"]
    assert _post(port, "/v1/models/m:frobnicate", {"x": x})[0] == 404
    st, _, body = _post(port, "/v1/models/m:predict", b"{not json")
    assert st == 400 and body["error"] == "bad_json"
    st, _, body = _post(port, "/v1/models/m:predict", {"x": x},
                        headers={"X-GMM-Deadline-Ms": "banana"})
    assert st == 400 and body["error"] == "bad_deadline"
    st, _, body = _post(port, "/v1/models/m:predict",
                        b"GMR1" + b"\x00" * 3,
                        headers={"Content-Type": wire.CONTENT_TYPE})
    assert st == 400 and body["error"] == "bad_frame"
    st, _, body = _post(port, "/v1/models/m:score", {"x": x},
                        headers={"X-GMM-Deadline-Ms": "0.0001"})
    assert st == 504 and body["error"] in ("deadline_expired",
                                           "http_timeout")
    conn = HTTPConnection("127.0.0.1", port, timeout=30.0)
    try:
        conn.putrequest("POST", "/v1/models/m:predict",
                        skip_accept_encoding=True)
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        conn.send(b"0\r\n\r\n")
        assert conn.getresponse().status == 411
    finally:
        conn.close()
    assert front.errors_4xx >= 5 and front.errors_5xx == 1  # the 504


def test_http_probes_metrics_and_drain_flip(inproc):
    front, server, _, _ = inproc
    port = front.port
    assert _get(port, "/healthz")[0] == 200
    assert _get(port, "/readyz")[0] == 200
    st, hdrs, payload = _get(port, "/metrics")
    text = payload.decode("utf-8")
    assert st == 200 and "openmetrics" in hdrs["content-type"]
    assert "gmm_http_connections" in text and text.rstrip().endswith("# EOF")
    server.begin_drain("test")
    st, hdrs, _ = _get(port, "/readyz")
    assert st == 503 and int(hdrs["retry-after"]) >= 1
    assert _get(port, "/healthz")[0] == 200


def test_http_body_bound_and_connection_cap(model, tmp_path):
    gm, data = model
    reg_dir = str(tmp_path / "reg")
    gm.to_registry(reg_dir, "m")
    server = GMMServer(ModelRegistry(reg_dir), device="cpu")
    t = threading.Thread(target=server.run_loop, daemon=True)
    t.start()
    front = HTTPFrontEnd(InprocBackend(server), max_body_bytes=2048,
                         max_connections=1).start()
    try:
        port = front.port
        st, hdrs, body = _post(port, "/v1/models/m:score_samples",
                               {"x": data[:400].tolist()})
        assert st == 413 and not body["ok"]
        hog = socket.create_connection(("127.0.0.1", port), timeout=30)
        try:
            time.sleep(0.1)
            st, hdrs, _ = _get(port, "/readyz")
            assert st == 503 and int(hdrs["retry-after"]) >= 1
        finally:
            hog.close()
        assert front.shed_connections >= 1
        deadline = time.monotonic() + 30
        while True:
            st, _, body = _post(port, "/v1/models/m:score",
                                {"x": data[:4].tolist()})
            if st == 200 or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        assert st == 200 and body["ok"]
    finally:
        front.stop()
        server._stop.set()
        t.join(timeout=60)


# ---------------------------------------------------------------- client

class _Script:
    def __init__(self, plays):
        self.plays = list(plays)
        self.seen = []
        self.lock = threading.Lock()
        self.stall_first_s = 0.0

    def next_play(self):
        with self.lock:
            return self.plays.pop(0) if len(self.plays) > 1 \
                else self.plays[0]


@pytest.fixture
def stub():
    script = _Script([(200, {"ok": True, "result": 1.0})])

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            with script.lock:
                first = not script.seen
                script.seen.append(
                    {"path": self.path,
                     "deadline": self.headers.get("X-GMM-Deadline-Ms")})
            if first and script.stall_first_s:
                time.sleep(script.stall_first_s)
            status, body = script.next_play()
            payload = json.dumps(body).encode("utf-8")
            self.send_response(status)
            if status in (429, 503):
                self.send_header("Retry-After", "0")
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield script, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def test_client_retries_transient_503_then_succeeds(stub):
    script, port = stub
    script.plays = [(503, {"ok": False, "error": "shutting_down"}),
                    (503, {"ok": False, "error": "shutting_down"}),
                    (200, {"ok": True, "result": [1.0, 2.0]})]
    client = GMMClient(f"127.0.0.1:{port}", retries=4, backoff_base_s=0.01)
    assert client.score_samples("m", [[0.0]]) == [1.0, 2.0]
    s = client.stats()
    assert (s["requests"], s["retries"], s["budget_denied"]) == (1, 2, 0)
    assert len(script.seen) == 3


def test_client_retry_budget_and_non_retryable_statuses(stub):
    script, port = stub
    script.plays = [(503, {"ok": False, "error": "shutting_down"})]
    client = GMMClient(f"127.0.0.1:{port}", retries=10, backoff_base_s=0.01,
                       retry_budget=0.0)
    with pytest.raises(GMMClientError, match="retry budget"):
        client.request("m", "score", [[0.0]])
    assert client.stats()["retries"] == 2 and len(script.seen) == 3
    script.plays = [(404, {"ok": False, "error": "unknown model 'x'"})]
    script.seen.clear()
    client = GMMClient(f"127.0.0.1:{port}", retries=5)
    with pytest.raises(GMMClientError, match="unknown model"):
        client.predict("x", [[0.0]])
    assert client.stats()["retries"] == 0 and len(script.seen) == 1


def test_client_deadline_version_and_hedge(stub):
    script, port = stub
    script.plays = [(200, {"ok": True, "result": [0]})]
    GMMClient(f"127.0.0.1:{port}").predict("m", [[0.0]], version=3,
                                           deadline_ms=5000)
    assert script.seen[0]["path"] == "/v1/models/m@3:predict"
    assert 0 < float(script.seen[0]["deadline"]) <= 5000
    script.seen.clear()
    script.plays = [(503, {"ok": False, "error": "shutting_down"})]
    client = GMMClient(f"127.0.0.1:{port}", retries=50, backoff_base_s=0.05,
                       retry_budget=1.0)
    with pytest.raises(GMMClientError, match="deadline"):
        client.score("m", [[0.0]], deadline_ms=150)
    script.seen.clear()
    script.plays = [(200, {"ok": True, "result": 7.0})]
    script.stall_first_s = 1.0
    client = GMMClient(f"127.0.0.1:{port}", hedge_ms=100, timeout_s=30.0)
    assert client.score("m", [[0.0]]) == 7.0
    assert client.stats()["hedge_wins"] == 1 and len(script.seen) == 2


# ---------------------------------------------------------------- pool

def _worker_doc(wd, idx, not_pid=None, timeout=120.0):
    path = os.path.join(wd, f"worker{idx}.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            doc = json.loads(open(path).read())
            if int(doc["pid"]) != (not_pid or -1):
                return doc
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"worker{idx}.json never moved past pid {not_pid}")


def test_pool_survives_sigkill_and_drains_to_75(model, tmp_path):
    """``gmm serve --http 0 --workers 2 --device cpu`` (the port's CLI in
    every process): SIGKILL a worker mid-stream, zero client failures,
    the slot respawns, SIGTERM drains the tier to exit 75 with a valid
    stream."""
    gm, data = model
    reg_dir = str(tmp_path / "reg")
    gm.to_registry(reg_dir, "m")
    port_file, wd = str(tmp_path / "port"), str(tmp_path / "wd")
    metrics = str(tmp_path / "serve.jsonl")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(
        [sys.executable, "-m", "cuda_gmm_mpi_tpu_torch.cli", "serve",
         "--registry", reg_dir, "--http", "0", "--workers", "2",
         "--http-port-file", port_file, "--worker-dir", wd,
         "--worker-backoff-s", "0.2", "--device", "cpu",
         "--metrics-file", metrics],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
    err = ""
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(port_file):
            assert p.poll() is None, p.communicate()
            assert time.monotonic() < deadline, "http port never bound"
            time.sleep(0.05)
        port = int(open(port_file).read().strip())
        client = GMMClient(f"127.0.0.1:{port}", timeout_s=120.0, retries=3,
                           backoff_base_s=0.05, retry_budget=1.0)
        victim = int(_worker_doc(wd, 0)["pid"])
        failed = 0
        for i in range(16):
            if i == 4:
                os.kill(victim, signal.SIGKILL)
            try:
                got = client.score_samples("m", data[:5].tolist(),
                                           deadline_ms=60_000)
                assert len(got) == 5
                got = client.request("m", "predict", data[:5],
                                     encoding="binary")["result"]
                assert got == gm.predict(data[:5]).tolist()
            except GMMClientError:
                failed += 1
        assert failed == 0
        doc = _worker_doc(wd, 0, not_pid=victim)
        assert doc["gen"] >= 1
        p.send_signal(signal.SIGTERM)
        _, err = communicate_or_kill(p, timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)
    assert p.returncode == 75, err
    assert "Preempted" in err
    records = read_stream(metrics)
    assert validate_stream(records) == []
    roll = [r for r in records if r["event"] == "serve_summary"][-1]["http"]
    assert roll["errors_5xx"] == 0 and roll["worker_crashes"] >= 1
    assert roll["worker_respawns"] >= 1
