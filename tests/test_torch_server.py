"""The port's serving endpoint beside the JAX package's.

Both servers are started on loopback with the same stub models, and every
request of tests/test_server.py (plus the multipart route, the data URL,
the plain body, the 404s) is posted to both: status, CORS header and body
must be equal, apart from the request id and the time.  The
micro-batchers of both packages are driven with the same submits, the
port's engine behind its batcher is held against the JAX engine behind
the JAX batcher, and both services' warm-up and persistence are compared
on disk."""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from chessvision_tpu.serve import server as jax_server
from chessvision_tpu_torch import constants
from chessvision_tpu_torch.cv_types import BatchResult, BoardExtractionResult, ChessVisionResult, PositionResult
from chessvision_tpu_torch.serve import server as server_mod
from chessvision_tpu_torch.serve import webroot_server
from chessvision_tpu_torch.serve.server import _MicroBatcher, fen_2_json, serve
from tests.test_server import StubCV as JaxStubCV
from tests.test_server import StubEngine as JaxStubEngine
from tests.test_torch_engine import STUB_QUAD, _engines, _quad_logits, _start_position_logits

START_FEN = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR"


class StubCV:
    """process_image stub returning a fixed start position."""

    def __init__(self, found: bool = True):
        self.found = found

    def process_image(self, img, threshold=0.5, flip=False):
        probs = np.zeros((64, 13), np.float32)
        probs[:, constants.LABEL_INDICES["f"]] = 1.0
        board = BoardExtractionResult(
            probabilities=np.zeros((256, 256), np.float32),
            binary_mask=np.zeros((256, 256), np.uint8),
            quadrangle=np.zeros((4, 2), np.float32) if self.found else None,
            board_image=np.zeros((512, 512), np.uint8) if self.found else None,
        )
        position = None
        if self.found:
            position = PositionResult(
                fen=START_FEN,
                original_fen=START_FEN,
                model_probabilities=probs,
                squares=np.zeros((64, 64, 64, 1), np.uint8),
                square_names=constants.SQUARE_NAMES_NORMAL,
                validation_fixes=[],
            )
        return ChessVisionResult(board_extraction=board, position=position, processing_time=0.01)


class StubEngine:
    """Counts process_batch calls; slow enough that concurrent requests
    pile up behind the first and get coalesced."""

    def __init__(self):
        self.calls: list[int] = []

    def process_batch(self, imgs, threshold=0.5, flip=False, lite=False, include_board=False):
        self.calls.append(len(imgs))
        time.sleep(0.25)
        b = len(imgs)
        probs = np.zeros((b, 64, 13), np.float32)
        probs[:, :, constants.LABEL_INDICES["f"]] = 1.0
        board_hw = (512, 512) if include_board else (0, 0)
        return BatchResult(
            logits=np.zeros((b, 0, 0), np.float32),
            binary_mask=np.zeros((b, 0, 0), np.uint8),
            quadrangle=np.zeros((b, 4, 2), np.float32),
            board_found=np.ones(b, bool),
            board_image=np.full((b, *board_hw), 7, np.uint8),
            probabilities=probs,
            fens=["8/8/8/8/8/8/8/8"] * b,
            original_fens=["8/8/8/8/8/8/8/8"] * b,
            validation_fixes=[[] for _ in range(b)],
        )


class EngineCV:
    def __init__(self, engine) -> None:
        self.engine = engine


def _serve_in_thread(mod=server_mod, **kwargs):
    server = mod.serve(port=0, **kwargs)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _stop(*servers) -> None:
    for server in servers:
        server.shutdown()
        server.server_close()


def _serve_both(tmp_path, port_model, jax_model, local: bool = True):
    """The port's server and the JAX package's, each with its own uploads
    folder under ``tmp_path``: (servers, {"port": n, "jax": n})."""
    ours, port = _serve_in_thread(local=local, cv_model=port_model, upload_root=str(tmp_path / "port"))
    theirs, jport = _serve_in_thread(jax_server, local=local, cv_model=jax_model, upload_root=str(tmp_path / "jax"))
    return (ours, theirs), {"port": port, "jax": jport}


@pytest.fixture(scope="module")
def ports(tmp_path_factory):
    servers, ports = _serve_both(tmp_path_factory.mktemp("uploads"), StubCV(), JaxStubCV())
    yield ports
    _stop(*servers)


@pytest.fixture(scope="module")
def server_port(ports) -> int:
    return ports["port"]


def _request(port: int, path: str, data: bytes | None, ctype: str = "application/json"):
    """(status, body, headers) of a POST, or of a GET where ``data`` is None."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _stable(body: dict) -> dict:
    """A response body without what differs from one request to the next."""
    return {k: v for k, v in body.items() if k not in ("id", "processing_time")}


def _both(ports: dict, path: str, data: bytes | None, ctype: str = "application/json"):
    """The same request to both servers: equal status, CORS header and
    body; returns the port's (status, body, headers)."""
    got = _request(ports["port"], path, data, ctype)
    want = _request(ports["jax"], path, data, ctype)
    assert got[0] == want[0]
    assert _stable(got[1]) == _stable(want[1])
    assert set(got[1]) == set(want[1])
    assert got[2]["Access-Control-Allow-Origin"] == want[2]["Access-Control-Allow-Origin"] == "*"
    assert got[2]["Content-Type"] == want[2]["Content-Type"]
    return got


def _post_both(ports: dict, path: str, payload: dict):
    status, body, _ = _both(ports, path, json.dumps(payload).encode())
    return status, body


def _post(port: int, path: str, payload: dict):
    status, body, _ = _request(port, path, json.dumps(payload).encode())
    return status, body


def _ppm(img_bgr: np.ndarray) -> bytes:
    h, w = img_bgr.shape[:2]
    return f"P6\n{w} {h}\n255\n".encode() + img_bgr[:, :, ::-1].tobytes()


def _image_b64(fmt: str = ".jpg", shape=(64, 64, 3)) -> str:
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    if fmt == ".ppm":
        return base64.b64encode(_ppm(img)).decode()
    import cv2

    ok, buf = cv2.imencode(fmt, img)
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def _concurrent_posts(port: int, payload: dict, n: int) -> list[dict]:
    results: list[dict] = []
    data = json.dumps(payload).encode()

    def post():
        results.append(_request(port, "/cv_algo/", data)[1])

    threads = [threading.Thread(target=post) for _ in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    return results


# -- the cases of tests/test_server.py ---------------------------------------------------


def test_ping(ports) -> None:
    status, body, _ = _both(ports, "/ping", None)
    assert (status, body) == (200, {"status": "ok"})
    status, body, _ = _both(ports, "/ping/", None)
    assert status == 200
    status, body, _ = _both(ports, "/nothing", None)
    assert (status, body) == (404, {"error": "not found"})
    status, body, _ = _both(ports, "/nothing", b"{}")
    assert status == 404


@pytest.mark.parametrize("fmt", [".jpg", ".png", ".ppm"])
def test_cv_algo_success(ports, fmt) -> None:
    status, body = _post_both(ports, "/cv_algo/", {"image": _image_b64(fmt)})
    assert status == 200
    assert body["success"] is True
    assert body["FEN"] == body["fen"] == START_FEN
    assert len(body["confidence_scores"]) == 64
    assert body["position"]["a1"] == "R"
    assert body["position"]["e8"] == "k"
    assert "e4" not in body["position"]
    assert body["processing_time"] > 0


def test_cv_algo_data_url_and_plain_body(ports) -> None:
    status, body = _post_both(ports, "/cv_algo/", {"image": "data:image/png;base64," + _image_b64(".png"), "flip": True})
    assert status == 200 and body["fen"] == START_FEN
    status, body, _ = _both(ports, "/cv_algo/", _image_b64(".ppm").encode(), "text/plain")
    assert status == 200 and body["fen"] == START_FEN


def test_cv_algo_missing_image(ports) -> None:
    status, body = _post_both(ports, "/cv_algo/", {})
    assert status == 400
    assert body["success"] is False


@pytest.mark.parametrize("junk", [b"junk", b"", b"\xff\xd8\xff\xe0 a cut JPEG", b"P6\n4 4\n255\n cut"], ids=repr)
def test_cv_algo_invalid_image(ports, junk) -> None:
    status, body = _post_both(ports, "/cv_algo/", {"image": base64.b64encode(junk).decode()})
    assert status == 400
    assert "Invalid image" in body["error"]


def test_cv_algo_malformed_json_is_a_500_on_both(ports) -> None:
    status, body, _ = _both(ports, "/cv_algo/", b"{not json")
    assert status == 500 and body["success"] is False


def test_classify_image_multipart(ports) -> None:
    boundary = "----testboundary42"
    img = _ppm(np.random.default_rng(1).integers(0, 256, (32, 48, 3), np.uint8))
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; name="flip"\r\n\r\ntrue\r\n'
        f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="b.ppm"\r\n'
        "Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + img + f"\r\n--{boundary}--\r\n".encode()
    ctype = f"multipart/form-data; boundary={boundary}"
    status, resp, _ = _both(ports, "/classify_image", body, ctype)
    assert status == 200 and resp["fen"] == START_FEN
    assert server_mod._parse_multipart(body, ctype) == jax_server._parse_multipart(body, ctype)
    assert server_mod._parse_multipart(body, ctype)[1] is True
    status, resp, _ = _both(ports, "/classify_image", b"", "multipart/form-data")
    assert status == 400 and resp["error"] == "No file part"
    junk = body.replace(img, b"junk")
    status, resp, _ = _both(ports, "/classify_image", junk, ctype)
    assert status == 400 and "Invalid image" in resp["error"]


def test_feedback_roundtrip(ports) -> None:
    status, body = _post_both(ports, "/feedback/", {"id": "test-123", "position": {"a1": "R"}, "flip": False})
    assert status == 200 and body["success"]
    status, body = _post_both(ports, "/feedback/", {"position": {}})
    assert status == 400


def test_feedback_is_written_under_a_server_made_name(tmp_path) -> None:
    entries = {}
    for name, mod, stub in (("port", server_mod, StubCV()), ("jax", jax_server, JaxStubCV())):
        root = tmp_path / name
        service = mod.ChessVisionService(local=True, cv_model=stub, upload_root=str(root))
        status, _ = service.feedback({"id": "../../escape", "position": {"e4": "P"}, "flip": True})
        assert status == 200
        (path,) = (root / "feedback").glob("*.json")
        assert "escape" not in path.name
        entries[name] = json.loads(path.read_text())
        entries[name].pop("timestamp")
        assert sorted(p.name for p in (root / "squares").iterdir()) == sorted(
            ["B", "K", "N", "P", "Q", "R", "_b", "_k", "_n", "_p", "_q", "_r", "f"]
        )
        mod.clean_uploads_folder(root)
        assert not list((root / "feedback").glob("*.json")) and (root / "raw").is_dir()
    assert entries["port"] == entries["jax"] == {"id": "../../escape", "position": {"e4": "P"}, "flip": True}


def test_fen_2_json() -> None:
    pos = fen_2_json(START_FEN)
    assert pos["a8"] == "r" and pos["h1"] == "R" and pos["e2"] == "P"
    assert len(pos) == 32
    assert pos == jax_server.fen_2_json(START_FEN)


def test_no_board_detected(tmp_path) -> None:
    servers, both = _serve_both(tmp_path, StubCV(found=False), JaxStubCV(found=False))
    try:
        status, body = _post_both(both, "/cv_algo/", {"image": _image_b64(".ppm")})
        assert status == 400
        assert body["error"] == "No chessboard detected"
    finally:
        _stop(*servers)


@pytest.mark.parametrize("local", [True, False], ids=["local", "persisting"])
def test_microbatcher_coalesces_concurrent_requests(tmp_path, local) -> None:
    """N simultaneous uploads become far fewer engine batches, each padded
    to a power of two, on both servers; the answers are equal."""
    models = {"port": EngineCV(StubEngine()), "jax": EngineCV(JaxStubEngine())}
    servers, both = _serve_both(tmp_path, models["port"], models["jax"], local=local)
    try:
        n = 8
        answers = {}
        for name, port in both.items():
            results = _concurrent_posts(port, {"image": _image_b64(".jpg"), "flip": False}, n)
            assert len(results) == n and all(r["success"] for r in results)
            calls = models[name].engine.calls
            assert len(calls) < n, f"{name}: no coalescing happened: {calls}"
            assert max(calls) > 1, f"{name}: never batched: {calls}"
            assert all(c & (c - 1) == 0 for c in calls), (name, calls)
            answers[name] = [_stable(r) for r in results]
        assert answers["port"] == answers["jax"]
        assert answers["port"][0]["fen"] == "8/8/8/8/8/8/8/8"
    finally:
        _stop(*servers)


def test_a_burst_of_connections_is_not_refused(server_port) -> None:
    """48 clients connecting at once all get their answer: the listen
    backlog is larger than socketserver's default of 5."""
    results = _concurrent_posts(server_port, {"image": _image_b64(".ppm")}, 48)
    assert len(results) == 48 and all(r["success"] for r in results)


def test_production_mode_batches_and_persists(tmp_path) -> None:
    """local=False rides the same micro-batched engine path and persists
    raw + board uploads asynchronously: the files of both servers are equal."""
    import cv2

    models = {"port": EngineCV(StubEngine()), "jax": EngineCV(JaxStubEngine())}
    servers, both = _serve_both(tmp_path, models["port"], models["jax"], local=False)
    try:
        n = 8
        written = {}
        for name, port in both.items():
            results = _concurrent_posts(port, {"image": _image_b64(".jpg"), "flip": False}, n)
            assert len(results) == n and all(r["success"] for r in results)
            calls = models[name].engine.calls
            assert len(calls) < n, f"{name}: prod mode didn't micro-batch: {calls}"
            assert max(calls) > 1, f"{name}: prod mode never batched: {calls}"
            root = tmp_path / name
            deadline = time.time() + 10
            while time.time() < deadline:
                raws = sorted((root / "raw").glob("*.JPG"))
                boards = sorted((root / "boards").glob("*.JPG"))
                if len(raws) == n and len(boards) == n:
                    break
                time.sleep(0.05)
            assert len(raws) == n, f"{name}: raw uploads not persisted: {len(raws)}/{n}"
            assert len(boards) == n, f"{name}: boards not persisted: {len(boards)}/{n}"
            assert {p.stem for p in raws} == {p.stem for p in boards} == {r["id"] for r in results}
            time.sleep(0.2)  # the last file may still be being written
            written[name] = (cv2.imread(str(raws[0])), cv2.imread(str(boards[0]), cv2.IMREAD_GRAYSCALE))
        board = written["port"][1]
        assert board is not None and board.shape == (512, 512) and board[0, 0] == 7
        np.testing.assert_array_equal(written["port"][0], written["jax"][0])
        np.testing.assert_array_equal(board, written["jax"][1])
    finally:
        _stop(*servers)


# -- the port's own engine behind the batcher ------------------------------------------------


def test_microbatcher_on_the_ports_engine_pads_and_returns_boards() -> None:
    """3 concurrent submits of 256² frames become one padded batch of 4 on
    the port's engine; FEN, confidences and boards are process_batch's, and
    those of the JAX batcher on the JAX engine for the same frames."""
    engine, ref = _engines(_quad_logits(STUB_QUAD), _start_position_logits())
    seen: list[int] = []
    real = engine.process_batch
    release = threading.Event()

    def counting(imgs, **kw):
        seen.append(len(imgs))
        if len(seen) == 1:  # the gate item holds the worker until the three are queued
            release.wait(60)
        return real(imgs, **kw)

    engine.process_batch = counting
    blocks = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), np.uint8)
    frames = np.kron(blocks, np.ones((1, 8, 8, 1), np.uint8))  # 256² frames of 8×8 blocks
    want = real(frames, lite=True, include_board=True)
    batcher = _MicroBatcher(engine, include_board=True, timeout_s=300.0)
    gate = threading.Event()
    batcher.q.put((frames[0], True, gate, {}))
    deadline = time.time() + 60
    while not seen and time.time() < deadline:  # the worker holds the gate item; the queue is empty
        time.sleep(0.01)
    out: dict[int, tuple] = {}
    threads = [threading.Thread(target=lambda i=i: out.update({i: batcher.submit(frames[i], False)})) for i in range(3)]
    for th in threads:
        th.start()
    while batcher.q.qsize() < 3 and time.time() < deadline:
        time.sleep(0.01)
    release.set()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads) and gate.is_set()
    assert sorted(out) == [0, 1, 2]
    assert seen == [1, 4], seen
    jax_batcher = jax_server._MicroBatcher(ref, include_board=True, timeout_s=300.0)
    for i in range(3):
        found, fen, conf, board = out[i]
        assert found and fen == want.fens[i] == START_FEN
        np.testing.assert_array_equal(conf, want.probabilities[i].max(axis=1))
        np.testing.assert_array_equal(board, want.board_image[i])
        jfound, jfen, jconf, jboard = jax_batcher.submit(frames[i], False)  # one at a time: batches of 1
        assert (found, fen) == (jfound, jfen)
        np.testing.assert_allclose(conf, jconf, atol=1e-5)
        # the two frameworks round the float32 homography differently in
        # the last bits: 1 gray level on under 0.1% of pixels
        diff = np.abs(board.astype(int) - jboard.astype(int))
        assert board.shape == jboard.shape and diff.max() <= 1 and np.mean(diff == 0) >= 0.999


@pytest.mark.parametrize("mod", [server_mod, jax_server], ids=["port", "jax"])
def test_microbatcher_reports_engine_errors_and_full_queue(mod) -> None:
    """The same faults give the same exceptions from both packages' batchers."""

    class Failing:
        def process_batch(self, imgs, **kw):
            raise RuntimeError("device fell over")

    batcher = mod._MicroBatcher(Failing(), timeout_s=30.0)
    with pytest.raises(RuntimeError, match="device fell over"):
        batcher.submit(np.zeros((8, 8, 3), np.uint8), False)
    with pytest.raises(RuntimeError, match="device fell over"):  # the worker outlived the failure
        batcher.submit(np.zeros((8, 8, 3), np.uint8), True)

    class Wedged:
        def __init__(self):
            self.release = threading.Event()

        def process_batch(self, imgs, **kw):
            self.release.wait(60)
            raise RuntimeError("released")

    wedged = Wedged()
    batcher = mod._MicroBatcher(wedged, max_batch=1, timeout_s=0.2)
    with pytest.raises(TimeoutError, match="did not answer within 0s"):
        batcher.submit(np.zeros((8, 8, 3), np.uint8), False)
    for _ in range(batcher.q.maxsize):
        batcher.q.put_nowait((np.zeros((1, 1, 3), np.uint8), False, threading.Event(), {}))
    with pytest.raises(TimeoutError, match="queue full"):
        batcher.submit(np.zeros((8, 8, 3), np.uint8), False)
    wedged.release.set()


def test_a_wedged_batcher_answers_503_on_both(tmp_path) -> None:
    class Wedged:
        def process_batch(self, imgs, **kw):
            time.sleep(1.0)
            raise RuntimeError("too late")

    servers, both = [], {}
    try:
        for name, mod in (("port", server_mod), ("jax", jax_server)):
            service = mod.ChessVisionService(local=True, cv_model=EngineCV(Wedged()), upload_root=str(tmp_path / name))
            service.batcher.timeout_s = 0.1
            server = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(service))
            threading.Thread(target=server.serve_forever, daemon=True).start()
            servers.append(server)
            both[name] = server.server_address[1]
        status, body = _post_both(both, "/cv_algo/", {"image": _image_b64(".ppm")})
        assert status == 503 and "did not answer" in body["error"]
    finally:
        _stop(*servers)


def test_warmup_visits_every_power_of_two_batch(tmp_path) -> None:
    calls = {}
    for name, mod, engine in (("port", server_mod, StubEngine()), ("jax", jax_server, JaxStubEngine())):
        service = mod.ChessVisionService(local=False, cv_model=EngineCV(engine), upload_root=str(tmp_path / name))
        service.warmup(image_hw=(16, 16))
        calls[name] = engine.calls
    assert calls["port"] == calls["jax"] == [1, 2, 4, 8, 16]


def test_webroot_is_the_jax_packages_static_directory() -> None:
    assert webroot_server.WEBROOT == constants.REPO_ROOT / "chessvision_tpu" / "serve" / "webroot"
    assert (webroot_server.WEBROOT / "index.html").is_file()
