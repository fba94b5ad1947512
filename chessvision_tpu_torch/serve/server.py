"""Compute-node inference server of the PyTorch port.

Counterpart of ``chessvision_tpu/serve/server.py`` on the stdlib HTTP
server, with the same routes and request/response contracts:

  POST /cv_algo/        base64-JSON image → {fen, position,
                        confidence_scores, processing_time} + CORS
  POST /classify_image  multipart variant
  POST /feedback/       persists user corrections as JSON
  GET  /ping            liveness probe

Uploads are persisted under user_uploads/{raw,boards} when not in local
mode, asynchronously off a bounded queue, so production requests ride the
same micro-batched engine path as local mode (``process_batch`` with
``lite=True, include_board=True`` returns the extracted board without the
logits buffer).  The models are loaded at startup, on the GPU.

Run: python -m chessvision_tpu_torch.serve.server --port 7777 [--local]
"""

from __future__ import annotations

import argparse
import base64
import datetime
import json
import logging
import os
import queue
import re
import shutil
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any

import numpy as np

from chessvision_tpu_torch.chessboard import expand_fen

logger = logging.getLogger(__name__)


def fen_2_json(fen: str) -> dict[str, str]:
    """Per-square piece map for the web client."""
    expanded = expand_fen(fen)
    out: dict[str, str] = {}
    i = 0
    for rank in range(8, 0, -1):
        for file in "abcdefgh":
            piece = expanded[i]
            i += 1
            if piece != ".":
                out[f"{file}{rank}"] = piece
    return out


def init_uploads_folder(root: str | Path) -> Path:
    """Create the uploads tree incl. the 13 per-class square dirs ('_x'
    names for black pieces, to survive case-insensitive filesystems)."""
    root = Path(root)
    for sub in ("raw", "boards", "feedback"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for label in ("B", "K", "N", "P", "Q", "R", "_b", "_k", "_n", "_p", "_q", "_r", "f"):
        (root / "squares" / label).mkdir(parents=True, exist_ok=True)
    return root


def clean_uploads_folder(root: str | Path) -> None:
    """Purge and recreate the uploads tree."""
    root = Path(root)
    if root.exists():
        shutil.rmtree(root)
    init_uploads_folder(root)


class _MicroBatcher:
    """Coalesces concurrent requests into one engine batch.

    The engine is batched end to end, so N simultaneous uploads cost one
    pipeline call instead of N serialized B=1 calls (measured rates:
    PERF.md).  A worker thread drains whatever is queued (no added latency
    when idle: the first request is processed at once), groups by
    (flip, shape), and pads each group to the next power of two, so the
    engine only ever sees log2(cap) + 1 batch sizes: cuDNN picks its
    algorithms and the allocator settles its blocks per shape, and
    ``ChessVisionService.warmup`` can visit them all before traffic.  The
    worker is the only thread that calls the engine."""

    def __init__(
        self,
        engine: Any,
        max_batch: int = 16,
        timeout_s: float = 900.0,
        include_board: bool = False,
    ) -> None:
        self.engine = engine
        self.max_batch = max_batch
        # production (persisting) mode also needs the extracted board
        self.include_board = include_board
        # generous: the timeout only has to catch a dead worker, so it sits
        # far above a cold batch shape's first call (kernel build, cuDNN
        # algorithm search); warmed shapes answer in well under a second
        self.timeout_s = timeout_s
        # bounded: a wedged (not dead) worker must shed load with 503s, not
        # accumulate one ~512 KB image per timed-out retry forever
        self.q: queue.Queue = queue.Queue(maxsize=max(64, 8 * max_batch))
        t = threading.Thread(target=self._loop, daemon=True, name="cv-microbatch")
        t.start()

    def submit(self, img: np.ndarray, flip: bool) -> tuple[bool, str, np.ndarray, np.ndarray | None]:
        ev = threading.Event()
        slot: dict[str, Any] = {}
        try:
            self.q.put_nowait((img, bool(flip), ev, slot))
        except queue.Full:
            # the handler maps TimeoutError to 503
            raise TimeoutError("micro-batch queue full — worker overloaded or wedged") from None
        if not ev.wait(timeout=self.timeout_s):
            # worker wedged or dead: fail this request instead of hanging
            # the connection forever
            raise TimeoutError(f"micro-batch worker did not answer within {self.timeout_s:.0f}s")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["found"], slot["fen"], slot["conf"], slot.get("board")

    def _loop(self) -> None:
        while True:
            items = [self.q.get()]
            while len(items) < self.max_batch:
                try:
                    items.append(self.q.get_nowait())
                except queue.Empty:
                    break
            groups: dict[tuple, list] = {}
            for it in items:
                groups.setdefault((it[1], it[0].shape), []).append(it)
            for (flip, _shape), group in groups.items():
                try:
                    n = len(group)
                    imgs = np.stack([it[0] for it in group])
                    padded = 1 << (n - 1).bit_length()
                    if padded > n:
                        imgs = np.concatenate([imgs, np.repeat(imgs[-1:], padded - n, axis=0)])
                    kw = {"include_board": True} if self.include_board else {}
                    batch = self.engine.process_batch(imgs, flip=flip, lite=True, **kw)
                    for i, (_, _, ev, slot) in enumerate(group):
                        slot["found"] = bool(batch.board_found[i])
                        slot["fen"] = batch.fens[i]
                        slot["conf"] = np.max(batch.probabilities[i], axis=1)
                        if self.include_board and slot["found"]:
                            slot["board"] = np.asarray(batch.board_image[i])
                        ev.set()
                except Exception as e:  # noqa: BLE001 — the worker must outlive a failed batch
                    logger.exception("micro-batch failed")
                    for _, _, ev, slot in group:
                        slot["error"] = str(e)
                        ev.set()


class ChessVisionService:
    """Holds the model + persistence dirs; handler delegates here."""

    def __init__(self, local: bool = True, upload_root: str | None = None, cv_model: Any = None) -> None:
        self.local = local
        self.lock = threading.Lock()
        if cv_model is None:
            from chessvision_tpu_torch.core import ChessVision

            logger.info("Eager-loading ChessVision models...")
            cv_model = ChessVision(lazy_load=False)
        self.cv = cv_model
        # The micro-batcher serves both modes.  In production (local=False)
        # the engine also returns the extracted board, and persistence
        # happens on a background thread so responses never wait on disk.
        self.batcher = (
            _MicroBatcher(cv_model.engine, include_board=not local) if hasattr(cv_model, "engine") else None
        )
        self.upload_root = Path(upload_root or "user_uploads")
        init_uploads_folder(self.upload_root)
        self._persist_q: Any = None
        if not local:
            # bounded + best-effort: under overload, dropping an upload
            # beats blocking responses (the response already shipped)
            self._persist_q = queue.Queue(maxsize=256)
            threading.Thread(target=self._persist_loop, daemon=True, name="cv-persist").start()

    def warmup(self, image_hw: tuple[int, int] = (512, 512)) -> None:
        """Run the lite engine path once at every micro-batch size
        (1, 2, ..., cap), so that no client request pays a first call's
        one-off costs: the kernel build and load, cuDNN's algorithm choice
        per shape, the allocator's first blocks."""
        if self.batcher is None:
            return
        b = 1
        kw = {"include_board": True} if self.batcher.include_board else {}
        while b <= self.batcher.max_batch:
            zeros = np.zeros((b, *image_hw, 3), np.uint8)
            self.cv.engine.process_batch(zeros, lite=True, **kw)
            logger.info("warmup: serving batch %d ran", b)
            b *= 2

    # -- request handlers ------------------------------------------------------

    def cv_algo(self, payload: dict[str, Any]) -> tuple[int, dict[str, Any]]:
        if "image" not in payload:
            return 400, {"success": False, "error": "Missing image data"}
        try:
            raw = payload["image"]
            if isinstance(raw, str) and raw.startswith("data:"):
                raw = raw.split(",", 1)[1]
            buf = base64.b64decode(raw)
            img = self._decode_image(buf)
        except Exception as e:  # noqa: BLE001 — any malformed upload is the client's 400
            return 400, {"success": False, "error": f"Invalid image data: {e}"}
        return self._process(img, payload.get("flip", False), payload.get("tokens"))

    def classify_image(self, image_bytes: bytes, flip: bool = False) -> tuple[int, dict[str, Any]]:
        try:
            img = self._decode_image(image_bytes)
        except Exception as e:  # noqa: BLE001 — any malformed upload is the client's 400
            return 400, {"success": False, "error": f"Invalid image data: {e}"}
        return self._process(img, flip, None)

    def _decode_image(self, buf: bytes) -> np.ndarray:
        """Encoded image → (H, W, 3) uint8 BGR."""
        import cv2

        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("could not decode image")
        return img

    def _process(self, img: np.ndarray, flip: bool, tokens: Any) -> tuple[int, dict[str, Any]]:
        raw_id = str(uuid.uuid4())
        t0 = time.time()
        if self.batcher is not None:
            # latency path: lite engine outputs (plus the extracted board
            # in persisting mode), with concurrent requests coalesced into
            # one device batch by the micro-batcher
            found, fen, confidences, board = self.batcher.submit(img, bool(flip))
            if not found:
                return 400, {"success": False, "error": "No chessboard detected"}
            if not self.local:
                self._persist_async(raw_id, img, board)
            elapsed = time.time() - t0
        else:
            with self.lock:
                result = self.cv.process_image(img, flip=bool(flip))
                if result.position is None:
                    return 400, {"success": False, "error": "No chessboard detected"}
                if not self.local:
                    self._persist(raw_id, img, result)
                fen = result.position.fen
                confidences = result.position.confidence_scores
                elapsed = result.processing_time

        return 200, {
            "success": True,
            "id": raw_id,
            "FEN": fen,
            "fen": fen,
            "position": fen_2_json(fen),
            "confidence_scores": [float(c) for c in confidences],
            "processing_time": elapsed,
        }

    def _persist_async(self, raw_id: str, img: np.ndarray, board: np.ndarray | None) -> None:
        try:
            self._persist_q.put_nowait((raw_id, img, board))
        except queue.Full:  # drop, never block
            logger.warning("persist queue full — dropping upload %s", raw_id)

    def _persist_loop(self) -> None:
        while True:
            raw_id, img, board = self._persist_q.get()
            self._write_upload(raw_id, img, board)

    def _persist(self, raw_id: str, img: np.ndarray, result: Any) -> None:
        self._write_upload(raw_id, img, result.board_extraction.board_image)

    def _write_upload(self, raw_id: str, img: np.ndarray, board: np.ndarray | None) -> None:
        try:
            import cv2

            cv2.imwrite(str(self.upload_root / "raw" / f"{raw_id}.JPG"), img)
            if board is not None:
                cv2.imwrite(str(self.upload_root / "boards" / f"{raw_id}.JPG"), board)
        except Exception:  # noqa: BLE001 — persistence is best-effort
            logger.exception("Failed to persist upload %s", raw_id)

    def feedback(self, payload: dict[str, Any]) -> tuple[int, dict[str, Any]]:
        if not payload.get("id") or "position" not in payload:
            return 400, {"success": False, "error": "Missing id or position"}
        entry = {
            "id": str(payload["id"]),
            "position": payload["position"],
            "flip": payload.get("flip", False),
            "timestamp": datetime.datetime.now().isoformat(),
        }
        # Server-generated filename: the client id is stored inside the
        # JSON, never used as a path component.
        path = self.upload_root / "feedback" / f"{uuid.uuid4().hex}.json"
        path.write_text(json.dumps(entry, indent=2))
        return 200, {"success": True}


def make_handler(service: ChessVisionService) -> type[BaseHTTPRequestHandler]:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, body: dict[str, Any]) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")
            self.end_headers()
            self.wfile.write(data)

        def do_OPTIONS(self) -> None:  # noqa: N802
            self._send(200, {})

        def do_GET(self) -> None:  # noqa: N802
            if self.path.rstrip("/") == "/ping":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self) -> None:  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            path = self.path.rstrip("/")
            try:
                if path == "/cv_algo":
                    ctype = self.headers.get("Content-Type", "")
                    if "application/json" in ctype:
                        payload = json.loads(body or b"{}")
                    else:
                        payload = {"image": body.decode("ascii", "ignore")}
                    status, resp = service.cv_algo(payload)
                elif path == "/classify_image":
                    ctype = self.headers.get("Content-Type", "")
                    image_bytes, flip = _parse_multipart(body, ctype)
                    if image_bytes is None:
                        status, resp = 400, {"success": False, "error": "No file part"}
                    else:
                        status, resp = service.classify_image(image_bytes, flip)
                elif path == "/feedback":
                    status, resp = service.feedback(json.loads(body or b"{}"))
                else:
                    status, resp = 404, {"error": "not found"}
            except TimeoutError as e:
                logger.exception("Request timed out in the micro-batcher")
                status, resp = 503, {"success": False, "error": str(e)}
            except Exception as e:  # noqa: BLE001 — the server answers 500 and keeps running
                logger.exception("Request failed")
                status, resp = 500, {"success": False, "error": str(e)}
            self._send(status, resp)

        def log_message(self, fmt: str, *args: Any) -> None:
            logger.info("%s - %s", self.address_string(), fmt % args)

    return Handler


def _parse_multipart(body: bytes, content_type: str) -> tuple[bytes | None, bool]:
    """Minimal multipart/form-data parser for the /classify_image route."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return None, False
    boundary = b"--" + m.group(1).encode()
    image_bytes = None
    flip = False
    for part in body.split(boundary):
        if b"\r\n\r\n" not in part:
            continue
        head, _, content = part.partition(b"\r\n\r\n")
        content = content.rstrip(b"\r\n-")
        head_l = head.decode("latin-1", "ignore").lower()
        if 'name="file"' in head_l or "filename=" in head_l:
            image_bytes = content
        elif 'name="flip"' in head_l:
            flip = content.strip().lower() in (b"true", b"1", b"yes")
    return image_bytes, flip


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 refuses connections
    # when a burst of clients connects faster than the accept loop spawns
    # handler threads, long before the micro-batcher's queue is full
    request_queue_size = 128


def serve(
    port: int = 7777,
    local: bool = True,
    cv_model: Any = None,
    upload_root: str | None = None,
    warmup: bool = False,
) -> ThreadingHTTPServer:
    service = ChessVisionService(local=local, cv_model=cv_model, upload_root=upload_root)
    if warmup:
        service.warmup()
    server = _Server(("0.0.0.0", port), make_handler(service))
    logger.info("chessvision compute endpoint on :%d (local=%s)", port, local)
    return server


def main(argv: list[str] | None = None) -> None:
    from chessvision_tpu_torch.utils import setup_logger

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=int(os.getenv("PORT", "7777")))
    parser.add_argument("--local", action="store_true", default=bool(os.getenv("LOCAL")))
    parser.add_argument("--upload-root", type=str, default=None)
    parser.add_argument("--clean-uploads", action="store_true", help="purge + recreate the uploads tree and exit")
    parser.add_argument("--warmup", action="store_true", help="run every micro-batch size once before accepting traffic")
    args = parser.parse_args(argv)
    setup_logger("chessvision_tpu_torch")
    if args.clean_uploads:
        clean_uploads_folder(args.upload_root or "user_uploads")
        print("uploads folder reset")
        return
    server = serve(port=args.port, local=args.local, upload_root=args.upload_root, warmup=args.warmup)
    server.serve_forever()


if __name__ == "__main__":
    main()
