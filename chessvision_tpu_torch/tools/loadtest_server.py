"""Concurrent load test of the serving endpoint (micro-batcher on), the
counterpart of ``scripts/loadtest_server.py``.

Starts the port's HTTP server in this process (``serve(port=0, warmup=True)``:
every micro-batch shape warmed), then posts ``--requests`` /cv_algo/
requests from threads, at most ``--concurrency`` at once, and prints one
JSON line: the JAX script's keys (``mode``, ``requests``, ``concurrency``,
``req_per_sec``, ``p50_ms``, ``p95_ms``, ``wall_s``), the image it posted,
the FEN every response gave, and the card's name and power limit.  Each
response's FEN must equal ``Engine.process_batch``'s on the decoded frame.

The image is the first ``data/test/initial/raw/*.JPG`` under the data root,
or, where there is none, ``synthetic.board_frames`` of seed 1 (a frame
whose board the committed models find) encoded as a JPEG.

    python -m chessvision_tpu_torch.tools.loadtest_server [--requests 96]
        [--concurrency 16] [--prod] [--device cuda|cpu]

Runs on the GPU unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Any

import numpy as np

from chessvision_tpu_torch import constants

SYNTHETIC_SEED = 1


def load_image(seed: int = SYNTHETIC_SEED) -> tuple[bytes, str]:
    """(encoded image, where it came from): the first real test photo
    under the data root, else a synthetic frame of ``seed`` as a JPEG."""
    raw = sorted((constants.data_root() / "test" / "initial" / "raw").glob("*.JPG"))
    if raw:
        return raw[0].read_bytes(), str(raw[0])
    import cv2

    from chessvision_tpu_torch.synthetic import board_frames

    ok, buf = cv2.imencode(".jpg", board_frames(seed, 1)[0][0], [cv2.IMWRITE_JPEG_QUALITY, 95])
    if not ok:
        raise RuntimeError("cv2 could not encode the synthetic frame")
    return buf.tobytes(), f"synthetic board_frames seed {seed} (JPEG, quality 95)"


def run(cv: Any, image: bytes, requests: int, concurrency: int, prod: bool) -> dict[str, Any]:
    """Serve ``cv`` on a free loopback port, post ``image`` ``requests``
    times at most ``concurrency`` at once; the JAX script's record plus
    ``fens``, the FEN of each response."""
    from chessvision_tpu_torch.serve.server import serve

    with tempfile.TemporaryDirectory(prefix="loadtest-uploads-") as uploads:
        server = serve(port=0, local=not prod, cv_model=cv, upload_root=uploads, warmup=True)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}/cv_algo/"
        payload = json.dumps({"image": base64.b64encode(image).decode(), "flip": False}).encode()

        def post() -> tuple[float, str]:
            t0 = time.perf_counter()
            req = urllib.request.Request(url, data=payload, headers={"Content-Type": "application/json"})
            resp = json.loads(urllib.request.urlopen(req, timeout=300).read())
            if not resp["success"]:
                raise RuntimeError(f"request failed: {resp}")
            return time.perf_counter() - t0, resp["fen"]

        try:
            post()  # connection warm
            results: list[tuple[float, str]] = []
            errors: list[BaseException] = []
            lock = threading.Lock()
            sem = threading.Semaphore(concurrency)

            def worker() -> None:
                try:
                    with sem:
                        r = post()
                    with lock:
                        results.append(r)
                except BaseException as e:  # noqa: BLE001 — reported after the joins
                    with lock:
                        errors.append(e)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=worker) for _ in range(requests)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
        finally:
            server.shutdown()
            server.server_close()
    if errors:
        raise RuntimeError(f"{len(errors)} of {requests} requests failed: {errors[0]!r}")
    lat = np.asarray(sorted(dt for dt, _ in results))
    return {
        "mode": "prod" if prod else "local",
        "requests": requests,
        "concurrency": concurrency,
        "req_per_sec": round(requests / wall, 2),
        "p50_ms": round(float(lat[len(lat) // 2]) * 1000, 1),
        "p95_ms": round(float(lat[int(len(lat) * 0.95)]) * 1000, 1),
        "wall_s": round(wall, 2),
        "fens": sorted({fen for _, fen in results}),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Concurrent load test of the PyTorch port's server (one JSON line)")
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--prod", action="store_true",
                    help="production mode: local=False, uploads persisted (async) and the extracted board shipped")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import cv2

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.tools import card
    from chessvision_tpu_torch.utils import default_train_dtype, resolve_device

    dev = resolve_device(args.device)
    cv = ChessVision(lazy_load=False, device=dev, dtype=default_train_dtype(dev))
    image, source = load_image()
    frame = cv2.imdecode(np.frombuffer(image, np.uint8), cv2.IMREAD_COLOR)
    want = cv.engine.process_batch(frame[None]).fens[0]
    rec = run(cv, image, args.requests, args.concurrency, args.prod)
    if rec["fens"] != [want]:
        raise RuntimeError(f"served FENs {rec['fens']} differ from process_batch's {want!r} on the decoded frame")
    rec.update(image=source, fen=want, backend=dev.type, **card.card_fields(dev))
    del rec["fens"]
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
