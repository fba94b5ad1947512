"""Web-node static server of the port.

Serves the JAX package's static UI in place (``chessvision_tpu/serve/
webroot/``: a path, the files are not copied).  The UI is vanilla JS and
talks to the compute endpoint's /cv_algo/ and /feedback/.

Run: python -m chessvision_tpu_torch.serve.webroot_server --port 8000
"""

from __future__ import annotations

import argparse
import functools
import http.server
from pathlib import Path

# on the checkout beside this package, wherever CVTPU_ROOT points
WEBROOT = Path(__file__).resolve().parents[2] / "chessvision_tpu" / "serve" / "webroot"


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args()
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(WEBROOT))
    with http.server.ThreadingHTTPServer(("0.0.0.0", args.port), handler) as server:
        print(f"webroot on :{args.port} (serving {WEBROOT})")
        server.serve_forever()


if __name__ == "__main__":
    main()
