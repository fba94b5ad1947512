"""Minimal runstore dashboard, the counterpart of
``chessvision_tpu/runstore/view.py`` (the same pages, byte for byte, over
the same store): browse projects → runs → parameters, scalar curves,
per-sample metrics tables with artifact thumbnails, and 2-D embedding
maps, from a stdlib HTTP server over the on-disk store.

    python -m chessvision_tpu_torch.runstore.view [--port 8008]

Everything is rendered server-side as static HTML + inline SVG (no JS
frameworks, nothing fetched from the network); image artifacts referenced
by metrics-table path columns are served through a store-root-jailed
``/file`` route.
"""

from __future__ import annotations

import argparse
import html
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from chessvision_tpu_torch.runstore.runs import Run, list_runs
from chessvision_tpu_torch.runstore.tables import store_root

_STYLE = """
body { font-family: system-ui, sans-serif; margin: 2em auto; max-width: 72em;
       color: #1a1a2e; }
h1, h2, h3 { font-weight: 600; }
a { color: #3451b2; text-decoration: none; }
a:hover { text-decoration: underline; }
table { border-collapse: collapse; margin: 1em 0; font-size: 0.9em; }
th, td { border: 1px solid #d8d8e0; padding: 0.3em 0.7em; text-align: left;
         vertical-align: top; }
th { background: #f2f2f7; }
img.thumb { max-height: 96px; max-width: 96px; display: block; }
.spark { margin: 0.4em 1.2em 0.4em 0; display: inline-block; }
.spark text { font-size: 11px; fill: #444; }
.muted { color: #777; font-size: 0.85em; }
code { background: #f2f2f7; padding: 0.1em 0.3em; }
"""

_MAX_ROWS = 200


def _page(title: str, body: str) -> bytes:
    return (
        f"<!doctype html><html><head><meta charset='utf-8'><title>{html.escape(title)}"
        f"</title><style>{_STYLE}</style></head><body>{body}</body></html>"
    ).encode("utf-8")


def _sparkline(xs: list[float], ys: list[float], label: str, w: int = 220, h: int = 60) -> str:
    """Inline SVG line chart with min/max/last annotations."""
    pts = [(x, y) for x, y in zip(xs, ys) if np.isfinite(y)]
    if not pts:
        return ""
    ys_f = [y for _, y in pts]
    lo, hi = min(ys_f), max(ys_f)
    span = (hi - lo) or 1.0
    n = len(pts)
    px = lambda i: 4 + (w - 8) * (i / max(n - 1, 1))  # noqa: E731
    py = lambda y: 14 + (h - 20) * (1 - (y - lo) / span)  # noqa: E731
    poly = " ".join(f"{px(i):.1f},{py(y):.1f}" for i, (_, y) in enumerate(pts))
    last = ys_f[-1]
    return (
        f"<svg class='spark' width='{w}' height='{h}' role='img'>"
        f"<text x='4' y='11'>{html.escape(label)} = {last:.5g}"
        f" <tspan fill='#999'>(min {lo:.3g}, max {hi:.3g}, n={n})</tspan></text>"
        f"<polyline points='{poly}' fill='none' stroke='#3451b2' stroke-width='1.5'/>"
        f"</svg>"
    )


def _scatter(xy: np.ndarray, w: int = 360, h: int = 300) -> str:
    """Inline SVG 2-D scatter (embedding map)."""
    if len(xy) == 0:
        return ""
    lo = xy.min(axis=0)
    span = np.maximum(xy.max(axis=0) - lo, 1e-9)
    circles = "".join(
        f"<circle cx='{6 + (w - 12) * (p[0] - lo[0]) / span[0]:.1f}' "
        f"cy='{6 + (h - 12) * (1 - (p[1] - lo[1]) / span[1]):.1f}' r='2.5' "
        f"fill='#3451b2' fill-opacity='0.55'/>"
        for p in xy
    )
    return f"<svg width='{w}' height='{h}' style='border:1px solid #d8d8e0'>{circles}</svg>"


def _is_image_path(v: str) -> bool:
    return v.lower().endswith((".png", ".jpg", ".jpeg")) and Path(v).exists()


def _file_url(path: str) -> str:
    return "/file?p=" + urllib.parse.quote(path)


def _cell(v) -> str:
    if isinstance(v, (str, np.str_)) and _is_image_path(str(v)):
        u = _file_url(str(v))
        return f"<a href='{u}'><img class='thumb' src='{u}' loading='lazy'></a>"
    if isinstance(v, (float, np.floating)):
        return f"{float(v):.5g}"
    if isinstance(v, np.ndarray):
        return html.escape(np.array2string(v, precision=3, threshold=8))
    return html.escape(str(v))


def index_page() -> bytes:
    root = store_root() / "projects"
    parts = ["<h1>chessvision-tpu runstore</h1>", f"<p class='muted'>store: <code>{html.escape(str(store_root()))}</code></p>"]
    if not root.exists():
        parts.append("<p>No projects yet.</p>")
    else:
        for proj in sorted(p.name for p in root.iterdir() if p.is_dir()):
            parts.append(f"<h2>{html.escape(proj)}</h2><table><tr><th>run</th><th>status</th><th>created</th><th>best val</th></tr>")
            for name in reversed(list_runs(proj)):
                run = Run(proj, name)
                p = run.parameters
                url = f"/run?project={urllib.parse.quote(proj)}&name={urllib.parse.quote(name)}"
                best = p.get("best_val_score", p.get("test_results", {}).get("top_1_accuracy", "") if isinstance(p.get("test_results"), dict) else "")
                parts.append(
                    f"<tr><td><a href='{url}'>{html.escape(name)}</a></td>"
                    f"<td>{html.escape(str(p.get('status', '')))}</td>"
                    f"<td>{html.escape(str(p.get('created', ''))[:19])}</td>"
                    f"<td>{_cell(best)}</td></tr>"
                )
            parts.append("</table>")
    return _page("runstore", "".join(parts))


def run_page(project: str, name: str) -> bytes:
    run = Run(project, name)
    parts = [f"<p><a href='/'>&larr; runs</a></p><h1>{html.escape(project)} / {html.escape(name)}</h1>"]

    # parameters
    parts.append("<h2>Parameters</h2><table>")
    for k, v in sorted(run.parameters.items()):
        if isinstance(v, dict):
            v = json.dumps(v, default=str)
        parts.append(f"<tr><th>{html.escape(str(k))}</th><td>{_cell(v)}</td></tr>")
    parts.append("</table>")

    # scalar curves
    scalars = run.scalars()
    if scalars:
        keys = sorted({k for row in scalars for k, v in row.items() if isinstance(v, (int, float))})
        parts.append("<h2>Scalars</h2><div>")
        for k in keys:
            ys = [row[k] for row in scalars if isinstance(row.get(k), (int, float))]
            parts.append(_sparkline(list(range(len(ys))), [float(y) for y in ys], k))
        parts.append("</div>")

    # metrics tables
    for tname in run.list_metrics_tables():
        cols = run.read_metrics_table(tname)
        n = len(next(iter(cols.values()))) if cols else 0
        parts.append(f"<h2>Metrics: {html.escape(tname)} <span class='muted'>({n} rows)</span></h2>")
        emb_keys = [k for k, v in cols.items() if k.endswith("_2d") and np.asarray(v).ndim == 2]
        for k in emb_keys:
            parts.append(f"<h3>{html.escape(k)}</h3>" + _scatter(np.asarray(cols[k], np.float64)))
        flat = {k: v for k, v in cols.items() if k not in emb_keys and np.asarray(v).ndim == 1}
        if flat:
            keys = sorted(flat, key=lambda k: (k != "example_id", k))
            parts.append("<table><tr>" + "".join(f"<th>{html.escape(k)}</th>" for k in keys) + "</tr>")
            for i in range(min(n, _MAX_ROWS)):
                parts.append("<tr>" + "".join(f"<td>{_cell(flat[k][i])}</td>" for k in keys) + "</tr>")
            parts.append("</table>")
            if n > _MAX_ROWS:
                parts.append(f"<p class='muted'>… {n - _MAX_ROWS} more rows not shown</p>")
    return _page(f"{project}/{name}", "".join(parts))


def _serve_file(path_str: str) -> tuple[int, bytes, str]:
    """Serve an artifact image, jailed to the store root (path columns in
    metrics tables point under run bulk dirs)."""
    try:
        path = Path(path_str).resolve()
        root = store_root().resolve()
        if root not in path.parents and path != root:
            return 403, b"outside store root", "text/plain"
        if not path.is_file():
            return 404, b"not found", "text/plain"
        ctype = {
            ".png": "image/png",
            ".jpg": "image/jpeg",
            ".jpeg": "image/jpeg",
        }.get(path.suffix.lower(), "application/octet-stream")
        return 200, path.read_bytes(), ctype
    except OSError as e:
        return 500, str(e).encode(), "text/plain"


def make_handler() -> type[BaseHTTPRequestHandler]:
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 — http.server API
            parsed = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(parsed.query))
            try:
                if parsed.path == "/":
                    status, body, ctype = 200, index_page(), "text/html; charset=utf-8"
                elif parsed.path == "/run" and "project" in q and "name" in q:
                    status, body, ctype = 200, run_page(q["project"], q["name"]), "text/html; charset=utf-8"
                elif parsed.path == "/file" and "p" in q:
                    status, body, ctype = _serve_file(q["p"])
                else:
                    status, body, ctype = 404, b"not found", "text/plain"
            except Exception as e:  # noqa: BLE001 — render errors as 500s
                status, body, ctype = 500, str(e).encode(), "text/plain"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt: str, *args) -> None:
            pass

    return Handler


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)
    server = ThreadingHTTPServer((args.host, args.port), make_handler())
    print(f"runstore view on http://{args.host}:{args.port}/ (store: {store_root()})")
    server.serve_forever()


if __name__ == "__main__":
    main()
