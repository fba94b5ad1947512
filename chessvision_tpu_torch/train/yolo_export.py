"""Export the board-extraction dataset in YOLO-segmentation layout, the
counterpart of ``chessvision_tpu/train/yolo_export.py`` (numpy and cv2; it
writes the same files, labels and ``dataset.yaml`` on the same data).

The seeded 90/10 split comes from the port's data loader (train/data.py,
the split every trainer uses), and the mask→polygon conversion is the
largest contour with normalized coordinates, one ``0 x1 y1 x2 y2 …`` line
per board.

Layout written under ``--out``:

    images/{train,val}/<id>.png     256×256 BGR frames
    labels/{train,val}/<id>.txt     YOLO-seg polygon (class 0 = board)
    dataset.yaml                    ultralytics-style dataset descriptor

The trainers consume masks directly (train_unet.py --model-id yolo); the
exporter is for external YOLO-seg tooling.

Run: python -m chessvision_tpu_torch.train.yolo_export --out data/yolo_seg
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def mask_to_polygon(mask: np.ndarray, threshold: int = 127) -> np.ndarray | None:
    """(H, W) mask → (N, 2) polygon of the largest foreground contour in
    pixel coordinates, or None for an empty mask.  Uses cv2.findContours
    when available; falls back to the convex hull of the boundary pixels
    (boards are convex quadrilaterals, so the hull IS the contour)."""
    binary = (np.asarray(mask) > threshold).astype(np.uint8)
    if not binary.any():
        return None
    try:
        import cv2

        contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        if not contours:
            return None
        largest = max(contours, key=cv2.contourArea)
        return largest.reshape(-1, 2).astype(np.float32)
    except ImportError:
        ys, xs = np.nonzero(binary)
        pts = np.stack([xs, ys], axis=1).astype(np.float32)
        return _convex_hull(pts)


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain (no cv2/scipy)."""
    pts = np.unique(pts, axis=0)
    if len(pts) < 3:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def build(points):
        out: list[np.ndarray] = []
        for p in points:
            while len(out) >= 2:
                a, b = out[-1] - out[-2], p - out[-2]
                # 2-D cross product (np.cross on 2-vectors is deprecated)
                if a[0] * b[1] - a[1] * b[0] > 0:
                    break
                out.pop()
            out.append(p)
        return out

    lower = build(pts)
    upper = build(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.float32)


def polygon_to_label_line(polygon: np.ndarray, h: int, w: int, class_id: int = 0) -> str:
    """YOLO-seg label line: class then x y pairs normalized to [0, 1]."""
    norm = polygon.astype(np.float64) / np.array([w, h], np.float64)
    norm = np.clip(norm, 0.0, 1.0)
    coords = " ".join(f"{v:.6f}" for v in norm.reshape(-1))
    return f"{class_id} {coords}"


def _write_png(path: Path, img_bgr: np.ndarray) -> None:
    import cv2

    cv2.imwrite(str(path), np.asarray(img_bgr))


def export_yolo_segmentation_dataset(
    out_dir: str | Path, data=None, threshold: int = 127
) -> dict[str, int]:
    """Write the YOLO-seg dataset; returns per-split exported counts."""
    if data is None:
        from chessvision_tpu_torch.train.data import load_board_extraction

        data = load_board_extraction()
    out = Path(out_dir)
    counts: dict[str, int] = {}
    for split, imgs, masks, ids in (
        ("train", data.train_images, data.train_masks, data.train_ids),
        ("val", data.val_images, data.val_masks, data.val_ids),
    ):
        img_dir = out / "images" / split
        lbl_dir = out / "labels" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        lbl_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        for i, ex_id in enumerate(ids):
            mask = np.asarray(masks[i])
            if mask.dtype != np.uint8:
                mask = (mask * 255).astype(np.uint8)
            poly = mask_to_polygon(mask, threshold)
            if poly is None or len(poly) < 3:
                logger.warning("Skipping %s: empty mask", ex_id)
                continue
            stem = Path(str(ex_id)).stem
            _write_png(img_dir / f"{stem}.png", imgs[i])
            h, w = mask.shape
            (lbl_dir / f"{stem}.txt").write_text(
                polygon_to_label_line(poly, h, w) + "\n"
            )
            n += 1
        counts[split] = n
        logger.info("Exported %d %s samples", n, split)

    (out / "dataset.yaml").write_text(
        "# YOLO-seg dataset exported from the chessvision board-extraction tables\n"
        f"path: {out.resolve()}\n"
        "train: images/train\n"
        "val: images/val\n"
        "names:\n"
        "  0: chessboard\n"
    )
    return counts


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="output dataset directory")
    ap.add_argument("--threshold", type=int, default=127)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    counts = export_yolo_segmentation_dataset(args.out, threshold=args.threshold)
    print(counts)


if __name__ == "__main__":
    main()
