"""Raw-data ingestion and enrichment pipeline, the counterpart of
``chessvision_tpu/ingest/pipeline.py``: fetch a date-ranged batch of raw
uploads (S3 via boto3 when available) or take a local folder, register
the files as a runstore table, run the port's batched engine over the
batch (on the GPU unless ``device="cpu"``) and write per-image enrichment
metrics: extraction success, the four quality scores, predicted FENs.
Frames are decoded by the native loader (``native_loader.load_batch``)
where it builds, else by cv2.
"""

from __future__ import annotations

import datetime
import logging
from pathlib import Path
from typing import Any

import numpy as np

import torch

from chessvision_tpu_torch.runstore import Run, Table, init

logger = logging.getLogger(__name__)


# --- acquisition ---------------------------------------------------------------


def download_raw_data(
    start_date: datetime.date,
    end_date: datetime.date,
    bucket: str = "chessvision-bucket",
    output_folder: Path | None = None,
    prefix: str = "raw/",
) -> list[Path]:
    """Download raw uploads for a date range from S3 (paginated, like
    process_pipeline.py:45-131).  Requires boto3 + credentials; the rest
    of the pipeline is agnostic to where files come from."""
    try:
        import boto3  # type: ignore
    except ImportError as err:
        raise ImportError(
            "boto3 is not available in this environment; use collect_local_files() "
            "or pass an explicit file list to run_pipeline()."
        ) from err

    out = Path(output_folder or f"raw_{start_date}_{end_date}")
    out.mkdir(parents=True, exist_ok=True)
    s3 = boto3.client("s3")
    paginator = s3.get_paginator("list_objects_v2")
    downloaded: list[Path] = []
    day = start_date
    while day <= end_date:
        day_prefix = f"{prefix}{day.isoformat()}"
        for page in paginator.paginate(Bucket=bucket, Prefix=day_prefix):
            for obj in page.get("Contents", []):
                dest = out / Path(obj["Key"]).name
                s3.download_file(bucket, obj["Key"], str(dest))
                downloaded.append(dest)
        day += datetime.timedelta(days=1)
    logger.info("Downloaded %d objects", len(downloaded))
    return downloaded


def collect_local_files(folder: str | Path) -> list[Path]:
    folder = Path(folder)
    return sorted(
        p for p in folder.iterdir() if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )


# --- quality scores (reference process_pipeline.py:357-467) ----------------------


def probability_distribution(mask: np.ndarray) -> float:
    """Bimodality of the probability mask: 1 − normalized 10-bin entropy."""
    hist, _ = np.histogram(mask.flatten(), bins=10, range=(0, 1))
    hist = hist / np.sum(hist)
    entropy = -np.sum(hist * np.log2(hist + 1e-10))
    max_entropy = -np.log2(1 / 10)
    return float(1.0 - entropy / max_entropy)


def mask_completeness(mask: np.ndarray) -> float:
    """Solidity of the thresholded mask: foreground area / filled area of
    the dominant component.  The reference fills the largest cv2 contour;
    here the filled region is the row/column convex closure of the
    dominant flood-fill component — identical for solid board blobs."""
    binary = mask > 0.5
    if not binary.any():
        return 0.0
    from chessvision_tpu_torch.ops.quad import connected_component

    seed = int(np.argmax(np.where(binary.ravel(), mask.ravel(), -1)))
    comp = connected_component(torch.from_numpy(binary)[None], torch.tensor([seed]))[0].numpy()
    if not comp.any():
        return 0.0
    # fill holes: a pixel is inside if covered both by a row-span and a
    # column-span of the component
    rows = np.where(comp.any(axis=1))[0]
    filled = np.zeros_like(comp)
    for r in rows:
        cols = np.where(comp[r])[0]
        filled[r, cols[0] : cols[-1] + 1] = True
    for c in np.where(comp.any(axis=0))[0]:
        rws = np.where(comp[:, c])[0]
        col_span = np.zeros(comp.shape[0], bool)
        col_span[rws[0] : rws[-1] + 1] = True
        filled[:, c] &= col_span
    original_area = float(binary.sum())
    filled_area = float(filled.sum())
    if filled_area == 0:
        return 0.0
    return min(original_area / filled_area, 1.0)


def quadrangle_regularity(quadrangle: np.ndarray | None) -> float:
    """How square the quadrangle is: side-length CV and angle deviation
    (process_pipeline.py:417-457)."""
    if quadrangle is None:
        return 0.0
    quad = np.asarray(quadrangle, np.float64).reshape(4, 2)
    sides = [np.linalg.norm(quad[i] - quad[(i + 1) % 4]) for i in range(4)]
    angles = []
    for i in range(4):
        v1 = quad[(i - 1) % 4] - quad[i]
        v2 = quad[(i + 1) % 4] - quad[i]
        norm = np.linalg.norm(v1) * np.linalg.norm(v2)
        cosang = np.clip(np.dot(v1, v2) / norm, -1, 1) if norm > 0 else 1.0
        angles.append(np.arccos(cosang))
    side_variance = np.std(sides) / np.mean(sides) if np.mean(sides) > 0 else 1.0
    angle_variance = np.std(angles) / (np.pi / 2)
    return float(1.0 - (side_variance * 0.5 + angle_variance * 0.5))


def probability_confidence(probabilities: np.ndarray) -> float:
    """Mean distance from 0.5 of the top-25% most confident pixels
    (process_pipeline.py:460-467)."""
    flat = probabilities.flatten()
    k = max(1, int(flat.size * 0.25))
    top = np.sort(flat)[-k:]
    return float(np.mean(np.abs(top - 0.5)) * 2)


# --- enrichment ---------------------------------------------------------------


def enrich_table(
    table: Table,
    run: Run,
    cv_model: Any = None,
    threshold: float = 0.5,
    batch_size: int = 32,
    image_size: int = 512,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Run the batched engine over a table of images and write an
    enrichment metrics table (success flags, quality scores, FENs).
    ``cv_model`` defaults to ``ChessVision`` with the default weights on
    ``device``."""
    import cv2

    from chessvision_tpu_torch.core import ChessVision

    if cv_model is None:
        cv_model = ChessVision(lazy_load=False, device=device)

    paths = table["path"]
    cols: dict[str, list] = {
        "example_id": [],
        "extraction_success": [],
        "fen": [],
        "probability_distribution": [],
        "mask_completeness": [],
        "quadrangle_regularity": [],
        "probability_confidence": [],
    }

    from chessvision_tpu_torch import native_loader

    use_native = native_loader.available()
    for start in range(0, len(paths), batch_size):
        chunk = paths[start : start + batch_size]
        if use_native:
            # threaded C++ decode+INTER_AREA straight into one NHWC batch —
            # the hot host stage of ingestion (decode error → zeroed frame,
            # dropped below like a cv2.imread failure)
            loaded, n_failures = native_loader.load_batch(
                [str(p) for p in chunk], image_size, image_size
            )
            if n_failures == 0:
                # nothing failed to decode — keep every slot, including a
                # legitimately all-black image
                pairs = [
                    (img, table["example_id"][start + i]) for i, img in enumerate(loaded)
                ]
            else:
                # failed slots come back zeroed; drop those and cross-check
                # the count against what the loader reported
                pairs = [
                    (img, table["example_id"][start + i])
                    for i, img in enumerate(loaded)
                    if img.sum() > 0
                ]
                n_dropped = len(loaded) - len(pairs)
                if n_dropped != n_failures:
                    logger.warning(
                        "native loader reported %d decode failures but %d zeroed "
                        "frames were dropped — an all-black source image may have "
                        "been discarded",
                        n_failures,
                        n_dropped,
                    )
        else:
            pairs = []
            for i, p in enumerate(chunk):
                img = cv2.imread(str(p))
                if img is None:
                    continue
                if img.shape[:2] != (image_size, image_size):
                    img = cv2.resize(img, (image_size, image_size), interpolation=cv2.INTER_AREA)
                pairs.append((img, table["example_id"][start + i]))
        if not pairs:
            continue
        imgs = [im for im, _ in pairs]
        keep_ids = [ex for _, ex in pairs]
        batch = np.stack(imgs)
        res = cv_model.engine.process_batch(batch, threshold)
        probs_masks = 1.0 / (1.0 + np.exp(-res.logits))  # (b, 256, 256)
        for bi, ex_id in enumerate(keep_ids):
            found = bool(res.board_found[bi])
            cols["example_id"].append(ex_id)
            cols["extraction_success"].append(int(found))
            cols["fen"].append(res.fens[bi] if found else "")
            cols["probability_distribution"].append(probability_distribution(probs_masks[bi]))
            cols["mask_completeness"].append(mask_completeness(probs_masks[bi]))
            cols["quadrangle_regularity"].append(
                quadrangle_regularity(res.quadrangle[bi] if found else None)
            )
            cols["probability_confidence"].append(probability_confidence(probs_masks[bi]))

    out = {
        k: (np.asarray(v, object) if k in ("example_id", "fen") else np.asarray(v))
        for k, v in cols.items()
    }
    run.write_metrics_table("enrichment", out)
    return out


def run_pipeline(
    *,
    input_folder: str | Path | None = None,
    files: list[Path] | None = None,
    start_date: datetime.date | None = None,
    end_date: datetime.date | None = None,
    bucket: str = "chessvision-bucket",
    project: str = "chessvision-new-raw",
    dataset: str = "raw",
    table_name: str | None = None,
    threshold: float = 0.5,
    cv_model: Any = None,
    device: str | torch.device = "cuda",
) -> tuple[Table, Run]:
    """Full ingestion: acquire files → table → enrichment run.

    Sources, in priority order: explicit ``files``, a local
    ``input_folder``, or S3 via date range (requires boto3)."""
    if files is None:
        if input_folder is not None:
            files = collect_local_files(input_folder)
        elif start_date and end_date:
            files = download_raw_data(start_date, end_date, bucket)
        else:
            raise ValueError("need files, input_folder, or a date range")
    if table_name is None:
        table_name = f"batch-{datetime.date.today().isoformat()}"

    table = Table(
        project,
        dataset,
        table_name,
        {
            "path": np.asarray([str(p) for p in files], object),
            "filename": np.asarray([Path(p).name for p in files], object),
        },
    ).save()
    run = init(project, f"enrich-{table_name}", parameters={"table": table.url, "threshold": threshold})
    enrich_table(table, run, cv_model=cv_model, threshold=threshold, device=device)
    run.set_status_completed()
    logger.info("Ingested %d files into %s", len(files), table.url)
    return table, run


def main(argv: list[str] | None = None) -> int:
    """CLI: one command ingests a folder (or an S3 date range) and writes
    the enrichment table and run."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m chessvision_tpu_torch.ingest",
        description="Ingest raw board photos and enrich them with the batched engine.",
    )
    src = parser.add_argument_group("source (pick one)")
    src.add_argument("--input-folder", help="local folder of raw images")
    src.add_argument("--start-date", help="S3 batch start date, YYYY-MM-DD")
    src.add_argument("--end-date", help="S3 batch end date, YYYY-MM-DD")
    parser.add_argument("--bucket", default="chessvision-bucket", help="S3 bucket name")
    parser.add_argument("--project", default="chessvision-new-raw")
    parser.add_argument("--dataset", default="raw")
    parser.add_argument("--table-name", default=None)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if not args.input_folder and not (args.start_date and args.end_date):
        parser.error("need --input-folder or both --start-date and --end-date")

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    table, run = run_pipeline(
        input_folder=args.input_folder,
        start_date=datetime.date.fromisoformat(args.start_date) if args.start_date else None,
        end_date=datetime.date.fromisoformat(args.end_date) if args.end_date else None,
        bucket=args.bucket,
        project=args.project,
        dataset=args.dataset,
        table_name=args.table_name,
        threshold=args.threshold,
        device=args.device,
    )
    print(f"table: {table.url}")
    print(f"run:   {run.dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
