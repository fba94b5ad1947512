"""The batched image→FEN engine on PyTorch.

Counterpart of ``chessvision_tpu/engine.py``: uint8 BGR frames → exact
grayscale and area resize → segmenter → sigmoid → quadrangles →
closed-form homographies → two-pass warp into a margin canvas (kernel K1)
→ grid detection on the uint8-rounded board → ``refine`` tail → flip →
uint8 board, all as tensors on one device; the chess-rule validation and
FEN assembly run on the host.

Input formats (sizes per board and rates on the card: PERF.md):

- raw frames (``run_device``, ``process_batch``): the front half runs on
  the device;
- packed (``pack_inputs`` → ``run_packed``): the host makes the 256² color
  input and the full-resolution gray; the raw path feeds the same back
  half, so the two are bit-identical;
- yuv (``pack_inputs_yuv`` → ``run_yuv``): full-resolution luma and 128²
  chroma differences; the color input is rebuilt on the device in
  float32 (approximate: mild chroma blur in the segmenter's input only);
- yuv444 (``pack_inputs_yuv444`` → ``run_yuv444``): luma, 256² chroma
  differences and a 4-bit green residual; rebuilt on the device in int32,
  bit-identical to the packed path.

``run_stream`` runs any of the four over an iterator of batches with the
upload of batch i+1 under the compute of batch i.

On a mesh (``Engine(mesh=…)``, ``parallel/mesh.py``) each process runs its
rows of the batch, padded to a multiple of the ranks, and ``host_gather``
hands every rank the whole batch's outputs (a mesh of one process keeps
them on its device).  ``run_stream`` never splits: each process streams
its own whole batches.

PyTorch runs eagerly, so there is no compiled program: the pipeline is
``_pipeline_core`` called under ``torch.inference_mode`` with TF32 off
(``utils.full_f32``), which keeps every float32 stage in full float32.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch
from torch import nn

from chessvision_tpu_torch import constants
from chessvision_tpu_torch.chessboard import labels_to_fen
from chessvision_tpu_torch.cv_types import BatchResult, ValidationFix
from chessvision_tpu_torch.ops import gridfix
from chessvision_tpu_torch.ops.color import bgr_to_gray, hflip, round_u8
from chessvision_tpu_torch.ops.quad import find_quadrangle_batch, scale_quadrangle
from chessvision_tpu_torch.ops.resize import resize
from chessvision_tpu_torch.ops.squares import extract_squares_batch
from chessvision_tpu_torch.ops.warp import get_perspective_transform, warp_perspective
from chessvision_tpu_torch.parallel import mesh as mesh_lib
from chessvision_tpu_torch.utils import full_f32, host_tensor, resolve_device

_BOARD_W, _BOARD_H = constants.BOARD_SIZE
_INPUT_HW = (constants.INPUT_SIZE[1], constants.INPUT_SIZE[0])
# destination corners of the rectified board: (w, h), not (w-1, h-1)
_DEST = np.array([[0.0, 0.0], [_BOARD_W, 0.0], [_BOARD_W, _BOARD_H], [0.0, _BOARD_H]], np.float32)

# sigmoid width of the original↔refined probability blend (arbitrate)
_ARBITRATE_TAU = 0.01

# Boards per chunk of the arbitrate tail (correction resample + two
# classifier passes + blend) on each rank, which bounds the ResNet's live
# activations (64 crops a board; bf16 conv outputs and the float32 stem
# and block outputs that bn_act writes).  The JAX package chunks at 128
# for a 16 GB TPU; on an 80 GB H100 a chunk of 512 boards peaks below the
# UNet of a 1024-frame batch (tools/memory_peaks, recorded in PERF.md).
# CVTPU_ARBITRATE_CHUNK sets it for an Engine built without
# ``arbitrate_chunk``.
_ARBITRATE_CHUNK = 512

# margin (px) of the warp canvas in refine modes: the board warps into a
# (512 + 2m)² canvas and the interior [m, m + 512)² is the nominal board
# (0: the board itself).  CVTPU_REFINE_MARGIN sets it when the module is
# imported, as in the JAX package.
_REFINE_MARGIN = int(os.getenv("CVTPU_REFINE_MARGIN", "32"))

# missing-king promotion floor of validate_labels_batch rule 3
_MISSING_KING_FLOOR = 0.05


def preprocess_images(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 (B, H, W, 3) BGR frames → (comp, gray), both uint8: the exact
    area resize to the segmentation input and the exact fixed-point gray."""
    comp = resize(images, _INPUT_HW, round_uint8=True)
    gray = bgr_to_gray(images, exact_u8=True)
    return comp, gray


# BT.601 luma weights of the fixed-point gray (ops/color.py):
# gray = (LR·R + LG·G + LB·B + 2^14) >> 15 with LR + LG + LB = 2^15 exactly,
# the identity the yuv444 reconstruction inverts in int32
_LUMA_R_I, _LUMA_G_I, _LUMA_B_I = 9798, 19235, 3735
_LUMA_R = _LUMA_R_I / 32768.0
_LUMA_G = _LUMA_G_I / 32768.0
_LUMA_B = _LUMA_B_I / 32768.0


def reconstruct_comp_yuv(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Device half of the yuv codec: (B, 256, 256, 3) float32 BGR input of
    the segmenter from (B, H, W) uint8 luma and (B, 128, 128) uint8 chroma
    differences (offset 128).  Luma is area-resized, chroma bilinearly
    upsampled (the float32 matmul path, TF32 off under ``full_f32``), green
    solved from the luma equation; rounded half up and clipped as a uint8
    round trip would."""
    y256 = resize(y.float(), _INPUT_HW)
    cb256 = resize(cb, _INPUT_HW) - 128.0
    cr256 = resize(cr, _INPUT_HW) - 128.0
    b256 = y256 + cb256
    r256 = y256 + cr256
    g256 = (y256 - _LUMA_R * r256 - _LUMA_B * b256) / _LUMA_G
    comp = torch.stack([b256, g256, r256], dim=-1)
    return torch.clamp(torch.floor(comp + 0.5), 0.0, 255.0)


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def reconstruct_comp_yuv444(
    y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, gres: torch.Tensor
) -> torch.Tensor:
    """Device half of the yuv444 codec: (B, 256, 256, 3) float32 comp, bit
    for bit the comp that ``pack_inputs_yuv444`` started from wherever the
    chroma differences fit int8 and the green residual int4.  Pure int32:
    every division is a floor division of possibly negative numerators."""
    bsz, h, w = y.shape
    ih, iw = _INPUT_HW
    fh, fw = h // ih, w // iw
    f2 = fh * fw
    # area sum of each luma block: ≤ f2·255
    sum4 = y.to(torch.int32).reshape(bsz, ih, fh, iw, fw).sum(dim=(2, 4), dtype=torch.int32)
    y256r = _floor_div(2 * sum4 + f2, 2 * f2)  # round-half-up of sum4 / f2
    b256 = y256r + (cb.to(torch.int32) - 128)
    r256 = y256r + (cr.to(torch.int32) - 128)
    # G predicted from the luma identity anchored on the rounded luma:
    # n = y256r·2^15 − LR·r − LB·b (|n| < 2^24), g ≈ n / LG rounded half up
    n = (y256r << 15) - _LUMA_R_I * r256 - _LUMA_B_I * b256
    g_pred = torch.clamp(_floor_div(2 * n + _LUMA_G_I, 2 * _LUMA_G_I), 0, 255)
    gi = gres.to(torch.int32)
    e = torch.stack([gi & 15, (gi >> 4) & 15], dim=-1).reshape(bsz, ih, iw)
    g256 = torch.clamp(g_pred + (e - 8), 0, 255)
    comp = torch.stack([b256, g256, r256], dim=-1).float()
    return torch.clamp(comp, 0.0, 255.0)


def _yuv_block_factors(gray: np.ndarray) -> tuple[int, int]:
    """The (fh, fw) block factors of a frame for YUV packing; raises a
    ``ValueError`` unless its dims are multiples of the segmentation input
    size.  Every pack path goes through this guard, so a wrong size fails
    on the host and not as a reshape error on the device."""
    ih, iw = _INPUT_HW
    h, w = gray.shape[1:3]
    if h % ih or w % iw:
        raise ValueError(
            f"YUV packing needs frame dims divisible by {constants.INPUT_SIZE} "
            f"(w, h); got {(w, h)} — use pack_inputs/the raw path for this size"
        )
    return h // ih, w // iw


def _luma_block_sums(gray: np.ndarray) -> tuple[np.ndarray, int]:
    """(B, 256, 256) int32 area-block sums of the full-resolution luma and
    the block's pixel count f2: the integer base that host and device
    share in the yuv444 reconstruction."""
    ih, iw = _INPUT_HW
    fh, fw = _yuv_block_factors(gray)
    # accumulate in int32 without an upcast copy of the full-res plane
    s = gray.reshape(len(gray), ih, fh, iw, fw).sum((2, 4), dtype=np.int32)
    return s, fh * fw


def pack_inputs_yuv444(images: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host packing for ``run_yuv444``: full-resolution fixed-point gray,
    256² chroma differences against the rounded luma downsample (offset
    128, clipped to int8) and the 4-bit green residual plane, two per
    byte.  The host mirrors the device's integer reconstruction, so the
    residual it stores is the one the device needs.  The native loader's
    fused packer (``native_loader.pack_yuv444``, one pass) runs where the
    library builds; it is bit-identical to the numpy below."""
    comp, gray = pack_inputs(images)
    _yuv_block_factors(gray)  # the guard runs before either packer
    from chessvision_tpu_torch import native_loader

    if native_loader.has_pack_yuv444():
        cb, cr, gres = native_loader.pack_yuv444(comp, gray)
        return gray, cb, cr, gres
    return (gray, *_pack_yuv444_numpy(comp, gray))


def _pack_yuv444_numpy(comp: np.ndarray, gray: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cb, cr, gres) of ``pack_inputs_yuv444`` in numpy."""
    fh, fw = _yuv_block_factors(gray)
    y256r = None
    if (fh, fw) == (2, 2):
        # cv2's integer INTER_AREA equals round-half-up of the block mean
        # only at factor 2; other factors take the block sums below
        try:
            import cv2

            y256r = np.stack(
                [cv2.resize(g, constants.INPUT_SIZE, interpolation=cv2.INTER_AREA) for g in gray]
            ).astype(np.int16)
        except ImportError:
            pass
    if y256r is None:
        sum4, f2 = _luma_block_sums(gray)
        y256r = ((2 * sum4 + f2) // (2 * f2)).astype(np.int16)
    # int16 throughout the small-range stages
    cb_c = np.clip(comp[..., 0].astype(np.int16) - y256r, -128, 127)
    cr_c = np.clip(comp[..., 2].astype(np.int16) - y256r, -128, 127)
    cb = (cb_c + 128).astype(np.uint8)
    cr = (cr_c + 128).astype(np.uint8)
    # G prediction without materializing B/R: with b = y256r + cb_c and
    # r = y256r + cr_c, the device's n = (y256r << 15) − LR·r − LB·b equals
    # LG·y256r + m with m = −LR·cr_c − LB·cb_c, so its round-half-up
    # quotient is y256r + floor((2m + LG) / 2LG).  The float32 quotient is
    # exact to the floor: |2m + LG| < 2^22 (exact in float32), true
    # quotients are ≥ 1/LG ≈ 5e-5 from any integer they do not attain, and
    # the float32 error is ≤ ~6e-6.
    m2 = cr_c * np.float32(-2.0 * _LUMA_R_I) + cb_c * np.float32(-2.0 * _LUMA_B_I)
    adj = np.floor((m2 + np.float32(_LUMA_G_I)) / np.float32(2 * _LUMA_G_I))
    g_pred = np.clip(y256r + adj, 0, 255)
    resid = comp[..., 1].astype(np.int16) - g_pred
    e = (np.clip(resid, -8, 7) + 8).astype(np.uint8)  # (B, 256, 256) in [0, 15]
    gres = (e[..., 0::2] | (e[..., 1::2] << 4)).astype(np.uint8)  # (B, 256, 128)
    return cb, cr, gres


def pack_inputs_yuv(images: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host packing for ``run_yuv``: full-resolution fixed-point gray plus
    2×-subsampled chroma differences of the segmentation input (Cb = B − Y,
    Cr = R − Y, offset-128 uint8, (B, 128, 128)).  The subsampled
    difference is pure integer arithmetic: round-half-up of
    (4·f2·ΣB − 4·ΣS) / (16·f2) over each 2×2 block, with ΣB the block sum
    of the comp channel and ΣS that of the luma block sums, so the native
    loader's packer (used where the library builds) is bit-identical."""
    comp, gray = pack_inputs(images)
    _yuv_block_factors(gray)
    from chessvision_tpu_torch import native_loader

    if native_loader.has_pack_yuv420():
        cb, cr = native_loader.pack_yuv420(comp, gray)
        return gray, cb, cr
    return (gray, *_pack_yuv420_numpy(comp, gray))


def _pack_yuv420_numpy(comp: np.ndarray, gray: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cb, cr) of ``pack_inputs_yuv`` in numpy."""
    ih, iw = _INPUT_HW
    th, tw = ih // 2, iw // 2
    b = len(comp)
    sum4, f2 = _luma_block_sums(gray)
    s_l = sum4.reshape(b, th, 2, tw, 2).sum((2, 4), dtype=np.int32)  # ΣS ≤ 4·f2·255
    out = []
    for ch in (0, 2):
        s_c = comp[..., ch].reshape(b, th, 2, tw, 2).sum((2, 4), dtype=np.int32)  # ΣB ≤ 1020
        # mean diff = ΣB/4 − ΣS/(4·f2), rounded half up by integer floor division
        num = 2 * (s_c * f2 - s_l) + 4 * f2
        d = num // (8 * f2)
        out.append(np.clip(d + 128, 0, 255).astype(np.uint8))
    return out[0], out[1]


def pack_inputs(images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host packing for ``run_packed``: exact INTER_AREA 256×256 resize and
    fixed-point gray, by cv2 when it imports and in numpy otherwise.  The
    two are bit-equal on 512² frames; at larger integer factors cv2's
    INTER_AREA rounds some pixels otherwise than the block mean."""
    try:
        import cv2
    except ImportError:
        b = images.astype(np.int32)
        gray = ((b[..., 2] * _LUMA_R_I + b[..., 1] * _LUMA_G_I + b[..., 0] * _LUMA_B_I + (1 << 14)) >> 15).astype(
            np.uint8
        )
        # integer-factor area mean, exact for divisible sizes; anything
        # else fails here rather than give a wrong geometry
        h, w = images.shape[1:3]
        tw, th = constants.INPUT_SIZE
        if h % th or w % tw:
            raise ValueError(
                f"pack_inputs numpy fallback needs frame dims divisible by "
                f"{constants.INPUT_SIZE}; got {(h, w)} — install cv2 or resize on host first"
            ) from None
        fh, fw = h // th, w // tw
        comp = images.reshape(len(images), th, fh, tw, fw, 3).mean((2, 4))
        return np.floor(comp + 0.5).astype(np.uint8), gray
    comp = np.stack([cv2.resize(im, constants.INPUT_SIZE, interpolation=cv2.INTER_AREA) for im in images])
    gray = np.stack([cv2.cvtColor(im, cv2.COLOR_BGR2GRAY) for im in images])
    return comp, gray


def _classify_squares(
    classifier: nn.Module, classifier_outputs_probabilities: bool, boards: torch.Tensor
) -> torch.Tensor:
    """(N, 512, 512) float32 post-flip boards → (N, 64, 13) float32 probs;
    the softmax runs in float32 whatever the model's dtype."""
    n = boards.shape[0]
    squares = extract_squares_batch(boards)
    cls_out = classifier(squares.reshape(n * 64, *constants.PIECE_SIZE, 1) / 255.0)
    probs = cls_out if classifier_outputs_probabilities else torch.softmax(cls_out.float(), dim=-1)
    return probs.reshape(n, 64, constants.NUM_CLASSES).float()


def _arbitrate_chunk(
    classifier: nn.Module,
    outputs_probabilities: bool,
    wide: torch.Tensor,
    corr: torch.Tensor,
    ms: torch.Tensor,
    margin: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Classify the nominal and the grid-corrected board and blend their
    probabilities by a sigmoid of the confidence gap; the board and quad
    go to the better side."""
    b0 = wide[:, margin : margin + _BOARD_H, margin : margin + _BOARD_W]
    b1 = gridfix.apply_correction(wide, corr, margin=margin)
    q1 = gridfix.refined_quadrangle(ms, corr)
    p0 = _classify_squares(classifier, outputs_probabilities, hflip(b0))
    p1 = _classify_squares(classifier, outputs_probabilities, hflip(b1))
    # mean top-1 probability over the 64 squares
    conf0 = p0.amax(dim=-1).mean(dim=-1)
    conf1 = p1.amax(dim=-1).mean(dim=-1)
    gap = conf1 - conf0
    wgt = torch.sigmoid(gap / _ARBITRATE_TAU)[:, None, None]
    probs = wgt * p1 + (1.0 - wgt) * p0
    use = gap > 0
    bsel = torch.where(use[:, None, None], b1, b0)
    return probs, bsel, q1, use


def _pipeline_core(
    extractor: nn.Module,
    classifier: nn.Module,
    classifier_outputs_probabilities: bool,
    comp_f32: torch.Tensor,  # (B, 256, 256, 3) float32 in [0, 255], BGR
    gray: torch.Tensor,  # (B, H, W) float32 full-res grayscale
    threshold: float,
    refine: str = "arbitrate",
    arbitrate_chunk: int | None = None,
) -> dict[str, torch.Tensor]:
    """Segmentation → quadrangle → warp → grid refinement → classify.

    ``refine``: "arbitrate" (classify the nominal and the grid-corrected
    board and blend), "detect" (always apply the detected correction) or
    "off" (the mask quad is final).  The arbitrate tail runs over chunks
    of ``arbitrate_chunk`` boards, one after the other."""
    chunk = _ARBITRATE_CHUNK if arbitrate_chunk is None else arbitrate_chunk
    margin = _REFINE_MARGIN
    b, h, _ = gray.shape
    dev = gray.device
    seg_logits = extractor(comp_f32 / 255.0)[..., 0].float()
    probs = torch.sigmoid(seg_logits)
    quad, found = find_quadrangle_batch(probs, threshold)
    quad_scaled = scale_quadrangle(quad, float(h), constants.INPUT_SIZE[1])
    dest = torch.from_numpy(_DEST).to(dev)
    safe_quad = torch.where(found[:, None, None], quad_scaled, dest)
    ms = get_perspective_transform(safe_quad, dest.expand(b, 4, 2))

    if refine == "off":
        boards_sel = warp_perspective(gray, ms, constants.BOARD_SIZE)
        quad_out = quad_scaled
        cls_probs = _classify_squares(classifier, classifier_outputs_probabilities, hflip(boards_sel))
    else:
        ms_wide = get_perspective_transform(safe_quad, (dest + float(margin)).expand(b, 4, 2))
        wide = warp_perspective(gray, ms_wide, (_BOARD_W + 2 * margin, _BOARD_H + 2 * margin))
        boards0 = wide[:, margin : margin + _BOARD_H, margin : margin + _BOARD_W]
        # detection sees the uint8-rounded board
        rounded = torch.clamp(torch.floor(boards0 + 0.5), 0, 255)
        corr = gridfix.detect_grid(rounded)
        if refine == "detect":
            boards_sel = gridfix.apply_correction(wide, corr, margin=margin)
            quad_out = gridfix.refined_quadrangle(ms, corr)
            cls_probs = _classify_squares(classifier, classifier_outputs_probabilities, hflip(boards_sel))
        else:
            # an empty batch is one chunk of no rows, so the outputs keep
            # the shapes and dtypes a chunk gives
            parts = [
                _arbitrate_chunk(
                    classifier,
                    classifier_outputs_probabilities,
                    wide[i : i + chunk],
                    corr[i : i + chunk],
                    ms[i : i + chunk],
                    margin,
                )
                for i in range(0, b, chunk) or (0,)
            ]
            cls_probs, boards_sel, quad1, use = (torch.cat(t, dim=0) for t in zip(*parts))
            quad_out = torch.where(use[:, None, None], quad1, quad_scaled)

    return {
        "logits": seg_logits,
        "quadrangle": quad_out,
        "found": found,
        "board_image": round_u8(hflip(boards_sel)),
        "probabilities": cls_probs,
    }


def validate_labels_batch(
    probabilities: np.ndarray,  # (B, 64, 13)
    square_names: list[str],
) -> tuple[list[list[str]], list[list[ValidationFix]]]:
    """Host-side chess-rule validation.

    Rule 1 — no pawns on the back ranks → next-best non-pawn.
    Rule 2 — one king per color: keep the most probable king, demote the
    rest to their next-best non-king (non-pawn on back-rank squares).
    Rule 3 — every color has a king: a color with none promotes its most
    king-probable square if that probability clears the floor, never
    displacing the other king or a square rules 1–2 already fixed.
    """
    b = probabilities.shape[0]
    preds = np.argmax(probabilities, axis=-1)  # (B, 64)
    labels = np.asarray(constants.LABEL_NAMES, dtype=object)[preds]

    pawn_idx = {constants.LABEL_INDICES["P"], constants.LABEL_INDICES["p"]}
    king_idx = {constants.LABEL_INDICES["K"], constants.LABEL_INDICES["k"]}
    invalid_rows = [i for i, name in enumerate(square_names) if name in constants.INVALID_PAWN_SQUARES]
    back_rank = set(invalid_rows)

    all_labels: list[list[str]] = []
    all_fixes: list[list[ValidationFix]] = []
    order = np.argsort(-probabilities[:, invalid_rows, :], axis=-1)  # (B, 16, 13)
    for bi in range(b):
        row_labels = list(labels[bi])
        fixes: list[ValidationFix] = []
        for ii, sq in enumerate(invalid_rows):
            if preds[bi, sq] in pawn_idx:
                for alt in order[bi, ii]:
                    if int(alt) not in pawn_idx:
                        alt_piece = constants.LABEL_NAMES[int(alt)]
                        fixes.append(ValidationFix(square_names[sq], row_labels[sq], alt_piece, "no_pawns_on_ends"))
                        row_labels[sq] = alt_piece
                        break
        for king in ("K", "k"):
            ki = constants.LABEL_INDICES[king]
            claimants = [sq for sq in range(64) if row_labels[sq] == king]
            if len(claimants) <= 1:
                continue
            claimants.sort(key=lambda sq: -float(probabilities[bi, sq, ki]))
            for sq in claimants[1:]:
                banned = king_idx | (pawn_idx if sq in back_rank else set())
                for alt in np.argsort(-probabilities[bi, sq]):
                    if int(alt) not in banned:
                        alt_piece = constants.LABEL_NAMES[int(alt)]
                        fixes.append(ValidationFix(square_names[sq], king, alt_piece, "one_king_per_color"))
                        row_labels[sq] = alt_piece
                        break
        touched = {f.square_name for f in fixes}
        for king, other in (("K", "k"), ("k", "K")):
            ki = constants.LABEL_INDICES[king]
            if any(lab == king for lab in row_labels):
                continue
            for sq in map(int, np.argsort(-probabilities[bi, :, ki])):
                if float(probabilities[bi, sq, ki]) < _MISSING_KING_FLOOR:
                    break
                if row_labels[sq] == other or square_names[sq] in touched:
                    continue
                fixes.append(ValidationFix(square_names[sq], row_labels[sq], king, "missing_king"))
                row_labels[sq] = king
                break
        all_labels.append(row_labels)
        all_fixes.append(fixes)
    return all_labels, all_fixes


def _copy_back(out: dict[str, torch.Tensor], keys: Sequence[str]) -> dict[str, np.ndarray]:
    """The named device outputs as host numpy arrays (waits for the device)."""
    return {k: out[k].cpu().numpy() for k in keys}


def _binary_mask(logits: np.ndarray, threshold: float) -> np.ndarray:
    """Host-side threshold mask of the segmentation logits, uint8 in {0, 255}."""
    with np.errstate(over="ignore"):
        probs_mask = 1.0 / (1.0 + np.exp(-logits, dtype=np.float32))
    return np.where(probs_mask > threshold, np.uint8(255), np.uint8(0))


def _fen_strings(
    probs: np.ndarray, validated: list[list[str]], found: np.ndarray, square_names: list[str]
) -> tuple[list[str], list[str]]:
    """(validated FENs, argmax FENs) of a batch; "" where no board was found."""
    labels = np.asarray(constants.LABEL_NAMES, dtype=object)[np.argmax(probs, axis=-1)]
    fens: list[str] = []
    original_fens: list[str] = []
    for bi in range(len(found)):
        if not found[bi]:
            original_fens.append("")
            fens.append("")
            continue
        original_fens.append(labels_to_fen(list(labels[bi]), square_names))
        fens.append(labels_to_fen(validated[bi], square_names))
    return fens, original_fens


class _StreamUploader:
    """Host→device uploads for ``Engine.run_stream``.

    On CUDA each field of a batch has two pinned staging buffers, used in
    turn.  ``put`` copies the host array into the free one (a copy from
    pageable memory would make the upload synchronous), enqueues
    ``copy_(non_blocking=True)`` on a copy stream and records an event
    after it.  The event does two jobs: ``take`` makes the compute stream
    wait on it before the batch is used, and the next ``put`` into the same
    buffer waits on it on the host, so a buffer is never overwritten while
    its copy is in flight.  On the CPU ``put`` only wraps the arrays."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(device)
            self._slots: list[dict[int, torch.Tensor]] = [{}, {}]
            self._events: list[torch.cuda.Event | None] = [None, None]
            self._turn = 0

    def put(self, fields: Sequence[Any]) -> tuple[list[torch.Tensor], Any]:
        """Start the upload of one batch's fields; returns the tensors on
        the device and the event that follows their copies (None on the
        CPU)."""
        tensors = [host_tensor(a) for a in fields]
        if not self._cuda:
            return tensors, None
        turn, self._turn = self._turn, 1 - self._turn
        if self._events[turn] is not None:
            self._events[turn].synchronize()
        staged = []
        # on this engine's card throughout: the pinned buffers go through its
        # context, and ``torch.cuda.stream`` entered from another current
        # card switches back to that card on exit, which opens a context there
        with torch.cuda.device(self.device):
            for i, t in enumerate(tensors):
                buf = self._slots[turn].get(i)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    self._slots[turn][i] = buf
                buf.copy_(t)
                staged.append(buf)
            with torch.cuda.stream(self._copy_stream):
                on_device = [t.to(self.device, non_blocking=True) for t in staged]
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        self._events[turn] = event
        return on_device, event

    def take(self, upload: tuple[list[torch.Tensor], Any]) -> list[torch.Tensor]:
        """Make the current stream wait for an upload that ``put`` started,
        and tell the allocator that its tensors are used on that stream."""
        on_device, event = upload
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in on_device:
                t.record_stream(compute)
        return on_device


class Engine:
    """Batched image→FEN engine on one device, or over a mesh of processes.

    ``extractor`` maps (B, 256, 256, 3) float inputs in [0, 1] to
    (B, 256, 256, 1) logits; ``classifier`` maps (N, 64, 64, 1) squares to
    (N, 13) logits (or probabilities).  Both are moved to ``device``
    ("cuda" by default; with no GPU, only an explicit "cpu" runs), or to
    the mesh's device.  ``refine_grid`` None reads ``CVTPU_REFINE``
    ("arbitrate" when unset).  ``arbitrate_chunk`` counts boards of the
    whole batch: None gives each rank a chunk of ``CVTPU_ARBITRATE_CHUNK``
    boards, or of 512 when unset, and each rank chunks its own rows."""

    def __init__(
        self,
        extractor: nn.Module,
        classifier: nn.Module,
        *,
        classifier_outputs_probabilities: bool = False,
        refine_grid: str | None = None,
        arbitrate_chunk: int | None = None,
        device: str | torch.device = "cuda",
        mesh: mesh_lib.Mesh | None = None,
    ) -> None:
        if refine_grid is None:
            refine_grid = os.getenv("CVTPU_REFINE", "arbitrate")
        if refine_grid not in ("arbitrate", "detect", "off"):
            raise ValueError(f"unknown refine_grid mode {refine_grid!r}")
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self._refine = refine_grid
        n = mesh.size if mesh is not None else 1
        if arbitrate_chunk is None:
            env_chunk = os.getenv("CVTPU_ARBITRATE_CHUNK")
            arbitrate_chunk = (int(env_chunk) if env_chunk else _ARBITRATE_CHUNK) * n
        # each rank chunks its own rows
        self._arbitrate_chunk = max(1, arbitrate_chunk // n)
        self._extractor = mesh_lib.replicate(mesh, extractor.to(self.device)).eval()
        self._classifier = mesh_lib.replicate(mesh, classifier.to(self.device)).eval()
        self._cls_probs_flag = classifier_outputs_probabilities

    def _back_half(self, comp_f32: torch.Tensor, gray_f32: torch.Tensor, threshold: float) -> dict[str, torch.Tensor]:
        """Everything after the input format: the one back half that every
        entry point feeds (call under inference_mode and full_f32)."""
        return _pipeline_core(
            self._extractor,
            self._classifier,
            self._cls_probs_flag,
            comp_f32,
            gray_f32,
            float(threshold),
            self._refine,
            self._arbitrate_chunk,
        )

    def _on_device(self, *arrays: Any) -> list[torch.Tensor]:
        return [host_tensor(a).to(self.device) for a in arrays]

    def run_device(self, images: np.ndarray | torch.Tensor, threshold: float = 0.5) -> dict[str, Any]:
        """Run the pipeline on (B, H, W, 3) uint8 frames (numpy or a tensor
        on any device); returns tensors on the engine's device (no host
        sync).  The front half makes the packed inputs on the device and
        hands them to ``run_packed``, so raw and packed inference are
        bit-identical.

        On a mesh every rank passes the same whole batch; it is padded in
        torch to a multiple of the ranks and each rank uploads and runs its
        rows.  On a mesh of one process the outputs stay tensors on the
        device; on a mesh that spans processes they come back gathered from
        every rank as host numpy, on every rank (as the JAX package's do)."""
        if self.mesh is not None:
            padded, orig = mesh_lib.pad_to_multiple(host_tensor(images), self.mesh.size)
            out = self._run_device(mesh_lib.local_rows(self.mesh, padded), threshold)
            if mesh_lib.spans_processes(self.mesh):
                out = mesh_lib.host_gather(self.mesh, out)
            return {k: v[:orig] for k, v in out.items()}
        return self._run_device(images, threshold)

    def _run_device(self, images: np.ndarray | torch.Tensor, threshold: float) -> dict[str, torch.Tensor]:
        with torch.inference_mode(), full_f32():
            comp, gray = preprocess_images(*self._on_device(images))
        return self.run_packed(comp, gray, threshold)

    def run_packed(self, comp: Any, gray: Any, threshold: float = 0.5) -> dict[str, torch.Tensor]:
        """Run the pipeline on host-prepared inputs from ``pack_inputs``:
        (B, 256, 256, 3) uint8 resized BGR and (B, H, W) uint8 gray."""
        with torch.inference_mode(), full_f32():
            comp, gray = self._on_device(comp, gray)
            return self._back_half(comp.float(), gray.float(), threshold)

    def run_yuv(self, y: Any, bc: Any, rc: Any, threshold: float = 0.5) -> dict[str, torch.Tensor]:
        """Run the pipeline on inputs from ``pack_inputs_yuv`` (see
        ``reconstruct_comp_yuv``).  Warp and classification see the exact
        luma, so boards and geometry given a mask are those of the packed
        path; only the segmenter's color input is approximate."""
        with torch.inference_mode(), full_f32():
            y, bc, rc = self._on_device(y, bc, rc)
            return self._back_half(reconstruct_comp_yuv(y, bc, rc), y.float(), threshold)

    def run_yuv444(self, y: Any, cb: Any, cr: Any, gres: Any, threshold: float = 0.5) -> dict[str, torch.Tensor]:
        """Run the pipeline on inputs from ``pack_inputs_yuv444`` (see
        ``reconstruct_comp_yuv444``): bit-identical to the packed path."""
        with torch.inference_mode(), full_f32():
            y, cb, cr, gres = self._on_device(y, cb, cr, gres)
            return self._back_half(reconstruct_comp_yuv444(y, cb, cr, gres), y.float(), threshold)

    def run_stream(
        self, batches: Iterable[Any], threshold: float = 0.5, kind: str = "raw"
    ) -> Iterator[dict[str, torch.Tensor]]:
        """Pipelined streaming inference: upload batch i+1 while batch i
        computes.  Yields the device output dicts in order, without a host
        sync.

        ``kind`` is the format of each element of ``batches``: "raw" —
        (B, H, W, 3) uint8 frames; "packed" — (comp, gray) from
        ``pack_inputs``; "yuv" — (y, bc, rc) from ``pack_inputs_yuv``;
        "yuv444" — (y, cb, cr, gres) from ``pack_inputs_yuv444``.

        Each round dispatches batch i first (eager kernels are enqueued
        and the host runs ahead), then draws batch i+1 from the iterator
        and starts its upload, then yields batch i's outputs: when
        ``batches`` is a generator that packs on demand, both the packing
        and the upload of batch i+1 lie under batch i's compute.  On CUDA
        the upload goes through pinned staging buffers on a copy stream
        (``_StreamUploader``); on the CPU it is the same loop with plain
        tensors."""
        # the raw kind runs the mesh-free path, as the JAX stream runs its
        # unsharded program: every process streams its own whole batches
        run: Callable[..., dict[str, torch.Tensor]] | None = {
            "raw": self._run_device,
            "packed": self.run_packed,
            "yuv": self.run_yuv,
            "yuv444": self.run_yuv444,
        }.get(kind)
        if run is None:
            raise ValueError(f"unknown stream kind {kind!r}")
        uploader = _StreamUploader(self.device)
        it = iter(batches)

        def put(element: Any) -> tuple[list[torch.Tensor], Any]:
            return uploader.put((element,) if kind == "raw" else tuple(element))

        try:
            current = put(next(it))
        except StopIteration:
            return
        while True:
            out = run(*uploader.take(current), threshold)
            nxt = next(it, None)
            pending = put(nxt) if nxt is not None else None
            yield out
            if pending is None:
                return
            current = pending

    def process_batch(
        self,
        images: np.ndarray,
        threshold: float = 0.5,
        flip: bool = False,
        lite: bool = False,
        include_board: bool = False,
    ) -> BatchResult:
        """Full image→FEN over a uniform-shape batch (B, H, W, 3) uint8.

        ``lite=True`` copies back only found/quadrangle/probabilities (and
        the board with ``include_board``); logits, mask and board come back
        empty.  On a mesh ``lite`` takes the full path, as in the JAX
        package, and every rank gets the whole batch's result."""
        out = self.run_device(images, threshold)
        b = images.shape[0]
        if mesh_lib.spans_processes(self.mesh):
            host = dict(out)  # gathered to the host already
            host["binary_mask"] = _binary_mask(host["logits"], threshold)
        elif lite and self.mesh is None:
            keep = ("found", "quadrangle", "probabilities") + (("board_image",) if include_board else ())
            host = _copy_back(out, keep)
            host["logits"] = np.zeros((b, 0, 0), np.float32)
            host["binary_mask"] = np.zeros((b, 0, 0), np.uint8)
            host.setdefault("board_image", np.zeros((b, 0, 0), np.uint8))
        else:
            host = _copy_back(out, tuple(out))
            host["binary_mask"] = _binary_mask(host["logits"], threshold)

        square_names = constants.SQUARE_NAMES_FLIPPED if flip else constants.SQUARE_NAMES_NORMAL
        probs = host["probabilities"]
        found = host["found"]
        validated, fixes = validate_labels_batch(probs, square_names)
        fens, original_fens = _fen_strings(probs, validated, found, square_names)

        return BatchResult(
            logits=host["logits"],
            binary_mask=host["binary_mask"],
            quadrangle=host["quadrangle"],
            board_found=found,
            board_image=host["board_image"],
            probabilities=probs,
            fens=fens,
            original_fens=original_fens,
            validation_fixes=[f if found[i] else [] for i, f in enumerate(fixes)],
            extra={"square_names": square_names},
        )

