"""The batched image→FEN engine on PyTorch.

Counterpart of ``chessvision_tpu/engine.py`` for the raw-frame path:
uint8 BGR frames → exact grayscale and area resize → UNet → sigmoid →
quadrangles → closed-form homographies → two-pass warp into a margin
canvas (kernel K1) → grid detection on the uint8-rounded board →
``refine`` tail → flip → uint8 board, all as tensors on one device; the
chess-rule validation and FEN assembly run on the host.

PyTorch runs eagerly, so there is no compiled program: the pipeline is
``_pipeline_core`` called under ``torch.inference_mode`` with TF32 off
(``utils.full_f32``), which keeps every float32 stage in full float32.
"""

from __future__ import annotations

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
from chessvision_tpu_torch.utils import full_f32, resolve_device

_BOARD_W, _BOARD_H = constants.BOARD_SIZE
_INPUT_HW = (constants.INPUT_SIZE[1], constants.INPUT_SIZE[0])
# destination corners of the rectified board: (w, h), not (w-1, h-1)
_DEST = np.array([[0.0, 0.0], [_BOARD_W, 0.0], [_BOARD_W, _BOARD_H], [0.0, _BOARD_H]], np.float32)

# sigmoid width of the original↔refined probability blend (arbitrate)
_ARBITRATE_TAU = 0.01

# Boards per chunk of the arbitrate tail (correction resample + two
# classifier passes + blend), which bounds the ResNet's live activations
# (64 crops a board; bf16 conv outputs plus float32 BatchNorm and ReLU
# outputs).  The JAX package chunks at 128 for a 16 GB TPU; an 80 GB H100
# runs the whole pipeline on 512 boards (peak memory: chip_smoke.py
# --profile, recorded in PERF.md).
_ARBITRATE_CHUNK = 512

# margin (px) of the warp canvas in refine modes: the board warps into a
# (512 + 2m)² canvas and the interior [m, m + 512)² is the nominal board
_REFINE_MARGIN = 32

# missing-king promotion floor of validate_labels_batch rule 3
_MISSING_KING_FLOOR = 0.05


def preprocess_images(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 (B, H, W, 3) BGR frames → (comp, gray), both uint8: the exact
    area resize to the segmentation input and the exact fixed-point gray."""
    comp = resize(images, _INPUT_HW, round_uint8=True)
    gray = bgr_to_gray(images, exact_u8=True)
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
            parts = [
                _arbitrate_chunk(
                    classifier,
                    classifier_outputs_probabilities,
                    wide[i : i + chunk],
                    corr[i : i + chunk],
                    ms[i : i + chunk],
                    margin,
                )
                for i in range(0, b, chunk)
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


class Engine:
    """Batched image→FEN engine on one device.

    ``extractor`` maps (B, 256, 256, 3) float inputs in [0, 1] to
    (B, 256, 256, 1) logits; ``classifier`` maps (N, 64, 64, 1) squares to
    (N, 13) logits (or probabilities).  Both are moved to ``device``
    ("cuda" by default; with no GPU, only an explicit "cpu" runs)."""

    def __init__(
        self,
        extractor: nn.Module,
        classifier: nn.Module,
        *,
        classifier_outputs_probabilities: bool = False,
        refine_grid: str = "arbitrate",
        arbitrate_chunk: int | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if refine_grid not in ("arbitrate", "detect", "off"):
            raise ValueError(f"unknown refine_grid mode {refine_grid!r}")
        self.device = resolve_device(device)
        self._refine = refine_grid
        self._arbitrate_chunk = _ARBITRATE_CHUNK if arbitrate_chunk is None else arbitrate_chunk
        self._extractor = extractor.to(self.device).eval()
        self._classifier = classifier.to(self.device).eval()
        self._cls_probs_flag = classifier_outputs_probabilities

    def run_device(self, images: np.ndarray | torch.Tensor, threshold: float = 0.5) -> dict[str, torch.Tensor]:
        """Run the pipeline on (B, H, W, 3) uint8 frames; returns tensors on
        the engine's device."""
        with torch.inference_mode(), full_f32():
            x = torch.as_tensor(images).to(self.device)
            comp, gray = preprocess_images(x)
            return _pipeline_core(
                self._extractor,
                self._classifier,
                self._cls_probs_flag,
                comp.float(),
                gray.float(),
                float(threshold),
                self._refine,
                self._arbitrate_chunk,
            )

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
        empty."""
        out = self.run_device(images, threshold)
        b = images.shape[0]
        if lite:
            keep = ("found", "quadrangle", "probabilities") + (("board_image",) if include_board else ())
            host = {k: out[k].cpu().numpy() for k in keep}
            host["logits"] = np.zeros((b, 0, 0), np.float32)
            host["binary_mask"] = np.zeros((b, 0, 0), np.uint8)
            host.setdefault("board_image", np.zeros((b, 0, 0), np.uint8))
        else:
            host = {k: v.cpu().numpy() for k, v in out.items()}
            with np.errstate(over="ignore"):
                probs_mask = 1.0 / (1.0 + np.exp(-host["logits"], dtype=np.float32))
            host["binary_mask"] = np.where(probs_mask > threshold, np.uint8(255), np.uint8(0))

        square_names = constants.SQUARE_NAMES_FLIPPED if flip else constants.SQUARE_NAMES_NORMAL
        probs = host["probabilities"]
        found = host["found"]
        labels = np.asarray(constants.LABEL_NAMES, dtype=object)[np.argmax(probs, axis=-1)]
        validated, fixes = validate_labels_batch(probs, square_names)
        original_fens: list[str] = []
        fens: list[str] = []
        for bi in range(b):
            if not found[bi]:
                original_fens.append("")
                fens.append("")
                continue
            original_fens.append(labels_to_fen(list(labels[bi]), square_names))
            fens.append(labels_to_fen(validated[bi], square_names))

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

