"""ChessVision: the single-image facade of the PyTorch port.

Counterpart of ``chessvision_tpu/core.py``: the same constructor and the
same seven public methods (``process_image``, ``extract_board``,
``classify_position``, ``process_board_extraction_logits``,
``process_position_probabilities``, ``extract_squares``,
``validate_position``), each dispatching to the batched engine.  For
throughput use ``ChessVision.engine.process_batch`` directly.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from chessvision_tpu_torch import constants, models
from chessvision_tpu_torch import weights as weights_mod
from chessvision_tpu_torch.checkpoint import load_variables
from chessvision_tpu_torch.chessboard import labels_to_fen
from chessvision_tpu_torch.cv_types import (
    BoardExtractionResult,
    ChessVisionResult,
    PositionResult,
    ValidationFix,
)
from chessvision_tpu_torch.engine import Engine, validate_labels_batch
from chessvision_tpu_torch.models.layers import set_compute_dtype
from chessvision_tpu_torch.ops.color import bgr_to_gray, create_binary_mask, hflip, round_u8
from chessvision_tpu_torch.ops.quad import find_quadrangle, scale_quadrangle
from chessvision_tpu_torch.ops.warp import get_perspective_transform, warp_perspective
from chessvision_tpu_torch.parallel.mesh import Mesh
from chessvision_tpu_torch.utils import full_f32, host_tensor, resolve_device

logger = logging.getLogger(__name__)

# architecture kwargs each model constructor takes from training_config
_ARCH_KEYS_BY_MODEL = {
    "unet": ("base", "bilinear"),
    "yolo": ("width",),
    "resnet18": ("width", "num_classes"),
}


def _arch_kwargs_from_metadata(metadata: dict, model_id: str) -> dict:
    cfg = metadata.get("training_config", {}) if metadata else {}
    return {k: cfg[k] for k in _ARCH_KEYS_BY_MODEL.get(model_id, ()) if k in cfg}


def build_model(
    kind: str,
    model_id: str | None,
    weights: str | None,
    dtype: torch.dtype,
    device: torch.device,
    model_kwargs: dict | None = None,
) -> tuple[nn.Module, models.ModelSpec]:
    """Build an extractor or classifier from an ``.npz`` checkpoint (its
    architecture from the checkpoint's ``training_config``), or with random
    weights from seed 0 when the file is absent; convolutions in ``dtype``."""
    create = models.create_extractor if kind == "extractor" else models.create_classifier
    model_id = model_id or ("unet" if kind == "extractor" else "resnet18")
    kwargs = dict(model_kwargs or {})
    variables = None
    if weights and Path(weights).exists():
        variables, metadata = load_variables(weights)
        kwargs = {**_arch_kwargs_from_metadata(metadata, model_id), **kwargs}
        logger.info("Loaded %s weights from %s", kind, weights)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module, spec = create(model_id, **kwargs)
    if variables is None:
        logger.warning("Weights not found at %s — random init for %s", weights, spec.model_id)
    else:
        module.load_state_dict(weights_mod.flax_to_torch(variables, module))
    return set_compute_dtype(module, dtype).to(device).eval(), spec


class ChessVision:
    """Chess position detection from images, on the GPU by default."""

    def __init__(
        self,
        board_extractor_weights: str | None = None,
        board_extractor_model_id: str | None = None,
        classifier_weights: str | None = None,
        classifier_model_id: str | None = None,
        lazy_load: bool = True,
        *,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
        mesh: Mesh | None = None,
        model_kwargs: dict | None = None,
        refine_grid: str | None = None,
    ) -> None:
        # on a mesh (``parallel.create_mesh``) the models live on this
        # process's device and the engine splits each batch over the ranks
        self._mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self._board_extractor: Any = None  # (module, spec)
        self._classifier: Any = None
        # explicit weights win; None means the model id's default
        self._board_extractor_weights = board_extractor_weights or (
            constants.BEST_YOLO_EXTRACTOR if board_extractor_model_id == "yolo" else constants.BEST_EXTRACTOR_WEIGHTS
        )
        self._board_extractor_model_id = board_extractor_model_id
        self._classifier_weights = classifier_weights or (
            constants.BEST_YOLO_CLASSIFIER if classifier_model_id == "yolo" else constants.BEST_CLASSIFIER_WEIGHTS
        )
        self._classifier_model_id = classifier_model_id
        self._dtype = dtype
        self._model_kwargs = model_kwargs or {}
        self._refine_grid = refine_grid  # None: the engine reads CVTPU_REFINE
        self._engine: Engine | None = None
        if not lazy_load:
            _ = self.board_extractor, self.classifier

    # -- model lifecycle --------------------------------------------------------

    @property
    def board_extractor(self) -> Any:
        if self._board_extractor is None:
            self._board_extractor = build_model(
                "extractor", self._board_extractor_model_id, self._board_extractor_weights,
                self._dtype, self.device, self._model_kwargs.get("extractor"),
            )
        return self._board_extractor

    @property
    def classifier(self) -> Any:
        if self._classifier is None:
            self._classifier = build_model(
                "classifier", self._classifier_model_id, self._classifier_weights,
                self._dtype, self.device, self._model_kwargs.get("classifier"),
            )
        return self._classifier

    @property
    def engine(self) -> Engine:
        """The batched engine (builds both models on first access)."""
        if self._engine is None:
            ex_mod, _ = self.board_extractor
            cl_mod, cl_spec = self.classifier
            self._engine = Engine(
                ex_mod,
                cl_mod,
                classifier_outputs_probabilities=cl_spec.outputs_probabilities,
                refine_grid=self._refine_grid,
                device=self.device,
                mesh=self._mesh,
            )
        return self._engine

    # -- public API (reference-compatible) ---------------------------------------

    def process_image(self, image: np.ndarray, threshold: float = 0.5, flip: bool = False) -> ChessVisionResult:
        """Process a raw BGR image into a validated FEN."""
        # the JAX facade's three checks, in its order and with its type and
        # messages; raised explicitly so that ``python -O`` keeps them
        if not isinstance(image, np.ndarray):
            raise AssertionError("Image must be a numpy array")
        if image.dtype != np.uint8:
            raise AssertionError("Image must be uint8")
        if len(image.shape) != 3:
            raise AssertionError("Image must be 3-dimensional (H,W,C)")
        start_time = time.time()
        result = self.engine.process_batch(image[None], threshold=threshold, flip=flip)
        found = bool(result.board_found[0])
        board_result = BoardExtractionResult(
            probabilities=result.logits[0],
            binary_mask=result.binary_mask[0],
            quadrangle=result.quadrangle[0] if found else None,
            board_image=result.board_image[0] if found else None,
        )
        position_result = None
        if found:
            position_result = PositionResult(
                fen=result.fens[0],
                original_fen=result.original_fens[0],
                model_probabilities=result.probabilities[0],
                squares=ChessVision.extract_squares(result.board_image[0]),
                square_names=result.extra["square_names"],
                validation_fixes=result.validation_fixes[0],
            )
        return ChessVisionResult(
            board_extraction=board_result,
            position=position_result,
            processing_time=time.time() - start_time,
        )

    def extract_board(self, image: np.ndarray, threshold: float = 0.5) -> BoardExtractionResult:
        """Extract the chessboard from a BGR image."""
        result = self.engine.process_batch(image[None], threshold=threshold)
        found = bool(result.board_found[0])
        return BoardExtractionResult(
            probabilities=result.logits[0],
            binary_mask=result.binary_mask[0],
            quadrangle=result.quadrangle[0] if found else None,
            board_image=result.board_image[0] if found else None,
        )

    def classify_position(self, board_image: np.ndarray, flip: bool = False) -> PositionResult:
        """Classify an extracted 512×512 grayscale board."""
        squares = ChessVision.extract_squares(board_image)
        square_names = constants.SQUARE_NAMES_FLIPPED if flip else constants.SQUARE_NAMES_NORMAL
        cl_mod, cl_spec = self.classifier
        with torch.inference_mode(), full_f32():
            batch = torch.as_tensor(squares, dtype=torch.float32, device=self.device) / 255.0
            out = cl_mod(batch)
            if not cl_spec.outputs_probabilities:
                out = torch.softmax(out.float(), dim=-1)
            probabilities = out.float().cpu().numpy()
        return ChessVision.process_position_probabilities(probabilities, square_names, squares)

    def process_board_extraction_logits(
        self, logits: np.ndarray, orig_image: np.ndarray, threshold: float
    ) -> BoardExtractionResult:
        """Geometry stages from precomputed segmentation logits."""
        with torch.inference_mode(), full_f32():
            probs = torch.sigmoid(host_tensor(logits, dtype=torch.float32, device=self.device))
            binary_mask = create_binary_mask(probs, threshold).cpu().numpy()
            quad, found = find_quadrangle(probs, threshold)
            if not bool(found):
                return BoardExtractionResult(
                    probabilities=logits, binary_mask=binary_mask, quadrangle=None, board_image=None
                )
            scaled = scale_quadrangle(quad, float(orig_image.shape[0]))
            dest = torch.tensor(
                [[0.0, 0.0], [512.0, 0.0], [512.0, 512.0], [0.0, 512.0]], device=self.device
            )
            m = get_perspective_transform(scaled, dest)
            gray = bgr_to_gray(host_tensor(orig_image, device=self.device).float())
            board = hflip(warp_perspective(gray, m, constants.BOARD_SIZE))
            return BoardExtractionResult(
                probabilities=logits,
                binary_mask=binary_mask,
                quadrangle=scaled.cpu().numpy(),
                board_image=round_u8(board).cpu().numpy(),
            )

    @staticmethod
    def process_position_probabilities(
        probabilities: np.ndarray, square_names: list[str], square_crops: np.ndarray
    ) -> PositionResult:
        """Probabilities → validated position."""
        pred_labels = [constants.LABEL_NAMES[p] for p in np.argmax(probabilities, axis=1)]
        validated_labels, fixes = ChessVision.validate_position(list(pred_labels), probabilities, square_names)
        return PositionResult(
            fen=labels_to_fen(validated_labels, square_names),
            original_fen=labels_to_fen(pred_labels, square_names),
            model_probabilities=probabilities,
            squares=square_crops,
            square_names=square_names,
            validation_fixes=fixes,
        )

    @staticmethod
    def extract_squares(board: np.ndarray) -> np.ndarray:
        """(512, 512) board → (64, 64, 64, 1) squares, rank-major."""
        h, w = board.shape
        sh, sw = h // 8, w // 8
        return board.reshape(8, sh, 8, sw).transpose(0, 2, 1, 3).reshape(64, sh, sw, 1)

    @staticmethod
    def validate_position(
        pred_labels: list[str], probabilities: np.ndarray, square_names: list[str]
    ) -> tuple[list[str], list[ValidationFix]]:
        """Chess-rule validation of one position (see
        ``engine.validate_labels_batch``)."""
        validated, fixes = validate_labels_batch(probabilities[None], square_names)
        out = list(pred_labels)
        for i, lab in enumerate(validated[0]):
            out[i] = lab
        return out, fixes[0]
