"""Model registry of the port (counterpart of
``chessvision_tpu/models/__init__.py``): extractor ids ``unet`` and
``yolo``, classifier ids ``resnet18`` and ``yolo``, each with the contract
flags the engine reads; and the port's own extractor id ``yolo11_seg``
(Ultralytics' YOLO11-seg, which the JAX package has not)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from torch import nn

from chessvision_tpu_torch.models.resnet import ResNet, resnet18
from chessvision_tpu_torch.models.unet import UNet
from chessvision_tpu_torch.models.yolo import YoloCls, YoloSeg
from chessvision_tpu_torch.models.yolo11_seg import YOLO11Seg

__all__ = [
    "UNet",
    "ResNet",
    "resnet18",
    "YoloCls",
    "YoloSeg",
    "YOLO11Seg",
    "ModelSpec",
    "EXTRACTORS",
    "CLASSIFIERS",
    "create_extractor",
    "create_classifier",
]


@dataclass(frozen=True)
class ModelSpec:
    model_id: str
    build: Callable[..., nn.Module]
    input_size: tuple[int, int]
    in_channels: int
    outputs_probabilities: bool = False


EXTRACTORS: dict[str, ModelSpec] = {
    "unet": ModelSpec("unet", lambda **kw: UNet(**kw), (256, 256), 3),
    "yolo": ModelSpec("yolo", lambda **kw: YoloSeg(**kw), (256, 256), 3),
    "yolo11_seg": ModelSpec("yolo11_seg", lambda **kw: YOLO11Seg(**kw), (256, 256), 3),
}

CLASSIFIERS: dict[str, ModelSpec] = {
    "resnet18": ModelSpec("resnet18", lambda **kw: resnet18(**kw), (64, 64), 1),
    # the flag is the JAX registry's: the engine takes this model's output
    # as it comes, without a softmax
    "yolo": ModelSpec("yolo", lambda **kw: YoloCls(**kw), (64, 64), 1, outputs_probabilities=True),
}


def _lookup(table: dict[str, ModelSpec], model_id: str) -> ModelSpec:
    if model_id not in table:
        raise ValueError(f"unknown model id {model_id!r}; have {sorted(table)}")
    return table[model_id]


def create_extractor(model_id: str | None = None, **kwargs: Any) -> tuple[nn.Module, ModelSpec]:
    """Resolve an extractor model id (None → unet)."""
    spec = _lookup(EXTRACTORS, model_id or "unet")
    return spec.build(**kwargs), spec


def create_classifier(model_id: str | None = None, **kwargs: Any) -> tuple[nn.Module, ModelSpec]:
    """Resolve a classifier model id (None → resnet18)."""
    spec = _lookup(CLASSIFIERS, model_id or "resnet18")
    return spec.build(**kwargs), spec
