"""Optimizers, the train state and the train/eval steps.

Counterpart of ``chessvision_tpu/train/steps.py``.  The optimizers are
written to optax's definitions, not ``torch.optim``'s, as small
transformations over lists of tensors (the parameters in Flax leaf order,
``weights.param_slots``), in optax's order and with optax's state:

- ``clip_by_global_norm``: unchanged below the norm, else ``g / ‖g‖ · max``;
- ``add_decayed_weights``: ``g + wd·p``;
- ``rmsprop``: ``nu = (1 − d)·g² + d·nu``, ``g·rsqrt(nu + eps)`` (eps inside
  the root), then the learning rate, then the trace ``t = u + m·t``;
- ``adam``: bias-corrected moments, ``m̂ / (sqrt(v̂ + eps_root) + eps)``;
- ``inject_hyperparams``: hyperparameters as state leaves (the UNet
  trainer's plateau schedule writes the learning rate there);
- ``exponential_decay`` and ``warmup_cosine_decay_schedule``, functions of
  the update count.

Each transformation's state is a flat list of tensors in the order of
``jax.tree.leaves`` of the optax state, so a checkpoint's
``opt_state/leafNNNN`` entries map one to one in both directions.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch
from torch import nn

from chessvision_tpu_torch.train import losses
from chessvision_tpu_torch.weights import Slot, flax_to_torch, param_slots, torch_to_flax

Tensors = list[torch.Tensor]
Scalar = float | torch.Tensor
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Transform:
    """One optax gradient transformation: ``init`` gives the state leaves,
    ``update`` maps (updates, state, params) to (updates, state)."""

    def init(self, params: Tensors) -> Tensors:
        return []

    def tags(self, n_params: int) -> list[int | None]:
        """For each state leaf, the parameter it mirrors (None: a scalar)."""
        return []

    def update(self, updates: Tensors, state: Tensors, params: Tensors) -> tuple[Tensors, Tensors]:
        raise NotImplementedError

    def hyperparam_index(self, name: str, n_params: int) -> int | None:
        """The state index of an injected hyperparameter, or None."""
        return None


def _count(params: Tensors) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


@dataclass
class Chain(Transform):
    parts: Sequence[Transform]

    def _split(self, state: Tensors, n_params: int) -> list[Tensors]:
        out, i = [], 0
        for t in self.parts:
            n = len(t.tags(n_params))
            out.append(state[i : i + n])
            i += n
        return out

    def init(self, params: Tensors) -> Tensors:
        return [leaf for t in self.parts for leaf in t.init(params)]

    def tags(self, n_params: int) -> list[int | None]:
        return [tag for t in self.parts for tag in t.tags(n_params)]

    def update(self, updates: Tensors, state: Tensors, params: Tensors) -> tuple[Tensors, Tensors]:
        new_state: Tensors = []
        for t, s in zip(self.parts, self._split(state, len(params))):
            updates, s = t.update(updates, s, params)
            new_state += s
        return updates, new_state

    def hyperparam_index(self, name: str, n_params: int) -> int | None:
        offset = 0
        for t in self.parts:
            i = t.hyperparam_index(name, n_params)
            if i is not None:
                return offset + i
            offset += len(t.tags(n_params))
        return None


class Identity(Transform):
    def update(self, updates, state, params):
        return updates, state


@dataclass
class ClipByGlobalNorm(Transform):
    max_norm: float

    def update(self, updates, state, params):
        norms = torch.stack(torch._foreach_norm(updates))
        g_norm = torch.sqrt(torch.sum(norms * norms))
        keep = (g_norm < self.max_norm).float()
        clipped = torch._foreach_mul(torch._foreach_div(updates, g_norm), self.max_norm)
        # an exact select: each element is t·1 + c·0 or t·0 + c·1
        kept = torch._foreach_mul(updates, keep)
        torch._foreach_mul_(clipped, 1.0 - keep)
        return torch._foreach_add(kept, clipped), state


@dataclass
class AddDecayedWeights(Transform):
    weight_decay: float

    def update(self, updates, state, params):
        return torch._foreach_add(updates, torch._foreach_mul(params, self.weight_decay)), state


@dataclass
class ScaleByRms(Transform):
    decay: Scalar = 0.9
    eps: Scalar = 1e-8
    initial_scale: Scalar = 0.0

    def init(self, params):
        return [torch.zeros_like(p) + self.initial_scale for p in params]

    def tags(self, n_params):
        return list(range(n_params))

    def update(self, updates, state, params):
        g2 = torch._foreach_mul(updates, updates)
        torch._foreach_mul_(g2, 1 - self.decay)
        nu = torch._foreach_add(g2, torch._foreach_mul(state, self.decay))
        scaling = torch._foreach_rsqrt(torch._foreach_add(nu, self.eps))
        return torch._foreach_mul(updates, scaling), nu


@dataclass
class ScaleByAdam(Transform):
    b1: Scalar = 0.9
    b2: Scalar = 0.999
    eps: Scalar = 1e-8
    eps_root: Scalar = 0.0

    def init(self, params):
        return [_count(params), *[torch.zeros_like(p) for p in params], *[torch.zeros_like(p) for p in params]]

    def tags(self, n_params):
        return [None, *range(n_params), *range(n_params)]

    def update(self, updates, state, params):
        n = len(params)
        count, mu, nu = state[0], state[1 : 1 + n], state[1 + n :]
        mu = torch._foreach_add(torch._foreach_mul(updates, 1 - self.b1), torch._foreach_mul(mu, self.b1))
        g2 = torch._foreach_mul(updates, updates)
        torch._foreach_mul_(g2, 1 - self.b2)
        nu = torch._foreach_add(g2, torch._foreach_mul(nu, self.b2))
        count_inc = count + 1
        t = count_inc.float()
        mu_hat = torch._foreach_div(mu, 1 - torch.pow(self.b1, t))
        nu_hat = torch._foreach_div(nu, 1 - torch.pow(self.b2, t))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(nu_hat, self.eps_root)), self.eps)
        return torch._foreach_div(mu_hat, den), [count_inc, *mu, *nu]


@dataclass
class Scale(Transform):
    step_size: Scalar

    def update(self, updates, state, params):
        return torch._foreach_mul(updates, self.step_size), state


@dataclass
class ScaleBySchedule(Transform):
    step_size_fn: Schedule

    def init(self, params):
        return [_count(params)]

    def tags(self, n_params):
        return [None]

    def update(self, updates, state, params):
        (count,) = state
        step = self.step_size_fn(count).to(torch.float32)
        return torch._foreach_mul(updates, step), [count + 1]


@dataclass
class Trace(Transform):
    decay: Scalar

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def tags(self, n_params):
        return list(range(n_params))

    def update(self, updates, state, params):
        new_trace = torch._foreach_add(updates, torch._foreach_mul(state, self.decay))
        return new_trace, new_trace


def scale_by_learning_rate(learning_rate: Scalar | Schedule) -> Transform:
    if callable(learning_rate):
        return ScaleBySchedule(lambda count: -1 * learning_rate(count))
    return Scale(-1 * learning_rate)


def rmsprop(
    learning_rate: Scalar | Schedule,
    decay: Scalar = 0.9,
    eps: Scalar = 1e-8,
    initial_scale: Scalar = 0.0,
    momentum: Scalar | None = None,
) -> Transform:
    return Chain([
        ScaleByRms(decay, eps, initial_scale),
        scale_by_learning_rate(learning_rate),
        Trace(momentum) if momentum is not None else Identity(),
    ])


def adam(
    learning_rate: Scalar | Schedule, b1: Scalar = 0.9, b2: Scalar = 0.999, eps: Scalar = 1e-8, eps_root: Scalar = 0.0
) -> Transform:
    return Chain([ScaleByAdam(b1, b2, eps, eps_root), scale_by_learning_rate(learning_rate)])


# every float hyperparameter of each optimizer, defaults included: what
# optax.inject_hyperparams keeps in its state (sorted there by name)
_HYPERPARAMS = {
    rmsprop: {"decay": 0.9, "eps": 1e-8, "initial_scale": 0.0},
    adam: {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0},
}


@dataclass
class InjectHyperparams(Transform):
    """``optax.inject_hyperparams(opt)(**kwargs)``: the state holds the
    update count, then every hyperparameter as a float32 scalar in name
    order, then the inner optimizer's state."""

    build: Callable[..., Transform]
    hyperparams: dict[str, float]
    names: list[str] = field(init=False)

    def __post_init__(self) -> None:
        self.hyperparams = {**_HYPERPARAMS[self.build], **self.hyperparams}
        self.names = sorted(self.hyperparams)

    def _inner(self, hp: Tensors) -> Transform:
        return self.build(**dict(zip(self.names, hp)))

    def init(self, params):
        dev = params[0].device
        hp = [torch.tensor(np.float32(self.hyperparams[k]), device=dev) for k in self.names]
        return [_count(params), *hp, *self._inner(hp).init(params)]

    def tags(self, n_params):
        inner = self.build(**self.hyperparams)
        return [None] * (1 + len(self.names)) + inner.tags(n_params)

    def update(self, updates, state, params):
        k = len(self.names)
        count, hp, inner_state = state[0], state[1 : 1 + k], state[1 + k :]
        updates, inner_state = self._inner(hp).update(updates, inner_state, params)
        return updates, [count + 1, *hp, *inner_state]

    def hyperparam_index(self, name: str, n_params: int) -> int | None:
        return 1 + self.names.index(name) if name in self.names else None


def inject_hyperparams(build: Callable[..., Transform], **hyperparams: float) -> InjectHyperparams:
    return InjectHyperparams(build, hyperparams)


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float, staircase: bool = False) -> Schedule:
    """``optax.exponential_decay`` (transition_begin 0, no end value)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: torch.full((), init_value, dtype=torch.float32, device=count.device)

    # every scalar stays a Python number: no host-to-device copy a step
    def schedule(count: torch.Tensor) -> torch.Tensor:
        p = count.float() / transition_steps
        if staircase:
            p = torch.floor(p)
        decayed = init_value * torch.pow(decay_rate, p)
        return torch.where(count <= 0, torch.full_like(decayed, init_value), decayed)

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1): a linear ramp
    from ``init_value`` to ``peak_value`` over ``warmup_steps`` updates, then
    a cosine decay to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"warmup_cosine_decay_schedule requires decay_steps > warmup_steps, got {decay_steps=}")

    def linear(count: torch.Tensor) -> torch.Tensor:
        if warmup_steps <= 0:
            return torch.full((), peak_value, dtype=torch.float32, device=count.device)
        c = torch.clamp(count, 0, warmup_steps).float()
        frac = 1 - c / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.float(), max=float(cos_steps))
        decay = 0.5 * (1 + torch.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * decay + alpha)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.where(count < warmup_steps, linear(count), cosine(count - warmup_steps))

    return schedule


def make_optimizer(
    kind: str,
    learning_rate: float | Schedule,
    *,
    weight_decay: float = 0.0,
    momentum: float = 0.0,
    gradient_clipping: float | None = None,
) -> Transform:
    """RMSprop or Adam, with optional global-norm clipping and weight decay
    ahead of it (``chessvision_tpu.train.steps.make_optimizer``)."""
    if kind == "rmsprop":
        core = rmsprop(learning_rate, momentum=momentum, eps=1e-8)
    elif kind == "adam":
        core = adam(learning_rate)
    else:
        raise ValueError(f"Unknown optimizer: {kind}")
    parts: list[Transform] = []
    if gradient_clipping:
        parts.append(ClipByGlobalNorm(gradient_clipping))
    if weight_decay:
        parts.append(AddDecayedWeights(weight_decay))
    parts.append(core)
    return Chain(parts)


@dataclass
class TrainState:
    """A model, its optimizer and the optimizer's state (leaves in optax
    order), and the update count.  ``params`` are the model's parameters in
    Flax leaf order; the model holds them and its BatchNorm statistics."""

    model: nn.Module
    tx: Transform
    opt_state: Tensors
    step: int = 0
    slots: list[Slot] = field(default_factory=list)
    params: list[nn.Parameter] = field(default_factory=list)

    @classmethod
    def create(cls, model: nn.Module, tx: Transform) -> "TrainState":
        slots = param_slots(model)
        named = dict(model.named_parameters())
        params = [named[s.key] for s in slots]
        return cls(model, tx, tx.init([p.detach() for p in params]), 0, slots, params)

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        with torch.no_grad():
            data = [p.detach() for p in self.params]
            updates, self.opt_state = self.tx.update(list(grads), self.opt_state, data)
            torch._foreach_add_(data, updates)
        self.step += 1

    def set_hyperparam(self, name: str, value: float) -> None:
        """Write an injected hyperparameter (e.g. the learning rate)."""
        i = self.tx.hyperparam_index(name, len(self.params))
        if i is None:
            raise KeyError(f"the optimizer has no injected hyperparameter {name!r}")
        self.opt_state[i] = torch.tensor(np.float32(value), device=self.opt_state[i].device)

    def opt_state_leaves(self) -> list[np.ndarray]:
        """The optimizer state as optax's leaves: numpy, Flax layouts."""
        out = []
        for leaf, tag in zip(self.opt_state, self.tx.tags(len(self.params))):
            a = leaf.detach().cpu().numpy()
            out.append(np.ascontiguousarray(self.slots[tag].to_flax(a)) if tag is not None else a)
        return out

    def load_opt_state_leaves(self, leaves: Sequence[np.ndarray]) -> None:
        tags = self.tx.tags(len(self.params))
        if len(leaves) != len(tags):
            raise ValueError(f"checkpoint has {len(leaves)} optimizer leaves, this optimizer {len(tags)}")
        dev = self.params[0].device
        state = []
        for leaf, tag, cur in zip(leaves, tags, self.opt_state):
            a = self.slots[tag].to_torch(np.asarray(leaf)) if tag is not None else np.asarray(leaf)
            t = torch.from_numpy(np.array(a)).to(device=dev, dtype=cur.dtype)  # a copy keeps 0-d leaves 0-d
            if t.shape != cur.shape:
                raise ValueError(f"optimizer leaf shape {tuple(t.shape)} != {tuple(cur.shape)}")
            state.append(t)
        self.opt_state = state


def ema_update(ema: Tensors, params: Sequence[torch.Tensor], decay: float) -> Tensors:
    """``decay·e + (1 − decay)·p`` per parameter."""
    with torch.no_grad():
        return torch._foreach_add(torch._foreach_mul(ema, decay), torch._foreach_mul([p.detach() for p in params], 1.0 - decay))


@contextlib.contextmanager
def params_swapped(state: TrainState, values: Tensors | None) -> Iterator[TrainState]:
    """``state`` with its parameters replaced by ``values`` (an EMA view)
    inside the block and restored exactly after; no-op for None."""
    if values is None:
        yield state
        return
    data = [p.detach() for p in state.params]
    with torch.no_grad():
        saved = [d.clone() for d in data]
        torch._foreach_copy_(data, values)
    try:
        yield state
    finally:
        with torch.no_grad():
            torch._foreach_copy_(data, saved)


def params_tree(state: TrainState, values: Sequence[torch.Tensor]) -> dict[str, Any]:
    """Tensors aligned with ``state.params`` as a Flax ``params`` tree."""
    tree: dict[str, Any] = {}
    for s, v in zip(state.slots, values):
        node = tree
        for p in s.path[:-1]:
            node = node.setdefault(p, {})
        node[s.path[-1]] = np.ascontiguousarray(s.to_flax(v.detach().float().cpu().numpy()))
    return tree


def params_from_tree(state: TrainState, tree: dict[str, Any]) -> Tensors:
    """A Flax ``params`` tree as tensors aligned with ``state.params``."""
    out = []
    for s, p in zip(state.slots, state.params):
        node = tree
        for k in s.path:
            node = node[k]
        out.append(torch.from_numpy(np.ascontiguousarray(s.to_torch(np.asarray(node, np.float32)))).to(p.device))
    return out


def checkpoint_variables(state: TrainState, ema: Tensors | None = None) -> dict[str, Any]:
    """The model's ``params`` and ``batch_stats`` (and ``ema_params``) as
    the Flax trees a checkpoint stores."""
    variables = torch_to_flax(state.model)
    if ema is not None:
        variables["ema_params"] = params_tree(state, ema)
    return variables


def restore(state: TrainState, variables: dict[str, Any]) -> None:
    """Load a checkpoint's ``params``/``batch_stats`` into the model, and
    its optimizer leaves (where it has them) into the state."""
    from chessvision_tpu_torch.checkpoint import load_opt_state_leaves

    model = state.model
    loaded = flax_to_torch(variables, model)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            t.copy_(loaded[key].to(t.dtype))
    leaves = load_opt_state_leaves(variables)
    if leaves is not None:
        state.load_opt_state_leaves(leaves)


def _param_grads(loss: torch.Tensor, state: TrainState) -> Tensors:
    return list(torch.autograd.grad(loss, state.params))


def make_seg_train_step() -> Callable[[TrainState, torch.Tensor, torch.Tensor], dict[str, torch.Tensor]]:
    """Segmentation train step: BCE + dice on the logits, BatchNorm in train
    mode, one optimizer update.  Returns the loss and the batch's dice, on
    the device."""

    def step(state: TrainState, images: torch.Tensor, masks: torch.Tensor) -> dict[str, torch.Tensor]:
        state.model.train()
        logits = state.model(images)[..., 0]
        loss = losses.segmentation_loss(logits, masks)
        state.apply_gradients(_param_grads(loss, state))
        dice = losses.dice_coefficient(torch.sigmoid(logits.detach()), masks)
        return {"loss": loss.detach(), "dice": dice}

    return step


def make_seg_eval_step() -> Callable[[TrainState, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Dice of the thresholded prediction (BatchNorm on running stats)."""

    def step(state: TrainState, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        state.model.eval()
        with torch.no_grad():
            probs = torch.sigmoid(state.model(images)[..., 0])
            return losses.dice_coefficient((probs > 0.5).float(), masks)

    return step


def make_cls_train_step(
    label_smoothing: float = 0.0, freeze_bn: bool = False
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], dict[str, torch.Tensor]]:
    """Classifier train step: cross entropy (optional smoothing) and top-1.
    ``freeze_bn`` keeps BatchNorm on its running statistics while the
    parameters train."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
        state.model.train(not freeze_bn)
        logits = state.model(images)
        loss = losses.cross_entropy(logits, labels, label_smoothing)
        state.apply_gradients(_param_grads(loss, state))
        acc = torch.mean((torch.argmax(logits.detach(), -1) == labels).float())
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def make_cls_eval_step() -> Callable[[TrainState, torch.Tensor, torch.Tensor], dict[str, torch.Tensor]]:
    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
        state.model.eval()
        with torch.no_grad():
            logits = state.model(images)
            loss = losses.cross_entropy(logits, labels)
            acc = torch.mean((torch.argmax(logits, -1) == labels).float())
        return {"loss": loss, "accuracy": acc, "logits": logits}

    return step
