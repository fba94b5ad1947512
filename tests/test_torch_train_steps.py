"""The port's losses, collectors, optimizers, training BatchNorm and train
steps against the JAX package's, on the CPU.

Tolerances (stated per check): losses and collectors 1e-6; ten optimizer
updates on the same gradients, relative error (max |a − b| / max |a| per
leaf) at most 1e-6 for parameters and every state leaf; BatchNorm in train
mode 1e-6; one train step from the same parameters and batch: loss and
metrics 1e-5 relative, new parameters, batch statistics and optimizer
leaves at the bounds each test states with its measured figure.  The two
frameworks sum the convolutions and the BatchNorm statistics in another
order (train-mode UNet logits differ by ~4e-6 relative), and RMSprop's and
Adam's first updates normalize the gradient, so an element whose gradient
is near its rounding error takes another step in each framework.  The
port's own gradients are held against float64 (1e-4 relative).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from chessvision_tpu import models as jmodels
from chessvision_tpu.runstore import metrics as jmetrics
from chessvision_tpu.train import losses as jlosses
from chessvision_tpu.train import steps as jsteps
from chessvision_tpu_torch import models as tmodels
from chessvision_tpu_torch import weights
from chessvision_tpu_torch.models.layers import BatchNorm2d, set_compute_dtype
from chessvision_tpu_torch.runstore import metrics as tmetrics
from chessvision_tpu_torch.train import losses as tlosses
from chessvision_tpu_torch.train import steps as tsteps


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30))


def _seg_case(seed: int = 0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (4, 16, 16)).astype(np.float32)
    targets = (rng.random((4, 16, 16)) > 0.6).astype(np.float32)
    targets[1] = 0.0  # an empty target
    logits[1] = -30.0  # and an empty prediction: dice's sets_sum == 0 rule
    return logits, targets


def test_segmentation_losses_match_jax() -> None:
    logits, targets = _seg_case()
    probs = 1 / (1 + np.exp(-logits))
    for jf, tf, args in (
        (jlosses.bce_with_logits, tlosses.bce_with_logits, (logits, targets)),
        (jlosses.segmentation_loss, tlosses.segmentation_loss, (logits, targets)),
        (jlosses.dice_coefficient, tlosses.dice_coefficient, (probs.astype(np.float32), targets)),
        (jlosses.dice_loss_per_sample, tlosses.dice_loss_per_sample, (probs.astype(np.float32), targets)),
        (jlosses.bce_with_logits_per_sample, tlosses.bce_with_logits_per_sample, (logits, targets)),
    ):
        want = np.asarray(jf(*map(jnp.asarray, args)))
        got = tf(*map(_t, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=jf.__name__)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing) -> None:
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (16, 13)).astype(np.float32)
    labels = rng.integers(0, 13, 16).astype(np.int32)
    want = float(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = float(tlosses.cross_entropy(_t(logits), _t(labels).long(), smoothing))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_collectors_match_jax() -> None:
    logits, targets = _seg_case(2)
    for jf, tf in ((jmetrics.segmentation_loss_per_sample, tmetrics.segmentation_loss_per_sample),
                   (jmetrics.segmentation_quality, tmetrics.segmentation_quality)):
        want = jmetrics.to_numpy(jf(jnp.asarray(logits), jnp.asarray(targets)))
        got = tmetrics.to_numpy(tf(_t(logits), _t(targets)))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    rng = np.random.default_rng(3)
    cl = rng.normal(0, 2, (32, 13)).astype(np.float32)
    labels = rng.integers(0, 13, 32).astype(np.int32)
    want = jmetrics.to_numpy({
        **jmetrics.classification_metrics(jnp.asarray(cl), jnp.asarray(labels)),
        **jmetrics.top2_margin_and_entropy(jax.nn.softmax(jnp.asarray(cl))),
    })
    got = tmetrics.to_numpy({
        **tmetrics.classification_metrics(_t(cl), _t(labels).long()),
        **tmetrics.top2_margin_and_entropy(torch.softmax(_t(cl), -1)),
    })
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert got[k].dtype == want[k].dtype, k


_SHAPES = [(3, 4), (5,), (2, 2, 3), ()]


def _optimizer_cases():
    def unet_tx(kind):
        if kind == "rmsprop":
            j = optax.inject_hyperparams(optax.rmsprop)(learning_rate=3e-3, momentum=0.999, eps=1e-8)
            t = tsteps.inject_hyperparams(tsteps.rmsprop, learning_rate=3e-3, momentum=0.999, eps=1e-8)
        else:
            j = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
            t = tsteps.inject_hyperparams(tsteps.adam, learning_rate=1e-3)
        return (optax.chain(optax.clip_by_global_norm(1.0), optax.add_decayed_weights(1e-8), j),
                tsteps.Chain([tsteps.ClipByGlobalNorm(1.0), tsteps.AddDecayedWeights(1e-8), t]))

    return {
        "make_optimizer rmsprop momentum clip decay": lambda: (
            jsteps.make_optimizer("rmsprop", 1e-3, weight_decay=1e-4, momentum=0.9, gradient_clipping=1.0),
            tsteps.make_optimizer("rmsprop", 1e-3, weight_decay=1e-4, momentum=0.9, gradient_clipping=1.0)),
        "make_optimizer adam": lambda: (jsteps.make_optimizer("adam", 1e-3), tsteps.make_optimizer("adam", 1e-3)),
        "unet trainer rmsprop (injected)": lambda: unet_tx("rmsprop"),
        "unet trainer adam (injected)": lambda: unet_tx("adam"),
        "classifier step schedule": lambda: (
            optax.adam(optax.exponential_decay(1e-3, 4, 0.1, staircase=True)),
            tsteps.adam(tsteps.exponential_decay(1e-3, 4, 0.1, staircase=True))),
        "classifier warmup cosine": lambda: (
            optax.adam(optax.warmup_cosine_decay_schedule(1e-3 / 25, 1e-3, 3, 10)),
            tsteps.adam(tsteps.warmup_cosine_decay_schedule(1e-3 / 25, 1e-3, 3, 10))),
    }


@pytest.mark.parametrize("case", sorted(_optimizer_cases()))
def test_optimizer_ten_updates_match_optax(case) -> None:
    jtx, ttx = _optimizer_cases()[case]()
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in _SHAPES]
    # large gradients every third update, so clipping acts on some and not others
    grads = [[(rng.normal(size=s) * (3.0 if k % 3 == 0 else 0.1)).astype(np.float32) for s in _SHAPES]
             for k in range(10)]
    jp = {f"p{i}": jnp.asarray(p) for i, p in enumerate(params)}
    js = jtx.init(jp)
    tp = [_t(p.copy()) for p in params]
    ts = ttx.init(tp)
    assert ttx.tags(len(tp)).count(None) + sum(1 for t in ttx.tags(len(tp)) if t is not None) == len(ts)
    for g in grads:
        u, js = jtx.update({f"p{i}": jnp.asarray(x) for i, x in enumerate(g)}, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update([_t(x) for x in g], ts, tp)
        tp = [a + b for a, b in zip(tp, tu)]
    for i in range(len(params)):
        assert _rel(jp[f"p{i}"], tp[i].numpy()) <= 1e-6, (case, i)
    jl = jax.tree.leaves(js)
    assert [np.shape(x) for x in jl] == [tuple(x.shape) for x in ts]
    for a, b in zip(jl, ts):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert _rel(a, b.numpy()) <= 1e-6, case


class _FlaxBN(fnn.Module):
    eps: float

    @fnn.compact
    def __call__(self, x, train: bool):
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=self.eps, dtype=jnp.float32)(x)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_batchnorm_train_mode_matches_flax(eps) -> None:
    """Output, running mean and running variance (biased, momentum 0.9)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(0.5, 2.0, (6, 5, 7, 8))).astype(np.float32)  # NHWC, 8 channels
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    y, upd = _FlaxBN(eps).apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    bn = BatchNorm2d(8, eps=eps)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    bn.train()
    got = bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["BatchNorm_0"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["BatchNorm_0"]["var"]), rtol=1e-6, atol=1e-6)
    # eval mode: the running statistics, unchanged
    bn.eval()
    y_eval = _FlaxBN(eps).apply(upd | {"params": variables["params"]}, jnp.asarray(x), train=False)
    got_eval = bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got_eval, np.asarray(y_eval), rtol=1e-6, atol=1e-6)


def _jax_state(jmodel, tx, sample):
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), sample)
    return jsteps.TrainState.create(apply_fn=jmodel.apply, params=v["params"], batch_stats=v["batch_stats"], tx=tx)


def _port_state(tmodel, jstate, ttx):
    tmodel.load_state_dict(weights.flax_to_torch(
        {"params": jax.tree.map(np.asarray, jstate.params), "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)},
        tmodel))
    set_compute_dtype(tmodel, torch.float32, master_weights=True)
    return tsteps.TrainState.create(tmodel, ttx)


def _state_errors(jstate, tstate) -> dict[str, float]:
    """Worst relative error per leaf, by group; the optimizer leaves must
    also agree in count, order and shape."""
    got = weights._flatten(weights.torch_to_flax(tstate.model))
    want = weights._flatten({"params": jax.tree.map(np.asarray, jstate.params),
                             "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    assert want.keys() == got.keys()
    errs = {group: max(_rel(want[k], got[k]) for k in want if k[0] == group) for group in ("params", "batch_stats")}
    jl, tl = jax.tree.leaves(jstate.opt_state), tstate.opt_state_leaves()
    assert [np.shape(x) for x in jl] == [x.shape for x in tl]
    assert all(np.asarray(a).dtype == b.dtype for a, b in zip(jl, tl))
    errs["opt_state"] = max(_rel(a, b) for a, b in zip(jl, tl))
    return errs


def _unet_case():
    rng = np.random.default_rng(0)
    x = (np.repeat(np.repeat(rng.integers(0, 256, (4, 8, 8, 3)), 8, 1), 8, 2) / 255.0).astype(np.float32)
    y = np.zeros((4, 64, 64), np.float32)
    y[:, 12:52, 10:50] = 1.0
    return x, y


def test_seg_train_step_matches_jax() -> None:
    """One RMSprop step (the UNet trainer's chain at lr 1e-3): loss and dice
    at 1e-5; new parameters 2e-4 (measured 7.5e-5, on a ConvTranspose bias
    whose gradient the following BatchNorm all but cancels: RMSprop scales
    its rounding noise up to a step); batch statistics 1e-5 (measured
    2.8e-6); optimizer leaves 5e-4 (measured 2.25e-4, the same elements)."""
    x, y = _unet_case()
    jstate = _jax_state(jmodels.UNet(base=4, dtype=jnp.float32),
                        jsteps.make_optimizer("rmsprop", 1e-3, weight_decay=1e-8, momentum=0.999, gradient_clipping=1.0),
                        jnp.zeros((1, 64, 64, 3)))
    tstate = _port_state(tmodels.UNet(base=4), jstate,
                         tsteps.make_optimizer("rmsprop", 1e-3, weight_decay=1e-8, momentum=0.999, gradient_clipping=1.0))
    jstate, jm = jsteps.make_seg_train_step()(jstate, jnp.asarray(x), jnp.asarray(y))
    tm = tsteps.make_seg_train_step()(tstate, _t(x), _t(y))
    for k in ("loss", "dice"):
        assert _rel(jm[k], tm[k].numpy()) <= 1e-5, k
    errs = _state_errors(jstate, tstate)
    assert errs["params"] <= 2e-4 and errs["batch_stats"] <= 1e-5 and errs["opt_state"] <= 5e-4, errs
    jd = float(jsteps.make_seg_eval_step()(jstate, jnp.asarray(x), jnp.asarray(y)))
    td = float(tsteps.make_seg_eval_step()(tstate, _t(x), _t(y)))
    assert abs(jd - td) <= 1e-5


@pytest.mark.parametrize("label_smoothing,freeze_bn", [(0.0, False), (0.1, False), (0.0, True)])
def test_cls_train_step_matches_jax(label_smoothing, freeze_bn) -> None:
    """One Adam step of a ResNet18 (width 8, B=16).  Loss and accuracy at
    1e-5 (measured 7.7e-6); batch statistics 1e-4 and new parameters within
    2.05·lr of JAX's (Adam's first step moves every element by ±lr).  On the
    CPU the JAX reference's train-mode BatchNorm statistics lose precision
    (XLA sums 4 096–16 384 float32 values per channel in sequence and takes
    E[x²] − E[x]²): its logits are 1.7e-4 and its gradients 4.3e-2
    (relative, worst leaf) from a float64 evaluation, the port's 5.8e-6 and
    6.2e-6; test_port_gradients_match_float64 holds the port to that."""
    rng = np.random.default_rng(1)
    x = rng.random((16, 64, 64, 1)).astype(np.float32)
    labels = (np.arange(16) % 13).astype(np.int32)
    lr = 1e-3
    jstate = _jax_state(jmodels.resnet18(width=8, dtype=jnp.float32), optax.adam(lr), jnp.zeros((1, 64, 64, 1)))
    tstate = _port_state(tmodels.resnet18(width=8), jstate, tsteps.adam(lr))
    params0 = [p.detach().clone() for p in tstate.params]
    stats_before = weights._flatten(weights.torch_to_flax(tstate.model)["batch_stats"])
    jstate, jm = jsteps.make_cls_train_step(label_smoothing=label_smoothing, freeze_bn=freeze_bn)(
        jstate, jnp.asarray(x), jnp.asarray(labels))
    tm = tsteps.make_cls_train_step(label_smoothing=label_smoothing, freeze_bn=freeze_bn)(tstate, _t(x), _t(labels).long())
    for k in ("loss", "accuracy"):
        assert _rel(jm[k], tm[k].numpy()) <= 1e-5, k
    errs = _state_errors(jstate, tstate)
    assert errs["batch_stats"] <= 1e-4, errs
    jp = jax.tree.leaves(jstate.params)
    for s, a, p, p0 in zip(tstate.slots, jp, tstate.params, params0):
        moved = s.to_flax(p.detach().numpy() - p0.numpy())
        assert np.max(np.abs(moved)) <= 1.0001 * lr
        assert np.max(np.abs(np.asarray(a) - s.to_flax(p.detach().numpy()))) <= 2.05 * lr, s.path
    if freeze_bn:
        after = weights._flatten(weights.torch_to_flax(tstate.model)["batch_stats"])
        assert all(np.array_equal(v, after[k]) for k, v in stats_before.items())
    je = jsteps.make_cls_eval_step()(jstate, jnp.asarray(x), jnp.asarray(labels))
    te = tsteps.make_cls_eval_step()(tstate, _t(x), _t(labels).long())
    assert _rel(je["loss"], te["loss"].numpy()) <= 1e-4 and float(je["accuracy"]) == float(te["accuracy"])


class _Float64(torch.nn.Module):
    def __init__(self, inner: torch.nn.Module) -> None:
        super().__init__()
        self.inner = inner

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.inner(z.double())


def _float64_twin(model: torch.nn.Module) -> torch.nn.Module:
    """A float64 copy of a port model (its float32 casts kept at float64)."""
    import copy

    twin = copy.deepcopy(model).double()
    for name, m in list(twin.named_modules()):
        if isinstance(m, torch.nn.Linear):
            parent = twin.get_submodule(name.rpartition(".")[0]) if "." in name else twin
            setattr(parent, name.rpartition(".")[2], _Float64(m))
        if isinstance(m, BatchNorm2d):
            m.forward = lambda x, m=m: _bn64(m, x)
    return twin


def _bn64(m: BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    return (x - mean[:, None, None]) * (torch.rsqrt(var + m.eps) * m.weight)[:, None, None] + m.bias[:, None, None]


@pytest.mark.parametrize("family", ["unet", "resnet18"])
def test_port_gradients_match_float64(family) -> None:
    """The port's train-mode forward and gradients in float32 against the
    same model evaluated in float64: loss 1e-6, every gradient leaf 1e-4
    relative (measured 6.2e-6 for the ResNet)."""
    torch.manual_seed(0)
    if family == "unet":
        model = tmodels.UNet(base=4)
        x, y = (_t(a) for a in _unet_case())

        def loss_of(m, xx):
            return tlosses.segmentation_loss(m(xx)[..., 0].double(), y.double())
    else:
        model = tmodels.resnet18(width=8)
        rng = np.random.default_rng(1)
        x = _t(rng.random((16, 64, 64, 1)).astype(np.float32))
        y = torch.arange(16) % 13

        def loss_of(m, xx):
            return tlosses.cross_entropy(m(xx).double(), y)
    twin = _float64_twin(model)
    model.train()
    twin.train()
    loss32 = loss_of(model, x)
    loss64 = loss_of(twin, x.double())
    g32 = torch.autograd.grad(loss32, list(model.parameters()))
    g64 = torch.autograd.grad(loss64, list(twin.parameters()))
    assert abs(loss32.item() - loss64.item()) <= 1e-6 * abs(loss64.item())
    for a, b in zip(g32, g64):
        assert _rel(b.numpy(), a.numpy()) <= 1e-4


def test_bf16_training_keeps_float32_master_weights() -> None:
    torch.manual_seed(0)
    model = set_compute_dtype(tmodels.resnet18(width=8), torch.bfloat16, master_weights=True)
    state = tsteps.TrainState.create(model, tsteps.adam(1e-3))
    x = torch.rand((8, 64, 64, 1))
    before = [p.detach().clone() for p in state.params]
    m = tsteps.make_cls_train_step()(state, x, torch.arange(8) % 13)
    assert torch.isfinite(m["loss"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad is None for p in model.parameters())  # gradients go to the optimizer, not .grad
    assert any(not torch.equal(a, p.detach()) for a, p in zip(before, state.params))
    # the convolutions compute in bf16 over the float32 weights
    logits = model.eval()(x)
    assert logits.dtype == torch.float32
    assert model.conv1.compute_dtype == torch.bfloat16 and model.conv1.weight.dtype == torch.float32


def test_set_hyperparam_writes_the_injected_learning_rate() -> None:
    model = tmodels.UNet(base=4)
    tx = tsteps.Chain([tsteps.ClipByGlobalNorm(1.0), tsteps.AddDecayedWeights(1e-8),
                       tsteps.inject_hyperparams(tsteps.rmsprop, learning_rate=3e-5, momentum=0.999, eps=1e-8)])
    state = tsteps.TrainState.create(model, tx)
    state.set_hyperparam("learning_rate", 3e-6)
    names = sorted(["decay", "eps", "initial_scale", "learning_rate", "momentum"])
    assert float(state.opt_state[1 + names.index("learning_rate")]) == np.float32(3e-6)
    with pytest.raises(KeyError):
        state.set_hyperparam("b1", 0.5)
