"""The port's data parallelism across cards, on the CPU: what a rank
computes and which card it binds, without a card.

- augmentation of a rank's rows (``rows=``, ``global_batch=``) equals the
  whole batch's augmentation sliced to those rows, bit for bit, for 2 and
  4 ranks (4 images of 64², every flag on);
- under a mesh each trainer hands K1 (``warp_twopass``) only its rank's
  rows: the planes of every call are counted, with the mesh simulated in
  one process (a ``Mesh`` of N ranks without a process group, so its
  collectives are identities);
- ``initialize_distributed`` under NCCL makes ``cuda:LOCAL_RANK`` the
  current device before it joins the group, and passes it as
  ``device_id``; ``create_mesh`` binds its card too;
- two ranks that report one card raise under NCCL, naming both;
- ``shutdown_distributed`` is idempotent, and the trainers' ``main``
  leaves a group it joined when the run raises;
- a single process that sees several cards says how to use them all.

tests/test_torch_mesh.py runs four real gloo ranks against the JAX
package's sharded step; tests/test_torch_cuda.py holds K1 and an
``Engine`` on a second card.
"""

from __future__ import annotations

import logging
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chessvision_tpu_torch.ops import hat_resample
from chessvision_tpu_torch.parallel import mesh as mesh_lib
from chessvision_tpu_torch.train import augment as aug
from chessvision_tpu_torch.train import train_classifier, train_unet


def _tiny_datasets(monkeypatch) -> None:
    """The trainers' loaders return tests/_trainer_parity.py's datasets."""
    from chessvision_tpu_torch.train import data as data_lib
    from tests import _trainer_parity

    monkeypatch.setattr(data_lib, "load_board_extraction", lambda *a, **k: _trainer_parity.seg_data(data_lib))
    monkeypatch.setattr(data_lib, "load_squares", lambda *a, **k: _trainer_parity.cls_data(data_lib))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- augmentation of a rank's rows ---------------------------------------------------


def _segmentation(rows=None, global_batch=None, sl=slice(None)):
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.random((4, 64, 64, 3)).astype(np.float32))[sl]
    masks = torch.from_numpy((rng.random((4, 64, 64)) > 0.5).astype(np.float32))[sl]
    return aug.augment_segmentation_batch(
        3, imgs.contiguous(), masks.contiguous(), illum_gradient=True, rows=rows, global_batch=global_batch
    )


def _classification(rows=None, global_batch=None, sl=slice(None)):
    squares = torch.from_numpy(np.random.default_rng(1).random((4, 64, 64, 1)).astype(np.float32))[sl]
    return (aug.augment_classification_batch(
        3, squares.contiguous(), cutout=True, dim=True, fade=True, rows=rows, global_batch=global_batch
    ),)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fn", [_segmentation, _classification], ids=["segmentation", "classification"])
def test_augmenting_a_ranks_rows_equals_the_sliced_batch(fn, world) -> None:
    full = fn()
    for rank in range(world):
        start, stop = mesh_lib.process_local_batch_slice(4, mesh_lib.Mesh(world, rank, torch.device("cpu")))
        got = fn(rows=(start, stop), global_batch=4, sl=slice(start, stop))
        for g, f in zip(got, full):
            assert g.shape == f[start:stop].shape
            assert torch.equal(g, f[start:stop]), (rank, float((g - f[start:stop]).abs().max()))


def test_rows_must_name_the_global_batch() -> None:
    x = torch.zeros(2, 64, 64, 1)
    with pytest.raises(ValueError, match="global_batch"):
        aug.augment_classification_batch(0, x, rows=(0, 2))
    with pytest.raises(ValueError, match="do not hold"):
        aug.augment_classification_batch(0, x, rows=(0, 3), global_batch=4)
    with pytest.raises(ValueError, match="needs rows"):
        aug.augment_classification_batch(0, x, global_batch=4)


@pytest.mark.parametrize("layout", ["contiguous", "channels_first", "strided_view"])
def test_row_mean_of_a_ranks_rows_equals_the_whole_batchs(layout) -> None:
    """``_row_mean`` reduces a rank's rows at the global batch's shape and
    layout, so every slice gets the whole batch's bits, one row included;
    rows that are not dense (a strided view) go through a contiguous copy
    in both."""
    x = torch.from_numpy(np.random.default_rng(2).random((4, 64, 64, 3)).astype(np.float32))
    if layout == "channels_first":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    if layout == "strided_view":
        x = x[:, ::2]
    assert aug._dense_rows(x) == (layout != "strided_view")
    full = aug._row_mean(x)
    assert torch.equal(full, x.contiguous().mean(dim=(1, 2, 3), keepdim=True) if layout == "strided_view"
                       else x.mean(dim=(1, 2, 3), keepdim=True))
    for start, stop in ((0, 1), (1, 2), (3, 4), (1, 3), (2, 4)):
        rows = x[start:stop].clone() if layout == "contiguous" else x[start:stop]
        assert torch.equal(aug._row_mean(rows, (start, stop, 4)), full[start:stop]), (start, stop)


# -- the trainers hand K1 only their rows ---------------------------------------------------------


def _simulated_rank(monkeypatch, world: int, rank: int) -> None:
    """Make the trainers see a mesh of ``world`` ranks in which this
    process is ``rank``; no process group, so the collectives are
    identities and only the rows this rank computes matter here."""
    mesh = mesh_lib.Mesh(world, rank, torch.device("cpu"))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_lib, "create_mesh", lambda *a, **k: mesh)
    monkeypatch.setattr(mesh_lib, "process_index", lambda: rank)
    monkeypatch.setattr(mesh_lib, "process_count", lambda: world)
    monkeypatch.setattr(mesh_lib.Mesh, "backend", property(lambda self: None))


def _planes_handed_to_k1(monkeypatch, fn) -> list[int]:
    planes: list[int] = []
    real = hat_resample.warp_twopass

    def counting(imgs, *args):
        planes.append(int(imgs.shape[0]))
        return real(imgs, *args)

    monkeypatch.setattr(hat_resample, "warp_twopass", counting)
    fn()
    return planes


@pytest.mark.parametrize("world,rank", [(2, 1), (4, 3)])
@pytest.mark.parametrize("kind", ["unet", "resnet18"])
def test_a_rank_augments_only_its_rows(monkeypatch, tmp_path, kind, world, rank) -> None:
    """UNet batch 4 (images 3 planes a row, masks 1) and ResNet18 batch 8
    (1 plane a row): every K1 call holds this rank's rows only."""
    monkeypatch.setenv("CVTPU_STORE_ROOT", str(tmp_path))
    _tiny_datasets(monkeypatch)
    _simulated_rank(monkeypatch, world, rank)
    if kind == "unet":
        batch = 4
        planes = _planes_handed_to_k1(monkeypatch, lambda: train_unet.train_model(
            epochs=1, batch_size=batch, base=4, device="cpu", run_name="rows", seed=0))
        rows = batch // world
        assert planes and planes == [3 * rows, rows] * (len(planes) // 2), planes
    else:
        batch = 8
        planes = _planes_handed_to_k1(monkeypatch, lambda: train_classifier.train_model(
            epochs=1, batch_size=batch, width=8, device="cpu", run_name="rows", seed=0))
        assert planes and set(planes) == {batch // world}, planes


# -- binding and leaving ---------------------------------------------------------------------


def _record_binding(monkeypatch, cards: int = 4) -> list[tuple]:
    calls: list[tuple] = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", torch.device(d))))

    def init_process_group(backend, init_method=None, timeout=None, world_size=-1, rank=-1, device_id=None):
        calls.append(("init_process_group", backend, device_id))

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    return calls


@pytest.mark.parametrize("how", ["flags", "torchrun"])
def test_nccl_binds_the_local_card_before_joining(monkeypatch, how) -> None:
    for v in (*mesh_lib._ENV_MARKERS, "CVTPU_DISTRIBUTED", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("LOCAL_RANK", "3")
    calls = _record_binding(monkeypatch)
    if how == "flags":
        mesh_lib.initialize_distributed("127.0.0.1:1", 4, 3, backend="nccl")
    else:
        for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"), ("WORLD_SIZE", "4"), ("RANK", "3")):
            monkeypatch.setenv(k, v)
        mesh_lib.initialize_distributed(backend="nccl")
    cuda3 = torch.device("cuda", 3)
    assert calls == [("set_device", cuda3), ("init_process_group", "nccl", cuda3)]


def test_explicit_ranks_without_local_rank_bind_rank_modulo_cards(monkeypatch) -> None:
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    calls = _record_binding(monkeypatch, cards=4)
    mesh_lib.initialize_distributed("127.0.0.1:1", 8, 6, backend="nccl")
    assert calls[0] == ("set_device", torch.device("cuda", 2))


def test_gloo_on_the_cpu_binds_nothing(monkeypatch) -> None:
    calls = _record_binding(monkeypatch)
    mesh_lib.initialize_distributed("127.0.0.1:1", 2, 1, backend="gloo")
    assert calls == [("init_process_group", "gloo", None)]


def test_create_mesh_binds_its_card(monkeypatch) -> None:
    monkeypatch.setenv("LOCAL_RANK", "2")
    calls = _record_binding(monkeypatch)
    mesh = mesh_lib.create_mesh(device="cuda")
    assert mesh.device == torch.device("cuda", 2) and calls == [("set_device", torch.device("cuda", 2))]
    assert mesh_lib.create_mesh(device="cpu").device == torch.device("cpu") and len(calls) == 1


def test_nccl_ranks_that_share_a_card_raise_naming_both(monkeypatch) -> None:
    store = dist.HashStore()
    store.set("cvtpu_mesh_device/0", "host/GPU-a")
    store.set("cvtpu_mesh_device/1", "host/GPU-b")
    monkeypatch.setattr(dist.distributed_c10d, "_get_default_store", lambda: store)
    mesh_lib.check_one_rank_per_device(mesh_lib.Mesh(3, 2, torch.device("cpu")), "host/GPU-c")
    with pytest.raises(RuntimeError, match="ranks 0 and 2 share the device host/GPU-a"):
        mesh_lib.check_one_rank_per_device(mesh_lib.Mesh(3, 2, torch.device("cpu")), "host/GPU-a")

    # create_mesh runs the check under NCCL, and falls back to nothing
    monkeypatch.setattr(mesh_lib, "process_count", lambda: 3)
    monkeypatch.setattr(mesh_lib, "process_index", lambda: 2)
    monkeypatch.setattr(mesh_lib.Mesh, "backend", property(lambda self: "nccl"))
    monkeypatch.setattr(mesh_lib, "_device_key", lambda dev: "host/GPU-b")
    _record_binding(monkeypatch)
    with pytest.raises(RuntimeError, match="ranks 1 and 2 share the device host/GPU-b"):
        mesh_lib.create_mesh(device="cuda")


def test_shutdown_distributed_is_idempotent(tmp_path) -> None:
    mesh_lib.shutdown_distributed()  # no group: nothing to leave
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        assert dist.is_initialized()
        mesh_lib.shutdown_distributed()
        assert not dist.is_initialized()
        mesh_lib.shutdown_distributed()
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("module", [train_unet, train_classifier], ids=["unet", "classifier"])
def test_main_leaves_the_group_it_joined_when_the_run_raises(monkeypatch, module) -> None:
    def boom(**kwargs):
        assert dist.is_initialized() and dist.get_world_size() == 1
        raise RuntimeError("the run failed")

    monkeypatch.setattr(module, "train_model", boom)
    argv = ["--device", "cpu", "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "1",
            "--process-id", "0"]
    try:
        with pytest.raises(RuntimeError, match="the run failed"):
            module.main(argv)
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_main_keeps_a_group_its_caller_joined(monkeypatch, tmp_path) -> None:
    monkeypatch.setattr(train_unet, "train_model", lambda **kw: (_ for _ in ()).throw(RuntimeError("stop")))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="stop"):
            train_unet.main(["--device", "cpu"])
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


# -- one process, several cards ------------------------------------------------------------


def test_one_process_on_a_many_card_host_says_how_to_use_them(monkeypatch, caplog) -> None:
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with caplog.at_level(logging.INFO, logger=mesh_lib.__name__):
        mesh_lib.log_unused_cards(torch.device("cuda", 0), "chessvision_tpu_torch.train.train_unet")
        mesh_lib.log_unused_cards(torch.device("cpu"), "chessvision_tpu_torch.train.train_unet")
    (msg,) = [r.getMessage() for r in caplog.records]
    assert "4 CUDA devices" in msg and "cuda:0 only" in msg
    assert "NPROC=4 scripts/bin/torch_train_distributed.sh" in msg
    assert "torchrun --nproc-per-node 4 -m chessvision_tpu_torch.train.train_unet" in msg


@pytest.mark.parametrize("module", [train_unet, train_classifier], ids=["unet", "classifier"])
def test_trainers_outside_a_group_report_the_cards_they_leave(monkeypatch, tmp_path, module) -> None:
    monkeypatch.setenv("CVTPU_STORE_ROOT", str(tmp_path))
    _tiny_datasets(monkeypatch)
    seen = []
    monkeypatch.setattr(mesh_lib, "log_unused_cards", lambda dev, name: seen.append((dev, name)))
    kw = dict(base=4, batch_size=4) if module is train_unet else dict(width=8, batch_size=8)
    module.train_model(epochs=1, augment=False, device="cpu", run_name="alone", seed=0, **kw)
    assert seen == [(torch.device("cpu"), module.__name__)]
