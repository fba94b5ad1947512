"""``engine._copy_back`` on the CPU: CPU tensors take the plain copy, and
the bookkeeping of the pinned slabs that CUDA outputs come back through.

The pinned copies themselves need a card: ``tests/test_torch_cuda.py``
(``-k copy_back``) holds them to the pageable path bit for bit.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest
import torch

from chessvision_tpu_torch import engine as engine_mod

CPU_OUTPUTS = {
    "float32": lambda: torch.randn(4, 8, 8, generator=torch.Generator().manual_seed(1)),
    "uint8": lambda: torch.arange(4 * 6 * 6, dtype=torch.uint8).view(4, 6, 6),
    "bool": lambda: torch.tensor([True, False, True]),
    "int32": lambda: torch.arange(7, dtype=torch.int32),
    "empty": lambda: torch.zeros((0, 256, 256), dtype=torch.float32),
    "scalar": lambda: torch.tensor(3.5),
    "transposed": lambda: torch.arange(24, dtype=torch.float32).view(4, 6).t(),
}


@pytest.mark.parametrize("name", sorted(CPU_OUTPUTS))
def test_copy_back_of_cpu_tensors_is_the_plain_copy(name) -> None:
    """The same arrays as ``.cpu().numpy()``, sharing the tensor's memory as
    before, and neither counter moves."""
    t = CPU_OUTPUTS[name]()
    other = torch.ones(2, 3)
    before = (engine_mod.copy_back_pinned_bytes, engine_mod.copy_back_pageable_bytes, engine_mod._pinned_live)
    host = engine_mod._copy_back({"x": t, "y": other, "unused": other}, ("y", "x"))
    assert list(host) == ["y", "x"]
    want = t.cpu().numpy()
    assert host["x"].dtype == want.dtype and host["x"].shape == want.shape
    assert host["x"].tobytes() == want.tobytes()
    assert t.numel() == 0 or np.shares_memory(host["x"], want)
    assert (engine_mod.copy_back_pinned_bytes, engine_mod.copy_back_pageable_bytes,
            engine_mod._pinned_live) == before


@pytest.mark.parametrize("sizes", [
    {"logits": 128 * 256 * 256 * 4, "board_image": 128 * 512 * 512, "binary_mask": 128 * 256 * 256,
     "found": 128, "quadrangle": 128 * 8 * 4, "probabilities": 128 * 64 * 13 * 4, "band": 4097 * 4},
    {"found": 1, "quadrangle": 32, "probabilities": 64 * 13 * 4},
    {"logits": 0, "found": 0, "board_image": 0},
    {"a": 1, "b": 0, "c": 255, "d": 257},
], ids=["batch128", "lite1", "empty", "odd"])
def test_slab_layout_aligns_each_output_in_order_and_apart(sizes) -> None:
    starts, total, block = engine_mod._slab_layout(sizes)
    assert list(starts) == list(sizes)
    ends = 0
    for k, n in sizes.items():
        assert starts[k] % 64 == 0 and starts[k] % engine_mod._SLAB_ALIGN == 0
        assert starts[k] >= ends  # no output overlaps the one before it
        ends = starts[k] + n
    assert ends <= total < ends + engine_mod._SLAB_ALIGN * len(sizes) + 1
    if total:
        assert block >= total and block & (block - 1) == 0 and block < 2 * total
    else:
        assert block == 0


def test_pinned_ceiling_refuses_a_slab_past_it(monkeypatch) -> None:
    monkeypatch.setattr(engine_mod, "_pinned_live", 0)
    monkeypatch.setattr(engine_mod, "_PINNED_CEILING", 1000)
    assert engine_mod._pin(600)
    assert not engine_mod._pin(401)
    assert engine_mod._pin(400)
    assert engine_mod._pinned_live == 1000
    assert not engine_mod._pin(1)
    engine_mod._unpin(600)
    assert engine_mod._pin(600)
    engine_mod._unpin(600)
    engine_mod._unpin(400)
    assert engine_mod._pinned_live == 0


def test_the_ceiling_is_a_quarter_of_the_hosts_memory() -> None:
    phys = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    assert engine_mod._PINNED_CEILING == phys // 4 > 0


def test_pinned_accounting_loses_no_update_across_threads(monkeypatch) -> None:
    """More threads than cores take and give back slabs and count copies
    under a short switch interval: every update lands, and no thread ever
    holds a slab past the ceiling."""
    monkeypatch.setattr(engine_mod, "_pinned_live", 0)
    monkeypatch.setattr(engine_mod, "_PINNED_CEILING", 24 * 64)
    monkeypatch.setattr(engine_mod, "copy_back_pinned_bytes", 0)
    monkeypatch.setattr(engine_mod, "copy_back_pageable_bytes", 0)
    n_threads, rounds = 32, 400
    refused, over = [0] * n_threads, []

    def work(i: int) -> None:
        for _ in range(rounds):
            if engine_mod._pin(64):
                if engine_mod._pinned_live > engine_mod._PINNED_CEILING:
                    over.append(engine_mod._pinned_live)
                engine_mod._count_copied(3, 0)
                engine_mod._unpin(64)
            else:
                refused[i] += 1
                engine_mod._count_copied(0, 5)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not over
    assert engine_mod._pinned_live == 0
    taken = n_threads * rounds - sum(refused)
    assert engine_mod.copy_back_pinned_bytes == 3 * taken
    assert engine_mod.copy_back_pageable_bytes == 5 * sum(refused)
