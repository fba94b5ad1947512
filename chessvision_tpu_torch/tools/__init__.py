"""Command-line tools on the port, run with ``python -m``, the
counterparts of the JAX side's ``scripts/`` and ``bench.py``.

Data: ``error_analysis`` (per-square errors of the test set) and
``mine_warped_squares`` (classifier squares cut from the engine's own
warps).  Measurement on the card (each line names the card and its power
limit, ``card``): ``bench`` (``bench_torch.py``, end to end),
``profile_stages``, ``bench_training``, ``mfu_accounting`` (FLOPs from
``flops``), ``sweep_arbitrate_chunk`` and ``microbench``."""
