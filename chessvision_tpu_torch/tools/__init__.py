"""Command-line data tools on the port's engine, run with ``python -m``:
``error_analysis`` (per-square errors of the test set) and
``mine_warped_squares`` (classifier squares cut from the engine's own
warps).  Counterparts of ``scripts/error_analysis.py`` and
``scripts/mine_warped_squares.py``."""
