"""The verdict on a run's readings: every number that the cell's check
(``checks/<check>.py``) reads is held to its limit in
``limits/<cell>.json``, and a number with no limit, or a limit with no
number, is an error in the benchmark, never a pass."""

from __future__ import annotations


def verdict(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict[str, dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}})."""
    unlimited = sorted(set(readings) - set(limits))
    unread = sorted(set(limits) - set(readings))
    if unlimited or unread:
        raise KeyError(f"numbers without a limit {unlimited}; limits without a number {unread}")
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in readings.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
