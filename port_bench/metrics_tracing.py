"""What the readers of the program's own spans share: the tracer's
snapshot (``madrona_rl_envs_playground_tpu_torch/utils/tracing.py``) and
medians over its replayed updates.

Every reader returns None where the program has no tracer (an older
checkout) or the snapshot holds no device time (no card), so a host time is
never reported under a device metric's name."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional


def snapshot() -> Optional[Dict]:
    """The process's tracer snapshot, or None where the program has none."""
    try:
        from madrona_rl_envs_playground_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def on_device(snap: Optional[Dict]) -> bool:
    """Whether ``snap`` holds any span timed on the device's clock."""
    return bool(snap) and any(s["device_ms"] is not None for u in snap["updates"]
                              for s in u["spans"])


def replayed(snap: Optional[Dict]) -> List[Dict]:
    """The kept updates that replayed their graphs and captured none, timed
    on the device."""
    if not on_device(snap):
        return []
    return [u for u in snap["updates"]
            if u["replayed"] and u["spans"][0]["device_ms"] is not None]


def median_over_updates(snap: Optional[Dict], per_update: Callable[[Dict], Optional[float]]):
    """The median of ``per_update(update)`` over the replayed updates (those
    for which it is not None); None where there is none."""
    values = [v for v in map(per_update, replayed(snap)) if v is not None]
    return statistics.median(values) if values else None


def phases(update: Dict) -> List[Dict]:
    """The update's phases: the spans whose parent is its ``update`` span."""
    root = update["spans"][0]["id"]
    return [s for s in update["spans"] if s["parent"] == root]


def phase_ms(snap: Optional[Dict], name: str) -> Optional[float]:
    """The median device ms of the phase ``name`` an update."""
    def one(u):
        ms = [s["device_ms"] for s in phases(u) if s["name"] == name]
        return sum(ms) if ms and None not in ms else None
    return median_over_updates(snap, one)


def host_seconds(snap: Optional[Dict], prefix: str) -> Optional[float]:
    """The process's host seconds in every span whose name starts with
    ``prefix`` (the tracer's running sums); None off the card."""
    if not on_device(snap):
        return None
    total = [st["host_ms"]["sum"] for name, st in snap["spans"].items()
             if name.startswith(prefix) and st["host_ms"]]
    return sum(total) / 1e3 if total else None
