"""Scalar metrics logging.

Counterpart of ``madrona_rl_envs_playground_tpu/utils/logger.py``: JSONL
always (one ``{"t", "step", tag}`` object a line), TensorBoard when
``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class ScalarLogger:
    def __init__(self, run_dir: str, use_tensorboard: bool = True):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(run_dir)
        self._t0 = time.time()

    def add_scalar(self, tag: str, value, step: int) -> None:
        v = float(value)
        self._jsonl.write(
            json.dumps({"t": round(time.time() - self._t0, 3), "step": int(step), tag: v})
            + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, v, step)

    def add_text(self, tag: str, text: str) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, text)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def maybe_logger(run_dir: Optional[str], verbose: bool) -> Optional[ScalarLogger]:
    return ScalarLogger(run_dir) if (verbose and run_dir) else None
