"""Metrics logging and step timing of the training CLI.

Port of `tdm_tpu/utils/logging.py`: the per-process logger, `MetricLogger`
(metrics.jsonl always; tensorboard through tensorboardX when installed) and
`StepTimer`. Profiling is `torch.profiler` in the CLI (`--profile_steps`),
in place of the JAX package's `jax.profiler` traces.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional


def setup_logging(name: str = "tdm_tpu_torch", *, main_process: bool = True) -> logging.Logger:
    """Per-process logger; processes other than the main one log warnings
    only (the accelerate `is_local_main_process` split, `src/main.py:100-114`)."""
    logging.basicConfig(
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
        level=logging.INFO if main_process else logging.WARNING,
    )
    return logging.getLogger(name)


class MetricLogger:
    """Scalar tracker: a metrics.jsonl file under `logdir`, and tensorboard
    when `report_to` asks for it and tensorboardX is installed; a disabled
    one (a process other than the main one) writes nothing."""

    def __init__(self, logdir: str, *, report_to: str = "tensorboard", enabled: bool = True):
        self._tb = self._jsonl = None
        if not enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        if report_to in ("tensorboard", "all"):
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except ImportError:  # tensorboardX is optional
                pass
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def log(self, metrics: dict, step: int) -> None:
        if self._jsonl is None:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **scalars}) + "\n")
        self._jsonl.flush()

    def log_image(self, tag: str, image, step: int) -> None:
        """[H, W, 3] uint8 grid → tensorboard (when active)."""
        if self._tb is not None:
            self._tb.add_image(tag, image, step, dataformats="HWC")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


class StepTimer:
    """Wall-clock time between ticks (None at the first)."""

    def __init__(self):
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None if self._last is None else now - self._last
        self._last = now
        return dt
