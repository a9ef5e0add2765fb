"""Structured metrics logging and timing (port of
`nerf_lidar_tpu/utils/logging.py`).

An append-only JSONL metrics log (one record per call, auditable across
restarts) with optional TensorBoard scalars, and a wall-clock span timer.
"""

from __future__ import annotations

import json
import os
import time

import torch.distributed as dist


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


class MetricsLogger:
    """`metrics.jsonl` in `exp_dir`, written by rank 0 of
    `torch.distributed` when it is initialised (always otherwise), plus
    optional TensorBoard scalars: without tensorboardX it says so and goes
    on, as a writer error never interrupts training."""

    def __init__(self, exp_dir: str, tensorboard: bool = False):
        self.path = None
        self.tb = None
        if _rank() == 0:
            os.makedirs(exp_dir, exist_ok=True)
            self.path = os.path.join(exp_dir, "metrics.jsonl")
            if tensorboard:
                try:
                    from tensorboardX import SummaryWriter
                    self.tb = SummaryWriter(os.path.join(exp_dir, "tb"))
                except Exception as e:  # an optional dependency
                    print(f"tensorboard logging disabled: {e}")

    def log(self, step: int, **metrics):
        if self.path is None:
            return
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self.tb.add_scalar(k, v, step)


class Timer:
    """Wall-clock span timer; call mark() to get (seconds, rate)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.count = 0

    def tick(self, n: int = 1):
        self.count += n

    def mark(self):
        dt = time.perf_counter() - self.t0
        rate = self.count / dt if dt > 0 else 0.0
        self.t0 = time.perf_counter()
        self.count = 0
        return dt, rate
