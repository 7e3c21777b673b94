"""Experiment tracking: console + JSONL, a throughput counter and a loss
buffer.

Counterpart of ``MetricsLogger``, ``Throughput`` and ``LossAccumulator`` in
``tinydiffusion_tpu/obs/metrics.py``, with the same file layout
(``<run_dir>/<project>/metrics.jsonl``, one JSON object per ``log`` call with
the wall time ``t`` and the ``step``, and ``config.json``) and the same key
names. The JAX logger also mirrors to wandb when it imports; the port
imports nothing outside torch, numpy and the standard library, so it has
no such mirror.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

import numpy as np
import torch


class MetricsLogger:
    def __init__(
        self,
        project: str,
        run_dir: str = "runs",
        config: Mapping[str, Any] | None = None,
        quiet: bool = False,
        enabled: bool = True,
    ):
        """``enabled=False`` (a data-parallel rank other than 0) writes and
        prints nothing."""
        self.project = project
        self.run_dir = os.path.join(run_dir, project)
        self.enabled = enabled
        self.quiet = quiet
        self._t0 = time.time()
        if not enabled:
            return
        os.makedirs(self.run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        if config:
            with open(os.path.join(self.run_dir, "config.json"), "w") as f:
                json.dump(dict(config), f, indent=2, default=str)

    def log(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        if not self.enabled:
            return
        scalars = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        record = {"t": round(time.time() - self._t0, 3), **scalars}
        if step is not None:
            record["step"] = int(step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if not self.quiet:
            parts = [f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in record.items()]
            print(f"[{self.project}] " + " ".join(parts), flush=True)

    def log_image(self, key: str, path: str, step: int | None = None) -> None:
        self.log({key: path}, step=step)

    def finish(self) -> None:
        if self.enabled:
            self._jsonl.close()


class Throughput:
    """Samples/sec since the last ``reset``. It reads the host clock only:
    callers synchronize the device before reading it."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter()
        self._samples = 0

    def add(self, n: int) -> None:
        self._samples += n

    @property
    def samples_per_sec(self) -> float:
        dt = time.perf_counter() - self._start
        return self._samples / dt if dt > 0 else 0.0


class LossAccumulator:
    """Per-step loss scalars buffered as device tensors, without a sync per
    step: ``add`` takes one step's 0-d tensor or a chunk's (K,) tensor of
    steps (``add_many`` names the latter). ``last()`` reads the last one (a
    sync: log points only); ``sum()``, ``mean()``, ``values()`` and
    ``finite_mean_and_bad_count()`` read them all in one copy, at epoch end."""

    def __init__(self):
        self.reset()

    def add(self, loss: torch.Tensor) -> None:
        self._vals.append(loss.reshape(-1))

    def add_many(self, losses: torch.Tensor) -> None:
        """Buffer a chunk's (K,) per-step losses as one entry: K steps."""
        self.add(losses)

    def reset(self) -> None:
        self._vals: list = []

    @property
    def count(self) -> int:
        return sum(len(v) for v in self._vals)

    def last(self) -> float:
        return float(self._vals[-1][-1]) if self._vals else 0.0

    def values(self) -> np.ndarray:
        """Every buffered value (on one device) as a float64 host array."""
        if not self._vals:
            return np.zeros((0,), np.float64)
        return torch.cat(self._vals).double().cpu().numpy()

    def sum(self) -> float:
        return float(self.values().sum())

    def mean(self) -> float:
        return float(self.values().mean()) if self._vals else 0.0

    def finite_mean_and_bad_count(self) -> tuple[float, int]:
        """The mean of the finite entries (inf when none is) and how many
        were not finite, so that a caller can log a skip instead of an epoch
        mean of inf."""
        vals = self.values()
        finite = vals[np.isfinite(vals)]
        return (float(finite.mean()) if len(finite) else float("inf")), len(vals) - len(finite)
