"""Experiment tracking: console + JSONL, and a throughput counter.

Counterpart of ``MetricsLogger`` and ``Throughput`` in
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


class MetricsLogger:
    def __init__(
        self,
        project: str,
        run_dir: str = "runs",
        config: Mapping[str, Any] | None = None,
        quiet: bool = False,
    ):
        self.project = project
        self.run_dir = os.path.join(run_dir, project)
        os.makedirs(self.run_dir, exist_ok=True)
        self.quiet = quiet
        self._t0 = time.time()
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        if config:
            with open(os.path.join(self.run_dir, "config.json"), "w") as f:
                json.dump(dict(config), f, indent=2, default=str)

    def log(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
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
