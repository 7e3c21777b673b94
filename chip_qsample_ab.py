#!/usr/bin/env python3
"""Time the fused q_sample kernel of two checkouts of this repo on one CUDA card.

    python3 chip_qsample_ab.py OLD_TREE NEW_TREE

Each tree is the root of a checkout (``git archive <commit> | tar -x -C DIR``;
only its ``tinydiffusion_torch/`` is read). The trees are timed in the order
OLD, NEW, NEW, OLD, each in a process of its own, which builds that tree's
kernels and launches its ``q_sample_fused`` at the main path's shape
(B = 128, 1x28x28 float32, T = 1000 linear betas) with an int seed, which
every version of the wrapper takes. One JSON line per run:

- ``device_us``: the kernel's own device time, from torch.profiler's kernel
  events over 20 eager launches;
- ``graph_us``: device time per launch of one CUDA graph of 100 launches,
  from CUDA events over 20 replays (a by-value seed replays the same noise,
  which does not change the time); ``graph_floor_us`` is the same for a
  graph of 100 one-element ``add_`` launches.

The card's name and power limit come first. ``chip_smoke.py`` takes its
q_sample timings from the two helpers here.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

KERNEL = "qsample_f32_kernel"
B, SHAPE, T = 128, (1, 28, 28), 1000


def kernel_device_us(launch, kernel: str, calls: int = 20) -> float:
    """Device time in us of one launch of ``kernel``: torch.profiler's events
    of the kernels whose name holds ``kernel``, over ``calls`` calls of
    ``launch``, each of which must launch it once."""
    return kernel_device_us_each([launch], kernel, calls)[0]


def kernel_device_us_each(launches, kernel: str, calls: int = 20,
                          sessions: int = 3) -> list[float]:
    """``kernel_device_us`` of each of ``launches`` from one profiler session:
    ``calls`` calls of each in turn, the kernel events split by start time.
    A session whose events fall short of the launches is taken again, up to
    ``sessions`` in all: CUPTI does not always hand over a later session's
    kernel records."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for launch in launches:
                for _ in range(calls):
                    launch()
            torch.cuda.synchronize()
        events = sorted((ev for ev in prof.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA
                         and kernel in ev.name and ev.self_device_time_total > 0),
                        key=lambda ev: ev.time_range.start)
        counts.append(len(events))
        if len(events) == calls * len(launches):
            return [sum(ev.self_device_time_total for ev in events[i:i + calls]) / calls
                    for i in range(0, len(events), calls)]
    raise RuntimeError(f"{kernel} profile: {counts} events in {sessions} sessions, "
                       f"{calls * len(launches)} launched in each")


def graph_us_per_launch(launch, launches: int = 100, replays: int = 20) -> float:
    """Device time per launch in us of ``launches`` calls of ``launch``
    captured in one CUDA graph, over ``replays`` replays (CUDA events)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / (replays * launches)


def _time_tree(tree: str) -> dict:
    """One tree's timings, in this process: its package comes first on the path."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from tinydiffusion_torch.core.schedule import DiffusionSchedule
    from tinydiffusion_torch.ops import qsample

    if not qsample.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {qsample.__file__}, not the tree {tree}")
    schedule = DiffusionSchedule.linear(T).to("cuda")
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn((B, *SHAPE), generator=gen).cuda()
    t = torch.randint(0, T, (B,), generator=gen).cuda()

    def launch():
        qsample.q_sample_fused(schedule, x0, t, 20261017)

    launch()
    one = torch.zeros(1, device="cuda")
    return {"tree": tree, "device_us": kernel_device_us(launch, KERNEL),
            "graph_us": graph_us_per_launch(launch),
            "graph_floor_us": graph_us_per_launch(lambda: one.add_(1.0))}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--tree":
        print(json.dumps(_time_tree(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_qsample_ab: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    old, new = argv
    for tree in (old, new, new, old):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
