#!/usr/bin/env python3
"""Time the LAION loader's decodes of the 512² fixtures in two checkouts of
this repo, on one host.

    python3 chip_decode_ab.py OLD_TREE NEW_TREE

Each tree is the root of a checkout (``git archive <commit> | tar -x -C DIR``)
with its ``tinydiffusion_torch/``. Both decode the same bytes: the 512²
fixtures of this script's checkout (``tests/fixtures/laion_loader_512*``),
through the tree's own ``data/laion.py::decode_image`` (its C decoders,
built by the tree at its first decode). The trees run in the order OLD,
NEW, NEW, OLD, OLD, NEW, each in a process of its own, which decodes each
file twice untimed, then ``REPEATS`` times, and reports each file's median
and least seconds (None: the tree refuses the file). Unlike
``chip_smoke.py``'s ``laion_loader`` phase, which times one decode a file
right after the previous file's plain decode, every timed decode here
follows a decode of the same file. The host's name comes first (the card's
name and power limit where ``nvidia-smi`` answers), then each process's
line, then a last line with each tree's medians side by side.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REPEATS = 15


def measure(tree: str) -> dict:
    """This process's decode times with ``tree``'s loader."""
    sys.path.insert(0, tree)
    from tinydiffusion_torch.data import laion  # the tree's own

    assert os.path.abspath(laion.__file__).startswith(os.path.abspath(tree) + os.sep)
    times = {}
    for path in sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "laion_loader_512*"))):
        if path.endswith(".json"):
            continue
        with open(path, "rb") as f:
            data = f.read()
        try:
            laion.decode_image(data)
        except ValueError:
            times[os.path.basename(path)] = None
            continue
        laion.decode_image(data)
        runs = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            laion.decode_image(data)
            runs.append(time.perf_counter() - t0)
        times[os.path.basename(path)] = {"median_s": statistics.median(runs), "min_s": min(runs)}
    return {"tree": tree, "s": times}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        card = None
    print(json.dumps({"host": os.uname().nodename, "card": card}), flush=True)
    old, new = (os.path.abspath(t) for t in sys.argv[1:])
    runs = []
    for tree in (old, new, new, old, old, new):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({tag: {name: [r["s"][name] and round(1e3 * r["s"][name]["median_s"], 3)
                                   for r in runs if r["tree"] == tree]
                            for name in runs[0]["s"]}
                      for tag, tree in (("old_ms", old), ("new_ms", new))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
