#!/usr/bin/env python3
"""Time the flash-attention kernels of two checkouts of this repo on one CUDA card.

    python3 chip_flash_ab.py OLD_TREE NEW_TREE

Each tree is the root of a checkout (``git archive <commit> tinydiffusion_torch |
tar -x -C DIR``; only its ``tinydiffusion_torch/`` is read). The trees are timed
in the order OLD, NEW, NEW, OLD, each in a process of its own, which builds
that tree's kernels (into the tree's own ``_build/``) and times its
``flash_fwd`` and ``flash_bwd`` wrappers, float32 and bfloat16, at the
conv-VAE's flash sites at B = 4 (``SITES``: 256², 512² and 1024² images; the
1024² sites only with ``--big``), on the operands ``chip_smoke.py`` draws
(the same seed in every process). One JSON line per run:

- ``ms``: by kernel and site, device time a call from CUDA events around 20
  forward or 10 backward calls after two warm-ups (5 and 3 from N = 65536
  on), the backward's scratch and any second kernel included, as the
  wrapper launches them;
- ``sha256``: by kernel and site, a digest of each output (out and lse; dq,
  dk and dv), so that two trees' results can be compared bit for bit;
- ``ptxas``: each flash kernel's registers, spills and ptxas remarks from
  the tree's nvcc log (``-Xptxas -v``), and its dynamic shared memory by
  (D, C).

The card's name and power limit come first; the last line, ``bit_equal``,
says by kernel and site whether every output of NEW equals OLD's.

    python3 chip_flash_ab.py [--big] OLD_TREE NEW_TREE
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

# (N, D, C) of the conv-VAE's flash sites: 256² (enc_attn0, enc/dec_attn1),
# 512² (the same at 4x N, and dec_attn0 at (16, 128)), 1024² (4x again).
SITES = ((16384, 4, 32), (4096, 8, 64), (65536, 4, 32), (16384, 8, 64), (4096, 16, 128))
BIG_SITES = ((262144, 4, 32), (65536, 8, 64), (16384, 16, 128))
BATCH = 4
SEED = 0


def _operands(b: int, n: int, d: int, c: int, dtype: torch.dtype):
    """qt, kt (B, D, N) ~ N(0, 2 / sqrt(D)), vt and the output gradient
    (B, C, N) ~ N(0, 1), as chip_smoke.py::_attention_operands draws them."""
    rng = np.random.default_rng(SEED)
    a = (2.0 / d**0.5) ** 0.5
    qt, kt = (torch.from_numpy(a * rng.standard_normal((b, d, n), np.float32)) for _ in range(2))
    vt, dot = (torch.from_numpy(rng.standard_normal((b, c, n), np.float32)) for _ in range(2))
    return [x.cuda().to(dtype) for x in (qt, kt, vt, dot)]


def _ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(log: str) -> dict[str, dict]:
    """ptxas's report of each kernel in an nvcc log (``-Xptxas -v``), by
    mangled name: registers, spill stores and loads in bytes, and its
    performance remarks (``C75xx``, e.g. a wgmma serialized)."""
    kernels, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kernels.setdefault(name, {"remarks": []})
        elif "Potential Performance Loss" in line:
            # ptxas names the function at the end of a remark and reports it
            # before its "Compiling entry" line.
            fn = line.rsplit("'", 2)[-2] if line.count("'") >= 2 else None
            kernels.setdefault(fn, {"remarks": []})["remarks"].append(
                line.split("Potential Performance Loss:", 1)[1].strip())
        elif name is not None and "spill stores" in line:
            fields = line.replace(",", "").split()
            kernels[name]["spill_stores"] = int(fields[fields.index("spill") - 2])
            kernels[name]["spill_loads"] = int(fields[fields.index("loads") - 3])
        elif name is not None and "Used" in line and "registers" in line:
            fields = line.replace(",", "").split()
            kernels[name]["registers"] = int(fields[fields.index("registers") - 1])
    return kernels


def _digest(x: torch.Tensor) -> str:
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _time_tree(tree: str, sites) -> dict:
    """One tree's timings, in this process: its package comes first on the path."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from tinydiffusion_torch.ops import _build, attention

    if not attention.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {attention.__file__}, not the tree {tree}")
    build = _build.build()
    lib = _build.library()
    smem = {f"{name} ({d}, {c})": getattr(lib, f"tdt_{name}_smem_bytes")(d, c)
            for name in ("flash_fwd", "flash_bwd", "flash_fwd_bf16", "flash_bwd_bf16")
            for _, d, c in sites}
    ms, sha = {}, {}
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        for n, d, c in sites:
            qt, kt, vt, dot = _operands(BATCH, n, d, c, dtype)
            out, lse = attention.flash_fwd(qt, kt, vt)
            delta = (dot.float() * out.float()).sum(1, keepdim=True)
            grads = attention.flash_bwd(qt, kt, vt, dot, lse, delta)
            site = f"N={n} D={d} C={c}"
            sha.setdefault(f"flash_fwd{suffix}", {})[site] = [_digest(x) for x in (out, lse)]
            sha.setdefault(f"flash_bwd{suffix}", {})[site] = [_digest(x) for x in grads]
            del grads
            big = n >= 65536
            ms.setdefault(f"flash_fwd{suffix}", {})[site] = _ms(
                lambda: attention.flash_fwd(qt, kt, vt), iters=5 if big else 20)
            ms.setdefault(f"flash_bwd{suffix}", {})[site] = _ms(
                lambda: attention.flash_bwd(qt, kt, vt, dot, lse, delta), iters=3 if big else 10)
            del qt, kt, vt, dot, out, lse, delta
            torch.cuda.empty_cache()
    return {"tree": tree, "ms": ms, "sha256": sha, "build_seconds": build.seconds,
            "ptxas": {k: v for k, v in ptxas_report(build.log).items() if k and "flash_" in k},
            "dynamic_smem_bytes": smem}


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--tree":
        sites = SITES + BIG_SITES if argv[2] == "big" else SITES
        print(json.dumps(_time_tree(argv[1], sites)), flush=True)
        return 0
    big = argv[:1] == ["--big"]
    argv = argv[1:] if big else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_flash_ab: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    old, new = argv
    runs = []
    for tree in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree, "big" if big else "small"],
            check=True, stdout=subprocess.PIPE, text=True).stdout
        print(out, end="", flush=True)
        runs.append(json.loads(out.strip().splitlines()[-1]))
    equal = {kernel: {site: all(r["sha256"][kernel][site] == runs[0]["sha256"][kernel][site]
                                for r in runs)
                      for site in sites}
             for kernel, sites in runs[0]["sha256"].items()}
    print(json.dumps({"bit_equal": equal}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
