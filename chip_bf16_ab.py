#!/usr/bin/env python3
"""Time the UNet28 train step, a DPM++-15 serving request and the conv-VAE's
bf16 train step of two checkouts of this repo on one CUDA card.

    python3 chip_bf16_ab.py OLD_TREE NEW_TREE

Each tree is the root of a checkout (``git archive <commit> | tar -x -C DIR``)
with its ``chip_smoke.py`` and ``tinydiffusion_torch/``; a tree without its
``checkpoints/`` reads this script's checkout's (a link is made). The trees
run in the order OLD, NEW, NEW, OLD, each in a process of its own, which
builds that tree's kernels and takes, with that tree's own
``chip_smoke.py`` helpers:

- ``train_steps_graph`` (bfloat16) and ``train_steps_graph_f32``: the main
  path's resident UNet28 step (width 64, B = 128, Adam, fused q_sample, a
  seeded init), 5 steps replayed from one captured CUDA graph;
- ``serve_dpmpp15``: the chain of one DPM++-15 request on
  ``conditional_cfg_ema_best`` (guidance 2 at doubled batch, n = 16, the
  bf16 forward on the EMA shadow), replayed from its graphs;
- ``vae_train_bf16_steps_graph``: 3 replayed conv-VAE steps at 256² (B = 4,
  ``vae_laion_best``, model and perceptual net in bfloat16).

Each is timed by CUDA events (``chip_smoke.cuda_ms``: 10 calls, 5 for a
request and a conv-VAE call) and profiled by ``chip_smoke._profile_window``,
whose ``profile`` line (busy share, kernels, top kernels) the process
prints. The card's name and power limit come first; then each process's
lines, each with its tree, and a last line with each tree's times side by
side.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS, SERVE_STEPS, SERVE_N, VAE_STEPS = 5, 15, 16, 3


def measure(tree: str) -> dict:
    """This process's times of ``tree``'s port; its profile lines go to
    stdout as ``chip_smoke.emit`` prints them."""
    sys.path.insert(0, tree)
    import chip_smoke as cs  # the tree's own

    assert os.path.dirname(os.path.abspath(cs.__file__)) == os.path.abspath(tree)
    cs.disable_tf32()
    ms = {}
    schedule = cs.DiffusionSchedule.linear(1000).to("cuda")
    images = np.random.default_rng(cs.SEED + 16).integers(0, 256, (128 * STEPS, 28, 28, 1),
                                                          dtype=np.uint8)
    for dtype, name in ((torch.bfloat16, "train_steps_graph"),
                        (torch.float32, "train_steps_graph_f32")):
        state, dataset = cs._resident_state(images)
        step = cs.make_resident_multi_step(schedule, dataset, compute_dtype=dtype)
        idxs = dataset.epoch_index_batches(0)
        ms[name] = cs.cuda_ms(lambda: step(state, idxs), iters=10) / STEPS
        cs._profile_window(name, lambda: step(state, idxs), steps=STEPS)
        del state, dataset, step

    cfg = cs.load_pixel_checkpoint(cs.CFG_CHECKPOINT, "cuda")
    serve = cs.make_sampler(cfg["model"], cfg["schedule"], (SERVE_N, 1, 28, 28), conditional=True,
                            method="dpmpp", sample_steps=SERVE_STEPS, guidance_scale=2.0,
                            null_label=cs.NULL_LABEL, compute_dtype=torch.bfloat16)
    y7 = torch.full((SERVE_N,), 7, dtype=torch.int64, device="cuda")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)

    def request():
        return serve(gen, params=cfg["params"], y=y7)

    request()  # the first request captures the chain
    ms["serve_dpmpp15"] = cs.cuda_ms(request, iters=5)
    cs._profile_window("serve_dpmpp15", request, steps=SERVE_STEPS, n=SERVE_N)

    vae = cs._conv_vae(torch.bfloat16)
    vae_state = cs.vae_laion.create_train_state(
        vae, cs.vae_laion.make_optimizer(vae, 1e-4, capturable=True), cs.SEED)
    vae_images = np.random.default_rng(cs.SEED + 29).integers(0, 256, (4 * VAE_STEPS, 256, 256, 3),
                                                               dtype=np.uint8)
    vae_data = cs.DeviceDataset(vae_images, 4, seed=cs.SEED, device="cuda",
                                u8_normalize=(1.0 / 255.0, 0.0))
    vae_step = cs.vae_laion.make_conv_vae_resident_step(
        cs.PerceptualNet(seed=123, dtype=torch.bfloat16).cuda(), 1.0, 10.0, vae_data)
    vae_idxs = vae_data.epoch_index_batches(0)
    ms["vae_train_bf16_steps_graph"] = cs.cuda_ms(lambda: vae_step(vae_state, vae_idxs),
                                                  iters=5) / VAE_STEPS
    # A forward and a backward launch at each of the three attention sites.
    cs._profile_window("vae_train_bf16_steps_graph", lambda: vae_step(vae_state, vae_idxs),
                       expect_flash=VAE_STEPS * 6, steps=VAE_STEPS, batch=4)
    return {"tree": tree, "ms": ms}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_bf16_ab: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    old, new = (os.path.abspath(t) for t in sys.argv[1:])
    for tree in (old, new):
        checkpoints = os.path.join(tree, "checkpoints")
        if os.path.isdir(checkpoints) and not os.listdir(checkpoints):
            os.rmdir(checkpoints)
        if not os.path.exists(checkpoints):
            os.symlink(os.path.join(REPO, "checkpoints"), checkpoints)
    runs = []
    for tree in (old, new, new, old):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        for line in lines[:-1]:
            print(json.dumps({"tree": tree, **line}), flush=True)
        runs.append(lines[-1])
    print(json.dumps({tag: [r["ms"] for r in runs if r["tree"] == tree]
                      for tag, tree in (("old", old), ("new", new))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
