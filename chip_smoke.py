#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tinydiffusion_torch``) on one CUDA card.

    python3 chip_smoke.py

Serves the 256x256 LAION conv beta-VAE from ``checkpoints/vae_laion_best``
through the port's entry points and holds every hand-written kernel on that
path against its plain PyTorch version. Phases, one JSON line each:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: the kernels, built with nvcc from ``tinydiffusion_torch/ops/csrc``;
3. kernel: the CUDA flash-attention forward against ``flash_fwd_reference``
   at each shape the model gives it (B = 4), out and lse, and the times of
   kernel, plain version and ``scaled_dot_product_attention`` (a yardstick
   only; the port never calls it);
4. slice: reconstruct 4 synthetic images and decode 16 prior samples on the
   card, with the kernel launches counted over exactly that work; check
   shapes, finiteness, the [0, 1] range and the card against the port's own
   CPU run;
5. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

``--profile`` adds a phase before the last two lines: ``torch.profiler`` over
one warm reconstruct and one prior decode, with device time by kernel and
the device's busy share of the window.

Any failure raises and the exit code is non-zero. Without a CUDA card it
exits 1 before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from tinydiffusion_torch.data.laion import synthesize_image
from tinydiffusion_torch.experiments.vae_laion import load_conv_vae, reconstruct, sample_prior
from tinydiffusion_torch.obs.images import save_image_grid
from tinydiffusion_torch.ops import _build, attention

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_laion_best")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version, both float32 on the card: they differ only in
# summation order and exp2 vs exp, ~1e-6 relative on logits of |s| <= ~15.
# The bound is the JAX package's own flash-vs-dense tolerance.
KERNEL_ATOL, KERNEL_RTOL = 2e-4, 5e-4
# Card vs CPU reconstruction, both float32 with TF32 off: only summation
# order differs, through ~30 layers; outputs are sigmoids in [0, 1].
CARD_VS_CPU_ATOL = 1e-3

# (N, D, C) of the kernel on the 256x256 path: enc_attn0 (128x128 map,
# C = 32) and enc_attn1 / dec_attn1 (64x64, C = 64). dec_attn0 (32x32,
# N = 1024) takes the dense path, as in JAX.
KERNEL_SITES = ((16384, 4, 32), (4096, 8, 64))
KERNEL_BATCH = 4
N_RECON, N_PRIOR = 4, 16


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around ``iters`` calls."""
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


def flash_bound_ms(b: int, n: int, d: int, c: int) -> tuple[float, str]:
    """Least time of the forward on an H100: larger of FLOPs and bytes over peak."""
    flops = 2.0 * b * n * n * (d + c)
    # read qt, kt, vt once; write out and lse once (float32)
    nbytes = 4.0 * b * n * (2 * d + c + c + 1)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=smi, **device, torch=torch.__version__,
         cuda=torch.version.cuda)
    return device


def phase_build() -> None:
    build = _build.build()
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    emit("build", seconds=round(build.seconds, 3), cached=build.seconds == 0.0,
         library=os.path.relpath(build.path, REPO), ptxas=ptxas)


def phase_kernel() -> list[dict]:
    rng = np.random.default_rng(SEED)
    sites = []
    for n, d, c in KERNEL_SITES:
        b = KERNEL_BATCH
        # q, k ~ N(0, a^2) with a^2 = 2 / sqrt(D): logits have std 2, and their
        # extremes over B*N^2 pairs reach +-10 and beyond, as the model's do.
        a = (2.0 / d**0.5) ** 0.5
        qt, kt = (torch.from_numpy(a * rng.standard_normal((b, d, n), np.float32)).cuda()
                  for _ in range(2))
        vt = torch.from_numpy(rng.standard_normal((b, c, n), np.float32)).cuda()
        out_k, lse_k = attention.flash_fwd(qt, kt, vt)
        out_r, lse_r = attention.flash_fwd_reference(qt, kt, vt)
        torch.cuda.synchronize()
        torch.testing.assert_close(out_k, out_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        torch.testing.assert_close(lse_k, lse_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        err = max((out_k - out_r).abs().max().item(), (lse_k - lse_r).abs().max().item())
        # (B, 1, N, D) views for the library yardstick, made outside its timing.
        q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous() for x in (qt, kt, vt))
        ms = cuda_ms(lambda: attention.flash_fwd(qt, kt, vt), iters=20)
        plain_ms = cuda_ms(lambda: attention.flash_fwd_reference(qt, kt, vt), iters=5)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0),
                             iters=5)
        bound_ms, bound_by = flash_bound_ms(b, n, d, c)
        site = {"B": b, "N": n, "D": d, "C": c, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "roofline_share": bound_ms / ms}
        emit("kernel", name="flash_fwd", atol=KERNEL_ATOL, rtol=KERNEL_RTOL, **site)
        sites.append(site)
        del qt, kt, vt, q4, k4, v4, out_k, out_r
        torch.cuda.empty_cache()
    return sites


def _nchw(images_uint8: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(images_uint8).permute(0, 3, 1, 2).float() / 255.0


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).cpu().numpy()


def _requests(model) -> tuple[torch.Tensor, torch.Tensor, torch.Generator]:
    """Seeded request inputs: N_RECON synthetic images in [0, 1], their
    reparameterization noise, and the generator of the prior latents."""
    x01 = _nchw(np.stack([synthesize_image(i, model.image_size)[0] for i in range(N_RECON)]))
    eps = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (N_RECON, model.latent_dim), np.float32))
    return x01, eps, torch.Generator(device="cuda").manual_seed(SEED + 2)


def phase_slice() -> int:
    t0 = time.perf_counter()
    model = load_conv_vae(CHECKPOINT, device="cuda")
    load_s = time.perf_counter() - t0
    size = model.image_size
    x01, eps, gen = _requests(model)

    # The main path, with the kernel launches counted over exactly this work.
    torch.cuda.synchronize()
    attention.flash_fwd_launches = 0
    t0 = time.perf_counter()
    recon = reconstruct(model, x01, eps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches_recon = attention.flash_fwd_launches
    prior = sample_prior(model, N_PRIOR, gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = attention.flash_fwd_launches
    if (launches_recon, launches) != (3, 4):
        raise RuntimeError(
            f"flash_fwd launches: {launches_recon} in reconstruct (want 3), "
            f"{launches} with the prior decode (want 4)")

    if tuple(recon.shape) != (N_RECON, 3, size, size):
        raise RuntimeError(f"reconstruction shape {tuple(recon.shape)}")
    if tuple(prior.shape) != (N_PRIOR, 3, size, size):
        raise RuntimeError(f"prior sample shape {tuple(prior.shape)}")
    for name, t in (("reconstruction", recon), ("prior samples", prior)):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{name} hold non-finite values")
        if t.min().item() < 0.0 or t.max().item() > 1.0:
            raise RuntimeError(f"{name} leave [0, 1]")

    # Warm steady-state request times (the counted run above was the first).
    steady = {"reconstruct": [], "sample_prior": []}
    for _ in range(3):
        t_a = time.perf_counter()
        reconstruct(model, x01, eps)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        sample_prior(model, N_PRIOR, gen)
        torch.cuda.synchronize()
        steady["reconstruct"].append(1e3 * (t_b - t_a))
        steady["sample_prior"].append(1e3 * (time.perf_counter() - t_b))

    cpu_model = load_conv_vae(CHECKPOINT, device="cpu")
    recon_cpu = reconstruct(cpu_model, x01[:2], eps[:2])
    card_vs_cpu = (recon[:2].cpu() - recon_cpu).abs().max().item()
    if not card_vs_cpu <= CARD_VS_CPU_ATOL:
        raise RuntimeError(
            f"card vs CPU reconstruction differ by {card_vs_cpu} > {CARD_VS_CPU_ATOL}")

    with tempfile.TemporaryDirectory() as tmp:
        grid = os.path.join(tmp, "vae_laion_smoke.png")
        save_image_grid(
            np.concatenate([_nhwc(x01), _nhwc(recon), _nhwc(prior)]), grid,
            nrow=4, normalize=False)
        grid_bytes = os.path.getsize(grid)

    emit("slice", checkpoint=os.path.relpath(CHECKPOINT, REPO), image_size=size,
         load_s=load_s, recon_images=N_RECON, prior_images=N_PRIOR,
         first_reconstruct_ms=1e3 * (t1 - t0), first_sample_prior_ms=1e3 * (t2 - t1),
         steady_reconstruct_ms=steady["reconstruct"],
         steady_sample_prior_ms=steady["sample_prior"],
         flash_fwd_launches=launches,
         recon_l1_to_input=(recon.cpu() - x01).abs().mean().item(),
         card_vs_cpu_max_abs=card_vs_cpu, card_vs_cpu_atol=CARD_VS_CPU_ATOL,
         grid_png_bytes=grid_bytes,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return launches


def phase_profile() -> None:
    """Device time by kernel over one warm reconstruct + one prior decode."""
    from torch.profiler import ProfilerActivity, profile

    model = load_conv_vae(CHECKPOINT, device="cuda")
    x01, eps, gen = _requests(model)
    reconstruct(model, x01, eps)  # warm-up
    sample_prior(model, N_PRIOR, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reconstruct(model, x01, eps)
        sample_prior(model, N_PRIOR, gen)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {  # device-side events only: CPU ops would count their kernels twice
        ev.key: (ev.self_device_time_total / 1e3, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0
    }
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", window_ms=window_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / window_ms,
         top=[{"kernel": k[:90], "ms": ms, "calls": n} for k, (ms, n) in top])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler breakdown of one warm request pair")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    sites = phase_kernel()
    launches = phase_slice()
    main_site = sites[0]  # N = 16384: the largest share of the kernel's work
    kernel = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tinydiffusion_torch/ops/csrc/flash_fwd.cu",
        "replaces": "tinydiffusion_tpu/ops/attention.py:113",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in sites),
        **{k: main_site[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "sites": sites,
    }
    if args.profile:
        phase_profile()
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
