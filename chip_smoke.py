#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tinydiffusion_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's three paths through their entry points and holds every
hand-written kernel on them against its plain PyTorch version: serving the
256x256 LAION conv beta-VAE (``checkpoints/vae_laion_best``), the UNet28
MNIST DDPM main path (train, sample, checkpoint: the port's
``experiments/diffusion.run``) and training the conv-VAE (the port's
``experiments/vae_laion.run``). Phases, one JSON line each:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: the kernels, built with one nvcc call from
   ``tinydiffusion_torch/ops/csrc``;
3. kernel: the CUDA flash-attention forward against ``flash_fwd_reference``
   at each shape the model gives it (B = 4), out and lse, and the times of
   kernel, plain version and ``scaled_dot_product_attention`` (a yardstick
   only; the port never calls it);
4. slice: reconstruct 4 synthetic images and decode 16 prior samples on the
   card, with the kernel launches counted over exactly that work; check
   shapes, finiteness, the [0, 1] range and the card against the port's own
   CPU run;
5. qsample_kernel: the CUDA fused q_sample against ``q_sample_fused_reference``
   at the train path's shape (B = 128, 1x28x28), value for value, and on a
   view whose rows are not 16-byte aligned (the kernel's scalar path); its
   determinism, seed sensitivity and moments; kernel and plain times;
6. train (twice, bfloat16 then float32 compute): ``run()`` at full width,
   batch 128, 2 epochs of 100 steps, 16 samples of
   the 1000-step fp32 sampler after each epoch, the trajectory, metrics and
   checkpoint in temporary directories; kernel launches counted over the
   run (q_sample launches must equal the train steps); the loss finite and
   its last epoch's mean below its first value; warm step time, samples/s
   and sampling seconds;
7. unet_parity: the card against the port's CPU run, TF32 off: eps from the
   committed ``checkpoints/diffusion_final`` weights, one SGD step through
   the step's (t, noise) seam, and a 20-step replayed DDPM chain;
8. train_step_bf16: the main path's step (bfloat16 autocast, Adam) on the
   card against the float32 step on the CPU, 3 steps at batch 128 from
   ``diffusion_final`` through the seam: losses and the direction of the
   weights' update;
9. sample: the 1000-step DDPM from ``diffusion_final``, 16 samples;
10. flash_bwd_kernel: the CUDA flash backward against ``flash_bwd_reference``
    at each flash site (B = 4) and at a ragged N, dq, dk and dv; two calls
    bit-equal; the times of kernel, plain version and the backward of
    ``scaled_dot_product_attention`` (a yardstick only);
11. flash_autograd: gradients through ``flash_attention_unscaled_t`` (the
    autograd Function over both kernels) on the card against the CPU;
12. vae_train: the conv-VAE's ``run()`` at full width (256x256, batch 4,
    float32, clip 10, Adam 1e-4), 2 epochs of 20 steps and 2 val batches,
    outputs in temporary directories; launches counted over the run
    (flash backward = 3 a step); the loss and its components finite; warm
    step time, images/s and peak memory;
13. vae_train_parity: one clip + SGD step from ``vae_laion_best`` (256x256,
    B = 2) on the card against the CPU, cuDNN deterministic: loss
    components, gradients, params, BN statistics, spectral-norm u and sigma;
14. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

``--profile`` adds phases before the last two lines: ``torch.profiler`` over
one warm reconstruct and one prior decode, over 5 warm UNet28 train steps,
over 20 sampler steps and over 3 warm conv-VAE train steps, each with device
time by kernel and the device's busy share of the window.

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

from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.laion import synthesize_image
from tinydiffusion_torch.experiments.common import load_unet28, make_sampler
from tinydiffusion_torch.experiments.diffusion import DiffusionConfig, run
from tinydiffusion_torch.experiments import vae_laion
from tinydiffusion_torch.experiments.vae_laion import load_conv_vae, reconstruct, sample_prior
from tinydiffusion_torch.models.vae_conv import PerceptualNet
from tinydiffusion_torch.obs.images import save_image_grid
from tinydiffusion_torch.ops import _build, attention, qsample
from tinydiffusion_torch.train.trainer import create_train_state, make_train_step

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_laion_best")
UNET_CHECKPOINT = os.path.join(REPO, "checkpoints", "diffusion_final")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version, both float32 on the card: they differ only in
# summation order and exp2 vs exp, ~1e-6 relative on logits of |s| <= ~15.
# The bound is the JAX package's own flash-vs-dense tolerance.
KERNEL_ATOL, KERNEL_RTOL = 2e-4, 5e-4
# Backward kernel vs plain version, both float32 on the card: summation
# order over up to N = 16384 terms and exp2 vs exp. The bound is the JAX
# package's flash-gradient tolerance (tests/test_flash_attention.py).
BWD_ATOL, BWD_RTOL = 5e-4, 1e-3
# Card vs CPU reconstruction, both float32 with TF32 off: only summation
# order differs, through ~30 layers; outputs are sigmoids in [0, 1].
CARD_VS_CPU_ATOL = 1e-3

# (N, D, C) of the kernel on the 256x256 path: enc_attn0 (128x128 map,
# C = 32) and enc_attn1 / dec_attn1 (64x64, C = 64). dec_attn0 (32x32,
# N = 1024) takes the dense path, as in JAX.
KERNEL_SITES = ((16384, 4, 32), (4096, 8, 64))
KERNEL_BATCH = 4
N_RECON, N_PRIOR = 4, 16

# q_sample kernel vs plain version on the same Philox stream: z differs only
# in the last bits of logf/sincosf against torch's log/cos/sin (|z| < 6),
# x_t by the same through one multiply-add.
QSAMPLE_ATOL = 1e-5
QSAMPLE_BATCH, QSAMPLE_SHAPE = 128, (1, 28, 28)
# Integer and float operations per element of the kernel: a Philox4x32-10
# call (10 rounds of 2 mulhi, 2 mullo, 4 xor; 9 key bumps of 2 adds) feeds 4
# elements, ~25 each; the uniform, Box-Muller and the noising add ~10.
QSAMPLE_OPS_PER_ELEMENT = 35
# Train path: full width, batch 128, 2 epochs of 100 steps (the first epoch
# warms cuDNN up; the second gives the warm step time). The raw-integer time
# embedding holds the loss near 1 for the first few dozen steps, in the JAX
# package as here.
TRAIN_EPOCHS, TRAIN_STEPS = 2, 100
# Card vs CPU, float32 with TF32 off on both: only summation order differs.
# Outputs, loss and params absolute; BatchNorm statistics relative.
UNET_CARD_VS_CPU_ATOL = 1e-4
UNET_PARITY_BATCH, CHAIN_T, CHAIN_N = 8, 20, 2
# The bfloat16 step on the card against the float32 step on the CPU. With 8
# bits of mantissa the losses differ by a few tenths of a percent and Adam's
# updates (about lr * sign(grad) on the first steps) point the same way but
# for the elements whose gradient is near zero: on an H100 the losses
# agreed within 0.7 % and the updates had a cosine of 0.988. A skipped
# optimizer step misses both by far (in a CPU run of the check at batch 8,
# losses 34 % and 57 % apart on its second and third steps, and a zero
# update); gradients of the wrong sign give a cosine near -1.
BF16_STEPS, BF16_BATCH = 3, 128
BF16_LOSS_RTOL, BF16_MIN_UPDATE_COS = 0.02, 0.9
# Conv-VAE training at the published recipe (256x256, batch 4, float32,
# clip 10, Adam 1e-4, seeded perceptual net): 88 records leave 80 for
# training (20 steps an epoch) and 8 for validation (2 batches), 2 epochs.
VAE_RECORDS, VAE_EPOCHS = 88, 2
# One clip(10) + SGD step from vae_laion_best, the card against the port on
# the CPU, float32 with TF32 off and cuDNN deterministic: only the order of
# sums differs. Loss components relative; each gradient tensor by its
# relative Frobenius error (train-mode BatchNorms at batch 2 and the
# attention's cancelling sums amplify summation-order differences, as in
# tests/test_torch_vae_train.py); params after the step absolute (lr 1e-3
# times a clipped gradient); BN statistics and spectral-norm u relative.
VAE_PARITY_BATCH, VAE_PARITY_LR = 2, 1e-3
VAE_LOSS_RTOL, VAE_GRAD_REL_ERR = 1e-4, 1.5e-2
VAE_PARAM_ATOL, VAE_STATS_RTOL, VAE_STATS_ATOL = 1e-5, 1e-4, 1e-5


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


def flash_bwd_bound_ms(b: int, n: int, d: int, c: int) -> tuple[float, str]:
    """Least time of the backward on an H100: larger of FLOPs and bytes over
    peak. Per (query, key) pair: the logit (D), dv (C), dp (C), dk (D) and
    dq (D) products; the exp and ds are small beside them."""
    flops = 2.0 * b * n * n * (3 * d + 2 * c)
    # read qt, kt, vt, dOt, lse, delta once; write dqt, dkt, dvt once (float32)
    nbytes = 4.0 * b * n * ((2 * d + 2 * c + 2) + (2 * d + c))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _attention_operands(rng, b: int, n: int, d: int, c: int):
    """qt, kt (B, D, N), vt (B, C, N) on the card: q, k ~ N(0, a^2) with
    a^2 = 2 / sqrt(D), so logits have std 2 and their extremes over B*N^2
    pairs reach +-10 and beyond, as the model's do."""
    a = (2.0 / d**0.5) ** 0.5
    qt, kt = (torch.from_numpy(a * rng.standard_normal((b, d, n), np.float32)).cuda()
              for _ in range(2))
    vt = torch.from_numpy(rng.standard_normal((b, c, n), np.float32)).cuda()
    return qt, kt, vt


def phase_flash_bwd_kernel() -> list[dict]:
    """The CUDA backward against ``flash_bwd_reference`` at each flash site
    (B = 4), with the forward's own lse and a random output gradient; two
    calls bit-equal; a ragged N; kernel, plain and SDPA-backward times."""
    rng = np.random.default_rng(SEED + 11)
    sites = []
    for n, d, c in KERNEL_SITES + ((1000, 4, 32),):
        b = KERNEL_BATCH if n != 1000 else 1  # N = 1000: keys and queries past a block
        qt, kt, vt = _attention_operands(rng, b, n, d, c)
        out_t, lse = attention.flash_fwd_reference(qt, kt, vt)
        dot = torch.from_numpy(rng.standard_normal((b, c, n), np.float32)).cuda()
        delta = (dot * out_t).sum(1, keepdim=True)
        args = (qt, kt, vt, dot, lse, delta)
        got = attention.flash_bwd(*args)
        again = attention.flash_bwd(*args)
        want = attention.flash_bwd_reference(*args)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        errs = {name: (g - w).abs().max().item() for name, g, w in zip(names, got, want)}
        scale = {name: w.abs().max().item() for name, w in zip(names, want)}
        deterministic = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        site = {"B": b, "N": n, "D": d, "C": c, "max_abs_err": max(errs.values()),
                "errs": errs, "max_abs_ref": scale, "bit_equal_over_two_calls": deterministic}
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=BWD_ATOL, rtol=BWD_RTOL)
        if not deterministic:
            raise RuntimeError(f"flash_bwd kernel: two calls differ at N = {n}")
        if n != 1000:
            q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous().requires_grad_()
                          for x in (qt, kt, vt))
            g4 = dot.transpose(1, 2).unsqueeze(1).contiguous()
            o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)  # outside the timing
            site["ms"] = cuda_ms(lambda: attention.flash_bwd(*args), iters=10)
            site["plain_ms"] = cuda_ms(lambda: attention.flash_bwd_reference(*args), iters=3)
            site["library_ms"] = cuda_ms(
                lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), iters=3)
            site["bound_ms"], site["bound_by"] = flash_bwd_bound_ms(b, n, d, c)
            site["roofline_share"] = site["bound_ms"] / site["ms"]
            del q4, k4, v4, g4, o4
        emit("flash_bwd_kernel", name="flash_bwd", atol=BWD_ATOL, rtol=BWD_RTOL, **site)
        sites.append(site)
        del qt, kt, vt, dot, out_t, lse, delta, got, again, want
        torch.cuda.empty_cache()
    return sites


def phase_flash_autograd() -> dict:
    """Gradients through ``flash_attention_unscaled_t`` (the autograd
    Function over both kernels) on the card against the port on the CPU."""
    rng = np.random.default_rng(SEED + 12)
    errs = {}
    for b, (n, d, c) in zip((1, 2), KERNEL_SITES):
        qt, kt, vt = (x.cpu() for x in _attention_operands(rng, b, n, d, c))
        g = torch.from_numpy(rng.standard_normal((b, c, n), np.float32))
        grads = {}
        for dev in ("cuda", "cpu"):
            leaves = [x.to(dev).requires_grad_() for x in (qt, kt, vt)]
            before = attention.flash_bwd_launches
            out = attention.flash_attention_unscaled_t(*leaves)
            out.backward(g.to(dev))
            if dev == "cuda" and attention.flash_bwd_launches != before + 1:
                raise RuntimeError("flash_attention_unscaled_t's backward skipped the kernel")
            grads[dev] = [x.grad.cpu() for x in leaves]
        for name, a, w in zip(("dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
            torch.testing.assert_close(a, w, atol=BWD_ATOL, rtol=BWD_RTOL)
            errs[f"N{n}_{name}"] = (a - w).abs().max().item()
    emit("flash_autograd", atol=BWD_ATOL, rtol=BWD_RTOL, **errs)
    return errs


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


def _reset_launches() -> None:
    attention.flash_fwd_launches = 0
    attention.flash_bwd_launches = 0
    qsample.qsample_launches = 0


def _launches() -> dict:
    return {"flash_fwd": attention.flash_fwd_launches, "flash_bwd": attention.flash_bwd_launches,
            "qsample": qsample.qsample_launches}


def qsample_bound_ms(b: int, feat: int, num_timesteps: int) -> tuple[float, str]:
    """Least time of the fused q_sample on an H100: read x0, t and the two
    tables once, write x_t and z once; ops at the CUDA cores' fp32 rate."""
    nbytes = 4.0 * b * feat * 3 + 8.0 * b + 4.0 * 2 * num_timesteps
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = QSAMPLE_OPS_PER_ELEMENT * b * feat / PEAK_FP32_FLOPS
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def phase_qsample_kernel() -> dict:
    schedule = DiffusionSchedule.linear(1000).to("cuda")
    rng = np.random.default_rng(SEED + 4)
    b = QSAMPLE_BATCH
    x0 = torch.from_numpy(rng.standard_normal((b, *QSAMPLE_SHAPE), np.float32)).cuda()
    t = torch.from_numpy(rng.integers(0, 1000, b)).cuda()
    seed = 20261017
    xt_k, z_k = qsample.q_sample_fused(schedule, x0, t, seed)
    xt_r, z_r = qsample.q_sample_fused_reference(schedule, x0, t, seed)
    torch.cuda.synchronize()
    torch.testing.assert_close(z_k, z_r, atol=QSAMPLE_ATOL, rtol=0)
    torch.testing.assert_close(xt_k, xt_r, atol=QSAMPLE_ATOL, rtol=0)
    err = max((z_k - z_r).abs().max().item(), (xt_k - xt_r).abs().max().item())
    # A contiguous x0 that starts 4 bytes into its storage: its rows are not
    # 16-byte aligned, so the kernel must take its scalar path.
    x0_odd = torch.empty(x0.numel() + 1, device="cuda")[1:].view_as(x0).copy_(x0)
    if x0_odd.data_ptr() % 16 == 0:
        raise RuntimeError("q_sample kernel: the offset view is aligned after all")
    xt_odd, z_odd = qsample.q_sample_fused(schedule, x0_odd, t, seed)
    torch.cuda.synchronize()
    if not (torch.equal(xt_odd, xt_k) and torch.equal(z_odd, z_k)):
        raise RuntimeError("q_sample kernel: an unaligned x0 gave other values")
    xt_again, z_again = qsample.q_sample_fused(schedule, x0, t, seed)
    _, z_other = qsample.q_sample_fused(schedule, x0, t, seed + 1)
    torch.cuda.synchronize()
    if not (torch.equal(z_again, z_k) and torch.equal(xt_again, xt_k)):
        raise RuntimeError("q_sample kernel: the same seed gave other bits")
    if (z_other == z_k).float().mean().item() > 1e-3:
        raise RuntimeError("q_sample kernel: another seed gave the same bits")
    z = z_k.double()
    mean, std = z.mean().item(), z.std().item()
    if not (abs(mean) < 0.01 and abs(std - 1.0) < 0.01):
        raise RuntimeError(f"q_sample kernel noise: mean {mean}, std {std}")
    rows = z_k.reshape(b, -1)
    row_corr = torch.corrcoef(rows[:2].double())[0, 1].item()
    if abs(row_corr) > 0.1:
        raise RuntimeError(f"q_sample kernel rows 0 and 1 correlate: {row_corr}")
    ms = cuda_ms(lambda: qsample.q_sample_fused(schedule, x0, t, seed), iters=50, warmup=5)
    plain_ms = cuda_ms(lambda: qsample.q_sample_fused_reference(schedule, x0, t, seed),
                       iters=50, warmup=5)
    feat = x0[0].numel()
    bound_ms, bound_by = qsample_bound_ms(b, feat, schedule.num_timesteps)
    site = {"B": b, "feat": feat, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "roofline_share": bound_ms / ms, "noise_mean": mean, "noise_std": std,
            "draws": z_k.numel(), "row_corr_0_1": row_corr}
    emit("qsample_kernel", name="qsample", atol=QSAMPLE_ATOL,
         library_note="no one PyTorch call draws the noise and noises x0 together", **site)
    return site


def phase_train(compute_dtype: str, data_root: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        config = DiffusionConfig(
            num_epochs=TRAIN_EPOCHS, max_steps_per_epoch=TRAIN_STEPS, batch_size=128,
            compute_dtype=compute_dtype, log_every=10,
            sample_every_epoch=True, visualize_denoising=True, data_root=data_root,
            out_dir=os.path.join(tmp, "out"), checkpoint_path=os.path.join(tmp, "ckpt"),
            device="cuda",
        )
        _set_default_tf32()  # the VAE phase turned them off; run() must itself
        # The main path, with the kernel launches counted over exactly this run.
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        result = run(config)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _launches()
        if torch.backends.cudnn.allow_tf32:
            raise RuntimeError(f"train ({compute_dtype}): run() left cuDNN's TF32 on")
        steps = result["state"].step
        if steps != TRAIN_EPOCHS * TRAIN_STEPS or launches["qsample"] != steps:
            raise RuntimeError(f"train ({compute_dtype}): {steps} steps, launches {launches}")
        # The loss stays near 1 for ~100 steps (the raw-integer time
        # embedding), so this only catches a run that diverges; the step
        # itself is held against the CPU in train_step_bf16 and unet_parity.
        losses = result["losses"]
        last_epoch = losses[len(losses) // TRAIN_EPOCHS:]
        if not all(np.isfinite(losses)) or not np.mean(last_epoch) < losses[0]:
            raise RuntimeError(f"train ({compute_dtype}): losses {losses}")
        out = config.out_dir
        want = [os.path.join(out, f"generated_mnist_epoch_{e}.png") for e in range(TRAIN_EPOCHS)]
        want += [os.path.join(out, "diffusion", "metrics.jsonl"),
                 os.path.join(out, "denoising_t1000.png")]
        want += [config.checkpoint_path + ext for ext in (".pt", ".npz", ".json")]
        missing = [os.path.relpath(p, tmp) for p in want if not os.path.getsize(p) > 0]
        if missing:
            raise RuntimeError(f"train ({compute_dtype}): missing outputs {missing}")
        with open(os.path.join(out, "diffusion", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        warm = result["epochs"][-1]
        fields = {
            "compute_dtype": compute_dtype, "steps": steps, "batch": config.batch_size,
            "launches": launches, "losses": losses, "wall_s": wall_s,
            "warm_samples_per_sec": warm["samples_per_sec"],
            "warm_step_ms": 1e3 * config.batch_size / warm["samples_per_sec"],
            "first_epoch_samples_per_sec": result["epochs"][0]["samples_per_sec"],
            "sample_seconds": [e["sample_seconds"] for e in result["epochs"]],
            "metrics_records": len(records),
            "checkpoint_bytes": {ext: os.path.getsize(config.checkpoint_path + ext)
                                 for ext in (".pt", ".npz")},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
    emit("train", **fields)
    return fields


def _unet_inputs(n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, 1, 28, 28), np.float32))
    return x, torch.from_numpy(rng.integers(0, 1000, n))


def phase_unet_parity() -> dict:
    """The card against the port's CPU run, float32, TF32 off (load_unet28)."""
    models = {dev: load_unet28(UNET_CHECKPOINT, dev) for dev in ("cuda", "cpu")}
    errs = {}
    x, t = _unet_inputs(4, SEED + 5)
    with torch.inference_mode():
        eps = {dev: m(x.to(dev), t.to(dev)).cpu() for dev, m in models.items()}
    errs["eps"] = (eps["cuda"] - eps["cpu"]).abs().max().item()

    # One SGD step through the (t, noise) seam, in train mode.
    x, t = _unet_inputs(UNET_PARITY_BATCH, SEED + 6)
    x = x.clamp(-1, 1)
    noise = torch.from_numpy(np.random.default_rng(SEED + 7).standard_normal(
        tuple(x.shape), np.float32))
    schedule = DiffusionSchedule.linear(1000)
    losses, params, stats = {}, {}, {}
    for dev, model in models.items():
        state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-2), SEED)
        step = make_train_step(schedule.to(dev))
        losses[dev] = step(state, x.to(dev), t=t.to(dev), noise=noise.to(dev)).item()
        params[dev] = {k: v.detach().cpu() for k, v in model.named_parameters()}
        stats[dev] = {k: v.cpu() for k, v in model.named_buffers() if k.endswith(("mean", "var"))}
    errs["step_loss"] = abs(losses["cuda"] - losses["cpu"])
    errs["step_params"] = max((params["cuda"][k] - v).abs().max().item()
                              for k, v in params["cpu"].items())
    # BatchNorm statistics are compared relative to their size: some running
    # variances of these weights are in the thousands.
    errs["step_stats_rel"] = max(((stats["cuda"][k] - v).abs() / v.abs().clamp_min(1.0)).max().item()
                                 for k, v in stats["cpu"].items())

    # A 20-step DDPM chain with replayed noise, from the stepped weights.
    chain_schedule = DiffusionSchedule.linear(CHAIN_T)
    rng = np.random.default_rng(SEED + 8)
    x_init = torch.from_numpy(rng.standard_normal((CHAIN_N, 1, 28, 28), np.float32))
    stream = torch.from_numpy(rng.standard_normal((CHAIN_T, CHAIN_N, 1, 28, 28), np.float32))
    chains = {}
    for dev, model in models.items():
        sampler = make_sampler(model, chain_schedule.to(dev), (CHAIN_N, 1, 28, 28))
        chains[dev] = sampler(x_init=x_init, noise_stream=stream).cpu()
    errs["chain"] = (chains["cuda"] - chains["cpu"]).abs().max().item()
    if not all(np.isfinite(list(errs.values()))) or max(errs.values()) > UNET_CARD_VS_CPU_ATOL:
        raise RuntimeError(f"unet card vs CPU: {errs} (atol {UNET_CARD_VS_CPU_ATOL})")
    emit("unet_parity", atol=UNET_CARD_VS_CPU_ATOL, losses=losses,
         max_abs_running_var=max(v.abs().max().item() for k, v in stats["cpu"].items()
                                 if k.endswith("var")), **errs)
    return errs


def phase_train_step_bf16() -> dict:
    """The default step (bfloat16, Adam) on the card against the float32
    step on the CPU, from the same weights and the same (x0, t, noise)."""
    rng = np.random.default_rng(SEED + 10)
    batches = [
        (torch.from_numpy(rng.standard_normal((BF16_BATCH, 1, 28, 28), np.float32)).clamp(-1, 1),
         torch.from_numpy(rng.integers(0, 1000, BF16_BATCH)),
         torch.from_numpy(rng.standard_normal((BF16_BATCH, 1, 28, 28), np.float32)))
        for _ in range(BF16_STEPS)
    ]
    schedule = DiffusionSchedule.linear(1000)
    losses, updates = {}, {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = load_unet28(UNET_CHECKPOINT, dev)
        before = torch.cat([p.detach().flatten() for p in model.parameters()])
        state = create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), SEED)
        step = make_train_step(schedule.to(dev), compute_dtype=dtype)
        losses[dev] = [step(state, x.to(dev), t=t.to(dev), noise=n.to(dev)).item()
                       for x, t, n in batches]
        after = torch.cat([p.detach().flatten() for p in model.parameters()])
        updates[dev] = (after - before).double().cpu()
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    a, b = updates["cuda"], updates["cpu"]
    cos = (a @ b / (a.norm() * b.norm())).item()
    fields = {"steps": BF16_STEPS, "batch": BF16_BATCH, "losses": losses, "loss_rel": loss_rel,
              "loss_rtol": BF16_LOSS_RTOL, "update_cos": cos,
              "min_update_cos": BF16_MIN_UPDATE_COS,
              "update_norm_ratio": (a.norm() / b.norm()).item()}
    if not (np.isfinite(cos) and max(loss_rel) <= BF16_LOSS_RTOL and cos >= BF16_MIN_UPDATE_COS):
        raise RuntimeError(f"bfloat16 step on the card vs float32 on the CPU: {fields}")
    emit("train_step_bf16", **fields)
    return fields


def phase_sample() -> dict:
    model = load_unet28(UNET_CHECKPOINT, "cuda")
    schedule = DiffusionSchedule.linear(1000).to("cuda")
    sampler = make_sampler(model, schedule, (16, 1, 28, 28))
    gen = torch.Generator("cuda").manual_seed(SEED + 9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = sampler(gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if tuple(samples.shape) != (16, 1, 28, 28) or not torch.isfinite(samples).all():
        raise RuntimeError(f"samples: shape {tuple(samples.shape)}, finite "
                           f"{torch.isfinite(samples).all().item()}")
    fields = {"samples": 16, "steps": 1000, "seconds": seconds,
              "min": samples.min().item(), "max": samples.max().item(),
              "share_in_unit_range": (samples.abs() <= 1.05).float().mean().item()}
    emit("sample", **fields)
    return fields


def _set_default_tf32() -> None:
    """The TF32 flags as a fresh process has them: a run must turn them off itself."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_vae_train() -> dict:
    """The conv-VAE's ``run()`` at full width on the card, with the kernel
    launches counted over exactly that run."""
    with tempfile.TemporaryDirectory() as tmp:
        config = vae_laion.VAELaionConfig(
            n_records=VAE_RECORDS, epochs=VAE_EPOCHS, log_interval=10,
            out_dir=os.path.join(tmp, "out"), checkpoint_dir=os.path.join(tmp, "ckpt"),
            device="cuda")
        _set_default_tf32()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        result = vae_laion.run(config)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if torch.backends.cudnn.allow_tf32:
            raise RuntimeError("vae_train: run() left cuDNN's TF32 on")
        steps = result["state"].step
        per_epoch = VAE_RECORDS - VAE_RECORDS // 10
        if steps != VAE_EPOCHS * (per_epoch // config.batch_size):
            raise RuntimeError(f"vae_train: {steps} steps")
        if launches["flash_bwd"] != 3 * steps or launches["flash_fwd"] < 3 * steps:
            raise RuntimeError(f"vae_train: {steps} steps, launches {launches}")
        if launches["qsample"]:
            raise RuntimeError("vae_train: the conv-VAE path launched the q_sample kernel")
        with open(os.path.join(config.out_dir, "vae_laion", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        batches = [r for r in records if "bce" in r]
        epochs = [r for r in records if "test_loss" in r]
        keys = ("batch_train_loss", "bce", "perceptual", "kld", "logvar_max", "mu_absmax")
        values = [r[k] for r in batches for k in keys] + [r["test_loss"] for r in epochs]
        if not batches or len(epochs) != VAE_EPOCHS or not np.all(np.isfinite(values)):
            raise RuntimeError(f"vae_train: metrics {records}")
        want = [os.path.join(config.out_dir, name) for name in (
            "generated_samples.png", *(f"original_vs_reconstructed_epoch_{e}.png"
                                       for e in range(1, VAE_EPOCHS + 1)))]
        want += [os.path.join(config.checkpoint_dir, "vae_laion_best" + ext)
                 for ext in (".pt", ".npz", ".json")]
        missing = [os.path.relpath(p, tmp) for p in want if not os.path.getsize(p) > 0]
        if missing:
            raise RuntimeError(f"vae_train: missing outputs {missing}")
        warm = result["epochs"][-1]
        fields = {
            "image_size": config.image_size, "batch": config.batch_size, "steps": steps,
            "launches": launches, "wall_s": wall_s,
            "warm_step_ms": 1e3 * warm["train_seconds"] / warm["steps"],
            "warm_images_per_sec": warm["images_per_sec"],
            "first_epoch_images_per_sec": result["epochs"][0]["images_per_sec"],
            "first_loss": batches[0]["batch_train_loss"],
            "last_loss": batches[-1]["batch_train_loss"],
            "components_last": {k: batches[-1][k] for k in keys[1:]},
            "test_losses": result["test_losses"], "peak_mem_gib": peak_gib,
        }
    emit("vae_train", **fields)
    return fields


def _frobenius_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def phase_vae_train_parity() -> dict:
    """One clip + SGD step from ``vae_laion_best`` at 256x256 (B = 2), the
    same x and eps: the card against the port on the CPU."""
    rng = np.random.default_rng(SEED + 13)
    x = _nchw(np.stack([synthesize_image(i, 256)[0] for i in range(VAE_PARITY_BATCH)]))
    eps = torch.from_numpy(rng.standard_normal((VAE_PARITY_BATCH, 128), np.float32))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the card's convolutions, reproducibly
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            model = load_conv_vae(CHECKPOINT, device=dev)
            state = vae_laion.create_train_state(
                model, torch.optim.SGD(model.parameters(), lr=VAE_PARITY_LR), SEED)
            step = vae_laion.make_conv_vae_train_step(PerceptualNet().to(dev), 1.0, 10.0)
            before = attention.flash_bwd_launches
            loss, comps = step(state, x.to(dev), eps=eps.to(dev))
            if dev == "cuda" and attention.flash_bwd_launches != before + 3:
                raise RuntimeError("vae_train_parity: the card's step skipped the flash backward")
            out[dev] = {
                "loss": loss.item(), "comps": {k: v.item() for k, v in comps.items()},
                "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
                "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                "stats": {n: b.cpu() for n, b in model.named_buffers()
                          if n.endswith(("running_mean", "running_var", ".u", ".sigma"))},
            }
    finally:
        torch.backends.cudnn.deterministic = deterministic
    card, cpu = out["cuda"], out["cpu"]
    errs = {"loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])}
    for k, v in cpu["comps"].items():
        errs[f"{k}_rel"] = abs(card["comps"][k] - v) / max(abs(v), 1e-30)
    # key biases: softmax ignores a shift of every key, so their gradient is
    # 0 and both sides hold rounding noise; the params after the step hold them.
    grad_errs = {n: _frobenius_rel(card["grads"][n], g) for n, g in cpu["grads"].items()
                 if not n.endswith("key.bias")}
    errs["grad_rel_max"] = max(grad_errs.values())
    errs["grad_rel_argmax"] = max(grad_errs, key=grad_errs.get)
    errs["params_max_abs"] = max((card["params"][n] - p).abs().max().item()
                                 for n, p in cpu["params"].items())
    errs["stats_max_excess"] = max(
        ((card["stats"][n] - b).abs() / (VAE_STATS_ATOL + VAE_STATS_RTOL * b.abs())).max().item()
        for n, b in cpu["stats"].items())
    ok = (max(v for k, v in errs.items() if k.endswith("_rel")) <= VAE_LOSS_RTOL
          and errs["grad_rel_max"] <= VAE_GRAD_REL_ERR
          and errs["params_max_abs"] <= VAE_PARAM_ATOL and errs["stats_max_excess"] <= 1.0)
    fields = {"batch": VAE_PARITY_BATCH, "image_size": 256,
              "loss": {d: out[d]["loss"] for d in out},
              "loss_rtol": VAE_LOSS_RTOL, "grad_rel_err": VAE_GRAD_REL_ERR,
              "param_atol": VAE_PARAM_ATOL, "stats_rtol": VAE_STATS_RTOL,
              "stats_atol": VAE_STATS_ATOL, "cudnn_deterministic": True, **errs}
    if not ok:
        raise RuntimeError(f"conv-VAE step on the card vs the CPU: {fields}")
    emit("vae_train_parity", **fields)
    return fields


def _profile_window(name: str, fn, **fields) -> None:
    """Device time by kernel over one warm call of ``fn``, and the device's
    busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    # Device-side events only: CPU ops would count their kernels twice, and so
    # would a user annotation's range on the device (``Optimizer.step#...``).
    kernels = {
        ev.key: (ev.self_device_time_total / 1e3, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0
        and not getattr(ev, "is_user_annotation", False)
    }
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", window=name, window_ms=window_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / window_ms, kernel_launches=sum(n for _, n in kernels.values()),
         top=[{"kernel": k[:90], "ms": ms, "calls": n} for k, (ms, n) in top], **fields)


def phase_profile() -> None:
    """Four windows: one warm reconstruct + one prior decode of the conv-VAE;
    5 warm UNet28 train steps (batch 128, bfloat16, fused q_sample); 20 steps
    of the fp32 DDPM sampler (16 samples); 3 warm conv-VAE train steps
    (256x256, batch 4, fp32, Adam) from ``vae_laion_best``."""
    model = load_conv_vae(CHECKPOINT, device="cuda")
    x01, eps, gen = _requests(model)
    _profile_window("vae_requests", lambda: (reconstruct(model, x01, eps),
                                             sample_prior(model, N_PRIOR, gen)))

    unet = load_unet28(UNET_CHECKPOINT, "cuda").train()
    schedule = DiffusionSchedule.linear(1000).to("cuda")
    state = create_train_state(unet, torch.optim.Adam(unet.parameters(), lr=1e-3), SEED)
    step = make_train_step(schedule, compute_dtype=torch.bfloat16)
    x0 = torch.rand(128, 1, 28, 28, device="cuda") * 2 - 1
    _profile_window("train_steps", lambda: [step(state, x0) for _ in range(5)], steps=5)

    sampler = make_sampler(unet, DiffusionSchedule.linear(20).to("cuda"), (16, 1, 28, 28))
    sample_gen = torch.Generator("cuda").manual_seed(SEED)
    _profile_window("sampler_steps", lambda: sampler(sample_gen), steps=20)

    vae = load_conv_vae(CHECKPOINT, device="cuda")
    vae_state = vae_laion.create_train_state(vae, vae_laion.make_optimizer(vae, 1e-4), SEED)
    vae_step = vae_laion.make_conv_vae_train_step(PerceptualNet().cuda(), 1.0, 10.0)
    x = _nchw(np.stack([synthesize_image(i, 256)[0] for i in range(4)])).cuda()
    _profile_window("vae_train_steps", lambda: [vae_step(vae_state, x) for _ in range(3)],
                    steps=3, batch=4)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add torch.profiler breakdowns of the serving, train and "
                             "sampling paths")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    sites = phase_kernel()
    _reset_launches()
    launches = phase_slice()
    if qsample.qsample_launches != 0:
        raise RuntimeError("the conv-VAE serving path launched the q_sample kernel")
    qsample_site = phase_qsample_kernel()
    with tempfile.TemporaryDirectory() as data_root:  # the synthetic MNIST cache
        trains = [phase_train(dtype, data_root) for dtype in ("bfloat16", "float32")]
    phase_unet_parity()
    phase_train_step_bf16()
    phase_sample()
    bwd_sites = phase_flash_bwd_kernel()
    phase_flash_autograd()
    vae = phase_vae_train()
    phase_vae_train_parity()
    main_site = sites[0]  # N = 16384: the largest share of the kernel's work
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {
            "name": "flash_fwd",
            "route": "cuda",
            "source": "tinydiffusion_torch/ops/csrc/flash_fwd.cu",
            "replaces": "tinydiffusion_tpu/ops/attention.py:113",
            # The serving path's run; the training run's count beside it.
            "launches": launches,
            "launches_vae_train": vae["launches"]["flash_fwd"],
            "max_abs_err": max(s["max_abs_err"] for s in sites),
            **{k: main_site[k] for k in keys},
            "sites": sites,
        },
        {
            "name": "qsample",
            "route": "cuda",
            "source": "tinydiffusion_torch/ops/csrc/qsample.cu",
            "replaces": "tinydiffusion_tpu/ops/qsample.py:45",
            # The main path's run: the default (bfloat16) train run.
            "launches": trains[0]["launches"]["qsample"],
            "launches_float32_run": trains[1]["launches"]["qsample"],
            "max_abs_err": qsample_site["max_abs_err"],
            **{k: qsample_site[k] for k in keys},
        },
        {
            "name": "flash_bwd",
            "route": "cuda",
            "source": "tinydiffusion_torch/ops/csrc/flash_bwd.cu",
            "replaces": "tinydiffusion_tpu/ops/attention.py:193",
            "launches": vae["launches"]["flash_bwd"],
            "max_abs_err": max(s["max_abs_err"] for s in bwd_sites),
            **{k: bwd_sites[0][k] for k in keys},  # N = 16384
            "sites": bwd_sites,
        },
    ]
    if args.profile:
        phase_profile()
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
