#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tinydiffusion_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths through their entry points and holds every
hand-written kernel on them against its plain PyTorch version: serving the
256x256 LAION conv beta-VAE (``checkpoints/vae_laion_best``), the UNet28
MNIST DDPM main path (train, sample, checkpoint: the port's
``experiments/diffusion.run``), class-conditional training with label
dropout (``experiments/conditional_diffusion.run``), the serving CLI
(``generate.main``: DDPM, DDIM, DPM-Solver++, guidance, img2img,
inpainting) and training the conv-VAE (``experiments/vae_laion.run``), and
the latent family: the MNIST MLP VAE (``experiments/vae.run``), latent
diffusion with the MLP UNet and the DiT (``experiments/latent_diffusion.run``)
and the serving CLI on their checkpoints. Phases, one JSON line each:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: the kernels, built with one nvcc call from
   ``tinydiffusion_torch/ops/csrc``: ptxas's registers, spills and shared
   memory per kernel, the flash kernels' dynamic shared memory, and the
   tensor-core instructions (HMMA, HGMMA) in each kernel's SASS
   (``cuobjdump``); fails if a flash forward or backward kernel has none;
3. kernel: the CUDA flash-attention forward against ``flash_fwd_reference``
   at each shape the model gives it (B = 4) and at two ragged N, out and lse;
   two calls bit-equal; the times of kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it); the bound (products at the TF32 tensor-core peak or bytes at the
   memory rate), the CUDA cores' fp32 bound and the exp unit's time beside it;
4. slice: reconstruct 4 synthetic images and decode 16 prior samples on the
   card, with the kernel launches counted over exactly that work; check
   shapes, finiteness, the [0, 1] range and the card against the port's own
   CPU run;
5. qsample_kernel: the CUDA fused q_sample against ``q_sample_fused_reference``
   at the train path's shape (B = 128, 1x28x28), value for value, with an int
   seed and with the seed in device memory, and on a view whose rows are not
   16-byte aligned (the kernel's scalar path); its determinism, seed
   sensitivity and moments; a seed drawn on the card and the kernel captured
   in one CUDA graph, two replays drawing different noise, each equal to the
   plain version at the seed read back; the eager call's time (``ms``), the
   kernel's own device time (profiler, ``device_us``), its time per launch in
   a graph of 100 (``graph_us``) beside that of 100 one-element adds
   (``graph_floor_us``), and the plain version's time; then the latent
   step's shape (128, 20) and a ragged (128, 18), each bit-equal to the plain
   version, with their times;
6. train (bfloat16, then float32 compute) and train_host (bfloat16):
   ``run()`` at full width, batch 128, 2 epochs of 100 steps, 16 samples of
   the 1000-step fp32 sampler after each epoch, the trajectory, metrics and
   checkpoint in temporary directories. ``train`` takes the default
   placement, the set resident on the card and each step a replay of one
   captured CUDA graph; ``train_host`` streams batches from the host. Kernel
   launches counted over the run (q_sample launches, graph replays
   included, must equal the train steps); the loss finite and its last
   epoch's mean below its first value; warm step time, samples/s and
   sampling seconds;
7. cond_train: the class-conditional ``run()`` at the committed CFG recipe
   (``conditional_cfg_ema_best.json``: width 64, B = 128, bf16, label
   dropout 0.1, EMA 0.999, guidance 2.0; resident, graph replays), 2 epochs
   of 100 steps and 93 val batches; q_sample launches counted over the run,
   train steps and val passes apart (one a step, one a val batch), the
   graph's captures and replays, warm samples/s, val losses, the seconds of
   the 16-sample CFG DDPM-1000 digit-7 grid; the best checkpoint loads back;
   vae_mnist_train: the MNIST VAE's ``run()`` at the published recipe
   (Adam 1e-3, B = 128, fp32; resident, graph replays), 2 epochs of 100
   steps and the 78-batch test pass: graph counts, warm samples/s, the last
   epoch's mean loss below the first logged one, the checkpoint loads as
   latent diffusion's VAE; latent_train, once per backbone (``mlp_unet``,
   ``dit``): ``run()`` at the committed checkpoint's recipe (bf16, B = 128;
   the DiT's per-epoch cosine rate) from ``vae_mnist_best``, 2 epochs of
   100 steps and the 93-batch val pass: q_sample launches at (128, 20),
   train and val apart, graph counts, the rate of each epoch, warm step,
   the digit-7 grid's seconds; for the DiT, a replayed step after the rate
   is set on the device tensor against the same step eager;
8. resident_parity: 10 steps of the resident step (2 eager warm-up steps,
   then 8 graph replays) against the same 10 steps run eagerly from the same
   state (``diffusion_final``, with an EMA) on the card, float32 and
   bfloat16: losses, the update's cosine (params, and the EMA shadow on its
   own), the largest params and BatchNorm statistics gaps, the generator's
   state after the steps, whether all is bit-equal, beside the same numbers
   for two eager runs (the noise of the atomics); then resident_restore: a
   ``.pt`` of the host path (Adam not capturable) restored into a resident
   state, whose graph captures and replays 4 steps that match the host
   state's own next steps;
9. cond_parity: the same graph-vs-eager check for 10 conditional steps with
   label dropout from the CFG checkpoint's params (labels gathered and
   dropped inside the graph), and one float32 conditional step on the card
   against the CPU through the (t, noise, keep) seam; latent_parity: the
   same graph-vs-eager check for 10 latent steps from each committed latent
   checkpoint, and one float32 latent step card vs CPU through the (z_eps,
   t, noise, masks) seam;
10. unet_parity: the card against the port's CPU run, TF32 off: eps from the
    committed ``checkpoints/diffusion_final`` weights, one SGD step through
    the step's (t, noise) seam, and a 20-step replayed DDPM chain (float32
    forward);
11. train_step_bf16: the main path's step (bfloat16 autocast, Adam) on the
    card against the float32 step on the CPU, 3 steps at batch 128 from
    ``diffusion_final`` through the seam: losses and the direction of the
    weights' update;
12. sample: the 1000-step DDPM from ``diffusion_final``, 16 samples, the
    forward in bf16 (JAX's) and in float32;
13. serve: ``generate.main`` on ``conditional_cfg_ema_best`` (CFG 2.0,
    digit 7, n = 16): DDPM-1000, DDIM-50, DPM++-15, DDIM img2img at
    strength 0.6 and DDIM inpainting (input PNGs from the port's encoder),
    each twice, the second's latency and model forwards; the inpainted
    output equal to x_known where the mask is 1; DDIM-10 and DPM++-10
    chains at n = 4 from one x_init, the card against the CPU with the
    float32 forward, and the card's bf16 forward against the CPU's float32;
    latent_serve: ``generate.main`` on ``latent_diffusion_best`` and
    ``diffusion_transformer_best`` (n = 16, digit 7): DDPM-1000, DDIM-50 and
    DPM++-15 twice each, warm latency and forwards; DDIM-10 decoded images
    card vs CPU, float32 and bf16 forward;
14. flash_bwd_kernel: the CUDA flash backward against ``flash_bwd_reference``
    at each flash site (B = 4) and at two ragged N, dq, dk and dv; two calls
    bit-equal; the times of kernel, plain version and the backward of
    ``scaled_dot_product_attention`` (a yardstick only), with the bounds of
    the ``kernel`` phase;
15. flash_autograd: gradients through ``flash_attention_unscaled_t`` (the
    autograd Function over both kernels) on the card against the CPU;
16. vae_train: the conv-VAE's ``run()`` at full width (256x256, batch 4,
    float32, clip 10, Adam 1e-4), 2 epochs of 20 steps and 2 val batches,
    outputs in temporary directories; launches counted over the run
    (flash backward = 3 a step); the loss and its components finite; warm
    step time, images/s and peak memory;
17. vae_train_parity: one clip + SGD step from ``vae_laion_best`` (256x256,
    B = 2) on the card against the CPU, cuDNN deterministic: loss
    components, gradients, params, BN statistics, spectral-norm u and sigma;
18. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

``--profile`` adds phases before the last two lines: ``torch.profiler`` over
one warm reconstruct and one prior decode, over 5 warm UNet28 train steps
(eager, ``train_steps``, and replayed from a graph over a resident set,
``train_steps_graph``), over 20 sampler steps, over the chain of one
DPM++-15 serving request (``serve_dpmpp15``), over 3 warm conv-VAE train
steps, over 5 latent MLP UNet train steps replayed from a graph
(``latent_train_steps_graph``) and over one DPM++-15 latent request on the
DiT (``latent_serve_dpmpp15``), each with device time by kernel, the
device's busy share of the window and the host's launch calls.

Any failure raises and the exit code is non-zero. Without a CUDA card it
exits 1 before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from chip_qsample_ab import graph_us_per_launch, kernel_device_us_each
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data.laion import synthesize_image
from tinydiffusion_torch.device import disable_tf32
from tinydiffusion_torch import generate
from tinydiffusion_torch.experiments import conditional_diffusion, latent_diffusion, vae, vae_laion
from tinydiffusion_torch.experiments.common import (
    load_latent_checkpoint,
    load_pixel_checkpoint,
    load_unet28,
    make_latent_pixel_sampler,
    make_sampler,
)
from tinydiffusion_torch.experiments.diffusion import DiffusionConfig, run
from tinydiffusion_torch.experiments.vae_laion import load_conv_vae, reconstruct, sample_prior
from tinydiffusion_torch.io.checkpoint import load_sidecar, restore_checkpoint, save_checkpoint
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.models.vae_conv import PerceptualNet
from tinydiffusion_torch.obs.images import load_image28, save_image_grid, write_png
from tinydiffusion_torch.ops import _build, attention, qsample
from tinydiffusion_torch.train.trainer import (
    GRAPH_WARMUP_STEPS,
    create_train_state,
    make_latent_train_step,
    make_resident_latent_multi_step,
    make_resident_multi_step,
    make_train_step,
)

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_laion_best")
UNET_CHECKPOINT = os.path.join(REPO, "checkpoints", "diffusion_final")
CFG_CHECKPOINT = os.path.join(REPO, "checkpoints", "conditional_cfg_ema_best")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). A float32
# product takes at least one TF32 tensor-core pass, so the TF32 rate bounds the
# flash kernels' products whatever computes them; the CUDA cores' fp32 rate is
# printed beside it (fp32_core_bound_ms) for the one-thread-a-row kernels.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# The exp unit (MUFU): 16 ex2 a clock on each of the 132 SMs at the 1.98 GHz
# boost clock. One exp per (query, key) pair: context only (sfu_ms), since a
# kernel may compute some exps on the FMA pipes.
SFU_EXP_PER_S = 132 * 16 * 1.98e9

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
# Ragged sites, B = 1: N = 1000 leaves keys and queries past a tile; N = 1001
# is not a multiple of 4, so the kernels stage it 4 bytes a copy, not 16.
RAGGED_SITES = ((1000, 4, 32), (1001, 8, 64))
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
# Resident step, graph against eager, from the same trained weights on the
# card: 2 eager warm-up steps, then replays. Only the order of floating-point
# atomics (the bilinear resize's backward adds with them) differs, run to run
# as between the two. It moves the losses by float32 rounding that bfloat16
# autocast can round up to a bfloat16 step in a few activations; Adam turns
# the rounding noise of gradients that are zero in exact arithmetic (conv
# biases ahead of a BatchNorm) into +-lr, so the weights are held by the
# cosine of their updates, as in train_step_bf16. From a fresh init, whose
# raw-integer time embedding drives activations into the hundreds, two
# bfloat16 runs part in the second step, before any replay, and by far within
# a few: that start cannot tell a fault from this noise. From the trained
# weights the second step (eager in both runs) already differs in bfloat16,
# and 10 steps' updates reached a cosine of 0.9985 (H100 80GB HBM3): the
# bfloat16 bound sits below that noise, the float32 one at 0.999 (read
# 0.99999). The losses range 0.2-0.35 over these steps, with t; and a replay
# that reused its draws would leave the generator's state, which must equal
# the eager run's exactly, behind.
# The steps keep an EMA of the params (0.99), so that the captured EMA update
# is held too: its update's cosine is checked on its own, with the params'
# bound (in 10 steps at 0.99 the shadow moves about 5 % as far as the
# params, so folded into one cosine with them it would not show). The largest
# gaps, params absolute and BatchNorm running statistics relative (to
# max(|x|, 1)), are bounded at 2.5 times and more the largest of two H100 runs'
# readings, graph vs eager and eager vs eager alike: float32 up to 1.77e-3
# and 0.0152, bfloat16 up to 1.14e-2 and 0.405. In bfloat16 these gaps are
# the atomics' noise, amplified, and cannot tell a fault from it; in float32
# a BatchNorm update missing from the graph (8 of the 10, on a random set far
# from MNIST's statistics) should stand far out (not tried on the card).
PARITY_STEPS, PARITY_BATCH, PARITY_EMA_DECAY = 10, 128, 0.99
PARITY_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
PARITY_MIN_UPDATE_COS = {"float32": 0.999, "bfloat16": 0.99}
PARITY_MAX_PARAM_ABS = {"float32": 5e-3, "bfloat16": 3e-2}
PARITY_MAX_STATS_REL = {"float32": 0.04, "bfloat16": 1.0}
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
# Class-conditional training at the committed CFG recipe
# (checkpoints/conditional_cfg_ema_best.json: width 64, time_dim 256, B = 128,
# bf16, Adam 1e-3, label dropout 0.1, EMA 0.999, guidance 2.0; resident, graph
# replays), cut to 2 epochs of 100 steps with the val pass cut to as many
# batches (the 12 000-image split has 93). Its labels, NULL_LABEL the null class.
COND_EPOCHS, COND_STEPS, NULL_LABEL = 2, 100, 10
# One float32 conditional step (label dropout through the keep seam) on the
# card against the CPU, from the CFG checkpoint's params: only summation order
# differs, as in unet_parity.
COND_PARITY_BATCH, COND_LOSS_RTOL = 32, 1e-4
# Serving from conditional_cfg_ema_best (the EMA shadow, guidance 2.0, digit
# 7, n = 16). The requests, as generate.py's flags.
SERVE_N = 16
SERVE_REQUESTS = {
    "ddpm1000": ["--sampler", "ddpm"],
    "ddim50": ["--sampler", "ddim", "--sample-steps", "50"],
    "dpmpp15": ["--sampler", "dpmpp", "--sample-steps", "15"],
    "img2img": ["--sampler", "ddim", "--sample-steps", "50", "--init-image", "INIT",
                "--strength", "0.6"],
    "inpaint": ["--sampler", "ddim", "--sample-steps", "50", "--inpaint-image", "INIT",
                "--inpaint-mask", "MASK"],
}
# DDIM-10 and DPM++-10 chains at n = 4 (guidance 2.0, a fixed x_init): the
# card's float32 forward against the CPU's, TF32 off, within 1e-3. With the
# bfloat16 forward (autocast) on the card against float32 on the CPU, the
# bounds were set before the first card reading, from CPU runs of the same
# chains (bf16 autocast against float32, both on the CPU): mean |diff| 0.0060
# / 0.0191 and max 0.128 / 0.690 for DDIM / DPM++ at this x_init (0.0029 /
# 0.0118 and 0.026 / 0.085 at another), samples in [-1.96, 1.35]. The largest
# difference is one pixel of a chaotic chain and heavy-tailed, so the mean
# carries the check (about 3 times the CPU's) and the max only catches a
# chain gone wrong.
SERVE_CHAIN_N, SERVE_CHAIN_STEPS = 4, 10
# The latent family (slice 5): the committed MNIST VAE and the two latent
# denoisers, whose sidecars give the train recipes (B = 128, bf16, Adam 1e-3,
# or the DiT's 3e-4 with a per-epoch cosine; fp32 sampling).
VAE_MNIST_CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_mnist_best")
LATENT_CHECKPOINTS = {"mlp_unet": os.path.join(REPO, "checkpoints", "latent_diffusion_best"),
                      "dit": os.path.join(REPO, "checkpoints", "diffusion_transformer_best")}
# q_sample at the latent step's shape, (B, latent_dim) = (128, 20): 80-byte
# rows, the float4 path; and a ragged (128, 18), 72-byte rows, the scalar
# path. The same Philox stream and arithmetic as the plain version on the
# card: bit-equal.
LATENT_QSAMPLE_SITES = ((128, 20), (128, 18))
# MNIST VAE training at the published recipe (Adam 1e-3, B = 128, float32),
# cut from 100 epochs of 468 steps to 2 of 100; the test pass is the whole
# 10k split (78 batches). Latent training at each committed recipe, cut from
# 100 epochs of 375 steps to 2 of 100, the val pass the whole 12k split (93
# batches): q_sample launches once a step and once a val batch.
MNIST_VAE_EPOCHS, MNIST_VAE_STEPS, MNIST_VAE_TEST_BATCHES = 2, 100, 78
LATENT_EPOCHS, LATENT_STEPS, LATENT_VAL_BATCHES = 2, 100, 93
# One float32 latent step (frozen encode, q_sample through the noise seam,
# SGD) on the card against the CPU from each committed checkpoint: only
# summation order differs, as in unet_parity.
LATENT_PARITY_BATCH, LATENT_LOSS_RTOL = 128, 1e-4
# The DiT's learning rate under a captured graph: 3 steps at the cosine's
# epoch-0 rate, then the epoch-1 rate (num_epochs = 2) set on the device
# tensor and one replayed step, against the same steps eager. The replayed
# step's update against the eager one: the cosine with params' fp32 bound and
# a norm ratio within 1 % (a replay that kept the old rate reads 2).
LR_REPLAY_MAX_NORM_GAP = 0.01
# Latent serving from both committed checkpoints (n = 16, digit 7, bf16
# forward, fp32 chain), each request twice.
LATENT_SERVE_REQUESTS = {
    "ddpm1000": (["--sampler", "ddpm"], 1000),
    "ddim50": (["--sampler", "ddim", "--sample-steps", "50"], 50),
    "dpmpp15": (["--sampler", "dpmpp", "--sample-steps", "15"], 15),
}
# DDIM-10 decoded images at n = 4 from a fixed x_init: the card's float32
# forward against the CPU's within 1e-3. The card's bfloat16 forward against
# the CPU's float32: bounds set before any card reading, from CPU runs of the
# same chains (bf16 autocast against float32, both on the CPU): mean |diff|
# 0.0030 / 0.0023 and max 0.062 / 0.079 for the MLP UNet / DiT at this
# x_init (0.0045 / 0.0084 and 0.096 / 0.35 at another); pixels in [-1, 1].
# The mean carries the check, the max only catches a chain gone wrong.
LATENT_SERVE_F32_ATOL = 1e-3
LATENT_SERVE_BF16_MEAN_ABS, LATENT_SERVE_BF16_MAX_ABS = 0.03, 1.0
SERVE_F32_ATOL = 1e-3
SERVE_BF16_MAX_ABS, SERVE_BF16_MEAN_ABS = 1.5, 0.06


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


def _flash_bounds(b: int, n: int, flops: float, nbytes: float) -> dict:
    """The least time of a flash kernel on an H100: the larger of its products'
    FLOPs at the TF32 tensor-core peak and its bytes at the memory rate; beside
    it the CUDA-core fp32 bound and the exp unit's time for one exp a pair."""
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "fp32_core_bound_ms": 1e3 * max(flops / PEAK_FP32_FLOPS, t_bytes),
            "sfu_ms": 1e3 * b * n * n / SFU_EXP_PER_S}


def flash_bound_ms(b: int, n: int, d: int, c: int) -> dict:
    """Bounds of the forward: 2*B*N^2*(D + C) FLOPs (the logit and value
    products); read qt, kt, vt once, write out and lse once (float32)."""
    return _flash_bounds(b, n, 2.0 * b * n * n * (d + c), 4.0 * b * n * (2 * d + c + c + 1))


def flash_bwd_bound_ms(b: int, n: int, d: int, c: int) -> dict:
    """Bounds of the backward. Per (query, key) pair: the logit (D), dv (C),
    dp (C), dk (D) and dq (D) products; the exp and ds are small beside them.
    Read qt, kt, vt, dOt, lse, delta once; write dqt, dkt, dvt once (float32)."""
    return _flash_bounds(b, n, 2.0 * b * n * n * (3 * d + 2 * c),
                         4.0 * b * n * ((2 * d + 2 * c + 2) + (2 * d + c)))


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
    calls bit-equal; two ragged N; kernel, plain and SDPA-backward times."""
    rng = np.random.default_rng(SEED + 11)
    sites = []
    for n, d, c in KERNEL_SITES + RAGGED_SITES:
        b = KERNEL_BATCH if (n, d, c) in KERNEL_SITES else 1
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
        if b == KERNEL_BATCH:
            q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous().requires_grad_()
                          for x in (qt, kt, vt))
            g4 = dot.transpose(1, 2).unsqueeze(1).contiguous()
            o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)  # outside the timing
            site["ms"] = cuda_ms(lambda: attention.flash_bwd(*args), iters=10)
            site["plain_ms"] = cuda_ms(lambda: attention.flash_bwd_reference(*args), iters=3)
            site["library_ms"] = cuda_ms(
                lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), iters=3)
            site.update(flash_bwd_bound_ms(b, n, d, c))
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


def _tensor_core_counts(library: str) -> dict[str, dict[str, int]]:
    """Tensor-core instructions in the SASS of each kernel of the library, by
    demangled name, from ``cuobjdump --dump-sass``: HMMA (mma.sync) and HGMMA
    (wgmma, Hopper's warpgroup product)."""
    bin_dir = os.path.dirname(_build.find_nvcc())
    sass = subprocess.run([os.path.join(bin_dir, "cuobjdump"), "--dump-sass", library],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line or f" {op} " in line:
                    counts[name][op] += 1
    filt = os.path.join(bin_dir, "cu++filt")
    if counts and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(counts), capture_output=True,
                               text=True, timeout=60, check=True).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    return counts


def phase_build() -> None:
    build = _build.build()
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    tensor_core = _tensor_core_counts(str(build.path))
    flash = {k: v for k, v in tensor_core.items() if "flash_" in k and "dq_sum" not in k}
    if not any("flash_fwd" in k for k in flash) or not any("flash_bwd" in k for k in flash):
        raise RuntimeError(f"build: no flash kernels in the SASS: {sorted(tensor_core)}")
    missing = [k for k, v in flash.items() if not sum(v.values())]
    if missing:
        raise RuntimeError(f"build: flash kernels without tensor-core instructions: {missing}")
    lib = _build.library()
    smem = {f"{name} ({d}, {c})": getattr(lib, f"tdt_{name}_smem_bytes")(d, c)
            for name in ("flash_fwd", "flash_bwd") for d, c in sorted(attention.KERNEL_HEAD_WIDTHS)}
    emit("build", seconds=round(build.seconds, 3), cached=build.seconds == 0.0,
         library=os.path.relpath(build.path, REPO), ptxas=ptxas, tensor_core=tensor_core,
         dynamic_smem_bytes=smem)


def phase_kernel() -> list[dict]:
    """The CUDA forward against ``flash_fwd_reference`` at each flash site
    (B = 4) and at two ragged N, out and lse; two calls bit-equal; kernel,
    plain and SDPA times at the sites."""
    rng = np.random.default_rng(SEED)
    sites = []
    for n, d, c in KERNEL_SITES + RAGGED_SITES:
        b = KERNEL_BATCH if (n, d, c) in KERNEL_SITES else 1
        qt, kt, vt = _attention_operands(rng, b, n, d, c)
        out_k, lse_k = attention.flash_fwd(qt, kt, vt)
        again = attention.flash_fwd(qt, kt, vt)
        out_r, lse_r = attention.flash_fwd_reference(qt, kt, vt)
        torch.cuda.synchronize()
        torch.testing.assert_close(out_k, out_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        torch.testing.assert_close(lse_k, lse_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        if not (torch.equal(again[0], out_k) and torch.equal(again[1], lse_k)):
            raise RuntimeError(f"flash_fwd kernel: two calls differ at N = {n}")
        err = max((out_k - out_r).abs().max().item(), (lse_k - lse_r).abs().max().item())
        site = {"B": b, "N": n, "D": d, "C": c, "max_abs_err": err,
                "bit_equal_over_two_calls": True}
        if b == KERNEL_BATCH:
            # (B, 1, N, D) views for the library yardstick, made outside its timing.
            q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous() for x in (qt, kt, vt))
            site["ms"] = cuda_ms(lambda: attention.flash_fwd(qt, kt, vt), iters=20)
            site["plain_ms"] = cuda_ms(lambda: attention.flash_fwd_reference(qt, kt, vt),
                                       iters=5)
            site["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0), iters=5)
            site.update(flash_bound_ms(b, n, d, c))
            site["roofline_share"] = site["bound_ms"] / site["ms"]
            del q4, k4, v4
        emit("kernel", name="flash_fwd", atol=KERNEL_ATOL, rtol=KERNEL_RTOL, **site)
        sites.append(site)
        del qt, kt, vt, out_k, lse_k, again, out_r, lse_r
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
    # The seed in device memory, as the train step draws it: the same values
    # as the same int; and one draw inside a CUDA graph, replayed twice.
    seed_dev = torch.tensor(seed, dtype=torch.int64, device="cuda")
    xt_dev, z_dev = qsample.q_sample_fused(schedule, x0, t, seed_dev)
    torch.cuda.synchronize()
    if not (torch.equal(xt_dev, xt_k) and torch.equal(z_dev, z_k)):
        raise RuntimeError("q_sample kernel: a device seed gave other values than the same int")
    graph_replays = _qsample_graph_replays(schedule, x0, t)
    err = max([err] + [r["max_abs_err"] for r in graph_replays])
    ms = cuda_ms(lambda: qsample.q_sample_fused(schedule, x0, t, seed), iters=50, warmup=5)
    plain_ms = cuda_ms(lambda: qsample.q_sample_fused_reference(schedule, x0, t, seed),
                       iters=50, warmup=5)
    graph_us, floor_us = _qsample_graph_us(schedule, x0, t, seed_dev)
    feat = x0[0].numel()
    bound_ms, bound_by = qsample_bound_ms(b, feat, schedule.num_timesteps)
    site = {"B": b, "feat": feat, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "graph_us": graph_us,
            "graph_floor_us": floor_us, "bound_ms": bound_ms, "bound_by": bound_by,
            "roofline_share": bound_ms / ms, "graph_replays": graph_replays,
            "noise_mean": mean, "noise_std": std, "draws": z_k.numel(),
            "row_corr_0_1": row_corr}
    latent_sites, latent_launches = _qsample_latent_sites(schedule)
    # One profiler session for every site: one launch shape after another.
    site["device_us"], *latent_us = kernel_device_us_each(
        [lambda: qsample.q_sample_fused(schedule, x0, t, seed_dev)] + latent_launches,
        "qsample_f32_kernel")
    for latent, us in zip(latent_sites, latent_us):
        latent["device_us"] = us
    site["latent_sites"] = latent_sites
    emit("qsample_kernel", name="qsample", atol=QSAMPLE_ATOL,
         library_note="no one PyTorch call draws the noise and noises x0 together", **site)
    return site


def _qsample_latent_sites(schedule) -> tuple[list[dict], list]:
    """The kernel at the latent step's (128, 20) and at a ragged (128, 18),
    bit-equal to the plain version on the card, with the main site's times
    (the device time apart), and a launch of each for the profiler."""
    rng = np.random.default_rng(SEED + 22)
    sites, launches = [], []
    for b, feat in LATENT_QSAMPLE_SITES:
        z0 = torch.from_numpy(rng.standard_normal((b, feat), np.float32)).cuda()
        t = torch.from_numpy(rng.integers(0, 1000, b)).cuda()
        seed = 20261017 + feat
        xt_k, z_k = qsample.q_sample_fused(schedule, z0, t, seed)
        xt_r, z_r = qsample.q_sample_fused_reference(schedule, z0, t, seed)
        torch.cuda.synchronize()
        err = max((z_k - z_r).abs().max().item(), (xt_k - xt_r).abs().max().item())
        if err != 0.0:
            raise RuntimeError(f"q_sample kernel at ({b}, {feat}): {err} from the plain version")
        seed_dev = torch.tensor(seed, dtype=torch.int64, device="cuda")
        ms = cuda_ms(lambda: qsample.q_sample_fused(schedule, z0, t, seed), iters=50, warmup=5)
        plain_ms = cuda_ms(lambda: qsample.q_sample_fused_reference(schedule, z0, t, seed),
                           iters=50, warmup=5)
        launches.append(functools.partial(qsample.q_sample_fused, schedule, z0, t, seed_dev))
        bound_ms, bound_by = qsample_bound_ms(b, feat, schedule.num_timesteps)
        sites.append({"B": b, "feat": feat, "row_bytes": 4 * feat, "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "roofline_share": bound_ms / ms})
    return sites, launches


def _qsample_graph_replays(schedule, x0, t) -> list[dict]:
    """A seed drawn on the card and the kernel, captured in one CUDA graph
    and replayed twice: each replay's noise equals the plain version at the
    seed read back from the card, and the two differ."""
    gen = torch.Generator("cuda").manual_seed(SEED + 14)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)  # else every replay would reuse one draw
    with torch.cuda.graph(graph):
        seed_dev = torch.randint(0, 2**31 - 1, (), generator=gen, device="cuda")
        xt_g, z_g = qsample.q_sample_fused(schedule, x0, t, seed_dev)
    replays, zs = [], []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        drawn = int(seed_dev)
        xt_r, z_r = qsample.q_sample_fused_reference(schedule, x0, t, drawn)
        torch.testing.assert_close(z_g, z_r, atol=QSAMPLE_ATOL, rtol=0)
        torch.testing.assert_close(xt_g, xt_r, atol=QSAMPLE_ATOL, rtol=0)
        replays.append({"seed": drawn, "max_abs_err": max((z_g - z_r).abs().max().item(),
                                                          (xt_g - xt_r).abs().max().item())})
        zs.append(z_g.clone())
    if replays[0]["seed"] == replays[1]["seed"] or (zs[0] == zs[1]).float().mean().item() > 1e-3:
        raise RuntimeError(f"q_sample in a graph: two replays drew the same noise {replays}")
    return replays


def _qsample_graph_us(schedule, x0, t, seed_dev) -> tuple[float, float]:
    """The kernel's time per launch inside a graph of 100, and the floor: a
    graph of 100 one-element ``add_`` launches."""
    per_launch = graph_us_per_launch(lambda: qsample.q_sample_fused(schedule, x0, t, seed_dev))
    one = torch.zeros(1, device="cuda")
    return per_launch, graph_us_per_launch(lambda: one.add_(1.0))


def phase_train(compute_dtype: str, data_root: str, placement: str = "auto") -> dict:
    """``run()`` at full width; ``"auto"`` keeps the set on the card and
    replays each step as a CUDA graph, ``"host"`` streams batches."""
    with tempfile.TemporaryDirectory() as tmp:
        config = DiffusionConfig(
            num_epochs=TRAIN_EPOCHS, max_steps_per_epoch=TRAIN_STEPS, batch_size=128,
            compute_dtype=compute_dtype, log_every=10,
            sample_every_epoch=True, visualize_denoising=True, data_root=data_root,
            out_dir=os.path.join(tmp, "out"), checkpoint_path=os.path.join(tmp, "ckpt"),
            device="cuda", data_placement=placement,
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
        if result["resident"] != (placement == "auto"):
            raise RuntimeError(f"train ({compute_dtype}, {placement}): resident "
                               f"{result['resident']}")
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
            "compute_dtype": compute_dtype, "placement": placement,
            "resident_graph": result["resident"], "steps": steps, "batch": config.batch_size,
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
    emit("train" if placement == "auto" else f"train_{placement}", **fields)
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
        sampler = make_sampler(model, chain_schedule.to(dev), (CHAIN_N, 1, 28, 28),
                               compute_dtype=torch.float32)
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


def _resident_state(images: np.ndarray, model=None, ema: bool = False, labels=None):
    """A train state with capturable Adam over ``model`` (default: a
    full-width UNet28 from a seeded init), with an EMA shadow when asked,
    and the resident set (with its labels, when given), on the card."""
    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            model = UNet28()
        model = model.cuda()
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3, capturable=True)
    state = create_train_state(model, optimizer, SEED, ema=ema)
    dataset = DeviceDataset(images, PARITY_BATCH, seed=SEED, device="cuda", labels=labels)
    return state, dataset


def _graph_vs_eager(phase: str, load_model, images: np.ndarray, labels=None, vae=None,
                    **step_options) -> dict:
    """PARITY_STEPS steps of the resident step (GRAPH_WARMUP_STEPS eager, the
    rest replays of its captured graph) against the same steps run eagerly
    (``make_train_step`` on the gathered batches) from the same state
    (``load_model()``), in float32 and in bfloat16, beside a second eager
    run: the noise floor of the card's atomics. With a frozen ``vae`` the
    steps are the latent ones (``make_resident_latent_multi_step`` against
    ``make_latent_train_step``)."""
    disable_tf32()
    schedule = DiffusionSchedule.linear(1000).to("cuda")
    fields = {"steps": PARITY_STEPS, "replayed": PARITY_STEPS - GRAPH_WARMUP_STEPS,
              "batch": PARITY_BATCH, "loss_rtol": PARITY_LOSS_RTOL,
              "min_update_cos": PARITY_MIN_UPDATE_COS, "max_params_abs": PARITY_MAX_PARAM_ABS,
              "max_stats_rel": PARITY_MAX_STATS_REL}
    failed = []

    def flat(tensors):
        return torch.cat([x.detach().flatten() for x in tensors])

    def cos(a, b):
        return (a @ b / (a.norm() * b.norm())).item()

    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        out = {}
        options = dict(step_options, ema_decay=PARITY_EMA_DECAY, compute_dtype=dtype)
        for mode in ("graph", "eager", "eager_again"):
            state, dataset = _resident_state(images, load_model(), ema=True, labels=labels)
            params0 = flat(state.model.parameters())
            ema0 = flat(state.ema_params.values())
            idxs = dataset.epoch_index_batches(0)[:PARITY_STEPS]
            _reset_launches()
            if mode == "graph":
                resident = (make_resident_multi_step(schedule, dataset, **options) if vae is None
                            else make_resident_latent_multi_step(vae, schedule, dataset,
                                                                 **options))
                losses = resident(state, idxs).tolist()
            else:
                step = (make_train_step(schedule, **options) if vae is None
                        else make_latent_train_step(vae, schedule, **options))
                losses = []
                for row in idxs:
                    batch = dataset.gather(torch.from_numpy(row).cuda())
                    x0, y = batch if labels is not None else (batch, None)
                    x0 = x0.permute(0, 3, 1, 2)  # NCHW; the latent VAE reads either
                    losses.append(step(state, x0, y).item())
            torch.cuda.synchronize()
            if qsample.qsample_launches != PARITY_STEPS or state.step != PARITY_STEPS:
                raise RuntimeError(f"{phase} ({mode}): {state.step} steps, "
                                   f"{qsample.qsample_launches} q_sample launches")
            params, ema = flat(state.model.parameters()), flat(state.ema_params.values())
            stats = flat([b for n, b in state.model.named_buffers()
                          if n.endswith(("running_mean", "running_var"))]
                         or [torch.zeros(1, device="cuda")])  # the DiT has no BatchNorm
            out[mode] = {"losses": losses, "params": params, "update": (params - params0).double(),
                         "ema": ema, "ema_update": (ema - ema0).double(), "stats": stats,
                         "generator": state.generator.get_state()}
        # Graph against eager, and eager against itself: the noise floor of
        # the atomics, beside what the graph adds to it.
        fields[name] = {"losses_graph": out["graph"]["losses"],
                        "losses_eager": out["eager"]["losses"]}
        for pair, (g, e) in (("graph_vs_eager", (out["graph"], out["eager"])),
                             ("eager_vs_eager", (out["eager_again"], out["eager"]))):
            fields[name][pair] = {
                "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(g["losses"], e["losses"])),
                "update_cos": cos(g["update"], e["update"]),
                "ema_update_cos": cos(g["ema_update"], e["ema_update"]),
                # The replays advanced the registered generator as eager steps do.
                "generator_equal": torch.equal(g["generator"], e["generator"]),
                "bit_equal": (g["losses"] == e["losses"] and torch.equal(g["params"], e["params"])
                              and torch.equal(g["ema"], e["ema"])
                              and torch.equal(g["stats"], e["stats"])),
                "params_max_abs": (g["params"] - e["params"]).abs().max().item(),
                "stats_max_rel": ((g["stats"] - e["stats"]).abs()
                                  / e["stats"].abs().clamp_min(1.0)).max().item(),
            }
        check = fields[name]["graph_vs_eager"]
        if not (check["generator_equal"] and check["loss_rel"] <= PARITY_LOSS_RTOL[name]
                and check["update_cos"] >= PARITY_MIN_UPDATE_COS[name]
                and check["ema_update_cos"] >= PARITY_MIN_UPDATE_COS[name]
                and check["params_max_abs"] <= PARITY_MAX_PARAM_ABS[name]
                and check["stats_max_rel"] <= PARITY_MAX_STATS_REL[name]):
            failed.append(name)
    if failed:
        raise RuntimeError(f"{phase}: graph vs eager in {failed}: {fields}")
    return fields


def phase_resident_parity() -> dict:
    """The resident step against eager steps from the committed
    ``diffusion_final`` weights (``_graph_vs_eager``)."""
    images = np.random.default_rng(SEED + 15).integers(
        0, 256, (PARITY_BATCH * PARITY_STEPS, 28, 28, 1), dtype=np.uint8)
    fields = _graph_vs_eager("resident_parity", lambda: load_unet28(UNET_CHECKPOINT, "cuda"),
                             images)
    fields["weights"] = os.path.relpath(UNET_CHECKPOINT, REPO)
    emit("resident_parity", **fields)
    return fields


def phase_resident_restore() -> dict:
    """A ``.pt`` written on the host path (Adam not capturable: its param
    groups say so, its step count lies on the CPU) restored into a resident
    state on the card, whose step then captures and replays its graph; its
    float32 losses against the host state's own next steps, eager."""
    disable_tf32()
    k = GRAPH_WARMUP_STEPS + 2
    images = np.random.default_rng(SEED + 16).integers(
        0, 256, (PARITY_BATCH * (k + 1), 28, 28, 1), dtype=np.uint8)
    schedule = DiffusionSchedule.linear(1000).to("cuda")
    model = load_unet28(UNET_CHECKPOINT, "cuda")
    host = create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), SEED)
    state, dataset = _resident_state(images, load_unet28(UNET_CHECKPOINT, "cuda"))
    idxs = dataset.epoch_index_batches(0)
    step = make_train_step(schedule)
    step(host, dataset.gather(torch.from_numpy(idxs[0]).cuda()).permute(0, 3, 1, 2))
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(os.path.join(tmp, "host"), host)
        restore_checkpoint(os.path.join(tmp, "host"), state)
    adam = state.optimizer
    if not (all(g["capturable"] for g in adam.param_groups)
            and all(s["step"].is_cuda for s in adam.state.values())):
        raise RuntimeError("resident_restore: the restored Adam is not capturable")
    _reset_launches()
    losses = make_resident_multi_step(schedule, dataset)(state, idxs[1 : k + 1]).tolist()
    torch.cuda.synchronize()
    if qsample.qsample_launches != k or state.step != k + 1:
        raise RuntimeError(f"resident_restore: {state.step} steps, "
                           f"{qsample.qsample_launches} q_sample launches")
    eager = [step(host, dataset.gather(torch.from_numpy(row).cuda()).permute(0, 3, 1, 2)).item()
             for row in idxs[1 : k + 1]]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, eager))
    fields = {"steps": k, "losses": losses, "losses_host_eager": eager, "loss_rel": loss_rel,
              "loss_rtol": PARITY_LOSS_RTOL["float32"]}
    if not loss_rel <= PARITY_LOSS_RTOL["float32"]:
        raise RuntimeError(f"resident_restore: the restored graph's losses {fields}")
    emit("resident_restore", **fields)
    return fields


def phase_sample() -> dict:
    """16 samples of the 1000-step DDPM from ``diffusion_final``, the model's
    forward in bfloat16 as JAX serves it (its UNet28 is a bf16 model) and,
    for continuity with the earlier runs, in float32; the chain in float32."""
    model = load_unet28(UNET_CHECKPOINT, "cuda")
    schedule = DiffusionSchedule.linear(1000).to("cuda")
    fields = {"samples": 16, "steps": 1000}
    for name, compute_dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        sampler = make_sampler(model, schedule, (16, 1, 28, 28), compute_dtype=compute_dtype)
        gen = torch.Generator("cuda").manual_seed(SEED + 9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = sampler(gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if tuple(samples.shape) != (16, 1, 28, 28) or not torch.isfinite(samples).all():
            raise RuntimeError(f"samples ({name}): shape {tuple(samples.shape)}, finite "
                               f"{torch.isfinite(samples).all().item()}")
        fields[name] = {"seconds": seconds, "min": samples.min().item(),
                        "max": samples.max().item(),
                        "share_in_unit_range": (samples.abs() <= 1.05).float().mean().item()}
    fields["seconds"] = fields["bfloat16"]["seconds"]
    emit("sample", **fields)
    return fields


def phase_cond_train(data_root: str) -> dict:
    """``run()`` of the class-conditional experiment at the committed CFG
    recipe, resident with graph replays, the kernel launches counted over
    exactly that run (train steps and val passes apart)."""
    recipe = load_sidecar(CFG_CHECKPOINT)["config"]
    with tempfile.TemporaryDirectory() as tmp:
        fields = {k: recipe[k] for k in ("batch_size", "lr", "num_timesteps", "num_classes",
                                         "time_dim", "compute_dtype", "sample_dtype",
                                         "ema_decay", "label_dropout", "guidance_scale",
                                         "noise_schedule", "prediction", "val_frac",
                                         "split_seed")}
        config = conditional_diffusion.ConditionalDiffusionConfig(
            **fields, num_epochs=COND_EPOCHS, max_steps_per_epoch=COND_STEPS,
            log_every=COND_STEPS, data_root=data_root, out_dir=os.path.join(tmp, "out"),
            model_save_path=os.path.join(tmp, "ckpt"), device="cuda")
        _set_default_tf32()  # run() must turn TF32 off itself
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        result = conditional_diffusion.run(config)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _launches()
        steps = result["state"].step
        val_batches = min(COND_STEPS, int(round(60_000 * config.val_frac)) // config.batch_size)
        split = result["qsample_launches"]
        graph = result["graph"]
        problems = []
        if torch.backends.cudnn.allow_tf32:
            problems.append("run() left cuDNN's TF32 on")
        if steps != COND_EPOCHS * COND_STEPS or not result["resident"]:
            problems.append(f"{steps} steps, resident {result['resident']}")
        if split != {"train": steps, "eval": COND_EPOCHS * val_batches}:
            problems.append(f"q_sample launches {split}, want {steps} train and "
                            f"{COND_EPOCHS * val_batches} eval")
        if launches["qsample"] != split["train"] + split["eval"]:
            problems.append(f"q_sample launches {launches} against {split}")
        if graph != {"eager": GRAPH_WARMUP_STEPS, "captures": 1,
                     "replays": steps - GRAPH_WARMUP_STEPS}:
            problems.append(f"graph counts {graph}")
        # The raw-integer time embedding holds the loss near 1 for the first
        # hundred steps or so, so this only catches a run that diverges or does
        # not learn at all, as in the train phase: the last epoch's mean train
        # loss below the first logged loss. The val losses stay above 1 this
        # early (eval-mode BatchNorm on running statistics 200 steps old).
        train_losses = [e["train_loss"] for e in result["epochs"]]
        values = result["losses"] + train_losses + result["val_losses"]
        if not np.all(np.isfinite(values)) or not train_losses[-1] < result["losses"][0]:
            problems.append(f"losses {result['losses']}, epoch means {train_losses}, "
                            f"val {result['val_losses']}")
        out = config.out_dir
        want = [os.path.join(out, f"generated_mnist_epoch_{e}.png") for e in range(COND_EPOCHS)]
        want += [os.path.join(out, name) for name in (
            "generated_digit_7.png", f"denoising_t{config.num_timesteps}.png")]
        want += [config.model_save_path + ext for ext in (".pt", ".npz", ".json")]
        missing = [os.path.relpath(p, tmp) for p in want if not os.path.getsize(p) > 0]
        if missing:
            problems.append(f"missing outputs {missing}")
        loaded = load_pixel_checkpoint(config.model_save_path, "cuda")
        if not (loaded["cfg_trained"] and loaded["use_ema"]
                and loaded["model"].class_embedding.weight.shape == (11, 256)):
            problems.append("the best checkpoint does not load as a CFG + EMA UNet28")
        warm = result["epochs"][-1]
        fields = {
            "recipe": os.path.relpath(CFG_CHECKPOINT, REPO) + ".json", "epochs": COND_EPOCHS,
            "steps": steps, "val_batches_per_epoch": val_batches, "launches": launches,
            "qsample_launches": split, "graph": graph, "losses": result["losses"],
            "train_losses": [e["train_loss"] for e in result["epochs"]],
            "val_losses": result["val_losses"], "wall_s": wall_s,
            "warm_samples_per_sec": warm["samples_per_sec"],
            "warm_step_ms": 1e3 * config.batch_size / warm["samples_per_sec"],
            "val_seconds": [e["val_seconds"] for e in result["epochs"]],
            "sample_seconds": [e["sample_seconds"] for e in result["epochs"]],
            "digit7_cfg_ddpm1000_seconds": result["digit7_seconds"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
    if problems:
        raise RuntimeError(f"cond_train: {problems}: {fields}")
    emit("cond_train", **fields)
    return fields


def phase_cond_parity() -> dict:
    """The resident conditional step with label dropout, graph against eager
    (``_graph_vs_eager``, from the CFG checkpoint's params); then one float32
    conditional step on the card against the CPU through the (t, noise,
    keep) seam."""
    images = np.random.default_rng(SEED + 17).integers(
        0, 256, (PARITY_BATCH * PARITY_STEPS, 28, 28, 1), dtype=np.uint8)
    labels = np.random.default_rng(SEED + 18).integers(0, 10, len(images))
    options = dict(conditional=True, label_dropout=0.1, null_label=NULL_LABEL)
    fields = _graph_vs_eager("cond_parity",
                             lambda: load_pixel_checkpoint(CFG_CHECKPOINT, "cuda")["model"],
                             images, labels, **options)
    fields["weights"] = os.path.relpath(CFG_CHECKPOINT, REPO)

    rng = np.random.default_rng(SEED + 19)
    b = COND_PARITY_BATCH
    x = torch.from_numpy(rng.uniform(-1, 1, (b, 1, 28, 28)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, b))
    t = torch.from_numpy(rng.integers(0, 1000, b))
    noise = torch.from_numpy(rng.standard_normal((b, 1, 28, 28)).astype(np.float32))
    keep = torch.from_numpy(rng.uniform(size=b) >= 0.25)  # a quarter to the null class
    schedule = DiffusionSchedule.linear(1000)
    losses, params = {}, {}
    for dev in ("cuda", "cpu"):
        model = load_pixel_checkpoint(CFG_CHECKPOINT, dev)["model"]
        state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-2), SEED)
        step = make_train_step(schedule.to(dev), **options)
        losses[dev] = step(state, x.to(dev), y.to(dev), t=t.to(dev), noise=noise.to(dev),
                           keep=keep.to(dev)).item()
        params[dev] = {k: v.detach().cpu() for k, v in model.named_parameters()}
    step_fields = {
        "batch": b, "dropped": int((~keep).sum()), "losses": losses,
        "loss_rel": abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"]),
        "loss_rtol": COND_LOSS_RTOL,
        "params_max_abs": max((params["cuda"][k] - v).abs().max().item()
                              for k, v in params["cpu"].items()),
    }
    fields["card_vs_cpu_step"] = step_fields
    if not step_fields["loss_rel"] <= COND_LOSS_RTOL:
        raise RuntimeError(f"cond_parity: the float32 step on the card vs the CPU: {step_fields}")
    emit("cond_parity", **fields)
    return fields


def _serve_chains() -> dict:
    """DDIM-10 and DPM++-10 at n = 4 from a fixed x_init (guidance 2.0): the
    card against the CPU, float32 forward (both TF32-free) and, on the card,
    the bfloat16 forward."""
    loaded = {dev: load_pixel_checkpoint(CFG_CHECKPOINT, dev) for dev in ("cuda", "cpu")}
    n = SERVE_CHAIN_N
    x_init = torch.from_numpy(np.random.default_rng(SEED + 20).standard_normal(
        (n, 1, 28, 28)).astype(np.float32))
    y = torch.tensor([0, 3, 7, 9])
    out = {}
    for method in ("ddim", "dpmpp"):
        chains = {}
        for dev, compute_dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                                   ("cuda", torch.bfloat16)):
            ld = loaded[dev]
            sampler = make_sampler(ld["model"], ld["schedule"], (n, 1, 28, 28),
                                   conditional=True, method=method,
                                   sample_steps=SERVE_CHAIN_STEPS, guidance_scale=2.0,
                                   null_label=NULL_LABEL, compute_dtype=compute_dtype)
            chains[(dev, compute_dtype)] = sampler(params=ld["params"], y=y.to(dev),
                                                   x_init=x_init.to(dev)).cpu()
        ref = chains[("cpu", torch.float32)]
        f32 = (chains[("cuda", torch.float32)] - ref).abs()
        bf16 = (chains[("cuda", torch.bfloat16)] - ref).abs()
        out[method] = {"f32_max_abs": f32.max().item(), "bf16_max_abs": bf16.max().item(),
                       "bf16_mean_abs": bf16.mean().item(),
                       "range": [ref.min().item(), ref.max().item()]}
    return out


def phase_serve() -> dict:
    """The port's serving CLI (``generate.main``) on the CFG checkpoint: each
    request twice, its warm (second) latency and model forwards; then the
    chains card against CPU, and the inpainted output against its known
    region."""
    fields = {"checkpoint": os.path.relpath(CFG_CHECKPOINT, REPO), "n": SERVE_N,
              "guidance_scale": 2.0, "digit": 7, "requests": {}}
    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        base = ["--checkpoint", CFG_CHECKPOINT, "--device", "cuda", "--n", str(SERVE_N),
                "--guidance-scale", "2.0", "--digit", "7"]
        init, mask = os.path.join(tmp, "init.png"), os.path.join(tmp, "mask.png")
        for name, flags in SERVE_REQUESTS.items():
            flags = [init if f == "INIT" else mask if f == "MASK" else f for f in flags]
            argv = base + flags + ["--out", os.path.join(tmp, f"{name}.png")]
            generate.main(argv)  # cold: cuDNN's first choices
            result = generate.main(argv)
            samples = result["samples"]
            if tuple(samples.shape) != (SERVE_N, 1, 28, 28) or not torch.isfinite(samples).all():
                problems.append(f"{name}: samples {tuple(samples.shape)}")
            fields["requests"][name] = {"warm_s": result["sample_seconds"],
                                        "forwards": result["forwards"],
                                        "ms_per_forward": 1e3 * result["sample_seconds"]
                                        / result["forwards"]}
            if name == "ddpm1000":
                # The inputs of img2img and inpainting, written by the port's
                # PNG encoder: the first sample, and a mask keeping its left half.
                first = ((samples[0, 0].float().clamp(-1, 1) + 1) * 127.5).round()
                write_png(init, first.to(torch.uint8).cpu().numpy()[..., None])
                keep = np.zeros((28, 28, 1), np.uint8)
                keep[:, :14] = 255
                write_png(mask, keep)
            if name == "inpaint":
                x_known = torch.from_numpy(load_image28(init)).permute(2, 0, 1).cuda()
                known = torch.from_numpy(load_image28(mask) >= 0).permute(2, 0, 1).cuda()
                kept = samples[:, known] == x_known[known]
                fields["inpaint_known_equal"] = bool(kept.all().item())
                if not fields["inpaint_known_equal"]:
                    problems.append("inpainting: the output differs from x_known where mask == 1")
        if qsample.qsample_launches or attention.flash_fwd_launches:
            problems.append(f"serving launched a training or VAE kernel: {_launches()}")
    forwards = {k: v["forwards"] for k, v in fields["requests"].items()}
    # img2img at strength 0.6 starts at t = 599: 50 of its 600 timesteps.
    if forwards != {"ddpm1000": 1000, "ddim50": 50, "dpmpp15": 15, "img2img": 50,
                    "inpaint": 50}:
        problems.append(f"model forwards {forwards}")
    fields["chains"] = _serve_chains()
    fields.update(f32_atol=SERVE_F32_ATOL, bf16_max_abs_bound=SERVE_BF16_MAX_ABS,
                  bf16_mean_abs_bound=SERVE_BF16_MEAN_ABS)
    for method, c in fields["chains"].items():
        if not (c["f32_max_abs"] <= SERVE_F32_ATOL and c["bf16_max_abs"] <= SERVE_BF16_MAX_ABS
                and c["bf16_mean_abs"] <= SERVE_BF16_MEAN_ABS):
            problems.append(f"{method} chain card vs CPU: {c}")
    if problems:
        raise RuntimeError(f"serve: {problems}: {fields}")
    emit("serve", **fields)
    return fields


def phase_vae_mnist_train(data_root: str) -> dict:
    """``experiments.vae.run`` at the published recipe on the default resident
    graph path, cut to 2 epochs of 100 steps; the test pass is the whole
    split."""
    with tempfile.TemporaryDirectory() as tmp:
        config = vae.VAEExperimentConfig(
            epochs=MNIST_VAE_EPOCHS, max_steps_per_epoch=MNIST_VAE_STEPS, data_root=data_root,
            out_dir=os.path.join(tmp, "out"), checkpoint_dir=os.path.join(tmp, "ckpt"),
            device="cuda")
        _set_default_tf32()  # run() must turn TF32 off itself
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        result = vae.run(config)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _launches()
        steps = result["state"].step
        problems = []
        if torch.backends.cudnn.allow_tf32:
            problems.append("run() left cuDNN's TF32 on")
        if steps != MNIST_VAE_EPOCHS * MNIST_VAE_STEPS or not result["resident"]:
            problems.append(f"{steps} steps, resident {result['resident']}")
        if result["graph"] != {"eager": GRAPH_WARMUP_STEPS, "captures": 1,
                               "replays": steps - GRAPH_WARMUP_STEPS}:
            problems.append(f"graph counts {result['graph']}")
        if any(launches.values()):
            problems.append(f"the MNIST VAE launched a hand-written kernel: {launches}")
        test_batches = [e["test_batches"] for e in result["epochs"]]
        if test_batches != [MNIST_VAE_TEST_BATCHES] * MNIST_VAE_EPOCHS:
            problems.append(f"test batches {test_batches}")
        per_sample = [e["loss_per_sample"] for e in result["epochs"]]
        values = result["losses"] + per_sample + result["test_losses"]
        if not np.all(np.isfinite(values)) or not per_sample[-1] < result["losses"][0]:
            problems.append(f"losses per sample {result['losses']}, epoch means {per_sample}, "
                            f"test {result['test_losses']}")
        ckpt = os.path.join(config.checkpoint_dir, "vae_mnist_best")
        want = [os.path.join(config.out_dir, name) for name in (
            "generated_samples.png", *(f"original_vs_reconstructed_epoch_{e}.png"
                                       for e in range(1, MNIST_VAE_EPOCHS + 1)))]
        want += [ckpt + ext for ext in (".pt", ".npz", ".json")]
        missing = [os.path.relpath(p, tmp) for p in want if not os.path.getsize(p) > 0]
        if missing:
            problems.append(f"missing outputs {missing}")
        _, latent_dim = latent_diffusion.load_vae(
            latent_diffusion.LatentDiffusionConfig(vae_checkpoint=ckpt), "cuda")
        warm = result["epochs"][-1]
        fields = {
            "epochs": MNIST_VAE_EPOCHS, "steps": steps, "batch": config.batch_size,
            "launches": launches, "graph": result["graph"], "test_batches": test_batches,
            "losses_per_sample": result["losses"], "epoch_loss_per_sample": per_sample,
            "test_losses": result["test_losses"], "wall_s": wall_s,
            "warm_samples_per_sec": warm["samples_per_sec"],
            "warm_step_ms": 1e3 * config.batch_size / warm["samples_per_sec"],
            "test_seconds": [e["test_seconds"] for e in result["epochs"]],
            "checkpoint_latent_dim": latent_dim,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
    if problems:
        raise RuntimeError(f"vae_mnist_train: {problems}: {fields}")
    emit("vae_mnist_train", **fields)
    return fields


def _dit_lr_replay() -> dict:
    """The DiT's rate under a captured graph: from ``diffusion_transformer_best``
    (float32, dropout on), 3 resident steps at the cosine's epoch-0 rate, the
    epoch-1 rate set on the capturable Adam's device tensor, one more step
    replayed; against the same 4 steps eager (the rate set between them),
    and a second eager run. The fourth step's update is compared."""
    disable_tf32()
    schedule = DiffusionSchedule.linear(1000).to("cuda")
    frozen, _ = latent_diffusion.load_vae(
        latent_diffusion.LatentDiffusionConfig(vae_checkpoint=VAE_MNIST_CHECKPOINT), "cuda")
    rates = latent_diffusion.cosine_decay(latent_diffusion.DIT_LR, 2)
    rng = np.random.default_rng(SEED + 23)
    images = rng.integers(0, 256, (PARITY_BATCH * 4, 28, 28, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, len(images))
    out = {}
    for mode in ("graph", "eager", "eager_again"):
        model = load_latent_checkpoint(LATENT_CHECKPOINTS["dit"], device="cuda")["model"]
        optimizer = torch.optim.Adam(model.parameters(), capturable=True,
                                     lr=torch.tensor(rates(0), device="cuda"))
        state = create_train_state(model, optimizer, SEED)
        dataset = DeviceDataset(images, PARITY_BATCH, seed=SEED, device="cuda", labels=labels)
        idxs = dataset.epoch_index_batches(0)

        def params():
            return torch.cat([p.detach().flatten() for p in model.parameters()]).double()

        _reset_launches()
        if mode == "graph":
            step = make_resident_latent_multi_step(frozen, schedule, dataset)
            step(state, idxs[:3])
            before = params()
            latent_diffusion.set_lr(optimizer, rates(1))
            step(state, idxs[3:])
            replays = step.counts["replays"]
        else:
            step = make_latent_train_step(frozen, schedule)
            for i, row in enumerate(idxs):
                if i == 3:
                    before = params()
                    latent_diffusion.set_lr(optimizer, rates(1))
                x0, y = dataset.gather(torch.from_numpy(row).cuda())
                step(state, x0, y)
        torch.cuda.synchronize()
        out[mode] = {"update": params() - before, "generator": state.generator.get_state(),
                     "lr": float(optimizer.param_groups[0]["lr"]),
                     "launches": qsample.qsample_launches}
    fields = {"lrs": [rates(0), rates(1)], "lr_read_after_set": out["graph"]["lr"],
              "graph_replays": replays, "max_norm_gap": LR_REPLAY_MAX_NORM_GAP,
              "min_update_cos": PARITY_MIN_UPDATE_COS["float32"]}
    for pair, (a, b) in (("graph_vs_eager", (out["graph"], out["eager"])),
                         ("eager_vs_eager", (out["eager_again"], out["eager"]))):
        u, v = a["update"], b["update"]
        fields[pair] = {"update_cos": (u @ v / (u.norm() * v.norm())).item(),
                        "update_norm_ratio": (u.norm() / v.norm()).item(),
                        "generator_equal": torch.equal(a["generator"], b["generator"])}
    check = fields["graph_vs_eager"]
    if not (check["generator_equal"] and replays == 2 and out["graph"]["launches"] == 4
            and abs(out["graph"]["lr"] - rates(1)) <= 1e-6 * rates(1)
            and check["update_cos"] >= PARITY_MIN_UPDATE_COS["float32"]
            and abs(check["update_norm_ratio"] - 1.0) <= LR_REPLAY_MAX_NORM_GAP):
        raise RuntimeError(f"the DiT's rate under the graph: {fields}")
    return fields


def phase_latent_train(backbone: str, data_root: str) -> dict:
    """``experiments.latent_diffusion.run`` at the committed checkpoint's
    recipe from the committed VAE, resident with graph replays, cut to 2
    epochs of 100 steps; the q_sample kernel's launches counted over exactly
    that run, train steps and val passes apart."""
    recipe = load_sidecar(LATENT_CHECKPOINTS[backbone])["config"]
    keys = ("backbone", "batch_size", "lr", "num_timesteps", "num_classes", "time_dim",
            "compute_dtype", "sample_dtype", "ema_decay", "noise_schedule", "prediction",
            "val_frac", "split_seed", "sample_every_epoch", "visualize_denoising")
    with tempfile.TemporaryDirectory() as tmp:
        config = latent_diffusion.LatentDiffusionConfig(
            **{k: recipe[k] for k in keys}, num_epochs=LATENT_EPOCHS,
            max_steps_per_epoch=LATENT_STEPS, log_every=LATENT_STEPS,
            vae_checkpoint=VAE_MNIST_CHECKPOINT, data_root=data_root,
            out_dir=os.path.join(tmp, "out"), model_save_path=os.path.join(tmp, "ckpt"),
            device="cuda")
        _set_default_tf32()  # run() must turn TF32 off itself
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        result = latent_diffusion.run(config)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _launches()
        steps = result["state"].step
        split = result["qsample_launches"]
        graph = result["graph"]
        problems = []
        if torch.backends.cudnn.allow_tf32:
            problems.append("run() left cuDNN's TF32 on")
        if steps != LATENT_EPOCHS * LATENT_STEPS or not result["resident"]:
            problems.append(f"{steps} steps, resident {result['resident']}")
        if split != {"train": steps, "eval": LATENT_EPOCHS * LATENT_VAL_BATCHES}:
            problems.append(f"q_sample launches {split}, want {steps} train and "
                            f"{LATENT_EPOCHS * LATENT_VAL_BATCHES} eval")
        if launches != {"flash_fwd": 0, "flash_bwd": 0, "qsample": steps + split["eval"]}:
            problems.append(f"launches {launches} against {split}")
        if graph != {"eager": GRAPH_WARMUP_STEPS, "captures": 1,
                     "replays": steps - GRAPH_WARMUP_STEPS}:
            problems.append(f"graph counts {graph}")
        train_losses = [e["train_loss"] for e in result["epochs"]]
        values = result["losses"] + train_losses + result["val_losses"]
        if not np.all(np.isfinite(values)) or not train_losses[-1] < result["losses"][0]:
            problems.append(f"losses {result['losses']}, epoch means {train_losses}, "
                            f"val {result['val_losses']}")
        lrs = [e["lr"] for e in result["epochs"]]
        if backbone == "dit":
            rates = latent_diffusion.cosine_decay(latent_diffusion.DIT_LR, LATENT_EPOCHS)
            want_lrs = [rates(e) for e in range(LATENT_EPOCHS)]  # 3e-4, 3e-4 (1 + cos(pi/2)) / 2
        else:
            want_lrs = [config.lr] * LATENT_EPOCHS
        if not np.allclose(lrs, want_lrs, rtol=1e-6, atol=0):
            problems.append(f"learning rates {lrs}, want {want_lrs}")
        want = [os.path.join(config.out_dir, "generated_digit_7.png")]
        want += [config.model_save_path + ext for ext in (".pt", ".npz", ".json")]
        missing = [os.path.relpath(p, tmp) for p in want if not os.path.getsize(p) > 0]
        if missing:
            problems.append(f"missing outputs {missing}")
        loaded = load_latent_checkpoint(config.model_save_path, device="cuda")
        if loaded["cfg"]["backbone"] != backbone:
            problems.append("the best checkpoint does not load as its backbone")
        warm = result["epochs"][-1]
        fields = {
            "backbone": backbone, "recipe": os.path.relpath(LATENT_CHECKPOINTS[backbone], REPO)
            + ".json", "compute_dtype": config.compute_dtype, "epochs": LATENT_EPOCHS,
            "steps": steps, "val_batches_per_epoch": LATENT_VAL_BATCHES, "launches": launches,
            "qsample_launches": split, "graph": graph, "lrs": lrs, "losses": result["losses"],
            "train_losses": train_losses, "val_losses": result["val_losses"], "wall_s": wall_s,
            "warm_samples_per_sec": warm["samples_per_sec"],
            "warm_step_ms": 1e3 * config.batch_size / warm["samples_per_sec"],
            "val_seconds": [e["val_seconds"] for e in result["epochs"]],
            "digit7_ddpm1000_seconds": result["digit7_seconds"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
    if problems:
        raise RuntimeError(f"latent_train ({backbone}): {problems}: {fields}")
    if backbone == "dit":
        fields["lr_replay"] = _dit_lr_replay()
    emit("latent_train", **fields)
    return fields


def phase_latent_parity() -> dict:
    """For each committed latent checkpoint: the resident latent step, graph
    against eager (``_graph_vs_eager``, the ``resident_parity`` quantities
    and bounds), and one float32 step on the card against the CPU through
    the (z_eps, t, noise, masks) seam."""
    fields = {}
    for i, (backbone, path) in enumerate(LATENT_CHECKPOINTS.items()):
        rng = np.random.default_rng(SEED + 24 + i)
        images = rng.integers(0, 256, (PARITY_BATCH * PARITY_STEPS, 28, 28, 1), dtype=np.uint8)
        labels = rng.integers(0, 10, len(images))
        frozen = load_latent_checkpoint(path, device="cuda")["vae"]
        out = _graph_vs_eager(f"latent_parity ({backbone})",
                              lambda: load_latent_checkpoint(path, device="cuda")["model"],
                              images, labels, vae=frozen)
        b = LATENT_PARITY_BATCH
        x = torch.from_numpy(rng.uniform(-1, 1, (b, 1, 28, 28)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, b))
        z_eps = torch.from_numpy(rng.standard_normal((b, 20)).astype(np.float32))
        t = torch.from_numpy(rng.integers(0, 1000, b))
        noise = torch.from_numpy(rng.standard_normal((b, 20)).astype(np.float32))
        masks = None
        if backbone == "dit":  # dropout 0.05: masks drawn once, the same on both sides
            masks = load_latent_checkpoint(path, device="cpu")["model"].draw_dropout_masks(
                b, torch.Generator().manual_seed(SEED + 25))
        losses, params = {}, {}
        for dev in ("cuda", "cpu"):
            loaded = load_latent_checkpoint(path, device=dev)
            model = loaded["model"]
            state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-2), SEED)
            step = make_latent_train_step(loaded["vae"], DiffusionSchedule.linear(1000).to(dev))
            losses[dev] = step(
                state, x.to(dev), y.to(dev), z_eps=z_eps.to(dev), t=t.to(dev), noise=noise.to(dev),
                masks=None if masks is None else [tuple(m.to(dev) for m in block)
                                                  for block in masks]).item()
            params[dev] = {k: v.detach().cpu() for k, v in model.named_parameters()}
        out["card_vs_cpu_step"] = {
            "batch": b, "losses": losses,
            "loss_rel": abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"]),
            "loss_rtol": LATENT_LOSS_RTOL,
            "params_max_abs": max((params["cuda"][k] - v).abs().max().item()
                                  for k, v in params["cpu"].items())}
        out["weights"] = os.path.relpath(path, REPO)
        if not out["card_vs_cpu_step"]["loss_rel"] <= LATENT_LOSS_RTOL:
            raise RuntimeError(f"latent_parity ({backbone}): the float32 step on the card vs "
                               f"the CPU: {out['card_vs_cpu_step']}")
        fields[backbone] = out
    emit("latent_parity", **fields)
    return fields


def _latent_serve_chains(path: str) -> dict:
    """DDIM-10 decoded images at n = 4 from a fixed x_init: the card against
    the CPU, float32 forward (both TF32-free) and, on the card, the bfloat16
    forward of the committed recipe."""
    loaded = {dev: load_latent_checkpoint(path, device=dev) for dev in ("cuda", "cpu")}
    x_init = torch.from_numpy(np.random.default_rng(SEED + 21).standard_normal(
        (4, 20)).astype(np.float32))
    y = torch.tensor([0, 3, 7, 9])
    images = {}
    for dev, compute_dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                               ("cuda", torch.bfloat16)):
        sampler = make_latent_pixel_sampler(dict(loaded[dev], compute_dtype=compute_dtype), 4,
                                            method="ddim", sample_steps=10)
        images[(dev, compute_dtype)] = sampler(None, y.to(dev), x_init=x_init.to(dev)).cpu()
    ref = images[("cpu", torch.float32)]
    f32 = (images[("cuda", torch.float32)] - ref).abs()
    bf16 = (images[("cuda", torch.bfloat16)] - ref).abs()
    return {"f32_max_abs": f32.max().item(), "bf16_max_abs": bf16.max().item(),
            "bf16_mean_abs": bf16.mean().item(), "range": [ref.min().item(), ref.max().item()]}


def phase_latent_serve() -> dict:
    """``generate.main`` on both committed latent checkpoints (n = 16, digit
    7, bf16 forward, fp32 chain): each request twice, the warm latency and
    model forwards; then DDIM-10 chains card against CPU."""
    fields = {"n": SERVE_N, "digit": 7, "checkpoints": {}}
    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        for backbone, path in LATENT_CHECKPOINTS.items():
            requests = {}
            for name, (flags, forwards) in LATENT_SERVE_REQUESTS.items():
                argv = ["--checkpoint", path, "--device", "cuda", "--n", str(SERVE_N),
                        "--digit", "7", *flags, "--out", os.path.join(tmp, f"{name}.png")]
                generate.main(argv)  # cold
                result = generate.main(argv)
                samples = result["samples"]
                if not (tuple(samples.shape) == (SERVE_N, 1, 28, 28)
                        and torch.isfinite(samples).all() and samples.abs().max() <= 1.0):
                    problems.append(f"{backbone} {name}: samples {tuple(samples.shape)}")
                if result["forwards"] != forwards or result["labels"] != [7] * SERVE_N:
                    problems.append(f"{backbone} {name}: {result['forwards']} forwards")
                requests[name] = {"warm_s": result["sample_seconds"],
                                  "forwards": result["forwards"],
                                  "ms_per_forward": 1e3 * result["sample_seconds"]
                                  / result["forwards"]}
            chains = _latent_serve_chains(path)
            if not (chains["f32_max_abs"] <= LATENT_SERVE_F32_ATOL
                    and chains["bf16_mean_abs"] <= LATENT_SERVE_BF16_MEAN_ABS
                    and chains["bf16_max_abs"] <= LATENT_SERVE_BF16_MAX_ABS):
                problems.append(f"{backbone} DDIM-10 card vs CPU: {chains}")
            fields["checkpoints"][backbone] = {"checkpoint": os.path.relpath(path, REPO),
                                               "requests": requests, "chains": chains}
        if any(_launches().values()):
            problems.append(f"latent serving launched a hand-written kernel: {_launches()}")
    fields.update(f32_atol=LATENT_SERVE_F32_ATOL, bf16_mean_abs_bound=LATENT_SERVE_BF16_MEAN_ABS,
                  bf16_max_abs_bound=LATENT_SERVE_BF16_MAX_ABS)
    if problems:
        raise RuntimeError(f"latent_serve: {problems}: {fields}")
    emit("latent_serve", **fields)
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
    """Device time by kernel over one warm call of ``fn``, the device's busy
    share of the window, and the flash kernels' device time in it."""
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
    # The host's launch calls: one a kernel when eager, one a graph when replayed.
    host_launches = {ev.key: ev.count for ev in prof.key_averages()
                     if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                   "cuLaunchKernelEx", "cudaGraphLaunch")}
    emit("profile", window=name, window_ms=window_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / window_ms, kernel_launches=sum(n for _, n in kernels.values()),
         host_launch_calls=host_launches,
         flash_ms=sum(ms for k, (ms, _) in kernels.items() if "flash_" in k),
         top=[{"kernel": k[:90], "ms": ms, "calls": n} for k, (ms, n) in top], **fields)


def phase_profile() -> None:
    """Eight windows: one warm reconstruct + one prior decode of the conv-VAE;
    5 warm UNet28 train steps (batch 128, bfloat16, fused q_sample), eager
    and then replayed from a CUDA graph over a resident set; 20 steps
    of the fp32 DDPM sampler (16 samples); the chain of one DPM++-15
    serving request (CFG, bf16 forward, 16 samples); 3 warm conv-VAE train
    steps (256x256, batch 4, fp32, Adam) from ``vae_laion_best``; 5 latent
    MLP UNet train steps replayed from a graph; one DPM++-15 latent serving
    request on the DiT."""
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

    # The same 5 steps as the default run takes them: the set on the card and
    # each step a replay of one captured graph (the warm-up call captures).
    images = np.random.default_rng(SEED + 16).integers(0, 256, (128 * 5, 28, 28, 1),
                                                        dtype=np.uint8)
    graph_state, dataset = _resident_state(images)
    graph_step = make_resident_multi_step(schedule, dataset, compute_dtype=torch.bfloat16)
    idxs = dataset.epoch_index_batches(0)
    _profile_window("train_steps_graph", lambda: graph_step(graph_state, idxs), steps=5)

    sampler = make_sampler(unet, DiffusionSchedule.linear(20).to("cuda"), (16, 1, 28, 28),
                           compute_dtype=torch.float32)
    sample_gen = torch.Generator("cuda").manual_seed(SEED)
    _profile_window("sampler_steps", lambda: sampler(sample_gen), steps=20)

    # One DPM++-15 serving request's chain, as generate.py runs it (CFG 2.0 at
    # doubled batch, the bf16 forward, the EMA shadow; n = 16).
    cfg = load_pixel_checkpoint(CFG_CHECKPOINT, "cuda")
    serve = make_sampler(cfg["model"], cfg["schedule"], (SERVE_N, 1, 28, 28), conditional=True,
                         method="dpmpp", sample_steps=15, guidance_scale=2.0,
                         null_label=NULL_LABEL, compute_dtype=torch.bfloat16)
    y7 = torch.full((SERVE_N,), 7, dtype=torch.int64, device="cuda")
    _profile_window("serve_dpmpp15", lambda: serve(sample_gen, params=cfg["params"], y=y7),
                    steps=15, n=SERVE_N)

    conv_vae = load_conv_vae(CHECKPOINT, device="cuda")
    vae_state = vae_laion.create_train_state(conv_vae, vae_laion.make_optimizer(conv_vae, 1e-4),
                                             SEED)
    vae_step = vae_laion.make_conv_vae_train_step(PerceptualNet().cuda(), 1.0, 10.0)
    x = _nchw(np.stack([synthesize_image(i, 256)[0] for i in range(4)])).cuda()
    _profile_window("vae_train_steps", lambda: [vae_step(vae_state, x) for _ in range(3)],
                    steps=3, batch=4)

    # 5 latent MLP UNet steps (B = 128, bf16, from latent_diffusion_best),
    # replayed from a graph over a resident set, as the default run takes them.
    mlp = load_latent_checkpoint(LATENT_CHECKPOINTS["mlp_unet"], device="cuda")
    rng = np.random.default_rng(SEED + 26)
    images = rng.integers(0, 256, (PARITY_BATCH * 5, 28, 28, 1), dtype=np.uint8)
    latent_state, latent_data = _resident_state(images, mlp["model"],
                                                labels=rng.integers(0, 10, len(images)))
    latent_step = make_resident_latent_multi_step(mlp["vae"], mlp["schedule"], latent_data,
                                                  compute_dtype=torch.bfloat16)
    latent_idxs = latent_data.epoch_index_batches(0)
    _profile_window("latent_train_steps_graph", lambda: latent_step(latent_state, latent_idxs),
                    steps=5)

    # One DPM++-15 latent serving request's chain and decode, as generate.py
    # runs it on the DiT (bf16 forward, fp32 chain; n = 16).
    dit = load_latent_checkpoint(LATENT_CHECKPOINTS["dit"], device="cuda")
    latent_serve = make_latent_pixel_sampler(dit, SERVE_N, method="dpmpp", sample_steps=15)
    _profile_window("latent_serve_dpmpp15", lambda: latent_serve(sample_gen, y7), steps=15,
                    n=SERVE_N)


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
    os.chdir(REPO)  # the committed latent sidecars name their VAE from the repo root
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
        train_host = phase_train("bfloat16", data_root, placement="host")
        cond = phase_cond_train(data_root)
        phase_vae_mnist_train(data_root)
        latents = {backbone: phase_latent_train(backbone, data_root)
                   for backbone in LATENT_CHECKPOINTS}
    phase_resident_parity()
    phase_resident_restore()
    phase_cond_parity()
    phase_latent_parity()
    phase_unet_parity()
    phase_train_step_bf16()
    phase_sample()
    phase_serve()
    phase_latent_serve()
    bwd_sites = phase_flash_bwd_kernel()
    phase_flash_autograd()
    vae = phase_vae_train()
    phase_vae_train_parity()
    main_site = sites[0]  # N = 16384: the largest share of the kernel's work
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # fp32_core_bound_ms and sfu_ms are worked out, not measured: they stay in the
    # phase lines, out of the kernels line.
    context = ("fp32_core_bound_ms", "sfu_ms")
    flash_keys = keys + ("roofline_share",)
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
            **{k: main_site[k] for k in flash_keys},
            "sites": [{k: v for k, v in s.items() if k not in context} for s in sites],
        },
        {
            "name": "qsample",
            "route": "cuda",
            "source": "tinydiffusion_torch/ops/csrc/qsample.cu",
            "replaces": "tinydiffusion_tpu/ops/qsample.py:45",
            # The main path's run: the default (bfloat16, resident, graph) train
            # run; the float32 and host-placement runs beside it.
            "launches": trains[0]["launches"]["qsample"],
            "launches_float32_run": trains[1]["launches"]["qsample"],
            "launches_host_run": train_host["launches"]["qsample"],
            # The class-conditional run: its train steps and its val passes.
            "launches_conditional_run": cond["launches"]["qsample"],
            "launches_conditional_split": cond["qsample_launches"],
            # The latent runs, at (128, 20): their train steps and val passes.
            "launches_latent_runs": {b: f["qsample_launches"] for b, f in latents.items()},
            "max_abs_err": max([qsample_site["max_abs_err"]]
                               + [s["max_abs_err"] for s in qsample_site["latent_sites"]]),
            **{k: qsample_site[k] for k in keys + (
                "roofline_share", "device_us", "graph_us", "graph_floor_us")},
            # The main site (128, 784) above; the latent step's (128, 20) and a
            # ragged (128, 18) here.
            "latent_sites": qsample_site["latent_sites"],
        },
        {
            "name": "flash_bwd",
            "route": "cuda",
            "source": "tinydiffusion_torch/ops/csrc/flash_bwd.cu",
            "replaces": "tinydiffusion_tpu/ops/attention.py:193",
            "launches": vae["launches"]["flash_bwd"],
            "max_abs_err": max(s["max_abs_err"] for s in bwd_sites),
            **{k: bwd_sites[0][k] for k in flash_keys},  # N = 16384
            "sites": [{k: v for k, v in s.items() if k not in context} for s in bwd_sites],
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
