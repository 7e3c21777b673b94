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
and the serving CLI on their checkpoints, and the LAION text-conditional
latent UNet (``experiments/conditional_diffusion_laion.run`` and
``generate_laion.main``), on the patch codec and the hash encoder and on the
pretrained seams, CLIP-L and the SD v1.4 VAE; and the FID tools on every
committed checkpoint and the reference-checkpoint importer. Phases, one JSON
line each:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: the kernels, built from ``tinydiffusion_torch/ops/csrc`` by one
   nvcc a source, all at once, and a link: ptxas's registers, spills, shared
   memory and performance remarks per kernel, the flash kernels' dynamic
   shared memory, and the tensor-core instructions (HMMA, HGMMA, and HGMMA
   by operand type) in each kernel's SASS (``cuobjdump``); fails if a flash
   forward or backward kernel has none, if a bfloat16 flash kernel has a
   tf32 HGMMA or no bf16 one, or if a bfloat16 flash kernel spills;
   bf16_layers: every bfloat16 layer of the port (conv and dense with their
   biases, the UNet28's and LatentUNet's resizes, ``ConvBNRelu``,
   ``TimeEmbedMLP``, the DiT's block, the MLP UNet's dense block) on the card
   against the port's CPU run of it: the share of outputs and input
   gradients that differ (``BF16_LAYER_SHARES``), and whether cuDNN's conv
   and cuBLASLt's linear add their bias apart;
3. kernel: the CUDA flash-attention forward against ``flash_fwd_reference``
   at each shape the 256² and 512² models give it and the 1024² model's
   dec_attn0 (B = 4), every head width, and at ragged N, out and lse;
   two calls bit-equal; the times of kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it; not timed where its MATH backend's logits pass 16 GiB); the bound
   (products at the TF32 tensor-core peak or bytes at the memory rate), the
   CUDA cores' fp32 bound and the exp unit's time beside it; ptxas's report
   and the dynamic shared memory of the kernel at the site; kernel_bf16: the
   same for the bfloat16 kernel on the operands rounded to bf16, compared in
   float32 (within one bf16 ulp; the share of outputs beyond one ulp, lse's
   error), SDPA in bf16 beside it (each site names the backend torch
   picked), the bound at the bf16 tensor-core peak;
4. slice: reconstruct 4 synthetic images and decode 16 prior samples on the
   card (a first eager request of each, then the requests as their CUDA
   graphs replay them), with the kernel launches counted over exactly the
   replayed work; check
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
   step's shape (128, 20), a ragged (128, 18) and the LAION step's
   (8, 4096), each bit-equal to the plain version, with their times;
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
   is set on the device tensor against the same step eager; laion_loader:
   the port's ``LAIONImageTextDataset`` and ``precache_dataset`` on this
   machine (no Pillow, requests, urllib3 or datasets) over a loopback HTTP
   server in a thread (a JPEG, the 4:4:4 JPEG and RGBA PNG of
   ``tests/fixtures/``, a 503 then a 200, a 404, a black image, a short
   body): the valid list, the requests, the cache files, the fixtures'
   decodes against Pillow's digests (each timed, two at 512² among them),
   the failed-URL JSON, a warm re-read and the cold rate of two 512² records;
   laion_train: the LAION ``run()`` at the published recipe (``laion_diffusion_1000ep.json``:
   256² images, 4x32x32 latents, time_dim 768, B = 8, bf16, Adam 1e-4 to
   1e-6 cosine over T_max 1000 steps, clip 10; resident, graph replays),
   cut to 800 records (80 steps an epoch, 20 val batches) and 2 epochs, the
   records read through the JPEG cache in a temporary directory (the LAION
   runs at 256² share one: laion_train fills it, the guided and CLIP runs
   read it warm):
   q_sample launches at (8, 4096), train and val apart, graph counts, each
   epoch's rate against the host formula, warm step, samples/s, the val
   pass's and the grids' seconds, peak memory;
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
   t, noise, masks) seam; laion_parity: the same check for 10 LAION steps
   from ``laion_diffusion_1000ep`` (caption dropout 0.1, EMA; the gather,
   encode, q_sample, clip and rate inside the graph), one step a call, the
   rate each step wrote on the card against the host's formula across
   T_max = 4; dp: the data-parallel code path (``parallel/``) at world size
   1 on NCCL (the environment torchrun would set, then
   ``maybe_initialize_distributed``): the resident UNet28 graph step
   (``diffusion_final``, bf16, B = 128, Adam 1e-3, an EMA) and the resident
   MLP-UNet latent step (``latent_diffusion_best``), each with its
   BatchNorm statistics and gradient bucket all-reduced inside the captured
   graph, 12 steps (2 eager warm-ups, 10 replays) against the same steps of
   the non-DP graph step, beside a second non-DP run, to resident_parity's
   bfloat16 bounds; each step's ms a replay (CUDA events), its kernels a
   step (one profiler session) and the peak memory, DP and non-DP; the
   group destroyed after; tp: the model axis, the full-width UNet28 at
   (data, model) = (1, 2), two processes on the card over gloo, 3 eager
   Adam steps in float32 and bfloat16, each against the one-process step
   from the same gathered state (loss, update cosine, gradients leaf by
   leaf), shard shapes, the whole tensors bit-equal on both ranks, and a
   gather made to sum the head's whole gradient caught by the gradient check;
10. unet_parity: the card against the port's CPU run, TF32 off: eps from the
    committed ``checkpoints/diffusion_final`` weights, one SGD step through
    the step's (t, noise) seam, and a 20-step replayed DDPM chain (float32
    forward);
11. train_step_bf16: the main path's step (bfloat16, Adam) on the
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
    card vs CPU, float32 and bf16 forward; laion_serve: ``generate_laion.main``
    on ``laion_diffusion_1000ep`` (the four prompts, bf16 forward, fp32
    chain): DDPM-1000 and DDIM-50 twice each; DDIM-10 decoded images card vs
    CPU; a checkpoint trained for 20 steps with caption dropout 0.1, served
    with guidance 2; chain_graph: each chain as the card runs it (its
    steps captured in CUDA graphs and replayed, the decode a graph of its
    own) against the same chain run eagerly from the host
    (``sample_fn.eager``), from one generator seed, cuDNN deterministic:
    ``diffusion_final`` DDPM-1000 at n = 16, DDPM-20 with inpainting and the
    stride-100 trajectory; the CFG checkpoint at guidance 2, DDIM-50 at eta 0
    and 1, img2img from t = 599 and DPM++-15; both latent checkpoints
    DPM++-15 with the decode; LAION DDIM-50 at guidance 2 with the patch
    codec's decode; the conv-VAE's ``reconstruct`` and ``sample_prior`` in
    float32 and bfloat16 at B = 4 and 32: the largest difference (bit-equal
    expected), the generators' states, warm eager and replayed ms, the
    captures' ms, kernels a step, forwards; fid_mnist:
    ``tools/fid_eval.py`` at n = 512 (sample batch 128) on every committed
    MNIST checkpoint (``diffusion_final`` DDIM-50, DPM++-20, DDPM-1000;
    ``conditional_cfg_ema_best`` DDIM-50 at
    guidance 1 and 2 with label accuracy; ``latent_diffusion_best`` and
    ``diffusion_transformer_best`` DPM++-20), each row beside JAX's own
    tool's row on the CPU at the same n and seed
    (``tests/fixtures/fid_jax_cpu_rows.json``), failing only on a gross
    fault (over 2x JAX's, or a label accuracy under 0.9 where JAX's is 0.97
    or more); the calibration rows and 512 test images' features card
    against CPU; the seconds to featurize the 10 000 test images and to
    sample each row; one row at a second seed, beside JAX's at that seed;
    fid_laion: ``tools/fid_eval_laion.py`` at 256², n = 512, batch 32: the
    calibration rows (card against CPU), ``vae_recon`` and
    ``vae_prior_decode`` on ``vae_laion_best`` (the flash forward at B = 32,
    64 launches counted over exactly that run), ``samples_dir[256]`` on 64
    DDIM-50 requests dumped by ``generate_laion.main --dump-dir``, beside
    JAX's own tool's CPU rows (``tests/fixtures/fid_laion_jax_cpu_rows.json``);
    ``vae_recon``'s first 32 images with the flash forward and
    with the plain attention (B = 4), images and FIDs; ``train_feature_net``
    for 1 epoch on 256 images, saved, read back, its accuracy;
    torch_import: a seeded synthetic upstream UNet28 ``.pth`` (the
    reference's names, full width) through
    ``tools/import_torch_checkpoint.py``, then ``load_pixel_checkpoint`` and
    DDIM-10 from one x_init on the card against the CPU; then the pretrained
    seams at their published widths on synthetic weights (``write_synthetic_clip`` puts CLIP-L's files in a
    temporary directory): clip_encode (CLIP-L through
    ``get_text_encoder("clip", clip_local_dir=...)`` on the card against the
    same files on the CPU, 16 captions, beside two card runs and the CPU's
    float32 against float64; the 800 records' captions encoded, the
    forward's time, FLOPs and share of the float32 peak), sdvae_codec (the SD
    v1.4 AutoencoderKL from a seeded init through
    ``SDVAECodec.from_torch_state_dict``, its keys and shapes against
    ``tests/fixtures/sd_v1_4_vae_state_dict.json``; encode moments of 8
    images of 256² and decode of 4 latents of 32², card against CPU, each
    one's time, peak memory, FLOPs and share of the float32 peak),
    laion_sd_train (the LAION recipe with the SD codec and CLIP's
    embeddings: 10 graph steps against eager with laion_parity's check,
    then 2 epochs of 20 resident steps, each a replay holding the stochastic
    encode and the q_sample kernel at (8, 4096), and the val passes, through
    ``make_resident_laion_multi_step`` and ``make_laion_eval_step``; the
    launches, graph counts, warm step, the encode's share of the step's
    device time by CUDA events and by one profiler session, the patch-codec
    step of laion_train beside), laion_sd_serve (DDIM-50 on the SD-trained
    UNet with CLIP's embeddings of the four prompts and the SD decode; the
    decode's time apart) and laion_clip_run (``python -m
    tinydiffusion_torch.experiments.conditional_diffusion_laion
    --text-encoder clip --clip-local-dir DIR`` for 20 steps and ``python -m
    tinydiffusion_torch.generate_laion`` on its checkpoint, DDIM-50);
14. flash_bwd_kernel: the CUDA flash backward against ``flash_bwd_reference``
    at the kernel phase's sites, dq, dk and dv; two calls
    bit-equal; the times of kernel, plain version and the backward of
    ``scaled_dot_product_attention`` (a yardstick only), with the bounds of
    the ``kernel`` phase; flash_bwd_kernel_bf16: the bfloat16 kernel the same
    way (dq within two bf16 ulps of its largest value, dk and dv one);
15. flash_autograd: gradients through ``flash_attention_unscaled_t`` (the
    autograd Function over both kernels) on the card against the CPU;
16. vae_train: the conv-VAE's ``run()`` at full width (256x256, batch 4,
    float32, clip 10, Adam 1e-4) on the default placement (both splits
    resident, each train step a replay of one captured graph), 2 epochs of
    20 steps and 2 val batches, outputs in temporary directories; launches
    counted over the run (flash backward = 3 a step run, eager or
    replayed); the graph's counts; the loss and its components finite; warm
    step time, images/s and peak memory; vae_train_host: the same,
    host-streamed; vae_train_bf16: resident in bfloat16, only the bf16
    kernels launched; vae_resident_parity: 10 resident steps (2 eager, 8
    replays) against the same 10 eager, beside a second eager run, from
    ``vae_laion_best``, float32 and bfloat16, cuDNN deterministic: losses,
    the update's cosine, params and BN / spectral-norm statistics gaps, the
    generator's state; vae_resident_full: JAX's full set (10 000 images of
    256², 1.97 GB, random bytes) pinned on the card, a chunk of 10 steps
    that captures, then 10 replays timed; peak memory;
17. vae_train_parity: one clip + SGD step from ``vae_laion_best`` (256x256,
    B = 2) on the card against the CPU, cuDNN deterministic: loss
    components, gradients, params, BN statistics, spectral-norm u and sigma;
    vae512_train and vae512_train_bf16: ``run()`` at 512² (every attention
    site on the flash path, dec_attn0 on the (16, 128) kernels), 44 records,
    2 epochs (bf16: 1) of 10 steps, resident with graph replays: warm step,
    images/s, peak memory, losses, the flash launches by kernel and (D, C),
    all three widths forward and backward, and the backward's scratch by site
    (``attention.flash_bwd_scratch``: at most 0.016 GiB); vae1024_train and
    vae1024_train_bf16: the same at 1024² (enc_attn0 at N = 262144), 40
    records, 1 epoch of 6 steps (2 eager, 1 capture, 4 replays); the later
    run at each size reads the first one's record cache, warm (its
    ``outside_steps`` time the cache's decodes); vae512_serve:
    the float32 run's checkpoint, ``reconstruct`` and ``sample_prior`` at
    B = 4, each call's graph bit-equal to eager with the generators equal,
    and within CARD_VS_CPU_ATOL of the same calls with the flash sites on the
    plain version (swapped here);
18. the ``kernels`` line (the float32 flash kernels, with the launches of
    the conv-VAE run and of fid_laion beside; q_sample, with the launches of
    laion_sd_train beside, and the bfloat16 flash kernels with
    launches from ``vae_train_bf16``; every flash kernel with its launches
    by (D, C) over the 512² and 1024² runs), then
    ``{"ok": true, "device": {...}}`` last.

``--profile`` adds phases before the last two lines: ``torch.profiler`` over
one warm reconstruct and one prior decode, over 5 warm UNet28 train steps
(eager, ``train_steps``, and replayed from a graph over a resident set,
``train_steps_graph``), over 20 sampler steps, over the chain of one
DPM++-15 serving request (``serve_dpmpp15``; these and the conv-VAE's
requests replayed from their graphs, and eager beside them), over 3 warm
conv-VAE train steps (eager, ``vae_train_steps``, and replayed from a graph over a resident
set, ``vae_train_steps_graph``, and the same in bfloat16,
``vae_train_bf16_steps_graph``, its flash kernels by name from one profiler
session; the same at 512², ``vae512_train_steps_graph`` and
``vae512_train_bf16_steps_graph``), over 5 latent MLP UNet train steps replayed
from a graph
(``latent_train_steps_graph``) and over one DPM++-15 latent request on the
DiT (``latent_serve_dpmpp15``), each with device time by kernel, the
device's busy share of the window and the host's launch calls.

Any failure raises and the exit code is non-zero. Without a CUDA card it
exits 1 before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import http.server
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from chip_flash_ab import ptxas_report
from chip_qsample_ab import graph_us_per_launch, kernel_device_us_each
from tinydiffusion_torch.compat import sdvae, text_encoder
from tinydiffusion_torch.compat.clip import PREFIX as CLIP_PREFIX
from tinydiffusion_torch.compat.clip import CLIPTextConfig, CLIPTextEncoder, CLIPTextTransformer
from tinydiffusion_torch.compat.clip_tokenizer import BOS_TOKEN, EOS_TOKEN, byte_to_unicode
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data import gif as gif_data
from tinydiffusion_torch.data import identify as identify_data
from tinydiffusion_torch.data import jpeg as jpeg_data
from tinydiffusion_torch.data import laion as laion_data
from tinydiffusion_torch.data import qoi as qoi_data
from tinydiffusion_torch.data import tga as tga_data
from tinydiffusion_torch.data import tiff as tiff_data
from tinydiffusion_torch.data import webp as webp_data
from tinydiffusion_torch.data.jpeg import decode_jpeg, encode_jpeg
from tinydiffusion_torch.data.laion import synthesize_caption, synthesize_image
from tinydiffusion_torch.data.mnist import load_mnist
from tinydiffusion_torch.device import disable_tf32
from tinydiffusion_torch.eval.fid import (
    FeatureNet,
    classifier_accuracy,
    featurize,
    fid_from_stats,
    frechet_gaussian_stats,
    load_feature_net,
    save_feature_net,
    train_feature_net,
)
from tinydiffusion_torch import generate, generate_laion
from tinydiffusion_torch.experiments import (
    conditional_diffusion,
    conditional_diffusion_laion,
    latent_diffusion,
    vae,
    vae_laion,
)
from tinydiffusion_torch.experiments.common import (
    load_latent_checkpoint,
    load_pixel_checkpoint,
    load_unet28,
    make_latent_pixel_sampler,
    make_sampler,
    make_trajectory_sampler,
)
from tinydiffusion_torch.experiments.diffusion import DiffusionConfig, run
from tinydiffusion_torch.experiments.vae_laion import load_conv_vae, reconstruct, sample_prior
from tinydiffusion_torch.io.checkpoint import (
    load_sidecar,
    load_weights_arrays,
    restore_checkpoint,
    save_checkpoint,
)
from tinydiffusion_torch.io.from_jax import state_dict_by_name
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.models.unet_latent import LatentUNet
from tinydiffusion_torch.models.vae_conv import PerceptualNet
from tinydiffusion_torch.obs.images import (
    encode_png,
    load_image28,
    resize_u8,
    save_image_grid,
    write_png,
)
from tinydiffusion_torch.ops import _build, attention, qsample
from tinydiffusion_torch.parallel.distributed import destroy, maybe_initialize_distributed
from tinydiffusion_torch.parallel import mesh as mesh_lib
from tinydiffusion_torch.parallel.mesh import make_mesh_for_batch
from tinydiffusion_torch.tools import fid_eval, fid_eval_laion, import_torch_checkpoint
from tinydiffusion_torch.train.trainer import (
    GRAPH_WARMUP_STEPS,
    create_train_state,
    make_laion_eval_step,
    make_laion_train_step,
    make_latent_train_step,
    make_resident_eval,
    make_resident_laion_multi_step,
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
# A bfloat16 kernel's products are bf16 values, so its bound takes them at the
# bf16 tensor-core peak, whatever passes the kernel spends on them.
PEAK_BF16_FLOPS = 989e12
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
# The bfloat16 kernels against their plain versions on the same bf16 inputs,
# compared in float32. Both compute in float32 (a product of two bf16 values
# is exact there) and round where JAX rounds; their float32 results differ by
# the float32 kernels' noise above, which carries a rounding across a bf16
# boundary now and then. out, dk and dv are rounded once: within one bf16 ulp
# (at most 2^-7 relative) beyond the float32 atol. dq is rounded once per
# 1024 keys into a bf16 running sum whose terms cancel (sum_j ds_ij = 0), so
# a flip is an ulp of a run's sum, not of dq: within two ulps of the largest
# |dq| of the tensor. lse is float32, held as the float32 kernel's. Each site
# also reports the share of outputs more than one ulp (of the plain value) off.
BF16_RTOL = 2.0**-7
BF16_DQ_ULPS_OF_MAX = 2
# Card vs CPU reconstruction, both float32 with TF32 off: only summation
# order differs, through ~30 layers; outputs are sigmoids in [0, 1].
CARD_VS_CPU_ATOL = 1e-3

# (N, D, C) of the kernel on the 256x256 path: enc_attn0 (128x128 map,
# C = 32) and enc_attn1 / dec_attn1 (64x64, C = 64). dec_attn0 (32x32,
# N = 1024) takes the dense path, as in JAX.
KERNEL_SITES = ((16384, 4, 32), (4096, 8, 64))
# Beyond 256²: dec_attn0 (C = 128, d = 16) takes the flash path at 512²
# (64x64, N = 4096) and 1024² (N = 16384); 512²'s enc_attn0 gives the
# (4, 32) kernels N = 65536, 16 times the work of their 256² site, and its
# enc_attn1 and dec_attn1 the (8, 64) kernels N = 16384.
KERNEL_SITES_BEYOND_256 = ((4096, 16, 128), (16384, 16, 128), (65536, 4, 32),
                           (16384, 8, 64))
KERNEL_BATCH = 4
# Ragged sites, B = 1: N = 1000 leaves keys and queries past a tile; N = 1001
# and 1002 are not multiples of 4, so the kernels stage them 4 bytes a copy,
# not 16 (the one-value paths, kVec = false).
RAGGED_SITES = ((1000, 4, 32), (1001, 8, 64), (1000, 16, 128), (1002, 16, 128))
# SDPA's MATH backend (its pick for bf16 at D = 4) holds B x N^2 float32
# logits and their softmax: past this it would not fit beside the kernels'
# operands (68.7 GB at B = 4, N = 65536), and its time is not taken.
LIBRARY_MATH_MAX_BYTES = 16 * 2**30
N_RECON, N_PRIOR = 4, 16

# q_sample kernel vs plain version on the same Philox stream: z differs only
# in the last bits of logf/sincosf against torch's log/cos/sin (|z| < 6),
# x_t by the same through one multiply-add.
QSAMPLE_ATOL = 1e-5
QSAMPLE_BATCH, QSAMPLE_SHAPE = 128, (1, 28, 28)
# A data-parallel rank's launch on its rows of the global batch (row_offset):
# two ranks' halves and a middle span, bit-equal to the rows of one launch.
QSAMPLE_ROW_SPANS = ((0, 64), (64, 128), (40, 104))
# Integer and float operations per element of the kernel: a Philox4x32-10
# call (10 rounds of 2 mulhi, 2 mullo, 4 xor; 9 key bumps of 2 adds) feeds 4
# elements, ~25 each; the uniform, Box-Muller and the noising add ~10.
QSAMPLE_OPS_PER_ELEMENT = 35
# Resident step, graph against eager, from the same trained weights on the
# card: 2 eager warm-up steps, then replays. Only the order of floating-point
# atomics (the bilinear resize's backward adds with them) differs, run to run
# as between the two. It moves the losses by float32 rounding that the
# bfloat16 compute can round up to a bfloat16 step in a few activations; Adam turns
# the rounding noise of gradients that are zero in exact arithmetic (conv
# biases ahead of a BatchNorm) into +-lr, so the weights are held by the
# cosine of their updates, as in train_step_bf16. From a fresh init, whose
# raw-integer time embedding drives activations into the hundreds, two
# bfloat16 runs part in the second step, before any replay, and by far within
# a few: that start cannot tell a fault from this noise. From the trained
# weights the second step (eager in both runs) already differs in bfloat16,
# and 10 steps' updates reached a cosine of 0.9985 (H100 80GB HBM3, read
# when the bf16 forward still ran under torch.autocast; the rounding of
# flax's dtype= has kept the phase inside the same bounds): the
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
# The default placement keeps both splits on the card, each train step a
# replay of one captured graph: 2 eager warm-up steps, 1 capture, 38
# replays over the run; the val pass runs eagerly.
VAE_RECORDS, VAE_EPOCHS = 88, 2
# The same recipe at 512x512 (vae512_train; every attention site on the
# flash path, dec_attn0 on the (16, 128) kernels), once in float32 and once
# in bfloat16: 44 records leave 40 for training (10 steps an epoch) and 4
# for validation (1 batch); float32 2 epochs (2 eager steps, 1 capture, 18
# replays; the second epoch's step time the warm one), bfloat16 1 epoch (2
# eager, 1 capture, 8 replays: one checkpoint write, 104 M parameters).
VAE512_RECORDS, VAE512_BF16_EPOCHS = 44, 1
# The same recipe at 1024x1024 (vae1024_train, vae1024_train_bf16: enc_attn0
# at N = 262144, where the backward's old per-key-block dq partials would
# have taken 64 GiB): 40 records leave 36 for training and 4 for validation
# (1 batch), 1 epoch of 6 steps: 2 eager steps, 1 capture, 4 replays (its
# step time has the eager steps and the capture in it). One epoch writes one
# checkpoint: the 407 M-parameter model's is 5.7 GB (its .pt with Adam's
# moments), 22 s a write on the card's machine; two epochs wrote two.
VAE1024_RECORDS, VAE1024_EPOCHS, VAE1024_STEPS = 40, 1, 6
# Records, epochs and steps an epoch (0: all) of the conv-VAE runs by image
# size and compute dtype.
VAE_RUNS = {(256, "float32"): (VAE_RECORDS, VAE_EPOCHS, 0),
            (256, "bfloat16"): (VAE_RECORDS, VAE_EPOCHS, 0),
            (512, "float32"): (VAE512_RECORDS, VAE_EPOCHS, 0),
            (512, "bfloat16"): (VAE512_RECORDS, VAE512_BF16_EPOCHS, 0),
            (1024, "float32"): (VAE1024_RECORDS, VAE1024_EPOCHS, VAE1024_STEPS),
            (1024, "bfloat16"): (VAE1024_RECORDS, VAE1024_EPOCHS, VAE1024_STEPS)}
# The flash sites of one conv-VAE step by image size, by (D, C): each runs
# one forward and one backward a train step.
VAE_FLASH_SITES = {256: {(4, 32): 1, (8, 64): 2},
                   512: {(4, 32): 1, (8, 64): 2, (16, 128): 1},
                   1024: {(4, 32): 1, (8, 64): 2, (16, 128): 1}}
# The backward's scratch a flash site may hold (attention.flash_bwd_scratch):
# O(B D N), 0.016 GiB at the 1024² enc_attn0 at most.
DQ_SCRATCH_MAX_GIB = 0.016
# vae512_serve: reconstruct and sample_prior at 512² from the checkpoint
# vae512_train wrote, B = 4, on the kernels (each call its CUDA graph)
# against the same weights and noise with the flash sites swapped for the
# plain versions on the card: within slice's card-vs-CPU bound
# (CARD_VS_CPU_ATOL, images in [0, 1]).
VAE512_SERVE_BATCH = 4
# vae_resident_parity: 10 resident steps (2 eager warm-ups, then 8 replays)
# against the same 10 steps eager from the same state (vae_laion_best, B = 4,
# Adam 1e-4, clip 10), beside a second eager run, in float32 and bfloat16,
# as resident_parity does. The bounds, set before the first card run:
# resident_parity's for the losses, the cosine of the updates and the BN and
# spectral-norm statistics; params absolute at a fifth (float32) and all
# (bfloat16) of what 10 Adam steps at 1e-4 can move one (1e-3), since Adam
# moves each param by about lr a step whatever its gradient's size. The
# float32 runs differ by cuDNN's atomics only (the LAION UNet's steps at 256²
# read 3.8e-7 / 3.1e-5 eager vs eager); bf16 rounds that noise up.
# They were more here: with cuDNN free to pick, two eager float32 runs of the
# conv-VAE read 3.7e-4 in the losses and 5.6e-4 in the params (H100 80GB HBM3,
# 700 W), above these bounds, while the bf16 runs were bit-equal. The phase
# therefore runs cuDNN deterministic, as vae_train_parity does, so that the
# pair measures what the graph adds and not cuDNN's noise; the bounds stayed.
VAE_PARITY_STEPS = 10
VAE_PARITY_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
VAE_PARITY_MIN_UPDATE_COS = {"float32": 0.999, "bfloat16": 0.99}
VAE_PARITY_MAX_PARAM_ABS = {"float32": 2e-4, "bfloat16": 1e-3}
VAE_PARITY_MAX_STATS_REL = {"float32": 0.04, "bfloat16": 1.0}
# vae_resident_full: JAX's full train set, 10 000 images of 256² x 3 uint8
# (1.97 GB; random bytes from numpy, since synthesizing them takes about a
# minute), pinned on the card; a chunk of 10 steps that captures, then one
# of 10 replays, timed.
VAE_FULL_IMAGES, VAE_FULL_CHUNK = 10_000, 10
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
# Their model forwards (img2img at strength 0.6 starts at t = 599: 50 of its
# 600 timesteps), counted by the chains' runners, graph replays included.
SERVE_FORWARDS = {"ddpm1000": 1000, "ddim50": 50, "dpmpp15": 15, "img2img": 50, "inpaint": 50}
# DDIM-10 and DPM++-10 chains at n = 4 (guidance 2.0, a fixed x_init): the
# card's float32 forward against the CPU's, TF32 off, within 1e-3. With the
# bfloat16 forward on the card against float32 on the CPU, the bounds were
# set before the first card reading, from CPU runs of the same chains when
# the bf16 forward ran under torch.autocast (bf16 against float32, both on
# the CPU): mean |diff| 0.0060 / 0.0191 and max 0.128 / 0.690 for DDIM /
# DPM++ at this x_init (0.0029 / 0.0118 and 0.026 / 0.085 at another),
# samples in [-1.96, 1.35]; the card's bf16 forward in flax's dtype= read
# mean 0.0097 / 0.0199 and max 0.284 / 0.838 (H100 80GB HBM3). The largest
# difference is one pixel of a chaotic chain and heavy-tailed, so the mean
# carries the check (about 3 times the CPU's) and the max only catches a
# chain gone wrong.
SERVE_CHAIN_N, SERVE_CHAIN_STEPS = 4, 10
# chain_graph: every sampler chain as the card runs it, its steps captured in
# CUDA graphs and replayed (core.graphs.ChainRunner), and the conv-VAE's two
# serving calls as graphs (GraphedCall), against the same work run eagerly
# from the host (sample_fn.eager: core.sampler's loop over the same bodies),
# from one generator seed, cuDNN deterministic. The same kernels on the same
# inputs: bit-equal expected. A chain that is not stays within
# CHAIN_GRAPH_REL of its largest value (a chain gone wrong differs by its
# whole scale), beside the gap of two eager runs; the generators must end
# equal. n = 16 (serving's); the conv-VAE at B = 4 (serving's) and 32 (the
# LAION FID tool's), float32 and bfloat16.
CHAIN_GRAPH_REL, CHAIN_GRAPH_VAE_BATCHES = 1e-3, (4, 32)
# The latent family (slice 5): the committed MNIST VAE and the two latent
# denoisers, whose sidecars give the train recipes (B = 128, bf16, Adam 1e-3,
# or the DiT's 3e-4 with a per-epoch cosine; fp32 sampling).
VAE_MNIST_CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_mnist_best")
LATENT_CHECKPOINTS = {"mlp_unet": os.path.join(REPO, "checkpoints", "latent_diffusion_best"),
                      "dit": os.path.join(REPO, "checkpoints", "diffusion_transformer_best")}
# q_sample at the latent step's shape, (B, latent_dim) = (128, 20): 80-byte
# rows, the float4 path; a ragged (128, 18), 72-byte rows, the scalar path;
# and the LAION step's (B, 4 * 32 * 32) = (8, 4096). The same Philox stream
# and arithmetic as the plain version on the card: bit-equal.
LATENT_QSAMPLE_SITES = ((128, 20), (128, 18), (8, 4096))
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
# same chains when the bf16 forward ran under torch.autocast (bf16 against
# float32, both on the CPU): mean |diff| 0.0030 / 0.0023 and max 0.062 /
# 0.079 for the MLP UNet / DiT at this x_init (0.0045 / 0.0084 and 0.096 /
# 0.35 at another); pixels in [-1, 1]. The card's bf16 forward in flax's
# dtype= read mean 0.0051 / 0.0036 and max 0.134 / 0.194 (H100 80GB HBM3).
# The mean carries the check, the max only catches a chain gone wrong.
LATENT_SERVE_F32_ATOL = 1e-3
LATENT_SERVE_BF16_MEAN_ABS, LATENT_SERVE_BF16_MAX_ABS = 0.03, 1.0
SERVE_F32_ATOL = 1e-3
SERVE_BF16_MAX_ABS, SERVE_BF16_MEAN_ABS = 1.5, 0.06
# The LAION text-conditional family (slice 6): the committed checkpoint,
# whose sidecar gives the published recipe (256² images, 4x32x32 latents,
# time_dim 768, B = 8, bf16, Adam 1e-4 to 1e-6 cosine with T_max 1000
# scheduler steps, clip 10; resident, 10 steps a chunk) and the codec basis.
LAION_CHECKPOINT = os.path.join(REPO, "checkpoints", "laion_diffusion_1000ep")
# Training cut from 10 000 records to 800 (the host synthesizes ~11 ms an
# image): 640 train (80 steps an epoch) and 160 val (20 batches), 2 epochs;
# a mid-epoch grid every 50 batches, the epoch grid at the last epoch.
LAION_RECORDS, LAION_EPOCHS, LAION_SAMPLE_EVERY = 800, 2, 50
# laion_loader: the port's LAION dataset over a loopback HTTP server at this
# image size, and Pillow's decodes of the two fixture files it serves (as
# sha256 of their RGB bytes; a CPU test ties them to Pillow).
LOADER_SIZE = 64
LOADER_PILLOW = os.path.join(REPO, "tests", "fixtures", "laion_loader_pillow.json")
# Fixtures at a web image's size (512², ~183 KiB each), fetched cold for the
# loader's rate.
LOADER_WEB_FIXTURES = ("laion_loader_512_progressive.jpg", "laion_loader_512_lossy.webp")
LOADER_JP2_512 = "laion_loader_512.jp2"
# 512² files of the arithmetic-coded JPEG, the YCbCr formats, 8-bit
# lossless JPEG, run-length TGA and QOI, timed beside the 512² JPEG; the
# arithmetic-coded one in C only (its plain decoder is bit-serial Python,
# held to the C one on the small arithmetic fixtures).
LOADER_NEW_512 = {"arith_progressive": "laion_loader_512_arith_progressive.jpg",
                  "ycbcr_jp2": "laion_loader_512_ycbcr.jp2",
                  "ycbcr_tiff": "laion_loader_512_ycbcr.tif",
                  "lossless_jpeg": "laion_loader_512_lossless.jpg",
                  "rle_tga": "laion_loader_512_rle.tga", "qoi": "laion_loader_512.qoi"}
LOADER_C_ONLY = {LOADER_NEW_512["arith_progressive"]}
LAION_TRAIN_STEPS, LAION_VAL_BATCHES = 80, 20
# laion_parity: resident_parity's graph-vs-eager check on 10 LAION steps (B = 8, caption
# dropout 0.1, EMA) from the committed weights, one step a call so that the
# rate the step wrote on the card is read after each; T_max 4, so that the 10
# steps cross it twice. The rate against the host's float64 formula: 1e-6
# relative, and one float32 ulp of the cosine times (lr - lr_min) / 2 where
# 1 + cos cancels next to T_max.
LAION_PARITY_T_MAX, LAION_CAPTION_DROPOUT = 4, 0.1
# dp: the data-parallel code path at world size 1 on NCCL. The card's machine
# has one H100 and NCCL refuses two ranks on one device, so no world size
# above 1 runs here (the CPU tests hold 2 ranks on gloo to one process). The
# DP graph step against the non-DP graph step: DP_REPLAYS replays after the
# warm-ups, resident_parity's bfloat16 bounds (the DP step normalises BN
# with float64 sums where cuDNN's kernel takes its own; the bf16 forward
# carries that); the times over DP_TIMED_CALLS calls of DP_REPLAYS + 2
# replays each.
DP_REPLAYS, DP_TIMED_CALLS = 10, 5
LAION_LR_RTOL = 1e-6
# laion_serve: the four prompts, bf16 forward and fp32 chain (the sidecar's),
# each request twice. DDIM-10 decoded images card vs CPU from one x_init:
# fp32 within 1e-3 (summation order only), the card's bf16 forward against
# the CPU's fp32 by the mean |diff| (as latent_serve).
LAION_SERVE_REQUESTS = {
    "ddpm1000": (["--sampler", "ddpm"], 1000),
    "ddim50": (["--sampler", "ddim", "--sample-steps", "50"], 50),
}
LAION_SERVE_F32_ATOL, LAION_SERVE_BF16_MEAN_ABS = 1e-3, 0.03
# A guided checkpoint trained for a few steps at the recipe with caption
# dropout 0.1, then served with --guidance-scale 2 (DDIM-50).
LAION_GUIDED_RECORDS, LAION_GUIDED_STEPS = 200, 20

# FID on the card (slice 12): tools/fid_eval.py's rows at n = 512 and sample
# batch 128, beside JAX's own tool's rows on the CPU at the same n, sample
# batch and seeds (tests/fixtures/fid_jax_cpu_rows.json, which names the
# command that made them; BASELINE.md's TPU figures were stale: 65.3 on the
# CFG s = 1 row where JAX's tool gives 12.78). Each entry: checkpoint,
# variants, guidance scale, JAX's FID per variant and JAX's label accuracy
# (conditional checkpoints). A row fails only on a gross fault: above
# FID_MAX_RATIO x JAX's, or a label accuracy under FID_MIN_LABEL_ACC where
# JAX's is at least FID_LABEL_ACC_FLOORED. The seed spread: the first row
# again at --seed FID_SPREAD_SEED, held to JAX's row at that seed.
FID_JAX_FIXTURE = os.path.join(REPO, "tests", "fixtures", "fid_jax_cpu_rows.json")
with open(FID_JAX_FIXTURE) as _f:
    FID_JAX = json.load(_f)
FID_N, FID_SAMPLE_BATCH = FID_JAX["n"], FID_JAX["sample_batch"]
FID_MNIST_ROWS = tuple((r["checkpoint"], r["variants"], r["guidance_scale"], r["fid"],
                        r["label_acc"]) for r in FID_JAX["rows"])
FID_JAX_CALIBRATION = FID_JAX["calibration"]
FID_MAX_RATIO, FID_MIN_LABEL_ACC, FID_LABEL_ACC_FLOORED = 2.0, 0.9, 0.97
FID_SPREAD_SEED = FID_JAX["spread_row"]["seed"]
# Card against CPU: the calibration rows (the same images, float32 features
# summed in other orders) within 1e-3 relative; the features of 512 test
# images within 1e-4 of the largest.
FID_CARD_VS_CPU_RTOL, FID_FEATURE_RTOL = 1e-3, 1e-4
# fid_laion: tools/fid_eval_laion.py at 256², n = 512, batch 32 (the flash
# forward at B = 32, N = 16384 and 4096), beside JAX's own tool's rows on the
# CPU at n = 512 (tests/fixtures/fid_laion_jax_cpu_rows.json, with the
# command; it replaced docs/evidence/fid_laion_r5.jsonl's TPU rows). The
# samples: 64 DDIM-50 requests of the four prompts from
# laion_diffusion_1000ep, 256 PNGs. Flash forward launches: 3 a reconstruct
# batch, 1 a prior decode, 16 batches.
FID_LAION_JAX_FIXTURE = os.path.join(REPO, "tests", "fixtures", "fid_laion_jax_cpu_rows.json")
with open(FID_LAION_JAX_FIXTURE) as _f:
    FID_LAION_JAX = json.load(_f)["rows"]
FID_LAION_BATCH, FID_LAION_REPEAT = 32, 64
FID_LAION_FLASH_LAUNCHES = (FID_N // FID_LAION_BATCH) * (3 + 1)
# The kernel against its plain version on vae_recon's first 32 images at
# B = 4 (the plain N² logits at B = 32 would take 34 GB): images within
# slice's card-vs-CPU bound for the same reconstruct (read 2.5e-4: the
# decoder carries the attention's 3xTF32 rounding into the pixels), the two
# sets' FIDs against the real set within 1e-3 relative (read 5.5e-6).
FID_KERNEL_IMAGES, FID_KERNEL_BATCH = 32, 4
FID_KERNEL_IMAGE_ATOL, FID_KERNEL_FID_RTOL = CARD_VS_CPU_ATOL, 1e-3
# train_feature_net on the card: an RGB net on 256 synthetic images, 1 epoch.
FID_TRAIN_IMAGES = 256
# torch_import: a seeded synthetic upstream UNet28 (the reference's names,
# full width) through the import tool, served by DDIM-10 at n = 4 from one
# x_init, float32 forward, card against CPU. Its random weights carry the
# chain to values of a few hundred, so the serve bound (1e-3 on values of
# order 1) applies relative to the largest value.
IMPORT_SEED, IMPORT_RTOL = SEED + 50, SERVE_F32_ATOL


# The pretrained seams (slice 11) at their published widths, on synthetic
# weights: no real CLIP or SD-VAE file can be fetched. CLIP-L from
# CLIPTextConfig's defaults, weights N(0, 0.02) from a seeded generator, the
# LayerNorms' weights 1 and the biases 0, saved with transformers' keys
# beside a vocabulary of the 256 byte symbols, their </w> forms, the merges
# that spell CLIP_WORDS and the two specials at 49406 and 49407.
CLIP_INIT_STD = 0.02
CLIP_WORDS = (
    "a photo of the cat dog horse cow and in on with at by for from to is are this that "
    "red green blue yellow orange black white brown small large big little old young "
    "painting drawing picture image portrait landscape sketch illustration render view "
    "house tree river mountain city street sky sea beach forest flower garden field road "
    "sunset night morning winter summer snow rain cloud light shadow color style art"
).split()
CLIP_BOS_ID, CLIP_EOS_ID = 49406, 49407
CLIP_SEED = SEED + 40
# clip_encode: the card against the CPU on 16 captions, float32 with TF32 off
# on both: only summation order differs, through 12 layers of 768-wide
# products; the pooled rows are LayerNorm outputs of order 1. The bound is
# set at 1e-3, ~100 times the float32 rounding the CPU's float32 run shows
# against its float64 run (printed beside it, as are two card runs).
CLIP_CHECK_CAPTIONS, CLIP_CARD_VS_CPU_ATOL = 16, 1e-3
# sdvae_codec: the SD v1.4 VAE (83 653 863 params) from a seeded init, encode
# moments of 8 images of 256² and decode of 4 latents of 32², the card against
# the CPU, float32 with TF32 off on both. On the CPU the float32 run is
# 6e-6 of the largest value from a float64 run (128² images); cuDNN may
# take Winograd or FFT convolutions, whose rounding is larger: bound 1e-3 of
# the largest value.
SD_SEED, SD_PARAMS = SEED + 41, 83_653_863
SD_ENCODE_BATCH, SD_DECODE_BATCH, SD_CARD_VS_CPU_REL = 8, 4, 1e-3
# laion_sd_train: the LAION recipe with the SD codec and CLIP's embeddings on
# 200 records (160 train: 20 steps an epoch; 40 val: 5 batches), 2 epochs.
LAION_SD_RECORDS, LAION_SD_EPOCHS, LAION_SD_STEPS = 200, 2, 20
# laion_clip_run: the train CLI on CLIP, 1 epoch of 20 steps over 200 records.
LAION_CLIP_RECORDS, LAION_CLIP_STEPS = 200, 20


def synthetic_clip_vocab() -> tuple[dict[str, int], list[tuple[str, str]]]:
    """A CLIP vocabulary and merge table: the byte symbols and their </w>
    forms, then the merges that join each of ``CLIP_WORDS`` left to right
    (the merged symbols added as they come), the specials at 49406-49407."""
    symbols = list(byte_to_unicode().values())
    tokens = symbols + [s + "</w>" for s in symbols]
    merges: list[tuple[str, str]] = []
    for word in CLIP_WORDS:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in merges:
                merges.append(pair)
                tokens.append(pair[0] + pair[1])
            parts = [pair[0] + pair[1]] + parts[2:]
    vocab = {tok: i for i, tok in enumerate(dict.fromkeys(tokens))}
    vocab.update({BOS_TOKEN: CLIP_BOS_ID, EOS_TOKEN: CLIP_EOS_ID})
    return vocab, merges


def write_synthetic_clip(directory: str, seed: int, config: CLIPTextConfig = CLIPTextConfig()
                         ) -> None:
    """``clip_text.pth`` (a ``CLIPTextModel`` state dict of ``config``'s
    shapes, ``text_model.`` keys), ``vocab.json`` and ``merges.txt`` in
    ``directory``: what ``get_text_encoder("clip", clip_local_dir=...)`` reads."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in CLIPTextTransformer(config).state_dict().items()}
    state = {}
    for key, shape in shapes.items():
        if "norm" in key and key.endswith(".weight"):
            value = torch.ones(shape)
        elif key.endswith(".bias"):
            value = torch.zeros(shape)
        else:
            value = torch.empty(shape).normal_(0.0, CLIP_INIT_STD, generator=gen)
        state[CLIP_PREFIX + key] = value
    torch.save(state, os.path.join(directory, "clip_text.pth"))
    vocab, merges = synthetic_clip_vocab()
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


# Each phase's wall seconds, printed as the line before the kernels line: the
# seconds since the previous line go to the phase that prints the line (a
# phase of several lines sums them; main's work between two phases goes to
# the next one).
PHASE_SECONDS: dict[str, float] = {}
_last_emit = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    now = time.perf_counter()
    PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + now - _last_emit[0]
    _last_emit[0] = now
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


def _flash_bounds(b: int, n: int, flops: float, nbytes: float,
                  peak: float = PEAK_TF32_FLOPS) -> dict:
    """The least time of a flash kernel on an H100: the larger of its products'
    FLOPs at the tensor-core ``peak`` of its operands (TF32 for float32, bf16
    for bfloat16) and its bytes at the memory rate; beside it the CUDA-core
    fp32 bound and the exp unit's time for one exp a pair."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "fp32_core_bound_ms": 1e3 * max(flops / PEAK_FP32_FLOPS, t_bytes),
            "sfu_ms": 1e3 * b * n * n / SFU_EXP_PER_S}


# Bytes of an operand element and the tensor-core peak of each kernel dtype.
_DTYPE_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_DTYPE_PEAK = {torch.float32: PEAK_TF32_FLOPS, torch.bfloat16: PEAK_BF16_FLOPS}


def flash_bound_ms(b: int, n: int, d: int, c: int, dtype=torch.float32) -> dict:
    """Bounds of the forward: 2*B*N^2*(D + C) FLOPs (the logit and value
    products); read qt, kt, vt once, write out once (in ``dtype``) and lse
    once (float32)."""
    e = _DTYPE_BYTES[dtype]
    return _flash_bounds(b, n, 2.0 * b * n * n * (d + c),
                         e * b * n * (2 * d + c + c) + 4.0 * b * n, _DTYPE_PEAK[dtype])


def flash_bwd_bound_ms(b: int, n: int, d: int, c: int, dtype=torch.float32) -> dict:
    """Bounds of the backward. Per (query, key) pair: the logit (D), dv (C),
    dp (C), dk (D) and dq (D) products; the exp and ds are small beside them.
    Read qt, kt, vt, dOt (in ``dtype``), lse, delta (float32) once; write
    dqt, dkt, dvt (in ``dtype``) once."""
    e = _DTYPE_BYTES[dtype]
    return _flash_bounds(b, n, 2.0 * b * n * n * (3 * d + 2 * c),
                         e * b * n * ((2 * d + 2 * c) + (2 * d + c)) + 4.0 * b * n * 2,
                         _DTYPE_PEAK[dtype])


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at each value of ``x`` (float32): 2^(e - 8) for
    |x| in [2^(e-1), 2^e)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def _bf16_check(name: str, got: torch.Tensor, want: torch.Tensor, atol: float) -> dict:
    """A bf16 kernel output against its plain version, in float32: raises
    beyond ``atol`` + one ulp (BF16_RTOL); returns the max abs error and the
    share of values more than one ulp off."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    torch.testing.assert_close(g, w, atol=atol, rtol=BF16_RTOL, msg=lambda m: f"{name}: {m}")
    return {"max_abs_err": diff.max().item(),
            "beyond_one_ulp_share": (diff > _bf16_ulp(w)).float().mean().item()}


def _sdpa_backend(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs."""
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "unknown"
    return torch.nn.attention.SDPBackend(choose(q4, k4, v4, scale=1.0)).name


def _attention_operands(rng, b: int, n: int, d: int, c: int):
    """qt, kt (B, D, N), vt (B, C, N) on the card: q, k ~ N(0, a^2) with
    a^2 = 2 / sqrt(D), so logits have std 2 and their extremes over B*N^2
    pairs reach +-10 and beyond, as the model's do."""
    a = (2.0 / d**0.5) ** 0.5
    qt, kt = (torch.from_numpy(a * rng.standard_normal((b, d, n), np.float32)).cuda()
              for _ in range(2))
    vt = torch.from_numpy(rng.standard_normal((b, c, n), np.float32)).cuda()
    return qt, kt, vt


def _kernel_build(name: str, d: int, c: int) -> dict:
    """What the build says of the flash kernel ``name`` at (d, c): ptxas's
    registers, spills and remarks of its instantiations there (the vector and
    the one-value load paths) and its dynamic shared memory."""
    tag = f"ILi{d}ELi{c}E"
    return {"ptxas": [r for r in _PTXAS[name] if tag in r["kernel"]],
            "dynamic_smem_bytes": getattr(_build.library(), f"tdt_{name}_smem_bytes")(d, c)}


def _library_too_big(backend: str, b: int, n: int) -> str | None:
    """Why SDPA is not timed at (b, n): its MATH backend's B x N^2 float32
    logits pass LIBRARY_MATH_MAX_BYTES. None when it is timed."""
    logits = 4 * b * n * n
    if backend == "MATH" and logits > LIBRARY_MATH_MAX_BYTES:
        return f"MATH would hold {logits / 1e9:.1f} GB of logits"
    return None


def _library_ms(fn, backend: str, b: int, n: int, iters: int) -> dict:
    """The time of the library yardstick ``fn`` (SDPA), or null with the
    reason (``_library_too_big``)."""
    too_big = _library_too_big(backend, b, n)
    if too_big:
        return {"library_ms": None, "library_backend": backend, "library_not_timed": too_big}
    return {"library_ms": cuda_ms(fn, iters=iters), "library_backend": backend}


def phase_flash_bwd_kernel(dtype=torch.float32) -> list[dict]:
    """The CUDA backward against ``flash_bwd_reference`` at each flash site
    of 256² and beyond (B = 4), with the forward's own lse and a random
    output gradient; two calls bit-equal; the ragged N; kernel, plain and
    SDPA-backward times.
    ``dtype=torch.bfloat16``: the bf16 kernel on the same operands rounded to
    bf16 (``flash_bwd_kernel_bf16``)."""
    bf16 = dtype == torch.bfloat16
    phase = "flash_bwd_kernel_bf16" if bf16 else "flash_bwd_kernel"
    rng = np.random.default_rng(SEED + 11)
    sites = []
    for n, d, c in KERNEL_SITES + KERNEL_SITES_BEYOND_256 + RAGGED_SITES:
        b = 1 if (n, d, c) in RAGGED_SITES else KERNEL_BATCH
        qt, kt, vt = (x.to(dtype) for x in _attention_operands(rng, b, n, d, c))
        out_t, lse = attention.flash_fwd_reference(qt, kt, vt)
        dot = torch.from_numpy(rng.standard_normal((b, c, n), np.float32)).cuda().to(dtype)
        delta = (dot.float() * out_t.float()).sum(1, keepdim=True)
        args = (qt, kt, vt, dot, lse, delta)
        got = attention.flash_bwd(*args)
        again = attention.flash_bwd(*args)
        want = attention.flash_bwd_reference(*args)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        scale = {name: w.abs().max().item() for name, w in zip(names, want)}
        deterministic = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        if bf16:
            checks = {name: _bf16_check(
                f"{phase} {name} N={n}", g, w,
                BWD_ATOL + (BF16_DQ_ULPS_OF_MAX * 2.0**-8 * scale[name] if name == "dq" else 0))
                for name, g, w in zip(names, got, want)}
            errs = {name: v["max_abs_err"] for name, v in checks.items()}
            extra = {"beyond_one_ulp_share": {k: v["beyond_one_ulp_share"]
                                              for k, v in checks.items()}}
        else:
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=BWD_ATOL, rtol=BWD_RTOL)
            errs = {name: (g - w).abs().max().item() for name, g, w in zip(names, got, want)}
            extra = {}
        site = {"B": b, "N": n, "D": d, "C": c, "max_abs_err": max(errs.values()),
                "errs": errs, "max_abs_ref": scale, "bit_equal_over_two_calls": deterministic,
                **extra}
        if not deterministic:
            raise RuntimeError(f"{phase}: two calls differ at N = {n}")
        if (n, d, c) not in RAGGED_SITES:
            q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous().requires_grad_()
                          for x in (qt, kt, vt))
            g4 = dot.transpose(1, 2).unsqueeze(1).contiguous()
            backend = _sdpa_backend(q4, k4, v4)
            o4 = (None if _library_too_big(backend, b, n)  # the forward, outside the timing
                  else F.scaled_dot_product_attention(q4, k4, v4, scale=1.0))
            site["ms"] = cuda_ms(lambda: attention.flash_bwd(*args), iters=10)
            site["plain_ms"] = cuda_ms(lambda: attention.flash_bwd_reference(*args), iters=3)
            site.update(_library_ms(
                lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True),
                backend, b, n, iters=3))
            site.update(flash_bwd_bound_ms(b, n, d, c, dtype))
            site["roofline_share"] = site["bound_ms"] / site["ms"]
            del q4, k4, v4, g4, o4
        tol = ({"atol": BWD_ATOL, "rtol": BF16_RTOL, "dq_ulps_of_max": BF16_DQ_ULPS_OF_MAX}
               if bf16 else {"atol": BWD_ATOL, "rtol": BWD_RTOL})
        name = "flash_bwd_bf16" if bf16 else "flash_bwd"
        emit(phase, name=name, **tol, **site, **_kernel_build(name, d, c))
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
    (wgmma, Hopper's warpgroup product), and the HGMMA by operand type
    (``HGMMA_BF16``: ``HGMMA.64xNx16.F32.BF16``, ``HGMMA_TF32``: ``...x8.F32.TF32``)."""
    bin_dir = os.path.dirname(_build.find_nvcc())
    sass = subprocess.run([os.path.join(bin_dir, "cuobjdump"), "--dump-sass", library],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0, "HGMMA_BF16": 0, "HGMMA_TF32": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line or f" {op} " in line:
                    counts[name][op] += 1
                    if op == "HGMMA":
                        for kind in ("BF16", "TF32"):
                            if f".{kind}" in line.split(";")[0]:
                                counts[name][f"HGMMA_{kind}"] += 1
    filt = os.path.join(bin_dir, "cu++filt")
    if counts and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(counts), capture_output=True,
                               text=True, timeout=60, check=True).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    return counts


# ptxas's report of the flash kernels of the build, by wrapper kernel name
# (set by phase_build; the kernel phases add each site's to their lines).
_PTXAS: dict[str, list[dict]] = {}
# The symbol of each flash kernel's pair kernel in the build.
_KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_tc_kernel", "flash_bwd": "flash_bwd_tc_kernel",
                   "flash_fwd_bf16": "flash_fwd_bf16_kernel",
                   "flash_bwd_bf16": "flash_bwd_bf16_kernel"}


# bf16_layers: the share of a bf16 layer's outputs (and input gradients) in
# which the card may differ from the port's CPU run on the same inputs. The
# outputs: 0.1 %, the CPU tests' bound against JAX's eager layers
# (tests/test_torch_bf16_layers.py), where two implementations' float32
# summation orders part the same way; a wrong rounding point moves 20-50 %
# (the fused bias, F.interpolate's resize). A BatchNorm's or LayerNorm's
# input gradient is two paths, each rounded to bf16 and then added (flax's),
# which turns order gaps into flips, and a conv or dense after it spreads
# them: on an H100 80GB HBM3 the blocks' gradients read 0.6-1.4 % against the
# CPU (cuDNN's and cuBLAS's orders), beyond the CPU tests' 0.2-1.5 %; 3 %.
# In eval mode (serving) the BatchNorm is one float32 kernel on both sides,
# one rounding, one path back: 0.1 % both ways.
BF16_LAYER_SHARES = {"conv": 1e-3, "dense": 1e-3, "resize": 1e-3, "conv_bn_relu": 1e-3,
                     "conv_bn_relu_grad": 0.03, "conv_bn_relu_eval": 1e-3, "time_embed_mlp": 1e-3,
                     "time_embed_mlp_grad": 5e-3, "transformer_block": 1e-3,
                     "transformer_block_grad": 0.03, "dense_bn_relu": 1e-3,
                     "dense_bn_relu_grad": 0.03}


def _bf16_flips(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(share of elements that differ, most bf16 ulps apart at the larger
    value) of two bf16 tensors, compared on the CPU."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    diff = (g - w).abs()
    ulps = diff / _bf16_ulp(torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126))
    return (diff > 0).float().mean().item(), ulps.max().item()


def _bf16_layer_cases() -> list:
    """(name, module, inputs, cotangent) of every bf16 layer the CPU tests
    hold to JAX's, at their shapes: a conv and a dense with their nonzero
    default biases, the resizes of the UNet28 and the LatentUNet,
    ``ConvBNRelu`` and the MLP UNet's dense block in train mode,
    ``ConvBNRelu`` in eval mode with running statistics away from their
    init, ``TimeEmbedMLP`` raw and ``/ 1000``, the DiT's block at one token
    and at four."""
    from tinydiffusion_torch.models.dit import TransformerBlock
    from tinydiffusion_torch.models.mlp_unet import DenseBNRelu
    from tinydiffusion_torch.nn.layers import Conv2d, ConvBNRelu, Linear, TimeEmbedMLP
    from tinydiffusion_torch.nn.resize import align_corners_matrix, resize_bilinear_align_corners

    class Resize(torch.nn.Module):
        def __init__(self, n_in: int, n_out: int):
            super().__init__()
            self.register_buffer("m", torch.from_numpy(align_corners_matrix(n_in, n_out)))

        def forward(self, x):
            return resize_bilinear_align_corners(x, self.m, self.m)

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 40)

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(bf16)

    def with_running_stats(block):
        bn = block.bn
        with torch.no_grad():
            for t, low, high in ((bn.running_mean, -1.0, 1.0), (bn.running_var, 0.5, 4.0),
                                 (bn.weight, 0.5, 1.5), (bn.bias, -0.5, 0.5)):
                t.copy_(torch.rand(t.shape, generator=gen) * (high - low) + low)
        return block.eval()

    torch.manual_seed(SEED + 41)
    cases = [("conv", Conv2d(128, 128, 3, padding=1, dtype=bf16), [normal(16, 128, 14, 14)],
              normal(16, 128, 14, 14)),
             ("dense", Linear(256, 256, dtype=bf16), [normal(64, 256)], normal(64, 256))]
    for n_in, n_out in ((4, 8), (7, 8), (14, 16), (28, 32), (32, 28), (8, 16), (16, 32)):
        cases.append((f"resize_{n_in}_{n_out}", Resize(n_in, n_out), [normal(8, 64, n_in, n_in)],
                      normal(8, 64, n_out, n_out)))
    cases += [
        ("conv_bn_relu", ConvBNRelu(64, 64, dtype=bf16).train(), [normal(16, 64, 14, 14)],
         normal(16, 64, 14, 14)),
        ("conv_bn_relu_eval", with_running_stats(ConvBNRelu(64, 64, dtype=bf16)),
         [normal(16, 64, 14, 14)], normal(16, 64, 14, 14)),
        ("time_embed_mlp", TimeEmbedMLP(256, dtype=bf16),
         [torch.randint(0, 1000, (64,), generator=gen)], normal(64, 256)),
        ("time_embed_mlp_dit", TimeEmbedMLP(256, normalize=1000.0, dtype=bf16),
         [torch.randint(0, 1000, (64,), generator=gen)], normal(64, 256)),
        ("transformer_block", TransformerBlock(256, 4, 1024).eval(),
         [normal(32, 1, 256)], normal(32, 1, 256)),
        ("transformer_block_s4", TransformerBlock(256, 4, 1024).eval(),
         [normal(32, 4, 256)], normal(32, 4, 256)),
        ("dense_bn_relu", DenseBNRelu(512, 256).train(), [normal(128, 512)],
         normal(128, 256)),
    ]
    return cases


def _bf16_layer_run(module, inputs: list, cotangent: torch.Tensor, device: str):
    """``module``'s output and its inputs' gradients (the first parameter's
    where the input is an integer) on ``device``, computing in bfloat16 as
    the train steps run it (``computing_in``)."""
    from tinydiffusion_torch.nn.layers import computing_in

    module = module.to(device)
    xs = [x.detach().clone().to(device).requires_grad_(x.is_floating_point()) for x in inputs]
    with computing_in(module, torch.bfloat16):
        out = module(*xs)
        out.backward(cotangent.to(device))
    grads = [x.grad for x in xs if x.is_floating_point()]
    if not grads:
        grads = [next(module.parameters()).grad]
    return out.detach().cpu(), [g.cpu() for g in grads]


def _fused_bias_flips(bf16_conv: bool) -> dict:
    """Whether the card's library adds a conv's (cuDNN) or a linear's
    (cuBLASLt) bias apart from the product, in bf16: the fused call against
    the product then ``+ bias`` (two roundings, flax's) and against the
    float32 product and bias rounded once."""
    gen = torch.Generator().manual_seed(SEED + 42)
    if bf16_conv:
        x, w, b = (torch.randn(s, generator=gen).to(torch.bfloat16).cuda()
                   for s in ((16, 128, 14, 14), (128, 128, 3, 3), (128,)))

        def product(x, w, b=None):
            return F.conv2d(x, w, b, padding=1)

        view = b[:, None, None]
    else:
        x, w, b = (torch.randn(s, generator=gen).to(torch.bfloat16).cuda()
                   for s in ((64, 256), (256, 256), (256,)))
        product, view = F.linear, b
    fused = product(x, w, b)
    apart = product(x, w) + view
    once = (product(x.float(), w.float()) + view.float()).to(torch.bfloat16)
    return {"fused_vs_apart_share": _bf16_flips(fused, apart)[0],
            "fused_vs_one_rounding_share": _bf16_flips(fused, once)[0],
            "bias_added_apart": bool(torch.equal(fused, apart))}


def phase_bf16_layers() -> dict:
    """Every bf16 layer of the port (``nn.layers``, ``nn.resize``: flax's
    ``dtype=``, each layer rounding where flax's code rounds) on the card
    against the port's CPU run of the same module on the same inputs,
    weights and cotangents, TF32 off: the share of outputs and of input
    gradients that differ, held to ``BF16_LAYER_SHARES``, and the most ulps
    apart; and whether cuDNN's convolution and cuBLASLt's linear add their
    bias apart in bf16 (what the port's split bias replaces)."""
    disable_tf32()
    layers, problems = {}, []
    for name, module, inputs, cotangent in _bf16_layer_cases():
        card_module = copy.deepcopy(module)
        cpu_out, cpu_grads = _bf16_layer_run(module, inputs, cotangent, "cpu")
        out, grads = _bf16_layer_run(card_module, inputs, cotangent, "cuda")
        kind = name.split("_s4")[0].replace("_dit", "")
        kind = "resize" if kind.startswith("resize") else kind
        share, ulps = _bf16_flips(out, cpu_out)
        grad_share, grad_ulps = max(_bf16_flips(g, c) for g, c in zip(grads, cpu_grads))
        layers[name] = {"share": share, "ulps": ulps, "grad_share": grad_share,
                        "grad_ulps": grad_ulps}
        grad_bound = BF16_LAYER_SHARES.get(f"{kind}_grad", BF16_LAYER_SHARES[kind])
        if share > BF16_LAYER_SHARES[kind] or grad_share > grad_bound:
            problems.append(f"{name}: {layers[name]}")
    fields = {"layers": layers, "conv_bias": _fused_bias_flips(True),
              "linear_bias": _fused_bias_flips(False)}
    if problems:
        raise RuntimeError(f"bf16_layers: {problems}: {fields}")
    emit("bf16_layers", **fields)
    return fields


def phase_build() -> None:
    build = _build.build()
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln
             or "Potential Performance Loss" in ln]
    tensor_core = _tensor_core_counts(str(build.path))
    flash = {k: v for k, v in tensor_core.items() if "flash_" in k and "dq_sum" not in k}
    if not any("flash_fwd" in k for k in flash) or not any("flash_bwd" in k for k in flash):
        raise RuntimeError(f"build: no flash kernels in the SASS: {sorted(tensor_core)}")
    missing = [k for k, v in flash.items() if not sum(v.values())]
    if missing:
        raise RuntimeError(f"build: flash kernels without tensor-core instructions: {missing}")
    # The bf16 kernels run their products as bf16 wgmma (k16), none as tf32.
    bf16 = {k: v for k, v in flash.items() if "_bf16_kernel" in k}
    wrong = [k for k, v in bf16.items() if not v["HGMMA_BF16"] or v["HGMMA_TF32"] or v["HMMA"]]
    # Two instantiations (the vector and the one-value load paths) of each
    # bf16 kernel at each head width.
    if len(bf16) != 4 * len(attention.KERNEL_HEAD_WIDTHS) or wrong:
        raise RuntimeError(f"build: bf16 flash kernels not all bf16 wgmma: {wrong or sorted(bf16)}")
    reports = ptxas_report(build.log)
    for name, kernel in _KERNEL_SYMBOLS.items():
        _PTXAS[name] = [{"kernel": k, **v} for k, v in sorted(reports.items())
                        if k and kernel in k]
        if len(_PTXAS[name]) != 2 * len(attention.KERNEL_HEAD_WIDTHS):
            raise RuntimeError(f"build: {kernel}: {len(_PTXAS[name])} instantiations")
    for name in ("flash_fwd_bf16", "flash_bwd_bf16"):
        spills = [r["kernel"] for r in _PTXAS[name]
                  if r.get("spill_stores") or r.get("spill_loads")]
        if spills:
            raise RuntimeError(f"build: {name} spills registers: {spills}")
    lib = _build.library()
    smem = {f"{name} ({d}, {c})": getattr(lib, f"tdt_{name}_smem_bytes")(d, c)
            for name in _FLASH_KERNELS for d, c in sorted(attention.KERNEL_HEAD_WIDTHS)}
    # The loader's C decoders, built by the host compiler (never nvcc).
    decoders = _build.build(_build.DECODERS)
    emit("build", seconds=round(build.seconds, 3), cached=build.seconds == 0.0,
         library=os.path.relpath(build.path, REPO), ptxas=ptxas, tensor_core=tensor_core,
         dynamic_smem_bytes=smem, decoders_library=os.path.relpath(decoders.path, REPO),
         decoders_compiler=decoders.compiler or _build.find_cc(),
         decoders_seconds=round(decoders.seconds, 3), decoders_cached=decoders.seconds == 0.0)


def phase_kernel(dtype=torch.float32) -> list[dict]:
    """The CUDA forward against ``flash_fwd_reference`` at each flash site of
    256² and beyond (B = 4) and at the ragged N, out and lse; two calls
    bit-equal; kernel, plain and SDPA times at the sites.
    ``dtype=torch.bfloat16``: the bf16 kernel on the same operands rounded to
    bf16 (``kernel_bf16``)."""
    bf16 = dtype == torch.bfloat16
    phase = "kernel_bf16" if bf16 else "kernel"
    rng = np.random.default_rng(SEED)
    sites = []
    for n, d, c in KERNEL_SITES + KERNEL_SITES_BEYOND_256 + RAGGED_SITES:
        b = 1 if (n, d, c) in RAGGED_SITES else KERNEL_BATCH
        qt, kt, vt = (x.to(dtype) for x in _attention_operands(rng, b, n, d, c))
        out_k, lse_k = attention.flash_fwd(qt, kt, vt)
        again = attention.flash_fwd(qt, kt, vt)
        out_r, lse_r = attention.flash_fwd_reference(qt, kt, vt)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse_k, lse_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        extra = {}
        if bf16:
            if out_k.dtype != torch.bfloat16:
                raise RuntimeError(f"{phase}: out is {out_k.dtype}")
            check = _bf16_check(f"{phase} out N={n}", out_k, out_r, KERNEL_ATOL)
            extra = {"beyond_one_ulp_share": check["beyond_one_ulp_share"],
                     "lse_max_abs_err": (lse_k - lse_r).abs().max().item()}
        else:
            torch.testing.assert_close(out_k, out_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        if not (torch.equal(again[0], out_k) and torch.equal(again[1], lse_k)):
            raise RuntimeError(f"{phase}: two calls differ at N = {n}")
        err = max((out_k.float() - out_r.float()).abs().max().item(),
                  (lse_k - lse_r).abs().max().item())
        site = {"B": b, "N": n, "D": d, "C": c, "max_abs_err": err,
                "bit_equal_over_two_calls": True, **extra}
        if (n, d, c) not in RAGGED_SITES:
            # (B, 1, N, D) views for the library yardstick, made outside its timing.
            q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous() for x in (qt, kt, vt))
            site["ms"] = cuda_ms(lambda: attention.flash_fwd(qt, kt, vt), iters=20)
            site["plain_ms"] = cuda_ms(lambda: attention.flash_fwd_reference(qt, kt, vt),
                                       iters=5)
            site.update(_library_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0),
                _sdpa_backend(q4, k4, v4), b, n, iters=5))
            site.update(flash_bound_ms(b, n, d, c, dtype))
            site["roofline_share"] = site["bound_ms"] / site["ms"]
            del q4, k4, v4
        tol = ({"atol": KERNEL_ATOL, "rtol": BF16_RTOL, "lse_rtol": KERNEL_RTOL} if bf16
               else {"atol": KERNEL_ATOL, "rtol": KERNEL_RTOL})
        name = "flash_fwd_bf16" if bf16 else "flash_fwd"
        emit(phase, name=name, **tol, **site, **_kernel_build(name, d, c))
        sites.append(site)
        del qt, kt, vt, out_k, lse_k, again, out_r, lse_r
        torch.cuda.empty_cache()
    if not bf16:
        sites += [_fid_kernel_site(rng, n, d, c) for n, d, c in KERNEL_SITES]
    return sites


def _fid_kernel_site(rng, n: int, d: int, c: int) -> dict:
    """The float32 forward at fid_laion's batch (B = 32) against its plain
    version run on slices of KERNEL_BATCH rows (its N² logits at B = 32 would
    take 34 GB at N = 16384); kernel, plain and SDPA times at B = 32."""
    b = FID_LAION_BATCH
    qt, kt, vt = _attention_operands(rng, b, n, d, c)

    def plain():
        parts = [attention.flash_fwd_reference(qt[i:i + KERNEL_BATCH], kt[i:i + KERNEL_BATCH],
                                               vt[i:i + KERNEL_BATCH])
                 for i in range(0, b, KERNEL_BATCH)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    out_k, lse_k = attention.flash_fwd(qt, kt, vt)
    out_r, lse_r = plain()
    torch.testing.assert_close(out_k, out_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    torch.testing.assert_close(lse_k, lse_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous() for x in (qt, kt, vt))
    site = {"B": b, "N": n, "D": d, "C": c, "path": "fid_laion",
            "max_abs_err": max((out_k - out_r).abs().max().item(),
                               (lse_k - lse_r).abs().max().item()),
            "ms": cuda_ms(lambda: attention.flash_fwd(qt, kt, vt), iters=10),
            "plain_ms": cuda_ms(plain, iters=2, warmup=1),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0), iters=5),
            "library_backend": _sdpa_backend(q4, k4, v4), **flash_bound_ms(b, n, d, c)}
    site["roofline_share"] = site["bound_ms"] / site["ms"]
    emit("kernel", name="flash_fwd", atol=KERNEL_ATOL, rtol=KERNEL_RTOL, **site)
    del qt, kt, vt, q4, k4, v4, out_k, lse_k, out_r, lse_r
    torch.cuda.empty_cache()
    return site


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

    # The first request of each runs eagerly (the warm-up of its graph).
    t0 = time.perf_counter()
    reconstruct(model, x01, eps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sample_prior(model, N_PRIOR, gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # The main path, with the kernel launches counted over exactly this work:
    # each request captured in its CUDA graph and replayed, the flash
    # forwards counted at the replay.
    replays = [vae_laion._RECONSTRUCT.counts["replays"], vae_laion._SAMPLE_PRIOR.counts["replays"]]
    attention.flash_fwd_launches = 0
    recon = reconstruct(model, x01, eps)
    launches_recon = attention.flash_fwd_launches
    prior = sample_prior(model, N_PRIOR, gen)
    launches = attention.flash_fwd_launches
    torch.cuda.synchronize()
    replays = [vae_laion._RECONSTRUCT.counts["replays"] - replays[0],
               vae_laion._SAMPLE_PRIOR.counts["replays"] - replays[1]]
    if (launches_recon, launches, replays) != (3, 4, [1, 1]):
        raise RuntimeError(
            f"flash_fwd launches: {launches_recon} in reconstruct (want 3), "
            f"{launches} with the prior decode (want 4); graph replays {replays} (want 1, 1)")

    if tuple(recon.shape) != (N_RECON, 3, size, size):
        raise RuntimeError(f"reconstruction shape {tuple(recon.shape)}")
    if tuple(prior.shape) != (N_PRIOR, 3, size, size):
        raise RuntimeError(f"prior sample shape {tuple(prior.shape)}")
    for name, t in (("reconstruction", recon), ("prior samples", prior)):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{name} hold non-finite values")
        if t.min().item() < 0.0 or t.max().item() > 1.0:
            raise RuntimeError(f"{name} leave [0, 1]")

    # Warm steady-state request times (graph replays).
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
         steady_reconstruct_ms=steady["reconstruct"], graph_replays=replays,
         steady_sample_prior_ms=steady["sample_prior"],
         flash_fwd_launches=launches,
         recon_l1_to_input=(recon.cpu() - x01).abs().mean().item(),
         card_vs_cpu_max_abs=card_vs_cpu, card_vs_cpu_atol=CARD_VS_CPU_ATOL,
         grid_png_bytes=grid_bytes,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return launches


_FLASH_KERNELS = attention.KERNELS


def _reset_launches() -> None:
    for kernel in _FLASH_KERNELS:
        setattr(attention, f"{kernel}_launches", 0)
    for key in attention.launches_by_width:
        attention.launches_by_width[key] = 0
    qsample.qsample_launches = 0


def _launches() -> dict:
    return {**{k: getattr(attention, f"{k}_launches") for k in _FLASH_KERNELS},
            "qsample": qsample.qsample_launches}


def _launches_by_width() -> dict[str, int]:
    """The flash launches since the last reset by kernel and (D, C), those
    launched."""
    return {f"{k} ({d}, {c})": n for (k, d, c), n in sorted(attention.launches_by_width.items())
            if n}


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
    row_spans = _qsample_row_offsets(schedule, x0, t, seed, xt_k, z_k)
    err = max([err] + [r["plain_max_abs_err"] for r in row_spans])
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
            "row_corr_0_1": row_corr, "row_offset_spans": row_spans}
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


def _qsample_row_offsets(schedule, x0, t, seed, xt_all, z_all) -> list[dict]:
    """The kernel on rows [lo, hi) of the batch with ``row_offset=lo``, as a
    data-parallel rank launches it: bit-equal to those rows of the launch on
    the whole batch, and within QSAMPLE_ATOL of the plain version at the
    same offset."""
    spans = []
    for lo, hi in QSAMPLE_ROW_SPANS:
        xs, ts = x0[lo:hi].contiguous(), t[lo:hi].contiguous()
        xt_o, z_o = qsample.q_sample_fused(schedule, xs, ts, seed, row_offset=lo)
        xt_p, z_p = qsample.q_sample_fused_reference(schedule, xs, ts, seed, row_offset=lo)
        torch.cuda.synchronize()
        span = {"rows": [lo, hi],
                "bit_equal_to_global": torch.equal(xt_o, xt_all[lo:hi])
                and torch.equal(z_o, z_all[lo:hi]),
                "plain_max_abs_err": max((z_o - z_p).abs().max().item(),
                                         (xt_o - xt_p).abs().max().item())}
        if not (span["bit_equal_to_global"] and span["plain_max_abs_err"] <= QSAMPLE_ATOL):
            raise RuntimeError(f"q_sample kernel at a row offset: {span}")
        spans.append(span)
    return spans


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


def _flat(tensors) -> torch.Tensor:
    return torch.cat([x.detach().flatten() for x in tensors])


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a @ b / (a.norm() * b.norm())).item()


def _parity_record(state, losses: list, params0: torch.Tensor, ema0: torch.Tensor) -> dict:
    """What one run of the parity steps left: its losses, params, EMA shadow,
    BatchNorm statistics and generator state, and the updates."""
    params, ema = _flat(state.model.parameters()), _flat(state.ema_params.values())
    stats = _flat([b for n, b in state.model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))]
                  or [torch.zeros(1, device="cuda")])  # the DiT has no BatchNorm
    return {"losses": losses, "params": params, "update": (params - params0).double(),
            "ema": ema, "ema_update": (ema - ema0).double(), "stats": stats,
            "generator": state.generator.get_state()}


def _parity_fields(name: str, out: dict, bounds: dict | None = None) -> tuple[dict, bool]:
    """Graph against eager, and eager against itself (the noise floor of the
    atomics, beside what the graph adds to it), for one compute dtype
    ``name``; and whether graph against eager is inside the ``bounds``
    (``_parity_bounds()`` by default). Records without an EMA shadow skip
    its checks."""
    bounds = bounds or _parity_bounds()
    ema = "ema" in out["graph"]
    fields = {"losses_graph": out["graph"]["losses"], "losses_eager": out["eager"]["losses"]}
    for pair, (g, e) in (("graph_vs_eager", (out["graph"], out["eager"])),
                         ("eager_vs_eager", (out["eager_again"], out["eager"]))):
        fields[pair] = {
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(g["losses"], e["losses"])),
            "update_cos": _cos(g["update"], e["update"]),
            # The replays advanced the registered generator as eager steps do.
            "generator_equal": torch.equal(g["generator"], e["generator"]),
            "bit_equal": (g["losses"] == e["losses"] and torch.equal(g["params"], e["params"])
                          and (not ema or torch.equal(g["ema"], e["ema"]))
                          and torch.equal(g["stats"], e["stats"])),
            "params_max_abs": (g["params"] - e["params"]).abs().max().item(),
            "stats_max_rel": ((g["stats"] - e["stats"]).abs()
                              / e["stats"].abs().clamp_min(1.0)).max().item(),
        }
        if ema:
            fields[pair]["ema_update_cos"] = _cos(g["ema_update"], e["ema_update"])
    check = fields["graph_vs_eager"]
    ok = (check["generator_equal"] and check["loss_rel"] <= bounds["loss_rtol"][name]
          and check["update_cos"] >= bounds["min_update_cos"][name]
          and (not ema or check["ema_update_cos"] >= bounds["min_update_cos"][name])
          and check["params_max_abs"] <= bounds["max_params_abs"][name]
          and check["stats_max_rel"] <= bounds["max_stats_rel"][name])
    return fields, ok


def _parity_bounds() -> dict:
    return {"loss_rtol": PARITY_LOSS_RTOL, "min_update_cos": PARITY_MIN_UPDATE_COS,
            "max_params_abs": PARITY_MAX_PARAM_ABS, "max_stats_rel": PARITY_MAX_STATS_REL}


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
              "batch": PARITY_BATCH, **_parity_bounds()}
    failed = []
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        out = {}
        options = dict(step_options, ema_decay=PARITY_EMA_DECAY, compute_dtype=dtype)
        for mode in ("graph", "eager", "eager_again"):
            state, dataset = _resident_state(images, load_model(), ema=True, labels=labels)
            params0, ema0 = _flat(state.model.parameters()), _flat(state.ema_params.values())
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
            out[mode] = _parity_record(state, losses, params0, ema0)
        fields[name], ok = _parity_fields(name, out)
        if not ok:
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
                                        / result["forwards"],
                                        "captures": result["captures"],
                                        "replays": result["replays"]}
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
    if forwards != SERVE_FORWARDS:
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


def _timed(fn):
    """``(ms, fn())``, host clock, the device's work included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def _kernel_events(fn) -> int:
    """Kernel events on the device in one profiler session over ``fn()``
    (taken again, up to 3 times, when a session returns none)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0 and not getattr(ev, "is_user_annotation", False))
        if n:
            return n
    raise RuntimeError("chain_graph: three profiler sessions without kernel events")


def _chain_graph_case(fn, eager, counts: dict, steps: int, seed: int, profiled=None) -> dict:
    """``fn(generator)`` (the graphs) three times and ``eager(generator)``
    twice, each from a generator seeded ``seed``: the first graph request
    warms up and captures, the last is timed warm; each against the first
    eager run (and the second eager run against the first), the generators'
    states after each, the warm times, the captures' host time, the kernels
    a step (a profiler session over ``profiled = (fn, its steps)``, else over
    a warm graph request) and the forwards a request."""

    def gen():
        return torch.Generator("cuda").manual_seed(seed)

    before = dict(counts)
    flash_before = _launches()
    graph_gens = [gen() for _ in range(3)]
    first = fn(graph_gens[0])
    second = fn(graph_gens[1])
    graph_ms, third = _timed(lambda: fn(graph_gens[2]))
    flash = {k: v - flash_before[k] for k, v in _launches().items() if v != flash_before[k]}
    done = {k: counts[k] - before[k] for k in ("eager", "captures", "replays", "forwards")}
    eager_gens = [gen(), gen()]
    _, want = _timed(lambda: eager(eager_gens[0]))
    eager_ms, again = _timed(lambda: eager(eager_gens[1]))
    scale = want.float().abs().max().item()

    def gap(a):
        return (a.float() - want.float()).abs().max().item()

    max_abs = max(gap(x) for x in (first, second, third))
    profiled_fn, profiled_steps = profiled or (fn, steps)
    return {
        "max_abs": max_abs, "bit_equal": max_abs == 0.0, "eager_vs_eager_max_abs": gap(again),
        "bound": CHAIN_GRAPH_REL * scale, "scale": scale,
        "generator_equal": all(torch.equal(g.get_state(), eager_gens[0].get_state())
                               for g in graph_gens + eager_gens[1:]),
        "eager_ms": eager_ms, "replay_ms": graph_ms, "speedup": eager_ms / graph_ms,
        "capture_ms": counts["capture_ms"] - before["capture_ms"],
        "kernels_per_step": _kernel_events(lambda: profiled_fn(gen())) / profiled_steps,
        "forwards": done["forwards"] / 3, "steps": steps, "counts": done,
        "flash_launches_graph": flash,
    }


def _chain_graph_flash(fields: dict, kernel: str) -> int:
    return sum(c["flash_launches_graph"].get(kernel, 0) for c in fields["chains"].values())


def phase_chain_graph() -> dict:
    """Each sampler chain of the serving and evaluation paths replayed from
    CUDA graphs against the same chain run eagerly, and the conv-VAE's
    ``reconstruct`` and ``sample_prior`` graphs against their eager calls
    (see CHAIN_GRAPH_REL)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    n, bf16 = SERVE_N, torch.bfloat16
    y7 = torch.full((n,), 7, dtype=torch.int64, device="cuda")
    rng = np.random.default_rng(SEED + 60)
    chains = {}

    def sampler_case(name, sampler, steps, seed, *args, profiled=None, **kwargs):
        chains[name] = _chain_graph_case(
            lambda g: sampler(g, *args, **kwargs), lambda g: sampler.eager(g, *args, **kwargs),
            sampler.counts, steps, seed, profiled)

    # UNet28 diffusion_final: the bf16 forward under the fp32 chain (JAX's).
    unet = load_pixel_checkpoint(UNET_CHECKPOINT, "cuda")
    model, params = unet["model"], unet["params"]
    sched20 = DiffusionSchedule.linear(20).to("cuda")
    # The DDPM-1000 chain's kernels a step, from the same step at T = 20.
    twin = make_sampler(model, sched20, (n, 1, 28, 28), compute_dtype=bf16)
    twin(torch.Generator("cuda").manual_seed(0), params=params)
    sampler_case("unet28_ddpm1000", make_sampler(model, unet["schedule"], (n, 1, 28, 28),
                                                 compute_dtype=bf16),
                 1000, SEED + 61, params=params,
                 profiled=(lambda g: twin(g, params=params), 20))
    x_known = torch.from_numpy(rng.uniform(-1, 1, (1, 1, 28, 28)).astype(np.float32)).cuda()
    mask = torch.zeros(1, 1, 28, 28, device="cuda")
    mask[..., :14] = 1.0
    sampler_case("unet28_ddpm20_inpaint", make_sampler(
        model, sched20, (n, 1, 28, 28), mask=mask, x_known=x_known, compute_dtype=bf16),
        20, SEED + 62, params=params)
    sampler_case("unet28_trajectory_stride100", make_trajectory_sampler(
        model, unet["schedule"], (4, 1, 28, 28), stride=100, compute_dtype=bf16),
        10, SEED + 63, params=params)
    # The CFG UNet28 at guidance 2 (generate.py's requests).
    cfg = load_pixel_checkpoint(CFG_CHECKPOINT, "cuda")
    guided = dict(conditional=True, guidance_scale=2.0, null_label=NULL_LABEL,
                  compute_dtype=bf16)
    x_noised = torch.from_numpy(rng.standard_normal((n, 1, 28, 28)).astype(np.float32)).cuda()
    for name, options, steps, inputs in (
            ("cfg_ddim50_eta0", dict(method="ddim", sample_steps=50), 50, {}),
            ("cfg_ddim50_eta1", dict(method="ddim", sample_steps=50, eta=1.0), 50, {}),
            ("cfg_img2img_t599", dict(method="ddim", sample_steps=50, t_start=599), 50,
             {"x_init": x_noised}),
            ("cfg_dpmpp15", dict(method="dpmpp", sample_steps=15), 15, {})):
        sampler_case(name, make_sampler(cfg["model"], cfg["schedule"], (n, 1, 28, 28),
                                        **guided, **options),
                     steps, SEED + 64, params=cfg["params"], y=y7, **inputs)
    # The latent checkpoints: DPM++-15 and the VAE's decode.
    for backbone, path in LATENT_CHECKPOINTS.items():
        loaded = load_latent_checkpoint(path, device="cuda")
        sampler_case(f"{backbone}_dpmpp15_decode", make_latent_pixel_sampler(
            loaded, n, method="dpmpp", sample_steps=15), 15, SEED + 65, y7)
    # LAION on the patch codec at guidance 2: DDIM-50 and the decode.
    laion = generate_laion.load_laion_checkpoint(LAION_CHECKPOINT, "cuda")
    prompts = conditional_diffusion_laion.SAMPLE_PROMPTS
    encoder = laion["text_encoder"]
    embeds = torch.from_numpy(encoder.encode(prompts)).cuda()
    sampler_case("laion_ddim50_guided_decode", conditional_diffusion_laion.make_laion_sampler(
        laion["model"], laion["schedule"], laion["codec"], len(prompts), 32, 4,
        compute_dtype=bf16, guidance_scale=2.0,
        null_embed=torch.from_numpy(encoder.encode([""])[0]).cuda(), method="ddim",
        sample_steps=50), 50, SEED + 66, embeds)
    # The conv-VAE's serving calls, float32 and bfloat16.
    for dtype in (torch.float32, bf16):
        vae = (load_conv_vae(CHECKPOINT, device="cuda") if dtype == torch.float32
               else _conv_vae(bf16).eval())
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        for b in CHAIN_GRAPH_VAE_BATCHES:
            x01 = _nchw(np.stack([synthesize_image(i, vae.image_size)[0]
                                  for i in range(b)])).cuda()
            eps = torch.from_numpy(rng.standard_normal((b, vae.latent_dim)).astype(
                np.float32)).cuda()
            with torch.inference_mode():
                chains[f"vae_{tag}_reconstruct_b{b}"] = _chain_graph_case(
                    lambda g: reconstruct(vae, x01, eps),
                    lambda g: vae_laion._reconstruct(vae, x01, eps),
                    vae_laion._RECONSTRUCT.counts, 1, SEED + 67)
                chains[f"vae_{tag}_sample_prior_b{b}"] = _chain_graph_case(
                    lambda g: sample_prior(vae, b, g),
                    lambda g: vae.decode(torch.randn(b, vae.latent_dim, generator=g,
                                                     device="cuda")),
                    vae_laion._SAMPLE_PRIOR.counts, 1, SEED + 68)
    torch.backends.cudnn.deterministic = deterministic

    problems = []
    for name, c in chains.items():
        if not (c["max_abs"] <= c["bound"] and c["generator_equal"]
                and c["forwards"] == c["steps"] and c["counts"]["captures"] >= 1
                and c["counts"]["replays"] >= 1):
            problems.append(f"{name}: {c}")
        print(f"chain_graph: {name:<32s} max|graph - eager| {c['max_abs']:.3g} "
              f"(eager vs eager {c['eager_vs_eager_max_abs']:.3g}), generator equal "
              f"{c['generator_equal']}, eager {c['eager_ms']:.2f} ms, replayed "
              f"{c['replay_ms']:.2f} ms, capture {c['capture_ms']:.1f} ms, "
              f"{c['kernels_per_step']:.1f} kernels a step, {c['forwards']:.0f} forwards",
              flush=True)
    del model, params, unet, cfg, laion, vae
    gc.collect()
    torch.cuda.empty_cache()
    fields = {"chains": chains, "rel_bound": CHAIN_GRAPH_REL, "cudnn_deterministic": True}
    if problems:
        raise RuntimeError(f"chain_graph: {problems}")
    emit("chain_graph", **fields)
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
        if launches != {**dict.fromkeys(_FLASH_KERNELS, 0), "qsample": steps + split["eval"]}:
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
                                  / result["forwards"],
                                  "captures": result["captures"], "replays": result["replays"]}
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


def _laion_recipe(**overrides) -> "conditional_diffusion_laion.LaionDiffusionConfig":
    """The committed LAION checkpoint's recipe (its sidecar's config), on the
    card, with JAX's default T_max of num_epochs = 1000 scheduler steps kept
    whatever num_epochs says, and ``overrides``."""
    config = conditional_diffusion_laion.config_from_sidecar(
        load_sidecar(LAION_CHECKPOINT)["config"])
    return dataclasses.replace(config, scheduler_t_max=config.scheduler_t_max
                               or config.num_epochs, device="cuda", **overrides)


def _record_cache(tmp: str, shared: str | None = None) -> dict:
    """A run's LAION record cache (``shared``, one the LAION runs at 256²
    fill and read in turn, or its own in ``tmp``) and its failed-URL list,
    in ``tmp``: nothing lands in the tree."""
    return {"image_cache_dir": shared or os.path.join(tmp, "laion_cache"),
            "failed_urls_cache": os.path.join(tmp, "failed_urls.json")}


def _host_lr(count: int, t_max: int, lr: float, lr_min: float) -> float:
    """torch's CosineAnnealingLR at ``count``, in float64 on the host."""
    return lr_min + (lr - lr_min) * 0.5 * (1.0 + np.cos(np.pi * count / t_max))


class _LoopbackServer:
    """A ThreadingHTTPServer on 127.0.0.1 in a thread, serving ``routes``
    (name -> callable(hit) -> (status, headers, body); a query string picks
    no other route) and counting the requests a path, query included."""

    def __init__(self, routes: dict):
        self.hits = {}
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                outer.hits[self.path] = outer.hits.get(self.path, 0) + 1
                route = routes.get(self.path.split("?")[0].strip("/"))
                status, headers, body = (route(outer.hits[self.path]) if route
                                         else (404, {}, b"missing"))
                self.send_response(status)
                for key, value in {"Content-Length": str(len(body)), **headers}.items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)
                self.close_connection = True

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _sha(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


# The plain versions of the C decoders, by the format identify_data names.
_PLAIN_DECODERS = {"JPEG": lambda data, header: jpeg_data.decode_jpeg_reference(data),
                   "GIF": lambda data, header: gif_data.decode_gif_reference(data),
                   "WEBP": lambda data, header: webp_data.decode_webp_reference(data),
                   "TIFF": lambda data, header: tiff_data.decode_tiff_reference(data),
                   "TGA": tga_data.decode_tga_reference, "QOI": qoi_data.decode_qoi_reference}


def _plain_decode(data: bytes) -> np.ndarray:
    """``decode_image`` with the plain versions of the C decoders (PNG, BMP,
    DIB, ICO, JPEG 2000 and Netpbm have none: theirs is ``decode_image``'s)."""
    plugin, header = identify_data.open_image(data)
    if plugin.name in _PLAIN_DECODERS:
        return _PLAIN_DECODERS[plugin.name](data, header)
    return laion_data.decode_image(data)


def phase_laion_loader() -> dict:
    """The port's LAION loader on this machine (no Pillow, requests, urllib3
    or datasets): ``LAIONImageTextDataset`` and ``precache_dataset`` over
    two synthetic records and a loopback HTTP server that serves a JPEG
    written by ``encode_jpeg``, the 4:4:4 JPEG and the RGBA PNG of
    ``tests/fixtures/``, a 503 then a 200, a 404, a black image and a body
    shorter than its Content-Length. Checks the valid list, the requests
    (one retry after the 503), the cache files (each the quality-95 JPEG of
    what was fetched, byte for byte ``encode_jpeg`` of the decode), every
    fixture's decode and resize against Pillow's (``LOADER_PILLOW``: JPEG
    baseline, progressive and CMYK, PNG RGBA, Adam7 and 16-bit grey, GIF,
    BMP, WebP lossless and lossy, TIFF of every compression the loader reads
    (tiles, planar and big-endian ones too; YCbCr at 1 x 1, 2 x 2 and 4 x 2),
    ICO and CUR, JPEG 2000 (JP2 and J2K, both wavelets, every progression
    order, the modes Pillow writes, YCbCr and sYCC), arithmetic-coded JPEG
    (sequential and progressive, restarts, DAC), 8-bit lossless JPEG, TGA
    (every mode, raw and run-length), DIB, Netpbm and QOI;
    each decode timed, 512² ones included, and held to the plain decoders
    byte for byte where there are any, but for the 512² arithmetic-coded
    one, ``LOADER_C_ONLY``), the
    failed-URL JSON, a warm re-read by a second instance (each record
    the decode of its cache file), and the cold ``precache_dataset`` time
    of the two 512² fixtures (``LOADER_WEB_FIXTURES``) served over the same
    loopback. Caches and lists in a temporary directory."""
    with open(LOADER_PILLOW) as f:
        pillow = json.load(f)
    fixtures = {}
    for name in sorted(k for k in pillow if k != "note"):
        with open(os.path.join(REPO, "tests", "fixtures", name), "rb") as f:
            fixtures[name] = f.read()
    photo = encode_jpeg(synthesize_image(3, 96)[0][:80], 90)
    black = encode_png(np.zeros((LOADER_SIZE, LOADER_SIZE, 3), np.uint8))
    short = encode_jpeg(synthesize_image(5, 96)[0], 90)
    routes = {
        "photo.jpg": lambda hit: (200, {}, photo),
        "photo444.jpg": lambda hit: (200, {}, fixtures["laion_loader_444.jpg"]),
        "rgba.png": lambda hit: (200, {}, fixtures["laion_loader_rgba.png"]),
        "flaky.jpg": lambda hit: (503, {}, b"busy") if hit == 1 else (200, {}, photo),
        "black.png": lambda hit: (200, {}, black),
        "short.jpg": lambda hit: (200, {"Content-Length": str(len(short))}, short[:len(short) // 2]),
        **{name: (lambda hit, name=name: (200, {}, fixtures[name])) for name in LOADER_WEB_FIXTURES},
    }
    server = _LoopbackServer(routes)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            names = ["photo.jpg", "photo444.jpg", "rgba.png", "flaky.jpg", "missing.jpg",
                     "black.png", "short.jpg"]
            records = laion_data.load_laion_dataset(2) + [
                {"URL": f"{server.base}/{name}", "TEXT": f"web {name}"} for name in names]
            cache = _record_cache(tmp)

            def dataset():
                return laion_data.LAIONImageTextDataset(
                    records, cache_dir=cache["image_cache_dir"],
                    failed_urls_cache=cache["failed_urls_cache"], image_size=LOADER_SIZE,
                    normalize=True, on_error="raise", as_uint8=True)

            t0 = time.perf_counter()
            valid = laion_data.precache_dataset(dataset())
            precache_s = time.perf_counter() - t0
            problems = []
            if valid != [0, 1, 2, 3, 4, 5]:
                problems.append(f"valid {valid}")
            want_hits = {"/photo.jpg": 1, "/photo444.jpg": 1, "/rgba.png": 1, "/flaky.jpg": 2,
                         "/missing.jpg": 1, "/black.png": 1, "/short.jpg": 1}
            if server.hits != want_hits:
                problems.append(f"requests {server.hits}")
            fetched = {"photo.jpg": photo, "photo444.jpg": fixtures["laion_loader_444.jpg"],
                       "rgba.png": fixtures["laion_loader_rgba.png"], "flaky.jpg": photo,
                       "black.png": black}
            ds = dataset()
            for record in records:
                path = ds._cache_path(record["URL"])
                name = record["URL"].rsplit("/", 1)[-1]
                if record["URL"].startswith(laion_data.SYNTHETIC_SCHEME):
                    source = synthesize_image(int(name), LOADER_SIZE)[0]
                else:
                    source = laion_data.decode_image(fetched[name]) if name in fetched else None
                if source is None:
                    if os.path.exists(path):
                        problems.append(f"{name}: cached, but its fetch failed")
                    continue
                with open(path, "rb") as f:
                    if f.read() != encode_jpeg(source):
                        problems.append(f"{name}: the cache file is not encode_jpeg of the fetch")
            decode_s, plain_decode_s, digests = {}, {}, {}
            for fixture in fixtures:
                t1 = time.perf_counter()
                image = laion_data.decode_image(fixtures[fixture])
                decode_s[fixture] = time.perf_counter() - t1
                small = resize_u8(image, LOADER_SIZE, LOADER_SIZE, "bilinear")
                digests[fixture] = _sha(image)
                if (digests[fixture], _sha(small)) != (pillow[fixture]["rgb_sha256"],
                                                  pillow[fixture]["rgb64_sha256"]):
                    problems.append(f"{fixture}: decode or resize differs from Pillow's")
                # The C decoders against their plain versions, byte for byte.
                if fixture in LOADER_C_ONLY:
                    continue
                t1 = time.perf_counter()
                plain = _plain_decode(fixtures[fixture])
                plain_decode_s[fixture] = time.perf_counter() - t1
                if plain.shape != image.shape or not np.array_equal(plain, image):
                    problems.append(f"{fixture}: the C decode differs from the plain version's")
            with open(cache["failed_urls_cache"]) as f:
                failed = json.load(f)
            if failed != sorted(f"{server.base}/{n}" for n in ("missing.jpg", "black.png",
                                                             "short.jpg")):
                problems.append(f"failed {failed}")
            warm = dataset()
            for i in valid:
                with open(warm._cache_path(records[i]["URL"]), "rb") as f:
                    want = decode_jpeg(f.read())
                if want.shape[:2] != (LOADER_SIZE, LOADER_SIZE):
                    want = resize_u8(want, LOADER_SIZE, LOADER_SIZE, "bilinear")
                if not np.array_equal(warm[i][0], want):
                    problems.append(f"record {i}: the warm read is not its cache's decode")
            hits_after = dict(server.hits)
            if hits_after != want_hits:  # the warm reads and the failed list ask no server
                problems.append(f"warm requests {hits_after}")
            # The cold rate at a web image's size: the 512² progressive JPEG
            # and lossy WebP, each fetched, decoded, resized and cached.
            web = [f"{server.base}/{name}" for name in LOADER_WEB_FIXTURES]
            t0 = time.perf_counter()
            web_valid = laion_data.precache_dataset(laion_data.LAIONImageTextDataset(
                [{"URL": url, "TEXT": url} for url in web],
                cache_dir=os.path.join(tmp, "web_cache"),
                failed_urls_cache=os.path.join(tmp, "web_failed.json"), image_size=LOADER_SIZE,
                normalize=True, on_error="raise", as_uint8=True))
            web_precache_s = time.perf_counter() - t0
            if web_valid != list(range(len(web))):
                problems.append(f"web-size records valid {web_valid}")
    finally:
        server.close()
    fields = {"records": len(records), "valid": valid, "requests": hits_after,
              "failed": len(failed), "precache_s": precache_s, "image_size": LOADER_SIZE,
              "fixtures_matched": len(fixtures), "digests": digests, "decode_s": decode_s,
              "plain_decode_s": plain_decode_s,
              "web_decode_s": {k: decode_s[k] for k in LOADER_WEB_FIXTURES},
              # A 512² JPEG 2000 (9/7, 12:1) beside the 512² JPEG and WebP.
              "jp2_512_decode_s": decode_s[LOADER_JP2_512],
              # The arithmetic-coded progressive JPEG (C only), the YCbCr JP2,
              # the 2 x 2 YCbCr TIFF, the lossless JPEG, the run-length TGA
              # and the QOI, each 512², and their plain decodes.
              "new_512_decode_s": {k: decode_s[v] for k, v in LOADER_NEW_512.items()},
              "new_512_plain_decode_s": {k: plain_decode_s[v] for k, v in LOADER_NEW_512.items()
                                         if v in plain_decode_s},
              "jpeg2000_decode_s": {k: v for k, v in decode_s.items()
                                    if k.endswith((".jp2", ".j2k"))},
              "web_plain_decode_s": {k: plain_decode_s[k] for k in LOADER_WEB_FIXTURES},
              "web_precache_s": web_precache_s,
              "web_records_per_s": len(LOADER_WEB_FIXTURES) / web_precache_s}
    if problems:
        raise RuntimeError(f"laion_loader: {problems}: {fields}")
    emit("laion_loader", **fields)
    return fields


def phase_laion_train(cache_dir: str | None = None) -> dict:
    """``experiments.conditional_diffusion_laion.run`` at the published
    recipe (``laion_diffusion_1000ep.json``), resident with graph replays,
    cut to 800 records and 2 epochs; the q_sample kernel's launches counted
    over exactly that run, train steps and val passes apart."""
    with tempfile.TemporaryDirectory() as tmp:
        config = _laion_recipe(
            num_epochs=LAION_EPOCHS, n_records=LAION_RECORDS,
            sample_every_batches=LAION_SAMPLE_EVERY, sample_every_epochs=LAION_EPOCHS,
            out_dir=os.path.join(tmp, "out"), model_save_path=os.path.join(tmp, "ckpt"),
            **_record_cache(tmp, cache_dir))
        _set_default_tf32()  # run() must turn TF32 off itself
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        result = conditional_diffusion_laion.run(config)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _launches()
        steps = result["state"].step
        split = result["qsample_launches"]
        graph = result["graph"]
        problems = []
        if torch.backends.cudnn.allow_tf32:
            problems.append("run() left cuDNN's TF32 on")
        if steps != LAION_EPOCHS * LAION_TRAIN_STEPS or not result["resident"]:
            problems.append(f"{steps} steps, resident {result['resident']}")
        if split != {"train": steps, "eval": LAION_EPOCHS * LAION_VAL_BATCHES}:
            problems.append(f"q_sample launches {split}, want {steps} train and "
                            f"{LAION_EPOCHS * LAION_VAL_BATCHES} eval")
        if launches != {**dict.fromkeys(_FLASH_KERNELS, 0), "qsample": steps + split["eval"]}:
            problems.append(f"launches {launches} against {split}")
        if graph != {"eager": GRAPH_WARMUP_STEPS, "captures": 1,
                     "replays": steps - GRAPH_WARMUP_STEPS}:
            problems.append(f"graph counts {graph}")
        train_losses = [e["train_loss"] for e in result["epochs"]]
        values = result["losses"] + train_losses + result["val_losses"]
        if not np.all(np.isfinite(values)) or not train_losses[-1] < result["losses"][0]:
            problems.append(f"losses {result['losses']}, epoch means {train_losses}, "
                            f"val {result['val_losses']}")
        # Each epoch's rate is its last update's: count = steps so far - 1.
        lrs = [e["lr"] for e in result["epochs"]]
        want_lrs = [_host_lr((e + 1) * LAION_TRAIN_STEPS - 1, config.scheduler_t_max, config.lr,
                             config.lr_min) for e in range(LAION_EPOCHS)]
        if not np.allclose(lrs, want_lrs, rtol=LAION_LR_RTOL, atol=0):
            problems.append(f"learning rates {lrs}, want {want_lrs}")
        grids = sorted(os.path.basename(p) for p in result["grids"])
        want_grids = sorted(["sampled_epoch0_batch59.png", "sampled_epoch1_batch59.png",
                             f"samples_epoch_{LAION_EPOCHS - 1}.png", "final_samples.png"])
        outputs = result["grids"] + [config.model_save_path + ext
                                     for ext in (".pt", ".npz", ".json")]
        if grids != want_grids or not all(os.path.getsize(p) > 0 for p in outputs):
            problems.append(f"grids {grids}, want {want_grids}")
        if "codec_state" not in load_sidecar(config.model_save_path)["metadata"]:
            problems.append("the checkpoint's sidecar has no codec_state")
        warm = result["epochs"][-1]
        fields = {
            "recipe": os.path.relpath(LAION_CHECKPOINT, REPO) + ".json",
            "records": LAION_RECORDS, "compute_dtype": config.compute_dtype,
            "batch": config.batch_size, "scheduler_t_max": config.scheduler_t_max,
            "epochs": LAION_EPOCHS, "steps": steps, "val_batches_per_epoch": LAION_VAL_BATCHES,
            "launches": launches, "qsample_launches": split, "graph": graph, "lrs": lrs,
            "losses": result["losses"], "train_losses": train_losses,
            "val_losses": result["val_losses"], "wall_s": wall_s,
            "data_seconds": result["data_seconds"],
            "warm_samples_per_sec": warm["samples_per_sec"],
            "warm_step_ms": 1e3 * warm["train_seconds"] / warm["steps"],
            "val_seconds": [e["val_seconds"] for e in result["epochs"]],
            "grid_seconds": [e["sample_seconds"] for e in result["epochs"]],
            "final_ddpm1000_seconds": result["final_seconds"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
    if problems:
        raise RuntimeError(f"laion_train: {problems}: {fields}")
    emit("laion_train", **fields)
    return fields


def phase_laion_parity() -> dict:
    """The resident LAION step (caption dropout, EMA, the clip and the rate
    inside the graph), graph against eager from the committed weights, with
    ``resident_parity``'s quantities and bounds, one step a call: the rate
    the step wrote on the card read after each, against the host formula
    across T_max."""
    disable_tf32()
    loaded = generate_laion.load_laion_checkpoint(LAION_CHECKPOINT, "cuda")
    b = loaded["config"].batch_size
    records = [synthesize_image(i, loaded["config"].image_size) for i in range(b * PARITY_STEPS)]
    encoder = loaded["text_encoder"]
    fields = _laion_graph_vs_eager(
        "laion_parity", loaded["codec"], np.stack([image for image, _ in records]),
        encoder.encode([caption for _, caption in records]),
        torch.from_numpy(encoder.encode([""])[0]).cuda())
    emit("laion_parity", **fields)
    return fields


def _laion_graph_vs_eager(phase: str, codec, images: np.ndarray, embeds: np.ndarray,
                          null: torch.Tensor) -> dict:
    """PARITY_STEPS LAION steps with ``codec`` from the committed weights,
    resident (graph replays) against eager and eager against itself, in
    float32 and bfloat16, one step a call; the rate each step wrote on the
    card against the host formula. Raises when graph against eager is out of
    ``_parity_bounds()`` or the rates disagree."""
    loaded = generate_laion.load_laion_checkpoint(LAION_CHECKPOINT, "cuda")
    schedule, recipe = loaded["schedule"], loaded["config"]
    b = recipe.batch_size
    lr, lr_min = recipe.lr, recipe.lr_min
    want_lrs = [_host_lr(c, LAION_PARITY_T_MAX, lr, lr_min) for c in range(PARITY_STEPS)]
    lr_atol = 0.5 * (lr - lr_min) * 2.0**-23
    fields = {"steps": PARITY_STEPS, "replayed": PARITY_STEPS - GRAPH_WARMUP_STEPS, "batch": b,
              "caption_dropout": LAION_CAPTION_DROPOUT, "scheduler_t_max": LAION_PARITY_T_MAX,
              **_parity_bounds(), "lr_rtol": LAION_LR_RTOL, "lr_atol": lr_atol,
              "lrs_host": want_lrs}
    failed = []
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        out, lrs = {}, {}
        options = dict(lr_schedule=conditional_diffusion_laion.cosine_annealing_lr(
                           lr, lr_min, LAION_PARITY_T_MAX),
                       clip_norm=recipe.clip_norm, ema_decay=PARITY_EMA_DECAY,
                       compute_dtype=dtype, caption_dropout=LAION_CAPTION_DROPOUT,
                       null_embed=null)
        for mode in ("graph", "eager", "eager_again"):
            model = generate_laion.load_laion_checkpoint(LAION_CHECKPOINT, "cuda")["model"]
            optimizer = torch.optim.Adam(model.parameters(), lr=torch.tensor(lr, device="cuda"),
                                         capturable=True)
            state = create_train_state(model, optimizer, SEED, ema=True)
            dataset = DeviceDataset(images, b, seed=SEED, device="cuda", embeds=embeds,
                                    u8_normalize=conditional_diffusion_laion.LAION_U8_NORMALIZE)
            params0, ema0 = _flat(model.parameters()), _flat(state.ema_params.values())
            idxs = dataset.epoch_index_batches(0)[:PARITY_STEPS]
            _reset_launches()
            losses, lrs[mode] = [], []
            if mode == "graph":
                resident = make_resident_laion_multi_step(codec, schedule, dataset, **options)
                for i in range(PARITY_STEPS):
                    losses.append(resident(state, idxs[i : i + 1]).item())
                    lrs[mode].append(optimizer.param_groups[0]["lr"].item())
                if resident.counts != {"eager": GRAPH_WARMUP_STEPS, "captures": 1,
                                       "replays": PARITY_STEPS - GRAPH_WARMUP_STEPS}:
                    raise RuntimeError(f"{phase}: graph counts {resident.counts}")
            else:
                step = make_laion_train_step(codec, schedule, **options)
                for row in idxs:
                    x, e = dataset.gather(torch.from_numpy(row).cuda())
                    losses.append(step(state, x.permute(0, 3, 1, 2), e).item())
                    lrs[mode].append(optimizer.param_groups[0]["lr"].item())
            torch.cuda.synchronize()
            if qsample.qsample_launches != PARITY_STEPS or state.step != PARITY_STEPS:
                raise RuntimeError(f"{phase} ({mode}): {state.step} steps, "
                                   f"{qsample.qsample_launches} q_sample launches")
            out[mode] = _parity_record(state, losses, params0, ema0)
        fields[name], ok = _parity_fields(name, out)
        gap = np.abs(np.array(lrs["graph"]) - want_lrs)
        fields[name]["lrs_graph"] = lrs["graph"]
        fields[name]["lr_max_rel"] = float((gap / np.array(want_lrs)).max())
        fields[name]["lrs_graph_equal_eager"] = lrs["graph"] == lrs["eager"]
        if not (ok and fields[name]["lrs_graph_equal_eager"]
                and np.all(gap <= lr_atol + LAION_LR_RTOL * np.array(want_lrs))):
            failed.append(name)
    fields["weights"] = os.path.relpath(LAION_CHECKPOINT, REPO)
    if failed:
        raise RuntimeError(f"{phase}: graph vs eager in {failed}: {fields}")
    return fields


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _graph_step_cost(resident, state, idxs, base: int) -> dict:
    """A captured step's cost: ms a replay by CUDA events over
    DP_TIMED_CALLS calls of ``len(idxs)`` replays each; its kernels a step
    from one profiler session over one call (taken again, up to 3 times, when
    it comes back without kernel events); the peak memory since the peak
    statistics were reset, above ``base`` bytes (what was live before the
    state was built: the state, its set, the graph's pool and the steps')."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(DP_TIMED_CALLS):
        resident(state, idxs)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (DP_TIMED_CALLS * len(idxs))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            resident(state, idxs)
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and ev.self_device_time_total > 0
                 and not getattr(ev, "is_user_annotation", False)]
        if names:
            break
    else:
        raise RuntimeError("dp: three profiler sessions without kernel events")
    return {"ms_per_step": ms, "kernels_per_step": len(names) / len(idxs),
            "nccl_kernels_per_step": sum("nccl" in n.lower() for n in names) / len(idxs),
            "peak_mib": peak}


def phase_dp() -> dict:
    """The data-parallel code path at world size 1: NCCL joined through
    ``maybe_initialize_distributed`` from torchrun's variables, the data
    axis from ``make_mesh_for_batch``; the UNet28 and MLP-UNet resident graph
    steps with ``dp`` (BN statistics and the gradient bucket all-reduced
    inside the graph) against the same steps without it, and their costs."""
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()))
    try:
        if not maybe_initialize_distributed("cuda"):
            raise RuntimeError("dp: the process group did not form")
        backend = torch.distributed.get_backend()
        dp = make_mesh_for_batch(PARITY_BATCH)
        if backend != "nccl" or dp is None or (dp.rank, dp.size) != (0, 1):
            raise RuntimeError(f"dp: backend {backend}, data axis {dp}")
        fields = {"backend": backend, "world_size": 1, "batch": PARITY_BATCH,
                  "steps": GRAPH_WARMUP_STEPS + DP_REPLAYS, "replayed": DP_REPLAYS,
                  **_parity_bounds()}
        disable_tf32()
        schedule = DiffusionSchedule.linear(1000).to("cuda")
        steps = GRAPH_WARMUP_STEPS + DP_REPLAYS
        rng = np.random.default_rng(SEED + 40)
        images = rng.integers(0, 256, (PARITY_BATCH * steps, 28, 28, 1), dtype=np.uint8)
        labels = rng.integers(0, 10, len(images))
        latent = load_latent_checkpoint(LATENT_CHECKPOINTS["mlp_unet"], device="cuda")
        families = {
            "unet28": (lambda: load_unet28(UNET_CHECKPOINT, "cuda"), None,
                       lambda ds, **o: make_resident_multi_step(schedule, ds, **o)),
            "mlp_unet": (lambda: load_latent_checkpoint(LATENT_CHECKPOINTS["mlp_unet"],
                                                        device="cuda")["model"], labels,
                         lambda ds, **o: make_resident_latent_multi_step(
                             latent["vae"], schedule, ds, **o)),
        }
        failed = []
        for name, (load_model, rows, make_step) in families.items():
            out, costs = {}, {}
            for mode, axis in (("dp", dp), ("graph", None), ("graph_again", None)):
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                state, dataset = _resident_state(images, load_model(), ema=True, labels=rows)
                params0, ema0 = _flat(state.model.parameters()), _flat(state.ema_params.values())
                idxs = dataset.epoch_index_batches(0)[:steps]
                resident = make_step(dataset, ema_decay=PARITY_EMA_DECAY,
                                     compute_dtype=torch.bfloat16, dp=axis)
                _reset_launches()
                losses = resident(state, idxs).tolist()
                torch.cuda.synchronize()
                counts = dict(resident.counts)
                if counts != {"eager": GRAPH_WARMUP_STEPS, "captures": 1, "replays": DP_REPLAYS} \
                        or qsample.qsample_launches != steps:
                    raise RuntimeError(f"dp ({name}, {mode}): graph {counts}, "
                                       f"{qsample.qsample_launches} q_sample launches")
                out[mode] = _parity_record(state, losses, params0, ema0)
                if mode != "graph_again":
                    costs[mode] = {**_graph_step_cost(resident, state, idxs, base),
                                   "qsample_launches_per_step":
                                   qsample.qsample_launches / state.step}
                del state, dataset, resident
            check, ok = _parity_fields("bfloat16", {"graph": out["dp"], "eager": out["graph"],
                                                    "eager_again": out["graph_again"]})
            check["dp_vs_graph"] = check.pop("graph_vs_eager")
            check["graph_vs_graph"] = check.pop("eager_vs_eager")
            check["losses_dp"] = check.pop("losses_graph")
            check["losses_graph"] = check.pop("losses_eager")
            fields[name] = {**check, "cost": costs, "qsample_launches_dp_run": steps}
            with_dp, without = costs["dp"], costs["graph"]
            print(f"dp: {name:<8s} step {with_dp['ms_per_step']:.4f} ms with DP, "
                  f"{without['ms_per_step']:.4f} ms without; kernels a step "
                  f"{with_dp['kernels_per_step']:.1f} / {without['kernels_per_step']:.1f}; "
                  f"peak {with_dp['peak_mib']:.0f} / {without['peak_mib']:.0f} MiB", flush=True)
            if not ok:
                failed.append(name)
        if failed:
            raise RuntimeError(f"dp: the DP graph step left the non-DP one in {failed}: {fields}")
    finally:
        destroy()
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(var, None)
    emit("dp", **fields)
    return fields


# tp: the UNet28 train step on a (data, model) = (1, 2) mesh, two processes
# on the one card over gloo, each step against the one-process step taken
# from the same state (the TP state gathered before it: params, BatchNorm
# statistics, Adam's moments, the generator). Compared step by step, not as
# two trajectories: in bfloat16 the partial input gradients are rounded
# before the reduce-scatter sums them, and two trajectories that start 1e-5
# apart part by 2.6 % in loss after four Adam steps (an H100 80GB HBM3 at 700 W).
# Adam's update barely moves when every gradient is scaled alike, so each
# step's gradients are held to the one-process step's too, leaf by leaf:
# |TP - one| / |one|, |one| floored at TP_GRAD_FLOOR of the largest leaf's
# norm (a conv bias ahead of a BatchNorm has a gradient of rounding noise).
# The bounds: in float32 the largest gap read 4e-5 (a conv weight; 1.7e-4
# with a floor of 1e-3) on an H100 80GB HBM3 at 700 W, summation order and
# cuDNN's nondeterminism; bfloat16 rounds each layer's partial input
# gradients once more (~4e-3 a rounding), and 0.1 is the relative gap at
# which a cosine falls to ~0.995. A gather that sums the head's whole
# gradient doubles every gradient above it: a gap of ~1. The one-process
# step computes each conv and dense product as the ranks do, in their output
# slices (``_shard_width_products``): cuDNN picks its algorithms by the
# problem's shape and layout, so a rank's half-width conv rounds otherwise
# than the whole one; the LatentUNet from its trained weights at B = 8
# turned that into a 4 % gradient gap and a first-update cosine of 0.9877 in
# bfloat16 against the plain one-process step, and the one-process step with
# sliced products alone does the same (PERF.md §6); in float32 the
# slices' summation orders alone parted a conv weight's gradient behind a
# BatchNorm by up to 2.2e-3. ``shard_width_reference`` reports the plain
# one-process step's gap to the sliced one.
TP_STEPS, TP_BATCH, TP_LR = 3, 128, 1e-3
TP_DTYPES = ("float32", "bfloat16")
TP_GRAD_RTOL = {"float32": 1e-3, "bfloat16": 1e-1}
TP_GRAD_FLOOR = 1e-2
# The latent denoisers that JAX's make_train_step trains, at the latent
# experiment's full width from the committed weights (time_dim 256, latent
# 20, B = 128; the MLP UNet 512 wide, the DiT of 4 heads and 4 layers at
# dropout 0.05, its masks drawn whole from the step's generator), the same
# steps and bounds as the UNet28's: every tensor of both splits two ways,
# so none is left whole. Then one DiT step with q, k and v split
# contiguously by head (whole heads to a rank, where JAX splits head_dim):
# the gradient check must catch it. And the LAION text-conditional
# LatentUNet from laion_diffusion_1000ep at its full width (time_dim 768,
# base width 32, (B, 4, 32, 32) latents, the recipe's B = 8, the hash
# encoder's (B, 768) context as y; its 4-channel head splits two ways too),
# with one float32 step whose head gather sums the loss's whole gradient
# over the axis (each rank's is whole already), which the check must catch.
TP_LATENT_MODELS = ("mlp_unet", "dit", "latent_unet")
TP_LAION_BATCH = 8


def _tp_batches() -> np.ndarray:
    rng = np.random.default_rng(SEED + 60)
    return rng.uniform(-1, 1, (TP_STEPS, TP_BATCH, 1, 28, 28)).astype(np.float32)


def _tp_latent_batches(name: str) -> list[tuple[np.ndarray, np.ndarray]]:
    """TP_STEPS batches of ``name``'s data arguments: N(0, 1) latents, as the
    VAE's, and labels; for the LatentUNet (B, 4, 32, 32) N(0, 1) latents and
    the hash encoder's contexts of synthetic captions."""
    rng = np.random.default_rng(SEED + 62)
    if name == "latent_unet":
        encoder = text_encoder.get_text_encoder("hash", 768)
        return [(rng.standard_normal((TP_LAION_BATCH, 4, 32, 32)).astype(np.float32),
                 encoder.encode([synthesize_caption(int(i))
                                 for i in rng.integers(0, 1000, TP_LAION_BATCH)]))
                for _ in range(TP_STEPS)]
    return [(rng.standard_normal((TP_BATCH, 20)).astype(np.float32),
             rng.integers(0, 10, TP_BATCH)) for _ in range(TP_STEPS)]


def _tp_latent_model(name: str):
    from tinydiffusion_torch.models.dit import DiT
    from tinydiffusion_torch.models.mlp_unet import MLPUNetLatent

    return {"dit": DiT, "mlp_unet": MLPUNetLatent, "latent_unet": LatentUNet}[name]()


def _gather_adam(optimizer, model, shardings, mesh) -> dict:
    """Each parameter's Adam state, its moments gathered whole, by name."""
    states = {n: optimizer.state[p] for n, p in model.named_parameters()
              if optimizer.state.get(p)}
    avg, sq = (mesh_lib.gather_state_dict({n: st[key] for n, st in states.items()}, shardings,
                                          mesh) for key in ("exp_avg", "exp_avg_sq"))
    return {n: {"step": st["step"].clone(), "exp_avg": avg[n], "exp_avg_sq": sq[n]}
            for n, st in states.items()}


def _grad_gap(got: dict, want: dict) -> tuple[float, str, float]:
    """The largest leaf-by-leaf gap between two sets of gradients (see
    TP_GRAD_RTOL), its leaf, and the ratio of their global norms."""
    norms = {n: want[n].double().norm().item() for n in want}
    floor = TP_GRAD_FLOOR * max(norms.values())
    gap, leaf = max(((got[n].double() - want[n].double()).norm().item() / max(norms[n], floor), n)
                    for n in want)
    ratio = _flat(got[n].double() for n in want).norm() / _flat(
        want[n].double() for n in want).norm()
    return gap, leaf, ratio.item()


class _ShardWidthProduct(torch.autograd.Function):
    """A conv's or dense's product in the one-process reference step, computed
    as the model axis's ranks compute theirs: in ``parts`` output slices, each
    on a channels-last input where the ranks read a gathered one (every input
    the model made, not the data), concatenated; backward, each slice's
    weight gradient, and the input gradient as the sum of the slices'
    partials (in float32 for a low-precision product, as the ranks'
    ``apply_full`` sums them). cuDNN picks its algorithms by the problem's
    shape and layout, and its sums round by them: a 64-channel 32 x 32
    bfloat16 conv at half width rounds 1.8e-4 of its outputs one ulp apart
    from the whole one (an H100 80GB HBM3 at 700 W), which a trained model
    at a small batch amplifies into its gradients. The slices are the
    plain model's products: no gather, scatter or rule of the model axis
    runs here."""

    @staticmethod
    def forward(ctx, x, weight, product, parts, dim):
        if x.dim() == 4 and x.requires_grad:
            x = x.contiguous(memory_format=torch.channels_last)
        ctx.save_for_backward(x, weight)
        ctx.product, ctx.parts, ctx.dim = product, parts, dim
        return torch.cat([product(x, w) for w in weight.chunk(parts, 0)], dim)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        product, needs_x, needs_w = ctx.product, *ctx.needs_input_grad[:2]
        low = x.dtype != torch.float32
        dx, dws = None, []
        for w, g in zip(weight.chunk(ctx.parts, 0), grad.chunk(ctx.parts, ctx.dim)):
            with torch.enable_grad():
                if needs_w:
                    leaf = w.detach().requires_grad_()
                    dws.append(torch.autograd.grad(product(x.detach(), leaf), leaf, g)[0])
                if needs_x:
                    xs = (x.detach().float() if low else x.detach()).requires_grad_()
                    out = product(xs, w.detach().float() if low else w.detach())
                    part = torch.autograd.grad(out, xs, g.float() if low else g)[0]
                    dx = part if dx is None else dx + part
        return (dx.to(x.dtype) if needs_x else None, torch.cat(dws, 0) if needs_w else None,
                None, None, None)


@contextlib.contextmanager
def _shard_width_products(parts: int):
    """Every ``nn.layers`` conv and dense product of the block as the model
    axis's ``parts`` ranks compute it (``_ShardWidthProduct``), where
    ``parts`` divides the layer's outputs, as ``infer_state_sharding`` splits
    them; the whole product elsewhere, as the ranks compute a layer left
    whole."""
    from tinydiffusion_torch.nn import layers

    saved = {cls: cls.__dict__["product"] for cls in (layers.Conv2d, layers.Linear)}
    conv_product, linear_product = layers.Conv2d.product, layers.Linear.product

    def sliced(product, x, w, dim):
        if w.shape[0] % parts:
            return product(x, w)
        return _ShardWidthProduct.apply(x, w, product, parts, dim)

    layers.Conv2d.product = lambda self, x, w: sliced(functools.partial(conv_product, self), x, w,
                                                      1)
    layers.Linear.product = staticmethod(lambda x, w: sliced(linear_product, x, w, -1))
    try:
        yield
    finally:
        for cls, product in saved.items():
            setattr(cls, "product", product)


def _shard_width_gap(name: str, dtype: str) -> dict:
    """One Adam step of ``name`` in one process from its committed weights on
    the first of its tp batches, its products in two ranks' slices
    (``_shard_width_products``) against the plain step: the loss's gap, the
    update's cosine and the gradients' gap (``_grad_gap``), cuDNN
    deterministic as in ``_tp_rank``."""
    disable_tf32()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _shard_width_runs(name, dtype)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _shard_width_runs(name: str, dtype: str) -> dict:
    schedule = DiffusionSchedule.linear(1000).to("cuda")
    path = LAION_CHECKPOINT if name == "latent_unet" else LATENT_CHECKPOINTS[name]
    whole = state_dict_by_name(load_weights_arrays(path))
    args = tuple(torch.from_numpy(a).cuda() for a in _tp_latent_batches(name)[0])
    runs = []
    for widths in (contextlib.nullcontext(), _shard_width_products(2)):
        model = _tp_latent_model(name).cuda()
        model.load_state_dict(whole)
        state = create_train_state(model, torch.optim.Adam(model.parameters(), lr=TP_LR), SEED)
        step = make_train_step(schedule, compute_dtype=getattr(torch, dtype), conditional=True)
        params0 = _flat(model.parameters()).clone()
        with widths:
            loss = step(state, *args).item()
        runs.append((loss, {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                     (_flat(model.parameters()) - params0).double()))
    (plain_loss, plain_grads, plain_update), (loss, grads, update) = runs
    gap, leaf, _ = _grad_gap(grads, plain_grads)
    return {"loss_rel": abs(loss - plain_loss) / abs(plain_loss),
            "update_cos": _cos(update, plain_update), "grad_gap": gap, "grad_gap_leaf": leaf}


def _tp_new_record() -> dict:
    return {"losses": [], "ref_losses": [], "update_cos": [], "grad_gap": [],
            "grad_gap_leaf": [], "grad_norm_ratio": [], "tp_ms": [], "ref_ms": [],
            "qsample_launches": 0}


def _tp_run(rank: int, mesh, schedule, make_model, whole: dict, dtype: str, batches: list,
            conditional: bool = False, planted=None) -> dict:
    """One model's TP steps in ``dtype`` (one a batch of ``batches``, each a
    tuple of the step's data arguments on the card), each against the
    one-process step on rank 0 from the same gathered state; then, with
    ``planted`` (a context manager), one more step on the first batch with
    it active, recorded as ``planted``."""
    compute_dtype = getattr(torch, dtype)
    model = make_model().cuda()
    shardings = mesh_lib.infer_state_sharding(model, mesh)
    mesh_lib.apply_sharding(model, shardings, mesh, state_dict=whole)
    state = create_train_state(model, torch.optim.Adam(model.parameters(), lr=TP_LR), SEED)
    step = make_train_step(schedule, compute_dtype=compute_dtype, mesh=mesh,
                           conditional=conditional)
    ref = make_model().cuda() if rank == 0 else None
    if ref is not None:
        ref_state = create_train_state(ref, torch.optim.Adam(ref.parameters(), lr=TP_LR), SEED)
        ref_step = make_train_step(schedule, compute_dtype=compute_dtype, conditional=conditional)
        names = [n for n, _ in ref.named_parameters()]

    def compared_step(args: tuple, into: dict) -> None:
        """One TP step and, on rank 0, the one-process step from the same
        gathered state: losses, ms, the update's cosine and the gradients'
        gap and norm ratio appended to ``into``."""
        before = mesh_lib.gather_state_dict(model.state_dict(), shardings, mesh)
        adam = _gather_adam(state.optimizer, model, shardings, mesh)
        if ref is not None:
            ref.load_state_dict(before)
            for name, p in ref.named_parameters():
                if name in adam:
                    ref_state.optimizer.state[p] = adam[name]
            ref_state.generator.set_state(state.generator.get_state())
            params0 = _flat(before[n] for n in names)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _shard_width_products(mesh.model.size):
                into["ref_losses"].append(ref_step(ref_state, *args).item())
            into["ref_ms"].append((time.perf_counter() - t0) * 1e3)
            ref_update = (_flat(ref.parameters()) - params0).double()
            ref_grads = {n: p.grad for n, p in ref.named_parameters()}
        torch.distributed.barrier()
        launched = qsample.qsample_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        into["losses"].append(step(state, *args).item())
        into["tp_ms"].append((time.perf_counter() - t0) * 1e3)
        into["qsample_launches"] += qsample.qsample_launches - launched
        after = mesh_lib.gather_state_dict(model.state_dict(), shardings, mesh)
        grads = mesh_lib.gather_state_dict(
            {n: p.grad for n, p in model.named_parameters()}, shardings, mesh)
        if ref is not None:
            update = (_flat(after[n] for n in names) - params0).double()
            into["update_cos"].append(_cos(update, ref_update))
            gap, leaf, ratio = _grad_gap(grads, ref_grads)
            into["grad_gap"].append(gap)
            into["grad_gap_leaf"].append(leaf)
            into["grad_norm_ratio"].append(ratio)

    record = _tp_new_record()
    for args in batches:
        compared_step(args, record)
    record.update(
        shapes={k: tuple(v.shape) for k, v in model.state_dict().items()},
        sharded=sorted(k for k, d in shardings.items() if d is not None),
        replicated={k: v.detach().cpu() for k, v in model.state_dict().items()
                    if shardings[k] is None})
    if planted is not None:
        record["planted"] = _tp_new_record()
        with planted():
            compared_step(batches[0], record["planted"])
    return record


@contextlib.contextmanager
def _planted_sum():
    """Every consumer taken as sharded: the head's gather then sums its
    whole gradient over the model axis."""
    keep = mesh_lib.out_sharded
    mesh_lib.out_sharded = lambda layer: True
    try:
        yield
    finally:
        mesh_lib.out_sharded = keep


@contextlib.contextmanager
def _planted_laion_head_sum():
    """The LatentUNet's head gathered with a backward that sums the loss's
    whole gradient over the model axis (as for a sharded consumer), where
    each rank's is already whole: every gradient above the head doubles."""
    from tinydiffusion_torch.models import unet_latent

    def summed(mp, layer, y):
        if mp is None:  # the one-process reference step
            return y
        return mesh_lib._ToFull.apply(mp, True, False, 1, 1, y)

    keep = unet_latent.gather_output
    unet_latent.gather_output = summed
    try:
        yield
    finally:
        unet_latent.gather_output = keep


@contextlib.contextmanager
def _planted_head_split():
    """The sharding rule with no head split: q, k and v cut contiguously."""
    keep = mesh_lib._heads
    mesh_lib._heads = lambda modules, owner: None
    try:
        yield
    finally:
        mesh_lib._heads = keep


def _tp_rank(rank: int, tmp: str) -> None:
    """One rank of the tp phase: gloo over a file rendezvous, the (1, 2) mesh,
    the full-width UNet28 sharded from the whole init, TP_STEPS eager Adam
    steps in each dtype (``_tp_run``), then the MLP UNet and the DiT on
    latents. Before each step the state is gathered whole, and rank 0 takes
    the one-process step from it on a whole model of its own; after it, the
    TP gradients are gathered whole beside that step's. In float32 one more
    UNet28 step runs with every consumer taken as sharded (the head's
    gather then sums its whole gradient over the axis), and one DiT step
    with q, k and v split by head, which the gradient check must catch.
    Results to ``tmp/tp_rank<rank>.pt``."""
    torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                                         rank=rank, world_size=2)
    try:
        disable_tf32()
        # cuDNN's nondeterministic convolution algorithms add in an order of
        # their own at each call: two float32 LatentUNet steps from one state
        # parted by up to 1.6e-3 in a conv weight's gradient behind a
        # BatchNorm, where the TP and one-process steps otherwise agree to
        # ~5e-6. Both steps here run cuDNN deterministic.
        torch.backends.cudnn.deterministic = True
        mesh = mesh_lib.make_mesh(("data", "model"), (1, 2))
        schedule = DiffusionSchedule.linear(1000).to("cuda")
        whole = torch.load(os.path.join(tmp, "init.pt"))
        batches = [(b,) for b in torch.from_numpy(_tp_batches()).cuda()]
        out = {"place": (mesh.data.rank, mesh.data.size, mesh.model.rank, mesh.model.size)}
        for dtype in TP_DTYPES:
            record = _tp_run(rank, mesh, schedule, UNet28, whole, dtype, batches,
                             planted=_planted_sum if dtype == "float32" else None)
            if "planted" in record:
                record["planted_sum"] = record.pop("planted")
            out[dtype] = record
            torch.cuda.empty_cache()
        latent_start = time.perf_counter()
        for name in TP_LATENT_MODELS:
            start = time.perf_counter()
            latent_batches = [(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
                              for x, y in _tp_latent_batches(name)]
            whole = torch.load(os.path.join(tmp, f"{name}.pt"))
            make_model = functools.partial(_tp_latent_model, name)
            planted = _planted_laion_head_sum if name == "latent_unet" else None
            out[name] = {dtype: _tp_run(rank, mesh, schedule, make_model, whole, dtype,
                                        latent_batches, conditional=True,
                                        planted=planted if dtype == "float32" else None)
                         for dtype in TP_DTYPES}
            if name == "dit":
                with _planted_head_split():
                    out["planted_heads"] = _tp_run(rank, mesh, schedule, make_model, whole,
                                                   "float32", latent_batches[:1],
                                                   conditional=True)
            torch.cuda.empty_cache()
            out[f"{name}_s"] = time.perf_counter() - start
        out["latent_s"] = time.perf_counter() - latent_start
        torch.save(out, os.path.join(tmp, f"tp_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _tp_summary(got: dict, other: dict) -> dict:
    """The fields of one model's run in one dtype, from both ranks' records."""
    same_keys = set(got["replicated"]) == set(other["replicated"])
    return {"losses": got["losses"], "one_process_losses": got["ref_losses"],
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], got["ref_losses"])),
            "update_cos": got["update_cos"], "grad_gap": got["grad_gap"],
            "grad_gap_leaf": got["grad_gap_leaf"], "grad_norm_ratio": got["grad_norm_ratio"],
            "ms_per_step": float(np.mean(got["tp_ms"][1:])),
            "one_process_ms_per_step": float(np.mean(got["ref_ms"][1:])),
            "qsample_launches": [got["qsample_launches"], other["qsample_launches"]],
            "sharded_tensors": len(got["sharded"]),
            "whole_tensors": len(got["shapes"]) - len(got["sharded"]),
            "ranks_agree": got["losses"] == other["losses"],
            "replicated_rank_gap": max(
                ((got["replicated"][k].double() - other["replicated"][k].double()).abs().max()
                 .item() for k in got["replicated"]), default=0.0) if same_keys else None}


def _tp_problems(dtype: str, out: dict) -> bool:
    return (out["loss_rel"] > PARITY_LOSS_RTOL[dtype]
            or min(out["update_cos"]) < PARITY_MIN_UPDATE_COS[dtype]
            or max(out["grad_gap"]) > TP_GRAD_RTOL[dtype]
            or not out["ranks_agree"]
            or out["replicated_rank_gap"] != 0.0
            or out["qsample_launches"] != [TP_STEPS, TP_STEPS])


def _tp_print(name: str, dtype: str, out: dict) -> None:
    print(f"tp: {name:<8s} {dtype:<8s} (1, 2) step {out['ms_per_step']:.2f} ms (gloo, two "
          f"processes on one card) vs {out['one_process_ms_per_step']:.2f} ms in one process; "
          f"loss rel {out['loss_rel']:.2e}, update cos {min(out['update_cos']):.6f}, grad gap "
          f"{max(out['grad_gap']):.2e}, replicated gap {out['replicated_rank_gap']}", flush=True)


def _tp_planted(record: dict) -> dict:
    return {"loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(record["losses"], record["ref_losses"])),
            "update_cos": record["update_cos"], "grad_gap": record["grad_gap"],
            "grad_norm_ratio": record["grad_norm_ratio"]}


def phase_tp() -> dict:
    """The model axis: the full-width UNet28 (base width 64, time_dim 256,
    B = 128) at (data, model) = (1, 2), two processes spawned on the one card
    (``torch.multiprocessing``) over gloo with CUDA tensors, TP_STEPS eager
    Adam steps in float32 and in bfloat16 with the q_sample kernel; then the
    MLP UNet and the DiT the same way on (B, 20) latents, and the LAION
    LatentUNet on (8, 4, 32, 32) latents with their (8, 768) contexts
    (TP_LATENT_MODELS).
    Each step against the one-process step from the same gathered state, on
    rank 0: the loss and the update's cosine within resident_parity's
    bounds, the gradients within TP_GRAD_RTOL leaf by leaf; each rank's
    shards half the whole shapes (the UNet28's head whole), every tensor
    left whole bit-equal on both ranks, TP_STEPS q_sample launches a rank,
    the one-process step's products computed in the ranks' slices (see
    TP_STEPS; the LatentUNet's one-process step so against the plain one
    beside, ``shard_width_reference``, reported, not bounded),
    the TP step's ms beside the one-process step's (the first step, the
    warm-up, left out); and the float32 UNet28 and LatentUNet steps with the
    head's gather summing its whole gradient, and the DiT step with q, k and
    v split by head, caught by the gradient check. NCCL takes no two ranks on one
    device, so the collectives here are gloo's, through the host: the ms
    are not what NCCL between cards would give."""
    import torch.multiprocessing as tmp_mp

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 61)
        init = UNet28().state_dict()
    reference = {dtype: _shard_width_gap("latent_unet", dtype) for dtype in TP_DTYPES}
    for dtype, gap in reference.items():
        print(f"tp: latent_unet {dtype} one-process step at the shard widths vs plain: loss rel "
              f"{gap['loss_rel']:.2e}, update cos {gap['update_cos']:.6f}, grad gap "
              f"{gap['grad_gap']:.2e} ({gap['grad_gap_leaf']})", flush=True)
    fields = {"mesh": [1, 2], "backend": "gloo", "batch": TP_BATCH, "steps": TP_STEPS,
              "shard_width_reference": reference,
              "bounds": {"loss_rtol": PARITY_LOSS_RTOL, "min_update_cos": PARITY_MIN_UPDATE_COS,
                         "grad_rtol": TP_GRAD_RTOL, "grad_floor": TP_GRAD_FLOOR}}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(init, os.path.join(tmp, "init.pt"))
        latent_init = {}
        for name in TP_LATENT_MODELS:
            path = LAION_CHECKPOINT if name == "latent_unet" else LATENT_CHECKPOINTS[name]
            latent_init[name] = state_dict_by_name(load_weights_arrays(path))
            torch.save(latent_init[name], os.path.join(tmp, f"{name}.pt"))
        t0 = time.perf_counter()
        tmp_mp.start_processes(_tp_rank, args=(tmp,), nprocs=2, start_method="spawn")
        fields["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt")) for r in range(2)]
    # The latent models' share of the ranks' seconds (rank 0 also runs the
    # one-process steps), and each model's.
    fields["latent_s"] = ranks[0]["latent_s"]
    fields["model_s"] = {name: ranks[0][f"{name}_s"] for name in TP_LATENT_MODELS}
    problems = []
    if [r["place"] for r in ranks] != [(0, 1, 0, 2), (0, 1, 1, 2)]:
        problems.append(f"places {[r['place'] for r in ranks]}")

    for dtype in TP_DTYPES:
        got, other = ranks[0][dtype], ranks[1][dtype]
        half = all(got["shapes"][k][d] * 2 == init[k].shape[d] for k in got["sharded"]
                   for d in [1 if k == "class_embedding.weight" else 0])
        head_whole = (not any(k.startswith("final_conv.") for k in got["sharded"])
                      and got["shapes"]["final_conv.weight"] == tuple(
                          init["final_conv.weight"].shape))
        out = dict(_tp_summary(got, other), shards_half=half, head_whole=head_whole,
                   whole_tensors=len(init) - len(got["sharded"]))
        fields[dtype] = out
        if _tp_problems(dtype, out) or not (half and head_whole):
            problems.append(f"{dtype}: {out}")
        _tp_print("unet28", dtype, out)
    for name in TP_LATENT_MODELS:
        fields[name] = {}
        for dtype in TP_DTYPES:
            got, other = ranks[0][name][dtype], ranks[1][name][dtype]
            whole = latent_init[name]
            # Every float tensor of the three models splits two ways: a rank
            # holds half of each (a head split's too, on its torch dimension
            # 0); only the LatentUNet's BatchNorm counters stay whole.
            half = (set(got["sharded"]) == {k for k, v in whole.items() if v.is_floating_point()}
                    and all(2 * np.prod(got["shapes"][k]) == whole[k].numel()
                            for k in got["sharded"]))
            out = dict(_tp_summary(got, other), shards_half=bool(half))
            fields[name][dtype] = out
            if _tp_problems(dtype, out) or not half:
                problems.append(f"{name} {dtype}: {out}")
            _tp_print(name, dtype, out)
    for key, record, what in (("planted_sum", ranks[0]["float32"]["planted_sum"],
                               "a gather that sums the head's whole gradient"),
                              ("planted_heads", ranks[0]["planted_heads"],
                               "q, k and v split by head"),
                              ("planted_laion_head", ranks[0]["latent_unet"]["float32"]["planted"],
                               "a LatentUNet head gather that sums the whole gradient")):
        fields[key] = _tp_planted(record)
        if record["grad_gap"][0] <= TP_GRAD_RTOL["float32"]:
            problems.append(f"the gradient check missed {what}: {fields[key]}")
        print(f"tp: {key}: grad gap {record['grad_gap'][0]:.3f}, norm ratio "
              f"{record['grad_norm_ratio'][0]:.4f}, update cos {record['update_cos'][0]:.6f}, "
              f"loss rel {fields[key]['loss_rel']:.2e}", flush=True)
    if problems:
        raise RuntimeError(f"tp: {problems}: {fields}")
    emit("tp", **fields)
    return fields


def _laion_serve_chains() -> dict:
    """DDIM-10 on the four prompts from one x_init, decoded images: the card
    against the CPU with the float32 forward (both TF32-free), and the
    card's bfloat16 forward (the sidecar's) against the CPU's float32."""
    prompts = conditional_diffusion_laion.SAMPLE_PROMPTS
    x_init = torch.from_numpy(np.random.default_rng(SEED + 31).standard_normal(
        (len(prompts), 4, 32, 32)).astype(np.float32))
    images = {}
    for dev, compute_dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                               ("cuda", torch.bfloat16)):
        loaded = generate_laion.load_laion_checkpoint(LAION_CHECKPOINT, dev)
        embeds = torch.from_numpy(loaded["text_encoder"].encode(prompts)).to(dev)
        sampler = conditional_diffusion_laion.make_laion_sampler(
            loaded["model"], loaded["schedule"], loaded["codec"], len(prompts), 32, 4,
            compute_dtype=compute_dtype, method="ddim", sample_steps=10)
        images[(dev, compute_dtype)] = sampler(None, embeds, x_init=x_init.to(dev)).cpu()
    ref = images[("cpu", torch.float32)]
    f32 = (images[("cuda", torch.float32)] - ref).abs()
    bf16 = (images[("cuda", torch.bfloat16)] - ref).abs()
    return {"f32_max_abs": f32.max().item(), "bf16_max_abs": bf16.max().item(),
            "bf16_mean_abs": bf16.mean().item(), "range": [ref.min().item(), ref.max().item()]}


def _laion_guided(tmp: str, cache_dir: str | None = None) -> dict:
    """A checkpoint trained for a few steps at the recipe with caption
    dropout 0.1, served with guidance 2 (DDIM-50): the guided grid against
    the same request at guidance 1."""
    config = _laion_recipe(
        num_epochs=1, n_records=LAION_GUIDED_RECORDS, max_steps_per_epoch=LAION_GUIDED_STEPS,
        caption_dropout=0.1, guidance_scale=2.0, sample_every_batches=0,
        sample_every_epoch=False, out_dir=os.path.join(tmp, "guided"),
        model_save_path=os.path.join(tmp, "guided", "ckpt"), **_record_cache(tmp, cache_dir))
    trained = conditional_diffusion_laion.run(config)
    argv = ["--checkpoint", config.model_save_path, "--device", "cuda", "--sampler", "ddim",
            "--sample-steps", "50", "--out", os.path.join(tmp, "guided.png")]
    generate_laion.main(argv + ["--guidance-scale", "2.0"])  # cold
    guided = generate_laion.main(argv + ["--guidance-scale", "2.0"])
    plain = generate_laion.main(argv)
    images = guided["images"]
    return {"train_steps": trained["state"].step, "qsample_launches": trained["qsample_launches"],
            "forwards": guided["forwards"], "warm_s": guided["sample_seconds"],
            "ms_per_forward": 1e3 * guided["sample_seconds"] / guided["forwards"],
            "ok": bool(guided["forwards"] == 50 and tuple(images.shape) == (4, 3, 256, 256)
                       and torch.isfinite(images).all()
                       and not torch.equal(images, plain["images"])),
            "mean_abs_vs_unguided": (images - plain["images"]).abs().mean().item()}


def phase_laion_serve(cache_dir: str | None = None) -> dict:
    """``generate_laion.main`` on the committed checkpoint (the four
    prompts, bf16 forward, fp32 chain): each request twice, the warm latency
    and model forwards; DDIM-10 chains card against CPU; then a guided
    checkpoint trained for a few steps and served with guidance 2."""
    fields = {"checkpoint": os.path.relpath(LAION_CHECKPOINT, REPO),
              "prompts": conditional_diffusion_laion.SAMPLE_PROMPTS, "requests": {}}
    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        for name, (flags, forwards) in LAION_SERVE_REQUESTS.items():
            argv = ["--checkpoint", LAION_CHECKPOINT, "--device", "cuda", *flags,
                    "--out", os.path.join(tmp, f"{name}.png")]
            generate_laion.main(argv)  # cold
            result = generate_laion.main(argv)
            images = result["images"]
            if not (tuple(images.shape) == (4, 3, 256, 256) and torch.isfinite(images).all()
                    and images.min() >= 0 and images.max() <= 1):
                problems.append(f"{name}: images {tuple(images.shape)}")
            if result["forwards"] != forwards:
                problems.append(f"{name}: {result['forwards']} forwards")
            fields["requests"][name] = {"warm_s": result["sample_seconds"],
                                        "forwards": result["forwards"],
                                        "ms_per_forward": 1e3 * result["sample_seconds"]
                                        / result["forwards"],
                                        "captures": result["captures"],
                                        "replays": result["replays"]}
        chains = _laion_serve_chains()
        if not (chains["f32_max_abs"] <= LAION_SERVE_F32_ATOL
                and chains["bf16_mean_abs"] <= LAION_SERVE_BF16_MEAN_ABS):
            problems.append(f"DDIM-10 card vs CPU: {chains}")
        fields["chains"] = chains
        if any(_launches().values()):
            problems.append(f"LAION serving launched a hand-written kernel: {_launches()}")
        fields["guided"] = _laion_guided(tmp, cache_dir)
        if not fields["guided"]["ok"]:
            problems.append(f"guided checkpoint: {fields['guided']}")
    fields.update(f32_atol=LAION_SERVE_F32_ATOL, bf16_mean_abs_bound=LAION_SERVE_BF16_MEAN_ABS)
    if problems:
        raise RuntimeError(f"laion_serve: {problems}: {fields}")
    emit("laion_serve", **fields)
    return fields


def phase_fid_mnist(data_root: str) -> dict:
    """``tools/fid_eval.py`` on the card at n = 512: every committed MNIST
    checkpoint's rows beside JAX's CPU rows (``FID_JAX_FIXTURE``), the calibration rows and
    512 test images' features against the port's CPU run, the seconds to
    featurize the 10 000 test images and to sample each row, and the spread
    of one row over two seeds."""
    base = ["--n", str(FID_N), "--sample-batch", str(FID_SAMPLE_BATCH), "--data-root", data_root,
            "--device", "cuda"]
    rows, problems = [], []
    _reset_launches()
    calibration = featurize_s = None
    for name, variants, scale, jax_fid, jax_acc in FID_MNIST_ROWS:
        result = fid_eval.main(["--checkpoint", os.path.join("checkpoints", name), "--variants",
                                variants, "--guidance-scale", str(scale), *base])
        calibration = calibration or {r["variant"]: r["fid"] for r in result["rows"][:2]}
        featurize_s = featurize_s or result["featurize_real_s"]
        for row in result["rows"][2:]:
            want = jax_fid[row["variant"]]
            entry = {"checkpoint": name, "variant": row["variant"], "guidance_scale": scale,
                     "fid": row["fid"], "jax_fid": want, "ratio": row["fid"] / want,
                     "sample_s": result["sample_s"][row["variant"]]}
            if "label_acc" in row:
                entry.update(label_acc=row["label_acc"], jax_label_acc=jax_acc)
                if jax_acc >= FID_LABEL_ACC_FLOORED and row["label_acc"] < FID_MIN_LABEL_ACC:
                    problems.append(f"{name} {row['variant']} s={scale}: label_acc "
                                    f"{row['label_acc']}")
            if not (np.isfinite(row["fid"]) and row["fid"] <= FID_MAX_RATIO * want):
                problems.append(f"{name} {row['variant']} s={scale}: FID {row['fid']} vs "
                                f"JAX's {want}")
            rows.append(entry)
            print(f"fid_mnist: {name:<28s} {row['variant']:<8s} s={scale:<4} FID "
                  f"{row['fid']:9.3f}  (JAX on the CPU {want:8.3f})"
                  + (f"  label-acc {row['label_acc']:.4f} (JAX {jax_acc})"
                     if "label_acc" in row else ""), flush=True)
    if any(_launches().values()):
        problems.append(f"the MNIST FID path launched a hand-written kernel: {_launches()}")
    # The seed spread of the first row.
    name, variants = FID_MNIST_ROWS[0][0], FID_MNIST_ROWS[0][1].split(",")[0]
    again = fid_eval.main(["--checkpoint", os.path.join("checkpoints", name), "--variants",
                           variants, "--seed", str(FID_SPREAD_SEED), *base])
    fid0, fid1 = rows[0]["fid"], again["rows"][2]["fid"]
    jax_fid1 = FID_JAX["spread_row"]["fid"]
    spread = {"checkpoint": name, "variant": variants,
              "fid_by_seed": {"0": fid0, str(FID_SPREAD_SEED): fid1},
              "jax_fid_by_seed": {"0": FID_MNIST_ROWS[0][3][variants],
                                  str(FID_SPREAD_SEED): jax_fid1},
              "rel_spread": abs(fid0 - fid1) / fid0}
    if not (np.isfinite(fid1) and fid1 <= FID_MAX_RATIO * jax_fid1):
        problems.append(f"{name} {variants} seed {FID_SPREAD_SEED}: FID {fid1} vs JAX's "
                        f"{jax_fid1}")
    # The port's CPU rows: the same calibration images, and 512 test images' features.
    cpu = fid_eval.main(["--checkpoint", os.path.join("checkpoints", name), "--variants", "",
                         *base, "--device", "cpu"])  # the last --device counts
    cpu_calibration = {r["variant"]: r["fid"] for r in cpu["rows"]}
    cal_gap = max(abs(calibration[k] - v) / v for k, v in cpu_calibration.items())
    if not cal_gap <= FID_CARD_VS_CPU_RTOL:
        problems.append(f"calibration card {calibration} vs CPU {cpu_calibration}")
    x_test, _ = load_mnist(data_root, train=False)
    feats = {dev: featurize(load_feature_net(os.path.join("checkpoints", "fid_classifier"),
                                             FeatureNet()).to(dev).eval(), x_test[:FID_N])
             for dev in ("cuda", "cpu")}
    feature_gap = np.abs(feats["cuda"] - feats["cpu"]).max() / np.abs(feats["cpu"]).max()
    if not feature_gap <= FID_FEATURE_RTOL:
        problems.append(f"features card vs CPU {feature_gap}")
    fields = {"n": FID_N, "sample_batch": FID_SAMPLE_BATCH, "rows": rows,
              "calibration": calibration, "calibration_cpu": cpu_calibration,
              "calibration_jax": FID_JAX_CALIBRATION, "calibration_card_vs_cpu_rel": cal_gap,
              "features_card_vs_cpu_rel": float(feature_gap), "featurize_10000_s": featurize_s,
              "seed_spread": spread, "max_ratio": FID_MAX_RATIO,
              "card_vs_cpu_rtol": FID_CARD_VS_CPU_RTOL, "feature_rtol": FID_FEATURE_RTOL}
    if problems:
        raise RuntimeError(f"fid_mnist: {problems}: {fields}")
    emit("fid_mnist", **fields)
    return fields


def _plain_attention(model) -> None:
    """Every attention site of a conv-VAE on its plain version."""
    for module in model.modules():
        if hasattr(module, "use_flash"):
            module.use_flash = False


def phase_fid_laion() -> dict:
    """``tools/fid_eval_laion.py`` on the card at n = 512: the calibration
    rows, ``vae_recon`` and ``vae_prior_decode`` on ``vae_laion_best`` (the
    flash forward at B = 32, launches counted over exactly that run) and
    ``samples_dir[256]`` on DDIM-50 dumps of ``laion_diffusion_1000ep``,
    beside JAX's; the calibration rows against the port's CPU run; the kernel
    against its plain version on vae_recon's first 32 images; and
    ``train_feature_net`` once on the card."""
    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        t0 = time.perf_counter()
        generate_laion.main(["--checkpoint", LAION_CHECKPOINT, "--device", "cuda",
                             "--sampler", "ddim", "--sample-steps", "50", "--dump-dir", dump,
                             "--repeat", str(FID_LAION_REPEAT),
                             "--out", os.path.join(tmp, "grid.png")])
        dump_s = time.perf_counter() - t0
        argv = ["--n", str(FID_N), "--batch", str(FID_LAION_BATCH), "--samples-dir", dump]
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = fid_eval_laion.main(argv + ["--device", "cuda"])
        tool_s = time.perf_counter() - t0
        launches = _launches()
        # The calibration rows on the CPU (no VAE there: its plain attention
        # at B = 32 would take 34 GB).
        cpu = fid_eval_laion.main(argv[:4] + ["--vae-checkpoint", os.path.join(tmp, "none"),
                                              "--device", "cpu"])
    if launches != {**{k: 0 for k in launches}, "flash_fwd": FID_LAION_FLASH_LAUNCHES}:
        problems.append(f"launches {launches}, want {FID_LAION_FLASH_LAUNCHES} flash_fwd")
    calibration = [k for k in FID_LAION_JAX if k.startswith("calibration")]
    cal_gap = max(abs(rows[k] - cpu[k]) / cpu[k] for k in calibration)
    if not cal_gap <= FID_CARD_VS_CPU_RTOL:
        problems.append(f"calibration card vs CPU: {rows} vs {cpu}")
    for key, want in FID_LAION_JAX.items():
        if key not in rows or not rows[key] <= FID_MAX_RATIO * want:
            problems.append(f"{key}: {rows.get(key)} vs JAX's {want}")
        print(f"fid_laion: {key:<36s} {rows.get(key)}  (JAX on the CPU {want})", flush=True)

    # The kernel against its plain version on vae_recon's first 32 images.
    models = {"flash": load_conv_vae(CHECKPOINT, device="cuda"),
              "plain": load_conv_vae(CHECKPOINT, device="cuda")}
    _plain_attention(models["plain"])
    real = fid_eval_laion.synth_set(FID_N, 256)[0]
    clf = load_feature_net(os.path.join("checkpoints", "fid_classifier_rgb256"), FeatureNet(
        num_classes=4, channels=fid_eval_laion.rgb_channels(256), in_channels=3,
        image_size=256)).to("cuda").eval()
    real_stats = frechet_gaussian_stats(featurize(clf, fid_eval_laion.to_m1(real), 32))
    recon = {k: fid_eval_laion.vae_images(m, real[:FID_KERNEL_IMAGES], FID_KERNEL_BATCH, SEED)[0]
             for k, m in models.items()}
    image_gap = float(np.abs(recon["flash"] - recon["plain"]).max())
    kernel_fid = {k: fid_from_stats(*real_stats, *frechet_gaussian_stats(featurize(clf, v, 32)))
                  for k, v in recon.items()}
    fid_gap = abs(kernel_fid["flash"] - kernel_fid["plain"]) / kernel_fid["plain"]
    if not (image_gap <= FID_KERNEL_IMAGE_ATOL and fid_gap <= FID_KERNEL_FID_RTOL):
        problems.append(f"flash vs plain vae_recon: images {image_gap}, FIDs {kernel_fid}")
    del models, recon
    torch.cuda.empty_cache()

    # train_feature_net once on the card: 1 epoch, saved and read back.
    x_tr, y_tr = fid_eval_laion.synth_set(FID_TRAIN_IMAGES, 256)
    x_te, y_te = fid_eval_laion.synth_set(FID_TRAIN_IMAGES, 256, offset=FID_TRAIN_IMAGES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = train_feature_net(fid_eval_laion.to_m1(x_tr), y_tr, epochs=1,
                            batch_size=FID_LAION_BATCH, num_classes=4,
                            channels=fid_eval_laion.rgb_channels(256), device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        save_feature_net(os.path.join(tmp, "clf"), net, {"num_classes": 4}, {})
        back = load_feature_net(os.path.join(tmp, "clf"), FeatureNet(
            num_classes=4, channels=fid_eval_laion.rgb_channels(256), in_channels=3,
            image_size=256)).to("cuda").eval()
    trained = {"accuracy": classifier_accuracy(net, fid_eval_laion.to_m1(x_te), y_te, 32),
               "accuracy_read_back": classifier_accuracy(back, fid_eval_laion.to_m1(x_te),
                                                         y_te, 32),
               "train_s": train_s, "images": FID_TRAIN_IMAGES, "epochs": 1}
    if not np.isfinite(trained["accuracy"]):
        problems.append(f"train_feature_net: {trained}")
    fields = {"n": FID_N, "batch": FID_LAION_BATCH, "rows": rows, "rows_jax": FID_LAION_JAX,
              "calibration_cpu": {k: cpu[k] for k in calibration},
              "calibration_card_vs_cpu_rel": cal_gap, "launches": launches,
              "dump_s": dump_s, "tool_s": tool_s,
              "kernel_vs_plain": {"images": FID_KERNEL_IMAGES, "batch": FID_KERNEL_BATCH,
                                  "image_max_abs": image_gap, "fid": kernel_fid,
                                  "fid_rel_gap": fid_gap, "image_atol": FID_KERNEL_IMAGE_ATOL,
                                  "fid_rtol": FID_KERNEL_FID_RTOL},
              "train_feature_net": trained}
    if problems:
        raise RuntimeError(f"fid_laion: {problems}: {fields}")
    emit("fid_laion", **fields)
    return fields


_UPSTREAM_RENAMES = (
    (r"^time_embedding\.fc([12])\.", lambda m: f"time_embedding.{2 * int(m[1]) - 2}."),
    (r"\.block1\.conv\.", ".0."), (r"\.block1\.bn\.", ".1."),
    (r"\.block2\.conv\.", ".3."), (r"\.block2\.bn\.", ".4."),
    (r"^bottleneck\.conv\.", "bottleneck.0."), (r"^bottleneck\.bn\.", "bottleneck.1."),
)


def synthetic_upstream_unet28(seed: int) -> dict[str, torch.Tensor]:
    """A seeded UNet28 state dict under the tiny-diffusion reference's names
    and layouts (``enc1.0``, ``time_embedding.2``, 1x1-conv ``time_proj``)
    at full width."""
    import re

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in UNet28().state_dict().items():
        if name.endswith("num_batches_tracked"):
            value = torch.tensor(100)
        elif name.endswith("running_var"):
            value = 0.5 + torch.rand(t.shape, generator=gen)
        else:
            value = 0.05 * torch.randn(t.shape, generator=gen)
        if re.match(r"^time_proj\d\.weight$", name):
            value = value[:, :, None, None]
        for pattern, repl in _UPSTREAM_RENAMES:
            name = re.sub(pattern, repl, name)
        out[name] = value
    return out


def phase_torch_import() -> dict:
    """A synthetic upstream UNet28 ``.pth`` through the import tool, served
    by ``load_pixel_checkpoint`` on the card and on the CPU: DDIM-10 chains
    from one x_init (float32 forward) against each other."""
    with tempfile.TemporaryDirectory() as tmp:
        pth, out = os.path.join(tmp, "upstream.pth"), os.path.join(tmp, "imported")
        torch.save(synthetic_upstream_unet28(IMPORT_SEED), pth)
        t0 = time.perf_counter()
        result = import_torch_checkpoint.main(["--model", "unet28", "--pth", pth, "--out", out])
        import_s = time.perf_counter() - t0
        loaded = {dev: load_pixel_checkpoint(out, dev) for dev in ("cuda", "cpu")}
    x_init = torch.from_numpy(np.random.default_rng(IMPORT_SEED).standard_normal(
        (SERVE_CHAIN_N, 1, 28, 28)).astype(np.float32))
    chains = {}
    for dev, ld in loaded.items():
        sampler = make_sampler(ld["model"], ld["schedule"], (SERVE_CHAIN_N, 1, 28, 28),
                               method="ddim", sample_steps=SERVE_CHAIN_STEPS)
        chains[dev] = sampler(params=ld["params"], x_init=x_init.to(dev)).cpu()
    largest = chains["cpu"].abs().max().item()
    gap = (chains["cuda"] - chains["cpu"]).abs().max().item() / largest
    fields = {"params": result["params"], "config": result["config"], "import_s": import_s,
              "ddim_steps": SERVE_CHAIN_STEPS, "n": SERVE_CHAIN_N, "largest_abs": largest,
              "card_vs_cpu_rel": gap, "rtol": IMPORT_RTOL,
              "finite": bool(torch.isfinite(chains["cuda"]).all())}
    if not (fields["finite"] and gap <= IMPORT_RTOL):
        raise RuntimeError(f"torch_import: {fields}")
    emit("torch_import", **fields)
    return fields


def _clip_captions() -> list[str]:
    """CLIP_CHECK_CAPTIONS captions: the four prompts, the empty one and
    sentences of CLIP_WORDS, some with words past the vocabulary's."""
    words = CLIP_WORDS
    made = [" ".join(words[(7 * i + 3 * j) % len(words)] for j in range(3 + i))
            + ("" if i % 3 else ", zebra crossing!") for i in range(CLIP_CHECK_CAPTIONS - 5)]
    return list(conditional_diffusion_laion.SAMPLE_PROMPTS) + [""] + made


def clip_flops(config: CLIPTextConfig, rows: int, tokens: int) -> float:
    """The transformer's products for (rows, tokens) ids: per token and layer
    the q, k, v and out projections (4 C^2), the MLP (2 C F) and the
    attention's two products over the tokens (2 N C), two FLOPs a MAC."""
    c, f, n = config.hidden_size, config.intermediate_size, tokens
    return 2.0 * rows * n * config.num_hidden_layers * (4 * c * c + 2 * c * f + 2 * n * c)


def phase_clip_encode(clip_dir: str) -> dict:
    """CLIP-L from the synthetic directory through ``get_text_encoder("clip",
    clip_local_dir=...)`` on the card, against the same files' encoder on the
    CPU (float32, TF32 off) on CLIP_CHECK_CAPTIONS captions, beside two card
    runs and the CPU's float32 against float64; then the 800 records'
    captions encoded on the card (host clock: tokenizing, the forward and
    the copy back) and the forward alone (CUDA events), its FLOPs and share
    of the float32 peak. Returns the card encoder and the records' embeddings."""
    disable_tf32()
    card = text_encoder.get_text_encoder("clip", 768, clip_dir, device="cuda")
    cpu = text_encoder.get_text_encoder("clip", 768, clip_dir, device="cpu")
    if not isinstance(card, CLIPTextEncoder) or card.config != CLIPTextConfig():
        raise RuntimeError(f"clip_encode: {type(card).__name__} {getattr(card, 'config', None)}")
    captions = _clip_captions()
    got, again, want = card.encode(captions), card.encode(captions), cpu.encode(captions)
    ids = torch.from_numpy(cpu.tokenizer(captions)["input_ids"])
    with torch.no_grad():
        want64 = cpu.model.double()(ids)[:, -1].numpy()
    fields = {"config": dataclasses.asdict(card.config), "captions": len(captions),
              "atol": CLIP_CARD_VS_CPU_ATOL,
              "card_vs_cpu_max_abs": float(np.abs(got - want).max()),
              "card_vs_card_max_abs": float(np.abs(got - again).max()),
              "cpu_f32_vs_f64_max_abs": float(np.abs(want - want64).max()),
              "max_abs": float(np.abs(want).max())}
    if not (got.shape == (len(captions), 768) and np.isfinite(got).all()
            and fields["card_vs_cpu_max_abs"] <= CLIP_CARD_VS_CPU_ATOL):
        raise RuntimeError(f"clip_encode: card vs CPU {fields}")
    records = [synthesize_caption(i) for i in range(LAION_RECORDS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    embeds = card.encode(records)
    encode_s = time.perf_counter() - t0
    record_ids = torch.from_numpy(card.tokenizer(records)["input_ids"]).cuda()
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: card.model(record_ids), iters=3, warmup=1)
    flops = clip_flops(card.config, *record_ids.shape)
    fields.update(records=len(records), encode_records_s=encode_s, forward_ms=forward_ms,
                  forward_gflop=flops / 1e9,
                  fp32_peak_share=flops / (forward_ms * 1e-3) / PEAK_FP32_FLOPS,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    emit("clip_encode", **fields)
    return {"encoder": card, "embeds": embeds, **fields}


def sdvae_flops(vae, fn) -> float:
    """The products of one call of ``fn`` on ``vae``, from the shapes that
    its convolutions, Dense layers and mid-block attentions see (hooks): two
    FLOPs a MAC; norms and activations not counted."""
    total = [0.0]

    def conv(m, inp, out):
        total[0] += 2.0 * out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] \
            * m.kernel_size[1]

    def dense(m, inp, out):
        total[0] += 2.0 * out.numel() * m.in_features

    def attn(m, inp, out):
        b, c, h, w = inp[0].shape
        total[0] += 2.0 * 2 * b * (h * w) ** 2 * c  # q k^T and p v

    hooks = []
    for module in vae.modules():
        if isinstance(module, torch.nn.Conv2d):
            hooks.append(module.register_forward_hook(conv))
        elif isinstance(module, torch.nn.Linear):
            hooks.append(module.register_forward_hook(dense))
        elif isinstance(module, sdvae.Attention):
            hooks.append(module.register_forward_hook(attn))
    try:
        fn()
    finally:
        for hook in hooks:
            hook.remove()
    return total[0]


def phase_sdvae_codec() -> dict:
    """The SD v1.4 AutoencoderKL at the fixture's config from a seeded init,
    through ``SDVAECodec.from_torch_state_dict``: its keys and shapes against
    ``tests/fixtures/sd_v1_4_vae_state_dict.json``; encode moments of 8
    synthetic 256² images and decode of 4 latents of 32², the card against
    the CPU (float32, TF32 off); each one's time (CUDA events), peak memory,
    FLOPs and share of the float32 peak. Returns the card codec."""
    disable_tf32()
    with open(os.path.join(REPO, "tests", "fixtures", "sd_v1_4_vae_state_dict.json")) as f:
        manifest = {k: tuple(v) for k, v in json.load(f).items()}
    with open(os.path.join(REPO, "tests", "fixtures", "sd_v1_4_vae_config.json")) as f:
        upstream = json.load(f)
    config = {k: upstream[k] for k in sdvae.SD_VAE_CONFIG}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SD_SEED)
        state = sdvae.AutoencoderKL(**config).state_dict()
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    n_params = sum(v.numel() for v in state.values())
    if shapes != manifest or n_params != SD_PARAMS:
        raise RuntimeError(f"sdvae_codec: {n_params} params, keys off the manifest: "
                           f"{sorted(set(shapes) ^ set(manifest))[:8]}")
    codec = sdvae.SDVAECodec.from_torch_state_dict(state, config,
                                                   upstream["scaling_factor"]).to("cuda")
    cpu = sdvae.SDVAECodec.from_torch_state_dict(state, config, upstream["scaling_factor"])
    x = _nchw(np.stack([synthesize_image(i, 256)[0] for i in range(SD_ENCODE_BATCH)]))
    x = x * 2.0 - 1.0
    z = torch.from_numpy(np.random.default_rng(SEED + 42).standard_normal(
        (SD_DECODE_BATCH, 4, 32, 32)).astype(np.float32))
    fields = {"params": n_params, "config": config, "rel_bound": SD_CARD_VS_CPU_REL}
    problems = []
    for name, fn, arg, shape in (("encode", codec.vae.encode_moments, x,
                                  (SD_ENCODE_BATCH, 8, 32, 32)),
                                 ("decode", codec.vae.decode, z, (SD_DECODE_BATCH, 3, 256, 256))):
        cpu_fn = getattr(cpu.vae, fn.__name__)
        arg_card = arg.cuda()
        with torch.no_grad():
            got, want = fn(arg_card).cpu(), cpu_fn(arg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: fn(arg_card), iters=5)
            peak = torch.cuda.max_memory_allocated() / 2**30
            flops = sdvae_flops(codec.vae, lambda: fn(arg_card))
        rel = ((got - want).abs().max() / want.abs().max()).item()
        fields[name] = {"input": list(arg.shape), "output": list(got.shape), "ms": ms,
                        "peak_mem_gib": peak, "gflop": flops / 1e9,
                        "gflop_per_image": flops / 1e9 / len(arg),
                        "fp32_peak_share": flops / (ms * 1e-3) / PEAK_FP32_FLOPS,
                        "card_vs_cpu_rel": rel, "max_abs": want.abs().max().item()}
        if tuple(got.shape) != shape or not torch.isfinite(got).all() or rel > SD_CARD_VS_CPU_REL:
            problems.append(f"{name}: {fields[name]}")
    if problems:
        raise RuntimeError(f"sdvae_codec: {problems}")
    emit("sdvae_codec", **fields)
    return {"codec": codec, **fields}


def _encode_share(codec, step, state, data, idxs, gen) -> dict:
    """The codec's share of the SD step's device time: CUDA-event times of
    ``len(idxs)`` graph-replayed steps and of as many encodes of the same
    batches; then one profiler session over the encodes and the steps
    (``record_function`` ranges apart, each ended by a synchronize), its
    kernels summed by the range they start in, taken again when a range
    holds no kernel or a kernel lies outside both (up to 3 sessions)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def encodes():
        for row in idxs:
            x, _ = data.gather(torch.from_numpy(row).cuda())
            codec.encode(x.permute(0, 3, 1, 2), generator=gen)

    steps_ms = cuda_ms(lambda: step(state, idxs), iters=1, warmup=1)
    encodes_ms = cuda_ms(encodes, iters=1, warmup=1)
    fields = {"steps": len(idxs), "steps_ms": steps_ms, "encodes_ms": encodes_ms,
              "event_share": encodes_ms / steps_ms}
    for session in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for name, fn in (("encodes", encodes), ("steps", lambda: step(state, idxs))):
                with record_function(name):
                    fn()
                    torch.cuda.synchronize()
        events = prof.events()
        ranges = {ev.name: ev.time_range for ev in events
                  if ev.name in ("encodes", "steps") and ev.device_type
                  == torch.autograd.DeviceType.CPU}
        busy = {"encodes": 0.0, "steps": 0.0, "outside": 0.0}
        for ev in events:
            if (ev.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(ev, "is_user_annotation", False) or ev.name in ranges):
                continue
            where = next((n for n, r in ranges.items() if r.start <= ev.time_range.start
                          <= r.end), "outside")
            busy[where] += ev.time_range.elapsed_us() / 1e3
        if len(ranges) == 2 and busy["encodes"] > 0 and busy["steps"] > 0 \
                and busy["outside"] == 0:
            fields.update(profile_sessions=session + 1, encodes_busy_ms=busy["encodes"],
                          steps_busy_ms=busy["steps"],
                          profile_share=busy["encodes"] / busy["steps"])
            return fields
    fields.update(profile_sessions=3, profile_share=None, profile_busy_ms=busy)
    return fields


def phase_laion_sd_train(codec, clip: dict, patch: dict) -> dict:
    """The LAION recipe (``laion_diffusion_1000ep.json``: LatentUNet at
    time_dim 768, B = 8, bf16, Adam 1e-4 cosine, clip 10, 10 steps a chunk)
    with the SD codec and CLIP-L's embeddings of the synthetic records,
    through ``make_resident_laion_multi_step`` and ``make_laion_eval_step``:
    first 10 graph steps against 10 eager (``laion_parity``'s check and
    bounds), then 2 epochs of 20 steps and the val pass, the q_sample
    launches counted over them, the warm step, the codec's share of the
    step's device time, and the patch-codec step of ``laion_train`` beside.
    Returns the trained model."""
    disable_tf32()
    recipe = _laion_recipe()
    b = recipe.batch_size
    records = [synthesize_image(i, recipe.image_size) for i in range(LAION_SD_RECORDS)]
    images = np.stack([image for image, _ in records])
    embeds = clip["embeds"][:LAION_SD_RECORDS]
    null = torch.from_numpy(clip["encoder"].encode([""])[0]).cuda()
    parity = _laion_graph_vs_eager("laion_sd_train", codec, images[: b * PARITY_STEPS],
                                   embeds[: b * PARITY_STEPS], null)

    schedule = DiffusionSchedule.linear(recipe.num_timesteps).to("cuda")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = LatentUNet(time_dim=recipe.time_dim, in_channels=recipe.latent_channels,
                           latent_size=recipe.latent_size)
    model = model.cuda()
    optimizer = torch.optim.Adam(model.parameters(), lr=torch.tensor(recipe.lr, device="cuda"),
                                 capturable=True)
    state = create_train_state(model, optimizer, SEED)
    perm = np.random.default_rng(recipe.split_seed).permutation(len(images))
    n_val = len(images) // 5
    common = dict(batch_size=b, seed=SEED, device="cuda",
                  u8_normalize=conditional_diffusion_laion.LAION_U8_NORMALIZE)
    train = DeviceDataset(images[perm[n_val:]], embeds=embeds[perm[n_val:]], **common)
    val = DeviceDataset(images[perm[:n_val]], embeds=embeds[perm[:n_val]], shuffle=False,
                        **common)
    chunk = make_resident_laion_multi_step(
        codec, schedule, train, clip_norm=recipe.clip_norm, compute_dtype=torch.bfloat16,
        lr_schedule=conditional_diffusion_laion.cosine_annealing_lr(
            recipe.lr, recipe.lr_min, recipe.scheduler_t_max))
    evaluate = make_resident_eval(
        make_laion_eval_step(codec, schedule, torch.bfloat16), val, SEED + 3,
        conditional_diffusion_laion.VAL_FOLD_STRIDE)
    g = max(recipe.steps_per_dispatch, recipe.log_every, 1)  # run()'s chunk
    _reset_launches()
    split = {"train": 0, "eval": 0}
    epochs = []
    for epoch in range(LAION_SD_EPOCHS):
        idxs = train.epoch_index_batches(epoch)[:LAION_SD_STEPS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = qsample.qsample_launches
        losses = torch.cat([chunk(state, idxs[i : i + g])
                            for i in range(0, len(idxs), g)]).tolist()
        train_s = time.perf_counter() - t0
        split["train"] += qsample.qsample_launches - before
        before = qsample.qsample_launches
        t0 = time.perf_counter()
        val_losses = evaluate(model, epoch, val.epoch_index_batches(0)).tolist()
        val_s = time.perf_counter() - t0
        split["eval"] += qsample.qsample_launches - before
        epochs.append({"losses": losses, "train_s": train_s, "step_ms": 1e3 * train_s / len(idxs),
                       "samples_per_sec": len(idxs) * b / train_s, "val_losses": val_losses,
                       "val_s": val_s})
    steps = LAION_SD_EPOCHS * LAION_SD_STEPS
    val_batches = LAION_SD_EPOCHS * (n_val // b)
    graph, launches = dict(chunk.counts), _launches()
    share = _encode_share(codec, chunk, state, train, train.epoch_index_batches(2)[:g],
                          torch.Generator("cuda").manual_seed(SEED))
    fields = {"recipe": os.path.relpath(LAION_CHECKPOINT, REPO) + ".json", "batch": b,
              "records": LAION_SD_RECORDS, "epochs": epochs, "graph": graph,
              "qsample_launches": split, "launches": launches, "parity": parity,
              "warm_step_ms": epochs[-1]["step_ms"],
              "warm_samples_per_sec": epochs[-1]["samples_per_sec"], "encode_share": share,
              "patch_codec_warm_step_ms": patch["warm_step_ms"],
              "patch_codec_warm_samples_per_sec": patch["warm_samples_per_sec"]}
    problems = []
    if split != {"train": steps, "eval": val_batches}:
        problems.append(f"q_sample launches {split}, want {steps} train, {val_batches} eval")
    if graph != {"eager": GRAPH_WARMUP_STEPS, "captures": 1,
                 "replays": steps - GRAPH_WARMUP_STEPS}:
        problems.append(f"graph counts {graph}")
    values = [v for e in epochs for v in e["losses"] + e["val_losses"]]
    if not np.all(np.isfinite(values)):
        problems.append("a loss is not finite")
    if problems:
        raise RuntimeError(f"laion_sd_train: {problems}: {fields}")
    emit("laion_sd_train", **fields)
    return {"model": model, "schedule": schedule, **fields}


def phase_laion_sd_serve(model, schedule, codec, clip_encoder) -> dict:
    """A request on the SD-trained UNet: the four prompts' CLIP embeddings,
    DDIM-50 (bf16 forward, fp32 chain) and the SD decode, as
    ``make_laion_sampler`` serves it; twice cold (the chain's and the
    decode's captures), then timed warm, every step and the decode replayed
    (forwards from the sampler's counts), with the text encode and the
    decode's time (CUDA events) apart."""
    prompts = conditional_diffusion_laion.SAMPLE_PROMPTS
    sampler = conditional_diffusion_laion.make_laion_sampler(
        model.eval(), schedule, codec, len(prompts), 32, 4, compute_dtype=torch.bfloat16,
        method="ddim", sample_steps=50)
    def request():
        embeds = torch.from_numpy(clip_encoder.encode(prompts)).cuda()
        return sampler(torch.Generator("cuda").manual_seed(SEED), embeds)

    request()  # cold: the chain's capture
    request()  # the decode's capture
    before = dict(sampler.counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = request()
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    forwards, replays = (sampler.counts[k] - before[k] for k in ("forwards", "replays"))
    t0 = time.perf_counter()
    clip_encoder.encode(prompts)
    text_s = time.perf_counter() - t0
    latents = torch.randn(len(prompts), 4, 32, 32, device="cuda")
    decode_ms = cuda_ms(lambda: codec.decode(latents), iters=3)
    fields = {"prompts": prompts, "sampler": "ddim50", "forwards": forwards,
              "graph_replays": replays, "request_s": request_s, "text_encode_s": text_s,
              "decode_ms": decode_ms,
              "ms_per_forward_and_step": (1e3 * request_s - decode_ms) / max(forwards, 1)}
    if not (forwards == 50 and replays == 51 and tuple(images.shape) == (4, 3, 256, 256)
            and torch.isfinite(images).all() and images.min() >= 0 and images.max() <= 1):
        raise RuntimeError(f"laion_sd_serve: images {tuple(images.shape)}: {fields}")
    emit("laion_sd_serve", **fields)
    return fields


def phase_laion_clip_run(clip_dir: str, cache_dir: str | None = None) -> dict:
    """The normal entry points on CLIP: ``python -m
    tinydiffusion_torch.experiments.conditional_diffusion_laion
    --text-encoder clip --clip-local-dir DIR`` cut to 1 epoch of 20 steps,
    then ``python -m tinydiffusion_torch.generate_laion`` on its checkpoint
    (DDIM-50, the four prompts), each a process of its own."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        train = [sys.executable, "-m", "tinydiffusion_torch.experiments.conditional_diffusion_laion",
                 "--text-encoder", "clip", "--clip-local-dir", clip_dir, "--num-epochs", "1",
                 "--max-steps-per-epoch", str(LAION_CLIP_STEPS), "--n-records",
                 str(LAION_CLIP_RECORDS), "--sample-every-epoch", "false",
                 "--out-dir", os.path.join(tmp, "out"), "--model-save-path", ckpt,
                 *(f for k, v in _record_cache(tmp, cache_dir).items()
                   for f in (f"--{k.replace('_', '-')}", v))]
        serve = [sys.executable, "-m", "tinydiffusion_torch.generate_laion", "--checkpoint", ckpt,
                 "--sampler", "ddim", "--sample-steps", "50", "--out",
                 os.path.join(tmp, "gen.png")]
        fields = {}
        for name, cmd in (("train", train), ("serve", serve)):
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
            fields[name] = {"rc": proc.returncode, "wall_s": time.perf_counter() - t0,
                            "tail": proc.stdout.strip().splitlines()[-3:]}
            if proc.returncode:
                raise RuntimeError(f"laion_clip_run {name}: rc {proc.returncode}\n"
                                   f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        sidecar = load_sidecar(ckpt)
        with open(os.path.join(tmp, "out", "laion-diffusion-model", "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        losses = [m["batch_train_loss"] for m in metrics if "batch_train_loss" in m]
        fields.update(steps=LAION_CLIP_STEPS, records=LAION_CLIP_RECORDS, losses=losses,
                      val_loss=[m["val_loss"] for m in metrics if "val_loss" in m])
        ok = (sidecar["config"]["text_encoder"] == "clip" and losses
              and np.all(np.isfinite(losses + fields["val_loss"]))
              and "wrote 4 samples" in " ".join(fields["serve"]["tail"])
              and "50 model forwards" in " ".join(fields["serve"]["tail"])
              and os.path.getsize(os.path.join(tmp, "gen.png")) > 0)
    if not ok:
        raise RuntimeError(f"laion_clip_run: {fields}")
    emit("laion_clip_run", **fields)
    return fields


def _set_default_tf32() -> None:
    """The TF32 flags as a fresh process has them: a run must turn them off itself."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def _timed_calls(targets: dict):
    """Each ``(owner, attribute)`` of ``targets`` wrapped for the block: its
    calls' seconds (the card synchronized before and after) and count under
    its name. A name ending in ``()`` times the callable its factory returns."""
    totals = {name.rstrip("()"): {"s": 0.0, "calls": 0} for name in targets}
    saved = []

    def timed(fn, total):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                total["s"] += time.perf_counter() - t0
                total["calls"] += 1
        return wrapper

    for name, (owner, attr) in targets.items():
        fn = getattr(owner, attr)
        total = totals[name.rstrip("()")]
        if name.endswith("()"):
            new = functools.wraps(fn)(lambda *a, _fn=fn, _t=total, **k: timed(_fn(*a, **k), _t))
        else:
            new = timed(fn, total)
        saved.append((owner, attr, fn))
        setattr(owner, attr, new)
    try:
        yield totals
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


# What a conv-VAE run() spends outside its train steps, by part: the records'
# load (inside it the synthetic fetches, the cache writes and reads), the val
# passes, the reconstruction panels and samples, the PNGs and the checkpoints.
_OUTSIDE_STEPS = {
    "load_images": (vae_laion, "load_images"),
    "fetch": (laion_data, "synthesize_image"),
    "cache_write": (laion_data, "encode_jpeg"),
    "cache_read": (laion_data, "decode_image"),
    "val_pass()": (vae_laion, "make_resident_eval"),
    "samples": (vae_laion, "sample_prior"),
    "png": (vae_laion, "save_image_grid"),
    "checkpoint": (vae_laion.BestKeeper, "update"),
}


def phase_vae_train(placement: str = "auto", compute_dtype: str = "float32",
                    image_size: int = 256, checkpoint_dir: str | None = None,
                    cache_dir: str | None = None) -> dict:
    """The conv-VAE's ``run()`` at full width on the card, with the kernel
    launches counted over exactly that run: ``vae_train`` (the default, the
    set resident and each step a graph replay), ``vae_train_host`` (batches
    streamed from the host) and ``vae_train_bf16`` (resident, bfloat16: the
    bf16 kernels only); at ``image_size=512`` or ``1024``, ``vae512_train``
    and ``vae512_train_bf16`` (resident), or ``vae1024_...``, the checkpoint
    left in ``checkpoint_dir`` when one is given. The records' JPEG cache
    goes into ``cache_dir`` (a run of its size before may have filled it:
    the records are then read warm, decoded) or else into the run's
    temporary directory, as does the failed-URL list."""
    phase = {("auto", "float32"): "vae_train", ("host", "float32"): "vae_train_host",
             ("auto", "bfloat16"): "vae_train_bf16"}[placement, compute_dtype]
    if image_size != 256:
        phase = phase.replace("vae_", f"vae{image_size}_")
    n_records, n_epochs, max_steps = VAE_RUNS[image_size, compute_dtype]
    with tempfile.TemporaryDirectory() as tmp:
        config = vae_laion.VAELaionConfig(
            image_size=image_size, n_records=n_records, epochs=n_epochs, log_interval=10,
            max_steps_per_epoch=max_steps, data_placement=placement,
            compute_dtype=compute_dtype, out_dir=os.path.join(tmp, "out"),
            image_cache_dir=cache_dir or os.path.join(tmp, "laion"),
            failed_urls_cache=os.path.join(tmp, "failed_urls.json"),
            checkpoint_dir=checkpoint_dir or os.path.join(tmp, "ckpt"), device="cuda")
        warm_cache = (os.path.isdir(config.image_cache_dir)
                      and len(os.listdir(config.image_cache_dir)) == n_records)
        _set_default_tf32()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        with _timed_calls(_OUTSIDE_STEPS) as parts:
            result = vae_laion.run(config)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _launches()
        by_width = dict(attention.launches_by_width)
        train_s = sum(e["train_seconds"] for e in result["epochs"])
        outside = {"wall_s": wall_s, "train_s": train_s, "outside_s": wall_s - train_s,
                   **{f"{k}_s": v["s"] for k, v in parts.items()},
                   "calls": {k: v["calls"] for k, v in parts.items()}}
        # The rest: the model's set-up, the resident set's copy, the graph's
        # warm-up and capture outside the timed epochs, the loggers.
        outside["other_s"] = outside["outside_s"] - sum(
            v["s"] for k, v in parts.items() if k not in ("fetch", "cache_write", "cache_read"))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if torch.backends.cudnn.allow_tf32:
            raise RuntimeError(f"{phase}: run() left cuDNN's TF32 on")
        steps = result["state"].step
        per_epoch = (n_records - n_records // 10) // config.batch_size
        if steps != n_epochs * (min(per_epoch, max_steps) if max_steps else per_epoch):
            raise RuntimeError(f"{phase}: {steps} steps")
        graph = result["graph"]
        if (graph is None) != (placement == "host"):
            raise RuntimeError(f"{phase}: resident {result['resident']}, graph {graph}")
        if graph is not None and (graph["eager"] + graph["replays"] != steps
                                  or graph["captures"] != 1 or graph["replays"] == 0):
            raise RuntimeError(f"{phase}: {steps} steps, graph {graph}")
        # The flash sites of a step, each one backward: launches per step times
        # the steps run (eager ones and graph replays, which count in the
        # launch counts through the graph's captured launches), at each head
        # width; the forwards at least as many (the val pass and the samples
        # add theirs).
        fwd, bwd = ("flash_fwd_bf16", "flash_bwd_bf16") if compute_dtype == "bfloat16" else (
            "flash_fwd", "flash_bwd")
        ran = steps if graph is None else graph["eager"] + graph["replays"]
        sites = VAE_FLASH_SITES[image_size]
        if launches[bwd] != sum(sites.values()) * ran or launches[fwd] < sum(sites.values()) * ran:
            raise RuntimeError(f"{phase}: {ran} steps run, launches {launches}")
        for (kernel, d, c), n in by_width.items():
            want = sites.get((d, c), 0) * ran if kernel in (fwd, bwd) else 0
            if not (n >= want if kernel == fwd and want else n == want):
                raise RuntimeError(f"{phase}: {ran} steps run, {kernel} ({d}, {c}) launched "
                                   f"{n} times: {_launches_by_width()}")
        others = {k: v for k, v in launches.items() if k not in (fwd, bwd) and v}
        if others:
            raise RuntimeError(f"{phase}: other kernels launched: {others}")
        with open(os.path.join(config.out_dir, "vae_laion", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        batches = [r for r in records if "bce" in r]
        epochs = [r for r in records if "test_loss" in r]
        keys = ("batch_train_loss", "bce", "perceptual", "kld", "logvar_max", "mu_absmax")
        values = [r[k] for r in batches for k in keys] + [r["test_loss"] for r in epochs]
        if not batches or len(epochs) != n_epochs or not np.all(np.isfinite(values)):
            raise RuntimeError(f"{phase}: metrics {records}")
        want = [os.path.join(config.out_dir, name) for name in (
            "generated_samples.png", *(f"original_vs_reconstructed_epoch_{e}.png"
                                       for e in range(1, n_epochs + 1)))]
        cached = len(os.listdir(config.image_cache_dir))
        if cached != config.n_records:
            raise RuntimeError(f"{phase}: {cached} cached records of {config.n_records}")
        # A warm cache: every record its cache file's decode, nothing fetched.
        reads = {k: parts[k]["calls"] for k in ("fetch", "cache_write", "cache_read")}
        if reads != ({"fetch": 0, "cache_write": 0, "cache_read": n_records} if warm_cache
                     else {"fetch": n_records, "cache_write": n_records, "cache_read": 0}):
            raise RuntimeError(f"{phase}: warm cache {warm_cache}, record reads {reads}")
        want += [os.path.join(config.checkpoint_dir, "vae_laion_best" + ext)
                 for ext in (".pt", ".npz", ".json")]
        missing = [os.path.relpath(p, tmp) for p in want if not os.path.getsize(p) > 0]
        if missing:
            raise RuntimeError(f"{phase}: missing outputs {missing}")
        # A run of one epoch has no warm epoch: its steps hold the eager
        # warm-ups and the capture (epoch_step_ms has them all).
        warm = result["epochs"][-1] if n_epochs > 1 else None
        fields = {
            "image_size": config.image_size, "batch": config.batch_size, "steps": steps,
            "placement": placement, "compute_dtype": compute_dtype, "graph": graph,
            "launches": launches, "launches_by_width": _launches_by_width(), "wall_s": wall_s,
            "warm_cache": warm_cache,
            "epoch_step_ms": [1e3 * e["train_seconds"] / e["steps"] for e in result["epochs"]],
            "warm_step_ms": warm and 1e3 * warm["train_seconds"] / warm["steps"],
            "warm_images_per_sec": warm and warm["images_per_sec"],
            "first_epoch_images_per_sec": result["epochs"][0]["images_per_sec"],
            "first_loss": batches[0]["batch_train_loss"],
            "last_loss": batches[-1]["batch_train_loss"],
            "components_last": {k: batches[-1][k] for k in keys[1:]},
            "test_losses": result["test_losses"], "peak_mem_gib": peak_gib,
            "dq_scratch_gib_by_site": _dq_scratch_gib(config.batch_size, image_size,
                                                      vae_laion.COMPUTE_DTYPES[compute_dtype]),
            "outside_steps": outside,
        }
    if max(fields["dq_scratch_gib_by_site"].values()) > DQ_SCRATCH_MAX_GIB:
        raise RuntimeError(f"{phase}: dq scratch {fields['dq_scratch_gib_by_site']} GiB")
    emit(phase, **fields)
    return fields


def _dq_scratch_gib(b: int, image_size: int, dtype: torch.dtype) -> dict[str, float]:
    """GiB of the backward kernel's scratch (``attention.flash_bwd_scratch``,
    what ``flash_bwd`` allocates: the dq counters, and the bf16 run sum) at
    each flash site of a conv-VAE step: O(B D N)."""
    sides = {(4, 32): image_size // 2, (8, 64): image_size // 4, (16, 128): image_size // 8}
    return {f"({d}, {c}) N={sides[d, c] ** 2}":
            attention.flash_bwd_scratch_bytes(dtype, b, d, sides[d, c] ** 2, c) / 2**30
            for d, c in VAE_FLASH_SITES[image_size]}


def _conv_vae(dtype: torch.dtype) -> "vae_laion.ConvVAE":
    """The conv-VAE of ``vae_laion_best`` on the card in the compute ``dtype``."""
    model = vae_laion.ConvVAE(dtype=dtype)
    model.load_state_dict(load_conv_vae(CHECKPOINT, device="cpu").state_dict())
    return model.cuda().train()


def _vae_record(state, losses: list, params0: torch.Tensor) -> dict:
    """What one run of the conv-VAE parity steps left (``_parity_record``'s
    fields; the statistics are the BN running ones and the spectral norms'
    ``u`` and ``sigma``)."""
    params = _flat(state.model.parameters())
    stats = _flat([b for n, b in state.model.named_buffers()
                   if n.endswith(("running_mean", "running_var", ".u", ".sigma"))])
    return {"losses": losses, "params": params, "update": (params - params0).double(),
            "stats": stats, "generator": state.generator.get_state()}


def phase_vae_resident_parity() -> dict:
    """VAE_PARITY_STEPS conv-VAE steps of the resident step (2 eager, then
    replays of its graph) against the same steps eager (the train step on the
    gathered batches), and a second eager run, from ``vae_laion_best``, in
    float32 and bfloat16, cuDNN deterministic."""
    disable_tf32()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _vae_resident_parity()
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _vae_resident_parity() -> dict:
    b = 4
    images = np.random.default_rng(SEED + 27).integers(
        0, 256, (b * VAE_PARITY_STEPS, 256, 256, 3), dtype=np.uint8)
    bounds = {"loss_rtol": VAE_PARITY_LOSS_RTOL, "min_update_cos": VAE_PARITY_MIN_UPDATE_COS,
              "max_params_abs": VAE_PARITY_MAX_PARAM_ABS,
              "max_stats_rel": VAE_PARITY_MAX_STATS_REL}
    fields = {"steps": VAE_PARITY_STEPS, "replayed": VAE_PARITY_STEPS - GRAPH_WARMUP_STEPS,
              "batch": b, **bounds, "cudnn_deterministic": True}
    failed = []
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        perceptual = PerceptualNet(dtype=dtype).cuda()
        out = {}
        for mode in ("graph", "eager", "eager_again"):
            model = _conv_vae(dtype)
            state = vae_laion.create_train_state(
                model, vae_laion.make_optimizer(model, 1e-4, capturable=True), SEED)
            dataset = DeviceDataset(images, b, seed=SEED, device="cuda",
                                    u8_normalize=(1.0 / 255.0, 0.0))
            idxs = dataset.epoch_index_batches(0)[:VAE_PARITY_STEPS]
            params0 = _flat(model.parameters())
            if mode == "graph":
                step = vae_laion.make_conv_vae_resident_step(perceptual, 1.0, 10.0, dataset)
                losses = step(state, idxs)[0].tolist()
                if step.counts["replays"] != VAE_PARITY_STEPS - GRAPH_WARMUP_STEPS:
                    raise RuntimeError(f"vae_resident_parity: graph counts {step.counts}")
            else:
                step = vae_laion.make_conv_vae_train_step(perceptual, 1.0, 10.0)
                losses = [step(state, dataset.gather(torch.from_numpy(row).cuda())
                               .permute(0, 3, 1, 2).contiguous())[0].item() for row in idxs]
            torch.cuda.synchronize()
            out[mode] = _vae_record(state, losses, params0)
            del model, state, dataset
        fields[name], ok = _parity_fields(name, out, bounds)
        if not ok:
            failed.append(name)
        del perceptual
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"vae_resident_parity: graph vs eager in {failed}: {fields}")
    fields["weights"] = os.path.relpath(CHECKPOINT, REPO)
    emit("vae_resident_parity", **fields)
    return fields


def phase_vae_resident_full() -> dict:
    """JAX's full 256² train set (VAE_FULL_IMAGES uint8 images) pinned on the
    card, a float32 model from a seeded init: one chunk of VAE_FULL_CHUNK
    steps (warm-ups and the capture), then one of replays, timed; the peak
    device memory."""
    disable_tf32()
    t0 = time.perf_counter()
    images = np.random.default_rng(SEED + 28).integers(
        0, 256, (VAE_FULL_IMAGES, 256, 256, 3), dtype=np.uint8)
    make_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dataset = DeviceDataset(images, 4, seed=SEED, device="cuda", u8_normalize=(1.0 / 255.0, 0.0))
    torch.cuda.synchronize()
    pin_s = time.perf_counter() - t0
    pinned_gib = dataset.images.numel() / 2**30
    del images
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = vae_laion.ConvVAE().cuda()
    state = vae_laion.create_train_state(
        model, vae_laion.make_optimizer(model, 1e-4, capturable=True), SEED)
    step = vae_laion.make_conv_vae_resident_step(PerceptualNet().cuda(), 1.0, 10.0, dataset)
    idxs = dataset.epoch_index_batches(1)
    first, _ = step(state, idxs[:VAE_FULL_CHUNK])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second, comps = step(state, idxs[VAE_FULL_CHUNK:2 * VAE_FULL_CHUNK])
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    losses = torch.cat([first, second]).tolist()
    if not np.all(np.isfinite(losses)) or step.counts["captures"] != 1:
        raise RuntimeError(f"vae_resident_full: losses {losses}, counts {step.counts}")
    fields = {"images": VAE_FULL_IMAGES, "image_size": 256, "pinned_gib": pinned_gib,
              "make_s": make_s, "pin_s": pin_s, "graph": dict(step.counts),
              "replayed_chunk_steps": VAE_FULL_CHUNK,
              "graph_step_ms": 1e3 * chunk_s / VAE_FULL_CHUNK,
              "graph_images_per_sec": 4 * VAE_FULL_CHUNK / chunk_s,
              "losses": losses, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit("vae_resident_full", **fields)
    del dataset, model, state, step
    torch.cuda.empty_cache()
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


def _plain_flash_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """The flash dispatch on the plain version, on the card: query-blocked, so
    N = 65536 never builds an N x N matrix (dense attention would)."""
    return attention.flash_fwd_reference(qt, kt, vt)[0]


def phase_vae512_serve(checkpoint: str) -> dict:
    """``reconstruct`` and ``sample_prior`` at 512² from the checkpoint
    vae512_train wrote (B = 4): each call's CUDA graph against the same call
    eager (bit-equal and the generators equal, cuDNN deterministic, as
    chain_graph), the flash launches of one graphed request of each by
    (D, C), and the images against the same weights and noise with every
    flash site on the plain version (swapped here, not in the package)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    b = VAE512_SERVE_BATCH
    torch.cuda.reset_peak_memory_stats()
    model = load_conv_vae(checkpoint, device="cuda")
    if model.image_size != 512:
        raise RuntimeError(f"vae512_serve: the checkpoint is {model.image_size}²")
    x01 = _nchw(np.stack([synthesize_image(i, 512)[0] for i in range(b)])).cuda()
    eps = torch.from_numpy(np.random.default_rng(SEED + 80).standard_normal(
        (b, model.latent_dim)).astype(np.float32)).cuda()
    seed = SEED + 81

    def gen():
        return torch.Generator("cuda").manual_seed(seed)

    with torch.inference_mode():
        cases = {
            "reconstruct": _chain_graph_case(
                lambda g: reconstruct(model, x01, eps),
                lambda g: vae_laion._reconstruct(model, x01, eps),
                vae_laion._RECONSTRUCT.counts, 1, seed),
            "sample_prior": _chain_graph_case(
                lambda g: sample_prior(model, b, g),
                lambda g: model.decode(torch.randn(b, model.latent_dim, generator=g,
                                                   device="cuda")),
                vae_laion._SAMPLE_PRIOR.counts, 1, seed)}
        # One graphed request of each, its launches counted.
        _reset_launches()
        recon = reconstruct(model, x01, eps)
        prior = sample_prior(model, b, gen())
        torch.cuda.synchronize()
        launches, by_width = _launches(), _launches_by_width()
        kernel_flash_t = attention._flash_t
        attention._flash_t = _plain_flash_t
        try:
            recon_plain = vae_laion._reconstruct(model, x01, eps)
            prior_plain = model.decode(torch.randn(b, model.latent_dim, generator=gen(),
                                                   device="cuda"))
            torch.cuda.synchronize()
        finally:
            attention._flash_t = kernel_flash_t
    torch.backends.cudnn.deterministic = deterministic
    problems = []
    want = {"flash_fwd (4, 32)": 1, "flash_fwd (8, 64)": 3, "flash_fwd (16, 128)": 2}
    if by_width != want or launches != {**{k: 0 for k in launches}, "flash_fwd": 6}:
        problems.append(f"launches {launches}, by width {by_width}, want {want}")
    gaps = {}
    for name, got, plain in (("reconstruct", recon, recon_plain),
                             ("sample_prior", prior, prior_plain)):
        if tuple(got.shape) != (b, 3, 512, 512) or not torch.isfinite(got).all():
            problems.append(f"{name}: shape {tuple(got.shape)} or non-finite values")
        elif got.min().item() < 0.0 or got.max().item() > 1.0:
            problems.append(f"{name} leaves [0, 1]")
        gaps[name] = (got - plain).abs().max().item()
        if not gaps[name] <= CARD_VS_CPU_ATOL:
            problems.append(f"{name}: kernels vs plain {gaps[name]} > {CARD_VS_CPU_ATOL}")
        c = cases[name]
        if not (c["bit_equal"] and c["generator_equal"] and c["counts"]["captures"] >= 1
                and c["counts"]["replays"] >= 1):
            problems.append(f"{name}: graph vs eager {c}")
    fields = {"checkpoint_image_size": model.image_size, "batch": b, "cases": cases,
              "launches": launches, "launches_by_width": by_width,
              "kernels_vs_plain_max_abs": gaps, "atol": CARD_VS_CPU_ATOL,
              "recon_l1_to_input": (recon - x01).abs().mean().item(),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "cudnn_deterministic": True}
    del model, recon, prior, recon_plain, prior_plain
    torch.cuda.empty_cache()
    if problems:
        raise RuntimeError(f"vae512_serve: {problems}: {fields}")
    emit("vae512_serve", **fields)
    return fields


def _profile_window(name: str, fn, expect_flash: int = 0, sessions: int = 3, warm: int = 1,
                    **fields) -> None:
    """Device time by kernel over one warm call of ``fn`` (after ``warm``
    calls: a sampler's first request captures its chain, its second its
    decode's graph), the device's busy share of the window, and the flash
    kernels' device time in it.
    ``expect_flash``: the flash kernel launches the call makes; a session
    whose flash events fall short is taken again, up to ``sessions`` in all
    (CUPTI does not always hand over a later session's kernel records), so
    every site comes from one session."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_ms = 1e3 * (time.perf_counter() - t0)
        # Device-side events only: CPU ops would count their kernels twice, and
        # so would a user annotation's range on the device (``Optimizer.step#...``).
        kernels = {
            ev.key: (ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)
        }
        counts.append(sum(n for k, (_, n) in kernels.items() if "flash_" in k))
        if counts[-1] >= expect_flash:
            break
    else:
        raise RuntimeError(f"profile {name}: {counts} flash events in {sessions} sessions, "
                           f"{expect_flash} launched in each")
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    # The host's launch calls: one a kernel when eager, one a graph when replayed.
    host_launches = {ev.key: ev.count for ev in prof.key_averages()
                     if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                   "cuLaunchKernelEx", "cudaGraphLaunch")}
    flash = {k: (ms, n) for k, (ms, n) in kernels.items() if "flash_" in k}
    flash_ms = sum(ms for ms, _ in flash.values())
    emit("profile", window=name, window_ms=window_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / window_ms, kernel_launches=sum(n for _, n in kernels.values()),
         host_launch_calls=host_launches, flash_ms=flash_ms,
         flash_share_of_busy=flash_ms / busy_ms if busy_ms else None,
         flash=[{"kernel": k[:120], "ms": ms, "calls": n} for k, (ms, n) in sorted(flash.items())],
         sessions=len(counts),
         top=[{"kernel": k[:90], "ms": ms, "calls": n} for k, (ms, n) in top], **fields)


def _profile_vae512_steps() -> None:
    """3 replayed conv-VAE steps at 512² (B = 4, a seeded init, the set on
    the card), float32 and bfloat16, as vae512_train takes them: four flash
    sites, a forward, a backward and its dq sum each, 12 flash kernels a
    step (``vae512_train_steps_graph``, ``vae512_train_bf16_steps_graph``)."""
    images = np.random.default_rng(SEED + 30).integers(0, 256, (4 * 3, 512, 512, 3),
                                                        dtype=np.uint8)
    data = DeviceDataset(images, 4, seed=SEED, device="cuda", u8_normalize=(1.0 / 255.0, 0.0))
    idxs = data.epoch_index_batches(0)
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        torch.manual_seed(SEED)
        model = vae_laion.ConvVAE(image_size=512, dtype=dtype).cuda().train()
        state = vae_laion.create_train_state(
            model, vae_laion.make_optimizer(model, 1e-4, capturable=True), SEED)
        step = vae_laion.make_conv_vae_resident_step(
            PerceptualNet(seed=123, dtype=dtype).cuda(), 1.0, 10.0, data)
        _profile_window(f"vae512_train{tag}_steps_graph", lambda: step(state, idxs),
                        expect_flash=3 * 12, steps=3, batch=4, image_size=512,
                        compute_dtype=str(dtype).split(".")[1])
        del model, state, step
        torch.cuda.empty_cache()


def phase_profile() -> None:
    """Sixteen windows: one warm reconstruct + one prior decode of the
    conv-VAE, replayed from their graphs and eager (``vae_requests_eager``);
    5 warm UNet28 train steps (batch 128, bfloat16, fused q_sample), eager
    and then replayed from a CUDA graph over a resident set; 20 steps
    of the fp32 DDPM sampler (16 samples) and the chain of one DPM++-15
    serving request (CFG, bf16 forward, 16 samples), each replayed from its
    graphs and eager (``_eager``); 3 warm conv-VAE train
    steps (256x256, batch 4, fp32, Adam) from ``vae_laion_best``, eager and
    replayed from a graph over a resident set, and the same replayed steps in
    bfloat16 (all flash sites from one profiler session); the replayed steps
    at 512², float32 and bfloat16 (``_profile_vae512_steps``); 5 latent
    MLP UNet train steps replayed from a graph; one DPM++-15 latent serving
    request on the DiT, replayed and eager."""
    model = load_conv_vae(CHECKPOINT, device="cuda")
    x01, eps, gen = _requests(model)
    _profile_window("vae_requests", lambda: (reconstruct(model, x01, eps),
                                             sample_prior(model, N_PRIOR, gen)), warm=2)
    # The same requests eager, as the port ran them before their graphs.
    x01_card, eps_card = x01.cuda(), eps.cuda()

    def vae_eager():
        with torch.inference_mode():
            vae_laion._reconstruct(model, x01_card, eps_card)
            model.decode(torch.randn(N_PRIOR, model.latent_dim, generator=gen, device="cuda"))

    _profile_window("vae_requests_eager", vae_eager)

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
    _profile_window("sampler_steps_eager", lambda: sampler.eager(sample_gen), steps=20)

    # One DPM++-15 serving request's chain, as generate.py runs it (CFG 2.0 at
    # doubled batch, the bf16 forward, the EMA shadow; n = 16).
    cfg = load_pixel_checkpoint(CFG_CHECKPOINT, "cuda")
    serve = make_sampler(cfg["model"], cfg["schedule"], (SERVE_N, 1, 28, 28), conditional=True,
                         method="dpmpp", sample_steps=15, guidance_scale=2.0,
                         null_label=NULL_LABEL, compute_dtype=torch.bfloat16)
    y7 = torch.full((SERVE_N,), 7, dtype=torch.int64, device="cuda")
    _profile_window("serve_dpmpp15", lambda: serve(sample_gen, params=cfg["params"], y=y7),
                    steps=15, n=SERVE_N)
    _profile_window("serve_dpmpp15_eager",
                    lambda: serve.eager(sample_gen, params=cfg["params"], y=y7), steps=15,
                    n=SERVE_N)

    conv_vae = load_conv_vae(CHECKPOINT, device="cuda")
    vae_state = vae_laion.create_train_state(conv_vae, vae_laion.make_optimizer(conv_vae, 1e-4),
                                             SEED)
    vae_step = vae_laion.make_conv_vae_train_step(PerceptualNet().cuda(), 1.0, 10.0)
    x = _nchw(np.stack([synthesize_image(i, 256)[0] for i in range(4)])).cuda()
    _profile_window("vae_train_steps", lambda: [vae_step(vae_state, x) for _ in range(3)],
                    steps=3, batch=4)

    # The same 3 steps as the default run takes them: the set on the card and
    # each step a replay of one captured graph (the warm-up call captures).
    graph_vae = _conv_vae(torch.float32)
    graph_vae_state = vae_laion.create_train_state(
        graph_vae, vae_laion.make_optimizer(graph_vae, 1e-4, capturable=True), SEED)
    vae_images = np.random.default_rng(SEED + 29).integers(0, 256, (4 * 3, 256, 256, 3),
                                                            dtype=np.uint8)
    vae_data = DeviceDataset(vae_images, 4, seed=SEED, device="cuda",
                             u8_normalize=(1.0 / 255.0, 0.0))
    vae_graph_step = vae_laion.make_conv_vae_resident_step(PerceptualNet().cuda(), 1.0, 10.0,
                                                           vae_data)
    vae_idxs = vae_data.epoch_index_batches(0)
    _profile_window("vae_train_steps_graph", lambda: vae_graph_step(graph_vae_state, vae_idxs),
                    steps=3, batch=4)

    # The same 3 steps in bfloat16, model and perceptual net, as
    # ``vae_train_bf16``'s run builds them: the bf16 flash kernels at the three
    # sites, a forward and a backward (and its dq sum) each, 9 flash launches a
    # step.
    bf16_vae = _conv_vae(torch.bfloat16)
    bf16_vae_state = vae_laion.create_train_state(
        bf16_vae, vae_laion.make_optimizer(bf16_vae, 1e-4, capturable=True), SEED)
    bf16_vae_step = vae_laion.make_conv_vae_resident_step(
        PerceptualNet(seed=123, dtype=torch.bfloat16).cuda(), 1.0, 10.0, vae_data)
    _profile_window("vae_train_bf16_steps_graph",
                    lambda: bf16_vae_step(bf16_vae_state, vae_idxs), expect_flash=3 * 9,
                    steps=3, batch=4, compute_dtype="bfloat16")
    _profile_vae512_steps()

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
                    n=SERVE_N, warm=2)
    _profile_window("latent_serve_dpmpp15_eager", lambda: latent_serve.eager(sample_gen, y7),
                    steps=15, n=SERVE_N)


def _kernel_widths(fields: dict, kernel: str) -> dict[str, int]:
    """A phase's launches of ``kernel`` by (D, C)."""
    return {k.split(" ", 1)[1]: n for k, n in fields["launches_by_width"].items()
            if k.split(" ", 1)[0] == kernel}


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
    t_start = _last_emit[0] = time.perf_counter()
    os.chdir(REPO)  # the committed latent sidecars name their VAE from the repo root
    device = phase_device()
    phase_build()
    phase_bf16_layers()
    sites = phase_kernel()
    bf16_sites = phase_kernel(torch.bfloat16)
    _reset_launches()
    launches = phase_slice()
    if qsample.qsample_launches != 0:
        raise RuntimeError("the conv-VAE serving path launched the q_sample kernel")
    qsample_site = phase_qsample_kernel()
    # The synthetic MNIST cache, kept for fid_mnist.
    data_dir = tempfile.TemporaryDirectory()
    data_root = data_dir.name
    trains = [phase_train(dtype, data_root) for dtype in ("bfloat16", "float32")]
    train_host = phase_train("bfloat16", data_root, placement="host")
    cond = phase_cond_train(data_root)
    phase_vae_mnist_train(data_root)
    latents = {backbone: phase_latent_train(backbone, data_root)
               for backbone in LATENT_CHECKPOINTS}
    phase_laion_loader()
    # One LAION record cache at 256² for the LAION runs, filled by the first
    # (cold: each record fetched and encoded), read warm by the later ones.
    laion_records = tempfile.TemporaryDirectory()
    laion = phase_laion_train(laion_records.name)
    phase_resident_parity()
    phase_resident_restore()
    phase_cond_parity()
    phase_latent_parity()
    phase_laion_parity()
    dp = phase_dp()
    tp = phase_tp()
    phase_unet_parity()
    phase_train_step_bf16()
    phase_sample()
    phase_serve()
    phase_latent_serve()
    phase_laion_serve(laion_records.name)
    chain_graph = phase_chain_graph()
    phase_fid_mnist(data_root)
    data_dir.cleanup()
    fid_laion = phase_fid_laion()
    phase_torch_import()
    # The pretrained seams at their published widths, on synthetic weights:
    # CLIP-L's files in a temporary directory (0.47 GiB), never in the tree.
    with tempfile.TemporaryDirectory() as clip_dir:
        write_synthetic_clip(clip_dir, CLIP_SEED)
        clip = phase_clip_encode(clip_dir)
        sd_codec = phase_sdvae_codec()["codec"]
        sd_train = phase_laion_sd_train(sd_codec, clip, laion)
        sd_launches = sd_train["qsample_launches"]
        phase_laion_sd_serve(sd_train["model"], sd_train["schedule"], sd_codec, clip["encoder"])
        del sd_train, clip
        phase_laion_clip_run(clip_dir, laion_records.name)
    laion_records.cleanup()
    bwd_sites = phase_flash_bwd_kernel()
    bwd_bf16_sites = phase_flash_bwd_kernel(torch.bfloat16)
    phase_flash_autograd()
    # One record cache a conv-VAE image size: the first run of a size fills
    # it, the later ones read it warm.
    vae_records = tempfile.TemporaryDirectory()
    cache = {size: os.path.join(vae_records.name, str(size)) for size, _ in VAE_RUNS}
    vae = phase_vae_train(cache_dir=cache[256])
    phase_vae_train("host", cache_dir=cache[256])
    vae_bf16 = phase_vae_train("auto", "bfloat16", cache_dir=cache[256])
    phase_vae_resident_parity()
    phase_vae_resident_full()
    phase_vae_train_parity()
    # The conv-VAE at 512²: every attention site on the flash path, dec_attn0
    # on the (16, 128) kernels; the float32 run's checkpoint served after.
    with tempfile.TemporaryDirectory() as vae512_dir:
        vae512 = phase_vae_train("auto", "float32", image_size=512, checkpoint_dir=vae512_dir,
                                 cache_dir=cache[512])
        vae512_bf16 = phase_vae_train("auto", "bfloat16", image_size=512, cache_dir=cache[512])
        vae512_serve = phase_vae512_serve(os.path.join(vae512_dir, "vae_laion_best"))
    # The conv-VAE at 1024²: enc_attn0 at N = 262144, which the backward's
    # O(N) dq scratch lets train on the card.
    vae1024 = phase_vae_train("auto", "float32", image_size=1024, cache_dir=cache[1024])
    vae1024_bf16 = phase_vae_train("auto", "bfloat16", image_size=1024, cache_dir=cache[1024])
    vae_records.cleanup()
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
            # The LAION FID tool's conv-VAE rows, at B = 32.
            "launches_fid_laion": fid_laion["launches"]["flash_fwd"],
            # The 512² run and serving requests, by (D, C).
            "launches_vae512_train": _kernel_widths(vae512, "flash_fwd"),
            "launches_vae1024_train": _kernel_widths(vae1024, "flash_fwd"),
            "launches_vae512_serve": _kernel_widths(vae512_serve, "flash_fwd"),
            # chain_graph's float32 conv-VAE requests (3 each: an eager first,
            # then a capture and replays).
            "launches_chain_graph": _chain_graph_flash(chain_graph, "flash_fwd"),
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
            # The LAION run, at (8, 4096): its train steps and val passes;
            # and the LAION steps on the SD codec's latents, the same shape.
            "launches_laion_run": laion["qsample_launches"],
            "launches_laion_sd_train": sd_launches,
            # The data-parallel graph steps at world size 1 (dp), each run's.
            "launches_dp": {k: dp[k]["qsample_launches_dp_run"] for k in ("unet28", "mlp_unet")},
            # The tensor-parallel steps at (1, 2): each rank's, by dtype; the
            # latent denoisers' by model and dtype.
            "launches_tp": {d: tp[d]["qsample_launches"] for d in TP_DTYPES},
            "launches_tp_latent": {m: {d: tp[m][d]["qsample_launches"] for d in TP_DTYPES}
                                   for m in TP_LATENT_MODELS},
            "max_abs_err": max([qsample_site["max_abs_err"]]
                               + [s["max_abs_err"] for s in qsample_site["latent_sites"]]),
            **{k: qsample_site[k] for k in keys + (
                "roofline_share", "device_us", "graph_us", "graph_floor_us")},
            # The main site (128, 784) above; the latent step's (128, 20), a
            # ragged (128, 18) and the LAION step's (8, 4096) here.
            "latent_sites": qsample_site["latent_sites"],
        },
        {
            "name": "flash_bwd",
            "route": "cuda",
            "source": "tinydiffusion_torch/ops/csrc/flash_bwd.cu",
            "replaces": "tinydiffusion_tpu/ops/attention.py:193",
            # The default conv-VAE run (resident, graph replays).
            "launches": vae["launches"]["flash_bwd"],
            "launches_vae512_train": _kernel_widths(vae512, "flash_bwd"),
            "launches_vae1024_train": _kernel_widths(vae1024, "flash_bwd"),
            "max_abs_err": max(s["max_abs_err"] for s in bwd_sites),
            **{k: bwd_sites[0][k] for k in flash_keys},  # N = 16384
            "sites": [{k: v for k, v in s.items() if k not in context} for s in bwd_sites],
        },
        # The bfloat16 kernels, launched by the bf16 conv-VAE run.
        {
            "name": "flash_fwd_bf16",
            "route": "cuda",
            "dtype": "bfloat16",
            "source": "tinydiffusion_torch/ops/csrc/flash_fwd_bf16.cu",
            "replaces": "tinydiffusion_tpu/ops/attention.py:113",
            "launches": vae_bf16["launches"]["flash_fwd_bf16"],
            "launches_vae512_train": _kernel_widths(vae512_bf16, "flash_fwd_bf16"),
            "launches_vae1024_train": _kernel_widths(vae1024_bf16, "flash_fwd_bf16"),
            # chain_graph's bfloat16 conv-VAE serving requests.
            "launches_chain_graph": _chain_graph_flash(chain_graph, "flash_fwd_bf16"),
            "max_abs_err": max(s["max_abs_err"] for s in bf16_sites),
            **{k: bf16_sites[0][k] for k in flash_keys},  # N = 16384
            "sites": [{k: v for k, v in s.items() if k not in context} for s in bf16_sites],
        },
        {
            "name": "flash_bwd_bf16",
            "route": "cuda",
            "dtype": "bfloat16",
            "source": "tinydiffusion_torch/ops/csrc/flash_bwd_bf16.cu",
            "replaces": "tinydiffusion_tpu/ops/attention.py:193",
            "launches": vae_bf16["launches"]["flash_bwd_bf16"],
            "launches_vae512_train": _kernel_widths(vae512_bf16, "flash_bwd_bf16"),
            "launches_vae1024_train": _kernel_widths(vae1024_bf16, "flash_bwd_bf16"),
            "max_abs_err": max(s["max_abs_err"] for s in bwd_bf16_sites),
            **{k: bwd_bf16_sites[0][k] for k in flash_keys},  # N = 16384
            "sites": [{k: v for k, v in s.items() if k not in context} for s in bwd_bf16_sites],
        },
    ]
    if args.profile:
        phase_profile()
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"phase": "phase_seconds", **PHASE_SECONDS}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
