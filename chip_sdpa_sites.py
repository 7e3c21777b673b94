#!/usr/bin/env python3
"""Time ``scaled_dot_product_attention`` beside the port's flash kernels at
the conv-VAE sites where ``chip_smoke.py`` takes no library time.

    python3 chip_sdpa_sites.py

On one CUDA card, at B = 4 on ``chip_smoke.py``'s operands: the float32 and
bfloat16 forward and backward at the 1024² sites (enc_attn0 at N = 262144,
(D, C) = (4, 32); enc_attn1 and dec_attn1 at N = 65536, (8, 64)), and the
bfloat16 forward and backward at the 512² enc_attn0 (N = 65536, (4, 32)).
For each: the port's kernel time (``flash_fwd`` or ``flash_bwd``, CUDA
events), its bound (``chip_smoke.flash_bound_ms`` / ``flash_bwd_bound_ms``),
and each SDPA backend (FLASH_ATTENTION, EFFICIENT_ATTENTION,
CUDNN_ATTENTION, MATH) forced alone with ``torch.nn.attention.sdpa_kernel``:
its time, or the error it raises at the shape (MATH is not tried where its
B x N^2 logits, 4 bytes each, pass ``chip_smoke.LIBRARY_MATH_MAX_BYTES``). Then
the same backends with q and k zero-padded to v's width (the same logits,
so the same function), which FLASH and cuDNN need at D = 4. The backward is
timed as ``torch.autograd.grad`` of one forward kept outside the timing.
The card's name and power limit come first; one JSON line a site; the last
line names each site's fastest backend at the shape and padded.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

import chip_smoke
from tinydiffusion_torch.ops import attention

BATCH = 4
# (label, N, D, C, dtype): the sites chip_smoke.py times without a library time.
SITES = (
    ("1024² enc_attn0", 262144, 4, 32, torch.float32),
    ("1024² enc/dec_attn1", 65536, 8, 64, torch.float32),
    ("1024² enc_attn0", 262144, 4, 32, torch.bfloat16),
    ("1024² enc/dec_attn1", 65536, 8, 64, torch.bfloat16),
    ("512² enc_attn0", 65536, 4, 32, torch.bfloat16),
)
BACKENDS = (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
            SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH)


def _iters(n: int, backward: bool) -> int:
    return (2 if backward else 3) if n >= 262144 else (3 if backward else 5)


def _sdpa(q4, k4, v4, backend, backward: bool, g4, n: int) -> dict:
    """One backend's time at these operands, or its error."""
    logits = 4 * q4.shape[0] * n * n
    if backend == SDPBackend.MATH and logits > chip_smoke.LIBRARY_MATH_MAX_BYTES:
        return {"error": f"not tried: MATH's B x N^2 logits, {logits / 1e9:.1f} GB at 4 bytes "
                         "each, pass chip_smoke.LIBRARY_MATH_MAX_BYTES"}
    try:
        with sdpa_kernel([backend]):
            if backward:
                q, k, v = (x.detach().requires_grad_() for x in (q4, k4, v4))
                o = F.scaled_dot_product_attention(q, k, v, scale=1.0)
                ms = chip_smoke.cuda_ms(
                    lambda: torch.autograd.grad(o, (q, k, v), g4, retain_graph=True),
                    iters=_iters(n, True), warmup=1)
                del q, k, v, o
            else:
                ms = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, scale=1.0), iters=_iters(n, False), warmup=1)
        return {"ms": ms}
    except (RuntimeError, torch.OutOfMemoryError) as e:
        return {"error": " ".join(str(e).split())[:300]}
    finally:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _fastest(results: dict) -> dict | None:
    timed = {k: v["ms"] for k, v in results.items() if "ms" in v}
    if not timed:
        return None
    best = min(timed, key=timed.get)
    return {"backend": best, "ms": timed[best]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_sdpa_sites: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    chip_smoke.disable_tf32()
    import numpy as np

    summary = []
    for label, n, d, c, dtype in SITES:
        rng = np.random.default_rng(chip_smoke.SEED)
        qt, kt, vt = (x.to(dtype) for x in chip_smoke._attention_operands(rng, BATCH, n, d, c))
        dot = torch.from_numpy(rng.standard_normal((BATCH, c, n), np.float32)).cuda().to(dtype)
        q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous() for x in (qt, kt, vt))
        g4 = dot.transpose(1, 2).unsqueeze(1).contiguous()
        pad = [0, c - d]
        qp, kp = F.pad(q4, pad), F.pad(k4, pad)
        for backward in (False, True):
            if backward:
                out_t, lse = attention.flash_fwd(qt, kt, vt)
                delta = (dot.float() * out_t.float()).sum(1, keepdim=True)
                kernel_ms = chip_smoke.cuda_ms(
                    lambda: attention.flash_bwd(qt, kt, vt, dot, lse, delta),
                    iters=_iters(n, True))
                bound = chip_smoke.flash_bwd_bound_ms(BATCH, n, d, c, dtype)
                del out_t, lse, delta
            else:
                kernel_ms = chip_smoke.cuda_ms(lambda: attention.flash_fwd(qt, kt, vt),
                                               iters=_iters(n, False))
                bound = chip_smoke.flash_bound_ms(BATCH, n, d, c, dtype)
            torch.cuda.empty_cache()
            at_shape = {b.name: _sdpa(q4, k4, v4, b, backward, g4, n) for b in BACKENDS}
            padded = {b.name: _sdpa(qp, kp, v4, b, backward, g4, n) for b in BACKENDS}
            site = {"site": label, "B": BATCH, "N": n, "D": d, "C": c, "dtype": str(dtype),
                    "direction": "backward" if backward else "forward",
                    "kernel_ms": kernel_ms, "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"], "sdpa_at_shape": at_shape,
                    "sdpa_qk_padded_to_C": padded, "fastest_at_shape": _fastest(at_shape),
                    "fastest_padded": _fastest(padded)}
            print(json.dumps(site), flush=True)
            summary.append({k: site[k] for k in ("site", "dtype", "direction", "kernel_ms",
                                                 "bound_ms", "fastest_at_shape",
                                                 "fastest_padded")})
        del qt, kt, vt, dot, q4, k4, v4, g4, qp, kp
        torch.cuda.empty_cache()
    print(json.dumps({"sites": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
