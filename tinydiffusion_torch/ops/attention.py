"""Unscaled flash attention for the conv-VAE's spatial self-attention.

Counterpart of ``tinydiffusion_tpu/ops/attention.py``. Semantics are the
same: logits are NOT scaled by 1/sqrt(d) (the reference's
``softmax(Q K^T) V``), and the two entry layouts are kept:

- ``flash_attention_unscaled``: q, k (B, N, D), v (B, N, C) -> (B, N, C);
- ``flash_attention_unscaled_t``: qt, kt (B, D, N), vt (B, C, N) -> (B, C, N),
  the layout ``SelfAttention2D`` produces from an NCHW map with no copy.

Dispatch, as in JAX: dense attention when ``N <= 1024`` or when N is not a
multiple of ``DEFAULT_BLOCK_Q``/``DEFAULT_BLOCK_K`` (the TPU kernel's tiles);
the flash forward otherwise. The CUDA kernel tiles itself and takes any N.

The flash forward is ``flash_fwd``: on a CUDA tensor it launches the
hand-written kernel ``csrc/flash_fwd.cu`` (which replaces the TPU's
``_fwd_kernel``) and counts the launch in ``flash_fwd_launches``; on a CPU
tensor it runs the plain version ``flash_fwd_reference``. There is no
fallback from one to the other. This slice serves only, so the kernel has
no backward yet: ``flash_fwd`` refuses inputs that require a gradient.
"""

from __future__ import annotations

import ctypes

import torch

from tinydiffusion_torch.ops import _build

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 1024
_DENSE_N_THRESHOLD = 1024  # below this, dense attention is faster + simpler

# (D, C) head widths the CUDA kernel is instantiated for: the conv-VAE's
# d = C // 8 at the attention widths that take the flash path at 256x256
# (C = 128 sees N = 1024 there, which is dense).
KERNEL_HEAD_WIDTHS = frozenset({(4, 32), (8, 64)})

# Launches of the CUDA kernel since import (or since a caller reset it).
flash_fwd_launches = 0


def flash_fwd_reference(
    qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, block_q: int = 512
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(out_t, lse)`` in float32.

    out_t (B, C, N) = unscaled softmax(Q K^T) V, lse (B, 1, N) = the row
    log-sum-exp of the logits. Computed over blocks of ``block_q`` queries,
    so N = 16384 never builds an N x N matrix.
    """
    qt, kt, vt = (x.float() for x in (qt, kt, vt))
    b, _, n = qt.shape
    out_t = torch.empty(b, vt.shape[1], n, dtype=torch.float32, device=qt.device)
    lse = torch.empty(b, 1, n, dtype=torch.float32, device=qt.device)
    for i in range(0, n, block_q):
        s = torch.matmul(qt[:, :, i:i + block_q].transpose(1, 2), kt)  # (B, bq, N)
        row_lse = torch.logsumexp(s, dim=-1)  # (B, bq)
        p = torch.exp(s - row_lse[..., None])
        out_t[:, :, i:i + block_q] = torch.matmul(vt, p.transpose(1, 2))  # (B, C, bq)
        lse[:, 0, i:i + block_q] = row_lse
    return out_t, lse


def _check_operands(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> None:
    if qt.dim() != 3 or kt.dim() != 3 or vt.dim() != 3:
        raise ValueError("flash_fwd takes qt, kt (B, D, N) and vt (B, C, N)")
    if qt.shape != kt.shape or vt.shape[0] != qt.shape[0] or vt.shape[2] != qt.shape[2]:
        raise ValueError(
            f"flash_fwd shape mismatch: qt {tuple(qt.shape)}, kt {tuple(kt.shape)}, "
            f"vt {tuple(vt.shape)}"
        )
    if not (qt.device == kt.device == vt.device):
        raise ValueError("flash_fwd operands lie on different devices")


def flash_fwd(
    qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: ``(out_t (B, C, N), lse (B, 1, N) float32)``.

    A CUDA tensor launches the CUDA kernel, which takes contiguous float32
    operands with (D, C) in ``KERNEL_HEAD_WIDTHS`` and raises on anything
    else. A CPU tensor runs ``flash_fwd_reference``.
    """
    global flash_fwd_launches
    _check_operands(qt, kt, vt)
    if qt.device.type == "cpu":
        out_t, lse = flash_fwd_reference(qt, kt, vt)
        return out_t.to(vt.dtype), lse
    if qt.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, not {qt.device}")
    for name, x in (("qt", qt), ("kt", kt), ("vt", vt)):
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA flash_fwd kernel takes float32; {name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the CUDA flash_fwd kernel takes contiguous operands; {name} is not")
    if torch.is_grad_enabled() and (qt.requires_grad or kt.requires_grad or vt.requires_grad):
        raise RuntimeError("the CUDA flash_fwd kernel has no backward yet; call it without grad")
    b, d, n = qt.shape
    c = vt.shape[1]
    if (d, c) not in KERNEL_HEAD_WIDTHS:
        raise ValueError(
            f"the CUDA flash_fwd kernel is built for (D, C) in {sorted(KERNEL_HEAD_WIDTHS)}, "
            f"not ({d}, {c})"
        )
    if b > 65535:  # the batch is the kernel grid's y dimension
        raise ValueError(f"the CUDA flash_fwd kernel takes B <= 65535, not {b}")
    lib = _build.library()
    out_t = torch.empty(b, c, n, dtype=torch.float32, device=qt.device)
    lse = torch.empty(b, 1, n, dtype=torch.float32, device=qt.device)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        rc = lib.tdt_flash_fwd_f32(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out_t.data_ptr(), lse.data_ptr(),
            b, n, d, c, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc}")
    flash_fwd_launches += 1
    return out_t, lse


def _dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(logits, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def _dense_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """Dense attention in the transposed (B, *, N) layout."""
    logits = torch.matmul(qt.float().transpose(1, 2), kt.float())  # (B, N, M)
    attn = torch.softmax(logits, dim=-1)
    return torch.matmul(vt.float(), attn.transpose(1, 2)).to(vt.dtype)  # (B, C, N)


def _use_dense(n: int) -> bool:
    block_q = min(DEFAULT_BLOCK_Q, n)
    block_k = min(DEFAULT_BLOCK_K, n)
    return n <= _DENSE_N_THRESHOLD or n % block_q != 0 or n % block_k != 0


def flash_attention_unscaled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unscaled softmax(q k^T) v, q/k (B, N, D), v (B, N, C) -> (B, N, C)."""
    if _use_dense(q.shape[1]):
        return _dense(q, k, v)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out_t, _ = flash_fwd(qt, kt, vt)
    return out_t.transpose(1, 2)


def flash_attention_unscaled_t(
    qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor
) -> torch.Tensor:
    """``flash_attention_unscaled`` in the kernel's native layout:
    qt/kt (B, D, N), vt (B, C, N) -> (B, C, N)."""
    if _use_dense(qt.shape[-1]):
        return _dense_t(qt, kt, vt)
    out_t, _ = flash_fwd(qt, kt, vt)
    return out_t
