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
``_fwd_kernel``; tensor cores, every product in 3xTF32, float32-accurate) and
counts the launch in ``flash_fwd_launches``; on a CPU
tensor it runs the plain version ``flash_fwd_reference``. The backward is
``flash_bwd`` in the same way: ``csrc/flash_bwd.cu`` (the TPU's
``_bwd_fused_kernel``), ``flash_bwd_launches``, ``flash_bwd_reference``.

Both take float32 or bfloat16 operands (qt, kt, vt and the output gradient
in one dtype; ``lse`` and ``delta`` always float32) and return outputs in
the operands' dtype, as JAX's kernels do. bfloat16 runs kernels of its own,
``csrc/flash_fwd_bf16.cu`` and ``csrc/flash_bwd_bf16.cu`` (bf16 ``wgmma``),
counted apart (``flash_fwd_bf16_launches``, ``flash_bwd_bf16_launches``):
their logit products are one exact pass, as JAX's are for bf16 inputs, and
their outputs are rounded where JAX rounds them, out once and dq once per
1024-key block. Every launch also counts by (kernel, D, C) in
``launches_by_width``. A launch under a CUDA graph
capture counts in ``captured``, and in the launch counts at each replay of
the graph (``count_replays``).
There is no fallback from a kernel to its plain version. ``_FlashT``, a
``torch.autograd.Function`` (JAX's ``_flash_t`` custom VJP), joins the two:
it saves ``(qt, kt, vt, out_t, lse)`` and its backward computes
``delta = sum_c dO * O`` in torch, outside the kernel, as JAX does. The
dense dispatch is plain torch, and autograd differentiates it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tinydiffusion_torch.ops import _build

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 1024
_DENSE_N_THRESHOLD = 1024  # below this, dense attention is faster + simpler

# (D, C) head widths the CUDA kernels are instantiated for: every width the
# conv-VAE can reach. Its SelfAttention2D sits only on C = 32, 64 and 128
# (d = C // 8); C = 128 (dec_attn0) takes the flash path from 512x512 on.
# Any other width raises on the card: there is no fallback.
KERNEL_HEAD_WIDTHS = frozenset({(4, 32), (8, 64), (16, 128)})

# The operand dtypes the kernels take, and the suffix of each one's launcher.
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

KERNELS = ("flash_fwd", "flash_bwd", "flash_fwd_bf16", "flash_bwd_bf16")
# Launches of the CUDA kernels since import (or since a caller reset them):
# the float32 kernels, and the bfloat16 ones apart.
flash_fwd_launches = 0
flash_bwd_launches = 0
flash_fwd_bf16_launches = 0
flash_bwd_bf16_launches = 0
# The same launches by (kernel, D, C).
launches_by_width = {(k, d, c): 0 for k in KERNELS for d, c in sorted(KERNEL_HEAD_WIDTHS)}
# Launches recorded into a CUDA graph while its stream was captured, by
# kernel and by (kernel, D, C): the graph's owner adds them to the counts
# above at each replay (``count_replays``), as ``ops.qsample`` does for its
# kernel.
captured = {**{k: 0 for k in KERNELS}, **{key: 0 for key in launches_by_width}}


def _count_launch(kernel: str, d: int, c: int) -> None:
    """One launch of ``kernel`` at (d, c): into ``<kernel>_launches`` and
    ``launches_by_width``, or into ``captured`` under a graph capture."""
    if torch.cuda.is_current_stream_capturing():
        captured[kernel] += 1
        captured[kernel, d, c] += 1
    else:
        globals()[f"{kernel}_launches"] += 1
        launches_by_width[kernel, d, c] += 1


def count_replays(per_replay: dict, replays: int = 1) -> None:
    """Add the launches of ``replays`` replays of a CUDA graph into which
    ``per_replay`` launches (a difference of ``captured`` across the
    capture: by kernel, and by (kernel, D, C)) were recorded to the
    ``<kernel>_launches`` counts and to ``launches_by_width``."""
    for key, n in per_replay.items():
        if isinstance(key, tuple):
            launches_by_width[key] += n * replays
        else:
            globals()[f"{key}_launches"] += n * replays

# Keys per block of the backward kernels (``kKeysPerBlock`` in
# csrc/flash_bwd.cu and csrc/flash_bwd_bf16.cu; a test ties them): each key
# block adds its dq partials into dq in key-block order.
FLASH_BWD_KEYS_PER_BLOCK = 64
FLASH_BWD_BF16_KEYS_PER_BLOCK = 128
# Queries a tile of the backward kernels, by C for float32 (``kBlockQFor`` in
# csrc/flash_bwd.cu) and for bfloat16 (``kTileTokens`` in csrc/bf16_mma.cuh;
# a test ties them): one dq counter a (batch row, query tile).
FLASH_BWD_QUERIES_PER_TILE = {32: 64, 64: 64, 128: 32}
FLASH_BWD_BF16_QUERIES_PER_TILE = 64


def flash_bwd_scratch(dtype: torch.dtype, b: int, d: int, n: int, c: int
                      ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The backward kernel's scratch at (B, D, N, C), by the launcher's
    argument names, as ``(shape, dtype)``: ``dq_count``, one int32 counter a
    (batch row, query tile) that orders the key blocks' dq adds; for
    bfloat16 also ``dq_run``, the float32 (B, D, N) sum of a run of
    ``DEFAULT_BLOCK_K`` keys before it is rounded into dq. Float32 dq
    accumulates in the output itself. O(B D N): no (query, key) term."""
    tile = (FLASH_BWD_BF16_QUERIES_PER_TILE if dtype == torch.bfloat16
            else FLASH_BWD_QUERIES_PER_TILE[c])
    scratch = {"dq_count": ((b, -(-n // tile)), torch.int32)}
    if dtype == torch.bfloat16:
        scratch = {"dq_run": ((b, d, n), torch.float32), **scratch}
    return scratch


def flash_bwd_scratch_bytes(dtype: torch.dtype, b: int, d: int, n: int, c: int) -> int:
    """Bytes of ``flash_bwd_scratch(dtype, b, d, n, c)``."""
    return sum(math.prod(shape) * torch.tensor([], dtype=dt).element_size()
               for shape, dt in flash_bwd_scratch(dtype, b, d, n, c).values())


def flash_fwd_reference(
    qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, block_q: int = 512
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(out_t, lse)``, out_t in vt's dtype,
    lse in float32.

    out_t (B, C, N) = unscaled softmax(Q K^T) V, lse (B, 1, N) = the row
    log-sum-exp of the logits, both computed in float32 (a product of two
    bf16 values is exact there) and out_t rounded to vt's dtype once, as
    JAX's ``_fwd_kernel`` does. Computed over blocks of ``block_q`` queries,
    so N = 16384 never builds an N x N matrix.
    """
    dtype = vt.dtype
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
    return out_t.to(dtype), lse


def flash_bwd_reference(
    qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, dot: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, block_q: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: ``(dqt, dkt, dvt)`` in the
    operands' dtype.

    With ``p = exp(q^T k - lse)`` and ``ds = p * (dO^T v - delta)``:
    ``dv = dO p``, ``dk = q ds`` and ``dq = k ds^T`` in the (B, *, N)
    layout, computed in float32. dk and dv are rounded to the dtype once.
    For bfloat16, dq follows JAX's ``_bwd_fused_kernel``, which accumulates
    it in bf16 over its key blocks (``DEFAULT_BLOCK_K`` keys): each block's
    float32 dq is rounded to bf16 and added to the bf16 running dq, rounding
    again. Computed over blocks of ``block_q`` queries, so N = 16384 never
    builds an N x N matrix.
    """
    dtype = qt.dtype
    n = qt.shape[-1]
    qt, kt, vt, dot, lse, delta = (x.float() for x in (qt, kt, vt, dot, lse, delta))
    dqt = torch.empty_like(qt)
    dkt = torch.zeros_like(kt)
    dvt = torch.zeros_like(vt)
    for i in range(0, qt.shape[-1], block_q):
        q_i, do_i = qt[:, :, i:i + block_q], dot[:, :, i:i + block_q]  # (B, D|C, bq)
        s = torch.matmul(q_i.transpose(1, 2), kt)  # (B, bq, N)
        p = torch.exp(s - lse[:, 0, i:i + block_q, None])
        dvt += torch.matmul(do_i, p)  # (B, C, N)
        dp = torch.matmul(do_i.transpose(1, 2), vt)  # (B, bq, N)
        ds = p * (dp - delta[:, 0, i:i + block_q, None])
        dkt += torch.matmul(q_i, ds)  # (B, D, N)
        if dtype == torch.float32:
            dqt[:, :, i:i + block_q] = torch.matmul(kt, ds.transpose(1, 2))  # (B, D, bq)
            continue
        dq = torch.zeros_like(q_i)
        for k0 in range(0, n, DEFAULT_BLOCK_K):
            keys = slice(k0, k0 + DEFAULT_BLOCK_K)
            part = torch.matmul(kt[:, :, keys], ds[:, :, keys].transpose(1, 2))
            dq = (dq + part.to(dtype).float()).to(dtype).float()
        dqt[:, :, i:i + block_q] = dq
    return dqt.to(dtype), dkt.to(dtype), dvt.to(dtype)


def _check_operands(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> None:
    if qt.dim() != 3 or kt.dim() != 3 or vt.dim() != 3:
        raise ValueError("flash attention takes qt, kt (B, D, N) and vt (B, C, N)")
    if qt.shape != kt.shape or vt.shape[0] != qt.shape[0] or vt.shape[2] != qt.shape[2]:
        raise ValueError(
            f"flash attention shape mismatch: qt {tuple(qt.shape)}, kt {tuple(kt.shape)}, "
            f"vt {tuple(vt.shape)}"
        )
    if not (qt.device == kt.device == vt.device):
        raise ValueError("flash attention operands lie on different devices")


def _check_dtypes(name: str, operands: dict[str, torch.Tensor],
                  stats: dict[str, torch.Tensor] | None = None) -> torch.dtype:
    """The dtype rules of both kernels and their plain versions: the
    ``operands`` in one dtype of ``KERNEL_DTYPES``, the ``stats`` (lse,
    delta) float32. Returns the operands' dtype."""
    dtypes = {key: x.dtype for key, x in operands.items()}
    if len(set(dtypes.values())) != 1:
        raise TypeError(f"{name} takes its operands in one dtype, not {dtypes}")
    dtype = next(iter(dtypes.values()))
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 operands, not {dtype}")
    for key, x in (stats or {}).items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} takes {key} in float32, not {x.dtype}")
    return dtype


def _check_kernel_operands(
    name: str, tensors: dict[str, torch.Tensor]
) -> tuple[int, int, int, int]:
    """The CUDA kernels' layout rules; returns (B, D, N, C) of qt and vt."""
    for key, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"the CUDA {name} kernel takes contiguous operands; {key} is not")
    b, d, n = tensors["qt"].shape
    c = tensors["vt"].shape[1]
    if (d, c) not in KERNEL_HEAD_WIDTHS:
        raise ValueError(
            f"the CUDA {name} kernel is built for (D, C) in {sorted(KERNEL_HEAD_WIDTHS)}, "
            f"not ({d}, {c})"
        )
    if b > 65535:  # the batch is the kernel grid's y dimension
        raise ValueError(f"the CUDA {name} kernel takes B <= 65535, not {b}")
    return b, d, n, c


def flash_fwd(
    qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: ``(out_t (B, C, N), lse (B, 1, N) float32)``,
    out_t in the operands' dtype (float32 or bfloat16, one for all three).

    A CUDA tensor launches the CUDA kernel of that dtype, which takes
    contiguous operands with (D, C) in ``KERNEL_HEAD_WIDTHS`` and raises on
    anything else. A CPU tensor runs ``flash_fwd_reference``.
    """
    _check_operands(qt, kt, vt)
    dtype = _check_dtypes("flash_fwd", {"qt": qt, "kt": kt, "vt": vt})
    if qt.device.type == "cpu":
        return flash_fwd_reference(qt, kt, vt)
    if qt.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, not {qt.device}")
    b, d, n, c = _check_kernel_operands("flash_fwd", {"qt": qt, "kt": kt, "vt": vt})
    launcher = getattr(_build.library(), f"tdt_flash_fwd_{KERNEL_DTYPES[dtype]}")
    out_t = torch.empty(b, c, n, dtype=dtype, device=qt.device)
    lse = torch.empty(b, 1, n, dtype=torch.float32, device=qt.device)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        rc = launcher(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out_t.data_ptr(), lse.data_ptr(),
            b, n, d, c, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd ({dtype}) kernel launch failed: cudaError {rc}")
    _count_launch("flash_fwd_bf16" if dtype == torch.bfloat16 else "flash_fwd", d, c)
    return out_t, lse


def flash_bwd(
    qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, dot: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward: ``(dqt, dkt, dvt)`` from the forward's
    operands, the output's gradient ``dot`` (B, C, N), the forward's ``lse``
    and ``delta = sum_c dot * out_t`` (both (B, 1, N) float32). qt, kt, vt
    and dot take one dtype, float32 or bfloat16, which the gradients come
    back in.

    A CUDA tensor launches the CUDA kernel of that dtype, which takes
    contiguous operands with (D, C) in ``KERNEL_HEAD_WIDTHS`` and raises on
    anything else. A CPU tensor runs ``flash_bwd_reference``.
    """
    _check_operands(qt, kt, vt)
    b, _, n = qt.shape
    if tuple(dot.shape) != tuple(vt.shape):
        raise ValueError(f"flash_bwd: dot {tuple(dot.shape)} is not vt's shape {tuple(vt.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (b, 1, n):
            raise ValueError(f"flash_bwd: {name} {tuple(x.shape)} is not {(b, 1, n)}")
    if not (dot.device == lse.device == delta.device == qt.device):
        raise ValueError("flash attention operands lie on different devices")
    dtype = _check_dtypes("flash_bwd", {"qt": qt, "kt": kt, "vt": vt, "dot": dot},
                          {"lse": lse, "delta": delta})
    if qt.device.type == "cpu":
        return flash_bwd_reference(qt, kt, vt, dot, lse, delta)
    if qt.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on cuda or cpu tensors, not {qt.device}")
    b, d, n, c = _check_kernel_operands(
        "flash_bwd", {"qt": qt, "kt": kt, "vt": vt, "dot": dot, "lse": lse, "delta": delta})
    launcher = getattr(_build.library(), f"tdt_flash_bwd_{KERNEL_DTYPES[dtype]}")
    dqt, dkt = torch.empty_like(qt), torch.empty_like(kt)
    dvt = torch.empty_like(vt)
    scratch = [torch.empty(shape, dtype=dt, device=qt.device)
               for shape, dt in flash_bwd_scratch(dtype, b, d, n, c).values()]
    query_tiles = scratch[-1].shape[1]  # dq_count's
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        rc = launcher(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), dot.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dqt.data_ptr(), dkt.data_ptr(), dvt.data_ptr(),
            *(x.data_ptr() for x in scratch), b, n, d, c, query_tiles, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"flash_bwd ({dtype}) kernel launch failed: cudaError {rc}")
    _count_launch("flash_bwd_bf16" if dtype == torch.bfloat16 else "flash_bwd", d, c)
    return dqt, dkt, dvt


class _FlashT(torch.autograd.Function):
    """``out_t = flash_fwd(qt, kt, vt)[0]`` with ``flash_bwd`` as its
    backward: JAX's ``_flash_t`` custom VJP (``_flash_t_fwd`` + ``_bwd``)."""

    @staticmethod
    def forward(ctx, qt, kt, vt):
        out_t, lse = flash_fwd(qt, kt, vt)
        ctx.save_for_backward(qt, kt, vt, out_t, lse)
        return out_t

    @staticmethod
    def backward(ctx, g_t):
        qt, kt, vt, out_t, lse = ctx.saved_tensors
        g_t = g_t.contiguous()
        delta = (g_t.float() * out_t.float()).sum(1, keepdim=True)  # (B, 1, N)
        return flash_bwd(qt, kt, vt, g_t, lse, delta)


def _flash_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    return _FlashT.apply(qt, kt, vt)


def _dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(logits, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def _dense_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """Dense attention in the transposed (B, *, N) layout. As in JAX, the
    weights are rounded to ``vt.dtype`` before the value product, which
    accumulates in float32."""
    logits = torch.matmul(qt.float().transpose(1, 2), kt.float())  # (B, N, M)
    attn = torch.softmax(logits, dim=-1).to(vt.dtype).float()
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
    return _flash_t(qt, kt, vt).transpose(1, 2)


def flash_attention_unscaled_t(
    qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor
) -> torch.Tensor:
    """``flash_attention_unscaled`` in the kernel's native layout:
    qt/kt (B, D, N), vt (B, C, N) -> (B, C, N)."""
    if _use_dense(qt.shape[-1]):
        return _dense_t(qt, kt, vt)
    return _flash_t(qt, kt, vt)
