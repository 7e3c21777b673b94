"""The port's flash attention (tinydiffusion_torch/ops/attention.py) against the
JAX package's (tinydiffusion_tpu/ops/attention.py), on the CPU.

On a CPU tensor the port's ``flash_fwd`` runs its plain version
``flash_fwd_reference``; the JAX ``_flash`` / ``_fwd`` run their Pallas
kernels in interpret mode, as the JAX package's own tests do. The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinydiffusion_tpu.ops import attention as jax_attention
from tinydiffusion_torch.ops import attention

# Both sides float32; the JAX kernel's bf16x3 logit products carry ~4e-6
# relative logit error, which exp turns into ~1e-4 on the outputs: the JAX
# package's own flash-vs-dense tolerance (tests/test_flash_attention.py).
ATOL, RTOL = 2e-4, 5e-4
# The dense dispatch is the same einsum/softmax on both sides.
DENSE_ATOL, DENSE_RTOL = 1e-5, 1e-5


def _qkv(b, n, d, c, seed):
    """q, k (B, N, D), v (B, N, C) float32, logits of std 2 (extremes ~ +-10)."""
    rng = np.random.default_rng(seed)
    a = (2.0 / d**0.5) ** 0.5
    q = (a * rng.standard_normal((b, n, d))).astype(np.float32)
    k = (a * rng.standard_normal((b, n, d))).astype(np.float32)
    v = rng.standard_normal((b, n, c)).astype(np.float32)
    return q, k, v


def _t(x):
    return np.ascontiguousarray(np.swapaxes(x, 1, 2))


@pytest.mark.parametrize("d,c", [(4, 32), (8, 64)])
def test_flash_entry_points_match_jax_flash(d, c, monkeypatch):
    """N = 2048 with blocks 512/1024 (the port's DEFAULT_BLOCK_Q/K) takes the
    flash path on both sides."""
    q, k, v = _qkv(2, 2048, d, c, seed=d)

    def no_dense(*args):
        raise AssertionError("flash dispatch expected")

    monkeypatch.setattr(attention, "_dense", no_dense)
    monkeypatch.setattr(attention, "_dense_t", no_dense)
    want = np.asarray(jax_attention._flash(*map(jnp.asarray, (q, k, v)), 512, 1024))
    got = attention.flash_attention_unscaled(
        *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    got_t = attention.flash_attention_unscaled_t(
        *(torch.from_numpy(_t(x)) for x in (q, k, v)))
    np.testing.assert_allclose(got_t.numpy(), _t(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d,c", [(4, 32), (8, 64)])
def test_flash_fwd_out_and_lse_match_jax_fwd(d, c):
    q, k, v = _qkv(2, 2048, d, c, seed=10 + d)
    qt, kt, vt = (_t(x) for x in (q, k, v))
    want_out, want_lse = jax_attention._fwd(*map(jnp.asarray, (qt, kt, vt)), 512, 1024)
    got_out, got_lse = attention.flash_fwd(*map(torch.from_numpy, (qt, kt, vt)))
    assert got_out.shape == (2, c, 2048) and got_lse.shape == (2, 1, 2048)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=RTOL)


def test_reference_chunking_does_not_change_the_result():
    qt, kt, vt = (torch.from_numpy(_t(x)) for x in _qkv(1, 1000, 4, 32, seed=3))
    out_a, lse_a = attention.flash_fwd_reference(qt, kt, vt, block_q=1000)
    out_b, lse_b = attention.flash_fwd_reference(qt, kt, vt, block_q=96)  # ragged last block
    torch.testing.assert_close(out_a, out_b, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse_a, lse_b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("entry", ["bnd", "bdn"])
def test_small_n_takes_the_dense_path_like_jax(entry, monkeypatch):
    """N = 256 <= 1024: dense on both sides, and the flash forward is not called."""
    q, k, v = _qkv(2, 256, 4, 32, seed=7)

    def no_flash(*args):
        raise AssertionError("dense dispatch expected")

    monkeypatch.setattr(attention, "flash_fwd", no_flash)
    if entry == "bnd":
        want = np.asarray(jax_attention.flash_attention_unscaled(*map(jnp.asarray, (q, k, v))))
        got = attention.flash_attention_unscaled(*map(torch.from_numpy, (q, k, v))).numpy()
    else:
        args = [_t(x) for x in (q, k, v)]
        want = np.asarray(jax_attention.flash_attention_unscaled_t(*map(jnp.asarray, args)))
        got = attention.flash_attention_unscaled_t(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=DENSE_ATOL, rtol=DENSE_RTOL)


def test_block_misaligned_n_takes_the_dense_path():
    """N = 1536 is not a multiple of block_k = 1024: dense, as in JAX."""
    q, k, v = _qkv(1, 1536, 4, 32, seed=8)
    want = np.asarray(jax_attention.flash_attention_unscaled(*map(jnp.asarray, (q, k, v))))
    calls = attention.flash_fwd_launches
    got = attention.flash_attention_unscaled(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=DENSE_ATOL, rtol=DENSE_RTOL)
    assert attention.flash_fwd_launches == calls


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    qt, kt, vt = (torch.from_numpy(_t(x)) for x in _qkv(1, 2048, 8, 64, seed=9))
    before = attention.flash_fwd_launches
    out, lse = attention.flash_fwd(qt, kt, vt)
    ref_out, ref_lse = attention.flash_fwd_reference(qt, kt, vt)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert attention.flash_fwd_launches == before


@pytest.mark.parametrize(
    "shapes",
    [((2, 4, 64), (2, 4, 32), (2, 32, 64)),   # N differs between q and k
     ((2, 4, 64), (2, 8, 64), (2, 32, 64)),   # D differs between q and k
     ((2, 4, 64), (2, 4, 64), (1, 32, 64)),   # B differs for v
     ((4, 64), (4, 64), (32, 64))],           # not batched
)
def test_flash_fwd_rejects_mismatched_operands(shapes):
    qt, kt, vt = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        attention.flash_fwd(qt, kt, vt)


def test_flash_fwd_raises_on_a_device_it_has_no_path_for():
    """Neither CPU nor CUDA: no silent fallback to the plain version."""
    qt, kt, vt = (torch.empty(s, device="meta") for s in ((1, 4, 64), (1, 4, 64), (1, 32, 64)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention.flash_fwd(qt, kt, vt)
