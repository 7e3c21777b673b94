"""The port's flash attention (tinydiffusion_torch/ops/attention.py) against the
JAX package's (tinydiffusion_tpu/ops/attention.py), on the CPU.

On a CPU tensor the port's ``flash_fwd`` runs its plain version
``flash_fwd_reference``; the JAX ``_flash`` / ``_fwd`` run their Pallas
kernels in interpret mode, as the JAX package's own tests do. The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinydiffusion_tpu.ops import attention as jax_attention
from tinydiffusion_torch.ops import _build, attention

# Both sides float32; the JAX kernel's bf16x3 logit products carry ~4e-6
# relative logit error, which exp turns into ~1e-4 on the outputs: the JAX
# package's own flash-vs-dense tolerance (tests/test_flash_attention.py).
ATOL, RTOL = 2e-4, 5e-4
# The dense dispatch is the same einsum/softmax on both sides.
DENSE_ATOL, DENSE_RTOL = 1e-5, 1e-5


# Every (D, C) the conv-VAE's attention reaches (d = C // 8 at C = 32, 64, 128):
# the widths the CUDA kernels are built for.
HEAD_WIDTHS = [(4, 32), (8, 64), (16, 128)]


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


@pytest.mark.parametrize("d,c", HEAD_WIDTHS)
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


@pytest.mark.parametrize("d,c", HEAD_WIDTHS)
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


# --- the backward ---------------------------------------------------------------

# The JAX package's own flash-gradient bar (tests/test_flash_attention.py):
# its backward kernel's bf16x3 logits against the port's float32.
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
# The Function against autograd of the port's own dense attention, both
# float32 torch on the CPU: only the order of the sums differs.
SAME_ATOL, SAME_RTOL = 1e-5, 1e-5


@pytest.mark.parametrize("d,c", HEAD_WIDTHS)
def test_flash_bwd_matches_jax_bwd(d, c):
    """The plain backward (what a CPU tensor runs) against JAX's ``_bwd``
    (its fused Pallas kernel in interpret mode) on JAX's own residuals."""
    q, k, v = _qkv(2, 2048, d, c, seed=20 + d)
    qt, kt, vt = (jnp.asarray(_t(x)) for x in (q, k, v))
    g = np.random.default_rng(30 + d).standard_normal((2, c, 2048)).astype(np.float32)
    out_t, lse = jax_attention._fwd(qt, kt, vt, 512, 1024)
    want = jax_attention._bwd(512, 1024, (qt, kt, vt, out_t, lse), jnp.asarray(g))
    port = [torch.from_numpy(np.array(x)) for x in (qt, kt, vt, out_t, lse)]
    delta = (torch.from_numpy(g) * port[3]).sum(1, keepdim=True)
    got = attention.flash_bwd(*port[:3], torch.from_numpy(g), port[4], delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("entry", ["bnd", "bdn"])
@pytest.mark.parametrize("d,c", HEAD_WIDTHS)
def test_flash_grads_match_jax_grad(entry, d, c, monkeypatch):
    """Gradients through both entry points (the autograd Function over
    ``flash_fwd`` and ``flash_bwd``) against ``jax.grad`` of JAX's ``_flash``
    and ``flash_attention_unscaled_t``, at N = 2048: flash on both sides."""
    q, k, v = _qkv(2, 2048, d, c, seed=40 + d)
    g = np.random.default_rng(50 + d).standard_normal((2, 2048, c)).astype(np.float32)

    def no_dense(*args):
        raise AssertionError("flash dispatch expected")

    calls = []
    flash_bwd = attention.flash_bwd
    monkeypatch.setattr(attention, "_dense", no_dense)
    monkeypatch.setattr(attention, "_dense_t", no_dense)
    monkeypatch.setattr(attention, "flash_bwd", lambda *a: calls.append(1) or flash_bwd(*a))
    if entry == "bnd":
        args, g_in = (q, k, v), g
        jax_fn = lambda *a: jax_attention._flash(*a, 512, 1024)  # noqa: E731
        port_fn = attention.flash_attention_unscaled
    else:
        args, g_in = tuple(_t(x) for x in (q, k, v)), _t(g)
        jax_fn = jax_attention.flash_attention_unscaled_t
        port_fn = attention.flash_attention_unscaled_t
    want = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * g_in), argnums=(0, 1, 2))(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    (port_fn(*leaves) * torch.from_numpy(g_in)).sum().backward()
    assert calls == [1]
    for name, leaf, b in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_flash_function_matches_autograd_of_dense_attention():
    """N = 256 (which the dispatch sends dense): the Function's gradients
    against autograd through the port's ``_dense_t``."""
    qt, kt, vt = (torch.from_numpy(_t(x)) for x in _qkv(2, 256, 4, 32, seed=60))
    g = torch.from_numpy(np.random.default_rng(61).standard_normal((2, 32, 256))
                         .astype(np.float32))
    grads = []
    for fn in (attention._FlashT.apply, attention._dense_t):
        leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
        out = fn(*leaves)
        (out * g).sum().backward()
        grads.append((out.detach(), [x.grad for x in leaves]))
    (out_f, grads_f), (out_d, grads_d) = grads
    torch.testing.assert_close(out_f, out_d, atol=SAME_ATOL, rtol=SAME_RTOL)
    for a, b in zip(grads_f, grads_d):
        torch.testing.assert_close(a, b, atol=SAME_ATOL, rtol=SAME_RTOL)


def test_cpu_backward_runs_the_plain_version_and_counts_no_launch():
    qt, kt, vt = (torch.from_numpy(_t(x)) for x in _qkv(1, 2048, 4, 32, seed=62))
    out, lse = attention.flash_fwd(qt, kt, vt)
    dot = torch.randn_like(out)
    delta = (dot * out).sum(1, keepdim=True)
    before = attention.flash_bwd_launches
    got = attention.flash_bwd(qt, kt, vt, dot, lse, delta)
    want = attention.flash_bwd_reference(qt, kt, vt, dot, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert attention.flash_bwd_launches == before


def test_backward_reference_chunking_does_not_change_the_result():
    qt, kt, vt = (torch.from_numpy(_t(x)) for x in _qkv(1, 1000, 4, 32, seed=63))
    out, lse = attention.flash_fwd_reference(qt, kt, vt)
    dot = torch.randn_like(out)
    delta = (dot * out).sum(1, keepdim=True)
    a = attention.flash_bwd_reference(qt, kt, vt, dot, lse, delta, block_q=1000)
    b = attention.flash_bwd_reference(qt, kt, vt, dot, lse, delta, block_q=96)  # ragged block
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad", ["dot", "lse", "delta", "device"])
def test_flash_bwd_rejects_mismatched_operands(bad):
    qt, kt, vt = torch.zeros(2, 4, 64), torch.zeros(2, 4, 64), torch.zeros(2, 32, 64)
    dot, lse, delta = torch.zeros(2, 32, 64), torch.zeros(2, 1, 64), torch.zeros(2, 1, 64)
    if bad == "dot":
        dot = torch.zeros(2, 32, 32)
    elif bad == "lse":
        lse = torch.zeros(2, 64)
    elif bad == "delta":
        delta = torch.zeros(1, 1, 64)
    else:
        qt, kt, vt, dot, lse, delta = (x.to("meta") for x in (qt, kt, vt, dot, lse, delta))
    with pytest.raises(ValueError):
        attention.flash_bwd(qt, kt, vt, dot, lse, delta)


# --- _dense_t rounds the weights as JAX does ------------------------------------


def test_bf16_dense_t_rounds_the_weights_like_jax():
    """bf16 q/k/v at N = 1024 (the dense site dec_attn0 of a bf16 model):
    JAX rounds the softmax weights to bf16 before the value product, which
    accumulates in float32. The port's ``_dense_t`` does the same, so the
    bf16 outputs agree but for the few whose float32 sums, taken in another
    order, round across a bf16 boundary. Without the rounding (the old
    expression) ~40 % of the outputs miss by up to a bf16 ulp."""
    q, k, v = _qkv(2, 1024, 4, 32, seed=70)
    qb, kb, vb = (jnp.asarray(_t(x)).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_attention._dense_t(qb, kb, vb).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                  for x in (qb, kb, vb))

    def missed(got: torch.Tensor) -> float:
        """Share of outputs more than half a bf16 ulp (2^-8 relative) off."""
        diff = np.abs(got.float().numpy() - want)
        return float((diff > 2.0**-8 * np.abs(want) + 1e-6).mean())

    got = attention._dense_t(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and missed(got) <= 0.005
    attn = torch.softmax(torch.matmul(tq.float().transpose(1, 2), tk.float()), dim=-1)
    old = torch.matmul(tv.float(), attn.transpose(1, 2)).to(tv.dtype)
    assert missed(old) > 0.1


# --- the CUDA kernels' precision budget and tile constants, on the CPU -----------

def _tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' split (csrc/tf32_mma.cuh::split) in plain torch: hi is x
    rounded to the nearest tf32 (ties away from zero, as cvt.rna) with the low
    13 bits cleared; lo = x - hi is exact, and the tensor core reads only its
    top 19 bits (the low 13 truncated)."""
    bits = x.view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """lo_a hi_b + hi_a lo_b + hi_a hi_b in float32: each product of two tf32
    values is exact in float32, so only the sums round."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


@pytest.mark.parametrize("d,c", HEAD_WIDTHS)
def test_3xtf32_products_keep_float32_accuracy(d, c):
    """The design's precision choice, checked before any card run: the plain
    forward with both products (logits and values) in emulated 3xTF32 stays
    within 1e-5 of the float32 plain version. Inputs as chip_smoke.py draws
    them: q, k ~ N(0, 2 / sqrt(D)), v ~ N(0, 1)."""
    qt, kt, vt = (torch.from_numpy(_t(x)) for x in _qkv(2, 2048, d, c, seed=80 + d))
    s = _matmul_3xtf32(qt.transpose(1, 2).contiguous(), kt)  # (B, N, N)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = _matmul_3xtf32(vt, p.transpose(1, 2).contiguous())  # (B, C, N)
    want_out, want_lse = attention.flash_fwd_reference(qt, kt, vt)
    assert (out - want_out).abs().max().item() <= 1e-5
    assert (lse[:, None] - want_lse).abs().max().item() <= 1e-5
    # One tf32 pass on the values alone is far outside that budget.
    vh, _ = _tf32_split(vt)
    one_pass = torch.matmul(vh, p.transpose(1, 2))
    assert (one_pass - want_out).abs().max().item() > 1e-4


def _bf16_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernels' split (csrc/bf16_mma.cuh::split_bf16) in plain torch:
    hi = x rounded to bf16 (nearest even), lo = x - hi rounded to bf16; the
    tensor core multiplies each plane by a bf16 operand exactly."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


# The card checks' bounds (chip_smoke.py): out within KERNEL_ATOL + one bf16
# ulp, dq, dk, dv within BWD_ATOL + one ulp, dq also two ulps of its largest
# value. The design's rounding must use at most 1/16 of them.
CARD_FWD_ATOL, CARD_BWD_ATOL = 2e-4, 5e-4
PLANES_SHARE_OF_BOUND = 1 / 16


def _share_of_bound(got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    return ((got - want).abs() / (atol + BF16_RTOL * want.abs())).max().item()


@pytest.mark.parametrize("d,c", HEAD_WIDTHS)
def test_bf16_planes_keep_the_card_bounds(d, c):
    """The bf16 kernels' precision choice, checked before any card run: the
    plain forward and backward with P and dS taken as two bf16 planes (and q,
    k, v, dO in bf16, the products float32) stay within 1/16 of the card
    checks' bounds of the unrounded plain version, at N = 2048, B = 2, inputs
    drawn as chip_smoke.py draws them. One plane of P (the TPU's DEFAULT
    precision for the value product) is recorded beside it: it lands outside
    the bounds themselves, so the kernels take two."""
    qt, kt, vt = (torch.from_numpy(_t(x)).to(torch.bfloat16).float()
                  for x in _qkv(2, 2048, d, c, seed=100 + d))
    dot = torch.from_numpy(np.random.default_rng(110 + d).standard_normal(
        (2, c, 2048), np.float32)).to(torch.bfloat16).float()
    s = torch.matmul(qt.transpose(1, 2), kt)  # (B, N, N), exact products
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    ph, pl = _bf16_planes(p)
    out = torch.matmul(vt, p.transpose(1, 2))
    shares = {"out": _share_of_bound(
        torch.matmul(vt, ph.transpose(1, 2)) + torch.matmul(vt, pl.transpose(1, 2)), out,
        CARD_FWD_ATOL)}
    one_plane = {"out": _share_of_bound(torch.matmul(vt, ph.transpose(1, 2)), out,
                                        CARD_FWD_ATOL)}
    delta = (dot * out).sum(1, keepdim=True).transpose(1, 2)  # (B, N, 1)
    ds = p * (torch.matmul(dot.transpose(1, 2), vt) - delta)  # (B, N, N)
    dh, dl = _bf16_planes(ds)
    want = {"dv": torch.matmul(dot, p), "dk": torch.matmul(qt, ds),
            "dq": torch.matmul(kt, ds.transpose(1, 2))}
    got = {"dv": torch.matmul(dot, ph) + torch.matmul(dot, pl),
           "dk": torch.matmul(qt, dh) + torch.matmul(qt, dl),
           "dq": torch.matmul(kt, dh.transpose(1, 2)) + torch.matmul(kt, dl.transpose(1, 2))}
    for name, w in want.items():
        atol = CARD_BWD_ATOL + (2 * 2.0**-8 * w.abs().max().item() if name == "dq" else 0.0)
        shares[name] = _share_of_bound(got[name], w, atol)
    assert max(shares.values()) <= PLANES_SHARE_OF_BOUND, shares
    assert one_plane["out"] > 1.0, one_plane


def _source_constant(name: str, source: str) -> int:
    text = (Path(_build._CSRC) / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, (name, source, found)
    return int(found[0])


def test_wrapper_tile_constants_match_the_kernel_sources():
    """The backward's dq adds are ordered by one counter a (batch row, query
    tile): the wrapper's queries a tile of each dtype
    (FLASH_BWD_QUERIES_PER_TILE by C for float32, FLASH_BWD_BF16_QUERIES_PER_TILE
    for bfloat16) must be its kernel's, or every launch is refused (the
    launcher checks query_tiles) or the counters are sized wrong; its keys
    per block (FLASH_BWD_KEYS_PER_BLOCK, FLASH_BWD_BF16_KEYS_PER_BLOCK) are
    each kernel's kKeysPerBlock."""
    for keys, source in ((attention.FLASH_BWD_KEYS_PER_BLOCK, "flash_bwd.cu"),
                         (attention.FLASH_BWD_BF16_KEYS_PER_BLOCK, "flash_bwd_bf16.cu")):
        assert keys == _source_constant("kKeysPerBlock", source)
    fp32 = (Path(_build._CSRC) / "flash_bwd.cu").read_text()
    found = re.findall(r"constexpr int kBlockQFor = C == 128 \? (\d+) : (\d+);", fp32)
    assert len(found) == 1, found
    at128, other = map(int, found[0])
    assert attention.FLASH_BWD_QUERIES_PER_TILE == {32: other, 64: other, 128: at128}
    assert "if (query_tiles != tiles) return cudaErrorInvalidValue;" in fp32
    bf16 = (Path(_build._CSRC) / "flash_bwd_bf16.cu").read_text()
    assert "constexpr int kBlockQ = kTileTokens;" in bf16
    assert attention.FLASH_BWD_BF16_QUERIES_PER_TILE == _source_constant(
        "kTileTokens", "bf16_mma.cuh")
    assert "if (query_tiles != (n + kBlockQ - 1) / kBlockQ) return cudaErrorInvalidValue;" in bf16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_scratch_is_linear_in_n(dtype):
    """The backward's scratch (``flash_bwd_scratch``, which the wrapper
    allocates and chip_smoke.py reports) holds at most one float32 (B, D, N)
    run sum and one int32 counter a (batch row, query tile), in the order
    the launcher takes them: at the 1024² conv-VAE's sites (B = 4) it is
    at most 0.016 GiB, where per-key-block partials took up to 64 GiB."""
    for d, c in HEAD_WIDTHS:
        for n in (1000, 4096, 65536, 262144):
            scratch = attention.flash_bwd_scratch(dtype, 4, d, n, c)
            assert list(scratch)[-1] == "dq_count"
            tile = (attention.FLASH_BWD_BF16_QUERIES_PER_TILE if dtype == torch.bfloat16
                    else attention.FLASH_BWD_QUERIES_PER_TILE[c])
            assert scratch["dq_count"] == ((4, -(-n // tile)), torch.int32)
            run = 4 * d * n * 4 if dtype == torch.bfloat16 else 0
            assert attention.flash_bwd_scratch_bytes(dtype, 4, d, n, c) == run + 4 * 4 * -(-n // tile)
    sites = {(4, 32): 512**2, (8, 64): 256**2, (16, 128): 128**2}  # 1024² image
    for (d, c), n in sites.items():
        assert attention.flash_bwd_scratch_bytes(dtype, 4, d, n, c) / 2**30 <= 0.016


def test_bwd_kernels_keep_no_per_key_block_partials():
    """Neither backward source keeps the per-key-block dq partials or their
    separate sum kernel; each orders its adds by the counters and zeroes them
    on the stream at every launch (so a CUDA graph's replays start from 0)."""
    for source in ("flash_bwd.cu", "flash_bwd_bf16.cu"):
        text = (Path(_build._CSRC) / source).read_text()
        assert "dq_part" not in text and "dq_sum" not in text, source
        assert re.search(r"wait_count\(counts \+ [\w.]+, kb\)", text), source
        assert re.search(r"release_count\(counts \+ [\w.]+, kb \+ 1\)", text), source
        assert "cudaMemsetAsync(dq_count, 0, counts * sizeof(int), stream)" in text


def test_head_widths_are_the_kernels_widths():
    assert set(HEAD_WIDTHS) == attention.KERNEL_HEAD_WIDTHS


_KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_fwd_bf16.cu", "flash_bwd_bf16.cu")


@pytest.mark.parametrize("source", _KERNEL_SOURCES)
def test_every_wrapper_width_is_instantiated_in_the_kernel_sources(source):
    """Each (D, C) of KERNEL_HEAD_WIDTHS has its ``launch<D, C>`` line and its
    ``_smem_bytes`` case in each of the four kernel sources, and no source
    instantiates a width the wrapper refuses: else a width the wrapper lets
    through would come back as cudaErrorInvalidValue on the card."""
    text = (Path(_build._CSRC) / source).read_text()
    launched = {(int(d), int(c)) for d, c in re.findall(
        r"if \(d == (\d+) && c == (\d+)\) \{?\s*return launch<\1, \2>\(", text)}
    smem = {(int(d), int(c)) for d, c in re.findall(
        r"if \(d == (\d+) && c == (\d+)\) return static_cast<int>\(sizeof\(Smem<", text)}
    assert launched == set(attention.KERNEL_HEAD_WIDTHS), (source, launched)
    assert smem == set(attention.KERNEL_HEAD_WIDTHS), (source, smem)


@pytest.mark.parametrize("d,c", [(2, 16), (16, 64), (8, 128), (32, 256)])
def test_kernel_operand_check_refuses_other_widths(d, c):
    """The card's wrapper raises on a width it has no kernel for (checked
    before any launch, so it runs here on CPU tensors); no fallback."""
    tensors = {"qt": torch.zeros(1, d, 64), "kt": torch.zeros(1, d, 64),
               "vt": torch.zeros(1, c, 64)}
    with pytest.raises(ValueError, match="is built for"):
        attention._check_kernel_operands("flash_fwd", tensors)


@pytest.mark.parametrize("d,c", HEAD_WIDTHS)
def test_kernel_operand_check_takes_every_built_width(d, c):
    tensors = {"qt": torch.zeros(2, d, 64), "kt": torch.zeros(2, d, 64),
               "vt": torch.zeros(2, c, 64)}
    assert attention._check_kernel_operands("flash_fwd", tensors) == (2, d, 64, c)


def test_launch_counts_by_width_follow_captures_and_replays(monkeypatch):
    """A launch counts once by kernel and once by (kernel, D, C); under a
    graph capture both go to ``captured``, and ``count_replays`` of the
    capture's difference (as ``core/graphs.py`` takes it) adds both to the
    launch counts at each replay. The wrapper's counting, without a card."""
    for key in attention.launches_by_width:
        monkeypatch.setitem(attention.launches_by_width, key, 0)
    monkeypatch.setattr(attention, "flash_bwd_launches", 0)
    monkeypatch.setattr(attention, "captured", dict.fromkeys(attention.captured, 0))
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    attention._count_launch("flash_bwd", 16, 128)
    before = dict(attention.captured)
    capturing[0] = True
    attention._count_launch("flash_bwd", 16, 128)
    attention._count_launch("flash_bwd", 4, 32)
    per_replay = {k: n - before[k] for k, n in attention.captured.items()}
    assert per_replay["flash_bwd"] == 2 and per_replay["flash_bwd", 16, 128] == 1
    assert attention.flash_bwd_launches == 1
    attention.count_replays(per_replay, replays=3)
    assert attention.flash_bwd_launches == 1 + 6
    assert attention.launches_by_width["flash_bwd", 16, 128] == 1 + 3
    assert attention.launches_by_width["flash_bwd", 4, 32] == 3
    assert sum(attention.launches_by_width.values()) == attention.flash_bwd_launches


# --- bfloat16 operands -------------------------------------------------------------

# bf16 operands: both sides compute in float32 (a product of two bf16 values is
# exact there) and round where JAX rounds, out, dk and dv once; their float32
# results differ as the float32 ones do (ATOL, GRAD_ATOL), which carries a
# rounding across a bf16 boundary now and then: one bf16 ulp, at most 2^-7
# relative. dq is rounded once per 1024-key block into a bf16 running sum
# whose terms cancel (sum_j ds_ij = 0), so a flip there is an ulp of a block's
# sum: dq is held within two ulps of its largest value.
BF16_RTOL = 2.0**-7
BF16_DQ_ULPS_OF_MAX = 2


def _bf16_pair(*arrays):
    """Each float32 array as a bf16 torch tensor and the same values as a
    bf16 JAX array."""
    port = [torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16) for x in arrays]
    return port, [jnp.asarray(p.float().numpy()).astype(jnp.bfloat16) for p in port]


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("d,c", HEAD_WIDTHS)
def test_bf16_flash_fwd_matches_jax_fwd(d, c):
    """bf16 q/k/v at N = 2048 (B = 2): out in bf16, lse in float32, against
    JAX's ``_fwd`` in interpret mode (its single exact logit pass)."""
    q, k, v = _qkv(2, 2048, d, c, seed=90 + d)
    port, jx = _bf16_pair(*(_t(x) for x in (q, k, v)))
    want_out, want_lse = jax_attention._fwd(*jx, 512, 1024)
    got_out, got_lse = attention.flash_fwd(*port)
    assert got_out.dtype == torch.bfloat16 and want_out.dtype == jnp.bfloat16
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(_f32(got_out), _f32(want_out), atol=ATOL, rtol=BF16_RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d,c", HEAD_WIDTHS)
def test_bf16_flash_bwd_matches_jax_bwd(d, c):
    """The plain bf16 backward against JAX's ``_bwd`` (its fused kernel in
    interpret mode, dq accumulated in bf16 over two 1024-key blocks) on
    JAX's own residuals."""
    q, k, v = _qkv(2, 2048, d, c, seed=100 + d)
    g = np.random.default_rng(110 + d).standard_normal((2, c, 2048)).astype(np.float32)
    (qt, kt, vt, gt), jx = _bf16_pair(*(_t(x) for x in (q, k, v)), g)
    out_t, lse = jax_attention._fwd(*jx[:3], 512, 1024)
    want = jax_attention._bwd(512, 1024, (*jx[:3], out_t, lse), jx[3])
    out = torch.from_numpy(_f32(out_t)).to(torch.bfloat16)
    delta = (gt.float() * out.float()).sum(1, keepdim=True)
    got = attention.flash_bwd(qt, kt, vt, gt, torch.from_numpy(np.array(lse)), delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        ref = _f32(b)
        atol = GRAD_ATOL + (BF16_DQ_ULPS_OF_MAX * 2.0**-8 * np.abs(ref).max()
                            if name == "dq" else 0.0)
        np.testing.assert_allclose(_f32(a), ref, atol=atol, rtol=BF16_RTOL, err_msg=name)


def test_bf16_dq_rounds_once_per_key_block_like_jax():
    """The plain bf16 dq is JAX's: each 1024-key block's float32 dq rounded
    to bf16 and added to the bf16 running dq. Summed in float32 and rounded
    once, it misses JAX's on a share of the elements (N = 4096: four blocks)."""
    q, k, v = _qkv(1, 4096, 4, 32, seed=120)
    g = np.random.default_rng(121).standard_normal((1, 32, 4096)).astype(np.float32)
    (qt, kt, vt, gt), jx = _bf16_pair(*(_t(x) for x in (q, k, v)), g)
    out_t, lse = jax_attention._fwd(*jx[:3], 512, 1024)
    want = _f32(jax_attention._bwd(512, 1024, (*jx[:3], out_t, lse), jx[3])[0])
    out = torch.from_numpy(_f32(out_t)).to(torch.bfloat16)
    stats = (torch.from_numpy(np.array(lse)), (gt.float() * out.float()).sum(1, keepdim=True))
    got = _f32(attention.flash_bwd_reference(qt, kt, vt, gt, *stats)[0])
    once = _f32(attention.flash_bwd_reference(*(x.float() for x in (qt, kt, vt, gt)), *stats)[0]
                .to(torch.bfloat16))
    assert np.mean(got != want) < 0.02
    assert np.mean(once != want) > 0.1


def test_bf16_flash_grads_match_jax_grad():
    """Gradients through ``flash_attention_unscaled_t`` (``_FlashT`` over
    both wrappers) with bf16 leaves against ``jax.grad`` of JAX's, N = 2048."""
    q, k, v = _qkv(2, 2048, 8, 64, seed=130)
    g = np.random.default_rng(131).standard_normal((2, 64, 2048)).astype(np.float32)
    port, jx = _bf16_pair(*(_t(x) for x in (q, k, v)))
    want = jax.grad(
        lambda *a: jnp.sum(jax_attention.flash_attention_unscaled_t(*a).astype(jnp.float32)
                           * g), argnums=(0, 1, 2))(*jx)
    leaves = [x.clone().requires_grad_() for x in port]
    out = attention.flash_attention_unscaled_t(*leaves)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(g)).sum().backward()
    for name, leaf, b in zip(("dq", "dk", "dv"), leaves, want):
        assert leaf.grad.dtype == torch.bfloat16, name
        ref = _f32(b)
        atol = GRAD_ATOL + (BF16_DQ_ULPS_OF_MAX * 2.0**-8 * np.abs(ref).max()
                            if name == "dq" else 0.0)
        np.testing.assert_allclose(_f32(leaf.grad), ref, atol=atol, rtol=BF16_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("bad", ["fwd_mixed", "fwd_float16", "bwd_dot", "bwd_lse", "bwd_delta"])
def test_flash_wrappers_refuse_mixed_dtypes(bad):
    """q, k, v (and dO) in one dtype, float32 or bfloat16; lse and delta float32."""
    qt, kt, vt = torch.zeros(1, 4, 64), torch.zeros(1, 4, 64), torch.zeros(1, 32, 64)
    dot, lse, delta = torch.zeros(1, 32, 64), torch.zeros(1, 1, 64), torch.zeros(1, 1, 64)
    if bad.startswith("fwd"):
        if bad == "fwd_mixed":
            vt = vt.to(torch.bfloat16)
        else:
            qt, kt, vt = (x.to(torch.float16) for x in (qt, kt, vt))
        with pytest.raises(TypeError):
            attention.flash_fwd(qt, kt, vt)
        return
    qt, kt, vt = (x.to(torch.bfloat16) for x in (qt, kt, vt))
    dot = dot.to(torch.bfloat16)
    if bad == "bwd_dot":
        dot = dot.float()
    elif bad == "bwd_lse":
        lse = lse.to(torch.bfloat16)
    else:
        delta = delta.to(torch.bfloat16)
    with pytest.raises(TypeError):
        attention.flash_bwd(qt, kt, vt, dot, lse, delta)


def test_bf16_dq_block_matches_the_kernel_source():
    """The plain bf16 dq rounds per DEFAULT_BLOCK_K keys (JAX's key block);
    the bf16 kernel's dq sum must round per as many (its kDqRunKeys), a whole
    number of its key blocks."""
    run = _source_constant("kDqRunKeys", "flash_bwd_bf16.cu")
    assert attention.DEFAULT_BLOCK_K == run
    assert run % _source_constant("kKeysPerBlock", "flash_bwd_bf16.cu") == 0
    assert run % attention.FLASH_BWD_BF16_KEYS_PER_BLOCK == 0
