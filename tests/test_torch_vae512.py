"""The conv-VAE beyond 256x256 against the JAX package, on the CPU.

From 512x512 on, ``dec_attn0`` (C = 128, d = 16) takes the flash path, so the
card runs the (D, C) = (16, 128) kernels there. This file holds:

- that site, ``SelfAttention2D(128)`` on a 64 x 64 map (N = 4096, the 512²
  ``dec_attn0``), port against flax on one set of weights carried across by
  ``io/from_jax.py``: forward and gradients, float32 and bfloat16, both sides
  on their flash paths (JAX's Pallas kernels in interpret mode, the port's
  plain versions on CPU tensors);
- the attention sites of ``ConvVAE`` at 256, 512 and 1024, listed by running
  both packages' models on shapes alone (torch's meta device, ``jax.eval_shape``):
  every site that takes the flash path must have its (D, C) in
  ``attention.KERNEL_HEAD_WIDTHS``, the widths the CUDA kernels are built for.

A whole-model comparison at 512² is out of reach on the CPU: the JAX flash
kernel runs in interpret mode there, and JAX's dense fallback (which its
``SelfAttention2D`` takes when the kernel raises) builds B x 65536² float32
logits at ``enc_attn0``, 17 GB a row. The 64² model tests in
``test_torch_vae_conv.py`` cover the rest of the model.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinydiffusion_tpu.io.checkpoint import _flat_items, _norm_key
from tinydiffusion_tpu.models import vae_conv as jax_vae_conv
from tinydiffusion_tpu.ops import attention as jax_attention
from tinydiffusion_torch.io.from_jax import conv_vae_state_dict
from tinydiffusion_torch.models.vae_conv import ConvVAE, SelfAttention2D
from tinydiffusion_torch.ops import attention

# float32 on both sides: the attention output and the input gradient within
# the port's flash-vs-JAX bounds (tests/test_torch_attention.py: JAX's bf16x3
# logits; CPU: 1e-6 relative). The parameters' gradients sum 8192 positions
# of such terms in different orders: within 2e-5 of the site's largest
# parameter gradient (CPU: 3e-6). The key's bias has no gradient in exact
# arithmetic (the softmax does not see a shift of k), so only that bound
# holds it.
ATOL, RTOL = 2e-4, 5e-4
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
PARAM_GRAD_OF_MAX = 2e-5
# bfloat16 on both sides, compared in float32: the output and the input
# gradient within one bf16 ulp (2^-7 relative) beyond the float32 atol. The
# output gamma * attn + x adds two bf16 terms, so a flip of one ulp in the
# attention term moves a sum that cancels near 0 by that ulp: the output's
# atol is one ulp of the largest attention term (CPU: 2^-11 off at 3 of its
# 1M values, where an ulp of the sum would allow 2^-17), and the input
# gradient's, g plus the attention path's gradient, one ulp of the largest
# of the latter (CPU: 2^-10 off at 6 values). The
# parameters' gradients within two bf16 ulps of the site's largest (CPU:
# within one). gamma's gradient is one bf16 reduction of the 1M products
# attn * g in each framework's own order and rounding (CPU: 27.5 apart at
# 131): not comparable across frameworks, so the float32 case alone holds it.
BF16_RTOL = 2.0**-7
BF16_PARAM_ULPS_OF_MAX = 2


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_attention_128_at_4096_tokens_matches_flax(dtype, monkeypatch):
    """The 512² ``dec_attn0``: C = 128, d = 16, a 64 x 64 map (N = 4096), B = 2,
    gamma 0.6; flax's init carried into the port by ``conv_vae_state_dict``.
    Forward, then the gradients of sum(out * g) in x and in every parameter."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(512)
    b, side, c = 2, 64, 128
    x = rng.standard_normal((b, side, side, c)).astype(np.float32)  # NHWC
    g = rng.standard_normal((b, side, side, c)).astype(np.float32)

    def no_dense(*args):
        raise AssertionError("flash dispatch expected")

    # Both sides on their flash paths: JAX's SelfAttention2D would fall back
    # to dense if its kernel raised; the port's wrapper would take dense at
    # an N it does not tile.
    monkeypatch.setattr(jax_vae_conv, "_dense_attention", no_dense)
    monkeypatch.setattr(attention, "_dense_t", no_dense)
    bwd_calls = []
    flash_bwd = attention.flash_bwd
    monkeypatch.setattr(attention, "flash_bwd", lambda *a: bwd_calls.append(1) or flash_bwd(*a))

    jmodel = jax_vae_conv.SelfAttention2D(use_flash=True, dtype=jdt)
    x_in = jnp.asarray(x).astype(jdt)
    variables = jmodel.init(jax.random.PRNGKey(0), x_in)
    flat, _ = _flat_items(variables)
    flat = {k: (np.full_like(v, 0.6) if k.endswith("/gamma") else np.asarray(v))
            for k, v in flat.items()}
    variables = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat[_norm_key(p)]), variables)

    def loss(v, xx):
        y = jmodel.apply(v, xx)
        return jnp.sum(y.astype(jnp.float32) * g), y

    (_, want), (want_dv, want_dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables, x_in)

    def port_params(tree: dict) -> dict:
        """A flax tree of this site, as the conv-VAE's ``dec_attn0``, through the
        JAX-to-port bridge, keyed by the port module's own names."""
        sd = conv_vae_state_dict({f"params/dec_attn0/{k.split('/', 1)[1]}":
                                  np.asarray(v, np.float32) for k, v in tree.items()})
        return {k.removeprefix("dec_attn.0."): v for k, v in sd.items()}

    model = SelfAttention2D(c, use_flash=True, dtype=tdt)
    model.load_state_dict(port_params(flat))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = model(xt)
    (out.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    assert bwd_calls == [1]
    assert out.dtype == tdt and xt.grad.dtype == tdt

    want_out = np.asarray(want.astype(jnp.float32))
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    if dtype == "bfloat16":
        # The residual's terms as both sides round them: x and g in bf16.
        x16, g16 = (np.asarray(jnp.asarray(a).astype(jdt), np.float32) for a in (x, g))
        atol = max(ATOL, _bf16_ulp(np.abs(want_out - x16).max()))
        grad_atol = max(GRAD_ATOL, _bf16_ulp(np.abs(want_dx - g16).max()))
        rtol = grad_rtol = BF16_RTOL
    else:
        atol, rtol, grad_atol, grad_rtol = ATOL, RTOL, GRAD_ATOL, GRAD_RTOL
    np.testing.assert_allclose(out.detach().float().permute(0, 2, 3, 1).numpy(), want_out,
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(xt.grad.float().permute(0, 2, 3, 1).numpy(), want_dx,
                               atol=grad_atol, rtol=grad_rtol)
    want_params = port_params(_flat_items(want_dv)[0])
    largest = max(w.abs().max().item() for w in want_params.values())
    bound = (BF16_PARAM_ULPS_OF_MAX * _bf16_ulp(largest) if dtype == "bfloat16"
             else PARAM_GRAD_OF_MAX * largest)
    checked = []
    for name, p in model.named_parameters():
        if dtype == "bfloat16" and name == "gamma":
            continue
        np.testing.assert_allclose(p.grad.float().numpy(), want_params[name].numpy(), rtol=0,
                                   atol=bound, err_msg=name)
        checked.append(name)
    assert len(checked) == (6 if dtype == "bfloat16" else 7)


# --- the attention sites of ConvVAE by image size --------------------------------

# (name, D, C, N, path) of each site, from the model's code (both packages,
# vae_conv.py): enc_attn0 and enc_attn1 after encoder stages 0-1 (S/2, S/4),
# dec_attn0 and dec_attn1 after decoder stages 0-1 (S/8, S/4). The flash path
# from N > 1024 on, as both packages' dispatch says.
EXPECTED_SITES = {
    256: [("enc_attn0", 4, 32, 16384, "flash"), ("enc_attn1", 8, 64, 4096, "flash"),
          ("dec_attn0", 16, 128, 1024, "dense"), ("dec_attn1", 8, 64, 4096, "flash")],
    512: [("enc_attn0", 4, 32, 65536, "flash"), ("enc_attn1", 8, 64, 16384, "flash"),
          ("dec_attn0", 16, 128, 4096, "flash"), ("dec_attn1", 8, 64, 16384, "flash")],
    1024: [("enc_attn0", 4, 32, 262144, "flash"), ("enc_attn1", 8, 64, 65536, "flash"),
           ("dec_attn0", 16, 128, 16384, "flash"), ("dec_attn1", 8, 64, 65536, "flash")],
}


def _port_sites(size: int, monkeypatch) -> list[tuple]:
    """The port's ConvVAE at ``size`` run on the meta device (shapes only): each
    attention call's (name, D, C, N) and the path its dispatch took."""
    seen = []
    path = {}

    def record(kind):
        def attend(qt, kt, vt):
            path["last"] = kind
            return torch.empty_like(vt)
        return attend

    monkeypatch.setattr(attention, "_flash_t", record("flash"))
    monkeypatch.setattr(attention, "_dense_t", record("dense"))
    with torch.device("meta"):
        model = ConvVAE(image_size=size)
        x = torch.empty(1, 3, size, size)
        eps = torch.empty(1, model.latent_dim)
    names = {m: name.replace(".", "") for name, m in model.named_modules()
             if isinstance(m, SelfAttention2D)}
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.append((names[m], m.query.weight.shape[0], i[0].shape[1],
                                     i[0].shape[2] * i[0].shape[3], path["last"])))
        for m in names]
    try:
        model(x, eps)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _jax_sites(size: int, monkeypatch) -> list[tuple]:
    """JAX's ConvVAE at ``size`` traced by ``jax.eval_shape`` (nothing is
    computed): each flash call's (D, C, N), in call order."""
    seen = []

    def record(qt, kt, vt):
        seen.append((qt.shape[1], vt.shape[1], vt.shape[2]))
        return vt

    monkeypatch.setattr(jax_attention, "flash_attention_unscaled_t", record)
    jmodel = jax_vae_conv.ConvVAE(image_size=size)
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    variables = jax.eval_shape(lambda a: jmodel.init(jax.random.PRNGKey(0), a,
                                                     jax.random.PRNGKey(1), train=False), x)
    seen.clear()  # init traced the model once
    jax.eval_shape(lambda v, a: jmodel.apply(v, a, jax.random.PRNGKey(1), train=False),
                   variables, x)
    return seen


@pytest.mark.parametrize("size", sorted(EXPECTED_SITES))
def test_every_flash_site_has_a_built_kernel_width(size, monkeypatch):
    """The fault this file guards: a site on the flash path whose (D, C) the
    CUDA kernels lack raises on the card, and a CPU run never sees it (CPU
    tensors take the plain versions). The port's sites are JAX's, in order."""
    sites = _port_sites(size, monkeypatch)
    assert sites == EXPECTED_SITES[size]
    assert [s[1:4] for s in sites] == _jax_sites(size, monkeypatch)
    for name, d, c, n, path in sites:
        if path == "flash":
            assert (d, c) in attention.KERNEL_HEAD_WIDTHS, (size, name, d, c, n)
