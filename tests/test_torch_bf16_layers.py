"""The port's bfloat16 layers round where flax's do, on the CPU.

A flax module of ``dtype=bfloat16`` rounds at fixed points: after a
product, again after its bias; after each op of ``jax.nn.silu`` and
``jax.nn.gelu``; after each of the resize's two products. The port's layers
(``nn.layers``, ``nn.resize``) compute in their ``dtype`` at the same
points, so that the same seeded bf16 inputs, weights and cotangents give
the same outputs and input gradients as JAX's layer run eagerly, up to a
one-ulp flip where two float32 sums add in another order.

The yardstick is JAX run eagerly, which rounds where flax's code says.
Under ``jit`` XLA fuses a BatchNorm's ops and rounds them elsewhere
(``test_jax_jit_rounds_conv_bn_relu_apart_from_eager``), a choice the port
cannot follow and a TPU's compiler would make differently again.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from tinydiffusion_tpu.models.dit import TransformerBlock as JaxTransformerBlock
from tinydiffusion_tpu.models.mlp_unet import _DenseBNRelu as JaxDenseBNRelu
from tinydiffusion_tpu.nn.layers import ConvBNRelu as JaxConvBNRelu
from tinydiffusion_tpu.nn.layers import TimeEmbedMLP as JaxTimeEmbedMLP
from tinydiffusion_tpu.nn.resize import resize_bilinear_align_corners as jax_resize
from tinydiffusion_torch.io.from_jax import jax_variables
from tinydiffusion_torch.models.dit import TransformerBlock
from tinydiffusion_torch.models.mlp_unet import DenseBNRelu
from tinydiffusion_torch.nn.layers import Conv2d, ConvBNRelu, Linear, TimeEmbedMLP, computing_in
from tinydiffusion_torch.nn.resize import align_corners_matrix, resize_bilinear_align_corners

BF16 = torch.bfloat16
# A layer's bound: at most this share of its outputs and of its input
# gradients differ from JAX's eager layer. Against the fused bias (26 %) and
# F.interpolate's resize (45-51 %) the share is the discriminating number.
MAX_SHARE = 1e-3
# The most a differing element may be off, in bf16 ulps of the larger value
# (of the product, for a conv's or dense's output): one ulp at each of the
# output's two rounding points (the product, the bias), and up to 4 where a
# float32 sum of many terms cancels to a small value (a conv's input
# gradient) and the two float32 summation orders part by more than the
# result's ulp.
MAX_ULPS = 2


def _ulp(scale: np.ndarray) -> np.ndarray:
    """One bf16 ulp at ``scale`` (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(scale, 2.0 ** -126))) - 7)


def gap(port: torch.Tensor, ref, pre: torch.Tensor | None = None) -> tuple[float, float]:
    """(share of elements that differ, most bf16 ulps apart) of two bf16
    arrays. An ulp is taken at the larger of the two values, or of ``pre``,
    the magnitude of the last rounded value before a sum (a product before
    its bias): a one-ulp flip there is many ulps of a small sum."""
    a = port.detach().float().numpy()
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.maximum(np.abs(a), np.abs(b))
    if pre is not None:
        scale = np.maximum(scale, np.abs(pre.detach().float().numpy()))
    diff = np.abs(a - b)
    return float((diff > 0).mean()), float((diff / _ulp(scale)).max())


def assert_rounds_as_jax(name: str, port: torch.Tensor, ref, max_share=MAX_SHARE,
                         max_ulps=MAX_ULPS, pre: torch.Tensor | None = None):
    share, ulps = gap(port, ref, pre)
    print(f"{name}: {share * 100:.4f} % differ, at most {ulps:g} ulp")
    assert share <= max_share and (max_ulps is None or ulps <= max_ulps), (name, share, ulps)


def bf16(rng: np.random.Generator, shape, scale=1.0) -> np.ndarray:
    """Seeded values already on the bf16 grid (float32 arrays)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(BF16).float().numpy()


def to_port(x: np.ndarray, nchw: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2) if nchw else x))
    return t.to(BF16).requires_grad_()


def to_jax(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(x).astype(jnp.bfloat16)


def from_nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def flax_variables(module: torch.nn.Module) -> dict:
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in jax_variables(module).items()})


def jax_eager(fn, inputs, cotangent):
    """(outputs, input gradients) of ``fn`` run op by op (no jit)."""
    out, vjp = jax.vjp(fn, *inputs)
    return out, vjp(cotangent)


def port_run(module, inputs, cotangent_nhwc: np.ndarray, nchw: bool = False):
    """``module``'s output and input gradients, computing in bfloat16 as the
    train steps run it (``computing_in``)."""
    cot = torch.from_numpy(np.ascontiguousarray(
        cotangent_nhwc.transpose(0, 3, 1, 2) if nchw else cotangent_nhwc)).to(BF16)
    with computing_in(module, BF16):
        out = module(*inputs)
        out.backward(cot)
    return out, [x.grad for x in inputs]


# --- the conv and the dense: the bias after the product ----------------------


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_affine_rounds_as_flax(kind):
    """A 3x3 conv 128 -> 128 at (16, 14, 14), and a dense 256 -> 256 over
    (64, 256) rows, with torch's nonzero default bias: flax rounds the
    product, then adds the bias in bf16."""
    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    if kind == "conv":
        layer = Conv2d(128, 128, 3, padding=1, dtype=BF16)
        flax_layer = flax_nn.Conv(128, (3, 3), padding=1, dtype=jnp.bfloat16)
        shape, nchw = (16, 14, 14, 128), True
    else:
        layer = Linear(256, 256, dtype=BF16)
        flax_layer = flax_nn.Dense(256, dtype=jnp.bfloat16)
        shape, nchw = (64, 256), False
    x, cot = bf16(rng, shape), bf16(rng, shape)
    variables = flax_variables(layer)
    ref, (ref_grad,) = jax_eager(lambda x: flax_layer.apply(variables, x), [to_jax(x)],
                                 to_jax(cot))
    xt = to_port(x, nchw)
    out, (grad,) = port_run(layer, [xt], cot, nchw)
    assert out.dtype == BF16 and layer.weight.dtype == torch.float32
    back = from_nhwc if nchw else (lambda t: t)
    with torch.no_grad():
        product = layer.product(xt.detach(), layer.weight.to(BF16))
    assert_rounds_as_jax(f"{kind} out", back(out), ref, pre=back(product))
    assert_rounds_as_jax(f"{kind} input grad", back(grad), ref_grad, max_ulps=4)
    # The weight's gradient reaches the float32 parameter through the cast,
    # rounded to bf16 first as JAX's does.
    ref_params = jax.vjp(lambda p: flax_layer.apply({"params": p}, to_jax(x)),
                         variables["params"])[1](to_jax(cot))[0]
    kernel = layer.weight.grad.permute(2, 3, 1, 0) if nchw else layer.weight.grad.T
    assert_rounds_as_jax(f"{kind} kernel grad", kernel, ref_params["kernel"])
    # The bias's gradient is the cotangent summed over the broadcast axes.
    # XLA's CPU backend sums a bf16 broadcast's transpose in bf16 (each add
    # rounded, windows of 32); the port sums in float32 and rounds once.
    rows = torch.from_numpy(cot.reshape(-1, cot.shape[-1])).to(BF16)
    assert torch.equal(layer.bias.grad, rows.float().sum(0).to(BF16).float())
    share, _ = gap(layer.bias.grad, ref_params["bias"])
    print(f"{kind} bias grad against XLA's bf16 sum: {share * 100:.1f} % differ")


def test_the_fused_bias_rounds_apart_from_flax():
    """The teeth: the bias added inside the product (one rounding, as
    ``F.conv2d(x, w, b)`` does) parts from flax in a large share."""
    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    layer = Conv2d(128, 128, 3, padding=1, dtype=BF16)
    x = bf16(rng, (16, 14, 14, 128))
    ref = flax_nn.Conv(128, (3, 3), padding=1, dtype=jnp.bfloat16).apply(
        flax_variables(layer), to_jax(x))
    with torch.no_grad():
        fused = torch.nn.functional.conv2d(to_port(x, True), layer.weight.to(BF16),
                                           layer.bias.to(BF16), padding=1)
    share, _ = gap(from_nhwc(fused), ref)
    print(f"fused bias: {share * 100:.2f} % differ")
    assert share > 0.1


# --- the resizes: JAX's two products -----------------------------------------

# The UNet28's five size pairs and the LatentUNet's three.
RESIZE_PAIRS = [(4, 8), (7, 8), (14, 16), (28, 32), (32, 28), (8, 16), (16, 32), (4, 8)]


@pytest.mark.parametrize("n_in,n_out", RESIZE_PAIRS,
                         ids=[f"{a}-{b}" + ("-latent" if i >= 5 else "")
                              for i, (a, b) in enumerate(RESIZE_PAIRS)])
def test_resize_rounds_as_jax(n_in, n_out):
    rng = np.random.default_rng(n_in * 100 + n_out)
    x, cot = bf16(rng, (8, n_in, n_in, 64)), bf16(rng, (8, n_out, n_out, 64))
    ref, (ref_grad,) = jax_eager(lambda x: jax_resize(x, (n_out, n_out)), [to_jax(x)],
                                 to_jax(cot))
    m = torch.from_numpy(align_corners_matrix(n_in, n_out))
    xt = to_port(x, True)
    out = resize_bilinear_align_corners(xt, m, m)
    out.backward(torch.from_numpy(np.ascontiguousarray(cot.transpose(0, 3, 1, 2))).to(BF16))
    assert_rounds_as_jax(f"resize {n_in}->{n_out} out", from_nhwc(out), ref, max_ulps=1)
    assert_rounds_as_jax(f"resize {n_in}->{n_out} input grad", from_nhwc(xt.grad), ref_grad,
                         max_ulps=1)


def test_interpolate_rounds_apart_from_jax():
    """The teeth: ``F.interpolate`` in bfloat16 (exact coefficients, one
    rounding) parts from JAX's products in a large share."""
    rng = np.random.default_rng(708)
    x = bf16(rng, (8, 7, 7, 64))
    ref = jax_resize(to_jax(x), (8, 8))
    with torch.no_grad():
        out = torch.nn.functional.interpolate(to_port(x, True), size=(8, 8), mode="bilinear",
                                              align_corners=True)
    share, _ = gap(from_nhwc(out), ref)
    print(f"F.interpolate: {share * 100:.1f} % differ")
    assert share > 0.3


def test_resize_equals_interpolate_in_float32():
    """In float32 the two products are ``F.interpolate``'s resize."""
    x = torch.randn(4, 8, 7, 7, generator=torch.Generator().manual_seed(0))
    m = torch.from_numpy(align_corners_matrix(7, 8))
    want = torch.nn.functional.interpolate(x, size=(8, 8), mode="bilinear", align_corners=True)
    torch.testing.assert_close(resize_bilinear_align_corners(x, m, m), want,
                               atol=1e-6, rtol=1e-6)


# --- the blocks ---------------------------------------------------------------


def _conv_bn_relu(rng):
    torch.manual_seed(0)
    block = ConvBNRelu(64, 64, dtype=BF16).train()
    x, cot = bf16(rng, (16, 14, 14, 64)), bf16(rng, (16, 14, 14, 64))
    return block, JaxConvBNRelu(64, dtype=jnp.bfloat16), x, cot


def _with_running_stats(block: ConvBNRelu, rng) -> ConvBNRelu:
    """``block`` with running statistics of a trained model (mean ~0.3,
    variance ~2) and a scale and bias away from their init."""
    bn = block.bn
    with torch.no_grad():
        for t, low, high in ((bn.running_mean, -1.0, 1.0), (bn.running_var, 0.5, 4.0),
                             (bn.weight, 0.5, 1.5), (bn.bias, -0.5, 0.5)):
            t.copy_(torch.from_numpy(rng.uniform(low, high, t.shape).astype(np.float32)))
    return block


def test_conv_bn_relu_train_rounds_as_flax():
    block, jax_block, x, cot = _conv_bn_relu(np.random.default_rng(2))
    variables = flax_variables(block)

    def f(x):
        y, _ = jax_block.apply(variables, x, train=True, mutable=["batch_stats"])
        return y

    ref, (ref_grad,) = jax_eager(f, [to_jax(x)], to_jax(cot))
    out, (grad,) = port_run(block, [to_port(x, True)], cot, nchw=True)
    assert_rounds_as_jax("ConvBNRelu out", from_nhwc(out), ref)
    # The BatchNorm's input gradient is two paths, each rounded to bf16 and
    # then added (flax's two converts of x); they nearly cancel, so a float32
    # summation-order difference in the statistics' reductions (XLA's CPU
    # backend sums in windows of 32, in order) flips one path's rounding in
    # ~0.15 % of elements, by many ulps of the small sum, and the conv's
    # backward spreads each flip over its 3x3 neighbours: ~1 %.
    assert_rounds_as_jax("ConvBNRelu input grad", from_nhwc(grad), ref_grad,
                         max_share=0.015, max_ulps=None)


def test_conv_bn_relu_eval_rounds_as_flax():
    """Eval mode (serving): torch's one batch-norm kernel normalises with the
    running statistics in float32 and rounds once, as flax's ops do."""
    rng = np.random.default_rng(6)
    block, jax_block, x, cot = _conv_bn_relu(rng)
    block = _with_running_stats(block, rng).eval()
    variables = flax_variables(block)
    ref, (ref_grad,) = jax_eager(lambda x: jax_block.apply(variables, x, train=False),
                                 [to_jax(x)], to_jax(cot))
    xt = to_port(x, True)
    out, (grad,) = port_run(block, [xt], cot, nchw=True)
    # A one-ulp flip of the conv's bf16 output (float32 summation order)
    # comes out scaled by the BatchNorm's multiplier: its ulp is taken at the
    # conv's output in the block's output units.
    bn = block.bn
    with torch.no_grad():
        mul = (bn.weight * torch.rsqrt(bn.running_var + bn.eps)).abs()
        pre = block.conv(xt.detach()).float().abs() * mul[:, None, None]
    assert_rounds_as_jax("ConvBNRelu eval out", from_nhwc(out), ref, pre=from_nhwc(pre))
    assert_rounds_as_jax("ConvBNRelu eval input grad", from_nhwc(grad), ref_grad, max_ulps=4)


def test_jax_jit_rounds_conv_bn_relu_apart_from_eager():
    """JAX's own jitted block parts from its eager one: XLA fuses the
    BatchNorm and rounds it elsewhere. The eager run is the yardstick."""
    block, jax_block, x, _ = _conv_bn_relu(np.random.default_rng(2))
    variables = flax_variables(block)

    def f(x):
        return jax_block.apply(variables, x, train=True, mutable=["batch_stats"])[0]

    eager, jitted = f(to_jax(x)), jax.jit(f)(to_jax(x))
    share, _ = gap(torch.from_numpy(np.asarray(eager.astype(jnp.float32))), jitted)
    print(f"JAX jit vs eager ConvBNRelu: {share * 100:.2f} % differ")
    assert share > 0.01


@pytest.mark.parametrize("normalize", [None, 1000.0], ids=["raw", "dit"])
def test_time_embed_mlp_rounds_as_flax(normalize):
    torch.manual_seed(0)
    mlp = TimeEmbedMLP(256, normalize=normalize, dtype=BF16)
    rng = np.random.default_rng(3)
    t = rng.integers(0, 1000, 64)
    cot = bf16(rng, (64, 256))
    variables = flax_variables(mlp)
    jax_mlp = JaxTimeEmbedMLP(256, normalize=normalize, dtype=jnp.bfloat16)
    ref = jax_mlp.apply(variables, jnp.asarray(t))
    # The input is an integer: the gradient to hold is fc1's weight's.
    ref_params = jax.vjp(lambda p: jax_mlp.apply({"params": p}, jnp.asarray(t)),
                         variables["params"])[1](to_jax(cot))[0]
    out = mlp(torch.from_numpy(t))
    out.backward(torch.from_numpy(cot).to(BF16))
    assert_rounds_as_jax("TimeEmbedMLP out", out, ref)
    assert_rounds_as_jax("TimeEmbedMLP fc1 kernel grad", mlp.fc1.weight.grad.T,
                         ref_params["fc1"]["kernel"], max_share=5e-3, max_ulps=1)


@pytest.mark.parametrize("tokens", [1, 4])
def test_transformer_block_rounds_as_flax(tokens):
    """The DiT's block in eval mode: flax's attention (q/k/v/out with their
    biases, q over sqrt(head_dim) in bf16, jax.nn.softmax), the exact GELU
    and the LayerNorms, at one token (the reference's) and at four."""
    torch.manual_seed(0)
    block = TransformerBlock(256, 4, 1024).eval()
    rng = np.random.default_rng(4)
    x, cot = bf16(rng, (32, tokens, 256)), bf16(rng, (32, tokens, 256))
    variables = flax_variables(block)
    jax_block = JaxTransformerBlock(256, 4, 1024, dtype=jnp.bfloat16)
    ref, (ref_grad,) = jax_eager(lambda x: jax_block.apply(variables, x, train=False),
                                 [to_jax(x)], to_jax(cot))
    out, (grad,) = port_run(block, [to_port(x)], cot)
    assert_rounds_as_jax(f"TransformerBlock S={tokens} out", out, ref, max_ulps=8)
    # Two LayerNorms' backward, as the BatchNorm's (see ConvBNRelu).
    assert_rounds_as_jax(f"TransformerBlock S={tokens} input grad", grad, ref_grad,
                         max_share=0.01, max_ulps=None)


def test_dense_bn_relu_train_rounds_as_flax():
    """The MLP UNet's ``Dense -> BatchNorm -> ReLU`` block in train mode."""
    torch.manual_seed(0)
    block = DenseBNRelu(512, 256).train()
    rng = np.random.default_rng(5)
    x, cot = bf16(rng, (128, 512)), bf16(rng, (128, 256))
    variables = flax_variables(block)
    jax_block = JaxDenseBNRelu(256, dtype=jnp.bfloat16)

    def f(x):
        return jax_block.apply(variables, x, train=True, mutable=["batch_stats"])[0]

    ref, (ref_grad,) = jax_eager(f, [to_jax(x)], to_jax(cot))
    out, (grad,) = port_run(block, [to_port(x)], cot)
    assert_rounds_as_jax("DenseBNRelu out", out, ref)
    # The BatchNorm's two paths, as in ConvBNRelu, without a conv to spread
    # the flips.
    assert_rounds_as_jax("DenseBNRelu input grad", grad, ref_grad, max_share=2e-3,
                         max_ulps=None)
