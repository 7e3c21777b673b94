"""Building blocks with the JAX package's (flax's) semantics.

Counterpart of ``tinydiffusion_tpu/nn/layers.py``: the UNet blocks
(``ConvBNRelu``, ``DoubleConvBlock``, ``TimeEmbedMLP``), ``BatchNorm2d`` and
``BatchNorm1d`` that keep flax's running statistics, flax's ``LayerNorm``,
and the spectral-norm wrapper of the conv-VAE.

A module of flax's ``dtype=`` computes in that dtype while its parameters
stay float32, and rounds where flax's code rounds: ``Conv2d`` and ``Linear``
(torch's, with the default init the JAX package copies) cast the input and
the weight, take the product without the bias and then add the bias cast to
the compute dtype, as flax's ``Conv`` and ``Dense`` do; ``silu``, ``gelu``
and ``softmax`` are the op sequences XLA runs for ``jax.nn.silu``,
``jax.nn.gelu(approximate=False)`` and ``jax.nn.softmax``, each op rounded,
with JAX's backward; the norms are flax's ops. Every such module carries
its ``dtype``; ``computing_in(model, dtype)`` makes all of a model's compute
in another inside a block (the train steps' and the sampler's
``compute_dtype``). Nothing reads ``torch.autocast``, so a model rounds the
same way on the CPU and on a card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.parallel.mesh import all_reduce_sum, apply_full, gather_last


class FlaxDtype:
    """A module that computes in ``self.dtype``, flax's ``dtype=``."""

    dtype: torch.dtype = torch.float32


@contextlib.contextmanager
def computing_in(model: nn.Module, dtype: torch.dtype):
    """Every ``FlaxDtype`` module of ``model`` computes in ``dtype`` inside
    the block, and in its own dtype again after it."""
    modules = [m for m in model.modules() if isinstance(m, FlaxDtype)]
    saved = [m.dtype for m in modules]
    for m in modules:
        m.dtype = dtype
    try:
        yield model
    finally:
        for m, d in zip(modules, saved):
            m.dtype = d


def flax_affine(layer, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """flax's ``Conv``/``Dense`` of ``dtype`` (default ``layer.dtype``): the
    input and the weight cast, the product without the bias, then the bias
    cast and added (a second rounding in bfloat16)."""
    dt = layer.dtype if dtype is None else dtype
    y = layer.product(x.to(dt), weight.to(dt))
    return y if bias is None else y + layer.bias_view(bias.to(dt))


class Conv2d(FlaxDtype, nn.Conv2d):
    """``nn.Conv2d`` as flax's ``Conv`` of ``dtype`` (``flax_affine``); the
    parameters stay float32."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def product(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, weight, None)

    @staticmethod
    def bias_view(bias: torch.Tensor) -> torch.Tensor:
        return bias[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_affine(self, x, self.weight, self.bias)


class Linear(FlaxDtype, nn.Linear):
    """``nn.Linear`` as flax's ``Dense`` of ``dtype`` (``flax_affine``)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    @staticmethod
    def product(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return F.linear(x, weight)

    @staticmethod
    def bias_view(bias: torch.Tensor) -> torch.Tensor:
        return bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_affine(self, x, self.weight, self.bias)


class _Silu(torch.autograd.Function):
    """``jax.nn.silu``: XLA runs ``x * (1 / (1 + exp(-x)))`` rounding after
    each op; the backward is JAX's, ``g * s + (g * x) * (s * (1 - s))``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    return _Silu.apply(x)


def constant(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX casts a constant to the
    operand's dtype; a Python number, so that no tensor is made in a CUDA
    graph's capture."""
    return torch.tensor(value, dtype=dtype).item()


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu(approximate=False)``: ``(0.5 * x) * erfc(-x *
    sqrt(0.5))``, each op rounded, the constants in ``x``'s dtype; the
    backward is the one JAX's autodiff writes (erfc's derivative through
    ``-2/sqrt(pi)`` in ``x``'s dtype)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.sqrt_half = constant(np.sqrt(0.5), x.dtype)
        half_x = 0.5 * x
        u = -x * ctx.sqrt_half
        erfc = torch.special.erfc(u)
        ctx.save_for_backward(half_x, erfc, torch.exp(-(u * u)))
        return half_x * erfc

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        half_x, erfc, gauss = ctx.saved_tensors
        slope = constant(-2.0 / np.sqrt(np.pi), g.dtype)
        through_erfc = ((slope * (half_x * g)) * gauss) * ctx.sqrt_half
        return -through_erfc + 0.5 * (g * erfc)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return _Gelu.apply(x)


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` over the last dim: ``s = exp(x - max)``, the sum
    of ``s`` in float32 rounded to x's dtype, ``s / sum``. The backward is
    the one JAX's autodiff writes, each op rounded in x's dtype:
    ``((g / w) - sum((g * w**-2) * s)) * s``, the sum over the S keys taken
    in order, each add rounded, as XLA sums it: at S = 4 a float32 sum
    rounded once moves 8.6 % of the DiT block's input gradients off JAX's
    (``tests/test_torch_bf16_layers.py``), 0.22 % with the adds rounded. At one
    token, the reference's, there is no add."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        s = torch.exp(x - x.amax(-1, keepdim=True))
        w = s.float().sum(-1, keepdim=True).to(x.dtype)
        ctx.save_for_backward(s, w)
        return s / w

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        s, w = ctx.saved_tensors
        z = (g * torch.reciprocal(w * w)) * s
        total = z[..., :1]
        for k in range(1, z.shape[-1]):
            total = total + z[..., k:k + 1]
        return (g / w - total) * s


def softmax(x: torch.Tensor) -> torch.Tensor:
    return _Softmax.apply(x)


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


def spectral_normalize(
    weight: torch.Tensor, u: torch.Tensor, out_dim: int, eps: float = 1e-12
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flax ``SpectralNorm`` (``n_steps=1``): ``(weight / sigma, new u, sigma)``.

    One power iteration from ``u`` (1, out) on the weight viewed as a
    (-1, out) matrix, as flax views its HWIO kernel. Here the rows come in
    torch's order rather than flax's; a row permutation changes neither the
    power iteration's ``u`` nor sigma.
    """
    n_out = weight.shape[out_dim]
    mat = weight.movedim(out_dim, -1).reshape(-1, n_out)
    # flax stops the gradient through u and v, not through sigma's matrix.
    v = _l2_normalize(u @ mat.detach().T, eps)
    u_new = _l2_normalize(v @ mat.detach(), eps)
    sigma = (v @ mat @ u_new.T)[0, 0]
    return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma)), u_new, sigma


class SpectralNorm(nn.Module):
    """Wraps a ``Conv2d`` or ``ConvTranspose2d``: its weight is divided by a
    power-iteration estimate of its largest singular value on every call.

    ``dtype`` is the wrapped flax conv's: the power iteration and the
    division run on the float32 kernel (flax's ``SpectralNorm`` normalises
    the parameter before the conv sees it), and the conv casts its input,
    the normalised kernel and the bias to ``dtype`` and convolves there.

    Unlike ``torch.nn.utils.spectral_norm`` this repeats flax's arithmetic
    exactly: one iteration per call in train AND eval mode, from the stored
    ``u``, with ``_l2_normalize(x) = x * rsqrt(sum(x^2) + 1e-12)``. ``u`` and
    the estimate ``sigma`` are written back only in train mode (flax's
    ``update_stats=train``). Like flax, nothing reads the stored ``sigma``;
    it is kept so that an exported checkpoint has every key a JAX one has.
    """

    def __init__(self, layer: nn.Conv2d | nn.ConvTranspose2d, eps: float = 1e-12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer = layer
        self.eps = eps
        self.dtype = dtype
        self.transposed = isinstance(layer, nn.ConvTranspose2d)
        # Output channels: dim 0 of a Conv2d weight, dim 1 of a ConvTranspose2d's.
        self.out_dim = 1 if self.transposed else 0
        self.register_buffer("u", torch.randn(1, layer.weight.shape[self.out_dim]))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.layer
        weight, u_new, sigma = spectral_normalize(layer.weight, self.u, self.out_dim, self.eps)
        if self.training:
            self.u.copy_(u_new)
            self.sigma.copy_(sigma.detach())
        dt = self.dtype
        x, weight = x.to(dt), weight.to(dt)
        bias = None if layer.bias is None else layer.bias.to(dt)
        if self.transposed:
            return F.conv_transpose2d(x, weight, bias, layer.stride, layer.padding)
        return F.conv2d(x, weight, bias, layer.stride, layer.padding)


def _move_running_stats(bn: nn.modules.batchnorm._BatchNorm, mean: torch.Tensor,
                        var: torch.Tensor) -> None:
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)


def _batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                dims: tuple[int, ...]) -> torch.Tensor:
    """flax's ``BatchNorm`` over ``dims``, the running statistics moved
    flax's way (see ``BatchNorm2d``).

    Eval mode is torch's one batch-norm kernel: flax normalises with the
    running statistics in float32 and rounds the result once, as the kernel
    does. Train mode follows flax's statistic: its fast variance (the
    default) runs flax's ops (``_flax_train_batch_norm``), whose input
    gradient is also flax's two bf16 paths in bfloat16; its two-pass
    variance (``fast_variance`` false, the conv-VAE's) is the kernel's own
    statistic and runs the kernel (with flax's ops the conv-VAE's bf16 step
    parts farther from JAX's:
    ``tests/test_torch_vae_train.py::test_bf16_train_step_matches_jax``
    holds the kernel, not them). Under data parallelism train mode runs
    flax's ops, over the global batch."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                            bn.eps)
    if bn.fast_variance or bn.data_parallel is not None:
        return _flax_train_batch_norm(bn, x, dims)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=dims, unbiased=False)
    _move_running_stats(bn, mean, var)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


def _flax_train_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                           dims: tuple[int, ...]) -> torch.Tensor:
    """flax's train-mode ``BatchNorm`` in its own ops: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in float32 with the batch
    statistics, the result in x's dtype.

    As in flax, x enters float32 twice, once for the statistics and once for
    ``x - mean``: in bfloat16 the two paths' input gradients round apart and
    add in bfloat16, as JAX's transposed converts do. The statistics are
    flax's fast variance, ``max(0, E[x^2] - E[x]^2)``, or with
    ``bn.fast_variance`` false (flax's ``use_fast_variance=False``, the
    conv-VAE's) the two-pass ``E[(x - E[x])^2]``, from per-channel sums
    taken in float64: in float32 the fast difference loses a few ulps of the
    variance where the mean is large (4 ulps on a variance of 391 in the
    small UNet28's decoder). Under data parallelism (``bn.data_parallel``)
    the sums are summed over the group, in one collective (two for the
    two-pass variance), differentiably (``parallel.mesh.all_reduce_sum``),
    so the batch is the global one and the backward carries the statistics'
    gradient terms of every rank's loss."""
    dp = bn.data_parallel
    xs = x.float()
    c = xs.shape[1]
    count = xs.numel() // c * (1 if dp is None else dp.size)
    shape = [1, c] + [1] * (x.dim() - 2)

    def global_sums(*terms: torch.Tensor) -> torch.Tensor:
        sums = torch.cat([t.sum(dims, dtype=torch.float64) for t in terms])
        return sums if dp is None else all_reduce_sum(sums, dp)

    if bn.fast_variance:
        sums = global_sums(xs, xs * xs)
        mean64 = sums[:c] / count
        var = torch.clamp(sums[c:] / count - mean64 * mean64, min=0.0).float()
        mean = mean64.float()
    else:
        mean = (global_sums(xs) / count).float()
        centred = xs - mean.view(shape)
        var = (global_sums(centred * centred) / count).float()
    _move_running_stats(bn, mean.detach(), var.detach())
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (x.float() - mean.view(shape)) * mul.view(shape) + bn.bias.float().view(shape)
    return y.to(x.dtype)


class BatchNorm2d(FlaxDtype, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax ``BatchNorm(momentum=0.9, epsilon=1e-5)``'s
    running statistics.

    Train mode normalises with the biased batch variance, as both frameworks
    do, but flax also updates ``running_var`` with the biased variance where
    torch uses the unbiased one: at the UNet28's 4x4 bottleneck with a batch
    of 8 the two differ by N/(N-1) = 1.6 %. This class follows flax, so the
    statistics after a step equal the JAX package's:
    ``running = 0.9 * running + 0.1 * batch`` for the mean and the biased
    variance (float32, from a two-pass ``var_mean`` or, in flax's ops, from
    float64 sums). ``num_batches_tracked`` is kept for
    ``state_dict`` compatibility and never advanced (the momentum is fixed).
    ``_batch_norm`` says which modes run torch's batch-norm kernel and which
    flax's ops.

    A bfloat16 input (a flax BatchNorm of ``dtype=bfloat16`` after a bf16
    conv) is normalised with float32 statistics, scale and bias, and the
    output comes back in ``dtype``, as flax's does.
    """

    # The data axis whose global batch train mode normalises over
    # (``parallel.mesh.sync_batch_norm_``); None: this process's batch.
    data_parallel = None

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 fast_variance: bool = True):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.dtype = dtype
        self.fast_variance = fast_variance  # flax's use_fast_variance

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _batch_norm(self, x, (0, 2, 3)).to(self.dtype)


class BatchNorm1d(FlaxDtype, nn.BatchNorm1d):
    """``BatchNorm2d``'s flax statistics over (B, C) features: the MLP UNet's
    ``Dense -> BatchNorm`` blocks."""

    data_parallel = None  # as BatchNorm2d's
    fast_variance = True

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _batch_norm(self, x, (0,)).to(self.dtype)


class LayerNorm(FlaxDtype, nn.LayerNorm):
    """flax ``LayerNorm(epsilon=1e-5)`` over the last dim: the statistics in
    float32 with flax's fast variance, ``max(0, E[x^2] - E[x]^2)``, then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, returned in
    ``dtype``, as a flax module of that dtype does. x enters float32 twice,
    as in ``_flax_train_batch_norm``.

    On the model axis (its scale and bias split, and its input this rank's
    features) the statistics need the whole width: the float32 input is
    gathered for them (``gather_last``; the backward sums each rank's
    float32 partial gradient over the axis), and this rank's features are
    normalised with its slices of scale and bias."""

    model_parallel = None  # as ConvBNRelu's

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-5)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = x.float()
        if self.model_parallel is not None and self.weight.shape[0] < self.normalized_shape[0]:
            xs = gather_last(self.model_parallel, xs, reduce=True)
        mean = xs.mean(-1, keepdim=True)
        var = ((xs * xs).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((x.float() - mean) * mul + self.bias.float()).to(self.dtype)


class ConvBNRelu(nn.Module):
    """``Conv2d(k=3, p=1) -> BatchNorm2d -> ReLU`` on NCHW, in ``dtype``.

    ``forward(*parts)`` convolves the channel concatenation of ``parts``. On
    the model axis (``parallel.mesh.apply_sharding``) each part is this
    rank's channels, the conv holds its slice of output channels and reads
    the whole input (``apply_full``); the BatchNorm and the ReLU work per
    channel, on the slice."""

    # The model axis (``parallel.mesh.ModelParallel``); None: one process.
    model_parallel = None

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size, padding=kernel_size // 2,
                           dtype=dtype)
        self.bn = BatchNorm2d(features, dtype)

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(apply_full(self.model_parallel, self.conv, *parts)))


class DoubleConvBlock(nn.Module):
    """Two stacked ``ConvBNRelu`` at the same width: one UNet stage, on the
    channel concatenation of its inputs."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block1 = ConvBNRelu(in_channels, features, dtype=dtype)
        self.block2 = ConvBNRelu(features, features, dtype=dtype)

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        return self.block2(self.block1(*parts))


class TimeEmbedMLP(FlaxDtype, nn.Module):
    """``Linear(1, D) -> SiLU -> Linear(D, D)`` time embedding in ``dtype``.
    The integer timestep enters as a raw float, as in the reference, or,
    with ``normalize``, divided by it (the DiT's ``t / 1000``).

    As in JAX, t is cast to the compute dtype before the division: in
    bfloat16 t = 999 rounds to 1000 and enters as 1.0. Dividing in float32
    and rounding the quotient would enter another value at 190 of the 1000
    timesteps."""

    model_parallel = None  # as ConvBNRelu's

    def __init__(self, dim: int, normalize: float | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize = normalize
        self.dtype = dtype
        self.fc1 = Linear(1, dim, dtype=dtype)
        self.fc2 = Linear(dim, dim, dtype=dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)[:, None]
        if self.normalize is not None:
            t = t / self.normalize
        return apply_full(self.model_parallel, self.fc2, silu(self.fc1(t)))
