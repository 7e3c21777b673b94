"""The latent diffusion transformer (DiT-style eps-predictor) over the MNIST
VAE's latents.

Counterpart of ``tinydiffusion_tpu/models/dit.py`` (``TransformerBlock``,
``DiT``; the reference's diffusion_transformer.py:16-109). Module names are
the JAX ones, so ``io.from_jax.dit_state_dict`` maps them by name.

- ``TransformerBlock``: flax ``MultiHeadDotProductAttention`` (4 heads,
  dropout on the attention weights), then **post**-LayerNorm residuals,
  ``x = norm1(x + dropout(attn(x)))`` and ``x = norm2(x + dropout(ff(x)))``
  with an exact-GELU feed-forward ``dim -> 4 dim -> dim``;
- the timestep enters as ``t / 1000`` (``TimeEmbedMLP(normalize=1000)``),
  the class embedding is added to it and the sum to every projected token,
  then the learned ``pos_encoding`` (1, S, D);
- head ``LayerNorm -> Linear(dim, latent_dim / S)``.

The attention is written out as products and a softmax, as JAX computes it
outside any kernel: q divided by ``sqrt(head_dim)`` cast to the compute
dtype, softmax over keys as ``jax.nn.softmax`` (``nn.layers.softmax``),
each step rounded in it. The model computes in its ``dtype``, flax's
``dtype=`` (float32, or what ``nn.layers.computing_in`` sets).
The reference feeds ONE token (``num_tokens = 1``), so the softmax is
exactly 1 and attention reduces to the value and output projections;
``num_tokens > 1`` splits the latent into tokens, as in JAX.

Dropout follows flax and draws nothing itself. Flax's attention dropout
broadcasts its mask over batch and heads (``broadcast_dropout=True``): ONE
(1, 1, S, S) keep mask per layer and step, shared by the whole batch; the
two residual dropouts are elementwise over (B, S, D). A train-mode forward
with dropout takes these masks as an argument (``draw_dropout_masks`` draws
them from a caller's generator), so a step's draws all come from its
state's generator, whether it runs eagerly or replayed in a CUDA graph, and
a test can hand it JAX's masks. Kept elements are divided by
``1 - dropout`` cast to the compute dtype, flax's arithmetic.

On the model axis (``parallel.mesh.apply_sharding``: JAX's
``infer_state_sharding`` of the flax leaves) the residual stream is split
on its width D, as are ``pos_encoding``, the norms, ``out``, ``ff2`` and
``input_proj``; ``ff1`` is split on 4 D, and ``query``, ``key`` and
``value`` on head_dim (flax keeps their kernels as (D, heads, head_dim): a
rank holds head_dim / m of every head, ``parallel.mesh.HeadSplit``). Each
``Linear`` reads its whole input (``parallel.mesh.apply_full``); q, k and
v are made whole in one gather that undoes the head interleave, and every
rank computes the softmax and its product with v whole (the scores need
whole heads), then its slice of ``out``. ``LayerNorm`` gathers its input
for the statistics. The dropout masks are drawn whole and each rank keeps
its features, so that a (1, m) step equals one process. ``final_proj``'s
output (split where the axis divides ``latent_dim / num_tokens``) is
gathered whole for the loss.
"""

from __future__ import annotations

import torch
from torch import nn

from tinydiffusion_torch.nn.layers import (
    FlaxDtype,
    LayerNorm,
    Linear,
    TimeEmbedMLP,
    constant,
    gelu,
    softmax,
)
from tinydiffusion_torch.parallel.mesh import (
    apply_full,
    apply_full_each,
    gather_last,
    gather_output,
    out_sharded,
)


class MultiHeadAttention(FlaxDtype, nn.Module):
    """flax ``MultiHeadDotProductAttention(qkv_features=dim, out_features=dim)``
    over (B, S, dim) tokens, self-attention. ``query``/``key``/``value`` and
    ``out`` are (dim, dim) ``nn.Linear``s; flax keeps their kernels as
    (dim, heads, head_dim) and (heads, head_dim, dim) (``io.from_jax``)."""

    model_parallel = None  # set by parallel.mesh.apply_sharding

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Linear(dim, dim)
        self.key = Linear(dim, dim)
        self.value = Linear(dim, dim)
        self.out = Linear(dim, dim)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None,
                keep_prob: float = 1.0) -> torch.Tensor:
        """``keep`` (1, 1, S, S) bool masks the attention weights (train mode)."""
        mp = self.model_parallel
        b, s = x.shape[:2]
        d, h = self.out.in_features, self.num_heads
        q, k, v = apply_full_each(mp, (self.query, self.key, self.value), x)
        if mp is not None and out_sharded(self.query):
            q, k, v = gather_last(mp, q, k, v, heads=h).split(d, -1)
        q = q.view(b, s, h, d // h)
        k = k.view(b, s, h, d // h)
        v = v.view(b, s, h, d // h)
        q = q / constant((d // h) ** 0.5, q.dtype)
        weights = softmax(torch.einsum("bqhd,bkhd->bhqk", q, k))
        if keep is not None:
            weights = weights * (keep.to(weights.dtype) / constant(keep_prob, weights.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, d)
        return apply_full(mp, self.out, out)


def _dropout(x: torch.Tensor, keep: torch.Tensor | None, keep_prob: float) -> torch.Tensor:
    """flax ``Dropout``: ``x / keep_prob`` (in x's dtype) where kept, 0
    elsewhere. ``keep`` may be the whole width's mask where ``x`` holds a
    model rank's features of it: its ``local_features``."""
    if keep is None:
        return x
    return torch.where(keep, x / constant(keep_prob, x.dtype), torch.zeros_like(x))


def local_features(mp, keep: torch.Tensor | None, width: int) -> torch.Tensor | None:
    """This model rank's ``width`` features of a whole-width mask (the last
    dimension), or the mask itself where it is that width."""
    if keep is None or keep.shape[-1] == width:
        return keep
    return keep.narrow(-1, mp.rank * width, width)


class TransformerBlock(nn.Module):
    model_parallel = None  # set by parallel.mesh.apply_sharding

    def __init__(self, dim: int, num_heads: int, ff_dim: int, dropout: float = 0.1):
        super().__init__()
        self.keep_prob = 1.0 - dropout
        self.attention = MultiHeadAttention(dim, num_heads)
        self.norm1 = LayerNorm(dim)
        self.ff1 = Linear(dim, ff_dim)
        self.ff2 = Linear(ff_dim, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        """``masks``: ``(attention (1, 1, S, S), output (B, S, D), ff (B, S,
        D))`` bool keep masks, or None (no dropout)."""
        mp = self.model_parallel
        attn_keep, out_keep, ff_keep = masks if masks is not None else (None, None, None)
        attn = self.attention(x, attn_keep, self.keep_prob)
        out_keep = local_features(mp, out_keep, attn.shape[-1])
        x = self.norm1(x + _dropout(attn, out_keep, self.keep_prob))
        h = apply_full(mp, self.ff2, gelu(apply_full(mp, self.ff1, x)))
        ff_keep = local_features(mp, ff_keep, h.shape[-1])
        return self.norm2(x + _dropout(h, ff_keep, self.keep_prob))


class DiT(FlaxDtype, nn.Module):
    supports_model_axis = True
    model_parallel = None  # set by parallel.mesh.apply_sharding

    def __init__(self, time_dim: int = 256, num_classes: int = 10, latent_dim: int = 20,
                 num_heads: int = 4, num_layers: int = 4, dropout: float = 0.05,
                 num_tokens: int = 1):
        super().__init__()
        if latent_dim % num_tokens:
            raise ValueError(f"latent_dim {latent_dim} does not split into {num_tokens} tokens")
        self.latent_dim = latent_dim
        self.num_tokens = num_tokens
        self.time_dim = time_dim
        self.dropout = dropout
        self.time_embedding = TimeEmbedMLP(time_dim, normalize=1000.0)
        self.class_embedding = nn.Embedding(num_classes, time_dim)  # N(0, 1) init
        self.input_proj = Linear(latent_dim // num_tokens, time_dim)
        self.pos_encoding = nn.Parameter(torch.randn(1, num_tokens, time_dim))
        self.num_layers = num_layers
        for i in range(num_layers):  # flax's names: block0, block1, ...
            self.add_module(f"block{i}", TransformerBlock(time_dim, num_heads, 4 * time_dim,
                                                          dropout))
        self.final_norm = LayerNorm(time_dim)
        self.final_proj = Linear(time_dim, latent_dim // num_tokens)

    def draw_dropout_masks(self, batch: int, generator: torch.Generator) -> list | None:
        """One train step's keep masks, per block ``(attention (1, 1, S, S),
        output (B, S, D), ff (B, S, D))``, drawn in that order from
        ``generator`` (on the model's device) as Bernoulli(1 - dropout); None
        when the model has no dropout."""
        if self.dropout == 0.0:
            return None
        keep_prob = 1.0 - self.dropout
        device = self.pos_encoding.device
        s, d = self.num_tokens, self.time_dim

        def keep(shape):
            return torch.rand(shape, generator=generator, device=device) < keep_prob

        return [(keep((1, 1, s, s)), keep((batch, s, d)), keep((batch, s, d)))
                for _ in range(self.num_layers)]

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                dropout_masks: list | None = None) -> torch.Tensor:
        """eps (B, latent_dim) float32 of latents ``x`` (B, latent_dim) at
        timesteps ``t`` with labels ``y``. In train mode with dropout the
        step's ``dropout_masks`` (``draw_dropout_masks``) are required; eval
        mode ignores them."""
        if not self.training or self.dropout == 0.0:
            dropout_masks = None
        elif dropout_masks is None:
            raise ValueError("a train-mode DiT forward with dropout needs dropout_masks "
                             "(draw_dropout_masks, from the step's generator)")
        mp = self.model_parallel
        batch = x.shape[0]
        dtype = self.dtype
        x = x.to(dtype)
        emb = self.time_embedding(t) + self.class_embedding(y).to(dtype)
        tokens = apply_full(mp, self.input_proj, x.reshape(batch, self.num_tokens, -1))
        tokens = tokens + emb[:, None, :] + self.pos_encoding.to(dtype)
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(
                tokens, None if dropout_masks is None else dropout_masks[i])
        out = apply_full(mp, self.final_proj, self.final_norm(tokens))
        out = gather_output(mp, self.final_proj, out)
        return out.reshape(batch, self.latent_dim).float()
