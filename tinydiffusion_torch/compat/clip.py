"""The CLIP-L text encoder: the ``"clip"`` conditioning seam.

Counterpart of ``tinydiffusion_tpu/compat/clip.py`` (``CLIPTextConfig``,
``clip_text_forward``, ``CLIPTextFlaxEncoder``). The reference conditions the
LAION diffusion on CLIP ViT-L/14's text transformer and embeds a prompt as
``last_hidden_state[:, -1, :]`` under no_grad (conditional_diffusion_laion.py:
207-219, 608-611): the last position of the 77, which is padding for any
prompt shorter than 76 tokens, not the eos of the text.

The transformer (transformers' ``CLIPTextModel``): token plus learned
position embeddings; pre-LN layers of multi-head self-attention under a
causal mask (q scaled by ``head_dim ** -0.5`` before the product, the masked
logits set to the dtype's minimum) and a quick-GELU MLP; a final LayerNorm.
Its ``state_dict`` keys are transformers' own without the ``text_model.``
prefix; ``clip_state_dict`` takes a ``CLIPTextModel`` state dict as
transformers saves it (prefixed, and with ``embeddings.position_ids`` in
some versions) to one that loads ``strict``.

The attention is dense products and a softmax, as in JAX, where it runs
outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.compat.clip_tokenizer import CLIPBPETokenizer

PREFIX = "text_model."
# A buffer of 0..N-1 that some transformers versions save; the forward does not need it.
POSITION_IDS = "embeddings.position_ids"


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """The fields of transformers' ``CLIPTextConfig`` that the forward reads.
    The defaults are openai/clip-vit-large-patch14's, the reference's model."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


class CLIPEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embedding = nn.Embedding(config.max_position_embeddings,
                                               config.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        n = input_ids.shape[1]
        return self.token_embedding(input_ids) + self.position_embedding.weight[:n]


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        c = config.hidden_size
        self.heads = config.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.v_proj, self.out_proj = nn.Linear(c, c), nn.Linear(c, c)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.heads

        def heads(t: torch.Tensor) -> torch.Tensor:  # (B, N, C) -> (B, H, N, hd)
            return t.view(b, n, self.heads, hd).transpose(1, 2)

        q = heads(self.q_proj(x) * hd**-0.5)  # transformers scales q before the product
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        attn = torch.softmax(q @ k.transpose(-1, -2) + mask, dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class CLIPMLP(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.act = config.hidden_act
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        eps = config.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=eps)
        self.self_attn = CLIPAttention(config)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=eps)
        self.mlp = CLIPMLP(config)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(config)
                                    for _ in range(config.num_hidden_layers))


class CLIPTextTransformer(nn.Module):
    """``forward(input_ids (B, N) int64) -> last_hidden_state (B, N, hidden_size)``."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.embeddings = CLIPEmbeddings(config)
        self.encoder = CLIPEncoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(input_ids)
        n = input_ids.shape[1]
        mask = torch.full((n, n), torch.finfo(x.dtype).min, dtype=x.dtype,
                          device=x.device).triu(1)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x)


def clip_state_dict(state_dict: dict) -> dict:
    """A transformers ``CLIPTextModel`` state dict with the ``text_model.``
    prefix taken off and ``embeddings.position_ids`` dropped: the keys of
    ``CLIPTextTransformer``."""
    out = {}
    for key, value in state_dict.items():
        key = key[len(PREFIX):] if key.startswith(PREFIX) else key
        if key != POSITION_IDS:
            out[key] = value
    return out


class CLIPTextEncoder:
    """The text-encoder seam, ``encode(texts) -> (B, hidden_size) float32``:
    the tokenizer on the host, the transformer batched on ``device`` under
    no_grad, the last position's hidden state (the reference's pooling)."""

    def __init__(self, model: CLIPTextTransformer, tokenizer, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.config = model.config
        self.dim = model.config.hidden_size

    @classmethod
    def from_local(cls, weights_path: str, vocab_file: str, merges_file: str,
                   config: CLIPTextConfig | None = None,
                   device: str | torch.device = "cuda") -> "CLIPTextEncoder":
        """Offline: a torch-saved ``CLIPTextModel`` state dict, loaded
        ``strict`` (a missing or unexpected key raises), and the tokenizer's
        local files."""
        config = config or CLIPTextConfig()
        state_dict = torch.load(weights_path, map_location="cpu", weights_only=True)
        model = CLIPTextTransformer(config)
        model.load_state_dict(clip_state_dict(state_dict), strict=True)
        tokenizer = CLIPBPETokenizer.from_files(vocab_file, merges_file,
                                                model_max_length=config.max_position_embeddings)
        return cls(model, tokenizer, device)

    @classmethod
    def from_pretrained(cls, model_name: str = "openai/clip-vit-large-patch14",
                        device: str | torch.device = "cuda") -> "CLIPTextEncoder":
        """The reference's path: transformers' weights and tokenizer (the
        package is imported here; without it this raises ``ImportError``)."""
        try:
            from transformers import CLIPTextModel, CLIPTokenizer
        except ImportError as e:
            raise ImportError("CLIP's from_pretrained needs the transformers package; "
                              "without it use a clip_local_dir") from e
        hf = CLIPTextModel.from_pretrained(model_name).eval()
        mc = hf.config
        config = CLIPTextConfig(
            vocab_size=mc.vocab_size, hidden_size=mc.hidden_size,
            intermediate_size=mc.intermediate_size, num_hidden_layers=mc.num_hidden_layers,
            num_attention_heads=mc.num_attention_heads,
            max_position_embeddings=mc.max_position_embeddings,
            layer_norm_eps=mc.layer_norm_eps, hidden_act=mc.hidden_act)
        model = CLIPTextTransformer(config)
        model.load_state_dict(clip_state_dict(hf.state_dict()), strict=True)
        return cls(model, CLIPTokenizer.from_pretrained(model_name), device)

    @torch.no_grad()
    def encode(self, texts: Sequence[str]) -> np.ndarray:
        ids = self.tokenizer(list(texts), padding="max_length",
                             max_length=self.tokenizer.model_max_length,
                             truncation=True)["input_ids"]
        hidden = self.model(torch.as_tensor(np.asarray(ids), device=self.device))
        return hidden[:, -1, :].float().cpu().numpy()  # the last position, padding or not
