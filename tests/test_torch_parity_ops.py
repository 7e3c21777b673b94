"""Parity tests of the tricky PyTorch-semantics ops against torch CPU
(SURVEY.md section 4: align_corners bilinear resize, ceil-mode max pool,
sinusoidal embedding)."""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from tinydiffusion_tpu.core.embeddings import sinusoidal_time_embedding  # noqa: E402
from tinydiffusion_tpu.nn.resize import (  # noqa: E402
    max_pool_ceil,
    resize_bilinear_align_corners,
    upsample_bilinear_2x,
)


@pytest.mark.parametrize(
    "in_size,out_size",
    [((7, 7), (8, 8)), ((14, 14), (16, 16)), ((28, 28), (32, 32)),
     ((32, 32), (28, 28)), ((4, 4), (8, 8)), ((5, 9), (13, 3))],
)
def test_bilinear_align_corners_matches_torch(rng, in_size, out_size):
    x = rng.standard_normal((2, *in_size, 3)).astype(np.float32)
    ours = np.asarray(resize_bilinear_align_corners(jnp.asarray(x), out_size))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NHWC -> NCHW
    theirs = (
        F.interpolate(xt, size=out_size, mode="bilinear", align_corners=True)
        .permute(0, 2, 3, 1)
        .numpy()
    )
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


def test_upsample_2x_matches_torch(rng):
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    ours = np.asarray(upsample_bilinear_2x(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    up = torch.nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)
    theirs = up(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(28, 28), (14, 14), (7, 7), (4, 4), (9, 11)])
def test_max_pool_ceil_matches_torch(rng, hw):
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    ours = np.asarray(max_pool_ceil(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    pool = torch.nn.MaxPool2d(2, ceil_mode=True)
    theirs = pool(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, theirs, atol=0, rtol=0)


def test_sinusoidal_embedding_matches_reference_formula():
    """conditional_diffusion_laion.py:223-232: half sin / half cos with
    freqs exp(-ln(10000) * i / (half - 1)), odd-dim zero pad."""
    t = np.array([0, 1, 17, 999], dtype=np.int64)
    dim = 768
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / (half - 1))
    # fp32 product of t * freq — the precision at which any fp32
    # implementation (incl. the torch reference) evaluates the argument.
    args = (t[:, None].astype(np.float32) * freqs.astype(np.float32)).astype(
        np.float64
    )
    expected = np.concatenate([np.sin(args), np.cos(args)], axis=-1)
    ours = np.asarray(sinusoidal_time_embedding(jnp.asarray(t), dim))
    # sin/cos of args up to ~1000: fp32 evaluation differs across libms at
    # ~1e-4; that is the honest parity bound here.
    np.testing.assert_allclose(ours, expected, atol=5e-4)

    odd = np.asarray(sinusoidal_time_embedding(jnp.asarray(t), 7))
    assert odd.shape == (4, 7)
    np.testing.assert_allclose(odd[:, -1], 0.0)


def test_cosine_annealing_lr_matches_torch_past_t_max():
    """conditional_diffusion_laion.py:435-438, 473: CosineAnnealingLR
    (T_max=num_epochs, eta_min=1e-6) stepped PER BATCH. Torch's recursion
    is periodic past T_max (lr oscillates back up to base lr with period
    2*T_max) — the regime the published 1000-epoch recipe spends ~999
    epochs in. Assert our closed form tracks torch at every step through
    two full periods."""
    from tinydiffusion_tpu.experiments.conditional_diffusion_laion import (
        cosine_annealing_lr,
    )

    lr, lr_min, t_max, n_steps = 1e-4, 1e-6, 50, 201
    m = torch.nn.Linear(2, 2)
    opt = torch.optim.Adam(m.parameters(), lr=lr)
    sch = torch.optim.lr_scheduler.CosineAnnealingLR(
        opt, T_max=t_max, eta_min=lr_min
    )
    theirs = []
    for _ in range(n_steps):
        theirs.append(opt.param_groups[0]["lr"])
        opt.step()
        sch.step()

    schedule = cosine_annealing_lr(lr, lr_min, t_max)
    ours = [float(schedule(jnp.asarray(s))) for s in range(n_steps)]
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-12)
