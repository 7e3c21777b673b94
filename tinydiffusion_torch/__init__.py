"""tinydiffusion_torch — the PyTorch + CUDA port of ``tinydiffusion_tpu``.

The JAX package beside this one is the reference: every module here keeps
the name of its JAX counterpart, and the tests under ``tests/test_torch_*``
hold each against it on the same inputs and weights.

The port imports ``torch``, ``numpy`` and the standard library only (no jax,
flax, optax, orbax, ml_dtypes or PIL, and nothing of ``tinydiffusion_tpu``),
so it runs on a CUDA machine that has none of the JAX stack. Importing it
does no work: there is no compile cache to set up, and the hand-written CUDA
kernels (``ops/csrc``) are built with ``nvcc`` on their first launch.

Ported so far: the main path, training and sampling the MNIST UNet28 DDPM
(``experiments/diffusion.py``) with a CUDA fused q_sample
(``ops/qsample.py``); and training and serving the LAION conv beta-VAE
(``experiments/vae_laion.py``) with a CUDA flash-attention forward and
backward (``ops/attention.py``).
"""

__version__ = "0.1.0"
