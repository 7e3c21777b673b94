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
(``ops/qsample.py``); class-conditional training with label dropout for
classifier-free guidance (``experiments/conditional_diffusion.py``); the
MNIST MLP VAE (``experiments/vae.py``) and class-conditional latent
diffusion over it with the MLP UNet or the DiT
(``experiments/latent_diffusion.py``); the serving CLI for pixel-space and
latent checkpoints (``generate.py``: DDPM, DDIM, DPM-Solver++, and for pixel
checkpoints guidance, img2img, inpainting); and training and serving the
LAION conv beta-VAE (``experiments/vae_laion.py``) with a CUDA
flash-attention forward and backward (``ops/attention.py``); FID evaluation
(``eval/fid.py``, ``tools/fid_eval.py``, ``tools/fid_eval_laion.py``), the
debug helpers (``obs/debug.py``) and the importer of reference checkpoints
(``compat/torch_import.py``, ``tools/import_torch_checkpoint.py``).
"""

__version__ = "0.1.0"
