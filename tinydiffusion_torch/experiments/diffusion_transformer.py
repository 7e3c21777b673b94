"""The DiT over the MNIST VAE's latents: latent diffusion with the transformer.

Counterpart of the root ``diffusion_transformer.py`` (the reference's
``python -m diffusion_transformer``): ``experiments/latent_diffusion.py``
with ``--backbone dit`` and paths of its own, so that a DiT run leaves the
MLP UNet's outputs alone: ``--out-dir runs/diffusion_transformer`` and
``--model-save-path runs/diffusion_transformer/diffusion_transformer_best``
(JAX's names, moved under ``runs/``). The caller's flags come after these
and win::

    python -m tinydiffusion_torch.experiments.diffusion_transformer --num-epochs 2 \\
        --max-steps-per-epoch 20 [--device cpu]
"""

from __future__ import annotations

import sys

from tinydiffusion_torch.experiments import latent_diffusion

DIT_FLAGS = ["--backbone", "dit", "--out-dir", "runs/diffusion_transformer",
             "--model-save-path", "runs/diffusion_transformer/diffusion_transformer_best"]


def main(argv=None) -> None:
    latent_diffusion.main(DIT_FLAGS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
