"""Loaders of weights made outside the repository (torchvision's VGG16, CLIP-L,
the SD VAE, the tiny-diffusion reference's checkpoints)."""
