"""Loaders of weights made outside the repository (torchvision's VGG16)."""
