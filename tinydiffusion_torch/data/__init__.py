"""See the JAX counterpart ``tinydiffusion_tpu.data``."""
