"""See the JAX counterpart ``tinydiffusion_tpu.core``."""
