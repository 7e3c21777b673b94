"""See the JAX counterpart ``tinydiffusion_tpu.io``."""
