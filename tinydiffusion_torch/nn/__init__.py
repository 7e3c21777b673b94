"""See the JAX counterpart ``tinydiffusion_tpu.nn``."""
