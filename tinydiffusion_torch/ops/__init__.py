"""See the JAX counterpart ``tinydiffusion_tpu.ops``."""
