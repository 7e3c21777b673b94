"""See the JAX counterpart ``tinydiffusion_tpu.train``."""
