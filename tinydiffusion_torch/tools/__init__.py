"""Command-line tools of the port, run as ``python -m tinydiffusion_torch.tools.<name>``:
``fid_eval`` and ``fid_eval_laion`` (FID of checkpoints and sample dumps),
``import_torch_checkpoint`` (a reference ``.pth`` into a port checkpoint).
See the JAX counterparts under ``tools/``."""
