"""Data parallelism: the ``data`` axis of ``tinydiffusion_tpu/parallel/``.

``distributed.py`` joins the processes that torchrun starts into one
``torch.distributed`` group (NCCL on cards, gloo on the CPU); ``mesh.py``
sizes the data axis by JAX's gcd rule and carries it to the train steps as a
``DataParallel`` value. The ``model`` axis (JAX's ``infer_state_sharding``,
tensor parallelism) is not ported.
"""
