"""Data and tensor parallelism: the ``data`` and ``model`` axes of
``tinydiffusion_tpu/parallel/``.

``distributed.py`` joins the processes that torchrun starts into one
``torch.distributed`` group (NCCL on cards, gloo on the CPU); ``mesh.py``
sizes the data axis by JAX's gcd rule and carries it to the train steps as a
``DataParallel`` value, and builds the ``(data, model)`` mesh of tensor
parallelism (``make_mesh``, JAX's ``infer_state_sharding`` and
``apply_sharding``), which the UNet28 train step takes.
"""
