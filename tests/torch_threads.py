"""Each test process's share of the CPU's cores for torch.

Imported at module level by every ``tests/test_torch_*.py`` (and by
``tests/torch_tp_worker.py``). Under ``pytest -n N`` (xdist) each of the N
workers would otherwise run torch's intra-op pool on every core, and N
pools fighting over the same cores make a run many times slower than the
sum of its tests (a 13 s test took over 500 s beside five others). The
share is ``cores // N`` threads (at least 1; all of them outside xdist). It
is also put in ``OMP_NUM_THREADS``, so that processes a test spawns (gloo
ranks, ``python -m`` runs) start with the same share. Tests that pin one
thread for bit-stability still do so around their work.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
THREADS = max(1, (os.cpu_count() or 1) // max(1, WORKERS))

torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)
