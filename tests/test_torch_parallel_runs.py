"""Data parallelism in the port's six train entry points, on the CPU.

Each ``run`` takes ``use_mesh`` as JAX's does: in a process group it trains
on its rank's rows of every global batch (``parallel/``). Two gloo ranks
(``torch.multiprocessing``, a ``file://`` rendezvous) run every entry point
at a tiny size (``tests/torch_dp_worker.py::entry_configs``); their logged
losses and val or test losses equal one process's on the whole batches, rank
1 writes nothing, rank 0's checkpoints load in one process, and a global
batch that the ranks do not divide leaves rank 1 idle.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tests import torch_dp_worker as worker
from tests.test_torch_vae_mnist import mnist_idx_root
from tinydiffusion_torch.experiments.common import load_pixel_checkpoint
from tinydiffusion_torch.io.checkpoint import load_weights_arrays

WORLD = 2
ENTRY_POINTS = ("diffusion", "diffusion_host", "conditional_diffusion", "vae",
                "latent_diffusion", "vae_laion", "conditional_diffusion_laion")
# Two Adam steps and a val pass, float32: the ranks' sums of the halves
# against one process's whole-batch sums. The first step's loss within 1e-5;
# after Adam's first update, ~lr * sign(g) where a gradient is near 0, the
# losses part by up to 3.2e-5 (the UNet28's second step, its val loss), so
# the later ones and the val and test losses are held within 1e-4.
FIRST_LOSS_RTOL, LOSS_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_runs")
    data_root = mnist_idx_root(tmp, n_train=160, n_test=32)
    mp.start_processes(worker.run_entry_points,
                       args=(WORLD, str(tmp / "rendezvous"), data_root, str(tmp)),
                       nprocs=WORLD, start_method="spawn")
    ranks = [dict(np.load(tmp / f"entry_rank{r}.npz")) for r in range(WORLD)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {}
        configs = worker.entry_configs(data_root, str(tmp / "one"))
        for name, (run, config) in configs.items():
            one[name] = worker.entry_losses(run(config))
    finally:
        torch.set_num_threads(threads)
    return {"tmp": tmp, "ranks": ranks, "one": one, "configs": configs}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_dp_run_logs_the_one_process_losses(runs, name):
    want = runs["one"][name]
    assert want and all(v.size for v in want.values())
    for rank in runs["ranks"]:
        got = {k[len(name) + 1:]: v for k, v in rank.items() if k.startswith(name + "/")}
        assert got.keys() == want.keys()
        first = "losses" if "losses" in want else "test_losses"
        np.testing.assert_allclose(got[first][0], want[first][0], rtol=FIRST_LOSS_RTOL)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL, err_msg=key)


def test_rank_one_writes_nothing_and_rank_zero_checkpoints_load(runs):
    tmp = runs["tmp"]
    written = [os.path.join(d, f) for d, _, files in os.walk(tmp / "rank1") for f in files]
    assert written == []
    ckpt = tmp / "rank0" / "diffusion" / "ckpt"
    loaded = load_pixel_checkpoint(str(ckpt), device="cpu")
    assert not loaded["conditional"] and loaded["model"].training is False
    ours, one = load_weights_arrays(str(ckpt)), load_weights_arrays(str(tmp / "one" / "diffusion"
                                                                         / "ckpt"))
    assert ours.keys() == one.keys()
    assert all(ours[k].shape == one[k].shape for k in one)
    for name in ENTRY_POINTS[2:]:
        assert any(f.endswith(".npz") for _, _, files in os.walk(tmp / "rank0" / name)
                   for f in files), name


def test_a_batch_the_ranks_do_not_divide_leaves_rank_one_idle(runs):
    rank0, rank1 = runs["ranks"]
    assert not bool(rank0["idle/idle"]) and bool(rank1["idle/idle"])
    assert rank0["idle/losses"].size == 2 and "idle/losses" not in rank1
