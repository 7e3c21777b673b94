"""The port's resident data path against the JAX package, on the CPU.

``data/device.py::DeviceDataset``, the placement rule of
``experiments/common.py``, ``train/trainer.py::make_resident_multi_step`` and
the resident loop of ``experiments/diffusion.py::run``. On a card the
resident step runs as replays of a captured CUDA graph, which only
``chip_smoke.py`` can drive (phases ``train``, ``resident_parity``); here the
same step runs eagerly, the path the card's graph captures. JAX's draws reach
the port through the step's ``(t, noise)`` seam. Models are small (base
width 8, time dim 32) and float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_diffusion import SMALL, _idx_data_root, _same_tables
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.data.device import DeviceDataset as JaxDeviceDataset
from tinydiffusion_tpu.experiments import common as jax_common
from tinydiffusion_tpu.experiments import diffusion as jax_diffusion
from tinydiffusion_tpu.io.checkpoint import _flat_items
from tinydiffusion_tpu.models.unet28 import UNet28 as JaxUNet28
from tinydiffusion_tpu.train.trainer import create_train_state as jax_create_train_state
from tinydiffusion_tpu.train.trainer import make_resident_multi_step as jax_resident_multi_step
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data.loader import BatchIterator
from tinydiffusion_torch.data.mnist import MNIST_SCALE, MNIST_SHIFT
from tinydiffusion_torch.experiments import common, diffusion
from tinydiffusion_torch.io.from_jax import unet28_state_dict
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.train.trainer import create_train_state, make_resident_multi_step

U8 = (MNIST_SCALE, MNIST_SHIFT)
CPU = torch.device("cpu")
# One float32 ulp at 1: XLA may fuse the normalisation's multiply and add.
NORMALIZE_ATOL = 1.2e-7
# Three SGD steps (lr 0.1) at B = 8 against JAX's scan of the same steps: the
# single step's bounds (tests/test_torch_diffusion.py: loss 1e-5 relative,
# params 1e-5) with room for three steps of summation-order differences to
# compound (2e-6 and 1.2e-6 seen). The BN statistics are looser: flax takes
# the batch variance as E[x^2] - E[x]^2, which loses ~eps * E[x]^2 / Var of
# it, and three steps at lr 0.1 grow the decoder's activations (running
# variances up to 1.3e3); 1.4e-4 relative seen.
MULTI_LOSS_RTOL, MULTI_PARAM_ATOL, MULTI_STATS_RTOL, MULTI_STATS_ATOL = 3e-5, 3e-5, 3e-4, 3e-6
K, BATCH, LR = 3, 8, 0.1


def test_device_dataset_order_and_gather_match_jax_and_the_host_iterator():
    images = np.random.default_rng(11).integers(0, 256, (100, 28, 28, 1), dtype=np.uint8)
    ours = DeviceDataset(images, 16, seed=3, device="cpu")
    theirs = JaxDeviceDataset([images], 16, shuffle=True, seed=3, u8_normalize=U8)
    host = BatchIterator([images], 16, shuffle=True, seed=3, u8_normalize=U8)
    assert ours.num_batches == theirs.num_batches == len(host) == 6
    for epoch in (0, 1):
        idxs = ours.epoch_index_batches(epoch)
        np.testing.assert_array_equal(idxs, theirs.epoch_index_batches(epoch))
        for row, batch in zip(idxs, host.epoch(epoch), strict=True):
            x = ours.gather(torch.from_numpy(row))
            (hx,) = host.to_device(batch, CPU)
            # The host path's own operations: the two paths see the same bits.
            assert x.dtype == torch.float32 and torch.equal(x, hx)
            (jx,) = theirs.gather_arrays(theirs.device_arrays, jnp.asarray(row))
            np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=NORMALIZE_ATOL, rtol=0)
    assert not np.array_equal(ours.epoch_index_batches(0), ours.epoch_index_batches(1))
    with pytest.raises(TypeError, match="uint8"):
        DeviceDataset(images.astype(np.float32), 16, device="cpu")


@pytest.mark.parametrize("placement", ["host", "device", "auto"])
@pytest.mark.parametrize("nbytes", [47_040_000, (4 << 30) + 1])
def test_resolve_data_placement_matches_jax(placement, nbytes):
    assert common.RESIDENT_AUTO_LIMIT_BYTES == jax_common.RESIDENT_AUTO_LIMIT_BYTES
    ours = common.resolve_data_placement(placement, nbytes)
    assert ours == jax_common.resolve_data_placement(placement, nbytes, 128)
    assert ours == (placement == "device" or (placement == "auto" and nbytes <= 4 << 30))


def test_resolve_data_placement_refuses_what_jax_refuses():
    for resolve in (common.resolve_data_placement,
                    lambda p, n: jax_common.resolve_data_placement(p, n, 128)):
        with pytest.raises(ValueError, match="choose 'host', 'device', or 'auto'"):
            resolve("hbm", 1)


class _Resolved(Exception):
    pass


@pytest.mark.parametrize("fused_qsample", [False, True])
@pytest.mark.parametrize("placement", ["auto", "host", "device"])
def test_both_clis_take_the_same_path_for_the_same_flags(tmp_path, monkeypatch, placement,
                                                         fused_qsample):
    """JAX's ``run`` resolves its placement after the data and the model; it
    is stopped there (its model init skipped) and its decision compared with
    the port's. ``"auto"`` with ``fused_qsample`` is the host path in both."""
    root = _idx_data_root(tmp_path)
    seen, resolve = {}, jax_common.resolve_data_placement

    def record(placement, dataset_bytes, batch_size, mesh=None, name="experiment"):
        seen["resident"] = resolve(placement, dataset_bytes, batch_size, mesh, name)
        seen["bytes"] = dataset_bytes
        raise _Resolved

    monkeypatch.setattr(jax_common, "resolve_data_placement", record)
    monkeypatch.setattr(jax_diffusion, "create_train_state", lambda *a, **k: None)
    flags = dict(data_placement=placement, fused_qsample=fused_qsample, data_root=root,
                 batch_size=8, use_mesh=False, out_dir=str(tmp_path / "jax"))
    with pytest.raises(_Resolved):
        jax_diffusion.run(jax_diffusion.DiffusionConfig(**flags))
    ours = diffusion.use_resident_path(diffusion.DiffusionConfig(**flags), seen["bytes"])
    assert ours == seen["resident"]
    assert ours == (placement == "device" or (placement == "auto" and not fused_qsample))


def test_resident_multi_step_matches_jax():
    """K = 3 SGD steps over the same index batches: JAX's scan of gather +
    normalise + step, and the port's resident step given JAX's per-step
    (t, noise), recomputed from the splits of its state's key."""
    images = np.random.default_rng(12).integers(0, 256, (40, 28, 28, 1), dtype=np.uint8)
    theirs = JaxDeviceDataset([images], BATCH, shuffle=True, seed=4, u8_normalize=U8)
    idxs = theirs.epoch_index_batches(0)[:K]
    jmodel = JaxUNet28(**SMALL, dtype=jnp.float32)
    tx = optax.sgd(LR)
    example = (jnp.zeros((BATCH, 28, 28, 1)), jnp.zeros((BATCH,), jnp.int32))
    jstate = jax_create_train_state(jmodel, tx, example, jax.random.PRNGKey(0))
    ts, noises, key = [], [], jstate.rng
    for _ in range(K):  # _raw_step_fn's split, step by step
        key, t_key, noise_key, _ = jax.random.split(key, 4)
        ts.append(np.asarray(jax.random.randint(t_key, (BATCH,), 0, 1000)))
        noises.append(np.asarray(jax.random.normal(noise_key, (BATCH, 28, 28, 1))))
    flat, _ = _flat_items({"params": jstate.params, "batch_stats": jstate.batch_stats})
    flat = {k: np.asarray(v) for k, v in flat.items()}  # before the step donates jstate
    jschedule = JaxSchedule.linear(1000)
    new_jstate, jlosses = jax_resident_multi_step(jmodel, tx, jschedule, theirs)(
        jstate, jnp.asarray(idxs))

    model = UNet28(**SMALL)
    model.load_state_dict(unet28_state_dict(flat))
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    ours = DeviceDataset(images, BATCH, seed=4, device="cpu")
    np.testing.assert_array_equal(ours.epoch_index_batches(0)[:K], idxs)
    step = make_resident_multi_step(_same_tables(jschedule), ours)
    losses = step(state, ours.epoch_index_batches(0)[:K], t=torch.from_numpy(np.stack(ts)).long(),
                  noise=torch.from_numpy(np.stack(noises).transpose(0, 1, 4, 2, 3).copy()))

    assert state.step == K and losses.shape == (K,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=MULTI_LOSS_RTOL)
    want, _ = _flat_items({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats})
    got = state.jax_weights()
    assert got.keys() == want.keys() | {"step"}
    for key, value in want.items():
        value = np.asarray(value)
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got[key], value, rtol=MULTI_STATS_RTOL,
                                       atol=MULTI_STATS_ATOL, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=MULTI_PARAM_ATOL, rtol=0,
                                       err_msg=key)


def test_resident_step_draws_t_then_the_seed_from_the_state_generator():
    """Without the seam, each of the K steps draws t and then a 0-d int64
    seed from the state's generator and trains on its own index batch: the
    same losses as single steps on the gathered batches with those draws
    replayed, and no kernel launch on the CPU."""
    images = np.random.default_rng(13).integers(0, 256, (24, 28, 28, 1), dtype=np.uint8)
    ds = DeviceDataset(images, 4, seed=1, device="cpu")
    sched = DiffusionSchedule.linear(1000)
    idxs = ds.epoch_index_batches(0)[:K]
    runs = []
    for replay in (False, True):
        torch.manual_seed(3)
        model = UNet28(**SMALL)
        state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 9)
        step = make_resident_multi_step(sched, ds)
        if not replay:
            before = qsample.qsample_launches
            runs.append(step(state, idxs).tolist())
            assert qsample.qsample_launches == before and state.step == K
            continue
        probe = torch.Generator().manual_seed(0)
        probe.set_state(state.generator.get_state())
        ts, noises = [], []
        for row in idxs:
            x0 = ds.gather(torch.from_numpy(row))
            ts.append(torch.randint(0, 1000, (4,), generator=probe))
            seed = torch.randint(0, 2**31 - 1, (), generator=probe)
            noises.append(qsample.q_sample_fused_reference(
                sched, x0.permute(0, 3, 1, 2), ts[-1], seed)[1])
        runs.append(step(state, idxs, t=torch.stack(ts), noise=torch.stack(noises)).tolist())
    assert runs[0] == runs[1] and len(set(runs[0])) == K


def test_run_trains_alike_on_the_host_and_the_resident_path(tmp_path):
    """The same config on both paths: the same batches, t and seeds, so the
    same logged losses and final weights, to the bit, on the CPU."""
    results = {}
    for placement in ("host", "device"):
        config = diffusion.DiffusionConfig(
            device="cpu", num_epochs=2, max_steps_per_epoch=3, batch_size=8, log_every=1,
            num_timesteps=100, sample_every_epoch=False, visualize_denoising=False,
            data_root=_idx_data_root(tmp_path / placement), checkpoint_path="",
            out_dir=str(tmp_path / placement / "out"), compute_dtype="float32",
            data_placement=placement, **SMALL)
        results[placement] = diffusion.run(config)
    host, resident = results["host"], results["device"]
    assert not host["resident"] and resident["resident"]
    assert len(host["losses"]) == 6 and host["losses"] == resident["losses"]
    assert host["state"].step == resident["state"].step == 6
    for (name, a), b in zip(host["state"].model.state_dict().items(),
                            resident["state"].model.state_dict().values()):
        assert torch.equal(a, b), name
