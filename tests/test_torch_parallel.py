"""Data parallelism in the port (``tinydiffusion_torch/parallel/``) on the CPU.

Under GSPMD a JAX step on a ``data`` mesh is the one-device step on the
global batch (``tests/test_train_dp.py``). Two processes in a gloo group
(``torch.multiprocessing``, a ``file://`` rendezvous) each take one SGD step
on their half of a global batch of 16 (``tests/torch_dp_worker.py``), and
the test holds them to

- the port's one-process step on the whole batch, with the step's own draws
  (t, the q_sample seed and rows, the reparameterising noise: drawn for the
  global batch, each rank keeping its rows), for the small UNet28 (BatchNorm2d
  in train mode) and the committed MLP UNet (BatchNorm1d);
- JAX's step (``_raw_step_fn``, ``_raw_latent_step_fn``) on the same weights
  with JAX's draws replayed through the seams;
- and, as a check with teeth, apart from the one-process step when each rank
  normalises with its own half's BatchNorm statistics.

Also: the validation loss reduced over the ranks, the gcd rule of
``make_mesh_for_batch`` and its warning, ``local_batch_slice``, and the
fused q_sample's row offset.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from tests import torch_dp_worker as worker
from tests.test_torch_diffusion import _same_tables
from tests.test_torch_latent import CHECKPOINTS, VAE_CHECKPOINT, _jax_model, _jax_variables
from tests.test_torch_latent import _vae_pair
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.io.checkpoint import _flat_items
from tinydiffusion_tpu.models.unet28 import UNet28 as JaxUNet28
from tinydiffusion_tpu.train.trainer import DiffusionTrainState as JaxTrainState
from tinydiffusion_tpu.train.trainer import _raw_latent_step_fn, _raw_step_fn
from tinydiffusion_tpu.train.trainer import create_train_state as jax_create_train_state
from tinydiffusion_torch.compat import latent_codec, sdvae
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.io.from_jax import unet28_state_dict
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.parallel import distributed, mesh

WORLD, BATCH = 2, 16
# One float32 SGD step: the loss within 1e-5 relative, params and BatchNorm
# statistics within 1e-5 (the sums of the two halves' statistics and
# gradients run in another order than one process's). The MLP UNet's
# committed running variances reach ~800, where one float32 ulp is 6.1e-5:
# there the statistics may also differ by 2 ulps (2^-22 relative).
LOSS_RTOL, PARAM_ATOL, STATS_ULP_RTOL = 1e-5, 1e-5, 2.0**-22
# Against JAX: the bounds of test_torch_diffusion / test_torch_latent's
# one-step tests (BN statistics to 1e-4 relative there, flax's fast variance
# against torch's var_mean).
JAX_STATS_RTOL, JAX_STATS_ATOL = 1e-4, 1e-6
TO_NCHW = (0, 3, 1, 2)


def _jax_unet(x0_nhwc: np.ndarray) -> dict:
    """JAX's small UNet28 SGD step on the global batch, from its own init,
    with its draws: the weights (as the port's state dict), t, noise and the
    step's result."""
    jmodel = JaxUNet28(**worker.UNET_SMALL, dtype=jnp.float32)
    tx = optax.sgd(worker.LR)
    example = (jnp.zeros((BATCH, 28, 28, 1)), jnp.zeros((BATCH,), jnp.int32))
    jstate = jax_create_train_state(jmodel, tx, example, jax.random.PRNGKey(0))
    _, t_key, noise_key, _ = jax.random.split(jstate.rng, 4)
    t = np.asarray(jax.random.randint(t_key, (BATCH,), 0, 1000))
    noise = np.asarray(jax.random.normal(noise_key, x0_nhwc.shape))
    jschedule = JaxSchedule.linear(1000)
    new_jstate, jloss = jax.jit(_raw_step_fn(jmodel, tx, jschedule))(jstate,
                                                                      jnp.asarray(x0_nhwc))
    flat, _ = _flat_items({"params": jstate.params, "batch_stats": jstate.batch_stats})
    want, _ = _flat_items({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats})
    return {"state_dict": unet28_state_dict({k: np.asarray(v) for k, v in flat.items()}),
            "t": t.astype(np.int64), "noise": noise.transpose(TO_NCHW), "schedule": jschedule,
            "loss": float(jloss), "weights": {k: np.asarray(v) for k, v in want.items()}}


def _jax_latent(x0_nhwc: np.ndarray, y: np.ndarray) -> dict:
    """JAX's MLP UNet SGD step from the committed weights, with its draws."""
    jvae, jvae_params, _ = _vae_pair()
    jmodel = _jax_model("mlp_unet")
    variables = _jax_variables("mlp_unet", jmodel)
    tx = optax.sgd(worker.LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(7))
    _, z_key, t_key, noise_key, _ = jax.random.split(jstate.rng, 5)
    draws = {"z_eps": np.asarray(jax.random.normal(z_key, (BATCH, 20))),
             "t": np.asarray(jax.random.randint(t_key, (BATCH,), 0, 1000)).astype(np.int64),
             "noise": np.asarray(jax.random.normal(noise_key, (BATCH, 20)))}
    jstep = jax.jit(_raw_latent_step_fn(jvae, jmodel, tx, JaxSchedule.linear(1000)))
    new_jstate, jloss = jstep(jstate, jvae_params, jnp.asarray(x0_nhwc), jnp.asarray(y))
    want, _ = _flat_items({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats})
    return {**draws, "loss": float(jloss), "weights": {k: np.asarray(v) for k, v in want.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, JAX's steps, the port's one-process steps and the two
    ranks' results, computed once for the module."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(16)
    unet_x0 = rng.uniform(-1, 1, (BATCH, 28, 28, 1)).astype(np.float32)
    latent_x0 = (rng.integers(0, 256, (BATCH, 28, 28, 1)) * (2.0 / 255.0) - 1.0).astype(
        np.float32)
    latent_y = rng.integers(0, 10, BATCH).astype(np.int32)
    jax_unet = _jax_unet(unet_x0)
    jax_latent = _jax_latent(latent_x0, latent_y)
    torch.save(jax_unet["state_dict"], tmp / "unet.pt")
    schedule = _same_tables(jax_unet["schedule"])
    inputs = {
        "unet_weights": str(tmp / "unet.pt"), "unet_x0": unet_x0.transpose(TO_NCHW),
        "unet_t": jax_unet["t"], "unet_noise": jax_unet["noise"],
        "vae_checkpoint": VAE_CHECKPOINT, "mlp_checkpoint": CHECKPOINTS["mlp_unet"],
        "latent_x0": latent_x0.transpose(TO_NCHW), "latent_y": latent_y,
        **{f"latent_{k}": jax_latent[k] for k in ("z_eps", "t", "noise")},
        **{f"schedule_{k}": getattr(schedule, k).numpy()
           for k in ("betas", "alphas", "alphas_cumprod")},
    }
    np.savez(tmp / "inputs.npz", **inputs)
    mp.start_processes(worker.run_rank, args=(WORLD, str(tmp / "rendezvous"),
                                              str(tmp / "inputs.npz"), str(tmp)),
                       nprocs=WORLD, start_method="spawn")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {"unet": worker.unet_step(inputs), "unet_jax": worker.unet_step(inputs, None, True),
               "unet_eval": worker.unet_eval(inputs), "latent": worker.latent_step(inputs),
               "latent_jax": worker.latent_step(inputs, None, True)}
    finally:
        torch.set_num_threads(threads)
    return {"ranks": ranks, "one": one, "jax": {"unet": jax_unet, "latent": jax_latent}}


def _case(rank: dict, case: str) -> dict:
    prefix = case + "/"
    return {k[len(prefix):]: v for k, v in rank.items() if k.startswith(prefix)}


def _assert_same_step(got: dict, want: dict, stats_rtol: float = STATS_ULP_RTOL,
                      stats_atol: float = PARAM_ATOL) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    keys = {k for k in want if k != "loss"}
    assert keys and {k for k in got if k != "loss"} == keys
    for key in sorted(keys):
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got[key], want[key], rtol=stats_rtol, atol=stats_atol,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("case", ["unet", "latent"])
def test_dp_step_equals_the_one_process_step(runs, case):
    """Each rank's step on its half, the step's own draws: the global loss,
    the params and the BatchNorm running statistics of one process's step on
    the whole batch, on both ranks."""
    for rank in runs["ranks"]:
        _assert_same_step(_case(rank, case), runs["one"][case])


@pytest.mark.parametrize("case", ["unet", "latent"])
def test_dp_step_equals_jax_on_its_draws(runs, case):
    """JAX's draws of the global batch through the seams: both ranks, and one
    process, end where JAX's step ends."""
    want = {"loss": runs["jax"][case]["loss"], **runs["jax"][case]["weights"]}
    for got in [_case(rank, case + "_jax") for rank in runs["ranks"]] + [
            runs["one"][case + "_jax"]]:
        _assert_same_step(got, want, JAX_STATS_RTOL, JAX_STATS_ATOL)


@pytest.mark.parametrize("case", ["unet", "latent"])
def test_local_batchnorm_statistics_would_fail(runs, case):
    """With each rank's own BatchNorm statistics (the gradients still
    averaged) the step leaves the one-process step by more than the bound."""
    want = runs["one"][case]
    for rank in runs["ranks"]:
        got = _case(rank, case + "_local_bn")
        gap = max(np.abs(got[k] - want[k]).max() for k in want if k != "loss")
        assert gap > 10 * PARAM_ATOL
        with pytest.raises(AssertionError):
            _assert_same_step(got, want)


def test_dp_eval_loss_is_the_global_batch_loss(runs):
    for rank in runs["ranks"]:
        np.testing.assert_allclose(_case(rank, "unet_eval")["loss"],
                                   runs["one"]["unet_eval"]["loss"], rtol=LOSS_RTOL)


def test_mesh_gcd_rule_and_warning_in_the_group(runs):
    for r, rank in enumerate(runs["ranks"]):
        assert int(rank["mesh/size"]) == WORLD and int(rank["mesh/rank"]) == r
        assert int(rank["mesh/local_batch_slice"]) == BATCH // WORLD
        assert int(rank["idle/size"]) == 1 and bool(rank["idle/active"]) == (r == 0)
        (message,) = rank["idle/warnings"]
        assert f"does not divide {WORLD} devices; using a 1-device mesh (1 devices idle)" in str(
            message)


def test_data_axis_size_is_jax_gcd_rule(caplog):
    with caplog.at_level("WARNING", logger="tinydiffusion_torch.mesh"):
        assert mesh.data_axis_size(4, 3) == 1
        assert mesh.data_axis_size(128, 4) == 4
        assert mesh.data_axis_size(6, 4) == 2
    assert [r.getMessage() for r in caplog.records] == [
        "batch_size=4 does not divide 3 devices; using a 1-device mesh (2 devices idle). "
        "Pick a batch divisible by the device count to use the full slice.",
        "batch_size=6 does not divide 4 devices; using a 2-device mesh (2 devices idle). "
        "Pick a batch divisible by the device count to use the full slice."]


def test_one_process_has_no_data_axis(monkeypatch):
    """Without torchrun's variables nothing is joined: no group, one device."""
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert not distributed.maybe_initialize_distributed("cpu")
    assert mesh.make_mesh_for_batch(BATCH) is None
    assert distributed.local_batch_slice(BATCH) == BATCH


def test_data_parallel_shards_rows():
    dp = mesh.DataParallel(rank=1, size=4)
    x = torch.arange(16).reshape(8, 2)
    assert torch.equal(dp.shard(x), x[2:4]) and dp.shard(x).data_ptr() == x[2:4].data_ptr()
    assert torch.equal(dp.shard(x.T, dim=1), x.T[:, 2:4])
    assert mesh.row_offset(dp, 2) == 2 and mesh.global_batch(dp, 2) == 8
    assert mesh.shard(None, x) is x and mesh.row_offset(None, 8) == 0
    assert dp.active and not dp.is_main and not mesh.is_main(dp) and mesh.is_main(None)
    assert not mesh.DataParallel(rank=5, size=4).active
    with pytest.raises(ValueError, match="does not split"):
        dp.shard(torch.zeros(6))


@pytest.mark.parametrize("shape", [(8, 784), (8, 20), (6, 1, 5, 7)])
def test_qsample_row_offset_draws_the_rows_of_a_global_draw(shape):
    """The fused q_sample's plain version at a row offset: the rows of the
    global call's x_t and noise, bit for bit, for any split."""
    schedule = DiffusionSchedule.linear(1000)
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.standard_normal(shape, np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, shape[0]))
    xt, z = qsample.q_sample_fused(schedule, x0, t, 1234)
    for lo, hi in ((0, 2), (2, 6), (shape[0] - 1, shape[0])):
        xt_r, z_r = qsample.q_sample_fused(schedule, x0[lo:hi], t[lo:hi], 1234, row_offset=lo)
        assert torch.equal(xt_r, xt[lo:hi]) and torch.equal(z_r, z[lo:hi])
    _, z_other = qsample.q_sample_fused(schedule, x0[2:6], t[2:6], 1234)
    assert not torch.equal(z_other, z[2:6])  # without the offset: other rows
    with pytest.raises(ValueError, match="32-bit row counter"):
        qsample.q_sample_fused(schedule, x0, t, 1234, row_offset=-1)


def test_codec_noise_shape_is_what_encode_draws():
    """A data-parallel LAION step draws the SD codec's Gaussian for the
    global batch itself, at ``noise_shape``: the draw ``encode`` makes from
    the generator. The patch codec draws nothing."""
    codec = sdvae.SDVAECodec(sdvae.AutoencoderKL(block_out_channels=(16, 32),
                                                 layers_per_block=1, norm_num_groups=8))
    images = torch.zeros(3, 3, 16, 16)
    shape = codec.noise_shape(images)
    assert shape == (3, 4, 8, 8)
    drawn = codec.encode(images, generator=torch.Generator().manual_seed(5))
    noise = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    given = codec.encode(images, noise=noise)
    assert torch.equal(drawn, given)
    assert latent_codec.LinearPatchCodec(image_size=64).noise_shape(images) is None
