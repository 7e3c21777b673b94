"""The model axis for the LAION text-conditional LatentUNet, on the CPU.

JAX's ``make_train_step(conditional=True, mesh, state_sharding=
infer_state_sharding(state, mesh, "model"))`` trains the LatentUNet
(``model(x_t, t, context)``) tensor-parallel. The port's counterpart is
``make_train_step(conditional=True, mesh=...)`` after
``parallel.mesh.apply_sharding``, the (B, time_dim) context as ``y``. Four
processes in a gloo group (``torch.multiprocessing``, a ``file://``
rendezvous; ``tests/torch_tp_worker.py::run_laion_rank``) take one SGD step
of a small LatentUNet (base width 8, time_dim 32, 8x8 latents of 4
channels, B = 8) on the ``(2, 2)`` mesh, then two of them on ``(1, 2)``,
and the test holds them to

- the sharding rule: every flax leaf's split at m = 2 and 4 is JAX's, shard
  contents included, through ``io.from_jax.jax_variables`` (the 4-channel
  ``final_conv`` split at both);
- the port's one-process step on the whole batch (its own draws), and three
  resident steps (``make_resident_multi_step`` over uint8 latents and their
  contexts) against one process's, which equal its eager steps;
- JAX's sharded step on a (1, 2) mesh of the CPU's devices, on its t and
  noise through the seams: float32, and bfloat16 within the bf16 steps'
  ``latent_unet`` bound of JAX's eager step (its gap to JAX's jitted (1, 2)
  step printed beside JAX's own eager-to-jit gap);
- the gathered state: JAX's gathered state, through an npz written by rank 0;
- and, as a check with teeth, the head's gather made to sum the loss's
  whole gradient over the model axis: the step leaves one process's.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec

import chip_smoke
from tests import torch_tp_worker as worker
from tests.test_torch_bf16_steps import JIT_RATIO, LOSS_FLOOR, PARAM_BOUNDS, gaps
from tests.test_torch_diffusion import _same_tables
from tests.test_torch_tensor_parallel_latent import (
    JAX_STATS_ATOL,
    JAX_STATS_RTOL,
    RESIDENT_ATOL,
    RESIDENT_STATS_SCALE,
    STATS_SCALE,
    _case,
    _flat,
    _weights,
)
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.io.checkpoint import _flat_items
from tinydiffusion_tpu.models.unet_latent import LatentUNet as JaxLatentUNet
from tinydiffusion_tpu.parallel.mesh import infer_state_sharding as jax_infer_state_sharding
from tinydiffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tinydiffusion_tpu.train.trainer import _raw_step_fn
from tinydiffusion_tpu.train.trainer import create_train_state as jax_create_train_state
from tinydiffusion_tpu.train.trainer import make_train_step as jax_make_train_step
from tinydiffusion_torch.io.checkpoint import load_weights_arrays
from tinydiffusion_torch.io.from_jax import jax_variables, state_dict_by_name
from tinydiffusion_torch.parallel import mesh as mesh_lib

BATCH, SIZE, CHANNELS, TIME_DIM = 8, 8, 4, 32
SEED = 31
# One SGD step against one process: the params within 1e-6 (summation-order
# gaps of the sharded products and the gathered sums), the loss within
# 1e-6 of itself; the BatchNorm statistics within a share of each tensor's
# largest value, as the latent models' TP test holds them.
ONE_LOSS_RTOL, ONE_PARAM_ATOL = 1e-6, 1e-6
# Against JAX's sharded step (float32): JAX's own bounds for its (data,
# model) step against one device, as the UNet28's and the latent models' TP
# tests hold them.
JAX_LOSS_RTOL, JAX_PARAM_ATOL = 2e-5, 2e-5
# The ranks against the card's reference with the ranks' slices: float32
# rounding (its BatchNorm statistics summed in another order).
SLICED_LOSS_RTOL, SLICED_PARAM_ATOL = 1e-6, 1e-7
MESHES = {"m22": (2, 2), "m12": (1, 2)}


def _jax_model(dtype=jnp.float32) -> JaxLatentUNet:
    return JaxLatentUNet(time_dim=TIME_DIM, in_channels=CHANNELS, base_width=8, dtype=dtype)


def _jax_state(dtype=jnp.float32):
    jmodel = _jax_model(dtype)
    tx = optax.sgd(worker.LR)
    example = (jnp.zeros((BATCH, SIZE, SIZE, CHANNELS)), jnp.zeros((BATCH,), jnp.int32),
               jnp.zeros((BATCH, TIME_DIM)))
    return jmodel, tx, jax_create_train_state(jmodel, tx, example, jax.random.PRNGKey(SEED))


def _nhwc(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _jax_tp_step(dtype, x0: np.ndarray, context: np.ndarray) -> dict:
    """JAX's ``make_train_step`` with ``state_sharding=infer_state_sharding``
    on a (1, 2) mesh of the CPU's devices: the loss, the gathered weights
    after and each leaf's dtype."""
    jmodel, tx, jstate = _jax_state(dtype)
    jmesh = jax_make_mesh(("data", "model"), shape=(1, 2), devices=jax.devices()[:2])
    shardings = jax_infer_state_sharding(jstate, jmesh, "model")
    step = jax_make_train_step(jmodel, tx, JaxSchedule.linear(1000), conditional=True,
                               mesh=jmesh, state_sharding=shardings)
    new, loss = step(jax.device_put(jstate, shardings), _nhwc(x0), jnp.asarray(context))
    return {"loss": float(loss), "weights": _flat(new.params, new.batch_stats),
            "dtypes": {k: jnp.asarray(v).dtype for k, v in _flat_items(
                {"params": new.params, "batch_stats": new.batch_stats})[0].items()}}


def _jax_bf16_eager_step(x0: np.ndarray, context: np.ndarray) -> tuple:
    """JAX's bfloat16 step on one device, run eagerly: (loss, weights)."""
    jmodel, tx, jstate = _jax_state(jnp.bfloat16)
    raw = _raw_step_fn(jmodel, tx, JaxSchedule.linear(1000), conditional=True)
    new, loss = raw(jstate, _nhwc(x0), jnp.asarray(context))
    return float(loss), _flat(new.params, new.batch_stats)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, JAX's steps, the one-process steps and every rank's
    results, computed once for the module. The ranks need only JAX's inits
    and draws: they run while JAX compiles and takes its steps."""
    tmp = tmp_path_factory.mktemp("tp_laion")
    rng = np.random.default_rng(32)
    x0 = rng.standard_normal((BATCH, CHANNELS, SIZE, SIZE)).astype(np.float32)
    context = rng.standard_normal((BATCH, TIME_DIM)).astype(np.float32)
    inputs = {"laion_x0": x0, "laion_context": context,
              "laion_rows": rng.integers(0, 256, (4 * BATCH, SIZE, SIZE, CHANNELS)).astype(np.uint8),
              "laion_row_context": rng.standard_normal((4 * BATCH, TIME_DIM)).astype(np.float32)}
    states = {tag: _jax_state(dtype)[2]
              for tag, dtype in (("laion", jnp.float32), ("laion_bf16", jnp.bfloat16))}
    for tag, jstate in states.items():
        torch.save(state_dict_by_name(_flat(jstate.params, jstate.batch_stats)),
                   tmp / f"{tag}.pt")
        inputs[f"{tag}_weights"] = str(tmp / f"{tag}.pt")
    # JAX's draws (``split(rng, 4)``: t, then the noise; both dtypes' states
    # hold the same key), the noise made NCHW.
    _, t_key, noise_key, _ = jax.random.split(states["laion"].rng, 4)
    inputs["laion_t"] = np.asarray(jax.random.randint(t_key, (BATCH,), 0, 1000)).astype(np.int64)
    noise = np.asarray(jax.random.normal(noise_key, (BATCH, SIZE, SIZE, CHANNELS)))
    inputs["laion_noise"] = np.ascontiguousarray(np.transpose(noise, (0, 3, 1, 2)))
    schedule = _same_tables(JaxSchedule.linear(1000))
    inputs.update({f"schedule_{k}": getattr(schedule, k).numpy()
                   for k in ("betas", "alphas", "alphas_cumprod")})
    np.savez(tmp / "inputs.npz", **inputs)
    context_mp = mp.start_processes(worker.run_laion_rank,
                                    args=(str(tmp), str(tmp / "inputs.npz"), str(tmp)), nprocs=4,
                                    join=False, start_method="spawn")
    try:
        jax_runs = {"fp32": _jax_tp_step(jnp.float32, x0, context),
                    "bf16": _jax_tp_step(jnp.bfloat16, x0, context)}
        jax_runs["bf16"]["eager"] = _jax_bf16_eager_step(x0, context)
        one = {case: worker.laion_step(inputs, case) for case in worker.LAION_CASES}
        for case in ("laion", "laion_bf16_jax"):  # the card's reference: the ranks' slices
            with chip_smoke._shard_width_products(2):
                one[f"sliced_{case}"] = worker.laion_step(inputs, case)
        one["resident"] = worker.laion_resident_steps(inputs)
        one["eager"] = worker.laion_eager_steps(inputs)
    finally:
        while not context_mp.join():
            pass
    ranks = [dict(np.load(tmp / f"laion_rank{r}.npz")) for r in range(4)]
    return {"ranks": ranks, "one": one, "jax": jax_runs, "dir": tmp}


def _ranks_of(runs, tag: str) -> list[dict]:
    return [r for r in runs["ranks"] if f"{tag}/place" in r]


def _assert_same_step(got: dict, want_loss: float, want: dict, loss_rtol: float,
                      param_atol: float, stats_rtol: float = 0.0, stats_atol: float = 0.0,
                      stats_scale: float = 0.0) -> None:
    """The loss, the params and the BatchNorm statistics, each statistic
    within ``stats_rtol`` of itself plus ``stats_atol`` plus ``stats_scale``
    of its tensor's largest value."""
    np.testing.assert_allclose(np.asarray(got["loss"]), np.asarray(want_loss), rtol=loss_rtol)
    got = _weights(got)
    assert set(got) == set(want) and want
    for key in sorted(want):
        if key.startswith("batch_stats/"):
            atol = stats_atol + stats_scale * float(np.abs(want[key]).max())
            np.testing.assert_allclose(got[key], want[key], rtol=stats_rtol, atol=atol,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=param_atol, err_msg=key)


# --- the sharding rule --------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4])
def test_sharding_rule_is_jax_leaf_by_leaf(m):
    """JAX's spec of each leaf on an (8 / m, m) mesh against the port's split
    on every model rank: the same leaves split (every conv on its output
    channels, the time MLP and projections on their features, the
    BatchNorm scales, biases and statistics, and the 4-channel head), each
    rank's shard (read through ``jax_variables``) JAX's slice of the leaf's
    last dimension."""
    _, _, jstate = _jax_state()
    jmesh = jax_make_mesh(("data", "model"), shape=(8 // m, m), devices=jax.devices()[:8])
    specs = jax_infer_state_sharding(jstate, jmesh, "model")
    leaves = _flat(jstate.params, jstate.batch_stats)
    spec_leaves, _ = _flat_items({"params": specs.params, "batch_stats": specs.batch_stats})
    whole = state_dict_by_name(leaves)
    for r in range(m):
        model = worker.latent_model("laion")
        shardings = mesh_lib.infer_state_sharding(model, m)
        mesh = mesh_lib.Mesh((8 // m, m), mesh_lib.DataParallel(0, 8 // m),
                             mesh_lib.ModelParallel(r, m))
        mesh_lib.apply_sharding(model, shardings, mesh, state_dict=whole)
        local = jax_variables(model)
        assert set(local) == set(leaves)
        for key, leaf in leaves.items():
            spec = spec_leaves[key].spec
            assert spec == PartitionSpec(*([None] * (leaf.ndim - 1)), "model"), key
            part = leaf.shape[-1] // m
            np.testing.assert_array_equal(local[key], leaf[..., r * part:(r + 1) * part],
                                          err_msg=f"rank {r}: {key}")
    assert shardings["final_conv.weight"] == 0 and shardings["time_mlp_fc2.bias"] == 0
    assert shardings["enc1.block1.bn.num_batches_tracked"] is None
    assert all(v is None for v in mesh_lib.infer_state_sharding(worker.latent_model("laion"), 1).values())


# --- the steps ----------------------------------------------------------------------


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_tp_step_equals_the_one_process_step(runs, tag):
    """Each rank, its own draws, float32: the loss, the params (within 1e-6)
    and the BatchNorm statistics of one process's step on the whole batch,
    once gathered back."""
    ranks = _ranks_of(runs, tag)
    assert len(ranks) == np.prod(MESHES[tag])
    one = runs["one"]["laion"]
    for rank in ranks:
        _assert_same_step(_case(rank, f"{tag}/laion"), float(one["loss"]), _weights(one),
                          ONE_LOSS_RTOL, ONE_PARAM_ATOL, stats_scale=STATS_SCALE)


def test_tp_step_equals_jax_sharded_step(runs):
    """JAX's t and noise through the seams, float32: every (1, 2) rank, and
    one process, end where JAX's ``make_train_step`` with
    ``state_sharding`` ends on its (1, 2) mesh (within 2e-5)."""
    want = runs["jax"]["fp32"]
    for got in [_case(r, "m12/laion_jax") for r in _ranks_of(runs, "m12")] + [
            runs["one"]["laion_jax"]]:
        _assert_same_step(got, want["loss"], want["weights"], JAX_LOSS_RTOL, JAX_PARAM_ATOL,
                          JAX_STATS_RTOL, JAX_STATS_ATOL)


def test_bf16_tp_step_equals_jax_bf16_steps(runs):
    """The bfloat16 step on JAX's draws, every (1, 2) rank and one process:
    within the bf16 steps' ``latent_unet`` bound of JAX's eager step (the
    rounding flax's code writes down), and within JAX's own eager-to-(1, 2)
    gap plus that bound of JAX's jitted (1, 2) step; the loss within that gap
    of the eager step and twice it of the (1, 2) step. The gaps are printed
    (``pytest -s``)."""
    want = runs["jax"]["bf16"]
    eager, tp = want["eager"], (want["loss"], want["weights"])
    bound = PARAM_BOUNDS["latent_unet"][0]
    eager_to_tp = gaps(eager, tp)
    for label, got in [(f"(1, 2) rank {i}", _case(r, "m12/laion_bf16_jax"))
                       for i, r in enumerate(_ranks_of(runs, "m12"))] + [
            ("one process", runs["one"]["laion_bf16_jax"])]:
        port = (float(got["loss"]), _weights(got))
        to_eager, to_tp = gaps(port, eager), gaps(port, tp)
        print(f"LatentUNet bf16 {label}: port vs JAX eager {to_eager}; port vs JAX (1, 2) "
              f"{to_tp}; JAX eager vs JAX (1, 2) {eager_to_tp}")
        assert to_eager["params"] <= bound, (label, to_eager)
        assert to_tp["params"] <= eager_to_tp["params"] + bound, (label, to_tp)
        assert to_eager["loss_rel"] <= eager_to_tp["loss_rel"] + LOSS_FLOOR, (label, to_eager)
        assert to_tp["loss_rel"] <= JIT_RATIO * eager_to_tp["loss_rel"] + LOSS_FLOOR, label


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_resident_tp_steps_equal_the_one_process_steps(runs, tag):
    """``make_resident_multi_step`` over uint8 (N, 8, 8, 4) latents and their
    (N, 32) contexts with the mesh: three steps end where one process's three
    resident steps end, and those are its eager ``make_train_step`` steps on
    the same batches, bit for bit; the model axis is checked once."""
    one, eager = runs["one"]["resident"], runs["one"]["eager"]
    np.testing.assert_array_equal(one["loss"], eager["loss"])
    assert set(one) == set(eager)
    for key in _weights(one):
        np.testing.assert_array_equal(one[key], eager[key], err_msg=key)
    for rank in _ranks_of(runs, tag):
        got = _case(rank, f"{tag}/resident")
        _assert_same_step(got, one["loss"], _weights(one), ONE_LOSS_RTOL, RESIDENT_ATOL,
                          stats_scale=RESIDENT_STATS_SCALE)
        assert int(got["model_axis_checks"]) == 1


def test_gathered_checkpoint_is_jax_gathered_state(runs):
    """The (1, 2) step on JAX's draws, gathered and written by rank 0
    (``io.checkpoint.save_weights``) and read back: JAX's gathered state
    after its sharded step, leaf for leaf in flax's layout."""
    got = load_weights_arrays(str(runs["dir"] / "m12_laion"))
    want = runs["jax"]["fp32"]["weights"]
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=2.0**-7, atol=JAX_PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_every_float_tensor_is_split_and_counters_agree(runs, tag):
    """Every float tensor of a rank holds 1/m of the whole tensor's elements
    (the head included); what stays whole is the BatchNorm step counters,
    bit-equal on the model ranks of a data row after the step."""
    d, m = MESHES[tag]
    whole = _case(runs["one"]["laion"], "shape")
    rows: dict = {}
    for r, rank in enumerate(_ranks_of(runs, tag)):
        assert list(rank[f"{tag}/place"]) == [r // m, d, r % m, m]
        shapes = _case(rank, f"{tag}/laion/shape")
        assert set(shapes) == set(whole)
        for key, shape in shapes.items():
            if key.endswith("num_batches_tracked"):
                assert list(shape) == list(whole[key]), key
            else:
                assert int(np.prod(shape)) * m == int(np.prod(whole[key])), key
        replicated = _case(rank, f"{tag}/laion/replicated")
        assert replicated and all(k.endswith("num_batches_tracked") for k in replicated)
        rows.setdefault(r // m, []).append(replicated)
    for copies in rows.values():
        for other in copies[1:]:
            for key, want in copies[0].items():
                np.testing.assert_array_equal(other[key], want, err_msg=key)


def test_a_summed_head_gather_fails(runs):
    """The head's gather with a backward that sums the loss's whole gradient
    over the model axis (where each rank's is already whole): the (1, 2)
    step leaves one process's by far more than the bound, in the head and
    upstream of it; the forward, and so the loss, is unchanged."""
    one = runs["one"]["laion"]
    for rank in _ranks_of(runs, "m12"):
        got = _case(rank, "m12/teeth_sum")
        np.testing.assert_allclose(float(got["loss"]), float(one["loss"]), rtol=ONE_LOSS_RTOL)
        with pytest.raises(AssertionError):
            _assert_same_step(got, float(one["loss"]), _weights(one), ONE_LOSS_RTOL,
                              ONE_PARAM_ATOL, stats_scale=STATS_SCALE)
        for key in ("params/final_conv/kernel", "params/enc1/block1/conv/kernel"):
            assert np.abs(got[key] - one[key]).max() > 100 * ONE_PARAM_ATOL, key


@pytest.mark.parametrize("case", ["laion", "laion_bf16_jax"])
def test_the_cards_sliced_reference_is_the_ranks_arithmetic(runs, case):
    """``chip_smoke.py``'s tp phase holds the ranks to a one-process step
    whose products are computed as the ranks compute theirs
    (``_shard_width_products``: output slices, each slice's weight gradient,
    the input gradient as the slices' partials summed, in float32 for
    bf16). Here that step, float32 and bf16, ends where the (1, 2) ranks end,
    to float32 rounding; and after the block the layers' products are their
    own again."""
    from tinydiffusion_torch.nn import layers

    sliced = runs["one"][f"sliced_{case}"]
    for rank in _ranks_of(runs, "m12"):
        _assert_same_step(_case(rank, f"m12/{case}"), float(sliced["loss"]), _weights(sliced),
                          SLICED_LOSS_RTOL, SLICED_PARAM_ATOL, stats_scale=STATS_SCALE)
    assert layers.Linear.__dict__["product"].__class__ is staticmethod
    assert layers.Conv2d.product.__qualname__ == "Conv2d.product"
