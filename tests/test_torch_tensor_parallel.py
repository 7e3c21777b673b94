"""The model axis (tensor parallelism) of the port's ``parallel/mesh.py`` on the CPU.

JAX shards the train state over a ``model`` mesh axis by
``infer_state_sharding`` and GSPMD derives the collectives; its
``tests/test_tensor_parallel.py`` holds the ``(data, model)`` step to the
one-device step. The port writes the collectives out. Four processes in a
gloo group (``torch.multiprocessing``, a ``file://`` rendezvous;
``tests/torch_tp_worker.py``) take one SGD step of the small UNet28 on the
``(2, 2)`` mesh (and the data axis alone at ``(4, 1)``), then two of them on
``(1, 2)``, and the test holds them to

- the sharding rule: the port's ``infer_state_sharding``, name by name
  through the weight converter, splits the same tensors as JAX's at m = 2, 4
  and 8, to the same shard shapes, for the unconditional and the
  class-conditional UNet28;
- the port's one-process step on the whole batch (its own draws) and JAX's
  ``_raw_step_fn`` (its draws through the seams), unconditional and
  class-conditional with label dropout and an EMA: the loss, the params,
  the BatchNorm statistics and the EMA, gathered back; and three resident
  steps (``make_resident_multi_step``) against one process's;
- each rank's shards being 1/m of the whole shapes, the one-channel head
  whole, and the gathered checkpoint's npz being the one-process run's;
- and, as a check with teeth, apart from the one-process step when the
  gather's backward splits its gradient instead of reduce-scattering it.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec

from tests import torch_tp_worker as worker
from tests.test_torch_bf16_steps import check_bf16_step, float32_broadcast_sums
from tests.test_torch_diffusion import _same_tables
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.io.checkpoint import _flat_items
from tinydiffusion_tpu.models.unet28 import UNet28 as JaxUNet28
from tinydiffusion_tpu.parallel.mesh import infer_state_sharding as jax_infer_state_sharding
from tinydiffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tinydiffusion_tpu.train.trainer import _raw_step_fn
from tinydiffusion_tpu.train.trainer import create_train_state as jax_create_train_state
from tinydiffusion_tpu.train.trainer import make_train_step as jax_make_train_step
from tinydiffusion_torch.io.checkpoint import load_weights_arrays, save_weights
from tinydiffusion_torch.io.from_jax import jax_variables, unet28_state_dict
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.parallel import mesh as mesh_lib

BATCH = 16
# JAX's own bounds for its (data, model) step against one device, SGD 1e-2
# (tests/test_tensor_parallel.py): the summation order of the reduce-scatters
# and of the data axis's sums is not one device's.
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
# BatchNorm statistics: test_torch_parallel's bounds (2 float32 ulps of the
# variances against one process; 1e-4 relative against flax's fast variance).
STATS_RTOL, STATS_ATOL = 2.0**-22, 1e-5
JAX_STATS_RTOL, JAX_STATS_ATOL = 1e-4, 1e-6
# A bfloat16 npz: one bf16 ulp apart at most where the float32 values differ
# by the bounds above.
NPZ_RTOL = 2.0**-7
# Three resident steps: each step's summation-order gaps (the data axis's
# float64 global statistics and its gradient sums among them) move the
# BatchNorm inputs and the gradients of the next, so after three steps the
# params and running statistics part by more than one step's bounds (up to
# 9e-5 absolute at (2, 2), 6e-6 relative at (1, 2), seen on the CPU).
RESIDENT_ATOL, RESIDENT_STATS_RTOL = 2e-4, 1e-4
# bfloat16 against JAX's bf16 step: the port rounds where flax's code
# rounds (``nn.layers``), so one process and (1, 2) alike part from JAX's
# jitted (1, 2) step by 1.3e-4 of the loss and 0.058 of a BatchNorm variance
# (seen on the CPU; 9.2e-4 and 0.46 under autocast). The largest param gap,
# 3.3e-3 after one SGD step at 1e-2 to JAX's jitted step and to its eager
# one alike, is the one-channel head's bias: JAX's CPU backend sums its
# gradient (a broadcast's transpose) in bf16 over B*H*W terms, each add
# rounded; with that sum in float32 the gap is 2e-5 (printed by
# ``check_bf16_step``, which holds the param gap to JAX's eager step to
# BF16_PARAM_ATOL as well).
BF16_LOSS_RTOL, BF16_PARAM_ATOL, BF16_STATS_RTOL, BF16_STATS_ATOL = 5e-4, 5e-3, 5e-3, 1e-2
# The bf16 TP step against one process's: the norm of the params' gap after
# one SGD step (1.7e-6 with float32 partials, 1.1e-4 with bf16-rounded ones,
# seen on the CPU); and four Adam steps' losses (within 1.1e-4 relative).
BF16_TP_NORM, BF16_TRAJECTORY_RTOL = 1e-5, 5e-4
TO_NCHW = (0, 3, 1, 2)
MESHES = {"m22": (2, 2), "m12": (1, 2)}


def _jax_state(conditional: bool, dtype=jnp.float32):
    jmodel = JaxUNet28(**worker.UNET_SMALL, num_classes=worker.NUM_CLASSES if conditional else None,
                       dtype=dtype)
    tx = optax.sgd(worker.LR)
    example = (jnp.zeros((BATCH, 28, 28, 1)), jnp.zeros((BATCH,), jnp.int32))
    if conditional:
        example += (jnp.zeros((BATCH,), jnp.int32),)
    state = jax_create_train_state(jmodel, tx, example, jax.random.PRNGKey(3 if conditional else 0),
                                   ema=conditional)
    return jmodel, tx, state


def _jax_step(conditional: bool, x0_nhwc: np.ndarray, y: np.ndarray) -> dict:
    """JAX's step from its own init, with its draws: the weights (as the
    port's state dict), the draws, the loss and the weights after."""
    jmodel, tx, jstate = _jax_state(conditional)
    keys = jax.random.split(jstate.rng, 5 if conditional else 4)
    draws = {"t": np.asarray(jax.random.randint(keys[1], (BATCH,), 0, 1000)).astype(np.int64),
             "noise": np.asarray(jax.random.normal(keys[2], x0_nhwc.shape)).transpose(TO_NCHW)}
    kw = {}
    if conditional:
        draws["keep"] = np.asarray(jax.random.bernoulli(keys[4], 1.0 - worker.LABEL_DROPOUT,
                                                        (BATCH,)))
        kw = dict(conditional=True, label_dropout=worker.LABEL_DROPOUT,
                  null_label=worker.NULL_LABEL, ema_decay=worker.EMA_DECAY)
    jschedule = JaxSchedule.linear(1000)
    args = (jnp.asarray(x0_nhwc),) + ((jnp.asarray(y),) if conditional else ())
    new, loss = jax.jit(_raw_step_fn(jmodel, tx, jschedule, **kw))(jstate, *args)
    flat, _ = _flat_items({"params": jstate.params, "batch_stats": jstate.batch_stats})
    after, _ = _flat_items({"params": new.params, "batch_stats": new.batch_stats})
    return {"state_dict": unet28_state_dict({k: np.asarray(v) for k, v in flat.items()}),
            "schedule": jschedule, "loss": float(loss), **draws,
            "weights": {k: np.asarray(v) for k, v in after.items()}}


def _jax_bf16_tp_step(x0_nhwc: np.ndarray) -> dict:
    """JAX's bfloat16 UNet28 through ``make_train_step`` with
    ``state_sharding=infer_state_sharding(...)`` on a (1, 2) mesh of the CPU's
    devices, from the float32 test's init and on its draws (the same key):
    the loss, the weights after, and each collective of the compiled program
    as (op, result dtype, the op that feeds it)."""
    jmodel, tx, jstate = _jax_state(False, jnp.bfloat16)
    jmesh = jax_make_mesh(("data", "model"), shape=(1, 2), devices=jax.devices()[:2])
    shardings = jax_infer_state_sharding(jstate, jmesh, "model")
    step = jax_make_train_step(jmodel, tx, JaxSchedule.linear(1000), mesh=jmesh,
                               state_sharding=shardings)
    jstate, x0 = jax.device_put(jstate, shardings), jnp.asarray(x0_nhwc)
    compiled = step.lower(jstate, x0).compile()
    new, loss = compiled(jstate, x0)
    after, _ = _flat_items({"params": new.params, "batch_stats": new.batch_stats})
    ops = {}
    for line in compiled.as_text().splitlines():
        m = re.match(r"\s*(?:ROOT )?(%\S+) = (\w+)\[[^=]*? ([a-z\-]+)\((%[^,)\s]+)", line)
        if m:
            ops[m.group(1)] = (m.group(3), m.group(2), m.group(4))
    collectives = [(op, dtype, ops.get(arg, ("?",))[0]) for op, dtype, arg in ops.values()
                   if op.startswith(("all-reduce", "reduce-scatter", "all-gather"))]
    return {"loss": float(loss), "weights": {k: np.asarray(v) for k, v in after.items()},
            "collectives": collectives}


def _jax_bf16_eager_steps(x0_nhwc: np.ndarray) -> dict:
    """JAX's bfloat16 step of ``_jax_bf16_tp_step`` on one device, run
    eagerly (op by op), as it is and with its broadcasts' transposes summed
    in float32 (``float32_broadcast_sums``): ``(loss, weights)`` each."""
    jmodel, tx, jstate = _jax_state(False, jnp.bfloat16)
    raw = _raw_step_fn(jmodel, tx, JaxSchedule.linear(1000))
    out = {}
    for name, context in (("eager", contextlib.nullcontext), ("sums", float32_broadcast_sums)):
        with context():
            new, loss = raw(jstate, jnp.asarray(x0_nhwc))
        after, _ = _flat_items({"params": new.params, "batch_stats": new.batch_stats})
        out[name] = (float(loss), {k: np.asarray(v) for k, v in after.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, JAX's steps, the one-process steps and every rank's
    results, computed once for the module."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(20)
    x0 = rng.uniform(-1, 1, (BATCH, 28, 28, 1)).astype(np.float32)
    cond_x0 = rng.uniform(-1, 1, (BATCH, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    jax_runs = {"unet": _jax_step(False, x0, y), "cond": _jax_step(True, cond_x0, y),
                "unet_bf16_tp": _jax_bf16_tp_step(x0), "unet_bf16_eager": _jax_bf16_eager_steps(x0)}
    assert jax_runs["cond"]["keep"].any() and not jax_runs["cond"]["keep"].all()
    torch.save(jax_runs["unet"]["state_dict"], tmp / "unet.pt")
    torch.save(jax_runs["cond"]["state_dict"], tmp / "cond.pt")
    schedule = _same_tables(jax_runs["unet"]["schedule"])
    inputs = {
        "unet_weights": str(tmp / "unet.pt"), "cond_weights": str(tmp / "cond.pt"),
        "unet_x0": x0.transpose(TO_NCHW), "cond_x0": cond_x0.transpose(TO_NCHW), "cond_y": y,
        "resident_images": rng.integers(0, 256, (4 * BATCH, 28, 28, 1)).astype(np.uint8),
        **{f"{case}_{k}": jax_runs[case][k] for case in ("unet", "cond")
           for k in ("t", "noise", "keep") if k in jax_runs[case]},
        **{f"schedule_{k}": getattr(schedule, k).numpy()
           for k in ("betas", "alphas", "alphas_cumprod")},
    }
    np.savez(tmp / "inputs.npz", **inputs)
    mp.start_processes(worker.run_rank, args=(str(tmp), str(tmp / "inputs.npz"), str(tmp)),
                       nprocs=4, start_method="spawn")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {case: worker.step(inputs, case) for case in worker.CASES}
        one["resident"] = worker.resident_steps(inputs)
        one["narrow"] = worker.narrow_step(inputs)
        one["bf16_trajectory"] = worker.bf16_trajectory(inputs)
        del one["narrow"]["sharded"]
        save_weights(str(tmp / "one_cond"), {k: v for k, v in one["cond"].items()
                                             if k != "loss" and not k.startswith("shape/")})
    finally:
        torch.set_num_threads(threads)
    return {"ranks": ranks, "one": one, "jax": jax_runs, "dir": tmp}


def _case(rank: dict, prefix: str) -> dict:
    prefix += "/"
    return {k[len(prefix):]: v for k, v in rank.items() if k.startswith(prefix)}


def _weights(result: dict) -> dict:
    return {k: v for k, v in result.items()
            if k != "loss" and k.split("/")[0] not in ("shape", "replicated")}


def _assert_same_step(got: dict, want_loss: float, want: dict, stats_rtol: float,
                      stats_atol: float) -> None:
    np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
    got = _weights(got)
    want = {k: v for k, v in want.items() if k in got or not k.startswith("ema_")}
    assert set(want) <= set(got) and want
    for key in sorted(want):
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got[key], want[key], rtol=stats_rtol, atol=stats_atol,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=PARAM_ATOL, err_msg=key)


def _ranks_of(runs, tag: str) -> list[dict]:
    return [r for r in runs["ranks"] if f"{tag}/place" in r]


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("conditional", [False, True])
def test_sharding_rule_is_jax_leaf_by_leaf(m, conditional):
    """JAX's spec of each params/batch_stats leaf on a (8 / m, m) mesh of the
    CPU's devices against the port's: the same leaves split (the head
    whole), to the same shard shapes, read through ``jax_variables`` on the
    port's sharded model."""
    _, _, jstate = _jax_state(conditional)
    jmesh = jax_make_mesh(("data", "model"), shape=(8 // m, m), devices=jax.devices()[:8])
    specs = jax_infer_state_sharding(jstate, jmesh, "model")
    leaves, _ = _flat_items({"params": jstate.params, "batch_stats": jstate.batch_stats})
    spec_leaves, _ = _flat_items({"params": specs.params, "batch_stats": specs.batch_stats})
    model = UNet28(**worker.UNET_SMALL, num_classes=worker.NUM_CLASSES if conditional else None)
    shardings = mesh_lib.infer_state_sharding(model, m)
    mesh = mesh_lib.Mesh((8 // m, m), mesh_lib.DataParallel(0, 8 // m),
                         mesh_lib.ModelParallel(0, m))
    mesh_lib.apply_sharding(model, shardings, mesh)
    local = jax_variables(model)
    assert set(local) == set(leaves)
    split = 0
    for key, leaf in leaves.items():
        spec = spec_leaves[key].spec
        sharded = spec == PartitionSpec(*([None] * (leaf.ndim - 1)), "model")
        assert sharded or spec == PartitionSpec(), key
        want = leaf.shape[:-1] + (leaf.shape[-1] // m,) if sharded else leaf.shape
        assert local[key].shape == want, key
        split += sharded
    assert spec_leaves["params/final_conv/kernel"].spec == PartitionSpec()
    assert local["params/final_conv/kernel"].shape == leaves["params/final_conv/kernel"].shape
    assert split == len(leaves) - 2  # all but the head's kernel and bias
    assert all(v is None for v in mesh_lib.infer_state_sharding(model, 1).values())


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("case", ["unet", "cond"])
def test_tp_step_equals_the_one_process_step(runs, tag, case):
    """Each rank, its own draws: the loss, the params, the BatchNorm
    statistics (and the EMA) of one process's step on the whole batch, once
    gathered back."""
    ranks = _ranks_of(runs, tag)
    assert len(ranks) == np.prod(MESHES[tag])
    one = runs["one"][case]
    for rank in ranks:
        _assert_same_step(_case(rank, f"{tag}/{case}"), float(one["loss"]), _weights(one),
                          STATS_RTOL, STATS_ATOL)


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("case", ["unet", "cond"])
def test_tp_step_equals_jax_on_its_draws(runs, tag, case):
    """JAX's draws (t, noise, and the kept labels) through the seams: every
    rank, and one process, end where JAX's ``_raw_step_fn`` ends."""
    jax_run = runs["jax"][case]
    for got in [_case(r, f"{tag}/{case}_jax") for r in _ranks_of(runs, tag)] + [
            runs["one"][f"{case}_jax"]]:
        _assert_same_step(got, jax_run["loss"], jax_run["weights"], JAX_STATS_RTOL,
                          JAX_STATS_ATOL)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_resident_tp_steps_equal_the_one_process_steps(runs, tag):
    """``make_resident_multi_step`` with the mesh: three steps over a
    resident set (each data row its columns of the index batches) end where
    one process's three steps end."""
    one = runs["one"]["resident"]
    assert len(one["loss"]) == worker.RESIDENT_STEPS
    for rank in _ranks_of(runs, tag):
        got = _case(rank, f"{tag}/resident")
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        assert set(_weights(got)) == set(_weights(one))
        for key, want in _weights(one).items():
            rtol = RESIDENT_STATS_RTOL if key.startswith("batch_stats/") else 0
            np.testing.assert_allclose(got[key], want, rtol=rtol, atol=RESIDENT_ATOL, err_msg=key)


def test_a_whole_layer_feeding_a_sharded_one(runs):
    """At (1, 4) a UNet28 of base width 2 keeps its stem whole (2 channels do
    not split four ways) and shards enc1 (4): the stem's input gradient is
    summed over the model axis (``_SumGradients``), and the step is one
    process's."""
    one = runs["one"]["narrow"]
    for rank in runs["ranks"]:
        got = _case(rank, "m14/narrow")
        sharded = set(got.pop("sharded").tolist())
        assert "enc1.block1.conv.weight" in sharded
        assert not {"initial_conv.weight", "initial_conv.bias"} & sharded
        _assert_same_step(got, float(one["loss"]), _weights(one), STATS_RTOL, STATS_ATOL)


def test_data_axis_alone_through_the_mesh(runs):
    """``make_mesh(("data",))`` on four ranks: model size 1, the data axis the
    ``DataParallel`` steps take; the step is the one-process step."""
    ranks = _ranks_of(runs, "m41")
    assert [list(r["m41/place"]) for r in ranks] == [[i, 4, 0, 1] for i in range(4)]
    one = runs["one"]["unet"]
    for rank in ranks:
        _assert_same_step(_case(rank, "m41/unet"), float(one["loss"]), _weights(one),
                          STATS_RTOL, STATS_ATOL)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_ranks_sit_as_jax_places_devices_and_hold_1_over_m(runs, tag):
    """Rank r at (r // m, r % m); each rank's sharded tensors 1/m of the
    whole (dim 0, the embedding's dim 1), the head and the counters whole."""
    d, m = MESHES[tag]
    for r, rank in enumerate(_ranks_of(runs, tag)):
        assert list(rank[f"{tag}/place"]) == [r // m, d, r % m, m]
        for case in ("unet", "cond"):
            shapes = _case(rank, f"{tag}/{case}/shape")
            whole = _case(runs["one"][case], "shape")
            assert set(shapes) == set(whole)
            for name, shape in shapes.items():
                full = list(whole[name])
                if name.startswith("final_conv.") or name.endswith("num_batches_tracked"):
                    assert list(shape) == full, name
                else:
                    dim = 1 if name == "class_embedding.weight" else 0
                    assert shape[dim] * m == full[dim], name
                    assert [s for i, s in enumerate(shape) if i != dim] == [
                        s for i, s in enumerate(full) if i != dim], name


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_gathered_checkpoint_is_the_one_process_runs(runs, tag):
    """The conditional run's weights, gathered and written by rank 0 through
    ``io.checkpoint.save_weights``: the one-process npz's keys, shapes and
    values (one bfloat16 ulp at most, the float32 values agreeing to the
    bounds above), EMA included."""
    got = load_weights_arrays(str(runs["dir"] / f"{tag}_cond"))
    want = load_weights_arrays(str(runs["dir"] / "one_cond"))
    assert set(got) == set(want) and any(k.startswith("ema_params/") for k in got)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=NPZ_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_a_gather_that_splits_its_gradient_would_fail(runs, tag):
    """With the gather's backward taking each rank's slice of its partial
    gradient instead of the reduce-scatter, the step leaves the one-process
    step by far more than the bound (the forward, and so the loss, stay)."""
    one = runs["one"]["unet"]
    for rank in _ranks_of(runs, tag):
        got = _case(rank, f"{tag}/teeth")
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        gap = max(np.abs(got[k] - one[k]).max() for k in _weights(one))
        assert gap > 10 * PARAM_ATOL
        with pytest.raises(AssertionError):
            _assert_same_step(got, float(one["loss"]), _weights(one), STATS_RTOL, STATS_ATOL)


@pytest.mark.parametrize("tag,case", [("m22", "unet"), ("m22", "cond"), ("m12", "unet"),
                                      ("m12", "cond"), ("m14", "narrow")])
def test_replicated_tensors_stay_equal_on_every_model_rank(runs, tag, case):
    """Each tensor the model axis leaves whole (the head; at (1, 4) the stem
    and its BatchNorm too) is bit-equal on the model ranks of a data row
    after the step: the replicated gradients are averaged over the axis."""
    rows = {}
    for rank in _ranks_of(runs, tag):
        rows.setdefault(int(rank[f"{tag}/place"][0]), []).append(
            _case(rank, f"{tag}/{case}/replicated"))
    for copies in rows.values():
        assert len(copies) == MESHES.get(tag, (1, 4))[1]
        assert "final_conv.weight" in copies[0] and "final_conv.bias" in copies[0]
        for other in copies[1:]:
            assert set(other) == set(copies[0])
            for name, want in copies[0].items():
                np.testing.assert_array_equal(other[name], want, err_msg=name)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_a_gather_that_sums_a_whole_gradient_would_fail(runs, tag):
    """With the gather before the one-channel head summing its gradient over
    the model axis, as it must for a sharded consumer (the head's gradient
    is whole on every rank already, so every gradient above it comes out m
    times too large), the step leaves the one-process step by far more than
    the bound; the loss, a forward value, stays."""
    one = runs["one"]["unet"]
    for rank in _ranks_of(runs, tag):
        got = _case(rank, f"{tag}/teeth_sum")
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        gap = max(np.abs(got[k] - one[k]).max() for k in _weights(one))
        assert gap > 10 * PARAM_ATOL
        with pytest.raises(AssertionError):
            _assert_same_step(got, float(one["loss"]), _weights(one), STATS_RTOL, STATS_ATOL)


def test_other_models_refuse_a_model_axis():
    """The models JAX's steps shard on no model axis (the MNIST VAE and the
    conv-VAE: their steps take no ``state_sharding``) raise on a model axis
    of two, naming what is ported; at model size 1 they shard nothing."""
    from tinydiffusion_torch.models.vae_conv import ConvVAE
    from tinydiffusion_torch.models.vae_mnist import VAEMnist

    mesh = mesh_lib.Mesh((1, 2), mesh_lib.DataParallel(0, 1), mesh_lib.ModelParallel(0, 2))
    for model in (VAEMnist(), ConvVAE(image_size=64)):
        with pytest.raises(NotImplementedError, match="ported for every denoiser.*UNet28"):
            mesh_lib.apply_sharding(model, mesh_lib.infer_state_sharding(model, 2), mesh)
    one = mesh_lib.Mesh((1, 1), mesh_lib.DataParallel(0, 1), mesh_lib.ModelParallel(0, 1))
    model = VAEMnist()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mesh_lib.apply_sharding(model, mesh_lib.infer_state_sharding(model, one), one)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_make_mesh_without_a_group_and_bad_shapes():
    mesh = mesh_lib.make_mesh()
    assert mesh.shape == (1, 1) and mesh.dp is None and mesh.mp is None
    with pytest.raises(ValueError, match="mesh shape"):
        mesh_lib.make_mesh(("data", "model"), (1, 2))
    with pytest.raises(ValueError, match="axes"):
        mesh_lib.make_mesh(("model", "data"))


def _params_gap_norm(got: dict, want: dict) -> float:
    """The norm of the parameters' difference, every leaf together."""
    return float(np.sqrt(sum(((got[k] - want[k]) ** 2).sum() for k in want
                             if k.startswith("params/"))))


def _assert_bf16_close(got: dict, want_loss: float, want: dict) -> None:
    np.testing.assert_allclose(got["loss"], want_loss, rtol=BF16_LOSS_RTOL)
    assert set(want) <= set(got)
    for key in sorted(want):
        rtol, atol = ((BF16_STATS_RTOL, BF16_STATS_ATOL) if key.startswith("batch_stats/")
                      else (0, BF16_PARAM_ATOL))
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol, err_msg=key)


def test_bf16_tp_step_equals_jax_bf16_tp_step(runs):
    """JAX's bf16 UNet28 step on its (1, 2) mesh (``make_train_step`` with
    ``state_sharding``) against the port's bf16 TP step at (1, 2) on the same
    draws (SGD): the loss, the params and the BatchNorm statistics within the
    bf16 bounds, which the port's one-process bf16 step meets as well. Both
    are also held to JAX's eager one-device step as ``test_torch_bf16_steps``
    holds the latent models' (``check_bf16_step``): the params within
    BF16_PARAM_ATOL of it, the loss within JAX's own eager-to-jit gap of it
    and within twice that gap of JAX's jitted step."""
    want = runs["jax"]["unet_bf16_tp"]
    eager = runs["jax"]["unet_bf16_eager"]
    for name, got in [(f"(1, 2) rank {i}", _case(r, "m12/unet_bf16_jax"))
                      for i, r in enumerate(_ranks_of(runs, "m12"))] + [
            ("one process", runs["one"]["unet_bf16_jax"])]:
        weights = {k: v for k, v in got.items() if k.startswith(("params/", "batch_stats/"))}
        check_bf16_step(f"UNet28 {name}", (float(got["loss"]), weights), eager["eager"],
                        (want["loss"], want["weights"]), eager["sums"],
                        (BF16_PARAM_ATOL, BF16_PARAM_ATOL))
        _assert_bf16_close(got, want["loss"], want["weights"])


def test_bf16_tp_sums_float32_partials_as_jax_does(runs):
    """JAX's compiled bf16 (1, 2) step runs every collective in float32, each
    all-reduce fed by a float32 convolution (or dot) of the bf16 operands:
    the partial input gradients are summed unrounded. The port's sharded
    layers give float32 partials too (``parallel.mesh.apply_full``): its bf16
    TP step stays within ``BF16_TP_NORM`` of its one-process step, where the
    same step with each partial rounded to bf16 before the sum (the port
    before) does not."""
    collectives = runs["jax"]["unet_bf16_tp"]["collectives"]
    assert collectives and all(dtype == "f32" for _, dtype, _ in collectives), collectives
    fed = [source for op, _, source in collectives if op.startswith("all-reduce")]
    assert fed and all(source in ("convolution", "dot", "fusion") for source in fed), fed
    assert "convolution" in fed
    one = runs["one"]["unet_bf16_jax"]
    for rank in _ranks_of(runs, "m12"):
        repaired = _params_gap_norm(_case(rank, "m12/unet_bf16_jax"), one)
        rounded = _params_gap_norm(_case(rank, "m12/bf16_rounded"), one)
        print("bf16 (1, 2) step vs one process, params gap norm: float32 partials",
              repaired, "bf16-rounded partials", rounded)
        assert repaired < BF16_TP_NORM < rounded


def test_bf16_tp_adam_trajectory_stays_near_one_process(runs):
    """Four bf16 Adam steps at (1, 2) (the step's own draws) against the
    same steps in one process: each loss within ``BF16_TRAJECTORY_RTOL``
    (Adam's scale-free update carries the summation-order gaps forward), with
    float32 partials and, for the record, rounded ones."""
    one = runs["one"]["bf16_trajectory"]
    for rank in _ranks_of(runs, "m12"):
        gaps = {}
        for name in ("bf16_trajectory", "bf16_trajectory_rounded"):
            got = _case(rank, f"m12/{name}")
            gaps[name] = (np.abs(got["loss"] - one["loss"]) / one["loss"],
                          _params_gap_norm(got, one))
        print("bf16 (1, 2) trajectory vs one process: loss rel, params gap norm", gaps)
        assert gaps["bf16_trajectory"][0].max() < BF16_TRAJECTORY_RTOL, gaps
