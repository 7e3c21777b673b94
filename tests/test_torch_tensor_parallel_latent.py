"""The model axis for the latent denoisers (the MLP UNet and the DiT) on the CPU,
and the DiT through ``make_train_step``.

JAX's ``make_train_step`` takes any denoiser on (B, D) latents and runs it
tensor-parallel when given ``state_sharding=infer_state_sharding(state, mesh,
"model")``. The port's counterpart is ``make_train_step(mesh=...)`` after
``parallel.mesh.apply_sharding``. Four processes in a gloo group
(``torch.multiprocessing``, a ``file://`` rendezvous;
``tests/torch_tp_worker.py::run_latent_rank``) take one SGD step of the small
MLP UNet and DiT (one token, and four) on the ``(2, 2)`` mesh, then two of
them on ``(1, 2)``, and the test holds them to

- the sharding rule: for every flax leaf of both models at m = 2 and 4, the
  port's split (read back through the weight converter) is JAX's, shard
  contents included: the DiT's query, key and value on head_dim, a strided
  slice of torch's weight;
- the port's one-process step on the whole batch (its own draws), in
  float32, and three resident steps (``make_resident_multi_step``) against
  one process's, which equal one process's eager steps;
- JAX's ``make_train_step`` with ``state_sharding`` on a (1, 2) mesh of the
  CPU's devices, on its draws (t, noise and flax's dropout masks) through
  the seams: float32, and bfloat16 within the gaps of the bf16 steps to
  JAX's jitted step (``tests/test_torch_bf16_steps.py``);
- the gathered state: JAX's gathered state, through ``io/from_jax.py`` and
  an npz written by rank 0;
- and, as a check with teeth, a sharding rule that splits q, k and v
  contiguously by head: both the rule's test and the JAX comparison fail.

First, the repaired fault: the port's ``make_train_step`` trains a
dropout-0.05 DiT (JAX's default) on one process, equal to JAX's step on the
committed weights with JAX's draws replayed.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec

from tests import torch_tp_worker as worker
from tests.test_torch_bf16_steps import JIT_RATIO, LOSS_FLOOR, PARAM_BOUNDS, gaps
from tests.test_torch_diffusion import _same_tables
from tests.test_torch_latent import _jax_variables, _port_model
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.io.checkpoint import _flat_items
from tinydiffusion_tpu.models.dit import DiT as JaxDiT
from tinydiffusion_tpu.models.mlp_unet import MLPUNetLatent as JaxMLPUNet
from tinydiffusion_tpu.parallel.mesh import infer_state_sharding as jax_infer_state_sharding
from tinydiffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tinydiffusion_tpu.train.trainer import DiffusionTrainState as JaxTrainState
from tinydiffusion_tpu.train.trainer import _raw_step_fn
from tinydiffusion_tpu.train.trainer import create_train_state as jax_create_train_state
from tinydiffusion_tpu.train.trainer import make_train_step as jax_make_train_step
from tinydiffusion_torch.io.checkpoint import load_weights_arrays
from tinydiffusion_torch.io.from_jax import jax_variables, state_dict_by_name
from tinydiffusion_torch.models.dit import DiT
from tinydiffusion_torch.ops.qsample import q_sample_fused_reference
from tinydiffusion_torch.parallel import mesh as mesh_lib
from tinydiffusion_torch.train import trainer

BATCH, LATENT = 16, 20
SEEDS = {"mlp": 11, "dit": 12, "dit4": 13}
# float32: JAX's own bounds for its (data, model) step against one device
# (tests/test_tensor_parallel.py), as the UNet28's TP test holds them; the
# BatchNorm statistics against flax's fast variance 1e-4 relative, as there.
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
JAX_STATS_RTOL, JAX_STATS_ATOL = 1e-4, 1e-6
# The MLP UNet's BatchNorm statistics against one process, within a share
# of each statistic tensor's largest value: at (2, 2) the data axis's
# global sums and the sharded products add in another order than one
# process's, and the small model's running variances reach ~120, where
# small entries part by up to 2.4e-4 of themselves. One step: 2^-20 (seen
# 5.3e-7 at (2, 2); 0 at (1, 2)).
STATS_SCALE = 2.0**-20
# Three resident steps: the summation-order gaps of one step carry into the
# next (the UNet28 TP test's params bound; seen 4.2e-5 at (2, 2)); the
# statistics within 3e-4 of the tensor's largest value (seen 1.27e-4 at
# (2, 2), 6.6e-6 at (1, 2)).
RESIDENT_ATOL, RESIDENT_STATS_SCALE = 2e-4, 3e-4
# bfloat16: the port's step (one process and (1, 2)) is held as
# ``test_torch_bf16_steps.check_bf16_step`` holds the bf16 steps (without its
# float32-sums diagnostic): to JAX's eager one-device step
# (the rounding flax's code writes down) within the bf16 steps' eager param
# bounds (tests/test_torch_bf16_steps.py::PARAM_BOUNDS), and to JAX's
# jitted (1, 2) step within JAX's own eager-to-(1, 2) gap: the loss within
# twice it (plus a float32 floor), the params within it plus the eager
# bound. JAX's jitted (1, 2) step equals its jitted one-device step here
# (CPU), and at this size lies 2.1e-3 (MLP UNet) and 9.8e-6 (DiT) from its
# eager step in the params.
BF16_MODELS = {"mlp": "mlp_unet", "dit": "dit"}
# The committed DiT through make_train_step against JAX's (float32, one
# SGD step at 1e-2, B = 16): test_torch_latent's step bounds.
DIT_LOSS_RTOL, DIT_PARAM_ATOL = 1e-5, 1e-5
MESHES = {"m22": (2, 2), "m12": (1, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(name: str, dtype=jnp.float32):
    cls, options = worker.LATENT_MODELS[name]
    return (JaxDiT if cls is DiT else JaxMLPUNet)(dtype=dtype, **options)


def _jax_state(name: str, dtype=jnp.float32):
    jmodel = _jax_model(name, dtype)
    tx = optax.sgd(worker.LR)
    example = (jnp.zeros((BATCH, LATENT)), jnp.zeros((BATCH,), jnp.int32),
               jnp.zeros((BATCH,), jnp.int32))
    return jmodel, tx, jax_create_train_state(jmodel, tx, example, jax.random.PRNGKey(SEEDS[name]))


def _flat(params, batch_stats) -> dict:
    flat, _ = _flat_items({"params": params, "batch_stats": batch_stats})
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32)) for k, v in flat.items()}


@contextlib.contextmanager
def _recording_bernoulli(drawn: list):
    """``jax.random.bernoulli`` appending each draw to ``drawn``."""
    bernoulli = jax.random.bernoulli

    def record(*args, **kwargs):
        keep = bernoulli(*args, **kwargs)
        drawn.append(np.asarray(keep))
        return keep

    jax.random.bernoulli = record
    try:
        yield
    finally:
        jax.random.bernoulli = bernoulli


def _jax_draws(jmodel, jstate, x0: np.ndarray, y: np.ndarray) -> dict:
    """The draws of JAX's step from ``jstate.rng`` (``split(rng, 4)``): t, the
    noise and flax's dropout masks, the masks recorded from an eager train
    apply under the step's dropout key (they depend on the key and the
    shapes only), per block (attention weights, attention output, ff)."""
    _, t_key, noise_key, drop_key = jax.random.split(jstate.rng, 4)
    t = np.asarray(jax.random.randint(t_key, (BATCH,), 0, 1000))
    noise = np.asarray(jax.random.normal(noise_key, x0.shape))
    drawn: list = []
    with _recording_bernoulli(drawn):
        jmodel.apply({"params": jstate.params, "batch_stats": jstate.batch_stats}, x0, t, y,
                     train=True, rngs={"dropout": drop_key}, mutable=["batch_stats"])
    return {"t": t.astype(np.int64), "noise": noise,
            "masks": [tuple(drawn[i:i + 3]) for i in range(0, len(drawn), 3)]}


def _jax_init(name: str, dtype, x0: np.ndarray, y: np.ndarray) -> dict:
    """JAX's init of ``name`` in ``dtype`` (as the port's state dict) and, in
    float32, its step's draws (they depend on the state's key alone, which
    both dtypes share)."""
    jmodel, _, jstate = _jax_state(name, dtype)
    out = {"state_dict": state_dict_by_name(_flat(jstate.params, jstate.batch_stats))}
    if dtype == jnp.float32:
        out.update(_jax_draws(jmodel, jstate, x0, y))
    return out


def _jax_tp_step(name: str, dtype, x0: np.ndarray, y: np.ndarray) -> dict:
    """JAX's ``make_train_step`` with ``state_sharding=infer_state_sharding``
    on a (1, 2) mesh of the CPU's devices, from ``_jax_init``'s state: the
    loss, the gathered weights after and each leaf's dtype."""
    jmodel, tx, jstate = _jax_state(name, dtype)
    jmesh = jax_make_mesh(("data", "model"), shape=(1, 2), devices=jax.devices()[:2])
    shardings = jax_infer_state_sharding(jstate, jmesh, "model")
    step = jax_make_train_step(jmodel, tx, JaxSchedule.linear(1000), conditional=True,
                               mesh=jmesh, state_sharding=shardings)
    new, loss = step(jax.device_put(jstate, shardings), jnp.asarray(x0), jnp.asarray(y))
    return {"loss": float(loss), "weights": _flat(new.params, new.batch_stats),
            "dtypes": {k: jnp.asarray(v).dtype for k, v in _flat_items(
                {"params": new.params, "batch_stats": new.batch_stats})[0].items()}}


def _jax_bf16_eager_steps(name: str, x0: np.ndarray, y: np.ndarray) -> dict:
    """JAX's bfloat16 step of ``_jax_tp_step`` on one device, run eagerly:
    ``{"eager": (loss, weights)}``."""
    jmodel, tx, jstate = _jax_state(name, jnp.bfloat16)
    raw = _raw_step_fn(jmodel, tx, JaxSchedule.linear(1000), conditional=True)
    new, loss = raw(jstate, jnp.asarray(x0), jnp.asarray(y))
    return {"eager": (float(loss), _flat(new.params, new.batch_stats))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, JAX's sharded steps, the one-process steps and every
    rank's results, computed once for the module. The ranks need only JAX's
    inits and draws: they run while JAX compiles and takes its steps."""
    tmp = tmp_path_factory.mktemp("tp_latent")
    rng = np.random.default_rng(23)
    x0 = rng.standard_normal((BATCH, LATENT)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    keys = {**{name: (name, jnp.float32) for name in worker.LATENT_MODELS},
            **{f"{name}_bf16": (name, jnp.bfloat16) for name in BF16_MODELS}}
    jax_runs = {key: _jax_init(*spec, x0, y) for key, spec in keys.items()}
    inputs = {"latent_x0": x0, "latent_y": y,
              "latent_rows": rng.integers(0, 256, (4 * BATCH, LATENT)).astype(np.uint8),
              "latent_row_labels": rng.integers(0, 10, 4 * BATCH)}
    for key, run in jax_runs.items():
        torch.save(run["state_dict"], tmp / f"{key}.pt")
        inputs[f"{key}_weights"] = str(tmp / f"{key}.pt")
    for name in worker.LATENT_MODELS:
        run = jax_runs[name]
        inputs.update({f"{name}_t": run["t"], f"{name}_noise": run["noise"]})
        for b, block in enumerate(run["masks"]):
            inputs.update({f"{name}_mask{b}_{i}": m for i, m in enumerate(block)})
    assert jax_runs["mlp"]["masks"] == [] and len(jax_runs["dit"]["masks"]) == 2
    schedule = _same_tables(JaxSchedule.linear(1000))
    inputs.update({f"schedule_{k}": getattr(schedule, k).numpy()
                   for k in ("betas", "alphas", "alphas_cumprod")})
    np.savez(tmp / "inputs.npz", **inputs)
    context = mp.start_processes(worker.run_latent_rank,
                                 args=(str(tmp), str(tmp / "inputs.npz"), str(tmp)), nprocs=4,
                                 join=False, start_method="spawn")
    try:
        for key, spec in keys.items():
            jax_runs[key].update(_jax_tp_step(*spec, x0, y))
        for name in BF16_MODELS:
            jax_runs[f"{name}_bf16"].update(_jax_bf16_eager_steps(name, x0, y))
        one = {case: worker.latent_step(inputs, case) for case in worker.LATENT_CASES}
        for name in ("mlp", "dit"):
            one[f"resident_{name}"] = worker.latent_resident_steps(inputs, name)
            one[f"eager_{name}"] = worker.latent_eager_steps(inputs, name)
    finally:
        while not context.join():
            pass
    ranks = [dict(np.load(tmp / f"latent_rank{r}.npz")) for r in range(4)]
    return {"ranks": ranks, "one": one, "jax": jax_runs, "dir": tmp}


def _case(rank: dict, prefix: str) -> dict:
    prefix += "/"
    return {k[len(prefix):]: v for k, v in rank.items() if k.startswith(prefix)}


def _weights(result: dict) -> dict:
    return {k: v for k, v in result.items() if k.startswith(("params/", "batch_stats/"))}


def _ranks_of(runs, tag: str) -> list[dict]:
    return [r for r in runs["ranks"] if f"{tag}/place" in r]


def _assert_same_step(got: dict, want_loss: float, want: dict, stats_rtol: float = 0.0,
                      stats_atol: float = 0.0, stats_scale: float = 0.0,
                      param_atol: float = PARAM_ATOL) -> None:
    """The loss, the params and the BatchNorm statistics, each statistic
    within ``stats_rtol`` of itself plus ``stats_atol`` plus ``stats_scale``
    of its tensor's largest value."""
    np.testing.assert_allclose(np.asarray(got["loss"]), np.asarray(want_loss), rtol=LOSS_RTOL)
    got = _weights(got)
    assert set(got) == set(want) and want
    for key in sorted(want):
        if key.startswith("batch_stats/"):
            atol = stats_atol + stats_scale * float(np.abs(want[key]).max())
            np.testing.assert_allclose(got[key], want[key], rtol=stats_rtol, atol=atol,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=param_atol, err_msg=key)


# --- the DiT through make_train_step, on one process --------------------------------


def _dit_make_train_step_runs():
    """JAX's ``make_train_step`` (one device, jitted) and the port's, the
    committed DiT at its default dropout 0.05, float32, one SGD step on JAX's
    draws; and the port's step on its own draws."""
    jmodel = JaxDiT(time_dim=256, num_classes=10, latent_dim=20)
    assert jmodel.dropout == 0.05
    variables = _jax_variables("dit", jmodel)
    tx = optax.sgd(worker.LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats={}, opt_state=tx.init(variables["params"]),
                           rng=jax.random.PRNGKey(21))
    rng = np.random.default_rng(24)
    x0 = rng.standard_normal((BATCH, LATENT)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    draws = _jax_draws(jmodel, jstate, x0, y)
    jschedule = JaxSchedule.linear(1000)
    new, loss = jax_make_train_step(jmodel, tx, jschedule, conditional=True)(
        jstate, jnp.asarray(x0), jnp.asarray(y))
    model = _port_model("dit")
    state = trainer.create_train_state(model, torch.optim.SGD(model.parameters(), lr=worker.LR),
                                       0)
    step = trainer.make_train_step(_same_tables(jschedule), conditional=True)
    masks = [tuple(torch.from_numpy(m) for m in block) for block in draws["masks"]]
    got = step(state, torch.from_numpy(x0), torch.from_numpy(y).long(),
               t=torch.from_numpy(draws["t"]), noise=torch.from_numpy(draws["noise"]),
               masks=masks)
    return {"jax": (float(loss), _flat(new.params, {})), "draws": draws,
            "port": (got.item(), {k: v for k, v in state.jax_weights().items() if k != "step"})}


def test_dit_through_make_train_step_equals_jax():
    """The committed DiT with dropout 0.05 through the port's
    ``make_train_step`` (it raised before: the step handed the train-mode DiT
    no masks) on JAX's t, noise and dropout masks: JAX's loss and params."""
    runs = _dit_make_train_step_runs()
    assert len(runs["draws"]["masks"]) == 4
    dropped = [not m.all() for block in runs["draws"]["masks"] for m in block[1:]]
    assert any(dropped)
    (loss, weights), (want_loss, want) = runs["port"], runs["jax"]
    np.testing.assert_allclose(loss, want_loss, rtol=DIT_LOSS_RTOL)
    assert set(weights) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(weights[key], want[key], rtol=0, atol=DIT_PARAM_ATOL,
                                   err_msg=key)


def test_dit_step_draws_its_masks_after_t_and_the_seed():
    """The port's own draws, in JAX's split order (t, the q_sample seed, the
    dropout masks), all from the state's generator: a step with no seams is
    the step with those draws replayed."""
    schedule = _same_tables(JaxSchedule.linear(1000))
    x0 = torch.from_numpy(np.random.default_rng(25).standard_normal((BATCH, LATENT))
                          .astype(np.float32))
    y = torch.arange(BATCH) % 10
    losses = []
    for replay in (False, True):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(3)
            model = DiT(**worker.LATENT_MODELS["dit4"][1])
        state = trainer.create_train_state(model, torch.optim.SGD(model.parameters(), lr=0.1), 8)
        seams = {}
        if replay:
            gen = torch.Generator().manual_seed(8)
            t = torch.randint(0, 1000, (BATCH,), generator=gen)
            seed = torch.randint(0, 2**31 - 1, (), generator=gen)
            seams = {"t": t, "noise": q_sample_fused_reference(schedule, x0, t, seed)[1],
                     "masks": model.draw_dropout_masks(BATCH, gen)}
        losses.append(trainer.make_train_step(schedule, conditional=True)(
            state, x0, y, **seams).item())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


# --- the sharding rule --------------------------------------------------------------


def _assert_rule_is_jax(name: str, m: int) -> None:
    """JAX's spec of each leaf on an (8 / m, m) mesh against the port's split
    on every model rank: the same leaves split, each rank's shard (read
    through ``jax_variables``) JAX's slice of the leaf's last dimension."""
    _, _, jstate = _jax_state(name)
    jmesh = jax_make_mesh(("data", "model"), shape=(8 // m, m), devices=jax.devices()[:8])
    specs = jax_infer_state_sharding(jstate, jmesh, "model")
    leaves = _flat(jstate.params, jstate.batch_stats)
    spec_leaves, _ = _flat_items({"params": specs.params, "batch_stats": specs.batch_stats})
    whole = state_dict_by_name(leaves)
    for r in range(m):
        model = worker.latent_model(name)
        shardings = mesh_lib.infer_state_sharding(model, m)
        mesh = mesh_lib.Mesh((8 // m, m), mesh_lib.DataParallel(0, 8 // m),
                             mesh_lib.ModelParallel(r, m))
        mesh_lib.apply_sharding(model, shardings, mesh, state_dict=whole)
        local = jax_variables(model)
        assert set(local) == set(leaves)
        for key, leaf in leaves.items():
            spec = spec_leaves[key].spec
            sharded = spec == PartitionSpec(*([None] * (leaf.ndim - 1)), "model")
            assert sharded or spec == PartitionSpec(), key
            part = leaf.shape[-1] // m
            want = leaf[..., r * part:(r + 1) * part] if sharded else leaf
            np.testing.assert_array_equal(local[key], want, err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", sorted(worker.LATENT_MODELS))
def test_sharding_rule_is_jax_leaf_by_leaf(name, m):
    """Every leaf of the MLP UNet and of the DiT (one token and four) is split
    as JAX splits it, shard contents included; the DiT's query, key and value
    kernels (D, heads, head_dim) on head_dim, ``pos_encoding`` (1, S, D) on
    D, and ``final_proj`` where m divides latent_dim / num_tokens."""
    _assert_rule_is_jax(name, m)
    model = worker.latent_model(name)
    shardings = mesh_lib.infer_state_sharding(model, m)
    if name.startswith("dit"):
        assert shardings["block0.attention.query.weight"] == mesh_lib.HeadSplit(0, 4)
        assert shardings["block0.attention.value.bias"] == mesh_lib.HeadSplit(0, 4)
        assert shardings["block0.attention.out.weight"] == 0
        assert shardings["pos_encoding"] == 2 and shardings["class_embedding.weight"] == 1
        assert (shardings["final_proj.weight"] is None) == (name == "dit4")
    else:
        assert shardings["final_fc.weight"] == 0
    assert all(v is None for v in mesh_lib.infer_state_sharding(model, 1).values())


def test_a_head_split_cut_by_heads_would_fail(monkeypatch):
    """The rule with q, k and v cut contiguously, whole heads to a rank
    (where JAX gives each rank head_dim / m of every head): the rule's test
    fails on the shard contents."""
    monkeypatch.setattr(mesh_lib, "_heads", worker._contiguous_heads)
    with pytest.raises(AssertionError, match="attention/(query|key|value)"):
        _assert_rule_is_jax("dit", 2)


def test_shards_round_trip_through_gather():
    """``shard_of`` and ``join_shards`` invert each other for a contiguous
    and a head split, and a head split's rank slice is the strided one."""
    w = torch.arange(8 * 3).reshape(8, 3)
    for spec in (0, mesh_lib.HeadSplit(0, 2)):
        parts = [mesh_lib.shard_of(w, spec, r, 2) for r in range(2)]
        assert torch.equal(mesh_lib.join_shards(parts, spec), w)
    assert torch.equal(mesh_lib.shard_of(w, mesh_lib.HeadSplit(0, 2), 1, 2), w[[2, 3, 6, 7]])


# --- the steps ----------------------------------------------------------------------


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(worker.LATENT_MODELS))
def test_tp_step_equals_the_one_process_step(runs, tag, name):
    """Each rank, its own draws, float32: the loss, the params and the
    BatchNorm statistics of one process's step on the whole batch, once
    gathered back."""
    ranks = _ranks_of(runs, tag)
    assert len(ranks) == np.prod(MESHES[tag])
    one = runs["one"][name]
    for rank in ranks:
        _assert_same_step(_case(rank, f"{tag}/{name}"), float(one["loss"]), _weights(one),
                          stats_scale=STATS_SCALE)


@pytest.mark.parametrize("name", sorted(worker.LATENT_MODELS))
def test_tp_step_equals_jax_sharded_step(runs, name):
    """JAX's draws (t, noise, flax's dropout masks) through the seams, float32:
    every (1, 2) rank, and one process, end where JAX's ``make_train_step``
    with ``state_sharding`` ends on its (1, 2) mesh."""
    want = runs["jax"][name]
    for got in [_case(r, f"m12/{name}_jax") for r in _ranks_of(runs, "m12")] + [
            runs["one"][f"{name}_jax"]]:
        _assert_same_step(got, want["loss"], want["weights"], JAX_STATS_RTOL, JAX_STATS_ATOL)


def _bf16_rounded(got: dict, dtypes: dict) -> dict:
    """The port's weights rounded to the dtype JAX keeps each in (flax's
    bf16 DiT has a bf16 ``pos_encoding`` parameter)."""
    return {k: (torch.from_numpy(v).to(torch.bfloat16).float().numpy()
                if dtypes.get(k) == jnp.bfloat16 else v) for k, v in got.items()}


@pytest.mark.parametrize("name", sorted(BF16_MODELS))
def test_bf16_tp_step_equals_jax_bf16_sharded_step(runs, name):
    """The bfloat16 step on JAX's draws, every (1, 2) rank and one process,
    against JAX's eager bf16 step and its jitted bf16 step on its (1, 2)
    mesh (``make_train_step`` with ``state_sharding``), as
    ``check_bf16_step`` holds the bf16 steps (the bounds' comment): the
    params within the eager bound of JAX's eager step and within JAX's own
    eager-to-(1, 2) gap plus it of JAX's (1, 2) step; the loss within that
    gap of the eager step and twice it of the (1, 2) step."""
    want = runs["jax"][f"{name}_bf16"]
    eager, tp = want["eager"], (want["loss"], want["weights"])
    eager_bound = PARAM_BOUNDS[BF16_MODELS[name]][0]
    eager_to_tp = gaps(eager, tp)
    for label, got in [(f"(1, 2) rank {i}", _case(r, f"m12/{name}_bf16_jax"))
                       for i, r in enumerate(_ranks_of(runs, "m12"))] + [
            ("one process", runs["one"][f"{name}_bf16_jax"])]:
        port = (float(got["loss"]), _bf16_rounded(_weights(got), want["dtypes"]))
        to_eager, to_tp = gaps(port, eager), gaps(port, tp)
        print(f"{name} bf16 {label}: port vs JAX eager {to_eager}; port vs JAX (1, 2) {to_tp}; "
              f"JAX eager vs JAX (1, 2) {eager_to_tp}")
        assert to_eager["params"] <= eager_bound, (label, to_eager)
        assert to_tp["params"] <= eager_to_tp["params"] + eager_bound, (label, to_tp)
        assert to_eager["loss_rel"] <= eager_to_tp["loss_rel"] + LOSS_FLOOR, (label, to_eager)
        assert to_tp["loss_rel"] <= JIT_RATIO * eager_to_tp["loss_rel"] + LOSS_FLOOR, label


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("name", ["mlp", "dit"])
def test_resident_tp_steps_equal_the_one_process_steps(runs, tag, name):
    """``make_resident_multi_step`` on (B, 20) rows with the mesh: three steps
    end where one process's three resident steps end, and those are its
    eager ``make_train_step`` steps on the same batches, bit for bit."""
    one, eager = runs["one"][f"resident_{name}"], runs["one"][f"eager_{name}"]
    np.testing.assert_array_equal(one["loss"], eager["loss"])
    assert set(one) == set(eager)
    for key in _weights(one):
        np.testing.assert_array_equal(one[key], eager[key], err_msg=key)
    for rank in _ranks_of(runs, tag):
        got = _case(rank, f"{tag}/resident_{name}")
        _assert_same_step(dict(got, loss=got["loss"]), one["loss"], _weights(one),
                          stats_scale=RESIDENT_STATS_SCALE, param_atol=RESIDENT_ATOL)
        assert int(got["model_axis_checks"]) == 1


def test_gathered_checkpoint_is_jax_gathered_state(runs):
    """The DiT's (1, 2) step on JAX's draws, gathered and written by rank 0
    (``io.checkpoint.save_weights``) and read back: JAX's gathered state after
    its sharded step, leaf for leaf in flax's layout."""
    got = load_weights_arrays(str(runs["dir"] / "m12_dit"))
    want = runs["jax"]["dit"]["weights"]
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=2.0**-7, atol=PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_ranks_hold_1_over_m_and_replicated_tensors_agree(runs, tag):
    """Each rank's shards are 1/m of the whole tensors; what the axis leaves
    whole (the four-token DiT's head, 5 outputs) is bit-equal on the model
    ranks of a data row after the step."""
    d, m = MESHES[tag]
    rows: dict = {}
    for r, rank in enumerate(_ranks_of(runs, tag)):
        assert list(rank[f"{tag}/place"]) == [r // m, d, r % m, m]
        for name in worker.LATENT_MODELS:
            shapes = _case(rank, f"{tag}/{name}/shape")
            whole = _case(runs["one"][name], "shape")
            assert set(shapes) == set(whole)
            assert sum(int(np.prod(s)) for s in shapes.values()) < sum(
                int(np.prod(s)) for s in whole.values())
        rows.setdefault(r // m, []).append(_case(rank, f"{tag}/dit4/replicated"))
    for copies in rows.values():
        assert {"final_proj.weight", "final_proj.bias"} <= set(copies[0])
        for other in copies[1:]:
            for key, want in copies[0].items():
                np.testing.assert_array_equal(other[key], want, err_msg=key)


@pytest.mark.parametrize("name", ["dit", "dit4"])
def test_a_head_split_cut_by_heads_fails_against_jax(runs, name):
    """With q, k and v cut contiguously by head, the (1, 2) step on JAX's
    draws leaves JAX's sharded step by far more than the bound: the gather
    that undoes the head interleave then puts another head's features in
    each head."""
    want = runs["jax"][name]
    for rank in _ranks_of(runs, "m12"):
        got = _case(rank, f"m12/heads_{name}_jax")
        assert abs(float(got["loss"]) - want["loss"]) > 100 * LOSS_RTOL * want["loss"]
        with pytest.raises(AssertionError):
            _assert_same_step(got, want["loss"], want["weights"], JAX_STATS_RTOL, JAX_STATS_ATOL)


def test_an_unsharded_model_on_a_model_axis_raises():
    """The axis is checked once a model (not at each step), and a model not
    sharded on the step's mesh still raises."""
    mesh = mesh_lib.Mesh((1, 2), mesh_lib.DataParallel(0, 1), mesh_lib.ModelParallel(0, 2))
    model = worker.latent_model("mlp")
    state = trainer.create_train_state(model, torch.optim.SGD(model.parameters(), lr=0.1), 0)
    step = trainer.make_train_step(_same_tables(JaxSchedule.linear(1000)), conditional=True,
                                   mesh=mesh)
    for _ in range(2):
        with pytest.raises(ValueError, match="not sharded on this mesh"):
            step(state, torch.zeros(BATCH, LATENT), torch.zeros(BATCH, dtype=torch.long))
