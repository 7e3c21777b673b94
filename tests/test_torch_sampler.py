"""The port's DDIM, DPM-Solver++ and inpainting samplers against the JAX
package, on the CPU.

Each chain gets the same start and the same per-step noise in both packages:
JAX draws them from its key (``init_key``, then per step ``step_key`` and
``known_key``), and the test rebuilds them from the same splits and hands
them to the port's ``x_init``/``noise_stream``/``known_stream`` seams. Two
denoisers: a closed form (``eps = x (0.3 + 0.6 t / T) + 0.05``), which
holds the chain arithmetic alone, and a UNet28 at base width 8 (time dim 32)
carried across from a JAX init. Both schedules hold JAX's own tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_diffusion import _same_tables, _small_pair, nchw, nhwc
from tinydiffusion_tpu.core import sampler as jax_sampler
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_torch.core import sampler
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.experiments.common import make_sampler

T = 1000
CLOSED_SHAPE = (3, 6, 6, 1)  # NHWC, as JAX samples
UNET_SHAPE = (2, 28, 28, 1)
# Closed-form chains, float32: the same operations in the same order; DDIM's
# x0_hat divides by sqrt(abar_t) (1/157 at t = 999), so one ulp of x there
# shows as ~1e-5 of x0_hat, which the next step scales back. The port's
# 1/sqrt against XLA's rsqrt, and its float32 tables against JAX's traced
# ones, differ in the last bit. DPM-Solver++ in one or two steps ends on
# (x - sigma_t eps) / alpha_t with alpha_t = 0.0064 at t = 999, which leaves
# outputs up to |x| ~ 16 that carry float32 rounding as 1.8e-6 relative.
CLOSED_ATOL, CLOSED_RTOL = 2e-5, 1e-5
# UNet28 chains, float32: the model's summation order (its own parity bound
# is 1e-4 relative, tests/test_torch_unet28.py) carried through the steps.
# The random init's raw-integer time embedding drives its eps into the tens,
# and the samples to |x| ~ 150, so the bound is relative to the largest
# |x|: 4.3e-6 of it seen (6.1e-4 at 141).
UNET_REL = 2e-5
# The grid lengths whose every point JAX's CPU program computes without
# fused multiply-adds (see core.sampler.ddim_timesteps).
PLAIN_GRID_STEPS = 352


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops; the suite runs several workers on a
    few cores, where torch's default of one thread a core oversubscribes
    them. One thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _closed_jax(x, t):
    return x * (0.3 + 0.6 * t.astype(jnp.float32) / T)[:, None, None, None] + 0.05


def _closed_port(x, t):
    return x * (0.3 + 0.6 * t.float() / T)[:, None, None, None] + 0.05


def _denoisers(kind: str):
    """(JAX apply_fn, port apply_fn, NHWC shape) for ``kind``."""
    if kind == "closed":
        return _closed_jax, _closed_port, CLOSED_SHAPE
    jmodel, variables, model = _small_pair(seed=11)
    model.eval()
    return (lambda x, t: jmodel.apply(variables, x, t, train=False),
            lambda x, t: model(x, t), UNET_SHAPE)


def _draws(key, shape, steps: int, step_noise: bool, known: bool):
    """JAX's own draws of a key-driven chain: x_init from ``init_key``, then
    per step the ``step_key`` normal (if drawn) and the ``known_key`` one."""
    key, init_key = jax.random.split(key)
    x_init = np.asarray(jax.random.normal(init_key, shape))
    zs, zks = [], []
    for _ in range(steps):
        if step_noise:
            key, step_key = jax.random.split(key)
            zs.append(np.asarray(jax.random.normal(step_key, shape)))
        if known:
            key, known_key = jax.random.split(key)
            zks.append(np.asarray(jax.random.normal(known_key, shape)))
    return x_init, zs, zks


def _assert_chain_close(kind: str, got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if kind == "closed":
        np.testing.assert_allclose(nhwc(got), want, atol=CLOSED_ATOL, rtol=CLOSED_RTOL)
    else:
        np.testing.assert_allclose(nhwc(got), want, atol=UNET_REL * np.abs(want).max(), rtol=0)


def _stream(zs):
    """(S, B, H, W, C) JAX draws -> (S, B, C, H, W) tensor, or None."""
    return torch.from_numpy(np.stack(zs).transpose(0, 1, 4, 2, 3).copy()) if zs else None


def _inpainting_inputs(shape):
    rng = np.random.default_rng(5)
    x_known = rng.uniform(-1, 1, (1,) + shape[1:]).astype(np.float32)
    mask = (rng.uniform(size=(1,) + shape[1:]) < 0.5).astype(np.float32)
    return x_known, mask


# --- the DDIM grid --------------------------------------------------------------


@pytest.mark.parametrize("num_timesteps, t_start", [(1000, None), (1000, 599), (1000, 500),
                                                    (1000, 123), (20, None), (20, 7)])
def test_ddim_timesteps_match_jax(num_timesteps, t_start):
    top = num_timesteps - 1 if t_start is None else t_start
    # Every length up to 100, then every 7th up to PLAIN_GRID_STEPS.
    for steps in [*range(1, 101), *range(101, PLAIN_GRID_STEPS + 1, 7)]:
        if steps > top + 1:
            break
        want = np.asarray(jax_sampler.ddim_timesteps(num_timesteps, steps, t_start))
        got = sampler.ddim_timesteps(num_timesteps, steps, t_start)
        np.testing.assert_array_equal(got, want, err_msg=f"{steps} steps")
    for steps in (0, 2000):  # clamped to [1, top + 1], as in JAX
        np.testing.assert_array_equal(sampler.ddim_timesteps(num_timesteps, steps, t_start),
                                      np.asarray(jax_sampler.ddim_timesteps(
                                          num_timesteps, steps, t_start)))
    with pytest.raises(ValueError, match="outside"):
        sampler.ddim_timesteps(num_timesteps, 10, num_timesteps)


def test_long_ddim_grids_differ_from_jax_only_at_ties():
    """Past 352 steps XLA's CPU loop fuses JAX's linspace into multiply-adds
    for the first 352 points, and a point on a tie k + 1/2 may round the
    other way: the grids then differ by one timestep there, and only there."""
    for steps in (353, 400, 600, 1000):
        want = np.asarray(jax_sampler.ddim_timesteps(T, steps))
        got = sampler.ddim_timesteps(T, steps)
        exact = (T - 1) * (1 - np.arange(steps) / (steps - 1))
        differ = got != want
        assert np.all(np.abs(got - want) <= 1)
        np.testing.assert_allclose(exact[differ] % 1.0, 0.5, atol=1e-3)


# --- DDIM, DPM-Solver++, img2img, inpainting -------------------------------------


@pytest.mark.parametrize("kind", ["closed", "unet"])
@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_matches_jax(kind, eta):
    jfn, pfn, shape = _denoisers(kind)
    steps, key = 10, jax.random.PRNGKey(3)
    want = jax.jit(lambda k: jax_sampler.ddim_sample(
        jfn, JaxSchedule.linear(T), shape, k, num_steps=steps, eta=eta))(key)
    x_init, zs, _ = _draws(key, shape, steps, eta > 0, False)
    got = sampler.ddim_sample(pfn, _same_tables(JaxSchedule.linear(T)), nchw(x_init).shape,
                              num_steps=steps, eta=eta, x_init=nchw(x_init),
                              noise_stream=_stream(zs))
    _assert_chain_close(kind, got, want)


@pytest.mark.parametrize("kind, steps", [("closed", 1), ("closed", 2), ("closed", 15),
                                         ("closed", 50), ("unet", 15)])
def test_dpmpp_matches_jax(kind, steps):
    jfn, pfn, shape = _denoisers(kind)
    key, jsched = jax.random.PRNGKey(4), JaxSchedule.linear(T)
    # The schedule is made outside the jit: JAX's DPM-Solver++ reads its
    # table on the host.
    want = jax.jit(lambda k: jax_sampler.dpmpp_sample(
        jfn, jsched, shape, k, num_steps=steps))(key)
    x_init, _, _ = _draws(key, shape, 0, False, False)
    got = sampler.dpmpp_sample(pfn, _same_tables(JaxSchedule.linear(T)), nchw(x_init).shape,
                               num_steps=steps, x_init=nchw(x_init))
    _assert_chain_close(kind, got, want)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("kind", ["closed", "unet"])
def test_ddim_img2img_matches_jax(kind):
    """The partial chain from t_start = 599 and an x_init noised to it."""
    jfn, pfn, shape = _denoisers(kind)
    rng = np.random.default_rng(6)
    x_init = rng.standard_normal(shape).astype(np.float32)
    want = jax.jit(lambda x: jax_sampler.ddim_sample(
        jfn, JaxSchedule.linear(T), shape, jax.random.PRNGKey(0), num_steps=20,
        x_init=x, t_start=599))(jnp.asarray(x_init))
    got = sampler.ddim_sample(pfn, _same_tables(JaxSchedule.linear(T)), nchw(x_init).shape,
                              num_steps=20, x_init=nchw(x_init), t_start=599)
    _assert_chain_close(kind, got, want)


@pytest.mark.parametrize("kind", ["closed", "unet"])
@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_inpainting_matches_jax_and_keeps_the_known_region(kind, method):
    jfn, pfn, shape = _denoisers(kind)
    x_known, mask = _inpainting_inputs(shape)
    key = jax.random.PRNGKey(7)
    if method == "ddpm":  # a T = 20 chain: every step at full width is slow
        jsched, steps, eta = JaxSchedule.linear(20), 20, 0.0
        want = jax.jit(lambda k: jax_sampler.ddpm_sample(
            jfn, jsched, shape, k, mask=mask, x_known=x_known))(key)
    else:
        jsched, steps, eta = JaxSchedule.linear(T), 10, 1.0
        want = jax.jit(lambda k: jax_sampler.ddim_sample(
            jfn, jsched, shape, k, num_steps=steps, eta=eta, mask=mask, x_known=x_known))(key)
    x_init, zs, zks = _draws(key, shape, steps, method == "ddpm" or eta > 0, True)
    kwargs = dict(x_init=nchw(x_init), noise_stream=_stream(zs), known_stream=_stream(zks),
                  mask=nchw(mask), x_known=nchw(x_known))
    if method == "ddpm":
        got = sampler.ddpm_sample(pfn, _same_tables(jsched), nchw(x_init).shape, **kwargs)
    else:
        got = sampler.ddim_sample(pfn, _same_tables(jsched), nchw(x_init).shape,
                                  num_steps=steps, eta=eta, **kwargs)
    _assert_chain_close(kind, got, want)
    known = np.broadcast_to(mask, shape) == 1
    assert known.any() and (~known).any()
    np.testing.assert_array_equal(nhwc(got)[known], np.broadcast_to(x_known, shape)[known])


def test_chains_draw_from_the_generator_in_order():
    """Without the seams each chain draws from its generator: two calls with
    the same seed agree, and DDIM at eta = 0 and DPM-Solver++ draw x_init only."""
    sched = DiffusionSchedule.linear(50)
    shape = (2, 1, 4, 4)
    for fn in (lambda g: sampler.ddpm_sample(_closed_port, sched, shape, g),
               lambda g: sampler.ddim_sample(_closed_port, sched, shape, g, num_steps=5, eta=1.0),
               lambda g: sampler.dpmpp_sample(_closed_port, sched, shape, g, num_steps=5)):
        a, b = fn(torch.Generator().manual_seed(0)), fn(torch.Generator().manual_seed(0))
        assert torch.equal(a, b) and torch.isfinite(a).all()
    g = torch.Generator().manual_seed(1)
    x_init = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    deterministic = sampler.ddim_sample(_closed_port, sched, shape, g, num_steps=5)
    assert torch.equal(deterministic, sampler.ddim_sample(_closed_port, sched, shape,
                                                          num_steps=5, x_init=x_init))
    with pytest.raises(ValueError, match="generator"):
        sampler.ddim_sample(_closed_port, sched, shape, num_steps=5, eta=1.0, x_init=x_init)
    with pytest.raises(ValueError, match="BOTH"):
        sampler.ddpm_sample(_closed_port, sched, shape, g, mask=torch.ones(shape))


def test_make_sampler_raises_jax_errors_on_the_host():
    from tinydiffusion_tpu.experiments.common import make_sampler as jax_make_sampler

    jmodel, _, model = _small_pair()
    cases = [
        (dict(method="plms"), "unknown sampler method"),
        (dict(prediction="x0"), "unknown prediction"),
        (dict(method="ddpm", t_start=10), "t_start"),
        (dict(method="dpmpp", mask=np.ones(1)), "inpainting"),
        (dict(conditional=True, guidance_scale=2.0), "null_label"),
    ]
    for kwargs, match in cases:
        with pytest.raises(ValueError, match=match):
            jax_make_sampler(jmodel, JaxSchedule.linear(10), (2, 28, 28, 1), **kwargs)
        if "mask" in kwargs:
            kwargs = dict(kwargs, mask=torch.ones(1))
        with pytest.raises(ValueError, match=match):
            make_sampler(model, DiffusionSchedule.linear(10), (2, 1, 28, 28), **kwargs)
