"""The port's fused q_sample against the JAX package, on the CPU.

The CUDA kernel (``tinydiffusion_torch/ops/csrc/qsample.cu``) runs only on a
card, where ``chip_smoke.py`` holds it value for value against the plain
version tested here, ``q_sample_fused_reference``: the same Philox4x32-10
stream in torch integer ops. JAX's ``q_sample_fused`` draws from the TPU's
hardware PRNG, and on the CPU from ``jax.random``, so no test can compare
the two streams' values. What is compared is the noising algebra (against
JAX ``q_sample_with_noise``) and the distribution (the checks of
``tests/test_qsample_fused.py``).
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinydiffusion_tpu.core.process import q_sample_with_noise as jax_q_sample_with_noise
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.ops import _build, qsample

# Random123's known-answer vectors for Philox4x32-10: (counter, key, output).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
# x_t from the plain version vs JAX's closed form on the same noise and the
# same schedule tables: both float32, the same two products and one sum.
ALGEBRA_ATOL = 1e-6


@pytest.fixture(scope="module")
def sched():
    return DiffusionSchedule.linear(1000)


@pytest.mark.parametrize("counter, key, want", PHILOX_KAT)
def test_philox_matches_the_random123_known_answers(counter, key, want):
    words = qsample.philox4x32_10(tuple(torch.tensor([c]) for c in counter), key)
    assert tuple(int(w) for w in words) == want


def test_mulhilo_is_the_exact_64_bit_product():
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.integers(0, 2**32, 4096), [0, 1, 2**32 - 1, 2**31, 0xFFFF0000]])
    for m in (0xD2511F53, 0xCD9E8D57):
        hi, lo = qsample._mulhilo(m, torch.from_numpy(xs.astype(np.int64)))
        for x, h, lo_ in zip(xs.tolist(), hi.tolist(), lo.tolist()):
            assert (h, lo_) == ((m * x) >> 32, (m * x) & 0xFFFFFFFF)


def test_uniforms_are_in_the_open_closed_unit_interval():
    bits = torch.tensor([0, 255, 256, 2**32 - 1], dtype=torch.int64)
    u = qsample._uniform_from_bits(bits)
    assert u.dtype == torch.float32
    assert u[0].item() == u[1].item() == 2.0**-25
    assert 0.0 < u.min().item() and u.max().item() <= 1.0


def test_noising_algebra_matches_jax_q_sample_with_noise(sched):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 1, 28, 28)).astype(np.float32)
    t = np.array([3, 123, 700, 999])
    jax_sched = JaxSchedule.linear(1000)
    same_tables = DiffusionSchedule(*(torch.from_numpy(np.array(getattr(jax_sched, name)))
                                      for name in ("betas", "alphas", "alphas_cumprod")))
    xt, noise = qsample.q_sample_fused_reference(same_tables, torch.from_numpy(x0),
                                                 torch.from_numpy(t), seed=1)
    to_nhwc = (0, 2, 3, 1)
    want = jax_q_sample_with_noise(
        jax_sched, jnp.asarray(x0.transpose(to_nhwc)), jnp.asarray(t),
        jnp.asarray(noise.numpy().transpose(to_nhwc)))
    np.testing.assert_allclose(xt.numpy().transpose(to_nhwc), np.asarray(want),
                               atol=ALGEBRA_ATOL, rtol=0)


def test_shapes_and_determinism(sched):
    x0 = torch.ones(4, 1, 28, 28)
    t = torch.tensor([0, 10, 500, 999])
    xt1, n1 = qsample.q_sample_fused(sched, x0, t, seed=7)
    xt2, n2 = qsample.q_sample_fused(sched, x0, t, seed=7)
    assert xt1.shape == n1.shape == x0.shape
    assert torch.equal(xt1, xt2) and torch.equal(n1, n2)
    xt3, _ = qsample.q_sample_fused(sched, x0, t, seed=8)
    assert not torch.allclose(xt1, xt3)


def test_noise_is_standard_gaussian(sched):
    x0 = torch.zeros(8, 32, 128, 1)  # 32k draws
    _, noise = qsample.q_sample_fused(sched, x0, torch.zeros(8, dtype=torch.int64), seed=3)
    z = noise.double().flatten()
    assert abs(z.mean().item()) < 0.02
    assert abs(z.std().item() - 1.0) < 0.02
    assert abs((z < 0).double().mean().item() - 0.5) < 0.02
    assert 3.5 < z.abs().max().item() < 7.0


def test_rows_independent(sched):
    """Each row has its own Philox counter, hence its own stream."""
    _, noise = qsample.q_sample_fused(sched, torch.zeros(4, 28, 28, 1),
                                      torch.zeros(4, dtype=torch.int64), seed=5)
    n = noise.reshape(4, -1).numpy()
    assert not np.allclose(n[0], n[1])
    assert abs(np.corrcoef(n[0], n[1])[0, 1]) < 0.05


def test_a_row_of_any_length_reads_the_same_stream(sched):
    """feat = 21 is not a multiple of 4 (the kernel's scalar path): its rows
    are the first 21 draws of the rows of feat = 24."""
    t = torch.zeros(3, dtype=torch.int64)
    _, z21 = qsample.q_sample_fused(sched, torch.zeros(3, 3, 7), t, seed=11)
    _, z24 = qsample.q_sample_fused(sched, torch.zeros(3, 4, 6), t, seed=11)
    assert torch.equal(z21.reshape(3, 21), z24.reshape(3, 24)[:, :21])


def test_the_64_bit_seed_keys_both_words(sched):
    x0, t = torch.zeros(2, 8), torch.zeros(2, dtype=torch.int64)
    _, lo = qsample.q_sample_fused(sched, x0, t, seed=5)
    _, hi = qsample.q_sample_fused(sched, x0, t, seed=5 + 2**32)
    assert not torch.allclose(lo, hi)
    for bad in (-1, 2**64):
        with pytest.raises(ValueError, match="seed"):
            qsample.q_sample_fused(sched, x0, t, seed=bad)


def test_a_tensor_seed_gives_the_values_of_the_same_int(sched):
    """A 0-d int64 seed, as a step draws it on the device, keys the stream as
    the same Python int does; its int64 bits are the key, so -1 is 2^64 - 1,
    as the kernel reads them."""
    x0 = torch.randn(3, 1, 28, 28, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([1, 400, 999])
    for seed, same in ((0, 0), (12345, 12345), (2**31 - 2, 2**31 - 2), (-1, 2**64 - 1)):
        a = qsample.q_sample_fused(sched, x0, t, torch.tensor(seed))
        b = qsample.q_sample_fused(sched, x0, t, same)
        assert all(torch.equal(u, v) for u, v in zip(a, b)), seed
    for bad in (torch.tensor([1]), torch.tensor(1, dtype=torch.int32), torch.tensor(1.0)):
        with pytest.raises(ValueError, match="0-d int64"):
            qsample.q_sample_fused(sched, x0, t, bad)


def test_graph_replays_add_their_captured_launches():
    before = qsample.qsample_launches
    qsample.count_replays(1, 5)
    qsample.count_replays(0, 3)
    assert qsample.qsample_launches == before + 5


def test_cpu_tensors_run_the_plain_version_and_count_no_launch(sched):
    before = qsample.qsample_launches
    x0 = torch.randn(2, 1, 28, 28, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([5, 900])
    got = qsample.q_sample_fused(sched, x0, t, seed=9)
    want = qsample.q_sample_fused_reference(sched, x0, t, seed=9)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert qsample.qsample_launches == before


def test_other_devices_are_refused(sched):
    with pytest.raises(ValueError, match="cuda or cpu"):
        qsample.q_sample_fused(sched, torch.zeros(2, 4, device="meta"),
                               torch.zeros(2, dtype=torch.int64, device="meta"), seed=0)


def test_every_kernel_launcher_has_a_ctypes_signature():
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer, so every ``extern "C"`` launcher in csrc/ needs its argtypes in
    ``_build.SIGNATURES``, with one entry per parameter."""
    found = {}
    for src in Path(_build._CSRC).glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len(params.split(","))
    assert found and found.keys() == _build.SIGNATURES.keys()
    for name, n in found.items():
        assert len(_build.SIGNATURES[name]) == n, name
