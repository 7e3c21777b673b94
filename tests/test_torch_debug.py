"""The port's numerical-safety helpers (``tinydiffusion_torch/obs/debug.py``)
and ``LossAccumulator`` against the JAX package, on the CPU.

``checked`` against JAX's ``checkify``-based ``checked`` on a table of
functions (each written once in torch and once in jax.numpy, on the same
input): both raise, or neither does, including a NaN made and then discarded
by a ``where``, a NaN input passed through ``add`` (an error in JAX) or
through a reshape, select, max or cast (none), and divisions by zero of
floats and ints. ``scrub_nonfinite`` and ``assert_all_finite`` against
JAX's; the four ``LossAccumulator`` methods to JAX's contract
(``tests/test_obs.py``).
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.checkify import JaxRuntimeError

from tinydiffusion_tpu.obs import debug as jax_debug
from tinydiffusion_tpu.obs.metrics import LossAccumulator as JaxLossAccumulator
from tinydiffusion_torch.obs import debug
from tinydiffusion_torch.obs.metrics import LossAccumulator

NAN, INF = math.nan, math.inf

# name: (torch fn, jax fn, input). Integer remainder by zero is left out:
# torch refuses to compute it at all, checked or not.
CASES = {
    "add": (lambda x: x + 1, lambda x: x + 1, [1.0, 2.0]),
    "log_of_negative": (torch.log, jnp.log, [-1.0, 2.0]),
    "log_of_zero_is_inf": (torch.log, jnp.log, [0.0, 1.0]),
    "discarded_nan": (lambda x: torch.where(x > 0, torch.log(x), 0.0),
                      lambda x: jnp.where(x > 0, jnp.log(x), 0.0), [-1.0, 2.0]),
    "nan_input_through_add": (lambda x: x + 1, lambda x: x + 1, [NAN, 2.0]),
    "nan_input_reshaped": (lambda x: x.reshape(2, 1), lambda x: x.reshape(2, 1), [NAN, 2.0]),
    "nan_input_scrubbed": (lambda x: torch.where(torch.isfinite(x), x, 0.0),
                           lambda x: jnp.where(jnp.isfinite(x), x, 0.0), [NAN, 2.0]),
    "nan_input_max": (lambda x: torch.clamp(x, min=0.0), lambda x: jnp.maximum(x, 0.0),
                      [NAN, 2.0]),
    "nan_input_neg": (lambda x: -x, lambda x: -x, [NAN, 2.0]),
    "nan_input_cast": (lambda x: x.half(), lambda x: x.astype(jnp.float16), [NAN, 2.0]),
    "nan_input_sum": (lambda x: x.sum(), lambda x: x.sum(), [NAN, 2.0]),
    "float_division_by_zero": (lambda x: x / 0.0, lambda x: x / 0.0, [1.0, 2.0]),
    "zero_over_zero_discarded": (lambda x: torch.where(x != 0, x / x, 1.0),
                                 lambda x: jnp.where(x != 0, x / x, 1.0), [0.0, 1.0]),
    "reciprocal_of_zero": (lambda x: 1.0 / x, lambda x: 1.0 / x, [0.0, 1.0]),
    "int_floor_division_by_zero": (lambda x: x // torch.tensor([0, 1]),
                                   lambda x: x // jnp.array([0, 1]), [1, 2]),
    "int_floor_division": (lambda x: x // torch.tensor([2, 1]),
                           lambda x: x // jnp.array([2, 1]), [1, 2]),
    "inf_input_scaled": (lambda x: x * 2, lambda x: x * 2, [INF, 2.0]),
    "inf_minus_inf": (lambda x: x - x, lambda x: x - x, [INF, 2.0]),
    "inf_times_zero": (lambda x: x * 0, lambda x: x * 0, [INF, 2.0]),
    "exp_overflow": (torch.exp, jnp.exp, [1000.0, 2.0]),
    "sqrt_of_negative": (torch.sqrt, jnp.sqrt, [-1.0, 2.0]),
    "matmul_and_mean": (lambda x: (x[:, None] @ x[None, :]).mean(),
                        lambda x: (x[:, None] @ x[None, :]).mean(), [1.0, 2.0]),
    "softmax_of_large": (lambda x: torch.softmax(x, 0), lambda x: jax.nn.softmax(x),
                         [1000.0, 1.0]),
    "logsumexp_of_large": (lambda x: torch.logsumexp(x, 0), jax.nn.logsumexp, [1000.0, 1.0]),
}


def _raises(fn, x) -> bool:
    try:
        fn(x)
    except (FloatingPointError, ZeroDivisionError, JaxRuntimeError):
        return True
    return False


@pytest.mark.parametrize("name", sorted(CASES))
def test_checked_raises_where_jax_checkify_does(name):
    torch_fn, jax_fn, value = CASES[name]
    want = _raises(jax_debug.checked(jax_fn), jnp.asarray(value))
    assert _raises(debug.checked(torch_fn), torch.tensor(value)) == want
    # Not strict: the error comes back beside the output, the same verdict.
    if name != "int_floor_division_by_zero":  # torch cannot compute it
        err, out = debug.checked(torch_fn, strict=False)(torch.tensor(value))
        assert (err is not None) == want
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(jax_fn(jnp.asarray(value)), np.float32))


def test_checked_names_the_op_and_passes_a_clean_model_through():
    with pytest.raises(FloatingPointError, match="aten.log"):
        debug.checked(torch.log)(torch.tensor([-1.0]))
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))
    x = torch.randn(3, 4)
    torch.testing.assert_close(debug.checked(model)(x), model(x))


def test_scrub_and_assert_finite_match_jax():
    x = [1.0, NAN, INF, -INF]
    np.testing.assert_array_equal(debug.scrub_nonfinite(torch.tensor(x)).numpy(),
                                  np.asarray(jax_debug.scrub_nonfinite(jnp.asarray(x))))
    for tree in ({"a": np.ones(3)}, {"a": {"b": [np.ones(2), 3]}}):
        debug.assert_all_finite(tree)
        jax_debug.assert_all_finite(tree)
    for tree, path in (({"a": np.array([1.0, NAN])}, "['a']"),
                       ({"a": {"b": [np.ones(2), np.array([INF])]}}, "['a']['b'][1]")):
        for fn in (debug.assert_all_finite, jax_debug.assert_all_finite):
            with pytest.raises(FloatingPointError, match=re.escape(f"state{path}")):
                fn(tree, "state")
    model = torch.nn.Linear(2, 2)
    with torch.no_grad():
        model.bias[1] = NAN
    with pytest.raises(FloatingPointError, match=re.escape("model['bias']")):
        debug.assert_all_finite(model, "model")
    debug.assert_all_finite({"step": torch.tensor(3), "w": torch.ones(2, dtype=torch.bfloat16)})


def test_loss_accumulator_scalar_and_vector_mix():
    for acc, as_array in ((LossAccumulator(), torch.tensor),
                          (JaxLossAccumulator(), jnp.asarray)):
        acc.add(as_array(1.0))
        acc.add_many(as_array([2.0, 3.0, 4.0]))
        acc.add(as_array(5.0))
        acc.add_many(as_array([6.0]))  # a ragged tail chunk
        assert acc.count == 6
        assert acc.sum() == 21.0
        assert acc.mean() == 3.5
        assert acc.last() == 6.0
        np.testing.assert_allclose(acc.values(), [1, 2, 3, 4, 5, 6])
        acc.reset()
        assert acc.count == 0 and acc.sum() == 0.0 and acc.mean() == 0.0


def test_loss_accumulator_finite_mean_and_bad_count():
    for acc, as_array in ((LossAccumulator(), torch.tensor),
                          (JaxLossAccumulator(), jnp.asarray)):
        acc.add_many(as_array([1.0, INF, 3.0]))
        acc.add(as_array(NAN))
        assert acc.finite_mean_and_bad_count() == (2.0, 2)
        acc.reset()
        acc.add(as_array(INF))
        assert acc.finite_mean_and_bad_count() == (INF, 1)
