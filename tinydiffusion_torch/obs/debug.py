"""Numerical-safety helpers: counterpart of ``tinydiffusion_tpu/obs/debug.py``.

- ``checked(fn, strict=True)``: JAX's is ``checkify`` with ``float_checks``;
  this one runs ``fn`` under a ``TorchDispatchMode`` that applies the same
  two checks to every ATen op inside it, so a NaN made and then discarded
  (``where(x > 0, log(x), 0)``) is caught as in JAX:
  - a division (``div``, ``floor_divide``, ``reciprocal``) whose divisor
    holds a zero, of any dtype (checkify's ``div`` check);
  - a floating output holding a NaN, from any op but those that only move,
    select, compare or convert values (checkify lists the primitives that
    can make a NaN; ``reshape``, ``select``, ``max``, ``neg`` and
    ``convert_element_type`` are not among them, so a NaN input passed
    through them is no error, while ``add`` on one is).
  The first fault raises ``ZeroDivisionError`` or ``FloatingPointError``
  naming the op. Each check reads the tensor back, a sync per op on a card:
  a debugging tool, not for a hot loop.
- ``scrub_nonfinite(x)``: NaN and Inf to zeros (the reference's sampler
  scrub, conditional_diffusion_laion.py:591-598).
- ``assert_all_finite(tree, name)``: a host-side check of a nested mapping,
  sequence, state dict or ``nn.Module``, naming the key path of the first
  non-finite leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# Ops whose divisor (the second argument; the only one for reciprocal) is checked.
_DIVISIONS = {aten.div, aten.div_, aten.floor_divide, aten.floor_divide_}
_RECIPROCALS = {aten.reciprocal, aten.reciprocal_}

# Ops that only move, select, compare or convert values: a NaN in their
# output came in through an input, and checkify's NaN check skips their
# primitives (reshape, broadcast, transpose, slice, concatenate, select_n,
# gather, scatter, max, min, neg, abs, sign, round, convert_element_type).
_PASS_THROUGH = {
    aten.view, aten._unsafe_view, aten.reshape, aten.expand, aten.permute, aten.t,
    aten.transpose, aten.squeeze, aten.unsqueeze, aten.flatten, aten.unflatten,
    aten.slice, aten.select, aten.split, aten.split_with_sizes, aten.unbind,
    aten.chunk, aten.narrow, aten.as_strided, aten.alias, aten.detach, aten.lift_fresh,
    aten.clone, aten.copy_, aten._to_copy, aten.to, aten.contiguous,
    aten.cat, aten.stack, aten.flip, aten.roll, aten.repeat,
    aten.where, aten.masked_fill, aten.masked_fill_, aten.index, aten.index_select,
    aten.gather, aten.scatter, aten.index_put, aten.index_put_, aten.take,
    aten.maximum, aten.minimum, aten.max, aten.min, aten.amax, aten.amin,
    aten.clamp, aten.clamp_, aten.clamp_min, aten.clamp_max, aten.relu, aten.relu_,
    aten.neg, aten.abs, aten.sign, aten.round, aten.floor, aten.ceil, aten.trunc,
    aten.fill_, aten.zero_, aten.zeros_like, aten.ones_like, aten.empty_like,
    aten.full_like, aten.new_zeros, aten.new_ones, aten.new_empty, aten.new_full,
}


def _floating(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class _FloatChecks(TorchDispatchMode):
    """Raises the first fault of the ops dispatched under it (``strict``),
    or records it in ``error`` and lets the ops run on."""

    def __init__(self, strict: bool):
        super().__init__()
        self.strict = strict
        self.error: Exception | None = None

    def _fault(self, error: Exception) -> None:
        if self.strict:
            raise error
        self.error = error

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if self.error is None and (packet in _DIVISIONS or packet in _RECIPROCALS):
            divisor = args[0] if packet in _RECIPROCALS else args[1]
            zero = ((divisor == 0).any().item() if isinstance(divisor, torch.Tensor)
                    else divisor == 0)
            if zero:
                self._fault(ZeroDivisionError(f"division by zero in aten.{packet.__name__}"))
        out = func(*args, **kwargs)
        if self.error is None and packet not in _PASS_THROUGH:
            if any(_floating(t) and torch.isnan(t).any().item() for t in tree_leaves(out)):
                self._fault(FloatingPointError(f"nan generated by aten.{packet.__name__}"))
        return out


def checked(fn: Callable, strict: bool = True) -> Callable:
    """``fn`` with NaN and division checks on every op inside it. With
    ``strict`` the first fault raises; otherwise the wrapper returns
    ``(error_or_None, out)`` (an integer division by zero still raises
    there: torch does not compute it)."""

    def wrapper(*args, **kwargs):
        mode = _FloatChecks(strict)
        with mode:
            out = fn(*args, **kwargs)
        return out if strict else (mode.error, out)

    return wrapper


def scrub_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Replace NaN and Inf with zeros (conditional_diffusion_laion.py:591-598)."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _leaves_with_path(tree: Any, path: str = ""):
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        for key, value in tree.items():
            yield from _leaves_with_path(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves_with_path(value, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming ``name`` and the key path of the
    first floating leaf that holds a NaN or an Inf (use in loops and tests)."""
    for path, leaf in _leaves_with_path(tree):
        arr = leaf.detach().float().cpu().numpy() if _floating(leaf) else np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            raise FloatingPointError(f"non-finite values in {name}{path}")
