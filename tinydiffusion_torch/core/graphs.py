"""CUDA graphs: the port's counterpart of ``jax.jit`` over a whole program.

JAX compiles each reverse chain into one ``lax.scan`` inside one jit, and
the conv-VAE's serving calls into jitted programs. On a card the port
captures the same work in ``torch.cuda.CUDAGraph``s and replays them, so the
host only calls ``replay()``; on the CPU the same bodies run eagerly.

- ``warm_up`` and ``capture`` are the mechanics every graph of the port
  goes through (the train steps of ``train/trainer.py`` too): eager warm-ups
  on a side stream, generators registered with the graph, and the kernel
  launches recorded in a capture counted once a replay in ``ops.qsample``'s
  and ``ops.attention``'s launch counts.
- ``ChainRunner`` runs a ``core.sampler.Chain``: its first
  ``GRAPH_WARMUP_STEPS`` steps eagerly, then each kind of step captured once
  and replayed, then the decode tail (a function of the chain's end) as a
  small graph of its own, warmed up by the first request. A chain of no more
  steps than the warm-up runs eagerly.
- ``GraphedCall`` runs a function of a few tensors as one graph per key,
  after one eager call (the conv-VAE's ``reconstruct`` and ``sample_prior``).

Each cached graph belongs to a key: the shapes, the options, and the
``data_ptr`` of every tensor it reads (the parameters, buffers and tables).
Those tensors are held with the graph, so no address of the key can be
reused while it lives; another key frees the old graph first. Inputs that
change from call to call are copied into static buffers, and the result is a
clone of the graph's static output, so that the next call cannot overwrite
it. A failed capture raises: no call falls back to eager steps.

Generators: a graph replays the draws of the generator registered at its
capture. A request brings its own generator (``generate.py`` and the FID
tools seed a fresh one for each), so the runner registers one generator of
its own and hands the caller's state through it: before the replays it
takes the caller's seed (``initial_seed``) and Philox offset
(``get_offset``) with ``manual_seed`` and ``set_offset``; each replay reads
them on the host and advances the offset by what the graph draws; after the
replays the caller's generator gets the advanced offset back
(``set_offset``). The caller's generator then ends where the eager chain
leaves it, whatever else drew from it before (a FID row draws its labels
from the generator of its chains).

A graph keeps the math mode of its capture (the callers turn TF32 off first:
``device.disable_tf32``) and the compute dtype its model ran in then
(``nn.layers.computing_in``; each weight is cast inside the graph, at every
replay).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
from torch import nn

from tinydiffusion_torch.ops import attention, qsample

# Eager steps before a capture, on a side stream: cuDNN settles its
# algorithms and every library handle exists before the graph records.
GRAPH_WARMUP_STEPS = 2


def warm_up(fn: Callable, device: torch.device):
    """``fn()`` eagerly on a side stream (a warm-up before a capture), ordered
    after and before the current stream's work."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


@dataclasses.dataclass
class Captured:
    """A captured graph, what its capture returned (its static output), the
    kernel launches recorded in it, and the host's seconds to capture it."""

    graph: torch.cuda.CUDAGraph
    out: object
    qsample_per_replay: int
    flash_per_replay: dict[str, int]
    capture_ms: float

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self.graph.replay()
        qsample.count_replays(self.qsample_per_replay, times)
        attention.count_replays(self.flash_per_replay, times)


def capture(fn: Callable, device: torch.device, generators=()) -> Captured:
    """``fn()`` captured in a new CUDA graph, not run. Each of ``generators``
    is registered with the graph: an unregistered one fails the capture, or
    would replay the captured draws; registered, each replay draws on from
    its state. Raises when the capture fails."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    qsample_before = qsample.qsample_captured
    flash_before = dict(attention.captured)
    # ``torch.cuda.graph``'s steps, but for its emptying of the allocator's
    # device and pinned-host caches: a serving request that captures (each
    # ``generate.py`` call does) paid up to half a second for them.
    torch.cuda.synchronize(device)
    stream = torch.cuda.Stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    return Captured(graph, out, qsample.qsample_captured - qsample_before,
                    {k: n - flash_before[k] for k, n in attention.captured.items()},
                    1e3 * (time.perf_counter() - t0))


class CudaGraphs:
    """What the runners need of the card. Tests may replace ``BACKEND`` with
    a stand-in that replays on the CPU; nothing else does."""

    @staticmethod
    def available(device: torch.device) -> bool:
        return device.type == "cuda"

    warm = staticmethod(warm_up)
    capture = staticmethod(capture)

    @staticmethod
    def generator(device: torch.device) -> torch.Generator:
        return torch.Generator(device)

    @staticmethod
    def hand_in(own: torch.Generator, caller: torch.Generator) -> None:
        own.manual_seed(caller.initial_seed())
        own.set_offset(caller.get_offset())

    @staticmethod
    def hand_back(own: torch.Generator, caller: torch.Generator) -> None:
        caller.set_offset(own.get_offset())


BACKEND = CudaGraphs()


def tensors_of(*objs) -> list[torch.Tensor]:
    """Every tensor that ``objs`` hold: tensors, a module's parameters and
    buffers, the values of dicts and sequences, and the tensor and module
    attributes of any other object (a schedule, a codec)."""
    out = []
    for obj in objs:
        if obj is None:
            continue
        if isinstance(obj, torch.Tensor):
            out.append(obj)
        elif isinstance(obj, nn.Module):
            out += list(obj.parameters()) + list(obj.buffers())
        elif isinstance(obj, dict):
            out += tensors_of(*obj.values())
        elif isinstance(obj, (list, tuple)):
            out += tensors_of(*obj)
        elif hasattr(obj, "__dict__"):
            out += tensors_of(*(v for v in vars(obj).values()
                                if isinstance(v, (torch.Tensor, nn.Module))))
    return out


def _key(key, reads: list[torch.Tensor]) -> tuple:
    return key, tuple(t.data_ptr() for t in reads)


class _Unit:
    """One body: ``warmup`` eager runs on a side stream (counted in
    ``counts["eager"]`` where ``count_eager``), then one capture, then
    replays."""

    def __init__(self, fn: Callable, warmup: int, generators=(), count_eager: bool = True):
        self.fn, self.warmup, self.generators = fn, warmup, generators
        self.count_eager = count_eager
        self.warm, self.captured = 0, None

    def run(self, times: int, device: torch.device, counts: dict):
        """``fn``'s work ``times`` times over; what its last run returned (a
        graph's static output once it replays)."""
        out = None
        while times and self.warm < self.warmup:
            out = BACKEND.warm(self.fn, device)
            self.warm += 1
            times -= 1
            counts["eager"] += self.count_eager
        if times:
            if self.captured is None:
                self.captured = BACKEND.capture(self.fn, device, self.generators)
                counts["captures"] += 1
                counts["capture_ms"] += self.captured.capture_ms
            self.captured.replay(times)
            counts["replays"] += times
            out = self.captured.out
        return out


def _new_counts() -> dict:
    return {"eager": 0, "captures": 0, "replays": 0, "forwards": 0, "capture_ms": 0.0}


def _statics(inputs: dict) -> dict:
    return {name: torch.empty_like(v) for name, v in inputs.items() if v is not None}


def _copy_in(statics: dict, inputs: dict) -> None:
    for name, v in inputs.items():
        if v is not None:
            statics[name].copy_(v)


class ChainRunner:
    """Runs reverse chains (``core.sampler.Chain``) as CUDA graphs on a card,
    eagerly elsewhere, keeping the graphs of the last key.

    ``counts``: chain steps run ``eager`` (the warm-ups, chains no longer
    than the warm-up, every step on the CPU), graph ``captures`` and
    ``replays`` (the tail's included), model ``forwards`` (one a step) and
    the host's ``capture_ms``."""

    def __init__(self):
        self.counts = _new_counts()
        self._entry = None

    @torch.inference_mode()
    def run(self, key, reads, build: Callable, device: torch.device, generator,
            inputs: dict, tail: Callable | None = None, eager: bool = False) -> torch.Tensor:
        """The chain that ``build(inputs) -> Chain`` makes on ``device``,
        started from ``generator`` and the named ``inputs`` (tensors on that
        device, or None), then ``tail`` of its end. On a card the chain is
        built once a ``key`` (with the addresses of what ``reads`` holds:
        everything the chain reads besides ``inputs``) over static copies of
        ``inputs``; ``eager`` runs the eager loop there instead, the
        reference a graph is held to."""
        entry = chain = None
        if not eager and BACKEND.available(device):
            reads = tensors_of(reads)
            key = _key((key, tail is not None, tuple(
                (name, v.shape, v.dtype) for name, v in inputs.items() if v is not None)), reads)
            if self._entry is not None and self._entry["key"] == key:
                entry = self._entry
        if entry is None:
            chain = build(inputs)
            if eager or not BACKEND.available(device) or len(chain.kinds) <= GRAPH_WARMUP_STEPS:
                self.counts["eager"] += len(chain.kinds)
                self.counts["forwards"] += len(chain.kinds)
                out = chain.run_eagerly(generator)
                return out if tail is None else tail(out)
            self._entry = None  # frees the old graphs first
            entry = self._new_entry(key, reads, build, inputs, tail)
        chain = entry["chain"]
        _copy_in(entry["statics"], inputs)
        chain.start(generator)
        if chain.draws:
            BACKEND.hand_in(chain.generator, generator)
        for kind, times in _segments(chain.kinds):
            entry["units"][kind].run(times, device, self.counts)
        if chain.draws:
            BACKEND.hand_back(chain.generator, generator)
        self.counts["forwards"] += len(chain.kinds)
        out = chain.result() if tail is None else entry["tail"].run(1, device, self.counts)
        return out.clone()

    def _new_entry(self, key, reads, build, inputs, tail) -> dict:
        statics = _statics(inputs)
        chain = build(statics)
        chain.generator = BACKEND.generator(chain.x.device)
        generators = (chain.generator,) if chain.draws else ()
        units = {}
        for kind in chain.kinds:
            if kind not in units:
                # The chain's first steps warm every later kind up too.
                units[kind] = _Unit(chain.bodies[kind], GRAPH_WARMUP_STEPS if not units else 0,
                                    generators)
        entry = {"key": key, "reads": reads, "statics": statics, "chain": chain,
                 "units": units}
        if tail is not None:
            entry["tail"] = _Unit(lambda: tail(chain.result()), 1, count_eager=False)
        self._entry = entry
        return entry


def _segments(kinds: list[str]) -> list[tuple[str, int]]:
    """Runs of equal kinds, in order: ``[("step", 999), ("last", 1)]``."""
    out = []
    for kind in kinds:
        if out and out[-1][0] == kind:
            out[-1] = (kind, out[-1][1] + 1)
        else:
            out.append((kind, 1))
    return out


class GraphedCall:
    """``fn(*inputs) -> tensor`` as one CUDA graph per key on a card, after
    one eager call of that key on a side stream; directly elsewhere.
    ``counts`` as ``ChainRunner``'s (``eager`` and ``forwards`` count calls)."""

    def __init__(self):
        self.counts = _new_counts()
        self._entry = None

    @torch.inference_mode()
    def __call__(self, fn: Callable, key, reads, *inputs: torch.Tensor) -> torch.Tensor:
        """``fn(*inputs)``; on a card, from the graph of ``key``, the inputs'
        shapes and dtypes and the addresses of what ``reads`` holds."""
        device = inputs[0].device
        self.counts["forwards"] += 1
        if not BACKEND.available(device):
            self.counts["eager"] += 1
            return fn(*inputs)
        reads = tensors_of(reads)
        full_key = _key((key, tuple((v.shape, v.dtype) for v in inputs)), reads)
        entry = self._entry
        if entry is None or entry["key"] != full_key:
            self._entry = None
            statics = [torch.empty_like(v) for v in inputs]
            entry = self._entry = {"key": full_key, "reads": reads, "statics": statics,
                                   "unit": _Unit(lambda: fn(*statics), 1)}
        for static, v in zip(entry["statics"], inputs):
            static.copy_(v)
        return entry["unit"].run(1, device, self.counts).clone()
