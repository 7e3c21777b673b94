"""The sampler chains as CUDA graphs replay them, on the CPU.

``core.sampler`` writes each chain's step once, as a body over device
buffers indexed by a position tensor, and ``core.graphs.ChainRunner`` warms
it up, captures it and replays it. Here a stand-in for the card's graphs
(``StandInGraphs``, put in place of ``core.graphs.BACKEND`` by the tests
only) records a body at its capture and re-runs it at each replay, so the
runner's static buffers, keys and generator hand-off run on the CPU.

The chains stepped that way are held bit for bit, with the generator's state
after them, against the eager loops the port ran before its chains had
bodies (``_loop_*`` below, transcribed from them), on
``tests/test_torch_sampler.py``'s closed-form and UNet denoisers. JAX parity
stays with ``tests/test_torch_sampler.py``, whose eager chains run the same
bodies.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_diffusion import _small_pair
from tests.test_torch_sampler import _closed_port
from tinydiffusion_torch.core import graphs, sampler
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.experiments.common import make_sampler
from tinydiffusion_torch.models.unet28 import UNet28

T = 1000
CLOSED_SHAPE = (3, 1, 6, 6)
UNET_SHAPE = (2, 1, 28, 28)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops on a few shared cores: one thread, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the stand-in graphs --------------------------------------------------------------


class _StandInGraph:
    """A captured body: nothing runs at the capture; each replay runs it and
    writes what it returns into one output tensor, as a graph's replays
    rewrite its static output."""

    def __init__(self, fn):
        self.fn, self.out, self.capture_ms = fn, None, 0.0

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            out = self.fn()
            if isinstance(out, torch.Tensor):
                if self.out is None:
                    self.out = out
                else:
                    self.out.copy_(out)


class StandInGraphs(graphs.CudaGraphs):
    """``core.graphs.BACKEND`` on the CPU: graphs everywhere, warm-ups run
    in place, the generator handed through its whole state."""

    def __init__(self):
        self.captured = []  # (the stand-in graph, the generators registered)

    @staticmethod
    def available(device) -> bool:
        return True

    @staticmethod
    def warm(fn, device):
        return fn()

    def capture(self, fn, device, generators=()):
        graph = _StandInGraph(fn)
        self.captured.append((graph, generators))
        return graph

    @staticmethod
    def generator(device) -> torch.Generator:
        return torch.Generator(device)

    @staticmethod
    def hand_in(own, caller) -> None:
        own.set_state(caller.get_state())

    @staticmethod
    def hand_back(own, caller) -> None:
        caller.set_state(own.get_state())


@pytest.fixture
def stand_in(monkeypatch) -> StandInGraphs:
    backend = StandInGraphs()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    return backend


# --- the eager loops before the chains had bodies ---------------------------------------


class _Draws:
    def __init__(self, shape, generator, noise_stream=None, known_stream=None):
        self.shape, self.generator = shape, generator
        self.streams = {"noise": noise_stream, "known": known_stream}

    def normal(self):
        return torch.randn(self.shape, generator=self.generator)

    def init(self, x_init):
        return x_init.clone() if x_init is not None else self.normal()

    def step(self, kind, i):
        stream = self.streams[kind]
        return stream[i] if stream is not None else self.normal()


def _t_vec(x, t):
    return torch.full((x.shape[0],), t, dtype=torch.int64)


def _loop_ddpm(apply_fn, schedule, shape, generator, timesteps, keep_frames=False,
               x_init=None, noise_stream=None, mask=None, x_known=None, known_stream=None):
    c_x, c_eps, sigma, c_known, c_noise = sampler._ddpm_tables(schedule)
    draws = _Draws(shape, generator, noise_stream, known_stream)
    x = draws.init(x_init)
    frames = []
    for i, t in enumerate(timesteps):
        eps_hat = apply_fn(x, _t_vec(x, t))
        x = c_x[t] * (x - c_eps[t] * eps_hat)
        if t > 0:
            x = x + sigma[t] * draws.step("noise", i)
        if mask is not None:
            zk = draws.step("known", i) if t > 0 else None
            x = sampler._composite(x, mask, x_known, c_known[t], c_noise[t], zk)
        frames.append(x)
    return torch.stack(frames) if keep_frames else x


def _loop_ddim(apply_fn, schedule, shape, generator, num_steps, eta, x_init=None, t_start=None,
               mask=None, x_known=None, noise_stream=None, known_stream=None):
    taus = sampler.ddim_timesteps(schedule.num_timesteps, num_steps, t_start)
    host = sampler._ddim_tables(sampler._host_alphas_cumprod(schedule), taus, float(eta))
    final = host.pop("final")
    tab = {k: torch.from_numpy(v) for k, v in host.items()}
    draws = _Draws(shape, generator, noise_stream, known_stream)
    x = draws.init(x_init)
    for i, t in enumerate(taus.tolist()):
        c = {k: v[i] for k, v in tab.items()}
        eps_hat = apply_fn(x, _t_vec(x, t))
        x0_hat = (x - c["eps_in_x0"] * eps_hat) * c["x0_scale"]
        x = c["x0_out"] * x0_hat + c["eps_out"] * eps_hat
        if eta > 0.0:
            z = draws.step("noise", i)
            if not final[i]:
                x = x + c["sigma"] * z
        if mask is not None:
            zk = draws.step("known", i)
            x = sampler._composite(x, mask, x_known, c["x0_out"], c["known_noise"],
                                   None if final[i] else zk)
    return x


def _loop_dpmpp(apply_fn, schedule, shape, generator, num_steps, x_init=None):
    taus, *coeffs = sampler._dpmpp_coefficients(sampler._host_alphas_cumprod(schedule),
                                                 num_steps)
    a_t, s_t, c_x, c_d, c_2 = (torch.from_numpy(v).float() for v in coeffs)
    x = _Draws(shape, generator).init(x_init)
    m_prev = torch.zeros_like(x)
    for i, t in enumerate(taus.tolist()):
        eps_hat = apply_fn(x, _t_vec(x, t))
        m = (x - s_t[i] * eps_hat) / a_t[i]
        x = c_x[i] * x + c_d[i] * m + c_2[i] * (m - m_prev)
        m_prev = m
    return x


# --- the cases --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _denoiser(kind: str):
    if kind == "closed":
        return _closed_port, CLOSED_SHAPE
    model = _small_pair(seed=11)[2].eval()
    return (lambda x, t: model(x, t)), UNET_SHAPE


def _inpainting(shape):
    rng = np.random.default_rng(5)
    x_known = torch.from_numpy(rng.uniform(-1, 1, (1,) + shape[1:]).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(1,) + shape[1:]) < 0.5).astype(np.float32))
    return {"mask": mask, "x_known": x_known}


# name -> (T, new chain from (apply_fn, schedule, shape, inputs), old loop from
# (apply_fn, schedule, shape, generator, **inputs), inpainting, img2img)
CASES = {
    "ddpm": (20, lambda f, s, sh, i: sampler.ddpm_chain(f, s, sh, torch.float32, i,
                                                        range(19, -1, -1)),
             lambda f, s, sh, g, **kw: _loop_ddpm(f, s, sh, g, range(19, -1, -1), **kw),
             False, False),
    "ddpm_inpaint": (20, lambda f, s, sh, i: sampler.ddpm_chain(f, s, sh, torch.float32, i,
                                                                range(19, -1, -1)),
                     lambda f, s, sh, g, **kw: _loop_ddpm(f, s, sh, g, range(19, -1, -1), **kw),
                     True, False),
    "ddim_eta0": (T, lambda f, s, sh, i: sampler.ddim_chain(f, s, sh, torch.float32, i, 10, 0.0),
                  lambda f, s, sh, g, **kw: _loop_ddim(f, s, sh, g, 10, 0.0, **kw), False, False),
    "ddim_eta1": (T, lambda f, s, sh, i: sampler.ddim_chain(f, s, sh, torch.float32, i, 10, 1.0),
                  lambda f, s, sh, g, **kw: _loop_ddim(f, s, sh, g, 10, 1.0, **kw), False, False),
    "ddim_img2img": (T, lambda f, s, sh, i: sampler.ddim_chain(f, s, sh, torch.float32, i, 20,
                                                               0.0, 599),
                     lambda f, s, sh, g, **kw: _loop_ddim(f, s, sh, g, 20, 0.0, t_start=599, **kw),
                     False, True),
    "ddim_inpaint": (T, lambda f, s, sh, i: sampler.ddim_chain(f, s, sh, torch.float32, i, 10,
                                                               1.0),
                     lambda f, s, sh, g, **kw: _loop_ddim(f, s, sh, g, 10, 1.0, **kw), True, False),
    "dpmpp1": (T, lambda f, s, sh, i: sampler.dpmpp_chain(f, s, sh, torch.float32, i, 1),
               lambda f, s, sh, g, **kw: _loop_dpmpp(f, s, sh, g, 1, **kw), False, False),
    "dpmpp2": (T, lambda f, s, sh, i: sampler.dpmpp_chain(f, s, sh, torch.float32, i, 2),
               lambda f, s, sh, g, **kw: _loop_dpmpp(f, s, sh, g, 2, **kw), False, False),
    "dpmpp15": (T, lambda f, s, sh, i: sampler.dpmpp_chain(f, s, sh, torch.float32, i, 15),
                lambda f, s, sh, g, **kw: _loop_dpmpp(f, s, sh, g, 15, **kw), False, False),
    "trajectory": (T, lambda f, s, sh, i: sampler.trajectory_chain(f, s, sh, torch.float32, i,
                                                                   100),
                   lambda f, s, sh, g, **kw: _loop_ddpm(f, s, sh, g, range(900, -1, -100),
                                                        keep_frames=True, **kw),
                   False, False),
}


@pytest.mark.parametrize("kind", ["closed", "unet"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_bodies_equal_the_eager_loops_bit_for_bit(stand_in, kind, case):
    """Each chain stepped as a replay steps it (position tensor, static
    buffers, warm-ups, a capture a kind, replays) equals the loop the port
    ran before, and leaves the generator where the loop leaves it; a second
    request with other draws replays what the first captured."""
    num_timesteps, new_chain, old_loop, inpaint, img2img = CASES[case]
    apply_fn, shape = _denoiser(kind)
    schedule = DiffusionSchedule.linear(num_timesteps)
    extra = _inpainting(shape) if inpaint else {}
    runner = graphs.ChainRunner()
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        x_init = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  if img2img else None)
        got_gen, want_gen = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        inputs = sampler.chain_inputs(torch.device("cpu"), torch.float32, x_init=x_init, **extra)
        got = runner.run(case, (), lambda i: new_chain(apply_fn, schedule, shape, i),
                         torch.device("cpu"), got_gen, inputs)
        want = old_loop(apply_fn, schedule, shape, want_gen, x_init=x_init, **extra)
        assert torch.equal(got, want), (case, seed, (got - want).abs().max())
        assert torch.equal(got_gen.get_state(), want_gen.get_state())
    steps = len(new_chain(apply_fn, schedule, shape, inputs).kinds)
    if steps <= graphs.GRAPH_WARMUP_STEPS:
        assert runner.counts["captures"] == 0 and runner.counts["eager"] == 2 * steps
    else:
        kinds = 2 if case in ("ddpm", "ddpm_inpaint", "trajectory") else 1
        assert runner.counts == {"eager": graphs.GRAPH_WARMUP_STEPS, "captures": kinds,
                                 "replays": 2 * steps - graphs.GRAPH_WARMUP_STEPS,
                                 "forwards": 2 * steps, "capture_ms": 0.0}
        draws = case in ("ddpm", "ddpm_inpaint", "ddim_eta1", "ddim_inpaint", "trajectory")
        assert all(bool(gens) == draws for _, gens in stand_in.captured)


def test_the_final_ddpm_step_draws_nothing(stand_in):
    """The t = 0 step is a body of its own, captured without a draw: after a
    DDPM-20 chain the generator has drawn x_init and 19 steps' noise."""
    schedule, shape = DiffusionSchedule.linear(20), CLOSED_SHAPE
    chain = sampler.ddpm_chain(_closed_port, schedule, shape, torch.float32,
                               sampler.chain_inputs("cpu", torch.float32), range(19, -1, -1))
    assert chain.kinds == ["step"] * 19 + ["last"]
    gen, want = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    cpu = torch.device("cpu")
    graphs.ChainRunner().run("ddpm", (), lambda i: sampler.ddpm_chain(
        _closed_port, schedule, shape, torch.float32, i, range(19, -1, -1)), cpu, gen,
        sampler.chain_inputs(cpu, torch.float32))
    for _ in range(20):
        torch.randn(shape, generator=want)
    assert torch.equal(gen.get_state(), want.get_state())


# --- make_sampler's graphs --------------------------------------------------------------


def _cfg_model(seed: int = 0) -> UNet28:
    torch.manual_seed(seed)
    return UNet28(time_dim=32, base_width=8, num_classes=11).eval()


def _stream(rng, steps, shape):
    return torch.from_numpy(rng.standard_normal((steps,) + shape).astype(np.float32))


def test_a_second_request_replays_and_keeps_the_first_output(stand_in):
    """The same key replays without a capture; the first request's output is
    a clone that the second leaves alone; x_init, y, noise_stream and
    known_stream reach the captured body through the static buffers (each
    request equals the eager chain on its own inputs)."""
    model, schedule = _cfg_model(), DiffusionSchedule.linear(20)
    shape = (3, 1, 28, 28)
    inpaint = _inpainting(shape)
    fn = make_sampler(model, schedule, shape, conditional=True, guidance_scale=2.0,
                      null_label=10, **inpaint)
    outs = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        request = dict(y=torch.from_numpy(rng.integers(0, 10, 3)),
                       x_init=_stream(rng, 1, shape)[0], noise_stream=_stream(rng, 20, shape),
                       known_stream=_stream(rng, 20, shape))
        outs.append((fn(**request), fn.eager(**request)))
        assert torch.equal(*outs[-1])
    assert not torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][0], outs[0][1])  # unchanged by the second request
    # Every draw replayed: the graphs register no generator.
    assert fn.counts == {"eager": 2 + 40, "captures": 2, "replays": 2 * 20 - 2,
                         "forwards": 80, "capture_ms": 0.0}
    assert [gens for _, gens in stand_in.captured] == [(), ()]


def test_another_key_captures_anew(stand_in):
    """Another n or another params identity captures again; another guidance
    or method is another sampler, whose graphs are its own; the same
    generator seed gives the eager chain's samples throughout."""
    model, schedule = _cfg_model(), DiffusionSchedule.linear(20)
    y = torch.tensor([1, 2, 3, 4])
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    other = {n: p * 1.01 for n, p in params.items()}
    samplers = {
        "cfg": make_sampler(model, schedule, (4, 1, 28, 28), conditional=True,
                            guidance_scale=2.0, null_label=10),
        "cfg3": make_sampler(model, schedule, (4, 1, 28, 28), conditional=True,
                             guidance_scale=3.0, null_label=10),
        "ddim": make_sampler(model, schedule, (4, 1, 28, 28), conditional=True,
                             guidance_scale=2.0, null_label=10, method="ddim", sample_steps=5,
                             eta=1.0),
    }
    requests = [("cfg", dict(params=params, y=y), 1), ("cfg", dict(params=params, y=y), 0),
                ("cfg", dict(params=params, y=y[:2], n=2), 1),
                ("cfg", dict(params=other, y=y[:2], n=2), 1),
                ("cfg", dict(params=other, y=y[:2], n=2), 0),
                ("cfg3", dict(params=params, y=y), 1), ("ddim", dict(params=params, y=y), 1)]
    for name, request, captures in requests:
        fn = samplers[name]
        before = fn.counts["captures"]
        got_gen, want_gen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
        got, want = fn(got_gen, **request), fn.eager(want_gen, **request)
        assert torch.equal(got, want), name
        assert torch.equal(got_gen.get_state(), want_gen.get_state())
        # A DDPM chain captures its steps and its final step; DDIM one body.
        assert fn.counts["captures"] - before == captures * (1 if name == "ddim" else 2), name
