"""The FID anchors of ``chip_smoke.py``: JAX's own tool's rows on the CPU.

``chip_smoke.py``'s ``fid_mnist`` phase holds each of the card's FID rows to
2x JAX's row for the same checkpoint, variant, guidance scale, n and seed.
Those rows were taken once with JAX's ``tools/fid_eval.py`` on the CPU and
committed as ``tests/fixtures/fid_jax_cpu_rows.json`` (the command that made
them is in the file). This test holds the fixture to what ``chip_smoke.py``
runs, and its calibration rows (real train images and Gaussian noise
against the test set, no sampling) to the port's CPU rows on the same
synthetic MNIST set.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import json
import os

import numpy as np
import pytest

import chip_smoke
from tinydiffusion_torch.tools import fid_eval

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "fid_jax_cpu_rows.json")
# The port's calibration rows against JAX's: the same images, float32
# features summed in other orders (the card-vs-CPU bound of chip_smoke.py).
CALIBRATION_RTOL = 1e-3


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def test_fixture_holds_the_rows_chip_smoke_runs(fixture):
    assert chip_smoke.FID_JAX == fixture
    assert (fixture["n"], fixture["sample_batch"]) == (chip_smoke.FID_N,
                                                       chip_smoke.FID_SAMPLE_BATCH)
    assert fixture["platform"] == "cpu" and "tools/fid_eval.py" in fixture["command"]
    for (name, variants, scale, fids, label_acc), row in zip(chip_smoke.FID_MNIST_ROWS,
                                                             fixture["rows"]):
        assert (name, variants, scale) == (row["checkpoint"], row["variants"],
                                           row["guidance_scale"])
        assert set(fids) == set(variants.split(",")) and row["seed"] == 0
        assert all(np.isfinite(v) and v > 0 for v in fids.values())
        conditional = name != "diffusion_final"
        assert (label_acc is not None) == conditional
    spread = fixture["spread_row"]
    first = chip_smoke.FID_MNIST_ROWS[0]
    assert (spread["checkpoint"], spread["variant"], spread["seed"]) == (
        first[0], first[1].split(",")[0], chip_smoke.FID_SPREAD_SEED)
    # The stale TPU figure this replaced: 65.3 on the CFG row at s = 1.
    cfg = next(r for r in fixture["rows"]
               if r["checkpoint"] == "conditional_cfg_ema_best" and r["guidance_scale"] == 1.0)
    assert cfg["fid"]["ddim50"] < 20 and cfg["label_acc"] > 0.97


def test_calibration_rows_equal_the_ports_cpu_rows(fixture, tmp_path):
    """The port's tool on the CPU, no variant: its calibration rows at each
    seed the fixture holds, on the synthetic MNIST set JAX's run read."""
    checkpoint = os.path.join(chip_smoke.REPO, "checkpoints", "diffusion_final")
    for seed, want in ((0, fixture["calibration"]),
                       (fixture["spread_row"]["seed"], fixture["spread_row"]["calibration"])):
        result = fid_eval.main(["--checkpoint", checkpoint, "--variants", "", "--n",
                                str(fixture["n"]), "--seed", str(seed), "--data-root",
                                str(tmp_path), "--device", "cpu"])
        got = {r["variant"]: r["fid"] for r in result["rows"]}
        assert got.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=CALIBRATION_RTOL, err_msg=key)
