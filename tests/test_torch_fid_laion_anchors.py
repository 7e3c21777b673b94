"""The LAION FID anchors of ``chip_smoke.py``: JAX's own tool's rows on the CPU.

``chip_smoke.py``'s ``fid_laion`` phase holds each of the card's LAION FID
rows to 2x JAX's ``tools/fid_eval_laion.py`` row at n = 512, taken once on
the CPU and committed as ``tests/fixtures/fid_laion_jax_cpu_rows.json`` (the
commands are in the file). This test holds the fixture to what
``chip_smoke.py`` runs, and its calibration rows (deterministic images and
numpy noise against the synthetic real set, at 256²) to the port's CPU rows.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import json
import os

import numpy as np

import chip_smoke
from tinydiffusion_torch.tools import fid_eval_laion

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "fid_laion_jax_cpu_rows.json")
# The same images, float32 features summed in other orders; the rows are
# rounded to 3 decimals on both sides.
CALIBRATION_RTOL = 1e-3


def test_laion_fixture_holds_the_rows_chip_smoke_runs():
    with open(FIXTURE) as f:
        fixture = json.load(f)
    assert chip_smoke.FID_LAION_JAX == fixture["rows"]
    assert fixture["n"] == chip_smoke.FID_N and fixture["platform"] == "cpu"
    assert "tools/fid_eval_laion.py" in fixture["command"]
    assert set(fixture["rows"]) == {"calibration_floor_real_vs_real",
                                    "calibration_ceiling_real_vs_noise", "vae_recon",
                                    "vae_prior_decode", "samples_dir[256]"}
    assert all(np.isfinite(v) and v > 0 for v in fixture["rows"].values())

    port = fid_eval_laion.main(["--n", str(fixture["n"]), "--batch", "32", "--vae-checkpoint",
                                os.path.join(os.path.dirname(FIXTURE), "no_such_vae"),
                                "--device", "cpu"])
    for key in ("calibration_floor_real_vs_real", "calibration_ceiling_real_vs_noise"):
        np.testing.assert_allclose(port[key], fixture["rows"][key], rtol=CALIBRATION_RTOL,
                                   err_msg=key)
