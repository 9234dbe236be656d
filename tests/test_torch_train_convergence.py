"""The port's convergence driver (tmdiff_tpu_torch/train_convergence.py) on
the CPU at a small size: 20 steps of the CLI's train path at channels
(4, 8, 8, 16), 16x16 scenes, two validation scenes a sensor. It writes the
JAX tool's keys (tools/train_convergence.py), trains the 20 steps, scores
every sensor, and its `lms` baseline equals the JAX package's scoring of
the same synthetic scenes (data/synthetic.py draws the same arrays in both
packages) within 1e-6 relative. Whether 20 steps beat the baselines is not
asserted: that is the card run's question (3000 steps)."""
import json

import numpy as np
import torch

from tmdiff_tpu.data.synthetic import make_arrays as jax_make_arrays
from tmdiff_tpu.eval import metrics as jax_metrics
from tmdiff_tpu_torch import train_convergence

torch.set_num_threads(2)

SIZE, VAL_SCENES = 16, 2


def test_convergence_driver_runs_and_scores(tmp_path):
    out = tmp_path / "result.json"
    rc = train_convergence.main(
        ["--steps", "20", "--channels", "4,8,8,16", "--size", str(SIZE), "--scenes", "8",
         "--val-scenes", str(VAL_SCENES), "--device", "cpu", "--out", str(out),
         "--root", str(tmp_path / "run")])
    res = json.loads(out.read_text())
    assert rc == (0 if res["beats_lms_and_untrained"] else 1)
    assert res["trained_step"] == 20
    assert res["config"]["channels"] == [4, 8, 8, 16] and res["config"]["device"] == "cpu"
    sensors = ("QB", "GF2", "WV3")
    want = {"config", "clip_mode", "trained_step", "beats_lms_and_untrained"} | {
        f"{kind}_{s}" for kind in ("lms", "untrained", "trained") for s in sensors}
    assert set(res) == want
    for key in want - {"config", "clip_mode", "trained_step", "beats_lms_and_untrained"}:
        assert set(res[key]) == {"sam", "ergas", "ssim"}
        assert all(np.isfinite(v) for v in res[key].values()), key
    for i, (sensor, bands) in enumerate((("QB", 4), ("GF2", 4), ("WV3", 8))):
        data = jax_make_arrays(VAL_SCENES, bands, SIZE, seed=100 + i, noise=0.002)
        ref = jax_metrics.mean_scores(list(data["gt"]), list(data["lms"]))
        for metric, v in ref.items():
            np.testing.assert_allclose(res[f"lms_{sensor}"][metric], v, rtol=1e-6)
    # the CLI's run wrote its checkpoint and validation under --root
    assert (tmp_path / "run" / "experiments" / "checkpoint" / "I20").is_dir()
