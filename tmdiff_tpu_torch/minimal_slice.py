"""The smallest end-to-end run of the port (port of examples/minimal_slice.py):
one synthetic WorldView-3-like 8-band 64x64 MS + PAN patch, a full-width
WavBEST (channels 32, 64, 128, 256) with weights from a seed, the frozen WV3
prompt row, 20-step multistep DPM-Solver++ (`dpm++_noise`), the residual
added back to the MS, and the reduced-resolution scores against the ground
truth.

    python -m tmdiff_tpu_torch.minimal_slice [--device cpu]

Runs on CUDA unless `--device` says otherwise. An untrained model should
roughly reproduce the upsampled MS.
"""
from __future__ import annotations

import argparse

import numpy as np

from tmdiff_tpu_torch.data.synthetic import make_arrays
from tmdiff_tpu_torch.eval.metrics import evaluate_rr
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.pipeline import Pansharpener


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m tmdiff_tpu_torch.minimal_slice")
    parser.add_argument("--device", default=None, help="torch device; CUDA when not given")
    args = parser.parse_args(argv)
    data = make_arrays(n=1, bands=8, size=64, seed=0)
    model = WavBEST((32, 64, 128, 256), device=args.device, seed=0)
    sharp = Pansharpener(model, device=args.device)
    pred = sharp.sample({"PAN": data["pan"], "MS": data["lms"]}, sensor="WV3",
                        method="dpm++_noise", steps=20)
    scores = evaluate_rr(np.transpose(data["gt"][0], (1, 2, 0)),
                         np.transpose(pred[0], (1, 2, 0)))
    print({k: round(float(v), 4) for k, v in scores.items()})
    print("pred range:", float(pred.min()), float(pred.max()))
    return scores


if __name__ == "__main__":
    main()
