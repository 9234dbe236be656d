"""The readings that a cell's limits are set from, on the card at the
cell's own sizes (not run by the benchmark's runs):

    python3 -m portbench.control --workload <cell> --seeds 11 12 13

For a serve cell it puts the cell's family's reference computed in the
control precision (fp8 operands for a bf16 configuration, the card's TF32
products for an fp32 one) in the program's place: as many requests as a
run compares, at placements drawn as a run's are (a batch seed, a bucket
of the engine's largest size, a row), each image against the float32
reference. For a training cell it
runs the compared steps three ways from the same weights and batches: the
control precision, and the reference with half of each batch left out of
the loss (the mean taken over the rest), each against the float32
reference. A state left unchanged reads 1 on the gradient and change gaps
by their definition and needs no run. Prints one JSON line a seed."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the nearest precision below the configuration's: fp8 operands for bfloat16,
# the card's TF32 products for float32
CONTROL = {"bfloat16": {"precision": "fp8"}, "float32": {"allow_tf32": True}}


def serve_readings(cell, seed: int, device) -> dict:
    from portbench import inputs, reference, serve

    family, t, m = cell.family, cell.traffic, cell.config["model"]
    weights = inputs.make_weights(family.weight_spec(m), seed, device)
    pool = inputs.scene_pool(seed, t["bands"], t["pool"], t["bands"], t["size"])
    n = cell.check["sample"]
    rng = np.random.default_rng([seed, 6])
    bucket = t["engine"]["max_batch"]
    reqs = [{"sensor": s, "scene": int(i), "extra": family.request_extra(t, seed, k)}
            for k, (s, i) in enumerate(zip(inputs.assign(t["sensors"], n, seed, 2),
                                           rng.integers(0, t["pool"], n)))]
    places = [{"seed": int(rng.integers(0, 2**31)), "bucket": bucket,
               "row": int(rng.integers(0, bucket))} for _ in range(n)]
    # the control's images, then each against the float32 reference
    control = serve_images(cell, weights, pool, reqs, places, device, **CONTROL[m["dtype"]])
    gaps = serve.reference_gaps(cell, weights, pool, reqs, list(zip(control, places)), device)
    return {"control_image_gap": serve.image_gap(gaps)}


def serve_images(cell, weights, pool, reqs, places, device, precision: str = "fp32",
                 allow_tf32: bool = False) -> list:
    import torch

    from portbench import inputs, reference

    m, t, e = cell.config["model"], cell.traffic, cell.traffic["engine"]
    kw = e.get("sampler_kw") or {}
    sab = reference.sqrt_alpha_bar(m["schedule"], m["n_timestep"], device)
    model = cell.family.reference(weights, m, precision)
    out = []
    with reference.products(allow_tf32), torch.no_grad():
        for r, p in zip(reqs, places):
            gen = torch.Generator(device=device).manual_seed(p["seed"])
            x_T = torch.randn((p["bucket"], t["bands"], t["size"], t["size"]), generator=gen,
                              device=device)[p["row"]:p["row"] + 1]
            pan = inputs.as_tensor(pool["pan"][r["scene"]][None], device)
            ms = inputs.as_tensor(pool["lms"][r["scene"]][None], device)
            prompt = inputs.as_tensor(inputs.prompt_table([r["sensor"]]), device)
            img = reference.sample(model, sab, pan, ms, prompt, x_T, e["method"], e["steps"],
                                   kw.get("refresh_every", 2), kw.get("cache_level", 1),
                                   inputs.stack([r["extra"]]))
            out.append(img[0].cpu().numpy())
    return out


def train_readings(cell, seed: int, device) -> dict:
    from portbench import inputs, train

    t, m = cell.traffic, cell.config["model"]
    spec = cell.family.weight_spec(m)
    names = [n for n, _, _, _ in spec]
    weights = inputs.make_weights(spec, seed, device)
    pools = {s: inputs.Pool(inputs.scene_pool(seed, 10 + i, t["pool"], t["bands"][s], t["size"]))
             for i, s in enumerate(t["sensors"])}
    steps = cell.check["steps"]
    ref = train.reference_steps(cell, seed, weights, pools, device, steps)
    out = {}
    for label, kw in (("control", CONTROL[m["dtype"]]),
                      ("half_batch", {"loss_rows": t["batch"] // 2})):
        got = train.reference_steps(cell, seed, weights, pools, device, steps, **kw)
        seen = {"losses": got["losses"],
                "grads": [[g[n] for n in names] for g in got["grads"]],
                "change": [got["change"][n] for n in names]}
        for k, (v, _) in train.compare(cell, names, seen, ref).items():
            out[f"{label}_{k}"] = v
        print(f"{label} seed {seed}:", train.describe(names, seen, ref), file=sys.stderr)
    return out


def main(argv=None) -> int:
    import torch

    from portbench import spec

    parser = argparse.ArgumentParser(prog="python3 -m portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = spec.load(args.workload, ROOT)
    device = torch.device(args.device)
    read = serve_readings if cell.traffic["kind"] == "serve" else train_readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, **read(cell, seed, device),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
