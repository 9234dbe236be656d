"""One run of one benchmark cell:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's program (tmdiff_tpu_torch)
on the card, warms it up, measures for `--seconds`, checks what the timed
path produced against the plain reference, and prints one JSON line last on
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` a `breakdown`, and last `check`, each compared number
beside its limit (also the last lines on standard error).

Everything about a cell is data that BENCHMARK.json names (portbench/spec.py),
and the model is the family its configuration names
(portbench/families/<family>.py, whose plain reference is
portbench/references/<family>.py); this file and the drivers it calls
(portbench/serve.py, portbench/train.py, by the mix's "kind") hold no cell
and no model. It exits non-zero and prints no result
without a CUDA card (or with fewer than the cell asks for), and if JAX,
flax or the JAX package `tmdiff_tpu` is loaded once the window has closed.
Build and kernel caches go to fixed directories inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# modules that must not be loaded in the process that prints the result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "tmdiff_tpu")
CACHE = os.path.join(ROOT, ".portbench_cache")
DRIVERS = {"serve": "portbench.serve", "train": "portbench.train"}
HOST_SPANS = {"serve": ["sample"], "train": ["step", "feed"]}


def forbidden_modules(modules=None) -> list:
    """The top-level names of `modules` (sys.modules' keys by default) that
    are in FORBIDDEN, whole names compared."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def result_line(cell, record, check: dict, peak: int, trace: bool, failed: int,
                attempted: int, device_name: str) -> dict:
    """The run's result, `check` last."""
    from portbench import trace as trace_lib

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.reported(kind):
        value = cell.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": cell.workload["chips"],
              "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for v, lim in check.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = record.kernels.busy_seconds(record.start, record.end)
        device["window_s"] = record.window_s
        out["breakdown"] = trace_lib.breakdown(
            record.kernels, record.spans, record.start, record.end,
            HOST_SPANS[cell.traffic["kind"]])
    out["check"] = {k: {"value": float(v), "limit": float(lim)} for k, (v, lim) in check.items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)

    from portbench import spec

    cell = spec.load(args.workload, ROOT)
    import torch

    chips = cell.workload["chips"]
    if chips != 1:
        fail(f"{args.workload} asks for {chips} cards; this harness runs a cell on one")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    card = power_limit()
    driver = __import__(DRIVERS[cell.traffic["kind"]], fromlist=["run"])
    seed = abs(args.seed)
    record, check, peak = driver.run(cell, seed, args.seconds, bool(args.trace),
                                     torch.device("cuda", 0), T_START)
    if cell.traffic["kind"] == "serve":
        attempted = len(record.requests)
        failed = sum(1 for r in record.requests if not r["ok"])
    else:
        attempted, failed = len(record.steps), record.failed
    out = result_line(cell, record, check, peak, bool(args.trace), failed, attempted,
                      torch.cuda.get_device_name(0))
    found = forbidden_modules()
    if found:
        fail(f"loaded in the process that measured: {', '.join(found)}", 4)
    print(f"portbench: {args.workload} seed {seed}: {card}; set-up {record.setup_s:.3f} s",
          file=sys.stderr)
    for name, c in out["check"].items():
        ok = c["value"] <= c["limit"] and not math.isnan(c["value"])
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
