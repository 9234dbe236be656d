"""The program's own spans (tmdiff_tpu_torch/utils/profiling.py) over the
traced window of one run of a cell:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> --record <0|1>

It runs the cell as `portbench.run --trace 1` does (the profiler over the
window) and, with `--record 1`, the program's span recorder on over the
same window, its spans kept on the record as `program_spans`. It prints one
JSON line: run.py's result line for `--trace 1` (its per-layer metrics,
breakdown and check), then `program`: the readers of PROGRAM_METRICS on
those spans; `idle_by_span`: the device's idle seconds in the window by
the innermost program span open at each gap's midpoint (LABELS, then the
harness's own spans as "harness:<name>"; breakdown's rule and its top 10);
`built_in_window`: the `conv3d.plan` and `step.capture` spans that began
in the window, where none is expected; `host_ms`: each span name's count
and mean host ms over its spans inside the window; and `spans`, how many
were kept.
With `--record 0` the program records nothing and the line has no
`program` readings: the pair, on one seed, gives the recorder's cost.

The helpers above `run_cell` are what the readers of those metrics
(portbench/metrics/) use; a record without `program_spans` (a run of
portbench.run) gives each of them nothing to read."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from portbench import run, spec, trace  # noqa: E402

PROGRAM_METRICS = {
    "serve": ["engine.queue_wait_ms.serve", "engine.collect_ms.serve",
              "sample.launch_ms.serve", "device.idle_host.serve"],
    "train": ["feed.source_wait_ms.train", "feed.stage_ms.train", "step.host_ms.train"],
}
# innermost first: a gap takes the first of these open at its midpoint (the
# spans of the thread that drives the device; engine.request and
# feed.produce run beside it)
LABELS = {
    "serve": ["conv3d.plan", "sample.denoise", "sample.h2d", "sample.encode", "sample.loop",
              "sample.d2h", "engine.wait", "engine.collect", "engine.assemble",
              "engine.sample", "engine.resolve"],
    "train": ["conv3d.plan", "feed.source", "feed.stage", "feed.handoff", "step.copy_in",
              "step.begin", "step.replay", "step.capture", "step.end"],
}
BUILT = ("conv3d.plan", "step.capture")


def program_spans(record):
    """The program's spans of the run (profiling.Span), or None where the
    run kept none."""
    return getattr(record, "program_spans", None)


def named(record, name: str) -> list:
    return [s for s in program_spans(record) or () if s.name == name]


def inside(record, name: str) -> list:
    """The spans `name` that began and ended in the window."""
    return [s for s in named(record, name) if s.start >= record.start and s.end <= record.end]


def batches_inside(record) -> dict:
    """{batch: its engine.sample span} of the sampler calls that began and
    ended in the window."""
    return {s.attrs["batch"]: s for s in inside(record, "engine.sample")}


def ancestor(span, name: str, by_id: dict):
    """The nearest span `name` among `span`'s parents, or None."""
    while span.parent in by_id:
        span = by_id[span.parent]
        if span.name == name:
            return span
    return None


def busy_within(kernels, start: int, end: int, intervals) -> float:
    """Device seconds busy (the union of the traced operations) inside the
    disjoint (a, b) ns `intervals`, each cut to [start, end]."""
    a, b = kernels.merged(start, end)
    cum = np.concatenate([[0], np.cumsum(b - a)])

    def before(t):  # busy ns in [start, t]
        i = np.searchsorted(a, t, side="right")
        return cum[i] - np.maximum(b[i - 1] - t, 0) if i else 0

    total = 0
    for lo, hi in intervals:
        lo, hi = max(lo, start), min(hi, end)
        if hi > lo:
            total += before(hi) - before(lo)
    return float(total) / 1e9


def per_step_ms(record, names) -> float | None:
    """The summed host ms of the window's spans `names` over its steps."""
    if not record.steps or not program_spans(record):
        return None
    spans = [s for n in names for s in inside(record, n)]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / len(record.steps) / 1e6


def run_cell(cell, seed: int, seconds: float, device, record_spans: bool, traced: bool = True):
    """(Record, check, peak) of one run of the cell's driver with the
    profiler over the window where `traced`, and the program's recorder on
    over the same window where `record_spans` (its spans kept as
    `record.program_spans`)."""
    from tmdiff_tpu_torch.utils import profiling

    kept: list = []

    class RecordingTrace(trace.DeviceTrace):
        def __enter__(self):
            super().__enter__()
            if record_spans:
                profiling.drain()
                profiling.enable()
            return self

        def __exit__(self, *exc):
            if record_spans:
                profiling.disable()
                kept.extend(profiling.drain())
            return super().__exit__(*exc)

    driver = importlib.import_module(run.DRIVERS[cell.traffic["kind"]])
    driver.DeviceTrace = RecordingTrace
    try:
        record, check, peak = driver.run(cell, seed, seconds, traced, device, T_START)
    finally:
        driver.DeviceTrace = trace.DeviceTrace
    if record_spans:
        record.program_spans = kept
    return record, check, peak


def program_readings(cell, record) -> dict:
    """What the line adds to run.py's: see the module doc."""
    kind = cell.traffic["kind"]
    out = {"program": {}, "spans": len(program_spans(record) or ())}
    for name in PROGRAM_METRICS[kind]:
        value = cell.reader(name).read(record)
        if value is not None:
            out["program"][name] = float(value)
    if record.kernels is not None:
        held = trace.Spans()
        for s in program_spans(record) or ():
            held.add(s.name, s.start, s.end)
        labels = list(LABELS[kind])
        for name in run.HOST_SPANS[kind]:
            labels.append("harness:" + name)
            held.spans["harness:" + name] = record.spans.spans.get(name, [])
        out["idle_by_span"] = trace.breakdown(record.kernels, held, record.start, record.end,
                                              labels)["idle_gaps"]
    out["built_in_window"] = {n: sum(1 for s in named(record, n)
                                     if record.start <= s.start < record.end) for n in BUILT}
    durations = {}
    for s in program_spans(record) or ():
        if s.start >= record.start and s.end <= record.end:
            durations.setdefault(s.name, []).append(s.end - s.start)
    out["host_ms"] = {n: [len(v), sum(v) / len(v) / 1e6] for n, v in sorted(durations.items())}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(run.CACHE, sub)
    import torch

    cell = spec.load(args.workload, run.ROOT)
    if not torch.cuda.is_available():
        run.fail(f"{args.workload} needs a CUDA card")
    seed = abs(args.seed)
    record, check, peak = run_cell(cell, seed, args.seconds, torch.device("cuda", 0),
                                   bool(args.record))
    if cell.traffic["kind"] == "serve":
        attempted = len(record.requests)
        failed = sum(1 for r in record.requests if not r["ok"])
    else:
        attempted, failed = len(record.steps), record.failed
    out = run.result_line(cell, record, check, peak, True, failed, attempted,
                          torch.cuda.get_device_name(0))
    out.update(program_readings(cell, record))
    print(f"portbench.spans: {args.workload} seed {seed} record {args.record}: "
          f"{run.power_limit()}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
