"""A serve mix: the program's InferenceEngine in process, driven by an open
loop of requests due on a schedule drawn from the seed, then the served
images held against the plain reference. What knows the model is the
cell's family (`portbench/families/<family>.py`): its weights' spec, its
model, what a request carries beyond PAN, MS and the sensor, the engine
call that hands a request over, and its plain reference. The rest (the
clock, the open loop, the window, the trace, the comparison) is this
file's and the mix's data.

Set-up builds the family's model in the configuration's dtype with the
harness's weights, hands the Pansharpener the harness's prompt table, starts
the engine with the mix's recipe and warms its buckets at the mix's one
image shape (the engine's own warm-up: each bucket, in turn, through
`submit`). The window then submits each request at its due time, whether
or not earlier ones have finished; the engine's worker batches and runs
them. After the window every request due in it is awaited (a minute at
most), the peak memory is read, the program is freed, and a sample of the
served images, drawn from the seed, is computed again by the reference from
the same inputs (the request's extras with them) and each request's
placement (its batch's seed, bucket and row)."""
from __future__ import annotations

import gc
import sys
import time

import numpy as np

from portbench import inputs, reference
from portbench.record import Record
from portbench.trace import DeviceTrace, now_ns

DRAIN_S = 60.0


class SpannedSharp:
    """The object the engine samples with: the Pansharpener, each call's
    host span and bucket recorded. `alter` (the harness's fault tests)
    changes what a call returns."""

    def __init__(self, sharp, alter=None):
        self.sharp = sharp
        self.batches: list = []
        self.alter = alter

    def sample(self, batch, **kw):
        start = now_ns()
        out = self.sharp.sample(batch, **kw)
        self.batches.append({"start": start, "end": now_ns(), "bucket": len(out)})
        return out if self.alter is None else self.alter(out)


def build(cell, seed: int, device):
    """(sharp, weights, pool) of the cell: the program at the
    configuration, on the harness's weights and prompt table."""
    import torch
    from tmdiff_tpu_torch.pipeline import Pansharpener

    family, m, t = cell.family, cell.config["model"], cell.traffic
    # as the server sets it: bf16 products accumulate in fp32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    weights = inputs.make_weights(family.weight_spec(m), seed, device)
    sharp = Pansharpener(family.build(m, weights, device), schedule_name=m["schedule"],
                         n_timestep=m["n_timestep"], device=device)
    sensors = sorted(sharp.prompt_index, key=sharp.prompt_index.get)
    sharp.prompt_table.copy_(torch.as_tensor(inputs.prompt_table(sensors)))
    pool = inputs.scene_pool(seed, t["bands"], t["pool"], t["bands"], t["size"])
    return sharp, weights, pool


def start(cell, seed: int, device, alter=None):
    """(engine, spanned sampler, weights, pool): the program built and its
    buckets warmed at the mix's image shape."""
    from tmdiff_tpu_torch.serve.engine import InferenceEngine

    t, e = cell.traffic, cell.traffic["engine"]
    sharp, weights, pool = build(cell, seed, device)
    spanned = SpannedSharp(sharp, alter)
    engine = InferenceEngine(spanned, method=e["method"], steps=e["steps"],
                             max_batch=e["max_batch"], max_delay_ms=e["max_delay_ms"],
                             max_queue=e["max_queue"], sampler_kw=e.get("sampler_kw"))
    try:
        engine.warmup([(t["bands"], t["size"], t["size"])], sensor=next(iter(t["sensors"])))
    except BaseException:
        engine.shutdown()
        raise
    return engine, spanned, weights, pool


def schedule(cell, seconds: float, seed: int, traffic=None) -> list:
    """[(due seconds, sensor, pool index, extra)] of one run of the cell's
    mix (or of `traffic` in its place): inputs.serve_requests, and what
    each request carries beyond PAN, MS and the sensor from the family."""
    t = cell.traffic if traffic is None else traffic
    return [(due, sensor, scene, cell.family.request_extra(t, seed, i))
            for i, (due, sensor, scene) in enumerate(inputs.serve_requests(t, seconds, seed))]


def window(engine, pool, requests: list, seconds: float, record: Record, trace: bool) -> list:
    """Submits each request of `requests` (`schedule`) through the family's
    engine call at its due time from now, whether or not earlier ones have
    finished, then awaits every one (DRAIN_S past the window's close at
    most). Fills the record's window, requests, engine counters and device
    trace; returns the requests."""
    from tmdiff_tpu_torch.serve.engine import EngineOverloaded

    submit = record.cell.family.submit
    before = {k: engine.stats[k] for k in ("requests", "batches", "padded_slots")}
    reqs = []
    with DeviceTrace(trace) as dt:
        record.start = now_ns()
        start = time.perf_counter()
        for due, sensor, idx, extra in requests:
            wait = start + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            r = {"due": record.start + int(due * 1e9), "done": None, "ok": False,
                 "sensor": sensor, "scene": idx, "extra": extra, "future": None}
            try:
                fut = submit(engine, pool["pan"][idx], pool["lms"][idx], sensor, extra)
            except EngineOverloaded:
                fut = None
            if fut is not None:
                r["future"] = fut
                fut.add_done_callback(lambda f, r=r: r.update(done=now_ns()))
            reqs.append(r)
        time.sleep(max(0.0, start + seconds - time.perf_counter()))
        record.end = record.start + int(seconds * 1e9)
        record.backlog = engine._queue.qsize()
        close = time.perf_counter()
        for r in reqs:
            if r["future"] is None:
                continue
            try:
                r["future"].result(timeout=max(0.0, close + DRAIN_S - time.perf_counter()))
                r["ok"] = r["done"] is not None
            except Exception:  # failed or late: counted as failed
                r["ok"] = False
    record.kernels = dt.kernels
    record.engine_delta = {k: engine.stats[k] - before[k] for k in before}
    record.requests = reqs
    return reqs


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        alter=None) -> tuple:
    """(Record, check, peak memory bytes) of one run: `check` maps each
    compared number to (value, limit)."""
    import torch

    engine, spanned, weights, pool = start(cell, seed, device, alter)
    try:
        if device.type == "cuda":
            torch.cuda.synchronize()
        record = Record(cell, time.perf_counter() - t_start)
        reqs = window(engine, pool, schedule(cell, seconds, seed), seconds, record, trace)
    finally:
        engine.shutdown()
    record.batches = spanned.batches
    for b in record.batches:
        record.spans.add("sample", b["start"], b["end"])
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    outputs = {i: (r["future"].result(), r["future"].placement)
               for i, r in enumerate(reqs) if r["ok"]}
    del engine, spanned
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check = compare(cell, seed, weights, pool, reqs, outputs, device)
    return record, check, peak


def compare(cell, seed: int, weights: dict, pool: dict, reqs: list, outputs: dict,
            device) -> dict:
    """{"image_gap": (worst relative gap, limit), "unanswered": (requests
    due in the window with no image, 0)}: a sample of the served images,
    drawn from the seed, against the reference computed from the same
    scene, sensor, seed, bucket and row. The number is the worst image's
    RMS gap to the reference, over the RMS of the reference's residual
    (its image minus the upsampled MS) taken over the whole sample."""
    limit = cell.check["limits"]["image_gap"]
    unanswered = (len(reqs) - len(outputs), 0)
    if not outputs:
        return {"image_gap": (float("inf"), limit), "unanswered": unanswered}
    keys = sorted(outputs)
    pick = np.random.default_rng([seed, 5]).permutation(len(keys))[:cell.check["sample"]]
    gaps = reference_gaps(cell, weights, pool, [reqs[keys[i]] for i in pick],
                          [outputs[keys[i]] for i in pick], device)
    print("images (RMS gap, RMS residual): " + ", ".join(f"({g:.4g}, {r:.4g})" for g, r in gaps),
          file=sys.stderr)
    return {"image_gap": (image_gap(gaps), limit), "unanswered": unanswered}


def image_gap(gaps: list) -> float:
    """The worst image's RMS gap over the sample's RMS residual, from each
    image's (RMS gap, RMS residual)."""
    residual = float(np.sqrt(np.mean([r ** 2 for _, r in gaps])))
    return max(g for g, _ in gaps) / residual


def reference_gaps(cell, weights, pool, reqs, outputs, device, block: int = 4) -> list:
    """Each image's (RMS gap to the reference, RMS of the reference's
    residual), the family's reference run in blocks of rows."""
    import torch

    m, t, e = cell.config["model"], cell.traffic, cell.traffic["engine"]
    kw = e.get("sampler_kw") or {}
    sab = reference.sqrt_alpha_bar(m["schedule"], m["n_timestep"], device)
    model = cell.family.reference(weights, m)
    gaps = []
    with reference.products(), torch.no_grad():
        for lo in range(0, len(reqs), block):
            rs, outs = reqs[lo:lo + block], outputs[lo:lo + block]
            x_T = []
            for _, place in outs:
                gen = torch.Generator(device=device).manual_seed(place["seed"])
                full = torch.randn((place["bucket"], t["bands"], t["size"], t["size"]),
                                   generator=gen, device=device)
                x_T.append(full[place["row"]])
            pan = inputs.as_tensor(np.stack([pool["pan"][r["scene"]] for r in rs]), device)
            ms = inputs.as_tensor(np.stack([pool["lms"][r["scene"]] for r in rs]), device)
            prompt = inputs.as_tensor(inputs.prompt_table([r["sensor"] for r in rs]), device)
            extra = inputs.stack([r["extra"] for r in rs])
            ref = reference.sample(model, sab, pan, ms, prompt, torch.stack(x_T),
                                   e["method"], e["steps"], kw.get("refresh_every", 2),
                                   kw.get("cache_level", 1), extra)
            for i, (img, _) in enumerate(outs):
                got = torch.as_tensor(img, device=device)
                gaps.append((float(torch.sqrt(torch.mean((got - ref[i]) ** 2))),
                             float(torch.sqrt(torch.mean((ref[i] - ms[i]) ** 2)))))
    return gaps
