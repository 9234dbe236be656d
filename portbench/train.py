"""A training mix: the CLI's training loop in process (SensorMixer's
per-step sensor over shuffled batch iterators, DeviceFeeder one step ahead,
`Trainer.compiled_step`), then its first steps held against the plain
reference. What knows the model is the cell's family
(`portbench/families/<family>.py`): its weights' spec, its model, what a
step carries beyond PAN, MS and the sensor prompt, the call that hands a
step over, and its plain reference; the feed, the clock, the window, the
optimiser's replay and the comparisons are this file's.

Set-up builds the family's model with the harness's weights, makes the trainer
with the configuration's optimiser and schedule, the scene pools of every
sensor and the feed, and runs the mix's first `warm_steps` steps through
the window's own call: each batch shape's first call runs its step and
captures it, a later call of that shape replays it. After each compared
step it reads that step's gradient of every parameter from AdamW's first
moment (m_k - beta1 m_(k-1)) / (1 - beta1), so the compared gradients come
from the eager half of a capturing call and from replays alike, and after
the last compared step each parameter's change, before a later step can
overwrite them. The window runs steps until its seconds have passed,
reading each step's loss one step late (so the host stays at most two
steps ahead, as a loop that logs its loss does) and ends with a
synchronize. After it, one more replayed step checks the EMA: each leaf's
change against (1 - decay) (parameter - EMA before), worked out in float64
from the program's own tensors (the EMA's change over the compared steps
lies below float32's resolution, so it cannot be held against the
reference there). Then the program is freed and the reference runs the
compared steps from the same weights, on batches it works out itself
from the seed."""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np

from portbench import inputs, reference
from portbench.record import Record
from portbench.trace import DeviceTrace, now_ns

BETA1 = 0.9


def build(cell, seed: int, device):
    """(trainer, state, weights, pools, prompts) of the cell."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.train.trainer import Trainer

    family, m, tc, t = cell.family, cell.config["model"], cell.config["train"], cell.traffic
    weights = inputs.make_weights(family.weight_spec(m), seed, device)
    model = family.build(m, weights, device)
    trainer = Trainer(model, NoiseSchedule.create(m["schedule"], m["n_timestep"]),
                      lr=tc["lr"], weight_decay=tc["weight_decay"],
                      warmup_steps=tc["warmup_steps"], max_iter=tc["max_iter"],
                      loss_type=tc["loss_type"], ema_decay=tc["ema_decay"],
                      grad_clip=tc["grad_clip"], remat=tc["remat"], seed=seed)
    state = trainer.init_state()
    pools = {s: inputs.Pool(inputs.scene_pool(seed, 10 + i, t["pool"], t["bands"][s], t["size"]))
             for i, s in enumerate(t["sensors"])}
    sensors = list(t["sensors"])
    prompts = dict(zip(sensors, inputs.as_tensor(inputs.prompt_table(sensors), device)))
    return trainer, state, weights, pools, prompts


def feed(cell, pools: dict, seed: int, device):
    """The CLI's feed: a SensorMixer over one shuffled BatchIterator a
    sensor, its draw in the mix's seeded blocks, through a DeviceFeeder.
    Yields (batch on the device, sensor)."""
    from tmdiff_tpu_torch.data.pipeline import BatchIterator, SensorMixer
    from tmdiff_tpu_torch.runtime.prefetch import DeviceFeeder

    t = cell.traffic
    iters = {s: BatchIterator(pools[s], batch_size=t["batch"], shuffle=True, seed=seed)
             for s in t["sensors"]}
    mixer = SensorMixer(iters, weights=t["sensors"], seed=seed)
    draw = inputs.BlockDraw(mixer.sensors, t["block"], seed)
    if not np.allclose(mixer.probs, draw.probabilities()):
        raise ValueError(f"the block {t['block']} does not hold the mixer's ratio "
                         f"{dict(zip(mixer.sensors, mixer.probs))}")
    mixer.rng = draw
    source = (({k: b[k] for k in ("Res", "PAN", "MS")}, s) for b, s in mixer)
    return DeviceFeeder(source, device=device, depth=t["feeder_depth"])


def leaf_norms(tensors) -> list:
    import torch

    return [float(n) for n in torch.stack(torch._foreach_norm(list(tensors))).cpu()]


def first_moments(optimizer, params) -> list:
    """A copy of AdamW's first moment of each of `params` (zeros before
    its first step)."""
    import torch

    st = optimizer.state
    return [st[p]["exp_avg"].clone() if "exp_avg" in st.get(p, {}) else torch.zeros_like(p)
            for p in params]


def ema_step(state, call, decay: float) -> tuple:
    """One more step, `call(state)` through the window's call; returns each
    EMA leaf's change and (1 - decay) (parameter after the step - EMA
    before), as per-leaf norms worked out in float64 from the program's own
    tensors."""
    before = [e.detach().clone() for e in state.ema_params]
    state, _ = call(state)
    got = leaf_norms(e.double() - b.double() for e, b in zip(state.ema_params, before))
    want = leaf_norms((1.0 - decay) * (p.detach().double() - b.double())
                      for p, b in zip(state.model.parameters(), before))
    return got, want


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault=None) -> tuple:
    """(Record, check, peak memory bytes) of one run. `fault` (the
    harness's fault tests) is called with the trainer before the first
    step and may break it."""
    import torch

    family, t = cell.family, cell.traffic
    trainer, state, weights, pools, prompts = build(cell, seed, device)
    if fault is not None:
        fault(trainer)
    names = [n for n, _ in trainer.model.named_parameters()]
    optimizer = state.optimizer
    feeder = feed(cell, pools, seed, device)
    step = trainer.compiled_step()
    n_check = cell.check["steps"]
    losses, seen = [], {"grads": []}
    moments = [torch.zeros_like(p) for p in trainer.model.parameters()]
    try:
        count = max(t["warm_steps"], n_check)  # steps run before the window
        for k in range(count):
            batch, sensor = next(feeder)
            state, metrics = family.train_call(step, state, batch, prompts[sensor],
                                               family.batch_extra(t, seed, k))
            if k < n_check:
                losses.append(metrics["l_pix"])
                now = first_moments(optimizer, trainer.model.parameters())
                seen["grads"].append(leaf_norms((m - BETA1 * m0) / (1.0 - BETA1)
                                                for m, m0 in zip(now, moments)))
                moments = now
            if k == n_check - 1:
                seen["change"] = leaf_norms(p.detach() - weights[n]
                                            for n, p in trainer.model.named_parameters())
                seen["ema_start"] = leaf_norms(state.ema_params)
        del moments
        seen["losses"] = [float(v) for v in losses]
        if device.type == "cuda":
            torch.cuda.synchronize()
        record = Record(cell, time.perf_counter() - t_start)
        with DeviceTrace(trace) as dt:
            record.start = now_ns()
            start, prev, bad = time.perf_counter(), None, 0
            while time.perf_counter() - start < seconds:
                f0 = now_ns()
                batch, sensor = next(feeder)
                record.spans.add("feed", f0, now_ns())
                extra = family.batch_extra(t, seed, count)
                count += 1
                s0 = now_ns()
                state, metrics = family.train_call(step, state, batch, prompts[sensor], extra)
                record.spans.add("step", s0, now_ns())
                record.steps.append(int(batch["MS"].shape[1]))
                if prev is not None:
                    bad += not math.isfinite(float(prev))
                prev = metrics["l_pix"]
            bad += not math.isfinite(float(prev))
            if device.type == "cuda":
                torch.cuda.synchronize()
            record.end = now_ns()
        record.kernels = dt.kernels
        record.failed = bad
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        batch, sensor = next(feeder)
        extra = family.batch_extra(t, seed, count)
        seen["ema"] = ema_step(
            state, lambda s: family.train_call(step, s, batch, prompts[sensor], extra),
            cell.config["train"]["ema_decay"])
    finally:
        feeder.close()
    trainer.release_compiled()
    del trainer, state, step, feeder, optimizer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(cell, seed, weights, pools, device, n_check)
    check = compare(cell, names, seen, ref)
    print(describe(names, seen, ref), file=sys.stderr)
    return record, check, peak


def reference_steps(cell, seed: int, weights: dict, pools: dict, device, steps: int,
                    loss_rows=None, allow_tf32: bool = False) -> dict:
    """The family's reference's losses, gradients, changes and EMA of
    `steps` steps from the harness's weights, on the batches the benchmark
    works out for the seed, each with what the family's `batch_extra` gives
    the program's step of that count; `allow_tf32` lets cuDNN and cuBLAS
    compute the fp32 products in TF32 (a control)."""
    import torch

    family, m, tc, t = cell.family, cell.config["model"], cell.config["train"], cell.traffic
    batches = []
    for k, (sensor, b) in enumerate(inputs.train_batches(t, pools, seed, steps)):
        prompt = inputs.as_tensor(inputs.prompt_table([sensor]), device)
        batches.append(tuple(inputs.as_tensor(b[key], device) for key in ("Res", "PAN", "MS"))
                       + (prompt.expand(len(b["Res"]), -1), family.batch_extra(t, seed, k)))
    sab = reference.sqrt_alpha_bar(m["schedule"], m["n_timestep"], device)
    with reference.products(allow_tf32):
        out = family.reference_train(weights, m, batches, seed, tc, sab, loss_rows)
    out["change"] = {n: float(torch.linalg.vector_norm(out["params"][n] - weights[n]))
                     for n in weights}
    del out["params"]
    return out


def leaf_gaps(got: list, want: list) -> np.ndarray:
    """Each leaf's |got - want| over the larger of want and the median
    leaf's want."""
    got_a, want_a = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got_a - want_a) / np.maximum(want_a, np.median(want_a))


def leaf_gap(got: list, want: list, keep=None) -> float:
    """The worst leaf's gap (leaf_gaps) over the leaves `keep` marks (all
    when None)."""
    gaps = leaf_gaps(got, want)
    return float(gaps.max() if keep is None else gaps[np.asarray(keep, bool)].max())


def describe(names: list, seen: dict, ref: dict) -> str:
    """The losses and the five worst leaves of each leaf gap, for the log;
    the EMA after the compared steps against the reference's (not compared:
    its change there lies below float32's resolution)."""
    out = [f"losses {seen['losses']} reference {ref['losses']}"]
    pairs = [(f"grads step {k}", got, [want[n] for n in names])
             for k, (got, want) in enumerate(zip(seen["grads"], ref["grads"]))]
    pairs.append(("change", seen["change"], [ref["change"][n] for n in names]))
    if "ema_start" in seen:
        pairs.append(("ema after the compared steps", seen["ema_start"],
                      [ref["ema"][n] for n in names]))
    if "ema" in seen:
        pairs.append(("ema change after the window", *seen["ema"]))
    for key, got, want in pairs:
        gaps = leaf_gaps(got, want)
        worst = np.argsort(-gaps)[:5]
        out.append(f"{key}: median leaf gap {float(np.median(gaps))!r}; worst "
                   + ", ".join(f"{names[i]} {gaps[i]:.3g} (norm {want[i]:.3g})" for i in worst))
    return "\n".join(out)


def compare(cell, names: list, seen: dict, ref: dict) -> dict:
    """{"loss_gap", "grad_gap", "change_gap", "ema_gap"}: each (value,
    limit). The loss gap is the worst step's |loss - reference| over the
    reference; the gradient gap the worst leaf's (leaf_gap) over the
    compared steps' gradients; the change gap the worst leaf's change after
    them. Leaves whose first reference gradient is under a thousandth of
    the median leaf's move under AdamW by round-off alone and are left out
    of the change. The EMA gap (where `seen` has the step after the
    window) is the worst leaf's gap of the EMA's change against
    (1 - decay) (parameter - EMA before)."""
    limits = cell.check["limits"]
    loss = max(abs(a - b) / abs(b) for a, b in zip(seen["losses"], ref["losses"]))
    want_g = [[want[n] for n in names] for want in ref["grads"]]
    keep = [g >= 1e-3 * float(np.median(want_g[0])) for g in want_g[0]]
    out = {"loss_gap": (loss, limits["loss_gap"]),
           "grad_gap": (max(leaf_gap(got, want) for got, want in zip(seen["grads"], want_g)),
                        limits["grad_gap"]),
           "change_gap": (leaf_gap(seen["change"], [ref["change"][n] for n in names], keep),
                          limits["change_gap"])}
    if "ema" in seen:
        out["ema_gap"] = (leaf_gap(*seen["ema"]), limits["ema_gap"])
    return out
