"""Everything a run feeds the program, made from `--seed`: the weights (on
the device, in a few large calls), the sensor-prompt table, the scene
pools, the open-loop arrival schedule of a serve mix and the batch order
of a training mix. One general generator reads every traffic file; a mix
is its parameters alone.

The scenes are the benchmark's copy of the synthetic PanCollection scene
(smooth material field, a 2x2 detail field shared across bands with per-band
gains, per-band noise; `tmdiff_tpu_torch/data/synthetic.py::make_scene`):
gt, the 4x-downsampled MS, its nearest-upsampled LMS and the PAN as the band
mean, all in [0, 1].
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from portbench.reference import PROMPT_DIM


def make_weights(spec: list, seed: int, device, bias_std: float = 0.02) -> dict:
    """name -> float32 tensor on `device`: every weight N(0, 1 / fan_in)
    (lecun normal, the model's own initialiser), every bias its base plus
    N(0, bias_std^2); one Gaussian draw for all of them from a generator on
    the device, then one scale and one shift."""
    sizes = [int(np.prod(shape)) for _, shape, _, _ in spec]
    counts = torch.tensor(sizes, device=device)
    scale = torch.tensor([bias_std if fan is None else fan ** -0.5 for _, _, fan, _ in spec],
                         device=device)
    shift = torch.tensor([0.0 if base is None else base for _, _, _, base in spec],
                         device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(int(counts.sum()), generator=gen, device=device)
    flat = flat * torch.repeat_interleave(scale, counts) + torch.repeat_interleave(shift, counts)
    out, off = {}, 0
    for (name, shape, _, _), n in zip(spec, sizes):
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def prompt_table(sensors) -> np.ndarray:
    """(len(sensors), 768) float32: one unit-RMS Gaussian row per sensor,
    seeded by the sha256 of its name (fixed across runs, as a frozen text
    embedding is)."""
    rows = []
    for s in sensors:
        seed = int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "little")
        v = np.random.default_rng(seed).standard_normal(PROMPT_DIM)
        rows.append(v / np.linalg.norm(v) * np.sqrt(PROMPT_DIM))
    return np.stack(rows).astype(np.float32)


def make_scene(rng: np.random.Generator, bands: int, size: int, scale: int = 4,
               noise: float = 0.015, detail: float = 0.08):
    """(gt, lms, pan): (bands, size, size), (bands, size, size), (1, size, size)."""
    base = rng.random((size // 8, size // 8))
    up = np.kron(base, np.ones((8, 8)))[:size, :size]
    det = np.kron(rng.standard_normal((size // 2, size // 2)), np.ones((2, 2)))[:size, :size]
    gains = 1.0 + 0.5 * np.cos(2.0 * np.pi * np.arange(bands) / max(bands, 1))
    gt = np.stack([np.clip(0.35 + 0.4 * up + detail * gains[b] * det
                           + noise * rng.standard_normal((size, size))
                           + 0.05 * b / max(bands - 1, 1), 0, 1) for b in range(bands)])
    pan = gt.mean(axis=0, keepdims=True)
    small = size // scale
    ms = gt.reshape(bands, small, scale, small, scale).mean(axis=(2, 4))
    lms = np.kron(ms, np.ones((scale, scale)))[:, :size, :size]
    return gt.astype(np.float32), lms.astype(np.float32), pan.astype(np.float32)


def scene_pool(seed: int, stream: int, n: int, bands: int, size: int) -> dict:
    """n scenes of one band count: {"gt", "lms", "pan"} stacked, float32."""
    rng = np.random.default_rng([seed, stream])
    gt, lms, pan = (np.stack(z) for z in zip(*(make_scene(rng, bands, size)
                                                for _ in range(n))))
    return {"gt": gt, "lms": lms, "pan": pan}


class Pool:
    """A training set in memory, as the trainer's batch iterators read one:
    `batch(idx)` gives {"Res": gt - lms, "PAN", "MS": lms}."""

    def __init__(self, scenes: dict):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes["gt"])

    def batch(self, idx) -> dict:
        idx = np.asarray(idx, np.int64)
        gt, lms = self.scenes["gt"][idx], self.scenes["lms"][idx]
        return {"Res": gt - lms, "PAN": self.scenes["pan"][idx], "MS": lms}


# -- serve mixes -------------------------------------------------------------------


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds) of an open loop at `rate`: n = round(rate *
    seconds) gaps taken at the exponential distribution's (i + 1/2) / n
    quantiles (a Poisson process's gaps), scaled so that they end at
    `seconds`, in an order drawn from `seed` (a plain shuffle), so that
    every seed offers the same gaps and the same bursts come in another
    order."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    order = np.random.default_rng([seed, 1]).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(order)[:-1]])


def assign(weights: dict, n: int, seed: int, stream: int) -> list:
    """n draws of the keys of `weights` in the proportions of their weights
    (largest remainder), in an order drawn from `seed`."""
    keys = list(weights)
    w = np.array([weights[k] for k in keys], np.float64)
    exact = w / w.sum() * n
    count = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - count), kind="stable")[:n - count.sum()]:
        count[i] += 1
    seq = np.repeat(np.arange(len(keys)), count)
    return [keys[i] for i in np.random.default_rng([seed, stream]).permutation(seq)]


def serve_requests(traffic: dict, seconds: float, seed: int) -> list:
    """[(due seconds, sensor, pool index)] of one run of a serve mix."""
    due = arrivals(traffic["rate_per_s"], seconds, seed)
    sensors = assign(traffic["sensors"], len(due), seed, 2)
    rng = np.random.default_rng([seed, 3])
    scenes = rng.integers(0, traffic["pool"], len(due))
    return [(float(d), s, int(i)) for d, s, i in zip(due, sensors, scenes)]


# -- train mixes ---------------------------------------------------------------------


class BlockDraw:
    """The sensor draw of a training mix: blocks of `block` (a list of
    sensor names, repeated in the published ratio), each in an order drawn
    from `seed`. `choice` has the signature of numpy's Generator.choice as
    the trainer's sensor mixer calls it, over `sensors` (the mixer's order)."""

    def __init__(self, sensors: list, block: list, seed: int):
        self.sensors = list(sensors)
        self.block = list(block)
        self.seed = seed
        self.drawn = 0
        self._queue: list = []

    def next_sensor(self) -> str:
        if not self._queue:
            k = self.drawn // len(self.block)
            self._queue = list(np.random.default_rng([self.seed, 4, k]).permutation(self.block))
        self.drawn += 1
        return self._queue.pop(0)

    def choice(self, n, p=None):
        if n != len(self.sensors):
            raise ValueError(f"drawing over {n} sensors, the block names {self.sensors}")
        return self.sensors.index(self.next_sensor())

    def probabilities(self) -> np.ndarray:
        return np.array([self.block.count(s) for s in self.sensors], np.float64) / len(self.block)


def batch_order(n: int, batch: int, seed: int, steps: int) -> list:
    """The rows of a shuffled epoch cycler's first `steps` batches (a fresh
    permutation of range(n) whenever an epoch runs out, drawn from
    default_rng(seed)): the benchmark's own account of what the trainer's
    batch iterator hands out."""
    rng = np.random.default_rng(seed)
    order, pos, out = np.arange(n), n, []
    for _ in range(steps):
        if pos + batch > n:
            rng.shuffle(order)
            pos = 0
        out.append(order[pos:pos + batch].copy())
        pos += batch
    return out


def train_batches(traffic: dict, pools: dict, seed: int, steps: int) -> list:
    """[(sensor, batch dict)] of a training mix's first `steps` steps, as
    the benchmark works them out: the block draw, then each sensor's own
    epoch cycler."""
    draw = BlockDraw(list(traffic["sensors"]), traffic["block"], seed)
    sensors = [draw.next_sensor() for _ in range(steps)]
    rows = {s: iter(batch_order(len(pools[s]), traffic["batch"], seed, steps))
            for s in traffic["sensors"]}
    return [(s, pools[s].batch(next(rows[s]))) for s in sensors]


def as_tensor(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)



def stack(extras: list) -> dict:
    """What several requests carry beyond PAN, MS and the prompt (their
    family's `request_extra`), stacked per key over them as rows."""
    return {k: np.stack([e[k] for e in extras]) for k in (extras[0] if extras else ())}
