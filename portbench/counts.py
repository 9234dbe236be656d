"""Operations and bytes of the benchmarked work, counted on the plain
reference of the cell's model family (`family.reference`, over the shared
samplers of portbench/reference.py) at a cell's shapes, on the meta
device: no arithmetic runs and nothing of the program is read, so the
counts are the same whatever implements the work.

* Model FLOPs: what torch.utils.flop_counter counts over the reference
  (convolutions, their input and weight gradients, matrix products and
  Linear layers); elementwise work is not counted.
* K1 work: each SAME 3x3x3 convolution, 2 B Cin Cout (3D - 2)(3H - 2)(3W - 2)
  operations: only the taps that land inside the input (an axis of n
  positions meets 3n - 2 of the 3n taps; the zero-padded ones are not
  work), and its bytes at the cell's element size: the input, the kernel,
  the per-sample style and the bias read once, the output written once.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs, reference

META = torch.device("meta")


def valid_taps(n: int) -> int:
    """The taps of a 3-wide SAME window over n positions that land inside
    them: 3n less one at each edge."""
    return 3 * n - 2


class ConvWork:
    """The counter the reference calls for every conv and Linear: sums the
    SAME 3x3x3 convs' operations (valid taps only) and bytes at
    `elem_bytes` an element."""

    def __init__(self, elem_bytes: int):
        self.elem_bytes = elem_bytes
        self.flops = 0
        self.bytes = 0
        self.convs = 0

    def __call__(self, kind, x, w, style=False, bias=False):
        if kind != "conv3":
            return
        b, cin, d, h, wd = x.shape
        cout = w.shape[0]
        self.convs += 1
        self.flops += 2 * b * cin * cout * valid_taps(d) * valid_taps(h) * valid_taps(wd)
        elems = x.numel() + w.numel() + b * d * h * wd * cout
        elems += b * cin * style + cout * bias
        self.bytes += elems * self.elem_bytes


def meta_weights(spec, grad: bool = False) -> dict:
    """name -> an empty tensor of each weight of `spec` (the program's
    layout) on the meta device."""
    return {n: torch.empty(s, device=META, requires_grad=grad) for n, s, _, _ in spec}


def serve_batch(family, cfg: dict, traffic: dict, bucket: int, elem_bytes: int) -> dict:
    """{"model_flops", "k1_flops", "k1_bytes", "k1_convs"} of one served
    batch of `bucket` rows of the mix's bands and size (padded rows
    included: the device computes them): the condition encoded once, then
    the sampler's denoise calls."""
    work = ConvWork(elem_bytes)
    model = family.reference(meta_weights(family.weight_spec(cfg)), cfg, counter=work)
    bands, size, engine = traffic["bands"], traffic["size"], traffic["engine"]
    sab = torch.empty(cfg["n_timestep"] + 1, device=META)
    pan = torch.empty(bucket, 1, size, size, device=META)
    ms = torch.empty(bucket, bands, size, size, device=META)
    prompt = torch.empty(bucket, reference.PROMPT_DIM, device=META)
    # what the rows carry beyond PAN, MS and the prompt: drawn at seed 0, since the
    # work depends on their shapes alone
    extra = inputs.stack([family.request_extra(traffic, 0, i) for i in range(bucket)])
    kw = engine.get("sampler_kw") or {}
    with FlopCounterMode(display=False) as fc:
        reference.sample(model, sab, pan, ms, prompt, torch.empty_like(ms), engine["method"],
                         engine["steps"], kw.get("refresh_every", 2), kw.get("cache_level", 1),
                         extra)
    return {"model_flops": fc.get_total_flops(), "k1_flops": work.flops,
            "k1_bytes": work.bytes, "k1_convs": work.convs}


def train_step(family, cfg: dict, traffic: dict, bands: int, elem_bytes: int) -> dict:
    """{"model_flops", "k1_flops", "k1_bytes", "k1_convs"} of one training
    step of the mix's batch and size on `bands`-band images: the forward,
    the input and weight gradients (no recompute) for the model FLOPs; for
    K1 each SAME 3x3x3 conv's forward and its input gradient (the same
    operations and bytes), counted once each."""
    work = ConvWork(elem_bytes)
    model = family.reference(meta_weights(family.weight_spec(cfg), grad=True), cfg,
                             counter=work)
    batch, size = traffic["batch"], traffic["size"]
    res = torch.empty(batch, bands, size, size, device=META)
    t = torch.ones(batch, dtype=torch.long, device=META)
    with FlopCounterMode(display=False) as fc:
        cond = model.encode(torch.empty(batch, 1, size, size, device=META), res,
                            torch.empty(batch, reference.PROMPT_DIM, device=META),
                            **family.batch_extra(traffic, 0, 0))
        pred, _ = model.denoise(res, t, cond)
        torch.mean(torch.abs(res - pred)).backward()
    return {"model_flops": fc.get_total_flops(), "k1_flops": 2 * work.flops,
            "k1_bytes": 2 * work.bytes, "k1_convs": 2 * work.convs}
