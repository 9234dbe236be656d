"""The ControlNet family: the UniControl ControlNet (arXiv:2302.05543,
arXiv:2305.11147) over TMDiff's legacy UNet, as the port's
`models/controlnet.py::ControlledLegacyUNet` serves it. Every line of the
harness that knows this architecture; a configuration names it by
"family": "controlnet" in its "model" object, and its plain reference is
`portbench/references/controlnet.py`. The harness calls it as WavBEST's
(`portbench/families/wavbest.py`'s doc).

A request carries, beyond PAN, MS and the sensor prompt, a control map
`hint` (size, size, hint channels), uniform in [0, 1) from the seed, and a
`task`, the id of one of the 13 UniControl tasks drawn uniformly from the
seed; the program gets the task's name (`engine.submit(..., hint=,
task=)`), the reference the ids. Training is not this family's: a
configuration of it serves only.

`libconv_work(cfg, traffic, bucket, elem_bytes)` counts the library convs'
work of one served batch (the strided, transposed and hint convs, which
run on cuDNN) for `metrics/libconv_roofline.serve.py`, as
`portbench/counts.py` counts K1's.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import inputs, spec
from portbench import reference as shared

REF = spec.reference_of(__file__)
LIBRARY_KINDS = ("strided", "transposed", "hint")


def weight_spec(model: dict) -> list:
    """[(name, shape, fan_in, bias base or None)] of every weight, the zero
    convs (drawn as any 1x1x1 conv: not zero) and the task table
    included, in the program's layout."""
    return REF.param_spec(model["channel_multiplier"], model["embed_dim"], model["inter_dim"],
                          model["hint_channels"], model["tasks"])


def build(model: dict, weights: dict, device):
    """The port's ControlledLegacyUNet in the configuration's dtype with
    `weights` loaded (strict: the task table too)."""
    from tmdiff_tpu_torch.models.controlnet import ControlledLegacyUNet

    net = ControlledLegacyUNet(tuple(model["channel_multiplier"]), model["hint_channels"],
                               model["embed_dim"], model["inter_dim"],
                               only_mid_control=model["only_mid_control"],
                               control_scales=tuple(model["control_scales"]), device=device,
                               dtype=getattr(torch, model["dtype"]))
    net.load_state_dict(weights, strict=True)
    return net


def request_extra(traffic: dict, seed: int, index: int) -> dict:
    """Request `index`'s hint (size, size, hint channels) and task id."""
    rng = np.random.default_rng([seed, 7, index])
    size, channels = traffic["size"], traffic["hint_channels"]
    return {"hint": rng.random((size, size, channels), dtype=np.float32),
            "task": np.int64(rng.integers(0, traffic["tasks"]))}


def submit(engine, pan, ms, sensor: str, extra: dict):
    names = {i: name for name, i in engine.task_index.items()}
    return engine.submit(pan, ms, sensor, hint=extra["hint"], task=names[int(extra["task"])])


def batch_extra(traffic: dict, seed: int, step: int) -> dict:
    raise ValueError("the controlnet family serves only: a configuration of it has no "
                     "training mix")


def train_call(step, state, batch, prompt, extra: dict):
    raise ValueError("the controlnet family serves only")


def reference(weights: dict, model: dict, precision: str = "fp32", counter=None):
    """The plain reference on `weights` (name -> tensor, the program's
    layout); `counter` as `REF.ControlledLegacyUNet` takes it."""
    params = {n: REF.to_reference_layout(n, w) for n, w in weights.items()}
    return REF.ControlledLegacyUNet(params, model["inter_dim"], precision, counter,
                                    model["control_scales"], model["only_mid_control"])


def reference_train(weights, model, batches, seed, train_cfg, sab, loss_rows=None):
    raise ValueError("the controlnet family serves only")


# -- the library convs' work ---------------------------------------------------------


def valid_taps(n: int, k: int, stride: int = 1, pad: int = 0) -> int:
    """The (output position, tap) pairs of a k-wide window at `stride` over
    n inputs padded by `pad` on each side whose tap lands on an input: the
    zero-padded taps are not work."""
    out = (n + 2 * pad - k) // stride + 1
    return sum(1 for o in range(out) for j in range(k) if 0 <= o * stride - pad + j < n)


def transposed_taps(n: int, k: int, stride: int, pad: int, out_pad: int) -> int:
    """The (input, tap) pairs of a transposed conv over n inputs whose
    output position lands inside the output kept (size (n - 1) stride -
    2 pad + k + out_pad): each input meets each tap once."""
    size = (n - 1) * stride - 2 * pad + k + out_pad
    return sum(1 for i in range(n) for j in range(k) if 0 <= i * stride - pad + j < size)


class LibConvWork:
    """The counter the reference calls for every conv and Linear: sums the
    strided, transposed and hint convs' operations, 2 B Cin Cout over the
    taps that meet the input (per axis: `valid_taps`, `transposed_taps`),
    and bytes at `elem_bytes` an element (the input, the kernel and the
    bias read once, the output written once)."""

    def __init__(self, elem_bytes: int):
        self.elem_bytes = elem_bytes
        self.flops = 0
        self.bytes = 0
        self.convs = 0

    def __call__(self, kind, x, w, style=False, bias=False):
        if kind not in LIBRARY_KINDS:
            return
        b, cin, d, h, wd = x.shape
        if kind == "transposed":  # (Cin, Cout, 3, 3, 3): depth SAME, space stride 2
            cout = w.shape[1]
            taps = (valid_taps(d, 3, 1, 1) * transposed_taps(h, 3, 2, 0, 1)
                    * transposed_taps(wd, 3, 2, 0, 1))
            out = (d, 2 * h + 2, 2 * wd + 2)
        elif kind == "strided":  # SAME over the bands, VALID stride 2 in space
            cout = w.shape[0]
            taps = valid_taps(d, 3, 1, 1) * valid_taps(h, 3, 2) * valid_taps(wd, 3, 2)
            out = (d, (h - 1) // 2, (wd - 1) // 2)
        else:  # hint: (1, 3, 3) SAME
            cout = w.shape[0]
            taps = valid_taps(h, 3, 1, 1) * valid_taps(wd, 3, 1, 1) * d
            out = (d, h, wd)
        self.convs += 1
        self.flops += 2 * b * cin * cout * taps
        elems = x.numel() + w.numel() + cout + b * cout * int(np.prod(out))
        self.bytes += elems * self.elem_bytes


def libconv_work(cfg: dict, traffic: dict, bucket: int, elem_bytes: int) -> dict:
    """{"libconv_flops", "libconv_bytes", "libconv_convs"} of one served
    batch of `bucket` rows (padded rows included: the device computes
    them): the condition encoded once, then the sampler's denoise calls,
    on the reference on the meta device."""
    meta = torch.device("meta")
    work = LibConvWork(elem_bytes)
    params = {n: torch.empty(s, device=meta) for n, s, _, _ in weight_spec(cfg)}
    model = reference(params, cfg, counter=work)
    bands, size, engine = traffic["bands"], traffic["size"], traffic["engine"]
    pan = torch.empty(bucket, 1, size, size, device=meta)
    ms = torch.empty(bucket, bands, size, size, device=meta)
    prompt = torch.empty(bucket, shared.PROMPT_DIM, device=meta)
    extra = inputs.stack([request_extra(traffic, 0, i) for i in range(bucket)])
    shared.sample(model, torch.empty(cfg["n_timestep"] + 1, device=meta), pan, ms, prompt,
                  torch.empty_like(ms), engine["method"], engine["steps"], extra=extra)
    return {"libconv_flops": work.flops, "libconv_bytes": work.bytes,
            "libconv_convs": work.convs}
