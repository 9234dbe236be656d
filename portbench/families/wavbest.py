"""The WavBEST family (TMDiff, IEEE TGRS 2024): every line of the harness
that knows this architecture. A configuration names it by "family":
"wavbest" in its "model" object, and `spec.Cell.family` loads this file by
that name; its plain reference is `portbench/references/wavbest.py`.

The drivers (`serve.py`, `train.py`, `control.py`, `counts.py`) call:

* `weight_spec(model)`: the weights' spec for `inputs.make_weights`;
* `build(model, weights, device)`: the port's model in the configuration's
  dtype with those weights loaded, which the drivers wrap in the port's
  Pansharpener, InferenceEngine and Trainer;
* `request_extra(traffic, seed, index)` / `batch_extra(traffic, seed,
  step)`: what serve request `index` or training step `step` carries beyond
  PAN, MS and the sensor prompt, drawn from the seed (numpy values; the
  reference gets them stacked per key over a block's rows);
* `submit(engine, pan, ms, sensor, extra)` / `train_call(step, state,
  batch, prompt, extra)`: the program's call for a request or a step;
* `reference(weights, model, precision, counter)`: the plain reference on
  the same weights (serving, the controls and the work counts);
* `reference_train(weights, model, batches, seed, train_cfg, sab,
  loss_rows)`: the reference's training steps from them.

WavBEST's requests and batches carry nothing beyond PAN, MS and the prompt.
"""
from __future__ import annotations

from portbench import spec
from portbench.reference import train_steps

REF = spec.reference_of(__file__)


def weight_spec(model: dict) -> list:
    """[(name, shape, fan_in, bias base or None)] of every parameter, in the
    program's layout."""
    return REF.param_spec(model["channel_multiplier"], model["embed_dim"], model["inter_dim"])


def build(model: dict, weights: dict, device):
    """The port's WavBEST in the configuration's dtype, `weights` loaded
    (strict)."""
    import torch
    from tmdiff_tpu_torch.models.wavbest import WavBEST

    net = WavBEST(tuple(model["channel_multiplier"]), model["embed_dim"], model["inter_dim"],
                  device=device, dtype=getattr(torch, model["dtype"]))
    net.load_state_dict(weights, strict=True)
    return net


def request_extra(traffic: dict, seed: int, index: int) -> dict:
    return {}


def submit(engine, pan, ms, sensor: str, extra: dict):
    return engine.submit(pan, ms, sensor)


def batch_extra(traffic: dict, seed: int, step: int) -> dict:
    return {}


def train_call(step, state, batch, prompt, extra: dict):
    return step(state, batch, prompt)


def reference(weights: dict, model: dict, precision: str = "fp32", counter=None):
    """The plain reference on `weights` (name -> tensor, the program's
    layout); `counter` as `REF.WavBEST` takes it."""
    params = {n: REF.to_reference_layout(n, w) for n, w in weights.items()}
    return REF.WavBEST(params, model["inter_dim"], precision, counter)


def reference_train(weights: dict, model: dict, batches: list, seed: int, train_cfg: dict, sab,
                    loss_rows=None) -> dict:
    """`train_steps` (portbench/reference.py) from `weights` (the program's
    layout), its parameters handed back in the program's layout."""
    leaves = {n: REF.to_reference_layout(n, t).detach().clone().requires_grad_(True)
              for n, t in weights.items()}
    out = train_steps(REF.WavBEST(leaves, model["inter_dim"]), leaves, batches, seed,
                      train_cfg, sab, loss_rows)
    out["params"] = {n: REF.to_program_layout(n, p) for n, p in out["params"].items()}
    return out
