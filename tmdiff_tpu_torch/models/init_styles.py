"""Post-construction weight re-initialisation styles (port of
tmdiff_tpu/models/init_styles.py, reference `networks.py:16-77`).

  * "normal":     N(0, 0.02) for every conv and Linear weight;
  * "kaiming":    kaiming-normal fan-in for Linear weights only; the convs
                  keep their weights (the reference matches 'Conv2d', so its
                  Conv3d layers keep their init);
  * "orthogonal": orthogonal (gain 1) for every conv and Linear weight, of
                  the weight flattened as the JAX kernel (prod(shape[:-1]),
                  Cout) - a Linear's (in, out);
  * "torch":      the reference's state after init_weights("kaiming"):
                  conv weights and conv biases U(+-1/sqrt(fan_in)) (torch's
                  Conv3d defaults, fan_in = k^3 Cin), Linear weights
                  kaiming-normal with zero bias, the style projections
                  included.

Under the first three styles biases are zero, except the style projections'
(the Linear beside a modulated conv, `utils/weights.py::_MODCONV_STYLE`),
which stay at 1, as the JAX package keeps them. Conv weights are
(kd, kh, kw, Cin, Cout), Linear weights torch's (out, in). Every draw comes
from the given generator on the CPU, in the order of `model.modules()`, and
is copied to the parameter's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tmdiff_tpu_torch.models.blocks import ModConv3d
from tmdiff_tpu_torch.utils.weights import _MODCONV_STYLE

STYLES = ("normal", "kaiming", "orthogonal", "torch")


def _style_linears(model: nn.Module) -> set[int]:
    """ids of the Linear layers that compute a modulated conv's style."""
    out = set()
    for parent in model.modules():
        for name, child in parent.named_children():
            if isinstance(child, ModConv3d) and name in _MODCONV_STYLE:
                out.add(id(getattr(parent, _MODCONV_STYLE[name]).dense))
    return out


def _orthogonal(shape, gen):
    flat = (int(np.prod(shape[:-1])), shape[-1])
    a = torch.randn(flat, generator=gen)
    q, r = torch.linalg.qr(a if flat[0] >= flat[1] else a.T)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if flat[0] < flat[1]:
        q = q.T
    return q.reshape(shape)


def _uniform(shape, bound, gen):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


@torch.no_grad()
def apply_init_style(model: nn.Module, init_type: str, generator: torch.Generator) -> nn.Module:
    """Re-initialise `model` in place in one of STYLES; returns it."""
    if init_type not in STYLES:
        raise NotImplementedError(init_type)
    styles = _style_linears(model)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            w = module.weight
            if init_type == "normal":
                new_w = torch.randn(w.shape, generator=generator) * 0.02
            elif init_type == "orthogonal":
                new_w = _orthogonal(tuple(w.shape[::-1]), generator).T
            else:  # kaiming and torch: kaiming-normal over fan_in = in
                new_w = torch.randn(w.shape, generator=generator) * math.sqrt(2.0 / w.shape[1])
            w.copy_(new_w)
            style_bias = init_type != "torch" and id(module) in styles
            module.bias.fill_(1.0 if style_bias else 0.0)
            continue
        w = getattr(module, "weight", None)
        if not isinstance(w, nn.Parameter) or w.dim() != 5:
            continue
        fan_in = int(np.prod(w.shape[:-1]))
        if init_type == "normal":
            w.copy_(torch.randn(w.shape, generator=generator) * 0.02)
        elif init_type == "orthogonal":
            w.copy_(_orthogonal(tuple(w.shape), generator))
        elif init_type == "torch":
            w.copy_(_uniform(w.shape, 1.0 / math.sqrt(fan_in), generator))
        bias = getattr(module, "bias", None)
        if bias is not None:
            if init_type == "torch":
                bias.copy_(_uniform(bias.shape, 1.0 / math.sqrt(fan_in), generator))
            else:
                bias.zero_()
    return model
