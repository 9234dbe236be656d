"""Dynamic (CondConv / DyConv) convolutions (port of
tmdiff_tpu/ops/dynamic_conv.py; reference `core/dynamic_conv.py`).

A softmax-over-K gate (global average pool -> two bias-free projections ->
softmax at an annealed temperature) mixes K candidate kernels per sample.
The conv is linear in its weight, so the port does what the JAX module
does: K convs of the whole batch, one per candidate kernel, mixed by the
gate per sample, and the bias mixed the same way,

    conv(x_b, sum_k a_bk W_k) = sum_k a_bk conv(x_b, W_k),

not a grouped conv with per-sample aggregated kernels. The JAX module's
convs are XLA convs (no Pallas kernel), so these are PyTorch's
F.conv{1,2,3}d over the channels-last layout (ops/library_conv.py::conv_nd:
cuDNN on the card, fp32 with TF32 off, XLA's padding written out).

The temperature is a call argument; anneal it from the training loop with
`anneal_temperature` (the reference subtracts 3 per epoch from 34 down to 1).
Parameters carry the flax names (`attention.fc1`, `attention.fc2`, `kernels`
in the flax layout (K, *kernel_size, Cin / groups, Cout), `bias` (K, Cout)),
so utils/weights.py::from_flax fills them.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tmdiff_tpu_torch.ops.library_conv import conv_nd

class _KernelGate(nn.Module):
    """softmax(fc2(relu(fc1(gap(x)))) / temperature) over K kernels."""

    def __init__(self, cin: int, num_kernels: int, ratio: float = 0.25):
        super().__init__()
        hidden = num_kernels if cin == 3 else int(cin * ratio) + 1
        self.fc1 = nn.Linear(cin, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, num_kernels, bias=False)

    def forward(self, x, temperature: float = 1.0):
        pooled = x.mean(dim=tuple(range(1, x.dim() - 1)))
        h = self.fc2(F.relu(self.fc1(pooled)))
        return torch.softmax(h / temperature, dim=-1)


class DynamicConv(nn.Module):
    """Rank-agnostic dynamic conv: the length of `kernel_size` selects
    1-D/2-D/3-D. Input (B, *spatial, Cin) channels-last; returns (B,
    *spatial', Cout)."""

    def __init__(self, cin: int, features: int, kernel_size: Sequence[int],
                 num_kernels: int = 4, ratio: float = 0.25, stride: int = 1,
                 padding="SAME", use_bias: bool = True, feature_group_count: int = 1):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride, self.padding, self.groups = stride, padding, feature_group_count
        self.attention = _KernelGate(cin, num_kernels, ratio)
        shape = (num_kernels, *self.kernel_size, cin // feature_group_count, features)
        fan_in = math.prod(shape[1:-1])
        # lecun-normal, as the JAX module initialises `kernels`
        self.kernels = nn.Parameter(torch.randn(shape) / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(num_kernels, features)) if use_bias else None

    def forward(self, x, temperature: float = 1.0):
        gate = self.attention(x, temperature)  # (B, K)
        out = 0.0
        for k in range(self.kernels.shape[0]):
            y = conv_nd(x, self.kernels[k], self.stride, self.padding, self.groups)
            out = out + y * gate[:, k].to(y.dtype).reshape(-1, *[1] * (y.dim() - 1))
        if self.bias is not None:
            mixed = torch.einsum("bk,kf->bf", gate, self.bias)
            out = out + mixed.reshape(gate.shape[0], *[1] * (out.dim() - 2), -1).to(out.dtype)
        return out


class DynamicConv1d(DynamicConv):
    pass


class DynamicConv2d(DynamicConv):
    pass


class DynamicConv3d(DynamicConv):
    pass


def anneal_temperature(temperature: float, step_delta: int = 1, rate: float = 3.0,
                       floor: float = 1.0) -> float:
    """The reference's annealing: subtract 3 per epoch until 1."""
    return max(floor, temperature - rate * step_delta)
