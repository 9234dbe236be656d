"""Attention blocks (port of tmdiff_tpu/ops/attention.py), channels-last.

SD-style cross/self attention, the GEGLU feed-forward, BasicTransformerBlock,
SpatialTransformer and SpatialSelfAttention from the reference's
experimental stack, and the NCSN++ channel attention `AttnBlockpp`. No model
of the repository wires them in, here or upstream; the modules themselves
are the entry points.

Multi-head attention goes through `ops/cuda/flash_attention.py` when
`use_flash` is set (the default): the CUDA kernel on a CUDA tensor, its
plain version `attention_reference` on a CPU tensor; `use_flash=False` takes
the plain version everywhere. Submodule and parameter names follow the flax
modules, so `utils/weights.py::from_flax` fills them from a flax param tree:
flax Dense kernels (I, O) and 1x1 Conv kernels (1, 1, I, O) both become
nn.Linear weights (O, I); LayerNorm/GroupNorm `scale` becomes `weight`.
Dropout is active only in train mode, as flax's `train=True`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tmdiff_tpu_torch.ops.cuda.flash_attention import attention_reference, flash_attention

# flax's LayerNorm and GroupNorm default epsilon
_EPS = 1e-6


def _group_norm(norm: nn.GroupNorm, x):
    """A GroupNorm over channels-last (B, H, W, C)."""
    return norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when no context is given.
    Softmax in fp32."""

    def __init__(self, query_dim: int, context_dim: int | None = None, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0, use_flash: bool = True):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head, self.use_flash = heads, dim_head, use_flash
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, context=None):
        context = x if context is None else context

        def split(t):
            b, s, _ = t.shape
            return t.reshape(b, s, self.heads, self.dim_head).transpose(1, 2).contiguous()

        q, k, v = split(self.to_q(x)), split(self.to_k(context)), split(self.to_v(context))
        out = (flash_attention if self.use_flash else attention_reference)(q, k, v)
        b, h, s, d = out.shape
        out = out.transpose(1, 2).reshape(b, s, h * d)
        return self.dropout(self.to_out(out))


class GEGLU(nn.Module):
    def __init__(self, dim: int, features: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * features)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")  # jax.nn.gelu's default


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, glu: bool = True, dropout: float = 0.0):
        super().__init__()
        inner = dim * mult
        self.glu = glu
        if glu:
            self.geglu = GEGLU(dim, inner)
        else:
            self.lin_in = nn.Linear(dim, inner)
        self.dropout = nn.Dropout(dropout)
        self.lin_out = nn.Linear(inner, dim)

    def forward(self, x):
        h = self.geglu(x) if self.glu else F.gelu(self.lin_in(x), approximate="tanh")
        return self.lin_out(self.dropout(h))


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF, pre-LayerNorm residuals."""

    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float = 0.0,
                 context_dim: int | None = None, disable_self_attn: bool = False):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(dim, context_dim if disable_self_attn else None,
                                    heads, dim_head, dropout)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dropout)
        self.ff = FeedForward(dim, dropout=dropout)
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=_EPS)

    def forward(self, x, context=None):
        ctx1 = context if self.disable_self_attn else None
        x = self.attn1(self.norm1(x), ctx1) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Image transformer: GroupNorm -> 1x1 proj in -> blocks over the (h*w)
    tokens -> zero-init 1x1 proj out + residual. Channels-last (B, H, W, C).
    With `use_checkpoint`, a block's activations are recomputed in the
    backward pass; without a gradient it changes nothing."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, depth: int = 1,
                 dropout: float = 0.0, context_dim: int | None = None,
                 use_checkpoint: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.depth, self.use_checkpoint = depth, use_checkpoint
        self.norm = nn.GroupNorm(32, in_channels, eps=_EPS)
        self.proj_in = nn.Linear(in_channels, inner)
        for i in range(depth):
            self.add_module(f"block{i}", BasicTransformerBlock(inner, heads, dim_head, dropout,
                                                               context_dim))
        self.proj_out = nn.Linear(inner, in_channels)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x, context=None):
        b, h, w, c = x.shape
        x_in = x
        x = self.proj_in(_group_norm(self.norm, x)).reshape(b, h * w, -1)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.use_checkpoint and torch.is_grad_enabled() and x.requires_grad:
                x = checkpoint(block, x, context, use_reentrant=False)
            else:
                x = block(x, context)
        return self.proj_out(x.reshape(b, h, w, -1)) + x_in


class SpatialSelfAttention(nn.Module):
    """Single-head 1x1-projected spatial self-attention over the h*w
    positions, head dim = C. Channels-last (B, H, W, C)."""

    def __init__(self, in_channels: int, use_flash: bool = True):
        super().__init__()
        c = in_channels
        self.use_flash = use_flash
        self.norm = nn.GroupNorm(32, c, eps=_EPS)
        self.q, self.k, self.v, self.proj_out = (nn.Linear(c, c) for _ in range(4))

    def forward(self, x):
        b, h, w, c = x.shape
        hn = _group_norm(self.norm, x)
        q, k, v = (m(hn).reshape(b, 1, h * w, c) for m in (self.q, self.k, self.v))
        out = (flash_attention if self.use_flash else attention_reference)(q, k, v)
        return x + self.proj_out(out.reshape(b, h, w, c))


class ChannelSelfAttention(nn.Module):
    """NCSN++ `AttnBlockpp`: attention over the spatial positions with the
    channels as features, the NIN 1x1 projections as Linear layers. Input
    (B, H, W, C); optional skip rescale by 1/sqrt(2). Plain PyTorch: the JAX
    module computes it as an einsum softmax, not through the flash-attention
    kernel, and so does this port."""

    def __init__(self, channels: int, skip_rescale: bool = True):
        super().__init__()
        c = channels
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = nn.GroupNorm(min(c // 4, 32) or 1, c, eps=_EPS)
        self.NIN_0, self.NIN_1, self.NIN_2, self.NIN_3 = (nn.Linear(c, c) for _ in range(4))
        # flax's variance_scaling(1e-10, "fan_avg", "uniform"): near zero
        nn.init.uniform_(self.NIN_3.weight, -(3e-10 / c) ** 0.5, (3e-10 / c) ** 0.5)
        nn.init.zeros_(self.NIN_3.bias)

    def forward(self, x):
        b, h, w, c = x.shape
        hn = _group_norm(self.GroupNorm_0, x)
        q, k, v = self.NIN_0(hn), self.NIN_1(hn), self.NIN_2(hn)
        s = torch.einsum("bhwc,bijc->bhwij", q, k) * (c ** -0.5)
        s = torch.softmax(s.reshape(b, h, w, h * w), dim=-1).reshape(b, h, w, h, w)
        out = self.NIN_3(torch.einsum("bhwij,bijc->bhwc", s, v))
        if self.skip_rescale:
            return (x + out) / 2.0 ** 0.5
        return x + out
