"""WavBEST building blocks (port of tmdiff_tpu/models/blocks.py).

Activations are (B, D, H, W, C) with the spectral bands as conv depth D.
Conv weights are kept in the JAX layout (kd, kh, kw, Cin, Cout); Linear
layers are torch's own (out, in). Module and parameter names follow the
reference torch classes, so a module's state_dict keys are the reference's
`sd.*` keys (utils/weights.py fills them):

  reference                     here
  AdaptionModulateBEST          AdaptionHead
  ResBlockModulateBEST          ResBlockModulate
  WaveletUPorDown               WaveletDown / WaveletUp
  ResblockDownOneModulateBEST   DownStage
  ResblockUpOneModulateBEST     UpStage
  FinalBlockModulateBEST        FinalBlock

The reference's two defined-but-unused blocks, ChannelWiseAttention and
AdaptiveGroupNorm, are here too, with the flax names (fc1/fc2, style).

A modulated conv's style Linear is a sibling of its conv in the reference
(`dense2` of a ResBlock's `conv21`, `dense1` of a wavelet block's `Conv_1`),
so it is one here too. The reference's dead parameters (the modulated convs'
biases, the wavelet blocks' `dense2`, the condition branch's time
projections) are not created. Decoder inputs may be tuples of channel parts;
they are convolved as their concat without materialising it.

Dropout (rate 0.2) sits at the JAX package's five sites: before a ResBlock's
conv20 (per part for a tuple input) and conv21, and before a wavelet block's
Conv_1. A block's `rng`, a torch.Generator on the activations' device, draws
the masks (train mode); None leaves dropout out (eval mode). Each part and
site draws its own mask from the generator in turn, so one generator state
gives the same masks again (the trainer's recompute relies on that).

Every block takes `dtype`, float32 (the default) or bfloat16, as the JAX
package's blocks do: parameters stay float32 and are cast at use, convs and
Linear layers run in `dtype` (a conv module casts its input to it, as the
JAX Conv3d does; a Linear adds its bias after the product, in `dtype`), and
the activations between them keep it, forward and backward (dropout divides
by its keep probability in `dtype`, as flax's Dropout does).

A SiLU before a conv, with the time embedding added before it
(`silu(h + temb)`), is the conv's pre-activation (`act_conv`): without
dropout the conv takes the shift and the activation as arguments and its
3x3x3 kernel applies them as it stages its operand where it can
(ops/modconv.py), so in bf16 serving neither h + temb nor its SiLU is
written out; with dropout between the SiLU and the conv (`rng` given) the
block computes them itself, as PyTorch ops.

Every conv module has a `plain` attribute: False sends its 3x3x3 convs to the
CUDA kernels on a CUDA tensor; True sends them to the kernels' plain versions
(see WavBEST.use_plain_conv). Its `impl` attribute picks the 3x3x3 lowering,
"banded" or "auto" (ops/modconv.py; see WavBEST.use_conv_impl). Its `mesh`
attribute, the placement of a sharded call (parallel/mesh.py; see
WavBEST.use_mesh) or None, makes its 3x3x3 convs exchange halo rows; the
blocks' dropout reads it from their convs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tmdiff_tpu_torch.ops import wavelet
from tmdiff_tpu_torch.ops.modconv import conv3d, conv3d_cat


def swish(x):
    return F.silu(x)


# The JAX package's dropout rate at every site (its blocks' `dropout` field).
DROPOUT = 0.2


def dropout(x, rate: float, rng, mesh=None):
    """Inverted dropout: each element kept with probability 1 - rate and
    divided by 1 - rate, the mask drawn from `rng`; identity when rng is
    None. The divisor is 1 - rate in x's dtype and the quotient is rounded
    once, as flax's Dropout computes `inputs / keep_prob` (its Python float
    takes x's dtype: 0.80078125 in bf16). On a sharded placement `mesh`
    (parallel/mesh.py) the mask is drawn at the global shape and this
    rank's shard of it is kept, so a meshed step draws the masks the
    unsharded step draws."""
    if rng is None or rate == 0.0:
        return x
    if mesh is None:
        keep = torch.rand(x.shape, generator=rng, device=x.device) >= rate
    else:
        keep = mesh.shard(torch.rand(mesh.global_shape(x.shape), generator=rng,
                                     device=x.device)) >= rate
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    return torch.where(keep, x / keep_prob, 0.0)


def act_conv(conv, x, shift, rng, *args):
    """conv(dropout(swish(x + shift)), *args): x a tensor or a tuple of
    channel parts, `shift` (B, C) over their concat or None. Without dropout
    (rng None) the shift and the SiLU go to the conv as its pre-activation;
    with it, they run here as PyTorch ops, each part drawing its own mask in
    turn."""
    if rng is None:
        return conv(x, *args, shift=shift, act="silu")
    parts = x if isinstance(x, tuple) else (x,)
    off, hs = 0, []
    for p in parts:
        if shift is not None:
            p = p + shift[:, None, None, None, off:off + p.shape[-1]]
        off += p.shape[-1]
        hs.append(dropout(swish(p), DROPOUT, rng, conv.mesh))
    return conv(tuple(hs) if isinstance(x, tuple) else hs[0], *args)


def dropout_rng(train: bool, rng):
    """A model call's dropout generator: `rng` in train mode (where it must
    be given), None in eval mode."""
    if not train:
        return None
    if rng is None:
        raise ValueError("train=True draws dropout masks from rng: pass a torch.Generator")
    return rng


def _lecun_normal(shape, fan_in):
    return nn.Parameter(torch.randn(shape) / math.sqrt(fan_in))


class Linear(nn.Linear):
    """nn.Linear run in `dtype`: in bfloat16 the input and the weight are
    cast to it and the bias (if any) is added after the product, in
    bfloat16, as a flax Dense of that dtype does; in float32 it is
    nn.Linear's forward on a float32 input."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32, bias: bool = True):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype == torch.float32:
            return super().forward(x.to(torch.float32))
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


def linear(cin: int, cout: int, bias_value: float = 0.0, dtype=torch.float32) -> Linear:
    """Linear with a lecun-normal weight and a constant bias, as the JAX
    package initialises its Dense layers (style projections start at 1)."""
    lin = Linear(cin, cout, dtype)
    with torch.no_grad():
        lin.weight.normal_(0.0, 1.0 / math.sqrt(cin))
        lin.bias.fill_(bias_value)
    return lin


class Dense(nn.Module):
    """The reference's Linear wrapper: the Linear sits at `.dense`."""

    def __init__(self, cin: int, cout: int, bias_value: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.dense = linear(cin, cout, bias_value, dtype)

    def forward(self, x):
        return self.dense(x)


class Conv3d(nn.Module):
    """Biased SAME 3-D conv in `dtype`; `x` may be a tuple of channel parts.
    `shift` and `act`: the input's pre-activation (ops/modconv.py)."""

    def __init__(self, cin: int, cout: int, k: int = 3, dtype=torch.float32):
        super().__init__()
        self.weight = _lecun_normal((k, k, k, cin, cout), k ** 3 * cin)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype
        self.plain = False
        self.impl = "banded"
        self.mesh = None

    def forward(self, x, shift=None, act=None):
        if isinstance(x, tuple):
            return conv3d_cat(tuple(p.to(self.dtype) for p in x), self.weight, bias=self.bias,
                              plain=self.plain, impl=self.impl, mesh=self.mesh, shift=shift,
                              act=act)
        return conv3d(x.to(self.dtype), self.weight, bias=self.bias, plain=self.plain,
                      impl=self.impl, mesh=self.mesh, shift=shift, act=act)


class ModConv3d(nn.Module):
    """Bias-free conv whose input channels are scaled per sample by a style
    (B, Cin) computed by a sibling Linear; it runs in x's dtype, as the JAX
    package's modulated conv does."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.weight = _lecun_normal((k, k, k, cin, cout), k ** 3 * cin)
        self.plain = False
        self.impl = "banded"
        self.mesh = None

    def forward(self, x, style, shift=None, act=None):
        return conv3d(x, self.weight, style=style, plain=self.plain, impl=self.impl,
                      mesh=self.mesh, shift=shift, act=act)


class ResBlockModulate(nn.Module):
    """(+temb) -> swish -> conv -> swish -> modulated conv -> + 1x1-projected skip."""

    def __init__(self, cin: int, features: int, embed_dim: int, use_temb: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.use_temb = use_temb
        self.conv20 = Conv3d(cin, features, dtype=dtype)
        self.conv21 = ModConv3d(features, features)
        self.dense2 = Dense(embed_dim, features, 1.0, dtype)
        if use_temb:
            self.dense1 = Dense(embed_dim, cin, dtype=dtype)
        if cin != features:
            self.res_conv = Conv3d(cin, features, 1, dtype)

    def forward(self, x, temb, zemb, rng=None):
        shift = self.dense1(temb) if self.use_temb else None
        h = act_conv(self.conv20, x, shift, rng)
        h = act_conv(self.conv21, h, None, rng, self.dense2(zemb))
        if hasattr(self, "res_conv"):
            x = self.res_conv(x)
        elif isinstance(x, tuple):
            x = torch.cat(x, dim=-1)
        return h + x


class AdaptionHead(nn.Module):
    """Entry head: 1x1x1 channel expansion -> swish -> modulated 3x3x3 conv."""

    def __init__(self, cin: int, features: int, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.conv20 = Conv3d(cin, features, 1, dtype)
        self.conv21 = ModConv3d(features, features)
        self.dense2 = Dense(embed_dim, features, 1.0, dtype)

    def forward(self, x, zemb):
        return self.conv21(self.conv20(x), self.dense2(zemb), act="silu")


class WaveletDown(nn.Module):
    """Conv both branches, Haar-DWT H/W, keep LL/2; returns the conv branch's
    (LH, HL, HH) as the skip."""

    def __init__(self, features: int, embed_dim: int, use_temb: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.use_temb = use_temb
        self.Conv_0 = Conv3d(features, features, dtype=dtype)
        self.Conv_2 = Conv3d(features, features, 1, dtype)
        self.Conv_1 = ModConv3d(features, features)
        self.dense1 = Dense(embed_dim, features, 1.0, dtype)
        if use_temb:
            self.Dense_0 = linear(embed_dim, features, dtype=dtype)

    def forward(self, x, temb, zemb, rng=None):
        h = self.Conv_0(x, act="silu")
        x = self.Conv_2(x)
        h_ll, h_lh, h_hl, h_hh = wavelet.dwt2d(h)
        h = h_ll * 0.5
        x = wavelet.dwt2d_ll(x) * 0.5
        shift = self.Dense_0(temb) if self.use_temb else None
        h = act_conv(self.Conv_1, h, shift, rng, self.dense1(zemb))
        return x + h, (h_lh, h_hl, h_hh)


class GroupedSkipConv(nn.Module):
    """3-group 3x3x3 conv over the three HF subbands without concatenating
    them: group g's block of the (3, 3, 3, C, 3F) kernel convolves part g."""

    def __init__(self, cin: int, features: int, groups: int = 3, dtype=torch.float32):
        super().__init__()
        self.features = features
        self.weight = _lecun_normal((3, 3, 3, cin, groups * features), 27 * cin)
        self.bias = nn.Parameter(torch.zeros(groups * features))
        self.dtype = dtype
        self.plain = False
        self.impl = "banded"
        self.mesh = None

    def forward(self, parts):
        f = self.features
        return tuple(
            conv3d(p.to(self.dtype), self.weight[..., g * f:(g + 1) * f],
                   bias=self.bias[g * f:(g + 1) * f], plain=self.plain, impl=self.impl,
                   mesh=self.mesh)
            for g, p in enumerate(parts))


class WaveletUp(nn.Module):
    """Conv both branches, project the encoder's HF skip through a 3-group
    conv, IDWT back to full resolution."""

    def __init__(self, features: int, skip_channels: int, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv3d(features, features, dtype=dtype)
        self.Conv_2 = Conv3d(features, features, 1, dtype)
        self.convH_0 = nn.ModuleList([GroupedSkipConv(skip_channels, features, dtype=dtype)])
        self.Conv_1 = ModConv3d(features, features)
        self.dense1 = Dense(embed_dim, features, 1.0, dtype)
        self.Dense_0 = linear(embed_dim, features, dtype=dtype)

    def forward(self, x, temb, zemb, skip, rng=None):
        h = self.Conv_0(x, act="silu")
        x = self.Conv_2(x)
        lh, hl, hh = (s * 2.0 for s in self.convH_0[0](tuple(s * 0.5 for s in skip)))
        h = wavelet.idwt2d(2.0 * h, lh, hl, hh)
        x = wavelet.idwt2d(2.0 * x, lh, hl, hh)
        h = act_conv(self.Conv_1, h, self.Dense_0(temb), rng, self.dense1(zemb))
        return x + h


class DownStage(nn.Module):
    """ResBlock (cin -> features) followed by wavelet downsampling."""

    def __init__(self, cin: int, features: int, embed_dim: int, use_temb: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.conv20 = ResBlockModulate(cin, features, embed_dim, use_temb, dtype)
        self.down = WaveletDown(features, embed_dim, use_temb, dtype)

    def forward(self, x, temb, zemb, rng=None):
        return self.down(self.conv20(x, temb, zemb, rng), temb, zemb, rng)


class UpStage(nn.Module):
    """ResBlock on the 3-way skip concat, then wavelet upsampling."""

    def __init__(self, cin: int, features: int, skip_channels: int, embed_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.conv20 = ResBlockModulate(cin, features, embed_dim, dtype=dtype)
        self.up1 = WaveletUp(features, skip_channels, embed_dim, dtype)

    def forward(self, x, temb, zemb, skip, rng=None):
        return self.up1(self.conv20(x, temb, zemb, rng), temb, zemb, skip, rng)


class FinalBlock(nn.Module):
    """Four ResBlocks, then a modulated 1x1x1 projection to one feature."""

    def __init__(self, cin: int, features: int, embed_dim: int, out_features: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv20 = ResBlockModulate(cin, features, embed_dim, dtype=dtype)
        self.conv21 = ResBlockModulate(features, features, embed_dim, dtype=dtype)
        self.conv22 = ResBlockModulate(features, features, embed_dim, dtype=dtype)
        self.conv23 = ResBlockModulate(features, features, embed_dim, dtype=dtype)
        self.conv24 = ModConv3d(features, out_features, 1)
        self.dense2 = Dense(embed_dim, features, 1.0, dtype)

    def forward(self, x, temb, zemb, rng=None):
        h = self.conv20(x, temb, zemb, rng)
        h = self.conv21(h, temb, zemb, rng)
        h = self.conv22(h, temb, zemb, rng)
        h = self.conv23(h, temb, zemb, rng)
        return self.conv24(swish(h), self.dense2(zemb))


class ChannelWiseAttention(nn.Module):
    """Squeeze-excitation channel gating (the reference's defined-but-unused
    `Hyper_unet_general.py:130-155`): global max and mean over (D, H, W),
    a two-layer MLP with swish, a sigmoid gate per channel. Layout
    (B, D, H, W, C); fc1 and fc2 run in `dtype`."""

    def __init__(self, channels: int, reduction_ratio: int = 16, dtype=torch.float32):
        super().__init__()
        hidden = 2 * channels // reduction_ratio
        self.fc1 = Linear(2 * channels, hidden, dtype)
        self.fc2 = Linear(hidden, channels, dtype)

    def forward(self, x):
        pooled = torch.cat([x.amax(dim=(1, 2, 3)), x.mean(dim=(1, 2, 3))], dim=-1)
        gate = torch.sigmoid(self.fc2(swish(self.fc1(pooled))))
        return x * gate[:, None, None, None, :]


class AdaptiveGroupNorm(nn.Module):
    """Style-conditioned group norm (the reference's defined-but-unused
    `Hyper_unet_general.py:311-331`): a GroupNorm without affine (statistics
    in float32, output in x's dtype, as flax's), then gamma * x_hat + beta
    with (gamma, beta) projected from the style vector by a Linear in
    `dtype` whose bias starts gamma at 1 and beta at 0 (the JAX package's
    `_agn_bias_init`). Layout (B, D, H, W, C)."""

    def __init__(self, channels: int, style_dim: int, num_groups: int, dtype=torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.style = Linear(style_dim, 2 * channels, dtype)
        with torch.no_grad():
            self.style.weight.normal_(0.0, 1.0 / math.sqrt(style_dim))
            self.style.bias.copy_(torch.cat([torch.ones(channels), torch.zeros(channels)]))

    def forward(self, x, style):
        out = F.group_norm(x.movedim(-1, 1).float(), self.num_groups, eps=1e-6)
        out = out.movedim(1, -1).to(x.dtype)
        gamma, beta = self.style(style).chunk(2, dim=-1)
        return gamma[:, None, None, None, :] * out + beta[:, None, None, None, :]
