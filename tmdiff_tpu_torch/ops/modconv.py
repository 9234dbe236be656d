"""3-D convolutions of WavBEST, band-as-depth channels-last layout, and the
JAX package's conv API (tmdiff_tpu/ops/modconv.py) in full.

Activations are (B, D, H, W, C) with the spectral bands as conv depth D;
kernels are (kd, kh, kw, Cin, Cout). WavBEST's convs are SAME and stride 1,
of two kernel sizes:

  * SAME stride-1 3x3x3, lowered by `impl`:
      - "banded" (the default): the 3x3x3 CUDA kernel (ops/cuda/conv3d.py)
        at every shape. The JAX package's TMDIFF_CONV3D_IMPL=banded.
      - "auto": the JAX package's TMDIFF_CONV3D_IMPL=auto with
        TMDIFF_BANDLANES_CONV=pallas. Where `_bandlanes_wins`, the bands are
        folded into channels and the conv runs as one 3x3 NHWC conv with a
        block-banded weight (`_conv3d_bandlanes`, the 3x3 CUDA kernel of
        ops/cuda/conv2d.py); every other 3x3x3 conv takes the 3x3x3 kernel.
    A modulated conv passes its style to the kernel, which scales the
    operand as it loads it: conv(x * s, W) without writing x * s out. Each
    kernel's plain version runs on a CPU tensor or when `plain=True`.
  * 1x1x1: a (B*D*H*W, Cin) @ (Cin, Cout) matrix product, under either impl.

A conv may take a pre-activation of its input, act="silu" with an
optional shift (B, Cin): silu(x + shift) (the blocks' `silu(h + temb)`
before a conv), padded after the activation. The 3x3x3 kernel applies it as it
stages its operand, beside the style, where x is bf16 on a CUDA device, no
gradient is needed and no halo rows are exchanged; the fp32 kernel, a
gradient, a halo exchange, the band-into-lanes form, the 1x1x1 product, the
library route and the plain versions take it as PyTorch ops first
(ops/cuda/conv3d.py::preact), the same ops and roundings.

Every other conv of the API (another kernel size, padding "VALID" or
explicit pairs, a stride) and the transposed `modulated_conv_transpose3d`
go to ops/library_conv.py (cuDNN, TF32 off, deterministic), as the JAX
package sends them to XLA's conv (its "auto" folds a kd = 1 SAME conv into
a 2-D one, the same function). On a space-split placement such a conv
runs on its shard where each rank's rows of the global output are a
contiguous block of equal size (`_split_plan`: the stride divides the
shard's height and the output height is the global height over the
stride): the shard takes the rows its window reaches past it from its
neighbours (the kernel height less the stride in all, split as the padding
splits it; zeros only at the image's edges), and the conv runs with no
padding along the height. The transposed conv does so on the stride-dilated
shard. Any other shape raises, naming it, where XLA's partitioner would
take it.

Under a gradient every 3x3x3 conv takes "banded" (K1's autograd Function:
the forward and the input gradient through the kernel, ops/cuda/conv3d.py,
in fp32 or bf16; the weight's cast to x's dtype is differentiated back to
the float32 parameter);
"auto" raises there, since K3 has no backward, as the JAX package's Pallas
3x3 conv has no VJP. `out` is then added out of place, so no tensor that
autograd saved is written; without a gradient it accumulates in place in the
kernel's epilogue, one launch per concat part.

Every conv runs in x's dtype, float32 or bfloat16: the weight, style and
bias are cast to it at use (parameters stay float32), as the JAX package
casts `kernel.astype(self.dtype)` and `style.astype(x.dtype)`; the
block-banded weight of the band-into-lanes form is built from the given
weight and then cast (`w2.astype(x.dtype)` there). The 1x1x1 convs are
products in x's dtype.

Every entry takes `mesh`, the placement of a call sharded over a
("data", "space") mesh (parallel/mesh.py), or None. Where it splits the
height, each 3x3x3 conv (and each part of a concat) first gets one halo row
from each neighbouring space rank (parallel/halo.py), runs its kernel on
the H + 2 rows, and keeps the middle H; the parts of `conv3d_cat`
accumulate into one (H + 2)-row buffer, cropped once. Either lowering is
exact that way (the JAX package refuses "banded" on a mesh, where its
Pallas call cannot be partitioned), and "auto" picks its lowering by the
global height, as the unsharded call does. On any placement the kernels
take the unsharded call's split count (`unsharded`, ops/cuda/conv3d.py::
plan), so each element of a shard is summed as in the unsharded call. The
1x1x1 convs are row-local.

The reference's per-sample modulated conv, w_b[o, i] = w[o, i] * s[b, i] with
no bias and no demodulation, equals conv(x_b * s_b, w) because the style
scales input channels only (tmdiff_tpu/ops/modconv.py pins this identity
against the torch reference golden).
"""
from __future__ import annotations

import torch

from tmdiff_tpu_torch.ops.cuda.conv2d import conv3x3_nhwc, conv3x3_nhwc_plain
from tmdiff_tpu_torch.ops.cuda.conv3d import banded_conv3d, conv3d_plain, needs_grad, preact
from tmdiff_tpu_torch.ops.library_conv import (conv_nd, conv_transpose_nd, dilate, per_axis,
                                               transpose_padding, xla_padding)
from tmdiff_tpu_torch.parallel.halo import exchange_rows

IMPLS = ("banded", "auto")

# Output widths that "auto" keeps on the 3x3x3 kernel, or sends to the
# band-into-lanes form, whatever `_bandlanes_wins` would say otherwise: the
# JAX package's TMDIFF_CONV3D_AUTO_NATIVE and TMDIFF_CONV3D_AUTO_BANDLANES,
# empty as there by default.
AUTO_NATIVE_COUTS: frozenset = frozenset()
AUTO_BANDLANES_COUTS: frozenset = frozenset()


def _bandlanes_wins(d: int, kd: int, cout: int, h: int = 0) -> bool:
    """The JAX package's rule for the band-into-lanes lowering under "auto":
    every lane-starved (Cout < 128) multi-tap conv over more than one band,
    except deep-band half-lane levels (D >= 8 and Cout >= 64) at H <= 128
    (h = 0: unknown), which stay on the native 3-D conv; the override sets
    above come first."""
    native_excl = d >= 8 and cout >= 64 and (h == 0 or h <= 128)
    return (kd > 1 and d > 1 and cout < 128
            and (cout in AUTO_BANDLANES_COUTS or not native_excl)
            and cout not in AUTO_NATIVE_COUTS)


def banded_weight(kernel, d: int):
    """The (kh, kw, D*Cin, D*Cout) block-banded 2-D weight of a (kd, kh, kw,
    Cin, Cout) kernel over D bands: block (d_in, d_out) holds tap
    d_in - d_out + kd // 2 where that lies in the kernel, zero elsewhere."""
    kd, kh, kw, cin, cout = kernel.shape
    bands = torch.arange(d, device=kernel.device)
    idx = bands[:, None] - bands[None, :] + kd // 2  # tap per (d_in, d_out)
    valid = (idx >= 0) & (idx < kd)
    kg = kernel[idx.clamp(0, kd - 1)] * valid[:, :, None, None, None, None]
    return kg.permute(2, 3, 0, 4, 1, 5).reshape(kh, kw, d * cin, d * cout)


def _as(t, dtype):
    return None if t is None else t.to(dtype)


def _conv3d_bandlanes(x, kernel, style=None, bias=None, out=None, plain: bool = False,
                      mesh=None):
    """SAME 3x3x3 conv with the bands folded into channels: (B, D, H, W, C)
    -> (B, H, W, D*C), one 3x3 conv with the block-banded weight (D/3 times
    the useful multiply-adds), and back. Style and bias go to the 2-D
    kernel, tiled over the bands; `out` accumulates after the unfold. Where
    the window overhangs the image (H or W < 3) the 3x3x3 kernel runs
    instead, as the JAX package routes such convs to the native conv. On a
    space-sharded placement `mesh` the halo rows are exchanged first and
    the middle rows of the output kept."""
    return _sharded(x, kernel, style, bias, out, plain, mesh, fold=True)


def _pre(shift, act) -> dict:
    """The keyword arguments of a pre-activation, none where there is none."""
    return {} if shift is None and act is None else {"shift": shift, "act": act}


def _conv333(x, kernel, style, bias, out, plain, fold, unsharded=None, pre=None):
    """The SAME 3x3x3 conv of x as it stands (halo rows included): through
    the band-into-lanes form where `fold` asks for it and the window fits
    the global height and the width, else through the 3x3x3 kernel. On a
    mesh, `unsharded` is the (B, H) of the unsharded call: its H is the
    global height, and the kernels are planned for it. `pre` (`_pre`) goes
    to the 3x3x3 kernel's wrapper, which applies it in the launch where it
    can; the band-into-lanes form takes it as PyTorch ops first."""
    dt = x.dtype
    b, d, hx, w, cin = x.shape
    h = hx if unsharded is None else unsharded[1]
    cout = kernel.shape[-1]
    on_mesh = {} if unsharded is None else {"unsharded": unsharded}
    pre = pre or {}
    if not fold or h < kernel.shape[1] or w < kernel.shape[2]:
        args = (x, _as(kernel, dt), _as(style, dt), _as(bias, dt), out)
        return conv3d_plain(*args, **pre) if plain else banded_conv3d(*args, **on_mesh, **pre)
    x = preact(x, **pre)
    x2 = x.permute(0, 2, 3, 1, 4).reshape(b, hx, w, d * cin)
    s2 = None if style is None else style.to(dt).repeat(1, d)
    b2 = None if bias is None else bias.to(dt).repeat(d)
    w2 = banded_weight(kernel, d).to(dt)
    y2 = (conv3x3_nhwc_plain(x2, w2, s2, b2) if plain
          else conv3x3_nhwc(x2, w2, s2, b2, **on_mesh))
    y = y2.view(b, hx, w, d, cout).permute(0, 3, 1, 2, 4)
    return y.contiguous() if out is None else out.add_(y)


def _halo(mesh) -> bool:
    return mesh is not None and mesh.halo


def _unsharded(mesh, x):
    """The (B, H) of the unsharded call of which x (B, D, H, W, C), without
    halo rows, is this rank's shard; None without a mesh."""
    if mesh is None:
        return None
    shape = mesh.global_shape(x.shape)
    return shape[0], shape[2]


def _sharded(x, kernel, style, bias, out, plain, mesh, fold, pre=None):
    """`_conv333` of an unsharded x, or of a space shard with its halo rows,
    keeping the middle rows. `out` (without a gradient) takes the sum. A
    shard takes its pre-activation as PyTorch ops before the exchange: the
    image's edge rows it receives are the padding, zeros the kernel could
    not tell from data."""
    unsharded = _unsharded(mesh, x)
    if not _halo(mesh):
        return _conv333(x, kernel, style, bias, out, plain, fold, unsharded, pre)
    y = _conv333(exchange_rows(preact(x, **(pre or {})), mesh), kernel, style, bias, None,
                 plain, fold, unsharded)[:, :, 1:-1]
    return y.contiguous() if out is None else out.add_(y)


def _refuse_auto_grad(impl: str) -> None:
    if impl == "auto":
        raise ValueError('the "auto" conv lowering has no backward (its 3x3 kernel has '
                         'none); train with impl="banded" (WavBEST.use_conv_impl)')


def _fold(impl: str, x, kernel, mesh) -> bool:
    """Whether "auto" sends this 3x3x3 conv to the band-into-lanes form; the
    rule reads the global height, so a shard takes the unsharded choice."""
    h = x.shape[2] * (mesh.space if _halo(mesh) else 1)
    return impl == "auto" and _bandlanes_wins(x.shape[1], 3, kernel.shape[-1], h)


def _kernel_route(kernel, padding, stride) -> bool:
    """Whether the conv is one of WavBEST's own: SAME, stride 1, a 3x3x3
    (K1) or 1x1x1 (a matrix product) kernel."""
    return (padding == "SAME" and tuple(stride) == (1, 1, 1)
            and tuple(kernel.shape[:3]) in ((3, 3, 3), (1, 1, 1)))


def _split_plan(mesh, x, kernel, padding, stride, name: str):
    """(lo, hi, pads) of a library conv of the space shard x: the rows its
    window reaches before and after the shard (a negative count: the
    shard's rows there that no output of this rank reads) and the conv's
    padding with the height's pair (0, 0), the exchange padding the image's
    edges. Raises where the split does not hold (module doc), naming the
    call `name` and the reason."""
    h_l = x.shape[2]
    h = h_l * mesh.space
    kh, sh = kernel.shape[1], stride[1]
    pads = xla_padding(padding, (x.shape[1], h, x.shape[3]), kernel.shape[:3], stride)
    p_lo, p_hi = pads[1]
    h_out = (h + p_lo + p_hi - kh) // sh + 1
    lo, hi = p_lo, kh - sh - p_lo
    if h_l % sh:
        why = f"the stride {sh} does not divide the shard's {h_l} rows"
    elif h_out != h // sh:
        why = f"its output height {h_out} is not the height {h} over the stride {sh}"
    elif max(lo, hi) > h_l:
        why = f"its window reaches {max(lo, hi)} rows past a {h_l}-row shard"
    else:
        pads[1] = (0, 0)
        return lo, hi, pads
    raise ValueError(f"{name} cannot run on a space-split placement of {mesh.space} ranks: {why}")


def _split_conv(x, kernel, padding, stride, mesh, name: str):
    """conv_nd of the space shard x: this rank's rows of the conv of the
    unsharded x (`_split_plan`). A bf16 x goes through the exchange as its
    float32 values (its rows cross as bf16), so the conv's input gradient
    comes back in float32 and a halo row's two parts add up before one
    rounding, as one process rounds the whole sum."""
    lo, hi, pads = _split_plan(mesh, x, kernel, padding, stride, name)
    dt = x.dtype
    xe = exchange_rows(x.float(), mesh, lo=max(lo, 0), hi=max(hi, 0), wire=dt)
    if lo < 0 or hi < 0:
        xe = xe[:, :, max(-lo, 0):xe.shape[2] - max(-hi, 0)]
    return conv_nd(xe, kernel, stride, pads, dtype=dt)


def _library(x, kernel, style, bias, out, padding, stride, mesh):
    """Any other conv, as the JAX package sends it to XLA's conv: x * s in
    x's dtype, `library_conv.conv_nd` (split over a space-split placement's
    shards), then the bias in x's dtype."""
    dt = x.dtype
    stride = per_axis(stride, 3)
    if style is not None:
        x = x * style.to(dt)[:, None, None, None, :]
    if _halo(mesh):
        y = _split_conv(x, kernel, padding, stride, mesh,
                        f"a {tuple(kernel.shape[:3])} conv with padding {padding!r} and stride "
                        f"{stride} of x {tuple(x.shape)}")
    else:
        y = conv_nd(x, kernel, stride, padding)
    if bias is not None:
        y = y + bias.to(dt)
    if out is None:
        return y
    return out + y if needs_grad(out, y) else out.add_(y)


def conv3d(x, kernel, *, style=None, bias=None, out=None, plain: bool = False,
           impl: str = "banded", mesh=None, padding="SAME", stride=(1, 1, 1), shift=None,
           act=None):
    """Conv of x (B, D, H, W, Cin) with kernel (kd, kh, kw, Cin, Cout) of
    the style-scaled input, plus bias; added into `out` when given (in
    place without a gradient). With a pre-activation, act="silu" and an
    optional shift (B, Cin), the conv's input is
    silu(x + shift[:, None, None, None, :]), padded after the activation:
    the 3x3x3 kernel applies it as it stages its operand where x is bf16 on
    a CUDA device, no gradient is needed and no halo rows are exchanged
    (ops/cuda/conv3d.py); every other call computes it first with PyTorch
    ops (`preact`), as the blocks did before. `padding` ("SAME", "VALID" or (lo, hi)
    pairs) and `stride` as the JAX package's conv3d takes them. SAME
    stride-1 3x3x3 convs take the kernel of `impl` (module doc), SAME
    stride-1 1x1x1 convs a matrix product, and every other conv
    `library_conv.conv_nd` (cuDNN, TF32 off), as the JAX package sends it to
    XLA's conv. On a space-sharded placement `mesh` (parallel/mesh.py) a
    3x3x3 conv exchanges one halo row with each neighbouring rank
    (parallel/halo.py), runs on the H + 2 rows and keeps the middle H; a
    library conv takes the rows its window reaches past the shard where the
    split holds, and raises elsewhere (module doc)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown conv lowering {impl!r}; expected one of {IMPLS}")
    pre = _pre(shift, act)
    if not _kernel_route(kernel, padding, stride):
        return _library(preact(x, **pre), kernel, style, bias, out, padding, stride, mesh)
    if needs_grad(x, kernel, style, bias, out, shift):
        _refuse_auto_grad(impl)
        if out is not None:
            return out + conv3d(x, kernel, style=style, bias=bias, plain=plain, mesh=mesh,
                                **pre)
    size = tuple(kernel.shape[:3])
    dt = x.dtype
    if size == (3, 3, 3):
        return _sharded(x, kernel, style, bias, out, plain, mesh, _fold(impl, x, kernel, mesh),
                        pre)
    x = preact(x, **pre)
    if style is not None:
        x = x * style.to(dt)[:, None, None, None, :]
    y = torch.matmul(x.reshape(-1, x.shape[-1]), kernel[0, 0, 0].to(dt))
    y = y.reshape(*x.shape[:-1], kernel.shape[-1])
    if bias is not None:
        y = y + bias.to(dt)
    return y if out is None else out.add_(y)


def conv3d_cat(parts, kernel, *, bias=None, plain: bool = False, impl: str = "banded",
               mesh=None, padding="SAME", stride=(1, 1, 1), shift=None, act=None):
    """conv3d(cat(parts, -1), kernel) + bias without materialising the concat:
    each part convolves with its slice of the kernel's input channels (a
    view, through which its gradient reaches the kernel), and the parts
    accumulate into one output. A pre-activation (conv3d's) takes each part
    with its own contiguous slice of the shift (B, total Cin). On a space-sharded placement the 3x3x3
    parts each get their halo rows and accumulate into one (H + 2)-row
    buffer, cropped once. A conv of the library route (see conv3d) sums its
    parts' convs, each rounded to x's dtype, as the JAX package does."""
    library = not _kernel_route(kernel, padding, stride)
    halo = not library and _halo(mesh) and tuple(kernel.shape[:3]) == (3, 3, 3)
    off, out = 0, None
    for p in parts:
        kpart = kernel[..., off:off + p.shape[-1], :]
        sh = None if shift is None else shift[:, off:off + p.shape[-1]].contiguous()
        off += p.shape[-1]
        b = bias if out is None else None
        if not halo:
            out = conv3d(p, kpart, bias=b, out=out, plain=plain, impl=impl, mesh=mesh,
                         padding=padding, stride=stride, shift=sh, act=act)
            continue
        if needs_grad(p, kpart, b, out, sh):
            _refuse_auto_grad(impl)
        xp = exchange_rows(preact(p, sh, act), mesh)
        unsharded = _unsharded(mesh, p)
        fold = _fold(impl, p, kpart, mesh)
        if out is not None and needs_grad(xp, kpart, out):
            out = out + _conv333(xp, kpart, None, b, None, plain, fold, unsharded)
        else:
            out = _conv333(xp, kpart, None, b, out, plain, fold, unsharded)
    if off != kernel.shape[-2]:
        raise ValueError(f"parts have {off} channels, kernel takes {kernel.shape[-2]}")
    return out[:, :, 1:-1].contiguous() if halo else out


def modulated_conv3d(x, kernel, style, *, plain: bool = False, impl: str = "banded",
                     mesh=None, padding="SAME", stride=(1, 1, 1)):
    """y_b = conv3d(x_b * s_b, kernel) for style (B, Cin), no bias."""
    return conv3d(x, kernel, style=style, plain=plain, impl=impl, mesh=mesh, padding=padding,
                  stride=stride)


def modulated_conv_transpose3d(x, kernel, style, *, stride=(1, 1, 1), padding="SAME",
                               mesh=None):
    """The transposed twin of modulated_conv3d: lax.conv_transpose(x_b *
    s_b, kernel, stride, padding) with kernel (kd, kh, kw, Cin, Cout), not
    flipped (transpose_kernel=False), padding "SAME", "VALID" or (lo, hi)
    pairs of the stride-dilated input (library_conv.conv_transpose_nd); x's
    dtype. On a space-split placement each shard is dilated with s - 1 zero
    rows after its last row too (its part of the dilated image; past the
    image's last row they stand for as much of the padding) and the
    stride-1 conv is split over the shards as a library conv is (module
    doc)."""
    scaled = x * style.to(x.dtype)[:, None, None, None, :]
    if not _halo(mesh):
        return conv_transpose_nd(scaled, kernel, stride, padding)
    stride = per_axis(stride, 3)
    pads = transpose_padding(kernel.shape[:3], stride, padding)
    p_lo, p_hi = pads[1]
    pads[1] = (p_lo, p_hi - (stride[1] - 1))
    return _split_conv(dilate(scaled, stride, trailing=(1,)), kernel, pads, (1, 1, 1), mesh,
                       f"a {tuple(kernel.shape[:3])} transposed conv with padding {padding!r} "
                       f"and stride {stride} of x {tuple(x.shape)}")
