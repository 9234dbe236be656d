"""Weights into the port's models, from the two formats the repository
holds.

  * `from_reference_state_dict`: the reference torch state_dict layout (the
    `sd.*` keys of tests/golden/*.npz, `I{step}_gen.pth`): conv weights
    (O, I, kd, kh, kw), the legacy blocks' transposed conv `up1` (I, O, kd,
    kh, kw), Linear weights (O, I). The reference's dead parameters are
    dropped: the modulated convs' biases, the wavelet blocks' unused
    `dense2`, and the condition branch's time projections.
  * `from_flax`: a JAX package param tree as nested dicts of numpy arrays
    (flax conv kernels (kd, kh, kw, I, O), Dense kernels (I, O)), mapped onto
    the reference keys by `torch_key`. It also fills the attention library
    (ops/attention.py), whose modules carry the flax names: Dense (I, O) and
    1x1 2-D Conv (1, 1, I, O) kernels become Linear weights, and the
    LayerNorm/GroupNorm `scale` becomes `weight`; and the legacy UNet and
    ControlNet (models/legacy_unet.py, models/controlnet.py): a legacy up
    stage's `up_kernel`/`up_bias` become its `up1` (the kernel stays in the
    (kd, kh, kw, I, O) layout that the JAX package swaps the last two axes
    of for `lax.conv_transpose`; ops/library_conv.py reads it so), the hint
    encoder's stacked stems (13, 1, 3, 3, I, O) keep their names and
    layout, and the Dense layers named `style` (a zero conv's), `fc1`/`fc2`
    (the task hypernetwork's) and `out_proj` become Linear weights. The
    library ops (ops/dynamic_conv.py, kernel_adaption.py, pgcu.py) and the
    orphan blocks of models/blocks.py carry the flax names too: their conv
    kernels keep the flax layout, `fc1`/`fc2`/`style` become Linear weights,
    and any other named parameter (`kernels`, `KernelParam`,
    `KernelAdaption`, `norm_scale`, `norm_bias`) keeps its name and layout.

The port keeps conv weights in the (kd, kh, kw, I, O) layout and Linear
weights in torch's (O, I). Both loaders are strict: a key the model does not
have, or a model parameter the input does not fill, raises KeyError.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# flax modulated-conv layer name -> the reference's style-Linear sibling
_MODCONV_STYLE = {"conv21": "dense2", "Conv_1": "dense1", "conv24": "dense2"}
# flax TimeMLP / PromptMLP layer -> index in the reference's nn.Sequential
_MLP_INDEX = {"lin0": "0", "lin1": "2", "lin2": "4"}
# attention-library layers that are nn.Linear in the port: flax Dense
# (I, O) and 1x1 2-D Conv (1, 1, I, O) kernels
_ATTN_LINEAR = {"to_q", "to_k", "to_v", "to_out", "proj", "lin_in", "lin_out",
                "proj_in", "proj_out", "q", "k", "v", "NIN_0", "NIN_1", "NIN_2", "NIN_3"}
# the ControlNet's and the legacy UNet's Dense layers (a zero conv's style
# outside the modulated convs of _MODCONV_STYLE, the task hypernetwork's, the
# output projection)
_DENSE = {"style", "fc1", "fc2", "out_proj"}


def torch_key(path: tuple[str, ...]) -> tuple[str, str]:
    """flax param path -> (reference torch key, kind), kind one of 'conv',
    'linear', 'none' (the layout change from flax to torch)."""
    parts = [p for p in path if p != "params"]
    leaf, mods = parts[-1], parts[:-1]
    if leaf == "scale":  # LayerNorm / GroupNorm
        return ".".join(mods) + ".weight", "none"
    if mods and mods[-1] in _ATTN_LINEAR:
        base = ".".join(mods)
        return (base + ".weight", "linear") if leaf == "kernel" else (base + ".bias", "none")
    if leaf in ("up_kernel", "up_bias"):  # a legacy up stage's transposed conv
        return ".".join(mods + ["up1", "weight" if leaf == "up_kernel" else "bias"]), "none"
    if leaf.startswith("stem"):  # the hint encoder's stacked stems
        return ".".join(mods + [leaf]), "none"
    if len(mods) >= 2 and mods[-2] in ("embed", "embed2") and mods[-1] in _MLP_INDEX:
        base = ".".join(mods[:-1] + [_MLP_INDEX[mods[-1]]])
        return (base + ".weight", "linear") if leaf == "kernel" else (base + ".bias", "none")
    if len(mods) >= 2 and mods[-1] == "style" and mods[-2] in _MODCONV_STYLE:
        base = ".".join(mods[:-2] + [_MODCONV_STYLE[mods[-2]], "dense"])
        return (base + ".weight", "linear") if leaf == "kernel" else (base + ".bias", "none")
    if mods and mods[-1] in _DENSE:
        base = ".".join(mods)
        return (base + ".weight", "linear") if leaf == "kernel" else (base + ".bias", "none")
    if mods and mods[-1] in _MODCONV_STYLE and leaf == "kernel":
        return ".".join(mods) + ".weight", "conv"
    if mods and mods[-1] == "dense1":
        base = ".".join(mods + ["dense"])
        return (base + ".weight", "linear") if leaf == "kernel" else (base + ".bias", "none")
    if mods and mods[-1] == "Dense_0":
        base = ".".join(mods)
        return (base + ".weight", "linear") if leaf == "kernel" else (base + ".bias", "none")
    if mods and mods[-1] == "convH_0":
        base = ".".join(mods) + ".0"
        return (base + ".weight", "conv") if leaf == "kernel" else (base + ".bias", "none")
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), "conv"
    # a bias, or a parameter of its own name (the library ops' `kernels`,
    # `KernelParam`, `norm_scale`, ...), kept in the flax layout
    return ".".join(mods + [leaf]), "none"


def is_dead_reference_param(key: str, sd: Mapping) -> bool:
    """The reference parameters its forward pass never reads."""
    return (
        # the modulated convs' biases
        key.endswith(("conv21.bias", "Conv_1.bias", "conv24.bias"))
        # WaveletUPorDown's dense2, only where a Conv_1 lives beside it
        or (".dense2.dense" in key and key.replace(".dense2.dense.weight", ".Conv_1.weight")
            .replace(".dense2.dense.bias", ".Conv_1.weight") in sd)
        # the condition branch's time projections (flag=True in the reference);
        # its wavelet blocks' dense1 is their live style Linear
        or ("_1." in key and (".conv20.dense1.dense." in key or ".Dense_0." in key))
    )


def _load_strict(model: torch.nn.Module, arrays: Mapping[str, np.ndarray], leftover_ok=None):
    """Every parameter of `model` from `arrays`; a buffer that `arrays` lacks
    (ControlledLegacyUNet's `task_features`, which neither the reference's
    checkpoints nor flax trees hold) keeps the model's own value."""
    own = model.state_dict()
    buffers = {k for k, _ in model.named_buffers()}
    unknown = sorted(k for k in arrays if k not in own
                     and not (leftover_ok and leftover_ok(k)))
    missing = sorted(k for k in own if k not in arrays and k not in buffers)
    if unknown or missing:
        raise KeyError(f"unknown keys {unknown[:8]}, missing keys {missing[:8]}")
    new = {}
    for k, ref in own.items():
        if k not in arrays:
            new[k] = ref
            continue
        t = torch.as_tensor(np.asarray(arrays[k], dtype=np.float32))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)}, the model has {tuple(ref.shape)}")
        new[k] = t
    model.load_state_dict(new, strict=True)
    return model


def _is_transposed_conv(key: str) -> bool:
    """The legacy up stages' ConvTranspose3d weights, (I, O, kd, kh, kw) in
    the reference (WavBEST's `up1` modules hold no weight of their own)."""
    return key == "up1.weight" or key.endswith(".up1.weight")


def from_reference_state_dict(model: torch.nn.Module, sd: Mapping[str, np.ndarray],
                              prefix: str = "") -> torch.nn.Module:
    """Fill `model` from a reference state_dict (keys after `prefix`)."""
    sd = {k[len(prefix):]: np.asarray(v) for k, v in sd.items() if k.startswith(prefix)}
    arrays = {k: np.transpose(v, (2, 3, 4, 0, 1) if _is_transposed_conv(k) else (2, 3, 4, 1, 0))
              if v.ndim == 5 else v for k, v in sd.items()}
    return _load_strict(model, arrays, leftover_ok=lambda k: is_dead_reference_param(k, sd))


def _flatten(tree, path=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, path + (str(k),))
    else:
        yield path, tree


def from_flax(model: torch.nn.Module, params) -> torch.nn.Module:
    """Fill `model` from a JAX param tree of numpy arrays: a WavBEST, a
    module of the attention library, a library op or orphan block, a
    LegacyUNet or a ControlledLegacyUNet."""
    arrays = {}
    for path, leaf in _flatten(params):
        key, kind = torch_key(path)
        arr = np.asarray(leaf)
        arrays[key] = arr.reshape(arr.shape[-2:]).T if kind == "linear" else arr
    return _load_strict(model, arrays)
