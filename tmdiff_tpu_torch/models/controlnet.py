"""ControlNet adapter over the legacy UNet (port of
tmdiff_tpu/models/controlnet.py, which reproduces the UniControl ControlNet
of the reference's `utils/cldm_unicontrol.py`).

  * `ControlledLegacyUNet`: LegacyUNet (models/legacy_unet.py, the same
    wiring and module names) whose middle output and encoder skips receive
    additive control residuals, the skip-level ones dropped with
    `only_mid_control`. The base embeddings, encoder and middle run under
    torch.no_grad(), as the reference runs them (the JAX package's
    stop_gradient on the taps): they get no gradient.
  * `ControlBranch`: a trainable copy of the base x-encoder, middle and
    embedding MLPs, a task-MoE hint encoder (`HintEncoderMoE`: 13 per-task
    stems and a shared trunk) and per-tap zero convs (`ModulatedZeroConv`)
    whose input channels are scaled per task by a style from the task
    hypernetwork (`TaskHypernet`). The style is detached at every zero
    conv, as the reference does, so the hypernetwork gets no gradient.
  * The init recipe: zero convs exact zeros, the control branch a copy of
    the base encoder (`init_control_from_base`), so at initialisation the
    controlled model computes the plain LegacyUNet bit for bit.
  * The optimiser split: `trainable_labels` names each parameter "train"
    or "freeze" (the control branch always trains, the base decoder only
    when not `sd_locked`, the base encoder never); `trainable_parameters`
    gives an optimiser the "train" ones, so a frozen parameter gets no
    update, as `optax.set_to_zero` gives it none in the JAX package.

The ResBlocks' SAME 3x3x3 convs run K1 on a CUDA tensor; the strided and
transposed convs and the hint encoder's (1, 3, 3) convs are no TPU kernel's
function and run through ops/library_conv.py (the JAX package's XLA convs);
the zero convs are 1x1x1 (matrix products). Module and parameter names are
the JAX package's (flax `stem{i}_kernel` stacks (13, 1, 3, 3, Cin, Cout)),
so utils/weights.py::from_flax fills them. Every module takes `dtype`,
float32 or bfloat16, as the JAX package's do: parameters stay float32, the
hint and the task feature are cast to `dtype`, and a zero conv computes
conv(x · s) + b in it.

Serving (pipeline.py, serve/engine.py) goes through the facade's contract:
`encode_condition(pan, ms, prompt_emb, hint=, task=)` holds what no
diffusion step changes, `denoise(x_t, t, cache)` the rest, and `forward`
equals the two together bit for bit. The hint encoder reads only the hint
and the task embedding, so it runs once per image, in `encode_condition`
(inside a `sample.hint` span, utils/profiling.py), exactly as it would at
every step. `task` is one id for the batch (an int: the JAX package's
path) or one id per row (a sequence, an array or a tensor of ids), so one
batch mixes tasks: each row's stems are its task's experts, run as one
grouped conv over the batch (ops/library_conv.py::library_conv3d_rows),
and the hypernetwork and the zero convs' styles take one task embedding
per row. The task features come from the model's `task_features` buffer
(ALL_TASKS_NUM, 768), filled from `task_feature` by default, unless a
caller passes `task_feat`.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from tmdiff_tpu_torch.models import legacy_unet
from tmdiff_tpu_torch.models.blocks import (AdaptionHead, ResBlockModulate, dropout_rng,
                                            linear, swish)
from tmdiff_tpu_torch.models.clip_text import placeholder_text_embedding
from tmdiff_tpu_torch.models.legacy_blocks import LibraryConv3d, StridedDownStage
from tmdiff_tpu_torch.models.legacy_unet import LegacyUNet
from tmdiff_tpu_torch.models.wavbest import PromptMLP, TimeMLP
from tmdiff_tpu_torch.ops.library_conv import library_conv3d, library_conv3d_rows
from tmdiff_tpu_torch.ops.modconv import modulated_conv3d
from tmdiff_tpu_torch.utils import profiling

# `cldm_unicontrol.py:146-150`: the 13 UniControl task ids.
TASKS_TO_ID = {
    "control_hed": 0, "control_canny": 1, "control_seg": 2,
    "control_depth": 3, "control_normal": 4, "control_openpose": 5,
    "control_img": 6, "control_hedsketch": 7, "control_bbox": 8,
    "control_outpainting": 9, "control_grayscale": 10, "control_blur": 11,
    "control_inpainting": 12,
}

# `cldm_unicontrol.py:422-428`: the task prompts whose text embedding is the
# 768-d task feature.
TASK_PROMPTS = {
    "control_hed": "hed edge to image",
    "control_canny": "canny edge to image",
    "control_seg": "segmentation map to image",
    "control_depth": "depth map to image",
    "control_normal": "normal surface map to image",
    "control_openpose": "human pose skeleton to image",
    "control_img": "image editing",
    "control_hedsketch": "sketch to image",
    "control_bbox": "bounding box to image",
    "control_outpainting": "image outpainting",
    "control_grayscale": "gray image to color image",
    "control_blur": "deblur image to clean image",
    "control_inpainting": "image inpainting",
}

ALL_TASKS_NUM = len(TASKS_TO_ID)  # 13


def torch_conv_bias_init(fan_in: int, shape) -> torch.Tensor:
    """torch's conv bias init, U(±1/√fan_in). The hint path is gated by two
    chained zero convs; with zero trunk biases the trunk's output at
    zeroconv0's init would be exactly zero and neither zero conv could
    leave zero under training. Nonzero biases, as torch's convs have, let
    the path bootstrap (tests/test_torch_controlnet.py)."""
    bound = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape).uniform_(-bound, bound)


def task_feature(task_name: str) -> np.ndarray:
    """The 768-d feature of a task: its prompt through the placeholder text
    embedding of the sensor prompts (models/clip_text.py)."""
    return placeholder_text_embedding(TASK_PROMPTS[task_name])


class TaskHypernet(nn.Module):
    """`task_id_hypernet`: 768 -> T -> T, SiLU after each Linear, in
    `dtype`."""

    def __init__(self, time_embed_dim: int, feature_dim: int = 768, dtype=torch.float32):
        super().__init__()
        self.fc1 = linear(feature_dim, time_embed_dim, dtype=dtype)
        self.fc2 = linear(time_embed_dim, time_embed_dim, dtype=dtype)

    def forward(self, feature):
        return swish(self.fc2(swish(self.fc1(feature))))


class ModulatedZeroConv(nn.Module):
    """Zero-initialised 1x1x1 conv whose input channels are scaled by the
    task style (a Linear of the task embedding, detached): conv(x · s) + b,
    the reference's modulated conv with demodulate=False, in `dtype`."""

    def __init__(self, cin: int, features: int, task_dim: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, 1, 1, cin, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.style = linear(task_dim, cin, dtype=dtype)
        self.dtype = dtype

    def forward(self, x, task_emb):
        style = self.style(task_emb).detach()
        if style.dim() == 1:
            style = style.expand(x.shape[0], style.shape[0])
        return modulated_conv3d(x.to(self.dtype), self.weight, style) + self.bias.to(self.dtype)


class HintEncoderMoE(nn.Module):
    """Task-MoE hint encoder: the task's stem (hint -> 16 -> 16 -> 32, SiLU),
    a zero conv, the shared trunk (32 -> 32 -> 96 -> 96 -> 256, SiLU) and a
    zero conv to `model_channels`, every conv (1, 3, 3) SAME at stride 1 on
    the depth-1 hint. Each stem layer is one stacked parameter over every
    task (the checkpoint is task-independent); `task_id` picks its slice:
    an int for the whole batch, or a (B,) tensor of ids, each row through
    its own task's stems in one grouped conv. The hint is (B, H, W,
    hint_channels), cast to `dtype`; the output (B, 1, H, W,
    model_channels) broadcasts over the bands."""

    STEM = ((None, 16), (16, 16), (16, 32))
    TRUNK = ((32, 32), (32, 96), (96, 96), (96, 256))

    def __init__(self, model_channels: int, hint_channels: int = 3,
                 all_tasks_num: int = ALL_TASKS_NUM, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        task_dim = 4 * model_channels
        for li, (cin, cout) in enumerate(self.STEM):
            cin = cin or hint_channels
            self.register_parameter(f"stem{li}_kernel", nn.Parameter(
                torch.randn(all_tasks_num, 1, 3, 3, cin, cout) / math.sqrt(9 * cin)))
            self.register_parameter(f"stem{li}_bias", nn.Parameter(
                torch_conv_bias_init(9 * cin, (all_tasks_num, cout))))
        self.zeroconv0 = ModulatedZeroConv(32, 32, task_dim, dtype)
        for li, (cin, cout) in enumerate(self.TRUNK):
            self.add_module(f"share{li}", LibraryConv3d(
                cin, cout, "hint", bias=torch_conv_bias_init(9 * cin, (cout,)), dtype=dtype))
        self.zeroconv1 = ModulatedZeroConv(256, model_channels, task_dim, dtype)

    def forward(self, hint, task_id, task_emb):
        h = hint.to(self.dtype)[:, None]
        conv = library_conv3d if isinstance(task_id, int) else library_conv3d_rows
        for li in range(len(self.STEM)):
            kernel = getattr(self, f"stem{li}_kernel")[task_id]
            bias = getattr(self, f"stem{li}_bias")[task_id]
            h = swish(conv(h, kernel, bias, kind="hint"))
        h = self.zeroconv0(h, task_emb)
        for li in range(len(self.TRUNK)):
            h = swish(getattr(self, f"share{li}")(h))
        return self.zeroconv1(h, task_emb)


class ControlBranch(nn.Module):
    """The trainable copy of the base x-encoder, middle and embedding MLPs
    (names as LegacyUNet's: `embed`, `embed2`, `conv2`, `down1-3`,
    `middle1`), the hint added to the head's output, and a zero conv per
    tap (`zero0-4`). Returns the five control residuals, in `dtype`."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128, 256), hint_channels: int = 3,
                 embed_dim: int = 128, inter_dim: int = 32, dtype=torch.float32):
        super().__init__()
        c0, c1, c2, c3 = channels
        e, d = embed_dim, dtype
        self.embed = TimeMLP(inter_dim, e, d)
        self.embed2 = PromptMLP(e, d)
        self.hint = HintEncoderMoE(c0, hint_channels, dtype=d)
        self.conv2 = AdaptionHead(1, c0, e, d)
        self.down1 = StridedDownStage(c0, c1, e, d)
        self.down2 = StridedDownStage(c1, c2, e, d)
        self.down3 = StridedDownStage(c2, c3, e, d)
        self.middle1 = ResBlockModulate(c3, c3, e, dtype=d)
        for i, f in enumerate((c0, c1, c2, c3, c3)):
            self.add_module(f"zero{i}", ModulatedZeroConv(f, f, 4 * c0, d))

    def forward(self, xt, gemb, zemb, hint_feat, task_emb, rng=None):
        """The five residuals; `zemb` (the branch's prompt MLP of the prompt)
        and `hint_feat` (its hint encoder's output) are what no step
        changes (ControlledLegacyUNet.encode_condition)."""
        temb = swish(self.embed(gemb))
        h0 = self.conv2(xt, zemb) + hint_feat
        h1 = self.down1(h0, temb, zemb, rng)
        h2 = self.down2(h1, temb, zemb, rng)
        h3 = self.down3(h2, temb, zemb, rng)
        mid = self.middle1(h3, temb, zemb, rng)
        return tuple(getattr(self, f"zero{i}")(h, task_emb)
                     for i, h in enumerate((h0, h1, h2, h3, mid)))


class ControlledLegacyUNet(LegacyUNet):
    """LegacyUNet plus additive control residuals (the reference's
    `ControlledUnetModel`). The base modules are LegacyUNet's, drawn from
    `seed`; the control branch and the task hypernetwork from `seed + 1`.
    With `hint=None`, or at the zero-init of the control branch, the
    forward equals the plain LegacyUNet's bit for bit. `dtype` as
    LegacyUNet's. `hint_channels` and `task_index` (task name -> id) tell
    the serving engine what a request carries."""

    # an unconditional hint's meaning is not defined for the guided sampler
    REFUSED_SAMPLERS = {**LegacyUNet.REFUSED_SAMPLERS,
                        "dpm++_cfg": "its unconditional branch would need an "
                                     "unconditional hint and task, which it does not define"}
    task_index = TASKS_TO_ID

    def __init__(self, channels: Sequence[int] = (32, 64, 128, 256), hint_channels: int = 3,
                 embed_dim: int = 128, inter_dim: int = 32, only_mid_control: bool = False,
                 control_scales: Sequence[float] = (1.0,) * 5, *, device=None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__(channels, embed_dim, inter_dim, device=device, seed=seed, dtype=dtype)
        self.hint_channels = hint_channels
        self.only_mid_control = only_mid_control
        self.control_scales = tuple(control_scales)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + 1)
            self.task_hypernet = TaskHypernet(4 * channels[0], dtype=dtype)
            self.control = ControlBranch(channels, hint_channels, embed_dim, inter_dim, dtype)
        names = sorted(TASKS_TO_ID, key=TASKS_TO_ID.get)
        self.register_buffer("task_features",
                             torch.as_tensor(np.stack([task_feature(n) for n in names])))
        self.to(self.device)
        self.eval()

    def encode_condition(self, pan, ms, prompt_emb, *, hint=None, task=None, task_feat=None):
        """LegacyUNet's cache (the base's embedding MLP under no_grad, as
        in `forward`) and, with a hint, the task embedding `task_emb`, the
        control branch's prompt MLP `control_zemb` and the hint encoder's
        output `hint_feat`. `hint` (B, H, W, hint_channels); `task` an int
        id for the batch or one id per row; `task_feat` the 768-d task
        feature(s) in place of the `task_features` rows."""
        if hint is None and (task is not None or task_feat is not None):
            raise ValueError("a task without a hint: pass hint= with it")
        with torch.no_grad():
            cache = LegacyUNet.encode_condition(self, pan, ms, prompt_emb)
        if hint is None:
            return cache
        if task is None:
            raise ValueError("hint conditioning needs a task: an id of TASKS_TO_ID, or one "
                             "per row")
        if isinstance(task, (int, np.integer)):
            task, ids = int(task), [int(task)]
        else:
            ids = (task.tolist() if torch.is_tensor(task) else np.asarray(task).tolist())
            if len(ids) != ms.shape[0]:
                raise ValueError(f"{len(ids)} task ids for a batch of {ms.shape[0]}")
            task = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        if task_feat is None:
            task_feat = self.task_features[task]
        task_emb = self.task_hypernet(torch.as_tensor(task_feat, dtype=torch.float32,
                                                      device=self.device).to(self.dtype))
        with profiling.span("sample.hint", rows=int(ms.shape[0]), tasks=len(set(ids))):
            hint_feat = self.control.hint(hint, task, task_emb)
        cache.update(task_emb=task_emb, hint_feat=hint_feat,
                     control_zemb=swish(self.control.embed2(cache["prompt"])))
        return cache

    def denoise(self, x_t, t, cache, *, train: bool = False, rng=None):
        """(B, bands, H, W) float32 x0-prediction from `encode_condition`'s
        cache: the base's embeddings, encoders and middle under no_grad (the
        reference's torch.no_grad(), `cldm_unicontrol.py:72-79`), the
        control residuals where the cache holds a hint, the decoder."""
        rng = dropout_rng(train, rng)
        xt = x_t.to(self.dtype)[..., None]
        zemb = cache["zemb"]
        with torch.no_grad():
            gemb, temb = legacy_unet.time_embeds(self, t)
            c_taps, x_taps = legacy_unet.encode(self, cache["cond"], xt, temb, zemb, rng)
            h = legacy_unet.middle(self, x_taps[3], temb, zemb, rng)
        x_taps = list(x_taps)
        if "hint_feat" in cache:
            res = self.control(xt, gemb, cache["control_zemb"], cache["hint_feat"],
                               cache["task_emb"], rng)
            s = self.control_scales
            h = h + s[4] * res[4]  # `h += control.pop()`
            if not self.only_mid_control:
                x_taps = [x + s[i] * r for i, (x, r) in enumerate(zip(x_taps, res))]
        return legacy_unet.decode(self, h, c_taps, x_taps, xt, temb, zemb, rng)

    def forward(self, x_t, t, pan, ms, prompt_emb, *, hint=None, task_id=0, task_feat=None,
                train: bool = False, rng=None):
        """`denoise(encode_condition(...))`: `task_id` an int or one id per
        row, `task_feat` the 768-d feature(s) or None for `task_features`'
        rows; both are read only with a hint."""
        control = {} if hint is None else dict(hint=hint, task=task_id, task_feat=task_feat)
        cache = self.encode_condition(pan, ms, prompt_emb, **control)
        return self.denoise(x_t, t, cache, train=train, rng=rng)


# -- parameter plumbing ----------------------------------------------------------

_BASE_ENCODER_KEYS = ("embed", "embed2", "conv1", "down1_1", "down2_1", "down3_1",
                      "conv2", "down1", "down2", "down3", "middle1")
_BASE_DECODER_KEYS = ("up1", "up2", "up3", "final", "out_proj")
_CONTROL_KEYS = ("control", "task_hypernet")
# ControlBranch modules that are copies of base modules
_COPY_PAIRS = (("conv2", "conv2"), ("down1", "down1"), ("down2", "down2"),
               ("down3", "down3"), ("middle1", "middle1"), ("embed", "embed"),
               ("embed2", "embed2"))


def inject_base_params(controlled: ControlledLegacyUNet, base: LegacyUNet):
    """Copy a plain LegacyUNet's weights into the controlled model's base
    modules (the frozen-base workflow); the control modules stay as they
    are. In place; returns `controlled`."""
    for k in _BASE_ENCODER_KEYS + _BASE_DECODER_KEYS:
        getattr(controlled, k).load_state_dict(getattr(base, k).state_dict())
    return controlled


def init_control_from_base(controlled: ControlledLegacyUNet):
    """The ControlNet init recipe: the control branch's copies of the base
    modules take their weights (the zero convs stay zero). In place;
    returns `controlled`."""
    for src, dst in _COPY_PAIRS:
        getattr(controlled.control, dst).load_state_dict(getattr(controlled, src).state_dict())
    return controlled


def trainable_labels(model: ControlledLegacyUNet, *, sd_locked: bool = True) -> dict:
    """{parameter name: "train" or "freeze"}: the control branch and the
    task hypernetwork train; the base decoder trains only when not
    `sd_locked`; the base encoder never does."""
    def label_for(key):
        if key in _CONTROL_KEYS or (key in _BASE_DECODER_KEYS and not sd_locked):
            return "train"
        return "freeze"

    return {name: label_for(name.split(".")[0]) for name, _ in model.named_parameters()}


def trainable_parameters(model: nn.Module, labels: dict) -> list:
    """The parameters labelled "train", for an optimiser: the frozen ones
    are never updated."""
    return [p for name, p in model.named_parameters() if labels[name] == "train"]
