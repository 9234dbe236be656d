"""Deep-image-prior utilities (port of tmdiff_tpu/utils/dip.py; the
reference's unused `utils/common_utils.py` get_noise, optimize and tv_loss):
small working library functions. Channels-last (B, H, W, C)."""
from __future__ import annotations

from typing import Callable

import torch


def get_noise(generator: torch.Generator, shape: tuple, method: str = "noise",
              noise_type: str = "u", var: float = 1.0 / 10):
    """The DIP input: uniform ("u") or normal noise times `var`, drawn from
    `generator` on its device, or a (B, H, W, 2) meshgrid of (x, y) in
    [0, 1]."""
    if method == "noise":
        draw = torch.rand if noise_type == "u" else torch.randn
        return draw(shape, generator=generator, device=generator.device) * var
    if method == "meshgrid":
        b, h, w, _ = shape
        yy, xx = torch.meshgrid(torch.linspace(0, 1, h, device=generator.device),
                                torch.linspace(0, 1, w, device=generator.device), indexing="ij")
        return torch.stack([xx, yy], dim=-1)[None].expand(b, h, w, 2)
    raise ValueError(method)


def tv_loss(x, beta: float = 0.5):
    """Total variation over (B, H, W, C)."""
    dh = (x[:, 1:, :-1] - x[:, :-1, :-1]) ** 2
    dw = (x[:, :-1, 1:] - x[:, :-1, :-1]) ** 2
    return torch.sum((dh + dw) ** beta)


def optimize(loss_fn: Callable, params, num_iter: int = 100, lr: float = 1e-2,
             optimizer: str = "adam"):
    """Minimises loss_fn(params) over a copy of the tensor `params` with
    torch.optim's Adam or SGD (optax's adam and sgd: the same defaults);
    returns (params, the loss of the last step's input), as the JAX loop."""
    p = params.detach().clone().requires_grad_(True)
    opt = {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}[optimizer]([p], lr=lr)
    loss = None
    for _ in range(num_iter):
        opt.zero_grad()
        loss = loss_fn(p)
        loss.backward()
        opt.step()
    return p.detach(), None if loss is None else loss.detach()
