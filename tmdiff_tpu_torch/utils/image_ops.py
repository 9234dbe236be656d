"""Differentiable image filters and quality ops (port of
tmdiff_tpu/utils/image_ops.py): the kornia-style toolbox of the reference
(`utils/util.py`: filter2D, BoxBlur, the Gaussian kernel, SSIM, psnr,
Laplacian, get_edge) and the gradient operators of `core/mylib.py`
(sobel_gradient, get_hp/get_lp). All channels-last (B, H, W, C) and
differentiable. These are the loss library's filters, not the evaluation
metrics of eval/metrics_torch.py.

`filter2d` is the JAX package's depthwise XLA conv: no Pallas kernel, so it
is PyTorch's grouped conv here (ops/library_conv.py::conv_nd: cuDNN on the
card, fp32 with TF32 off, XLA's "SAME" padding, the odd pixel of an even
kernel after).
"""
from __future__ import annotations

import torch

from tmdiff_tpu_torch.ops.library_conv import conv_nd


def filter2d(x, kernel, padding: str = "SAME"):
    """Depthwise 2-D correlation of x (B, H, W, C) with a shared (kh, kw)
    kernel; padding "SAME" or "VALID"."""
    c = x.shape[-1]
    k = kernel.to(device=x.device, dtype=x.dtype)
    return conv_nd(x, k[:, :, None, None].expand(*k.shape, 1, c), padding=padding, groups=c)


def box_kernel(size: int):
    return torch.full((size, size), 1.0 / (size * size), dtype=torch.float32)


def box_blur(x, size: int = 5):
    return filter2d(x, box_kernel(size))


def gaussian_kernel1d(size: int, sigma: float):
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def gaussian_kernel2d(size: int, sigma: float):
    g = gaussian_kernel1d(size, sigma)
    return torch.outer(g, g)


def gaussian_blur(x, size: int = 5, sigma: float = 1.0):
    return filter2d(x, gaussian_kernel2d(size, sigma))


def get_lp(x, size: int = 5, sigma: float = 1.0):
    """Low-pass (Gaussian blur) component."""
    return gaussian_blur(x, size, sigma)


def get_hp(x, size: int = 5, sigma: float = 1.0):
    """High-pass component: x - blur(x)."""
    return x - gaussian_blur(x, size, sigma)


def get_edge(x, size: int = 5):
    """Box-filter high-pass (reference `utils/util.py:123-131`)."""
    return x - box_blur(x, size)


SOBEL_X = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float32)
SOBEL_Y = torch.tensor([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=torch.float32)
LAPLACIAN_K = torch.tensor([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=torch.float32)


def sobel_gradient(x):
    """(gx, gy) Sobel gradients per channel."""
    return filter2d(x, SOBEL_X), filter2d(x, SOBEL_Y)


def laplacian(x):
    return filter2d(x, LAPLACIAN_K)


def psnr(pred, target, data_range: float = 1.0):
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def ssim(pred, target, data_range: float = 1.0, window_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03):
    """Gaussian-window SSIM (the reference's torch-side variant,
    `utils/util.py:503-632`), differentiable; mean over the map."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    w = gaussian_kernel2d(window_size, sigma)
    mu_p = filter2d(pred, w, "VALID")
    mu_t = filter2d(target, w, "VALID")
    mu_pp = filter2d(pred * pred, w, "VALID")
    mu_tt = filter2d(target * target, w, "VALID")
    mu_pt = filter2d(pred * target, w, "VALID")
    var_p = mu_pp - mu_p ** 2
    var_t = mu_tt - mu_t ** 2
    cov = mu_pt - mu_p * mu_t
    s = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2))
    return torch.mean(s)


def sam_loss(pred, target, eps: float = 1e-8):
    """Differentiable spectral angle (radians) over (B, H, W, C)."""
    dot = torch.sum(pred * target, dim=-1)
    denom = torch.linalg.norm(pred, dim=-1) * torch.linalg.norm(target, dim=-1)
    cos = torch.clamp(dot / (denom + eps), -1 + 1e-7, 1 - 1e-7)
    return torch.mean(torch.arccos(cos))
