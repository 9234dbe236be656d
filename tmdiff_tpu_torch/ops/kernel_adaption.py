"""Sensor-adaptive degradation operators: a learnable PSF, then subsampling
(port of tmdiff_tpu/ops/kernel_adaption.py; reference
`core/kernelAdaption.py`).

The point-spread function is a parametric Gaussian built from a learnable
2x2 lower-triangular precision factor Q (`GaussianDegradation`) or a
free-form softmax kernel (`FreePSFDegradation`). The blur is a depthwise
VALID correlation (utils/image_ops.py::filter2d: PyTorch's grouped conv,
the JAX package's XLA conv), then top-left subsampling by the scale, the
reference's `F.conv2d(...)[:, :, 0::s, 0::s]`. Channels-last (B, H, W, C).
Parameters carry the flax names (`KernelParam`, `KernelAdaption`).
"""
from __future__ import annotations

import torch
from torch import nn

from tmdiff_tpu_torch.utils.image_ops import filter2d


def gaussian_kernel_from_q(q, kernel_size: int, scale_factor: int, shift: str = "center"):
    """(k, k) Gaussian PSF from the factor Q: Sigma^-1 = (Q o mask)^T (Q o mask)."""
    mask = torch.tensor([[1.0, 0.0], [1.0, 1.0]], dtype=q.dtype, device=q.device)
    m = q * mask
    inv_sigma = m.T @ m
    if shift == "left":
        mu = kernel_size // 2 - 0.5 * (scale_factor - 1)
    elif shift == "center":
        mu = kernel_size // 2
    elif shift == "right":
        mu = kernel_size // 2 + 0.5 * (scale_factor - 1)
    else:
        raise ValueError(shift)
    r = torch.arange(kernel_size, device=q.device)
    grid = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1).to(q.dtype) - mu
    quad = torch.einsum("hwi,ij,hwj->hw", grid, inv_sigma, grid)
    raw = torch.exp(-0.5 * quad)
    return raw / torch.sum(raw)


def _blur_subsample(x, psf, scale: int):
    """x (B, H, W, C) correlated VALID with the (k, k) psf per channel,
    then [::scale, ::scale]."""
    return filter2d(x, psf, "VALID")[:, ::scale, ::scale, :]


class GaussianDegradation(nn.Module):
    """Learnable-Gaussian blur and subsample, Q initialised at 5 I."""

    def __init__(self, kernel_size: int, scale_factor: int):
        super().__init__()
        self.kernel_size, self.scale_factor = kernel_size, scale_factor
        self.KernelParam = nn.Parameter(5.0 * torch.eye(2))

    def forward(self, x):
        psf = gaussian_kernel_from_q(self.KernelParam, self.kernel_size, self.scale_factor)
        return _blur_subsample(x, psf, self.scale_factor)


class FreePSFDegradation(nn.Module):
    """Free-form softmax PSF of size (scale, scale)."""

    def __init__(self, scale_factor: int):
        super().__init__()
        self.scale_factor = scale_factor
        self.KernelAdaption = nn.Parameter(torch.randn(scale_factor, scale_factor))

    def forward(self, x):
        raw = self.KernelAdaption
        psf = torch.softmax(raw.reshape(-1), dim=0).reshape(raw.shape)
        return _blur_subsample(x, psf, self.scale_factor)
