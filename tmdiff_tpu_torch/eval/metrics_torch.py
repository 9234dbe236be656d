"""Metrics on tensors, on the batch's device (port of
tmdiff_tpu/eval/metrics_jnp.py, the JAX package's twins of the reference's
torch metrics): batched (N, C, H, W), differentiable, so that a validation
batch is scored where it was sampled and the scores can serve as losses.

The reference's conventions are kept, quirks included:
  * `sam` converts with the literal 180 / 3.1415926, not pi;
  * `scc` takes the 8-centre omnidirectional high-pass with VALID padding,
    per band (the reference passes (N, C, H, W) to a one-channel conv,
    which fails for C > 1; per band is the only form that runs, and it
    equals the reference at C = 1);
  * `d_lambda` / `d_s` average |delta Q| over band pairs, as the QNR paper.
Batch aggregates are means over N. `ssim_per_image` is the Gaussian-window
SSIM (11 x 11, sigma 1.5, VALID) of the JAX package's image ops, one value
per image over all its channels.

The filters are written as sums of shifted slices in the input's type, so
no library convolution (which may run in TF32 on an H100) enters the
scores. These are elementwise chains and reductions that XLA fuses in the
JAX package, not Pallas kernels.
"""
from __future__ import annotations

import math

import torch

# the reference's degree conversion constant, not pi
_DEG = 180.0 / 3.1415926


def _angles(x_true, x_pred):
    dot = torch.sum(x_true * x_pred, dim=1)
    n1 = torch.linalg.vector_norm(x_true, dim=1)
    n2 = torch.linalg.vector_norm(x_pred, dim=1)
    return torch.arccos(torch.clamp(dot / n2 / n1, -1.0, 1.0))


def sam(x_true, x_pred):
    """Mean spectral angle in degrees over (N, C, H, W) batches."""
    return torch.mean(_angles(x_true, x_pred)) * _DEG


def sam_per_image(x_true, x_pred):
    """(N,) spectral angle in degrees, the mean over each image."""
    return torch.mean(_angles(x_true, x_pred), dim=(1, 2)) * _DEG


def _correlate_valid(x, taps_h, taps_w):
    """VALID 2-D correlation of (..., H, W) with the separable kernel
    outer(taps_h, taps_w), as shifted-slice sums (rows, then columns)."""
    kh, kw = len(taps_h), len(taps_w)
    h, w = x.shape[-2] - kh + 1, x.shape[-1] - kw + 1
    rows = sum(c * x[..., i:i + h, :] for i, c in enumerate(taps_h))
    return sum(c * rows[..., :, j:j + w] for j, c in enumerate(taps_w))


def _sobel8(x):
    """VALID 3x3 correlation with the 8-centre kernel [[-1, -1, -1], [-1, 8,
    -1], [-1, -1, -1]] per band: (N, C, H, W) -> (N, C, H - 2, W - 2)."""
    h, w = x.shape[-2] - 2, x.shape[-1] - 2
    box = _correlate_valid(x, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    return 9.0 * x[..., 1:1 + h, 1:1 + w] - box


def scc(x, y):
    """Mean spatial correlation of the high-pass maps: the correlation per
    (image, band) over the spatial dims, then the mean."""
    x, y = _sobel8(x), _sobel8(y)
    vx = x - torch.mean(x, dim=(2, 3), keepdim=True)
    vy = y - torch.mean(y, dim=(2, 3), keepdim=True)
    num = torch.sum(vx * vy, dim=(2, 3))
    den = torch.sqrt(torch.sum(vx * vx, dim=(2, 3))) * torch.sqrt(torch.sum(vy * vy, dim=(2, 3)))
    return torch.mean(num / den)


def q_index(a, b, eps: float = 1e-8):
    """Universal quality index over (N, H, W) single-band batches: moments
    per image, then the mean over the batch."""
    e_a, e_b = torch.mean(a, dim=(1, 2)), torch.mean(b, dim=(1, 2))
    e_a2, e_b2 = torch.mean(a * a, dim=(1, 2)), torch.mean(b * b, dim=(1, 2))
    e_ab = torch.mean(a * b, dim=(1, 2))
    var_a, var_b = e_a2 - e_a * e_a, e_b2 - e_b * e_b
    cov = e_ab - e_a * e_b
    return torch.mean(4 * cov * e_a * e_b / ((var_a + var_b) * (e_a ** 2 + e_b ** 2) + eps))


def d_lambda(l_ms, ps):
    """Spectral distortion index over (N, C, H, W)."""
    bands = ps.shape[1]
    acc = sum(torch.abs(q_index(ps[:, i], ps[:, j]) - q_index(l_ms[:, i], l_ms[:, j]))
              for i in range(bands) for j in range(bands) if j != i)
    return acc / bands / (bands - 1)


def d_s(l_ms, pan, l_pan, ps):
    """Spatial distortion index; pan and l_pan are (N, 1, H, W) and
    (N, 1, h, w)."""
    bands = ps.shape[1]
    acc = sum(torch.abs(q_index(ps[:, i], pan[:, 0]) - q_index(l_ms[:, i], l_pan[:, 0]))
              for i in range(bands))
    return acc / bands


def _gaussian_taps(size: int = 11, sigma: float = 1.5):
    g = [math.exp(-((i - (size - 1) / 2.0) ** 2) / (2.0 * sigma ** 2)) for i in range(size)]
    total = sum(g)
    return tuple(v / total for v in g)


def ssim_per_image(pred, target, data_range: float = 1.0):
    """(N,) SSIM of (N, C, H, W) batches with an 11 x 11 Gaussian window
    (sigma 1.5), VALID, K1 = 0.01, K2 = 0.03: the mean of the map over each
    image's positions and channels."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    taps = _gaussian_taps()
    f = lambda im: _correlate_valid(im, taps, taps)
    mu_p, mu_t = f(pred), f(target)
    var_p = f(pred * pred) - mu_p ** 2
    var_t = f(target * target) - mu_t ** 2
    cov = f(pred * target) - mu_p * mu_t
    s = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2))
    return torch.mean(s, dim=(1, 2, 3))
