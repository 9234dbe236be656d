"""Pansharpening quality metrics, numpy (port of tmdiff_tpu/eval/metrics.py,
whose conventions it keeps: those of the reference's numpy suite).

  * images are (H, W, C) float arrays; reduced-resolution (RR) metrics
    compare against ground truth, full-resolution (FR) metrics are
    no-reference (D_lambda, D_s, QNR);
  * SAM in degrees with NaN pixels zeroed;
  * ERGAS with ratio 0.25 and per-band RMSE normalised by the predicted
    band's mean, as the reference does;
  * SSIM with skimage's `structural_similarity` defaults (uniform 7x7
    window, K1 = 0.01, K2 = 0.03, unbiased covariance, border crop),
    written out here;
  * Q4, the quaternion quality index of 4-band data;
  * SCC as the correlation of Sobel high-pass maps (the reference's own
    SCC_numpy is broken; the JAX package implements the intended
    definition, and so does this port);
  * D_s degrades the PAN with two Gaussian pyramid steps, cv2.pyrDown's
    5-tap [1 4 6 4 1] / 16 filter with its reflect-101 border and even-row
    decimation, written here with scipy (cv2 is not a dependency).
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve, correlate1d, sobel, uniform_filter


# ---------------------------------------------------------------------------
# Reference-quality (RR) metrics
# ---------------------------------------------------------------------------


def ssim(x_true: np.ndarray, x_pred: np.ndarray, data_range: float) -> float:
    """Mean SSIM over channels, skimage-default semantics (see module doc)."""
    x_true = np.asarray(x_true, np.float64)
    x_pred = np.asarray(x_pred, np.float64)
    assert x_true.shape == x_pred.shape and x_true.ndim == 3
    win = 7
    pad = (win - 1) // 2
    np_win = win**2
    cov_norm = np_win / (np_win - 1)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def channel(a, b):
        f = lambda im: uniform_filter(im, size=win)
        ua, ub = f(a), f(b)
        uaa, ubb, uab = f(a * a), f(b * b), f(a * b)
        va = cov_norm * (uaa - ua * ua)
        vb = cov_norm * (ubb - ub * ub)
        vab = cov_norm * (uab - ua * ub)
        s = ((2 * ua * ub + c1) * (2 * vab + c2)) / (
            (ua**2 + ub**2 + c1) * (va + vb + c2)
        )
        return s[pad:-pad, pad:-pad].mean()

    return float(np.mean([channel(x_true[..., c], x_pred[..., c])
                          for c in range(x_true.shape[-1])]))


def ssim_gaussian(x_true: np.ndarray, x_pred: np.ndarray, data_range: float,
                  win: int = 11, sigma: float = 1.5) -> float:
    """SSIM with an 11 x 11 Gaussian window (sigma 1.5) over the VALID
    positions, the mean over positions and channels: the host counterpart,
    in float64, of `metrics_torch.ssim_per_image`, which the harness
    computes on the card. It is another statistic than `ssim` (a uniform
    7 x 7 window): the two differ by 4e-3 on an image halfway between the
    upsampled MS and the ground truth."""
    x_true = np.asarray(x_true, np.float64)
    x_pred = np.asarray(x_pred, np.float64)
    taps = np.exp(-((np.arange(win) - (win - 1) / 2.0) ** 2) / (2.0 * sigma ** 2))
    taps /= taps.sum()
    pad = (win - 1) // 2
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2

    def f(im):
        out = correlate1d(correlate1d(im, taps, axis=0, mode="constant"), taps, axis=1,
                          mode="constant")
        return out[pad:-pad, pad:-pad]

    mu_t, mu_p = f(x_true), f(x_pred)
    var_t = f(x_true * x_true) - mu_t ** 2
    var_p = f(x_pred * x_pred) - mu_p ** 2
    cov = f(x_true * x_pred) - mu_t * mu_p
    s = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / ((mu_p ** 2 + mu_t ** 2 + c1)
                                                     * (var_p + var_t + c2))
    return float(s.mean())


def sam(x_true: np.ndarray, x_pred: np.ndarray) -> float:
    """Spectral angle mapper in degrees, NaN-zeroed."""
    assert x_true.ndim == 3 and x_true.shape == x_pred.shape
    dot = np.sum(x_true * x_pred, axis=2)
    n1 = np.linalg.norm(x_true, axis=2)
    n2 = np.linalg.norm(x_pred, axis=2)
    with np.errstate(invalid="ignore", divide="ignore"):
        res = np.arccos(np.clip(dot / (n2 * n1), -1.0, 1.0))
    res = np.nan_to_num(res, nan=0.0)
    return float(np.mean(res) * 180.0 / np.pi)


def mpsnr(x_true: np.ndarray, x_pred: np.ndarray, data_range: float) -> float:
    vals = []
    for c in range(x_true.shape[-1]):
        mse = np.mean((x_true[..., c] - x_pred[..., c]) ** 2)
        vals.append(10 * np.log10(data_range**2 / mse))
    return float(np.mean(vals))


def rmse(ms: np.ndarray, ps: np.ndarray) -> float:
    """Root-mean-square error normalised by spatial size only
    (`RMSE_numpy:204-218` divides by H·W even for multichannel input)."""
    d = (np.asarray(ms, np.float64) - np.asarray(ps, np.float64)) ** 2
    return float(np.sqrt(np.sum(d) / (d.shape[0] * d.shape[1])))


def ergas(ms: np.ndarray, ps: np.ndarray, ratio: float = 0.25) -> float:
    m, n, d = ms.shape
    acc = 0.0
    for i in range(d):
        acc += rmse(ms[..., i], ps[..., i]) ** 2 / np.mean(ps[..., i]) ** 2
    return float(100 * ratio * np.sqrt(acc / d))


def cc(ms: np.ndarray, ps: np.ndarray) -> float:
    """Mean per-band Pearson correlation."""
    vals = []
    for i in range(ms.shape[-1]):
        a = ms[..., i].ravel()
        b = ps[..., i].ravel()
        vals.append(np.corrcoef(a, b)[0, 1])
    return float(np.mean(vals))


def scc(ms: np.ndarray, ps: np.ndarray) -> float:
    """Spatial correlation coefficient: Pearson correlation of sobel
    high-frequency components, per band, averaged. (Deviation: the reference
    implementation is broken — see module doc.)"""
    vals = []
    for i in range(ms.shape[-1]):
        a = sobel(ps[..., i], mode="constant").ravel()
        b = sobel(ms[..., i], mode="constant").ravel()
        vals.append(np.corrcoef(a, b)[0, 1])
    return float(np.mean(vals))


def q_index(a: np.ndarray, b: np.ndarray) -> float:
    """Universal quality index Q for a single band pair."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    cov = np.cov(a, b)
    m1, m2 = a.mean(), b.mean()
    d1, d2 = cov[0, 0], cov[1, 1]
    return float(4 * cov[0, 1] * m1 * m2 / ((d1 + d2) * (m1**2 + m2**2)))


def uiqc(ms: np.ndarray, ps: np.ndarray) -> float:
    """Mean per-band universal quality index (`UIQC_numpy:244-260`)."""
    return float(np.mean([q_index(ms[..., i], ps[..., i])
                          for i in range(ms.shape[-1])]))


def q4(ms: np.ndarray, ps: np.ndarray) -> float:
    """Quaternion quality index for 4-band imagery."""
    assert ms.shape[-1] == 4, "Q4 is defined for 4-band images"

    def _quat_product_columns(d1, d2c):
        # r = q1 * conj-signed q2 per pixel (vectorised over columns)
        a0, a1, a2, a3 = d1
        b0, b1, b2, b3 = d2c
        return np.stack([
            a0 * b0 - a1 * b1 - a2 * b2 - a3 * b3,
            a0 * b1 + a1 * b0 + a2 * b3 - a3 * b2,
            a0 * b2 - a1 * b3 + a2 * b0 + a3 * b1,
            a0 * b3 + a1 * b2 - a2 * b1 + a3 * b0,
        ])

    vec_ps = ps.reshape(-1, 4).T.astype(np.float64)
    vec_ms = ms.reshape(-1, 4).T.astype(np.float64)
    m1 = vec_ps.mean(axis=1)
    m2 = vec_ms.mean(axis=1)
    d1 = vec_ps - m1[:, None]
    d2 = vec_ms - m2[:, None]
    s1 = np.mean(np.sum(d1 * d1, axis=0))
    s2 = np.mean(np.sum(d2 * d2, axis=0))
    d2_conj = d2 * np.array([1.0, -1.0, -1.0, -1.0])[:, None]
    c = _quat_product_columns(d1, d2_conj).mean(axis=1)
    return float(
        4
        * np.sqrt(np.sum(m1 * m1) * np.sum(m2 * m2) * np.sum(c * c))
        / (s1 + s2)
        / (np.sum(m1 * m1) + np.sum(m2 * m2))
    )


# ---------------------------------------------------------------------------
# No-reference (FR) metrics
# ---------------------------------------------------------------------------


def d_lambda(l_ms: np.ndarray, ps: np.ndarray) -> float:
    """Spectral distortion: inter-band Q-index consistency."""
    L = ps.shape[-1]
    acc = 0.0
    for i in range(L):
        for j in range(L):
            if j != i:
                acc += abs(
                    q_index(ps[..., i], ps[..., j])
                    - q_index(l_ms[..., i], l_ms[..., j])
                )
    return float(acc / (L * (L - 1)))


_PYR_TAPS = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _pyr_down(img: np.ndarray, times: int = 2) -> np.ndarray:
    """Gaussian pyramid downsampling, cv2.pyrDown `times` times (the
    reference's degradation of the PAN): the separable 5-tap filter with a
    reflect-101 border (scipy's "mirror"), then every other row and column
    from the first, in the input's float type."""
    for _ in range(times):
        out = correlate1d(img, _PYR_TAPS, axis=0, mode="mirror")
        out = correlate1d(out, _PYR_TAPS, axis=1, mode="mirror")
        img = out[::2, ::2]
    return img


def d_s(l_ms: np.ndarray, pan: np.ndarray, ps: np.ndarray) -> float:
    """Spatial distortion: Q(ps_i, pan) vs Q(l_ms_i, degraded pan)."""
    L = ps.shape[-1]
    l_pan = _pyr_down(pan, 2)
    acc = 0.0
    for i in range(L):
        acc += abs(q_index(ps[..., i], pan) - q_index(l_ms[..., i], l_pan))
    return float(acc / L)


def qnr(l_ms, pan, ps, alpha: float = 1.0, beta: float = 1.0) -> float:
    dl = d_lambda(l_ms, ps)
    ds = d_s(l_ms, pan, ps)
    return float((1 - dl) ** alpha * (1 - ds) ** beta)


def fcc(pan: np.ndarray, ps: np.ndarray) -> float:
    """Max per-band Laplacian-highpass correlation with PAN."""
    k = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], np.float64)
    b = convolve(pan.astype(np.float64), k, mode="constant").ravel()
    vals = []
    for i in range(ps.shape[-1]):
        a = convolve(ps[..., i].astype(np.float64), k, mode="constant").ravel()
        vals.append(np.corrcoef(b, a)[0, 1])
    return float(np.max(vals))


def sf(ps: np.ndarray) -> float:
    """Spatial frequency (`SF_numpy:356-368`)."""
    rf = np.sqrt(np.mean(np.diff(ps, axis=1) ** 2))
    cf = np.sqrt(np.mean(np.diff(ps, axis=0) ** 2))
    return float(np.sqrt(rf**2 + cf**2))


def sd(ps: np.ndarray) -> float:
    """Standard deviation (`SD_numpy:371-378`)."""
    return float(np.std(ps))


def evaluate_rr(gt: np.ndarray, pred: np.ndarray, data_range: float = 1.0) -> dict:
    """Full reduced-resolution metric dict for one (H, W, C) image pair."""
    out = {
        "ssim": ssim(gt, pred, data_range),
        "sam": sam(gt, pred),
        "ergas": ergas(gt, pred),
        "psnr": mpsnr(gt, pred, data_range),
        "scc": scc(gt, pred),
        "cc": cc(gt, pred),
        "rmse": rmse(gt, pred),
        "uiqc": uiqc(gt, pred),
    }
    if gt.shape[-1] == 4:
        out["q4"] = q4(gt, pred)
    return out


def evaluate_fr(l_ms: np.ndarray, pan: np.ndarray, pred: np.ndarray) -> dict:
    """No-reference full-resolution metric dict."""
    return {
        "d_lambda": d_lambda(l_ms, pred),
        "d_s": d_s(l_ms, pan, pred),
        "qnr": qnr(l_ms, pan, pred),
        "fcc": fcc(pan, pred),
        "sf": sf(pred),
        "sd": sd(pred),
    }


def mean_scores(gts_chw, preds_chw, round_to: int | None = None) -> dict:
    """Mean SAM/ERGAS/SSIM over a prediction set, the shared scoring loop of
    the JAX package's evaluation tools, with their conventions: SAM(pred,
    gt), ERGAS(gt, pred) with the prediction's mean, predictions clipped to
    [0, 1], (C, H, W) to (H, W, C).

    gts_chw / preds_chw: equal-length sequences of (C, H, W) arrays in
    [0, 1] model space."""
    n = len(preds_chw)
    assert len(gts_chw) == n, (len(gts_chw), n)
    vals = {"sam": 0.0, "ergas": 0.0, "ssim": 0.0}
    for gt_c, pr_c in zip(gts_chw, preds_chw):
        gt = np.transpose(np.asarray(gt_c), (1, 2, 0))
        pr = np.clip(np.transpose(np.asarray(pr_c), (1, 2, 0)), 0, 1)
        vals["sam"] += sam(pr, gt) / n
        vals["ergas"] += ergas(gt, pr) / n
        vals["ssim"] += ssim(pr, gt, 1.0) / n
    if round_to is not None:
        return {k: round(v, round_to) for k, v in vals.items()}
    return vals
