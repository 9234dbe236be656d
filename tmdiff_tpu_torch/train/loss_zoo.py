"""Named reference loss zoo (port of tmdiff_tpu/train/loss_zoo.py): the
experimental losses of the reference's `core/mylib.py:310-1540`
(loss_func1-32 with the 29-family variants, FLoss-FLoss5, SAMLoss, the
MWCNN dwt), held against the torch originals (tests/golden/loss_zoo.npz).
The four losses commented out upstream (loss_func11/14/19/24) are left out
there and here.

None of these is on the reference's active path (only l1/l2/smooth_l1 are);
the composable building blocks live in train/losses.py. This module keeps
the reference's exact combinations, quirks included:

  * `sobel_gradient` (mylib:253): per-channel Sobel correlation, zero
    padding;
  * `Gaussian_Blur` (mylib:292): cv2.GaussianBlur(ksize 5, sigma 2) with
    cv2's default reflect-101 border (not the zero-padded blur of
    utils/image_ops.py); its 5-tap kernel is computed here, without cv2;
  * `dwt` (mylib:1044): the MWCNN unnormalised Haar butterfly;
  * `SAMLoss` (mylib:1024): reshape semantics follow torch's NCHW
    flattening;
  * `FLoss` (mylib:817): Barlow-Twins cross-correlation with a double
    batch norm.

Image arguments are channels-last (B, H, W, C); feature arguments keep
their native shapes. Plain torch, differentiable.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tmdiff_tpu_torch.utils.image_ops import SOBEL_X, SOBEL_Y, filter2d


def _cv2_gauss_kernel():
    """cv2.getGaussianKernel(5, 2) outer itself: exp(-x^2 / 2 sigma^2) at
    x = -2..2, normalised."""
    g = torch.exp(-torch.arange(-2.0, 3.0) ** 2 / (2.0 * 2.0 ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def gaussian_blur_cv(x):
    """`Gaussian_Blur` (mylib:292): cv2.GaussianBlur((5, 5), 2) with the
    reflect-101 border, torch's "reflect" padding."""
    xp = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect").permute(0, 2, 3, 1)
    return filter2d(xp, _cv2_gauss_kernel(), padding="VALID")


def sobel_pair(x):
    return filter2d(x, SOBEL_X), filter2d(x, SOBEL_Y)


def _l1(a, b):
    return torch.mean(torch.abs(a - b))


def _pan_gradient_term(pan, out):
    """L1 gradient match of channel-mean(out) against PAN — shared by
    loss_func1/2/3/8/9."""
    out2pan = torch.mean(out, dim=-1, keepdim=True)
    px, py = sobel_pair(pan)
    ox, oy = sobel_pair(out2pan)
    return _l1(ox, px) + _l1(oy, py)


def loss_func1(ref, pan, ms, out):
    """mylib:310-336: L1(out, ms) + L1(out, ref) + PAN-gradient match."""
    return _l1(out, ms) + _l1(out, ref) + _pan_gradient_term(pan, out)


def loss_func2(ref, pan, ms, out):
    """mylib:341-368: spectral term through the cv2 Gaussian blur."""
    return (
        _l1(gaussian_blur_cv(out), ms)
        + _l1(out, ref)
        + _pan_gradient_term(pan, out)
    )


# loss_func3 (mylib:373-407) computes the identical quantity via nn.L1Loss.
loss_func3 = loss_func2


def loss_func8(pan, ms, out):
    """mylib:626-656: unsupervised (no ref) — blur-spectral + PAN gradient."""
    return _l1(gaussian_blur_cv(out), ms) + _pan_gradient_term(pan, out)


def loss_func9(pan, ms, out):
    """mylib:659-689: spectral term is CosineEmbeddingLoss(target=+1) =
    mean(1 − cosine over the channel axis)."""
    blur = gaussian_blur_cv(out)
    num = torch.sum(blur * ms, dim=-1)
    den = torch.linalg.norm(blur, dim=-1) * torch.linalg.norm(ms, dim=-1)
    cos = num / torch.clamp(den, min=1e-8)
    return torch.mean(1.0 - cos) + _pan_gradient_term(pan, out)


# -- feature-space losses ----------------------------------------------------


def scaled_dot_product(query, key):
    """mylib:558-563 (QKᵀ/√d_k, no softmax)."""
    d_k = query.shape[-1]
    return torch.matmul(query, key.transpose(-2, -1)) / math.sqrt(d_k)


def similarity_triplet_loss(anchor, positive, negative, margin: float = 12.0):
    """mylib:551-556: hinge on similarity difference (note: *similarities*,
    so positive enters with +, negative with −)."""
    distance = (
        scaled_dot_product(anchor, positive)
        - scaled_dot_product(anchor, negative)
        + margin
    )
    return torch.mean(torch.clamp(distance, min=0.0))


def gram_matrix(y):
    """mylib:565-570 on channels-last (B, H, W, C): G = FFᵀ/(C·H·W) with
    F the (C, H·W) feature matrix."""
    b, h, w, c = y.shape
    f = y.reshape(b, h * w, c).transpose(1, 2)  # (B, C, HW)
    return torch.matmul(f, f.transpose(1, 2)) / (c * h * w)


def loss_func6(ref, out, qkv, qkv_h1, margin: float = 12.0):
    """mylib:509-548: L1(out, ref) + two similarity-triplet terms +
    Gram-matrix style loss."""
    return (
        _l1(out, ref)
        + similarity_triplet_loss(*qkv, margin=margin)
        + similarity_triplet_loss(*qkv_h1, margin=margin)
        + _l1(gram_matrix(out), gram_matrix(ref))
    )


def sam_loss(t1, t2):
    """`SAMLoss` (mylib:1024-1041). The reference reshapes NCHW tensors to
    (C·H, B·W-ish) rows and takes per-column cosine; replicated exactly on
    channels-last inputs by converting to NCHW flattening order."""
    def to_rows(t):
        b, h, w, c = t.shape
        nchw = t.permute(0, 3, 1, 2).reshape(b, c, h, w)
        return nchw.reshape(c * h, -1) if b == 1 else nchw.reshape(
            nchw.shape[1] * nchw.shape[2], -1
        )

    a, b_ = to_rows(t1), to_rows(t2)
    n1 = torch.sqrt(torch.sum(a ** 2, dim=0))
    n2 = torch.sqrt(torch.sum(b_ ** 2, dim=0))
    cos = torch.sum(a * b_, dim=0) / (n1 * n2 + 1e-10)
    return torch.mean((cos - 1.0) ** 2)


def dwt_mwcnn(x):
    """`dwt` (mylib:1044-1070): unnormalised Haar butterfly, channels-last.
    x1..x4 use the reference's (row, col) parity convention."""
    x1 = x[:, 0::2, 0::2, :]
    x2 = x[:, 1::2, 0::2, :]
    x3 = x[:, 0::2, 1::2, :]
    x4 = x[:, 1::2, 1::2, :]
    ll = x1 + x2 + x3 + x4
    lh = -x1 - x3 + x2 + x4
    hl = -x1 + x3 - x2 + x4
    hh = x1 - x3 - x2 + x4
    return ll, lh, hl, hh


def loss_func22(ref, out):
    """mylib:1072-1096: L1(ref, out) + 0.1·SAM(LL) + 0.5·L1(high bands)."""
    r = dwt_mwcnn(ref)
    o = dwt_mwcnn(out)
    loss_l = sam_loss(r[0], o[0])
    rh = torch.cat(r[1:], dim=-1)
    oh = torch.cat(o[1:], dim=-1)
    return _l1(ref, out) + 0.1 * loss_l + 0.5 * _l1(rh, oh)


def _off_diagonal(x):
    n = x.shape[0]
    return x.reshape(-1)[:-1].reshape(n - 1, n + 1)[:, 1:].reshape(-1)


def _bn(x, eps: float = 1e-5):
    """BatchNorm1d(affine=False) in train mode: per-feature batch stats
    (biased variance, torch semantics)."""
    mean = torch.mean(x, dim=0)
    var = torch.var(x, dim=0, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def floss(f1, f2, w1, b1, w2, b2, lambd: float = 1.0):
    """`FLoss` (mylib:817-850), functional: Barlow-Twins-style
    cross-correlation between two projected feature batches. f1/f2 are
    (B, C, M, N)-flattened features (any trailing layout — flattened
    row-major like torch.reshape); w/b are the two Linear projections."""
    f1 = f1.reshape(f1.shape[0], -1)
    f2 = f2.reshape(f2.shape[0], -1)
    p1 = _bn(f1 @ w1.T + b1)
    p2 = _bn(f2 @ w2.T + b2)
    c = _bn(p1).T @ _bn(p2)
    on_diag = torch.sum((torch.diagonal(c) - 1.0) ** 2)
    off_diag = torch.sum(_off_diagonal(c) ** 2)
    return on_diag + lambd * off_diag


# -- the remaining named combinations ----------------------------------------
# Dead upstream (commented out in mylib.py, cannot run): loss_func11 (:755),
# loss_func14 (:797, needs an absent FFL import), loss_func19 (:970),
# loss_func24 (:1170). Everything else below is live-runnable upstream and
# golden-pinned (tests/golden/loss_zoo.npz).


def loss_func4(ref, pan, ms, out, qkv, margin: float = 12.0):
    """mylib:410-449: loss_func2's three terms + one similarity triplet."""
    return loss_func2(ref, pan, ms, out) + similarity_triplet_loss(
        *qkv, margin=margin
    )


def loss_func5(ref, out, qkv, margin: float = 12.0):
    """mylib:467-491: L1(out, ref) + similarity triplet."""
    return _l1(out, ref) + similarity_triplet_loss(*qkv, margin=margin)


def loss_func7(ref, out, qkv, qkv_h2, qkv_h1, margin: float = 12.0):
    """mylib:572-603: L1 + THREE triplet terms (full/h2/h1) + Gram style."""
    return (
        _l1(out, ref)
        + similarity_triplet_loss(*qkv, margin=margin)
        + similarity_triplet_loss(*qkv_h2, margin=margin)
        + similarity_triplet_loss(*qkv_h1, margin=margin)
        + _l1(gram_matrix(out), gram_matrix(ref))
    )


def l3_loss(a, b):
    """mylib:745-752 (`loss_func10`): mean(|a−b| · (a−b)²) — an odd-power
    penalty between L2 and L4 the author calls loss_func10."""
    d = a - b
    return torch.mean(torch.abs(d) * torch.square(d))


loss_func10 = l3_loss


def loss_func12(out_l, out_h, ms_l, pan_h):
    """mylib:772-781: l3 penalty on the low band vs MS and high band vs PAN
    (a frequency-separated reconstruction objective)."""
    return l3_loss(pan_h, out_h) + l3_loss(ms_l, out_l)


def loss_func13(out_l, out_h, ms_l, pan_h):
    """mylib:784-794: L1 version of loss_func12."""
    return _l1(pan_h, out_h) + _l1(ms_l, out_l)


def loss_func15(ref, out, pc_2, mc_2, fl_params, lambd: float = 0.005):
    """mylib:853-867: L1(ref, out) + FLoss on the level-2 low latents.
    `fl_params` = (w1, b1, w2, b2) of the FLoss projections."""
    return _l1(ref, out) + floss(pc_2, mc_2, *fl_params, lambd=lambd)


def loss_func16(ref, out, pc_2, mc_2, fl_params, lambd: float = 0.005):
    """mylib:871-885: weighted variant, FLoss scaled by /4096."""
    return 0.7 * _l1(ref, out) + 0.3 * floss(
        pc_2, mc_2, *fl_params, lambd=lambd
    ) / 4096.0


def loss_func17(ref, out, pgc_2, mgc_2, pgc_1, mgc_1, fl_h2_params,
                fl_h1_params, lambd: float = 0.005):
    """mylib:889-907: L1 + FLoss on BOTH high-frequency latent levels."""
    return (
        _l1(ref, out)
        + floss(pgc_1, mgc_1, *fl_h1_params, lambd=lambd) / 4096.0
        + floss(pgc_2, mgc_2, *fl_h2_params, lambd=lambd) / 4096.0
    )


def loss_func18(ref, out, pc_2, mc_2, pgc_2, mgc_2, pgc_1, mgc_1,
                fl_l_params, fl_h2_params, fl_h1_params, lambd: float = 0.005):
    """mylib:911-931: L1 + FLoss on the low level AND both high levels."""
    return (
        _l1(ref, out)
        + floss(pc_2, mc_2, *fl_l_params, lambd=lambd) / 4096.0
        + floss(pgc_1, mgc_1, *fl_h1_params, lambd=lambd) / 4096.0
        + floss(pgc_2, mgc_2, *fl_h2_params, lambd=lambd) / 4096.0
    )


def floss2(f1, f2, w1, b1, w2, b2, lambd: float = 1.0):
    """`FLoss2` (mylib:935-967): like floss but the cross-correlation is
    across the BATCH axis (c = bn(p1) @ bn(p2).T, a B×B matrix — "data and
    data similar") and the diagonal/off-diagonal terms are MEANS not sums."""
    f1 = f1.reshape(f1.shape[0], -1)
    f2 = f2.reshape(f2.shape[0], -1)
    p1 = _bn(f1 @ w1.T + b1)
    p2 = _bn(f2 @ w2.T + b2)
    c = _bn(p1) @ _bn(p2).T
    on_diag = torch.mean((torch.diagonal(c) - 1.0) ** 2)
    off_diag = torch.mean(_off_diagonal(c) ** 2)
    return on_diag + lambd * off_diag


def floss3(f1, f2, p1_params, p2_params, lambd: float = 1.0,
           negative_slope: float = 0.2):
    """`FLoss3` (mylib:1129-1167): FLoss2 with 2-layer MLP projections
    (Linear → BatchNorm1d(no affine) → LeakyReLU(0.2) → Linear).
    `pX_params` = (wa, ba, wb, bb)."""

    def mlp(f, wa, ba, wb, bb):
        h = _bn(f @ wa.T + ba)
        h = torch.where(h >= 0, h, negative_slope * h)
        return h @ wb.T + bb

    f1 = f1.reshape(f1.shape[0], -1)
    f2 = f2.reshape(f2.shape[0], -1)
    q1 = _bn(mlp(f1, *p1_params))
    q2 = _bn(mlp(f2, *p2_params))
    c = _bn(q1) @ _bn(q2).T
    on_diag = torch.mean((torch.diagonal(c) - 1.0) ** 2)
    off_diag = torch.mean(_off_diagonal(c) ** 2)
    return on_diag + lambd * off_diag


def floss4(v1, v2, lambd: float = 0.005):
    """`FLoss4` (mylib:1191-1200): parameter-free cross-correlation on
    already-projected latents, batch axis (c = v1 @ v2.T)."""
    c = v1 @ v2.T
    return torch.mean((torch.diagonal(c) - 1.0) ** 2) + lambd * torch.mean(
        _off_diagonal(c) ** 2
    )


def floss5(v1, v2, lambd: float = 0.005):
    """`FLoss5` (mylib:1204-1211): feature-axis variant (c = v1.T @ v2)."""
    c = v1.T @ v2
    return torch.mean((torch.diagonal(c) - 1.0) ** 2) + lambd * torch.mean(
        _off_diagonal(c) ** 2
    )


def loss_func20(ref, out, ms_2, out_2):
    """mylib:990-1003: L1 at full res + L1 at the level-2 pyramid."""
    return _l1(ref, out) + _l1(ms_2, out_2)


def loss_func21(ref, out, ms_2, out_2, ms_1, out_1):
    """mylib:1006-1020: loss_func20 + the level-1 pyramid term."""
    return _l1(ref, out) + _l1(ms_2, out_2) + _l1(ms_1, out_1)


def loss_func23(ref, out, ms_2, out_2):
    """mylib:1099-1125: loss_func22's wavelet terms (0.1·SAM(LL) +
    0.3·L1(high)) + full-res L1 + 0.5·pyramid L1."""
    r = dwt_mwcnn(ref)
    o = dwt_mwcnn(out)
    rh = torch.cat(r[1:], dim=-1)
    oh = torch.cat(o[1:], dim=-1)
    return (
        _l1(ref, out)
        + 0.1 * sam_loss(r[0], o[0])
        + 0.3 * _l1(rh, oh)
        + 0.5 * _l1(ms_2, out_2)
    )


def loss_func25(ref, out, pan_, out_pan, ms_, out_ms):
    """mylib:1214-1230: L1 + 1e-4·FLoss4 on both modality latent pairs."""
    return (
        _l1(out, ref)
        + 1e-4 * floss4(ms_, out_ms)
        + 1e-4 * floss4(pan_, out_pan)
    )


def loss_func26(ref, out, pan_, out_pan, ms_, out_ms):
    """mylib:1233-1255: L1 + 0.5·L1(ms latents) + 0.1·L1(pan latents).
    (The reference's internal variable names are swapped; weights follow the
    arithmetic, not the names.)"""
    return _l1(out, ref) + 0.5 * _l1(ms_, out_ms) + 0.1 * _l1(pan_, out_pan)


def loss_func27(ref, out, pan_, out_pan, ms_, out_ms):
    """mylib:1258-1280: as loss_func26 with both weights 0.1."""
    return _l1(out, ref) + 0.1 * _l1(ms_, out_ms) + 0.1 * _l1(pan_, out_pan)


def loss_func28(ref, out, panl_latent, msl_latent):
    """mylib:1284-1295: 10·L1 + 0.1·FLoss4 on the low latents."""
    return 10.0 * _l1(ref, out) + 0.1 * floss4(panl_latent, msl_latent)


def loss_func29(ref, out, panl, msl, panl1, msl1):
    """mylib:1299-1314: L1 + 20·(FLoss4(l) + FLoss4(ll))."""
    return _l1(ref, out) + 20.0 * (floss4(panl1, msl1) + floss4(panl, msl))


def loss_func29_h(ref, out, panh, msh, panlh, mslh):
    """mylib:1318-1332: L1 + 50·(FLoss4(h) + FLoss4(lh))."""
    return _l1(ref, out) + 50.0 * (floss4(panh, msh) + floss4(panlh, mslh))


def loss_func29_h_3(ref, out, panh, msh, panlh, mslh, panllh, msllh):
    """mylib:1335-1352: L1 + 20·(h + lh + llh) FLoss4 terms."""
    return _l1(ref, out) + 20.0 * (
        floss4(panh, msh) + floss4(panlh, mslh) + floss4(panllh, msllh)
    )


def loss_func29_lh(ref, out, panl1, msl1, panl, msl, panh, msh, panlh, mslh):
    """mylib:1356-1377: L1 + 20·(h + lh + l + ll) FLoss4 terms."""
    return _l1(ref, out) + 20.0 * (
        floss4(panh, msh) + floss4(panlh, mslh)
        + floss4(panl1, msl1) + floss4(panl, msl)
    )


def loss_func29_c(ref, out, panl, msl, panl1, msl1):
    """mylib:1382-1396: L1 + 0.1·FLoss4(l) + 1·FLoss4(ll)."""
    return _l1(ref, out) + 0.1 * floss4(panl1, msl1) + floss4(panl, msl)


def loss_func29_3layer(ref, out, panl, msl, panll, msll, panlll, mslll):
    """mylib:1399-1414: L1 + 0.1·FLoss4(l) + FLoss4(ll) + FLoss4(lll)."""
    return (
        _l1(ref, out)
        + 0.1 * floss4(panl, msl)
        + floss4(panll, msll)
        + floss4(panlll, mslll)
    )


def loss_func29_a(ref, out, panl, msl, panl1, msl1):
    """mylib:1417-1431: plain-L1 ablation of loss_func29."""
    return _l1(ref, out) + _l1(panl1, msl1) + _l1(panl, msl)


def loss_func29_1(ref, out, panl, msl, panl1, msl1):
    """mylib:1435-1448: loss_func29_c with the FLoss5 (feature-axis)
    correlation."""
    return _l1(ref, out) + 0.1 * floss5(panl1, msl1) + floss5(panl, msl)


def loss_func30(ref, out, panl, msl, panl1, msl1):
    """mylib:1452-1464: L1 + 0.1·FLoss4(h1) + 0.1·FLoss4(h2)."""
    return _l1(ref, out) + 0.1 * floss4(panl1, msl1) + 0.1 * floss4(panl, msl)


def loss_func31(ref, out, panll, msll, panl, msl, panh2, msh2, panh1, msh1):
    """mylib:1468-1486: L1 + 0.1·FLoss4 on all four latent pairs."""
    return _l1(ref, out) + 0.1 * (
        floss4(panh1, msh1) + floss4(panh2, msh2)
        + floss4(panl, msl) + floss4(panll, msll)
    )


def loss_func32(ref, out, panh, msh, panlh, mslh):
    """mylib:1517-1548: L1 + L1 on both MWCNN-DWT bands + 20·(FLoss4(h) +
    FLoss4(lh))."""
    r = dwt_mwcnn(ref)
    o = dwt_mwcnn(out)
    rh = torch.cat(r[1:], dim=-1)
    oh = torch.cat(o[1:], dim=-1)
    return (
        _l1(ref, out)
        + _l1(rh, oh)
        + _l1(r[0], o[0])
        + 20.0 * (floss4(panh, msh) + floss4(panlh, mslh))
    )


LOSS_ZOO = {
    "loss_func1": loss_func1,
    "loss_func2": loss_func2,
    "loss_func3": loss_func3,
    "loss_func4": loss_func4,
    "loss_func5": loss_func5,
    "loss_func6": loss_func6,
    "loss_func7": loss_func7,
    "loss_func8": loss_func8,
    "loss_func9": loss_func9,
    "loss_func10": loss_func10,
    "loss_func12": loss_func12,
    "loss_func13": loss_func13,
    "loss_func15": loss_func15,
    "loss_func16": loss_func16,
    "loss_func17": loss_func17,
    "loss_func18": loss_func18,
    "loss_func20": loss_func20,
    "loss_func21": loss_func21,
    "loss_func22": loss_func22,
    "loss_func23": loss_func23,
    "loss_func25": loss_func25,
    "loss_func26": loss_func26,
    "loss_func27": loss_func27,
    "loss_func28": loss_func28,
    "loss_func29": loss_func29,
    "loss_func29_h": loss_func29_h,
    "loss_func29_h_3": loss_func29_h_3,
    "loss_func29_lh": loss_func29_lh,
    "loss_func29_c": loss_func29_c,
    "loss_func29_3layer": loss_func29_3layer,
    "loss_func29_a": loss_func29_a,
    "loss_func29_1": loss_func29_1,
    "loss_func30": loss_func30,
    "loss_func31": loss_func31,
    "loss_func32": loss_func32,
    "sam_loss": sam_loss,
    "floss": floss,
    "floss2": floss2,
    "floss3": floss3,
    "floss4": floss4,
    "floss5": floss5,
    "similarity_triplet_loss": similarity_triplet_loss,
    "l3_loss": l3_loss,
}
