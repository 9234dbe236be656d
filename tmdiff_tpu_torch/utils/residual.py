"""Residual <-> image conversions: the diffusion target is Res = HR - LMS;
sampling adds the upsampled MS back."""


def img2res(img, lms):
    return img - lms


def res2img(res, lms):
    return res + lms
