"""wgrad_roofline.train: the SAME 3x3x3 convs' weight gradients' share of
their roofline in the window's training steps, in percent. Work: a weight
gradient does its forward's multiply-adds over the valid taps, reads x and
dy and writes dW, the forward's bytes: half of each step's `k1_flops` and
`k1_bytes`, which count the forward and the input gradient (counted once
each on the plain reference, at the global batch). Its least time at the
configuration's peak FLOP/s or peak bandwidth, whichever bounds it, over
the device time in the window of the kernels named below: every kernel
that computes a weight gradient has `wgrad` in its name, whatever
implements it (cuDNN's `sm80_xmma_wgrad_*` and `wgrad_alg1_nd_float_engine*`,
or the port's `wgrad_3x3_tf32x3_kernel` and `wgrad_splitk_reduce_kernel`),
so every implementation is held to the same work. cuDNN's route also runs
its layout transposes `nhwcToNchwKernel` and `nchwToNhwcKernel`, which in
the training cell serve nothing but the weight gradient: they count too."""
from portbench import arith

KERNELS = ("wgrad", "nhwcToNchwKernel", "nchwToNhwcKernel")


def read(record):
    if record.kernels is None or not record.steps:
        return None
    seconds = record.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    least = sum(arith.least_seconds(record.train_work(bands)["k1_flops"] / 2,
                                    record.train_work(bands)["k1_bytes"] / 2,
                                    record.peak_flops, record.peak_bytes)
                for bands in record.steps)
    return 100.0 * least / seconds
