"""k1_roofline.train: K1's share of its roofline in the window's training
steps, in percent: the least time of each step's SAME 3x3x3 conv forward
and input gradient at the global batch, counted once each on the plain
reference (remat's recompute not counted), at the configuration's peak
FLOP/s or peak bandwidth, whichever bounds it, over the device time of the
kernels named below in the window (the recompute's launches included)."""
from portbench import arith

# K1's kernels: the conv_3x3_ family (its tensor-core and FMA variants, the
# weight split and the split-K reduce), as the port's profile_request groups it
KERNELS = ("conv_3x3_",)


def read(record):
    if record.kernels is None or not record.steps:
        return None
    seconds = record.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    least = sum(arith.least_seconds(record.train_work(bands)["k1_flops"],
                                    record.train_work(bands)["k1_bytes"],
                                    record.peak_flops, record.peak_bytes)
                for bands in record.steps)
    return 100.0 * least / seconds
