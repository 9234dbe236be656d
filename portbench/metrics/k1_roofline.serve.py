"""k1_roofline.serve: K1's share of its roofline on the served batches, in
percent: the least time of the SAME 3x3x3 conv work that the batches which
began and ended in the window need (counted on the plain reference at
their bucket sizes, padded rows included), at the configuration's peak
FLOP/s or peak bandwidth, whichever bounds it, over the device time of
the kernels named below inside those batches' spans."""
from portbench import arith

# K1's kernels: the conv_3x3_ family (its tensor-core and FMA variants, the
# weight split and the split-K reduce), as the port's profile_request groups it
KERNELS = ("conv_3x3_",)


def read(record):
    if record.kernels is None:
        return None
    inside = record.batches_inside()
    spans = [(b["start"], b["end"]) for b in inside]
    seconds = record.kernel_seconds(KERNELS, spans)
    if not inside or seconds <= 0:
        return None
    least = sum(arith.least_seconds(record.serve_work(b["bucket"])["k1_flops"],
                                    record.serve_work(b["bucket"])["k1_bytes"],
                                    record.peak_flops, record.peak_bytes) for b in inside)
    return 100.0 * least / seconds
