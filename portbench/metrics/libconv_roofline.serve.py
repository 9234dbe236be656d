"""libconv_roofline.serve: the library convs' share of their roofline on the
served batches, in percent: the least time of the strided, transposed and
hint conv work that the batches which began and ended in the window need
(counted by the family's `libconv_work` on the plain reference at their
bucket sizes, padded rows included, only the taps that meet the input), at
the configuration's peak FLOP/s or peak bandwidth, whichever bounds it,
over the device time of the kernels named below inside those batches'
spans. A family without `libconv_work` has no such convs: nothing to read."""
from portbench import arith

# the cuDNN kernels those convs launch on the card, as the profiler names them
# (an H100, cuDNN of torch 2.11+cu128): the implicit-GEMM `sm90_xmma_fprop_*`
# (strided and hint convs) and `sm90_xmma_dgrad_*` (transposed) kernels and
# cuDNN's layout passes (`cudnn::engines_precompiled::nchwToNhwcKernel`, ...),
# all named with "cudnn"; the grouped stems' `implicit_convolveNd_sgemm` and
# `tensorTransformGeneric`. The serving path calls cuDNN for nothing else.
KERNELS = ("cudnn", "implicit_convolveNd", "tensorTransformGeneric")


def read(record):
    count = getattr(record.cell.family, "libconv_work", None)
    if record.kernels is None or count is None:
        return None
    inside = record.batches_inside()
    spans = [(b["start"], b["end"]) for b in inside]
    seconds = record.kernel_seconds(KERNELS, spans)
    if not inside or seconds <= 0:
        return None
    least = 0.0
    for b in inside:
        key = ("libconv", b["bucket"])
        if key not in record._work:
            record._work[key] = count(record.cell.config["model"], record.cell.traffic,
                                      b["bucket"], record.elem_bytes)
        work = record._work[key]
        least += arith.least_seconds(work["libconv_flops"], work["libconv_bytes"],
                                     record.peak_flops, record.peak_bytes)
    return 100.0 * least / seconds
