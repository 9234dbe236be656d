"""mfu.serve: model FLOPs of the batches that began and ended in the window
(counted on the plain reference at their bucket sizes, padded rows
included) over their summed sampler spans at the configuration's peak, in
percent."""


def read(record):
    inside = record.batches_inside()
    if not inside:
        return None
    flops = sum(record.serve_work(b["bucket"])["model_flops"] for b in inside)
    seconds = sum(b["end"] - b["start"] for b in inside) / 1e9
    return 100.0 * flops / (seconds * record.peak_flops)
