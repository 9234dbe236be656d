"""mfu.train: model FLOPs of the window's steps at the global batch
(forward, input and weight gradients, counted on the plain reference; no
recompute) over the window's seconds at the configuration's peak times the
cards the cell runs on, in percent."""


def read(record):
    if not record.steps:
        return None
    flops = sum(record.train_work(bands)["model_flops"] for bands in record.steps)
    cards = record.cell.workload["chips"]
    return 100.0 * flops / (record.window_s * cards * record.peak_flops)
