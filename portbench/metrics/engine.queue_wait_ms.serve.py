"""engine.queue_wait_ms.serve: the 90th percentile, in ms, over the
requests whose batch's sampler call began and ended in the window, of the
time from submit() to the start of that call (the program's
`engine.request` span's start and its `sampled_ns`)."""
from portbench import arith, spans


def read(record):
    batches = spans.batches_inside(record)
    waits = [(r.attrs["sampled_ns"] - r.start) / 1e6 for r in spans.named(record, "engine.request")
             if r.attrs.get("batch") in batches and "sampled_ns" in r.attrs]
    return arith.percentile(waits, 90) if waits else None
