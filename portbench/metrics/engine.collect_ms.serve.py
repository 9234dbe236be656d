"""engine.collect_ms.serve: the mean, in ms, of the program's
`engine.collect` spans (a group's first request to its close) of the
batches whose sampler call began and ended in the window."""
from portbench import spans


def read(record):
    batches = spans.batches_inside(record)
    held = [s.end - s.start for s in spans.named(record, "engine.collect")
            if s.attrs.get("batch") in batches]
    return sum(held) / len(held) / 1e6 if held else None
