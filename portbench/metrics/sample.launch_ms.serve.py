"""sample.launch_ms.serve: the mean host span, in ms, of a network call
(the program's `sample.denoise`) inside the sampler calls that began and
ended in the window: the host's launches of one call, and any wait for
the device inside it."""
from portbench import spans


def read(record):
    batches = {s.id for s in spans.batches_inside(record).values()}
    by_id = {s.id: s for s in spans.program_spans(record) or ()}
    held = [s.end - s.start for s in spans.named(record, "sample.denoise")
            if getattr(spans.ancestor(s, "engine.sample", by_id), "id", None) in batches]
    return sum(held) / len(held) / 1e6 if held else None
