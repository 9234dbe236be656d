"""sample.batch_ms.serve: the mean host span, in ms, of the sampler calls
(Pansharpener.sample, as the engine makes them) that began and ended in
the window."""


def read(record):
    inside = record.batches_inside()
    if not inside:
        return None
    return sum(b["end"] - b["start"] for b in inside) / len(inside) / 1e6
