"""engine.batch_fill.serve: the requests the engine batched in the window
over the rows of the buckets it ran (real rows plus padded ones), from the
deltas of InferenceEngine.stats, in percent."""


def read(record):
    d = record.engine_delta
    rows = d.get("requests", 0) + d.get("padded_slots", 0)
    return 100.0 * d["requests"] / rows if rows else None
