"""train.feed_wait_ms.train: the mean host span, in ms, of the window's
`next(feeder)` calls (the DeviceFeeder handing out the next staged batch)."""


def read(record):
    waits = record.spans.within("feed", record.start, record.end)
    if not waits:
        return None
    return sum(b - a for a, b in waits) / len(waits) / 1e6
