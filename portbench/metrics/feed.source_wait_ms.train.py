"""feed.source_wait_ms.train: the program's `feed.source` spans in the
window (DeviceFeeder waiting for its next item from the Prefetcher), in ms
a window step."""
from portbench import spans


def read(record):
    return spans.per_step_ms(record, ["feed.source"])
