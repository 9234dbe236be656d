"""feed.stage_ms.train: the program's `feed.stage` and `feed.handoff`
spans in the window (DeviceFeeder pinning the next item and issuing its
copies, then handing an item over across streams), in ms a window step."""
from portbench import spans


def read(record):
    return spans.per_step_ms(record, ["feed.stage", "feed.handoff"])
