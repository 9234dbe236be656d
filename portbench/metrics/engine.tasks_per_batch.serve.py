"""engine.tasks_per_batch.serve: the mean count of distinct tasks in a batch
(the `tasks` attribute of the program's `engine.sample` spans) over the
batches whose sampler call began and ended in the window. Nothing to read
where the spans carry no tasks."""
from portbench import spans


def read(record):
    held = [s.attrs["tasks"] for s in spans.batches_inside(record).values()
            if s.attrs.get("tasks")]
    return sum(held) / len(held) if held else None
