"""step.host_ms.train: the host's work of the compiled step outside its
replay, the program's `step.copy_in`, `step.begin` and `step.end` spans in
the window, in ms a window step."""
from portbench import spans


def read(record):
    return spans.per_step_ms(record, ["step.copy_in", "step.begin", "step.end"])
