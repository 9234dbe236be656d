"""train_step_s: the window's seconds, from the first step's start to the
synchronize after the last, over the steps it ran."""


def read(record):
    return record.window_s / len(record.steps) if record.steps else None
