"""device.idle.serve: the share of the window, in percent, in which no
operation ran on the device (the union of the traced operations'
intervals)."""


def read(record):
    if record.kernels is None:
        return None
    return 100.0 * (1.0 - record.kernels.busy_seconds(record.start, record.end)
                    / record.window_s)
