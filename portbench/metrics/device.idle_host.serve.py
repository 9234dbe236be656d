"""device.idle_host.serve: the share of the window, in percent, in which
no operation ran on the device while the engine's worker was inside one
of its program spans other than `engine.wait` (collecting, assembling,
sampling or resolving): it had work, and the card did not."""
from portbench import spans


def read(record):
    sampled = spans.named(record, "engine.sample")
    if record.kernels is None or not sampled:
        return None
    worker = sampled[0].thread
    busy = [(s.start, s.end) for s in spans.program_spans(record)
            if s.thread == worker and s.parent == 0 and s.name != "engine.wait"]
    held = sum(min(b, record.end) - max(a, record.start) for a, b in busy
               if min(b, record.end) > max(a, record.start)) / 1e9
    idle = held - spans.busy_within(record.kernels, record.start, record.end, busy)
    return 100.0 * idle / record.window_s
