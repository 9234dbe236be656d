"""The benchmark's arithmetic: percentiles over all requests, a roofline's
least time, and the spread of a set of runs (the union of the device's
intervals is trace.Kernels'). Plain Python; no clock is read here."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of `values` by linear interpolation
    between closest ranks (numpy's default). A failed request enters as
    math.inf: it is slower than any served one, and a percentile that
    reaches it is inf."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def least_seconds(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the chip could take for the work: the larger of its
    operations at the peak rate and its bytes at the peak bandwidth."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def spread(values) -> float:
    """Distance between the first and third quartiles (statistics.quantiles,
    n=4) as a share of the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
