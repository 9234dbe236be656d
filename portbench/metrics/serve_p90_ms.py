"""serve_p90_ms: the 90th percentile, over every request due in the
window, of the time from the request's due time to its resolved future; a
refused, failed or unresolved request counts as slower than any served
one."""
import math

from portbench import arith


def read(record):
    lat = [(r["done"] - r["due"]) / 1e6 if r["ok"] else math.inf for r in record.requests]
    if not lat:
        return None
    p90 = arith.percentile(lat, 90)
    return p90 if math.isfinite(p90) else 1e9
