"""The spread of a set of runs, as a cell's bounds are set from it:

    python3 -m portbench.spreads result-1.json result-2.json ...

Each file holds a run's standard output (its last line is the result).
For every metric it prints the runs' median, their spread (the distance
between the first and third quartiles over the median) and the spread
with the run farthest from the median left out (how a check reads
tightness), and which runs came out not correct."""
from __future__ import annotations

import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def without_farthest(values: list) -> list:
    med = statistics.median(values)
    rest = list(values)
    rest.remove(max(values, key=lambda v: abs(v - med)))
    return rest


def main(argv=None) -> int:
    from portbench import arith

    paths = sys.argv[1:] if argv is None else argv
    by_metric: dict = {}
    for path in paths:
        with open(path) as f:
            line = json.loads(f.read().splitlines()[-1])
        if not line["correct"]:
            print(f"{path}: not correct: {line['check']}")
        for name, m in line["metrics"].items():
            by_metric.setdefault(name, []).append(m["value"])
    for name, values in sorted(by_metric.items()):
        if len(values) < 4:
            print(f"{name}: {len(values)} runs, median {statistics.median(values)!r}")
            continue
        print(f"{name}: {len(values)} runs, median {statistics.median(values)!r}, spread "
              f"{arith.spread(values)!r}, without the farthest "
              f"{arith.spread(without_farthest(values))!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
