"""The rate sweep that fixes a serve mix's offered rate (run once, when the
cell is defined; not by the benchmark's runs):

    python3 -m portbench.sweep --workload <cell> --seed 7 --seconds 20 --rates 4 5 6 7 8

One process builds and warms the cell's program once, then offers each
rate in turn, an open loop of the mix's arrivals for `--seconds`, and
prints one JSON line a rate: the images returned in the window per second,
the median and 90th percentile latency from the due time, the requests
still queued when the window closed, and the share of bucket rows that
carried a request. The knee is the highest rate whose returned rate keeps
up with the offered one with no backlog."""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch

    from portbench import arith, serve, spec
    from portbench.record import Record

    parser = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    args = parser.parse_args(argv)
    cell = spec.load(args.workload, ROOT)
    engine, _, _, pool = serve.start(cell, args.seed, torch.device("cuda"))
    try:
        for rate in args.rates:
            record = Record(cell, 0.0)
            requests = serve.schedule(cell, args.seconds, args.seed,
                                      {**cell.traffic, "rate_per_s": rate})
            reqs = serve.window(engine, pool, requests, args.seconds, record, False)
            lat = [(r["done"] - r["due"]) / 1e6 if r["ok"] else math.inf for r in reqs]
            done = sum(1 for r in reqs if r["ok"] and r["done"] <= record.end)
            d = record.engine_delta
            print(json.dumps({
                "rate": rate, "img_s": done / args.seconds,
                "p50_ms": arith.percentile(lat, 50), "p90_ms": arith.percentile(lat, 90),
                "failed": sum(1 for r in reqs if not r["ok"]), "backlog": record.backlog,
                "fill": d["requests"] / max(1, d["requests"] + d["padded_slots"]),
                "batches": d["batches"]}), flush=True)
    finally:
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
