"""A search mix's knee: the highest rate at which the backlog does not
grow, found once by a sweep on the card (not run by the benchmark).

    python -m cmhbench.sweep --config dcmht-vitb32-64bit --traffic search-text-poisson \
        --seconds 50 --rates 4 4.5 5 5.5 6

One set-up, then a window at each rate: requests completed a second,
p50 and p95 latency, the generator's lateness, and the growth of the
backlog, the median latency of the window's last fifth over its first
fifth. Prints one JSON line a rate.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

from . import spec
from .common import Context
from .kinds import search
from .run import cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="a configuration of BENCHMARK.json")
    ap.add_argument("--traffic", required=True, help="a search mix of traffic/")
    ap.add_argument("--seed", type=int, default=2147483647)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    cfg = spec.config(spec.load(), args.config)
    with tempfile.TemporaryDirectory(prefix="cmhbench-") as tmp:
        ctx = Context(cfg=cfg, traffic=spec.traffic(args.traffic), limits={}, seed=args.seed,
                      seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                      started=time.time(), tmp=Path(tmp))
        with search.served(ctx) as (port, _):
            for i, rate in enumerate(args.rates):
                ctx.traffic["rate"] = rate
                res = search.window(ctx, port, search.schedule(ctx, args.seconds, 3 + i),
                                    f"rate{i}")["results"]
                lat = search.latencies_ms(res)
                fifth = max(1, len(lat) // 5)
                done = [r for r in res if r.get("status") == 200]
                row = {"rate": rate, "requests": len(res), "ok": len(done),
                       "p50_ms": search.percentile(lat, 50), "p95_ms": search.percentile(lat, 95),
                       "late_p95_ms": search.percentile([r["late_s"] * 1e3 for r in res], 95),
                       "growth": statistics.median(lat[-fifth:]) / statistics.median(lat[:fifth])}
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
