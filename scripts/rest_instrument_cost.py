"""Time what the observability instruments add to one REST request of the
PyTorch port, in one process on one engine: ``RestApp.handle`` of the read
port with no instruments (``bare``: ``NullMetricsRegistry``, the ``NOOP``
tracer, a timeline recorder with no readers, the engine's slice mirror
detached) against the daemon's full wiring (``full``: its metrics registry
with every bridge, a ``memory`` tracer, the recorder's stage spans and stage
histogram, the slice mirror), with three wirings between them that add one
instrument at a time: ``metrics`` (the registry: the request counter and
histogram), ``span`` (and the request span), ``stage_spans`` (and the
recorder's stage spans).

    python3 scripts/rest_instrument_cost.py --out build/instrument_cost.json
    python3 scripts/rest_instrument_cost.py --device cpu --tuples 20000 --rounds 4 --requests 50 --out /tmp/ic.json

The store and checks are chip_smoke.py's main phase (the 1M-tuple RBAC
store from its seed, its checks) behind ``Daemon`` on the card. Every app
serves the daemon's store and batcher, so a ``GET /check`` waits for the
same device answer either way. Each of ``--rounds`` rounds runs a block of
``--requests`` sequential calls on each wiring, the order rotated by one
each round, so a drift of the host cancels across rounds. Two routes are
timed: ``GET /check`` (the batcher and the card) and ``GET /version`` (the
middleware alone, no device work). Measured, host clock, per call:
``handle`` from entry to return. Reported per route and wiring: each
block's median and mean µs, the median of the block medians, and each
round's difference to ``bare`` of the block medians (median, min, max over
the rounds). Every ``/check`` answer is held against the analytic
expectation. The card's name and power limit go into the output beside
the numbers.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path
from urllib.parse import parse_qs

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

#: chip_smoke.py's seed and main-phase store size
SEED = 20261017
N_TUPLES = 1_000_000


def _block(app, calls) -> list[float]:
    """One block: each call's ``handle`` time in µs; raises on a wrong answer."""
    out = []
    for path, query, want in calls:
        t0 = time.perf_counter_ns()
        status, _, _ = app.handle("GET", path, query, b"", {})
        out.append((time.perf_counter_ns() - t0) / 1e3)
        if status != want:
            raise SystemExit(f"GET {path} {query} answered {status}, expected {want}")
    return out


def _summary(blocks: dict[str, list[dict]]) -> dict:
    """Per wiring: its blocks, the median of their medians, and each round's
    block median minus ``bare``'s (median, min, max over the rounds)."""
    out = {}
    for name, rows in blocks.items():
        diff = [r["median_us"] - b["median_us"] for r, b in zip(rows, blocks["bare"])]
        out[name] = {
            "blocks": rows,
            "median_us": statistics.median(r["median_us"] for r in rows),
            "minus_bare_us": {"median": statistics.median(diff), "min": min(diff),
                              "max": max(diff)},
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="JSON file to write")
    ap.add_argument("--rounds", type=int, default=12, help="blocks of each wiring a route")
    ap.add_argument("--requests", type=int, default=300, help="calls a block")
    ap.add_argument("--tuples", type=int, default=N_TUPLES)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a dry run")
    args = ap.parse_args(argv)

    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("rest_instrument_cost: no CUDA device is available", file=sys.stderr)
        return 2
    from keto_tpu_torch.driver import observability as obs
    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.servers.rest import READ, RestApp
    from keto_tpu_torch.workloads import RBAC_NAMESPACES, rbac_queries, rbac_workload
    from keto_tpu_torch.x.timeline import TimelineRecorder
    from keto_tpu_torch.x.tracing import NOOP

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0] \
        if on_card else "host (dry run)"
    print(card, flush=True)
    n_calls = (args.rounds + 1) * args.requests * 5
    rng = random.Random(SEED)
    tuples, ctx = rbac_workload(rng, args.tuples)
    queries, expected = rbac_queries(rng, n_calls, ctx)
    d = Daemon(RBAC_NAMESPACES, device=args.device, tuples=tuples, tracing_provider="memory")
    del tuples
    d.start()
    out: dict = {"card": card, "torch": torch.__version__, "tuples": args.tuples,
                 "rounds": args.rounds, "requests": args.requests}
    try:
        d.engine.labels_settled()
        tracer, metrics = d.tracer, d.metrics

        def recorder(stage_spans):
            r = TimelineRecorder()
            if stage_spans:
                r.set_tracer(tracer)
            return r

        def app(rec, m=None, tr=NOOP):
            return RestApp(READ, d.store, d.batcher, recorder=rec, monitor=d.monitor,
                           metrics=m, tracer=tr, slo=d.slo, logger=d.logger)

        slices = d.engine.stream_slice_stats
        mirror = obs.stream_slice_histogram(metrics)
        # name: (app, the slice mirror while it serves)
        wirings = {
            "bare": (app(recorder(False)), None),
            "metrics": (app(recorder(False), metrics), None),
            "span": (app(recorder(False), metrics, tracer), None),
            "stage_spans": (app(recorder(True), metrics, tracer), None),
            "full": (app(d.recorder, metrics, tracer), mirror),
        }
        names = list(wirings)

        def check_calls(k):
            s0 = k * args.requests
            return [("/check", parse_qs(queries[i].to_url_query()), 200 if expected[i] else 403)
                    for i in range(s0, s0 + args.requests)]

        def version_calls(_k):
            return [("/version", {}, 200)] * args.requests

        for route, calls_of in (("GET /check", check_calls), ("GET /version", version_calls)):
            k = 0
            for name in names:  # warm-up, one block each
                a, hist = wirings[name]
                slices.attach_histogram(hist)
                _block(a, calls_of(k))
                k += 1
            blocks: dict = {name: [] for name in names}
            for r in range(args.rounds):
                for name in names[r % len(names):] + names[:r % len(names)]:
                    a, hist = wirings[name]
                    slices.attach_histogram(hist)
                    us = _block(a, calls_of(k))
                    k += 1
                    blocks[name].append({"median_us": statistics.median(us),
                                         "mean_us": statistics.fmean(us)})
            slices.attach_histogram(mirror)
            out[route] = s = _summary(blocks)
            print(route + ": " + ", ".join(
                f"{n} {s[n]['median_us']:.1f} µs ({json.dumps(s[n]['minus_bare_us'])} over bare)"
                for n in names), flush=True)
        out["spans_kept"] = len(tracer.finished)
    finally:
        d.stop()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
