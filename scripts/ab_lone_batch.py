"""Time a lone ``POST /check/batch`` through the daemon of one checkout of the
PyTorch port on the card, with no other client, beside the same checks
straight through the engine, on BASELINE config 3.

    python3 scripts/ab_lone_batch.py --tree . --out build/lone_change.json
    python3 scripts/ab_lone_batch.py --tree build/parent --out build/lone_parent.json

``--tree`` names the checkout whose ``keto_tpu_torch`` package is imported
(its kernels are built in that checkout), so a change and its parent run the
same requests on the same store, one process each, in one call on one card
(run parent, change, change, parent). Only entry points both checkouts
share are called: ``Daemon(namespaces, device=, tuples=, engine_options=)``
with its ``start``/``stop``, the read port's ``POST /check/batch``, and
``engine.batch_check``. So each checkout serves the batch with its own
daemon wiring: where the batcher has priority lanes, a batch-lane request
is served a sub-slice a round; where it has admission control, a post past
the admitted window answers 429 and the client sleeps its ``Retry-After``,
as the reference's SDK does.

The store and checks are chip_smoke.py's main phase (the 1M-tuple RBAC
store from its seed, its 100k checks), the engine with labels off. For
each width (``--widths``, default 16,384 and 32,768), ``--reps`` posts of
consecutive slices of the checks go back to back over one HTTP/1.1
connection. Measured, host clock:

- ``post_ms``: each admitted post, send to last byte (the JSON encode of
  the body is made before the clock starts);
- ``shed``: the 429s, with their ``Retry-After``; ``wall_s`` the whole run
  of the width, the sleeps included, and ``sustained_checks_per_s`` the
  answered checks over it;
- ``engine_ms``: ``engine.batch_check`` of the same slices, called
  directly (the same process, after the posts);
- ``slices``: the engine's stream slices each post took, where the tree
  records ``stream_slice_stats``.

Every answer is held against the analytic expectation. The card's name and
power limit go into the output beside every number. ``--device cpu
--tuples N --checks N`` makes a dry run of the script on the host.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import random
import statistics
import subprocess
import sys
import time

#: chip_smoke.py's seed and main-phase sizes
SEED = 20261017
N_TUPLES = 1_000_000
N_CHECKS = 100_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose keto_tpu_torch is measured")
    ap.add_argument("--out", required=True, help="JSON file to write")
    ap.add_argument("--widths", default="16384,32768", help="comma list of batch widths")
    ap.add_argument("--reps", type=int, default=5, help="posts a width")
    ap.add_argument("--tuples", type=int, default=N_TUPLES)
    ap.add_argument("--checks", type=int, default=N_CHECKS)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a dry run")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    widths = [int(w) for w in args.widths.split(",")]

    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("ab_lone_batch: no CUDA device is available", file=sys.stderr)
        return 2
    import keto_tpu_torch
    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.workloads import RBAC_NAMESPACES, rbac_queries, rbac_workload

    if not keto_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {keto_tpu_torch.__file__}, not the package under {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0] \
        if on_card else "host (dry run)"
    out: dict = {"tree": tree, "card": card, "torch": torch.__version__,
                 "tuples": args.tuples, "checks": args.checks}

    rng = random.Random(SEED)
    tuples, ctx = rbac_workload(rng, args.tuples)
    queries, expected = rbac_queries(rng, args.checks, ctx)
    d = Daemon(RBAC_NAMESPACES, device=args.device, tuples=tuples,
               engine_options={"labels_enabled": False})
    del tuples
    d.start()
    engine = d.engine
    stats = getattr(engine, "stream_slice_stats", None)
    conn = http.client.HTTPConnection("127.0.0.1", d.read.port, timeout=300)

    def post(body):
        t0 = time.perf_counter()
        conn.request("POST", "/check/batch", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw, resp.headers, (time.perf_counter() - t0) * 1e3

    def body_of(s0, n):
        return json.dumps({"tuples": [q.to_json() for q in queries[s0:s0 + n]]}).encode()

    try:
        # one small post and one engine call first: the kernels' first
        # launches and the stream controller's first observations
        st, raw, _, _ = post(body_of(0, 1024))
        if st != 200 or json.loads(raw)["results"] != expected[:1024]:
            raise SystemExit(f"warm-up post answered {st}")
        engine.batch_check(queries[:1024])
        runs = []
        for w in widths:
            starts = [(k * w) % max(1, args.checks - w) for k in range(args.reps)]
            bodies = [body_of(s0, w) for s0 in starts]
            posts, shed = [], []
            slices0 = stats.snapshot()["count"] if stats is not None else None
            t_run = time.perf_counter()
            for s0, body in zip(starts, bodies):
                while True:
                    st, raw, h, ms = post(body)
                    if st == 429:
                        ra = h.get("Retry-After")
                        shed.append((round(ms, 3), ra))
                        time.sleep(float(ra or 1))
                        continue
                    if st != 200 or json.loads(raw)["results"] != expected[s0:s0 + w]:
                        raise SystemExit(f"a {w}-tuple post at {s0} answered {st}")
                    posts.append(ms)
                    break
            wall = time.perf_counter() - t_run
            slices = (stats.snapshot()["count"] - slices0) if stats is not None else None
            eng = []
            for s0 in starts:
                t0 = time.perf_counter()
                got = engine.batch_check(queries[s0:s0 + w])
                eng.append((time.perf_counter() - t0) * 1e3)
                if list(got) != expected[s0:s0 + w]:
                    raise SystemExit(f"engine.batch_check of {w} at {s0} disagrees")
            med_post, med_eng = statistics.median(posts), statistics.median(eng)
            runs.append({
                "width": w, "reps": args.reps,
                "post_ms": [round(x, 3) for x in posts], "post_ms_median": round(med_post, 3),
                "post_checks_per_s": round(w / med_post * 1e3, 1),
                "shed": shed, "wall_s": round(wall, 3),
                "sustained_checks_per_s": round(w * len(posts) / wall, 1),
                "engine_ms": [round(x, 3) for x in eng], "engine_ms_median": round(med_eng, 3),
                "engine_checks_per_s": round(w / med_eng * 1e3, 1),
                "slices_a_post": None if slices is None else slices / len(posts),
            })
            print(json.dumps(runs[-1]), flush=True)
        out["runs"] = runs
    finally:
        conn.close()
        d.stop()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
