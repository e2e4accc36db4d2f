"""Time the cold start of one checkout of the PyTorch port on the card: the
store load of a BASELINE configuration, the engine's first snapshot, and
the first read of the stored rows, with the host's memory after each.

    python3 scripts/ab_cold_start.py --tree . --out build/cold_change.json
    python3 scripts/ab_cold_start.py --tree build/parent --out build/cold_parent.json

``--tree`` names the checkout whose ``keto_tpu_torch`` package is imported,
so a change and its parent run the same steps on the same tuples, one
process each (the host memory is the process's own), in one call on one
card. Only entry points both checkouts share are called: the store's
``write_relation_tuples`` and ``snapshot_rows``, the engine's
``snapshot`` and ``build_info``.

The tuples are chip_smoke.py's: ``--config 4`` (the default) the deep
phase's 10M-tuple GitHub-style store, ``--config 3`` the main phase's 1M
RBAC store, each from chip_smoke's seed, written in one call. The engine
runs with labels off (the label build is not part of this measurement).
Measured, host clock:

- ``store_s``: the one write of every tuple;
- ``snapshot_s``: ``engine.snapshot()`` to a synchronized card, with the
  tree's ``build_info`` (its interning seconds; the build's path and
  phases where the tree records them);
- ``first_rows_s``: the first ``snapshot_rows()`` after the build (where a
  bulk load parked the row objects, this builds them);
- the resident memory (VmRSS) and the process's peak (``ru_maxrss``), in
  MiB, after generating the tuples, after the load, after the snapshot and
  after the first row read;
- a hash of the snapshot's host arrays (two checkouts must give the same).

The card's name and power limit go into the output beside every number.
``--device cpu --tuples N`` makes a dry run of the script on the host.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import resource
import subprocess
import sys
import time

#: chip_smoke.py's seed: config 3 draws from SEED, config 4 from SEED + 4
SEED = 20261017
TUPLES = {3: 1_000_000, 4: 10_000_000}
ARRAYS = ("raw2dev", "fwd_indptr", "fwd_indices", "sink_indptr", "sink_indices", "rev_indptr",
          "rev_indices")


def rss() -> dict:
    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return {"rss_mib": now / 1024,
            "peak_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose keto_tpu_torch is measured")
    ap.add_argument("--out", required=True, help="JSON file to write")
    ap.add_argument("--config", type=int, choices=sorted(TUPLES), default=4)
    ap.add_argument("--tuples", type=int, default=0, help="tuples (default: the config's)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a dry run")
    args = ap.parse_args(argv)
    n = args.tuples or TUPLES[args.config]
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("ab_cold_start: no CUDA device is available", file=sys.stderr)
        return 2
    import keto_tpu_torch
    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
    from keto_tpu_torch.persistence.memory import MemoryPersister
    from keto_tpu_torch import workloads

    if not keto_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {keto_tpu_torch.__file__}, not the package under {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0] \
        if on_card else "host (dry run)"
    out: dict = {"tree": tree, "card": card, "torch": torch.__version__, "config": args.config}

    t0 = time.monotonic()
    if args.config == 4:
        tuples, _ = workloads.github_workload(random.Random(SEED + 4), n)
        namespaces = workloads.GITHUB_NAMESPACES
    else:
        tuples, _ = workloads.rbac_workload(random.Random(SEED), n)
        namespaces = workloads.RBAC_NAMESPACES
    out["generate_s"] = time.monotonic() - t0
    out["tuples"] = len(tuples)
    out["after_generate"] = rss()

    nm = tns.MemoryManager(namespaces)
    store = MemoryPersister(nm)
    t0 = time.monotonic()
    store.write_relation_tuples(*tuples)
    out["store_s"] = time.monotonic() - t0
    del tuples
    out["after_store"] = rss()

    engine = TorchCheckEngine(store, nm, device=args.device, labels_enabled=False)
    t0 = time.monotonic()
    snap = engine.snapshot()
    if on_card:
        torch.cuda.synchronize()
    out["snapshot_s"] = time.monotonic() - t0
    out["build_info"] = {k: v for k, v in (engine.build_info or {}).items()
                         if isinstance(v, (int, float, str, dict))}
    out["after_snapshot"] = rss()

    t0 = time.monotonic()
    rows, _ = store.snapshot_rows()
    out["first_rows_s"] = time.monotonic() - t0
    out["rows"] = len(rows)
    del rows
    out["after_first_rows"] = rss()

    h = hashlib.sha256()
    for k in ARRAYS:
        h.update(np.ascontiguousarray(getattr(snap, k)).tobytes())
    for b in snap.buckets:
        h.update(np.ascontiguousarray(b.nbrs).tobytes())
    out["snapshot_sha256"] = h.hexdigest()[:16]
    out["nodes"], out["edges"] = int(snap.n_nodes), int(snap.n_edges)
    engine.close()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
