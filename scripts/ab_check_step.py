"""Time the BFS check step of one checkout of the PyTorch port on the card,
unsharded and over 4 row-range shards (K10a), on BASELINE config 3.

    python3 scripts/ab_check_step.py --tree . --out build/ab_step_change.json
    python3 scripts/ab_check_step.py --tree build/parent --out build/ab_step_parent.json

``--tree`` names the checkout whose ``keto_tpu_torch`` package is imported
(its kernels are built in that checkout), so two checkouts — a change and
its parent — run the same measurements on the same inputs, one process
each, in one call on one card. Only entry points both checkouts share are
called: the engine's snapshot (unsharded, and over a mesh of 4 shards),
``pack_chunk``/``pack_entries``, ``route_entries``, and the two steps
``kernels.check_step_cuda`` and ``sharded.check_step_cuda``.

The inputs are chip_smoke.py's main phase: the 1M-tuple RBAC store and its
100k checks, packed into one step (W = 4,096 query words), ``it_cap`` the
engine's and ``block_iters`` 8 (the engine's first). Measured for each
step, on the card:

- ms a step: the host clock around a call that ends in its own host read
  (mean of REPS, and the median of REPS calls timed alone), and CUDA events
  around REPS steps back to back (device time, each step's allocations
  included);
- the host reads one step makes (PyTorch's sync debug mode);
- the kernel launches one step makes, by name (the tree's own counters);
- the halo copies one sharded step makes: the tree's count on the card
  (``kernels.run_counts``) where it has one, else the copies its host loop
  notes (``COLLECTIVE_CALLS["all_gather"]``);
- ``iters``, ``truncated`` and a hash of the output words (two checkouts
  must give the same);
- the device µs of each kernel one unsharded and one sharded step run,
  by name, from one ``torch.profiler`` session over both (``kernels_us``;
  a process's first session is the one that sees the card).

The card's name and power limit go into the output beside every number.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261017
N_TUPLES = 1_000_000
N_CHECKS = 100_000
SHARDS = 4
BLOCK_ITERS = 8
REPS = 20


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (never the measured
    tree's): its ``host_reads``, ``whole_ms``, ``call_ms`` and ``time_ms``
    count and time here as they do in the smoke run."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_ab_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(smoke, torch, kernels, step, halo, tail: int) -> dict:
    """One step's numbers (see the module docstring); ``halo()`` reads the
    tree's halo-copy count, ``tail`` is the output's words after the
    decision bits (``iters`` is the first)."""
    out = step()
    torch.cuda.synchronize()
    words = out.cpu().numpy()
    before, copies0 = dict(kernels.COUNTS), halo()
    step()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in kernels.COUNTS.items() if v != before[k]}
    copies = halo() - copies0
    return {"ms": smoke.whole_ms(torch, lambda: step().tolist(), REPS),
            "median_ms": smoke.call_ms(torch, lambda: step().tolist(), REPS),
            "device_ms": smoke.time_ms(step, REPS),
            "host_reads": smoke.host_reads(torch, step), "launches": launched,
            "halo_copies": copies, "iters": int(words[-tail]), "truncated": int(words[1 - tail]),
            "words": int(words.size),
            "out_sha256": hashlib.sha256(words.tobytes()).hexdigest()[:16]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose keto_tpu_torch is measured")
    ap.add_argument("--out", required=True, help="JSON file to write")
    args = ap.parse_args(argv)
    smoke = _smoke()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("ab_check_step: no CUDA device is available", file=sys.stderr)
        return 2
    import keto_tpu_torch
    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.check import kernels
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
    from keto_tpu_torch.check.pack import pack_chunk, pack_entries
    from keto_tpu_torch.parallel import make_mesh
    from keto_tpu_torch.parallel import sharded as ps
    from keto_tpu_torch.persistence.memory import MemoryPersister
    from keto_tpu_torch.workloads import RBAC_NAMESPACES, rbac_queries, rbac_workload

    if not keto_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {keto_tpu_torch.__file__}, not the package under {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out: dict = {"tree": tree, "card": card, "torch": torch.__version__}

    t0 = time.monotonic()
    rng = random.Random(SEED)
    tuples, ctx = rbac_workload(rng, N_TUPLES)
    queries, _ = rbac_queries(rng, N_CHECKS, ctx)
    nm = tns.MemoryManager(RBAC_NAMESPACES)
    store = MemoryPersister(nm)
    store.write_relation_tuples(*tuples)
    del tuples
    engine = TorchCheckEngine(store, nm, device="cuda", labels_enabled=False)
    snap = engine.snapshot()
    sd, tg, multi = engine._resolve_bulk_py(snap, queries)
    packed, _ = pack_chunk(snap, sd, tg, multi, 0, len(queries))
    buf, sizes = pack_entries(packed)
    entries = torch.from_numpy(buf).cuda()
    g = snap.device
    kw = dict(sizes=sizes, n_active=g.num_active, n_int=g.num_int, valid_rows=g.valid_rows,
              it_cap=engine._it_cap, block_iters=BLOCK_ITERS)
    torch.cuda.synchronize()
    out["setup_s"] = time.monotonic() - t0
    out["shape"] = {"W": sizes[3] // 32, "n_int": g.num_int, "n_active": g.num_active,
                    "buckets": [[int(b.shape[0]), int(b.shape[1]), int(n)]
                                for b, n in zip(g.buckets, g.valid_rows)]}

    def step():
        return kernels.check_step_cuda(g.buckets, entries, **kw)

    out["step"] = measure(smoke, torch, kernels, step, lambda: 0, 2)
    print(f"step: {json.dumps(out['step'])}", flush=True)

    mesh = make_mesh(graph=SHARDS, device="cuda")
    sharded = TorchCheckEngine(store, nm, device="cuda", labels_enabled=False, mesh=mesh)
    ssnap = sharded.snapshot()
    spec = ssnap.shard_spec
    ent, ssizes = ps.route_entries(spec, packed, sizes[3])
    ent = torch.from_numpy(ent).cuda()
    skw = dict(sizes=ssizes, rps=spec.rows_per_shard, B=sizes[3], it_cap=sharded._it_cap,
               block_iters=BLOCK_ITERS)
    if hasattr(kernels, "run_counts"):
        def halo():
            return kernels.run_counts()[1]
        out["halo_counter"] = "kernels.run_counts (on the card)"
    else:
        def halo():
            return ps.COLLECTIVE_CALLS["all_gather"]
        out["halo_counter"] = "COLLECTIVE_CALLS['all_gather'] (host loop)"
    def sharded_step():
        return ps.check_step_cuda(mesh, ssnap.device_shards, ent, None, None, **skw)

    out["sharded_step"] = measure(smoke, torch, kernels, sharded_step, halo, 3)
    out["sharded_step"]["rows_per_shard"] = spec.rows_per_shard
    print(f"sharded_step: {json.dumps(out['sharded_step'])}", flush=True)
    out["kernels_us"] = smoke.device_kernels(torch, lambda: (step(), sharded_step()))
    print(f"kernels_us: {json.dumps(out['kernels_us'])}", flush=True)
    engine.close()
    sharded.close()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
