"""Time the label build's frontier sweeps (K6, K10c), its covered masks
(K7) and mirror flushes (K9), and the list fixpoint (K5) of one checkout of
the PyTorch port on the card, on BASELINE config 4.

    python3 scripts/ab_fixpoints.py --tree . --out build/ab_change.json
    python3 scripts/ab_fixpoints.py --tree build/parent --out build/ab_parent.json

``--tree`` names the checkout whose ``keto_tpu_torch`` package is imported
(its kernels are built in that checkout), so two checkouts — a change and
its parent — run the same measurements on the same inputs, one process
each, in one call on one card. Only entry points both checkouts share are
called: the engine's snapshot, ``device_build_labels`` (unsharded and over
a mesh of 4 shards), the two sweepers' ``sweep``, ``_compute_covered``,
``_Mirror.store``/``flush_device`` and ``list_step_cuda``.

Measured, each on the card (host clock around calls that end in a host
read; host reads counted by PyTorch's sync debug mode):

- the device label build, unsharded and sharded: seconds, entries, a
  hash of the arrays (two checkouts must build the same index), sweeps,
  and the sharded build's halo all-gathers and their bytes;
- the first forward sweep of the build's first batch (64 landmarks, no
  labels yet), run to its fixpoint by ``_Sweeper.sweep`` and by
  ``_ShardedSweeper.sweep`` over 4 shards: ms a sweep, host reads, a hash
  of the stored bitmap;
- the covered mask of a mid-build batch (64 landmarks from the middle of
  the landmark order, their own OUT rows of the built index against its IN
  rows at the build's width, as chip_smoke.py's K7 row), by
  ``_compute_covered`` as the tree's build calls it (with its reused
  lane-mask table where the tree has one): ms a call (the mean of calls
  back to back, and the median of calls timed alone), host reads, a hash;
- one mirror flush of a batch's stores (the same 64 landmarks' entries of
  the built index, both sides, stored into a fresh ``_Mirror``), replayed
  from the same pending stores: ms a flush (mean and median, as above),
  host reads, slot set launches, a hash of the device arrays;
- the list fixpoint of the first ListObjects query of the list phase
  (chip_smoke.py's), without an overlay and with a 64-row overlay made from
  the seed (half its destinations passive rows): ms a run, steps, host
  reads.

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
DEEP_TUPLES = 10_000_000
LIST_QUERIES = 200
OVERLAY_ROWS = 64
REPS = 20
SHARDS = 4


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (never the measured
    tree's): its ``label_digest``, ``host_reads`` and ``whole_ms`` count
    and time here as they do in the smoke run."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_ab_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def covered_and_flush(smoke, torch, np, label_build, idx, order, n, wt, mw) -> dict:
    """K7's ``_compute_covered`` and K9's ``_Mirror.flush_device`` of this
    tree on one mid-build batch of ``idx`` (see the module docstring)."""
    import inspect

    from keto_tpu_torch.check import kernels

    out_pad, in_pad = -1, -2
    lanes = 32 * wt
    mid = np.asarray(order[n // 2 : n // 2 + lanes], np.int64)
    lab = np.full((n + 1, mw), in_pad, np.int32)
    lab[:, : min(mw, idx.in_lab.shape[1])] = idx.in_lab[:, :mw]
    own = np.full((lanes, mw), out_pad, np.int32)
    own[:, : min(mw, idx.out_lab.shape[1])] = idx.out_lab[mid, :mw]
    lab_t = torch.from_numpy(lab).cuda()
    kw = {}
    if "table" in inspect.signature(label_build._compute_covered).parameters:
        kw["table"] = torch.zeros((n + 1, wt), dtype=torch.int32, device="cuda")

    def covered():
        return label_build._compute_covered(lab_t, own, lanes, wt, out_pad, **kw)

    res = covered()
    torch.cuda.synchronize()
    launches = kernels.COUNTS["covered"]
    reads = smoke.host_reads(torch, covered)
    r = {"covered": {
        "ms": smoke.whole_ms(torch, covered, REPS), "median_ms": smoke.call_ms(torch, covered),
        "host_reads": reads,
        "launches": kernels.COUNTS["covered"] - launches, "lanes": lanes,
        "own_entries": int((own != out_pad).sum()), "table_reused": bool(kw),
        "result_sha256": hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()[:16]}}
    print(f"covered: {json.dumps(r['covered'])}", flush=True)

    mirror = label_build._Mirror(n, mw, "cuda")
    for v in mid.tolist():
        mirror.store("out", np.array([v]), v)
        mirror.store("in", np.array([v]), v)
        mirror.store("in", np.nonzero((idx.in_lab[:n] == v).any(1))[0], v)
        mirror.store("out", np.nonzero((idx.out_lab[:n] == v).any(1))[0], v)
    pend = {k: list(v) for k, v in mirror._pending.items()}

    def flush():
        mirror._pending = {k: list(v) for k, v in pend.items()}
        mirror.flush_device()

    flush()
    torch.cuda.synchronize()
    launches = kernels.COUNTS["slot_set"]
    reads = smoke.host_reads(torch, flush)
    digest = hashlib.sha256(mirror.out_d.cpu().numpy().tobytes()
                            + mirror.in_d.cpu().numpy().tobytes()).hexdigest()[:16]
    r["flush"] = {"ms": smoke.whole_ms(torch, flush, REPS),
                  "median_ms": smoke.call_ms(torch, flush), "host_reads": reads,
                  "launches": kernels.COUNTS["slot_set"] - launches,
                  "entries": int(sum(p[0].size for v in pend.values() for p in v)),
                  "arrays_sha256": digest}
    print(f"flush: {json.dumps(r['flush'])}", flush=True)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose keto_tpu_torch is measured")
    ap.add_argument("--out", required=True, help="JSON file to write")
    args = ap.parse_args(argv)
    smoke = _smoke()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_fixpoints: no CUDA device is available", file=sys.stderr)
        return 2
    import keto_tpu_torch
    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
    from keto_tpu_torch.graph import label_build
    from keto_tpu_torch.graph.labels import interior_adjacency, landmark_order
    from keto_tpu_torch.list import gpu_engine, kernels as lk
    from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
    from keto_tpu_torch.parallel import make_mesh
    from keto_tpu_torch.parallel import sharded as ps
    from keto_tpu_torch.persistence.memory import MemoryPersister
    from keto_tpu_torch.workloads import GITHUB_NAMESPACES, github_list_queries, github_workload

    if not keto_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {keto_tpu_torch.__file__}, not the package under {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out: dict = {"tree": tree, "card": card, "torch": torch.__version__}

    t0 = time.monotonic()
    tuples, ctx = github_workload(random.Random(SEED + 4), DEEP_TUPLES)
    nm = tns.MemoryManager(GITHUB_NAMESPACES)
    store = MemoryPersister(nm)
    store.write_relation_tuples(*tuples)
    del tuples
    engine = TorchCheckEngine(store, nm, device="cuda", labels_enabled=False)
    snap = engine.snapshot()
    torch.cuda.synchronize()
    out["setup_s"] = time.monotonic() - t0
    n = snap.num_int
    wt = engine._labels_batch // 32
    build_kw = dict(max_width=engine._labels_max_width, landmarks=engine._labels_landmarks,
                    min_gain=engine._labels_min_gain, batch=engine._labels_batch, device="cuda")
    mesh = make_mesh(graph=SHARDS, device="cuda")

    # the device label build, unsharded and sharded (with the halo all-gathers
    # the sharded build counts)
    for name, kw in (("build", {}), ("sharded_build", {"mesh": mesh, "shard_count": SHARDS})):
        ps.reset_collective_counts()
        t0 = time.monotonic()
        idx, info = label_build.device_build_labels(snap, **build_kw, **kw)
        torch.cuda.synchronize()
        out[name] = {"seconds": time.monotonic() - t0, "entries": int(idx.n_entries),
                     "landmarks": int(info.landmarks), "batches": int(info.batches),
                     "sweeps": int(info.dispatches), "label_sha256": smoke.label_digest(idx),
                     "backend": idx.backend,
                     "halo_rounds": int(ps.COLLECTIVE_CALLS["all_gather"]),
                     "halo_bytes": int(ps.COLLECTIVE_BYTES["all_gather"]),
                     "covered_s": info.covered_s,
                     "flush_s": getattr(info, "flush_s", None),
                     "flushes": getattr(info, "flushes", None)}
        print(f"{name}: {json.dumps(out[name])}", flush=True)
        if name == "build":
            built = idx
        del idx

    # the first forward sweep of the build's first batch
    out_ip, out_ix, in_ip, in_ix = interior_adjacency(snap)
    order = landmark_order(out_ip, in_ip, n)
    fwd = label_build.build_ell_groups(in_ip, in_ix, n)
    bwd = label_build.build_ell_groups(out_ip, out_ix, n)
    seeds = np.asarray(order[: 32 * wt], np.int64)
    sweepers = {"sweep": label_build._Sweeper(fwd, bwd, n, "cuda"),
                "sharded_sweep": label_build._ShardedSweeper(fwd, bwd, n, mesh, SHARDS, "cuda")}
    stored = {}
    for name, sw in sweepers.items():
        cov = torch.zeros((sw._rows(), wt), dtype=torch.int32, device="cuda")
        S = sw.sweep(True, seeds, cov, wt)
        stored[name] = hashlib.sha256(np.ascontiguousarray(S).tobytes()).hexdigest()[:16]
        def call(sw=sw):
            return sw.sweep(True, seeds, cov, wt)

        out[name] = {"ms": smoke.whole_ms(torch, call, REPS),
                     "host_reads": smoke.host_reads(torch, call),
                     "stored_sha256": stored[name], "stored_bits": int(np.unpackbits(
                         S.view(np.uint8)).sum())}
        print(f"{name}: {json.dumps(out[name])}", flush=True)

    # the covered mask of a mid-build batch and one mirror flush of its stores
    out.update(covered_and_flush(smoke, torch, np, label_build, built, order, n, wt,
                                 engine._labels_max_width))
    del built

    # the list fixpoint of the list phase's first ListObjects query
    objects, _ = github_list_queries(random.Random(SEED + 5), LIST_QUERIES, ctx)
    lst = SnapshotListEngine(engine, nm, device="cuda")
    captured = []
    step = gpu_engine.list_step

    def capture(buckets, R0, ov_nbrs, ov_dst, **kw):
        captured.append((buckets, R0.clone(), ov_nbrs, ov_dst, kw))
        return step(buckets, R0, ov_nbrs, ov_dst, **kw)

    gpu_engine.list_step = capture
    try:
        lst.list_objects("issues", "view", objects[0][0])
    finally:
        gpu_engine.list_step = step
    buckets, R0, _, _, kw = captured[0]
    n_rows, n_active = R0.shape[0] - 1, kw["n_active"]
    rng = np.random.default_rng(SEED)
    half = min(OVERLAY_ROWS // 2, n_rows - n_active)
    dst = np.concatenate([rng.choice(np.arange(n_active, n_rows), size=half, replace=False),
                          rng.choice(n_active, size=OVERLAY_ROWS - half, replace=False)])
    ov_nbrs = torch.from_numpy(rng.integers(0, n_rows, size=(OVERLAY_ROWS, 4)).astype(np.int32))
    ov_dst = torch.from_numpy(dst.astype(np.int32))
    for name, ov in (("list_fixpoint", (None, None)),
                     ("list_fixpoint_overlay", (ov_nbrs.cuda(), ov_dst.cuda()))):
        def run(ov=ov):
            return lk.list_step_cuda(buckets, R0, *ov, **kw)

        before = lk.COUNTS["list_iters"]
        R = run()
        steps = lk.COUNTS["list_iters"] - before
        reads = smoke.host_reads(torch, run)
        out[name] = {"ms": smoke.whole_ms(torch, run, REPS), "host_reads": reads, "steps": steps, "rows": n_rows,
                     "n_active": n_active, "overlay_rows": 0 if ov[0] is None else OVERLAY_ROWS,
                     "result_sha256": hashlib.sha256(R.cpu().numpy().tobytes()).hexdigest()[:16]}
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    engine.close()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
