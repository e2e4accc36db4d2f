"""Time the label route's pair compare of one checkout of the PyTorch port on
the card: K3 (``keto_label_step``) at BASELINE config 4's deep shape, K10b's
whole sharded label step over 4 shards on the same pairs, and K4
(``keto_label_witness``) at 65,536 pairs and at one.

    python3 scripts/ab_label_step.py --prepare build/ab_label_inputs.pt
    python3 scripts/ab_label_step.py --tree build/parent --inputs build/ab_label_inputs.pt \\
        --out build/ab_label_parent.json
    python3 scripts/ab_label_step.py --tree . --inputs build/ab_label_inputs.pt \\
        --out build/ab_label_change.json

``--prepare`` builds the inputs once, with this checkout's engine, and saves
them: chip_smoke.py's deep workload (10M tuples, seed as its deep phase),
the engine's snapshot and device label build, and the largest label step
of its 100k-check batch (the label arrays, the entries, ``n_pairs``,
``B``), plus 65,536 random interior pairs for K4, the first of them
alone as its one-pair launch. ``--tree`` names the checkout whose
``keto_tpu_torch`` package is imported (its kernels are built in that
checkout), so two checkouts — a change and its parent — time the same
kernels on the same inputs, one process each, in one call on one card
(run parent, change, change, parent). Only entry points both checkouts share are called — the
wrappers ``kernels.label_step_cuda``, ``kernels.label_step_witness_cuda``,
``sharded.label_step_cuda``, ``sharded.route_labels`` and the C entry
points — with the launch helpers ``kernels.label_step_launch`` and
``kernels.label_witness_launch`` where the tree has them, else the C
signatures the parent's kernels take.

Measured, each on the card: a kernel as bare launches in one CUDA graph
(``ms``: its device time, no host work between launches), the wrapper's
call back to back (``wrapper_ms``, CUDA events), the plain version's
answer held against the kernel's (mismatching words), and a hash of the
output words (two checkouts must give the same). K10b: its whole call
back to back (``ms``, CUDA events, as chip_smoke.py times it; the host's
work between the calls bounds it where the kernels are faster) and the
same calls replayed from one CUDA graph (``device_ms``, the step's device
time). The card's name and power limit go into the output beside every
number.
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
from pathlib import Path

SEED = 20261017
DEEP_TUPLES = 10_000_000
N_CHECKS = 100_000
WITNESS_BATCH = 65_536
SHARDS = 4
GRAPH_LAUNCHES = 20
REPS = 50


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (never the measured
    tree's): its ``graph_ms``, ``time_ms`` and ``diff`` time and compare
    here as they do in the smoke run."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_ab_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def prepare(path: str) -> dict:
    """The inputs (see the module docstring), saved to ``path``."""
    import numpy as np
    import torch

    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.check import kernels
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
    from keto_tpu_torch.persistence.memory import MemoryPersister
    from keto_tpu_torch.workloads import GITHUB_NAMESPACES, github_queries, github_workload

    rng = random.Random(SEED + 4)
    tuples, ctx = github_workload(rng, DEEP_TUPLES)
    queries, _ = github_queries(rng, N_CHECKS, ctx)
    nm = tns.MemoryManager(GITHUB_NAMESPACES)
    store = MemoryPersister(nm)
    store.write_relation_tuples(*tuples)
    del tuples
    engine = TorchCheckEngine(store, nm, device="cuda")
    snap = engine.snapshot()
    if not engine.labels_settled():
        raise SystemExit("ab_label_step: no label index")
    captured = []
    dispatch = kernels.label_step

    def capture(out_lab, in_lab, entries, **kw):
        captured.append((out_lab, in_lab, entries, kw))
        return dispatch(out_lab, in_lab, entries, **kw)

    kernels.label_step = capture
    try:
        engine.batch_check(queries)
    finally:
        kernels.label_step = dispatch
    out_lab, in_lab, entries, kw = max(captured, key=lambda c: c[3]["n_pairs"])
    pairs = np.random.default_rng(SEED + 8).integers(0, snap.num_int, size=(2, WITNESS_BATCH))
    inputs = {"out_lab": out_lab.cpu(), "in_lab": in_lab.cpu(), "entries": entries.cpu(),
              "n_pairs": int(kw["n_pairs"]), "B": int(kw["B"]), "num_int": int(snap.num_int),
              "witness_pairs": torch.from_numpy(pairs.astype(np.int32))}
    engine.close()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(inputs, path)
    return {k: v for k, v in inputs.items() if isinstance(v, int)} | {
        "Wo": int(out_lab.shape[1]), "Wi": int(in_lab.shape[1])}


def _sha(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def measure(smoke, torch, kernels, ps, make_mesh, inputs: dict) -> dict:
    dev = "cuda"
    out_lab, in_lab = inputs["out_lab"].to(dev), inputs["in_lab"].to(dev)
    entries = inputs["entries"].to(dev)
    P, B = inputs["n_pairs"], inputs["B"]
    Wo, Wi, rows = out_lab.shape[1], in_lab.shape[1], out_lab.shape[0]
    lib = kernels._lib()
    new = hasattr(kernels, "label_step_launch")
    res: dict = {"launch_helpers": new, "shape": {"pairs": P, "B": B, "Wo": Wo, "Wi": Wi,
                                                  "rows": rows}}
    if hasattr(kernels, "label_team"):
        res["shape"]["team"] = list(kernels.label_team(Wo))

    def k3_launch(out):
        if new:
            return kernels.label_step_launch(lib, out_lab, in_lab, entries, P, out,
                                             kernels._stream())
        return lib.keto_label_step(out_lab.data_ptr(), Wo, in_lab.data_ptr(), Wi, rows,
                                   entries.data_ptr(), P, out.data_ptr(), kernels._stream())

    def k4_launch(pa, pb, out):
        if new:
            return kernels.label_witness_launch(lib, out_lab, in_lab, pa, pb, out,
                                                kernels._stream())
        return lib.keto_label_witness(out_lab.data_ptr(), Wo, in_lab.data_ptr(), Wi, rows,
                                      pa.data_ptr(), pb.data_ptr(), pa.numel(), out.data_ptr(),
                                      kernels._stream())

    # K3 at the deep shape
    want = kernels.label_step_ref(out_lab, in_lab, entries, n_pairs=P, B=B)
    got = kernels.label_step_cuda(out_lab, in_lab, entries, n_pairs=P, B=B)
    bare = torch.zeros_like(want)
    ms, how = smoke.graph_ms(torch, lambda: smoke._ok(k3_launch(bare), "keto_label_step"),
                             GRAPH_LAUNCHES)
    torch.cuda.synchronize()
    res["label_step"] = {
        "ms": ms, "timed_by": how,
        "wrapper_ms": smoke.time_ms(
            lambda: kernels.label_step_cuda(out_lab, in_lab, entries, n_pairs=P, B=B), REPS),
        "mismatches": smoke.diff(got, want)[0] + smoke.diff(bare, want)[0],
        "out_sha256": _sha(got)}
    print(f"label_step: {json.dumps(res['label_step'])}", flush=True)

    # K10b's whole step: the same pairs over 4 row-range shards
    o_sh, i_sh, rl, _ = ps.route_labels(inputs["out_lab"].numpy(), inputs["in_lab"].numpy(),
                                        SHARDS)
    o_sh, i_sh = torch.from_numpy(o_sh).to(dev), torch.from_numpy(i_sh).to(dev)
    mesh = make_mesh(graph=SHARDS, device=dev)
    step = lambda: ps.label_step_cuda(mesh, o_sh, i_sh, entries, n_pairs=P, B=B, rl=rl)  # noqa: E731
    sh = step()
    torch.cuda.synchronize()
    device_ms, how = smoke.graph_ms(torch, step, GRAPH_LAUNCHES)
    res["shard_label_step"] = {"ms": smoke.time_ms(step, REPS), "device_ms": device_ms,
                               "device_timed_by": how, "rl": rl, "g": SHARDS,
                               "mismatches": smoke.diff(sh, want)[0], "out_sha256": _sha(sh)}
    print(f"shard_label_step: {json.dumps(res['shard_label_step'])}", flush=True)

    # K4 at 65,536 pairs and at one
    wp = inputs["witness_pairs"].to(dev)
    for name, pa, pb, n_graph in (
        ("label_witness_batch", wp[0].contiguous(), wp[1].contiguous(), GRAPH_LAUNCHES),
        ("label_witness", wp[0, :1].contiguous(), wp[1, :1].contiguous(), 500),
    ):
        want = kernels.label_step_witness_ref(out_lab, in_lab, pa, pb)
        got = kernels.label_step_witness_cuda(out_lab, in_lab, pa, pb)
        bare = torch.full_like(want, -3)
        ms, how = smoke.graph_ms(torch, lambda: smoke._ok(k4_launch(pa, pb, bare),
                                                          "keto_label_witness"), n_graph)
        torch.cuda.synchronize()
        res[name] = {
            "pairs": int(pa.numel()), "ms": ms, "timed_by": how,
            "wrapper_ms": smoke.time_ms(
                lambda: kernels.label_step_witness_cuda(out_lab, in_lab, pa, pb), 10 * n_graph),
            "mismatches": smoke.diff(got, want)[0] + smoke.diff(bare, want)[0],
            "landmarks_found": int((want >= 0).sum()), "out_sha256": _sha(got)}
        print(f"{name}: {json.dumps(res[name])}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prepare", help="build the inputs with this checkout and save them here")
    ap.add_argument("--tree", help="checkout whose keto_tpu_torch is measured")
    ap.add_argument("--inputs", help="the file --prepare wrote")
    ap.add_argument("--out", help="JSON file to write")
    args = ap.parse_args(argv)
    if not args.prepare and not (args.tree and args.inputs and args.out):
        ap.error("give --prepare FILE, or --tree, --inputs and --out")
    smoke = _smoke()
    tree = os.path.abspath(args.tree or Path(__file__).resolve().parents[1])
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("ab_label_step: no CUDA device is available", file=sys.stderr)
        return 2
    import keto_tpu_torch

    if not keto_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {keto_tpu_torch.__file__}, not the package under {tree}")
    out: dict = {"tree": tree, "card": card(), "torch": torch.__version__}
    if args.prepare:
        out["inputs"] = prepare(args.prepare)
        print(json.dumps(out), flush=True)
        return 0
    from keto_tpu_torch.check import kernels
    from keto_tpu_torch.parallel import make_mesh
    from keto_tpu_torch.parallel import sharded as ps

    out.update(measure(smoke, torch, kernels, ps, make_mesh, torch.load(args.inputs)))
    bad = sum(v["mismatches"] for v in out.values() if isinstance(v, dict) and "mismatches" in v)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    print(out["card"], flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
