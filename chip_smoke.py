"""Smoke run of the PyTorch port on one NVIDIA GPU: build, parity, main path, serve.

    python3 chip_smoke.py            # every phase, as a release check runs it
    python3 chip_smoke.py --only build,parity

Phases, in order; any failure exits non-zero:

1. card and build — the card's name and power limit (nvidia-smi), then the
   CUDA kernels compiled from keto_tpu_torch/csrc with nvcc for sm_90a;
2. parity — every CUDA kernel against its plain PyTorch version on the same
   tensors on the card, over random ELL graphs made from a numpy seed
   (degree caps 1..4096, W in {1, 8, 64, 4096}, bit 31, sentinel and padding
   rows, overlays with padding, it_cap truncation with block_iters 1/3/8,
   n_active = 0); every word of every output must agree;
3. main path — BASELINE config 3 (RBAC, 1M tuples, 3-level group nesting)
   into the port's store, TorchCheckEngine on the card, 100k checks: every
   decision equals the analytic expectation, a 2,000-query sample equals
   the recursive oracle, and every kernel of the path launched; then each
   kernel is timed at the main path's shapes beside its plain version and
   its memory bound;
4. serve — the REST server with the engine on the card: the cat-videos
   checks (200, 200, 403, 200), read-your-writes after a PUT, /check/batch,
   then a PUT that closes a cycle and a batch over it; each part fails
   unless its requests launched every kernel their snapshot needs.

Output: progress lines, the ``{"kernels": [...]}`` line, the card line, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

PHASES = ("build", "parity", "main", "serve")
SEED = 20261017
N_TUPLES = 1_000_000
N_CHECKS = 100_000
ORACLE_SAMPLE = 2_000

#: the TPU kernels these CUDA kernels replace
K1 = "keto_tpu/check/tpu_engine.py:89"
K2 = "keto_tpu/check/tpu_engine.py:110"
#: HBM rate of one H100 SXM (NVIDIA's data sheet), the card the bounds are for
H100_SXM_RATE = 3.35e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    """The memory rate the bounds use; only the H100 SXM's is known here."""
    if "H100" not in name or "HBM3" not in name:
        raise SystemExit(f"bounds are stated for an H100 SXM (HBM3), not {name!r}")
    return H100_SXM_RATE


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def diff(a, b) -> tuple[int, int]:
    """(mismatching words, max |a-b| over words read as uint32)."""
    import torch

    a = a.to(torch.int64) & 0xFFFFFFFF
    b = b.to(torch.int64) & 0xFFFFFFFF
    if a.shape != b.shape:
        return max(a.numel(), b.numel()), -1
    d = (a - b).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


# -- phase 2: parity on random layouts ---------------------------------------


PARITY_CASES = [
    dict(W=1, caps=(1, 2, 4, 8), rows=(40, 20, 10, 5), n_int=100),
    dict(W=8, caps=(1, 2048), rows=(60, 3), n_int=100, block_iters=3),
    dict(W=8, caps=(1, 4096), rows=(30, 2), n_int=100, overlay=True),
    dict(W=64, caps=(1, 16, 1024), rows=(50, 9, 2), overlay=True, block_iters=1),
    dict(W=4096, caps=(1, 2, 4096), rows=(40, 10, 1), n_int=80),
    dict(W=4096, caps=(1,), rows=(40,), n_int=48, chain=True, it_cap=5, block_iters=3),
    dict(W=8, caps=(1,), rows=(60,), chain=True, it_cap=3, block_iters=1),
    dict(W=1, caps=(1,), rows=(60,), chain=True, it_cap=2, block_iters=8),
    dict(W=64, caps=(1,), rows=(50,), chain=True, block_iters=3, overlay=True),
    dict(W=8, n_int=30),
    dict(W=4096, n_int=12),
]


def phase_parity(torch, kernels, rows_out):
    import numpy as np

    from keto_tpu_torch.check.random_layouts import random_case

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    total = 0
    for i, case in enumerate(PARITY_CASES):
        buckets, entries, ov, kw = random_case(rng, **case)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        nb = [t(b) for b in buckets]
        ent = t(entries)
        ovn, ovd = (None, None) if ov is None else (t(ov[0]), t(ov[1]))
        got = kernels.check_step_cuda(nb, ent, ovn, ovd, **kw)
        want = kernels.check_step_ref(nb, ent, ovn, ovd, **kw)
        torch.cuda.synchronize()
        m, _ = diff(got, want)
        tail = got[-2:].tolist()
        if kw["n_active"]:
            W = kw["sizes"][3] // 32
            R = torch.from_numpy(
                rng.integers(0, 2**32, size=(kw["n_int"] + 1, W), dtype=np.uint64)
                .astype(np.uint32).view(np.int32)
            ).to(dev)
            R[-1] = 0
            m += diff(kernels.pull_cuda(nb, kw["valid_rows"], R),
                      kernels.pull_ref(nb, kw["valid_rows"], R))[0]
        log(f"parity case {i}: {case} -> iters={tail[0]} truncated={tail[1]} mismatches={m}")
        total += m
    rows_out["parity_mismatches"] = total
    if total:
        raise SystemExit(f"kernel parity FAILED: {total} mismatching words")


# -- phase 3: main path ---------------------------------------------------------


def phase_main(torch, kernels, report):
    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.check.engine import CheckEngine
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
    from keto_tpu_torch.persistence.memory import MemoryPersister
    from keto_tpu_torch.workloads import RBAC_NAMESPACES, rbac_queries, rbac_workload

    rng = random.Random(SEED)
    t0 = time.monotonic()
    tuples, ctx = rbac_workload(rng, N_TUPLES)
    queries, expected = rbac_queries(rng, N_CHECKS, ctx)
    nm = tns.MemoryManager(RBAC_NAMESPACES)
    store = MemoryPersister(nm)
    store.write_relation_tuples(*tuples)
    log(f"workload: {len(tuples)} tuples, {len(queries)} checks, "
        f"{sum(expected)} expected grants ({time.monotonic() - t0:.1f}s to generate and store)")

    engine = TorchCheckEngine(store, nm, device="cuda")
    t0 = time.monotonic()
    snap = engine.snapshot()
    torch.cuda.synchronize()
    snap_s = time.monotonic() - t0
    log(f"snapshot: {snap.n_nodes} nodes, {snap.n_edges} edges, num_int={snap.num_int}, "
        f"num_active={snap.num_active}, n_peeled={snap.n_peeled}, "
        f"buckets={[(tuple(b.nbrs.shape), b.n) for b in snap.buckets]}, {snap_s:.3f}s")

    # the main path's run: launch counts from exactly this call
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    got = engine.batch_check(queries)
    torch.cuda.synchronize()
    check_s = time.monotonic() - t0
    launches = dict(kernels.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    wrong = sum(g != e for g, e in zip(got, expected))
    log(f"main path: {N_CHECKS} checks in {check_s:.3f}s ({N_CHECKS / check_s:.0f} checks/s), "
        f"peak device memory {peak / 2**20:.1f} MiB, launches {launches}, "
        f"wrong vs analytic {wrong}")
    if wrong:
        raise SystemExit(f"main path FAILED: {wrong} decisions differ from the expectation")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"main path FAILED: kernels never launched: {missing}")
    # steady state: block_iters has adapted, nothing is cold
    t0 = time.monotonic()
    got2 = engine.batch_check(queries)
    steady_s = time.monotonic() - t0
    if got2 != got:
        raise SystemExit("main path FAILED: a second run decided differently")
    oracle = CheckEngine(store)
    t0 = time.monotonic()
    bad = sum(oracle.subject_is_allowed(q) != g
              for q, g in zip(queries[:ORACLE_SAMPLE], got[:ORACLE_SAMPLE]))
    log(f"oracle sample: {ORACLE_SAMPLE} checks, {bad} mismatches "
        f"({time.monotonic() - t0:.1f}s); steady {N_CHECKS / steady_s:.0f} checks/s")
    if bad:
        raise SystemExit(f"main path FAILED: {bad} oracle mismatches")
    report["main"] = {
        "config": "BASELINE config 3 (RBAC)", "tuples": len(tuples), "checks": N_CHECKS,
        "snapshot_s": snap_s, "check_s": check_s, "checks_per_s": N_CHECKS / check_s,
        "steady_check_s": steady_s, "steady_checks_per_s": N_CHECKS / steady_s,
        "peak_device_bytes": peak, "oracle_sample": ORACLE_SAMPLE, "oracle_mismatches": bad,
        "grants": sum(expected),
    }
    report["launches"] = launches
    return engine, snap, queries


def kernel_rows(torch, kernels, engine, snap, queries, rate, launches):
    """Time every kernel at the main path's shapes beside its plain version
    and its bound; compare each against the plain version once more."""
    from keto_tpu_torch.check.pack import pack_chunk, pack_entries

    g = snap.device
    # the host half of the batch, timed on its own (the engine runs the same
    # calls inside batch_check)
    t0 = time.monotonic()
    sd, tg, multi = engine._resolve_bulk_py(snap, queries)
    t1 = time.monotonic()
    packed, _ = pack_chunk(snap, sd, tg, multi, 0, len(queries))
    buf, sizes = pack_entries(packed)
    t2 = time.monotonic()
    entries = torch.from_numpy(buf).cuda()
    torch.cuda.synchronize()
    host = {"resolve_s": t1 - t0, "pack_s": t2 - t1, "h2d_s": time.monotonic() - t2,
            "entry_bytes": int(buf.nbytes)}
    S1, S2, SA, B = sizes
    W = B // 32
    n_int, n_active = g.num_int, g.num_active
    kw = dict(sizes=sizes, n_active=n_active, n_int=n_int, valid_rows=g.valid_rows,
              it_cap=4096, block_iters=engine._block_iters)
    word = 4
    bitmap = (n_int + 1) * W * word
    act = n_active * W * word
    rows = []

    def row(name, part, cuda_fn, plain_fn, outs, bytes_needed, reps, library=None, extra=None):
        a, b = outs
        m, err = diff(a, b)
        ms = time_ms(cuda_fn, reps)
        plain = time_ms(plain_fn, max(1, reps // 10), warmup=1)
        lib = time_ms(library, reps) if library is not None else None
        r = {"name": name, "route": "cuda", "source": "keto_tpu_torch/csrc/check_kernels.cu",
             "replaces": K1 if name == "pull" else K2, "part": part,
             "launches": launches[name], "mismatches": m,
             "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": bytes_needed / rate * 1e3, "bound_by": "bytes", "library_ms": lib}
        r.update(extra or {})
        rows.append(r)
        log(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f} ms, bound {r['bound_ms']:.4f} ms), "
            f"mismatches {m}")

    # seed
    R0, ans0 = kernels.seed_cuda(entries, sizes, n_int, W)
    R0r, ans0r = kernels.seed_ref(entries, sizes, n_int, W)
    e = entries.long()
    rows1 = torch.cat([e[:S1], e[2 * S1 : 2 * S1 + S2]])
    qs1 = torch.cat([e[S1 : 2 * S1], e[2 * S1 + S2 : 2 * S1 + 2 * S2]])
    keep = rows1 <= n_int
    flat = rows1[keep] * W + (qs1[keep] >> 5)
    bits = (torch.ones_like(qs1[keep]) << (qs1[keep] & 31)).to(torch.int32)
    scratch = torch.zeros((n_int + 1) * W, dtype=torch.int32, device="cuda")
    row("seed", "seed scatter, tpu_engine.py:156-161",
        lambda: kernels.seed_cuda(entries, sizes, n_int, W),
        lambda: kernels.seed_ref(entries, sizes, n_int, W),
        (torch.cat([R0.view(-1), ans0.view(-1)]), torch.cat([R0r.view(-1), ans0r.view(-1)])),
        8 * (S1 + S2) + 2 * bitmap, 20,
        library=lambda: scratch.index_put_((flat,), bits, accumulate=True))

    # the fixpoint, for realistic pull/commit/answer inputs
    R = R0.clone()
    P = torch.zeros((n_active + 1, W), dtype=torch.int32, device="cuda")
    state = torch.tensor([1, 0, 0], dtype=torch.int32, device="cuda")
    while int(state[0]):
        kernels.pull_cuda(g.buckets, g.valid_rows, R, P=P, state=state)
        kernels.commit_cuda(P, R, n_active, state)
        kernels.close_cuda(state)
    iters = int(state[1])

    # the pull must read every valid neighbour slot, each distinct source
    # row once (the all-zero sentinel row n_int needs no read), and write P
    slots = sum(n * b.shape[1] for b, n in zip(g.buckets, g.valid_rows))
    srcs = torch.unique(torch.cat([b[:n].reshape(-1) for b, n in zip(g.buckets, g.valid_rows)]))
    distinct = int((srcs < n_int).sum())
    pulled = kernels.pull_cuda(g.buckets, g.valid_rows, R)
    library = None
    if all(b.shape[1] == 1 for b in g.buckets):
        # with every degree cap 1 the pull is a plain row gather
        src = torch.cat([b[:n, 0] for b, n in zip(g.buckets, g.valid_rows)])
        if diff(torch.index_select(R, 0, src), pulled)[0]:
            raise SystemExit("index_select disagrees with the pull at cap 1")
        library = lambda: torch.index_select(R, 0, src)  # noqa: E731
    row("pull", "_pull, tpu_engine.py:89-107 (and the overlay OR, :181-188)",
        lambda: kernels.pull_cuda(g.buckets, g.valid_rows, R),
        lambda: kernels.pull_ref(g.buckets, g.valid_rows, R),
        (pulled, kernels.pull_ref(g.buckets, g.valid_rows, R)),
        slots * word + distinct * W * word + act, 20, library=library,
        extra={"edge_slots": slots, "distinct_source_rows": distinct})

    # the first commit folds the pull into R0; the timed repeats then find
    # nothing to change, so their bound is the two reads alone
    Pc = P[:n_active].clone()
    Rc, Rr = R0.clone(), R0.clone()
    sc = torch.tensor([1, 0, 0], dtype=torch.int32, device="cuda")
    sr = sc.clone()
    kernels.commit_cuda(Pc, Rc, n_active, sc)
    kernels.commit_ref(Pc, Rr, n_active, sr)
    on = torch.tensor([1, 0, 0], dtype=torch.int32, device="cuda")
    row("commit", "R[:n_active] |= p and the changed flag, tpu_engine.py:189-191",
        lambda: kernels.commit_cuda(Pc, Rc, n_active, on),
        lambda: kernels.commit_ref(Pc, Rr, n_active, sr),
        (torch.cat([Rc.view(-1), sc]), torch.cat([Rr.view(-1), sr])),
        2 * act, 20)

    s1 = torch.tensor([1, 5, 1], dtype=torch.int32, device="cuda")
    s2 = s1.clone()
    kernels.close_cuda(s1)
    kernels.close_ref(s2)
    spare = torch.tensor([1, 0, 1], dtype=torch.int32, device="cuda")
    row("close", "the while/fori guard, tpu_engine.py:198-212",
        lambda: kernels.close_cuda(spare),
        lambda: kernels.close_ref(spare.clone()),
        (s1, s2), 24, 50)

    out_c = kernels.answer_pack_cuda(entries, sizes, n_active, P, ans0, R, state)
    out_r = kernels.answer_pack_ref(entries, sizes, n_active, P, ans0, R, iters, False)
    row("answer_pack", "answers and bit pack, tpu_engine.py:219-243",
        lambda: kernels.answer_pack_cuda(entries, sizes, n_active, P, ans0, R, state),
        lambda: kernels.answer_pack_ref(entries, sizes, n_active, P, ans0, R, iters, False),
        (out_c, out_r), word * (3 * B + 3 * SA) + (W + 2) * word, 20)

    # the whole step at the main path's shapes, for the record
    full_c = kernels.check_step_cuda(g.buckets, entries, **kw)
    full_r = kernels.check_step_ref(g.buckets, entries, **kw)
    m, _ = diff(full_c, full_r)
    step = {"name": "check_step", "W": W, "sizes": list(sizes), "iters": iters,
            "mismatches": m, **host,
            "ms": time_ms(lambda: kernels.check_step_cuda(g.buckets, entries, **kw), 5, 1),
            "plain_ms": time_ms(lambda: kernels.check_step_ref(g.buckets, entries, **kw), 2, 1)}
    log(f"check_step at main shapes: {json.dumps(step)}")
    total = sum(r["mismatches"] for r in rows) + m
    if total:
        raise SystemExit(f"kernel parity at main shapes FAILED: {total} mismatching words")
    return rows, step


# -- phase 4: serve ---------------------------------------------------------------


#: a cycle through the directory's owners: its rows cannot be peeled, so the
#: served snapshot gets active rows and the fixpoint kernels run
SERVE_CYCLE = "videos:/cats#owner@(videos:/cats/1.mp4#owner)"
SERVE_CYCLE_CHECKS = [
    ("videos:/cats/2.mp4#view@cat lady", True),
    ("videos:/cats#view@cat lady", True),
    ("videos:/cats/1.mp4#view@dog", False),
]


def served_launches(kernels, engine, what: str) -> dict:
    """The launch counts of the serve requests since the last reset; fails
    unless the path ran every kernel that the served snapshot needs."""
    counts = dict(kernels.COUNTS)
    n_active = engine.snapshot().num_active
    need = ["seed", "answer_pack"] + (["pull", "commit", "close"] if n_active else [])
    log(f"serve launches ({what}, {n_active} active rows): {counts}")
    missing = [k for k in need if not counts[k]]
    if missing:
        raise SystemExit(f"serve FAILED: {what} never launched {missing}")
    return counts


def phase_serve(kernels, report):
    import urllib.error
    import urllib.request

    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.relationtuple.model import RelationTuple
    from keto_tpu_torch.workloads import (
        CAT_VIDEOS_CHECKS,
        CAT_VIDEOS_NAMESPACES,
        CAT_VIDEOS_TUPLES,
        parse_tuples,
    )

    def req(method, port, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
        try:
            with urllib.request.urlopen(r, timeout=60) as resp:
                raw = resp.read()
                return resp.status, json.loads(raw) if raw else None
        except urllib.error.HTTPError as e:
            raw = e.read()
            return e.code, json.loads(raw) if raw else None

    d = Daemon(CAT_VIDEOS_NAMESPACES, device="cuda", tuples=parse_tuples(CAT_VIDEOS_TUPLES))
    d.start()
    try:
        kernels.reset_counts()
        codes = []
        for check, allowed in CAT_VIDEOS_CHECKS:
            q = RelationTuple.from_string(check).to_url_query()
            status, body = req("GET", d.read.port, "/check?" + q)
            codes.append(status)
            if status != (200 if allowed else 403) or body != {"allowed": allowed}:
                raise SystemExit(f"serve FAILED: {check} -> {status} {body}")
        new = RelationTuple.from_string("videos:/cats/2.mp4#view@*")
        put = req("PUT", d.write.port, "/relation-tuples", new.to_json())
        after = req("GET", d.read.port, "/check?" + new.to_url_query())
        batch = req("POST", d.read.port, "/check/batch",
                    {"tuples": [RelationTuple.from_string(c).to_json() for c, _ in CAT_VIDEOS_CHECKS]})
        log(f"serve: cat-videos {codes}, PUT {put[0]}, check after write {after}, batch {batch}")
        if put[0] != 201 or after != (200, {"allowed": True}):
            raise SystemExit("serve FAILED: a written tuple is not visible to /check")
        if batch != (200, {"results": [True, True, True, True]}):
            raise SystemExit(f"serve FAILED: /check/batch answered {batch}")
        report["serve_launches"] = served_launches(kernels, d.engine, "cat-videos")

        put = req("PUT", d.write.port, "/relation-tuples",
                  RelationTuple.from_string(SERVE_CYCLE).to_json())
        kernels.reset_counts()
        cyc = req("POST", d.read.port, "/check/batch",
                  {"tuples": [RelationTuple.from_string(c).to_json() for c, _ in SERVE_CYCLE_CHECKS]})
        log(f"serve: PUT {put[0]} of a cycle, batch {cyc}")
        if put[0] != 201 or cyc != (200, {"results": [a for _, a in SERVE_CYCLE_CHECKS]}):
            raise SystemExit(f"serve FAILED: checks over the cycle answered {cyc}")
        cycled = served_launches(kernels, d.engine, "cycle")
        if not cycled["pull"]:
            raise SystemExit("serve FAILED: the cycle left the served snapshot without active rows")
        report["serve_cycle_launches"] = cycled
    finally:
        d.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated phases to run (default: all of {','.join(PHASES)})")
    args = ap.parse_args(argv)
    phases = set(args.only.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from keto_tpu_torch import _build
    from keto_tpu_torch.check import kernels

    card = card_line()
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"memory rate used for bounds {rate / 1e12:.2f} TB/s")
    t0 = time.monotonic()
    _build.build(verbose=True)
    _build.lib()
    log(f"build: {_build.library_path().name} in {time.monotonic() - t0:.2f}s "
        f"(nvcc {_build.build_seconds:.2f}s)")

    report: dict = {}
    if "parity" in phases:
        phase_parity(torch, kernels, report)
    rows = []
    if "main" in phases:
        engine, snap, queries = phase_main(torch, kernels, report)
        rows, step = kernel_rows(torch, kernels, engine, snap, queries, rate, report["launches"])
        report["check_step"] = step
        log(json.dumps({"main": report["main"]}))
    if "serve" in phases:
        phase_serve(kernels, report)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
