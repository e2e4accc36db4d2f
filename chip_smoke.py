"""Smoke run of the PyTorch port on one NVIDIA GPU: build, parity, the BFS
and label routes of Check, the check scheduler under load, the
device-memory governor and the health machine, the snapshot cache, sharded
serving, reverse queries, the stream and explain, the write path, serve.

    python3 chip_smoke.py            # every phase, as a release check runs it
    python3 chip_smoke.py --only build,parity
    python3 chip_smoke.py --only build,main,lanes               # the check scheduler
    python3 chip_smoke.py --only build,main,labels,hbm          # the governor and health
    python3 chip_smoke.py --only build,parity,main,deep,shard   # sharded serving
    python3 chip_smoke.py --only build,parity,deep,list         # reverse queries
    python3 chip_smoke.py --only build,parity,deep,explain      # the stream and explain
    python3 chip_smoke.py --only build,parity,deep,list,write   # and the write path
    python3 chip_smoke.py --only build,deep,cache,serve         # the snapshot cache, keyed writes

Phases, in order; any failure exits non-zero:

1. build — the card's name and power limit (nvidia-smi), then the CUDA
   kernels compiled from keto_tpu_torch/csrc with nvcc for sm_90a (one nvcc
   per source, all started together), timed beside one nvcc over every
   source when the build was cold, and the host library (the interner with
   its bulk resolve and the pack walk, keto_tpu_torch/native/*.cpp)
   compiled with g++, its seconds and the compiler's version beside nvcc's;
2. parity — every CUDA kernel against its plain PyTorch version on the same
   tensors on the card, over random layouts made from a numpy seed: the
   check step (degree caps 1..4096 and 1,100, W in {1, 3, 5, 8, 12, 64,
   4096}, bit 31, sentinel and padding rows, overlays, it_cap truncation
   inside a block of steps, n_active = 0; each step the seeds, ONE
   ``keto_check_run`` launch and the answer with no host read in between),
   K1's ``keto_pull`` alone (one launch over every bucket) and the run
   alone, each into a sentinel-filled output, the label
   step (label widths 1..128, pad pairs, several pairs per query), the
   whole frontier sweep (one launch a run: expansion pruning on and off,
   rows outside every dst, groups of cap 32 and more, wt 1, 2 and 5, with
   no budget, the run's own visits, one visit less and half), the covered
   mask (lanes 1 to 160 at wt 1, 2, 3 and 5, own pads -1 and -2, label
   widths 1, 3 and 12 to 64, with and without 16-byte loads, own rows
   narrower than the label rows, output rows past the label rows, config
   4's 123,950 rows, one table reused and zero after every call, also
   through ``_compute_covered``; an own entry outside the label rows must
   raise) and the slot set (a bucket patch, overlay rows and their dst
   vector, a label-mirror store in place, an empty entry list, duplicate
   slots; calls of several targets over many tiles and cut tiles, in place
   and not, one launch a call; an out-of-range entry that must raise with
   every target untouched and nothing launched), the
   label witness (label widths 1..128, unequal sides, sorted and shuffled
   rows, the pad row, pairs with no common entry, rows whose every entry is
   common, 65,536 pairs), the list fixpoint (the base pull alone, an overlay into active rows, an
   overlay into passive rows, a chain that it_cap truncates, no active row
   but an overlay, all 32 lanes; and random layouts with wide buckets,
   overlays into passive rows and it_cap cuts inside a block of steps),
   the build's radix argsort (empty, one
   key, all keys equal, negative keys, a ragged last tile, random int32, 10M
   keys in [0, 5.2M), keys whose middle digit is constant, the build's
   bucket keys; each permutation also equal to numpy's stable argsort and
   to ``torch.argsort(stable=True)``) and the sharded programs at 1, 2, 3
   and 4 shards (K10a on the check step's layouts — uneven last shards,
   overlays with rows no shard owns, it_cap truncation, bit 31, no active
   row, narrow and odd widths, a cap past 1,024, and each layout again
   with all-sentinel entries, which must decide nothing — with the
   1-shard output's first W+2 words equal to the single-device K2's and
   its popcount word (counted by the seeds and the run where they set its
   bits) equal to every shard count's; each step g seeds, ONE run over
   every shard and ONE answer with no host read in between; the
   run alone into a sentinel-filled P against the plain run on the same
   global rows, a halo copy each step run; K10b on label widths
   1..128 with pad rows, also against the single-device K3, and each
   side's pair-row exchange alone with rows no shard owns; K10c's whole
   sharded sweep, one launch with the halo copy between waves, with
   expansion pruning on and off, the routing's padding rows and the
   budgets above, also against the single-device sweep), and the two
   answer kernels, ``keto_answer_pack`` and ``keto_shard_answer``, one
   launch a call, on their own layouts (random entries, a word whose 32
   queries all hit, every sink entry in one word, passive and absent
   targets, targets and sink rows no shard owns; W = 1, 3, 5, 8, 64 and
   4,096; g = 1..8);
   every word of every output must agree;
3. main — BASELINE config 3 (RBAC, 1M tuples, 3-level group nesting) on
   the BFS route (labels off), 100k checks: every decision equals the
   analytic expectation, a 2,000-query sample equals the recursive
   oracle, and every BFS kernel launched, each BFS step the seeds, one
   ``keto_check_run`` launch and the answer (the runs' pull phases counted
   on the card); each kernel is then timed at the main path's shapes
   beside its plain version and its bound: ``keto_pull`` alone beside
   ``torch.index_select``, the run kernel alone (a bare launch) and as its
   wrapper's call, the whole step (which must make no host read). The snapshot
   line gives the build's sort seconds on the card (K8) against the host
   sorter on the same keys, whose permutations must equal the card's, the
   sorter's dispatch counts, and K8's summed device ms over the same sorts
   replayed on the idle card, with the passes they ran and skipped. The
   batch must take the native host path (the snapshot interned in C++, every
   slice resolved by the C++ bulk resolve and packed by the native walk);
   the host-path line then gives the whole batch's resolve seconds, native
   against the host loop ``_resolve_bulk_py`` (medians of 3, the arrays
   equal), its pack seconds, the native walk against numpy (medians of 3,
   equal entry buffers), the path counters, the interning of the 1M stored
   rows, native against the Python interner (one run each, the arrays and
   code tables equal), and checks/s, first and steady. The store takes the
   1M tuples in one bulk write (a numpy lexsort, the sorted column bundle
   kept, the row objects parked); the cold-start line gives the store's
   seconds, the first build's path and phase seconds (``intern``,
   ``device_build``), the snapshot's seconds, the host's resident and peak
   memory after the load, the build and the first row materialization, and
   that materialization's seconds, timed apart; the phase fails unless the
   first build interned from the bundle (``columns``). The streaming line
   builds the same snapshot through a chunk-preferring view of the store
   (``full_build``'s ``stream`` path: the native stream builder fed chunk
   by chunk), with its scan and intern seconds, and fails unless its arrays
   equal the column build's;
4. lanes — main's engine (labels off) and store behind the daemon's
   wiring (``make_batcher``: priority lanes, lanes of 32,768 tuples that
   shed when full, admission control; one ``TimelineRecorder``; a read and
   a write ``RestServer``; a decision log sampling every /check; the
   shadow audit at 1%), driven over HTTP: a 50,000-tuple batch, wider than
   the admission window, must answer 429 with ``Retry-After``; a lone
   batch (3 back-to-back posts of half the window, no other client: ms,
   sheds, rounds a post, checks/s beside ``engine.batch_check`` of the
   same); (a) 16 clients sending 200 ``GET /check`` each while two
   posters keep the batch lane fed with main's 100,000 checks in
   2,048-tuple posts (each posts while the other's is served): interactive
   p50/p99 overall, under a batch (an admitted post in flight at any point
   of the GET's life) and alone, the share of the span a batch was in
   flight and the lane's queued share, the rounds and the batch's
   sub-slices, the slices, the controller before and after; (b) two
   turns, the audit on, then off, each from a reopened admission
   window: three waves of 8 concurrent half-window batches beside 16
   clients: 429s with ``Retry-After``, the shed counters, the admission
   window, each thread group's CPU seconds (handlers, collector, audit,
   clients; ``/proc/self/task/*/schedstat``); (c) 200
   ``?timeout_ms=0.001`` and 200 ``X-Request-Timeout-Ms: 1`` checks while a
   batch is queued: 504 or the right answer, ``deadline_drop_count``; (d)
   every interactive answer carries ``Server-Timing`` with a ``device``
   entry and ``X-Request-Id``, ``/debug/requests`` answers 50 recent and a
   trace-id filter, the device stamps' slice widths, every decision-log
   record routed ``bfs`` (or ``host``) with its trace id; (f) a batch in
   flight, then the drain: ``/health/ready`` 503 while draining, the batch
   answered, the drain's seconds; (e) the audit settles with checks and
   no mismatch. The servers carry the daemon's observability wiring (a
   ``memory`` tracer): one ``/metrics`` scrape is timed under (b)'s waves;
   after (f) both ports' scrapes parse strictly and must hold the same
   families, ``keto_http_requests_total`` equal to the phase's own count
   of its requests by route and code, the slice histogram's count to the
   engine's slice stats over the phase, the shed and deadline families to
   the batcher's, the ``device`` stage series above 0, and ``GET /slo``'s
   totals to a scrape. Any wrong decision, unlisted status, interactive
   429, a (b) turn without a 429, a scrape that differs from its source,
   or a phase that launched no ``keto_seed``, ``keto_check_run`` or
   ``keto_answer_pack`` fails it;
5. labels — the same store and checks with the default engine: labels on,
   built on the host (config 3 is below the device-build gate): decisions
   equal to the BFS run's and the expectation, the label step launched and
   the label build's kernels not;
6. hbm — the device-memory governor and the health machine
   (keto_tpu_torch/driver/hbm.py, health.py) on a ``fork()`` of main's
   store, config 3 with labels built on the card and a list engine, a
   ``HealthMonitor`` and a read ``RestServer``: (a) every ledger tag beside
   its tensors' bytes (``snapshot``, ``labels``, ``overlay`` and ``reverse``
   must be equal) and beside ``torch.cuda.memory_allocated`` since the
   engine was made (after ``deep``, the same at config 4 on deep's engine);
   (b) a budget below the buckets' bytes and a mid → leaf write: the ladder
   walks its five rungs in order and refuses the refresh, ``health()`` shows
   ``memory_pressure``, ``/health/ready`` answers 200 ``degraded``, the 100k
   checks equal main's expectation on the BFS route, and 200 listings on
   the reverse rung's host route equal the card's from before; (c) the
   monitor's staleness budget cut to 2 s: 503 with ``Retry-After``; (d) the
   auto budget back: the ladder restores, the fold rebuilds the labels on
   the card, the label route answers the new expectation and health reads
   SERVING; (e) real ``torch.OutOfMemoryError``s with the card filled: the
   100k batch, with the ladder at 0, evicts the staging rung (host memory),
   fails its retry and raises with no answer, health SERVING, then answers
   once the card is freed; a refresh's overlay upload evicts the labels
   rung, whose freed arrays let its retry succeed (``oom_recoveries`` + 1);
   (f) budgets that refuse the build transients (``evict=False``): the sorts
   and the label build run on the host, their permutations and entries
   equal to the card's, counted ``skipped``, the rung depth unchanged. A
   flight recorder (``min_interval_s=0``) rides along: (b) must leave a
   valid ``health-degraded`` bundle, (e0) and (e1) each an ``oom`` bundle
   whose ``hbm`` section counts its event (bytes and trigger-to-file
   seconds printed); a scrape after (a) must show ``keto_hbm_resident_bytes``
   equal to the ledger, one after (e) the governor's OOM counts;
7. cli — the reference's default serving path on the card (ROADMAP A7's
   first half): (a) a JSON config (``dsn: memory``, ports 0,
   ``serve.http_backend: async``, namespaces from a ``file://`` directory,
   every other key at its default) through ``Config`` → ``Registry`` →
   ``Daemon``; config 3's 1M tuples written through the registry's store
   (the bulk path), main's 100k checks as ``POST /check/batch`` bodies of
   16,384 tuples (429s slept through), then 16 keep-alive clients × 100
   ``GET /check``: 0 wrong against main's expectation, GET p50/p99 beside
   the lanes phase's threaded GETs, K2's run and K8's sorts launched (K3
   where the label route answered); (b) ``GET /watch`` from the watermark,
   then 10 ``PATCH`` transactions of 100 tuples through the write port:
   every commit group once, in commit order, send-to-line ms; a resume
   from the 5th token yields groups 6–10; ``gc_watch_logs`` with a 1 ms
   retention: a resume below the horizon answers 410, and the engine, left
   behind the horizon, takes exactly one full rebuild whose 100k decisions
   equal main's expectation plus the writes; (c) a namespace file written
   into the watched directory serves a ``PATCH`` within 5 s and checks on
   the card; a malformed file keeps the last good set; the drain closes
   the open stream; (d) ``python3 -m keto_tpu_torch serve -c`` as its own
   process with ``profiling: trace``: its first answered check (boot
   seconds), the cat-videos tuples PUT and checked, SIGTERM → exit 0
   within ``serve.drain_timeout_s`` + 30 s, its ``torch.profiler`` trace
   naming ``check_run_kernel`` (``keto_check_run``), the kernel library
   under build/kernels/ reused (same source hash, no ``nvcc``); (e) an
   unknown key, a wrong type and ``serve.role: replica`` each exit
   non-zero with the schema's or the registry's message in a process that
   sees no card;
8. deep — BASELINE config 4 (GitHub-style org/team/repo, 10M tuples,
   five namespaces, grant chains up to 7 edges) with the default engine
   (its build histogram attached before the first build: a
   ``keto_build_phase_duration_seconds`` series for each phase the build
   names, ``keto_build_rows_ingested_total`` equal to the store's rows):
   the labels built on the card, 100k checks equal to the analytic
   expectation, an oracle sample, the label step, frontier sweep, covered
   mask and slot set each launched, every mirror flush one slot set
   launch, the build's seconds split into seed uploads, sweeps (launch to
   host read), covered masks, flushes and the host mirror; then the three
   label kernels are timed at the path's shapes beside their plain
   versions and bounds (the sweep as a whole run, its kernel alone, its
   launches and host reads a run; the covered mask as wrapper calls, its
   kernel alone and the whole ``_compute_covered`` call, one
   ``keto_covered`` call (three device launches) and no host read, or the
   row fails); its snapshot line
   reports the build's sorts as main's does, K8's replay on its own line
   once the label build has left the card; its host-path line gives the
   snapshot's interning seconds and the batch's resolve and pack seconds
   on each path, as main's does; its cold-start line is main's (the 10M
   tuples in one bulk write, the first build from the bundle or the phase
   fails, the materialization timed apart after the label build settles),
   and the host-path line interns the 10M rows once more from the row
   objects, split into the C++ call and the Python column extraction
   around it (the path the bundle replaces), and the bundle once more,
   split into the NUL scan of its columns and the C++ call (main's does
   the same at 1M);
9. cache — the snapshot cache (keto_tpu_torch/graph/snapcache.py), in a
   ``tempfile.mkdtemp`` directory removed at the end, its disk's free space
   printed first: (a) deep's snapshot, its labels settled, saved: seconds
   split into the string tables (the C++ interner's strings one code at a
   time) and the rest, and bytes; (b) a fresh engine on deep's store with
   that directory: seconds to its first answered 100k batch beside deep's
   snapshot and label build, ``cache_loads`` 1, ``full_rebuilds`` 0 and
   ``label_builds`` 0 or the phase fails, K8 launched by the reload's list
   layouts, every decision equal to deep's, the resolve path (the host
   loop: a cached interner has no bulk resolve) and checks/s first and
   steady; (e) config 3 (main's store, or made anew without main) on a
   4-shard engine with labels off saves per-shard bucket segments, and a
   4-shard and a single-device engine each reload them with every decision
   equal to the expectation; (c) 5,000 new memberships written to a
   ``fork()`` of the store, an engine reloading the older cache catches up
   through the delta path (``delta_applies``, no rebuild), every decision
   and the 5,000 memberships equal to a fresh build's; (d) a segment of
   that cache corrupted: ``load_latest`` quarantines it. (c) and (d) run at
   config 4, or at config 3 when (a) and (b) took more than 120 s;
10. shard — one ``ShardMesh`` of 4 graph shards on the card: (a) main's
   store and 100k checks on a sharded engine with labels off (K10a, the
   BFS route), every decision equal to the analytic expectation and to
   main's unsharded run, a 2,000-query oracle sample, every K10a entry
   point launched and no unsharded answer kernel, each step 4 seeds, one
   run and one answer, the halo copies counted on the card equal to the
   steps run and to the ``shard_halo_rounds`` counter, each slice's iterations
   and truncation flag equal to main's engine's on the same slices, the
   ``shard_*`` counters and the collectives' bytes, checks/s beside the
   unsharded engine's; (b) a sharded engine on a fork of the deep phase's
   store (labels on): the sharded device label build (K10c) whose stored
   entries must equal the deep phase's single-device build, its seconds
   beside that build's; the 100k checks on the label route (K10b) equal
   to the expectation; the explain phase's 8,192 checks with wildcard
   relations (hybrid slices: K10a at config 4's shapes) equal to their
   expectation, per slice as the deep engine's, every stream slice
   ``hybrid`` with its halo rounds; 20 ListObjects and 20 ListSubjects
   against their analytic sets; a write of 64 team→team edges (the overlay
   routed per shard), the fold (the labels patched by the sharded sweeps)
   and the edges' deletes (bucket slots patched on their owning shards),
   each followed by the 100k checks (the fold's equal to the overlay's,
   the deletes' equal to the expectation) and an oracle sample; peak
   device memory; then K10a's whole step (no host read, one run), its run
   alone, ``keto_shard_answer`` and the halo copy timed at config 3's
   shapes, K10b's program and its pair-row
   exchange (``keto_pair_gather``, one launch per side) and K10c's whole
   sharded sweep (the build's first; the build's halo rounds and bytes
   one a wave) at config 4's, each beside its
   plain version and bound (the halo copy beside ``torch.cat`` and the
   exchange beside ``torch.index_select`` of the flattened stripes, and
   the earlier yardstick ``torch.stack(...).sum(0)``); (g) the config 3
   engine's per-shard ledger after ``warm_compile``, and a
   plan that only the hottest shard's slice of the budget refuses, whose
   walk evicts each rung once for the whole mesh down to the warm ladder;
11. list — on the deep phase's engine and store: 200 ListObjects ("which
   issues may user-u view") and 200 ListSubjects ("which users may view
   issue-j"), each against its analytic expected set from the generator's
   maps; p50/p99 seconds and items/s per orientation (cache misses only),
   the route counts (every listing on the card), K5's runs and steps, the
   upload seconds of each orientation; then 50 of each against the host
   lister on the same snapshot, 10 ListSubjects against the Manager oracle,
   and 20 ListObjects answers through a Check batch (every listed issue
   allowed, as many unlisted ones denied); K5 (a whole run, its kernel
   alone, its launches and host reads a run) and K8 are timed at the
   path's shapes beside their plain versions and bounds;
12. explain — on the deep phase's engine and store, labels on: the 100k
   checks through ``batch_check_stream`` (ordered) and through
   ``batch_check_stream_with_token(ordered=False, with_info=True)``, each
   equal to ``batch_check`` and the expectation with every offset
   delivered once, reported with slices and queries per route, checks/s
   against the batch path, slice service-time p50/p99, the controller's
   final width and the device busy share (CUDA-event spans of each slice's
   kernels over the wall time); 8,192 checks at a pinned width of 1,024,
   every fourth a wildcard-relation check ("may user u do anything on repo
   r?", two starts, never label-certifiable), whose every slice must land
   as ``hybrid`` (a label output and a BFS sub-batch) equal to
   ``batch_check`` and the expectation; the 100k checks ten times over in
   one stream (1M), long enough that slices land after the first window
   and the controller's ``cap()`` must move, each decision equal to the
   expectation; no staging lease outstanding after any stream; then 200
   ``ExplainEngine.explain`` calls —
   50 denies, and 150 grants of which up to 50 route to ``hybrid`` and the
   rest to ``label`` (two thirds of those between interior rows: a team's
   ancestor or a root team's org, whose explain names a landmark) — each
   with the expected decision, grants verified by back-trace, denies
   certified, no verify failure or divergence, and every label/hybrid
   grant's ``landmark_dev`` equal to the host index's ``witness_landmark``
   with the label witness launched once per interior pair; explain p50/p99
   seconds; the label witness is then timed at one pair and at 65,536
   pairs on config 4's label arrays beside its plain version and bound;
13. write — the deep phase's engine and store take writes through the
   store, as the REST write API makes them: (a) the reference bench's
   burst of 5,000 new team memberships (interior→sink edges: the labels
   stay live, the background fold absorbs the burst), (b) 64 new
   team→team edges between active interior team rows in two writes (the
   overlay ELL: the second write lands in the resident overlay by the
   slot set; the label route stops until the fold patches the labels on
   the card; 20 explains at the write's snaptoken, on the new edges, must
   take the BFS route with no landmark, with verified witnesses, deciding
   as the host lister and the oracle do), (c) deletes of 64 team-nesting edges (bucket slots patched
   by the slot set) and of the 5,000 burst memberships (tombstones). After
   each step: the seconds until ``snapshot_serving()`` reaches the
   watermark, a 100k-check batch's checks/s and route counts, the
   maintenance counters, and 100 decisions (half on touched teams)
   against the oracle, and 100 ListObjects for users the step touched plus
   100 ListSubjects for issues granted to the touched teams, each against
   the host lister on the same snapshot (K5's overlay stage must launch in
   (b), K9's list site in (c), and every fold must clear the list mirror);
   then the fold. The store's rows are built before the burst (the deep
   phase timed that apart), so no ``store_s`` pays it. At the end the 100k
   decisions and the last listings are
   held against a fresh engine built on the final store (the rebuild the
   write path replaced, its labels built on the card) and no full rebuild
   may have happened; K9 is timed on the largest bucket-patch call (every
   bucket in one fused launch: the copy and the patch; one launch and no
   host read a call, or the row fails), and K5 on the first
   fixpoint that ran with the overlay pending, against its plain version;
14. serve — the REST server with the default engine (labels on) and a
   decision log sampling every check: ``GET /check/explain`` on a grant
   (a verified witness) and a deny (a certificate), the cat-videos checks
   (200, 200, 403, 200) read back from the decision log, read-your-writes
   after a PUT,
   /check/batch, then a PUT that closes a cycle and a batch over it, then
   a ListObjects and a paged ListSubjects over REST; each part fails
   unless its requests launched the kernels of the routes that answered
   them; then the tuple API: ``/version`` on both ports, ``GET /expand``
   (trees equal to the Manager-backed engine's on the same store at the
   clamped depth, a 400 without ``max-depth``), ``GET /relation-tuples``
   paged one tuple at a time (equal to the store's own read), and a
   ``PATCH /relation-tuples`` of an insert and a delete, read back through
   ``/relation-tuples``, ``/check`` and ``/expand``; last, 64 concurrent
   keyed ``PUT /relation-tuples`` (``X-Idempotency-Key``, one keep-alive
   connection a writer), each resent once: every resend replays its token,
   the daemon's group-commit coordinator commits them in fewer groups than
   writers, and ``GET /check?snaptoken=`` reads every write. The daemon
   traces to an ``otlp-file`` span file and keeps a bundle directory: after
   a traced ``GET /check`` and the drain, every span line must parse, the
   check's request span must have its stage spans (``device`` among them)
   as children and the ``drain`` bundle must validate.

``--only`` names a subset; ``lanes``, ``labels``, ``hbm`` and ``cli`` need ``main``,
``shard`` needs ``main`` and ``deep``, ``cache``, ``list`` and ``explain`` need ``deep`` and
``write`` needs ``list`` (they run on that phase's engine and store), and a subset
that breaks this exits non-zero.

Output: progress lines, the ``{"kernels": [...]}`` line, the card line, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import collections
import json
import random
import subprocess
import sys
import time
import types
import urllib.request

PHASES = ("build", "parity", "main", "lanes", "labels", "hbm", "cli", "deep", "cache", "shard",
          "list", "explain", "write", "serve")
#: a phase that runs on the engine and store of another
PHASE_NEEDS = {"lanes": ("main",), "labels": ("main",), "hbm": ("main",), "cli": ("main",),
               "shard": ("main", "deep"),
               "cache": ("deep",), "list": ("deep",),
               "explain": ("deep",), "write": ("list",)}
SEED = 20261017
N_TUPLES = 1_000_000
N_CHECKS = 100_000
ORACLE_SAMPLE = 2_000
#: BASELINE config 4 at its full size
DEEP_TUPLES = 10_000_000
DEEP_ORACLE_SAMPLE = 250
#: the write phase: the reference bench's burst (bench.py:894-909), the
#: overlay-ELL edges of step (b) in two writes, the deleted nesting edges
WRITE_BURST = 5_000
WRITE_ELL = (40, 24)
WRITE_DELETE_ELL = 64
WRITE_ORACLE_SAMPLE = 100
#: explains after step (b), on its new team→team edges
WRITE_EXPLAINS = 20
#: the list phase: listings per orientation, the host-lister and Check
#: cross-check samples, the oracle sample (ListSubjects only: the oracle's
#: ListObjects walks the store by subject, which it does not index)
LIST_QUERIES = 200
LIST_HOST_SAMPLE = 50
LIST_CHECK_SAMPLE = 20
LIST_ORACLE_SAMPLE = 10
#: listings per orientation after each write step
WRITE_LIST_QUERIES = 100

#: the TPU kernels these CUDA kernels replace
K1 = "keto_tpu/check/tpu_engine.py:89"
K2 = "keto_tpu/check/tpu_engine.py:110"
K3 = "keto_tpu/check/tpu_engine.py:310"
K6 = "keto_tpu/graph/label_build.py:150"
K7 = "keto_tpu/graph/label_build.py:183"
K9 = ("keto_tpu/check/tpu_engine.py:2542 (and :2665; keto_tpu/graph/label_build.py:433; "
      "keto_tpu/list/tpu_engine.py:337)")
K5 = "keto_tpu/list/tpu_engine.py:76"
#: the counts of the kernels one K5 fixpoint run launches
K5_KERNELS = ("list_fixpoint",)
K8 = "keto_tpu/graph/device_build.py:54"
K4 = "keto_tpu/check/tpu_engine.py:352"
K10A = "keto_tpu/parallel/sharded.py:327"
K10B = "keto_tpu/parallel/sharded.py:473"
K10C = "keto_tpu/parallel/sharded.py:559"
SHARD_SRC = "keto_tpu_torch/csrc/shard_kernels.cu"
LABEL_SRC = "keto_tpu_torch/csrc/label_kernels.cu"

#: per H100 variant, by a word of its nvidia-smi name: memory rate (B/s),
#: SMs and boost clock (Hz), from NVIDIA's H100 data sheet (SXM5 HBM3
#: 3.35 TB/s, PCIe HBM2e 2.0 TB/s, NVL HBM3 3.9 TB/s) and the Hopper
#: architecture white paper (SM counts and boost clocks). Int32 compares
#: run on 64 INT32 lanes per SM and clock.
CARDS = (
    ("NVL", 3.9e12, 132, 1.785e9),
    ("PCIe", 2.0e12, 114, 1.755e9),
    ("HBM3", 3.35e12, 132, 1.98e9),
)
INT32_LANES_PER_SM = 64


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> tuple[float, float]:
    """(memory rate in B/s, int32 compare rate in op/s) of the H100 variant
    named; exits for a card outside the table."""
    if "H100" in name:
        for word, rate, sms, clock in CARDS:
            if word in name:
                return rate, sms * INT32_LANES_PER_SM * clock
    raise SystemExit(f"no data-sheet rates for {name!r}: bounds are stated for H100 "
                     f"variants ({', '.join(w for w, *_ in CARDS)})")


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


def paired_ms(fn, other, turns: int = 5, reps: int = 20) -> tuple:
    """``time_ms`` of ``fn`` and of ``other`` (None: not timed) in turns,
    ``fn`` first: their medians and every turn's pair."""
    pairs = [(time_ms(fn, reps), None if other is None else time_ms(other, reps))
             for _ in range(turns)]
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return (med([a for a, _ in pairs]), None if other is None else med([b for _, b in pairs]),
            pairs)


def time_fresh_ms(fn, make, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn(*state)`` over ``reps`` calls, each on its
    own ``state = make()``, all made before the timed loop: for a kernel
    that updates its inputs in place, so every timed call does the work of
    the first."""
    import torch

    states = [make() for _ in range(warmup + reps)]
    for s in states[:warmup]:
        fn(*s)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for s in states[warmup:]:
        fn(*s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serial_build_seconds(_build) -> float:
    """Seconds of one nvcc over every source into one library, in a
    temporary directory under the build directory: the cold build the
    parallel one (one nvcc per source) is compared with."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        t0 = time.monotonic()
        subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-o", f"{d}/lib.so",
                        *map(str, _build.sources())], check=True, capture_output=True)
        return time.monotonic() - t0


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
#: narrow and odd widths (a word at a time), caps past 1,024, it_cap cuts
#: inside a block of steps (a generator of their own, so the layouts above
#: and after stay as they were)
NARROW_CASES = [
    dict(W=3, caps=(1, 2, 1100), rows=(40, 10, 2), n_int=90, overlay=True, block_iters=2),
    dict(W=5, caps=(1, 4, 2048), rows=(40, 8, 2), n_int=90),
    dict(W=5, caps=(1,), rows=(60,), chain=True, it_cap=7, block_iters=4),
    dict(W=3, caps=(1,), rows=(60,), chain=True, it_cap=5, block_iters=3, overlay=True),
    dict(W=12, caps=(1, 1100), rows=(30, 3), n_int=60, overlay=True),
]


def run_parity(torch, kernels, plan, R0, P0, run_kw, plain, G=None) -> tuple:
    """``keto_check_run`` of ``plan`` on a copy of ``R0`` into ``P0`` (its run
    rows sentinel-filled) against its plain version ``plain(R, P)`` on
    another copy: mismatching words of R, P and the state's {changed,
    steps}, the steps and the halo copies the card counted, and the plain
    state."""
    Rc, Rr = R0.clone(), R0.clone()
    Pr = torch.zeros_like(P0)
    kernels.reset_run_counts()
    state = kernels.check_run_cuda(plan, Rc, P0, G=G, **run_kw)
    steps, copies = kernels.run_counts()
    want = plain(Rr, Pr)
    torch.cuda.synchronize()
    m = diff(Rc, Rr)[0] + diff(P0, Pr)[0] + diff(state[:2], want[:2])[0]
    return m, steps, copies, want


def phase_parity(torch, kernels, rows_out):
    import numpy as np

    from keto_tpu_torch.check.random_layouts import SENTINEL, random_case

    rng = np.random.default_rng(SEED)
    narrow = np.random.default_rng(SEED + 10)
    dev = torch.device("cuda")
    total = 0
    for i, case in enumerate(PARITY_CASES + NARROW_CASES):
        gen = rng if i < len(PARITY_CASES) else narrow
        buckets, entries, ov, kw = random_case(gen, **case)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        nb = [t(b) for b in buckets]
        ent = t(entries)
        ovn, ovd = (None, None) if ov is None else (t(ov[0]), t(ov[1]))
        before = dict(kernels.COUNTS)
        reads = host_reads(torch, lambda: kernels.check_step_cuda(nb, ent, ovn, ovd, **kw))
        launched = {k: kernels.COUNTS[k] - before[k] for k in kernels.BFS_KERNELS}
        got = kernels.check_step_cuda(nb, ent, ovn, ovd, **kw)
        want = kernels.check_step_ref(nb, ent, ovn, ovd, **kw)
        torch.cuda.synchronize()
        m, _ = diff(got, want)
        # a step is the seeds, one run (none without active rows) and the
        # answer, with no host read in between
        m += int(reads != 0) + int(launched != {"seed": 1, "answer_pack": 1,
                                               "check_run": int(bool(kw["n_active"]))})
        tail = got[-2:].tolist()
        line = ""
        n_active, n_int = kw["n_active"], kw["n_int"]
        if n_active:
            W = kw["sizes"][3] // 32
            R = torch.from_numpy(
                gen.integers(0, 2**32, size=(n_int + 1, W), dtype=np.uint64)
                .astype(np.uint32).view(np.int32)
            ).to(dev)
            R[-1] = 0
            # K1 alone into a sentinel-filled output, one launch
            P = torch.full((n_active + 2, W), SENTINEL, dtype=torch.int32, device=dev)
            pulls = kernels.COUNTS["pull"]
            kernels.pull_cuda(nb, kw["valid_rows"], R, P=P)
            m_pull = diff(P[:n_active], kernels.pull_ref(nb, kw["valid_rows"], R))[0]
            m_pull += int((P[n_active:] != SENTINEL).sum()) + int(kernels.COUNTS["pull"] - pulls != 1)
            # the run alone into a sentinel-filled P
            R0, _ = kernels.seed_ref(ent, kw["sizes"], n_int, W)
            P0 = torch.full((n_active + 1, W), SENTINEL, dtype=torch.int32, device=dev)
            P0[n_active] = 0
            plan = kernels.bucket_runs(nb, kw["valid_rows"], src_rows=n_int + 1, W=W)
            run_kw = dict(ov=kernels.RunOverlay.of(ovn, ovd, n_active), it_cap=kw["it_cap"],
                          block_iters=kw["block_iters"])
            m_run, steps, copies, ref = run_parity(
                torch, kernels, plan, R0, P0, run_kw,
                lambda R, P: kernels.check_run_ref(nb, kw["valid_rows"], R, P, ovn, ovd,
                                                   it_cap=kw["it_cap"],
                                                   block_iters=kw["block_iters"]))
            m_run += int((steps, copies) != (int(ref[1]), 0))
            m += m_pull + m_run
            line = f", pull mismatches={m_pull}, run mismatches={m_run} (steps {steps})"
        log(f"parity case {i}: {case} -> iters={tail[0]} truncated={tail[1]}, host reads {reads}, "
            f"launches {launched}{line}, mismatches={m}")
        total += m
    total += label_parity(torch, rng, dev)
    total += witness_parity(torch, rng, dev)
    total += slot_parity(torch, rng, dev)
    total += list_parity(torch, rng, dev)
    total += sort_parity(torch, rng, dev)
    total += shard_parity(torch, rng, dev)
    total += answer_parity(torch, dev)
    rows_out["parity_mismatches"] = total
    if total:
        raise SystemExit(f"kernel parity FAILED: {total} mismatching words")


#: the answer kernels' parity layouts (``random_answer_case``): K2's
#: ``keto_answer_pack`` at (W, n_int, n_active), K10a's ``keto_shard_answer``
#: at (W, n_int, shard counts), each for every kind
ANSWER_WIDTHS = [(1, 96, 64), (3, 96, 64), (5, 200, 150), (64, 300, 200), (4096, 4095, 3000)]
SHARD_ANSWER_WIDTHS = [(1, 96, range(1, 9)), (3, 96, range(1, 9)), (5, 200, range(1, 9)),
                       (8, 300, range(1, 9)), (4096, 4095, (4,))]


def answer_parity(torch, dev) -> int:
    """K2's and K10a's answer kernels, ONE launch each, against their plain
    versions on every ``random_answer_case`` layout (random entries, a word
    whose 32 queries all hit, every sink entry in one word, passive and
    absent targets, targets and sink rows no shard owns; W = 1, 3, 5, 8, 64
    and 4,096; g = 1..8): mismatching words, launches and host reads."""
    import numpy as np

    from keto_tpu_torch.check import kernels
    from keto_tpu_torch.check.random_layouts import ANSWER_KINDS, random_answer_case
    from keto_tpu_torch.parallel import sharded as ps

    rng = np.random.default_rng(SEED + 12)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    total = 0
    state = torch.tensor([1, 6, 0], dtype=torch.int32, device=dev)
    for kind in ANSWER_KINDS:
        m = n = 0
        for W, n_int, n_active in ANSWER_WIDTHS:
            c = random_answer_case(rng, kind, W, n_int=n_int, n_active=n_active)
            args = (t(c["entries"]), c["sizes"], n_active, t(c["P"]), t(c["ans_base"]), t(c["R"]))
            before = kernels.COUNTS["answer_pack"]
            reads = host_reads(torch, lambda: kernels.answer_pack_cuda(*args, state))
            got = kernels.answer_pack_cuda(*args, state)
            m += diff(got, kernels.answer_pack_ref(*args, 6, True))[0] + int(reads != 0)
            m += int(kernels.COUNTS["answer_pack"] - before != 2)
            n += 1
        for W, n_int, gs in SHARD_ANSWER_WIDTHS:
            for g in gs:
                c = random_answer_case(rng, kind, W, n_int=n_int, g=g)
                args = (t(c["entries"]), c["sizes"], t(c["P"]), t(c["ans_base"]), t(c["R"]),
                        c["rps"])
                out = torch.zeros(W + 3, dtype=torch.int32, device=dev)
                out[W + 2] = 0x5A5A  # the seeds' and the run's count, left as it is
                before = kernels.COUNTS["shard_answer"]
                reads = host_reads(torch, lambda: ps.shard_answer_cuda(*args, state, out.clone()))
                ps.shard_answer_cuda(*args, state, out)
                m += diff(out, ps.shard_answer_ref(*args, 6, True, 0x5A5A))[0] + int(reads != 0)
                m += int(kernels.COUNTS["shard_answer"] - before != 2)
                n += 1
        log(f"parity answers {kind}: {n} layouts (keto_answer_pack at W "
            f"{[w for w, *_ in ANSWER_WIDTHS]}, keto_shard_answer at W "
            f"{[w for w, *_ in SHARD_ANSWER_WIDTHS]}, g 1..8 and 4 at W 4,096), one launch a call, "
            f"mismatches={m}")
        total += m
    return total


#: K3's parity layouts: (n, Wo, Wi, W, live pairs, layout); "sorted" is the
#: engine's order (live pairs by query, pads with query 0 after them),
#: "k10b" the exchanged rows K10b hands K3 (pa = pb = arange(P)), "outside"
#: pairs naming rows outside the label arrays (no hit, as a pad pair)
LABEL_STEP_CASES = [
    (90, 1, 1, 1, 20, "random"), (90, 32, 1, 8, 700, "random"), (90, 1, 32, 8, 700, "random"),
    (200, 64, 64, 64, 6000, "random"), (120, 128, 32, 64, 2100, "random"),
    (120, 32, 128, 64, 2100, "random"), (60, 128, 128, 1, 100, "random"),
    (3000, 64, 64, 4096, 300_000, "random"), (500, 2, 8, 4096, 140_000, "random"),
    (90, 3, 5, 8, 700, "random"), (90, 5, 3, 8, 700, "random"),
    (120, 33, 65, 64, 2100, "random"), (120, 65, 33, 64, 2100, "random"),
    (500, 8, 2, 4096, 140_000, "sorted"), (500, 3, 5, 4096, 140_000, "sorted"),
    (300, 33, 5, 64, 6000, "sorted"), (300, 200, 3, 64, 6000, "sorted"),
    (500, 8, 2, 4096, 140_000, "k10b"), (200, 5, 33, 64, 6000, "k10b"),
    (200, 65, 3, 64, 6000, "outside"), (200, 8, 2, 64, 6000, "outside"),
]
SWEEP_CASES = [  # (n, caps, rows per group, wt): the whole sweep (K6)
    (100, (1, 2, 4), (30, 10, 5), 1), (100, (1, 2, 4), (30, 10, 5), 2),
    (300, (1, 4096), (100, 3), 2), (5000, (1, 2, 8, 64, 1024), (2000, 800, 300, 40, 4), 2),
    (400, (8, 32, 64), (40, 12, 6), 5),
]
COVERED_CASES = [  # (label rows T, width, lanes, wt, own pad, own width (0: width), rows past T)
    (1000, 64, 64, 2, -1, 0, 0), (1000, 64, 32, 1, -2, 0, 0), (700, 16, 1, 2, -2, 0, 13),
    (5000, 64, 33, 2, -1, 16, 0), (3001, 3, 64, 2, -2, 0, 7), (900, 12, 96, 3, -1, 0, 0),
    (4000, 32, 160, 5, -2, 64, 0), (123950, 64, 64, 2, -1, 0, 3), (30000, 1, 32, 1, -2, 0, 0),
    (700, 4, 64, 2, -1, 0, 0), (30000, 1, 64, 2, -2, 0, 5), (700, 8, 96, 3, -1, 0, 0),
    (700, 2, 96, 3, -2, 0, 0), (5000, 1, 160, 5, -1, 0, 0),
]


def sweep_parity(torch, run) -> tuple[int, str]:
    """The whole sweep's kernel against its plain version through ``run(fn,
    budget)`` (``fn`` is ``sweep_cuda`` or ``sweep_ref``) with no budget,
    the run's own visits, one visit less and half of them: mismatching
    words of the stored bitmap plus mismatching {waves, visits, dry}, and
    one launch a run. Returns (mismatches, a log line)."""
    from keto_tpu_torch.graph import label_kernels as lk

    _, waves, visits, _ = run(lk.sweep_ref, None)
    m, seen = 0, []
    for budget in (None, visits, visits - 1, visits // 2):
        before = lk.COUNTS["sweep_run"]
        got = run(lk.sweep_cuda, budget)
        want = run(lk.sweep_ref, budget)
        m += diff(got[0], want[0])[0] + sum(a != b for a, b in zip(got[1:], want[1:]))
        m += abs(lk.COUNTS["sweep_run"] - before - 1)
        seen.append(list(want[1:]))
    return m, f"{waves} waves, {visits} visits; (waves, visits, dry) by budget {seen}"


def label_parity(torch, rng, dev) -> int:
    """K3, K6 and K7 against their plain versions; mismatching words. K3
    also from a bare launch, and counted: one launch a call."""
    import numpy as np

    from keto_tpu_torch.check import kernels
    from keto_tpu_torch.check.random_layouts import (
        outside_rows,
        random_covered_case,
        random_label_case,
        random_sweep_case,
    )
    from keto_tpu_torch.graph import label_build, label_kernels as lk

    t = lambda a: torch.from_numpy(a.copy()).to(dev)  # noqa: E731
    total = 0
    for n, Wo, Wi, W, pairs, layout in LABEL_STEP_CASES:
        out_lab, in_lab, entries, P, B = random_label_case(
            rng, n, Wo, Wi, W, pairs, sorted_queries=layout in ("sorted", "k10b"),
            exchanged=layout == "k10b")
        plain = entries
        if layout == "outside":
            rows, plain_rows = outside_rows(rng, entries[: 2 * P], n, pairs // 10)
            entries = np.concatenate([rows, entries[2 * P :]])
            plain = np.concatenate([plain_rows, plain[2 * P :]])
        lab = (t(out_lab), t(in_lab))
        before = kernels.COUNTS["label_step"]
        got = kernels.label_step_cuda(*lab, t(entries), n_pairs=P, B=B)
        launched = kernels.COUNTS["label_step"] - before
        want = kernels.label_step_ref(*lab, t(plain), n_pairs=P, B=B)
        bare = torch.zeros_like(want)
        _ok(kernels.label_step_launch(kernels._lib(), *lab, t(entries), P, bare,
                                      kernels._stream()), "keto_label_step")
        torch.cuda.synchronize()
        m = diff(got, want)[0] + diff(bare, want)[0] + abs(launched - 1)
        hits = int(sum(bin(w & 0xFFFFFFFF).count("1") for w in want.tolist()))
        log(f"parity label_step n={n} Wo={Wo} Wi={Wi} W={W} pairs={pairs} layout={layout} "
            f"team={kernels.label_team(Wo)}: {hits} query bits set, mismatches={m}")
        total += m
    for n, caps, rows, wt in SWEEP_CASES:
        groups, _, X0, _, cov = random_sweep_case(rng, n, caps, rows, wt)
        g = lk.EllGroups.from_groups(groups, dev)
        for prune in (True, False):
            m, log_ = sweep_parity(torch, lambda fn, b: fn(g, t(X0), t(cov), n_dst=n + 1,
                                                           prune_expansion=prune, budget=b))
            log(f"parity sweep n={n} caps={caps} wt={wt} prune={prune}: {log_}, mismatches={m}")
            total += m
    table = None
    for T, width, lanes, wt, pad, own_width, extra in COVERED_CASES:
        lab, own = random_covered_case(rng, T, width, lanes, pad=pad, own_width=own_width)
        if table is None or table.shape[0] < T or table.shape[1] != wt:
            table = torch.zeros((max(T, 123950), wt), dtype=torch.int32, device=dev)
        tab = table[:T]  # one table reused across calls, as the build does
        got = lk.covered_cuda(t(lab), t(own), wt=wt, rows=T + extra, table=tab)
        want = lk.covered_ref(t(lab), t(own), wt=wt, rows=T + extra)
        torch.cuda.synchronize()
        m = diff(got, want)[0] + int(table.count_nonzero())
        out = torch.full_like(want, 0x5A5A5A5A)  # a word the launch misses shows
        if lk.covered_launch(lk._lib(), t(lab), t(own), wt, tab, out, lk._stream()):
            raise SystemExit("kernel parity FAILED: keto_covered refused the launch")
        m += diff(out, want)[0] + int(table.count_nonzero())
        via = label_build._compute_covered(t(lab), own, lanes, wt, pad, rows=T + extra, table=tab)
        m += diff(via, want)[0]
        log(f"parity covered T={T} width={width} lanes={lanes} wt={wt} pad={pad} "
            f"own_width={own_width or width} rows={T + extra}: "
            f"{int((want != 0).any(1).sum())} rows covered, mismatches={m}")
        total += m
    lab, own = random_covered_case(rng, 500, 8, 33, pad=-1)
    own[3, 0] = 500
    try:
        label_build._compute_covered(t(lab), own, 33, 2, -1)
    except ValueError as e:
        log(f"parity covered own entry outside the label rows: raised ({e})")
    else:
        raise SystemExit("kernel parity FAILED: an own entry outside the label rows did not raise")
    return total


SLOT_CASES = [  # (what, rows, ld, entries, duplicates, 1-D, in place)
    ("bucket patch", 131072, 1, 64, False, False, False),
    ("bucket patch, cap 8", 4096, 8, 300, False, False, False),
    ("overlay rows", 64, 8, 24, False, False, False),
    ("overlay dst", 64, 1, 24, False, True, False),
    ("mirror store", 124000, 64, 3000, False, False, True),
    ("empty entry list", 1000, 4, 0, False, False, False),
    ("duplicate slots", 2000, 16, 800, True, False, False),
]


#: K4's parity layouts: (n, Wo, Wi, pairs, shuffled rows); the 65,536-pair
#: batch, odd widths, rows wider than 128 entries and the explain path's
#: single pair among them
WITNESS_CASES = [
    (60, 1, 8, 400, False), (60, 8, 1, 400, True), (90, 32, 64, 2000, False),
    (90, 64, 32, 2000, True), (120, 128, 64, 4000, False), (120, 64, 128, 4000, True),
    (80, 128, 1, 1000, True), (3000, 64, 64, 65_536, False), (3000, 64, 64, 65_536, True),
    (90, 3, 5, 700, False), (90, 5, 3, 700, True), (120, 33, 65, 2000, False),
    (120, 65, 33, 2000, True), (80, 200, 3, 1000, True), (40, 8, 2, 1, False),
    (40, 64, 64, 1, True),
]


def witness_parity(torch, rng, dev) -> int:
    """K4 against its plain version on its own layouts; mismatching words."""
    from keto_tpu_torch.check import kernels
    from keto_tpu_torch.check.random_layouts import SENTINEL, outside_rows, random_witness_case

    total = 0
    for n, Wo, Wi, pairs, shuffle in WITNESS_CASES:
        arrays = random_witness_case(rng, n, Wo, Wi, pairs, shuffle=shuffle)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = kernels.label_step_witness_cuda(*args)
        want = kernels.label_step_witness_ref(*args)
        # a bare launch into a sentinel-filled output: every word is written
        bare = torch.full_like(want, SENTINEL)
        _ok(kernels.label_witness_launch(kernels._lib(), *args, bare, kernels._stream()),
            "keto_label_witness")
        # pairs naming rows outside the label arrays answer -1, as pad pairs
        (pa, plain_a), (pb, plain_b) = (outside_rows(rng, a, n, max(1, pairs // 10))
                                        for a in arrays[2:])
        far = kernels.label_step_witness_cuda(*args[:2], *(torch.from_numpy(x).to(dev)
                                                           for x in (pa, pb)))
        far_want = kernels.label_step_witness_ref(*args[:2], *(torch.from_numpy(x).to(dev)
                                                               for x in (plain_a, plain_b)))
        torch.cuda.synchronize()
        m = diff(got, want)[0] + diff(bare, want)[0] + diff(far, far_want)[0]
        log(f"parity label_witness n={n} Wo={Wo} Wi={Wi} pairs={pairs} shuffled={shuffle} "
            f"team={kernels.label_team(Wo)}: {int((want >= 0).sum())} pairs with a landmark, "
            f"first {want[:3].tolist()}, mismatches={m}")
        total += m
    return total


#: K9 calls of several targets, one launch each: (rows, ld, entries,
#: duplicates, 1-D) per target; targets over many SLOT_TILE tiles, tiles cut
#: by a target's end, an empty entry list among them
SLOT_MANY_CASES = [
    ("bucket patch, every bucket", [(131072, 1, 64, False, False), (4097, 8, 300, False, False),
                                    (1000, 32, 0, False, False), (257, 1024, 900, True, False)]),
    ("overlay rows and dst", [(64, 8, 24, False, False), (64, 1, 24, False, True)]),
    ("mirror flush, both sides", [(124000, 64, 9000, False, False),
                                  (124000, 64, 2500, True, False)]),
]


def slot_parity(torch, rng, dev) -> int:
    """K9 against its plain version on the write path's layouts, one
    target a call and several (one launch a call); an entry outside its
    target must raise before any target is written. Mismatching words."""
    from keto_tpu_torch.check import kernels
    from keto_tpu_torch.check.random_layouts import random_slot_case

    total = 0
    for what, n, ld, m, dup, one_d, in_place in SLOT_CASES:
        buf, r, c, v = random_slot_case(rng, n, ld, m, dup=dup, one_d=one_d)
        a = torch.from_numpy(buf.copy()).to(dev)
        b = torch.from_numpy(buf.copy()).to(dev)
        got = kernels.slot_set_cuda(a, r, c, v, in_place=in_place)
        want = kernels.slot_set_ref(b, r, c, v, in_place=in_place)
        torch.cuda.synchronize()
        mism = diff(got, want)[0]
        if in_place:
            mism += diff(a, b)[0] + int(got.data_ptr() != a.data_ptr())
        else:
            mism += diff(a, torch.from_numpy(buf).to(dev))[0]  # the target is untouched
        log(f"parity slot_set {what}: shape {tuple(buf.shape)}, {m} entries, "
            f"{int((got != a).sum()) if not in_place else m} words changed, mismatches={mism}")
        total += mism
    for what, shapes in SLOT_MANY_CASES:
        cases = [random_slot_case(rng, n, ld, m, dup=dup, one_d=one_d)
                 for n, ld, m, dup, one_d in shapes]
        for in_place in (False, True):
            a = [torch.from_numpy(c[0].copy()).to(dev) for c in cases]
            b = [torch.from_numpy(c[0].copy()).to(dev) for c in cases]
            before = kernels.COUNTS["slot_set"]
            got = kernels.slot_set_many_cuda([(x, *c[1:]) for x, c in zip(a, cases)],
                                             in_place=in_place)
            launches = kernels.COUNTS["slot_set"] - before
            want = kernels.slot_set_many_ref([(x, *c[1:]) for x, c in zip(b, cases)],
                                             in_place=in_place)
            torch.cuda.synchronize()
            mism = sum(diff(g, w)[0] for g, w in zip(got, want)) + abs(launches - 1)
            if not in_place:
                mism += sum(diff(x, torch.from_numpy(c[0]).to(dev))[0] for x, c in zip(a, cases))
            log(f"parity slot_set_many {what} (in place {in_place}): {len(cases)} targets, "
                f"{sum(len(c[1]) for c in cases)} entries, {launches} launch, mismatches={mism}")
            total += mism
    buf, r, c, v = random_slot_case(rng, 100, 4, 10)
    c[3] = 4
    other, ro, co, vo = random_slot_case(rng, 5000, 8, 40)
    keep = [torch.from_numpy(other).to(dev), torch.from_numpy(buf).to(dev)]
    before = kernels.COUNTS["slot_set"]
    try:
        kernels.slot_set_many_cuda([(keep[0], ro, co, vo), (keep[1], r, c, v)], in_place=True)
    except ValueError as e:
        torch.cuda.synchronize()
        changed = diff(keep[0].cpu(), torch.from_numpy(other))[0] + \
            diff(keep[1].cpu(), torch.from_numpy(buf))[0]
        log(f"parity slot_set out of range: raised ({e}); {changed} words of its targets "
            f"changed, {kernels.COUNTS['slot_set'] - before} launches")
        if changed or kernels.COUNTS["slot_set"] != before:
            raise SystemExit("kernel parity FAILED: an out-of-range slot set wrote its targets")
    else:
        raise SystemExit("kernel parity FAILED: an out-of-range slot set did not raise")
    return total


def list_parity(torch, rng, dev) -> int:
    """K5 against its plain version on the card over its parity layouts
    (the base pull alone, an overlay into active rows, an overlay into
    passive rows, a chain that it_cap truncates, no active row but an
    overlay, all 32 lanes; lane 31 seeded in each). Mismatching words."""
    import numpy as np

    from keto_tpu_torch.check.random_layouts import (
        LIST_CASES, LIST_WIDE_CASES, list_case_inputs, list_case_tuples, random_list_layout)
    from keto_tpu_torch.graph.carry import device_list_from_arrays, list_layout_arrays
    from keto_tpu_torch.graph.snapshot import build_snapshot
    from keto_tpu_torch.list import kernels as lk
    from keto_tpu_torch.persistence.memory import MemoryPersister
    from keto_tpu_torch import namespace as tns

    nm = tns.MemoryManager([tns.Namespace(id=1, name="g"), tns.Namespace(id=2, name="d")])
    total = 0
    for kind in LIST_CASES:
        tuples, orient = list_case_tuples(kind, rng)
        store = MemoryPersister(nm)
        store.write_relation_tuples(*tuples)
        arrays, meta = list_layout_arrays(build_snapshot(*store.snapshot_rows()), orient)
        R0, ovn, ovd, it_cap, block_iters = list_case_inputs(kind, rng, meta["n_rows"],
                                                             meta["n_active"])
        dl = device_list_from_arrays(arrays, meta, dev)
        t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        kw = dict(n_active=dl.n_active, valid_rows=dl.valid_rows, it_cap=it_cap,
                  block_iters=block_iters)
        iters0 = lk.COUNTS["list_iters"]
        got = lk.list_step_cuda(dl.buckets, t(R0), t(ovn), t(ovd), **kw)
        want = lk.list_step_ref(dl.buckets, t(R0), t(ovn), t(ovd), **kw)
        torch.cuda.synchronize()
        m, _ = diff(got, want)
        grown = int((want != t(R0)).sum())
        log(f"parity list_step {kind}: {meta['n_rows']} rows, {meta['n_active']} active, "
            f"overlay {None if ovn is None else list(ovn.shape)}, "
            f"{lk.COUNTS['list_iters'] - iters0} steps, {grown} words grew, mismatches={m}")
        total += m
    for caps, rows, passive, K, it_cap, block_iters in LIST_WIDE_CASES:
        buckets, R0, ovn, ovd = random_list_layout(rng, caps, rows, passive, K)
        t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        nb = [t(b) for b in buckets]
        kw = dict(n_active=sum(rows), valid_rows=rows, it_cap=it_cap, block_iters=block_iters)
        before = dict(lk.COUNTS)
        got = lk.list_step_cuda(nb, t(R0), t(ovn), t(ovd), **kw)
        steps = lk.COUNTS["list_iters"] - before["list_iters"]
        m = abs(lk.COUNTS["list_fixpoint"] - before["list_fixpoint"] - 1)
        want = lk.list_step_ref(nb, t(R0), t(ovn), t(ovd), **kw)
        torch.cuda.synchronize()
        m += diff(got, want)[0]
        log(f"parity list_fixpoint caps={caps} rows={rows} passive={passive} overlay={K} "
            f"it_cap={it_cap} block_iters={block_iters}: {steps} steps, "
            f"{int((want != t(R0)).sum())} words grew, mismatches={m}")
        total += m
    return total


def sort_parity(torch, rng, dev) -> int:
    """K8 against its plain version on the card over its parity layouts (10M
    keys in [0, 5.2M) the largest); each permutation also equals
    ``np.argsort(kind="stable")``. Mismatching words."""
    import numpy as np

    from keto_tpu_torch.check.random_layouts import SORT_CASES, sort_case_keys
    from keto_tpu_torch.graph import sort_kernels as sk

    total = 0
    for kind in SORT_CASES:
        keys = sort_case_keys(kind, rng, tile=sk.TILE, big=(10_000_000, 5_200_000))
        t = torch.from_numpy(keys).to(dev)
        before = dict(sk.COUNTS)
        got = sk.radix_argsort_cuda(t)
        ran = sk.COUNTS["radix_pass"] - before["radix_pass"]
        want = sk.radix_argsort_ref(t)
        lib = torch.argsort(t, stable=True).to(torch.int32)
        torch.cuda.synchronize()
        m, _ = diff(got, want)
        m_lib, _ = diff(got, lib)
        host = np.argsort(keys, kind="stable")
        m_np = int((got.cpu().numpy() != host).sum()) if host.size else 0
        log(f"parity radix_argsort {kind}: {keys.size} keys, {ran} passes run, mismatches={m} "
            f"(vs np.argsort stable: {m_np}, vs torch.argsort stable: {m_lib})")
        total += m + m_np + m_lib
    return total


#: K10a's parity layouts (``random_case`` arguments), each at every g of
#: SHARD_GS: uneven last shards (n_int + 1 rows rarely divide by 3 or 4),
#: overlays (their pad rows owned by no shard), it_cap truncation, bit 31,
#: no active row; plus every layout with all-sentinel entries
SHARD_CASES = [
    dict(W=1, caps=(1, 2, 4, 8), rows=(40, 20, 10, 5), n_int=100),
    dict(W=8, caps=(1, 2048), rows=(60, 3), n_int=101, block_iters=3),
    dict(W=64, caps=(1, 16, 1024), rows=(50, 9, 2), n_int=70, overlay=True, block_iters=1),
    dict(W=4096, caps=(1, 2, 64), rows=(40, 10, 1), n_int=81),
    dict(W=8, caps=(1,), rows=(60,), n_int=64, chain=True, it_cap=3, block_iters=1),
    dict(W=64, caps=(1,), rows=(50,), n_int=64, chain=True, block_iters=3, overlay=True),
    dict(W=8, n_int=30),
]
#: K10a's narrow and odd widths, a cap past 1,024 and an it_cap cut inside a
#: block of steps (seeded by a generator of their own)
SHARD_NARROW_CASES = [
    dict(W=3, caps=(1, 2, 1100), rows=(40, 10, 2), n_int=90, overlay=True, block_iters=2),
    dict(W=5, caps=(1,), rows=(60,), n_int=64, chain=True, it_cap=7, block_iters=4),
    dict(W=1, caps=(1, 2048), rows=(30, 2), n_int=41, overlay=True),
]
SHARD_GS = (1, 2, 3, 4)
#: K10c's parity layouts: (n, caps, rows per group, wt, expansion pruning)
SHARD_SWEEP_CASES = [
    (40, (1, 2, 4), (10, 8, 5), 1, True), (33, (1, 8), (20, 6), 2, False),
    (700, (1, 2, 16, 128), (300, 100, 30, 3), 2, True), (701, (1, 4), (500, 50), 1, False),
]


def _sentinel_entries(spec, B):
    """The all-padding geometry (the reference's warm slice): every entry
    a dropped or padded sentinel, routed to the shards."""
    import numpy as np

    from keto_tpu_torch.parallel.sharded import route_entries

    ni = spec.n_int
    e_rows = np.full(B, ni + 1, np.int32)
    e_q = np.zeros(B, np.int32)
    packed = (e_rows, e_q, e_rows, e_q, np.full(B, ni, np.int32), e_q, np.full(B, ni, np.int32))
    return route_entries(spec, packed, B)[0]


def shard_parity(torch, rng, dev) -> int:
    """K10's kernels against their plain versions on the card, every output
    word, at g in 1..4: the sharded BFS step (K10a, and the g = 1 program
    against the single-device K2: its words [0, W+2) equal K2's and its
    popcount word equals every g's), the sharded label step (K10b, and
    against the single-device K3) and the sharded sweep (K10c, and against
    the single-device sweep on the same rows). Mismatching words."""
    import numpy as np

    from keto_tpu_torch.check import kernels
    from keto_tpu_torch.check.random_layouts import (
        SENTINEL, random_label_case, random_shard_case, random_sweep_case)
    from keto_tpu_torch.graph import label_kernels as lk
    from keto_tpu_torch.parallel import make_mesh
    from keto_tpu_torch.parallel import sharded as ps

    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    total = 0
    narrow = np.random.default_rng(SEED + 11)
    for i, case in enumerate(SHARD_CASES + SHARD_NARROW_CASES):
        seed = int((rng if i < len(SHARD_CASES) else narrow).integers(1 << 30))
        pop1 = None
        for g in SHARD_GS:
            mesh = make_mesh(graph=g, device=dev)
            single, (spec, ent, ov, kw) = random_shard_case(np.random.default_rng(seed), g, **case)
            bk = ps.ShardedBuckets.from_spec(spec, dev)
            ovn, ovd = (None, None) if ov is None else (t(ov[0]), t(ov[1]))
            ent_d = t(ent)
            before = dict(kernels.COUNTS)
            reads = host_reads(torch, lambda: ps.check_step_cuda(mesh, bk, ent_d, ovn, ovd, **kw))
            launched = {k: kernels.COUNTS[k] - before[k] for k in
                        ("seed", "check_run", "shard_answer", "pull", "answer_pack")}
            got = ps.check_step_cuda(mesh, bk, ent_d, ovn, ovd, **kw)
            want = ps.check_step_ref(mesh, bk, ent_d, ovn, ovd, **kw)
            pad = _sentinel_entries(spec, kw["B"])
            got0 = ps.check_step_cuda(mesh, bk, t(pad), ovn, ovd, **kw)
            want0 = ps.check_step_ref(mesh, bk, t(pad), ovn, ovd, **kw)
            torch.cuda.synchronize()
            m = diff(got, want)[0] + diff(got0, want0)[0]
            # a step is g seeds, ONE run over every shard and ONE answer, with
            # no host read in between
            m += int(reads != 0) + int(launched != {"seed": g, "check_run": 1, "shard_answer": 1,
                                                    "pull": 0, "answer_pack": 0})
            W = kw["B"] // 32
            m += int((got0[:W] != 0).sum())  # an all-padding slice decides nothing
            b, e, o, k1 = single
            if g == 1 and k1["n_active"]:
                one = kernels.check_step_cuda([t(x) for x in b], t(e), *(
                    (None, None) if o is None else (t(o[0]), t(o[1]))), **k1)
                m += diff(got[: W + 2], one)[0]
            pop = int(got[W + 2]) & 0xFFFFFFFF
            pop1 = pop if pop1 is None else pop1
            m += int(pop != pop1)
            # the run alone into a sentinel-filled P, against its plain
            # version; a halo copy each step run
            rps = kw["rps"]
            plan = ps.shard_runs(bk, g, rps, W)
            R0 = torch.zeros((g * rps, W), dtype=torch.int32, device=dev)
            for s in range(g):
                R0[s * rps : (s + 1) * rps] = kernels.seed_ref(ent_d[s], kw["sizes"], rps - 1, W)[0]
            P0 = torch.full((g * rps, W), SENTINEL, dtype=torch.int32, device=dev)
            P0[plan.n_rows :] = 0
            loop = dict(it_cap=kw["it_cap"], block_iters=kw["block_iters"])
            m_run, steps, copies, ref = run_parity(
                torch, kernels, plan, R0, P0, dict(ov=kernels.RunOverlay.of(ovn, ovd, rps, rps),
                                                   **loop),
                lambda R, P: ps.shard_run_ref(plan, R, P, ovn, ovd, rps=rps, **loop),
                G=torch.empty_like(R0))
            m_run += int(not steps == copies == int(ref[1]))
            m += m_run
            log(f"parity shard check_step case {i} g={g} rps={rps} "
                f"iters={int(got[W])} truncated={int(got[W + 1])} frontier_bits={pop}: "
                f"host reads {reads}, launches {launched}, run mismatches={m_run} (steps {steps}, "
                f"halo copies {copies}), mismatches={m}")
            total += m
    for n, Wo, Wi, W, pairs, _ in LABEL_STEP_CASES[:7] + [(301, 64, 64, 64, 6000, None)]:
        seed = int(rng.integers(1 << 30))
        for g in SHARD_GS:
            out_lab, in_lab, ent, P, B = random_label_case(np.random.default_rng(seed), n, Wo,
                                                           Wi, W, pairs)
            o_sh, i_sh, rl, _ = ps.route_labels(out_lab, in_lab, g)
            mesh = make_mesh(graph=g, device=dev)
            got = ps.label_step(mesh, t(o_sh), t(i_sh), t(ent), n_pairs=P, B=B, rl=rl)
            want = ps.label_step(make_mesh(graph=g, device="cpu"), torch.from_numpy(o_sh),
                                 torch.from_numpy(i_sh), torch.from_numpy(ent), n_pairs=P, B=B,
                                 rl=rl)
            one = kernels.label_step_cuda(t(out_lab), t(in_lab), t(ent), n_pairs=P, B=B)
            # each side's exchange alone, with rows no shard owns (negative,
            # at and past g*rl) and rows at a stripe boundary added
            extra = np.asarray([-1, -rl, g * rl, g * rl + 3, rl - 1, rl], np.int32)
            m_rows = sum(diff(ps.pair_rows_cuda(t(sh), t(np.concatenate([r, extra])), rl),
                              ps.pair_rows_ref(t(sh), t(np.concatenate([r, extra])), rl))[0]
                         for sh, r in ((o_sh, ent[:P]), (i_sh, ent[P : 2 * P])))
            torch.cuda.synchronize()
            m = diff(got.cpu(), want)[0] + diff(got, one)[0] + m_rows
            log(f"parity shard label_step n={n} Wo={Wo} Wi={Wi} W={W} pairs={pairs} g={g} "
                f"rl={rl}: {int(torch.tensor([bin(x & 0xFFFFFFFF).count('1') for x in want.tolist()]).sum())} "
                f"grants, pair_rows mismatches={m_rows}, mismatches={m}")
            total += m
    for n, caps, rows, wt, prune in SHARD_SWEEP_CASES:
        seed = int(rng.integers(1 << 30))
        groups, _, X0, _, cov = random_sweep_case(np.random.default_rng(seed), n, caps, rows, wt)
        one = lk.EllGroups.from_groups(groups, dev)
        S1, w1, v1, _ = lk.sweep_cuda(one, t(X0), t(cov), n_dst=n + 1, prune_expansion=prune)
        for g in SHARD_GS:
            rps = -(-(n + 1) // g)
            routed = ps.route_label_ell(groups, n, g, rps)
            merged = ps.sweep_ell_groups(routed, rps, dev)
            mesh = make_mesh(graph=g, device=dev)

            def slab(a):
                o = np.zeros((g * rps, wt), np.int32)
                o[: a.shape[0]] = a
                return t(o)

            def run(fn, budget):
                if fn is lk.sweep_cuda:
                    return ps.label_sweep(mesh, merged, slab(X0), slab(cov), rps=rps,
                                          prune_expansion=prune, budget=budget)
                return fn(merged, slab(X0), slab(cov), n_dst=rps, shards=g,
                          prune_expansion=prune, budget=budget)

            m, line = sweep_parity(torch, run)
            # and against the single-device sweep on the same rows
            S, w, v, _ = run(lk.sweep_cuda, None)
            m += diff(S[: n + 1], S1)[0] + int((w, v) != (w1, v1))
            pad = int(sum(int((db == rps).sum()) for _, db in routed))
            log(f"parity shard sweep n={n} caps={caps} wt={wt} prune={prune} g={g} rps={rps} "
                f"({pad} padding rows): {line}, mismatches={m}")
            total += m
    return total


# -- the build's sorts (K8) -------------------------------------------------------


def record_sorts(engine) -> list:
    """Capture every batch the engine's build sorter sorts, with its
    permutations, so the snapshot line can time the host sorter on the same
    keys and hold K8's permutations against it."""
    import numpy as np

    batches: list = []
    sorter = engine._build_sorter
    inner = sorter.argsort_many

    def many(arrays):
        out = inner(arrays)
        batches.append(([np.asarray(a) for a in arrays], out))
        return out

    sorter.argsort_many = many
    return batches


def k8_replay(batches, sort_s_card) -> dict:
    """K8 over the build's card-side batches again, on an idle card: the
    passes the build's sorts ran and skipped; ``k8_kernel_ms``, the summed
    device ms of the kernels alone (each array's ``keto_radix_hist`` and
    the passes of its plan, enqueued on scratch made beforehand, as
    ``list_sort_rows`` times them) with its share of the build's
    ``sort_s_card``; and ``k8_call_ms``, the wrapper's whole calls (scratch,
    the plan's copy-back and its one synchronisation included). CUDA events,
    mean of 3 calls a batch. These launches are measurements: the counts
    are restored after."""
    import numpy as np
    import torch

    from keto_tpu_torch.graph import sort_kernels as sk
    from keto_tpu_torch.graph.device_build import DEFAULT_MIN_EDGES

    saved = dict(sk.COUNTS)
    on_card = [arrays for arrays, _ in batches
               if max((a.size for a in arrays), default=0) >= DEFAULT_MIN_EDGES]
    uploads = [[torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()
                for a in arrays if a.size] for arrays in on_card]
    for keys in uploads:
        sk.radix_argsort_many_cuda(keys)
    r = {"k8_sorts": sk.COUNTS["radix_sort"] - saved["radix_sort"],
         "k8_passes_run": sk.COUNTS["radix_pass"] - saved["radix_pass"],
         "k8_passes_skipped": sk.COUNTS["radix_pass_skipped"] - saved["radix_pass_skipped"]}
    klib, stream = sk._lib(), sk._stream()

    def kernels_ms(keys):
        plans = [sk.radix_pass_plan(sk.radix_hist_ref(k)) for k in keys]

        def make():
            hist = torch.zeros((len(keys), sk.PASSES, sk.DIGITS), dtype=torch.int32,
                               device="cuda")
            return hist, [sk._Scratch(k, h) for k, h in zip(keys, hist)]

        def run(hist, scratch):
            for k, h in zip(keys, hist):
                klib.keto_radix_hist(k.data_ptr(), k.numel(), h.data_ptr(), stream)
            for sc, plan in zip(scratch, plans):
                sk._passes_cuda(klib, stream, sc, plan)

        return time_fresh_ms(run, make, 3, warmup=1)

    kernel = [kernels_ms(keys) for keys in uploads]
    call = [time_ms(lambda: sk.radix_argsort_many_cuda(keys), 3, warmup=0) for keys in uploads]
    sk.COUNTS.update(saved)
    r["k8_kernel_ms"] = sum(kernel)
    r["k8_call_ms"] = sum(call)
    r["k8_share_of_sort_s_card"] = r["k8_kernel_ms"] / 1e3 / sort_s_card if sort_s_card else None
    r["k8_batches"] = [{"keys": [k.numel() for k in keys], "kernel_ms": km, "call_ms": cm}
                       for keys, km, cm in zip(uploads, kernel, call)]
    return r


def sort_report(engine, batches) -> dict:
    """The build's sort seconds on the card against the host sorter on the
    same keys, the sorter's counters, and the permutation mismatches."""
    from keto_tpu_torch.graph.device_build import DEFAULT_MIN_EDGES, HostSorter

    # the batches that went to the card (the gate's side of the sorter)
    big = [(arrays, out) for arrays, out in batches
           if max((a.size for a in arrays), default=0) >= DEFAULT_MIN_EDGES]
    host = HostSorter()
    t0 = time.monotonic()
    perms = [host.argsort_many(arrays) for arrays, _ in big]
    host_s = time.monotonic() - t0
    mism = sum(int((p != q).sum()) for (_, out), ps in zip(big, perms) for p, q in zip(ps, out))
    c = engine.counters()
    info = engine.build_info or {}
    r = {"sort_s_card": info.get("sort_s", {}).get("device"),
         "sort_s_host_below_gate": info.get("sort_s", {}).get("host"),
         "host_sorter_s_same_keys": host_s,
         "device_sorted_keys": int(sum(a.size for arrays, _ in big for a in arrays)),
         "largest_sort": int(max((a.size for arrays, _ in batches for a in arrays), default=0)),
         "build_sort_bytes": info.get("build_sort_bytes"),
         "build_s": info.get("seconds"),
         "perm_mismatches_vs_host": mism,
         **{k: c.get(k, 0) for k in ("device_build_dispatches", "device_build_host_dispatches",
                                     "device_build_errors")}}
    if mism or not r["device_build_dispatches"] or r["device_build_errors"]:
        raise SystemExit(f"build sorts FAILED: {r}")
    return r


# -- the host half of a check ----------------------------------------------------


def host_paths(engine) -> dict:
    """The host path counters: resolved batches by path (engine), packed
    chunks by path and snapshot interns by path (process-wide)."""
    from keto_tpu_torch.check import native_pack
    from keto_tpu_torch.graph import native

    c = engine.counters()
    return {"resolve_native_batches": c.get("resolve_native_batches", 0),
            "resolve_python_batches": c.get("resolve_python_batches", 0),
            "pack_native_chunks": native_pack.COUNTERS["native"],
            "pack_numpy_chunks": native_pack.COUNTERS["numpy"],
            "intern_native": native.COUNTERS["native"], "intern_python": native.COUNTERS["python"]}


def require_native(phase, snap, before, after) -> None:
    """Fail unless the snapshot interned in C++ and the batch between the
    two counter reads resolved and packed only on the native paths."""
    from keto_tpu_torch.graph.native import NativeInterned

    d = {k: after[k] - before[k] for k in after}
    log(f"{phase} batch host paths: {json.dumps(d)}, snapshot interned by "
        f"{type(snap.interned).__name__}")
    if not isinstance(snap.interned, NativeInterned) or not d["resolve_native_batches"] \
            or d["resolve_python_batches"] or not d["pack_native_chunks"] \
            or d["pack_numpy_chunks"]:
        raise SystemExit(f"{phase} FAILED: the batch left the native host path: {d}")


def _median_s(fn, reps: int):
    """(median seconds, every run's seconds, the last result) of ``reps``
    calls of ``fn``."""
    import statistics

    times, out = [], None
    for _ in range(reps):
        t0 = time.monotonic()
        out = fn()
        times.append(time.monotonic() - t0)
    return statistics.median(times), times, out


def host_split(engine, snap, queries, reps: int = 3) -> dict:
    """The host half of one whole batch on each path: the resolve (the C++
    bulk resolve against the host loop) and the pack (the native walk
    against numpy; then its walk and its sink gather alone), medians of
    ``reps`` runs each. Fails unless each pair gives equal outputs."""
    import numpy as np

    from keto_tpu_torch.check import native_pack
    from keto_tpu_torch.check.pack import pack_chunk, pack_entries, walk_numpy

    import statistics

    n = len(queries)
    # the C++ call's own seconds inside each native resolve (the rest is
    # the Python loop that packs the queries into its buffer)
    interned = snap.interned
    inner, c_call_s = interned.resolve_queries, []

    def timed(buf, k):
        t0 = time.monotonic()
        out = inner(buf, k)
        c_call_s.append(time.monotonic() - t0)
        return out

    interned.resolve_queries = timed
    try:
        rn_s, rn_runs, (sd, tg, multi) = _median_s(lambda: engine._resolve_bulk(snap, queries),
                                                   reps)
    finally:
        del interned.resolve_queries
    rp_s, rp_runs, (sd2, tg2, multi2) = _median_s(
        lambda: engine._resolve_bulk_py(snap, queries), reps)
    resolve_equal = (np.array_equal(sd, sd2) and np.array_equal(tg, tg2)
                     and multi.keys() == multi2.keys()
                     and all(np.array_equal(a, b) for i in multi
                             for a, b in zip(multi[i], multi2[i])))
    pn_s, pn_runs, (pn, hn) = _median_s(
        lambda: pack_chunk(snap, sd, tg, multi, 0, n, native=True), reps)
    pp_s, pp_runs, (pp, hp) = _median_s(
        lambda: pack_chunk(snap, sd, tg, multi, 0, n, native=False), reps)
    entries_equal = hn.tobytes() == hp.tobytes() and (pn is None) == (pp is None)
    if entries_equal and pn is not None:
        (bn, zn), (bp, zp) = pack_entries(pn), pack_entries(pp)
        entries_equal = zn == zp and bn.tobytes() == bp.tobytes()
    # the pack's two native parts alone, on the whole batch: the walk of
    # the host-propagated starts and the sink answer gather
    ni, sb, nl = snap.num_int, snap.sink_base, snap.num_live
    m_host = ((sd >= ni) & (sd < sb)) | (sd >= nl)
    rows = np.concatenate([sd[m_host]] + [h for _, h in multi.values()]).astype(np.int64)
    pq = np.concatenate([np.nonzero(m_host)[0]] + [np.full(h.size, i) for i, (_, h)
                                                   in multi.items()]).astype(np.int64)
    wn_s, _, wn = _median_s(lambda: native_pack.pack_walk(snap, rows, pq, tg), reps)
    wp_s, _, wp = _median_s(lambda: walk_numpy(snap, rows, pq, tg), reps)
    sinks = tg[(sd != -1) & (tg >= sb) & (tg < nl)]
    gn_s, _, gn = _median_s(lambda: native_pack.sink_gather(snap, sinks), reps)
    gp_s, _, gp = _median_s(lambda: snap.sink_in_rows_bulk(sinks), reps)
    parts_equal = all(np.array_equal(a, b) for a, b in zip(wn[:2] + gn, wp[:2] + gp)) \
        and (wn[2] is None) == (wp[2] is None) \
        and (wn[2] is None or np.array_equal(wn[2], wp[2]))
    r = {"queries": n, "reps": reps, "resolve_native_s": rn_s, "resolve_py_s": rp_s,
         "resolve_native_runs_s": rn_runs, "resolve_py_runs_s": rp_runs,
         "resolve_c_call_s": statistics.median(c_call_s), "resolve_equal": resolve_equal, "multi_start_queries": len(multi),
         "walk_eligible": native_pack.walk_eligible(snap), "pack_native_s": pn_s,
         "pack_numpy_s": pp_s, "pack_native_runs_s": pn_runs, "pack_numpy_runs_s": pp_runs,
         "entries_equal": entries_equal, "walk_rows": int(rows.size),
         "walk_native_s": wn_s, "walk_numpy_s": wp_s, "sink_targets": int(sinks.size),
         "sink_rows": int(gn[0].size), "sink_gather_native_s": gn_s,
         "sink_gather_numpy_s": gp_s, "parts_equal": parts_equal}
    if not (resolve_equal and entries_equal and parts_equal):
        raise SystemExit(f"host path FAILED: the native and Python paths differ: {r}")
    return r


def native_intern(rows, wild):
    """The rows interned by the C++ interner, one run: (the interned graph,
    its seconds, the seconds of the C++ build call inside them; the rest
    is the Python column extraction and the arrays' copy-out)."""
    from keto_tpu_torch import _build
    from keto_tpu_torch.graph.native import native_intern_rows

    lib = _build.host_lib()
    inner, c_call_s = lib.graph_build_columnar, []

    def timed(*args):
        t0 = time.monotonic()
        handle = inner(*args)
        c_call_s.append(time.monotonic() - t0)
        return handle

    lib.graph_build_columnar = timed
    try:
        t0 = time.monotonic()
        nat = native_intern_rows(rows, wild)
        seconds = time.monotonic() - t0
    finally:
        lib.graph_build_columnar = inner
    return nat, seconds, sum(c_call_s)


def interned_equal(a, b, sample: int = 4096) -> bool:
    """Two interned graphs are equal: their edge and key arrays, their
    counts and code tables, and the keys of ``sample`` set ids and leaf ids
    spread over each range, looked up both ways."""
    import numpy as np

    if a is None or b is None:
        return False
    if (a.num_sets, a.num_leaves, a.num_obj_codes(), a.num_rel_codes()) != \
            (b.num_sets, b.num_leaves, b.num_obj_codes(), b.num_rel_codes()):
        return False
    if not all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("src", "dst", "key_ns", "key_obj", "key_rel", "key_wild")):
        return False
    sets = np.unique(np.linspace(0, a.num_sets - 1, min(sample, a.num_sets)).astype(np.int64))
    leaves = np.unique(np.linspace(0, a.num_leaves - 1, min(sample, a.num_leaves)).astype(np.int64))
    return all(a.set_key_of(int(i)) == b.set_key_of(int(i)) for i in sets) and \
        all(a.leaf_str(int(i)) == b.leaf_str(int(i)) for i in leaves)


def intern_split(store, wild):
    """The store's rows interned by the C++ interner and by the Python
    interner, one run each; fails unless the arrays and code tables are
    equal. Returns (the line's numbers, the C++ interner's graph)."""
    import numpy as np

    from keto_tpu_torch.graph.interner import intern_rows

    rows, _ = store.snapshot_rows()
    nat, native_s, c_call_s = native_intern(rows, wild)
    t1 = time.monotonic()
    py = intern_rows(rows, wild)
    t2 = time.monotonic()
    equal = nat is not None and (nat.num_sets, nat.num_leaves) == (py.num_sets, py.num_leaves) \
        and all(np.array_equal(getattr(nat, k), getattr(py, k))
                for k in ("src", "dst", "key_ns", "key_obj", "key_rel", "key_wild")) \
        and (nat.num_obj_codes(), nat.num_rel_codes()) == (py.num_obj_codes(), py.num_rel_codes())
    r = {"intern_rows": len(rows), "intern_native_s": native_s, "intern_c_call_s": c_call_s,
         "intern_py_s": t2 - t1, "intern_equal": equal}
    if not equal:
        raise SystemExit(f"host path FAILED: the native interner differs from Python's: {r}")
    return r, nat


def column_intern(store, wild, rows_interned) -> dict:
    """The store's column bundle interned once more, split into the NUL
    scan of its five string columns (``native._ucs4_ok``), the C++
    ``graph_build_ucs4`` call and the rest (the arrays' copy-out); fails
    unless the bundle is there and gives the graph that the row path
    (``rows_interned``, the C++ interner over ``snapshot_rows``) gives."""
    from keto_tpu_torch import _build
    from keto_tpu_torch.graph import native

    cols = store.snapshot_columns(store.watermark())
    if cols is None:
        raise SystemExit("host path FAILED: the store holds no column bundle")
    names = ("obj", "rel", "sid", "sso", "ssr")
    t0 = time.monotonic()
    ok = all(native._ucs4_ok(cols[k]) for k in names)
    scan_s = time.monotonic() - t0
    lib = _build.host_lib()
    inner, c_call_s = lib.graph_build_ucs4, []

    def timed(*args):
        t1 = time.monotonic()
        handle = inner(*args)
        c_call_s.append(time.monotonic() - t1)
        return handle

    lib.graph_build_ucs4 = timed
    try:
        t0 = time.monotonic()
        g = native.native_intern_columns(lib, cols, wild)
        seconds = time.monotonic() - t0
    finally:
        lib.graph_build_ucs4 = inner
    equal = interned_equal(g, rows_interned)
    r = {"columns_intern_s": seconds, "columns_nul_scan_s": scan_s,
         "columns_c_call_s": sum(c_call_s), "columns_ok": ok, "columns_equal": equal,
         "bundle_mib": sum(a.nbytes for a in cols.values()) / 2**20,
         "bundle_widths": {k: cols[k].dtype.itemsize // 4 for k in names}}
    if not (ok and equal):
        raise SystemExit(f"host path FAILED: the column intern differs from the row intern: {r}")
    return r


def host_rss() -> dict:
    """The process's resident memory now (VmRSS) and at its peak
    (``ru_maxrss``, since the process started), in MiB."""
    import resource

    now = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) / 1024
    return {"rss_mib": now,
            "peak_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}


def cold_start(phase, engine, store, store_s, snap_s, rss_stored, rss_built) -> dict:
    """The first build's path and phases, the snapshot's seconds and the
    host memory around it, then the first row materialization, timed
    apart. Fails unless the build interned from the column bundle with the
    store's rows parked."""
    from keto_tpu_torch.persistence.memory import _DeferredRows

    info = engine.build_info
    parked = isinstance(store._row_list, _DeferredRows)
    t0 = time.monotonic()
    rows, _ = store.snapshot_rows()
    mat_s = time.monotonic() - t0
    r = {"store_s": store_s, "path": info["path"], "phases_s": info["phases_s"],
         "intern_s": info["intern_s"], "build_s": info["seconds"], "snapshot_s": snap_s,
         "rows_parked_at_build": parked, "materialized_rows": len(rows),
         "materialize_s": mat_s, "after_store": rss_stored, "after_snapshot": rss_built,
         "after_materialize": host_rss()}
    log(f"{phase} cold start: {json.dumps(r)}")
    if info["path"] != "columns" or not parked:
        raise SystemExit(f"{phase} FAILED: the first build did not intern from the store's "
                         f"column bundle with its rows parked: {r}")
    return r


class ChunkPreferring:
    """A view of a store that offers only the chunked scan and prefers it:
    ``full_build`` takes its ``stream`` path over it."""

    scan_chunks_preferred = True

    def __init__(self, inner):
        self._inner = inner

    def watermark(self):
        return self._inner.watermark()

    def snapshot_scan(self, on_chunk, chunk_rows):
        return self._inner.snapshot_scan(on_chunk, chunk_rows=chunk_rows)


def snapshots_equal(a, b) -> bool:
    """Every host array of two snapshots, the buckets, both list layouts
    and the interned graphs' arrays."""
    import numpy as np

    arrays = ("raw2dev", "fwd_indptr", "fwd_indices", "sink_indptr", "sink_indices",
              "rev_indptr", "rev_indices")
    scalars = ("snapshot_id", "num_sets", "num_leaves", "num_active", "num_int", "num_live",
               "n_peeled")
    ok = all(np.array_equal(getattr(a, k), getattr(b, k)) for k in arrays)
    ok = ok and all(getattr(a, k) == getattr(b, k) for k in scalars)
    ok = ok and len(a.buckets) == len(b.buckets) and all(
        (x.offset, x.n) == (y.offset, y.n) and np.array_equal(x.nbrs, y.nbrs)
        for x, y in zip(a.buckets, b.buckets))
    ok = ok and all(np.array_equal(getattr(a, o).order, getattr(b, o).order)
                    for o in ("lay_fwd", "lay_rev"))
    return ok and all(np.array_equal(getattr(a.interned, k), getattr(b.interned, k))
                      for k in ("src", "dst", "key_ns", "key_obj", "key_rel", "key_wild"))


def streaming_line(engine, store, snap, wild) -> dict:
    """``full_build`` over a chunk-preferring view of the store (the
    ``stream`` path), with the engine's sorter and the default chunk size; fails unless
    it took that path and its snapshot equals the column build's."""
    from keto_tpu_torch.graph import stream_build

    prog = stream_build.BuildProgress()
    t0 = time.monotonic()
    got = stream_build.full_build(ChunkPreferring(store), wild,
                                  peel_seed_cap=engine._peel_seed_cap,
                                  sorter=engine._build_sorter, progress=prog)
    wall = time.monotonic() - t0
    equal = snapshots_equal(got, snap)
    r = {"path": prog.path, "seconds": wall, "phases_s": prog.durations(),
         "rows": prog.rows_ingested, "chunk_rows": stream_build.DEFAULT_CHUNK_ROWS,
         "equal_to_column_build": equal}
    log(f"streaming build: {json.dumps(r)}")
    if prog.path != "stream" or not equal:
        raise SystemExit(f"streaming build FAILED: {r}")
    return r


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
    gen_s = time.monotonic() - t0
    nm = tns.MemoryManager(RBAC_NAMESPACES)
    store = MemoryPersister(nm)
    t0 = time.monotonic()
    store.write_relation_tuples(*tuples)
    store_s = time.monotonic() - t0
    rss_stored = host_rss()
    log(f"workload: {len(tuples)} tuples, {len(queries)} checks, "
        f"{sum(expected)} expected grants ({gen_s:.1f}s to generate, {store_s:.1f}s to store)")

    engine = TorchCheckEngine(store, nm, device="cuda", labels_enabled=False)
    batches = record_sorts(engine)
    t0 = time.monotonic()
    snap = engine.snapshot()
    torch.cuda.synchronize()
    snap_s = time.monotonic() - t0
    cold = cold_start("main", engine, store, store_s, snap_s, rss_stored, host_rss())
    sorts = sort_report(engine, batches)
    sorts.update(k8_replay(batches, sorts["sort_s_card"]))  # labels off: the card is idle
    del batches
    log(f"snapshot: {snap.n_nodes} nodes, {snap.n_edges} edges, num_int={snap.num_int}, "
        f"num_active={snap.num_active}, n_peeled={snap.n_peeled}, "
        f"buckets={[(tuple(b.nbrs.shape), b.n) for b in snap.buckets]}, {snap_s:.3f}s; "
        f"build sorts {json.dumps(sorts)}")

    # the main path's run: launch counts from exactly this call (the runs'
    # steps, each a pull phase, counted on the card)
    kernels.reset_counts()
    kernels.reset_run_counts()
    torch.cuda.reset_peak_memory_stats()
    paths0 = host_paths(engine)
    t0 = time.monotonic()
    got = engine.batch_check(queries)
    torch.cuda.synchronize()
    check_s = time.monotonic() - t0
    require_native("main", snap, paths0, host_paths(engine))
    launches = dict(kernels.COUNTS)
    launches["check_run_steps"], launches["check_run_halo_copies"] = kernels.run_counts()
    peak = torch.cuda.max_memory_allocated()
    wrong = sum(g != e for g, e in zip(got, expected))
    log(f"main path: {N_CHECKS} checks in {check_s:.3f}s ({N_CHECKS / check_s:.0f} checks/s), "
        f"peak device memory {peak / 2**20:.1f} MiB, launches {launches}, "
        f"wrong vs analytic {wrong}")
    if wrong:
        raise SystemExit(f"main path FAILED: {wrong} decisions differ from the expectation")
    missing = [k for k in kernels.BFS_KERNELS if launches[k] == 0]
    if missing:
        raise SystemExit(f"main path FAILED: kernels never launched: {missing}")
    # config 3 has active rows: every BFS step is the seeds, one run and the
    # answer (keto_pull alone is not on the path: its device function is)
    if not launches["seed"] == launches["check_run"] == launches["answer_pack"] \
            or launches["pull"] or not launches["check_run_steps"]:
        raise SystemExit(f"main path FAILED: BFS steps are not one run each: {launches}")
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
    host = host_split(engine, snap, queries)
    wild = frozenset(n.id for n in RBAC_NAMESPACES if n.name == "")
    split, rows_nat = intern_split(store, wild)
    host.update(split)
    host.update(column_intern(store, wild, rows_nat))
    del rows_nat
    host.update({"paths": host_paths(engine), "checks_per_s": N_CHECKS / check_s,
                 "steady_checks_per_s": N_CHECKS / steady_s})
    log(f"main host path: {json.dumps(host)}")
    stream = streaming_line(engine, store, snap, wild)
    report["main"] = {
        "config": "BASELINE config 3 (RBAC)", "tuples": len(tuples), "checks": N_CHECKS,
        "cold_start": cold, "streaming_build": stream,
        "snapshot_s": snap_s, "check_s": check_s, "checks_per_s": N_CHECKS / check_s,
        "steady_check_s": steady_s, "steady_checks_per_s": N_CHECKS / steady_s,
        "peak_device_bytes": peak, "oracle_sample": ORACLE_SAMPLE, "oracle_mismatches": bad,
        "grants": sum(expected), "build_sorts": sorts, "host_path": host,
    }
    report["launches"] = launches
    return engine, snap, queries, (store, nm, got, expected), ctx


def kernel_rows(torch, kernels, engine, snap, queries, rate, launches):
    """Time every kernel at the main path's shapes beside its plain version
    and its bound; compare each against the plain version once more."""
    from keto_tpu_torch.check.pack import pack_chunk, pack_entries

    g = snap.device
    # the host half of the batch, timed on its own (the engine runs the same
    # calls inside batch_check)
    t0 = time.monotonic()
    sd, tg, multi = engine._resolve_bulk(snap, queries)
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

    def row(name, part, cuda_fn, plain_fn, outs, bytes_needed, reps, library=None, extra=None,
            ms=None, plain=None, n_launches=None, lib=None):
        a, b = outs
        m, err = diff(a, b)
        ms = time_ms(cuda_fn, reps) if ms is None else ms
        plain = time_ms(plain_fn, max(1, reps // 10), warmup=1) if plain is None else plain
        lib = time_ms(library, reps) if library is not None else lib
        r = {"name": name, "route": "cuda", "source": "keto_tpu_torch/csrc/check_kernels.cu",
             "replaces": K1 if name == "pull" else K2, "part": part,
             "launches": launches[name] if n_launches is None else n_launches, "mismatches": m,
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

    # the fixpoint, for realistic pull and answer inputs: one run from R0
    plan = kernels.bucket_runs(g.buckets, g.valid_rows, src_rows=n_int + 1, W=W)
    R = R0.clone()
    P = kernels.pull_out(n_active + 1, W, n_active, kw["it_cap"], "cuda")
    state = kernels.check_run_cuda(plan, R, P, it_cap=kw["it_cap"], block_iters=kw["block_iters"])
    truncated, iters = state[:2].tolist()

    # the pull must read every valid neighbour slot, each distinct source
    # row once (the all-zero sentinel row n_int needs no read), and write P
    slots = sum(n * b.shape[1] for b, n in zip(g.buckets, g.valid_rows))
    srcs = torch.unique(torch.cat([b[:n].reshape(-1) for b, n in zip(g.buckets, g.valid_rows)]))
    distinct = int((srcs < n_int).sum())
    pull_bytes = slots * word + distinct * W * word + act
    pulled = kernels.pull_cuda(g.buckets, g.valid_rows, R)
    library = None
    if all(b.shape[1] == 1 for b in g.buckets):
        # with every degree cap 1 the pull is a plain row gather
        src = torch.cat([b[:n, 0] for b, n in zip(g.buckets, g.valid_rows)])
        if diff(torch.index_select(R, 0, src), pulled)[0]:
            raise SystemExit("index_select disagrees with the pull at cap 1")
        library = lambda: torch.index_select(R, 0, src)  # noqa: E731
    Pp = torch.empty_like(pulled)
    lib_ = kernels._lib()
    stream = torch.cuda.current_stream().cuda_stream
    pull_bare = bare_ms(torch, lambda _: kernels.pull_launch(lib_, plan, R, Pp, stream), [0] * 20)

    # the run: the kernel alone (a bare launch behind a spin kernel, each on
    # its own copy of R0), the wrapper's call, the plain run
    def run_state():
        Rs = R0.clone()
        return (Rs, kernels.pull_out(n_active + 1, W, n_active, kw["it_cap"], "cuda"),
                torch.zeros(3, dtype=torch.int32, device="cuda"))

    run_kw = dict(it_cap=kw["it_cap"], block_iters=kw["block_iters"])
    run_bare = bare_ms(torch, lambda st: kernels.run_launch(lib_, plan, *st, **run_kw,
                                                            stream=stream),
                       [run_state() for _ in range(10)])
    run_wrapper = time_fresh_ms(lambda Rs, Ps, _: kernels.check_run_cuda(plan, Rs, Ps, **run_kw),
                                run_state, 10)
    run_plain = time_fresh_ms(lambda Rs, Ps, _: kernels.check_run_ref(g.buckets, g.valid_rows,
                                                                      Rs, Ps, **run_kw),
                              run_state, 2, warmup=1)
    Rr = R0.clone()
    Pr = torch.zeros_like(P)
    ref_state = kernels.check_run_ref(g.buckets, g.valid_rows, Rr, Pr, **run_kw)
    # what a step's work must move: the pull's bytes (P written once, the
    # answer's p_fix), one read of R's active prefix, and the words of R
    # that the step changes; the commit's re-read of P is the run's own
    # cost (a run that ping-pongs R would not make it), so it is not charged
    changed = words_changed(lambda Rs, Ps, k: kernels.check_run_ref(
        g.buckets, g.valid_rows, Rs, Ps, it_cap=k, block_iters=1), R0, P, iters)
    run_bytes = iters * (pull_bytes + act) + changed * word
    # the run's phases as the path runs them, stamped by the card's clock
    phases = run_phases(torch, kernels, lambda st, stamps: kernels.run_launch(
        lib_, plan, *st, **run_kw, stamps=stamps, stream=stream),
        [run_state() for _ in range(5)], iters)
    # K1 (its launches on a plan made once) and its library call timed in
    # turns, the median of each; the wrapper's calls apart
    pull_fn = lambda: kernels.pull_cuda(g.buckets, g.valid_rows, R, P=Pp)  # noqa: E731
    pull_ms, lib_ms, turns = paired_ms(
        lambda: _ok(kernels.pull_launch(lib_, plan, R, Pp, stream), "keto_pull"), library)
    row("pull", "_pull, tpu_engine.py:89-107: keto_pull alone, one launch over every bucket "
        "(on the main path the same device function is a phase of keto_check_run)",
        pull_fn, lambda: kernels.pull_ref(g.buckets, g.valid_rows, R),
        (pulled, kernels.pull_ref(g.buckets, g.valid_rows, R)),
        pull_bytes, 20, ms=pull_ms, lib=lib_ms, n_launches=launches["check_run_steps"],
        extra={"edge_slots": slots, "distinct_source_rows": distinct, "bare_ms": pull_bare,
               "wrapper_ms": time_ms(pull_fn, 20), "turns_ms": turns,
               "timed_by": "CUDA events over 20 launches back to back, in 5 turns with the "
                           "library call; the medians",
               "keto_pull_launches_main_path": launches["pull"],
               "launches_are": "pull phases of keto_check_run on the main path (counted on "
                               "the card)",
               "run_ms_per_step": run_bare / max(1, iters),
               "run_pull_phase_ms": phases["pull_ms"],
               "run_pull_phase_bound_ratio": phases["pull_ms"] / (pull_bytes / rate * 1e3)})
    row("check_run", "the guarded fixpoint, tpu_engine.py:164-216: keto_check_run, ONE "
        "cooperative launch a step (pull, commit, guard between grid barriers); ms is the "
        "kernel alone",
        None, None,
        (torch.cat([R.view(-1), P[:n_active].reshape(-1), state[:2]]),
         torch.cat([Rr.view(-1), Pr[:n_active].reshape(-1), ref_state[:2]])),
        run_bytes, 0, ms=run_bare, plain=run_plain,
        extra={"wrapper_ms": run_wrapper, "iters": iters, "truncated": truncated,
               "block_iters": kw["block_iters"], "runs": len(plan.rows),
               "ms_per_step": run_bare / max(1, iters), "pull_alone_ms": pull_bare,
               "words_changed": changed, "phases": phases,
               "bound_counts": "a step: slots, distinct source rows, P written, R's active "
                               "prefix read; the words changed written once"})

    out_c = kernels.answer_pack_cuda(entries, sizes, n_active, P, ans0, R, state)
    out_r = kernels.answer_pack_ref(entries, sizes, n_active, P, ans0, R, iters, bool(truncated))
    # what the answer must move: each target's id and each sink pair
    # (coalesced), and a 32-byte sector for every distinct sector its
    # random word gathers touch (P, ans_base, R), the answer written once
    a0 = 2 * S1 + 2 * S2
    tg, a_rows, a_q = e[a0 + 2 * SA :], e[a0 : a0 + SA], e[a0 + SA : a0 + 2 * SA]
    qw = torch.arange(B, device="cuda") >> 5
    gathers = {"P": sectors(torch, tg.clamp(max=n_active) * W + qw),
               "ans_base": sectors(torch, tg * W + qw),
               "R": sectors(torch, a_rows * W + (a_q >> 5))}
    ans_bytes = 32 * sum(gathers.values()) + word * (B + 2 * SA) + (W + 2) * word
    bare = torch.zeros_like(out_c)
    ans_ms, ans_how = graph_ms(torch, lambda: _ok(lib_.keto_answer_pack(
        entries.data_ptr(), S1, S2, SA, B, n_active, P.data_ptr(), ans0.data_ptr(), R.data_ptr(),
        W, state.data_ptr(), bare.data_ptr(), kernels._stream()), "keto_answer_pack"), 20)
    def answer_fn():
        return kernels.answer_pack_cuda(entries, sizes, n_active, P, ans0, R, state)

    row("answer_pack", "answers and bit pack, tpu_engine.py:219-243: keto_answer_pack, a warp an "
        "answer word (one ballot), sink hits one atomic a distinct word a warp; ms is the kernel "
        "alone",
        answer_fn,
        lambda: kernels.answer_pack_ref(entries, sizes, n_active, P, ans0, R, iters,
                                        bool(truncated)),
        (out_c, out_r), ans_bytes, 20, ms=ans_ms,
        extra={"timed_by": ans_how, "wrapper_ms": time_ms(answer_fn, 20), "B": B, "SA": SA,
               "sectors": gathers, "bound_counts": "bytes in 32-byte sectors: a sector per "
               "distinct sector the gathers touch, ids and pairs once, the answer once",
               "bound_4byte_ms": (word * (3 * B + 3 * SA) + (W + 2) * word) / rate * 1e3})

    # the whole step at the main path's shapes: the seeds, one run, the
    # answer, no host read in between
    step_fn = lambda: kernels.check_step_cuda(g.buckets, entries, **kw)  # noqa: E731
    before = dict(kernels.COUNTS)
    reads = host_reads(torch, step_fn)
    per_step = {k: kernels.COUNTS[k] - before[k] for k in kernels.BFS_KERNELS + ("pull",)}
    if reads or per_step != {"seed": 1, "check_run": 1, "answer_pack": 1, "pull": 0}:
        raise SystemExit(f"main path FAILED: a BFS step made {reads} host reads and launched "
                         f"{per_step}, not the seeds, one run and the answer")
    full_c = step_fn()
    full_r = kernels.check_step_ref(g.buckets, entries, **kw)
    seed_bytes = 8 * (S1 + S2) + 2 * bitmap
    row("check_step", "the whole step, tpu_engine.py:110-251: keto_seed, keto_check_run, "
        "keto_answer_pack and the step's allocations",
        step_fn, lambda: kernels.check_step_ref(g.buckets, entries, **kw), (full_c, full_r),
        seed_bytes + run_bytes + ans_bytes, 5, n_launches=launches["check_run"],
        extra={"host_reads": reads, "launches_a_step": per_step, "iters": iters,
               "wall_ms": whole_ms(torch, lambda: step_fn().tolist(), 20)})
    step = {"name": "check_step", "W": W, "sizes": list(sizes), "iters": iters,
            "mismatches": rows[-1]["mismatches"], **host, "ms": rows[-1]["ms"],
            "plain_ms": rows[-1]["plain_ms"]}
    log(f"check_step at main shapes: {json.dumps(step)}")
    total = sum(r["mismatches"] for r in rows)
    if total:
        raise SystemExit(f"kernel parity at main shapes FAILED: {total} mismatching words")
    return rows, step


# -- phase 4: lanes, the check scheduler over HTTP on main's engine ------------


#: the lanes phase: interactive clients and their GETs each, the overload
#: phase's concurrent batch posters and waves, the deadline checks of each
#: kind, the audit's sample rate. The widest batch the daemon's wiring
#: admits is its admission window's top, ``max_pending``; the phase's
#: batches take half of it, which the window still admits after one
#: halving, and two of them fill it
LANES_CLIENTS = 16
LANES_GETS = 200
LANES_POSTERS = 8
LANES_WAVES = 3
LANES_DEADLINES = 200
LANES_AUDIT_RATE = 0.01
#: a batch wider than the admission window's top: the wiring answers it
#: 429 even into an empty lane
LANES_WIDE = 50_000
#: how long a batch poster honours Retry-After before the phase fails
LANES_RETRY_S = 60.0
#: (a)'s batch stream: this many posters, each posting its next batch while
#: the other's is served, so the batch lane holds work for the whole
#: interactive run. A round takes at most one batch sub-slice (1,024)
#: whatever a post's width, so the width only has to keep the lane's
#: backlog inside the admission budget (160 ms at 4 × the 40 ms target):
#: two sub-slices a post
LANES_STREAM_POSTERS = 2
LANES_STREAM_WIDTH = 2048
#: (b)'s turns, each at this audit sample rate: on, off (two more turns,
#: on and off again, ran until the every-phase run neared its time limit)
LANES_B_AUDIT = (LANES_AUDIT_RATE, 0.0)
#: lone batch posts (no other client), each half the window's top
LANES_LONE_REPS = 3
#: how long the phase waits for the admission window to reopen between parts
LANES_REOPEN_S = 20.0
#: the sampler's period (the batch lane's occupancy)
LANES_SAMPLE_S = 0.005


def _lane_trace(k: int) -> str:
    """A W3C traceparent carrying the phase's trace id number ``k``."""
    return f"00-{k:032x}-{k:016x}-01"


def _pct_ms(xs, q):
    return round(sorted(xs)[min(len(xs) - 1, int(len(xs) * q))], 3) if xs else None


def _merge_spans(spans):
    """The union of ``(t0, t1)`` spans as sorted disjoint spans."""
    merged: list = []
    for t0, t1 in sorted(spans):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def _overlaps(merged, t0, t1) -> bool:
    """Whether ``[t0, t1]`` meets any of the sorted disjoint ``merged``."""
    import bisect

    i = bisect.bisect_right([m[0] for m in merged], t1) - 1
    return i >= 0 and merged[i][1] >= t0


def _covered_share(merged, t0, t1) -> float:
    """The share of ``[t0, t1]`` that the sorted disjoint ``merged`` cover."""
    if t1 <= t0:
        return 0.0
    return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in merged) / (t1 - t0)


#: the lanes phase's thread groups, by Python thread name (the rest of the
#: process's threads, the card's and the native host library's, are
#: ``native``)
def _thread_group(name: str) -> str:
    if name == "check-batcher":
        return "collector"
    if name == "keto-torch-audit":
        return "audit"
    if "process_request_thread" in name:
        return "handlers"
    if name.startswith("lanes-client"):
        return "clients"
    if name.startswith("lanes-poster"):
        return "posters"
    if name == "lanes-sampler":
        return "sampler"
    if name == "MainThread":
        return "main"
    return "other_python"


def _task_cpu_ns(tid: int):
    """A thread's CPU time in ns: ``schedstat``'s first field where the
    kernel keeps it, else ``stat``'s utime + stime in clock ticks; None if
    neither reads."""
    import os

    try:
        with open(f"/proc/self/task/{tid}/schedstat") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open(f"/proc/self/task/{tid}/stat") as f:
            fields = f.read().rpartition(")")[2].split()
        return (int(fields[11]) + int(fields[12])) * 10**9 // os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class _LaneSampler:
    """Samples, on a thread of its own, whether the batcher's batch lane
    holds queued tuples (every ``LANES_SAMPLE_S``), and takes each thread's
    CPU time (``/proc/self/task/<tid>/``) at ``start()`` and ``stop()``
    only: a read of every thread's file is costly in a sandboxed ``/proc``,
    so a thread that ends in between notes its own CPU time as it ends
    (``note_exit``). ``stop()`` returns the lane's queued share and the CPU
    seconds of each thread group over the span, beside the wall and process
    CPU."""

    def __init__(self, batcher, lane):
        import threading

        self._batcher, self._lane = batcher, lane
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="lanes-sampler", daemon=True)
        self._first: dict = {}  # tid → ns at its first sample (0 for a thread born later)
        self._last: dict = {}  # tid → (ns, group) at its last sample
        self.samples = self.queued = 0

    def _cpu(self, born_ok: bool) -> None:
        import os
        import threading

        names = {t.native_id: t.name for t in threading.enumerate()}
        try:
            tids = [int(t) for t in os.listdir("/proc/self/task")]
        except OSError:
            return
        for tid in tids:
            ns = _task_cpu_ns(tid)
            if ns is None:
                continue  # the thread ended between the listing and the read
            group = _thread_group(names[tid]) if tid in names else "native"
            if tid not in self._first:
                self._first[tid] = 0 if born_ok else ns
            self._last[tid] = (ns, group)

    def note_exit(self) -> None:
        """The calling thread's own CPU time as it ends (a short-lived
        client may end between two samples)."""
        import threading

        tid = threading.get_native_id()
        self._first.setdefault(tid, 0)
        self._last[tid] = (time.thread_time_ns(), _thread_group(threading.current_thread().name))

    def _run(self) -> None:
        while not self._stop.wait(LANES_SAMPLE_S):
            self.samples += 1
            self.queued += self._batcher.lane_depths[self._lane] > 0

    def start(self) -> "_LaneSampler":
        self._t0, self._p0 = time.monotonic(), time.process_time()
        self._cpu(False)
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        self._cpu(True)
        wall = time.monotonic() - self._t0
        groups: dict = {}
        for tid, (ns, group) in self._last.items():
            groups[group] = groups.get(group, 0.0) + (ns - self._first[tid]) / 1e9
        python = sum(v for k, v in groups.items() if k != "native")
        process = time.process_time() - self._p0
        return {
            "lane_queued_share": round(self.queued / self.samples, 4) if self.samples else None,
            "wall_s": round(wall, 3),
            "process_cpu_s": round(process, 3),
            "thread_cpu_s": {k: round(v, 3) for k, v in sorted(groups.items())},
            # threads that ended in between without noting their own
            "unsampled_cpu_s": round(process - sum(groups.values()), 3),
            "python_threads_cpu_per_wall": round(python / wall, 3) if wall else None,
        }


def phase_lanes(torch, kernels, report, engine, queries, main_ctx):
    """Main's engine and store behind the daemon's wiring (``make_batcher``,
    one ``TimelineRecorder``, a read and a write ``RestServer``, a decision
    log sampling every /check), driven over HTTP: (a) interactive GETs
    under a monster batch, (b) overload, (c) deadlines, (d) timelines, (e)
    the shadow audit at 1%, (f) a drain with a batch in flight. The servers
    carry the daemon's observability wiring (keto_tpu_torch/driver/
    observability.py, a ``memory`` tracer): after (f) both ports'
    ``/metrics`` are scraped and held against their sources."""
    import http.client
    import tempfile
    import threading

    from keto_tpu_torch import _build
    from keto_tpu_torch.driver import observability as obs
    from keto_tpu_torch.driver.batch import BATCH
    from keto_tpu_torch.driver.daemon import DRAINING, drain, make_batcher
    from keto_tpu_torch.explain import DecisionLog
    from keto_tpu_torch.servers.rest import READ, WRITE, RestServer
    from keto_tpu_torch.x.metrics import normalize_route, parse_exposition
    from keto_tpu_torch.x.timeline import TimelineRecorder
    from keto_tpu_torch.x.tracing import Tracer

    store, _nm, _got, expected = main_ctx
    batcher = make_batcher(engine)
    recorder = TimelineRecorder()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log_dir = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    dlog = DecisionLog(log_dir.name, sample=1.0)
    # the daemon's observability wiring, by hand
    tracer = Tracer("memory")
    servers: list = []
    metrics = obs.build_metrics(
        engine=lambda: engine, batcher=lambda: batcher,
        monitor=lambda: servers[0].app.monitor if servers else None,
        recorder=lambda: recorder, decision_log=lambda: dlog, store=lambda: store,
        tracer=lambda: tracer, slo=lambda: slo)
    slo = obs.build_slo(metrics)
    obs.attach_engine(metrics, engine)
    obs.attach_recorder(metrics, recorder, tracer)
    slices0 = engine.stream_slice_stats.snapshot()["count"]
    seen = dict(recorder=recorder, metrics=metrics, tracer=tracer, slo=slo)
    read = RestServer(READ, store, batcher, decision_log=dlog, **seen)
    write = RestServer(WRITE, store, batcher, **seen)
    servers += [read, write]
    # every request of the phase by (role, method, route, code), health
    # probes aside: what keto_http_requests_total must hold
    sent: dict = {}
    sent_lock = threading.Lock()

    def tally(role, method, path, status):
        if not path.startswith("/health/"):
            key = (role, method, normalize_route(path.split("?")[0]), str(status))
            with sent_lock:
                sent[key] = sent.get(key, 0) + 1

    def scrape(role):
        """One ``GET /metrics`` on ``role``'s port, strictly parsed: its
        seconds, bytes and families."""
        port = read.port if role == READ else write.port
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as resp:
            text = resp.read().decode()
            status = resp.status
        sec = time.perf_counter() - t0
        tally(role, "GET", "/metrics", status)
        return sec, len(text), parse_exposition(text)
    wide = batcher.max_pending
    half = wide // 2
    rng = random.Random(SEED + 15)
    errors: list = []
    out: dict = {"batch_width": half, "window_top": wide}

    def fail(msg):
        errors.append(msg)
        raise SystemExit(f"lanes FAILED: {msg}")

    # each round's interactive and batch tuples (the batcher's own dispatch,
    # observed; a measurement hook of this script only)
    rounds: list = []
    dispatch = batcher._dispatch_stream

    def counted(segments, at_leasts, latests):
        rounds.append((sum(c for it, _, c in segments if it.lane != BATCH),
                       sum(c for it, _, c in segments if it.lane == BATCH)))
        return dispatch(segments, at_leasts, latests)

    batcher._dispatch_stream = counted

    # every client thread keeps one HTTP/1.1 connection to the read port,
    # as a client's connection pool would
    conns = threading.local()

    def call(method, path, body=None, headers=None):
        conn = getattr(conns, "c", None)
        if conn is None:
            conn = conns.c = http.client.HTTPConnection("127.0.0.1", read.port, timeout=300)
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        ms = (time.perf_counter() - t0) * 1e3
        tally(READ, method, path, resp.status)
        return resp.status, (json.loads(raw) if raw else None), resp.headers, ms

    def hang_up():
        conn = getattr(conns, "c", None)
        if conn is not None:
            conn.close()
            conns.c = None

    paths = {}

    def path_of(i):
        if i not in paths:
            paths[i] = "/check?" + queries[i].to_url_query()
        return paths[i]

    def batch_body(start, n):
        return json.dumps({"tuples": [q.to_json() for q in queries[start:start + n]]}).encode()

    inter: dict = {}  # part → [(ms, t0, t1, status)], perf_counter spans
    stage_ms: dict = {}  # part → the Server-Timing segments of each answer

    def interactive(part, i, headers=None, suffix="", allow_504=False):
        t0 = time.perf_counter()
        st, body, h, ms = call("GET", path_of(i) + suffix, headers=headers)
        got = (ms, t0, time.perf_counter(), st)
        want = expected[i]
        if st == 504 and allow_504:
            inter.setdefault(part, []).append(got)
            return st
        if st == 429:
            fail(f"({part}) an interactive check was shed: {body}")
        if st != (200 if want else 403) or body != {"allowed": want}:
            fail(f"({part}) check {i} answered {st} {body}, expected {want}")
        timing = h.get("Server-Timing") or ""
        if "device;dur=" not in timing or not h.get("X-Request-Id"):
            fail(f"({part}) check {i} lacks Server-Timing device or X-Request-Id: {dict(h)}")
        inter.setdefault(part, []).append(got)
        for entry in timing.split(","):
            stage, _, dur = entry.strip().partition(";dur=")
            stage_ms.setdefault(part, {}).setdefault(stage, []).append(float(dur))
        return st

    def stages(part):
        """p50/p99 ms of each Server-Timing stage of ``part``'s answers."""
        return {k: (_pct_ms(v, 0.5), _pct_ms(v, 0.99))
                for k, v in stage_ms.get(part, {}).items()}

    posts: list = []  # (part, status, ms, retry_after, t0, t1)

    def post_batch(part, start, n, retry, trace=None, body=None):
        """One /check/batch; ``retry`` honours 429s' Retry-After until it is
        admitted (as the reference's SDK does)."""
        body = batch_body(start, n) if body is None else body
        headers = {"Content-Type": "application/json"}
        if trace is not None:
            headers["traceparent"] = _lane_trace(trace)
        t_end = time.monotonic() + LANES_RETRY_S
        while True:
            t0 = time.perf_counter()
            st, got, h, ms = call("POST", "/check/batch", body, headers)
            t1 = time.perf_counter()
            if st == 429:
                ra = h.get("Retry-After")
                posts.append((part, st, ms, ra, t0, t1))
                if not ra:
                    fail(f"({part}) a 429 without Retry-After: {got}")
                if not retry:
                    return st
                if time.monotonic() > t_end:
                    fail(f"({part}) a {n}-tuple batch was refused for {LANES_RETRY_S}s")
                time.sleep(float(ra))
                continue
            posts.append((part, st, ms, None, t0, t1))
            if st != 200 or got["results"] != expected[start:start + n]:
                fail(f"({part}) batch [{start}, {start + n}) answered {st}, "
                     f"{None if got is None else str(got)[:200]}")
            return st

    sampling: list = []  # the running _LaneSampler, if any

    def on_thread(fn):
        def go():
            try:
                fn()
            except Exception as e:  # a client's own fault fails the phase
                errors.append(f"{type(e).__name__}: {e}")
            finally:
                hang_up()
                for smp in sampling:
                    smp.note_exit()
        return go

    def spawn(fns, name):
        threads = [threading.Thread(target=on_thread(f), name=f"{name}-{k}", daemon=True)
                   for k, f in enumerate(fns)]
        for t in threads:
            t.start()
        return threads

    def join_all(threads, timeout=600):
        for t in threads:
            t.join(timeout=timeout)
        if any(t.is_alive() for t in threads) or errors:
            raise SystemExit(f"lanes FAILED: {errors or 'a client hung'}")

    def run_threads(fns, name="lanes-poster"):
        join_all(spawn(fns, name))

    def reopen():
        """Wait, the lanes empty, until the admission window is back at its
        top: each admission precheck with the lane empty ticks it (+512
        tuples a healthy tick, a tick each 0.25 s at most)."""
        t_end = time.monotonic() + LANES_REOPEN_S
        while batcher.admission.window < wide and time.monotonic() < t_end:
            if not batcher.lane_depths[BATCH]:
                batcher.admission_precheck(BATCH)
            time.sleep(0.05)
        return batcher.admission.window

    def lat_split(part, spans):
        """``part``'s interactive latencies: all, and those under a batch
        (an admitted batch in flight at any point of the GET's life) and
        alone, with the share of the GETs' span that a batch was in flight."""
        rows = inter.get(part, [])
        merged = _merge_spans(spans)
        under = [m for m, t0, t1, _ in rows if _overlaps(merged, t0, t1)]
        alone = [m for m, t0, t1, _ in rows if not _overlaps(merged, t0, t1)]
        lat = [m for m, _, _, _ in rows]
        span = (min((r[1] for r in rows), default=0.0), max((r[2] for r in rows), default=0.0))
        return {
            "gets": len(lat), "p50_ms": _pct_ms(lat, 0.5), "p99_ms": _pct_ms(lat, 0.99),
            "under_batch": len(under), "under_p50_ms": _pct_ms(under, 0.5),
            "under_p99_ms": _pct_ms(under, 0.99), "alone": len(alone),
            "alone_p50_ms": _pct_ms(alone, 0.5), "alone_p99_ms": _pct_ms(alone, 0.99),
            "batch_in_flight_share": round(_covered_share(merged, *span), 4),
        }

    # a handler thread that ends between two samples (a shed post) notes
    # its own CPU time as it ends (a measurement hook of this script only)
    serve_one = read.httpd.process_request_thread

    def process_request_thread(request, client_address):
        try:
            serve_one(request, client_address)
        finally:
            for smp in sampling:
                smp.note_exit()

    read.httpd.process_request_thread = process_request_thread

    # sheds before a body's decode (the pre-parse check) apart from those
    # after it (a measurement hook of this script only)
    precheck = batcher.admission_precheck
    prechecked: list = []

    def counted_precheck(lane=BATCH):
        try:
            return precheck(lane)
        except Exception:
            prechecked.append(lane)
            raise

    batcher.admission_precheck = counted_precheck

    engine.audit_sample_rate = LANES_AUDIT_RATE
    audit0 = {k: engine.counters()[k] for k in ("audit_checks", "audit_mismatches",
                                                "audit_skipped_stale")}
    kernels.reset_counts()
    for s in (read, write):
        s.start()
    batcher.start()
    try:
        # the wiring refuses a batch wider than the admission window, even
        # into an empty lane
        st, body, h, _ = call("POST", "/check/batch", batch_body(0, LANES_WIDE),
                              {"Content-Type": "application/json"})
        out["wide_batch"] = {"tuples": LANES_WIDE, "status": st,
                             "retry_after": h.get("Retry-After"),
                             "window": batcher.admission.window}
        if st != 429 or not h.get("Retry-After"):
            fail(f"a {LANES_WIDE}-tuple batch answered {st} {body}")

        # a lone batch: half the window's top posted back to back with no
        # other client (a 429 sleeps its Retry-After), beside the same
        # checks straight through the engine; the cost of serving a batch
        # a sub-slice a round
        lone_bodies = [batch_body(k * half, half) for k in range(LANES_LONE_REPS)]
        r0 = len(rounds)
        t0 = time.monotonic()
        for k, b in enumerate(lone_bodies):
            post_batch("lone", k * half, half, True, body=b)
        lone_wall = time.monotonic() - t0
        lone_ok = [ms for p, st, ms, _, _, _ in posts if p == "lone" and st == 200]
        eng_ms = []
        for k in range(LANES_LONE_REPS):
            t1 = time.perf_counter()
            if engine.batch_check(queries[k * half:(k + 1) * half]) != \
                    expected[k * half:(k + 1) * half]:
                fail("the lone batch's checks disagree straight through the engine")
            eng_ms.append((time.perf_counter() - t1) * 1e3)
        out["lone"] = {
            "width": half, "reps": LANES_LONE_REPS, "post_ms": [round(m, 3) for m in lone_ok],
            "post_checks_per_s": round(half / _pct_ms(lone_ok, 0.5) * 1e3, 1),
            "shed": sum(p == "lone" and st == 429 for p, st, *_ in posts),
            "sustained_checks_per_s": round(half * len(lone_ok) / lone_wall, 1),
            "rounds_a_post": (len(rounds) - r0) / len(lone_ok),
            "engine_ms": [round(m, 3) for m in eng_ms],
            "engine_checks_per_s": round(half / _pct_ms(eng_ms, 0.5) * 1e3, 1),
        }
        log(f"lanes lone: {json.dumps(out['lone'])}")

        # (a) interactive under a batch stream: LANES_STREAM_POSTERS posters
        # post main's checks LANES_STREAM_WIDTH at a time, each its next
        # batch while the other's is served, until the 16 interactive
        # clients are done and main's 100,000 checks were posted once
        window_a = reopen()
        ctrl_a0 = engine.stream_ctrl.snapshot()
        slices_a0 = engine.stream_slice_stats.snapshot()["count"]
        r0, p0 = len(rounds), len(posts)
        chunks = [(s0, min(LANES_STREAM_WIDTH, N_CHECKS - s0))
                  for s0 in range(0, N_CHECKS, LANES_STREAM_WIDTH)]
        chunk_bodies = [batch_body(s0, n) for s0, n in chunks]
        picks = [[rng.randrange(N_CHECKS) for _ in range(LANES_GETS)]
                 for _ in range(LANES_CLIENTS)]
        next_chunk = iter(range(1 << 30))  # shared; next() is atomic under the GIL
        first_queued = threading.Event()
        clients_done = threading.Event()

        def poster():
            while True:
                k = next(next_chunk)
                if k >= len(chunks) and clients_done.is_set():
                    return
                (s0, n), b = chunks[k % len(chunks)], chunk_bodies[k % len(chunks)]
                post_batch("a", s0, n, True, trace=2, body=b)
                first_queued.set()

        def client(k):
            # client 0's requests carry a traceparent: the trace-id filter
            # of /debug/requests must return them
            hdr = {"traceparent": _lane_trace(1)} if k == 0 else None

            def go():
                t_end = time.monotonic() + LANES_RETRY_S
                while not (batcher.lane_depths[BATCH] or first_queued.is_set()) and \
                        time.monotonic() < t_end:
                    time.sleep(0.0005)
                for i in picks[k]:
                    interactive("a", i, hdr)
            return go

        t0 = time.monotonic()
        posters = spawn([poster] * LANES_STREAM_POSTERS, "lanes-poster")
        sampler = _LaneSampler(batcher, BATCH).start()
        sampling.append(sampler)
        try:
            join_all(spawn([client(k) for k in range(LANES_CLIENTS)], "lanes-client"))
        finally:
            clients_done.set()
        join_all(posters)
        sampled = sampler.stop()
        sampling.clear()
        a_s = time.monotonic() - t0
        rounds_a = rounds[r0:]
        batch_rounds = [b for _, b in rounds_a if b]
        a_posts = [p for p in posts[p0:] if p[0] == "a"]
        a_ok = [p for p in a_posts if p[1] == 200]
        out["a"] = {
            "seconds": round(a_s, 3), "window_at_start": window_a,
            **lat_split("a", [(p[4], p[5]) for p in a_ok]),
            **sampled, "server_timing": stages("a"),
            "batch_posts": len(a_ok), "batch_width": LANES_STREAM_WIDTH,
            "batch_posters": LANES_STREAM_POSTERS,
            "batch_checks": sum(n for (s0, n) in chunks) if len(a_ok) >= len(chunks) else None,
            "batch_shed": len(a_posts) - len(a_ok),
            "batch_post_p50_ms": _pct_ms([p[2] for p in a_ok], 0.5),
            "batch_post_p99_ms": _pct_ms([p[2] for p in a_ok], 0.99),
            "rounds": len(rounds_a), "rounds_with_batch": len(batch_rounds),
            "batch_sub_slice_max": max(batch_rounds, default=0),
            "batch_sub_slice_p50": _pct_ms(batch_rounds, 0.5),
            "round_interactive_max": max((i for i, _ in rounds_a), default=0),
            "slices": engine.stream_slice_stats.snapshot()["count"] - slices_a0,
            "slice_ms": engine.stream_slice_stats.snapshot(),
            "ctrl_before": ctrl_a0, "ctrl_after": engine.stream_ctrl.snapshot(),
        }
        log(f"lanes (a): {json.dumps(out['a'])}")
        if len(a_ok) < len(chunks):
            fail(f"(a) answered {len(a_ok)} batch posts, fewer than main's {len(chunks)} chunks")

        # (d) timelines, read before (b) rotates the ring
        st, dbg, _, _ = call("GET", "/debug/requests?n=50")
        st1, traced, _, _ = call("GET", f"/debug/requests?n=1000&slowest=0&trace_id={1:032x}")
        st2, mon, _, _ = call("GET", f"/debug/requests?n=1000&slowest=32&trace_id={2:032x}")
        if st != 200 or len(dbg["recent"]) != 50 or st1 != 200 or not traced["recent"] or \
                any(t["trace_id"] != f"{1:032x}" for t in traced["recent"]):
            fail(f"/debug/requests answered {st} ({len(dbg['recent'])} recent), "
                 f"the trace filter {st1} ({len(traced['recent'])})")
        widths = [s["attrs"]["width"] for t in dbg["recent"] + mon["recent"] + mon["slowest"]
                  for s in t["stages"] if s["stage"] == "device"]
        # the slowest answered batch (a shed one rode no slice)
        mon_tl = next((t for t in mon["slowest"] + mon["recent"] if t["status"] == 200), None)
        out["d"] = {
            "recent": len(dbg["recent"]), "traced": len(traced["recent"]),
            "batch_timelines": len(mon["recent"]) + len(mon["slowest"]),
            "device_widths": {"n": len(widths), "min": min(widths, default=None),
                              "p50": _pct_ms(widths, 0.5), "max": max(widths, default=None)},
            "batch_timeline": None if mon_tl is None else {
                "total_ms": mon_tl["total_ms"], "truncated": mon_tl["truncated"],
                "devices": sum(s["stage"] == "device" for s in mon_tl["stages"]),
                "routes": sorted({s["attrs"]["route"] for s in mon_tl["stages"]
                                  if s["stage"] == "device"})},
        }

        # (b) overload: waves of concurrent batch posters beside the
        # interactive clients, in turns with the audit on and off, each
        # from a reopened window, each thread's CPU sampled
        def overload(turn, rate):
            part = f"b{turn}"
            engine.audit_settled(timeout=60)  # no earlier sample runs into this turn
            engine.audit_sample_rate = rate
            window0 = reopen()
            stop_b = threading.Event()
            shed_b0 = (batcher.shed_count, dict(batcher.shed_by_lane),
                       batcher.admission_shed_count)
            p0, pre0 = len(posts), len(prechecked)

            def steady(k):
                def go():
                    for _ in range(LANES_GETS):
                        if stop_b.is_set():
                            return
                        interactive(part, rng.randrange(N_CHECKS))
                return go

            t0 = time.monotonic()
            sampler = _LaneSampler(batcher, BATCH).start()
            sampling.append(sampler)
            clients = spawn([steady(k) for k in range(LANES_CLIENTS)], "lanes-client")
            if turn == 0:
                # one scrape under the overload waves, on its own connection
                def mid_scrape():
                    time.sleep(0.25)
                    sec, size, fams = scrape(READ)
                    overload_scrape.update(seconds=sec, bytes=size, families=len(fams))

                clients += spawn([mid_scrape], "lanes-scrape")
            try:
                for wave in b_bodies:
                    run_threads([(lambda s0=s0, b=b: post_batch(part, s0, half, False, body=b))
                                 for s0, b in wave])
            finally:
                stop_b.set()
            join_all(clients, timeout=60)
            sampled = sampler.stop()
            sampling.clear()
            b_posts = [p for p in posts[p0:] if p[0] == part]
            res = {
                "audit_rate": rate, "window_at_start": window0,
                "seconds": round(time.monotonic() - t0, 3), "posts": len(b_posts),
                "ok": sum(p[1] == 200 for p in b_posts),
                "shed": sum(p[1] == 429 for p in b_posts),
                "retry_after": sorted({p[3] for p in b_posts if p[1] == 429}),
                "shed_before_decode": len(prechecked) - pre0,
                "shed_ms_p50": _pct_ms([p[2] for p in b_posts if p[1] == 429], 0.5),
                **lat_split(part, [(p[4], p[5]) for p in b_posts if p[1] == 200]),
                **sampled, "server_timing": stages(part),
                "shed_count": batcher.shed_count - shed_b0[0],
                "shed_by_lane": {k: v - shed_b0[1][k] for k, v in batcher.shed_by_lane.items()},
                "admission_shed_count": batcher.admission_shed_count - shed_b0[2],
                "admission": batcher.admission.snapshot(),
            }
            log(f"lanes (b) turn {turn}: {json.dumps(res)}")
            if not res["shed"]:
                fail(f"(b) turn {turn} shed nothing")
            return res

        overload_scrape: dict = {}
        # every turn posts the same batches, encoded once before the first
        b_bodies = [[(s0, batch_body(s0, half)) for s0 in
                     ((wave * LANES_POSTERS + p) * 4096 % (N_CHECKS - wide)
                      for p in range(LANES_POSTERS))] for wave in range(LANES_WAVES)]
        out["b"] = [overload(turn, rate) for turn, rate in enumerate(LANES_B_AUDIT)]
        del b_bodies
        engine.audit_sample_rate = LANES_AUDIT_RATE

        # (c) deadlines, sent while a batch is queued
        drops0 = batcher.deadline_drop_count
        reopen()
        c_post = threading.Thread(target=on_thread(lambda: post_batch("c", 0, half, True)),
                                  daemon=True)
        c_post.start()
        t_end = time.monotonic() + LANES_RETRY_S
        while not batcher.lane_depths[BATCH] and time.monotonic() < t_end and not errors:
            time.sleep(0.001)
        queued_at_start = batcher.lane_depths[BATCH]
        kinds = [("query", i) for i in range(LANES_DEADLINES)] + \
                [("header", i) for i in range(LANES_DEADLINES)]
        rng.shuffle(kinds)
        got_c: dict = {"query": [], "header": []}

        def deadline_client(part):
            def go():
                for kind, _ in part:
                    i = rng.randrange(N_CHECKS)
                    if kind == "query":
                        st = interactive("c", i, suffix="&timeout_ms=0.001", allow_504=True)
                    else:
                        st = interactive("c", i, {"X-Request-Timeout-Ms": "1"}, allow_504=True)
                    got_c[kind].append(st)
            return go

        run_threads([deadline_client(kinds[k::8]) for k in range(8)], "lanes-client")
        c_post.join(timeout=600)
        if errors or c_post.is_alive():
            raise SystemExit(f"lanes FAILED: {errors or '(c) the batch never finished'}")
        out["c"] = {
            "batch_queued_at_start": queued_at_start,
            **{f"{kind}_{code}": sum(s == code for s in got_c[kind])
               for kind in ("query", "header") for code in (504, 200, 403)},
            "deadline_drop_count": batcher.deadline_drop_count - drops0,
        }
        log(f"lanes (c): {json.dumps(out['c'])}")

        # (d) the decision log: every /check decision, its route and trace id
        recs, corrupt = dlog.read_all("default")
        routes: dict = {}
        for r in recs:
            routes[r["route"]] = routes.get(r["route"], 0) + 1
        traced_recs = sum(r["trace_id"] == f"{1:032x}" for r in recs)
        out["d"].update({"decision_log": len(recs), "corrupt": corrupt, "routes": routes,
                         "traced_records": traced_recs})
        if corrupt or not recs or set(routes) - {"bfs", "host"} or not routes.get("bfs") \
                or not traced_recs:
            fail(f"the decision log holds {len(recs)} records, routes {routes}, "
                 f"{traced_recs} traced, {corrupt} corrupt")
        log(f"lanes (d): {json.dumps(out['d'])}")

        # (f) drain with a batch in flight
        reopen()
        f_post = threading.Thread(
            target=on_thread(lambda: post_batch("f", N_CHECKS - half, half, True)), daemon=True)
        f_post.start()
        t_end = time.monotonic() + LANES_RETRY_S
        while not batcher.lane_depths[BATCH] and time.monotonic() < t_end and not errors:
            time.sleep(0.001)
        inflight = batcher.inflight
        drained: dict = {}
        dt = threading.Thread(
            target=on_thread(lambda: drained.update(drain((read, write), batcher, 60.0))),
            daemon=True)
        dt.start()
        ready = []
        while True:
            alive = dt.is_alive()
            st, body, h, _ = call("GET", "/health/ready")
            ready.append((st, body.get("reason"), h.get("Retry-After")))
            if st == 503 or not alive:
                break
        dt.join(timeout=120)
        f_post.join(timeout=120)
        if errors or f_post.is_alive() or dt.is_alive():
            raise SystemExit(f"lanes FAILED: {errors or '(f) the drain hung'}")
        after = call("GET", "/health/ready")[:2]
        hang_up()
        out["f"] = {"inflight_at_drain": inflight, "drain": drained,
                    "ready_while_draining": ready[-1], "ready_polls": len(ready),
                    "ready_after": after,
                    "batch": [(st, round(ms, 1)) for p, st, ms, *_ in posts if p == "f"]}
        log(f"lanes (f): {json.dumps(out['f'])}")
        if ready[-1] != (503, DRAINING, "1") or after[0] != 503 or \
                not drained.get("batcher_idle") or posts[-1][:2] != ("f", 200):
            fail(f"(f) the drain: {out['f']}")
        out["scrape"] = lanes_scrape(scrape, sent, batcher, engine, slices0, read.port,
                                     overload_scrape, out)
    finally:
        batcher.stop()
        for s in (read, write):
            s.stop()
        dlog.close()
        log_dir.cleanup()
        batcher._dispatch_stream = dispatch
        batcher.admission_precheck = precheck
        engine.stream_slice_stats.attach_histogram(None)
        engine.build_progress.attach_histogram(None)

    # (e) the audit: every sample re-checked on the oracle, off the path
    t0 = time.monotonic()
    if not engine.audit_settled(timeout=600):
        raise SystemExit("lanes FAILED: the audit did not settle")
    engine.audit_sample_rate = 0.0
    c = engine.counters()
    out["e"] = {k: c[k] - audit0[k] for k in audit0}
    out["e"].update({"settle_s": round(time.monotonic() - t0, 3), "rate": LANES_AUDIT_RATE,
                     "divergences": list(engine.audit_divergences)})
    log(f"lanes (e): {json.dumps(out['e'])}")
    if not out["e"]["audit_checks"] or out["e"]["audit_mismatches"]:
        raise SystemExit(f"lanes FAILED: the audit {out['e']}")
    launches = dict(kernels.COUNTS)
    out["launches"] = launches
    out["shed_count"] = batcher.shed_count
    missing = [k for k in ("seed", "check_run", "answer_pack") if not launches.get(k)]
    if missing:
        raise SystemExit(f"lanes FAILED: the phase's requests never launched {missing}")
    report["lanes"] = out


def _samples(fams, name, **labels):
    """``name``'s samples (a histogram's ``_count`` etc. by their sample
    name) whose labels include ``labels``, as ``{label tuple: value}``."""
    fam = name if name in fams else name.rsplit("_", 1)[0]
    if fam not in fams:
        raise SystemExit(f"scrape FAILED: {fam} is missing from the scrape")
    return {tuple(sorted(lbl.items())): v for n, lbl, v in fams[fam]["samples"]
            if n == name and all(lbl.get(k) == x for k, x in labels.items())}


def lanes_scrape(scrape, sent, batcher, engine, slices0, read_port, overload_scrape, out) -> dict:
    """After (a)–(f): both ports' ``/metrics`` strictly parsed and held
    against their sources — the slice histogram's count against the
    engine's slice stats over the phase, ``keto_http_requests_total``
    against the phase's own count of its requests by route and code, the
    shed and deadline families against the batcher's fields, the
    ``device`` stage of the timeline histogram above 0 — and ``GET /slo``'s
    totals against a scrape. Any difference or missing family fails."""
    from keto_tpu_torch.servers.rest import READ, WRITE

    def fail(msg):
        raise SystemExit(f"lanes FAILED: the scrape: {msg}")

    sec_w, size_w, fams_w = scrape(WRITE)
    sec, size, fams = scrape(READ)
    if set(fams) != set(fams_w):
        fail(f"the ports expose different families: {sorted(set(fams) ^ set(fams_w))}")
    got_req = {(lbl["role"], lbl["method"], lbl["route"], lbl["code"]): v
               for _, lbl, v in fams["keto_http_requests_total"]["samples"]}
    want_req = dict(sent)
    want_req[(READ, "GET", "/metrics", "200")] -= 1  # the scrape counts after its render
    slices = engine.stream_slice_stats.snapshot()["count"] - slices0
    h_slices = sum(_samples(fams, "keto_engine_stream_slice_duration_seconds_count").values())
    device = sum(_samples(fams, "keto_timeline_stage_duration_seconds_count",
                          stage="device").values())
    shed = sum(_samples(fams, "keto_check_shed_total").values())
    drops = sum(_samples(fams, "keto_check_deadline_drops_total").values())
    lane_shed = {k[0][1]: v for k, v in _samples(fams, "keto_lane_shed_total").items()}
    res = {
        "families": len(fams), "bytes": size, "scrape_s": sec, "write_scrape_s": sec_w,
        "overload_scrape": overload_scrape, "requests": sum(got_req.values()),
        "request_series": len(got_req), "slices": slices, "slice_histogram_count": h_slices,
        "device_stage_count": device, "shed": shed, "deadline_drops": drops,
        "get_p50_ms": out["a"]["p50_ms"], "get_p99_ms": out["a"]["p99_ms"],
    }
    if got_req != {k: v for k, v in want_req.items() if v}:
        diff = {str(k): (got_req.get(k), want_req.get(k)) for k in set(got_req) | set(want_req)
                if got_req.get(k) != want_req.get(k)}
        fail(f"keto_http_requests_total differs from the phase's requests: {diff}")
    if h_slices != slices or not slices:
        fail(f"the slice histogram counts {h_slices}, the engine's stats {slices}")
    if shed != batcher.shed_count or drops != batcher.deadline_drop_count or \
            lane_shed != {k: float(v) for k, v in batcher.shed_by_lane.items()}:
        fail(f"shed {shed}/{batcher.shed_count}, deadline drops {drops}/"
             f"{batcher.deadline_drop_count}, lanes {lane_shed}/{batcher.shed_by_lane}")
    if not device > 0 or not overload_scrape.get("families") == len(fams):
        fail(f"device stage {device}, the scrape under overload {overload_scrape}")
    # /slo: a fresh sample (past the engine's 1 s sampling interval), then a
    # scrape; the report's 1 h window holds every request of the phase but
    # /slo's own, which counts after its report
    time.sleep(1.05)
    with urllib.request.urlopen(f"http://127.0.0.1:{read_port}/slo", timeout=60) as resp:
        slo_status, rep = resp.status, json.loads(resp.read())
    _, _, after = scrape(READ)
    total = sum(_samples(after, "keto_http_requests_total").values())
    errors = sum(v for k, v in _samples(after, "keto_http_requests_total").items()
                 if dict(k)["code"].startswith("5"))
    hour = rep["windows"][1]
    res["slo"] = {"status": slo_status, "requests": hour["requests"], "errors": hour["errors"],
                  "availability_ratio": hour["availability_ratio"],
                  "latency_ratio": hour["latency_ratio"]}
    if slo_status != 200 or hour["requests"] != total - 1 or hour["errors"] != errors:
        fail(f"/slo {res['slo']} against the scrape's {total} requests, {errors} errors")
    log(f"lanes scrape: {json.dumps(res)}")
    return res


# -- phase 5: labels on config 3 ------------------------------------------------


def route_counts(engine) -> dict:
    c = engine.counters()
    return {k: c.get(k, 0) for k in
            ("label_checks", "label_fallbacks", "label_builds", "label_device_builds")}


def phase_labels(torch, kernels, report, main_ctx, queries):
    """Config 3 with the default engine: labels on, built on the host."""
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine

    store, nm, bfs_got, expected = main_ctx
    kernels.reset_counts()
    engine = TorchCheckEngine(store, nm, device="cuda")
    t0 = time.monotonic()
    if not engine.labels_settled():
        raise SystemExit("labels FAILED: no label index on config 3")
    settle_s = time.monotonic() - t0
    idx = engine.snapshot().labels
    t0 = time.monotonic()
    got = engine.batch_check(queries)
    torch.cuda.synchronize()
    check_s = time.monotonic() - t0
    launches = dict(kernels.COUNTS)
    counts = route_counts(engine)
    wrong = sum(g != e for g, e in zip(got, expected))
    differ = sum(g != b for g, b in zip(got, bfs_got))
    log(f"labels (config 3, {idx.backend} build): {idx.n_landmarks} landmarks, "
        f"{idx.n_entries} entries, coverage {idx.coverage:.4f}, Wo={idx.out_lab.shape[1]} "
        f"Wi={idx.in_lab.shape[1]}, build {idx.build_ms / 1e3:.3f}s (settled in {settle_s:.3f}s); "
        f"{len(queries)} checks in {check_s:.3f}s ({len(queries) / check_s:.0f} checks/s); "
        f"route counts {counts}; launches {launches}; wrong vs analytic {wrong}, "
        f"differ from the BFS run {differ}")
    if wrong or differ:
        raise SystemExit(f"labels FAILED: {wrong} wrong, {differ} differ from the BFS route")
    if idx.backend != "host" or counts["label_device_builds"] or launches["sweep_run"] \
            or launches["covered"]:
        raise SystemExit("labels FAILED: config 3 must take the host build")
    if not launches["label_step"] or not counts["label_checks"]:
        raise SystemExit("labels FAILED: the label route never answered")
    report["labels"] = {
        "config": "BASELINE config 3 (RBAC), labels on", "build": idx.backend,
        "build_s": idx.build_ms / 1e3, "landmarks": idx.n_landmarks, "entries": idx.n_entries,
        "coverage": idx.coverage, "check_s": check_s, "checks_per_s": len(queries) / check_s,
        "route_counts": counts, "launches": launches,
    }


# -- phase 6: hbm, the device-memory governor and the health machine -----------


#: listings per orientation of the hbm phase (before the pressure on the
#: card, then on the reverse rung's host route)
HBM_LISTINGS = 100
#: the monitor's staleness budget in (c)
HBM_STALENESS_S = 2.0


def ledger_line(torch, eng, base: int, lst=None) -> dict:
    """Every ledger tag beside the bytes of the tensors it names, and the
    ledger's total beside ``torch.cuda.memory_allocated`` since ``base``
    (just before the engine was made). Fails unless ``snapshot``,
    ``labels``, ``overlay`` and ``reverse`` equal their tensors' bytes."""
    from keto_tpu_torch.driver.hbm import device_measured_bytes

    led = eng.hbm.ledger()
    tensors = eng.hbm_ledger_bytes()
    snap = eng._snapshot
    if lst is not None:
        tensors["reverse"] = lst.device_bytes(snap)
    alloc = (device_measured_bytes(eng.device) or 0) - base
    out = {"ledger": led, "tensors": tensors, "resident": eng.hbm.resident_bytes(),
           "allocated_since_engine": alloc,
           "gap": alloc - eng.hbm.resident_bytes(), "budget": eng.hbm.budget_bytes,
           "host": eng.hbm.snapshot().get("host", {})}
    bad = [t for t in tensors if led.get(t, 0) != tensors[t]]
    if bad:
        raise SystemExit(f"hbm FAILED (a): tags {bad} differ from their tensors: {out}")
    return out


def _fill_card(torch) -> list:
    """Fill the card: one ballast tensor over the driver's free memory less
    64 MiB, then ever smaller tensors, each size until the caching
    allocator raises ``torch.OutOfMemoryError``, so that neither the driver
    nor a cached segment has a free block left."""
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    held = [torch.empty(max(0, free - (64 << 20)), dtype=torch.uint8, device="cuda")]
    for size in (16 << 20, 1 << 20, 64 << 10, 4 << 10, 512):
        while True:
            try:
                held.append(torch.empty(size, dtype=torch.uint8, device="cuda"))
            except torch.OutOfMemoryError:
                break
    return held


def _rbac_expect(ctx, parsed, extra) -> list:
    """The analytic decisions of main's checks with ``extra`` mid → leaf
    edges (``groups:mid-m#member@groups:leaf-g#member``) added."""
    add: dict = {}
    for m, g in extra:
        add.setdefault(g, set()).add(m)
    out = []
    for d, u in parsed:
        kind, g = ctx["doc_grant"][d]
        leaves = ctx["membership"].get(u, set())
        if kind == "leaf":
            out.append(g in leaves)
            continue
        mids = {ctx["leaf_parent"][lf] for lf in leaves}
        for lf in leaves:
            mids |= add.get(lf, set())
        out.append(g in mids if kind == "mid" else
                   g in {ctx["mid_parent"][m] for m in mids})
    return out


def _new_edge(ctx, parsed, expected, taken) -> tuple:
    """A mid → leaf edge (both active interior rows: an overlay-ELL edge)
    that turns at least one of main's denies into a grant."""
    for (d, u), e in zip(parsed, expected):
        kind, g = ctx["doc_grant"][d]
        if e or kind == "leaf":
            continue
        m = g if kind == "mid" else (ctx["top_mids"].get(g) or [None])[0]
        for lf in sorted(ctx["membership"].get(u, ())):
            if m is not None and ctx["leaf_parent"][lf] != m and (m, lf) not in taken:
                return m, lf
    raise SystemExit("hbm FAILED: no mid → leaf edge changes a decision")


def phase_hbm(torch, kernels, report, main_ctx, queries, rctx, device="cuda"):
    """The device-memory governor and the health machine at config 3 on a
    fork of main's store (see the module docstring)."""
    import tempfile
    import urllib.error

    import numpy as np

    from keto_tpu_torch import _build
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
    from keto_tpu_torch.driver import observability as obs
    from keto_tpu_torch.driver.daemon import make_batcher
    from keto_tpu_torch.driver.hbm import device_budget_bytes
    from keto_tpu_torch.driver.health import HealthMonitor, HealthState
    from keto_tpu_torch.graph.device_build import DEFAULT_MIN_EDGES, GovernedSorter
    from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
    from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet
    from keto_tpu_torch.servers.rest import READ, RestServer
    from keto_tpu_torch.x.flightrec import list_bundles, validate_bundle
    from keto_tpu_torch.x.metrics import parse_exposition

    on_card = device == "cuda"
    store, nm, _bfs_got, expected = main_ctx
    t_phase = time.monotonic()
    out: dict = {"config": "BASELINE config 3 (RBAC), labels on, built on the card"}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def fail(msg):
        raise SystemExit(f"hbm FAILED: {msg}")

    def ready():
        url = f"http://127.0.0.1:{server.port}/health/ready"
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, json.loads(r.read()), r.headers.get("Retry-After")
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read()), err.headers.get("Retry-After")

    def checks(what, want, mode="latest"):
        before = eng.counters().get("label_checks", 0)
        kernels.reset_counts()
        t0 = time.monotonic()
        got = eng.batch_check(queries, mode=mode)
        sync()
        s = time.monotonic() - t0
        wrong = sum(g != e for g, e in zip(got, want))
        r = {"s": s, "checks_per_s": len(queries) / s, "wrong": wrong,
             "label_checks": eng.counters().get("label_checks", 0) - before,
             "label_step": kernels.COUNTS["label_step"], "check_run": kernels.COUNTS["check_run"]}
        if wrong:
            fail(f"{what}: {wrong} decisions differ from the expectation: {r}")
        return r

    def counts():
        c = eng.counters()
        g = eng.hbm.snapshot()
        return {"rung": g["rung"], "evicted": g["evicted"], "refusals": g["refusals"],
                "restores": g["restores"], "oom_events": g["oom_events"],
                "oom_recoveries": g["oom_recoveries"],
                "evictions_by_rung": {k: v for k, v in g["evictions_by_rung"].items() if v},
                "refresh_failures": c.get("refresh_failures", 0)}

    parsed = [(int(q.object[4:]), int(q.subject.id[5:])) for q in queries]
    users = sorted({u for _, u in parsed[::2]})[:HBM_LISTINGS]
    docs = sorted({d for d, _ in parsed})[:HBM_LISTINGS]

    def listings():
        lst._cache.clear()
        t0 = time.monotonic()
        got = [lst.list_objects("docs", "view", SubjectID(f"user-{u}"))[0] for u in users]
        got += [lst.list_subjects("docs", f"doc-{d}", "view")[0] for d in docs]
        return got, time.monotonic() - t0

    fork = store.fork()
    sync()
    base = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.monotonic()
    eng = TorchCheckEngine(fork, nm, device=device, labels_device_min_edges=0)
    batches = record_sorts(eng)
    lst = SnapshotListEngine(eng, nm, device=device)
    monitor = HealthMonitor(eng, staleness_budget_s=60.0)
    batcher = make_batcher(eng)
    # the flight recorder under build/, wired as the daemon wires it, but
    # with min_interval_s=0: every trigger of the phase writes its bundle
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    bundle_dir = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    fr = None
    metrics = obs.build_metrics(engine=lambda: eng, batcher=lambda: batcher,
                                monitor=lambda: monitor, lister=lambda: lst, store=lambda: fork,
                                flightrec=lambda: fr)
    fr = obs.build_flight_recorder(
        bundle_dir.name, obs.flightrec_collect(monitor=lambda: monitor, engine=lambda: eng,
                                               batcher=lambda: batcher, metrics=lambda: metrics),
        min_interval_s=0.0)
    obs.wire_flight_recorder(fr, monitor=monitor, engine=eng)
    triggered: list = []  # (reason, time.time()) of each trigger (this script's hook)
    on_oom = eng.hbm.on_oom

    def oom_hook(what):
        triggered.append(("oom", time.time()))
        on_oom(what)

    eng.hbm.on_oom = oom_hook
    server = RestServer(READ, fork, batcher, monitor=monitor, metrics=metrics)
    server.start()

    def scrape():
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=60) as r:
            return parse_exposition(r.read().decode())

    def bundle(reason, n, timeout=30.0):
        """The ``n``-th (from 1) bundle of ``reason``, once written: valid,
        its bytes and the seconds from its trigger to its file."""
        t_end = time.monotonic() + timeout
        while True:
            got = [(p, json.loads(p.read_text())) for p in list_bundles(bundle_dir.name)]
            got = sorted([(b["created_unix"], p, b) for p, b in got if b["reason"] == reason],
                         key=lambda x: x[0])
            if len(got) >= n or time.monotonic() > t_end:
                break
            time.sleep(0.02)
        if len(got) < n:
            fail(f"no {reason} bundle number {n} in {timeout}s: {fr.snapshot()}")
        _, path, b = got[n - 1]
        problems = validate_bundle(b)
        if problems:
            fail(f"the {reason} bundle is invalid: {problems}")
        trig = [t for r, t in triggered if r == reason]
        return b, {"reason": reason, "bytes": path.stat().st_size,
                   "trigger_to_file_s": path.stat().st_mtime - trig[n - 1],
                   "sections": sorted(b["sections"]), "detail": b["detail"][:80]}

    out["bundles"] = []
    try:
        if not eng.labels_settled():
            fail("no label index")
        sync()
        idx = eng._snapshot.labels
        out["build"] = {"s": time.monotonic() - t0, "labels": idx.backend,
                        "label_bytes": idx.device_bytes(), "entries": idx.n_entries}
        if idx.backend != "device":
            fail(f"the labels were built on the {idx.backend}")
        out["checks"] = checks("labels on", expected)
        if out["checks"]["label_checks"] == 0 or (on_card and not out["checks"]["label_step"]):
            fail(f"the label route never answered: {out['checks']}")
        dev_lists, list_s = listings()
        routes = dict(lst.requests_total)
        n_dev = sum(n for (_, p), n in routes.items() if p == "device")
        # "host": a listing whose seeds hold no interior row needs no fixpoint
        if set(p for (_, p) in routes) - {"device", "host"} or n_dev < HBM_LISTINGS:
            fail(f"the listings did not run on the card: {routes}")
        out["listings_device"] = {"s": list_s, "routes": {f"{o}/{p}": n
                                                          for (o, p), n in routes.items()}}

        # (a) the ledger against the card, and keto_hbm_resident_bytes
        # against the ledger
        out["a"] = ledger_line(torch, eng, base, lst)
        log(f"hbm (a) config 3: {json.dumps(out['a'])}")
        led = eng.hbm.ledger()
        got_led = {k[0][1]: v for k, v in _samples(scrape(), "keto_hbm_resident_bytes").items()}
        if {t: v for t, v in got_led.items() if v} != {t: float(v) for t, v in led.items() if v}:
            fail(f"(a) keto_hbm_resident_bytes {got_led} differs from the ledger {led}")
        out["a"]["scraped_tags"] = len(got_led)

        # (b) pressure: a budget below the bucket bytes of the next snapshot
        extra = [_new_edge(rctx, parsed, expected, set())]
        want1 = _rbac_expect(rctx, parsed, extra)
        snap0 = eng._snapshot
        auto = eng.hbm.budget_bytes
        eng.hbm.set_budget_bytes(eng.hbm.ledger()["snapshot"] // 2)
        m, g = extra[0]
        fork.write_relation_tuples(RelationTuple(
            namespace="groups", object=f"mid-{m}", relation="member",
            subject=SubjectSet("groups", f"leaf-{g}", "member")))
        t0 = time.monotonic()
        b_checks = checks("(b) under pressure", expected, mode="serving")
        b = {"checks": b_checks, "first_batch_s": time.monotonic() - t0}
        h = eng.health()
        b["counts"] = counts()
        b["health"] = {k: h[k] for k in ("memory_pressure", "hbm_rung", "hbm_resident_bytes",
                                          "hbm_budget_bytes", "staleness_s")}
        triggered.append(("health-degraded", time.time()))
        b["ready"] = ready()[:2]
        deg, deg_line = bundle("health-degraded", 1)
        out["bundles"].append(deg_line)
        if deg["sections"]["health"]["state"] != "degraded" or \
                "memory_pressure" not in deg["detail"]:
            fail(f"(b) the health-degraded bundle: {deg_line}, {deg['sections']['health']}")
        if eng._snapshot is not snap0 or not h["memory_pressure"] \
                or b["counts"]["evicted"] != ["staging", "labels", "reverse", "warm-ladder",
                                              "overlay-budget"] \
                or b["counts"]["refusals"] < 1 or b_checks["label_checks"] \
                or b_checks["label_step"]:
            fail(f"(b) the ladder: {b}")
        if b["ready"][0] != 200 or b["ready"][1].get("status") != "degraded":
            fail(f"(b) /health/ready: {b['ready']}")
        ev_lists, ev_s = listings()
        ev_routes = {f"{o}/{p}": n for (o, p), n in lst.requests_total.items()}
        b["listings_evicted_s"] = ev_s
        b["listing_routes"] = ev_routes
        differ = sum(x != y for x, y in zip(ev_lists, dev_lists))
        n_ev = sum(n for (_, p), n in lst.requests_total.items() if p == "evicted")
        if differ or n_ev != n_dev:
            fail(f"(b) {differ} listings differ on the reverse rung's route, {n_ev} evicted")
        log(f"hbm (b): {json.dumps(b)}")
        out["b"] = b

        # (c) staleness: the monitor's budget cut to HBM_STALENESS_S
        monitor.set_staleness_budget_s(HBM_STALENESS_S)
        t0 = time.monotonic()
        while monitor.status()[0] is not HealthState.NOT_SERVING:
            if time.monotonic() - t0 > 30:
                fail(f"(c) never NOT_SERVING: {monitor.status()}")
            time.sleep(0.05)
        st, body, retry = ready()
        out["c"] = {"not_serving_after_s": time.monotonic() - t0, "status": st, "body": body,
                    "retry_after": retry, "staleness_s": eng.staleness_s()}
        log(f"hbm (c): {json.dumps(out['c'])}")
        if st != 503 or retry != "1" or body.get("status") != "unavailable":
            fail(f"(c) /health/ready: {out['c']}")

        # (d) restore: the auto budget back, the ladder up, the labels rebuilt
        t0 = time.monotonic()
        eng.hbm.set_budget_bytes(device_budget_bytes(eng.device) if on_card else auto)
        eng.snapshot()
        sync()
        d = {"refresh_s": time.monotonic() - t0, "counts": counts()}
        d["ledger_with_overlay"] = ledger_line(torch, eng, base, lst)
        t1 = time.monotonic()
        snap = eng.maintenance_settled(fold=True, timeout=300)
        sync()
        d["labels_restored_s"] = time.monotonic() - t1
        d["restore_s"] = time.monotonic() - t0
        d["checks"] = checks("(d) restored", want1)
        d["flipped"] = sum(a != b_ for a, b_ in zip(want1, expected))
        d["ready"] = ready()[:2]
        d["state"] = monitor.status()[0].value
        if snap.labels is None or eng.hbm.rung_depth or snap.has_overlay \
                or not d["checks"]["label_checks"] or d["state"] == "not_serving":
            fail(f"(d) restore: {d}")
        monitor.set_staleness_budget_s(60.0)
        if monitor.status()[0] is not HealthState.SERVING or d["ready"][0] != 200:
            fail(f"(d) health: {monitor.status()}")
        d["labels_backend"] = snap.labels.backend
        log(f"hbm (d): {json.dumps(d)}")
        out["d"] = d

        if on_card:
            def oom_bundle(n, events):
                """After (e0) or (e1): its ``oom`` bundle shows the event."""
                got, line = bundle("oom", n)
                hbm = got["sections"].get("hbm", {})
                out["bundles"].append(line)
                if hbm.get("oom_events") != events:
                    fail(f"(e) oom bundle {n}: hbm {hbm.get('oom_events')}, counted {events}")

            out["e"] = hbm_real_oom(torch, eng, fork, queries, want1, rctx, parsed, extra,
                                    checks, counts, fail, monitor, oom_bundle)
            fams = scrape()
            snap_g = eng.hbm.snapshot()
            scraped = (sum(_samples(fams, "keto_oom_events_total").values()),
                       sum(_samples(fams, "keto_oom_recoveries_total").values()))
            if scraped != (snap_g["oom_events"], snap_g["oom_recoveries"]):
                fail(f"(e) the scrape's OOM counts {scraped}, the governor's {snap_g}")
            out["e"]["scraped_oom"] = scraped
        log(f"hbm bundles (min_interval_s=0): {json.dumps(out['bundles'])}")

        # (f) the build transients: refused with evict=False, built on the host
        depth = eng.hbm.rung_depth
        big = [arrays for arrays, _ in batches
               if max((a.size for a in arrays), default=0) >= DEFAULT_MIN_EDGES]
        sorter = GovernedSorter(eng.device, hbm=eng.hbm, on_count=eng._incr)
        card = [sorter.argsort_many(arrays) for arrays in big]
        c0 = eng.counters()
        eng.hbm.set_budget_bytes(eng.hbm.resident_bytes() + 1)
        t0 = time.monotonic()
        host = [sorter.argsort_many(arrays) for arrays in big]
        sort_host_s = time.monotonic() - t0
        snap = eng._snapshot
        eng.hbm.set_budget_bytes(eng.hbm.resident_bytes() + eng.label_build_bytes - 1)
        t0 = time.monotonic()
        idx_host = eng._build_label_index(snap)
        label_host_s = time.monotonic() - t0
        c1 = eng.counters()
        eng.hbm.set_budget_bytes(device_budget_bytes(eng.device) if on_card else auto)
        same_sorts = all(np.array_equal(x, y) for a, b_ in zip(card, host) for x, y in zip(a, b_))
        same_labels = bool(np.array_equal(idx_host.out_lab, snap.labels.out_lab)
                           and np.array_equal(idx_host.in_lab, snap.labels.in_lab))
        f = {"sort_batches": len(big), "sorted_keys": sum(a.size for b_ in big for a in b_),
             "host_sort_s": sort_host_s, "sorts_equal": same_sorts,
             "device_build_skipped": c1.get("device_build_skipped", 0)
             - c0.get("device_build_skipped", 0),
             "label_backend": idx_host.backend, "labels_equal": same_labels,
             "label_host_s": label_host_s,
             "label_device_build_skipped": c1.get("label_device_build_skipped", 0)
             - c0.get("label_device_build_skipped", 0),
             "rung_before": depth, "rung_after": eng.hbm.rung_depth}
        log(f"hbm (f): {json.dumps(f)}")
        if not big or not same_sorts or not same_labels or f["device_build_skipped"] != len(big) \
                or f["label_device_build_skipped"] != 1 or idx_host.backend != "host" \
                or f["rung_after"] != depth:
            fail(f"(f) the build transients: {f}")
        out["f"] = f
    finally:
        server.stop()
        eng.close()
        bundle_dir.cleanup()
    out["seconds"] = time.monotonic() - t_phase
    report["hbm"] = out
    del eng, lst


def hbm_real_oom(torch, eng, fork, queries, want, rctx, parsed, extra, checks, counts, fail,
                 monitor, oom_bundle) -> dict:
    """(e) Real out-of-memory errors from the caching allocator, the card
    filled by ``_fill_card``. (e0) the ladder at 0: the 100k batch's first
    slice cannot allocate, the governor evicts the staging rung — host
    memory, nothing on the card — the retry fails too and the batch RAISES:
    no answer, counted, health SERVING; the card freed, the batch answers.
    (e1) the next refresh's overlay upload cannot allocate: the governor
    evicts the labels rung, whose arrays free their blocks, and the retry
    succeeds (``oom_recoveries`` + 1). After each, ``oom_bundle(n,
    oom_events)`` holds the flight recorder's n-th ``oom`` bundle against
    the count."""
    from keto_tpu_torch.driver.health import HealthState
    from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectSet

    e: dict = {}
    c0 = counts()
    held = _fill_card(torch)
    e["e0_held_bytes"] = sum(t.numel() for t in held)
    t0 = time.monotonic()
    try:
        eng.batch_check(queries)
    except torch.OutOfMemoryError as err:
        e["e0_raised"] = str(err).split("\n")[0][:160]
    finally:
        e["e0_s"] = time.monotonic() - t0
        e["e0_state"] = monitor.status()[0].value
        del held
        torch.cuda.empty_cache()
    c1 = counts()
    e["e0_counts"] = {k: c1[k] for k in ("oom_events", "oom_recoveries", "evicted")}
    if "e0_raised" not in e or c1["oom_events"] != c0["oom_events"] + 1 \
            or c1["oom_recoveries"] != c0["oom_recoveries"] or c1["evicted"] != ["staging"] \
            or e["e0_state"] != HealthState.SERVING.value:
        fail(f"(e0) a real OOM no rung clears: {e}")
    oom_bundle(1, c1["oom_events"])
    e["e0_after"] = checks("(e0) the card freed", want)

    m, g = _new_edge(rctx, parsed, want, set(extra))
    extra.append((m, g))
    want2 = _rbac_expect(rctx, parsed, extra)
    fork.write_relation_tuples(RelationTuple(
        namespace="groups", object=f"mid-{m}", relation="member",
        subject=SubjectSet("groups", f"leaf-{g}", "member")))
    held = _fill_card(torch)
    t0 = time.monotonic()
    try:
        snap = eng.snapshot()
        e["e1_s"] = time.monotonic() - t0
    finally:
        del held
        torch.cuda.empty_cache()
    c2 = counts()
    e["e1_counts"] = {k: c2[k] for k in ("oom_events", "oom_recoveries", "evictions_by_rung")}
    if snap.snapshot_id != fork.watermark() or c2["oom_events"] != c1["oom_events"] + 1 \
            or c2["oom_recoveries"] != c1["oom_recoveries"] + 1 \
            or c2["evictions_by_rung"].get("labels", 0) \
            != c1["evictions_by_rung"].get("labels", 0) + 1:
        fail(f"(e1) a real OOM at the refresh's upload: {e}, {c2}")
    oom_bundle(2, c2["oom_events"])
    t0 = time.monotonic()
    eng.maintenance_settled(fold=True, timeout=300)
    e["e1_labels_restored_s"] = time.monotonic() - t0
    e["e1_after"] = checks("(e1) recovered", want2)
    if not e["e1_after"]["label_checks"] or eng.hbm.rung_depth:
        fail(f"(e1) the labels did not come back: {e}")
    log(f"hbm (e): {json.dumps(e)}")
    return e


# -- phase 6: deep, config 4 on the label route ---------------------------------


def label_digest(idx) -> str:
    """A short hash of a label index's arrays, to hold two builds (two
    trees, or the sharded and the unsharded build) against each other."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in ("out_lab", "in_lab", "out_ok", "in_ok", "processed"):
        h.update(np.ascontiguousarray(getattr(idx, k)).tobytes())
    return h.hexdigest()[:16]


def deep_build_families(metrics, engine, n_tuples: int) -> dict:
    """The ``keto_build_*`` families after deep's first build and its label
    build: a phase-histogram series for every phase the build names (and
    ``labels``), and the rows ingested equal to the store's rows. The scrape
    is the registry's render, strictly parsed."""
    from keto_tpu_torch.x.metrics import parse_exposition

    render_s = []  # twice: the first pays what a process's first render pays
    for _ in range(2):
        t0 = time.perf_counter()
        text = metrics.render()
        fams = parse_exposition(text)
        render_s.append(time.perf_counter() - t0)
    counts = {dict(k)["phase"]: v for k, v in
              _samples(fams, "keto_build_phase_duration_seconds_count").items()}
    sums = {dict(k)["phase"]: round(v, 3) for k, v in
            _samples(fams, "keto_build_phase_duration_seconds_sum").items()}
    rows = sum(_samples(fams, "keto_build_rows_ingested_total").values())
    edges = sum(_samples(fams, "keto_build_edges_ingested_total").values())
    named = set((engine.build_info or {}).get("phases_s", {})) | {"labels"}
    res = {"phases": counts, "phase_s": sums, "rows_ingested": rows, "edges_ingested": edges,
           "store_rows": n_tuples, "build_info_phases": sorted(named), "render_s": render_s,
           "bytes": len(text)}
    log(f"deep build families: {json.dumps(res)}")
    if named - set(counts) or rows != n_tuples:
        raise SystemExit(f"deep FAILED: the build families {res}")
    return res


def build_split(info) -> dict:
    """The device label build's seconds by part (host clock, BuildInfo):
    seed uploads, sweeps from launch to host read (the stored bitmap's
    download included), the covered masks (K7: the own rows' check and
    upload, the launch), the mirror's flushes (K9, one call each), and the
    rest: the host mirror and the finalize."""
    build_s = info.build_ms / 1e3
    parts = {"upload_s": info.upload_s, "sweep_s": info.sweep_s, "covered_s": info.covered_s,
             "flush_s": info.flush_s}
    return {"sweeps": info.sweeps, "waves": info.waves, "flushes": info.flushes,
            "build_s": build_s, **parts, "host_s": build_s - sum(parts.values())}


def phase_deep(torch, kernels, report):
    """BASELINE config 4 with the default engine: device label build, label
    route. Returns what the kernel rows need."""
    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.check.engine import CheckEngine
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
    from keto_tpu_torch.driver import observability as obs
    from keto_tpu_torch.persistence.memory import MemoryPersister
    from keto_tpu_torch.workloads import GITHUB_NAMESPACES, github_queries, github_workload

    rng = random.Random(SEED + 4)
    t0 = time.monotonic()
    tuples, ctx = github_workload(rng, DEEP_TUPLES)
    queries, expected = github_queries(rng, N_CHECKS, ctx)
    gen_s = time.monotonic() - t0
    nm = tns.MemoryManager(GITHUB_NAMESPACES)
    store = MemoryPersister(nm)
    t0 = time.monotonic()
    store.write_relation_tuples(*tuples)
    store_s = time.monotonic() - t0
    n_tuples = len(tuples)
    del tuples
    rss_stored = host_rss()
    log(f"deep workload: {n_tuples} tuples, {len(queries)} checks, {sum(expected)} expected "
        f"grants ({gen_s:.1f}s to generate, {store_s:.1f}s to store)")

    # the main path's run: counts from the snapshot and label build on
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    engine = TorchCheckEngine(store, nm, device="cuda")
    # the build families: the phase histogram attached before the first build
    metrics = obs.build_metrics(engine=lambda: engine)
    obs.attach_engine(metrics, engine)
    batches = record_sorts(engine)
    t0 = time.monotonic()
    snap = engine.snapshot()
    torch.cuda.synchronize()
    snap_s = time.monotonic() - t0
    rss_built = host_rss()
    slots = engine._interior_ell_slots(snap)
    sorts = sort_report(engine, batches)
    # K8's kernel row times the largest array the build sorted
    sort_keys = max((a for arrays, _ in batches for a in arrays), key=lambda a: a.size)
    log(f"deep snapshot: {snap.n_nodes} nodes, {snap.n_edges} edges, num_int={snap.num_int}, "
        f"num_active={snap.num_active}, {slots} interior ELL slots, "
        f"buckets={[(tuple(b.nbrs.shape), b.n) for b in snap.buckets]}, {snap_s:.3f}s; "
        f"list layouts fwd {snap.lay_fwd.n_rows} rows ({snap.lay_fwd.n_active} active), "
        f"rev {snap.lay_rev.n_active} active; build sorts {json.dumps(sorts)}")
    t0 = time.monotonic()
    if not engine.labels_settled():
        raise SystemExit("deep FAILED: no label index")
    settle_s = time.monotonic() - t0
    idx, info = snap.labels, engine.label_build_info
    build = {
        "backend": idx.backend, "build_s": idx.build_ms / 1e3, "settled_s": settle_s,
        "landmarks": info.landmarks if info else idx.n_landmarks,
        "batches": info.batches if info else 0, "restarts": info.restarts if info else 0,
        "entries": idx.n_entries, "coverage": idx.coverage, "Wo": int(idx.out_lab.shape[1]),
        "Wi": int(idx.in_lab.shape[1]), "transient_bytes": engine.label_build_bytes,
        "truncated": info.truncated if info else "",
        "label_sha256": label_digest(idx), "split": build_split(info) if info else None,
    }
    log(f"deep label build: {json.dumps(build)}")
    build_fams = deep_build_families(metrics, engine, n_tuples)
    # the first row materialization, once the label build has left the host
    cold = cold_start("deep", engine, store, store_s, snap_s, rss_stored, rss_built)

    # capture the label step's inputs while the batch runs (the launches
    # themselves are counted by the CUDA wrapper as always)
    captured = []
    dispatch = kernels.label_step

    def capture(out_lab, in_lab, entries, **kw):
        captured.append((out_lab, in_lab, entries, kw))
        return dispatch(out_lab, in_lab, entries, **kw)

    kernels.label_step = capture
    paths0 = host_paths(engine)
    try:
        t0 = time.monotonic()
        got = engine.batch_check(queries)
        torch.cuda.synchronize()
        check_s = time.monotonic() - t0
    finally:
        kernels.label_step = dispatch
    require_native("deep", snap, paths0, host_paths(engine))
    launches = dict(kernels.COUNTS)
    counts = route_counts(engine)
    peak = torch.cuda.max_memory_allocated()
    wrong = sum(g != e for g, e in zip(got, expected))
    log(f"deep path: {N_CHECKS} checks in {check_s:.3f}s ({N_CHECKS / check_s:.0f} checks/s), "
        f"peak device memory {peak / 2**20:.1f} MiB, route counts {counts}, launches {launches}, "
        f"wrong vs analytic {wrong}")
    if wrong:
        raise SystemExit(f"deep FAILED: {wrong} decisions differ from the expectation")
    missing = [k for k in ("label_step", "sweep_run", "covered", "slot_set") if not launches[k]]
    if missing:
        raise SystemExit(f"deep FAILED: kernels never launched: {missing}")
    if info is None or launches["slot_set"] != info.flushes:
        raise SystemExit(f"deep FAILED: {launches['slot_set']} slot set launches for "
                         f"{info.flushes if info else None} mirror flushes (one launch a flush)")
    if counts["label_device_builds"] != 1 or not counts["label_checks"]:
        raise SystemExit(f"deep FAILED: route counts {counts}")
    t0 = time.monotonic()
    got2 = engine.batch_check(queries)
    steady_s = time.monotonic() - t0
    if got2 != got:
        raise SystemExit("deep FAILED: a second run decided differently")
    oracle = CheckEngine(store)
    t0 = time.monotonic()
    step = max(1, N_CHECKS // DEEP_ORACLE_SAMPLE)
    sample = list(range(0, N_CHECKS, step))[:DEEP_ORACLE_SAMPLE]
    bad = sum(oracle.subject_is_allowed(queries[i]) != got[i] for i in sample)
    log(f"deep oracle sample: {len(sample)} checks, {bad} mismatches "
        f"({time.monotonic() - t0:.1f}s); steady {N_CHECKS / steady_s:.0f} checks/s")
    if bad:
        raise SystemExit(f"deep FAILED: {bad} oracle mismatches")
    host = host_split(engine, snap, queries)
    # the snapshot's interning once more from the rows, split into the C++
    # build call and the Python column extraction around it, and from the
    # column bundle, held against it
    rows, _ = store.snapshot_rows()
    wild = frozenset(n.id for n in GITHUB_NAMESPACES if n.name == "")
    nat, native_s, c_call_s = native_intern(rows, wild)
    del rows
    if (nat.num_nodes, nat.src.size) != (snap.n_nodes, snap.n_edges):
        raise SystemExit(f"deep FAILED: the interner gave {nat.num_nodes} nodes and "
                         f"{nat.src.size} edges, the snapshot {snap.n_nodes} and {snap.n_edges}")
    host.update(column_intern(store, wild, nat))
    del nat
    host.update({"snapshot_intern_s": (engine.build_info or {}).get("intern_s"),
                 "intern_rows": n_tuples, "intern_native_s": native_s,
                 "intern_c_call_s": c_call_s,
                 "snapshot_s": snap_s, "paths": host_paths(engine),
                 "checks_per_s": N_CHECKS / check_s, "steady_checks_per_s": N_CHECKS / steady_s})
    log(f"deep host path: {json.dumps(host)}")
    # K8 replayed on the idle card, after the path's peak memory was read
    sorts.update(k8_replay(batches, sorts["sort_s_card"]))
    del batches
    k8 = {k: v for k, v in sorts.items() if k.startswith("k8_")}
    log(f"deep build sorts on K8 alone: {json.dumps(k8)}")
    report["deep"] = {
        "config": "BASELINE config 4 (GitHub org/team/repo)", "tuples": n_tuples,
        "alloc_before_engine": alloc0,
        "checks": N_CHECKS, "cold_start": cold, "snapshot_s": snap_s, "interior_rows": snap.num_int,
        "interior_ell_slots": slots, "label_build": build, "check_s": check_s,
        "checks_per_s": N_CHECKS / check_s, "steady_check_s": steady_s,
        "steady_checks_per_s": N_CHECKS / steady_s, "peak_device_bytes": peak,
        "route_counts": counts, "launches": launches, "oracle_sample": len(sample),
        "oracle_mismatches": bad, "grants": sum(expected), "build_sorts": sorts,
        "host_path": host, "build_families": build_fams,
    }
    return engine, snap, captured, launches, store, queries, got, ctx, sort_keys


#: the cache phase: the catch-up's writes, the seconds of its save and
#: reload past which the catch-up and the corruption run at config 3, and
#: the sharded save's shards
CACHE_WRITES = 5_000
CACHE_CONFIG3_AFTER_S = 120.0
CACHE_SHARDS = 4


def config3_store():
    """Config 3's store, queries and expected decisions, made as the main
    phase makes them (for a cache phase run without main)."""
    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.persistence.memory import MemoryPersister
    from keto_tpu_torch.workloads import RBAC_NAMESPACES, rbac_queries, rbac_workload

    rng = random.Random(SEED)
    tuples, ctx = rbac_workload(rng, N_TUPLES)
    queries, expected = rbac_queries(rng, N_CHECKS, ctx)
    nm = tns.MemoryManager(RBAC_NAMESPACES)
    store = MemoryPersister(nm)
    store.write_relation_tuples(*tuples)
    return store, nm, queries, expected


def cache_burst(snap, ns: str, ns_id: int, prefix: str, rng) -> list:
    """CACHE_WRITES memberships of new users on the groups ``prefix-k`` that
    ``snap`` holds (sink edges: the overlay keeps the labels live)."""
    from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID

    n_groups = 0
    while snap.resolve_set(ns_id, f"{prefix}-{n_groups}", "member") is not None:
        n_groups += 1
    return [RelationTuple(ns, f"{prefix}-{rng.randrange(n_groups)}", "member",
                          SubjectID(f"cache-user-{i}")) for i in range(CACHE_WRITES)]


def phase_cache(torch, kernels, report, deep_keep, main_keep, device="cuda"):
    """The snapshot cache (see the module docstring): (a) deep's snapshot
    saved, (b) reloaded by a fresh engine, (e) config 3's sharded save
    reloaded by a sharded and a single-device engine, (c) an older cache
    caught up through the delta path, (d) a corrupted segment quarantined.
    Returns the reload's launch counts (K8's among them)."""
    import os
    import shutil
    import tempfile

    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
    from keto_tpu_torch.graph import snapcache
    from keto_tpu_torch.parallel import make_mesh
    from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def fail(what):
        raise SystemExit(f"cache FAILED: {what}")

    deep, store, queries, got_deep, _ = deep_keep
    out: dict = {}
    root = tempfile.mkdtemp(prefix="keto-snapcache-")
    try:
        usage = shutil.disk_usage(root)
        out["disk"] = {"dir": root, "free_bytes": usage.free, "total_bytes": usage.total}
        log(f"cache: {root}, {usage.free / 2**30:.1f} GiB free of {usage.total / 2**30:.1f} GiB")

        # (a) the save: deep's snapshot, its labels settled
        if not deep.labels_settled():
            fail("deep's engine has no label index to save")
        d4 = os.path.join(root, "config4")
        timings: dict = {}
        snap = deep.snapshot()
        path4 = snapcache.save_snapshot(snap, d4, labels_wait=deep._label_build_wait,
                                        timings=timings)
        if path4 is None:
            fail("deep's snapshot was not cacheable")
        save = {**timings, "rest_s": timings["seconds"] - timings["strings_s"],
                "tag": os.path.basename(path4),
                "segments": len(json.loads(open(os.path.join(path4, "meta.json")).read())
                                ["segments"])}
        out["save"] = save
        log(f"cache (a) save: {json.dumps(save)}")

        # (b) the reload: a fresh engine on deep's store, to its first batch
        kernels.reset_counts()
        t0 = time.monotonic()
        eng = TorchCheckEngine(store, store.namespaces, device=device, snapshot_cache_dir=d4)
        got = eng.batch_check(queries)
        sync()
        first_s = time.monotonic() - t0
        launches = dict(kernels.COUNTS)
        c = eng.counters()
        t0 = time.monotonic()
        got2 = eng.batch_check(queries)
        sync()
        steady_s = time.monotonic() - t0
        deep_r = report.get("deep", {})
        reload = {
            "first_batch_s": first_s, "reload_s": eng.last_cache_load["seconds"],
            "bytes": eng.last_cache_load["bytes"], "labels": eng.last_cache_load["labels"],
            "deep_snapshot_s": deep_r.get("snapshot_s"),
            "deep_label_build_s": deep_r.get("label_build", {}).get("build_s"),
            "deep_label_settled_s": deep_r.get("label_build", {}).get("settled_s"),
            "counters": {k: c.get(k, 0) for k in (
                "cache_loads", "full_rebuilds", "label_builds", "cache_quarantined",
                "cache_load_failures", "label_checks", "label_fallbacks",
                "resolve_python_batches", "resolve_native_batches",
                "device_build_dispatches", "device_build_host_dispatches")},
            "k8": {k: launches[k] for k in ("radix_sort", "radix_hist", "radix_pass",
                                            "radix_pass_skipped")},
            "resolve_path": "python" if not c.get("resolve_native_batches") else "native",
            "checks_per_s_first": len(queries) / first_s,
            "checks_per_s_steady": len(queries) / steady_s,
            "wrong_vs_deep": sum(a != b for a, b in zip(got, got_deep)),
        }
        out["reload"] = reload
        log(f"cache (b) reload: {json.dumps(reload)}")
        if reload["wrong_vs_deep"] or got2 != got:
            fail(f"{reload['wrong_vs_deep']} reloaded decisions differ from deep's")
        if (c.get("cache_loads"), c.get("full_rebuilds", 0), c.get("label_builds", 0)) != (1, 0, 0):
            fail(f"the reload's counters: {reload['counters']}")
        if on_card and not launches["radix_hist"]:
            fail("the reload's list layouts never launched K8")
        eng.close()
        del eng, got, got2
        ab_s = timings["seconds"] + first_s
        small = ab_s > CACHE_CONFIG3_AFTER_S
        out["catch_up_config"] = 3 if small else 4

        # (e) config 3's sharded save, reloaded sharded and single-device
        if main_keep is not None:
            _, queries3, (store3, nm3, _, expected3) = main_keep
        else:
            store3, nm3, queries3, expected3 = config3_store()
        d3 = os.path.join(root, "config3")
        kw3 = dict(device=device, labels_enabled=False, snapshot_cache_dir=d3)
        sh = TorchCheckEngine(store3, nm3, mesh=make_mesh(graph=CACHE_SHARDS, device=device), **kw3)
        snap3 = sh.snapshot()
        sh.cache_settled(600)
        path3 = sh.save_snapshot_cache()
        saved3 = dict(sh.last_cache_save or {})
        sh.close()
        names = os.listdir(path3)
        meta3 = json.loads(open(os.path.join(path3, "meta.json")).read())
        stripes = [n for n in names if n.startswith("bucket_") and "_s" in n]
        sharded = {"shards": meta3["shards"], "stripes": len(stripes),
                   "buckets": len(meta3["buckets"]),
                   "groups": sorted(g for g in meta3["groups"] if g.startswith("shard")),
                   "save_s": saved3.get("seconds"), "bytes": saved3.get("bytes")}
        if meta3["shards"] != CACHE_SHARDS or len(stripes) != CACHE_SHARDS * len(meta3["buckets"]):
            fail(f"the sharded save: {sharded}")
        for mode, extra in (("sharded", {"mesh": make_mesh(graph=CACHE_SHARDS, device=device)}),
                            ("single", {})):
            t0 = time.monotonic()
            e = TorchCheckEngine(store3, nm3, **kw3, **extra)
            g = e.batch_check(queries3)
            sync()
            ce = e.counters()
            wrong = sum(a != b for a, b in zip(g, expected3))
            sharded[mode] = {"first_batch_s": time.monotonic() - t0,
                             "reload_s": e.last_cache_load["seconds"] if e.last_cache_load else None,
                             "cache_loads": ce.get("cache_loads", 0),
                             "full_rebuilds": ce.get("full_rebuilds", 0), "wrong": wrong}
            e.close()
            if wrong or (ce.get("cache_loads"), ce.get("full_rebuilds", 0)) != (1, 0):
                fail(f"the {mode} reload of the sharded save: {sharded[mode]}")
        out["sharded"] = sharded
        log(f"cache (e) sharded: {json.dumps(sharded)}")

        # (c) the catch-up: writes on a fork, the older cache reloaded, the
        # delta path to the fork's watermark, decisions equal a fresh build's
        if small:
            cstore, cnm, cq, cdir, csnap = store3, nm3, queries3, d3, snap3
            burst_of, labels = ("groups", 1, "leaf"), False
        else:
            cstore, cnm, cq, cdir, csnap = store, store.namespaces, queries, d4, snap
            burst_of, labels = ("teams", 2, "team"), True
        burst = cache_burst(csnap, *burst_of, random.Random(SEED + 7))
        fork = cstore.fork()
        t0 = time.monotonic()
        wm = fork.transact_relation_tuples(burst, ()).snaptoken
        store_s = time.monotonic() - t0
        qs = list(cq) + [RelationTuple(b.namespace, b.object, "member", b.subject) for b in burst]
        qs += [RelationTuple(b.namespace, b.object, "member", SubjectID(b.subject.id + "-ghost"))
               for b in burst[:500]]
        t0 = time.monotonic()
        e = TorchCheckEngine(fork, cnm, device=device, snapshot_cache_dir=cdir,
                             labels_enabled=labels, compact_after_s=3600.0,
                             overlay_edge_budget=1 << 20)
        got = e.batch_check(qs)
        sync()
        catch_s = time.monotonic() - t0
        ce = e.counters()
        snap_c = e.snapshot()
        e.close()
        t0 = time.monotonic()
        fresh = TorchCheckEngine(fork, cnm, device=device, labels_enabled=False)
        want = fresh.batch_check(qs)
        sync()
        fresh_s = time.monotonic() - t0
        fresh.close()
        catch = {"config": out["catch_up_config"], "writes": len(burst), "store_s": store_s,
                 "watermark": wm, "cached_watermark": int(csnap.snapshot_id),
                 "first_batch_s": catch_s, "fresh_build_and_batch_s": fresh_s,
                 "checks": len(qs), "overlay": snap_c.has_overlay,
                 "snapshot_id": int(snap_c.snapshot_id),
                 "counters": {k: ce.get(k, 0) for k in ("cache_loads", "delta_applies",
                                                        "full_rebuilds", "label_builds")},
                 "wrong_vs_fresh": sum(a != b for a, b in zip(got, want)),
                 "burst_granted": sum(got[len(cq):len(cq) + len(burst)])}
        out["catch_up"] = catch
        log(f"cache (c) catch-up: {json.dumps(catch)}")
        if catch["wrong_vs_fresh"] or catch["burst_granted"] != len(burst) or \
                snap_c.snapshot_id != wm:
            fail(f"the catch-up decided otherwise than a fresh build: {catch}")
        if (ce.get("cache_loads"), ce.get("full_rebuilds", 0)) != (1, 0) or not ce.get("delta_applies"):
            fail(f"the catch-up did not reload and apply a delta: {catch['counters']}")
        del fork, got, want

        # (d) a corrupted segment is quarantined
        victim_dir = sorted(p for p in os.listdir(cdir) if p.startswith("v"))[-1]
        meta_c = json.loads(open(os.path.join(cdir, victim_dir, "meta.json")).read())
        victim = "lab_out.npy" if "lab_out.npy" in meta_c["segments"] else sorted(
            n for n in meta_c["segments"] if n.startswith("bucket_"))[0]
        seg = os.path.join(cdir, victim_dir, victim)
        with open(seg, "r+b") as f:
            f.seek(os.path.getsize(seg) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))

        counts = collections.Counter()
        t0 = time.monotonic()
        loaded = snapcache.load_latest(
            cdir, stats=types.SimpleNamespace(incr=lambda k, by=1: counts.update({k: by})))
        corrupt = {"segment": victim, "quarantined": counts["cache_quarantined"],
                   "loaded": loaded is not None, "seconds": time.monotonic() - t0,
                   "left": sorted(os.listdir(cdir))}
        out["corruption"] = corrupt
        log(f"cache (d) corruption: {json.dumps(corrupt)}")
        if loaded is not None or corrupt["quarantined"] != 1 or victim_dir in corrupt["left"]:
            fail(f"the corrupted cache was not quarantined: {corrupt}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["cache"] = out
    return launches


def bare_ms(torch, launch, states, spin_cycles: int = 2_000_000) -> float:
    """Mean device time of one bare launch: ``launch(state)`` once on each of
    ``states`` (made beforehand), between two CUDA events queued behind a
    spin kernel, so the host's launch work happens while the card is busy
    and nothing but the kernel lies between the events."""
    torch.cuda.synchronize()
    pairs = []
    for st in states:
        torch.cuda._sleep(spin_cycles)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        rc = launch(st)
        e1.record()
        if rc:
            raise RuntimeError(f"bare launch failed: CUDA error {rc}")
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


def _ok(rc: int, what: str) -> None:
    """Raise on a launch's nonzero CUDA error code: a refused launch timed
    as an empty interval must not read as a fast kernel."""
    if rc:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


RUN_PHASES = ("halo", "pull", "overlay", "commit")


def run_phases(torch, kernels, launch, states, steps: int) -> dict:
    """Device ms a step of each phase of ``keto_check_run`` as the path runs
    it (on its co-resident grid, each phase up to the end of its grid
    barrier): ``launch(state, stamps)`` once on each of ``states``, the
    card's nanosecond clock stamped by the run at every phase boundary of
    its ``steps`` steps. The means over every step of every launch, the
    first launch's steps, and the stamps' finest nonzero step."""
    import numpy as np

    diffs = []
    for st in states:
        stamps = torch.zeros((steps, kernels.RUN_STAMPS), dtype=torch.int64, device="cuda")
        _ok(launch(st, stamps), "keto_check_run")
        t = stamps.cpu().numpy()
        d = np.diff(t, axis=1)
        if not t.all() or (d < 0).any():
            raise SystemExit(f"keto_check_run's phase stamps are incomplete or out of order: {t}")
        diffs.append(d / 1e6)
    d = np.concatenate(diffs)
    pos = d[d > 0]
    return {**{f"{k}_ms": float(d[:, i].mean()) for i, k in enumerate(RUN_PHASES)},
            "step_ms": float(d.sum(1).mean()), "steps": steps, "launches": len(states),
            "first_launch_ms": diffs[0].round(6).tolist(),
            "clock_step_ns": float(pos.min() * 1e6) if pos.size else None,
            "timed_by": "%globaltimer stamps of thread 0 of block 0 after each grid barrier"}


def words_changed(run, R0, P0, iters: int) -> int:
    """Words of R that the plain run changes, summed over its ``iters``
    steps: ``run(R, P, k)`` runs k steps on fresh copies (``block_iters``
    1, ``it_cap`` k), and step k's changes are R after k steps against R
    after k - 1."""
    prev, total = R0, 0
    for k in range(1, iters + 1):
        R = R0.clone()
        run(R, P0.clone(), k)
        total += int((R != prev).sum())
        prev = R
    return total


def sectors(torch, words) -> int:
    """The distinct 32-byte sectors (8 words) that gathers of the flat word
    indices ``words`` touch in one buffer."""
    return int(torch.unique(words >> 3).numel())


def host_reads(torch, fn) -> int:
    """The synchronising CUDA calls one ``fn()`` makes, counted by PyTorch's
    sync debug mode (each warns once)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # PyTorch's one-time notice that the mode is a prototype is not a sync
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


def call_ms(torch, fn, reps: int = 200) -> float:
    """Median host-clock time of one ``fn()`` over ``reps`` calls, each
    timed alone, for a call that makes no host read (it only enqueues, so
    its host time is what its caller waits): the median leaves out a
    garbage collection of the store's objects landing in one call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2] * 1e3


def whole_ms(torch, fn, reps: int) -> float:
    """Mean host-clock time of ``fn()`` over ``reps`` calls, each ending in
    its own host read (so the work is done when it returns)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def sweep_row(torch, name, replaces, part, run, launch, X0, launches, wave_bytes, halo_bytes,
              rate, extra, reps=20):
    """A whole-sweep kernel row: ``run(fn, budget)`` calls the wrapper
    (``sweep_cuda``) or the plain version (``sweep_ref``) on the path's
    inputs, ``launch(state)`` the bare kernel on ``sweep_state`` buffers.
    Holds the kernel against the plain version (no budget and one that runs
    dry a visit early), times the whole run (the wrapper's call: one launch
    and its one host read), the kernel alone (``bare_ms``) and the plain
    version, and counts the launches and host reads of one run (one each,
    or the row fails). The bound is what one run moves: the run's waves ×
    one wave's bytes, and ``halo_bytes`` for each halo copy between two
    waves (waves − 1 of them)."""
    from keto_tpu_torch.graph import label_kernels as lk

    want = run(lk.sweep_ref, None)
    before = lk.COUNTS["sweep_run"]
    reads = host_reads(torch, lambda: run(lk.sweep_cuda, None))
    per_run = lk.COUNTS["sweep_run"] - before
    got = run(lk.sweep_cuda, None)
    m, err = diff(got[0], want[0])
    m += sum(a != b for a, b in zip(got[1:], want[1:]))
    _, waves, visits, _ = want
    dry_got, dry_want = run(lk.sweep_cuda, visits - 1), run(lk.sweep_ref, visits - 1)
    m += sum(a != b for a, b in zip(dry_got[1:], dry_want[1:]))
    if not visits or waves < 2:
        raise SystemExit(f"{name} FAILED: the timed sweep runs {waves} waves, {visits} visits")
    ms = whole_ms(torch, lambda: run(lk.sweep_cuda, None), reps)
    states = [lk.sweep_state(X0) for _ in range(reps)]
    kernel_ms = bare_ms(torch, launch, states)
    last = states[-1]
    m += diff(last[3][: X0.numel()].view(X0.shape).cpu(), want[0])[0]
    del states, last
    plain = whole_ms(torch, lambda: run(lk.sweep_ref, None), 2)
    bound = (waves * wave_bytes + (waves - 1) * halo_bytes) / rate * 1e3
    r = {"name": name, "route": "cuda", "source": LABEL_SRC, "replaces": replaces, "part": part,
         "launches": launches["sweep_run"], "mismatches": m, "max_abs_err": err, "ms": ms,
         "kernel_ms": kernel_ms, "kernel_timed_by": "events around a bare launch behind a spin",
         "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
         "launches_per_run": per_run, "host_reads_per_run": reads, "waves": waves,
         "visits": visits, "wave_bound_ms": wave_bytes / rate * 1e3,
         "halo_bound_ms": halo_bytes / rate * 1e3,
         "runs_waves": launches["sweep_waves"], **extra}
    log(f"kernel {name}: {ms:.4f} ms a run (kernel alone {kernel_ms:.4f} ms, plain {plain:.4f} "
        f"ms, bound {bound:.4f} ms over {waves} waves), {per_run} launch and {reads} host read "
        f"a run, mismatches {m}, {json.dumps(extra)}")
    if m or per_run != 1 or reads != 1:
        raise SystemExit(f"{name} FAILED at its path's shapes: {m} mismatches, {per_run} "
                         f"launches and {reads} host reads a run")
    return r


def label_rows(torch, kernels, snap, engine, captured, launches, rate, int_rate):
    """Time K3, K6 and K7 at the deep path's shapes beside their plain
    versions and bounds; compare each against its plain version once more.
    No single PyTorch call computes any of the three (library_ms null)."""
    from keto_tpu_torch.graph import label_build, label_kernels as lk
    from keto_tpu_torch.graph.labels import interior_adjacency, landmark_order

    rows = []

    def row(name, replaces, cuda_fn, plain_fn, outs, bound_bytes, bound_ops, reps, extra,
            make=None, ms=None):
        m = sum(diff(a, b)[0] for a, b in zip(*outs))
        errs = [diff(a, b)[1] for a, b in zip(*outs)]
        if ms is not None:  # measured by the caller
            plain = time_ms(plain_fn, max(1, reps // 10), warmup=1)
        elif make is None:
            ms = time_ms(cuda_fn, reps)
            plain = time_ms(plain_fn, max(1, reps // 10), warmup=1)
        else:
            ms = time_fresh_ms(cuda_fn, make, reps)
            plain = time_fresh_ms(plain_fn, make, max(1, reps // 10), warmup=1)
        by_bytes = bound_bytes / rate * 1e3
        by_ops = bound_ops / int_rate * 1e3
        r = {"name": name, "route": "cuda", "source": "keto_tpu_torch/csrc/label_kernels.cu",
             "replaces": replaces, "launches": launches[name], "mismatches": m,
             "max_abs_err": max(errs), "ms": ms, "plain_ms": plain,
             "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops
             else "operations", "library_ms": None, "bytes_bound_ms": by_bytes,
             "ops_bound_ms": by_ops, **extra}
        rows.append(r)
        log(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}), mismatches {m}, {json.dumps(extra)}")

    # K3: the largest label step of the deep batch. ms: bare keto_label_step
    # launches in one CUDA graph (the kernel's device time; each launch ORs
    # into the same zeroed output, which ends equal to the plain answer);
    # wrapper_ms: the whole label_step_cuda call (checks, the zeroed output,
    # the ctypes launch), back to back
    out_lab, in_lab, entries, kw = max(captured, key=lambda c: c[3]["n_pairs"])
    P, B = kw["n_pairs"], kw["B"]
    e = entries.long()
    pa, pb = e[:P], e[P : 2 * P]
    n_out = (out_lab != -1).sum(1)
    n_in = (in_lab != -2).sum(1)
    compares = int((n_out[pa] * n_in[pb]).sum())
    Wo, Wi = out_lab.shape[1], in_lab.shape[1]
    k3_bytes = 12 * P + 4 * (int(torch.unique(pa).numel()) * Wo + int(torch.unique(pb).numel()) * Wi
                             + B // 32)
    want = kernels.label_step_ref(out_lab, in_lab, entries, **kw)
    bare = torch.zeros_like(want)
    lib = kernels._lib()
    ms, timed_by = graph_ms(torch, lambda: _ok(kernels.label_step_launch(
        lib, out_lab, in_lab, entries, P, bare, kernels._stream()), "keto_label_step"), 20)
    torch.cuda.synchronize()
    wrapper = time_ms(lambda: kernels.label_step_cuda(out_lab, in_lab, entries, **kw), 20)
    live = int(((pa < snap.num_int) & (pb < snap.num_int)).sum())
    team, k = kernels.label_team(Wo)
    log(f"kernel label_step shape: Wo={Wo} Wi={Wi} pairs={P} live_pairs={live} team={team} "
        f"k={k} (pairs a warp at once: {32 // team})")
    row("label_step", K3, None,
        lambda: kernels.label_step_ref(out_lab, in_lab, entries, **kw),
        ([kernels.label_step_cuda(out_lab, in_lab, entries, **kw), bare], [want, want]),
        k3_bytes, compares, 20,
        {"pairs": P, "live_pairs": live, "Wo": Wo, "Wi": Wi, "B": B, "team": team, "k": k,
         "valid_compares": compares, "wrapper_ms": wrapper, "timed_by": timed_by,
         "graph_launches": 20}, ms=ms)

    # K6: the first forward sweep of the build's first batch (no labels yet,
    # so nothing is covered), the whole run to its fixpoint
    n = snap.num_int
    out_ip, out_ix, in_ip, in_ix = interior_adjacency(snap)
    order = landmark_order(out_ip, in_ip, n)
    wt = engine._labels_batch // 32
    g = lk.EllGroups.from_groups(label_build.build_ell_groups(in_ip, in_ix, n), "cuda")
    X0 = torch.from_numpy(label_build._seed_bitmap(order[: 32 * wt], n, wt, n + 1)).cuda()
    cov = torch.zeros_like(X0)
    # a wave reads every slot and dst index once, one X row per distinct
    # source, and V, S, cov and X' once per dst word (the ping-pong buffers
    # are never zeroed)
    srcs = int((torch.unique(g.slots) < n).sum())
    wave_bytes = 4 * (g.slots.numel() + g.n_rows + wt * (srcs + 5 * g.n_rows))
    rows.append(sweep_row(torch, "sweep_run", K6, "one orientation's whole sweep (the waves of "
                          "_sweep_step().step to the fixpoint, label_build.py:269-281)",
                          lambda fn, b: fn(g, X0, cov, n_dst=n + 1, budget=b),
                          lambda st: lk.sweep_launch(lk._lib(), g, st, cov, n_dst=n + 1,
                                                     halo=False, prune_expansion=True,
                                                     budget=None, stream=lk._stream()),
                          X0, launches, wave_bytes, 0, rate,
                          {"rows": g.n_rows, "slots": int(g.slots.numel()), "groups": len(g.rows),
                           "caps": list(g.caps), "wt": wt, "distinct_source_rows": srcs}))

    # K7: the covered mask of a mid-build batch (the forward orientation:
    # the IN rows against the lanes' own OUT rows), against the final labels
    rows.append(covered_row(torch, snap, engine, order, wt, launches, rate))
    total = sum(r["mismatches"] for r in rows)
    if total:
        raise SystemExit(f"label kernel parity at deep shapes FAILED: {total} mismatching words")
    return rows


def covered_row(torch, snap, engine, order, wt, launches, rate, reps=20):
    """K7 at the deep path's shapes: the lanes of a mid-build batch (64
    landmarks from the middle of the landmark order) with their own OUT
    rows of the final index, against the IN rows padded to the build's
    width. Holds the kernel and the whole ``_compute_covered`` call against
    the plain version; times the wrapper's calls back to back (``ms``, CUDA
    events), the kernel alone (``kernel_ms``: its three launches behind a
    spin), the whole call on the host clock (``call_ms``: the own rows'
    check, their upload and the launches) and the plain version; counts the
    ``keto_covered`` calls (three device launches each) and the host reads
    of one call (the row fails unless 1 and 0)."""
    import numpy as np

    from keto_tpu_torch.graph import label_build, label_kernels as lk
    from keto_tpu_torch.graph.labels import IN_PAD, OUT_PAD

    n = snap.num_int
    idx = snap.labels
    mw = engine._labels_max_width
    lab = np.full((n + 1, mw), IN_PAD, np.int32)
    lab[:, : min(mw, idx.in_lab.shape[1])] = idx.in_lab[:, :mw]
    lanes = 32 * wt
    mid = order[(n // 2) : (n // 2) + lanes]
    own = np.full((lanes, mw), OUT_PAD, np.int32)
    own[:, : min(mw, idx.out_lab.shape[1])] = idx.out_lab[mid, :mw]
    lab_t = torch.from_numpy(lab).cuda()
    own_t = torch.from_numpy(own).cuda()
    table = torch.zeros((n + 1, wt), dtype=torch.int32, device="cuda")

    def call():
        return label_build._compute_covered(lab_t, own, lanes, wt, OUT_PAD, table=table)

    want = lk.covered_ref(lab_t, own_t, wt=wt)
    m, err = diff(lk.covered_cuda(lab_t, own_t, wt=wt, table=table), want)
    m += diff(call(), want)[0]
    before = lk.COUNTS["covered"]
    reads = host_reads(torch, call)
    per_call = lk.COUNTS["covered"] - before
    m += int(table.count_nonzero())
    ms = time_ms(lambda: lk.covered_cuda(lab_t, own_t, wt=wt, table=table), reps)
    out = torch.empty((n + 1, wt), dtype=torch.int32, device="cuda")
    lib, stream = lk._lib(), lk._stream()
    kernel_ms = bare_ms(torch, lambda _: lk.covered_launch(lib, lab_t, own_t, wt, table, out,
                                                           stream), [None] * reps)
    m += diff(out, want)[0]
    host_ms = call_ms(torch, call)
    plain = time_ms(lambda: lk.covered_ref(lab_t, own_t, wt=wt), 2, warmup=1)
    own_entries = int((own != OUT_PAD).sum())
    nbytes = 4 * (lab.size + own.size + (n + 1) * wt)
    r = {"name": "covered", "route": "cuda", "source": LABEL_SRC, "replaces": K7,
         "launches": launches["covered"], "mismatches": m, "max_abs_err": err, "ms": ms,
         "kernel_ms": kernel_ms,
         "kernel_timed_by": "events around the three bare launches behind a spin",
         "call_ms": host_ms, "call_timed_by": "host clock, median of 200 calls timed alone",
         "plain_ms": plain, "bound_ms": nbytes / rate * 1e3, "bound_by": "bytes",
         "bound_note": "the label array and own rows read once, the output written once; the "
                       "lane-mask table's gathers stay in L2 and are not counted",
         "library_ms": None, "launches_per_call": per_call, "host_reads_per_call": reads,
         "rows": n + 1, "width": mw, "lanes": lanes, "wt": wt, "own_entries": own_entries,
         "distinct_own_entries": int(np.unique(own[own != OUT_PAD]).size),
         "rows_covered": int((want != 0).any(1).sum())}
    log(f"kernel covered: {ms:.4f} ms a wrapper call (kernel alone {kernel_ms:.4f} ms, whole "
        f"_compute_covered {host_ms:.4f} ms, plain {plain:.4f} ms, bound {r['bound_ms']:.4f} ms), "
        f"{per_call} keto_covered call and {reads} host reads a call, mismatches {m}, "
        f"{json.dumps(r)}")
    if m or per_call != 1 or reads:
        raise SystemExit(f"covered FAILED at its path's shapes: {m} mismatches, {per_call} "
                         f"calls and {reads} host reads a call")
    return r


# -- phase 7: shard, sharded serving on the card (K10) -------------------------------

#: the shard phase's mesh: graph shards, all on the one card
SHARD_G = 4
SHARD_LISTS = 20
SHARD_ELL = 64


def slice_steps(engine, queries) -> list:
    """``(queries, iters, truncated, route)`` of every slice the batch path
    dispatches for ``queries``, each landed as the engine lands it. The
    controller's entry budget (which follows measured service times) is
    pinned off, so two engines cut the same slices."""
    engine.stream_ctrl.entry_budget = lambda: None
    try:
        snap = engine.snapshot()
        recs = []
        for rec in engine._dispatch_slices(snap, queries):
            if rec[0] is not None:
                rec[0].copy_to_host_async()
            recs.append(rec)
        out = []
        for dev, host_ans, nq, _chunk, leases, _n in recs:
            _, iters, truncated, route = engine._land_slice(dev, host_ans, nq, leases)
            out.append((nq, iters, truncated, route))
        return out
    finally:
        del engine.stream_ctrl.entry_budget


def shard_counts(engine) -> dict:
    c = engine.counters()
    return {k: c.get(k, 0) for k in ("shard_halo_rounds", "shard_halo_bytes",
                                     "shard_frontier_bits", "shard_dispatch_failures")}


def phase_shard(torch, kernels, report, main_keep, deep_keep, rate, int_rate, device="cuda"):
    """Sharded serving on one ``ShardMesh`` of SHARD_G shards (see the
    module docstring). Returns K10's kernel rows (none off the card: a
    CPU rehearsal runs the plain versions)."""
    import numpy as np

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_bytes():
        return torch.cuda.max_memory_allocated() if on_card else 0

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    from keto_tpu_torch.check.engine import CheckEngine
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
    from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
    from keto_tpu_torch.parallel import make_mesh
    from keto_tpu_torch.parallel import sharded as ps
    from keto_tpu_torch.workloads import github_list_queries

    single3, queries3, (store3, nm3, got3, expected3) = main_keep
    deep, deep_store, deep_q, deep_got, ctx = deep_keep
    mesh = make_mesh(graph=SHARD_G, device=device)
    out: dict = {"graph_shards": SHARD_G}
    captured: dict = {}
    wrapped = {name: getattr(ps, name) for name in ("check_step", "label_step", "label_sweep")}

    def capture(name):
        fn = wrapped[name]

        def call(*a, **kw):
            if name not in captured:
                captured[name] = (a, kw)
            return fn(*a, **kw)
        return call

    for name in wrapped:
        setattr(ps, name, capture(name))
    try:
        # (a) config 3, labels off: every check on the sharded BFS route
        eng = TorchCheckEngine(store3, nm3, device=device, labels_enabled=False, mesh=mesh)
        t0 = time.monotonic()
        snap = eng.snapshot()
        sync()
        snap_s = time.monotonic() - t0
        spec = snap.shard_spec
        kernels.reset_counts()
        if on_card:
            kernels.reset_run_counts()
        ps.reset_collective_counts()
        reset_peak()
        t0 = time.monotonic()
        got = eng.batch_check(queries3)
        sync()
        check_s = time.monotonic() - t0
        launches = dict(kernels.COUNTS)
        if on_card:  # the runs' steps and halo copies, counted on the card
            launches["check_run_steps"], launches["check_run_halo_copies"] = kernels.run_counts()
        coll = {k: (ps.COLLECTIVE_CALLS[k], ps.COLLECTIVE_BYTES[k]) for k in ps.COLLECTIVE_BYTES}
        peak = peak_bytes()
        wrong = sum(g != e for g, e in zip(got, expected3))
        differ = sum(g != e for g, e in zip(got, got3))
        counters = shard_counts(eng)
        missing = [k for k in ("seed", "check_run", "shard_answer") if on_card and not launches[k]]
        if on_card and (launches["seed"] != SHARD_G * launches["check_run"]
                        or launches["shard_answer"] != launches["check_run"]
                        or launches["pull"]
                        or not launches["check_run_halo_copies"] == launches["check_run_steps"]
                        == counters["shard_halo_rounds"]):
            missing.append(f"one run a step and a halo copy a step run: {launches}, "
                           f"halo rounds {counters['shard_halo_rounds']}")
        t0 = time.monotonic()
        got_b = eng.batch_check(queries3)
        steady_s = time.monotonic() - t0
        t0 = time.monotonic()
        single3.batch_check(queries3)
        single_s = time.monotonic() - t0
        bad = sum(CheckEngine(store3).subject_is_allowed(q) != g
                  for q, g in zip(queries3[:ORACLE_SAMPLE], got[:ORACLE_SAMPLE]))
        steps_sh, steps_one = slice_steps(eng, queries3), slice_steps(single3, queries3)
        a = {"config": "BASELINE config 3 (RBAC), labels off", "rows_per_shard": spec.rows_per_shard,
             "interior_rows": snap.num_int, "snapshot_s": snap_s, "check_s": check_s,
             "checks_per_s": N_CHECKS / check_s, "steady_checks_per_s": N_CHECKS / steady_s,
             "unsharded_steady_checks_per_s": N_CHECKS / single_s, "wrong_vs_analytic": wrong,
             "differ_from_unsharded": differ, "oracle_sample": ORACLE_SAMPLE, "oracle_mismatches": bad,
             "slices_sharded": steps_sh, "slices_unsharded": steps_one, "counters": counters,
             "collective_bytes": coll, "peak_device_bytes": peak, "launches": launches}
        log(f"shard (a): {json.dumps(a)}")
        out["g"] = shard_ledger_line(eng, queries3, expected3, on_card)
        eng.close()
        if wrong or differ or bad or got_b != got or missing or launches["answer_pack"]:
            raise SystemExit(f"shard FAILED (a): {wrong} wrong, {differ} differ, {bad} oracle, "
                             f"missing kernels {missing}, unsharded answer_pack "
                             f"{launches['answer_pack']}")
        if [x[:3] for x in steps_sh] != [x[:3] for x in steps_one] or not counters["shard_halo_rounds"]:
            raise SystemExit(f"shard FAILED (a): per-slice iters/truncated {steps_sh} vs "
                             f"{steps_one}, counters {counters}")
        out["a"] = a
        rows = shard_check_rows(torch, kernels, ps, mesh, snap, captured.pop("check_step"),
                                launches, rate) if on_card else []
        del eng, snap

        # (b) config 4 on a fork of the deep phase's store: labels on
        fork = deep_store.fork()
        eng = TorchCheckEngine(fork, fork.namespaces, device=device, mesh=mesh)
        kernels.reset_counts()
        ps.reset_collective_counts()
        reset_peak()
        t0 = time.monotonic()
        snap = eng.snapshot()
        sync()
        snap_s = time.monotonic() - t0
        t0 = time.monotonic()
        if not eng.labels_settled():
            raise SystemExit("shard FAILED: no sharded label index")
        settle_s = time.monotonic() - t0
        build_launches = dict(kernels.COUNTS)
        idx, one = snap.labels, deep.snapshot().labels
        same = {f: bool(np.array_equal(getattr(idx, f), getattr(one, f)))
                for f in ("out_lab", "in_lab", "out_ok", "in_ok", "processed")}
        halo = (ps.COLLECTIVE_CALLS["all_gather"], ps.COLLECTIVE_BYTES["all_gather"])
        build = {"backend": idx.backend, "build_s": idx.build_ms / 1e3, "settled_s": settle_s,
                 "unsharded_build_s": one.build_ms / 1e3, "entries": idx.n_entries,
                 "unsharded_entries": one.n_entries, "equal": same,
                 "label_sha256": label_digest(idx),
                 "split": build_split(eng.label_build_info) if eng.label_build_info else {},
                 "waves": build_launches["sweep_waves"], "halo_rounds": halo[0],
                 "halo_bytes": halo[1],
                 "launches": {k: build_launches[k] for k in ("sweep_run", "covered", "slot_set")}}
        sweeps = build["split"].get("sweeps", 0)
        build["per_sweep"] = {"launches": build_launches["sweep_run"] / max(1, sweeps),
                              "halo_rounds": halo[0] / max(1, sweeps),
                              "halo_bytes": halo[1] / max(1, sweeps)}
        log(f"shard (b) label build: {json.dumps(build)}")
        if idx.backend != "sharded" or not all(same.values()) \
                or (on_card and build_launches["sweep_run"] != sweeps) \
                or (on_card and build_launches["slot_set"] != build["split"].get("flushes")) \
                or halo[0] != build["waves"] or halo[1] % max(1, halo[0]):
            raise SystemExit(f"shard FAILED: the sharded label build {build}")
        kernels.reset_counts()
        ps.reset_collective_counts()
        t0 = time.monotonic()
        got = eng.batch_check(deep_q)
        sync()
        check_s = time.monotonic() - t0
        launches = dict(kernels.COUNTS)
        t0 = time.monotonic()
        eng.batch_check(deep_q)
        steady_s = time.monotonic() - t0
        t0 = time.monotonic()
        deep.batch_check(deep_q)
        single_s = time.monotonic() - t0
        wrong = sum(g != e for g, e in zip(got, deep_got))
        hq, hwant = hybrid_queries(deep_q, deep_got, ctx)
        before = dict(kernels.COUNTS)
        hgot = eng.batch_check(hq)
        hybrid_launches = {k: kernels.COUNTS[k] - before[k] for k in
                           ("shard_answer", "pair_rows", "label_step", "check_run",
                            "answer_pack")}
        hwrong = sum(g != w for g, w in zip(hgot, hwant))
        hsteps, hsteps_one = slice_steps(eng, hq), slice_steps(deep, hq)
        gen, _ = eng.batch_check_stream_with_token(hq, ordered=False, with_info=True,
                                                   slice_cap=HYBRID_SLICE)
        infos = [info for _, _, info in gen]
        b = {"config": "BASELINE config 4 (GitHub org/team/repo), labels on",
             "rows_per_shard": snap.shard_spec.rows_per_shard, "interior_rows": snap.num_int,
             "snapshot_s": snap_s, "label_build": build, "check_s": check_s,
             "checks_per_s": N_CHECKS / check_s, "steady_checks_per_s": N_CHECKS / steady_s,
             "unsharded_steady_checks_per_s": N_CHECKS / single_s, "wrong_vs_analytic": wrong,
             "route_counts": route_counts(eng), "launches": launches,
             "hybrid": {"checks": len(hq), "wrong": hwrong, "launches": hybrid_launches,
                        "slices_sharded": hsteps, "slices_unsharded": hsteps_one,
                        "stream_routes": sorted({i["route"] for i in infos}),
                        "stream_halo_rounds": [i.get("halo_rounds") for i in infos],
                        "stream_halo_bytes": [i.get("halo_bytes") for i in infos]}}
        log(f"shard (b) checks: {json.dumps(b)}")
        if wrong or hwrong or (on_card and not (launches["pair_rows"] and launches["label_step"]
                                                and hybrid_launches["shard_answer"])) \
                or hybrid_launches["answer_pack"] \
                or [x[:3] for x in hsteps] != [x[:3] for x in hsteps_one] \
                or b["hybrid"]["stream_routes"] != ["hybrid"] \
                or not all(b["hybrid"]["stream_halo_rounds"]):
            raise SystemExit(f"shard FAILED (b): {json.dumps(b)}")

        # listings on the sharded engine: the list engine's own layouts
        objects, subjects = github_list_queries(random.Random(SEED + 5), SHARD_LISTS, ctx)
        lst = SnapshotListEngine(eng, fork.namespaces, device=device)
        lbad = sum(len(set(lst.list_objects("issues", "view", q)[0]) ^ set(w)) for q, w in objects)
        lbad += sum(len(set(lst.list_subjects("issues", o, "view")[0]) ^ set(w)) for o, w in subjects)
        lroutes = {f"{o}/{p}": n for (o, p), n in sorted(lst.requests_total.items())}
        b["listings"] = {"objects": len(objects), "subjects": len(subjects),
                         "wrong_items": lbad, "routes": lroutes}
        log(f"shard (b) listings: {json.dumps(b['listings'])}")
        if lbad or any(k.endswith("/host") for k in lroutes):
            raise SystemExit(f"shard FAILED (b): listings {b['listings']}")

        b["write"] = shard_write(kernels, eng, fork, deep_q, deep_got, ctx, sync, on_card)
        b["counters"] = shard_counts(eng)
        b["peak_device_bytes"] = peak_bytes()
        log(f"shard (b) counters {b['counters']}, peak device memory "
            f"{b['peak_device_bytes'] / 2**20:.1f} MiB")
        out["b"] = b
        if on_card:
            rows += shard_label_rows(torch, ps, mesh, captured, launches, build_launches, rate,
                                     int_rate, snap.num_int)
        eng.close()
    finally:
        for name, fn in wrapped.items():
            setattr(ps, name, fn)
    report["shard"] = out
    return rows


def shard_ledger_line(eng, queries, expected, on_card) -> dict:
    """(g) The per-shard ledger of the 4-shard engine at config 3 (labels
    off), its warm ladder loaded by ``warm_compile``, and a plan that only
    the hottest shard's slice of the budget refuses: the walk evicts rungs
    for the whole mesh at once, each counted once, until that slice fits —
    here the warm-ladder rung, after the three that hold nothing on this
    engine's card (staging is host memory, labels are off, no list engine
    is attached). The 100k checks then run on the trimmed widths and equal
    the expectation; the auto budget restores the ladder."""
    from keto_tpu_torch.driver.hbm import device_budget_bytes

    gov = eng.hbm
    warmed = eng.warm_compile()
    res = gov.shard_resident_bytes()
    g = {"warmed": warmed, "ledger": gov.ledger(), "per_shard": res,
         "per_shard_by_tag": gov.shard_ledger(), "budget": gov.budget_bytes}
    warm = gov.ledger().get("warmup", 0)
    hot = max(range(len(res)), key=lambda s: res[s])
    after = res[hot] - warm // len(res)
    x = max(16, -(-(gov.resident_bytes() - 4 * after) // 3) + 1, max(res) - after + 1)
    gov.set_budget_bytes(len(res) * (after + x))
    per = [0] * len(res)
    per[hot] = x
    g.update({"hot_shard": hot, "plan_bytes": x, "plan_budget": gov.budget_bytes,
              "global_fits": gov.fits(x), "hot_slice_fits": res[hot] + x <= gov.budget_bytes
              // len(res)})
    fits = gov.plan(x, what="one shard's upload", per_shard=per)
    snap = gov.snapshot()
    g.update({"planned": fits, "evicted": snap["evicted"],
              "evictions_by_rung": {k: v for k, v in snap["evictions_by_rung"].items() if v},
              "per_shard_after": gov.shard_resident_bytes(),
              "widths_after": list(eng._word_widths())})
    t0 = time.monotonic()
    got = eng.batch_check(queries)
    g["trimmed_check_s"] = time.monotonic() - t0
    g["wrong"] = sum(a != b for a, b in zip(got, expected))
    gov.set_budget_bytes(device_budget_bytes(eng.device) if on_card else 4 << 30)
    g["restored"] = gov.maybe_restore()
    log(f"shard (g): {json.dumps(g)}")
    if not warm or not fits or g["wrong"] or not g["global_fits"] or g["hot_slice_fits"] \
            or snap["evicted"][-1] != "warm-ladder" \
            or any(v != 1 for v in g["evictions_by_rung"].values()) or gov.rung_depth:
        raise SystemExit(f"shard FAILED (g): {g}")
    return g


def shard_write(kernels, eng, store, queries, expected, ctx, sync, on_card) -> dict:
    """One write of SHARD_ELL team→team edges (the overlay, routed per
    shard), the fold (the labels patched by the sharded sweeps), then the
    edges' deletes (tombstones: the owning shards' bucket slots patched by
    ``patch_pos``), each followed by the 100k checks: equal to the overlay
    run's decisions after the fold and to the expectation after the
    deletes, with an oracle sample each time."""
    import numpy as np

    from keto_tpu_torch.check.engine import CheckEngine
    from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

    rng = random.Random(SEED + 11)
    oracle = CheckEngine(store)
    snap = eng.snapshot()
    n_teams = 0
    while snap.resolve_set(2, f"team-{n_teams}", "member") is not None:
        n_teams += 1
    teams = [(f"team-{t}", d) for t, d in
             ((t, snap.resolve_set(2, f"team-{t}", "member")) for t in range(n_teams))
             if d is not None and d < snap.num_active]
    ip, ix = snap.fwd_indptr, snap.fwd_indices
    edges, used = [], set()
    while len(edges) < SHARD_ELL:
        (po, pd), (co, cd) = rng.sample(teams, 2)
        if cd in used or pd == cd or np.any(ix[ip[pd]:ip[pd + 1]] == cd):
            continue
        used.add(cd)
        edges.append(RelationTuple("teams", po, "member", SubjectSet("teams", co, "member")))
    touched = [int(t.object.split("-")[1]) for t in edges]

    def round_(name):
        before = dict(kernels.COUNTS)
        t0 = time.monotonic()
        got = eng.batch_check(queries)
        sync()
        dt = time.monotonic() - t0
        users = [f"user-{rng.randrange(800_000)}" for _ in range(50)]
        sample = [RelationTuple("teams", f"team-{t}", "member", SubjectID(u))
                  for t, u in zip(rng.choices(touched, k=50), users)]
        sample += [queries[i] for i in rng.sample(range(len(queries)), 50)]
        bad = sum(oracle.subject_is_allowed(q) != g for q, g in zip(sample, eng.batch_check(sample)))
        snap = eng.snapshot()
        r = {"checks_per_s": len(queries) / dt, "grants": sum(got), "oracle_mismatches": bad,
             "overlay": snap.has_overlay, "lab_dirty": len(snap.lab_dirty or ()),
             "shard_overlay": None if snap.device_shard_overlay is None
             else list(snap.device_shard_overlay[0].shape),
             "launches": {k: kernels.COUNTS[k] - before[k] for k in
                          ("shard_answer", "check_run_overlay", "pair_rows", "slot_set")}}
        log(f"shard write {name}: {json.dumps(r)}")
        if bad:
            raise SystemExit(f"shard FAILED: write {name}: {bad} oracle mismatches")
        return r, got

    out = {}
    before = dict(kernels.COUNTS)
    wm = store.transact_relation_tuples(edges, ()).snaptoken
    if eng.snapshot().snapshot_id != wm:
        raise SystemExit("shard FAILED: the write is not visible")
    out["overlay"], got_ov = round_("(overlay)")
    if (on_card and not out["overlay"]["launches"]["check_run_overlay"]) \
            or out["overlay"]["shard_overlay"] is None:
        raise SystemExit(f"shard FAILED: the routed overlay never ran: {out['overlay']}")
    t0 = time.monotonic()
    eng.maintenance_settled(fold=True, timeout=900)
    out["fold_s"] = time.monotonic() - t0
    out["last_compaction"] = eng.last_compaction
    out["after_fold"], got_fold = round_("(after the fold)")
    if got_fold != got_ov or (eng.last_compaction or {}).get("labels") != "patched":
        raise SystemExit(f"shard FAILED: the fold changed decisions or did not patch the labels: "
                         f"{eng.last_compaction}")
    slot0 = kernels.COUNTS["slot_set"]
    store.transact_relation_tuples((), edges)
    snap = eng.snapshot()
    out["tombstones"] = int(snap.ov_removed.size) if snap.ov_removed is not None else 0
    out["ell_patch_slot_sets"] = kernels.COUNTS["slot_set"] - slot0
    out["deleted"], got_del = round_("(deleted)")
    wrong = sum(g != e for g, e in zip(got_del, expected))
    out["wrong_vs_analytic_after_deletes"] = wrong
    out["launches"] = {k: kernels.COUNTS[k] - before[k] for k in
                       ("shard_answer", "check_run_overlay", "slot_set", "sweep_run", "covered")}
    log(f"shard write: {json.dumps({k: v for k, v in out.items() if k not in ('overlay', 'after_fold', 'deleted')})}")
    if wrong or not out["tombstones"] or (on_card and not out["ell_patch_slot_sets"]):
        raise SystemExit(f"shard FAILED: after the deletes {wrong} decisions differ from the "
                         f"expectation, {out['ell_patch_slot_sets']} ELL patch slot sets")
    return out


def _bound(rate, int_rate, nbytes, ops=0):
    by_bytes = nbytes / rate * 1e3
    by_ops = ops / int_rate * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _k10_row(rows, name, replaces, part, cuda_fn, plain_fn, outs, launches, bound, reps,
             library=None, extra=None, make=None, source=SHARD_SRC, ms=None, plain=None):
    m = sum(diff(a, b)[0] for a, b in zip(*outs))
    err = max(diff(a, b)[1] for a, b in zip(*outs))
    if ms is None and make is None:  # else measured by the caller
        ms = time_ms(cuda_fn, reps)
        plain = time_ms(plain_fn, max(1, reps // 10), warmup=1)
    elif ms is None:
        ms = time_fresh_ms(cuda_fn, make, reps)
        plain = time_fresh_ms(plain_fn, make, max(1, reps // 10), warmup=1)
    lib = None if library is None else time_ms(library, reps)
    r = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "part": part,
         "launches": launches, "mismatches": m, "max_abs_err": err, "ms": ms, "plain_ms": plain,
         "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib, **(extra or {})}
    rows.append(r)
    log(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f} ms, bound {bound[0]:.4f} ms by "
        f"{bound[1]}, library {lib}), mismatches {m}, {json.dumps(extra or {})}")


def shard_check_rows(torch, kernels, ps, mesh, snap, call, launches, rate) -> list:
    """K10a's rows at config 3's shapes (the first sharded dispatch of the
    shard phase's run): the whole program, its run alone (counting the
    frontier bits it sets, as on the path, and without the counter),
    ``keto_shard_answer`` and the halo copy, each beside its plain version
    and bound. The step must be the seeds, one run and one answer with no
    host read in between, and its halo copies equal its iters."""
    (m_, bk, ent, ovn, ovd), kw = call
    g, rps, B = ent.shape[0], kw["rps"], kw["B"]
    W, (S1, S2, SA, _) = B // 32, kw["sizes"]
    kernels.reset_run_counts()
    R, P, ab, state, counted = ps.fixpoint_cuda(mesh, bk, ent, ovn, ovd, **kw)
    truncated, iters = state[:2].tolist()
    steps, copies = kernels.run_counts()
    rows: list = []
    slab = rps * W * 4
    plan = ps.shard_runs(bk, g, rps, W)
    act = plan.n_rows * W * 4
    # what a hop's work must move: the halo copy (read + write every slab),
    # the pull's slots and distinct sources and its P rows (written once,
    # the answer's p_fix), one read of R's active rows; and the words of R
    # the hops change, written once (the commit's re-read of P is the run's
    # own cost, not the work's)
    slots = sum(k * nb.shape[1] for nb, k in zip(plan.nbrs, plan.rows))
    srcs = int(torch.unique(torch.cat([nb[:k].reshape(-1) for nb, k in
                                       zip(plan.nbrs, plan.rows)])).numel()) if slots else 0
    hop = 2 * g * slab + 4 * slots + srcs * W * 4 + 2 * act
    R0 = torch.zeros((g * rps, W), dtype=torch.int32, device="cuda")
    for s in range(g):
        R0[s * rps : (s + 1) * rps] = kernels.seed_ref(ent[s], kw["sizes"], rps - 1, W)[0]
    plain_run = lambda Rs, Ps, k=kw["it_cap"], b=kw["block_iters"]: ps.shard_run_ref(  # noqa: E731
        plan, Rs, Ps, ovn, ovd, rps=rps, it_cap=k, block_iters=b)
    changed = words_changed(lambda Rs, Ps, k: plain_run(Rs, Ps, k, 1), R0,
                            torch.zeros((g * rps, W), dtype=torch.int32, device="cuda"), iters)
    run_b = iters * hop + 4 * changed
    seed_b = g * (8 * (S1 + S2) + 2 * slab)
    # what the answer must move: every shard's target ids and sink pairs
    # (coalesced), a sector for every distinct sector the owned gathers
    # touch (P, ans_base, R), the answer written once; no read of R for the
    # popcount (the seeds and the run count it where they set the bits)
    e, a0 = ent.long(), 2 * S1 + 2 * S2
    qw = torch.arange(B, device="cuda") >> 5
    tflat, sflat = [], []
    for s in range(g):
        tg = e[s, a0 + 2 * SA :]
        ar, aq = e[s, a0 : a0 + SA], e[s, a0 + SA : a0 + 2 * SA]
        own, owned = tg < rps, (ar >= 0) & (ar < rps)
        tflat.append((s * rps + tg[own]) * W + qw[own])
        sflat.append((s * rps + ar[owned]) * W + (aq[owned] >> 5))
    gathers = {"P": sectors(torch, torch.cat(tflat)), "sinks_R": sectors(torch, torch.cat(sflat))}
    gathers["ans_base"] = gathers["P"]
    ans_b = 32 * sum(gathers.values()) + 4 * g * (B + 2 * SA) + 4 * (W + 3)
    ans_old = g * (4 * (B + 2 * SA) + slab) + 4 * (B + SA) + 4 * (W + 3)
    full = lambda: ps.check_step_cuda(mesh, bk, ent, ovn, ovd, **kw)  # noqa: E731
    plain = lambda: ps.check_step_ref(mesh, bk, ent, ovn, ovd, **kw)  # noqa: E731
    before = dict(kernels.COUNTS)
    reads = host_reads(torch, full)
    per_step = {k: kernels.COUNTS[k] - before[k] for k in
                ("seed", "check_run", "shard_answer", "pull", "answer_pack")}
    if reads or per_step != {"seed": g, "check_run": 1, "shard_answer": 1, "pull": 0,
                             "answer_pack": 0} or not steps == copies == iters:
        raise SystemExit(f"shard FAILED: a K10a step made {reads} host reads, launched "
                         f"{per_step}, ran {steps} steps with {copies} halo copies ({iters} iters)")
    _k10_row(rows, "shard_check_step", K10A, "the whole sharded BFS step (keto_seed a shard, "
             "ONE keto_check_run over every shard with its halo phase, ONE keto_shard_answer, "
             "and the step's allocations)", full, plain, ([full()], [plain()]),
             launches["check_run"], _bound(rate, 1, seed_b + run_b + ans_b), 5,
             extra={"g": g, "rps": rps, "W": W, "iters": iters, "truncated": truncated,
                    "halo_copies": copies, "host_reads": reads, "launches_a_step": per_step,
                    "sizes": list(kw["sizes"]),
                    "wall_ms": whole_ms(torch, lambda: full().tolist(), 20)})

    # the run alone over every shard: a bare launch behind a spin kernel on
    # its own copy of the seeded slabs, with its frontier-bit counter as on
    # the path (the phases also without it, in the same call)
    run_kw = dict(ov=kernels.RunOverlay.of(ovn, ovd, rps, rps), it_cap=kw["it_cap"],
                  block_iters=kw["block_iters"])
    lib_ = kernels._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def run_state():
        return (R0.clone(), kernels.pull_out(g * rps, W, plan.n_rows, kw["it_cap"], "cuda"),
                torch.zeros(3, dtype=torch.int32, device="cuda"), torch.empty_like(R0),
                torch.zeros(1, dtype=torch.int32, device="cuda"))

    bare = bare_ms(torch, lambda st: kernels.run_launch(lib_, plan, *st[:3], G=st[3], pop=st[4],
                                                        **run_kw, stream=stream),
                   [run_state() for _ in range(10)])
    wrapper = time_fresh_ms(lambda Rs, Ps, _, Gs, pc: kernels.check_run_cuda(
        plan, Rs, Ps, G=Gs, pop=pc, **run_kw), run_state, 10)
    phase_fns = {c: (lambda st, stamps, c=c: kernels.run_launch(
        lib_, plan, *st[:3], G=st[3], pop=st[4] if c else None, **run_kw, stamps=stamps,
        stream=stream)) for c in (True, False)}
    phases = run_phases(torch, kernels, phase_fns[True], [run_state() for _ in range(5)], iters)
    phases_uncounted = run_phases(torch, kernels, phase_fns[False],
                                  [run_state() for _ in range(5)], iters)
    run_plain = time_fresh_ms(lambda Rs, Ps, *_: plain_run(Rs, Ps), run_state, 2, warmup=1)
    Rc, Pc, Cc, Gc, pc = run_state()
    Sc = kernels.check_run_cuda(plan, Rc, Pc, G=Gc, pop=pc, **run_kw)
    Rr, Pr = R0.clone(), torch.zeros_like(Pc)
    pr = torch.zeros(1, dtype=torch.int32, device="cuda")
    Sr = ps.shard_run_ref(plan, Rr, Pr, ovn, ovd, rps=rps, it_cap=kw["it_cap"],
                          block_iters=kw["block_iters"], pop=pr)
    _k10_row(rows, "shard_check_run", K10A, "the sharded fixpoint, sharded.py:371-417: "
             "keto_check_run over every shard, a halo phase a hop run, the commits counting "
             "the frontier bits they set; ms is the kernel alone",
             None, None, ([Rc, Pc[: plan.n_rows], Sc[:2], pc], [Rr, Pr[: plan.n_rows], Sr[:2], pr]),
             launches["check_run"], _bound(rate, 1, run_b), 0, ms=bare, plain=run_plain,
             source="keto_tpu_torch/csrc/check_kernels.cu",
             extra={"wrapper_ms": wrapper, "iters": iters, "halo_copies": copies,
                    "runs": len(plan.rows), "ms_per_hop": bare / max(1, iters),
                    "words_changed": changed, "phases": phases,
                    "phases_without_counter": phases_uncounted,
                    "commit_phase_ms_counted_vs_not": [phases["commit_ms"],
                                                       phases_uncounted["commit_ms"]],
                    "pull_phase_bound_ms": _bound(rate, 1, 4 * slots + srcs * W * 4 + act)[0],
                    "bound_counts": "a hop: the halo (every slab read and written), slots, "
                                    "distinct source rows, P written, R's active rows read; "
                                    "the words changed written once"})

    # the answer: ONE launch over every shard into an output whose frontier
    # word the seeds and the run counted (the step's own count is held
    # against popcount(R) here, as the reference's psum computes it)
    pop_word = int(counted[W + 2]) & 0xFFFFFFFF
    pop_r = int(kernels._popcount(R).sum()) & 0xFFFFFFFF

    def answer():
        out = counted.clone()
        ps.shard_answer_cuda(ent, kw["sizes"], P, ab, R, rps, state, out)
        return out

    def answer_plain():
        return ps.shard_answer_ref(ent, kw["sizes"], P, ab, R, rps, iters, bool(truncated),
                                   pop_r)

    bare_out = counted.clone()
    ans_ms, ans_how = graph_ms(torch, lambda: _ok(lib_.keto_shard_answer(
        ent.data_ptr(), ent.shape[1], g, S1, S2, SA, B, rps, P.data_ptr(), ab.data_ptr(),
        R.data_ptr(), W, state.data_ptr(), bare_out.data_ptr(), kernels._stream()),
        "keto_shard_answer"), 20)
    _k10_row(rows, "shard_answer", K10A, "owned answers and their OR-combine over every shard, "
             "sharded.py:422-455, ONE launch; the popcount psum counted by the seeds and the "
             "run where they set the bits; ms is the kernel alone",
             answer, answer_plain, ([answer()], [answer_plain()]),
             launches["shard_answer"], _bound(rate, 1, ans_b), 20, ms=ans_ms,
             plain=time_ms(answer_plain, 2, warmup=1),
             extra={"timed_by": ans_how, "wrapper_ms": time_ms(answer, 20), "g": g, "B": B,
                    "SA_per_shard": SA, "sectors": gathers,
                    "frontier_bits_counted": pop_word, "frontier_bits_popcount_R": pop_r,
                    "bound_counts": "bytes in 32-byte sectors: a sector per distinct sector "
                                    "the owned gathers touch, ids and pairs once, the answer "
                                    "once; no read of R for the popcount",
                    "bound_4byte_ms": ans_old / rate * 1e3,
                    "bound_4byte_counts": "the parent's: 4 bytes a gather, and each shard's "
                                          "R slab read for the popcount"})
    if pop_word != pop_r:
        raise SystemExit(f"shard FAILED: the counted frontier bits {pop_word} are not "
                         f"popcount(R) {pop_r}")
    slabs = list(R.view(g, rps, W))
    G = torch.empty((g * rps, W), dtype=torch.int32, device="cuda")
    _k10_row(rows, "halo_copy", K10A, "lax.all_gather of the [rps, W] slabs, sharded.py:403: "
             "a phase of keto_check_run on the path, timed here as a copy_ per slab (one card, "
             "no interconnect)",
             lambda: ps.all_gather_rows(slabs, out=G), lambda: torch.cat(slabs),
             ([ps.all_gather_rows(slabs, out=G)], [torch.cat(slabs)]),
             launches["check_run_halo_copies"], _bound(rate, 1, 2 * g * slab), 20,
             library=lambda: torch.cat(slabs, out=G),
             extra={"bytes_moved_per_hop": g * slab, "run_halo_phase_ms": phases["halo_ms"],
                    "run_halo_phase_bound_ratio": phases["halo_ms"] / _bound(rate, 1, 2 * g * slab)[0],
                    "reference_halo_bytes_per_round": ps.halo_bytes_per_round(snap.shard_spec, W),
                    "launches_are": "halo phases of the runs on the shard phase's path "
                                    "(counted on the card)"},
             source="keto_tpu_torch/parallel/sharded.py")
    if sum(r["mismatches"] for r in rows):
        raise SystemExit("shard FAILED: K10a parity at config 3's shapes")
    return rows


def device_kernels(torch, fn) -> dict:
    """The device kernels one call of ``fn`` runs, by ``torch.profiler``:
    {kernel name: device µs}, or {"error": ...} where the profiler fails."""
    try:
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us and e.device_type == torch.autograd.DeviceType.CUDA:
                out[e.key[:120]] = us
        return out
    except Exception as e:  # noqa: BLE001 - a yardstick's breakdown, reported with the row
        return {"error": repr(e)[:200]}


def shard_label_rows(torch, ps, mesh, captured, launches, build_launches, rate,
                     int_rate, n) -> list:
    """K10b's and K10c's rows at config 4's shapes: the first label step of
    the 100k batch and the first sweep of the sharded label build (``n``
    interior rows, the gather sentinel)."""
    from keto_tpu_torch.graph import label_kernels as lk

    rows: list = []
    (m_, out_sh, in_sh, ent), kw = captured["label_step"]
    P, B, rl = kw["n_pairs"], kw["B"], kw["rl"]
    g, Wo, Wi = out_sh.shape[0], out_sh.shape[2], in_sh.shape[2]
    pa, pb = ent[:P], ent[P : 2 * P]
    full = lambda: ps.label_step_cuda(mesh, out_sh, in_sh, ent, **kw)  # noqa: E731
    plain = lambda: ps.label_step_ref(mesh, out_sh, in_sh, ent, **kw)  # noqa: E731
    # every pair row of the path lies in [0, g*rl); the pairs name each
    # stripe row many times over, and the function reads each named row once
    for r in (pa, pb):
        if not bool(((r >= 0) & (r < g * rl)).all()):
            raise SystemExit("shard FAILED: a label-route pair row outside [0, g*rl)")
    named = 4 * (torch.unique(pa).numel() * Wo + torch.unique(pb).numel() * Wi)
    # ms: whole calls back to back (CUDA events; the host's work between the
    # launches included, so it bounds this number where the kernels are
    # faster than it); device_ms: the same calls captured in one CUDA graph
    # and replayed, the step's device time alone
    device_ms, device_how = graph_ms(torch, full, 20)
    _k10_row(rows, "shard_label_step", K10B, "pair-row exchange and K3's compare",
             full, plain, ([full()], [plain()]), launches["label_step"],
             _bound(rate, int_rate, 12 * P + named + B // 8, P * Wo * Wi), 20,
             extra={"pairs": P, "Wo": Wo, "Wi": Wi, "rl": rl, "g": g, "named_row_bytes": named,
                    "device_ms": device_ms, "device_timed_by": device_how})

    def exchange(fn):
        return [fn(out_sh, pa, rl), fn(in_sh, pb, rl)]

    # one call over the flattened stripes computes the same function on rows
    # in [0, g*rl): index_select on the int32 words and on the same bytes as
    # complex128 (a fourth of the elements), and gather with the row index
    # expanded over the row; the fastest is the row's library call
    pa64, pb64 = pa.long(), pb.long()
    kernel_out = exchange(ps.pair_rows_cuda)

    def flat(dt):
        return out_sh.view(g * rl, Wo).view(dt), in_sh.view(g * rl, Wi).view(dt)

    def index_select(dt):
        fo, fi = flat(dt)
        return lambda: (torch.index_select(fo, 0, pa64), torch.index_select(fi, 0, pb64))

    def gather(dt):
        fo, fi = flat(dt)
        io, ii = pa64[:, None].expand(P, fo.shape[1]), pb64[:, None].expand(P, fi.shape[1])
        return lambda: (torch.gather(fo, 0, io), torch.gather(fi, 0, ii))

    calls = {"index_select int32": index_select(torch.int32)}
    if not (Wo % 4 or Wi % 4 or out_sh.storage_offset() % 4 or in_sh.storage_offset() % 4):
        calls["index_select complex128"] = index_select(torch.complex128)
        calls["gather complex128"] = gather(torch.complex128)
    else:
        calls["gather int32"] = gather(torch.int32)
    lib_ms = {}
    for name, call in calls.items():
        if any(diff(a.view(torch.int32), b)[0] for a, b in zip(call(), kernel_out)):
            raise SystemExit(f"shard FAILED: {name} differs from the pair-row exchange")
        lib_ms[name] = time_ms(call, 20)
    best = min(lib_ms, key=lib_ms.get)

    def contrib(lab_sh, rows_):
        out = []
        for s in range(g):
            local = rows_.long() - s * rl
            own = (local >= 0) & (local < rl)
            out.append(torch.where(own[:, None], lab_sh[s][local.clamp(0, rl - 1)],
                                   torch.zeros((), dtype=torch.int32, device="cuda")))
        return torch.stack(out)

    # both sides' bare launches in one CUDA graph: the kernels' device time
    # without the wrappers' host work between them
    klib = ps._lib()
    bare = [torch.empty_like(o) for o in kernel_out]

    def launch():
        for lab, r, o in ((out_sh, pa, bare[0]), (in_sh, pb, bare[1])):
            rc = klib.keto_pair_gather(lab.data_ptr(), rl, g, lab.shape[2], r.data_ptr(), P,
                                       o.data_ptr(), ps._stream())
            if rc:
                raise RuntimeError(f"keto_pair_gather failed: CUDA error {rc}")

    bare_ms, bare_how = graph_ms(torch, launch, 20)
    if any(diff(a, b)[0] for a, b in zip(bare, kernel_out)):
        raise SystemExit("shard FAILED: the bare pair-gather launches differ from the wrapper's")
    del bare

    co, ci = contrib(out_sh, pa), contrib(in_sh, pb)
    prev_ms = time_ms(lambda: (co.sum(0, dtype=torch.int32), ci.sum(0, dtype=torch.int32)), 20)
    del co, ci
    _k10_row(rows, "pair_rows", K10B, "the psum pair-row exchange, sharded.py:500-514 (both "
             "sides, one owner-gather launch each)", lambda: exchange(ps.pair_rows_cuda),
             lambda: exchange(ps.pair_rows_ref),
             (exchange(ps.pair_rows_cuda), exchange(ps.pair_rows_ref)), launches["pair_rows"],
             _bound(rate, 1, 8 * P + named + 4 * P * (Wo + Wi)), 20, library=calls[best],
             extra={"pairs": P, "named_row_bytes": named, "bare_graph_ms": bare_ms,
                    "bare_timed_by": bare_how,
                    "library": f"torch.{best} over the flattened [g*rl, w] stripes, per side, "
                               "int64 indices made beforehand (the fastest of library_calls_ms)",
                    "library_calls_ms": lib_ms,
                    "library_index_select_kernels": device_kernels(torch, calls["index_select int32"]),
                    "library_prev": {"call": "torch.stack(...).sum(0) of ready per-shard rows",
                                     "ms": prev_ms}})

    # K10c: the sharded build's first sweep, the whole run, every shard in
    # the one launch with the halo copy between waves
    (m_, groups, X0, cov), kw = captured["label_sweep"]
    rps, wt = kw["rps"], X0.shape[1]
    prune = kw.get("prune_expansion", True)
    n_rows, n_slots = groups.n_rows, int(groups.slots.numel())
    # a wave's bytes as the single-device wave's: every dst index, the slots
    # of the rows the routing keeps (its padding rows, dst = rps, are
    # skipped before their slots are read), one X row per distinct source,
    # V, S, cov and X' once per kept dst word; the halo copy of every slab
    # (read once, written once) runs between two waves only
    kept = [int(((d >= 0) & (d < rps)).sum()) for d in
            (groups.group(i)[1] for i in range(len(groups.rows)))]
    kept_rows, kept_slots = sum(kept), sum(k * c for k, c in zip(kept, groups.caps))
    srcs = int((torch.unique(groups.slots) < n).sum())
    wave_bytes = 4 * (kept_slots + n_rows + wt * (srcs + 5 * kept_rows))
    halo_bytes = 2 * g * rps * wt * 4

    def run(fn, budget):
        if fn is lk.sweep_cuda:
            return ps.label_sweep(mesh, groups, X0, cov, rps=rps, prune_expansion=prune,
                                  budget=budget)
        return fn(groups, X0, cov, n_dst=rps, shards=g, prune_expansion=prune, budget=budget)

    rows.append(sweep_row(torch, "shard_label_sweep", K10C, "one orientation's whole sharded "
                          "sweep: per wave the halo copy of the slabs and every shard's K6 wave "
                          "(sharded.py:559-628 to the fixpoint)", run,
                          lambda st: lk.sweep_launch(lk._lib(), groups, st, cov, n_dst=rps,
                                                     halo=True, prune_expansion=prune,
                                                     budget=None, stream=lk._stream()),
                          X0, build_launches, wave_bytes, halo_bytes, rate,
                          {"rows": n_rows, "slots": n_slots, "groups": len(groups.rows),
                           "wt": wt, "rps": rps, "g": g, "kept_rows": kept_rows,
                           "kept_slots": kept_slots, "distinct_source_rows": srcs}))
    if sum(r["mismatches"] for r in rows):
        raise SystemExit("shard FAILED: K10b/K10c parity at config 4's shapes")
    return rows


# -- phase 8: list, reverse queries on the deep phase's engine and store -----------


class PinnedEngine:
    """A check-engine stand-in that serves one snapshot: the host lister
    runs on it (a copy with ``lst_dirty`` set routes every listing to
    ``_fixpoint_host``), over exactly the snapshot the card answered on."""

    def __init__(self, snap, store):
        self._snap = snap
        self._store = store

    def snapshot(self, at_least=None):
        return self._snap

    def snapshot_serving(self):
        return self._snap


def host_lister(snap, store, device="cuda"):
    import dataclasses
    import threading

    from keto_tpu_torch.list.gpu_engine import SnapshotListEngine

    dirty = dataclasses.replace(snap, lst_dirty=True, device_list=None, _pattern_cache={},
                                _cache_lock=threading.Lock())
    return SnapshotListEngine(PinnedEngine(dirty, store), store.namespaces, device=device)


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def phase_list(torch, kernels, report, engine, store, ctx, device="cuda"):
    """ListObjects and ListSubjects at config 4 (see the module docstring).
    Returns the list engine, the captured fixpoint inputs and the launches."""
    from keto_tpu_torch.list import gpu_engine
    from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
    from keto_tpu_torch.relationtuple.model import RelationTuple
    from keto_tpu_torch.workloads import github_list_queries

    rng = random.Random(SEED + 5)
    objects, subjects = github_list_queries(rng, LIST_QUERIES, ctx)
    # cache misses only: each query once
    objects = list({str(s): (s, w) for s, w in objects}.values())
    subjects = list({o: (o, w) for o, w in subjects}.values())
    lst = SnapshotListEngine(engine, store.namespaces, device=device)
    captured = []
    step = gpu_engine.list_step

    def capture(buckets, R0, ov_nbrs, ov_dst, **kw):
        if not captured:
            captured.append((buckets, R0.clone(), ov_nbrs, ov_dst, kw))
        return step(buckets, R0, ov_nbrs, ov_dst, **kw)

    kernels.reset_counts()
    gpu_engine.list_step = capture
    out: dict = {}
    try:
        for op, qs in (("objects", objects), ("subjects", subjects)):
            lat, items, bad, tokens = [], 0, 0, set()
            for q, want in qs:
                t0 = time.monotonic()
                if op == "objects":
                    got, tok = lst.list_objects("issues", "view", q)
                else:
                    got, tok = lst.list_subjects("issues", q, "view")
                lat.append(time.monotonic() - t0)
                items += len(got)
                bad += len(set(got) ^ set(want))
                tokens.add(tok)
            out[op] = {"listings": len(qs), "items": items, "mean_items": items / len(qs),
                       "p50_s": _pct(lat, 0.5), "p99_s": _pct(lat, 0.99), "max_s": max(lat),
                       "items_per_s": items / sum(lat), "wrong_items_vs_analytic": bad,
                       "snaptokens": sorted(tokens)}
            log(f"list {op}: {json.dumps(out[op])}")
            if bad:
                raise SystemExit(f"list FAILED: {bad} {op} differ from the analytic sets")
    finally:
        gpu_engine.list_step = step
    launches = dict(kernels.COUNTS)
    routes = {f"{op}/{path}": n for (op, path), n in sorted(lst.requests_total.items())}
    out.update({"routes": routes, "device_errors": lst.device_errors,
                "k5_runs": launches["list_fixpoint"], "k5_steps": launches["list_iters"],
                "upload_s": dict(lst.upload_seconds), "launches": launches})
    log(f"list routes {routes}, K5 runs {launches['list_fixpoint']} ({launches['list_iters']} steps), "
        f"upload seconds {lst.upload_seconds}, launches {launches}")
    if (routes.get("objects/device") != len(objects) or routes.get("subjects/device") != len(subjects)
            or any(k.endswith("/host") for k in routes)):
        raise SystemExit(f"list FAILED: every listing must take the device route: {routes}")
    if device == "cuda" and not launches["list_fixpoint"]:
        raise SystemExit(f"list FAILED: K5 never launched: {launches}")

    # the host lister on the same snapshot, the oracle, and Check
    snap = engine.snapshot()
    host = host_lister(snap, store, device)
    t0 = time.monotonic()
    hbad = sum(len(set(lst.list_objects("issues", "view", q)[0])
                   ^ set(host.list_objects("issues", "view", q)[0]))
               for q, _ in objects[:LIST_HOST_SAMPLE])
    hbad += sum(len(set(lst.list_subjects("issues", o, "view")[0])
                    ^ set(host.list_subjects("issues", o, "view")[0]))
                for o, _ in subjects[:LIST_HOST_SAMPLE])
    host_s = time.monotonic() - t0
    obad = sum(len(set(w) ^ set(lst.oracle.list_subjects("issues", o, "view")))
               for o, w in subjects[:LIST_ORACLE_SAMPLE])
    n_issues = len(ctx["issue_repo"])
    cq, cwant = [], []
    for q, want in objects[:LIST_CHECK_SAMPLE]:
        listed = set(want)
        cq += [RelationTuple("issues", o, "view", q) for o in want]
        cwant += [True] * len(want)
        others = set()
        while len(others) < len(want):
            o = f"issue-{rng.randrange(n_issues)}"
            if o not in listed:
                others.add(o)
        cq += [RelationTuple("issues", o, "view", q) for o in sorted(others)]
        cwant += [False] * len(others)
    cgot = engine.batch_check(cq)
    cbad = sum(g != w for g, w in zip(cgot, cwant))
    cross = {"host_lister_sample": 2 * LIST_HOST_SAMPLE, "host_lister_differ": hbad,
             "host_lister_s": host_s, "host_routes": {f"{o}/{p}": n for (o, p), n in
                                                     host.requests_total.items()},
             "oracle_sample": LIST_ORACLE_SAMPLE, "oracle_differ": obad,
             "check_sample": len(cq), "check_differ": cbad}
    out["cross_checks"] = cross
    log(f"list cross-checks: {json.dumps(cross)}")
    if hbad or obad or cbad or host.requests_total.get(("objects", "host"), 0) != LIST_HOST_SAMPLE:
        raise SystemExit(f"list FAILED: cross-checks {cross}")
    report["list"] = out
    return lst, captured, launches


# -- phase 9: explain, the stream and decision provenance on deep's engine -------

#: the explain phase: explains of denies, of label-route grants, and at most
#: this many grants the router sends to the hybrid route
EXPLAIN_DENIES = 50
EXPLAIN_GRANTS = 150
EXPLAIN_HYBRID = 50
#: K4's batch row: random interior pairs on config 4's label arrays
WITNESS_BATCH = 65_536
#: the hybrid stream: checks, every fourth a wildcard-relation check, at a
#: pinned slice width
HYBRID_CHECKS = 8192
HYBRID_SLICE = 1024
#: the long stream: the 100k checks this many times over, more than the
#: first window of 16 slices at the controller's starting width holds
LONG_REPEATS = 10


def _spans(torch, kernels, names):
    """Wrap the named kernel dispatchers so every call is bracketed by CUDA
    events on the current stream; returns (the spans, a restore function).
    A span runs from a call's first kernel to its last."""
    spans, saved = [], {n: getattr(kernels, n) for n in names}

    def wrap(fn):
        def timed(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans.append((start, end))
            return out
        return timed

    for n, fn in saved.items():
        setattr(kernels, n, wrap(fn))

    def restore():
        for n, fn in saved.items():
            setattr(kernels, n, fn)

    return spans, restore


def phase_explain(torch, kernels, report, engine, store, queries, expected, ctx, device="cuda"):
    """The streaming pipeline and GET /check/explain's engine at config 4
    (see the module docstring). Returns what K4's rows need."""
    import numpy as np

    from keto_tpu_torch.explain import ExplainEngine
    from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectSet

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n = len(queries)
    out: dict = {}

    # (1) the stream against the batch path on the same snapshot
    t0 = time.monotonic()
    batch = engine.batch_check(queries)
    sync()
    batch_s = time.monotonic() - t0
    if batch != expected:
        raise SystemExit("explain FAILED: batch_check differs from the expectation")
    kernels.reset_counts()
    engine.reset_route_stats()
    engine.stream_slice_stats.reset()
    spans, restore = _spans(torch, kernels, ("check_step", "label_step")) if cuda else ([], None)
    try:
        t0 = time.monotonic()
        ordered = np.concatenate(list(engine.batch_check_stream(queries))).tolist()
        sync()
        ordered_s = time.monotonic() - t0
        busy_ms = sum(a.elapsed_time(b) for a, b in spans)
        spans.clear()
        seen = np.zeros(n, np.int64)
        unordered = np.zeros(n, bool)
        infos = []
        t0 = time.monotonic()
        gen, token = engine.batch_check_stream_with_token(queries, ordered=False, with_info=True)
        for off, dec, info in gen:
            seen[off : off + len(dec)] += 1
            unordered[off : off + len(dec)] = dec
            infos.append(info)
        sync()
        unordered_s = time.monotonic() - t0
        busy2_ms = sum(a.elapsed_time(b) for a, b in spans)
    finally:
        if restore is not None:
            restore()
    launches = dict(kernels.COUNTS)
    by_route: dict = {}
    for info in infos:
        r = by_route.setdefault(info["route"], {"slices": 0, "queries": 0})
        r["slices"] += 1
        r["queries"] += info["width"]
    stream = {
        "checks": n, "batch_s": batch_s, "batch_checks_per_s": n / batch_s,
        "ordered_s": ordered_s, "ordered_checks_per_s": n / ordered_s,
        "unordered_s": unordered_s, "unordered_checks_per_s": n / unordered_s,
        "ordered_wrong": sum(a != b for a, b in zip(ordered, expected)),
        "unordered_wrong": int(sum(bool(a) != b for a, b in zip(unordered, expected))),
        "offsets_not_once": int((seen != 1).sum()), "snaptoken": token,
        "unordered_slices_by_route": by_route, "route_snapshot": engine.stream_route_snapshot(),
        "slice_stats": engine.stream_slice_stats.snapshot(),
        "bfs_steps": engine.bfs_steps_stats.snapshot(), "final_cap": engine.stream_ctrl.cap(),
        "controller": engine.stream_ctrl.snapshot(),
        "device_busy_share_ordered": busy_ms / 1e3 / ordered_s if cuda else None,
        "device_busy_share_unordered": busy2_ms / 1e3 / unordered_s if cuda else None,
        "launches": launches, "staging": engine.staging_snapshot(),
    }
    log(f"explain stream: {json.dumps(stream)}")
    if stream["ordered_wrong"] or stream["unordered_wrong"] or stream["offsets_not_once"]:
        raise SystemExit(f"explain FAILED: the stream differs from batch_check: {stream}")
    if stream["staging"]["leased"]:
        raise SystemExit("explain FAILED: a staging lease outlived its slice")
    out["stream"] = stream
    out["hybrid_stream"] = hybrid_stream(engine, queries, expected, ctx)
    out["long_stream"] = long_stream(engine, queries, expected, sync)

    # (2) 200 explains: denies, label-route grants, hybrid-route grants
    rng = random.Random(SEED + 7)
    snap = engine.snapshot()
    idx = snap.labels
    ex = ExplainEngine(engine, store)
    denies = [queries[i] for i in range(n) if not expected[i]][: 40 * EXPLAIN_DENIES : 40]
    grants = [queries[i] for i in range(n) if expected[i]]
    # interior → interior grants (a team's ancestor, a root team's org)
    inner = []
    teams = sorted(ctx["team_users"])
    while len(inner) < 2 * EXPLAIN_GRANTS:
        t = rng.choice(teams)
        chain, root = ctx["ancestors"](t)
        sub = SubjectSet("teams", f"team-{t}", "member")
        if len(chain) > 1 and rng.random() < 0.6:
            a = rng.choice(sorted(chain - {t}))
            inner.append(RelationTuple("teams", f"team-{a}", "member", sub))
        else:
            inner.append(RelationTuple("orgs", f"org-{ctx['root_org'][root]}", "member", sub))
    t0 = time.monotonic()
    label_inner, label_sink, hybrid = [], [], []
    for q in inner + grants[: 8 * EXPLAIN_GRANTS]:
        allowed, route, _ = ex.decide_with(engine, store, q, None)
        if not allowed:
            raise SystemExit(f"explain FAILED: the grant {q} was denied")
        if route == "hybrid" and len(hybrid) < EXPLAIN_HYBRID:
            hybrid.append(q)
        elif route == "label":
            (label_inner if q.namespace in ("teams", "orgs") else label_sink).append(q)
    classify_s = time.monotonic() - t0
    # two thirds interior pairs (they carry a landmark), the rest grants of
    # the 100k batch (a sink target: no single interior pair)
    n_label = EXPLAIN_GRANTS - len(hybrid)
    k = min(len(label_inner), (2 * n_label) // 3)
    label = label_inner[:k] + label_sink[: n_label - k]
    label += label_inner[k : k + n_label - len(label)]
    picked = [(q, False, "deny") for q in denies] + [(q, True, "label") for q in label] + \
             [(q, True, "hybrid") for q in hybrid]
    kernels.reset_counts()
    lat, bad, k4_pairs, k4_launched, routes, lm_found = [], [], [], 0, {}, 0
    for q, want, kind in picked:
        before = kernels.COUNTS["label_witness"]
        t0 = time.monotonic()
        resp = ex.explain(q)
        lat.append(time.monotonic() - t0)
        k4 = kernels.COUNTS["label_witness"] - before
        routes[resp["route"]] = routes.get(resp["route"], 0) + 1
        problems = []
        if resp["allowed"] != want or resp.get("decision_divergence"):
            problems.append("decision")
        if want and not (resp["verified"] and resp["witness_source"] == "backtrace"):
            problems.append("witness")
        if not want and (resp["certificate"] or {}).get("type") != "frontier-exhaustion":
            problems.append("certificate")
        if want and resp["route"] in ("label", "hybrid"):
            # the host index's answer for the same pair; None where the query
            # has no single interior pair
            sd, tg, multi = engine._resolve_bulk(snap, [q])
            a, b = int(sd[0]), int(tg[0])
            pair = 0 not in multi and 0 <= a < snap.num_int and 0 <= b < snap.num_int
            host_lm = idx.witness_landmark(a, b) if pair else None
            got_lm = (resp.get("landmark") or {}).get("landmark_dev")
            if got_lm != host_lm or k4 != (1 if pair and cuda else 0):
                problems.append(f"landmark {got_lm} vs host {host_lm}, K4 launches {k4}")
            if pair:
                k4_pairs.append((a, b))
                k4_launched += k4
            lm_found += got_lm is not None
        elif k4:
            problems.append(f"K4 launched {k4} times for a {resp['route']} {kind}")
        if problems:
            bad.append((str(q), kind, problems, resp))
    explain = {
        "explains": len(picked), "denies": len(denies), "label_grants": len(label),
        "label_grants_interior": sum(q.namespace in ("teams", "orgs") for q in label),
        "hybrid_grants": len(hybrid), "hybrid_candidates_found": len(hybrid),
        "classified": len(inner) + min(len(grants), 8 * EXPLAIN_GRANTS),
        "classify_s": classify_s, "routes": routes, "landmarks": lm_found,
        "k4_launches": kernels.COUNTS["label_witness"], "k4_pairs": len(k4_pairs),
        "verify_failures": ex.verify_failures, "requests_by_route": dict(ex.requests_by_route),
        "p50_s": _pct(lat, 0.5), "p99_s": _pct(lat, 0.99), "max_s": max(lat),
        "total_s": sum(lat), "bad": bad[:5],
    }
    log(f"explain: {json.dumps(explain)}")
    if bad or ex.verify_failures or len(denies) != EXPLAIN_DENIES or \
            len(label) + len(hybrid) != EXPLAIN_GRANTS:
        raise SystemExit(f"explain FAILED: {len(bad)} explains wrong: {bad[:3]}")
    if cuda and (not k4_launched or k4_launched != len(k4_pairs) or lm_found < 50):
        raise SystemExit(f"explain FAILED: K4 launches {k4_launched} for {len(k4_pairs)} pairs, "
                         f"{lm_found} landmarks")
    out["explain"] = explain
    report["explain"] = out
    return k4_pairs, kernels.COUNTS["label_witness"]


def graph_ms(torch, launch, n: int, reps: int = 10):
    """Mean device time of one ``launch()`` from a CUDA graph of ``n``
    captured launches, replayed ``reps`` times: no host work between the
    kernels, so a kernel shorter than its launch overhead is still timed.
    Returns (ms, how): a launch loop timed by events where the capture
    fails."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            launch()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                launch()
        g.replay()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - reported with the row
        torch.cuda.synchronize()
        log(f"graph capture failed ({e!r}); timing a launch loop")
        return time_ms(launch, n), "launch_loop"
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n), "cuda_graph"


def hybrid_queries(queries, expected, ctx):
    """``HYBRID_CHECKS`` label-route checks with every fourth replaced by a
    wildcard-relation check ("may user u do anything on repo r?", two
    starts, never label-certifiable), and their expected decisions."""
    from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID

    rng = random.Random(SEED + 9)

    def member_of(grant):
        kind, x = grant
        if kind == "org":
            roots = ctx["org_roots"][x]
            if not roots:
                return None
            x = rng.choice(roots)
        users = ctx["team_users"].get(x)
        return rng.choice(users) if users else None

    qs, want = [], []
    for i in range(HYBRID_CHECKS):
        if i % 4 != 3:
            qs.append(queries[i])
            want.append(expected[i])
            continue
        r = rng.randrange(len(ctx["repo_reader"]))
        grants = (ctx["repo_reader"][r], ctx["repo_maint"][r])
        u = member_of(rng.choice(grants)) if rng.random() < 0.5 else None
        if u is None:
            u = rng.randrange(ctx["n_users"])
        qs.append(RelationTuple("repos", f"repo-{r}", "", SubjectID(f"user-{u}")))
        want.append(any(ctx["grant_ok"](u, g) for g in grants))
    return qs, want


def hybrid_stream(engine, queries, expected, ctx) -> dict:
    """Label-route checks with wildcard-relation checks among them, streamed
    at a pinned width: every slice must land on the hybrid route, equal to
    ``batch_check`` and the expectation."""
    import numpy as np

    qs, want = hybrid_queries(queries, expected, ctx)
    batch = engine.batch_check(qs)
    engine.reset_route_stats()
    fb0 = engine.counters().get("label_fallbacks", 0)
    got = np.zeros(len(qs), bool)
    seen = np.zeros(len(qs), np.int64)
    routes: dict = {}
    t0 = time.monotonic()
    gen, _ = engine.batch_check_stream_with_token(qs, ordered=False, with_info=True,
                                                  slice_cap=HYBRID_SLICE)
    for off, dec, info in gen:
        got[off : off + len(dec)] = dec
        seen[off : off + len(dec)] += 1
        routes[info["route"]] = routes.get(info["route"], 0) + 1
    res = {
        "checks": len(qs), "wildcard_checks": HYBRID_CHECKS // 4, "slice_cap": HYBRID_SLICE,
        "grants": int(sum(want)), "wildcard_grants": int(sum(want[3::4])),
        "stream_s": time.monotonic() - t0, "slices_by_route": routes,
        "route_snapshot": engine.stream_route_snapshot(),
        "label_fallbacks": engine.counters().get("label_fallbacks", 0) - fb0,
        "batch_wrong": int(sum(a != b for a, b in zip(batch, want))),
        "stream_wrong": int(sum(bool(a) != b for a, b in zip(got, want))),
        "offsets_not_once": int((seen != 1).sum()), "staging": engine.staging_snapshot(),
    }
    log(f"explain hybrid stream: {json.dumps(res)}")
    if res["batch_wrong"] or res["stream_wrong"] or res["offsets_not_once"] or \
            set(routes) != {"hybrid"} or res["staging"]["leased"]:
        raise SystemExit(f"explain FAILED: the hybrid stream {res}")
    return res


def long_stream(engine, queries, expected, sync) -> dict:
    """The 100k checks LONG_REPEATS times over in one unordered stream, on a
    fresh controller (a server's first stream starts there), with its
    ``cap()`` read after every landed slice and recorded wherever the
    stream asks it for the width of the next batch it takes: the first
    window of slices goes out at the starting width, and the slices that
    land then set the widths of those dispatched after."""
    import itertools

    import numpy as np

    from keto_tpu_torch.check.stream import StreamSliceController

    n = len(queries)
    want = np.asarray(expected, bool)
    ctrl = engine.stream_ctrl = StreamSliceController()
    cap0 = ctrl.cap()
    read_cap, taken = ctrl.cap, []
    ctrl.cap = lambda: taken.append(read_cap()) or taken[-1]
    splits0 = engine.counters().get("slice_splits", 0)
    engine.stream_slice_stats.reset()
    engine.reset_route_stats()
    widths: dict = {}
    caps = [cap0]
    wrong = 0
    t0 = time.monotonic()
    gen, _ = engine.batch_check_stream_with_token(
        itertools.chain.from_iterable([queries] * LONG_REPEATS), ordered=False, with_info=True)
    for off, dec, info in gen:
        if off in widths:
            raise SystemExit(f"explain FAILED: the long stream landed offset {off} twice")
        widths[off] = len(dec)
        wrong += int((np.asarray(dec, bool) != want[(off + np.arange(len(dec))) % n]).sum())
        caps.append(read_cap())
    sync()
    del ctrl.cap
    wall = time.monotonic() - t0
    order = [widths[k] for k in sorted(widths)]
    covered = sum(order) == n * LONG_REPEATS and \
        all(a + widths[a] == b for a, b in zip(sorted(widths), sorted(widths)[1:]))
    res = {
        "checks": n * LONG_REPEATS, "wall_s": wall, "checks_per_s": n * LONG_REPEATS / wall,
        "slices": len(order), "start_cap": cap0, "final_cap": read_cap(),
        "batch_caps": {str(c): taken.count(c) for c in sorted(set(taken))},
        "entry_budget": ctrl.entry_budget(),
        "caps_seen": sorted(set(caps)), "cap_changes": sum(a != b for a, b in zip(caps, caps[1:])),
        "widths": {str(w): order.count(w) for w in sorted(set(order))},
        "first_widths": order[:20], "last_widths": order[-20:],
        "slice_splits": engine.counters().get("slice_splits", 0) - splits0,
        "slice_stats": engine.stream_slice_stats.snapshot(),
        "route_snapshot": engine.stream_route_snapshot(), "controller": ctrl.snapshot(),
        "wrong": wrong, "covered": covered, "staging": engine.staging_snapshot(),
    }
    log(f"explain long stream: {json.dumps(res)}")
    if wrong or not covered or res["staging"]["leased"]:
        raise SystemExit(f"explain FAILED: the long stream {res}")
    if len(res["caps_seen"]) < 2:
        raise SystemExit(f"explain FAILED: the controller's cap never moved in {len(order)} slices")
    return res


def witness_rows(torch, kernels, snap, pairs, launches, rate, int_rate):
    """K4 at the explain path's shape (one pair, the first explained) and at
    a 65,536-pair batch of random interior pairs on config 4's label
    arrays, each beside its plain version and bound. ``ms`` is the kernel's
    device time: bare ``keto_label_witness`` launches captured in one CUDA
    graph (``timed_by``), inputs and output already on the card;
    ``wrapper_ms`` is the whole ``label_step_witness_cuda`` call (checks,
    the output allocation, the ctypes launch), timed back to back. No single
    PyTorch call computes it (library_ms null)."""
    import numpy as np

    out_lab, in_lab = snap.device_labels
    Wo, Wi = int(out_lab.shape[1]), int(in_lab.shape[1])
    n_out = (out_lab != -1).sum(1)
    n_in = (in_lab != -2).sum(1)
    rng = np.random.default_rng(SEED + 8)
    batch = rng.integers(0, snap.num_int, size=(2, WITNESS_BATCH)).astype(np.int32)
    lib = kernels._lib()
    rows = []
    for name, pa_np, pb_np, n_graph in (
        ("label_witness", np.array([pairs[0][0]], np.int32), np.array([pairs[0][1]], np.int32), 500),
        ("label_witness_batch", batch[0], batch[1], 20),
    ):
        pa, pb = (torch.from_numpy(x).cuda() for x in (pa_np, pb_np))
        P = int(pa.numel())
        got = kernels.label_step_witness_cuda(out_lab, in_lab, pa, pb)
        want = kernels.label_step_witness_ref(out_lab, in_lab, pa, pb)
        torch.cuda.synchronize()
        m, err = diff(got, want)
        bare = torch.full((P,), -3, dtype=torch.int32, device="cuda")

        def launch():
            _ok(kernels.label_witness_launch(lib, out_lab, in_lab, pa, pb, bare,
                                             kernels._stream()), "keto_label_witness")

        ms, timed_by = graph_ms(torch, launch, n_graph)
        m_bare = diff(bare, want)[0]
        wrapper = time_ms(lambda: kernels.label_step_witness_cuda(out_lab, in_lab, pa, pb),
                          10 * n_graph)
        plain = time_ms(lambda: kernels.label_step_witness_ref(out_lab, in_lab, pa, pb),
                        max(1, n_graph // 50), warmup=1)
        # each input read once: the distinct rows the pairs name, the pair
        # rows, the output; the compares these rows' valid entries need
        k4_bytes = 4 * (int(torch.unique(pa).numel()) * Wo + int(torch.unique(pb).numel()) * Wi) \
            + 12 * P
        compares = int((n_out[pa.long()] * n_in[pb.long()]).sum())
        by_bytes, by_ops = k4_bytes / rate * 1e3, compares / int_rate * 1e3
        # the bound over every slot of every pair, pads included: P·(Wo+Wi)·4
        # + 12·P bytes against P·Wo·Wi compares
        slot_bytes, slot_ops = (P * (Wo + Wi) * 4 + 12 * P) / rate * 1e3, P * Wo * Wi / int_rate * 1e3
        r = {"name": name, "route": "cuda", "source": "keto_tpu_torch/csrc/label_kernels.cu",
             "replaces": K4, "launches": launches, "mismatches": m, "max_abs_err": err,
             "ms": ms, "plain_ms": plain, "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations", "library_ms": None,
             "wrapper_ms": wrapper, "timed_by": timed_by, "graph_launches": n_graph,
             "bare_mismatches": m_bare, "pairs": P, "Wo": Wo, "Wi": Wi,
             "valid_compares": compares, "bytes_bound_ms": by_bytes, "ops_bound_ms": by_ops,
             "every_slot_bound_ms": max(slot_bytes, slot_ops),
             "landmarks_found": int((want >= 0).sum())}
        rows.append(r)
        log(f"kernel {name}: {ms:.5f} ms by {timed_by} (wrapper {wrapper:.4f} ms, plain "
            f"{plain:.4f} ms, bound {r['bound_ms']:.6f} ms by {r['bound_by']}), P={P}, "
            f"mismatches {m}, bare launches {m_bare}")
        if m or m_bare:
            raise SystemExit(f"{name} parity at config 4's shapes FAILED: {m} mismatching words, "
                             f"{m_bare} from the bare launches")
    return rows


# -- phase 10: write, on the deep phase's engine and store ------------------------

MAINT = ("delta_applies", "overlay_device_applies", "full_rebuilds", "compactions", "fold_runs",
         "label_patches", "label_patch_aborts", "label_rebuilds", "label_invalidations",
         "label_checks", "label_fallbacks", "label_builds", "label_device_builds",
         "refresh_failures", "compaction_failures", "label_patch_failures")


def maint_counts(engine) -> dict:
    c = engine.counters()
    return {k: c.get(k, 0) for k in MAINT}


def phase_write(torch, kernels, report, engine, store, queries, lst, ctx, device="cuda"):
    """The write path at config 4 (see the module docstring), with the list
    engine's listings after each step. Returns the captured slot sets for
    K9's kernel row and K9's launches."""
    import numpy as np

    from keto_tpu_torch.list import gpu_engine
    from keto_tpu_torch.list.gpu_engine import SnapshotListEngine

    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine

    from keto_tpu_torch.check.engine import CheckEngine
    from keto_tpu_torch.explain import ExplainEngine
    from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

    from keto_tpu_torch.persistence.memory import _DeferredRows

    if isinstance(store._row_list, _DeferredRows):
        raise SystemExit("write FAILED: the store's rows are still parked; the burst's store_s "
                         "would pay their materialization")
    rng = random.Random(SEED + 6)
    oracle = CheckEngine(store)
    out: dict = {"steps": {}}
    # every slot set call of the write path (one launch each on the card),
    # tagged by its site (the bucket patch runs inside _apply_ell_patch; the
    # mirror writes in place; the rest are the resident overlay's rows and
    # dst), with its targets
    captured: list = []
    sites = {"ell_patch": 0, "overlay": 0, "mirror": 0, "list": 0}
    in_patch, in_list = [False], [False]
    slot_set, apply_patch = kernels.slot_set_many, engine._apply_ell_patch
    ensure_list, list_step = lst._ensure_device, gpu_engine.list_step
    # the first K5 run with the overlay pending, for K5's overlay row
    ov_cap: list = [None]

    def capture(targets, *, in_place=False):
        site = ("list" if in_list[0] else "mirror" if in_place
                else "ell_patch" if in_patch[0] else "overlay")
        targets = [(buf, np.asarray(rows), None if cols is None else np.asarray(cols),
                    np.asarray(vals)) for buf, rows, cols, vals in targets]
        if targets:
            sites[site] += 1
            captured.append((site, targets))
        return slot_set(targets, in_place=in_place)

    def step_capture(buckets, R0, ov_nbrs, ov_dst, **kw):
        if ov_cap[0] is None and ov_nbrs is not None and ov_nbrs.shape[0]:
            ov_cap[0] = (buckets, R0.clone(), ov_nbrs, ov_dst, kw)
        return list_step(buckets, R0, ov_nbrs, ov_dst, **kw)

    def patch(snap):
        in_patch[0] = True
        try:
            apply_patch(snap)
        finally:
            in_patch[0] = False

    def ensure(snap, orient):
        in_list[0] = True
        try:
            return ensure_list(snap, orient)
        finally:
            in_list[0] = False

    def issues_of(teams, k):
        """Up to ``k`` issues whose repos grant their reader set to one of
        ``teams``."""
        out = sorted({f"issue-{j}" for t in teams for r in ctx["reader_repos"].get(("team", t), ())
                      for j in ctx["issues_by_repo"].get(r, ())})
        return out if len(out) <= k else rng.sample(out, k)

    def list_round(name, users, issues):
        """Listings for what the step touched, on the card through the
        engine's lister, each held against the host lister on the snapshot
        of the same watermark."""
        before = dict(kernels.COUNTS)
        t0 = time.monotonic()
        dev_o = [lst.list_objects("issues", "view", SubjectID(u), latest=True) for u in users]
        dev_s = [lst.list_subjects("issues", i, "view", latest=True) for i in issues]
        dt = time.monotonic() - t0
        snap = engine.snapshot()
        host = host_lister(snap, store, device)
        bad = sum(len(set(g) ^ set(host.list_objects("issues", "view", SubjectID(u))[0]))
                  for u, (g, _) in zip(users, dev_o))
        bad += sum(len(set(g) ^ set(host.list_subjects("issues", i, "view")[0]))
                   for i, (g, _) in zip(issues, dev_s))
        tokens = {t for _, t in dev_o + dev_s}
        r = {"objects": len(users), "subjects": len(issues), "seconds": dt,
             "items": sum(len(g) for g, _ in dev_o + dev_s), "host_differ": bad,
             "snaptokens": sorted(tokens), "host_snapshot": int(snap.snapshot_id),
             "lst_ov_edges": len(snap.lst_ov_edges or ()), "lst_patch": len(snap.lst_patch or ()),
             "lst_dirty": snap.lst_dirty,
             "k5_overlay_runs": (kernels.COUNTS["list_fixpoint_overlay"]
                                 - before["list_fixpoint_overlay"]),
             "k5_runs": kernels.COUNTS["list_fixpoint"] - before["list_fixpoint"]}
        log(f"write {name} listings: {json.dumps(r)}")
        if bad or tokens != {snap.snapshot_id}:
            raise SystemExit(f"write FAILED: step {name}: listings differ from the host lister: {r}")
        return r, [g for g, _ in dev_o], [g for g, _ in dev_s]

    def lists_cleared(name):
        snap = engine.snapshot()
        if not snap.has_overlay and (snap.lst_ov_edges or snap.lst_patch or snap.lst_dirty):
            raise SystemExit(f"write FAILED: the fold after {name} left lst_* behind")
        return {"overlay_left": snap.has_overlay, "lst_cleared": not (
            snap.lst_ov_edges or snap.lst_patch or snap.lst_dirty)}

    def visible_s(wm) -> float:
        t0 = time.monotonic()
        while engine.snapshot_serving().snapshot_id < wm:
            if time.monotonic() - t0 > 600:
                raise SystemExit("write FAILED: the serving snapshot never reached the write")
            time.sleep(0.002)
        return time.monotonic() - t0

    def check_round(name, touched):
        """The 100k batch and the oracle sample after one step."""
        before = maint_counts(engine)
        ov = engine.snapshot().has_overlay
        t0 = time.monotonic()
        got = engine.batch_check(queries)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.monotonic() - t0
        after = maint_counts(engine)
        half = WRITE_ORACLE_SAMPLE // 2
        users = [f"user-{rng.randrange(800_000)}" for _ in range(half)]
        sample = [RelationTuple("teams", f"team-{t}", "member", SubjectID(u))
                  for t, u in zip(rng.choices(touched, k=half), users)]
        sample += [queries[i] for i in rng.sample(range(len(queries)), WRITE_ORACLE_SAMPLE - half)]
        mine = engine.batch_check(sample)
        t1 = time.monotonic()
        bad = sum(oracle.subject_is_allowed(q) != g for q, g in zip(sample, mine))
        r = {"overlay_pending": ov, "checks_s": dt, "checks_per_s": len(queries) / dt,
             "label_checks": after["label_checks"] - before["label_checks"],
             "label_fallbacks": after["label_fallbacks"] - before["label_fallbacks"],
             "label_invalidations": after["label_invalidations"] - before["label_invalidations"],
             "oracle_sample": len(sample), "oracle_mismatches": bad,
             "oracle_s": time.monotonic() - t1, "grants": sum(got)}
        log(f"write {name} checks: {json.dumps(r)}")
        if bad:
            raise SystemExit(f"write FAILED: step {name}: {bad} oracle mismatches")
        return r, got

    def settle(name, fold):
        t0 = time.monotonic()
        snap = engine.maintenance_settled(fold=fold, timeout=900)
        r = {"settle_s": time.monotonic() - t0, "overlay_left": snap.has_overlay,
             "last_compaction": engine.last_compaction, "counters": maint_counts(engine)}
        log(f"write {name} fold: {json.dumps(r)}")
        return r

    kernels.slot_set_many, engine._apply_ell_patch, lst._ensure_device = capture, patch, ensure
    gpu_engine.list_step = step_capture
    try:
        kernels.reset_counts()
        start = maint_counts(engine)
        snap = engine.snapshot()

        # (a) the reference bench's burst: new users on existing teams
        n_teams = 0  # the teams are team-0 .. team-(n-1)
        while snap.resolve_set(2, f"team-{n_teams}", "member") is not None:
            n_teams += 1
        burst = [RelationTuple("teams", f"team-{rng.randrange(n_teams)}", "member",
                               SubjectID(f"burst-user-{i}")) for i in range(WRITE_BURST)]
        t0 = time.monotonic()
        wm = store.transact_relation_tuples(burst, ()).snaptoken
        store_s = time.monotonic() - t0
        vis = visible_s(wm)
        snap = engine.snapshot()
        step = {"writes": len(burst), "store_s": store_s, "visible_s": vis,
                "lab_dirty": bool(snap.lab_dirty), "counters": maint_counts(engine)}
        log(f"write (a) burst: {json.dumps(step)}")
        touched_a = sorted({int(t.object.split("-")[1]) for t in burst})
        step["lists"], _, _ = list_round(
            "(a)", [t.subject.id for t in burst[:WRITE_LIST_QUERIES]],
            issues_of(touched_a, WRITE_LIST_QUERIES))
        step["checks"], _ = check_round("(a)", touched_a)
        if step["lab_dirty"] or step["checks"]["label_invalidations"] or not step["checks"]["label_checks"]:
            raise SystemExit(f"write FAILED: the sink burst took the label route off: {step}")
        step["fold"] = settle("(a)", fold=False)
        step["fold"].update(lists_cleared("(a)"))
        out["steps"]["a"] = step

        # (b) team→team edges between active interior team rows: overlay ELL
        snap = engine.snapshot()
        teams = [(f"team-{t}", d) for t, d in
                 ((t, snap.resolve_set(2, f"team-{t}", "member")) for t in range(n_teams))
                 if d is not None and d < snap.num_active]
        ip, ix = snap.fwd_indptr, snap.fwd_indices
        new_edges, used_dst = [], set()
        while len(new_edges) < sum(WRITE_ELL):
            (po, pd), (co, cd) = rng.sample(teams, 2)
            if cd in used_dst or pd == cd or np.any(ix[ip[pd]:ip[pd + 1]] == cd):
                continue
            used_dst.add(cd)  # distinct destinations: one overlay row each
            new_edges.append(RelationTuple("teams", po, "member", SubjectSet("teams", co, "member")))
        step = {"writes": [], "counters": None}
        for k, n in enumerate(WRITE_ELL):
            part = new_edges[sum(WRITE_ELL[:k]):sum(WRITE_ELL[:k]) + n]
            t0 = time.monotonic()
            wm = store.transact_relation_tuples(part, ()).snaptoken
            store_s = time.monotonic() - t0
            vis = visible_s(wm)
            step["writes"].append({"edges": n, "store_s": store_s, "visible_s": vis})
        snap = engine.snapshot()
        step.update({"lab_dirty": len(snap.lab_dirty or ()), "ov_ell": int(snap.ov_ell.shape[0]),
                     "overlay_shape": list(snap.device_overlay[0].shape),
                     "counters": maint_counts(engine)})
        log(f"write (b) overlay ELL: {json.dumps(step)}")
        # explains at the write's snaptoken while the overlay is pending
        # (lab_dirty), before the quiet fold can land: a member of the new
        # child team, or the child team itself, as the parent's member
        ex_snap = engine.snapshot()
        ex_qs = []
        for t in new_edges[:WRITE_EXPLAINS]:
            us = ctx["team_users"].get(int(t.subject.object.split("-")[1]))
            sub = SubjectID(f"user-{us[0]}") if us and len(ex_qs) % 2 == 0 else t.subject
            ex_qs.append(RelationTuple("teams", t.object, "member", sub))
        ex = ExplainEngine(engine, store)
        t0 = time.monotonic()
        ex_resps = [ex.explain(q, at_least=wm) for q in ex_qs]
        ex_s = time.monotonic() - t0
        touched_b = [int(t.object.split("-")[1]) for t in new_edges]
        kids = [int(t.subject.object.split("-")[1]) for t in new_edges]
        users_b = sorted({f"user-{u}" for k in kids for u in ctx["team_users"].get(k, ())})
        launches_before = dict(kernels.COUNTS)
        step["checks"], _ = check_round("(b)", touched_b)
        step["overlay_run_launches"] = (kernels.COUNTS["check_run_overlay"]
                                        - launches_before["check_run_overlay"])
        if step["checks"]["label_checks"] or (device == "cuda" and not step["overlay_run_launches"]):
            raise SystemExit(f"write FAILED: the dirty overlay did not take the BFS route: {step}")
        host = host_lister(ex_snap, store, device)
        ex_bad = []
        for q, r in zip(ex_qs, ex_resps):
            listed = q.object in host.list_objects("teams", "member", q.subject)[0]
            if not (r["allowed"] is listed is oracle.subject_is_allowed(q) is True) or \
                    r["route"] != "bfs" or "landmark" in r or not r["verified"] or \
                    r["witness_source"] != "backtrace" or int(r["snaptoken"]) < wm:
                ex_bad.append((str(q), listed, r))
        step["explains"] = {"explains": len(ex_qs), "seconds": ex_s, "lab_dirty": len(ex_snap.lab_dirty or ()),
                            "routes": dict(ex.requests_by_route), "verify_failures": ex.verify_failures,
                            "witness_edges": [len(r["witness"] or ()) for r in ex_resps],
                            "wrong": len(ex_bad)}
        log(f"write (b) explains: {json.dumps(step['explains'])}")
        if ex_bad or ex.verify_failures or not ex_snap.lab_dirty:
            raise SystemExit(f"write FAILED: explains over the pending overlay: {ex_bad[:3]}")
        # after the checks, whose route assertion needs the overlay pending:
        # a listing that runs past compact_after_s may meet the quiet fold
        step["lists"], _, _ = list_round(
            "(b)", rng.sample(users_b, min(WRITE_LIST_QUERIES, len(users_b))),
            issues_of(touched_b, WRITE_LIST_QUERIES))
        if device == "cuda" and not step["lists"]["k5_overlay_runs"]:
            raise SystemExit(f"write FAILED: K5's overlay stage never launched in (b): {step}")
        step["fold"] = settle("(b)", fold=True)
        step["fold"].update(lists_cleared("(b)"))
        if (step["fold"]["last_compaction"] or {}).get("labels") != "patched":
            raise SystemExit(f"write FAILED: the fold did not patch the labels: {step['fold']}")
        step["after_fold"], _ = check_round("(b) after the fold", touched_b)
        if not step["after_fold"]["label_checks"]:
            raise SystemExit("write FAILED: the label route did not resume after the fold")
        out["steps"]["b"] = step

        # (c) deletes: team-nesting ELL edges (bucket patches) and the burst
        snap = engine.snapshot()
        nest = []
        for t in range(n_teams):
            d = snap.resolve_set(2, f"team-{t}", "member")
            if d is None or d >= snap.num_int:
                continue
            for c in ix[ip[d]:ip[d + 1]].tolist():
                if c < snap.num_active:
                    key = snap.key_of_dev(c)
                    if key[0] == "set" and key[1][0] == 2:
                        nest.append(RelationTuple("teams", f"team-{t}", "member",
                                                  SubjectSet("teams", key[1][1], "member")))
            if len(nest) >= 4 * WRITE_DELETE_ELL:
                break
        dels = rng.sample(nest, WRITE_DELETE_ELL) + burst
        t0 = time.monotonic()
        wm = store.transact_relation_tuples((), dels).snaptoken
        store_s = time.monotonic() - t0
        vis = visible_s(wm)
        snap = engine.snapshot()
        step = {"deletes": len(dels), "store_s": store_s, "visible_s": vis,
                "tombstones": int(snap.ov_removed.size) if snap.ov_removed is not None else 0,
                "lab_dirty": len(snap.lab_dirty or ()), "counters": maint_counts(engine)}
        log(f"write (c) deletes: {json.dumps(step)}")
        touched_c = [int(t.object.split("-")[1]) for t in dels[:WRITE_DELETE_ELL]]
        kids = [int(t.subject.object.split("-")[1]) for t in dels[:WRITE_DELETE_ELL]]
        users_c = sorted({f"user-{u}" for k in kids for u in ctx["team_users"].get(k, ())})
        half = WRITE_LIST_QUERIES // 2
        users_c = rng.sample(users_c, min(half, len(users_c))) + [
            t.subject.id for t in burst[:WRITE_LIST_QUERIES - min(half, len(users_c))]]
        issues_c = issues_of(touched_c, WRITE_LIST_QUERIES)
        list_site = sites["list"]
        step["lists"], _, _ = list_round("(c)", users_c, issues_c)
        step["list_site_slot_sets"] = sites["list"] - list_site
        if device == "cuda" and not step["list_site_slot_sets"]:
            raise SystemExit(f"write FAILED: K9 never launched at the list site in (c): {step}")
        step["checks"], _ = check_round("(c)", touched_c + touched_a[:64])
        step["fold"] = settle("(c)", fold=False)
        step["fold"].update(lists_cleared("(c)"))
        step["lists_after_fold"], objs_c, subs_c = list_round("(c) after the fold", users_c,
                                                              issues_c)
        step["after_fold"], got = check_round("(c) after the fold", touched_c)
        out["steps"]["c"] = step
    finally:
        kernels.slot_set_many, engine._apply_ell_patch, lst._ensure_device = (
            slot_set, apply_patch, ensure_list)
        gpu_engine.list_step = list_step
    launches = dict(kernels.COUNTS)
    end = maint_counts(engine)
    delta = {k: end[k] - start[k] for k in MAINT}
    out.update({"counters": delta, "launches": launches, "slot_set_sites": sites})
    log(f"write counters {json.dumps(delta)}, slot set launches by site {sites}")
    need = {"delta_applies": 3, "compactions": 1, "label_patches": 1, "overlay_device_applies": 1}
    short = {k: delta[k] for k, v in need.items() if delta[k] < v}
    if delta["full_rebuilds"] or short or any(delta[k] for k in MAINT if k.endswith("failures")):
        raise SystemExit(f"write FAILED: counters {delta} (need {need}, no full rebuild)")
    if not all(sites.values()):
        raise SystemExit(f"write FAILED: the slot set missed a site: {sites}")

    # the rebuild the write path replaced: a fresh engine on the final store
    fresh = TorchCheckEngine(store, store.namespaces, device=device)
    t0 = time.monotonic()
    fresh.snapshot()
    if device == "cuda":
        torch.cuda.synchronize()
    rebuild_s = time.monotonic() - t0
    t0 = time.monotonic()
    if not fresh.labels_settled():
        raise SystemExit("write FAILED: the fresh engine built no label index")
    label_s = time.monotonic() - t0
    want = fresh.batch_check(queries)
    bad = sum(g != w for g, w in zip(got, want))
    fresh_lst = SnapshotListEngine(fresh, store.namespaces, device=device)
    lbad = sum(len(set(g) ^ set(fresh_lst.list_objects("issues", "view", SubjectID(u))[0]))
               for u, g in zip(users_c, objs_c))
    lbad += sum(len(set(g) ^ set(fresh_lst.list_subjects("issues", i, "view")[0]))
                for i, g in zip(issues_c, subs_c))
    out["fresh_engine"] = {"snapshot_s": rebuild_s, "label_build_s": label_s,
                           "build_path": fresh.build_info["path"],
                           "build_phases_s": fresh.build_info["phases_s"],
                           "route_counts": route_counts(fresh), "mismatches": bad,
                           "listings": len(users_c) + len(issues_c), "listing_items_differ": lbad,
                           "list_routes": {f"{o}/{p}": n for (o, p), n in
                                           fresh_lst.requests_total.items()}}
    log(f"write fresh engine: snapshot {rebuild_s:.2f}s, label build {label_s:.2f}s, "
        f"{bad} of {len(queries)} decisions differ, {json.dumps(out['fresh_engine'])}")
    fresh.close()
    del fresh
    if bad or lbad:
        raise SystemExit(f"write FAILED: {bad} decisions, {lbad} listed items differ from a "
                         "fresh engine")
    report["write"] = out
    return captured, launches, ov_cap[0]


def slot_rows(torch, kernels, captured, launches, rate):
    """Time K9 on the write path's largest bucket-patch call (every bucket
    of one patch in one launch) beside its plain version, its bound and
    ``clone().index_put_`` a target. ``ms`` is the fused launch alone (the
    copy and the patch; plan and entries already on the card) by CUDA
    events over back-to-back launches, ``wrapper_ms`` the whole wrapper
    call (dedup and range check, plan, upload, launch) the same way, and
    ``call_ms`` on the host clock; one call must make one launch and no
    host read."""
    site, targets = max((x for x in captured if x[0] == "ell_patch"),
                        key=lambda x: sum(t[0].numel() for t in x[1]))
    want = kernels.slot_set_many_ref(targets)
    got = kernels.slot_set_many_cuda(targets)
    torch.cuda.synchronize()
    m = sum(diff(g, w)[0] for g, w in zip(got, want))
    err = max(diff(g, w)[1] for g, w in zip(got, want))
    before = kernels.COUNTS["slot_set"]
    reads = host_reads(torch, lambda: kernels.slot_set_many_cuda(targets))
    per_call = kernels.COUNTS["slot_set"] - before
    plan = kernels.slot_set_plan(targets)
    words = torch.from_numpy(plan.words).cuda()
    lib, stream = kernels._lib(), kernels._stream()
    if kernels.slot_set_launch(lib, plan, words, stream):
        raise SystemExit("slot set at write shapes FAILED: the bare launch was refused")
    torch.cuda.synchronize()
    m += sum(diff(o, w)[0] for o, w in zip(plan.outs, want))
    ent = []
    for buf, r, c, v in targets:
        rows, cols, vals, _ = kernels._slot_entries(buf, r, c, v)
        ent.append((buf, torch.from_numpy(rows).cuda(), torch.from_numpy(cols).cuda(),
                    torch.from_numpy(vals).cuda()))

    def library():
        for buf, rr, cc, vv in ent:
            buf.clone().index_put_((rr,) if buf.dim() == 1 else (rr, cc), vv)

    lib_ms = time_ms(library, 100)
    ms = time_ms(lambda: _ok(kernels.slot_set_launch(lib, plan, words, stream), "keto_slot_set"),
                 100)
    wrapper = time_ms(lambda: kernels.slot_set_many_cuda(targets), 50)
    host_ms = call_ms(torch, lambda: kernels.slot_set_many_cuda(targets))
    plain = time_ms(lambda: kernels.slot_set_many_ref(targets), 10, warmup=1)
    n = plan.n_entries
    # each functional target read and written once, the descriptors and
    # every entry's key and value read once, every entry's word written once
    bytes_needed = sum(2 * t[0].numel() * 4 for t in targets) + 4 * (plan.words.size + n)
    row = {"name": "slot_set", "route": "cuda", "source": "keto_tpu_torch/csrc/patch_kernels.cu",
           "replaces": K9, "launches": launches["slot_set"], "mismatches": m, "max_abs_err": err,
           "ms": ms, "plain_ms": plain, "bound_ms": bytes_needed / rate * 1e3, "bound_by": "bytes",
           "library_ms": lib_ms, "library_note": "clone().index_put_ a target",
           "wrapper_ms": wrapper, "call_ms": host_ms,
           "call_timed_by": "host clock, median of 200 calls timed alone",
           "launches_per_call": per_call, "host_reads_per_call": reads, "site": site,
           "targets": len(targets),
           "target_shapes": [list(t[0].shape) for t in targets], "entries": n,
           "blocks": plan.n_blocks}
    log(f"kernel slot_set: {ms:.4f} ms the fused launch (wrapper {wrapper:.4f} ms, host clock "
        f"{host_ms:.4f} ms, plain {plain:.4f} ms, bound {row['bound_ms']:.5f} ms, index_put_ "
        f"{lib_ms:.4f} ms), {per_call} launch and {reads} host reads a call, mismatches {m}, "
        f"{json.dumps(row)}")
    if m or per_call != 1 or reads:
        raise SystemExit(f"slot set at write shapes FAILED: {m} mismatching words, {per_call} "
                         f"launches and {reads} host reads a call")
    return [row]


def k5_row(torch, lk, cap, launches, rate, name, note):
    """K5 on one captured fixpoint's inputs: the kernel against the plain
    version; the whole run (the wrapper's call: one launch and its one host
    read), the kernel alone (``bare_ms``) and the plain version timed; the
    launches and host reads of one run counted."""
    buckets, R0, ovn, ovd, kw = cap
    got = lk.list_step_cuda(buckets, R0, ovn, ovd, **kw)
    want = lk.list_step_ref(buckets, R0, ovn, ovd, **kw)
    m, err = diff(got, want)
    before = dict(lk.COUNTS)
    reads = host_reads(torch, lambda: lk.list_step_cuda(buckets, R0, ovn, ovd, **kw))
    per_run = {k: lk.COUNTS[k] - before[k] for k in K5_KERNELS}
    steps = lk.COUNTS["list_iters"] - before["list_iters"]
    ms = whole_ms(torch, lambda: lk.list_step_cuda(buckets, R0, ovn, ovd, **kw), 20)
    pull = bool(buckets) and kw["n_active"] > 0
    bk = list(zip(buckets, kw["valid_rows"])) if pull else []
    K = 0 if ovn is None else int(ovn.shape[0])
    states = [lk.fixpoint_state(R0, pull, K) for _ in range(20)]
    kernel_ms = bare_ms(torch, lambda st: lk.fixpoint_launch(
        lk._lib(), bk, st, ovn if K else None, ovd, kw["it_cap"], kw.get("block_iters", 8),
        lk._stream()), states)
    Ra, Rb, _, ctl = states[-1]
    m += diff(Rb if int(ctl[2]) else Ra, want)[0]
    del states
    plain = whole_ms(torch, lambda: lk.list_step_ref(buckets, R0, ovn, ovd, **kw), 2)
    # inputs read once (the valid bucket rows, the overlay, R0), the bitmap
    # written once
    slots = sum(int(n) * b.shape[1] for b, n in zip(buckets, kw["valid_rows"]))
    ov_ints = 0 if ovn is None else ovn.numel() + ovd.numel()
    k5_bytes = 4 * (slots + ov_ints) + 2 * R0.numel() * 4
    row = {"name": name, "route": "cuda", "source": "keto_tpu_torch/csrc/list_kernels.cu",
           "replaces": K5, "launches": launches, "mismatches": m, "max_abs_err": err,
           "ms": ms, "kernel_ms": kernel_ms,
           "kernel_timed_by": "events around a bare launch behind a spin", "plain_ms": plain,
           "bound_ms": k5_bytes / rate * 1e3, "bound_by": "bytes", "library_ms": None,
           "rows": int(R0.shape[0]) - 1, "n_active": kw["n_active"], "edge_slots": slots,
           "overlay_rows": K, "steps": steps, "launches_per_run": sum(per_run.values()),
           "host_reads_per_run": reads, "note": note}
    log(f"kernel {name}: {ms:.4f} ms a run (kernel alone {kernel_ms:.4f} ms, plain {plain:.4f} "
        f"ms, bound {row['bound_ms']:.4f} ms), {steps} steps, {row['launches_per_run']} launch "
        f"and {reads} host read a run, mismatches {m}")
    if m or row["launches_per_run"] != 1 or reads != 1:
        raise SystemExit(f"{name} FAILED at its path's shapes: {m} mismatching words, "
                         f"{row['launches_per_run']} launches and {reads} host reads a run")
    return row


def list_sort_rows(torch, kernels, captured, list_launches, deep_launches, sort_keys, rate,
                   cache_launches=None):
    """K5 at the list phase's shapes (the first ListObjects fixpoint) and K8
    on the deep build's largest key array, each beside its plain version and
    bound; K8 also beside ``torch.argsort(stable=True)``, with the cache
    phase's reload's launches where it ran."""
    import numpy as np

    from keto_tpu_torch.graph import sort_kernels as sk
    from keto_tpu_torch.list import kernels as lk

    rows = [k5_row(torch, lk, captured[0], list_launches["list_fixpoint"], rate, "list_step",
                   "the whole fixpoint, no overlay pending; launches = fixpoint runs in the "
                   "list phase, one keto_list_fixpoint launch each")]

    keys = torch.from_numpy(np.ascontiguousarray(sort_keys, dtype=np.int32)).cuda()
    n = keys.numel()
    got = sk.radix_argsort_cuda(keys)
    want = sk.radix_argsort_ref(keys)
    m, err = diff(got, want)
    lib = torch.argsort(keys, stable=True)
    if not torch.equal(lib.to(torch.int32), got):
        raise SystemExit("radix argsort at deep shapes FAILED: torch.argsort(stable=True) differs")
    ms = time_ms(lambda: sk.radix_argsort_cuda(keys), 10)
    plain = time_ms(lambda: sk.radix_argsort_ref(keys), 1, warmup=0)
    lib_ms = time_ms(lambda: torch.argsort(keys, stable=True), 10)
    # the kernels alone: the histogram launch, then the passes enqueued with
    # the plan known (no synchronisation between them)
    plan = sk.radix_pass_plan(sk.radix_hist_ref(keys))
    hist = torch.zeros((sk.PASSES, sk.DIGITS), dtype=torch.int32, device="cuda")
    klib, stream = sk._lib(), sk._stream()
    hist_ms = time_ms(lambda: _ok(klib.keto_radix_hist(keys.data_ptr(), n, hist.data_ptr(), stream),
                                   "keto_radix_hist"), 10)
    hist.zero_()
    klib.keto_radix_hist(keys.data_ptr(), n, hist.data_ptr(), stream)
    passes_ms = time_fresh_ms(lambda sc: sk._passes_cuda(klib, stream, sc, plan),
                              lambda: (sk._Scratch(keys, hist),), 10)
    rows.append({"name": "radix_argsort", "route": "cuda", "source": "keto_tpu_torch/csrc/sort_kernels.cu",
                 "replaces": K8, "launches": deep_launches["radix_sort"], "mismatches": m,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 # the function reads each int32 key once and writes each int32 index once
                 "bound_ms": 8 * n / rate * 1e3, "bound_by": "bytes", "library_ms": lib_ms,
                 "keys": n, "passes_run": plan, "hist_kernel_ms": hist_ms,
                 "pass_kernels_ms": passes_ms,
                 "kernel_bytes_bound_ms": sk.kernel_bytes(n, len(plan)) / rate * 1e3,
                 "kernel_launches": {k: deep_launches[k] for k in
                                     ("radix_hist", "radix_pass", "radix_pass_skipped")},
                 "cache_reload_launches": None if cache_launches is None else {
                     k: cache_launches[k] for k in ("radix_sort", "radix_hist", "radix_pass",
                                                    "radix_pass_skipped")},
                 "note": "launches = whole sorts in the deep build (each one keto_radix_hist, "
                         "then one keto_radix_pass per pass its plan runs; radix_pass_skipped "
                         "counts the passes left out); ms = the wrapper's whole call (its one "
                         "synchronisation for the plan included); hist_kernel_ms and "
                         "pass_kernels_ms time the kernels alone; kernel_bytes_bound_ms = "
                         f"the {sk.kernel_bytes(1, len(plan))} B/key the kernels move"})
    log(f"kernel radix_argsort: {ms:.4f} ms on {n} keys (plain {plain:.4f} ms, bound "
        f"{rows[-1]['bound_ms']:.4f} ms, torch.argsort stable {lib_ms:.4f} ms), mismatches {m}")
    if m:
        raise SystemExit(f"radix argsort parity at deep shapes FAILED: {m} mismatching words")
    return rows


def list_overlay_row(torch, cap, launches, rate):
    """K5 at the write phase's shapes: a fixpoint run with the overlay
    pending, so the overlay gather and scatter launch in every step."""
    from keto_tpu_torch.list import kernels as lk

    if cap is None:
        raise SystemExit("write FAILED: no listing ran K5 with an overlay pending")
    return k5_row(torch, lk, cap, launches["list_fixpoint_overlay"], rate, "list_step_overlay",
                  "the whole fixpoint with the write phase's overlay pending; launches = the "
                  "write phase's fixpoint runs with an overlay pending, one keto_list_fixpoint "
                  "launch each")


# -- phase 11: serve ---------------------------------------------------------------


#: a cycle through the directory's owners: its rows cannot be peeled, so the
#: served snapshot gets active rows; the self-query through the cycle falls
#: back from the label route, so the fixpoint kernels run too
SERVE_CYCLE = "videos:/cats#owner@(videos:/cats/1.mp4#owner)"
#: GET /check/explain on the cat-videos demo: a grant and a deny
SERVE_EXPLAINS = [("videos:/cats/1.mp4#view@cat lady", True), ("videos:/cats/2.mp4#view@*", False)]
SERVE_CYCLE_CHECKS = [
    ("videos:/cats/2.mp4#view@cat lady", True),
    ("videos:/cats#view@cat lady", True),
    ("videos:/cats/1.mp4#view@dog", False),
    ("videos:/cats#owner@(videos:/cats#owner)", True),
]


def served_launches(kernels, engine, what: str, before: dict) -> dict:
    """The launch counts of the serve requests since the last reset, after
    the label build has settled; fails unless the label step launched
    where the label route answered and the BFS kernels where it fell back
    (the fixpoint's only where the snapshot has active rows)."""
    engine.labels_settled()
    counts = dict(kernels.COUNTS)
    routes = route_counts(engine)
    answered = routes["label_checks"] - before["label_checks"]
    fell_back = routes["label_fallbacks"] - before["label_fallbacks"]
    n_active = engine.snapshot().num_active
    need = ["label_step"] if answered else []
    if fell_back:
        need += ["seed", "answer_pack"] + (["check_run"] if n_active else [])
    log(f"serve launches ({what}, {n_active} active rows, {answered} label-route checks, "
        f"{fell_back} fallbacks): {counts}")
    missing = [k for k in need if not counts[k]]
    if missing or not any(counts.values()):
        raise SystemExit(f"serve FAILED: {what} never launched {missing or 'any kernel'}")
    return counts


def serve_tuple_api(d, req) -> dict:
    """``/version``, ``GET /expand``, ``GET /relation-tuples`` and ``PATCH
    /relation-tuples`` on the daemon ``d``; fails on a wrong answer. The
    expand trees are held against the Manager-backed engine over the same
    store at the clamped depth, the tuple pages against the store's own
    read."""
    from urllib.parse import urlencode

    from keto_tpu_torch.expand import ExpandEngine
    from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple, SubjectSet
    from keto_tpu_torch.version import __version__

    out: dict = {}
    oracle = ExpandEngine(d.store)

    def fail(what, got):
        raise SystemExit(f"serve FAILED: {what} answered {got}")

    for port in (d.read.port, d.write.port):
        got = req("GET", port, "/version")
        if got != (200, {"version": __version__}):
            fail("/version", got)
    out["version"] = __version__

    def expand(obj, rel, depth):
        q = urlencode({"namespace": "videos", "object": obj, "relation": rel,
                       **({} if depth is None else {"max-depth": depth})})
        return req("GET", d.read.port, "/expand?" + q)

    def tree_json(obj, rel, depth):
        t = oracle.build_tree(SubjectSet("videos", obj, rel), depth)
        return None if t is None else t.to_json()

    cap = d.read.app.max_read_depth
    trees = {}
    for obj, rel, asked in (("/cats/1.mp4", "view", 3), ("/cats/2.mp4", "view", 0),
                            ("/cats", "owner", 100), ("/cats/9.mp4", "view", 2)):
        got = expand(obj, rel, asked)
        want = tree_json(obj, rel, d.read.app.expand_depth(asked))
        if got != (200, want):
            fail(f"/expand {obj}#{rel} max-depth={asked} (want {want})", got)
        trees[f"{obj}#{rel}@{asked}"] = got[1]
    if expand("/cats/1.mp4", "view", None)[0] != 400:
        fail("/expand without max-depth", expand("/cats/1.mp4", "view", None))
    out["expand"] = {"cap": cap, "trees": len(trees), "no_depth": 400}

    def pages(query: RelationQuery):
        seen, token, n = [], "", 0
        while True:
            status, body = req("GET", d.read.port, "/relation-tuples?" + query.to_url_query()
                               + f"&page_size=1&page_token={token}")
            if status != 200:
                fail("/relation-tuples", (status, body))
            seen += body["relation_tuples"]
            token, n = body["next_page_token"], n + 1
            if not token:
                return seen, n

    q1 = RelationQuery(namespace="videos", object="/cats/1.mp4")
    got, n_pages = pages(q1)
    want = [t.to_json() for t in d.store.get_relation_tuples(q1)[0]]
    if got != want or n_pages != len(want):
        fail(f"/relation-tuples pages (want {want})", got)
    out["relation_tuples"] = {"tuples": len(got), "pages": n_pages}

    ins = RelationTuple.from_string("videos:/cats/3.mp4#view@*")
    dele = RelationTuple.from_string("videos:/cats/1.mp4#view@*")
    status, body = req("PATCH", d.write.port, "/relation-tuples", [
        {"action": "insert", "relation_tuple": ins.to_json()},
        {"action": "delete", "relation_tuple": dele.to_json()}])
    if status != 204:
        fail("PATCH /relation-tuples", (status, body))
    after = {
        "inserted": req("GET", d.read.port, "/check?" + ins.to_url_query() + "&latest=true"),
        "deleted": req("GET", d.read.port, "/check?" + dele.to_url_query() + "&latest=true"),
        "3.mp4": pages(RelationQuery(namespace="videos", object="/cats/3.mp4"))[0],
        "expand": expand("/cats/1.mp4", "view", 3),
    }
    if after["inserted"] != (200, {"allowed": True}) or \
            after["deleted"] != (403, {"allowed": False}) or after["3.mp4"] != [ins.to_json()] \
            or after["expand"] != (200, tree_json("/cats/1.mp4", "view", 3)) or \
            "*" in [c.get("subject_id") for c in after["expand"][1]["children"]]:
        fail("the tuple API after a PATCH", after)
    out["patch"] = {"status": status, "inserted_allowed": True, "deleted_allowed": False}
    log(f"serve: tuple API {json.dumps(out)}, trees {json.dumps(trees)}")
    return out


#: concurrent keyed writers of the serve phase, each resending its PUT once
SERVE_KEYED_WRITERS = 64


def serve_keyed_writes(d) -> dict:
    """SERVE_KEYED_WRITERS concurrent ``PUT /relation-tuples`` with an
    ``X-Idempotency-Key`` each, each resent once: every resend must replay
    its write's token (``X-Keto-Idempotent-Replay: true``), the store must
    commit them in fewer groups than writers (the daemon's group-commit
    coordinator), and ``GET /check?snaptoken=`` must read every write. Each
    writer keeps one connection open (keep-alive), opened before the
    writers start, as a client pool does."""
    import http.client
    import threading
    import urllib.request

    from keto_tpu_torch.relationtuple.model import RelationTuple

    def put(conn, t, key):
        conn.request("PUT", "/relation-tuples", body=json.dumps(t.to_json()).encode(),
                     headers={"X-Idempotency-Key": key, "Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        return resp.status, dict(resp.getheaders())

    n = SERVE_KEYED_WRITERS
    tuples = [RelationTuple.from_string(f"videos:/cats/keyed-{i}.mp4#view@writer-{i}")
              for i in range(n)]
    first: list = [None] * n
    again: list = [None] * n
    flush0, writers0 = d.writer.flush_total, d.writer.writers_total
    replays0 = d.store.idempotent_replays
    conns = [http.client.HTTPConnection("127.0.0.1", d.write.port, timeout=60) for _ in range(n)]
    for c in conns:
        c.connect()
    barrier = threading.Barrier(n + 1)

    def writer(i):
        barrier.wait()
        first[i] = put(conns[i], tuples[i], f"serve-keyed-{i}")
        again[i] = put(conns[i], tuples[i], f"serve-keyed-{i}")

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    for c in conns:
        c.close()
    tokens = [int(h.get("X-Keto-Snaptoken", -1)) for _, h in first]
    out = {"writers": n, "seconds": wall,
           "statuses": sorted({st for st, _ in first + again}),
           "distinct_tokens": len(set(tokens)),
           "replayed": sum(h.get("X-Keto-Idempotent-Replay") == "true"
                           and int(h.get("X-Keto-Snaptoken", -2)) == tok
                           for (_, h), tok in zip(again, tokens)),
           "first_replayed": sum(h.get("X-Keto-Idempotent-Replay") == "true" for _, h in first),
           "flush_total": d.writer.flush_total - flush0,
           "writers_total": d.writer.writers_total - writers0,
           "store_replays": d.store.idempotent_replays - replays0}
    read = 0
    for t, tok in zip(tuples, tokens):
        q = t.to_url_query() + f"&snaptoken={tok}"
        with urllib.request.urlopen(f"http://127.0.0.1:{d.read.port}/check?{q}", timeout=60) as r:
            read += json.loads(r.read()) == {"allowed": True} and \
                int(r.headers["X-Keto-Snaptoken"]) >= tok
    out["read_at_token"] = read
    log(f"serve: keyed writers {json.dumps(out)}")
    if out["statuses"] != [201] or out["distinct_tokens"] != n or out["replayed"] != n \
            or out["first_replayed"] or out["store_replays"] != n or read != n \
            or not out["flush_total"] < n:
        raise SystemExit(f"serve FAILED: keyed writers {out}")
    return out


def phase_serve(kernels, report):
    import tempfile
    import urllib.error
    import urllib.request

    from keto_tpu_torch import _build
    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.relationtuple.model import RelationTuple
    from keto_tpu_torch.workloads import (
        CAT_VIDEOS_CHECKS,
        CAT_VIDEOS_NAMESPACES,
        CAT_VIDEOS_TUPLES,
        parse_tuples,
    )

    def req(method, port, path, body=None, headers=None):
        data = None if body is None else json.dumps(body).encode()
        r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                   headers=headers or {})
        try:
            with urllib.request.urlopen(r, timeout=60) as resp:
                raw = resp.read()
                return resp.status, json.loads(raw) if raw else None
        except urllib.error.HTTPError as e:
            raw = e.read()
            return e.code, json.loads(raw) if raw else None

    log_dir = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    obs_dir = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    span_file = f"{obs_dir.name}/spans.otlp.jsonl"
    bundle_dir = f"{obs_dir.name}/bundles"
    d = Daemon(CAT_VIDEOS_NAMESPACES, device="cuda", tuples=parse_tuples(CAT_VIDEOS_TUPLES),
               decision_log_dir=log_dir.name, decision_log_sample=1.0,
               tracing_provider="otlp-file", tracing_otlp_file=span_file,
               debug_bundle_dir=bundle_dir)
    d.start()
    drained = False
    try:
        d.engine.labels_settled()
        kernels.reset_counts()
        before = route_counts(d.engine)
        # GET /check/explain: a grant with its witness, a deny with its
        # certificate (before the PUT below grants it)
        explained = {}
        for check, allowed in SERVE_EXPLAINS:
            status, body = req("GET", d.read.port,
                               "/check/explain?" + RelationTuple.from_string(check).to_url_query())
            explained[check] = {"status": status, "allowed": body.get("allowed"),
                                "route": body.get("route"), "verified": body.get("verified"),
                                "witness_edges": len(body.get("witness") or ()),
                                "certificate": body.get("certificate")}
            if status != 200 or body["allowed"] is not allowed or \
                    (allowed and not (body["verified"] and body["witness"])) or \
                    (not allowed and body["certificate"]["type"] != "frontier-exhaustion"):
                raise SystemExit(f"serve FAILED: /check/explain {check} -> {status} {body}")
        log(f"serve: /check/explain {json.dumps(explained)}")
        report["serve_explain"] = explained
        codes = []
        for check, allowed in CAT_VIDEOS_CHECKS:
            q = RelationTuple.from_string(check).to_url_query()
            status, body = req("GET", d.read.port, "/check?" + q)
            codes.append(status)
            if status != (200 if allowed else 403) or body != {"allowed": allowed}:
                raise SystemExit(f"serve FAILED: {check} -> {status} {body}")
        # the daemon's log: read_all flushes its open segment first
        recs, corrupt = d.decision_log.read_all("default")
        checks = [r["decision"] for r in recs if r["kind"] == "check"]
        kinds = [r["kind"] for r in recs]
        log(f"serve: decision log {kinds}, check decisions {checks}, {corrupt} corrupt lines")
        if corrupt or checks != [a for _, a in CAT_VIDEOS_CHECKS] or \
                kinds.count("explain") != len(SERVE_EXPLAINS):
            raise SystemExit(f"serve FAILED: the decision log holds {recs}")
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
        report["serve_launches"] = served_launches(kernels, d.engine, "cat-videos", before)

        put = req("PUT", d.write.port, "/relation-tuples",
                  RelationTuple.from_string(SERVE_CYCLE).to_json())
        d.engine.labels_settled()
        kernels.reset_counts()
        before = route_counts(d.engine)
        cyc = req("POST", d.read.port, "/check/batch",
                  {"tuples": [RelationTuple.from_string(c).to_json() for c, _ in SERVE_CYCLE_CHECKS]})
        log(f"serve: PUT {put[0]} of a cycle, batch {cyc}")
        if put[0] != 201 or cyc != (200, {"results": [a for _, a in SERVE_CYCLE_CHECKS]}):
            raise SystemExit(f"serve FAILED: checks over the cycle answered {cyc}")
        cycled = served_launches(kernels, d.engine, "cycle", before)
        if not cycled["check_run"]:
            raise SystemExit("serve FAILED: the cycle left the served snapshot without active rows")
        report["serve_cycle_launches"] = cycled

        # the reverse queries over REST, on the card
        kernels.reset_counts()
        lo = req("GET", d.read.port, "/relation-tuples/list-objects?"
                 "namespace=videos&relation=view&subject_id=cat%20lady&latest=true")
        ls = req("GET", d.read.port, "/relation-tuples/list-subjects?"
                 "namespace=videos&object=/cats/1.mp4&relation=view&page_size=1")
        routes = dict(d.lister.requests_total)
        log(f"serve: list-objects {lo}, list-subjects {ls}, routes {routes}, "
            f"K5 runs {kernels.COUNTS['list_fixpoint']}")
        if lo[0] != 200 or lo[1]["objects"] != ["/cats", "/cats/1.mp4", "/cats/2.mp4"] \
                or ls[0] != 200 or ls[1]["subject_ids"] != ["*"] or not ls[1]["next_page_token"]:
            raise SystemExit(f"serve FAILED: listings answered {lo}, {ls}")
        if kernels.COUNTS["list_fixpoint"] < 2 or any(p != "device" for _, p in routes):
            raise SystemExit(f"serve FAILED: the listings did not run K5 on the card: {routes}")
        report["serve_list_launches"] = dict(kernels.COUNTS)
        report["serve_tuple_api"] = serve_tuple_api(d, req)
        report["serve_keyed_writes"] = serve_keyed_writes(d)

        # one traced check, then the drain: a drain bundle, and the span file
        # flushed with the check's request span and its stage spans (the
        # writes above changed the decisions: any answer the status mirrors)
        traced = req("GET", d.read.port, "/check?" + RelationTuple.from_string(
            CAT_VIDEOS_CHECKS[0][0]).to_url_query(), headers={"traceparent": SERVE_TRACEPARENT})
        if traced[0] not in (200, 403) or traced[1] != {"allowed": traced[0] == 200}:
            raise SystemExit(f"serve FAILED: the traced check answered {traced}")
        drained = True
        d.drain_and_shutdown()
        report["serve_observability"] = serve_observability(span_file, bundle_dir)
    finally:
        if not drained:
            d.stop()
        log_dir.cleanup()
        obs_dir.cleanup()


#: the traced check of the serve phase (W3C traceparent: trace, parent span)
SERVE_TRACE_ID = "5e7c0ba1d9a44f3bb1d6c2f0a8e4b731"
SERVE_TRACEPARENT = f"00-{SERVE_TRACE_ID}-a1b2c3d4e5f60718-01"


def serve_observability(span_file: str, bundle_dir: str) -> dict:
    """After the serve phase's drain: every line of the ``otlp-file`` span
    file parses as an OTLP request; the traced ``GET /check`` is there with
    its stage spans as children (``device`` among them); the ``drain``
    bundle validates."""
    from pathlib import Path

    from keto_tpu_torch.x.flightrec import list_bundles, validate_bundle

    def fail(msg):
        raise SystemExit(f"serve FAILED: {msg}")

    spans = []
    lines = Path(span_file).read_text().splitlines()
    for line in lines:
        spans += json.loads(line)["resourceSpans"][0]["scopeSpans"][0]["spans"]
    reqs = [s for s in spans if s["traceId"] == SERVE_TRACE_ID and s["name"] == "http.GET /check"]
    if len(reqs) != 1 or reqs[0]["parentSpanId"] != SERVE_TRACEPARENT.split("-")[2]:
        fail(f"the traced check's request span: {reqs}")
    stages = sorted(s["name"] for s in spans if s["parentSpanId"] == reqs[0]["spanId"])
    if "timeline.device" not in stages:
        fail(f"the traced check's stage spans: {stages}")
    bundles = [(p, json.loads(p.read_text())) for p in list_bundles(bundle_dir)]
    drains = [(p, b) for p, b in bundles if b["reason"] == "drain"]
    if len(drains) != 1 or validate_bundle(drains[0][1]):
        fail(f"the drain bundle: {[b['reason'] for _, b in bundles]}, "
             f"{validate_bundle(drains[0][1]) if drains else None}")
    res = {"span_lines": len(lines), "spans": len(spans), "traced_stages": stages,
           "bundles": [b["reason"] for _, b in bundles],
           "drain_bundle_bytes": drains[0][0].stat().st_size,
           "drain_sections": sorted(drains[0][1]["sections"])}
    log(f"serve observability: {json.dumps(res)}")
    return res


# -- the cli phase: the registry path, Watch, hot reload and the CLI process ---


#: the cli phase: /check/batch bodies, keep-alive GET clients and their GETs,
#: the watch leg's write transactions and their tuples, the seconds allowed
#: for a hot-reloaded namespace to serve and for the CLI's drain past its
#: serve.drain_timeout_s
CLI_BATCH = 16_384
CLI_CLIENTS = 16
CLI_GETS = 100
CLI_WATCH_WRITES = 10
CLI_WATCH_TUPLES = 100
CLI_RELOAD_S = 5.0
CLI_EXIT_MARGIN_S = 30.0
#: the hot-reloaded namespace (an id config 3 does not use)
CLI_HOT_NS = {"id": 7, "name": "cli-hot"}
CLI_HOT_TUPLES = ["cli-hot:a#m@(cli-hot:b#m)", "cli-hot:b#m@(cli-hot:a#m)", "cli-hot:b#m@alice"]
CLI_HOT_CHECKS = [("cli-hot:a#m@alice", True), ("cli-hot:a#m@bob", False)]
#: the device kernels whose names a CUDA trace of a check shows, by wrapper
CLI_TRACE_KERNELS = {"check_run_kernel": "keto_check_run", "label_step_kernel": "keto_label_step"}


class _Conn:
    """One keep-alive HTTP/1.1 connection: ``req`` answers (status, parsed
    body, headers)."""

    def __init__(self, port: int, timeout: float = 120.0):
        import http.client

        self.c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def req(self, method, path, body=None, headers=None):
        data = None if body is None else (body if isinstance(body, bytes)
                                          else json.dumps(body).encode())
        self.c.request(method, path, body=data, headers=headers or {})
        r = self.c.getresponse()
        raw = r.read()
        return r.status, (json.loads(raw) if raw else None), dict(r.getheaders())

    def close(self):
        self.c.close()


class _WatchReader:
    """A ``GET /watch?snaptoken=N`` stream read on a thread: ``lines`` holds
    ``(receive unix time, message)``; the thread ends with the stream."""

    def __init__(self, port: int, token: int):
        import http.client
        import threading

        self.lines: list = []
        self.status = None
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        self.conn.request("GET", f"/watch?snaptoken={token}")
        self.resp = self.conn.getresponse()
        self.status = self.resp.status
        self.thread = threading.Thread(target=self._read, daemon=True)
        if self.status == 200:
            self.thread.start()

    def _read(self):
        try:
            while True:
                line = self.resp.readline()
                if not line:
                    return
                self.lines.append((time.time(), json.loads(line)))
        except OSError:
            return

    def wait(self, n: int, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while len(self.lines) < n and time.monotonic() < deadline:
            time.sleep(0.005)
        return len(self.lines) >= n

    def close(self):
        self.conn.close()


def _kernel_files():
    from keto_tpu_torch import _build

    return sorted((p.name, p.stat().st_mtime_ns) for p in _build.BUILD_DIR.glob("*.so"))


def phase_cli(torch, kernels, report, queries, main_ctx, device="cuda"):
    """The reference's default serving path on the card (see the module
    docstring's cli entry): (a) ``Config`` → ``Registry`` → ``Daemon`` on
    the async backend with config 3 loaded through the registry's store,
    main's 100k checks as ``/check/batch`` posts, then keep-alive GETs;
    (b) Watch: groups exactly once in commit order, a resume, 410 under a
    GC'd horizon and the engine's full rebuild past it; (c) a hot-reloaded
    namespace served on the card, a malformed file keeping the last good
    set; (d) ``python3 -m keto_tpu_torch serve -c`` as its own process with
    a ``torch.profiler`` trace, SIGTERM, exit 0; (e) bad configs refused
    before the card is touched. ``device="cpu"`` rehearses the phase on the
    host (no launch is counted there, so the launch checks are the card's
    alone)."""
    import os
    import signal
    import tempfile
    import threading
    from pathlib import Path

    from keto_tpu_torch import _build
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.driver.registry import Registry
    from keto_tpu_torch.relationtuple.model import RelationTuple
    from keto_tpu_torch.workloads import (
        CAT_VIDEOS_CHECKS,
        CAT_VIDEOS_NAMESPACES,
        CAT_VIDEOS_TUPLES,
        RBAC_NAMESPACES,
        rbac_workload,
    )

    def fail(msg):
        raise SystemExit(f"cli FAILED: {msg}")

    t_phase = time.monotonic()
    on_card = device == "cuda"
    out: dict = {"card": card_line() if on_card else "cpu"}
    _, _, _, expected = main_ctx
    work = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR.parent))
    ns_dir = work / "ns"
    ns_dir.mkdir()
    for n in RBAC_NAMESPACES:
        (ns_dir / f"{n.name}.json").write_text(json.dumps(n.to_json()))
    cfg_path = work / "cfg.json"
    cfg_path.write_text(json.dumps({
        "dsn": "memory", "namespaces": f"file://{ns_dir}",
        "serve": {"read": {"host": "127.0.0.1", "port": 0},
                  "write": {"host": "127.0.0.1", "port": 0}, "http_backend": "async"}}))

    # (a) the registry path in process
    t0 = time.monotonic()
    tuples, _ = rbac_workload(random.Random(SEED), N_TUPLES)
    gen_s = time.monotonic() - t0
    reg = Registry(Config(config_file=str(cfg_path)), device=None if on_card else device)
    d = Daemon(reg)
    store = reg.relation_tuple_manager()
    t0 = time.monotonic()
    store.write_relation_tuples(*tuples)
    load_s = time.monotonic() - t0
    del tuples
    kernels.reset_counts()
    if on_card:
        kernels.reset_run_counts()
    t0 = time.monotonic()
    d.serve_all(block=False)
    engine = reg.permission_engine()
    serving = False
    procs: dict = {}
    try:
        if type(d.read).__name__ != "AsyncRestServer":
            fail(f"the read port serves on {type(d.read).__name__}, not the async backend")
        post = _Conn(d.read_port)
        got, sheds, post_ms = [], 0, []
        for i in range(0, len(queries), CLI_BATCH):
            body = json.dumps({"tuples": [q.to_json() for q in queries[i:i + CLI_BATCH]]}).encode()
            while True:
                t1 = time.monotonic()
                status, resp, hdrs = post.req("POST", "/check/batch", body)
                if status != 429:
                    break
                sheds += 1
                time.sleep(float(hdrs.get("Retry-After", "1")))
            post_ms.append((time.monotonic() - t1) * 1e3)
            if status != 200:
                fail(f"POST /check/batch answered {status} {resp}")
            got += resp["results"]
        post.close()
        batch_s = time.monotonic() - t0
        wrong = sum(bool(g) != e for g, e in zip(got, expected))
        if len(got) != len(queries) or wrong:
            fail(f"{wrong} of {len(got)} batch decisions differ from main's expectation")

        lat, bad = [], []

        def client(k):
            c = _Conn(d.read_port)
            try:
                for j in range(CLI_GETS):
                    i = (k * CLI_GETS + j * 7919) % len(queries)
                    t1 = time.perf_counter()
                    status, _, _ = c.req("GET", "/check?" + queries[i].to_url_query())
                    lat.append((time.perf_counter() - t1) * 1e3)
                    if status != (200 if expected[i] else 403):
                        bad.append((i, status))
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(k,)) for k in range(CLI_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        if bad or len(lat) != CLI_CLIENTS * CLI_GETS:
            fail(f"GET /check: {len(bad)} wrong of {len(lat)}: {bad[:5]}")
        launches = dict(kernels.COUNTS)
        if on_card:
            launches["check_run_steps"] = kernels.run_counts()[0]
        labels = engine.labels_settled()
        if on_card and (not launches["check_run"] or not launches["radix_sort"]
                        or not launches["radix_pass"]):
            fail(f"the registry path did not run K2 and K8 on the card: {launches}")
        if on_card and labels and engine.counters().get("label_checks", 0) \
                and not launches["label_step"]:
            fail("the label route answered without K3")
        out["a"] = {
            "config": "BASELINE config 3 (RBAC) through Config, Registry, Daemon (async)",
            "tuples": N_TUPLES, "checks": len(got), "wrong": wrong, "generate_s": gen_s,
            "store_load_s": load_s, "batch_posts": len(post_ms), "batch_sheds": sheds,
            "batch_s": batch_s, "post_p50_ms": _pct_ms(post_ms, 0.5),
            "gets": len(lat), "get_p50_ms": _pct_ms(lat, 0.5), "get_p99_ms": _pct_ms(lat, 0.99),
            "lanes_threaded_get": {k: report.get("lanes", {}).get("a", {}).get(k) for k in
                                   ("p50_ms", "p99_ms", "alone_p50_ms", "alone_p99_ms")},
            "labels_landed": bool(labels), "build_path": engine.build_info.get("path"),
            "launches": launches,
        }
        log(f"cli (a): {json.dumps(out['a'])}")

        # (e) refusals before the card is touched, in processes that see no
        # card: started now, they run beside (b) and (c), which time nothing
        # a few CPU-bound processes would move; read after (d)
        bad = {"unknown key": ({"serve": {"nope": 1}}, "Additional properties are not allowed"),
               "wrong type": ({"serve": {"read": {"port": "x"}}}, "is not of type 'integer'"),
               "replica": ({"serve": {"role": "replica"}}, "ROADMAP A10")}
        for name, (cfg, _) in bad.items():
            path = work / f"bad-{name.replace(' ', '-')}.json"
            path.write_text(json.dumps({"namespaces": [], **cfg}))
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "keto_tpu_torch", "serve", "-c", str(path)],
                cwd=str(Path(__file__).resolve().parent),
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        # (b) Watch over the write port's commits
        wm = store.watermark()
        keep = _WatchReader(d.read_port, wm)
        if keep.status != 200:
            fail(f"GET /watch answered {keep.status}")
        denied = [i for i, e in enumerate(expected) if not e][:CLI_WATCH_WRITES * CLI_WATCH_TUPLES]
        writer = _Conn(d.write_port)
        acked = []
        for w in range(CLI_WATCH_WRITES):
            part = denied[w * CLI_WATCH_TUPLES:(w + 1) * CLI_WATCH_TUPLES]
            sent = time.time()
            status, _, hdrs = writer.req("PATCH", "/relation-tuples", [
                {"action": "insert", "relation_tuple": queries[i].to_json()} for i in part])
            if status != 204:
                fail(f"PATCH /relation-tuples answered {status}")
            acked.append((int(hdrs["X-Keto-Snaptoken"]), sent))
        writer.close()
        if not keep.wait(CLI_WATCH_WRITES):
            fail(f"the stream delivered {len(keep.lines)} of {CLI_WATCH_WRITES} groups")
        time.sleep(0.3)  # more than one poll: nothing else may arrive
        tokens = [int(m["snaptoken"]) for _, m in keep.lines]
        if tokens != [t for t, _ in acked] or any(len(m["changes"]) != CLI_WATCH_TUPLES
                                                   for _, m in keep.lines):
            fail(f"groups {tokens} against commits {[t for t, _ in acked]}")
        # from the client's send of the write to its line on the stream (the
        # commit's own stamp rides a line only when the handler registered
        # it before the hub's poll emitted the group, as in the reference)
        line_ms = [(rt - sent) * 1e3 for (rt, _), (_, sent) in zip(keep.lines, acked)]
        emit_ms = [(m["emitted_at"] - m["committed_at"]) * 1e3 for _, m in keep.lines
                   if "committed_at" in m]
        resume = _WatchReader(d.read_port, acked[4][0])
        resume.wait(CLI_WATCH_WRITES - 5)
        time.sleep(0.3)
        resumed = [int(m["snaptoken"]) for _, m in resume.lines]
        resume.close()
        if resumed != [t for t, _ in acked[5:]]:
            fail(f"a resume from the 5th token yielded {resumed}")
        # nothing asked the engine for a snapshot since the writes: it is
        # behind them, and the GC below leaves it behind the horizon
        engine_wm = engine._snapshot.snapshot_id
        if engine_wm >= store.watermark():
            fail("the engine caught up with the writes before the GC")
        rebuilds0 = engine.counters().get("full_rebuilds", 0)
        store.watch_log_retention_s = 1e-3
        time.sleep(0.01)
        # a pass prunes at most serve.watch_gc_max_rows: drain the backlog
        pruned, n = 0, -1
        while n:
            n = store.gc_watch_logs()
            pruned += n
        store.watch_log_retention_s = 3600.0
        gone = _Conn(d.read_port)
        status, body, _ = gone.req("GET", f"/watch?snaptoken={wm}")
        gone.close()
        if status != 410:
            fail(f"a resume below the GC'd horizon answered {status}, not 410")
        t1 = time.monotonic()
        after = engine.batch_check(queries)
        rebuild_s = time.monotonic() - t1
        want = list(expected)
        for i in denied:
            want[i] = True
        rebuilt = engine.counters().get("full_rebuilds", 0) - rebuilds0
        wrong_after = sum(a != w for a, w in zip(after, want))
        if wrong_after or rebuilt != 1:
            fail(f"after the GC: {wrong_after} wrong, {rebuilt} full rebuilds (want 1)")
        out["b"] = {
            "writes": CLI_WATCH_WRITES, "tuples_each": CLI_WATCH_TUPLES, "groups": tokens,
            "send_to_line_ms": {"p50": _pct_ms(line_ms, 0.5), "max": round(max(line_ms), 3)},
            "commit_to_emit_ms": {"p50": _pct_ms(emit_ms, 0.5),
                                  "max": round(max(emit_ms), 3) if emit_ms else None,
                                  "lines_with_commit_stamp": len(emit_ms)},
            "resumed_from": acked[4][0], "resumed": resumed, "gc_pruned": pruned,
            "engine_watermark_at_gc": engine_wm,
            "below_horizon": status, "full_rebuilds": rebuilt, "rebuild_and_check_s": rebuild_s,
            "wrong_after": wrong_after,
        }
        log(f"cli (b): {json.dumps(out['b'])}")

        # (c) a namespace hot-reloaded from the watched directory
        (ns_dir / "cli-hot.json").write_text(json.dumps(CLI_HOT_NS))
        t1 = time.monotonic()
        w = _Conn(d.write_port)
        while True:
            status, _, _ = w.req("PATCH", "/relation-tuples", [
                {"action": "insert", "relation_tuple": RelationTuple.from_string(t).to_json()}
                for t in CLI_HOT_TUPLES])
            if status == 204 or time.monotonic() - t1 > CLI_RELOAD_S:
                break
            time.sleep(0.05)
        reload_s = time.monotonic() - t1
        w.close()
        if status != 204:
            fail(f"the hot-reloaded namespace refused writes for {reload_s:.1f}s: {status}")
        r = _Conn(d.read_port)

        def hot_checks():
            kernels.reset_counts()
            codes = [r.req("GET", "/check?" + RelationTuple.from_string(c).to_url_query()
                           + "&latest=true")[0] for c, _ in CLI_HOT_CHECKS]
            return codes, dict(kernels.COUNTS)

        codes, hot_launches = hot_checks()
        if codes != [200 if a else 403 for _, a in CLI_HOT_CHECKS]:
            fail(f"checks on the hot-reloaded namespace answered {codes}")
        launched = sum(hot_launches[k] for k in ("seed", "check_run", "answer_pack", "label_step"))
        if on_card and not launched:
            fail(f"the checks on the hot-reloaded namespace launched nothing: {hot_launches}")
        (ns_dir / "zz-bad.json").write_text(json.dumps({"id": "x"}))
        time.sleep(1.5)  # past one of the watcher's 1 s polls
        names = sorted(n.name for n in reg.namespace_manager().namespaces())
        codes_bad, _ = hot_checks()
        r.close()
        if names != sorted([n.name for n in RBAC_NAMESPACES] + [CLI_HOT_NS["name"]]) \
                or codes_bad != codes:
            fail(f"a malformed file did not keep the last good set: {names}, {codes_bad}")
        out["c"] = {"reload_s": reload_s, "codes": codes, "launches": hot_launches,
                    "after_malformed": names}
        log(f"cli (c): {json.dumps(out['c'])}")

        serving = True
        t1 = time.monotonic()
        d.drain_and_shutdown()
        keep.thread.join(timeout=10)
        if keep.thread.is_alive():
            fail("the drain did not close the open watch stream")
        out["drain_s"] = time.monotonic() - t1
        keep.close()
    finally:
        if not serving:
            d.shutdown()
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()

    # (d) the CLI as its own process, with a torch.profiler trace
    trace_dir = work / "trace"
    cli_cfg = work / "cli.json"
    cli_cfg.write_text(json.dumps({
        "dsn": "memory", "namespaces": [n.to_json() for n in CAT_VIDEOS_NAMESPACES],
        "serve": {"read": {"host": "127.0.0.1", "port": 0},
                  "write": {"host": "127.0.0.1", "port": 0}},
        "profiling": "trace"}))
    before = _kernel_files()
    env = dict(os.environ, KETO_TPU_TRACE_DIR=str(trace_dir))
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-m", "keto_tpu_torch", "serve", "-c", str(cli_cfg)]
                            + ([] if on_card else ["--device", device]),
                            cwd=str(Path(__file__).resolve().parent), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        import re
        import select

        # the banner comes once both ports answer; a process that never
        # prints it fails the phase instead of holding the call
        ready, _, _ = select.select([proc.stdout], [], [], 180.0)
        first = proc.stdout.readline() if ready else ""

        m = re.search(r"read :(\d+), write :(\d+), device (\S+), graph shards", first)
        if not m:
            fail(f"the CLI printed {first!r}; stderr {proc.stderr.read()[-2000:]}")
        rp, wp, dev = int(m.group(1)), int(m.group(2)), m.group(3)
        c = _Conn(rp)
        status = c.req("GET", "/check?" + RelationTuple.from_string(
            CAT_VIDEOS_CHECKS[0][0]).to_url_query())[0]
        boot_s = time.monotonic() - t0
        if status != 403:
            fail(f"the CLI's first check on an empty store answered {status}")
        w = _Conn(wp)
        from keto_tpu_torch.workloads import parse_tuples

        for t in parse_tuples(CAT_VIDEOS_TUPLES):
            if w.req("PUT", "/relation-tuples", t.to_json())[0] != 201:
                fail(f"the CLI refused PUT {t}")
        w.close()
        codes = [c.req("GET", "/check?" + RelationTuple.from_string(q).to_url_query()
                       + "&latest=true")[0] for q, _ in CAT_VIDEOS_CHECKS]
        c.close()
        if codes != [200 if a else 403 for _, a in CAT_VIDEOS_CHECKS]:
            fail(f"the CLI's cat-videos checks answered {codes}")
        t1 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=5.0 + CLI_EXIT_MARGIN_S)
        exit_s = time.monotonic() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    if rc != 0:
        fail(f"the CLI exited {rc} after SIGTERM: {err[-2000:]}")
    table = (trace_dir / "kernels.txt").read_text() if (trace_dir / "kernels.txt").exists() else ""
    trace = (trace_dir / "trace.json").read_text() if (trace_dir / "trace.json").exists() else ""
    named = sorted({wrapper for k, wrapper in CLI_TRACE_KERNELS.items()
                    if k in table or k in trace})
    if on_card and (dev not in ("cuda", "cuda:0") or not named):
        fail(f"the CLI's trace names no hand-written kernel (device {dev}); "
             f"{table[:1500]}")
    reused = _kernel_files() == before
    if on_card and not reused:
        fail("the CLI process built the kernel library again")
    out["d"] = {"device": dev, "boot_to_first_check_s": boot_s, "cat_videos": codes,
                "sigterm_exit_s": exit_s, "exit": rc, "trace_names": named,
                "trace_bytes": len(trace), "library_reused": reused}
    log(f"cli (d): {json.dumps(out['d'])}")

    refused = {}
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=60)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        refused[name] = p.returncode
        if p.returncode == 0 or bad[name][1] not in err or "CUDA" in err:
            fail(f"{name}: exit {p.returncode}, {err[-500:]}")
    try:
        Registry(Config(overrides={"namespaces": [], "serve.role": "replica"}, env={}))
        fail("serve.role: replica built a registry")
    except ValueError as e:
        if "ROADMAP A10" not in str(e):
            fail(f"serve.role: replica raised {e}")
    out["e"] = {"exits": refused}
    out["seconds"] = time.monotonic() - t_phase
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    log(f"cli (e): {json.dumps(out['e'])}; phase {out['seconds']:.1f}s")
    report["cli"] = out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated phases to run (default: all of {','.join(PHASES)}); "
                         "lanes, labels, hbm and cli need main, shard needs main and deep, "
                         "cache, list and explain need deep, write needs list")
    args = ap.parse_args(argv)
    phases = set(args.only.split(","))
    unknown = phases - set(PHASES)
    missing = [f"{p} needs {need}" for p in sorted(phases & set(PHASE_NEEDS))
               for need in PHASE_NEEDS[p] if need not in phases]
    if unknown or missing:
        print(f"chip_smoke: --only {args.only}: unknown phases {sorted(unknown)}, {missing}",
              file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from keto_tpu_torch import _build
    from keto_tpu_torch.check import kernels

    card = card_line()
    name = torch.cuda.get_device_name(0)
    rate, int_rate = card_rates(name)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"memory rate used for bounds {rate / 1e12:.2f} TB/s, int32 compares "
        f"{int_rate / 1e12:.2f} Top/s")
    t0 = time.monotonic()
    _build.build(verbose=True)
    _build.lib()
    log(f"build: {_build.library_path().name} from {[p.name for p in _build.sources()]} in "
        f"{time.monotonic() - t0:.2f}s (nvcc {_build.build_seconds:.2f}s)")
    if _build.build_seconds:
        log(f"build: one nvcc over every source instead: {serial_build_seconds(_build):.2f}s")
    t0 = time.monotonic()
    _build.host_lib()
    log(f"build: host library {_build.host_library_path().name} from "
        f"{[p.name for p in _build.host_sources()]} in {time.monotonic() - t0:.2f}s "
        f"(g++ {_build.host_build_seconds:.2f}s; {_build.compiler_version()}; "
        f"{' '.join(_build.HOST_COMPILE_FLAGS + _build.HOST_LINK_FLAGS)})")

    report: dict = {}
    t_start = time.monotonic()
    if "parity" in phases:
        phase_parity(torch, kernels, report)
    rows = []
    main_keep = None
    if "main" in phases:
        engine, snap, queries, main_ctx, rbac_ctx = phase_main(torch, kernels, report)
        rows, step = kernel_rows(torch, kernels, engine, snap, queries, rate, report["launches"])
        report["check_step"] = step
        log(json.dumps({"main": report["main"]}))
        if "lanes" in phases:
            phase_lanes(torch, kernels, report, engine, queries, main_ctx)
            log(json.dumps({"lanes": report["lanes"]}))
            log(f"elapsed {time.monotonic() - t_start:.1f}s")
        if "labels" in phases:
            phase_labels(torch, kernels, report, main_ctx, queries)
            log(json.dumps({"labels": report["labels"]}))
        if "hbm" in phases:
            phase_hbm(torch, kernels, report, main_ctx, queries, rbac_ctx)
            log(json.dumps({"hbm": report["hbm"]}))
            log(f"elapsed {time.monotonic() - t_start:.1f}s")
        if "cli" in phases:
            phase_cli(torch, kernels, report, queries, main_ctx)
            log(json.dumps({"cli": report["cli"]}))
            log(f"elapsed {time.monotonic() - t_start:.1f}s")
        # the shard phase holds its config 3 run against this engine's; the
        # cache phase saves and reloads its store
        main_keep = (engine, queries, main_ctx) if phases & {"shard", "cache"} else None
        del engine, snap, queries, main_ctx, rbac_ctx
    log(f"elapsed {time.monotonic() - t_start:.1f}s")
    if "deep" in phases:
        engine, snap, captured, launches, store, deep_q, deep_got, ctx, sort_keys = phase_deep(
            torch, kernels, report)
        rows += label_rows(torch, kernels, snap, engine, captured, launches, rate, int_rate)
        log(json.dumps({"deep": report["deep"]}))
        del snap, captured
        if "hbm" in phases:
            # the ledger at config 4 on deep's engine, with no rebuild
            report["hbm_deep"] = ledger_line(torch, engine, report["deep"]["alloc_before_engine"])
            log(f"hbm (a) config 4: {json.dumps(report['hbm_deep'])}")
        log(f"elapsed {time.monotonic() - t_start:.1f}s")
        cache_launches = None
        if "cache" in phases:
            cache_launches = phase_cache(torch, kernels, report,
                                         (engine, store, deep_q, deep_got, ctx), main_keep)
            log(json.dumps({"cache": report["cache"]}))
            log(f"elapsed {time.monotonic() - t_start:.1f}s")
        if "shard" in phases:
            rows += phase_shard(torch, kernels, report, main_keep,
                                (engine, store, deep_q, deep_got, ctx), rate, int_rate)
            log(f"elapsed {time.monotonic() - t_start:.1f}s")
        if main_keep is not None:
            main_keep[0].close()
            main_keep = None
        if "list" in phases:
            lst, lcap, ll = phase_list(torch, kernels, report, engine, store, ctx)
            rows += list_sort_rows(torch, kernels, lcap, ll, launches, sort_keys, rate,
                                   cache_launches)
            log(json.dumps({"list": report["list"]}))
            del lcap
            log(f"elapsed {time.monotonic() - t_start:.1f}s")
        if "explain" in phases:
            pairs, k4_launches = phase_explain(torch, kernels, report, engine, store, deep_q,
                                               deep_got, ctx)
            rows += witness_rows(torch, kernels, engine.snapshot(), pairs, k4_launches, rate,
                                 int_rate)
            log(json.dumps({"explain": report["explain"]}))
            log(f"elapsed {time.monotonic() - t_start:.1f}s")
        if "list" in phases:
            if "write" in phases:
                slots, wl, wcap = phase_write(torch, kernels, report, engine, store, deep_q,
                                              lst, ctx)
                rows += slot_rows(torch, kernels, slots, wl, rate)
                rows.append(list_overlay_row(torch, wcap, wl, rate))
                log(json.dumps({"write": report["write"]}))
                del slots, wcap
                log(f"elapsed {time.monotonic() - t_start:.1f}s")
            del lst
        engine.close()
        del engine, store, deep_q, deep_got, ctx, sort_keys
    if "serve" in phases:
        phase_serve(kernels, report)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
