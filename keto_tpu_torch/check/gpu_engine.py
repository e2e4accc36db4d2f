"""Batched check engine: 2-hop labels and multi-source bit-packed BFS on one GPU.

The core of ``TpuCheckEngine`` (keto_tpu/check/tpu_engine.py:1045), on two
routes. The **label route** (the default, as in the reference) answers
every label-certifiable query with ONE intersection step (``label_step``)
over a 2-hop label index built per snapshot (keto_tpu_torch/graph/labels.py
on the host, keto_tpu_torch/graph/label_build.py on the card past
``labels_device_min_edges`` ELL slots), and sends the rest to the **BFS
route** as a compacted sub-batch. On the BFS route up to 32·W queries
share one ``int32[num_int+1, W]`` reached
bitmap (bit ``q%32`` of word ``q//32`` in row ``v`` = "query q reached node
v"), a pull step ORs each active row's interior in-neighbours, the loop
runs to the reachability fixpoint, and the answer for query q is its target
bit of the fixpoint's pull plus the host-propagated one-hop term — "reached
via ≥ 1 edge", the reference's rule that a subject only matches via an
actual tuple. The device programs are keto_tpu_torch/check/kernels.py.

Decision parity with the reference engine (reference
internal/check/engine.go): an unknown namespace is denied, not an error;
empty namespace/object/relation fields wildcard the start expansion while
subject matching stays literal; an empty relation in a subject set never
fabricates a transitive grant.

Kept against the reference engine: snapshot (a full rebuild whenever the
store's watermark moved — read-your-writes), bucket upload, the label
build overlapped on a background thread and installed only onto the exact
snapshot it was built for, host resolution, the label router, slicing,
one device→host copy per batch, the exact truncation re-run ladder and
the grow-only ``block_iters`` retune. Not here: delta overlays and label
patches, compaction, the snapshot cache, sharding, the HBM governor, the
streaming pipeline and slice controller, and any CPU fallback: a device
error raises, and a failed label build is raised by the next check and by
``labels_settled()`` instead of leaving serving quietly on BFS.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.pack import (
    _WORD_WIDTHS,
    _ceil_pow2,
    _entry_pad,
    pack_chunk,
    pack_entries,
)
from keto_tpu_torch.graph import label_build
from keto_tpu_torch.graph.carry import device_graph_from_arrays, snapshot_arrays
from keto_tpu_torch.graph.labels import build_labels
from keto_tpu_torch.graph.snapshot import WILDCARD, GraphSnapshot, build_snapshot
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.device import resolve_device
from keto_tpu_torch.x.errors import ErrNamespaceUnknown

_log = logging.getLogger("keto_tpu_torch.check")

#: distinct-from-None cache sentinel for namespace resolution
_UNSET = object()


class _HybridSlice:
    """Device output(s) of one label-routed slice: the label kernel's
    packed bits for the whole slice (None when every query fell back),
    plus — when some queries fell back — a BFS sub-batch output and the
    slice positions it answers."""

    __slots__ = ("label_dev", "bfs_dev", "bfs_pos")

    def __init__(self, label_dev, bfs_dev=None, bfs_pos=None):
        self.label_dev = label_dev
        self.bfs_dev = bfs_dev
        self.bfs_pos = bfs_pos

    def parts(self) -> list:
        return [p for p in (self.label_dev, self.bfs_dev) if p is not None]


class TorchCheckEngine:
    """Check engine answering batched queries on the device graph.

    ``store`` must expose ``snapshot_rows() -> (rows, watermark)`` and
    ``watermark()`` (keto_tpu_torch/persistence/memory.py); ``namespaces``
    is a namespace.Manager or a zero-arg callable returning the current one.
    ``device`` defaults to ``cuda`` and must be named ``"cpu"`` to run the
    plain PyTorch path on the host.
    """

    def __init__(
        self,
        store,
        namespaces,
        *,
        device: Optional[Union[str, torch.device]] = None,
        it_cap: int = 4096,
        max_batch: int = 32 * _WORD_WIDTHS[-1],
        mem_budget_bytes: int = 10 << 30,
        peel_seed_cap: float = 4.0,
        labels_enabled: bool = True,
        labels_max_width: int = 64,
        labels_landmarks: int = 0,
        labels_device_build: bool = True,
        labels_min_gain: float = 0.0,
        labels_batch: int = 64,
        labels_device_min_edges: int = label_build.DEFAULT_MIN_EDGES,
    ):
        if it_cap < 1:
            raise ValueError("it_cap must be >= 1 (the answer pull needs one step)")
        self.device = resolve_device(device)
        self._store = store
        if isinstance(namespaces, namespace_pkg.Manager):
            self._nm: Callable[[], namespace_pkg.Manager] = lambda: namespaces
        else:
            self._nm = namespaces
        self._it_cap = it_cap
        self._max_batch = max_batch
        # bound on the BFS workspace (~3 W-wide bitmaps over interior rows):
        # huge graphs narrow the batch width instead of overshooting memory
        self._mem_budget = mem_budget_bytes
        self._peel_seed_cap = peel_seed_cap
        # pulls per convergence observation, grown to the workload's depth
        self._block_iters = 8
        self._lock = threading.Lock()
        self._snapshot: Optional[GraphSnapshot] = None
        # 2-hop labels: built per snapshot, served as the one-step route;
        # BFS answers what the labels cannot certify. The knobs and their
        # defaults are the reference's (tpu_engine.py:1097-1168)
        self._labels_enabled = bool(labels_enabled)
        self._labels_max_width = int(labels_max_width)
        self._labels_landmarks = int(labels_landmarks)
        self._labels_device_build = bool(labels_device_build)
        self._labels_min_gain = float(labels_min_gain)
        self._labels_batch = int(labels_batch)
        self._labels_device_min_edges = int(labels_device_min_edges)
        self._label_build_thread: Optional[threading.Thread] = None
        #: the exception of the last background label build, raised by the
        #: next check and by labels_settled() (never a quiet BFS fallback)
        self._label_build_error: Optional[Exception] = None
        #: transient device bytes of the last device label build (what the
        #: reference plans against its HBM governor, which is not ported)
        self.label_build_bytes = 0
        #: BuildInfo of the last device label build
        self.label_build_info: Optional[label_build.BuildInfo] = None
        # route counters, counted where the reference counts them:
        # label_checks, label_fallbacks, label_builds, label_device_builds
        self._counters: collections.Counter = collections.Counter()
        self._counter_lock = threading.Lock()

    # -- snapshot lifecycle --------------------------------------------------

    def snapshot(self) -> GraphSnapshot:
        """Device snapshot current with the store's watermark: rebuilt in
        full (and its buckets uploaded) whenever the watermark moved, so
        every acknowledged write is visible to the next check."""
        snap = self._snapshot
        if snap is not None and snap.snapshot_id == self._store.watermark():
            return snap
        with self._lock:
            snap = self._snapshot
            rows, wm = self._store.snapshot_rows()
            if snap is not None and snap.snapshot_id == wm:
                return snap
            wild_ns_ids = frozenset(n.id for n in self._nm().namespaces() if n.name == "")
            new = build_snapshot(rows, wm, wild_ns_ids, peel_seed_cap=self._peel_seed_cap)
            arrays, meta = snapshot_arrays(new)
            new.device = device_graph_from_arrays(arrays, meta, self.device)
            # the labels phase overlaps serving: BFS answers until the
            # index installs onto this very snapshot
            self._start_label_build(new)
            self._snapshot = new
            return new

    # -- counters ------------------------------------------------------------

    def _incr(self, name: str, by: int = 1) -> None:
        with self._counter_lock:
            self._counters[name] += by

    def counters(self) -> dict:
        """The route counters (``label_checks``, ``label_fallbacks``,
        ``label_builds``, ``label_device_builds``) since construction."""
        with self._counter_lock:
            return dict(self._counters)

    # -- 2-hop labels (keto_tpu_torch/graph/labels.py) -------------------------

    #: landmark auto-cap of the HOST build: with ``labels_landmarks == 0``
    #: it processes min(num_int, this) nodes; the device build has no cap
    LABELS_AUTO_CAP = 131072

    def _interior_ell_slots(self, snap: GraphSnapshot) -> int:
        """Padded interior ELL edge slots — the size signal the device-build
        gate compares against ``labels_device_min_edges``."""
        return sum(int(b.n) * int(np.asarray(b.nbrs).shape[1]) for b in snap.buckets)

    def _build_label_index(self, snap: GraphSnapshot):
        """Construct the 2-hop index for ``snap``. On the device (batched
        sweeps, no landmark cap; ``labels_min_gain`` bounds the build) once
        the graph has ``labels_device_min_edges`` interior ELL slots; on
        the host (per-landmark BFS, ``LABELS_AUTO_CAP``) below that or with
        ``labels_device_build=False`` — never after a device error, which
        propagates. Entry-identical either way."""
        n = snap.num_int
        landmarks = self._labels_landmarks
        if (
            self._labels_device_build
            and n > 0
            and self._interior_ell_slots(snap) >= self._labels_device_min_edges
        ):
            need = label_build.estimate_build_bytes(n, self._labels_max_width, self._labels_batch)
            self.label_build_bytes = need
            _log.info("device label build: %d interior rows, ~%d transient device bytes", n, need)
            idx, info = label_build.device_build_labels(
                snap,
                max_width=self._labels_max_width,
                landmarks=landmarks,
                min_gain=self._labels_min_gain,
                batch=self._labels_batch,
                device=self.device,
            )
            self.label_build_info = info
            self._incr("label_device_builds")
            if info.truncated:
                self._note_label_truncation(info.truncated, idx)
            return idx
        if landmarks == 0:
            landmarks = min(n, self.LABELS_AUTO_CAP)
        idx = build_labels(snap, max_width=self._labels_max_width, landmarks=landmarks)
        if landmarks < n:
            self._note_label_truncation("cap", idx)
        return idx

    @staticmethod
    def _note_label_truncation(reason: str, idx) -> None:
        _log.warning(
            "label build truncated (%s): %d/%d landmarks processed, coverage_ratio=%.4f — "
            "uncovered deep checks fall back to the BFS kernels",
            reason, idx.n_landmarks, idx.n, idx.coverage,
        )

    def _start_label_build(self, snap: GraphSnapshot) -> None:
        """Kick the label construction for ``snap`` on a background thread;
        the engine serves ``snap`` on the BFS route until the index installs
        under the lock. The thread launches on its own current stream (the
        default stream, as serving does), so its kernels and serving's
        serialise on the card. A failure is kept on the engine and raised
        by the next check and by ``labels_settled()``."""
        if not self._labels_enabled:
            return
        self._label_build_error = None

        def work():
            try:
                idx = self._build_label_index(snap)
            except Exception as e:  # kept on the engine and raised by the next check
                _log.error("background label build failed", exc_info=True)
                if self._label_build_thread is threading.current_thread():
                    self._label_build_error = e
                return
            with self._lock:
                self._install_labels_locked(snap, idx)

        t = threading.Thread(target=work, name="label-build", daemon=True)
        self._label_build_thread = t
        t.start()

    def _install_labels_locked(self, snap: GraphSnapshot, idx) -> None:
        """Land a background-built index (caller holds the lock) on the
        snapshot it was built for, and upload it only while that snapshot
        is the one being served: a later snapshot starts its own build, and
        an index never serves another snapshot's edges."""
        snap.labels = idx
        self._incr("label_builds")
        if self._snapshot is snap:
            self._upload_labels(snap)

    def _label_build_wait(self) -> None:
        """Join the in-flight background label build."""
        t = self._label_build_thread
        if t is not None and t.is_alive():
            t.join()

    def _raise_label_error(self) -> None:
        err = self._label_build_error
        if err is not None:
            raise RuntimeError("the label build failed") from err

    def labels_settled(self) -> bool:
        """Force the snapshot refresh and block until its label build has
        installed; raises the build's error if it failed. Returns whether
        the serving snapshot carries an index."""
        self.snapshot()
        self._label_build_wait()
        self._raise_label_error()
        snap = self._snapshot
        return snap is not None and snap.labels is not None

    def _upload_labels(self, snap: GraphSnapshot) -> None:
        snap.device_labels = tuple(
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)
            for a in (snap.labels.out_lab, snap.labels.in_lab)
        )

    def _labels_usable(self, snap: GraphSnapshot) -> bool:
        """Route checks through the label index on this snapshot?"""
        return self._labels_enabled and snap.labels is not None and snap.device_labels is not None

    # -- resolution ----------------------------------------------------------

    def _ns_resolver(self):
        """Per-batch namespace-name → id resolver with a cache: ``None`` =
        unknown (→ denied, engine.go:76-77), ``WILDCARD`` = empty name."""
        nm = self._nm()
        cache: dict = {}

        def _ns(name: str):
            hit = cache.get(name, _UNSET)
            if hit is not _UNSET:
                return hit
            if name == "":
                r: object = WILDCARD
            else:
                try:
                    r = nm.get_namespace_by_name(name).id
                except ErrNamespaceUnknown:
                    r = None
            cache[name] = r
            return r

        return _ns

    def _subject_target(self, snap: GraphSnapshot, rt: RelationTuple, ns_of):
        """Resolve a query's subject to its target device row: the id, -1
        when no such node exists (target unreachable), or ``None`` when the
        subject itself forces a deny (nil subject, unknown subject
        namespace)."""
        sub = rt.subject
        if type(sub) is SubjectID:
            dev = snap.resolve_leaf(sub.id)
            return -1 if dev is None else dev
        if isinstance(sub, SubjectSet):
            sns_id = ns_of(sub.namespace)
            if sns_id is None:
                return None
            if sns_id == WILDCARD:
                # subjects are matched literally; an empty subject
                # namespace can only equal a stored subject in a
                # namespace named ""
                wild_list = list(snap.wild_ns_ids)
                if not wild_list:
                    return -1
                sns_id = wild_list[0]
            dev = snap.resolve_set(sns_id, sub.object, sub.relation)
            return -1 if dev is None else dev
        return None  # nil subject → denied

    def _resolve_specials(self, snap, tuples, indices, sd, tg, multi):
        """Wildcard/pattern queries, resolved in bulk through the snapshot's
        family-grouped sorted indexes (``resolve_starts_bulk``); subjects
        literally. Results splice into the caller's bulk arrays."""
        _ns = self._ns_resolver()
        live: list[int] = []
        pats: list[tuple] = []
        for i in indices:
            rt = tuples[i]
            ns_id = _ns(rt.namespace)
            if ns_id is None:
                continue  # unknown namespace → denied
            live.append(i)
            pats.append((ns_id, rt.object, rt.relation))
        if not live:
            return
        starts_l = snap.resolve_starts_bulk(pats)
        ni = snap.num_int
        sbase = snap.sink_base
        nl = snap.num_live
        for i, starts in zip(live, starts_l):
            if starts.size == 0:
                continue  # no matching start node → denied
            t = self._subject_target(snap, tuples[i], _ns)
            if t is None:
                continue  # nil subject / unknown subject namespace → denied
            if 0 <= t < nl:
                tg[i] = t
            sd[i] = -2
            # interior starts seed the bitmap; sink starts (no out-edges)
            # contribute nothing; peeled/static starts are host-propagated
            # at pack time (pack_chunk)
            multi[i] = (
                starts[starts < ni],
                starts[((starts >= ni) & (starts < sbase)) | (starts >= nl)],
            )

    def _resolve_bulk_py(
        self, snap: GraphSnapshot, tuples: Sequence[RelationTuple]
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """One host pass resolving every query to device rows.

        Returns ``(sd, tg, multi)``: ``sd[i]`` the single start row (``-1``
        no start — a guaranteed deny; ``-2`` multi-start, rows in
        ``multi``), ``tg[i]`` the target row or ``-1`` when unreachable, and
        ``multi`` ``{i: (live start rows, host-propagated start rows)}`` for
        wildcard-pattern queries.
        """
        n = len(tuples)
        nl = snap.num_live
        sd = np.full(n, -1, np.int64)
        tg = np.full(n, -1, np.int64)
        multi: dict = {}
        resolve_set = snap.interned.resolve_set
        raw2dev = snap.raw2dev
        wild_ids = snap.wild_ns_ids
        _ns = self._ns_resolver()

        special: list[int] = []
        for i, rt in enumerate(tuples):
            ns_id = _ns(rt.namespace)
            if ns_id is None:
                continue  # unknown namespace → denied (engine.go:76-77)
            obj, rel = rt.object, rt.relation
            if ns_id == WILDCARD or ns_id in wild_ids or obj == "" or rel == "":
                special.append(i)  # wildcard pattern → bulk family resolver
                continue
            raw = resolve_set(ns_id, obj, rel)
            if raw < 0:
                continue
            t = self._subject_target(snap, rt, _ns)
            if t is None:
                continue  # nil subject / unknown subject namespace → denied
            if 0 <= t < nl:
                tg[i] = t
            sd[i] = int(raw2dev[raw])
        if special:
            self._resolve_specials(snap, tuples, special, sd, tg, multi)
        return sd, tg, multi

    # -- public API ----------------------------------------------------------

    def batch_check(self, tuples: Sequence[RelationTuple]) -> list[bool]:
        """Answer every query (see ``batch_check_with_token``)."""
        return self.batch_check_with_token(tuples)[0]

    def batch_check_with_token(self, tuples: Sequence[RelationTuple]) -> tuple[list[bool], int]:
        """Decisions plus the id of the snapshot that produced them (the
        snaptoken). Every call reads the latest snapshot, so a check sees
        every write acknowledged before it."""
        snap = self.snapshot()
        self._raise_label_error()
        if snap.n_nodes == 0 or snap.n_edges == 0 or not tuples:
            return [False] * len(tuples), snap.snapshot_id
        out, max_iters = self._run_exact(snap, tuples)
        self._after_batch(max_iters)
        return out.tolist(), snap.snapshot_id

    def subject_is_allowed(self, requested: RelationTuple) -> bool:
        """Single-query convenience with the oracle engine's signature."""
        return self.batch_check([requested])[0]

    # -- batch execution -----------------------------------------------------

    def _cap_limit(self, snap: GraphSnapshot) -> int:
        """Iteration count that can NEVER truncate: monotone bitmaps reach
        the fixpoint in at most one pull per active row, +1 for the
        convergence observation."""
        return snap.num_active + 1

    def _run_exact(
        self, snap: GraphSnapshot, tuples: Sequence[RelationTuple], it_cap: Optional[int] = None
    ) -> tuple[np.ndarray, int]:
        """Dispatch + collect with the exactness guarantee: a truncated
        kernel (frontier still growing at it_cap) never decides a query.
        Affected queries re-run with an escalating cap bounded by
        ``_cap_limit`` — the final rung cannot truncate."""
        cap = it_cap or self._it_cap
        results = list(self._dispatch_slices(snap, tuples, it_cap=cap))
        out, max_iters, trunc_idx = self._collect(results, len(tuples))
        if trunc_idx:
            limit = self._cap_limit(snap)
            if cap >= limit:
                raise RuntimeError(
                    f"BFS truncated at the fixpoint bound (cap={cap}, "
                    f"active rows={snap.num_active})"
                )
            new_cap = min(max(cap * 8, 8), limit)
            _log.info(
                "check BFS hit it_cap=%d; re-running %d queries exactly at cap=%d",
                cap, len(trunc_idx), new_cap,
            )
            redo, redo_iters = self._run_exact(
                snap, [tuples[i] for i in trunc_idx], it_cap=new_cap
            )
            out[np.asarray(trunc_idx)] = redo
            max_iters = max(max_iters, redo_iters)
        return out, max_iters

    def _slice_cap(self, snap: GraphSnapshot) -> int:
        """Queries per device slice: the widest bitmap the workspace budget
        allows (~3 W-wide int32 bitmaps over interior rows)."""
        w_cap = next(
            (w for w in reversed(_WORD_WIDTHS) if (snap.num_int + 1) * 12 * w <= self._mem_budget),
            _WORD_WIDTHS[0],
        )
        return min(self._max_batch, 32 * w_cap)

    def _entry_counts(
        self, snap: GraphSnapshot, sd: np.ndarray, tg: np.ndarray, multi: dict
    ) -> np.ndarray:
        """Per-query device entry counts (seeds + answer gathers) of a
        resolved slice. Host-propagated starts are estimated at one hop of
        out-degree; this only balances sub-chunk boundaries."""
        n = sd.shape[0]
        ni = snap.num_int
        sbase = snap.sink_base
        nl = snap.num_live
        ip = snap.fwd_indptr
        sp_ = snap.sink_indptr
        cnt = np.zeros(n, np.int64)
        m_int = (sd >= 0) & (sd < ni)
        cnt[m_int] = 1
        m_host = ((sd >= ni) & (sd < sbase)) | (sd >= nl)
        if m_host.any():
            s = sd[m_host]
            cnt[m_host] = ip[s + 1] - ip[s]
        has_start = m_int | m_host
        for i, (live, hostp) in multi.items():
            cnt[i] = live.size + hostp.size
            has_start[i] = live.size > 0 or hostp.size > 0
        m_ans = has_start & (tg >= sbase) & (tg < nl)
        if m_ans.any():
            t = tg[m_ans] - sbase
            cnt[m_ans] += sp_[t + 1] - sp_[t]
        return cnt

    def _dispatch_slices(
        self, snap: GraphSnapshot, tuples: Sequence[RelationTuple], it_cap: Optional[int] = None
    ):
        """Resolve + pack + dispatch ``tuples`` in ``_slice_cap`` query
        slices, yielding ``(dev_out | None, host_ans, nq)`` as each slice is
        enqueued. A slice whose fan-out exceeds ``4·B`` device entries is
        sub-chunked at the same width, so entry arrays stay within the
        ``{B, 2B, 4B}`` pad geometries."""
        cap_q = self._slice_cap(snap)
        n = len(tuples)
        for s0 in range(0, n, cap_q):
            s1 = min(s0 + cap_q, n)
            sd, tg, multi = self._resolve_bulk_py(snap, tuples[s0:s1])
            nq = s1 - s0
            W = next(w for w in _WORD_WIDTHS if 32 * w >= nq)
            cap_e = 4 * 32 * W
            cnt = self._entry_counts(snap, sd, tg, multi)
            if int(cnt.sum()) <= cap_e:
                bounds = [(0, nq)]
            else:
                csum = np.concatenate([np.zeros(1, np.int64), np.cumsum(cnt)])
                bounds = []
                i0 = 0
                while i0 < nq:
                    i1 = int(np.searchsorted(csum, csum[i0] + cap_e, side="right")) - 1
                    i1 = max(i0 + 1, min(i1, nq))
                    bounds.append((i0, i1))
                    i0 = i1
            use_labels = self._labels_usable(snap)
            for a, b in bounds:
                # sub-chunks keep the slice width: queries pad, geometry stays
                if use_labels:
                    dev, host_ans = self._device_batch_labeled(
                        snap, sd, tg, multi, a, b, W, it_cap=it_cap
                    )
                else:
                    dev, host_ans = self._device_batch(snap, sd, tg, multi, a, b, W, it_cap=it_cap)
                yield dev, host_ans, b - a

    #: per-query pair-fanout cap on the label route: a query spawning more
    #: pairs than this costs more as intersections than as one BFS rider
    _LABEL_PAIR_CAP = 64

    def _device_batch_labeled(self, snap, sd, tg, multi, i0, i1, W, it_cap=None):
        """The label route for one sub-chunk (tpu_engine.py:4408): resolve
        the chunk with the SAME host machinery as the BFS route
        (``pack_chunk``), answer every label-certifiable query with ONE
        ``label_step``, and ride the rest on a compacted BFS sub-batch.

        The reach0 mapping (keto_tpu_torch/graph/labels.py):

        - a query's **pairs** are (seed row u) × (target-side row r): the
          interior target itself, or a sink target's interior in-neighbour
          gathers (``a_rows``, what the BFS kernel gathers);
        - an e1 seed equal to an interior target would conflate reach0 with
          the "via ≥ 1 edge" rule, so that query falls back; an e2 seed
          equal to the target was reached via a real edge on the host walk,
          so ``host_ans`` already granted it and the pair drops;
        - multi-start queries, uncertifiable pairs (coverage gaps) and
          over-fanout queries fall back.
        """
        idx = snap.labels
        packed, host_ans = pack_chunk(snap, sd, tg, multi, i0, i1, W)
        nq = i1 - i0
        if packed is None:
            return None, host_ans  # nothing reaches any device path
        (e1r, e1q, e2r, e2q, ar, aq, targets) = packed
        ni = snap.num_int
        B = 32 * W
        tq = np.asarray(targets[:nq], np.int64)
        t_int = tq < ni

        fallback = np.zeros(nq, bool)
        for i in multi:
            if i0 <= i < i1:
                fallback[i - i0] = True

        # valid (non-padding) entries; e1/e2 pad with row ni+1, a with ni
        m1 = (e1r != ni + 1) & (e1q < nq)
        m2 = (e2r != ni + 1) & (e2q < nq)
        ma = (ar != ni) & (aq < nq)
        s_rows = np.concatenate([e1r[m1], e2r[m2]]).astype(np.int64)
        s_q = np.concatenate([e1q[m1], e2q[m2]]).astype(np.int64)
        # e1 seed == interior target: reach0 would count the 0-edge path
        e1_rows_v = e1r[m1].astype(np.int64)
        e1_q_v = e1q[m1].astype(np.int64)
        self_hit = t_int[e1_q_v] & (e1_rows_v == tq[e1_q_v])
        if self_hit.any():
            fallback[e1_q_v[self_hit]] = True

        # target-side rows per query: the interior target, or the sink
        # answer-gather rows
        b_rows = np.concatenate([tq[t_int], ar[ma].astype(np.int64)])
        b_q = np.concatenate([np.nonzero(t_int)[0], aq[ma].astype(np.int64)])

        # group both sides by query, then cross-join per query
        so = np.argsort(s_q, kind="stable")
        s_rows, s_q = s_rows[so], s_q[so]
        bo = np.argsort(b_q, kind="stable")
        b_rows, b_q = b_rows[bo], b_q[bo]
        ns = np.bincount(s_q, minlength=nq)
        nr = np.bincount(b_q, minlength=nq)
        over = ns * nr > self._LABEL_PAIR_CAP
        if over.any():
            fallback[over] = True
        # drop both sides of fallback queries before the join
        keep_s = ~fallback[s_q]
        keep_b = ~fallback[b_q]
        s_rows, s_q = s_rows[keep_s], s_q[keep_s]
        b_rows, b_q = b_rows[keep_b], b_q[keep_b]
        ns = np.bincount(s_q, minlength=nq) if s_q.size else np.zeros(nq, np.int64)
        nr = np.bincount(b_q, minlength=nq) if b_q.size else np.zeros(nq, np.int64)

        rep_nr = np.repeat(nr, ns)  # aligned to s_rows
        total = int(rep_nr.sum())
        if total:
            b_starts = np.cumsum(nr) - nr
            base = np.repeat(b_starts[s_q], rep_nr)
            csum = np.cumsum(rep_nr) - rep_nr
            within = np.arange(total) - np.repeat(csum, rep_nr)
            pa = np.repeat(s_rows, rep_nr)
            pb = b_rows[base + within]
            pq = np.repeat(s_q, rep_nr)
            # e2-seed == target pairs: already host-granted (e1 cases fell
            # back above)
            drop = t_int[pq] & (pa == pb)
            if drop.any():
                pa, pb, pq = pa[~drop], pb[~drop], pq[~drop]
            # coverage: a miss on an uncertifiable pair is not a deny
            cert = idx.certifiable(pa, pb)
            if not cert.all():
                bad = np.unique(pq[~cert])
                fallback[bad] = True
                keep = ~fallback[pq]
                pa, pb, pq = pa[keep], pb[keep], pq[keep]
        else:
            pa = pb = pq = np.zeros(0, np.int64)

        n_fb = int(np.count_nonzero(fallback))
        self._incr("label_checks", nq - n_fb)
        if n_fb:
            self._incr("label_fallbacks", n_fb)

        ldev = None
        if pa.size:
            P = _entry_pad(B, pa.size)
            pad = P - pa.size
            entries = np.concatenate([
                pa, np.full(pad, ni, np.int64),
                pb, np.full(pad, ni, np.int64),
                pq, np.zeros(pad, np.int64),
            ]).astype(np.int32)
            out_lab, in_lab = snap.device_labels
            ldev = kernels.label_step(
                out_lab, in_lab, torch.from_numpy(entries).to(self.device), n_pairs=P, B=B
            )

        bfs_dev = None
        bfs_pos = None
        if n_fb:
            pos = np.nonzero(fallback)[0]
            gidx = pos + i0
            multi2 = {j: multi[int(i)] for j, i in enumerate(gidx) if int(i) in multi}
            W2 = next(w for w in _WORD_WIDTHS if 32 * w >= pos.size)
            bfs_dev, _ = self._device_batch(
                snap, sd[gidx], tg[gidx], multi2, 0, pos.size, W2, it_cap=it_cap
            )
            bfs_pos = pos
        if ldev is None and bfs_dev is None:
            return None, host_ans
        return _HybridSlice(ldev, bfs_dev, bfs_pos), host_ans

    def _device_batch(self, snap, sd, tg, multi, i0, i1, force_W=None, it_cap=None):
        """Pack + dispatch one sub-chunk. Returns ``(dev, host_ans)``: the
        kernel's int32[W+2] output still on the device (None when no query
        of the chunk reaches the device) and the host-decided grants."""
        packed, host_ans = pack_chunk(snap, sd, tg, multi, i0, i1, force_W)
        if packed is None:
            return None, host_ans
        buf, sizes = pack_entries(packed)
        g = snap.device
        entries = torch.from_numpy(buf).to(g.device)
        dev = kernels.check_step(
            g.buckets,
            entries,
            sizes=sizes,
            n_active=g.num_active,
            n_int=g.num_int,
            valid_rows=g.valid_rows,
            it_cap=it_cap or self._it_cap,
            block_iters=self._block_iters,
        )
        return dev, host_ans

    @staticmethod
    def _decode_packed(f: np.ndarray, host_ans: np.ndarray, nq: int):
        """Decode one kernel's packed ``uint32[W+2]`` output (decision bits,
        iteration count, truncation flag): device bits ∪ host-decided
        grants. Returns ``(bool[nq], iters, truncated)``."""
        W = f.shape[0] - 2
        lanes = np.arange(32, dtype=np.uint32)
        bits = ((f[:W, None] >> lanes) & 1).astype(bool).ravel()[:nq]
        return bits | host_ans[:nq], int(f[W]), bool(f[W + 1])

    @staticmethod
    def _decode_label_bits(f: Optional[np.ndarray], nq: int) -> np.ndarray:
        """Label kernel output ``uint32[W]`` → bool[nq] (None → zeros)."""
        if f is None:
            return np.zeros(nq, bool)
        lanes = np.arange(32, dtype=np.uint32)
        return ((f[:, None] >> lanes) & 1).astype(bool).ravel()[:nq]

    def _decode_hybrid(self, lab, bfs, bfs_pos, host_ans, nq):
        """Decode one label-routed slice from fetched arrays: label bits for
        the whole slice, BFS sub-batch bits scattered onto their positions.
        Only the BFS part can truncate."""
        out = self._decode_label_bits(lab, nq)
        iters, trunc = 0, False
        if bfs is not None:
            bits2, iters, trunc = self._decode_packed(bfs, host_ans[bfs_pos], bfs_pos.size)
            out[bfs_pos] = bits2
        return out | host_ans[:nq], iters, trunc

    def _collect(self, results, n: int):
        """Fetch every dispatched slice in ONE device→host copy and unpack.
        Returns ``(decisions, max_iters, truncated query indices)`` —
        queries in a truncated slice carry no decision (``_run_exact``
        re-runs them). Label-routed slices add their label output and BFS
        sub-batch to the same copy."""
        devs = []
        for d, _, _ in results:
            if d is not None:
                devs.extend(d.parts() if isinstance(d, _HybridSlice) else [d])
        flat = None
        if devs:
            flat = torch.cat(devs).cpu().numpy().view(np.uint32)
        out = np.zeros(n, dtype=bool)
        max_iters = 0
        trunc_idx: list[int] = []
        pos = 0
        off = 0

        def take(part):
            nonlocal off
            seg = flat[off : off + part.shape[0]]
            off += part.shape[0]
            return seg

        for dev, host_ans, nq in results:
            if dev is None:
                out[pos : pos + nq] = host_ans[:nq]
            else:
                if isinstance(dev, _HybridSlice):
                    lab = take(dev.label_dev) if dev.label_dev is not None else None
                    bfs = take(dev.bfs_dev) if dev.bfs_dev is not None else None
                    bits, it, tr = self._decode_hybrid(lab, bfs, dev.bfs_pos, host_ans, nq)
                else:
                    bits, it, tr = self._decode_packed(take(dev), host_ans, nq)
                out[pos : pos + nq] = bits
                max_iters = max(max_iters, it)
                if tr:
                    trunc_idx.extend(range(pos, pos + nq))
            pos += nq
        return out, max_iters, trunc_idx

    def _after_batch(self, max_iters: int) -> None:
        # adapt the pull-block size so deep workloads converge within few
        # host observations. Grow-only, as the reference: converged steps
        # inside a block are guarded no-ops on the device.
        want = min(32, _ceil_pow2(max_iters + 1))
        if want > self._block_iters:
            self._block_iters = want
