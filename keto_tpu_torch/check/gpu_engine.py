"""Batched check engine: multi-source bit-packed BFS on one GPU.

The core of ``TpuCheckEngine`` (keto_tpu/check/tpu_engine.py:1045) on the
BFS route: up to 32·W queries share one ``int32[num_int+1, W]`` reached
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
store's watermark moved — read-your-writes), bucket upload, host
resolution, slicing, one device→host copy per batch, the exact truncation
re-run ladder and the grow-only ``block_iters`` retune. Not here: labels,
delta overlays, compaction, the snapshot cache, sharding, the streaming
pipeline and slice controller, and any CPU fallback: a device error raises.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.pack import _WORD_WIDTHS, _ceil_pow2, pack_chunk, pack_entries
from keto_tpu_torch.graph.carry import device_graph_from_arrays, snapshot_arrays
from keto_tpu_torch.graph.snapshot import WILDCARD, GraphSnapshot, build_snapshot
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.device import resolve_device
from keto_tpu_torch.x.errors import ErrNamespaceUnknown

_log = logging.getLogger("keto_tpu_torch.check")

#: distinct-from-None cache sentinel for namespace resolution
_UNSET = object()


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
            self._snapshot = new
            return new

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
            for a, b in bounds:
                dev, host_ans = self._device_batch(snap, sd, tg, multi, a, b, W, it_cap=it_cap)
                yield dev, host_ans, b - a

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

    def _collect(self, results, n: int):
        """Fetch every dispatched slice in ONE device→host copy and unpack.
        Returns ``(decisions, max_iters, truncated query indices)`` —
        queries in a truncated slice carry no decision (``_run_exact``
        re-runs them)."""
        devs = [d for d, _, _ in results if d is not None]
        flat = None
        if devs:
            flat = torch.cat(devs).cpu().numpy().view(np.uint32)
        out = np.zeros(n, dtype=bool)
        max_iters = 0
        trunc_idx: list[int] = []
        pos = 0
        off = 0
        for dev, host_ans, nq in results:
            if dev is None:
                out[pos : pos + nq] = host_ans[:nq]
            else:
                f = flat[off : off + dev.shape[0]]
                off += dev.shape[0]
                bits, it, tr = self._decode_packed(f, host_ans, nq)
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
