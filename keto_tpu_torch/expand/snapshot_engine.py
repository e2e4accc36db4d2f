"""Snapshot-backed expand engine: a per-level bulk gather over the check
engine's snapshot, then the reference's exact tree built on the host.

The port's counterpart of keto_tpu/expand/tpu_engine.py
(``SnapshotExpandEngine``), named for what it serves: the snapshots of a
``TorchCheckEngine``. The Manager-backed engine (keto_tpu_torch/expand/
engine.py, a copy of keto_tpu/expand/engine.py) queries the store once per
subject-set node per page. This engine answers from the snapshot the check
engine serves, in two phases:

- **Phase A, adjacency capture.** Breadth-first from the root set: ONE
  vectorized gather per level over the snapshot's forward CSR
  (``out_neighbors_bulk``) collects the ordered child list of every set
  node reachable within the depth budget.
- **Phase B, the reference's construction.** The host engine's
  depth-first recursion (pre-order visited-set pruning via
  ``check_and_add_visited``, ``rest_depth <= 1`` leaf conversion, ``None``
  for empty sets) replayed over the captured adjacency. Tree-child order
  equals the Manager's page order because the snapshot's per-node edge
  order keeps the store's row order.

Expand has no device kernel: its output is the edge list itself, so the
host gather over the forward CSR (the array the device layout is built
from) moves the fewest bytes.

Divergences from the Manager-backed engine (the reference's, kept):

- duplicate store rows collapse to one edge: a tuple inserted twice
  yields one child, not two (the same grant set);
- a wildcard-bearing set node's children dedup across the tuples its
  pattern matches;
- a root pattern that exists as no set node concatenates the ordered child
  lists of the matching keys, which can interleave differently from the
  global row order when wildcard-bearing keys also match.

Overlay rules. While a delta overlay is pending the fast path still
serves: the snapshot's overlay adjacency (``ov_fwd``,
keto_tpu_torch/graph/overlay.py) is merged into each node's base child
list **in Manager order** (base children are in subject-sort order, and
overlay children sort by the same subject key, so a two-way ordered merge
gives the Manager's page order); tombstoned base edges are masked by
``out_neighbors_bulk``. Two overlay cases delegate to the Manager-backed
engine: a graph with wildcard-bearing set nodes (their child order is the
global row order, not subject order) and a pattern root with no node of
its own (the same reason, through ``_pattern_children``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.expand.engine import ExpandEngine
from keto_tpu_torch.expand.tree import LEAF, UNION, Tree
from keto_tpu_torch.graph.snapshot import WILDCARD, GraphSnapshot
from keto_tpu_torch.relationtuple.model import Subject, SubjectID, SubjectSet
from keto_tpu_torch.x.errors import ErrNamespaceUnknown
from keto_tpu_torch.x.graph import check_and_add_visited

#: virtual device id for a root pattern that exists as no set node
_PATTERN_ROOT = -1


class SnapshotExpandEngine:
    """Expand over a ``TorchCheckEngine``'s snapshots.

    The snapshots and their freshness (read-your-writes through the store
    watermark) are the check path's, so an expand issued after a write sees
    the write exactly as a check does.
    """

    def __init__(self, check_engine, namespaces):
        self._engine = check_engine
        if isinstance(namespaces, namespace_pkg.Manager):
            self._nm: Callable[[], namespace_pkg.Manager] = lambda: namespaces
        else:
            self._nm = namespaces
        #: exact-order engine for overlay-pending snapshots (see module doc)
        self._manager_engine = ExpandEngine(check_engine._store)

    # -- public API (host engine signature) ----------------------------------

    def build_tree(self, subject: Subject, rest_depth: int) -> Optional[Tree]:
        if rest_depth <= 0:
            return None
        if not isinstance(subject, SubjectSet):
            return Tree(type=LEAF, subject=subject)
        snap = self._engine.snapshot()
        if snap.has_overlay and snap.has_wildcards:
            # wildcard-bearing nodes order children by GLOBAL row order —
            # not reconstructible from the per-node overlay merge (module
            # doc); serve the reference's exact tree from the Manager
            return self._manager_engine.build_tree(subject, rest_depth)
        nm = self._nm()

        ns = subject.namespace
        if ns == "":
            ns_id: int = WILDCARD
        else:
            # unknown namespace raises, exactly like the host engine's
            # first Manager query (reference engine.go:51-61 propagates)
            ns_id = nm.get_namespace_by_name(ns).id

        root_dev = None
        if ns_id != WILDCARD:
            root_dev = snap.resolve_set(ns_id, subject.object, subject.relation)
        pattern = (
            ns_id == WILDCARD
            or ns_id in snap.wild_ns_ids
            or subject.object == ""
            or subject.relation == ""
        )
        children_of: dict[int, np.ndarray] = {}
        if root_dev is None:
            if not pattern:
                return None  # literal key absent → no tuples → nil tree
            if snap.has_overlay:
                # a pattern root concatenates MATCHING KEYS' lists in
                # global row order — same non-reconstructible case
                return self._manager_engine.build_tree(subject, rest_depth)
            starts = snap.resolve_starts(ns_id, subject.object, subject.relation)
            if starts.size == 0:
                return None
            children_of[_PATTERN_ROOT] = self._pattern_children(snap, starts)
            root_dev = _PATTERN_ROOT

        self._capture_adjacency(snap, root_dev, rest_depth, children_of)

        ns_names = {n.id: n.name for n in nm.namespaces()}

        def subject_of(dev: int) -> Subject:
            kind, key = snap.key_of_dev(dev)
            if kind == "leaf":
                return SubjectID(key)
            k_ns, k_obj, k_rel = key
            name = ns_names.get(k_ns)
            if name is None:
                # tuples can outlive a namespace removed by config reload;
                # the Manager-backed engine raises from its id→name
                # resolution in the same situation
                raise ErrNamespaceUnknown(f"namespace id {k_ns}")
            return SubjectSet(name, k_obj, k_rel)

        visited: set[str] = set()

        def rec(sub: Subject, dev: int, rd: int) -> Optional[Tree]:
            # mirrors keto_tpu_torch/expand/engine.py _build_tree line for line
            if rd <= 0:
                return None
            if not isinstance(sub, SubjectSet):
                return Tree(type=LEAF, subject=sub)
            if check_and_add_visited(visited, sub):
                return None
            ch = children_of.get(dev)
            if ch is None or ch.size == 0:
                return None
            if rd <= 1:
                return Tree(type=LEAF, subject=sub)
            node = Tree(type=UNION, subject=sub)
            for c in ch.tolist():
                cs = subject_of(c)
                t = rec(cs, c, rd - 1)
                node.children.append(t if t is not None else Tree(type=LEAF, subject=cs))
            return node

        return rec(subject, root_dev, rest_depth)

    # -- phase A -------------------------------------------------------------

    def _subject_order_key(self, snap: GraphSnapshot, dev: int):
        """Manager ORDER BY position of a child: subject sets first
        (NULL-first on the subject_id column), each group sorted by its
        key fields — comparable tuples."""
        kind, key = snap.key_of_dev(dev)
        return (0, key) if kind == "set" else (1, (key,))

    def _merge_overlay_children(
        self, snap: GraphSnapshot, dev: int, base: np.ndarray
    ) -> np.ndarray:
        """Base children (already in subject-sort order — one literal
        node's rows are contiguous in the store's ORDER BY) merged with
        the node's overlay children in the SAME order: the Manager's page
        order, reproduced without a storage round trip. Overlay lists are
        tiny by design, so each overlay child bisects into the sorted
        base list (O(k log n) key computations, not O(n)); the merged
        array memoizes on the immutable snapshot."""
        import bisect as _bisect

        extra = snap.ov_fwd.get(int(dev))
        if not extra:
            return base
        cache_key = ("_exp_merge", int(dev))
        with snap._cache_lock:
            hit = snap._pattern_cache.get(cache_key)
        if hit is not None:
            return hit
        okey = lambda d: self._subject_order_key(snap, int(d))  # noqa: E731
        ov_sorted = sorted(extra, key=okey)
        positions = [
            _bisect.bisect_left(base, okey(d), key=okey) for d in ov_sorted
        ]
        out = np.insert(base.astype(np.int64), positions, ov_sorted)
        with snap._cache_lock:
            snap._pattern_cache[cache_key] = out
        return out

    def _capture_adjacency(
        self,
        snap: GraphSnapshot,
        root_dev: int,
        rest_depth: int,
        children_of: dict[int, np.ndarray],
    ) -> None:
        """Fill ``children_of`` for every set node reachable within the
        depth budget: one ``out_neighbors_bulk`` gather per BFS level
        (base edges, tombstone-masked), plus the per-node overlay merge
        when a delta is pending."""
        if root_dev == _PATTERN_ROOT:
            ch = children_of[_PATTERN_ROOT]
            m = snap.is_set_dev_bulk(ch)
            frontier = list(dict.fromkeys(ch[m].tolist()))
        else:
            frontier = [root_dev]
        seen = set(frontier)
        level = 0
        has_ov = bool(snap.ov_fwd)
        # a node at BFS level L expands with rest_depth - L; it consults
        # its children whenever that is ≥ 1
        while frontier and level <= rest_depth - 1:
            arr = np.asarray(frontier, np.int64)
            rows, cnts = snap.out_neighbors_bulk(arr, overlay=False)
            ends = np.cumsum(cnts)
            nxt: list[int] = []
            new_children: list[np.ndarray] = []
            start = 0
            for i, dev in enumerate(frontier):
                ch = rows[start : ends[i]]
                start = int(ends[i])
                if has_ov:
                    ch = self._merge_overlay_children(snap, dev, ch)
                children_of[dev] = ch
                new_children.append(ch)
            if new_children:
                flat = np.concatenate(new_children) if len(new_children) > 1 else new_children[0]
                if flat.size:
                    m = snap.is_set_dev_bulk(flat)
                    for c in flat[m].tolist():
                        if c not in seen:
                            seen.add(c)
                            nxt.append(c)
            frontier = nxt
            level += 1

    @staticmethod
    def _pattern_children(snap: GraphSnapshot, starts: np.ndarray) -> np.ndarray:
        """Ordered union of the matching keys' child lists for a root
        pattern with no node of its own: keys sort by (ns_id, object,
        relation) — the leading columns of the store's ORDER BY — then
        each key contributes its children in its own (row-order) edge
        order; duplicates keep the first occurrence. (Never called with a
        pending overlay: build_tree delegates that case to the Manager.)"""
        keyed = []
        for dev in starts.tolist():
            kind, key = snap.key_of_dev(dev)
            if kind == "set":
                keyed.append((key, dev))
        keyed.sort(key=lambda kv: kv[0])
        if not keyed:
            return np.zeros(0, np.int64)
        rows, _ = snap.out_neighbors_bulk(np.asarray([d for _, d in keyed], np.int64))
        _, first = np.unique(rows, return_index=True)
        return rows[np.sort(first)]
