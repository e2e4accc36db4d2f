"""String → int32 node interning for the tuple graph.

Every stored relation tuple ``ns:obj#rel@subject`` contributes one directed
edge to a graph whose vertices are:

- **set nodes** — distinct ``(namespace_id, object, relation)`` triples
  appearing either as a tuple's left-hand side or as a subject-set subject;
- **leaf nodes** — distinct subject-ID strings. Subject IDs are globally
  scoped strings (not namespaced), mirroring the reference's
  ``SubjectID.Equals`` which compares only the string
  (reference internal/relationtuple/definitions.go:166-170).

**Wildcard semantics.** The reference's tuple query skips the filter for
every empty field (reference internal/persistence/sql/relationtuples.go:218-235:
``if query.Relation != "" { … }`` etc.), so when the check engine expands a
subject set whose relation/object/namespace is the empty string, that field
matches *anything*. Equality matching of subjects, by contrast, is always
literal. The graph encodes this exactly:

- the **out-edges of a set node K are the subjects of every tuple whose
  left-hand side matches K's query** (empty fields of K wildcarded). For a
  fully literal K that degenerates to "the tuples of K";
- a node is only *matched* (its reached-bit consulted) via exact key
  equality, so wildcards never leak into subject matching.

Namespace wildcarding keys off the namespace *name* being ``""`` — which may
be a configured namespace (reference engine_test.go:119-149 configures one);
reads treat it as a wildcard either way, exactly like the reference, because
``GetRelationTuples`` never resolves an empty namespace name.

Raw ids are dense: set nodes occupy ``[0, num_sets)`` and leaf nodes
``[num_sets, num_sets + num_leaves)``.

Known (documented) divergence: the reference keys its visited set by the
subject's *string form*, so a ``SubjectID`` whose id literally spells
``ns:obj#rel`` can shadow the same-named ``SubjectSet`` mid-traversal and
prune a branch (reference internal/x/graph/graph_utils.go:13-35). The graph
engine interns leaves and sets in disjoint id spaces and never prunes, so it
answers strictly-by-the-model in that pathological case.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Iterable

import numpy as np

SET_KIND = 0
LEAF_KIND = 1


class _Codes:
    """Interns strings to dense int codes for vectorized matching."""

    def __init__(self):
        self.by_str: dict[str, int] = {}

    def code(self, s: str) -> int:
        c = self.by_str.get(s)
        if c is None:
            c = len(self.by_str)
            self.by_str[s] = c
        return c


@dataclass
class InternedGraph:
    """Node tables, per-field code arrays, and raw edges for one snapshot."""

    set_ids: dict[tuple[int, str, str], int]
    leaf_ids: dict[str, int]
    obj_codes: dict[str, int]
    rel_codes: dict[str, int]
    # set-node key fields, aligned with raw set index
    key_ns: np.ndarray  # int64 [num_sets]
    key_obj: np.ndarray  # int64 [num_sets] (codes)
    key_rel: np.ndarray  # int64 [num_sets] (codes)
    key_wild: np.ndarray  # bool [num_sets] — any field wildcards
    # raw deduplicated edges
    src: np.ndarray  # int64 [E] (set-node raw ids)
    dst: np.ndarray  # int64 [E] (unified raw ids)

    @property
    def num_sets(self) -> int:
        return len(self.set_ids)

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_ids)

    @property
    def num_nodes(self) -> int:
        return self.num_sets + self.num_leaves

    # -- resolution -----------------------------------------------------------

    def resolve_set(self, ns_id: int, obj: str, rel: str) -> int:
        """Raw set-node id, or -1 when absent."""
        return self.set_ids.get((ns_id, obj, rel), -1)

    def resolve_leaf(self, subject_id: str) -> int:
        """Raw leaf index (not offset by num_sets), or -1 when absent."""
        return self.leaf_ids.get(subject_id, -1)

    def obj_code(self, s: str) -> int:
        return self.obj_codes.get(s, -1)

    def rel_code(self, s: str) -> int:
        return self.rel_codes.get(s, -1)

    def num_obj_codes(self) -> int:
        """Code-table size (ExtendedInterned assigns fresh codes above)."""
        return len(self.obj_codes)

    def num_rel_codes(self) -> int:
        return len(self.rel_codes)

    # -- reverse lookups (compaction's child order) ----------------------------

    def set_key_of(self, raw_id: int):
        """``(ns_id, object, relation)`` of set node ``raw_id``."""
        inv = self.__dict__.get("_set_by_id")
        if inv is None:
            inv = [None] * len(self.set_ids)
            for k, i in self.set_ids.items():
                inv[i] = k
            self.__dict__["_set_by_id"] = inv
        return inv[raw_id]

    def leaf_str(self, idx: int) -> str:
        """Subject-id string of leaf ``idx`` (not offset by num_sets)."""
        inv = self.__dict__.get("_leaf_by_id")
        if inv is None:
            inv = [None] * len(self.leaf_ids)
            for s, i in self.leaf_ids.items():
                inv[i] = s
            self.__dict__["_leaf_by_id"] = inv
        return inv[idx]


class ExtendedInterned:
    """Copy-on-write interner view (keto_tpu/graph/interner.py:142-315): an
    immutable base interner plus small append-only extension tables for
    the nodes an overlay compaction folds in
    (keto_tpu_torch/graph/compaction.py).

    The base is never mutated, so snapshots sharing it (batches in flight
    on the pre-compaction snapshot) stay consistent. Raw ids match a grown
    interner: extension set keys take raw ids ``[base.num_sets,
    num_sets)`` in fold order, which shifts every leaf's unified raw id by
    the extension set count (compaction rebuilds ``raw2dev`` to match).
    New field codes are assigned above the base code-table sizes, so they
    never collide with base codes in the pattern indexes. Extension keys
    are always literal (``apply_delta`` rejects new wildcard-bearing
    keys), so ``key_wild`` extends with False. Extending an
    ``ExtendedInterned`` copies its tables onto the same base rather than
    stacking wrappers.
    """

    #: the engine's bulk resolve re-resolves its misses through the host
    #: path while this is set (extension nodes are not in a native base)
    has_ext = True

    def __init__(self, base, new_set_keys, new_leaves):
        if isinstance(base, ExtendedInterned):
            self._base = base._base
            self._ext_set_keys = list(base._ext_set_keys)
            self._ext_leaves = list(base._ext_leaves)
            self._ext_obj_codes = dict(base._ext_obj_codes)
            self._ext_rel_codes = dict(base._ext_rel_codes)
        else:
            self._base = base
            self._ext_set_keys = []
            self._ext_leaves = []
            self._ext_obj_codes = {}
            self._ext_rel_codes = {}
        b = self._base
        self._base_num_sets = b.num_sets
        self._base_num_leaves = b.num_leaves
        # base code-table sizes: the floor for fresh extension codes
        self._obj_floor = b.num_obj_codes()
        self._rel_floor = b.num_rel_codes()
        for key in new_set_keys:
            self._ext_set_keys.append((int(key[0]), str(key[1]), str(key[2])))
        self._ext_leaves.extend(str(s) for s in new_leaves)
        self._ext_set_ids = {k: self._base_num_sets + i for i, k in enumerate(self._ext_set_keys)}
        self._ext_leaf_ids = {s: self._base_num_leaves + i for i, s in enumerate(self._ext_leaves)}
        n_ext = len(self._ext_set_keys)
        ext_ns = np.empty(n_ext, np.int64)
        ext_obj = np.empty(n_ext, np.int64)
        ext_rel = np.empty(n_ext, np.int64)
        for i, (ns, obj, rel) in enumerate(self._ext_set_keys):
            ext_ns[i] = ns
            ext_obj[i] = self._intern_field(obj, self._ext_obj_codes, b.obj_code, self._obj_floor)
            ext_rel[i] = self._intern_field(rel, self._ext_rel_codes, b.rel_code, self._rel_floor)
        self.key_ns = np.concatenate([np.asarray(b.key_ns, np.int64), ext_ns])
        self.key_obj = np.concatenate([np.asarray(b.key_obj, np.int64), ext_obj])
        self.key_rel = np.concatenate([np.asarray(b.key_rel, np.int64), ext_rel])
        self.key_wild = np.concatenate([np.asarray(b.key_wild, bool), np.zeros(n_ext, bool)])

    @staticmethod
    def _intern_field(s, ext_codes, base_lookup, floor):
        c = base_lookup(s)
        if c >= 0:
            return c
        c = ext_codes.get(s)
        if c is None:
            c = floor + len(ext_codes)
            ext_codes[s] = c
        return c

    @property
    def num_sets(self) -> int:
        return self._base_num_sets + len(self._ext_set_keys)

    @property
    def num_leaves(self) -> int:
        return self._base_num_leaves + len(self._ext_leaves)

    @property
    def n_ext(self) -> int:
        return len(self._ext_set_keys) + len(self._ext_leaves)

    def num_obj_codes(self) -> int:
        return self._obj_floor + len(self._ext_obj_codes)

    def num_rel_codes(self) -> int:
        return self._rel_floor + len(self._ext_rel_codes)

    def resolve_set(self, ns_id: int, obj: str, rel: str) -> int:
        raw = self._base.resolve_set(ns_id, obj, rel)
        if raw >= 0:
            return raw
        return self._ext_set_ids.get((ns_id, obj, rel), -1)

    def resolve_leaf(self, subject_id: str) -> int:
        raw = self._base.resolve_leaf(subject_id)
        if raw >= 0:
            return raw
        return self._ext_leaf_ids.get(subject_id, -1)

    def obj_code(self, s: str) -> int:
        c = self._base.obj_code(s)
        return c if c >= 0 else self._ext_obj_codes.get(s, -1)

    def rel_code(self, s: str) -> int:
        c = self._base.rel_code(s)
        return c if c >= 0 else self._ext_rel_codes.get(s, -1)

    def resolve_queries(self, buf: bytes, n: int):
        """Bulk literal resolution through the base's native tables, with
        leaf raw ids re-offset for the grown set count. Ext-only keys come
        back -1; the engine re-resolves those misses through the host path
        (``has_ext``). None when the base has no native bulk entry point
        or rejects the buffer."""
        base_rq = getattr(self._base, "resolve_queries", None)
        if base_rq is None:
            return None
        got = base_rq(buf, n)
        if got is None:
            return None
        start, sub = got
        k = len(self._ext_set_keys)
        if k:
            sub = np.where(sub >= self._base_num_sets, sub + k, sub)
        return start, sub

    def set_key_of(self, raw_id: int):
        if raw_id < self._base_num_sets:
            return self._base.set_key_of(raw_id)
        return self._ext_set_keys[raw_id - self._base_num_sets]

    def leaf_str(self, idx: int) -> str:
        if idx < self._base_num_leaves:
            return self._base.leaf_str(idx)
        return self._ext_leaves[idx - self._base_num_leaves]


class IncrementalInterner:
    """Chunk-incremental interning with the exact ``intern_rows``
    semantics: feed row chunks in store ORDER BY order via ``add_rows``
    and ``finish()`` returns the same ``InternedGraph`` a single pass
    over the concatenated stream would produce (ids and field codes are
    assigned in first-occurrence order, which chunking cannot change).

    A copy of keto_tpu/graph/interner.py's Python path, so a snapshot built
    here is byte-identical to the JAX package's (tests/test_torch_snapshot.py
    holds them against each other). Snapshots intern through the native
    C++ interner (graph/native.py), which assigns the same ids; this path
    takes the rows it cannot encode."""

    def __init__(self, wild_ns_ids: FrozenSet[int] = frozenset()):
        self._wild_ns_ids = wild_ns_ids
        self._set_ids: dict[tuple[int, str, str], int] = {}
        self._leaf_ids: dict[str, int] = {}
        self._objc = _Codes()
        self._relc = _Codes()
        # pass-1 accumulators (per-tuple field codes + subject raw kind)
        self._t_lhs: list[int] = []
        self._t_ns: list[int] = []
        self._t_obj: list[int] = []
        self._t_rel: list[int] = []
        self._t_sub_kind: list[int] = []
        self._t_sub_idx: list[int] = []

    def add_rows(self, rows: Iterable) -> None:
        """Intern one chunk (pass 1); chunks must arrive in stream order."""
        set_ids = self._set_ids
        leaf_ids = self._leaf_ids
        objc, relc = self._objc, self._relc

        def set_node(ns_id: int, obj: str, rel: str) -> int:
            key = (ns_id, obj, rel)
            idx = set_ids.get(key)
            if idx is None:
                idx = len(set_ids)
                set_ids[key] = idx
                # intern field codes at node creation so code numbering
                # matches the native interner exactly (ingest.cpp set_node)
                objc.code(obj)
                relc.code(rel)
            return idx

        def leaf_node(s: str) -> int:
            idx = leaf_ids.get(s)
            if idx is None:
                idx = len(leaf_ids)
                leaf_ids[s] = idx
            return idx

        t_lhs, t_ns = self._t_lhs, self._t_ns
        t_obj, t_rel = self._t_obj, self._t_rel
        t_sub_kind, t_sub_idx = self._t_sub_kind, self._t_sub_idx
        for r in rows:
            lhs = set_node(r.namespace_id, r.object, r.relation)
            t_lhs.append(lhs)
            t_ns.append(r.namespace_id)
            t_obj.append(objc.code(r.object))
            t_rel.append(relc.code(r.relation))
            if r.subject_id is not None:
                t_sub_kind.append(LEAF_KIND)
                t_sub_idx.append(leaf_node(r.subject_id))
            else:
                t_sub_kind.append(SET_KIND)
                t_sub_idx.append(
                    set_node(r.sset_namespace_id, r.sset_object, r.sset_relation)
                )

    def finish(self) -> InternedGraph:
        """Pass 2 over the accumulated per-tuple arrays: key arrays,
        wildcard edge expansion, first-occurrence edge dedup."""
        wild_ns_ids = self._wild_ns_ids
        set_ids = self._set_ids
        leaf_ids = self._leaf_ids
        objc, relc = self._objc, self._relc
        num_sets = len(set_ids)
        key_ns = np.empty(num_sets, np.int64)
        key_obj = np.empty(num_sets, np.int64)
        key_rel = np.empty(num_sets, np.int64)
        wild = np.zeros(num_sets, bool)
        for (ns_id, obj, rel), i in set_ids.items():
            key_ns[i] = ns_id
            key_obj[i] = objc.code(obj)
            key_rel[i] = relc.code(rel)
            wild[i] = (ns_id in wild_ns_ids) or obj == "" or rel == ""
        # resolve after the loop above — "" may first intern via a set key
        empty_obj = objc.by_str.get("")
        empty_rel = relc.by_str.get("")

        tn = np.asarray(self._t_ns, np.int64)
        to = np.asarray(self._t_obj, np.int64)
        tr = np.asarray(self._t_rel, np.int64)
        tl = np.asarray(self._t_lhs, np.int64)
        tk = np.asarray(self._t_sub_kind, np.int64)
        ti = np.asarray(self._t_sub_idx, np.int64)
        t_sub_raw = np.where(tk == SET_KIND, ti, ti + num_sets)

        # edges: literal LHS nodes take their own tuples' subjects;
        # wildcard-bearing set nodes take every matching tuple's subject
        srcs = [tl[~wild[tl]]] if tl.size else [np.zeros(0, np.int64)]
        dsts = [t_sub_raw[~wild[tl]]] if tl.size else [np.zeros(0, np.int64)]
        for i in np.nonzero(wild)[0]:
            m = np.ones(tl.shape[0], bool)
            if key_ns[i] not in wild_ns_ids:
                m &= tn == key_ns[i]
            if key_obj[i] != empty_obj:
                m &= to == key_obj[i]
            if key_rel[i] != empty_rel:
                m &= tr == key_rel[i]
            srcs.append(np.full(int(m.sum()), i, np.int64))
            dsts.append(t_sub_raw[m])

        src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
        dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
        if src.size:
            # duplicate tuples produce duplicate store rows (random
            # shard_id PK, reference relationtuples.go:135-138) but add
            # nothing to reachability — dedup edges, keeping the FIRST
            # occurrence in emission order. Rows arrive sorted in the
            # store's ORDER BY, so a set node's surviving out-edge order
            # is exactly the order the Manager pages that node's tuples —
            # the expand engine's tree-child order rides on this.
            packed = src * np.int64(num_sets + len(leaf_ids)) + dst
            _, keep = np.unique(packed, return_index=True)
            src, dst = src[np.sort(keep)], dst[np.sort(keep)]

        return InternedGraph(
            set_ids=set_ids,
            leaf_ids=leaf_ids,
            obj_codes=objc.by_str,
            rel_codes=relc.by_str,
            key_ns=key_ns,
            key_obj=key_obj,
            key_rel=key_rel,
            key_wild=wild,
            src=src,
            dst=dst,
        )


def intern_rows(rows: Iterable, wild_ns_ids: FrozenSet[int] = frozenset()) -> InternedGraph:
    """Intern ``persistence.memory.InternalRow``-shaped rows (attributes:
    namespace_id, object, relation, subject_id | sset_*). ``wild_ns_ids`` are
    the ids of namespaces whose configured *name* is the empty string.
    One-shot wrapper over ``IncrementalInterner``."""
    it = IncrementalInterner(wild_ns_ids)
    it.add_rows(rows)
    return it.finish()
