"""In-memory tuple store: a lean port of keto_tpu/persistence/memory.py.

Implements the ``Manager`` contract (reference
internal/relationtuple/definitions.go:28-33) with the semantics of the
reference SQL persister (internal/persistence/sql/relationtuples.go):

- namespaces are stored as their config-assigned int32 IDs and resolved back
  through the namespace manager on read (relationtuples.go:43-80);
- writes validate namespaces (both the tuple's and a subject-set subject's)
  against the namespace manager before any mutation (relationtuples.go:82-126);
- duplicate inserts create additional rows (the SQL PK is a random shard_id,
  relationtuples.go:135-138), deletes remove *all* matching rows;
- rows stay sorted in the reference's ORDER BY (relationtuples.go:215) with
  SQLite NULL-first semantics, ties broken by commit order — the order the
  snapshot builder interns in, so a store holding the same tuples as the JAX
  package's store yields a byte-identical snapshot;
- pagination tokens are 1-based page numbers, "" = first page / no more pages
  (persister.go:106-134).

- every effective write is logged for delta snapshots: the insert log
  ``(watermark, row)`` and the delete log ``(watermark, key7)``, each kept
  to ``LOG_CAP`` entries (keto_tpu/persistence/memory.py:171-190,
  :600-715). ``rows_since`` and ``changes_since`` read them; a bulk write
  past the cap raises the log's floor instead of logging every row, so a
  10M-tuple load keeps no log entries.
- a write of 4,096 tuples or more takes the bulk path
  (keto_tpu/persistence/memory.py:292-416): one column pass, the store's
  ORDER BY as a numpy lexsort, the rows built already in order. A bulk
  load into an empty store keeps its sorted column bundle
  (``snapshot_columns``), the snapshot builder's zero-copy interning input;
  past ``LOG_CAP`` it also parks the row objects (``_DeferredRows``), which
  the first reader of a row builds. Every mutation drops the bundle.

Left out against the reference store: networks, idempotency keys, fleet
leases and watch logs.
"""

from __future__ import annotations

import bisect
import itertools
import threading
from typing import Optional, Sequence

import numpy as np

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.relationtuple.manager import Manager, TransactResult
from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.errors import ErrMalformedPageToken, ErrNilSubject
from keto_tpu_torch.x.pagination import (
    DEFAULT_PAGE_SIZE,
    PaginationOptionSetter,
    get_pagination_options,
)


class InternalRow:
    """One stored tuple with interned namespace IDs (treat as immutable).
    A slotted class: bulk loads construct millions of these."""

    __slots__ = (
        "namespace_id", "object", "relation", "subject_id",
        "sset_namespace_id", "sset_object", "sset_relation", "seq",
    )

    def __init__(
        self,
        namespace_id: int,
        object: str,  # noqa: A002 - field name mirrors the SQL column
        relation: str,
        subject_id: Optional[str],  # exactly one of subject_id / sset_* is set
        sset_namespace_id: Optional[int],
        sset_object: Optional[str],
        sset_relation: Optional[str],
        seq: int,  # commit order (the reference's commit_time)
    ):
        self.namespace_id = namespace_id
        self.object = object
        self.relation = relation
        self.subject_id = subject_id
        self.sset_namespace_id = sset_namespace_id
        self.sset_object = sset_object
        self.sset_relation = sset_relation
        self.seq = seq

    def __repr__(self) -> str:
        return (
            f"InternalRow(namespace_id={self.namespace_id!r}, object={self.object!r}, "
            f"relation={self.relation!r}, subject_id={self.subject_id!r}, "
            f"sset_namespace_id={self.sset_namespace_id!r}, "
            f"sset_object={self.sset_object!r}, sset_relation={self.sset_relation!r}, "
            f"seq={self.seq!r})"
        )

    def key7(self):
        """Row identity for delete matching — the 7 user-visible fields."""
        return (
            self.namespace_id, self.object, self.relation, self.subject_id,
            self.sset_namespace_id, self.sset_object, self.sset_relation,
        )

    def sort_key(self):
        # ORDER BY namespace_id, object, relation, subject_id,
        #   subject_set_namespace_id, subject_set_object, subject_set_relation,
        #   commit_time — with NULLs first (SQLite dialect)
        sid = self.subject_id
        sns = self.sset_namespace_id
        sso = self.sset_object
        ssr = self.sset_relation
        return (
            self.namespace_id,
            self.object,
            self.relation,
            (0, "") if sid is None else (1, sid),
            (0, 0) if sns is None else (1, sns),
            (0, "") if sso is None else (1, sso),
            (0, "") if ssr is None else (1, ssr),
            self.seq,
        )


class _DeferredRows:
    """A bulk load's row objects, not built yet.

    Building tens of millions of ``InternalRow`` objects is the largest
    cost of a bulk load, and the cold start never reads them: the snapshot
    builder interns straight from the sorted column bundle
    (``snapshot_columns`` → ``native_intern_columns``). So a bulk load into
    an empty store past ``LOG_CAP`` parks this thunk, and the first reader
    that needs row objects (a Manager read, a delete, a later write,
    ``snapshot_rows``, ``fork``) builds them through
    ``MemoryPersister._rows``: the same rows in the same order, paid off
    the cold start (keto_tpu/persistence/memory.py:143-165)."""

    __slots__ = ("_make", "n")

    def __init__(self, make, n: int):
        self._make = make
        self.n = int(n)

    def materialize(self) -> list:
        return self._make()


class MemoryPersister(Manager):
    #: inserts above this count sort once and merge; smaller ones insort
    _MERGE_AT = 256
    #: log entries kept for delta snapshots; past this, readers rebuild
    LOG_CAP = 65536
    #: inserts from this count on take the bulk path (``_bulk_ingest``)
    _BULK_AT = 4096
    #: longest string a bulk-ingest numpy column holds: fixed-width U-dtype
    #: cells mean one outlier inflates the whole column (n · maxlen · 4
    #: bytes), so a batch with a longer string takes the row path
    _BULK_MAX_STR = 256
    #: the one-shot paths (the column bundle, the columnar extraction) beat
    #: chunked packing here: the streaming build prefers the chunk seam only
    #: on stores with scan I/O to overlap
    scan_chunks_preferred = False

    def __init__(self, namespace_manager_source):
        """``namespace_manager_source`` is a zero-arg callable returning the
        current namespace.Manager, or a Manager instance."""
        if isinstance(namespace_manager_source, namespace_pkg.Manager):
            self._nm = lambda: namespace_manager_source
        else:
            self._nm = namespace_manager_source
        # guards: _row_list, _col_cache, _lhs_index, _watermark, the logs
        self._lock = threading.RLock()
        # the rows in ORDER BY, or a parked bulk load: read through _rows()
        self._row_list: "list[InternalRow] | _DeferredRows" = []
        # (watermark, sorted column bundle) of a bulk load into an empty
        # store: the snapshot builder's interning input while no mutation
        # has followed it (snapshot_columns)
        self._col_cache: Optional[tuple[int, dict]] = None
        self._seq = itertools.count()
        self._watermark = 0
        # (ns_id, obj, rel) → sorted row sublist: the in-memory analog of
        # the reference's covering index, serving the oracle's fully
        # literal traversal queries without a scan. Rebuilt lazily after
        # writes.
        self._lhs_index: Optional[dict[tuple, list[InternalRow]]] = None
        # delta logs (keto_tpu_torch/graph/overlay.py reads them through
        # changes_since): (watermark, row) per inserted row and
        # (watermark, key7) per effective delete key, each bounded by
        # LOG_CAP; a floor is the newest watermark the log no longer covers
        self._insert_log: list[tuple[int, InternalRow]] = []
        self._delete_log: list[tuple[int, tuple]] = []
        self._log_floor = 0
        self._del_floor = 0
        #: watermark of the last effective delete (rows_since refuses to
        #: span it: an insert-only delta cannot express a delete)
        self._delete_wm = 0

    @property
    def namespaces(self):
        """Zero-arg callable returning the current namespace manager — the
        namespace source handed to engines built over this store."""
        return self._nm

    # -- helpers -------------------------------------------------------------

    def _rows(self) -> list[InternalRow]:
        """The row list, building a parked bulk load's rows on first touch
        (keto_tpu/persistence/memory.py:267-279). The one reader of
        ``_row_list``; callers hold the lock."""
        got = self._row_list
        if isinstance(got, _DeferredRows):
            got = self._row_list = got.materialize()
        return got

    def _to_row(self, rt: RelationTuple) -> InternalRow:
        nm = self._nm()
        ns = nm.get_namespace_by_name(rt.namespace)
        if rt.subject is None:
            raise ErrNilSubject()
        if isinstance(rt.subject, SubjectID):
            return InternalRow(ns.id, rt.object, rt.relation, rt.subject.id, None, None, None, next(self._seq))
        sns = nm.get_namespace_by_name(rt.subject.namespace)
        return InternalRow(
            ns.id, rt.object, rt.relation, None, sns.id, rt.subject.object, rt.subject.relation, next(self._seq)
        )

    def _bulk_ingest(self, tuples_seq: Sequence[RelationTuple]) -> Optional[tuple]:
        """Bulk tuples → ``(make_rows thunk, sorted column bundle)`` in ONE
        column pass (keto_tpu/persistence/memory.py:298-416). The ORDER BY
        runs as a numpy lexsort over the columns: NULL-first rides on
        (presence, value) pairs as in ``sort_key``, numpy's U-dtype
        comparison is by code point (Python's str order), and the arange
        tie-break is arrival order, which is seq order, so the order is
        ``sort_key``'s. The thunk builds the rows directly in that order.

        Returns None when the batch is unsafe for fixed-width numpy
        columns: a string with a trailing NUL (numpy strips it on read-back,
        collapsing ``"a\x00"`` onto ``"a"``) or longer than
        ``_BULK_MAX_STR``. The caller takes the row path, which handles both
        exactly."""
        nm = self._nm()
        ns_cache: dict = {}

        def ns_id(name: str) -> int:
            i = ns_cache.get(name)
            if i is None:
                i = ns_cache[name] = nm.get_namespace_by_name(name).id
            return i

        n = len(tuples_seq)
        c_ns: list[int] = []
        c_obj: list[str] = []
        c_rel: list[str] = []
        c_kind: list[bool] = []
        c_sid: list[str] = []
        c_sns: list[int] = []
        c_sso: list[str] = []
        c_ssr: list[str] = []
        for rt in tuples_seq:
            sub = rt.subject
            if sub is None:
                raise ErrNilSubject()
            c_ns.append(ns_id(rt.namespace))
            c_obj.append(rt.object)
            c_rel.append(rt.relation)
            if isinstance(sub, SubjectID):
                c_kind.append(True)
                c_sid.append(sub.id)
                c_sns.append(0)
                c_sso.append("")
                c_ssr.append("")
            else:
                c_kind.append(False)
                c_sid.append("")
                c_sns.append(ns_id(sub.namespace))
                c_sso.append(sub.object)
                c_ssr.append(sub.relation)

        cap = self._BULK_MAX_STR
        for col in (c_obj, c_rel, c_sid, c_sso, c_ssr):
            if max(map(len, col), default=0) > cap or any(s.endswith("\x00") for s in col):
                return None
        a_ns = np.asarray(c_ns, np.int64)
        a_obj = np.array(c_obj)
        a_rel = np.array(c_rel)
        sid_p = np.asarray(c_kind, bool)
        sid_v = np.array(c_sid)
        sns_v = np.asarray(c_sns, np.int64)
        sso_v = np.array(c_sso)
        ssr_v = np.array(c_ssr)
        # exactly one of subject id / subject set: ~sid_p is the presence
        # flag of sns/sso/ssr (NULL-first: subject-set rows sort before
        # subject-id rows)
        perm = np.lexsort((
            np.arange(n),
            ssr_v, sso_v, sns_v, ~sid_p,
            sid_v, sid_p,
            a_rel, a_obj, a_ns,
        ))
        bundle = {
            "ns": a_ns[perm],
            "kind": sid_p[perm].view(np.uint8),
            "sns": sns_v[perm],
            "obj": a_obj[perm],
            "rel": a_rel[perm],
            "sid": sid_v[perm],
            "sso": sso_v[perm],
            "ssr": ssr_v[perm],
        }
        seqs = list(itertools.islice(self._seq, n))

        def make_rows() -> list:
            # the rows in sorted order, directly (no second permutation
            # pass); a thunk, so a bulk load into an empty store can park it
            rows: list = [None] * n
            for out_i, i in enumerate(perm.tolist()):
                if c_kind[i]:
                    rows[out_i] = InternalRow(c_ns[i], c_obj[i], c_rel[i], c_sid[i], None, None,
                                              None, seqs[i])
                else:
                    rows[out_i] = InternalRow(c_ns[i], c_obj[i], c_rel[i], None, c_sns[i],
                                              c_sso[i], c_ssr[i], seqs[i])
            return rows

        return make_rows, bundle

    def _to_tuple(self, row: InternalRow) -> RelationTuple:
        nm = self._nm()
        ns = nm.get_namespace_by_config_id(row.namespace_id)
        if row.subject_id is not None:
            subject: object = SubjectID(id=row.subject_id)
        else:
            sns = nm.get_namespace_by_config_id(row.sset_namespace_id)
            subject = SubjectSet(namespace=sns.name, object=row.sset_object, relation=row.sset_relation)
        return RelationTuple(namespace=ns.name, object=row.object, relation=row.relation, subject=subject)

    def _compile_query(self, query: RelationQuery):
        """Resolve namespace names up front (unknown → ErrNamespaceUnknown,
        matching reference relationtuples.go:224-235 which resolves before
        filtering) and return a row predicate."""
        nm = self._nm()
        ns_id = nm.get_namespace_by_name(query.namespace).id if query.namespace != "" else None
        sub = query.subject
        sub_id = None
        sset_key = None
        if isinstance(sub, SubjectID):
            sub_id = sub.id
        elif isinstance(sub, SubjectSet):
            sset_key = (nm.get_namespace_by_name(sub.namespace).id, sub.object, sub.relation)

        def matches(row: InternalRow) -> bool:
            if query.relation != "" and row.relation != query.relation:
                return False
            if query.object != "" and row.object != query.object:
                return False
            if ns_id is not None and row.namespace_id != ns_id:
                return False
            if sub_id is not None and row.subject_id != sub_id:
                return False
            if sset_key is not None and (
                (row.sset_namespace_id, row.sset_object, row.sset_relation) != sset_key
            ):
                return False
            return True

        return matches

    def _index_lookup(self, query: RelationQuery) -> list[InternalRow]:
        """Rows to filter: the LHS-index bucket for a fully-literal
        (namespace, object, relation) query, else the full row list. Must be
        called under the lock."""
        if query.namespace == "" or query.object == "" or query.relation == "":
            return self._rows()
        idx = self._lhs_index
        if idx is None:
            idx = {}
            for r in self._rows():
                idx.setdefault((r.namespace_id, r.object, r.relation), []).append(r)
            self._lhs_index = idx
        ns_id = self._nm().get_namespace_by_name(query.namespace).id
        return idx.get((ns_id, query.object, query.relation), [])

    # -- Manager -------------------------------------------------------------

    def get_relation_tuples(
        self, query: RelationQuery, *options: PaginationOptionSetter
    ) -> tuple[list[RelationTuple], str]:
        opts = get_pagination_options(*options)
        per_page = opts.size or DEFAULT_PAGE_SIZE
        if opts.token == "":
            page = 1
        else:
            if not opts.token.isdigit():
                raise ErrMalformedPageToken()
            page = max(int(opts.token), 1)

        with self._lock:
            candidates = self._index_lookup(query)
            matches = self._compile_query(query)
            matched = [r for r in candidates if matches(r)]
            total_pages = -(-len(matched) // per_page)  # ceil
            start = (page - 1) * per_page
            page_rows = matched[start : start + per_page]
            next_token = "" if page >= total_pages else str(page + 1)
            return [self._to_tuple(r) for r in page_rows], next_token

    def write_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.transact_relation_tuples(tuples, ())

    def delete_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.transact_relation_tuples((), tuples)

    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
    ) -> TransactResult:
        """Atomic: namespace validation happens for the whole batch before any
        mutation, so a failing insert/delete leaves the store untouched
        (rollback semantics of reference relationtuples.go:271-278)."""
        with self._lock:
            make_rows = bundle = None
            if len(insert) >= self._BULK_AT:
                # one column pass and a numpy lexsort, plus the interner's
                # column bundle; None: the batch is unsafe for numpy
                # columns, the row path below takes it
                got = self._bulk_ingest(insert)
                if got is not None:
                    make_rows, bundle = got
            new_rows = [] if make_rows is not None else [self._to_row(rt) for rt in insert]
            # delete keys in request order (the delete log keeps it)
            delete_keys = list(dict.fromkeys(self._to_row(rt).key7() for rt in delete))
            rows = self._rows()
            # any mutation drops the bundle; a clean bulk load into an
            # empty store sets it again below
            self._col_cache = None
            col_bundle = bundle if bundle is not None and not rows and not delete else None
            # a bulk load into an empty store past the log cap parks its
            # rows: the snapshot builder reads the bundle, and the log takes
            # the raise-the-floor path either way
            deferred = col_bundle is not None and len(insert) > self.LOG_CAP
            hit_keys: set = set()
            if deferred:
                self._row_list = _DeferredRows(make_rows, len(insert))
                self._lhs_index = None
            else:
                if make_rows is not None:
                    # the bulk rows come sorted, and the log keeps them so
                    new_rows = make_rows()
                    rows = _merge_sorted(rows, new_rows)
                elif len(new_rows) > self._MERGE_AT:
                    # the log keeps request order; the merge needs sort order
                    rows = _merge_sorted(rows, sorted(new_rows, key=InternalRow.sort_key))
                else:
                    for r in new_rows:
                        bisect.insort(rows, r, key=InternalRow.sort_key)
                if delete_keys:
                    keyset = set(delete_keys)
                    kept = []
                    for r in rows:
                        k = r.key7()
                        if k in keyset:
                            hit_keys.add(k)
                        else:
                            kept.append(r)
                    rows = kept
                self._row_list = rows
                self._update_lhs_index(new_rows, keyset if delete_keys else ())
            self._watermark += 1
            wm = self._watermark
            if col_bundle is not None:
                self._col_cache = (wm, col_bundle)
            if deferred:
                # parked rows never enter the insert log: no delta can
                # span this batch
                self._log_floor = wm
                self._insert_log = []
            if hit_keys:
                # only effective deletes (matched >= 1 row) are logged
                self._delete_wm = wm
                self._delete_log.extend((wm, k) for k in delete_keys if k in hit_keys)
                if len(self._delete_log) > self.LOG_CAP:
                    drop = len(self._delete_log) - self.LOG_CAP
                    self._del_floor = self._delete_log[drop - 1][0]
                    del self._delete_log[:drop]
            if new_rows:
                if len(new_rows) > self.LOG_CAP:
                    # a bulk write past the cap: no delta can span it (its
                    # rows share one watermark) — raise the floor instead
                    # of logging every row
                    self._log_floor = wm
                    self._insert_log = []
                else:
                    self._insert_log.extend((wm, r) for r in new_rows)
                    if len(self._insert_log) > self.LOG_CAP:
                        drop = len(self._insert_log) - self.LOG_CAP
                        self._log_floor = self._insert_log[drop - 1][0]
                        del self._insert_log[:drop]
            return TransactResult(snaptoken=wm)

    def _update_lhs_index(self, new_rows, delete_keys) -> None:
        """Keep the LHS index current without an O(rows) rebuild per write:
        small inserts insort into their buckets, deletes filter only their
        buckets; a bulk write drops it for one lazy rebuild."""
        idx = self._lhs_index
        if idx is None:
            return
        if len(new_rows) > 4096:
            self._lhs_index = None
            return
        for r in new_rows:
            bucket = idx.setdefault((r.namespace_id, r.object, r.relation), [])
            bisect.insort(bucket, r, key=InternalRow.sort_key)
        for k in delete_keys:
            b = idx.get((k[0], k[1], k[2]))
            if b:
                idx[(k[0], k[1], k[2])] = [r for r in b if r.key7() != k]

    def watermark(self) -> int:
        with self._lock:
            return self._watermark

    # -- snapshot support ----------------------------------------------------

    def fork(self) -> "MemoryPersister":
        """An independent store holding the same rows at the same watermark,
        over the same namespaces: the parent's rows are built once if a
        bulk load parked them, the row list is copied (its rows are
        immutable and shared), the column bundle valid at this watermark
        is carried over (so the fork's cold start interns from it too), and
        the change logs start empty at the fork's watermark, so a write to
        either store is invisible to the other. chip_smoke.py gives a
        second engine its own copy of a 10M-tuple store this way, without
        generating it again."""
        with self._lock:
            other = MemoryPersister(self._nm)
            other._row_list = list(self._rows())
            other._col_cache = self._col_cache
            # both stores go on from the same next row id: the parent gets
            # back the id read here, ahead of its own counter
            nxt = next(self._seq)
            self._seq = itertools.chain((nxt,), self._seq)
            other._seq = itertools.count(nxt)
            other._watermark = self._watermark
            other._log_floor = other._del_floor = self._watermark
            other._delete_wm = self._delete_wm
            return other

    def snapshot_rows(self) -> tuple[list[InternalRow], int]:
        """Consistent (rows, watermark) view for the graph builder."""
        with self._lock:
            return list(self._rows()), self._watermark

    def snapshot_scan(self, on_chunk, chunk_rows: int = 262144) -> int:
        """Chunked ``snapshot_rows`` (the streaming build's scan seam,
        keto_tpu_torch/graph/stream_build.py): calls ``on_chunk`` with
        consecutive row chunks in ORDER BY order and returns the watermark
        they are consistent at. The chunks are handed over outside the lock
        (the list is copied under it)."""
        with self._lock:
            rows = list(self._rows())
            wm = self._watermark
        step = max(1, int(chunk_rows))
        for i in range(0, len(rows), step):
            on_chunk(rows[i : i + step])
        return wm

    def snapshot_columns(self, watermark: int) -> Optional[dict]:
        """The bulk load's sorted column bundle if it is valid at
        ``watermark`` (no mutation since), else None: the zero-copy
        interning input of a full snapshot build
        (keto_tpu_torch/graph/native.py ``native_intern_columns``)."""
        with self._lock:
            got = self._col_cache
            if got is not None and got[0] == watermark:
                return got[1]
            return None

    def rows_since(self, watermark: int):
        """Rows inserted after ``watermark`` as ``(rows, new_watermark)``, or
        None when no insert-only delta can express the change (a delete
        since, or the insert log no longer reaches back that far)."""
        with self._lock:
            if self._delete_wm > watermark or self._log_floor > watermark:
                return None
            return [r for w, r in self._insert_log if w > watermark], self._watermark

    def changes_since(self, watermark: int):
        """Ordered mutations after ``watermark`` as ``(ops, new_watermark)``,
        each op ``("ins", InternalRow)`` or ``("del", key7)``; None when
        either log no longer reaches back that far. Within one transaction
        inserts come before deletes, as the transaction applies them."""
        with self._lock:
            if self._log_floor > watermark or self._del_floor > watermark:
                return None
            ins = [(w, 0, ("ins", r)) for w, r in self._insert_log if w > watermark]
            dels = [(w, 1, ("del", k)) for w, k in self._delete_log if w > watermark]
            merged = sorted(ins + dels, key=lambda t: (t[0], t[1]))
            return [op for _, _, op in merged], self._watermark


def _merge_sorted(rows: list, new_sorted: list) -> list:
    """Merge a sorted batch into the sorted row list: one binary search per
    new row, then slice copies — no per-element Python loop over ``rows``
    (a 5,000-row write into a 10M-row store costs milliseconds). Equal keys
    keep the stored rows first, as ``heapq.merge`` does."""
    key = InternalRow.sort_key
    out: list = []
    prev = 0
    for r in new_sorted:
        pos = bisect.bisect_right(rows, key(r), lo=prev, key=key)
        out.extend(rows[prev:pos])
        out.append(r)
        prev = pos
    out.extend(rows[prev:])
    return out
