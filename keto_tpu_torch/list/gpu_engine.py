"""Snapshot-backed list engine: the reverse-query fixpoint on the card.

The counterpart of ``SnapshotListEngine`` (keto_tpu/list/tpu_engine.py). A
listing is full-graph reachability from one seed — forward for ListSubjects
("who can access Y" walks the grant edges outward), backward for
ListObjects ("what can X access" walks them in reverse). Both run over the
snapshot's bucketed-ELL list layouts (keto_tpu_torch/graph/snapshot.py
``ListLayout``): per step every interior-class row ORs the reached bits of
its layout neighbours — in-neighbours in the forward orientation,
out-neighbours in the transposed one — through the list fixpoint K5
(keto_tpu_torch/list/kernels.py), with the delta overlay's interior-class
edges ORed inside the loop.

The host completes what lies outside the iterated rows: seeds expand
through the overlay-aware one-hop adjacency, sink answers gather through
the tombstone-masked sink CSR plus overlay sink edges, and static
candidates resolve by one vectorized out-neighbour gather — the check
engine's split (the card for the fixpoint, the host for the boundary).

Routes, each counted in ``requests_total[(op, route)]``:

- a query in a wildcard-configured namespace, or with an empty field →
  the Manager-backed oracle (keto_tpu_torch/list/engine.py), "oracle";
- a snapshot whose overlay the layouts could not mirror (``lst_dirty``) →
  the host lister ``_fixpoint_host`` over the same snapshot, "host" (as
  is a listing with no interior seed, which needs no fixpoint);
- everything else → the card, "device".

A device error raises to the caller and counts ``device_errors``: the
reference's quiet host retry (tpu_engine.py:241-251) is not ported, and
neither is its HBM ``reverse`` eviction rung, which waits for the HBM
governor.

Each snapshot uploads its own layouts on first use (``_ensure_device``),
then applies the pending ``lst_patch`` slot patches to that private copy
in place with K9 (``slot_set_many``), the list site of K9.

Pagination: results are canonicalized (sorted, deduplicated) and cached
per (query, snapshot id); page tokens carry the snapshot watermark and a
VALUE cursor, so follow-up pages pin a snapshot at least as fresh and
survive a fold renumbering device ids.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Union

import numpy as np
import torch

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.check import kernels
from keto_tpu_torch.graph.carry import device_list_from_arrays, list_layout_arrays
from keto_tpu_torch.graph.snapshot import GraphSnapshot
from keto_tpu_torch.list.engine import ListEngine, decode_page_token, encode_page_token, slice_page
from keto_tpu_torch.list.kernels import list_step
from keto_tpu_torch.relationtuple.model import Subject, SubjectID, SubjectSet
from keto_tpu_torch.x.device import resolve_device
from keto_tpu_torch.x.errors import ErrNamespaceUnknown

#: concurrent listings one fixpoint bit-packs (one uint32 lane each)
LANES = 32


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def _out_all(snap: GraphSnapshot, nodes: np.ndarray) -> np.ndarray:
    """All out-neighbour devs of ``nodes``: the base CSR (tombstone-masked)
    merged with the complete overlay adjacency (``ov_fwd``, every added
    edge whatever its class). Union only; order irrelevant."""
    rows, _ = snap.out_neighbors_bulk(np.asarray(nodes, np.int64), overlay=False)
    ov = snap.ov_fwd
    if ov:
        extras = [np.asarray(ov[int(u)], np.int64) for u in np.asarray(nodes).tolist()
                  if int(u) in ov]
        if extras:
            rows = np.concatenate([rows.astype(np.int64)] + extras)
    return rows


def _in_all(snap: GraphSnapshot, nodes: np.ndarray) -> np.ndarray:
    """All in-neighbour devs of ``nodes`` (transposed CSR, masked, plus the
    overlay's reverse adjacency)."""
    rows, _ = snap.in_neighbors_bulk(np.asarray(nodes, np.int64))
    return rows


class SnapshotListEngine:
    """Reverse queries over the check engine's snapshots.

    ``check_engine`` is the ``TorchCheckEngine`` whose snapshots (and their
    snaptoken freshness) the listings share, so a listing issued after a
    write sees it exactly as a check does. ``device`` defaults to ``cuda``
    and must be named ``"cpu"`` to run the plain PyTorch path.
    """

    def __init__(
        self,
        check_engine,
        namespaces,
        *,
        device: Optional[Union[str, torch.device]] = None,
        cache_entries: int = 64,
    ):
        self.device = resolve_device(device)
        self._engine = check_engine
        if isinstance(namespaces, namespace_pkg.Manager):
            self._nm: Callable[[], namespace_pkg.Manager] = lambda: namespaces
        else:
            self._nm = namespaces
        #: the Manager-backed oracle: wildcard queries route here
        self.oracle = ListEngine(check_engine._store)
        self._lock = threading.Lock()  # guards: _cache, device_list uploads
        self._cache: OrderedDict = OrderedDict()
        self._cache_entries = int(cache_entries)
        self._count_lock = threading.Lock()
        #: listings by (op, route): route is "oracle", "empty", "host" or
        #: "device"
        self.requests_total: dict[tuple[str, str], int] = {}
        #: device fixpoints that raised
        self.device_errors = 0
        #: seconds of the last upload of each orientation's layouts
        self.upload_seconds: dict[str, float] = {}

    # -- bookkeeping ---------------------------------------------------------

    def _count(self, op: str, path: str) -> None:
        with self._count_lock:
            key = (op, path)
            self.requests_total[key] = self.requests_total.get(key, 0) + 1

    def _snap(self, at_least: Optional[int], latest: bool) -> GraphSnapshot:
        if latest:
            return self._engine.snapshot()  # read-your-writes
        if at_least is not None:
            return self._engine.snapshot(at_least=at_least)
        return self._engine.snapshot_serving()  # never stalls the read plane

    def _ns_id(self, name: str) -> Optional[int]:
        try:
            return self._nm().get_namespace_by_name(name).id
        except ErrNamespaceUnknown:
            return None

    # -- fixpoints -----------------------------------------------------------

    def _fixpoint(self, snap: GraphSnapshot, orient: str, seeds: np.ndarray):
        """(bool[sink_base]: interior-class devs reached from ``seeds``, route).
        ``seeds`` count as reached ("via >= 1 edge" is the caller's seeding
        contract)."""
        sb = snap.sink_base
        reached = np.zeros(sb, bool)
        seeds = np.unique(np.asarray(seeds, np.int64))
        if sb == 0 or seeds.size == 0:
            reached[seeds] = True if seeds.size else False
            return reached, "host"
        if snap.lst_dirty or snap.lay_fwd is None:
            return self._fixpoint_host(snap, orient, seeds), "host"
        try:
            return self._fixpoint_device(snap, orient, [seeds])[0], "device"
        except Exception:
            with self._count_lock:
                self.device_errors += 1
            raise

    def _fixpoint_host(self, snap: GraphSnapshot, orient: str, seeds: np.ndarray) -> np.ndarray:
        """The host lister's fixpoint: frontier BFS over the masked host CSRs
        — the edge set the device layouts iterate (base minus tombstones plus
        overlay), so its answers equal the device's."""
        sb = snap.sink_base
        reached = np.zeros(sb, bool)
        frontier = seeds[seeds < sb]
        reached[frontier] = True
        expand = _out_all if orient == "fwd" else _in_all
        while frontier.size:
            nbrs = np.unique(expand(snap, frontier))
            nbrs = nbrs[(nbrs >= 0) & (nbrs < sb)]
            new = nbrs[~reached[nbrs]]
            reached[new] = True
            frontier = new
        return reached

    def _fixpoint_device(self, snap: GraphSnapshot, orient: str, seed_lists: list) -> list:
        """Up to ``LANES`` listings in one bit-packed fixpoint on the card
        (the engine runs one per call, as the reference)."""
        if len(seed_lists) > LANES:
            raise ValueError(f"{len(seed_lists)} listings exceed the {LANES} lanes of one word")
        lay = snap.lay_fwd if orient == "fwd" else snap.lay_rev
        n_rows = lay.n_rows
        dl = self._ensure_device(snap, orient)
        ov_nbrs, ov_dst = self._overlay_stage(snap, lay)
        R0 = np.zeros((n_rows + 1, 1), np.uint32)
        for q, seeds in enumerate(seed_lists):
            rows = lay.dev2row[np.asarray(seeds, np.int64)]
            R0[rows, 0] |= np.uint32(1 << q)
        R = list_step(
            dl.buckets,
            torch.from_numpy(R0.view(np.int32)).to(self.device),
            ov_nbrs,
            ov_dst,
            n_active=lay.n_active,
            valid_rows=dl.valid_rows,
            it_cap=n_rows + 2,
        )
        bits = R[:n_rows, 0].cpu().numpy().view(np.uint32)
        outs = []
        for q in range(len(seed_lists)):
            reached = np.zeros(n_rows, bool)
            reached[lay.order] = ((bits >> np.uint32(q)) & 1).astype(bool)
            outs.append(reached)
        return outs

    def _ensure_device(self, snap: GraphSnapshot, orient: str):
        """This snapshot's upload of one orientation's layouts, with the
        pending ``lst_patch`` entries past its applied count written in place
        by K9 (``slot_set_many``: every bucket in one call). The upload is
        private to the snapshot (a delta snapshot starts with none), so the
        in-place writes touch no tensor another snapshot reads."""
        with self._lock:
            if snap.device_list is None:
                snap.device_list = {}
            dl = snap.device_list
            patches = snap.lst_patch or []
            entry = dl.get(orient)
            if entry is None:
                t0 = time.monotonic()
                arrays, meta = list_layout_arrays(snap, orient)
                entry = dl[orient] = [device_list_from_arrays(arrays, meta, self.device), 0]
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.upload_seconds[orient] = time.monotonic() - t0
            if entry[1] < len(patches):
                by_bucket: dict[int, list] = {}
                for o, bi, row, col, val in patches[entry[1]:]:
                    if o == orient:
                        by_bucket.setdefault(bi, []).append((row, col, val))
                bufs = entry[0].buckets
                es = [np.asarray(ents, np.int64) for ents in by_bucket.values()]
                kernels.slot_set_many([(bufs[bi], e[:, 0], e[:, 1], e[:, 2])
                                       for bi, e in zip(by_bucket, es)], in_place=True)
                entry[1] = len(patches)
            return entry[0]

    def _overlay_stage(self, snap: GraphSnapshot, lay):
        """The overlay's interior-class edges as a ``[K, C]`` gather matrix
        and ``[K]`` destination rows in this orientation's row space (rebuilt
        per call: the overlay is budget-bounded and the upload tiny). Holes
        point at the all-zero row ``n_rows``; padded destinations at
        ``n_rows + 1``, which the fixpoint drops."""
        edges = snap.lst_ov_edges
        if not edges:
            return None, None
        if lay.orient == "fwd":
            pairs = [(int(lay.dev2row[d]), int(lay.dev2row[s])) for s, d in edges]
        else:
            pairs = [(int(lay.dev2row[s]), int(lay.dev2row[d])) for s, d in edges]
        by_dst: dict[int, list[int]] = {}
        for dst, val in pairs:
            by_dst.setdefault(dst, []).append(val)
        K = _ceil_pow2(len(by_dst))
        C = _ceil_pow2(max(len(v) for v in by_dst.values()))
        nbrs = np.full((K, C), np.int32(lay.n_rows), np.int32)
        dsts = np.full(K, np.int32(lay.n_rows + 1), np.int32)
        for i, (dst, vals) in enumerate(sorted(by_dst.items())):
            dsts[i] = dst
            nbrs[i, : len(vals)] = vals
        return torch.from_numpy(nbrs).to(self.device), torch.from_numpy(dsts).to(self.device)

    # -- ListSubjects --------------------------------------------------------

    def list_subjects(
        self,
        namespace: str,
        object: str,
        relation: str,
        *,
        at_least: Optional[int] = None,
        latest: bool = False,
    ) -> tuple[list[str], int]:
        """(sorted subject ids reachable from namespace:object#relation,
        snaptoken of the snapshot that answered)."""
        snap = self._snap(at_least, latest)
        token = int(snap.snapshot_id)
        ns_id = self._ns_id(namespace)
        wild = namespace == "" or object == "" or relation == "" or (
            ns_id is not None and ns_id in snap.wild_ns_ids
        )
        if wild:
            self._count("subjects", "oracle")
            return self.oracle.list_subjects(namespace, object, relation), token
        if ns_id is None:
            self._count("subjects", "empty")
            return [], token

        def compute() -> list[str]:
            seed = snap.resolve_set(ns_id, object, relation)
            if seed is None:
                return []
            sb = snap.sink_base
            hop = np.unique(_out_all(snap, np.asarray([seed], np.int64)))
            reached, path = self._fixpoint(snap, "fwd", hop[hop < sb])
            self._count("subjects", path)
            return self._subjects_from(snap, reached, hop[hop >= sb])

        return self._cached(("subjects", ns_id, object, relation, token), compute), token

    def _subjects_from(self, snap: GraphSnapshot, reached: np.ndarray, direct: np.ndarray) -> list:
        """Reached interior rows + direct one-hop sinks → subject-id strings:
        base sinks with a live reached in-neighbour (sink CSR,
        tombstone-masked), overlay sink edges, then the leaf filter."""
        sb, nl = snap.sink_base, snap.num_live
        out_devs = set(int(d) for d in direct)
        si = snap.sink_indices
        if reached.any() and si is not None and si.size and nl > sb:
            src_c, live, seg = self._sink_gather(snap)
            ok = reached[src_c] & live
            hit = np.bincount(seg[ok], minlength=nl - sb) > 0
            out_devs.update((np.nonzero(hit)[0] + sb).tolist())
        for dst, srcs in (snap.ov_sink_in or {}).items():
            s = np.asarray(srcs, np.int64)
            s = s[s < sb]
            if s.size and reached[s].any():
                out_devs.add(int(dst))
        for s, dsts in (snap.ov_fwd or {}).items():
            if s < sb and reached[s]:
                out_devs.update(int(d) for d in dsts if d >= sb)
        res = set()
        for d in out_devs:
            kind, key = snap.key_of_dev(int(d))
            if kind == "leaf":
                res.add(key)
        return sorted(res)

    @staticmethod
    def _sink_gather(snap: GraphSnapshot):
        """Per snapshot, cached: the sink CSR's in-neighbour rows clipped into
        the reached bitmap, the mask of live interior entries (not
        tombstoned), and each entry's sink segment."""
        with snap._cache_lock:
            hit = snap._pattern_cache.get("_list_sinks")
        if hit is not None:
            return hit
        sb, nl = snap.sink_base, snap.num_live
        sp = snap.sink_indptr
        src = snap.sink_indices.astype(np.int64)
        live = src < sb
        rem = snap.ov_removed
        if rem is not None and rem.size:
            sink_dev = np.repeat(np.arange(sb, nl, dtype=np.int64), np.diff(sp))
            keys = (src << 32) | sink_dev
            pos = np.clip(np.searchsorted(rem, keys), 0, rem.size - 1)
            live &= rem[pos] != keys
        got = (np.clip(src, 0, sb - 1), live, np.repeat(np.arange(nl - sb), np.diff(sp)))
        with snap._cache_lock:
            snap._pattern_cache["_list_sinks"] = got
        return got

    # -- ListObjects ---------------------------------------------------------

    def _target_dev(self, snap: GraphSnapshot, subject: Subject) -> Optional[int]:
        """The subject's device node, matching the check engine's literal
        subject resolution: an empty subject namespace can only equal a
        stored subject in a namespace named ""."""
        if isinstance(subject, SubjectID):
            return snap.resolve_leaf(subject.id)
        if isinstance(subject, SubjectSet):
            if subject.namespace == "":
                wild_list = list(snap.wild_ns_ids)
                if not wild_list:
                    return None
                skey = (wild_list[0], subject.object, subject.relation)
            else:
                sid = self._ns_id(subject.namespace)
                if sid is None:
                    return None
                skey = (sid, subject.object, subject.relation)
            return snap.resolve_set(*skey)
        return None

    def list_objects(
        self,
        namespace: str,
        relation: str,
        subject: Subject,
        *,
        at_least: Optional[int] = None,
        latest: bool = False,
    ) -> tuple[list[str], int]:
        """(sorted objects o in ``namespace`` with check(namespace, o,
        relation, subject) true, snaptoken). Backward reachability from the
        subject over the transposed layout."""
        snap = self._snap(at_least, latest)
        token = int(snap.snapshot_id)
        ns_id = self._ns_id(namespace)
        wild = namespace == "" or relation == "" or (
            ns_id is not None and ns_id in snap.wild_ns_ids
        )
        if wild:
            self._count("objects", "oracle")
            return self.oracle.list_objects(namespace, relation, subject), token
        if ns_id is None:
            self._count("objects", "empty")
            return [], token

        def compute() -> list[str]:
            t = self._target_dev(snap, subject)
            if t is None:
                return []
            sb = snap.sink_base
            preds = np.unique(_in_all(snap, np.asarray([t], np.int64)))
            reached, path = self._fixpoint(snap, "rev", preds[preds < sb])
            self._count("objects", path)
            return self._objects_from(snap, reached, ns_id, relation, int(t))

        return self._cached(("objects", ns_id, relation, str(subject), token), compute), token

    def _objects_from(
        self, snap: GraphSnapshot, reached: np.ndarray, ns_id: int, relation: str, t: int
    ) -> list[str]:
        """Candidates = every set node matching (namespace, *, relation),
        overlay included. Interior candidates answer from the fixpoint;
        static candidates by one vectorized out-neighbour gather (a static
        reaches the target iff an out-edge hits the target or a reached
        interior row); sink-class candidates have no out-edges."""
        sb = snap.sink_base
        interior, statics, rows, rows_c, m, seg = self._candidates(snap, ns_id, relation)
        answers: list[int] = []
        if interior.size and reached.size:
            answers.extend(interior[reached[interior]].tolist())
        if statics.size:
            ok = rows == t
            if reached.size:
                ok |= m & reached[rows_c]
            hit = np.bincount(seg[ok], minlength=statics.size) > 0
            ovf = snap.ov_fwd or {}
            if ovf:
                # overlay out-edges of the statics (sorted, so each overlay
                # source finds its candidate by binary search)
                srcs = np.fromiter(ovf.keys(), np.int64, len(ovf))
                pos = np.clip(np.searchsorted(statics, srcs), 0, statics.size - 1)
                for c, i in zip(srcs.tolist(), pos.tolist()):
                    if statics[i] != c or hit[i]:
                        continue
                    for d in ovf[c]:
                        if d == t or (d < sb and reached.size and reached[d]):
                            hit[i] = True
                            break
            answers.extend(statics[hit].tolist())
        objs = set()
        for d in answers:
            kind, key = snap.key_of_dev(int(d))
            # an object named "" is a wildcard pattern, not an object — never
            # an answer (the oracle's contract too)
            if kind == "set" and key[1] != "":
                objs.add(key[1])
        return sorted(objs)

    @staticmethod
    def _candidates(snap: GraphSnapshot, ns_id: int, relation: str):
        """Per snapshot and (namespace, relation), cached: the interior and
        static candidate set nodes, the statics' out-neighbours (base CSR,
        tombstone-masked) clipped into the reached bitmap, the mask of
        interior ones, and each entry's static segment — the part of
        ``_objects_from`` that does not depend on the subject."""
        key = ("_list_cands", ns_id, relation)
        with snap._cache_lock:
            hit = snap._pattern_cache.get(key)
        if hit is not None:
            return hit
        sb, nl = snap.sink_base, snap.num_live
        cands = np.unique(snap.resolve_starts(ns_id, "", relation))
        statics = cands[cands >= nl]  # base statics + overlay nodes
        rows, cnts = snap.out_neighbors_bulk(statics, overlay=False)
        rows = rows.astype(np.int64)
        m = rows < sb
        got = (cands[cands < sb], statics, rows, np.where(m, rows, 0), m,
               np.repeat(np.arange(statics.size), cnts))
        with snap._cache_lock:
            snap._pattern_cache[key] = got
        return got

    # -- paginated surface ---------------------------------------------------

    def _cached(self, key: tuple, compute):
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                return hit
        val = compute()
        with self._lock:
            self._cache[key] = val
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_entries:
                self._cache.popitem(last=False)
        return val

    def page_subjects(
        self,
        namespace: str,
        object: str,
        relation: str,
        *,
        page_size: int = 0,
        page_token: str = "",
        at_least: Optional[int] = None,
        latest: bool = False,
    ) -> tuple[list[str], str, int]:
        """(subject ids page, next_page_token, snaptoken)."""
        cursor = ""
        if page_token:
            w, cursor = decode_page_token(page_token)
            at_least = max(at_least or 0, w)  # pin: never older than page 1
        items, token = self.list_subjects(
            namespace, object, relation, at_least=at_least, latest=latest
        )
        page, nxt = slice_page(items, cursor, page_size)
        return page, (encode_page_token(token, nxt) if nxt else ""), token

    def page_objects(
        self,
        namespace: str,
        relation: str,
        subject: Subject,
        *,
        page_size: int = 0,
        page_token: str = "",
        at_least: Optional[int] = None,
        latest: bool = False,
    ) -> tuple[list[str], str, int]:
        """(objects page, next_page_token, snaptoken)."""
        cursor = ""
        if page_token:
            w, cursor = decode_page_token(page_token)
            at_least = max(at_least or 0, w)
        items, token = self.list_objects(
            namespace, relation, subject, at_least=at_least, latest=latest
        )
        page, nxt = slice_page(items, cursor, page_size)
        return page, (encode_page_token(token, nxt) if nxt else ""), token
