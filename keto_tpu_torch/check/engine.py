"""Oracle check engine: recursive subject-set expansion on the host.

This is a faithful re-implementation of the reference's check engine
(reference internal/check/engine.go:33-95): depth-first search over
subject-set indirections with early exit on match, a shared visited-set cycle
guard, page-at-a-time reads through the Manager contract, and
unknown-namespace → allowed=false (engine.go:76-77).

Its role here is the *differential-testing oracle* the GPU engine
(keto_tpu_torch/check/gpu_engine.py) must agree with bit-for-bit: the
tests and ``chip_smoke.py`` hold the device decisions against it.
"""

from __future__ import annotations

from keto_tpu_torch.relationtuple.manager import Manager
from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple, SubjectSet
from keto_tpu_torch.x.errors import ErrNotFound
from keto_tpu_torch.x.graph import check_and_add_visited
from keto_tpu_torch.x.pagination import with_size, with_token


class CheckEngine:
    def __init__(self, manager: Manager, page_size: int = 0):
        self._manager = manager
        # page_size=0 keeps the store default (100); tests inject smaller
        # sizes to assert pagination behavior.
        self._page_size = page_size

    def subject_is_allowed(self, requested: RelationTuple) -> bool:
        """Can ``requested.subject`` be reached from
        ``requested.object#requested.relation``? Reference engine.go:93-95."""
        return self._check_one_indirection_further(
            requested,
            RelationQuery(
                namespace=requested.namespace,
                object=requested.object,
                relation=requested.relation,
            ),
            visited=set(),
        )

    def _check_one_indirection_further(
        self, requested: RelationTuple, expand_query: RelationQuery, visited: set[str]
    ) -> bool:
        """Page loop over one subject-set expansion. Reference engine.go:69-91."""
        prev_page = ""
        while True:
            opts = [with_token(prev_page)]
            if self._page_size:
                opts.append(with_size(self._page_size))
            try:
                next_rels, next_page = self._manager.get_relation_tuples(expand_query, *opts)
            except ErrNotFound:
                # unknown namespace → denied, not an error (engine.go:76-77)
                return False

            allowed = self._subject_is_allowed(requested, next_rels, visited)
            if allowed or next_page == "":
                return allowed
            prev_page = next_page

    def _subject_is_allowed(
        self, requested: RelationTuple, rels: list[RelationTuple], visited: set[str]
    ) -> bool:
        """Match + recurse over one page of tuples. Reference engine.go:33-67."""
        for sr in rels:
            if check_and_add_visited(visited, sr.subject):
                continue

            if requested.subject == sr.subject:
                return True

            if not isinstance(sr.subject, SubjectSet):
                continue

            if self._check_one_indirection_further(
                requested,
                RelationQuery(
                    namespace=sr.subject.namespace,
                    object=sr.subject.object,
                    relation=sr.subject.relation,
                ),
                visited,
            ):
                return True

        return False


class HostStreamEngine(CheckEngine):
    """The host ``CheckEngine`` behind the batcher's stream interface: what
    the registry serves for ``engine.backend: oracle`` (the reference's
    explicit host setting). Each batcher round is decided on the host, one
    recursion a tuple, against the store as it stands; the token is the
    store's watermark read before the round, which every decision is at
    least as fresh as. It runs no device code and has no snapshot, so the
    registry serves Expand and the list routes from the store beside it and
    explain is off."""

    #: the stream yields per-slice route info (``with_info=True``)
    STREAM_INFO = True

    def __init__(self, manager: Manager, page_size: int = 0):
        super().__init__(manager, page_size)
        from keto_tpu_torch.check.stream import StreamSliceController
        from keto_tpu_torch.x.telemetry import DurationStats

        #: the batcher bounds a round by ``stream_ctrl.cap()``; admission
        #: reads the slice times
        self.stream_ctrl = StreamSliceController()
        self.stream_slice_stats = DurationStats()

    def batch_check_stream_with_token(self, tuples_iter, *, slice_cap=None, at_least=None,
                                      mode: str = "latest", ordered: bool = True,
                                      with_info: bool = False):
        """``(generator, token)``: the generator yields ``(offset,
        decisions)`` — ``(offset, decisions, info)`` with ``with_info`` — a
        slice of at most ``slice_cap`` (default ``stream_ctrl.cap()``)
        tuples at a time; ``info``'s route is ``cpu``."""
        import time

        import torch

        if with_info and ordered:
            raise ValueError("with_info requires ordered=False")
        token = int(self._manager.watermark())
        cap = max(1, int(slice_cap or self.stream_ctrl.cap()))

        def gen():
            offset, chunk = 0, []
            for t in list(tuples_iter) + [None]:
                if t is not None:
                    chunk.append(t)
                if chunk and (t is None or len(chunk) == cap):
                    t0 = time.perf_counter()
                    out = torch.tensor([self.subject_is_allowed(c) for c in chunk],
                                       dtype=torch.bool)
                    ms = (time.perf_counter() - t0) * 1e3
                    self.stream_slice_stats.observe(ms)
                    info = {"width": len(chunk), "bfs_steps": 0, "route": "cpu",
                            "service_ms": ms}
                    yield (offset, out, info) if with_info else (offset, out)
                    offset += len(chunk)
                    chunk = []

        return gen(), token
