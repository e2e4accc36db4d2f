"""Tuple-manager contract.

Mirrors the reference's ``relationtuple.Manager`` interface
(reference internal/relationtuple/definitions.go:28-33): paginated query,
write, delete, and an atomic insert+delete transaction. Engines depend only
on this contract, so any store (in-memory, SQLite, ...) plugs in underneath
both the oracle engine and the GPU snapshot builder.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Sequence

from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple
from keto_tpu_torch.x.pagination import PaginationOptionSetter


@dataclass(frozen=True)
class TransactResult:
    """Outcome of one write transaction: ``snaptoken`` is the watermark the
    transaction committed at (the consistency token a caller can pin
    subsequent checks to)."""

    snaptoken: int


class Manager(abc.ABC):
    @abc.abstractmethod
    def get_relation_tuples(
        self, query: RelationQuery, *options: PaginationOptionSetter
    ) -> tuple[list[RelationTuple], str]:
        """Return (tuples, next_page_token); "" token means last page."""

    @abc.abstractmethod
    def write_relation_tuples(self, *tuples: RelationTuple) -> None: ...

    @abc.abstractmethod
    def delete_relation_tuples(self, *tuples: RelationTuple) -> None: ...

    @abc.abstractmethod
    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
    ) -> TransactResult:
        """Atomically apply inserts then deletes; all-or-nothing."""

    def watermark(self) -> int:
        """Monotonic write counter, used by the GPU engine to detect staleness
        of its device-resident graph snapshot (the real implementation of what
        the reference stubs as "snaptoken", reference
        internal/check/handler.go:162)."""
        return 0
