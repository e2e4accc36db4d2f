"""Tuple-manager contract.

A copy of keto_tpu/relationtuple/manager.py. Mirrors the reference's
``relationtuple.Manager`` interface (reference
internal/relationtuple/definitions.go:28-33): paginated query, write,
delete, an atomic insert+delete transaction with an optional idempotency
key, and a group of independent transactions (``transact_many``). Engines
depend only on this contract, so any store plugs in underneath both the
oracle engine and the GPU snapshot builder.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional, Sequence

from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple
from keto_tpu_torch.x.errors import KetoError
from keto_tpu_torch.x.pagination import PaginationOptionSetter, get_pagination_options


@dataclass(frozen=True)
class TransactResult:
    """Outcome of one write transaction.

    ``snaptoken`` is the watermark the transaction committed at (the
    consistency token a caller can pin subsequent checks to — the
    durability contract says an acknowledged snaptoken survives server
    death, docs/concepts/snaptokens.md). ``replayed`` is True when the
    transaction was deduplicated against an earlier application of the
    same idempotency key: nothing was re-applied and ``snaptoken`` is the
    ORIGINAL transaction's token, so a client retrying after an ambiguous
    failure (connection lost post-commit, pre-ack) observes exactly the
    response it missed."""

    snaptoken: int
    replayed: bool = False


@dataclass(frozen=True)
class TransactWrite:
    """One writer's intent inside a multi-writer group transact
    (:meth:`Manager.transact_many`): the same (insert, delete,
    idempotency_key) triple a solo ``transact_relation_tuples`` call
    takes, carried as data so a commit coordinator can batch many
    writers into one durable transaction."""

    insert: Sequence[RelationTuple] = ()
    delete: Sequence[RelationTuple] = ()
    idempotency_key: Optional[str] = None


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
        idempotency_key: Optional[str] = None,
    ) -> Optional[TransactResult]:
        """Atomically apply inserts then deletes; all-or-nothing.

        With ``idempotency_key`` set, the transaction is exactly-once per
        key: the key → snaptoken binding is recorded atomically WITH the
        writes, and a retry of an already-applied key re-applies nothing
        and returns the original snaptoken with ``replayed=True`` (the
        CRDB-style answer to ambiguous-commit retries). Implementations
        return a :class:`TransactResult`; the base contract allows None
        for legacy stores without a watermark concept."""

    def transact_many(self, writes: Sequence[TransactWrite]) -> list:
        """Apply many independent write transactions in one durable
        group: one BEGIN/COMMIT (SQL stores), one lock hold (memory), N
        per-writer outcomes in input order.

        The per-writer semantics are EXACTLY those of N serial
        ``transact_relation_tuples`` calls in the same order: each
        writer gets its own snaptoken from the group's commit sequence
        (consecutive, monotone), its own replayable idempotency-key row
        committed atomically with its rows, and replay detection against
        both prior transactions and earlier writers in the same group.
        A writer whose input the store refuses (a ``KetoError``: an
        unknown namespace, a nil subject) applies nothing and gets its
        exception in its place in the list; the writers around it commit
        as they would alone. Any other error is the store's own: it
        raises and fails the group.

        The base implementation loops over ``transact_relation_tuples``
        — correct but per-commit-durable; stores override it with a real
        batched path (the memory store's)."""
        out: list = []
        for w in writes:
            try:
                out.append(self.transact_relation_tuples(
                    w.insert, w.delete, idempotency_key=w.idempotency_key))
            except KetoError as e:  # this writer's own input, refused
                out.append(e)
        return out

    def watermark(self) -> int:
        """Monotonic write counter, used by the GPU engine to detect staleness
        of its device-resident graph snapshot (the real implementation of what
        the reference stubs as "snaptoken", reference
        internal/check/handler.go:162)."""
        return 0


class ManagerWrapper(Manager):
    """Test spy recording requested page tokens, used to assert the engines'
    pagination behavior. Reference definitions.go:645-683."""

    def __init__(self, manager: Manager, *page_opts: PaginationOptionSetter):
        self.manager = manager
        self.page_opts = list(page_opts)
        self.requested_pages: list[str] = []

    def get_relation_tuples(
        self, query: RelationQuery, *options: PaginationOptionSetter
    ) -> tuple[list[RelationTuple], str]:
        opts = get_pagination_options(*options)
        self.requested_pages.append(opts.token)
        return self.manager.get_relation_tuples(query, *(self.page_opts + list(options)))

    def write_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.manager.write_relation_tuples(*tuples)

    def delete_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.manager.delete_relation_tuples(*tuples)

    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
        idempotency_key: Optional[str] = None,
    ) -> Optional[TransactResult]:
        return self.manager.transact_relation_tuples(
            insert, delete, idempotency_key=idempotency_key
        )

    def transact_many(self, writes: Sequence[TransactWrite]) -> list:
        return self.manager.transact_many(writes)

    def watermark(self) -> int:
        return self.manager.watermark()
