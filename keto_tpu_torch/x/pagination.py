"""Pagination options.

Mirrors the reference's functional-option pagination (reference
internal/x/pagination.go:11-31): an opaque token plus a page size. The
built-in persisters interpret the token as a 1-based page number string
(reference internal/persistence/sql/persister.go:117-134), with "" denoting
the first page and "" returned when there is no further page.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

DEFAULT_PAGE_SIZE = 100  # reference internal/persistence/sql/persister.go:46


@dataclass
class PaginationOptions:
    token: str = ""
    size: int = DEFAULT_PAGE_SIZE


PaginationOptionSetter = Callable[[PaginationOptions], PaginationOptions]


def with_token(token: str) -> PaginationOptionSetter:
    def setter(opts: PaginationOptions) -> PaginationOptions:
        opts.token = token
        return opts

    return setter


def with_size(size: int) -> PaginationOptionSetter:
    def setter(opts: PaginationOptions) -> PaginationOptions:
        if size > 0:
            opts.size = size
        return opts

    return setter


def get_pagination_options(*setters: PaginationOptionSetter) -> PaginationOptions:
    opts = PaginationOptions()
    for s in setters:
        opts = s(opts)
    return opts
