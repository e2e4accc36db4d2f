"""Expand engine over the Manager: materialize the subject-set tree (a copy
of keto_tpu/expand/engine.py).

Faithful to reference internal/expand/engine.go:30-98: depth-limited
recursion with the shared visited-set cycle guard, page loop per node,
``rest_depth <= 1`` truncates a set node to a leaf, and a SubjectID is always
a leaf. Returns ``None`` for depth ≤ 0, cycles, and empty sets — exactly the
reference's nil-tree cases.
"""

from __future__ import annotations

from typing import Optional

from keto_tpu_torch.expand.tree import LEAF, UNION, Tree
from keto_tpu_torch.relationtuple.manager import Manager
from keto_tpu_torch.relationtuple.model import RelationQuery, Subject, SubjectSet
from keto_tpu_torch.x.graph import check_and_add_visited
from keto_tpu_torch.x.pagination import with_size, with_token


class ExpandEngine:
    def __init__(self, manager: Manager, page_size: int = 0):
        self._manager = manager
        self._page_size = page_size

    def build_tree(self, subject: Subject, rest_depth: int) -> Optional[Tree]:
        return self._build_tree(subject, rest_depth, visited=set())

    def _build_tree(self, subject: Subject, rest_depth: int, visited: set[str]) -> Optional[Tree]:
        if rest_depth <= 0:
            return None

        if not isinstance(subject, SubjectSet):
            return Tree(type=LEAF, subject=subject)

        if check_and_add_visited(visited, subject):
            return None

        sub_tree = Tree(type=UNION, subject=subject)
        next_page = ""
        while True:
            opts = [with_token(next_page)]
            if self._page_size:
                opts.append(with_size(self._page_size))
            rels, next_page = self._manager.get_relation_tuples(
                RelationQuery(
                    namespace=subject.namespace, object=subject.object, relation=subject.relation
                ),
                *opts,
            )
            if not rels:
                return None

            if rest_depth <= 1:
                sub_tree.type = LEAF
                return sub_tree

            for r in rels:
                child = self._build_tree(r.subject, rest_depth - 1, visited)
                if child is None:
                    child = Tree(type=LEAF, subject=r.subject)
                sub_tree.children.append(child)

            if next_page == "":
                return sub_tree
