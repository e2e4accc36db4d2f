"""Subject-set expansion trees (a copy of keto_tpu/expand/tree.py).

Node types and codecs mirroring reference internal/expand/tree.go: the engine
only emits ``union`` and ``leaf`` today (exclusion/intersection are reserved
for userset rewrites, tree.go:15-30), JSON uses the ``subject_id`` XOR
``subject_set`` convention (tree.go:84-139), and the pretty printer renders
the same box art (tree.go:218-235).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

from keto_tpu_torch.relationtuple.model import Subject, SubjectID, SubjectSet
from keto_tpu_torch.x.errors import ErrBadRequest, ErrDuplicateSubject, ErrNilSubject

UNION = "union"
EXCLUSION = "exclusion"
INTERSECTION = "intersection"
LEAF = "leaf"

_VALID_TYPES = {UNION, EXCLUSION, INTERSECTION, LEAF}


@dataclass
class Tree:
    type: str
    subject: Subject
    children: list["Tree"] = field(default_factory=list)

    def to_json(self) -> dict[str, Any]:
        body: dict[str, Any] = {"type": self.type}
        if self.children:
            body["children"] = [c.to_json() for c in self.children]
        sid = self.subject.subject_id
        sset = self.subject.subject_set
        if sid is not None:
            body["subject_id"] = sid
        if sset is not None:
            body["subject_set"] = {
                "namespace": sset.namespace,
                "object": sset.object,
                "relation": sset.relation,
            }
        return body

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "Tree":
        t = obj.get("type")
        if t not in _VALID_TYPES:
            raise ErrBadRequest(f"unknown node type {t!r}")
        sid = obj.get("subject_id")
        sset = obj.get("subject_set")
        if sid is None and sset is None:
            raise ErrNilSubject()
        if sid is not None and sset is not None:
            raise ErrDuplicateSubject()
        subject: Subject
        if sid is not None:
            if not isinstance(sid, str):
                raise ErrBadRequest("subject_id must be a string")
            subject = SubjectID(id=sid)
        else:
            if not isinstance(sset, Mapping):
                raise ErrBadRequest("subject_set must be an object")
            subject = SubjectSet(
                namespace=sset.get("namespace", ""),
                object=sset.get("object", ""),
                relation=sset.get("relation", ""),
            )
        raw_children = obj.get("children", [])
        if not isinstance(raw_children, list):
            raise ErrBadRequest("children must be a list")
        children = [cls.from_json(c) for c in raw_children]
        return cls(type=t, subject=subject, children=children)

    def __str__(self) -> str:
        """Pretty printer; byte-identical art to reference tree.go:218-235
        (including the trailing variation selector after the clover)."""
        sub = str(self.subject)
        if self.type == LEAF:
            return f"☘ {sub}️"
        children = ["\n│  ".join(str(c).split("\n")) for c in self.children]
        return f"∪ {sub}\n├─ " + "\n├─ ".join(children)

    def equals(self, other: Optional["Tree"]) -> bool:
        """Order-insensitive equality over children (the e2e suite compares
        trees irrespective of sibling order, reference
        internal/e2e/cases_test.go)."""
        if other is None:
            return False
        if self.type != other.type or self.subject != other.subject:
            return False
        if len(self.children) != len(other.children):
            return False
        remaining = list(other.children)
        for c in self.children:
            for i, o in enumerate(remaining):
                if c.equals(o):
                    remaining.pop(i)
                    break
            else:
                return False
        return True
