"""Relation-tuple data model.

A relation tuple ``namespace:object#relation@subject`` states that ``subject``
has ``relation`` on ``object`` within ``namespace``. The subject is a sum
type: either an opaque subject ID, or a *subject set*
``namespace:object#relation`` referencing every subject that (transitively)
has ``relation`` on ``object``.

Semantics follow the reference model exactly:
- string grammar & parsing: reference internal/relationtuple/definitions.go:138-193, 273-306
- JSON codec (``subject_id`` XOR ``subject_set``): definitions.go:316-343
- URL-query codec incl. dropped legacy ``subject`` key: definitions.go:378-414, 458-516
- query semantics (zero values mean "any"): definitions.go:44-66
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Union
from urllib.parse import parse_qs, urlencode

from keto_tpu_torch.x.errors import (
    ErrDroppedSubjectKey,
    ErrDuplicateSubject,
    ErrIncompleteSubject,
    ErrMalformedInput,
    ErrNilSubject,
)

_SUBJECT_ID_KEY = "subject_id"
_SSET_NS_KEY = "subject_set.namespace"
_SSET_OBJ_KEY = "subject_set.object"
_SSET_REL_KEY = "subject_set.relation"


@dataclass(frozen=True)
class SubjectID:
    """A concrete subject, e.g. a user id. Reference definitions.go:39-42."""

    id: str = ""

    def __str__(self) -> str:
        return self.id

    def to_json(self) -> dict[str, Any]:
        return {"subject_id": self.id}

    @property
    def subject_id(self) -> Optional[str]:
        return self.id

    @property
    def subject_set(self) -> Optional["SubjectSet"]:
        return None


@dataclass(frozen=True)
class SubjectSet:
    """An indirect subject: everyone with ``relation`` on ``namespace:object``.
    Reference definitions.go:103-118."""

    namespace: str = ""
    object: str = ""
    relation: str = ""

    def __str__(self) -> str:
        return f"{self.namespace}:{self.object}#{self.relation}"

    def to_json(self) -> dict[str, Any]:
        return {
            "subject_set": {
                "namespace": self.namespace,
                "object": self.object,
                "relation": self.relation,
            }
        }

    @property
    def subject_id(self) -> Optional[str]:
        return None

    @property
    def subject_set(self) -> Optional["SubjectSet"]:
        return self


Subject = Union[SubjectID, SubjectSet]


def subject_from_string(s: str) -> Subject:
    """Parse a subject: anything containing ``#`` is a subject set.
    Reference definitions.go:138-143, 172-193."""
    if "#" in s:
        parts = s.split("#")
        if len(parts) != 2:
            raise ErrMalformedInput()
        inner = parts[0].split(":")
        if len(inner) != 2:
            raise ErrMalformedInput()
        return SubjectSet(namespace=inner[0], object=inner[1], relation=parts[1])
    return SubjectID(id=s)


def subject_set_from_url_query(query: Union[str, Mapping[str, list[str]]]) -> SubjectSet:
    """Decode a subject set from bare ``namespace``/``object``/``relation``
    query keys: the expand endpoint's subject (reference
    internal/relationtuple/definitions.go:145-151)."""
    q = parse_qs(query, keep_blank_values=True) if isinstance(query, str) else query

    def get(k: str) -> str:
        v = q.get(k, [])
        return v[0] if v else ""

    return SubjectSet(namespace=get("namespace"), object=get("object"), relation=get("relation"))


def _subject_from_json(obj: Mapping[str, Any]) -> Subject:
    """Decode the ``subject_id`` XOR ``subject_set`` JSON convention.
    Reference definitions.go:316-339."""
    sid = obj.get("subject_id")
    sset = obj.get("subject_set")
    if sid is not None and sset is not None:
        raise ErrDuplicateSubject()
    if sid is None and sset is None:
        raise ErrNilSubject()
    if sid is not None:
        if not isinstance(sid, str):
            raise ErrMalformedInput("subject_id must be a string")
        return SubjectID(id=sid)
    if not isinstance(sset, Mapping):
        raise ErrMalformedInput("subject_set must be an object")
    return SubjectSet(
        namespace=str(sset.get("namespace", "")),
        object=str(sset.get("object", "")),
        relation=str(sset.get("relation", "")),
    )


@dataclass(frozen=True)
class RelationTuple:
    """An internal relation tuple. Reference definitions.go:95-100."""

    namespace: str
    object: str
    relation: str
    subject: Subject

    def __str__(self) -> str:
        return f"{self.namespace}:{self.object}#{self.relation}@{self.subject}"

    # -- string grammar ------------------------------------------------------

    @classmethod
    def from_string(cls, s: str) -> "RelationTuple":
        """Parse ``ns:obj#rel@subject`` with optional parens around the
        subject. Reference definitions.go:277-306."""
        ns, sep, rest = s.partition(":")
        if not sep:
            raise ErrMalformedInput("expected input to contain ':'")
        obj, sep, rest = rest.partition("#")
        if not sep:
            raise ErrMalformedInput("expected input to contain '#'")
        rel, sep, sub = rest.partition("@")
        if not sep:
            raise ErrMalformedInput("expected input to contain '@'")
        # optional brackets around the subject set, e.g. "@(ns:obj#rel)"
        sub = sub.strip("()")
        return cls(namespace=ns, object=obj, relation=rel, subject=subject_from_string(sub))

    # -- JSON ----------------------------------------------------------------

    def to_json(self) -> dict[str, Any]:
        body: dict[str, Any] = {
            "namespace": self.namespace,
            "object": self.object,
            "relation": self.relation,
        }
        body.update(self.subject.to_json())
        return body

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "RelationTuple":
        if not isinstance(obj, Mapping):
            raise ErrMalformedInput("expected a JSON object")
        return cls(
            namespace=str(obj.get("namespace", "")),
            object=str(obj.get("object", "")),
            relation=str(obj.get("relation", "")),
            subject=_subject_from_json(obj),
        )

    def to_query(self) -> "RelationQuery":
        """The exact query naming this tuple (every field, the subject
        included)."""
        return RelationQuery(
            namespace=self.namespace,
            object=self.object,
            relation=self.relation,
            subject_id=self.subject.subject_id,
            subject_set=self.subject.subject_set,
        )

    # -- URL query -----------------------------------------------------------

    def to_url_query(self) -> str:
        vals = [
            ("namespace", self.namespace),
            ("object", self.object),
            ("relation", self.relation),
        ]
        if isinstance(self.subject, SubjectID):
            vals.append((_SUBJECT_ID_KEY, self.subject.id))
        else:
            vals.append((_SSET_NS_KEY, self.subject.namespace))
            vals.append((_SSET_OBJ_KEY, self.subject.object))
            vals.append((_SSET_REL_KEY, self.subject.relation))
        return urlencode(vals)

    @classmethod
    def from_url_query(cls, query: Union[str, Mapping[str, list[str]]]) -> "RelationTuple":
        """Reference definitions.go:378-395 — a tuple (unlike a query)
        requires a subject."""
        q = RelationQuery.from_url_query(query)
        sub = q.subject
        if sub is None:
            raise ErrNilSubject()
        return cls(namespace=q.namespace, object=q.object, relation=q.relation, subject=sub)

@dataclass
class RelationQuery:
    """A tuple query; empty namespace/object/relation mean "any", and the
    subject filter is optional (but at most one of id/set).
    Reference definitions.go:44-66."""

    namespace: str = ""
    object: str = ""
    relation: str = ""
    subject_id: Optional[str] = None
    subject_set: Optional[SubjectSet] = None

    @property
    def subject(self) -> Optional[Subject]:
        if self.subject_id is not None:
            return SubjectID(id=self.subject_id)
        if self.subject_set is not None:
            return self.subject_set
        return None

    @classmethod
    def from_url_query(cls, query: Union[str, Mapping[str, list[str]]]) -> "RelationQuery":
        """Reference definitions.go:458-493. Notable cases:
        - legacy ``subject`` key → ErrDroppedSubjectKey
        - all four subject keys present → ErrDuplicateSubject
        - partial ``subject_set.*`` without ``subject_id`` → ErrIncompleteSubject
        """
        if isinstance(query, str):
            q = parse_qs(query, keep_blank_values=True)
        else:
            q = dict(query)

        def has(k: str) -> bool:
            return k in q

        def get(k: str) -> str:
            v = q.get(k, [])
            return v[0] if v else ""

        if has("subject"):
            raise ErrDroppedSubjectKey()

        subject_id: Optional[str] = None
        subject_set: Optional[SubjectSet] = None
        has_id = has(_SUBJECT_ID_KEY)
        has_set = has(_SSET_NS_KEY) or has(_SSET_OBJ_KEY) or has(_SSET_REL_KEY)
        has_full_set = has(_SSET_NS_KEY) and has(_SSET_OBJ_KEY) and has(_SSET_REL_KEY)

        if not has_id and not has_set:
            pass  # not queried for the subject
        elif has_id and has_full_set:
            raise ErrDuplicateSubject()
        elif has_id:
            subject_id = get(_SUBJECT_ID_KEY)
        elif has_full_set:
            subject_set = SubjectSet(
                namespace=get(_SSET_NS_KEY),
                object=get(_SSET_OBJ_KEY),
                relation=get(_SSET_REL_KEY),
            )
        else:
            raise ErrIncompleteSubject()

        return cls(
            namespace=get("namespace"),
            object=get("object"),
            relation=get("relation"),
            subject_id=subject_id,
            subject_set=subject_set,
        )

    def to_url_query(self) -> str:
        vals: list[tuple[str, str]] = []
        if self.namespace:
            vals.append(("namespace", self.namespace))
        if self.relation:
            vals.append(("relation", self.relation))
        if self.object:
            vals.append(("object", self.object))
        if self.subject_id is not None:
            vals.append((_SUBJECT_ID_KEY, self.subject_id))
        elif self.subject_set is not None:
            vals.append((_SSET_NS_KEY, self.subject_set.namespace))
            vals.append((_SSET_OBJ_KEY, self.subject_set.object))
            vals.append((_SSET_REL_KEY, self.subject_set.relation))
        return urlencode(vals)
