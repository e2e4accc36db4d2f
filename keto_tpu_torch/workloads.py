"""Workloads the smoke run and the tests drive, made from a seed.

- ``CAT_VIDEOS`` — the cat-videos demo tuples
  (contrib/cat-videos-example/relation-tuples/tuples.txt) and the four
  checks every build must answer: allowed, allowed, denied, allowed.
- ``rbac_workload`` — BASELINE config 3, the RBAC graph of bench.py:39:
  users ∈ leaf groups ∈ mid groups ∈ top groups, documents granting
  ``view`` to a group, sized by tuple count; ``rbac_queries`` draws checks
  with analytic expectations (half built to be granted, half uniform).
"""

from __future__ import annotations

import random

from keto_tpu_torch.namespace import Namespace
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

CAT_VIDEOS_TUPLES = """\
// Everyone may view the teaser clip.
videos:/cats/1.mp4#view@*
// Owners of a video may view it.
videos:/cats/1.mp4#view@(videos:/cats/1.mp4#owner)
videos:/cats/2.mp4#view@(videos:/cats/2.mp4#owner)
// Whoever owns the /cats directory owns the videos in it...
videos:/cats/1.mp4#owner@(videos:/cats#owner)
videos:/cats/2.mp4#owner@(videos:/cats#owner)
// ...and may view the directory listing.
videos:/cats#view@(videos:/cats#owner)
// The cat lady owns the directory.
videos:/cats#owner@cat lady
"""

CAT_VIDEOS_NAMESPACES = [Namespace(id=1, name="videos")]

#: (check, expected decision)
CAT_VIDEOS_CHECKS = [
    ("videos:/cats/1.mp4#view@*", True),
    ("videos:/cats/1.mp4#view@cat lady", True),
    ("videos:/cats/2.mp4#view@*", False),
    ("videos:/cats/2.mp4#view@cat lady", True),
]


def parse_tuples(text: str) -> list[RelationTuple]:
    """String-codec lines, ``//`` comments and blank lines skipped."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("//"):
            out.append(RelationTuple.from_string(line))
    return out


RBAC_NAMESPACES = [Namespace(id=1, name="groups"), Namespace(id=2, name="docs")]


def _T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def rbac_workload(rng: random.Random, n_tuples: int):
    """BASELINE config 3 at ``n_tuples``: returns ``(tuples, ctx)`` where
    ``ctx`` carries the membership maps ``rbac_queries`` needs."""
    n_users = max(100, n_tuples // 10)
    n_leaf = max(20, n_tuples // 125)
    n_mid = max(5, n_leaf // 5)
    n_top = max(2, n_mid // 4)

    tuples = []
    membership: dict = {}  # user → set of leaf groups
    leaf_users: dict = {}  # leaf group → users
    for u in range(n_users):
        for _ in range(rng.choice((1, 1, 2))):
            g = rng.randrange(n_leaf)
            membership.setdefault(u, set()).add(g)
            leaf_users.setdefault(g, []).append(u)
            tuples.append(_T("groups", f"leaf-{g}", "member", SubjectID(f"user-{u}")))

    leaf_parent, mid_leaves = {}, {}
    for g in range(n_leaf):
        parent = rng.randrange(n_mid)
        leaf_parent[g] = parent
        mid_leaves.setdefault(parent, []).append(g)
        tuples.append(
            _T("groups", f"mid-{parent}", "member", SubjectSet("groups", f"leaf-{g}", "member"))
        )
    mid_parent, top_mids = {}, {}
    for m in range(n_mid):
        parent = rng.randrange(n_top)
        mid_parent[m] = parent
        top_mids.setdefault(parent, []).append(m)
        tuples.append(
            _T("groups", f"top-{parent}", "member", SubjectSet("groups", f"mid-{m}", "member"))
        )

    doc_grant = {}
    d = 0
    while len(tuples) < n_tuples:
        kind, idx = rng.choice((("leaf", n_leaf), ("mid", n_mid), ("top", n_top)))
        g = rng.randrange(idx)
        doc_grant[d] = (kind, g)
        tuples.append(
            _T("docs", f"doc-{d}", "view", SubjectSet("groups", f"{kind}-{g}", "member"))
        )
        d += 1
    ctx = {
        "n_users": n_users, "membership": membership, "leaf_users": leaf_users,
        "leaf_parent": leaf_parent, "mid_leaves": mid_leaves,
        "mid_parent": mid_parent, "top_mids": top_mids, "doc_grant": doc_grant,
    }
    return tuples, ctx


def _user_reaches(ctx, u, kind, g) -> bool:
    leaves = ctx["membership"].get(u, set())
    if kind == "leaf":
        return g in leaves
    mids = {ctx["leaf_parent"][lf] for lf in leaves}
    if kind == "mid":
        return g in mids
    return g in {ctx["mid_parent"][m] for m in mids}


def _member_of(ctx, kind, g, rng):
    """A user transitively inside group (kind, g), or None if empty."""
    if kind == "top":
        mids = ctx["top_mids"].get(g)
        if not mids:
            return None
        kind, g = "mid", rng.choice(mids)
    if kind == "mid":
        leaves = ctx["mid_leaves"].get(g)
        if not leaves:
            return None
        g = rng.choice(leaves)
    users = ctx["leaf_users"].get(g)
    return rng.choice(users) if users else None


def rbac_queries(rng: random.Random, n_checks: int, ctx):
    """``(queries, expected)``: even-indexed queries target a user built to
    hold the grant, odd ones a uniform random user (almost always denied)."""
    docs = list(ctx["doc_grant"])
    queries, expected = [], []
    for i in range(n_checks):
        d = rng.choice(docs)
        kind, g = ctx["doc_grant"][d]
        u = _member_of(ctx, kind, g, rng) if i % 2 == 0 else None
        if u is None:
            u = rng.randrange(ctx["n_users"])
        queries.append(_T("docs", f"doc-{d}", "view", SubjectID(f"user-{u}")))
        expected.append(_user_reaches(ctx, u, kind, g))
    return queries, expected
