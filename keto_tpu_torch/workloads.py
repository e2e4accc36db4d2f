"""Workloads the smoke run and the tests drive, made from a seed.

- ``CAT_VIDEOS`` — the cat-videos demo tuples
  (contrib/cat-videos-example/relation-tuples/tuples.txt) and the four
  checks every build must answer: allowed, allowed, denied, allowed.
- ``rbac_workload`` — BASELINE config 3, the RBAC graph of bench.py:39:
  users ∈ leaf groups ∈ mid groups ∈ top groups, documents granting
  ``view`` to a group, sized by tuple count; ``rbac_queries`` draws checks
  with analytic expectations (half built to be granted, half uniform).
- ``github_workload`` — BASELINE config 4, the GitHub-style org/team/repo
  graph of bench.py:117 (five namespaces, team forests nested 4 deep, grant
  chains up to 7 edges); ``github_queries`` (bench.py:282) draws checks on
  issues and pulls with analytic expectations; ``github_list_queries``
  draws ListObjects ("which issues may user-u view") and ListSubjects
  ("which users may view issue-j") with their analytic expected sets.
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


GITHUB_NAMESPACES = [
    Namespace(id=i + 1, name=n) for i, n in enumerate(("orgs", "teams", "repos", "issues", "pulls"))
]


def github_workload(rng: random.Random, n_tuples: int):
    """BASELINE config 4 at ``n_tuples`` (10M in the BASELINE): users join
    teams; teams nest in forests of depth ≤ 4
    (``teams:team-P#member@teams:team-C#member``); root teams attach to
    orgs; repos grant ``reader``/``maintainer`` to an org's members or a
    team's members; issues and pulls grant ``view`` through the repo's
    reader/maintainer set. The deepest chain is
    issue→reader→org→root-team→(3 nested teams)→user = 7 edges. Every
    count scales with ``n_tuples``. Returns ``(tuples, ctx)``; ``ctx`` has
    the membership maps ``github_queries`` needs."""
    scale = n_tuples / 10_000_000
    n_users = max(1_000, int(800_000 * scale))
    n_teams = max(64, int(120_000 * scale))
    n_orgs = max(8, int(5_000 * scale))
    n_repos = max(64, int(250_000 * scale))
    levels = 4  # team nesting depth

    tuples = []
    # team forest: contiguous level blocks; level-k teams parent into k-1
    lvl_bounds = [i * n_teams // levels for i in range(levels + 1)]

    def level_of(t):
        for k in range(levels):
            if t < lvl_bounds[k + 1]:
                return k
        return levels - 1

    team_parent, team_children = {}, {}
    for t in range(lvl_bounds[1], n_teams):
        k = level_of(t)
        parent = rng.randrange(lvl_bounds[k - 1], lvl_bounds[k])
        team_parent[t] = parent
        team_children.setdefault(parent, []).append(t)
        tuples.append(_T("teams", f"team-{parent}", "member", SubjectSet("teams", f"team-{t}", "member")))

    anc_cache: dict = {}

    def ancestors(t):
        """(the team's ancestor chain, itself included; its root)"""
        got = anc_cache.get(t)
        if got is None:
            chain = [t]
            while chain[-1] in team_parent:
                chain.append(team_parent[chain[-1]])
            got = anc_cache[t] = (frozenset(chain), chain[-1])
        return got

    org_roots: dict = {o: [] for o in range(n_orgs)}
    root_org: dict = {}
    for r in range(lvl_bounds[1]):
        o = rng.randrange(n_orgs)
        org_roots[o].append(r)
        root_org[r] = o
        tuples.append(_T("orgs", f"org-{o}", "member", SubjectSet("teams", f"team-{r}", "member")))

    # direct team memberships: the tuple bulk, sized so the total lands on
    # n_tuples after repos, issues and pulls
    n_issueish = int(n_tuples * 0.30)
    budget_members = n_tuples - len(tuples) - 2 * n_repos - n_issueish
    per_user = max(1, budget_members // n_users)
    team_users: dict = {}
    user_teams: dict = {}
    for u in range(n_users):
        for _ in range(per_user):
            t = rng.randrange(n_teams)
            user_teams.setdefault(u, []).append(t)
            team_users.setdefault(t, []).append(u)
            tuples.append(_T("teams", f"team-{t}", "member", SubjectID(f"user-{u}")))

    repo_reader, repo_maint = {}, {}
    for r in range(n_repos):
        if rng.random() < 0.5:
            grant = ("org", rng.randrange(n_orgs))
            sub = SubjectSet("orgs", f"org-{grant[1]}", "member")
        else:
            grant = ("team", rng.randrange(n_teams))
            sub = SubjectSet("teams", f"team-{grant[1]}", "member")
        repo_reader[r] = grant
        tuples.append(_T("repos", f"repo-{r}", "reader", sub))
        mt = rng.randrange(n_teams)
        repo_maint[r] = ("team", mt)
        tuples.append(_T("repos", f"repo-{r}", "maintainer", SubjectSet("teams", f"team-{mt}", "member")))

    issue_repo, pull_repo = [], []
    while len(tuples) < n_tuples:
        r = rng.randrange(n_repos)
        if len(issue_repo) <= len(pull_repo):
            tuples.append(_T("issues", f"issue-{len(issue_repo)}", "view",
                             SubjectSet("repos", f"repo-{r}", "reader")))
            issue_repo.append(r)
        else:
            tuples.append(_T("pulls", f"pull-{len(pull_repo)}", "view",
                             SubjectSet("repos", f"repo-{r}", "maintainer")))
            pull_repo.append(r)

    def grant_ok(u, grant):
        kind, x = grant
        if kind == "org":
            roots = set(org_roots[x])
            return any(ancestors(dt)[1] in roots for dt in user_teams.get(u, ()))
        return any(x in ancestors(dt)[0] for dt in user_teams.get(u, ()))

    def member_of_grant(grant):
        """A user holding ``grant``, or None: a random downward walk from
        the granted team (an org's random root team), stopping at direct
        members."""
        kind, x = grant
        if kind == "org":
            roots = org_roots[x]
            if not roots:
                return None
            x = rng.choice(roots)
        for _ in range(8):
            us = team_users.get(x)
            if us and rng.random() < 0.5:
                return rng.choice(us)
            kids = team_children.get(x)
            if not kids:
                return rng.choice(us) if us else None
            x = rng.choice(kids)
        us = team_users.get(x)
        return rng.choice(us) if us else None

    issues_by_repo: dict = {}
    for j, r in enumerate(issue_repo):
        issues_by_repo.setdefault(r, []).append(j)
    reader_repos: dict = {}  # grant → repos whose reader set it is
    for r, grant in repo_reader.items():
        reader_repos.setdefault(grant, []).append(r)

    ctx = {
        "n_users": n_users, "issue_repo": issue_repo, "pull_repo": pull_repo,
        "repo_reader": repo_reader, "repo_maint": repo_maint,
        "grant_ok": grant_ok, "member_of_grant": member_of_grant,
        # the maps the list expectations read
        "team_children": team_children, "team_users": team_users, "user_teams": user_teams,
        "org_roots": org_roots, "root_org": root_org, "ancestors": ancestors,
        "issues_by_repo": issues_by_repo, "reader_repos": reader_repos,
    }
    return tuples, ctx


def github_queries(rng: random.Random, n_checks: int, ctx):
    """``(queries, expected)``: half engineered grants, half uniform users
    (mostly denials), over the deepest objects (issues and pulls). The
    grant walk draws from the generator's ``rng`` (kept in ``ctx``), as the
    reference's does."""
    queries, expected = [], []
    for i in range(n_checks):
        if i % 2 == 0:
            j = rng.randrange(len(ctx["issue_repo"]))
            ns, obj = "issues", f"issue-{j}"
            grant = ctx["repo_reader"][ctx["issue_repo"][j]]
        else:
            j = rng.randrange(len(ctx["pull_repo"]))
            ns, obj = "pulls", f"pull-{j}"
            grant = ctx["repo_maint"][ctx["pull_repo"][j]]
        u = ctx["member_of_grant"](grant) if i % 4 < 2 else None
        if u is None:
            u = rng.randrange(ctx["n_users"])
        queries.append(_T(ns, obj, "view", SubjectID(f"user-{u}")))
        expected.append(ctx["grant_ok"](u, grant))
    return queries, expected


def _team_subtree(ctx, team: int) -> list:
    """The team and every team nested below it."""
    out, stack = [], [team]
    while stack:
        t = stack.pop()
        out.append(t)
        stack.extend(ctx["team_children"].get(t, ()))
    return out


def github_list_queries(rng: random.Random, n: int, ctx):
    """``(objects, subjects)`` over config 4's issues, each with its analytic
    expected set, sorted as the list engines sort it:

    - ``objects``: ``(SubjectID("user-u"), [issue names])`` — ListObjects on
      ``issues#view``: the issues whose repo's reader grant is an org one of
      the user's teams roots in, or a team that is one of their teams or an
      ancestor of one;
    - ``subjects``: ``("issue-j", [user ids])`` — ListSubjects on
      ``issues:issue-j#view``: the direct members of every team under the
      granted team (or under the granted org's root teams)."""
    objects, subjects = [], []
    for _ in range(n):
        u = rng.randrange(ctx["n_users"])
        teams, orgs = set(), set()
        for t in ctx["user_teams"].get(u, ()):
            chain, root = ctx["ancestors"](t)
            teams |= chain
            orgs.add(ctx["root_org"][root])
        repos = [r for o in orgs for r in ctx["reader_repos"].get(("org", o), ())]
        repos += [r for t in teams for r in ctx["reader_repos"].get(("team", t), ())]
        issues = {j for r in repos for j in ctx["issues_by_repo"].get(r, ())}
        objects.append((SubjectID(f"user-{u}"), sorted(f"issue-{j}" for j in issues)))
    for _ in range(n):
        j = rng.randrange(len(ctx["issue_repo"]))
        kind, x = ctx["repo_reader"][ctx["issue_repo"][j]]
        roots = ctx["org_roots"][x] if kind == "org" else [x]
        users = {u for r in roots for t in _team_subtree(ctx, r)
                 for u in ctx["team_users"].get(t, ())}
        subjects.append((f"issue-{j}", sorted(f"user-{u}" for u in users)))
    return objects, subjects
