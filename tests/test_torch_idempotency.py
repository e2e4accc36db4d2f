"""Idempotency keys on the write path, against the JAX package on the CPU.

- the store (keto_tpu/persistence/memory.py:556-570, :716-724): keyed and
  unkeyed writes, inserts, deletes and both in one transaction, replays of
  every kind, give the port's ``MemoryPersister`` the same snaptokens,
  replay flags, rows, watermarks, change logs and ``idempotent_replays``
  as the JAX package's store; a replay applies nothing and does not move
  the watermark; a keyed bulk write (4,096 tuples or more) still takes the
  bulk path; the TTL sweep forgets a key as the reference's does
  (tests/test_crashsafe.py:196-221);
- REST (keto_tpu/servers/rest.py:1019-1112): ``X-Idempotency-Key`` on
  ``PUT``, ``DELETE`` and ``PATCH /relation-tuples`` answers a replay with
  the original ``X-Keto-Snaptoken`` and ``X-Keto-Idempotent-Replay: true``,
  the same statuses and headers as the reference daemon's over the same
  script; concurrent keyed writers resent once each through a
  group-commit coordinator replay their tokens, commit in fewer groups
  than writers, and each write reads back at its token; a writer with an
  unknown namespace among concurrent writers to the daemon gets its 404
  alone while the others get 201 with their own tokens; without a
  coordinator the write port commits through the store's own
  transaction.

The writes are drawn from numpy seeds.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.driver.daemon import Daemon
from keto_tpu_torch.driver.group_commit import GroupCommitCoordinator
from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.servers.rest import WRITE, RestServer
from keto_tpu_torch.x.pagination import with_size, with_token

from test_torch_overlay import jt
from test_torch_snapshot import jax_store, port_store

NS = [("g", 1), ("d", 2)]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def rand_tuple(rng):
    objs, users = [f"o{i}" for i in range(5)], [f"u{i}" for i in range(5)]
    sub = (SubjectID(users[rng.integers(5)]) if rng.random() < 0.6
           else SubjectSet("g", objs[rng.integers(5)], "m"))
    return T(("g", "d")[rng.integers(2)], objs[rng.integers(5)], ("m", "view")[rng.integers(2)], sub)


def _all_rows(p):
    out, token = [], ""
    while True:
        got, token = p.get_relation_tuples(RelationQuery(), with_size(1000), with_token(token))
        out += [(t.namespace, t.object, t.relation, str(t.subject)) for t in got]
        if not token:
            return sorted(out)


def _ref_rows(p):
    from keto_tpu.relationtuple.model import RelationQuery as JQ
    from keto_tpu.x.pagination import with_size, with_token

    out, token = [], ""
    while True:
        got, token = p.get_relation_tuples(JQ(), with_size(1000), with_token(token))
        out += [(t.namespace, t.object, t.relation, str(t.subject)) for t in got]
        if not token:
            return sorted(out)


def _ops_key(got):
    if got is None:
        return None
    ops, wm = got
    return [(kind, p if kind == "del" else p.key7()) for kind, p in ops], wm


@pytest.mark.parametrize("seed", range(4))
def test_keyed_writes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    base = [rand_tuple(rng) for _ in range(10)]
    mine, ref = port_store(NS, base), jax_store(NS, base)
    keys: list = []
    marks = [mine.watermark()]
    for rnd in range(25):
        ins = [rand_tuple(rng) for _ in range(rng.integers(0, 4))]
        live = _all_rows(mine)
        dels = []
        if live and rng.random() < 0.4:
            ns, o, r, s = live[rng.integers(len(live))]
            dels = [RelationTuple.from_string(f"{ns}:{o}#{r}@{s}")]
        r = rng.random()
        if keys and r < 0.3:
            key = keys[rng.integers(len(keys))]  # a retry: replays, whatever its body
        elif r < 0.7:
            key = f"k{seed}-{rnd}"
            keys.append(key)
        else:
            key = None
        before = mine.watermark()
        a = mine.transact_relation_tuples(ins, dels, idempotency_key=key)
        b = ref.transact_relation_tuples([jt(t) for t in ins], [jt(t) for t in dels],
                                         idempotency_key=key)
        assert (a.snaptoken, a.replayed) == (b.snaptoken, b.replayed), (rnd, key)
        if a.replayed:
            assert mine.watermark() == before, "a replay moved the watermark"
        assert mine.watermark() == ref.watermark()
        assert _all_rows(mine) == _ref_rows(ref)
        marks.append(mine.watermark())
    assert mine.idempotent_replays == ref.idempotent_replays > 0
    for wm in marks:
        assert _ops_key(mine.changes_since(wm)) == _ops_key(ref.changes_since(wm)), wm


def test_a_replay_applies_nothing():
    p = port_store(NS, [])
    t = T("g", "grp", "m", SubjectID("a"))
    first = p.transact_relation_tuples([t], (), idempotency_key="k")
    log = p.changes_since(0)
    again = p.transact_relation_tuples([t, T("g", "grp", "m", SubjectID("b"))], [t],
                                       idempotency_key="k")
    assert (again.snaptoken, again.replayed) == (first.snaptoken, True)
    assert p.watermark() == first.snaptoken and p.changes_since(0) == log
    assert _all_rows(p) == [("g", "grp", "m", "a")] and p.idempotent_replays == 1


def test_a_keyed_bulk_write_takes_the_bulk_path():
    p = port_store(NS, [])
    bulk = [T("g", f"o{i}", "m", SubjectID(f"u{i % 7}")) for i in range(p._BULK_AT)]
    r = p.transact_relation_tuples(bulk, (), idempotency_key="bulk")
    assert p.snapshot_columns(r.snaptoken) is not None, "the keyed bulk write left the bulk path"
    again = p.transact_relation_tuples(bulk, (), idempotency_key="bulk")
    assert again.replayed and again.snaptoken == r.snaptoken
    assert p.snapshot_columns(r.snaptoken) is not None and p.watermark() == r.snaptoken


def test_a_namespace_error_records_no_key():
    p = port_store(NS, [])
    with pytest.raises(Exception):
        p.transact_relation_tuples([T("nope", "o", "m", SubjectID("a"))], (), idempotency_key="k")
    r = p.transact_relation_tuples([T("g", "o", "m", SubjectID("a"))], (), idempotency_key="k")
    assert not r.replayed and r.snaptoken == 1


def _gc_scenario(p, t1, t2):
    first = p.transact_relation_tuples([t1], (), idempotency_key="gc-key")
    assert first.replayed is False
    assert p.transact_relation_tuples([t1], (), idempotency_key="gc-key").replayed
    # with TTL 0 the next keyed write sweeps every key
    p.idempotency_ttl_s = 0.0
    p.transact_relation_tuples([t2], (), idempotency_key="other")
    res = p.transact_relation_tuples([t1], (), idempotency_key="gc-key")
    assert res.replayed is False, "an expired key must not replay"
    assert res.snaptoken > first.snaptoken
    return [first.snaptoken, res.snaptoken, p.watermark(), p.idempotent_replays]


def test_idempotency_ttl_sweep_equals_reference():
    t1 = T("d", "doc", "view", SubjectID("alice"))
    t2 = T("d", "doc2", "view", SubjectID("bob"))
    mine, ref = port_store(NS, []), jax_store(NS, [])
    assert _gc_scenario(mine, t1, t2) == _gc_scenario(ref, jt(t1), jt(t2))
    assert _all_rows(mine) == _ref_rows(ref) and len(_all_rows(mine)) == 3


def test_keys_within_the_ttl_survive_the_sweep(monkeypatch):
    p = port_store(NS, [])
    now = [1000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    p.transact_relation_tuples([T("g", "o", "m", SubjectID("a"))], (), idempotency_key="old")
    now[0] += p.idempotency_ttl_s - 1
    p.transact_relation_tuples([T("g", "o", "m", SubjectID("b"))], (), idempotency_key="young")
    assert set(p._idempotency) == {"old", "young"}
    now[0] += 2
    p.transact_relation_tuples([T("g", "o", "m", SubjectID("c"))], (), idempotency_key="new")
    assert set(p._idempotency) == {"young", "new"}


@pytest.mark.parametrize("seed", range(3))
def test_the_ttl_sweep_keeps_the_references_keys(monkeypatch, seed):
    """Keyed writes at seeded times, some retries among them: after every
    write the port's dedup holds the keys the reference's holds, with the
    same tokens, though its sweep stops at the first live key."""
    rng = np.random.default_rng(300 + seed)
    mine, ref = port_store(NS, []), jax_store(NS, [])
    mine.idempotency_ttl_s = ref.idempotency_ttl_s = 50.0
    now = [1000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    for i in range(120):
        now[0] += float(rng.exponential(4.0))
        key = f"k{rng.integers(i + 1)}" if rng.random() < 0.3 else f"k{i}"
        t = rand_tuple(rng)
        got = mine.transact_relation_tuples([t], (), idempotency_key=key)
        want = ref.transact_relation_tuples([jt(t)], (), idempotency_key=key)
        assert (got.snaptoken, got.replayed) == (want.snaptoken, want.replayed)
        theirs = ref._shared.idempotency.get(ref.network_id, {})
        assert dict(mine._idempotency) == theirs
    assert mine.idempotent_replays == ref.idempotent_replays > 0


# -- REST ------------------------------------------------------------------------------


def _req(method, port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            raw = resp.read()
            return resp.status, (json.loads(raw) if raw else None), dict(resp.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else None), dict(e.headers)


def _acl(i, j):
    return RelationTuple.from_string(f"acl:obj-{i}#access@user-{j}")


def _key(k):
    return {"X-Idempotency-Key": k}


_WRITE_SCRIPT = [
    ("PUT", "/relation-tuples", _acl(1, 1).to_json(), _key("put-1")),
    ("PUT", "/relation-tuples", _acl(1, 1).to_json(), _key("put-1")),  # replay
    ("PUT", "/relation-tuples", _acl(1, 2).to_json(), _key("put-1")),  # replay, other body
    ("PUT", "/relation-tuples", _acl(2, 2).to_json(), {}),
    ("PUT", "/relation-tuples", _acl(2, 2).to_json(), {}),  # no key: applies again
    ("DELETE", "/relation-tuples?" + _acl(2, 2).to_url_query(), None, _key("del-1")),
    ("DELETE", "/relation-tuples?" + _acl(2, 2).to_url_query(), None, _key("del-1")),
    ("PATCH", "/relation-tuples", [{"action": "insert", "relation_tuple": _acl(3, 3).to_json()},
                                   {"action": "delete", "relation_tuple": _acl(1, 1).to_json()}],
     _key("patch-1")),
    ("PATCH", "/relation-tuples", [{"action": "insert", "relation_tuple": _acl(3, 3).to_json()}],
     _key("patch-1")),
    ("PUT", "/relation-tuples", _acl(4, 4).to_json(), _key("")),  # an empty key is no key
    ("PATCH", "/relation-tuples", [{"action": "nope", "relation_tuple": _acl(5, 5).to_json()}],
     _key("bad")),
    ("PUT", "/relation-tuples", _acl(5, 5).to_json(), _key("bad")),  # the 400 recorded no key
]

_WRITE_HEADERS = ("X-Keto-Snaptoken", "X-Keto-Idempotent-Replay", "Location")


def _write_server(d, transact=None):
    """A second write port over the daemon's store and batcher, writing
    through ``transact`` (None: the store's own transaction)."""
    s = RestServer(WRITE, d.store, d.batcher, transact=transact)
    s.start()
    return s


def test_keyed_rest_writes_equal_reference_daemon():
    from keto_tpu.config.provider import Config
    from keto_tpu.driver.daemon import Daemon as RefDaemon
    from keto_tpu.driver.registry import Registry

    mine = Daemon([tns.Namespace(id=0, name="acl")], device="cpu")
    mine.start()
    ref = RefDaemon(Registry(Config(overrides={"namespaces": [{"id": 0, "name": "acl"}],
                                               "dsn": "memory", "serve.read.port": 0,
                                               "serve.write.port": 0})))
    ref.serve_all(block=False)
    try:
        for method, path, body, headers in _WRITE_SCRIPT:
            got = _req(method, mine.write.port, path, body, headers)
            want = _req(method, ref.write_port, path, body, headers)
            assert got[:2] == want[:2], (method, path, headers)
            assert {k: got[2].get(k) for k in _WRITE_HEADERS} == \
                {k: want[2].get(k) for k in _WRITE_HEADERS}, (method, path, headers)
        assert mine.store.idempotent_replays == 4
        assert _all_rows(mine.store) == _ref_rows(ref.registry.relation_tuple_manager())
        assert mine.writer.writers_total == mine.store.group_commit_writers > 0
    finally:
        mine.stop()
        ref.shutdown()


def test_concurrent_keyed_writers_replay_and_commit_in_groups():
    """16 writers PUT at once, each with its own key, then each resends its
    PUT: the resend replays its token, the store commits the first round in
    fewer groups than writers, and ``?snaptoken=`` reads every write."""
    n = 16
    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu")
    d.start()
    # a write port of its own behind a 50 ms window, so the writers coalesce
    co = GroupCommitCoordinator(d.store, window_ms=50.0)
    co.start()
    w = _write_server(d, co.transact)
    try:
        barrier = threading.Barrier(n)
        first: list = [None] * n
        second: list = [None] * n

        def writer(i):
            barrier.wait()
            first[i] = _req("PUT", w.port, "/relation-tuples", _acl(i, i).to_json(),
                            _key(f"w{i}"))
            second[i] = _req("PUT", w.port, "/relation-tuples", _acl(i, i).to_json(),
                             _key(f"w{i}"))

        threads = [threading.Thread(target=writer, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        toks = [int(r[2]["X-Keto-Snaptoken"]) for r in first]
        assert all(r[0] == 201 for r in first + second)
        assert sorted(toks) == list(range(1, n + 1)), "writers shared or skipped a token"
        assert [int(r[2]["X-Keto-Snaptoken"]) for r in second] == toks
        assert all(r[2].get("X-Keto-Idempotent-Replay") == "true" for r in second)
        assert not any(r[2].get("X-Keto-Idempotent-Replay") for r in first)
        assert co.flush_total < 2 * n and d.store.group_commits == co.flush_total
        assert d.store.idempotent_replays == n and d.store.watermark() == n
        for i, tok in enumerate(toks):
            status, body, headers = _req("GET", d.read.port,
                                         f"/check?{_acl(i, i).to_url_query()}&snaptoken={tok}")
            assert (status, body) == (200, {"allowed": True})
            assert int(headers["X-Keto-Snaptoken"]) >= tok
    finally:
        w.stop()
        co.stop()
        d.stop()


@pytest.mark.parametrize("bad", [0, 5])
def test_a_refused_writer_fails_alone_through_the_daemon(bad):
    """Eight writers PUT at once through the daemon's write port, one of them
    to an unknown namespace: that one alone gets 404 (and its resend 404
    again, its key never recorded); the other seven get 201 with their own
    tokens, durable and readable at them."""
    n = 8
    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu")
    d.start()
    try:
        def body(i):
            return (RelationTuple.from_string(f"nope:obj-{i}#access@user-{i}") if i == bad
                    else _acl(i, i)).to_json()

        barrier = threading.Barrier(n)
        got: list = [None] * n

        def writer(i):
            barrier.wait()
            got[i] = _req("PUT", d.write.port, "/relation-tuples", body(i), _key(f"w{i}"))

        threads = [threading.Thread(target=writer, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert got[bad][0] == 404
        assert _req("PUT", d.write.port, "/relation-tuples", body(bad), _key(f"w{bad}"))[0] == 404
        good = [(i, r) for i, r in enumerate(got) if i != bad]
        assert all(r[0] == 201 and not r[2].get("X-Keto-Idempotent-Replay") for _, r in good)
        toks = [int(r[2]["X-Keto-Snaptoken"]) for _, r in good]
        assert sorted(toks) == list(range(1, n)) and d.store.watermark() == n - 1
        assert d.writer.flush_errors == 0 and d.writer.writers_total == n + 1
        for (i, _), tok in zip(good, toks):
            status, answer, _ = _req("GET", d.read.port,
                                     f"/check?{_acl(i, i).to_url_query()}&snaptoken={tok}")
            assert (status, answer) == (200, {"allowed": True})
    finally:
        d.stop()


def test_solo_writes_without_group_commit():
    """A write port with no coordinator commits through the store's own
    transaction, keys and replays included."""
    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu")
    d.start()
    w = _write_server(d)
    try:
        a = _req("PUT", w.port, "/relation-tuples", _acl(1, 1).to_json(), _key("k"))
        b = _req("PUT", w.port, "/relation-tuples", _acl(1, 1).to_json(), _key("k"))
        assert a[2]["X-Keto-Snaptoken"] == b[2]["X-Keto-Snaptoken"] == "1"
        assert b[2]["X-Keto-Idempotent-Replay"] == "true" and d.store.group_commits == 0
    finally:
        w.stop()
        d.stop()
