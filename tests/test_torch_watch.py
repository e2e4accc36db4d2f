"""The Watch changefeed on the CPU: the port's store seam
(``MemoryPersister.watch_changes_since``) and ``WatchHub``
(keto_tpu_torch/list/watch.py) against the reference's on the same writes
(the watch cases of tests/test_list_watch.py): equal commit groups and
tokens, exactly-once resume from any token, the 410 horizon, the live tail
and ``close()``, the max-streams shed, a stream riding through a fold. Then
the time-based log GC against the reference store's at the same clock, an
engine whose watermark fell behind a GC'd horizon rebuilding in full with
the oracle's decisions, ``GET /watch`` end to end against the reference
daemon's stream on both of the port's backends, and the drain closing an
open stream."""

from __future__ import annotations

import http.client
import json
import threading
import time

import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.list.watch import WatchHub, resume_state
from keto_tpu_torch.persistence.memory import MemoryPersister
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.errors import ErrTooManyRequests, ErrWatchExpired

NSS = [("ns0", 0), ("ns1", 1)]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def _ref_tuple(t):
    from keto_tpu.relationtuple import RelationTuple as RT
    from keto_tpu.relationtuple import SubjectID as RSID
    from keto_tpu.relationtuple import SubjectSet as RSS

    s = t.subject
    sub = RSID(s.id) if isinstance(s, SubjectID) else RSS(s.namespace, s.object, s.relation)
    return RT(namespace=t.namespace, object=t.object, relation=t.relation, subject=sub)


class Pair:
    """The port's store and hub, and the reference's, fed the same writes."""

    def __init__(self, poll_s=0.01, max_streams=64):
        from keto_tpu import namespace as rns
        from keto_tpu.list.watch import WatchHub as RefHub
        from keto_tpu.persistence.memory import MemoryPersister as RefStore

        self.mine = MemoryPersister(tns.MemoryManager([tns.Namespace(id=i, name=n)
                                                      for n, i in NSS]))
        self.ref = RefStore(rns.MemoryManager([rns.Namespace(id=i, name=n) for n, i in NSS]))
        self.hub = WatchHub(self.mine, poll_s=poll_s, max_streams=max_streams)
        self.ref_hub = RefHub(self.ref, poll_s=poll_s, max_streams=max_streams)

    def transact(self, insert=(), delete=()):
        a = self.mine.transact_relation_tuples(list(insert), list(delete))
        b = self.ref.transact_relation_tuples([_ref_tuple(t) for t in insert],
                                              [_ref_tuple(t) for t in delete])
        assert a.snaptoken == b.snaptoken
        return a.snaptoken

    def changes(self, since):
        mine, wm = self.hub.changes_since(since)
        ref, ref_wm = self.ref_hub.changes_since(since)
        assert wm == ref_wm
        assert _groups(mine) == _groups(ref)
        return mine, wm


def _groups(groups):
    return [(int(t), [(a, str(rt)) for a, rt in changes]) for t, changes in groups]


def _random_writes(pair, seed, n=12):
    import random

    rng = random.Random(seed)
    live = []
    for i in range(n):
        ins = [T(rng.choice(["ns0", "ns1"]), f"o{rng.randrange(5)}", "r0",
                 SubjectID(f"u{rng.randrange(4)}") if rng.random() < 0.6
                 else SubjectSet("ns1", f"o{rng.randrange(5)}", "r0"))
               for _ in range(rng.randrange(1, 4))]
        dels = [live.pop(rng.randrange(len(live)))] if live and rng.random() < 0.4 else []
        pair.transact(ins, dels)
        live.extend(ins)


def test_watch_commit_ordered_groups():
    p = Pair()
    p.transact([T("ns0", "a", "r0", SubjectID("u1")), T("ns0", "b", "r0", SubjectID("u2"))])
    p.transact(delete=[T("ns0", "a", "r0", SubjectID("u1"))])
    groups, wm = p.changes(0)
    assert [g[0] for g in groups] == sorted(g[0] for g in groups)
    # one transaction = one group; the two inserts share a snaptoken
    assert len(groups[0][1]) == 2 and all(a == "insert" for a, _ in groups[0][1])
    assert groups[-1][1][0][0] == "delete"
    state, last = resume_state(iter(groups))
    assert last == wm and set(state) == {"ns0:b#r0@u2"}


@pytest.mark.parametrize("seed", range(3))
def test_watch_resume_any_token_exactly_once(seed):
    p = Pair()
    _random_writes(p, seed)
    full, wm = p.changes(0)
    for cut in range(0, wm + 1):
        part, _ = p.changes(cut)
        # exactly the groups after the cut: no duplicates, no gaps
        assert [g[0] for g in part] == [g[0] for g in full if g[0] > cut]
        state, _ = resume_state(iter(full[: len(full) - len(part)] + part))
        assert state == resume_state(iter(full))[0]


def test_watch_expired_horizon():
    p = Pair()
    p.mine.LOG_CAP = 8
    p.ref._shared.LOG_CAP = 8
    for i in range(20):
        p.transact([T("ns0", f"o{i}", "r0", SubjectID("u"))])
    for hub in (p.hub, p.ref_hub):
        with pytest.raises(ErrWatchExpired if hub is p.hub else Exception) as ei:
            hub.changes_since(1)
        assert type(ei.value).__name__ == "ErrWatchExpired" and ei.value.status_code == 410
        assert hub.expired_total == 1
    groups, _ = p.changes(p.mine.watermark())
    assert groups == []
    # the horizon is the same on both: the oldest token each still serves
    first = min(t for t in range(21) if _serves(p.hub, t))
    assert first == min(t for t in range(21) if _serves(p.ref_hub, t))


def _serves(hub, token):
    try:
        hub.changes_since(token)
        return True
    except Exception:
        return False


def test_watch_live_tail_and_close():
    p = Pair()
    got = []

    def run():
        for token, changes in p.hub.subscribe(0):
            got.append((token, changes))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    time.sleep(0.05)
    p.transact([T("ns0", "x", "r0", SubjectID("u9"))])
    deadline = time.time() + 5
    while not got and time.time() < deadline:
        time.sleep(0.01)
    assert got and str(got[0][1][0][1]) == "ns0:x#r0@u9"
    assert p.hub.active_streams == 1 and p.hub.events_total == 1
    p.hub.close()
    th.join(timeout=5)
    assert not th.is_alive() and p.hub.active_streams == 0


def test_watch_max_streams_sheds():
    p = Pair(max_streams=1)
    assert p.hub.try_acquire_stream()
    with pytest.raises(ErrTooManyRequests):
        next(iter(p.hub.subscribe(0)))
    p.hub.release_stream()
    assert p.hub.try_acquire_stream()
    p.hub.release_stream()


def test_watch_rides_through_a_fold():
    """Engine-side maintenance (overlays, the background fold, a full
    rebuild) never disturbs the changefeed: the logs are store-side."""
    p = Pair()
    p.transact([T("ns0", f"o{i}", "r0", SubjectID("u")) for i in range(20)])
    eng = TorchCheckEngine(p.mine, p.mine.namespaces, device="cpu")
    try:
        eng.snapshot()
        p.transact([T("ns0", "late", "r0", SubjectID("u"))])
        p.transact(delete=[T("ns0", "o3", "r0", SubjectID("u"))])
        eng.snapshot()
        eng.maintenance_settled(fold=True)
        groups, _ = p.changes(0)
        state, _ = resume_state(iter(groups))
        assert "ns0:late#r0@u" in state and "ns0:o3#r0@u" not in state and len(state) == 20
    finally:
        eng.close()


@pytest.mark.parametrize("cap", [0, 1, 3, 10000])
def test_time_based_gc_equals_the_reference(cap):
    """``gc_watch_logs`` at the same clock prunes the same entries and
    raises the same horizon as the reference store's, the cap included."""
    p = Pair()
    for store in (p.mine, p.ref):
        store.watch_log_retention_s = 100.0
        store.watch_gc_max_rows = cap
    _random_writes(p, 7, n=10)
    t0 = time.time()
    assert p.mine.gc_watch_logs(now=t0) == p.ref.gc_watch_logs(now=t0) == 0
    for later in (t0 + 1000.0, t0 + 1000.0, t0 + 2000.0):
        assert p.mine.gc_watch_logs(now=later) == p.ref.gc_watch_logs(now=later)
        floors = (p.mine._log_floor, p.mine._del_floor)
        assert floors == (p.ref._shared.log_floor.get("default", 0),
                          p.ref._shared.del_floor.get("default", 0))
        for token in range(p.mine.watermark() + 1):
            assert _serves(p.hub, token) == _serves(p.ref_hub, token), token


def test_engine_behind_a_gcd_horizon_rebuilds_in_full():
    """The GC raises the floors the engine's delta path reads: an engine
    whose watermark fell behind the horizon takes a full rebuild, never a
    delta that lacks the pruned rows, and decides as the oracle does."""
    nm = tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in NSS])
    store = MemoryPersister(nm)
    store.watch_log_retention_s = 60.0
    store.write_relation_tuples(T("ns1", "g", "m", SubjectID("alice")),
                                T("ns0", "doc", "r0", SubjectSet("ns1", "g", "m")))
    eng = TorchCheckEngine(store, nm, device="cpu", labels_enabled=False)
    try:
        eng.snapshot()
        wm = store.watermark()
        store.write_relation_tuples(T("ns1", "g", "m", SubjectID("bob")))
        store.delete_relation_tuples(T("ns1", "g", "m", SubjectID("alice")))
        store.write_relation_tuples(T("ns1", "h", "m", SubjectID("carol")),
                                    T("ns0", "doc", "r0", SubjectSet("ns1", "h", "m")))
        assert store.changes_since(wm) is not None
        assert store.gc_watch_logs(now=time.time() + 3600.0) > 0
        assert store.changes_since(wm) is None
        with pytest.raises(ErrWatchExpired):
            store.watch_changes_since(wm)
        before = eng.counters().get("full_rebuilds", 0)
        snap = eng.snapshot()
        assert snap.snapshot_id == store.watermark()
        assert eng.counters().get("full_rebuilds", 0) == before + 1
        oracle = CheckEngine(store)
        checks = [T("ns0", "doc", "r0", SubjectID(u)) for u in ("alice", "bob", "carol", "dan")]
        got = [bool(a) for a in eng.batch_check(checks)]
        assert got == [oracle.subject_is_allowed(c) for c in checks] == [False, True, True, False]
    finally:
        eng.close()


# -- GET /watch end to end --------------------------------------------------------


def _stream(port, token, out, ready):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", f"/watch?snaptoken={token}")
    resp = conn.getresponse()
    out.append(resp.status)
    ready.set()
    while True:
        line = resp.readline()
        if not line:
            break
        out.append(json.loads(line))
    conn.close()


def _port_daemon(**keys):
    """The port's daemon over a ``Registry`` of ``keys`` on the loopback."""
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.driver.registry import Registry

    cfg = Config(overrides={"namespaces": [{"id": i, "name": n} for n, i in NSS],
                            "serve.read.host": "127.0.0.1", "serve.read.port": 0,
                            "serve.write.host": "127.0.0.1", "serve.write.port": 0,
                            **keys}, env={})
    d = Daemon(Registry(cfg, device="cpu"))
    d.start()
    return d


def _lines(got):
    return [{k: v for k, v in m.items() if k not in ("committed_at", "emitted_at", "traceparent")}
            for m in got[1:]]


@pytest.mark.parametrize("backend", ["threading", "async"])
def test_get_watch_streams_as_the_reference(backend):
    from keto_tpu.config.provider import Config as RefConfig
    from keto_tpu.driver.daemon import Daemon as RefDaemon
    from keto_tpu.driver.registry import Registry as RefRegistry

    nss = [{"id": i, "name": n} for n, i in NSS]
    mine = _port_daemon(**{"serve.http_backend": backend, "serve.watch_poll_ms": 20.0,
                           "tracing.provider": "memory"})
    ref = RefDaemon(RefRegistry(RefConfig(overrides={
        "namespaces": nss, "serve.read.port": 0, "serve.write.port": 0,
        "serve.watch_poll_ms": 20.0, "tracing.provider": "memory"})))
    ref.serve_all(block=False)
    try:
        streams = {}
        for name, port in (("mine", mine.read_port), ("ref", ref.read_port)):
            out, ready = [], threading.Event()
            th = threading.Thread(target=_stream, args=(port, 0, out, ready), daemon=True)
            th.start()
            assert ready.wait(10)
            streams[name] = (out, th)
        writes = [
            ("PUT", "/relation-tuples", {"namespace": "ns0", "object": "a", "relation": "r0",
                                         "subject_id": "u1"}),
            ("PATCH", "/relation-tuples", [
                {"action": "insert", "relation_tuple": {"namespace": "ns1", "object": "g",
                                                        "relation": "m", "subject_id": "u2"}},
                {"action": "delete", "relation_tuple": {"namespace": "ns0", "object": "a",
                                                        "relation": "r0", "subject_id": "u1"}}]),
            ("DELETE", "/relation-tuples?namespace=ns1&object=g&relation=m&subject_id=u2", None),
        ]
        tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
        for port in (mine.write_port, ref.write_port):
            for method, path, body in writes:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                conn.request(method, path, body=None if body is None else json.dumps(body),
                             headers={"traceparent": tp})
                assert conn.getresponse().status in (201, 204)
                conn.close()
        deadline = time.time() + 10
        while any(len(o) < 4 for o, _ in streams.values()) and time.time() < deadline:
            time.sleep(0.02)
        got, want = streams["mine"][0], streams["ref"][0]
        assert got[0] == want[0] == 200
        assert _lines(got) == _lines(want) and len(_lines(got)) == 3
        # every write registered its trace with the hub (the same trace id;
        # the span ids are each server's own); a line carries it unless the
        # hub's poll emitted the group before the handler registered it, a
        # race the reference has too (then the line has no committed_at)
        for daemon, lines in ((mine, got), (ref, want)):
            for m in lines[1:]:
                reg_tp, _ = daemon.registry.watch_hub().commit_trace(int(m["snaptoken"]))
                assert reg_tp.split("-")[1] == tp.split("-")[1]
                assert m.get("traceparent", reg_tp) == reg_tp
                assert ("traceparent" in m) == ("committed_at" in m)
        # a resume from the first token answers the rest; below the horizon 410
        for daemon in (mine, ref):
            conn = http.client.HTTPConnection("127.0.0.1", daemon.read_port, timeout=10)
            conn.request("GET", "/watch?snaptoken=x")
            assert conn.getresponse().status == 400
            conn.close()
    finally:
        mine.drain_and_shutdown()
        ref.drain_and_shutdown()
    for out, th in streams.values():
        th.join(timeout=10)
        assert not th.is_alive(), "the drain did not end the stream"


def test_watch_410_and_429_over_http():
    from test_torch_rest import _req

    d = _port_daemon(**{"serve.watch_max_streams": 1})
    try:
        d.store.LOG_CAP = 2
        for i in range(5):
            d.store.write_relation_tuples(T("ns0", f"o{i}", "r0", SubjectID("u")))
        status, body, _ = _req("GET", d.read.port, "/watch?snaptoken=1")
        assert status == 410 and body["error"]["code"] == 410
        out, ready = [], threading.Event()
        th = threading.Thread(target=_stream, args=(d.read.port, d.store.watermark(), out,
                                                     ready), daemon=True)
        th.start()
        assert ready.wait(10) and out[0] == 200
        status, body, headers = _req("GET", d.read.port, f"/watch?snaptoken={d.store.watermark()}")
        assert status == 429 and headers["Retry-After"] == "1"
        assert _req("GET", d.write.port, "/watch")[0] == 404
    finally:
        d.drain_and_shutdown()
    th.join(timeout=10)
    assert not th.is_alive()
