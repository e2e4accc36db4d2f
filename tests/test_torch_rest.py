"""The port's REST server on the CPU: the cat-videos checks answer 200/403,
a write on the write port is visible to the next check, and the batch and
health routes answer. The reverse queries (``/relation-tuples/list-objects``
and ``/relation-tuples/list-subjects``) answer with their status codes,
400s, pages and snaptoken header, and ``?latest=`` reads a PUT back.
``GET /check/explain`` answers a grant with a verified witness and a deny
with a certificate (both 200), a nil subject with 400, and 404 when
explain is disabled; ``/check`` samples its decisions into the decision
log; the CLI passes the explain and decision-log flags through.
``/version`` answers on both ports; ``GET /expand`` answers the reference's
tree, a 400 without an integer ``max-depth`` and clamps the depth to
``max_read_depth``; ``GET /relation-tuples`` pages the store (a malformed
``page_size`` is a 400, an unknown namespace a 404); ``PATCH
/relation-tuples`` applies inserts and deletes in one transaction, and an
unknown action or namespace applies nothing (tests/test_rest_api.py:59,
:106, :131, :166). The check scheduler over REST: ``X-Keto-Priority`` and
``timeout_ms`` / ``X-Request-Timeout-Ms`` answer as the reference's
servers do (400s, 504), a shed ``/check/batch`` answers 429 with
``Retry-After`` as the reference's, responses carry ``X-Request-Id`` and
``Server-Timing``, ``GET /debug/requests`` answers with its filters, the
decision log takes its route and trace id from the timeline, a drain
answers 503 on ``/health/ready`` while in-flight checks finish, and the
CLI and daemon pass the scheduler's knobs."""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import urlencode

import pytest

from keto_tpu_torch.driver.daemon import Daemon
from keto_tpu_torch.relationtuple.model import RelationTuple
from keto_tpu_torch.workloads import (
    CAT_VIDEOS_CHECKS,
    CAT_VIDEOS_NAMESPACES,
    CAT_VIDEOS_TUPLES,
    parse_tuples,
)


def _req(method, port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if raw else None), dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else None), dict(e.headers)


@pytest.fixture
def daemon():
    d = Daemon(CAT_VIDEOS_NAMESPACES, device="cpu", tuples=parse_tuples(CAT_VIDEOS_TUPLES))
    d.start()
    yield d
    d.stop()


@pytest.mark.parametrize("check,allowed", CAT_VIDEOS_CHECKS)
def test_cat_videos_get_check(daemon, check, allowed):
    q = RelationTuple.from_string(check).to_url_query()
    status, body, headers = _req("GET", daemon.read.port, "/check?" + q)
    assert (status, body) == ((200 if allowed else 403), {"allowed": allowed})
    assert headers["X-Keto-Snaptoken"] == "1"


def test_post_check_and_batch(daemon):
    tuples = [RelationTuple.from_string(c) for c, _ in CAT_VIDEOS_CHECKS]
    status, body, _ = _req("POST", daemon.read.port, "/check", tuples[2].to_json())
    assert (status, body) == (403, {"allowed": False})
    status, body, _ = _req("POST", daemon.read.port, "/check/batch",
                           {"tuples": [t.to_json() for t in tuples]})
    assert status == 200 and body == {"results": [a for _, a in CAT_VIDEOS_CHECKS]}
    status, body, _ = _req("POST", daemon.read.port, "/check/batch", {"tuples": []})
    assert status == 400


def test_write_then_check(daemon):
    new = RelationTuple.from_string("videos:/cats/2.mp4#view@*")
    status, _, _ = _req("GET", daemon.read.port, "/check?" + new.to_url_query())
    assert status == 403
    status, body, headers = _req("PUT", daemon.write.port, "/relation-tuples", new.to_json())
    assert status == 201 and body == new.to_json()
    assert headers["X-Keto-Snaptoken"] == "2"
    status, body, headers = _req("GET", daemon.read.port, "/check?" + new.to_url_query())
    assert (status, body, headers["X-Keto-Snaptoken"]) == (200, {"allowed": True}, "2")
    status, _, _ = _req("DELETE", daemon.write.port, "/relation-tuples?" + new.to_url_query())
    assert status == 204
    status, _, _ = _req("GET", daemon.read.port, "/check?" + new.to_url_query())
    assert status == 403


@pytest.mark.parametrize("token,status", [("1", 200), ("", 200), ("x1", 400), ("1.5", 400)])
def test_snaptoken_is_validated(daemon, token, status):
    """The latest snapshot serves every well-formed token; a malformed one
    is the caller's error."""
    t = RelationTuple.from_string(CAT_VIDEOS_CHECKS[0][0])
    got = _req("GET", daemon.read.port, f"/check?{t.to_url_query()}&snaptoken={token}")
    assert got[0] == status
    got = _req("POST", daemon.read.port, f"/check/batch?snaptoken={token}",
               {"tuples": [t.to_json()]})
    assert got[0] == status
    if status == 400:
        assert "malformed snaptoken" in got[1]["error"]["message"]


def test_errors_and_health(daemon):
    q = urlencode({"namespace": "videos", "object": "/cats", "relation": "view"})
    status, body, _ = _req("GET", daemon.read.port, "/check?" + q)
    assert status == 400 and body["error"]["message"] == "Subject has to be specified."
    status, body, _ = _req("PUT", daemon.write.port, "/relation-tuples",
                           {"namespace": "nope", "object": "o", "relation": "r",
                            "subject_id": "u"})
    assert status == 404
    for port in (daemon.read.port, daemon.write.port):
        assert _req("GET", port, "/health/alive")[:2] == (200, {"status": "ok"})
        assert _req("GET", port, "/health/ready")[:2] == (200, {"status": "ok"})
    assert _req("GET", daemon.write.port, "/check?" + q)[0] == 404


def write_config(path, namespaces, **keys):
    """A JSON config for ``serve -c``: the namespaces, both ports 0 and
    ``keys`` as dotted keys over the defaults."""
    cfg = {"dsn": "memory", "namespaces": namespaces,
           "serve": {"read": {"port": 0}, "write": {"port": 0}}}
    for dotted, value in keys.items():
        cur = cfg
        *head, last = dotted.split(".")
        for part in head:
            cur = cur.setdefault(part, {})
        cur[last] = value
    path.write_text(json.dumps(cfg))
    return path


class cli_serve:
    """``python -m keto_tpu_torch serve -c CFG --device cpu`` as a
    subprocess: ``read_port``/``write_port`` and ``line`` come from its
    first stdout line; ``stop()`` sends SIGTERM and answers the exit code."""

    def __init__(self, cfg, *extra):
        import subprocess
        import sys
        from pathlib import Path

        self.proc = subprocess.Popen(
            [sys.executable, "-m", "keto_tpu_torch", "serve", "-c", str(cfg), "--device", "cpu",
             *extra],
            cwd=Path(__file__).resolve().parent.parent, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        self.line = self.proc.stdout.readline()
        m = re.search(r"read :(\d+), write :(\d+), device cpu", self.line)
        if not m:
            err = self.proc.stderr.read() if self.proc.poll() is not None else ""
            self.kill()
            raise AssertionError((self.line, err))
        self.read_port, self.write_port = int(m.group(1)), int(m.group(2))

    def stop(self, timeout=30):
        import signal

        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=timeout)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def put_tuples(port, tuples):
    for t in tuples:
        status, _, _ = _req("PUT", port, "/relation-tuples", t.to_json())
        assert status == 201, t


def test_cli_serve_on_cpu(tmp_path):
    """``python -m keto_tpu_torch serve -c cfg.json --device cpu`` takes the
    cat-videos tuples through its write port, answers the cat-videos checks
    and exits 0 on SIGTERM."""
    cfg = write_config(tmp_path / "cfg.json", [n.to_json() for n in CAT_VIDEOS_NAMESPACES])
    srv = cli_serve(cfg)
    try:
        put_tuples(srv.write_port, parse_tuples(CAT_VIDEOS_TUPLES))
        for check, allowed in CAT_VIDEOS_CHECKS:
            q = RelationTuple.from_string(check).to_url_query()
            assert _req("GET", srv.read_port, "/check?" + q + "&latest=true")[0] == \
                (200 if allowed else 403)
        assert srv.stop() == 0
    finally:
        srv.kill()


def test_cli_rejects_a_malformed_namespace(tmp_path):
    """The schema refuses a namespace entry without an id, before anything
    is served; a name with '=' in it is a name like any other."""
    from keto_tpu_torch.cmd import main
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.x.errors import ErrBadRequest

    bad = write_config(tmp_path / "bad.json", [{"name": "videos"}])
    with pytest.raises(ErrBadRequest, match="invalid configuration"):
        Config(config_file=str(bad), env={})
    assert main(["serve", "-c", str(bad), "--device", "cpu"]) == 1
    good = write_config(tmp_path / "good.json", [{"name": "a=b", "id": 3}])
    nss = Config(config_file=str(good), env={}).namespace_manager().namespaces()
    assert [(n.name, n.id) for n in nss] == [("a=b", 3)]


LIST_OBJECTS = "/relation-tuples/list-objects?"
LIST_SUBJECTS = "/relation-tuples/list-subjects?"


def test_list_endpoints_answer(daemon):
    q = urlencode({"namespace": "videos", "relation": "view", "subject_id": "cat lady"})
    status, body, headers = _req("GET", daemon.read.port, LIST_OBJECTS + q)
    assert status == 200 and headers["X-Keto-Snaptoken"] == "1"
    assert body == {"objects": ["/cats", "/cats/1.mp4", "/cats/2.mp4"], "next_page_token": "",
                    "snaptoken": "1"}
    q = urlencode({"namespace": "videos", "object": "/cats/1.mp4", "relation": "view"})
    status, body, headers = _req("GET", daemon.read.port, LIST_SUBJECTS + q)
    assert (status, body["subject_ids"], headers["X-Keto-Snaptoken"]) == (
        200, ["*", "cat lady"], "1")
    # a subject set as the subject
    q = urlencode({"namespace": "videos", "relation": "view", "subject_set.namespace": "videos",
                   "subject_set.object": "/cats", "subject_set.relation": "owner"})
    assert _req("GET", daemon.read.port, LIST_OBJECTS + q)[1]["objects"] == [
        "/cats", "/cats/1.mp4", "/cats/2.mp4"]
    assert daemon.lister.requests_total[("objects", "device")] == 2


def test_list_endpoints_page(daemon):
    base = {"namespace": "videos", "relation": "view", "subject_id": "cat lady", "page_size": "2"}
    status, body, _ = _req("GET", daemon.read.port, LIST_OBJECTS + urlencode(base))
    assert status == 200 and body["objects"] == ["/cats", "/cats/1.mp4"] and body["next_page_token"]
    nxt = dict(base, page_token=body["next_page_token"])
    status, body, _ = _req("GET", daemon.read.port, LIST_OBJECTS + urlencode(nxt))
    assert (status, body["objects"], body["next_page_token"]) == (200, ["/cats/2.mp4"], "")


@pytest.mark.parametrize("path,query", [
    (LIST_OBJECTS, {"namespace": "videos", "relation": "view"}),
    (LIST_OBJECTS, {"relation": "view", "subject_id": "cat lady"}),
    (LIST_OBJECTS, {"namespace": "videos", "subject_id": "cat lady"}),
    (LIST_OBJECTS, {"namespace": "videos", "relation": "view", "subject_id": "x",
                    "page_token": "$bad"}),
    (LIST_OBJECTS, {"namespace": "videos", "relation": "view", "subject_id": "x",
                    "page_size": "-1"}),
    (LIST_OBJECTS, {"namespace": "videos", "relation": "view", "subject_id": "x",
                    "snaptoken": "x1"}),
    (LIST_SUBJECTS, {"namespace": "videos", "object": "/cats"}),
    (LIST_SUBJECTS, {"object": "/cats", "relation": "view"}),
    (LIST_SUBJECTS, {"namespace": "videos", "relation": "view"}),
    (LIST_SUBJECTS, {"namespace": "videos", "object": "/cats", "relation": "view",
                     "page_size": "two"}),
])
def test_list_endpoints_reject_incomplete_queries(daemon, path, query):
    status, body, _ = _req("GET", daemon.read.port, path + urlencode(query))
    assert status == 400, body
    assert _req("GET", daemon.write.port, path + urlencode(query))[0] == 404


def test_list_latest_reads_a_put_back(daemon):
    new = RelationTuple.from_string("videos:/cats/2.mp4#view@dog")
    status, _, headers = _req("PUT", daemon.write.port, "/relation-tuples", new.to_json())
    assert status == 201 and headers["X-Keto-Snaptoken"] == "2"
    for extra in ({"latest": "true"}, {"snaptoken": "2"}):
        q = urlencode({"namespace": "videos", "object": "/cats/2.mp4", "relation": "view", **extra})
        status, body, headers = _req("GET", daemon.read.port, LIST_SUBJECTS + q)
        assert (status, body["subject_ids"], body["snaptoken"], headers["X-Keto-Snaptoken"]) == (
            200, ["cat lady", "dog"], "2", "2")
    q = urlencode({"namespace": "videos", "relation": "view", "subject_id": "dog",
                   "latest": "true"})
    assert _req("GET", daemon.read.port, LIST_OBJECTS + q)[1]["objects"] == ["/cats/2.mp4"]


EXPLAIN = "/check/explain?"


def test_explain_contract(daemon):
    grant = RelationTuple.from_string("videos:/cats/1.mp4#view@cat lady")
    status, body, headers = _req("GET", daemon.read.port, EXPLAIN + grant.to_url_query())
    assert status == 200 and body["allowed"] and body["verified"], body
    assert body["witness_source"] == "backtrace" and body["route"] in ("label", "hybrid", "bfs")
    assert [RelationTuple.from_json(w).to_url_query() for w in body["witness"]] == [
        RelationTuple.from_string(t).to_url_query() for t in (
            "videos:/cats/1.mp4#view@(videos:/cats/1.mp4#owner)",
            "videos:/cats/1.mp4#owner@(videos:/cats#owner)",
            "videos:/cats#owner@cat lady")]
    assert headers["X-Keto-Snaptoken"] == body["snaptoken"] == "1"

    deny = RelationTuple.from_string("videos:/cats/2.mp4#view@*")
    status, body, _ = _req("GET", daemon.read.port, EXPLAIN + deny.to_url_query())
    assert status == 200 and body["allowed"] is False and body["witness"] is None
    assert body["certificate"]["type"] == "frontier-exhaustion"

    q = urlencode({"namespace": "videos", "object": "/cats", "relation": "view"})
    status, body, _ = _req("GET", daemon.read.port, EXPLAIN + q)
    assert status == 400 and body["error"]["message"] == "Subject has to be specified."
    status, _, _ = _req("GET", daemon.read.port, EXPLAIN + grant.to_url_query() + "&snaptoken=x")
    assert status == 400
    # pinned to a write's snaptoken: the write is explained
    status, _, headers = _req("PUT", daemon.write.port, "/relation-tuples", deny.to_json())
    token = headers["X-Keto-Snaptoken"]
    status, body, headers = _req("GET", daemon.read.port,
                                 EXPLAIN + deny.to_url_query() + "&snaptoken=" + token)
    assert status == 200 and body["allowed"] and body["verified"]
    assert body["snaptoken"] == headers["X-Keto-Snaptoken"] == token
    assert daemon.explain.verify_failures == 0
    assert sum(daemon.explain.requests_by_route.values()) == 3
    assert _req("GET", daemon.write.port, EXPLAIN + grant.to_url_query())[0] == 404


def test_explain_disabled_is_404():
    d = Daemon(CAT_VIDEOS_NAMESPACES, device="cpu", tuples=parse_tuples(CAT_VIDEOS_TUPLES),
               explain_enabled=False)
    d.start()
    try:
        grant = RelationTuple.from_string("videos:/cats/1.mp4#view@cat lady")
        status, body, _ = _req("GET", d.read.port, EXPLAIN + grant.to_url_query())
        assert status == 404 and "explain disabled" in body["error"]["message"]
        assert _req("GET", d.read.port, "/check?" + grant.to_url_query())[0] == 200
        assert d.explain is None and d.decision_log is None
    finally:
        d.stop()


def test_check_samples_into_the_decision_log(tmp_path):
    from keto_tpu_torch.explain import DecisionLog

    d = Daemon(CAT_VIDEOS_NAMESPACES, device="cpu", tuples=parse_tuples(CAT_VIDEOS_TUPLES),
               decision_log_dir=str(tmp_path / "dlog"), decision_log_sample=1.0)
    d.start()
    try:
        for check, allowed in CAT_VIDEOS_CHECKS:
            q = RelationTuple.from_string(check).to_url_query()
            assert _req("GET", d.read.port, "/check?" + q)[0] == (200 if allowed else 403)
        grant = RelationTuple.from_string(CAT_VIDEOS_CHECKS[0][0])
        assert _req("GET", d.read.port, EXPLAIN + grant.to_url_query())[0] == 200
    finally:
        d.stop()
    recs, corrupt = DecisionLog(str(tmp_path / "dlog")).read_all("default")
    checks = [r for r in recs if r["kind"] == "check"]
    assert corrupt == 0 and [c["decision"] for c in checks] == [a for _, a in CAT_VIDEOS_CHECKS]
    for c in checks:
        # the route comes off the request timeline's device stamp, the
        # trace id is the request id (no traceparent was sent)
        assert c["route"] in ("host", "label", "hybrid", "bfs") and c["trace_id"]
        assert c["witness"] is None and c["snaptoken"] == "1"
    explains = [r for r in recs if r["kind"] == "explain"]
    assert len(explains) == 1 and explains[0]["witness"] and explains[0]["decision"] is True


def test_cli_passes_the_explain_flags(tmp_path):
    """The explain and decision-log keys of a ``serve -c`` config reach the
    registry's explain engine and decision log."""
    from keto_tpu_torch.cmd import build_parser
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.driver.registry import Registry, schema_default

    nss = [{"id": 0, "name": "acl"}]
    args = build_parser().parse_args(["serve", "-c", str(write_config(tmp_path / "a.json", nss))])
    cfg = Config(config_file=args.config, env={})
    keys = ("serve.explain_enabled", "serve.decision_log_dir", "serve.decision_log_sample",
            "serve.decision_log_segment_bytes", "serve.decision_log_retention")
    assert tuple(cfg.get(k, schema_default(k)) for k in keys) == (True, "", 0.0, 1 << 20, 8)
    reg = Registry(cfg, device="cpu")
    try:
        assert reg.explain_engine() is not None and reg.decision_log() is None
    finally:
        reg.close()
    cfg_path = write_config(tmp_path / "b.json", nss, **{
        "serve.explain_enabled": False, "serve.decision_log_dir": str(tmp_path / "x"),
        "serve.decision_log_sample": 0.25, "serve.decision_log_segment_bytes": 4096,
        "serve.decision_log_retention": 2})
    args = build_parser().parse_args(["serve", "-c", str(cfg_path)])
    reg = Registry(Config(config_file=args.config, env={}), device="cpu")
    try:
        dl = reg.decision_log()
        assert reg.explain_engine() is None
        assert (str(dl._root), dl._sample, dl._segment_bytes, dl._retention) == \
            (str(tmp_path / "x"), 0.25, 4096, 2)
    finally:
        reg.close()


# -- the tuple API: /version, /expand, GET and PATCH /relation-tuples ----------


def _tuple_json(ns, obj, rel, subject_id=None, subject_set=None):
    body = {"namespace": ns, "object": obj, "relation": rel}
    if subject_id is not None:
        body["subject_id"] = subject_id
    if subject_set is not None:
        body["subject_set"] = subject_set
    return body


@pytest.fixture
def api():
    """tests/test_rest_api.py's servers: two namespaces, no tuples."""
    from keto_tpu_torch import namespace as tns

    d = Daemon([tns.Namespace(id=0, name="videos"), tns.Namespace(id=1, name="groups")],
               device="cpu")
    d.start()
    yield d
    d.stop()


def test_version_on_both_ports(api):
    from keto_tpu.version import __version__ as ref_version

    for port in (api.read.port, api.write.port):
        status, body, _ = _req("GET", port, "/version")
        assert (status, body) == (200, {"version": ref_version})


def test_expand(api):
    _req("PUT", api.write.port, "/relation-tuples",
         _tuple_json("videos", "v2", "view",
                     subject_set={"namespace": "groups", "object": "g1", "relation": "member"}))
    _req("PUT", api.write.port, "/relation-tuples", _tuple_json("groups", "g1", "member",
                                                                 subject_id="u1"))
    status, body, _ = _req("GET", api.read.port,
                           "/expand?namespace=videos&object=v2&relation=view&max-depth=3")
    assert status == 200
    assert body == {"type": "union",
                    "subject_set": {"namespace": "videos", "object": "v2", "relation": "view"},
                    "children": [{"type": "union",
                                  "subject_set": {"namespace": "groups", "object": "g1",
                                                  "relation": "member"},
                                  "children": [{"type": "leaf", "subject_id": "u1"}]}]}
    # no tree: an empty 200
    status, body, _ = _req("GET", api.read.port,
                           "/expand?namespace=videos&object=nope&relation=view&max-depth=3")
    assert (status, body) == (200, None)
    # an absent or non-integer max-depth is a 400 (the reference parses it)
    for q in ("", "&max-depth=", "&max-depth=two"):
        status, body, _ = _req("GET", api.read.port,
                               "/expand?namespace=videos&object=v2&relation=view" + q)
        assert status == 400 and body["error"]["code"] == 400
    # an unknown namespace is a 404 and expand is a read route only
    status, _, _ = _req("GET", api.read.port,
                        "/expand?namespace=nope&object=v2&relation=view&max-depth=3")
    assert status == 404
    assert _req("GET", api.write.port,
                "/expand?namespace=videos&object=v2&relation=view&max-depth=3")[0] == 404


def _depth(tree):
    return 0 if tree is None else 1 + max((_depth(c) for c in tree.get("children", ())),
                                          default=0)


@pytest.mark.parametrize("cap,asked,want", [
    (5, 0, 5), (5, -1, 5), (5, 2, 2), (5, 5, 5), (5, 100, 5), (3, 0, 3), (3, 4, 3), (3, 1, 1),
])
def test_expand_depth_is_clamped_to_max_read_depth(cap, asked, want):
    """keto_tpu/driver/registry.py:768-773: 0, a negative depth or one past
    the cap takes the cap."""
    from keto_tpu import namespace as jns
    from keto_tpu.expand.engine import ExpandEngine as RefExpand
    from keto_tpu.persistence.memory import MemoryPersister as JaxPersister
    from keto_tpu.relationtuple.model import RelationTuple as JT
    from keto_tpu.relationtuple.model import SubjectSet as JSet
    from keto_tpu_torch import namespace as tns

    chain = [RelationTuple.from_string(f"groups:g{i}#member@groups:g{i + 1}#member")
             for i in range(8)]
    chain.append(RelationTuple.from_string("groups:g8#member@u"))
    d = Daemon([tns.Namespace(id=1, name="groups")], device="cpu", tuples=chain,
               max_read_depth=cap)
    d.start()
    try:
        status, body, _ = _req("GET", d.read.port,
                               f"/expand?namespace=groups&object=g0&relation=member"
                               f"&max-depth={asked}")
    finally:
        d.stop()
    assert status == 200 and _depth(body) == want
    ref = JaxPersister(jns.MemoryManager([jns.Namespace(id=1, name="groups")]))
    ref.write_relation_tuples(*(JT.from_string(str(t)) for t in chain))
    assert body == RefExpand(ref).build_tree(JSet("groups", "g0", "member"), want).to_json()


def test_relation_tuples_crud_and_pagination(api):
    for i in range(5):
        _req("PUT", api.write.port, "/relation-tuples",
             _tuple_json("videos", "list", "view", subject_id=f"u{i}"))
    status, body, _ = _req("GET", api.read.port,
                           "/relation-tuples?namespace=videos&object=list&relation=view"
                           "&page_size=2")
    assert status == 200 and len(body["relation_tuples"]) == 2
    assert body["next_page_token"] == "2"
    seen = [t["subject_id"] for t in body["relation_tuples"]]
    token = body["next_page_token"]
    while token:
        status, body, _ = _req("GET", api.read.port,
                               "/relation-tuples?namespace=videos&object=list&relation=view"
                               f"&page_size=2&page_token={token}")
        assert status == 200
        seen += [t["subject_id"] for t in body["relation_tuples"]]
        token = body["next_page_token"]
    assert seen == [f"u{i}" for i in range(5)]
    assert body["relation_tuples"][0] == _tuple_json("videos", "list", "view", subject_id="u4")
    # the whole store, one page of the default size
    status, body, _ = _req("GET", api.read.port, "/relation-tuples")
    assert status == 200 and len(body["relation_tuples"]) == 5 and body["next_page_token"] == ""
    # a malformed page size or token is a 400; an unknown namespace a 404
    assert _req("GET", api.read.port, "/relation-tuples?page_size=two")[0] == 400
    assert _req("GET", api.read.port, "/relation-tuples?page_token=x1")[0] == 400
    status, body, _ = _req("GET", api.read.port, "/relation-tuples?namespace=nope")
    assert status == 404 and body["error"]["code"] == 404
    # DELETE by query, then the list no longer holds it; GET is a read route
    status, _, _ = _req("DELETE", api.write.port,
                        "/relation-tuples?namespace=videos&object=list&relation=view"
                        "&subject_id=u0")
    assert status == 204
    _, body, _ = _req("GET", api.read.port,
                      "/relation-tuples?namespace=videos&object=list&relation=view")
    assert [t["subject_id"] for t in body["relation_tuples"]] == [f"u{i}" for i in range(1, 5)]
    assert _req("GET", api.write.port, "/relation-tuples?namespace=videos")[0] == 404


def test_patch_transaction(api):
    def subjects():
        _, body, _ = _req("GET", api.read.port,
                          "/relation-tuples?namespace=videos&object=p&relation=view")
        return [t["subject_id"] for t in body["relation_tuples"]]

    _req("PUT", api.write.port, "/relation-tuples", _tuple_json("videos", "p", "view",
                                                                 subject_id="old"))
    status, body, headers = _req("PATCH", api.write.port, "/relation-tuples", [
        {"action": "insert", "relation_tuple": _tuple_json("videos", "p", "view",
                                                           subject_id="new")},
        {"action": "delete", "relation_tuple": _tuple_json("videos", "p", "view",
                                                           subject_id="old")},
    ])
    assert (status, body, headers["X-Keto-Snaptoken"]) == (204, None, "2")
    assert subjects() == ["new"]
    # the check path sees the patch (read-your-writes through the snaptoken)
    q = "/check?namespace=videos&object=p&relation=view&subject_id=new&snaptoken=2"
    assert _req("GET", api.read.port, q)[0] == 200
    for bad, code in (
        ([{"action": "upsert",
           "relation_tuple": _tuple_json("videos", "p", "view", subject_id="x")}], 400),
        ([{"action": "insert"}], 400),
        ({"action": "insert"}, 400),
        ([{"action": "insert", "relation_tuple": _tuple_json("videos", "p", "view",
                                                             subject_id="y")},
          {"action": "insert", "relation_tuple": _tuple_json("nope", "p", "view",
                                                             subject_id="y")}], 404),
    ):
        status, body, _ = _req("PATCH", api.write.port, "/relation-tuples", bad)
        assert status == code and body["error"]["code"] == code
        assert subjects() == ["new"]
    # PATCH is a write route only
    assert _req("PATCH", api.read.port, "/relation-tuples", [])[0] == 404


def test_read_write_split(api):
    status, _, _ = _req("PUT", api.read.port, "/relation-tuples",
                        _tuple_json("videos", "x", "r", subject_id="u"))
    assert status == 404
    status, _, _ = _req("GET", api.write.port,
                        "/check?namespace=videos&object=x&relation=r&subject_id=u")
    assert status == 404


_SET_G1 = {"namespace": "groups", "object": "g1", "relation": "member"}
_P_VIEW = ("videos", "p", "view")
_SCRIPTS = {
    "expand": [
        ("PUT", "write", "/relation-tuples", _tuple_json("videos", "v2", "view",
                                                         subject_set=_SET_G1)),
        ("PUT", "write", "/relation-tuples", _tuple_json("groups", "g1", "member",
                                                         subject_id="u1")),
    ] + [("GET", role, "/expand?namespace=" + q, None) for role, q in (
        ("read", "videos&object=v2&relation=view&max-depth=3"),
        ("read", "videos&object=v2&relation=view&max-depth=0"),
        ("read", "videos&object=v2&relation=view&max-depth=1"),
        ("read", "videos&object=nope&relation=view&max-depth=3"),
        ("read", "videos&object=v2&relation=view"),
        ("read", "videos&object=v2&relation=view&max-depth="),
        ("read", "videos&object=v2&relation=view&max-depth=two"),
        ("read", "nope&object=v2&relation=view&max-depth=3"),
        ("write", "videos&object=v2&relation=view&max-depth=3"),
    )],
    "pages": [
        ("PUT", "write", "/relation-tuples", _tuple_json("videos", "list", "view",
                                                         subject_id=f"u{i}"))
        for i in range(5)
    ] + [("GET", "read", "/relation-tuples" + q, None) for q in (
        "?namespace=videos&object=list&relation=view&page_size=2",
        "?namespace=videos&object=list&relation=view&page_size=2&page_token=2",
        "?namespace=videos&object=list&relation=view&page_size=2&page_token=4",
        "", "?page_size=two", "?page_token=x1", "?namespace=nope",
    )] + [
        ("GET", "write", "/relation-tuples?namespace=videos", None),
        ("DELETE", "write",
         "/relation-tuples?namespace=videos&object=list&relation=view&subject_id=u0", None),
        ("GET", "read", "/relation-tuples?namespace=videos&object=list&relation=view", None),
    ],
    "patch": [
        ("PUT", "write", "/relation-tuples", _tuple_json(*_P_VIEW, subject_id="old")),
        ("PATCH", "write", "/relation-tuples", [
            {"action": "insert", "relation_tuple": _tuple_json(*_P_VIEW, subject_id="new")},
            {"action": "delete", "relation_tuple": _tuple_json(*_P_VIEW, subject_id="old")}]),
        ("GET", "read", "/relation-tuples?namespace=videos&object=p&relation=view", None),
        ("PATCH", "write", "/relation-tuples",
         [{"action": "upsert", "relation_tuple": _tuple_json(*_P_VIEW, subject_id="x")}]),
        ("PATCH", "write", "/relation-tuples", [{"action": "insert"}]),
        ("PATCH", "write", "/relation-tuples", {"action": "insert"}),
        ("PATCH", "write", "/relation-tuples", [
            {"action": "insert", "relation_tuple": _tuple_json(*_P_VIEW, subject_id="y")},
            {"action": "insert", "relation_tuple": _tuple_json("nope", "p", "view",
                                                               subject_id="y")}]),
        ("GET", "read", "/relation-tuples?namespace=videos&object=p&relation=view", None),
        ("PATCH", "read", "/relation-tuples", []),
    ],
    "version": [("GET", "read", "/version", None), ("GET", "write", "/version", None)],
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_tuple_routes_answer_as_the_reference(api, script):
    """The same requests, in the same order, to the port's servers and to
    the reference's (tests/test_rest_api.py's setup): equal status codes
    and bodies, error envelopes included."""
    from keto_tpu.config.provider import Config
    from keto_tpu.driver.registry import Registry
    from keto_tpu.servers.rest import READ, WRITE, RestServer

    reg = Registry(Config(overrides={"namespaces": [{"id": 0, "name": "videos"},
                                                    {"id": 1, "name": "groups"}]}))
    ref = {"read": RestServer(reg, READ, port=0), "write": RestServer(reg, WRITE, port=0)}
    for s in ref.values():
        s.start()
    try:
        for method, role, path, body in _SCRIPTS[script]:
            got = _req(method, getattr(api, role).port, path, body)[:2]
            want = _req(method, ref[role].port, path, body)[:2]
            assert got == want, (method, role, path)
    finally:
        for s in ref.values():
            s.stop()
        reg.close()


# -- the check scheduler over REST: lanes, deadlines, sheds, timelines, drain ----------


def _acl(i, j):
    return RelationTuple.from_string(f"acl:obj-{i}#access@user-{j}")


def _hreq(method, port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if raw else None), r.headers
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else None), e.headers


@pytest.fixture(scope="module")
def acl_pair():
    """The port's daemon and the reference's (tests/test_overload.py's
    ``daemon`` fixture) on the same eight grants."""
    from keto_tpu.config.provider import Config
    from keto_tpu.driver.daemon import Daemon as RefDaemon
    from keto_tpu.driver.registry import Registry
    from keto_tpu.relationtuple.model import RelationTuple as JT

    from keto_tpu_torch import namespace as tns

    grants = [_acl(i, i) for i in range(8)]
    mine = Daemon([tns.Namespace(id=0, name="acl")], device="cpu", tuples=grants)
    mine.start()
    ref = RefDaemon(Registry(Config(overrides={"namespaces": [{"id": 0, "name": "acl"}],
                                               "dsn": "memory", "serve.read.port": 0,
                                               "serve.write.port": 0})))
    ref.serve_all(block=False)
    ref.registry.relation_tuple_manager().write_relation_tuples(
        *(JT.from_string(str(t)) for t in grants))
    yield mine, ref
    mine.stop()
    ref.shutdown()


_CHECK = "/check?" + _acl(1, 1).to_url_query()
_DENY = "/check?" + _acl(1, 2).to_url_query()
_BATCH = {"tuples": [_acl(i, j).to_json() for i, j in ((0, 0), (1, 2), (3, 3))]}
_SCHEDULER_SCRIPT = [
    ("GET", _CHECK, None, {}),
    ("GET", _DENY, None, {"X-Keto-Priority": "batch"}),
    ("GET", _CHECK, None, {"X-Keto-Priority": " Interactive "}),
    ("GET", _CHECK, None, {"X-Keto-Priority": "urgent"}),
    ("GET", _CHECK + "&timeout_ms=x", None, {}),
    ("GET", _CHECK + "&timeout_ms=0", None, {}),
    ("GET", _CHECK + "&timeout_ms=-5", None, {}),
    ("GET", _CHECK, None, {"X-Request-Timeout-Ms": "soon"}),
    ("GET", _CHECK + "&timeout_ms=0.001", None, {}),
    ("GET", _CHECK + "&timeout_ms=5000", None, {"X-Request-Timeout-Ms": "0.001"}),
    ("GET", _CHECK, None, {"X-Request-Timeout-Ms": "5000"}),
    ("POST", "/check?timeout_ms=0.001", _acl(1, 1).to_json(), {}),
    ("POST", "/check", _acl(1, 1).to_json(), {"X-Keto-Priority": "nope"}),
    ("POST", "/check/batch", _BATCH, {"X-Keto-Priority": "urgent"}),
    ("POST", "/check/batch?timeout_ms=0.001", _BATCH, {}),
    ("POST", "/check/batch?timeout_ms=abc", _BATCH, {}),
    ("POST", "/check/batch", _BATCH, {"X-Keto-Priority": "batch"}),
    ("POST", "/check/batch", _BATCH, {"X-Keto-Priority": "interactive"}),
]


@pytest.mark.parametrize("k", range(len(_SCHEDULER_SCRIPT)))
def test_lanes_and_deadlines_answer_as_the_reference(acl_pair, k):
    """``X-Keto-Priority`` and ``timeout_ms`` / ``X-Request-Timeout-Ms``:
    the same request to both servers, equal status and body (400s for a
    malformed or non-positive value or an unknown lane, 504 for a deadline
    that expired before queueing)."""
    mine, ref = acl_pair
    method, path, body, headers = _SCHEDULER_SCRIPT[k]
    got = _hreq(method, mine.read.port, path, body, headers)
    want = _hreq(method, ref.read_port, path, body, headers)
    assert got[:2] == want[:2], (method, path, headers)


def test_timeout_of_a_thousandth_ms_sheds_with_504(acl_pair):
    mine, _ = acl_pair
    status, body, headers = _hreq("GET", mine.read.port, _CHECK + "&timeout_ms=0.001")
    assert status == 504 and body["error"]["code"] == 504
    assert headers["X-Request-Id"] and "Retry-After" not in headers


def _pin_window(batcher, window):
    """Hold the admission window where it is: no tick re-judges it."""
    adm = batcher.admission
    adm._interval_s, adm._last_tick, adm.window = 1e9, time.monotonic(), window


def test_shed_batch_answers_429_with_retry_after_as_the_reference(acl_pair):
    mine, ref = acl_pair
    batchers = (mine.batcher, ref.registry.check_batcher())
    saved = [(b.admission.window, b.admission._interval_s, b.admission._last_tick)
             for b in batchers]
    try:
        for b in batchers:
            _pin_window(b, 0)
        shed0 = mine.batcher.admission_shed_count
        got = _hreq("POST", mine.read.port, "/check/batch", _BATCH)
        want = _hreq("POST", ref.read_port, "/check/batch", _BATCH)
        assert got[0] == want[0] == 429
        assert got[2]["Retry-After"] == want[2]["Retry-After"] == "1"
        assert got[1]["error"]["message"] == want[1]["error"]["message"]
        assert got[1]["error"]["code"] == 429
        assert mine.batcher.admission_shed_count == shed0 + 1
        # a batch pinned interactive is never admission-limited
        got = _hreq("POST", mine.read.port, "/check/batch", _BATCH,
                    {"X-Keto-Priority": "interactive"})
        want = _hreq("POST", ref.read_port, "/check/batch", _BATCH,
                     {"X-Keto-Priority": "interactive"})
        assert got[:2] == want[:2] == (200, {"results": [True, False, True]})
    finally:
        for b, (w, iv, lt) in zip(batchers, saved):
            b.admission.window, b.admission._interval_s, b.admission._last_tick = w, iv, lt


SERVER_TIMING_ENTRY = re.compile(r"^[a-z_]+;dur=\d+\.\d\d$")


def test_responses_carry_server_timing_and_request_id(acl_pair):
    mine, _ = acl_pair
    status, _, h = _hreq("GET", mine.read.port, _CHECK)
    assert status == 200 and re.fullmatch(r"[0-9a-f]{32}", h["X-Request-Id"])
    parts = [p.strip() for p in h["Server-Timing"].split(",")]
    assert all(SERVER_TIMING_ENTRY.match(p) for p in parts), parts
    assert [p.split(";")[0] for p in parts] == ["admit", "pack", "dispatch", "device", "land",
                                                "deliver", "total"]
    _, _, h = _hreq("GET", mine.read.port, _CHECK, headers={"X-Request-Id": "req-7"})
    assert h["X-Request-Id"] == "req-7"
    status, _, h = _hreq("GET", mine.read.port, _CHECK + "&timeout_ms=x")
    assert status == 400 and h["X-Request-Id"] and h["Server-Timing"].startswith("deliver;")
    status, _, h = _hreq("GET", mine.write.port, "/version")
    assert status == 200 and h["X-Request-Id"] and h["Server-Timing"]
    _, _, h = _hreq("GET", mine.read.port, "/health/alive")
    assert "X-Request-Id" not in h and "Server-Timing" not in h


def test_debug_requests_and_its_filters():
    from keto_tpu_torch import namespace as tns

    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu",
               tuples=[_acl(i, i) for i in range(4)])
    d.start()
    try:
        trace = "4bf92f3577b34da6a3ce929d0e0e4736"
        parent = f"00-{trace}-00f067aa0ba902b7-01"
        for k in range(3):
            _hreq("GET", d.read.port, _CHECK, headers={"traceparent": parent})
        _hreq("GET", d.read.port, _DENY)
        _hreq("GET", d.read.port, _DENY, headers={"traceparent": "00-zz-bad-01"})
        _hreq("PUT", d.write.port, "/relation-tuples", _acl(5, 5).to_json())
        for port in (d.read.port, d.write.port):  # one recorder behind both ports
            status, body, _ = _hreq("GET", port, "/debug/requests")
            assert status == 200 and body["enabled"] and body["finished"] == {"http": 6}
            assert [t["kind"] for t in body["recent"]] == \
                ["PUT /relation-tuples"] + ["GET /check"] * 5
        status, body, _ = _hreq("GET", d.read.port, f"/debug/requests?trace_id={trace}")
        assert [t["trace_id"] for t in body["recent"]] == [trace] * 3
        assert len(body["slowest"]) == 3
        check = body["recent"][0]
        assert [s["stage"] for s in check["stages"]] == [
            "arrival", "admit", "pack", "dispatch", "device", "land", "deliver"]
        device = next(s for s in check["stages"] if s["stage"] == "device")["attrs"]
        assert set(device) >= {"width", "bfs_steps", "route", "service_ms"}
        assert check["status"] == 200 and check["snaptoken"] == "1"
        status, body, _ = _hreq("GET", d.read.port, "/debug/requests?n=2&slowest=1")
        assert len(body["recent"]) == 2 and len(body["slowest"]) == 1
        _, body, _ = _hreq("GET", d.read.port, "/debug/requests?snaptoken=2")
        assert [t["kind"] for t in body["recent"]] == ["PUT /relation-tuples"]
        _, body, _ = _hreq("GET", d.read.port, "/debug/requests?tenant=other")
        assert body["recent"] == [] and body["slowest"] == []
        _, body, _ = _hreq("GET", d.read.port, "/debug/requests?tenant=default")
        assert len(body["recent"]) == 6
        assert _hreq("GET", d.read.port, "/debug/requests?n=x")[0] == 400
        # reading the ring does not churn it
        _, body, _ = _hreq("GET", d.read.port, "/debug/requests")
        assert body["finished"] == {"http": 6}
    finally:
        d.stop()


def test_decision_log_takes_route_and_trace_from_the_timeline(tmp_path):
    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.explain import DecisionLog

    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu",
               tuples=[_acl(i, i) for i in range(4)],
               decision_log_dir=str(tmp_path / "dlog"), decision_log_sample=1.0)
    d.start()
    trace = "0af7651916cd43dd8448eb211c80319c"
    try:
        _, _, h1 = _hreq("GET", d.read.port, _CHECK,
                         headers={"traceparent": f"00-{trace}-b7ad6b7169203331-01"})
        _, _, h2 = _hreq("POST", d.read.port, "/check", _acl(1, 2).to_json())
        _, body, _ = _hreq("GET", d.read.port, "/debug/requests")
        routes = [[s["attrs"]["route"] for s in t["stages"] if s["stage"] == "device"][-1]
                  for t in body["recent"]]
    finally:
        d.stop()
    recs, corrupt = DecisionLog(str(tmp_path / "dlog")).read_all("default")
    assert corrupt == 0
    assert [(r["decision"], r["trace_id"]) for r in recs] == \
        [(True, trace), (False, h2["X-Request-Id"])]
    assert [r["route"] for r in recs] == routes[::-1] and all(routes)


def test_drain_answers_503_while_inflight_checks_finish():
    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.driver.daemon import DRAINING, drain

    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu",
               tuples=[_acl(i, i) for i in range(4)])
    d.start()
    gate = threading.Event()
    dispatch = d.batcher._dispatch_stream

    def held(*a, **kw):
        assert gate.wait(10)
        return dispatch(*a, **kw)

    d.batcher._dispatch_stream = held
    res = {}
    t = threading.Thread(target=lambda: res.update(r=_hreq("GET", d.read.port, _CHECK)[:2]),
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 10
        while d.batcher.inflight == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        out = {}
        dt = threading.Thread(target=lambda: out.update(drain((d.read, d.write), d.batcher,
                                                              10.0)), daemon=True)
        dt.start()
        deadline = time.monotonic() + 10
        while (d.read.app.draining is None or d.write.app.draining is None) \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        for port in (d.read.port, d.write.port):
            status, body, h = _hreq("GET", port, "/health/ready")
            assert (status, body, h["Retry-After"]) == \
                (503, {"status": "unavailable", "reason": DRAINING}, "1")
            assert _hreq("GET", port, "/health/alive")[:2] == (200, {"status": "ok"})
        assert dt.is_alive() and d.batcher.inflight == 1
        gate.set()
        dt.join(timeout=10)
        t.join(timeout=10)
        assert res["r"] == (200, {"allowed": True})
        assert out["batcher_idle"] and out["servers_idle"] and out["seconds"] > 0
    finally:
        gate.set()
        d.stop()


def test_drain_and_shutdown_stops_the_daemon():
    from keto_tpu_torch import namespace as tns

    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu", tuples=[_acl(0, 0)])
    d.start()
    port = d.read.port
    assert _hreq("GET", port, _CHECK.replace("obj-1", "obj-0").replace("user-1", "user-0"))[0] \
        == 200
    out = d.drain_and_shutdown(drain_timeout_s=2.0)
    assert out["batcher_idle"] and out["servers_idle"] and not d.batcher.running
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/health/alive", timeout=2)


def test_cli_passes_the_scheduler_flags(tmp_path):
    """The scheduler's keys of a ``serve -c`` config reach the batcher, the
    timeline recorder and the engine."""
    from keto_tpu_torch.cmd import build_parser
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.driver.registry import Registry

    nss = [{"id": 0, "name": "acl"}]
    cases = [
        ({}, (True, True, 0.0, 40.0)),
        ({"serve.admission_enabled": False, "serve.timeline_enabled": False,
          "serve.audit_sample_rate": 0.5, "serve.stream_slice_target_ms": 20.0},
         (False, False, 0.5, 20.0)),
    ]
    for i, (keys, want) in enumerate(cases):
        path = write_config(tmp_path / f"c{i}.json", nss, **keys)
        args = build_parser().parse_args(["serve", "-c", str(path)])
        reg = Registry(Config(config_file=args.config, env={}), device="cpu")
        try:
            eng = reg.permission_engine()
            got = (reg.check_batcher().admission is not None, reg.timeline_recorder().enabled,
                   eng.audit_sample_rate, eng.stream_ctrl.target_ms)
            assert got == want
        finally:
            reg.close()


def test_daemon_wires_the_scheduler_knobs():
    """``make_batcher`` as the reference's registry wires the batcher, and
    the daemon's knobs: no admission, no timelines, the engine's stream
    target and audit rate."""
    from keto_tpu.config.provider import Config
    from keto_tpu.driver.registry import Registry

    from keto_tpu_torch import namespace as tns

    reg = Registry(Config(overrides={"namespaces": [{"id": 0, "name": "acl"}]}))
    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu", tuples=[_acl(0, 0)])
    try:
        ref = reg.check_batcher()
        for b in (d.batcher, ref):
            b.start()
        for attr in ("_batch_size", "_window_s", "_max_pending", "_shed_on_full",
                     "_interactive_max_tuples", "_sub_slice", "_batch_reserve"):
            assert getattr(d.batcher, attr) == getattr(ref, attr), attr
        mine_adm = d.batcher.admission.snapshot()
        assert mine_adm == ref.admission.snapshot()
        assert d.batcher.admission.min_window == ref.admission.min_window
        assert d.engine.stream_ctrl.target_ms == 40.0 and d.engine.audit_sample_rate == 0.0
    finally:
        d.batcher.stop()
        d.engine.close()
        reg.close()
    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu", tuples=[_acl(0, 0)],
               engine_options={"stream_slice_target_ms": 10.0})
    try:
        # the admission budget follows the engine's slice target: 4 × 10 ms
        assert d.batcher.admission.budget_ms == 40.0
    finally:
        d.engine.close()
    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu", tuples=[_acl(0, 0)],
               admission_enabled=False, timeline_enabled=False,
               engine_options={"audit_sample_rate": 0.5, "stream_slice_target_ms": 10.0})
    d.start()
    try:
        assert d.batcher.admission is None and not d.recorder.enabled
        assert d.engine.stream_ctrl.target_ms == 10.0 and d.engine.audit_sample_rate == 0.5
        status, _, h = _hreq("GET", d.read.port, "/check?" + _acl(0, 0).to_url_query())
        assert status == 200 and h["X-Request-Id"] and "Server-Timing" not in h
        assert _hreq("GET", d.read.port, "/debug/requests")[1]["recent"] == []
    finally:
        d.stop()
