"""The port's REST server on the CPU: the cat-videos checks answer 200/403,
a write on the write port is visible to the next check, and the batch and
health routes answer. The reverse queries (``/relation-tuples/list-objects``
and ``/relation-tuples/list-subjects``) answer with their status codes,
400s, pages and snaptoken header, and ``?latest=`` reads a PUT back.
``GET /check/explain`` answers a grant with a verified witness and a deny
with a certificate (both 200), a nil subject with 400, and 404 when
explain is disabled; ``/check`` samples its decisions into the decision
log; the CLI passes the explain and decision-log flags through."""

from __future__ import annotations

import json
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


def test_cli_serve_on_cpu(tmp_path):
    """``python -m keto_tpu_torch serve --device cpu`` answers the cat-videos
    checks and exits 0 on SIGTERM."""
    import re
    import signal
    import subprocess
    import sys
    from pathlib import Path

    tuples = tmp_path / "tuples.txt"
    tuples.write_text(CAT_VIDEOS_TUPLES)
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "keto_tpu_torch", "serve", "--device", "cpu",
         "--read-port", "0", "--write-port", "0", "--namespace", "videos=1",
         "--tuples", str(tuples)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        m = re.search(r"read :(\d+), write :(\d+), device cpu", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        read_port = int(m.group(1))
        for check, allowed in CAT_VIDEOS_CHECKS:
            q = RelationTuple.from_string(check).to_url_query()
            assert _req("GET", read_port, "/check?" + q)[0] == (200 if allowed else 403)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_rejects_a_malformed_namespace():
    from keto_tpu_torch.cmd import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["serve", "--namespace", "videos"])
    args = build_parser().parse_args(["serve", "--namespace", "a=b=3"])
    assert [(n.name, n.id) for n in args.namespace] == [("a=b", 3)]


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
        assert c["route"] == "" and c["witness"] is None and c["snaptoken"] == "1"
    explains = [r for r in recs if r["kind"] == "explain"]
    assert len(explains) == 1 and explains[0]["witness"] and explains[0]["decision"] is True


def test_cli_passes_the_explain_flags():
    from keto_tpu_torch.cmd import build_parser

    args = build_parser().parse_args(["serve"])
    assert (args.explain_enabled, args.decision_log_dir, args.decision_log_sample,
            args.decision_log_segment_bytes, args.decision_log_retention) == (True, "", 0.0, 1 << 20, 8)
    args = build_parser().parse_args([
        "serve", "--no-explain", "--decision-log-dir", "/x", "--decision-log-sample", "0.25",
        "--decision-log-segment-bytes", "4096", "--decision-log-retention", "2"])
    assert (args.explain_enabled, args.decision_log_dir, args.decision_log_sample,
            args.decision_log_segment_bytes, args.decision_log_retention) == (False, "/x", 0.25, 4096, 2)
