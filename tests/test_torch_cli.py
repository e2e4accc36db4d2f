"""The port's command line (keto_tpu_torch/cmd) on the CPU: ``relation-tuple
parse``, ``namespace validate`` and ``version`` print what the reference's
commands print on the same files; ``serve -c cfg.json --device cpu`` as a
subprocess answers the cat-videos checks, its SIGTERM drain ends an open
``/watch`` stream and it exits 0; a config the schema refuses or a key that
waits for a later ROADMAP item exits non-zero with its message; the
commands that wait for a later item exit 2 naming it."""

from __future__ import annotations

import http.client
import json
import threading

import pytest
from test_torch_rest import _req, cli_serve, put_tuples, write_config

from keto_tpu_torch.cmd import WAITING_COMMANDS, main
from keto_tpu_torch.relationtuple.model import RelationTuple
from keto_tpu_torch.workloads import (
    CAT_VIDEOS_CHECKS,
    CAT_VIDEOS_NAMESPACES,
    CAT_VIDEOS_TUPLES,
    parse_tuples,
)


def _ref_cli(args):
    from click.testing import CliRunner

    from keto_tpu.cmd.root import cli

    return CliRunner().invoke(cli, args)


@pytest.mark.parametrize("fmt", ["default", "json", "json-pretty"])
@pytest.mark.parametrize("n", [1, 7])
def test_relation_tuple_parse_prints_as_the_reference(tmp_path, capsys, fmt, n):
    lines = CAT_VIDEOS_TUPLES.strip().splitlines()
    body = [ln for ln in lines if ln.strip() and not ln.strip().startswith("//")][:n]
    path = tmp_path / "t.txt"
    path.write_text("// a comment\n\n" + "\n".join(body) + "\n")
    assert main(["relation-tuple", "parse", str(path), "--format", fmt]) == 0
    got = capsys.readouterr().out
    want = _ref_cli(["relation-tuple", "parse", str(path), "--format", fmt])
    assert want.exit_code == 0 and got == want.output


def test_namespace_validate_as_the_reference(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps([{"id": 1, "name": "videos"}, {"id": 2, "name": "groups"}]))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"name": "no-id"}))
    assert main(["namespace", "validate", str(good)]) == 0
    out = capsys.readouterr().out
    want = _ref_cli(["namespace", "validate", str(good)])
    assert want.exit_code == 0 and out == want.output
    assert main(["namespace", "validate", str(good), str(bad)]) == 1
    captured = capsys.readouterr()
    assert "INVALID" in captured.err and str(bad) in captured.err
    assert _ref_cli(["namespace", "validate", str(good), str(bad)]).exit_code == 1


def test_version_prints_the_version(capsys):
    from keto_tpu_torch.version import __version__

    assert main(["version"]) == 0
    assert capsys.readouterr().out.strip() == __version__ == _ref_cli(["version"]).output.strip()


def test_serve_answers_and_its_sigterm_drain_ends_a_watch(tmp_path):
    cfg = write_config(tmp_path / "cfg.json", [n.to_json() for n in CAT_VIDEOS_NAMESPACES],
                       **{"serve.watch_poll_ms": 20.0, "serve.drain_timeout_s": 5.0})
    srv = cli_serve(cfg)
    try:
        lines, ready = [], threading.Event()

        def watch():
            conn = http.client.HTTPConnection("127.0.0.1", srv.read_port, timeout=30)
            conn.request("GET", "/watch?snaptoken=0")
            resp = conn.getresponse()
            lines.append(resp.status)
            ready.set()
            while True:
                line = resp.readline()
                if not line:
                    break
                lines.append(json.loads(line))

        th = threading.Thread(target=watch, daemon=True)
        th.start()
        assert ready.wait(10) and lines[0] == 200
        put_tuples(srv.write_port, parse_tuples(CAT_VIDEOS_TUPLES))
        for check, allowed in CAT_VIDEOS_CHECKS:
            q = RelationTuple.from_string(check).to_url_query()
            assert _req("GET", srv.read_port, "/check?" + q + "&latest=true")[0] == \
                (200 if allowed else 403)
        assert srv.stop() == 0
        th.join(timeout=10)
        assert not th.is_alive(), "the drain did not end the watch stream"
        assert [int(m["snaptoken"]) for m in lines[1:]] == list(range(1, 8))
    finally:
        srv.kill()


@pytest.mark.parametrize("keys,message", [
    ({"serve.nope": 1}, "Additional properties are not allowed"),
    ({"serve.read.port": "x"}, "is not of type 'integer'"),
    ({"serve.role": "replica"}, "ROADMAP A10"),
    ({"dsn": "sqlite://x.db"}, "ROADMAP A8"),
])
def test_serve_refuses_a_bad_config(tmp_path, capsys, keys, message):
    cfg = write_config(tmp_path / "cfg.json", [{"id": 0, "name": "acl"}], **keys)
    assert main(["serve", "-c", str(cfg)]) == 1
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["migrate", "up"], ["namespace", "migrate-legacy"], ["check"],
                                  ["expand"], ["status"], ["relation-tuple", "create", "f"],
                                  ["relation-tuple", "delete", "f"], ["relation-tuple", "get"]])
def test_a_waiting_command_names_its_item(capsys, argv):
    assert main(argv) == 2
    err = capsys.readouterr().err
    item = next(v for k, v in WAITING_COMMANDS.items() if " ".join(argv).startswith(k))
    assert item in err and "ROADMAP" in err
