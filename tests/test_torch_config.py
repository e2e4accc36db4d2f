"""The port's config provider (keto_tpu_torch/config) against the
reference's (keto_tpu/config) on the CPU: the merged defaults, the layering
of file (JSON and YAML), environment and overrides, the port's own schema
validator against ``jsonschema``'s verdict on the reference schema, inline,
file and directory namespaces, the watcher keeping the last good set, the
websocket namespace source (tests/ws_test_server.py) including a frame cut
by a read timeout, and a YAML file refused by name where ``yaml`` is
missing."""

from __future__ import annotations

import json
import sys
import time

import pytest

from keto_tpu_torch.config import Config, NamespaceWatcher, load_namespaces_from_uri
from keto_tpu_torch.config import validate as schema_check
from keto_tpu_torch.config.schema import CONFIG_SCHEMA, NAMESPACE_SCHEMA
from keto_tpu_torch.x.errors import ErrBadRequest


def _ref():
    from keto_tpu.config import provider

    return provider


def _both(**kw):
    """The port's and the reference's merged config dicts for ``kw``."""
    mine = Config(**kw)
    ref = _ref().Config(**kw)
    try:
        return mine._cfg, ref._cfg
    finally:
        mine.close()
        ref.close()


def test_merged_defaults_equal_the_reference():
    mine, ref = _both(env={})
    assert mine == ref
    assert mine["serve"]["http_backend"] == "async" and mine["dsn"] == "memory"


LAYERS = {
    "file": ({"serve": {"read": {"port": 5000}, "watch_poll_ms": 20},
              "log": {"level": "debug"}}, {}, {}),
    "env": ({}, {"SERVE_READ_PORT": "6000", "ENGINE_PEEL_SEED_CAP": "2.5", "DSN": "memory",
                 "NAMESPACES": '[{"id": 3, "name": "envns"}]', "LOG_FORMAT": "json"}, {}),
    "overrides": ({}, {}, {"serve.write.port": 7000, "serve.labels_enabled": False,
                           "namespaces": [{"id": 1, "name": "o"}]}),
    "all three": ({"serve": {"read": {"port": 5000}}, "engine": {"batch_size": 128}},
                  {"SERVE_READ_PORT": "6000", "ENGINE_BATCH_SIZE": "256"},
                  {"serve.read.port": 7000, "tracing.provider": "memory"}),
    "env uri": ({}, {"NAMESPACES": "file:///nonexistent/ns"}, {}),
}


@pytest.mark.parametrize("fmt", ["json", "yaml"])
@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layering_equals_the_reference(tmp_path, case, fmt):
    import yaml

    file_cfg, env, overrides = LAYERS[case]
    path = tmp_path / f"cfg.{fmt}"
    path.write_text(json.dumps(file_cfg) if fmt == "json" else yaml.safe_dump(file_cfg))
    mine, ref = _both(config_file=str(path), env=env, overrides=overrides)
    assert mine == ref


def test_a_file_without_a_known_suffix_reads_as_json_then_yaml(tmp_path):
    (tmp_path / "a.conf").write_text('{"serve": {"read": {"port": 1}}}')
    (tmp_path / "b.conf").write_text("serve:\n  read:\n    port: 2\n")
    assert Config(config_file=str(tmp_path / "a.conf"), env={}).get("serve.read.port") == 1
    assert Config(config_file=str(tmp_path / "b.conf"), env={}).get("serve.read.port") == 2


def _full():
    return {"dsn": "memory", "namespaces": [{"id": 0, "name": "a"}],
            "serve": {"read": {"host": "", "port": 1}, "write": {"port": 2}},
            "engine": {"backend": "auto"}, "log": {"level": "info", "format": "text"}}


#: configs on both sides of the schema: valid ones, unknown keys, wrong
#: types, enum misses, ``minimum``, the namespaces' ``oneOf``
VERDICTS = {
    "empty": {},
    "full": _full(),
    "ns uri": {"namespaces": "file:///x"},
    "ns empty list": {"namespaces": []},
    "ns with config": {"namespaces": [{"id": 1, "name": "a", "config": {"k": 1}}]},
    "ns $schema": {"namespaces": [{"$schema": "s", "id": 1, "name": "a"}]},
    "ns id float integral": {"namespaces": [{"id": 1.0, "name": "a"}]},
    "ns id negative": {"namespaces": [{"id": -1, "name": "a"}]},
    "ns id float": {"namespaces": [{"id": 1.5, "name": "a"}]},
    "ns id bool": {"namespaces": [{"id": True, "name": "a"}]},
    "ns no id": {"namespaces": [{"name": "a"}]},
    "ns no name": {"namespaces": [{"id": 1}]},
    "ns extra key": {"namespaces": [{"id": 1, "name": "a", "x": 1}]},
    "ns config not object": {"namespaces": [{"id": 1, "name": "a", "config": []}]},
    "ns number": {"namespaces": 5},
    "ns object": {"namespaces": {"id": 1, "name": "a"}},
    "ns item not object": {"namespaces": ["a"]},
    "unknown top key": {"nope": 1},
    "unknown serve key": {"serve": {"nope": 1}},
    "unknown read key": {"serve": {"read": {"nope": 1}}},
    "port string": {"serve": {"read": {"port": "4466"}}},
    "port float": {"serve": {"read": {"port": 4466.5}}},
    "port integral float": {"serve": {"read": {"port": 4466.0}}},
    "port bool": {"serve": {"read": {"port": True}}},
    "port negative": {"serve": {"read": {"port": -1}}},
    "backend enum miss": {"serve": {"http_backend": "epoll"}},
    "backend ok": {"serve": {"http_backend": "threading"}},
    "engine backend miss": {"engine": {"backend": "gpu"}},
    "engine backend oracle": {"engine": {"backend": "oracle"}},
    "log level miss": {"log": {"level": "verbose"}},
    "log format json": {"log": {"format": "json"}},
    "bool as int": {"serve": {"labels_enabled": 1}},
    "bool ok": {"serve": {"labels_enabled": False}},
    "number as string": {"serve": {"staleness_budget_s": "60"}},
    "number int": {"serve": {"staleness_budget_s": 60}},
    "number bool": {"serve": {"staleness_budget_s": False}},
    "dsn number": {"dsn": 1},
    "serve not object": {"serve": []},
    "tracing otlp unknown": {"tracing": {"otlp": {"nope": ""}}},
    "tracing provider miss": {"tracing": {"provider": "jaeger"}},
    "profiling trace": {"profiling": "trace"},
    "profiling miss": {"profiling": "gpu"},
    "metrics unknown": {"metrics": {"enabled": True, "port": 1}},
    "telemetry": {"telemetry": {"enabled": True}},
    "role replica": {"serve": {"role": "replica"}},
    "role miss": {"serve": {"role": "leader"}},
    "tenant backend miss": {"serve": {"tenant_backend": "gpu"}},
    "limit depth string": {"limit": {"max_read_depth": "5"}},
    "root list": [],
}


@pytest.mark.parametrize("case", sorted(VERDICTS))
def test_the_validator_gives_jsonschemas_verdict(case):
    import jsonschema

    cfg = VERDICTS[case]
    want = jsonschema.Draft7Validator(CONFIG_SCHEMA).is_valid(cfg)
    assert schema_check.is_valid(cfg, CONFIG_SCHEMA) == want
    if isinstance(cfg, dict) and isinstance(cfg.get("namespaces"), list):
        for item in cfg["namespaces"]:
            want_ns = jsonschema.validators.validator_for(NAMESPACE_SCHEMA)(
                NAMESPACE_SCHEMA).is_valid(item)
            assert schema_check.is_valid(item, NAMESPACE_SCHEMA) == want_ns
    if isinstance(cfg, dict):
        # and the providers agree on accept/reject through Config itself
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict) and k != "config":
                    walk(v, f"{prefix}{k}.")
                else:
                    flat[f"{prefix}{k}"] = v

        walk(cfg, "")
        verdicts = []
        for cls in (Config, _ref().Config):
            try:
                cls(overrides=flat, env={}).close()
                verdicts.append(True)
            except Exception:
                verdicts.append(False)
        assert verdicts[0] == verdicts[1]


def test_the_validator_refuses_keywords_it_does_not_implement():
    with pytest.raises(schema_check.SchemaError):
        schema_check.is_valid(1, {"type": "integer", "maximum": 3})
    err = pytest.raises(ErrBadRequest, Config, overrides={"serve.read.port": "x"}, env={})
    assert "serve.read.port" in str(err.value) and "is not of type 'integer'" in str(err.value)


def _names(nss):
    return sorted((n.name, n.id) for n in nss)


def test_inline_file_and_directory_namespaces(tmp_path):
    import yaml

    inline = [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]
    mine = Config(overrides={"namespaces": inline}, env={})
    ref = _ref().Config(overrides={"namespaces": inline}, env={})
    assert _names(mine.namespace_manager().namespaces()) == \
        _names(ref.namespace_manager().namespaces()) == [("a", 1), ("b", 2)]
    d = tmp_path / "ns"
    d.mkdir()
    (d / "a.json").write_text(json.dumps({"id": 1, "name": "a"}))
    (d / "b.yaml").write_text(yaml.safe_dump([{"id": 2, "name": "b"}, {"id": 3, "name": "c"}]))
    (d / "c.toml").write_text('id = 4\nname = "d"\n')
    (d / "ignored.txt").write_text("not a namespace")
    for uri in (f"file://{d}", f"file://{d / 'b.yaml'}", str(d / "a.json")):
        got = _names(load_namespaces_from_uri(uri))
        assert got == _names(_ref().load_namespaces_from_uri(uri))
    assert _names(load_namespaces_from_uri(f"file://{d}")) == \
        [("a", 1), ("b", 2), ("c", 3), ("d", 4)]
    cfg = Config(overrides={"namespaces": f"file://{d}"}, env={})
    try:
        assert len(cfg.namespace_manager().namespaces()) == 4
    finally:
        cfg.close()


def test_the_watcher_keeps_the_last_good_set(tmp_path):
    d = tmp_path / "ns"
    d.mkdir()
    (d / "a.json").write_text(json.dumps({"id": 1, "name": "a"}))
    fired = []
    w = NamespaceWatcher(f"file://{d}", on_change=lambda: fired.append(1))
    assert _names(w.manager().namespaces()) == [("a", 1)]
    time.sleep(0.01)
    (d / "b.json").write_text(json.dumps({"id": 2, "name": "b"}))
    assert w.check_reload() and fired == [1]
    assert _names(w.manager().namespaces()) == [("a", 1), ("b", 2)]
    time.sleep(0.01)
    (d / "c.json").write_text(json.dumps({"id": "x"}))  # schema-invalid
    assert not w.check_reload()
    assert _names(w.manager().namespaces()) == [("a", 1), ("b", 2)] and fired == [1]
    time.sleep(0.01)
    (d / "c.json").write_text("{not json")
    assert not w.check_reload()
    (d / "c.json").unlink()
    time.sleep(0.01)
    (d / "d.json").write_text(json.dumps({"id": 5, "name": "e"}))
    assert w.check_reload()
    assert _names(w.manager().namespaces()) == [("a", 1), ("b", 2), ("e", 5)]


def test_a_yaml_file_without_yaml_is_refused_by_name(tmp_path, monkeypatch):
    path = tmp_path / "cfg.yml"
    path.write_text("dsn: memory\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ErrBadRequest, match="'yaml' module"):
        Config(config_file=str(path), env={})
    ns = tmp_path / "ns.yaml"
    ns.write_text("id: 1\nname: a\n")
    with pytest.raises(ErrBadRequest, match="'yaml' module"):
        load_namespaces_from_uri(str(ns))
    # JSON needs no yaml
    (tmp_path / "cfg.json").write_text('{"dsn": "memory"}')
    assert Config(config_file=str(tmp_path / "cfg.json"), env={}).dsn == "memory"


def _wait_for(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_websocket_namespace_source():
    """Snapshots push over a live websocket, a malformed or schema-invalid
    one keeps the last good set, and the watcher reconnects after a dropped
    connection."""
    from ws_test_server import WsTestServer

    srv = WsTestServer()
    try:
        w = NamespaceWatcher(srv.url, ws_initial_wait=0.1)
        assert srv.wait_client(), "watcher never connected"
        assert w.manager().namespaces() == []
        srv.send_text(json.dumps([{"id": 1, "name": "alpha"}]))
        assert _wait_for(lambda: [n.name for n in w.manager().namespaces()] == ["alpha"])
        srv.send_text("{not json::")
        srv.send_text(json.dumps({"id": 2}))  # schema-invalid (no name)
        time.sleep(0.3)
        assert [n.name for n in w.manager().namespaces()] == ["alpha"]
        srv.send_text("- id: 1\n  name: alpha\n- id: 2\n  name: beta\n")  # YAML
        assert _wait_for(lambda: len(w.manager().namespaces()) == 2)
        srv.drop_client()
        assert srv.wait_client(10), "watcher did not reconnect"
        srv.send_text(json.dumps([{"id": 9, "name": "gamma"}]))
        assert _wait_for(lambda: [n.name for n in w.manager().namespaces()] == ["gamma"], 10)
        w.stop()
    finally:
        srv.close()


def test_websocket_namespace_source_through_config():
    from ws_test_server import WsTestServer

    srv = WsTestServer()
    try:
        cfg = Config(overrides={"namespaces": srv.url}, env={})
        fired = []
        cfg.on_namespace_change(lambda: fired.append(1))
        cfg.namespace_manager()
        assert srv.wait_client(), "watcher never connected"
        srv.send_text(json.dumps([{"id": 4, "name": "pushed"}]))
        assert _wait_for(
            lambda: [n.name for n in cfg.namespace_manager().namespaces()] == ["pushed"])
        assert fired
        cfg.close()
    finally:
        srv.close()


def test_websocket_survives_mid_frame_timeout():
    """A read timeout while a frame is half delivered does not desync the
    stream: the frame and the next one both apply."""
    from ws_test_server import WsTestServer

    srv = WsTestServer()
    try:
        w = NamespaceWatcher(srv.url, ws_initial_wait=0.1)
        assert srv.wait_client()
        payload = json.dumps([{"id": 1, "name": "slow"}]).encode()
        frame = bytes([0x81, len(payload)]) + payload
        with srv._lock:
            conn = srv._conn
        conn.sendall(frame[:5])
        time.sleep(1.2)  # the watcher times out mid-frame at least once
        conn.sendall(frame[5:])
        assert _wait_for(lambda: [n.name for n in w.manager().namespaces()] == ["slow"])
        srv.send_text(json.dumps([{"id": 2, "name": "after"}]))
        assert _wait_for(lambda: [n.name for n in w.manager().namespaces()] == ["after"])
        w.stop()
    finally:
        srv.close()


def test_the_ws_client_speaks_the_reference_handshake():
    from keto_tpu.x import ws as ref_ws

    from keto_tpu_torch.x import ws

    for key in ("dGhlIHNhbXBsZSBub25jZQ==", "x3JJHMbDL1EzLkh9GBhXDw=="):
        assert ws.accept_key(key) == ref_ws.accept_key(key)
