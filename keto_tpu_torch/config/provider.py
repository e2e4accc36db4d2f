"""Configuration provider: the port's copy of keto_tpu/config/provider.py.

Schema-validated config loaded from (in increasing precedence) defaults, a
JSON or YAML file, environment variables, and explicit overrides — the same
file+env+flags layering the reference builds on configx (reference
internal/driver/config/provider.go:55-81). Namespaces may be given inline or
as a ``file://`` URI of a file or directory, hot-reloaded by
``NamespaceWatcher`` (reference internal/driver/config/namespace_watcher.go),
or as a ``ws://`` URI whose server pushes whole namespace documents.

Env-var convention follows the reference: dots become underscores and the key
is uppercased, e.g. ``serve.read.port`` → ``SERVE_READ_PORT``; ``DSN`` and
``NAMESPACES`` (JSON or a URI string) are also honored.

Where the port differs: it needs nothing outside the standard library.
JSON files parse with ``json``; a ``.yaml``/``.yml`` file parses with
``yaml`` only where that module imports, and without it raises an error
naming the module (a refusal, never a quiet substitute); a file of another
suffix is read as JSON, then as YAML where ``yaml`` imports. The schema is
checked by the port's own validator (keto_tpu_torch/config/validate.py),
never by ``jsonschema``.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import threading
from pathlib import Path
from typing import Any, Callable, Optional

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.config import validate as schema_check
from keto_tpu_torch.config.schema import CONFIG_SCHEMA, NAMESPACE_SCHEMA
from keto_tpu_torch.x.errors import ErrBadRequest

_log = logging.getLogger("keto_tpu_torch.config")

KEY_DSN = "dsn"
KEY_READ_API_HOST = "serve.read.host"
KEY_READ_API_PORT = "serve.read.port"
KEY_WRITE_API_HOST = "serve.write.host"
KEY_WRITE_API_PORT = "serve.write.port"
KEY_NAMESPACES = "namespaces"

_DEFAULTS: dict[str, Any] = {
    "dsn": "memory",
    "serve": {
        "read": {"host": "", "port": 4466},  # reference provider.go:112-118
        "write": {"host": "", "port": 4467},  # reference provider.go:120-126
        "http_backend": "async",
    },
    "namespaces": [],
    "engine": {
        "backend": "auto",
        "batch_size": 4096,
        "it_cap": 4096,
        "peel_seed_cap": 4.0,
        "batch_window_ms": 1.0,
        "sync_rebuild_budget_s": 0.25,
    },
    "limit": {"max_read_depth": 5},
    "log": {"level": "info", "format": "text"},
    "tracing": {
        "provider": "",
        "otlp": {"file": "", "endpoint": "http://127.0.0.1:4318/v1/traces"},
    },
    "profiling": "",
    "telemetry": {"enabled": False},
}

_ENV_KEYS = [
    "dsn",
    "serve.read.host",
    "serve.read.port",
    "serve.write.host",
    "serve.write.port",
    "serve.http_backend",
    "namespaces",
    "engine.backend",
    "engine.batch_size",
    "engine.it_cap",
    "engine.peel_seed_cap",
    "engine.batch_window_ms",
    "engine.sync_rebuild_budget_s",
    "limit.max_read_depth",
    "log.level",
    "log.format",
    "profiling",
    "tracing.provider",
    "tracing.otlp.file",
    "tracing.otlp.endpoint",
]


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def _get_path(cfg: dict, dotted: str, default: Any = None) -> Any:
    cur: Any = cfg
    for p in dotted.split("."):
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


def _schema_type(dotted: str) -> Optional[str]:
    node: Any = CONFIG_SCHEMA
    for part in dotted.split("."):
        node = node.get("properties", {}).get(part)
        if not isinstance(node, dict):
            return None
    return node.get("type")


def _coerce(dotted: str, raw: str) -> Any:
    # env values coerce by the key's DECLARED schema type — suffix
    # heuristics rot the moment a float key ends in _cap or _size
    if dotted == "namespaces":
        raw = raw.strip()
        if raw.startswith("["):
            return json.loads(raw)
        return raw
    t = _schema_type(dotted)
    if t == "integer":
        return int(raw)
    if t == "number":
        return float(raw)
    return raw


def _uri_to_path(uri: str) -> Path:
    return Path(uri[len("file://"):] if uri.startswith("file://") else uri)


def _yaml():
    """The ``yaml`` module, or an error naming it where it does not import."""
    try:
        import yaml
    except ImportError:
        raise ErrBadRequest(
            "a YAML document needs the 'yaml' module (PyYAML), which is not "
            "installed; write the file as JSON instead"
        ) from None
    return yaml


def parse_text(text: str, suffix: str = "") -> Any:
    """A JSON or YAML document by file suffix: ``.json`` is JSON, ``.yaml``
    and ``.yml`` YAML (``_yaml``), ``.toml`` TOML; any other suffix is read
    as JSON, then as YAML where ``yaml`` imports (JSON is YAML, so a
    document means the same either way)."""
    if suffix == ".json":
        return json.loads(text)
    if suffix in (".yaml", ".yml"):
        return _yaml().safe_load(text)
    if suffix == ".toml":
        import tomllib

        return tomllib.loads(text)
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError:
        raise ErrBadRequest(
            "the document is not JSON, and reading it as YAML needs the 'yaml' "
            "module (PyYAML), which is not installed"
        ) from None
    return yaml.safe_load(text)


def parse_namespace_file(path: Path) -> list[namespace_pkg.Namespace]:
    """Parse one namespace definition file (json/yaml/toml); the file may hold
    a single namespace object or a list (reference
    internal/driver/config/namespace_watcher.go:138-209)."""
    return parse_namespaces_data(parse_text(path.read_text(), path.suffix))


def load_namespaces_from_uri(uri: str) -> list[namespace_pkg.Namespace]:
    """Load namespaces from a ``file://`` URI pointing at a file or directory
    of definition files."""
    path = _uri_to_path(uri)
    if path.is_dir():
        out: list[namespace_pkg.Namespace] = []
        for child in sorted(path.iterdir()):
            if child.suffix in (".yaml", ".yml", ".json", ".toml"):
                out.extend(parse_namespace_file(child))
        return out
    return parse_namespace_file(path)


def parse_namespaces_data(data) -> list[namespace_pkg.Namespace]:
    """Validate a parsed namespace document (single mapping or list) into
    Namespace objects."""
    items = data if isinstance(data, list) else [data]
    out = []
    for item in items:
        schema_check.validate(item, NAMESPACE_SCHEMA)
        out.append(namespace_pkg.namespace_from_json(item))
    return out


class NamespaceWatcher:
    """Hot-reloads namespace definitions from a file, a directory, or a
    **websocket URI**, keeping the last-good set on parse errors
    (reference internal/driver/config/namespace_watcher.go:47-136 — the
    reference's watcherx supports the same three source kinds).

    Websocket mode (``ws://`` / ``wss://``): each text message from the
    server is a full namespace document in any file format the file
    source accepts (yaml/json — a single mapping or a list); the latest
    well-formed message wins. This is a simplification of watcherx's
    per-file change-event protocol: the source pushes whole snapshots,
    which is also what the reference's eventHandler reduces to for a
    single watched definition (namespace_watcher.go:90-136). The
    connection retries with backoff; the constructor waits up to
    ``ws_initial_wait`` seconds for the first snapshot (empty set until
    one arrives)."""

    def __init__(
        self,
        uri: str,
        poll_interval: float = 1.0,
        on_change: Optional[Callable[[], None]] = None,
        ws_initial_wait: float = 3.0,
    ):
        self.uri = uri
        self.poll_interval = poll_interval
        self.on_change = on_change
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ws_mode = uri.startswith(("ws://", "wss://"))
        if self._ws_mode:
            self._manager = namespace_pkg.MemoryManager([])
            self._stamp: tuple = ()
            self._first_snapshot = threading.Event()
            self.start()
            self._first_snapshot.wait(ws_initial_wait)
        else:
            self._manager = namespace_pkg.MemoryManager(load_namespaces_from_uri(uri))
            self._stamp = self._fingerprint()

    def _fingerprint(self) -> tuple:
        path = _uri_to_path(self.uri)
        try:
            if path.is_dir():
                return tuple(
                    sorted((str(p), p.stat().st_mtime_ns) for p in path.iterdir() if p.is_file())
                )
            return ((str(path), path.stat().st_mtime_ns),)
        except FileNotFoundError:
            # a file vanished mid-scan (atomic replace); treat as a changed,
            # incomplete state — the next poll re-fingerprints
            return ()

    def manager(self) -> namespace_pkg.MemoryManager:
        with self._lock:
            return self._manager

    def check_reload(self) -> bool:
        """Reload if the underlying files changed; True if namespaces changed.
        On parse error the previous (last-good) set is kept. Websocket
        sources are push-based: always False here."""
        if self._ws_mode:
            return False
        stamp = self._fingerprint()
        if stamp == self._stamp:
            return False
        self._stamp = stamp
        try:
            nss = load_namespaces_from_uri(self.uri)
        except Exception:
            return False  # keep last-good (reference namespace_watcher.go:110-121)
        with self._lock:
            self._manager = namespace_pkg.MemoryManager(nss)
        if self.on_change:
            self.on_change()
        return True

    def _apply_ws_snapshot(self, text: str) -> None:
        try:
            nss = parse_namespaces_data(parse_text(text))
        except Exception as e:
            # keep last-good, exactly like the file source — but tell the
            # operator (an invalid push is otherwise invisible)
            _log.warning("namespace snapshot from %s rejected: %s", self.uri, e)
            return
        with self._lock:
            self._manager = namespace_pkg.MemoryManager(nss)
        self._first_snapshot.set()
        if self.on_change:
            self.on_change()

    def _ws_loop(self) -> None:
        from keto_tpu_torch.x.ws import WebSocketClient

        backoff = 0.2
        while not self._stop.is_set():
            try:
                client = WebSocketClient(self.uri, timeout=5.0)
                client.settimeout(0.5)
                backoff = 0.2
                try:
                    while not self._stop.is_set():
                        try:
                            msg = client.recv()
                        except TimeoutError:
                            continue  # poll the stop flag
                        if msg is None:
                            break  # server closed; reconnect
                        self._apply_ws_snapshot(msg)
                finally:
                    client.close()
            except Exception as e:
                # connect/handshake/stream failure: retry with backoff,
                # visibly — a dead source otherwise denies every check
                # with no trace of why
                _log.warning("namespace source %s unavailable (%s); retrying", self.uri, e)
            if not self._stop.is_set():
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 5.0)

    def start(self) -> None:
        if self._thread:
            return
        if self._ws_mode:
            target = self._ws_loop
        else:

            def target():
                while not self._stop.wait(self.poll_interval):
                    self.check_reload()

        self._thread = threading.Thread(target=target, name="namespace-watcher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None


class Config:
    """Validated configuration + namespace manager accessor."""

    def __init__(
        self,
        config_file: Optional[str] = None,
        overrides: Optional[dict[str, Any]] = None,
        env: Optional[dict[str, str]] = None,
    ):
        cfg = copy.deepcopy(_DEFAULTS)
        if config_file:
            raw = Path(config_file).read_text()
            file_cfg = parse_text(raw, Path(config_file).suffix) or {}
            if not isinstance(file_cfg, dict):
                raise ErrBadRequest(f"config file {config_file} must hold a mapping")
            cfg = _deep_merge(cfg, file_cfg)
        env = os.environ if env is None else env
        for dotted in _ENV_KEYS:
            env_key = dotted.replace(".", "_").upper()
            if env_key in env:
                _set_path(cfg, dotted, _coerce(dotted, env[env_key]))
        for dotted, value in (overrides or {}).items():
            _set_path(cfg, dotted, value)

        try:
            schema_check.validate(cfg, CONFIG_SCHEMA)
        except schema_check.ValidationError as e:
            raise ErrBadRequest(f"invalid configuration: {e}") from e

        self._cfg = cfg
        self._watcher: Optional[NamespaceWatcher] = None
        self._static_manager: Optional[namespace_pkg.MemoryManager] = None
        self._on_namespace_change: list[Callable[[], None]] = []

    def get(self, dotted: str, default: Any = None) -> Any:
        return _get_path(self._cfg, dotted, default)

    @property
    def dsn(self) -> str:
        return self._cfg["dsn"]

    def read_api_address(self) -> tuple[str, int]:
        return self.get(KEY_READ_API_HOST, ""), int(self.get(KEY_READ_API_PORT, 4466))

    def write_api_address(self) -> tuple[str, int]:
        return self.get(KEY_WRITE_API_HOST, ""), int(self.get(KEY_WRITE_API_PORT, 4467))

    def on_namespace_change(self, cb: Callable[[], None]) -> None:
        self._on_namespace_change.append(cb)

    def _fire_namespace_change(self) -> None:
        for cb in self._on_namespace_change:
            cb()

    def namespace_manager(self) -> namespace_pkg.Manager:
        """Inline list → static manager; URI string → watched manager
        (reference provider.go:157-198)."""
        nss = self._cfg.get("namespaces", [])
        if isinstance(nss, str):
            if self._watcher is None:
                self._watcher = NamespaceWatcher(nss, on_change=self._fire_namespace_change)
                self._watcher.start()
            return self._watcher.manager()
        if self._static_manager is None:
            self._static_manager = namespace_pkg.MemoryManager(
                namespace_pkg.namespace_from_json(n) if isinstance(n, dict) else n for n in nss
            )
        return self._static_manager

    def set_namespaces(self, namespaces: list[namespace_pkg.Namespace]) -> None:
        """Test/embedding helper: replace the static namespace set."""
        if self._watcher:  # a prior URI-backed manager is superseded
            self._watcher.stop()
            self._watcher = None
        self._cfg["namespaces"] = [n.to_json() for n in namespaces]
        self._static_manager = namespace_pkg.MemoryManager(namespaces)
        self._fire_namespace_change()

    def close(self) -> None:
        if self._watcher:
            self._watcher.stop()
