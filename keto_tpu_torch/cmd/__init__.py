"""The command line: the port's copy of keto_tpu/cmd/root.py, on
``argparse`` (the standard library) where the reference uses ``click``.

- ``serve -c FILE``: the config (keto_tpu_torch/config) → ``profiling`` →
  ``Registry`` → ``Daemon``, SIGTERM and SIGINT drain, and the process
  blocks serving. ``--device cpu`` is the one flag the reference lacks: the
  explicit request to serve on the CPU (the tests' path); by default the
  engine runs on the card and the process fails where there is none. Once
  both ports answer, ``serve`` prints ``serving: read :N, write :N, device
  D, graph shards G`` on its first stdout line.
- ``namespace validate FILE...``, ``relation-tuple parse FILE...`` and
  ``version`` run locally, as the reference's do.
- ``migrate up|down|status`` and ``namespace migrate-legacy`` operate on
  the SQL stores, which are ROADMAP A8; ``check``, ``expand``, ``status``
  and ``relation-tuple create|delete|get`` dial a gRPC remote, which is the
  second half of ROADMAP A7. Each of them exits 2 with a message naming
  its item.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

#: the commands that wait for a later ROADMAP item, and what they wait for
WAITING_COMMANDS = {
    "migrate": "the SQL stores (ROADMAP A8)",
    "namespace migrate-legacy": "the SQL stores (ROADMAP A8)",
    "check": "the gRPC API, the second half of ROADMAP A7",
    "expand": "the gRPC API, the second half of ROADMAP A7",
    "status": "the gRPC API, the second half of ROADMAP A7",
    "relation-tuple create": "the gRPC API, the second half of ROADMAP A7",
    "relation-tuple delete": "the gRPC API, the second half of ROADMAP A7",
    "relation-tuple get": "the gRPC API, the second half of ROADMAP A7",
}

_FORMATS = ("default", "json", "json-pretty")
_TABLE_HEADER = ("NAMESPACE", "OBJECT ID", "RELATION NAME", "SUBJECT")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m keto_tpu_torch",
                                description="keto-tpu on PyTorch and CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("serve", help="serve the read and write APIs (REST)")
    s.add_argument("-c", "--config", default=None, metavar="FILE",
                   help="the config file (JSON, or YAML where PyYAML is installed)")
    s.add_argument("--device", default=None,
                   help="torch device of the engine (default: the card; 'cpu' serves on "
                        "the host, the plain PyTorch path)")

    ns = sub.add_parser("namespace", help="work with namespace definitions")
    ns_sub = ns.add_subparsers(dest="namespace_command", required=True)
    v = ns_sub.add_parser("validate", help="validate namespace definition files")
    v.add_argument("files", nargs="+")
    ml = ns_sub.add_parser("migrate-legacy", help="migrate v0.6-era namespace tables")
    ml.add_argument("target", nargs="?")
    ml.add_argument("-c", "--config", default=None)
    ml.add_argument("-y", "--yes", action="store_true")

    rt = sub.add_parser("relation-tuple", help="read and manipulate relation tuples")
    rt_sub = rt.add_subparsers(dest="tuple_command", required=True)
    parse = rt_sub.add_parser("parse", help="parse human-readable relation tuples")
    parse.add_argument("files", nargs="+")
    parse.add_argument("--format", dest="fmt", choices=_FORMATS, default="default")
    for name in ("create", "delete", "get"):
        w = rt_sub.add_parser(name, help=f"{name} relation tuples on a remote (gRPC)")
        w.add_argument("args", nargs="*")

    m = sub.add_parser("migrate", help="run or inspect storage migrations")
    m.add_argument("action", choices=("up", "down", "status"))
    m.add_argument("-c", "--config", default=None)
    m.add_argument("-y", "--yes", action="store_true")
    m.add_argument("--steps", type=int, default=1)

    for name in ("check", "expand", "status"):
        r = sub.add_parser(name, help=f"{name} on a remote (gRPC)")
        r.add_argument("args", nargs="*")

    sub.add_parser("version", help="print the framework version")
    return p


def _print_formatted(obj, fmt: str, default_str: Optional[str] = None) -> None:
    if fmt == "json":
        print(json.dumps(obj))
    elif fmt == "json-pretty":
        print(json.dumps(obj, indent=2))
    else:
        print(default_str if default_str is not None else json.dumps(obj, indent=2))


def _parse_tuple_files(files) -> list:
    """Human-syntax tuple files: one ``ns:obj#rel@subject`` a line, ``//``
    comments and blank lines ignored (reference cmd/relationtuple/parse.go:48-91)."""
    from keto_tpu_torch.relationtuple.model import RelationTuple

    rts = []
    for fn in files:
        text = sys.stdin.read() if fn == "-" else Path(fn).read_text()
        name = "stdin" if fn == "-" else fn
        for i, row in enumerate(text.split("\n")):
            row = row.strip()
            if not row or row.startswith("//"):
                continue
            try:
                rts.append(RelationTuple.from_string(row))
            except Exception as e:
                raise SystemExit(f"Could not decode {name}:{i + 1}\n  {row}\n\n{e}")
    return rts


def _print_tuple_table(rts) -> None:
    rows = [(rt.namespace, rt.object, rt.relation, str(rt.subject)) for rt in rts]
    widths = [
        max(len(_TABLE_HEADER[i]), *(len(r[i]) for r in rows)) if rows else len(_TABLE_HEADER[i])
        for i in range(4)
    ]
    for row in (_TABLE_HEADER, *rows):
        print("\t".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())


def _relation_tuple_parse(files, fmt: str) -> int:
    rts = _parse_tuple_files(files)
    if fmt in ("json", "json-pretty"):
        payload = rts[0].to_json() if len(rts) == 1 else [rt.to_json() for rt in rts]
        _print_formatted(payload, fmt)
    elif len(rts) == 1:
        print(str(rts[0]))
    else:
        _print_tuple_table(rts)
    return 0


def _namespace_validate(files) -> int:
    """Validate namespace files against the schema (reference
    cmd/namespace/validate.go:20-58)."""
    from keto_tpu_torch.config.provider import parse_namespace_file

    failed = False
    for fn in files:
        try:
            for ns in parse_namespace_file(Path(fn)):
                print(f"{fn}: namespace {ns.name!r} (id {ns.id}) is valid")
        except Exception as e:
            print(f"{fn}: INVALID — {e}", file=sys.stderr)
            failed = True
    return 1 if failed else 0


def serve(config: Optional[str], device: Optional[str]) -> int:
    """``serve -c FILE`` (reference cmd/server/serve.go:33-70): the config
    is checked (schema, then the registry's key policy) before anything
    touches the card."""
    from keto_tpu_torch.config.provider import Config
    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.driver.registry import Registry
    from keto_tpu_torch.x import profiling

    cfg = Config(config_file=config)
    profiling.attach(cfg.get("profiling", ""))  # reference main.go:25-28
    daemon = Daemon(Registry(cfg, device=device))
    daemon.install_signal_handlers()
    daemon.serve_all(block=False)
    engine = daemon.engine
    print(f"serving: read :{daemon.read_port}, write :{daemon.write_port}, "
          f"device {getattr(engine, 'device', 'host')}, "
          f"graph shards {getattr(engine, 'shard_count', 0)}", flush=True)
    try:
        daemon.wait_for_shutdown()
    except KeyboardInterrupt:
        pass
    daemon.drain_and_shutdown()
    return 0


def _waiting(command: str) -> int:
    print(f"{command}: not available in this port yet: it needs {WAITING_COMMANDS[command]}",
          file=sys.stderr)
    return 2


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.command
    if cmd == "serve":
        from keto_tpu_torch.x.errors import KetoError

        try:
            return serve(args.config, args.device)
        except (KetoError, ValueError, OSError) as e:
            # a refused config: the schema's or the key policy's message
            print(f"serve: {e}", file=sys.stderr)
            return 1
    if cmd == "version":
        from keto_tpu_torch.version import __version__

        print(__version__)
        return 0
    if cmd == "namespace":
        if args.namespace_command == "validate":
            return _namespace_validate(args.files)
        return _waiting("namespace migrate-legacy")
    if cmd == "relation-tuple":
        if args.tuple_command == "parse":
            return _relation_tuple_parse(args.files, args.fmt)
        return _waiting(f"relation-tuple {args.tuple_command}")
    return _waiting(cmd)


if __name__ == "__main__":
    sys.exit(main())
