"""Command line: ``python -m keto_tpu_torch serve`` (explicit flags; the
config provider and the client commands are a later slice)."""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Optional, Sequence


def _namespace(spec: str):
    from keto_tpu_torch.namespace import Namespace

    name, sep, ident = spec.rpartition("=")
    if not sep or not ident.lstrip("-").isdigit():
        raise argparse.ArgumentTypeError(f"expected NAME=ID, got {spec!r}")
    return Namespace(id=int(ident), name=name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m keto_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serve", help="serve /check on the read port and tuple writes on the write port")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--read-port", type=int, default=4466)
    s.add_argument("--write-port", type=int, default=4467)
    s.add_argument("--namespace", type=_namespace, action="append", default=[],
                   metavar="NAME=ID", help="a namespace (repeatable)")
    s.add_argument("--tuples", metavar="FILE",
                   help="string-codec tuples to load at start ('//' comments)")
    s.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    s.add_argument("--mesh-graph", type=int, default=1, metavar="G",
                   help="serve from G row-range graph shards on the device (default 1: unsharded)")
    s.add_argument("--no-device-build", dest="device_build", action="store_false",
                   help="sort the snapshot build on the host instead of the card (K8)")
    s.add_argument("--no-explain", dest="explain_enabled", action="store_false",
                   help="answer GET /check/explain with 404")
    s.add_argument("--decision-log-dir", default="", metavar="DIR",
                   help="keep the decision-audit log under DIR (default: no log)")
    s.add_argument("--decision-log-sample", type=float, default=0.0, metavar="FRACTION",
                   help="fraction of /check decisions recorded in the log (default 0)")
    s.add_argument("--decision-log-segment-bytes", type=int, default=1 << 20, metavar="BYTES",
                   help="seal a log segment past this size (default 1 MiB)")
    s.add_argument("--decision-log-retention", type=int, default=8, metavar="N",
                   help="sealed log segments kept (default 8)")
    s.add_argument("--no-admission", dest="admission_enabled", action="store_false",
                   help="no admission window on the batch lane (a full lane still sheds 429)")
    s.add_argument("--no-timeline", dest="timeline_enabled", action="store_false",
                   help="record no request timelines (no Server-Timing, /debug/requests empty)")
    s.add_argument("--audit-sample-rate", type=float, default=0.0, metavar="FRACTION",
                   help="fraction of decisions re-checked on the CPU oracle off the serving "
                        "path (default 0: no shadow audit)")
    s.add_argument("--stream-slice-target-ms", type=float, default=40.0, metavar="MS",
                   help="the stream's target service time a slice (default 40; admission's "
                        "budget is 4 times it)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.workloads import parse_tuples

    tuples = []
    if args.tuples:
        with open(args.tuples, encoding="utf-8") as f:
            tuples = parse_tuples(f.read())
    d = Daemon(args.namespace, device=args.device, host=args.host,
               read_port=args.read_port, write_port=args.write_port, tuples=tuples,
               engine_options={"device_build_enabled": args.device_build,
                               "audit_sample_rate": args.audit_sample_rate,
                               "stream_slice_target_ms": args.stream_slice_target_ms},
               explain_enabled=args.explain_enabled, decision_log_dir=args.decision_log_dir,
               decision_log_sample=args.decision_log_sample,
               decision_log_segment_bytes=args.decision_log_segment_bytes,
               decision_log_retention=args.decision_log_retention,
               mesh_graph=args.mesh_graph, admission_enabled=args.admission_enabled,
               timeline_enabled=args.timeline_enabled)
    d.start()
    print(f"serving: read :{d.read.port}, write :{d.write.port}, device {d.engine.device}, "
          f"graph shards {d.engine.shard_count}", flush=True)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    d.drain_and_shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
