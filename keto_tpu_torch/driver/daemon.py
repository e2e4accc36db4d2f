"""The serving process: one store, one check engine on the card, the list
engine and the snapshot-backed expand engine beside it on the same
snapshots, one check batcher and the read and write REST ports (reference
internal/driver/daemon.go, cut to the Check, Expand, List and tuple
slices). ``max_read_depth`` caps an expand's depth (the reference's
``limit.max_read_depth``, default 5). The engine serves with
2-hop labels on, as the reference's daemon does; ``engine_options`` passes
the label knobs (``labels_enabled``, ``labels_max_width``,
``labels_landmarks``, ``labels_device_build``, ``labels_min_gain``,
``labels_batch``, ``labels_device_min_edges``) and the overlay knobs
(``overlay_edge_budget``, ``fold_segment_edges``, ``compact_after_s``,
``sync_rebuild_budget_s``), ``device_build_enabled`` (the build's sorts
on the card) and the stream and audit knobs (``stream_slice_target_ms``,
``stream_tail_ratio``, ``audit_sample_rate``) through to
``TorchCheckEngine``. Writes apply as
delta overlays folded in the background (keto_tpu_torch/graph/overlay.py,
keto_tpu_torch/graph/compaction.py).

Decision provenance (keto_tpu/driver/registry.py:790-838, defaults from
keto_tpu/config/schema.py:208-230): ``explain_enabled`` (default true)
serves ``GET /check/explain`` through an ``ExplainEngine`` over the engine
and the store; ``decision_log_dir`` (default "": no log) keeps a
``DecisionLog`` that records every explain and, with
``decision_log_sample`` > 0, that fraction of ``/check`` decisions, in
segments of ``decision_log_segment_bytes`` (1 MiB) of which
``decision_log_retention`` (8) sealed ones are kept.

Sharded serving (keto_tpu/driver/registry.py:650-680, the registry's
``serve.mesh_graph``): ``mesh_graph`` > 1 serves from a ``ShardMesh`` of
that many row-range shards on the engine's device
(keto_tpu_torch/parallel/); 1 (the default) serves unsharded.

The check batcher is wired by ``make_batcher`` as the reference's registry
wires it (keto_tpu/driver/registry.py:878-920): priority lanes, a full lane
shedding 429, and admission control over the engine's slice service times
(``admission_enabled``). ``timeline_enabled`` (default true) keeps one
``TimelineRecorder`` for both ports. ``drain_and_shutdown`` is the
reference's drain (keto_tpu/driver/daemon.py:163-277) cut to this daemon:
``/health/ready`` answers 503 while the batcher's in-flight checks and the
servers' open exchanges finish, then everything stops; the signal handling
stays with the CLI (ROADMAP A7)."""

from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence, Union

import torch

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.driver.admission import AdmissionController
from keto_tpu_torch.driver.batch import CheckBatcher
from keto_tpu_torch.expand.snapshot_engine import SnapshotExpandEngine
from keto_tpu_torch.explain import DecisionLog, ExplainEngine
from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
from keto_tpu_torch.parallel import make_mesh
from keto_tpu_torch.persistence.memory import MemoryPersister
from keto_tpu_torch.relationtuple.model import RelationTuple
from keto_tpu_torch.servers.rest import MAX_READ_DEPTH, READ, WRITE, RestServer
from keto_tpu_torch.x.device import resolve_device
from keto_tpu_torch.x.timeline import TimelineRecorder

#: the readiness reason while a drain runs (keto_tpu/driver/daemon.py:183)
DRAINING = "draining: shutdown requested"


#: the reference registry's batcher settings at their defaults
#: (keto_tpu/driver/registry.py:878-920: ``engine.batch_size``,
#: ``engine.batch_window_ms``, ``serve.interactive_max_tuples``,
#: ``serve.batch_sub_slice``, ``serve.admission_min_window``); they come
#: back as knobs with the config loader (ROADMAP A7)
BATCH_SIZE = 4096
WINDOW_MS = 1.0
INTERACTIVE_MAX_TUPLES = 16
BATCH_SUB_SLICE = 1024
ADMISSION_MIN_WINDOW = 64


def make_batcher(engine, *, admission_enabled: bool = True) -> CheckBatcher:
    """The serving process's check batcher, wired as the reference's
    registry wires it: lanes of ``max_pending = 8 × BATCH_SIZE`` tuples that
    shed when full, and (``admission_enabled``) an AIMD admission window
    over the batch lane keyed off the engine's slice service times, its
    budget 4 × the engine's slice target (``engine.stream_ctrl``)."""
    max_pending = 8 * BATCH_SIZE
    admission = None
    if admission_enabled:
        ctrl = getattr(engine, "stream_ctrl", None)
        admission = AdmissionController(
            stats=getattr(engine, "stream_slice_stats", None),
            target_ms=float(getattr(ctrl, "target_ms", 40.0)),
            min_window=ADMISSION_MIN_WINDOW,
            max_window=max_pending,
        )
    return CheckBatcher(
        engine,
        batch_size=BATCH_SIZE,
        window_ms=WINDOW_MS,
        max_pending=max_pending,
        shed_on_full=True,
        interactive_max_tuples=INTERACTIVE_MAX_TUPLES,
        batch_sub_slice=BATCH_SUB_SLICE,
        admission=admission,
    )


def drain(servers: Sequence[RestServer], batcher: CheckBatcher, drain_timeout_s: float) -> dict:
    """The drain before a shutdown: every server's ``/health/ready`` answers
    503 from now on; then wait up to ``drain_timeout_s`` for the batcher's
    in-flight checks and for the servers to write every accepted response.
    Returns ``{"batcher_idle", "servers_idle", "seconds"}``; stops nothing."""
    t0 = time.monotonic()
    for s in servers:
        s.app.draining = DRAINING
    deadline = t0 + max(0.0, drain_timeout_s)
    idle = batcher.drain(drain_timeout_s)
    servers_idle = all(s.drain(max(0.5, deadline - time.monotonic())) for s in servers)
    return {"batcher_idle": idle, "servers_idle": servers_idle,
            "seconds": time.monotonic() - t0}


class Daemon:
    def __init__(
        self,
        namespaces: Iterable[namespace_pkg.Namespace],
        *,
        device: Optional[Union[str, torch.device]] = None,
        host: str = "127.0.0.1",
        read_port: int = 0,
        write_port: int = 0,
        tuples: Iterable[RelationTuple] = (),
        engine_options: Optional[dict] = None,
        explain_enabled: bool = True,
        decision_log_dir: str = "",
        decision_log_sample: float = 0.0,
        decision_log_segment_bytes: int = 1 << 20,
        decision_log_retention: int = 8,
        mesh_graph: int = 1,
        max_read_depth: int = MAX_READ_DEPTH,
        admission_enabled: bool = True,
        timeline_enabled: bool = True,
    ):
        nm = namespace_pkg.MemoryManager(namespaces)
        options = dict(engine_options or {})
        if int(mesh_graph) > 1:
            options["mesh"] = make_mesh(graph=int(mesh_graph), device=resolve_device(device))
        self.store = MemoryPersister(nm)
        tuples = list(tuples)
        if tuples:
            self.store.write_relation_tuples(*tuples)
        self.engine = TorchCheckEngine(self.store, nm, device=device, **options)
        self.lister = SnapshotListEngine(self.engine, nm, device=self.engine.device)
        self.expander = SnapshotExpandEngine(self.engine, nm)
        self.batcher = make_batcher(self.engine, admission_enabled=admission_enabled)
        #: the request timelines of both ports
        self.recorder = TimelineRecorder(enabled=timeline_enabled)
        self.decision_log = (
            DecisionLog(decision_log_dir, sample=decision_log_sample,
                        segment_bytes=decision_log_segment_bytes,
                        retention=decision_log_retention)
            if decision_log_dir else None
        )
        self.explain = (
            ExplainEngine(self.engine, self.store, decision_log=self.decision_log)
            if explain_enabled else None
        )
        self.read = RestServer(READ, self.store, self.batcher, host, read_port,
                               lister=self.lister, explain=self.explain,
                               decision_log=self.decision_log, expander=self.expander,
                               max_read_depth=max_read_depth, recorder=self.recorder)
        self.write = RestServer(WRITE, self.store, self.batcher, host, write_port,
                                recorder=self.recorder)

    def start(self) -> None:
        """Build the first snapshot on the device, then open both ports."""
        self.engine.snapshot()
        self.batcher.start()
        self.read.start()
        self.write.start()

    def drain_and_shutdown(self, drain_timeout_s: float = 5.0) -> dict:
        """Answer 503 on ``/health/ready``, let the in-flight checks and
        responses finish (up to ``drain_timeout_s``), then stop. Returns
        ``drain``'s record."""
        out = drain((self.read, self.write), self.batcher, drain_timeout_s)
        self.stop()
        return out

    def stop(self) -> None:
        self.read.stop()
        self.write.stop()
        self.batcher.stop()
        self.engine.close()
        if self.decision_log is not None:
            self.decision_log.close()
