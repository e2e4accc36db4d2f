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
``sync_rebuild_budget_s``) and ``device_build_enabled`` (the build's sorts
on the card) through to ``TorchCheckEngine``. Writes apply as
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
(keto_tpu_torch/parallel/); 1 (the default) serves unsharded."""

from __future__ import annotations

from typing import Iterable, Optional, Union

import torch

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.driver.batch import CheckBatcher
from keto_tpu_torch.expand.snapshot_engine import SnapshotExpandEngine
from keto_tpu_torch.explain import DecisionLog, ExplainEngine
from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
from keto_tpu_torch.parallel import make_mesh
from keto_tpu_torch.persistence.memory import MemoryPersister
from keto_tpu_torch.relationtuple.model import RelationTuple
from keto_tpu_torch.servers.rest import MAX_READ_DEPTH, READ, WRITE, RestServer
from keto_tpu_torch.x.device import resolve_device


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
        self.batcher = CheckBatcher(self.engine)
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
                               max_read_depth=max_read_depth)
        self.write = RestServer(WRITE, self.store, self.batcher, host, write_port)

    def start(self) -> None:
        """Build the first snapshot on the device, then open both ports."""
        self.engine.snapshot()
        self.batcher.start()
        self.read.start()
        self.write.start()

    def stop(self) -> None:
        self.read.stop()
        self.write.stop()
        self.batcher.stop()
        self.engine.close()
        if self.decision_log is not None:
            self.decision_log.close()
