"""The shard mesh of the sharded serving mode: a ``graph`` axis of ``g``
row-range shards, each with its torch device.

The counterpart of ``make_mesh`` (keto_tpu/parallel/mesh.py:101-120). The
reference's mesh is a ``(graph, data)`` grid of JAX devices driven by one
process (single-controller): one ``shard_map`` program runs over it. The
port's mesh is driven the same way, by one process, and every shard's
slabs are tensors of their own on their shard's device:

- the ``graph`` axis partitions the bitmap, bucket and label rows
  (keto_tpu_torch/parallel/sharded.py);
- the ``data`` axis is 1: query words are not split, so ``data > 1``
  raises;
- every shard lives on ONE device. A mesh over several distinct devices
  needs peer copies or NCCL between them, which come with the multi-GPU
  item of ROADMAP (A11), and raises ``NotImplementedError`` until then.

Not here: ``init_distributed`` (the multi-controller runtime) and the
lockstep front end (keto_tpu/parallel/lockstep.py), ROADMAP A11 too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from keto_tpu_torch.x.device import resolve_device, same_device

GRAPH_AXIS = "graph"
DATA_AXIS = "data"


@dataclass(frozen=True)
class ShardMesh:
    """``g`` graph shards, each with its device (all the same one)."""

    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        if not all(same_device(d, self.devices[0]) for d in self.devices):
            raise NotImplementedError(
                f"a shard mesh over several devices {[str(d) for d in self.devices]}: the halo "
                "exchange between cards (peer copies or NCCL) is ROADMAP A11, not ported yet"
            )

    @property
    def graph(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as the reference's ``Mesh.shape``."""
        return {GRAPH_AXIS: self.graph, DATA_AXIS: 1}

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return torch.device(self.devices[0])


def make_mesh(
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    graph: int = 1,
    data: Optional[int] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> ShardMesh:
    """A mesh of ``graph`` shards. ``devices`` names one device per shard
    (as the reference's ``make_mesh(devices, graph=g)`` with ``data = 1``);
    without it every shard lives on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``). ``data`` must be 1 (or None)."""
    graph = int(graph)
    if graph < 1:
        raise ValueError(f"graph={graph}: a mesh needs at least one shard")
    if devices is None:
        devices = [resolve_device(device)] * graph
    devices = [torch.device(d) for d in devices]
    if data is None:
        if len(devices) % graph:
            raise ValueError(f"{len(devices)} devices not divisible by graph={graph}")
        data = len(devices) // graph
    if int(data) != 1:
        raise NotImplementedError(
            f"data={data}: the port's mesh does not split query words (the data axis is 1)"
        )
    if graph > len(devices):
        raise ValueError(f"need {graph} devices, have {len(devices)}")
    return ShardMesh(devices=tuple(devices[:graph]))
