"""Reverse queries: ListObjects ("what can X access?") and ListSubjects
("who can access Y?").

- :mod:`keto_tpu_torch.list.engine` — the Manager-backed oracle and the
  page-token helpers;
- :mod:`keto_tpu_torch.list.kernels` — the list fixpoint (K5), plain and
  CUDA;
- :mod:`keto_tpu_torch.list.gpu_engine` — the snapshot-backed engine that
  runs the fixpoint on the card over the check engine's snapshots.
"""

from keto_tpu_torch.list.engine import ListEngine, decode_page_token, encode_page_token

__all__ = ["ListEngine", "decode_page_token", "encode_page_token"]
