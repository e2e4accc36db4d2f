"""Decision provenance: witness paths, deny certificates and the durable
decision-audit log (a port of keto_tpu/explain).

A *witness* for an allowed Check is a concrete chain of relation tuples
``t1 .. tk`` where ``t1`` expands the requested ``object#relation``, each
intermediate ``ti``'s subject is the subject set the next edge expands, and
``tk``'s subject is the requested subject. A denied Check carries a
*frontier-exhaustion certificate*: the BFS frontier sizes per hop proving
the subject-set closure was exhausted without reaching the subject.

Every witness is verified edge by edge against the Manager before it
leaves the process (``verify_witness``); one that fails is a bug, counted
and replaced by the oracle's witness.
"""

from keto_tpu_torch.explain.decision_log import DecisionLog
from keto_tpu_torch.explain.engine import ExplainEngine
from keto_tpu_torch.explain.witness import build_witness, oracle_witness, verify_witness

__all__ = [
    "DecisionLog",
    "ExplainEngine",
    "build_witness",
    "oracle_witness",
    "verify_witness",
]
