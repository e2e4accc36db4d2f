from keto_tpu_torch.expand.engine import ExpandEngine
from keto_tpu_torch.expand.tree import EXCLUSION, INTERSECTION, LEAF, UNION, Tree

__all__ = ["ExpandEngine", "Tree", "LEAF", "UNION", "EXCLUSION", "INTERSECTION"]
