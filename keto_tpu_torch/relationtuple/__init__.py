from keto_tpu_torch.relationtuple.model import (
    RelationQuery,
    RelationTuple,
    Subject,
    SubjectID,
    SubjectSet,
    subject_from_string,
)
from keto_tpu_torch.relationtuple.manager import Manager, TransactResult

__all__ = [
    "RelationQuery",
    "RelationTuple",
    "Subject",
    "SubjectID",
    "SubjectSet",
    "subject_from_string",
    "Manager",
    "TransactResult",
]
