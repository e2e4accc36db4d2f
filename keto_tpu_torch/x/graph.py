"""Traversal cycle guard.

The reference keeps a per-request visited set keyed by the subject's string
form, created lazily and mutated in place so it is shared across sibling
branches of the traversal (reference internal/x/graph/graph_utils.go:13-35).
"""

from __future__ import annotations

from keto_tpu_torch.relationtuple.model import Subject


def check_and_add_visited(visited: set[str], current: Subject) -> bool:
    """Returns True if ``current`` was already visited; marks it otherwise.

    Keys are ``str(subject)`` — meaning a SubjectID whose id happens to spell
    ``ns:obj#rel`` collides with that SubjectSet, exactly as in the reference.
    """
    key = str(current)
    if key in visited:
        return True
    visited.add(key)
    return False
