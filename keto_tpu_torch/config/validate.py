"""A small JSON-schema validator for the config and namespace schemas.

Serving never depends on ``jsonschema``: the port checks its copy of the
reference schema (keto_tpu_torch/config/schema.py) with this validator,
which implements the keywords that schema uses — ``type``, ``enum``,
``properties``, ``additionalProperties``, ``required``, ``items``,
``oneOf`` and ``minimum`` — with draft-07's semantics (an integral float is
an ``integer``, a bool is neither an ``integer`` nor a ``number``, and
``minimum`` applies to numbers only). ``default``, ``description``,
``title``, ``$id`` and ``$schema`` are annotations. Any other keyword in a
schema raises ``SchemaError``, so the validator never accepts what it does
not check. tests/test_torch_config.py holds its verdicts equal to
``jsonschema``'s.
"""

from __future__ import annotations

from typing import Any, Iterator

#: the keywords that annotate and constrain nothing
_ANNOTATIONS = frozenset({"default", "description", "title", "$id", "$schema", "examples"})
_CHECKED = frozenset({"type", "enum", "properties", "additionalProperties", "required",
                      "items", "oneOf", "minimum"})


class SchemaError(ValueError):
    """The schema uses a keyword this validator does not implement."""


class ValidationError(ValueError):
    """An instance the schema refuses: ``message`` in jsonschema's words,
    ``path`` the dotted location of the offending value ("" at the root)."""

    def __init__(self, message: str, path: str = ""):
        super().__init__(f"at {path}: {message}" if path else message)
        self.message = message
        self.path = path


def _is_type(value: Any, t: str) -> bool:
    if t == "object":
        return isinstance(value, dict)
    if t == "array":
        return isinstance(value, list)
    if t == "string":
        return isinstance(value, str)
    if t == "boolean":
        return isinstance(value, bool)
    if t == "null":
        return value is None
    if isinstance(value, bool):
        return False
    if t == "integer":
        return isinstance(value, int) or (isinstance(value, float) and value.is_integer())
    if t == "number":
        return isinstance(value, (int, float))
    raise SchemaError(f"unknown type {t!r}")


def _equal(a: Any, b: Any) -> bool:
    """jsonschema's equality: a bool equals only a bool."""
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    return a == b


def _join(path: str, key: Any) -> str:
    return f"{path}.{key}" if path else str(key)


def iter_errors(instance: Any, schema: dict, path: str = "") -> Iterator[ValidationError]:
    """Every violation of ``schema`` by ``instance``, depth first."""
    unknown = set(schema) - _CHECKED - _ANNOTATIONS
    if unknown:
        raise SchemaError(f"unsupported schema keywords {sorted(unknown)}")
    if "type" in schema:
        types = schema["type"] if isinstance(schema["type"], list) else [schema["type"]]
        if not any(_is_type(instance, t) for t in types):
            shown = ", ".join(repr(t) for t in types)
            yield ValidationError(f"{instance!r} is not of type {shown}", path)
            return
    if "enum" in schema and not any(_equal(instance, e) for e in schema["enum"]):
        yield ValidationError(f"{instance!r} is not one of {schema['enum']!r}", path)
    if "minimum" in schema and _is_type(instance, "number") and instance < schema["minimum"]:
        yield ValidationError(f"{instance!r} is less than the minimum of {schema['minimum']!r}",
                              path)
    if isinstance(instance, dict):
        props = schema.get("properties", {})
        for key in schema.get("required", ()):
            if key not in instance:
                yield ValidationError(f"{key!r} is a required property", path)
        extra = schema.get("additionalProperties", True)
        unexpected = [k for k in instance if k not in props]
        if extra is False and unexpected:
            names = ", ".join(repr(k) for k in unexpected)
            verb = "was" if len(unexpected) == 1 else "were"
            yield ValidationError(
                f"Additional properties are not allowed ({names} {verb} unexpected)", path)
        elif isinstance(extra, dict):
            for k in unexpected:
                yield from iter_errors(instance[k], extra, _join(path, k))
        for key, sub in props.items():
            if key in instance:
                yield from iter_errors(instance[key], sub, _join(path, key))
    if isinstance(instance, list) and "items" in schema:
        for i, item in enumerate(instance):
            yield from iter_errors(item, schema["items"], _join(path, i))
    if "oneOf" in schema:
        matched = sum(1 for sub in schema["oneOf"] if is_valid(instance, sub))
        if matched == 0:
            yield ValidationError(f"{instance!r} is not valid under any of the given schemas",
                                  path)
        elif matched > 1:
            yield ValidationError(f"{instance!r} is valid under each of the given schemas", path)


def is_valid(instance: Any, schema: dict) -> bool:
    return next(iter_errors(instance, schema), None) is None


def validate(instance: Any, schema: dict) -> None:
    """Raise the first ``ValidationError`` of ``instance`` against ``schema``."""
    err = next(iter_errors(instance, schema), None)
    if err is not None:
        raise err
