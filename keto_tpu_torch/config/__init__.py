"""The config provider and its schema (keto_tpu/config)."""

from keto_tpu_torch.config.provider import (
    Config,
    parse_text,
    NamespaceWatcher,
    load_namespaces_from_uri,
    parse_namespace_file,
    KEY_DSN,
    KEY_NAMESPACES,
    KEY_READ_API_HOST,
    KEY_READ_API_PORT,
    KEY_WRITE_API_HOST,
    KEY_WRITE_API_PORT,
)
from keto_tpu_torch.config.schema import CONFIG_SCHEMA, NAMESPACE_SCHEMA

__all__ = [
    "Config",
    "NamespaceWatcher",
    "load_namespaces_from_uri",
    "parse_namespace_file",
    "parse_text",
    "CONFIG_SCHEMA",
    "NAMESPACE_SCHEMA",
    "KEY_DSN",
    "KEY_NAMESPACES",
    "KEY_READ_API_HOST",
    "KEY_READ_API_PORT",
    "KEY_WRITE_API_HOST",
    "KEY_WRITE_API_PORT",
]
