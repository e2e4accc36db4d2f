"""Serving core: the check batcher and the daemon that wires store, engine,
batcher and the two REST ports together."""
