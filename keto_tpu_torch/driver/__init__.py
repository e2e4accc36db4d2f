"""Serving core: the check batcher with its priority lanes, admission
control and the daemon that wires store, engine, batcher and the two REST
ports together."""
