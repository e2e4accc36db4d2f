"""Tuple stores behind the ``Manager`` contract (the Check slice ports the
in-memory store only)."""
