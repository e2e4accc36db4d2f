"""Shared helpers: errors, pagination, the traversal cycle guard and the
device rule every entry point follows (``x/device.py``)."""
