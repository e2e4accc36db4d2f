"""Tuple-graph machinery for the GPU check engine: string interning, the
bucketed reverse-ELL snapshot and its device-resident copy (``carry``)."""
