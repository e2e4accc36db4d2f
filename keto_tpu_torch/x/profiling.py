"""Profiling guard: the port's copy of keto_tpu/x/profiling.py.

The analog of the reference's profilex wiring in main (reference
main.go:25-28; config key ``profiling``, config.schema.json:271-280):
``profiling: cpu`` wraps the process in cProfile, ``profiling: mem`` in
tracemalloc, and ``profiling: trace`` records a ``torch.profiler`` trace of
the host and the card (CUDA activities: every kernel launch, copy and
synchronization) where the reference records a ``jax.profiler`` one. The
trace is written at exit as a Chrome trace (``trace.json``, viewable in
Perfetto) and a kernel table (``kernels.txt``, ``key_averages()`` sorted by
device time) under ``KETO_TPU_TRACE_DIR``, or ``./keto-tpu-trace``. Stats
and the paths print to stderr on a clean shutdown.

Unlike the reference, a ``trace`` that cannot start raises: the config
asked for a trace of the card, and a process that runs without one would
hide that. Without a CUDA device the trace covers the host alone.
"""

from __future__ import annotations

import atexit
import os
import sys


def trace_dir() -> str:
    """Where ``profiling: trace`` writes its files."""
    return os.environ.get("KETO_TPU_TRACE_DIR") or os.path.join(os.getcwd(), "keto-tpu-trace")


def attach(mode: str) -> None:
    """Install the requested profiler for the process lifetime."""
    if mode == "cpu":
        import cProfile
        import pstats

        profiler = cProfile.Profile()
        profiler.enable()

        def dump():
            profiler.disable()
            pstats.Stats(profiler, stream=sys.stderr).sort_stats("cumulative").print_stats(40)

        atexit.register(dump)
    elif mode == "mem":
        import tracemalloc

        tracemalloc.start(10)

        def dump():
            snapshot = tracemalloc.take_snapshot()
            print("== top allocations ==", file=sys.stderr)
            for stat in snapshot.statistics("lineno")[:25]:
                print(stat, file=sys.stderr)

        atexit.register(dump)
    elif mode == "trace":
        import torch
        from torch.profiler import ProfilerActivity, profile

        out = trace_dir()
        os.makedirs(out, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()

        def dump():
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
            sort = "cuda_time_total" if ProfilerActivity.CUDA in activities else "cpu_time_total"
            with open(os.path.join(out, "kernels.txt"), "w", encoding="utf-8") as f:
                f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
            print(f"== torch profiler trace written to {out} ==", file=sys.stderr)

        atexit.register(dump)
    elif mode:
        raise ValueError(f"unknown profiling mode {mode!r} (want cpu|mem|trace)")
