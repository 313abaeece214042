"""Tracing and timing utilities (port of xmir_tpu/utils/profiling.py).

  - ``span(name)``: a wall-clock context manager that adds up per-phase
    totals and counts (``span_report``, ``reset_spans``, ``dump_spans``)
  - ``trace(dir)``: a torch.profiler trace of the CPU and, where there is
    one, the card, written under ``dir`` as a Chrome trace (trace.json)

The spans are host wall time: a span around asynchronous CUDA work measures
its enqueue unless the work ends in a synchronise inside the span.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict

_SPANS: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _SPANS[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def span_report() -> Dict[str, dict]:
    return {k: {"total_s": round(v, 4), "count": _COUNTS[k], "mean_s": round(v / _COUNTS[k], 5)}
            for k, v in sorted(_SPANS.items())}


def reset_spans():
    _SPANS.clear()
    _COUNTS.clear()


def dump_spans(path: str):
    with open(path, "w") as f:
        json.dump(span_report(), f, indent=2)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU activity, and CUDA's where a card
    is available); the Chrome trace goes to ``log_dir/trace.json``. Yields
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
