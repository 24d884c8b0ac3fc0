"""Profiling and tracing hooks (``piqp_tpu/utils/profiling.py``).

The reference compiles ~80 Tracy zone macros in under BUILD_WITH_TRACY
(utils/tracy.hpp:11-26) and fills Info's phase timers
(timer.hpp:17-35, results.hpp:83-88).  The port's analogs:

- :func:`trace`: a ``torch.profiler`` capture of everything run inside the
  context, host ops and, on a CUDA run, the card's kernels, written as a
  Chrome trace (open it in Perfetto or ``chrome://tracing``);
- :func:`annotate`: a named region that shows in that trace (the Zone
  macro analog), and as an NVTX range on a CUDA run.

Wall-clock phase timings stay host-side in the stateful solvers
(``Settings(compute_timings=True)``).
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profile of everything run inside the context and write it
    to ``log_dir/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named region for trace timelines: ``torch.profiler.record_function``
    and, on a CUDA run, ``torch.cuda.nvtx.range``."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
