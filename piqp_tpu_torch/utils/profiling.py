"""Profiling and tracing hooks (``piqp_tpu/utils/profiling.py``).

The reference compiles ~80 Tracy zone macros in under BUILD_WITH_TRACY
(utils/tracy.hpp:11-26) and fills Info's phase timers
(timer.hpp:17-35, results.hpp:83-88).  The port's analogs:

- :func:`trace`: a ``torch.profiler`` capture of everything run inside the
  context, host ops and, on a CUDA run, the card's kernels, written as a
  Chrome trace (open it in Perfetto or ``chrome://tracing``);
- :func:`annotate`: a named region that shows in that trace (the Zone
  macro analog), and as an NVTX range on a CUDA run.

A region is recorded only while a profiler records: ``torch.profiler``
(Kineto puts the span on the clock of the card's kernels, copies and
fills) or ``torch.autograd.profiler.emit_nvtx()`` for Nsight.  Otherwise
``annotate`` costs one check of the profiler's flag and enters nothing.
Regions nest by time on their thread, so a region's parent is the region
that encloses it; the profiler keeps them, nothing else does.

The program's regions are named ``piqp.<layer>[.<part>]``:

- ``piqp.entry.copy``, ``piqp.entry.canonical``: an entry's stack of each
  raw field into host staging with its host-to-device copy, then the
  canonicalisation of the batch on its device, in that order, in both
  entries: ``batch.prepare_batch`` (dense) and the stage entry
  (``batch.prepare_stage_batch``, ``multistage.from_stage_blocks``,
  ``from_sparse``); the counter ``batch.entry_batches_by_staging`` counts
  their calls by staging, ``"pinned"`` or ``"pageable"``;
- ``piqp.solve``: one request, ``api._solve_fresh`` or ``_solve_reuse``;
- ``piqp.ruiz``: the Ruiz equilibration of ``_solve_fresh``;
- ``piqp.ipm.iter``: one trip of ``solver.solve_scaled``'s loop, in either
  mixed-precision phase, with the exit test that follows it;
- ``piqp.kkt.factor``: one factorization attempt of
  ``solver.factor_ladder`` (scalings and ``kkt.factor``), retries included;
- ``piqp.kkt.solve``: ``kkt.solve``, iterative refinement included;
- ``piqp.ipm.graph``: one replay of a CUDA graph of a segment of the
  loop (``graphs.Segments.run``), inside the trip's and the KKT's spans
  that the segment's eager code sits in;
- ``piqp.horizon.factor``, ``piqp.horizon.solve``: the horizon-sharded
  factorization and condensed solve (``parallel/horizon.py``);
- ``piqp.ms.cr_level``: one level of ``multistage.cr_chain_factor``'s
  cyclic reduction, its K2 launch (or library factor) and Schur updates;
- ``piqp.ms.cr_sweep``: one of ``multistage.cr_chain_fwd`` and
  ``cr_chain_bwd``, the cyclic-reduction sweeps of a condensed solve.

Wall-clock phase timings stay host-side in the stateful solvers
(``Settings(compute_timings=True)``).
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"

# whether a profiler (torch.profiler, or autograd's emit_nvtx) records
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


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


def annotate(name: str):
    """Named region for trace timelines while a profiler records:
    ``torch.profiler.record_function`` and, on a CUDA run,
    ``torch.cuda.nvtx.range``.  With no profiler recording, a context that
    does nothing."""
    if not _recording():
        return _OFF
    return _span(name)


@contextlib.contextmanager
def _span(name: str):
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
