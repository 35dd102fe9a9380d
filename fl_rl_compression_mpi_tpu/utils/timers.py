"""Phase timers + throughput reporting (reference component #12).

The reference instruments every phase of every path with a small timer
hierarchy (``/root/reference/src/timers/``): wall-clock ``CpuTimer``,
CUDA-event ``GpuTimer`` and throughput-reporting ``CpuTimerWithTransfer``
(auto-scaled B/s…GB/s, ``cpu_timer_with_transfer.cu:16-40``).  Same report
format here; device phases time a
``block_until_ready`` boundary (the XLA analog of CUDA events for
whole-phase timing), and `jax.profiler` traces are a context-manager away
for kernel-level breakdowns.

Two reference defects are fixed, not replicated (SURVEY.md "quirks"):
the rank-tagged print that dropped its message body (``cpu_timer.cu:19-27``)
and the division by a 0 ms interval printing ``inf``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax

_UNITS = [("GB/s", 1e9), ("MB/s", 1e6), ("KB/s", 1e3), ("B/s", 1.0)]


def _format_rate(bytes_: int, seconds: float) -> str:
    if seconds <= 0:
        return "n/a"
    rate = bytes_ / seconds
    for unit, scale in _UNITS:
        if rate >= scale:
            return f"{rate / scale:.2f} {unit}"
    return f"{rate:.2f} B/s"


class Timer:
    """Start/stop phase timer printing ``[TIMER] <name>: <ms> ms`` (the
    reference's report line, ``cpu_timer.cu:19-27``, with the dangling-else
    bug fixed: the rank tag and the timing both always print)."""

    def __init__(self, name: str, rank: int = -1, enabled: bool = True,
                 printer: Callable[[str], None] = print):
        self.name = name
        self.rank = rank
        self.enabled = enabled
        self.printer = printer
        self._t0 = 0.0
        self.elapsed_s = 0.0
        self.transfer_bytes = 0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self, *wait_for) -> float:
        """Stop; any ``wait_for`` arrays are blocked on first so device
        phases measure completed work, not dispatch."""
        for x in wait_for:
            jax.block_until_ready(x)
        self.elapsed_s = time.perf_counter() - self._t0
        return self.elapsed_s

    def add_transfer_size(self, nbytes: int) -> None:
        """Accumulate bytes for throughput reporting (the reference's
        ``addTransferSize``, ``cpu_timer_with_transfer.cuh:19-22``)."""
        self.transfer_bytes += int(nbytes)

    def print_result(self) -> None:
        if not self.enabled:
            return
        prefix = f"[Rank {self.rank}] " if self.rank >= 0 else ""
        line = f"{prefix}[TIMER] {self.name}: {self.elapsed_s * 1e3:.3f} ms"
        if self.transfer_bytes:
            line += (f" ({_format_rate(self.transfer_bytes, self.elapsed_s)},"
                     f" {self.transfer_bytes} B)")
        self.printer(line)


@contextlib.contextmanager
def timed(name: str, nbytes: int = 0, enabled: bool = True, rank: int = -1,
          result=None):
    """``with timed("compression", nbytes=n): ...`` — prints on exit.
    Pass ``result=[arr, ...]`` (a mutable list filled inside the block) to
    block on device values before stopping the clock."""
    t = Timer(name, rank=rank, enabled=enabled)
    if nbytes:
        t.add_transfer_size(nbytes)
    t.start()
    try:
        yield t
    finally:
        t.stop(*(result or ()))
        t.print_result()


# ---------------------------------------------------------------------------
# Stage timers: per-stage [TIMER] lines INSIDE the codec drivers (the
# reference wraps every internal stage — alloc, H2D, each kernel, D2H —
# in timer prints, ``fl_gpu.cu:317-415``/``:573-637``, and rank-tags the
# multihost loader/driver lines, ``file_io.cu:64``).  Module-level switch
# so the hot paths pay one bool check when observability is off.
# ---------------------------------------------------------------------------

_STAGE = {"enabled": False, "rank": -1}


def set_stage_timers(enabled: bool, rank: int = -1) -> None:
    """Enable per-stage ``[TIMER]`` lines inside the codec drivers
    (``fl_jax.encode/decode``, ``rl_jax``, ``parallel/multihost``).
    ``rank``: process index for the reference-style ``[Rank N]`` prefix
    (multihost drivers)."""
    _STAGE["enabled"] = bool(enabled)
    _STAGE["rank"] = int(rank)


def stage_timers_enabled() -> bool:
    return _STAGE["enabled"]


@contextlib.contextmanager
def stage(name: str, nbytes: int = 0, result=None):
    """Codec-internal stage timer: a no-op (no fence, no print) unless
    :func:`set_stage_timers` enabled it.  When enabled, blocks on any
    device values appended to the mutable ``result`` list before stopping
    the clock (whole-phase timing — the XLA analog of the reference's
    CUDA-event ``GpuTimer``)."""
    if not _STAGE["enabled"]:
        yield None
        return
    with timed(name, nbytes=nbytes, rank=_STAGE["rank"], enabled=True,
               result=result) as t:
        yield t


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Optional `jax.profiler` trace around a phase (kernel-level view in
    TensorBoard/XProf, on top of the per-phase timers)."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(logdir):
        yield
