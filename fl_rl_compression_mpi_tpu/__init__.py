"""Lossless FL/RL compression on GPUs, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the CUDA +
MPI + NCCL reference ``Polyphemus980/fl-rl-compression-MPI``:

* **FL** — fixed-length bit-packing: per-128-byte-frame minimal bit-width
  (segmented max-reduce) + dense LSB-first re-pack, bit-exact with the
  reference container format;
* **RL** — run-length coding (flag + scan compaction, 255-capped runs),
  implemented from the reference's written spec (it shipped no RL code);
* data-parallel scaling over a ``jax.sharding.Mesh`` with ``shard_map`` and
  XLA collectives replacing MPI point-to-point / NCCL AllGather;
* a C++ host runtime for the CPU golden paths (the reference's native CPU
  codec), bound via ctypes.

Layout: ``ops/`` device + host kernels, ``models/`` codec families,
``parallel/`` mesh/sharding/multi-host, ``utils/`` timers & runtime glue.
"""

__version__ = "0.1.0"


def _retain_arena() -> None:
    """Keep freed large allocations inside the process.

    On this platform the hypervisor reclaims pages the guest frees (free
    page reporting), so every fresh large ``np.empty`` re-faults its pages
    through the host at ~0.1 GB/s — a 256 MiB host-fold buffer costs
    seconds instead of milliseconds (measured: cold first-touch 0.13 GB/s
    vs 7.6 GB/s warm, memset 11 GB/s).  Raising glibc's mmap/trim
    thresholds routes big mallocs through the brk arena and never returns
    them to the OS, so steady-state hot paths run at memory speed.  The
    high-water cost is bounded by peak simultaneous usage, which this
    workload already pays.
    """
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):  # pragma: no cover
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except OSError:  # pragma: no cover - non-glibc libc
        pass


_retain_arena()

from .container import (  # noqa: F401
    FLCompressed,
    RLCompressed,
    load_fl,
    load_rl,
    save_fl,
    save_rl,
)
from .api import (  # noqa: F401,E402
    compress,
    compress_file,
    decompress,
    decompress_file,
    methods,
)
