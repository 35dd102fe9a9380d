"""RL (run-length) codec on the device, in plain JAX.

Semantics come from the golden NumPy implementation (`rl_numpy.py`) and the
reference's written spec (``/root/reference/IMPLEMENTATION-PLAN.md:81-179`` —
the reference ships no RL code).  The spec's GPU shape is flag → scan →
compact, with a rescan fix-up loop for runs longer than 255; here the cap is
applied *directly* in one pass — ``lax.cummax`` of flagged positions gives
each element its (uncapped) run start, and extra boundaries are flagged every
255 elements — so the whole encode is two scans, two scatters and a gather,
all static-shape and branch-free:

* ``flags``: run-start indicator (shifted inequality) OR a 255-cap boundary;
* ``run_id``: inclusive scan of flags − 1 (the spec's ``startIndices`` scan);
* compaction: scatter of flagged elements to ``run_id`` slots — every write
  index is unique, so no atomics and no nondeterminism;
* decode: exclusive scan of counts → run starts; a mark/cumsum assigns each
  output element its run id, replacing the spec's per-thread binary search
  (``IMPLEMENTATION-PLAN.md:154-179``) with a single scan + gather.

Shapes are static (worst case: every byte its own run); the true input
length ``n`` and run count are traced scalars, sliced on host.  Index math
is int32, so one call handles inputs below 2 GiB.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

RUN_CAP = 255  # counts are u8 (IMPLEMENTATION-PLAN.md:125)


class RLEncoded(NamedTuple):
    """Worst-case static-shape encode result; first ``num_runs`` entries of
    ``counts``/``values`` are valid."""
    counts: jax.Array    # u8[N_pad]
    values: jax.Array    # u8[N_pad]
    num_runs: jax.Array  # i32 scalar


@jax.jit
def rl_encode(data: jax.Array, n: jax.Array) -> RLEncoded:
    """Encode ``data[:n]`` (u8[N_pad]; bytes beyond ``n`` may be junk)."""
    npad = data.shape[0]
    n = n.astype(jnp.int32)
    idx = jnp.arange(npad, dtype=jnp.int32)
    valid = idx < n
    data = jnp.where(valid, data, 0).astype(jnp.uint8)

    prev = jnp.concatenate([data[:1] ^ 1, data[:-1]])  # force flag at 0
    flags = (data != prev) & valid
    flags = flags.at[0].set(n > 0)

    # Uncapped run start of every element: running max of flagged positions.
    start = jax.lax.cummax(jnp.where(flags, idx, 0))
    flags = flags | (((idx - start) % RUN_CAP == 0) & (idx != start) & valid)

    run_id = jnp.cumsum(flags.astype(jnp.int32)) - 1
    num_runs = jnp.where(n > 0, run_id[-1] + 1, 0)

    # Compact: only flagged elements write; their run_ids are unique.
    scatter_to = jnp.where(flags, run_id, npad)        # npad = dropped
    values = (jnp.zeros(npad, jnp.uint8)
              .at[scatter_to].set(data, mode="drop"))
    starts = (jnp.zeros(npad, jnp.int32)
              .at[scatter_to].set(idx, mode="drop"))
    # counts[r] = starts[r+1] - starts[r]; last run ends at n.
    next_start = jnp.concatenate([starts[1:], starts[-1:]])
    rix = jnp.arange(npad, dtype=jnp.int32)
    next_start = jnp.where(rix == num_runs - 1, n, next_start)
    counts = jnp.where(rix < num_runs, next_start - starts, 0)
    return RLEncoded(counts=counts.astype(jnp.uint8), values=values,
                     num_runs=num_runs)


@functools.partial(jax.jit, static_argnames=("out_pad",))
def rl_decode(counts: jax.Array, values: jax.Array, num_runs: jax.Array,
              n: jax.Array, out_pad: int) -> jax.Array:
    """Decode to u8[out_pad] with valid prefix ``n`` (= sum of counts).

    ``counts``/``values`` are u8[R_pad] with junk beyond ``num_runs``;
    ``out_pad`` is the static output buffer size (≥ n — callers know the
    decoded size from the container's ``inputSize`` header field).
    """
    rpad = counts.shape[0]
    n = n.astype(jnp.int32)
    rix = jnp.arange(rpad, dtype=jnp.int32)
    c = jnp.where(rix < num_runs, counts.astype(jnp.int32), 0)
    starts = jnp.cumsum(c) - c                         # exclusive scan

    scatter_to = jnp.where((rix < num_runs) & (c > 0), starts, out_pad)
    mark = (jnp.zeros(out_pad, jnp.int32)
            .at[scatter_to].add(1, mode="drop"))
    run_id = jnp.cumsum(mark) - 1
    run_id = jnp.clip(run_id, 0, rpad - 1)
    out = values[run_id]
    oix = jnp.arange(out_pad, dtype=jnp.int32)
    return jnp.where(oix < n, out, 0).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Host-facing convenience wrappers.
# ---------------------------------------------------------------------------

def _pad(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def _constant_byte(data: np.ndarray) -> int | None:
    """Cheap two-stage constant-stream check (chunked early-exit
    verify — shared helper in ``utils``): non-constant streams pay
    ~128 KiB, constant streams pay one bounded-memory compare instead
    of the whole device round trip."""
    from ..utils import constant_byte_probe
    return constant_byte_probe(data)


def encode(data: np.ndarray, bucket: int = 1 << 20):
    """NumPy in → exact (counts u8[R], values u8[R]) out (host API mirroring
    `rl_numpy.encode`)."""
    data = np.asarray(data, np.uint8)
    n = data.size
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    # Whole-stream CONSTANT fast path (round 4b): the RL container of a
    # constant stream is closed-form — ceil(n/255) runs of 255 (tail
    # remainder) of one value (spec semantics:
    # /root/reference/IMPLEMENTATION-PLAN.md:125-148, pinned by the
    # rl_numpy golden) — so one host verify pass replaces the whole
    # H2D + kernel + D2H round trip.  The verify is exact, not
    # speculative: no miss path exists.
    c = _constant_byte(data)
    if c is not None:
        from ..utils.timers import stage
        with stage("Compression", n):      # --timers stage parity
            runs = -(-n // 255)
            counts = np.full(runs, 255, np.uint8)
            counts[-1] = n - 255 * (runs - 1)
            return counts, np.full(runs, c, np.uint8)
    npad = _pad(n, bucket)
    buf = np.zeros(npad, np.uint8)
    buf[:n] = data
    # Per-stage [TIMER] lines (no-op unless the CLI enabled them) —
    # observability parity with the reference's per-phase codec timers
    # (/root/reference/src/fl/fl_gpu.cu:317-415; RL is spec-only there).
    from ..utils.timers import stage
    h2d = []
    with stage("Copy input data to device", npad, result=h2d):
        dataj = jnp.asarray(buf)
        h2d.append(dataj)
    krn = []
    with stage("Compression", n, result=krn):
        enc = rl_encode(dataj, jnp.int32(n))
        krn += [enc.counts, enc.num_runs]
    r = int(enc.num_runs)
    with stage("Copy results to CPU", 2 * r):
        return (np.asarray(jax.device_get(enc.counts[:r])),
                np.asarray(jax.device_get(enc.values[:r])))


def decode(counts: np.ndarray, values: np.ndarray,
           bucket: int = 1 << 15) -> np.ndarray:
    """NumPy in → decoded bytes out (host API mirroring `rl_numpy.decode`).
    The exact decoded size is the sum of counts, computed host-side."""
    counts = np.asarray(counts, np.uint8)
    values = np.asarray(values, np.uint8)
    r = counts.size
    if r == 0:
        return np.zeros(0, np.uint8)
    n = int(counts.astype(np.int64).sum())
    # Constant-container fast path (round 4b): the canonical constant
    # stream container (all counts 255 but the tail, one value) decodes
    # to a host memset — the check reads only the ~n/255-byte container.
    if (bool((values == values[0]).all())
            and bool((counts[:-1] == 255).all())):
        from ..utils.timers import stage
        with stage("Decompression", n):    # --timers stage parity
            return np.full(n, values[0], np.uint8)
    rpad = _pad(r, bucket)
    cbuf = np.zeros(rpad, np.uint8)
    cbuf[:r] = counts
    vbuf = np.zeros(rpad, np.uint8)
    vbuf[:r] = values
    out_pad = _pad(n, bucket)
    from ..utils.timers import stage
    h2d = []
    with stage("Copy input to device", 2 * rpad, result=h2d):
        cj, vj = jnp.asarray(cbuf), jnp.asarray(vbuf)
        h2d += [cj, vj]
    krn = []
    with stage("Decompression", n, result=krn):
        outd = rl_decode(cj, vj, jnp.int32(r), jnp.int32(n), out_pad)
        krn.append(outd)
    with stage("Copy results to CPU", n):
        out = jax.device_get(outd)
    return np.asarray(out)[:n]
