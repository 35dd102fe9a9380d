"""Static bit-pack/unpack pattern tables shared by every FL backend.

The fixed-length (FL) codec packs each frame of ``frame_length`` bytes at the
frame's minimal bit-width ``b`` (1..8).  Element ``i`` of a frame occupies the
bit range ``[i*b, (i+1)*b)`` of the frame's bitstream; bitstream bit ``p``
lives in byte ``p // 8`` at in-byte position ``p % 8`` (LSB-first).  These are
exactly the semantics of the reference CPU codec
(``/root/reference/src/fl/fl_cpu.cu:62-84`` pack, ``:115-141`` unpack) and the
CUDA kernels (``/root/reference/src/fl/fl_gpu.cu:700-755``).

The reference scatters each *input* byte with sub-word atomics.  That is
avoidable: instead we precompute, once per width ``b``, the static
pattern describing every *output* byte as an OR of shifted input bytes (and
every decoded byte as a mask/shift of two packed bytes).  With static tables
the pack/unpack becomes a branch-free gather + shift + OR that XLA can
vectorize, and no two writers ever share an output byte — the atomics
disappear by construction.

A frame of ``L`` bytes at width ``b`` packs to ``ceil(L*b/8)`` bytes; for the
reference's ``L == 128`` that is exactly ``16*b`` bytes, so every full frame
is byte-aligned (the invariant that makes distributed concatenation lossless —
see SURVEY.md finding #3).
"""

from __future__ import annotations

import functools

import numpy as np

# Reference frame length (``/root/reference/src/fl/fl_common.cuh:9``).  The
# tables are parameterized so frame length is a real (static-compile-key)
# config knob, as the reference's design doc intended but never implemented.
FRAME_LENGTH = 128

MAX_WIDTH = 8  # bytes in, so 1..8 bits per element


def required_bits_u8(values: np.ndarray) -> np.ndarray:
    """Minimal bits to represent each byte, floored at 1.

    Matches ``8 - countLeadingZeroes(v)`` with the reference's floor of 1 for
    zero bytes (``/root/reference/src/fl/fl_cpu.cu:39-47``).
    """
    v = np.asarray(values)
    out = np.zeros(v.shape, np.int32)
    for k in range(MAX_WIDTH):
        out += (v.astype(np.int64) >= (1 << k)).astype(np.int32)
    return np.maximum(out, 1)


def packed_bytes(frame_length: int, width: int) -> int:
    """Bytes produced by one *full* frame at ``width`` bits/element."""
    return (frame_length * width + 7) // 8


@functools.lru_cache(maxsize=None)
def pack_tables(frame_length: int = FRAME_LENGTH):
    """Per-width static pack patterns.

    Returns ``{b: (idx, lshift, rshift, valid, nbytes)}`` where output byte
    ``j`` of a width-``b`` frame is::

        OR_t  valid[j,t] * ((frame[idx[j,t]] << lshift[j,t]) >> rshift[j,t])

    masked to 8 bits.  For output byte ``j``, the first contributing element
    is ``i0 = (8*j) // b`` with in-byte phase ``d = 8*j - i0*b``; element
    ``i0 + t`` contributes with signed shift ``t*b - d`` (negative = right
    shift, i.e. the reference's cross-byte overflow spill in reverse).
    """
    tables = {}
    for b in range(1, MAX_WIDTH + 1):
        nbytes = packed_bytes(frame_length, b)
        per_byte = []
        max_terms = 0
        for j in range(nbytes):
            i0 = (8 * j) // b
            d = 8 * j - i0 * b
            terms = []
            t = 0
            while True:
                s = t * b - d
                if s >= 8:
                    break
                i = i0 + t
                if i < frame_length:
                    terms.append((i, s))
                t += 1
            per_byte.append(terms)
            max_terms = max(max_terms, len(terms))
        idx = np.zeros((nbytes, max_terms), np.int32)
        shift = np.zeros((nbytes, max_terms), np.int32)
        valid = np.zeros((nbytes, max_terms), bool)
        for j, terms in enumerate(per_byte):
            for t, (i, s) in enumerate(terms):
                idx[j, t] = i
                shift[j, t] = s
                valid[j, t] = True
        lshift = np.maximum(shift, 0).astype(np.int32)
        rshift = np.maximum(-shift, 0).astype(np.int32)
        tables[b] = (idx, lshift, rshift, valid, nbytes)
    return tables


@functools.lru_cache(maxsize=None)
def unpack_tables(frame_length: int = FRAME_LENGTH):
    """Per-width static unpack patterns.

    Returns ``{b: (byte_idx, bit_off)}`` (each ``(frame_length,)``): element
    ``i`` of a width-``b`` frame starts at bitstream bit ``i*b``, i.e. packed
    byte ``byte_idx[i] = (i*b)//8`` with offset ``bit_off[i] = (i*b)%8``; the
    value is ``((p[B] >> off) | (p[B+1] << (8-off))) & ((1<<b)-1)`` — the
    two-byte masked read of ``/root/reference/src/fl/fl_cpu.cu:126-136``.
    """
    tables = {}
    for b in range(1, MAX_WIDTH + 1):
        pos = np.arange(frame_length, dtype=np.int64) * b
        byte_idx = (pos // 8).astype(np.int32)
        bit_off = (pos % 8).astype(np.int32)
        tables[b] = (byte_idx, bit_off)
    return tables


def max_row_bytes(frame_length: int = FRAME_LENGTH) -> int:
    """Worst-case packed bytes per frame (width 8)."""
    return packed_bytes(frame_length, MAX_WIDTH)
