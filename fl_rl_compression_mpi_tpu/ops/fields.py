"""Field-form glue: host fold/unfold + end-to-end fields-path codecs.

For frame lengths that are not a multiple of 32 bytes, the FL codec splits
work between device and host (see `fl_jax.py`): the device runs
:func:`fl_jax.fl_encode_fields` / :func:`fl_jax.fl_decode_fields`
(elementwise, memory-bandwidth bound); the host folds fields into the
byte-exact reference stream (and unfolds back).  Fold/unfold use the
native OpenMP library when available (`csrc/flrlio.cpp`), else the
vectorized NumPy fallbacks below — identical output either way, pinned by
the differential tests.
"""

from __future__ import annotations

import numpy as np

from ..native import get_native
from . import fl_jax, fl_numpy
from .bitpack import FRAME_LENGTH


# ---------------------------------------------------------------------------
# NumPy fold/unfold fallbacks (correctness-first; native lib is the fast one)
# ---------------------------------------------------------------------------

def unspread_fields(fields: np.ndarray, bits: np.ndarray, n: int,
                    frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Fields → raw bytes (vectorized; inverse of the device spread)."""
    wpf = frame_length // 4
    b = np.repeat(bits.astype(np.uint32), wpf)[: fields.size]
    mask = ((np.uint32(1) << b) - np.uint32(1)).astype(np.uint32)
    f = fields.astype(np.uint32)
    out = np.empty((fields.size, 4), np.uint8)
    for k in range(4):
        out[:, k] = ((f >> (k * b)) & mask).astype(np.uint8)
    return out.reshape(-1)[:n]


def spread_fields(data: np.ndarray, bits: np.ndarray,
                  frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Raw bytes → fields (vectorized; the device spread, on host)."""
    n = data.size
    frames = -(-n // frame_length)
    buf = np.zeros(frames * frame_length, np.uint8)
    buf[:n] = data
    e = buf.reshape(-1, 4).astype(np.uint32)
    wpf = frame_length // 4
    b = np.repeat(bits.astype(np.uint32), wpf)
    return (e[:, 0] | (e[:, 1] << b) | (e[:, 2] << (2 * b))
            | (e[:, 3] << (3 * b)))


def fold(fields: np.ndarray, bits: np.ndarray, n: int,
         frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Fields + bits → byte-exact packed stream (reference layout)."""
    nat = get_native()
    if nat is not None:
        return nat.fl_fold(fields, bits, n, frame_length)
    data = unspread_fields(fields, bits, n, frame_length)
    got_bits, values = fl_numpy.encode(data, frame_length)
    if not np.array_equal(got_bits, bits[: got_bits.size]):
        raise ValueError("fold: bits inconsistent with field content")
    return values


def unfold(values: np.ndarray, bits: np.ndarray, n: int,
           frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Packed stream + bits → fields."""
    nat = get_native()
    if nat is not None:
        return nat.fl_unfold(values, bits, n, frame_length)
    data = fl_numpy.decode(n, bits, values, frame_length)
    return spread_fields(data, bits, frame_length)


# ---------------------------------------------------------------------------
# End-to-end host APIs — thin aliases of the canonical ones in fl_jax,
# kept for discoverability.
# ---------------------------------------------------------------------------

def encode(data: np.ndarray, frame_length: int = FRAME_LENGTH,
           bucket_frames: int = fl_jax.BUCKET_FRAMES):
    return fl_jax.encode(data, frame_length, bucket_frames)


def decode(output_size: int, bits: np.ndarray, values: np.ndarray,
           frame_length: int = FRAME_LENGTH,
           bucket_frames: int = fl_jax.BUCKET_FRAMES) -> np.ndarray:
    return fl_jax.decode(output_size, bits, values, frame_length,
                         bucket_frames)
