"""Streaming (chunked) compression — bounded memory for any file size.

The reference loads whole files into host RAM and whole chunks into GPU
memory (``loadFile``/``loadFileMpi``; its SLURM config caps at 16 GB RAM).
Frame alignment (SURVEY.md finding #3) makes streaming trivial by design:
any frame-multiple chunking of the input produces byte-identical output to
a whole-file encode, so this driver processes fixed-size chunks —
encode on the device, append — with memory bounded by one chunk
regardless of file size.  Decompression streams symmetrically (per-chunk
frame ranges are computed from the widths header).

The FL container stores `bits` before `values`, so a single-pass streaming
writer buffers only the (tiny) widths array in RAM and spools packed bytes
to a temp file next to the output, stitching on close.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from .container import _HEADER
from .ops import fl_jax
from .ops.bitpack import FRAME_LENGTH

# frame-aligned default chunk (the pipeline depth and this size are still
# to be priced on the card: ROADMAP A6)
DEFAULT_CHUNK = 256 << 20


def _chunk_bytes(chunk_mb: int | None, frame_length: int) -> int:
    c = DEFAULT_CHUNK if chunk_mb is None else chunk_mb << 20
    c = max(c, frame_length)
    return (c // frame_length) * frame_length


def compress_fl_stream(input_path: str, output_path: str,
                       frame_length: int = FRAME_LENGTH,
                       chunk_mb: int | None = None) -> None:
    """Stream-compress ``input_path`` → FL container, bounded memory."""
    chunk = _chunk_bytes(chunk_mb, frame_length)
    total = os.path.getsize(input_path)
    bits_parts = []
    values_size = 0
    tmp_fd, tmp_path = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(output_path)) or ".",
        suffix=".flrl.tmp")
    try:
        with open(input_path, "rb") as fin, os.fdopen(tmp_fd, "wb") as ftmp:
            def chunks():
                while True:
                    buf = fin.read(chunk)
                    if not buf:
                        return
                    yield np.frombuffer(buf, np.uint8)

            # software-pipelined: chunk k+1's read + H2D +
            # kernel dispatch overlap chunk k's D2H + spool — the drain
            # of one chunk happens while the next is in flight
            # (fl_jax.encode_chunks)
            for bits, values in fl_jax.encode_chunks(chunks(),
                                                     frame_length):
                bits_parts.append(bits)
                values.tofile(ftmp)
                values_size += values.size
        bits_all = (np.concatenate(bits_parts) if bits_parts
                    else np.zeros(0, np.uint8))
        with open(output_path, "wb") as fout:
            fout.write(_HEADER.pack(total, bits_all.size, values_size))
            bits_all.tofile(fout)
            with open(tmp_path, "rb") as ftmp:
                while True:
                    blk = ftmp.read(1 << 24)
                    if not blk:
                        break
                    fout.write(blk)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def verify_fl_stream(input_path: str, container_path: str,
                     frame_length: int = FRAME_LENGTH,
                     chunk_mb: int | None = None) -> bool:
    """Round-trip self-check for the streaming path (bounded memory):
    stream-decompress ``container_path`` to a temp file and byte-compare
    against ``input_path`` chunk by chunk."""
    tmp_fd, tmp_path = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(container_path)) or ".",
        suffix=".flrl.verify")
    os.close(tmp_fd)
    try:
        decompress_fl_stream(container_path, tmp_path, frame_length,
                             chunk_mb)
        if os.path.getsize(tmp_path) != os.path.getsize(input_path):
            return False
        with open(input_path, "rb") as fa, open(tmp_path, "rb") as fb:
            while True:
                a = fa.read(1 << 24)
                b = fb.read(1 << 24)
                if a != b:
                    return False
                if not a:
                    return True
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def decompress_fl_stream(input_path: str, output_path: str,
                         frame_length: int = FRAME_LENGTH,
                         chunk_mb: int | None = None) -> None:
    """Stream-decompress an FL container, bounded memory.

    Reads the widths header once (it is ``ceil(n/L)`` bytes — 1/128 of the
    input), then walks packed bytes chunk by chunk.
    """
    chunk = _chunk_bytes(chunk_mb, frame_length)
    with open(input_path, "rb") as fin:
        input_size, bits_size, values_size = _HEADER.unpack(
            fin.read(_HEADER.size))
        bits_all = np.frombuffer(fin.read(bits_size), np.uint8)
        # Validate before walking: with a short widths array the chunk
        # loop would run out of frames (nf == 0), decode nothing, and
        # still advance `produced` — silently truncating the output.
        if bits_all.size < -(-input_size // frame_length):
            raise IOError(
                "[FileIO] corrupt FL container: widths array shorter "
                f"than frame count ({bits_all.size} < "
                f"{-(-input_size // frame_length)})")
        frames_per_chunk = chunk // frame_length
        with open(output_path, "wb") as fout:
            state = {"fstart": 0, "produced": 0}

            def parts():
                while state["produced"] < input_size:
                    nf = min(frames_per_chunk,
                             bits_all.size - state["fstart"])
                    n_out = min(chunk, input_size - state["produced"])
                    f0 = state["fstart"]
                    vbytes = fl_jax.values_size(bits_all[f0:f0 + nf], n_out,
                                                frame_length)
                    values = np.frombuffer(fin.read(vbytes), np.uint8)
                    state["fstart"] += nf
                    state["produced"] += n_out
                    yield (n_out, bits_all[f0:f0 + nf], values)

            # software-pipelined: the next chunk's read + H2D
            # + kernel dispatch overlap this chunk's D2H + file write
            for out in fl_jax.decode_chunks(parts(), frame_length):
                out.tofile(fout)
    if state["produced"] != input_size:  # pragma: no cover
        raise IOError("[FileIO] container truncated")
