"""FL (fixed-length) codec on the device, in plain JAX.

Semantics are specified by the golden NumPy implementation (`fl_numpy.py`)
and, transitively, by the reference CPU codec
(``/root/reference/src/fl/fl_cpu.cu``).  The computation takes the shape of
the reference's CUDA kernels (``fl_gpu.cu:648-755``) without their atomics
(SURVEY.md §7):

* **Widths.** The per-frame width is the reference's ``max(1, 8 - clz(max
  byte))`` (``fl_cpu.cu:39-47``), computed from an integer OR-reduce
  (bitlen(OR) == bitlen(max) for unsigned bytes) in place of the
  reference's shared-memory ``atomicMax`` tree.
* **Field form.** The input is viewed as little-endian u32 words (4
  elements per word).  For a frame at width ``b``, word ``q`` becomes field
  ``q``, the 4·b-bit *spread* ``e0 | e1<<b | e2<<2b | e3<<3b`` (exact in
  u32: 3b+8 ≤ 32).  A frame's packed payload is its fields' low 4·b-bit
  windows concatenated.
* **Dense placement** (``frame_length % 32 == 0``, the reference's 128
  included).  A group of 8 fields packs to exactly ``b`` whole u32 words, so
  a frame packs to ``L·b/32`` words and no two frames share a word.  An
  exclusive cumsum of those word counts places every frame, and one scatter
  with unique indices writes the container's packed stream: no atomics, a
  deterministic result.  Decode gathers the same words back.  Only the
  compressed bytes cross the host link in either direction.
* **Field route** (other frame lengths).  The device computes fields and
  the host places bytes with the native fold/unfold (``csrc/flrlio.cpp``).

Shapes are static (XLA compiles once per padded-size bucket); the true
length ``n`` is a traced scalar so arbitrary sizes reuse one executable.
Index math is int32, so one dispatch is capped at 1 GiB
(:data:`MAX_DEVICE_CHUNK`); larger inputs run as a pipeline of
frame-aligned chunks with byte-identical output (SURVEY.md finding #3),
side-stepping the reference's ``int`` overflow (``file_io.cu:46-51``).
"""

from __future__ import annotations

import functools
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.timers import stage
from .bitpack import FRAME_LENGTH, MAX_WIDTH


def _required_bits(frame_max: jax.Array) -> jax.Array:
    """``max(1, 8 - clz(v))`` per frame, branch-free (floor of 1 for zero
    frames as in the reference, ``fl_cpu.cu:39-47``)."""
    acc = jnp.zeros_like(frame_max)
    for k in range(MAX_WIDTH):
        acc = acc + (frame_max >= (1 << k)).astype(frame_max.dtype)
    return jnp.maximum(acc, 1)


def _word_tail_mask(nw: int, n: jax.Array) -> jax.Array:
    """u32 mask zeroing bytes at global index ≥ n (word-granular)."""
    widx = jnp.arange(nw, dtype=jnp.int32)
    rem = jnp.clip(n - widx * 4, 0, 4)
    m = jnp.uint32(0)
    for k, mk in ((1, 0xFF), (2, 0xFFFF), (3, 0xFFFFFF), (4, 0xFFFFFFFF)):
        m = jnp.where(rem == k, jnp.uint32(mk), m)
    return m


def _broadcast_frames(x: jax.Array, wpf: int) -> jax.Array:
    """Per-frame value → per-word value, flat."""
    F = x.shape[0]
    return jnp.broadcast_to(x[:, None], (F, wpf)).reshape(F * wpf)


@functools.partial(jax.jit, static_argnames=("frame_length",))
def fl_encode_fields(words: jax.Array, n: jax.Array,
                     frame_length: int = FRAME_LENGTH):
    """Encode to field form.

    ``words``: u32[NW] little-endian view of the input bytes (NW·4 a frame
    multiple; bytes ≥ n may be junk).  Returns ``(bits u8[F], fields
    u32[NW])`` — fields of frames beyond ``ceil(n/L)`` are zero.
    """
    L = frame_length
    assert L % 8 == 0
    wpf = L // 4                     # words per frame
    nw = words.shape[0]
    assert nw % wpf == 0
    F = nw // wpf
    n = n.astype(jnp.int32)
    w = words.astype(jnp.uint32) & _word_tail_mask(nw, n)

    # Per-frame width via OR-reduce (bitlen(OR bytes) == bitlen(max byte)).
    o = w | (w >> 8)
    o = (o | (o >> 16)) & jnp.uint32(0xFF)
    frame_or = o.reshape(F, wpf).max(axis=1).astype(jnp.int32)
    bits = _required_bits(frame_or)

    # One constant-shift spread per width, selected by the frame's width
    # (b == 8 is the identity spread).
    bw = _broadcast_frames(bits, wpf)
    e1 = (w >> 8) & jnp.uint32(0xFF)
    e2 = (w >> 16) & jnp.uint32(0xFF)
    e3 = w >> 24
    e0 = w & jnp.uint32(0xFF)
    fields = w
    for b in range(1, MAX_WIDTH):
        sp = e0 | (e1 << b) | (e2 << (2 * b)) | (e3 << (3 * b))
        fields = jnp.where(bw == b, sp, fields)
    return bits.astype(jnp.uint8), fields


@functools.partial(jax.jit, static_argnames=("frame_length",))
def fl_decode_fields(fields: jax.Array, bits: jax.Array, n: jax.Array,
                     frame_length: int = FRAME_LENGTH) -> jax.Array:
    """Inverse of :func:`fl_encode_fields`: fields u32[NW] + bits u8[F] →
    decoded words u32[NW] (bytes ≥ n zeroed)."""
    L = frame_length
    wpf = L // 4
    nw = fields.shape[0]
    assert bits.shape[0] * wpf == nw
    n = n.astype(jnp.int32)
    f = fields.astype(jnp.uint32)

    bw = _broadcast_frames(bits.astype(jnp.int32), wpf)
    w = f
    for b in range(1, MAX_WIDTH):
        mask = jnp.uint32((1 << b) - 1)
        un = ((f & mask) | (((f >> b) & mask) << 8)
              | (((f >> (2 * b)) & mask) << 16)
              | (((f >> (3 * b)) & mask) << 24))
        w = jnp.where(bw == b, un, w)
    return w & _word_tail_mask(nw, n)


# ---------------------------------------------------------------------------
# Dense placement (frame_length % 32 == 0).
# ---------------------------------------------------------------------------

def dense_route(frame_length: int) -> bool:
    """Whether frames of this length pack to whole u32 words (L·b/32 words
    at every width b), so the device places the packed stream itself."""
    return frame_length % 32 == 0


def _pack_terms(b: int):
    """(out_slot j, field k, shift) terms for packing one 8-field group at
    width b: field k's 4b bits live at group-bit offset 4bk; out word j
    holds group bits [32j, 32j+32)."""
    terms = []
    for k in range(8):
        lo = 4 * b * k
        hi = lo + 4 * b
        for j in range(lo // 32, (hi - 1) // 32 + 1):
            terms.append((j, k, lo - 32 * j))
    return terms


def _pack_groups(g: jax.Array, b: int) -> jax.Array:
    """Funnel-pack u32[..., 8] fields of width-b frames → u32[..., b]."""
    cols = [None] * b
    for j, k, shift in _pack_terms(b):
        t = g[..., k] << shift if shift >= 0 else g[..., k] >> -shift
        cols[j] = t if cols[j] is None else cols[j] | t
    return jnp.stack(cols, axis=-1)


def _unpack_groups(p: jax.Array, b: int) -> jax.Array:
    """Inverse funnel: u32[..., b] packed words → u32[..., 8] fields."""
    fb = 4 * b
    mask = jnp.uint32((1 << fb) - 1)
    out = []
    for k in range(8):
        j, s = divmod(fb * k, 32)
        v = p[..., j] >> s
        if s + fb > 32:
            v = v | (p[..., j + 1] << (32 - s))
        out.append(v & mask)
    return jnp.stack(out, axis=-1)


def _frame_word_offsets(bits: jax.Array, n: jax.Array, frame_length: int):
    """Words per live frame (L·b/32; 0 beyond ``ceil(n/L)``) and their
    exclusive cumsum — the frame's word offset in the packed stream."""
    F = bits.shape[0]
    live = (jnp.arange(F, dtype=jnp.int32)
            < (n.astype(jnp.int32) + frame_length - 1) // frame_length)
    fw = jnp.where(live, bits.astype(jnp.int32) * (frame_length // 32), 0)
    return fw, jnp.cumsum(fw) - fw


@functools.partial(jax.jit, static_argnames=("frame_length",))
def fl_encode_dense(words: jax.Array, n: jax.Array,
                    frame_length: int = FRAME_LENGTH):
    """Encode to the container's packed stream, placed on the device.

    ``words``: u32[NW] as for :func:`fl_encode_fields`.  Returns ``(bits
    u8[F], dense u32[NW], total_words i32)``: the first ``total_words``
    words of ``dense`` are the packed stream (the tail frame's last word
    holds zero bits past ``n``); the rest is zero.
    """
    L = frame_length
    assert dense_route(L)
    wpf, G = L // 4, L // 32
    nw = words.shape[0]
    bits, fields = fl_encode_fields(words, n, frame_length=L)
    F = bits.shape[0]
    b = bits.astype(jnp.int32)[:, None]
    groups = fields.reshape(F, G, 8)
    packed = fields.reshape(F, wpf)                     # width 8: identity
    for w in range(1, MAX_WIDTH):
        pw = _pack_groups(groups, w).reshape(F, G * w)
        pw = jnp.pad(pw, ((0, 0), (0, wpf - G * w)))
        packed = jnp.where(b == w, pw, packed)
    fw, woff = _frame_word_offsets(bits, n, L)
    j = jnp.arange(wpf, dtype=jnp.int32)[None, :]
    # Words past a frame's count go to distinct out-of-range slots, so
    # every index is unique and the scatter needs no atomics.
    spill = nw + jnp.arange(F * wpf, dtype=jnp.int32).reshape(F, wpf)
    idx = jnp.where(j < fw[:, None], woff[:, None] + j, spill)
    dense = jnp.zeros(nw, jnp.uint32).at[idx.reshape(-1)].set(
        packed.reshape(-1), mode="drop", unique_indices=True)
    return bits, dense, jnp.sum(fw)


@functools.partial(jax.jit, static_argnames=("frame_length",))
def fl_decode_dense(dense: jax.Array, bits: jax.Array, n: jax.Array,
                    frame_length: int = FRAME_LENGTH) -> jax.Array:
    """Inverse of :func:`fl_encode_dense`: packed stream u32[V] (any length;
    words past V read as zero) + bits u8[F] → decoded words u32[F·L/4]
    (bytes ≥ n zeroed)."""
    L = frame_length
    assert dense_route(L)
    wpf, G = L // 4, L // 32
    F = bits.shape[0]
    fw, woff = _frame_word_offsets(bits, n, L)
    j = jnp.arange(wpf, dtype=jnp.int32)[None, :]
    packed = dense.at[woff[:, None] + j].get(mode="fill", fill_value=0)
    packed = jnp.where(j < fw[:, None], packed, jnp.uint32(0))
    b = bits.astype(jnp.int32)[:, None, None]
    fields = packed.reshape(F, G, 8)                    # width 8: identity
    for w in range(1, MAX_WIDTH):
        fields = jnp.where(
            b == w, _unpack_groups(packed[:, : G * w].reshape(F, G, w), w),
            fields)
    return fl_decode_fields(fields.reshape(-1), bits, n, frame_length=L)


# ---------------------------------------------------------------------------
# Host-facing APIs (pad → device → exact-size container bytes).
# ---------------------------------------------------------------------------

# Single device dispatch cap: index math inside the kernels is int32 (the
# design cap documented above).  Larger inputs are processed in
# frame-aligned chunks — byte-identical output by the frame-alignment
# invariant (SURVEY.md finding #3).
MAX_DEVICE_CHUNK = 1 << 30


# Default padding bucket: inputs pad to a multiple of 2^13 frames (1 MiB at
# the reference's frame length), so nearby sizes share one executable.
BUCKET_FRAMES = 1 << 13


def _device_cap(frame_length: int) -> int:
    return (MAX_DEVICE_CHUNK // frame_length) * frame_length


def _check_frame_length(frame_length: int) -> None:
    # Every formulation here (the field spread, the closed-form constant
    # container) assumes full frames are byte-aligned; the CLI enforces
    # the same rule.
    if frame_length % 8:
        raise ValueError(
            f"frame_length must be a multiple of 8, got {frame_length}")


def pad_to_frames(n: int, frame_length: int = FRAME_LENGTH,
                  bucket: int = 1) -> int:
    """Static padded size for an ``n``-byte input: a frame multiple, rounded
    up to ``bucket`` frames so many sizes share one compiled executable."""
    frames = max(1, -(-n // frame_length))
    frames = -(-frames // bucket) * bucket
    return frames * frame_length


def frame_value_bytes(bits: np.ndarray, n: int,
                      frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Packed bytes of each of the ``ceil(n/L)`` frames (only the last
    frame may be partial) — the reference decoder's offset scan input
    (``fl_gpu.cu:596-601``)."""
    frames = -(-n // frame_length)
    counts = np.minimum(
        n - np.arange(frames, dtype=np.int64) * frame_length, frame_length)
    return (bits[:frames].astype(np.int64) * counts + 7) // 8


def values_size(bits: np.ndarray, n: int,
                frame_length: int = FRAME_LENGTH) -> int:
    """Exact packed-stream size of an ``n``-byte input with widths ``bits``."""
    return int(frame_value_bytes(bits, n, frame_length).sum())


def transfer_words(k: int, nw: int) -> int:
    """Words to move for a ``k``-word prefix of an ``nw``-word buffer,
    rounded up to 1/32 of the buffer so that transfers compile a bounded
    number of shapes (at most 3% more than ``k``)."""
    step = max(nw // 32, 1)
    return min(nw, max(1, -(-k // step)) * step)


def _host_constant_byte(data: np.ndarray) -> int | None:
    """Two-stage constant-stream check (cheap 128 KiB probe, then a
    chunked early-exit verify — shared helper in ``utils``)."""
    from ..utils import constant_byte_probe
    return constant_byte_probe(data)


def _constant_frame_pattern(c: int, fb: int,
                            frame_length: int) -> np.ndarray:
    """One full frame's packed payload for a constant byte ``c`` at
    width ``fb``: the LSB-first repetition of c's fb bits over
    frame_length·fb bits — a byte cycle of period fb (frames restart
    the phase, so every full frame is this same block)."""
    nbytes = frame_length * fb // 8
    cbits = np.array([(c >> k) & 1 for k in range(fb)], np.uint8)
    stream = np.tile(cbits, nbytes * 8 // fb)
    return np.packbits(stream, bitorder="little")  # LSB-first per byte


def _constant_container(c: int, n: int, frame_length: int):
    """Closed-form FL container of ``n`` bytes of constant ``c``
    (any width 1..8, any tail): widths all fb; payload = the per-frame
    byte cycle, with the tail frame truncated to ceil(counts·fb/8)
    bytes and its last partial byte masked."""
    fb = max(1, int(c).bit_length())
    frames = -(-n // frame_length)
    bits = np.full(frames, fb, np.uint8)
    pat = _constant_frame_pattern(c, fb, frame_length)
    tail_count = n - (frames - 1) * frame_length
    tail_bits = tail_count * fb
    tail_len = -(-tail_bits // 8)
    values = np.tile(pat, frames)[: (frames - 1) * pat.size + tail_len]
    if tail_bits % 8:
        values[-1] &= (1 << (tail_bits % 8)) - 1
    return bits, values


def host_constant_decode_probe(bits: np.ndarray, values: np.ndarray,
                               n: int,
                               frame_length: int = FRAME_LENGTH
                               ) -> int | None:
    """Decode-side constant-container check, shared by the single-device
    and distributed host decoders: returns the constant byte when the
    container is EXACTLY the closed form (uniform widths + repeating frame
    pattern, verified by a cheap prefix probe and then an exact full
    compare), else None — a mismatch falls through to the device path."""
    frames = -(-n // frame_length)
    if (frame_length % 8 or not frames or not values.size
            or bits.size < frames):
        return None
    ba = bits[:frames]
    if not bool((ba == ba[0]).all()):
        return None
    fbu = int(ba[0])
    c = int(values[0]) & ((1 << fbu) - 1)
    if max(1, c.bit_length()) != fbu:
        return None
    # prefix probe against the repeating frame pattern (valid strictly
    # before the last byte — only the tail frame's final byte is
    # masked), THEN the exact full compare
    pat = _constant_frame_pattern(c, fbu, frame_length)
    probe = min(values.size - 1, 128 << 10)
    pre = np.tile(pat, -(-probe // pat.size) + 1)[:probe]
    if not bool((values[:probe] == pre).all()):
        return None
    _, ev = _constant_container(c, n, frame_length)
    if values.size == ev.size and bool((values == ev).all()):
        return c
    return None


def host_identity_decode_probe(bits: np.ndarray, values: np.ndarray,
                               n: int,
                               frame_length: int = FRAME_LENGTH):
    """Width-8 IDENTITY check, shared by every host decoder: packing bytes
    at width 8 is the identity, so an all-8 widths header means the
    payload IS the output — one memcpy, no device work (the
    incompressible-stream class).  Returns the decoded bytes or None."""
    frames = -(-n // frame_length)
    if not frames or bits.size < frames or values.size < n:
        return None
    ba = bits[:frames]
    if bool((ba == 8).all()):
        return values[:n].copy()
    return None


def encode(data: np.ndarray, frame_length: int = FRAME_LENGTH,
           bucket_frames: int = BUCKET_FRAMES):
    """NumPy in → (bits u8[F], values u8[V]) out, exact sizes, bit-exact
    with `fl_numpy.encode`.  A one-chunk run of :func:`encode_chunks`
    (inputs above the device cap run as a pipeline of chunks)."""
    data = np.asarray(data, np.uint8)
    parts = list(encode_chunks([data], frame_length, bucket_frames))
    if len(parts) == 1:
        return parts[0]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def decode(output_size: int, bits: np.ndarray, values: np.ndarray,
           frame_length: int = FRAME_LENGTH,
           bucket_frames: int = BUCKET_FRAMES) -> np.ndarray:
    """NumPy in → decoded u8[output_size].  A one-chunk run of
    :func:`decode_chunks`."""
    parts = list(decode_chunks([(output_size, bits, values)], frame_length,
                               bucket_frames))
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


# ---------------------------------------------------------------------------
# Software-pipelined chunked codec.
#
# JAX dispatch is asynchronous: ``device_put`` and kernel calls return
# immediately and only ``device_get`` blocks.  These generators use that to
# overlap chunk k+1's H2D + kernel with chunk k's D2H + host work — a
# pipeline whose wall time approaches max(phase) per chunk instead of the
# reference's fully serialized Σ(phases) (``fl_gpu.cu:341,348,367``
# synchronizes after every stage).  The per-stage [TIMER] lines (enabled by
# ``--timers``) mirror the reference's ``gpuCompress``/``gpuDecompress``
# timers (``fl_gpu.cu:317-415``, ``:573-637``); enabling them fences each
# stage, which serializes the pipeline.  Frame-aligned chunks make the
# outputs byte-identical to a whole-buffer encode (SURVEY.md finding #3).
# ---------------------------------------------------------------------------

def _encode_submit(data: np.ndarray, frame_length: int, bucket_frames: int):
    n = data.size
    if n == 0:
        return ("ready", (np.zeros(0, np.uint8), np.zeros(0, np.uint8)))
    c = _host_constant_byte(data)
    if c is not None:
        # closed-form container: one exact host verify pass replaces the
        # whole device round trip
        with stage("Compression", n):
            return ("ready", _constant_container(c, n, frame_length))
    npad = pad_to_frames(n, frame_length, bucket_frames)
    buf = np.zeros(npad, np.uint8)
    buf[:n] = data
    h2d = []
    with stage("Copy input data to device", npad, result=h2d):
        words = jnp.asarray(buf.view(np.uint32))
        h2d.append(words)
    krn = []
    with stage("Compression", n, result=krn):
        if dense_route(frame_length):
            out = fl_encode_dense(words, jnp.int32(n),
                                  frame_length=frame_length)
        else:
            out = fl_encode_fields(words, jnp.int32(n),
                                   frame_length=frame_length)
        krn += list(out)
    return ("dev", n, out)


def _encode_drain(entry, frame_length: int):
    if entry[0] == "ready":
        return entry[1]
    _, n, out = entry
    frames = -(-n // frame_length)
    if dense_route(frame_length):
        bits_d, dense_d, _ = out
        with stage("Copy results to CPU") as t:
            bits = np.asarray(jax.device_get(bits_d))[:frames]
            vsz = values_size(bits, n, frame_length)
            kw = transfer_words(-(-vsz // 4), dense_d.shape[0])
            values = np.asarray(jax.device_get(dense_d[:kw])).view(
                np.uint8)[:vsz]
            if t:
                t.add_transfer_size(frames + vsz)
        return bits, values
    from .fields import fold
    bits_d, fields_d = out
    wpf = frame_length // 4
    with stage("Copy results to CPU", frames + frames * wpf * 4):
        bits = np.asarray(jax.device_get(bits_d))[:frames]
        fields_h = np.asarray(jax.device_get(fields_d))[: frames * wpf]
    with stage("Host fold (ragged placement)", n):
        return bits, fold(fields_h, bits, n, frame_length)


def encode_chunks(chunks, frame_length: int = FRAME_LENGTH,
                  bucket_frames: int = BUCKET_FRAMES, depth: int = 2):
    """Pipelined encode over an iterable of NumPy byte chunks (all but
    the last must be frame-aligned).  Yields ``(bits, values)`` pairs
    in order — one per chunk, except that chunks above the 1 GiB
    device cap are split internally (frame-aligned) and yield one pair
    per sub-chunk."""
    _check_frame_length(frame_length)
    cap = _device_cap(frame_length)

    def capped(it):
        for d in it:
            d = np.asarray(d, np.uint8)
            if d.size <= cap:
                yield d
            else:
                for off in range(0, d.size, cap):
                    yield d[off:off + cap]

    pending = deque()
    tail_seen = False
    for data in capped(chunks):
        # frame alignment is the correctness invariant (SURVEY finding
        # #3): a misaligned NON-final chunk would silently produce a
        # different container than the whole-buffer encode — reject it
        if tail_seen:
            raise ValueError(
                "encode_chunks: a non-frame-aligned chunk must be the "
                "last one")
        tail_seen = bool(data.size % frame_length)
        pending.append(_encode_submit(data, frame_length, bucket_frames))
        if len(pending) >= depth:
            yield _encode_drain(pending.popleft(), frame_length)
    while pending:
        yield _encode_drain(pending.popleft(), frame_length)


def _decode_submit(n: int, bits: np.ndarray, values: np.ndarray,
                   frame_length: int, bucket_frames: int):
    if n == 0:
        return ("ready", np.zeros(0, np.uint8))
    frames = -(-n // frame_length)
    if bits.size < frames:
        # incl. an EMPTY widths array with n > 0 — silently returning
        # empty output would truncate the stream.  Checked before any
        # size-n work: a corrupt header claiming a huge size is rejected
        # in O(1) (the reference trusts it, fl_cpu.cu:115-141).
        raise ValueError(
            "fl decode: corrupt container (bits array shorter than "
            f"frame count: {bits.size} < {frames})")
    c = host_constant_decode_probe(bits, values, n, frame_length)
    if c is not None:
        with stage("Decompression", n):
            return ("ready", np.full(n, c, np.uint8))
    out8 = host_identity_decode_probe(bits, values, n, frame_length)
    if out8 is not None:
        with stage("Decompression", n):
            return ("ready", out8)
    npad = pad_to_frames(n, frame_length, bucket_frames)
    bbuf = np.zeros(npad // frame_length, np.uint8)
    bbuf[:frames] = bits[:frames]
    h2d, krn = [], []
    if dense_route(frame_length):
        vsz = values_size(bits, n, frame_length)
        if values.size < vsz:
            raise ValueError(
                "fl decode: corrupt container (packed stream shorter than "
                f"the widths imply: {values.size} < {vsz})")
        kw = transfer_words(-(-vsz // 4), npad // 4)
        vbuf = np.zeros(kw * 4, np.uint8)
        vbuf[:vsz] = values[:vsz]
        with stage("Copy input to device", vsz + frames, result=h2d):
            dj, bj = jnp.asarray(vbuf.view(np.uint32)), jnp.asarray(bbuf)
            h2d += [dj, bj]
        with stage("Decompression", n, result=krn):
            out = fl_decode_dense(dj, bj, jnp.int32(n),
                                  frame_length=frame_length)
            krn.append(out)
        return ("dev", n, out)
    from .fields import unfold
    with stage("Host unfold (ragged placement)", n):
        fields_h = unfold(values, bits, n, frame_length)
    fbuf = np.zeros(npad // 4, np.uint32)
    fbuf[: fields_h.size] = fields_h
    with stage("Copy input to device", npad + frames, result=h2d):
        fj, bj = jnp.asarray(fbuf), jnp.asarray(bbuf)
        h2d += [fj, bj]
    with stage("Decompression", n, result=krn):
        out = fl_decode_fields(fj, bj, jnp.int32(n),
                               frame_length=frame_length)
        krn.append(out)
    return ("dev", n, out)


def _decode_drain(entry):
    if entry[0] == "ready":
        return entry[1]
    _, n, out = entry
    with stage("Copy results to CPU", n):
        return np.asarray(jax.device_get(out)).view(np.uint8)[:n]


def decode_chunks(parts, frame_length: int = FRAME_LENGTH,
                  bucket_frames: int = BUCKET_FRAMES, depth: int = 2):
    """Pipelined decode over an iterable of ``(output_size, bits,
    values)`` frame-aligned container chunks.  Yields decoded u8 arrays
    in order — one per chunk, except that chunks above the 1 GiB device
    cap are split internally (one output per sub-chunk)."""
    _check_frame_length(frame_length)
    cap = _device_cap(frame_length)

    def capped(it):
        # parts above the device cap split frame-aligned, with per-chunk
        # value offsets from the widths header
        fpc = cap // frame_length
        for n, bits, values in it:
            n = int(n)
            bits = np.asarray(bits, np.uint8)
            values = np.asarray(values, np.uint8)
            if n <= cap:
                yield (n, bits, values)
                continue
            frames = -(-n // frame_length)
            if bits.size < frames:
                raise ValueError(
                    "fl decode: corrupt container (bits array shorter "
                    f"than frame count: {bits.size} < {frames})")
            voffs = np.concatenate(
                [[0], np.cumsum(frame_value_bytes(bits, n, frame_length))])
            for off in range(0, n, cap):
                f0 = off // frame_length
                f1 = min(f0 + fpc, frames)
                yield (min(cap, n - off), bits[f0:f1],
                       values[voffs[f0]:voffs[f1]])

    pending = deque()
    for part in capped(parts):
        pending.append(_decode_submit(*part, frame_length, bucket_frames))
        if len(pending) >= depth:
            yield _decode_drain(pending.popleft())
    while pending:
        yield _decode_drain(pending.popleft())
