"""Multi-device distributed compression over a 1-D device mesh.

The reference distributes with one MPI rank + one GPU per file chunk and
gathers to rank 0 (MPI point-to-point, ``/root/reference/src/fl/fl_gpu.cu:
41-74``) or with a max-padded ``ncclAllGather`` + offset compaction
(``fl_gpu.cu:76-287``).  Here both are one SPMD program:

* a 1-D ``jax.sharding.Mesh`` over the devices, axis ``"dp"`` — data
  parallelism is the reference's only strategy (SURVEY.md §2) and the right
  one for an embarrassingly parallel codec; every card of a host reaches
  every other at the same rate, so the mesh follows the algorithm alone;
* the file is split into frame-aligned chunks with the reference's rule
  ``chunk = (S // (L·N)) · L``, last shard takes the remainder
  (``file_io.cu:46-51`` — reproduced in 64-bit math, not the reference's
  overflowing ``int``);
* ``jax.shard_map`` runs the single-device codec per shard: dense
  placement (`ops/fl_jax.py`) for frame lengths that are a multiple of 32,
  so each device holds its shard's exact packed stream;
* the merge is either **host-side** (pull each shard's widths and packed
  prefix and concatenate in rank order — the MPI-gather analog; lossless
  because shard boundaries are frame multiples, SURVEY.md finding #3) or
  **on-device**: gather the widths and per-shard totals, then
  ``jax.lax.all_gather`` each shard's packed prefix padded to the largest
  one — the reference's metadata allgather + max-padded ``ncclAllGather``
  (``fl_gpu.cu:101-194``), with XLA inserting the collectives.

Per-shard sizes travel implicitly: widths (`bits`) determine every offset,
so the reference's ``MPI_Allgather`` of {bitsSize, valuesSize, inputSize}
(``fl_gpu.cu:101-106``) reduces to gathering the small `bits` arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..container import FLCompressed, RLCompressed
from ..ops import fl_jax, rl_jax
from ..ops.bitpack import FRAME_LENGTH
from ..ops.fields import fold, unfold

AXIS = "dp"

# jitted shard_map programs, keyed by (mesh, static config) — rebuilding
# the wrapped function per call would retrace and recompile every time.
_JIT_CACHE: dict = {}


def _cached(key, build):
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = _JIT_CACHE[key] = build()
    return fn


def _shard_program(key, fn, mesh, in_specs, out_specs):
    return _cached(key, lambda: jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False)))


def make_mesh(num_devices: int | None = None) -> Mesh:
    """1-D mesh over the first ``num_devices`` (default: all) devices."""
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def make_local_mesh(num_devices: int | None = None) -> Mesh:
    """1-D mesh over this *process's* devices only.  In a multi-process
    runtime ``jax.devices()`` is global; per-process work (the multihost
    driver's local chunk encode, mirroring one MPI rank) must stay on
    addressable devices or host transfers of the results fail."""
    devs = jax.local_devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (AXIS,))


class ShardPlan(NamedTuple):
    """Host-side split of a ``total``-byte input into frame-aligned shards
    (the reference's ``loadFileMpi`` split, ``file_io.cu:46-51``)."""
    num_shards: int
    shard_npad: int          # static per-shard buffer (frame multiple)
    ns: np.ndarray           # i64[num_shards] true bytes per shard
    total: int


def plan_shards(total: int, num_shards: int,
                frame_length: int = FRAME_LENGTH,
                bucket_frames: int = fl_jax.BUCKET_FRAMES) -> ShardPlan:
    chunk = (total // (frame_length * num_shards)) * frame_length
    ns = np.full(num_shards, chunk, np.int64)
    ns[-1] = total - chunk * (num_shards - 1)
    npad = fl_jax.pad_to_frames(int(ns.max()), frame_length, bucket_frames)
    return ShardPlan(num_shards, npad, ns, total)


def shard_host_data(data: np.ndarray, plan: ShardPlan) -> np.ndarray:
    """Scatter host bytes into the padded ``(N, shard_npad)`` layout."""
    out = np.zeros((plan.num_shards, plan.shard_npad), np.uint8)
    off = 0
    for i, n in enumerate(plan.ns):
        out[i, :n] = data[off:off + n]
        off += int(n)
    return out


def _frames_of(plan: ShardPlan, i: int, frame_length: int) -> int:
    return (int(plan.ns[i]) + frame_length - 1) // frame_length


def _shard_rows(x: jax.Array) -> list:
    """The ``(1, K)`` per-device blocks of an ``(N, K)`` array sharded over
    ``dp``, in rank order, each still on its own device (slicing one then
    moves only that device's bytes)."""
    rows = {s.index[0].start or 0: s.data for s in x.addressable_shards}
    return [rows[i] for i in range(len(rows))]


# ---------------------------------------------------------------------------
# FL — sharded programs
# ---------------------------------------------------------------------------

def _fl_local_encode(frame_length):
    def f(words, n):
        bits, dense, total = fl_jax.fl_encode_dense(
            words[0], n[0], frame_length=frame_length)
        return bits[None], dense[None], total[None]
    return f


def fl_compress_sharded(mesh: Mesh, words2d: jax.Array, ns: jax.Array,
                        frame_length: int = FRAME_LENGTH):
    """Per-shard dense encode; outputs stay sharded over ``dp`` (the host
    later pulls each shard's packed prefix in rank order — the MPI-gather
    analog).  ``words2d``: u32[N_shards, shard_npad/4].  Returns ``(bits
    u8[N, Fp], dense u32[N, shard_npad/4], total_words i32[N])``."""
    fn = _shard_program(
        ("fl_enc", mesh, frame_length), _fl_local_encode(frame_length),
        mesh, (P(AXIS, None), P(AXIS)),
        (P(AXIS, None), P(AXIS, None), P(AXIS)))
    return fn(words2d, ns)


def _fl_merged_encode_meta(frame_length):
    def f(words, n):
        bits, dense, total = fl_jax.fl_encode_dense(
            words[0], n[0], frame_length=frame_length)
        # metadata all-gather only (the reference's MPI_Allgather of
        # sizes, fl_gpu.cu:101-106): widths are 1/L of the input and the
        # totals are scalars; the packed streams STAY sharded until the
        # host has sized the prefix gather below.
        return (jax.lax.all_gather(bits, AXIS), dense[None],
                jax.lax.all_gather(total, AXIS))
    return f


def fl_compress_merged(mesh: Mesh, words2d: jax.Array, ns: jax.Array,
                       frame_length: int = FRAME_LENGTH):
    """Two-step on-device merge — the reference's metadata allgather +
    max-padded payload allgather (``fl_gpu.cu:101-194``): step 1 gathers
    the widths and per-shard totals; step 2 all-gathers only each shard's
    packed PREFIX, padded to the largest shard's (bucketed) total.
    Collective traffic is O(largest compressed shard · N_dev), not
    O(input).  Returns replicated ``(bits u8[N, Fp], prefixes u32[N, K],
    totals i32[N])``."""
    fn = _shard_program(
        ("fl_merged_meta", mesh, frame_length),
        _fl_merged_encode_meta(frame_length), mesh,
        (P(AXIS, None), P(AXIS)), (P(), P(AXIS, None), P()))
    bits_g, dense_sh, totals_g = fn(words2d, ns)
    totals = np.asarray(jax.device_get(totals_g))
    nw = dense_sh.shape[1]
    kw = fl_jax.transfer_words(int(totals.max()), nw)
    gather = _shard_program(
        ("fl_gather_prefix", mesh, nw, kw),
        lambda d: jax.lax.all_gather(d[0, :kw], AXIS), mesh,
        (P(AXIS, None),), P())
    return bits_g, gather(dense_sh), totals_g


def _fl_local_decode(frame_length):
    def f(dense, bits, n):
        return fl_jax.fl_decode_dense(dense[0], bits[0], n[0],
                                      frame_length=frame_length)[None]
    return f


def fl_decompress_sharded(mesh: Mesh, dense2d: jax.Array, bits2d: jax.Array,
                          ns: jax.Array, frame_length: int = FRAME_LENGTH):
    """Per-shard dense decode — each device unpacks its own shard's packed
    stream (``dense2d`` u32[N, K], any K) into u32[N, Fp·L/4].  The
    reference has no distributed decompression at all (``main.cu:131-169``
    falls back to single-process CPU)."""
    fn = _shard_program(
        ("fl_dec", mesh, frame_length), _fl_local_decode(frame_length),
        mesh, (P(AXIS, None), P(AXIS, None), P(AXIS)), P(AXIS, None))
    return fn(dense2d, bits2d, ns)


def _fl_local_encode_fields(frame_length):
    def f(words, n):
        bits, fields = fl_jax.fl_encode_fields(
            words[0], n[0], frame_length=frame_length)
        return bits[None], fields[None]
    return f


def _fl_local_decode_fields(frame_length):
    def f(fields, bits, n):
        return fl_jax.fl_decode_fields(fields[0], bits[0], n[0],
                                       frame_length=frame_length)[None]
    return f


# ---------------------------------------------------------------------------
# RL
# ---------------------------------------------------------------------------

def _rl_local_encode(block, n):
    enc = rl_jax.rl_encode(block[0], n[0])
    return enc.counts[None], enc.values[None], enc.num_runs[None]


def rl_compress_sharded(mesh: Mesh, data2d: jax.Array, ns: jax.Array):
    """Per-shard RL encode.  Runs crossing a shard boundary are split into
    two runs — decode is still lossless; the container is deterministic
    given (data, shard plan).  The reference defines no distributed RL at
    all (RL exists only as a spec), so per-shard-concat is our canonical
    distributed semantics."""
    fn = _shard_program(
        ("rl_enc", mesh), _rl_local_encode, mesh,
        (P(AXIS, None), P(AXIS)), (P(AXIS, None), P(AXIS, None), P(AXIS)))
    return fn(data2d, ns)


def _rl_local_decode(out_pad):
    def f(counts, values, nr, n):
        return rl_jax.rl_decode(counts[0], values[0], nr[0], n[0],
                                out_pad)[None]
    return f


def rl_decompress_sharded(mesh: Mesh, counts2d, values2d, nrs, ns,
                          out_pad: int):
    fn = _shard_program(
        ("rl_dec", mesh, out_pad), _rl_local_decode(out_pad), mesh,
        (P(AXIS, None), P(AXIS, None), P(AXIS), P(AXIS)), P(AXIS, None))
    return fn(counts2d, values2d, nrs, ns)


# ---------------------------------------------------------------------------
# Host-facing whole-file API (single host, N local devices).
# ---------------------------------------------------------------------------

def _superchunks(total: int, n_dev: int, frame_length: int):
    """Outer frame-aligned chunking when per-shard sizes would exceed the
    int32 device cap (the reference instead overflows and corrupts,
    file_io.cu:46-51).  Returns the chunk step, or None if one pass fits."""
    step = n_dev * fl_jax._device_cap(frame_length)
    return step if total > step else None


def _fl_prologue(data, mesh, frame_length, bucket_frames, compress):
    """Shared head of the FL compress paths: the closed-form constant
    container, the superchunk split, or ``None`` to go on."""
    n_dev = mesh.devices.size
    fl_jax._check_frame_length(frame_length)
    # Whole-stream CONSTANT closed form: the host verifies (chunked
    # early-exit probe) and synthesizes the container with no device
    # round trip — the merge of N constant shards IS the constant
    # container.
    c = fl_jax._host_constant_byte(data)
    if c is not None:
        return FLCompressed(*fl_jax._constant_container(
            c, data.size, frame_length), data.size)
    step = _superchunks(data.size, n_dev, frame_length)
    if step:
        parts = [compress(data[o:o + step], mesh, frame_length,
                          bucket_frames)
                 for o in range(0, data.size, step)]
        return parts[0].merge(*parts[1:])
    return None


def _merge_prefixes(plan, frame_length, bits_rows, prefix_rows):
    """Rank-ordered container payload from per-shard widths and packed
    prefixes (any array-likes whose leading words cover the prefix)."""
    bits_parts, values_parts = [], []
    for i in range(plan.num_shards):
        bi = np.asarray(bits_rows[i])[: _frames_of(plan, i, frame_length)]
        vsz = fl_jax.values_size(bi, int(plan.ns[i]), frame_length)
        kw = fl_jax.transfer_words(-(-vsz // 4), prefix_rows[i].shape[-1])
        vw = np.asarray(jax.device_get(prefix_rows[i][..., :kw])).reshape(-1)
        bits_parts.append(bi)
        values_parts.append(vw.view(np.uint8)[:vsz])
    return FLCompressed(bits=np.concatenate(bits_parts),
                        values=np.concatenate(values_parts),
                        input_size=plan.total)


def compress_fl(data: np.ndarray, mesh: Mesh | None = None,
                frame_length: int = FRAME_LENGTH,
                bucket_frames: int = fl_jax.BUCKET_FRAMES) -> FLCompressed:
    """Sharded FL encode with the rank-ordered host merge (``fl-dist``)."""
    data = np.asarray(data, np.uint8)
    if data.size == 0:
        return FLCompressed(np.zeros(0, np.uint8), np.zeros(0, np.uint8), 0)
    mesh = mesh or make_mesh()
    done = _fl_prologue(data, mesh, frame_length, bucket_frames,
                        compress_fl)
    if done is not None:
        return done
    n_dev = mesh.devices.size
    plan = plan_shards(data.size, n_dev, frame_length, bucket_frames)
    words2d = jnp.asarray(shard_host_data(data, plan).view(np.uint32))
    ns = jnp.asarray(plan.ns, jnp.int32)
    if fl_jax.dense_route(frame_length):
        bits_d, dense_d, _ = fl_compress_sharded(mesh, words2d, ns,
                                                 frame_length)
        return _merge_prefixes(plan, frame_length,
                               np.asarray(jax.device_get(bits_d)),
                               _shard_rows(dense_d))
    # Field route: per-shard fields, one host fold over the rank-ordered
    # concatenation (shard boundaries are frame-aligned).
    fn = _shard_program(
        ("fl_enc_fields", mesh, frame_length),
        _fl_local_encode_fields(frame_length), mesh,
        (P(AXIS, None), P(AXIS)), (P(AXIS, None), P(AXIS, None)))
    bits, fields = jax.device_get(fn(words2d, ns))
    wpf = frame_length // 4
    nfs = [_frames_of(plan, i, frame_length) for i in range(n_dev)]
    bits_all = np.concatenate([bits[i, : nfs[i]] for i in range(n_dev)])
    fields_all = np.concatenate(
        [fields[i, : nfs[i] * wpf] for i in range(n_dev)])
    return FLCompressed(
        bits=bits_all,
        values=fold(fields_all, bits_all, data.size, frame_length),
        input_size=data.size)


def compress_fl_ici(data: np.ndarray, mesh: Mesh | None = None,
                    frame_length: int = FRAME_LENGTH,
                    bucket_frames: int = fl_jax.BUCKET_FRAMES) -> FLCompressed:
    """Like :func:`compress_fl` but the payload gather happens on device
    (all-gather of the packed prefixes, replicated result — the NCCL-path
    analog); the host pulls one replicated array instead of N shard
    slices.  Frame lengths off the dense route take the host merge."""
    data = np.asarray(data, np.uint8)
    if data.size == 0:
        return FLCompressed(np.zeros(0, np.uint8), np.zeros(0, np.uint8), 0)
    if not fl_jax.dense_route(frame_length):
        return compress_fl(data, mesh, frame_length, bucket_frames)
    mesh = mesh or make_mesh()
    done = _fl_prologue(data, mesh, frame_length, bucket_frames,
                        compress_fl_ici)
    if done is not None:
        return done
    plan = plan_shards(data.size, mesh.devices.size, frame_length,
                       bucket_frames)
    bits_g, prefixes_g, _ = fl_compress_merged(
        mesh, jnp.asarray(shard_host_data(data, plan).view(np.uint32)),
        jnp.asarray(plan.ns, jnp.int32), frame_length)
    return _merge_prefixes(plan, frame_length,
                           np.asarray(jax.device_get(bits_g)),
                           np.asarray(jax.device_get(prefixes_g)))


def decompress_fl(comp: FLCompressed, mesh: Mesh | None = None,
                  frame_length: int = FRAME_LENGTH,
                  bucket_frames: int = fl_jax.BUCKET_FRAMES) -> np.ndarray:
    n = int(comp.input_size)
    if n == 0 or comp.bits.size == 0:
        return np.zeros(0, np.uint8)
    fl_jax._check_frame_length(frame_length)
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    frames = -(-n // frame_length)
    if comp.bits.size < frames:
        raise ValueError(
            "fl decode: corrupt container (bits array shorter than "
            f"frame count: {comp.bits.size} < {frames})")
    # CONSTANT closed form: exact host verify of the container against
    # the repeating frame pattern → one memset, no device work.
    c = fl_jax.host_constant_decode_probe(comp.bits, comp.values, n,
                                          frame_length)
    if c is not None:
        return np.full(n, c, np.uint8)
    # width-8 identity: all-8 widths ⇒ payload == output.
    out8 = fl_jax.host_identity_decode_probe(comp.bits, comp.values, n,
                                             frame_length)
    if out8 is not None:
        return out8
    voffs = np.concatenate(
        [[0], np.cumsum(fl_jax.frame_value_bytes(comp.bits, n,
                                                 frame_length))])
    if voffs[-1] > comp.values.size:
        raise ValueError(
            "fl decode: corrupt container (packed stream shorter than "
            f"the widths imply: {comp.values.size} < {voffs[-1]})")
    step = _superchunks(n, n_dev, frame_length)
    if step:
        fpc = step // frame_length
        parts = []
        for off in range(0, n, step):
            f0 = off // frame_length
            f1 = min(f0 + fpc, frames)
            sub = FLCompressed(comp.bits[f0:f1],
                               comp.values[voffs[f0]:voffs[f1]],
                               min(step, n - off))
            parts.append(decompress_fl(sub, mesh, frame_length,
                                       bucket_frames))
        return np.concatenate(parts)
    plan = plan_shards(n, n_dev, frame_length, bucket_frames)
    fpad = plan.shard_npad // frame_length
    bits2d = np.zeros((n_dev, fpad), np.uint8)
    f0s = np.concatenate(
        [[0], np.cumsum([_frames_of(plan, i, frame_length)
                         for i in range(n_dev)])])
    for i in range(n_dev):
        bits2d[i, : f0s[i + 1] - f0s[i]] = comp.bits[f0s[i]:f0s[i + 1]]
    ns = jnp.asarray(plan.ns, jnp.int32)
    if fl_jax.dense_route(frame_length):
        # each device unpacks its own shard's packed stream; only the
        # compressed bytes go up
        vsz = [int(voffs[f0s[i + 1]] - voffs[f0s[i]]) for i in range(n_dev)]
        kw = fl_jax.transfer_words(-(-max(vsz) // 4), plan.shard_npad // 4)
        vals2d = np.zeros((n_dev, kw * 4), np.uint8)
        for i in range(n_dev):
            vals2d[i, : vsz[i]] = comp.values[voffs[f0s[i]]:
                                              voffs[f0s[i + 1]]]
        out = fl_decompress_sharded(mesh, jnp.asarray(vals2d.view(np.uint32)),
                                    jnp.asarray(bits2d), ns, frame_length)
    else:
        # field route: host unfold, then sharded device decode
        wpf = frame_length // 4
        fields_all = unfold(comp.values, comp.bits, n, frame_length)
        fields2d = np.zeros((n_dev, fpad * wpf), np.uint32)
        for i in range(n_dev):
            fields2d[i, : (f0s[i + 1] - f0s[i]) * wpf] = fields_all[
                f0s[i] * wpf: f0s[i + 1] * wpf]
        fn = _shard_program(
            ("fl_dec_fields", mesh, frame_length),
            _fl_local_decode_fields(frame_length), mesh,
            (P(AXIS, None), P(AXIS, None), P(AXIS)), P(AXIS, None))
        out = fn(jnp.asarray(fields2d), jnp.asarray(bits2d), ns)
    out_bytes = np.asarray(jax.device_get(out)).view(np.uint8).reshape(
        n_dev, -1)
    return np.concatenate(
        [out_bytes[i, : plan.ns[i]] for i in range(n_dev)])


def compress_rl(data: np.ndarray, mesh: Mesh | None = None,
                bucket_frames: int = fl_jax.BUCKET_FRAMES) -> RLCompressed:
    data = np.asarray(data, np.uint8)
    if data.size == 0:
        return RLCompressed(np.zeros(0, np.uint8), np.zeros(0, np.uint8), 0)
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    plan = plan_shards(data.size, n_dev, FRAME_LENGTH, bucket_frames)
    data2d = shard_host_data(data, plan)
    counts, values, nr = jax.device_get(rl_compress_sharded(
        mesh, jnp.asarray(data2d), jnp.asarray(plan.ns, jnp.int32)))
    return RLCompressed(
        counts=np.concatenate([counts[i, : nr[i]] for i in range(n_dev)]),
        values=np.concatenate([values[i, : nr[i]] for i in range(n_dev)]),
        input_size=data.size)


def decompress_rl(comp: RLCompressed, mesh: Mesh | None = None,
                  bucket: int = 1 << 16) -> np.ndarray:
    """Distributed RL decode.  Run boundaries are data-dependent (not
    shard-aligned), so the *run list* is split evenly across shards; the
    host computes each shard's decoded byte range with one cumsum and each
    shard decodes its runs independently."""
    r_total = int(comp.counts.size)
    if r_total == 0:
        return np.zeros(0, np.uint8)
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    per = -(-r_total // n_dev)
    rpad = max(bucket, -(-per // bucket) * bucket)
    counts2d = np.zeros((n_dev, rpad), np.uint8)
    values2d = np.zeros((n_dev, rpad), np.uint8)
    nrs = np.zeros(n_dev, np.int32)
    ns = np.zeros(n_dev, np.int64)
    for i in range(n_dev):
        lo, hi = i * per, min((i + 1) * per, r_total)
        if hi > lo:
            counts2d[i, : hi - lo] = comp.counts[lo:hi]
            values2d[i, : hi - lo] = comp.values[lo:hi]
            nrs[i] = hi - lo
            ns[i] = int(comp.counts[lo:hi].astype(np.int64).sum())
    out_pad = max(bucket, -(-int(ns.max()) // bucket) * bucket)
    out = jax.device_get(rl_decompress_sharded(
        mesh, jnp.asarray(counts2d), jnp.asarray(values2d),
        jnp.asarray(nrs), jnp.asarray(ns, jnp.int32), out_pad))
    return np.concatenate([out[i, : ns[i]] for i in range(n_dev)])
