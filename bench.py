"""Benchmark driver — prints one JSON line with the device codec's rate.

Measures on the device JAX finds and names it in the output (platform,
``device_kind``, count).  FL: a seeded 4-bit stream (BASELINE.json's
256 MB low-entropy FL config), device-resident, jitted steps:

* **per-op** (headline): the dense encode (:func:`fl_jax.fl_encode_dense`)
  and decode (:func:`fl_jax.fl_decode_dense`) of ``--size-mb``; the round
  trip is checked on host.  ``value`` is the aggregate rate
  ``2·N / (t_enc + t_dec)``; ``vs_baseline`` is that pair's share of the
  device's memory roofline on its minimal traffic (null for a device not
  in :data:`PEAK_HBM_GBPS`);
* **sharded**: the same encode under ``shard_map`` on a 1-device mesh
  against the bare call (the cost of the distributed wrapper);
* **e2e** (``--full``): the host API (``fl_jax.encode``), serial versus the
  pipelined ``encode_chunks`` on the same data, H2D and D2H included.

``--method rl`` times the RL encode/decode pair instead.  Every time is a
host clock around work that ends in ``block_until_ready``; compilation is
warmed up first and not counted.

Usage: python bench.py [--size-mb 256] [--method fl|rl] [--full]
"""

import argparse
import json
import sys
import time

import numpy as np

# Peak device-memory bandwidth by ``device_kind`` (GB/s), for roofline
# shares.  Source: NVIDIA H200 data sheet (SXM, 4.8 TB/s HBM3e).  A device
# that is not listed gets no roofline share, never an assumed peak.
PEAK_HBM_GBPS = {"NVIDIA H200": 4800.0}


def roofline_share(moved_bytes: float, seconds: float,
                   device_kind: str):
    """Share of the device's memory roofline reached by moving
    ``moved_bytes`` in ``seconds``; None when the peak is unknown."""
    peak = PEAK_HBM_GBPS.get(device_kind)
    if peak is None or seconds <= 0:
        return None
    return moved_bytes / 1e9 / seconds / peak


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size-mb", type=int, default=256)
    ap.add_argument("--method", choices=["fl", "rl"], default="fl")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--full", action="store_true",
                    help="also run the host-API end-to-end arm")
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from fl_rl_compression_mpi_tpu.cli import _enable_compile_cache
    from fl_rl_compression_mpi_tpu.ops import fl_jax, rl_jax
    _enable_compile_cache()

    dev = jax.devices()[0]
    kind = dev.device_kind
    result = {"device": {"platform": dev.platform, "kind": kind,
                         "count": len(jax.devices())}}

    def timed(fn, reps):
        """(last output, median seconds) of ``fn()`` after one warm-up."""
        out = jax.block_until_ready(fn())
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return out, float(np.median(ts))

    n = args.size_mb << 20
    rng = np.random.default_rng(0)
    gb = n / 1e9

    if args.method == "rl":
        nruns = n // 32
        host = np.repeat(rng.integers(0, 256, nruns, np.uint8),
                         rng.integers(16, 112, nruns))[:n].copy()
        data = jax.device_put(jnp.asarray(host))
        nn = jnp.int32(n)
        enc, t_enc = timed(lambda: rl_jax.rl_encode(data, nn), args.reps)
        out, t_dec = timed(
            lambda: rl_jax.rl_decode(enc.counts, enc.values, enc.num_runs,
                                     nn, n), args.reps)
        comp_bytes = 2 * int(enc.num_runs)
        if not np.array_equal(np.asarray(jax.device_get(out))[:n], host):
            print(json.dumps({"metric": "rl_codec_throughput", "value": 0.0,
                              "unit": "GB/s", "error": "round-trip mismatch",
                              **result}))
            return 1
        agg = 2 * gb / (t_enc + t_dec)
        share = roofline_share(2 * (n + comp_bytes), t_enc + t_dec, kind)
        result.update({
            "metric": "rl_codec_throughput", "value": round(agg, 2),
            "unit": "GB/s",
            "vs_baseline": None if share is None else round(share, 4),
            "encode_gbps": round(gb / t_enc, 2),
            "decode_gbps": round(gb / t_dec, 2),
            "ratio": round(comp_bytes / n, 4)})
        print(json.dumps(result), flush=True)
        return 0

    # Low-entropy synthetic stream (BASELINE.json config): bytes < 16, so
    # every frame packs at 4 bits.
    host = rng.integers(0, 16, n, np.uint8)
    npad = fl_jax.pad_to_frames(n)
    buf = np.zeros(npad, np.uint8)
    buf[:n] = host
    frames = -(-n // 128)
    words = jax.device_put(jnp.asarray(buf.view(np.uint32)))
    nn = jnp.int32(n)

    log("per-op arm ...")
    (bits_d, dense_d, _), t_enc = timed(
        lambda: fl_jax.fl_encode_dense(words, nn), args.reps)
    bits_h = np.asarray(jax.device_get(bits_d))[:frames]
    vsz = fl_jax.values_size(bits_h, n)
    out_w, t_dec = timed(
        lambda: fl_jax.fl_decode_dense(dense_d, bits_d, nn), args.reps)
    ok = bool(np.array_equal(
        np.asarray(jax.device_get(out_w)).view(np.uint8)[:n], host))
    if not ok:
        print(json.dumps({"metric": "fl_kernel_throughput", "value": 0.0,
                          "unit": "GB/s", "error": "round-trip mismatch",
                          **result}))
        return 1
    agg = 2 * gb / (t_enc + t_dec)
    moved = 2 * (n + vsz + frames)   # each op reads one form, writes the other
    share = roofline_share(moved, t_enc + t_dec, kind)
    result.update({
        "metric": "fl_kernel_throughput", "unit": "GB/s",
        "value": round(agg, 2),
        "vs_baseline": None if share is None else round(share, 4),
        "encode_gbps": round(gb / t_enc, 2),
        "decode_gbps": round(gb / t_dec, 2),
        "ratio": round((frames + vsz) / n, 4)})

    log("sharded arm ...")
    from fl_rl_compression_mpi_tpu.parallel import dist
    mesh = dist.make_mesh(1)
    words2d = words.reshape(1, -1)
    ns1 = jnp.asarray([n], jnp.int32)
    _, t_bare = timed(lambda: fl_jax.fl_encode_dense(words, nn), args.reps)
    _, t_shd = timed(lambda: dist.fl_compress_sharded(mesh, words2d, ns1),
                     args.reps)
    result["sharded_enc_gbps"] = round(gb / t_shd, 2)
    result["sharded_eff"] = round(t_bare / t_shd, 3)

    if args.full:
        log("e2e arm ...")
        fl_jax.encode(host)                 # warm compiles + buffers
        t0 = time.perf_counter()
        bits_e, values_e = fl_jax.encode(host)
        result["e2e_serial_s"] = time.perf_counter() - t0
        ck = 32 << 20
        for _ in fl_jax.encode_chunks([host[:ck]]):
            pass                            # warm the chunk shape
        t0 = time.perf_counter()
        parts = list(fl_jax.encode_chunks(
            host[o:o + ck] for o in range(0, n, ck)))
        result["e2e_pipe_s"] = time.perf_counter() - t0
        result["e2e_pipe_ok"] = bool(
            np.array_equal(np.concatenate([p[0] for p in parts]), bits_e)
            and np.array_equal(np.concatenate([p[1] for p in parts]),
                               values_e))

    if not args.json_only:
        log(f"fl size={args.size_mb}MiB {result}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
