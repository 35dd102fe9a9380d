"""Benchmark matrix driver — the `on_cluster.sh` analog.

The reference's only benchmark harness is a SLURM script running
``mpirun ./compress c {fl-nccl, fl-mpi}`` over {512, 2048, 3124} MB inputs
on 3 DGX nodes and eyeballing ``logs/*.log``
(``/root/reference/on_cluster.sh:18-34``).  This driver reproduces the same
matrix natively: synthetic inputs of the same sizes, codec methods from the
registry, all in one process (so one process holds the card), structured
JSONL results.  Times are host wall clocks around the host API calls (the
user's path, transfers included), after one warm-up call.

Usage:
    python scripts/bench_matrix.py [--sizes-mb 512 2048 3124]
        [--methods fl fl-cpu rl-cpu] [--out logs/bench_matrix.jsonl]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes-mb", type=int, nargs="+",
                    default=[512, 2048, 3124])
    ap.add_argument("--methods", nargs="+",
                    default=["fl", "fl-cpu", "fl-dist", "rl-cpu"])
    ap.add_argument("--out", default="logs/bench_matrix.jsonl")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--host-verify", action="store_true",
                    help="verify device-method round-trips with the native "
                         "HOST decoder instead of timing device decode "
                         "(bit-exactness is the same claim)")
    args = ap.parse_args()

    from fl_rl_compression_mpi_tpu.cli import _enable_compile_cache
    from fl_rl_compression_mpi_tpu.models.registry import resolve
    _enable_compile_cache()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    for size_mb in args.sizes_mb:
        n = size_mb * (1 << 20)
        rng = np.random.default_rng(size_mb)
        # family-appropriate synthetics (BASELINE.json configs): FL gets
        # low-entropy bytes (4-bit frames); RL gets long-run data (mean
        # run ~64 — random bytes are RL's degenerate worst case).
        fl_host = rng.integers(0, 16, n, np.uint8)
        nruns = n // 32
        rl_host = np.repeat(rng.integers(0, 256, nruns, np.uint8),
                            rng.integers(16, 112, nruns))[:n].copy()
        for method in args.methods:
            codec = resolve(method)
            host = rl_host if codec.family == "rl" else fl_host
            device_method = method not in ("fl-cpu", "rl-cpu")
            try:
                comp = codec.compress(host)       # warm (compile/caches)
                ts = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    comp = codec.compress(host)
                    ts.append(time.perf_counter() - t0)
                t_enc = float(np.median(ts))
                rec = {"method": method, "size_mb": size_mb,
                       "encode_gbps": round(n / 1e9 / t_enc, 2)}
                if args.host_verify and device_method:
                    from fl_rl_compression_mpi_tpu.native import get_native
                    nat = get_native()
                    if codec.family == "fl":
                        out = nat.fl_decode(n, comp.bits, comp.values)
                    else:
                        out = nat.rl_decode(comp.counts, comp.values)
                    rec["verify"] = "host-decode"
                else:
                    out = codec.decompress(comp)
                    ts = []
                    for _ in range(args.reps):
                        t0 = time.perf_counter()
                        out = codec.decompress(comp)
                        ts.append(time.perf_counter() - t0)
                    rec["decode_gbps"] = round(
                        n / 1e9 / float(np.median(ts)), 2)
                ok = bool(np.array_equal(out, host))
                if codec.family == "fl":
                    csize = comp.bits.size + comp.values.size + 24
                else:
                    csize = comp.counts.size + comp.values.size + 24
                rec.update(ratio=round(csize / n, 4), roundtrip_ok=ok)
            except (MemoryError, RuntimeError, ValueError) as e:
                rec = {"method": method, "size_mb": size_mb,
                       "error": str(e)[:200]}
            results.append(rec)
            print(json.dumps(rec), flush=True)
        del host
    with open(args.out, "a") as f:
        for rec in results:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
