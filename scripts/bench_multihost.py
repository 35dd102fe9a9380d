"""Multi-host (loopback) benchmark — wall time + peak RSS per process.

The reference's only multi-node evidence is eyeballed SLURM logs
(``/root/reference/on_cluster.sh``).  What one machine can validate at GB
scale is the multi-host *pipeline*: ``jax.distributed``
bootstrap, per-process sharded file reads, sizes-only exchange, the
bounded fixed-size streaming merge into host-0 pwrites, and distributed
decompression — including the bounded-memory claim (peak RSS per
process must track the streaming chunk, not the whole payload) and
byte-identical output across process counts.

Process ``i`` uses GPU ``i`` (``--cpu``: the CPU backend).  Writes one JSONL
row per (np, op).  Usage:
    python scripts/bench_multihost.py [--size-mb 1024] [--np-list 1 2 4]
        [--method fl] [--cpu] [--out logs/bench_multihost.jsonl]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from launch_multihost import child_env  # noqa: E402  (scripts/ sibling)

WRAP = r"""
import atexit, os, resource, runpy, sys
out = os.environ["FLRL_RSS_OUT"]

def _dump():
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with open(out, "w") as f:
        f.write(str(kb))

atexit.register(_dump)
sys.argv = ["fl_rl_compression_mpi_tpu"] + sys.argv[1:]
runpy.run_module("fl_rl_compression_mpi_tpu", run_name="__main__")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_cli(np_, cli_args, rssdir, tag, cpu):
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for i in range(np_):
        e = dict(child_env(i, cpu), FLRL_RSS_OUT=f"{rssdir}/{tag}_{i}.rss")
        # np=1 goes through the SAME multihost driver (coordinator with
        # one process) so rows are path-comparable — without this the
        # np=1 row measured the plain single-process codec and the
        # synth-codec mode never engaged there
        extra = ["--coordinator", f"localhost:{port}",
                 "--num-processes", str(np_), "--process-id", str(i)]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WRAP, *cli_args, *extra], env=e,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    rc = 0
    for p in procs:
        rc |= p.wait()
    wall = time.perf_counter() - t0
    rss = [int(open(f"{rssdir}/{tag}_{i}.rss").read()) // 1024
           for i in range(np_)]
    return rc, wall, rss


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size-mb", type=int, default=1024)
    ap.add_argument("--np-list", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--method", default="fl")
    ap.add_argument("--out", default="logs/bench_multihost.jsonl")
    ap.add_argument("--cpu", action="store_true",
                    help="run every process on the CPU backend")
    ap.add_argument("--shared-fs", action="store_true",
                    help="FLRL_SHARED_FS=1: direct parallel pwrites "
                         "(every process writes its own range — the "
                         "loopback machine IS one filesystem).  Without "
                         "it the streaming merge moves the whole decoded "
                         "file through allgather, a process-count-"
                         "independent cost that flatlines decompress.")
    ap.add_argument("--synth-codec", action="store_true",
                    help="FLRL_SYNTH_CODEC=1: width-8 identity codec — "
                         "near-zero codec cost, so the row measures the "
                         "streaming-merge + write path in isolation from "
                         "codec compute.  Decode uses the real w8 identity "
                         "fast path; round-trip stays byte-checked.")
    args = ap.parse_args()
    if args.shared_fs:
        os.environ["FLRL_SHARED_FS"] = "1"
    if args.synth_codec:
        os.environ["FLRL_SYNTH_CODEC"] = "1"

    import numpy as np
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n = args.size_mb << 20
    rows = []
    with tempfile.TemporaryDirectory() as td:
        src = f"{td}/in.bin"
        g = np.random.default_rng(0)
        if args.method.startswith("rl"):
            k = n // 32
            data = np.repeat(g.integers(0, 256, k, np.uint8),
                             g.integers(16, 112, k))[:n]
        else:
            data = g.integers(0, 16, n, np.uint8)
        data[:n].tofile(src)
        del data
        ref_bytes = None
        for np_ in args.np_list:
            comp = f"{td}/out_{np_}.c"
            rc, wall_c, rss_c = run_cli(
                np_, ["c", args.method, src, comp], td, f"c{np_}", args.cpu)
            assert rc == 0, f"compress rc={rc} np={np_}"
            if ref_bytes is None:
                ref_bytes = open(comp, "rb").read()
                same = True
            else:
                same = open(comp, "rb").read() == ref_bytes
            dec = f"{td}/dec_{np_}.bin"
            rc, wall_d, rss_d = run_cli(
                np_, ["d", args.method, comp, dec], td, f"d{np_}", args.cpu)
            assert rc == 0, f"decompress rc={rc} np={np_}"
            ok = (os.path.getsize(dec) == n
                  and subprocess.run(["cmp", "-s", src, dec]).returncode
                  == 0)
            row = {"np": np_, "method": args.method,
                   "shared_fs": bool(args.shared_fs),
                   "synth_codec": bool(args.synth_codec),
                   "size_mb": args.size_mb,
                   "compress_s": round(wall_c, 2),
                   "compress_gbps": round(n / 1e9 / wall_c, 3),
                   "decompress_s": round(wall_d, 2),
                   "decompress_gbps": round(n / 1e9 / wall_d, 3),
                   "maxrss_mb_compress": rss_c,
                   "maxrss_mb_decompress": rss_d,
                   "container_identical": bool(same),
                   "roundtrip_ok": bool(ok)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            os.unlink(dec)
    with open(args.out, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
