"""Local multi-process launcher — the single-machine ``mpirun`` analog.

The reference launches with ``mpirun -np N ./compress ...``
(``/root/reference/on_cluster.sh:18-34``).  Here multi-process runs use
``jax.distributed``; this helper spawns N such processes on ONE machine so
the full multi-host code path — bootstrap, sharded file reads, sizes-only
exchange, rank-ordered streaming merge — runs without a cluster.  Process
``i`` sees only GPU ``i`` (``CUDA_VISIBLE_DEVICES``); ``--cpu`` runs every
process on the CPU backend instead.

Usage:
    python scripts/launch_multihost.py -np 4 c fl <in> <out>
    python scripts/launch_multihost.py --cpu -np 2 c fl <in> <out>
(extra CLI args pass through, e.g. --frame-length)
"""

import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def child_env(rank: int, cpu: bool, base=None) -> dict:
    """Environment of process ``rank``: the repo on the path and, on GPUs,
    exactly one visible card (``rank``) with no fallback to the CPU."""
    env = dict(os.environ if base is None else base, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env["JAX_PLATFORMS"] = "cuda"
        env["CUDA_VISIBLE_DEVICES"] = str(rank)
    return env


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-np", type=int, default=2, help="number of processes")
    ap.add_argument("--cpu", action="store_true",
                    help="run every process on the CPU backend")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="CLI args: <c|d> <method> <in> <out> [...]")
    args = ap.parse_args()
    if not args.rest:
        ap.error("missing CLI args")

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fl_rl_compression_mpi_tpu", *args.rest,
         "--coordinator", f"localhost:{port}",
         "--num-processes", str(args.np), "--process-id", str(i)],
        env=child_env(i, args.cpu)) for i in range(args.np)]
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
