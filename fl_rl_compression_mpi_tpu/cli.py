"""Command-line interface (reference components #1-2).

Mirrors the reference CLI surface (``compress <operation> <method> <input>
<output>``, ``/root/reference/src/main.cu:18-33`` +
``src/args_parser.cu:8-76``) and extends it with the knobs the reference's
design doc promised but never implemented (runtime frame length,
``IMPLEMENTATION-PLAN.md:15``) plus the RL methods its README advertises but
its parser rejects (``README.md:25-26`` vs ``args_parser.cu:30-53``).

Methods:

===========  ===============================================================
``fl``       FL on one GPU (reference ``fl`` GPU path)
``fl-cpu``   FL on host via the native codec (reference ``fl-cpu``)
``fl-dist``  FL over all devices, rank-ordered host merge (``fl-mpi``
             analog)
``fl-nccl``  FL over all devices, on-device all-gather merge (reference
             ``fl-nccl``; XLA hands the collective to NCCL)
``rl``       RL on one GPU (spec-only in the reference)
``rl-cpu``   RL on host via the native codec
``rl-dist``  RL over all devices (per-shard runs, boundary runs split)
===========  ===============================================================

``fl-mpi`` and ``fl-ici`` are accepted as aliases of ``fl-dist`` and
``fl-nccl``.  ``fl-shmem`` (an enum value with no implementation in the
reference, silently degrading to CPU there — ``main.cu:90-92``) maps to
``fl-dist`` with a notice instead of silently changing backends.

Unlike the reference, decompression is available distributed for every
method (the reference decompresses ``fl`` on one GPU and everything else on
one CPU thread, ``main.cu:131-169``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import container
from .models.registry import ALIASES as _ALIASES
from .ops.bitpack import FRAME_LENGTH
from .utils.timers import timed

_METHODS = ("fl", "fl-cpu", "fl-dist", "fl-nccl", "rl", "rl-cpu", "rl-dist",
            "fl-mpi", "fl-ici", "fl-shmem")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fl_rl_compression_mpi_tpu",
        description="FL/RL lossless compression on GPUs (JAX)",
        epilog="example: python -m fl_rl_compression_mpi_tpu c fl in.bin "
               "out.fl")
    p.add_argument("operation", choices=("c", "d"),
                   help="c = compress, d = decompress")
    p.add_argument("method", choices=_METHODS)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--frame-length", type=int, default=FRAME_LENGTH,
                   help="FL frame length in bytes (default 128; must divide "
                        "by 8 for frame byte-alignment)")
    p.add_argument("--timers", action="store_true",
                   help="print [TIMER] phase lines like the reference")
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="capture a jax.profiler trace of the codec phase")
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices for distributed methods "
                        "(default: all)")
    p.add_argument("--stream-chunk-mb", type=int, default=None,
                   metavar="MB",
                   help="FL only: stream the file in frame-aligned chunks "
                        "of this size (bounded memory for any file size; "
                        "byte-identical output — the reference loads whole "
                        "files)")
    p.add_argument("--verify", action="store_true",
                   help="after compressing, decompress the output and "
                        "byte-compare against the input (round-trip "
                        "self-check)")
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="multi-host mode: jax.distributed coordinator "
                        "address (the reference's mpirun analog; pair "
                        "with --num-processes/--process-id)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def _run_multihost(args) -> int:
    """Multi-host driver: every process runs this same CLI (one per host,
    like one MPI rank per node); process 0 writes the output.  Uses the
    rank-ordered streaming merge (bounded memory) — see
    parallel/multihost.py."""
    import jax

    from .parallel import multihost
    from .utils.timers import set_stage_timers
    multihost.init_distributed(args.coordinator, args.num_processes,
                               args.process_id)
    # rank-tagged per-stage [TIMER] lines (reference: file_io.cu:64,
    # cpu_timer.cu:19-27 — whose rank-tagged print never fired)
    set_stage_timers(args.timers, rank=jax.process_index())
    if args.timers:
        print(f"[INFO] backend={jax.default_backend()} "
              f"devices={jax.device_count()} "
              f"process={jax.process_index()}/{jax.process_count()}",
              file=sys.stderr)
    method = _resolve(args.method)
    family = "rl" if method.startswith("rl") else "fl"
    if args.operation == "c":
        if family == "fl":
            multihost.compress_fl_file(args.input, args.output,
                                       args.frame_length)
        else:
            multihost.compress_rl_file(args.input, args.output)
        if args.verify:
            with timed("verification", enabled=args.timers):
                if not multihost.verify_file_roundtrip(
                        args.input, args.output, family,
                        args.frame_length):
                    print("[ERROR] verification failed: round-trip "
                          "mismatch", file=sys.stderr)
                    return 1
            print("[INFO] verification OK", file=sys.stderr)
    else:
        if family == "fl":
            multihost.decompress_fl_file(args.input, args.output,
                                         args.frame_length)
        else:
            multihost.decompress_rl_file(args.input, args.output)
    return 0


def _resolve(method: str) -> str:
    if method == "fl-shmem":
        print("[INFO] fl-shmem: no SHMEM path; using fl-dist "
              "(the reference silently degraded this to CPU)",
              file=sys.stderr)
        return "fl-dist"
    return _ALIASES.get(method, method)


def _compress(args, data: np.ndarray) -> None:
    from .models.registry import resolve
    codec = resolve(_resolve(args.method))
    from .utils.timers import profiler_trace
    with timed("compression", nbytes=data.size, enabled=args.timers), \
            profiler_trace(args.profile):
        comp = codec.compress(data, frame_length=args.frame_length,
                              devices=args.devices)
    with timed("saving output", enabled=args.timers):
        if codec.family == "fl":
            container.save_fl(args.output, comp)
            payload = comp.bits.size + comp.values.size
        else:
            container.save_rl(args.output, comp)
            payload = comp.counts.size + comp.values.size
    if args.timers:
        n_in = int(comp.input_size)
        ratio = (payload + 24) / n_in if n_in else 0.0
        print(f"[INFO] compressed {n_in} -> {payload + 24} bytes "
              f"(ratio {ratio:.4f})", file=sys.stderr)


def _decompress(args) -> None:
    from .models.registry import resolve
    codec = resolve(_resolve(args.method))
    with timed("loading compressed input", enabled=args.timers):
        comp = (container.load_rl(args.input) if codec.family == "rl"
                else container.load_fl(args.input))
    from .utils.timers import profiler_trace
    with timed("decompression", nbytes=int(comp.input_size),
               enabled=args.timers), profiler_trace(args.profile):
        out = codec.decompress(comp, frame_length=args.frame_length,
                               devices=args.devices)
    with timed("saving output", nbytes=out.size, enabled=args.timers):
        from .fileio import save_file
        save_file(args.output, out)


_CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache: CLI invocations are one process per
    run (like the reference binary), so without it every run pays the full
    compile.  ``JAX_COMPILATION_CACHE_DIR`` names the directory when set
    (an empty value disables the cache); otherwise a fixed ``.jax_cache/``
    at the checkout root (a fixed path, since the path is part of the
    cache key)."""
    import jax
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if cache is None:
        cache = os.path.join(_CHECKOUT_ROOT, ".jax_cache")
    if cache:
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _enable_compile_cache()
    # per-stage [TIMER] lines inside the codec drivers (H2D, kernel,
    # D2H, host fold/unfold) — observability parity with the
    # reference's per-phase timers (fl_gpu.cu:317-415, :573-637).
    # Set unconditionally: in-process callers (tests) run main() many
    # times and must not inherit a previous run's switch.
    from .utils.timers import set_stage_timers
    set_stage_timers(args.timers)
    if args.frame_length <= 0 or args.frame_length % 8:
        print("[ERROR] --frame-length must be a positive multiple of 8 "
              "(frame byte-alignment invariant)", file=sys.stderr)
        return 2
    if args.timers and args.coordinator is None:
        # device banner, like the reference's [INFO] rank/device prints
        # (main.cu:42,68) — but only when observability is requested, so
        # the default path never pays for backend initialization early.
        # Multihost runs print it inside _run_multihost instead: touching
        # the backend here would break jax.distributed.initialize.
        import jax
        print(f"[INFO] backend={jax.default_backend()} "
              f"devices={jax.device_count()}", file=sys.stderr)
    try:
        if args.coordinator is not None:
            return _run_multihost(args)
        if args.stream_chunk_mb is not None:
            if not _resolve(args.method).startswith("fl"):
                print("[ERROR] --stream-chunk-mb supports FL methods only",
                      file=sys.stderr)
                return 2
            from . import stream
            with timed("streaming " + ("compression" if args.operation == "c"
                                       else "decompression"),
                       enabled=args.timers):
                if args.operation == "c":
                    stream.compress_fl_stream(
                        args.input, args.output, args.frame_length,
                        args.stream_chunk_mb)
                else:
                    stream.decompress_fl_stream(
                        args.input, args.output, args.frame_length,
                        args.stream_chunk_mb)
            if args.operation == "c" and args.verify:
                with timed("verification", enabled=args.timers):
                    if not stream.verify_fl_stream(
                            args.input, args.output, args.frame_length,
                            args.stream_chunk_mb):
                        print("[ERROR] verification failed: round-trip "
                              "mismatch", file=sys.stderr)
                        return 1
                print("[INFO] verification OK", file=sys.stderr)
            return 0
        if args.operation == "c":
            with timed("loading input", enabled=args.timers) as t:
                from .fileio import load_file
                data = load_file(args.input)
                t.add_transfer_size(data.size)
            _compress(args, data)
            if args.verify:
                with timed("verification", nbytes=data.size,
                           enabled=args.timers):
                    from .models.registry import resolve
                    codec = resolve(_resolve(args.method))
                    comp = (container.load_rl(args.output)
                            if codec.family == "rl"
                            else container.load_fl(args.output))
                    out = codec.decompress(
                        comp, frame_length=args.frame_length,
                        devices=args.devices)
                    if not np.array_equal(out, data):
                        print("[ERROR] verification failed: round-trip "
                              "mismatch", file=sys.stderr)
                        return 1
                print("[INFO] verification OK", file=sys.stderr)
        else:
            _decompress(args)
    except (OSError, ValueError) as e:
        # the reference catches and tags errors the same way (main.cu:95-99)
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
