"""Smoke run of the FL/RL codec on NVIDIA GPUs, byte-exact end to end.

Drives the system's main path through the entry points a user calls — the
library (``fl_jax``/``rl_jax``) and the ``python -m
fl_rl_compression_mpi_tpu`` CLI — at the upstream benchmark's file sizes
(``on_cluster.sh`` compresses 512, 2048 and 3124 MB; SURVEY.md §6), and
compares every container and every decoded byte exactly (tolerance 0, the
codec is lossless) with the repository's own references: the containers
written by the reference binary (``tests/golden/reference/``) and the
native host codec (``fl-cpu``, ``rl-cpu``).

One card (the default):

1. goldens — the 25 reference-written cases and the sample BMP encode and
   decode through the device library;
2. CLI — ``c``/``d`` with ``--timers --verify`` of seeded files: a 4-bit
   stream of 2 GiB (above the 1 GiB dispatch cap, so the chunked pipeline
   runs, and again with ``--stream-chunk-mb 256``), per-frame mixed widths
   (256 MiB), RL runs of 1..600 bytes (512 MiB) and a half-constant RL
   stream (256 MiB).  Each container must equal the native codec's.

``--four-cards`` runs only the multi-card path and what it is compared
with: ``fl-dist``, ``fl-nccl`` and ``rl-dist`` with ``--devices 4``, and
``scripts/launch_multihost.py -np 4`` with one card per process.

Every process that uses a card is a child run one at a time, so one JAX
process holds a card at a time; this process never touches a device.
Every child runs with ``JAX_PLATFORMS=cuda``, so JAX cannot fall back to
the CPU.  Printed times are smoke timings, not a benchmark.  The last line
of standard output is ``{"ok": true, "device": {...}}``; any failure exits
non-zero without it.

Usage: python chip_smoke.py [--four-cards]
"""

import argparse
import glob
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "fl_rl_compression_mpi_tpu"
GOLD = os.path.join(ROOT, "tests", "golden", "reference")
MIB = 1 << 20
# JAX_PLATFORMS of every child, and the backend name it must report.
PLATFORM = "cuda"
BACKEND = {"cuda": "gpu", "cpu": "cpu"}
SIZES = {"fl4": 2048 * MIB, "mixed": 256 * MIB, "rl_runs": 512 * MIB,
         "rl_half": 256 * MIB}
STREAM_CHUNK_MB = 256
SEED = 0
BMP_BYTES, BMP_FL_BYTES, BMP_RL_BYTES = 3_275_658, 3_166_346, 6_456_210
CHILD_TIMEOUT_S = 900


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card(s), as nvidia-smi reports them."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(p.stdout.split("\n")).strip(" |") or p.stderr.strip()


def child_env(**extra) -> dict:
    env = dict(os.environ, JAX_PLATFORMS=PLATFORM)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def run(args, **extra) -> tuple:
    """Run one child (in its own process group, killed whole on timeout);
    return ``(completed, seconds)`` or raise on a non-zero exit."""
    t0 = time.perf_counter()
    p = subprocess.Popen(args, cwd=ROOT, env=child_env(**extra),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise SmokeFailure(f"timed out: {' '.join(args)}")
    secs = time.perf_counter() - t0
    if p.returncode != 0:
        raise SmokeFailure(f"{' '.join(args)} exited {p.returncode}:\n"
                           f"{out[-3000:]}\n{err[-3000:]}")
    return subprocess.CompletedProcess(args, 0, out, err), secs


def cli(*args, **extra):
    return run([sys.executable, "-m", PKG, *map(str, args)], **extra)


def same_file(a: str, b: str) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


# ---------------------------------------------------------------------------
# Seeded inputs, written in bounded chunks.
# ---------------------------------------------------------------------------

def _runs(rng, n: int, max_run: int) -> np.ndarray:
    """Run-structured bytes: random values in runs of 1..max_run bytes."""
    k = n // ((max_run + 1) // 2) + 1024
    lens = rng.integers(1, max_run + 1, k)
    while lens.sum() < n:
        lens = np.concatenate([lens, rng.integers(1, max_run + 1, 1024)])
    return np.repeat(rng.integers(0, 256, lens.size, np.uint8), lens)[:n]


def write_input(kind: str, path: str, n: int) -> None:
    rng = np.random.default_rng(SEED)
    with open(path, "wb") as f:
        if kind == "fl4":                    # every frame at width 4
            for off in range(0, n, 256 * MIB):
                rng.integers(0, 16, min(256 * MIB, n - off),
                             np.uint8).tofile(f)
        elif kind == "mixed":                # per-frame widths 1..8
            d = rng.integers(0, 256, n, np.uint8).reshape(-1, 128)
            w = rng.integers(1, 9, d.shape[0])
            d &= ((1 << w) - 1).astype(np.uint8)[:, None]
            d[:, 0] |= (1 << (w - 1)).astype(np.uint8)
            d.tofile(f)
        elif kind == "rl_runs":
            _runs(rng, n, 600).tofile(f)
        elif kind == "rl_half":              # every other 4 MiB constant
            d = _runs(rng, n, 600)
            blk = 4 * MIB
            for off in range(0, n, 2 * blk):
                d[off:off + blk] = d[off]
            d.tofile(f)


# ---------------------------------------------------------------------------
# Children (run on the device).
# ---------------------------------------------------------------------------

def child_main(phase: str) -> int:
    import jax
    want = BACKEND.get(os.environ.get("JAX_PLATFORMS", ""), "gpu")
    if jax.default_backend() != want:
        print(f"backend {jax.default_backend()} is not {want}",
              file=sys.stderr)
        return 3
    from fl_rl_compression_mpi_tpu.native import get_native
    dev = jax.devices()[0]
    print("DEVICE " + json.dumps(
        {"platform": dev.platform, "kind": dev.device_kind,
         "count": len(jax.devices())}))
    print(f"jax {jax.__version__}; native host library loaded: "
          f"{get_native() is not None}")
    if phase == "goldens":
        goldens_phase()
    return 0


def goldens_phase() -> None:
    """Reference-written containers through the device library."""
    from fl_rl_compression_mpi_tpu import container
    from fl_rl_compression_mpi_tpu.native import get_native
    from fl_rl_compression_mpi_tpu.ops import fl_jax, fl_numpy, rl_jax

    def fl_bytes(bits, values, n):
        return (container._HEADER.pack(n, bits.size, values.size)
                + bits.tobytes() + values.tobytes())

    t0 = time.perf_counter()
    cases = sorted(glob.glob(os.path.join(GOLD, "case_*.bin")))
    check(len(cases) == 25, f"expected 25 golden cases, found {len(cases)}")
    for path in cases:
        data = np.fromfile(path, np.uint8)
        blob = open(path[:-4] + ".fl", "rb").read()
        check(fl_bytes(*fl_jax.encode(data), data.size) == blob,
              f"fl encode of {os.path.basename(path)} differs")
        comp = container.load_fl(path[:-4] + ".fl")
        check(np.array_equal(fl_jax.decode(comp.input_size, comp.bits,
                                           comp.values), data),
              f"fl decode of {os.path.basename(path)} differs")
    gold_bmp = os.path.join(GOLD, "sample_bmp.fl")
    comp = container.load_fl(gold_bmp)
    bmp = fl_jax.decode(comp.input_size, comp.bits, comp.values)
    check(bmp.size == BMP_BYTES, f"BMP decodes to {bmp.size} bytes")
    check(np.array_equal(bmp, fl_numpy.decode(comp.input_size, comp.bits,
                                              comp.values)),
          "BMP device decode differs from the NumPy golden")
    blob = fl_bytes(*fl_jax.encode(bmp), bmp.size)
    check(len(blob) == BMP_FL_BYTES and blob == open(gold_bmp, "rb").read(),
          f"BMP re-encode differs ({len(blob)} bytes)")
    counts, values = rl_jax.encode(bmp)
    check(24 + counts.size + values.size == BMP_RL_BYTES,
          f"BMP RL container is {24 + 2 * counts.size} bytes")
    nat = get_native()
    if nat is not None:
        c_n, v_n = nat.rl_encode(bmp)
        check(np.array_equal(c_n, counts) and np.array_equal(v_n, values),
              "BMP RL container differs from the native codec's")
    check(np.array_equal(rl_jax.decode(counts, values), bmp),
          "BMP RL round trip differs")
    print(f"goldens: 25 cases + BMP (FL {BMP_FL_BYTES} B, RL "
          f"{BMP_RL_BYTES} B) byte-exact in "
          f"{time.perf_counter() - t0:.2f} s")


def probe(phase: str) -> dict:
    p, secs = run([sys.executable, os.path.abspath(__file__),
                   "--child", phase])
    log(p.stdout.rstrip())
    log(f"[{phase} child: {secs:.2f} s wall]")
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("DEVICE ")]
    check(line, "device probe printed no DEVICE line")
    dev = json.loads(line[0][len("DEVICE "):])
    check(dev["platform"] == BACKEND[PLATFORM],
          f"device platform {dev['platform']}")
    return dev


# ---------------------------------------------------------------------------
# CLI phases (parent).
# ---------------------------------------------------------------------------

_D2H = re.compile(r"\[TIMER\] Copy results to CPU: .*, (\d+) B\)")


def report(what: str, nbytes: int, secs: float, proc) -> None:
    log(f"{what}: {secs:.3f} s wall, {nbytes / 1e9 / secs:.3f} GB/s "
        "(smoke timing)")
    for ln in proc.stdout.splitlines():
        if "[TIMER]" in ln:
            log("    " + ln)


def roundtrip(tmp: str, kind: str, method: str, extra=()) -> str:
    """c (--verify) / d / native-codec comparison of one seeded input;
    returns the input path (the container is left as ``<input>.c``)."""
    n = SIZES[kind]
    src = os.path.join(tmp, f"{kind}.bin")
    if not os.path.exists(src):
        write_input(kind, src, n)
    out, back, ref = src + ".c", src + ".back", src + ".ref"
    backend = f"backend={BACKEND[PLATFORM]}"
    p, secs = cli("c", method, src, out, "--timers", "--verify", *extra)
    check("verification OK" in p.stderr, f"{kind}: no verification OK")
    check(backend in p.stderr, f"{kind}: child did not report {backend}")
    report(f"{kind} ({n} B) c {method} --verify", n, secs, p)
    if method == "fl":
        # device→host bytes of the compression (before the verify pass)
        # must be the container payload, not the input size
        head = p.stdout.split("[TIMER] compression:")[0]
        d2h = sum(int(x) for x in _D2H.findall(head))
        payload = os.path.getsize(out) - 24
        log(f"    D2H during compression: {d2h} B; container payload "
            f"(frames + values): {payload} B; input: {n} B")
        check(d2h == payload, f"{kind}: D2H {d2h} B != payload {payload} B")
    p, secs = cli("d", method, out, back, "--timers", *extra)
    check(same_file(back, src), f"{kind}: d {method} output differs")
    report(f"{kind} d {method}", n, secs, p)
    os.unlink(back)
    fam = method.split("-")[0]
    p, secs = cli("c", f"{fam}-cpu", src, ref)
    check(same_file(out, ref),
          f"{kind}: {method} container differs from {fam}-cpu's")
    log(f"{kind}: {method} container == {fam}-cpu container "
        f"({os.path.getsize(out)} B; {fam}-cpu took {secs:.3f} s)")
    return src


def single_card(tmp: str) -> None:
    src = roundtrip(tmp, "fl4", "fl")
    out = src + ".stream"
    p, secs = cli("c", "fl", src, out, "--timers", "--verify",
                  "--stream-chunk-mb", STREAM_CHUNK_MB)
    check("verification OK" in p.stderr, "stream: no verification OK")
    check(same_file(out, src + ".ref"), "stream container differs")
    report(f"fl4 c fl --stream-chunk-mb {STREAM_CHUNK_MB} --verify",
           SIZES["fl4"], secs, p)
    for f in glob.glob(src + "*"):
        os.unlink(f)
    for kind, method in (("mixed", "fl"), ("rl_runs", "rl"),
                         ("rl_half", "rl")):
        src = roundtrip(tmp, kind, method)
        for f in glob.glob(src + "*"):
            os.unlink(f)


def four_cards(tmp: str, dev: dict) -> None:
    check(dev["count"] >= 4, f"--four-cards needs 4 devices, JAX sees "
          f"{dev['count']}")
    fl4 = os.path.join(tmp, "fl4.bin")
    write_input("fl4", fl4, SIZES["fl4"])
    single = fl4 + ".single"
    p, secs = cli("c", "fl", fl4, single, CUDA_VISIBLE_DEVICES="0")
    log(f"fl4 c fl on one card: {secs:.3f} s wall ({os.path.getsize(single)}"
        " B container)")
    for method in ("fl-dist", "fl-nccl"):
        out, back = fl4 + "." + method, fl4 + ".back"
        p, secs = cli("c", method, fl4, out, "--devices", 4, "--timers")
        check(f"backend={BACKEND[PLATFORM]} devices=" in p.stderr,
              f"{method}: no backend line")
        check(same_file(out, single),
              f"{method} container differs from the one-card container")
        report(f"fl4 c {method} --devices 4 (== one-card container)",
               SIZES["fl4"], secs, p)
        p, secs = cli("d", method, out, back, "--devices", 4, "--timers")
        check(same_file(back, fl4), f"d {method} output differs")
        report(f"fl4 d {method} --devices 4", SIZES["fl4"], secs, p)
        os.unlink(out)
        os.unlink(back)
    mh = fl4 + ".launcher"
    launcher = [sys.executable,
                os.path.join(ROOT, "scripts", "launch_multihost.py"),
                "-np", "4", *(["--cpu"] if PLATFORM == "cpu" else []),
                "c", "fl", fl4, mh]
    p, secs = run(launcher)
    check(same_file(mh, single),
          "launcher (4 processes) container differs from one-card's")
    log(f"fl4 launch_multihost -np 4 c fl: {secs:.3f} s wall "
        "(== one-card container)")
    for f in glob.glob(fl4 + "*"):
        os.unlink(f)

    rlf = os.path.join(tmp, "rl_runs.bin")
    n = SIZES["rl_runs"]
    write_input("rl_runs", rlf, n)
    out, back = rlf + ".c", rlf + ".back"
    p, secs = cli("c", "rl-dist", rlf, out, "--devices", 4, "--timers")
    check(open(out, "rb").read() == rl_dist_expected(rlf, 4),
          "rl-dist container differs from per-shard rl-cpu encodes")
    report("rl_runs c rl-dist --devices 4 (== per-shard rl-cpu)", n, secs,
           p)
    p, secs = cli("d", "rl-dist", out, back, "--devices", 4, "--timers")
    check(same_file(back, rlf), "d rl-dist output differs")
    report("rl_runs d rl-dist --devices 4", n, secs, p)


def rl_dist_expected(path: str, n_dev: int) -> bytes:
    """Concatenated native RL encodes of the shards ``dist.plan_shards``
    cuts (host only: nothing here initializes a JAX backend)."""
    from fl_rl_compression_mpi_tpu import container
    from fl_rl_compression_mpi_tpu.native import get_native
    from fl_rl_compression_mpi_tpu.ops import rl_numpy
    from fl_rl_compression_mpi_tpu.parallel.dist import plan_shards
    data = np.fromfile(path, np.uint8)
    nat = get_native()
    enc = nat.rl_encode if nat is not None else rl_numpy.encode
    counts, values, off = [], [], 0
    for ns in plan_shards(data.size, n_dev).ns:
        c, v = enc(data[off:off + int(ns)])
        counts.append(c)
        values.append(v)
        off += int(ns)
    c, v = np.concatenate(counts), np.concatenate(values)
    return (container._HEADER.pack(data.size, c.size, v.size)
            + c.tobytes() + v.tobytes())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card path (fl-dist, fl-nccl, "
                         "rl-dist, 4-process launcher) and its references")
    ap.add_argument("--child", choices=("probe", "goldens"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child_main(args.child)
    os.environ["JAX_PLATFORMS"] = PLATFORM
    log(f"card (nvidia-smi name, power.limit): {card_line()}")
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            if args.four_cards:
                dev = probe("probe")
                four_cards(tmp, dev)
            else:
                dev = probe("goldens")
                single_card(tmp)
    except (SmokeFailure, OSError) as e:
        log(f"FAILED after {time.perf_counter() - t0:.1f} s: {e}")
        return 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
