"""Host-side parts of the GPU entry points, on CPU: the compile-cache
location, the multi-process launcher's per-process environment, the bench's
peak table, and ``chip_smoke.py`` refusing to report success without a
GPU."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from fl_rl_compression_mpi_tpu import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("env,want", [
    ("/some/cache", "/some/cache"),
    (None, os.path.join(REPO, ".jax_cache")),
    ("", None),
], ids=["env-set", "env-unset", "env-empty"])
def test_compile_cache_location(env, want, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set (empty disables the cache);
    otherwise the cache sits at a fixed .jax_cache/ in the checkout."""
    import jax
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    cli._enable_compile_cache()
    assert seen.get("jax_compilation_cache_dir") == want


@pytest.mark.parametrize("cpu", [False, True], ids=["gpu", "cpu"])
def test_launcher_process_environment(cpu):
    launcher = _load(os.path.join("scripts", "launch_multihost.py"),
                     "launch_multihost")
    base = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "JAX_PLATFORMS": "cpu", "HOME": "/h"}
    for rank in range(4):
        env = launcher.child_env(rank, cpu, base)
        assert env["PYTHONPATH"] == REPO and env["HOME"] == "/h"
        assert "XLA_FLAGS" not in env
        if cpu:
            assert env["JAX_PLATFORMS"] == "cpu"
            assert "CUDA_VISIBLE_DEVICES" not in env
        else:
            # one card per process, and no silent CPU fallback
            assert env["JAX_PLATFORMS"] == "cuda"
            assert env["CUDA_VISIBLE_DEVICES"] == str(rank)


@pytest.mark.parametrize("kind,want", [("NVIDIA H200", 0.5),
                                       ("cpu", None)])
def test_bench_peak_table(kind, want):
    """A known device gets a roofline share against its listed peak; an
    unknown one gets none, never an assumed peak."""
    bench = _load("bench.py", "bench_mod")
    share = bench.roofline_share(2.4e9, 1e-3, kind)
    assert share == pytest.approx(want) if want else share is None


def test_chip_smoke_fails_without_gpu(tmp_path):
    """On a machine without a GPU the smoke run exits non-zero and never
    prints its ok line."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    lines = p.stdout.strip().splitlines()
    assert lines, p.stderr
    with pytest.raises(ValueError):
        json.loads(lines[-1])
    assert '"ok": true' not in p.stdout
