"""Multi-chip distributed compression tests on the virtual 8-device CPU mesh.

These exercise the real sharding logic — `shard_map` over a 1-D dp mesh,
the on-device all-gather merge, rank-ordered host assembly — without GPUs
(SURVEY.md §4(d): the reference's multi-node story was untestable).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fl_rl_compression_mpi_tpu.ops import fl_numpy, rl_numpy
from fl_rl_compression_mpi_tpu.parallel import dist


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() == 8, "conftest must provide 8 virtual devices"
    return dist.make_mesh()


def _mk(seed, size, hi=64):
    return np.random.default_rng(seed).integers(0, hi, size, np.uint8)


def test_plan_shards_reference_split_rule():
    # chunk = (S // (L*N)) * L, last shard takes remainder (file_io.cu:46-51)
    plan = dist.plan_shards(1_000_000, 8)
    assert plan.ns[:-1].tolist() == [(1_000_000 // (128 * 8)) * 128] * 7
    assert plan.ns.sum() == 1_000_000
    assert all(n % 128 == 0 for n in plan.ns[:-1])


def test_fl_distributed_equals_single(mesh):
    """Frame-aligned shard concat must be byte-identical to the single-chip
    encode (SURVEY.md finding #3)."""
    for size in (128 * 8 * 100, 999_999, 12_345):
        data = _mk(size, size)
        comp = dist.compress_fl(data, mesh, bucket_frames=64)
        bits_g, values_g = fl_numpy.encode(data)
        np.testing.assert_array_equal(comp.bits, bits_g)
        np.testing.assert_array_equal(comp.values, values_g)
        out = dist.decompress_fl(comp, mesh, bucket_frames=64)
        np.testing.assert_array_equal(out, data)


def test_fl_ici_merge_matches_host_merge(mesh):
    """The on-device all-gather (fl-nccl) path must produce the identical
    container payload as the host-side (MPI-analog) merge."""
    data = _mk(1, 128 * 8 * 64 + 777)
    comp_ici = dist.compress_fl_ici(data, mesh, bucket_frames=64)
    bits_g, values_g = fl_numpy.encode(data)
    np.testing.assert_array_equal(comp_ici.bits, bits_g)
    np.testing.assert_array_equal(comp_ici.values, values_g)


def test_rl_distributed_roundtrip(mesh):
    for size in (100_000, 12_345):
        for data in (_mk(2, size, 4),
                     np.repeat(_mk(3, size // 100 + 1, 8), 300)[:size],
                     np.zeros(size, np.uint8)):
            comp = dist.compress_rl(data, mesh, bucket_frames=64)
            out = dist.decompress_rl(comp, mesh, bucket=1024)
            np.testing.assert_array_equal(out, data)
            # boundary-split runs cost at most N-1 extra runs vs single-chip
            c_g, _ = rl_numpy.encode(data)
            assert comp.counts.size <= c_g.size + 7


def test_small_input_fewer_bytes_than_shards(mesh):
    """Inputs smaller than one frame per shard still round-trip."""
    for size in (1, 17, 128, 129, 1000):
        data = _mk(4, size, 256)
        comp = dist.compress_fl(data, mesh, bucket_frames=4)
        np.testing.assert_array_equal(
            dist.decompress_fl(comp, mesh, bucket_frames=4), data)
        rcomp = dist.compress_rl(data, mesh, bucket_frames=4)
        np.testing.assert_array_equal(
            dist.decompress_rl(rcomp, mesh, bucket=64), data)


def test_rl_distributed_deterministic_given_shard_plan(mesh):
    """Pins the documented RL distributed semantics (parallel/dist.py:
    rl_compress_sharded): the container is DETERMINISTIC given (data,
    shard plan) — byte-identical across repeated runs and equal to the
    per-shard golden concat — while `rl` vs `rl-dist` containers may
    legitimately differ when a run crosses a shard boundary (the run is
    split in two; decode is lossless either way)."""
    size = 128 * 8 * 40 + 515
    data = np.repeat(_mk(9, size // 50 + 1, 16), 100)[:size].copy()
    for n_dev in (2, 4, 8):
        sub = dist.make_mesh(n_dev)
        a = dist.compress_rl(data, sub, bucket_frames=64)
        b = dist.compress_rl(data, sub, bucket_frames=64)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.values, b.values)
        # semantic pin: equal to the per-shard single-chip golden concat
        plan = dist.plan_shards(size, n_dev, bucket_frames=64)
        cg, vg, off = [], [], 0
        for ns in plan.ns:
            c, v = rl_numpy.encode(data[off:off + int(ns)])
            cg.append(c)
            vg.append(v)
            off += int(ns)
        np.testing.assert_array_equal(a.counts, np.concatenate(cg))
        np.testing.assert_array_equal(a.values, np.concatenate(vg))
        np.testing.assert_array_equal(
            dist.decompress_rl(a, sub, bucket=1024), data)
    # the documented divergence: long runs straddle every shard boundary
    # here, so single-chip and distributed containers differ in SIZE —
    # yet both decode to the same bytes
    const = np.zeros(128 * 8 * 16, np.uint8)
    single_c, _ = rl_numpy.encode(const)
    d8 = dist.compress_rl(const, mesh, bucket_frames=16)
    assert d8.counts.size > single_c.size
    np.testing.assert_array_equal(
        dist.decompress_rl(d8, mesh, bucket=1024), const)


@pytest.mark.parametrize("total", [128 * 8 * 64, 128 * 8 * 64 + 777],
                         ids=["aligned", "ragged"])
@pytest.mark.parametrize("method", ["compress_fl", "compress_fl_ici"])
def test_dense_sharded_merge_matches_golden(mesh, method, total):
    """Both merges of the per-shard packed streams (host prefix pulls, and
    the on-device prefix all-gather) give the golden container, whether
    the shards end on a frame or the last one is ragged; the sharded dense
    decode restores the input."""
    rng = np.random.default_rng(total)
    data = rng.integers(0, 256, total).astype(np.uint8)
    frames = data[: total // 128 * 128].reshape(-1, 128)
    frames &= ((1 << rng.integers(1, 9, frames.shape[0])) - 1).astype(
        np.uint8)[:, None]
    comp = getattr(dist, method)(data, mesh, bucket_frames=64)
    bits_g, values_g = fl_numpy.encode(data)
    np.testing.assert_array_equal(comp.bits, bits_g)
    np.testing.assert_array_equal(comp.values, values_g)
    np.testing.assert_array_equal(
        dist.decompress_fl(comp, mesh, bucket_frames=64), data)
