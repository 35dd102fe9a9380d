"""Extended randomized differential fuzzing across every backend pair.

Heavier than the fuzz battery in conftest: random sizes, distributions and
frame lengths, all compared against the NumPy golden (which the
reference-semantics tests pin).
"""

import numpy as np
import pytest

from fl_rl_compression_mpi_tpu.native import get_native
from fl_rl_compression_mpi_tpu.ops import fl_jax, fl_numpy, rl_jax, rl_numpy

# Heavy randomized suite: slow tier (see conftest).
pytestmark = pytest.mark.slow


def _random_case(g):
    kind = g.integers(0, 5)
    size = int(g.integers(1, 200_000))
    if kind == 0:
        return g.integers(0, 256, size, np.uint8)
    if kind == 1:
        return g.integers(0, int(g.integers(2, 32)), size, np.uint8)
    if kind == 2:
        nruns = size // int(g.integers(2, 300)) + 1
        return np.repeat(g.integers(0, 256, nruns, np.uint8),
                         g.integers(1, 600, nruns))[:size].copy()
    if kind == 3:
        return np.zeros(size, np.uint8)
    # blocks of alternating entropy
    parts = [g.integers(0, 256 if i % 2 else 4, 1000, np.uint8)
             for i in range(size // 1000 + 1)]
    return np.concatenate(parts)[:size]


@pytest.mark.parametrize("seed", range(8))
def test_fl_backends_agree(seed):
    g = np.random.default_rng(1000 + seed)
    data = _random_case(g)
    bits_g, values_g = fl_numpy.encode(data)
    bits_d, values_d = fl_jax.encode(data, bucket_frames=32)
    np.testing.assert_array_equal(bits_d, bits_g)
    np.testing.assert_array_equal(values_d, values_g)
    nat = get_native()
    if nat is not None:
        bits_n, values_n = nat.fl_encode(data)
        np.testing.assert_array_equal(bits_n, bits_g)
        np.testing.assert_array_equal(values_n, values_g)
        np.testing.assert_array_equal(
            nat.fl_decode(data.size, bits_g, values_g), data)
    np.testing.assert_array_equal(
        fl_jax.decode(data.size, bits_g, values_g, bucket_frames=32), data)


@pytest.mark.parametrize("seed", range(8))
def test_rl_backends_agree(seed):
    g = np.random.default_rng(2000 + seed)
    data = _random_case(g)
    c_g, v_g = rl_numpy.encode(data)
    c_d, v_d = rl_jax.encode(data, bucket=4096)
    np.testing.assert_array_equal(c_d, c_g)
    np.testing.assert_array_equal(v_d, v_g)
    nat = get_native()
    if nat is not None:
        c_n, v_n = nat.rl_encode(data)
        np.testing.assert_array_equal(c_n, c_g)
        np.testing.assert_array_equal(nat.rl_decode(c_g, v_g), data)
    np.testing.assert_array_equal(rl_jax.decode(c_g, v_g, bucket=4096), data)


@pytest.mark.parametrize("frame_length", [8, 16, 64, 256, 1024])
def test_fl_frame_lengths(frame_length):
    g = np.random.default_rng(frame_length)
    data = g.integers(0, 128, 7 * frame_length + 3, np.uint8)
    bits_g, values_g = fl_numpy.encode(data, frame_length)
    bits_d, values_d = fl_jax.encode(data, frame_length, bucket_frames=4)
    np.testing.assert_array_equal(bits_d, bits_g)
    np.testing.assert_array_equal(values_d, values_g)
    nat = get_native()
    if nat is not None:
        bits_n, values_n = nat.fl_encode(data, frame_length)
        np.testing.assert_array_equal(bits_n, bits_g)
        np.testing.assert_array_equal(values_n, values_g)
