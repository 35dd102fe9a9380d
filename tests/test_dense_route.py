"""Dense FL route (``fl_encode_dense`` / ``fl_decode_dense``) against the
NumPy golden and the reference-written containers, on the CPU backend.

The route is plain JAX and not gated on the backend, so these run the same
program the GPU runs (at small shapes)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest

from fl_rl_compression_mpi_tpu import container
from fl_rl_compression_mpi_tpu.ops import fl_jax, fl_numpy

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                    "reference")
CASES = sorted(glob.glob(os.path.join(GOLD, "case_*.fl")))
PAD_FRAMES = 64          # one padded shape: every case shares one compile


def _encode_dense(data, frame_length=128, pad_frames=PAD_FRAMES):
    buf = np.zeros(pad_frames * frame_length, np.uint8)
    buf[: data.size] = data
    bits, dense, total = fl_jax.fl_encode_dense(
        jnp.asarray(buf.view(np.uint32)), jnp.int32(data.size),
        frame_length=frame_length)
    return np.asarray(bits), np.asarray(dense), int(total)


def _decode_dense(bits, values, n, frame_length=128, pad_frames=PAD_FRAMES):
    bbuf = np.zeros(pad_frames, np.uint8)
    bbuf[: bits.size] = bits
    vbuf = np.zeros(-(-values.size // 4) * 4, np.uint8)
    vbuf[: values.size] = values
    out = fl_jax.fl_decode_dense(
        jnp.asarray(vbuf.view(np.uint32)), jnp.asarray(bbuf), jnp.int32(n),
        frame_length=frame_length)
    return np.asarray(out).view(np.uint8)[:n]


def _check_against_golden(data, frame_length=128):
    bg, vg = fl_numpy.encode(data, frame_length)
    bits, dense, total = _encode_dense(data, frame_length)
    frames = bg.size
    np.testing.assert_array_equal(bits[:frames], bg)
    # every live frame takes L·b/32 whole words (the tail frame too); the
    # container payload is their byte prefix and everything past it is 0
    assert total == int(bg.astype(np.int64).sum()) * frame_length // 32
    np.testing.assert_array_equal(dense.view(np.uint8)[: vg.size], vg)
    assert not dense.view(np.uint8)[vg.size:].any()
    np.testing.assert_array_equal(
        _decode_dense(bg, vg, data.size, frame_length), data)


@pytest.mark.parametrize("tail", [0, 1, 77])
@pytest.mark.parametrize("width", range(1, 9))
def test_dense_uniform_width(width, tail):
    rng = np.random.default_rng(width * 100 + tail)
    n = 128 * 37 + tail
    data = rng.integers(0, 1 << width, n).astype(np.uint8)
    data[::128] |= 1 << (width - 1)          # pin every frame at `width`
    _check_against_golden(data)


@pytest.mark.parametrize("seed", range(4))
def test_dense_mixed_widths(seed):
    rng = np.random.default_rng(seed)
    n = 128 * 50 + int(rng.integers(0, 128))
    data = rng.integers(0, 256, n).astype(np.uint8)
    frames = data[: n // 128 * 128].reshape(-1, 128)
    frames &= ((1 << rng.integers(1, 9, frames.shape[0])) - 1).astype(
        np.uint8)[:, None]
    _check_against_golden(data)


@pytest.mark.parametrize("path", CASES,
                         ids=[os.path.basename(p)[:-3] for p in CASES])
def test_dense_decode_of_reference_container(path):
    """Containers written by the reference binary decode through the
    device program directly (no host constant/identity shortcut)."""
    comp = container.load_fl(path)
    data = np.fromfile(path[:-3] + ".bin", np.uint8)
    n = int(comp.input_size)
    pad = max(PAD_FRAMES, -(-n // 128))
    if n:
        np.testing.assert_array_equal(
            _decode_dense(comp.bits, comp.values, n, pad_frames=pad), data)
    else:
        assert data.size == 0


@pytest.mark.parametrize("frame_length,dense", [
    (32, True), (64, True), (256, True), (8, False), (24, False)])
def test_frame_length_route(frame_length, dense, monkeypatch):
    """Frame lengths that are a multiple of 32 take the dense route; the
    others keep the field route with the host fold/unfold.  Both match the
    golden through the host API."""
    from fl_rl_compression_mpi_tpu.ops import fields
    assert fl_jax.dense_route(frame_length) == dense
    calls = []
    fold, unfold = fields.fold, fields.unfold
    monkeypatch.setattr(fields, "fold",
                        lambda *a: calls.append("fold") or fold(*a))
    monkeypatch.setattr(fields, "unfold",
                        lambda *a: calls.append("unfold") or unfold(*a))
    rng = np.random.default_rng(frame_length)
    data = rng.integers(0, 256, 40 * frame_length + 5).astype(np.uint8)
    frames = data[: 40 * frame_length].reshape(40, frame_length)
    frames &= ((1 << rng.integers(1, 9, 40)) - 1).astype(np.uint8)[:, None]
    bg, vg = fl_numpy.encode(data, frame_length)
    bits, values = fl_jax.encode(data, frame_length, bucket_frames=8)
    np.testing.assert_array_equal(bits, bg)
    np.testing.assert_array_equal(values, vg)
    np.testing.assert_array_equal(
        fl_jax.decode(data.size, bg, vg, frame_length, bucket_frames=8),
        data)
    assert calls == ([] if dense else ["fold", "unfold"])
