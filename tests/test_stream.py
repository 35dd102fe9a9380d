"""Streaming (chunked) FL compression — byte-identical to whole-file."""

import numpy as np
import pytest

from fl_rl_compression_mpi_tpu import container, stream
from fl_rl_compression_mpi_tpu.cli import main
from fl_rl_compression_mpi_tpu.ops import fl_numpy


@pytest.mark.parametrize("size", [128 * 100, 128 * 257 + 55, 1000])
def test_stream_matches_whole_file(tmp_path, size):
    data = np.random.default_rng(size).integers(0, 64, size, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    whole = str(tmp_path / "whole.fl")
    bits, values = fl_numpy.encode(data)
    container.save_fl(whole, container.FLCompressed(bits, values, data.size))

    out = str(tmp_path / "stream.fl")
    stream.compress_fl_stream(src, out, chunk_mb=1)  # forces many chunks? 1MB
    assert open(out, "rb").read() == open(whole, "rb").read()

    back = str(tmp_path / "back.bin")
    stream.decompress_fl_stream(out, back, chunk_mb=1)
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)


def test_stream_tiny_chunks(tmp_path):
    """Chunk smaller than default floors to one frame and still matches."""
    data = np.random.default_rng(1).integers(0, 256, 128 * 33 + 5, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    out = str(tmp_path / "s.fl")
    # chunk_mb=0 floors to one frame per chunk
    stream.compress_fl_stream(src, out, chunk_mb=0)
    comp = container.load_fl(out)
    bits_g, values_g = fl_numpy.encode(data)
    np.testing.assert_array_equal(comp.bits, bits_g)
    np.testing.assert_array_equal(comp.values, values_g)
    back = str(tmp_path / "b.bin")
    stream.decompress_fl_stream(out, back, chunk_mb=0)
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)


def test_stream_empty(tmp_path):
    src = str(tmp_path / "e.bin")
    open(src, "wb").close()
    out = str(tmp_path / "e.fl")
    stream.compress_fl_stream(src, out)
    assert open(out, "rb").read() == b"\x00" * 24
    back = str(tmp_path / "e2.bin")
    stream.decompress_fl_stream(out, back)
    assert open(back, "rb").read() == b""


def test_stream_cli(tmp_path):
    data = np.random.default_rng(2).integers(0, 32, 300_000, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    comp = str(tmp_path / "o.fl")
    back = str(tmp_path / "o.bin")
    assert main(["c", "fl", src, comp, "--stream-chunk-mb", "1"]) == 0
    assert main(["d", "fl", comp, back, "--stream-chunk-mb", "1"]) == 0
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)
    # containers interoperate with non-streaming methods
    back2 = str(tmp_path / "o2.bin")
    assert main(["d", "fl-cpu", comp, back2]) == 0
    np.testing.assert_array_equal(np.fromfile(back2, np.uint8), data)


def test_stream_rejects_rl(tmp_path, capsys):
    src = str(tmp_path / "x.bin")
    np.zeros(10, np.uint8).tofile(src)
    assert main(["c", "rl", src, str(tmp_path / "x.rl"),
                 "--stream-chunk-mb", "1"]) == 2


def test_stream_cli_verify(tmp_path, capsys):
    data = np.random.default_rng(3).integers(0, 32, 300_000, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    comp = str(tmp_path / "o.fl")
    assert main(["c", "fl", src, comp, "--stream-chunk-mb", "1",
                 "--verify"]) == 0
    assert "verification OK" in capsys.readouterr().err
    # corrupting the container makes --verify fail with a tagged error
    blob = bytearray(open(comp, "rb").read())
    blob[-1] ^= 0xFF
    bad_src = str(tmp_path / "in2.bin")
    data.tofile(bad_src)
    open(comp, "wb").write(bytes(blob))
    from fl_rl_compression_mpi_tpu import stream
    assert not stream.verify_fl_stream(bad_src, comp, 128, 1)


def test_pipelined_chunk_codec_dense_paths(monkeypatch):
    """Software-pipelined chunked codec (encode_chunks / decode_chunks) on
    the dense route: byte-exact vs fl_numpy across chunk classes —
    constant (closed form at submit), uniform w4, uniform with a narrower
    tail frame, mixed widths, ragged tail — and every non-constant chunk
    is placed on the device (no host fold)."""
    from fl_rl_compression_mpi_tpu.ops import fields, fl_jax, fl_numpy
    calls = {"enc": 0, "dec": 0}
    enc, dec = fl_jax.fl_encode_dense, fl_jax.fl_decode_dense

    def spy_enc(*a, **k):
        calls["enc"] += 1
        return enc(*a, **k)

    def spy_dec(*a, **k):
        calls["dec"] += 1
        return dec(*a, **k)

    def no_host_placement(*a, **k):
        raise AssertionError("dense route must not fold/unfold on host")

    monkeypatch.setattr(fl_jax, "fl_encode_dense", spy_enc)
    monkeypatch.setattr(fl_jax, "fl_decode_dense", spy_dec)
    monkeypatch.setattr(fields, "fold", no_host_placement)
    monkeypatch.setattr(fields, "unfold", no_host_placement)
    rng = np.random.default_rng(5)
    ck = 128 * 64                       # frame-aligned chunk size
    const = np.full(ck, 9, np.uint8)
    uni = (rng.integers(0, 16, ck, np.uint8) | 8)      # uniform w4
    miss = uni.copy()
    miss[-128:] = 1                     # tail frame width 1 -> flag trips
    mixed = rng.integers(0, 256, ck, np.uint8)   # per-frame widths 1..8
    mixed.reshape(-1, 128)[:] &= ((1 << rng.integers(1, 9, ck // 128)) - 1
                                  ).astype(np.uint8)[:, None]
    tail = rng.integers(0, 64, 777, np.uint8)          # ragged last
    chunks = [const, uni, miss, mixed, tail]
    data = np.concatenate(chunks)
    parts = list(fl_jax.encode_chunks(iter(chunks), bucket_frames=8))
    bits = np.concatenate([p[0] for p in parts])
    values = np.concatenate([p[1] for p in parts])
    bg, vg = fl_numpy.encode(data)
    np.testing.assert_array_equal(bits, bg)
    np.testing.assert_array_equal(values, vg)
    # decode side: per-chunk frame ranges from the widths header
    voffs, dparts, f0 = 0, [], 0
    for c in chunks:
        nf = -(-c.size // 128)
        counts = np.minimum(
            c.size - np.arange(nf, dtype=np.int64) * 128, 128)
        vb = int(((bg[f0:f0 + nf].astype(np.int64) * counts + 7)
                  // 8).sum())
        dparts.append((c.size, bg[f0:f0 + nf], vg[voffs:voffs + vb]))
        f0 += nf
        voffs += vb
    outs = list(fl_jax.decode_chunks(iter(dparts), bucket_frames=8))
    np.testing.assert_array_equal(np.concatenate(outs), data)
    assert calls == {"enc": 4, "dec": 4}


def test_encode_chunks_rejects_misaligned_middle_chunk():
    """Frame alignment is the byte-identity invariant: a misaligned
    NON-final chunk must raise, not silently change the container."""
    import pytest

    from fl_rl_compression_mpi_tpu.ops import fl_jax
    chunks = [np.zeros(100, np.uint8), np.zeros(128, np.uint8)]
    with pytest.raises(ValueError, match="last"):
        list(fl_jax.encode_chunks(iter(chunks)))
    # a misaligned LAST chunk is fine
    ok = list(fl_jax.encode_chunks(iter(
        [np.zeros(256, np.uint8), np.zeros(100, np.uint8)])))
    assert len(ok) == 2


def test_chunked_codec_random_split_equivalence():
    """Property fuzz: for ANY frame-aligned chunking of a
    stream mixing constant spans, w8 spans, and mixed-width content,
    encode_chunks produces bit-identical (bits, values) to the
    whole-buffer golden, and decode_chunks inverts it exactly (both
    on the dense route)."""
    from fl_rl_compression_mpi_tpu.ops import fl_jax, fl_numpy
    rng = np.random.default_rng(13)
    for trial in range(6):
        spans = []
        for _ in range(rng.integers(2, 6)):
            kind = rng.integers(0, 3)
            ln = int(rng.integers(1, 40)) * 128
            if kind == 0:
                spans.append(np.full(ln, int(rng.integers(0, 256)),
                                     np.uint8))
            elif kind == 1:
                s = rng.integers(0, 256, ln).astype(np.uint8)
                s[::128] |= 128
                spans.append(s)
            else:
                spans.append(rng.integers(
                    0, 1 << int(rng.integers(1, 9)), ln).astype(
                        np.uint8))
        data = np.concatenate(spans)[: -int(rng.integers(0, 120)) or None]
        bg, vg = fl_numpy.encode(data)
        # random frame-aligned split points (+ ragged tail allowed)
        nfr = -(-data.size // 128)
        cuts = np.sort(rng.choice(np.arange(1, nfr), size=min(
            int(rng.integers(1, 5)), nfr - 1), replace=False)) * 128
        chunks = np.split(data, cuts)
        parts = list(fl_jax.encode_chunks(iter(chunks),
                                          bucket_frames=16))
        np.testing.assert_array_equal(
            np.concatenate([p[0] for p in parts]), bg, err_msg=str(trial))
        np.testing.assert_array_equal(
            np.concatenate([p[1] for p in parts]), vg, err_msg=str(trial))
        # decode side over the same split
        dparts, f0, voff = [], 0, 0
        for c in chunks:
            nf = -(-c.size // 128)
            counts = np.minimum(
                c.size - np.arange(nf, dtype=np.int64) * 128, 128)
            vb = int(((bg[f0:f0 + nf].astype(np.int64) * counts + 7)
                      // 8).sum())
            dparts.append((c.size, bg[f0:f0 + nf],
                           vg[voff:voff + vb]))
            f0 += nf
            voff += vb
        outs = list(fl_jax.decode_chunks(iter(dparts),
                                         bucket_frames=16))
        np.testing.assert_array_equal(np.concatenate(outs), data,
                                      err_msg=str(trial))


def test_chunked_codec_device_cap_split(monkeypatch):
    """Chunks above the device cap split internally (frame-aligned) —
    the streaming CLI passes user-sized chunks straight through, and
    the cap is the int32 index-math bound the kernels assume."""
    from fl_rl_compression_mpi_tpu.ops import fl_jax, fl_numpy
    monkeypatch.setattr(fl_jax, "MAX_DEVICE_CHUNK", 128 * 64)
    rng = np.random.default_rng(21)
    data = rng.integers(0, 64, 128 * 300 + 17, np.uint8)
    parts = list(fl_jax.encode_chunks(iter([data]), bucket_frames=8))
    assert len(parts) > 1                 # really split
    bg, vg = fl_numpy.encode(data)
    np.testing.assert_array_equal(
        np.concatenate([p[0] for p in parts]), bg)
    np.testing.assert_array_equal(
        np.concatenate([p[1] for p in parts]), vg)
    outs = list(fl_jax.decode_chunks(iter([(data.size, bg, vg)]),
                                     bucket_frames=8))
    assert len(outs) > 1
    np.testing.assert_array_equal(np.concatenate(outs), data)


def test_decode_rejects_empty_widths_nonzero_claim():
    """n > 0 with an empty widths array is a corrupt container and must
    raise (the native decoder already does; the Python decoders used to
    silently return empty output — a truncation)."""
    import pytest

    from fl_rl_compression_mpi_tpu.ops import fl_jax
    with pytest.raises(ValueError, match="corrupt"):
        fl_jax.decode(1000, np.zeros(0, np.uint8),
                      np.zeros(0, np.uint8))
    with pytest.raises(ValueError, match="corrupt"):
        list(fl_jax.decode_chunks(iter(
            [(1000, np.zeros(0, np.uint8), np.zeros(0, np.uint8))])))


def test_api_accepts_python_bytes():
    """flrl.compress advertised bytes-in; np.asarray(bytes) is a scalar
    trap — pinned."""
    import fl_rl_compression_mpi_tpu as flrl
    raw = bytes(range(200)) * 80
    comp = flrl.compress(raw, method="fl-cpu")
    np.testing.assert_array_equal(
        flrl.decompress(comp, method="fl-cpu"),
        np.frombuffer(raw, np.uint8))
