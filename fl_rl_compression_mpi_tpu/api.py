"""One-call library API over the codec registry.

The CLI mirrors the reference's command surface
(``/root/reference/src/main.cu:72-169``); library users get the same
method table as plain functions — bytes in/out or file in/out — with
every backend (``fl``, ``fl-cpu``, ``fl-dist``, ``fl-nccl``, ``rl``,
``rl-cpu``, ``rl-dist`` + the aliases ``fl-mpi``/``fl-ici``)
selectable by name:

    import fl_rl_compression_mpi_tpu as flrl
    comp = flrl.compress(data, method="fl")        # container struct
    out = flrl.decompress(comp, method="fl")
    flrl.compress_file("in.bin", "out.fl")         # container on disk
    flrl.decompress_file("out.fl", "restored.bin")

Containers written here are byte-identical to the reference binary's
(pinned by ``tests/golden/reference/``), so files interoperate across
both implementations and every method of the same family.
"""

from __future__ import annotations

import numpy as np

from . import container
from .models.registry import ALIASES, CODECS, resolve


def methods() -> dict[str, str]:
    """Available method names (incl. reference aliases) → description."""
    out = {name: c.description for name, c in CODECS.items()}
    out.update({a: f"alias of {t}" for a, t in ALIASES.items()})
    return out


def _as_u8(data) -> np.ndarray:
    # np.asarray(b"...", np.uint8) treats bytes as a SCALAR and raises;
    # frombuffer is the correct zero-copy view for bytes-like inputs
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return np.asarray(data, np.uint8)


def compress(data, method: str = "fl", **opts):
    """Bytes → container struct (``FLCompressed`` / ``RLCompressed``).

    ``opts`` pass through to the backend (``frame_length`` for FL,
    ``devices`` for distributed methods)."""
    codec = resolve(method)
    return codec.compress(_as_u8(data), **opts)


def decompress(comp, method: str = "fl", **opts) -> np.ndarray:
    """Container struct → decoded bytes (u8 array)."""
    codec = resolve(method)
    return codec.decompress(comp, **opts)


def compress_file(input_path: str, output_path: str,
                  method: str = "fl", **opts) -> None:
    """File → container file (the reference's ``compress c`` analog)."""
    codec = resolve(method)
    from .fileio import load_file
    comp = codec.compress(load_file(input_path), **opts)
    if codec.family == "fl":
        container.save_fl(output_path, comp)
    else:
        container.save_rl(output_path, comp)


def decompress_file(input_path: str, output_path: str,
                    method: str = "fl", **opts) -> None:
    """Container file → file (the reference's ``compress d`` analog)."""
    codec = resolve(method)
    comp = (container.load_fl(input_path) if codec.family == "fl"
            else container.load_rl(input_path))
    from .fileio import save_file
    save_file(output_path, codec.decompress(comp, **opts))
