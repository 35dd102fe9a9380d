"""Codec backend registry — one table from method name to implementation.

The reference dispatches methods with switch statements in ``main.cu``
(``/root/reference/src/main.cu:72-169``); here every backend is a uniform
``Codec`` entry so the CLI, tests and benchmarks enumerate one table.  The
two codec families (FL, RL) × backends (device kernel, native C++ host,
NumPy golden, distributed host-merge, distributed all-gather merge) are this
framework's "model zoo".
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..container import FLCompressed, RLCompressed
from ..native import get_native


@dataclasses.dataclass(frozen=True)
class Codec:
    name: str
    family: str                       # "fl" | "rl"
    description: str
    compress: Callable[..., object]   # (data, **opts) -> container struct
    decompress: Callable[..., np.ndarray]  # (container, **opts) -> bytes
    distributed: bool = False


def _fl(data, frame_length=128, **_):
    from ..ops import fl_jax
    bits, values = fl_jax.encode(data, frame_length)
    return FLCompressed(bits, values, data.size)


def _fl_d(comp, frame_length=128, **_):
    from ..ops import fl_jax
    return fl_jax.decode(comp.input_size, comp.bits, comp.values,
                         frame_length)


def _fl_cpu(data, frame_length=128, **_):
    nat = get_native()
    if nat is not None:
        bits, values = nat.fl_encode(data, frame_length)
    else:
        from ..ops import fl_numpy
        bits, values = fl_numpy.encode(data, frame_length)
    return FLCompressed(bits, values, data.size)


def _fl_cpu_d(comp, frame_length=128, **_):
    nat = get_native()
    if nat is not None:
        return nat.fl_decode(comp.input_size, comp.bits, comp.values,
                             frame_length)
    from ..ops import fl_numpy
    return fl_numpy.decode(comp.input_size, comp.bits, comp.values,
                           frame_length)


def _fl_dist(data, frame_length=128, devices=None, **_):
    from ..parallel import dist
    return dist.compress_fl(data, dist.make_mesh(devices), frame_length)


def _fl_nccl(data, frame_length=128, devices=None, **_):
    from ..parallel import dist
    return dist.compress_fl_ici(data, dist.make_mesh(devices), frame_length)


def _fl_dist_d(comp, frame_length=128, devices=None, **_):
    from ..parallel import dist
    return dist.decompress_fl(comp, dist.make_mesh(devices), frame_length)


def _rl(data, **_):
    from ..ops import rl_jax
    counts, values = rl_jax.encode(data)
    return RLCompressed(counts, values, data.size)


def _rl_d(comp, **_):
    from ..ops import rl_jax
    return rl_jax.decode(comp.counts, comp.values)


def _rl_cpu(data, **_):
    nat = get_native()
    if nat is not None:
        counts, values = nat.rl_encode(data)
    else:
        from ..ops import rl_numpy
        counts, values = rl_numpy.encode(data)
    return RLCompressed(counts, values, data.size)


def _rl_cpu_d(comp, **_):
    nat = get_native()
    if nat is not None:
        return nat.rl_decode(comp.counts, comp.values)
    from ..ops import rl_numpy
    return rl_numpy.decode(comp.counts, comp.values)


def _rl_dist(data, devices=None, **_):
    from ..parallel import dist
    return dist.compress_rl(data, dist.make_mesh(devices))


def _rl_dist_d(comp, devices=None, **_):
    from ..parallel import dist
    return dist.decompress_rl(comp, dist.make_mesh(devices))


CODECS: dict[str, Codec] = {c.name: c for c in [
    Codec("fl", "fl", "FL on one GPU (device widths + dense placement)",
          _fl, _fl_d),
    Codec("fl-cpu", "fl", "FL on host (native C++/OpenMP, NumPy fallback)",
          _fl_cpu, _fl_cpu_d),
    Codec("fl-dist", "fl", "FL over all devices, rank-ordered host merge "
          "(reference fl-mpi analog)", _fl_dist, _fl_dist_d,
          distributed=True),
    Codec("fl-nccl", "fl", "FL over all devices, on-device all-gather "
          "merge (reference fl-nccl)", _fl_nccl, _fl_dist_d,
          distributed=True),
    Codec("rl", "rl", "RL on one GPU", _rl, _rl_d),
    Codec("rl-cpu", "rl", "RL on host (native C++/OpenMP, NumPy fallback)",
          _rl_cpu, _rl_cpu_d),
    Codec("rl-dist", "rl", "RL over all devices (per-shard runs)",
          _rl_dist, _rl_dist_d, distributed=True),
]}

ALIASES = {"fl-mpi": "fl-dist", "fl-ici": "fl-nccl"}


def resolve(name: str) -> Codec:
    return CODECS[ALIASES.get(name, name)]
