"""A device mesh for the port's single-controller tensor parallelism.

Port of `build_mesh` (`nos_tpu/parallel/mesh.py:22`). JAX's `Mesh` is an
array of devices with named axes, and a `shard_map`'d program runs once per
device. The port keeps one controller: a `Mesh` here is only the devices in
shard order with named axis sizes, and the sharded programs loop over the
shards of one axis (`models/decode.py::TPLocal`). A device may repeat in the
list, which stands in for the virtual devices the JAX package tests on:
`["cpu", "cpu"]` in the tests, `["cuda:0", "cuda:0"]` on a single card. The
same code runs one shard per card when the devices differ.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Devices laid out on named axes: `.shape` maps each axis name to its
    size (in order, like JAX's `mesh.shape`), `.axis_names` lists them and
    `.devices` holds the `torch.device`s in row-major order over the axes."""

    def __init__(self, devices: Sequence[torch.device], axes: Dict[str, int]):
        self.shape: Dict[str, int] = dict(axes)
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.devices: List[torch.device] = list(devices)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis` (shard order), every other axis at index
        0: the shards a program sharded on `axis` alone runs on."""
        grid = np.arange(len(self.devices)).reshape(tuple(self.shape.values()))
        index = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return [self.devices[i] for i in grid[index].tolist()]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def canonical_device(d) -> torch.device:
    """`d` as a torch.device, a CUDA device with its index ("cuda" is the
    current one), so that devices compare equal when they are one."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def build_mesh(axes: Optional[Dict[str, int]] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh with the given axis sizes (e.g. {"tp": 2}). Sizes multiply to
    at most the device count (a prefix of the devices is used); one size
    may be -1, inferred. `devices` None means every CUDA device, and raises
    without CUDA; an explicit list may repeat a device. No axes: one "dp"
    axis over all the devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_mesh runs on CUDA by default and no CUDA device is "
                "available; pass devices=['cpu', ...] to build a CPU mesh"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    axes = dict(axes or {"dp": n})
    infer = [k for k, v in axes.items() if v == -1]
    if len(infer) > 1:
        raise ValueError("at most one axis size may be -1")
    known = int(np.prod([v for v in axes.values() if v != -1]))
    if infer:
        if n % known != 0:
            raise ValueError(f"cannot infer {infer[0]}: {n} devices / {known}")
        axes[infer[0]] = n // known
    total = int(np.prod(list(axes.values())))
    if total > n:
        raise ValueError(f"mesh axes {axes} need {total} devices, have {n}")
    return Mesh(devices[:total], axes)
