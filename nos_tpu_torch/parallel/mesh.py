"""A device mesh for the port's single-controller parallelism.

Port of `build_mesh` (`nos_tpu/parallel/mesh.py:22`),
`build_multislice_mesh` (:50), `mesh_from_topology` (:111) and
`mesh_from_assignment` (:139). JAX's `Mesh` is an
array of devices with named axes, and a `shard_map`'d program runs once per
device. The port keeps one controller: a `Mesh` here is only the devices in
shard order with named axis sizes, and the sharded programs loop over the
shards of one axis (`models/decode.py::TPLocal`, `parallel/collectives.py`).
A position is an index into `devices`; `coords` names its index on each
axis and `groups(axis)` lists the positions that a collective over `axis`
joins. A device may repeat in the
list, which stands in for the virtual devices the JAX package tests on:
`["cpu", "cpu"]` in the tests, `["cuda:0", "cuda:0"]` on a single card. The
same code runs one shard per card when the devices differ.
`mesh_from_assignment` is the last link from the control plane to the
workload: the sub-slice topology label that a node agent stamps becomes
the mesh of the job that landed there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nos_tpu_torch import constants
from nos_tpu_torch.tpu.topology import Topology, accelerator_generation


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
        grid = self._grid()
        index = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return [self.devices[i] for i in grid[index].tolist()]

    def _grid(self) -> np.ndarray:
        return np.arange(len(self.devices)).reshape(tuple(self.shape.values()))

    def coords(self, position: int) -> Dict[str, int]:
        """The index of `position` on each axis."""
        index = np.unravel_index(position, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, index)}

    def groups(self, axis: str) -> List[List[int]]:
        """The positions a collective over `axis` joins: one list per
        index of the other axes (row-major), each in `axis` order. An axis
        the mesh lacks has size 1: every position is a group of its own."""
        grid = self._grid()
        if axis not in self.shape:
            return [[p] for p in grid.ravel().tolist()]
        moved = np.moveaxis(grid, self.axis_names.index(axis), -1)
        return moved.reshape(-1, self.shape[axis]).tolist()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def canonical_device(d) -> torch.device:
    """`d` as a torch.device, a CUDA device with its index ("cuda" is the
    current one), so that devices compare equal when they are one."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _devices(devices: Optional[Sequence], what: str) -> List[torch.device]:
    """`devices` as canonical torch devices; None means every CUDA device,
    and raises without CUDA (`what` names the entry point)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on CUDA by default and no CUDA device is "
                "available; pass devices=['cpu', ...] to build a CPU mesh"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [canonical_device(d) for d in devices]


def build_mesh(axes: Optional[Dict[str, int]] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh with the given axis sizes (e.g. {"tp": 2}). Sizes multiply to
    at most the device count (a prefix of the devices is used); one size
    may be -1, inferred. `devices` None means every CUDA device, and raises
    without CUDA; an explicit list may repeat a device. No axes: one "dp"
    axis over all the devices."""
    devices = _devices(devices, "build_mesh")
    n = len(devices)
    axes = _infer_axes(axes or {"dp": n}, n, "")
    total = int(np.prod(list(axes.values())))
    if total > n:
        raise ValueError(f"mesh axes {axes} need {total} devices, have {n}")
    return Mesh(devices[:total], axes)


def _infer_axes(axes: Dict[str, int], n: int, what: str) -> Dict[str, int]:
    """`axes` with its one -1 size (if any) inferred from `n` devices."""
    axes = dict(axes)
    infer = [k for k, v in axes.items() if v == -1]
    if len(infer) > 1:
        raise ValueError(f"at most one {what}axis size may be -1")
    known = int(np.prod([v for v in axes.values() if v != -1]))
    if infer:
        if n % known != 0:
            raise ValueError(f"cannot infer {infer[0]}: {n} devices / {known}")
        axes[infer[0]] = n // known
    return axes


def build_multislice_mesh(ici_axes: Optional[Dict[str, int]] = None, dcn_axis: str = "dcn",
                          num_slices: Optional[int] = None,
                          devices: Optional[Sequence] = None) -> Mesh:
    """A mesh whose leading `dcn_axis` spans slices and whose other axes
    tile each slice (`nos_tpu/parallel/mesh.py:50`): data parallelism on
    the slow axis, tensor, sequence and expert parallelism inside a slice.
    A torch device names no slice, so the devices split into `num_slices`
    equal contiguous groups (one group when None). The ICI axes must
    multiply to the devices of a slice; one size may be -1, inferred."""
    devices = _devices(devices, "build_multislice_mesh")
    n_slices = num_slices or 1
    if len(devices) % n_slices != 0:
        raise ValueError(f"{len(devices)} devices not divisible into {n_slices} slices")
    per_slice = len(devices) // n_slices
    ici_axes = _infer_axes(ici_axes or {"dp": per_slice}, per_slice, "ICI ")
    if int(np.prod(list(ici_axes.values()))) != per_slice:
        raise ValueError(f"ICI axes {ici_axes} must multiply to {per_slice} devices per slice")
    return Mesh(devices, dict({dcn_axis: n_slices}, **ici_axes))


def mesh_from_topology(topology: Topology, axis_names: Sequence[str] = ("dp", "tp"),
                       devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh shaped like a sub-slice's physical topology
    (`nos_tpu/parallel/mesh.py:111`): a v5e `4x4` becomes a ("dp", "tp")
    4x4 mesh whose axes follow the mesh dimensions. Missing axes get size
    1; topology dims beyond `axis_names` fold into the last axis. The
    devices, one per chip, lie in row-major order; `devices` None means
    every CUDA device, and raises without CUDA."""
    devices = _devices(devices, "mesh_from_topology")
    dims = list(topology.shape.dims)
    if len(devices) != topology.chips:
        raise ValueError(
            f"topology {topology} has {topology.chips} chips, "
            f"got {len(devices)} devices"
        )
    if len(dims) < len(axis_names):
        dims += [1] * (len(axis_names) - len(dims))
    if len(dims) > len(axis_names):
        folded = int(np.prod(dims[len(axis_names) - 1:]))
        dims = dims[: len(axis_names) - 1] + [folded]
    return Mesh(devices, dict(zip(axis_names, dims)))


def mesh_from_assignment(node_labels: Dict[str, str], axis_names: Sequence[str] = ("dp", "tp"),
                         devices: Optional[Sequence] = None, num_slices: int = 1,
                         ici_axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The workload mesh from the labels of the node a pod landed on
    (`nos_tpu/parallel/mesh.py:139`): the sub-slice topology label (else
    the node's mesh topology) under the accelerator label's generation
    (v5e when unknown). A single-slice gang gets `mesh_from_topology`'s
    mesh; a multislice gang (`num_slices` > 1) a leading "dcn" axis over
    the slices with `ici_axes` (default one "tp" axis over a slice's
    chips) inside each, through `build_multislice_mesh`."""
    topo_str = node_labels.get(
        constants.LABEL_TPU_SUBSLICE_TOPOLOGY
    ) or node_labels.get(constants.LABEL_TPU_TOPOLOGY)
    if not topo_str:
        raise ValueError("node labels carry no sub-slice or mesh topology")
    generation = (
        accelerator_generation(
            node_labels.get(constants.LABEL_TPU_ACCELERATOR, "")
        )
        or "v5e"
    )
    topology = Topology.parse(generation, topo_str)
    if num_slices > 1:
        if ici_axes is None:
            ici_axes = {"tp": topology.chips}
        return build_multislice_mesh(
            dict(ici_axes), num_slices=num_slices, devices=devices
        )
    return mesh_from_topology(topology, axis_names, devices)
