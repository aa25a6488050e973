"""Sharding rules and placement on a mesh.

Port of `nos_tpu/parallel/sharding.py`: `transformer_param_rules` (:18),
`decode_param_rules` (:37), `spec_for_path` (:70), `guarded_spec` (:85),
`shard_params` (:117), `param_partition_specs` (:135), and the roles of
`param_shardings`, `batch_sharding` and `replicated` (:127-163). A spec is a
plain tuple of mesh axis names (or tuples of them) or None, one entry per
leading tensor dimension, in the role of JAX's `PartitionSpec`; `()` is
replicated. Where JAX places one global array on the mesh, the port keeps
one tensor per mesh position (`shard_tensor`; `unshard_tensor` joins them
back): `shard_params` returns one param tree per shard of the tp axis (the
decode engine's layout), `param_shardings` a `MeshTree`, one tree per mesh
position (the train step's).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from nos_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]


def transformer_param_rules(tp_axis: str = "tp") -> Sequence[Tuple[str, Spec]]:
    """The Megatron layout of the sharded train step: qkv and the MLP's
    up/gate projections shard their output features (column-parallel),
    the attention output and the MLP's down projection their input
    features (row-parallel: partial sums, then a sum across tp), the
    embeddings their features and the heads their outputs on tp; norms
    replicate. First match wins."""
    return (
        (r".*(wq|wk|wv|qkv|up_proj|fc1|w_gate|w_up)$", (None, tp_axis)),
        (r".*(wo|out_proj|down_proj|fc2|w_down)$", (tp_axis, None)),
        (r".*(tok_emb|pos_emb|patch_emb)$", (None, tp_axis)),
        (r".*(lm_head|class_head|box_head)$", (None, tp_axis)),
        (r".*", ()),
    )


def decode_param_rules(tp_axis: str = "tp") -> Sequence[Tuple[str, Spec]]:
    """The all-column-parallel layout of the serving decode path
    (docs/sharded-decode.md): every projection shards its OUTPUT features,
    so no contraction is split across shards and the only collectives are
    exact concatenations. tok_emb shards vocab rows (a lookup adds one real
    row to zeros, exactly), lm_head vocab columns; norm scales replicate.
    First match wins."""
    return (
        (r".*(wq|wk|wv|w_gate|w_up|wo|w_down)$", (None, tp_axis)),
        (r".*tok_emb$", (tp_axis, None)),
        (r".*lm_head$", (None, tp_axis)),
        (r".*", ()),
    )


def spec_for_path(path: str, rules: Sequence[Tuple[str, Spec]]) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return tuple(spec)
    return ()


def guarded_spec(arr: torch.Tensor, path: str, mesh: Mesh, rules) -> Spec:
    """The rule's spec for one tensor, replicated instead when the spec
    has more entries than the tensor has dimensions or a sharded dimension
    does not divide by its axis (the 97-token vocabulary on two shards)."""
    spec = spec_for_path(path, rules)
    if len(spec) > arr.dim():
        return ()
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in mesh.shape or arr.shape[dim] % mesh.shape[axis] != 0:
            return ()
    return spec


def _map_params(params, mesh: Mesh, rules, leaf):
    rules = rules or decode_param_rules()

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        return leaf(guarded_spec(tree, prefix, mesh, rules), tree)

    return rebuild(params)


def param_partition_specs(params, mesh: Mesh, rules=None) -> Dict:
    """The spec of every leaf (the guard applied), as a tree shaped like
    `params`. `rules` None means `decode_param_rules()`."""
    return _map_params(params, mesh, rules, lambda spec, arr: spec)


def shard_params(params, mesh: Mesh, rules=None, tp_axis: str = "tp") -> List[Dict]:
    """One param tree per shard of `tp_axis`, on that shard's device
    (`mesh.axis_devices`): a sharded leaf holds its contiguous slice, a
    replicated one the whole tensor, one copy per distinct device (shards
    on one device share it). `rules` None means `decode_param_rules()`."""
    devices = mesh.axis_devices(tp_axis)
    width = len(devices)

    def slices(spec, arr):
        for axis in spec:
            if axis is not None and axis != tp_axis and mesh.shape[axis] > 1:
                raise ValueError(
                    f"spec {spec} shards on '{axis}'; shard_params places "
                    f"shards of '{tp_axis}' only"
                )
        if tp_axis not in spec:
            copies = {d: arr.to(d) for d in set(devices)}
            return [copies[d] for d in devices]
        dim = spec.index(tp_axis)
        size = arr.shape[dim] // width
        return [arr.narrow(dim, s * size, size).contiguous().to(d)
                for s, d in enumerate(devices)]

    tree = _map_params(params, mesh, rules, slices)

    def pick(node, s):
        if isinstance(node, dict):
            return {k: pick(v, s) for k, v in node.items()}
        return node[s]

    return [pick(tree, s) for s in range(width)]


# -- placement on every axis of a mesh ---------------------------------------------
def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(entry, mesh: Mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(index, parts) of one spec entry at a position: the entry's axes
    (those the mesh has) taken row-major, as JAX orders a tuple entry."""
    index, parts = 0, 1
    for axis in _axes(entry):
        size = mesh.shape.get(axis, 1)
        index, parts = index * size + coords.get(axis, 0), parts * size
    return index, parts


def shard_slices(x: torch.Tensor, mesh: Mesh, spec: Spec) -> List[torch.Tensor]:
    """Mesh position p's block of `x` under `spec` as a view of `x`, one
    per position (positions that differ only on axes the spec leaves out
    get the same block)."""
    out = []
    for p in range(len(mesh.devices)):
        coords = mesh.coords(p)
        y = x
        for dim, entry in enumerate(spec):
            index, parts = _block(entry, mesh, coords)
            if parts > 1:
                if x.shape[dim] % parts:
                    raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by {parts}")
                size = x.shape[dim] // parts
                y = y.narrow(dim, index * size, size)
        out.append(y)
    return out


def shard_tensor(x: torch.Tensor, mesh: Mesh, spec: Spec) -> List[torch.Tensor]:
    """`x` placed on the mesh (the role of `jax.device_put(x,
    NamedSharding(mesh, spec))`): position p's block, contiguous, on
    `mesh.devices[p]`. Differentiable: a block's gradient flows back into
    `x`. Spec entries naming axes the mesh lacks shard nothing."""
    return [y.contiguous().to(d) for y, d in zip(shard_slices(x, mesh, spec), mesh.devices)]


def unshard_tensor(shards: Sequence[torch.Tensor], mesh: Mesh, spec: Spec,
                   device=None) -> torch.Tensor:
    """The global tensor from its per-position blocks under `spec`, on
    `device` (None: the first position's). Each block is read from the
    first position that holds it. Differentiable."""
    device = shards[0].device if device is None else device
    blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
    for p, x in enumerate(shards):
        coords = mesh.coords(p)
        blocks.setdefault(tuple(_block(e, mesh, coords)[0] for e in spec), x)
    zero = {a: 0 for a in mesh.axis_names}

    def build(prefix: Tuple[int, ...]) -> torch.Tensor:
        dim = len(prefix)
        if dim == len(spec):
            return blocks[prefix].to(device)
        parts = _block(spec[dim], mesh, zero)[1]
        if parts == 1:
            return build(prefix + (0,))
        return torch.cat([build(prefix + (i,)) for i in range(parts)], dim)

    return build(())


def replica_groups(mesh: Mesh, spec: Spec) -> List[List[int]]:
    """The positions that hold the same block under `spec` (those that
    differ only on axes the spec leaves out), each group in position
    order."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for p in range(len(mesh.devices)):
        coords = mesh.coords(p)
        groups.setdefault(tuple(_block(e, mesh, coords)[0] for e in spec), []).append(p)
    return list(groups.values())


def batch_sharding(mesh: Mesh, dp_axis: str = "dp", sp_axis: Optional[str] = None) -> Spec:
    """The batch layout: batch on dp, the sequence on sp when the mesh has
    it."""
    if sp_axis and sp_axis in mesh.shape:
        return (dp_axis, sp_axis)
    return (dp_axis,)


def replicated(mesh: Mesh) -> Spec:
    return ()


def tree_leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a nested dict in insertion order, keys joined by "/"."""
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            yield from tree_leaves(val, path)
        else:
            yield path, val


def tree_map(fn, tree: Dict, prefix: str = "") -> Dict:
    """`tree` with every leaf replaced by fn(path, leaf)."""
    return {k: tree_map(fn, v, f"{prefix}/{k}" if prefix else str(k)) if isinstance(v, dict)
            else fn(f"{prefix}/{k}" if prefix else str(k), v) for k, v in tree.items()}


def tree_get(tree: Dict, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


class MeshTree:
    """A tree of tensors placed on a mesh, the role of a JAX pytree of
    arrays under NamedShardings: `specs` is the tree of each leaf's spec,
    `shards[p]` the tree of mesh position p's blocks, each a tensor of its
    own on `mesh.devices[p]` (so that a replica's gradient lands on it
    alone)."""

    def __init__(self, mesh: Mesh, specs: Dict, shards: List[Dict]):
        self.mesh, self.specs, self.shards = mesh, specs, shards

    def leaves(self, path: str) -> List[torch.Tensor]:
        """Leaf `path` at every position."""
        return [tree_get(s, path) for s in self.shards]

    def gather(self, device=None) -> Dict:
        """The global tree (detached), each leaf on `device` (None: the
        first position's)."""
        return tree_map(lambda path, spec: unshard_tensor(
            [x.detach() for x in self.leaves(path)], self.mesh, spec, device), self.specs)


def param_shardings(params: Dict, mesh: Mesh, rules=None) -> MeshTree:
    """`params` placed on every position of `mesh` by `rules` (None:
    `transformer_param_rules()`), the guard applied: each position's
    leaves are fresh tensors (detached copies) on its device."""
    specs = param_partition_specs(params, mesh, rules or transformer_param_rules())
    per_leaf = {path: [y.detach().clone() for y in shard_tensor(tree_get(params, path), mesh,
                                                                 spec)]
                for path, spec in tree_leaves(specs)}
    shards = [tree_map(lambda path, _: per_leaf[path][p], specs)
              for p in range(len(mesh.devices))]
    return MeshTree(mesh, specs, shards)
