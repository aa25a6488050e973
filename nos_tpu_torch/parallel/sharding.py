"""Parameter sharding rules for tensor-parallel decode.

Port of `nos_tpu/parallel/sharding.py`: `decode_param_rules` (:37),
`spec_for_path` (:70), `guarded_spec` (:85), `shard_params` (:117) and
`param_partition_specs` (:135). A spec is a plain tuple of mesh axis names
or None, one entry per leading tensor dimension, in the role of JAX's
`PartitionSpec`; `()` is replicated. Where JAX places one global array on the
mesh, `shard_params` returns one param tree per shard, each leaf contiguous on
its shard's device.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from nos_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]


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
