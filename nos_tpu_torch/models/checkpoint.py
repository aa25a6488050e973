"""Checkpoint and resume of a training job's params and optimizer state.

Port of `nos_tpu/models/checkpoint.py`: `save_checkpoint` (:38),
`latest_step` (:70) and `restore_checkpoint` (:82), with the `step_N`
directory layout. The reference writes with Orbax when it is importable
and an `.npz` otherwise; the port has one codec, `torch.save` of one
`state.pt` a step, which keeps every dtype (bfloat16 included) bit for
bit. What is saved is global: the params tree and the AdamW state of
`models/train.py` as trees of the same shape (`exp_avg`, `exp_avg_sq`)
and its step count, gathered from a mesh's positions when the job ran on
one. A restore casts each leaf to the dtype of `like`'s, places the params
on `like`'s device or, with a mesh, on every position by the sharding rules
(`param_shardings`), and builds `like`'s optimizer over them with the moments
placed the same way, so a job rescheduled onto another mesh resumes where
it left off.
"""

from __future__ import annotations

import inspect
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from nos_tpu_torch.parallel.sharding import (MeshTree, param_shardings, shard_tensor,
                                             tree_get, tree_leaves, tree_map, unshard_tensor)

STEP_DIR = re.compile(r"^step_(\d+)$")
STATE = "state.pt"
_MOMENTS = ("exp_avg", "exp_avg_sq")


def _leaf_groups(params):
    """(path, tensors holding the leaf, spec or None) for each leaf."""
    if isinstance(params, MeshTree):
        return [(path, params.leaves(path), spec) for path, spec in tree_leaves(params.specs)]
    return [(path, [leaf], None) for path, leaf in tree_leaves(params)]


def _global_tree(params, value) -> Dict:
    """The global CPU tree of value(tensors holding a leaf) over every
    leaf of `params` (every position's tensors on a mesh)."""
    def one(path, tensors, spec):
        got = [value(t).detach() for t in tensors]
        if spec is None:
            return got[0].cpu()
        return unshard_tensor(got, params.mesh, spec, "cpu")

    groups = {path: (tensors, spec) for path, tensors, spec in _leaf_groups(params)}
    shape = params.specs if isinstance(params, MeshTree) else params
    return tree_map(lambda path, _: one(path, *groups[path]), shape)


def save_checkpoint(directory: str, step: int, params, opt_state) -> str:
    """Write params + optimizer state for `step` under
    `directory/step_{step}`. Returns the step path. The AdamW state is
    {"step", "exp_avg", "exp_avg_sq"} as global trees, or None before the
    first step."""
    path = os.path.join(directory, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    first = _leaf_groups(params)[0][1][0]
    opt = None
    if opt_state.state.get(first):
        opt = {"step": opt_state.state[first]["step"].detach().cpu().clone()}
        for name in _MOMENTS:
            opt[name] = _global_tree(params, lambda t, name=name: opt_state.state[t][name])
    torch.save({"params": _global_tree(params, lambda t: t), "opt_state": opt},
               os.path.join(path, STATE))
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory) if (m := STEP_DIR.match(name))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int], like: Tuple[Any, Any],
                       mesh=None) -> Tuple[Any, Any, int]:
    """Restore (params, opt_state, step); `step` None means the latest.
    `like` is (params, optimizer) of the target job (a fresh
    `init_train_state`): its leaves give the dtypes and, without a mesh,
    the device, its optimizer the hyperparameters. With a mesh the params
    and moments are placed on it by the sharding rules."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    saved = torch.load(os.path.join(path, STATE), map_location="cpu", weights_only=True)
    like_params, like_opt = like
    like_leaves = {p: ts[0] for p, ts, _ in _leaf_groups(like_params)}
    saved_paths = [p for p, _ in tree_leaves(saved["params"])]
    if sorted(saved_paths) != sorted(like_leaves):
        raise ValueError(f"checkpoint at {path} has leaves {sorted(saved_paths)}, "
                         f"target expects {sorted(like_leaves)}")
    device = next(iter(like_leaves.values())).device

    def cast(p, x):
        return x.to(dtype=like_leaves[p].dtype)

    params = tree_map(cast, saved["params"])
    if mesh is not None:
        params = param_shardings(params, mesh)
    else:
        params = tree_map(lambda p, x: x.to(device), params)
    for _, tensors, _ in _leaf_groups(params):
        for t in tensors:
            t.requires_grad_(True)
    groups = _leaf_groups(params)
    accepted = inspect.signature(type(like_opt).__init__).parameters
    hyper = {k: v for k, v in like_opt.param_groups[0].items() if k in accepted and k != "params"}
    opt = type(like_opt)([t for _, ts, _ in groups for t in ts], **hyper)
    state = saved["opt_state"]
    for leaf_path, tensors, spec in groups if state is not None else ():
        moments = {}
        for name in _MOMENTS:
            value = cast(leaf_path, tree_get(state[name], leaf_path))
            moments[name] = ([value.to(tensors[0].device)] if spec is None
                             else shard_tensor(value, mesh, spec))
        for i, t in enumerate(tensors):
            opt.state[t] = {"step": state["step"].clone(),
                            **{n: moments[n][i].detach().clone() for n in _MOMENTS}}
    return params, opt, step
