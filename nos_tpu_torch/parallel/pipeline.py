"""Pipeline parallelism over the `pp` mesh axis.

Port of `nos_tpu/parallel/pipeline.py`: `_pipeline_local` (:35) and
`pipeline_apply` (:96), the GPipe schedule. Each pp rank holds one stage
(a contiguous group of layers); M microbatches stream through P stages in
M + P - 1 ticks: at tick t stage 0 ingests microbatch clip(t), every other
stage takes the activation `ring_pass` handed it, and the last stage writes
its result for microbatch t - (P - 1). The last stage's outputs then go to
every rank. The reference's one `shard_map`'d scan becomes a loop over
ticks and, in each, over the ranks of one pp group (the port's single
controller); autograd through the loop and the ring passes gives the
backward pipeline, as JAX's transpose of the program does. A stage whose
microbatch t - s lies outside [0, M) computes nothing here: the reference
computes a value there that never reaches an output.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from nos_tpu_torch.parallel import collectives as col
from nos_tpu_torch.parallel.mesh import Mesh
from nos_tpu_torch.parallel.sharding import shard_tensor, tree_map, unshard_tensor


def _pipeline_local(stage_params: List[Dict], microbatches: List[torch.Tensor],
                    stage_fn: Callable) -> List[torch.Tensor]:
    """The schedule over one pp group: stage_params[s] is stage s's tree
    (on its rank's device), microbatches[s] the [M, mb, ...] stream as rank
    s holds it (only stage 0 reads it). -> [M, mb, ...] outputs on every
    rank."""
    n_stages = len(stage_params)
    m = microbatches[0].shape[0]
    carry = [torch.zeros_like(x[0]) for x in microbatches]
    outputs: List[Optional[torch.Tensor]] = [None] * m
    for t in range(m + n_stages - 1):
        ys = []
        for s in range(n_stages):
            if not 0 <= t - s < m:
                ys.append(torch.zeros_like(carry[s]))
                continue
            x = microbatches[s][min(t, m - 1)] if s == 0 else carry[s]
            y = stage_fn(stage_params[s], x)
            if s == n_stages - 1:
                outputs[t - (n_stages - 1)] = y
            ys.append(y)
        carry = col.ring_pass(ys)
    stacked = torch.stack(outputs)  # type: ignore[arg-type]
    return [stacked.to(x.device) for x in microbatches]


def pipeline_apply(stage_params: Dict, batch: torch.Tensor, stage_fn: Callable, mesh: Mesh,
                   axis_name: str = "pp", n_microbatches: Optional[int] = None) -> torch.Tensor:
    """Run `stage_fn(stage_params, x)` as a pipeline over `axis_name`.

    stage_params: a tree whose leaves have a leading stage axis of size pp
    (sharded over `axis_name`); stage_fn receives one stage's slice.
    batch: [B, ...], split into microbatches (the microbatch rows over "dp"
    when the mesh has it). Returns [B, ...], the final stage's output."""
    pp = mesh.shape[axis_name]
    if n_microbatches is None:
        n_microbatches = pp
    b = batch.shape[0]
    if b % n_microbatches != 0:
        raise ValueError(f"batch {b} not divisible into {n_microbatches} microbatches")
    mb = b // n_microbatches
    microbatches = batch.reshape((n_microbatches, mb) + tuple(batch.shape[1:]))
    dp = "dp" if "dp" in mesh.shape else None
    data_spec = (None, dp)
    placed = tree_map(lambda _, x: shard_tensor(x, mesh, (axis_name,)), stage_params)
    mbs = shard_tensor(microbatches, mesh, data_spec)
    out: List[torch.Tensor] = [None] * len(mbs)  # type: ignore[list-item]
    for group in mesh.groups(axis_name):
        params = [tree_map(lambda _, xs: xs[p][0], placed) for p in group]
        for p, o in zip(group, _pipeline_local(params, [mbs[p] for p in group], stage_fn)):
            out[p] = o
    result = unshard_tensor(out, mesh, data_spec, batch.device)
    return result.reshape((b,) + tuple(result.shape[2:]))
