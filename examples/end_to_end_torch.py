"""End to end on the PyTorch/CUDA port (`nos_tpu_torch`): carve a TPU mesh,
schedule a workload onto it, build the mesh from the carve, train, and
serve. The port's counterpart of `examples/end_to_end.py`, act for act.

    python examples/end_to_end_torch.py                # on the CUDA card
    python examples/end_to_end_torch.py --device cpu   # the kernels' plain versions

The control plane runs in-process over the cluster bus; the workload plane
runs on one device standing in for the carved sub-slice's eight chips:
the 2x4 mesh lists that device eight times (`["cuda:0"] * 8`, or
`["cpu"] * 8`), and its positions run one after another.

    1. control plane: a pod asking for a connected 2x4 sub-slice fails to
       schedule, the partitioner carves the node's mesh, the agent applies
       and reports, the pod binds.
    2. workload plane: the "pod" builds its dp x tp mesh from the carve's
       topology and runs five sharded training steps of a GPT with head_dim
       16 in bf16 (the flash kernels at head_dim 16, zero-padded to 64)
       with mesh-prefetched input.
    3. serving: the trained params, gathered from the mesh, serve through
       the continuous-batching DecodeServer (the paged window kernel on the
       prefill, the paged decode kernel on every decode step).

Each act is a function of a config and a device, so a test can run them;
`main()` runs the reference's configuration.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from nos_tpu_torch import constants  # noqa: E402
from nos_tpu_torch.api.objects import (  # noqa: E402
    Container, Node, NodeStatus, ObjectMeta, Pod, PodSpec)
from nos_tpu_torch.api.resources import ResourceList  # noqa: E402
from nos_tpu_torch.device import resolve  # noqa: E402
from nos_tpu_torch.models.data import prefetch_to_mesh, synthetic_token_stream  # noqa: E402
from nos_tpu_torch.models.gpt import GPTConfig  # noqa: E402
from nos_tpu_torch.models.train import (TrainConfig, init_train_state,  # noqa: E402
                                        make_optimizer, make_train_step)
from nos_tpu_torch.parallel.mesh import Mesh, canonical_device, mesh_from_topology  # noqa: E402
from nos_tpu_torch.parallel.sharding import MeshTree, batch_sharding, param_shardings  # noqa: E402
from nos_tpu_torch.runtime.decode_server import DecodeServer  # noqa: E402
from nos_tpu_torch.system import ControlPlane  # noqa: E402
from nos_tpu_torch.tpu import Topology  # noqa: E402

# The reference's model (examples/end_to_end.py:96-98): head_dim 64 / 4 = 16.
MODEL = GPTConfig(vocab=128, hidden=64, layers=2, heads=4, max_seq=32)
BATCH, SEQ, STEPS = 8, 32, 5
PROMPT, MAX_NEW = [1, 2, 3, 4], 8


def carve_and_bind(say=print) -> Dict:
    """Act 1 (examples/end_to_end.py:47-90): `tpu-node-0`, a v5e 4x4,
    gets a pod asking for `google.com/tpu-2x4`; the scheduler marks it
    Unschedulable, and after the +61 s batch window the partitioner
    carves, the agent applies and the pod binds. -> {"node": the pod's
    node, "phase": its phase, "carved": the node's allocatable
    `google.com/tpu-*` resources}."""

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Clock()
    plane = ControlPlane(now=clock).start()
    plane.cluster.create(
        Node(
            metadata=ObjectMeta(
                name="tpu-node-0",
                labels={
                    constants.LABEL_PARTITIONING: constants.KIND_TPU,
                    constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                    constants.LABEL_TPU_TOPOLOGY: "4x4",
                },
            ),
            status=NodeStatus(allocatable=ResourceList.of({"cpu": 64, "google.com/tpu": 16})),
        )
    )
    plane.add_tpu_agent("tpu-node-0")
    plane.cluster.create(
        Pod(
            metadata=ObjectMeta(name="train-job", namespace="ml"),
            spec=PodSpec(
                containers=[Container(resources=ResourceList.of({"google.com/tpu-2x4": 1}))],
                scheduler_name=constants.SCHEDULER_NAME,
            ),
        )
    )
    plane.scheduler.schedule_pending()  # -> Unschedulable, batched
    clock.t += 61
    plane.tick()
    pod = plane.cluster.get("Pod", "ml", "train-job")
    node = plane.cluster.get("Node", "", "tpu-node-0")
    carved = {k: v for k, v in node.status.allocatable.items() if "tpu-" in k}
    say(f"pod bound to {pod.spec.node_name} ({pod.status.phase})")
    say(f"carved: {carved}")
    return {"node": pod.spec.node_name, "phase": pod.status.phase, "carved": carved}


def carve_mesh(device, topology: str = "2x4") -> Mesh:
    """The job's dp x tp mesh from its carve's topology
    (examples/end_to_end.py:93-95): one position per chip, each on
    `device`."""
    topo = Topology.parse("v5e", topology)
    return mesh_from_topology(topo, ("dp", "tp"), devices=[canonical_device(device)] * topo.chips)


def train_on_mesh(cfg: TrainConfig, mesh: Mesh, params: Optional[Dict] = None,
                  steps: int = STEPS, batch: int = BATCH, seq: int = SEQ,
                  say=print):
    """Act 2 (examples/end_to_end.py:96-103): `steps` sharded train steps
    over `mesh`, fed by `prefetch_to_mesh(synthetic_token_stream(...))`
    split on dp. `params`, a global param tree, starts the run (a test
    carries the reference's across); None draws them from seed 0. ->
    (the MeshTree of trained params, the losses as floats)."""
    if params is None:
        params, opt = init_train_state(cfg, torch.Generator().manual_seed(0), mesh=mesh)
    else:
        params = param_shardings(params, mesh)
        opt = make_optimizer(cfg, params)
    step = make_train_step(cfg, mesh)
    stream = synthetic_token_stream(cfg.model.vocab, batch=batch, seq=seq, steps=steps)
    losses = []
    for i, tokens in enumerate(prefetch_to_mesh(stream, mesh, batch_sharding(mesh, "dp"),
                                                size=2)):
        params, opt, metrics = step(params, opt, tokens)
        losses.append(float(metrics["loss"]))
        say(f"train step {i}: loss={losses[-1]:.4f}")
    return params, losses


def serve_trained(params: MeshTree, model: GPTConfig, device,
                  prompt: Sequence[int] = PROMPT, max_new: int = MAX_NEW,
                  say=print) -> List[int]:
    """Act 3 (examples/end_to_end.py:105-112): the trained params gathered
    from the mesh (`MeshTree.gather`) serve `prompt` for `max_new` tokens
    through `DecodeServer(..., n_slots=2, max_len=32)`. -> the tokens."""
    server = DecodeServer(params.gather(), model, n_slots=2, max_len=32,
                          device=canonical_device(device)).start()
    try:
        out = [int(t) for t in server.generate(list(prompt), max_new=max_new, timeout=300)]
    finally:
        server.stop()
    say(f"served tokens: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a CUDA device) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device, "examples/end_to_end_torch.py")
    bound = carve_and_bind()
    assert bound["node"] == "tpu-node-0"
    mesh = carve_mesh(device)
    params, _ = train_on_mesh(TrainConfig(model=MODEL), mesh)
    serve_trained(params, MODEL, device)
    print("end-to-end OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
