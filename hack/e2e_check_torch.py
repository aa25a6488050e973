#!/usr/bin/env python
"""The live-cluster e2e assertion on the PyTorch/CUDA port (`nos_tpu_torch`),
a copy of `hack/e2e_check.py` with the port's imports: drive one full
dynamic-partitioning loop against ANY kubeconfig and fail loudly at the
first rung that doesn't climb. It runs no kernel and touches no device.

Scenario (the control-plane loop, no kubelet dependency — works on kind, a
real cluster, or the in-tree API-server emulator, with the controllers
deployed/running externally):

  1. create a synthetic TPU node (partitioning labels + chip allocatable);
  2. create a pending pod requesting a sub-slice (google.com/tpu-2x2);
  3. wait: the scheduler marks it Unschedulable ->
  4. wait: the partitioner writes spec annotations on the node ->
  5. wait: the tpu-agent applies the carve and reports status annotations ->
  6. wait: the scheduler binds the pod to the carved slice.

The same six rungs, arguments, exit codes (0 pass, 1 a rung failed, 2 no
kubeconfig) and `[e2e]` lines as the original. Exercised against the port's
emulator and the port's CLI binaries as subprocesses
(`python -m nos_tpu_torch.cli`; tests/test_torch_e2e_check.py), so the
gate itself is tested logic, not a write-only script.

Usage: NOS_E2E_KUBECONFIG=/path/to/kubeconfig python hack/e2e_check_torch.py
       [--timeout 120] [--keep]  (--keep leaves the objects for inspection)
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import uuid

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nos_tpu_torch import constants  # noqa: E402
from nos_tpu_torch.api.objects import (  # noqa: E402
    Container,
    Node,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
)
from nos_tpu_torch.api.resources import ResourceList  # noqa: E402
from nos_tpu_torch.cluster.kube import KubeCluster  # noqa: E402


def log(msg: str) -> None:
    print(f"[e2e] {msg}", flush=True)


def wait_for(what: str, probe, timeout_s: float, interval_s: float = 1.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = probe()
        if value:
            log(f"OK: {what}")
            return value
        time.sleep(interval_s)
    log(f"FAILED waiting for: {what} (after {timeout_s}s)")
    return None


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--keep", action="store_true")
    parser.add_argument("--node-name", default=f"e2e-tpu-{uuid.uuid4().hex[:6]}")
    parser.add_argument("--namespace", default="default")
    args = parser.parse_args()

    kubeconfig = os.environ.get("NOS_E2E_KUBECONFIG")
    if not kubeconfig:
        log("NOS_E2E_KUBECONFIG is not set")
        return 2
    kube = KubeCluster(kubeconfig_path=kubeconfig)
    node_name = args.node_name
    pod_name = f"{node_name}-pod"

    def cleanup():
        if args.keep:
            log(f"--keep: leaving node/{node_name} and pod/{pod_name}")
            return
        for kind, ns, name in (("Pod", args.namespace, pod_name), ("Node", "", node_name)):
            try:
                kube.delete(kind, ns, name)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    try:
        log(f"1/6 creating synthetic TPU node {node_name} (v5e 4x4, 16 chips)")
        kube.create(
            Node(
                metadata=ObjectMeta(
                    name=node_name,
                    labels={
                        constants.LABEL_PARTITIONING: constants.KIND_TPU,
                        constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                        constants.LABEL_TPU_TOPOLOGY: "4x4",
                    },
                ),
                status=NodeStatus(
                    allocatable=ResourceList.of(
                        {"cpu": 8, "memory": "16Gi", constants.RESOURCE_TPU: 16}
                    )
                ),
            )
        )
        log(f"2/6 creating pending pod {pod_name} requesting google.com/tpu-2x2")
        kube.create(
            Pod(
                metadata=ObjectMeta(name=pod_name, namespace=args.namespace),
                spec=PodSpec(
                    containers=[
                        Container(
                            resources=ResourceList.of({"google.com/tpu-2x2": 1})
                        )
                    ],
                    scheduler_name=constants.SCHEDULER_NAME,
                ),
            )
        )

        def pod():
            return kube.get("Pod", args.namespace, pod_name)

        def node():
            return kube.get("Node", "", node_name)

        if not wait_for(
            "3/6 scheduler marked the pod Unschedulable (or bound it)",
            lambda: pod().spec.node_name
            or any(
                c.type == "PodScheduled" and c.status == "False"
                for c in pod().status.conditions
            ),
            args.timeout,
        ):
            return 1
        if not wait_for(
            "4/6 partitioner wrote spec annotations on the node",
            lambda: any(
                constants.ANNOTATION_SPEC_REGEX.match(k)
                for k in node().metadata.annotations
            ),
            args.timeout,
        ):
            return 1
        if not wait_for(
            "5/6 tpu-agent reported status annotations (carve applied)",
            lambda: any(
                constants.ANNOTATION_STATUS_REGEX.match(k)
                for k in node().metadata.annotations
            ),
            args.timeout,
        ):
            return 1
        bound = wait_for(
            "6/6 scheduler bound the pod to the carved slice",
            lambda: pod().spec.node_name or None,
            args.timeout,
        )
        if not bound:
            return 1
        if bound != node_name:
            log(f"pod bound to unexpected node {bound!r} (expected {node_name})")
            return 1
        log("PASS: full dynamic-partitioning loop")
        return 0
    finally:
        cleanup()
        kube.close()


if __name__ == "__main__":
    sys.exit(main())
