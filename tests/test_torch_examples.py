"""The port's entry points outside the package on the CPU:
examples/end_to_end_torch.py against the same steps through the JAX package,
and examples/sharing-comparison/{run_local,serve,client}_torch.py.

The end-to-end example's three acts: the control plane's carve and bind
(the pod's node and phase and the carved resources equal the JAX
package's), five dp 2 x tp 4 train steps on the 2x4 carve (the JAX side on
the 8 virtual CPU devices of tests/conftest.py, the port on `["cpu"] * 8`;
f32, JAX's `init_train_state(PRNGKey(0), ...)` params carried across with
`from_numpy_params`; each loss within rtol 1e-5, the bound
tests/test_torch_sharded_train.py pins for its dp x tp steps) and the
trained params served through `DecodeServer` (the same 8 greedy tokens).
The sharing demo on its `--tiny` model (bf16): both modes of
`run_local_torch` in-process and the HTTP server on port 0 with the
closed-loop client, every served result held against the image's
`vit_detect` alone within chip_smoke.py's bf16 VIT_TOL."""

import dataclasses
import importlib.util
import json
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import test_torch_fleet_parity as fp
import torch_mirror

REPO = Path(__file__).resolve().parent.parent
SHARING = REPO / "examples" / "sharing-comparison"

_time_limit = fp.time_limit(120)
_reset_state = torch_mirror.reset_state()


def _load(path, name):
    """A script of the repo as a module (its directory has a hyphen)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _end_to_end():
    return _load(REPO / "examples" / "end_to_end_torch.py", "end_to_end_torch")


# -- examples/end_to_end_torch.py ----------------------------------------------
def _jax_carve():
    """examples/end_to_end.py:47-90 through the JAX package: -> the pod's
    node and phase and the node's carved `google.com/tpu-*` resources."""
    from nos_tpu import constants
    from nos_tpu.api.objects import Container, Node, NodeStatus, ObjectMeta, Pod, PodSpec
    from nos_tpu.api.resources import ResourceList
    from nos_tpu.system import ControlPlane

    clock = [0.0]
    plane = ControlPlane(now=lambda: clock[0]).start()
    plane.cluster.create(Node(
        metadata=ObjectMeta(name="tpu-node-0", labels={
            constants.LABEL_PARTITIONING: constants.KIND_TPU,
            constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
            constants.LABEL_TPU_TOPOLOGY: "4x4"}),
        status=NodeStatus(allocatable=ResourceList.of({"cpu": 64, "google.com/tpu": 16}))))
    plane.add_tpu_agent("tpu-node-0")
    plane.cluster.create(Pod(
        metadata=ObjectMeta(name="train-job", namespace="ml"),
        spec=PodSpec(
            containers=[Container(resources=ResourceList.of({"google.com/tpu-2x4": 1}))],
            scheduler_name=constants.SCHEDULER_NAME)))
    plane.scheduler.schedule_pending()
    clock[0] += 61
    plane.tick()
    pod = plane.cluster.get("Pod", "ml", "train-job")
    node = plane.cluster.get("Node", "", "tpu-node-0")
    return {"node": pod.spec.node_name, "phase": pod.status.phase,
            "carved": {k: v for k, v in node.status.allocatable.items() if "tpu-" in k}}


def _jax_train_and_serve(cfg, steps):
    """examples/end_to_end.py:93-112 through the JAX package on the 8
    virtual CPU devices, f32 -> (initial params as numpy, losses, served
    tokens)."""
    from nos_tpu.models import data as jdata
    from nos_tpu.models import train as jtrain
    from nos_tpu.parallel.mesh import mesh_from_topology
    from nos_tpu.runtime.decode_server import DecodeServer
    from nos_tpu.tpu import Topology

    topo = Topology.parse("v5e", "2x4")
    mesh = mesh_from_topology(topo, ("dp", "tp"), devices=jax.devices()[: topo.chips])
    params, opt_state = jtrain.init_train_state(jax.random.PRNGKey(0), cfg, mesh)
    start = jax.tree_util.tree_map(np.asarray, params)
    step = jtrain.make_train_step(cfg, mesh)
    stream = jdata.synthetic_token_stream(cfg.model.vocab, batch=8, seq=32, steps=steps)
    losses = []
    for batch in jdata.prefetch_to_mesh(stream, mesh, P("dp", None), size=2):
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    server = DecodeServer(params, cfg.model, n_slots=2, max_len=32).start()
    try:
        tokens = [int(t) for t in server.generate([1, 2, 3, 4], max_new=8, timeout=300)]
    finally:
        server.stop()
    return start, losses, tokens


def test_end_to_end_acts_match_the_jax_package():
    from nos_tpu.models import gpt as jgpt
    from nos_tpu.models import train as jtrain
    from nos_tpu_torch.models.params import from_numpy_params
    from nos_tpu_torch.models.train import TrainConfig

    ex = _end_to_end()
    said = []
    bound = ex.carve_and_bind(say=said.append)
    assert bound == _jax_carve()
    assert bound["node"] == "tpu-node-0" and bound["carved"] == {"google.com/tpu-2x4": 1}
    assert said[0] == "pod bound to tpu-node-0 (Running)"

    model = ex.MODEL
    assert (model.vocab, model.hidden, model.layers, model.heads, model.max_seq,
            model.head_dim) == (128, 64, 2, 4, 32, 16)
    jmodel = jgpt.GPTConfig(vocab=128, hidden=64, layers=2, heads=4, max_seq=32,
                            dtype="float32")
    start, jlosses, jtokens = _jax_train_and_serve(jtrain.TrainConfig(model=jmodel), ex.STEPS)

    tmodel = dataclasses.replace(model, dtype="float32")
    mesh = ex.carve_mesh("cpu")
    assert mesh.shape == {"dp": 2, "tp": 4} and [str(d) for d in mesh.devices] == ["cpu"] * 8
    params, losses = ex.train_on_mesh(TrainConfig(model=tmodel), mesh,
                                      params=from_numpy_params(start, tmodel, device="cpu"),
                                      say=said.append)
    assert len(losses) == ex.STEPS and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    tokens = ex.serve_trained(params, tmodel, "cpu", say=said.append)
    assert tokens == jtokens and len(tokens) == 8
    assert said[-1] == f"served tokens: {tokens}"


def test_end_to_end_main_runs_on_the_cpu_and_needs_cuda_by_default(capsys):
    ex = _end_to_end()
    assert ex.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["pod bound to tpu-node-0 (Running)",
                       "carved: {'google.com/tpu-2x4': 1.0}"]
    assert [line.split(":")[0] for line in out[2:7]] == [f"train step {i}" for i in range(5)]
    assert out[7].startswith("served tokens: [") and out[-1] == "end-to-end OK"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex.main([])


# -- examples/sharing-comparison/*_torch.py ------------------------------------
def _run_local():
    return _load(SHARING / "run_local_torch.py", "run_local_torch")


def test_run_local_keeps_the_reference_table():
    reference = _load(SHARING / "run_local.py", "sharing_run_local_reference")
    port = _run_local()
    assert port.REFERENCE == reference.REFERENCE
    assert (port.WARMUP_REQUESTS, port.MEASURE_REQUESTS) == (
        reference.WARMUP_REQUESTS, reference.MEASURE_REQUESTS)


def _alone(cfg, params, image):
    from nos_tpu_torch.models.vit import vit_detect

    return [x[0] for x in vit_detect(params, image[None], cfg)]


# A served result against its image alone (bucket 1), chip_smoke.py's
# VIT_TOL for bf16: a batch rounds its bf16 matmuls in another order than a
# lone image, so scores and boxes are held within 2e-3 (about one bf16 step
# of a logit through the softmax and the sigmoid) and labels equal wherever
# the top-2 class logits differ by more than one bf16 step.
VIT_TOL_BF16 = 2e-3


def _held_alone(cfg, params, image, got):
    from nos_tpu_torch.models.vit import vit_forward

    labels, scores, boxes = _alone(cfg, params, image)
    top = vit_forward(params, image[None], cfg)[0][0, :, :-1].float().topk(2, dim=-1).values
    step = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(
        top[:, 0].abs().clamp_min(torch.finfo(torch.float32).tiny))))
    decided = (top[:, 0] - top[:, 1]) > step
    assert torch.equal(got[0][decided], labels[decided])
    assert (got[1] - scores).abs().max().item() <= VIT_TOL_BF16
    assert (got[2] - boxes).abs().max().item() <= VIT_TOL_BF16


@pytest.mark.parametrize("mode", ["shared", "sequential"])
def test_run_local_tiny_sweep_on_the_cpu(monkeypatch, capsys, mode):
    rl = _run_local()
    points = []
    run_point = rl.run_point

    def recorded(cfg, params, n, mode_, device):
        points.append((cfg, params, run_point(cfg, params, n, mode_, device)))
        return points[-1][2]

    monkeypatch.setattr(rl, "run_point", recorded)
    assert rl.main(["--tiny", "--workloads", "3", "--mode", mode, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "card: none (cpu)" and out[1] == f"device: cpu | mode: {mode}"
    assert "A100" in out[2] and out[3].split()[0] == "3"
    assert out[3].split()[2:] == ["0.1640s", "0.3413s", "0.2931s"]
    (cfg, params, point), = points
    assert point["requests_served"] == 3 * (rl.WARMUP_REQUESTS + rl.MEASURE_REQUESTS)
    if mode == "sequential":
        assert point["requests_per_batch"] == 1.0
    for image, results in zip(point["images"], point["results"]):
        assert len(results) == rl.MEASURE_REQUESTS
        for got in results:
            _held_alone(cfg, params, image, got)


def _get(url, data=None):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


def test_serve_and_client_on_the_cpu():
    from nos_tpu_torch.models.vit import ViTConfig

    serve = _load(SHARING / "serve_torch.py", "serve_torch")
    client = _load(SHARING / "client_torch.py", "client_torch")
    make_image = _run_local().make_image
    cfg = ViTConfig(image_size=32, patch_size=16, hidden=64, layers=1, heads=2, det_tokens=5)
    httpd = serve.make_server(0, cfg=cfg, device="cpu", max_batch=4, host="127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        from nos_tpu_torch.models.vit import init_vit

        params = init_vit(cfg, torch.Generator().manual_seed(0), device="cpu")
        for seed in (0, 1, 7):
            got = json.loads(_get(url + "/infer", json.dumps({"seed": seed}).encode()))
            assert got["latency_s"] > 0
            _held_alone(cfg, params, make_image(cfg, seed, "cpu"),
                        [torch.tensor(got[k]) for k in ("labels", "scores", "boxes")])
        text = _get(url + "/metrics").decode()
        assert "sharing_demo_requests_total 3" in text
        assert client.main(["--server", url, "--count", "3", "--report", "3",
                            "--metrics-port", "0", "--seed", "5"]) == 0
        assert "sharing_demo_requests_total 6" in _get(url + "/metrics").decode()
        assert httpd.slice_server.requests_served == 6
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.slice_server.stop()
        thread.join(timeout=10)
