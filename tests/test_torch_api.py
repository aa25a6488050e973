"""The port's object-model layer (`nos_tpu_torch/api/`, `constants.py`)
against the JAX package's: the cases of tests/test_resources.py (:22-66),
tests/test_scheduler_args.py (:25-62, :108-129) and tests/test_annotations.py
that need only `api/` and `cluster/`, each run on both packages; every
constant of the reference present in the port with an equal value; the
quota webhooks in process and across packages over HTTP
(`cluster/webhook_server.py` behind `cluster/apiserver.py`)."""

import http.client
import importlib
import json
import re
import types

import pytest

import test_torch_fleet_parity as fp

PACKAGES = ("nos_tpu", "nos_tpu_torch")

_time_limit = fp.time_limit(60)


def load(pkg):
    m = types.SimpleNamespace(pkg=pkg)
    m.constants = importlib.import_module(f"{pkg}.constants")
    m.o = importlib.import_module(f"{pkg}.api.objects")
    m.q = importlib.import_module(f"{pkg}.api.quota_types")
    m.r = importlib.import_module(f"{pkg}.api.resources")
    m.ann = importlib.import_module(f"{pkg}.api.annotations")
    m.sa = importlib.import_module(f"{pkg}.api.scheduler_args")
    m.wh = importlib.import_module(f"{pkg}.api.webhooks")
    m.c = importlib.import_module(f"{pkg}.cluster.client")
    m.s = importlib.import_module(f"{pkg}.cluster.serialize")
    return m


@pytest.fixture(params=PACKAGES)
def p(request):
    return load(request.param)


# -- constants ----------------------------------------------------------------
def test_every_reference_constant_is_in_the_port_with_an_equal_value():
    """The control plane's and the serving plane's wire protocol: every
    public name of nos_tpu.constants (modules and `__future__` features
    aside), compiled regexes compared by pattern, functions by their
    answers on every partitioning kind."""
    ref = importlib.import_module("nos_tpu.constants")
    port = importlib.import_module("nos_tpu_torch.constants")
    checked = 0
    for name, want in vars(ref).items():
        if name.startswith("_") or isinstance(want, types.ModuleType) or name == "annotations":
            continue
        assert hasattr(port, name), name
        got = getattr(port, name)
        if isinstance(want, re.Pattern):
            assert isinstance(got, re.Pattern) and got.pattern == want.pattern, name
        elif callable(want):
            for kind in ref.PARTITIONING_KINDS:
                assert got(kind) == want(kind), (name, kind)
        else:
            assert got == want, name
        checked += 1
    assert checked > 200
    assert port.RESOURCE_TPU == "google.com/tpu" and port.DOMAIN == "tpu.nos"


# -- resources (test_resources.py:22-66) --------------------------------------
@pytest.mark.parametrize(
    "raw,expected",
    [("500m", 0.5), ("2", 2.0), (3, 3.0), ("1Gi", 2**30), ("10G", 10e9), ("1.5", 1.5),
     ("250m", 0.25), ("2Ki", 2048.0)],
)
def test_parse_quantity(p, raw, expected):
    assert p.r.parse_quantity(raw) == pytest.approx(expected)


def test_resource_list_arithmetic(p):
    RL = p.r.ResourceList
    a = RL.of({"cpu": "1", "google.com/tpu": 4})
    b = RL.of({"cpu": "500m", "google.com/tpu": 6})
    assert a.add(b) == {"cpu": 1.5, "google.com/tpu": 10}
    assert a.subtract(b) == {"cpu": 0.5, "google.com/tpu": -2}
    assert a.subtract_non_negative(b) == {"cpu": 0.5}
    assert a.subtract(b).negatives() == {"google.com/tpu": -2}
    assert a.subtract(b).abs() == {"cpu": 0.5, "google.com/tpu": 2}


def test_resource_list_equality_ignores_zero_entries(p):
    RL = p.r.ResourceList
    assert RL.of({"cpu": 1, "x": 0}) == RL.of({"cpu": 1})
    assert RL.of({"cpu": 1}) != RL.of({"cpu": 2})


def test_fits_in(p):
    RL = p.r.ResourceList
    cap = RL.of({"cpu": 4, "google.com/tpu-2x2": 2})
    assert RL.of({"cpu": 2, "google.com/tpu-2x2": 2}).fits_in(cap)
    assert not RL.of({"google.com/tpu-2x2": 3}).fits_in(cap)
    assert not RL.of({"nvidia.com/gpu": 1}).fits_in(cap)


def test_compute_pod_request_max_of_init_and_sum_of_containers(p):
    RL, o = p.r.ResourceList, p.o
    pod = o.Pod(spec=o.PodSpec(
        containers=[o.Container(resources=RL.of({"cpu": 1, "memory": "1Gi"})),
                    o.Container(resources=RL.of({"cpu": 2}))],
        init_containers=[o.Container(resources=RL.of({"cpu": 5})),
                         o.Container(resources=RL.of({"memory": "4Gi"}))],
        overhead=RL.of({"cpu": "100m"}),
    ))
    req = p.r.compute_pod_request(pod)
    assert req["cpu"] == pytest.approx(5.1)  # max(init 5, sum 3) + overhead
    assert req["memory"] == pytest.approx(4 * 2**30)


# -- scheduler plugin args (test_scheduler_args.py:25-62, :108-129) -----------
def _doc(p, **fields):
    return {"apiVersion": p.sa.V1BETA3, "kind": p.sa.KIND_CAPACITY, **fields}


def test_decode_with_overrides(p):
    args = p.sa.decode_plugin_args(_doc(p, nvidiaGpuResourceMemoryGB=40, tpuChipMemoryGB=32))
    assert args == p.sa.CapacitySchedulingArgs(40.0, 32.0)


def test_defaulting_fills_unset_pointers(p):
    args = p.sa.decode_plugin_args(_doc(p, nvidiaGpuResourceMemoryGB=24))
    assert args.nvidia_gpu_resource_memory_gb == 24.0
    assert args.tpu_chip_memory_gb == p.constants.DEFAULT_TPU_CHIP_MEMORY_GB
    assert p.sa.decode_plugin_args(_doc(p)) == p.sa.CapacitySchedulingArgs()


def test_unknown_field_rejected(p):
    with pytest.raises(p.sa.PluginArgsError, match="unknown field"):
        p.sa.decode_plugin_args(_doc(p, nvidiaGpuMemoryGB=40))  # typo'd name


def test_unknown_version_or_kind_rejected_with_supported_set(p):
    with pytest.raises(p.sa.PluginArgsError, match="supported"):
        p.sa.decode_plugin_args({"apiVersion": "kubescheduler.config.k8s.io/v1beta2",
                                 "kind": p.sa.KIND_CAPACITY})
    with pytest.raises(p.sa.PluginArgsError, match="supported"):
        p.sa.decode_plugin_args(_doc(p) | {"kind": "ElasticQuotaArgs"})


def test_invalid_values_rejected(p):
    with pytest.raises(p.sa.PluginArgsError, match="positive"):
        p.sa.decode_plugin_args(_doc(p, tpuChipMemoryGB=0))
    with pytest.raises(p.sa.PluginArgsError, match="not a number"):
        p.sa.decode_plugin_args(_doc(p, tpuChipMemoryGB="lots"))


def test_round_trip(p):
    args = p.sa.CapacitySchedulingArgs(80.0, 16.0)
    assert p.sa.decode_plugin_args(p.sa.encode_plugin_args(args)) == args


def test_bool_rejected_as_number(p):
    """The wire type is *int64: `true` must be a decode error, though
    Python's bool subclasses int."""
    with pytest.raises(p.sa.PluginArgsError, match="not a number"):
        p.sa.decode_plugin_args(_doc(p, tpuChipMemoryGB=True))
    with pytest.raises(p.sa.PluginArgsError, match="not a number"):
        p.sa.decode_plugin_args(_doc(p, nvidiaGpuResourceMemoryGB=False))


def test_non_finite_rejected(p):
    with pytest.raises(p.sa.PluginArgsError, match="not finite"):
        p.sa.decode_plugin_args(_doc(p, tpuChipMemoryGB=float("inf")))
    with pytest.raises(p.sa.PluginArgsError, match="not finite"):
        p.sa.decode_plugin_args(_doc(p, tpuChipMemoryGB=float("nan")))


def test_string_rejected_as_number(p):
    with pytest.raises(p.sa.PluginArgsError, match="not a number"):
        p.sa.decode_plugin_args(_doc(p, tpuChipMemoryGB="32"))


def test_plugin_args_encode_equal_across_packages():
    ref, port = load("nos_tpu"), load("nos_tpu_torch")
    for fields in ({}, {"nvidiaGpuResourceMemoryGB": 40}, {"tpuChipMemoryGB": 24}):
        want = ref.sa.encode_plugin_args(ref.sa.decode_plugin_args(_doc(ref, **fields)))
        got = port.sa.encode_plugin_args(port.sa.decode_plugin_args(_doc(port, **fields)))
        assert got == want


# -- annotations (the cases of test_annotations.py without a tpu.Profile) -----
def test_parse_ignores_foreign_annotations(p):
    d = {
        "tpu.nos/spec-dev-0-2x2": "1",
        "tpu.nos/status-dev-0-2x2-free": "1",
        "tpu.nos/status-dev-0-2x2-used": "0",
        "kubernetes.io/something": "x",
        "tpu.nos/spec-partitioning-plan": "42",
    }
    assert len(p.ann.parse_spec(d)) == 1
    assert len(p.ann.parse_status(d)) == 2


def test_plan_handshake(p):
    annotations = {}
    assert p.ann.node_reported_last_plan(annotations)  # no spec -> nothing owed
    annotations[p.constants.ANNOTATION_SPEC_PLAN] = "plan-7"
    assert not p.ann.node_reported_last_plan(annotations)
    annotations[p.constants.ANNOTATION_STATUS_PLAN] = "plan-6"
    assert not p.ann.node_reported_last_plan(annotations)
    annotations[p.constants.ANNOTATION_STATUS_PLAN] = "plan-7"
    assert p.ann.node_reported_last_plan(annotations)


def test_strip_annotations(p):
    d = {"tpu.nos/spec-dev-0-2x2": "1", "tpu.nos/status-dev-0-2x2-free": "1", "other": "keep"}
    p.ann.strip_spec_annotations(d)
    assert "tpu.nos/spec-dev-0-2x2" not in d and "other" in d
    p.ann.strip_status_annotations(d)
    assert d == {"other": "keep"}


def test_parsed_annotations_equal_across_packages():
    d = {
        "tpu.nos/spec-dev-0-2x2": "2", "tpu.nos/spec-dev-1-1x1": "3",
        "tpu.nos/status-dev-0-2x2-free": "1", "tpu.nos/status-dev-0-2x2-used": "1",
        "tpu.nos/status-dev-1-1x1-free": "3", "kubernetes.io/something": "x",
    }
    ref, port = load("nos_tpu").ann, load("nos_tpu_torch").ann

    def plain(items):
        return sorted(tuple(sorted(vars(x).items())) for x in items)

    assert plain(port.parse_spec(d)) == plain(ref.parse_spec(d))
    assert plain(port.parse_status(d)) == plain(ref.parse_status(d))
    assert port.format_spec(port.parse_spec(d)) == ref.format_spec(ref.parse_spec(d))
    assert port.format_status(port.parse_status(d)) == ref.format_status(ref.parse_status(d))
    assert (port.geometry_counts_from_status(port.parse_status(d))
            == ref.geometry_counts_from_status(ref.parse_status(d)))


# -- quota webhooks -------------------------------------------------------------
def quota(p, name, ns, lo, hi=None):
    RL = p.r.ResourceList
    return p.q.ElasticQuota(metadata=p.o.ObjectMeta(name=name, namespace=ns),
                            spec=p.q.ElasticQuotaSpec(
                                min=RL.of({"google.com/tpu": lo}),
                                max=None if hi is None else RL.of({"google.com/tpu": hi})))


def test_quota_webhooks_in_process(p):
    c = p.c.Cluster()
    p.wh.install_quota_webhooks(c)
    c.create(quota(p, "eq", "team-a", 2, 4))
    with pytest.raises(p.c.AdmissionError, match="exceeds max"):
        c.create(quota(p, "bad", "team-b", 8, 4))
    with pytest.raises(p.c.AdmissionError, match="already has ElasticQuota"):
        c.create(quota(p, "second", "team-a", 1))
    ceq = p.q.CompositeElasticQuota(
        metadata=p.o.ObjectMeta(name="ceq", namespace="default"),
        spec=p.q.CompositeElasticQuotaSpec(namespaces=["team-a", "team-c"]))
    c.create(ceq)
    with pytest.raises(p.c.AdmissionError, match="claimed by CompositeElasticQuota"):
        c.create(quota(p, "eq", "team-c", 1))
    assert [x.metadata.name for x in c.list("ElasticQuota")] == ["eq"]


@pytest.mark.parametrize("emulator_pkg,hook_pkg", [
    ("nos_tpu", "nos_tpu"), ("nos_tpu", "nos_tpu_torch"), ("nos_tpu_torch", "nos_tpu"),
    ("nos_tpu_torch", "nos_tpu_torch")])
def test_remote_quota_webhook_across_packages(emulator_pkg, hook_pkg):
    """An emulator of one package forwards ElasticQuota writes as
    AdmissionReview v1 POSTs to the other's webhook server: the same
    verdicts and messages in every pairing."""
    e, h = load(emulator_pkg), load(hook_pkg)
    api = importlib.import_module(f"{emulator_pkg}.cluster.apiserver")
    ws = importlib.import_module(f"{hook_pkg}.cluster.webhook_server")
    hooks = h.c.Cluster()
    h.wh.install_quota_webhooks(hooks)
    hook_server = ws.AdmissionWebhookServer(hooks._webhooks).start()
    server = api.ClusterAPIServer().start()
    conn = http.client.HTTPConnection("127.0.0.1", server._httpd.server_address[1], timeout=10)
    try:
        server.add_remote_webhook("ElasticQuota", hook_server.url)
        path = "/apis/tpu.nos/v1alpha1/namespaces/team-a/elasticquotas"
        out = []
        for q in (quota(e, "ok", "team-a", 2, 4), quota(e, "bad", "team-a", 8, 4)):
            conn.request("POST", path, body=json.dumps(e.s.to_wire(q)),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            out.append((resp.status, body.get("kind"), body.get("message")))
        assert out[0][:2] == (201, "ElasticQuota")
        assert out[1][0] >= 400 and "exceeds max" in out[1][2]
        assert [x.metadata.name for x in server.cluster.list("ElasticQuota")] == ["ok"]
    finally:
        conn.close()
        server.stop()
        hook_server.stop()
