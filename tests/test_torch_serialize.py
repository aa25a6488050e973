"""The port's wire codec (`nos_tpu_torch/cluster/serialize.py`) against
the JAX package's: the cases of tests/test_serialize.py (randomized
to_wire -> from_wire round trips per kind, quantities, timestamps) on both
packages, and the codec across packages: for every kind in KINDS, equal
objects give equal wire dicts, and each package's from_wire of the other's
output gives back the object it would have built itself."""

import dataclasses
import importlib
import random
import types

import pytest

PACKAGES = ("nos_tpu", "nos_tpu_torch")


def load(pkg):
    m = types.SimpleNamespace(pkg=pkg)
    m.constants = importlib.import_module(f"{pkg}.constants")
    m.o = importlib.import_module(f"{pkg}.api.objects")
    m.q = importlib.import_module(f"{pkg}.api.quota_types")
    m.r = importlib.import_module(f"{pkg}.api.resources")
    m.s = importlib.import_module(f"{pkg}.cluster.serialize")
    return m


@pytest.fixture(params=PACKAGES)
def p(request):
    return load(request.param)


def rand_meta(p, rng, name="obj"):
    # The uid is set, not drawn from the package's own counter, so that
    # objects built in either package agree.
    return p.o.ObjectMeta(
        name=f"{name}-{rng.randrange(1000)}",
        namespace=rng.choice(["", "default", "nos-system"]),
        labels={f"l{i}": f"v{rng.randrange(10)}" for i in range(rng.randrange(3))},
        annotations={
            "tpu.nos/spec-dev-0-1x1": str(rng.randrange(4)),
            "unrelated/key": "kept-verbatim",
        },
        uid=f"uid-{name}-{rng.randrange(10**6)}",
        resource_version=rng.randrange(10**6),
        creation_timestamp=float(rng.randrange(1, 2**31)),
    )


def rand_resources(p, rng):
    return p.r.ResourceList.of(
        {
            "cpu": rng.choice([0.1, 0.25, 1, 2, 64]),
            "memory": rng.choice([128 * 2**20, 2**30, 17 * 2**30]),
            "google.com/tpu": rng.randrange(0, 17),
        }
    )


def build(p, kind, seed):
    """An object of `kind` drawn from random.Random(seed): equal objects in
    either package for one seed."""
    rng = random.Random(seed)
    o, q = p.o, p.q
    if kind == "Pod":
        return o.Pod(
            metadata=rand_meta(p, rng, "pod"),
            spec=o.PodSpec(
                node_name=rng.choice(["", "node-a"]),
                scheduler_name=rng.choice(["", p.constants.SCHEDULER_NAME]),
                priority=rng.randrange(-10, 10),
                containers=[o.Container(name="main", resources=rand_resources(p, rng))],
            ),
            status=o.PodStatus(phase=rng.choice(["Pending", "Running", "Succeeded"])),
        )
    if kind == "Node":
        return o.Node(
            metadata=rand_meta(p, rng, "node"),
            status=o.NodeStatus(
                allocatable=rand_resources(p, rng), capacity=rand_resources(p, rng)
            ),
        )
    if kind == "ElasticQuota":
        return q.ElasticQuota(
            metadata=rand_meta(p, rng, "eq"),
            spec=q.ElasticQuotaSpec(min=rand_resources(p, rng), max=rand_resources(p, rng)),
            status=q.ElasticQuotaStatus(used=rand_resources(p, rng)),
        )
    if kind == "CompositeElasticQuota":
        return q.CompositeElasticQuota(
            metadata=rand_meta(p, rng, "ceq"),
            spec=q.CompositeElasticQuotaSpec(
                namespaces=[f"ns{i}" for i in range(rng.randrange(1, 4))],
                min=rand_resources(p, rng),
                max=rand_resources(p, rng),
            ),
        )
    if kind == "ConfigMap":
        return o.ConfigMap(metadata=rand_meta(p, rng, "cm"), data={"config.yaml": "a: 1\n"})
    if kind == "PodDisruptionBudget":
        return o.PodDisruptionBudget(
            metadata=rand_meta(p, rng, "pdb"),
            spec=o.PodDisruptionBudgetSpec(min_available=2, selector={"app": "x"}),
        )
    if kind == "Lease":
        return o.Lease(
            metadata=rand_meta(p, rng, "lease"),
            spec=o.LeaseSpec(
                holder_identity="op-1",
                lease_duration_seconds=15,
                acquire_time=1000.0,
                renew_time=1010.0,
            ),
        )
    raise AssertionError(f"no factory for {kind}")


def assert_roundtrip(p, obj, kind):
    wire = p.s.to_wire(obj)
    assert wire.get("kind") == kind
    back = p.s.from_wire(wire)
    assert back == obj, f"{kind} round-trip drifted"
    # And the wire form itself is stable (a second encode is identical —
    # no hidden state, no float jitter).
    assert p.s.to_wire(back) == wire


@pytest.mark.parametrize("seed", range(5))
def test_pod_roundtrip(p, seed):
    assert_roundtrip(p, build(p, "Pod", seed), "Pod")


@pytest.mark.parametrize("seed", range(5))
def test_node_roundtrip(p, seed):
    assert_roundtrip(p, build(p, "Node", seed), "Node")


@pytest.mark.parametrize("seed", range(3))
def test_quota_roundtrips(p, seed):
    assert_roundtrip(p, build(p, "ElasticQuota", seed), "ElasticQuota")
    assert_roundtrip(p, build(p, "CompositeElasticQuota", seed), "CompositeElasticQuota")


def test_configmap_pdb_lease_roundtrip(p):
    for kind in ("ConfigMap", "PodDisruptionBudget", "Lease"):
        assert_roundtrip(p, build(p, kind, 0), kind)


def test_every_registered_kind_has_both_directions(p):
    for kind, codec in p.s.KINDS.items():
        assert callable(codec.to_wire) and callable(codec.from_wire), kind
        assert codec.kind == kind and codec.plural, kind


def test_quantity_formats_are_k8s_legal_and_roundtrip(p):
    for v in (0.1, 0.25, 0.5, 1, 2, 3.5, 64, 128 * 2**20, 2**30, 17 * 2**30,
              1500, 0.001, 10**12):
        s = p.s.format_quantity(v)
        assert p.r.parse_quantity(s) == pytest.approx(v, rel=1e-9), (v, s)


def test_timestamp_roundtrip_is_utc_rfc3339(p):
    for ts in (0.0, 1.0, 1_700_000_000.0, 2**31 - 1.0):
        s = p.s.ts_to_wire(ts)
        if ts == 0.0:
            assert s is None  # zero = unset, omitted from the wire
            continue
        assert s.endswith("Z") and "T" in s
        assert p.s.ts_from_wire(s) == ts


def test_resources_wire_sorted_and_stable(p):
    rl = p.r.ResourceList.of({"memory": 2**30, "cpu": 2, "google.com/tpu": 4})
    wire = p.s.resources_to_wire(rl)
    assert list(wire) == sorted(wire)
    assert p.s.resources_from_wire(wire) == rl


def test_kinds_registries_equal_across_packages():
    ref, port = load("nos_tpu"), load("nos_tpu_torch")
    fields = ("kind", "group", "version", "plural", "namespaced", "has_status_subresource",
              "api_prefix")

    def table(s):
        return {k: tuple(getattr(i, f) for f in fields) for k, i in s.KINDS.items()}

    assert table(port.s) == table(ref.s)
    assert sorted(port.s.KINDS_BY_PLURAL) == sorted(ref.s.KINDS_BY_PLURAL)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", sorted(load("nos_tpu").s.KINDS))
def test_wire_equal_across_packages(kind, seed):
    """Equal objects encode to equal dicts; each package decodes the
    other's dict to the object it builds itself."""
    ref, port = load("nos_tpu"), load("nos_tpu_torch")
    ref_obj, port_obj = build(ref, kind, seed), build(port, kind, seed)
    ref_wire, port_wire = ref.s.to_wire(ref_obj), port.s.to_wire(port_obj)
    assert port_wire == ref_wire
    from_ref = port.s.from_wire(ref_wire)
    assert type(from_ref) is type(port_obj) and from_ref == port_obj
    from_port = ref.s.from_wire(port_wire)
    assert type(from_port) is type(ref_obj) and from_port == ref_obj
    assert dataclasses.asdict(from_ref) == dataclasses.asdict(ref_obj)
