"""The port's control-plane utilities (`nos_tpu_torch/util/`) against the
JAX package's: the cases of tests/test_batcher.py, test_churn_ledger.py,
test_predicates.py, test_pod_predicates.py and test_leader_election.py
(the HTTP case included), each run on both packages; then cross-package
checks: every pod predicate of `util/pod.py` gives equal answers on a seeded
set of pods, and a `LeaderElector` of each package campaigns against the
other's over each package's `ClusterAPIServer`."""

import importlib
import random
import threading
import types

import pytest

import test_torch_fleet_parity as fp

PACKAGES = ("nos_tpu", "nos_tpu_torch")

_time_limit = fp.time_limit(60)


def load(pkg):
    m = types.SimpleNamespace(pkg=pkg)
    m.constants = importlib.import_module(f"{pkg}.constants")
    m.o = importlib.import_module(f"{pkg}.api.objects")
    m.r = importlib.import_module(f"{pkg}.api.resources")
    m.c = importlib.import_module(f"{pkg}.cluster.client")
    m.batcher = importlib.import_module(f"{pkg}.util.batcher")
    m.churn = importlib.import_module(f"{pkg}.util.churn")
    m.pred = importlib.import_module(f"{pkg}.util.predicates")
    m.pod = importlib.import_module(f"{pkg}.util.pod")
    m.leader = importlib.import_module(f"{pkg}.util.leader")
    m.apiserver = importlib.import_module(f"{pkg}.cluster.apiserver")
    m.kube = importlib.import_module(f"{pkg}.cluster.kube")
    return m


@pytest.fixture(params=PACKAGES)
def p(request):
    return load(request.param)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- test_batcher.py ----------------------------------------------------------
def test_empty_batcher_never_ready(p):
    clk = FakeClock()
    b = p.batcher.Batcher(timeout_s=60, idle_s=10, now=clk)
    assert not b.ready()
    clk.advance(1000)
    assert not b.ready()
    assert b.drain_if_ready() == []


def test_idle_window_closes_batch(p):
    clk = FakeClock()
    b = p.batcher.Batcher(timeout_s=60, idle_s=10, now=clk)
    b.add("a")
    clk.advance(5)
    b.add("b")
    clk.advance(9)
    assert not b.ready()
    clk.advance(1.5)
    assert b.ready()
    assert b.drain_if_ready() == ["a", "b"]
    assert len(b) == 0


def test_timeout_window_closes_batch_despite_activity(p):
    clk = FakeClock()
    b = p.batcher.Batcher(timeout_s=30, idle_s=10, now=clk)
    b.add(0)
    for i in range(1, 7):
        clk.advance(5)
        b.add(i)
    assert b.ready()
    assert b.drain_if_ready() == list(range(7))


def test_new_batch_after_drain_restarts_windows(p):
    clk = FakeClock()
    b = p.batcher.Batcher(timeout_s=30, idle_s=10, now=clk)
    b.add("x")
    clk.advance(10)
    assert b.drain_if_ready() == ["x"]
    b.add("y")
    assert not b.ready()
    clk.advance(10)
    assert b.drain_if_ready() == ["y"]


def test_idle_defaults_to_timeout_when_invalid(p):
    clk = FakeClock()
    b = p.batcher.Batcher(timeout_s=10, idle_s=0, now=clk)
    b.add(1)
    clk.advance(9.9)
    assert not b.ready()
    clk.advance(0.2)
    assert b.ready()


def test_seconds_until_ready(p):
    clk = FakeClock()
    b = p.batcher.Batcher(timeout_s=30, idle_s=10, now=clk)
    assert b.seconds_until_ready() is None
    b.add(1)
    assert b.seconds_until_ready() == 10
    clk.advance(25)
    b.add(2)
    assert b.seconds_until_ready() == 5


# -- test_churn_ledger.py -----------------------------------------------------
def make_ledger(p, cooldown=10.0, budget=3, window=100.0):
    return p.churn.ChurnLedger(cooldown, budget, window)


def test_unknown_key_is_immediately_eligible(p):
    assert make_ledger(p).eligible_at("w", now=50.0) == 50.0


def test_cooldown_applies_after_one_eviction(p):
    ledger = make_ledger(p, cooldown=10.0)
    ledger.note("w", 100.0)
    assert ledger.eligible_at("w", 101.0) == 110.0
    assert ledger.eligible_at("w", 115.0) <= 115.0


def test_budget_blocks_until_oldest_ages_out_of_window(p):
    ledger = make_ledger(p, cooldown=10.0, budget=3, window=100.0)
    for t in (100.0, 120.0, 140.0):
        ledger.note("w", t)
    assert ledger.eligible_at("w", 141.0) == 200.0
    assert ledger.eligible_at("w", 201.0) <= 201.0


def test_budget_window_slides_per_eviction(p):
    ledger = make_ledger(p, cooldown=0.0, budget=2, window=100.0)
    ledger.note("w", 0.0)
    ledger.note("w", 90.0)
    assert ledger.eligible_at("w", 95.0) == 100.0
    ledger.note("w", 100.0)
    assert ledger.eligible_at("w", 101.0) == 190.0


def test_read_path_prunes_lazily_without_writing(p):
    ledger = make_ledger(p, cooldown=10.0, budget=1, window=100.0)
    ledger.note("w", 0.0)
    assert ledger.eligible_at("w", 500.0) == 500.0
    assert ledger.history["w"] == [0.0]


def test_keys_are_independent(p):
    ledger = make_ledger(p, cooldown=50.0)
    ledger.note("a", 100.0)
    assert ledger.eligible_at("b", 101.0) == 101.0


def test_bulk_prune_is_in_place_preserving_aliases(p):
    ledger = make_ledger(p, cooldown=1.0, budget=3, window=100.0)
    alias = ledger.history
    for i in range(4200):
        ledger.note(f"old-{i}", float(i) * 0.001)
    assert len(alias) == 4200
    ledger.note("fresh", 10_000.0)
    assert alias is ledger.history
    assert "fresh" in alias
    assert len(alias) == 1, "aged-out workloads must be dropped"
    assert ledger.eligible_at("old-17", 10_001.0) == 10_001.0


def test_prune_keeps_live_entries(p):
    ledger = make_ledger(p, cooldown=1.0, budget=3, window=1000.0)
    for i in range(4200):
        ledger.note(f"w-{i}", 100.0)
    ledger.note("trigger", 200.0)
    assert len(ledger.history) == 4201
    assert ledger.eligible_at("w-7", 100.5) == 101.0


# -- test_predicates.py -------------------------------------------------------
def node(p, name="n", annotations=None, allocatable=None, capacity=None):
    o = p.o
    return o.Node(
        metadata=o.ObjectMeta(name=name, annotations=dict(annotations or {})),
        status=o.NodeStatus(
            allocatable=p.r.ResourceList.of(allocatable or {}),
            capacity=p.r.ResourceList.of(capacity or {}),
        ),
    )


def ev(p, kind, new, old=None):
    return p.c.Event(getattr(p.c.EventType, kind), new, old)


def test_matching_name(p):
    f = p.pred.matching_name("target")
    assert f(ev(p, "ADDED", node(p, "target")))
    assert not f(ev(p, "ADDED", node(p, "other")))


def test_exclude_delete(p):
    assert not p.pred.exclude_delete(ev(p, "DELETED", node(p)))
    assert p.pred.exclude_delete(ev(p, "ADDED", node(p)))
    assert p.pred.exclude_delete(ev(p, "MODIFIED", node(p), node(p)))


def test_annotations_changed(p):
    same = ev(p, "MODIFIED", node(p, annotations={"a": "1"}), node(p, annotations={"a": "1"}))
    diff = ev(p, "MODIFIED", node(p, annotations={"a": "2"}), node(p, annotations={"a": "1"}))
    assert not p.pred.annotations_changed(same)
    assert p.pred.annotations_changed(diff)
    assert p.pred.annotations_changed(ev(p, "ADDED", node(p)))


def test_node_resources_changed(p):
    same = ev(p, "MODIFIED", node(p, allocatable={"cpu": 4}), node(p, allocatable={"cpu": 4}))
    diff_alloc = ev(p, "MODIFIED", node(p, allocatable={"cpu": 8}), node(p, allocatable={"cpu": 4}))
    diff_cap = ev(p, "MODIFIED", node(p, capacity={"cpu": 8}), node(p, capacity={"cpu": 4}))
    assert not p.pred.node_resources_changed(same)
    assert p.pred.node_resources_changed(diff_alloc)
    assert p.pred.node_resources_changed(diff_cap)


def test_spec_annotations_changed_ignores_status_noise(p):
    c = p.constants
    spec_key = f"{c.DOMAIN}/spec-dev-0-2x2"
    status_key = f"{c.DOMAIN}/status-dev-0-2x2-free"
    old = node(p, annotations={spec_key: "1", status_key: "0"})
    status_only = node(p, annotations={spec_key: "1", status_key: "1"})
    spec_change = node(p, annotations={spec_key: "2", status_key: "0"})
    assert not p.pred.spec_annotations_changed(ev(p, "MODIFIED", status_only, old))
    assert p.pred.spec_annotations_changed(ev(p, "MODIFIED", spec_change, old))
    with_plan = node(p, annotations={spec_key: "1", c.ANNOTATION_SPEC_PLAN: "p1"})
    assert p.pred.spec_annotations_changed(ev(p, "MODIFIED", with_plan, old))


def test_phase_changed(p):
    o = p.o
    p_old = o.Pod(metadata=o.ObjectMeta(name="p"), status=o.PodStatus(phase="Pending"))
    p_run = o.Pod(metadata=o.ObjectMeta(name="p"), status=o.PodStatus(phase="Running"))
    assert p.pred.phase_changed(ev(p, "MODIFIED", p_run, p_old))
    assert not p.pred.phase_changed(ev(p, "MODIFIED", p_run, p_run))
    assert p.pred.phase_changed(ev(p, "ADDED", p_run))
    assert p.pred.phase_changed(ev(p, "DELETED", p_run))


def test_combinators_and_filtered(p):
    pred = p.pred
    f = pred.all_of(pred.exclude_delete, pred.matching_name("n"))
    seen = []
    handler = pred.filtered(f, seen.append)
    handler(ev(p, "ADDED", node(p, "n")))
    handler(ev(p, "DELETED", node(p, "n")))
    handler(ev(p, "ADDED", node(p, "x")))
    assert len(seen) == 1
    q = pred.any_of(pred.matching_name("a"), pred.matching_name("b"))
    assert q(ev(p, "ADDED", node(p, "a")))
    assert q(ev(p, "ADDED", node(p, "b")))
    assert not q(ev(p, "ADDED", node(p, "c")))


# -- test_pod_predicates.py ---------------------------------------------------
def unschedulable_pod(p):
    o = p.o
    pod = o.Pod(metadata=o.ObjectMeta(name="p", namespace="ns"))
    pod.status.phase = o.PodPhase.PENDING
    pod.status.conditions.append(
        o.PodCondition(type="PodScheduled", status="False", reason="Unschedulable"))
    return pod


def test_extra_resources_could_help_scheduling_happy_path(p):
    assert p.pod.extra_resources_could_help_scheduling(unschedulable_pod(p))


def test_running_pod_not_eligible(p):
    pod = unschedulable_pod(p)
    pod.status.phase = p.o.PodPhase.RUNNING
    assert not p.pod.extra_resources_could_help_scheduling(pod)


def test_pending_but_not_marked_unschedulable_not_eligible(p):
    pod = p.o.Pod()
    pod.status.phase = p.o.PodPhase.PENDING
    assert not p.pod.extra_resources_could_help_scheduling(pod)


def test_preempting_pod_not_eligible(p):
    pod = unschedulable_pod(p)
    pod.status.nominated_node_name = "node-1"
    assert not p.pod.extra_resources_could_help_scheduling(pod)


def test_daemonset_owned_pod_not_eligible(p):
    pod = unschedulable_pod(p)
    pod.owner_references.append(p.o.OwnerReference(kind="DaemonSet", name="ds"))
    assert not p.pod.extra_resources_could_help_scheduling(pod)


def test_is_over_quota_label(p):
    c = p.constants
    pod = p.o.Pod()
    assert not p.pod.is_over_quota(pod)
    pod.metadata.labels[c.LABEL_CAPACITY] = c.CAPACITY_OVER_QUOTA
    assert p.pod.is_over_quota(pod)
    pod.metadata.labels[c.LABEL_CAPACITY] = c.CAPACITY_IN_QUOTA
    assert not p.pod.is_over_quota(pod)


def test_is_active(p):
    pod = p.o.Pod()
    assert not p.pod.is_active(pod)
    pod.spec.node_name = "n1"
    pod.status.phase = p.o.PodPhase.RUNNING
    assert p.pod.is_active(pod)
    pod.status.phase = p.o.PodPhase.SUCCEEDED
    assert not p.pod.is_active(pod)


# -- test_leader_election.py --------------------------------------------------
def elector(p, cluster, identity, clock, **kw):
    return p.leader.LeaderElector(
        cluster, lease_name="nos-tpu-operator", namespace="nos-system", identity=identity,
        lease_duration_s=15, now=clock, **kw,
    )


def lease(cluster):
    return cluster.get("Lease", "nos-system", "nos-tpu-operator")


def test_first_elector_acquires_and_renews(p):
    cluster, clock = p.c.Cluster(), FakeClock(1000.0)
    a = elector(p, cluster, "a", clock)
    assert a.try_acquire()
    assert lease(cluster).spec.holder_identity == "a"
    clock.t += 10
    assert a.try_acquire()
    assert lease(cluster).spec.renew_time == clock.t


def test_second_elector_blocked_while_lease_fresh(p):
    cluster, clock = p.c.Cluster(), FakeClock(1000.0)
    a, b = elector(p, cluster, "a", clock), elector(p, cluster, "b", clock)
    assert a.try_acquire()
    clock.t += 10
    assert not b.try_acquire()
    assert lease(cluster).spec.holder_identity == "a"


def test_stale_lease_taken_over_with_transition_count(p):
    cluster, clock = p.c.Cluster(), FakeClock(1000.0)
    a, b = elector(p, cluster, "a", clock), elector(p, cluster, "b", clock)
    assert a.try_acquire()
    assert not b.try_acquire()
    clock.t += 20
    assert b.try_acquire()
    assert lease(cluster).spec.holder_identity == "b"
    assert lease(cluster).spec.lease_transitions == 1
    assert a._renew() == "lost"


def test_remote_clock_skew_cannot_steal_a_live_lease(p):
    cluster = p.c.Cluster()
    holder_clock, candidate_clock = FakeClock(1000.0), FakeClock(1120.0)
    a = elector(p, cluster, "a", holder_clock)
    b = elector(p, cluster, "b", candidate_clock)
    assert a.try_acquire()
    for _ in range(6):
        assert not b.try_acquire(), "skewed candidate stole a live lease"
        holder_clock.t += 5
        candidate_clock.t += 5
        assert a.try_acquire()


def test_transient_renew_errors_tolerated_until_deadline(p):
    cluster, clock = p.c.Cluster(), FakeClock(1000.0)
    a = elector(p, cluster, "a", clock)
    assert a.try_acquire()
    a._leading.set()
    a._last_renew_ok = clock()
    real_patch = cluster.patch

    def flaky_patch(*args, **kw):
        raise RuntimeError("apiserver blip")

    cluster.patch = flaky_patch
    clock.t += 5
    assert a._renew() == "error"
    assert clock() - a._last_renew_ok <= a.lease_duration_s
    cluster.patch = real_patch
    assert a._renew() == "ok"


def test_voluntary_release_enables_immediate_takeover(p):
    cluster, clock = p.c.Cluster(), FakeClock(1000.0)
    a, b = elector(p, cluster, "a", clock), elector(p, cluster, "b", clock)
    assert a.try_acquire()
    a.release()
    clock.t += 1
    assert b.try_acquire()


def test_concurrent_takeover_races_pick_one_winner(p):
    cluster, clock = p.c.Cluster(), FakeClock(1000.0)
    holder = elector(p, cluster, "old", clock)
    assert holder.try_acquire()
    racers = [elector(p, cluster, f"r{i}", clock) for i in range(6)]
    for e in racers:
        assert not e.try_acquire()
    clock.t += 30
    results = {}
    barrier = threading.Barrier(len(racers))

    def race(e):
        barrier.wait()
        results[e.identity] = e.try_acquire()

    threads = [threading.Thread(target=race, args=(e,)) for e in racers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(results.values()) == 1, results
    winner = next(k for k, v in results.items() if v)
    assert lease(cluster).spec.holder_identity == winner


def test_campaign_loop_and_loss_callback(p):
    cluster, clock = p.c.Cluster(), FakeClock(1000.0)
    lost = threading.Event()
    a = elector(p, cluster, "a", clock, renew_period_s=0.01, retry_period_s=0.01,
                on_stopped_leading=lost.set)
    a.start()
    try:
        assert a.wait_for_leadership(timeout=10)

        def steal(obj):
            obj.spec.holder_identity = "thief"
            obj.spec.renew_time = clock() + 1000

        cluster.patch("Lease", "nos-system", "nos-tpu-operator", steal)
        assert lost.wait(timeout=10), "loss callback never fired"
        assert not a.is_leader
    finally:
        a.stop(release=False)


def test_leader_election_over_http_backend(p):
    server = p.apiserver.ClusterAPIServer().start()
    kube = p.kube.KubeCluster(p.kube.KubeConfig(server=server.url))
    try:
        clock = FakeClock(1000.0)
        a, b = elector(p, kube, "a", clock), elector(p, kube, "b", clock)
        assert a.try_acquire()
        assert not b.try_acquire()
        clock.t += 20
        assert b.try_acquire()
        got = kube.get("Lease", "nos-system", "nos-tpu-operator")
        assert got.spec.holder_identity == "b"
        assert got.spec.lease_transitions == 1
    finally:
        kube.close()
        server.stop()


# -- across packages ----------------------------------------------------------
REF, PORT = load("nos_tpu"), load("nos_tpu_torch")


def _random_pod(m, rng):
    o, c = m.o, m.constants
    pod = o.Pod(metadata=o.ObjectMeta(name="p", namespace="ns"))
    pod.status.phase = rng.choice([o.PodPhase.PENDING, o.PodPhase.RUNNING, o.PodPhase.SUCCEEDED,
                                   o.PodPhase.FAILED])
    if rng.random() < 0.6:
        pod.status.conditions.append(o.PodCondition(
            type="PodScheduled", status=rng.choice(["False", "True"]),
            reason=rng.choice(["Unschedulable", "Other"])))
    if rng.random() < 0.3:
        pod.status.nominated_node_name = "node-1"
    if rng.random() < 0.3:
        pod.owner_references.append(o.OwnerReference(kind=rng.choice(["DaemonSet", "Node", "Job"]),
                                                     name="x"))
    if rng.random() < 0.5:
        pod.spec.node_name = "n1"
    labels, anns = pod.metadata.labels, pod.metadata.annotations
    if rng.random() < 0.5:
        labels[c.LABEL_CAPACITY] = rng.choice([c.CAPACITY_OVER_QUOTA, c.CAPACITY_IN_QUOTA])
    if rng.random() < 0.5:
        anns[c.ANNOTATION_EXPECTED_DURATION] = rng.choice(["60", "-1", "abc", "", "12.5"])
    if rng.random() < 0.5:
        anns[c.ANNOTATION_BOUND_AT] = rng.choice(["100", "x", "7.25"])
    if rng.random() < 0.5:
        anns[c.ANNOTATION_CHECKPOINTABLE] = rng.choice(["true", "True", "no"])
    if rng.random() < 0.5:
        labels[c.LABEL_GANG] = "g"
        labels[c.LABEL_GANG_SIZE] = rng.choice(["4", "x"])
    if rng.random() < 0.5:
        labels[c.LABEL_MULTISLICE_COUNT] = rng.choice(["2", "0", "z"])
    if rng.random() < 0.5:
        pod.spec.node_selector[c.LABEL_TPU_SUBSLICE_TOPOLOGY] = rng.choice(["2x2", "4x8", "bad"])
    return pod


def test_pod_predicates_equal_across_packages():
    """Every function of util/pod.py on 200 seeded pods, and
    `latest_expected_end` over groups of them."""
    names = ["is_pending", "is_unschedulable", "is_preempting", "is_owned_by_daemonset_or_node",
             "extra_resources_could_help_scheduling", "is_over_quota", "is_scheduled", "is_active",
             "expected_duration_s", "bound_at_s", "expected_end_s", "is_checkpointable", "gang_of",
             "gang_size_of", "multislice_count"]
    outs = []
    for m in (REF, PORT):
        rng = random.Random(11)
        pods = [_random_pod(m, rng) for _ in range(200)]
        rows = []
        for pod in pods:
            row = [getattr(m.pod, n)(pod) for n in names]
            want = m.pod.wanted_subslice_topology(pod)
            rows.append(row + [None if want is None else want.name])
        ends = [m.pod.latest_expected_end(pods[i:i + k], 50.0)
                for k in (1, 2) for i in range(0, 200, k)]
        outs.append((rows, ends))
    assert outs[0] == outs[1]
    assert any(e is not None for e in outs[0][1])


@pytest.mark.parametrize("server_pkg", PACKAGES)
def test_electors_of_both_packages_share_one_lease(server_pkg):
    """A reference elector and a port elector over one HTTP API server:
    exactly one leads, the other takes over after a release, and the lease
    counts the transition."""
    srv = load(server_pkg).apiserver.ClusterAPIServer().start()
    kubes = [m.kube.KubeCluster(m.kube.KubeConfig(server=srv.url)) for m in (REF, PORT)]
    try:
        clock = FakeClock(1000.0)
        a = elector(REF, kubes[0], "ref", clock)
        b = elector(PORT, kubes[1], "port", clock)
        assert [a.try_acquire(), b.try_acquire()] == [True, False]
        a.release()
        clock.t += 1
        assert b.try_acquire()
        got = kubes[0].get("Lease", "nos-system", "nos-tpu-operator")
        assert got.spec.holder_identity == "port" and got.spec.lease_transitions == 1
        assert not a.try_acquire()
    finally:
        for k in kubes:
            k.close()
        srv.stop()
