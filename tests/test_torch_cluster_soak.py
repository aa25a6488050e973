"""Concurrent writers on the port's in-memory cluster bus
(`nos_tpu_torch/cluster/client.py`) against the JAX package's: the whole of
tests/test_cluster_soak.py, each case on both packages. Many threads
patch, create, delete and watch at once; afterwards the store must be
consistent and every watcher must have seen each object's events in
commit order (resource versions strictly increasing, no lost updates)."""

import importlib
import threading
import types
from collections import defaultdict

import pytest

import test_torch_fleet_parity as fp

PACKAGES = ("nos_tpu", "nos_tpu_torch")

_time_limit = fp.time_limit(120)


@pytest.fixture(params=PACKAGES)
def p(request):
    return types.SimpleNamespace(
        o=importlib.import_module(f"{request.param}.api.objects"),
        c=importlib.import_module(f"{request.param}.cluster.client"))


def test_concurrent_counter_patches_lose_no_updates(p):
    """N threads x M increments against one annotation counter: the
    read-modify-write patch holds the lock, so the final value is exactly
    N*M (lost updates would show as a lower count)."""
    cluster = p.c.Cluster()
    cluster.create(p.o.Node(metadata=p.o.ObjectMeta(name="n0")))
    n_threads, n_incr = 8, 200

    def worker():
        for _ in range(n_incr):
            cluster.patch(
                "Node", "", "n0",
                lambda n: n.metadata.annotations.__setitem__(
                    "count", str(int(n.metadata.annotations.get("count", "0")) + 1)
                ),
            )

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    node = cluster.get("Node", "", "n0")
    assert node.metadata.annotations["count"] == str(n_threads * n_incr)
    assert node.metadata.resource_version >= n_threads * n_incr


def test_watchers_see_per_object_events_in_commit_order(p):
    """Under concurrent writers, each object's MODIFIED stream must arrive
    with strictly increasing resource versions and old_obj chaining to the
    previous delivery (the synchronous-dispatch ordering contract)."""
    cluster = p.c.Cluster()
    for i in range(4):
        cluster.create(p.o.Pod(metadata=p.o.ObjectMeta(name=f"p{i}", namespace="soak")))
    deliveries = defaultdict(list)
    lock = threading.Lock()

    def on_event(ev):
        with lock:
            deliveries[ev.obj.metadata.name].append(ev)

    cluster.watch("Pod", on_event, replay=False)

    def writer(pod_name):
        for k in range(150):
            cluster.patch(
                "Pod", "soak", pod_name,
                lambda pod, k=k: pod.metadata.labels.__setitem__("step", str(k)),
            )

    threads = [threading.Thread(target=writer, args=(f"p{i}",)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    for name, events in deliveries.items():
        assert len(events) == 150, f"{name}: {len(events)} events"
        rvs = [e.obj.metadata.resource_version for e in events]
        assert rvs == sorted(rvs) and len(set(rvs)) == len(rvs), (
            f"{name}: non-monotonic rvs"
        )
        for prev, cur in zip(events, events[1:]):
            assert cur.old_obj.metadata.resource_version == (
                prev.obj.metadata.resource_version
            ), f"{name}: old_obj chain broken"


def test_create_delete_churn_with_concurrent_list(p):
    """Creators, deleters, and listers race; nothing deadlocks, every list
    snapshot is internally consistent (no half-written objects), and the
    final census matches what survived."""
    cluster = p.c.Cluster()
    errors = []
    stop = threading.Event()

    def creator(ns):
        try:
            for k in range(100):
                cluster.create(p.o.Pod(metadata=p.o.ObjectMeta(name=f"c{k}", namespace=ns)))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def deleter(ns):
        deleted = 0
        while deleted < 50 and not stop.is_set():
            for k in range(100):
                if deleted >= 50:
                    break
                try:
                    cluster.delete("Pod", ns, f"c{k}")
                    deleted += 1
                except p.c.NotFoundError:
                    pass

    def lister():
        try:
            while not stop.is_set():
                for pod in cluster.list("Pod"):
                    assert pod.metadata.name.startswith("c")
                    assert pod.metadata.resource_version > 0
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = (
        [threading.Thread(target=creator, args=(f"ns{i}",)) for i in range(3)]
        + [threading.Thread(target=deleter, args=(f"ns{i}",)) for i in range(3)]
        + [threading.Thread(target=lister) for _ in range(2)]
    )
    for t in threads:
        t.start()
    for t in threads[:6]:
        t.join(timeout=60)
    stop.set()
    for t in threads[6:]:
        t.join(timeout=10)
    assert not errors, errors
    # 3 namespaces x (100 created - 50 deleted)
    assert len(cluster.list("Pod")) == 150


def test_watch_handler_exception_never_breaks_writers(p):
    cluster = p.c.Cluster()

    def bad_handler(ev):
        raise RuntimeError("watcher bug")

    seen = []
    cluster.watch("Pod", bad_handler, replay=False)
    cluster.watch("Pod", seen.append, replay=False)
    cluster.create(p.o.Pod(metadata=p.o.ObjectMeta(name="p", namespace="x")))
    # the writer survived AND the healthy watcher still got the event
    assert cluster.get("Pod", "x", "p") is not None
    assert [e.type for e in seen] == [p.c.EventType.ADDED]


def test_unsubscribe_race_with_writers(p):
    """Subscribing/unsubscribing while writers churn must neither deadlock
    nor deliver to dead handlers after unsubscribe returns... eventually
    (synchronous dispatch: in-flight deliveries on other threads may land,
    but none after the unsubscribing thread's next write)."""
    cluster = p.c.Cluster()
    cluster.create(p.o.Node(metadata=p.o.ObjectMeta(name="n")))
    stop = threading.Event()

    def writer():
        k = 0
        while not stop.is_set():
            k += 1
            cluster.patch(
                "Node", "", "n",
                lambda o, k=k: o.metadata.labels.__setitem__("w", str(k)),
            )

    w = threading.Thread(target=writer)
    w.start()
    try:
        for _ in range(50):
            got = []
            unsub = cluster.watch("Node", got.append)
            unsub()
            count_after = len(got)
            cluster.patch(
                "Node", "", "n",
                lambda o: o.metadata.labels.__setitem__("probe", "x"),
            )
            assert len(got) == count_after, "delivery after unsubscribe"
    finally:
        stop.set()
        w.join(timeout=10)
