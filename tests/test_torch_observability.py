"""The port's health and debug HTTP plane (nos_tpu_torch/observability.py
`HealthManager`, `ObservabilityServer`, `setup_logging`) against the JAX
package, on the CPU, mirroring tests/test_observability.py (:31-120,
:301) and the debug-endpoint cases of tests/test_accounting.py
(:341-455): every endpoint, the bearer-token guard (401) and the unarmed
surfaces (404), the /debug index, a trace's payload carrying its cost
receipt, concurrent scrapes while writers churn; each server case on both
packages' classes, and the port's /metrics text equal to the JAX
package's for the same registry content. Every server is stopped in a
`finally`."""

import http.client
import json
import logging
import threading

import pytest

import test_torch_fleet_parity as fp

_time_limit = fp.time_limit(120)

SIDE = pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])


@pytest.fixture(scope="module")
def both():
    return fp.sides()


def get(port, path, token=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path,
                     headers={"Authorization": f"Bearer {token}"} if token else {})
        resp = conn.getresponse()
        return resp.status, resp.read().decode(), dict(resp.getheaders())
    finally:
        conn.close()


class Served:
    """An ObservabilityServer of `side`, started, stopped on exit."""

    def __init__(self, side, **kw):
        obs = side.observability
        self.metrics = kw.pop("metrics", None) or side.Metrics()
        self.health = obs.HealthManager()
        self.srv = obs.ObservabilityServer(self.metrics, self.health, port=0, **kw)

    def __enter__(self):
        self.srv.start()
        return self

    def __exit__(self, *exc):
        self.srv.stop()

    def get(self, path, token=None):
        return get(self.srv.port, path, token)


def fill(m):
    """One registry content, written the same way on either package."""
    m.inc("nos_tpu_partitioning_cycles", kind="tpu")
    m.inc("nos_tpu_partitioning_cycles", kind="tpu")
    m.inc("nos_tpu_decode_steps", 7)
    m.set_gauge("nos_tpu_chips_total", 256, node="n0")
    m.set_gauge("nos_tpu_fleet_tok_s", 12.5, replica="replica-0")
    m.set_gauge("nos_tpu_fleet_tok_s", 3.0, replica="replica-1")
    m.remove_gauge("nos_tpu_fleet_tok_s", replica="replica-1")
    for v in (0.0003, 0.0003, 0.004, 0.08, 7.0, 42.0):
        m.observe("nos_tpu_tick", v, phase="admit")
    m.observe("nos_tpu_plan_seconds", 0.25)


def test_exposition_text_equals_the_jax_packages(both):
    """The same registry content renders the same Prometheus text, # TYPE
    lines and cumulative buckets included, and the port's /metrics serves
    exactly that text."""
    jside, tside = both
    jm, tm = jside.Metrics(), tside.Metrics()
    fill(jm)
    fill(tm)
    assert tm.render() == jm.render()
    with Served(tside, metrics=tm) as s:
        status, body, headers = s.get("/metrics")
    assert status == 200 and body == jm.render()
    assert headers["Content-Type"] == "text/plain; version=0.0.4"
    assert 'nos_tpu_tick_seconds_bucket{phase="admit",le="+Inf"} 6' in body
    assert "# TYPE nos_tpu_partitioning_cycles_total counter" in body.splitlines()


@SIDE
def test_health_endpoints_probes_and_404(both, which):
    """test_observability.py:31-84: ok by default, a failing readyz check
    500 until it recovers, a raising check a failure and not a crash, an
    unknown path 404, probes in plain text."""
    with Served(both[which]) as s:
        assert s.get("/healthz")[:2] == (200, "ok")
        assert s.get("/readyz")[:2] == (200, "ok")
        assert s.get("/healthz")[2]["Content-Type"] == "text/plain"
        assert s.get("/nope")[0] == 404
        state = {"up": False}
        s.health.add_readyz("bus", lambda: None if state["up"] else "bus down")
        status, body, _ = s.get("/readyz")
        assert status == 500 and "bus down" in body
        assert s.get("/healthz")[0] == 200
        state["up"] = True
        assert s.get("/readyz")[:2] == (200, "ok")

        def exploding():
            raise RuntimeError("probe bug")

        s.health.add_healthz("bad", exploding)
        status, body, _ = s.get("/healthz")
        assert status == 500 and "probe bug" in body
        assert s.get("/metrics")[0] == 200
    assert s.health.healthz()[0] is False and s.health.readyz() == (True, {})


@SIDE
def test_bearer_token_guards_metrics_and_debug(both, which):
    """test_observability.py:301: with a token, /metrics and every /debug
    path need the exact bearer token (401 with WWW-Authenticate otherwise);
    /healthz and /readyz stay open."""
    side = both[which]
    c = side.constants
    tracer, led = side.Tracer(), side.CostLedger()
    with Served(side, metrics_token="s3cret", tracer=tracer, accounting=led,
                recorder=side.FlightRecorder()) as s:
        s.metrics.inc("nos_tpu_test_counter")
        for path in ("/metrics", c.DEBUG_PATH_INDEX, c.DEBUG_PATH_EVENTS,
                     c.DEBUG_PATH_ACCOUNTING, c.DEBUG_PATH_TRACE_PREFIX + "tr-1"):
            status, _, headers = s.get(path)
            assert status == 401 and headers["WWW-Authenticate"] == "Bearer", path
            assert s.get(path, token="wrong")[0] == 401, path
        status, body, _ = s.get("/metrics", token="s3cret")
        assert status == 200 and "nos_tpu_test_counter" in body
        assert s.get("/healthz")[0] == 200 and s.get("/readyz")[0] == 200


@SIDE
def test_debug_index_and_unarmed_surfaces(both, which):
    """test_accounting.py:373-414: /debug lists exactly the armed surfaces;
    with nothing armed it and every surface answer 404."""
    side = both[which]
    c = side.constants
    with Served(side, metrics_token="s3", tracer=side.Tracer(),
                accounting=side.CostLedger()) as s:
        status, body, headers = s.get(c.DEBUG_PATH_INDEX, token="s3")
        assert status == 200 and headers["Content-Type"] == "application/json"
        assert json.loads(body)["surfaces"] == [c.DEBUG_PATH_TRACE_PREFIX + "<id>",
                                                c.DEBUG_PATH_ACCOUNTING]
        assert s.get(c.DEBUG_PATH_EVENTS, token="s3")[0] == 404
        assert s.get(c.DEBUG_PATH_PRESSURE, token="s3")[0] == 404
    with Served(side) as s:
        for path in (c.DEBUG_PATH_INDEX, c.DEBUG_PATH_EVENTS, c.DEBUG_PATH_PRESSURE,
                     c.DEBUG_PATH_ACCOUNTING, c.DEBUG_PATH_TRACE_PREFIX + "tr-1"):
            assert s.get(path)[0] == 404, path


def test_debug_payloads_equal_the_jax_packages(both):
    """/debug/accounting (the roll-up with its receipts), /debug/trace/<id>
    carrying the request's receipt, /debug/events (the recorder's ring and
    the trace ids) and an unknown trace's 404: the port's payloads equal
    the JAX package's for the same content, wall-clock fields aside."""
    def run(side):
        c = side.constants
        tracer, led, rec = side.Tracer(), side.CostLedger(), side.FlightRecorder()
        tid = tracer.new_trace()
        tracer.event(tid, c.TRACE_EV_SUBMIT, prompt_tokens=4)
        led.open_request(tid, "gold")
        led.charge(tid, "gold", decode_tokens=7, slot_seconds=0.5)
        led.close_request(tid, "gold", tokens=8)
        rec.record(c.FLIGHT_EV_FINISH, slot=0, tokens=8)
        rec.dump(side.faults.FAULT_TRANSIENT)
        with Served(side, tracer=tracer, accounting=led, recorder=rec) as s:
            acct = json.loads(s.get(c.DEBUG_PATH_ACCOUNTING)[1])
            trace = json.loads(s.get(c.DEBUG_PATH_TRACE_PREFIX + tid)[1])
            events = json.loads(s.get(c.DEBUG_PATH_EVENTS)[1])
            missing = s.get(c.DEBUG_PATH_TRACE_PREFIX + "tr-nope")[0]
        assert acct["tenants"]["gold"][c.COST_DECODE_TOKENS] == 7
        assert acct["receipts"][0]["status"] == c.RECEIPT_STATUS_OK
        assert trace["receipt"][c.COST_DECODE_TOKENS] == 7 and missing == 404
        assert events["traces"] == [tid]
        assert events["postmortems"][0]["reason"] == side.faults.FAULT_TRANSIENT
        for r in acct["receipts"] + [trace["receipt"]]:
            r.pop("dur_s")
        for e in trace["events"] + events["events"] + [
                x for p in events["postmortems"] for x in p.get("events", [])]:
            e.pop("t", None)
            e.pop("ts", None)
        for p in events["postmortems"]:
            p.pop("t", None)
            p.pop("ts", None)
        return acct, trace, events

    fp.twin(both, run)


@SIDE
def test_concurrent_scrapes_with_writers(both, which):
    """test_observability.py:86: writers churn while three scrapers hit
    /metrics; every response is 200 and every sample line parses."""
    side = both[which]
    stop = threading.Event()
    errors = []
    with Served(side) as s:
        def writer():
            k = 0
            while not stop.is_set():
                k += 1
                s.metrics.inc("nos_tpu_soak_total", shard=str(k % 5))

        def scraper():
            try:
                for _ in range(30):
                    status, body, _ = s.get("/metrics")
                    assert status == 200
                    for line in body.splitlines():
                        if line and not line.startswith("#"):
                            float(line.rpartition(" ")[2])
            except Exception as e:  # noqa: BLE001 - collected for the assert
                errors.append(e)

        w = threading.Thread(target=writer)
        scrapers = [threading.Thread(target=scraper) for _ in range(3)]
        w.start()
        for t in scrapers:
            t.start()
        try:
            for t in scrapers:
                t.join(timeout=60)
        finally:
            stop.set()
            w.join(timeout=10)
    assert not errors, errors
    assert not w.is_alive() and not any(t.is_alive() for t in scrapers)


def test_setup_logging_sets_the_level():
    from nos_tpu_torch.observability import setup_logging

    root = logging.getLogger()
    saved = (root.level, list(root.handlers))
    try:
        for h in list(root.handlers):
            root.removeHandler(h)
        setup_logging("warning")
        assert root.level == logging.WARNING and root.handlers
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        root.setLevel(saved[0])
        for h in saved[1]:
            root.addHandler(h)
