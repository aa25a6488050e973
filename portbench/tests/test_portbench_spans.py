"""`portbench/spans.py` on synthetic kernels, launches and spans with
answers worked out by hand, and on a span log from the engine itself."""

import numpy as np
import pytest

from portbench import spans

# The engine thread's spans on its perf counter (ns): the epoch clock is
# the perf counter + 1000 over the window [1000, 1100].
OPEN, CLOSE = (1000, 0), (1100, 100)
SPANS = [  # kind, name, start, end, parent
    ("tick", "tick", 10, 60, -1),
    ("phase", "admit", 12, 20, 0),
    ("phase", "pump_prefill", 20, 50, 0),
    ("dispatch", "prefill_chunk", 25, 40, 2),
    ("stage", "stage", 26, 30, 3),
    ("phase", "eos_scan", 50, 58, 0),
    ("read_wait", "read_wait", 52, 56, 5),
    ("tick", "tick", 70, 95, -1),
    ("phase", "dispatch_macro", 71, 90, 7),
    ("dispatch", "macro", 72, 80, 8),
]
# Kernels on the epoch clock, each with its launch call's host stamp: a
# kernel launched onto an idle card starts at its launch.
KERNELS = [  # start, end, launch
    (1030, 1045, 1030),  # launched in the prefill chunk's dispatch
    (1045, 1053, 1028),  # queued behind it
    (1075, 1085, 1075),  # the macro window
    (1090, 1092, 1090),  # launched in a phase, outside any dispatch
    (1093, 1096, -1),    # no launch call in the trace
]


def log(rows=SPANS, dropped=0):
    kind, name, start, end, parent = zip(*rows)
    return {"kind": list(kind), "name": list(name), "start_ns": np.array(start),
            "end_ns": np.array(end), "parent": np.array(parent), "dropped": dropped}


def joined(on_engine=None, device_ahead=0):
    ks, ke, launch = (np.array(c) for c in zip(*KERNELS))
    return spans.join(ks + device_ahead, ke + device_ahead, launch, log(), OPEN, CLOSE,
                      launch_on_engine=on_engine)


IDLE = {"between_ticks": 24, "tick": 6, "admit": 8, "pump_prefill": 5,
        "dispatch:prefill_chunk": 1, "stage": 4, "read_wait": 3, "eos_scan": 2,
        "dispatch_macro": 6, "dispatch:macro": 3}


def test_idle_time_goes_to_the_innermost_span():
    j = joined()
    assert j["idle_phases"] == pytest.approx({k: v / 1e9 for k, v in IDLE.items()}, rel=1e-12)
    assert j["idle_s"] == pytest.approx(62e-9, rel=1e-12)
    assert sum(j["idle_phases"].values()) == pytest.approx(j["idle_s"], rel=1e-12)
    assert j["busy_s"] == pytest.approx(38e-9, rel=1e-9) and j["window_s"] == 100e-9
    assert j["coverage"]["idle_no_span_s"] == pytest.approx(24e-9, rel=1e-12)


@pytest.mark.parametrize("on_engine, want", [
    (None, {"prefill_chunk": 23, "macro": 10, "outside_dispatch": 5}),
    # A launch inside a dispatch's time but from another thread is not its.
    ([True, False, True, True, True], {"prefill_chunk": 15, "macro": 10, "outside_dispatch": 13}),
])
def test_kernels_take_the_kind_of_the_dispatch_around_their_launch(on_engine, want):
    j = joined(on_engine)
    assert j["device_by_dispatch"] == pytest.approx({k: v / 1e9 for k, v in want.items()},
                                                    rel=1e-12)
    assert j["coverage"]["outside_dispatch_share"] == pytest.approx(want["outside_dispatch"] / 38)


def test_a_gap_ends_at_the_launch_whatever_the_device_clock_reads():
    """Kineto's device stamps drift from the host's by milliseconds; each
    gap keeps its device length but ends at its launch call, so only the
    gaps no known launch ends move: the one before the last kernel leaves
    the tick, and 3 of the last gap's 4 ns fall outside the window."""
    j = joined(device_ahead=3)
    want = dict(IDLE, between_ticks=22, tick=5)
    assert j["idle_phases"] == pytest.approx({k: v / 1e9 for k, v in want.items()}, rel=1e-12)
    assert j["device_by_dispatch"] == joined()["device_by_dispatch"]


def test_no_span_and_no_dispatch_fall_to_their_own_labels():
    j = spans.join(np.array([1040]), np.array([1050]), np.array([1040]),
                   log([("tick", "tick", 60, 70, -1)], dropped=3), OPEN, CLOSE)
    assert j["idle_phases"] == pytest.approx({"between_ticks": 80e-9, "tick": 10e-9})
    assert j["device_by_dispatch"] == pytest.approx({"outside_dispatch": 10e-9})
    assert j["coverage"]["spans_dropped"] == 3


def test_the_clock_pairs_map_the_perf_counter_onto_the_epoch():
    opened, closed = (1000, 0), (1200, 100)  # the epoch clock runs twice as fast
    assert spans.to_epoch(np.array([0, 50, 100, 150]), opened, closed).tolist() == [
        1000, 1100, 1200, 1300]
    j = spans.join(np.array([1100]), np.array([1150]), np.array([1100]),
                   log([("dispatch", "burst", 40, 60, -1)]), opened, closed)
    # The dispatch spans [1080, 1120] on the epoch clock and holds the launch.
    assert j["device_by_dispatch"] == pytest.approx({"burst": 50e-9})
    assert j["coverage"]["clock_drift_ns"] == 100
    assert j["idle_phases"] == pytest.approx({"between_ticks": 130e-9, "dispatch:burst": 20e-9})


def test_innermost_takes_the_child_of_a_parent_opened_at_the_same_stamp():
    start, end, parent = np.array([0, 0, 5]), np.array([10, 4, 8]), np.array([-1, 0, 0])
    assert spans.innermost(start, end, parent, np.array([0, 3, 4, 6, 9, 10])).tolist() == [
        1, 1, 0, 2, 0, -1]


def test_an_engines_own_span_log_joins():
    """A profiler's log on a fake clock: every idle nanosecond lands on a
    label, and the dispatch's kernel on its kind."""
    from nos_tpu_torch import constants, tracing
    from nos_tpu_torch.tracing import TickProfiler

    clock = iter(range(100)).__next__
    prof = TickProfiler(clock=lambda: clock() * 1e-6)  # 1 us a read
    # tick [0, 9] us > pump_prefill [1, 8] > prefill_last [2, 5] > stage
    # [3, 4]; read_wait [6, 7] in the phase.
    prof.begin_tick()
    with prof.phase(constants.TICK_PHASE_PUMP_PREFILL):
        with prof.dispatch(tracing.DISPATCH_PREFILL_LAST), prof.stage():
            pass
        with prof.read_wait():
            pass
    prof.end_tick()
    j = spans.join(np.array([4500 + 1000]), np.array([6000 + 1000]), np.array([4500 + 1000]),
                   prof.span_log(), (1000, 0), (10000 + 1000, 10000))
    assert j["device_by_dispatch"] == pytest.approx({"prefill_last": 1.5e-6})
    assert sum(j["idle_phases"].values()) == pytest.approx(j["idle_s"], rel=1e-12)
    assert set(j["idle_phases"]) == {"tick", "pump_prefill", "dispatch:prefill_last", "stage",
                                     "read_wait", "between_ticks"}
