"""Lay the engine's span log beside the device trace of a `--trace 1` run.

The engine's TickProfiler (`nos_tpu_torch/tracing.py`) keeps a log of its
ticks, tick phases, dispatches (each with the kind of program it wraps),
uploads (`stage`) and blocking reads (`read_wait`), stamped on the
`perf_counter_ns` clock, and pairs that clock with the Unix-epoch one on
demand (`clock_pair()`). Kineto stamps host and device activity in
Unix-epoch nanoseconds. `join` maps the spans onto the epoch clock by
linear interpolation between a pair read when the window opened and one
read when it closed, then, with sorted-interval searches only:

  - lays each idle stretch of the device (the window less the union of
    the kernel intervals) over the engine thread's innermost open span:
    a tick phase by its name, `dispatch:<kind>`, `stage`, `read_wait`,
    `tick` (inside a tick, outside every phase) or `between_ticks`;
  - gives each kernel the kind of the dispatch span that holds the host
    stamp of the runtime call that launched it, or `outside_dispatch`.

Times are int64 nanoseconds; results are seconds."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

BETWEEN_TICKS = "between_ticks"
OUTSIDE_DISPATCH = "outside_dispatch"
DISPATCH = "dispatch"


def to_epoch(perf_ns: np.ndarray, open_pair: Tuple[int, int],
             close_pair: Tuple[int, int]) -> np.ndarray:
    """perf_counter_ns stamps on the epoch clock: the line through the two
    (epoch, perf) pairs, extended beyond them."""
    (w0, p0), (w1, p1) = open_pair, close_pair
    rate = (w1 - w0) / (p1 - p0) if p1 != p0 else 1.0
    return w0 + np.rint((np.asarray(perf_ns, dtype=np.int64) - p0) * rate).astype(np.int64)


def labels_of(kind: Sequence[str], name: Sequence[str]) -> np.ndarray:
    """Each record's label: `dispatch:<kind>` for a dispatch, else its name
    (a tick phase, `stage`, `read_wait`, `tick`)."""
    return np.array([f"{DISPATCH}:{n}" if k == DISPATCH else n for k, n in zip(kind, name)],
                    dtype=object)


def idle_intervals(starts: np.ndarray, ends: np.ndarray, launch: np.ndarray, lo: int,
                   hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """The card's idle stretches on the host clock, one a gap, in kernel
    order. A gap ends when the host launches the kernel after it, so it
    is laid to end at that launch call's host stamp and to last as long
    as the device measured; where the call is unknown, at the kernel's
    start. Before the first kernel the card idles from `lo` to its
    launch; after the last, from its end to `hi`. Only durations are
    read off the device's clock, which Kineto maps onto the epoch with
    offsets of milliseconds that jump between resyncs."""
    if not len(starts):
        return np.array([lo], dtype=np.int64), np.array([hi], dtype=np.int64)
    order = np.argsort(starts, kind="stable")
    s, e, at = starts[order], ends[order], launch[order]
    at = np.where(at >= 0, at, s)
    reach = np.maximum.accumulate(e)
    gap = np.concatenate([[max(0, at[0] - lo)], np.maximum(0, s[1:] - reach[:-1]),
                          [max(0, hi - reach[-1])]])
    g1 = np.concatenate([at, [hi]])
    keep = gap > 0
    g1 = np.clip(g1[keep], lo, hi)
    return np.clip(g1 - gap[keep], lo, hi), g1


def innermost(start: np.ndarray, end: np.ndarray, parent: np.ndarray,
              t: np.ndarray) -> np.ndarray:
    """For each time in `t`, the index of the innermost record open at it
    (start <= t < end), or -1. The records are one thread's properly
    nested spans in the order they opened (starts non-decreasing):
    the last record opened at or before t, or the nearest of its
    ancestors still open."""
    cur = np.searchsorted(start, t, side="right") - 1
    while True:
        closed = (cur >= 0) & (end[np.maximum(cur, 0)] <= t)
        if not closed.any():
            return cur
        cur = np.where(closed, parent[np.maximum(cur, 0)], cur)


def _by_label(labels: np.ndarray, seconds: np.ndarray) -> Dict[str, float]:
    keys, inv = np.unique(labels.astype(str), return_inverse=True)
    sums = np.bincount(inv, weights=seconds, minlength=len(keys))
    return {str(k): float(v) for k, v in zip(keys, sums) if v > 0}


def join(kernel_start: np.ndarray, kernel_end: np.ndarray, launch_ns: np.ndarray,
         spans: Dict, open_pair: Tuple[int, int], close_pair: Tuple[int, int],
         launch_on_engine: Optional[np.ndarray] = None) -> Dict:
    """Join one window's kernels with the engine's span log.

    `kernel_start`, `kernel_end`: device intervals (epoch ns). `launch_ns`:
    per kernel, the host start of the runtime call that launched it
    (epoch ns; -1 where the trace holds none); `launch_on_engine`, per
    kernel, whether that call ran on the engine's thread (all, if None).
    `spans`: `TickProfiler.span_log()` read whole (first 0). The window is
    [open_pair[0], close_pair[0]] on the epoch clock.

    Returns `idle_phases` and `device_by_dispatch` ({label: seconds}),
    `idle_s` (the gaps' seconds, `idle_intervals`), `busy_s` (the rest of
    the window), `coverage` (`outside_dispatch_share`: the share of kernel
    seconds outside any dispatch; `idle_no_span_s`: idle seconds with no
    engine span open; `spans_dropped`; `clock_drift_ns`: how far the
    perf counter ran from the epoch clock over the window), and
    `window_s`."""
    lo, hi = int(open_pair[0]), int(close_pair[0])
    ks = np.asarray(kernel_start, dtype=np.int64)
    ke = np.asarray(kernel_end, dtype=np.int64)
    launch = np.asarray(launch_ns, dtype=np.int64)
    g0, g1 = idle_intervals(ks, ke, launch, lo, hi)
    idle_s = float((g1 - g0).sum()) / 1e9
    window_s = (hi - lo) / 1e9

    start = to_epoch(spans["start_ns"], open_pair, close_pair)
    end = np.where(spans["end_ns"] < 0, np.iinfo(np.int64).max,
                   to_epoch(spans["end_ns"], open_pair, close_pair))
    parent = np.asarray(spans["parent"], dtype=np.int64)
    names = np.append(labels_of(spans["kind"], spans["name"]), BETWEEN_TICKS)

    # Cut the window at every span edge: each piece has one innermost span.
    # Per label, the cumulative time of its pieces gives the idle time of
    # each gap under that label (gaps may overlap where a launch ran late).
    edges = np.unique(np.clip(np.concatenate([start, end[end < hi], [lo, hi]]), lo, hi))
    mid = (edges[:-1] + edges[1:]) // 2
    owner = (innermost(start, end, parent, mid) if len(start)
             else np.full(len(mid), -1, dtype=np.int64))
    owner = np.where(owner >= 0, owner, len(names) - 1)
    keys, piece_label = np.unique(names[owner].astype(str), return_inverse=True)
    piece_len = np.diff(edges).astype(np.float64)
    at0 = np.clip(np.searchsorted(edges, g0, side="right") - 1, 0, len(piece_len) - 1)
    at1 = np.clip(np.searchsorted(edges, g1, side="right") - 1, 0, len(piece_len) - 1)
    in0 = np.minimum(g0 - edges[at0], piece_len[at0])
    in1 = np.minimum(g1 - edges[at1], piece_len[at1])
    idle_phases = {}
    for code, key in enumerate(keys):
        mine = piece_label == code
        cum = np.concatenate([[0.0], np.cumsum(np.where(mine, piece_len, 0.0))])
        upto1 = cum[at1] + np.where(mine[at1], in1, 0.0)
        upto0 = cum[at0] + np.where(mine[at0], in0, 0.0)
        total = float((upto1 - upto0).sum()) / 1e9
        if total > 0:
            idle_phases[str(key)] = total

    # Kernels by the dispatch span around their launch call.
    is_disp = np.array([k == DISPATCH for k in spans["kind"]], dtype=bool)
    d_start, d_end = start[is_disp], end[is_disp]
    d_label = np.asarray(spans["name"], dtype=object)[is_disp] if is_disp.any() else None
    launch = np.asarray(launch_ns, dtype=np.int64)
    ok = launch >= 0
    if launch_on_engine is not None:
        ok &= np.asarray(launch_on_engine, dtype=bool)
    kernel_label = np.full(len(ks), OUTSIDE_DISPATCH, dtype=object)
    if d_label is not None and len(ks):
        j = np.searchsorted(d_start, launch, side="right") - 1
        held = ok & (j >= 0) & (launch < d_end[np.maximum(j, 0)])
        kernel_label[held] = d_label[j[held]]
    dur_s = (ke - ks) / 1e9
    device_by_dispatch = _by_label(kernel_label, dur_s)
    total = float(dur_s.sum())
    outside = device_by_dispatch.get(OUTSIDE_DISPATCH, 0.0)
    drift = (close_pair[0] - open_pair[0]) - (close_pair[1] - open_pair[1])
    return {
        "idle_phases": idle_phases,
        "device_by_dispatch": device_by_dispatch,
        "idle_s": idle_s,
        "busy_s": window_s - idle_s,
        "window_s": window_s,
        "coverage": {
            "outside_dispatch_share": outside / total if total > 0 else None,
            "idle_no_span_s": idle_phases.get(BETWEEN_TICKS, 0.0),
            "spans_dropped": int(spans.get("dropped", 0)),
            "clock_drift_ns": int(drift),
        },
    }

