"""Port of `nos_tpu/analysis/__init__.py:1` (:1-102). Copied near verbatim; the
imports point at the port, which imports nothing of the JAX package. The
six checkers whose rules the reference writes in JAX (trace_safety,
host_sync, staging_discipline, device_placement, donation_discipline,
quant_discipline) carry PyTorch counterparts of those rules; the codes and
the engine are the reference's.

Domain-aware static analysis for the nos_tpu_torch tree
(`python -m nos_tpu_torch.cli lint`).

The system's correctness hangs off conventions no general-purpose linter
checks: the `tpu.nos/...` annotation/label wire protocol between the central
partitioner and node agents (constants.py), hand-rolled lock discipline in the
threaded controllers/runtimes, and capture/compile purity in the workload
plane.
The reference `nos` operator gets `go vet`/staticcheck for this class of bug;
this package is the Python rebuild's equivalent — a single-pass AST framework
with pluggable domain checkers, structured `file:line` findings, and a
committed suppression baseline (lint-baseline-torch.txt), gated in tier-1
by tests/test_torch_static_analysis.py.

Since the interprocedural layer (analysis/callgraph.py), the engine builds
ONE whole-tree call graph per run and routes every reachability question
through it; findings are cached per file content hash (analysis/cache.py)
so warm runs only re-analyze what changed.

Checker codes (`all_codes()` is the authoritative list; the docs table in
docs/static-analysis.md is gated against it):
  NOS001  wire-protocol string literal outside constants.py
  NOS002  one-sided/dead protocol constant (no writer or no reader)
  NOS003  broad `except` swallows the error silently
  NOS004  bare `except:`
  NOS005  lock-guarded attribute mutated without holding the lock
  NOS006  lock-order inversion in the static lock-acquisition graph
  NOS007  impure call inside a captured/compiled function
  NOS008  float `==`/`!=` comparison in numeric code
  NOS009  unseeded global-RNG draw on a simulation/planner path
  NOS010  host-blocking call on the engine tick path
  NOS011  paged-pool bookkeeping mutated outside the BlockManager
  NOS012  tick/recovery-path broad except bypasses the fault taxonomy
  NOS013  spill-tier state mutated outside the SpillTier
  NOS014  tracing event names / recorder state outside their APIs
  NOS015  non-staged host->device upload on the tick path
  NOS016  per-device placement on the tick path
  NOS017  radix-tree node structure mutated outside the tree classes
  NOS018  cost/accounting identity violation
  NOS019  fleet KV store discipline violation
  NOS020  use-after-donate: a replayed graph's output read after a later replay
  NOS021  replay/classify closure reads clocks, global RNG, or live state
  NOS022  telemetry schema drift (emit vs registry vs report vs docs)
  NOS023  unused inline `# nos-lint: ignore[...]` suppression
  NOS000  engine-level finding (unreadable/unparseable file)
"""

from __future__ import annotations

from typing import List

from nos_tpu_torch.analysis.baseline import (
    BaselineEntry,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from nos_tpu_torch.analysis.cache import CACHE_BASENAME, LintCache, package_salt
from nos_tpu_torch.analysis.checkers import all_checkers
from nos_tpu_torch.analysis.core import ENGINE_CODES, Checker, Engine, FileContext, Finding

__all__ = [
    "BaselineEntry",
    "CACHE_BASENAME",
    "Checker",
    "Engine",
    "FileContext",
    "Finding",
    "LintCache",
    "all_checkers",
    "all_codes",
    "apply_baseline",
    "load_baseline",
    "run",
    "write_baseline",
]


def all_codes() -> List[str]:
    """Every finding code a default lint run can emit: the union of the
    registered checkers' codes and the engine's own (NOS000 unreadable
    input, NOS023 unused suppression). The docs drift gate pins the
    docs/static-analysis.md table against exactly this list."""
    codes = set(ENGINE_CODES)
    for checker in all_checkers():
        codes.update(checker.codes)
    return sorted(codes)


def run(paths, baseline_path=None, checkers=None, root=None, cache_path=None):
    """One-call entry point: analyze `paths`, apply the baseline, return
    (findings, suppressed, stale_entries). Used by the CLI and the tier-1
    gate so both agree bit-for-bit. `cache_path` enables the incremental
    cache (per-file findings reused when content hashes match); runs
    without it are always cold."""
    engine = Engine(checkers if checkers is not None else all_checkers(), root=root)
    cache = LintCache(cache_path, package_salt(None)) if cache_path else None
    findings = engine.run(paths, cache=cache)
    if cache is not None:
        cache.write()
    if baseline_path is None:
        return findings, [], []
    entries = load_baseline(baseline_path)
    return apply_baseline(findings, entries)
