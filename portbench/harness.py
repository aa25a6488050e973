"""Find a cell's parts by name, run it, and build its result line.

A cell `<cell>` is `cells/<cell>.json`; it names its configuration
(`configs/<config>.json`, whose `arch` selects `arch/<arch>.py` for the
weights, the engine's model config, the kernel libraries and the work
count, and `references/<arch>.py` for the plain reference), its traffic
mix (`traffic/<mix>.json`, whose `kind` selects `gen/<kind>.py`) and its
driver (`drivers/<driver>.py`).
The metrics a run reports are those `BENCHMARK.json` lists for the cell:
its `end_to_end` metrics with `--trace 0`, its `per_layer` metrics with
`--trace 1`, each computed by the reader of the same name under
`endtoend/` or `metrics/` (`UNIT`, `read(run) -> value or None`). A reader
that finds nothing to read returns None and the metric is left out.
Adding a cell, a mix, a configuration, an architecture or a metric is
adding files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from functools import cached_property
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
#: Top-level module names the benchmark's process may never hold: JAX and
#: the JAX package the port was made from (compared whole: the port's
#: name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "nos_tpu")


def _find(kind: str, name: str, suffix: str, roots) -> Path:
    """`<root>/<kind>/<name><suffix>` in the first of `roots` that holds it,
    then in the benchmark's own folder."""
    for root in (*roots, ROOT):
        path = Path(root) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    return ROOT / kind / f"{name}{suffix}"


def load_json(kind: str, name: str, roots=()) -> Dict:
    path = _find(kind, name, ".json", roots)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} entry named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, roots=()):
    """The module `<kind>/<name>.py`, loaded from its file (names may hold
    characters an import statement cannot)."""
    path = _find(kind, name, ".py", roots)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    key = f"portbench._{kind}_{name}_{abs(hash(str(path)))}".replace("-", "_").replace(".", "_")
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def benchmark_metrics(cell: str, trace: bool, spec: Optional[Dict] = None) -> List[str]:
    """The metric names BENCHMARK.json gives `cell` for this kind of run."""
    if spec is None:
        spec = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m["name"] for m in group if "workloads" not in m or cell in m["workloads"]]


class Run:
    """One run of one cell: its parts, and what the driver leaves in it for
    the readers."""

    def __init__(self, cell_name: str, seed: int, seconds: float, trace: bool,
                 t_process: float, device: str = "cuda", roots=()):
        self.roots = tuple(roots)
        self.cell = load_json("cells", cell_name, self.roots)
        self.name = cell_name
        self.config = load_json("configs", self.cell["config"], self.roots)
        if "arch" not in self.config:
            path = _find("configs", self.cell["config"], ".json", self.roots)
            raise ValueError(f"configuration {path} names no 'arch' (arch/<arch>.py and "
                             "references/<arch>.py)")
        self.mix = load_json("traffic", self.cell["traffic"], self.roots)
        self.device = device
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.t_process = t_process
        self.t_open: Optional[float] = None
        self.served = None
        self.trace_data = None
        self.counters = ({}, {})
        self.memory_peak_bytes = 0
        self.params = None
        self.warm_requests = 0
        #: Seconds of set-up by part (imports and CUDA context, the kernel
        #: library's build, weights, engine with its pool and window
        #: capture, warm requests).
        self.setup_parts: Dict[str, float] = {}

    def make_traffic(self):
        gen = load_module("gen", self.mix["kind"], self.roots)
        return gen.make(self.mix, int(self.shape.vocab), self.seed, self.seconds)

    def open_window(self) -> None:
        self.t_open = time.monotonic()

    @property
    def setup_s(self) -> float:
        return self.t_open - self.t_process

    @cached_property
    def arch(self):
        """`arch/<arch>.py`: weights, engine config, kernel libraries and
        the work count of the configuration's architecture."""
        return load_module("arch", self.config["arch"], self.roots)

    @cached_property
    def reference(self):
        """`references/<arch>.py`: the plain forward (`logits_at`) that
        judges the served tokens."""
        return load_module("references", self.config["arch"], self.roots)

    @cached_property
    def shape(self):
        return self.arch.shape(self.config)

    @cached_property
    def work(self):
        """The work the window's requests needed (`work.py` over the
        architecture's `shape`), prompt tokens counted as prefill only where
        no earlier request held them: the benchmark's own trie sees each
        prompt when it is sent and each reply when it arrives, in that
        order."""
        from portbench.work import PrefixTrie, Work

        events = []
        for r in self.served.records:
            events.append((r.sent, 1, id(r), r))
            if r.out is not None:
                events.append((r.done, 0, id(r), r))
        events.sort(key=lambda e: (e[0], e[1], e[2]))
        trie, w, cached = PrefixTrie(), Work(), {}
        block = int(self.cell["engine"].get("block_size", 32))
        for _, kind, key, r in events:
            if kind == 1:
                prompt = r.prompt.tolist()
                cached[key] = trie.match(prompt)
                trie.insert(prompt)
            else:
                trie.insert(r.prompt.tolist() + r.out.tolist())
        for r in self.served.records:
            w.add(self.shape, len(r.prompt), cached[id(r)], r.n_out, block)
        return w

    def read(self, kind: str, names: List[str]) -> Dict[str, Dict]:
        out = {}
        for name in names:
            mod = load_module(kind, name, self.roots)
            value = mod.read(self)
            if value is not None and math.isfinite(value):
                out[name] = {"value": float(value), "unit": mod.UNIT}
        return out
