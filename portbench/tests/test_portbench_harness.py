"""The benchmark's harness on the CPU: lookup by name, the generators, the
trie's work count, the result line from a tiny configuration served by
`DecodeServer(device="cpu")`, correctness failing under planted faults and
under the control, additions by files alone, and the import rule. The
last test runs a real cell on the card and skips here."""

import ast
import json
import math
import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import control, harness
from portbench import run as run_mod
from portbench.drivers.serve import Record, Served

ROOT = Path(harness.ROOT)
SPEC = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = [m["name"] for m in SPEC["end_to_end"]]


def tiny(cell, data_root, seed=2 ** 31 + 77, seconds=1.5, roots=None):
    run = harness.Run(cell, seed, seconds, False, time.monotonic(), device="cpu",
                      roots=roots or [data_root])
    return run, run_mod.execute(run, harness.benchmark_metrics(cell, False, SPEC))


# -- finding the parts by name -------------------------------------------------
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_parts_by_name(cell):
    run = harness.Run(cell, 1, 30, False, time.monotonic())
    assert run.cell["name"] == cell and run.cell["config"] == run.config["name"]
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert (w["config"], w["traffic"]) == (run.cell["config"], run.cell["traffic"])
    assert harness.load_module("gen", run.mix["kind"]).make
    assert harness.load_module("drivers", run.cell["driver"]).run
    assert run.arch.make_params and run.arch.engine_config and run.arch.KERNEL_LIBRARIES
    assert run.shape.vocab == run.config["vocab_size"] and run.reference.logits_at
    for trace in (False, True):
        for name in harness.benchmark_metrics(cell, trace, SPEC):
            assert harness.load_module("metrics" if trace else "endtoend", name).read


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader_with_its_unit(group):
    kind = "endtoend" if group == "end_to_end" else "metrics"
    for m in SPEC[group]:
        assert harness.load_module(kind, m["name"]).UNIT == m["unit"]


def test_benchmark_json_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"] and SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        body = json.loads((ROOT.parent / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert harness.load_json("cells", w["name"])["chips"] == w["chips"]
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in SPEC["workloads"]]
    moves = {m["name"]: m.get("workloads", cells) for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in moves and "\n" not in m["layer"]
        # Every cell that reads the metric reports the metric it moves.
        assert set(m.get("workloads", cells)) <= set(moves[m["moves"]])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


# -- the generators --------------------------------------------------------------
def _shapes(streams):
    return sorted((len(t.new), t.max_new) for s in streams for t in s.turns)


MIXES = sorted(p.stem for p in (ROOT / "traffic").glob("*.json"))
OPEN_RAG = {"kind": "open", "rate_per_s": 15.0, "prompt": {"lo": 1024, "hi": 3584},
            "output": {"lo": 32, "hi": 128}}
OPEN_SESSIONS = {"kind": "sessions", "rate_per_s": 6.0, "system_prompts": 8,
                 "system_tokens": 2048, "turns": 4, "new": {"lo": 64, "hi": 256},
                 "output": {"lo": 32, "hi": 128}}


def _mix(mix):
    return mix if isinstance(mix, dict) else harness.load_json("traffic", mix)


@pytest.mark.parametrize("mix", [*MIXES, OPEN_RAG, OPEN_SESSIONS],
                         ids=[*MIXES, "open-rag", "open-sessions"])
def test_a_seed_orders_the_same_work(mix):
    body = _mix(mix)
    gen = harness.load_module("gen", body["kind"])
    a = gen.make(body, 1000, 5, 30.0)
    b = gen.make(body, 1000, 5, 30.0)
    c = gen.make(body, 1000, 2 ** 31 + 9, 30.0)
    assert [s.start_s for s in a] == [s.start_s for s in b]
    assert all(np.array_equal(x.new, y.new) for s, u in zip(a, b) for x, y in zip(s.turns, u.turns))
    assert _shapes(a) == _shapes(c)
    assert not all(np.array_equal(x.new, y.new) for s, u in zip(a, c) for x, y in zip(s.turns, u.turns))
    if "rate_per_s" in body:
        # An open loop asks for the same lengths at the same moments.
        assert [s.start_s for s in a] == [s.start_s for s in c]
        assert [[len(t.new) for t in s.turns] for s in a] == [[len(t.new) for t in s.turns] for s in c]


def test_open_loop_arrivals_fill_the_window_at_the_rate():
    body = dict(OPEN_RAG, rate_per_s=40.0)
    streams = harness.load_module("gen", "open").make(body, 1000, 3, 30.0)
    starts = [s.start_s for s in streams]
    assert len(streams) == 1200 and starts[0] == 0.0
    assert 27.0 < max(starts) < 30.0
    lens = [len(s.turns[0].new) for s in streams]
    assert 1024 <= min(lens) and max(lens) <= 3584
    assert all(32 <= s.turns[0].max_new <= 128 for s in streams)


def test_closed_loop_staggers_the_first_replies():
    body = harness.load_json("traffic", "chat-closed")
    streams = harness.load_module("gen", "closed").make(body, 1000, 11, 30.0)
    assert len(streams) == 128 and all(s.start_s == 0.0 for s in streams)
    first = [s.turns[0].max_new for s in streams]
    later = [t.max_new for s in streams for t in s.turns[1:]]
    assert min(first) < 64 and 256 <= min(later) and max(later) <= 1024
    later_of = [sorted(t.max_new for s in harness.load_module("gen", "closed").make(
        body, 1000, seed, 30.0) for t in s.turns[1:]) for seed in (1, 2)]
    assert sum(later_of[0]) == pytest.approx(sum(later_of[1]), rel=0.05)


@pytest.mark.parametrize("mix", ["agent-closed", OPEN_SESSIONS], ids=["closed", "open"])
def test_sessions_share_system_prompts_and_grow_their_history(mix):
    body = _mix(mix)
    streams = harness.load_module("gen", "sessions").make(body, 1000, 4, 10.0)
    per = int(body.get("sessions_per_client", 1))
    assert all(s.history and len(s.turns) == 4 * per for s in streams)
    if "clients" in body:
        assert len(streams) == body["clients"] and all(s.start_s == 0.0 for s in streams)
    opens = [t for s in streams for t in s.turns if t.fresh]
    assert len(opens) == len(streams) * per
    assert len({tuple(t.new[:2048]) for t in opens}) == 8
    for s in streams:
        for k, t in enumerate(s.turns):
            assert t.fresh == (k % 4 == 0)
            assert 64 <= len(t.new) - (2048 if t.fresh else 0) <= 256


def test_a_fresh_turn_opens_a_new_history(data_root):
    from portbench.drivers.serve import drive, max_prompt
    from portbench.gen import Stream, Turn

    class Echo:
        def __init__(self):
            self.prompts = []

        def submit(self, prompt, max_new):
            from concurrent.futures import Future
            self.prompts.append(list(prompt))
            f = Future()
            f.set_result([9] * max_new)
            return f

    a, b, c = (np.array(x, dtype=np.int32) for x in ([1, 2], [3], [4, 5, 6]))
    st = Stream(0.0, [Turn(a, 2, fresh=True), Turn(b, 1), Turn(c, 2, fresh=True)], history=True)
    assert max_prompt([st]) == 5
    eng = Echo()
    served = drive(eng, [st], 1.0, 5.0)
    assert eng.prompts == [[1, 2], [1, 2, 9, 9, 3], [4, 5, 6]]
    assert [r.turn for r in served.records] == [0, 1, 2]


# -- the trie's work count ---------------------------------------------------------
def test_work_counts_only_tokens_no_earlier_request_held(data_root):
    run = harness.Run("tiny.sessions", 1, 10.0, False, 0.0, device="cpu", roots=[data_root])
    sysp = np.arange(24, dtype=np.int32)
    a1 = Record(0, 0, 0.0, 0.0, np.concatenate([sysp, [100, 101]]).astype(np.int32), 3,
                done=1.0, out=np.array([7, 8, 9]))
    b1 = Record(1, 0, 0.5, 0.5, np.concatenate([sysp, [200]]).astype(np.int32), 3,
                done=1.5, out=np.array([1, 2, 3]))
    a2 = Record(0, 1, 1.0, 1.0, np.concatenate([a1.prompt, a1.out, [50, 51]]).astype(np.int32),
                3, done=2.0, out=np.array([4, 5, 6]))
    run.served = Served([a1, b1, a2], 10.0, 3.0)
    w = run.work
    assert w.prompt_tokens == 26 + 25 + 31
    assert w.cached_tokens == 0 + 24 + 29
    assert w.prefill_tokens == 26 + 1 + 2
    assert w.decode_tokens == 6


def test_the_check_samples_whole_requests_from_across_the_window():
    from portbench import check

    recs = [Record(i % 16, 0, 0.1 * i, 0.1 * i, np.zeros(10 + i, dtype=np.int32), 50,
                   done=0.1 * i + 5, out=np.arange(40 + (i == 7) * 900)) for i in range(100)]
    recs.append(Record(0, 1, 9.0, 9.0, np.zeros(5, dtype=np.int32), 4, error="boom"))
    picked = check.sample(recs, 2 ** 31 + 11, 8)
    assert len(picked) == 8 and picked[0] is recs[7]
    assert len({id(r) for r in picked}) == 8 and all(r.error is None for r in picked)
    assert len({r.stream for r in picked}) >= 4 and max(r.sent for r in picked[1:]) > 1.0
    assert [id(r) for r in check.sample(recs, 2 ** 31 + 11, 8)] == [id(r) for r in picked]
    assert [id(r) for r in check.sample(recs, 3, 8)] != [id(r) for r in picked]


# -- a run's result line --------------------------------------------------------
def test_the_last_line_of_a_tiny_cpu_run(data_root):
    run, res = tiny("tiny.chat", data_root)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 4
    assert set(res["metrics"]) == set(harness.benchmark_metrics("tiny.chat", False, SPEC))
    for name, m in res["metrics"].items():
        assert m["unit"] == harness.load_module("endtoend", name).UNIT
        assert m["value"] > 0 and math.isfinite(m["value"])
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    gap = res["checks"]["max_logit_gap"]
    assert gap["value"] <= gap["limit"] and res["checks"]["unfinished_requests"]["value"] == 0
    json.dumps(res)


def test_per_layer_readers_without_a_trace_read_nothing_or_the_engine(data_root):
    run, _ = tiny("tiny.sessions", data_root, seconds=1.5)
    got = run.read("metrics", [m["name"] for m in SPEC["per_layer"]])
    assert "prefix_hit_share" in got and got["prefix_hit_share"]["value"] > 0
    assert "queue_wait_p95_s" in got
    for name in ("serve_mfu", "decode_attn_roofline", "window_attn_roofline",
                 "device_idle_share", "host_overhead_ms_per_tick"):
        assert name not in got


def test_without_a_card_a_run_exits_non_zero_and_prints_no_result(monkeypatch, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH", "USE_FLAX", "USE_JAX"):
        monkeypatch.setenv(var, "")
    rc = run_mod.main(["--workload", SPEC["workloads"][0]["name"], "--seed", str(2 ** 31 + 3),
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA device" in out.err


# -- correctness fails where it must ----------------------------------------------
def _alter_token(monkeypatch):
    from nos_tpu_torch.runtime import decode_server as ds

    orig = ds.greedy
    monkeypatch.setattr(ds, "greedy", lambda logits: (orig(logits) + 1) % logits.shape[-1])


def _state_unchanged(monkeypatch):
    from nos_tpu_torch.models import decode

    monkeypatch.setattr(decode, "_write_kv", lambda lc, pages, offs, k, v, amax=(None, None): {})


def _half_the_batch(monkeypatch):
    from nos_tpu_torch.runtime import decode_server as ds

    orig = ds.paged_decode_step

    def step(params, token, cfg, pcache, table, pos, mask, *a, **k):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = False
        return orig(params, token, cfg, pcache, table, pos, mask, *a, **k)

    monkeypatch.setattr(ds, "paged_decode_step", step)


@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged, _half_the_batch])
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(fault, monkeypatch, data_root):
    # The exchange between chips has no fault to plant: every cell runs on one chip.
    fault(monkeypatch)
    _, res = tiny("tiny.chat", data_root)
    assert res["correct"] is False
    gap = res["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"] or res["failed"] > 0


def test_the_control_fails_the_limit_that_the_program_meets(data_root):
    # Each seed compares every request it finished (the cell's `requests`
    # is the tiny mix's 16) in a window long enough to finish most of them
    # on a loaded CPU: a sample of a few short requests can leave the
    # control under the limit.
    rows = list(control.readings("tiny.chat", [5, 6, 7], 3.0, device="cpu", roots=[data_root]))
    for row in rows:
        assert row["max_logit_gap"] <= row["limit"] < row["control_max_logit_gap"]


# -- adding by files alone ------------------------------------------------------------
def test_a_mix_a_cell_and_a_metric_added_as_files_alone(tmp_path, data_root):
    for sub in ("gen", "traffic", "cells", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "gen" / "pairs.py").write_text(
        "from portbench.gen import Stream, Turn, rng_for, tokens\n"
        "def make(mix, vocab, seed, seconds):\n"
        "    rng = rng_for(seed)\n"
        "    return [Stream(0.25 * i, [Turn(tokens(rng, vocab, mix['prompt']), 4)] * 2,"
        " history=True) for i in range(mix['pairs'])]\n")
    (tmp_path / "traffic" / "tiny-pairs.json").write_text('{"kind": "pairs", "pairs": 3, "prompt": 12}')
    cell = json.loads((Path(data_root) / "cells" / "tiny.chat.json").read_text())
    cell.update(name="tiny.pairs", traffic="tiny-pairs")
    (tmp_path / "cells" / "tiny.pairs.json").write_text(json.dumps(cell))
    (tmp_path / "metrics" / "turns_sent.py").write_text(
        "UNIT = 'requests'\ndef read(run):\n    return len(run.served.records)\n")
    run, res = tiny("tiny.pairs", data_root, roots=[str(tmp_path), data_root])
    assert res["correct"] is True and res["attempted"] == 6
    assert run.read("metrics", ["turns_sent"]) == {"turns_sent": {"value": 6.0, "unit": "requests"}}


def _config_and_cell(tmp_path, data_root, config, cell, **changes):
    """A copy of the tiny configuration (`changes` applied, None deletes a
    key) and of tiny.chat naming it, both under `tmp_path`."""
    for sub in ("configs", "cells"):
        (tmp_path / sub).mkdir(exist_ok=True)
    body = json.loads((Path(data_root) / "configs" / "tiny.json").read_text())
    body.update(name=config, **changes)
    body = {k: v for k, v in body.items() if v is not None}
    (tmp_path / "configs" / f"{config}.json").write_text(json.dumps(body))
    chat = json.loads((Path(data_root) / "cells" / "tiny.chat.json").read_text())
    chat.update(name=cell, config=config)
    (tmp_path / "cells" / f"{cell}.json").write_text(json.dumps(chat))


def test_an_architecture_added_as_files_alone(tmp_path, data_root):
    for sub in ("arch", "references"):
        (tmp_path / sub).mkdir()
    (tmp_path / "arch" / "tinyalt.py").write_text(
        "import dataclasses\n"
        "from portbench.arch import llama\n"
        "KERNEL_LIBRARIES = llama.KERNEL_LIBRARIES\n"
        "make_params, engine_config = llama.make_params, llama.engine_config\n"
        "class Shape(llama.Shape):\n"
        "    def linear_flops(self):\n"
        "        return 2 * super().linear_flops()\n"
        "def shape(config):\n"
        "    return Shape(**dataclasses.asdict(llama.shape(config)))\n")
    (tmp_path / "references" / "tinyalt.py").write_text(
        "from portbench.references import llama\n"
        "CALLS = []\n"
        "def logits_at(params, config, tokens, first, quant=None):\n"
        "    CALLS.append(len(tokens))\n"
        "    return llama.logits_at(params, config, tokens, first, quant=quant)\n")
    _config_and_cell(tmp_path, data_root, "tinyalt", "tiny.alt", arch="tinyalt")
    run, res = tiny("tiny.alt", data_root, roots=[str(tmp_path), data_root])
    assert res["correct"] is True and res["failed"] == 0
    # The configuration's own reference judged every compared request.
    from portbench import check

    picked = check.sample(run.served.records, run.seed, run.cell["check"]["requests"])
    assert len(run.reference.CALLS) == len(picked) >= 4
    assert run.reference.__file__ == str(tmp_path / "references" / "tinyalt.py")
    doubled = vars(run.work)
    # The same records under the dense count: the linear layers ran once
    # for each prefilled token and each decode step.
    dense_shape = harness.load_module("arch", "llama").shape(run.config)
    del run.__dict__["work"]
    run.__dict__["shape"] = dense_shape
    dense = vars(run.work)
    passes = dense["prefill_tokens"] + dense["decode_tokens"]
    assert passes > 0
    assert doubled["model_flops"] == pytest.approx(
        dense["model_flops"] + passes * dense_shape.linear_flops(), rel=1e-12)
    assert {k: v for k, v in doubled.items() if k != "model_flops"} == {
        k: v for k, v in dense.items() if k != "model_flops"}


def test_a_configuration_without_arch_is_refused_by_its_file(tmp_path, data_root):
    _config_and_cell(tmp_path, data_root, "noarch", "tiny.noarch", arch=None)
    with pytest.raises(ValueError, match=r"noarch\.json names no 'arch'"):
        harness.Run("tiny.noarch", 1, 1.0, False, time.monotonic(), device="cpu",
                    roots=[str(tmp_path), data_root])


# -- the import rule -------------------------------------------------------------
def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert files
    for path in files:
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    refs = sorted((ROOT / "references").glob("*.py"))
    assert refs
    for path in refs + [ROOT / name for name in ("work.py", "stats.py", "check.py")]:
        assert not set(_imports(path)) & {"nos_tpu_torch", *harness.FORBIDDEN}, path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nos_tpu_torch_x", object())
    assert "nos_tpu" not in harness.forbidden_modules() or "nos_tpu" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "nos_tpu.fake", object())
    assert "nos_tpu" in harness.forbidden_modules()


# -- on the card ---------------------------------------------------------------------
@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct_and_its_control_is_not(cuda):
    row = next(control.readings("smollm2-1.7b.chat-decode", [2 ** 31 + 5], 4.0))
    assert row["unfinished"] == 0
    assert row["max_logit_gap"] <= row["limit"] < row["control_max_logit_gap"]


# -- the trace's reduction, on fake Kineto events ------------------------------------
class _Ev:
    def __init__(self, cuda, name, start=0, dur=0, corr=0):
        import torch

        self._d = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
        self._n, self._s, self._u, self._c = name, start, dur, corr

    def device_type(self):
        return self._d

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c


def test_the_trace_reduces_to_a_union_sums_by_name_and_named_gaps():
    from types import SimpleNamespace

    from portbench.trace import Trace

    events = [_Ev(False, "cudaGraphLaunch", corr=1), _Ev(False, "cudaLaunchKernel", corr=3),
              _Ev(True, "void nos::split::split_decode_kernel<64, 2>(Params)", 100, 50, 1),
              _Ev(True, "void at::native::elementwise_kernel<128, 4>(int, F)", 120, 60, 1),
              _Ev(True, "window_mma_kernel(WindowMmaParams)", 400, 100, 3)]
    tr = Trace()
    tr._prof = SimpleNamespace(stop=lambda: None, profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr._t0 = 0.0
    tr._reduce(0.0)
    assert tr.kernel_count == 3
    assert tr.busy_s == pytest.approx(180e-9)
    assert tr.kernel_seconds("split_decode_kernel") == pytest.approx(50e-9)
    assert tr.kernel_seconds("window_mma_kernel", "paged_attention_kernel") == pytest.approx(100e-9)
    assert tr.gap_totals == {"cudaLaunchKernel -> window_mma_kernel": pytest.approx(220e-9)}
    b = tr.breakdown()
    assert b["device_ops"][0] == ["window_mma_kernel", pytest.approx(100e-9)]
    assert len(b["device_ops"]) == 3 and len(b["idle_gaps"]) == 1
