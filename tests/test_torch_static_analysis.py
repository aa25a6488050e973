"""The port's static-analysis suite (`nos_tpu_torch/analysis/`, `cli lint`).

The cases of tests/test_static_analysis.py run on the port through
`torch_mirror`: the reference's bodies, fixtures and assertions line for
line, with `nos_tpu` pointed at `nos_tpu_torch` (so `TREE` is the port's
tree). Left out are the reference's tree gate, which reads the reference's
`lint-baseline.txt` (the port's gate is below, over the port's baseline),
and the cases that exercise the JAX fixtures of the six checkers whose
rules the port writes for PyTorch (`REWRITTEN`): their counterparts run
here over `tests/analysis_fixtures/torch/`, where every line a positive
fixture expects a finding on carries a `# NOSxxx` marker, and each
checker's findings must be exactly those lines."""

import os
import re
from functools import lru_cache

import pytest
import test_torch_fleet_parity as fp
import torch_mirror

from nos_tpu_torch import analysis
from nos_tpu_torch.analysis.checkers.device_placement import DevicePlacementChecker
from nos_tpu_torch.analysis.checkers.donation_discipline import DonationDisciplineChecker
from nos_tpu_torch.analysis.checkers.host_sync import HostSyncChecker
from nos_tpu_torch.analysis.checkers.quant_discipline import QuantDisciplineChecker
from nos_tpu_torch.analysis.checkers.replay_purity import ReplayPurityChecker
from nos_tpu_torch.analysis.checkers.staging_discipline import StagingDisciplineChecker
from nos_tpu_torch.analysis.checkers.trace_safety import TraceSafetyChecker

_time_limit = fp.time_limit(90)
_reset_state = torch_mirror.reset_state()

# The reference's cases on the JAX fixtures of the six rewritten checkers
# (and its tree gate); every other case is mirrored.
REWRITTEN = (
    "test_tree_has_zero_non_baselined_findings",
    "test_trace_safety_positives",
    "test_trace_safety_negatives",
    "test_host_sync_positives",
    "test_host_sync_negatives",
    "test_staging_discipline_positives",
    "test_staging_discipline_negatives",
    "test_staging_discipline_scope_needs_runtime_dir",
    "test_staging_discipline_sanctioned_site_suppressed_inline",
    "test_device_placement_positives",
    "test_device_placement_negatives",
    "test_device_placement_scope_needs_runtime_dir",
    "test_device_placement_sanctioned_site_suppressed_inline",
    "test_donation_pos_fixture_flags_every_pattern",
    "test_donation_neg_fixture_is_clean",
    "test_donation_self_attr_read_line_is_the_read_not_the_call",
    "test_donation_out_of_scope_dirs_ignored",
    "test_quant_discipline_positives",
    "test_quant_discipline_negatives",
    "test_quant_discipline_scopes",
)
MIRRORED = [
    name
    for name in re.findall(
        r"^def (test_\w+)",
        (torch_mirror.TESTS / "test_static_analysis.py").read_text(),
        re.M,
    )
    if name not in REWRITTEN
]
torch_mirror.mirror(globals(), "test_static_analysis", only=MIRRORED)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = os.path.join(REPO, "nos_tpu_torch")
PORT_BASELINE = os.path.join(REPO, "lint-baseline-torch.txt")
TORCH_FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures", "torch")
_MARKER = re.compile(r"#\s*(NOS\d{3})\s*$")


def _lint(paths, checkers, root=REPO):
    return analysis.Engine(checkers, root=root).run(
        paths if isinstance(paths, list) else [paths]
    )


def _marked(path):
    """(code, line) for every line of a fixture that carries a marker."""
    with open(path, encoding="utf-8") as fh:
        return sorted(
            (m.group(1), n)
            for n, line in enumerate(fh, start=1)
            if (m := _MARKER.search(line))
        )


# -- the port's tree gate -------------------------------------------------------
def test_port_tree_has_zero_non_baselined_findings():
    findings, suppressed, stale = analysis.run(
        [PORT_TREE], baseline_path=PORT_BASELINE, root=REPO
    )
    assert not findings, "new static-analysis findings:\n" + "\n".join(
        f.render() for f in findings
    )
    assert not stale, "stale baseline entries:\n" + "\n".join(e.render() for e in stale)
    entries = analysis.load_baseline(PORT_BASELINE)
    assert [e.code for e in entries] == ["NOS002"]
    assert len(suppressed) == len(entries)
    for entry in entries:
        assert entry.rationale, f"baseline entry without rationale: {entry.render()}"


def test_port_inline_suppressions_name_their_code():
    """Every inline suppression of the port names the code it silences (a
    blanket one would hide every other checker's finding on its line)."""
    blanket = []
    for path in analysis.Engine.discover([PORT_TREE]):
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        for line, codes in analysis.Engine._scan_ignores(source).items():
            if codes is None:
                blanket.append(f"{os.path.relpath(path, REPO)}:{line}")
    assert blanket == []


# -- the six rewritten checkers on their torch fixtures --------------------------
POSITIVES = [
    ("ops/trace_pos.py", TraceSafetyChecker),
    ("scheduler/rng_pos.py", TraceSafetyChecker),
    ("runtime/host_sync_pos.py", HostSyncChecker),
    ("runtime/staging_pos.py", StagingDisciplineChecker),
    ("runtime/device_place_pos.py", DevicePlacementChecker),
    ("runtime/donate_pos.py", DonationDisciplineChecker),
    ("runtime/quant_pos.py", QuantDisciplineChecker),
    ("serving/replay_pos.py", ReplayPurityChecker),
]
NEGATIVES = [(rel.replace("_pos", "_neg"), checker) for rel, checker in POSITIVES]


@pytest.mark.parametrize("rel,checker", POSITIVES, ids=[r for r, _ in POSITIVES])
def test_torch_positive_fixture_flags_every_marked_line(rel, checker):
    path = os.path.join(TORCH_FIXTURES, rel)
    want = _marked(path)
    assert want
    got = sorted((f.code, f.line) for f in _lint(path, [checker()]))
    assert got == want


@pytest.mark.parametrize("rel,checker", NEGATIVES, ids=[r for r, _ in NEGATIVES])
def test_torch_negative_fixture_is_clean(rel, checker):
    path = os.path.join(TORCH_FIXTURES, rel)
    assert _marked(path) == []
    assert _lint(path, [checker()]) == []


def test_trace_safety_reasons_name_the_torch_wrappers():
    findings = _lint(os.path.join(TORCH_FIXTURES, "ops", "trace_pos.py"),
                     [TraceSafetyChecker()])
    nos7 = " | ".join(f.message for f in findings if f.code == "NOS007")
    assert "time." in nos7 and "print()" in nos7 and "np.random" in nos7
    assert "global mutation" in nos7 and "random." in nos7
    assert "captured/compiled" in nos7
    rng = _lint(os.path.join(TORCH_FIXTURES, "scheduler", "rng_pos.py"),
                [TraceSafetyChecker()])
    msgs = " | ".join(f.message for f in rng)
    assert "torch.randperm()" in msgs and "torch.Generator" in msgs
    assert "torch.manual_seed() (reseeds the global generator)" in msgs


def test_host_sync_reasons_name_each_blocking_read():
    findings = _lint(os.path.join(TORCH_FIXTURES, "runtime", "host_sync_pos.py"),
                     [HostSyncChecker()])
    msgs = " | ".join(f.message for f in findings)
    for read in (".item()", ".tolist()", ".cpu()", ".numpy()", "np.asarray()",
                 "np.array()", "torch.cuda.synchronize()", ".synchronize()"):
        assert read in msgs, read


def test_staging_and_placement_messages_point_at_the_funnel():
    staging = _lint(os.path.join(TORCH_FIXTURES, "runtime", "staging_pos.py"),
                    [StagingDisciplineChecker()])
    assert all("HostStage.to_device" in f.message for f in staging)
    msgs = " | ".join(f.message for f in staging)
    assert "torch.tensor(..., device=)" in msgs and "torch.from_numpy().to()" in msgs
    placement = _lint(os.path.join(TORCH_FIXTURES, "runtime", "device_place_pos.py"),
                      [DevicePlacementChecker()])
    msgs = " | ".join(f.message for f in placement)
    assert "set_device" in msgs and "'cuda:N'" in msgs and "device_count" in msgs


def test_donation_messages_name_the_replay_and_the_loop():
    findings = _lint(os.path.join(TORCH_FIXTURES, "runtime", "donate_pos.py"),
                     [DonationDisciplineChecker()])
    msgs = "\n".join(f.message for f in findings)
    assert "read here without rebinding" in msgs
    assert "inside a loop that replays the graph again but never rebound" in msgs
    assert "'self._last'" in msgs and "'self._window'" in msgs


def test_quant_messages_name_the_inplace_write():
    findings = _lint(os.path.join(TORCH_FIXTURES, "runtime", "quant_pos.py"),
                     [QuantDisciplineChecker()])
    msgs = " | ".join(f.message for f in findings)
    for what in ("via .index_copy_()", "via .scatter_reduce_()", "via .fill_()",
                 "via .zero_()", "dequantize", "outside nos_tpu_torch/ops/"):
        assert what in msgs, what


# -- scopes: the same code outside its checker's directories is clean ----------------
SCOPED = [
    (
        TraceSafetyChecker,
        "ops",
        "import time\nimport torch\n@torch.compile\ndef f(x):\n    return time.time()\n",
    ),
    (
        TraceSafetyChecker,
        "scheduler",
        "import torch\ndef jitter(n):\n    return torch.randn(n)\n",
    ),
    (
        HostSyncChecker,
        "runtime",
        "class Engine:\n    def _tick(self):\n        return self.lens.tolist()\n",
    ),
    (
        StagingDisciplineChecker,
        "runtime",
        "import torch\nclass Engine:\n    def _tick(self):\n"
        "        return torch.tensor(self.queue, device=self.device)\n",
    ),
    (
        DevicePlacementChecker,
        "runtime",
        "class Engine:\n    def _tick(self):\n        return self.buf.to('cuda:1')\n",
    ),
    (
        DonationDisciplineChecker,
        "runtime",
        "def bad(g):\n    out = g.replay()\n    g.replay()\n    return out\n",
    ),
    (
        QuantDisciplineChecker,
        "models",
        "def hack(lc, b, s):\n    lc['k_scale'].index_put_((b,), s)\n",
    ),
]


@pytest.mark.parametrize(
    "checker,scope,source", SCOPED, ids=[c.__name__ for c, _, _ in SCOPED]
)
def test_torch_rule_binds_only_in_its_scope(tmp_path, checker, scope, source):
    inside = tmp_path / scope / "mod.py"
    inside.parent.mkdir()
    inside.write_text(source)
    outside = tmp_path / "elsewhere" / "mod.py"
    outside.parent.mkdir()
    outside.write_text(source)
    assert len(_lint(str(inside), [checker()], root=str(tmp_path))) == 1
    assert _lint(str(outside), [checker()], root=str(tmp_path)) == []


def test_quant_rule_exempts_the_ops_funnel(tmp_path):
    body = "def funnel(lc, b, s):\n    lc['k_scale'][b] = s\n    lc['v_scale'].copy_(s)\n"
    for scope, count in (("ops", 0), ("runtime", 2), ("serving", 2), ("models", 2)):
        f = tmp_path / scope / "quantized_kv_like.py"
        f.parent.mkdir()
        f.write_text(body)
        found = _lint(str(f), [QuantDisciplineChecker()], root=str(tmp_path))
        assert len(found) == count, scope


# -- a sanctioned inline suppression is honoured ----------------------------------
SANCTIONED = [
    (
        HostSyncChecker,
        "NOS010",
        "        a = self._event.synchronize()  # nos-lint: ignore[NOS010]\n"
        "        b = self.lens.cpu()\n",
    ),
    (
        StagingDisciplineChecker,
        "NOS015",
        "        a = torch.tensor([1, 2], device=self.device)  # nos-lint: ignore[NOS015]\n"
        "        b = torch.as_tensor(self.queue, device=self.device)\n",
    ),
    (
        DevicePlacementChecker,
        "NOS016",
        "        a = torch.device('cuda', 0)  # nos-lint: ignore[NOS016]\n"
        "        b = torch.device('cuda', 1)\n",
    ),
    (
        TraceSafetyChecker,
        "NOS007",
        "        with torch.cuda.graph(self.g):\n"
        "            a = time.time()  # nos-lint: ignore[NOS007]\n"
        "            b = time.time()\n",
    ),
]


@pytest.mark.parametrize(
    "checker,code,body", SANCTIONED, ids=[c for _, c, _ in SANCTIONED]
)
def test_torch_sanctioned_site_suppressed_inline(tmp_path, checker, code, body):
    runtime = tmp_path / "runtime"
    runtime.mkdir()
    f = runtime / "engine.py"
    f.write_text(
        "import time\nimport torch\n"
        "class Engine:\n"
        "    def _tick(self):\n" + body + "        return a, b\n"
    )
    findings = _lint(str(runtime), [checker()], root=str(tmp_path))
    last = 5 + body.count("\n") - 1
    assert [(x.code, x.line) for x in findings] == [(code, last)]


def test_donation_sanctioned_site_suppressed_inline(tmp_path):
    runtime = tmp_path / "runtime"
    runtime.mkdir()
    f = runtime / "engine.py"
    f.write_text(
        "def window(g):\n"
        "    a = g.replay()\n"
        "    b = g.replay()\n"
        "    keep = a  # nos-lint: ignore[NOS020]\n"
        "    c = g.replay()\n"
        "    return keep, b\n"
    )
    findings = _lint(str(runtime), [DonationDisciplineChecker()], root=str(tmp_path))
    assert [(x.code, x.line) for x in findings] == [("NOS020", 6)]


# -- the port's real tree is clean for each rewritten code --------------------------
@lru_cache(maxsize=None)
def _port_tree_findings():
    return tuple(
        _lint(
            PORT_TREE,
            [
                TraceSafetyChecker(),
                HostSyncChecker(),
                StagingDisciplineChecker(),
                DevicePlacementChecker(),
                DonationDisciplineChecker(),
                QuantDisciplineChecker(),
            ],
        )
    )


@pytest.mark.parametrize(
    "code",
    ["NOS007", "NOS008", "NOS009", "NOS010", "NOS015", "NOS016", "NOS020", "NOS024"],
)
def test_torch_rule_real_port_tree_is_clean(code):
    findings = [f for f in _port_tree_findings() if f.code == code]
    assert findings == [], "\n".join(f.render() for f in findings)


def test_tick_rules_reach_the_engines_sanctioned_reads(tmp_path):
    """The tick path the rules walk is the real one: with its two inline
    suppressions dropped (on a copy), NOS010 flags `_TokRef.np`'s event
    wait and host view, the engine's one materialization point, and
    nothing else of the engine."""
    path = os.path.join(PORT_TREE, "runtime", "decode_server.py")
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    lines = source.splitlines()
    sites = [n for n, line in enumerate(lines, 1) if "ignore[NOS010]" in line]
    assert len(sites) == 2
    assert "self._event.synchronize()" in lines[sites[0] - 1]
    assert "self._arr.numpy()" in lines[sites[1] - 1]
    runtime = tmp_path / "runtime"
    runtime.mkdir()
    (runtime / "decode_server.py").write_text(
        re.sub(r"  # nos-lint: ignore\[NOS010\]", "", source)
    )
    findings = _lint(str(runtime), [HostSyncChecker()], root=str(tmp_path))
    assert [(f.code, f.line) for f in findings] == [("NOS010", n) for n in sites]


# -- cli lint: the port's defaults --------------------------------------------------
def test_cli_lint_defaults_to_the_port_tree_and_baseline(monkeypatch, capsys):
    from nos_tpu_torch import cli

    monkeypatch.chdir(REPO)
    assert cli.LINT_BASELINE == os.path.basename(PORT_BASELINE)
    assert analysis.CACHE_BASENAME == ".nos-lint-cache-torch.json"
    assert cli.main(["lint", "--no-cache", "--format", "json"]) == 0
    import json

    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and payload["stale_baseline_entries"] == []
    assert payload["suppressed"] == len(analysis.load_baseline(PORT_BASELINE))
    files = int(payload["stats"].split()[0])
    assert files == len(analysis.Engine.discover([PORT_TREE]))
