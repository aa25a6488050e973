"""The port's analyzer (`nos_tpu_torch/analysis/`) against the reference's
(`nos_tpu/analysis/`), exactly.

- The 13 checkers the port copies (every one whose rules name no JAX API)
  give the same findings — path, line, code and message, with the package
  name normalized — over the JAX package's tree, over the port's tree and
  over the reference's fixtures (`tests/analysis_fixtures/`).
- Importing the port's analyzer and CLI loads neither `jax` nor anything
  of `nos_tpu`, nor `torch`: `cli lint` is host Python over `ast`, as the
  reference's is (a fresh process reads `sys.modules`).
- The port's tree gate holds the restored suppressions closed: on a copy
  of the port's tree with each inline suppression at a reference site
  dropped, the gate reports that site's finding at its line and nothing
  else."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import test_torch_fleet_parity as fp
import torch_mirror

from nos_tpu import analysis as ref_analysis
from nos_tpu_torch import analysis as port_analysis

_time_limit = fp.time_limit(90)
_reset_state = torch_mirror.reset_state()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = os.path.join(REPO, "nos_tpu_torch")
PORT_BASELINE = os.path.join(REPO, "lint-baseline-torch.txt")

#: The checkers copied near verbatim, by module.
SHARED = (
    "wire_literals",
    "protocol_roundtrip",
    "exception_hygiene",
    "lock_discipline",
    "block_discipline",
    "fault_discipline",
    "spill_discipline",
    "trace_discipline",
    "radix_discipline",
    "cost_discipline",
    "store_discipline",
    "replay_purity",
    "telemetry_schema",
)
REWRITTEN = (
    "trace_safety",
    "host_sync",
    "staging_discipline",
    "device_placement",
    "donation_discipline",
    "quant_discipline",
)


def _shared(analysis):
    return [c for c in analysis.all_checkers() if type(c).__module__.rsplit(".", 1)[1] in SHARED]


def _codes(checkers):
    return sorted({code for c in checkers for code in c.codes})


def _normalized(findings):
    return sorted(
        (f.path.replace("nos_tpu_torch/", "nos_tpu/"), f.line, f.code,
         f.message.replace("nos_tpu_torch", "nos_tpu"))
        for f in findings
    )


def test_the_registries_split_into_shared_and_rewritten():
    modules = sorted(type(c).__module__.rsplit(".", 1)[1]
                     for c in port_analysis.all_checkers())
    assert modules == sorted(SHARED + REWRITTEN)
    assert port_analysis.all_codes() == ref_analysis.all_codes()
    assert _codes(_shared(port_analysis)) == _codes(_shared(ref_analysis))
    assert len(_shared(port_analysis)) == len(SHARED)


def _paths(tree):
    """The tree's paths; of the fixtures, the reference's (the port's own
    under `torch/` exercise the port's torch rules)."""
    path = os.path.join(REPO, tree)
    if tree != FIXTURES:
        return [path]
    return [os.path.join(path, name) for name in sorted(os.listdir(path)) if name != "torch"]


FIXTURES = "tests/analysis_fixtures"


@pytest.mark.parametrize("tree", ["nos_tpu", "nos_tpu_torch", FIXTURES])
def test_shared_checkers_match_the_reference_exactly(tree):
    paths = _paths(tree)
    select = _codes(_shared(ref_analysis))
    want = ref_analysis.Engine(_shared(ref_analysis), root=REPO).run(paths, select=select)
    got = port_analysis.Engine(_shared(port_analysis), root=REPO).run(paths, select=select)
    assert _normalized(got) == _normalized(want)
    if tree == FIXTURES:
        assert len(want) > 50  # the fixtures' positives, every shared code
        assert {f.code for f in want} >= {"NOS001", "NOS002", "NOS003", "NOS005",
                                           "NOS011", "NOS012", "NOS014", "NOS018",
                                           "NOS021", "NOS022"}


def test_port_analyzer_and_cli_import_neither_jax_nor_nos_tpu_nor_torch():
    probe = (
        "import sys\n"
        "import nos_tpu_torch.analysis as a, nos_tpu_torch.cli\n"
        "a.all_checkers()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'nos_tpu',"
        " 'torch'))\n"
        "print(bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=60, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


#: The suppressions restored at the reference's sites, by port file and code.
RESTORED = {
    "runtime/decode_server.py": ("NOS010", "NOS010", "NOS012"),
    "serving/replica.py": ("NOS012",),
    "serving/supervisor.py": ("NOS012",),
    "observability.py": ("NOS018", "NOS018"),
}


def test_gate_fails_on_a_copy_without_the_suppressions(tmp_path):
    tree = tmp_path / "nos_tpu_torch"
    shutil.copytree(PORT_TREE, tree, ignore=shutil.ignore_patterns("__pycache__", "_build"))
    os.makedirs(tmp_path / "docs")
    shutil.copy(os.path.join(REPO, "docs", "telemetry.md"), tmp_path / "docs")
    want = []
    for rel, codes in RESTORED.items():
        path = tree / rel
        source = path.read_text()
        found = re.findall(r"# nos-lint: ignore\[(NOS\d{3})\]", source)
        assert tuple(sorted(found)) == codes, rel
        for n, line in enumerate(source.splitlines(), start=1):
            m = re.search(r"# nos-lint: ignore\[(NOS\d{3})\]", line)
            if m:
                want.append((f"nos_tpu_torch/{rel}", n, m.group(1)))
        path.write_text(re.sub(r"# nos-lint: ignore\[NOS\d{3}\]", "#", source))

    found, _, _ = port_analysis.run([str(tree)], baseline_path=PORT_BASELINE,
                                    root=str(tmp_path))
    assert sorted((f.path, f.line, f.code) for f in found) == sorted(want)
