"""Run a reference test file's own cases on the port.

`load("test_scheduler")` reads `tests/test_scheduler.py`, points every
`nos_tpu` name in it at `nos_tpu_torch` (imports, lazy imports in function
bodies, `__import__` strings, `python -m nos_tpu.cli` argument lists) and
every import of a sibling test module (`from test_multihost import ...`,
`from tests.test_operations import ...`) at that module's port-side copy,
and executes the result as a module of its own. Nothing else of the source
changes: the cases keep the reference's bodies, helpers, fixtures, marks
and assertions line for line (tracebacks point into the reference file).
The reference side of each case is the reference file itself, which the
same test run collects as it always has.

`mirror(globals(), "test_scheduler")` puts every case and fixture of that
port-side module into a `tests/test_torch_*.py` file for pytest to collect,
leaving out the cases marked `slow` (the reference's full-size runs, which
the tier-1 command deselects); `only=[...]` takes the named cases (and
every fixture) of a file the port holds in part. `reset_state()` is an autouse fixture that puts both
packages' module-level state back to its import-time value before each
case, so a case sees the same state whichever files ran before it in the
worker."""

import ast
import importlib
import re
import sys
import types
from pathlib import Path

import pytest
from _pytest.assertion.rewrite import rewrite_asserts
from _pytest.fixtures import FixtureFunctionDefinition

TESTS = Path(__file__).resolve().parent
PORT = "nos_tpu_torch"
PACKAGES = ("nos_tpu", PORT)

_PACKAGE_NAME = re.compile(r"\bnos_tpu\b")
_SIBLING = re.compile(r"^(\s*from\s+)(?:tests\.)?(test_\w+)(\s+import\b)", re.M)


def port_name(ref):
    return f"{ref}__on_{PORT}"


def port_source(ref):
    """The source of `tests/<ref>.py` with the JAX package's names and the
    sibling test modules pointed at the port."""
    source = (TESTS / f"{ref}.py").read_text()
    if re.search(r"^\s*import\s+(?:tests\.)?test_\w+", source, re.M):
        raise ValueError(f"{ref}: only `from test_x import ...` is mirrored")
    source = _PACKAGE_NAME.sub(PORT, source)
    return _SIBLING.sub(lambda m: f"{m.group(1)}{port_name(m.group(2))}{m.group(3)}", source)


def _compile(source, path):
    """`source` compiled with pytest's assertion rewriting, as pytest itself
    compiles a test module (a failed assert shows its operands)."""
    tree = ast.parse(source, str(path))
    rewrite_asserts(tree, source.encode(), str(path), None)
    return compile(tree, str(path), "exec")


def load(ref):
    """The port-side module of `tests/<ref>.py` (built once a process)."""
    name = port_name(ref)
    if name in sys.modules:
        return sys.modules[name]
    source = port_source(ref)
    for sibling in sorted(set(re.findall(r"\b(test_\w+)__on_" + PORT, source))):
        load(sibling)
    path = TESTS / f"{ref}.py"
    module = types.ModuleType(name)
    module.__file__ = str(path)
    sys.modules[name] = module
    try:
        exec(_compile(source, path), module.__dict__)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def mirror(namespace, ref, only=None):
    """Put the cases (all, or those named in `only`) and every fixture of
    `tests/<ref>.py`'s port-side module into `namespace`. A module-level
    `pytestmark` of the reference goes onto each case taken."""
    module = load(ref)
    marks = getattr(module, "pytestmark", [])
    marks = marks if isinstance(marks, list) else [marks]
    taken = []
    for name, value in vars(module).items():
        if name.startswith("__") or name == "pytestmark":
            continue
        case = name.startswith(("test", "Test"))
        fixture = isinstance(value, FixtureFunctionDefinition)
        if not (fixture or (case if only is None else name in only)):
            continue
        if name in namespace and namespace[name] is not value:
            raise ValueError(f"{ref}.{name} is already defined here")
        if case:
            if any(m.name == "slow" for m in marks + getattr(value, "pytestmark", [])):
                continue
            for mark in marks:
                value = mark(value)
            taken.append(name)
        namespace[name] = value
    if only is not None and sorted(set(only) - set(taken)):
        raise ValueError(f"{ref} has no {sorted(set(only) - set(taken))}")
    return module


def _reset(pkg):
    importlib.import_module(f"{pkg}.gpu.mig").clear_known_geometry_overrides()
    importlib.import_module(f"{pkg}.observability").metrics.__init__()
    importlib.import_module(f"{pkg}.tpu.packing")._PACK_CACHE.clear()


def reset_state():
    """An autouse fixture: both packages' module-level state (the MIG
    geometry overrides, the `observability.metrics` registry, the packer's
    cache) back to its import-time value before each case. A module takes
    it with `_reset_state = reset_state()`."""

    @pytest.fixture(autouse=True)
    def _reset_state():
        for pkg in PACKAGES:
            _reset(pkg)
        yield

    return _reset_state
