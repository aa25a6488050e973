"""The port imports nothing of the JAX package and no `jax`, at any depth.

`test_torch_decode_server.py::test_package_imports_neither_jax_nor_nos_tpu`
imports every module in a fresh process and reads `sys.modules`, which
misses an import inside a function body until that function runs. This
pin reads the source instead: every `import`/`from` statement of
`nos_tpu_torch/**/*.py` and `chip_smoke.py`, in function bodies too, and
every `importlib.import_module`/`__import__` call with a literal name."""

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FOREIGN = ("nos_tpu", "jax")


def _foreign(name):
    return any(name == root or name.startswith(root + ".") for root in FOREIGN)


def foreign_imports(source, filename="<source>"):
    """(line, module) for every import of the JAX package or `jax` in
    `source`, at any depth."""
    found = []
    for node in ast.walk(ast.parse(source, filename)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if _foreign(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _foreign(node.module):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            arg = node.args[0]
            if (name in ("import_module", "__import__") and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _foreign(arg.value)):
                found.append((node.lineno, arg.value))
    return sorted(found)


# The port's entry points outside the package.
PORT_SCRIPTS = ["hack/e2e_check_torch.py", "examples/end_to_end_torch.py",
                "examples/sharing-comparison/run_local_torch.py",
                "examples/sharing-comparison/serve_torch.py",
                "examples/sharing-comparison/client_torch.py"]


def port_sources():
    return (sorted((REPO / "nos_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
            + [REPO / rel for rel in PORT_SCRIPTS])


def test_no_module_of_the_port_imports_jax_or_nos_tpu():
    sources = port_sources()
    assert len(sources) > 100
    offenders = {
        str(path.relative_to(REPO)): hits
        for path in sources
        if (hits := foreign_imports(path.read_text(), str(path)))
    }
    assert offenders == {}


def test_pin_sees_lazy_and_dynamic_imports():
    source = (
        "import os\n"
        "from nos_tpu_torch.cluster.client import Cluster\n"
        "def f():\n"
        "    from nos_tpu.controllers.health import is_node_device_healthy\n"
        "    class C:\n"
        "        def g(self):\n"
        "            import jax.numpy as jnp\n"
        "    return importlib.import_module('nos_tpu.tpu')\n"
        "x = __import__('jax')\n"
        "from . import sibling\n"
    )
    assert foreign_imports(source) == [
        (4, "nos_tpu.controllers.health"), (7, "jax.numpy"), (8, "nos_tpu.tpu"), (9, "jax"),
    ]


def test_pin_reads_the_scheduler_wiring_simulator_and_cli():
    """The modules of ROADMAP A item 6 step 5 are among the sources read,
    and each imports the port (so a rename cannot drop one silently)."""
    sources = {str(path.relative_to(REPO)): path for path in port_sources()}
    step5 = ["config.py", "system.py", "sim.py", "sim_oracle.py", "cli.py",
             "scheduler/framework.py", "scheduler/scheduler.py",
             "scheduler/plugins/__init__.py", "scheduler/plugins/capacity.py",
             "scheduler/plugins/noderesources.py", "scheduler/plugins/topology.py"]
    for rel in step5:
        path = sources[f"nos_tpu_torch/{rel}"]
        text = path.read_text()
        assert f"`nos_tpu/{rel}:1`" in text, rel
        assert foreign_imports(text, str(path)) == [], rel


def test_pin_reads_the_port_scripts_outside_the_package():
    """The port's copies of the reference's entry points outside the
    package (the kind gate, the end-to-end example, the sharing demo) are
    among the sources read, and each imports the port."""
    sources = {str(path.relative_to(REPO)) for path in port_sources()}
    for rel in PORT_SCRIPTS:
        assert rel in sources
        text = (REPO / rel).read_text()
        assert "from nos_tpu_torch" in text, rel
        assert foreign_imports(text, rel) == [], rel
