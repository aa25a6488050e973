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


def port_sources():
    return sorted((REPO / "nos_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


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
