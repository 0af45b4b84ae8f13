"""What the benchmark may import: never JAX or the JAX package (top-level
names compared whole, so ``repro_torch`` is the program and ``repro`` is
not), and in the reference nothing of the program either."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = set(top_level_imports(path))
    assert "repro_torch" not in found
    assert not {m for m in found if m.startswith("port_bench")}


def test_names_compare_whole():
    names = set(top_level_imports(HERE / "drivers" / "snn_server.py"))
    assert "repro_torch" in names and not names & FORBIDDEN


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys
    import types

    from port_bench import harness

    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro.core")
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("repro_torch_x"))
    assert ("repro" in harness.forbidden_modules()) == ("repro" in sys.modules)


def test_a_reader_that_loads_the_jax_package_gives_no_result(monkeypatch):
    """Readers are loaded by path after the window: what they load is looked for too."""
    import sys
    import types

    from port_bench import harness
    from port_bench.tests.conftest import small_run

    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    real = harness.reader

    def reader(name):
        monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
        return real(name)

    monkeypatch.setattr(harness, "reader", reader)
    with pytest.raises(harness.Refused, match="repro"):
        small_run("snn-64k.stream", seconds=0.2)
