"""Nothing under ``portbench/`` imports JAX or the JAX package, whose name
the measured program's begins with (top-level names compared whole), the
reference imports nothing of the program, and no file reads the JAX
package's benchmark (`bench.py`, `tools/`) or `chip_smoke.py`."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ehgr_tpu"}
SOURCES = sorted(PKG.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert "ehgr_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"torch", "typing", "__future__",
                                       "portbench"}


def test_whole_names_compared(tmp_path):
    """``ehgr_tpu_torch`` begins with ``ehgr_tpu`` and is allowed; the JAX
    package is not."""
    probe = tmp_path / "probe.py"
    probe.write_text("import ehgr_tpu_torch.models\n"
                     "from ehgr_tpu.ops import x\n")
    assert top_level_imports(probe) & FORBIDDEN == {"ehgr_tpu"}


@pytest.mark.parametrize("word", ["chip_smoke", "bench.py", "tools/"])
def test_no_earlier_benchmark_read(word):
    for path in PKG.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json") and \
                path != Path(__file__).resolve():
            assert word not in path.read_text(), path
