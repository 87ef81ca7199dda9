"""Nothing the benchmark runs is JAX or the JAX package: the modules
``portbench.run`` loads, and the imports of every module under portbench/
but the tests, compared by whole top-level names (``recommender_tpu_torch``
is the port, ``recommender_tpu`` the JAX package). The reference imports
nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "recommender_tpu"}
READ_NOTHING = ("bench.py", "benchmarks")  # the JAX package's benchmark


def _sources(root):
    return [p for p in Path(root).rglob("*.py")
            if "tests" not in p.relative_to(manifest.PKG).parts and "__pycache__" not in p.parts]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", _sources(manifest.PKG), ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN
    text = path.read_text()
    assert not any(f'"{name}' in text or f"'{name}" in text for name in READ_NOTHING)


@pytest.mark.parametrize("path", sorted((manifest.PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    imported = _imports(path)
    assert "recommender_tpu_torch" not in imported
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference"), node.module


def test_what_run_loads():
    code = ("import sys, portbench.run as r, portbench.harness, portbench.calibrate, "
            "portbench.faults\n"
            "from portbench import manifest\n"
            "from portbench.tests.tiny import tiny_cell\n"
            "for w in manifest.load()['workloads']:\n"
            "    c = tiny_cell(w['name']); c.family; c.reference; c.generator\n"
            "    [manifest.metric_reader(m['name']) for m in c.per_layer]\n"
            "    c.family.build(c.config['model'], 'cpu')\n"
            "import recommender_tpu_torch.core.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            "print(r.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin"}).stdout
    loaded, forbidden = out.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert not set(eval(loaded)) & FORBIDDEN  # noqa: S307 (our own printed list)
    assert "recommender_tpu_torch" in loaded


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "recommender_tpu_torch_x", sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "recommender_tpu.models", sys)
    assert run.loaded_forbidden() == ["recommender_tpu.models"]
