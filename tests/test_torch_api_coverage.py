"""Every public top-level name of the JAX package has a counterpart of the
same name in the same module of the port, or a row in
``recommender_tpu_torch/PARITY.md``'s table "Public names without a
same-named counterpart" that gives its counterpart or why it is not
ported. The check is an AST diff of the two packages' top-level
definitions and assignments (no module is imported), module by module."""
import ast
import os
import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT, PORT_ROOT = REPO / "recommender_tpu", REPO / "recommender_tpu_torch"
TABLE = "## Public names without a same-named counterpart"


def _public_names(path: Path) -> set[str]:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def _missing() -> set[tuple[str, str]]:
    """(module path, name) of every JAX name the port's module lacks."""
    out = set()
    for path in JAX_ROOT.rglob("*.py"):
        rel = path.relative_to(JAX_ROOT).as_posix()
        port = PORT_ROOT / rel
        ours = _public_names(port) if port.exists() else set()
        out.update((rel, n) for n in _public_names(path) - ours)
    return out


def _table() -> set[tuple[str, str]]:
    """(module path, name) of every name in the PARITY table's first column."""
    text = (PORT_ROOT / "PARITY.md").read_text()
    body = text[text.index(TABLE):].split("\n## ", 1)[0]
    out = set()
    for line in body.splitlines():
        if not line.startswith("| `"):
            continue
        cells = re.findall(r"`([^`]+)`", line.split("|")[1])
        module, first = cells[0].split("::")
        out.update((module, n) for n in [first, *cells[1:]])
    return out


def test_every_jax_name_is_ported_or_in_the_parity_table():
    missing, table = _missing(), _table()
    assert len(missing) > 20  # the diff sees the TPU gates and sharding helpers
    assert sorted(missing - table) == []
    # and the table names nothing that has since been ported
    assert sorted(table - missing) == []


def test_every_jax_module_has_a_counterpart():
    modules = {p.relative_to(JAX_ROOT).as_posix() for p in JAX_ROOT.rglob("*.py")}
    lacking = sorted(m for m in modules if not (PORT_ROOT / m).exists())
    assert lacking == []
    assert os.path.exists(PORT_ROOT / "cli" / "prepare_criteo.py")
    assert os.path.exists(PORT_ROOT / "core" / "profiling.py")
