"""The port stands alone: no file of ``src/repro_torch/``, nor
``chip_smoke.py``, imports JAX, the reference package ``repro`` or the
reference's bench ``benchmarks``, by an import statement, ``__import__`` or
``importlib.import_module`` of a string or f-string that begins with
``repro.``, ``jax`` or ``benchmarks``.  The machine with the card has no JAX."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")
# the leading text of a module name given as a string that marks it forbidden
FORBIDDEN_PREFIXES = ("repro.", "jax", "benchmarks")


def _leading_text(arg: ast.expr) -> str | None:
    """The literal text a string or f-string argument begins with."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr) and arg.values and isinstance(arg.values[0], ast.Constant):
        return str(arg.values[0].value)
    return None


def _imports_by_name(node: ast.Call) -> bool:
    """``__import__(...)``, ``importlib.import_module(...)`` or ``import_module(...)``."""
    f = node.func
    return (getattr(f, "id", None) in ("__import__", "import_module")
            or getattr(f, "attr", None) == "import_module")


def imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and _imports_by_name(node) and node.args:
            text = _leading_text(node.args[0])
            if text is None:
                continue
            if isinstance(node.args[0], ast.Constant):
                roots.add(text.split(".")[0])
            roots.update(p.rstrip(".") for p in FORBIDDEN_PREFIXES if text.startswith(p))
    return roots


def test_files_exist():
    assert len(FILES) > 10
    assert all(p.exists() for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize("call", [
    'importlib.import_module(f"repro.configs.{name}")',
    'importlib.import_module("repro.models.api")',
    'import_module(f"jax{suffix}")',
    '__import__("benchmarks.tables")',
])
def test_imports_by_name_are_caught(tmp_path, call):
    """A module imported by name from a string is flagged like an import
    statement; the port's own ``repro_torch.`` modules are not."""
    src = tmp_path / "scratch.py"
    src.write_text(f"import importlib\nfrom importlib import import_module\n"
                   f"name, suffix = 'qwen15_4b', ''\n{call}\n"
                   f"importlib.import_module(f'repro_torch.configs.{{name}}')\n")
    bad = imported_roots(src) & set(FORBIDDEN)
    assert bad, f"{call} was not caught"
    ok = tmp_path / "ok.py"
    ok.write_text("import importlib\nimportlib.import_module(f'repro_torch.configs.{x}')\n")
    assert not imported_roots(ok) & set(FORBIDDEN)
