"""Nothing under ``port_bench/`` imports JAX or the JAX package, and the
reference imports nothing of the program.

Top-level module names are compared whole: ``musicgan_tpu_torch`` (the
port) begins with ``musicgan_tpu`` (the JAX package) and is not it."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "musicgan_tpu"}


def imported(path: Path) -> set[str]:
    """Absolute module names a file imports, its relative imports resolved
    against its package under ``port_bench``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    try:
        package = path.relative_to(BENCH.parent).with_suffix("").parts[:-1]
    except ValueError:
        package = ()
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) - node.level + 1] if node.level else ()
            if node.module:
                names.add(".".join(base + tuple(node.module.split("."))))
            else:
                names.update(".".join(base + (a.name,)) for a in node.names)
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & FORBIDDEN, f"{path} imports {sorted(tops & FORBIDDEN)}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in imported(path):
        top = name.split(".")[0]
        assert top != "musicgan_tpu_torch", f"{path} imports {name}"
        if top == "port_bench":
            assert name.startswith("port_bench.reference"), f"{path} reaches outside the reference: {name}"


def test_the_check_tells_the_port_from_the_jax_package(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import musicgan_tpu_torch.generate\nfrom musicgan_tpu_torch import serve\n")
    assert not {n.split(".")[0] for n in imported(probe)} & FORBIDDEN
    probe.write_text("from musicgan_tpu.ops import conv\n")
    assert {n.split(".")[0] for n in imported(probe)} & FORBIDDEN == {"musicgan_tpu"}


def test_the_run_refuses_a_process_holding_jax(monkeypatch):
    import sys
    import types

    from port_bench.run import forbidden_modules

    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "musicgan_tpu_torch_probe", types.ModuleType("musicgan_tpu_torch_probe"))
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.probe", types.ModuleType("jaxlib.probe"))
    assert "jaxlib" in forbidden_modules()
