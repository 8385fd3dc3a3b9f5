"""The port's ground rules, read from its source.

Every file of ``src/repro_torch`` and ``chip_smoke.py`` imports nothing of
JAX and nothing of the JAX package ``repro``; no module imports ``triton``
at its top level (the CPU machines that import every module have none);
and no file of the port calls PyTorch's fused attention or
``torch.compile`` in place of a kernel of its own.
"""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(tree):
    """(module name, node) of every import in the tree, relative imports
    resolved to the port's package."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node
        elif isinstance(node, ast.ImportFrom):
            yield ("repro_torch" if node.level else node.module or ""), node


def _top(name):
    return name.split(".")[0]


def _ids(files):
    return [str(f.relative_to(REPO)) for f in files]


def test_the_port_has_its_files():
    names = {str(f.relative_to(REPO)) for f in FILES}
    for want in ("src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/kernels/gather_rows.py",
                 "src/repro_torch/kernels/ssd.py",
                 "src/repro_torch/models/model.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/mamba.py",
                 "src/repro_torch/serve/engine.py",
                 "src/repro_torch/launch/serve.py",
                 "chip_smoke.py"):
        assert want in names
    for cu in ("flash_attention.cu", "gather_rows.cu", "ssd.cu"):
        assert (PORT / "kernels" / "csrc" / cu).is_file()


@pytest.mark.parametrize("path", FILES, ids=_ids(FILES))
def test_no_jax_and_no_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name, _ in _imports(tree)
           if _top(name) in ("jax", "jaxlib", "repro") or name.startswith("jax")]
    assert not bad, f"{path.name} imports {bad}"


def _run_at_import(tree):
    """The imports that run when the module is imported: all but those in
    a function's body."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield from (name for name, _ in _imports(node))
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", FILES, ids=_ids(FILES))
def test_no_module_level_triton_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not any(_top(n) == "triton" for n in _run_at_import(tree)), path.name


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=_ids(sorted(PORT.rglob("*.py"))))
def test_no_library_attention_or_compile(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("scaled_dot_product_attention", "compile") or (
                isinstance(node.value, ast.Name) and node.value.id == "re"
            ), f"{path.name}:{node.lineno} uses {node.attr}"
        if isinstance(node, ast.Name):
            assert node.id != "scaled_dot_product_attention", f"{path.name}:{node.lineno}"
        if isinstance(node, ast.ImportFrom):
            assert all(a.name not in ("scaled_dot_product_attention", "compile")
                       for a in node.names), f"{path.name}:{node.lineno}"


def test_the_checks_catch_what_they_forbid(tmp_path):
    """Each rule fails on a file that breaks it."""
    cases = {
        "import jax.numpy as jnp\n": test_no_jax_and_no_reference_package,
        "from repro.kernels import ops\n": test_no_jax_and_no_reference_package,
        "try:\n    import triton\nexcept ImportError:\n    pass\n":
            test_no_module_level_triton_import,
        "import torch\nf = torch.nn.functional.scaled_dot_product_attention\n":
            test_no_library_attention_or_compile,
        "import torch\ng = torch.compile(len)\n": test_no_library_attention_or_compile,
    }
    for i, (src, check) in enumerate(cases.items()):
        bad = tmp_path / f"bad{i}.py"
        bad.write_text(src)
        with pytest.raises(AssertionError):
            check(bad)
    ok = tmp_path / "ok.py"
    ok.write_text("import repro_torch\n\ndef launch():\n    import triton\n    return triton\n")
    for check in set(cases.values()):
        check(ok)
