"""Source-level lint of the PyTorch port (paddle_tpu_torch/ and
chip_smoke.py), one case per file: no import of jax or of the JAX
package (the port keeps its own copies of what it needs), and the
patterns tests/test_code_hygiene.py bans in paddle_tpu/ — bare
``except:``, mutable default arguments, ``threading.Thread`` without an
explicit ``daemon=``.
"""
import ast
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "paddle_tpu_torch")


def _files():
    out = [os.path.join(_ROOT, "chip_smoke.py")]
    for root, dirs, files in os.walk(_PKG):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return [os.path.relpath(p, _ROOT) for p in out]


def _tree(rel):
    with open(os.path.join(_ROOT, rel), encoding="utf-8") as f:
        return ast.parse(f.read(), filename=rel)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("rel", _files())
def test_port_file_hygiene(rel):
    tree = _tree(rel)
    bad = []
    for mod in _imported_modules(tree):
        root = mod.split(".")[0]
        if root in ("jax", "jaxlib", "paddle_tpu"):
            bad.append(f"imports {mod}")
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            bad.append(f"bare except at line {node.lineno}")
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            defaults = list(node.args.defaults) + \
                [d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    bad.append(f"mutable default at line {d.lineno}")
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if name == "Thread" and not any(k.arg == "daemon"
                                            for k in node.keywords):
                bad.append(f"Thread without daemon= at line {node.lineno}")
    assert not bad, f"{rel}: {bad}"
