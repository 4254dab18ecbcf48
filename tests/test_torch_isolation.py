"""The port stands alone: ``src/repro_torch/`` and ``chip_smoke.py``
import neither jax nor anything of the JAX package ``repro``.

Two checks, because either alone can be fooled: an AST scan of every
source for import statements and ``import_module``/``__import__`` calls
naming a forbidden module (a grep would miss an aliased or dynamic
import), and a fresh interpreter that imports every module of the port
and ``chip_smoke`` and then finds no forbidden module in ``sys.modules``
(which catches an import hidden behind a guard or in a dependency).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


# modules the scans must reach, the train slice's among them
REQUIRED = (
    "kernels/flash_attention.py", "kernels/odc_gather.py",
    "kernels/odc_scatter.py", "kernels/_ring.py", "kernels/_build.py",
    "core/odc.py", "core/ranks.py", "core/fsdp.py", "core/backend.py",
    "core/train_step.py", "optim/adamw.py", "optim/schedules.py",
    "data/lengths.py", "data/packing.py", "data/loader.py",
    "balance/cost.py", "balance/kk.py", "balance/strategies.py",
    "launch/train.py", "launch/serve.py", "bridge.py",
)


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_scans_cover_every_module_of_the_port():
    scanned = {str(p.relative_to(PORT)) for p in _sources()
               if PORT in p.parents}
    assert set(REQUIRED) <= scanned, sorted(set(REQUIRED) - scanned)
    assert (REPO / "chip_smoke.py") in _sources()


def _imports(tree):
    """(line, module name) of every import in the tree, dynamic ones with
    a literal (or f-string literal) prefix included."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name not in ("import_module", "__import__"):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield node.lineno, arg.value.rstrip(".")


def test_scan_sees_every_kind_of_import():
    src = ("import jax.numpy as jnp\nfrom repro.models import layers\n"
           "import importlib\nimportlib.import_module(f'repro.configs.{x}')\n"
           "__import__('jaxlib')\nfrom repro_torch import bridge\n")
    found = [name for _, name in _imports(ast.parse(src))]
    assert [n for n in found if _forbidden(n)] == \
        ["jax.numpy", "repro.models", "repro.configs", "jaxlib"]
    assert not _forbidden("repro_torch.bridge")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imports(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, chip_smoke\n"
        "from repro_torch import configs\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for a in configs.ARCH_IDS:\n"
        "    configs.get_config(a)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'repro') or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "missing = [m for m in %r if m not in names]\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 20 else 0)\n"
        % (["repro_torch." + r[:-3].replace("/", ".") for r in REQUIRED],))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
