"""The port stands without JAX and without the JAX package.

``keto_tpu_torch`` (and ``chip_smoke.py``) import ``torch`` and ``numpy``,
never ``jax``, and nothing of ``keto_tpu`` — not even its JAX-free
modules: the port keeps its own copies.
"""

from __future__ import annotations

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import keto_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "keto_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


#: modules the walk must find (the write path's, the reverse queries', the
#: explain path's, the full build's, expand's and the check scheduler's among
#: them): a module that fails to be found is not checked
REQUIRED = (
    "keto_tpu_torch.graph.overlay",
    "keto_tpu_torch.graph.compaction",
    "keto_tpu_torch.x.supervise",
    "keto_tpu_torch.check.gpu_engine",
    "keto_tpu_torch.graph.label_build",
    "keto_tpu_torch.graph.device_build",
    "keto_tpu_torch.graph.sort_kernels",
    "keto_tpu_torch.list",
    "keto_tpu_torch.list.engine",
    "keto_tpu_torch.list.kernels",
    "keto_tpu_torch.list.gpu_engine",
    "keto_tpu_torch.check.stream",
    "keto_tpu_torch.x.telemetry",
    "keto_tpu_torch.explain",
    "keto_tpu_torch.explain.engine",
    "keto_tpu_torch.explain.witness",
    "keto_tpu_torch.explain.decision_log",
    "keto_tpu_torch.graph.native",
    "keto_tpu_torch.check.native_pack",
    "keto_tpu_torch.graph.stream_build",
    "keto_tpu_torch.expand",
    "keto_tpu_torch.expand.engine",
    "keto_tpu_torch.expand.tree",
    "keto_tpu_torch.expand.snapshot_engine",
    "keto_tpu_torch.version",
    "keto_tpu_torch.x.timeline",
    "keto_tpu_torch.driver.admission",
    "keto_tpu_torch.driver.batch",
    "keto_tpu_torch.driver.daemon",
    "keto_tpu_torch.servers.rest",
)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(keto_tpu_torch.__path__, "keto_tpu_torch.")
    )


def test_walk_finds_every_module():
    found = set(_modules())
    assert set(REQUIRED) <= found, sorted(set(REQUIRED) - found)
    assert len(found) >= 51


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'keto_tpu' or m.startswith('keto_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m] is not None]\n"
        "print(len(" + repr(_modules()) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 51


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "keto_tpu"), f"{path.name} imports {mod}"
    assert "keto_tpu." not in path.read_text(encoding="utf-8").replace("keto_tpu_torch.", "")
