"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and ``chip_smoke.py`` refuses to run without a CUDA card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deeplearning4j_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "deeplearning4j_tpu"}


def _port_sources():
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "scripts").glob("torch_*.py")))


def test_no_jax_import_in_the_sources():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {r}"
                          for r in roots if r in FORBIDDEN]
    assert not offenders, offenders


def test_every_port_module_imports_with_jax_blocked():
    """A fresh interpreter with ``jax`` and the JAX package made unimportable
    imports every port module; neither appears in ``sys.modules``."""
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'deeplearning4j_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n, m in sys.modules.items() if m is not None and\n"
        "             n.split('.')[0] in ('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
        "assert not bad, bad\n"
        f"print('imported {len(mods)}')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"imported {len(mods)}" in r.stdout


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA (this test's environment, or forced below) the script
    exits nonzero and prints no result line."""
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    for cwd, path in ((REPO, str(REPO)), (tmp_path, "")):
        env = dict(os.environ, PYTHONPATH=path)
        r = subprocess.run([sys.executable, "-c", code], cwd=str(cwd), env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_the_data_parallel_modules_are_checked():
    """The checks above walk the package, so the modules of the
    data-parallel slice (and the kernel wrapper they launch) are among
    them."""
    rel = {str(p.relative_to(REPO)) for p in _port_sources()}
    for name in ("parallel/__init__.py", "parallel/mesh.py", "parallel/wrapper.py",
                 "parallel/zero.py", "nn/ops/fused_update.py", "parallel/inference.py",
                 "train/faults.py"):
        assert f"deeplearning4j_tpu_torch/{name}" in rel, name
