"""Guards of the port's boundary: ``ehgr_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, flax or the ``ehgr_tpu`` package, and
``chip_smoke.py`` refuses to run (nonzero exit, no result) without CUDA or
without the rest of the repository."""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import ehgr_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ehgr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ehgr_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        ehgr_tpu_torch.__path__, "ehgr_tpu_torch."))


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""      # no card, wherever this runs
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_every_module_is_found():
    mods = _modules()
    for want in ("ehgr_tpu_torch.ops.kernels.action_mega",
                 "ehgr_tpu_torch.eval.inference",
                 "ehgr_tpu_torch.models.convert"):
        assert want in mods


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py"])
def test_source_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a visible card, and alone in a directory (no port), the
    script exits nonzero and prints no result."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = _run([script], cwd)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
