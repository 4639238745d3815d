"""Guards of the port's boundary: ``ehgr_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, flax or the ``ehgr_tpu`` package (nor, in their
source, ``transformers``: the HF converters take a state dict), a kernel
wrapper given a CUDA tensor launches its kernel or raises (never its plain
version), and ``chip_smoke.py`` refuses to run (nonzero exit, no result)
without CUDA or without the rest of the repository."""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ehgr_tpu_torch
from ehgr_tpu_torch.ops.kernels import (action_fused, action_mega, build,
                                        int8_conv, registry, shift,
                                        tsm_shift)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ehgr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ehgr_tpu")
# the source scan also refuses transformers (only tests may import it)
FORBIDDEN_SOURCE = FORBIDDEN + ("transformers",)


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
                 "ehgr_tpu_torch.ops.kernels.action_fused",
                 "ehgr_tpu_torch.ops.kernels.shift",
                 "ehgr_tpu_torch.ops.kernels.tsm_shift",
                 "ehgr_tpu_torch.ops.kernels.int8_conv",
                 "ehgr_tpu_torch.ops.quantize",
                 "ehgr_tpu_torch.train.checkpoints",
                 "ehgr_tpu_torch.ops.action_vjp",
                 "ehgr_tpu_torch.models.decoders",
                 "ehgr_tpu_torch.train.losses",
                 "ehgr_tpu_torch.train.optim",
                 "ehgr_tpu_torch.train.ema",
                 "ehgr_tpu_torch.train.steps",
                 "ehgr_tpu_torch.eval.inference",
                 "ehgr_tpu_torch.models.convert",
                 "ehgr_tpu_torch.models.factory",
                 "ehgr_tpu_torch.train.loop",
                 "ehgr_tpu_torch.utils.meters",
                 "ehgr_tpu_torch.utils.metrics_log",
                 "ehgr_tpu_torch.cli.train",
                 "ehgr_tpu_torch.cli.train_mtmm",
                 "ehgr_tpu_torch.cli.train_sd",
                 "ehgr_tpu_torch.ops.kernels.registry",
                 "ehgr_tpu_torch.serve.export",
                 "ehgr_tpu_torch.eval.cascade",
                 "ehgr_tpu_torch.eval.streaming",
                 "ehgr_tpu_torch.cli.export_serving",
                 "ehgr_tpu_torch.cli.test_cascade",
                 "ehgr_tpu_torch.cli.stream_demo",
                 "ehgr_tpu_torch.models.mobilenet_v2",
                 "ehgr_tpu_torch.models.bn_inception",
                 "ehgr_tpu_torch.models.res2net",
                 "ehgr_tpu_torch.models.modality",
                 "ehgr_tpu_torch.models.byot_resnet",
                 "ehgr_tpu_torch.utils.profiling",
                 "ehgr_tpu_torch.eval.gradcam",
                 "ehgr_tpu_torch.eval.case_study",
                 "ehgr_tpu_torch.data.pseudo_depth",
                 "ehgr_tpu_torch.cli.cam_visualize",
                 "ehgr_tpu_torch.cli.case_study",
                 "ehgr_tpu_torch.cli.train_sd_actionnet",
                 "ehgr_tpu_torch.cli.test_sd_actionnet",
                 "ehgr_tpu_torch.cli.prepare_data",
                 "ehgr_tpu_torch.cli.dress_rehearsal",
                 "ehgr_tpu_torch.cli.reproduce",
                 "ehgr_tpu_torch.models.video3d",
                 "ehgr_tpu_torch.models.videomae",
                 "ehgr_tpu_torch.models.dpt",
                 "ehgr_tpu_torch.cli.train_slowonly",
                 "ehgr_tpu_torch.cli.train_videomae"):
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
            assert name.split(".")[0] not in FORBIDDEN_SOURCE, (path, name)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a visible card, and alone in a directory (no port), the
    script exits nonzero and prints no result."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = _run([script], cwd)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports ``cuda:0``, so a wrapper takes its CUDA
    branch on a machine without a card: its checks see ``cuda:0``, and a
    call of one of the port's custom ops (``ehgr::*``, whose dispatcher
    keys on the CPU storage) goes to the op's CUDA implementation."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.OpOverload) and \
                func.namespace == "ehgr":
            return func.redispatch(
                torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA), *args,
                **(kwargs or {}))
        return super().__torch_function__(func, types, args, kwargs)


def _cuda(*shape):
    return torch.Tensor._make_subclass(_OnCuda, torch.randn(shape))


@pytest.mark.parametrize("kernel", ["learnable_shift_fwd",
                                    "learnable_shift_bwd",
                                    "learnable_shift_bwd_strip",
                                    "action_stats",
                                    "action_stats_window", "action_apply",
                                    "action_apply_strip", "action_prologue",
                                    "action_prologue_window", "tsm_shift",
                                    "int8_conv"])
def test_cuda_tensor_with_failed_build_raises(monkeypatch, kernel):
    """A CUDA operand and a kernel that does not build: the wrapper raises
    the build's error; it neither runs the plain version nor counts.
    ``action_apply_strip``: ``action_apply`` on bf16 operands of its main
    path's route (``csrc/action_apply.cu``); ``action_stats_window`` /
    ``action_prologue_window`` the same for ``csrc/action_stats.cu``, and
    ``learnable_shift_bwd_strip`` for ``csrc/shift_bwd.cu``."""
    n, t, s, c, f = 1, 2, 3, 16, 8

    def strip(*shape):
        return torch.Tensor._make_subclass(
            _OnCuda, torch.randn(*shape).to(torch.bfloat16))

    def codes(*shape):
        return torch.Tensor._make_subclass(
            _OnCuda, torch.randint(-127, 128, shape, dtype=torch.int8))
    args = {"learnable_shift_fwd": (_cuda(n, t, s, c), _cuda(3, c)),
            "learnable_shift_bwd": (_cuda(n, t, s, c), _cuda(n, t, s, c),
                                    _cuda(3, c)),
            "learnable_shift_bwd_strip": (strip(n, t, s, 64),
                                          strip(n, t, s, 64), strip(3, 64)),
            "action_stats": (_cuda(n, t, s, c), _cuda(3, c), _cuda(c, 1)),
            "action_apply": (_cuda(n, t, s, c), _cuda(3, c),
                             _cuda(n, t, s, 1), _cuda(n, t, c),
                             _cuda(c, f)),
            "action_apply_strip": (strip(n, t, s, 64), strip(3, 64),
                                   strip(n, t, s, 1), strip(n, t, 64),
                                   strip(64, f)),
            "action_prologue": (_cuda(n, t, s, c), _cuda(3, c),
                                _cuda(c, 1)),
            "action_stats_window": (strip(n, t, s, 64), strip(3, 64),
                                    strip(64, 4)),
            "action_prologue_window": (strip(n, t, s, 64), strip(3, 64),
                                       strip(64, 4)),
            "tsm_shift": (_cuda(n, t, s, c), 8),
            "int8_conv": (_cuda(2, c, 5, 5), _cuda().abs(),
                          codes(f, c, 3, 3), _cuda(f).abs(), 1, 1)}[kernel]
    mod = {"learnable_shift_fwd": shift, "learnable_shift_bwd": shift,
           "learnable_shift_bwd_strip": shift,
           "action_stats": action_mega, "action_apply": action_mega,
           "action_apply_strip": action_mega,
           "action_prologue": action_fused, "tsm_shift": tsm_shift,
           "action_stats_window": action_mega,
           "action_prologue_window": action_fused,
           "int8_conv": int8_conv}[kernel]
    kernel = kernel.replace("_strip", "").replace("_window", "")

    def failed_build(name, verbose=False):
        raise RuntimeError(f"nvcc failed on {name}")

    def plain(*a):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build", failed_build)
    monkeypatch.setattr(mod, kernel + "_plain", plain)
    wrapper = getattr(mod, kernel)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        wrapper(*args)
    assert wrapper.launches == before


# op -> (operands of a kernel launch, the wrapper counting it, its module)
_OP_ARGS = {
    "ehgr::action_stats": (lambda: (_cuda(1, 2, 3, 16), _cuda(3, 16),
                                    _cuda(16, 1)), action_mega),
    "ehgr::action_apply": (lambda: (_cuda(1, 2, 3, 16), _cuda(3, 16),
                                    _cuda(1, 2, 3, 1), _cuda(1, 2, 16),
                                    _cuda(16, 8)), action_mega),
    "ehgr::action_prologue": (lambda: (_cuda(1, 2, 3, 16), _cuda(3, 16),
                                       _cuda(16, 1)), action_fused),
    "ehgr::tsm_shift": (lambda: (_cuda(1, 2, 3, 16), 8, False), tsm_shift),
    "ehgr::int8_conv": (lambda: (
        _cuda(2, 16, 5, 5), _cuda().abs(), torch.Tensor._make_subclass(
            _OnCuda, torch.randint(-127, 128, (8, 16, 3, 3),
                                   dtype=torch.int8)),
        _cuda(8).abs(), 1, 1), int8_conv)}


def test_registry_names_every_op_with_a_cuda_kernel():
    """``registry.OPS`` (what a loaded artifact may call) is every custom
    op of the port, each with a CUDA kernel, a CPU kernel and a fake
    implementation registered."""
    assert sorted(registry.OPS) == sorted(_OP_ARGS)
    for name in registry.OPS:
        for key in ("CUDA", "CPU", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                name, key), (name, key)


@pytest.mark.parametrize("name", sorted(_OP_ARGS))
def test_op_on_cuda_tensor_with_failed_build_raises(monkeypatch, name):
    """Each custom op itself (as an exported graph calls it, without the
    wrapper) on CUDA operands and a kernel that does not build: the build's
    error; the plain version does not run and nothing is counted."""
    make, mod = _OP_ARGS[name]
    wrapper = registry.OPS[name]
    kernel = wrapper.__name__

    def failed_build(lib, verbose=False):
        raise RuntimeError(f"nvcc failed on {lib}")

    def plain(*a):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build", failed_build)
    monkeypatch.setattr(mod, kernel + "_plain", plain)
    op = getattr(torch.ops.ehgr, name.split("::")[1]).default
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        op(*make())
    assert wrapper.launches == before
