"""The benchmark's yardsticks: the reference's FLOP count against a hand
count of ResNet-50's convolutions (and ACTION's), and each kernel's least
time at the shapes of the port's kernel table (PERF.md, section 6: a
served forward of 20 clips, a train step of 8)."""

import json
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from portbench import reading
from portbench.work import flops, kernels

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CSRC = Path(__file__).resolve().parents[2] / "ehgr_tpu_torch" / "ops" / \
    "kernels" / "csrc"


def model(temporal):
    return json.loads((CONFIGS / f"{temporal}_r50_ego.json").read_text())[
        "model"]


def resnet50_frame(crop=224, classes=83):
    """2 x multiply-adds of one frame through ResNet-50's convolutions and
    the head, by hand."""
    total = 2 * 64 * 3 * 49 * (crop // 2) ** 2             # stem 7x7 / 2
    side, cin = crop // 4, 64
    for stage, (blocks, planes) in enumerate(
            zip((3, 4, 6, 3), (64, 128, 256, 512)), 1):
        for j in range(blocks):
            out = side // 2 if stage > 1 and j == 0 else side
            total += 2 * planes * cin * side * side          # conv1 1x1
            total += 2 * planes * planes * 9 * out * out     # conv2 3x3
            total += 2 * planes * 4 * planes * out * out     # conv3 1x1
            if j == 0:
                total += 2 * planes * 4 * cin * out * out    # downsample
            side, cin = out, planes * 4
    return total + 2 * 2048 * classes


def action_frame(crop=224):
    """ACTION's own layers at the 16 sites, one frame: the temporal shift,
    STE's 3x3x3 conv, CE's squeeze, temporal conv and expand on the pooled
    feature, ME's squeeze, depthwise 3x3 and expand."""
    total = 0
    for s, c, _ in kernels.resnet_sites(crop):
        cr = c // 16
        total += 2 * 3 * c * s + 2 * 27 * s
        total += 2 * c * cr + 2 * cr * cr * 3 + 2 * cr * c
        total += 2 * c * cr * s + 2 * 9 * cr * s + 2 * cr * c
    return total


def test_tsm_frame_is_resnet50():
    assert flops.call_flops(model("tsm"), 1, 224) == 8 * resnet50_frame()


def test_action_frame_adds_its_layers():
    assert flops.call_flops(model("action"), 1, 224) == \
        8 * (resnet50_frame() + action_frame())


def test_resnet50_hand_count_is_published_size():
    # ResNet-50 at 224^2 is 4.1 GMACs with its 1000-way head
    assert 8.1e9 < resnet50_frame(classes=1000) < 8.3e9


def test_grouped_conv_backward_counts_groups():
    x = torch.empty(4, 64, 8, 8, device="meta", requires_grad=True)
    w = torch.empty(64, 1, 3, 3, device="meta", requires_grad=True)
    with flops.counter() as fc:
        F.conv2d(x, w, padding=1, groups=64).sum().backward()
    assert fc.get_total_flops() == 3 * 2 * 4 * 64 * 9 * 64


def test_step_is_forward_and_two_backwards():
    m = model("tsm")
    fwd = flops.call_flops(m, 2, 64)
    step = flops.step_flops(m, 2, 64, with_depth=False, depth_weight=0.0)
    stem = 2 * 64 * 3 * 49 * 32 ** 2 * 16                    # no dx
    assert step == 3 * fwd - stem


@pytest.mark.parametrize("launch,clips,train,bound_ms", [
    ("action_stats", 20, False, 0.574), ("action_apply", 20, False, 0.736),
    ("learnable_shift_fwd", 8, True, 0.429),
    ("learnable_shift_bwd", 8, True, 0.644)])
def test_action_bounds_match_kernel_table(launch, clips, train, bound_ms):
    count, seconds = kernels.bounds_per_call(model("action"), clips,
                                             train)[launch]
    assert count == 16
    assert round(seconds * 1e3, 3) == bound_ms


def test_tsm_bound_matches_kernel_table():
    count, seconds = kernels.bounds_per_call(model("tsm"), 8, True)[
        "tsm_shift"]
    assert count == 32 and round(seconds * 1e3, 3) == 0.845


@pytest.mark.parametrize("name,launch", [
    ("void (anonymous namespace)::stats_window_kernel<4, 64, false>(x)",
     "action_stats"),
    ("void (anonymous namespace)::pool_reduce<__nv_bfloat16>(float const*, "
     "__nv_bfloat16*, int, int, int)", "action_stats"),
    ("apply_strip_kernel<256, 128>", "action_apply"),
    ("tsm_sweep<unsigned short, 8>", "tsm_shift"),
    ("dw_finish", "learnable_shift_bwd"),
    ("void cutlass::Kernel<cutlass_80_tensorop_bf16_s16816gemm>(Params)",
     None),
    ("void at::native::elementwise_kernel<128, 4, (lambda)>(int, "
     "(lambda))", None)])
def test_trace_names_map_to_launches(name, launch):
    found = kernels.launch_of(name)
    assert (found and found[0]) == launch


def csrc_kernels():
    """Every ``__global__`` function of the program's kernel sources."""
    names = set()
    for path in sorted(CSRC.glob("*.cu*")):
        names |= set(re.findall(
            r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(?:void\s+)?(\w+)\s*\(", path.read_text()))
    return names


def test_every_csrc_kernel_maps_to_a_launch():
    found = csrc_kernels()
    assert {"stats_window_kernel", "pool_reduce", "dw_finish"} <= found
    assert found == set(kernels.KERNELS)
    for ident, launch in kernels.KERNELS.items():
        assert launch in kernels.FIRST_KERNEL
        assert kernels.FIRST_KERNEL[launch] in kernels.KERNELS


def _record(kernel_times):
    return {"kind": "serve", "calls": 1, "clips_per_call": 20,
            "model": model("action"),
            "trace": {"busy_s": 1.0, "window_s": 1.0,
                      "kernels": kernel_times}}


def test_roofline_counts_every_kernel_of_a_launch():
    bounds = kernels.bounds_per_call(model("action"), 20, False)
    both = {name: {"seconds": 4 * sec, "launches": n}
            for name, (n, sec) in bounds.items()}
    assert reading.kernel_roofline(_record(both), "serve") == \
        pytest.approx(25.0)


def test_roofline_refuses_a_launch_it_cannot_bound():
    times = {"action_stats": {"seconds": 1e-3, "launches": 16},
             "action_sweep": {"seconds": 1e-3, "launches": 16}}
    with pytest.raises(ValueError, match="action_sweep"):
        reading.kernel_roofline(_record(times), "serve")


def test_sites():
    sites = kernels.resnet_sites(224)
    assert len(sites) == 16
    assert sites[0] == (3136, 64, 64) and sites[3] == (3136, 256, 128)
    assert sites[-1] == (49, 2048, 512)
