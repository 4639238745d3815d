"""GradCAM for TSN models (counterpart of ``ehgr_tpu/eval/gradcam.py``;
ref ``cam_visualize.py:60-100``: GradCAM over ``base_model.layer4[-1]``
via pytorch_grad_cam).

As in the JAX package: one forward of the whole model at eval pulls out the
stage's tap (``TSN(..., return_taps=True)``), then only the *head*, a pure
function of the tap, is differentiated.  The trunk runs under
``torch.no_grad()`` (in ``'mega'`` on the card that is the ACTION kernels,
which have no backward and are asked for none); the tap is detached and
the head rebuilt from the model's own modules: for the final exit, the
mean over h, w, ``new_fc`` and the consensus; for exit K, ``scalaK`` at
eval, the mean, ``middle_fcK`` and the consensus.  No softmax, whatever
``before_softmax`` says (the JAX head has none), and the consensus runs
over ``num_segments``, as JAX's.  The head computes in the parameters'
dtype (f32), whatever the trunk's compute dtype.

CAM = ReLU( sum_c ( mean_hw(dlogit/dA)_c * A_c ) ), per frame, normalized.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ehgr_tpu_torch.ops.consensus import consensus


def _final_head_fn(model) -> Tuple[Callable, str]:
    """layer4 tap ``[NT, C, h, w]`` -> ``[N, num_class]`` logits (pool +
    ``new_fc`` + consensus)."""
    fc = model.new_fc

    def head(acts):
        pooled = acts.mean((2, 3))
        logits = F.linear(pooled, fc.weight, fc.bias)
        return consensus(
            logits.reshape(-1, model.num_segments, logits.shape[-1]))

    return head, "layer4"


def _mid_head_fn(model, k: int) -> Tuple[Callable, str]:
    """layerK tap -> exit-K logits (``scalaK`` + ``middle_fcK`` +
    consensus)."""
    scala = getattr(model, f"scala{k}")
    fc = getattr(model, f"middle_fc{k}")

    def head(acts):
        h = scala(acts)
        pooled = h.mean((2, 3))
        logits = F.linear(pooled, fc.weight, fc.bias)
        return consensus(
            logits.reshape(-1, model.num_segments, logits.shape[-1]))

    return head, f"layer{k}"


def gradcam(model, clip, class_idx: Optional[int] = None,
            exit: str = "final") -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame CAMs for a normalized clip ``[N, T, H, W, 3]`` (a tensor,
    or an array put on the model's device).  ``exit``: ``'final'`` or
    ``'mid1'`` ... ``'mid3'``.  ``class_idx=None`` takes the argmax of
    video 0 for every video.

    Returns ``(cams [N*T, h, w] in [0,1], logits [N, C])`` as numpy."""
    dev = next(model.parameters()).device
    clip = torch.as_tensor(clip).to(dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            _, taps = model(clip, return_taps=True)
        if exit == "final":
            head, tap_name = _final_head_fn(model)
        else:
            head, tap_name = _mid_head_fn(model, int(exit[-1]))
        acts = taps[tap_name].detach().to(
            next(model.parameters()).dtype).requires_grad_(True)
        with torch.enable_grad():
            logits = head(acts)
            if class_idx is None:
                class_idx = int(torch.argmax(logits[0]))
            seed = torch.zeros_like(logits)
            seed[:, class_idx] = 1.0
            (grads,) = torch.autograd.grad(logits, acts, seed)
    finally:
        model.train(was_training)
    acts = acts.detach()
    weights = grads.mean((2, 3), keepdim=True)
    cam = torch.relu((weights * acts).sum(1))                  # [NT, h, w]
    lo = cam.amin((1, 2), keepdim=True)
    hi = cam.amax((1, 2), keepdim=True)
    cam = (cam - lo) / torch.clamp(hi - lo, min=1e-8)
    return cam.cpu().numpy(), logits.detach().cpu().numpy()


def overlay_cam(frame_u8: np.ndarray, cam: np.ndarray,
                alpha: float = 0.5) -> np.ndarray:
    """Blend a CAM heatmap (red channel ramp) over an RGB uint8 frame."""
    from PIL import Image

    h, w = frame_u8.shape[:2]
    cam_img = np.asarray(Image.fromarray(
        (cam * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR))
    heat = np.zeros_like(frame_u8)
    heat[..., 0] = cam_img                       # red ramp
    heat[..., 2] = 255 - cam_img                 # blue for cold
    return ((1 - alpha) * frame_u8 + alpha * heat).astype(np.uint8)
