"""GradCAM visualization CLI (counterpart of ``cli/cam_visualize.py``; ref
``cam_visualize.py``): per-frame CAM overlays over layer4 of the first clip
of the first five test videos, written as GIFs under
``<run_dir>/cam``.

  python -m ehgr_tpu_torch.cli.cam_visualize --preset ego_baseline \
      --checkpoint_path <file.pth> --annot_path <dir> [--synthetic] \
      [--device cuda|cpu]

The flags are those of ``cli/cam_visualize.py``, plus ``--device``
(default ``cuda``).
"""

import argparse
import os
import sys


def main(argv=None):
    import numpy as np
    import torch
    from PIL import Image

    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.data.factory import build_test_dataset
    from ehgr_tpu_torch.eval.gradcam import gradcam, overlay_cam
    from ehgr_tpu_torch.eval.runner import _build_model
    from ehgr_tpu_torch.ops.preprocess_device import normalize_clip

    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda")
    args, rest = dev.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))
    cfg = config_from_args(rest, default_preset="ego_baseline")
    model, _ = _build_model(cfg, "tsn", args.device)
    dataset = build_test_dataset(cfg)
    out_dir = os.path.join(cfg.run.run_dir, "cam")
    os.makedirs(out_dir, exist_ok=True)

    records = []
    for idx in range(min(5, len(dataset))):
        sample = dataset[idx]
        frames = sample["rgb"][0]                       # first clip [T,H,W,3]
        clip = normalize_clip(torch.as_tensor(frames[None]).to(args.device),
                              cfg.data.mean, cfg.data.std)
        cams, logits = gradcam(model, clip)
        imgs = [Image.fromarray(overlay_cam(frames[t], cams[t]))
                for t in range(frames.shape[0])]
        gif = os.path.join(out_dir, f"cam{idx:03d}.gif")
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=150, loop=0)
        records.append({"video": idx, "pred": int(np.argmax(logits[0])),
                        "label": int(sample["label"]), "gif": gif})
    return records


if __name__ == "__main__":
    print(main())
