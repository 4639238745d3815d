"""Export a serving artifact (counterpart of ``cli/export_serving.py``): the
whole scoring program (on-device preprocess + backbone + clip vote) with
its weights, the kernels kept as custom ops, written as one file that a
serving process reloads without model code (``ehgr_tpu_torch.serve``).

  python -m ehgr_tpu_torch.cli.export_serving --preset ego_baseline \
      --out model.ehgrtx [--arch tsn|tsn_middle2|...] \
      [--checkpoint_path <file.pth>] [--clip_num 10] [--videos 8|sym] \
      [--clip_scorer] [--device cuda|cpu]

``--videos sym`` exports a symbolic batch dimension (one artifact, any
batch).  ``--clip_scorer`` exports the pre-cropped ``[N,T,H,W,3] -> [N,C]``
deploy contract instead of the full video protocol.  The program serves on
the device it was exported on (``--device``, default ``cuda``), so the JAX
CLI's ``--platforms`` is refused.  The other flags are those of
``config_from_args`` (``--quantize static|dynamic`` exports int8 block
convs, ``--action_fused mega|prologue`` the ACTION kernels).
"""

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--out", default="model.ehgrtx")
    p.add_argument("--arch", default="tsn")
    p.add_argument("--clip_num", type=int, default=10)
    p.add_argument("--videos", default="8")
    p.add_argument("--platforms", default=None)
    p.add_argument("--clip_scorer", action="store_true")
    p.add_argument("--device", default="cuda")
    args, rest = p.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))
    if args.platforms is not None:
        raise SystemExit("--platforms has no counterpart here: a torch "
                         "artifact serves on the device it is exported on; "
                         "pass --device cuda|cpu")

    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.eval.runner import _build_model
    from ehgr_tpu_torch.serve import (export_artifact, make_clip_scorer,
                                      make_video_scorer, save_artifact,
                                      symbolic_batch)
    from ehgr_tpu_torch.serve.export import graph_ops

    cfg = config_from_args(rest, default_preset="ego_baseline")
    model, _ = _build_model(cfg, args.arch, args.device)

    t, crop = cfg.model.num_segments, cfg.data.crop_size
    scale = cfg.data.scale_size
    if args.clip_scorer:
        scorer = make_clip_scorer(model, mean=cfg.data.mean,
                                  std=cfg.data.std,
                                  dtype_name=cfg.model.dtype)
        shape = (8, t, crop, crop, 3)
    else:
        # square resize = the EgoGesture protocol (test.py:204-207);
        # NvGesture short-side-resizes then crops (scale != crop)
        scorer = make_video_scorer(model, scale_size=scale, crop_size=crop,
                                   square_resize=(scale == crop),
                                   dtype_name=cfg.model.dtype)
        shape = (8, args.clip_num, t, scale, scale, 3)
    if args.videos == "sym":
        shape = symbolic_batch(shape)
    else:
        shape = (int(args.videos),) + shape[1:]

    program = export_artifact(scorer, shape)
    manifest = {"arch": args.arch, "preset": None,
                "clip_scorer": args.clip_scorer, "num_segments": t,
                "crop_size": crop, "scale_size": scale,
                "num_classes": cfg.model.num_classes,
                "quantize": cfg.model.quantize or None,
                "checkpoint": cfg.run.checkpoint_path or None}
    nbytes = save_artifact(args.out, program, manifest)
    res = {"out": args.out, "bytes": nbytes, "arch": args.arch,
           "in_shape": [getattr(d, "__name__", str(d)) for d in shape],
           "device": args.device, "ops": graph_ops(program)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
