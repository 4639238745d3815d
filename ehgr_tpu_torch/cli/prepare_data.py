"""Offline data prep CLI (counterpart of ``cli/prepare_data.py``): the
reference's "run this file first" step
(``data/dataset_EgoGesture.py:85-97`` ``construct_every_annot`` and
``data/dataset_NvGesture.py:62-69``), plus optional pseudo-depth trees and
the 10-class study splits.

  python -m ehgr_tpu_torch.cli.prepare_data ego --frame_path <frames> \
      --label_path <labels> --save_path <annot dir> [--pseudo_depth] \
      [--make_10cls]
  python -m ehgr_tpu_torch.cli.prepare_data nv --dataset_path <root> \
      --save_path <annot dir>

It runs on the host alone, but for ``--pseudo_depth --midas_weights
<dpt_large-midas-2f21e586.pt>``, which runs MiDaS DPT-Large on
``--device`` (default ``cuda``; ``data/pseudo_depth.py``); without
``--midas_weights`` the pseudo-depth is the labelled gray proxy.
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["ego", "nv"])
    p.add_argument("--frame_path", default="")
    p.add_argument("--label_path", default="")
    p.add_argument("--dataset_path", default="")
    p.add_argument("--save_path", required=True)
    p.add_argument("--pseudo_depth", action="store_true")
    p.add_argument("--midas_weights", default="",
                   help="dpt_large-midas-2f21e586.pt path -> MiDaS "
                        "pseudo-depth on --device; default is the labeled "
                        "gray proxy")
    p.add_argument("--device", default="cuda",
                   help="where --midas_weights runs DPT-Large")
    p.add_argument("--make_10cls", action="store_true")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    from ehgr_tpu_torch.data.annotations import (construct_annot_ego,
                                                 construct_annot_nv,
                                                 make_10cls_splits)

    written = []
    if args.dataset == "ego":
        if args.pseudo_depth:
            from ehgr_tpu_torch.data.pseudo_depth import (
                generate_pseudo_depth_tree, midas_predictor)

            pred = midas_predictor(args.midas_weights, args.device) \
                if args.midas_weights else None
            n = generate_pseudo_depth_tree(args.frame_path, args.frame_path,
                                           predictor=pred)
            print(f"pseudo-depth frames written: {n}")
        for mode in ("train", "val", "test", "train_plus_val"):
            written.append(construct_annot_ego(
                args.frame_path, args.label_path, args.save_path, mode))
        if args.make_10cls:
            written.extend(make_10cls_splits(args.save_path))
    else:
        for mode in ("train", "test"):
            written.append(construct_annot_nv(
                args.dataset_path, args.save_path, mode))
    return written


if __name__ == "__main__":
    for path in main():
        print(path)
