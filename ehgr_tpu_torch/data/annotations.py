"""Annotation builders (the port's own copy of
``ehgr_tpu/data/annotations.py``): one pandas pickle per split with
list-of-frame-path columns (``rgb, depth, depth_est, label`` for
EgoGesture, plus ``skeleton`` for NvGesture), label 0-based, the same
rows in the same order as the JAX package's builders.

pandas is imported inside the functions that use it, so the runner
imports without it (the synthetic sources need none).
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Dict, List, Sequence

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

# Subject-ID splits of the EgoGesture benchmark
EGO_SPLITS: Dict[str, List[int]] = {
    "train": [3, 4, 5, 6, 8, 10, 15, 16, 17, 20, 21, 22, 23, 25, 26, 27, 30,
              32, 36, 38, 39, 40, 42, 43, 44, 45, 46, 48, 49, 50],
    "val": [1, 7, 12, 13, 24, 29, 33, 34, 35, 37],
    "test": [2, 9, 11, 14, 18, 19, 28, 31, 41, 47],
}
EGO_SPLITS["train_plus_val"] = EGO_SPLITS["train"] + EGO_SPLITS["val"]


def _listdir_clean(path: str) -> List[str]:
    return [n for n in os.listdir(path) if n != ".DS_Store"]


def construct_annot_ego(frame_path: str, label_path: str, save_path: str,
                        mode: str, skip_missing: bool = True) -> str:
    """Walk ``Subject*/Scene*/{Color,Depth,Depth_Est}`` trees + per-group
    ``class,start,end`` CSVs; emit ``<save_path>/<mode>.pkl``.

    Frame range per gesture instance is ``[start, end-1)`` and labels are
    shifted to 0-based, matching the reference exactly.  ``skip_missing``
    tolerates absent subject dirs (partial downloads / synthetic trees);
    pass False for the reference's crash-on-missing behavior."""
    import pandas as pd

    rows = {k: [] for k in ("rgb", "depth", "depth_est", "label")}
    for sub_i in EGO_SPLITS[mode]:
        sub_frames = os.path.join(frame_path, f"Subject{sub_i:02}")
        sub_labels = os.path.join(label_path, f"subject{sub_i:02}")
        if skip_missing and not os.path.isdir(sub_frames):
            continue
        n_scenes = len(_listdir_clean(sub_frames))
        for scene_i in range(1, n_scenes + 1):
            scene = os.path.join(sub_frames, f"Scene{scene_i}")
            rgb_root = os.path.join(scene, "Color")
            depth_root = os.path.join(scene, "Depth")
            dest_root = os.path.join(scene, "Depth_Est")
            lab_scene = os.path.join(sub_labels, f"Scene{scene_i}")
            n_groups = len(_listdir_clean(rgb_root))
            for g in range(1, n_groups + 1):
                csv = os.path.join(lab_scene, f"Group{g}.csv")
                if not os.path.isfile(csv):
                    csv = os.path.join(lab_scene, f"group{g}.csv")
                note = pd.read_csv(csv, names=["class", "start", "end"])
                note = note[~np.isnan(note["start"])]
                for cls, start, end in note.values:
                    frames = range(int(start), int(end - 1))
                    rows["rgb"].append(
                        [os.path.join(rgb_root, f"rgb{g}", f"{i:06}.jpg")
                         for i in frames])
                    rows["depth"].append(
                        [os.path.join(depth_root, f"depth{g}", f"{i:06}.jpg")
                         for i in frames])
                    rows["depth_est"].append(
                        [os.path.join(dest_root, f"depth_est{g}",
                                      f"{i:06}.jpg") for i in frames])
                    rows["label"].append(int(cls) - 1)
    os.makedirs(save_path, exist_ok=True)
    out = os.path.join(save_path, f"{mode}.pkl")
    pd.DataFrame(rows).to_pickle(out)
    return out


def construct_annot_nv(dataset_path: str, save_path: str, mode: str) -> str:
    """Parse ``nvgesture_{train,test}_correct_cvpr2016_v2.lst``
    (``path:...``, ``:start:end``, ``label:`` fields) into a pickle with
    rgb / depth / depth_est / skeleton / label columns."""
    import pandas as pd

    lst = os.path.join(dataset_path,
                       f"nvgesture_{mode}_correct_cvpr2016_v2.lst")
    rows = {k: [] for k in ("rgb", "depth", "depth_est", "skeleton", "label")}
    with open(lst) as f:
        for line in f:
            params = line.split(" ")
            rel = params[0].split(":")[1].split("/")
            base = os.path.join(dataset_path, *rel[1:4])
            start = int(params[2].split(":")[2])
            end = int(params[2].split(":")[3])
            label = int(params[4].split(":")[1]) - 1
            idx = range(start, end + 1)
            rows["rgb"].append(
                [os.path.join(base, "sk_color_all", f"{i:05}.jpg")
                 for i in idx])
            rows["depth"].append(
                [os.path.join(base, "sk_depth_all", f"{i:05}.jpg")
                 for i in idx])
            rows["depth_est"].append(
                [os.path.join(base, "sk_depth_est_all", f"{i:05}.jpg")
                 for i in idx])
            rows["skeleton"].append(
                [os.path.join(base, "sk_skeleton_all", f"{i:05}.npy")
                 for i in idx])
            rows["label"].append(label)
    os.makedirs(save_path, exist_ok=True)
    out = os.path.join(save_path, f"{mode}.pkl")
    pd.DataFrame(rows).to_pickle(out)
    return out


def subset_annot(annot_path: str, mode: str, classes: Sequence[int],
                 save_as: str, remap_labels: bool = False) -> str:
    """Filter a split pickle to a class subset — the offline prep behind the
    reference's ``train_plus_val_10cls`` / ``test_10cls`` splits
    (``train_sd.py:572-594``).  Writes ``<annot_path>/<save_as>.pkl``."""
    import pandas as pd

    df = pd.read_pickle(os.path.join(annot_path, f"{mode}.pkl"))
    keep = df["label"].isin(list(classes))
    out = df[keep].reset_index(drop=True)
    if remap_labels:
        mapping = {c: i for i, c in enumerate(sorted(classes))}
        out = out.assign(label=[mapping[int(l)] for l in out["label"]])
    path = os.path.join(annot_path, f"{save_as}.pkl")
    out.to_pickle(path)
    return path


def make_10cls_splits(annot_path: str, classes: Sequence[int] = tuple(range(10))):
    """Create the 10-class EgoGesture study splits the SD trainer consumes."""
    return (subset_annot(annot_path, "train_plus_val", classes,
                         "train_plus_val_10cls"),
            subset_annot(annot_path, "test", classes, "test_10cls"))


def load_annotations(annot_path: str, mode: str) -> pd.DataFrame:
    """Read ``<annot_path>/<mode>.pkl`` (the reference ``load_video*``
    contract, ``dataset_EgoGesture.py:100-138``)."""
    import pandas as pd

    return pd.read_pickle(os.path.join(annot_path, f"{mode}.pkl"))
