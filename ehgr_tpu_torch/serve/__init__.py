from ehgr_tpu_torch.serve.export import (export_artifact, load_artifact,
                                         make_clip_scorer, make_video_scorer,
                                         save_artifact, symbolic_batch)

__all__ = ["export_artifact", "load_artifact", "make_clip_scorer",
           "make_video_scorer", "save_artifact", "symbolic_batch"]
