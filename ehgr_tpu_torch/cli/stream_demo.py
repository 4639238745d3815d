"""Streaming-recognition demo (counterpart of ``cli/stream_demo.py``): the
online recognizer over a synthetic frame stream, frames pushed one at a
time, one window scored every ``--stride`` frames, debounced start/end
events printed:

  python -m ehgr_tpu_torch.cli.stream_demo --preset ego_sd --synthetic \
      [--checkpoint_path <ckpt.pth>] [--frames 256] [--stride 8] \
      [--threshold 0.6] [--cascade_exit 0] [--device cuda|cpu]

``--cascade_exit K`` scores windows with the truncated ``tsn_middle{K}``
deploy model instead of the full net.
"""

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--stride", type=int, default=8)
    p.add_argument("--threshold", type=float, default=0.6)
    p.add_argument("--cascade_exit", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args, rest = p.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))

    import numpy as np

    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.eval.runner import _build_model
    from ehgr_tpu_torch.eval.streaming import (StreamingRecognizer,
                                               make_stream_score_fn)

    cfg = config_from_args(rest, default_preset="ego_sd")
    exit_k = args.cascade_exit
    arch = f"tsn_middle{exit_k}" if exit_k else "tsn"
    model, _ = _build_model(cfg, arch, args.device)
    fn = make_stream_score_fn(model, device=args.device,
                              crop_size=cfg.data.crop_size,
                              dtype_name=cfg.model.dtype)
    rec = StreamingRecognizer(fn, num_segments=cfg.model.num_segments,
                              window=4 * cfg.model.num_segments,
                              stride=args.stride, threshold=args.threshold)

    # synthetic stream: per-class pixel bias segments, gesture-like
    rng = np.random.default_rng(cfg.run.seed)
    hw = cfg.data.crop_size
    events, t0 = [], time.perf_counter()
    cls = int(rng.integers(0, cfg.model.num_classes))
    for i in range(args.frames):
        if i % 64 == 0:
            cls = int(rng.integers(0, cfg.model.num_classes))
        frame = rng.integers(0, 256, (hw, hw, 3)).astype(np.uint8)
        frame[..., 0] = np.clip(frame[..., 0] * 0.5 + cls * 13, 0, 255)
        for ev in rec.push(frame):
            events.append(ev)
            print(f"frame {ev.frame_index:5d}: {ev.kind:5s} class "
                  f"{ev.label} (conf {ev.confidence:.2f})", flush=True)
    events += rec.flush()
    dt = time.perf_counter() - t0
    print(f"{args.frames} frames in {dt:.1f}s = {args.frames / dt:.1f} fps "
          f"({arch}, stride {args.stride}); {len(events)} events")
    return {"fps": args.frames / dt, "events": len(events), "arch": arch}


if __name__ == "__main__":
    main()
