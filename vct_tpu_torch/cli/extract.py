"""Offline feature extraction CLI (port of ``vct_tpu/cli/extract.py``): the
reference's training-data preparation step.

    python -m vct_tpu_torch.cli.extract --videos ./raw_vids --out ./feats \\
        --ext_type uni_12 --clip_weights ViT-B-32.pt
    python -m vct_tpu_torch.cli.extract --videos ./raw_vids --out ./rgb \\
        --feat_type I3D --i3d_stream both --out_flow ./flow \\
        --i3d_weights rgb_imagenet.pt --i3d_flow_weights flow_imagenet.pt

The reference tells users to produce per-video ``.npy`` features with the
``video_features`` submodule before training (``README.md:94-96``). This
CLI does it in-process: host decode and sampling, then the CLIP ViT-B/32
tower (one ``(T, 512)`` ``.npy`` per video, frames in chunks of
``--batch_frames``) or the Kinetics I3D tower (one ``(n_stacks, 1024)``
``.npy`` per video and stream, one 64-frame clip per call) on the card,
``--cpu`` for the host. The files are what ``vct_tpu_torch.data.datasets``
and the reference dataloader read.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import List

import numpy as np
import torch

from vct_tpu_torch.cli.common import add_device_args, resolve_device

VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".webm", ".mov", ".mpg", ".mpeg")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Extract CLIP features for a video dir")
    p.add_argument("--videos", required=True, type=str,
                   help="directory of raw videos (or a single video file)")
    p.add_argument("--out", required=True, type=str, help="output .npy directory")
    p.add_argument("--ext_type", type=str, default="uni_12",
                   help="frame sampling: [type]_[param] (uni_12 fps_2 fix_20 tsn_12); "
                        "I3D ignores this and uses 64-frame stacks at stride 64")
    p.add_argument("--feat_type", type=str, default="CLIP4CLIP-ViT-B-32",
                   choices=["CLIP", "CLIP4CLIP-ViT-B-32", "I3D"],
                   help="feature extractor (reference predict_video.py:157); "
                        "CLIP* -> (T, 512) frame features, I3D -> (n_stacks, 1024)")
    p.add_argument("--clip_weights", type=str, default=None,
                   help="CLIP ViT-B/32 weights (OpenAI .pt / HF .bin / .npz)")
    p.add_argument("--i3d_stream", choices=["rgb", "flow", "both"],
                   default="rgb",
                   help="I3D stream: rgb (default), flow (host-side optical "
                        "flow into the flow tower; estimator note in "
                        "vct_tpu_torch/i3d/flow.py), or both — one pass writing "
                        "RGB features to --out and flow features to "
                        "--out_flow, decoding and cropping each video once "
                        "instead of twice.")
    p.add_argument("--i3d_weights", type=str, default=None,
                   help="Kinetics I3D weights for --feat_type I3D, matching "
                        "--i3d_stream (RGB weights for rgb/both, flow weights "
                        "for flow; torch InceptionI3d state dict .pt/.pth or "
                        ".npz)")
    p.add_argument("--i3d_flow_weights", type=str, default=None,
                   help="Kinetics I3D FLOW weights (--i3d_stream both)")
    p.add_argument("--out_flow", type=str, default=None,
                   help="output .npy directory for the flow features with "
                        "--i3d_stream both (RGB goes to --out)")
    p.add_argument("--batch_frames", type=int, default=256,
                   help="frames per device batch (CLIP)")
    p.add_argument("--overwrite", action="store_true")
    add_device_args(p)
    return p


def list_videos(path: str) -> List[pathlib.Path]:
    p = pathlib.Path(path)
    if p.is_file():
        return [p]
    vids = sorted(q for q in p.iterdir() if q.suffix.lower() in VIDEO_EXTS)
    if not vids:
        raise SystemExit(f"no videos under {path!r} (looked for {VIDEO_EXTS})")
    stems = {}
    for v in vids:
        if v.stem in stems:
            raise SystemExit(
                f"output collision: {stems[v.stem].name} and {v.name} would both "
                f"write {v.stem}.npy — rename one"
            )
        stems[v.stem] = v
    return vids


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    both = args.feat_type == "I3D" and args.i3d_stream == "both"
    out_flow_dir = None
    if both:
        if args.out_flow is None:
            raise SystemExit("--i3d_stream both needs --out_flow "
                             "(flow .npy dir; RGB features go to --out)")
        out_flow_dir = pathlib.Path(args.out_flow)
        out_flow_dir.mkdir(parents=True, exist_ok=True)

    if args.feat_type == "I3D":
        video_feats = _make_i3d_encoder(args, device)
    else:
        video_feats = _make_clip_encoder(args, device)

    vids = list_videos(args.videos)
    done = skipped = 0
    for vp in vids:
        out_paths = [out_dir / f"{vp.stem}.npy"]
        if both:
            out_paths.append(out_flow_dir / f"{vp.stem}.npy")
        # per-file skip: without --overwrite an existing output is never
        # rewritten, even when its sibling stream is missing and the video
        # has to be recomputed
        targets = (out_paths if args.overwrite
                   else [p for p in out_paths if not p.exists()])
        if not targets:
            skipped += 1
            continue
        feats = video_feats(vp) if both else [video_feats(vp)]
        for out_path, f in zip(out_paths, feats):
            if out_path not in targets:
                continue
            np.save(out_path, f.astype(np.float32))
            print(f"{vp.name}: {f.shape} -> {out_path}")
        done += 1
    dirs = f"{out_dir} + {out_flow_dir}" if both else f"{out_dir}"
    print(f"extracted {done} videos ({skipped} skipped) to {dirs}")


def _make_clip_encoder(args, device: torch.device):
    """Per-video CLIP features: ``--ext_type`` sampling, the ViT-B/32 tower on
    ``--batch_frames`` frames a call (the tower's compiled program: a CUDA
    graph per chunk shape, the last ``graphs.StagedModule.max_sets`` kept;
    no frame batch is padded), one (T, 512) array per video."""
    from vct_tpu_torch import graphs
    from vct_tpu_torch.cli.predict import load_clip_tower
    from vct_tpu_torch.clip import preprocess_frames, sample_frames

    tower = graphs.StagedModule(load_clip_tower(args.clip_weights, device), "pixels")

    def video_feats(vp: pathlib.Path) -> np.ndarray:
        pixels = torch.from_numpy(preprocess_frames(sample_frames(str(vp), args.ext_type)))
        return np.concatenate([tower(chunk.to(device)).cpu().numpy()
                               for chunk in pixels.split(args.batch_frames)])

    return video_feats


def _make_i3d_encoder(args, device: torch.device):
    """Per-video I3D features: decode every frame, 64-frame stacks at stride
    64 (the video_features I3D recipe the reference delegates to), the tower
    one clip per call, one (n_stacks, 1024) array per video and stream."""
    from vct_tpu_torch.cli.predict import load_i3d_tower
    from vct_tpu_torch.clip import sample_frames
    from vct_tpu_torch.i3d import preprocess_i3d_flow, preprocess_i3d_frames
    from vct_tpu_torch.i3d.model import stack_features

    if args.i3d_weights is None:
        what = "RGB" if args.i3d_stream == "both" else args.i3d_stream.upper()
        raise SystemExit(f"--feat_type I3D needs --i3d_weights "
                         f"(Kinetics InceptionI3d {what} state dict)")

    if args.i3d_stream == "both":
        # one pass: decode and crop once per video, then both towers; the
        # shared crop is what preprocess_i3d_frames / _flow each start from,
        # so the features equal two single-stream runs'
        if args.i3d_flow_weights is None:
            raise SystemExit("--i3d_stream both needs --i3d_flow_weights "
                             "(Kinetics InceptionI3d FLOW state dict)")
        from vct_tpu_torch.i3d import flow_from_cropped, resize_center_crop, scale_i3d_frames

        rgb = load_i3d_tower(args.i3d_weights, device)
        flow = load_i3d_tower(args.i3d_flow_weights, device)

        def video_feats(vp):
            cropped = resize_center_crop(sample_frames(str(vp), "fix_1"))  # every frame
            return (stack_features(rgb, scale_i3d_frames(cropped)),
                    stack_features(flow, flow_from_cropped(cropped)))

        return video_feats

    tower = load_i3d_tower(args.i3d_weights, device)
    prep = (preprocess_i3d_flow if args.i3d_stream == "flow"
            else preprocess_i3d_frames)

    def video_feats(vp) -> np.ndarray:
        # a 1-frame video is handled inside the preprocessors
        # (flow_from_cropped duplicates the frame; i3d_stacks loops frames)
        return stack_features(tower, prep(sample_frames(str(vp), "fix_1")))

    return video_feats


if __name__ == "__main__":
    main()
