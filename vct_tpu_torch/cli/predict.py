"""Single-video prediction CLI (port of ``vct_tpu/cli/predict.py``; the
reference's ``predict_video.py``).

    python -m vct_tpu_torch.cli.predict -c configs/msvd.json -m ckpt.pth \\
        -v video.avi --clip_weights ViT-B-32.pt [--beam N | --vis_attn]

Contract (``predict_video.py:145-188``): ``-c`` config + ``-m`` checkpoint
(a reference ``.pth`` or the Trainer's ``.pt``), then either ``-v`` a raw
video or ``-f`` precomputed ``.npy`` features; ``--ext_type`` frame sampling
(``uni_12`` etc.); ``--greedy`` or ``--beam N``; ``--vis_attn`` renders the
decoder cross-attention heatmap to ``--attn_out``.

The raw-video path runs in-process: host decode and sampling
(``vct_tpu_torch.clip.frames``) feed the CLIP ViT-B/32 tower on the
captioner's device, whose features go straight to the decode kernels
(``vct_tpu_torch.pipeline``). CLIP weights come from ``--clip_weights``
(OpenAI ``.pt`` state dict, HF ``.bin``, or ``.npz``). Device flags as in the
other CLIs: ``--gpu``, the default, is cuda:0 and fails without a card;
``--cpu`` asks for the host.

With ``--feat_type I3D`` the video goes through the Kinetics I3D tower
(``--i3d_stream rgb``, ``flow`` or ``both``, weights from ``--i3d_weights`` /
``--i3d_flow_weights``) on the captioner's device, 64-frame stacks one clip
per call, and its ``[1, n_stacks, 1024]`` features take the features path.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vct_tpu_torch.cli.common import (
    add_device_args,
    load_checkpoint_into,
    load_config,
    load_feature_files,
    make_trainer_pieces,
    resolve_device,
)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Caption a single video")
    p.add_argument("-c", "--config", required=True, type=str,
                   help="The path of '.json' config file")
    p.add_argument("-m", "--model", required=True, type=str,
                   help="The path of model checkpoint (.pth, or the Trainer's .pt)")
    inp = p.add_mutually_exclusive_group(required=True)
    inp.add_argument("-v", "--video", type=str, help="The path of input video")
    inp.add_argument("-f", "--features", nargs="+", type=str,
                     help="The paths of input features of a video (.npy, (T, E))")
    p.add_argument("--feat_type", nargs="+", type=str,
                   choices=["CLIP", "I3D", "CLIP4CLIP-ViT-B-32"],
                   default=["CLIP4CLIP-ViT-B-32"],
                   help="feature extractor for -v (reference predict_video.py:157): "
                        "CLIP* = ViT-B/32 image tower (T, 512); I3D = Kinetics "
                        "InceptionI3d RGB (n_stacks, 1024)")
    p.add_argument("--ext_type", type=str, default="uni_12",
                   help="frame sampling: [type]_[param], e.g. uni_12 fps_2 fix_20 tsn_12 "
                        "(I3D ignores this: 64-frame stacks at stride 64)")
    p.add_argument("--clip_weights", type=str, default=None,
                   help="CLIP ViT-B/32 weights for -v (OpenAI .pt / HF .bin / .npz)")
    p.add_argument("--i3d_weights", type=str, default=None,
                   help="Kinetics I3D RGB weights for -v with --feat_type I3D")
    p.add_argument("--i3d_stream", choices=["rgb", "flow", "both"],
                   default="rgb",
                   help="I3D stream(s): rgb (default), flow (host-side "
                        "optical flow into the flow tower; estimator note in "
                        "vct_tpu_torch/i3d/flow.py), or both (two modalities)")
    p.add_argument("--i3d_flow_weights", type=str, default=None,
                   help="Kinetics I3D FLOW weights (--i3d_stream flow/both)")
    gen = p.add_mutually_exclusive_group()
    gen.add_argument("--greedy", action="store_true", help="greedy decode (default)")
    gen.add_argument("--beam", type=int, help="beam search decode")
    p.add_argument("--vis_attn", action="store_true",
                   help="save decoder cross-attention heatmap to --attn_out")
    p.add_argument("--attn_out", type=str, default="attn.png")
    add_device_args(p)
    return p


def load_clip_tower(clip_weights: str, device: torch.device):
    """The ViT-B/32 tower with ``clip_weights`` loaded (strict), on ``device``."""
    from vct_tpu_torch.clip.convert import convert_clip, load_clip_state_dict
    from vct_tpu_torch.clip.vision import CLIPVisionTower

    if clip_weights is None:
        raise SystemExit("-v needs --clip_weights (CLIP ViT-B/32 state dict); "
                         "or precompute features and use -f")
    tower = CLIPVisionTower(device=device)
    tower.load_state_dict(convert_clip(load_clip_state_dict(clip_weights), layers=tower.layers))
    return tower.eval().requires_grad_(False)


def load_i3d_tower(weights: str, device: torch.device):
    """The Kinetics I3D tower with ``weights`` (a torch InceptionI3d state
    dict or ``.npz``) folded and loaded (strict), its stem as wide as the
    checkpoint's (3 RGB, 2 flow), on ``device``."""
    from vct_tpu_torch.i3d import I3DTower, convert_i3d, load_i3d_state_dict

    sd = load_i3d_state_dict(weights)
    tower = I3DTower(sd["Conv3d_1a_7x7.conv3d.weight"].shape[1], device=device)
    tower.load_state_dict(convert_i3d(sd))
    return tower.eval().requires_grad_(False)


def _order_i3d_streams(streams, modal_names, log=print):
    """Align ``--i3d_stream both`` with the checkpoint's modality order.

    Both I3D streams are dim-1024, so the shape check cannot catch a
    swapped order (it would silently feed RGB features into the flow slot).
    When the config's modal names say which slot is which ('flow' / 'rgb'
    substrings), follow them; otherwise state the positional [rgb, flow]
    assumption out loud."""
    if len(streams) != 2:
        return streams
    names = [str(m).lower() for m in modal_names]
    flow_slots = [i for i, m in enumerate(names) if "flow" in m]
    rgb_slots = [i for i, m in enumerate(names) if "rgb" in m or m == "i3d"]
    # one identifiable slot pins the other, so one-sided evidence (e.g.
    # modal=['flow', 'motion'] or ['motion', 'rgb']) is enough to order by
    flow_idx = None
    if len(flow_slots) == 1 and flow_slots[0] not in rgb_slots:
        flow_idx = flow_slots[0]
    elif not flow_slots and len(rgb_slots) == 1:
        flow_idx = 1 - rgb_slots[0]
    if flow_idx == 0:
        log(f"modal names put flow first: feeding streams as ['flow', 'rgb'] "
            f"to match {list(modal_names)}")
        return ["flow", "rgb"]
    if flow_idx is None:
        log(f"WARNING: cannot tell which of modal={list(modal_names)} is the "
            "flow slot (both streams are dim 1024); assuming the training "
            "order was [rgb, flow]")
    return streams


def i3d_features(cfg, args, device: torch.device, log=print):
    """``-v`` with ``--feat_type I3D`` -> one [1, n_stacks, 1024] float32
    array per stream, in the config's modality order (reference
    ``vct_tpu/cli/predict.py:133-179``)."""
    from vct_tpu_torch.clip import sample_frames
    from vct_tpu_torch.i3d import FEATURE_DIM, preprocess_i3d_flow, preprocess_i3d_frames
    from vct_tpu_torch.i3d.model import stack_features

    streams = (["rgb", "flow"] if args.i3d_stream == "both"
               else [args.i3d_stream])
    if "rgb" in streams and args.i3d_weights is None:
        raise SystemExit("-v with --feat_type I3D needs --i3d_weights")
    if "flow" in streams and args.i3d_flow_weights is None:
        raise SystemExit(f"--i3d_stream {args.i3d_stream} needs "
                         "--i3d_flow_weights")
    if (len(cfg.model.modal) != len(streams)
            or any(d != FEATURE_DIM for d in cfg.model.modal_shape)):
        raise SystemExit(
            f"I3D streams {streams} produce {len(streams)} modalit"
            f"{'y' if len(streams) == 1 else 'ies'} of dim {FEATURE_DIM}; "
            f"config has modal={cfg.model.modal} "
            f"modal_shape={cfg.model.modal_shape}"
        )
    streams = _order_i3d_streams(streams, cfg.model.modal, log)
    frames = sample_frames(args.video, "fix_1")
    weights = {"rgb": args.i3d_weights, "flow": args.i3d_flow_weights}
    # a 1-frame video is handled inside the preprocessors
    # (flow_from_cropped duplicates the frame; i3d_stacks loops frames)
    prep = {"rgb": preprocess_i3d_frames, "flow": preprocess_i3d_flow}
    return [stack_features(load_i3d_tower(weights[s], device), prep[s](frames))[None]
            for s in streams]


def predict(cfg, args, *, device: torch.device, log=print) -> str:
    """Programmatic entry (reference ``predict``, ``predict_video.py:110-142``).
    Returns the caption string; the tokens at ``predict.tokens`` and, with
    ``args.vis_attn``, the attention maps [max_len-1, layers, 1, T_mem] at
    ``predict.attn``."""
    from vct_tpu_torch.decode import detokenize_batch, make_auto_beam_fn, make_auto_greedy_fn

    beam = int(getattr(args, "beam", None) or 0)
    collect_attn = bool(args.vis_attn)
    if beam and collect_attn:
        raise SystemExit("--vis_attn requires --greedy (per-step attention)")
    model, tokenizer = make_trainer_pieces(cfg, device)
    load_checkpoint_into(model, args.model, log=log, cfg=cfg)
    model.to_compute_dtype()
    max_len, start_id, end_id = cfg.test.max_length, tokenizer.start_id, tokenizer.end_id

    if args.video and args.feat_type[0] != "I3D":
        from vct_tpu_torch.clip import preprocess_frames, sample_frames
        from vct_tpu_torch.pipeline import make_video_caption_fn

        tower_dim = 512  # CLIP ViT-B/32 joint-space dim
        if len(cfg.model.modal) != 1 or cfg.model.modal_shape[0] != tower_dim:
            raise SystemExit(
                f"-v produces one CLIP modality of dim {tower_dim}; config has "
                f"modal={cfg.model.modal} modal_shape={cfg.model.modal_shape}")
        tower = load_clip_tower(args.clip_weights, device)
        pixels = torch.from_numpy(preprocess_frames(sample_frames(args.video, args.ext_type)))
        # one call: bypass the closure cache, which would keep this model and
        # tower alive after it
        fn = make_video_caption_fn.__wrapped__(
            model, tower, max_len=max_len, start_id=start_id, end_id=end_id,
            collect_attn=collect_attn, beam_size=beam)
        tokens, aux = fn(pixels[None].to(device))
    else:
        feats = (i3d_features(cfg, args, device, log) if args.video
                 else load_feature_files(args.features))
        if len(feats) != len(cfg.model.modal):
            raise SystemExit(f"config expects {len(cfg.model.modal)} modalities, "
                             f"got {len(feats)} feature inputs")
        masks = [torch.zeros(f.shape[:2], dtype=torch.bool, device=device) for f in feats]
        feats = [torch.from_numpy(f).to(device) for f in feats]
        if beam:
            # the decode kernels on the card, as eval and serving run them
            fn = make_auto_beam_fn(model, max_len, start_id, end_id, beam)
        else:
            # B=1 rides the whole-step kernel; attention capture takes the
            # module path (per-step weights)
            fn = make_auto_greedy_fn(model, max_len, start_id, end_id,
                                     collect_attn=collect_attn)
        tokens, aux = fn(feats, masks)
    caption = detokenize_batch(tokenizer, tokens)[0]
    predict.attn = aux.cpu().numpy() if (collect_attn and aux is not None) else None
    predict.tokens = tokens[0].cpu().numpy()
    return caption


def visualize_attention(attn: np.ndarray, tokens, tokenizer, out_path: str) -> None:
    """Mean cross-attention heatmap (reference ``visualize``,
    ``predict_video.py:82-107``): generated tokens x memory positions,
    averaged over layers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = np.asarray(attn, np.float32)
    a = a.reshape(a.shape[0], -1, a.shape[-1]).mean(axis=1)  # [steps, Tk]

    words = tokenizer.convert_ids_to_tokens(tokens[1:len(a) + 1])
    end = next((i for i, w in enumerate(words) if w == "[SEP]"), len(words))
    a, words = a[:end], words[:end]

    fig, ax = plt.subplots(figsize=(max(6, a.shape[1] * 0.5), max(4, len(words) * 0.4)))
    im = ax.imshow(a, aspect="auto", cmap="viridis")
    ax.set_yticks(range(len(words)), words)
    ax.set_xlabel("memory position (global + frames)")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    device = resolve_device(args)

    from vct_tpu_torch.text.tokenizer import make_tokenizer
    from vct_tpu_torch.utils import setup_seed

    cfg = load_config(args.config)
    setup_seed(cfg.tpu.seed)

    caption = predict(cfg, args, device=device)
    print(f"caption: {caption}")

    if args.vis_attn and predict.attn is not None:
        tokenizer = make_tokenizer(cfg.tpu.vocab_path, cfg.model.tokenizer)
        visualize_attention(predict.attn, predict.tokens, tokenizer, args.attn_out)
        print(f"attention heatmap saved to {args.attn_out}")
    return caption


if __name__ == "__main__":
    main()
