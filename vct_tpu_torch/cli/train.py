"""Training CLI (port of ``vct_tpu/cli/train.py``).

    python -m vct_tpu_torch.cli.train -c configs/msvd.json [--resume auto]

``-c/--config`` JSON, ``--resume`` (a checkpoint file, or ``auto`` for
``<save_dir>/<tag>_latest.pt`` when present), ``--no_tensorboard``, device
flags (``--gpu``, the default, is cuda:0 and fails without a card; ``--cpu``
asks for the host), ``--profile DIR`` for a ``torch.profiler`` trace of one
train epoch. One process drives one device: ``-ws`` other than 1 is refused
until the DDP slice.
"""

from __future__ import annotations

import argparse
import copy
import os

import torch

from vct_tpu_torch.cli.common import add_device_args, load_config, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train MMT4Caption on one CUDA device")
    p.add_argument("-c", "--config", required=True, type=str,
                   help="The path of '.json' config file")
    p.add_argument("-ws", "--world_size", default=1, type=int,
                   help="number of devices; only 1 until the DDP slice")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint file to resume (optimizer+epoch included); "
                        "'auto' resumes from <save_dir>/<tag>_latest.pt if present")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the first train epoch to "
                        "DIR/train_epoch.json (chrome://tracing, Perfetto)")
    add_device_args(p)
    return p


def profile_epoch(trainer, out_dir: str) -> str:
    """Trace one train epoch, then put the pre-profile state back so the real
    run carries no hidden extra epoch of updates."""
    from torch.profiler import ProfilerActivity, profile

    state = trainer.state
    before = (copy.deepcopy(state.model.state_dict()),
              copy.deepcopy(state.optimizer.state_dict()),
              state.generator.get_state(), state.step)
    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_epoch.json")
    with profile(activities=activities) as prof:
        trainer.train_epoch(trainer.start_epoch)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
    prof.export_chrome_trace(path)
    state.model.load_state_dict(before[0])
    state.optimizer.load_state_dict(before[1])
    state.generator.set_state(before[2])
    state.step = before[3]
    return path


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.world_size != 1:
        raise SystemExit("-ws other than 1: multi-device training comes with the DDP "
                         "slice of the port")
    device = resolve_device(args)

    from vct_tpu_torch.train.loop import CKPT_SUFFIX, Trainer
    from vct_tpu_torch.utils import setup_seed

    cfg = load_config(args.config)
    setup_seed(cfg.tpu.seed)
    print(cfg.display())

    writer = None
    if not args.no_tensorboard:
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(os.path.join(cfg.train.log_dir, cfg.train.tag))
        except ImportError:
            print("tensorboardX unavailable; logging to stdout only")

    trainer = Trainer(cfg, device=device, writer=writer)
    if args.resume == "auto":
        latest = os.path.join(cfg.train.save_dir, cfg.train.tag + "_latest" + CKPT_SUFFIX)
        if os.path.isfile(latest):
            trainer.resume(latest)
        else:
            print(f"--resume auto: no checkpoint at {latest}, starting fresh")
    elif args.resume:
        trainer.resume(args.resume)
    if args.profile:
        print(f"profile trace written to {profile_epoch(trainer, args.profile)}")
    scores = trainer.fit()
    if writer is not None:
        writer.close()
    print("final scores:", scores)
    return scores


if __name__ == "__main__":
    main()
