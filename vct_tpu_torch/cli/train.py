"""Training CLI (port of ``vct_tpu/cli/train.py``).

    python -m vct_tpu_torch.cli.train -c configs/msvd.json [--resume auto]
    python -m vct_tpu_torch.cli.train -c configs/msvd.json -ws 4     # 4 cards
    torchrun --nproc_per_node 4 -m vct_tpu_torch.cli.train -c configs/msvd.json

``-c/--config`` JSON, ``--resume`` (a checkpoint file, or ``auto`` for
``<save_dir>/<tag>_latest.pt`` when present), ``--no_tensorboard``, device
flags (``--gpu``, the default, is cuda:0 and fails without a card; ``--cpu``
asks for the host), ``--profile DIR`` for a ``torch.profiler`` trace of one
train epoch.

``-ws/--world_size`` is the number of processes, one per device, data
parallel over ``torch.distributed`` (``vct_tpu_torch.parallel``): -1 (the
default, and ``--multi_gpu``) is every visible card. N > 1 spawns N
processes on cuda:0..N-1 with NCCL, or with ``--cpu`` N processes on the host
with gloo. Under ``torchrun`` the CLI joins its group (at any world size,
one included) on cuda:LOCAL_RANK. ``-ws N`` with fewer than N cards fails:
nothing runs on fewer ranks or on the host unless asked. The mesh is
``tpu.mesh_data`` x ``tpu.mesh_model`` over these ranks; ``-ws`` N sets
``mesh_data`` to N / ``mesh_model``. Rank 0 logs, writes TensorBoard and
checkpoints; ``main`` returns rank 0's scores.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import tempfile

import torch

from vct_tpu_torch.cli.common import add_device_args, load_config, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train MMT4Caption on CUDA devices")
    p.add_argument("-c", "--config", required=True, type=str,
                   help="The path of '.json' config file")
    p.add_argument("-ws", "--world_size", default=-1, type=int,
                   help="processes, one per device (-1 = every visible card; one with "
                        "--cpu)")
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


def world_of(args) -> int:
    """The number of processes ``-ws`` / ``--multi_gpu`` ask for; under
    torchrun its WORLD_SIZE, which an explicit ``-ws`` must name."""
    env = os.environ.get("WORLD_SIZE") if "RANK" in os.environ else None
    if env is not None:
        if args.world_size > 0 and args.world_size != int(env):
            raise SystemExit(f"-ws {args.world_size}, but torchrun started {env} processes")
        return int(env)
    if args.world_size > 0 and not args.multi_gpu:
        return args.world_size
    if args.cpu:
        return 1
    return max(torch.cuda.device_count(), 1)


def check_cards(args, world: int) -> None:
    """Without ``--cpu`` every rank needs a card of its own."""
    if args.cpu or world <= 1:
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < world:
        raise SystemExit(f"-ws {world} asks for {world} CUDA devices, one per process; "
                         f"this machine has {have}. Pass --cpu for {world} processes on "
                         f"the host (gloo)")


def run(args, *, rank=None, world_size=None, init_method=None):
    """Train as one rank (or the one process) -> (the Trainer, the final
    scores)."""
    from vct_tpu_torch.parallel.mesh import init_process_group
    from vct_tpu_torch.train.loop import CKPT_SUFFIX, Trainer
    from vct_tpu_torch.utils import setup_seed

    if "LOCAL_RANK" in os.environ and not args.cpu:  # torchrun
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --cpu to run on the host")
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    elif rank is not None and not args.cpu:
        device = torch.device("cuda", rank)
    else:
        device = resolve_device(args)
    import torch.distributed as dist

    had_group = dist.is_initialized()
    joined = init_process_group(device, rank=rank, world_size=world_size,
                                init_method=init_method)
    me = dist.get_rank() if joined else 0
    cfg = load_config(args.config)
    if args.world_size > 0 and not args.multi_gpu:  # -ws sets the data size, as the
        world, model = args.world_size, cfg.tpu.mesh_model  # reference's does
        cfg = cfg.replace(tpu=dataclasses.replace(
            cfg.tpu, mesh_data=world // model if world % model == 0 else -1))
    setup_seed(cfg.tpu.seed)
    if me == 0:
        print(cfg.display())

    writer = None
    if not args.no_tensorboard and me == 0:
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(os.path.join(cfg.train.log_dir, cfg.train.tag))
        except ImportError:
            print("tensorboardX unavailable; logging to stdout only")

    try:
        trainer = Trainer(cfg, device=device, writer=writer)
        if args.resume == "auto":
            latest = os.path.join(cfg.train.save_dir, cfg.train.tag + "_latest" + CKPT_SUFFIX)
            if os.path.isfile(latest):
                trainer.resume(latest)
            else:
                trainer.log(f"--resume auto: no checkpoint at {latest}, starting fresh")
        elif args.resume:
            trainer.resume(args.resume)
        if args.profile and me == 0 and not trainer.mesh.distributed:
            print(f"profile trace written to {profile_epoch(trainer, args.profile)}")
        elif args.profile:
            trainer.log("--profile traces one process; skipped on a process group")
        scores = trainer.fit()
        if writer is not None:
            writer.close()
        trainer.log(f"final scores: {scores}")
        return trainer, scores
    finally:
        if joined and not had_group:
            dist.destroy_process_group()


def _rank_main(rank: int, args, world: int, init_method: str, out: str):
    """One spawned rank: train, and rank 0 leaves its scores in ``out`` ->
    what ``run`` returns. Host ranks (``--cpu``) take one thread each: they
    share the cores."""
    if args.cpu:
        torch.set_num_threads(1)
    trainer, scores = run(args, rank=rank, world_size=world, init_method=init_method)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(scores, f)
    return trainer, scores


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    world = world_of(args)
    if "RANK" in os.environ or world == 1:
        return run(args)[1]
    check_cards(args, world)
    from vct_tpu_torch.parallel.mesh import spawn

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scores.json")
        spawn(_rank_main, world, args=(args, world, f"file://{tmp}/rendezvous", out))
        with open(out) as f:
            return json.load(f)


if __name__ == "__main__":
    main()
