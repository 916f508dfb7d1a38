"""Training orchestration (port of ``vct_tpu/train/loop.py``).

Epoch structure of the reference: train epoch -> scheduler step -> validation
losses -> caption-metric eval -> sample prediction -> logging -> metric/loss
earlystop -> periodic save. Checkpoints are full resumable train states;
``Trainer.resume`` continues mid-run with the same save/stop/LR decisions.

Ported: the caption, match and cross tasks (the last two with a frozen text
encoder: the CLIP text tower from ``tpu.clip_text_weights`` /
``clip_vocab_json`` / ``clip_merges_txt``, or one passed in), the UniVL
decoder import (``caption_decoder.univl``, before ``pretrained_model``, the
reference's load order), and eval decoding on the decode kernels (greedy, or
beam search when ``tpu.beam_size`` > 1).

In one process on a card the train and validation steps replay CUDA graphs
(``train.step.GraphedTrainStep`` / ``GraphedEvalStep``: a shape's first call
runs eagerly, later calls replay); on the host, and on a mesh with a process
group, they run eagerly. ``resume`` restores into the same state, so the
train step's graphs are captured again after it.

On a mesh (a process group exists: ``torchrun``, or ``cli.train -ws N``) the
Trainer is one rank of ``tpu.mesh_data x tpu.mesh_model``
(``parallel.mesh``): every rank draws the same global batch and takes its
rows, the train step runs under DDP and the validation parts are summed over
the data group; each rank decodes its rows of every eval batch and the
tokens are gathered in batch order; rank 0 scores them and its numbers decide
earlystop, the scheduler and saving on every rank. At ``mesh_model`` > 1 the
FFNs and the LM head are split (``shard_train_state``) and the fused loss is
off, as in the reference. Rank 0 alone logs, writes TensorBoard and writes
checkpoints (whole tensors); each rank's dropout generator is seeded from
(``tpu.seed``, its data index).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from vct_tpu_torch import tracing
from vct_tpu_torch.config import Config
from vct_tpu_torch.convert import load_state_dict_into, load_torch_state_dict
from vct_tpu_torch.data.collate import Batch, collate
from vct_tpu_torch.data.loader import DataLoader, build_dataloader
from vct_tpu_torch.decode import (
    detokenize_batch,
    make_auto_beam_fn,
    make_auto_greedy_fn,
    pipelined_map,
)
from vct_tpu_torch.evalcap.scorer import COCOScorer, make_coco_sample
from vct_tpu_torch.models.lfm2 import caption_lm_config
from vct_tpu_torch.models.mmt4caption import DTYPES, MMT4Caption
from vct_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast_object,
    make_mesh,
    row_range,
    shard_batch,
    shard_train_state,
)
from vct_tpu_torch.text.tokenizer import CaptionPreprocessor, make_tokenizer
from vct_tpu_torch.train.earlystop import EarlyStopping
from vct_tpu_torch.train.optimizers import (
    build_optimizer,
    build_scheduler,
    set_learning_rate,
)
from vct_tpu_torch.train.state import (
    make_train_state,
    rank_seed,
    restore_checkpoint,
    save_checkpoint,
)
from vct_tpu_torch.train.step import (
    batch_to_arrays,
    combine_eval_parts,
    make_eval_step,
    make_train_step,
    reduce_eval_parts,
)

METRIC_KEYS = ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr")  # the earlystop sum
CKPT_SUFFIX = ".pt"


def make_trainer_mesh(cfg: Config, device: torch.device) -> Mesh:
    """The mesh ``tpu.mesh_data`` x ``tpu.mesh_model`` names, over the
    process group when one exists (else one process). A config whose mesh is
    another size than the group is refused: a rank left out would wait."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = cfg.tpu.mesh_data, cfg.tpu.mesh_model
    if data != -1 and data * model != world:
        raise ValueError(f"tpu.mesh_data x tpu.mesh_model = {data} x {model} = "
                         f"{data * model} ranks, but the process group has {world}: run "
                         f"{data * model} processes (cli.train -ws, torchrun) or set "
                         f"tpu.mesh_data to -1")
    return make_mesh(data, model, device=device)


class Trainer:
    def __init__(self, cfg: Config, *, device: torch.device, tokenizer=None,
                 text_encoder: Optional[Callable[[List[str]], torch.Tensor]] = None,
                 mesh: Optional[Mesh] = None, writer=None,
                 log: Callable[[str], None] = print):
        self.cfg = cfg
        self.device = device
        self.task = cfg.train.task
        self.mesh = mesh or make_trainer_mesh(cfg, device)
        self.log = log if self.mesh.is_main else (lambda *_: None)
        self.text_encoder = text_encoder
        if self.task in ("match", "cross") and text_encoder is None:
            if not cfg.tpu.clip_text_weights:
                raise ValueError("match/cross tasks need a text_encoder: pass one, or set "
                                 "tpu.clip_text_weights/clip_vocab_json/clip_merges_txt")
            from vct_tpu_torch.clip.text import build_text_encoder

            self.text_encoder = build_text_encoder(
                cfg.model.text_enc_type, device=device, clip_weights=cfg.tpu.clip_text_weights,
                vocab_json=cfg.tpu.clip_vocab_json, merges_txt=cfg.tpu.clip_merges_txt)
        self.tokenizer = tokenizer or make_tokenizer(cfg.tpu.vocab_path, cfg.model.tokenizer)
        self.preprocessor = CaptionPreprocessor(self.tokenizer, cfg.tpu.max_caption_len)

        model_cfg = cfg.model
        if (model_cfg.vocab_size != self.tokenizer.vocab_size
                or model_cfg.pad_id != self.tokenizer.pad_id):
            # vocab size and [PAD] come from the tokenizer, as in the reference
            model_cfg = dataclasses.replace(model_cfg, vocab_size=self.tokenizer.vocab_size,
                                            pad_id=self.tokenizer.pad_id)
        tpu_cfg = cfg.tpu
        if self.mesh.model > 1 and tpu_cfg.use_fused_loss:
            # the fused loss takes the whole generator; a vocab-split head
            # materialises its shard's logits and reduces the statistics
            self.log("model-axis > 1: the fused LM-head loss is off; the loss is taken "
                     "from vocab-sharded logits")
            tpu_cfg = dataclasses.replace(tpu_cfg, use_fused_loss=False)
        caption_lm = caption_lm_config(cfg.raw)
        if caption_lm is not None and (self.mesh.model > 1 or cfg.model.caption_decoder.univl):
            raise ValueError("model.caption_lm: the LFM2 caption LM takes neither tensor "
                             "parallelism (tpu.mesh_model) nor a UniVL decoder")
        self.model = MMT4Caption(model_cfg, tpu_cfg, dtype=DTYPES[cfg.tpu.dtype],
                                 caption_lm=caption_lm)
        self.model.init_weights(torch.Generator().manual_seed(cfg.tpu.seed))
        self.model.to(device)
        if cfg.model.caption_decoder.univl:
            from vct_tpu_torch.convert import import_univl_decoder

            import_univl_decoder(self.model,
                                 load_torch_state_dict(cfg.model.caption_decoder.univl))
            self.log(f"imported UniVL decoder from {cfg.model.caption_decoder.univl}")
        if cfg.model.pretrained_model:
            self.load_pretrained(cfg.model.pretrained_model)
        shard_train_state(self.mesh, self.model)

        self.optimizer = build_optimizer(cfg.train, self.model)
        self.scheduler = build_scheduler(cfg.train)
        self.state = make_train_state(self.model, self.optimizer, device=device,
                                      seed=rank_seed(cfg.tpu.seed, self.mesh.data_index))
        step_mesh = self.mesh if self.mesh.distributed else None
        self.train_step = make_train_step(self.task, mesh=step_mesh)
        self.val_step = make_eval_step(self.task, mesh=step_mesh)
        self.earlystop = EarlyStopping(patience=cfg.train.earlystop, trace_func=self.log)
        self.writer = writer if self.mesh.is_main else None
        self.start_epoch = 0
        self.step_losses: List[float] = []  # the last train epoch's, per step
        self.history: List[Dict[str, Any]] = []  # per epoch: losses, validation, scores
        self.last_captions: Dict[str, str] = {}  # the last eval decode's, by video

        self.loaders: Dict[str, DataLoader] = {}
        self.datasets: Dict[str, Any] = {}
        for name, split in (("train", cfg.data.train), ("validation", cfg.data.validation),
                            ("eval", cfg.data.eval)):
            if split is None:
                continue
            prep = self.preprocessor if name != "eval" else None
            ds, loader = build_dataloader(split, cfg.tpu, preprocessor=prep)
            self.datasets[name], self.loaders[name] = ds, loader

    # ------------------------------------------------------------------

    def load_pretrained(self, path: str) -> None:
        """Load a reference-format ``.pth`` (lenient: missing and unexpected
        keys are reported, not raised)."""
        report = load_state_dict_into(self.model, load_torch_state_dict(path))
        self.log(f"loaded {path}: missing={len(report['missing'])} "
                 f"unexpected={len(report['unexpected'])}")

    def _progress(self, loader, desc: str):
        if not self.cfg.tpu.progress_bar:
            return loader
        try:
            from tqdm import tqdm

            return tqdm(loader, total=len(loader), desc=desc, leave=False)
        except ImportError:
            return loader

    def local_rows(self, batch: Batch) -> Batch:
        """This rank's rows of a collated global batch (itself off a data
        mesh): every rank draws the same batch and keeps its share."""
        if self.mesh.data == 1:
            return batch
        lo, hi = row_range(self.mesh, batch.feats[0].shape[0])
        n_valid = None if batch.n_valid is None else max(0, min(hi, batch.n_valid) - lo)
        return Batch(shard_batch(self.mesh, batch.feats), shard_batch(self.mesh, batch.masks),
                     batch.captions[lo:hi], batch.vids[lo:hi],
                     shard_batch(self.mesh, batch.token_ids),
                     shard_batch(self.mesh, batch.token_mask), n_valid)

    def _arrays(self, batch: Batch) -> Dict[str, Any]:
        return batch_to_arrays(self.local_rows(batch), self.device, self.text_encoder)

    def train_epoch(self, epoch: int) -> float:
        loader = self.loaders["train"]
        loader.set_epoch(epoch)
        # losses stay on the device until the epoch ends: fetching one per
        # step would stall the host on every step
        losses = []
        batches = iter(self._progress(loader, f"train e{epoch}"))
        while True:
            with tracing.span("train.fetch"):
                batch = next(batches, None)
            if batch is None:
                break
            arrays = self._arrays(batch)
            with tracing.span("train.step"):
                self.state, metrics = self.train_step(self.state, arrays)
            losses.append(metrics["loss"])
        if not losses:
            self.step_losses = []
            return 0.0
        losses = torch.stack(losses).double()
        self.step_losses = losses.tolist()
        return float(losses.mean())

    def val_epoch(self) -> Dict[str, float]:
        """Validation losses from exact sum/count parts reduced here (over the
        batches, and the data group on a mesh), so the result is independent
        of batching and filler rows add nothing."""
        loader = self.loaders.get("validation")
        if loader is None:
            return {}
        parts_list = [self.val_step(self.model, self._arrays(batch)) for batch in loader]
        if not parts_list:
            return {}
        # one fetch at the end, in float64 so the sum does not depend on order
        sums = reduce_eval_parts({k: torch.stack([p[k] for p in parts_list])
                                  for k in parts_list[0]},
                                 self.mesh if self.mesh.distributed else None)
        return combine_eval_parts(
            self.task, sums, sce_alpha=self.cfg.model.caption_decoder.sce_loss_alpha,
            loss_beta=self.cfg.model.loss_beta)

    def _greedy_fn(self, shard_rows: bool = True):
        """The eval decoder over the model's CURRENT weights (the kernel
        weights are extracted anew: training changes them every step): beam
        search when ``tpu.beam_size`` > 1, greedy otherwise. On a data mesh
        (``shard_rows``) each rank decodes its rows and the tokens come back
        whole."""
        self.model.eval()
        cfg = self.cfg
        mesh = self.mesh if shard_rows and self.mesh.data > 1 else None
        if cfg.tpu.beam_size > 1:
            return make_auto_beam_fn(self.model, cfg.test.max_length,
                                     self.tokenizer.start_id, self.tokenizer.end_id,
                                     cfg.tpu.beam_size, mesh=mesh)
        return make_auto_greedy_fn(self.model, cfg.test.max_length,
                                   self.tokenizer.start_id, self.tokenizer.end_id, mesh=mesh)

    def eval_epoch(self, verbose: bool = False) -> Dict[str, float]:
        """Decode the eval split and score it with the COCO scorers (on rank
        0, whose scores every rank takes)."""
        loader = self.loaders.get("eval")
        if loader is None:
            return {}
        vid2result = self.last_captions = self.decode_split(loader)
        scores = None
        if self.mesh.is_main:
            gts, samples, ids = make_coco_sample(vid2result,
                                                 self.datasets["eval"].video2caption)
            scores = dict(COCOScorer(verbose=verbose).score(gts, samples, ids))
        return broadcast_object(scores, self.mesh)

    def decode_split(self, loader: DataLoader) -> Dict[str, str]:
        """The next batch's decode is launched before the previous one's
        tokens are fetched and detokenised (``pipelined_map``). On a data
        mesh each rank decodes its rows and every rank gets the whole
        batch's tokens, in batch order."""
        decode = self._greedy_fn()
        vid2result: Dict[str, str] = {}

        def _launch(batch):
            arrays = batch_to_arrays(batch, self.device)
            return decode(arrays["feats"], arrays["masks"])[0]

        for batch, tokens in pipelined_map(_launch, self._progress(loader, "decode")):
            caps = detokenize_batch(self.tokenizer, tokens)
            for vid, cap in list(zip(batch.vids, caps))[: batch.n_valid]:
                vid2result[vid] = cap
        return vid2result

    # ------------------------------------------------------------------

    def _log_scalars(self, epoch: int, scalars: Dict[str, float]) -> None:
        line = " | ".join(f"{k}={v:.4f}" for k, v in scalars.items())
        self.log(f"[epoch {epoch}] {line}")
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(k, v, epoch)

    def _ckpt_path(self, suffix: str) -> str:
        return os.path.join(self.cfg.train.save_dir, self.cfg.train.tag + suffix + CKPT_SUFFIX)

    def _run_ctl(self) -> Dict[str, float]:
        """Flat run-control scalars: earlystop + scheduler internals."""
        ctl = {f"es_{k}": v for k, v in self.earlystop.state_dict().items()}
        ctl.update({f"sched_{k}": v for k, v in self.scheduler.state_dict().items()})
        return ctl

    def save(self, suffix: str, epoch: int) -> str:
        """Every rank takes part (shards are gathered); rank 0 writes."""
        path = self._ckpt_path(suffix)
        save_checkpoint(path, self.state, epoch=epoch, run_ctl=self._run_ctl(),
                        mesh=self.mesh)
        return path

    def resume(self, path: str) -> None:
        self.state, self.start_epoch, run_ctl = restore_checkpoint(path, self.state,
                                                                   mesh=self.mesh)
        if self.state.reseeded:
            seed = rank_seed(self.cfg.tpu.seed + self.state.step, self.mesh.data_index)
            self.state.generator.manual_seed(seed)
            self.log(f"{path} was written at another world size: the dropout generators "
                     f"are re-seeded from (tpu.seed + step, data index)")
        if run_ctl is not None:
            self.earlystop.load_state_dict(
                {k[3:]: v for k, v in run_ctl.items() if k.startswith("es_")})
            self.scheduler.load_state_dict(
                {k[6:]: v for k, v in run_ctl.items() if k.startswith("sched_")})
            lr = self.scheduler.lr
            set_learning_rate(self.optimizer, lr)
            self.log(f"restored run control: earlystop counter="
                     f"{self.earlystop.counter} best={self.earlystop.best_score} lr={lr}")
        self.log(f"resumed from {path} at epoch {self.start_epoch}")

    def fit(self) -> Dict[str, float]:
        cfg = self.cfg
        last_scores: Dict[str, float] = {}
        plateau = type(self.scheduler).__name__ == "ReduceLROnPlateau"
        for epoch in range(self.start_epoch, cfg.train.epoch):
            t0 = time.time()
            train_loss = self.train_epoch(epoch)
            if not plateau:  # the plateau scheduler steps once the val loss is known
                set_learning_rate(self.optimizer, self.scheduler.step())

            # every rank takes rank 0's numbers (the scores too, in eval_epoch):
            # a rank that decided otherwise about the LR, earlystop or saving
            # would wait in the next collective
            train_loss, val_metrics = broadcast_object((train_loss, self.val_epoch()),
                                                       self.mesh)
            if plateau and val_metrics:
                set_learning_rate(self.optimizer, self.scheduler.step(val_metrics["loss"]))

            scores = self.eval_epoch()
            last_scores = scores

            scalars = {"train_loss": train_loss, "lr": self.scheduler.lr,
                       "epoch_seconds": time.time() - t0}
            scalars.update({f"val_{k}": v for k, v in val_metrics.items()})
            scalars.update(scores)
            self.history.append({"epoch": epoch, "train_loss": train_loss,
                                 "step_losses": self.step_losses, "val": val_metrics,
                                 "scores": scores})
            self._log_scalars(epoch, scalars)
            self.print_sample()

            # earlystop: metric sum (maximize) or val loss (minimize)
            if cfg.train.metric_earlystop and scores:
                value = -sum(scores.get(k, 0.0) for k in METRIC_KEYS)
            else:
                value = val_metrics.get("loss", train_loss)
            # epoch + 1 wherever a checkpoint is taken AFTER the epoch ran: the
            # stored value is "next epoch to train", so resuming never
            # re-applies a completed epoch's updates
            self.earlystop(value, save_fn=lambda: self.save("_earlystop", epoch + 1))
            if self.earlystop.early_stop:
                self.log(f"early stop at epoch {epoch}")
                # mark the run CONCLUDED in the rolling checkpoint: a
                # `--resume auto` relaunch must find nothing left to train
                self.save("_latest", cfg.train.epoch)
                break

            if (epoch + 1) % cfg.train.save_frequency == 0:
                self.save(f"_epoch{epoch}", epoch + 1)
            # preemption recovery: a rolling full train-state checkpoint every
            # epoch; `--resume auto` picks it up
            self.save("_latest", epoch + 1)
        return last_scores

    def print_sample(self) -> None:
        """Print one eval video's prediction beside a ground truth."""
        ds = self.datasets.get("eval")
        if ds is None or not len(ds):
            return
        if self.mesh.model == 1 and not self.mesh.is_main:
            return  # a split model decodes on every rank of its group
        feats, _, vid = ds[0]
        batch = collate([(feats, "", vid)], batch_size=1, max_frames=self.cfg.tpu.max_frames)
        arrays = batch_to_arrays(batch, self.device)
        tokens, _ = self._greedy_fn(shard_rows=False)(arrays["feats"], arrays["masks"])
        pred = detokenize_batch(self.tokenizer, tokens)[0]
        gt = ds.video2caption.get(vid, [""])[0]
        self.log(f"sample [{vid}] pred: {pred!r} | gt: {gt!r}")
