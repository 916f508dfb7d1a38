"""Training orchestration on one device (port of ``vct_tpu/train/loop.py``).

Epoch structure of the reference: train epoch -> scheduler step -> validation
losses -> caption-metric eval -> sample prediction -> logging -> metric/loss
earlystop -> periodic save. Checkpoints are full resumable train states;
``Trainer.resume`` continues mid-run with the same save/stop/LR decisions.

Ported: the caption, match and cross tasks (the last two with a frozen text
encoder: the CLIP text tower from ``tpu.clip_text_weights`` /
``clip_vocab_json`` / ``clip_merges_txt``, or one passed in), the UniVL
decoder import (``caption_decoder.univl``, before ``pretrained_model``, the
reference's load order), and eval decoding on the decode kernels (greedy, or
beam search when ``tpu.beam_size`` > 1). Left to a later slice: device meshes
and tensor parallelism (DDP).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from vct_tpu_torch.config import Config
from vct_tpu_torch.convert import load_state_dict_into, load_torch_state_dict
from vct_tpu_torch.data.collate import collate
from vct_tpu_torch.data.loader import DataLoader, build_dataloader
from vct_tpu_torch.decode import (
    detokenize_batch,
    make_auto_beam_fn,
    make_auto_greedy_fn,
    pipelined_map,
)
from vct_tpu_torch.evalcap.scorer import COCOScorer, make_coco_sample
from vct_tpu_torch.models.mmt4caption import DTYPES, MMT4Caption
from vct_tpu_torch.text.tokenizer import CaptionPreprocessor, make_tokenizer
from vct_tpu_torch.train.earlystop import EarlyStopping
from vct_tpu_torch.train.optimizers import (
    build_optimizer,
    build_scheduler,
    set_learning_rate,
)
from vct_tpu_torch.train.state import (
    make_train_state,
    restore_checkpoint,
    save_checkpoint,
)
from vct_tpu_torch.train.step import (
    batch_to_arrays,
    combine_eval_parts,
    make_eval_step,
    make_train_step,
)

METRIC_KEYS = ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr")  # the earlystop sum
CKPT_SUFFIX = ".pt"


class Trainer:
    def __init__(self, cfg: Config, *, device: torch.device, tokenizer=None,
                 text_encoder: Optional[Callable[[List[str]], torch.Tensor]] = None,
                 writer=None, log: Callable[[str], None] = print):
        self.cfg = cfg
        self.log = log
        self.device = device
        self.task = cfg.train.task
        if cfg.tpu.mesh_data > 1 or cfg.tpu.mesh_model > 1:
            raise NotImplementedError("multi-device training comes with the DDP slice")
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
        self.model = MMT4Caption(model_cfg, cfg.tpu, dtype=DTYPES[cfg.tpu.dtype])
        self.model.init_weights(torch.Generator().manual_seed(cfg.tpu.seed))
        self.model.to(device)
        if cfg.model.caption_decoder.univl:
            from vct_tpu_torch.convert import import_univl_decoder

            import_univl_decoder(self.model,
                                 load_torch_state_dict(cfg.model.caption_decoder.univl))
            self.log(f"imported UniVL decoder from {cfg.model.caption_decoder.univl}")
        if cfg.model.pretrained_model:
            self.load_pretrained(cfg.model.pretrained_model)

        self.optimizer = build_optimizer(cfg.train, self.model)
        self.scheduler = build_scheduler(cfg.train)
        self.state = make_train_state(self.model, self.optimizer, device=device,
                                      seed=cfg.tpu.seed)
        self.train_step = make_train_step(self.task)
        self.val_step = make_eval_step(self.task)
        self.earlystop = EarlyStopping(patience=cfg.train.earlystop, trace_func=log)
        self.writer = writer
        self.start_epoch = 0

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

    def train_epoch(self, epoch: int) -> float:
        loader = self.loaders["train"]
        loader.set_epoch(epoch)
        # losses stay on the device until the epoch ends: fetching one per
        # step would stall the host on every step
        losses = []
        for batch in self._progress(loader, f"train e{epoch}"):
            self.state, metrics = self.train_step(
                self.state, batch_to_arrays(batch, self.device, self.text_encoder))
            losses.append(metrics["loss"])
        if not losses:
            return 0.0
        return float(torch.stack(losses).double().mean())

    def val_epoch(self) -> Dict[str, float]:
        """Validation losses from exact sum/count parts reduced here, so the
        result is independent of batching and filler rows add nothing."""
        loader = self.loaders.get("validation")
        if loader is None:
            return {}
        parts_list = [self.val_step(self.model,
                                    batch_to_arrays(batch, self.device, self.text_encoder))
                      for batch in loader]
        if not parts_list:
            return {}
        # one fetch at the end, in float64 so the sum does not depend on order
        sums = {k: float(torch.stack([p[k] for p in parts_list]).double().sum())
                for k in parts_list[0]}
        return combine_eval_parts(
            self.task, sums, sce_alpha=self.cfg.model.caption_decoder.sce_loss_alpha,
            loss_beta=self.cfg.model.loss_beta)

    def _greedy_fn(self):
        """The eval decoder over the model's CURRENT weights (the kernel
        weights are extracted anew: training changes them every step): beam
        search when ``tpu.beam_size`` > 1, greedy otherwise."""
        self.model.eval()
        cfg = self.cfg
        if cfg.tpu.beam_size > 1:
            return make_auto_beam_fn(self.model, cfg.test.max_length,
                                     self.tokenizer.start_id, self.tokenizer.end_id,
                                     cfg.tpu.beam_size)
        return make_auto_greedy_fn(self.model, cfg.test.max_length,
                                   self.tokenizer.start_id, self.tokenizer.end_id)

    def eval_epoch(self, verbose: bool = False) -> Dict[str, float]:
        """Decode the eval split and score it with the COCO scorers."""
        loader = self.loaders.get("eval")
        if loader is None:
            return {}
        vid2result = self.decode_split(loader)
        gts, samples, ids = make_coco_sample(vid2result, self.datasets["eval"].video2caption)
        return dict(COCOScorer(verbose=verbose).score(gts, samples, ids))

    def decode_split(self, loader: DataLoader) -> Dict[str, str]:
        """The next batch's decode is launched before the previous one's
        tokens are fetched and detokenised (``pipelined_map``)."""
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
        path = self._ckpt_path(suffix)
        save_checkpoint(path, self.state, epoch=epoch, run_ctl=self._run_ctl())
        return path

    def resume(self, path: str) -> None:
        self.state, self.start_epoch, run_ctl = restore_checkpoint(path, self.state)
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

            val_metrics = self.val_epoch()
            if plateau and val_metrics:
                set_learning_rate(self.optimizer, self.scheduler.step(val_metrics["loss"]))

            scores = self.eval_epoch()
            last_scores = scores

            scalars = {"train_loss": train_loss, "lr": self.scheduler.lr,
                       "epoch_seconds": time.time() - t0}
            scalars.update({f"val_{k}": v for k, v in val_metrics.items()})
            scalars.update(scores)
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
        feats, _, vid = ds[0]
        batch = collate([(feats, "", vid)], batch_size=1, max_frames=self.cfg.tpu.max_frames)
        arrays = batch_to_arrays(batch, self.device)
        tokens, _ = self._greedy_fn()(arrays["feats"], arrays["masks"])
        pred = detokenize_batch(self.tokenizer, tokens)[0]
        gt = ds.video2caption.get(vid, [""])[0]
        self.log(f"sample [{vid}] pred: {pred!r} | gt: {gt!r}")
