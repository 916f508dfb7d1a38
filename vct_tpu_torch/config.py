"""Typed configuration system.

Ingests the reference's JSON config files verbatim (schema documented at
``README.md:124-144`` and exemplified by
``configs/*.json``; parsed by ``utils.py:82-112``)
and layers TPU-specific settings on top under an optional ``"tpu"`` key with
sensible defaults, so a reference config is a valid vct_tpu config.

Unlike the reference's raw-dict ``Config`` (``utils.py:82-89``), everything here
is a typed, validated dataclass; ``Config.check`` (which the reference defines
but never calls, ``utils.py:108-112``) runs automatically at load time.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union


def _get(d: Dict[str, Any], key: str, default=None):
    v = d.get(key, default)
    return default if v is None else v


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SplitConfig:
    """One of data.{train,validation,eval} (reference config ``data`` block)."""

    feat_dir: Tuple[str, ...] = ()
    annotation_path: str = ""
    dataset: str = "msrvtt"  # msrvtt | msvd | vatex
    mode: str = "by_caption"  # by_caption | by_video
    split_mode: str = "train"  # train | validate | test
    debug: bool = False
    debug_num: int = 0
    batch_size: int = 64

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SplitConfig":
        return SplitConfig(
            feat_dir=tuple(_get(d, "feat_dir", [])),
            annotation_path=_get(d, "annotation_path", ""),
            dataset=_get(d, "dataset", "msrvtt"),
            mode=_get(d, "mode", "by_caption"),
            split_mode=_get(d, "split_mode", "train"),
            debug=bool(_get(d, "_debug", False)),
            debug_num=int(_get(d, "_debug_num", 0)),
            batch_size=int(_get(d, "batch_size", 64)),
        )


@dataclass(frozen=True)
class DataConfig:
    train: Optional[SplitConfig] = None
    validation: Optional[SplitConfig] = None
    eval: Optional[SplitConfig] = None
    video_dir: Optional[str] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DataConfig":
        return DataConfig(
            train=SplitConfig.from_dict(d["train"]) if d.get("train") else None,
            validation=SplitConfig.from_dict(d["validation"]) if d.get("validation") else None,
            eval=SplitConfig.from_dict(d["eval"]) if d.get("eval") else None,
            video_dir=d.get("video_dir"),
        )


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LRSchedulerConfig:
    """Mirrors reference ``train.optimizer.lr_scheduler``
    (consumed at ``train.py:33-47``)."""

    name: str = "CosineAnnealingLR"  # CosineAnnealingLR | ReduceLROnPlateau | none
    T_max: int = 8
    eta_min: float = 1e-5
    factor: float = 0.1
    patience: int = 10

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "LRSchedulerConfig":
        if not d:
            return LRSchedulerConfig(name="none")
        return LRSchedulerConfig(
            name=_get(d, "name", "CosineAnnealingLR"),
            T_max=int(_get(d, "T_max", 8)),
            eta_min=float(_get(d, "eta_min", 1e-5)),
            factor=float(_get(d, "factor", 0.1)),
            patience=int(_get(d, "patience", 10)),
        )


@dataclass(frozen=True)
class OptimizerConfig:
    """Mirrors reference ``train.optimizer`` (``train.py:22-32``)."""

    name: str = "adam"  # adam | adamw | sgd
    learning_rate: float = 1e-4
    beta: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    momentum: float = 0.0

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OptimizerConfig":
        return OptimizerConfig(
            name=_get(d, "name", "adam").lower(),
            learning_rate=float(_get(d, "learning_rate", 1e-4)),
            beta=tuple(_get(d, "beta", (0.9, 0.999))),
            weight_decay=float(_get(d, "weight_decay", 0.0)),
            momentum=float(_get(d, "momentum", 0.0)),
        )


@dataclass(frozen=True)
class TrainConfig:
    task: str = "caption"  # caption | match | cross
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    earlystop: int = 5
    epoch: int = 30
    save_frequency: int = 100
    save_dir: str = "./checkpoint"
    log_dir: str = "./log"
    tag: str = "vct_tpu"
    metric_earlystop: bool = True

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TrainConfig":
        opt = _get(d, "optimizer", {})
        return TrainConfig(
            task=_get(d, "task", "caption"),
            optimizer=OptimizerConfig.from_dict(opt),
            lr_scheduler=LRSchedulerConfig.from_dict(opt.get("lr_scheduler")),
            earlystop=int(_get(d, "earlystop", 5)),
            epoch=int(_get(d, "epoch", 30)),
            save_frequency=int(_get(d, "save_frequency", 100)),
            save_dir=_get(d, "save_dir", "./checkpoint"),
            log_dir=_get(d, "log_dir", "./log"),
            tag=_get(d, "tag", "vct_tpu"),
            metric_earlystop=bool(_get(d, "metric_earlystop", True)),
        )


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MatchingConfig:
    """Mirrors reference ``model.matching`` (``MMT4Caption.py:86-91``)."""

    enable_tem: bool = False
    matching_loss: str = "CSL"  # CSL | CSL_WDS
    temperature: Optional[float] = None

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["MatchingConfig"]:
        if d is None:
            return None
        return MatchingConfig(
            enable_tem=bool(_get(d, "enable_tem", False)),
            matching_loss=_get(d, "matching_loss", "CSL"),
            temperature=d.get("temperature"),
        )


@dataclass(frozen=True)
class MMEConfig:
    """Mirrors reference ``model.video_encoder.mme`` (``MMT4Caption.py:80-83``)."""

    temporal: str = "encoding"  # encoding | embedding
    modal_different: bool = True
    do_norm: bool = False
    aggregation: str = "avg"  # max | avg | GRU | biGRU


@dataclass(frozen=True)
class VideoEncoderConfig:
    type: str = "mme"  # mme | simple | hmme
    # int for mme/simple; list[int] (per-modality depth) for hmme,
    # mirroring reference HMMEncoder num_encoder_layers (MMEncoder.py:316).
    layer: Union[int, Tuple[int, ...]] = 1
    nhead: int = 8
    feedforward: int = 2048
    mme: MMEConfig = field(default_factory=MMEConfig)
    aoa: bool = False  # dead key in the reference too (never read)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "VideoEncoderConfig":
        mme = _get(d, "mme", {})
        layer = _get(d, "layer", 1)
        if isinstance(layer, (list, tuple)):
            layer = tuple(int(x) for x in layer)
        else:
            layer = int(layer)
        return VideoEncoderConfig(
            type=_get(d, "type", "mme"),
            layer=layer,
            nhead=int(_get(d, "nhead", 8)),
            feedforward=int(_get(d, "feedforward", 2048)),
            mme=MMEConfig(
                temporal=_get(mme, "temporal", "encoding"),
                modal_different=bool(_get(mme, "modal_different", True)),
                do_norm=bool(_get(mme, "do_norm", False)),
                aggregation=_get(mme, "aggregation", "avg"),
            ),
            aoa=bool(_get(d, "aoa", False)),
        )


@dataclass(frozen=True)
class CaptionDecoderConfig:
    layer: int = 3
    nhead: int = 8
    feedforward: int = 2048
    sce_loss_alpha: float = 0.5
    # reference ``layer_type`` selects the attention-weights-returning decoder
    # (CapDecoder.py:21-24); in vct_tpu every decoder can return attention maps,
    # so this is accepted and ignored.
    layer_type: Optional[str] = None
    univl: Optional[str] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "CaptionDecoderConfig":
        return CaptionDecoderConfig(
            layer=int(_get(d, "layer", 3)),
            nhead=int(_get(d, "nhead", 8)),
            feedforward=int(_get(d, "feedforward", 2048)),
            sce_loss_alpha=float(_get(d, "sce_loss_alpha", 0.5)),
            layer_type=d.get("layer_type"),
            univl=d.get("univl"),
        )


@dataclass(frozen=True)
class ModelConfig:
    modal: Tuple[str, ...] = ("CLIP4Clip",)
    modal_shape: Tuple[int, ...] = (512,)
    tokenizer: str = "bert-base-uncased"
    text_enc_type: str = "CLIP"
    embed_dim: int = 768
    dropout: float = 0.3
    loss_beta: float = 0.5
    matching: Optional[MatchingConfig] = field(default_factory=MatchingConfig)
    activation: str = "gelu"
    video_encoder: VideoEncoderConfig = field(default_factory=VideoEncoderConfig)
    caption_decoder: CaptionDecoderConfig = field(default_factory=CaptionDecoderConfig)
    pretrained_model: Optional[str] = None
    # vocab size of the BERT WordPiece tokenizer; overridable for tests.
    vocab_size: int = 30522
    # [PAD] token id. The reference takes it from the tokenizer
    # (model/MMT4Caption.py:38 <- CapPreprocessor's "[PAD]" lookup); 0 for
    # bert-base-uncased. Trainer/make_trainer_pieces overwrite it with the
    # actual tokenizer's pad id so custom vocabs with [PAD] elsewhere keep
    # loss masking and decode-pad embedding consistent end to end.
    pad_id: int = 0

    @property
    def num_modal(self) -> int:
        return len(self.modal_shape)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelConfig":
        return ModelConfig(
            modal=tuple(_get(d, "modal", ("CLIP4Clip",))),
            modal_shape=tuple(int(x) for x in _get(d, "modal_shape", (512,))),
            tokenizer=_get(d, "tokenizer", "bert-base-uncased"),
            text_enc_type=_get(d, "text_enc_type", "CLIP"),
            embed_dim=int(_get(d, "embed_dim", 768)),
            dropout=float(_get(d, "dropout", 0.3)),
            loss_beta=float(_get(d, "loss_beta", 0.5)),
            matching=MatchingConfig.from_dict(d.get("matching")),
            activation=_get(d, "activation", "gelu"),
            video_encoder=VideoEncoderConfig.from_dict(_get(d, "video_encoder", {})),
            caption_decoder=CaptionDecoderConfig.from_dict(_get(d, "caption_decoder", {})),
            pretrained_model=d.get("pretrained_model"),
            vocab_size=int(_get(d, "vocab_size", 30522)),
            pad_id=int(_get(d, "pad_id", 0)),
        )


# ---------------------------------------------------------------------------
# tpu (vct_tpu extension block; all defaults — absent in reference configs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TPUConfig:
    """Static-shape and sharding settings that have no reference equivalent.

    XLA compiles one program per shape, so ragged batches (the reference pads
    to per-batch max, ``dataloader.py:233-276``) become fixed rectangles here.
    """

    # Static frames per modality. uni_12 feature extraction (README.md:60-64)
    # yields exactly 12 frames, so 12 is both faithful and tight.
    max_frames: int = 12
    # Static caption length incl. [CLS]/[SEP]; reference generation cap is 30
    # (configs test.max_length) and training captions are ragged-padded.
    max_caption_len: int = 32
    # Compute dtype for the jitted model ("bfloat16" on TPU, "float32" for
    # parity tests). Params are always kept in float32.
    dtype: str = "bfloat16"
    # Mesh axis sizes. data axis = data parallelism (reference DDP equivalent);
    # model axis reserved for tensor parallelism (unused at this model scale).
    mesh_data: int = -1  # -1 = all devices
    mesh_model: int = 1
    # WordPiece vocab file (BERT bert-base-uncased vocab.txt). Required because
    # this framework never downloads from the HF hub at runtime.
    vocab_path: Optional[str] = None
    # Use the Pallas fused-attention kernel when running on TPU.
    use_pallas_attention: bool = True
    # Keep the Pallas attention kernel on multi-device meshes by shard_map-ing
    # it over the 'data' axis (Mosaic kernels are single-device programs, so
    # without this the Trainer falls back to XLA attention when the mesh spans
    # more than one device). Off by default: correct by construction
    # (batch-parallel, no collectives) and interpret-mode tested, but this
    # machine has one chip, so the path has never run on real multi-chip
    # hardware.
    pallas_partition_kernels: bool = False
    # Fused LM-head+SCE loss (ops.fused_loss): the [B*S, vocab] logits never
    # exist in HBM on loss-only forwards (train/val steps). Values/gradients
    # match the materialized path to float summation order.
    use_fused_loss: bool = True
    # Fused-loss backward residual: stash each vocab chunk's half-precision
    # logits in the vjp forward instead of recomputing them in pass 2 and
    # the backward (same values to summation order; ~[B*S, vocab] 16-bit HBM
    # for 2 fewer generator GEMMs). Measured NEUTRAL on v5e at B=256
    # (35.9 vs 36.1 ms/step: the loss scans are VPU-bound on exp/compare,
    # not GEMM-bound), so it defaults off to keep the memory; flip it on
    # for chips where the generator GEMM is the binding resource. Ignored
    # for fp32 compute dtypes and on loss-only (validation) forwards.
    fused_loss_stash: bool = False
    # Run the fused-loss vocab sweeps as software-pipelined Mosaic kernels
    # (ops.pallas_loss): the chunk GEMM (MXU) overlaps the exp/compare sweep
    # (VPU) instead of serializing with it as the XLA scans do (the round-3
    # trace pinned the scans at ~12.6 ms of a B=256 step). Same values and
    # gradients to float-summation order (tests/test_pallas_loss.py). The
    # Trainer turns this off on multi-device meshes — Mosaic kernels are
    # single-device programs and the scans shard freely under GSPMD.
    fused_loss_pallas: bool = True
    # Opt-in fast numerics: drop the torch-parity-mandated fp32 softmax
    # logits and fp32 LayerNorm statistics down to the compute dtype
    # (bfloat16). Quantifies the "parity tax" on the train step (round-4
    # VERDICT #5) — default OFF so every parity/decode-exactness guarantee
    # holds; measured delta recorded in docs/PERF.md. Only affects the XLA
    # attention path and module LayerNorms; the Pallas kernels keep their
    # own (fp32-statistics) schedule either way.
    fast_numerics: bool = False
    # Replicate reference quirks bit-for-bit (see SURVEY.md Appendix A and
    # models/ docstrings) instead of the corrected semantics.
    quirk_unmasked_aggregation: bool = False
    quirk_no_memory_mask_in_decoder: bool = False
    # Host->device dtype for feature batches ("float32" or "float16").
    # float16 halves/quarters the bytes shipped per batch — the measured e2e
    # eval bottleneck on narrow host->device links — and the model casts
    # inputs to its compute dtype on device anyway. float32 default keeps
    # parity-test numerics byte-identical.
    feat_transfer_dtype: str = "float32"
    # decoding
    beam_size: int = 1  # 1 = greedy; >1 = beam search (reference stubs beam)
    seed: int = 666  # reference seeds 666 (train.py:308)
    # tqdm progress bars over train/decode batches (reference train.py:119,178)
    progress_bar: bool = True
    # Frozen CLIP text encoder assets for the match/cross tasks (reference
    # TextEncoder.py downloads ViT-B/32 at runtime; this framework loads local
    # files: a CLIP state dict (.pt/.bin/.npz) + HF-format vocab.json/merges.txt).
    clip_text_weights: Optional[str] = None
    clip_vocab_json: Optional[str] = None
    clip_merges_txt: Optional[str] = None

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "TPUConfig":
        if not d:
            return TPUConfig()
        known = {f.name for f in dataclasses.fields(TPUConfig)}
        return TPUConfig(**{k: v for k, v in d.items() if k in known})


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TestConfig:
    max_length: int = 30

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "TestConfig":
        if not d:
            return TestConfig()
        return TestConfig(max_length=int(_get(d, "max_length", 30)))


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)
    raw: Dict[str, Any] = field(default_factory=dict, repr=False)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        cfg = Config(
            data=DataConfig.from_dict(_get(d, "data", {})),
            train=TrainConfig.from_dict(_get(d, "train", {})),
            test=TestConfig.from_dict(d.get("test")),
            model=ModelConfig.from_dict(_get(d, "model", {})),
            tpu=TPUConfig.from_dict(d.get("tpu")),
            raw=d,
        )
        cfg.check()
        return cfg

    def check(self) -> None:
        """Validation the reference defines but never runs (utils.py:108-112)."""
        if self.model.video_encoder.type == "simple" and self.train.task != "caption":
            raise ValueError("Simple video encoder does NOT support 'cross' task")
        if len(self.model.modal) != len(self.model.modal_shape):
            raise ValueError("model.modal and model.modal_shape must have equal length")
        if self.model.embed_dim % self.model.video_encoder.nhead != 0:
            raise ValueError("embed_dim must be divisible by video_encoder.nhead")
        if self.model.embed_dim % self.model.caption_decoder.nhead != 0:
            raise ValueError("embed_dim must be divisible by caption_decoder.nhead")
        ve = self.model.video_encoder
        if ve.type == "hmme" and not isinstance(ve.layer, tuple):
            raise ValueError("hmme encoder requires per-modality layer list")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def display(self, width: int = 90) -> str:
        """Pretty-print, mirroring reference Config.display (utils.py:91-106)."""
        bold, thin = "=" * width, "-" * width
        lines = [bold, f"{'Config':^{width}}", bold]
        for mk, mv in self.raw.items():
            lines.append(f"{str(mk):^{width}}")
            lines.append(thin)
            if not isinstance(mv, dict):
                lines.append(str(mv))
            else:
                for k, v in mv.items():
                    lines.append("{:<20}| {}".format(k, v))
            lines.append(bold)
        out = "\n".join(lines)
        print(out)
        return out


def load_config(path: str) -> Config:
    """Load a config JSON (reference JSONs work verbatim)."""
    with open(path) as f:
        return Config.from_dict(json.load(f))
