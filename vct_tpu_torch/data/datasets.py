"""Datasets: MSR-VTT, MSVD, VATEX over per-modality ``.npy`` feature dirs.

Torch-free re-design of ``dataloader.py:354-532``. Semantics
kept:

* one ``.npy`` per video per modality; arrays stored (T, E) or (E, T) and
  auto-oriented so ``dim0 <= dim1`` (the reference's transpose rule,
  ``dataloader.py:382-385`` — it assumes T < E),
* ``by_caption`` mode: one sample per *caption*; ``by_video``: one per video
  (``dataloader.py:378-396``),
* ``debug``/``debug_num`` truncation of the caption list
  (``dataloader.py:408-409``),
* ``video2caption`` ground-truth map exposed for the scorer
  (``eval.py:157,162``).

Deviation (documented): the reference zips *unsorted* ``Path.glob`` streams
across modality dirs and assumes identical ordering (``dataloader.py:368-372``)
— OS-dependent and silently wrong if a file is missing in one modality. Here
videos are matched by filename stem across modalities and sorted; missing
stems raise.
"""

from __future__ import annotations

import abc
import json
import pathlib
from typing import Dict, List, Sequence, Tuple

import numpy as np


def load_feature(path: str) -> np.ndarray:
    """Load one modality feature, oriented (T, E) per the reference rule."""
    arr = np.load(str(path)).astype(np.float32)
    arr = np.squeeze(arr)
    if arr.ndim != 2:
        raise ValueError(f"feature {path} has shape {arr.shape}, want 2-D")
    if arr.shape[0] > arr.shape[1]:
        arr = arr.T
    return arr


def _index_feature_dirs(feat_dirs: Sequence[str]) -> Tuple[List[str], List[Dict[str, str]]]:
    """-> (sorted common stems, per-modality stem->path maps)."""
    maps: List[Dict[str, str]] = []
    for d in feat_dirs:
        m = {p.stem: str(p) for p in pathlib.Path(d).glob("*.npy")}
        if not m:
            raise FileNotFoundError(f"no .npy features under {d}")
        maps.append(m)
    # symmetric check: a stem present in ANY modality should exist in EVERY
    # modality (comparing only against maps[0] would silently drop videos
    # whose file was lost from the first dir). A stray extra .npy in some
    # dirs is survivable — warn and drop the stem (round-3 advisor finding:
    # hard-failing on extras aborted dataset construction the old
    # intersection code tolerated) — but if the intersection is empty the
    # dirs don't describe the same videos at all, so fail loudly.
    union = set().union(*maps)
    common = set.intersection(*(set(m) for m in maps))
    dropped = union - common
    if dropped:
        if not common:
            raise FileNotFoundError(
                f"feature dirs {list(feat_dirs)} share NO video stems "
                f"(e.g. {sorted(dropped)[:5]}...)"
            )
        import warnings

        per_dir = {
            str(d): sorted(set(m) - common)[:5]
            for d, m in zip(feat_dirs, maps)
            if set(m) - common
        }
        warnings.warn(
            f"dropping {len(dropped)} video stem(s) not present in every "
            f"modality dir (extras by dir: {per_dir})",
            stacklevel=2,
        )
    return sorted(common), maps


class CoreDataset(abc.ABC):
    """Multi-modality-ready base (reference ``Core_Dataset``)."""

    def __init__(
        self,
        feat_dirs: Sequence[str],
        annotation_path: str,
        split_type: str = "train",
        mode: str = "by_caption",
        debug: bool = False,
        debug_num: int = 400,
    ):
        if split_type.lower() in ("val", "validate"):
            split_type = "validate"
        if split_type not in ("train", "validate", "test"):
            # an unknown split silently matches zero annotations -> a run
            # that "works" on an empty dataset; fail fast instead
            raise ValueError(
                f"unknown split_type {split_type!r} "
                "(expected train/validate/val/test)"
            )
        self.split_type = split_type
        self.mode = mode
        self.feat_dirs = list(feat_dirs)
        self.annotation_path = annotation_path
        self.video_ids_all, self._maps = _index_feature_dirs(feat_dirs)
        self.video2caption: Dict[str, List[str]] = self._parse_annotations()
        # by_video iterates feature files like the reference
        # (dataloader.py:388-396, __len__ uses video_feat_list)
        self.video_ids = self.video_ids_all
        # filter against the COMMON-stem set, not the first modality dir:
        # a stem present in dir0 but dropped for missing siblings would
        # otherwise stay sampleable and KeyError mid-epoch at load time
        have = set(self.video_ids_all)
        self.cap_vid_list: List[Tuple[str, str]] = [
            (cap, vid)
            for vid, caps in self.video2caption.items()
            for cap in caps
            if vid in have
        ]
        if debug:
            self.cap_vid_list = self.cap_vid_list[:debug_num]

    @abc.abstractmethod
    def _parse_annotations(self) -> Dict[str, List[str]]:
        ...

    # -- item access -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.cap_vid_list) if self.mode == "by_caption" else len(self.video_ids)

    def feature_paths(self, vid: str) -> List[str]:
        return [m[vid] for m in self._maps]

    def load_video(self, vid: str) -> List[np.ndarray]:
        return [load_feature(p) for p in self.feature_paths(vid)]

    def row(self, index: int) -> Tuple[str, str]:
        """(caption, vid) for sample ``index`` under the current mode — the
        ONE mode dispatch shared by ``__getitem__`` and the native collate
        path (they must resolve identical rows for the same indices)."""
        if self.mode == "by_caption":
            return self.cap_vid_list[index]
        if self.mode == "by_video":
            return "", self.video_ids[index]
        raise ValueError(f"unknown mode {self.mode!r}")

    def __getitem__(self, index: int) -> Tuple[List[np.ndarray], str, str]:
        caption, vid = self.row(index)
        return self.load_video(vid), caption, vid

    @property
    def num_modal(self) -> int:
        return len(self.feat_dirs)


class MSRVTTDataset(CoreDataset):
    """MSR-VTT JSON annotations: ``videos[].split`` + ``sentences[]``
    (``dataloader.py:411-436``); splits train/validate/test."""

    def _parse_annotations(self) -> Dict[str, List[str]]:
        with open(self.annotation_path, encoding="utf-8") as f:
            ann = json.load(f)
        video2split = {v["video_id"]: v["split"] for v in ann["videos"]}
        out: Dict[str, List[str]] = {}
        for s in ann["sentences"]:
            if video2split.get(s["video_id"]) != self.split_type:
                continue
            out.setdefault(s["video_id"], []).append(s["caption"])
        return out


class MSVDDataset(CoreDataset):
    """MSVD line format ``"<vid> <caption words...>"``, one file per split
    (``dataloader.py:467-484``)."""

    def _parse_annotations(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        with open(self.annotation_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                vid, _, cap = line.partition(" ")
                out.setdefault(vid, []).append(cap)
        return out


class VATEXDataset(CoreDataset):
    """VATEX JSON list with ``videoID``/``enCap`` (legacy reference support,
    ``dataloader.py:114-151``); feature files keyed by the 11-char YouTube id
    prefix of the stem (``dataloader.py:121``)."""

    def _parse_annotations(self) -> Dict[str, List[str]]:
        with open(self.annotation_path, encoding="utf-8") as f:
            ann = json.load(f)
        stem_by_key = {s[:11]: s for s in self.video_ids_all}
        out: Dict[str, List[str]] = {}
        for item in ann:
            key = item["videoID"][:11]
            stem = stem_by_key.get(key)
            if stem is not None:
                out[stem] = list(item["enCap"])
        return out


_DATASETS = {"msrvtt": MSRVTTDataset, "msvd": MSVDDataset, "vatex": VATEXDataset}


def build_dataset(split_cfg) -> CoreDataset:
    """Factory mirroring ``build_dataloader``'s selection
    (``dataloader.py:513-522``); takes a ``SplitConfig``."""
    cls = _DATASETS.get(split_cfg.dataset.strip().lower())
    if cls is None:
        # fail fast like the unknown-split_type check: silently parsing a
        # VATEX file with the MSR-VTT parser crashes far from the typo
        raise ValueError(
            f"unknown dataset {split_cfg.dataset!r} "
            f"(expected one of {sorted(_DATASETS)})"
        )
    return cls(
        split_cfg.feat_dir,
        split_cfg.annotation_path,
        split_type=split_cfg.split_mode,
        mode=split_cfg.mode,
        debug=split_cfg.debug,
        debug_num=split_cfg.debug_num,
    )
