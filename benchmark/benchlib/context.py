"""What a driver is given, and what it gives back."""

from __future__ import annotations

import gc
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from benchlib.cells import Cell


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    tmp: str  # this run's scratch directory, removed at its end
    t_process: float  # perf_counter at process start: set-up is counted from here
    dims: Dict[str, int]

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic

    def program_config(self, vocab_path: str, split: str = "", feat_dir: str = "",
                       annotation: str = "") -> Dict[str, Any]:
        """The configuration as the program runs it: the cell's file with
        ``split`` (if any) reading the run's seeded files, the synthetic
        vocab, the run's seed for the program's own generators, no progress
        bars, and nothing written outside the run's directory."""
        cfg = json.loads(json.dumps(self.cell.config))
        cfg["data"] = ({split: {**cfg["data"][split], "feat_dir": [feat_dir],
                                "annotation_path": annotation}} if split else {})
        cfg["tpu"].update(vocab_path=vocab_path, seed=self.seed % (1 << 31), progress_bar=False)
        cfg["train"].update(save_dir=os.path.join(self.tmp, "ckpt"),
                            log_dir=os.path.join(self.tmp, "log"))
        return cfg


def release(device) -> None:
    """Give the program's freed state back before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


@dataclass
class Outcome:
    """A driver's result. ``e2e``: the end-to-end readings by metric name;
    ``checks``: the numbers that decide ``correct`` (the limits come from
    the cell's file); ``records``: what the per-layer readers read."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, float]
    memory_peak_bytes: int
    trace: Optional[Any] = None
    records: Dict[str, Any] = field(default_factory=dict)
    lines: Tuple[str, ...] = ()  # said on standard output before the result
