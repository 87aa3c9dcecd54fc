"""YAML config system with dataclass-backed defaults (`gimmvfi_tpu/utils/config.py`).

YAML files of the reference's schema (`configs/gimm/*.yaml`,
`configs/gimmvfi/*.yaml`) are read with PyYAML's safe loader and merged
over dataclass defaults, with `a.b.c=value` dot-list overrides.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional

import yaml


@dataclass
class HypoNetActivationConfig:
    type: str = "siren"
    siren_w0: float = 1.0


@dataclass
class HypoNetInitConfig:
    weight_init_type: str = "siren"
    bias_init_type: str = "siren"


@dataclass
class HypoNetConfig:
    type: str = "mlp"
    n_layer: int = 5
    hidden_dim: List[int] = field(default_factory=lambda: [128])
    use_bias: bool = True
    input_dim: int = 3
    output_dim: int = 2
    output_bias: float = 0.5
    normalize_weight: bool = True
    activation: HypoNetActivationConfig = field(default_factory=HypoNetActivationConfig)
    initialization: HypoNetInitConfig = field(default_factory=HypoNetInitConfig)


@dataclass
class ArchConfig:
    type: str = "gimmvfi_r"
    ema: Optional[bool] = True
    ema_value: Optional[float] = None
    fwarp_type: str = "linear"
    rec_weight: float = 0.1
    raft_iter: int = 20
    coord_range: List[float] = field(default_factory=lambda: [-1.0, 1.0])
    modulated_layer_idxs: Optional[List[int]] = None
    hyponet: HypoNetConfig = field(default_factory=HypoNetConfig)


@dataclass
class WarmupConfig:
    epoch: int = 1
    multiplier: float = 1.0
    buffer_epoch: int = 0
    min_lr: float = 8e-6
    mode: str = "fix"
    start_from_zero: bool = True


@dataclass
class OptimizerConfig:
    type: str = "adamw"
    init_lr: float = 8e-5
    weight_decay: float = 4e-5
    betas: List[float] = field(default_factory=lambda: [0.9, 0.999])
    ft: bool = True
    max_gn: Optional[float] = None
    warmup: WarmupConfig = field(default_factory=WarmupConfig)


@dataclass
class SubsampleConfig:
    type: Optional[str] = "random"
    ratio: float = 0.1


@dataclass
class LossConfig:
    type: str = "mse"
    perceptual_loss: bool = False
    subsample: SubsampleConfig = field(default_factory=SubsampleConfig)


@dataclass
class DatasetConfig:
    type: str = "vimeo_arb"
    path: str = "./data/vimeo90k/vimeo_septuplet"
    aug: bool = True


@dataclass
class ExperimentConfig:
    amp: bool = True
    batch_size: int = 4
    total_batch_size: int = 32
    epochs: int = 60
    save_ckpt_freq: int = 10
    test_freq: int = 10
    test_imlog_freq: int = 10
    seed: int = 0


@dataclass
class Config:
    trainer: str = "stage_inr"
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    arch: ArchConfig = field(default_factory=ArchConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)


def _merge_into(obj: Any, data: dict) -> Any:
    """Recursively set dict values onto a dataclass instance."""
    for k, v in (data or {}).items():
        if not hasattr(obj, k):
            setattr(obj, k, v)
            continue
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_into(cur, v)
        else:
            setattr(obj, k, v)
    return obj


def load_config(path: Optional[str] = None, overrides: Optional[list[str]] = None) -> Config:
    """Load YAML over the defaults; apply 'a.b.c=value' dot-list overrides
    (`src/utils/config.py:129-130`)."""
    cfg = Config()
    if path:
        with open(path) as f:
            _merge_into(cfg, yaml.safe_load(f))
    for item in overrides or []:
        key, _, raw = item.partition("=")
        val = yaml.safe_load(raw)
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], val)
    return cfg


def save_config(cfg: Config, path: str):
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
