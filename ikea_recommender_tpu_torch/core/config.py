"""Typed experiment configuration.

The port's own copy of the schema in ``ikea_recommender_tpu/core/config.py``:
the same dataclasses, defaults and YAML aliases, so one ``experiment.yaml``
loads into the same fields in both packages. The field comments there say
what each training knob does; many of those knobs reach code that later
slices of the port bring.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ExperimentConfig:
    """Experiment metadata (YAML section ``experiment``)."""

    exp_class: str = "default"
    exp_name: str = "experiment"
    desc: str = ""
    use_wandb: bool = False
    use_tensorboard: bool = False
    tensorboard_root: str = "tensorboard"
    seed: int = 118
    seed_torch: Optional[int] = None
    seed_python: Optional[int] = None
    save_pretrained_embeddings: bool = False


@dataclass
class DataConfig:
    """Data paths and vocabulary sizes (YAML section ``data``)."""

    train_path: str = ""
    val_path: str = ""
    test_path: str = ""
    # Input vocabulary size; the embedding table has num_items + 1 rows, the
    # extra row used for padding.
    num_items: int = 0
    # Output head size; defaults to num_items when 0.
    num_actions: int = 0
    input_tokenizer: Optional[str] = None
    output_tokenizer: Optional[str] = None
    market_tokenizer: Optional[str] = None
    session_col: str = "session_id"
    item_col: str = "item_id"

    def __post_init__(self) -> None:
        if self.num_actions == 0:
            self.num_actions = self.num_items


@dataclass
class TrainConfig:
    """Model + optimization hyperparameters (YAML section ``train``)."""

    model: str = "gru4rec"  # gru4rec | bidir_gru4rec | sqn | smorl | sarm
    batch_size: int = 256
    val_batch_size: int = 2000
    epochs: int = 30
    learning_rate: float = 0.01
    embedding_size: int = 64
    hidden_state_size: int = 64
    gru_layers: int = 1
    dropout: float = 0.0  # BidirGRU4Rec only
    gamma: float = 0.5
    alpha: float = 1.0
    q_weights: List[float] = field(default_factory=lambda: [1.0, 1.0, 1.0])
    state_size: int = 10
    padding_position: str = "end"  # "end" or "beg"
    padding_id: Optional[int] = None  # defaults to num_items
    train_padding_embed: bool = True
    # Length-masked recurrence (the reference's packed sequences); False
    # runs the GRU over pad tokens too.
    use_packed_seq: bool = True
    best_model_metric: str = "Val_NDCG@10"
    best_model_mode: str = "max"
    head_idx: int = 0
    eval_at: List[float] = field(default_factory=lambda: [0.25, 0.5, 0.75, 1.0])
    num_q_heads: int = 3  # SMORL; canonical 3-head (acc, div, nov)
    sarm_gamma: float = 0.99
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    scan_impl: str = "auto"  # the reference's recurrence choice; the port has one
    fused_ce: bool = True
    fused_ce_min_actions: Optional[int] = None
    head_precision: str = "high"  # "highest" | "high" | "default"
    optimizer: str = "adam"
    qhead_optimizer: Optional[str] = None
    optimizer_mv_dtype: Optional[str] = None
    double_q_optimizers: int = 2
    # Quirk-compatibility flags (reference behavior opt-in)
    compat_boot_len_bug: bool = False
    compat_div_len_bug: bool = False
    compat_first_layer_head: bool = False  # quirk 4: head reads layer 0
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    max_window_batches: int = 1024
    profile_dir: Optional[str] = None
    # Named numerics presets: "fast" | "reference". A preset only fills
    # fields still at their defaults.
    preset: Optional[str] = None

    def __post_init__(self) -> None:
        if self.preset is not None:
            if self.preset not in ("fast", "reference"):
                raise ValueError(
                    f"train.preset must be 'fast' or 'reference', got {self.preset!r}"
                )
            if self.head_precision == "high":
                self.head_precision = (
                    "default" if self.preset == "fast" else "highest"
                )
            if self.optimizer_mv_dtype is None and self.preset == "fast":
                self.optimizer_mv_dtype = "bfloat16"
            if self.qhead_optimizer is None and self.preset == "fast":
                self.qhead_optimizer = "lazy_adam"
                self.qhead_from_preset = True
        if self.head_precision not in ("highest", "high", "default"):
            raise ValueError(
                "train.head_precision must be one of highest/high/default, "
                f"got {self.head_precision!r}"
            )


@dataclass
class ParallelConfig:
    """Device-mesh scaling (YAML section ``parallel``): ``data`` x ``model``
    devices."""

    data: int = 1
    model: int = 1
    sharded_ce: bool = False
    process_sharded: Optional[bool] = None

    @property
    def num_devices(self) -> int:
        return self.data * self.model

    @property
    def enabled(self) -> bool:
        return self.num_devices > 1


@dataclass
class MetricsConfig:
    """Evaluation protocol parameters (YAML section ``metrics``)."""

    div_emb_dir: Optional[str] = None
    require_div_emb: bool = False
    unpopular_actions_path: Optional[str] = None
    topk_cov: List[int] = field(default_factory=lambda: [1, 5, 10, 20])
    topk_div: int = 1
    topk_hr_ndcg: List[int] = field(default_factory=lambda: [10, 20])
    topk_nov: int = 1
    nov_rew_sig: float = 1.0
    train_metrics: bool = True
    fused_eval: Optional[bool] = None
    eval_precision: Optional[str] = None
    action_type_names: Optional[List[str]] = None


@dataclass
class Config:
    """Top-level config: the reference YAML sections."""

    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # The config file's parent directory doubles as the experiment output dir.
    exp_dir: str = "."

    @property
    def padding_id(self) -> int:
        if self.train.padding_id is not None:
            return self.train.padding_id
        return self.data.num_items

    @property
    def seed(self) -> int:
        exp = self.experiment
        if exp.seed_torch is not None:
            return int(exp.seed_torch) * 1_000_003 + int(exp.seed_python or 0)
        return exp.seed


def _filter_kwargs(cls: type, raw: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in raw.items() if k in names}


# Keys the reference YAMLs use that map onto differently-named fields here.
_TRAIN_ALIASES = {
    "base_model": "model",
}


def config_from_dict(raw: Dict[str, Any], exp_dir: str = ".") -> Config:
    """Build a Config from a raw (reference-compatible) YAML dict."""
    exp_raw = dict(raw.get("experiment", {}))
    for key in ("exp_class", "exp_name"):
        if key in raw:
            exp_raw.setdefault(key, raw[key])
    data_raw = dict(raw.get("data", {}))
    train_raw = dict(raw.get("train", {}))
    for old, new in _TRAIN_ALIASES.items():
        if old in train_raw and new not in train_raw:
            val = train_raw.pop(old)
            train_raw[new] = {"GRU": "gru4rec"}.get(val, str(val).lower())
    metrics_raw = dict(raw.get("metrics", {}))
    if "eval_at" in metrics_raw and "eval_at" not in train_raw:
        train_raw["eval_at"] = metrics_raw["eval_at"]
    if "padding_pos" in train_raw and "padding_position" not in train_raw:
        train_raw["padding_position"] = train_raw.pop("padding_pos")
    actions_raw = raw.get("actions", {}) or {}
    names = actions_raw.get("action_types_names")
    if names and "action_type_names" not in metrics_raw:
        if isinstance(names, dict):
            names = [names[k] for k in sorted(names, key=int)]
        metrics_raw["action_type_names"] = list(names)
    par_raw = dict(raw.get("parallel", {}))
    if "mesh" in par_raw and isinstance(par_raw["mesh"], dict):
        par_raw.update(par_raw.pop("mesh"))
    return Config(
        experiment=ExperimentConfig(**_filter_kwargs(ExperimentConfig, exp_raw)),
        data=DataConfig(**_filter_kwargs(DataConfig, data_raw)),
        train=TrainConfig(**_filter_kwargs(TrainConfig, train_raw)),
        metrics=MetricsConfig(**_filter_kwargs(MetricsConfig, metrics_raw)),
        parallel=ParallelConfig(**_filter_kwargs(ParallelConfig, par_raw)),
        exp_dir=exp_dir,
    )


def load_experiment_config(yaml_path: str) -> Config:
    """Load a YAML experiment file (reference-compatible schema)."""
    import yaml  # PyYAML is needed only here

    with open(yaml_path, "r") as fh:
        raw = yaml.safe_load(fh) or {}
    exp_dir = os.path.dirname(os.path.abspath(yaml_path))
    return config_from_dict(raw, exp_dir=exp_dir)


def save_experiment_config(cfg: Config, yaml_path: str) -> None:
    """Write ``cfg``'s five sections (experiment, data, train, metrics,
    parallel) with every field, as the reference's
    ``save_experiment_config`` does; :func:`load_experiment_config` reads
    the file back to an equal ``Config`` whose ``exp_dir`` is the file's
    directory."""
    import yaml

    raw = {name: dataclasses.asdict(getattr(cfg, name))
           for name in ("experiment", "data", "train", "metrics", "parallel")}
    with open(yaml_path, "w") as fh:
        yaml.safe_dump(raw, fh, sort_keys=False)
