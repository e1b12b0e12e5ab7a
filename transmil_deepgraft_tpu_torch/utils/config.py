"""Config system of the port (counterpart of ``utils/config.py``): YAML ->
attribute dict, the task from the file name, ``in_features`` per feature
extractor, and the log-path tree.

The YAML files are read with PyYAML's ``safe_load`` (PyYAML is installed
wherever the port runs), so the JAX package's configs parse to the same
trees. :class:`Config` is the addict-like attribute dict of the reference:
a missing key reads as an empty, falsy ``Config`` without being stored.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Mapping

import yaml


class Config(dict):
    """Attribute-accessible dict: nested mappings are wrapped on assignment,
    and ``cfg.Section.missing or default`` works as with ``addict.Dict``."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        for arg in args:
            if isinstance(arg, Mapping):
                for k, v in arg.items():
                    self[k] = v
            elif arg is not None:
                for k, v in arg:
                    self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __setitem__(self, key: Any, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):  # keep the pickle and copy protocols intact
            raise AttributeError(name)
        return self[name]

    def __missing__(self, key: Any) -> "Config":
        return Config()

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo: dict) -> "Config":
        out = Config()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    def to_dict(self) -> dict:
        def unwrap(v: Any) -> Any:
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return {k: unwrap(v) for k, v in self.items()}


def read_yaml(fpath: str | Path) -> Config:
    """Load a YAML config file into a :class:`Config`."""
    with open(fpath, "r") as f:
        return Config(yaml.safe_load(f))


# Feature-extractor name -> embedding dim (ref ``code/train.py:392-397``).
FEATURE_EXTRACTOR_DIMS: dict[str, int] = {
    "retccl": 2048,
    "histoencoder": 384,
    "ctranspath": 784,
    "resnet50": 1024,
}


# Class-index -> class-name maps per task (ref ``code/utils/utils.py:37-53``),
# for the result CSVs and figures.
LABEL_MAP: dict[str, dict[str, str]] = {
    "no_other": {"0": "Normal", "1": "TCMR", "2": "ABMR", "3": "Mixed", "4": "Viral"},
    "rejections": {"0": "TCMR", "1": "ABMR", "2": "Mixed"},
    "norm_rest": {"0": "Normal", "1": "Disease"},
    "rej_rest": {"0": "Rejection", "1": "Other"},
    "rest_rej": {"0": "Other", "1": "Rejection"},
    "norm_rej_rest": {"0": "Normal", "1": "Rejection", "2": "Other"},
    "big_three": {"0": "ccRCC", "1": "papRCC", "2": "chRCC"},
    "tcmr_abmr": {"0": "TCMR", "1": "ABMR"},
    "tcmr": {"0": "Other", "1": "TCMR"},
    "tcmr_viral": {"0": "TCMR", "1": "Viral"},
    # tasks only named in the reference's label_map.json (test_visualize.py:277)
    "no_viral": {"0": "Normal", "1": "TCMR", "2": "ABMR", "3": "Mixed"},
    "all": {"0": "Normal", "1": "TCMR", "2": "ABMR", "3": "Mixed", "4": "Viral", "5": "Other"},
    "camelyon16": {"0": "Normal", "1": "Tumor"},
}

# the figures' per-class / per-run colours
COLOR_MAP = [
    "#377eb8", "#ff7f00", "#4daf4a", "#f781bf", "#a65628", "#984ea3",
    "#999999", "#e41a1c", "#dede00",
]


def derive_task_from_config_path(config_path: str | Path) -> str:
    """Task from the file name: ``TransMIL_retccl_norm_rest.yaml`` ->
    ``norm_rest`` (stem parts from the third on, cut at the first ``-``)."""
    stem = Path(config_path).name
    if stem.endswith(".yaml") or stem.endswith(".yml"):
        stem = stem.rsplit(".", 1)[0]
    task = "_".join(stem.split("_")[2:])
    return task.split("-")[0]


def in_features_for_extractor(feature_extractor: str, default: int | None = None) -> int | None:
    """Embedding dim of a feature extractor, or ``default``."""
    return FEATURE_EXTRACTOR_DIMS.get(feature_extractor, default)


def check_home(cfg: Config, home: str | None = None) -> Config:
    """Re-root absolute ``General.log_path`` / ``Data.data_dir`` /
    ``Data.label_file`` whose first component is not ``home`` (default: the
    first component of the working directory) onto ``home``."""
    home = home or (Path(os.getcwd()).parts[1] if len(Path(os.getcwd()).parts) > 1 else "")
    if not home:
        return cfg

    def remap(x):
        p = Path(str(x))
        if p.is_absolute() and len(p.parts) > 2 and p.parts[1] != home:
            return "/" + str(Path(home).joinpath(*p.parts[2:]))
        return x

    if cfg.General.log_path:
        cfg.General.log_path = remap(cfg.General.log_path)
    if cfg.Data.data_dir:
        cfg.Data.data_dir = remap(cfg.Data.data_dir)
    if cfg.Data.label_file:
        cfg.Data.label_file = remap(cfg.Data.label_file)
    return cfg


def finalize_config(
    cfg: Config,
    *,
    config_path: str | Path | None = None,
    stage: str | None = None,
    fold: int | None = None,
    version: int | None = None,
    loss: str | None = None,
    epoch: str | int | None = None,
    fine_tune: bool = False,
    resume_training: bool = False,
    fast_dev_run: bool = False,
    label_file: str | None = None,
) -> Config:
    """The CLI's config surgery after parsing: the overrides, the task from
    the file name, ``in_features`` per extractor, and the log path
    ``{log_path}/{project}/{model}/{task}/_{backbone}_{loss}``."""
    if config_path is not None:
        cfg.config = str(config_path)
    if stage is not None:
        cfg.General.server = stage
    if fold is not None:
        cfg.Data.fold = fold
    if loss is not None:
        cfg.Loss.base_loss = loss
    if version is not None:
        cfg.version = version
    if label_file is not None:
        cfg.Data.label_file = label_file
    cfg.fine_tune = fine_tune
    cfg.resume_training = resume_training
    cfg.fast_dev_run = fast_dev_run
    cfg.epoch = epoch

    if cfg.config:
        cfg.task = derive_task_from_config_path(cfg.config)
        log_name = f"_{cfg.Model.backbone}_{cfg.Loss.base_loss}"
        project_dir = Path(cfg.config).parent.name or "project"
        cfg.log_name = log_name
        cfg.log_path = str(
            Path(cfg.General.log_path or "logs")
            / project_dir
            / str(cfg.Model.name)
            / str(cfg.task)
            / log_name
        )

    fe = cfg.Data.feature_extractor
    if fe:
        dim = in_features_for_extractor(str(fe))
        if dim is not None:
            cfg.Model.in_features = dim
    return cfg
