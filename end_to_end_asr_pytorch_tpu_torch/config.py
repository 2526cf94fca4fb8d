"""YAML experiment config loading (same schema as the JAX package)."""
from __future__ import annotations

from typing import Any, Dict

import yaml

_TOP_LEVEL = ("data", "model", "hparas")

# framework defaults merged under every solver's hparas
default_hparas: Dict[str, Any] = {
    "GRAD_CLIP": 5.0,        # global-norm gradient clipping
    "PROGRESS_STEP": 100,    # console progress every N steps
    "DEV_N_EXAMPLE": 4,      # dev examples logged during validation
    "TB_FLUSH_FREQ": 180,    # seconds between TensorBoard flushes
}


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError("config root must be a mapping")
    for key in _TOP_LEVEL:
        if key not in cfg:
            raise ValueError(f"config missing required top-level block {key!r}")
    data = cfg["data"]
    for key in ("corpus", "text"):
        if key not in data:
            raise ValueError(f"config data block missing {key!r}")
    if "audio" not in data and "encoder" in cfg["model"]:
        raise ValueError("ASR config data block missing 'audio'")
    if data["text"].get("mode") not in ("character", "word", "subword"):
        raise ValueError(f"unknown text mode {data['text'].get('mode')!r}")
    return cfg


def merge_hparas(hparas: Dict[str, Any]) -> Dict[str, Any]:
    """An experiment's hparas merged over ``default_hparas``."""
    out = dict(default_hparas)
    out.update(hparas or {})
    return out
