"""SpecAugment (Park et al. 2019): time and frequency masking of features,
the port of the JAX package's ``ops/augment.py`` ``spec_augment``.

Opt-in under ``data.audio.augment``; the training step applies it to the
front end's features before the amp cast and the encoder, never in
validation or decoding. The JAX function draws and masks in one; here the
two are apart, so a test can feed the JAX draws to the masking:

  * ``draw_masks`` draws each utterance's (start, width) per mask from an
    explicit ``torch.Generator`` on the features' device, with the JAX
    draws' bounds;
  * ``apply_masks`` sets every masked bin to 0.0 (the CMVN'd features'
    mean) with a ``where``, as the JAX function does.

Config keys (all optional), with the JAX package's defaults:
  augment:
    freq_mask_n: 2        # number of frequency masks
    freq_mask_width: 27   # max width per mask (F bins), at most F
    time_mask_n: 2        # number of time masks
    time_mask_width: 40   # max width per mask (frames)
    time_mask_ratio: 0.2  # cap: each time mask <= ratio * length // n
The JAX package masks with plain ``jnp`` and no Pallas kernel; so does the
port, with plain PyTorch.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..parallel import mesh


class Masks(NamedTuple):
    freq_start: torch.Tensor   # (B, freq_mask_n) int64
    freq_width: torch.Tensor   # (B, freq_mask_n) int64
    time_start: torch.Tensor   # (B, time_mask_n) int64
    time_width: torch.Tensor   # (B, time_mask_n) int64


def mask_params(cfg: Dict[str, Any], F: int):
    """(fn, fw, tn, tw, ratio) of an ``augment`` block for F bins."""
    return (int(cfg.get("freq_mask_n", 2)),
            int(cfg.get("freq_mask_width", min(27, F))),
            int(cfg.get("time_mask_n", 2)),
            int(cfg.get("time_mask_width", 40)),
            float(cfg.get("time_mask_ratio", 0.2)))


def max_time_width(feat_len: torch.Tensor, ratio: float, tn: int
                   ) -> torch.Tensor:
    """Each time mask's cap per utterance: floor(ratio * len) // tn, the
    product taken in f32 as the JAX package takes it."""
    prod = (torch.tensor(ratio, dtype=torch.float32, device=feat_len.device)
            * feat_len.to(torch.float32))
    return torch.clamp(prod.to(torch.int64) // max(tn, 1), min=0)


def _below(limit: torch.Tensor, generator) -> torch.Tensor:
    """One uniform integer in [0, limit) per entry of ``limit`` (>= 1), a
    row per utterance."""
    u = mesh.rand(limit.shape, generator, limit.device, torch.float64)
    return torch.minimum((u * limit).to(torch.int64), limit - 1)


def draw_masks(feat_len: torch.Tensor, F: int, cfg: Dict[str, Any],
               generator: torch.Generator) -> Masks:
    """Per-utterance mask positions for features (B, T, F) of lengths
    ``feat_len`` (B,): a frequency mask's width is uniform in [0, fw] and its
    start in [0, max(F - width, 1)); a time mask's width is
    min(uniform [0, tw], max_time_width) and its start in
    [0, max(len - width, 1)). Every draw is taken at the global batch's
    shape (``parallel/mesh.py``)."""
    fn, fw, tn, tw, ratio = mask_params(cfg, F)
    B = feat_len.shape[0]
    dev = feat_len.device
    f_width = mesh.randint(fw + 1, (B, fn), generator, dev)
    f_start = _below(torch.clamp(F - f_width, min=1), generator)
    t_width = torch.minimum(mesh.randint(tw + 1, (B, tn), generator, dev),
                            max_time_width(feat_len, ratio, tn)[:, None])
    t_start = _below(torch.clamp(feat_len.to(torch.int64)[:, None] - t_width,
                                 min=1), generator)
    return Masks(f_start, f_width, t_start, t_width)


def apply_masks(feat: torch.Tensor, masks: Masks) -> torch.Tensor:
    """feat (B, T, F) with every masked bin set to 0.0."""
    B, T, F = feat.shape
    f_ids = torch.arange(F, device=feat.device)[None, None, :]
    t_ids = torch.arange(T, device=feat.device)[None, None, :]

    def hit(ids, start, width):       # (B, n) -> (B, L): any mask covers
        m = (ids >= start[..., None]) & (ids < (start + width)[..., None])
        return m.any(dim=1)

    drop = (hit(f_ids, masks.freq_start, masks.freq_width)[:, None, :]
            | hit(t_ids, masks.time_start, masks.time_width)[:, :, None])
    return torch.where(drop, torch.zeros((), dtype=feat.dtype,
                                         device=feat.device), feat)

