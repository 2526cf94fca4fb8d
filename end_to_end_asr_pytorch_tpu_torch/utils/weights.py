"""Weight bridge: arrays keyed by the JAX package's parameter-tree paths ->
the port's ASR / LM modules, which then compute the same functions.

Keys are the paths ``jax.tree_util.keystr`` prints for ``ASRParams`` /
``RNNLMParams`` leaves (``.encoder.layers[0].fwd.w_ih``); the port's module
attributes carry the same names (``encoder.layers.0.fwd.w_ih``). Matmul
weights keep the JAX (in, out) layout; only convolution kernels change
layout, to PyTorch's: VGG HWIO -> OIHW, CNN (k, in, out) -> (out, in, k),
the location conv (k, 1, F) -> (F, 1, k). The JAX plugin solver's tree
``{'asr': ASRParams, 'plugin': PluginParams}`` (``['asr'].encoder...``,
``['plugin'].w_proj``) splits into the ASR's arrays and the embedding
plugin's, whose ``w_proj`` (dec, emb) becomes ``nn.Linear``'s (emb, dec).
This module imports no JAX: the caller flattens the tree. ``jax_arrays``
goes the other way, from the port's modules to arrays at the JAX paths in
the JAX layout (what ``utils/orbax.py`` writes).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.asr import ASR
from ..models.lm import RNNLM


def port_name(path: str) -> str:
    """'.encoder.layers[0].fwd.w_ih' -> 'encoder.layers.0.fwd.w_ih';
    "['asr'].embed" -> 'asr.embed'."""
    path = re.sub(r"\['(\w+)'\]", r".\1", path)
    return re.sub(r"\[(\d+)\]", r".\1", path).lstrip(".")


def _to_port_layout(name: str, a: np.ndarray) -> np.ndarray:
    if re.search(r"(^|\.)prenet\.k\d$", name):
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.transpose(2, 1, 0)
    if re.search(r"(^|\.)loc_conv$", name):
        return a.transpose(2, 1, 0)
    return a


def _to_jax_layout(name: str, a: np.ndarray) -> np.ndarray:
    """The inverse of ``_to_port_layout``."""
    if re.search(r"(^|\.)prenet\.k\d$", name):
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.transpose(2, 1, 0)
    if re.search(r"(^|\.)loc_conv$", name):
        return a.transpose(2, 1, 0)
    return a


def jax_arrays(module: nn.Module, plugin: Optional[nn.Module] = None
               ) -> Dict[str, np.ndarray]:
    """{dotted JAX path: array in the JAX layout} of ``module`` (an ASR or
    an RNNLM), the inverse of ``load_arrays``; with ``plugin`` the JAX
    plugin solver's tree: the ASR under ``asr.``, the plugin's
    ``plugin.w_proj`` (dec, emb) and ``plugin.b_proj``."""
    out = {n: _to_jax_layout(n, t.detach().cpu().numpy())
           for n, t in module.state_dict().items()}
    if plugin is None:
        return out
    out = {f"asr.{n}": a for n, a in out.items()}
    out["plugin.w_proj"] = plugin.w_proj.detach().cpu().numpy().T
    out["plugin.b_proj"] = plugin.b_proj.detach().cpu().numpy()
    return out


def assign(module: nn.Module, arrays: Dict[str, np.ndarray],
           what: str) -> nn.Module:
    """Copy ``{port parameter name: array in the port's layout}`` into
    ``module``. Every parameter must be supplied with its shape, and no key
    may be left over."""
    sd = module.state_dict()
    missing = sorted(set(sd) - set(arrays))
    extra = sorted(set(arrays) - set(sd))
    if missing or extra:
        raise KeyError(f"{what}: missing {missing[:10]}, "
                       f"unexpected {extra[:10]}")
    with torch.no_grad():
        for name, t in sd.items():
            a = arrays[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{what}: {name} has shape {a.shape}, "
                                 f"the model expects {tuple(t.shape)}")
            t.copy_(torch.tensor(np.asarray(a), dtype=torch.float32))
    return module


def split_plugin(arrays: Dict[str, Any]):
    """{port name: array} of an ASR, or of the plugin solver's
    {'asr', 'plugin'} tree (names ``asr.*`` / ``plugin.*``) -> (the ASR's
    arrays, the plugin's arrays or None)."""
    if not any(k.startswith("asr.") for k in arrays):
        return arrays, None
    asr = {k[4:]: v for k, v in arrays.items() if k.startswith("asr.")}
    plugin = {k[7:]: v for k, v in arrays.items() if k.startswith("plugin.")}
    extra = sorted(set(arrays) - {f"asr.{k}" for k in asr}
                   - {f"plugin.{k}" for k in plugin})
    if extra:
        raise KeyError(f"weight bridge: unexpected {extra[:10]}")
    return asr, plugin


def load_plugin_arrays(plugin: nn.Module, arrays: Dict[str, Any]
                       ) -> nn.Module:
    """Copy the JAX ``PluginParams`` arrays {w_proj (dec, emb), b_proj}
    into the port's ``EmbeddingRegularizer``."""
    got = {k: np.asarray(v, dtype=np.float32) for k, v in arrays.items()}
    if "w_proj" in got:
        got["w_proj"] = got["w_proj"].T
    return assign(plugin, got, "weight bridge (plugin)")


def load_arrays(module: nn.Module, arrays: Dict[str, Any],
                plugin: Optional[nn.Module] = None) -> nn.Module:
    """Copy ``{jax_path: array}`` (JAX layout) into ``module``; a plugin
    solver's tree also fills ``plugin`` (its plugin part is skipped when
    ``plugin`` is None; a plugin without one in the tree raises)."""
    named = {port_name(k): v for k, v in arrays.items()}
    named, plug = split_plugin(named)
    if plugin is not None:
        if plug is None:
            raise KeyError("weight bridge: the checkpoint holds no plugin "
                           "parameters")
        load_plugin_arrays(plugin, plug)
    got = {name: _to_port_layout(name, np.asarray(v, dtype=np.float32))
           for name, v in named.items()}
    return assign(module, got, "weight bridge")


def asr_from_arrays(input_size: int, vocab_size: int, cfg: Dict[str, Any],
                    arrays: Dict[str, Any], device: Optional[str] = None) -> ASR:
    return load_arrays(ASR(input_size, vocab_size, cfg, device=device), arrays)


def lm_from_arrays(vocab_size: int, cfg: Dict[str, Any],
                   arrays: Dict[str, Any], device: Optional[str] = None
                   ) -> RNNLM:
    return load_arrays(RNNLM(vocab_size, cfg, device=device), arrays)
