"""Reference-layout checkpoints (``torch.save``): load an ASR or an RNN-LM
one into the port's modules, and save the port's models as one.

Same key rules as the JAX package's ``translate_asr_state_dict``: keys are
resolved by suffix with alias lists per slot, recurrent modules are found by
torch's parameter-name pattern (``weight_ih_l{n}[_reverse]``) in state_dict
order, every tensor is shape-checked, and unmatched slots raise with the
candidate keys listed. Layouts: nn.Linear (out, in) -> (in, out); LSTM
gates stay (i, f, g, o) with ``b = bias_ih + bias_hh``; GRU biases stay
separate; convolution weights are already in PyTorch's layout, which the
port keeps. The RNN-LM follows the JAX package's ``translate_lm_state_dict``:
the embedding (``emb`` / ``embed`` / ``embedding``), its recurrent layers in
state_dict order, and the output layer (``trans`` / ``out`` / ``proj`` /
``output_layer``), whose weight is absent under ``emb_tying``.

The save side writes the reference layout ``{"model": state_dict,
"optimizer": ..., "global_step": int, "<metric>": float}`` with torch
``nn.Module`` key names (``asr_state_dict`` for an ASR, ``lm_state_dict``
for an RNN-LM: ``emb``, ``rnn.*_l{n}``, ``trans``), which both this loader
and the JAX package's ``utils/checkpoint.load_checkpoint`` read. The
optimizer entry is the port's own ``Optimizer.state_dict()``.
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.asr import ASR
from ..models.lm import RNNLM
from .weights import assign


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


class KeyResolver:
    """Suffix-alias key lookup over a flat state_dict with consumption
    tracking."""

    def __init__(self, sd: Dict[str, Any]):
        self.sd = OrderedDict(
            (k[7:] if k.startswith("module.") else k, v) for k, v in sd.items())
        self.used: set = set()

    def find(self, suffixes: List[str], shape=None, scope: str = "",
             required: bool = True, numel=None) -> Optional[np.ndarray]:
        for suf in suffixes:
            for k, v in self.sd.items():
                if k in self.used or not k.startswith(scope):
                    continue
                if not (k == suf or k.endswith("." + suf)):
                    continue
                a = _np(v)
                if shape is not None and tuple(a.shape) != tuple(shape):
                    continue
                if numel is not None and a.size != numel:
                    continue
                self.used.add(k)
                return a
        if required:
            cands = [k for k in self.sd if k.startswith(scope)
                     and k not in self.used]
            raise KeyError(
                f"torch checkpoint: no key matching {suffixes} "
                f"(scope={scope!r}, shape={shape}); unconsumed keys under "
                f"scope: {cands[:20]}")
        return None

    def rnn_groups(self, scope: str = "") -> List[Dict[str, np.ndarray]]:
        """One dict per (module, layer) in state_dict order with keys like
        'weight_ih', 'bias_hh', 'weight_ih_reverse'."""
        groups: "OrderedDict[tuple, Dict[str, np.ndarray]]" = OrderedDict()
        pat = re.compile(r"(weight|bias)_(ih|hh)(?:_l(\d+))?(_reverse)?$")
        for k, v in self.sd.items():
            if k in self.used or not k.startswith(scope):
                continue
            m = pat.search(k)
            if not m or (m.start() > 0 and k[m.start() - 1] != "."):
                continue
            prefix = k[:m.start()].rstrip(".")
            layer = int(m.group(3)) if m.group(3) is not None else 0
            name = f"{m.group(1)}_{m.group(2)}" + (m.group(4) or "")
            groups.setdefault((prefix, layer), {})[name] = _np(v)
            self.used.add(k)
        return list(groups.values())


def _cell(out: Dict[str, np.ndarray], prefix: str, module: str,
          g: Dict[str, np.ndarray], reverse: bool = False) -> None:
    s = "_reverse" if reverse else ""
    out[f"{prefix}.w_ih"] = g[f"weight_ih{s}"].T
    out[f"{prefix}.w_hh"] = g[f"weight_hh{s}"].T
    if module == "lstm":
        out[f"{prefix}.b"] = g[f"bias_ih{s}"] + g.get(f"bias_hh{s}", 0.0)
    else:
        out[f"{prefix}.b_ih"] = g[f"bias_ih{s}"]
        out[f"{prefix}.b_hh"] = g.get(f"bias_hh{s}",
                                      np.zeros_like(g[f"bias_ih{s}"]))


def translate_asr_state_dict(sd: Dict[str, Any], model: ASR
                             ) -> Dict[str, np.ndarray]:
    """Reference ASR state_dict -> {port parameter name: array} for
    ``model``'s configuration."""
    res = KeyResolver(sd)
    params = dict(model.state_dict())
    shape = lambda name: tuple(params[name].shape)
    out: Dict[str, np.ndarray] = {}

    enc = model.encoder
    if enc.prenet is not None:   # resolve before rnn_groups claims keys
        n_conv = 4 if hasattr(enc.prenet, "k4") else 2
        kind = "vgg" if n_conv == 4 else "cnn"
        for i in range(1, n_conv + 1):
            out[f"encoder.prenet.k{i}"] = res.find(
                [f"conv{i}.weight", f"{kind}_conv{i}.weight"], scope="encoder")
            out[f"encoder.prenet.b{i}"] = res.find(
                [f"conv{i}.bias", f"{kind}_conv{i}.bias"], scope="encoder")

    groups = res.rnn_groups(scope="encoder")
    if len(groups) != len(enc.layers):
        raise ValueError(f"torch checkpoint: found {len(groups)} recurrent "
                         f"modules under 'encoder', model has "
                         f"{len(enc.layers)} layers")
    for li, (layer, g) in enumerate(zip(enc.layers, groups)):
        p = f"encoder.layers.{li}"
        _cell(out, f"{p}.fwd", layer.module, g)
        if layer.bwd is not None:
            if "weight_ih_reverse" not in g:
                raise ValueError(f"torch checkpoint: encoder layer {li} is "
                                 "bidirectional in the model but the "
                                 "checkpoint has no _reverse weights")
            _cell(out, f"{p}.bwd", layer.module, g, reverse=True)
        if layer.ln_scale is not None:
            out[f"{p}.ln_scale"] = res.find(
                ["ln.weight", "layer_norm.weight", "norm.weight"],
                shape=shape(f"{p}.ln_scale"), scope="encoder")
            out[f"{p}.ln_bias"] = res.find(
                ["ln.bias", "layer_norm.bias", "norm.bias"],
                shape=shape(f"{p}.ln_bias"), scope="encoder")
        if layer.w_proj is not None:
            out[f"{p}.w_proj"] = res.find(
                ["pj.weight", "proj.weight", "linear.weight"],
                shape=shape(f"{p}.w_proj")[::-1], scope="encoder").T
            out[f"{p}.b_proj"] = res.find(
                ["pj.bias", "proj.bias", "linear.bias"],
                shape=shape(f"{p}.b_proj"), scope="encoder")

    if model.ctc_w is not None:
        out["ctc_w"] = res.find(["ctc_layer.weight", "ctc_out.weight",
                                 "ctc.weight"], shape=shape("ctc_w")[::-1]).T
        out["ctc_b"] = res.find(["ctc_layer.bias", "ctc_out.bias", "ctc.bias"],
                                shape=shape("ctc_b"))

    if model.embed is not None:
        out["embed"] = res.find(["pre_embed.weight", "embed.weight",
                                 "embedding.weight"], shape=shape("embed"))
        _attention(res, model, shape, out)
        dec_groups = res.rnn_groups(scope="decoder") or res.rnn_groups()
        if len(dec_groups) != len(model.decoder.cells):
            raise ValueError(
                f"torch checkpoint: found {len(dec_groups)} recurrent modules "
                f"for the decoder, model has {len(model.decoder.cells)}")
        for ci, g in enumerate(dec_groups):
            _cell(out, f"decoder.cells.{ci}", model.decoder.module, g)
        out["char_w"] = res.find(["char_trans.weight", "char_out.weight",
                                  "output_layer.weight"],
                                 shape=shape("char_w")[::-1]).T
        out["char_b"] = res.find(["char_trans.bias", "char_out.bias",
                                  "output_layer.bias"], shape=shape("char_b"))
    return out


def _attention(res: KeyResolver, model: ASR, shape, out) -> None:
    att = model.attention
    # prefer an explicit (possibly nested) attention module scope so the
    # bare 'bias' suffix cannot bind an unrelated module's bias
    sc = ""
    for k in res.sd:
        i = k.find("attention.")
        if i == 0 or (i > 0 and k[i - 1] == "."):
            sc = k[:i + len("attention.")]
            break
    lin = lambda sufs, name: res.find(sufs, shape=shape(name)[::-1], scope=sc).T
    out["attention.w_q"] = lin(["proj_q.weight", "query_proj.weight",
                                "q_proj.weight"], "attention.w_q")
    out["attention.w_k"] = lin(["proj_k.weight", "key_proj.weight",
                                "k_proj.weight"], "attention.w_k")
    if att.w_v is not None:
        out["attention.w_v"] = lin(["proj_v.weight", "value_proj.weight",
                                    "v_proj.weight"], "attention.w_v")
    if att.w_merge is not None:
        out["attention.w_merge"] = lin(["merge_head.weight", "merge.weight",
                                        "out_proj.weight"], "attention.w_merge")
    if att.loc_conv is not None:
        nf, in_ch, k = shape("attention.loc_conv")
        w = res.find(["loc_conv.weight", "location_conv.weight"],
                     numel=k * in_ch * nf, scope=sc)
        if w.shape != (nf, in_ch, k):
            raise ValueError(f"torch checkpoint: loc_conv shape {w.shape} does "
                             f"not match the single-channel convention "
                             f"({nf}, {in_ch}, {k})")
        out["attention.loc_conv"] = w
        out["attention.w_f"] = lin(["loc_proj.weight", "loc_linear.weight"],
                                   "attention.w_f")
        bias_sufs = (["att_bias", "loc_bias", "bias"] if sc
                     else ["att_bias", "loc_bias"])
        out["attention.bias"] = res.find(bias_sufs, shape=shape("attention.bias"),
                                         scope=sc)
        v_shape = shape("attention.v_energy")
        out["attention.v_energy"] = res.find(
            ["gen_energy.weight", "v_energy.weight", "energy.weight"],
            numel=int(np.prod(v_shape)), scope=sc).reshape(v_shape)


def load_asr_state_dict(sd: Dict[str, Any], model: ASR) -> ASR:
    """Fill ``model`` in place from a reference ASR state_dict."""
    return assign(model, translate_asr_state_dict(sd, model),
                  "torch checkpoint")


def load_plugin_state_dict(sd: Dict[str, Any], plugin) -> None:
    """Fill the embedding plugin's projection from a state_dict by suffix
    (``latent_transform`` / ``emb_proj`` (the reference's) / ``plugin``;
    nn.Linear's (emb, dec) layout, the port's own); where it has none, the
    plugin keeps its initial values, as the JAX loader does."""
    res = KeyResolver(sd)
    w = res.find(["latent_transform.weight", "emb_proj.weight",
                  "plugin.w_proj"], shape=tuple(plugin.w_proj.shape),
                 required=False)
    if w is not None:
        b = res.find(["latent_transform.bias", "emb_proj.bias",
                      "plugin.b_proj"], shape=tuple(plugin.b_proj.shape))
        assign(plugin, {"w_proj": w, "b_proj": b}, "torch checkpoint (plugin)")


def load_torch_checkpoint(path: str, model: ASR,
                          plugin=None) -> Dict[str, Any]:
    """torch.load a reference checkpoint ({'model': state_dict, ...} or a
    bare state_dict) into ``model`` (and an embedding ``plugin``). Returns
    {'model', 'optimizer' (the saved optimizer state, or None),
    'global_step'}."""
    sd, step, opt = _read(path)
    load_asr_state_dict(sd, model)
    if plugin is not None:
        load_plugin_state_dict(sd, plugin)
    return {"model": model, "optimizer": opt, "global_step": step}


def translate_lm_state_dict(sd: Dict[str, Any], lm: RNNLM
                            ) -> Dict[str, np.ndarray]:
    """Reference RNN-LM state_dict -> {port parameter name: array} for
    ``lm``'s configuration."""
    res = KeyResolver(sd)
    shape = lambda name: tuple(lm.state_dict()[name].shape)
    out = {"embed": res.find(["emb.weight", "embed.weight", "embedding.weight"],
                             shape=shape("embed"))}
    groups = res.rnn_groups()
    if len(groups) != len(lm.cells):
        raise ValueError(f"torch checkpoint: found {len(groups)} recurrent "
                         f"layers, LM has {len(lm.cells)}")
    for ci, g in enumerate(groups):
        _cell(out, f"cells.{ci}", lm.module, g)
    if lm.out_w is not None:                       # no emb_tying
        out["out_w"] = res.find(["trans.weight", "out.weight", "proj.weight",
                                 "output_layer.weight"],
                                shape=shape("out_w")[::-1]).T
    out["out_b"] = res.find(["trans.bias", "out.bias", "proj.bias",
                             "output_layer.bias"], shape=shape("out_b"))
    return out


def _read(path: str):
    """(state_dict, global_step, optimizer state or None) of a torch
    checkpoint: ``{'model': state_dict, ...}`` or a bare state_dict."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ck, dict) and "model" in ck:
        opt = ck.get("optimizer")
        return (ck["model"], int(ck.get("global_step", 0)),
                opt if isinstance(opt, dict) else None)
    return ck, 0, None


def load_lm_checkpoint(path: str, lm: RNNLM) -> Dict[str, Any]:
    """torch.load a reference RNN-LM checkpoint into ``lm``. Returns
    {'model', 'optimizer' (the saved optimizer state, or None),
    'global_step'}."""
    sd, step, opt = _read(path)
    return {"model": assign(lm, translate_lm_state_dict(sd, lm),
                            "torch LM checkpoint"), "optimizer": opt,
            "global_step": step}


def lm_state_dict(lm: RNNLM) -> "OrderedDict[str, torch.Tensor]":
    """The port's RNN-LM -> a reference-layout ``state_dict`` (``emb``,
    ``rnn.weight_ih_l{n}`` ..., ``trans``), on the CPU."""
    t = lambda x: x.detach().cpu().clone()
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["emb.weight"] = t(lm.embed)
    for ci, cell in enumerate(lm.cells):
        _rnn_entries(sd, "rnn", cell, f"_l{ci}")
    if lm.out_w is not None:
        sd["trans.weight"] = t(lm.out_w.T)
    sd["trans.bias"] = t(lm.out_b)
    return sd


def _rnn_entries(sd, prefix: str, cell, suffix: str) -> None:
    """One recurrent cell as torch's nn.LSTM / nn.GRU parameters (an LSTM's
    bias in ``bias_ih`` with a zero ``bias_hh``)."""
    t = lambda x: x.detach().cpu().clone()
    sd[f"{prefix}.weight_ih{suffix}"] = t(cell.w_ih.T)
    sd[f"{prefix}.weight_hh{suffix}"] = t(cell.w_hh.T)
    if hasattr(cell, "b"):
        sd[f"{prefix}.bias_ih{suffix}"] = t(cell.b)
        sd[f"{prefix}.bias_hh{suffix}"] = torch.zeros_like(t(cell.b))
    else:
        sd[f"{prefix}.bias_ih{suffix}"] = t(cell.b_ih)
        sd[f"{prefix}.bias_hh{suffix}"] = t(cell.b_hh)


def asr_state_dict(model: ASR) -> "OrderedDict[str, torch.Tensor]":
    """The port's ASR -> a reference-layout ``state_dict`` (nn.Linear
    weights (out, in), LSTM ``weight_ih_l{n}[_reverse]`` with the bias in
    ``bias_ih`` and a zero ``bias_hh``), on the CPU."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    t = lambda x: x.detach().cpu().clone()
    rnn = lambda prefix, cell, suffix: _rnn_entries(sd, prefix, cell, suffix)

    enc = model.encoder
    pre = enc.prenet
    if pre is not None:
        li0 = 1
        for i in range(1, 5 if hasattr(pre, "k4") else 3):
            sd[f"encoder.layers.0.conv{i}.weight"] = t(getattr(pre, f"k{i}"))
            sd[f"encoder.layers.0.conv{i}.bias"] = t(getattr(pre, f"b{i}"))
    else:
        li0 = 0
    for li, layer in enumerate(enc.layers):
        p = f"encoder.layers.{li + li0}"
        rnn(f"{p}.layer", layer.fwd, "_l0")
        if layer.bwd is not None:
            rnn(f"{p}.layer", layer.bwd, "_l0_reverse")
        if layer.ln_scale is not None:
            sd[f"{p}.ln.weight"] = t(layer.ln_scale)
            sd[f"{p}.ln.bias"] = t(layer.ln_bias)
        if layer.w_proj is not None:
            sd[f"{p}.pj.weight"] = t(layer.w_proj.T)
            sd[f"{p}.pj.bias"] = t(layer.b_proj)
    if model.ctc_w is not None:
        sd["ctc_layer.weight"] = t(model.ctc_w.T)
        sd["ctc_layer.bias"] = t(model.ctc_b)
    if model.embed is not None:
        sd["pre_embed.weight"] = t(model.embed)
        a = model.attention
        sd["attention.proj_q.weight"] = t(a.w_q.T)
        sd["attention.proj_k.weight"] = t(a.w_k.T)
        if a.w_v is not None:
            sd["attention.proj_v.weight"] = t(a.w_v.T)
        if a.w_merge is not None:
            sd["attention.merge_head.weight"] = t(a.w_merge.T)
        if a.loc_conv is not None:
            sd["attention.loc_conv.weight"] = t(a.loc_conv)
            sd["attention.loc_proj.weight"] = t(a.w_f.T)
            sd["attention.bias"] = t(a.bias)
            sd["attention.gen_energy.weight"] = t(a.v_energy)
        for ci, cell in enumerate(model.decoder.cells):
            rnn("decoder.layers", cell, f"_l{ci}")
        sd["char_trans.weight"] = t(model.char_w.T)
        sd["char_trans.bias"] = t(model.char_b)
    return sd


def save_checkpoint(path, model, optimizer=None, global_step: int = 0,
                    metrics: Optional[Dict[str, float]] = None,
                    plugin=None) -> None:
    """Write ``model`` (an ASR or an RNNLM) to ``path`` in the reference
    layout (see the module docstring), an ASR's embedding ``plugin`` as
    ``plugin.w_proj`` (emb, dec) / ``plugin.b_proj``, through a temporary
    file renamed into place."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    sd = lm_state_dict(model) if isinstance(model, RNNLM) else \
        asr_state_dict(model)
    if plugin is not None:
        sd["plugin.w_proj"] = plugin.w_proj.detach().cpu().clone()
        sd["plugin.b_proj"] = plugin.b_proj.detach().cpu().clone()
    ck: Dict[str, Any] = {"model": sd, "global_step": int(global_step)}
    if optimizer is not None:
        ck["optimizer"] = _to_cpu(optimizer.state_dict())
    for k, v in (metrics or {}).items():
        ck[k] = float(v)
    tmp = path.with_suffix(path.suffix + f".{os.getpid()}.tmp")
    torch.save(ck, str(tmp))
    os.replace(tmp, path)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj
