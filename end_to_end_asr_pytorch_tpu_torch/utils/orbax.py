"""``ckpt_format: orbax``: checkpoint directories in the JAX package's orbax
layout, written and read with neither JAX nor orbax.

A checkpoint ``<path>/`` holds what the JAX package's
``utils/checkpoint.py`` writes there:
- ``model/``: the parameters at the JAX parameter-tree paths, in the JAX
  layout (``utils/weights.jax_arrays``), as an orbax ``StandardCheckpointer``
  item in its non-OCDBT layout: ``_METADATA`` (JSON: ``use_ocdbt: false``
  and a ``tree_metadata`` entry a leaf, the JAX tree's ``None`` leaves
  too), ``_CHECKPOINT_METADATA``, and one zarr v2 directory a leaf, named
  by its dotted key path, whose ``.zarray`` names no compressor and whose
  one chunk (``0.0`` for a matrix, ``0`` for a scalar) holds the raw
  C-order bytes. The JAX package's ``load_checkpoint`` restores it into
  its template.
- ``port_optimizer/``: the port's own optimizer state
  (``Optimizer.state_dict``: ``count`` and ``slots.<parameter>.<slot>``;
  the optimizer's name in ``_CHECKPOINT_METADATA``'s custom metadata), in
  the same layout. It is not ``optimizer/``, which the JAX package
  restores into an optax template: that package resumes the model and the
  step from such a directory, and starts its optimizer afresh.
- ``meta.json``: ``global_step`` and ``metrics``, written last, so a
  directory that holds it is complete.

``save_orbax`` writes to a ``.tmp`` sibling, renames an existing directory
aside to ``.old``, promotes the ``.tmp`` and removes the ``.old``; after a
preemption in any of those windows ``recover_sibling`` promotes the
complete sibling back (the JAX package's ``_recover_orbax_sibling``).

``read_orbax`` reads this layout only. The directories the JAX package
writes are OCDBT (``manifest.ocdbt``), every file zstd-compressed; they,
and any leaf whose ``.zarray`` names a compressor, raise
``NotImplementedError``.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models.lm import RNNLM
from .weights import jax_arrays

Keys = Tuple[str, ...]

# The JAX package's parameter NamedTuples, by the dotted path of a
# container ("*" an index): the fields a configuration may leave None.
_ASR_FIELDS = {
    "": ("encoder", "ctc_w", "ctc_b", "embed", "attention", "decoder",
         "char_w", "char_b"),
    "encoder": ("prenet", "layers"),
    "encoder.layers.*": ("fwd", "bwd", "ln_scale", "ln_bias", "w_proj",
                         "b_proj"),
    "attention": ("w_q", "w_k", "w_v", "w_merge", "loc_conv", "w_f", "bias",
                  "v_energy"),
}
_LM_FIELDS = {"": ("embed", "cells", "out_w", "out_b")}


def none_leaves(names: Iterable[str], fields: Dict[str, Tuple[str, ...]]
                ) -> list:
    """The dotted paths of the JAX tree's None leaves, given the paths of
    its arrays (``names``) and its containers' fields (``fields``): each
    field of a container that holds an array and under which no array
    lies."""
    names = list(names)
    out = []
    for pattern, flds in fields.items():
        parts = pattern.split(".") if pattern else []
        prefixes = {".".join(n.split(".")[:len(parts)]) for n in names
                    if len(n.split(".")) > len(parts)
                    and all(p in ("*", q) for p, q in
                            zip(parts, n.split(".")))}
        for pre in sorted(prefixes):
            for f in flds:
                path = f"{pre}.{f}" if pre else f
                if not any(n == path or n.startswith(path + ".")
                           for n in names):
                    out.append(path)
    return out


def _key_metadata(keys: Keys) -> list:
    return [{"key": k, "key_type": 1 if k.isdigit() else 2} for k in keys]


def write_item(d: Path, leaves: Dict[Keys, Optional[np.ndarray]],
               custom_metadata: Optional[Dict[str, Any]] = None) -> None:
    """One orbax ``StandardCheckpointer`` item at ``d`` in the non-OCDBT,
    uncompressed layout; a None leaf is recorded in the metadata only."""
    d.mkdir(parents=True)
    tree = {}
    for keys, a in leaves.items():
        if a is None:
            tree[str(keys)] = {"key_metadata": _key_metadata(keys),
                               "value_metadata": {"value_type": "None",
                                                  "skip_deserialize": True}}
            continue
        a = np.ascontiguousarray(a)
        leaf = d / ".".join(keys)
        leaf.mkdir()
        (leaf / ".zarray").write_text(json.dumps({
            "chunks": list(a.shape), "compressor": None,
            "dimension_separator": ".", "dtype": a.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(a.shape), "zarr_format": 2}))
        (leaf / (".".join("0" * a.ndim) or "0")).write_bytes(a.tobytes())
        tree[str(keys)] = {"key_metadata": _key_metadata(keys),
                           "value_metadata": {"value_type": "jax.Array",
                                              "skip_deserialize": False,
                                              "write_shape": list(a.shape)}}
    (d / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree, "use_ocdbt": False, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    now = time.time_ns()
    (d / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": "orbax.checkpoint._src.handlers."
                         "standard_checkpoint_handler."
                         "StandardCheckpointHandler",
        "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
        "custom_metadata": custom_metadata or {}}))


def _written_by_jax(d: Path, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{d}: {why}, as the JAX package writes its orbax directories "
        "(OCDBT, zstd-compressed); the port reads only the uncompressed, "
        "non-OCDBT layout it writes itself (ckpt_format: orbax in the port)")


def read_item(d: Path) -> Tuple[Dict[Keys, np.ndarray], Dict[str, Any]]:
    """({key path: array}, the custom metadata) of an item ``write_item``
    wrote."""
    meta = json.loads((d / "_METADATA").read_text())
    if meta.get("use_ocdbt", True) or (d / "manifest.ocdbt").exists():
        raise _written_by_jax(d, "an OCDBT directory")
    out = {}
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"]["value_type"] == "None":
            continue
        keys = tuple(k["key"] for k in entry["key_metadata"])
        leaf = d / ".".join(keys)
        z = json.loads((leaf / ".zarray").read_text())
        if z.get("compressor") is not None or z.get("filters"):
            raise _written_by_jax(
                leaf, f"a leaf compressed with {z['compressor'].get('id')}"
                if z.get("compressor") else "a filtered leaf")
        if z["chunks"] != z["shape"] or z.get("order", "C") != "C":
            raise NotImplementedError(
                f"{leaf}: {z['chunks']} chunks of a {z['shape']} array; "
                "the port reads one C-order chunk a leaf")
        dtype = np.dtype(z["dtype"])
        data = (leaf / (".".join("0" * len(z["shape"])) or "0")).read_bytes()
        if len(data) != dtype.itemsize * int(np.prod(z["shape"])):
            raise ValueError(f"{leaf}: {len(data)} bytes for shape "
                             f"{z['shape']} of {dtype}")
        out[keys] = np.frombuffer(data, dtype).reshape(z["shape"]).copy()
    custom = json.loads((d / "_CHECKPOINT_METADATA").read_text())
    return out, custom.get("custom_metadata") or {}


def model_leaves(model, plugin=None) -> Dict[Keys, Optional[np.ndarray]]:
    """The JAX tree of ``model`` (and ``plugin``): {key path: array, or
    None for the JAX tree's None leaves}."""
    arrays = jax_arrays(model, plugin)
    prefix = "asr." if plugin is not None else ""
    own = [n[len(prefix):] for n in arrays if n.startswith(prefix)]
    fields = _LM_FIELDS if isinstance(model, RNNLM) else _ASR_FIELDS
    leaves: Dict[Keys, Optional[np.ndarray]] = {
        tuple(n.split(".")): a for n, a in arrays.items()}
    for n in none_leaves(own, fields):
        leaves[tuple((prefix + n).split("."))] = None
    return leaves


def save_orbax(path, model, optimizer=None, global_step: int = 0,
               metrics: Optional[Dict[str, float]] = None,
               plugin=None) -> None:
    """Write ``model`` (an ASR or an RNNLM; an ASR's embedding ``plugin``
    in the plugin solver's tree), the port's ``optimizer`` state, the step
    and ``metrics`` as the orbax directory ``path`` (module docstring)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    old = path.with_suffix(path.suffix + ".old")
    shutil.rmtree(tmp, ignore_errors=True)
    write_item(tmp / "model", model_leaves(model, plugin))
    if optimizer is not None:
        sd = optimizer.state_dict()
        leaves = {("count",): sd["count"].detach().cpu().numpy()}
        for name, slots in sd["slots"].items():
            for slot, t in slots.items():
                leaves[("slots", name, slot)] = t.detach().cpu().numpy()
        write_item(tmp / "port_optimizer", leaves,
                   {"optimizer": sd["optimizer"]})
    (tmp / "meta.json").write_text(json.dumps(
        {"global_step": int(global_step),
         "metrics": {k: float(v) for k, v in (metrics or {}).items()}}))
    if path.is_dir():
        shutil.rmtree(old, ignore_errors=True)   # a stale .old of a crash
        path.rename(old)                         # a complete one stays
    elif path.exists():                          # a torch file before
        path.unlink()
    tmp.replace(path)
    shutil.rmtree(old, ignore_errors=True)


def recover_sibling(p: Path) -> Path:
    """Nothing at ``p``: a preemption may have struck ``save_orbax``
    between renaming the old directory aside and promoting the new one.
    Promote the complete sibling (one with ``meta.json``): ``.tmp``, the
    newer, before ``.old``."""
    for suffix in (".tmp", ".old"):
        cand = p.with_suffix(p.suffix + suffix)
        if cand.is_dir() and (cand / "meta.json").exists():
            cand.rename(p)
            return p
    return p


def read_orbax(path) -> Dict[str, Any]:
    """{'model': {dotted JAX path: array}, 'optimizer': the port's
    optimizer ``state_dict`` or None, 'global_step', 'metrics'} of an
    orbax directory."""
    path = Path(path)
    if (path / "model" / "manifest.ocdbt").exists():
        raise _written_by_jax(path / "model", "an OCDBT directory")
    meta = json.loads((path / "meta.json").read_text())
    model, _ = read_item(path / "model")
    opt = None
    if (path / "port_optimizer").is_dir():
        leaves, custom = read_item(path / "port_optimizer")
        slots: Dict[str, Dict[str, torch.Tensor]] = {}
        for keys, a in leaves.items():
            if keys[0] == "slots":
                slots.setdefault(keys[1], {})[keys[2]] = torch.from_numpy(a)
        opt = {"optimizer": custom["optimizer"],
               "count": torch.from_numpy(leaves[("count",)]),
               "slots": slots}
    return {"model": {".".join(k): a for k, a in model.items()},
            "optimizer": opt, "global_step": int(meta["global_step"]),
            "metrics": meta.get("metrics", {})}
