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
- ``optimizer/``: the optimizer's state as the JAX package's optax tree
  (``utils/optax_state.to_optax``: ``apply_if_finite``'s counters, the
  slots at the parameters' JAX paths and layout, the step counts), in the
  same layout, its ``EmptyState`` nodes and the parameter tree's None
  leaves recorded in ``_METADATA`` as ``None`` values. The JAX package's
  ``load_checkpoint`` restores it into ``Optimizer(...).init(params)``.
- ``meta.json``: ``global_step`` and ``metrics``, written last, so a
  directory that holds it is complete.

``save_orbax`` writes to a ``.tmp`` sibling, renames an existing directory
aside to ``.old``, promotes the ``.tmp`` and removes the ``.old``; after a
preemption in any of those windows ``recover_sibling`` promotes the
complete sibling back (the JAX package's ``_recover_orbax_sibling``).

``read_orbax`` reads these directories and the ones the JAX package
writes through orbax with its defaults: ``model/`` and ``optimizer/``
OCDBT databases (``manifest.ocdbt``, ``ocdbt.process_<i>/``;
``utils/ocdbt.py``) holding a zarr v2 ``.zarray`` and zstd-compressed
chunks a leaf. ``read_item`` takes zarr v2 leaves, compressed with zstd or
not, in OCDBT or in a directory a leaf: arrays split into several chunks,
chunks missing from the store (the fill value), scalars (int32 and bool
among them), and bf16 leaves (returned as float32 of the same values, an
exact widening). Chunks are decompressed by the port's own zstd
decoder (``utils/zstd.py``). A zarr v3 leaf (``zarr.json``, orbax's
``use_zarr3``, which the JAX package does not set) raises. ``optimizer/``
is read in both layouts and mapped onto the port's optimizer by
``utils/optax_state.from_optax``, so a resume takes the model, the
optimizer state and the step of a directory either package wrote.
"""
from __future__ import annotations

import itertools
import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from ..models.lm import RNNLM
from . import zstd
from .ocdbt import read_ocdbt
from .optax_state import from_optax, to_optax
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


def write_item(d: Path, leaves: Dict[Keys, Optional[np.ndarray]]) -> None:
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
        a = np.asarray(a, order="C")          # a scalar stays 0-d
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
        "custom_metadata": {}}))


def _fill(value, dtype: np.dtype, bf16: bool, what: str):
    """A zarr v2 ``fill_value`` as a scalar of ``dtype`` (bf16: its bits):
    null, which orbax writes, is zero, as tensorstore reads it."""
    if value is None:
        return dtype.type(0)
    if not isinstance(value, (int, float)):
        raise NotImplementedError(f"{what}: fill_value {value!r}")
    if bf16:
        return np.uint16(np.array(value, np.float32).view(np.uint32) >> 16)
    return dtype.type(value)


def _dtype(name: str, what: str) -> Tuple[np.dtype, bool]:
    """(the stored dtype, whether it is bf16) of a zarr v2 ``dtype``. bf16
    is read as its bits (uint16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    try:
        dt = np.dtype(name)
    except TypeError:
        raise NotImplementedError(f"{what}: data type {name!r}") from None
    if dt.kind not in "biufc":
        raise NotImplementedError(f"{what}: data type {name!r}")
    return dt, False


def _widen(a: np.ndarray, bf16: bool) -> np.ndarray:
    """Native byte order; bf16 bits widened to the float32 of the same
    value (exact: a bf16 is a float32's upper half)."""
    a = a.astype(a.dtype.newbyteorder("="), copy=False)
    if bf16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a


def _grid(shape, chunks, what: str):
    """Each chunk's grid index and the slices of the array it covers."""
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{what}: chunk shape {chunks} for shape {shape}")
    counts = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*[range(n) for n in counts]):
        yield idx, tuple(slice(i * c, min((i + 1) * c, s))
                         for i, c, s in zip(idx, chunks, shape))


def _read_v2(z: Dict[str, Any], get, name: str, what: str) -> np.ndarray:
    """A zarr v2 array (``.zarray`` ``z``) whose chunk ``key`` is
    ``get(f"{name}/{key}")`` (None: missing, the fill value)."""
    if z.get("zarr_format") != 2:
        raise NotImplementedError(f"{what}: zarr_format "
                                  f"{z.get('zarr_format')} in a .zarray")
    comp = z.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise NotImplementedError(f"{what}: compressor {comp.get('id')!r}; "
                                  "the port reads zstd and none")
    if z.get("filters"):
        raise NotImplementedError(f"{what}: filters {z['filters']}")
    if z.get("order", "C") != "C":
        raise NotImplementedError(f"{what}: order {z['order']!r}; orbax "
                                  "writes C")
    dt, bf16 = _dtype(z["dtype"], what)
    shape, chunks = list(z["shape"]), list(z["chunks"])
    sep = z.get("dimension_separator", ".")
    out = np.full(shape, _fill(z.get("fill_value"), dt, bf16, what), dt)
    for idx, where in _grid(shape, chunks, what):
        raw = get(f"{name}/{sep.join(map(str, idx)) or '0'}")
        if raw is None:
            continue
        if comp is not None:
            raw = zstd.decompress(raw)
        if len(raw) != dt.itemsize * int(np.prod(chunks)):
            raise ValueError(f"{what}: chunk {idx} holds {len(raw)} bytes "
                             f"for {chunks} of {z['dtype']}")
        chunk = np.frombuffer(raw, dt).reshape(chunks)
        out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    return _widen(out, bf16)


def read_array(get, name: str, what: str) -> np.ndarray:
    """The array ``name`` of a store (``get(key)``: its bytes, or None),
    from its zarr v2 ``.zarray``."""
    meta = get(f"{name}/.zarray")
    if meta is not None:
        return _read_v2(json.loads(meta), get, name, what)
    if get(f"{name}/zarr.json") is not None:
        raise NotImplementedError(f"{what}: a zarr v3 leaf (zarr.json); the "
                                  "port reads the zarr v2 leaves the JAX "
                                  "package writes")
    raise FileNotFoundError(f"{what}: no .zarray")


def read_item(d: Path) -> Tuple[Dict[Keys, np.ndarray], Dict[str, Any]]:
    """({key path: array}, the custom metadata) of an orbax
    ``StandardCheckpointer`` item: OCDBT (``utils/ocdbt.py``) or a
    directory a leaf, zarr v2, compressed with zstd or not (module
    docstring). bf16 leaves come back as float32 of the same values."""
    meta = json.loads((d / "_METADATA").read_text())
    ocdbt = meta.get("use_ocdbt", True) or (d / "manifest.ocdbt").exists()
    if ocdbt:
        store = read_ocdbt(d)

        def get(key: str) -> Optional[bytes]:
            return store.get(key.encode())
    else:
        def get(key: str) -> Optional[bytes]:
            p = d / key
            return p.read_bytes() if p.is_file() else None
    out = {}
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"]["value_type"] == "None":
            continue
        keys = tuple(k["key"] for k in entry["key_metadata"])
        name = ".".join(keys)
        out[keys] = read_array(get, name, str(d / name))
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
    in the plugin solver's tree), ``optimizer``'s state as optax's tree,
    the step and ``metrics`` as the orbax directory ``path`` (module
    docstring)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    old = path.with_suffix(path.suffix + ".old")
    shutil.rmtree(tmp, ignore_errors=True)
    leaves = model_leaves(model, plugin)
    write_item(tmp / "model", leaves)
    if optimizer is not None:
        opt = to_optax(optimizer.state_dict(),
                       [".".join(k) for k, a in leaves.items() if a is None])
        write_item(tmp / "optimizer",
                   {tuple(k.split(".")): a for k, a in opt.items()})
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
    optimizer ``state_dict`` of its ``optimizer/`` (optax's tree), or None,
    'global_step', 'metrics'} of an orbax directory."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    model, _ = read_item(path / "model")
    opt = None
    if (path / "optimizer").is_dir():
        leaves, _ = read_item(path / "optimizer")
        opt = from_optax({".".join(k): a for k, a in leaves.items()})
    return {"model": {".".join(k): a for k, a in model.items()},
            "optimizer": opt, "global_step": int(meta["global_step"]),
            "metrics": meta.get("metrics", {})}
