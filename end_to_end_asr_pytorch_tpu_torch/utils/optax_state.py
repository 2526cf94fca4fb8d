"""The optimizer state in the JAX package's optax tree, in both directions.

The JAX ``optim.Optimizer`` is ``apply_if_finite(chain(clip_by_global_norm,
<base>))``. Flattened to dotted key paths (a NamedTuple by field name, a
tuple by index, the parameter tree by its own paths), its state is, with
optax 0.2.6:

- ``notfinite_count`` (int32), ``last_finite`` (bool), ``total_notfinite``
  (int32): ``apply_if_finite``'s counters;
- ``inner_state.0``: the clip's ``EmptyState``;
- ``inner_state.1``: the base optimizer's chain (``CHAINS`` below): its
  slots, one parameter tree each (``inner_state.1.0.mu.<parameter path>``),
  its step counts (int32 scalars) and ``EmptyState`` nodes.

``EmptyState`` nodes and the parameter tree's ``None`` leaves hold no
array; orbax records them in its metadata, and ``to_optax`` gives them as
``None`` so that ``utils/orbax.py`` writes them. A slot is mapped as its
parameter is (``utils/weights.py``): the same path, the same layout
transforms, the plugin solver's ``{'asr', 'plugin'}`` tree split the same
way. The port keeps one step count; it is written to each of optax's, and
on reading they must agree. The optimizer's kind is read from the tree's
slot names. This module imports neither JAX nor optax: the layout is
written out here, and the tests hold it to the installed optax.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from .weights import _to_jax_layout, _to_port_layout, port_name, split_plugin

# per optimizer: the fields of each element of its chain's state
# (``inner_state.1.<i>``), in order; no fields: an EmptyState
CHAINS = {
    "adadelta": ((), ("e_g", "e_x"), ("count",)),
    "adam": (("count", "mu", "nu"), ("count",)),
    "adamw": (("count", "mu", "nu"), (), ("count",)),
    "sgd": (("trace",), ("count",)),
}
COUNTERS = {"notfinite_count": np.int32, "last_finite": np.bool_,
            "total_notfinite": np.int32}
PLUGIN = "plugin."                 # the port's prefix of the plugin's leaves


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _jax_slot(name: str, a: np.ndarray, plugin: bool):
    """(JAX parameter path, array in the JAX layout) of the slot of the
    port's parameter ``name``."""
    if name.startswith(PLUGIN):
        return name, (a.T if name == PLUGIN + "w_proj" else a)
    return (f"asr.{name}" if plugin else name), _to_jax_layout(name, a)


def _layout(name: str):
    """(the paths of its step counts, {slot: the path under which its
    parameter tree sits}) of optimizer ``name``'s optax state."""
    counts, slots = [], {}
    for i, fields in enumerate(CHAINS[name]):
        for f in fields:
            if f == "count":
                counts.append(f"inner_state.1.{i}.count")
            else:
                slots[f] = f"inner_state.1.{i}.{f}"
    return counts, slots


def to_optax(state: Dict[str, Any], none_params: Iterable[str] = ()
             ) -> Dict[str, Optional[np.ndarray]]:
    """{dotted optax path: array, or None for an empty node} of the port's
    ``Optimizer.state_dict()`` (whole slots: under tensor parallelism
    within ``parallel/tp.whole``), in the order the tree flattens, which
    orbax's metadata needs for the tuples. ``none_params``: the dotted
    paths of the JAX parameter tree's None leaves, recorded under every
    slot."""
    count = _np(state["count"]).astype(np.int32)
    plugin = any(n.startswith(PLUGIN) for n in state["slots"])
    out: Dict[str, Optional[np.ndarray]] = {
        k: _np(state[k]).astype(dt) for k, dt in COUNTERS.items()}
    out["inner_state.0"] = None                     # the clip's EmptyState
    for i, fields in enumerate(CHAINS[state["optimizer"]]):
        node = f"inner_state.1.{i}"
        if not fields:
            out[node] = None
        for f in fields:
            if f == "count":
                out[f"{node}.count"] = count.copy()
                continue
            for n, d in state["slots"].items():
                path, a = _jax_slot(n, _np(d[f]), plugin)
                out[f"{node}.{f}.{path}"] = a
            for path in none_params:
                out[f"{node}.{f}.{path}"] = None
    return out


def kind_of(leaves: Dict[str, Any]) -> str:
    """The optimizer whose optax state ``leaves`` (dotted paths) is, from
    its slot names and, for adam and adamw, where its schedule's count
    sits."""
    for name in CHAINS:
        counts, slots = _layout(name)
        if all(any(p.startswith(pre + ".") for p in leaves)
               for pre in slots.values()) and all(c in leaves
                                                  for c in counts):
            return name
    raise ValueError("optimizer state: not the optax state of Adadelta, "
                     "Adam, AdamW or SGD as the JAX package builds it: "
                     f"{sorted(leaves)[:8]}")


def from_optax(leaves: Dict[str, Any], name: Optional[str] = None
               ) -> Dict[str, Any]:
    """The port's ``Optimizer.state_dict()`` of the optax state ``leaves``
    ({dotted path: array}; None entries are ignored). ``name``: the
    optimizer the configuration asks for; another kind of state raises,
    naming both."""
    leaves = {k: v for k, v in leaves.items() if v is not None}
    kind = kind_of(leaves)
    if name is not None and kind != name.lower():
        raise ValueError(f"optimizer state is {kind!r}, the configuration "
                         f"asks for {name.lower()!r}")
    count_paths, slot_paths = _layout(kind)
    counts = {p: int(np.asarray(leaves[p])) for p in count_paths}
    if len(set(counts.values())) != 1:
        raise ValueError(f"optimizer state: the step counts disagree: "
                         f"{counts}")
    missing = [k for k in COUNTERS if k not in leaves]
    if missing:
        raise KeyError(f"optimizer state: no {missing} (apply_if_finite)")
    by_slot: Dict[str, Dict[str, np.ndarray]] = {s: {} for s in slot_paths}
    for path, a in leaves.items():
        for s, pre in slot_paths.items():
            if path.startswith(pre + "."):
                by_slot[s][port_name(path[len(pre) + 1:])] = np.asarray(a)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for s, arrays in by_slot.items():
        asr, plugin = split_plugin(arrays)
        for n, a in asr.items():
            out.setdefault(n, {})[s] = torch.from_numpy(np.ascontiguousarray(
                _to_port_layout(n, a.astype(np.float32))))
        for n, a in (plugin or {}).items():
            a = a.astype(np.float32)
            out.setdefault(PLUGIN + n, {})[s] = torch.from_numpy(
                np.ascontiguousarray(a.T if n == "w_proj" else a))
    return {"optimizer": kind,
            "count": torch.tensor(next(iter(counts.values())),
                                  dtype=torch.int32),
            **{k: torch.from_numpy(np.asarray(leaves[k]).astype(dt))
               for k, dt in COUNTERS.items()},
            "slots": out}
