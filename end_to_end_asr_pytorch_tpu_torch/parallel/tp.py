"""Tensor parallelism: computing with the parameter parts that
``mesh.model_parallel_spec`` places on each rank of a model group.

Storage and compute are split as in Megatron-LM's pairing, which the JAX
package's GSPMD layout describes:

  * Vocabulary-sized leaves (``VOCAB``) are computed split. The CTC,
    attention and LM heads (``ctc_w`` / ``char_w`` / ``out_w`` and their
    biases) give each rank its V / M columns of the logits, which
    ``gather`` joins along V (its backward takes the rank's columns back),
    so the softmax, the CTC loss (K3), the cross-entropy, the beam tail
    (K8) and K6 read the whole logits, as the JAX package's loss softmax
    all-gathers once. The head's input passes ``copy_to_model`` (identity
    forward, all-reduce over the model group backward: Megatron's "f"),
    without which its gradient would be the rank's part alone. An
    embedding lookup (``vocab_lookup``) takes the rank's rows, zeroes the
    ids outside them and all-reduces the result (``reduce_from_model``,
    Megatron's "g"); the decoders' (V, gates) lookup tables are built from
    the rank's rows and gathered (``vocab_table``). ``models/asr.py`` and
    ``models/lm.py`` call these three for their heads and embeddings.
  * Every other split leaf (the scans' and cells' weights and biases, the
    attention projections) is split only where it is stored: within
    ``gathered`` (one training step's forward and backward, one decode or
    validation batch) it holds the whole tensor, so the models compute
    with whole weights: K2 / K4 and their backward passes keep a
    direction's whole W_hh on one cluster of the card, and K5 and K7 take
    whole attention weights. On leaving the block each keeps its part of
    the whole gradient it computed; the ranks of a group compute it from
    the same rows and each part is held once, so this needs no collective.

Replicated leaves are held whole on every rank of a group; the optimizer
gives every rank model index 0's gradient for them (``optim.py``), so the
copies stay bit-identical whatever order a rank's backward summed in.

``shard_module`` cuts a module's parameters in place and records, on each
owning module, which of its leaves are split along which dimension
(``_tp_split``: a plain attribute, so it survives ``copy.deepcopy`` and
``torch.func.functional_call``); ``whole`` puts every whole tensor back,
the optimizer's slots too, for the duration of a block (the checkpoint
writer's view). At ``model_parallel: 1`` nothing is split and every helper
here returns its input.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import mesh
from ..ops.amp import dot_f32

# the leaves computed split; every other split leaf is whole within ``gathered``
VOCAB = {"ctc_w", "ctc_b", "char_w", "char_b", "out_w", "out_b", "embed"}


class _Gather(torch.autograd.Function):
    """Forward: the model group's parts joined along ``dim``. Backward:
    this rank's part of the whole gradient it computed."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return mesh.model_all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, mesh.model_index() * ctx.n, ctx.n)
                .contiguous(), None)


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over the model
    group (the input of a product with a split weight)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh.model_all_reduce(g.clone())


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the input summed over the model group. Backward: the
    identity."""

    @staticmethod
    def forward(ctx, x):
        return mesh.model_all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Gather.apply(x, dim) if mesh.model_size() > 1 else x


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x) if mesh.model_size() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x) if mesh.model_size() > 1 else x


def split_dim(module: nn.Module, name: str) -> Optional[int]:
    """The dimension ``module.<name>`` is split along, or None."""
    split = getattr(module, "_tp_split", None)
    return None if not split else split.get(name)


def vocab_logits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 split: bool) -> torch.Tensor:
    """``x @ w + b`` in f32; with ``w`` (d, V / M) and ``b`` the rank's
    columns (``split``), each rank's product joined along V. The input's
    gradient is summed over the group in f32 and rounded to a bf16 input's
    dtype once, as world 1 rounds it."""
    if not split:
        return dot_f32(x, w) + b
    return gather(dot_f32(copy_to_model(x.float()), w) + b, -1)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a table of which this rank holds rows
    ``[i n, (i + 1) n)``: the rank's rows looked up, the others zero, the
    sum over the model group."""
    n = table.shape[0]
    local = ids.long() - mesh.model_index() * n
    inside = (local >= 0) & (local < n)
    rows = F.embedding(torch.clamp(local, 0, n - 1), table)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    return reduce_from_model(torch.where(inside[..., None], rows, zero))


def vocab_table(table_rows: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, split: bool) -> torch.Tensor:
    """The (V, G) table ``table @ w + b`` in f32; when ``split`` the table
    is the rank's rows and ``w`` / ``b`` whole: each rank's rows, joined
    (the gradients of ``w`` and ``b`` summed over the model group)."""
    if not split:
        return dot_f32(table_rows, w) + b
    part = dot_f32(table_rows, copy_to_model(w)) + copy_to_model(b)
    return gather(part, 0)


# ------------------------------------------------------------ the parts
def shard_module(module: nn.Module, prefix: str = "") -> Dict[str, int]:
    """Cut every parameter of ``module`` that the rule splits to this rank's
    part, in place, and record it on its owner; returns {parameter name
    (with ``prefix``): dimension}. Nothing happens at ``model_parallel:
    1``."""
    m = mesh.model_size()
    out: Dict[str, int] = {}
    if m == 1:
        return out
    for mod_name, mod in module.named_modules():
        for leaf, p in list(mod._parameters.items()):
            if p is None:
                continue
            name = f"{prefix}{mod_name}.{leaf}" if mod_name else \
                f"{prefix}{leaf}"
            dim = mesh.model_parallel_spec(name, p.shape, m)
            if dim is None:
                continue
            with torch.no_grad():
                p.data = mesh.part_of(p.data, dim)
            split = dict(getattr(mod, "_tp_split", None) or {})
            split[leaf] = dim
            mod._tp_split = split
            out[name] = dim
    return out


def _gather_whole(params: Dict[str, torch.Tensor],
                  split: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """Give each parameter in ``split`` its whole tensor (a collective);
    returns the parts it held."""
    parts = {}
    with torch.no_grad():
        for name, dim in split.items():
            p = params[name]
            parts[name] = p.data
            p.data = mesh.model_all_gather(p.data, dim)
    return parts


@contextlib.contextmanager
def gathered(params: Dict[str, torch.Tensor],
             split: Dict[str, int]) -> Iterator[None]:
    """Within the block, every split parameter in ``params`` that is not in
    ``VOCAB`` holds the whole tensor (a collective: every rank of the model
    group enters it together). After it, each holds its part again, and a
    gradient computed within the block is cut to the rank's part."""
    at_use = {n: d for n, d in split.items()
              if n.rsplit(".", 1)[-1] not in VOCAB}
    if not at_use:
        yield
        return
    before = {n: params[n].grad for n in at_use}
    parts = _gather_whole(params, at_use)
    try:
        yield
    finally:
        for name, part in parts.items():
            p = params[name]
            g, p.grad = p.grad, None
            p.data = part
            p.grad = (g if g is None or g is before[name]
                      else mesh.part_of(g, at_use[name]))


@contextlib.contextmanager
def whole(params: Dict[str, torch.Tensor], split: Dict[str, int],
          optimizer=None) -> Iterator[None]:
    """Within the block, every split parameter in ``params`` and its
    optimizer slots hold the whole tensor (a collective: every rank of the
    model group enters it together); their parts come back after."""
    if not split:
        yield
        return
    parts = _gather_whole(params, split)
    slots = None
    if optimizer is not None and optimizer.slots:
        slots = optimizer.slots
        optimizer.slots = {
            n: {s: (mesh.model_all_gather(v, split[n]) if n in split
                    else v) for s, v in d.items()}
            for n, d in slots.items()}
    try:
        yield
    finally:
        for name, t in parts.items():
            params[name].data = t
        if slots is not None:
            optimizer.slots = slots


def shard_slots(optimizer, split: Dict[str, int]) -> None:
    """Cut the optimizer's whole slots (``init`` on the whole parameters,
    or a loaded state) to this rank's parts, and hand it the split leaves
    (its norm and its skip sum them over the model group)."""
    optimizer.split = dict(split)
    if split and optimizer.slots:
        optimizer.slots = {
            n: {s: (mesh.part_of(v, split[n]) if n in split else v)
                for s, v in d.items()}
            for n, d in optimizer.slots.items()}
