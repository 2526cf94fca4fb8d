"""Optimizer: the JAX package's ``optim.Optimizer`` (an optax chain) written
out by hand, so that its steps equal optax's step for step.

``optimizer: Adadelta | Adam | AdamW | SGD``, ``lr_scheduler: fixed |
warmup`` (Noam inverse-sqrt, peak ``lr`` at ``warmup_step``), global-norm
clipping and the non-finite-gradient step skip, in optax's arithmetic:

- clip: ``g / ||g|| * max_norm`` when ``||g|| >= max_norm`` (no epsilon);
- skip (``apply_if_finite``): a step with any non-finite gradient changes
  no parameter and no state, the step count included, so the warmup
  schedule sees count 0 on the first applied update;
- AdamW's weight decay is optax's default 1e-4 (torch's is 1e-2); SGD is
  optax's ``trace`` with ``momentum`` (default 0).

Every step runs on the device with no host synchronisation: the skip is a
``torch.where`` on a device flag. ``apply_if_finite``'s three counters
(``notfinite_count``, ``last_finite``, ``total_notfinite``) are kept as
device scalars and updated as optax updates them; with its
``max_consecutive_errors`` of 1e8 they never change a step, and they are
kept so that the optax state (``utils/optax_state.py``) goes from the JAX
package to the port and back unchanged.

Under tensor parallelism (``parallel/tp.shard_slots`` sets ``split``, the
parameters each rank holds a part of) the slots are parts as well, and the
global norm and the non-finite flag sum the split leaves' squares and
non-finite counts over the model group (replicated leaves count once), so
every rank of a group clips by the world-1 norm and skips together. The
replicated leaves take model index 0's gradient in the same all-reduce:
the ranks of a group compute it from the same rows, but a backward whose
sums run in no fixed order (cuDNN's convolution gradients use atomics)
gives each rank other low bits, and the copies would drift apart.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from .parallel import mesh

# apply_if_finite's counters, in the state_dict as in optax's state
COUNTERS = ("notfinite_count", "last_finite", "total_notfinite")
_INT32_MAX = 2 ** 31 - 1
_SLOTS = {"adadelta": ("e_g", "e_x"), "adam": ("mu", "nu"),
          "adamw": ("mu", "nu"), "sgd": ("trace",)}


def _safe_increment(n: torch.Tensor) -> torch.Tensor:
    """optax's ``numerics.safe_increment``: +1, saturating at int32's
    largest value."""
    return torch.where(n < _INT32_MAX, n + 1, n)


class Optimizer:
    RHO = 0.9                 # optax adadelta
    B1, B2 = 0.9, 0.999       # optax adam / adamw
    WEIGHT_DECAY = 1e-4       # optax adamw default

    def __init__(self, hparas: Dict[str, Any], grad_clip: float = 5.0):
        self.name = str(hparas.get("optimizer", "Adadelta")).lower()
        if self.name not in _SLOTS:
            raise NotImplementedError(f"optimizer {self.name!r}")
        self.lr = float(hparas.get("lr", 1.0))
        self.eps = float(hparas.get("eps", 1e-8))
        self.momentum = float(hparas.get("momentum", 0.0))
        self.schedule = str(hparas.get("lr_scheduler", "fixed")).lower()
        if self.schedule not in ("fixed", "warmup"):
            raise NotImplementedError(f"lr_scheduler {self.schedule!r}")
        self.warmup = int(hparas.get("warmup_step", 4000))
        self.grad_clip = float(grad_clip)
        self.count = None
        # apply_if_finite's counters (module docstring)
        self.notfinite_count = self.last_finite = self.total_notfinite = None
        self.slots: Dict[str, Dict[str, torch.Tensor]] = {}
        self.split: Dict[str, int] = {}   # see the module docstring

    def init(self, params: Mapping[str, torch.Tensor]) -> None:
        dev = next(iter(params.values())).device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)
        self.slots = {n: {s: torch.zeros_like(p) for s in _SLOTS[self.name]}
                      for n, p in params.items()}

    def lr_at(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule at update count ``count`` (f32 tensor)."""
        if self.schedule == "fixed":
            return torch.full((), self.lr, dtype=torch.float32,
                              device=count.device)
        s = torch.clamp(count, min=1).to(torch.float32)
        w = self.warmup
        return self.lr * torch.minimum(s ** -0.5, s * w ** -1.5) * (w ** 0.5)

    def _direction(self, name, p, g, count_inc):
        """The update before the learning rate, and the new slots."""
        st = self.slots[name]
        if self.name == "adadelta":
            e_g = (1 - self.RHO) * g ** 2 + self.RHO * st["e_g"]
            u = torch.sqrt(st["e_x"] + self.eps) / torch.sqrt(e_g + self.eps) * g
            e_x = (1 - self.RHO) * u ** 2 + self.RHO * st["e_x"]
            return u, {"e_g": e_g, "e_x": e_x}
        if self.name == "sgd":
            tr = g + self.momentum * st["trace"]
            return tr, {"trace": tr}
        mu = (1 - self.B1) * g + self.B1 * st["mu"]
        nu = (1 - self.B2) * g * g + self.B2 * st["nu"]
        c = count_inc.to(torch.float32)
        u = (mu / (1 - self.B1 ** c)) / (torch.sqrt(nu / (1 - self.B2 ** c)) + self.eps)
        if self.name == "adamw":
            u = u + self.WEIGHT_DECAY * p
        return u, {"mu": mu, "nu": nu}

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Apply one update from each parameter's ``.grad``. Returns the raw
        gradient global norm (before the clip), a device scalar."""
        if self.count is None:
            self.init(params)
        grads = {n: p.grad for n, p in params.items()}
        if self.split:
            gnorm, finite = self._norm_over_model(grads)
        else:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in grads.values()]).all()
        clip = gnorm < self.grad_clip
        step_size = -self.lr_at(self.count)
        count_inc = self.count + 1
        for n, p in params.items():
            g = torch.where(clip, grads[n], grads[n] / gnorm * self.grad_clip)
            u, new = self._direction(n, p, g, count_inc)
            p.copy_(torch.where(finite, p + step_size * u, p))
            for s, v in new.items():
                self.slots[n][s] = torch.where(finite, v, self.slots[n][s])
        self.count = torch.where(finite, count_inc, self.count)
        self.notfinite_count = torch.where(
            finite, torch.zeros_like(self.notfinite_count),
            _safe_increment(self.notfinite_count))
        self.last_finite = finite
        self.total_notfinite = torch.where(
            finite, self.total_notfinite,
            _safe_increment(self.total_notfinite))
        return gnorm

    def _norm_over_model(self, grads):
        """The global norm and the finite flag of the whole gradient, from
        the rank's parts: one all-reduce over the model group of the split
        leaves' squares and non-finite counts, and of the replicated
        leaves' gradients from model index 0 (zeros from the others),
        which replace every rank's own, in place."""
        rep = [g for n, g in grads.items() if n not in self.split]
        part = [g for n, g in grads.items() if n in self.split]
        zero = torch.zeros((), device=part[0].device)
        tot = torch.cat([torch.stack([
            sum((torch.sum(g * g) for g in part), zero),
            sum((torch.sum(~torch.isfinite(g)).float() for g in part),
                zero)])] + [g.reshape(-1).float() for g in rep])
        if mesh.model_index() != 0:
            tot[2:] = 0
        mesh.model_all_reduce(tot)
        off = 2
        for g in rep:
            g.copy_(tot[off:off + g.numel()].view_as(g))
            off += g.numel()
        sq = sum((torch.sum(g * g) for g in rep), zero) + tot[0]
        finite = (torch.stack([torch.isfinite(g).all() for g in rep]).all()
                  if rep else torch.ones((), dtype=torch.bool,
                                         device=zero.device)) & (tot[1] == 0)
        return torch.sqrt(sq), finite

    def state_dict(self) -> Dict[str, Any]:
        return {"optimizer": self.name, "count": self.count,
                **{k: getattr(self, k) for k in COUNTERS},
                "slots": self.slots}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` onto the device and parameter set given
        to ``init``, which must come first."""
        if sd["optimizer"] != self.name:
            raise ValueError(f"optimizer state is {sd['optimizer']!r}, the "
                             f"configuration asks for {self.name!r}")
        if set(sd["slots"]) != set(self.slots):
            raise KeyError("optimizer state does not match the parameters: "
                           f"{sorted(set(sd['slots']) ^ set(self.slots))[:10]}")
        dev = self.count.device
        self.count = sd["count"].to(dev)
        for k in COUNTERS:          # a state saved before they were kept
            if k in sd:
                setattr(self, k, sd[k].to(dev))
        self.slots = {n: {s: v.to(dev) for s, v in d.items()}
                      for n, d in sd["slots"].items()}
