"""What a training driver does: one solver object built in set-up
and driven from the seed through its first steps by the window's own call
and feed (``parallel/mesh.prefetch_to_device`` into ``Solver.train_step``,
the step count advanced as ``exec`` advances it), each step on another
batch of the pool, then once more over the rest of the pool so that every
shape has run; the same object then trains in the window.

The check follows the first ``STEPS`` steps with the plain reference
(``reference/``) from the same seeded weights and batches, drawing the
dropout and teacher-forcing uniforms from a generator seeded as the
solver seeds its own (``seed + 1``, on the card) in the program's order,
and compares, each against the reference's: every step's losses
(``loss_gap``, relative), each leaf's first gradient as the optimizer got
it, read back from its state after step 1 (``grad_gap``), and each leaf's
change after step ``STEPS`` (``delta_gap``); a leaf's gap is taken
against the larger of its reference norm and the median leaf's.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import cell as C
from ..reference.numerics import Numerics
from ..reference.optim import Plain
from ..reference.rnn import draw_weights
from ..traffic import cycle, make_pool

STEPS = 3
TINY = 1e-3   # a leaf whose first reference gradient is under this share of
              # the median leaf's moves by round-off alone: no delta compared


class TrainDriver:
    keys: tuple = ()
    loss_keys: tuple = ("loss",)

    def __init__(self, cell: C.Cell):
        self.cell = cell
        self.units: List[Dict[str, Any]] = []
        self.fault = None

    # to be given by each driver
    def leaves(self):
        raise NotImplementedError

    def build_solver(self):
        raise NotImplementedError

    def work(self, batch) -> float:
        raise NotImplementedError

    def counts(self, unit) -> Dict[str, Any]:
        """A step's model FLOPs (``flops``) and scan calls (``scans``),
        from ``work.py``."""
        raise NotImplementedError

    def reference_step(self, nm, p, batch, gen, step) -> Dict[str, float]:
        raise NotImplementedError

    # ---------------------------------------------------------------- set-up
    def weights(self):
        return draw_weights(self.leaves(), C.derive(self.cell.seed, 1),
                            self.cell.device)

    def setup(self):
        cell = self.cell
        self.tok = C.tokenizer()
        self.pool = make_pool(cell.mix, cell.seed, self.tok, cell.device)
        self.w0 = self.weights()
        self.solver = self.build_solver()
        C.assign(self.solver_module(), self.w0)
        self.order = cycle(len(self.pool), cell.seed)
        first = [next(self.order) for _ in range(len(self.pool))]
        self.first = first[:STEPS]
        self.prog = {"losses": [], "grad": None, "delta": None}
        self._loop(first, None, record=True)
        if cell.device.type == "cuda":
            torch.cuda.synchronize()
        self.prog["losses"] = [{k: float(v) for k, v in m.items()}
                               for m in self.prog["losses"]]
        self.units = []

    def solver_module(self):
        return self.solver.model

    def slot_grad_norms(self) -> Dict[str, float]:
        """Each leaf's first gradient, as the optimizer got it, from its
        state after one step (Adam: mu = (1 - b1) g)."""
        opt = self.solver.optimizer
        return {n: float(st["mu"].double().norm() / (1 - opt.B1))
                for n, st in opt.slots.items()}

    # ---------------------------------------------------------------- window
    def _feed(self, indices):
        for i in indices:
            b = self.pool[i]
            if self.fault == "half_batch":
                n = len(b["text_len"]) // 2
                b = {k: (v[:n] if hasattr(v, "__len__") else v)
                     for k, v in b.items()}
            yield b

    def _loop(self, indices, deadline, record=False):
        from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
        s = self.solver
        feed = mesh.prefetch_to_device(self._feed(indices), self.cell.device,
                                       keys=self.keys)
        with contextlib.closing(feed):
            for dev, batch in feed:
                frozen = ({k: p.detach().clone() for k, p in s.params.items()}
                          if self.fault == "frozen" else None)
                m = s.train_step(*(dev[k] for k in self.keys))
                if frozen is not None:      # the step leaves its state as it was
                    with torch.no_grad():
                        for k, p in s.params.items():
                            p.copy_(frozen[k])
                s.step += 1
                if record:
                    self._record(m)
                self.units.append({"work": self.work(batch),
                                   "text_len": batch["text_len"].tolist()})
                if deadline is not None and time.perf_counter() >= deadline:
                    break

    def _record(self, m):
        n = len(self.prog["losses"])
        if n < STEPS:
            self.prog["losses"].append({k: m[k].detach().clone()
                                        for k in self.loss_keys})
        if n == 0:
            self.prog["grad"] = self.slot_grad_norms()
        if n == STEPS - 1:
            with torch.no_grad():
                self.prog["delta"] = {
                    k: float((p.detach() - self.w0[k]).double().norm())
                    for k, p in self.solver.params.items()}

    def window(self, seconds: float):
        t0 = time.perf_counter()
        self.units = []
        self._loop(self.order, t0 + seconds)
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        for u in self.units:
            u["t"] = t
        return t0

    def close(self):
        self.solver = None

    # ----------------------------------------------------------------- check
    def follow(self, mode: str = "f32"):
        """The reference's losses, first clipped gradients and changes over
        the first STEPS steps, in ``mode``."""
        cell = self.cell
        nm = Numerics(mode)
        p = {k: v.clone().requires_grad_(True)
             for k, v in self.weights().items()}
        w0 = {k: v.detach().clone() for k, v in p.items()}
        opt = Plain(cell.config["hparas"])
        gen = torch.Generator(device=cell.device).manual_seed(cell.seed + 1)
        losses, grad = [], None
        with nm.flags():
            for step, i in enumerate(self.first):
                batch = {k: torch.as_tensor(v, device=cell.device)
                         for k, v in self.pool[i].items() if k in self.keys}
                losses.append(self.reference_step(nm, p, batch, gen, step))
                g = opt.step(p)
                if step == 0:
                    grad = {k: float(v.double().norm()) for k, v in g.items()}
        delta = {k: float((p[k].detach() - w0[k]).double().norm()) for k in p}
        return {"losses": losses, "grad": grad, "delta": delta}

    def readings(self, mode: str = "f32") -> Dict[str, float]:
        ref = self.follow("f32")
        other = self.prog if mode == "f32" else self.follow(mode)
        return compare(ref, other, self.loss_keys)


def _leaf_gap(ref: Dict[str, float], got: Dict[str, float], keep=None) -> float:
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return max(abs(got.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def compare(ref, got, loss_keys) -> Dict[str, float]:
    if got["grad"] is None or got["delta"] is None or len(got["losses"]) < STEPS:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "delta_gap": float("inf")}
    loss = max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-30)
               for r, g in zip(ref["losses"], got["losses"]) for k in loss_keys)
    med = float(np.median(list(ref["grad"].values())))
    moving = {k for k, v in ref["grad"].items() if v >= TINY * med}
    return {"loss_gap": loss, "grad_gap": _leaf_gap(ref["grad"], got["grad"]),
            "delta_gap": _leaf_gap(ref["delta"], got["delta"], moving)}
