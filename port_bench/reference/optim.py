"""Plain optimizer steps of the reference: optax's global-norm clip
(``g / ||g|| * max_norm`` when ``||g|| >= max_norm``), then Adam (0.9,
0.999), as the LM recipe states it."""
from __future__ import annotations

from typing import Dict

import torch

B1, B2 = 0.9, 0.999


class Plain:
    def __init__(self, hparas: Dict, grad_clip: float = 5.0):
        self.kind = str(hparas["optimizer"]).lower()
        if self.kind != "adam":
            raise NotImplementedError(f"optimizer {self.kind!r}")
        if str(hparas.get("lr_scheduler", "fixed")).lower() != "fixed":
            raise NotImplementedError("the reference steps at a fixed rate")
        self.lr = float(hparas["lr"])
        self.eps = float(hparas.get("eps", 1e-8))
        self.clip = float(grad_clip)
        self.n = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update from each leaf's ``.grad``; returns the clipped
        gradients the update used."""
        g = {k: v.grad for k, v in params.items()}
        norm = torch.sqrt(sum((x.double() ** 2).sum()
                              for x in g.values())).float()
        if norm >= self.clip:
            g = {k: x / norm * self.clip for k, x in g.items()}
        self.n += 1
        for k, p in params.items():
            st = self.state.setdefault(
                k, {s: torch.zeros_like(p) for s in ("a", "b")})
            st["a"] = (1 - B1) * g[k] + B1 * st["a"]
            st["b"] = (1 - B2) * g[k] ** 2 + B2 * st["b"]
            u = (st["a"] / (1 - B1 ** self.n)) / (
                torch.sqrt(st["b"] / (1 - B2 ** self.n)) + self.eps)
            p -= self.lr * u
            p.grad = None
        return g
