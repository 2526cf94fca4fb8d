"""Plain recurrences and weights of the reference.

Leaves are named and laid out as the program names them (``w_ih`` (D, 4H),
``w_hh`` (H, 4H), one bias ``b`` (4H,), gates in the order i, f, g, o), so
that the benchmark can hand the same seeded weights to both sides. Nothing
here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .numerics import Numerics

# (name, shape, kind, fan): kind "w" is Uniform(+-1/sqrt(fan)), "zero" a
# zero bias, "lstm_b" a zero LSTM bias whose forget quarter is 1
Leaf = Tuple[str, Tuple[int, ...], str, int]


def lstm_leaves(prefix: str, in_dim: int, hidden: int) -> List[Leaf]:
    return [(f"{prefix}w_ih", (in_dim, 4 * hidden), "w", hidden),
            (f"{prefix}w_hh", (hidden, 4 * hidden), "w", hidden),
            (f"{prefix}b", (4 * hidden,), "lstm_b", 0)]


def lstm_cell(nm: Numerics, p: Dict[str, torch.Tensor], pre: str,
              x_proj: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One step from the input projection ``x_proj`` = x w_ih + b; the
    new state as ``nm`` stores it."""
    gates = x_proj + nm.mm(h, p[pre + "w_hh"])
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return nm.q(torch.sigmoid(o) * torch.tanh(c)), nm.q(c)


def lstm_scan(nm: Numerics, p: Dict[str, torch.Tensor], pre: str,
              x: torch.Tensor, mask: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """x (B, T, D), mask (B, T) a valid prefix of each row -> (B, T, H):
    zero state, padded steps emit zeros and hold the carry (so the reverse
    pass of a row starts at its last valid step)."""
    B, T, _ = x.shape
    H = p[pre + "w_hh"].shape[0]
    x_proj = nm.mm(x, p[pre + "w_ih"]) + p[pre + "b"]
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new, c_new = lstm_cell(nm, p, pre, x_proj[:, t], h, c)
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out[t] = torch.where(m, h_new, torch.zeros_like(h_new))
    return torch.stack(out, dim=1)


def draw_weights(leaves: List[Leaf], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every leaf from one uniform draw on ``device`` by a generator seeded
    with ``seed``: a few large calls, float32."""
    n = sum(int(torch.Size(s).numel()) for _, s, _, _ in leaves)
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(n, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind, fan in leaves:
        k = int(torch.Size(shape).numel())
        if kind == "w":
            s = 1.0 / max(fan, 1) ** 0.5
            t = (u[off:off + k] * (2 * s) - s).reshape(shape)
        else:
            t = torch.zeros(shape, device=device)
            if kind == "lstm_b":
                H = shape[0] // 4
                t[H:2 * H] = 1.0
        out[name] = t.clone()
        off += k
    return out


def dropout(h: torch.Tensor, rate: float, u: torch.Tensor) -> torch.Tensor:
    """Inverted dropout with the uniform draw ``u`` of h's shape."""
    keep = 1.0 - rate
    return h * (u < keep).to(h.dtype) / keep
