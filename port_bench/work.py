"""Work counts from shapes and true lengths: the model FLOPs of each
configuration's equations (matrix products and convolutions, 2 FLOPs a
multiply-add) and the operations and bytes of the kernels' functions,
the same whatever implements them. The table of peaks is ``PEAKS``.

Peaks: one NVIDIA H100 SXM, dense bf16 989 TFLOP/s and 3.35 TB/s of HBM
(NVIDIA's data sheet at the 700 W limit). Every share divides by the bf16
rate, f32 configurations too, because the program computes its f32
products on the tensor cores in bf16 passes.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

PEAKS = {"flops": 989e12, "bytes_per_s": 3.35e12}

HOP, WIN = 160, 400        # 10 ms / 25 ms at 16 kHz


def least_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAKS["flops"], nbytes / PEAKS["bytes_per_s"])


# ------------------------------------------------------------ the model
GATES = {"lstm": 4, "gru": 3}     # gate blocks of a recurrent cell's products


def gates(module: str) -> int:
    m = str(module).lower()
    if m not in GATES:
        raise NotImplementedError(f"no work count for a {module!r} cell")
    return GATES[m]


def rnn_step(module: str, din: int, h: int) -> float:
    """One recurrent cell step of one row: input and recurrent products."""
    return 2.0 * (din + h) * gates(module) * h


def frames(samples: int) -> int:
    """Feature frames of a wave of ``samples`` (center padding)."""
    return samples // HOP + 1


def encoder_flops(model: Dict, feat_dim: int, vocab: int, t: int) -> float:
    """VGG prenet, BiLSTM stack and CTC head over ``t`` true feature
    frames of one utterance (the prenet's frequency split as the model's:
    13 bins a channel where they divide, else 40)."""
    freq = 13 if feat_dim % 13 == 0 else (40 if feat_dim % 40 == 0
                                          else feat_dim)
    cin = feat_dim // freq
    f = 0.0
    f += 2.0 * 9 * cin * 64 * t * freq           # conv1 at (t, freq)
    f += 2.0 * 9 * 64 * 64 * t * freq            # conv2
    f += 2.0 * 9 * 64 * 128 * (t // 2) * (freq // 2)
    f += 2.0 * 9 * 128 * 128 * (t // 2) * (freq // 2)
    t4 = t // 4
    din = 128 * max(freq // 4, 1)
    for h in model["encoder"]["dim"]:
        f += 2 * t4 * rnn_step(model["encoder"]["module"], din, int(h))
        din = 2 * int(h)
    return f + 2.0 * t4 * din * vocab


def att_step(model: Dict, t4: int, enc: int) -> float:
    """One location-attention step of one row over ``t4`` frames."""
    a = model["attention"]
    A, ks, nf = int(a["dim"]), int(a["loc_kernel_size"]), int(a["loc_kernel_num"])
    q = int(model["decoder"]["dim"])
    return (2.0 * q * A + t4 * (2.0 * ks * nf + 2.0 * nf * A + 2.0 * A
                                + 2.0 * A))


def speller_step(model: Dict, vocab: int) -> float:
    d, A = int(model["decoder"]["dim"]), int(model["attention"]["dim"])
    return rnn_step(model["decoder"]["module"], d + A, d) + 2.0 * d * vocab


def lm_step(model: Dict, vocab: int) -> float:
    E, H = int(model["emb_dim"]), int(model["dim"])
    f, din = 0.0, E
    for _ in range(int(model["layer"])):
        f += rnn_step(model["module"], din, H)
        din = H
    return f + 2.0 * H * vocab


def att_precompute(model: Dict, t4: int, enc: int) -> float:
    return 2.0 * 2 * t4 * enc * int(model["attention"]["dim"])


def decode_flops(cfg: Dict, lm_cfg: Dict, wave_len: Sequence[int], beam: int,
                 steps: int) -> float:
    """A decode batch: the encoder over each utterance's true frames, then
    ``steps`` beam steps of ``beam`` hypotheses an utterance (all slots, as
    run): attention, speller, LM and the CTC prefix product over the
    utterance's frames and the vocabulary."""
    m, V = cfg["model"], int(cfg["vocab"])
    enc = 2 * int(m["encoder"]["dim"][-1])
    f = 0.0
    per_hyp = speller_step(m, V) + lm_step(lm_cfg["model"], V)
    for n in wave_len:
        t = frames(int(n))
        t4 = t // 4
        f += encoder_flops(m, cfg["feat_dim"], V, t) + att_precompute(m, t4, enc)
        f += steps * beam * (att_step(m, t4, enc) + per_hyp + 2.0 * t4 * V)
    return f


def lm_train_flops(cfg: Dict, text_len: Iterable[int]) -> float:
    return 3.0 * sum(int(u) for u in text_len) * lm_step(cfg["model"],
                                                         int(cfg["vocab"]))


# ---------------------------------------------------------- the kernels
def fbank_work(batch: int, samples: int, n_mels: int = 40):
    """K1 as called: the (batch, samples) f32 waves -> (batch, T, n_mels)
    log-mel; the windowed DFT as a real product, the power and the mel
    product. (flops, bytes)."""
    t = frames(samples)
    bins = WIN // 2 + 1
    f = batch * t * (2.0 * 2 * WIN * bins + 3.0 * bins + 2.0 * bins * n_mels)
    return f, 4.0 * batch * (samples + t * n_mels)


def scan_work(rows_steps: float, h: int, dtype_bytes: int, module: str):
    """One direction of a recurrent scan over ``rows_steps`` true (row,
    step) pairs: the recurrent product h W_hh a step (forward), or
    dh W_hh^T (backward); bytes: the (row, step)'s gate inputs read and H
    outputs written (backward: H in, gate outputs out) at the scan's dtype,
    and W_hh read once. (flops, bytes)."""
    g = gates(module)
    f = rows_steps * 2.0 * h * g * h
    io = rows_steps * (g * h + h) * dtype_bytes
    return f, io + 4.0 * h * g * h


def encoder_scans(model: Dict, wave_len: Sequence[int], dtype_bytes: int,
                  passes: int = 1):
    """The encoder's scan calls over a batch's true frames: (rows x steps,
    hidden, bytes an element, module), each layer's two directions,
    ``passes`` times (2: forward and backward)."""
    steps = sum(frames(int(n)) // 4 for n in wave_len)
    enc = model["encoder"]
    return [(steps, int(h), dtype_bytes, enc["module"])
            for h in enc["dim"] for _ in range(2 * passes)]


def lm_scans(model: Dict, text_len: Iterable[int], dtype_bytes: int,
             passes: int = 1):
    """The LM's scan calls over true tokens, as ``encoder_scans``."""
    steps = sum(int(u) for u in text_len)
    return [(steps, int(model["dim"]), dtype_bytes, model["module"])
            ] * int(model["layer"]) * passes
