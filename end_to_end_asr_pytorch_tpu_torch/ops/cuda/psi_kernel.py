"""K6: the CTC prefix scorer's phase-1 psi over the whole vocabulary, fused
with its last-token and blank epilogues — wrapper for ``csrc/psi.cu`` and
its plain PyTorch version.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/psi_kernel.py``
``psi_fused`` with the same contract: wd (B, K, T) f32 = exp(phi_diff - md),
probs (B, T, V) bf16 (decode amp) or f32, md (B, K) f32 row shifts,
psi_same (B, K) f32 score of repeating the last token, last_tok (B, K) int32
-> psi (B, K, V) f32:

    psi[b,k,v] = v == blank     ? -1e30
               : v == last[b,k] ? psi_same[b,k]
               : md[b,k] + log(sum_t bf16(wd[b,k,t]) * probs[b,t,v] + 1e-38)

(wd is rounded to the probs type; products and sums are f32). On the H100
the kernel is bound by the bytes of probs (see the CUDA source).

``pick_block`` is a copy of the JAX package's: the beam's gate. A
configuration takes K6 exactly where the JAX package would take its Pallas
kernel, decided from V, T and the probs type before any launch. The CUDA
kernel's own blocking does not depend on it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
_VMEM_BUDGET = 4 * 1024 * 1024  # the TPU kernel's probs-block bytes per cell
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "psi_launch": (_I, [_P, _P, _I, _P, _P, _P, _P] + [_I] * 5 + [_P]),
}
_CPT = 4  # vocabulary columns per thread in the kernel: V must divide


def pick_block(V: int, T: int, itemsize: int = 2) -> Optional[int]:
    """Largest vocab block in {1024, 512, 256, 128} that divides V and keeps
    the TPU kernel's (T, BV) probs block within its budget; None if V is
    not blockable (then the beam does not take the kernel)."""
    for bv in (1024, 512, 256, 128):
        if V % bv == 0 and T * bv * itemsize <= _VMEM_BUDGET:
            return bv
    return None


def psi_plain(wd: torch.Tensor, probs: torch.Tensor, md: torch.Tensor,
              psi_same: torch.Tensor, last_tok: torch.Tensor,
              blank: int = 0) -> torch.Tensor:
    """Plain version of the kernel, the TPU kernel's arithmetic: wd rounded
    to the probs type, bf16 products summed in f32 (the TPU kernel's
    ``preferred_element_type=float32``), then the merges, blank last."""
    V = probs.shape[-1]
    acc = torch.bmm(wd.to(probs.dtype).float(), probs.float())
    psi = md[..., None] + torch.log(acc + 1e-38)
    col = torch.arange(V, device=probs.device)
    psi = torch.where(col == last_tok[..., None], psi_same[..., None], psi)
    psi[:, :, blank] = NEG_INF
    return psi


def psi_fused(wd: torch.Tensor, probs: torch.Tensor, md: torch.Tensor,
              psi_same: torch.Tensor, last_tok: torch.Tensor,
              blank: int = 0) -> torch.Tensor:
    """K6. probs bf16 or f32, every other float input f32, last_tok int32,
    all contiguous; V a multiple of 4. CPU tensors take the plain version;
    CUDA tensors launch the kernel. Either way, inputs of another dtype or
    layout raise."""
    B, K, T = wd.shape
    V = probs.shape[-1]
    f32 = torch.float32
    if probs.dtype not in (torch.bfloat16, f32):
        raise ValueError(f"psi_fused: probs must be bf16 or f32, got {probs.dtype}")
    build.check_inputs("psi_fused", wd,
                       ("wd", wd, (B, K, T), f32),
                       ("probs", probs, (B, T, V), probs.dtype),
                       ("md", md, (B, K), f32),
                       ("psi_same", psi_same, (B, K), f32),
                       ("last_tok", last_tok, (B, K), torch.int32))
    if wd.device.type == "cpu":
        return psi_plain(wd, probs, md, psi_same, last_tok, blank)
    if wd.device.type != "cuda":
        raise ValueError(f"psi_fused: unsupported device {wd.device}")
    if V % _CPT:
        raise ValueError(f"psi_fused: V={V} must be a multiple of {_CPT}")
    lib = build.load("psi", _SIGNATURES)
    out = torch.empty((B, K, V), dtype=f32, device=wd.device)
    stream = torch.cuda.current_stream(wd.device).cuda_stream
    rc = lib.psi_launch(wd.data_ptr(), probs.data_ptr(),
                        int(probs.dtype == torch.bfloat16), md.data_ptr(),
                        psi_same.data_ptr(), last_tok.data_ptr(),
                        out.data_ptr(), B, K, T, V, blank, stream)
    build.check(rc, "psi_fused launch")
    psi_fused.launches += 1
    return out


psi_fused.launches = 0
