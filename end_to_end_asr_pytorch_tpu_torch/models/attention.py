"""Attention for the decoders and the training label scan: scaled-dot and
location-aware.

Modes ``'dot' | 'loc'``, multi-head (``num_head``, merged by ``w_merge``),
softmax ``temperature`` and optional value projection (``v_proj``), as in
the JAX package. Key/value projections are computed once per utterance
(``precompute``); ``step_beam`` advances K hypotheses against the
unexpanded (B, ...) cache and ``step`` one hypothesis (the differentiable
step of the teacher-forced label scan and of greedy decoding).

Two config keys fuse the 'loc' energy chain (location features, query + key
sum, tanh, energy, masked softmax, context) into one call, under the JAX
package's own gates. ``use_pallas: true`` sends ``step_beam`` through K5
(``ops/cuda/att_kernel.py``) when ``num_head == 1`` and ``v_proj``.
``use_pallas_train: true`` sends ``step`` through ``LocAttTrain``
(``ops/cuda/att_train_kernel.py``: K7 forward and hand-written backward)
when also there is no ``w_merge``. The kernels run for CUDA tensors (unless
``cuda.USE_KERNELS`` is off); CPU tensors take their plain versions through
the same calls, and ``LocAttTrain`` keeps its hand-written backward there
too. A config outside a gate runs the plain chain, as in the JAX package.

The location features are a plain ``F.conv1d`` over the summed previous
alignment. XLA's ``SAME`` padding for an even kernel is asymmetric (low
``(ks-1)//2``, high ``ks//2``), so the alignment is padded explicitly; a
symmetric ``padding=`` would drop a frame. The JAX package's lane padding
of the head dim (``d_pad``, ``pad_lanes``) and Toeplitz band are TPU layout
devices that change no number and are not carried over.

Amp: ``precompute(..., amp=True)`` stores keys and values in bf16, and
the plain chain then runs in the cache dtype (the (B, K, H, T, d) tanh
argument is bf16) while the energies, the softmax and the context
accumulate in f32. ``step_beam`` computes the location features in f32,
as the JAX package's f32 Toeplitz band of the beam step does; ``step``
(the training label scan and greedy decoding) convolves in the cache's
dtype, as the JAX package's training ``step`` convolves in its bf16
``loc_conv``'s: under amp training the summed alignment and the features
are rounded to bf16. K5 is f32 only: under ``use_pallas`` the keys and
values are widened to f32 for it, as the JAX package does. Under
``use_pallas_train`` with a bf16 cache (amp training) ``step`` hands
``LocAttTrain`` bf16 inputs, as the JAX package hands its kernel: the query
projection plus bias and the projected location features (convolved in
bf16) each summed in f32 and rounded to bf16, and ``v_energy`` rounded; on
the card they run K7's bf16 variant. Gradients reach the f32 parameters
through those roundings (``ops/amp.bf16_call``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import cuda as cuda_kernels
from ..ops.amp import dot_f32, tanh as amp_tanh
from ..ops.cuda.att_kernel import loc_attention_fused, loc_attention_plain
from ..ops.cuda.att_train_kernel import LocAttTrain
from ..utils.init import const, uniform


class AttCache(NamedTuple):
    keys: torch.Tensor      # (B, H, T, dim) projected keys
    values: torch.Tensor    # (B, T, H*v_dim) or raw enc (B, T, Dk)
    mask: torch.Tensor      # (B, T) bool valid
    inv_len: torch.Tensor   # (B, 1) 1/enc_len


class Attention(nn.Module):
    """Parameters as in the JAX package: w_q (Dq, H*dim), w_k (Dk, H*dim),
    w_v (Dk, H*v_dim) | None, w_merge (H*v_dim, v_dim) | None, and for 'loc'
    loc_conv (F, 1, ks) (torch conv1d layout), w_f (F, dim), bias (H*dim,),
    v_energy (H, dim)."""

    def __init__(self, cfg: Dict[str, Any], query_dim: int, key_dim: int,
                 generator=None, device=None):
        super().__init__()
        self.mode = cfg.get("mode", "loc")
        if self.mode not in ("dot", "loc"):
            raise NotImplementedError(f"attention mode {self.mode!r}")
        self.num_head = int(cfg.get("num_head", 1))
        self.dim = int(cfg.get("dim", 300))
        self.temperature = float(cfg.get("temperature", 0.5))
        self.v_proj = bool(cfg.get("v_proj", True))
        self.loc_kernel_size = int(cfg.get("loc_kernel_size", 100))
        self.loc_kernel_num = int(cfg.get("loc_kernel_num", 10))
        self.use_pallas = bool(cfg.get("use_pallas", False))
        self.use_pallas_train = bool(cfg.get("use_pallas_train", False))
        self.query_dim = query_dim
        self.key_dim = key_dim
        self.v_dim = self.dim if self.v_proj else key_dim
        self.context_dim = self.v_dim
        H, d = self.num_head, self.dim
        g, dev = generator, device
        self.w_q = uniform((query_dim, H * d), query_dim, g, dev)
        self.w_k = uniform((key_dim, H * d), key_dim, g, dev)
        self.w_v = (uniform((key_dim, H * self.v_dim), key_dim, g, dev)
                    if self.v_proj else None)
        self.w_merge = (uniform((H * self.v_dim, self.v_dim), H * self.v_dim,
                                g, dev) if H > 1 else None)
        self.loc_conv = self.w_f = self.bias = self.v_energy = None
        if self.mode == "loc":
            ks, nf = self.loc_kernel_size, self.loc_kernel_num
            self.loc_conv = uniform((nf, 1, ks), ks, g, dev)
            self.w_f = uniform((nf, d), nf, g, dev)
            self.bias = const(H * d, 0.0, dev)
            self.v_energy = uniform((H, d), d, g, dev)

    def precompute(self, enc: torch.Tensor, enc_len: torch.Tensor,
                   amp: bool = False) -> AttCache:
        """enc (B, T, Dk), enc_len (B,) -> cached projections (bf16 keys and
        values under ``amp``)."""
        B, T, _ = enc.shape
        keys = dot_f32(enc, self.w_k).reshape(B, T, self.num_head, self.dim)
        keys = keys.permute(0, 2, 1, 3)
        vals = dot_f32(enc, self.w_v) if self.w_v is not None else enc
        if amp:
            keys = keys.to(torch.bfloat16)
            vals = vals.to(torch.bfloat16)
        mask = torch.arange(T, device=enc.device)[None, :] < enc_len[:, None]
        inv_len = 1.0 / torch.clamp(enc_len, min=1).to(torch.float32)
        return AttCache(keys, vals, mask, inv_len[:, None])

    def init_align(self, cache: AttCache) -> torch.Tensor:
        """Alignment 'before step 0': uniform over valid frames (B, H, T)."""
        B, H, T, _ = cache.keys.shape
        uni = torch.where(cache.mask[:, None, :], cache.inv_len[:, :, None],
                          torch.zeros((), device=cache.keys.device))
        return uni.expand(B, H, T)

    def loc_features(self, a: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """a (N, T) summed alignment -> (N, T, F) location conv features
        with XLA 'SAME' (low (ks-1)//2, high ks//2) padding, convolved in
        ``dtype`` (the alignment and the kernel cast to it)."""
        ks = self.loc_conv.shape[-1]
        ap = F.pad(a.to(dtype)[:, None, :], ((ks - 1) // 2, ks // 2))
        return F.conv1d(ap, self.loc_conv.to(dtype)).transpose(1, 2)

    def step(self, cache: AttCache, query: torch.Tensor,
             prev_align: torch.Tensor):
        """query (B, Dq), prev_align (B, H, T) ->
        (context (B, context_dim), align (B, H, T)): ``LocAttTrain`` under
        ``use_pallas_train`` (the JAX package's gate), else ``step_beam``
        with one hypothesis, the same arithmetic as the JAX package's
        ``step``."""
        if (self.mode == "loc" and self.use_pallas_train
                and self.num_head == 1 and self.w_v is not None
                and self.w_merge is None):
            # the kernel's inputs in the cache dtype (bf16 under amp), each
            # product summed in f32 first, as the JAX package builds them
            cd = cache.keys.dtype
            q = (dot_f32(query, self.w_q) + self.bias).to(cd)
            f = dot_f32(self.loc_features(prev_align.sum(dim=1), cd),
                        self.w_f).to(cd)
            enc_len = torch.clamp(cache.mask.sum(dim=1, dtype=torch.int32),
                                  min=1)
            use_kernel = query.is_cuda and cuda_kernels.USE_KERNELS
            ctx, align = LocAttTrain.apply(
                q, cache.keys[:, 0], f, self.v_energy[0].to(cd), cache.values,
                enc_len, self.temperature, use_kernel)
            return ctx, align[:, None, :]
        ctx, align = self.step_beam(cache, query[:, None], prev_align[:, None],
                                    loc_dtype=cache.keys.dtype)
        return ctx[:, 0], align[:, 0]

    def step_beam(self, cache: AttCache, query: torch.Tensor,
                  prev_align: torch.Tensor,
                  loc_dtype: torch.dtype = torch.float32):
        """query (B, K, Dq), prev_align (B, K, H, T) ->
        (context (B, K, context_dim), align (B, K, H, T)); the location
        features convolved in ``loc_dtype`` (``step`` passes the cache's)."""
        B, H, T, d = cache.keys.shape
        K = query.shape[1]
        cd = cache.keys.dtype      # f32, or bf16 under decode amp
        q = dot_f32(query, self.w_q).reshape(B, K, H, d)
        if self.mode == "dot":
            energy = torch.einsum("bkhd,bhtd->bkht", q.to(cd).float(),
                                  cache.keys.float())
        elif self.use_pallas and H == 1 and self.w_v is not None:
            fsm = self.loc_features(prev_align.sum(dim=2).reshape(B * K, T))
            use_kernel = query.is_cuda and cuda_kernels.USE_KERNELS
            run = loc_attention_fused if use_kernel else loc_attention_plain
            ctx, align = run(     # K5 is f32 only
                q[:, :, 0] + self.bias, cache.keys[:, 0].float(),
                fsm.reshape(B, K, T, -1).contiguous(), self.w_f,
                self.v_energy[0], cache.values.float(),
                cache.mask.sum(dim=1, dtype=torch.int32), self.temperature)
            return ctx, align[:, :, None, :]
        else:
            a = prev_align.sum(dim=2).reshape(B * K, T)
            f = dot_f32(self.loc_features(a, loc_dtype), self.w_f).reshape(
                B, K, T, d)
            qb = q + self.bias.reshape(H, d)[None, None]
            # the (B, K, H, T, d) chain runs in the cache dtype; the energy
            # reduction accumulates in f32 (JAX: preferred_element_type=f32)
            tanh_arg = (qb.to(cd)[:, :, :, None, :] + cache.keys[:, None]
                        + f.to(cd)[:, :, None, :, :])        # (B, K, H, T, d)
            energy = torch.einsum("bkhtd,hd->bkht", amp_tanh(tanh_arg).float(),
                                  self.v_energy.float())
        energy = energy / self.temperature
        energy = torch.where(cache.mask[:, None, None, :], energy,
                             torch.full((), -1e30, device=energy.device))
        align = torch.softmax(energy, dim=-1)                 # (B, K, H, T)
        # the context: align rounded to the cache dtype, summed in f32
        a_cd = align.to(cd).float()
        if self.w_v is not None:
            vals = cache.values.reshape(B, T, H, self.v_dim)
            ctx = torch.einsum("bkht,bthv->bkhv", a_cd, vals.float())
        else:
            ctx = torch.einsum("bkht,btv->bkhv", a_cd, cache.values.float())
        ctx = ctx.reshape(B, K, H * self.v_dim)
        if self.w_merge is not None:
            ctx = dot_f32(ctx, self.w_merge)
        return ctx, align
