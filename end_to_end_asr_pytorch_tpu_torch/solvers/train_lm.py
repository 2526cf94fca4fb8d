"""RNN-LM training solver (``main --lm``), the port of the JAX package's
``solvers/train_lm.py``.

Text-only data (``data/dataset.load_textset``: a corpus's transcripts or
``.txt`` sentence files), next-token cross-entropy (the input is ``[<sos>,
t_0 .. t_{U-2}]``, the target the text with its ``<eos>``; the loss the
NLL's sum over the valid tokens divided by their count), the configured
optimizer with its gradient clip, perplexity logged every
``PROGRESS_STEP`` (``tr``) and at every ``valid_step`` (``dv``), and
``best_ppx.pth`` / ``latest.pth`` in the reference layout, which the
decode solver's ``decode.lm_path`` reads. Each layer's scan goes through
K2 / K2b (LSTM) or K4 / K4b (GRU) on the card. Training runs in f32, as
the JAX solver's does: ``--amp`` and ``hparas.amp`` are ignored. Under
``torchrun`` each rank trains on its rows of the global batch, the NLL
divides by the global token count, the gradients are summed, and the dev
perplexity sums every rank's NLL and tokens; with ``model_parallel: M``
each rank holds its part of the split parameters and slots, as the ASR
solver's (``parallel/tp.py``), and those sums go over the data group.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .base import BaseSolver
from ..data.dataset import load_textset
from ..models.lm import RNNLM
from ..optim import Optimizer
from ..parallel import mesh, tp
from ..utils.jax_ckpt import load_checkpoint, resumed
from ..utils.text import EOS_IDX


def lm_nll(lm: RNNLM, text: torch.Tensor, text_len: torch.Tensor,
           train: bool = False, generator=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token NLL of ``text`` (B, U) with lengths ``text_len``: the
    input is ``[<sos>, t_0 .. t_{U-2}]``, the target ``text``. Returns
    (the NLL summed over the valid tokens, their count), both f32."""
    B, U = text.shape
    sos = torch.full((B, 1), EOS_IDX, dtype=text.dtype, device=text.device)
    logits = lm(torch.cat([sos, text[:, :-1]], dim=1), text_len, train=train,
                generator=generator)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, text[..., None])[..., 0]
    mask = (torch.arange(U, device=text.device)[None, :]
            < text_len[:, None]).to(nll.dtype)
    return torch.sum(nll * mask), torch.sum(mask)


class Solver(BaseSolver):
    def __init__(self, config, paras):
        super().__init__(config, paras)
        h = config["hparas"]
        self.max_step = int(h.get("max_step", 1000))
        self.valid_step = int(h.get("valid_step", 500))
        self.best_ppx = float("inf")
        if getattr(paras, "amp", False) or h.get("amp", False):
            self.verbose("amp is ignored: the RNN-LM trains in f32")

    def load_data(self):
        (self.tr_set, self.dv_set, self.vocab_size, self.tokenizer,
         msg) = load_textset(self.config["data"]["corpus"],
                             self.config["data"]["text"], **self.shard)
        self.verbose(msg)

    def set_model(self):
        dev = self.device
        init = torch.Generator().manual_seed(self.paras.seed)
        self.lm = RNNLM(self.vocab_size, self.config["model"], generator=init,
                        device=dev)
        self.lm.requires_grad_(True)
        self.params = dict(self.lm.named_parameters())
        self.optimizer = Optimizer(self.config["hparas"],
                                   grad_clip=self.GRAD_CLIP)
        self.optimizer.init(self.params)
        self.gen = torch.Generator(device=dev).manual_seed(self.paras.seed + 1)
        n_params = sum(p.numel() for p in self.params.values())
        self.verbose(f"RNN-LM | {self.lm.module.upper()} x{self.lm.n_layers} "
                     f"dim {self.lm.dim} | params {n_params / 1e6:.2f}M | "
                     f"device {dev}{self.parallel_msg()}")
        if self.paras.load:
            ck = load_checkpoint(self.paras.load, self.lm)
            if ck["optimizer"] is not None:
                self.optimizer.load_state_dict(ck["optimizer"])
            self.step = ck["global_step"]
            self.verbose(f"Loaded ckpt {self.paras.load} @ step {self.step}"
                         f"{resumed(ck['optimizer'])}")
        self.split = tp.shard_module(self.lm)
        tp.shard_slots(self.optimizer, self.split)

    def _to_device(self, batch):
        return (torch.from_numpy(batch["text"]).to(self.device, torch.int64),
                torch.from_numpy(batch["text_len"]).to(self.device,
                                                       torch.int64))

    def train_step(self, text, text_len, rows=None) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch; returns device scalars (``loss``,
        and ``grad_norm`` before the clip). Its parts are profiler ranges:
        ``lm.forward``, ``lm.backward``, ``lm.optimizer``. Under a process
        group the batch is this rank's rows (``rows``, as the ASR solver's):
        dropout draws at the global shape, the NLL divides by the global
        token count, and the gradients and the loss are summed over the
        ranks (``lm.all_reduce``) before the optimizer."""
        count = None
        if mesh.active():
            count = mesh.all_reduce_sum(
                (torch.arange(text.shape[1], device=text.device)[None, :]
                 < text_len[:, None]).sum().to(torch.float32))
        with tp.gathered(self.params, self.split):
            with record_function("lm.forward"), mesh.batch_rows(rows):
                total, local = lm_nll(self.lm, text, text_len, True,
                                      self.gen)
                loss = total / torch.clamp(
                    local if count is None else count, min=1.0)
            for p in self.params.values():
                p.grad = None
            with record_function("lm.backward"):
                loss.backward()
        loss = loss.detach()
        if mesh.active():
            with record_function("lm.all_reduce"):
                loss = loss.clone()
                mesh.all_reduce_grads(self.params, [loss])
        with record_function("lm.optimizer"):
            gnorm = self.optimizer.step(self.params)
        return {"loss": loss, "grad_norm": gnorm}

    def exec(self):
        self.verbose(f"LM training from step {self.step} to {self.max_step}")
        t0, toks = time.time(), 0
        while self.step < self.max_step:
            for batch in self.tr_set:
                m = self.train_step(*self._to_device(batch),
                                    rows=batch.get("rows"))
                toks += batch.get("tokens", int(batch["text_len"].sum()))
                self.step += 1
                if self.step % self.PROGRESS_STEP == 0:
                    loss = float(m["loss"])
                    rate = toks / max(time.time() - t0, 1e-9)
                    self.progress(f"lm loss {loss:.3f} | ppx "
                                  f"{math.exp(loss):.1f} | {rate:.0f} tok/s")
                    self.write_log("ppx", {"tr": math.exp(loss)})
                if self.step % self.valid_step == 0:
                    self.validate()
                if self.step >= self.max_step:
                    break
        self.validate()
        self.close()
        return self.best_ppx

    @torch.no_grad()
    def validate(self):
        """Dev perplexity exp(sum NLL / tokens) over the dev set (each
        batch's sums added over the ranks); writes ``best_ppx.pth`` when it
        improves and ``latest.pth`` always."""
        total, count = 0.0, 0.0
        for batch in self.dv_set:
            with tp.gathered(self.params, self.split):
                t, c = lm_nll(self.lm, *self._to_device(batch))
            if mesh.active():
                t, c = mesh.all_reduce_sum(torch.stack([t, c]))
            total += float(t)
            count += float(c)
        ppx = float(np.exp(total / max(count, 1.0)))
        self.write_log("ppx", {"dv": ppx})
        self.progress(f"DEV | lm ppx {ppx:.2f}")
        if ppx < self.best_ppx:
            self.best_ppx = ppx
            self.save("best_ppx.pth", self.lm, optimizer=self.optimizer,
                      global_step=self.step, metrics={"ppx": ppx})
        self.save("latest.pth", self.lm, optimizer=self.optimizer,
                  global_step=self.step, metrics={"ppx": ppx})
