"""ASR training solver, the port of the JAX package's
``solvers/train_asr.py``.

Scheduled teacher forcing (linear ``tf_start -> tf_end`` over ``tf_step``),
loss ``ctc_weight * CTC + (1 - ctc_weight) * CE(ignore pad 0)`` with the
zero-infinity rule (a row whose CTC NLL is ~1e30, no feasible alignment,
adds nothing), curriculum epochs in ascending length order, periodic
``validate()`` with greedy decoding and WER / CER for both heads, the
first ``DEV_N_EXAMPLE`` hypotheses, references and attention alignments
(``align_i`` figures, from the teacher-forced pass) logged to
TensorBoard, and ``best_att.pth`` / ``best_ctc.pth`` / ``latest.pth`` in
the reference layout (directories in the JAX package's orbax layout under
``ckpt_format: orbax``). The CTC term goes through K3 on the card
(``use_pallas_ctc: auto | true``) or the plain autograd CTC (``false``,
and ``auto`` on the CPU); the encoder's LSTMs through K2 / K2b (GRUs
through K4 / K4b). The step runs eagerly, one batch at a time, with no
host synchronisation between progress prints.

``hparas.amp`` or ``--amp`` runs the step's model in bf16, as the JAX
solver's amp ``loss_fn`` does: the f32 front end (K1) feeds features cast
to bf16, every floating parameter is cast to bf16 (``ops/amp.bf16_call``),
the scans take their kernels' bf16 training variants, and the CTC and
attention outputs go back to f32 for the losses (K3 stays f32). The
optimizer, its state and the checkpoints keep the f32 parameters;
validation decodes with the f32 weights, greedily through the lookup
tables, as the JAX solver passes ``amp`` to its greedy decode.

``data.audio.augment`` applies SpecAugment (``ops/augment.py``) to the
front end's features in training steps only, its masks drawn from the
step's generator. ``model.plugin`` adds the embedding regularizer
(``models/plugin.py``): its ``emb_loss`` joins the total, the optimizer
and the checkpoints take its projection (``plugin.w_proj`` /
``plugin.b_proj``), and validation's greedy decode uses its fused
log-probs when ``fuse > 0``.

Under ``torchrun`` (``parallel/mesh.py``) each rank trains on its rows of
the global batch and takes the JAX sharded step's values: the losses
divide by the global batch's counts, the random draws take its shape, the
gradients are summed over the ranks before the clip, and validation
gathers every rank's predictions, so every rank reaches the same rates and
checkpoint decisions (rank 0 writes). With ``model_parallel: M`` the ranks
of a model group share their rows and each holds its part of the split
parameters and their optimizer slots (``parallel/tp.py``); the sums and
gathers above go over the data group, the clip's norm over the model
group too, and ``--load`` cuts the whole checkpoint to the rank's parts.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .base import BaseSolver
from ..data.dataset import load_dataset
from ..decode.greedy import att_greedy, ctc_greedy
from ..models.asr import ASR
from ..models.plugin import plugin_from_config
from ..ops.amp import bf16_call
from ..ops.augment import apply_masks, draw_masks
from ..ops.audio import create_transform
from ..ops.ctc import ctc_loss, ctc_loss_k3
from ..optim import Optimizer
from ..parallel import mesh, tp
from ..utils.metrics import cal_er
from ..utils.jax_ckpt import load_checkpoint, resumed
from ..utils.util import feat_to_fig

DEV_STEP_RATIO = 1.2  # decode-step headroom during validation


def masked_ce(logits: torch.Tensor, targets: torch.Tensor,
              count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy with ignore_index=0 (pad), summed over valid tokens and
    divided by their number, or by ``count`` (the global batch's)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = (targets != 0).to(nll.dtype)
    if count is None:
        count = torch.sum(mask)
    return torch.sum(nll * mask) / torch.clamp(count, min=1.0)


def global_counts(text: torch.Tensor, text_len: torch.Tensor
                  ) -> Optional[torch.Tensor]:
    """The global batch's (rows with a label, label tokens), f32, summed
    over the ranks: the normalisers of ``asr_loss``; ``None`` without a
    process group (each loss counts its own batch)."""
    if not mesh.active():
        return None
    return mesh.all_reduce_sum(torch.stack(
        [(text_len > 0).sum(), (text != 0).sum()]).to(torch.float32))


def asr_loss(ctc_out, enc_len, att_out, text, text_len, ctc_weight: float,
             ctc_loss_fn, counts: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The joint loss of the JAX solver's ``loss_fn``: per-row CTC NLL over
    max(text_len, 1), rows with NLL >= 1e29 dropped, summed over the number
    of rows with a label; plus the masked CE of the attention head. With
    ``counts`` (``global_counts``) both divide by the global batch's
    numbers, so the ranks' losses sum to the global one."""
    valid = text_len > 0
    n_valid = (torch.clamp(valid.sum(), min=1) if counts is None
               else torch.clamp(counts[0], min=1.0))
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=text.device)
    if ctc_out is not None:
        nll = ctc_loss_fn(ctc_out, enc_len, text, text_len)
        per = nll / torch.clamp(text_len, min=1)
        ctc_l = torch.sum(torch.where(valid & (nll < 1e29), per,
                                      torch.zeros_like(per))) / n_valid
        total = total + ctc_weight * ctc_l
        metrics["ctc_loss"] = ctc_l
    if att_out is not None:
        att_l = masked_ce(att_out, text,
                          None if counts is None else counts[1])
        total = total + (1.0 - ctc_weight) * att_l
        metrics["att_loss"] = att_l
    metrics["loss"] = total
    return total, metrics


class Solver(BaseSolver):
    def __init__(self, config, paras):
        super().__init__(config, paras)
        self.best_wer = {"att": 3.0, "ctc": 3.0}
        h = config["hparas"]
        self.max_step = int(h.get("max_step", 1000))
        self.valid_step = int(h.get("valid_step", 500))
        self.tf_start = float(h.get("tf_start", 1.0))
        self.tf_end = float(h.get("tf_end", 1.0))
        self.tf_step = int(h.get("tf_step", 1))
        self.curriculum = int(h.get("curriculum", 0))
        self.amp = bool(getattr(paras, "amp", False) or h.get("amp", False))
        self.aug_cfg = config["data"]["audio"].get("augment")
        self.last_masks = None  # the SpecAugment masks of the last step

    # ----------------------------------------------------------------- data
    def load_data(self):
        (self.tr_set, self.dv_set, self.feat_dim, self.vocab_size,
         self.tokenizer, msg) = load_dataset(self.paras.njobs,
                                             self.curriculum > 0,
                                             **self.shard,
                                             **self.config["data"])
        self.verbose(msg)

    # ---------------------------------------------------------------- model
    def set_model(self):
        dev = self.device
        self.frontend, _ = create_transform(self.config["data"]["audio"],
                                            device=dev)
        init = torch.Generator().manual_seed(self.paras.seed)
        self.model = ASR(self.feat_dim, self.vocab_size, self.config["model"],
                         generator=init, device=dev)
        self.model.requires_grad_(True)
        self.params = dict(self.model.named_parameters())
        self.plugin = plugin_from_config(
            self.config["model"], self.vocab_size, self.model.dec_dim,
            self.tokenizer, torch.Generator().manual_seed(self.paras.seed + 7),
            dev)
        if self.plugin is not None:
            self.plugin.requires_grad_(True)
            self.params.update({f"plugin.{n}": p for n, p in
                                self.plugin.named_parameters()})
        self.ctc_weight = self.model.ctc_weight
        self.optimizer = Optimizer(self.config["hparas"], grad_clip=self.GRAD_CLIP)
        self.optimizer.init(self.params)
        # dropout masks and teacher-forcing coins
        self.gen = torch.Generator(device=dev).manual_seed(self.paras.seed + 1)
        use_k3 = self.config["hparas"].get("use_pallas_ctc", "auto")
        if use_k3 == "auto":
            use_k3 = dev.type == "cuda"
        self.ctc_loss_fn = ctc_loss_k3 if use_k3 else ctc_loss
        n_params = sum(p.numel() for p in self.params.values())
        self.verbose(f"ASR model | ctc_weight {self.ctc_weight} | params "
                     f"{n_params / 1e6:.2f}M | device {dev} | CTC "
                     f"{'K3' if use_k3 else 'plain'} | "
                     f"{'amp (bf16)' if self.amp else 'f32'}"
                     f"{self.parallel_msg()}")
        if self.paras.load:
            ck = load_checkpoint(self.paras.load, self.model, self.plugin)
            if ck["optimizer"] is not None:
                self.optimizer.load_state_dict(ck["optimizer"])
            self.step = ck["global_step"]
            self.verbose(f"Loaded ckpt {self.paras.load} @ step {self.step}"
                         f"{resumed(ck['optimizer'])}")
        self.split = tp.shard_module(self.model)
        tp.shard_slots(self.optimizer, self.split)

    def tf_rate(self) -> float:
        frac = min(max(self.step / max(self.tf_step, 1), 0.0), 1.0)
        return self.tf_start - (self.tf_start - self.tf_end) * frac

    def _to_device(self, batch):
        dev = self.device
        return (torch.from_numpy(batch["wave"]).to(dev),
                torch.from_numpy(batch["wave_len"]).to(dev),
                torch.from_numpy(batch["text"]).to(dev, torch.int64),
                torch.from_numpy(batch["text_len"]).to(dev, torch.int64))

    def train_step(self, wave, wave_len, text, text_len,
                   rows=None) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch: front end, teacher-forced model,
        joint loss, backward, update. Returns device scalars; ``grad_norm``
        is the raw gradient's global norm, taken before the clip. Its parts
        are profiler ranges: ``train.frontend``, the model's ``asr.*``,
        ``train.loss``, ``train.backward``, ``train.optimizer``. Under amp
        the model runs on bf16 features and parameters and its outputs go
        back to f32. ``data.audio.augment`` masks the f32 features first
        (SpecAugment, drawn from the step's generator); the embedding
        plugin adds its ``emb_loss`` on every label step's decoder state.

        Under a process group the batch is this rank's rows (``rows``, the
        loader's ``(lo, hi, total)``): the random draws take the global
        batch's shape, the losses divide by the global counts
        (``train.counts``), and the gradients and the loss metrics are
        summed over the ranks before the optimizer (``train.all_reduce``),
        so every rank takes the world-1 step. Under tensor parallelism the
        forward and the backward run on whole weights (``tp.gathered``)
        and each rank keeps its part of their gradients."""
        tf_rate = self.tf_rate()
        counts = None
        if mesh.active():
            with record_function("train.counts"):
                counts = global_counts(text, text_len)
        with tp.gathered(self.params, self.split):
            with mesh.batch_rows(rows):
                metrics, loss = self._forward_loss(wave, wave_len, text,
                                                   text_len, tf_rate, counts)
            for p in self.params.values():
                p.grad = None
            with record_function("train.backward"):
                loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh.active():
            with record_function("train.all_reduce"):
                metrics = {k: v.clone() for k, v in metrics.items()}
                mesh.all_reduce_grads(self.params, list(metrics.values()))
        with record_function("train.optimizer"):
            metrics["grad_norm"] = self.optimizer.step(self.params)
        metrics["tf_rate"] = torch.tensor(tf_rate)
        return metrics

    def _forward_loss(self, wave, wave_len, text, text_len, tf_rate, counts):
        """(metrics, loss) of the step's forward (see ``train_step``)."""
        with record_function("train.frontend"):
            feat, feat_len = self.frontend(wave, wave_len)
            if self.aug_cfg:
                self.last_masks = draw_masks(feat_len, feat.shape[2],
                                             self.aug_cfg, self.gen)
                feat = apply_masks(feat, self.last_masks)
        args = (feat_len, text.shape[1], tf_rate)
        kw = dict(teacher=text, train=True, generator=self.gen,
                  get_dec_state=self.plugin is not None)
        if self.amp:
            ctc_out, enc_len, att_out, _, dec_states = bf16_call(
                self.model, feat.to(torch.bfloat16), *args, **kw)
            ctc_out = None if ctc_out is None else ctc_out.float()
            att_out = None if att_out is None else att_out.float()
            dec_states = None if dec_states is None else dec_states.float()
        else:
            ctc_out, enc_len, att_out, _, dec_states = self.model(feat, *args,
                                                                  **kw)
        with record_function("train.loss"):
            loss, metrics = asr_loss(ctc_out, enc_len, att_out, text, text_len,
                                     self.ctc_weight, self.ctc_loss_fn, counts)
            if self.plugin is not None:
                metrics["emb_loss"] = self.plugin.loss(
                    dec_states, text, None if counts is None else counts[1])
                loss = loss + metrics["emb_loss"]
                metrics["loss"] = loss
        return metrics, loss

    # ----------------------------------------------------------------- exec
    def exec(self):
        self.verbose(f"Training from step {self.step} to {self.max_step}")
        epoch = 0
        last_t, last_u, utts = time.time(), 0, 0
        while self.step < self.max_step:
            shuffle = epoch >= self.curriculum
            for batch in self.tr_set.epoch_iter(shuffle=shuffle):
                rows = batch.get("rows")
                metrics = self.train_step(*self._to_device(batch), rows=rows)
                utts += (rows[2] if rows else
                         int(np.sum(batch["text_len"] > 0)))
                self.step += 1
                if self.step % self.PROGRESS_STEP == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    now = time.time()
                    rate = (utts - last_u) / max(now - last_t, 1e-9)
                    last_t, last_u = now, utts
                    self.progress(
                        f"loss {m['loss']:.3f} | "
                        f"ctc {m.get('ctc_loss', float('nan')):.3f} | "
                        f"att {m.get('att_loss', float('nan')):.3f} | "
                        f"grad {m['grad_norm']:.2f} | tf {m['tf_rate']:.2f} | "
                        f"{rate:.1f} utt/s")
                    self.write_log("loss", {"tr_" + k: v for k, v in m.items()
                                            if "loss" in k})
                    self.write_log("speed", {"utts_per_sec": rate})
                    self.write_log("tf_rate", {"tf": m["tf_rate"]})
                    self.write_log("grad_norm", {"grad_norm": m["grad_norm"]})
                if self.step % self.valid_step == 0:
                    self.validate()
                    last_t, last_u = time.time(), utts
                if self.step >= self.max_step:
                    break
            epoch += 1
        self.validate()
        self.close()
        return self.best_wer

    # ------------------------------------------------------------- validate
    @torch.no_grad()
    def valid_batch(self, wave, wave_len, text, text_len) -> Dict[str, torch.Tensor]:
        """Greedy predictions, losses and the teacher-forced pass's
        alignments (``att_align`` (B, U, H, T')) of one dev batch; under a
        process group the losses divide by the global batch's counts (the
        ranks' sum to the global loss)."""
        model = self.model
        counts = global_counts(text, text_len)
        feat, feat_len = self.frontend(wave, wave_len)
        U = text.shape[1]
        out = {}
        enc, enc_len = model.encode(feat, feat_len)
        if model.enable_ctc:
            ctc_out = model.ctc_output(enc)
            nll = self.ctc_loss_fn(ctc_out, enc_len, text, text_len)
            out["ctc_pred"] = ctc_greedy(ctc_out)
            valid = (text_len > 0) & (nll < 1e29)
            per = nll / torch.clamp(text_len, min=1)
            n_valid = (torch.clamp((text_len > 0).sum(), min=1)
                       if counts is None else torch.clamp(counts[0], min=1.0))
            out["ctc_loss"] = (torch.sum(torch.where(valid, per, torch.zeros_like(per)))
                               / n_valid)
        if model.enable_att:
            out["att_pred"] = att_greedy(model, enc, enc_len,
                                         int(math.ceil(U * DEV_STEP_RATIO)),
                                         amp=self.amp, plugin=self.plugin)
            # the teacher-forced pass: the attention loss and the figures
            _, _, att_out, att_align, _ = model(feat, feat_len, U, 1.0,
                                                teacher=text)
            out["att_loss"] = masked_ce(att_out, text,
                                        None if counts is None else counts[1])
            out["att_align"] = att_align
        return out

    def validate(self):
        """Dev WER / CER and losses of both heads, means over batches of
        each batch's rate; under a process group each batch's predictions
        are gathered from every rank first, so every rank reaches the same
        rates and the same checkpoint decisions."""
        ers = {"att": [], "ctc": []}
        cers = {"att": [], "ctc": []}
        losses = {"att": [], "ctc": []}
        shown = 0
        for batch in self.dv_set:
            with tp.gathered(self.params, self.split):
                out = self.valid_batch(*self._to_device(batch))
            if shown >= self.DEV_N_EXAMPLE:
                out.pop("att_align", None)     # no figure left to draw
            out = {k: v.cpu().numpy() for k, v in out.items()}
            batch = mesh.gather_batch({**out, **{k: batch[k] for k in (
                "text", "text_len", "text_raw")}})
            out = {k: batch[k] for k in out}
            n_real = int(np.sum(batch["text_len"] > 0))
            truth = batch["text"][:n_real]
            for head in ("att", "ctc"):
                pred = out.get(f"{head}_pred")
                if pred is None:
                    continue
                ers[head].append(cal_er(self.tokenizer, pred[:n_real], truth,
                                        mode="wer", ctc=(head == "ctc")))
                cers[head].append(cal_er(self.tokenizer, pred[:n_real], truth,
                                         mode="cer", ctc=(head == "ctc")))
                losses[head].append(float(out[f"{head}_loss"]))
            pred = out.get("att_pred", out.get("ctc_pred"))
            for i in range(min(n_real, self.DEV_N_EXAMPLE - shown)):
                hyp = self.tokenizer.decode(pred[i].tolist(),
                                            ignore_repeat=("att_pred" not in out))
                self.write_log(f"hyp_{shown}", hyp or "<empty>")
                self.write_log(f"ref_{shown}", batch["text_raw"][i])
                if "att_align" in out:
                    self.write_log(f"align_{shown}",
                                   feat_to_fig(out["att_align"][i, :, 0, :]))
                shown += 1
        msg = []
        for head in ("att", "ctc"):
            if not ers[head]:
                continue
            wer, cer = float(np.mean(ers[head])), float(np.mean(cers[head]))
            self.write_log("wer", {f"dv_{head}": wer})
            self.write_log("cer", {f"dv_{head}": cer})
            self.write_log("loss", {f"dv_{head}": float(np.mean(losses[head]))})
            msg.append(f"{head} WER {wer:.3f} CER {cer:.3f}")
            if wer < self.best_wer[head]:
                self.best_wer[head] = wer
                self.save(f"best_{head}.pth", self.model,
                          optimizer=self.optimizer, global_step=self.step,
                          metrics={"wer": wer, "cer": cer}, plugin=self.plugin)
        self.save("latest.pth", self.model, optimizer=self.optimizer,
                  global_step=self.step,
                  metrics={f"wer_{h}": self.best_wer[h] for h in self.best_wer},
                  plugin=self.plugin)
        self.progress("DEV | " + " | ".join(msg))
