"""RNN-LM training through ``main --lm``'s solver: ``solvers/train_lm.py``
``Solver.train_step`` on each batch of the pool, fed by
``parallel/mesh.prefetch_to_device``; the work is the batch's true
(unpadded) tokens. See ``train.py`` for the set-up and the check."""
from __future__ import annotations

from .. import work
from ..reference import lm as lm_ref
from .train import TrainDriver


class Driver(TrainDriver):
    keys = ("text", "text_len")

    def leaves(self):
        cfg = self.cell.config
        return lm_ref.leaves(cfg["model"], cfg["vocab"])

    def build_solver(self):
        from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import Solver
        cfg = self.cell.config
        s = Solver({k: cfg[k] for k in ("data", "model", "hparas")},
                   self.cell.paras(cfg["name"]))
        s.vocab_size, s.tokenizer = cfg["vocab"], self.tok
        s.set_model()
        return s

    def solver_module(self):
        return self.solver.lm

    def work(self, batch) -> float:
        return float(batch["text_len"].sum())

    def counts(self, unit):
        cfg = self.cell.config
        dtype = 2 if cfg["precision"]["train"] == "bf16" else 4
        return {"flops": work.lm_train_flops(cfg, unit["text_len"]),
                "scans": work.lm_scans(cfg["model"], unit["text_len"], dtype,
                                       2)}

    def reference_step(self, nm, p, batch, gen, step):
        cfg = self.cell.config["model"]
        text, text_len = batch["text"].long(), batch["text_len"].long()
        u = lm_ref.draws(cfg, *text.shape, gen, text.device)
        total, count = lm_ref.nll(nm, p, cfg, text, text_len, u)
        loss = total / count.clamp(min=1.0)
        loss.backward()
        return {"loss": float(loss.detach())}
