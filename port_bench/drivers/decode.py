"""Offline decoding through ``main --test``'s solver: each batch of the
pool goes through ``parallel/mesh.prefetch_to_device`` into
``solvers/test_asr.py`` ``Solver._run_batch`` (front end K1, the encoder,
``BeamDecoder.forward`` with the recipe's joint CTC / attention / LM beam,
the n-best texts), and is scored by ``utils/metrics.error_rates`` as
``_decode_set`` scores it; nothing is written to disk.

Set-up makes the ASR and LM weights on the card from the seed (the CTC,
character and LM heads scaled by the configuration's ``head_gain``, so
that they are peaked as a trained model's are and one token moves a score
well past the limits), writes the LM where the recipe's ``decode.lm_path`` reads it (the run's
scratch directory), and runs every batch of the pool once through a few
beam steps. The check takes a seeded sample of the window's finished
utterances: the plain reference (``reference/las.py``) rescores every
hypothesis of their n-best lists, and the served scores are held to its
scores, each alone and against the rest of its list.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import numpy as np
import torch
import yaml

from .. import cell as C, work
from ..reference import las, lm as lm_ref
from ..reference.numerics import Numerics
from ..reference.rnn import draw_weights
from ..traffic import cycle, make_pool, vocab

WAVE_KEYS = ("wave", "wave_len")
SAMPLE_UTTS = 16      # utterances checked per run, the longest among them
WARM_LEN_RATIO = 0.02  # the beam's length limit in warm-up: a few steps
MISSING = {"score_gap": float("inf"), "nbest_gap": float("inf")}


class Driver:

    def __init__(self, cell: C.Cell):
        self.cell = cell
        self.units: List[Dict[str, Any]] = []
        self.fault = None     # a fault planted for the check's own tests

    # ---------------------------------------------------------------- set-up
    def weights(self):
        cfg = self.cell.config
        lm_cfg = self.cell.configs[cfg["lm"]]
        dev = self.cell.device
        w = draw_weights(las.leaves(cfg["model"], cfg["feat_dim"], cfg["vocab"]),
                         C.derive(self.cell.seed, 1), dev)
        lw = draw_weights(lm_ref.leaves(lm_cfg["model"], cfg["vocab"]),
                          C.derive(self.cell.seed, 2), dev)
        g = cfg["head_gain"]              # peaked heads, as trained ones are
        for leaves_, name, key in ((w, "ctc_w", "ctc"), (w, "char_w", "char"),
                                   (lw, "out_w", "lm")):
            leaves_[name].mul_(float(g[key]))
        return w, lw

    def setup(self):
        from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM
        from end_to_end_asr_pytorch_tpu_torch.solvers.test_asr import Solver
        from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import (
            save_checkpoint)
        cell, cfg = self.cell, self.cell.config
        lm_cfg = cell.configs[cfg["lm"]]
        self.tok = C.tokenizer()
        self.pool = make_pool(cell.mix, cell.seed, self.tok, cell.device)
        w, lw = self.weights()
        lm = RNNLM(cfg["vocab"], lm_cfg["model"], device=cell.device)
        C.assign(lm, lw)
        lm_yaml = cell.tmp / "lm.yaml"
        lm_yaml.write_text(yaml.safe_dump(
            {k: lm_cfg[k] for k in ("data", "model", "hparas")}))
        save_checkpoint(cell.tmp / "lm.pth", lm)
        del lm, lw
        config = {k: cfg[k] for k in ("data", "model", "hparas")}
        config["decode"] = dict(cfg["decode"], lm_config=str(lm_yaml),
                                lm_path=str(cell.tmp / "lm.pth"))
        s = Solver(config, cell.paras(cfg["name"]), mode="test")
        s.feat_dim, s.vocab_size, s.tokenizer = (cfg["feat_dim"], cfg["vocab"],
                                                 self.tok)
        s.set_model()
        C.assign(s.model, w)
        self.solver = s
        self.order = cycle(len(self.pool), cell.seed)
        self.warm_up()
        self.units = []

    def warm_up(self):
        """Every batch shape of the pool once, each through the front end,
        the encoder and a few beam steps (the beam's limits cut for it):
        every kernel and shape of the window, without decoding whole
        batches."""
        dec = self.solver.decoder
        ratios = dec.min_len_ratio, dec.max_len_ratio
        dec.min_len_ratio, dec.max_len_ratio = 0.0, WARM_LEN_RATIO
        try:
            self._loop(range(len(self.pool)), None)
        finally:
            dec.min_len_ratio, dec.max_len_ratio = ratios

    # ---------------------------------------------------------------- window
    def _feed(self, indices):
        for i in indices:
            b = self.pool[i]
            if self.fault == "half_batch":
                n = len(b["name"]) // 2
                b = {k: v[:n] for k, v in b.items()}
            yield dict(b, pool_index=i)

    @contextlib.contextmanager
    def _frozen_steps(self):
        """The ``frozen`` fault: every beam step of the speller returns the
        decoder state and alignment it was given."""
        from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
        step = ASR.decode_step_beam

        def frozen(model, cache, state, prev_align, *a, **k):
            logits, _, _, ctx = step(model, cache, state, prev_align, *a, **k)
            return logits, state, prev_align, ctx

        ASR.decode_step_beam = frozen
        try:
            yield
        finally:
            ASR.decode_step_beam = step

    def _loop(self, indices, deadline):
        from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
        from end_to_end_asr_pytorch_tpu_torch.utils.metrics import error_rates
        s = self.solver
        feed = mesh.prefetch_to_device(self._feed(indices), self.cell.device,
                                       keys=WAVE_KEYS)
        frozen = (self._frozen_steps() if self.fault == "frozen"
                  else contextlib.nullcontext())
        with contextlib.closing(feed), frozen:
            for dev, batch in feed:
                out = s._run_batch(dev, batch)
                rows = [i for i in range(len(batch["name"]))
                        if batch["text_len"][i] != 0]
                hyps = [out["best"][i] for i in rows]
                refs = [batch["text_raw"][i] for i in rows]
                error_rates(hyps, refs, "wer")
                error_rates(hyps, refs, "cer")
                if self.fault == "alter_token":   # every best hypothesis
                    for cands in out["nbest"]:
                        text, score = cands[0]
                        cands[0] = (("b" if text[:1] == "a" else "a")
                                    + text[1:], score)
                self.units.append({
                    "t": time.perf_counter(), "pool_index": batch["pool_index"],
                    "work": float(np.sum(batch["wave_len"])) / 16000.0,
                    "wave_len": batch["wave_len"].tolist(),
                    "steps": int(s.decoder.last_steps),
                    "shape": tuple(batch["wave"].shape),
                    "nbest": out["nbest"]})
                if deadline is not None and time.perf_counter() >= deadline:
                    break

    def counts(self, u) -> Dict[str, Any]:
        """A batch's model FLOPs and scan calls (``work.py``)."""
        cfg = self.cell.config
        half = cfg["precision"]["decode"] == "bf16"
        return {"flops": work.decode_flops(
                    cfg, self.cell.configs[cfg["lm"]], u["wave_len"],
                    int(cfg["decode"]["beam_size"]), u["steps"]),
                "scans": work.encoder_scans(cfg["model"], u["wave_len"],
                                            2 if half else 4)}

    def window(self, seconds: float):
        t0 = time.perf_counter()
        self.units = []
        self._loop(self.order, t0 + seconds)
        return t0

    def close(self):
        """Free the program's state before the reference runs."""
        self.solver = None

    # ----------------------------------------------------------------- check
    def sample(self):
        """(pool index, row) of SAMPLE_UTTS utterances finished in the
        window, drawn from the seed, the longest among them."""
        done = {}
        for ui, u in enumerate(self.units):
            for r in range(self.cell.mix["batch"]):
                done[(u["pool_index"], r)] = ui
        keys = sorted(done)
        longest = max(keys, key=lambda k: int(self.pool[k[0]]["wave_len"][k[1]]))
        rng = np.random.Generator(np.random.PCG64(C.derive(self.cell.seed, 3)))
        pick = [keys[i] for i in rng.choice(len(keys), min(len(keys),
                                                           SAMPLE_UTTS - 1),
                                            replace=False)]
        return sorted(set(pick + [longest])), done

    @staticmethod
    def _ids(text: str):
        """A hypothesis's text back to token ids (``<unk>`` is id 2)."""
        table = {c: i for i, c in enumerate(vocab())}
        out, i = [], 0
        while i < len(text):
            if text.startswith("<unk>", i):
                out.append(2)
                i += 5
                continue
            c = "<space>" if text[i] == " " else text[i]
            if c not in table or table[c] < 3:
                raise ValueError(f"hypothesis piece {text[i]!r}")
            out.append(table[c])
            i += 1
        return out

    def readings(self, mode: str = "f32") -> Dict[str, float]:
        """Over the sample, with d the gap between a served hypothesis's
        score and the reference's score of the same tokens: the widest
        |d| (``score_gap``), and the widest departure of d from the median
        d of its utterance's n-best (``nbest_gap``: the list's scores
        against each other, where the rounding that the hypotheses share
        cancels, so that one wrong token or a score paired with another
        hypothesis stands out); both inf where an answer is missing or
        holds a piece outside the vocabulary. With a control ``mode``: the
        reference in that precision, its scores of the same hypotheses, in
        the program's place."""
        cfg = self.cell.config
        lm_cfg = self.cell.configs[cfg["lm"]]
        dev = self.cell.device
        d = cfg["decode"]
        wts = (1.0 - float(d["ctc_weight"]), float(d["ctc_weight"]),
               float(d["lm_weight"]))
        w, lw = self.weights()
        pick, done = self.sample()
        K = int(d["beam_size"])
        hyps, served = [], []
        for pi, r in pick:
            nbest = self.units[done[(pi, r)]]["nbest"]
            cands = nbest[r] if r < len(nbest) else []
            if len(cands) != K:
                return dict(MISSING)
            try:
                hyps += [self._ids(text) for text, _ in cands]
            except ValueError:
                return dict(MISSING)
            served += [float(s) for _, s in cands]
        utt = torch.arange(len(pick), device=dev).repeat_interleave(K)
        args = (w, cfg, lw, lm_cfg)
        with torch.no_grad():
            scores = {m: self._call(las.hypothesis_scores, m, *args,
                                    self._encoded(Numerics(m), w, pick), utt,
                                    hyps, wts)
                      for m in {"f32", mode}}
        other = (torch.tensor(served, device=dev) if mode == "f32"
                 else scores[mode])
        gap = (other - scores["f32"]).view(len(pick), K).double()
        return {"score_gap": float(gap.abs().max()),
                "nbest_gap": float((gap - gap.median(1, keepdim=True).values)
                                   .abs().max())}

    def _encoded(self, nm, w, pick):
        """The sampled utterances through the reference's encoder, each
        pool batch at its own padded width, as one batch in ``pick``'s
        order."""
        cfg, dev = self.cell.config, self.cell.device
        parts = []
        for pi in sorted({p for p, _ in pick}):
            rows = [r for p, r in pick if p == pi]
            b = self.pool[pi]
            with nm.flags():
                parts.append(las.Encoded.of(
                    nm, w, cfg["model"], cfg["data"]["audio"],
                    torch.as_tensor(b["wave"][rows], device=dev),
                    torch.as_tensor(b["wave_len"][rows], device=dev)))
        return las.Encoded.cat(parts)

    @staticmethod
    def _call(fn, mode, w, cfg, lw, lm_cfg, *rest):
        nm = Numerics(mode)
        with nm.flags():
            return fn(nm, w, cfg["model"], lw, lm_cfg["model"], *rest)
