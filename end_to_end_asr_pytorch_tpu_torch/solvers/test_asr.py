"""Decode solver (``main --test``), the port of the JAX package's
``solvers/test_asr.py``: the dev and test splits decoded in batches with
the ``decode:`` block. Under ``torchrun`` each rank decodes its rows of the
global batch (``corpus.batch_size``, padded with zero-length rows to a
multiple of the world, as the JAX package pads for its mesh); rank 0
gathers every rank's hypotheses and n-best lists and writes them in the
global row order, the dummy rows dropped, and the summary's WER / CER and
K8 launches cover every rank. With ``model_parallel: M`` the ASR and the
LM are split as in training (``parallel/tp.py``), the ranks of a model
group decode the same rows, and the gather goes over the data group, so
every row is written once.

The beam (``decode/beam.py``: joint CTC prefix / attention scores, shallow
fusion of the RNN-LM from ``decode.lm_config`` / ``decode.lm_path`` when
``lm_weight > 0``, of the embedding plugin's fused log-probs when
``model.plugin`` has ``fuse > 0``; each step's tail through K8 within its
scope, see ``decode/beam.py``) decodes models with an attention decoder;
a CTC-only model decodes greedily. The batches come through
``parallel/mesh.prefetch_to_device``, so the next batch's waves are copied
to the card while this one decodes. Rows stream to ``<outdir>/<name>_sd<seed>/{split}_output.csv``
(``idx\\thyp\\ttruth``, the best hypothesis) and ``{split}_beam.csv``
(``idx\\trank\\tscore\\thyp``, the n-best with 4-decimal scores) batch by
batch, and one summary line per split gives WER / CER, throughput, the beam
route and, on the card, K8's launches.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .base import BaseSolver
from ..config import load_config
from ..data.dataset import load_dataset
from ..decode.beam import BeamDecoder
from ..decode.greedy import ctc_greedy
from ..models.asr import ASR
from ..models.lm import RNNLM
from ..models.plugin import plugin_from_config
from ..ops.audio import create_transform
from ..parallel import mesh, tp
from ..utils.jax_ckpt import load_checkpoint
from ..utils.metrics import edit_distance

WAVE_KEYS = ("wave", "wave_len")   # the entries a decode batch reads


class Solver(BaseSolver):
    def __init__(self, config, paras, mode="test"):
        super().__init__(config, paras, mode)
        self.decode_cfg = dict(config.get("decode", {}))
        self.lm_weight = float(self.decode_cfg.get("lm_weight", 0.0))

    def load_data(self):
        (self.dv_set, self.tt_set, self.feat_dim, self.vocab_size,
         self.tokenizer, msg) = load_dataset(self.paras.njobs, False,
                                             mode="test", **self.shard,
                                             **self.config["data"])
        self.verbose(msg)

    def set_model(self):
        dev = self.device
        self.frontend, _ = create_transform(self.config["data"]["audio"],
                                            device=dev)
        init = torch.Generator().manual_seed(self.paras.seed)
        self.model = ASR(self.feat_dim, self.vocab_size, self.config["model"],
                         generator=init, device=dev)
        # the embedding plugin: fused decoding when its fuse > 0
        self.plugin = (plugin_from_config(
            self.config["model"], self.vocab_size, self.model.dec_dim,
            self.tokenizer, torch.Generator().manual_seed(7), dev)
            if self.model.enable_att else None)
        if self.paras.load:
            ck = load_checkpoint(self.paras.load, self.model, self.plugin)
            self.verbose(f"Loaded ASR ckpt {self.paras.load} ({ck['format']}) "
                         f"@ step {ck['global_step']}")
        self.lm = None
        if self.lm_weight > 0:
            lm_cfg = load_config(self.decode_cfg["lm_config"])
            self.lm = RNNLM(self.vocab_size, lm_cfg["model"], device=dev)
            load_checkpoint(self.decode_cfg["lm_path"], self.lm)
            self.verbose(f"Loaded LM ckpt for shallow fusion "
                         f"(weight {self.lm_weight})")
        self.params = dict(self.model.named_parameters())
        self.split = tp.shard_module(self.model)
        if self.lm is not None:
            self.params.update({f"lm.{n}": p
                                for n, p in self.lm.named_parameters()})
            self.split.update(tp.shard_module(self.lm, "lm."))
        if self.split:
            self.verbose("Decode" + self.parallel_msg())
        self.decoder = (BeamDecoder(self.model, self.decode_cfg, self.lm,
                                    plugin=self.plugin)
                        if self.model.enable_att else None)

    @torch.no_grad()
    def exec(self):
        for name, dataset in (("dev", self.dv_set), ("test", self.tt_set)):
            self._decode_set(name, dataset)

    def _decode_set(self, split_name: str, dataset):
        # rows stream to disk per batch; error rates are running sums
        n_utts = 0
        wer_sum = cer_sum = 0.0
        wer_n = cer_n = 0
        audio_sec = 0.0
        fused = None
        k8 = 0
        t0 = time.time()
        out_file = self.outdir / f"{split_name}_output.csv"
        lead = self.rank == 0
        with contextlib.ExitStack() as files:
            f_out = f_beam = None
            if lead:
                f_out = files.enter_context(open(out_file, "w",
                                                 encoding="utf-8"))
                f_beam = files.enter_context(open(
                    self.outdir / f"{split_name}_beam.csv", "w",
                    encoding="utf-8"))
                f_out.write("idx\thyp\ttruth\n")
                f_beam.write("idx\trank\tscore\thyp\n")
            wrote_nbest = False
            for dev, batch in mesh.prefetch_to_device(dataset, self.device,
                                                      keys=WAVE_KEYS):
                out = self._run_batch(dev, batch)
                out.update({k: batch[k] for k in ("name", "text_raw",
                                                  "text_len", "wave_len")})
                out["k8"] = 0
                if self.decoder is not None:
                    fused = self.decoder.last_fused
                    out["k8"] = self.decoder.last_k8_launches
                out = mesh.gather_batch(out)
                k8 += out["k8"]
                for i in range(len(out["name"])):
                    if out["text_len"][i] == 0:
                        continue
                    name = out["name"][i]
                    ref = out["text_raw"][i]
                    hyp = out["best"][i]
                    if lead:
                        f_out.write(f"{name}\t{hyp}\t{ref}\n")
                        for k, (h, s) in enumerate(out["nbest"][i]):
                            f_beam.write(f"{name}\t{k}\t{s:.4f}\t{h}\n")
                    wrote_nbest = wrote_nbest or bool(out["nbest"][i])
                    e = self._er_one(hyp, ref, "wer")
                    if e is not None:
                        wer_sum += e
                        wer_n += 1
                    e = self._er_one(hyp, ref, "cer")
                    if e is not None:
                        cer_sum += e
                        cer_n += 1
                    audio_sec += float(out["wave_len"][i]) / 16000.0
                    n_utts += 1
            if lead and not wrote_nbest:
                f_beam.write("\n")
        dt = time.time() - t0
        wer = wer_sum / wer_n if wer_n else 0.0
        cer = cer_sum / cer_n if cer_n else 0.0
        route = ("greedy CTC" if self.decoder is None else
                 f"beam {'fused' if fused else 'unfused'} (K8 launches "
                 f"{k8})")
        self.verbose(
            f"{split_name}: {n_utts} utts | WER {wer:.3f} | CER {cer:.3f} | "
            f"{n_utts / dt:.2f} utts/sec | RTF-inverse {audio_sec / dt:.1f}x "
            f"realtime | {route} | wrote {out_file}")
        return {"wer": wer, "cer": cer, "utts_per_sec": n_utts / dt}

    @staticmethod
    def _er_one(h, r, mode):
        hs, rs = (h.split(), r.split()) if mode == "wer" else (list(h),
                                                               list(r))
        if not rs:
            return None
        return edit_distance(hs, rs) / len(rs)

    def _run_batch(self, dev, batch):
        with tp.gathered(self.params, self.split):
            return self._decode_batch(dev, batch)

    def _decode_batch(self, dev, batch):
        """Hypotheses and n-best lists of one batch from its waves on the
        device (``dev``, the prefetcher's); ``batch`` is its host half."""
        feat, feat_len = self.frontend(dev["wave"], dev["wave_len"])
        B = len(batch["name"])
        if self.decoder is not None:
            out = self.decoder.forward(feat, feat_len)
            tokens = out.tokens.cpu().numpy()
            lengths = out.lengths.cpu().numpy()
            scores = out.scores.cpu().numpy()
            best, nbest = [], []
            for i in range(B):
                cands = [(self.tokenizer.decode(
                    tokens[i, k, :lengths[i, k]].tolist()), float(scores[i, k]))
                    for k in range(tokens.shape[1])]
                best.append(cands[0][0])
                nbest.append(cands)
            return {"best": best, "nbest": nbest}
        enc, enc_len = self.model.encode(feat, feat_len)
        ids = ctc_greedy(self.model.ctc_output(enc)).cpu().numpy()
        enc_len = enc_len.cpu().numpy()
        best = [self.tokenizer.decode(ids[i, :enc_len[i]].tolist(),
                                      ignore_repeat=True) for i in range(B)]
        return {"best": best, "nbest": [[(b, 0.0)] for b in best]}
