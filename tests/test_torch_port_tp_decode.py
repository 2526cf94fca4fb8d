"""Tensor parallelism of the port's LM training and decoding, and the three
entry points under ``torchrun`` with ``model_parallel: 2``, on the CPU.

An LM step at M=2 (with and without ``emb_tying``, V=14 so the rule splits
the vocabulary leaves) is held to the JAX LM step on ``make_mesh(2,
model_parallel=2)``; beam decoding at M=2 (f32 and amp, LM fused) and amp
greedy decoding through the split lookup tables to the port's world 1;
``main --test`` at M=2 to the JAX package's test solver at
``model_parallel: 2`` (hypotheses identical, scores within 1e-4); and
``torchrun --nproc_per_node=4`` (2 x 2) of ``main``, ``main --lm`` and
``main --test`` to the same runs in one process: one ``log.jsonl`` with
world 1's entries, the same checkpoints, every CSV row once.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.config import load_config as jax_load_config
from end_to_end_asr_pytorch_tpu.data import synthetic as jax_synthetic
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
from end_to_end_asr_pytorch_tpu.optim import Optimizer as JaxOptimizer
from end_to_end_asr_pytorch_tpu.parallel import mesh as pmesh
from end_to_end_asr_pytorch_tpu.solvers.test_asr import Solver as JaxTestSolver
from end_to_end_asr_pytorch_tpu_torch import main as port_main
from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import save_checkpoint
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (lm_from_arrays,
                                                            port_name)
from tests import torch_port_dist as dh
from tests.test_e2e_train import _paras
from tests.test_torch_ckpt import export_asr_state_dict
from tests.test_torch_port_lm_train import _jax_loss_fn
from tests.test_torch_port_parallel import _assert_csvs_equal, _log_entries
from tests.test_torch_port_test_solver import (LM_MODEL, MODEL_CFG,
                                               reference_lm_state_dict)
from tests.torch_port_fixtures import AUDIO_CFG, jax_arrays, to_np, waves

torch.set_num_threads(1)
ADAM = {"optimizer": "Adam", "lr": 1e-3, "eps": 1e-8, "lr_scheduler": "fixed"}
LM_V = 14
TYING = (False, True)


def _lm_cfg(tying):
    return {"module": "LSTM", "dim": 16, "emb_dim": 16, "layer": 2,
            "emb_tying": tying, "dropout": 0.0}


def _text(seed, lens=(11, 7, 16, 1, 5)):
    """Token ids in [3, LM_V) ending in <eos> (1), ragged, padded to 16."""
    rng = np.random.RandomState(seed)
    text = np.zeros((len(lens), 16), np.int32)
    for b, n in enumerate(lens):
        text[b, :n - 1] = rng.randint(3, LM_V, n - 1)
        text[b, n - 1] = 1
    return {"text": text, "text_len": np.asarray(lens, np.int32)}


def _jax_lm_step(cfg, batch):
    """The JAX LM solver's mean NLL and one Adam step on ``make_mesh(2,
    model_parallel=2)``, parameters and optax state placed by its rule."""
    jlm = JaxLM(LM_V, cfg)
    jp = jlm.init(jax.random.PRNGKey(4))
    mm = pmesh.make_mesh(2, model_parallel=2)
    sb = pmesh.shard_batch(mm, pmesh.pad_batch_to(batch, 2))
    pr = pmesh.shard_params(mm, jp)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jlm)))(
        pr, sb["text"], sb["text_len"])
    jopt = JaxOptimizer(ADAM, grad_clip=5.0)
    new, _ = jopt.step(grads, pmesh.shard_params(mm, jopt.init(pr)), pr)
    return jp, float(loss), jax_arrays(new)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A corpus (V=30, so M=2 splits every vocabulary leaf), the JAX
    package's init as reference-layout ASR and LM checkpoints, and the
    JAX LM steps."""
    d = tmp_path_factory.mktemp("tp_decode")
    corpus = jax_synthetic.generate_corpus(str(d / "synth"), n_train=4,
                                           n_dev=3, n_test=3, max_words=2)
    vocab = 3 + len((corpus / "vocab.txt").read_text().split())
    jp = JaxASR(40, vocab, MODEL_CFG).init(jax.random.PRNGKey(11))
    torch.save({"model": export_asr_state_dict(jp), "global_step": 5},
               str(d / "asr.pth"))
    jlp = JaxLM(vocab, LM_MODEL).init(jax.random.PRNGKey(13))
    torch.save({"model": reference_lm_state_dict(jlp)}, str(d / "lm.pth"))
    data = {"corpus": {"name": "synthetic", "path": str(corpus),
                       "train_split": ["train-clean"],
                       "dev_split": ["dev-clean"],
                       "test_split": ["test-clean"], "batch_size": 8},
            "audio": AUDIO_CFG,
            "text": {"mode": "character",
                     "vocab_file": str(corpus / "vocab.txt")}}
    (d / "lm.yaml").write_text(yaml.safe_dump(
        {"data": {k: data[k] for k in ("corpus", "text")}, "model": LM_MODEL,
         "hparas": {}}))
    decode = {"beam_size": 3, "min_len_ratio": 0.0, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3, "amp": False,
              "lm_config": str(d / "lm.yaml"), "lm_path": str(d / "lm.pth")}
    (d / "fix.yaml").write_text(yaml.safe_dump(
        {"data": data, "model": MODEL_CFG, "hparas": {}, "decode": decode,
         "model_parallel": 2}))
    lm = {}
    for tying in TYING:
        jlm_p, loss, new = _jax_lm_step(_lm_cfg(tying), _text(6))
        path = d / f"lm_init_{tying}.pth"
        save_checkpoint(path, lm_from_arrays(LM_V, _lm_cfg(tying),
                                             jax_arrays(jlm_p), device="cpu"))
        lm[tying] = (str(path), loss, new)
    return {"dir": d, "vocab": vocab, "decode": decode, "lm": lm}


def _beam_cfgs(decode):
    return [dict(decode, fused_step=False), dict(decode, amp=True)]


@pytest.fixture(scope="module")
def w2(setup):
    """One world-2 group at M=2: the LM steps, then the decodes."""
    d = setup["dir"]
    w, wl = waves(21, (6000, 4000, 3000))
    jobs = [("tp_lm_steps", (2, dict(_lm_cfg(t), vocab=LM_V), ADAM,
                             [_text(6)], f"{d}/lm{t}", setup["lm"][t][0]))
            for t in TYING]
    dec = (2, AUDIO_CFG, MODEL_CFG, LM_MODEL, setup["vocab"],
           str(d / "asr.pth"), str(d / "lm.pth"), w, wl,
           _beam_cfgs(setup["decode"]), 6)
    jobs.append(("tp_decode", dec))
    res = dh.run_world(dh.tp_jobs, 2, d / "g2", jobs)
    ref = dh.tp_decode(0, 1, 1, *dec[1:])
    return res, ref


@pytest.mark.parametrize("tying", TYING)
def test_lm_step_at_m2_matches_the_jax_tp_step(setup, w2, tying):
    """B=5 sentences (padded to 6): the loss and the parameters after one
    Adam step against the JAX LM solver's on ``make_mesh(2,
    model_parallel=2)``; the two ranks identical; the embedding (and the
    output layer, untied) split by the rule."""
    res = [r[TYING.index(tying)] for r in w2[0]]
    _, loss, ref = setup["lm"][tying]
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        for n, v in res[0]["whole"].items():
            assert torch.equal(r["whole"][n], v), n
    np.testing.assert_allclose(res[0]["losses"][0]["loss"], loss, rtol=1e-5)
    assert len(res[0]["whole"]) == len(ref)
    for path, v in ref.items():
        name = port_name(path)
        np.testing.assert_allclose(to_np(res[0]["whole"][name]), v,
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    want = {"embed", "out_b", "cells.0.w_ih", "cells.1.w_hh"}
    if not tying:
        want.add("out_w")
    assert want <= set(res[0]["split"])


def test_beam_and_amp_greedy_at_m2_equal_world1(w2):
    """Beam decoding with the LM fused (f32, K8's plain tail; and amp with
    its bf16 lookup tables) and amp greedy decoding at M=2: tokens and
    lengths identical to world 1's, scores within 1e-5."""
    res, ref = w2
    got = res[0][2]
    assert {"ctc_w", "char_w", "embed", "lm.embed", "lm.out_w"} <= set(
        got["split"])
    for r in res[1:]:
        for a, b in zip(r[2]["beams"], got["beams"]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    for (t, ln, sc), (rt, rln, rsc) in zip(got["beams"], ref["beams"]):
        assert torch.equal(t, rt) and torch.equal(ln, rln)
        torch.testing.assert_close(sc, rsc, rtol=1e-5, atol=1e-5)
    assert torch.equal(got["greedy"], ref["greedy"])


def test_main_test_at_m2_matches_the_jax_solver_at_model_parallel_2(
        setup, tmp_path):
    """``main --test`` with ``model_parallel: 2`` at world 2 (the ASR and
    the LM split, both ranks decoding every row) against the JAX test
    solver with the same key (a 4 x 2 mesh): the CSVs' hypotheses
    identical, scores within 1e-4, each row written once."""
    d = setup["dir"]
    paras = _paras(d / "jax", "fix", load=str(d / "asr.pth"))
    paras.test = True
    solver = JaxTestSolver(jax_load_config(str(d / "fix.yaml")), paras,
                           "test")
    solver.load_data()
    solver.set_model()
    solver.exec()
    ref = {f.name: f.read_text()
           for f in sorted((d / "jax" / "out" / "fix_sd0").glob("*.csv"))}
    out = tmp_path / "out"
    dh.run_world(dh.run_main, 2, tmp_path / "w2", [
        "--config", str(d / "fix.yaml"), "--test", "--cpu", "--load",
        str(d / "asr.pth"), "--outdir", str(out)])
    got = {f.name: f.read_text()
           for f in sorted((out / "fix_sd0").glob("*.csv"))}
    _assert_csvs_equal(got, ref)
    assert len(got["dev_output.csv"].strip().split("\n")) == 1 + 3


def _torchrun(argv, cwd, n=4, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n}", "-m", "end_to_end_asr_pytorch_tpu_torch.main",
         *argv, "--cpu"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_torchrun_2x2_main_lm_and_test_on_the_cpu(tmp_path, capsys):
    """``torchrun --nproc_per_node=4 ... --cpu`` with ``model_parallel: 2``
    (2 data x 2 model): ``main`` (2 steps and a validation), ``main --lm``
    and ``main --test`` against the same runs in one process: the same log
    entries written once, the same parameters and optimizer slots in every
    checkpoint (whole tensors), the same CSVs with each row once."""
    corpus = jax_synthetic.generate_corpus(str(tmp_path / "c"), n_train=5,
                                           n_dev=3, n_test=3, max_words=2)
    las = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    las["data"]["corpus"].update(path=str(corpus), batch_size=3)
    las["data"]["text"]["vocab_file"] = str(corpus / "vocab.txt")
    las["model"]["encoder"].update(dim=[16, 16], dropout=[0.2, 0.2])
    las["model"]["attention"].update(dim=8, loc_kernel_size=6,
                                     loc_kernel_num=2)
    las["model"]["decoder"]["dim"] = 16
    las["hparas"].update(max_step=2, valid_step=2, PROGRESS_STEP=1,
                         tf_start=0.8, tf_end=0.8)
    lm = yaml.safe_load((ROOT / "config/synthetic/lm.yaml").read_text())
    lm["data"]["corpus"].update(path=str(corpus), batch_size=3,
                                train_split=["train-clean"],
                                dev_split=["dev-clean"])
    lm["data"]["text"]["vocab_file"] = str(corpus / "vocab.txt")
    lm["model"].update(dim=16, emb_dim=16, dropout=0.2)
    lm["hparas"].update(max_step=2, valid_step=2, PROGRESS_STEP=1)
    las["decode"].update(beam_size=2)
    runs = {}
    for world in (1, 4):
        w = tmp_path / f"w{world}"
        w.mkdir()
        if world > 1:
            las["model_parallel"] = lm["model_parallel"] = 2
        (w / "lm.yaml").write_text(yaml.safe_dump(lm))
        las["decode"].update(lm_config=str(w / "lm.yaml"), lm_path=str(
            w / "ckpt" / "lm_sd0" / "best_ppx.pth"))
        (w / "las.yaml").write_text(yaml.safe_dump(las))
        dirs = ["--logdir", str(w / "log"), "--ckpdir", str(w / "ckpt"),
                "--outdir", str(w / "out")]
        steps = [[*dirs, "--config", str(w / "las.yaml")],
                 [*dirs, "--config", str(w / "lm.yaml"), "--lm"],
                 [*dirs, "--config", str(w / "las.yaml"), "--test", "--load",
                  str(w / "ckpt" / "las_sd0" / "latest.pth")]]
        for argv in steps:
            if world == 1:
                port_main.main([*argv, "--cpu"])
            else:
                out = _torchrun(argv, tmp_path)
                assert out.count("[device] cpu (cpu) | world 4 (gloo)") == 1
                assert "tensor parallel 2x2" in out
        runs[world] = w
    capsys.readouterr()
    w1, w4 = runs[1], runs[4]
    for exp in ("las_sd0", "lm_sd0"):
        assert (_log_entries(w4 / "log" / exp / "log.jsonl")
                == _log_entries(w1 / "log" / exp / "log.jsonl")), exp
    for exp, files in (("las_sd0", ("latest.pth", "best_att.pth")),
                       ("lm_sd0", ("latest.pth", "best_ppx.pth"))):
        for f in files:
            a = torch.load(w1 / "ckpt" / exp / f, weights_only=True)
            b = torch.load(w4 / "ckpt" / exp / f, weights_only=True)
            assert a["global_step"] == b["global_step"] == 2
            for key in ("model", "optimizer"):
                sa = a[key] if key == "model" else a[key]["slots"]
                sb = b[key] if key == "model" else b[key]["slots"]
                assert sorted(sa) == sorted(sb)
                for n in sa:
                    pairs = ([(sa[n], sb[n])] if key == "model" else
                             [(sa[n][s], sb[n][s]) for s in sa[n]])
                    for x, y in pairs:
                        assert x.shape == y.shape, n
                        np.testing.assert_allclose(
                            to_np(y), to_np(x), rtol=1e-4, atol=1e-6,
                            err_msg=n)
    got = {f.name: f.read_text()
           for f in sorted((w4 / "out" / "las_sd0").glob("*.csv"))}
    ref = {f.name: f.read_text()
           for f in sorted((w1 / "out" / "las_sd0").glob("*.csv"))}
    _assert_csvs_equal(got, ref)
    for split in ("dev", "test"):
        assert len(got[f"{split}_output.csv"].strip().split("\n")) == 1 + 3
