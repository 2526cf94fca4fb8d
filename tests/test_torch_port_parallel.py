"""Data parallelism of the port (``parallel/mesh.py`` over
``torch.distributed``) on the CPU, in gloo groups of spawned processes
(``tests/torch_port_dist.py``) and under ``torchrun``.

The port's world-W step is held to the JAX package's sharded step on the
conftest's 8-device mesh and to its own world-1 step: the batch is the
global batch (padded with zero-length rows to a multiple of the world),
the losses are normalised over it, the random draws take its shape, and
every rank ends each step with the same parameters. Tolerances as the
port's single-device tests: loss rtol 1e-5; parameters after the
optimizer rtol 1e-4 / atol 1e-6; decode tokens identical, scores within
1e-4 (4 printed decimals).
"""
import copy
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.data import synthetic as jax_synthetic
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from end_to_end_asr_pytorch_tpu.optim import Optimizer as JaxOptimizer
from end_to_end_asr_pytorch_tpu.parallel import mesh as pmesh
from end_to_end_asr_pytorch_tpu.solvers.test_asr import Solver as JaxTestSolver
from end_to_end_asr_pytorch_tpu.solvers.train_asr import masked_ce as jax_masked_ce
from end_to_end_asr_pytorch_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint)
from end_to_end_asr_pytorch_tpu_torch import main as port_main
from end_to_end_asr_pytorch_tpu_torch.data import audio_io, synthetic
from end_to_end_asr_pytorch_tpu_torch.data.dataset import (load_dataset,
                                                           load_textset)
from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    _to_port_layout, asr_from_arrays, lm_from_arrays, port_name)
from tests import torch_port_dist as dist_helpers
from tests.flac_encoder import encode_flac
from tests.test_e2e_train import _paras
from tests.test_torch_ckpt import export_asr_state_dict
from tests.test_torch_port_lm_train import _jax_loss_fn
from tests.test_torch_port_test_solver import (LM_MODEL, MODEL_CFG,
                                               reference_lm_state_dict)
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, VOCAB, jax_arrays,
                                       to_np, waves)

torch.set_num_threads(1)
ADADELTA = {"optimizer": "Adadelta", "lr": 1.0, "eps": 1e-8,
            "lr_scheduler": "fixed", "tf_start": 1.0, "tf_end": 1.0}
ADAM = {"optimizer": "Adam", "lr": 1e-3, "eps": 1e-8, "lr_scheduler": "fixed"}
LENS = (7040, 5600, 3300, 6100, 4000, 2500)


def _batch(seed, lens=LENS, U=8, V=VOCAB):
    """A global numpy batch: ragged waves, labels in [3, V) of ragged
    lengths (one per wave)."""
    w, wl = waves(seed, lens)
    rng = np.random.RandomState(seed + 100)
    text_len = rng.randint(2, U + 1, len(lens)).astype(np.int32)
    text = rng.randint(3, V, (len(lens), U)).astype(np.int32)
    text[np.arange(U)[None, :] >= text_len[:, None]] = 0
    return {"wave": w, "wave_len": wl, "text": text, "text_len": text_len}


def _assert_ranks_identical(results):
    for r in results[1:]:
        assert r["losses"] == results[0]["losses"]
        for n, p in results[0]["params"].items():
            assert torch.equal(r["params"][n], p), n


def _assert_params_close(got, ref):
    assert sorted(got) == sorted(ref)
    for n in ref:
        np.testing.assert_allclose(to_np(got[n]), to_np(ref[n]), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


# ------------------------------------------------------------------ (a)
def test_pad_batch_and_rows_split_the_global_batch():
    """``pad_batch_to`` as the JAX package's (zero-length dummy rows at the
    end, lists padded), and the rank ranges cover the padded batch."""
    batch = {"wave": np.ones((5, 4), np.float32),
             "text_len": np.array([3, 3, 3, 3, 3], np.int32),
             "name": ["a"] * 5, "meta": 7}
    out = mesh.pad_batch_to(batch, 4)
    ref = pmesh.pad_batch_to(batch, 4)
    for k in ("wave", "text_len"):
        np.testing.assert_array_equal(out[k], ref[k])
    assert out["name"] == ["a"] * 5 + [""] * 3 and out["meta"] == 7
    assert mesh.pad_batch_to(batch, 5) is batch
    assert [mesh.row_range(8, r, 4) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="do not split"):
        mesh.row_range(6, 0, 4)
    # without a group every collective is the identity
    assert not mesh.active() and mesh.gather_rows(3) == [3]
    t = torch.ones(3)
    assert mesh.all_reduce_sum(t) is t and torch.equal(t, torch.ones(3))


def test_global_shape_draws_cut_the_rank_rows():
    """Under ``batch_rows`` a draw takes the real rows of the global batch
    (world 1's draw) and a dummy row past them gets zeros."""
    full = torch.rand((5, 3), generator=torch.Generator().manual_seed(1))
    got = []
    for lo, hi in ((0, 2), (2, 4), (4, 6)):
        with mesh.batch_rows((lo, hi, 5)):
            got.append(mesh.rand((2, 3), torch.Generator().manual_seed(1)))
    torch.testing.assert_close(torch.cat(got)[:5], full, rtol=0, atol=0)
    assert torch.equal(got[2][1], torch.zeros(3))
    tm = torch.rand((4, 5), generator=torch.Generator().manual_seed(2))
    with mesh.batch_rows((2, 4, 5)), mesh.time_major():
        u = mesh.rand((4, 2), torch.Generator().manual_seed(2))
    assert torch.equal(u, tm[:, 2:4])
    with mesh.batch_rows((0, 2, 5)), pytest.raises(ValueError, match="rows"):
        mesh.rand((3, 3), torch.Generator())


def _corpus(root, n_train=5, n_dev=3, n_test=3):
    return synthetic.generate_corpus(str(root), n_train=n_train, n_dev=n_dev,
                                     n_test=n_test, max_words=2)


@pytest.mark.parametrize("world", [2, 3])
def test_loaders_give_each_rank_its_rows_of_the_global_batch(tmp_path, world):
    """Every rank walks the world-1 batch order; its rows, joined in rank
    order with the dummy rows dropped, are the world-1 batch, padded to
    the same shape (the global longest wave and label)."""
    corpus = _corpus(tmp_path / "c", n_train=7)
    data = {"corpus": {"name": "synthetic", "path": str(corpus),
                       "train_split": ["train-clean"],
                       "dev_split": ["dev-clean"], "batch_size": 3},
            "audio": AUDIO_CFG,
            "text": {"mode": "character",
                     "vocab_file": str(corpus / "vocab.txt")}}
    ref = list(load_dataset(0, False, **copy.deepcopy(data))[0])
    ranks = [list(load_dataset(0, False, rank=r, world=world,
                               **copy.deepcopy(data))[0])
             for r in range(world)]
    tr, _, _, _, _ = load_textset(data["corpus"], data["text"])
    tr_ranks = [load_textset(data["corpus"], data["text"], r, world)[0]
                for r in range(world)]
    assert len(ref) == 3 and all(len(r) == 3 for r in ranks)
    for i, b in enumerate(ref):
        parts = [r[i] for r in ranks]
        n = len(b["name"])
        for k in ("wave", "wave_len", "text", "text_len"):
            joined = np.concatenate([p[k] for p in parts])
            assert joined.shape[1:] == b[k].shape[1:], k
            np.testing.assert_array_equal(joined[:n].astype(np.float32),
                                          b[k].astype(np.float32), err_msg=k)
            assert not joined[n:].any(), k
        assert sum((p["name"] for p in parts), [])[:n] == b["name"]
        assert [p["rows"] for p in parts] == [
            mesh.row_range(len(parts) * len(parts[0]["name"]), r, world)
            + (n,) for r in range(world)]
    for b, *parts in zip(tr, *tr_ranks):
        n = len(b["text_len"])
        joined = np.concatenate([p["text"] for p in parts])
        np.testing.assert_array_equal(joined[:n], b["text"])
        assert not joined[n:].any()
        assert all(p["tokens"] == int(b["text_len"].sum()) for p in parts)


def test_num_samples_reads_the_length_from_the_header(tmp_path):
    """WAV (mono, stereo, odd chunk sizes), NPY and FLAC lengths read from
    the header equal the decoded lengths, without decoding."""
    rng = np.random.RandomState(0)
    cases = []
    for n in (0, 1, 1601):
        p = tmp_path / f"m{n}.wav"
        audio_io.write_wav(str(p), rng.randn(n) * 0.1)
        cases.append(p)
    stereo = tmp_path / "s.wav"
    pcm = (rng.randn(999, 2) * 1000).astype("<i2").tobytes()
    hdr = (b"RIFF" + (36 + 10 + len(pcm)).to_bytes(4, "little") + b"WAVE"
           + b"fmt " + (16).to_bytes(4, "little")
           + np.array([1, 2], "<u2").tobytes()
           + np.array([16000, 64000], "<u4").tobytes()
           + np.array([4, 16], "<u2").tobytes()
           + b"LIST" + (1).to_bytes(4, "little") + b"x\0"
           + b"data" + len(pcm).to_bytes(4, "little"))
    stereo.write_bytes(hdr + pcm)
    cases.append(stereo)
    npy = tmp_path / "a.npy"
    np.save(npy, rng.randn(777).astype(np.float32))
    cases.append(npy)
    flac = tmp_path / "a.flac"
    flac.write_bytes(encode_flac((rng.randn(3000) * 2000).astype(np.int16)))
    cases.append(flac)
    for p in cases:
        assert audio_io.num_samples(str(p)) == len(
            audio_io.load_audio(str(p))[0]), p.name


# ------------------------------------------------------------------ (b)
def _jax_sharded_step(cfg, seed, batch, hparas):
    """The JAX package's step on the 8-device mesh: params replicated, the
    batch padded to 8 and sharded, the solver's joint loss at tf 1 through
    ``jax.value_and_grad``, then one optimizer step."""
    jm = JaxASR(40, VOCAB, cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    frontend = JaxFrontend(AUDIO_CFG)
    U = batch["text"].shape[1]

    def loss_fn(p, wave, wave_len, text, text_len):
        feat, flen = frontend(wave, wave_len)
        ctc_out, enc_len, att_out, _, _ = jm.forward(
            p, feat, flen, U, 1.0, teacher=text, train=True,
            rng=jax.random.PRNGKey(7))
        valid = text_len > 0
        nll = jax_ctc_loss(ctc_out, enc_len, text, text_len)
        per = nll / jnp.maximum(text_len, 1)
        ctc_l = jnp.sum(jnp.where(valid & (nll < 1e29), per, 0.0)) / \
            jnp.maximum(jnp.sum(valid), 1)
        return 0.5 * ctc_l + 0.5 * jax_masked_ce(att_out, text)

    m8 = pmesh.make_mesh(8)
    sb = pmesh.shard_batch(m8, pmesh.pad_batch_to(batch, 8))
    pr = pmesh.shard_params(m8, jp)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        pr, sb["wave"], sb["wave_len"], sb["text"], sb["text_len"])
    jopt = JaxOptimizer(hparas, grad_clip=5.0)
    new, _ = jopt.step(grads, jopt.init(pr), pr)
    return jp, float(loss), jax_arrays(new)


def test_world4_step_matches_the_jax_sharded_step(tmp_path):
    """B=6 padded to 8 (rank 3 holds only dummy rows): the port's world-4
    step against the JAX step on the 8-device mesh, and every rank's
    parameters bit-identical."""
    model = copy.deepcopy(ASR_CFG)           # a quicker compile on 8 devices
    model["encoder"].update(prenet="", dim=[16], sample_rate=[2])
    batch = _batch(0)
    jp, ref_loss, ref_params = _jax_sharded_step(model, 0, batch, ADADELTA)
    state = asr_from_arrays(40, VOCAB, model, jax_arrays(jp),
                            device="cpu").state_dict()
    cfg = {"audio": AUDIO_CFG, "model": model, "vocab": VOCAB}
    res = dist_helpers.run_world(dist_helpers.asr_steps, 4, tmp_path / "w4",
                                 cfg, ADADELTA, [batch], str(tmp_path), state)
    _assert_ranks_identical(res)
    np.testing.assert_allclose(res[0]["losses"][0]["loss"], ref_loss,
                               rtol=1e-5)
    got = res[0]["params"]
    assert len(got) == len(ref_params)
    for path, v in ref_params.items():
        name = port_name(path)
        np.testing.assert_allclose(to_np(got[name]), _to_port_layout(name, v),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------------------------ (c)
def _options_cfg(tmp_path):
    table = np.random.RandomState(5).randn(VOCAB, 16).astype(np.float32)
    np.save(tmp_path / "emb.npy", table)
    model = copy.deepcopy(ASR_CFG)
    model["encoder"]["dropout"] = [0.3, 0.3]
    model["decoder"].update(layer=2, dropout=0.3)
    model["emb_drop"] = 0.3
    model["plugin"] = {"src": str(tmp_path / "emb.npy"), "weight": 0.7}
    audio = dict(AUDIO_CFG, augment={"freq_mask_width": 8,
                                     "time_mask_width": 10})
    return {"audio": audio, "model": model, "vocab": VOCAB}


def test_world4_with_dropout_teacher_forcing_augment_and_plugin_equals_world1(
        tmp_path):
    """Two steps with dropout 0.3 (encoder, decoder, embedding), teacher
    forcing 0.5, SpecAugment and the embedding plugin: world 4 (B=6 padded
    to 8) against the port's world 1 on the same seed."""
    cfg = _options_cfg(tmp_path)
    hp = dict(ADADELTA, tf_start=0.5, tf_end=0.5)
    batches = [_batch(1), _batch(2, lens=(3000, 6400, 5000, 2000, 7000, 900))]
    ref = dist_helpers.asr_steps(0, 1, cfg, hp, batches, str(tmp_path / "w1"))
    res = dist_helpers.run_world(dist_helpers.asr_steps, 4, tmp_path / "w4",
                                 cfg, hp, batches, str(tmp_path / "d"))
    _assert_ranks_identical(res)
    for got, want in zip(res[0]["losses"], ref["losses"]):
        for k in ("loss", "ctc_loss", "att_loss", "emb_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _assert_params_close(res[0]["params"], ref["params"])


# ------------------------------------------------------------------ (d)
def test_lm_world2_step_matches_the_jax_sharded_step(tmp_path):
    """The LM step at world 2 (B=5 padded to 6, text padded to the global
    longest) against the JAX LM solver's mean NLL on the 8-device mesh and
    one optax Adam step."""
    from tests.test_torch_port_lm_train import VOCAB as LM_V, _cfg, _text
    cfg = _cfg("LSTM", 2)
    jlm = JaxLM(LM_V, cfg)
    jp = jlm.init(jax.random.PRNGKey(4))
    text, lens = _text(6, lens=(11, 7, 16, 1, 5))
    m8 = pmesh.make_mesh(8)
    sb = pmesh.shard_batch(m8, pmesh.pad_batch_to(
        {"text": text, "text_len": lens}, 8))
    pr = pmesh.shard_params(m8, jp)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jlm)))(
        pr, sb["text"], sb["text_len"])
    jopt = JaxOptimizer(ADAM, grad_clip=5.0)
    new, _ = jopt.step(grads, jopt.init(pr), pr)
    state = lm_from_arrays(LM_V, cfg, jax_arrays(jp), device="cpu").state_dict()
    res = dist_helpers.run_world(
        dist_helpers.lm_steps, 2, tmp_path / "w2", dict(cfg, vocab=LM_V), ADAM,
        [{"text": text, "text_len": lens}], str(tmp_path), state)
    _assert_ranks_identical(res)
    np.testing.assert_allclose(res[0]["losses"][0], float(loss), rtol=1e-5)
    for path, v in jax_arrays(new).items():
        name = port_name(path)
        np.testing.assert_allclose(to_np(res[0]["params"][name]), v,
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------------------------ (e)
@pytest.fixture(scope="module")
def decode_setup(tmp_path_factory):
    """3 dev and 3 test utterances (at world 2: 2 rows a rank, one a dummy
    row), the JAX package's init as a reference-layout ASR checkpoint and
    an LM for shallow fusion, and the JAX solver's CSVs on its mesh."""
    d = tmp_path_factory.mktemp("dist_decode")
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
        {"data": data, "model": MODEL_CFG, "hparas": {}, "decode": decode}))
    from end_to_end_asr_pytorch_tpu.config import load_config
    paras = _paras(d / "jax", "fix", load=str(d / "asr.pth"))
    paras.test = True
    solver = JaxTestSolver(load_config(str(d / "fix.yaml")), paras, "test")
    solver.load_data()
    solver.set_model()
    solver.exec()
    out = d / "jax" / "out" / "fix_sd0"
    return d, {f.name: f.read_text() for f in sorted(out.glob("*.csv"))}


def _beam_rows(text):
    rows = [ln.split("\t") for ln in text.strip().split("\n")[1:]]
    return [(r[0], r[1], r[3]) for r in rows], np.array([float(r[2])
                                                          for r in rows])


def _assert_csvs_equal(got, ref):
    assert sorted(got) == sorted(ref) == [
        "dev_beam.csv", "dev_output.csv", "test_beam.csv", "test_output.csv"]
    for split in ("dev", "test"):
        assert got[f"{split}_output.csv"] == ref[f"{split}_output.csv"]
        g_rows, g_sc = _beam_rows(got[f"{split}_beam.csv"])
        r_rows, r_sc = _beam_rows(ref[f"{split}_beam.csv"])
        assert g_rows == r_rows
        np.testing.assert_allclose(g_sc, r_sc, atol=1e-4, rtol=0)


def test_main_test_world2_matches_the_jax_solver(decode_setup, tmp_path):
    d, ref = decode_setup
    out = tmp_path / "out"
    dist_helpers.run_world(dist_helpers.run_main, 2, tmp_path / "w2", [
        "--config", str(d / "fix.yaml"), "--test", "--cpu", "--load",
        str(d / "asr.pth"), "--outdir", str(out)])
    got = {f.name: f.read_text()
           for f in sorted((out / "fix_sd0").glob("*.csv"))}
    _assert_csvs_equal(got, ref)
    assert len(got["dev_output.csv"].strip().split("\n")) == 1 + 3


# ------------------------------------------------------------------ (f)
def _torchrun(argv, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "end_to_end_asr_pytorch_tpu_torch.main",
         *argv, "--cpu"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _log_entries(path):
    return Counter((e["step"], e["name"]) for e in
                   map(json.loads, path.read_text().splitlines()))


def test_torchrun_main_lm_and_test_on_the_cpu(tmp_path, capsys):
    """``torchrun --nproc_per_node=2 ... --cpu``: ``main`` (2 steps and a
    validation, then ``--load`` resumes to 3), ``main --lm`` and ``main
    --test``, each against the same run in one process: the same log
    entries, written once (rank 0 alone), the same parameters in every
    checkpoint (which the JAX package loads), the same CSVs."""
    corpus = _corpus(tmp_path / "c", n_train=5, n_dev=3, n_test=3)
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
    (tmp_path / "lm.yaml").write_text(yaml.safe_dump(lm))
    las["decode"].update(beam_size=2, lm_config=str(tmp_path / "lm.yaml"))
    runs = {}
    for world in (1, 2):
        w = tmp_path / f"w{world}"
        las["decode"]["lm_path"] = str(w / "ckpt" / "lm_sd0" / "best_ppx.pth")
        (w / "las.yaml").parent.mkdir()
        (w / "las.yaml").write_text(yaml.safe_dump(las))
        dirs = ["--logdir", str(w / "log"), "--ckpdir", str(w / "ckpt"),
                "--outdir", str(w / "out")]
        asr = w / "ckpt" / "las_sd0"
        steps = [[*dirs, "--config", str(w / "las.yaml")],
                 [*dirs, "--config", str(tmp_path / "lm.yaml"), "--lm"],
                 [*dirs, "--config", str(w / "las.yaml"), "--test", "--load",
                  str(asr / "latest.pth")]]
        for argv in steps:
            if world == 1:
                port_main.main([*argv, "--cpu"])
            else:
                out = _torchrun(argv, tmp_path)
                assert out.count("[device] cpu (cpu) | world 2 (gloo)") == 1
        las["hparas"]["max_step"] = 3
        (w / "las.yaml").write_text(yaml.safe_dump(las))
        resume = [*dirs, "--config", str(w / "las.yaml"), "--load",
                  str(asr / "latest.pth")]
        if world == 1:
            port_main.main([*resume, "--cpu"])
        else:
            _torchrun(resume, tmp_path)
        las["hparas"]["max_step"] = 2
        runs[world] = w
    capsys.readouterr()
    w1, w2 = runs[1], runs[2]
    for exp in ("las_sd0", "lm_sd0"):
        assert (_log_entries(w2 / "log" / exp / "log.jsonl")
                == _log_entries(w1 / "log" / exp / "log.jsonl")), exp
    vocab = 3 + len((corpus / "vocab.txt").read_text().split())
    for exp, files in (("las_sd0", ("latest.pth", "best_att.pth")),
                       ("lm_sd0", ("latest.pth", "best_ppx.pth"))):
        for f in files:
            a = torch.load(w1 / "ckpt" / exp / f, weights_only=True)
            b = torch.load(w2 / "ckpt" / exp / f, weights_only=True)
            assert a["global_step"] == b["global_step"]
            _assert_params_close(b["model"], a["model"])
    ck = torch.load(w2 / "ckpt" / "las_sd0" / "latest.pth", weights_only=True)
    assert ck["global_step"] == 3
    jm = JaxASR(40, vocab, las["model"])
    assert jax_load_checkpoint(str(w2 / "ckpt" / "las_sd0" / "latest.pth"),
                               jm.init(jax.random.PRNGKey(0)))[
        "global_step"] == 3
    jl = JaxLM(vocab, lm["model"])
    assert jax_load_checkpoint(str(w2 / "ckpt" / "lm_sd0" / "best_ppx.pth"),
                               jl.init(jax.random.PRNGKey(0)))[
        "global_step"] == 2
    got = {f.name: f.read_text()
           for f in sorted((w2 / "out" / "las_sd0").glob("*.csv"))}
    ref = {f.name: f.read_text()
           for f in sorted((w1 / "out" / "las_sd0").glob("*.csv"))}
    _assert_csvs_equal(got, ref)


# ------------------------------------------------------------------ (g)
FAIL_SCRIPT = textwrap.dedent("""
    import sys, torch
    sys.path.insert(0, {root!r})
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    rank = int(sys.argv[1])
    mesh.init(torch.device("cpu"), init_method={store!r}, rank=rank,
              world=2, timeout=20)
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    mesh.all_reduce_sum(torch.ones(4))
    print("rank 0 went on")
""")


def test_a_failed_rank_ends_the_job_with_an_error(tmp_path):
    """Rank 1 raises after joining the group; rank 0, waiting on an
    all-reduce, ends with an error too, well within the group's timeout,
    instead of hanging."""
    script = tmp_path / "fail.py"
    script.write_text(FAIL_SCRIPT.format(root=str(ROOT),
                                         store=f"file://{tmp_path}/store"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=90) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert time.monotonic() - t0 < 90
    assert [p.returncode != 0 for p in procs] == [True, True]
    assert "rank 1 fails" in outs[1][1]
    assert "rank 0 went on" not in outs[0][0]


# ------------------------------------------------------------------ (h)
BUILD_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    from pathlib import Path
    from end_to_end_asr_pytorch_tpu_torch.data.flac import read_flac
    from end_to_end_asr_pytorch_tpu_torch.utils import native
    native.BUILD_DIR = Path({build!r})
    print(len(read_flac({flac!r})[0]))
""")


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_two_processes_build_the_flac_decoder_once(tmp_path):
    """Two processes read a FLAC file through a binding with nothing built:
    g++ runs once (the other process waits on the build directory's lock
    and loads the library), both decode it."""
    pcm = (np.random.RandomState(3).randn(4000) * 1000).astype(np.int16)
    flac = tmp_path / "a.flac"
    flac.write_bytes(encode_flac(pcm))
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "gxx.log"
    wrapper = bin_dir / "g++"
    wrapper.write_text(f"#!/bin/sh\necho run >> {log}\nsleep 1\n"
                       f"exec {shutil.which('g++')} \"$@\"\n")
    wrapper.chmod(0o755)
    script = tmp_path / "build.py"
    script.write_text(BUILD_SCRIPT.format(root=str(ROOT),
                                          build=str(tmp_path / "build"),
                                          flac=str(flac)))
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, str(script)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o[0].strip() for o in outs] == ["4000", "4000"]
    assert log.read_text().split() == ["run"]
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".so"]


# ------------------------------------------- zero-length rows, one process
def _grads_of(model_cfg, batch, k7):
    cfg = copy.deepcopy(model_cfg)
    cfg["attention"]["use_pallas_train"] = k7
    pm = asr_from_arrays(40, VOCAB, cfg, jax_arrays(
        JaxASR(40, VOCAB, model_cfg).init(jax.random.PRNGKey(3))),
        device="cpu")
    pm.requires_grad_(True)
    from end_to_end_asr_pytorch_tpu_torch.ops.ctc import ctc_loss_k3
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_asr import asr_loss
    fe = AudioFrontend(AUDIO_CFG, device="cpu")
    feat, flen = fe(torch.from_numpy(batch["wave"]),
                    torch.from_numpy(batch["wave_len"]))
    text = torch.from_numpy(batch["text"]).long()
    ctc_out, enc_len, att_out, _, _ = pm(feat, flen, text.shape[1], 1.0,
                                         teacher=text, train=True,
                                         generator=torch.Generator())
    loss, _ = asr_loss(ctc_out, enc_len, att_out, text,
                       torch.from_numpy(batch["text_len"]).long(), 0.5,
                       ctc_loss_k3)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in pm.named_parameters()}


@pytest.mark.parametrize("style", ["drop", "concat"])
@pytest.mark.parametrize("k7", [False, True])
def test_zero_length_rows_add_nothing_to_loss_or_gradient(style, k7):
    """Two zero-length rows (the padding of a global batch) among six real
    ones, through the plain versions of K1, the scans, K3 (T=1 or, with
    ``concat``, T=0 at S=1) and K7: the loss and every gradient finite and
    equal to those of the six rows alone."""
    cfg = copy.deepcopy(ASR_CFG)
    cfg["encoder"].update(sample_rate=[1, 2], sample_style=style)
    real = _batch(4)
    padded = mesh.pad_batch_to(real, 8)
    ref_loss, ref = _grads_of(cfg, real, k7)
    loss, got = _grads_of(cfg, padded, k7)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    for n, g in got.items():
        assert torch.isfinite(g).all(), n
        np.testing.assert_allclose(to_np(g), to_np(ref[n]), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_zero_length_rows_decode_finite_and_leave_the_other_rows():
    """Beam decoding with a zero-length row beside real ones: the real
    rows' hypotheses and scores equal the batch without it; the dummy
    row's scores are finite."""
    V = 12
    pm = ASR(40, V, MODEL_CFG, generator=torch.Generator().manual_seed(2),
             device="cpu")
    dec = BeamDecoder(pm, {"beam_size": 3, "max_len_ratio": 0.6,
                           "ctc_weight": 0.3})
    fe = AudioFrontend(AUDIO_CFG, device="cpu")
    w, wl = waves(5, (6000, 4000, 3000))
    wp = np.concatenate([w, np.zeros((1, w.shape[1]), np.float32)])
    wlp = np.concatenate([wl, np.zeros(1, np.int32)])
    with torch.no_grad():
        a = dec.forward(*fe(torch.from_numpy(w), torch.from_numpy(wl)))
        b = dec.forward(*fe(torch.from_numpy(wp), torch.from_numpy(wlp)))
    assert torch.isfinite(b.scores).all()
    assert torch.equal(b.tokens[:3], a.tokens)
    assert torch.equal(b.lengths[:3], a.lengths)
    torch.testing.assert_close(b.scores[:3], a.scores, rtol=1e-5, atol=1e-5)
