"""The port's training path against the JAX package on the CPU: one train
step's loss and every parameter's gradient, teacher forcing, greedy decode,
the optimizer against optax, checkpoints read by the JAX loader, and the
``train`` entry point.

Weights come from the JAX package's init through the port's weight bridge;
inputs from ``np.random.RandomState``. Tolerances (f32, sums in another
order): loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6; logits atol 1e-4;
parameters after optimizer steps rtol 1e-5 / atol 1e-7."""
import copy
import functools
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.decode.greedy import att_greedy as jax_att_greedy
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from end_to_end_asr_pytorch_tpu.optim import Optimizer as JaxOptimizer
from end_to_end_asr_pytorch_tpu.solvers.train_asr import masked_ce as jax_masked_ce
from end_to_end_asr_pytorch_tpu.utils.checkpoint import load_checkpoint
from end_to_end_asr_pytorch_tpu_torch import train
from end_to_end_asr_pytorch_tpu_torch.decode.greedy import att_greedy
from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR as PortASR
from end_to_end_asr_pytorch_tpu_torch.models.encoder import dropout
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.ops.ctc import ctc_loss, ctc_loss_k3
from end_to_end_asr_pytorch_tpu_torch.optim import Optimizer
from end_to_end_asr_pytorch_tpu_torch.solvers.train_asr import asr_loss
from end_to_end_asr_pytorch_tpu_torch.utils import torch_ckpt
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    _to_port_layout, asr_from_arrays, port_name)
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, VOCAB, jax_arrays,
                                       to_np, waves)

torch.set_num_threads(1)
# row 2's 8 labels cannot fit its 5 encoder frames: the zero-infinity rule
TEXT = np.asarray([[3, 4, 4, 5, 6, 2, 0, 0], [7, 8, 9, 7, 0, 0, 0, 0],
                   [3, 5, 7, 9, 11, 3, 5, 7]], np.int32)
TEXT_LEN = np.asarray([6, 4, 8], np.int32)


def _port_grads_by_jax_path(model):
    return {n: to_np(p.grad) for n, p in model.named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_step(seed):
    """JAX: loss and gradients of the solver's joint loss at tf_rate 1."""
    jm = JaxASR(40, VOCAB, ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(seed))
    w, wl = waves(seed)
    feat, flen = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    text, text_len = jnp.asarray(TEXT), jnp.asarray(TEXT_LEN)

    def loss_fn(p):
        ctc_out, enc_len, att_out, _, _ = jm.forward(
            p, feat, flen, TEXT.shape[1], 1.0, teacher=text, train=True,
            rng=jax.random.PRNGKey(7))
        valid = text_len > 0
        nll = jax_ctc_loss(ctc_out, enc_len, text, text_len)
        per = nll / jnp.maximum(text_len, 1)
        ctc_l = jnp.sum(jnp.where(valid & (nll < 1e29), per, 0.0)) / \
            jnp.maximum(jnp.sum(valid), 1)
        return 0.5 * ctc_l + 0.5 * jax_masked_ce(att_out, text)

    loss, grads = jax.value_and_grad(loss_fn)(jp)
    return jm, jp, float(loss), jax_arrays(grads)


@pytest.mark.parametrize("ctc_fn", ["autograd", "k3_lattice"])
def test_train_loss_and_every_gradient_match_jax(ctc_fn):
    jm, jp, ref_loss, ref_grads = _jax_step(0)
    pm = asr_from_arrays(40, VOCAB, ASR_CFG, jax_arrays(jp), device="cpu")
    pm.requires_grad_(True)
    w, wl = waves(0)
    feat, flen = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                        torch.from_numpy(wl))
    text, text_len = torch.from_numpy(TEXT).long(), torch.from_numpy(TEXT_LEN).long()
    ctc_out, enc_len, att_out, _, _ = pm(feat, flen, TEXT.shape[1], 1.0,
                                         teacher=text, train=True,
                                         generator=torch.Generator())
    fn = ctc_loss if ctc_fn == "autograd" else ctc_loss_k3
    loss, metrics = asr_loss(ctc_out, enc_len, att_out, text, text_len, 0.5, fn)
    assert int(enc_len[2]) < TEXT_LEN[2]          # the infeasible row
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    got = _port_grads_by_jax_path(pm)
    assert len(got) == len(ref_grads)
    for path, g in ref_grads.items():
        name = port_name(path)
        np.testing.assert_allclose(got[name], _to_port_layout(name, g),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        assert np.any(got[name] != 0), name


def test_self_fed_forward_matches_jax_teacher_none():
    """tf_rate 0: every step after <sos> feeds back the argmax, which is
    what the JAX package's forward does with no teacher."""
    jm, jp, _, _ = _jax_step(1)
    w, wl = waves(1)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    _, _, ref, ref_align, _ = jm.forward(jp, jf, jfl, 6, teacher=None)
    pm = asr_from_arrays(40, VOCAB, ASR_CFG, jax_arrays(jp), device="cpu")
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    with torch.no_grad():
        _, _, got, got_align, _ = pm(pf, pfl, 6, 0.0,
                                     teacher=torch.from_numpy(TEXT),
                                     generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(to_np(got_align), np.asarray(ref_align),
                               atol=1e-5, rtol=0)


def test_att_greedy_matches_jax():
    jm, jp, _, _ = _jax_step(2)
    rng = np.random.RandomState(2)
    enc = rng.randn(3, 9, jm.encoder.out_dim).astype(np.float32)
    elen = np.asarray([9, 6, 3], np.int32)
    ref = jax_att_greedy(jm, jp, jnp.asarray(enc), jnp.asarray(elen), 7)
    pm = asr_from_arrays(40, VOCAB, ASR_CFG, jax_arrays(jp), device="cpu")
    with torch.no_grad():
        got = att_greedy(pm, torch.from_numpy(enc), torch.from_numpy(elen), 7)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


OPT_CASES = [(o, s) for o in ("Adadelta", "Adam", "AdamW", "SGD")
             for s in ("fixed", "warmup")]


@pytest.mark.parametrize("opt,sched", OPT_CASES)
def test_optimizer_matches_optax(opt, sched):
    """Three steps: a clipped one, a skipped one (NaN gradient), and one
    under the clip norm; parameters and the raw gradient norm agree."""
    hp = {"optimizer": opt, "lr": 0.5, "eps": 1e-8, "lr_scheduler": sched,
          "warmup_step": 2, "momentum": 0.9}
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (4.0, 1.0, 0.3)]
    grads[1]["b"][2] = np.nan
    jopt = JaxOptimizer(hp, grad_clip=2.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    popt = Optimizer(hp, grad_clip=2.0)
    pparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    for g in grads:
        jparams, jstate = jopt.step({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        for k, p in pparams.items():
            p.grad = torch.from_numpy(g[k])
        gn = popt.step(pparams)
        if np.isfinite(g["b"]).all():
            ref_gn = math.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                                   for v in g.values()))
            np.testing.assert_allclose(float(gn), ref_gn, rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(to_np(pparams[k]), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(popt.count) == 2


def test_dropout_rate_and_scaling():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = dropout(x, 0.3, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    # the generator makes the masks reproducible
    torch.testing.assert_close(dropout(x, 0.3, torch.Generator().manual_seed(0)), y)


@pytest.mark.parametrize("part", ["encoder", "decoder", "embedding"])
def test_train_dropout_needs_a_generator_and_changes_the_output(part):
    """A training pass with dropout > 0 raises without a generator, rather
    than train with no dropout; with one it is reproducible and differs
    from the pass without dropout."""
    cfg = copy.deepcopy(ASR_CFG)
    if part == "encoder":
        cfg["encoder"]["dropout"] = [0.3, 0.3]
    elif part == "decoder":
        cfg["decoder"].update(layer=2, dropout=0.3)
    else:
        cfg["emb_drop"] = 0.3
    pm = PortASR(40, VOCAB, cfg, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    w, wl = waves(0)
    feat, flen = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                        torch.from_numpy(wl))
    text = torch.from_numpy(TEXT).long()

    def att_out(train, seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return pm(feat, flen, TEXT.shape[1], 1.0, teacher=text, train=train,
                  generator=gen)[2]

    with torch.no_grad():
        with pytest.raises(ValueError, match="Generator"):
            att_out(True)
        ref = att_out(False, 1)
        a, b = att_out(True, 1), att_out(True, 1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - ref).abs().max()) > 1e-3


def test_checkpoint_saved_by_port_loads_in_jax(tmp_path):
    jm = JaxASR(40, VOCAB, ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(5))
    pm = asr_from_arrays(40, VOCAB, ASR_CFG, jax_arrays(jp), device="cpu")
    with torch.no_grad():                   # weights the JAX init did not make
        for p in pm.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(5)))
    opt = Optimizer({"optimizer": "Adadelta"})
    opt.init(dict(pm.named_parameters()))
    torch_ckpt.save_checkpoint(tmp_path / "latest.pth", pm, opt, 17, {"wer": 0.5})
    ck = load_checkpoint(str(tmp_path / "latest.pth"),
                         jm.init(jax.random.PRNGKey(6)))
    assert ck["global_step"] == 17 and ck["metrics"]["wer"] == 0.5
    loaded = jax_arrays(ck["model"])
    sd = pm.state_dict()
    assert len(loaded) == len(sd)
    for path, a in loaded.items():
        name = port_name(path)
        np.testing.assert_array_equal(_to_port_layout(name, a), to_np(sd[name]))
    # and the port's own loader restores weights, optimizer state and step
    again = asr_from_arrays(40, VOCAB, ASR_CFG, jax_arrays(jp), device="cpu")
    back = torch_ckpt.load_torch_checkpoint(str(tmp_path / "latest.pth"), again)
    assert back["global_step"] == 17 and back["optimizer"]["optimizer"] == "adadelta"
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _corpus(root):
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    generate_corpus(root, n_train=6, n_dev=3, n_test=0, seed=0)
    return root


def _train_config(tmp_path, **hparas):
    root = _corpus(str(tmp_path.parent / "synth_corpus"))
    cfg = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    cfg["data"]["corpus"].update(path=root, batch_size=3)
    cfg["data"]["text"]["vocab_file"] = f"{root}/vocab.txt"
    cfg["model"]["encoder"]["dim"] = [16, 16]
    cfg["model"]["attention"].update(dim=8, loc_kernel_size=6, loc_kernel_num=2)
    cfg["model"]["decoder"]["dim"] = 16
    cfg["hparas"].update(max_step=2, valid_step=2, PROGRESS_STEP=1,
                         tf_end=0.5, tf_step=2, **hparas)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_train_entry_runs_on_cpu_and_resumes(tmp_path):
    cfg = _train_config(tmp_path)
    common = ["--config", str(cfg), "--cpu", "--no-msg", "--logdir",
              str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")]
    best = train.main(common)
    exp = tmp_path / "ckpt" / "cfg_sd0"
    assert (exp / "latest.pth").exists() and set(best) == {"att", "ctc"}
    log = [json.loads(ln) for ln in
           (tmp_path / "log" / "cfg_sd0" / "log.jsonl").read_text().splitlines()]
    losses = [v for e in log if e["name"] == "loss" for v in e["value"].values()]
    assert len(losses) >= 6 and all(math.isfinite(v) for v in losses)
    assert {e["name"] for e in log} >= {"wer", "cer", "grad_norm", "hyp_0", "ref_0"}
    ck = torch.load(str(exp / "latest.pth"), weights_only=True)
    assert ck["global_step"] == 2 and int(ck["optimizer"]["count"]) == 2
    # --load resumes weights, optimizer state and step
    cfg2 = yaml.safe_load(cfg.read_text())
    cfg2["hparas"]["max_step"] = 3
    cfg.write_text(yaml.safe_dump(cfg2))
    train.main([*common, "--load", str(exp / "latest.pth")])
    ck = torch.load(str(exp / "latest.pth"), weights_only=True)
    assert ck["global_step"] == 3 and int(ck["optimizer"]["count"]) == 3


def test_train_entry_needs_cuda_without_cpu_flag(tmp_path, monkeypatch):
    cfg = _train_config(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--config", str(cfg), "--no-msg", "--logdir",
                    str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")])


def _set_option(tmp_path, where, key, value):
    """The small training config with ``key`` set (``where`` "flag": a
    command-line flag) -> the entry point's argv."""
    cfg_path = _train_config(tmp_path)
    cfg = yaml.safe_load(cfg_path.read_text())
    target = {"hparas": cfg["hparas"], "audio": cfg["data"]["audio"],
              "model": cfg["model"], "root": cfg}.get(where)
    if target is not None:
        target[key] = value
    cfg_path.write_text(yaml.safe_dump(cfg))
    return ["--config", str(cfg_path), "--cpu", "--no-msg", "--logdir",
            str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")] + (
                [key] if where == "flag" else [])


@pytest.mark.parametrize("where,key,value", [
    ("root", "model_parallel", 2), ("root", "ckpt_format", "orbx")])
def test_unported_training_options_raise(tmp_path, where, key, value):
    """model_parallel 2 at world 1 raises the JAX package's ValueError (M
    must divide the processes); a ckpt_format other than native / orbax
    raises its ValueError at start-up, as the JAX BaseSolver's does (orbax
    trains: tests/test_torch_port_orbax.py)."""
    with pytest.raises(ValueError, match=key.lstrip("-")):
        train.main(_set_option(tmp_path, where, key, value))


@pytest.mark.parametrize("extra", [["--lm"], ["--lm", "--amp"]])
def test_lm_flag_trains(tmp_path, capsys, extra):
    """``--lm`` (which raised until LM training was ported) trains an RNN-LM
    on the corpus's transcripts: two steps, ``best_ppx.pth`` and
    ``latest.pth`` with a finite dev perplexity; ``--amp`` is ignored."""
    root = _corpus(str(tmp_path.parent / "synth_corpus"))
    cfg = yaml.safe_load((ROOT / "config/synthetic/lm.yaml").read_text())
    cfg["data"]["corpus"].update(path=root, batch_size=3)
    cfg["data"]["text"]["vocab_file"] = f"{root}/vocab.txt"
    cfg["model"].update(dim=8, emb_dim=8)
    cfg["hparas"].update(max_step=2, valid_step=2)
    path = tmp_path / "lm.yaml"
    path.write_text(yaml.safe_dump(cfg))
    ppx = train.main(["--config", str(path), "--cpu", "--logdir",
                      str(tmp_path / "log"), "--ckpdir",
                      str(tmp_path / "ckpt"), *extra])
    assert math.isfinite(ppx)
    for name in ("best_ppx.pth", "latest.pth"):
        ck = torch.load(str(tmp_path / "ckpt" / "lm_sd0" / name),
                        weights_only=True)
        assert ck["global_step"] == 2 and math.isfinite(ck["ppx"])
    ignored = "amp is ignored" in capsys.readouterr().out
    assert ignored == ("--amp" in extra)


@pytest.mark.parametrize("where,key,value", [
    ("hparas", "amp", True), ("flag", "--amp", None)])
def test_amp_training_options_run(tmp_path, where, key, value):
    """``hparas.amp`` and ``--amp`` (which raised until amp training was
    ported) train in bf16: two steps with finite losses, the checkpoint
    keeps f32 weights."""
    train.main(_set_option(tmp_path, where, key, value))
    exp = tmp_path / "ckpt" / "cfg_sd0"
    ck = torch.load(str(exp / "latest.pth"), weights_only=True)
    assert ck["global_step"] == 2
    assert all(v.dtype == torch.float32 for v in ck["model"].values()
               if torch.is_tensor(v) and v.is_floating_point())
    log = [json.loads(ln) for ln in
           (tmp_path / "log" / "cfg_sd0" / "log.jsonl").read_text().splitlines()]
    losses = [v for e in log if e["name"] == "loss" for v in e["value"].values()]
    assert losses and all(math.isfinite(v) for v in losses)
