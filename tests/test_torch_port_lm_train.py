"""RNN-LM training of the port (``main --lm``: ``solvers/train_lm.py``,
``RNNLM.forward``, ``data/dataset.load_textset``, LM checkpoints) against
the JAX package on the CPU.

Weights come from the JAX package's init through the port's weight bridge;
token ids from ``np.random.RandomState``. Tolerances (f32, sums in another
order): logits and loss rtol 1e-5 (logits also atol 1e-6, for values near
zero); gradients rtol 1e-4 / atol 1e-6; parameters after one Adam step
rtol 1e-5 / atol 1e-7; dev perplexity rtol 1e-5. JAX's dropout draws from
``jax.random``, which the port cannot reproduce: parity is taken at
dropout 0, and the port's dropout is checked on its own."""
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.data.dataset import load_textset as jax_load_textset
from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
from end_to_end_asr_pytorch_tpu.optim import Optimizer as JaxOptimizer
from end_to_end_asr_pytorch_tpu.solvers.train_lm import Solver as JaxSolver
from end_to_end_asr_pytorch_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint, save_checkpoint as jax_save_checkpoint)
from end_to_end_asr_pytorch_tpu_torch import main as port_main
from end_to_end_asr_pytorch_tpu_torch.data import synthetic
from end_to_end_asr_pytorch_tpu_torch.data.dataset import load_textset
from end_to_end_asr_pytorch_tpu_torch.models import lm as lm_module
from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM
from end_to_end_asr_pytorch_tpu_torch.optim import Optimizer
from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import lm_nll
from end_to_end_asr_pytorch_tpu_torch.utils import jax_ckpt
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    lm_from_arrays, load_arrays, port_name)
from tests.torch_port_fixtures import jax_arrays, to_np

torch.set_num_threads(1)
VOCAB = 13
ADAM = {"optimizer": "Adam", "lr": 1e-3, "eps": 1e-8, "lr_scheduler": "fixed"}


def _cfg(module="LSTM", layer=1, tying=False, dropout=0.0):
    return {"module": module, "dim": 16, "emb_dim": 16, "layer": layer,
            "emb_tying": tying, "dropout": dropout}


def _text(seed, lens=(11, 7, 16, 1)):
    """Token ids in [3, VOCAB) ending in <eos> (1), ragged, padded to 16."""
    rng = np.random.RandomState(seed)
    text = np.zeros((len(lens), 16), np.int32)
    for b, n in enumerate(lens):
        text[b, :n - 1] = rng.randint(3, VOCAB, n - 1)
        text[b, n - 1] = 1
    return text, np.asarray(lens, np.int32)


def _models(cfg, seed=0):
    jlm = JaxLM(VOCAB, cfg)
    jp = jlm.init(jax.random.PRNGKey(seed))
    return jlm, jp, lm_from_arrays(VOCAB, cfg, jax_arrays(jp), device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_synth")
    return synthetic.generate_corpus(str(root), n_train=10, n_dev=5, n_test=2,
                                     text_only=70)


def _data(corpus, train_split, dev_split=("dev-clean",), batch_size=8):
    return ({"name": "synthetic", "path": str(corpus),
             "train_split": list(train_split), "dev_split": list(dev_split),
             "batch_size": batch_size},
            {"mode": "character", "vocab_file": str(corpus / "vocab.txt")})


@pytest.mark.parametrize("splits", ["txt", "transcripts"])
def test_textset_batches_and_order_equal_jax(corpus, splits):
    train = ["lm_text.txt"] if splits == "txt" else ["train-clean"]
    corp, text = _data(corpus, train)
    tr, dv, vocab, _, msg = load_textset(corp, text)
    jtr, jdv, jvocab, _, jmsg = jax_load_textset(1, False, False, corp, text)
    assert vocab == jvocab and msg == jmsg and len(tr) == len(jtr) > 1
    for _ in range(2):                   # two epochs of shuffled order
        for got_set, ref_set in ((tr, jtr), (dv, jdv)):
            got, ref = list(got_set), list(ref_set)
            assert len(got) == len(ref) > 0
            for g, r in zip(got, ref):
                assert g["text"].shape[1] % 16 == 0
                for k in ("text", "text_len"):
                    assert g[k].dtype == r[k].dtype
                    np.testing.assert_array_equal(g[k], r[k])


def test_mixed_splits_raise_in_both_packages(corpus):
    corp, text = _data(corpus, ["lm_text.txt", "train-clean"])
    with pytest.raises(ValueError, match="cannot mix"):
        load_textset(corp, text)
    with pytest.raises(ValueError, match="cannot mix"):
        jax_load_textset(1, False, False, corp, text)


@pytest.mark.parametrize("tying", [False, True])
@pytest.mark.parametrize("layer", [1, 2])
@pytest.mark.parametrize("module", ["LSTM", "GRU"])
def test_forward_logits_match_jax(module, layer, tying):
    cfg = _cfg(module, layer, tying)
    jlm, jp, lm = _models(cfg, seed=layer + 2 * tying)
    text, lens = _text(5)
    ref = jlm.forward(jp, jnp.asarray(text), jnp.asarray(lens))
    with torch.no_grad():
        got = lm(torch.from_numpy(text).long(), torch.from_numpy(lens).long())
    assert got.shape == (4, 16, VOCAB) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _jax_loss_fn(jlm):
    solver = SimpleNamespace(lm=jlm)

    def loss_fn(p, text, text_len):
        total, count = JaxSolver._nll(solver, p, text, text_len, True, None)
        return total / jnp.maximum(count, 1.0)
    return loss_fn


@pytest.mark.parametrize("module", ["LSTM", "GRU"])
def test_train_step_matches_jax_and_optax(module):
    """One step at dropout 0: the loss and every gradient against
    ``jax.value_and_grad`` of the JAX solver's mean NLL, then the
    parameters after one Adam step against optax's."""
    cfg = _cfg(module, 2)
    jlm, jp, lm = _models(cfg, seed=4)
    text, lens = _text(6)
    jt, jl = jnp.asarray(text), jnp.asarray(lens)
    loss, grads = jax.value_and_grad(_jax_loss_fn(jlm))(jp, jt, jl)
    jopt = JaxOptimizer(ADAM, grad_clip=5.0)
    updates, _ = jopt.tx.update(grads, jopt.init(jp), jp)
    ref_params = jax_arrays(optax.apply_updates(jp, updates))

    lm.requires_grad_(True)
    params = dict(lm.named_parameters())
    total, count = lm_nll(lm, torch.from_numpy(text).long(),
                          torch.from_numpy(lens).long(), train=True)
    got_loss = total / torch.clamp(count, min=1.0)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=1e-5)
    ref_grads = jax_arrays(grads)
    assert len(ref_grads) == len(params)
    for path, g in ref_grads.items():
        name = port_name(path)
        np.testing.assert_allclose(to_np(params[name].grad), g, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        assert np.any(to_np(params[name].grad) != 0), name
    opt = Optimizer(ADAM, grad_clip=5.0)
    opt.init(params)
    opt.step(params)
    for path, p in ref_params.items():
        name = port_name(path)
        np.testing.assert_allclose(to_np(params[name]), p, rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def _lm_yaml(tmp_path, corpus, **hparas):
    """config/synthetic/lm.yaml on the generated corpus, lm_text.txt as the
    train split, at tiny width."""
    cfg = yaml.safe_load((ROOT / "config/synthetic/lm.yaml").read_text())
    corp, text = _data(corpus, ["lm_text.txt"])
    cfg["data"] = {"corpus": corp, "text": text}
    cfg["model"].update(dim=16, emb_dim=16)
    cfg["hparas"].update({"max_step": 2, "valid_step": 2, "PROGRESS_STEP": 1,
                          **hparas})
    path = tmp_path / "lm.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


def _argv(tmp_path, cfg_path, *extra):
    return ["--config", str(cfg_path), "--lm", "--cpu", "--no-msg",
            "--logdir", str(tmp_path / "log"), "--ckpdir",
            str(tmp_path / "ckpt"), *extra]


def test_validation_perplexity_matches_jax(tmp_path, corpus):
    """The port's ``validate`` on the JAX package's weights against
    exp(sum / count) of the JAX solver's ``_valid_step`` over the JAX
    package's dev batches."""
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import Solver
    path, cfg = _lm_yaml(tmp_path, corpus)
    cfg["model"]["layer"] = 2
    solver = Solver(cfg, port_main.build_parser().parse_args(
        _argv(tmp_path, path)))
    solver.load_data()
    solver.set_model()
    jlm = JaxLM(solver.vocab_size, cfg["model"])
    jp = jlm.init(jax.random.PRNGKey(8))
    load_arrays(solver.lm, jax_arrays(jp))
    solver.validate()
    _, jdv, _, _, _ = jax_load_textset(1, False, False, cfg["data"]["corpus"],
                                       cfg["data"]["text"])
    total = count = 0.0
    for batch in jdv:
        t, c = JaxSolver._nll(SimpleNamespace(lm=jlm), jp,
                              jnp.asarray(batch["text"]),
                              jnp.asarray(batch["text_len"]), False, None)
        total += float(t)
        count += float(c)
    np.testing.assert_allclose(solver.best_ppx, math.exp(total / count),
                               rtol=1e-5)
    ck = torch.load(str(solver.ckpdir / "best_ppx.pth"), weights_only=True)
    assert ck["ppx"] == solver.best_ppx and ck["global_step"] == 0


def test_dropout_is_seeded_keeps_its_rate_and_needs_a_generator(monkeypatch):
    lm = RNNLM(VOCAB, _cfg("LSTM", 2, dropout=0.2),
               generator=torch.Generator().manual_seed(0), device="cpu")
    text, lens = _text(7, lens=(16,) * 64)
    tok, ln = torch.from_numpy(text).long(), torch.from_numpy(lens).long()
    seen = []
    real = lm_module.dropout

    def record(h, rate, generator):
        out = real(h, rate, generator)
        seen.append((h, out))
        return out

    monkeypatch.setattr(lm_module, "dropout", record)
    with torch.no_grad():
        run = lambda s: lm(tok, ln, train=True,
                           generator=torch.Generator().manual_seed(s))
        a, b, c = run(3), run(3), run(4)
        assert len(seen) == 6                 # the embedding and layer 1
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, c)
        torch.testing.assert_close(lm(tok, ln), lm(tok, ln, train=False,
                                                   generator=None))
    kept = n = 0
    for h, out in seen:
        live = h != 0
        keep = (out != 0) & live
        torch.testing.assert_close(out[keep], h[keep] / 0.8)
        kept += int(keep.sum())
        n += int(live.sum())
    sigma = math.sqrt(0.8 * 0.2 / n)
    assert abs(kept / n - 0.8) < 3 * sigma
    with pytest.raises(ValueError, match="torch.Generator"):
        lm(tok, ln, train=True)


def test_main_lm_writes_checkpoints_that_jax_and_the_decoder_read(
        tmp_path, corpus, capsys):
    """``main --lm`` for 2 steps writes ``best_ppx.pth`` and ``latest.pth``;
    the JAX package's loader reads ``best_ppx.pth`` to the port's logits;
    ``main --test`` fuses it through ``decode.lm_path`` (the recipe's
    ``las.yaml`` chain); ``--load`` resumes the step and Adam's state."""
    path, cfg = _lm_yaml(tmp_path, corpus)
    best = port_main.main(_argv(tmp_path, path))
    exp = tmp_path / "ckpt" / "lm_sd0"
    assert math.isfinite(best)
    ck = torch.load(str(exp / "best_ppx.pth"), weights_only=True)
    assert ck["global_step"] == 2 and ck["ppx"] == best
    assert int(ck["optimizer"]["count"]) == 2
    assert set(ck["optimizer"]["slots"]["embed"]) == {"mu", "nu"}
    log = [json.loads(ln) for ln in
           (tmp_path / "log" / "lm_sd0" / "log.jsonl").read_text().splitlines()]
    assert [e["step"] for e in log if "tr" in e["value"]] == [1, 2]
    assert any("dv" in e["value"] for e in log)

    vocab = 30
    jlm = JaxLM(vocab, cfg["model"])
    jck = jax_load_checkpoint(str(exp / "best_ppx.pth"),
                              jlm.init(jax.random.PRNGKey(1)))
    assert jck["global_step"] == 2
    lm = RNNLM(vocab, cfg["model"], device="cpu")
    assert jax_ckpt.load_checkpoint(str(exp / "best_ppx.pth"),
                                    lm)["format"] == "torch"
    text, lens = _text(9)
    ref = jlm.forward(jck["model"], jnp.asarray(text), jnp.asarray(lens))
    with torch.no_grad():
        got = lm(torch.from_numpy(text).long(), torch.from_numpy(lens).long())
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)

    las = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    las["data"]["corpus"].update(path=str(corpus), batch_size=5,
                                 test_split=["test-clean"])
    las["data"]["text"]["vocab_file"] = str(corpus / "vocab.txt")
    las["model"]["encoder"]["dim"] = [16, 16]
    las["model"]["attention"].update(dim=8, loc_kernel_size=6,
                                     loc_kernel_num=2)
    las["model"]["decoder"]["dim"] = 16
    las["decode"].update(beam_size=2, lm_path=str(exp / "best_ppx.pth"),
                         lm_config=str(path))
    (tmp_path / "las.yaml").write_text(yaml.safe_dump(las))
    capsys.readouterr()
    port_main.main(["--config", str(tmp_path / "las.yaml"), "--test", "--cpu",
                    "--outdir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "Loaded LM ckpt for shallow fusion (weight 0.3)" in out
    assert (tmp_path / "out" / "las_sd0" / "test_output.csv").exists()

    cfg["hparas"]["max_step"] = 3
    path.write_text(yaml.safe_dump(cfg))
    port_main.main(_argv(tmp_path, path, "--load", str(exp / "latest.pth")))
    ck = torch.load(str(exp / "latest.pth"), weights_only=True)
    assert ck["global_step"] == 3 and int(ck["optimizer"]["count"]) == 3


def test_load_resumes_a_jax_native_lm_checkpoint(tmp_path, corpus):
    """A checkpoint the JAX package wrote in its native format: the port
    resumes its weights and step; this one holds no optax state, so the
    optimizer starts afresh."""
    path, cfg = _lm_yaml(tmp_path, corpus, max_step=3, valid_step=10)
    jlm = JaxLM(30, cfg["model"])
    jp = jlm.init(jax.random.PRNGKey(5))
    jax_save_checkpoint(str(tmp_path / "jax.pth"), jp, None, 2, {"ppx": 9.0})
    lm = RNNLM(30, cfg["model"], device="cpu")
    ck = jax_ckpt.load_checkpoint(str(tmp_path / "jax.pth"), lm)
    assert ck["format"] == "native" and ck["optimizer"] is None
    for k, v in lm_from_arrays(30, cfg["model"], jax_arrays(jp),
                               device="cpu").state_dict().items():
        torch.testing.assert_close(lm.state_dict()[k], v, rtol=0, atol=0)
    port_main.main(_argv(tmp_path, path, "--load", str(tmp_path / "jax.pth")))
    ck = torch.load(str(tmp_path / "ckpt" / "lm_sd0" / "latest.pth"),
                    weights_only=True)
    assert ck["global_step"] == 3 and int(ck["optimizer"]["count"]) == 1


@pytest.mark.parametrize("key,value", [("model_parallel", 2),
                                       ("ckpt_format", "orbx")])
def test_lm_options_not_ported_raise(tmp_path, corpus, key, value):
    """model_parallel 2 at world 1 raises the JAX package's ValueError (M
    must divide the processes); so does a ckpt_format other than native /
    orbax, at start-up (``main --lm`` with orbax:
    tests/test_torch_port_orbax.py)."""
    path, cfg = _lm_yaml(tmp_path, corpus)
    cfg[key] = value
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match=key):
        port_main.main(_argv(tmp_path, path))
