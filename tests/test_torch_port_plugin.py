"""The port's embedding plugin (``models/plugin.py``,
``utils/bert_embedding.py``) against the JAX package on the CPU.

Held here: the plugin's loss and fused log-probs (atol 1e-6), greedy and
beam decoding with fusion (identical ids and tokens; beam scores atol
1e-4), one ``Solver.train_step`` with the plugin on the plain attention
route and on K7's (its plain version here) against the JAX solver's loss
with ``emb_loss`` (loss rtol 1e-5, every gradient, the projection's too,
rtol 1e-4 / atol 1e-6), the ``.vec`` and hash tables, both checkpoint
readers and the writer, and ``main`` -> ``main --test`` -> ``transcribe``
with the plugin, SpecAugment and the decode keys, the ``--test`` CSVs
against the JAX test solver's on the port's checkpoint."""
import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.config import load_config as jax_load_config
from end_to_end_asr_pytorch_tpu.decode.beam import BeamDecoder as JaxBeam
from end_to_end_asr_pytorch_tpu.decode.greedy import att_greedy as jax_att_greedy
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.models.plugin import \
    EmbeddingRegularizer as JaxPlugin
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from end_to_end_asr_pytorch_tpu.solvers.test_asr import Solver as JaxTestSolver
from end_to_end_asr_pytorch_tpu.solvers.train_asr import masked_ce as jax_masked_ce
from end_to_end_asr_pytorch_tpu.utils import bert_embedding as jax_bert
from end_to_end_asr_pytorch_tpu.utils.checkpoint import save_checkpoint
from end_to_end_asr_pytorch_tpu.utils.text import \
    load_text_encoder as jax_text_encoder
from end_to_end_asr_pytorch_tpu.utils.torch_ckpt import \
    load_torch_checkpoint as jax_load_torch
from end_to_end_asr_pytorch_tpu_torch import main as port_main
from end_to_end_asr_pytorch_tpu_torch import transcribe
from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
from end_to_end_asr_pytorch_tpu_torch.decode.greedy import att_greedy
from end_to_end_asr_pytorch_tpu_torch.models import attention as port_attention
from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
from end_to_end_asr_pytorch_tpu_torch.models.plugin import EmbeddingRegularizer
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.solvers.train_asr import Solver
from end_to_end_asr_pytorch_tpu_torch.utils import (bert_embedding,
                                                    jax_ckpt, torch_ckpt)
from end_to_end_asr_pytorch_tpu_torch.utils.text import load_text_encoder
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    _to_port_layout, asr_from_arrays, lm_from_arrays, load_arrays,
    load_plugin_arrays, port_name)
from tests.test_e2e_train import _paras
from tests.test_torch_ckpt import export_asr_state_dict
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, LM_CFG, VOCAB,
                                       jax_arrays, to_np, waves)

torch.set_num_threads(1)
CHARS = list("abcdefgh") + ["<space>"]          # 3 + 9 = VOCAB
DECODE_CFG = {"beam_size": 4, "min_len_ratio": 0.05, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3}
TEXT = np.asarray([[3, 4, 4, 5, 6, 2, 0, 0], [7, 8, 9, 7, 0, 0, 0, 0],
                   [3, 5, 7, 9, 11, 3, 5, 7]], np.int32)
TEXT_LEN = np.asarray([6, 4, 8], np.int32)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """A character vocabulary of VOCAB entries and its hash table (dim 16)
    written by the port's CLI."""
    d = tmp_path_factory.mktemp("plugin")
    (d / "vocab.txt").write_text("\n".join(CHARS) + "\n")
    bert_embedding.main(["--vocab_file", str(d / "vocab.txt"), "--output",
                         str(d / "emb.npy"), "--method", "hash", "--dim",
                         "16"])
    return d


def _plugins(table, seed=3, **cfg):
    """The JAX plugin, its parameters, and the port's with the same ones."""
    cfg = {"src": str(table / "emb.npy"), "weight": 0.7, "fuse": 0.3,
           "temp": 0.8, **cfg}
    jplug = JaxPlugin(cfg, VOCAB, 32)
    jpp = jplug.init(jax.random.PRNGKey(seed))
    pplug = EmbeddingRegularizer(cfg, VOCAB, 32, device="cpu")
    load_plugin_arrays(pplug, {port_name(k): v
                               for k, v in jax_arrays(jpp).items()})
    return jplug, jpp, pplug


def test_tables_equal_jax(table, tmp_path):
    """The hash table and a ``.vec`` table (header, trailing spaces, rows
    for no piece) equal the JAX package's."""
    ref = jax_bert.generate_embedding(str(table / "vocab.txt"), "character",
                                      str(tmp_path / "jax.npy"),
                                      method="hash", dim=16)
    np.testing.assert_array_equal(np.load(table / "emb.npy"), ref)
    vec = tmp_path / "t.vec"
    rng = np.random.RandomState(0)
    rows = ["4 5"] + [f"{w} " + " ".join(f"{v:.6f}" for v in rng.randn(5))
                      + " " for w in ("a", "C", "h", "zz")]
    vec.write_text("\n".join(rows) + "\n")
    tok = load_text_encoder("character", str(table / "vocab.txt"))
    jtok = jax_text_encoder("character", str(table / "vocab.txt"))
    from end_to_end_asr_pytorch_tpu_torch.utils.bert_embedding import \
        load_vec_table
    got = load_vec_table(str(vec), tok)
    np.testing.assert_array_equal(got, jax_bert.load_vec_table(str(vec), jtok))
    assert (got[3:] != 0).any(axis=1).sum() == 2        # a and h
    p = EmbeddingRegularizer({"src": str(vec)}, VOCAB, 32, tokenizer=tok)
    j = JaxPlugin({"src": str(vec)}, VOCAB, 32, tokenizer=jtok)
    np.testing.assert_allclose(to_np(p.table), np.asarray(j.table), atol=1e-7)
    with pytest.raises(ValueError, match="tokenizer"):
        EmbeddingRegularizer({"src": str(vec)}, VOCAB, 32)
    with pytest.raises(ValueError, match="vocab"):
        EmbeddingRegularizer({"src": str(table / "emb.npy")}, VOCAB + 1, 32)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_fused_log_prob_match_jax(table, seed):
    jplug, jpp, pplug = _plugins(table, seed)
    rng = np.random.RandomState(seed)
    dec = rng.randn(3, 8, 32).astype(np.float32)
    ref = jplug.loss(jpp, jnp.asarray(dec), jnp.asarray(TEXT))
    got = pplug.loss(torch.from_numpy(dec), torch.from_numpy(TEXT))
    np.testing.assert_allclose(float(got), float(ref), rtol=0, atol=1e-6)
    h = rng.randn(5, 32).astype(np.float32)
    logits = (rng.randn(5, VOCAB) * 3).astype(np.float32)
    ref = jplug.fused_log_prob(jpp, jnp.asarray(h), jnp.asarray(logits))
    got = pplug.fused_log_prob(torch.from_numpy(h), torch.from_numpy(logits))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0, atol=1e-6)
    # a bf16 decoder state (amp) is widened, as the JAX promotion does
    hb = torch.from_numpy(h).to(torch.bfloat16)
    ref = jplug.fused_log_prob(jpp, jnp.asarray(h, jnp.bfloat16),
                               jnp.asarray(logits))
    got = pplug.fused_log_prob(hb, torch.from_numpy(logits))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0, atol=1e-6)


def _asr(seed):
    jm = JaxASR(40, VOCAB, ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = asr_from_arrays(40, VOCAB, ASR_CFG, jax_arrays(jp), device="cpu")
    w, wl = waves(seed)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    return jm, jp, pm, (jf, jfl), (pf, pfl)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_with_fusion_matches_jax(table, seed):
    jplug, jpp, pplug = _plugins(table, seed, fuse=0.6)
    jm, jp, pm, (jf, jfl), (pf, pfl) = _asr(seed)
    jenc, jel = jm.encode(jp, jf, jfl)
    ref = jax_att_greedy(jm, jp, jenc, jel, 9, plugin=jplug,
                         plugin_params=jpp)
    with torch.no_grad():
        penc, pel = pm.encode(pf, pfl)
        got = att_greedy(pm, penc, pel, 9, plugin=pplug)
        plain = att_greedy(pm, penc, pel, 9)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    assert not torch.equal(got, plain)          # the fusion acts


@pytest.mark.parametrize("temp", [1.0, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_beam_with_fusion_matches_jax(table, seed, temp):
    from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
    jplug, jpp, pplug = _plugins(table, seed, temp=temp)
    jm, jp, pm, (jf, jfl), (pf, pfl) = _asr(seed)
    jlm = JaxLM(VOCAB, LM_CFG)
    jlp = jlm.init(jax.random.PRNGKey(100 + seed))
    plm = lm_from_arrays(VOCAB, LM_CFG, jax_arrays(jlp), device="cpu")
    ref = JaxBeam(jm, DECODE_CFG, lm=jlm, plugin=jplug).forward(
        jp, jf, jfl, lm_params=jlp, plugin_params=jpp)
    dec = BeamDecoder(pm, DECODE_CFG, lm=plm, plugin=pplug)
    got = dec.forward(pf, pfl)
    assert dec.last_fused is False               # K8's scope ends here
    np.testing.assert_array_equal(to_np(got.lengths), np.asarray(ref.lengths))
    np.testing.assert_array_equal(to_np(got.tokens), np.asarray(ref.tokens))
    np.testing.assert_allclose(to_np(got.scores), np.asarray(ref.scores),
                               atol=1e-4, rtol=0)
    # fuse 0: the plugin is no part of decoding, and K8 keeps its route
    _, _, off = _plugins(table, seed, fuse=0.0)
    d0 = BeamDecoder(pm, DECODE_CFG, lm=plm, plugin=off)
    d0.forward(pf, pfl)
    assert d0.plugin is None and d0.last_fused is True


def _solver(tmp_path, cfg, plugin_cfg):
    config = {"data": {"corpus": {"name": "none"}, "audio": AUDIO_CFG,
                       "text": {"mode": "character"}},
              "model": dict(cfg, plugin=plugin_cfg),
              "hparas": {"optimizer": "Adadelta", "lr": 1.0,
                         "tf_start": 1.0, "tf_end": 1.0}}
    paras = SimpleNamespace(config="plug.yaml", name=None, seed=0,
                            logdir=str(tmp_path / "log"),
                            ckpdir=str(tmp_path / "ckpt"), load=None,
                            njobs=0, no_msg=True, cpu=True, amp=False)
    solver = Solver(config, paras)
    solver.feat_dim, solver.vocab_size = 40, VOCAB
    solver.set_model()
    return solver


@pytest.mark.parametrize("k7", [False, True])
def test_train_step_with_plugin_matches_jax(table, tmp_path, k7, monkeypatch):
    """``Solver.train_step`` with the plugin: the JAX solver's loss_fn
    with ``get_dec_state`` and ``emb_loss``, on the plain attention route
    or K7's (``use_pallas_train``; its plain version on the CPU)."""
    cfg = copy.deepcopy(ASR_CFG)
    cfg["attention"]["use_pallas_train"] = k7
    plugin_cfg = {"src": str(table / "emb.npy"), "weight": 0.7}
    jm = JaxASR(40, VOCAB, cfg)
    jplug = JaxPlugin(plugin_cfg, VOCAB, 32)
    params = {"asr": jm.init(jax.random.PRNGKey(5)),
              "plugin": jplug.init(jax.random.PRNGKey(6))}
    w, wl = waves(5)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    text, text_len = jnp.asarray(TEXT), jnp.asarray(TEXT_LEN)

    def loss_fn(p):
        ctc_out, enc_len, att_out, _, dec = jm.forward(
            p["asr"], jf, jfl, TEXT.shape[1], 1.0, teacher=text, train=True,
            rng=jax.random.PRNGKey(7), get_dec_state=True)
        nll = jax_ctc_loss(ctc_out, enc_len, text, text_len)
        valid = text_len > 0
        per = nll / jnp.maximum(text_len, 1)
        ctc_l = jnp.sum(jnp.where(valid & (nll < 1e29), per, 0.0)) / \
            jnp.maximum(jnp.sum(valid), 1)
        emb = jplug.loss(p["plugin"], dec, text)
        return 0.5 * ctc_l + 0.5 * jax_masked_ce(att_out, text) + emb, emb

    (ref_loss, ref_emb), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    solver = _solver(tmp_path, cfg, plugin_cfg)
    arrays = jax_arrays(params)
    load_arrays(solver.model, arrays, solver.plugin)
    seen = []
    apply = port_attention.LocAttTrain.apply
    monkeypatch.setattr(port_attention, "LocAttTrain", type("Spy", (), {
        "apply": staticmethod(lambda *a: seen.append(1) or apply(*a))}))
    m = solver.train_step(torch.from_numpy(w), torch.from_numpy(wl),
                          torch.from_numpy(TEXT).long(),
                          torch.from_numpy(TEXT_LEN).long())
    assert len(seen) == (TEXT.shape[1] if k7 else 0)
    np.testing.assert_allclose(float(m["loss"]), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["emb_loss"]), float(ref_emb), rtol=1e-5)
    got = {n: to_np(p.grad) for n, p in solver.params.items()}
    ref = {port_name(k).removeprefix("asr."): v
           for k, v in jax_arrays(ref_grads).items()}
    assert sorted(got) == sorted(ref)
    for name, g in ref.items():
        want = g.T if name == "plugin.w_proj" else _to_port_layout(name, g)
        np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        assert np.any(got[name] != 0), name


def test_checkpoints_carry_the_plugin(table, tmp_path):
    """The JAX native {'asr', 'plugin'} file into the port; the port's
    torch file into the JAX loader and back; a file with no plugin
    entries leaves the plugin at its initial values."""
    jm = JaxASR(40, VOCAB, ASR_CFG)
    jplug = JaxPlugin({"src": str(table / "emb.npy")}, VOCAB, 32)
    params = {"asr": jm.init(jax.random.PRNGKey(1)),
              "plugin": jplug.init(jax.random.PRNGKey(2))}
    save_checkpoint(str(tmp_path / "native.pth"), params, global_step=4)
    pm = ASR(40, VOCAB, ASR_CFG, device="cpu")
    pplug = EmbeddingRegularizer({"src": str(table / "emb.npy")}, VOCAB, 32)
    ck = jax_ckpt.load_checkpoint(str(tmp_path / "native.pth"), pm, pplug)
    assert ck["global_step"] == 4 and ck["format"] == "native"
    np.testing.assert_array_equal(to_np(pplug.w_proj),
                                  np.asarray(params["plugin"].w_proj).T)
    np.testing.assert_array_equal(to_np(pm.char_w),
                                  np.asarray(params["asr"].char_w))
    # without a plugin module the plugin part is skipped
    jax_ckpt.load_checkpoint(str(tmp_path / "native.pth"),
                             ASR(40, VOCAB, ASR_CFG, device="cpu"))
    # the port's writer -> the JAX loader and the port's reader
    torch_ckpt.save_checkpoint(tmp_path / "port.pth", pm, global_step=6,
                               plugin=pplug)
    template = {"asr": jm.init(jax.random.PRNGKey(8)),
                "plugin": jplug.init(jax.random.PRNGKey(9))}
    back = jax_load_torch(str(tmp_path / "port.pth"), template)["model"]
    np.testing.assert_array_equal(np.asarray(back["plugin"].w_proj),
                                  np.asarray(params["plugin"].w_proj))
    np.testing.assert_array_equal(np.asarray(back["plugin"].b_proj),
                                  np.asarray(params["plugin"].b_proj))
    again = EmbeddingRegularizer({"src": str(table / "emb.npy")}, VOCAB, 32)
    jax_ckpt.load_checkpoint(str(tmp_path / "port.pth"),
                             ASR(40, VOCAB, ASR_CFG, device="cpu"), again)
    assert torch.equal(again.w_proj, pplug.w_proj)
    assert torch.equal(again.b_proj, pplug.b_proj)
    # a reference file without the projection: initial values stay
    torch.save({"model": export_asr_state_dict(params["asr"])},
               str(tmp_path / "ref.pth"))
    fresh = EmbeddingRegularizer({"src": str(table / "emb.npy")}, VOCAB, 32,
                                 generator=torch.Generator().manual_seed(0))
    init = fresh.w_proj.clone()
    jax_ckpt.load_checkpoint(str(tmp_path / "ref.pth"),
                             ASR(40, VOCAB, ASR_CFG, device="cpu"), fresh)
    assert torch.equal(fresh.w_proj, init)
    save_checkpoint(str(tmp_path / "plain.pth"), params["asr"])
    with pytest.raises(KeyError, match="no plugin"):
        jax_ckpt.load_checkpoint(str(tmp_path / "plain.pth"),
                                 ASR(40, VOCAB, ASR_CFG, device="cpu"), fresh)


def test_entry_points_with_plugin_augment_and_decode_keys(tmp_path, capsys):
    """``main`` 2 steps with SpecAugment and the plugin, then ``main
    --test`` with the plugin fused, ``psi_quant`` and ``ctc_candidates``
    (its CSVs equal to the JAX test solver's on the port's checkpoint),
    then ``transcribe``."""
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    root = tmp_path / "synth"
    generate_corpus(str(root), n_train=6, n_dev=3, n_test=3, seed=0,
                    max_words=2)
    bert_embedding.main(["--vocab_file", str(root / "vocab.txt"), "--output",
                         str(tmp_path / "emb.npy"), "--method", "hash",
                         "--dim", "24"])
    cfg = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    cfg["data"]["corpus"].update(path=str(root), batch_size=3)
    cfg["data"]["text"]["vocab_file"] = str(root / "vocab.txt")
    cfg["data"]["audio"]["augment"] = {"time_mask_width": 8}
    cfg["model"]["encoder"]["dim"] = [16, 16]
    cfg["model"]["attention"].update(dim=8, loc_kernel_size=6,
                                     loc_kernel_num=2)
    cfg["model"]["decoder"]["dim"] = 16
    cfg["model"]["plugin"] = {"src": str(tmp_path / "emb.npy"), "weight": 0.5,
                              "fuse": 0.3, "temp": 1.0}
    cfg["hparas"].update(max_step=2, valid_step=2, PROGRESS_STEP=1)
    cfg["decode"] = {"beam_size": 3, "max_len_ratio": 0.6, "ctc_weight": 0.3,
                     "psi_quant": "int8", "ctc_candidates": 8,
                     "approx_topk": 0.9}
    path = tmp_path / "plug.yaml"
    path.write_text(yaml.safe_dump(cfg))
    common = ["--config", str(path), "--cpu", "--no-msg"]
    port_main.main([*common, "--logdir", str(tmp_path / "log"), "--ckpdir",
                    str(tmp_path / "ckpt")])
    ck = tmp_path / "ckpt" / "plug_sd0" / "latest.pth"
    sd = torch.load(str(ck), weights_only=True)
    assert sd["global_step"] == 2
    assert sd["model"]["plugin.w_proj"].shape == (24, 16)
    assert set(sd["optimizer"]["slots"]) >= {"plugin.w_proj", "plugin.b_proj"}
    log = (tmp_path / "log" / "plug_sd0" / "log.jsonl").read_text()
    assert "tr_emb_loss" in log
    port_main.main(["--config", str(path), "--cpu", "--test", "--load",
                    str(ck), "--outdir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert out.count("| beam unfused") == 2, out
    got = {f.name: f.read_text()
           for f in (tmp_path / "out" / "plug_sd0").glob("*.csv")}
    jpar = _paras(tmp_path / "jax", "plug", load=str(ck))
    jpar.test = True
    js = JaxTestSolver(jax_load_config(str(path)), jpar, "test")
    js.load_data()
    js.set_model()
    js.exec()
    ref = {f.name: f.read_text()
           for f in (tmp_path / "jax" / "out" / "plug_sd0").glob("*.csv")}
    assert sorted(got) == sorted(ref) and len(got) == 4
    for name in ref:
        if name.endswith("_output.csv"):
            assert got[name] == ref[name]
    wavs = sorted(str(p) for p in (root / "test-clean").rglob("*.wav"))
    transcribe.main(["--config", str(path), "--load", str(ck), "--cpu",
                     "--output", str(tmp_path / "t.tsv"), *wavs])
    rows = (tmp_path / "t.tsv").read_text().strip().split("\n")
    assert len(rows) == len(wavs) == 3
