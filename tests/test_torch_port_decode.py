"""The port's serving path against the JAX package: beam decode with CTC
prefix scoring and LM fusion from raw waves, its parts (attention step,
decoder tables, LM step, CTC prefix scorer), the two weight loaders, the
``transcribe`` entry point, and the port's import and device rules.

Weights are made by the JAX package and moved into the port through its
weight bridge; inputs come from ``np.random.RandomState``. The beam must give
identical tokens and lengths; scores agree within atol 1e-4 (f32 sums taken
in another order)."""
import ast
import copy
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.decode.beam import BeamDecoder as JaxBeam
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.models.attention import Attention as JaxAttention
from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
from end_to_end_asr_pytorch_tpu.ops import ctc_prefix as jctc
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
from end_to_end_asr_pytorch_tpu_torch.models.attention import Attention
from end_to_end_asr_pytorch_tpu_torch.ops import ctc_prefix
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import (fbank_kernel,
                                                        lstm_kernel,
                                                        psi_kernel)
from end_to_end_asr_pytorch_tpu_torch.utils import torch_ckpt
from end_to_end_asr_pytorch_tpu_torch.utils.device import resolve_device
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    asr_from_arrays, load_arrays, lm_from_arrays)
from tests.test_torch_ckpt import export_asr_state_dict
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, LM_CFG, VOCAB,
                                       jax_arrays, to_np, waves)

torch.set_num_threads(1)
ATOL = 1e-4
DECODE_CFG = {"beam_size": 4, "min_len_ratio": 0.05, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3}


@functools.lru_cache(maxsize=None)
def _models(seed):
    jm = JaxASR(40, VOCAB, ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(seed))
    jlm = JaxLM(VOCAB, LM_CFG)
    jlp = jlm.init(jax.random.PRNGKey(100 + seed))
    pm = asr_from_arrays(40, VOCAB, ASR_CFG, jax_arrays(jp), device="cpu")
    plm = lm_from_arrays(VOCAB, LM_CFG, jax_arrays(jlp), device="cpu")
    return jm, jp, jlm, jlp, pm, plm


@functools.lru_cache(maxsize=None)
def _jax_beam(seed):
    """The JAX package's decode of seed's waves. Its early exit is exact
    (tests/test_beam_earlystop.py), so one reference serves both settings
    of the port's."""
    jm, jp, jlm, jlp, _, _ = _models(seed)
    w, wl = waves(seed)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    return JaxBeam(jm, DECODE_CFG, lm=jlm).forward(jp, jf, jfl, lm_params=jlp)


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_decode_from_waves_matches_jax(seed, early_stop):
    _, _, _, _, pm, plm = _models(seed)
    cfg = dict(DECODE_CFG, early_stop=early_stop)
    w, wl = waves(seed)
    ref = _jax_beam(seed)
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    got = BeamDecoder(pm, cfg, lm=plm).forward(pf, pfl)
    np.testing.assert_array_equal(to_np(got.lengths), np.asarray(ref.lengths))
    np.testing.assert_array_equal(to_np(got.tokens), np.asarray(ref.tokens))
    np.testing.assert_allclose(to_np(got.scores), np.asarray(ref.scores),
                               atol=ATOL, rtol=0)


def test_beam_ctc_only_and_no_lm_match_jax():
    """Decode-time weights at the edges: CTC-free scoring, and CTC with
    no LM, on features with ragged lengths."""
    jm, jp, _, _, pm, _ = _models(4)
    rng = np.random.RandomState(4)
    feat = rng.randn(3, 28, 40).astype(np.float32)
    flen = np.asarray([28, 21, 12], np.int32)
    for cw in (0.0, 0.6):
        cfg = {"beam_size": 3, "max_len_ratio": 0.8, "ctc_weight": cw}
        ref = JaxBeam(jm, cfg).forward(jp, jnp.asarray(feat), jnp.asarray(flen))
        got = BeamDecoder(pm, cfg).forward(torch.from_numpy(feat),
                                           torch.from_numpy(flen))
        np.testing.assert_array_equal(to_np(got.tokens), np.asarray(ref.tokens))
        np.testing.assert_array_equal(to_np(got.lengths),
                                      np.asarray(ref.lengths))
        np.testing.assert_allclose(to_np(got.scores), np.asarray(ref.scores),
                                   atol=ATOL, rtol=0)


ATT_CASES = {
    "loc_even_kernel": ASR_CFG["attention"],
    "loc_2head_merge": dict(ASR_CFG["attention"], num_head=2,
                            loc_kernel_size=5, temperature=1.0),
    "dot_2head_no_vproj": {"mode": "dot", "dim": 16, "num_head": 2,
                           "temperature": 0.7, "v_proj": False},
}


@pytest.mark.parametrize("name", sorted(ATT_CASES))
def test_attention_step_beam_matches_jax(name):
    cfg = ATT_CASES[name]
    Dq, Dk, B, K, T = 24, 20, 3, 4, 11
    ja = JaxAttention(cfg, Dq, Dk)
    jp = ja.init(jax.random.PRNGKey(2))
    pa = load_arrays(Attention(cfg, Dq, Dk, device="cpu"), jax_arrays(jp))
    rng = np.random.RandomState(2)
    enc = rng.randn(B, T, Dk).astype(np.float32)
    elen = np.asarray([11, 7, 3], np.int32)
    q = rng.randn(B, K, Dq).astype(np.float32)
    jc = ja.precompute(jp, jnp.asarray(enc), jnp.asarray(elen))
    pc = pa.precompute(torch.from_numpy(enc), torch.from_numpy(elen))
    prev = np.asarray(jnp.broadcast_to(ja.init_align(jc)[:, None],
                                       (B, K, ja.num_head, T)))
    prev = prev * rng.uniform(0.5, 1.5, size=prev.shape).astype(np.float32)
    np.testing.assert_allclose(to_np(pa.init_align(pc)),
                               np.asarray(ja.init_align(jc)), atol=0, rtol=0)
    rctx, ral = ja.step_beam(jp, jc, jnp.asarray(q), jnp.asarray(prev))
    gctx, gal = pa.step_beam(pc, torch.from_numpy(q), torch.from_numpy(prev))
    np.testing.assert_allclose(to_np(gal), np.asarray(ral), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to_np(gctx), np.asarray(rctx), atol=ATOL, rtol=0)


def test_decode_step_tables_and_tied_lm_match_jax():
    """The x0_proj table path of the decoder step and an emb-tied LM's
    table path give the JAX package's logits."""
    jm, jp, _, _, pm, _ = _models(6)
    B, K, T = 2, 3, 7
    rng = np.random.RandomState(6)
    enc = rng.randn(B, T, jm.encoder.out_dim).astype(np.float32)
    elen = np.asarray([7, 4], np.int32)
    tok = rng.randint(0, VOCAB, size=(B * K,))
    jc = jm.attention.precompute(jp.attention, jnp.asarray(enc), jnp.asarray(elen))
    jst = jm.decoder.init_state(B * K)
    jal = jnp.broadcast_to(jm.attention.init_align(jc)[:, None], (B, K, 1, T))
    ref = jm.decode_step_beam(jp, jc, jst, jal, jnp.asarray(tok), K,
                              tables=jm.precompute_decode_tables(jp))[0]
    pc = pm.attention.precompute(torch.from_numpy(enc), torch.from_numpy(elen))
    pal = pm.attention.init_align(pc)[:, None].expand(B, K, 1, T)
    for tables in (pm.precompute_decode_tables(), None):
        got = pm.decode_step_beam(pc, pm.decoder.init_state(B * K), pal,
                                  torch.from_numpy(tok), K, tables=tables)[0]
        np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL,
                                   rtol=0)
    lm_cfg = dict(LM_CFG, emb_tying=True, layer=2)
    jlm = JaxLM(VOCAB, lm_cfg)
    jlp = jlm.init(jax.random.PRNGKey(6))
    plm = lm_from_arrays(VOCAB, lm_cfg, jax_arrays(jlp), device="cpu")
    rl, _ = jlm.step(jlp, jlm.init_state(B), jnp.asarray(tok[:B]),
                     emb_proj=jlm.emb_proj_table(jlp))
    for emb_proj in (plm.emb_proj_table(), None):
        gl, _ = plm.step(plm.init_state(B), torch.from_numpy(tok[:B]),
                         emb_proj=emb_proj)
        np.testing.assert_allclose(to_np(gl), np.asarray(rl), atol=ATOL, rtol=0)


def test_ctc_prefix_scorer_matches_jax():
    """psi over the full vocab and the C=1 winner-state recompute from a
    non-trivial prefix state."""
    B, K, T, V = 2, 3, 9, 7
    rng = np.random.RandomState(12)
    lp = rng.randn(B, T, V).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    elen = np.asarray([9, 6], np.int32)
    jlp = jctc.pad_ctc_log_probs(jnp.asarray(lp), jnp.asarray(elen))
    plp = ctc_prefix.pad_ctc_log_probs(torch.from_numpy(lp),
                                       torch.from_numpy(elen))
    np.testing.assert_array_equal(to_np(plp), np.asarray(jlp))
    jr, _ = jctc.init_state(jlp, K)
    last = rng.randint(3, V, size=(B, K))
    plen = np.full((B, K), 1)
    cand = rng.randint(1, V, size=(B, K, 1))
    # advance one step so r is not the empty-prefix state
    _, jr1 = jctc.score_candidates(jlp, jr, jnp.asarray(last),
                                   jnp.zeros((B, K), jnp.int32),
                                   cand_ids=jnp.asarray(last[..., None]))
    jr1 = jr1[:, :, 0]
    r1_port = torch.tensor(np.asarray(jr1))
    rpsi, _ = jctc.score_candidates(jlp, jr1, jnp.asarray(last),
                                    jnp.asarray(plen), with_state=False)
    gpsi, _ = ctc_prefix.score_candidates(plp, r1_port, torch.from_numpy(last),
                                          torch.from_numpy(plen),
                                          with_state=False)
    np.testing.assert_allclose(to_np(gpsi), np.asarray(rpsi), atol=ATOL, rtol=0)
    _, rr = jctc.score_candidates(jlp, jr1, jnp.asarray(last), jnp.asarray(plen),
                                  cand_ids=jnp.asarray(cand))
    _, gr = ctc_prefix.score_candidates(plp, r1_port, torch.from_numpy(last),
                                        torch.from_numpy(plen),
                                        cand_ids=torch.from_numpy(cand))
    np.testing.assert_allclose(to_np(gr), np.asarray(rr), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to_np(ctc_prefix.final_score(gr[:, :, 0])),
                               np.asarray(jctc.final_score(rr[:, :, 0])),
                               atol=ATOL, rtol=0)


BRIDGE_CASES = {
    "vgg_loc_lstm": ASR_CFG,
    "cnn_dot_gru": {
        "ctc_weight": 0.3,
        "encoder": {"prenet": "cnn", "module": "GRU", "bidirection": False,
                    "dim": [16, 16], "sample_rate": [1, 1],
                    "sample_style": "concat", "layer_norm": [True, False],
                    "proj": [False, True]},
        "attention": {"mode": "dot", "dim": 12, "num_head": 2,
                      "temperature": 1.0, "v_proj": True},
        "decoder": {"module": "GRU", "dim": 16, "layer": 2},
    },
}


@pytest.mark.parametrize("name", sorted(BRIDGE_CASES))
def test_weight_bridge_and_ckpt_loader_agree(name, tmp_path):
    cfg = BRIDGE_CASES[name]
    jm = JaxASR(40, VOCAB, cfg)
    jp = jm.init(jax.random.PRNGKey(9))
    bridged = asr_from_arrays(40, VOCAB, cfg, jax_arrays(jp), device="cpu")
    f = tmp_path / "ref.pth"
    torch.save({"model": export_asr_state_dict(jp), "global_step": 3}, str(f))
    from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
    loaded = ASR(40, VOCAB, cfg, device="cpu")
    ck = torch_ckpt.load_torch_checkpoint(str(f), loaded)
    assert ck["global_step"] == 3
    a, b = bridged.state_dict(), loaded.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def _write_transcribe_inputs(tmp_path):
    from end_to_end_asr_pytorch_tpu.data.audio_io import write_wav
    import yaml
    chars = list("abcdefgh") + ["<space>"]
    (tmp_path / "vocab.txt").write_text("\n".join(chars) + "\n")
    cfg = {
        "data": {"corpus": {"name": "none"},
                 "audio": dict(AUDIO_CFG),
                 "text": {"mode": "character",
                          "vocab_file": str(tmp_path / "vocab.txt")}},
        "model": copy.deepcopy(ASR_CFG), "hparas": {},
        "decode": {"beam_size": 3, "min_len_ratio": 0.0,
                   "max_len_ratio": 0.5, "ctc_weight": 0.3},
    }
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    w, wl = waves(21, lens=(4800, 3900))
    paths = []
    for i in range(2):
        p = tmp_path / f"utt{i}.wav"
        write_wav(str(p), w[i, :wl[i]])
        paths.append(str(p))
    jm = JaxASR(40, 3 + len(chars), ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(21))
    torch.save({"model": export_asr_state_dict(jp)}, str(tmp_path / "m.pth"))
    return paths


def test_transcribe_matches_root_tool(tmp_path, monkeypatch):
    import transcribe as jax_transcribe
    from end_to_end_asr_pytorch_tpu_torch import transcribe
    paths = _write_transcribe_inputs(tmp_path)
    common = ["--config", str(tmp_path / "cfg.yaml"), "--load",
              str(tmp_path / "m.pth"), "--cpu", "--batch", "2", *paths]
    monkeypatch.setattr(sys, "argv", ["transcribe.py", *common, "--output",
                                      str(tmp_path / "jax.tsv")])
    jax_transcribe.main()
    transcribe.main([*common, "--output", str(tmp_path / "port.tsv")])
    ref = (tmp_path / "jax.tsv").read_text()
    assert len(ref.strip().split("\n")) == 2
    assert (tmp_path / "port.tsv").read_text() == ref


def test_port_imports_no_jax_and_no_jax_package():
    """Every module of the port and chip_smoke.py: no jax / flax / optax,
    no orbax / tensorstore / zstd package, and nothing of
    end_to_end_asr_pytorch_tpu (matched as a whole name, since the port's
    own name extends it)."""
    banned = {"jax", "jaxlib", "flax", "optax", "end_to_end_asr_pytorch_tpu",
              "orbax", "tensorstore", "zstandard", "zstd", "numcodecs",
              "zarr"}
    files = sorted((ROOT / "end_to_end_asr_pytorch_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the entry points, solvers, kernel wrappers and checkpoint readers
    rel = {str(f.relative_to(ROOT / "end_to_end_asr_pytorch_tpu_torch"))
           for f in files[:-1]}
    assert {"main.py", "train.py", "transcribe.py", "solvers/test_asr.py",
            "ops/cuda/beam_step_kernel.py", "utils/jax_ckpt.py",
            "utils/torch_ckpt.py", "solvers/train_lm.py", "data/flac.py",
            "utils/native.py", "ops/augment.py", "models/plugin.py",
            "utils/bert_embedding.py", "utils/orbax.py", "utils/ocdbt.py",
            "utils/zstd.py", "utils/generate_vocab.py",
            "utils/metrics.py"} <= rel
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in banned:
                    bad.append(f"{f.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_port_builds_no_source_outside_its_package(tmp_path, monkeypatch):
    """Every source the port compiles lies inside its package: the four
    host libraries as ``utils/native.build`` is asked for them when each is
    first used (the FLAC decoder, the edit distance, the BPE encoder, the
    zstd decoder), the module constants that name them, and the CUDA
    sources' directory."""
    from end_to_end_asr_pytorch_tpu_torch.data.flac import read_flac
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build as cuda_build
    from end_to_end_asr_pytorch_tpu_torch.utils import metrics, native, zstd
    from end_to_end_asr_pytorch_tpu_torch.utils.text import SubwordTextEncoder
    from tests.flac_encoder import encode_flac
    pkg = ROOT / "end_to_end_asr_pytorch_tpu_torch"
    asked, real = [], native.build

    def spy(source, what):
        asked.append(Path(source).resolve())
        return real(source, what)
    monkeypatch.setattr(native, "build", spy)
    for attr in ("_lib", "_edit_lib", "_bpe_lib"):
        monkeypatch.setattr(native, attr, None)
    monkeypatch.setattr(zstd, "_lib", None)
    (tmp_path / "a.flac").write_bytes(encode_flac(np.arange(-50, 50,
                                                            dtype=np.int16)))
    assert len(read_flac(str(tmp_path / "a.flac"))[0]) == 100
    assert metrics.edit_distance("ab", "b") == 1
    assert SubwordTextEncoder(["<pad>", "<eos>", "<unk>", "\u2581a"],
                              []).encode("a a") == [3, 3, 1]
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert sorted(p.name for p in asked) == [
        "bpe_encoder.cc", "edit_distance.cc", "flac_decoder.cc",
        "zstd_decoder.cc"]
    constants = [native.SOURCE, native.EDIT_SOURCE, native.BPE_SOURCE,
                 zstd.SOURCE, cuda_build.CSRC]
    for p in asked + constants:
        assert pkg in Path(p).resolve().parents, p


def test_cpu_tensors_launch_no_kernel_and_entry_points_need_cuda(
        tmp_path, monkeypatch):
    f0, l0 = fbank_kernel.fbank_fused.launches, lstm_kernel.lstm_scan_fused.launches
    _, _, _, _, pm, _ = _models(0)
    w, wl = waves(0)
    feat, flen = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                        torch.from_numpy(wl))
    pm.encode(feat, flen)
    # an amp decode with psi_kernel on CPU tensors: plain versions only
    BeamDecoder(pm, {**DECODE_CFG, "amp": True, "psi_kernel": True}
                ).forward(feat, flen)
    assert fbank_kernel.fbank_fused.launches == f0 == 0
    assert lstm_kernel.lstm_scan_fused.launches == l0 == 0
    assert lstm_kernel.lstm_scan_bf16.launches == 0
    assert psi_kernel.psi_fused.launches == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    from end_to_end_asr_pytorch_tpu_torch import transcribe
    paths = _write_transcribe_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transcribe.main(["--config", str(tmp_path / "cfg.yaml"), "--load",
                         str(tmp_path / "m.pth"), *paths])
