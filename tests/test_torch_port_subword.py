"""The port's subword tokenizers and a subword transcribe against the JAX
package on the CPU.

Both encoders (the binary sentencepiece reader with unigram Viterbi, and the
JSON BPE) must give the JAX package's ids and the same text back, CTC
collapse included; the port's ``serialize_model_proto`` must write the JAX
package's bytes; and ``transcribe`` with a subword YAML must write the root
tool's TSV rows, also with ``decode.psi_kernel: true`` (V=128 opens K6's
gate, whose plain version runs on the CPU). Exact equality throughout.
"""
import copy
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.utils import sentencepiece_model as jspm
from end_to_end_asr_pytorch_tpu.utils import text as jtext
from end_to_end_asr_pytorch_tpu_torch.utils import sentencepiece_model as pspm
from end_to_end_asr_pytorch_tpu_torch.utils import text as ptext
from tests.torch_port_fixtures import ASR_CFG, AUDIO_CFG, waves

WORDS = ["the", "cat", "sat", "on", "mat", "dog", "log", "hello", "world",
         "speech", "recognition", "beam", "search", "token"]
TEXTS = ["the cat sat on the mat", "hello world", "speech recognition",
         "beam search token", "the dog sat on a log", "catalog zebra",
         "  spaced   out  ", ""]


def spm_pieces(n: int, seed: int = 0):
    """(piece, score, type) of a unigram model with ``n`` pieces: the
    reserved three, then whole words, word prefixes and single letters."""
    rng = np.random.RandomState(seed)
    out = [("<pad>", 0.0, pspm.TYPE_CONTROL), ("</s>", 0.0, pspm.TYPE_CONTROL),
           ("<unk>", 0.0, pspm.TYPE_UNKNOWN)]
    cands = ["▁" + w for w in WORDS] + ["▁" + w[:k] for w in WORDS
                                          for k in (1, 2, 3)]
    cands += list("abcdefghijklmnopqrstuvwxy") + ["▁"]
    cands += [w[k:] for w in WORDS for k in (1, 2, 3)]
    seen = set()
    for c in cands:
        if c not in seen and len(out) < n:
            seen.add(c)
            out.append((c, float(-rng.uniform(1, 12)), pspm.TYPE_NORMAL))
    i = 0
    while len(out) < n:                     # filler pieces no text uses
        out.append((f"▁q{i}", -20.0, pspm.TYPE_NORMAL))
        i += 1
    return out


def bpe_model():
    vocab = ["<pad>", "<eos>", "<unk>", "▁", "▁t", "▁th", "▁the", "▁c", "a",
             "t", "at", "▁ca", "▁cat", "s", "▁s", "▁sat", "o", "n", "▁o",
             "▁on", "m", "▁m", "▁mat", "h", "e", "l", "d", "g"]
    merges = [["▁t", "h"], ["▁th", "e"], ["▁c", "a"], ["▁ca", "t"],
              ["a", "t"], ["▁s", "at"], ["▁o", "n"], ["▁m", "at"]]
    return {"vocab": vocab, "merges": merges}


def test_serialize_model_proto_writes_the_jax_bytes():
    pieces = spm_pieces(64)
    data = pspm.serialize_model_proto(pieces)
    assert data == jspm.serialize_model_proto(pieces)
    assert pspm.parse_model_proto(data) == jspm.parse_model_proto(data)


@pytest.mark.parametrize("n", [40, 128])
def test_sentencepiece_encoder_matches_jax(tmp_path, n):
    f = tmp_path / "sp.model"
    f.write_bytes(pspm.serialize_model_proto(spm_pieces(n, seed=n)))
    pe = ptext.load_text_encoder("subword", str(f))
    je = jtext.load_text_encoder("subword", str(f))
    assert isinstance(pe, ptext.SentencePieceTextEncoder)
    assert pe.vocab_size == je.vocab_size == n
    rng = np.random.RandomState(n)
    for text in TEXTS:
        ids = pe.encode(text)
        assert ids == je.encode(text)
        assert pe.decode(ids) == je.decode(ids)
        # CTC-style frame ids: repeats and blanks between the pieces
        frames = []
        for i in ids[:-1]:
            frames += [i] * rng.randint(1, 3) + [0] * rng.randint(0, 2)
        assert (pe.decode(frames, ignore_repeat=True)
                == je.decode(frames, ignore_repeat=True))


def test_json_bpe_encoder_matches_jax(tmp_path):
    f = tmp_path / "bpe.json"
    f.write_text(json.dumps(bpe_model()))
    pe = ptext.load_text_encoder("subword", str(f))
    je = jtext.load_text_encoder("subword", str(f))
    assert isinstance(pe, ptext.SubwordTextEncoder)
    assert pe.vocab_size == je.vocab_size
    for text in TEXTS + ["that cat", "zzz the"]:
        ids = pe.encode(text)
        assert ids == je.encode_py(text) == je.encode(text)
        assert pe.decode(ids) == je.decode(ids)
        frames = [i for i in ids for _ in range(2)] + [0, 5, 5, 0, 5]
        assert (pe.decode(frames, ignore_repeat=True)
                == je.decode(frames, ignore_repeat=True))


def test_subword_index_contract_raises_as_in_jax(tmp_path):
    bad = [("a", -1.0, pspm.TYPE_NORMAL)] + spm_pieces(20)
    f = tmp_path / "bad.model"
    f.write_bytes(pspm.serialize_model_proto(bad))
    for mod in (ptext, jtext):
        with pytest.raises(ValueError, match="0=<pad>"):
            mod.load_text_encoder("subword", str(f))
    g = tmp_path / "bad.json"
    g.write_text(json.dumps({"vocab": ["a", "b", "c"], "merges": []}))
    with pytest.raises(ValueError, match="<pad> <eos> <unk>"):
        ptext.load_text_encoder("subword", str(g))


V_SUB = 128


def _write_subword_inputs(tmp_path, decode_extra=None):
    """A sentencepiece model of V_SUB pieces, a subword YAML, two WAVs and a
    reference-layout checkpoint of a JAX-initialised model."""
    import yaml
    import torch
    from end_to_end_asr_pytorch_tpu.data.audio_io import write_wav
    from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
    from tests.test_torch_ckpt import export_asr_state_dict
    sp = tmp_path / "sp.model"
    sp.write_bytes(pspm.serialize_model_proto(spm_pieces(V_SUB)))
    cfg = {
        "data": {"corpus": {"name": "none"}, "audio": dict(AUDIO_CFG),
                 "text": {"mode": "subword", "vocab_file": str(sp)}},
        "model": copy.deepcopy(ASR_CFG), "hparas": {},
        "decode": {"beam_size": 3, "min_len_ratio": 0.0,
                   "max_len_ratio": 0.5, "ctc_weight": 0.3,
                   **(decode_extra or {})},
    }
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    w, wl = waves(31, lens=(4800, 3900))
    paths = []
    for i in range(2):
        p = tmp_path / f"utt{i}.wav"
        write_wav(str(p), w[i, :wl[i]])
        paths.append(str(p))
    jm = JaxASR(40, V_SUB, ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(31))
    torch.save({"model": export_asr_state_dict(jp)}, str(tmp_path / "m.pth"))
    return paths


def test_load_config_reads_the_subword_yaml(tmp_path):
    from end_to_end_asr_pytorch_tpu_torch.config import load_config
    _write_subword_inputs(tmp_path, {"psi_kernel": True})
    cfg = load_config(str(tmp_path / "cfg.yaml"))
    assert cfg["data"]["text"]["mode"] == "subword"
    assert cfg["decode"]["psi_kernel"] is True
    tok = ptext.load_text_encoder(**cfg["data"]["text"])
    assert tok.vocab_size == V_SUB


def test_subword_transcribe_matches_root_tool(tmp_path, monkeypatch):
    """The root tool (JAX) and the port's transcribe on a subword YAML; the
    port again with decode.psi_kernel: true and fused_step: false (K6's
    route; its plain version on the CPU) writes the same rows."""
    import transcribe as jax_transcribe
    import yaml
    from end_to_end_asr_pytorch_tpu_torch import transcribe
    from end_to_end_asr_pytorch_tpu_torch.ops import ctc_prefix
    paths = _write_subword_inputs(tmp_path)
    common = ["--config", str(tmp_path / "cfg.yaml"), "--load",
              str(tmp_path / "m.pth"), "--cpu", "--batch", "2", *paths]
    monkeypatch.setattr(sys, "argv", ["transcribe.py", *common, "--output",
                                      str(tmp_path / "jax.tsv")])
    jax_transcribe.main()
    transcribe.main([*common, "--output", str(tmp_path / "port.tsv")])
    ref = (tmp_path / "jax.tsv").read_text()
    assert len(ref.strip().split("\n")) == 2
    assert (tmp_path / "port.tsv").read_text() == ref
    cfg = yaml.safe_load((tmp_path / "cfg.yaml").read_text())
    cfg["decode"]["psi_kernel"] = True
    cfg["decode"]["fused_step"] = False     # K8's route leaves psi to K8
    (tmp_path / "cfg_k6.yaml").write_text(yaml.safe_dump(cfg))
    calls = []
    orig = ctc_prefix.score_candidates
    monkeypatch.setattr(ctc_prefix, "score_candidates",
                        lambda *a, **k: calls.append(k.get("psi_kernel"))
                        or orig(*a, **k))
    transcribe.main(["--config", str(tmp_path / "cfg_k6.yaml"),
                     *common[2:], "--output", str(tmp_path / "k6.tsv")])
    assert True in calls
    assert (tmp_path / "k6.tsv").read_text() == ref
