"""The port's host runtime for text on the CPU: the native edit distance
(``native/edit_distance.cc``) and BPE encoder (``native/bpe_encoder.cc``)
through ``utils/native.py``, WER / CER (``utils/metrics.py``), the JSON BPE
``encode`` (``utils/text.py``) and the vocabulary generator
(``utils/generate_vocab.py``), against their plain versions and the JAX
package.

Edit distances and error rates equal the plain two-row DP and the JAX
package's exactly; ``encode`` equals ``encode_py`` (the JAX package's
reference walk) on any text, also where the JAX package's own native path
does not (whitespace other than ' ', NUL bytes, pieces holding '\\x01'),
and the JAX native path on space-separated text; the generator writes the
bytes of ``util/generate_vocab_file.py``. A missing compiler or a library
that does not load raises, naming the library.
"""
import importlib.util
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import yaml
from hypothesis import given, settings, strategies as st

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.utils import metrics as jmetrics
from end_to_end_asr_pytorch_tpu.utils import native as jnative
from end_to_end_asr_pytorch_tpu.utils import text as jtext
from end_to_end_asr_pytorch_tpu_torch.utils import generate_vocab
from end_to_end_asr_pytorch_tpu_torch.utils import metrics as pmetrics
from end_to_end_asr_pytorch_tpu_torch.utils import native
from end_to_end_asr_pytorch_tpu_torch.utils import text as ptext

SETTINGS = settings(max_examples=150, deadline=None, derandomize=True,
                    database=None)
# every separator str.split() knows, beside ' '
WHITESPACE = ("\t\n\r\x0b\x0c\x1c\x1d\x1e\x1f\x85\xa0 "
              + "".join(map(chr, range(0x2000, 0x200B)))
              + "    　")
LETTERS = "abcdefghijklmnopqrstuvwxyzéüßøçñ中文語▁"


def _load_jax_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_vocab_file", ROOT / "util" / "generate_vocab_file.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corpus_lines(seed=0, n_lines=400):
    """Lines of words drawn Zipf-like from one inventory of 120 words over
    LETTERS (the same for every seed, one word with a NUL byte inside)."""
    inv_rng, rng = np.random.RandomState(0), np.random.RandomState(seed)
    inv = ["".join(inv_rng.choice(list(LETTERS[:-1]), inv_rng.randint(1, 12)))
           for _ in range(120)]
    inv[5] = inv[5] + "\x00" + inv[6]
    p = 1.0 / np.arange(1, len(inv) + 1)
    p /= p.sum()
    return [" ".join(rng.choice(inv, rng.randint(3, 15), p=p))
            for _ in range(n_lines)]


@pytest.fixture(scope="module")
def bpe_json(tmp_path_factory):
    """A 300-piece JSON BPE written by the port's generator."""
    d = tmp_path_factory.mktemp("bpe")
    (d / "text.txt").write_text("\n".join(_corpus_lines()) + "\n",
                                encoding="utf-8")
    generate_vocab.main(["--input_file", str(d / "text.txt"), "--output_file",
                         str(d / "bpe.json"), "--mode", "subword",
                         "--vocab_size", "300"])
    return d / "bpe.json"


@pytest.fixture(scope="module")
def encoders(bpe_json):
    pe = ptext.load_text_encoder("subword", str(bpe_json))
    je = jtext.load_text_encoder("subword", str(bpe_json))
    assert isinstance(pe, ptext.SubwordTextEncoder)
    return pe, je


# ------------------------------------------------------------ edit distance
TOKENS = {
    "int": st.lists(st.integers(0, 4), max_size=30),
    "char": st.text(alphabet="abc dé\x00", max_size=40),
    "word": st.lists(st.sampled_from(["the", "cat", "hat", "a", "été",
                                      ""]), max_size=20),
}


@pytest.mark.parametrize("kind", sorted(TOKENS))
def test_edit_distance_equals_plain_and_jax(kind):
    @SETTINGS
    @given(TOKENS[kind], TOKENS[kind])
    def check(a, b):
        d = pmetrics.edit_distance_plain(a, b)
        assert native.edit_distance(a, b) == pmetrics.edit_distance(a, b) == d
        assert jmetrics.edit_distance(a, b) == d
        assert jmetrics._edit_distance_py(a, b) == d
        assert native.edit_distance_batch([a], [b]).tolist() == [d]
    check()


def test_edit_distance_batch_on_mixed_lengths():
    """One crossing for pairs of every shape: empty sides, 1 token, 300
    tokens, ints, characters and words, in one batch."""
    rng = np.random.RandomState(1)
    hyps, refs = [[], [], [1], "", "kitten"], [[], [2, 3], [], "abc",
                                              "sitting"]
    for _ in range(60):
        kind = rng.randint(3)
        n, m = rng.randint(0, 300, 2) if rng.rand() < 0.2 else rng.randint(
            0, 40, 2)
        if kind == 0:
            a, b = rng.randint(0, 6, n).tolist(), rng.randint(0, 6, m).tolist()
        elif kind == 1:
            a = "".join(rng.choice(list("ab cé"), n))
            b = "".join(rng.choice(list("ab cé"), m))
        else:
            words = ["go", "stop", "left", "right"]
            a, b = list(rng.choice(words, n)), list(rng.choice(words, m))
        hyps.append(a)
        refs.append(b)
    got = native.edit_distance_batch(hyps, refs)
    assert got.dtype == np.int32 and got.shape == (len(hyps),)
    want = [pmetrics.edit_distance_plain(h, r) for h, r in zip(hyps, refs)]
    assert got.tolist() == want
    assert got[:5].tolist() == [0, 2, 1, 3, 3]
    assert jnative.available()
    assert jnative.edit_distance_batch(hyps, refs).tolist() == want
    assert native.edit_distance_batch([], []).tolist() == []
    with pytest.raises(ValueError, match="2 hypotheses, 1 references"):
        native.edit_distance_batch([[1], [2]], [[1]])


@pytest.mark.parametrize("ctc", [False, True])
@pytest.mark.parametrize("mode", ["wer", "cer"])
@pytest.mark.parametrize("scores", [False, True])
def test_cal_er_equals_jax_and_plain(tmp_path, mode, ctc, scores):
    """(B, U, V) scores or (B, U) ids, with empty references and all-blank
    hypotheses: the port's cal_er equals the JAX package's and the mean of
    the plain distances, exactly."""
    chars = list("abcde") + ["<space>"]
    (tmp_path / "v.txt").write_text("\n".join(chars) + "\n")
    pt = ptext.load_text_encoder("character", str(tmp_path / "v.txt"))
    jt = jtext.load_text_encoder("character", str(tmp_path / "v.txt"))
    rng = np.random.RandomState(7 + 2 * ctc + 4 * (mode == "cer"))
    B, U, V = 12, 20, 3 + len(chars)
    ids = rng.randint(0, V, (B, U))
    ids[rng.rand(B, U) < 0.15] = 0
    ids[3] = 0                                   # an all-blank hypothesis
    truth = rng.randint(3, V, (B, 14))
    truth[:, 10:] = 0
    truth[2] = 0                                 # an empty reference
    truth[5, 3] = 1                              # <eos> ends it early
    pred = np.eye(V)[ids] + rng.rand(B, U, V) * 0.5 if scores else ids
    got = pmetrics.cal_er(pt, pred, truth, mode=mode, ctc=ctc)
    assert got == jmetrics.cal_er(jt, pred, truth, mode=mode, ctc=ctc)
    rates = []
    for p, t in zip(np.asarray(pred).argmax(-1) if scores else pred, truth):
        h, r = pt.decode(p.tolist(), ignore_repeat=ctc), pt.decode(t.tolist())
        h, r = (h.split(), r.split()) if mode == "wer" else (list(h), list(r))
        if r:
            rates.append(pmetrics.edit_distance_plain(h, r) / len(r))
    assert len(rates) > B // 2 and got == float(np.mean(rates)) > 0


def test_error_rates_per_utterance():
    hyps = ["the cat", "", "a b c", "x"]
    refs = ["the hat", "one two", "", "y z"]
    assert pmetrics.error_rates(hyps, refs, "wer") == [0.5, 1.0, None, 1.0]
    assert pmetrics.error_rates(hyps, refs, "cer") == [1 / 7, 1.0, None,
                                                       1.0]
    assert pmetrics.error_rates(["ab c"], ["abc"], "cer") == [1 / 3]


# ---------------------------------------------------------------- BPE encode
TEXT = st.text(alphabet=st.sampled_from(list(LETTERS) + list(WHITESPACE)
                                        + [" ", "\x00", "\x01", "Q", "\ud800"]),
               max_size=80)


@SETTINGS
@given(TEXT)
def test_bpe_encode_equals_encode_py(encoders, text):
    """Any text: the port's native encode equals its own encode_py and the
    JAX package's encode_py (whitespace other than ' ', NUL, unknown
    characters, the boundary mark, a lone surrogate)."""
    pe, je = encoders
    want = je.encode_py(text)
    assert pe.encode(text) == pe.encode_py(text) == want


@pytest.mark.parametrize("case", ["tabs_newlines", "nbsp_ideographic",
                                  "repeated_spaces", "nul", "long_word",
                                  "long_text", "empty", "non_ascii"])
def test_bpe_encode_named_cases(encoders, case):
    pe, je = encoders
    lines = _corpus_lines(3, 40)
    text = {"tabs_newlines": "\t".join(lines[:3]) + "\n" + lines[3] + "\r\n",
            "nbsp_ideographic": "\xa0".join(lines[4].split()) + "　x",
            "repeated_spaces": "   ".join(lines[5].split()) + "  ",
            "nul": lines[6].replace(" ", "\x00", 2),
            # past the JAX binding's smallest buffer (64 ids)
            "long_word": "".join(lines[:8]).replace(" ", "") * 3,
            "long_text": " ".join(lines),
            "empty": "",
            "non_ascii": "中文語 ßøç éü▁ñ"}[case]
    ids = pe.encode(text)
    assert ids == je.encode_py(text) and ids[-1] == ptext.EOS_IDX
    if case == "long_word":
        assert len(text) > 64 and len(ids) > 64


def test_bpe_encode_equals_jax_native_on_spaced_text(encoders):
    """Space-separated text (the JAX native path's own domain): the port's
    ids equal the JAX package's native encoder's, line for line. The word
    with a NUL byte is left out: the JAX source reads every piece as a C
    string, so the pieces holding NUL and the merges of that word are cut
    short there (its other words are not)."""
    pe, je = encoders
    assert jnative.available() and je._native is not None
    for text in _corpus_lines(11, 300):
        text = " ".join(w for w in text.split() if "\x00" not in w)
        assert pe.encode(text) == je.encode(text)


def test_the_jax_whitespace_discrepancy(encoders):
    """The reference's own two paths disagree on a tab: its native encoder
    keeps the tab inside a word, its encode_py splits there. The port
    gives encode_py's ids."""
    pe, je = encoders
    words = [w for ln in _corpus_lines(12, 4) for w in ln.split()
             if "\x00" not in w]
    text = "\t".join(words[:3])
    assert je.encode(text) != je.encode_py(text)
    assert pe.encode(text) == je.encode_py(text)


def test_a_piece_holding_x01_does_not_collide():
    """Merges keyed by 'a' + '\\x01' + 'b' (the JAX native source) would
    take the pair (▁a, \\x01b) for the merge (▁a\\x01, b): the port keys on
    the pair and gives encode_py's ids."""
    b = ptext.SubwordTextEncoder.BOUNDARY
    assert (b + "a") + "\x01" + "\x01b" == (b + "a\x01") + "\x01" + "b"
    vocab = ptext.TextEncoder.RESERVED + [b + "a", "\x01", "b", "\x01b",
                                          b + "a\x01", b + "a\x01b"]
    merges = [["\x01", "b"], [b + "a\x01", "b"]]
    enc = ptext.SubwordTextEncoder(vocab, merges)
    for text in ("a\x01b", "a\x01b a\x01", "a\x01\x01b"):
        assert enc.encode(text) == enc.encode_py(text)
    assert enc.encode("a\x01b") == [3, 6, 1]


def test_bpe_merge_ranks_and_duplicates_as_a_dict():
    """A later duplicate merge or vocabulary entry replaces the earlier one,
    and a merge entry that is not a pair never matches, as in encode_py."""
    b = ptext.SubwordTextEncoder.BOUNDARY
    vocab = ptext.TextEncoder.RESERVED + [b + "a", "b", "c", b + "ab", "bc",
                                          b + "abc", "bc"]
    merges = [["b", "c"], [b + "a", "b"], ["b", "c", "x"], [b + "ab", "c"],
              [b + "a", "b"]]
    enc = ptext.SubwordTextEncoder(vocab, merges)
    for text in ("abc", "ab", "bc abc", "cab", "abcabc"):
        assert enc.encode(text) == enc.encode_py(text)


def test_threads_share_one_native_encoder(bpe_json):
    """Twelve threads encode through one fresh encoder at once (the
    loader's pool): one native handle is made, every line gives
    encode_py's ids."""
    enc = ptext.load_text_encoder("subword", str(bpe_json))
    lines = _corpus_lines(5, 480)
    n = 12
    out, errors, handles = [None] * n, [], set()

    def work(i):
        try:
            out[i] = [enc.encode(ln) for ln in lines[i::n]]
            handles.add(id(enc._native))
        except Exception as e:                  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(handles) == 1
    for i in range(n):
        assert out[i] == [enc.encode_py(ln) for ln in lines[i::n]]


# ------------------------------------------------------------ build failures
LIBRARIES = {
    "edit": ("_edit_lib", "edit distance library",
             lambda _: pmetrics.edit_distance("ab", "ba")),
    "bpe": ("_bpe_lib", "BPE encoder",
            lambda f: ptext.load_text_encoder("subword", str(f)).encode("a")),
}


@pytest.mark.parametrize("fault", ["no_compiler", "load_fails"])
@pytest.mark.parametrize("library", sorted(LIBRARIES))
def test_a_failed_build_raises_by_name(tmp_path, monkeypatch, bpe_json,
                                       library, fault):
    """No g++ (``shutil.which`` finds none) or a library that does not
    load: the call raises naming the library, nothing is left loaded or
    built, and no Python path answers instead."""
    attr, what, call = LIBRARIES[library]
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, attr, None)
    if fault == "no_compiler":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        match = f"g\\+\\+ not found: the {what}"
    else:
        def refuse(path, *a, **k):
            raise OSError(f"{path}: invalid ELF header")
        monkeypatch.setattr(native.ctypes, "CDLL", refuse)
        match = f"cannot load the {what}"
    with pytest.raises(RuntimeError, match=match):
        call(bpe_json)
    assert getattr(native, attr) is None
    built = sorted((tmp_path / "build").glob("*"))
    assert [p.suffix for p in built] == ([] if fault == "no_compiler"
                                         else [".so"])


# ---------------------------------------------------------------- generator
@pytest.mark.parametrize("mode,fmt,size", [("character", "json", 5000),
                                           ("word", "json", 60),
                                           ("subword", "json", 250),
                                           ("subword", "spm", 250)])
def test_generator_writes_the_jax_tools_bytes(tmp_path, monkeypatch, mode,
                                              fmt, size):
    (tmp_path / "text.txt").write_text(
        "\n".join(_corpus_lines(2, 300)) + "\n  \n", encoding="utf-8")
    args = ["--input_file", str(tmp_path / "text.txt"), "--mode", mode,
            "--vocab_size", str(size), "--format", fmt]
    generate_vocab.main([*args, "--output_file", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["generate_vocab_file.py", *args,
                                      "--output_file", str(tmp_path / "jax")])
    _load_jax_generator().main()
    port = (tmp_path / "port").read_bytes()
    assert len(port) > 50 and port == (tmp_path / "jax").read_bytes()
    if mode == "subword":
        enc = ptext.load_text_encoder("subword", str(tmp_path / "port"))
        assert enc.vocab_size == size


# ------------------------------------------------------ main --test, JSON BPE
def test_main_test_on_a_json_bpe_corpus_scores_as_jax(tmp_path, monkeypatch,
                                                      capsys):
    """``main --test --cpu`` with a CTC-only model on a JSON BPE made by the
    port's generator from the corpus's transcripts: the split's WER and
    CER equal the JAX solver's exactly, as do the output CSVs."""
    import jax
    from end_to_end_asr_pytorch_tpu.config import load_config
    from end_to_end_asr_pytorch_tpu.data import synthetic
    from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
    from end_to_end_asr_pytorch_tpu.solvers.test_asr import Solver as JaxSolver
    from end_to_end_asr_pytorch_tpu_torch import main as port_main
    from end_to_end_asr_pytorch_tpu_torch.solvers import test_asr as ptest
    from tests.test_e2e_train import _paras
    from tests.test_torch_ckpt import export_asr_state_dict
    import torch
    corpus = synthetic.generate_corpus(str(tmp_path / "synth"), n_train=8,
                                       n_dev=6, n_test=6, max_words=3)
    lines = [ln.split(" ", 1)[1].lower()
             for f in sorted(corpus.rglob("*.trans.txt"))
             for ln in f.read_text().splitlines() if " " in ln]
    (tmp_path / "text.txt").write_text("\n".join(lines) + "\n")
    generate_vocab.main(["--input_file", str(tmp_path / "text.txt"),
                         "--output_file", str(tmp_path / "bpe.json"),
                         "--mode", "subword", "--vocab_size", "40"])
    vocab = len(json.loads((tmp_path / "bpe.json").read_text())["vocab"])
    model = {"ctc_weight": 1.0,
             "encoder": {"prenet": "", "module": "LSTM", "bidirection": True,
                         "dim": [32], "sample_rate": [2],
                         "sample_style": "drop"},
             "attention": {"mode": "loc", "dim": 16, "num_head": 1,
                           "loc_kernel_size": 11, "loc_kernel_num": 3},
             "decoder": {"module": "LSTM", "dim": 32, "layer": 1}}
    jp = JaxASR(40, vocab, model).init(jax.random.PRNGKey(5))
    torch.save({"model": export_asr_state_dict(jp)}, str(tmp_path / "a.pth"))
    cfg = {"data": {"corpus": {"name": "synthetic", "path": str(corpus),
                               "dev_split": ["dev-clean"],
                               "test_split": ["test-clean"], "batch_size": 4},
                    "audio": {"feat_type": "fbank", "feat_dim": 40,
                              "cmvn": True},
                    "text": {"mode": "subword",
                             "vocab_file": str(tmp_path / "bpe.json")}},
           "model": model, "hparas": {}, "decode": {"beam_size": 2}}
    (tmp_path / "bpe.yaml").write_text(yaml.safe_dump(cfg))

    scores = {}
    real = ptest.Solver._decode_set

    def spy(self, split, dataset):
        scores[split] = real(self, split, dataset)
        return scores[split]
    monkeypatch.setattr(ptest.Solver, "_decode_set", spy)
    port_main.main(["--config", str(tmp_path / "bpe.yaml"), "--test",
                    "--cpu", "--load", str(tmp_path / "a.pth"), "--outdir",
                    str(tmp_path / "port")])
    capsys.readouterr()

    paras = _paras(tmp_path / "jax", "bpe", load=str(tmp_path / "a.pth"))
    paras.test = True
    solver = JaxSolver(load_config(str(tmp_path / "bpe.yaml")), paras, "test")
    solver.load_data()
    solver.set_model()
    for split, ds in (("dev", solver.dv_set), ("test", solver.tt_set)):
        want = solver._decode_set(split, ds)
        assert (scores[split]["wer"], scores[split]["cer"]) == (want["wer"],
                                                                want["cer"])
        assert scores[split]["cer"] > 0
        for kind in ("output", "beam"):
            name = f"{split}_{kind}.csv"
            assert ((tmp_path / "port" / "bpe_sd0" / name).read_text()
                    == (tmp_path / "jax" / "out" / "bpe_sd0" / name
                        ).read_text())
