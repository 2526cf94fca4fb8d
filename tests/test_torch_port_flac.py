"""FLAC input of the port (``data/flac.py`` over its own build of
``native/flac_decoder.cc``, ``utils/native.py``) against the JAX package's
``data/flac_native.py`` on the CPU: decodes bit-equal on streams from the
test encoder, truncated streams refused by both, the loaders' int16
batches of a FLAC LibriSpeech-layout tree equal, ``main`` and ``main
--test`` on that tree, and the build's failures raising."""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.data.dataset import load_dataset as jax_load_dataset
from end_to_end_asr_pytorch_tpu.data.flac_native import read_flac as jax_read_flac
from end_to_end_asr_pytorch_tpu_torch import main as port_main
from end_to_end_asr_pytorch_tpu_torch.data import audio_io, synthetic
from end_to_end_asr_pytorch_tpu_torch.data.dataset import load_dataset
from end_to_end_asr_pytorch_tpu_torch.data.flac import read_flac
from end_to_end_asr_pytorch_tpu_torch.utils import native
from tests.flac_encoder import encode_flac

torch.set_num_threads(1)


def _pcm(case: str) -> tuple[np.ndarray, dict]:
    """Samples and encoder options of one stream: the modes the JAX
    package's own decoder test covers, stereo, and a block size that does
    not divide the length."""
    rng = np.random.RandomState(1)
    if case == "constant":
        return np.full(3000, 123, np.int32), {"mode": "constant"}
    if case == "fixed2":
        t = np.arange(5000)
        pcm = (8000 * np.sin(t / 40.0)).astype(np.int32) + rng.randint(-8, 8, 5000)
        return pcm, {"mode": "fixed2"}
    if case == "stereo":
        return rng.randint(-1000, 1000, (2500, 2)).astype(np.int32), {}
    if case == "ragged_blocks":
        return rng.randint(-32768, 32767, 3001).astype(np.int32), {
            "blocksize": 1000}
    return rng.randint(-32768, 32767, 4000).astype(np.int32), {}


@pytest.mark.parametrize("case", ["verbatim", "constant", "fixed2", "stereo",
                                  "ragged_blocks"])
def test_read_flac_is_bit_equal_to_jax(tmp_path, case):
    pcm, opts = _pcm(case)
    path = tmp_path / f"{case}.flac"
    path.write_bytes(encode_flac(pcm, **opts))
    wave, sr = read_flac(str(path))
    ref, ref_sr = jax_read_flac(str(path))
    assert sr == ref_sr == 16000 and wave.dtype == ref.dtype == np.float32
    assert len(wave) == len(pcm)
    np.testing.assert_array_equal(wave, ref)
    np.testing.assert_array_equal(audio_io.load_audio(str(path))[0], ref)


@pytest.mark.parametrize("cut", [41, 60, -3])
def test_truncated_streams_raise_in_both_packages(tmp_path, cut):
    """Cut inside STREAMINFO (rc -3) and inside a subframe (rc -7)."""
    data = encode_flac(_pcm("verbatim")[0])
    path = tmp_path / "cut.flac"
    path.write_bytes(data[:cut])
    for read in (read_flac, jax_read_flac):
        with pytest.raises(ValueError, match=r"rc=-\d"):
            read(str(path))


def test_load_audio_dispatches_by_extension(tmp_path):
    pcm = _pcm("verbatim")[0]
    (tmp_path / "a.FLAC").write_bytes(encode_flac(pcm))
    wave, sr = audio_io.load_audio(str(tmp_path / "a.FLAC"))
    np.testing.assert_array_equal(wave, pcm.astype(np.float32) / 32768.0)
    audio_io.write_wav(str(tmp_path / "a.wav"), wave, sr)
    np.testing.assert_allclose(audio_io.load_audio(str(tmp_path / "a.wav"))[0],
                               wave, atol=1e-4)
    with pytest.raises(ValueError, match="unsupported audio format"):
        audio_io.load_audio(str(tmp_path / "a.ogg"))


@pytest.fixture(scope="module")
def flac_tree(tmp_path_factory):
    """A generated corpus in LibriSpeech layout with every WAV converted to
    PCM16 FLAC (as the JAX package's loader test converts it)."""
    root = tmp_path_factory.mktemp("flac_corpus")
    synthetic.generate_corpus(str(root), n_train=8, n_dev=4, n_test=4,
                              max_words=2)
    for wav in sorted(root.rglob("*.wav")):
        wave, sr = audio_io.load_audio(str(wav))
        pcm = np.clip(np.round(wave * 32768.0), -32768, 32767).astype(np.int16)
        wav.with_suffix(".flac").write_bytes(encode_flac(pcm, sr=sr))
        wav.unlink()
    assert len(list(root.rglob("*.flac"))) == 16
    return root


def _data_cfg(root):
    return {"corpus": {"name": "synthetic", "path": str(root),
                       "train_split": ["train-clean"],
                       "dev_split": ["dev-clean"],
                       "test_split": ["test-clean"], "batch_size": 4},
            "audio": {"feat_type": "fbank", "feat_dim": 40},
            "text": {"mode": "character",
                     "vocab_file": str(root / "vocab.txt")}}


@pytest.mark.parametrize("mode", ["train", "test"])
def test_flac_tree_batches_equal_the_jax_loader(flac_tree, mode):
    data = _data_cfg(flac_tree)
    port = load_dataset(1, False, mode=mode, **data)
    ref = jax_load_dataset(1, False, False, False, data["corpus"],
                           data["audio"], data["text"], mode=mode)
    assert port[2:4] == ref[2:4]
    for got_set, ref_set in zip(port[:2], ref[:2]):
        got, want = list(got_set), list(ref_set)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["wave"].dtype == w["wave"].dtype == np.int16
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)


def test_main_trains_and_decodes_a_flac_tree(flac_tree, tmp_path, capsys):
    cfg = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    cfg["data"] = dict(_data_cfg(flac_tree),
                       audio=cfg["data"]["audio"])
    cfg["model"]["encoder"]["dim"] = [16, 16]
    cfg["model"]["attention"].update(dim=8, loc_kernel_size=6,
                                     loc_kernel_num=2)
    cfg["model"]["decoder"]["dim"] = 16
    cfg["hparas"].update(max_step=2, valid_step=2, PROGRESS_STEP=1)
    cfg["decode"].update(lm_weight=0.0, beam_size=2)
    path = tmp_path / "flac.yaml"
    path.write_text(yaml.safe_dump(cfg))
    common = ["--config", str(path), "--cpu", "--logdir", str(tmp_path / "l"),
              "--ckpdir", str(tmp_path / "c"), "--outdir", str(tmp_path / "o")]
    port_main.main(common)
    ckpt = tmp_path / "c" / "flac_sd0" / "latest.pth"
    assert torch.load(str(ckpt), weights_only=True)["global_step"] == 2
    port_main.main([*common, "--test", "--load", str(ckpt)])
    out = capsys.readouterr().out
    assert "dev: " in out and "test: " in out
    for split in ("dev", "test"):
        rows = (tmp_path / "o" / "flac_sd0" / f"{split}_output.csv"
                ).read_text().strip().split("\n")
        assert len(rows) == 1 + 4


def _fresh_build(monkeypatch, tmp_path):
    """Point the binding at an empty build directory with nothing loaded."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)


def _native_listing():
    """native/ without the JAX package's own library, which its tests build
    there (``make -C native``), maybe at this moment in another process."""
    return sorted(p.name for p in (ROOT / "native").iterdir()
                  if p.name != "libasrnative.so")


@pytest.mark.parametrize("fault", ["no_compiler", "build_fails",
                                   "load_fails"])
def test_a_failed_build_raises_and_writes_nothing_under_native(
        tmp_path, monkeypatch, fault):
    _fresh_build(monkeypatch, tmp_path)
    before = _native_listing()
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(_pcm("verbatim")[0]))
    if fault == "no_compiler":
        (tmp_path / "empty").mkdir()
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
        match = "g\\+\\+ not found"
    elif fault == "build_fails":
        bad = tmp_path / "broken.cc"
        bad.write_text("int flac_decode( {\n")
        monkeypatch.setattr(native, "SOURCE", bad)
        match = "(?s)g\\+\\+ failed .*error:"
    else:
        def refuse(path, *a, **k):
            raise OSError(f"{path}: invalid ELF header")
        monkeypatch.setattr(native.ctypes, "CDLL", refuse)
        match = "cannot load the FLAC decoder"
    with pytest.raises(RuntimeError, match=match):
        read_flac(str(path))
    assert native._lib is None
    assert _native_listing() == before
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_threads_build_the_library_once(tmp_path, monkeypatch):
    """Six threads decode at once through a binding with nothing built:
    one library is built, no temporary file is left, every decode equal."""
    _fresh_build(monkeypatch, tmp_path)
    pcm = _pcm("ragged_blocks")[0]
    path = tmp_path / "t.flac"
    path.write_bytes(encode_flac(pcm, blocksize=1000))
    out, errors = [None] * 6, []

    def work(i):
        try:
            out[i] = read_flac(str(path))[0]
        except Exception as e:             # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".so"]
    for w in out:
        np.testing.assert_array_equal(w, pcm.astype(np.float32) / 32768.0)
