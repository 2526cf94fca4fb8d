"""Dev / test decoding (``main --test``) of the port against the JAX
package's ``solvers/test_asr.Solver`` on a tiny synthetic corpus, with
RNN-LM shallow fusion; the RNN-LM checkpoint loader; the JAX-format
checkpoint reader and its msgpack decoder.

The ASR checkpoint holds the JAX package's random init in the reference
layout, the LM checkpoint is built as ``tests/test_torch_ckpt.py`` builds
one. Output CSVs: the best hypotheses byte-identical, the n-best identical
in idx / rank / hyp with scores within 1e-4 (4 printed decimals of f32
scores summed in another order)."""
import copy
import functools
import json
import sys
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.config import load_config as jax_load_config
from end_to_end_asr_pytorch_tpu.data import synthetic
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
from end_to_end_asr_pytorch_tpu.solvers.test_asr import Solver as JaxTestSolver
from end_to_end_asr_pytorch_tpu.utils.checkpoint import save_checkpoint
from end_to_end_asr_pytorch_tpu.utils.torch_ckpt import (
    translate_lm_state_dict as jax_translate_lm)
from end_to_end_asr_pytorch_tpu_torch import main as port_main
from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM
from end_to_end_asr_pytorch_tpu_torch.utils import (jax_ckpt, orbax,
                                                  torch_ckpt)
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (asr_from_arrays,
                                                            lm_from_arrays)
from tests.test_e2e_train import _paras
from tests.test_torch_ckpt import _rnn_entries, export_asr_state_dict, t
from tests.torch_port_fixtures import jax_arrays, to_np

torch.set_num_threads(1)
NAME = "fix"           # experiment name: outputs under <outdir>/fix_sd0/
MODEL_CFG = {
    "ctc_weight": 0.5,
    "encoder": {"prenet": "", "module": "LSTM", "bidirection": True,
                "dim": [32, 32], "sample_rate": [2, 2],
                "sample_style": "drop"},
    "attention": {"mode": "loc", "dim": 16, "num_head": 1,
                  "loc_kernel_size": 11, "loc_kernel_num": 3},
    "decoder": {"module": "LSTM", "dim": 32, "layer": 1},
}
LM_MODEL = {"module": "LSTM", "dim": 24, "emb_dim": 24, "layer": 2}


def reference_lm_state_dict(params) -> "OrderedDict":
    """A JAX RNN-LM's parameters as a reference-layout state_dict
    (``emb``, ``rnn.*_l{n}``, ``trans``), as test_lm_roundtrip builds it."""
    sd = OrderedDict()
    sd["emb.weight"] = t(params.embed)
    for ci, cell in enumerate(params.cells):
        _rnn_entries(sd, "rnn", cell, f"_l{ci}")
    if params.out_w is not None:
        sd["trans.weight"] = t(np.asarray(params.out_w).T)
    sd["trans.bias"] = t(params.out_b)
    return sd


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Corpus, config files and checkpoints shared by every case."""
    d = tmp_path_factory.mktemp("test_solver")
    corpus = synthetic.generate_corpus(str(d / "synth"), n_train=8, n_dev=4,
                                       n_test=4, max_words=2)
    vocab = 3 + len((corpus / "vocab.txt").read_text().split())
    jm = JaxASR(40, vocab, MODEL_CFG)
    jp = jm.init(jax.random.PRNGKey(11))
    torch.save({"model": export_asr_state_dict(jp), "global_step": 5},
               str(d / "asr.pth"))
    save_checkpoint(str(d / "asr_native.pth"), jp, global_step=5)
    ctc_cfg = dict(copy.deepcopy(MODEL_CFG), ctc_weight=1.0)
    jpc = JaxASR(40, vocab, ctc_cfg).init(jax.random.PRNGKey(12))
    torch.save({"model": export_asr_state_dict(jpc)}, str(d / "ctc.pth"))
    jlp = JaxLM(vocab, LM_MODEL).init(jax.random.PRNGKey(13))
    torch.save({"model": reference_lm_state_dict(jlp)}, str(d / "lm.pth"))
    data = {"corpus": {"name": "synthetic", "path": str(corpus),
                       "train_split": ["train-clean"],
                       "dev_split": ["dev-clean"],
                       "test_split": ["test-clean"], "batch_size": 8},
            "audio": {"feat_type": "fbank", "feat_dim": 40, "cmvn": True},
            "text": {"mode": "character",
                     "vocab_file": str(corpus / "vocab.txt")}}
    (d / "lm.yaml").write_text(yaml.safe_dump(
        {"data": {k: data[k] for k in ("corpus", "text")},
         "model": LM_MODEL, "hparas": {}}))
    decode = {"beam_size": 3, "min_len_ratio": 0.0, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3, "amp": False,
              "lm_config": str(d / "lm.yaml"), "lm_path": str(d / "lm.pth")}
    return {"dir": d, "data": data, "decode": decode, "jax_params": jp,
            "vocab": vocab}


def _config(setup, case):
    cfg = {"data": setup["data"], "model": copy.deepcopy(MODEL_CFG),
           "hparas": {}, "decode": dict(setup["decode"])}
    if case == "ctc_only":
        cfg["model"]["ctc_weight"] = 1.0
    if case == "beam":      # K8's plain version: the default is K8's route
        cfg["decode"]["fused_step"] = False
    path = setup["dir"] / case / f"{NAME}.yaml"
    path.parent.mkdir(exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def _ckpt(setup, case):
    name = {"ctc_only": "ctc.pth", "native": "asr_native.pth"}.get(case,
                                                                 "asr.pth")
    return str(setup["dir"] / name)


@functools.lru_cache(maxsize=None)
def _jax_outputs(root: str, ctc_only: bool):
    """The JAX solver's CSVs ({file name: text}) for the LM-fused beam
    config (which every beam case shares: JAX ignores fused_step and the
    native checkpoint holds the same weights) or the CTC-only one."""
    d = Path(root)
    case = "ctc_only" if ctc_only else "beam"
    cfg = jax_load_config(str(d / case / f"{NAME}.yaml"))
    paras = _paras(d / case / "jax", NAME, load=str(d / ("ctc.pth" if ctc_only
                                                         else "asr.pth")))
    paras.test = True
    solver = JaxTestSolver(cfg, paras, "test")
    solver.load_data()
    solver.set_model()
    solver.exec()
    out = d / case / "jax" / "out" / f"{NAME}_sd0"
    return {f.name: f.read_text() for f in sorted(out.glob("*.csv"))}


def _port_outputs(setup, case, capsys):
    cfg = _config(setup, case)
    out = setup["dir"] / case / "port"
    port_main.main(["--config", str(cfg), "--test", "--cpu", "--load",
                    _ckpt(setup, case), "--outdir", str(out)])
    log = capsys.readouterr().out
    files = sorted((out / f"{NAME}_sd0").glob("*.csv"))
    return {f.name: f.read_text() for f in files}, log


def _beam_rows(text):
    rows = [ln.split("\t") for ln in text.strip().split("\n")[1:]]
    return [(r[0], r[1], r[3]) for r in rows], np.array([float(r[2])
                                                          for r in rows])


@pytest.mark.parametrize("case", ["beam", "fused", "ctc_only", "native"])
def test_port_test_solver_matches_jax_solver(setup, case, capsys):
    got, log = _port_outputs(setup, case, capsys)
    _config(setup, "ctc_only" if case == "ctc_only" else "beam")
    ref = _jax_outputs(str(setup["dir"]), case == "ctc_only")
    assert sorted(got) == sorted(ref) == [
        "dev_beam.csv", "dev_output.csv", "test_beam.csv", "test_output.csv"]
    for split in ("dev", "test"):
        assert got[f"{split}_output.csv"] == ref[f"{split}_output.csv"]
        assert len(got[f"{split}_output.csv"].strip().split("\n")) == 1 + 4
        g_rows, g_sc = _beam_rows(got[f"{split}_beam.csv"])
        r_rows, r_sc = _beam_rows(ref[f"{split}_beam.csv"])
        assert g_rows == r_rows
        np.testing.assert_allclose(g_sc, r_sc, atol=1e-4, rtol=0)
    route = {"beam": "beam unfused", "fused": "beam fused",
             "native": "beam fused", "ctc_only": "greedy CTC"}[case]
    assert log.count(f"| {route}") == 2, log
    if case == "native":
        # the JAX-format file restores the JAX weights exactly, and decodes
        # as the torch pickle of the same weights does
        V = setup["vocab"]
        model = ASR(40, V, MODEL_CFG, device="cpu")
        ck = jax_ckpt.load_checkpoint(_ckpt(setup, case), model)
        assert ck == {"optimizer": None, "global_step": 5, "format": "native"}
        ref_model = asr_from_arrays(40, V, MODEL_CFG,
                                    jax_arrays(setup["jax_params"]),
                                    device="cpu")
        for k, v in ref_model.state_dict().items():
            torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
        pickled, _ = _port_outputs(setup, "beam", capsys)
        assert got == pickled


@pytest.mark.parametrize("tying", [False, True])
def test_lm_loader_matches_jax_translation(tying, tmp_path):
    cfg = dict(LM_MODEL, emb_tying=tying)
    jlm = JaxLM(11, cfg)
    jlp = jlm.init(jax.random.PRNGKey(3 + tying))
    sd = reference_lm_state_dict(jlp)
    ref = jax_translate_lm(sd, jlm.init(jax.random.PRNGKey(9)))
    torch.save({"model": sd, "global_step": 2}, str(tmp_path / "lm.pth"))
    lm = RNNLM(11, cfg, device="cpu")
    ck = jax_ckpt.load_checkpoint(str(tmp_path / "lm.pth"), lm)
    assert ck["format"] == "torch" and ck["global_step"] == 2
    tok = np.asarray([1, 4, 7, 10])
    rl, _ = jlm.step(ref, jlm.init_state(4), jnp.asarray(tok))
    gl, _ = lm.step(lm.init_state(4), torch.from_numpy(tok))
    np.testing.assert_allclose(to_np(gl), np.asarray(rl), atol=1e-6, rtol=0)
    # the writer's layout is what the loader (and the JAX one) reads
    again = RNNLM(11, cfg, device="cpu")
    torch_ckpt.assign(again, torch_ckpt.translate_lm_state_dict(
        torch_ckpt.lm_state_dict(lm), again), "roundtrip")
    for k, v in lm.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0)
    bridged = lm_from_arrays(11, cfg, jax_arrays(ref), device="cpu")
    for k, v in bridged.state_dict().items():
        torch.testing.assert_close(lm.state_dict()[k], v, rtol=0, atol=0)


def test_msgpack_decoder_matches_the_msgpack_package():
    import msgpack
    from flax import serialization
    obj = {"small": [0, 1, 127, -1, -32, -33, 128, 255, 256, 65535, 65536,
                     2 ** 32, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 40],
           "floats": [0.5, -1e300, 3.25], "none": None, "flags": [True, False],
           "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "ü"],
           "bins": [b"", b"x" * 300, b"y" * 70000],
           "big_list": list(range(70000)),
           "big_map": {str(i): i for i in range(20)}}
    assert jax_ckpt.msgpack_unpack(msgpack.packb(obj, use_bin_type=True)) == obj
    single = msgpack.packb([1.5, -2.25], use_single_float=True)
    assert jax_ckpt.msgpack_unpack(single) == [1.5, -2.25]
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "i": jnp.arange(3, dtype=jnp.int32), "s": np.float32(2.5),
            "nested": (np.ones((1, 2)), None)}
    got = jax_ckpt.msgpack_unpack(serialization.to_bytes(tree))
    np.testing.assert_array_equal(got["w"], tree["w"])
    np.testing.assert_array_equal(got["i"], np.arange(3, dtype=np.int32))
    assert got["s"] == np.float32(2.5) and got["s"].dtype == np.float32
    assert got["nested"]["1"] is None
    np.testing.assert_array_equal(got["nested"]["0"], np.ones((1, 2)))
    assert jax_ckpt.tree_arrays(got)["nested.0"].shape == (1, 2)


def test_orbax_directories_raise(tmp_path):
    """An orbax directory the JAX package wrote (OCDBT, zstd-compressed)
    now loads into the port's LM bit for bit; a directory the port cannot
    read raises, naming why: an OCDBT manifest whose CRC fails, a leaf
    compressed with a codec other than zstd
    (tests/test_torch_port_orbax_jax.py covers the formats)."""
    params = JaxLM(5, LM_MODEL).init(jax.random.PRNGKey(0))
    save_checkpoint(tmp_path / "lm.pth", params, None, 3, fmt="orbax")
    lm = RNNLM(5, LM_MODEL)
    ck = jax_ckpt.load_checkpoint(str(tmp_path / "lm.pth"), lm)
    assert ck["global_step"] == 3 and ck["format"] == "orbax"
    ref = lm_from_arrays(5, LM_MODEL, jax_arrays(params), "cpu")
    for k, v in ref.state_dict().items():
        assert torch.equal(lm.state_dict()[k], v), k
    manifest = tmp_path / "lm.pth" / "model" / "manifest.ocdbt"
    damaged = bytearray(manifest.read_bytes())
    damaged[-1] ^= 0xFF
    manifest.write_bytes(bytes(damaged))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        jax_ckpt.load_checkpoint(str(tmp_path / "lm.pth"), RNNLM(5, LM_MODEL))
    orbax.save_orbax(tmp_path / "port.pth", ref, global_step=1)
    zarray = tmp_path / "port.pth" / "model" / "embed" / ".zarray"
    z = json.loads(zarray.read_text())
    zarray.write_text(json.dumps({**z, "compressor": {"id": "blosc"}}))
    with pytest.raises(NotImplementedError, match="compressor 'blosc'"):
        jax_ckpt.load_checkpoint(str(tmp_path / "port.pth"),
                                 RNNLM(5, LM_MODEL))


def test_test_mode_ignores_amp(setup, capsys):
    """``main --test --amp`` decodes as ``main --test`` does: the JAX
    package's decode solver never reads ``--amp`` (the port's main once
    raised on it before dispatching ``--test``)."""
    cfg = _config(setup, "amp")
    outs = {}
    for flags in ([], ["--amp"]):
        out = setup["dir"] / "amp" / ("port_amp" if flags else "port")
        port_main.main(["--config", str(cfg), "--test", "--cpu", "--load",
                        _ckpt(setup, "amp"), "--outdir", str(out), *flags])
        files = sorted((out / f"{NAME}_sd0").glob("*.csv"))
        outs[bool(flags)] = {f.name: f.read_text() for f in files}
    capsys.readouterr()
    assert len(outs[True]) == 4 and outs[True] == outs[False]


def test_test_mode_rejects_model_parallel(setup):
    """``model_parallel: 2`` in ``main --test`` at world 1 raises the JAX
    package's ValueError (its ``make_mesh``: M must divide the devices;
    here the processes), as it does in training."""
    path = _config(setup, "mp")
    cfg = yaml.safe_load(path.read_text())
    cfg["model_parallel"] = 2
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="model_parallel"):
        port_main.main(["--config", str(path), "--test", "--cpu", "--load",
                        _ckpt(setup, "mp"), "--outdir",
                        str(setup["dir"] / "mp" / "out")])
