"""``ckpt_format: orbax`` on the CPU: the port writes checkpoint
directories in the JAX package's orbax layout with neither JAX nor orbax
(``utils/orbax.py``), the JAX package's ``load_checkpoint`` restores them
bit for bit, the port reads them back (model, its optimizer state as
optax's tree, step), ``main`` resumes from them as from its torch file, an interrupted
save recovers as the JAX package's does, and the directories the JAX
package writes itself (OCDBT, zstd) are read bit for bit.

Weights come from the JAX package's init through the port's weight
bridge; every comparison is exact."""
import copy
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR  # noqa: E402
from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM  # noqa: E402
from end_to_end_asr_pytorch_tpu.models.plugin import \
    EmbeddingRegularizer as JaxPlugin  # noqa: E402
from end_to_end_asr_pytorch_tpu.optim import \
    Optimizer as JaxOptimizer  # noqa: E402
from end_to_end_asr_pytorch_tpu.utils.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load, save_checkpoint as jax_save)
from end_to_end_asr_pytorch_tpu_torch import main as port_main  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch import train  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.models.plugin import \
    EmbeddingRegularizer  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.optim import Optimizer  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.utils import jax_ckpt, orbax  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (  # noqa: E402
    asr_from_arrays, lm_from_arrays, load_plugin_arrays, port_name)
from tests.torch_port_fixtures import (ASR_CFG, LM_CFG, VOCAB,  # noqa: E402
                                       jax_arrays)

torch.set_num_threads(1)


def _cfg(**changes):
    cfg = copy.deepcopy(ASR_CFG)
    for path, value in changes.items():
        *head, last = path.split("__")
        d = cfg
        for h in head:
            d = d[h]
        d[last] = value
    return cfg


ASR_CASES = {
    "vgg_lstm": ASR_CFG,
    # CTC only (no attention, decoder, embed, char head), layer norm and a
    # projection on every layer, one direction (bwd is None)
    "ctc_ln_proj_unidirectional": _cfg(ctc_weight=1.0,
                                       encoder__layer_norm=True,
                                       encoder__proj=True,
                                       encoder__bidirection=False),
    # attention only (no CTC head), no prenet, GRU encoder and decoder
    "att_gru_no_prenet": _cfg(ctc_weight=0.0, encoder__prenet="",
                              encoder__module="GRU", decoder__module="GRU"),
    "cnn": _cfg(encoder__prenet="cnn"),
}


def _models(case, tmp_path, seed=1):
    """(JAX tree, the port's model, the port's plugin or None)."""
    key = jax.random.PRNGKey(seed)
    if case.startswith("lm"):
        cfg = {**LM_CFG, "emb_tying": case == "lm_tied", "layer": 2}
        jp = JaxLM(VOCAB, cfg).init(key)
        return jp, lm_from_arrays(VOCAB, cfg, jax_arrays(jp), "cpu"), None
    cfg = ASR_CASES.get(case, ASR_CFG)
    jp = JaxASR(40, VOCAB, cfg).init(key)
    model = asr_from_arrays(40, VOCAB, cfg, jax_arrays(jp), "cpu")
    if case != "plugin":
        return jp, model, None
    np.save(tmp_path / "emb.npy",
            np.random.RandomState(seed).randn(VOCAB, 16).astype(np.float32))
    pcfg = {"src": str(tmp_path / "emb.npy"), "weight": 0.5, "fuse": 0.3}
    jpp = JaxPlugin(pcfg, VOCAB, 32).init(jax.random.PRNGKey(seed + 1))
    plugin = EmbeddingRegularizer(pcfg, VOCAB, 32, device="cpu")
    load_plugin_arrays(plugin, {port_name(k): v
                                for k, v in jax_arrays(jpp).items()})
    return {"asr": jp, "plugin": jpp}, model, plugin


def _zeros(tree):
    return jax.tree.map(lambda x: x * 0, tree)


@pytest.mark.parametrize("case", [*ASR_CASES, "plugin", "lm", "lm_tied"])
def test_jax_restores_a_port_directory_bit_for_bit(tmp_path, case):
    """The JAX package's ``load_checkpoint`` (orbax's StandardCheckpointer)
    restores every leaf of its template from the port's directory, None
    leaves included, with the step and the metrics of meta.json."""
    jp, model, plugin = _models(case, tmp_path)
    orbax.save_orbax(tmp_path / "best.pth", model, global_step=123,
                     metrics={"wer": 0.25}, plugin=plugin)
    out = jax_load(tmp_path / "best.pth", _zeros(jp))
    assert out["global_step"] == 123 and out["metrics"] == {"wer": 0.25}
    assert out["optimizer"] is None
    got, want = jax_arrays(out["model"]), jax_arrays(jp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert jax.tree.structure(out["model"]) == jax.tree.structure(jp)


def _stepped_optimizer(params, name="Adam"):
    """The port's optimizer after one step on random gradients: every slot
    and the count non-zero."""
    opt = Optimizer({"optimizer": name, "lr": 1e-3})
    opt.init(params)
    g = torch.Generator().manual_seed(0)
    for p in params.values():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step(params)
    return opt


@pytest.mark.parametrize("case", ["vgg_lstm", "plugin", "lm"])
def test_port_reads_back_the_model_and_its_optimizer(tmp_path, case):
    jp, model, plugin = _models(case, tmp_path)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    if plugin is not None:
        params.update({f"plugin.{n}": p for n, p in plugin.named_parameters()})
    opt = _stepped_optimizer(params)
    orbax.save_orbax(tmp_path / "latest.pth", model, opt, global_step=7,
                     metrics={"ppx": 3.5}, plugin=plugin)
    assert (tmp_path / "latest.pth" / "optimizer" / "_METADATA").is_file()
    assert not (tmp_path / "latest.pth" / "port_optimizer").exists()
    # optimizer/ is optax's tree: the JAX package restores it into its
    # optimizer's template, every leaf and empty node in place
    jtemplate = JaxOptimizer({"optimizer": "Adam", "lr": 1e-3}).init(jp)
    jck = jax_load(tmp_path / "latest.pth", _zeros(jp), jtemplate)
    assert jax.tree.structure(jck["optimizer"]) == jax.tree.structure(
        jtemplate)
    assert int(jck["optimizer"].inner_state[1][0].count) == 1
    fresh = (RNNLM(VOCAB, {**LM_CFG, "layer": 2}, device="cpu")
             if case == "lm" else ASR(40, VOCAB, ASR_CFG, device="cpu"))
    fresh_plugin = None if plugin is None else EmbeddingRegularizer(
        {"src": str(tmp_path / "emb.npy")}, VOCAB, 32, device="cpu")
    ck = jax_ckpt.load_checkpoint(str(tmp_path / "latest.pth"), fresh,
                                  fresh_plugin)
    assert ck["global_step"] == 7 and ck["format"] == "orbax"
    for a, b in ((model, fresh), (plugin, fresh_plugin)):
        if a is not None:
            sa, sb = a.state_dict(), b.state_dict()
            assert list(sa) == list(sb)
            for k in sa:
                assert torch.equal(sa[k], sb[k]), k
    fresh.requires_grad_(True)
    fparams = dict(fresh.named_parameters())
    if fresh_plugin is not None:
        fparams.update({f"plugin.{n}": p
                        for n, p in fresh_plugin.named_parameters()})
    opt2 = Optimizer({"optimizer": "Adam", "lr": 1e-3})
    opt2.init(fparams)
    opt2.load_state_dict(ck["optimizer"])
    assert int(opt2.count) == int(opt.count) == 1
    assert opt2.count.dtype == opt.count.dtype
    for n, slots in opt.slots.items():
        for s, v in slots.items():
            assert torch.equal(opt2.slots[n][s], v), (n, s)
    assert json.loads((tmp_path / "latest.pth" / "meta.json").read_text()) \
        == {"global_step": 7, "metrics": {"ppx": 3.5}}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``main`` on a tiny corpus in both formats (2 steps, validation at 2),
    each resumed to step 3 with ``--load latest.pth``."""
    from tests.test_torch_port_train import _train_config
    root = tmp_path_factory.mktemp("orbax_train")
    runs = {}
    for fmt in ("native", "orbax"):
        d = root / fmt
        d.mkdir()
        cfg = _train_config(d)
        c = yaml.safe_load(cfg.read_text())
        c["ckpt_format"] = fmt
        cfg.write_text(yaml.safe_dump(c))
        common = ["--config", str(cfg), "--cpu", "--no-msg", "--logdir",
                  str(d / "log"), "--ckpdir", str(d / "ckpt")]
        train.main(common)
        exp = d / "ckpt" / "cfg_sd0"
        shutil.copytree(exp, d / "at_step2")
        c["hparas"]["max_step"] = 3
        cfg.write_text(yaml.safe_dump(c))
        train.main([*common, "--load", str(exp / "latest.pth")])
        log = [json.loads(ln) for ln in
               (d / "log" / "cfg_sd0" / "log.jsonl").read_text().splitlines()]
        runs[fmt] = {"dir": d, "cfg": cfg, "exp": exp, "log": log}
    return runs


def test_main_writes_complete_orbax_directories(trained):
    exp = trained["orbax"]["exp"]
    for name in ("best_att.pth", "best_ctc.pth", "latest.pth"):
        p = exp / name
        assert p.is_dir(), name
        for f in ("meta.json", "model/_METADATA",
                  "model/_CHECKPOINT_METADATA", "optimizer/_METADATA"):
            assert (p / f).is_file(), (name, f)
    assert sorted(q.name for q in exp.iterdir()) == [
        "best_att.pth", "best_ctc.pth", "latest.pth"]       # no .tmp, .old
    assert json.loads((exp / "latest.pth" / "meta.json").read_text())[
        "global_step"] == 3
    assert (trained["native"]["exp"] / "latest.pth").is_file()


def test_resume_from_orbax_equals_resume_from_the_torch_file(trained):
    """Step 3 after ``--load latest.pth/`` (orbax) takes the loss and
    reaches the parameters and optimizer state that step 3 after ``--load``
    of the torch file does."""
    def step3(run):
        return [e["value"] for e in run["log"]
                if e["step"] == 3 and e["name"] == "loss"
                and "tr_loss" in e["value"]]
    a, b = step3(trained["orbax"]), step3(trained["native"])
    assert len(a) == 1 and a == b
    models, opts = {}, {}
    mcfg = yaml.safe_load(trained["orbax"]["cfg"].read_text())["model"]
    vocab = 3 + len((Path(yaml.safe_load(trained["orbax"]["cfg"].read_text())[
        "data"]["text"]["vocab_file"])).read_text().split())
    for fmt in ("orbax", "native"):
        models[fmt] = ASR(40, vocab, mcfg, device="cpu")
        ck = jax_ckpt.load_checkpoint(str(trained[fmt]["exp"] / "latest.pth"),
                                      models[fmt])
        assert ck["global_step"] == 3
        opts[fmt] = ck["optimizer"]
    for k, v in models["native"].state_dict().items():
        assert torch.equal(models["orbax"].state_dict()[k], v), k
    assert int(opts["orbax"]["count"]) == int(opts["native"]["count"]) == 3
    for n, slots in opts["native"]["slots"].items():
        for s, v in slots.items():
            assert torch.equal(opts["orbax"]["slots"][n][s], v), (n, s)


def test_main_test_decodes_an_orbax_directory_as_the_torch_file(trained,
                                                                 tmp_path):
    """``main --test --load best_att.pth/`` writes the CSVs that ``--load``
    of the torch best_att.pth of the same run writes."""
    outs = {}
    for fmt in ("native", "orbax"):
        run = trained[fmt]
        c = yaml.safe_load(run["cfg"].read_text())
        c["data"]["corpus"]["dev_split"] = ["dev-clean"]
        c["data"]["corpus"]["test_split"] = ["dev-clean"]
        c["decode"] = {"beam_size": 2, "min_len_ratio": 0.05,
                       "max_len_ratio": 0.6, "ctc_weight": 0.3}
        cfg = tmp_path / f"{fmt}.yaml"
        cfg.write_text(yaml.safe_dump(c))
        port_main.main(["--config", str(cfg), "--test", "--cpu", "--no-msg",
                        "--load", str(run["dir"] / "at_step2" / "best_att.pth"),
                        "--outdir", str(tmp_path / "out")])
        out = tmp_path / "out" / f"{fmt}_sd0"
        outs[fmt] = [(out / f).read_text() for f in
                     ("dev_output.csv", "dev_beam.csv", "test_beam.csv")]
    assert outs["orbax"] == outs["native"]
    assert len(outs["orbax"][0].splitlines()) == 4       # header + 3 utts


def test_lm_main_writes_orbax_the_jax_loader_restores(tmp_path):
    """``main --lm`` with ckpt_format orbax: best_ppx.pth/ and latest.pth/,
    which the JAX package restores into its LM template (the same leaves
    as the port's LM) and ``--load`` resumes."""
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    corpus = generate_corpus(str(tmp_path / "c"), n_train=6, n_dev=3,
                             n_test=0, text_only=20)
    cfg = yaml.safe_load((ROOT / "config/synthetic/lm.yaml").read_text())
    cfg["data"] = {"corpus": {"name": "synthetic", "path": str(corpus),
                              "train_split": ["lm_text.txt"],
                              "dev_split": ["dev-clean"], "batch_size": 4},
                   "text": {"mode": "character",
                            "vocab_file": str(corpus / "vocab.txt")}}
    cfg["model"].update(dim=16, emb_dim=16)
    cfg["hparas"].update(max_step=2, valid_step=2, PROGRESS_STEP=1)
    cfg["ckpt_format"] = "orbax"
    path = tmp_path / "lm.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = ["--config", str(path), "--lm", "--cpu", "--no-msg", "--logdir",
            str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")]
    port_main.main(argv)
    exp = tmp_path / "ckpt" / "lm_sd0"
    assert (exp / "best_ppx.pth").is_dir() and (exp / "latest.pth").is_dir()
    vocab = 3 + len((corpus / "vocab.txt").read_text().split())
    lm = RNNLM(vocab, cfg["model"], device="cpu")
    jax_ckpt.load_checkpoint(str(exp / "best_ppx.pth"), lm)
    jlm = JaxLM(vocab, cfg["model"])
    out = jax_load(exp / "best_ppx.pth", jlm.init(jax.random.PRNGKey(9)))
    assert out["global_step"] == 2 and "ppx" in out["metrics"]
    got = jax_arrays(out["model"])
    for name, t in lm.state_dict().items():
        np.testing.assert_array_equal(got["." + name.replace(".0.", "[0].")],
                                      t.numpy(), err_msg=name)
    cfg["hparas"]["max_step"] = 3
    path.write_text(yaml.safe_dump(cfg))
    port_main.main([*argv, "--load", str(exp / "latest.pth")])
    assert json.loads((exp / "latest.pth" / "meta.json").read_text())[
        "global_step"] == 3


@pytest.mark.parametrize("window", ["after_rename_aside", "mid_tmp_write"])
def test_preemption_recovery(tmp_path, window):
    """As the JAX package's ``test_orbax_preemption_recovery``: an
    interrupted overwrite leaves the old directory aside as ``.old`` and
    the new one as ``.tmp``; the loader promotes the complete sibling
    (``.tmp`` when its meta.json landed, else ``.old``)."""
    _, model, _ = _models("vgg_lstm", tmp_path)
    path = tmp_path / "latest.pth"
    orbax.save_orbax(path, model, global_step=1)
    orbax.save_orbax(path, model, global_step=2)
    if window == "after_rename_aside":
        shutil.copytree(path, tmp_path / "latest.pth.tmp")
        meta = tmp_path / "latest.pth.tmp" / "meta.json"
        meta.write_text(meta.read_text().replace('"global_step": 2',
                                                 '"global_step": 3'))
        path.rename(tmp_path / "latest.pth.old")
        expect = 3
    else:
        (tmp_path / "latest.pth.tmp" / "model").mkdir(parents=True)
        path.rename(tmp_path / "latest.pth.old")
        expect = 2
    fresh = ASR(40, VOCAB, ASR_CFG, device="cpu")
    ck = jax_ckpt.load_checkpoint(str(path), fresh)
    assert ck["global_step"] == expect and path.is_dir()
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), fresh.state_dict().values()))


def test_an_orbax_save_replaces_a_torch_file(tmp_path):
    """Switching ckpt_format in an experiment: the torch file at the path
    gives way to the directory, which loads."""
    from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import \
        save_checkpoint
    _, model, _ = _models("vgg_lstm", tmp_path)
    path = tmp_path / "latest.pth"
    save_checkpoint(path, model, global_step=1)
    assert path.is_file()
    orbax.save_orbax(path, model, global_step=2)
    assert path.is_dir()
    ck = jax_ckpt.load_checkpoint(str(path),
                                  ASR(40, VOCAB, ASR_CFG, device="cpu"))
    assert ck["global_step"] == 2


@pytest.mark.parametrize("layout", ["ocdbt", "zstd_leaf"])
def test_directories_the_jax_package_writes_are_read_bit_for_bit(tmp_path,
                                                                  layout):
    """The JAX package's own orbax directories: OCDBT (its default), or
    a non-OCDBT one whose leaves orbax compressed with zstd; the port
    loads every leaf as the JAX package's ``load_checkpoint`` restores it
    (``tests/test_torch_port_orbax_jax.py`` covers the formats in full)."""
    jp, model, _ = _models("vgg_lstm", tmp_path)
    path = tmp_path / "jax.pth"
    if layout == "ocdbt":
        jax_save(path, jp, None, 5, fmt="orbax")
        assert (path / "model" / "manifest.ocdbt").is_file()
    else:
        path.mkdir()
        ckptr = ocp.Checkpointer(ocp.StandardCheckpointHandler(
            use_ocdbt=False))
        ckptr.save(path / "model", args=ocp.args.StandardSave(jp))
        ckptr.close()
        (path / "meta.json").write_text('{"global_step": 5, "metrics": {}}')
        z = json.loads((path / "model" / "ctc_w" / ".zarray").read_text())
        assert z["compressor"]["id"] == "zstd"
    want = jax_arrays(jax_load(path, _zeros(jp))["model"])
    got = orbax.read_orbax(path)["model"]
    assert sorted(got) == sorted(port_name(k) for k in want)
    for k, w in want.items():
        assert got[port_name(k)].dtype == w.dtype
        np.testing.assert_array_equal(got[port_name(k)], w, err_msg=k)
    fresh = ASR(40, VOCAB, ASR_CFG, device="cpu")
    ck = jax_ckpt.load_checkpoint(str(path), fresh)
    assert ck["global_step"] == 5 and ck["format"] == "orbax"
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_none_leaves_follow_the_jax_trees_fields():
    names = ["encoder.layers.0.fwd.w_ih", "encoder.layers.1.fwd.w_ih",
             "encoder.layers.1.ln_scale", "ctc_w", "ctc_b"]
    got = orbax.none_leaves(names, orbax._ASR_FIELDS)
    assert got == ["embed", "attention", "decoder", "char_w", "char_b",
                   "encoder.prenet",
                   "encoder.layers.0.bwd", "encoder.layers.0.ln_scale",
                   "encoder.layers.0.ln_bias", "encoder.layers.0.w_proj",
                   "encoder.layers.0.b_proj", "encoder.layers.1.bwd",
                   "encoder.layers.1.ln_bias", "encoder.layers.1.w_proj",
                   "encoder.layers.1.b_proj"]
