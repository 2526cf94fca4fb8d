"""The optimizer state across the two packages on the CPU: the port's
``Optimizer`` state as the JAX package's optax tree and back
(``utils/optax_state.py``), read from the JAX package's native files and
orbax directories (OCDBT, zstd), written as ``optimizer/`` for the JAX
package to restore, and ``main --load`` (ASR and ``--lm``, also at
``model_parallel: 2``) continuing as the JAX package's own ``--load`` of the
same checkpoint does.

The optax tree is the installed optax's own (``Optimizer(...).init``);
weights come from the JAX package's init through the port's weight
bridge, inputs and gradients from ``np.random.RandomState``. Tolerances,
as the port's train parity tests take them: counters, counts and every
restored leaf exactly; losses rtol 1e-5; parameters and slots after
optimizer steps rtol 1e-5 / atol 1e-7 (a slot element near zero is a
difference of larger terms)."""
import copy
import json
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
from end_to_end_asr_pytorch_tpu.optim import \
    Optimizer as JaxOptimizer  # noqa: E402
from end_to_end_asr_pytorch_tpu.parallel import mesh as jax_mesh  # noqa: E402
from end_to_end_asr_pytorch_tpu.utils.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load, save_checkpoint as jax_save)
from end_to_end_asr_pytorch_tpu_torch import main as port_main  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.optim import Optimizer  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.solvers import (  # noqa: E402
    train_asr as port_train_asr, train_lm as port_train_lm)
from end_to_end_asr_pytorch_tpu_torch.utils import (  # noqa: E402
    jax_ckpt, optax_state, orbax)
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (  # noqa: E402
    _to_port_layout, load_arrays, port_name)
from tests import torch_port_dist as dh  # noqa: E402
from tests.test_torch_port_orbax import _models  # noqa: E402
from tests.test_torch_port_train import OPT_CASES  # noqa: E402
from tests.torch_port_fixtures import jax_arrays, to_np  # noqa: E402

torch.set_num_threads(1)
PARAM_TOL = {"rtol": 1e-5, "atol": 1e-7}


def _dotted(tree):
    """{dotted path: array} of a JAX tree's array leaves."""
    return {jax.tree_util.keystr(p, simple=True, separator="."):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _empty_nodes(tree):
    """The dotted paths of a JAX tree's None leaves and optax's EmptyState
    nodes (a NamedTuple without fields), as orbax records them."""
    def empty(x):
        return x is None or (isinstance(x, tuple) and hasattr(x, "_fields")
                             and not x._fields)
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=empty)[0]
    return {jax.tree_util.keystr(p, simple=True, separator=".")
            for p, v in leaves if empty(v)}


def _hp(opt, sched):
    return {"optimizer": opt, "lr": 0.5, "eps": 1e-8, "lr_scheduler": sched,
            "warmup_step": 2, "momentum": 0.9}


def _grads(seed, params, scales=(4.0, 1.0, 0.3, 0.7)):
    """One gradient a scale; the second has a NaN (a skipped step)."""
    rng = np.random.RandomState(seed)
    out = [{k: (rng.randn(*v.shape) * s).astype(np.float32)
            for k, v in params.items()} for s in scales]
    out[1]["b"][2] = np.nan
    return out


def _three_steps(opt, sched):
    """The JAX optimizer and the port's after a clipped step, a skipped one
    (NaN) and one under the clip norm on the same two leaves; and the
    fourth gradient."""
    hp = _hp(opt, sched)
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = _grads(5, params)
    jopt = JaxOptimizer(hp, grad_clip=2.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    popt = Optimizer(hp, grad_clip=2.0)
    pparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    for g in grads[:3]:
        jparams, jstate = jopt.step({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        for k, p in pparams.items():
            p.grad = torch.from_numpy(g[k])
        popt.step(pparams)
    return hp, jopt, jparams, jstate, popt, pparams, grads[3]


@pytest.mark.parametrize("opt,sched", OPT_CASES)
def test_to_optax_is_the_optax_state_leaf_for_leaf(opt, sched):
    """``to_optax`` of the port's state after three steps (clipped,
    skipped, plain) has optax's every leaf with its dtype (counters and
    counts exactly) and its empty nodes as None."""
    _, _, _, jstate, popt, _, _ = _three_steps(opt, sched)
    got = optax_state.to_optax(popt.state_dict())
    want = _dotted(jstate)
    arrays = {k: v for k, v in got.items() if v is not None}
    assert sorted(arrays) == sorted(want)
    assert {k for k, v in got.items() if v is None} == _empty_nodes(jstate)
    for k, w in want.items():
        assert arrays[k].dtype == w.dtype and arrays[k].shape == w.shape, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(arrays[k], w, err_msg=k, **PARAM_TOL)
        else:
            np.testing.assert_array_equal(arrays[k], w, err_msg=k)
    assert bool(jstate.last_finite) and int(jstate.total_notfinite) == 1


@pytest.mark.parametrize("opt,sched", OPT_CASES)
def test_from_optax_then_a_step_equals_optax(opt, sched):
    """The port's optimizer loaded with ``from_optax`` of the JAX state
    takes the next step as optax does: parameters, and its whole state
    after it."""
    hp, jopt, jparams, jstate, _, _, g = _three_steps(opt, sched)
    sd = optax_state.from_optax(_dotted(jstate), opt)
    assert sd["optimizer"] == opt.lower() and int(sd["count"]) == 2
    pparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    popt = Optimizer(hp, grad_clip=2.0)
    popt.init(pparams)
    popt.load_state_dict(sd)
    jparams, jstate = jopt.step({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jparams)
    for k, p in pparams.items():
        p.grad = torch.from_numpy(g[k])
    popt.step(pparams)
    for k, p in pparams.items():
        np.testing.assert_allclose(to_np(p), np.asarray(jparams[k]),
                                   err_msg=k, **PARAM_TOL)
    got = optax_state.to_optax(popt.state_dict())
    for k, w in _dotted(jstate).items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, err_msg=k, **PARAM_TOL)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_another_kind_or_disagreeing_counts_raise():
    """A state of another optimizer raises naming both; optax's two counts
    of Adam must agree."""
    _, _, _, jstate, _, _, _ = _three_steps("Adam", "fixed")
    leaves = _dotted(jstate)
    with pytest.raises(ValueError, match="'adam', the configuration asks "
                                         "for 'adadelta'"):
        optax_state.from_optax(leaves, "Adadelta")
    popt = Optimizer({"optimizer": "SGD"})
    popt.init({"a": torch.zeros(3, 4), "b": torch.zeros(5)})
    with pytest.raises(ValueError, match="'adam'.*'sgd'"):
        popt.load_state_dict(optax_state.from_optax(leaves))
    leaves["inner_state.1.1.count"] = np.asarray(7, np.int32)
    with pytest.raises(ValueError, match="step counts disagree"):
        optax_state.from_optax(leaves)
    with pytest.raises(ValueError, match="not the optax state"):
        optax_state.from_optax({"notfinite_count": np.int32(0)})


# ------------------------------------------- directories the port writes

def _port_grads(jgrads, module, plugin):
    """The JAX-tree gradients in the port's names and layouts, as
    ``load_arrays`` carries parameters."""
    m, p = copy.deepcopy(module), copy.deepcopy(plugin)
    load_arrays(m, jax_arrays(jgrads), p)
    out = dict(m.state_dict())
    if p is not None:
        out.update({f"plugin.{n}": t for n, t in p.state_dict().items()})
    return out


def _random_like(tree, seed, scale):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        (rng.randn(*x.shape) * scale).astype(np.float32)), tree)


@pytest.mark.parametrize("case,opt", [("vgg_lstm", "Adadelta"),
                                      ("plugin", "AdamW"), ("lm", "Adam"),
                                      ("lm_tied", "SGD")])
def test_jax_restores_the_ports_optimizer_and_continues_as_it(tmp_path,
                                                              case, opt):
    """Two port steps, then ``save_orbax``: the JAX package's
    ``load_checkpoint`` restores ``optimizer/`` into its optimizer's
    template bit for bit (the port's state through ``to_optax``), it is
    the state optax reached on the same gradients, and the JAX package's
    next step from it equals the port's (the prenet and location-conv
    slots change layout, the plugin's projection transposes, a tied LM
    has no output matrix)."""
    hp = {**_hp(opt, "warmup"), "lr": 0.05}
    jp, model, plugin = _models(case, tmp_path)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    if plugin is not None:
        plugin.requires_grad_(True)
        params.update({f"plugin.{n}": p for n, p in
                       plugin.named_parameters()})
    popt = Optimizer(hp)
    popt.init(params)
    jopt = JaxOptimizer(hp)
    jstate = jopt.init(jp)
    jstep = jax.jit(jopt.step)
    jgrads = [_random_like(jp, s, 0.3 * s) for s in (1, 2, 3)]
    for g in jgrads[:2]:
        jp, jstate = jstep(g, jstate, jp)
        for n, t in _port_grads(g, model, plugin).items():
            params[n].grad = t.clone()
        popt.step(params)
    path = tmp_path / "latest.pth"
    orbax.save_orbax(path, model, popt, global_step=2, plugin=plugin)
    got = jax_load(path, jp, jopt.init(jp))
    assert jax.tree.structure(got["optimizer"]) == jax.tree.structure(jstate)
    mine = optax_state.to_optax(popt.state_dict())
    for k, v in _dotted(got["optimizer"]).items():
        assert v.dtype == mine[k].dtype, k
        np.testing.assert_array_equal(v, mine[k], err_msg=k)
    for k, w in _dotted(jstate).items():
        np.testing.assert_allclose(_dotted(got["optimizer"])[k], w,
                                   err_msg=k, **PARAM_TOL)
    jnext, _ = jstep(jgrads[2], got["optimizer"], got["model"])
    for n, t in _port_grads(jgrads[2], model, plugin).items():
        params[n].grad = t.clone()
    popt.step(params)
    want = _port_grads(jnext, model, plugin)
    for n, p in params.items():
        np.testing.assert_allclose(to_np(p), to_np(want[n]), err_msg=n,
                                   **PARAM_TOL)


# ------------------------------------------------- main --load, JAX-written

N = 3            # the JAX package's steps before its checkpoint


def _asr_config(d):
    """``test_torch_port_train._train_config`` with one encoder layer, at
    tf 1 throughout (the two packages draw teacher forcing from other
    streams), max_step N + 2."""
    from tests.test_torch_port_train import _train_config
    path = _train_config(d)
    cfg = yaml.safe_load(path.read_text())
    enc = cfg["model"]["encoder"]
    for k in ("dim", "dropout", "layer_norm", "proj", "sample_rate"):
        enc[k] = enc[k][:1]
    enc["sample_rate"] = [4]
    cfg["hparas"].update(tf_end=1.0, max_step=N + 2, valid_step=100)
    path.write_text(yaml.safe_dump(cfg))
    vocab = 3 + len(Path(cfg["data"]["text"]["vocab_file"]
                         ).read_text().split())
    return path, cfg, vocab


def _lm_config(d, corpus, opt, sched):
    """config/synthetic/lm.yaml at width 16 and dropout 0 on ``corpus``'s
    lm_text.txt with optimizer ``opt`` under schedule ``sched`` (warmup
    over 3 steps, SGD's momentum 0.9), max_step N + 2."""
    cfg = yaml.safe_load((ROOT / "config/synthetic/lm.yaml").read_text())
    cfg["data"] = {"corpus": {"name": "synthetic", "path": str(corpus),
                              "train_split": ["lm_text.txt"],
                              "dev_split": ["dev-clean"], "batch_size": 5},
                   "text": {"mode": "character",
                            "vocab_file": str(corpus / "vocab.txt")}}
    cfg["model"].update(dim=16, emb_dim=16, dropout=0.0)
    cfg["hparas"].update(max_step=N + 2, valid_step=100, optimizer=opt,
                         lr_scheduler=sched, warmup_step=3, momentum=0.9)
    path = d / "lm.yaml"
    path.write_text(yaml.safe_dump(cfg))
    vocab = 3 + len((corpus / "vocab.txt").read_text().split())
    return path, cfg, vocab


def _jax_solver(kind, cfg, cfg_path, vocab, load, workdir):
    """The JAX package's training solver set up as its ``main`` sets it up
    (``set_model`` with ``--load``), without its corpus."""
    if kind == "asr":
        from end_to_end_asr_pytorch_tpu.solvers.train_asr import Solver
    else:
        from end_to_end_asr_pytorch_tpu.solvers.train_lm import Solver
    paras = SimpleNamespace(config=str(cfg_path), name=None, seed=0,
                            logdir=str(workdir / "jlog"),
                            ckpdir=str(workdir / "jckpt"),
                            outdir=str(workdir / "jout"), load=str(load),
                            njobs=0, no_msg=True, amp=False)
    solver = Solver(copy.deepcopy(cfg), paras)
    solver.vocab_size = vocab
    solver.feat_dim = 40
    solver.tokenizer = None
    solver.set_model()
    return solver


def _jax_steps(solver, kind, batches):
    """The JAX solver's jitted train step on each (host) batch from its
    step counter, as its ``exec`` takes them: the losses."""
    rng_base = jax.random.PRNGKey(solver.paras.seed + 1)
    step = jnp.asarray(solver.step, jnp.int32)
    keys = (("wave", "wave_len", "text", "text_len") if kind == "asr"
            else ("text", "text_len"))
    losses = []
    for b in batches:
        hb = jax_mesh.pad_batch_to({k: b[k] for k in keys}, solver.n_dev)
        sb = jax_mesh.shard_batch(solver.mesh, hb)
        solver.params, solver.opt_state, step, out = solver._train_step(
            solver.params, solver.opt_state, step, *[sb[k] for k in keys],
            rng_base)
        losses.append(float(out["loss"] if kind == "asr" else out))
    return losses


def _record_port_steps(monkeypatch, kind):
    """Spy on the port solver's ``train_step``: each batch (numpy, in the
    JAX loader's dtypes) and its loss."""
    mod = port_train_asr if kind == "asr" else port_train_lm
    seen = []
    orig = mod.Solver.train_step

    def spy(self, *args, rows=None):
        m = orig(self, *args, rows=rows)
        names = (("wave", "wave_len", "text", "text_len") if kind == "asr"
                 else ("text", "text_len"))
        b = {k: to_np(a) for k, a in zip(names, args)}
        for k in ("wave_len", "text", "text_len"):
            if k in b:
                b[k] = b[k].astype(np.int32)
        seen.append((b, float(m["loss"])))
        return m
    monkeypatch.setattr(mod.Solver, "train_step", spy)
    return seen


def _jax_checkpoints(kind, cfg, vocab, d):
    """The JAX package's weights and optimizer after N steps on random
    gradients (one skipped), saved with its own ``save_checkpoint`` in
    both formats."""
    if kind == "asr":
        from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
        jp = JaxASR(40, vocab, cfg["model"]).init(jax.random.PRNGKey(4))
    else:
        from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
        jp = JaxLM(vocab, cfg["model"]).init(jax.random.PRNGKey(4))
    jopt = JaxOptimizer(cfg["hparas"], grad_clip=5.0)
    state = jopt.init(jp)
    jstep = jax.jit(jopt.step)
    for s in range(N + 1):
        g = _random_like(jp, 10 + s, 0.5)
        if s == 1:
            g = jax.tree.map(lambda x: x.at[(0,) * x.ndim].set(jnp.nan), g)
        jp, state = jstep(g, state, jp)
    assert int(state.total_notfinite) == 1
    paths = {"native": d / "jax_native.pth", "orbax": d / "jax_orbax.pth"}
    jax_save(str(paths["native"]), jp, state, N, {"x": 1.0})
    jax_save(str(paths["orbax"]), jp, state, N, {"x": 1.0}, fmt="orbax")
    assert (paths["orbax"] / "optimizer" / "manifest.ocdbt").is_file()
    return paths


# (model, optimizer, schedule): the JAX-written formats the port resumes
RESUME_CASES = {("asr", "Adadelta", "fixed"): ("native", "orbax"),
                ("lm", "Adam", "fixed"): ("native", "orbax"),
                **{("lm", o, sch): (("native", "orbax")[i % 2],)
                   for i, (o, sch) in enumerate(OPT_CASES)
                   if (o, sch) != ("Adam", "fixed")}}
RESUME_RUNS = [(case, fmt) for case, fmts in RESUME_CASES.items()
               for fmt in fmts]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """For each case of ``RESUME_CASES``: JAX-written checkpoints at step N
    in both formats; the port's ``main --load`` of each listed format to
    step N + 2 (its batches, losses, the written latest.pth read back);
    the JAX solver's ``--load`` of the same checkpoint stepped on those
    batches."""
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import \
        generate_corpus
    corpus = generate_corpus(str(tmp_path_factory.mktemp("lm_corpus")),
                             n_train=6, n_dev=3, n_test=0, text_only=40)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for case, fmts in RESUME_CASES.items():
            kind = case[0]
            d = tmp_path_factory.mktemp("resume_" + "_".join(case))
            cfg_path, cfg, vocab = (_asr_config(d) if kind == "asr" else
                                    _lm_config(d, corpus, *case[1:]))
            paths = _jax_checkpoints(kind, cfg, vocab, d)
            runs = {}
            for fmt in fmts:
                seen = _record_port_steps(mp, kind)
                argv = ["--config", str(cfg_path), "--cpu", "--no-msg",
                        "--logdir", str(d / fmt / "log"), "--ckpdir",
                        str(d / fmt / "ckpt"), "--load", str(paths[fmt])]
                port_main.main(argv + (["--lm"] if kind == "lm" else []))
                mp.undo()
                latest = d / fmt / "ckpt" / f"{cfg_path.stem}_sd0" / \
                    "latest.pth"
                model = (ASR(40, vocab, cfg["model"], device="cpu")
                         if kind == "asr" else
                         RNNLM(vocab, cfg["model"], device="cpu"))
                jax_ckpt.load_checkpoint(str(latest), model)
                runs[fmt] = {"seen": seen, "model": model.state_dict(),
                             "ck": torch.load(str(latest), weights_only=True)}
            batches = [b for b, _ in runs[fmts[0]]["seen"]]
            solver = _jax_solver(kind, cfg, cfg_path, vocab, paths[fmts[0]],
                                 d)
            assert solver.step == N
            losses = _jax_steps(solver, kind, batches)
            out[case] = {"runs": runs, "cfg": cfg, "vocab": vocab,
                         "paths": paths, "jax_losses": losses,
                         "jax_params": jax_arrays(solver.params),
                         "jax_state": solver.opt_state, "batches": batches}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case,fmt", RESUME_RUNS,
                         ids=["-".join((*c, f)) for c, f in RESUME_RUNS])
def test_main_load_continues_as_the_jax_packages_load(resumed, case, fmt):
    """Steps N + 1 and N + 2 after the port's ``main --load`` (``main --lm
    --load``) of a JAX-written checkpoint take the losses the JAX
    package's solver takes after its own ``--load`` of it, and reach its
    weights and its optax state; the count is N + 2."""
    r = resumed[case]
    run = r["runs"][fmt]
    assert len(run["seen"]) == 2
    for (b, _), want in zip(run["seen"], r["batches"]):
        for k, v in want.items():
            np.testing.assert_array_equal(b[k], v)
    np.testing.assert_allclose([l for _, l in run["seen"]], r["jax_losses"],
                               rtol=1e-5)
    ck = run["ck"]
    assert ck["global_step"] == N + 2
    assert int(ck["optimizer"]["count"]) == N + 2
    assert ck["optimizer"]["optimizer"] == case[1].lower()
    for path, w in r["jax_params"].items():
        name = port_name(path)
        np.testing.assert_allclose(to_np(run["model"][name]),
                                   _to_port_layout(name, w), err_msg=name,
                                   **PARAM_TOL)
    got = optax_state.to_optax(ck["optimizer"])
    for k, w in _dotted(r["jax_state"]).items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, err_msg=k, **PARAM_TOL)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("fmt", ["native", "orbax"])
def test_a_checkpoint_of_another_optimizer_raises_in_both_packages(
        resumed, tmp_path, fmt):
    """The LM's Adam checkpoint under a configuration asking for Adadelta:
    the port's ``--load`` raises naming both, as the JAX package's restore
    into an Adadelta template fails."""
    r = resumed[("lm", "Adam", "fixed")]
    cfg = copy.deepcopy(r["cfg"])
    cfg["hparas"]["optimizer"] = "Adadelta"
    path = tmp_path / "lm.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="'adam', the configuration asks "
                                         "for 'adadelta'"):
        port_main.main(["--config", str(path), "--lm", "--cpu", "--no-msg",
                        "--logdir", str(tmp_path / "log"), "--ckpdir",
                        str(tmp_path / "ckpt"), "--load",
                        str(r["paths"][fmt])])
    from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
    jp = JaxLM(r["vocab"], cfg["model"]).init(jax.random.PRNGKey(0))
    with pytest.raises(Exception):
        jax_load(str(r["paths"][fmt]), jp,
                 JaxOptimizer(cfg["hparas"]).init(jp))


def test_model_parallel_2_resumes_a_jax_checkpoint_as_world_1(resumed,
                                                              tmp_path):
    """The ASR's JAX-written orbax checkpoint under ``model_parallel: 2``
    on a gloo group of two: each rank keeps its part of the whole optax
    state; the two steps equal world 1's ``main --load`` (losses, whole
    parameters and slots, count), and the checkpoint the group then
    writes (``tp.whole``) is the optax state the JAX package's solver
    reached, restored by the JAX package."""
    r = resumed[("asr", "Adadelta", "fixed")]
    cfg = {"audio": r["cfg"]["data"]["audio"], "model": r["cfg"]["model"],
           "vocab": r["vocab"]}
    w2 = dh.run_world(dh.tp_asr_steps, 2, tmp_path / "g2", 2, cfg,
                      r["cfg"]["hparas"], r["batches"], str(tmp_path / "w"),
                      str(r["paths"]["orbax"]), "tp.pth", "orbax")
    world1 = r["runs"]["orbax"]
    for rank in w2:
        assert rank["split"], "nothing was split at model_parallel 2"
        np.testing.assert_allclose([m["loss"] for m in rank["losses"]],
                                   [l for _, l in world1["seen"]], rtol=1e-5)
        assert rank["count"] == N + 2
        for n, v in world1["model"].items():
            np.testing.assert_allclose(to_np(rank["whole"][n]), to_np(v),
                                       err_msg=n, **PARAM_TOL)
        for n, d in world1["ck"]["optimizer"]["slots"].items():
            for s, v in d.items():
                np.testing.assert_allclose(
                    to_np(rank["whole_slots"][f"{n}.{s}"]), to_np(v),
                    err_msg=f"{n}.{s}", **PARAM_TOL)
    from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
    jp = JaxASR(40, r["vocab"], r["cfg"]["model"]).init(
        jax.random.PRNGKey(0))
    got = jax_load(str(tmp_path / "w" / "ckpt" / "dist_sd0" / "tp.pth"), jp,
                   JaxOptimizer(r["cfg"]["hparas"]).init(jp))
    assert got["global_step"] == 2
    for k, w in _dotted(r["jax_state"]).items():
        np.testing.assert_allclose(_dotted(got["optimizer"])[k], w,
                                   err_msg=k, **PARAM_TOL)


def _unpack(d):
    import base64
    return np.frombuffer(base64.b64decode(d["b64"]),
                         np.dtype(d["dtype"])).reshape(d["shape"])


def test_the_committed_lm_resume_fixture_holds(tmp_path):
    """``tests/fixtures/jax_orbax_lm_resume`` (``make_jax_resume_fixture.py``,
    which ``chip_smoke.py``'s ``jax_resume_entry`` resumes on the card):
    the JAX package regenerates it with the same leaves (model and optax
    state, read by the port) and the same recorded steps; the port's LM
    Solver with ``--load`` on it takes the recorded losses (rtol 1e-5) and
    reaches the recorded leaf norms (rtol 1e-5) at count 6, and the
    control that starts the optimizer afresh misses the leaf norms by more
    than the card's bound of 1e-4."""
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import Solver
    from tests.make_jax_resume_fixture import STEPS, main as make_fixture
    fixture = ROOT / "tests" / "fixtures" / "jax_orbax_lm_resume"
    make_fixture(["--out", str(tmp_path / "again")])
    ref = json.loads((fixture / "outputs.json").read_text())
    assert json.loads((tmp_path / "again" / "outputs.json").read_text()) \
        == ref
    for item in ("model", "optimizer"):
        got, _ = orbax.read_item(fixture / "latest.pth" / item)
        want, _ = orbax.read_item(tmp_path / "again" / "latest.pth" / item)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    assert ref["model"]["dropout"] == 0.0 and ref["saved_at"] == STEPS
    norms = {}
    for route in ("resumed", "control"):
        paras = SimpleNamespace(config="lm.yaml", name=None, seed=0,
                                logdir=str(tmp_path / "log"),
                                ckpdir=str(tmp_path / "ckpt"),
                                load=str(fixture / "latest.pth"), njobs=0,
                                no_msg=True, cpu=True, amp=False)
        solver = Solver({"data": {"corpus": {"name": "none"},
                                  "text": {"mode": "character"}},
                         "model": ref["model"], "hparas": ref["hparas"]},
                        paras)
        solver.vocab_size = ref["vocab_size"]
        solver.set_model()
        assert solver.step == STEPS
        if route == "control":
            solver.optimizer.init(solver.params)
        losses = [float(solver.train_step(
            torch.from_numpy(_unpack(b["text"]).astype(np.int64)),
            torch.from_numpy(_unpack(b["text_len"]).astype(np.int64)))["loss"])
            for b in ref["batches"]]
        norms[route] = {n: float(p.detach().double().norm())
                        for n, p in solver.params.items()}
        if route == "resumed":
            np.testing.assert_allclose(
                losses, [st["loss"] for st in ref["steps"]], rtol=1e-5)
            assert int(solver.optimizer.count) == 2 * STEPS \
                == ref["steps"][-1]["count"]
    for n, v in ref["leaf_norms"].items():
        np.testing.assert_allclose(norms["resumed"][port_name(n)], v,
                                   rtol=1e-5, err_msg=n)
    assert max(abs(norms["control"][port_name(n)] - v) / v
               for n, v in ref["leaf_norms"].items()) > 1e-4
