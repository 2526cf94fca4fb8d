"""Tensor parallelism of the port (``model_parallel: M``: ``parallel/mesh.py``
layout and rule, ``parallel/tp.py`` compute) on the CPU, in gloo groups of
spawned processes (``tests/torch_port_dist.py``).

The port's placement rule is held to the JAX package's
``model_parallel_spec`` leaf by leaf, optimizer slots included; its steps at
world 2 (1 x 2) and world 4 (2 x 2) to the JAX package's step on
``make_mesh(n, model_parallel=M)`` over the conftest's 8 CPU devices, at
V=16 (the rule splits the vocabulary leaves) and V=15 (they replicate);
dropout, teacher forcing, SpecAugment and the embedding plugin at 2 x 2,
a clipped step and a non-finite step to the port's world 1; each rank's
storage to the world-1 bytes cut by the rule; a checkpoint written at
M=2 to world 1's, loaded at M=1 and M=4. Tolerances as the data-parallel
tests: loss rtol 1e-5, parameters after the optimizer rtol 1e-4 / atol
1e-6. Each group is spawned once per module (``tp_jobs`` runs several
cases in it) to keep the file's time down.
"""
import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from end_to_end_asr_pytorch_tpu.optim import Optimizer as JaxOptimizer
from end_to_end_asr_pytorch_tpu.parallel import mesh as pmesh
from end_to_end_asr_pytorch_tpu.solvers.train_asr import masked_ce as jax_masked_ce
from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
from end_to_end_asr_pytorch_tpu_torch.optim import Optimizer
from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import save_checkpoint
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    _to_port_layout, asr_from_arrays, port_name)
from tests import torch_port_dist as dh
from tests.torch_port_fixtures import ASR_CFG, AUDIO_CFG, jax_arrays, to_np, waves

torch.set_num_threads(1)
ADADELTA = {"optimizer": "Adadelta", "lr": 1.0, "eps": 1e-8,
            "lr_scheduler": "fixed"}
ADAM = {"optimizer": "Adam", "lr": 1e-3, "eps": 1e-8, "lr_scheduler": "fixed"}
LENS = (7040, 5600, 3300, 6100, 4000, 2500)
VOCABS = (16, 15)
# the quicker model of the data-parallel tests, its dims divisible by 4
MODEL = copy.deepcopy(ASR_CFG)
MODEL["encoder"].update(prenet="", dim=[16], sample_rate=[2])


def _batch(seed, V, lens=LENS, U=8):
    """A global numpy batch: ragged waves, labels in [3, V)."""
    w, wl = waves(seed, lens)
    rng = np.random.RandomState(seed + 100)
    text_len = rng.randint(2, U + 1, len(lens)).astype(np.int32)
    text = rng.randint(3, V, (len(lens), U)).astype(np.int32)
    text[np.arange(U)[None, :] >= text_len[:, None]] = 0
    return {"wave": w, "wave_len": wl, "text": text, "text_len": text_len}


def _spec_dim(spec):
    """A JAX PartitionSpec as the port's rule states it: the dimension
    split over 'model', or None."""
    return next((i for i, a in enumerate(spec) if a == "model"), None)


# ------------------------------------------------------------ the rule
def test_port_rule_equals_the_jax_rule_on_every_leaf():
    """``mesh.model_parallel_spec`` on the port's names and layouts gives
    the JAX rule's placement for every parameter and every optax slot of
    the JAX package's tp test model (V=16) and of a V=15 one, at M=2 and
    4; a port optimizer's slots take their parameter's placement."""
    for V in (16, 15):
        cfg = {"ctc_weight": 0.5,
               "encoder": {"prenet": "", "module": "LSTM",
                           "bidirection": True, "dim": [16],
                           "sample_rate": [2], "sample_style": "drop"},
               "attention": {"mode": "dot", "dim": 8, "num_head": 1},
               "decoder": {"module": "LSTM", "dim": 16, "layer": 1}}
        jp = JaxASR(8, V, cfg).init(jax.random.PRNGKey(0))
        state = JaxOptimizer(ADAM).init(jp)
        port = ASR(8, V, cfg, device="cpu")
        opt = Optimizer(ADAM)
        opt.init(dict(port.named_parameters()))
        for m in (2, 4):
            flat = jax.tree_util.tree_flatten_with_path(jp)[0]
            n_split = 0
            for path, leaf in flat:
                name = port_name(jax.tree_util.keystr(path))
                shape = _to_port_layout(name, np.asarray(leaf)).shape
                want = _spec_dim(pmesh.model_parallel_spec(path, leaf, m))
                assert mesh.model_parallel_spec(name, shape, m) == want, name
                for slot, v in opt.slots[name].items():
                    assert mesh.model_parallel_spec(
                        name, v.shape, m) == want, (name, slot)
                n_split += want is not None
            assert n_split > 0
            # optax's leaves mirror the parameter names: the same rule
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
                if not getattr(leaf, "ndim", 0):
                    continue
                name = port_name(jax.tree_util.keystr(path))
                want = _spec_dim(pmesh.model_parallel_spec(path, leaf, m))
                assert mesh.model_parallel_spec(name, leaf.shape, m) == want
        if V == 15:
            assert mesh.model_parallel_spec("char_w", (16, 15), 2) is None
            assert mesh.model_parallel_spec("embed", (15, 16), 2) is None


def test_port_rule_at_v16384_splits_exactly_the_jax_set():
    """The JAX package's exact-set test over the port's names: at V=16384
    and M=4 every gate, attention and vocabulary leaf is split and only
    the conv kernels and biases replicate; an embedding plugin's
    projection matches no set and replicates, as in JAX."""
    cfg = {"ctc_weight": 0.5,
           "encoder": {"prenet": "vgg", "module": "LSTM", "bidirection": True,
                       "dim": [32, 32], "sample_rate": [1, 1],
                       "sample_style": "drop", "dropout": [0.0, 0.0],
                       "layer_norm": [False, False], "proj": [False, False]},
           "attention": {"mode": "loc", "dim": 16, "num_head": 1},
           "decoder": {"module": "LSTM", "dim": 32, "layer": 1}}
    model = ASR(40, 16384, cfg, device="cpu")
    specs = {n: mesh.model_parallel_spec(n, p.shape, 4)
             for n, p in model.named_parameters()}
    expected = {}
    for layer in (0, 1):
        for d in ("fwd", "bwd"):
            for leaf, dim in (("w_ih", 1), ("w_hh", 1), ("b", 0)):
                expected[f"encoder.layers.{layer}.{d}.{leaf}"] = dim
    expected.update({
        "ctc_w": 1, "ctc_b": 0, "char_w": 1, "char_b": 0, "embed": 0,
        "attention.w_q": 1, "attention.w_k": 1, "attention.w_v": 1,
        "attention.w_f": 1, "attention.v_energy": 1, "attention.bias": 0,
        "decoder.cells.0.w_ih": 1, "decoder.cells.0.w_hh": 1,
        "decoder.cells.0.b": 0})
    assert {n: d for n, d in specs.items() if d is not None} == expected
    assert {n for n, d in specs.items() if d is None} == {
        *(f"encoder.prenet.{k}{i}" for k in "kb" for i in range(1, 5)),
        "attention.loc_conv"}
    for name in ("plugin.w_proj", "plugin.b_proj"):
        assert mesh.model_parallel_spec(name, (16, 32), 4) is None


def test_model_parallel_that_does_not_divide_the_world_raises():
    """As ``make_mesh``: M=2 at world 1 raises naming model_parallel; M=1
    changes nothing."""
    with pytest.raises(ValueError, match="model_parallel"):
        mesh.set_model_parallel(2)
    assert mesh.set_model_parallel(1).m == 1 and mesh.model_size() == 1


# ------------------------------------------------- the JAX tp reference
def _jax_tp_step(V, batch, hparas, n, m, seed=0):
    """The JAX package's step on ``make_mesh(n, model_parallel=m)``: the
    parameters and the optax state placed by its rule, the batch padded to
    n and split over 'data', the solver's joint loss at tf 1, one step."""
    jm = JaxASR(40, V, MODEL)
    jp = jm.init(jax.random.PRNGKey(seed))
    frontend = JaxFrontend(AUDIO_CFG)
    U = batch["text"].shape[1]

    def loss_fn(p, wave, wave_len, text, text_len):
        feat, flen = frontend(wave, wave_len)
        ctc_out, enc_len, att_out, _, _ = jm.forward(
            p, feat, flen, U, 1.0, teacher=text, train=True,
            rng=jax.random.PRNGKey(7))
        valid = text_len > 0
        nll = jax_ctc_loss(ctc_out, enc_len, text, text_len)
        per = nll / jnp.maximum(text_len, 1)
        ctc_l = jnp.sum(jnp.where(valid & (nll < 1e29), per, 0.0)) / \
            jnp.maximum(jnp.sum(valid), 1)
        return 0.5 * ctc_l + 0.5 * jax_masked_ce(att_out, text)

    mm = pmesh.make_mesh(n, model_parallel=m)
    sb = pmesh.shard_batch(mm, pmesh.pad_batch_to(batch, n))
    pr = pmesh.shard_params(mm, jp)
    assert any("model" in str(l.sharding.spec)
               for l in jax.tree_util.tree_leaves(pr))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        pr, sb["wave"], sb["wave_len"], sb["text"], sb["text_len"])
    jopt = JaxOptimizer(hparas, grad_clip=5.0)
    new, _ = jopt.step(grads, pmesh.shard_params(mm, jopt.init(pr)), pr)
    return jp, float(loss), jax_arrays(new)


def _cfg(V, model=MODEL, audio=AUDIO_CFG):
    return {"audio": audio, "model": model, "vocab": V}


def _init_ckpt(root, V, jp):
    path = Path(root) / f"init_v{V}.pth"
    if not path.exists():
        save_checkpoint(path, asr_from_arrays(40, V, MODEL, jax_arrays(jp),
                                              device="cpu"))
    return str(path)


def _options_cfg(root, V=16):
    table = np.random.RandomState(5).randn(V, 16).astype(np.float32)
    np.save(Path(root) / "emb.npy", table)
    model = copy.deepcopy(MODEL)
    model["encoder"]["dropout"] = [0.3]
    model["decoder"].update(layer=2, dropout=0.3)
    model["emb_drop"] = 0.3
    model["plugin"] = {"src": str(Path(root) / "emb.npy"), "weight": 0.7}
    audio = dict(AUDIO_CFG, augment={"freq_mask_width": 8,
                                     "time_mask_width": 10})
    return _cfg(V, model, audio)


OPT_HP = dict(ADADELTA, tf_start=0.5, tf_end=0.5)
OPT_BATCHES = [_batch(1, 16),
               _batch(2, 16, lens=(3000, 6400, 5000, 2000, 7000, 900))]
CLIP_HP = dict(ADAM, GRAD_CLIP=0.05)
AMP_HP = dict(ADAM, amp=True)


def _nan_batch():
    b = _batch(3, 16)
    b["wave"][1, 100] = np.nan
    return b


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX tp step at (world, M) = (2, 2) and (4, 2), V=16 and 15."""
    return {(n, V): _jax_tp_step(V, _batch(0, V), ADADELTA, n, 2)
            for n in (2, 4) for V in VOCABS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_refs):
    """Every group this module spawns, once: world 2 at M=2 (the JAX
    steps, a clipped step, a non-finite step, an Adam step that writes a
    checkpoint), world 4 at M=2 (the JAX steps, the options), world 4 at
    M=4 (that checkpoint loaded, one more step); and world 1 in this
    process for each."""
    d = tmp_path_factory.mktemp("tp")
    inits = {V: _init_ckpt(d, V, jax_refs[(2, V)][0]) for V in VOCABS}
    opt = _options_cfg(d)
    ck = f"{d}/w2/ckpt/dist_sd0/tp.pth"
    w2_jobs = [("tp_asr_steps", (2, _cfg(V), ADADELTA, [_batch(0, V)],
                                 f"{d}/w2/{V}", inits[V])) for V in VOCABS]
    w2_jobs += [("tp_asr_steps", (2, _cfg(16), CLIP_HP, [_batch(0, 16)],
                                  f"{d}/w2/clip", inits[16])),
                ("tp_asr_steps", (2, _cfg(16), ADAM, [_nan_batch()],
                                  f"{d}/w2/nan", inits[16])),
                ("tp_asr_steps", (2, _cfg(16), ADAM, [_batch(4, 16)],
                                  f"{d}/w2", inits[16], "tp.pth")),
                ("tp_asr_steps", (2, _cfg(16), AMP_HP, [_batch(6, 16)],
                                  f"{d}/w2/amp", inits[16])),
                ("tp_drift", (2, _cfg(16), ADAM, [_batch(4, 16)] * 2,
                              f"{d}/w2/drift", inits[16]))]
    w4_jobs = [("tp_asr_steps", (2, _cfg(V), ADADELTA, [_batch(0, V)],
                                 f"{d}/w4/{V}", inits[V])) for V in VOCABS]
    w4_jobs.append(("tp_asr_steps", (2, opt, OPT_HP, OPT_BATCHES,
                                     f"{d}/w4/opt")))
    out = {"w2": dh.run_world(dh.tp_jobs, 2, d / "g2", w2_jobs),
           "w4": dh.run_world(dh.tp_jobs, 4, d / "g4", w4_jobs),
           "m4": dh.run_world(dh.tp_jobs, 4, d / "g44", [
               ("tp_asr_steps", (4, _cfg(16), ADAM, batches, f"{d}/m4", ck))
               for batches in ([], [_batch(5, 16)])]),
           "ckpt": ck}
    one = lambda *a: dh.tp_asr_steps(0, 1, 1, *a)
    out["w1"] = {
        "clip": one(_cfg(16), CLIP_HP, [_batch(0, 16)], f"{d}/1c", inits[16]),
        "nan": one(_cfg(16), ADAM, [_nan_batch()], f"{d}/1n", inits[16]),
        "save": one(_cfg(16), ADAM, [_batch(4, 16)], f"{d}/w1", inits[16],
                    "tp.pth"),
        "opt": one(opt, OPT_HP, OPT_BATCHES, f"{d}/1o"),
        "m4": one(_cfg(16), ADAM, [_batch(5, 16)], f"{d}/1m4", ck),
        "load": one(_cfg(16), ADAM, [], f"{d}/1l", ck),
        "amp": one(_cfg(16), AMP_HP, [_batch(6, 16)], f"{d}/1a", inits[16]),
        "init16": one(_cfg(16), ADAM, [], f"{d}/1i", inits[16])}
    out["w1_ckpt"] = f"{d}/w1/ckpt/dist_sd0/tp.pth"
    return out


def _assert_close(got, ref, names=None):
    for n in names or ref:
        np.testing.assert_allclose(to_np(got[n]), to_np(ref[n]), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def _assert_group_identical(res):
    """Every rank: the same losses and the same whole parameters and
    slots (the replicated leaves bit-identical in every rank's store)."""
    for r in res[1:]:
        for got, want in zip(r["losses"], res[0]["losses"]):
            assert sorted(got) == sorted(want)
            np.testing.assert_array_equal([got[k] for k in sorted(got)],
                                          [want[k] for k in sorted(want)])
        for key in ("whole", "whole_slots"):
            for n, v in res[0][key].items():
                assert torch.equal(r[key][n], v), n
        for n in res[0]["params"]:
            if n not in res[0]["split"]:
                assert torch.equal(r["params"][n], res[0]["params"][n]), n


# ------------------------------------------------------- steps vs JAX
@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("world", [2, 4])
def test_tp_step_matches_the_jax_tp_step(runs, jax_refs, world, V):
    """1 x 2 (B=6 padded to 6) and 2 x 2 (padded to 8, the second data
    index holding two dummy rows): the port's step against the JAX step on
    ``make_mesh(world, model_parallel=2)``; at V=15 the vocabulary leaves
    replicate and every other rule still fires."""
    res = [r[VOCABS.index(V)] for r in runs[f"w{world}"]]
    _assert_group_identical(res)
    _, ref_loss, ref = jax_refs[(world, V)]
    np.testing.assert_allclose(res[0]["losses"][0]["loss"], ref_loss,
                               rtol=1e-5)
    got = res[0]["whole"]
    assert len(got) == len(ref)
    for path, v in ref.items():
        name = port_name(path)
        np.testing.assert_allclose(to_np(got[name]), _to_port_layout(name, v),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    vocab = {"ctc_w", "ctc_b", "char_w", "char_b", "embed"}
    assert (vocab <= set(res[0]["split"])) == (V % 2 == 0)
    assert "encoder.layers.0.fwd.w_hh" in res[0]["split"]


def test_tp_2x2_with_dropout_teacher_forcing_augment_and_plugin(runs):
    """Two steps with dropout 0.3 (encoder, 2-layer decoder, embedding),
    teacher forcing 0.5, SpecAugment and the embedding plugin at 2 x 2
    against the port's world 1 on the same seed."""
    res = [r[2] for r in runs["w4"]]
    ref = runs["w1"]["opt"]
    _assert_group_identical(res)
    for got, want in zip(res[0]["losses"], ref["losses"]):
        for k in ("loss", "ctc_loss", "att_loss", "emb_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _assert_close(res[0]["whole"], ref["whole"])
    _assert_close(res[0]["whole_slots"], ref["whole_slots"])
    assert "plugin.w_proj" not in res[0]["split"]


@pytest.mark.parametrize("case,job", [("clip", 2), ("nan", 3), ("amp", 5)])
def test_tp_clipped_and_non_finite_steps_equal_world1(runs, case, job):
    """A step whose norm (1.7) exceeds the clip (0.05), a step with a NaN
    sample (non-finite gradient: no parameter, slot or count moves), and an
    amp step (``hparas.amp``: the split parts rounded to bf16, then
    gathered) at 1 x 2 against world 1: the norm summed over the model
    group, the skip taken together."""
    res = [r[job] for r in runs["w2"]]
    ref = runs["w1"][case]
    _assert_group_identical(res)
    g, w = res[0]["losses"][0]["grad_norm"], ref["losses"][0]["grad_norm"]
    if case != "nan":
        assert w > 1.0 or case == "amp"
        np.testing.assert_allclose(g, w, rtol=1e-5)
        np.testing.assert_allclose(res[0]["losses"][0]["loss"],
                                   ref["losses"][0]["loss"], rtol=1e-5)
        assert res[0]["count"] == ref["count"] == 1
    else:
        assert not np.isfinite(g) and not np.isfinite(w)
        assert res[0]["count"] == ref["count"] == 0
        init = runs["w1"]["init16"]["whole"]
        for n, v in res[0]["whole"].items():
            assert torch.equal(v, init[n]), n
    _assert_close(res[0]["whole"], ref["whole"])
    _assert_close(res[0]["whole_slots"], ref["whole_slots"])


def test_replicated_leaves_stay_identical_when_rank_gradients_differ(runs):
    """At 1 x 2, each rank's gradient of the replicated leaves moved by a
    different amount in its backward (as sums in another order would move
    it): after two Adam steps the replicated leaves and their slots are
    still bit-identical across the ranks, since every rank takes model
    index 0's gradient, and the norm is the same on both."""
    res = [r[6] for r in runs["w2"]]
    rep = [n for n in res[0]["params"] if n not in res[0]["split"]]
    assert rep == ["attention.loc_conv"]
    _assert_group_identical(res)
    for n in rep:
        for s in ("mu", "nu"):
            assert torch.equal(res[1]["slots"][f"{n}.{s}"],
                               res[0]["slots"][f"{n}.{s}"]), (n, s)


def test_all_reduce_grads_makes_no_collective_over_one_data_rank(runs):
    """At 1 x 2 the data group is one rank: ``all_reduce_grads`` returns
    before any all-reduce."""
    assert [r[6]["all_reduce_calls"] for r in runs["w2"]] == [0, 0]


def test_each_rank_holds_its_part_of_every_split_leaf(runs):
    """At 1 x 2, V=16: each rank's parameters and Adadelta slots are its
    part of the whole (``narrow`` along the rule's dimension), and its
    bytes are the world-1 bytes cut by the rule."""
    res = [r[0] for r in runs["w2"]]
    whole = res[0]["whole"]
    want = sum(v.numel() // (2 if n in res[0]["split"] else 1)
               for n, v in whole.items()) * 4
    for rank, r in enumerate(res):
        assert sum(v.numel() * 4 for v in r["params"].values()) == want
        assert sum(v.numel() * 4 for v in r["slots"].values()) == 2 * want
        for n, v in r["params"].items():
            dim = r["split"].get(n)
            full = whole[n] if dim is None else whole[n].narrow(
                dim, rank * v.shape[dim], v.shape[dim])
            assert torch.equal(v, full), n
            for s in ("e_g", "e_x"):
                part = r["slots"][f"{n}.{s}"]
                full = r["whole_slots"][f"{n}.{s}"]
                if dim is not None:
                    full = full.narrow(dim, rank * v.shape[dim], v.shape[dim])
                assert torch.equal(part, full), (n, s)
    assert 0 < want < sum(v.numel() for v in whole.values()) * 4


def test_checkpoint_written_at_m2_equals_world1_and_loads_at_m1_and_m4(runs):
    """The M=2 ranks' checkpoint (whole tensors, rank 0 writing) equals
    world 1's after the same Adam step; loaded at M=4 (1 x 4) each rank
    holds its parts of it (the whole view equals a world-1 load bit for
    bit), and one more step there equals one at world 1."""
    a = torch.load(runs["ckpt"], weights_only=True)
    b = torch.load(runs["w1_ckpt"], weights_only=True)
    assert a["global_step"] == b["global_step"] == 1
    assert sorted(a["model"]) == sorted(b["model"])
    _assert_close(a["model"], b["model"])
    sa, sb = a["optimizer"]["slots"], b["optimizer"]["slots"]
    assert sorted(sa) == sorted(sb)
    for n in sb:
        _assert_close(sa[n], sb[n])
        for s in sb[n]:
            assert sa[n][s].shape == sb[n][s].shape
    assert int(a["optimizer"]["count"]) == 1
    loaded = [r[0] for r in runs["m4"]]
    _assert_group_identical(loaded)
    assert all(len(r["split"]) == 20 for r in loaded)
    for key in ("whole", "whole_slots"):
        want = runs["w1"]["load"][key]
        assert sorted(loaded[0][key]) == sorted(want)
        for n, v in want.items():
            assert torch.equal(loaded[0][key][n], v), n
    assert loaded[0]["count"] == runs["w1"]["load"]["count"] == 1
    m4, ref = [r[1] for r in runs["m4"]], runs["w1"]["m4"]
    _assert_group_identical(m4)
    np.testing.assert_allclose(m4[0]["losses"][0]["loss"],
                               ref["losses"][0]["loss"], rtol=1e-5)
    _assert_close(m4[0]["whole"], ref["whole"])
    _assert_close(m4[0]["whole_slots"], ref["whole_slots"])
    assert m4[0]["count"] == ref["count"] == 2
