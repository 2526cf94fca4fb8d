"""K7's bf16 variant (amp training with ``attention.use_pallas_train``)
against the JAX package on the CPU.

Held here:
  * the bf16 plain versions (``loc_att_fwd_plain`` / ``loc_att_bwd_plain``
    on bf16 q, keys, f, v and vals, which the wrappers ``loc_att_fwd_bf16``
    / ``loc_att_bwd_bf16`` take for CPU tensors) and ``LocAttTrain``'s hand
    backward on them, against ``loc_att_train(..., interpret=True)`` on the
    same bf16 inputs under ``jax.vjp``: ctx and align f32, the five
    gradients bf16; ragged lengths with a full row and a row of length 1;
  * masked frames: zero dtarg and dvals past each length;
  * the wrappers' input checks;
  * ``Attention.step`` under amp (bf16 cache and query, weights rounded to
    bf16) with ``use_pallas_train`` against the JAX package's ``step`` on
    bf16 weights, values and gradients;
  * one amp ``Solver.train_step`` with ``use_pallas_train`` against the JAX
    solver's amp ``loss_fn``;
  * amp greedy decoding (a bf16 encoding, weights rounded to bf16) through
    the bf16 route: the same ids as the JAX package's;
  * ``main --amp --cpu`` with ``use_pallas_train``: training through the
    bf16 route, validation through the f32 one (the JAX solver validates
    in f32).

On the CPU the JAX ``step`` takes its plain chain; the ``jax_k7`` fixture
routes it through ``loc_att_train`` in interpret mode, from the test side
only (the JAX package is left as it is).

What the reference computes: in interpret mode XLA keeps the kernel's bf16
intermediates in f32 where it can. q + keys and then + f are each rounded
to bf16, but tanh of that stays f32 (it is not rounded before the energy
product nor in the backward's 1 - th^2 and dv); align is rounded to bf16
for the context, dctx for dal and dener for dv; dq is the f32 sum of the
unrounded dtarg; dvals is align * dctx in f32; the bf16 outputs are each
rounded once. The port rounds at exactly these places.

Tolerances, with their reasons:
  * kernel level: ctx and align (f32) within atol 1e-6 (f32 sums taken in
    another order, XLA's f32 tanh against PyTorch's; measured 2.7e-7); the
    bf16 gradients within 1 bf16 ulp of the larger magnitude plus 1e-5
    (measured: equal to the reference's).
  * ``Attention.step``: ctx and align within atol 1e-5 (measured 7.5e-8);
    the gradients of the query, the previous alignment and every parameter
    within 2^-7 of their largest magnitude: the JAX package rounds each
    parameter's gradient to bf16, the port leaves it f32 (measured: query
    and alignment equal, parameters 3.3e-3 of max, w_k).
  * the train step: loss within rel 1e-4 (measured 1.4e-6), every gradient
    within 3e-2 of its max magnitude (``test_torch_port_train_amp.py``'s
    bound and reasons; measured 1.7e-2, the VGG's k3).
  * greedy ids identical.
"""
import copy
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.decode.greedy import att_greedy as jax_att_greedy
from end_to_end_asr_pytorch_tpu.models import attention as jax_attention_mod
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.models.attention import Attention as JaxAttention
from end_to_end_asr_pytorch_tpu.ops.pallas import att_train_kernel as jk7
from end_to_end_asr_pytorch_tpu_torch import main as port_main
from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
from end_to_end_asr_pytorch_tpu_torch.decode.greedy import att_greedy
from end_to_end_asr_pytorch_tpu_torch.models import attention as port_attention
from end_to_end_asr_pytorch_tpu_torch.models.attention import Attention
from end_to_end_asr_pytorch_tpu_torch.ops.amp import bf16_rounded_copy
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import att_train_kernel as tk
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    _to_port_layout, asr_from_arrays, load_arrays, port_name)
from tests.test_torch_port_train_amp import (ATT_SCALE, TEXT, TEXT_LEN,
                                             _jax_amp_step, _solver,
                                             jax_kernels)
from tests.torch_port_fixtures import ASR_CFG, VOCAB, jax_arrays, to_np, waves

torch.set_num_threads(1)
BF = torch.bfloat16
D, VD = 8, 6
# B, T, d, vdim, tau: B=8 is the TPU kernel's 8-row block, B=3 an odd batch
SHAPES = {"B4_T13": (4, 13, 8, 6, 0.5), "B3_T11": (3, 11, 16, 12, 0.7),
          "B8_T9": (8, 9, 16, 8, 1.0)}
GRADS = ("dq", "dkeys", "df", "dv", "dvals")


class _OnTpu:
    """The ``jax`` module as the JAX attention module sees it, with a
    backend that is not the CPU: its ``step`` then takes the K7 route."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture()
def jax_k7(monkeypatch):
    """The JAX package's training attention step through its K7 kernel in
    interpret mode (set from the test side only)."""
    k7 = jk7.loc_att_train
    monkeypatch.setattr(jax_attention_mod, "jax", _OnTpu())
    monkeypatch.setattr(jk7, "loc_att_train",
                        lambda q, keys, f, v, vals, enc_len, tau,
                        interpret=False: k7(q, keys, f, v, vals, enc_len,
                                            tau, True))


def _lens(B, T, rng):
    """Ragged lengths: row 0 full, row 1 of length 1."""
    lens = rng.randint(2, T, size=B).astype(np.int32)
    lens[0], lens[1] = T, 1
    return lens


def _k7_inputs(shape, seed):
    """bf16 q, keys, f, v, vals (as f32 arrays of bf16 values), lengths and
    the f32 cotangents dctx, dalign."""
    B, T, d, vdim, _ = SHAPES[shape]
    rng = np.random.RandomState(seed)
    r = lambda *s, sc=0.7: (rng.randn(*s) * sc).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(BF).float().numpy()
    arrays = tuple(bf(a) for a in (r(B, d), r(B, T, d), r(B, T, d), r(d),
                                   r(B, T, vdim)))
    return arrays, _lens(B, T, rng), r(B, vdim, sc=1.0), r(B, T, sc=1.0)


def _tb(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(BF) for a in arrays]


def _jb(arrays):
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def assert_within_ulp(got, ref):
    """|got - ref| <= 2^-7 max(|got|, |ref|) + 1e-5 (1 bf16 ulp)."""
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    d = np.abs(g - r)
    bad = d > np.maximum(np.abs(g), np.abs(r)) * 2.0 ** -7 + 1e-5
    assert not bad.any(), (d[bad].max(), int(bad.sum()))


def assert_within_max(got, ref, frac, what=""):
    g, r = _f32(got), _f32(ref)
    err = np.abs(g - r).max() / np.abs(r).max()
    assert err <= frac, (what, err)


def _jax_k7(shape, seed):
    arrays, lens, dctx, dalign = _k7_inputs(shape, seed)
    tau = SHAPES[shape][-1]
    (ctx, align), vjp = jax.vjp(
        lambda *a: jk7.loc_att_train(*a, jnp.asarray(lens), tau, True),
        *_jb(arrays))
    grads = vjp((jnp.asarray(dctx), jnp.asarray(dalign)))
    return (ctx, align), grads


# ------------------------------------------------------------ kernel level
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k7_bf16_forward_matches_pallas_interpret(shape):
    """The bf16 forward (the wrapper on CPU tensors, its plain version and
    LocAttTrain) against the TPU kernel on bf16 inputs: f32 ctx and align
    within atol 1e-6; no launch on the CPU."""
    arrays, lens, _, _ = _k7_inputs(shape, 2)
    tau = SHAPES[shape][-1]
    (rctx, ral), _ = _jax_k7(shape, 2)
    for fn in (tk.loc_att_fwd_bf16, tk.loc_att_fwd_plain,
               lambda *a: tk.LocAttTrain.apply(*a, False)):
        ctx, al = fn(*_tb(arrays), torch.from_numpy(lens), tau)
        assert ctx.dtype == al.dtype == torch.float32
        np.testing.assert_allclose(to_np(ctx), np.asarray(rctx), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(to_np(al), np.asarray(ral), rtol=0,
                                   atol=1e-6)
    assert tk.loc_att_fwd_bf16.launches == 0


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k7_bf16_backward_matches_pallas_vjp(shape):
    """The bf16 backward on the CPU (the wrapper, and LocAttTrain's hand
    backward under autograd) against jax.vjp of the TPU kernel on bf16
    inputs: all five gradients bf16, each within 1 bf16 ulp + 1e-5."""
    arrays, lens, dctx, dalign = _k7_inputs(shape, 3)
    tau = SHAPES[shape][-1]
    _, ref = _jax_k7(shape, 3)
    assert all(r.dtype == jnp.bfloat16 for r in ref)
    ins = _tb(arrays)
    el = torch.from_numpy(lens)
    _, al = tk.loc_att_fwd_bf16(*ins, el, tau)
    dq, dtarg, dvals, dv = tk.loc_att_bwd_bf16(
        *ins, el, al, torch.from_numpy(dctx), torch.from_numpy(dalign), tau)
    assert all(t.dtype == BF for t in (dq, dtarg, dvals, dv))
    for name, g, r in zip(GRADS, (dq, dtarg, dtarg, dv, dvals), ref):
        assert_within_ulp(g, r)
    xs = [t.requires_grad_(True) for t in _tb(arrays)]
    ctx, al = tk.LocAttTrain.apply(*xs, el, tau, False)
    (ctx * torch.from_numpy(dctx)).sum().add(
        (al * torch.from_numpy(dalign)).sum()).backward()
    for name, x, r in zip(GRADS, xs, ref):
        assert x.grad.dtype == BF, name
        assert_within_ulp(x.grad, r)
        assert bool((x.grad != 0).any()), name
    assert tk.loc_att_bwd_bf16.launches == 0


def test_k7_bf16_masked_frames_get_zero_dtarg_and_dvals():
    """Frames past each length get no gradient; the length-1 row puts all
    its weight on frame 0, so its energies get none."""
    arrays, lens, dctx, dalign = _k7_inputs("B4_T13", 5)
    ins, el = _tb(arrays), torch.from_numpy(lens)
    _, al = tk.loc_att_fwd_plain(*ins, el, 0.5)
    _, dtarg, dvals, _ = (_f32(x) for x in tk.loc_att_bwd_bf16(
        *ins, el, al, torch.from_numpy(dctx), torch.from_numpy(dalign), 0.5))
    for b, n in enumerate(lens):
        assert np.all(dtarg[b, n:] == 0.0) and np.all(dvals[b, n:] == 0.0)
    assert np.all(dtarg[1] == 0.0)
    assert np.any(dvals[1, 0] != 0.0)


def _strided(t):
    """The same values in a non-contiguous (transposed) layout."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


SPOIL = {"f32_keys": (1, lambda t: t.float(), "bfloat16"),
         "f32_v": (3, lambda t: t.float(), "bfloat16"),
         "strided_vals": (4, _strided, "contiguous"),
         "int64_len": (5, lambda t: t.long(), "int32")}


@pytest.mark.parametrize("bad", sorted(SPOIL))
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_bf16_wrappers_reject_other_inputs(which, bad):
    """The bf16 wrappers take bf16 q, keys, f, v, vals and int32 lengths
    only, and raise on anything else, rather than pass it to a plain
    version; the f32 wrappers keep rejecting bf16."""
    arrays, lens, dctx, dalign = _k7_inputs("B3_T11", 6)
    args = [*_tb(arrays), torch.from_numpy(lens)]
    i, spoil, match = SPOIL[bad]
    args[i] = spoil(args[i])
    _, al = tk.loc_att_fwd_plain(*_tb(arrays), torch.from_numpy(lens), 0.5)
    cts = (al, torch.from_numpy(dctx), torch.from_numpy(dalign))
    with pytest.raises(ValueError, match=match):
        if which == "fwd":
            tk.loc_att_fwd_bf16(*args, 0.5)
        else:
            tk.loc_att_bwd_bf16(*args, *cts, 0.5)
    good = [*_tb(arrays), torch.from_numpy(lens)]
    with pytest.raises(ValueError, match="float32"):
        if which == "fwd":
            tk.loc_att_fwd_fused(*good, 0.5)
        else:
            tk.loc_att_bwd_fused(*good, *cts, 0.5)


@pytest.mark.parametrize("ct", ["align", "dctx", "dalign"])
def test_bf16_backward_takes_f32_cotangents_only(ct):
    """align, dctx and dalign stay f32 in the bf16 backward, as the TPU
    kernel takes them; bf16 ones raise."""
    arrays, lens, dctx, dalign = _k7_inputs("B4_T13", 7)
    ins, el = _tb(arrays), torch.from_numpy(lens)
    _, al = tk.loc_att_fwd_plain(*ins, el, 0.5)
    cts = {"align": al, "dctx": torch.from_numpy(dctx),
           "dalign": torch.from_numpy(dalign)}
    cts[ct] = cts[ct].to(BF)
    with pytest.raises(ValueError, match=ct):
        tk.loc_att_bwd_bf16(*ins, el, cts["align"], cts["dctx"],
                            cts["dalign"], 0.5)


# ------------------------------------------------------------- model level
LOC_CFG = dict(ASR_CFG["attention"], dim=D, loc_kernel_num=3)
Dq, Dk = 12, 10


@pytest.mark.parametrize("tau", [0.5, 1.0])
def test_amp_step_with_use_pallas_train_matches_jax(tau, jax_k7, monkeypatch):
    """Attention.step on a bf16 cache and query, weights rounded to bf16,
    under use_pallas_train (LocAttTrain on bf16 inputs) against the JAX
    package's step on bf16 weights through its interpret K7: ctx and align,
    and the gradients of the query, the previous alignment and every
    parameter."""
    cfg = dict(LOC_CFG, temperature=tau, use_pallas_train=True)
    ja = JaxAttention(cfg, Dq, Dk)
    jp = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16).astype(jnp.float32),
        ja.init(jax.random.PRNGKey(3)))
    jp = jp._replace(w_q=jp.w_q * ATT_SCALE, w_k=jp.w_k * ATT_SCALE)
    jp = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16).astype(jnp.float32), jp)
    B, T = 4, 13
    rng = np.random.RandomState(8)
    bf = lambda a: torch.from_numpy(a).to(BF).float().numpy()
    enc = bf(rng.randn(B, T, Dk).astype(np.float32))
    elen = _lens(B, T, rng)
    q = bf(rng.randn(B, Dq).astype(np.float32))
    prev = rng.uniform(0.0, 0.3, size=(B, 1, T)).astype(np.float32)
    dctx = rng.randn(B, D).astype(np.float32)
    dalign = rng.randn(B, 1, T).astype(np.float32)

    def jstep(p, query, pa):
        pb = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), p)
        c = ja.precompute(pb, jnp.asarray(enc).astype(jnp.bfloat16),
                          jnp.asarray(elen), amp=True)
        return ja.step(pb, c, query, pa)

    called = []
    k7 = jk7.loc_att_train
    monkeypatch.setattr(jk7, "loc_att_train",
                        lambda *a, **k: called.append(1) or k7(*a, **k))
    (rctx, ral), vjp = jax.vjp(jstep, jp, jnp.asarray(q).astype(jnp.bfloat16),
                               jnp.asarray(prev))
    assert called
    gp, gq, gprev = vjp((jnp.asarray(dctx), jnp.asarray(dalign)))

    pa = load_arrays(Attention(cfg, Dq, Dk, device="cpu"), jax_arrays(jp))
    pa.requires_grad_(True)
    seen = []
    apply = tk.LocAttTrain.apply
    monkeypatch.setattr(port_attention, "LocAttTrain", type("Spy", (), {
        "apply": staticmethod(lambda *a: seen.append(a[0].dtype)
                              or apply(*a))}))
    tq = torch.from_numpy(q).to(BF).requires_grad_(True)
    tprev = torch.from_numpy(prev).requires_grad_(True)
    pc = pa.precompute(torch.from_numpy(enc).to(BF), torch.from_numpy(elen),
                       amp=True)
    ctx, al = pa.step(pc, tq, tprev)
    assert seen == [BF]
    np.testing.assert_allclose(to_np(ctx), np.asarray(rctx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(al), np.asarray(ral), rtol=0, atol=1e-5)
    ((ctx * torch.from_numpy(dctx)).sum()
     + (al * torch.from_numpy(dalign)).sum()).backward()
    assert tq.grad.dtype == BF
    assert_within_max(tq.grad, gq, 2.0 ** -7, "query")
    assert_within_max(tprev.grad, gprev, 2.0 ** -7, "prev_align")
    ref = jax_arrays(gp)
    got = {n: p.grad for n, p in pa.named_parameters()}
    assert len(got) == len(ref) == 7
    for path, g in ref.items():
        name = port_name(path)
        assert_within_max(got[name], _to_port_layout(name, g), 2.0 ** -7, name)


def _with_k7(cfg=ASR_CFG):
    cfg = copy.deepcopy(cfg)
    cfg["attention"]["use_pallas_train"] = True
    return cfg


def test_amp_train_step_with_use_pallas_train_matches_jax(
        tmp_path, jax_kernels, jax_k7, monkeypatch):
    """One amp step of ``Solver.train_step`` with use_pallas_train (K7's
    bf16 route at every label step) against the JAX solver's amp loss and
    gradients with its K7 in interpret mode: loss within rel 1e-4, every
    gradient within 3e-2 of its max magnitude."""
    cfg = _with_k7()
    jp, ref_loss, ref_grads = _jax_amp_step(cfg, 3, ATT_SCALE)
    solver = _solver(tmp_path, cfg)
    src = asr_from_arrays(40, VOCAB, cfg, jax_arrays(jp), device="cpu")
    solver.model.load_state_dict(src.state_dict())
    seen = []
    apply = tk.LocAttTrain.apply
    monkeypatch.setattr(port_attention, "LocAttTrain", type("Spy", (), {
        "apply": staticmethod(lambda *a: seen.append(a[0].dtype)
                              or apply(*a))}))
    w, wl = waves(3)
    m = solver.train_step(torch.from_numpy(w), torch.from_numpy(wl),
                          torch.from_numpy(TEXT).long(),
                          torch.from_numpy(TEXT_LEN).long())
    assert seen == [BF] * TEXT.shape[1]
    loss = float(m["loss"])
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss), (loss, ref_loss)
    got = {n: p.grad for n, p in solver.model.named_parameters()}
    assert len(got) == len(ref_grads)
    for path, g in ref_grads.items():
        name = port_name(path)
        assert got[name].dtype == torch.float32, name
        ref = _to_port_layout(name, g)
        err = np.abs(to_np(got[name]) - ref).max() / np.abs(ref).max()
        assert err <= 3e-2, (name, err)


@pytest.mark.parametrize("seed", [0, 1])
def test_amp_att_greedy_with_use_pallas_train_matches_jax(seed, jax_k7):
    """Greedy decoding of a bf16 encoding with weights rounded to bf16
    (amp) through the bf16 route of use_pallas_train: the JAX package's
    ids."""
    cfg = _with_k7()
    jm = JaxASR(40, VOCAB, cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    jp = jp._replace(attention=jp.attention._replace(
        w_q=jp.attention.w_q * ATT_SCALE, w_k=jp.attention.w_k * ATT_SCALE))
    jpb = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    rng = np.random.RandomState(20 + seed)
    enc = torch.from_numpy(rng.randn(3, 9, jm.encoder.out_dim).astype(
        np.float32)).to(BF)
    elen = np.asarray([9, 1, 4], np.int32)
    ref = jax_att_greedy(jm, jpb, jnp.asarray(_f32(enc)).astype(jnp.bfloat16),
                         jnp.asarray(elen), 7)
    pm = bf16_rounded_copy(asr_from_arrays(40, VOCAB, cfg, jax_arrays(jp),
                                           device="cpu"))
    with torch.no_grad():
        got = att_greedy(pm, enc, torch.from_numpy(elen), 7)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


def test_main_amp_with_use_pallas_train_trains_on_cpu(tmp_path, monkeypatch):
    """``main --amp --cpu`` with attention.use_pallas_train on
    config/synthetic/las.yaml (cut to small widths and two steps): every
    training label step takes LocAttTrain on bf16 inputs, validation (f32,
    as the JAX solver validates) on f32 ones; finite losses and a
    checkpoint."""
    root = generate_corpus(str(tmp_path / "synth"), n_train=6, n_dev=3,
                           n_test=0, seed=0)
    cfg = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    cfg["data"]["corpus"].update(path=str(root), batch_size=3)
    cfg["data"]["text"]["vocab_file"] = f"{root}/vocab.txt"
    cfg["model"]["encoder"]["dim"] = [16, 16]
    cfg["model"]["attention"].update(dim=8, loc_kernel_size=6,
                                     loc_kernel_num=2, use_pallas_train=True)
    cfg["model"]["decoder"]["dim"] = 16
    cfg["hparas"].update(max_step=2, valid_step=2, PROGRESS_STEP=1)
    path = tmp_path / "las.yaml"
    path.write_text(yaml.safe_dump(cfg))
    seen = []
    apply = tk.LocAttTrain.apply
    monkeypatch.setattr(port_attention, "LocAttTrain", type("Spy", (), {
        "apply": staticmethod(lambda *a: seen.append(a[0].dtype)
                              or apply(*a))}))
    port_main.main(["--config", str(path), "--cpu", "--amp", "--no-msg",
                    "--logdir", str(tmp_path / "log"), "--ckpdir",
                    str(tmp_path / "ckpt")])
    assert set(seen) == {BF, torch.float32}
    log = [json.loads(ln) for ln in
           (tmp_path / "log" / "las_sd0" / "log.jsonl").read_text()
           .splitlines()]
    losses = [v for e in log if e["name"] == "loss"
              for v in e["value"].values()]
    assert len(losses) >= 4 and all(math.isfinite(v) for v in losses)
    assert (tmp_path / "ckpt" / "las_sd0" / "latest.pth").exists()
