"""Amp (bf16) training of the port against the JAX package on the CPU:
``hparas.amp: True`` / ``--amp``.

Held here:
  * the bf16 training variants of the recurrent kernels, their plain
    versions against the JAX package's TPU kernels in interpret mode: K2
    and K4 with residuals (``_run_fwd`` on bf16 x_proj: ys and every
    residual in bf16, f32 carries), K2b and K4b (``_run_bwd`` on the same
    bf16 residuals: dxp in bf16, dW_hh and db_hh in f32), both directions,
    ragged masks;
  * the scans under autograd on weights rounded to bf16 (``ops/rnn.py``):
    ys and dx in bf16, the weights' gradients, against ``jax.vjp`` on bf16
    weights;
  * the zero-padding of widths that are not a multiple of 4 (H=6, 10): the
    plain versions on padded tensors, sliced back, equal the unpadded runs;
  * one whole amp train step of the port's solver (LSTM and GRU models)
    against the JAX solver's amp ``loss_fn`` under ``value_and_grad``, on
    the same weights;
  * ``main --amp --cpu`` on ``config/synthetic/las.yaml``: it trains, keeps
    f32 parameters and optimizer state, and its ``latest.pth`` loads in the
    JAX package.

The JAX side runs its LSTM and GRU scans through its TPU kernels in
interpret mode (``USE_FUSED_SCAN`` and an ``interpret=True`` wrapper, set
from the test side only): on the CPU it would otherwise take its
``lax.scan``, whose carries are rounded to bf16 each step, while the TPU
kernels and the port keep f32 carries.

Tolerances, with their reasons:
  * bf16 outputs of the kernels (ys, residuals, dxp): within 1 bf16 ulp of
    the larger magnitude (2^-7 of it) plus 1e-5: the f32 values before
    rounding differ by f32 sums taken in another order;
  * dW_hh and db_hh: within 2^-7 of their largest magnitude (sums over
    T B products of bf16 values, some of which differ by one ulp);
  * the train step: loss within rel 1e-2 and every gradient within 3e-2 of
    its largest magnitude. The port rounds the activations where the JAX
    package does: a conv's bias is added after the bf16 conv, and tanh's
    gradient is rounded as JAX's autodiff of tanh rounds it
    (``ops/amp.tanh``). The JAX side sums the cotangent of a broadcast bf16
    operand in f32, as XLA on the TPU does (``jax_kernels``). What is left:
    one-ulp differences of f32 sums taken in another order, and a weight's
    gradient, which the port sums over its uses in f32 and rounds once,
    where JAX rounds each use and sums in bf16. Measured: loss rel 9.7e-7
    (LSTM) and 4.1e-6 (GRU); worst gradient 1.9e-2 (LSTM, the VGG's k3)
    and 2.5e-2 (GRU, the VGG's k1) of its max.
  * the train step's attention weights: w_q and w_k are scaled by 12
    (``ATT_SCALE``), so that the tanh arguments are of order 1, as in a
    trained attention. At the random init they are ~0.1, and the softmax
    makes the terms of the query's gradient cancel to a few percent of
    their size, so bf16 rounding dominates the gradients of w_q and the
    attention bias, in the JAX package's own amp step as in the port's.
"""
import copy
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
from jax._src.lax import lax
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.ops import rnn as jrnn
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from end_to_end_asr_pytorch_tpu.ops.pallas import gru_kernel as jgk
from end_to_end_asr_pytorch_tpu.ops.pallas import lstm_kernel as jlk
from end_to_end_asr_pytorch_tpu.solvers.train_asr import masked_ce as jax_masked_ce
from end_to_end_asr_pytorch_tpu.utils.checkpoint import load_checkpoint
from end_to_end_asr_pytorch_tpu.utils.text import load_text_encoder
from end_to_end_asr_pytorch_tpu_torch import main as port_main
from end_to_end_asr_pytorch_tpu_torch.ops import rnn
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import gru_kernel as gk
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel as lk
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import scan_tc
from end_to_end_asr_pytorch_tpu_torch.solvers.train_asr import Solver
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    _to_port_layout, asr_from_arrays, port_name)
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, VOCAB, jax_arrays,
                                       to_np, waves)

torch.set_num_threads(1)
BF = torch.bfloat16
GRU_CFG = copy.deepcopy(ASR_CFG)
GRU_CFG["encoder"]["module"] = "GRU"
GRU_CFG["decoder"]["module"] = "GRU"
TEXT = np.asarray([[3, 4, 4, 5, 6, 2, 0, 0], [7, 8, 9, 7, 0, 0, 0, 0],
                   [3, 5, 7, 9, 11, 3, 5, 7]], np.int32)
TEXT_LEN = np.asarray([6, 4, 8], np.int32)
# the kernels' ragged masks: a full row, a shorter one, one of 2 steps
LENS = (None, 7, 2)
# the train step's scale of the attention's w_q and w_k (module docstring)
ATT_SCALE = 12.0


@pytest.fixture()
def jax_kernels(monkeypatch):
    """The JAX package's LSTM and GRU scans through their TPU kernels in
    interpret mode (carries stay f32), and the cotangent of a broadcast
    summed in f32 when it is bf16, as XLA on the TPU sums it (XLA on the
    CPU adds a bf16 reduction's terms in bf16, one by one: the gradient of
    a bf16 bias then drifts by tens of percent); from the test side
    only."""
    unbroadcast = lax._unbroadcast

    def f32_sum(aval, ct):
        if ct.dtype != jnp.bfloat16:
            return unbroadcast(aval, ct)
        return unbroadcast(aval, ct.astype(jnp.float32)).astype(jnp.bfloat16)

    monkeypatch.setattr(lax, "_unbroadcast", f32_sum)
    monkeypatch.setattr(jrnn, "USE_FUSED_SCAN", True)
    lstm, gru = jlk.lstm_scan_fused, jgk.gru_scan_fused
    monkeypatch.setattr(jlk, "lstm_scan_fused",
                        lambda x, w, m, r=False, interpret=False:
                        lstm(x, w, m, r, True))
    monkeypatch.setattr(jgk, "gru_scan_fused",
                        lambda x, w, b, m, r=False, interpret=False:
                        gru(x, w, b, m, r, True))


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


def assert_within_max(got, ref, frac):
    g, r = _f32(got), _f32(ref)
    err = np.abs(g - r).max() / np.abs(r).max()
    assert err <= frac, err


def _case(seed, T, H, n_gates, B=3):
    """bf16 x_proj, a bf16-valued f32 W_hh (amp rounds the weights), a bf16
    upstream gradient, a ragged mask and, for the GRU, a b_hh."""
    rng = np.random.RandomState(seed)
    xp = torch.from_numpy((rng.randn(T, B, n_gates * H) * 0.8).astype(
        np.float32)).to(BF)
    w = torch.from_numpy(rng.uniform(-0.3, 0.3, (H, n_gates * H)).astype(
        np.float32)).to(BF).float()
    b = torch.from_numpy((rng.randn(n_gates * H) * 0.3).astype(
        np.float32)).to(BF).float()
    dys = torch.from_numpy(rng.randn(T, B, H).astype(np.float32)).to(BF)
    lens = np.asarray([T if n is None else n for n in LENS][:B])
    mask = torch.from_numpy(np.arange(T)[:, None] < lens[None, :])
    return xp, w, b, dys, mask


def _j(t):
    return jnp.asarray(_f32(t)).astype(
        jnp.bfloat16 if t.dtype == BF else jnp.float32) if isinstance(
        t, torch.Tensor) and t.is_floating_point() else jnp.asarray(to_np(t))


def _t(a):
    """A JAX bf16 / f32 array as a torch tensor of the same dtype."""
    a = jnp.asarray(a)
    out = torch.from_numpy(np.asarray(a.astype(jnp.float32)).copy())
    return out.to(BF) if a.dtype == jnp.bfloat16 else out


def _flip(reverse):
    return (lambda a: a[::-1]) if reverse else (lambda a: a)


# ------------------------------------------------------------- K2 / K2b
@pytest.mark.parametrize("T", [12, 9])
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_bf16_residuals_match_the_tpu_kernel(T, reverse):
    """K2's bf16 training variant (its plain version on the CPU) against
    ``_run_fwd`` in interpret mode on bf16 x_proj: ys, cs and gates, all
    bf16, each within 1 bf16 ulp."""
    xp, w, _, _, mask = _case(20 + T + reverse, T, 16, 4)
    n0 = lk.lstm_train_bf16.launches
    got = lk.lstm_scan_fused(xp, w, mask, reverse, residuals=True)
    assert lk.lstm_train_bf16.launches == n0 == 0
    _, (_, _, _, ys, cs, gates) = jlk._fused_fwd(_j(xp), _j(w), _j(mask),
                                                 reverse, True)
    f = _flip(reverse)
    for g, r in zip(got, (f(ys), f(cs), f(gates))):
        assert g.dtype == BF and r.dtype == jnp.bfloat16
        assert_within_ulp(g, r)
    assert np.all(_f32(got[0])[~to_np(mask)] == 0.0)


@pytest.mark.parametrize("T", [12, 9])
@pytest.mark.parametrize("reverse", [False, True])
def test_k2b_bf16_matches_the_tpu_kernel_vjp(T, reverse):
    """K2b's bf16 variant on the TPU kernel's own bf16 residuals against
    its VJP (``_fused_bwd``, interpret mode): dxp bf16 within 1 ulp, dW_hh
    within 2^-7 of its max magnitude."""
    xp, w, _, dys, mask = _case(30 + T + reverse, T, 16, 4)
    out, res = jlk._fused_fwd(_j(xp), _j(w), _j(mask), reverse, True)
    rdxp, rdw, _ = jlk._fused_bwd(reverse, True, res, _j(dys))
    f = _flip(reverse)
    ys, cs, gates = (_t(f(a)) for a in res[3:])
    dxp, dw = lk.lstm_bwd_fused(gates, cs, ys, mask, w, dys, reverse)
    assert (dxp.dtype, dw.dtype) == (BF, torch.float32)
    assert rdxp.dtype == jnp.bfloat16
    assert_within_ulp(dxp, rdxp)
    assert_within_max(dw, rdw, 2.0 ** -7)


# ------------------------------------------------------------- K4 / K4b
@pytest.mark.parametrize("T", [12, 9])
@pytest.mark.parametrize("reverse", [False, True])
def test_k4_bf16_residuals_match_the_tpu_kernel(T, reverse):
    """K4's bf16 training variant against ``_run_fwd`` in interpret mode:
    ys, gates and hp_n, all bf16, each within 1 bf16 ulp."""
    xp, w, b, _, mask = _case(40 + T + reverse, T, 16, 3)
    n0 = gk.gru_train_bf16.launches
    got = gk.gru_scan_fused(xp, w, b, mask, reverse, residuals=True)
    assert gk.gru_train_bf16.launches == n0 == 0
    _, (_, _, ys, gates, hpn) = jgk._g_fwd(_j(xp), _j(w), _j(b), _j(mask),
                                           reverse, True)
    f = _flip(reverse)
    for g, r in zip(got, (f(ys), f(gates), f(hpn))):
        assert g.dtype == BF and r.dtype == jnp.bfloat16
        assert_within_ulp(g, r)


@pytest.mark.parametrize("T", [12, 9])
@pytest.mark.parametrize("reverse", [False, True])
def test_k4b_bf16_matches_the_tpu_kernel_vjp(T, reverse):
    """K4b's bf16 variant on the TPU kernel's bf16 residuals against its
    VJP (``_g_bwd``, interpret mode): dxp bf16 within 1 ulp (h_prev the
    bf16 ys), dW_hh and db_hh within 2^-7 of their max magnitude."""
    xp, w, b, dys, mask = _case(50 + T + reverse, T, 16, 3)
    out, res = jgk._g_fwd(_j(xp), _j(w), _j(b), _j(mask), reverse, True)
    rdxp, rdw, rdb, _ = jgk._g_bwd(reverse, True, res, _j(dys))
    f = _flip(reverse)
    ys, gates, hpn = (_t(f(a)) for a in res[2:])
    dxp, dw, db = gk.gru_bwd_fused(gates, hpn, ys, mask, w, dys, reverse)
    assert (dxp.dtype, dw.dtype, db.dtype) == (BF, torch.float32,
                                               torch.float32)
    assert_within_ulp(dxp, rdxp)
    assert_within_max(dw, rdw, 2.0 ** -7)
    assert_within_max(db, rdb, 2.0 ** -7)


# ------------------------------------------------- the scans under autograd
@pytest.mark.parametrize("module", ["lstm", "gru"])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_gradients_on_bf16_weights_match_jax(module, reverse,
                                                  jax_kernels):
    """rnn.lstm_scan / gru_scan on weights rounded to bf16 (as amp training
    hands them over, in f32) and a bf16 input under autograd (LSTMScan /
    GRUScan with the bf16 training variants' plain versions) against
    ``jax.vjp`` of the JAX package's scan on bf16 weights through its
    interpret kernels: ys and dx in bf16, and every weight's gradient."""
    T, B, D, H = 10, 3, 12, 16
    init = jrnn.init_lstm if module == "lstm" else jrnn.init_gru
    jw = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                init(jax.random.PRNGKey(7 + reverse), D, H))
    rng = np.random.RandomState(7 + reverse)
    x = rng.randn(T, B, D).astype(np.float32)
    dy = rng.randn(T, B, H).astype(np.float32)
    mask = np.arange(T)[:, None] < np.array([T, 7, 2])[None, :]
    jscan = jrnn.lstm_scan if module == "lstm" else jrnn.gru_scan
    ys, vjp = jax.vjp(lambda w, xx: jscan(w, xx, jnp.asarray(mask),
                                          reverse=reverse),
                      jw, jnp.asarray(x).astype(jnp.bfloat16))
    rw, rx = vjp(jnp.asarray(dy).astype(jnp.bfloat16))
    pw = rnn.cell_weights(module, D, H, device="cpu")
    for name, p in pw.named_parameters():
        p.data = _t(getattr(jw, name)).float()
        p.requires_grad_(True)
    px = torch.from_numpy(x).to(BF).requires_grad_(True)
    pscan = rnn.lstm_scan if module == "lstm" else rnn.gru_scan
    got = pscan(pw, px, torch.from_numpy(mask), reverse=reverse)
    assert got.dtype == BF
    assert_within_ulp(got, ys)
    got.backward(torch.from_numpy(dy).to(BF))
    assert px.grad.dtype == BF
    assert_within_max(px.grad, rx, 2.0 ** -7)
    for name, p in pw.named_parameters():
        assert_within_max(p.grad, getattr(rw, name), 2.0 ** -7)


# ---------------------------------------------------------- widths % 4
@pytest.mark.parametrize("H", [6, 10])
@pytest.mark.parametrize("module", ["lstm", "gru"])
def test_padded_units_stay_zero_and_change_nothing(H, module):
    """The wrappers' zero-padding of H up to a multiple of 4, run through
    the plain versions: padded x_proj gate columns, W_hh rows and columns
    (and b_hh) give padded units that stay exactly 0 and real units equal
    to the unpadded run, forward with residuals and backward."""
    T, reverse = 9, True
    G = 4 if module == "lstm" else 3
    Hp = scan_tc.padded(H)
    assert Hp % 4 == 0 and Hp > H
    rng = np.random.RandomState(H)
    xp = torch.from_numpy(rng.randn(T, 3, G * H).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.4, 0.4, (H, G * H)).astype(np.float32))
    b = torch.from_numpy(rng.randn(G * H).astype(np.float32) * 0.3)
    dys = torch.from_numpy(rng.randn(T, 3, H).astype(np.float32))
    mask = torch.from_numpy(np.arange(T)[:, None] < np.array([T, 5, 1]))
    pu, un = scan_tc.pad_units, scan_tc.unpad_units
    xpp, wp, dyp = pu(xp, G, Hp), scan_tc.pad_w(w, G, Hp), pu(dys, 1, Hp)
    assert wp.shape == (Hp, G * Hp)
    if module == "lstm":
        ref = lk.lstm_scan_fwd_plain(xp, w, mask, reverse)
        pad = lk.lstm_scan_fwd_plain(xpp, wp, mask, reverse)
        widths = (1, 1, G)
        rdxp, rdw = lk.lstm_scan_bwd_plain(*ref[::-1][:2], ref[0], mask, w,
                                           dys, reverse)
        pdxp, _ = lk.lstm_scan_bwd_plain(*pad[::-1][:2], pad[0], mask, wp,
                                         dyp, reverse)
    else:
        bp = pu(b, G, Hp)
        ref = gk.gru_scan_fwd_plain(xp, w, b, mask, reverse)
        pad = gk.gru_scan_fwd_plain(xpp, wp, bp, mask, reverse)
        widths = (1, G, 1)
        rdxp, rdw, _ = gk.gru_scan_bwd_plain(ref[1], ref[2], ref[0], mask, w,
                                             dys, reverse)
        pdxp, _, _ = gk.gru_scan_bwd_plain(pad[1], pad[2], pad[0], mask, wp,
                                           dyp, reverse)
    assert float(pad[0][..., H:].abs().max()) == 0.0
    for r, p, g in zip(ref, pad, widths):
        torch.testing.assert_close(un(p, g, H), r, rtol=0, atol=1e-6)
    torch.testing.assert_close(un(pdxp, G, H), rdxp, rtol=0, atol=1e-6)
    assert float(pdxp.reshape(T, 3, G, Hp)[..., H:].abs().max()) == 0.0


# ------------------------------------------------------ one train step
def _solver(tmp_path, cfg, amp_flag=False, hparas_amp=True):
    """The port's training solver (no corpus) with ``cfg`` and amp on, as
    ``main`` sets it up."""
    config = {"data": {"corpus": {"name": "none"}, "audio": AUDIO_CFG,
                       "text": {"mode": "character"}},
              "model": cfg,
              "hparas": {"optimizer": "Adadelta", "lr": 1.0,
                         "tf_start": 1.0, "tf_end": 1.0, "amp": hparas_amp}}
    paras = SimpleNamespace(config="amp.yaml", name=None, seed=0,
                            logdir=str(tmp_path / "log"),
                            ckpdir=str(tmp_path / "ckpt"), load=None,
                            njobs=0, no_msg=True, cpu=True, amp=amp_flag)
    solver = Solver(config, paras)
    solver.feat_dim, solver.vocab_size = 40, VOCAB
    solver.set_model()
    return solver


def _jax_amp_step(cfg, seed, att_scale=1.0):
    """The JAX solver's amp loss_fn (_cast_bf16 of every f32 parameter,
    bf16 features, f32 outputs for the losses) under value_and_grad, at
    tf 1.0 with no dropout; the attention's w_q and w_k scaled by
    ``att_scale``."""
    jm = JaxASR(40, VOCAB, cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    att = jp.attention._replace(w_q=jp.attention.w_q * att_scale,
                                w_k=jp.attention.w_k * att_scale)
    jp = jp._replace(attention=att)
    w, wl = waves(seed)
    feat, flen = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    text, text_len = jnp.asarray(TEXT), jnp.asarray(TEXT_LEN)

    def loss_fn(p):
        pb = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
            p)
        ctc_out, enc_len, att_out, _, _ = jm.forward(
            pb, feat.astype(jnp.bfloat16), flen, TEXT.shape[1], 1.0,
            teacher=text, train=True, rng=jax.random.PRNGKey(7))
        ctc_out, att_out = (ctc_out.astype(jnp.float32),
                            att_out.astype(jnp.float32))
        valid = text_len > 0
        nll = jax_ctc_loss(ctc_out, enc_len, text, text_len)
        per = nll / jnp.maximum(text_len, 1)
        ctc_l = jnp.sum(jnp.where(valid & (nll < 1e29), per, 0.0)) / \
            jnp.maximum(jnp.sum(valid), 1)
        return 0.5 * ctc_l + 0.5 * jax_masked_ce(att_out, text)

    loss, grads = jax.value_and_grad(loss_fn)(jp)
    return jp, float(loss), jax_arrays(grads)


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_amp_train_step_matches_the_jax_solver(family, tmp_path, jax_kernels):
    """One amp step of ``Solver.train_step`` against the JAX solver's amp
    loss and gradients on the same weights: loss within rel 1e-2, every
    gradient within 3e-2 of its max magnitude (figures measured in the
    module docstring); the parameters and the optimizer state stay f32."""
    cfg = ASR_CFG if family == "lstm" else GRU_CFG
    jp, ref_loss, ref_grads = _jax_amp_step(cfg, 3, ATT_SCALE)
    solver = _solver(tmp_path, cfg)
    assert solver.amp
    src = asr_from_arrays(40, VOCAB, cfg, jax_arrays(jp), device="cpu")
    solver.model.load_state_dict(src.state_dict())
    w, wl = waves(3)
    n0 = (lk.lstm_train_bf16.launches, lk.lstm_bwd_bf16.launches,
          gk.gru_train_bf16.launches, gk.gru_bwd_bf16.launches)
    m = solver.train_step(torch.from_numpy(w), torch.from_numpy(wl),
                          torch.from_numpy(TEXT).long(),
                          torch.from_numpy(TEXT_LEN).long())
    assert n0 == (0, 0, 0, 0) == (
        lk.lstm_train_bf16.launches, lk.lstm_bwd_bf16.launches,
        gk.gru_train_bf16.launches, gk.gru_bwd_bf16.launches)
    loss = float(m["loss"])
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss), (loss, ref_loss)
    got = {n: p.grad for n, p in solver.model.named_parameters()}
    assert len(got) == len(ref_grads)
    for path, g in ref_grads.items():
        name = port_name(path)
        assert got[name].dtype == torch.float32, name
        ref = _to_port_layout(name, g)
        err = np.abs(to_np(got[name]) - ref).max() / np.abs(ref).max()
        assert err <= 3e-2, (name, err)
    assert all(p.dtype == torch.float32 for p in solver.model.parameters())
    assert all(v.dtype == torch.float32
               for d in solver.optimizer.slots.values() for v in d.values())


def test_amp_with_use_pallas_train_raises_naming_k7(tmp_path):
    """K7 has no bf16 variant yet: amp with attention.use_pallas_train
    raises rather than widen the attention step to f32."""
    cfg = copy.deepcopy(ASR_CFG)
    cfg["attention"]["use_pallas_train"] = True
    solver = _solver(tmp_path, cfg, amp_flag=True, hparas_amp=False)
    w, wl = waves(1)
    with pytest.raises(NotImplementedError, match="K7's bf16 variant"):
        solver.train_step(torch.from_numpy(w), torch.from_numpy(wl),
                          torch.from_numpy(TEXT).long(),
                          torch.from_numpy(TEXT_LEN).long())


# ------------------------------------------------------ the entry point
def test_main_amp_trains_and_writes_a_checkpoint_jax_reads(tmp_path):
    """``main --amp --cpu`` on config/synthetic/las.yaml (cut to small
    widths and two steps): finite losses, f32 parameters and optimizer
    state in latest.pth, which the JAX package's loader reads back."""
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    root = generate_corpus(str(tmp_path / "synth"), n_train=6, n_dev=3,
                           n_test=0, seed=0)
    cfg = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    cfg["data"]["corpus"].update(path=str(root), batch_size=3)
    cfg["data"]["text"]["vocab_file"] = f"{root}/vocab.txt"
    cfg["model"]["encoder"]["dim"] = [16, 16]
    cfg["model"]["attention"].update(dim=8, loc_kernel_size=6,
                                     loc_kernel_num=2)
    cfg["model"]["decoder"]["dim"] = 16
    cfg["hparas"].update(max_step=2, valid_step=2, PROGRESS_STEP=1)
    path = tmp_path / "las.yaml"
    path.write_text(yaml.safe_dump(cfg))
    port_main.main(["--config", str(path), "--cpu", "--amp", "--no-msg",
                    "--logdir", str(tmp_path / "log"), "--ckpdir",
                    str(tmp_path / "ckpt")])
    log = [json.loads(ln) for ln in
           (tmp_path / "log" / "las_sd0" / "log.jsonl").read_text()
           .splitlines()]
    losses = [v for e in log if e["name"] == "loss"
              for v in e["value"].values()]
    assert len(losses) >= 4 and all(math.isfinite(v) for v in losses)
    ckpt = tmp_path / "ckpt" / "las_sd0" / "latest.pth"
    ck = torch.load(str(ckpt), weights_only=True)
    assert ck["global_step"] == 2 and int(ck["optimizer"]["count"]) == 2
    tensors = [v for v in ck["model"].values() if torch.is_tensor(v)]
    assert tensors and all(v.dtype == torch.float32 for v in tensors
                           if v.is_floating_point())
    slots = ck["optimizer"]["slots"]
    assert slots and all(v.dtype == torch.float32 for d in slots.values()
                         for v in d.values())
    V = load_text_encoder("character", f"{root}/vocab.txt").vocab_size
    jm = JaxASR(40, V, cfg["model"])
    back = load_checkpoint(str(ckpt), jm.init(jax.random.PRNGKey(1)))
    assert back["global_step"] == 2
    loaded = jax_arrays(back["model"])
    fresh = jax_arrays(jm.init(jax.random.PRNGKey(1)))
    assert len(loaded) == len(fresh)
    assert all(np.isfinite(a).all() for a in loaded.values())
    assert any(not np.array_equal(loaded[k], fresh[k]) for k in loaded)
