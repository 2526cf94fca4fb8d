"""The fused location-attention paths of the port against the JAX package on
the CPU: K5 (``loc_attention_plain``, the beam step) against
``loc_attention_fused(..., interpret=True)``; K7 (``LocAttTrain`` with its
hand-written backward, the training step) against ``loc_att_train(...,
interpret=True)`` under ``jax.vjp`` and against autograd through the plain
forward; ``Attention.step_beam`` / ``step`` under ``use_pallas`` /
``use_pallas_train`` against the JAX package's own steps; the beam decode,
one train step, greedy decoding and the entry points with the two keys; the
gates; and the wrappers' input checks.

Inputs come from ``np.random.RandomState`` with ragged lengths (one full
row, one row of length 1). Tolerances (f32, sums taken in another order):
kernel-level values and gradients rtol 1e-5 / atol 1e-6; model-level steps
atol 1e-5 (values) and rtol 1e-4 / atol 1e-6 (gradients); the train step's
loss rtol 1e-5 and gradients rtol 1e-4 / atol 1e-6; beam tokens identical,
scores atol 1e-4."""
import copy
import functools
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
from end_to_end_asr_pytorch_tpu.decode.beam import BeamDecoder as JaxBeam
from end_to_end_asr_pytorch_tpu.decode.greedy import att_greedy as jax_att_greedy
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.models.attention import Attention as JaxAttention
from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from end_to_end_asr_pytorch_tpu.ops.pallas.att_kernel import (
    loc_attention_fused as jax_k5)
from end_to_end_asr_pytorch_tpu.ops.pallas.att_train_kernel import (
    loc_att_train as jax_k7)
from end_to_end_asr_pytorch_tpu.solvers.train_asr import masked_ce as jax_masked_ce
from end_to_end_asr_pytorch_tpu_torch import train
from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
from end_to_end_asr_pytorch_tpu_torch.decode.greedy import att_greedy
from end_to_end_asr_pytorch_tpu_torch.models import attention as port_attention
from end_to_end_asr_pytorch_tpu_torch.models.attention import Attention
from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.ops.ctc import ctc_loss
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import att_kernel, att_train_kernel
from end_to_end_asr_pytorch_tpu_torch.solvers.train_asr import asr_loss
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    _to_port_layout, asr_from_arrays, load_arrays, lm_from_arrays, port_name)
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, LM_CFG, VOCAB,
                                       jax_arrays, to_np, waves)

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
D, F, VD, KB = 8, 3, 6, 3
SHAPES = {"B4_T13": (4, 13, 0.5), "B3_T11": (3, 11, 0.7)}   # B, T, tau


def _lens(B, T, rng):
    """Ragged lengths: row 0 full, row 1 of length 1."""
    lens = rng.randint(2, T, size=B).astype(np.int32)
    lens[0], lens[1] = T, 1
    return lens


def _k5_inputs(B, T, seed):
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.7).astype(np.float32)
    return (r(B, KB, D), r(B, T, D), r(B, KB, T, F), r(F, D), r(D),
            r(B, T, VD), _lens(B, T, rng))


def _k7_inputs(B, T, seed):
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.7).astype(np.float32)
    arrays = (r(B, D), r(B, T, D), r(B, T, D), r(D), r(B, T, VD))
    return arrays, _lens(B, T, rng), r(B, VD), r(B, T)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k5_plain_matches_pallas_interpret(shape):
    B, T, tau = SHAPES[shape]
    args = _k5_inputs(B, T, 0)
    rctx, ral = jax_k5(*(jnp.asarray(a) for a in args), temperature=tau,
                       interpret=True)
    ctx, al = att_kernel.loc_attention_plain(*_t(args), tau)
    np.testing.assert_allclose(to_np(ctx), np.asarray(rctx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(al), np.asarray(ral), rtol=RTOL, atol=ATOL)
    # the frames past each row's length get no alignment
    lens = args[-1]
    for b in range(B):
        assert np.all(to_np(al)[b, :, lens[b]:] == 0.0)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    got = att_kernel.loc_attention_fused(*_t(args), tau)
    for a, b in zip(got, (ctx, al)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert att_kernel.loc_attention_fused.launches == 0


def test_k5_zero_length_row_is_uniform_as_in_jax():
    """enc_len is not clamped: a zero-length row has every energy masked
    and a uniform alignment, as the TPU kernel gives it."""
    B, T, tau = SHAPES["B3_T11"]
    args = list(_k5_inputs(B, T, 1))
    args[-1] = np.asarray([T, 0, 4], np.int32)
    rctx, ral = jax_k5(*(jnp.asarray(a) for a in args), temperature=tau,
                       interpret=True)
    ctx, al = att_kernel.loc_attention_plain(*_t(args), tau)
    np.testing.assert_allclose(to_np(al)[1], np.full((KB, T), 1.0 / T),
                               rtol=1e-6)
    np.testing.assert_allclose(to_np(al), np.asarray(ral), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(ctx), np.asarray(rctx), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k7_forward_matches_pallas_interpret(shape):
    B, T, tau = SHAPES[shape]
    arrays, lens, _, _ = _k7_inputs(B, T, 2)
    rctx, ral = jax_k7(*(jnp.asarray(a) for a in arrays), jnp.asarray(lens),
                       tau, True)
    for fn in (att_train_kernel.loc_att_fwd_plain,
               att_train_kernel.loc_att_fwd_fused,
               lambda *a: att_train_kernel.LocAttTrain.apply(*a, False)):
        ctx, al = fn(*_t(arrays), torch.from_numpy(lens), tau)
        np.testing.assert_allclose(to_np(ctx), np.asarray(rctx), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(to_np(al), np.asarray(ral), rtol=RTOL,
                                   atol=ATOL)
    assert att_train_kernel.loc_att_fwd_fused.launches == 0


def _port_k7_grads(arrays, lens, dctx, dalign, tau, fn):
    """Gradients of sum(ctx * dctx) + sum(align * dalign) wrt q, keys, f,
    v, vals, with ``fn`` the forward."""
    xs = [t.requires_grad_(True) for t in _t(arrays)]
    ctx, al = fn(*xs, torch.from_numpy(lens), tau)
    (ctx * torch.from_numpy(dctx)).sum().add(
        (al * torch.from_numpy(dalign)).sum()).backward()
    return [to_np(x.grad) for x in xs]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k7_hand_backward_matches_pallas_vjp(shape):
    """All five gradients of LocAttTrain (its hand-written backward, the
    one the card runs as K7) against jax.vjp of the TPU kernel's custom
    VJP in interpret mode; B=3 is an odd batch."""
    B, T, tau = SHAPES[shape]
    arrays, lens, dctx, dalign = _k7_inputs(B, T, 3)
    _, vjp = jax.vjp(lambda *a: jax_k7(*a, jnp.asarray(lens), tau, True),
                     *(jnp.asarray(a) for a in arrays))
    ref = vjp((jnp.asarray(dctx), jnp.asarray(dalign)))
    got = _port_k7_grads(arrays, lens, dctx, dalign, tau,
                         lambda *a: att_train_kernel.LocAttTrain.apply(*a, False))
    for name, g, r in zip(("dq", "dkeys", "df", "dv", "dvals"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        assert np.any(g != 0), name


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k7_hand_backward_matches_autograd_through_plain_forward(shape):
    B, T, tau = SHAPES[shape]
    arrays, lens, dctx, dalign = _k7_inputs(B, T, 4)
    hand = _port_k7_grads(arrays, lens, dctx, dalign, tau,
                          lambda *a: att_train_kernel.LocAttTrain.apply(*a, False))
    auto = _port_k7_grads(arrays, lens, dctx, dalign, tau,
                          att_train_kernel.loc_att_fwd_plain)
    for name, a, b in zip(("dq", "dkeys", "df", "dv", "dvals"), hand, auto):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_k7_masked_frames_get_zero_dtarg_and_dvals():
    B, T, tau = SHAPES["B4_T13"]
    arrays, lens, dctx, dalign = _k7_inputs(B, T, 5)
    ta = _t(arrays)
    ctx, al = att_train_kernel.loc_att_fwd_plain(*ta, torch.from_numpy(lens), tau)
    out = att_train_kernel.loc_att_bwd_fused(
        *ta, torch.from_numpy(lens), al, *_t((dctx, dalign)), tau)
    ref = att_train_kernel.loc_att_bwd_plain(
        *ta, torch.from_numpy(lens), al, *_t((dctx, dalign)), tau)
    for a, b in zip(out, ref):                   # CPU: the plain version
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, dtarg, dvals, _ = (to_np(x) for x in out)
    for b in range(B):
        assert np.all(dtarg[b, lens[b]:] == 0.0)
        assert np.all(dvals[b, lens[b]:] == 0.0)
    # the length-1 row puts all its weight on frame 0: no energy gradient
    assert np.all(dtarg[1] == 0.0)
    assert att_train_kernel.loc_att_bwd_fused.launches == 0


LOC_CFG = dict(ASR_CFG["attention"], dim=D, loc_kernel_num=F)
Dq, Dk = 12, 10


def _attention_pair(cfg, seed):
    ja = JaxAttention({k: v for k, v in cfg.items()
                       if k not in ("use_pallas", "use_pallas_train")}, Dq, Dk)
    jp = ja.init(jax.random.PRNGKey(seed))
    pa = load_arrays(Attention(cfg, Dq, Dk, device="cpu"), jax_arrays(jp))
    return ja, jp, pa


def _att_inputs(B, K, T, seed):
    rng = np.random.RandomState(seed)
    enc = rng.randn(B, T, Dk).astype(np.float32)
    elen = _lens(B, T, rng)
    q = rng.randn(B, K, Dq).astype(np.float32)
    prev = rng.uniform(0.0, 0.3, size=(B, K, 1, T)).astype(np.float32)
    return enc, elen, q, prev


class _Spy:
    """Records the fused routes the attention module takes."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("loc_attention_plain", "loc_attention_fused"):
            orig = getattr(port_attention, name)
            monkeypatch.setattr(port_attention, name, self._wrap(name, orig))
        orig_apply = att_train_kernel.LocAttTrain.apply
        monkeypatch.setattr(port_attention, "LocAttTrain", type(
            "LocAttTrainSpy", (), {"apply": staticmethod(
                self._wrap("LocAttTrain", orig_apply))}))

    def _wrap(self, name, fn):
        def run(*a, **k):
            self.calls.append(name)
            return fn(*a, **k)
        return run


@pytest.mark.parametrize("tau", [0.5, 1.0])
def test_step_beam_with_use_pallas_matches_jax(tau, monkeypatch):
    """K5's route (its plain version on the CPU) against the JAX package's
    step_beam with use_pallas off: the same math."""
    cfg = dict(LOC_CFG, temperature=tau, use_pallas=True)
    ja, jp, pa = _attention_pair(cfg, 0)
    B, K, T = 4, KB, 13
    enc, elen, q, prev = _att_inputs(B, K, T, 0)
    jc = ja.precompute(jp, jnp.asarray(enc), jnp.asarray(elen))
    rctx, ral = ja.step_beam(jp, jc, jnp.asarray(q), jnp.asarray(prev))
    spy = _Spy(monkeypatch)
    pc = pa.precompute(torch.from_numpy(enc), torch.from_numpy(elen))
    gctx, gal = pa.step_beam(pc, torch.from_numpy(q), torch.from_numpy(prev))
    assert spy.calls == ["loc_attention_plain"]
    np.testing.assert_allclose(to_np(gal), np.asarray(ral), atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_np(gctx), np.asarray(rctx), atol=1e-5, rtol=0)


def _jax_step_vjp(ja, jp, enc, elen, q, prev, dctx, dalign):
    def f(p, query, pa):
        c = ja.precompute(p, jnp.asarray(enc), jnp.asarray(elen))
        return ja.step(p, c, query, pa)
    out, vjp = jax.vjp(f, jp, jnp.asarray(q), jnp.asarray(prev))
    return out, vjp((jnp.asarray(dctx), jnp.asarray(dalign)))


@pytest.mark.parametrize("tau", [0.5, 1.0])
def test_step_with_use_pallas_train_matches_jax(tau, monkeypatch):
    """LocAttTrain's route of Attention.step: values, and the gradients of
    every attention parameter, the query and the previous alignment,
    against jax.vjp of the JAX package's step (its plain chain on the
    CPU)."""
    cfg = dict(LOC_CFG, temperature=tau, use_pallas_train=True)
    ja, jp, pa = _attention_pair(cfg, 1)
    B, T = 4, 13
    enc, elen, q, prev = _att_inputs(B, 1, T, 1)
    q, prev = q[:, 0], prev[:, 0]
    rng = np.random.RandomState(11)
    dctx = rng.randn(B, pa.context_dim).astype(np.float32)
    dalign = rng.randn(B, 1, T).astype(np.float32)
    (rctx, ral), (gp, gq, gprev) = _jax_step_vjp(ja, jp, enc, elen, q, prev,
                                                 dctx, dalign)
    spy = _Spy(monkeypatch)
    pa.requires_grad_(True)
    tq, tprev = (torch.from_numpy(a).requires_grad_(True) for a in (q, prev))
    pc = pa.precompute(torch.from_numpy(enc), torch.from_numpy(elen))
    ctx, al = pa.step(pc, tq, tprev)
    assert spy.calls == ["LocAttTrain"]
    np.testing.assert_allclose(to_np(ctx), np.asarray(rctx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_np(al), np.asarray(ral), atol=1e-5, rtol=0)
    ((ctx * torch.from_numpy(dctx)).sum()
     + (al * torch.from_numpy(dalign)).sum()).backward()
    np.testing.assert_allclose(to_np(tq.grad), np.asarray(gq), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(tprev.grad), np.asarray(gprev),
                               rtol=1e-4, atol=1e-6)
    got = {n: to_np(p.grad) for n, p in pa.named_parameters()}
    ref = jax_arrays(gp)
    assert len(got) == len(ref) == 7
    for path, g in ref.items():
        name = port_name(path)
        np.testing.assert_allclose(got[name], _to_port_layout(name, g),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


OUTSIDE = {"two_heads": dict(LOC_CFG, num_head=2),
           "no_v_proj": dict(LOC_CFG, v_proj=False)}


@pytest.mark.parametrize("method", ["step", "step_beam"])
@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_configs_outside_the_gates_take_the_plain_chain(name, method,
                                                        monkeypatch):
    """num_head 2 or v_proj false with both keys on: no fused route, and
    the JAX package's values."""
    cfg = dict(OUTSIDE[name], use_pallas=True, use_pallas_train=True)
    ja, jp, pa = _attention_pair(cfg, 2)
    H = pa.num_head
    B, K, T = 3, (KB if method == "step_beam" else 1), 11
    enc, elen, q, prev = _att_inputs(B, K, T, 2)
    prev = np.repeat(prev, H, axis=2)
    jc = ja.precompute(jp, jnp.asarray(enc), jnp.asarray(elen))
    spy = _Spy(monkeypatch)
    pc = pa.precompute(torch.from_numpy(enc), torch.from_numpy(elen))
    if method == "step":
        ref = ja.step(jp, jc, jnp.asarray(q[:, 0]), jnp.asarray(prev[:, 0]))
        got = pa.step(pc, torch.from_numpy(q[:, 0]), torch.from_numpy(prev[:, 0]))
    else:
        ref = ja.step_beam(jp, jc, jnp.asarray(q), jnp.asarray(prev))
        got = pa.step_beam(pc, torch.from_numpy(q), torch.from_numpy(prev))
    assert spy.calls == []
    for g, r in zip(got, ref):
        np.testing.assert_allclose(to_np(g), np.asarray(r), atol=1e-5, rtol=0)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to see which route
    the attention module picks there."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kernels", [True, False])
def test_card_tensors_take_the_kernel_route_by_the_switch_alone(
        monkeypatch, kernels):
    """On the card the route is chosen by the kernel switch alone."""
    routes = []

    def k5(name):
        def run(qb, keys, fsm, w_f, v, vals, enc_len, tau):
            routes.append(name)
            B, K, T = fsm.shape[:3]
            return torch.zeros(B, K, vals.shape[-1]), torch.zeros(B, K, T)
        return run

    def k7(q, keys, f, v, vals, enc_len, tau, use_kernel):
        routes.append(("K7", use_kernel))
        return torch.zeros(q.shape[0], vals.shape[-1]), torch.zeros(keys.shape[:2])

    monkeypatch.setattr(port_attention, "loc_attention_fused", k5("fused"))
    monkeypatch.setattr(port_attention, "loc_attention_plain", k5("plain"))
    monkeypatch.setattr(port_attention, "LocAttTrain",
                        type("Rec", (), {"apply": staticmethod(k7)}))
    monkeypatch.setattr(cuda_kernels, "USE_KERNELS", kernels)
    pa = Attention(dict(LOC_CFG, use_pallas=True, use_pallas_train=True),
                   Dq, Dk, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    enc, elen, q, prev = _att_inputs(2, KB, 7, 3)
    pc = pa.precompute(torch.from_numpy(enc), torch.from_numpy(elen))
    card = lambda a: torch.from_numpy(a).as_subclass(_OnCard)
    pa.step_beam(pc, card(q), torch.from_numpy(prev))
    pa.step(pc, card(q[:, 0]), torch.from_numpy(prev[:, 0]))
    assert routes == ["fused" if kernels else "plain", ("K7", kernels)]


def _bf16(t):
    return t.to(torch.bfloat16)


def _strided(t):
    """The same values in a non-contiguous (transposed) layout."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


WRAPPERS = ["k5", "k7_fwd", "k7_bwd"]


@pytest.mark.parametrize("bad", ["bf16", "strided"])
@pytest.mark.parametrize("which", WRAPPERS)
def test_wrappers_reject_non_f32_or_non_contiguous_inputs(which, bad):
    """Each wrapper raises on a bf16 or a non-contiguous input on the CPU,
    rather than pass it to a plain version."""
    spoil = _bf16 if bad == "bf16" else _strided
    match = "float32" if bad == "bf16" else "contiguous"
    if which == "k5":
        qb, keys, fsm, w_f, v, vals, lens = _t(_k5_inputs(3, 11, 6))
        with pytest.raises(ValueError, match=match):
            att_kernel.loc_attention_fused(qb, keys, spoil(fsm), w_f, v,
                                           vals, lens, 0.5)
        return
    arrays, lens, dctx, dalign = _k7_inputs(3, 11, 6)
    q, keys, f, v, vals = _t(arrays)
    lens = torch.from_numpy(lens)
    if which == "k7_fwd":
        with pytest.raises(ValueError, match=match):
            att_train_kernel.loc_att_fwd_fused(q, spoil(keys), f, v, vals,
                                               lens, 0.5)
        return
    _, al = att_train_kernel.loc_att_fwd_plain(q, keys, f, v, vals, lens, 0.5)
    with pytest.raises(ValueError, match=match):
        att_train_kernel.loc_att_bwd_fused(q, keys, f, v, vals, lens, al,
                                           spoil(torch.from_numpy(dctx)),
                                           torch.from_numpy(dalign), 0.5)


# ---------------------------------------------------------------- slice level
DECODE_CFG = {"beam_size": 4, "min_len_ratio": 0.05, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3}


def _with(key):
    cfg = copy.deepcopy(ASR_CFG)
    cfg["attention"][key] = True
    return cfg


@functools.lru_cache(maxsize=None)
def _beam_models(seed):
    jm = JaxASR(40, VOCAB, ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(seed))
    jlm = JaxLM(VOCAB, LM_CFG)
    jlp = jlm.init(jax.random.PRNGKey(100 + seed))
    pm = asr_from_arrays(40, VOCAB, _with("use_pallas"), jax_arrays(jp),
                         device="cpu")
    plm = lm_from_arrays(VOCAB, LM_CFG, jax_arrays(jlp), device="cpu")
    return jm, jp, jlm, jlp, pm, plm


@pytest.mark.parametrize("seed", [0, 1])
def test_beam_decode_with_use_pallas_matches_jax(seed, monkeypatch):
    jm, jp, jlm, jlp, pm, plm = _beam_models(seed)
    w, wl = waves(seed)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    ref = JaxBeam(jm, DECODE_CFG, lm=jlm).forward(jp, jf, jfl, lm_params=jlp)
    spy = _Spy(monkeypatch)
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    dec = BeamDecoder(pm, DECODE_CFG, lm=plm)
    got = dec.forward(pf, pfl)
    assert spy.calls == ["loc_attention_plain"] * dec.last_steps
    np.testing.assert_array_equal(to_np(got.tokens), np.asarray(ref.tokens))
    np.testing.assert_array_equal(to_np(got.lengths), np.asarray(ref.lengths))
    np.testing.assert_allclose(to_np(got.scores), np.asarray(ref.scores),
                               atol=1e-4, rtol=0)


TEXT = np.asarray([[3, 4, 4, 5, 6, 2, 0, 0], [7, 8, 9, 7, 0, 0, 0, 0],
                   [3, 5, 7, 9, 11, 3, 5, 7]], np.int32)
TEXT_LEN = np.asarray([6, 4, 8], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_train_step(seed):
    jm = JaxASR(40, VOCAB, _with("use_pallas_train"))
    jp = jm.init(jax.random.PRNGKey(seed))
    w, wl = waves(seed)
    feat, flen = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    text, text_len = jnp.asarray(TEXT), jnp.asarray(TEXT_LEN)

    def loss_fn(p):
        ctc_out, enc_len, att_out, _, _ = jm.forward(
            p, feat, flen, TEXT.shape[1], 1.0, teacher=text, train=True,
            rng=jax.random.PRNGKey(7))
        valid = text_len > 0
        nll = jax_ctc_loss(ctc_out, enc_len, text, text_len)
        per = nll / jnp.maximum(text_len, 1)
        ctc_l = jnp.sum(jnp.where(valid & (nll < 1e29), per, 0.0)) / \
            jnp.maximum(jnp.sum(valid), 1)
        return 0.5 * ctc_l + 0.5 * jax_masked_ce(att_out, text)

    loss, grads = jax.value_and_grad(loss_fn)(jp)
    return jm, jp, float(loss), jax_arrays(grads)


@pytest.mark.parametrize("seed", [0, 3])
def test_train_step_with_use_pallas_train_matches_jax(seed, monkeypatch):
    """One teacher-forced train step through LocAttTrain (its hand-written
    backward at every label step): loss and every gradient against JAX
    value_and_grad."""
    _, jp, ref_loss, ref_grads = _jax_train_step(seed)
    pm = asr_from_arrays(40, VOCAB, _with("use_pallas_train"), jax_arrays(jp),
                         device="cpu")
    pm.requires_grad_(True)
    spy = _Spy(monkeypatch)
    w, wl = waves(seed)
    feat, flen = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                        torch.from_numpy(wl))
    text, text_len = torch.from_numpy(TEXT).long(), torch.from_numpy(TEXT_LEN).long()
    ctc_out, enc_len, att_out, _, _ = pm(feat, flen, TEXT.shape[1], 1.0,
                                         teacher=text, train=True,
                                         generator=torch.Generator())
    assert spy.calls == ["LocAttTrain"] * TEXT.shape[1]
    loss, _ = asr_loss(ctc_out, enc_len, att_out, text, text_len, 0.5, ctc_loss)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    got = {n: to_np(p.grad) for n, p in pm.named_parameters()}
    assert len(got) == len(ref_grads)
    for path, g in ref_grads.items():
        name = port_name(path)
        np.testing.assert_allclose(got[name], _to_port_layout(name, g),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        assert np.any(got[name] != 0), name


def test_att_greedy_with_use_pallas_train_matches_jax(monkeypatch):
    jm, jp, _, _ = _jax_train_step(0)
    rng = np.random.RandomState(2)
    enc = rng.randn(3, 9, jm.encoder.out_dim).astype(np.float32)
    elen = np.asarray([9, 1, 4], np.int32)
    ref = jax_att_greedy(jm, jp, jnp.asarray(enc), jnp.asarray(elen), 7)
    pm = asr_from_arrays(40, VOCAB, _with("use_pallas_train"), jax_arrays(jp),
                         device="cpu")
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        got = att_greedy(pm, torch.from_numpy(enc), torch.from_numpy(elen), 7)
    assert spy.calls and set(spy.calls) == {"LocAttTrain"}
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


# ---------------------------------------------------------------- entry points
def test_train_entry_with_use_pallas_train_runs_on_cpu(tmp_path, monkeypatch):
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
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
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    spy = _Spy(monkeypatch)
    train.main(["--config", str(path), "--cpu", "--no-msg", "--logdir",
                str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")])
    assert spy.calls and set(spy.calls) == {"LocAttTrain"}
    log = [json.loads(ln) for ln in
           (tmp_path / "log" / "cfg_sd0" / "log.jsonl").read_text().splitlines()]
    losses = [e["value"]["tr_loss"] for e in log
              if e["name"] == "loss" and "tr_loss" in e["value"]]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert (tmp_path / "ckpt" / "cfg_sd0" / "latest.pth").exists()


def test_transcribe_with_use_pallas_writes_the_same_rows(tmp_path, monkeypatch):
    from end_to_end_asr_pytorch_tpu_torch import transcribe
    from tests.test_torch_port_decode import _write_transcribe_inputs
    paths = _write_transcribe_inputs(tmp_path)
    common = ["--load", str(tmp_path / "m.pth"), "--cpu", "--batch", "2", *paths]
    transcribe.main(["--config", str(tmp_path / "cfg.yaml"), *common,
                     "--output", str(tmp_path / "plain.tsv")])
    cfg = yaml.safe_load((tmp_path / "cfg.yaml").read_text())
    cfg["model"]["attention"]["use_pallas"] = True
    (tmp_path / "k5.yaml").write_text(yaml.safe_dump(cfg))
    spy = _Spy(monkeypatch)
    transcribe.main(["--config", str(tmp_path / "k5.yaml"), *common,
                     "--output", str(tmp_path / "k5.tsv")])
    assert spy.calls and set(spy.calls) == {"loc_attention_plain"}
    rows = (tmp_path / "k5.tsv").read_text()
    assert len(rows.strip().split("\n")) == 2
    assert rows == (tmp_path / "plain.tsv").read_text()
