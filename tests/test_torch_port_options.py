"""The port's SpecAugment and the beam's opt-in decode keys against the JAX
package on the CPU.

SpecAugment: the masking is bit-identical to JAX ``spec_augment`` given the
JAX draws (rebuilt here with the same ``jax.random`` splits); the port's
own draws keep the JAX bounds; a train step on masked features matches
the JAX loss with ``spec_augment`` inside it (loss rtol 1e-5, gradients
rtol 1e-4 / atol 1e-6).

Decode keys (``ctc_candidates``, ``psi_quant``, ``ctc_window``,
``approx_topk``): ``score_candidates``' candidate, q8 and window branches
against the JAX scorer (rtol 1e-5; the q8 int32 product bit-equal), whole
f32 beams (identical tokens and lengths, scores rtol 1e-5), ``psi_quant``
under amp (identical top-1, best score within 1e-4, as
test_torch_port_amp.py), the early exit's resolution and step count, the
routes taken and the JAX package's ValueErrors."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.decode.beam import BeamDecoder as JaxBeam
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu.ops import ctc_prefix as jctc
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.augment import spec_augment
from end_to_end_asr_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from end_to_end_asr_pytorch_tpu.solvers.train_asr import masked_ce as jax_masked_ce
from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
from end_to_end_asr_pytorch_tpu_torch.ops import ctc_prefix
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.ops.augment import (
    Masks, apply_masks, draw_masks, mask_params, max_time_width)
from end_to_end_asr_pytorch_tpu_torch.ops.ctc import ctc_loss
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import beam_step_kernel
from end_to_end_asr_pytorch_tpu_torch.solvers.train_asr import asr_loss
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    _to_port_layout, asr_from_arrays, port_name)
from tests.test_torch_port_amp import (_assert_top1, _models,
                                       _spy_psi_route, jax_fused_scan)
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, VOCAB,
                                       jax_arrays, to_np, waves)

torch.set_num_threads(1)
NEG_INF = -1e30
DECODE_CFG = {"beam_size": 4, "min_len_ratio": 0.05, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3}
TEXT = np.asarray([[3, 4, 4, 5, 6, 2, 0, 0], [7, 8, 9, 7, 0, 0, 0, 0],
                   [3, 5, 7, 9, 11, 3, 5, 7]], np.int32)
TEXT_LEN = np.asarray([6, 4, 8], np.int32)
AUG_CFGS = {"defaults": {},
            "wide": {"freq_mask_n": 3, "freq_mask_width": 12,
                     "time_mask_n": 1, "time_mask_width": 30,
                     "time_mask_ratio": 0.5}}


# ------------------------------------------------------------ SpecAugment
def jax_draws(feat_len, F, cfg, key) -> Masks:
    """The draws of JAX ``spec_augment`` for ``key``, rebuilt with its
    splits, as the port's Masks."""
    fn, fw, tn, tw, ratio = mask_params(cfg, F)
    B = len(feat_len)
    fl = jnp.asarray(feat_len, jnp.int32)
    rng, out = key, {"fs": [], "fw": [], "ts": [], "tw": []}
    for _ in range(fn):
        rng, k1, k2 = jax.random.split(rng, 3)
        width = jax.random.randint(k1, (B, 1), 0, fw + 1)
        out["fw"].append(width)
        out["fs"].append(jax.random.randint(k2, (B, 1), 0,
                                            jnp.maximum(F - width, 1)))
    max_t = jnp.maximum((ratio * fl).astype(jnp.int32) // max(tn, 1), 0)
    for _ in range(tn):
        rng, k1, k2 = jax.random.split(rng, 3)
        width = jnp.minimum(jax.random.randint(k1, (B, 1), 0, tw + 1),
                            max_t[:, None])
        out["tw"].append(width)
        out["ts"].append(jax.random.randint(
            k2, (B, 1), 0, jnp.maximum(fl[:, None] - width, 1)))
    t = {k: torch.from_numpy(np.concatenate(
        [np.asarray(a) for a in v], 1).astype(np.int64)) for k, v in out.items()}
    return Masks(t["fs"], t["fw"], t["ts"], t["tw"])


@pytest.mark.parametrize("name", sorted(AUG_CFGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masking_is_bit_identical_to_jax_on_its_draws(name, seed):
    cfg = AUG_CFGS[name]
    rng = np.random.RandomState(seed)
    B, T, F = 5, 90, 40
    feat = rng.randn(B, T, F).astype(np.float32)
    flen = np.asarray([90, 61, 17, 1, 0], np.int32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(spec_augment(jnp.asarray(feat), jnp.asarray(flen), key,
                                  cfg))
    masks = jax_draws(flen, F, cfg, key)
    got = to_np(apply_masks(torch.from_numpy(feat), masks))
    np.testing.assert_array_equal(got, ref)
    assert (got == 0).any() or not masks.freq_width.any()


def test_time_cap_matches_jax():
    flen = np.arange(0, 1200, 7, dtype=np.int32)
    for ratio, tn in ((0.2, 2), (0.05, 3), (0.37, 1)):
        ref = np.maximum((ratio * jnp.asarray(flen)).astype(jnp.int32)
                         // tn, 0)
        got = max_time_width(torch.from_numpy(flen), ratio, tn)
        np.testing.assert_array_equal(to_np(got), np.asarray(ref))


@pytest.mark.parametrize("lo,hi", [(400, 1000), (0, 60)])
def test_draws_keep_the_jax_bounds(lo, hi):
    """2,000 utterances: every width and start within its bound, and (when
    the lengths do not cap them) every width 0..max occurs."""
    rng = np.random.RandomState(lo)
    F, cfg = 40, {}
    fn, fw, tn, tw, ratio = mask_params(cfg, F)
    flen = torch.from_numpy(rng.randint(lo, hi + 1, 2000))
    g = torch.Generator().manual_seed(5)
    m = draw_masks(flen, F, cfg, g)
    assert m.freq_width.shape == (2000, fn) and m.time_width.shape == (2000, tn)
    assert bool(((m.freq_width >= 0) & (m.freq_width <= fw)).all())
    assert bool(((m.freq_start >= 0)
                 & (m.freq_start < torch.clamp(F - m.freq_width, min=1))).all())
    cap = max_time_width(flen, ratio, tn)[:, None]
    assert bool(((m.time_width >= 0) & (m.time_width <= tw)
                 & (m.time_width <= cap)).all())
    limit = torch.clamp(flen[:, None] - m.time_width, min=1)
    assert bool(((m.time_start >= 0) & (m.time_start < limit)).all())
    assert set(m.freq_width.flatten().tolist()) == set(range(fw + 1))
    if lo >= 400:
        assert set(m.time_width.flatten().tolist()) == set(range(tw + 1))
    else:
        assert int(m.time_width.max()) <= int(cap.max())
    # a fixed generator state gives the same masks
    g2 = torch.Generator().manual_seed(5)
    assert all(torch.equal(a, b) for a, b in
               zip(m, draw_masks(flen, F, cfg, g2)))


def test_train_step_on_masked_features_matches_jax():
    """The JAX loss with ``spec_augment`` on the front end's features (as
    its solver's loss_fn) against the port's loss on ``apply_masks`` of
    the same draws: loss and every gradient."""
    cfg = {"time_mask_width": 6, "freq_mask_width": 10}
    jm = JaxASR(40, VOCAB, ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(4))
    w, wl = waves(4)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    key = jax.random.PRNGKey(9)
    text, text_len = jnp.asarray(TEXT), jnp.asarray(TEXT_LEN)

    def loss_fn(p):
        feat = spec_augment(jf, jfl, key, cfg)
        ctc_out, enc_len, att_out, _, _ = jm.forward(
            p, feat, jfl, TEXT.shape[1], 1.0, teacher=text, train=True,
            rng=jax.random.PRNGKey(7))
        nll = jax_ctc_loss(ctc_out, enc_len, text, text_len)
        valid = text_len > 0
        per = nll / jnp.maximum(text_len, 1)
        ctc_l = jnp.sum(jnp.where(valid & (nll < 1e29), per, 0.0)) / \
            jnp.maximum(jnp.sum(valid), 1)
        return 0.5 * ctc_l + 0.5 * jax_masked_ce(att_out, text)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jp)
    pm = asr_from_arrays(40, VOCAB, ASR_CFG, jax_arrays(jp), device="cpu")
    pm.requires_grad_(True)
    feat, flen = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                        torch.from_numpy(wl))
    masks = jax_draws(np.asarray(jfl), 40, cfg, key)
    feat = apply_masks(feat, masks)
    assert (feat == 0).any()
    tt = torch.from_numpy(TEXT).long()
    ctc_out, enc_len, att_out, _, _ = pm(feat, flen, TEXT.shape[1], 1.0,
                                         teacher=tt, train=True,
                                         generator=torch.Generator())
    loss, _ = asr_loss(ctc_out, enc_len, att_out, tt,
                       torch.from_numpy(TEXT_LEN).long(), 0.5, ctc_loss)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    got = {n: to_np(p.grad) for n, p in pm.named_parameters()}
    for path, g in jax_arrays(ref_grads).items():
        name = port_name(path)
        np.testing.assert_allclose(got[name], _to_port_layout(name, g),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------------- score_candidates
def _psi_inputs(B=3, K=4, T=18, V=24, seed=0):
    """A mid-decode CTC state (as test_torch_port_amp.py builds it)."""
    rng = np.random.RandomState(seed)
    lp = jax.nn.log_softmax(
        jnp.asarray(rng.randn(B, T, V) * 2.0, jnp.float32), axis=-1)
    enc_len = jnp.asarray(rng.randint(T // 2, T + 1, (B,)), jnp.int32)
    lp = jctc.pad_ctc_log_probs(lp, enc_len)
    r, _ = jctc.init_state(lp, K)
    last = jnp.asarray(rng.randint(1, V, (B, K)), jnp.int32)
    plen = jnp.asarray(rng.randint(0, 3, (B, K)), jnp.int32)
    _, r2 = jctc.score_candidates(lp, r, last, plen, cand_ids=last[..., None])
    last2 = rng.randint(1, V, (B, K)).astype(np.int32)
    cand = np.stack([rng.permutation(V)[:5] for _ in range(B * K)]
                    ).reshape(B, K, 5).astype(np.int32)
    cand[0, 0, 0] = 0                             # the blank among them
    cand[1, 1, 1] = last2[1, 1]                   # the last token
    return (np.array(lp), np.array(r2[:, :, 0]), last2, np.array(plen) + 1,
            cand)


def _assert_psi(got, ref):
    got, ref = to_np(got), np.asarray(ref)
    dead = ref <= NEG_INF / 2
    np.testing.assert_array_equal(got <= NEG_INF / 2, dead)
    np.testing.assert_allclose(got[~dead], ref[~dead], rtol=1e-5, atol=0)


def _port(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("route", ["rows", "full_then_gather"])
@pytest.mark.parametrize("seed", [0, 1])
def test_candidate_psi_matches_jax(route, seed):
    """Both psi-only ``cand_ids`` branches: the rows of probs_vt gathered,
    and the full-vocab psi gathered."""
    lp, r, last, plen, cand = _psi_inputs(seed=seed)
    kw = {}
    if route == "rows":
        pvt = np.exp(np.moveaxis(lp, 1, 2))
        kw = {"probs_vt": pvt}
    ref, _ = jctc.score_candidates(
        None if route == "rows" else jnp.asarray(lp), jnp.asarray(r),
        jnp.asarray(last), jnp.asarray(plen), cand_ids=jnp.asarray(cand),
        with_state=False, **{k: jnp.asarray(v) for k, v in kw.items()})
    got, _ = ctc_prefix.score_candidates(
        None if route == "rows" else _port(lp), _port(r),
        _port(last).long(), _port(plen), cand_ids=_port(cand).long(),
        with_state=False, **{k: _port(v) for k, v in kw.items()})
    assert got.shape == cand.shape
    _assert_psi(got, ref)
    full, _ = ctc_prefix.score_candidates(_port(lp), _port(r),
                                          _port(last).long(), _port(plen),
                                          with_state=False)
    _assert_psi(got, np.take_along_axis(to_np(full), cand, 2))


@pytest.mark.parametrize("T", [37, 1100])
def test_q8_product_is_the_exact_int32_sum(T):
    """The int8 x int8 -> int32 product, bit-equal to the JAX einsum, also
    past 1040 frames (all-127 rows: a single f32 product would round)."""
    rng = np.random.RandomState(T)
    B, K, V = 2, 3, 17
    qw = rng.randint(0, 128, (B, K, T)).astype(np.int8)
    q8 = rng.randint(0, 128, (B, T, V)).astype(np.int8)
    qw[0, 0] = 127
    q8[0, :, 0] = 127
    ref = np.asarray(jnp.einsum("bkt,btv->bkv", jnp.asarray(qw),
                                jnp.asarray(q8),
                                preferred_element_type=jnp.int32))
    for operand in (_port(q8), _port(q8).float()):
        got = ctc_prefix.q8_product(_port(qw), operand)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(to_np(got), ref)
    assert ref[0, 0, 0] == T * 127 * 127


def test_quantize_probs_q8_matches_jax():
    rng = np.random.RandomState(0)
    p = np.concatenate([rng.rand(5000), (np.arange(128) + 0.5) / 127.0,
                        [0.0, 1.0]]).astype(np.float32)
    ref = np.asarray(jctc.quantize_probs_q8(jnp.asarray(p)))
    got = ctc_prefix.quantize_probs_q8(_port(p))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(to_np(got), ref)


@pytest.mark.parametrize("q8,window,nb", [
    (True, 0, False), (False, 6, True), (False, 6, False), (True, 5, True),
    (False, 40, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_q8_and_window_psi_match_jax(q8, window, nb, seed):
    """The q8 branch, the window branch (frontier with and without the
    best non-blank log-prob; a window past T is no window) and both."""
    lp, r, last, plen, _ = _psi_inputs(seed=seed, T=24)
    probs = np.exp(lp)
    jkw, pkw = {}, {"window": window}
    jkw["window"] = window
    if q8:
        jkw["probs_q8"] = jctc.quantize_probs_q8(jnp.asarray(probs))
        pkw["probs_q8"] = ctc_prefix.quantize_probs_q8(_port(probs))
    if nb:
        mx = np.max(lp[:, :, 1:], axis=-1)
        jkw["max_nb_lp"] = jnp.asarray(mx)
        pkw["max_nb_lp"] = _port(mx)
    ref, _ = jctc.score_candidates(jnp.asarray(lp), jnp.asarray(r),
                                   jnp.asarray(last), jnp.asarray(plen),
                                   with_state=False,
                                   probs=jnp.asarray(probs), **jkw)
    got, _ = ctc_prefix.score_candidates(_port(lp), _port(r),
                                         _port(last).long(), _port(plen),
                                         with_state=False, probs=_port(probs),
                                         **pkw)
    _assert_psi(got, ref)


# ------------------------------------------------------------- the beam
KEYS = {"candidates": {"ctc_candidates": 4},
        "psi_quant": {"psi_quant": "int8"},
        "window": {"ctc_window": 4},
        "approx_topk": {"approx_topk": 0.95},
        "quant_window": {"psi_quant": "int8", "ctc_window": 5},
        "candidates_window": {"ctc_candidates": 6, "ctc_window": 3},
        "quant_early_stop": {"psi_quant": "int8", "early_stop": True}}
# K8's scope: the full vocab and no window
FUSED = {"candidates": False, "psi_quant": True, "window": False,
         "approx_topk": True, "quant_window": False,
         "candidates_window": False, "quant_early_stop": True}


@pytest.mark.parametrize("key", sorted(KEYS))
@pytest.mark.parametrize("seed", [0, 1])
def test_f32_beam_with_each_key_matches_jax(key, seed):
    jm, jp, jlm, jlp, pm, plm = _models(seed, VOCAB)
    cfg = dict(DECODE_CFG, **KEYS[key])
    w, wl = waves(seed)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    jb = JaxBeam(jm, cfg, lm=jlm)
    ref = jb.forward(jp, jf, jfl, lm_params=jlp)
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    dec = BeamDecoder(pm, cfg, lm=plm)
    k8 = beam_step_kernel.beam_step_fused.launches
    got = dec.forward(pf, pfl)
    np.testing.assert_array_equal(to_np(got.lengths), np.asarray(ref.lengths))
    np.testing.assert_array_equal(to_np(got.tokens), np.asarray(ref.tokens))
    np.testing.assert_allclose(to_np(got.scores), np.asarray(ref.scores),
                               rtol=1e-5, atol=0)
    # the early exit resolves as in JAX and runs as many steps
    assert dec.early_stop == jb.early_stop
    T = int(dec.last_enc.shape[1])
    S = max(1, int(np.ceil(cfg["max_len_ratio"] * T))) + 1
    assert dec.last_steps == (jb._last_steps if jb.early_stop else S)
    assert dec.last_fused is FUSED[key]
    assert beam_step_kernel.beam_step_fused.launches == k8   # CPU: no launch


def test_candidates_at_or_above_v_are_the_full_vocab():
    *_, pm, plm = _models(0, VOCAB)
    w, wl = waves(0)
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    ref = BeamDecoder(pm, DECODE_CFG, lm=plm).forward(pf, pfl)
    dec = BeamDecoder(pm, dict(DECODE_CFG, ctc_candidates=VOCAB), lm=plm)
    got = dec.forward(pf, pfl)
    assert dec.last_fused is True
    assert torch.equal(got.tokens, ref.tokens)
    assert torch.equal(got.scores, ref.scores)


@pytest.mark.parametrize("extra", [{}, {"ctc_window": 5}, {"psi_kernel": True},
                                   {"ctc_candidates": 8}])
@pytest.mark.parametrize("seed", [0, 1])
def test_amp_psi_quant_beam_matches_jax(seed, extra, jax_fused_scan,
                                        monkeypatch):
    """psi_quant under forced amp (the int8 product; K6 off even when
    psi_kernel asks for it): identical top-1, best score within 1e-4."""
    calls = _spy_psi_route(monkeypatch)
    V = 128
    jm, jp, jlm, jlp, pm, plm = _models(seed, V)
    cfg = dict(DECODE_CFG, amp=True, psi_quant="int8", **extra)
    w, wl = waves(seed)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    jcfg = dict(cfg, psi_kernel="interpret") if "psi_kernel" in extra else cfg
    ref = JaxBeam(jm, jcfg, lm=jlm).forward(jp, jf, jfl, lm_params=jlp)
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    dec = BeamDecoder(pm, cfg, lm=plm)
    got = dec.forward(pf, pfl)
    assert dec.last_amp is True and dec.early_stop is False
    _assert_top1(ref, got, 1e-4)
    assert calls and not any(k for k, _ in calls)


@pytest.mark.parametrize("key,value", [
    ("psi_quant", "int4"), ("psi_quant", True), ("ctc_window", -2),
    ("approx_topk", 1.5), ("approx_topk", -0.25)])
def test_invalid_values_raise_the_jax_errors(key, value):
    jm, *_, pm, _ = _models(0, VOCAB)
    cfg = dict(DECODE_CFG, **{key: value})
    with pytest.raises(ValueError) as ref:
        JaxBeam(jm, cfg)
    with pytest.raises(ValueError) as got:
        BeamDecoder(pm, cfg)
    assert str(got.value) == str(ref.value)


def test_window_under_psi_kernel_is_ignored_as_in_jax(capsys):
    jm, *_, pm, _ = _models(0, VOCAB)
    cfg = dict(DECODE_CFG, ctc_window=8, psi_kernel=True)
    jb = JaxBeam(jm, cfg)
    ref = capsys.readouterr().out
    dec = BeamDecoder(pm, cfg)
    assert capsys.readouterr().out == ref and "ctc_window ignored" in ref
    assert dec.ctc_window == jb.ctc_window == 0
    assert dec.early_stop is jb.early_stop is True
    for pq in (False, "int8"):      # psi_quant takes K6 off first
        d = BeamDecoder(pm, dict(cfg, psi_quant=pq))
        assert d.ctc_window == (8 if pq else 0)
        assert d.psi_kernel is (not pq)
