"""K8, the fused beam-step tail, and the beam's ``decode.fused_step`` route.

``beam_step_plain`` (what ``beam_step_fused`` runs on CPU tensors) against
the JAX package's TPU kernel ``fused_score_select`` in interpret mode, on the
inputs of ``tests/test_beam_step_kernel.py`` and at the slice's K=8, V=31
with T off the 128 grid; the whole beam on the fused route against the JAX
beam (tokens identical, scores within 1e-5) and against the port's own
unfused route (bit-equal); the route's gate, by a spy on the wrapper."""
import copy
import functools
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
from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM
from end_to_end_asr_pytorch_tpu.ops import ctc_prefix as jctc
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.pallas.beam_step_kernel import (
    fused_score_select)
from end_to_end_asr_pytorch_tpu_torch.decode import beam as port_beam
from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import beam_step_kernel as bsk
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (asr_from_arrays,
                                                            lm_from_arrays)
from tests import test_beam_step_kernel as tpu_case
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, LM_CFG, VOCAB,
                                       OnCard, jax_arrays, to_np, waves)

torch.set_num_threads(1)
NEG_INF = -1e30
EOS, PAD = tpu_case.EOS, tpu_case.PAD
AW, CW, LW = tpu_case.AW, tpu_case.CW, tpu_case.LW


def _slice_inputs(t, seed, B=4, K=8, V=31, T=45):
    """tpu_case._inputs' construction at the slice's K and V, T = 45 frames
    (its padded grid Tp = 128 for the TPU kernel), with live and dead slots
    and a partly filled finished set."""
    rng = np.random.RandomState(seed)
    Tp = 128
    att = rng.randn(B, K, V).astype(np.float32) * 2
    lm = rng.randn(B, K, V).astype(np.float32) * 2
    base = rng.randn(B, K).astype(np.float32)
    valid = np.ones((B, K), bool)
    if t == 0:
        valid[:, 1:] = False
    else:
        valid[1, 5] = valid[2, 0] = False
    last = rng.randint(2, V, (B, K)).astype(np.int32)
    fin_norm = np.full((B, K), NEG_INF, np.float32)
    fin_meta = np.zeros((B, K), np.int32)
    if t > 0:
        fin_norm[:, :3] = rng.randn(B, 3) - 5.0
        fin_meta[:, :3] = (rng.randint(1, t + 1, (B, 3)) << 8) \
            + rng.randint(0, K, (B, 3))
    enc_len = rng.randint(T // 2, T + 1, (B,)).astype(np.int32)
    enc_len[0] = T
    lp = jax.nn.log_softmax(jnp.asarray(rng.randn(B, Tp, V).astype(np.float32)),
                            axis=-1)
    lp = jctc.pad_ctc_log_probs(lp, jnp.asarray(enc_len))
    r, _ = jctc.init_state(lp, K)
    if t > 0:
        _, r_new = jctc.score_candidates(
            lp, r, jnp.asarray(last), jnp.zeros((B, K), jnp.int32),
            cand_ids=jnp.asarray(last)[..., None])
        r = r_new[:, :, 0]
    min_len = np.maximum((0.05 * enc_len).astype(np.int32), 0)
    max_len = np.maximum((0.6 * enc_len).astype(np.int32), 1)
    return (jnp.asarray(att), jnp.asarray(lm), jnp.asarray(base),
            jnp.asarray(valid), jnp.asarray(last), jnp.asarray(fin_norm),
            jnp.asarray(fin_meta), r, lp, jnp.asarray(min_len),
            jnp.asarray(max_len)), T


def _port_args(t, ins, T):
    """The JAX-side inputs as the port's beam carries them, cut to T."""
    (att, lm, base, valid, last, fin_norm, fin_meta, r, lp, min_len,
     max_len) = [np.asarray(x) for x in ins]
    f = lambda a: torch.from_numpy(np.array(a))
    return (t, f(att), f(lm), f(base), f(valid), f(last).long(), f(fin_norm),
            f(fin_meta).long(), f(r[:, :, :T]), f(lp[:, :T]),
            f(min_len), f(max_len))


def _tpu_kernel(t, ins, V):
    """fused_score_select in interpret mode, laid out as
    tests/test_beam_step_kernel.py lays it out (Vp = 128 lanes, (B, V, Tp))."""
    (att, lm, base, valid, last, fin_norm, fin_meta, r, lp, min_len,
     max_len) = ins
    pad = lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, 128 - V)),
                            constant_values=NEG_INF)
    return fused_score_select(
        t, pad(att), pad(lm), base, valid, last, fin_norm, fin_meta,
        r[..., 0], r[..., 1], jnp.swapaxes(lp, 1, 2), min_len[:, None],
        max_len[:, None], aw=AW, cw=CW, lw=LW, V=V, eos_idx=EOS,
        pad_idx=PAD, blank=0, interpret=True)


def _ref_psi_pick(t, ins, v_idx, k_idx):
    """The psi that ``_ref_step`` gathers for the winners (its ``psi_g``)."""
    _, _, _, _, last, _, _, r, lp, _, _ = ins
    B, K = last.shape
    psi, _ = jctc.score_candidates(lp, r, last, jnp.full((B, K), t, jnp.int32),
                                   with_state=False)
    return np.asarray(psi)[np.arange(B)[:, None], k_idx, v_idx]


def _check_against_tpu_kernel(t, ins, V, T):
    got = bsk.beam_step_plain(*_port_args(t, ins, T), aw=AW, cw=CW, lw=LW,
                              eos=EOS, pad=PAD)
    ref = _tpu_kernel(t, ins, V)
    live = np.asarray(ref.new_valid).astype(bool)
    np.testing.assert_array_equal(to_np(got.new_valid), live)
    for name in ("v_idx", "k_idx"):
        np.testing.assert_array_equal(to_np(getattr(got, name))[live],
                                      np.asarray(getattr(ref, name))[live])
    np.testing.assert_allclose(to_np(got.new_base)[live],
                               np.asarray(ref.new_base)[live],
                               rtol=1e-5, atol=1e-5)
    # real finished scores only: the TPU kernel masks eos before dividing by
    # t + 1 (its placeholders are -1e30 / (t + 1)), the JAX beam and the
    # port after (-1e30), decode/beam.py
    fin = np.asarray(ref.fin_norm) > NEG_INF / (2 * (t + 1))
    np.testing.assert_allclose(to_np(got.fin_norm)[fin],
                               np.asarray(ref.fin_norm)[fin],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(to_np(got.fin_meta)[fin],
                                  np.asarray(ref.fin_meta)[fin])
    ref_r = np.stack([np.asarray(ref.r_nb), np.asarray(ref.r_b)], -1)[:, :, :T]
    got_r = to_np(got.r)
    sane = ref_r[live] > NEG_INF / 2
    np.testing.assert_allclose(got_r[live][sane], ref_r[live][sane],
                               rtol=1e-4, atol=1e-4)
    psi_ref = _ref_psi_pick(t, ins, to_np(got.v_idx), to_np(got.k_idx))
    np.testing.assert_allclose(to_np(got.psi_pick)[live], psi_ref[live],
                               rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("t", [0, 3])
def test_plain_matches_tpu_kernel_on_its_own_inputs(t):
    ins = tpu_case._inputs(t, seed=t)
    _check_against_tpu_kernel(t, ins, tpu_case.V, tpu_case.Tp)


@pytest.mark.parametrize("t", [0, 2])
def test_plain_matches_tpu_kernel_at_slice_widths_off_the_128_grid(t):
    ins, T = _slice_inputs(t, seed=10 + t)
    got = _check_against_tpu_kernel(t, ins, 31, T)
    if t == 0:
        # step 0: only slot 0 lives, and every winner extends it
        assert np.all(to_np(got.k_idx) == 0)


def test_fused_on_cpu_tensors_is_the_plain_version():
    ins, T = _slice_inputs(2, seed=5)
    args = _port_args(2, ins, T)
    kw = dict(aw=AW, cw=CW, lw=LW, eos=EOS, pad=PAD)
    n0 = bsk.beam_step_fused.launches
    got = bsk.beam_step_fused(*args, **kw)
    ref = bsk.beam_step_plain(*args, **kw)
    assert bsk.beam_step_fused.launches == n0 == 0
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    no_lm = bsk.beam_step_fused(*args[:2], None, *args[3:], **kw)
    assert no_lm.v_idx.dtype == torch.int64 and no_lm.r.shape == args[8].shape


@pytest.mark.parametrize("bad", ["f64_logits", "int32_last", "strided_r",
                                 "int64_len"])
def test_fused_rejects_other_dtypes_and_layouts(bad):
    ins, T = _slice_inputs(2, seed=6)
    args = list(_port_args(2, ins, T))
    if bad == "f64_logits":
        args[1] = args[1].double()
    elif bad == "int32_last":
        args[5] = args[5].int()
    elif bad == "strided_r":
        args[8] = args[8].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        args[11] = args[11].long()
    with pytest.raises(ValueError, match="beam_step_fused"):
        bsk.beam_step_fused(*args, aw=AW, cw=CW, lw=LW, eos=EOS, pad=PAD)


# ------------------------------------------------------------ the beam route
DECODE_CFG = {"beam_size": 4, "min_len_ratio": 0.05, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3}


@functools.lru_cache(maxsize=None)
def _models(seed, use_pallas=False):
    cfg = copy.deepcopy(ASR_CFG)
    if use_pallas:
        cfg["attention"]["use_pallas"] = True
    jm = JaxASR(40, VOCAB, ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(seed))
    jlm = JaxLM(VOCAB, LM_CFG)
    jlp = jlm.init(jax.random.PRNGKey(100 + seed))
    pm = asr_from_arrays(40, VOCAB, cfg, jax_arrays(jp), device="cpu")
    plm = lm_from_arrays(VOCAB, LM_CFG, jax_arrays(jlp), device="cpu")
    return jm, jp, jlm, jlp, pm, plm


def _feats(seed):
    w, wl = waves(seed)
    pf = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                torch.from_numpy(wl))
    jf = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    return pf, jf


@pytest.mark.parametrize("case", ["lm_early_stop", "lm_all_steps",
                                  "no_lm", "use_pallas"])
def test_fused_route_matches_jax_beam_and_the_unfused_route(case):
    seed = {"lm_early_stop": 0, "lm_all_steps": 1, "no_lm": 2,
            "use_pallas": 3}[case]
    jm, jp, jlm, jlp, pm, plm = _models(seed, case == "use_pallas")
    use_lm = case != "no_lm"
    cfg = dict(DECODE_CFG, early_stop=case != "lm_all_steps",
               lm_weight=0.3 if use_lm else 0.0, fused_step=True)
    (pf, pfl), (jf, jfl) = _feats(seed)
    # the JAX decoder reads its keys with .get: fused_step is ignored
    ref = JaxBeam(jm, cfg, lm=jlm if use_lm else None).forward(
        jp, jf, jfl, lm_params=jlp if use_lm else None)
    dec = BeamDecoder(pm, cfg, lm=plm if use_lm else None)
    got = dec.forward(pf, pfl)
    assert dec.last_fused is True
    np.testing.assert_array_equal(to_np(got.tokens), np.asarray(ref.tokens))
    np.testing.assert_array_equal(to_np(got.lengths), np.asarray(ref.lengths))
    np.testing.assert_allclose(to_np(got.scores), np.asarray(ref.scores),
                               atol=1e-5, rtol=0)
    unfused = BeamDecoder(pm, dict(cfg, fused_step=False),
                          lm=plm if use_lm else None)
    plain = unfused.forward(pf, pfl)
    assert unfused.last_fused is False
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_jax_decoder_ignores_fused_step():
    jm, jp, jlm, jlp, _, _ = _models(0)
    _, (jf, jfl) = _feats(0)
    a = JaxBeam(jm, DECODE_CFG, lm=jlm).forward(jp, jf, jfl, lm_params=jlp)
    b = JaxBeam(jm, dict(DECODE_CFG, fused_step=True), lm=jlm).forward(
        jp, jf, jfl, lm_params=jlp)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("case,calls", [
    ("fused", "steps"), ("fused_card_f32", "steps"), ("amp", 0),
    ("amp_auto_on_card", 0), ("no_ctc", 0), ("off", 0), ("auto", "steps"),
    ("absent", "steps")])
def test_fused_route_gate(monkeypatch, case, calls):
    """beam_step_fused runs once per step inside K8's gate (CTC on, amp
    resolved off, fused_step not false; absent and auto open it as true
    does) and never outside it."""
    seen = []
    real = port_beam.beam_step_fused

    def spy(*args, **kw):
        seen.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(port_beam, "beam_step_fused", spy)
    _, _, _, _, pm, plm = _models(0)
    cfg = dict(DECODE_CFG, fused_step=True, amp=False)
    if case == "amp":
        cfg["amp"] = True
    elif case == "amp_auto_on_card":
        cfg["amp"] = "auto"
    elif case == "no_ctc":
        cfg["ctc_weight"] = 0.0
    elif case in ("off", "auto"):
        cfg["fused_step"] = False if case == "off" else "auto"
    elif case == "absent":
        del cfg["fused_step"]
    (pf, pfl), _ = _feats(0)
    if case in ("fused_card_f32", "amp_auto_on_card"):
        pf = pf.as_subclass(OnCard)
    dec = BeamDecoder(pm, cfg, lm=plm)
    dec.forward(pf, pfl)
    assert dec.last_amp is (case in ("amp", "amp_auto_on_card"))
    assert dec.last_fused is (calls == "steps")
    assert seen == (list(range(dec.last_steps)) if calls == "steps" else [])
    assert bsk.beam_step_fused.launches == 0
