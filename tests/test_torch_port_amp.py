"""The port's decode amp (bf16) path and K6 against the JAX package on the CPU.

Held here: K6's plain version against the TPU kernel in interpret mode and
against the JAX CTC prefix scorer, with bf16 and with f32 probs; K2's bf16
variant's plain version against the TPU kernel in interpret mode with bf16
x_proj; the amp pieces (CTC prep, decoder and LM tables, the beam-step
logits, the LM step); and whole amp beam decodes at V=31 and at V=128 with
K6, and the f32 decode at V=128 with K6.

Where the JAX package runs an LSTM over time, these tests send it through
its TPU kernel in interpret mode (``USE_FUSED_SCAN`` and an
``interpret=True`` wrapper, set from the test side only): on the CPU it
would otherwise take its ``lax.scan``, whose carries are rounded to bf16
each step, while the TPU kernel and the port keep f32 carries.

Tolerances, with their reasons:
  * K6 plain vs interpret: rtol = atol = 2e-5 on finite entries (f32 sums
    in another order), the blank and last-token columns bit-equal;
  * bf16 outputs (K2's ys, the lookup tables): within 1 bf16 ulp (the f32
    value before rounding differs in the last bits);
  * amp beam: identical top-1 tokens on every row, best score within 1e-4
    (measured <= 2.1e-5: XLA may keep bf16 elementwise chains in f32 where
    eager PyTorch rounds after each op);
  * the f32 decode keeps test_torch_port_decode.py's exact-path tolerances
    (identical tokens, scores atol 1e-4).
"""
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
from end_to_end_asr_pytorch_tpu.ops import rnn as jrnn
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.pallas import att_kernel as jak
from end_to_end_asr_pytorch_tpu.ops.pallas import lstm_kernel as jlk
from end_to_end_asr_pytorch_tpu.ops.pallas.psi_kernel import psi_fused as jpsi
from end_to_end_asr_pytorch_tpu_torch.decode import beam as port_beam
from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
from end_to_end_asr_pytorch_tpu_torch.models import attention as port_attention
from end_to_end_asr_pytorch_tpu_torch.ops import ctc_prefix
from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
from end_to_end_asr_pytorch_tpu_torch.ops import rnn
from end_to_end_asr_pytorch_tpu_torch.ops.amp import bf16_rounded_copy
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel, psi_kernel
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    asr_from_arrays, lm_from_arrays)
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, LM_CFG,
                                       jax_arrays, to_np, waves)

torch.set_num_threads(1)
BF = torch.bfloat16
NEG_INF = -1e30
DECODE_CFG = {"beam_size": 4, "min_len_ratio": 0.05, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3}


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def assert_within_bf16_ulp(got, ref):
    """|got - ref| <= 1 ulp of bf16 at the larger magnitude (8 significant
    bits: 2^-7 of it, which is at least one ulp)."""
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    tol = np.maximum(np.abs(g), np.abs(r)) * 2.0 ** -7
    bad = np.abs(g - r) > tol
    assert not bad.any(), (np.abs(g - r)[bad].max(), int(bad.sum()))


@pytest.fixture()
def jax_fused_scan(monkeypatch):
    """The JAX package's LSTM scans through its TPU kernel in interpret
    mode (its carries stay f32), from the test side only."""
    monkeypatch.setattr(jrnn, "USE_FUSED_SCAN", True)
    orig = jlk.lstm_scan_fused
    monkeypatch.setattr(jlk, "lstm_scan_fused",
                        lambda x, w, m, r=False, interpret=False:
                        orig(x, w, m, r, True))


# ------------------------------------------------------------------- K6
def _psi_inputs(B=3, K=4, T=18, V=256, seed=0):
    """A mid-decode CTC state, as tests/test_psi_kernel.py builds it."""
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
    return np.array(lp), np.array(r2[:, :, 0]), last2, np.array(plen) + 1


def _probs(lp, dtype):
    p = np.exp(lp)
    return ((jnp.asarray(p).astype(jnp.bfloat16), torch.from_numpy(p).to(BF))
            if dtype == "bf16" else (jnp.asarray(p), torch.from_numpy(p)))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("V,T", [(128, 18), (256, 9)])
def test_psi_kernel_plain_matches_jax_scorers(V, T, dtype):
    """The port's psi-only scorer with psi_kernel (K6's plain version on the
    CPU) against the JAX scorer through its Pallas kernel in interpret mode,
    and against the JAX scorer's einsum path; without psi_kernel the port's
    own einsum path too."""
    lp, r, last, plen = _psi_inputs(V=V, T=T, seed=V + T)
    jp, pp = _probs(lp, dtype)
    jargs = (jnp.asarray(lp), jnp.asarray(r), jnp.asarray(last),
             jnp.asarray(plen))
    ref_k, _ = jctc.score_candidates(*jargs, with_state=False, probs=jp,
                                     psi_pallas="interpret")
    ref_e, _ = jctc.score_candidates(*jargs, with_state=False, probs=jp)
    pargs = (torch.from_numpy(lp), torch.from_numpy(r),
             torch.from_numpy(last).long(), torch.from_numpy(plen))
    n0 = psi_kernel.psi_fused.launches
    got_k, _ = ctc_prefix.score_candidates(*pargs, with_state=False, probs=pp,
                                           psi_kernel=True)
    got_e, _ = ctc_prefix.score_candidates(*pargs, with_state=False, probs=pp)
    assert psi_kernel.psi_fused.launches == n0 == 0
    for got, ref in ((got_k, ref_k), (got_k, ref_e), (got_e, ref_e)):
        got, ref = to_np(got), np.asarray(ref)
        assert got.dtype == ref.dtype == np.float32
        mask = ref > NEG_INF / 2
        np.testing.assert_allclose(got[mask], ref[mask], rtol=2e-5, atol=2e-5)
        assert np.all(got[:, :, 0] == NEG_INF)
    # both routes merge the same psi_same (each framework computes its own,
    # so against JAX the last-token column is held to the tolerance above)
    last_col = lambda x: np.take_along_axis(to_np(x), last[..., None], axis=2)
    np.testing.assert_array_equal(last_col(got_k), last_col(got_e))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_psi_plain_edges_match_pallas_interpret(dtype):
    """K6's plain version against psi_fused(interpret=True) on raw inputs:
    last == blank (blank wins), last at block edges, a frame-padded row, and
    an all-zero probs column, which must give md - 87.4982 (finite)."""
    B, K, T, V = 3, 8, 12, 256
    rng = np.random.RandomState(7)
    p = rng.dirichlet(np.ones(V) * 0.3, size=(B, T)).astype(np.float32)
    p[2, 8:] = 0.0
    p[2, 8:, 0] = 1.0                               # padded frames: blank only
    p[:, :, 77] = 0.0                               # an all-zero column
    wd = np.exp(-rng.uniform(0, 6, (B, K, T))).astype(np.float32)
    md = rng.uniform(-60, -1, (B, K)).astype(np.float32)
    ps = rng.uniform(-60, -1, (B, K)).astype(np.float32)
    last = np.array([0, 127, 128, 255, 1, 77, 3, 129] * B,
                    np.int32).reshape(B, K)
    if dtype == "bf16":
        jp = jnp.asarray(p).astype(jnp.bfloat16)
        pp = torch.from_numpy(p).to(BF)
    else:
        jp, pp = jnp.asarray(p), torch.from_numpy(p)
    ref = np.asarray(jpsi(jnp.asarray(wd), jp, jnp.asarray(md),
                          jnp.asarray(ps), jnp.asarray(last), interpret=True))
    t = torch.from_numpy
    got = to_np(psi_kernel.psi_fused(t(wd), pp, t(md), t(ps), t(last)))
    mask = ref > NEG_INF / 2
    np.testing.assert_allclose(got[mask], ref[mask], rtol=2e-5, atol=2e-5)
    assert np.all(got[:, :, 0] == NEG_INF) and np.all(ref[:, :, 0] == NEG_INF)
    same = np.take_along_axis(got, last[..., None], axis=2)[..., 0]
    np.testing.assert_array_equal(np.where(last == 0, NEG_INF, ps), same)
    zero_col = got[:, :, 77]
    expect = np.where(last == 77, ps, md + np.log(np.float32(1e-38)))
    np.testing.assert_allclose(zero_col, expect, rtol=0, atol=2e-5)
    assert np.isfinite(zero_col).all()
    assert abs(float(np.log(np.float32(1e-38))) + 87.4982) < 1e-3


def test_psi_fused_rejects_bad_inputs():
    B, K, T, V = 2, 3, 5, 128
    z = lambda *s: torch.zeros(s)
    last = torch.zeros(B, K, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        psi_kernel.psi_fused(z(B, K, T), z(B, T, V), z(B, K), z(B, K),
                             last.long())
    with pytest.raises(ValueError, match="bf16 or f32"):
        psi_kernel.psi_fused(z(B, K, T), z(B, T, V).half(), z(B, K),
                             z(B, K), last)
    with pytest.raises(ValueError, match="contiguous"):
        psi_kernel.psi_fused(z(B, T, K).transpose(1, 2), z(B, T, V), z(B, K),
                             z(B, K), last)


def test_pick_block_is_the_jax_gate():
    from end_to_end_asr_pytorch_tpu.ops.pallas.psi_kernel import (
        pick_block as jpick)
    for V in (31, 128, 256, 1000, 1024, 5120, 16384):
        for T in (9, 176, 704, 5000):
            for itemsize in (2, 4):
                assert (psi_kernel.pick_block(V, T, itemsize)
                        == jpick(V, T, itemsize))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a card tensor: the route the
    scorer picks there."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kernels", [True, False])
def test_card_probs_take_k6_by_the_switch_alone(monkeypatch, kernels):
    routes = []

    def rec(name):
        def run(wd, probs, md, ps, last, blank):
            routes.append(name)
            return torch.zeros(wd.shape[:2] + probs.shape[-1:])
        return run

    monkeypatch.setattr(ctc_prefix, "psi_fused", rec("fused"))
    monkeypatch.setattr(ctc_prefix, "psi_plain", rec("plain"))
    monkeypatch.setattr(cuda_kernels, "USE_KERNELS", kernels)
    lp, r, last, plen = _psi_inputs(V=128, T=9, seed=1)
    probs = torch.from_numpy(np.exp(lp)).to(BF).as_subclass(_OnCard)
    ctc_prefix.score_candidates(torch.from_numpy(lp), torch.from_numpy(r),
                                torch.from_numpy(last).long(),
                                torch.from_numpy(plen), with_state=False,
                                probs=probs, psi_kernel=True)
    assert routes == ["fused" if kernels else "plain"]


# ------------------------------------------------------------- K2 bf16
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_bf16_plain_matches_pallas_interpret(reverse):
    """lstm_scan_bf16 (its plain version on the CPU) against the TPU
    kernel in interpret mode on bf16 x_proj: f32 carries, bf16 ys."""
    T, B, H = 9, 3, 16
    rng = np.random.RandomState(5 + reverse)
    xp = (rng.randn(T, B, 4 * H) * 0.8).astype(np.float32)
    w = rng.uniform(-0.25, 0.25, (H, 4 * H)).astype(np.float32)
    lens = np.array([T, 6, 1])
    mask = np.arange(T)[:, None] < lens[None, :]
    xb = jnp.asarray(xp).astype(jnp.bfloat16)
    ref = jlk.lstm_scan_fused(xb, jnp.asarray(w), jnp.asarray(mask), reverse,
                              True)
    n0 = lstm_kernel.lstm_scan_bf16.launches
    got = lstm_kernel.lstm_scan_fused(torch.from_numpy(xp).to(BF),
                                      torch.from_numpy(w),
                                      torch.from_numpy(mask), reverse)
    assert lstm_kernel.lstm_scan_bf16.launches == n0 == 0
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    assert_within_bf16_ulp(got, ref)
    assert np.all(_f32(got)[~mask] == 0.0)


def test_k2_bf16_rejects_residuals_and_f16():
    """bf16 x_proj with residuals is amp training's route (it once raised
    here): it returns ys and the residuals in bf16. f16 x_proj and a bf16
    W_hh still raise."""
    T, B, H = 4, 2, 8
    xp = torch.zeros(T, B, 4 * H, dtype=BF)
    w = torch.zeros(H, 4 * H)
    mask = torch.ones(T, B, dtype=torch.bool)
    out = lstm_kernel.lstm_scan_fused(xp, w, mask, residuals=True)
    assert [t.dtype for t in out] == [BF] * 3
    assert [tuple(t.shape) for t in out] == [(T, B, H)] * 2 + [(T, B, 4 * H)]
    with pytest.raises(ValueError, match="bfloat16"):
        lstm_kernel.lstm_scan_bf16(xp.half(), w, mask)
    with pytest.raises(ValueError, match="float32"):
        lstm_kernel.lstm_scan_bf16(xp, w.to(BF), mask)


def test_lstm_scan_amp_matches_jax(jax_fused_scan):
    """rnn.lstm_scan on weights rounded to bf16 and bf16 input: x_proj
    rounded to bf16, K2's bf16 contract, bf16 ys."""
    T, B, D, H = 10, 3, 12, 16
    w = jrnn.init_lstm(jax.random.PRNGKey(3), D, H)
    wb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), w)
    rng = np.random.RandomState(3)
    x = rng.randn(T, B, D).astype(np.float32)
    mask = np.arange(T)[:, None] < np.array([T, 7, 2])[None, :]
    ref = jrnn.lstm_scan(wb, jnp.asarray(x).astype(jnp.bfloat16),
                         jnp.asarray(mask), reverse=True)
    pw = rnn.LSTMWeights(D, H, device="cpu")
    for name in ("w_ih", "w_hh", "b"):
        getattr(pw, name).data.copy_(torch.from_numpy(
            np.asarray(getattr(w, name))))
    got = rnn.lstm_scan(bf16_rounded_copy(pw), torch.from_numpy(x).to(BF),
                        torch.from_numpy(mask), reverse=True)
    assert got.dtype == BF
    assert_within_bf16_ulp(got, ref)


# ------------------------------------------------------------ amp pieces
V_SMALL = 31


@functools.lru_cache(maxsize=None)
def _models(seed, V):
    jm = JaxASR(40, V, ASR_CFG)
    jp = jm.init(jax.random.PRNGKey(seed))
    jlm = JaxLM(V, LM_CFG)
    jlp = jlm.init(jax.random.PRNGKey(100 + seed))
    pm = asr_from_arrays(40, V, ASR_CFG, jax_arrays(jp), device="cpu")
    plm = lm_from_arrays(V, LM_CFG, jax_arrays(jlp), device="cpu")
    return jm, jp, jlm, jlp, pm, plm


def _cast(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
        tree)


def test_bf16_copy_leaves_the_model_f32():
    """The amp call's copy holds every weight rounded to bf16, kept in f32
    (so a product reads it as it is); the caller's model is not rounded."""
    *_, pm, _ = _models(0, V_SMALL)
    amp = bf16_rounded_copy(pm)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert all(p.dtype == torch.float32 for p in amp.parameters())
    rounded = []
    for (n, a), (_, b) in zip(pm.named_parameters(), amp.named_parameters()):
        assert torch.equal(a.to(BF).float(), b), n
        rounded.append(not torch.equal(a, b))
    assert any(rounded)


def test_amp_ctc_prep_matches_jax():
    jm, jp, *_, pm, _ = _models(0, V_SMALL)
    rng = np.random.RandomState(8)
    enc = rng.randn(2, 9, jm.encoder.out_dim).astype(np.float32)
    elen = np.array([9, 5], np.int32)
    pb = _cast(jp)
    jenc = jnp.asarray(enc).astype(jnp.bfloat16)
    logits = jm.ctc_logits(pb, jenc)
    lse = jax.nn.logsumexp(logits, axis=-1, keepdims=True)
    ref_lp = jctc.pad_ctc_log_probs(logits - lse, jnp.asarray(elen))
    ref_p = jnp.exp(ref_lp.astype(jnp.bfloat16))
    lp, probs = port_beam.ctc_prep(bf16_rounded_copy(pm),
                                   torch.from_numpy(enc).to(BF),
                                   torch.from_numpy(elen), amp=True)
    assert lp.dtype == torch.float32 and probs.dtype == BF
    np.testing.assert_allclose(to_np(lp), np.asarray(ref_lp), rtol=0,
                               atol=1e-5)
    assert_within_bf16_ulp(probs, ref_p)


def test_amp_tables_step_and_lm_match_jax():
    """The bf16 lookup tables, one amp beam step's logits, state and
    alignment through the tables, and the LM step through its table."""
    jm, jp, jlm, jlp, pm, plm = _models(6, V_SMALL)
    B, K, T = 2, 3, 7
    rng = np.random.RandomState(6)
    enc = rng.randn(B, T, jm.encoder.out_dim).astype(np.float32)
    elen = np.asarray([7, 4], np.int32)
    tok = rng.randint(0, V_SMALL, size=(B * K,))
    pb, lb = _cast(jp), _cast(jlp)
    jenc = jnp.asarray(enc).astype(jnp.bfloat16)
    jc = jm.attention.precompute(pb.attention, jenc, jnp.asarray(elen),
                                 amp=True)
    jt = jm.precompute_decode_tables(pb)
    jst = jm.decoder.init_state(B * K, jnp.bfloat16)
    jst = jst._replace(h=jnp.asarray(rng.randn(*jst.h.shape) * 0.5,
                                     jnp.bfloat16),
                       c=jnp.asarray(rng.randn(*jst.c.shape) * 0.5,
                                     jnp.bfloat16))
    jal = jnp.broadcast_to(jm.attention.init_align(jc)[:, None], (B, K, 1, T))
    rl, rst, ral, rctx = jm.decode_step_beam(pb, jc, jst, jal,
                                             jnp.asarray(tok), K, tables=jt)
    am, alm = bf16_rounded_copy(pm), bf16_rounded_copy(plm)
    pt = am.precompute_decode_tables(amp=True)
    assert torch.equal(pt["emb_proj"].to(BF).float(), pt["emb_proj"])
    assert_within_bf16_ulp(pt["emb_proj"], jt["emb_proj"])
    pc = am.attention.precompute(torch.from_numpy(enc).to(BF),
                                 torch.from_numpy(elen), amp=True)
    assert pc.keys.dtype == pc.values.dtype == BF
    assert_within_bf16_ulp(pc.keys, jc.keys[..., :jm.attention.dim])
    pst = am.decoder.init_state(B * K, "cpu", BF)._replace(
        h=torch.from_numpy(_f32(jst.h)).to(BF),
        c=torch.from_numpy(_f32(jst.c)).to(BF))
    pal = am.attention.init_align(pc)[:, None].expand(B, K, 1, T)
    gl, gst, gal, gctx = am.decode_step_beam(pc, pst, pal,
                                             torch.from_numpy(tok), K,
                                             tables=pt)
    assert gl.dtype == gal.dtype == gctx.dtype == torch.float32
    assert gst.h.dtype == gst.c.dtype == BF
    np.testing.assert_allclose(to_np(gal), np.asarray(ral), rtol=0, atol=1e-3)
    np.testing.assert_allclose(to_np(gctx), np.asarray(rctx), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(to_np(gl), np.asarray(rl), rtol=0, atol=5e-3)
    assert_within_bf16_ulp(gst.h, rst.h)
    jemb = jlm.emb_proj_table(lb)
    pemb = alm.emb_proj_table(amp=True)
    assert torch.equal(pemb.to(BF).float(), pemb)
    assert_within_bf16_ulp(pemb, jemb)
    rlm, rls = jlm.step(lb, jlm.init_state(B * K, jnp.bfloat16),
                        jnp.asarray(tok), emb_proj=jemb)
    glm, gls = alm.step(alm.init_state(B * K, "cpu", BF),
                        torch.from_numpy(tok), emb_proj=pemb)
    assert glm.dtype == torch.float32 and gls.h.dtype == BF
    np.testing.assert_allclose(to_np(glm), np.asarray(rlm), rtol=0, atol=2e-3)
    assert_within_bf16_ulp(gls.c, rls.c)


def test_amp_step_with_use_pallas_matches_jax(monkeypatch):
    """One amp beam step through K5's route (its plain version on the CPU):
    the bf16 keys and values widened to f32 for it, the weights as rounded
    for the call; against the JAX package's amp step through its Pallas
    kernel in interpret mode. atol 1e-5 (measured <= 1.2e-7: the chain into
    K5 is f32 on both sides)."""
    orig = jak.loc_attention_fused
    monkeypatch.setattr(jak, "loc_attention_fused",
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))
    routes = []
    plain = port_attention.loc_attention_plain
    monkeypatch.setattr(port_attention, "loc_attention_plain",
                        lambda *a: routes.append(1) or plain(*a))
    cfg = copy.deepcopy(ASR_CFG)
    cfg["attention"]["use_pallas"] = True
    jm = JaxASR(40, V_SMALL, cfg)
    jp = jm.init(jax.random.PRNGKey(9))
    pm = asr_from_arrays(40, V_SMALL, cfg, jax_arrays(jp), device="cpu")
    B, K, T = 2, 3, 7
    rng = np.random.RandomState(9)
    enc = rng.randn(B, T, jm.encoder.out_dim).astype(np.float32)
    elen = np.asarray([7, 4], np.int32)
    tok = rng.randint(0, V_SMALL, size=(B * K,))
    pb = _cast(jp)
    jc = jm.attention.precompute(pb.attention,
                                 jnp.asarray(enc).astype(jnp.bfloat16),
                                 jnp.asarray(elen), amp=True)
    jst = jm.decoder.init_state(B * K, jnp.bfloat16)
    jst = jst._replace(h=jnp.asarray(rng.randn(*jst.h.shape) * 0.5,
                                     jnp.bfloat16),
                       c=jnp.asarray(rng.randn(*jst.c.shape) * 0.5,
                                     jnp.bfloat16))
    prev = rng.uniform(0.0, 0.3, size=(B, K, 1, T)).astype(np.float32)
    rl, rst, ral, rctx = jm.decode_step_beam(
        pb, jc, jst, jnp.asarray(prev), jnp.asarray(tok), K,
        tables=jm.precompute_decode_tables(pb))
    am = bf16_rounded_copy(pm)
    pc = am.attention.precompute(torch.from_numpy(enc).to(BF),
                                 torch.from_numpy(elen), amp=True)
    pst = am.decoder.init_state(B * K, "cpu", BF)._replace(
        h=torch.from_numpy(_f32(jst.h)).to(BF),
        c=torch.from_numpy(_f32(jst.c)).to(BF))
    gl, gst, gal, gctx = am.decode_step_beam(
        pc, pst, torch.from_numpy(prev), torch.from_numpy(tok), K,
        tables=am.precompute_decode_tables(amp=True))
    assert routes == [1]
    assert gl.dtype == gal.dtype == gctx.dtype == torch.float32
    for got, ref in ((gal, ral), (gctx, rctx), (gl, rl)):
        np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0,
                                   atol=1e-5)
    assert_within_bf16_ulp(gst.h, rst.h)


# ------------------------------------------------------------ amp beam
def _decode_both(seed, V, cfg, jcfg=None):
    jm, jp, jlm, jlp, pm, plm = _models(seed, V)
    w, wl = waves(seed)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    ref = JaxBeam(jm, jcfg or cfg, lm=jlm).forward(jp, jf, jfl,
                                                   lm_params=jlp)
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    dec = BeamDecoder(pm, cfg, lm=plm)
    got = dec.forward(pf, pfl)
    assert dec.last_amp == bool(cfg.get("amp"))
    return ref, got


def _assert_top1(ref, got, score_atol):
    rt, rl = np.asarray(ref.tokens), np.asarray(ref.lengths)
    gt, gl = to_np(got.tokens), to_np(got.lengths)
    for b in range(rt.shape[0]):
        assert gl[b, 0] == rl[b, 0]
        np.testing.assert_array_equal(gt[b, 0, :gl[b, 0]], rt[b, 0, :rl[b, 0]])
    np.testing.assert_allclose(to_np(got.scores)[:, 0],
                               np.asarray(ref.scores)[:, 0], rtol=0,
                               atol=score_atol)


def _spy_psi_route(monkeypatch):
    """(psi_kernel, probs dtype) of every psi-only call of the beam's
    scorer: whether it took K6's route, and with which probs."""
    calls = []
    orig = ctc_prefix.score_candidates

    def spy(*a, **kw):
        if not kw.get("with_state", True):
            calls.append((kw.get("psi_kernel", False), kw["probs"].dtype))
        return orig(*a, **kw)

    monkeypatch.setattr(ctc_prefix, "score_candidates", spy)
    return calls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_amp_beam_matches_jax_at_v31(seed, jax_fused_scan):
    cfg = dict(DECODE_CFG, amp=True)
    ref, got = _decode_both(seed, V_SMALL, cfg)
    _assert_top1(ref, got, 1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_amp_beam_with_psi_kernel_matches_jax_at_v128(seed, jax_fused_scan,
                                                      monkeypatch):
    """K6's gate opens at V=128 under amp (bf16 probs): the port's scorer
    takes K6's route once per beam step (its plain version on the CPU)."""
    calls = _spy_psi_route(monkeypatch)
    n0 = (psi_kernel.psi_fused.launches, lstm_kernel.lstm_scan_bf16.launches,
          lstm_kernel.lstm_scan_fused.launches)
    cfg = dict(DECODE_CFG, amp=True, psi_kernel=True)
    ref, got = _decode_both(seed, 128, cfg, dict(cfg, psi_kernel="interpret"))
    _assert_top1(ref, got, 1e-4)
    assert len(calls) > 0 and set(calls) == {(True, BF)}
    # CPU tensors: the plain versions, no kernel launch
    assert (psi_kernel.psi_fused.launches, lstm_kernel.lstm_scan_bf16.launches,
            lstm_kernel.lstm_scan_fused.launches) == n0 == (0, 0, 0)


def test_amp_beam_fold_logp_matches_jax(jax_fused_scan):
    """fold_logp forced on at V=128 (auto folds only from V=1024)."""
    cfg = dict(DECODE_CFG, amp=True, fold_logp=True)
    ref, got = _decode_both(3, 128, cfg)
    _assert_top1(ref, got, 1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_beam_with_psi_kernel_matches_jax_at_v128(seed, monkeypatch):
    """Without amp the gate is evaluated with f32 probs and K6 takes them
    as they are: the exact path's tolerances hold. K8's route leaves psi
    to K8, so the step tail runs K8's plain version (fused_step false)."""
    calls = _spy_psi_route(monkeypatch)
    cfg = dict(DECODE_CFG, amp=False, psi_kernel=True, fused_step=False)
    ref, got = _decode_both(seed, 128, cfg, dict(cfg, psi_kernel="interpret"))
    np.testing.assert_array_equal(to_np(got.lengths), np.asarray(ref.lengths))
    np.testing.assert_array_equal(to_np(got.tokens), np.asarray(ref.tokens))
    np.testing.assert_allclose(to_np(got.scores), np.asarray(ref.scores),
                               atol=1e-4, rtol=0)
    assert len(calls) > 0 and set(calls) == {(True, torch.float32)}


def test_amp_auto_is_off_on_the_cpu_and_v31_fails_the_gate(monkeypatch):
    """``amp: auto`` resolves from the encoder's device (off here), and the
    V=31 vocabulary never reaches K6, even with psi_kernel."""
    calls = _spy_psi_route(monkeypatch)
    *_, pm, plm = _models(0, V_SMALL)
    w, wl = waves(0)
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    for cfg in (dict(DECODE_CFG, psi_kernel=True),
                dict(DECODE_CFG, psi_kernel=True, amp=True)):
        dec = BeamDecoder(pm, cfg, lm=plm)
        dec.forward(pf, pfl)
        assert dec.last_amp == ("amp" in cfg)
    assert calls and not any(k for k, _ in calls)
