"""The port's GRU family against the JAX package on the CPU: K4's and K4b's
plain versions against the TPU kernels in interpret mode, ``GRUScan``'s
gradients against ``jax.vjp`` of the TPU kernel's custom VJP and against
autograd through the plain scan, K4's bf16 contract (decode amp), one train
step of a GRU encoder + GRU decoder model, the amp beam decode of a GRU
model with a GRU LM, ``transcribe`` (the f32 beam) on a reference-layout
GRU checkpoint against the root tool, and the wrappers' input and route
rules.

Where the JAX package runs a GRU over time under amp, these tests send it
through its TPU kernel in interpret mode (``USE_FUSED_SCAN`` and an
``interpret=True`` wrapper, set from the test side only): on the CPU it
would otherwise take its ``lax.scan``, whose carry is rounded to bf16 each
step, while the TPU kernel (and the port) keep an f32 carry.

Tolerances, with their reasons (f32, sums taken in another order): forward
values atol 1e-5; gradients rtol 1e-4 / atol 1e-6; the train step's loss
rtol 1e-5; bf16 ys within 1 bf16 ulp (the f32 value before rounding differs
in the last bits); the amp beam identical top-1 tokens, best score within
1e-4; transcribe's TSV identical."""
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
from end_to_end_asr_pytorch_tpu.ops import rnn as jrnn
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from end_to_end_asr_pytorch_tpu.ops.pallas import gru_kernel as jgk
from end_to_end_asr_pytorch_tpu.solvers.train_asr import masked_ce as jax_masked_ce
from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
from end_to_end_asr_pytorch_tpu_torch.ops import rnn
from end_to_end_asr_pytorch_tpu_torch.ops.amp import bf16_rounded_copy
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.ops.ctc import ctc_loss_k3
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import gru_kernel, lstm_kernel
from end_to_end_asr_pytorch_tpu_torch.solvers.train_asr import asr_loss
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (
    _to_port_layout, asr_from_arrays, lm_from_arrays, port_name)
from tests.test_torch_ckpt import export_asr_state_dict
from tests.torch_port_fixtures import (ASR_CFG, AUDIO_CFG, LM_CFG, VOCAB,
                                       jax_arrays, to_np, waves)

torch.set_num_threads(1)
BF = torch.bfloat16
B, H = 3, 16
GRU_CFG = copy.deepcopy(ASR_CFG)
GRU_CFG["encoder"]["module"] = "GRU"
GRU_CFG["decoder"]["module"] = "GRU"
GRU_LM_CFG = dict(LM_CFG, module="GRU")
DECODE_CFG = {"beam_size": 4, "min_len_ratio": 0.05, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3}


def _scan_inputs(seed, T):
    """x_proj (T, B, 3H), W_hh, b_hh (non-zero, so that its n third under
    the reset gate matters), a ragged mask and an upstream gradient."""
    rng = np.random.RandomState(seed)
    xp = (rng.randn(T, B, 3 * H) * 0.5).astype(np.float32)
    w_hh = (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)
    b_hh = (rng.randn(3 * H) * 0.3).astype(np.float32)
    mask = np.arange(T)[:, None] < np.asarray([T, T - 3, 2])[None, :]
    dys = rng.randn(T, B, H).astype(np.float32)
    return xp, w_hh, b_hh, mask, dys


def _walk(a, reverse):
    """An array in the TPU wrapper's walk order (flipped when reversed),
    or back."""
    return a[::-1] if reverse else a


def _jax_fwd(xp, w_hh, b_hh, mask, reverse):
    """_run_fwd in interpret mode, as _g_fwd calls it: (ys, gates, hp_n)
    in real-time order."""
    m = mask.astype(np.float32)[:, :, None]
    out = jgk._run_fwd(jnp.asarray(_walk(xp, reverse)),
                       jnp.asarray(_walk(m, reverse)), jnp.asarray(w_hh),
                       jnp.asarray(b_hh), interpret=True)
    return [_walk(np.asarray(a), reverse) for a in out]


def assert_within_bf16_ulp(got, ref):
    """|got - ref| <= 1 ulp of bf16 at the larger magnitude (8 significant
    bits: 2^-7 of it, which is at least one ulp)."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(jnp.asarray(got, jnp.float32))
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    assert g.shape == r.shape
    bad = np.abs(g - r) > np.maximum(np.abs(g), np.abs(r)) * 2.0 ** -7
    assert not bad.any(), (np.abs(g - r)[bad].max(), int(bad.sum()))


# ----------------------------------------------------------- K4 and K4b
@pytest.mark.parametrize("T", [12, 9])     # UNROLL = 4 divides 12, not 9
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_forward_plain_matches_pallas_interpret(reverse, T):
    xp, w_hh, b_hh, mask, _ = _scan_inputs(T + reverse, T)
    rys, rgates, rhpn = _jax_fwd(xp, w_hh, b_hh, mask, reverse)
    t = torch.from_numpy
    ys, gates, hp_n = gru_kernel.gru_scan_fwd_plain(t(xp), t(w_hh), t(b_hh),
                                                    t(mask), reverse)
    for got, ref in ((ys, rys), (gates, rgates), (hp_n, rhpn)):
        np.testing.assert_allclose(to_np(got), ref, atol=1e-5, rtol=0)
    assert np.all(to_np(ys)[~mask] == 0.0)
    # the serving wrapper on CPU tensors: the same ys, and no launch
    got = gru_kernel.gru_scan_fused(t(xp), t(w_hh), t(b_hh), t(mask), reverse)
    torch.testing.assert_close(got, ys, rtol=0, atol=0)
    assert gru_kernel.gru_scan_fused.launches == 0


@pytest.mark.parametrize("T", [12, 9])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_backward_steps_match_pallas_interpret(reverse, T):
    """K4b's plain version against _run_bwd in interpret mode on the same
    residuals: dxp and dhp; and dW_hh / db_hh against _g_bwd's
    reductions."""
    xp, w_hh, b_hh, mask, dys = _scan_inputs(20 + T + reverse, T)
    ys, gates, hp_n = _jax_fwd(xp, w_hh, b_hh, mask, reverse)
    m = mask.astype(np.float32)[:, :, None]
    rdxp, rdhp = (_walk(np.asarray(a), reverse) for a in jgk._run_bwd(
        *(jnp.asarray(_walk(a, reverse)) for a in (gates, hp_n, ys, m)),
        jnp.asarray(w_hh), jnp.asarray(_walk(dys, reverse)), interpret=True))
    t = torch.from_numpy
    args = (t(gates.copy()), t(hp_n.copy()), t(ys.copy()), t(mask), t(w_hh),
            t(dys), reverse)
    dxp, dhp = gru_kernel.gru_bwd_steps_plain(*args)
    np.testing.assert_allclose(to_np(dxp), rdxp, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(dhp), rdhp, rtol=1e-4, atol=1e-6)
    assert np.all(to_np(dxp)[~mask] == 0.0)
    hs_prev = _walk(np.concatenate([np.zeros_like(ys[:1]),
                                    _walk(ys, reverse)[:-1]]), reverse)
    _, dw, db = gru_kernel.gru_bwd_fused(*args)
    np.testing.assert_allclose(to_np(dw),
                               np.einsum("tbi,tbj->ij", hs_prev, rdhp),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(db), rdhp.sum((0, 1)), rtol=1e-4,
                               atol=1e-6)
    assert gru_kernel.gru_bwd_fused.launches == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_gradients_match_jax_vjp_and_autograd(reverse):
    """GRUScan's gradients for x_proj, W_hh and b_hh against jax.vjp of
    gru_scan_fused(interpret=True), and against autograd through the plain
    scan."""
    xp, w_hh, b_hh, mask, dys = _scan_inputs(40 + reverse, 10)
    f = lambda x, w, b: jgk.gru_scan_fused(x, w, b, jnp.asarray(mask),
                                           reverse, True)
    rys, vjp = jax.vjp(f, jnp.asarray(xp), jnp.asarray(w_hh),
                       jnp.asarray(b_hh))
    refs = [np.asarray(a) for a in vjp(jnp.asarray(dys))]
    for scan in (lambda x, w, b, m: gru_kernel.GRUScan.apply(
                     x, w, b, m, reverse, False),
                 lambda x, w, b, m: gru_kernel.gru_scan_plain(
                     x, w, b, m, reverse)):
        ins = [torch.from_numpy(a).requires_grad_(True)
               for a in (xp, w_hh, b_hh)]
        ys = scan(*ins, torch.from_numpy(mask))
        np.testing.assert_allclose(to_np(ys), np.asarray(rys), atol=1e-5,
                                   rtol=0)
        ys.backward(torch.from_numpy(dys))
        for x, ref, name in zip(ins, refs, ("x_proj", "w_hh", "b_hh")):
            np.testing.assert_allclose(to_np(x.grad), ref, rtol=1e-4,
                                       atol=1e-6, err_msg=name)


# --------------------------------------------------------------- K4 bf16
@pytest.mark.parametrize("reverse", [False, True])
def test_k4_bf16_plain_matches_pallas_interpret(reverse):
    """gru_scan_fused on bf16 x_proj (gru_scan_bf16's plain version on the
    CPU) against the TPU kernel in interpret mode: f32 carry, bf16 ys."""
    xp, w_hh, b_hh, mask, _ = _scan_inputs(50 + reverse, 9)
    ref = jgk.gru_scan_fused(jnp.asarray(xp).astype(jnp.bfloat16),
                             jnp.asarray(w_hh), jnp.asarray(b_hh),
                             jnp.asarray(mask), reverse, True)
    t = torch.from_numpy
    got = gru_kernel.gru_scan_fused(t(xp).to(BF), t(w_hh), t(b_hh), t(mask),
                                    reverse)
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    assert gru_kernel.gru_scan_bf16.launches == 0
    assert_within_bf16_ulp(got, ref)
    assert np.all(got.float().numpy()[~mask] == 0.0)


@pytest.fixture()
def jax_fused_gru(monkeypatch):
    """The JAX package's GRU scans through its TPU kernel in interpret
    mode (its carry stays f32), from the test side only."""
    monkeypatch.setattr(jrnn, "USE_FUSED_SCAN", True)
    orig = jgk.gru_scan_fused
    monkeypatch.setattr(jgk, "gru_scan_fused",
                        lambda x, w, b, m, r=False, interpret=False:
                        orig(x, w, b, m, r, True))


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_amp_keeps_an_f32_carry(reverse, jax_fused_gru):
    """rnn.gru_scan on weights rounded to bf16 and a bf16 input, as decode
    amp runs it: x_proj rounded to bf16, then K4's bf16 contract (f32
    carry, bf16 ys), as the JAX package's TPU kernel computes it. A bf16
    carry fed with f32 x_proj drifts past 1 bf16 ulp of it."""
    T, D = 14, 12
    w = jrnn.init_gru(jax.random.PRNGKey(3 + reverse), D, H)
    rng = np.random.RandomState(3 + reverse)
    w = w._replace(b_ih=jnp.asarray(rng.randn(3 * H) * 0.3, jnp.float32),
                   b_hh=jnp.asarray(rng.randn(3 * H) * 0.3, jnp.float32))
    wb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), w)
    x = rng.randn(T, B, D).astype(np.float32)
    mask = np.arange(T)[:, None] < np.array([T, 9, 3])[None, :]
    ref = jrnn.gru_scan(wb, jnp.asarray(x).astype(jnp.bfloat16),
                        jnp.asarray(mask), reverse=reverse)
    pw = rnn.GRUWeights(D, H, device="cpu")
    for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        getattr(pw, name).data.copy_(torch.from_numpy(
            np.asarray(getattr(w, name))))
    got = rnn.gru_scan(bf16_rounded_copy(pw), torch.from_numpy(x).to(BF),
                       torch.from_numpy(mask), reverse=reverse)
    assert got.dtype == BF
    assert_within_bf16_ulp(got, ref)


# --------------------------------------------------------- one train step
TEXT = np.asarray([[3, 4, 4, 5, 6, 2, 0, 0], [7, 8, 9, 7, 0, 0, 0, 0],
                   [3, 5, 7, 9, 11, 3, 5, 7]], np.int32)
TEXT_LEN = np.asarray([6, 4, 8], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_step(seed):
    """JAX: loss and gradients of the solver's joint loss at tf_rate 1 for
    the GRU model (its GRU scans through lax.scan on the CPU), under jit."""
    jm = JaxASR(40, VOCAB, GRU_CFG)
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

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    return jp, float(loss), jax_arrays(grads)


def test_gru_train_step_matches_jax(monkeypatch):
    """One train step of a GRU encoder + GRU decoder: the loss and every
    parameter's gradient; the encoder's scans went through GRUScan."""
    jp, ref_loss, ref_grads = _jax_step(0)
    calls = []
    orig = gru_kernel.GRUScan.apply
    monkeypatch.setattr(rnn.GRUScan, "apply",
                        lambda *a: calls.append(a[-1]) or orig(*a))
    pm = asr_from_arrays(40, VOCAB, GRU_CFG, jax_arrays(jp), device="cpu")
    pm.requires_grad_(True)
    w, wl = waves(0)
    feat, flen = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                        torch.from_numpy(wl))
    text = torch.from_numpy(TEXT).long()
    ctc_out, enc_len, att_out, _, _ = pm(feat, flen, TEXT.shape[1], 1.0,
                                         teacher=text, train=True,
                                         generator=torch.Generator())
    loss, _ = asr_loss(ctc_out, enc_len, att_out, text,
                       torch.from_numpy(TEXT_LEN).long(), 0.5, ctc_loss_k3)
    loss.backward()
    assert calls == [False] * 4                  # 2 layers x 2 directions
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    got = {n: to_np(p.grad) for n, p in pm.named_parameters()}
    assert len(got) == len(ref_grads)
    for path, g in ref_grads.items():
        name = port_name(path)
        np.testing.assert_allclose(got[name], _to_port_layout(name, g),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        assert np.any(got[name] != 0), name


# ----------------------------------------------------------- beam decodes
@functools.lru_cache(maxsize=None)
def _models(seed):
    jm = JaxASR(40, VOCAB, GRU_CFG)
    jp = jm.init(jax.random.PRNGKey(seed))
    jlm = JaxLM(VOCAB, GRU_LM_CFG)
    jlp = jlm.init(jax.random.PRNGKey(100 + seed))
    pm = asr_from_arrays(40, VOCAB, GRU_CFG, jax_arrays(jp), device="cpu")
    plm = lm_from_arrays(VOCAB, GRU_LM_CFG, jax_arrays(jlp), device="cpu")
    return jm, jp, jlm, jlp, pm, plm


def _decode_both(seed, cfg):
    jm, jp, jlm, jlp, pm, plm = _models(seed)
    w, wl = waves(seed)
    jf, jfl = JaxFrontend(AUDIO_CFG)(jnp.asarray(w), jnp.asarray(wl))
    ref = JaxBeam(jm, cfg, lm=jlm).forward(jp, jf, jfl, lm_params=jlp)
    pf, pfl = AudioFrontend(AUDIO_CFG, device="cpu")(torch.from_numpy(w),
                                                     torch.from_numpy(wl))
    dec = BeamDecoder(pm, cfg, lm=plm)
    got = dec.forward(pf, pfl)
    assert dec.last_amp == bool(cfg.get("amp"))
    return ref, got


def test_gru_amp_beam_matches_jax(jax_fused_gru):
    """The amp beam of a GRU model and GRU LM (its encoder's scans through
    K4's bf16 route, their plain version on the CPU) against the JAX
    package's amp beam with its GRU through the interpret TPU kernel."""
    n0 = (gru_kernel.gru_scan_bf16.launches, gru_kernel.gru_scan_fused.launches,
          lstm_kernel.lstm_scan_bf16.launches)
    ref, got = _decode_both(0, dict(DECODE_CFG, amp=True))
    rt, rl = np.asarray(ref.tokens), np.asarray(ref.lengths)
    gt, gl = to_np(got.tokens), to_np(got.lengths)
    for b in range(rt.shape[0]):
        assert gl[b, 0] == rl[b, 0]
        np.testing.assert_array_equal(gt[b, 0, :gl[b, 0]], rt[b, 0, :rl[b, 0]])
    np.testing.assert_allclose(to_np(got.scores)[:, 0],
                               np.asarray(ref.scores)[:, 0], rtol=0, atol=1e-4)
    # CPU tensors: the plain versions, no kernel launch
    assert (gru_kernel.gru_scan_bf16.launches, gru_kernel.gru_scan_fused.launches,
            lstm_kernel.lstm_scan_bf16.launches) == n0 == (0, 0, 0)


def test_transcribe_gru_checkpoint_matches_root_tool(tmp_path, monkeypatch):
    """The port's transcribe and the root tool on one reference-layout GRU
    checkpoint (separate bias_ih / bias_hh): identical TSV."""
    import transcribe as jax_transcribe
    import yaml
    from end_to_end_asr_pytorch_tpu.data.audio_io import write_wav
    from end_to_end_asr_pytorch_tpu_torch import transcribe
    chars = list("abcdefgh") + ["<space>"]
    (tmp_path / "vocab.txt").write_text("\n".join(chars) + "\n")
    cfg = {"data": {"corpus": {"name": "none"}, "audio": dict(AUDIO_CFG),
                    "text": {"mode": "character",
                             "vocab_file": str(tmp_path / "vocab.txt")}},
           "model": copy.deepcopy(GRU_CFG), "hparas": {},
           "decode": {"beam_size": 3, "min_len_ratio": 0.0,
                      "max_len_ratio": 0.5, "ctc_weight": 0.3}}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    w, wl = waves(22, lens=(4800, 3900))
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"utt{i}.wav"))
        write_wav(paths[-1], w[i, :wl[i]])
    jp = JaxASR(40, 3 + len(chars), GRU_CFG).init(jax.random.PRNGKey(22))
    sd = export_asr_state_dict(jp)
    assert any(k.endswith("bias_hh_l0") for k in sd)
    torch.save({"model": sd}, str(tmp_path / "m.pth"))
    common = ["--config", str(tmp_path / "cfg.yaml"), "--load",
              str(tmp_path / "m.pth"), "--cpu", "--batch", "2", *paths]
    monkeypatch.setattr(sys, "argv", ["transcribe.py", *common, "--output",
                                      str(tmp_path / "jax.tsv")])
    jax_transcribe.main()
    transcribe.main([*common, "--output", str(tmp_path / "port.tsv")])
    ref = (tmp_path / "jax.tsv").read_text()
    assert len(ref.strip().split("\n")) == 2
    assert (tmp_path / "port.tsv").read_text() == ref


# --------------------------------------------------------- inputs, routes
def test_wrappers_reject_wrong_dtypes_and_shapes():
    """Wrong dtypes, shapes and layouts raise in the wrappers. bf16 x_proj
    with residuals (it once raised here) is amp training's route: it
    returns ys and the residuals in bf16; f16 still raises."""
    T = 4
    xp, w_hh, b_hh, mask, dys = (torch.from_numpy(a)
                                 for a in _scan_inputs(60, T))
    bf = lambda t: t.to(BF)
    out = gru_kernel.gru_scan_fused(bf(xp), w_hh, b_hh, mask, residuals=True)
    assert [t.dtype for t in out] == [BF] * 3
    with pytest.raises(ValueError, match="float32"):
        gru_kernel.gru_scan_fused(xp.half(), w_hh, b_hh, mask, residuals=True)
    with pytest.raises(ValueError, match="float32"):
        gru_kernel.gru_scan_fused(xp, w_hh, bf(b_hh), mask)
    with pytest.raises(ValueError, match="bfloat16"):
        gru_kernel.gru_scan_bf16(xp.half(), w_hh, b_hh, mask)
    with pytest.raises(ValueError, match="float32"):
        gru_kernel.gru_scan_bf16(bf(xp), bf(w_hh), b_hh, mask)
    with pytest.raises(ValueError, match=r"\(48,\)"):
        gru_kernel.gru_scan_fused(xp, w_hh, b_hh[:-1], mask)
    with pytest.raises(ValueError, match="x_proj"):
        gru_kernel.gru_scan_fused(xp[..., :-1], w_hh, b_hh, mask)
    with pytest.raises(ValueError, match="contiguous"):
        gru_kernel.gru_scan_fused(xp, w_hh.t().contiguous().t(), b_hh, mask)
    ys, gates, hp_n = gru_kernel.gru_scan_fwd_plain(xp, w_hh, b_hh, mask)
    with pytest.raises(ValueError, match="float32"):
        gru_kernel.gru_bwd_fused(bf(gates), hp_n, ys, mask, w_hh, dys)
    with pytest.raises(ValueError, match="hp_n"):
        gru_kernel.gru_bwd_fused(gates, hp_n[:, :, :-1], ys, mask, w_hh, dys)
    with pytest.raises(ValueError, match="bool"):
        gru_kernel.gru_bwd_fused(gates, hp_n, ys, mask.float(), w_hh, dys)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to see which route
    the callers pick there."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_tensors_take_k4_by_the_switch_alone(monkeypatch, dtype,
                                                  kernels):
    """On the card the route is chosen by the kernel switch alone: a bf16
    input goes to the kernels too (K4's bf16 variant), never quietly to the
    plain versions; with an initial state the plain scan runs."""
    routes = []

    class Recorder:
        @staticmethod
        def apply(*args):
            routes.append(args[-1])
            return args[0]

    monkeypatch.setattr(rnn, "GRUScan", Recorder)
    monkeypatch.setattr(cuda_kernels, "USE_KERNELS", kernels)
    w = rnn.GRUWeights(4, 8, torch.Generator().manual_seed(0))
    x = torch.zeros(5, 2, 4, dtype=dtype).as_subclass(_OnCard)
    rnn.gru_scan(w, x, torch.ones(5, 2, dtype=torch.bool))
    assert routes == [kernels]
    rnn.gru_scan(w, torch.zeros(5, 2, 4), torch.ones(5, 2, dtype=torch.bool),
                 h0=torch.zeros(2, 8))
    assert routes == [kernels]
