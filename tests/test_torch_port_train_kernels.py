"""The training kernels' plain versions and autograd Functions against the
JAX package: K2's residuals and K2b (``lstm_scan_bwd_plain``, ``LSTMScan``)
against ``lstm_scan_fused(..., interpret=True)`` under ``jax.vjp``, and K3
(``ctc_loss_plain``, ``CTCLoss``) against ``ctc_loss_pallas(..., 0, True)``
and against ``ops/ctc.py``'s autodiff, which ``ops/ctc.py`` of the port
also mirrors.

Tolerances (f32, sums taken in another order): forward values atol 1e-5,
gradients rtol 1e-4 / atol 1e-6 (K2b) and atol 1e-5 (CTC, whose entries are
posteriors in [-1, 0]), NLL rtol 1e-5."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from end_to_end_asr_pytorch_tpu.ops import ctc as jctc
from end_to_end_asr_pytorch_tpu.ops.pallas import ctc_kernel as jctc_kernel
from end_to_end_asr_pytorch_tpu.ops.pallas import lstm_kernel as jlstm
from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
from end_to_end_asr_pytorch_tpu_torch.ops import ctc, rnn
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import ctc_kernel, lstm_kernel
from tests.torch_port_fixtures import to_np

torch.set_num_threads(1)
T, B, H = 12, 3, 16
LENS = np.asarray([12, 9, 4])


def _lstm_inputs(seed):
    rng = np.random.RandomState(seed)
    xp = (rng.randn(T, B, 4 * H) * 0.5).astype(np.float32)
    w_hh = (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
    mask = np.arange(T)[:, None] < LENS[None, :]
    dys = rng.randn(T, B, H).astype(np.float32)
    return xp, w_hh, mask, dys


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_residuals_match_pallas_interpret(reverse):
    xp, w_hh, mask, _ = _lstm_inputs(0)
    _, (_, _, _, _, jcs, jgates) = jlstm._fused_fwd(
        jnp.asarray(xp), jnp.asarray(w_hh), jnp.asarray(mask), reverse, True)
    flip = (lambda a: np.asarray(a)[::-1]) if reverse else np.asarray
    ys, cs, gates = lstm_kernel.lstm_scan_fused(
        torch.from_numpy(xp), torch.from_numpy(w_hh), torch.from_numpy(mask),
        reverse, residuals=True)
    np.testing.assert_allclose(to_np(cs), flip(jcs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_np(gates), flip(jgates), atol=1e-5, rtol=0)
    plain = lstm_kernel.lstm_scan_plain(torch.from_numpy(xp),
                                        torch.from_numpy(w_hh),
                                        torch.from_numpy(mask), reverse)
    np.testing.assert_array_equal(to_np(ys), to_np(plain))


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_backward_matches_pallas_vjp(reverse):
    """lstm_scan_bwd_plain's dxp and dW_hh, and LSTMScan under autograd,
    against jax.vjp of the TPU kernel's custom VJP in interpret mode."""
    xp, w_hh, mask, dys = _lstm_inputs(1)
    f = lambda x, w: jlstm.lstm_scan_fused(x, w, jnp.asarray(mask), reverse, True)
    _, vjp = jax.vjp(f, jnp.asarray(xp), jnp.asarray(w_hh))
    rdx, rdw = (np.asarray(a) for a in vjp(jnp.asarray(dys)))
    tx, tw, tm = (torch.from_numpy(a) for a in (xp, w_hh, mask))
    ys, cs, gates = lstm_kernel.lstm_scan_fwd_plain(tx, tw, tm, reverse)
    dxp, dw = lstm_kernel.lstm_scan_bwd_plain(gates, cs, ys, tm, tw,
                                              torch.from_numpy(dys), reverse)
    np.testing.assert_allclose(to_np(dxp), rdx, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(dw), rdw, rtol=1e-4, atol=1e-6)
    # masked steps give exactly zero gate gradients
    assert np.all(to_np(dxp)[~mask] == 0.0)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    out = lstm_kernel.LSTMScan.apply(tx, tw, tm, reverse, False)
    out.backward(torch.from_numpy(dys))
    np.testing.assert_allclose(to_np(tx.grad), rdx, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(tw.grad), rdw, rtol=1e-4, atol=1e-6)


def test_lstm_backward_matches_autograd_through_plain_scan():
    xp, w_hh, mask, dys = _lstm_inputs(2)
    for reverse in (False, True):
        grads = []
        for fn in (lambda x, w: lstm_kernel.LSTMScan.apply(
                       x, w, torch.from_numpy(mask), reverse, False),
                   lambda x, w: lstm_kernel.lstm_scan_plain(
                       x, w, torch.from_numpy(mask), reverse)):
            x = torch.from_numpy(xp).requires_grad_(True)
            w = torch.from_numpy(w_hh).requires_grad_(True)
            fn(x, w).backward(torch.from_numpy(dys))
            grads.append((to_np(x.grad), to_np(w.grad)))
        for a, b in zip(*grads):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def _ctc_inputs(seed, Tc=14, V=6):
    """Rows: repeated label, ragged lengths, zero-length label, infeasible
    (label longer than its frames allow)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(4, Tc, V).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = np.asarray([[2, 2, 3, 0], [1, 4, 5, 3], [0, 0, 0, 0],
                         [1, 2, 1, 2]], np.int32)
    label_len = np.asarray([3, 4, 0, 4], np.int32)
    logit_len = np.asarray([14, 10, 7, 3], np.int32)
    return lp, logit_len, labels, label_len


def test_ctc_plain_matches_pallas_interpret():
    lp, ll, lab, lab_len = _ctc_inputs(0)
    args = [jnp.asarray(a) for a in (lp, ll, lab, lab_len)]
    g = np.asarray([1.0, 0.5, 2.0, 1.5], np.float32)
    rnll, vjp = jax.vjp(lambda x: jctc_kernel.ctc_loss_pallas(
        x, *args[1:], 0, True), args[0])
    rgrad = np.asarray(vjp(jnp.asarray(g))[0])
    x = torch.from_numpy(lp).requires_grad_(True)
    nll = ctc_kernel.CTCLoss.apply(x, *(torch.from_numpy(a) for a in
                                        (ll, lab, lab_len)), 0, False)
    nll.backward(torch.from_numpy(g))
    np.testing.assert_allclose(to_np(nll), np.asarray(rnll), rtol=1e-5, atol=0)
    np.testing.assert_allclose(to_np(x.grad), rgrad, rtol=0, atol=1e-5)
    # the infeasible row: NLL ~1e30 and exactly zero gradient
    assert to_np(nll)[3] > 1e29
    assert np.all(to_np(x.grad)[3] == 0.0)
    # frames at or past a row's length get exactly zero gradient
    assert np.all(to_np(x.grad)[1, 10:] == 0.0)


def test_ctc_plain_lattice_gradient_matches_autodiff():
    """The analytic gradient of the plain lattice against autodiff of the
    port's ops/ctc.py and of the JAX package's, on the feasible rows."""
    lp, ll, lab, lab_len = _ctc_inputs(1)
    targs = [torch.from_numpy(a) for a in (ll, lab, lab_len)]
    rnll, vjp = jax.vjp(lambda x: jctc.ctc_loss(
        x, *(jnp.asarray(a) for a in (ll, lab, lab_len))), jnp.asarray(lp))
    feas = np.asarray([1, 1, 1, 0], np.float32)
    rgrad = np.asarray(vjp(jnp.asarray(feas))[0])
    for fn in (ctc.ctc_loss, ctc.ctc_loss_k3):
        x = torch.from_numpy(lp).requires_grad_(True)
        nll = fn(x, *targs)
        np.testing.assert_allclose(to_np(nll)[:3], np.asarray(rnll)[:3],
                                   rtol=1e-5, atol=0)
        assert to_np(nll)[3] > 1e29
        nll.backward(torch.from_numpy(feas))
        np.testing.assert_allclose(to_np(x.grad), rgrad, rtol=0, atol=1e-5)


def test_ctc_loss_mean_matches_jax():
    lp, ll, lab, lab_len = _ctc_inputs(2)
    ref = jctc.ctc_loss_mean(*(jnp.asarray(a) for a in (lp, ll, lab, lab_len)))
    got = ctc.ctc_loss_mean(*(torch.from_numpy(a) for a in (lp, ll, lab, lab_len)))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_array_equal(
        to_np(ctc.extend_labels(torch.from_numpy(lab))),
        np.asarray(jctc.extend_labels(jnp.asarray(lab))))


def test_cpu_tensors_take_plain_versions():
    """The wrappers on CPU tensors are their plain versions, and launch
    nothing."""
    xp, w_hh, mask, dys = _lstm_inputs(3)
    tx, tw, tm, td = (torch.from_numpy(a) for a in (xp, w_hh, mask, dys))
    res = lstm_kernel.lstm_scan_fused(tx, tw, tm, True, residuals=True)
    for a, b in zip(res, lstm_kernel.lstm_scan_fwd_plain(tx, tw, tm, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    got = lstm_kernel.lstm_bwd_fused(res[2], res[1], res[0], tm, tw, td, True)
    ref = lstm_kernel.lstm_scan_bwd_plain(res[2], res[1], res[0], tm, tw, td, True)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ctc_args = [torch.from_numpy(a) for a in _ctc_inputs(3)]
    a = ctc_kernel.ctc_loss_fused(*ctc_args)
    b = ctc_kernel.ctc_loss_plain(*ctc_args)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert (lstm_kernel.lstm_scan_fused.launches, lstm_kernel.lstm_bwd_fused.launches,
            ctc_kernel.ctc_loss_fused.launches) == (0, 0, 0)


def test_wrappers_reject_non_f32_inputs():
    """The kernels take f32, or bf16 activations and residuals with an f32
    W_hh (amp training, which once raised here); another dtype raises in
    the wrapper on any device, rather than pass to a plain version."""
    xp, w_hh, mask, dys = (torch.from_numpy(a) for a in _lstm_inputs(4))
    bf = lambda t: t.to(torch.bfloat16)
    ys, cs, gates = lstm_kernel.lstm_scan_fused(bf(xp), w_hh, mask,
                                                residuals=True)
    dxp, dw = lstm_kernel.lstm_bwd_fused(gates, cs, ys, mask, w_hh, bf(dys))
    assert (dxp.dtype, dw.dtype) == (torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        lstm_kernel.lstm_scan_fused(bf(xp), bf(w_hh), mask, residuals=True)
    with pytest.raises(ValueError, match="float32"):
        lstm_kernel.lstm_bwd_fused(gates, cs, ys, mask, bf(w_hh), bf(dys))
    with pytest.raises(ValueError, match="float32"):
        lstm_kernel.lstm_scan_fused(xp.half(), w_hh, mask, residuals=True)
    ys, cs, gates = lstm_kernel.lstm_scan_fwd_plain(xp, w_hh, mask)
    with pytest.raises(ValueError, match="float32"):
        lstm_kernel.lstm_bwd_fused(gates.half(), cs.half(), ys.half(), mask,
                                   w_hh, dys.half())
    lp, ll, lab, lab_len = (torch.from_numpy(a) for a in _ctc_inputs(4))
    with pytest.raises(ValueError, match="float32"):
        ctc_kernel.ctc_loss_fused(bf(lp), ll, lab, lab_len)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to see which route
    the callers pick there."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_tensors_take_the_kernel_route_whatever_their_dtype(
        monkeypatch, dtype, kernels):
    """On the card the route is chosen by the kernel switch alone: a bf16
    input goes to the kernels (whose wrappers raise), never quietly to the
    plain versions."""
    routes = []

    class Recorder:
        @staticmethod
        def apply(*args):
            routes.append(args[-1])
            return args[0]

    monkeypatch.setattr(rnn, "LSTMScan", Recorder)
    monkeypatch.setattr(ctc, "CTCLoss", Recorder)
    monkeypatch.setattr(cuda_kernels, "USE_KERNELS", kernels)
    w = rnn.LSTMWeights(4, 8, torch.Generator().manual_seed(0)).to(dtype)
    x = torch.zeros(5, 2, 4, dtype=dtype).as_subclass(_OnCard)
    rnn.lstm_scan(w, x, torch.ones(5, 2, dtype=torch.bool))
    lp, ll, lab, lab_len = _ctc_inputs(5)
    ctc.ctc_loss_k3(torch.from_numpy(lp).to(dtype).as_subclass(_OnCard),
                    *(torch.from_numpy(a) for a in (ll, lab, lab_len)))
    assert routes == [kernels, kernels]
