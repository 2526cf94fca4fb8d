"""K3 as the card runs it, on the CPU: the plain version that takes the
log-probs (``ctc_loss_plain``: ``prepare`` then ``lattice_plain``) against
the TPU kernel in interpret mode (``ctc_loss_pallas(..., 0, True)``) and
against autodiff of ``ops/ctc.py`` (the port's and the JAX package's), on
inputs made with numpy from a seed: repeated labels, a label length of 0, an
infeasible row, ragged logit lengths (one past T, one of 0), T=1, int32 and
int64 labels and lengths. Then the kernel's contract on the host side:
``supports`` and the design rule over every lattice up to T=4096, S=4097,
and the card route of ``CTCLoss.forward``, which launches K3 alone (no
``prepare``, no other op but the output allocation).

Tolerances (f32, sums taken in another order): NLL rtol 1e-5 on feasible
rows (infeasible ones ~1e30 on both sides), gradients atol 1e-5 (their
entries are posteriors in [-1, 0])."""
import ctypes
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from end_to_end_asr_pytorch_tpu.ops import ctc as jctc
from end_to_end_asr_pytorch_tpu.ops.pallas import ctc_kernel as jctc_kernel
from end_to_end_asr_pytorch_tpu_torch.ops import ctc
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build, ctc_kernel
from tests.torch_port_fixtures import to_np

torch.set_num_threads(1)


def _inputs(seed, case):
    """log_probs (B, T, V) f32 and int32 logit lengths, labels (B, U) and
    label lengths, labels right-padded with 0."""
    rng = np.random.RandomState(seed)
    if case == "T1":
        B, T, U, V = 3, 1, 2, 5
        labels = np.asarray([[0, 0], [3, 0], [2, 4]])
        lab_len = np.asarray([0, 1, 2])                  # the last infeasible
        logit_len = np.asarray([1, 1, 1])
    elif case == "mixed":
        B, T, U, V = 6, 14, 4, 7
        labels = rng.randint(1, V, size=(B, U))
        labels[0, 1] = labels[0, 0]                      # a repeated label
        labels[4] = [2, 2, 2, 5]                         # repeats: skips off
        lab_len = np.asarray([4, 3, 0, 4, 4, 2])
        logit_len = np.asarray([14, 11, 7, 3, 17, 0])    # row 3 infeasible
    else:                                                # "wide"
        B, T, U, V = 4, 30, 12, 5
        labels = rng.randint(1, V, size=(B, U))
        labels[:, 1::3] = labels[:, 0::3]
        lab_len = np.asarray([12, 9, 1, 12])
        logit_len = np.asarray([30, 24, 30, 10])         # row 3 infeasible
    for b in range(B):
        labels[b, lab_len[b]:] = 0
    logits = rng.randn(B, T, V).astype(np.float32) * 2.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return (lp.astype(np.float32), logit_len.astype(np.int32),
            labels.astype(np.int32), lab_len.astype(np.int32))


CASES = ("mixed", "wide", "T1")


def _torch_args(arrays, dtype):
    lp, ll, lab, lab_len = arrays
    return (torch.from_numpy(lp),) + tuple(
        torch.from_numpy(a).to(dtype) for a in (ll, lab, lab_len))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case, dtype):
    """ctc_loss_plain's NLL, and CTCLoss's gradient on the plain route,
    against the TPU kernel in interpret mode under jax.vjp."""
    arrays = _inputs(0, case)
    lp = arrays[0]
    g = np.linspace(0.5, 2.0, lp.shape[0]).astype(np.float32)
    rnll, vjp = jax.vjp(lambda x: jctc_kernel.ctc_loss_pallas(
        x, *(jnp.asarray(a) for a in arrays[1:]), 0, True), jnp.asarray(lp))
    rgrad = np.asarray(vjp(jnp.asarray(g))[0])
    rnll = np.asarray(rnll)
    x, ll, lab, lab_len = _torch_args(arrays, dtype)
    nll, grad_emit, ext = ctc_kernel.ctc_loss_plain(x, ll, lab, lab_len)
    np.testing.assert_array_equal(
        to_np(ext), np.asarray(jctc.extend_labels(jnp.asarray(arrays[2]))))
    feas = rnll < 1e29
    assert feas.sum() < len(feas) and np.array_equal(to_np(nll) < 1e29, feas)
    np.testing.assert_allclose(to_np(nll)[feas], rnll[feas], rtol=1e-5, atol=0)
    assert tuple(grad_emit.shape) == (*lp.shape[:2], 2 * lab.shape[1] + 1)
    x.requires_grad_(True)
    out = ctc_kernel.CTCLoss.apply(x, ll, lab, lab_len, 0, False)
    torch.testing.assert_close(out.detach(), nll, rtol=0, atol=0)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(to_np(x.grad), rgrad, rtol=0, atol=1e-5)
    # exactly zero gradient on infeasible rows and at frames at or past a
    # row's length
    assert np.all(to_np(grad_emit)[~feas] == 0.0)
    for b, n in enumerate(arrays[1]):
        assert np.all(to_np(grad_emit)[b, max(n, 0):] == 0.0)


@pytest.mark.parametrize("case", ("mixed", "T1"))
def test_plain_gradient_matches_autodiff(case):
    """The analytic gradient of ctc_loss_plain against autodiff through the
    port's ops/ctc.py and the JAX package's, on the feasible rows. (Over
    the 30 frames of "wide", autodiff's own rounding through the recursion
    reaches 1.5e-5; that case is held to the interpret kernel above.)"""
    arrays = _inputs(1, case)
    lp = arrays[0]
    rnll, vjp = jax.vjp(lambda x: jctc.ctc_loss(
        x, *(jnp.asarray(a) for a in arrays[1:])), jnp.asarray(lp))
    feas = (np.asarray(rnll) < 1e29).astype(np.float32)
    rgrad = np.asarray(vjp(jnp.asarray(feas))[0])
    x, ll, lab, lab_len = _torch_args(arrays, torch.int64)
    nll = ctc_kernel.ctc_loss_plain(x, ll, lab, lab_len)[0]
    f = feas > 0
    np.testing.assert_allclose(to_np(nll)[f], np.asarray(rnll)[f],
                               rtol=1e-5, atol=0)
    grads = []
    for fn in (ctc.ctc_loss, ctc.ctc_loss_k3):
        xx = x.clone().requires_grad_(True)
        fn(xx, ll, lab, lab_len).backward(torch.from_numpy(feas))
        grads.append(to_np(xx.grad))
    for got in grads:
        np.testing.assert_allclose(got, rgrad, rtol=0, atol=1e-5)


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's outputs, bit
    for bit, and launches nothing; another dtype raises."""
    x, ll, lab, lab_len = _torch_args(_inputs(2, "mixed"), torch.int64)
    before = ctc_kernel.ctc_loss_fused.launches
    got = ctc_kernel.ctc_loss_fused(x, ll, lab, lab_len)
    ref = ctc_kernel.ctc_loss_plain(x, ll, lab, lab_len)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ctc_kernel.ctc_loss_fused.launches == before
    with pytest.raises(ValueError, match="float32"):
        ctc_kernel.ctc_loss_fused(x.double(), ll, lab, lab_len)
    with pytest.raises(ValueError, match="int32 or int64"):
        ctc_kernel.ctc_loss_fused(x, ll, lab.float(), lab_len)


def _launchable(R, NW, S):
    """ctc_launch's own checks (csrc/ctc_loss.cu) for a design."""
    return (R in ctc_kernel.STATES and NW in ctc_kernel.WARPS
            and 64 * NW <= ctc_kernel.max_threads(R) and S % 2 == 1
            and ctc_kernel.padded(S) >= S and ctc_kernel.padded(S) % 4 == 0)


def test_supports_and_the_design_rule_hold_for_every_lattice():
    """Every T up to 4096 and every S = 2U + 1 up to 4097: supports holds,
    and the design the wrapper picks (and every one the sweep times) is one
    the kernel launches, walking S in one chunk up to 2048 states."""
    for S in range(1, 4098, 2):
        assert all(ctc_kernel.supports(T, S) for T in range(1, 4097))
        cands = ctc_kernel.designs(S)
        assert ctc_kernel.pick(S) in cands
        for R, NW in cands:
            assert _launchable(R, NW, S)
            K = ctc_kernel.chunks(S, R, NW)
            assert K >= 1 and 32 * NW * R * K >= S
            assert K == 1 or S > 2048
    assert not ctc_kernel.supports(0, 5) and not ctc_kernel.supports(5, 4)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to see which route
    the callers pick there."""

    @property
    def is_cuda(self):
        return True


class _FakeLib:
    """Stands in for the built library: checks each call's argument count
    against the ctypes signatures and records ctc_launch's arguments."""

    def __init__(self):
        self.launches = []

    def __getattr__(self, name):
        _, argtypes = ctc_kernel._SIGNATURES[name]

        def call(*args):
            assert len(args) == len(argtypes), name
            if name == "ctc_smem_limit":
                args[1]._obj.value = 232448 - 528
            if name == "ctc_launch":
                self.launches.append(args)
            return 0
        return call


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_card_route_launches_k3_alone(monkeypatch, dtype):
    """On the card, ctc_loss_k3's forward goes straight to K3: prepare is
    never called (it raises here), and the only tensor ops before the
    launch are the output allocations (and a view of the gradient)."""
    x, ll, lab, lab_len = _torch_args(_inputs(3, "wide"), dtype)
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name, sig: lib)
    monkeypatch.setattr(ctc_kernel, "_stream", lambda device: 0)
    monkeypatch.setattr(ctc_kernel, "_SMEM_LIMIT", {})

    def no_prepare(*args, **kw):
        raise AssertionError("prepare called on the card route")

    monkeypatch.setattr(ctc_kernel, "prepare", no_prepare)
    # the fake launch counts too: the count is put back afterwards
    monkeypatch.setattr(ctc_kernel.ctc_loss_fused, "launches", 0)
    before = ctc_kernel.ctc_loss_fused.launches
    card = x.as_subclass(_OnCard).requires_grad_(True)
    with _Ops() as rec:
        ctc.ctc_loss_k3(card, ll, lab, lab_len)
    assert ctc_kernel.ctc_loss_fused.launches == before + 1
    assert len(lib.launches) == 1
    B, T, V = x.shape
    U = lab.shape[1]
    S = 2 * U + 1
    R, NW = ctc_kernel.pick(S)
    idx64 = 7 if dtype == torch.int64 else 0
    assert lib.launches[0][9:20] == (B, T, V, U, S, ctc_kernel.padded(S),
                                     R, NW, 0, idx64, 1)
    assert set(rec.ops) <= {"aten.empty.memory_format", "aten.slice.Tensor",
                            "aten.alias.default", "aten.detach.default",
                            "aten.view.default"}, rec.ops
    assert "aten.empty.memory_format" in rec.ops
