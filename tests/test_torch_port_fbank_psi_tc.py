"""The arithmetic and layouts of K1's and K6's Hopper designs, on the CPU.

K1 (``csrc/fbank.cu``) runs the windowed DFT on bf16 tensor cores as six
passes of a three-part split; ``split_power_spectrum`` spells that out (hi /
mid / lo parts of the frames and of the interleaved cos/-sin matrix, exact
products, f32 sums). Through the same mel product and log it must match the
JAX ``fbank_fused`` in interpret mode within the frontend tests' atol of
1e-4, and a float64 reference within 1e-4, which a single bf16 pass misses.
``span_frames`` gathers frames through the kernel's padded span layout.

K6 (``csrc/psi.cu``) walks T in 16-frame chunks with the hypotheses in
tiles of 8; ``psi_chunked_plain`` spells that out against ``psi_plain`` and
the JAX ``psi_fused`` in interpret mode (rtol / atol 2e-5, the blank and
last-token columns bit-equal). ``supports``, the kernel's own limits, must
cover every input the beam's gate ``pick_block`` admits."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from end_to_end_asr_pytorch_tpu.ops.pallas.fbank_kernel import (
    fbank_fused as jax_fbank_fused)
from end_to_end_asr_pytorch_tpu.ops.pallas.psi_kernel import psi_fused as jpsi
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import fbank_kernel as fk
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import psi_kernel as pk
from tests.torch_port_fixtures import to_np

torch.set_num_threads(1)
ATOL = 1e-4
NEG_INF = -1e30
KW = dict(n_fft=400, hop=160, log_eps=1e-10)


def fbank_inputs(case):
    """(wave (B, S) f32, [cosw, msinw, mel_fb]) for a 7 s utterance or three
    ragged ones with silent (zero) tails."""
    rng = np.random.RandomState(11)
    if case == "7s":
        w = (rng.randn(1, 7 * 16000) * 0.1).astype(np.float32)
    else:
        w = (rng.randn(3, 9600) * 0.1).astype(np.float32)
        for b, n in enumerate((9600, 5000, 1700)):
            w[b, n:] = 0.0
    fe = AudioFrontend({"feat_type": "fbank", "feat_dim": 40}, device="cpu")
    return w, [fe.cosw, fe.msinw, fe.mel_fb]


def float64_logmel(w, args):
    cosw, msinw, mel = (to_np(a).astype(np.float64) for a in args)
    frames = to_np(fk.frame_signal(torch.from_numpy(w).double(), 400, 160))
    re, im = frames @ cosw, frames @ msinw
    return np.log((re * re + im * im) @ mel + 1e-10)


@pytest.mark.parametrize("case", ["7s", "silent_tails"])
def test_split_fbank_matches_jax_interpret(case):
    w, args = fbank_inputs(case)
    ref = jax_fbank_fused(jnp.asarray(w), *[jnp.asarray(to_np(a)) for a in args],
                          interpret=True, **KW)
    got = fk.fbank_split_plain(torch.from_numpy(w), *args, **KW)
    assert got.shape == ref.shape == (w.shape[0], w.shape[1] // 160 + 1, 40)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL, rtol=0)
    if case == "silent_tails":       # whole frames of zeros: log(eps) exactly
        assert np.all(to_np(got)[2, 15:] == np.float32(np.log(np.float32(1e-10))))


@pytest.mark.parametrize("case", ["7s", "silent_tails"])
def test_split_fbank_is_f32_grade(case):
    """Within 1e-4 of float64 on the log-mel; one bf16 pass is not."""
    w, args = fbank_inputs(case)
    ref = float64_logmel(w, args)
    got = to_np(fk.fbank_split_plain(torch.from_numpy(w), *args, **KW))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    one_pass = lambda t: t.to(torch.bfloat16).float()
    frames = one_pass(fk.frame_signal(torch.from_numpy(w), 400, 160))
    y = frames @ one_pass(fk.interleave_dft(args[0], args[1]))
    power = y[..., 0::2] ** 2 + y[..., 1::2] ** 2
    single = to_np(torch.log(power @ args[2] + 1e-10))
    assert np.abs(single - ref).max() > 10 * ATOL


def test_interleave_dft_columns():
    _, (cosw, msinw, _) = fbank_inputs("silent_tails")
    d = fk.interleave_dft(cosw, msinw)
    assert d.shape == (400, 402)
    assert torch.equal(d[:, 0::2], cosw) and torch.equal(d[:, 1::2], msinw)


@pytest.mark.parametrize("n_fft,hop,S", [(400, 160, 112000), (400, 160, 201),
                                         (320, 80, 4000), (800, 160, 3000)])
def test_span_frames_equal_frame_signal(n_fft, hop, S):
    """Every tile's frames gathered through the kernel's span layout (rows
    of hop samples, reflect indices, NaN in the row padding) equal
    ``frame_signal``'s, tail tiles and sub-window waves included."""
    rng = np.random.RandomState(S)
    wave = torch.from_numpy((rng.randn(2, S) * 0.1).astype(np.float32))
    ref = fk.frame_signal(wave, n_fft, hop)
    T = ref.shape[1]
    rows, rs = fk.span_layout(n_fft, hop)
    assert (rs * 2 // 16) % 2 == 1 and rows * hop >= (fk.TILE - 1) * hop + n_fft
    for t0 in range(0, T, fk.TILE):
        nf = min(fk.TILE, T - t0)
        got = fk.span_frames(wave, n_fft, hop, t0)
        assert not torch.isnan(got[:, :nf]).any()
        assert torch.equal(got[:, :nf], ref[:, t0:t0 + nf])


def budget_ts(itemsize):
    """T values up to one past the gate's budget (4 MiB / (128 itemsize)):
    every T to 64, then a stride, then both sides of the limit."""
    limit = 4 * 1024 * 1024 // (128 * itemsize)
    ts = set(range(1, 65)) | set(range(65, limit, 97))
    return sorted(ts | {limit - 1, limit, limit + 1}), limit


@pytest.mark.parametrize("itemsize", [2, 4])
def test_kernel_supports_every_input_the_gate_takes(itemsize):
    ts, limit = budget_ts(itemsize)
    taken = 0
    for V in range(128, 16384 + 1, 128):
        for T in ts:
            if pk.pick_block(V, T, itemsize) is not None:
                assert pk.supports(V, T, itemsize), (V, T, itemsize)
                taken += 1
    assert pk.pick_block(128, limit, itemsize) == 128
    assert pk.pick_block(128, limit + 1, itemsize) is None
    assert taken > 128 * 64
    assert not pk.supports(100, 176, 2) and not pk.supports(5120, 0, 2)


def psi_inputs(K, T, dtype, seed=5, B=2, V=256):
    """Raw K6 inputs: Dirichlet probs rows (one frame-padded row blank-only,
    an all-zero column 77), wd in (0, 1], last tokens on blank, block edges
    and the zero column."""
    rng = np.random.RandomState(seed + K)
    p = rng.dirichlet(np.ones(V) * 0.3, size=(B, T)).astype(np.float32)
    p[1, T - 9:] = 0.0
    p[1, T - 9:, 0] = 1.0
    p[:, :, 77] = 0.0
    wd = np.exp(-rng.uniform(0, 6, (B, K, T))).astype(np.float32)
    md = rng.uniform(-60, -1, (B, K)).astype(np.float32)
    ps = rng.uniform(-60, -1, (B, K)).astype(np.float32)
    edges = [0, 127, 128, 255, 1, 77, 3, 129, 15, 16, 8, 7]
    last = np.array((edges * B)[:B * K] if K <= len(edges) else
                    rng.randint(0, V, (B * K,)), np.int32).reshape(B, K)
    jp = jnp.asarray(p).astype(jnp.bfloat16) if dtype == "bf16" else jnp.asarray(p)
    tp = torch.from_numpy(p)
    tp = tp.to(torch.bfloat16) if dtype == "bf16" else tp
    t = torch.from_numpy
    return ((t(wd), tp, t(md), t(ps), t(last)),
            (jnp.asarray(wd), jp, jnp.asarray(md), jnp.asarray(ps),
             jnp.asarray(last)))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("K", [8, 12])
def test_psi_chunked_walk_matches_plain_and_jax(K, dtype):
    """T=37 (two whole chunks and a zero-padded one), K in one or two
    tiles of 8 hypotheses."""
    targs, jargs = psi_inputs(K, 37, dtype)
    got = to_np(pk.psi_chunked_plain(*targs))
    plain = to_np(pk.psi_plain(*targs))
    ref = np.asarray(jpsi(*jargs, interpret=True))
    last = to_np(targs[4])
    for other in (plain, ref):
        mask = other > NEG_INF / 2
        np.testing.assert_allclose(got[mask], other[mask], rtol=2e-5,
                                   atol=2e-5)
        assert np.all(got[:, :, 0] == other[:, :, 0])
        np.testing.assert_array_equal(
            np.take_along_axis(got, last[..., None], 2),
            np.take_along_axis(other, last[..., None], 2))
    zero = got[:, :, 77][last != 77]
    want = to_np(targs[2])[last != 77] + np.log(np.float32(1e-38))
    np.testing.assert_allclose(zero, want, rtol=0, atol=2e-5)
