"""The arithmetic of the Hopper designs of K4b and K8 on the CPU.

The kernels run only on the card; the plain helpers beside them spell out
what they compute, and are held here:

  * K4b's step product dhp @ W_hh^T on bf16 tensor cores
    (``scan_tc.split_product(dhp, w_hh.t())``): within 2e-7 sum |dhp| |w|
    of the float64 product, across magnitudes, with zeros and negatives
    (the dropped cross terms are below 2^-23 of each product, the rest is
    f32 summation order); a backward scan whose carry product goes through
    it, in the kernel's epilogue order, matches ``gru_bwd_steps_plain``
    within the chip check's atol 1e-4 (measured ~1e-7); and the block split
    ``plan_bwd`` covers the repository's widths.
  * K8's joint top-K over vocabulary slices (``split_top_k``): equal to the
    stable global top-K (values and flat indices exactly), on random
    scores, exact ties and mass ties of -1e30, for slices that do not
    divide V and slices narrower than K; its normaliser combined over the
    slices (``combined_log_norm``) within 1e-6 of ``torch.logsumexp``
    relative to the row's magnitude (f32 rounding of values up to ~20);
    and the cluster size ``clusters`` leaves no slice empty.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import beam_step_kernel as bsk
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import gru_kernel, scan_tc

torch.set_num_threads(1)


# --------------------------------------------------------------------- K4b
@pytest.mark.parametrize("mag", [1e-20, 1e-6, 1e-3, 1.0, 1e3])
def test_split_backward_product_within_bound_of_f64(mag):
    rng = np.random.RandomState(int(-np.log10(mag)) + 30)
    B, H = 8, 64
    dhp = (rng.randn(B, 3 * H) * mag).astype(np.float32)
    dhp[:, ::7] = 0.0
    dhp[3] = 0.0
    w_hh = rng.uniform(-0.125, 0.125, (H, 3 * H)).astype(np.float32)
    w = torch.from_numpy(w_hh)
    assert scan_tc.has_bf16_remainder(w)      # training W_hh: all passes
    got = scan_tc.split_product(torch.from_numpy(dhp), w.t()).double().numpy()
    ref = dhp.astype(np.float64) @ w_hh.astype(np.float64).T
    bound = 2e-7 * (np.abs(dhp).astype(np.float64)
                    @ np.abs(w_hh).astype(np.float64).T)
    assert np.all(np.abs(got - ref) <= bound)
    assert np.all(got[3] == 0.0)


def _split_bwd_steps(gates, hp_n, ys, mask, w_hh, dys, reverse):
    """The backward recurrence as the tensor-core kernel runs it: the carry
    product through the split product, then the epilogue of GruBwdCell
    (dh_carry = p + st; st = m dh z + (1 - m) dh_carry)."""
    T, B, G = gates.shape
    H = G // 3
    hs_prev = gru_kernel._prev_step(ys, reverse)
    st = torch.zeros((B, H))
    prev = torch.zeros((B, G))
    dxp, dhp = torch.zeros((T, B, G)), torch.zeros((T, B, G))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        r, z, n = gates[t].split(H, dim=-1)
        m = mask[t][:, None].float()
        dh_carry = scan_tc.split_product(prev, w_hh.t()) + st
        dh = dh_carry + dys[t]
        dz = dh * (hs_prev[t] - n)
        dan = dh * (1.0 - z) * (1.0 - n * n)
        dar = m * ((dan * hp_n[t]) * r * (1.0 - r))
        daz = m * (dz * z * (1.0 - z))
        dxp[t] = torch.cat([dar, daz, m * dan], -1)
        dhp[t] = torch.cat([dar, daz, m * (dan * r)], -1)
        st = m * (dh * z) + (1.0 - m) * dh_carry
        prev = dhp[t]
    return dxp, dhp


@pytest.mark.parametrize("reverse", [False, True])
def test_split_backward_scan_matches_plain(reverse):
    rng = np.random.RandomState(7 + reverse)
    T, B, H = 20, 5, 32
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    xp = t(rng.randn(T, B, 3 * H) * 0.5)
    w_hh = t(rng.uniform(-1, 1, (H, 3 * H)) / np.sqrt(H))
    b_hh = t(rng.randn(3 * H) * 0.3)
    lens = np.asarray([T, T - 4, 11, 1, 16])
    mask = torch.from_numpy(np.arange(T)[:, None] < lens[None, :])
    dys = t(rng.randn(T, B, H))
    ys, gates, hp_n = gru_kernel.gru_scan_fwd_plain(xp, w_hh, b_hh, mask,
                                                    reverse)
    ref = gru_kernel.gru_bwd_steps_plain(gates, hp_n, ys, mask, w_hh, dys,
                                         reverse)
    got = _split_bwd_steps(gates, hp_n, ys, mask, w_hh, dys, reverse)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-4
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H", [64, 128, 256, 300, 320, 512, 1024])
@pytest.mark.parametrize("n_gates", [3, 4])
def test_plan_bwd_covers_the_repo_widths(H, n_gates):
    C, U, kw, kg = scan_tc.plan_bwd(H, n_gates)
    assert C * U == H and U % 4 == 0
    assert 1 <= kw <= 16 and 16 * kw * kg >= n_gates * H
    assert 16 * kw * (kg - 1) < n_gates * H       # no idle k-group
    assert scan_tc.warps_bwd(H, n_gates) == -(-U // 16) * kg <= 16
    # a cluster for the main path's widths, a grid only where none fits
    assert (C <= 16) == (H <= 512)
    if H == 512:                    # K4b and K2b on the main path
        want = {3: (16, 32, 16, 6), 4: (16, 32, 16, 8)}[n_gates]
        assert (C, U, kw, kg) == want


@pytest.mark.parametrize("H", [6, 250, 4096])
def test_plan_bwd_rejects_what_the_kernel_does_not_take(H):
    with pytest.raises(ValueError, match="backward scan"):
        scan_tc.plan_bwd(H, 3)


# ---------------------------------------------------------------------- K8
def _scores(case, B, K, V, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, K, V).astype(np.float32) * 3
    if case == "ties":
        x = np.round(x)                               # many exact ties
    elif case == "mass_ties":
        x[0] = -1e30                                  # a dead utterance
        x[1, 1:] = -1e30                              # one live slot
        x[2, :, ::2] = -1e30
        x[3, :, :] = np.round(x[3])
    return torch.from_numpy(x)


@pytest.mark.parametrize("case", ["random", "ties", "mass_ties"])
@pytest.mark.parametrize("V,C", [(31, 1), (5120, 16), (999, 4), (1000, 3),
                                 (20, 10), (13, 13)])
def test_split_top_k_equals_stable_global_top_k(case, V, C):
    B, K = 4, 8
    x = _scores(case, B, K, V, seed=V + C)
    got_v, got_i = bsk.split_top_k(x, C, K)
    ref_v, ref_i = bsk.top_k(x.reshape(B, K * V), K)
    assert torch.equal(got_i, ref_i)
    assert torch.equal(got_v, ref_v)


@pytest.mark.parametrize("V,C", [(31, 1), (5120, 16), (999, 4), (1000, 3)])
def test_combined_normaliser_matches_logsumexp(V, C):
    rng = np.random.RandomState(V)
    x = torch.from_numpy((rng.randn(4, 8, V) * 3).astype(np.float32))
    x[0, 0, 5] = 40.0                                 # one dominant logit
    got = bsk.combined_log_norm(x, C)
    ref = torch.logsumexp(x, -1)
    assert torch.all((got - ref).abs() <= 1e-6 * ref.abs().clamp_min(1.0))


def test_clusters_leave_no_slice_empty():
    assert all(bsk.clusters(V) == 1 for V in (1, 31, 128, bsk.SLICE))
    assert bsk.clusters(5120) == 16
    for V in range(1, 12000, 7):
        C = bsk.clusters(V)
        vs = -(-V // C)
        assert 1 <= C <= bsk.MAX_CLUSTER and (C - 1) * vs < V
