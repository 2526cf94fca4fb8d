"""The arithmetic of the tensor-core scans K2-bf16 / K4-bf16
(``ops/cuda/scan_tc.py``, ``csrc/scan_tc.cuh``) on the CPU.

The kernels run only on the card; their arithmetic is spelled out by the
plain helpers of ``scan_tc``, held here: the three-part bf16 split of the
f32 carry is exact, the split product over a bf16-valued W_hh equals the
f32 product, the remainder test tells a bf16-valued W_hh from one that is
not, and the block split covers the widths the repository's configurations
use. Then LSTM and GRU scans whose step product is ``split_product`` are
held against the JAX package's TPU kernels in interpret mode on bf16 x_proj,
as the port's plain bf16 scans are.

Tolerances, with their reasons:
  * the split: exact (hi + mid + lo == h, summed in float64);
  * the split product: within 2e-7 * sum |h| |w| of the f32 product and of
    the float64 product (both are sums of the same exact products in f32,
    in another order);
  * the scans: ys within 1 bf16 ulp (the f32 value before rounding differs
    in the last bits).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.ops.pallas import gru_kernel as jgk
from end_to_end_asr_pytorch_tpu.ops.pallas import lstm_kernel as jlk
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import scan_tc

BF = torch.bfloat16


def _f64(t):
    return t.double().numpy()


@pytest.mark.parametrize("mag", [1e-30, 1e-20, 1e-10, 1e-6, 1e-3, 1.0, 1e3])
def test_split3_sums_to_h(mag):
    rng = np.random.RandomState(int(-np.log10(mag) + 40))
    h = (rng.uniform(1.0, 10.0, 4096) * mag
         * rng.choice([-1.0, 1.0], 4096)).astype(np.float32)
    h[::97] = 0.0
    hi, mid, lo = scan_tc.split3(torch.from_numpy(h))
    assert hi.dtype == mid.dtype == lo.dtype == BF
    np.testing.assert_array_equal(_f64(hi) + _f64(mid) + _f64(lo),
                                  h.astype(np.float64))
    # each part is the nearest bf16 of what the earlier parts leave
    np.testing.assert_array_equal(_f64(hi), _f64(torch.from_numpy(h).to(BF)))


def test_split3_of_zeros_and_negation():
    h = torch.from_numpy(np.random.RandomState(1).randn(512).astype(np.float32))
    for a, b in zip(scan_tc.split3(-h), scan_tc.split3(h)):
        assert torch.equal(a, -b)
    zero = torch.zeros(64)
    assert all(bool((p == 0).all()) for p in scan_tc.split3(zero))


@pytest.mark.parametrize("B,H,N", [(4, 16, 64), (32, 128, 384), (16, 512, 2048)])
def test_split_product_equals_f32_product(B, H, N):
    rng = np.random.RandomState(H)
    h = torch.from_numpy(np.tanh(rng.randn(B, H)).astype(np.float32))
    s = 1.0 / np.sqrt(H)
    w = torch.from_numpy(rng.uniform(-s, s, (H, N)).astype(np.float32))
    w = w.to(BF).float()                       # bf16-valued, as decode amp
    assert not scan_tc.has_bf16_remainder(w)
    got = _f64(scan_tc.split_product(h, w))
    scale = np.abs(_f64(h)) @ np.abs(_f64(w))
    assert np.all(np.abs(got - _f64(h @ w)) <= 2e-7 * scale)
    assert np.all(np.abs(got - _f64(h) @ _f64(w)) <= 2e-7 * scale)


def test_split_product_with_remainder_equals_f32_product():
    """An f32 W_hh that bf16 does not hold takes the remainder passes."""
    rng = np.random.RandomState(7)
    h = torch.from_numpy(np.tanh(rng.randn(8, 256)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.06, 0.06, (256, 768)).astype(np.float32))
    assert scan_tc.has_bf16_remainder(w)
    got = _f64(scan_tc.split_product(h, w))
    scale = np.abs(_f64(h)) @ np.abs(_f64(w))
    assert np.all(np.abs(got - _f64(h) @ _f64(w)) <= 2e-7 * scale)
    # without the remainder passes the product is only bf16-accurate in w
    hi_only = _f64(h) @ _f64(w.to(BF).float())
    assert np.abs(hi_only - _f64(h) @ _f64(w)).max() > 1e-4 * scale.max()


@pytest.mark.parametrize("where", [0, 777, -1])
def test_remainder_test_finds_one_ulp(where):
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(64, 256).astype(np.float32)).to(BF).float()
    assert not scan_tc.has_bf16_remainder(w)
    flat = w.numpy().reshape(-1).copy()
    flat[where] = np.nextafter(flat[where], np.float32(np.inf))
    assert scan_tc.has_bf16_remainder(torch.from_numpy(flat.reshape(64, 256)))


@pytest.mark.parametrize("H", [64, 128, 192, 256, 300, 320, 512, 1024])
@pytest.mark.parametrize("n_gates", [4, 3])
def test_plan_covers_the_repo_widths(H, n_gates):
    C, U, kw, kg = scan_tc.plan(H, n_gates)
    ks = -(-H // 16)
    assert C * U == H and U % 4 == 0
    assert kw <= 16 and kw * kg >= ks and kw * (kg - 1) < ks
    assert scan_tc.warps(H, n_gates) == -(-n_gates * U // 16) * kg
    assert scan_tc.warps(H, n_gates) <= scan_tc.MAX_WARPS
    if H == 512:                    # the main path: clusters of 16 blocks
        assert (C, U, kw, kg) == (16, 32, 16, 2)
    # up to 512 a cluster holds W_hh; 1024 needs a grid of 64 blocks
    assert (C <= scan_tc.MAX_CLUSTER) == (H <= 512)
    if H == 1024:
        assert (C, U) == (64, 16)


@pytest.mark.parametrize("H,n_gates", [(6, 4), (250, 3), (4100, 4)])
def test_plan_rejects_what_the_kernel_does_not_take(H, n_gates):
    with pytest.raises(ValueError, match="tensor-core scan"):
        scan_tc.plan(H, n_gates)


def _block_product(h, w, n_gates):
    """h @ w as the kernel's blocks compute it under ``plan``: block `rank`
    takes its U units of every gate, zero-padded to m-tiles of 16 columns,
    over H zero-padded to k-steps of 16; warp k-group j sums its kw k-steps
    (hi . w_hi in one f32 sum, the smaller terms in another), and the
    epilogue adds the k-groups' partial sums in order."""
    B, H = h.shape
    C, U, kw, kg = scan_tc.plan(H, n_gates)
    ks = -(-H // 16)
    mt = -(-n_gates * U // 16)
    hp = torch.zeros(B, 16 * ks)
    hp[:, :H] = h
    hi, mid, lo = (p.float() for p in scan_tc.split3(hp))
    rem = scan_tc.has_bf16_remainder(w)
    out = torch.zeros(B, n_gates * H)
    for rank in range(C):
        cols = [g * H + rank * U + u for g in range(n_gates) for u in range(U)]
        ws = torch.zeros(16 * ks, 16 * mt)
        ws[:H, :len(cols)] = w[:, cols]
        w_hi, w_mid, w_lo = (p.float() for p in scan_tc.split3(ws))
        total = None
        for j in range(kg):
            k = slice(16 * kw * j, 16 * min(kw * (j + 1), ks))
            acc = hi[:, k] @ w_hi[k]
            acl = mid[:, k] @ w_hi[k] + lo[:, k] @ w_hi[k]
            if rem:
                acl = (acl + hi[:, k] @ w_mid[k] + mid[:, k] @ w_mid[k]
                       + hi[:, k] @ w_lo[k])
            part = acc + acl
            total = part if total is None else total + part
        out[:, cols] = total[:, :len(cols)]
    return out


@pytest.mark.parametrize("rounded", [True, False])
@pytest.mark.parametrize("H,n_gates", [(192, 4), (300, 4), (300, 3),
                                       (320, 4), (320, 3), (1024, 4)])
def test_block_split_product_equals_f32_product(H, n_gates, rounded):
    """The padded block split (widths whose units are not a multiple of 8,
    whose gate columns or H are not a multiple of 16, and the grid-only
    split of H=1024) sums the same exact products as the f32 product."""
    rng = np.random.RandomState(H + n_gates)
    h = torch.from_numpy(np.tanh(rng.randn(4, H)).astype(np.float32))
    s = 1.0 / np.sqrt(H)
    w = torch.from_numpy(rng.uniform(-s, s, (H, n_gates * H)).astype(np.float32))
    if rounded:
        w = w.to(BF).float()
    got = _f64(_block_product(h, w, n_gates))
    scale = np.abs(_f64(h)) @ np.abs(_f64(w))
    assert np.all(np.abs(got - _f64(h) @ _f64(w)) <= 2e-7 * scale)


def _split_scan(x_proj, w_hh, mask, reverse, step):
    """A scan whose step product is the kernel's split product: f32 carry,
    ys rounded once to bf16."""
    T, B, _ = x_proj.shape
    H = w_hh.shape[0]
    h = torch.zeros(B, H)
    state = torch.zeros(B, H)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        p = scan_tc.split_product(h, w_hh)
        h_new, s_new = step(x_proj[t].float(), p, h, state)
        m = mask[t][:, None]
        h = torch.where(m, h_new, h)
        state = torch.where(m, s_new, state)
        ys[t] = torch.where(m, h_new, torch.zeros(()))
    return torch.stack(ys).to(BF)


def _lstm_step(x, p, h, c):
    i, f, g, o = (x + p).split(h.shape[1], dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _assert_within_bf16_ulp(got, ref):
    g = got.float().numpy()
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    bad = np.abs(g - r) > np.maximum(np.abs(g), np.abs(r)) * 2.0 ** -7
    assert not bad.any(), (np.abs(g - r)[bad].max(), int(bad.sum()))


def _inputs(seed, G, H=16, T=9):
    rng = np.random.RandomState(seed)
    xp = (rng.randn(T, 3, G) * 0.8).astype(np.float32)
    w = rng.uniform(-0.25, 0.25, (H, G)).astype(np.float32)
    b = rng.uniform(-0.25, 0.25, (G,)).astype(np.float32)
    mask = np.arange(T)[:, None] < np.array([T, 6, 1])[None, :]
    return xp, w, b, mask


@pytest.mark.parametrize("rounded", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_split_lstm_scan_matches_pallas_interpret(reverse, rounded):
    """K2-bf16's arithmetic against the TPU kernel in interpret mode on
    bf16 x_proj, with W_hh rounded to bf16 (decode amp) and unrounded."""
    H = 16
    xp, w, _, mask = _inputs(11 + reverse, 4 * H)
    if rounded:
        w = np.asarray(torch.from_numpy(w).to(BF).float())
    xb = torch.from_numpy(xp).to(BF)
    got = _split_scan(xb, torch.from_numpy(w), torch.from_numpy(mask),
                      reverse, _lstm_step)
    ref = jlk.lstm_scan_fused(jnp.asarray(xp).astype(jnp.bfloat16),
                              jnp.asarray(w), jnp.asarray(mask), reverse,
                              True)
    _assert_within_bf16_ulp(got, ref)
    assert np.all(got.float().numpy()[~mask] == 0.0)


@pytest.mark.parametrize("rounded", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_split_gru_scan_matches_pallas_interpret(reverse, rounded):
    """K4-bf16's arithmetic (b_hh added to the split product) against the
    TPU kernel in interpret mode on bf16 x_proj."""
    H = 16
    xp, w, b, mask = _inputs(21 + reverse, 3 * H)
    if rounded:
        w = np.asarray(torch.from_numpy(w).to(BF).float())
    bt = torch.from_numpy(b)

    def step(x, p, h, _):
        hp = p + bt
        r = torch.sigmoid(x[:, :H] + hp[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + hp[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * hp[:, 2 * H:])
        return (1.0 - z) * n + z * h, _

    got = _split_scan(torch.from_numpy(xp).to(BF), torch.from_numpy(w),
                      torch.from_numpy(mask), reverse, step)
    ref = jgk.gru_scan_fused(jnp.asarray(xp).astype(jnp.bfloat16),
                             jnp.asarray(w), jnp.asarray(b),
                             jnp.asarray(mask), reverse, True)
    _assert_within_bf16_ulp(got, ref)
    assert np.all(got.float().numpy()[~mask] == 0.0)
