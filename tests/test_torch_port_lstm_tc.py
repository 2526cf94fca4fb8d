"""The arithmetic of K2 (f32) and K2b on the tensor-core scans of
``csrc/scan_tc.cuh`` on the CPU, and the launch schedule of those scans.

The kernels run only on the card; the plain helpers beside them spell out
what they compute, and are held here against the port's plain versions and
against the JAX package's TPU kernels in interpret mode, at small widths
(H=64 and 128, T=12, both directions, ragged masks):

  * K2b: ``lstm_bwd_steps_plain`` (the carry product dgates @ W_hh^T
    through ``scan_tc.split_product``, then ``LstmBwdCell``'s epilogue in
    its order) against ``lstm_scan_bwd_plain`` within the chip check's atol
    1e-4 (measured ~1e-7: the split product equals the f32 one up to
    summation order), and with dW_hh (``dw_hh``) against ``jax.vjp`` of
    the TPU kernel's custom VJP (``_run_bwd``) at rtol 1e-4 / atol 1e-6,
    the tolerance the plain backward is held to there.
  * K2 in f32 with residuals: a scan whose step product is the split
    product over an f32 W_hh that bf16 does not hold (the remainder
    passes) against the TPU kernel's ``_run_fwd`` in interpret mode: ys,
    cell states and gates within atol 1e-5 (f32, sums in another order).
  * The schedule (``scan_tc.schedule`` / ``launches``) that ``run`` and
    ``run_bwd`` follow and the launch counters report, on an occupancy
    table of the H100's shape: one launch where the groups fit, one per
    wave of a cooperative grid where they do not, and 8-row groups in
    waves where a block of 16 rows does not fit (K2b at H=512).
"""
import ctypes
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.ops.pallas import lstm_kernel as jlk
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel as lk
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import scan_tc

torch.set_num_threads(1)
T = 12
LENS = np.asarray([12, 9, 12, 4, 1])


def _inputs(seed, H):
    rng = np.random.RandomState(seed)
    B = len(LENS)
    xp = (rng.randn(T, B, 4 * H) * 0.5).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = np.arange(T)[:, None] < LENS[None, :]
    dys = rng.randn(T, B, H).astype(np.float32)
    return xp, w_hh, mask, dys


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H", [64, 128])
def test_split_backward_steps_match_plain_backward(H, reverse):
    xp, w_hh, mask, dys = (torch.from_numpy(a) for a in _inputs(H + reverse, H))
    assert scan_tc.has_bf16_remainder(w_hh)    # training W_hh: six passes
    ys, cs, gates = lk.lstm_scan_fwd_plain(xp, w_hh, mask, reverse)
    ref, ref_dw = lk.lstm_scan_bwd_plain(gates, cs, ys, mask, w_hh, dys,
                                         reverse)
    got = lk.lstm_bwd_steps_plain(gates, cs, mask, w_hh, dys, reverse)
    assert float((got - ref).abs().max()) <= 1e-4
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lk.dw_hh(ys, got, reverse), ref_dw,
                               rtol=1e-5, atol=1e-5)
    # masked steps give exactly zero gate gradients
    assert bool((got[~mask] == 0).all())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H", [64, 128])
def test_split_backward_steps_match_pallas_vjp(H, reverse):
    """dxp of K2b's arithmetic, and dW_hh from it, against jax.vjp of the
    TPU kernel's custom VJP (its _run_bwd) in interpret mode."""
    xp, w_hh, mask, dys = _inputs(2 * H + reverse, H)
    f = lambda x, w: jlk.lstm_scan_fused(x, w, jnp.asarray(mask), reverse,
                                         True)
    _, vjp = jax.vjp(f, jnp.asarray(xp), jnp.asarray(w_hh))
    rdx, rdw = (np.asarray(a) for a in vjp(jnp.asarray(dys)))
    tx, tw, tm, tdy = (torch.from_numpy(a) for a in (xp, w_hh, mask, dys))
    ys, cs, gates = lk.lstm_scan_fwd_plain(tx, tw, tm, reverse)
    dxp = lk.lstm_bwd_steps_plain(gates, cs, tm, tw, tdy, reverse)
    np.testing.assert_allclose(_np(dxp), rdx, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(lk.dw_hh(ys, dxp, reverse)), rdw,
                               rtol=1e-4, atol=1e-6)


def _split_fwd(x_proj, w_hh, mask, reverse):
    """K2's f32 forward with residuals as the tensor-core scan computes it:
    the step product through the split product, then LstmCellT's epilogue
    (the carried cell state and the post-activation gates kept)."""
    T_, B, G = x_proj.shape
    H = G // 4
    h, c = torch.zeros(B, H), torch.zeros(B, H)
    ys, cs, gs = (torch.zeros(T_, B, n) for n in (H, H, G))
    for t in (range(T_ - 1, -1, -1) if reverse else range(T_)):
        pre = x_proj[t] + scan_tc.split_product(h, w_hh)
        i, f, o = (torch.sigmoid(pre[:, k * H:(k + 1) * H]) for k in (0, 1, 3))
        g = torch.tanh(pre[:, 2 * H:3 * H])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None]
        c = torch.where(m, c_new, c)
        h = torch.where(m, h_new, h)
        ys[t] = torch.where(m, h_new, torch.zeros(()))
        cs[t] = c
        gs[t] = torch.cat([i, f, g, o], -1)
    return ys, cs, gs


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H", [64, 128])
def test_split_lstm_scan_residuals_match_pallas_interpret(H, reverse):
    """K2 in f32 on the tensor cores (an unrounded W_hh, so the remainder
    passes run) against _run_fwd in interpret mode: ys, cs and gates."""
    xp, w_hh, mask, _ = _inputs(3 * H + reverse, H)
    assert scan_tc.has_bf16_remainder(torch.from_numpy(w_hh))
    _, (_, _, _, jys, jcs, jgates) = jlk._fused_fwd(
        jnp.asarray(xp), jnp.asarray(w_hh), jnp.asarray(mask), reverse, True)
    flip = (lambda a: np.asarray(a)[::-1]) if reverse else np.asarray
    got = _split_fwd(*(torch.from_numpy(a) for a in (xp, w_hh, mask)),
                     reverse)
    for g, r in zip(got, (jys, jcs, jgates)):
        np.testing.assert_allclose(_np(g), flip(r), atol=1e-5, rtol=0)
    assert np.all(_np(got[0])[~mask] == 0.0)


# ------------------------------------------------------------- the schedule
def _query(table):
    """An occupancy query with the shared library's signature that reports
    ``table[(mode, rows)]`` groups resident at once."""
    def query(H, U, C, kw, kg, rows, mode, out):
        out._obj.value = table.get((mode, rows), 0)
        return 0
    query.__name__ = f"fake_{id(table)}"
    return query


@pytest.fixture
def one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    scan_tc._groups.clear()
    yield
    scan_tc._groups.clear()


C_, G_ = scan_tc.CLUSTER, scan_tc.GRID
# at H=512 on an H100: 16-block groups, at most 7 clusters or 8 grid groups;
# K2b's blocks of 16 rows do not fit (shared memory)
FWD_H100 = {(C_, 8): 7, (C_, 16): 7, (G_, 8): 8, (G_, 16): 8}
BWD_H100 = {(C_, 8): 7, (G_, 8): 8}


@pytest.mark.parametrize("B,want", [
    (32, (C_, 8, 4, 4, 1)),        # 8-row clusters fit: one launch
    (56, (C_, 8, 7, 7, 1)),
    (128, (G_, 16, 8, 8, 1)),      # one grid of 8 groups of 16 rows
    (200, (C_, 16, 13, 13, 1)),    # clusters in waves: one launch
])
def test_forward_schedule(one_card, B, want):
    q = _query(FWD_H100)
    got = scan_tc.schedule(q, 512, 4, B)
    assert got == want[:4]
    assert scan_tc.launches(q, 512, 4, B) == want[4]


@pytest.mark.parametrize("B,want", [
    (32, (G_, 8, 4, 4, 1)),        # the grid first: one launch
    (64, (G_, 8, 8, 8, 1)),
    (128, (G_, 8, 16, 8, 2)),      # 8-row grids in two waves
    (136, (G_, 8, 17, 8, 3)),
])
def test_backward_schedule_takes_8_row_waves(one_card, B, want):
    q = _query(BWD_H100)
    got = scan_tc.schedule(q, 512, 4, B, scan_tc.plan_bwd, True)
    assert got == want[:4]
    assert scan_tc.launches(q, 512, 4, B, scan_tc.plan_bwd, True) == want[4]
    assert scan_tc.plan_bwd(512, 4) == (16, 32, 16, 8)


@pytest.mark.parametrize("B,launches", [(32, 1), (128, 4)])
def test_grid_only_width_launches_per_wave(one_card, B, launches):
    """H=1024 splits into 64 blocks: a grid only, two groups at a time."""
    q = _query({(G_, 8): 2, (G_, 16): 2})
    assert scan_tc.plan(1024, 4)[0] == 64
    mode, rows, groups, per = scan_tc.schedule(q, 1024, 4, B)
    assert (mode, rows) == (G_, 16)
    assert scan_tc.launches(q, 1024, 4, B) == launches == -(-groups // per)


def test_forced_design_keeps_its_rows(one_card):
    q = _query(FWD_H100)
    assert scan_tc.schedule(q, 512, 4, 128, mode=G_, rows=8) == (G_, 8, 16, 8)
    assert scan_tc.schedule(q, 512, 4, 128, mode=C_, rows=8) == (C_, 8, 16, 16)
