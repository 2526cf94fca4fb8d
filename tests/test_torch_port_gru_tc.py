"""The arithmetic of K4 in f32 on the tensor-core scan of
``csrc/scan_tc.cuh`` on the CPU, and its launch schedule.

The kernel runs only on the card; the plain helper here spells out what it
computes: each step's product h @ W_hh through ``scan_tc.split_product``
over an f32 W_hh that bf16 does not hold (so the remainder passes run, as
for the W_hh of training and of the f32 decode), then ``GruCellT``'s
epilogue with b_hh (hp = p + b_hh; r, z, n; h' = (1 - z) n + z h) and its
residuals (the post-activation gates and hp_n). It is held to the JAX
package's TPU kernel ``_run_fwd`` in interpret mode at H=64 and 128, T=12
and 9 (the TPU kernel's UNROLL of 4 divides 12, not 9), both directions,
ragged masks: ys, gates and hp_n within atol 1e-5 (f32, sums in another
order), as K2's split forward is. The schedule (``scan_tc.schedule`` /
``launches``) of the GRU's three gates at H=512 follows an occupancy table
of the H100's shape, and the cooperative f32 forward's unit picker is gone.
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
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import gru_kernel, scan_tc

torch.set_num_threads(1)
LENS = np.asarray([12, 9, 12, 4, 1])


def _inputs(seed, H, T):
    """x_proj (T, B, 3H), an unrounded W_hh, a non-zero b_hh (its n third
    sits under the reset gate) and a ragged mask (lengths cut to T)."""
    rng = np.random.RandomState(seed)
    B = len(LENS)
    xp = (rng.randn(T, B, 3 * H) * 0.5).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    b_hh = (rng.randn(3 * H) * 0.3).astype(np.float32)
    mask = np.arange(T)[:, None] < np.minimum(LENS, T)[None, :]
    return xp, w_hh, b_hh, mask


def _split_fwd(x_proj, w_hh, b_hh, mask, reverse):
    """K4's f32 forward with residuals as the tensor-core scan computes it:
    the step product through the split product, then GruCellT's epilogue
    (gates and hp_n kept for every step, masked or not)."""
    T, B, G = x_proj.shape
    H = G // 3
    h = torch.zeros(B, H)
    ys, gs, hps = (torch.zeros(T, B, n) for n in (H, G, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hp = scan_tc.split_product(h, w_hh) + b_hh
        xp = x_proj[t]
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
        n = torch.tanh(xp[:, 2 * H:] + r * hp[:, 2 * H:])
        h_new = (1.0 - z) * n + z * h
        m = mask[t][:, None]
        h = torch.where(m, h_new, h)
        ys[t] = torch.where(m, h_new, torch.zeros(()))
        gs[t] = torch.cat([r, z, n], -1)
        hps[t] = hp[:, 2 * H:]
    return ys, gs, hps


def _jax_fwd(xp, w_hh, b_hh, mask, reverse):
    """_run_fwd in interpret mode as _g_fwd calls it (x_proj and mask
    flipped when reversed): (ys, gates, hp_n) in real-time order."""
    walk = (lambda a: a[::-1]) if reverse else (lambda a: a)
    m = mask.astype(np.float32)[:, :, None]
    out = jgk._run_fwd(jnp.asarray(walk(xp)), jnp.asarray(walk(m)),
                       jnp.asarray(w_hh), jnp.asarray(b_hh), interpret=True)
    return [walk(np.asarray(a)) for a in out]


@pytest.mark.parametrize("T", [12, 9])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H", [64, 128])
def test_split_gru_scan_residuals_match_pallas_interpret(H, reverse, T):
    xp, w_hh, b_hh, mask = _inputs(H + 2 * T + reverse, H, T)
    assert scan_tc.has_bf16_remainder(torch.from_numpy(w_hh))
    ref = _jax_fwd(xp, w_hh, b_hh, mask, reverse)
    got = _split_fwd(*(torch.from_numpy(a) for a in (xp, w_hh, b_hh, mask)),
                     reverse)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=0)
    assert np.all(got[0].numpy()[~mask] == 0.0)


@pytest.mark.parametrize("reverse", [False, True])
def test_split_gru_scan_matches_port_plain_version(reverse):
    """The split forward against the port's own plain version (what the
    chip check holds the kernel to, atol 1e-4) at H=128."""
    t = [torch.from_numpy(a) for a in _inputs(7 + reverse, 128, 12)]
    got = _split_fwd(*t, reverse)
    ref = gru_kernel.gru_scan_fwd_plain(*t, reverse)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    # the serving wrapper on CPU tensors: the plain version, no launch
    ys = gru_kernel.gru_scan_fused(*t, reverse)
    torch.testing.assert_close(ys, ref[0], rtol=0, atol=0)
    assert gru_kernel.gru_scan_fused.launches == 0


# ------------------------------------------------------------- the schedule
def _query(table):
    """An occupancy query with the shared library's signature that reports
    ``table[(mode, rows)]`` groups resident at once."""
    def query(H, U, C, kw, kg, rows, mode, out):
        out._obj.value = table.get((mode, rows), 0)
        return 0
    query.__name__ = f"fake_gru_{id(table)}"
    return query


@pytest.fixture
def one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    scan_tc._groups.clear()
    yield
    scan_tc._groups.clear()


C_, G_ = scan_tc.CLUSTER, scan_tc.GRID
# at H=512 on an H100: groups of 16 blocks of 12 warps, at most 7 clusters
# or 8 groups of a cooperative grid resident at once
FWD_H100 = {(C_, 8): 7, (C_, 16): 7, (G_, 8): 8, (G_, 16): 8}


def test_gru_plan_at_the_main_width():
    assert scan_tc.plan(512, 3) == (16, 32, 16, 2)
    assert scan_tc.warps(512, 3) == 12


@pytest.mark.parametrize("B,want", [
    (32, (C_, 8, 4, 4, 1)),        # four 8-row clusters: one launch
    (128, (G_, 16, 8, 8, 1)),      # one grid of 8 groups of 16 rows
])
def test_gru_forward_schedule(one_card, B, want):
    q = _query(FWD_H100)
    assert scan_tc.schedule(q, 512, 3, B) == want[:4]
    assert scan_tc.launches(q, 512, 3, B) == want[4]


def test_cooperative_forward_is_gone():
    """K4 in f32 runs on the tensor-core scan: the unit picker and the
    entry points of the cooperative forward are gone."""
    for name in ("_pick_units", "_FWD", "_NT"):
        assert not hasattr(gru_kernel, name)
    assert "gru_fwd_launch" not in gru_kernel._SIGNATURES
    assert "gru_max_coresident" not in gru_kernel._SIGNATURES
    assert "gru_tc_f32_launch" in gru_kernel._SIGNATURES
    assert hasattr(gru_kernel, "gru_fwd_tc")
