"""The arithmetic of K5's Hopper design on the CPU: the frames of each
utterance whose alignment can be non-zero cut into C slices (one block of
a cluster each), each slice's softmax partials, then their combine; and
how many slices a launch takes.

The kernel runs only on the card; ``att_kernel.loc_attention_split``
spells out what it computes (per row, nw frames below the length, all T
for a zero-length row, in C slices of ceil(nw / C); per slice the
energies, the max m_r, s_r = sum exp(e - m_r) and the partial context;
then M = max m_r, S = sum s_r exp(m_r - M), ctx = sum exp(m_r - M) ctx_r
/ S, align = exp(e - M) / S). It is held here to the plain version
``loc_attention_plain`` and to the JAX package's TPU kernel in interpret
mode with 1, 2, 3 and 8 slices of T=37 frames (which none of 2, 3 and 8
divides), on rows of length 37, 20 and 12 (cut unevenly), 1 (every slice
but the first empty) and 0 (uniform 1 / T): rtol 1e-5 / atol 1e-6, the
kernel-level tolerance of the attention tests (f32, sums taken in another
order). ``slices`` bounds the cluster size and ``pick_slices`` picks it
from an occupancy table of the H100's shape.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.ops.pallas.att_kernel import (
    loc_attention_fused as jax_k5)
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import att_kernel

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
K, D, F, VD, T = 3, 8, 3, 6, 37
# full; cut unevenly by 2, 3 and 8 slices; one frame; zero-length
LENS = np.asarray([T, 20, 12, 1, 0], np.int32)


def _inputs(seed, lens=LENS):
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.7).astype(np.float32)
    B = len(lens)
    return (r(B, K, D), r(B, T, D), r(B, K, T, F), r(F, D), r(D),
            r(B, T, VD), lens)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("tau", [0.5, 1.3])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_split_softmax_matches_plain_and_pallas_interpret(C, tau):
    args = _inputs(C + int(10 * tau))
    ctx, al = att_kernel.loc_attention_split(*_t(args), tau, C)
    pctx, pal = att_kernel.loc_attention_plain(*_t(args), tau)
    rctx, ral = jax_k5(*(jnp.asarray(a) for a in args), temperature=tau,
                       interpret=True)
    for got, ref in ((ctx, pctx), (al, pal)):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(rctx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(al.numpy(), np.asarray(ral), rtol=RTOL,
                               atol=ATOL)
    # frames past each row's length get exactly 0; the zero-length row is
    # uniform over all T frames
    for b, n in enumerate(LENS):
        if n > 0:
            assert np.all(al.numpy()[b, :, n:] == 0.0)
    np.testing.assert_allclose(al.numpy()[-1], np.full((K, T), 1.0 / T),
                               rtol=1e-6)


@pytest.mark.parametrize("C", [2, 3, 8])
def test_slices_past_the_length_contribute_nothing(C):
    """A row of length 1 leaves every slice but the first without a frame:
    their partials (m = -FLT_MAX, s = 0, zero context) change nothing, and
    the row's alignment is one-hot."""
    args = _inputs(40 + C, np.asarray([1, 1], np.int32))
    ctx, al = att_kernel.loc_attention_split(*_t(args), 0.5, C)
    ref = att_kernel.loc_attention_split(*_t(args), 0.5, 1)
    torch.testing.assert_close(ctx, ref[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(al, ref[1], rtol=0, atol=0)
    assert np.all(al.numpy()[:, :, 0] == 1.0)
    torch.testing.assert_close(ctx, torch.from_numpy(args[5][:, :1]).expand(
        2, K, VD), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T_,want", [(1, 1), (16, 1), (17, 2), (37, 3),
                                     (100, 7), (176, 8), (700, 8)])
def test_slices_leave_no_slice_empty(T_, want):
    C = att_kernel.slices(T_)
    assert C == want
    ts = -(-T_ // C)
    assert 1 <= C <= att_kernel.MAX_SLICES and (C - 1) * ts < T_


# clusters of C blocks resident at once at the main shape, of an H100's
# shape: two blocks per SM, and clusters of 7 or 8 as the card's GPCs
# place them (30 of 8, 32 of 7)
H100_CLUSTERS = {8: 30, 7: 32, 6: 39, 5: 47, 4: 62, 3: 88, 2: 132, 1: 264}


@pytest.fixture
def h100(monkeypatch):
    def query(K, T, d, F, vdim, C, out):
        out._obj.value = H100_CLUSTERS[C]
        return 0
    query.__name__ = "fake_h100_clusters"
    att_kernel._resident.clear()
    att_kernel._picked.clear()
    yield query
    att_kernel._resident.clear()
    att_kernel._picked.clear()


@pytest.mark.parametrize("B,want", [
    (1, 8), (30, 8),    # every cluster of 8 resident: the most blocks
    (32, 7),            # 32 clusters of 7 in one wave beat two of 8
    (33, 6),
    (128, 2),           # one wave of 2 (88 frames) against 5 of 8 (22)
])
def test_pick_slices_minimises_waves_times_frames(h100, B, want):
    assert att_kernel.pick_slices(h100, B, 8, 176, 300, 10, 300) == want


def test_pick_slices_skips_sizes_that_do_not_fit(h100, monkeypatch):
    monkeypatch.setitem(H100_CLUSTERS, 8, 0)
    monkeypatch.setitem(H100_CLUSTERS, 7, 0)
    assert att_kernel.pick_slices(h100, 1, 8, 176, 300, 10, 300) == 6
    att_kernel._resident.clear()
    att_kernel._picked.clear()
    for C in H100_CLUSTERS:
        monkeypatch.setitem(H100_CLUSTERS, C, 0)
    with pytest.raises(ValueError):
        att_kernel.pick_slices(h100, 1, 8, 176, 300, 10, 300)
