"""The arithmetic of K7's Hopper design on the CPU: the frames of each
utterance whose alignment can be non-zero cut into C slices (one block of
a cluster each), the per-slice sums of the training attention step's
forward and backward, then their combine in rank order; and how many
blocks a launch takes.

The kernels run only on the card; ``att_train_kernel.loc_att_fwd_split``
and ``loc_att_bwd_split`` spell out what they compute (per row, nw frames
below the length, all T for a zero-length row, in C slices of ceil(nw /
C); the forward: per-slice energies and maxima, the cluster max M, s_r =
sum exp(e - M) summed in rank order, the context from the final align;
the backward: per-slice dal . align summed in rank order, the dq and dv
partials of each slice summed in rank order, dv over the rows in order).
They are held here to the plain versions ``loc_att_fwd_plain`` /
``loc_att_bwd_plain`` and to the JAX package's TPU kernel in interpret
mode (``loc_att_train(..., interpret=True)`` under ``jax.vjp``) with 1, 2,
3 and 8 slices of T=37 frames (which none of 2, 3 and 8 divides), on rows
of length 37, 20 and 12 (cut unevenly), 1 (every slice but the first
empty) and 0 (uniform 1 / T):
  * f32: rtol 1e-5 / atol 1e-6, the kernel-level tolerance of the
    attention tests (sums taken in another order);
  * bf16 q, keys, f, v and vals (amp training): ctx and align within atol
    1e-6, the five gradients within 1 bf16 ulp of the larger magnitude
    plus 1e-5, the bounds of ``tests/test_torch_port_att_train_amp.py``.
``clusters`` bounds the cluster size and ``pick_clusters`` picks it from
an occupancy table of the H100's shape.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.ops.pallas.att_train_kernel import (
    loc_att_train as jax_k7)
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import att_train_kernel as tk

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
D, VD, T = 8, 6, 37
# full; cut unevenly by 2, 3 and 8 slices; one frame; zero-length
LENS = np.asarray([T, 20, 12, 1, 0], np.int32)
BF = torch.bfloat16


def _inputs(seed, lens=LENS, bf16=False):
    """q, keys, f, v, vals (bf16 values held in f32 arrays where
    ``bf16``), the lengths, and the f32 cotangents dctx and dalign."""
    rng = np.random.RandomState(seed)
    r = lambda *s, sc=0.7: (rng.randn(*s) * sc).astype(np.float32)
    B = len(lens)
    arrays = (r(B, D), r(B, T, D), r(B, T, D), r(D), r(B, T, VD))
    if bf16:
        arrays = tuple(torch.from_numpy(a).to(BF).float().numpy()
                       for a in arrays)
    return arrays, lens, r(B, VD, sc=1.0), r(B, T, sc=1.0)


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrays]


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _jax(arrays, lens, dctx, dalign, tau, bf16=False):
    """The TPU kernel in interpret mode: (ctx, align) and the gradients
    (dq, dkeys, df, dv, dvals) under jax.vjp."""
    xs = [jnp.asarray(a) for a in arrays]
    if bf16:
        xs = [x.astype(jnp.bfloat16) for x in xs]
    out, vjp = jax.vjp(
        lambda *a: jax_k7(*a, jnp.asarray(lens), tau, True), *xs)
    return out, vjp((jnp.asarray(dctx), jnp.asarray(dalign)))


def assert_within_ulp(got, ref):
    """|got - ref| <= 2^-7 max(|got|, |ref|) + 1e-5 (1 bf16 ulp)."""
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    d = np.abs(g - r)
    bad = d > np.maximum(np.abs(g), np.abs(r)) * 2.0 ** -7 + 1e-5
    assert not bad.any(), (d[bad].max(), int(bad.sum()))


@pytest.mark.parametrize("tau", [0.5, 1.3])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_forward_split_matches_plain_and_pallas_interpret(C, tau):
    arrays, lens, dctx, dalign = _inputs(C + int(10 * tau))
    ctx, al = tk.loc_att_fwd_split(*_t(arrays), torch.from_numpy(lens), tau,
                                   C)
    pctx, pal = tk.loc_att_fwd_plain(*_t(arrays), torch.from_numpy(lens),
                                     tau)
    (rctx, ral), _ = _jax(arrays, lens, dctx, dalign, tau)
    for got, ref in ((ctx, pctx), (al, pal)):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(rctx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(al.numpy(), np.asarray(ral), rtol=RTOL,
                               atol=ATOL)
    # frames past each row's length get exactly 0; the zero-length row is
    # uniform over all T frames
    for b, n in enumerate(lens):
        if n > 0:
            assert np.all(al.numpy()[b, n:] == 0.0)
    np.testing.assert_allclose(al.numpy()[-1], np.full(T, 1.0 / T),
                               rtol=1e-6)


@pytest.mark.parametrize("tau", [0.5, 1.3])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_backward_split_matches_plain_and_pallas_vjp(C, tau):
    arrays, lens, dctx, dalign = _inputs(20 + C + int(10 * tau))
    el = torch.from_numpy(lens)
    _, al = tk.loc_att_fwd_plain(*_t(arrays), el, tau)
    got = tk.loc_att_bwd_split(*_t(arrays), el, al, *_t((dctx, dalign)),
                               tau, C)
    ref = tk.loc_att_bwd_plain(*_t(arrays), el, al, *_t((dctx, dalign)),
                               tau)
    for name, g, r in zip(("dq", "dtarg", "dvals", "dv"), got, ref):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL, msg=name)
    _, (jq, jk, jf, jv, jvals) = _jax(arrays, lens, dctx, dalign, tau)
    dq, dtarg, dvals, dv = (x.numpy() for x in got)
    for name, g, r in (("dq", dq, jq), ("dkeys", dtarg, jk),
                       ("df", dtarg, jf), ("dv", dv, jv),
                       ("dvals", dvals, jvals)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # the frames past each row's length get zero dtarg and dvals
    for b, n in enumerate(lens):
        if n > 0:
            assert np.all(dtarg[b, n:] == 0.0) and np.all(dvals[b, n:] == 0.0)


@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_bf16_split_matches_plain_and_pallas_interpret(C):
    """bf16 inputs: the split forward and backward against the plain
    versions on the same bf16 inputs and the TPU kernel on them: ctx and
    align f32 within atol 1e-6, the gradients bf16, each within 1 bf16 ulp
    + 1e-5."""
    arrays, lens, dctx, dalign = _inputs(40 + C, bf16=True)
    el, tau = torch.from_numpy(lens), 0.7
    xs = _t(arrays, BF)
    ctx, al = tk.loc_att_fwd_split(*xs, el, tau, C)
    pctx, pal = tk.loc_att_fwd_plain(*xs, el, tau)
    (rctx, ral), jgrads = _jax(arrays, lens, dctx, dalign, tau, bf16=True)
    assert ctx.dtype == al.dtype == torch.float32
    for got, ref in ((ctx, pctx), (al, pal), (ctx, rctx), (al, ral)):
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=0, atol=1e-6)
    grads = tk.loc_att_bwd_split(*xs, el, pal, *_t((dctx, dalign)), tau, C)
    pgrads = tk.loc_att_bwd_plain(*xs, el, pal, *_t((dctx, dalign)), tau)
    assert all(g.dtype == BF for g in grads)
    for g, r in zip(grads, pgrads):
        assert_within_ulp(g, r)
    dq, dtarg, dvals, dv = grads
    for g, r in zip((dq, dtarg, dtarg, dv, dvals), jgrads):
        assert r.dtype == jnp.bfloat16
        assert_within_ulp(g, r)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("C", [2, 3, 8])
def test_slices_past_the_length_contribute_nothing(C, bf16):
    """Rows of length 1 leave every slice but the first without a frame:
    their partials change nothing. The alignment is one-hot, the context
    the first frame's values, and the backward equals the one-slice
    split's."""
    dtype = BF if bf16 else torch.float32
    arrays, lens, dctx, dalign = _inputs(60 + C, np.asarray([1, 1], np.int32),
                                         bf16)
    xs, el = _t(arrays, dtype), torch.from_numpy(lens)
    ctx, al = tk.loc_att_fwd_split(*xs, el, 0.5, C)
    rctx, ral = tk.loc_att_fwd_split(*xs, el, 0.5, 1)
    torch.testing.assert_close(al, ral, rtol=0, atol=0)
    assert np.all(al.numpy()[:, 0] == 1.0)
    torch.testing.assert_close(ctx, rctx, rtol=0, atol=0)
    torch.testing.assert_close(ctx, xs[4][:, 0].float(), rtol=0, atol=0)
    cot = _t((dctx, dalign))
    got = tk.loc_att_bwd_split(*xs, el, al, *cot, 0.5, C)
    ref = tk.loc_att_bwd_split(*xs, el, al, *cot, 0.5, 1)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("T_,want", [(1, 1), (16, 1), (17, 2), (37, 3),
                                     (100, 7), (176, 11), (256, 16),
                                     (900, 16)])
def test_clusters_leave_no_slice_empty(T_, want):
    C = tk.clusters(T_)
    assert C == want
    ts = -(-T_ // C)
    assert 1 <= C <= tk.MAX_CLUSTER and (C - 1) * ts < T_


H100_SMS = 132
# clusters of C blocks resident at once at T=176, d=vdim=300, as the
# occupancy query answers on an H100 (chip_smoke.py's k7 lines): the
# forward fits two blocks of 256 threads an SM, the backward three, and
# clusters are placed within the card's GPCs
H100_CLUSTERS = {
    "fwd": [264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14],
    "bwd": [396, 198, 124, 92, 69, 62, 47, 45, 37, 30, 28, 28, 23, 21, 21, 21]}


@pytest.fixture
def h100():
    def query(kind, T, d, vdim, C, out):
        row = H100_CLUSTERS["bwd" if kind & tk.BWD else "fwd"]
        out._obj.value = row[C - 1]
        return 0
    query.__name__ = "fake_h100_clusters"
    tk._resident.clear()
    tk._picked.clear()
    yield query
    tk._resident.clear()
    tk._picked.clear()


@pytest.mark.parametrize("B,T_,fwd,bwd", [
    (32, 176, 6, 6),     # 192 blocks: nearest 1.5 an SM, one wave
    (128, 176, 2, 2),    # 256 blocks in one wave (384 would take two)
    (4, 900, 16, 16),    # a long utterance: the largest cluster
    (1, 37, 3, 3),       # one short row: every slice of clusters(T)
    (600, 176, 1, 1),    # fewest waves first: 2 of 1 block, 4 of 2
])
def test_pick_clusters_fills_the_card_in_the_fewest_waves(h100, B, T_, fwd,
                                                          bwd):
    for kind, want in ((0, fwd), (tk.BWD, bwd), (tk.BF16_IN, fwd),
                       (tk.BWD | tk.BF16_IN, bwd)):
        assert tk.pick_clusters(h100, kind, B, T_, 300, 300, H100_SMS) == want


def test_pick_clusters_skips_sizes_that_do_not_fit(h100, monkeypatch):
    row = [0] * 4 + H100_CLUSTERS["fwd"][4:]
    monkeypatch.setitem(H100_CLUSTERS, "fwd", [0] * 16)
    with pytest.raises(ValueError):
        tk.pick_clusters(h100, 0, 32, 176, 300, 300, H100_SMS)
    tk._resident.clear()
    tk._picked.clear()
    monkeypatch.setitem(H100_CLUSTERS, "fwd", row)
    assert tk.pick_clusters(h100, 0, 600, 176, 300, 300, H100_SMS) == 5


def test_kernel_variant_follows_widths_and_alignment():
    """The 4-element kernel where d and vdim are multiples of 4 and every
    row tensor starts on 4 elements, else the scalar one."""
    x = torch.zeros(64)
    assert tk._kind(False, torch.float32, 300, 300, x[:8]) == 0
    assert tk._kind(True, BF, 300, 300, x.to(BF)[:8]) == tk.BWD | tk.BF16_IN
    assert tk._kind(False, torch.float32, 38, 300, x) == tk.SCALAR
    assert tk._kind(False, torch.float32, 300, 70, x) == tk.SCALAR
    assert tk._kind(False, torch.float32, 300, 300, x[1:9]) == tk.SCALAR
    assert tk._kind(True, BF, 300, 300, x.to(BF)[2:10]) == (
        tk.BWD | tk.BF16_IN | tk.SCALAR)
