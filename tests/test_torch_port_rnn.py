"""The port's recurrent cores and K2's plain version against the JAX package.

``lstm_scan`` forward and reverse over ragged masks against
``ops/rnn.lstm_scan`` (its lax.scan path) and against the TPU kernel
``lstm_scan_fused`` in Pallas interpret mode; the GRU scan and the cells
against theirs. Tolerance atol 1e-5: f32 recurrences, sums in another order."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from end_to_end_asr_pytorch_tpu.ops import rnn as jrnn
from end_to_end_asr_pytorch_tpu.ops.pallas.lstm_kernel import (
    lstm_scan_fused as jax_lstm_scan_fused)
from end_to_end_asr_pytorch_tpu_torch.ops import rnn
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel
from tests.torch_port_fixtures import to_np

torch.set_num_threads(1)
ATOL = 1e-5
T, B, D, H = 12, 3, 20, 32
LENS = np.asarray([12, 9, 4])


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, D).astype(np.float32)
    mask = np.arange(T)[:, None] < LENS[None, :]
    return x, mask


def _port_cell(kind, jw):
    w = rnn.cell_weights(kind, D, H, device="cpu")
    with torch.no_grad():
        for name, t in w.state_dict().items():
            t.copy_(torch.from_numpy(np.array(getattr(jw, name))))
    return w


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lstm_scan_matches_jax(seed, reverse):
    x, mask = _inputs(seed)
    jw = jrnn.init_lstm(jax.random.PRNGKey(seed), D, H)
    ref = jrnn.lstm_scan(jw, jnp.asarray(x), jnp.asarray(mask), reverse=reverse)
    got = rnn.lstm_scan(_port_cell("lstm", jw), torch.from_numpy(x),
                        torch.from_numpy(mask), reverse=reverse)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL, rtol=0)
    # padded steps emit exactly zero
    assert np.all(to_np(got)[~mask] == 0.0)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_wrapper_matches_pallas_interpret(reverse):
    """K2's wrapper on CPU tensors (its plain version) against the TPU
    kernel in interpret mode, on the same x_proj, W_hh and ragged mask."""
    rng = np.random.RandomState(3)
    xp = (rng.randn(T, B, 4 * H) * 0.5).astype(np.float32)
    w_hh = (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
    mask = np.arange(T)[:, None] < LENS[None, :]
    ref = jax_lstm_scan_fused(jnp.asarray(xp), jnp.asarray(w_hh),
                              jnp.asarray(mask), reverse, True)
    got = lstm_kernel.lstm_scan_fused(torch.from_numpy(xp),
                                      torch.from_numpy(w_hh),
                                      torch.from_numpy(mask), reverse)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_matches_jax(reverse):
    x, mask = _inputs(5)
    jw = jrnn.init_gru(jax.random.PRNGKey(5), D, H)
    jw = jw._replace(b_ih=jw.b_ih + 0.1, b_hh=jw.b_hh - 0.2)
    ref = jrnn.gru_scan(jw, jnp.asarray(x), jnp.asarray(mask), reverse=reverse)
    got = rnn.gru_scan(_port_cell("gru", jw), torch.from_numpy(x),
                       torch.from_numpy(mask), reverse=reverse)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL, rtol=0)


def test_cells_and_bidirectional_match_jax():
    x, mask = _inputs(8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    jf, jb = jrnn.init_lstm(k1, D, H), jrnn.init_lstm(k2, D, H)
    ref = jrnn.bidirectional(jrnn.lstm_scan, jf, jb, jnp.asarray(x),
                             jnp.asarray(mask))
    pf, pb = _port_cell("lstm", jf), _port_cell("lstm", jb)
    got = rnn.bidirectional(rnn.lstm_scan, pf, pb, torch.from_numpy(x),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL, rtol=0)
    # one cell step with a non-zero carry
    rng = np.random.RandomState(9)
    h, c = rng.randn(B, H).astype(np.float32), rng.randn(B, H).astype(np.float32)
    xp = rng.randn(B, 4 * H).astype(np.float32)
    rh, rc = jrnn.lstm_cell(jf, jnp.asarray(h), jnp.asarray(c), jnp.asarray(xp))
    gh, gc = rnn.lstm_cell(pf, torch.from_numpy(h), torch.from_numpy(c),
                           torch.from_numpy(xp))
    np.testing.assert_allclose(to_np(gh), np.asarray(rh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to_np(gc), np.asarray(rc), atol=ATOL, rtol=0)


def test_lstm_scan_with_initial_state_matches_jax():
    x, mask = _inputs(11)
    jw = jrnn.init_lstm(jax.random.PRNGKey(11), D, H)
    rng = np.random.RandomState(11)
    h0, c0 = rng.randn(B, H).astype(np.float32), rng.randn(B, H).astype(np.float32)
    ref = jrnn.lstm_scan(jw, jnp.asarray(x), jnp.asarray(mask),
                         h0=jnp.asarray(h0), c0=jnp.asarray(c0))
    got = rnn.lstm_scan(_port_cell("lstm", jw), torch.from_numpy(x),
                        torch.from_numpy(mask), h0=torch.from_numpy(h0),
                        c0=torch.from_numpy(c0))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL, rtol=0)
