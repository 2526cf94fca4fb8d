"""The port's audio front end and K1's plain version against the JAX package.

Same waves (numpy, from a seed) through ``AudioFrontend`` of both packages,
and through the JAX ``fbank_fused`` Pallas kernel in interpret mode against
the port's ``fbank_fused`` wrapper on CPU tensors (its plain version).
Tolerance atol 1e-4: f32 sums taken in another order by another BLAS."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu.ops.pallas.fbank_kernel import (
    fbank_fused as jax_fbank_fused)
from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
from end_to_end_asr_pytorch_tpu_torch.ops.cuda import fbank_kernel
from tests.torch_port_fixtures import to_np, waves

torch.set_num_threads(1)
ATOL = 1e-4

CFGS = {
    "fbank_deltas_cmvn": {"feat_type": "fbank", "feat_dim": 40,
                          "delta_order": 2, "cmvn": True},
    "mfcc_delta_cmvn": {"feat_type": "mfcc", "feat_dim": 13,
                        "delta_order": 1, "delta_window_size": 3,
                        "cmvn": True},
    "linear_delta_cmvn": {"feat_type": "linear", "delta_order": 1,
                          "cmvn": True},
    "fbank_nocmvn": {"feat_type": "fbank", "feat_dim": 40, "cmvn": False},
    "fbank_20ms_hop": {"feat_type": "fbank", "feat_dim": 40,
                       "frame_length": 20, "frame_shift": 5, "cmvn": True},
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_frontend_matches_jax(name):
    cfg = CFGS[name]
    w, wl = waves(seed=1)
    ref_f, ref_l = JaxFrontend(cfg)(jnp.asarray(w), jnp.asarray(wl))
    fe = AudioFrontend(cfg, device="cpu")
    got_f, got_l = fe(torch.from_numpy(w), torch.from_numpy(wl))
    assert fe.feat_dim == ref_f.shape[-1]
    np.testing.assert_array_equal(to_np(got_l), np.asarray(ref_l))
    np.testing.assert_allclose(to_np(got_f), np.asarray(ref_f), atol=ATOL,
                               rtol=0)


def test_int16_and_short_clip_match_jax():
    """PCM16 input is dequantized exactly; clips shorter than half a window
    are zero-extended instead of failing the reflect pad."""
    rng = np.random.RandomState(4)
    pcm = rng.randint(-32768, 32767, size=(2, 3000)).astype(np.int16)
    wl = np.asarray([3000, 2100], np.int32)
    short = (rng.randn(2, 150) * 0.1).astype(np.float32)
    swl = np.asarray([150, 90], np.int32)
    for x, lens in ((pcm, wl), (short, swl)):
        ref_f, ref_l = JaxFrontend(CFGS["fbank_deltas_cmvn"])(
            jnp.asarray(x), jnp.asarray(lens))
        got_f, got_l = AudioFrontend(CFGS["fbank_deltas_cmvn"], device="cpu")(
            torch.from_numpy(x), torch.from_numpy(lens))
        np.testing.assert_array_equal(to_np(got_l), np.asarray(ref_l))
        np.testing.assert_allclose(to_np(got_f), np.asarray(ref_f),
                                   atol=ATOL, rtol=0)


def test_fbank_wrapper_matches_pallas_interpret():
    """K1's wrapper on CPU tensors (its plain version) against the TPU
    kernel run in interpret mode, on full-length random audio."""
    rng = np.random.RandomState(7)
    w = (rng.randn(3, 4960) * 0.1).astype(np.float32)
    fe = AudioFrontend({"feat_type": "fbank", "feat_dim": 40}, device="cpu")
    args = [fe.cosw, fe.msinw, fe.mel_fb]
    ref = jax_fbank_fused(jnp.asarray(w), *[jnp.asarray(to_np(a)) for a in args],
                          n_fft=400, hop=160, log_eps=1e-10, interpret=True)
    got = fbank_kernel.fbank_fused(torch.from_numpy(w), *args, n_fft=400,
                                   hop=160, log_eps=1e-10)
    assert got.shape == ref.shape == (3, 4960 // 160 + 1, 40)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL, rtol=0)
