"""The port's encoder (VGG / CNN prenet + (Bi)RNN stack) and CTC head
against the JAX package, on shared weights (moved through the port's weight
bridge) and the same ragged features. Tolerance atol 1e-4: f32 convolutions
and recurrences, sums in another order."""
import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR
from end_to_end_asr_pytorch_tpu_torch.utils.weights import asr_from_arrays
from tests.torch_port_fixtures import ASR_CFG, VOCAB, jax_arrays, to_np

torch.set_num_threads(1)
ATOL = 1e-4


def _cfg(**enc):
    cfg = copy.deepcopy(ASR_CFG)
    cfg["encoder"].update(enc)
    return cfg


CASES = {
    "vgg_bilstm": _cfg(),
    "vgg_ln_proj_concat": _cfg(layer_norm=[True, False], proj=[False, True],
                               sample_rate=[2, 1], sample_style="concat"),
    "cnn_gru_drop": _cfg(prenet="cnn", module="GRU", bidirection=False,
                         sample_rate=[1, 2]),
    "noprenet_lstm_drop": _cfg(prenet="", sample_rate=[2, 2]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_encoder_and_ctc_head_match_jax(name):
    cfg = CASES[name]
    feat_dim = 40
    jm = JaxASR(feat_dim, VOCAB, cfg)
    jp = jm.init(jax.random.PRNGKey(3))
    pm = asr_from_arrays(feat_dim, VOCAB, cfg, jax_arrays(jp), device="cpu")
    rng = np.random.RandomState(3)
    feat = rng.randn(3, 24, feat_dim).astype(np.float32)
    flen = np.asarray([24, 17, 9], np.int32)
    ref_enc, ref_len = jm.encode(jp, jnp.asarray(feat), jnp.asarray(flen))
    got_enc, got_len = pm.encode(torch.from_numpy(feat), torch.from_numpy(flen))
    np.testing.assert_array_equal(to_np(got_len), np.asarray(ref_len))
    assert got_enc.shape == ref_enc.shape
    np.testing.assert_allclose(to_np(got_enc), np.asarray(ref_enc), atol=ATOL,
                               rtol=0)
    ref_ctc = jm.ctc_output(jp, ref_enc)
    got_ctc = pm.ctc_output(torch.from_numpy(np.asarray(ref_enc)))
    np.testing.assert_allclose(to_np(got_ctc), np.asarray(ref_ctc), atol=ATOL,
                               rtol=0)
