"""Shared tiny configurations and helpers for the tests that hold the
PyTorch port (``end_to_end_asr_pytorch_tpu_torch``) against the JAX package.

Inputs come from ``np.random.RandomState`` and reach both packages as numpy
arrays; weights are made by the JAX package's own init and moved into the
port through its weight bridge (``utils/weights.py``)."""
import jax
import numpy as np
import torch

VOCAB = 12
ASR_CFG = {
    "ctc_weight": 0.5,
    "encoder": {"prenet": "vgg", "module": "LSTM", "bidirection": True,
                "dim": [32, 32], "sample_rate": [1, 1],
                "sample_style": "drop"},
    # even loc kernel: XLA SAME padding is asymmetric there
    "attention": {"mode": "loc", "dim": 16, "num_head": 1,
                  "temperature": 0.5, "v_proj": True,
                  "loc_kernel_size": 6, "loc_kernel_num": 3},
    "decoder": {"module": "LSTM", "dim": 32, "layer": 1},
}
LM_CFG = {"module": "LSTM", "dim": 32, "emb_dim": 32, "layer": 1}
AUDIO_CFG = {"feat_type": "fbank", "feat_dim": 40, "cmvn": True}


def jax_arrays(params) -> dict:
    """{keystr path: np.ndarray} for every leaf of a JAX parameter tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def waves(seed: int, lens=(7040, 5600, 3300)):
    """Ragged random waves (B, S) f32 and their lengths, zero past each
    length."""
    rng = np.random.RandomState(seed)
    S = max(lens)
    w = (rng.randn(len(lens), S) * 0.1).astype(np.float32)
    for b, n in enumerate(lens):
        w[b, n:] = 0.0
    return w, np.asarray(lens, np.int32)


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a card tensor: the route code
    picks for the card, taken without one."""

    @property
    def is_cuda(self):
        return True
