"""Write the JAX-written orbax checkpoint that ``chip_smoke.py``'s
``jax_orbax_entry`` phase loads on the card, and the JAX package's outputs
it is held to.

    JAX_PLATFORMS=cpu python tests/make_jax_orbax_fixture.py \
        [--out tests/fixtures/jax_orbax_las] [--seed 0]

The JAX package (on the CPU) initialises ``config/synthetic/las.yaml``'s
model at ``--seed`` (``jax.random.PRNGKey(seed)``, as its solvers do; 40
fbank features, the synthetic corpus's 31 tokens) and saves it with its
own ``save_checkpoint(..., fmt="orbax")``: ``<out>/best_att.pth/``, an
OCDBT directory with zstd-compressed chunks. ``<out>/outputs.json`` holds
three fixed waves (PCM16, made from ``--seed`` with numpy) and the JAX
package's outputs on them: the encoder output and the CTC log-probs (each
row cut at its encoder length) and the beam-4 decode of
``las.yaml``'s ``decode`` block without the LM (every beam's tokens and
score). Arrays are stored as base64 of their little-endian bytes.
"""
import argparse
import base64
import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WAVE_LENS = (17600, 12000, 20800)     # 1.1 s, 0.75 s, 1.3 s at 16 kHz
VOCAB = 31                            # 3 + the synthetic corpus's 28 chars


def fixture_waves(seed: int) -> np.ndarray:
    """(3, S) int16 waves, zero past each length: a few tones under a
    random envelope, and noise."""
    rng = np.random.RandomState(seed)
    S = max(WAVE_LENS)
    out = np.zeros((len(WAVE_LENS), S), np.int16)
    for b, n in enumerate(WAVE_LENS):
        t = np.arange(n) / 16000.0
        w = sum(rng.uniform(0.05, 0.2) * np.sin(2 * np.pi * rng.uniform(
            120, 2400) * t + rng.uniform(0, 2 * np.pi)) for _ in range(3))
        env = np.interp(t, np.linspace(0, t[-1], 8), rng.uniform(0.2, 1, 8))
        w = w * env + 0.02 * rng.randn(n)
        out[b, :n] = np.clip(np.round(w * 32767), -32768, 32767)
    return out


def pack(a) -> dict:
    a = np.ascontiguousarray(a)
    a = a.astype(a.dtype.newbyteorder("<"))
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures" /
                                         "jax_orbax_las"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import yaml
    from end_to_end_asr_pytorch_tpu.decode.beam import BeamDecoder
    from end_to_end_asr_pytorch_tpu.models.asr import ASR
    from end_to_end_asr_pytorch_tpu.ops.audio import create_transform
    from end_to_end_asr_pytorch_tpu.utils.checkpoint import save_checkpoint

    cfg = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    frontend, feat_dim = create_transform(cfg["data"]["audio"])
    model = ASR(feat_dim, VOCAB, cfg["model"])
    params = model.init(jax.random.PRNGKey(args.seed))
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    save_checkpoint(str(out / "best_att.pth"), params, None, 0, {},
                    fmt="orbax")

    pcm = fixture_waves(args.seed)
    wave = pcm.astype(np.float32) / 32768.0
    wave_len = np.asarray(WAVE_LENS, np.int32)
    feat, feat_len = frontend(wave, wave_len)
    enc, enc_len = model.encode(params, feat, feat_len)
    lp = model.ctc_output(params, enc)
    decode_cfg = {**cfg["decode"], "lm_weight": 0.0}
    beam = BeamDecoder(model, decode_cfg).forward(params, feat, feat_len)
    enc, enc_len, lp = np.asarray(enc), np.asarray(enc_len), np.asarray(lp)
    rows = []
    for b in range(len(WAVE_LENS)):
        n = int(enc_len[b])
        lens = np.asarray(beam.lengths[b])
        rows.append({
            "enc": pack(enc[b, :n]), "ctc_log_probs": pack(lp[b, :n]),
            "beam_tokens": [np.asarray(beam.tokens[b, k, :lens[k]]).tolist()
                            for k in range(len(lens))],
            "beam_scores": np.asarray(beam.scores[b], np.float64).tolist()})
    (out / "outputs.json").write_text(json.dumps({
        "config": "config/synthetic/las.yaml", "seed": args.seed,
        "vocab_size": VOCAB, "feat_dim": feat_dim,
        "decode": decode_cfg, "wave_len": list(WAVE_LENS),
        "pcm16": pack(pcm), "enc_len": enc_len.tolist(), "utts": rows},
        indent=1))
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"wrote {out} ({size} bytes)")


if __name__ == "__main__":
    main()
