"""Write the JAX-written LM checkpoint, optimizer state included, that
``chip_smoke.py``'s ``jax_resume_entry`` phase resumes on the card, and the
JAX package's next steps it is held to.

    JAX_PLATFORMS=cpu python tests/make_jax_resume_fixture.py \
        [--out tests/fixtures/jax_orbax_lm_resume] [--seed 0]

The JAX package (on the CPU) initialises ``config/synthetic/lm.yaml``'s
RNN-LM at its own widths (emb 64, one LSTM layer of 64, the synthetic
corpus's 31 tokens) at ``--seed`` with dropout 0 (the two packages draw
dropout from other streams), and trains it with its own optimizer
(``lm.yaml``'s Adam, lr 1e-3, fixed schedule) and its LM solver's loss
(``_nll``: mean next-token NLL) for ``STEPS`` steps on fixed batches made
from ``--seed`` with numpy. It saves that state with its own
``save_checkpoint(..., fmt="orbax")``: ``<out>/latest.pth/``, ``model/``
and ``optimizer/`` OCDBT directories with zstd-compressed chunks and
``meta.json`` at step ``STEPS``. It then takes ``STEPS`` more steps on the
next batches and writes ``<out>/outputs.json``: those batches (base64 of
their little-endian bytes), each step's loss, raw gradient norm and Adam
count, and each parameter leaf's L2 norm after the last step.
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

VOCAB = 31          # 3 + the synthetic corpus's 28 characters
STEPS = 3           # before the checkpoint, and after it
BATCH = 32          # lm.yaml's batch_size
LENS = (16, 96)     # sentence lengths, <eos> included


def fixture_batches(seed: int, n: int = 2 * STEPS):
    """``n`` batches of BATCH sentences: tokens in [3, VOCAB) ending in
    <eos> (1), ragged, zero-padded to the longest (the first row)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rng.randint(LENS[0], LENS[1] + 1, size=BATCH)
        lens[0] = LENS[1]
        text = rng.randint(3, VOCAB, size=(BATCH, LENS[1])).astype(np.int32)
        text[np.arange(LENS[1])[None, :] >= lens[:, None]] = 0
        text[np.arange(BATCH), lens - 1] = 1
        out.append((text, lens.astype(np.int32)))
    return out


def pack(a) -> dict:
    a = np.ascontiguousarray(a)
    a = a.astype(a.dtype.newbyteorder("<"))
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode()}


def lm_config():
    import yaml
    cfg = yaml.safe_load((ROOT / "config/synthetic/lm.yaml").read_text())
    cfg["model"]["dropout"] = 0.0
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures" /
                                         "jax_orbax_lm_resume"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    from types import SimpleNamespace
    from end_to_end_asr_pytorch_tpu.models.lm import RNNLM
    from end_to_end_asr_pytorch_tpu.optim import Optimizer
    from end_to_end_asr_pytorch_tpu.solvers.train_lm import Solver
    from end_to_end_asr_pytorch_tpu.utils.checkpoint import save_checkpoint

    cfg = lm_config()
    lm = RNNLM(VOCAB, cfg["model"])
    params = lm.init(jax.random.PRNGKey(args.seed))
    opt = Optimizer(cfg["hparas"], grad_clip=5.0)
    state = opt.init(params)
    solver = SimpleNamespace(lm=lm)

    def loss_fn(p, text, text_len):
        total, count = Solver._nll(solver, p, text, text_len, True,
                                   jax.random.PRNGKey(0))
        return total / jnp.maximum(count, 1.0)

    @jax.jit
    def step(p, s, text, text_len):
        loss, grads = jax.value_and_grad(loss_fn)(p, text, text_len)
        updates, s = opt.tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, \
            optax.global_norm(grads)

    batches = fixture_batches(args.seed)
    for text, lens in batches[:STEPS]:
        params, state, _, _ = step(params, state, text, lens)
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    save_checkpoint(str(out / "latest.pth"), params, state, STEPS, {},
                    fmt="orbax")
    steps = []
    for text, lens in batches[STEPS:]:
        params, state, loss, gnorm = step(params, state, text, lens)
        steps.append({"loss": float(loss), "grad_norm": float(gnorm),
                      "count": int(state.inner_state[1][0].count)})
    norms = {jax.tree_util.keystr(p, simple=True, separator="."):
             float(np.linalg.norm(np.asarray(v, np.float64)))
             for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    (out / "outputs.json").write_text(json.dumps({
        "config": "config/synthetic/lm.yaml", "seed": args.seed,
        "vocab_size": VOCAB, "model": cfg["model"],
        "hparas": cfg["hparas"], "saved_at": STEPS,
        "batches": [{"text": pack(t), "text_len": pack(n)}
                    for t, n in batches[STEPS:]],
        "steps": steps, "leaf_norms": norms}, indent=1))
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"wrote {out} ({size} bytes)")


if __name__ == "__main__":
    main()
