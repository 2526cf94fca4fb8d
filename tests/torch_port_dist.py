"""Process groups for the port's data-parallel tests, on the CPU.

``run_world`` starts ``world`` processes with ``torch.multiprocessing``,
each joining a gloo group through a ``file://`` store under the test's
temporary directory (so parallel test workers never share a port), and
returns what each rank's function returned, in rank order. Every child
runs on one thread; the group has a 60 s timeout and the whole run a
join limit, so a deadlock fails the test instead of hanging it. This
module imports neither JAX nor the JAX package, so the children start
quickly.
"""
import copy
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parent.parent
GROUP_TIMEOUT_S = 60.0


def _child(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    try:
        mesh.init(torch.device("cpu"), backend="gloo",
                  init_method=f"file://{tmp}/store", rank=rank, world=world,
                  timeout=GROUP_TIMEOUT_S)
        out = fn(rank, world, *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    except BaseException:
        Path(f"{tmp}/rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        mesh.shutdown()


def run_world(fn, world, tmp, *args, timeout=120.0):
    """``fn(rank, world, *args)`` in ``world`` processes of one gloo group;
    their results in rank order. Fails on a rank that raised, or on a run
    that outlasts ``timeout`` seconds (its processes are killed)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.spawn(_child, args=(fn, world, str(tmp), args), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"world {world} still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ----------------------------------------------------- what the ranks run
def make_solver(cfg, hparas, workdir, seed=0, vocab=12, feat_dim=40,
                model_parallel=1, load=None, ckpt_format="native"):
    """The port's ASR training solver on ``cfg``'s model, set up as
    ``main`` sets it up but without a corpus (``load``: a checkpoint to
    start from, cut to the rank's parts at ``model_parallel`` > 1;
    ``ckpt_format``: how ``save`` writes)."""
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_asr import Solver
    config = {"data": {"corpus": {"name": "none"},
                       "audio": copy.deepcopy(cfg["audio"]),
                       "text": {"mode": "character"}},
              "model": copy.deepcopy(cfg["model"]), "hparas": dict(hparas),
              "model_parallel": model_parallel, "ckpt_format": ckpt_format}
    paras = SimpleNamespace(config="dist.yaml", name=None, seed=seed,
                            logdir=f"{workdir}/log", ckpdir=f"{workdir}/ckpt",
                            load=load, njobs=0, no_msg=True, cpu=True)
    solver = Solver(config, paras)
    solver.feat_dim, solver.vocab_size = feat_dim, vocab
    solver.set_model()
    return solver


def rank_batch(batch, rank, world, model_parallel=1):
    """Rank ``rank``'s rows of a global numpy batch padded to a multiple of
    ``world`` (as the loaders cut it: by data index over the data ranks),
    as tensors, and its ``rows``."""
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    n = len(batch["text_len"])
    padded = mesh.pad_batch_to(batch, world)
    lo, hi = mesh.row_range(len(padded["text_len"]), rank // model_parallel,
                            world // model_parallel)
    t = [torch.from_numpy(np.ascontiguousarray(padded[k][lo:hi]))
         for k in ("wave", "wave_len", "text", "text_len")]
    t[2], t[3] = t[2].long(), t[3].long()
    return t, ((lo, hi, n) if world > 1 else None)


def asr_steps(rank, world, cfg, hparas, batches, workdir, state=None):
    """Train steps of ``make_solver(cfg, hparas)`` on this rank's rows of
    each global batch (``state``: a port state dict to start from): the
    losses and the parameters after the last."""
    solver = make_solver(cfg, hparas, workdir, vocab=cfg["vocab"])
    if state is not None:
        solver.model.load_state_dict(state)
    losses = []
    for b in batches:
        t, rows = rank_batch(b, rank, world)
        m = solver.train_step(*t, rows=rows)
        losses.append({k: float(v) for k, v in m.items()})
    return {"losses": losses,
            "params": {n: p.detach().clone() for n, p in solver.params.items()}}


def lm_steps(rank, world, model_cfg, hparas, batches, workdir, state=None):
    """Train steps of the port's LM solver on this rank's rows of each
    global text batch: losses and parameters after the last."""
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import Solver
    config = {"data": {"corpus": {"name": "none"},
                       "text": {"mode": "character"}},
              "model": copy.deepcopy(model_cfg), "hparas": dict(hparas)}
    paras = SimpleNamespace(config="lm.yaml", name=None, seed=0,
                            logdir=f"{workdir}/log", ckpdir=f"{workdir}/ckpt",
                            load=None, njobs=0, no_msg=True, cpu=True)
    solver = Solver(config, paras)
    solver.vocab_size = model_cfg["vocab"]
    solver.set_model()
    if state is not None:
        solver.lm.load_state_dict(state)
    losses = []
    for b in batches:
        n = len(b["text_len"])
        padded = mesh.pad_batch_to(b, world)
        lo, hi = mesh.row_range(len(padded["text_len"]), rank, world)
        m = solver.train_step(
            torch.from_numpy(padded["text"][lo:hi]).long(),
            torch.from_numpy(padded["text_len"][lo:hi]).long(),
            rows=(lo, hi, n) if world > 1 else None)
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "params": {n: p.detach().clone() for n, p in solver.params.items()}}


def tp_state(solver):
    """What a tensor-parallel rank holds after its steps: its parameter
    parts and optimizer slot parts, and both whole (``tp.whole``, the
    checkpoint writer's view), on the CPU."""
    from end_to_end_asr_pytorch_tpu_torch.parallel import tp
    cpu = lambda d: {n: v.detach().cpu().clone() for n, v in d.items()}
    slots = lambda o: {f"{n}.{s}": v for n, d in o.slots.items()
                       for s, v in d.items()}
    out = {"params": cpu(solver.params), "slots": cpu(slots(solver.optimizer)),
           "split": dict(solver.split),
           "count": int(solver.optimizer.count)}
    with tp.whole(solver.params, solver.split, solver.optimizer):
        out["whole"] = cpu(solver.params)
        out["whole_slots"] = cpu(slots(solver.optimizer))
    return out


def tp_asr_steps(rank, world, m, cfg, hparas, batches, workdir, load=None,
                 save=None, ckpt_format="native"):
    """Train steps of ``make_solver(cfg, hparas)`` at ``model_parallel: m``
    from the checkpoint ``load`` on this rank's rows of each global batch:
    the step metrics and ``tp_state``; ``save``: a checkpoint name the
    solver then writes (rank 0) under ``workdir`` in ``ckpt_format``."""
    solver = make_solver(cfg, hparas, workdir, vocab=cfg["vocab"],
                         model_parallel=m, load=load, ckpt_format=ckpt_format)
    losses = []
    for b in batches:
        t, rows = rank_batch(b, rank, world, m)
        metrics = solver.train_step(*t, rows=rows)
        losses.append({k: float(v) for k, v in metrics.items()})
    if save is not None:
        solver.save(save, solver.model, optimizer=solver.optimizer,
                    global_step=len(batches))
    return {"losses": losses, **tp_state(solver)}


def tp_drift(rank, world, m, cfg, hparas, batches, workdir, load=None):
    """``tp_asr_steps`` with each rank's gradient of every replicated leaf
    moved by a rank-dependent amount as its backward accumulates it (as a
    backward whose sums run in another order on each rank would): the
    step metrics, ``tp_state``, and the collectives one
    ``all_reduce_grads`` makes."""
    import torch.distributed as dist
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    solver = make_solver(cfg, hparas, workdir, vocab=cfg["vocab"],
                         model_parallel=m, load=load)
    def move(p):
        p.grad.add_(1e-3 * (rank + 1))
    for n, p in solver.params.items():
        if n not in solver.split:
            p.register_post_accumulate_grad_hook(move)
    losses = []
    for b in batches:
        t, rows = rank_batch(b, rank, world, m)
        metrics = solver.train_step(*t, rows=rows)
        losses.append({k: float(v) for k, v in metrics.items()})
    calls = []
    reduce = dist.all_reduce
    dist.all_reduce = lambda *a, **k: calls.append(1) or reduce(*a, **k)
    try:
        mesh.all_reduce_grads(solver.params)
    finally:
        dist.all_reduce = reduce
    return {"losses": losses, "all_reduce_calls": len(calls),
            **tp_state(solver)}


def tp_lm_steps(rank, world, m, model_cfg, hparas, batches, workdir,
                load=None):
    """Train steps of the port's LM solver at ``model_parallel: m`` from
    the checkpoint ``load``: losses and ``tp_state``."""
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import Solver
    config = {"data": {"corpus": {"name": "none"},
                       "text": {"mode": "character"}},
              "model": copy.deepcopy(model_cfg), "hparas": dict(hparas),
              "model_parallel": m}
    paras = SimpleNamespace(config="lm.yaml", name=None, seed=0,
                            logdir=f"{workdir}/log", ckpdir=f"{workdir}/ckpt",
                            load=load, njobs=0, no_msg=True, cpu=True)
    solver = Solver(config, paras)
    solver.vocab_size = model_cfg["vocab"]
    solver.set_model()
    losses = []
    for b in batches:
        n = len(b["text_len"])
        padded = mesh.pad_batch_to(b, world)
        lo, hi = mesh.row_range(len(padded["text_len"]), rank // m,
                                world // m)
        out = solver.train_step(
            torch.from_numpy(padded["text"][lo:hi]).long(),
            torch.from_numpy(padded["text_len"][lo:hi]).long(),
            rows=(lo, hi, n) if world > 1 else None)
        losses.append({k: float(v) for k, v in out.items()})
    return {"losses": losses, **tp_state(solver)}


def tp_decode(rank, world, m, audio_cfg, model_cfg, lm_cfg, vocab,
              asr_ckpt, lm_ckpt, wave, wave_len, decode_cfgs, greedy_steps):
    """The port's ASR and LM from checkpoints, cut to this rank's parts at
    ``model_parallel: m``: a beam decode of the batch (numpy waves, the
    same on every rank) for each decode config ((tokens, lengths, scores)
    each), then amp greedy decoding through the lookup tables."""
    from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
    from end_to_end_asr_pytorch_tpu_torch.decode.greedy import att_greedy
    from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
    from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM
    from end_to_end_asr_pytorch_tpu_torch.ops.audio import AudioFrontend
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh, tp
    from end_to_end_asr_pytorch_tpu_torch.utils.jax_ckpt import \
        load_checkpoint
    mesh.set_model_parallel(m)
    model = ASR(40, vocab, model_cfg, device="cpu")
    load_checkpoint(asr_ckpt, model)
    lm = RNNLM(vocab, lm_cfg, device="cpu")
    load_checkpoint(lm_ckpt, lm)
    split = {**tp.shard_module(model), **tp.shard_module(lm, "lm.")}
    params = {**dict(model.named_parameters()),
              **{f"lm.{n}": p for n, p in lm.named_parameters()}}
    feat, flen = AudioFrontend(audio_cfg, device="cpu")(
        torch.from_numpy(wave), torch.from_numpy(wave_len))
    out = {"split": split, "beams": []}
    with torch.no_grad(), tp.gathered(params, split):
        for cfg in decode_cfgs:
            o = BeamDecoder(model, cfg, lm).forward(feat, flen)
            out["beams"].append((o.tokens, o.lengths, o.scores))
        enc, enc_len = model.encode(feat, flen)
        out["greedy"] = att_greedy(model, enc, enc_len, greedy_steps,
                                   amp=True)
    return out


def tp_jobs(rank, world, jobs):
    """Several of this module's rank functions in one group, in order:
    ``jobs`` is a list of (function name, its arguments after ``rank,
    world``); returns their results."""
    return [globals()[fn](rank, world, *args) for fn, args in jobs]


def run_main(rank, world, argv):
    """``main`` with ``argv`` in an existing group; its return value."""
    from end_to_end_asr_pytorch_tpu_torch import main
    return main.main(argv)
