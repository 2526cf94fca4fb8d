#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0] [--batch 32]

Phases, each printing one JSON line:
  1. device  - the card (nvidia-smi name and power limit), torch / CUDA versions
  2. build   - nvcc builds every kernel of the serving path from csrc/
  3. k1      - the fbank kernel against its plain PyTorch version at
               B utterances of 7 s with ragged lengths (log-mel atol 1e-3)
  4. k2      - the LSTM scan kernel against its plain version at H=512,
               T=176, both directions, ragged masks (atol 1e-4), at B=128
               and at the slice's batch
  5. slice   - bench.py's model at full width (VGG + 3x BiLSTM-512,
               loc attention 300 / kernel 100, LSTM-512 decoder and LM,
               beam 8, V=31, CTC 0.3 + LM 0.3) with random weights from
               --seed: three timed decode batches with the kernels (the
               main path; every kernel must have been launched there), one
               with the plain versions, both on the card; then a breakdown
               of one batch (host-clock split and a torch.profiler pass)
  6. entry   - python -m end_to_end_asr_pytorch_tpu_torch.transcribe on
               two WAVs with a reference-layout checkpoint
Then a line with the per-kernel measurements ({"kernels": [...]}), the
nvidia-smi line, and last {"ok": true, "device": {...}}. Any failed phase
ends the run with a non-zero exit code. Needs CUDA: without it the script
fails before printing a result.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# bench.py's full-width serving configuration
MODEL_CFG = {
    "ctc_weight": 0.5,
    "encoder": {"prenet": "vgg", "module": "LSTM", "bidirection": True,
                "dim": [512, 512, 512], "dropout": [0.0] * 3,
                "layer_norm": [False] * 3, "proj": [False] * 3,
                "sample_rate": [1, 1, 1], "sample_style": "drop"},
    "attention": {"mode": "loc", "dim": 300, "num_head": 1,
                  "temperature": 0.5, "v_proj": True,
                  "loc_kernel_size": 100, "loc_kernel_num": 10},
    "decoder": {"module": "LSTM", "dim": 512, "layer": 1, "dropout": 0.0},
}
LM_CFG = {"module": "LSTM", "dim": 512, "emb_dim": 512, "layer": 1}
AUDIO_CFG = {"feat_type": "fbank", "feat_dim": 40, "cmvn": True}
DECODE_CFG = {"beam_size": 8, "min_len_ratio": 0.05, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3}
CHARS = list("abcdefghijklmnopqrstuvwxyz'") + ["<space>"]   # V = 3 + 28 = 31
SECS = 7.0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s (no tensor cores)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_waves(n, seed, secs=SECS, sr=16000):
    """bench.py's waves (padded to the 64-frame quantum) with ragged
    lengths between 60% and 100% of ``secs``."""
    rng = np.random.RandomState(seed)
    s = int(secs * sr)
    t_pad = ((s // 160 + 1 + 63) // 64) * 64
    s_pad = (t_pad - 1) * 160
    waves = rng.randn(n, s_pad).astype(np.float32) * 0.1
    lens = rng.randint(int(0.6 * s), s + 1, size=n).astype(np.int32)
    lens[0] = s
    for b, n_b in enumerate(lens):
        waves[b, n_b:] = 0.0
    return waves, lens


def export_asr_state_dict(model):
    """Port ASR module -> reference-layout torch state_dict (the layout the
    port's utils/torch_ckpt.py reads)."""
    import torch
    sd = OrderedDict()
    t = lambda x: x.detach().cpu().clone()

    def rnn(prefix, cell, suffix):
        sd[f"{prefix}.weight_ih{suffix}"] = t(cell.w_ih.T)
        sd[f"{prefix}.weight_hh{suffix}"] = t(cell.w_hh.T)
        sd[f"{prefix}.bias_ih{suffix}"] = t(cell.b)
        sd[f"{prefix}.bias_hh{suffix}"] = torch.zeros_like(t(cell.b))

    pre = model.encoder.prenet
    for i in (1, 2, 3, 4):
        sd[f"encoder.layers.0.conv{i}.weight"] = t(getattr(pre, f"k{i}"))
        sd[f"encoder.layers.0.conv{i}.bias"] = t(getattr(pre, f"b{i}"))
    for li, layer in enumerate(model.encoder.layers):
        rnn(f"encoder.layers.{li + 1}.layer", layer.fwd, "_l0")
        rnn(f"encoder.layers.{li + 1}.layer", layer.bwd, "_l0_reverse")
    sd["ctc_layer.weight"] = t(model.ctc_w.T)
    sd["ctc_layer.bias"] = t(model.ctc_b)
    sd["pre_embed.weight"] = t(model.embed)
    a = model.attention
    sd["attention.proj_q.weight"] = t(a.w_q.T)
    sd["attention.proj_k.weight"] = t(a.w_k.T)
    sd["attention.proj_v.weight"] = t(a.w_v.T)
    sd["attention.loc_conv.weight"] = t(a.loc_conv)
    sd["attention.loc_proj.weight"] = t(a.w_f.T)
    sd["attention.bias"] = t(a.bias)
    sd["attention.gen_energy.weight"] = t(a.v_energy)
    for ci, cell in enumerate(model.decoder.cells):
        rnn("decoder.layers", cell, f"_l{ci}")
    sd["char_trans.weight"] = t(model.char_w.T)
    sd["char_trans.bias"] = t(model.char_b)
    return sd


def phase_k1(frontend, batch, seed):
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import fbank_kernel as fk
    w, _ = make_waves(batch, seed)
    wave = torch.from_numpy(w).cuda()
    kw = dict(n_fft=frontend.n_fft, hop=frontend.hop, log_eps=1e-10)
    args = (wave, frontend.cosw, frontend.msinw, frontend.mel_fb)
    got = fk.fbank_fused(*args, **kw)
    ref = fk.fbank_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(bool(torch.isfinite(got).all()), "K1 output not finite")
    check(err <= 1e-3, f"K1 log-mel max abs err {err} > 1e-3")
    window = torch.hann_window(frontend.n_fft, device="cuda")

    def library():
        spec = torch.stft(wave, frontend.n_fft, frontend.hop, window=window,
                          center=True, pad_mode="reflect", return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2
        return torch.log(power.transpose(1, 2) @ frontend.mel_fb + 1e-10)

    lib_err = float((library() - ref).abs().max())
    B, S = wave.shape
    T, n_mels = got.shape[1], got.shape[2]
    n_fft, n_bins = frontend.n_fft, frontend.n_bins
    nbytes = 4 * (B * S + 2 * n_fft * n_bins + n_bins * n_mels + B * T * n_mels)
    flops = B * T * (4 * n_fft * n_bins + 3 * n_bins + 2 * n_bins * n_mels)
    b_ms, b_by = bound(nbytes, flops)
    res = {"name": "fbank_fused", "route": "cuda",
           "source": "end_to_end_asr_pytorch_tpu_torch/csrc/fbank.cu",
           "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/fbank_kernel.py:75",
           "max_abs_err": err,
           "ms": cuda_ms(lambda: fk.fbank_fused(*args, **kw), 20),
           "plain_ms": cuda_ms(lambda: fk.fbank_plain(*args, **kw), 20),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cuda_ms(library, 20)}
    emit({"phase": "k1", "shape": [B, S], "frames": T,
          "library_max_abs_err_vs_plain": lib_err, **res})
    return res


def phase_k2(seed, slice_batch, T=176, H=512):
    """K2 against its plain version, both directions, ragged masks, at B=128
    and at the slice's batch (the shape the main path gives it; that record
    is the kernel's line)."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel as lk
    rng = np.random.RandomState(seed + 1)
    s = 1.0 / math.sqrt(H)
    w_hh = torch.from_numpy(rng.uniform(-s, s, (H, 4 * H)).astype(np.float32)).cuda()
    # cuDNN yardstick at full length: identity input weights make its gates
    # x_proj + h @ W_hh as here (it also runs a (T*B, 4H) x (4H, 4H) input
    # product that the kernel does not)
    cudnn = torch.nn.LSTM(4 * H, H).cuda()
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(torch.eye(4 * H, device="cuda"))
        cudnn.weight_hh_l0.copy_(w_hh.T)
        cudnn.bias_ih_l0.zero_()
        cudnn.bias_hh_l0.zero_()
    records = {}
    for B in (128, slice_batch):
        xp = torch.from_numpy(rng.randn(T, B, 4 * H).astype(np.float32)).cuda()
        lens = rng.randint(T // 2, T + 1, size=B)
        lens[0] = T
        mask = torch.from_numpy(np.arange(T)[:, None] < lens[None, :]).cuda()
        err = 0.0
        for reverse in (False, True):
            got = lk.lstm_scan_fused(xp, w_hh, mask, reverse)
            ref = lk.lstm_scan_plain(xp, w_hh, mask, reverse)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "K2 output not finite")
            err = max(err, float((got - ref).abs().max()))
        check(err <= 1e-4, f"K2 max abs err {err} > 1e-4 at B={B}")

        def library():
            with torch.no_grad():
                return cudnn(xp)[0]

        full = torch.ones_like(mask)
        lib_err = float((library() - lk.lstm_scan_fused(xp, w_hh, full)).abs().max())
        nbytes = 4 * (T * B * 4 * H + H * 4 * H + T * B + T * B * H)
        flops = T * 2 * B * H * 4 * H
        b_ms, b_by = bound(nbytes, flops)
        records[B] = {
            "name": "lstm_scan_fused", "route": "cuda",
            "source": "end_to_end_asr_pytorch_tpu_torch/csrc/lstm_scan.cu",
            "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py:92",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: lk.lstm_scan_fused(xp, w_hh, mask, True), 10),
            "plain_ms": cuda_ms(lambda: lk.lstm_scan_plain(xp, w_hh, mask, True), 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(library, 10)}
        emit({"phase": "k2", "T": T, "B": B, "H": H,
              "cudnn_full_length_max_abs_err": lib_err, **records[B]})
    return records[slice_batch]


def phase_slice(frontend, batch, seed, device, n_batches=3):
    import torch
    from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
    from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
    from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM
    from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import fbank_kernel, lstm_kernel
    g = torch.Generator().manual_seed(seed)
    model = ASR(frontend.feat_dim, 3 + len(CHARS), MODEL_CFG, generator=g,
                device=device)
    lm = RNNLM(3 + len(CHARS), LM_CFG, generator=g, device=device)
    decoder = BeamDecoder(model, DECODE_CFG, lm=lm)
    w, wl = make_waves(batch, seed + 2)
    wave, wave_len = torch.from_numpy(w).to(device), torch.from_numpy(wl).to(device)

    def run():
        with torch.no_grad():
            feat, feat_len = frontend(wave, wave_len)
            enc, _ = model.encode(feat, feat_len)
            return enc, decoder.forward(feat, feat_len)

    run()                                   # warm-up (cuDNN / cuBLAS plans)
    torch.cuda.synchronize()
    fbank_kernel.fbank_fused.launches = 0
    lstm_kernel.lstm_scan_fused.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(n_batches):
            feat, feat_len = frontend(wave, wave_len)
            out_k = decoder.forward(feat, feat_len)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_batches
    launches = {"fbank_fused": fbank_kernel.fbank_fused.launches,
                "lstm_scan_fused": lstm_kernel.lstm_scan_fused.launches}
    steps = decoder.last_steps
    check(launches["fbank_fused"] > 0 and launches["lstm_scan_fused"] > 0,
          f"main path did not launch every kernel: {launches}")
    enc_k, _ = run()
    cuda_kernels.USE_KERNELS = False
    try:
        enc_p, out_p = run()
    finally:
        cuda_kernels.USE_KERNELS = True
    torch.cuda.synchronize()
    K = DECODE_CFG["beam_size"]
    check(tuple(out_k.scores.shape) == (batch, K), "scores shape")
    check(bool(torch.isfinite(out_k.scores[:, 0]).all())
          and bool((out_k.scores[:, 0] > -1e29).all()), "top-1 scores")
    enc_err = float((enc_k - enc_p).abs().max())
    score_err = float((out_k.scores[:, 0] - out_p.scores[:, 0]).abs().max())
    same = [bool(out_k.lengths[b, 0] == out_p.lengths[b, 0]) and torch.equal(
        out_k.tokens[b, 0, :out_k.lengths[b, 0]],
        out_p.tokens[b, 0, :out_p.lengths[b, 0]]) for b in range(batch)]
    check(enc_err <= 1e-3, f"encoder kernel vs plain max abs diff {enc_err}")
    # random weights leave many hypotheses within ~1e-4 of each other, so
    # 1e-7 differences in the encoder can reorder near-tied beams: the best
    # normalized score is held to 1e-2, the encoder output to 1e-3
    check(score_err <= 1e-2, f"best score kernel vs plain max abs diff {score_err}")
    emit({"phase": "slice", "batch": batch, "secs": SECS,
          "enc_frames": int(enc_k.shape[1]), "decode_steps": steps,
          "enc_max_abs_diff": enc_err, "best_score_max_abs_diff": score_err,
          "top1_identical_share": sum(same) / batch,
          "batches": n_batches, "utts_per_s": batch / dt,
          "seconds_per_batch": dt, "launches": launches})
    slice_breakdown(frontend, model, decoder, wave, wave_len)
    return model, launches


def slice_breakdown(frontend, model, decoder, wave, wave_len):
    """Where one kernel-path decode batch spends its time: host-clock split
    into front end, encoder and beam loop, then one profiled decode for the
    device's busy share and its largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        (feat, feat_len), front_ms = timed(lambda: frontend(wave, wave_len))
        _, enc_ms = timed(lambda: model.encode(feat, feat_len))
        _, fwd_ms = timed(lambda: decoder.forward(feat, feat_len))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_ms = timed(lambda: decoder.forward(feat, feat_len))
    from torch.autograd import DeviceType
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies): an operator's own row
    # repeats the time of the kernels it launched
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev(e) > 0]
    check(len(evts) > 0, "the profiler recorded no device time")
    busy_ms = sum(dev(e) for e in evts) / 1e3
    top = {}
    for e in evts:
        top[e.key[:90]] = top.get(e.key[:90], 0.0) + dev(e) / 1e3
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:8])
    emit({"phase": "slice_breakdown", "frontend_ms": front_ms,
          "encode_ms": enc_ms, "beam_loop_ms": fwd_ms - enc_ms,
          "decode_steps": decoder.last_steps,
          "beam_step_ms": (fwd_ms - enc_ms) / decoder.last_steps,
          "profiled_decode_ms": prof_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / prof_ms,
          "device_kernel_launches": sum(e.count for e in evts),
          "top_device_ms": top})


def phase_entry(model, seed):
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch.data.audio_io import write_wav
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        (d / "vocab.txt").write_text("\n".join(CHARS) + "\n")
        cfg = {"data": {"corpus": {"name": "smoke"}, "audio": AUDIO_CFG,
                        "text": {"mode": "character",
                                 "vocab_file": str(d / "vocab.txt")}},
               "model": MODEL_CFG, "hparas": {},
               "decode": {k: v for k, v in DECODE_CFG.items()
                          if k != "lm_weight"}}
        (d / "cfg.yaml").write_text(yaml.safe_dump(cfg))
        torch.save({"model": export_asr_state_dict(model), "global_step": 0},
                   str(d / "asr.pth"))
        rng = np.random.RandomState(seed + 3)
        wavs = []
        for i, secs in enumerate((2.5, 1.7)):
            p = d / f"utt{i}.wav"
            write_wav(str(p), rng.randn(int(secs * 16000)) * 0.1)
            wavs.append(str(p))
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "end_to_end_asr_pytorch_tpu_torch.transcribe",
             "--config", str(d / "cfg.yaml"), "--load", str(d / "asr.pth"),
             "--output", str(d / "out.tsv"), *wavs],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"transcribe exited {proc.returncode}: {proc.stderr[-2000:]}")
        rows = (d / "out.tsv").read_text().strip().split("\n")
        check(len(rows) == 2 and all("\t" in r for r in rows),
              f"transcribe TSV rows: {rows!r}")
        emit({"phase": "entry", "rows": len(rows), "seconds": dt,
              "stderr_tail": proc.stderr.strip().splitlines()[-1:]})


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--phases", default="k1,k2,slice,entry",
                    help="comma list of phases after build (default: all)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    from end_to_end_asr_pytorch_tpu_torch.ops.audio import create_transform
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build
    from end_to_end_asr_pytorch_tpu_torch.utils.device import resolve_device

    device = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    secs = build.build(["fbank", "lstm_scan"])
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in build.build_log.items()}
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas})

    frontend, _ = create_transform(AUDIO_CFG, device=device)
    kernels = {}
    if "k1" in phases:
        kernels["fbank_fused"] = phase_k1(frontend, args.batch, args.seed)
    if "k2" in phases:
        kernels["lstm_scan_fused"] = phase_k2(args.seed, args.batch)
    if "slice" in phases:
        model, launches = phase_slice(frontend, args.batch, args.seed, device)
        for name, n in launches.items():
            if name in kernels:
                kernels[name]["launches"] = n
        if "entry" in phases:
            phase_entry(model, args.seed)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r.get(k) for k in order} for r in kernels.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
