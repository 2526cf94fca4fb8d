#!/usr/bin/env python3
"""Times K1, K2, K2b, K3, K4, K4b, K5, K6, K7 and K8 of one checkout of the
PyTorch port on one GPU, so that two commits can be compared on the same
card in turns.

    python3 chip_turns.py [--root DIR] [--seed 0] [--cases k1,k2,k2b,...]

``--root`` is the checkout whose ``end_to_end_asr_pytorch_tpu_torch`` is
imported (default: this one); run the script once per checkout, in turns
(parent, change, change, parent), inside one call on the card. It prints
one JSON line per measurement and last the card's name and power limit:

  k1   - fbank_fused on 7 s waves (chip_smoke's) at B=32 and 128, beside
         torch.stft + mel (ms by CUDA events over 20 calls, device ms by
         the profiler, for both)
  k2   - lstm_scan_fused in f32 (serving, and with its training residuals)
         at T=176, H=512, B=32 and 128, reversed, ragged masks, beside
         cuDNN nn.LSTM's forward (TF32 off)
  k2b  - lstm_bwd_fused (with the dW_hh GEMM) at the same shapes, beside
         cuDNN nn.LSTM fwd+bwd - fwd
  k3   - ctc_loss_fused (chip_smoke's ctc_case: V=31, ragged lengths, one
         infeasible row) at B=32 and 128 (T=176, U=96) and "long" (B=32,
         T=307, U=200): device ms of the kernel alone (kernel_device_ms)
         and of the whole function from the log-probs (function_device_ms,
         which for a checkout whose K3 takes the emission lattice adds its
         prepare), ms by CUDA events over 20 calls of the function, and the
         kernel's launches per call
  k4   - gru_scan_fused in f32 (serving, and with its training residuals)
         at T=176, H=512, B=32 and 128, reversed, ragged masks, beside
         cuDNN nn.GRU's forward (TF32 off)
  k4b  - gru_bwd_fused (with the dW_hh GEMM) at T=176, H=512, B=32 and 128,
         reversed, ragged masks, beside cuDNN nn.GRU fwd+bwd - fwd (TF32 off)
  k5   - loc_attention_fused at B=32 and 128, K=8, T=176, d=300, F=10,
         vdim=300, ragged lengths (ms by CUDA events over 20 calls, device
         ms by the profiler)
  k6   - psi_fused at B=32 and 128, K=8, T=176, V=5120, bf16 probs
         (chip_smoke's psi_case), beside torch.bmm of the rounded weights
         and the probs (ms and device ms, for both)
  k7   - loc_att_fwd_fused and loc_att_bwd_fused (the f32 training
         attention step), and loc_att_fwd_bf16 and loc_att_bwd_bf16 on the
         same inputs rounded to bf16 (amp training), at B=32 and 128,
         T=176, d=300, vdim=300, ragged lengths (ms by CUDA events over 20
         calls, device ms by the profiler)
  k8   - beam_step_fused at B=32 (V=31, V=5120 and V=16384) and B=128
         (V=5120), K=8,
         T=176, on beam states made by 40 plain beam steps over random
         logits and CTC log-probs from --seed (ms by CUDA events over 20
         calls, and the least of 9 more such trials: where the host's
         enqueue is slower than the card, as at V=31, the host's noise
         only ever adds; device ms by the profiler), beside the plain tail

``--cases`` keeps only the named ones (k1, k2, k2b, k3, k4, k4b, k5, k6,
k7, k8_31, k8_5120, k8_5120_b128, k8_16384; default all but k1 and k6).
It needs CUDA and exits with an error without it.
"""
import argparse
import inspect
import subprocess
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases",
                    default="k2,k2b,k3,k4,k4b,k5,k7,k8_31,k8_5120,"
                            "k8_5120_b128,k8_16384")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_turns: CUDA is not available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs              # this checkout's timing helpers
    sys.path.insert(0, str(Path(args.root).resolve()))
    from end_to_end_asr_pytorch_tpu_torch.ops import ctc_prefix
    from end_to_end_asr_pytorch_tpu_torch.ops.audio import create_transform
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import att_kernel as ak
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import att_train_kernel as tk
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import beam_step_kernel as bsk
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import ctc_kernel as ck
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import fbank_kernel as fk
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import gru_kernel as gk
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel as lk
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import psi_kernel as pk
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = str(Path(args.root).resolve())
    for mod in (ak, bsk, ck, fk, gk, lk, pk, tk):
        assert Path(mod.__file__).resolve().is_relative_to(root), mod.__file__

    cases = set(args.cases.split(","))
    T, H = 176, 512
    frontend, _ = create_transform(cs.AUDIO_CFG, device="cuda")
    for B in ((32, 128) if "k1" in cases else ()):
        wave = torch.from_numpy(cs.make_waves(B, args.seed)[0]).cuda()
        fused = lambda: fk.fbank_fused(
            wave, frontend.cosw, frontend.msinw, frontend.mel_fb,
            n_fft=frontend.n_fft, hop=frontend.hop, log_eps=1e-10)
        library = cs.stft_mel(frontend, wave)
        cs.emit({"turn": "k1", "root": root, "B": B,
                 "ms": cs.cuda_ms(fused, 20),
                 "device_ms": cs.device_ms(fused),
                 "library_ms": cs.cuda_ms(library, 20),
                 "library_device_ms": cs.device_ms(library)})
    for B in ((32, 128) if "k6" in cases else ()):
        psi = cs.psi_case(B, 8, T, cs.V_SUB, args.seed + 9 + B + cs.V_SUB,
                          torch.bfloat16)
        fused = lambda: pk.psi_fused(*psi)
        library, _ = cs.psi_library(psi[0].to(torch.bfloat16), psi[1])
        cs.emit({"turn": "k6", "root": root, "B": B,
                 "ms": cs.cuda_ms(fused, 20),
                 "device_ms": cs.device_ms(fused),
                 "library_ms": cs.cuda_ms(library, 20),
                 "library_device_ms": cs.device_ms(library)})
    for B in ((32, 128) if cases & {"k2", "k2b"} else ()):
        rng = np.random.RandomState(args.seed + B)
        w_hh = cs.lstm_weights(rng, H)
        xp, dys, mask = cs.scan_case(rng, B, T, H, 4)
        cudnn = cs.cudnn_lstm(w_hh)
        xl = xp.clone().requires_grad_(True)
        fwd = cs.cuda_ms(lambda: cudnn(xl)[0], 10)
        if "k2" in cases:
            cs.emit({"turn": "k2", "root": root, "B": B,
                     "ms": cs.cuda_ms(lambda: lk.lstm_scan_fused(
                         xp, w_hh, mask, True), 10),
                     "ms_residuals": cs.cuda_ms(lambda: lk.lstm_scan_fused(
                         xp, w_hh, mask, True, residuals=True), 10),
                     "cudnn_ms": cs.cuda_ms(lambda: cudnn(xp)[0], 10)})
        if "k2b" in cases:
            ys, c, gates = lk.lstm_scan_fused(xp, w_hh, mask, True,
                                              residuals=True)
            cs.emit({"turn": "k2b", "root": root, "B": B,
                     "ms": cs.cuda_ms(lambda: lk.lstm_bwd_fused(
                         gates, c, ys, mask, w_hh, dys, True), 10),
                     "cudnn_ms": cs.cuda_ms(
                         lambda: cudnn(xl)[0].backward(dys), 10) - fwd})
    for label, B, T3, U in ((("B32", 32, 176, 96), ("B128", 128, 176, 96),
                             ("long", 32, 307, 200)) if "k3" in cases else ()):
        lp, ll, lab, lab_len = (x.cuda() for x in cs.ctc_case(
            B, args.seed + 5, T3, U))
        if "emit" in inspect.signature(ck.ctc_loss_fused).parameters:
            emit, skip, eidx, _ = ck.prepare(lp, lab, lab_len)
            kernel = lambda: ck.ctc_loss_fused(emit, skip, ll, eidx)
            function = lambda: (lambda e, s, i, _: ck.ctc_loss_fused(
                e, s, ll, i))(*ck.prepare(lp, lab, lab_len))
        else:
            kernel = function = lambda: ck.ctc_loss_fused(lp, ll, lab, lab_len)
        before = ck.ctc_loss_fused.launches
        kernel()
        cs.emit({"turn": "k3", "root": root, "shape": label, "B": B, "T": T3,
                 "S": 2 * U + 1, "launches": ck.ctc_loss_fused.launches - before,
                 "kernel_device_ms": cs.device_ms(kernel),
                 "function_device_ms": cs.device_ms(function),
                 "ms": cs.cuda_ms(function, 20)})
    for B in ((32, 128) if "k4" in cases else ()):
        rng = np.random.RandomState(args.seed + B)
        w_hh, b_hh = cs.gru_weights(rng, H)
        xp, _, mask = cs.scan_case(rng, B, T, H, 3)
        cudnn = cs.cudnn_gru(w_hh, b_hh)
        with torch.no_grad():
            cs.emit({"turn": "k4", "root": root, "B": B,
                     "ms": cs.cuda_ms(lambda: gk.gru_scan_fused(
                         xp, w_hh, b_hh, mask, True), 10),
                     "ms_residuals": cs.cuda_ms(lambda: gk.gru_scan_fused(
                         xp, w_hh, b_hh, mask, True, residuals=True), 10),
                     "cudnn_ms": cs.cuda_ms(lambda: cudnn(xp)[0], 10)})
    for B in ((32, 128) if "k4b" in cases else ()):
        rng = np.random.RandomState(args.seed + B)
        w_hh, b_hh = cs.gru_weights(rng, H)
        xp, dys, mask = cs.scan_case(rng, B, T, H, 3)
        ys, gates, hp_n = gk.gru_scan_fused(xp, w_hh, b_hh, mask, True,
                                            residuals=True)
        cudnn = cs.cudnn_gru(w_hh, b_hh)
        xl = xp.clone().requires_grad_(True)
        fwd = cs.cuda_ms(lambda: cudnn(xl)[0], 10)
        cs.emit({"turn": "k4b", "root": root, "B": B,
                 "ms": cs.cuda_ms(lambda: gk.gru_bwd_fused(
                     gates, hp_n, ys, mask, w_hh, dys, True), 10),
                 "cudnn_ms": cs.cuda_ms(
                     lambda: cudnn(xl)[0].backward(dys), 10) - fwd})

    for B in ((32, 128) if "k5" in cases else ()):
        rng, lens = cs.att_case(B, args.seed + 7, T)
        r = lambda *shape, s: torch.from_numpy(
            (rng.randn(*shape) * s).astype(np.float32)).cuda()
        K, d, F, vdim, tau = 8, 300, 10, 300, 0.5
        att = (r(B, K, d, s=0.3), r(B, T, d, s=0.3), r(B, K, T, F, s=0.05),
               r(F, d, s=0.3), r(d, s=0.06), r(B, T, vdim, s=0.3),
               torch.from_numpy(lens).cuda(), tau)
        cs.emit({"turn": "k5", "root": root, "B": B,
                 "ms": cs.cuda_ms(lambda: ak.loc_attention_fused(*att), 20),
                 "device_ms": cs.device_ms(
                     lambda: ak.loc_attention_fused(*att))})

    for B in ((32, 128) if "k7" in cases else ()):
        rng, lens = cs.att_case(B, args.seed + 8, T)
        r = lambda *shape, s: torch.from_numpy(
            (rng.randn(*shape) * s).astype(np.float32)).cuda()
        d = vdim = 300
        ins = (r(B, d, s=0.3), r(B, T, d, s=0.3), r(B, T, d, s=0.1),
               r(d, s=0.06), r(B, T, vdim, s=0.3),
               torch.from_numpy(lens).cuda())
        dctx, dalign = r(B, vdim, s=1.0), r(B, T, s=1.0)
        bins = tuple(t.to(torch.bfloat16) for t in ins[:5]) + ins[5:]
        rec = {}
        for tag, x, f_fn, b_fn in (
                ("", ins, tk.loc_att_fwd_fused, tk.loc_att_bwd_fused),
                ("bf16_", bins, tk.loc_att_fwd_bf16, tk.loc_att_bwd_bf16)):
            _, align = f_fn(*x, 0.5)
            fwd = lambda: f_fn(*x, 0.5)
            bwd = lambda: b_fn(*x, align, dctx, dalign, 0.5)
            rec.update({f"{tag}fwd_ms": cs.cuda_ms(fwd, 20),
                        f"{tag}fwd_device_ms": cs.device_ms(fwd),
                        f"{tag}bwd_ms": cs.cuda_ms(bwd, 20),
                        f"{tag}bwd_device_ms": cs.device_ms(bwd)})
        cs.emit({"turn": "k7", "root": root, "B": B, **rec})

    takes_probs = "probs" in inspect.signature(bsk.beam_step_fused).parameters
    for B, V, name in ((32, 31, "k8_31"), (32, 5120, "k8_5120"),
                       (128, 5120, "k8_5120_b128"), (32, 16384, "k8_16384")):
        if name not in cases:
            continue
        g = torch.Generator(device="cuda").manual_seed(args.seed + V)
        K = 8
        lens = torch.randint(T // 2, T + 1, (B,), generator=g, device="cuda")
        lens[0] = T
        raw = torch.randn(B, T, V, generator=g, device="cuda") * 3
        lp = ctc_prefix.pad_ctc_log_probs(torch.log_softmax(raw, -1),
                                          lens.to(torch.int32))
        r, _ = ctc_prefix.init_state(lp, K)
        state = [torch.zeros(B, K, device="cuda"),
                 (torch.arange(K, device="cuda")[None] == 0).expand(
                     B, K).contiguous(),
                 torch.full((B, K), 1, dtype=torch.int64, device="cuda"),
                 torch.full((B, K), -1e30, device="cuda"),
                 torch.zeros((B, K), dtype=torch.int64, device="cuda"),
                 r.contiguous()]
        mn = torch.ceil(0.05 * lens.float()).to(torch.int32)
        mx = torch.clamp(torch.ceil(0.6 * lens.float()).to(torch.int32), min=1)
        kw = dict(aw=0.7, cw=0.3, lw=0.3, eos=1, pad=0, blank=0)
        probs = torch.exp(lp)
        for t in range(41):
            logits = torch.randn(B, K, V, generator=g, device="cuda") * 2
            lm = torch.randn(B, K, V, generator=g, device="cuda") * 2
            base, valid, last, fin_norm, fin_meta, r = state
            step = (t, logits, lm, base, valid, last, fin_norm, fin_meta, r,
                    lp, mn, mx)
            o = bsk.beam_step_plain(*step, probs=probs, **kw)
            state = [o.new_base, o.new_valid, o.v_idx, o.fin_norm, o.fin_meta,
                     o.r.contiguous()]
        fkw = {**kw, "probs": probs} if takes_probs else kw
        fused = lambda: bsk.beam_step_fused(*step, **fkw)
        plain = lambda: bsk.beam_step_plain(*step, probs=probs, **kw)
        cs.emit({"turn": "k8", "root": root, "B": B, "V": V,
                 "ms": cs.cuda_ms(fused, 20),
                 "ms_min_of_9": min(cs.cuda_ms(fused, 20) for _ in range(9)),
                 "device_ms": cs.device_ms(fused),
                 "plain_ms": cs.cuda_ms(plain, 20),
                 "plain_device_ms": cs.device_ms(plain)})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
