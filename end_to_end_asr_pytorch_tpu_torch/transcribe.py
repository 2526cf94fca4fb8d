"""Batch transcription: audio files in, a TSV of transcripts out.

  python -m end_to_end_asr_pytorch_tpu_torch.transcribe \
      --config config/libri/asr_example.yaml --load ref_ckpt.pth \
      audio1.wav dir_of_audio/ [--beam 8] [--batch 16] [--output out.tsv] [--cpu]

Same flags and output as the JAX package's ``transcribe.py``. ``--load``
takes a reference-layout torch ASR checkpoint or one the JAX package wrote.
Runs on the card unless ``--cpu`` is given. As in the root tool, LM fusion
is off here (``lm_weight`` forced to 0): decoding with the RNN-LM is
``python -m end_to_end_asr_pytorch_tpu_torch.main --test``. The config's
``data.text`` may be character, word or subword (a sentencepiece ``.model``
or a JSON BPE), and its ``decode`` block reaches the beam as it is:
``amp: auto`` (the default) decodes in bf16 on the card and in f32 with
``--cpu``, each beam step's tail is one K8 launch where its scope holds
(CTC on, amp off) unless ``fused_step: false``, and ``psi_kernel: true``
takes K6 where its gate opens off K8's route. Beyond the root tool, a
``model.plugin`` block is read as ``main --test`` reads it: the plugin's
projection comes from the checkpoint and ``fuse > 0`` decodes with its
fused log-probs.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import load_config
from .data.audio_io import load_audio
from .decode.beam import BeamDecoder
from .decode.greedy import ctc_greedy
from .models.asr import ASR
from .models.plugin import plugin_from_config
from .ops.audio import create_transform
from .utils.device import resolve_device
from .utils.text import load_text_encoder
from .utils.jax_ckpt import load_checkpoint


def collect_files(paths):
    exts = {".wav", ".flac", ".npy"}
    out = []
    for p in map(Path, paths):
        if p.is_dir():
            out.extend(sorted(q for q in p.rglob("*")
                              if q.suffix.lower() in exts))
        elif p.suffix.lower() in exts:
            out.append(p)
        else:
            print(f"warning: skipping {p} (unsupported suffix)",
                  file=sys.stderr)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("audio", nargs="+", help="audio files or directories")
    ap.add_argument("--config", required=True)
    ap.add_argument("--load", required=True, help="ASR checkpoint")
    ap.add_argument("--beam", type=int, default=None,
                    help="override decode.beam_size")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--output", default=None, help="TSV output (default stdout)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = load_config(args.config)
    tokenizer = load_text_encoder(**cfg["data"]["text"])
    frontend, feat_dim = create_transform(cfg["data"]["audio"], device=device)
    model = ASR(feat_dim, tokenizer.vocab_size, cfg["model"], device=device)
    plugin = (plugin_from_config(cfg["model"], tokenizer.vocab_size,
                                 model.dec_dim, tokenizer, device=device)
              if model.enable_att else None)
    load_checkpoint(args.load, model, plugin)

    decode_cfg = dict(cfg.get("decode", {}))
    decode_cfg["lm_weight"] = 0.0
    if args.beam:
        decode_cfg["beam_size"] = args.beam
    decoder = (BeamDecoder(model, decode_cfg, plugin=plugin)
               if model.enable_att else None)

    files = collect_files(args.audio)
    if not files:
        sys.exit("no audio files found")
    rows = []
    t0 = time.perf_counter()
    audio_secs = 0.0
    sr_expect = frontend.sample_rate
    with torch.no_grad():
        for i in range(0, len(files), args.batch):
            chunk = files[i:i + args.batch]
            waves = []
            for f in chunk:
                w, sr = load_audio(str(f))
                if sr != sr_expect:
                    sys.exit(f"{f}: sample rate {sr} != the model's "
                             f"configured {sr_expect} Hz — resample first")
                waves.append(w)
            audio_secs += sum(len(w) for w in waves) / float(sr_expect)
            s_max = max(len(w) for w in waves)
            t_pad = ((s_max // 160 + 1 + 63) // 64) * 64
            s_pad = max((t_pad - 1) * 160, s_max)
            wave = np.zeros((len(chunk), s_pad), np.float32)
            wave_len = np.zeros((len(chunk),), np.int32)
            for b, w in enumerate(waves):
                wave[b, :len(w)] = w
                wave_len[b] = len(w)
            feat, feat_len = frontend(torch.from_numpy(wave).to(device),
                                      torch.from_numpy(wave_len).to(device))
            if decoder is not None:
                out = decoder.forward(feat, feat_len)
                toks, lens = out.tokens.cpu().numpy(), out.lengths.cpu().numpy()
                for b, f in enumerate(chunk):
                    rows.append((str(f), tokenizer.decode(
                        toks[b, 0, :lens[b, 0]].tolist())))
            else:
                enc, enc_len = model.encode(feat, feat_len)
                ids = ctc_greedy(model.ctc_output(enc)).cpu().numpy()
                enc_len = enc_len.cpu().numpy()
                for b, f in enumerate(chunk):
                    rows.append((str(f), tokenizer.decode(
                        ids[b, :enc_len[b]].tolist(), ignore_repeat=True)))
    dt = time.perf_counter() - t0
    text = "\n".join(f"{f}\t{hyp}" for f, hyp in rows)
    if args.output:
        Path(args.output).write_text(text + "\n")
    else:
        print(text)
    print(f"# {len(files)} files, {audio_secs:.1f}s audio in {dt:.1f}s "
          f"({audio_secs / dt:.1f}x real-time) on {device}", file=sys.stderr)


if __name__ == "__main__":
    main()
