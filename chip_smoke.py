#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0] [--batch 32] [--phases k1,k2,...]

Phases, each printing one JSON line:
  device      - the card (nvidia-smi name and power limit), torch / CUDA
  build       - nvcc builds every kernel (csrc/*.cu), all started together
  k1          - the fbank kernel (the DFT on the tensor cores, six passes
                of a three-part bf16 split) against its plain PyTorch
                version at the slice's batch and at B=128 of 7 s waves with
                ragged lengths (log-mel atol 1e-3), CUDA-event and device
                ms beside torch.stft + mel; its bound at the f32 rate and
                at the tensor rate (bound_ms_tensor); the HMMA lines of
                its library's SASS (cuobjdump), which must not be 0
  k2          - K2, the LSTM scan (the tensor-core scan of csrc/scan_tc.cuh
                in f32: the unrounded W_hh takes the remainder passes),
                against its plain version at H=512, T=176, both directions,
                ragged masks, without and with its residuals (ys, cells,
                gates atol 1e-4), at B=128 and at the slice's batch, for the
                design the wrapper picks and every design (cluster or grid,
                8 or 16 rows per group, in waves where they do not fit),
                each timed with its launches and resident groups; its bound
                at the f32 rate and at the tensor rate of its six bf16
                passes; cuDNN nn.LSTM as the yardstick; then H=318 (zero-
                padded to 320 by the wrapper), 320 and 1024 at B=32 and 128
                (k2_widths); K2 with bf16 residuals (k2_bf16_train, amp
                training: bf16 x_proj, ys, cell states and gates, f32
                carries, W_hh rounded to bf16) at B=128 and the slice's
                batch, both directions, in every design whose blocks fit
                (timed: all at the slice's batch, the picked one at B=128):
                ys and residuals within 1 bf16 ulp + 1e-5 of the plain
                version, bound at the bf16 tensor rate (3 passes), cuDNN
                nn.LSTM's bf16 training forward as the yardstick; and
                K2-bf16, the tensor-core scan
                (bf16 x_proj and ys, f32 carries), at the same shapes with
                W_hh rounded to bf16 as decode amp hands it (the row's ms)
                and with the unrounded f32 W_hh (ms_unrounded_w): ys within
                1 bf16 ulp of the plain version, plus 1e-5 for the f32 sums
                taken in another order; its bound at the bf16 tensor rate
                (three passes, and one pass as bound_ms_one_pass); every
                design (cluster or grid, 8 or 16 rows per group, in waves
                where the groups do not fit at once) checked the same way
                and timed beside the one the wrapper picks; then widths off
                the main path, H=300, 320 and 1024 at B=32 and 128
  scan_floor  - (only when named in --phases) the floor of the bf16 scans'
                step exchange at H=512, T=176: T rounds of barrier plus
                exchange of h alone, for a cooperative grid (grid.sync, h
                through L2, 16 or 32 blocks) and a cluster of 16 blocks
                (barrier.cluster, h through distributed shared memory)
  mma_floor   - (only when named in --phases) the ceiling of mma.sync
                m16n8k16 in bf16, the instruction K1 and the scans run on:
                one block per SM of 4, 8 and 16 warps issuing 28
                independent products each on register operands (TFLOP/s
                and share of the dense bf16 peak)
  k2b         - K2's residual outputs (cell states, gates) and K2b, the LSTM
                backward (the tensor-core backward scan), against their
                plain versions and against autograd through the plain scan,
                same shapes (residuals and dxp atol 1e-4, dW_hh within 1e-3
                of its max magnitude), for the picked design and every
                design whose blocks fit (at H=512 only 8-row groups do),
                each timed with its launches and resident groups; its
                bound at the f32 rate and at the tensor rate of its six
                bf16 passes; cuDNN nn.LSTM fwd+bwd - fwd as the yardstick;
                then H=320 and H=1024 at B=32 and 128 (k2b_widths); and
                K2b in bf16 (k2b_bf16, amp training) on the plain forward's
                bf16 residuals, both directions, every design whose blocks
                fit (timed as k2_bf16_train): dxp within 1 bf16 ulp + 1e-5,
                dW_hh within 1e-3 of its max magnitude; bound at the bf16
                tensor rate (3 passes and the dW_hh GEMM); cuDNN nn.LSTM in
                bf16 fwd+bwd - fwd as the yardstick
  k3          - the CTC forward-backward kernel (from the log-probs)
                against its plain version at B=128 and the slice's batch
                (T=176, U=96), "long" (B=32, T=307, U=200), "very_long"
                (B=8, T=875, U=600) and "chunked" (B=4, T=1400, U=1100,
                walked in chunks), V=31, ragged lengths, repeated labels,
                an infeasible row (NLL rtol 1e-5, gradient atol 1e-5, zero
                gradient on infeasible rows and past each length, the
                extended labels equal, every output bit-identical over two
                calls; the elements that differ from the plain version
                counted), for the picked design and every other (R states
                a thread, NW warps a group: the sweep), with the bytes the
                function must move (bound_ms), the bytes the kernel moves
                (moved_bound_ms) and the chain floor (frames less one times
                ctc_floor_kernel's step, k3_floor, which also holds the
                kernel's written-out expf / logf to the library's over
                every input they take); then k3_route: the card
                route's CTCLoss.forward must launch K3 alone (and how many
                kernels prepare, the old route's lattice gather, launches)
  k4          - K4, the GRU scan (the tensor-core scan of csrc/scan_tc.cuh
                in f32, as K2), against its plain version at H=512,
                T=176, both directions, ragged masks, at B=128 and at the
                slice's batch, without and with its residuals (ys, gates,
                hp_n atol 1e-4), for the design the wrapper picks and every
                design, each timed with and without residuals; its bound at
                the f32 rate and at the tensor rate of its six bf16 passes;
                then H=318, 320 and 1024 at B=32 and 128 (k4_widths); K4
                with bf16 residuals (k4_bf16_train, amp training: ys, gates
                and hp_n in bf16), checked and timed as k2_bf16_train, cuDNN
                nn.GRU's bf16 training forward as the yardstick; and
                K4-bf16 at the same shapes and widths, checked as K2-bf16
                (rounded and unrounded W_hh, every design, 1 bf16 ulp +
                1e-5); cuDNN nn.GRU in f32 (TF32 off) and in bf16 as the
                library yardsticks
  k4b         - K4's residuals and the GRU backward kernel (the tensor-core
                backward scan) against the plain backward and against
                autograd through the plain scan, same shapes (dxp atol
                1e-4, dW_hh and db_hh within 1e-3 of their max magnitude),
                for the picked design and every other (cluster or grid, 8
                or 16 rows per group, in waves where they do not fit),
                each timed; its bound at the f32 rate and at the tensor
                rate of its six bf16 passes; cuDNN nn.GRU fwd+bwd - fwd as
                the yardstick; then H=320 and H=1024 at B=32 and 128; and
                K4b in bf16 (k4b_bf16, amp training: h_prev the bf16 ys,
                dxp bf16, dhp f32), checked and timed as k2b_bf16 (dW_hh
                and db_hh within 1e-3 of their max magnitude)
  k5          - the beam-step location-attention kernel (one cluster of
                blocks per utterance) against its plain version at B=128
                and the slice's batch, K=8, T=176, d=300, F=10, ragged
                lengths; then an odd shape (B=3, K=5, T=37, d=96, F=3,
                vdim=80, rows of length 37, 1 and 0), a long one (T=700)
                and F=20, d=70, vdim=38 (align atol 1e-5, ctx atol 1e-4,
                a zero-length row uniform 1 / T); CUDA-event and device
                ms; at B=128 and 32 also every cluster size, checked the
                same way and timed, with the clusters of each resident at
                once
  k7          - the training attention step's forward and backward kernels
                against their plain versions, and the backward also
                against autograd through the plain forward, at B=128 and
                the slice's batch, T=176, d=300 (ctx / align atol 1e-4;
                dq / dtarg / dvals atol 1e-5; dv within 1e-4 of its max
                magnitude); then K7's bf16 variant (k7_bf16 lines, amp
                training) on the same inputs rounded to bf16 against its
                plain version (ctx / align within 1e-4 + 2^-7 of their max
                magnitude; bf16 dq / dtarg / dvals within 1 bf16 ulp +
                1e-5; dv within 2^-7 of its max magnitude), bound at bf16
                bytes. Both run as one cluster of blocks per utterance:
                each line holds the cluster sizes picked, the SMs one
                launch's blocks ran on, every cluster
                size checked the same way and timed with the clusters of
                each resident at once, a bit-identity check of every
                output (dv included) over two calls, and the device ms
                with L2 flushed before each call. Then k7_case lines in
                f32 and bf16: d=38, vdim=70 (the scalar variant), rows
                shorter than the cluster and a zero-length row, B=4 at
                T=900. The library's SASS must hold no MUFU.TANH
  k6        - the CTC prefix psi kernel against its plain version at
                B=128 and the slice's batch, K=8, T=176, V=5120 with bf16
                probs (ragged lengths, padded frames blank-only); at V=128
                with the last token on blank and on every block edge and an
                all-zero probs column (md - 87.4982, finite); and with f32
                probs at the slice's batch, V=5120; then bf16 at
                V=16384, at K=12, and at B=2, T=8000 (rtol / atol 2e-5 on
                finite entries, blank and last-token columns bit-equal);
                CUDA-event and device ms beside torch.bmm
  k8          - the fused beam-step tail kernel against its plain version
                on real beam states: the slice's model, LM, batch and
                config recorded at steps 0, 1, 40 and the last (B=32, K=8,
                V=31, T=176: one block per utterance), the same decode at
                V=5120 (a cluster of 16 blocks) at steps 1, 40 and the
                last, both also without the LM at step 40, at V=999 (4
                uneven slices) at steps 1 and 40, a batch of 128 at
                V=5120, step 1, V=16384 (16 slices of 1024 columns,
                config/synthetic/las_sub16k.yaml's width) at steps 1 and
                40, and beams of 16 and 4 at V=31 (16 also at V=5120)
                (winners equal on every slot, dead ones included, unless
                the plain scores are a near tie within 1e-5; scores and
                psi rtol / atol 1e-5; r rtol / atol 1e-4; max_abs_err over
                base, psi, finished scores and r); times at step 40 of
                V=31, V=5120 and V=16384 and at step 1 of the batch of
                128, and the
                device time of the kernel and of the plain tail per step
  lm_scan     - K2 (without and with residuals), K2b, K4 (without and
                with residuals) and K4b at the RNN-LM's shapes, one
                direction, H=512: B=64 at T=400 and T=592 and a ragged
                last batch, B=13 at T=112, against their plain versions at
                the k2 / k2b / k4 / k4b tolerances; CUDA-event and device
                ms beside the bounds (f32 rate, and the six bf16 passes at
                the tensor rate) and cuDNN nn.LSTM / nn.GRU
  lm_train    - LM training main path: the port's LM solver with
                config/libri/lm_example.yaml's model at full width (2 x
                LSTM-512, emb 512, dropout 0.2, Adam lr 1e-3) on B=64
                generated sentences of 96-400 characters, V=31: one step
                with the kernels against one with the plain versions at
                dropout 0 (loss rtol 1e-5, every gradient within rtol 1e-4
                / atol 1e-6), 5 timed steps (ms and tokens per second),
                one profiled step (host split, device busy and idle,
                launches, kernel_device_ms; taken again, up to 3 times,
                when its trace lost kernels); every step must launch K2
                twice and K2b twice and no other kernel
  lm_train_gru - the same with module GRU: K4 twice and K4b twice a step
  slice       - serving main path: bench.py's model at full width (VGG +
                3x BiLSTM-512, loc attention 300 / kernel 100, LSTM-512
                decoder and LM, beam 8, V=31, CTC 0.3 + LM 0.3, decode.amp
                pinned off, decode.fused_step false: the step tail is K8's
                eager plain version) with random weights from --seed: one
                timed decode batch with the kernels after a warm-up (it
                must launch K1 once and K2 six times, one launch per call
                unless a grid's groups run in waves, and no other kernel),
                one with the plain versions; then a breakdown of one batch
                (its device time from a trace of device activity only)
  slice_fused - the same with the default step tail, K8: it must launch
                exactly once per beam step of every batch; then best-score
                difference, top-1 share, launches, host split and device
                busy side by side with slice
  slice_att   - slice_fused with attention.use_pallas: K5 and K8 must each
                launch exactly once per beam step of every batch (the
                breakdowns give each kernel's device ms by name)
  slice_amp   - the slice with decode.amp left at auto, which must resolve
                to bf16 on the card: K2's bf16 variant six times per batch,
                K6 and K8 never (V=31 fails K6's gate, K8 is f32); top-1
                share and best-score difference against the same batch with
                amp off (K8 once per step)
  slice_sub5k - the same model and LM at V=5120 with amp and
                decode.psi_kernel: K6 exactly once per beam step; the same
                batch with psi_kernel off launches it never; then the batch
                in f32 with K8 (once per step) and with its plain version:
                best-score difference, host split and device busy side by
                side; breakdowns of the first and the two f32 runs
  slice_gru   - the slice with the GRU family (bench.py's model and LM
                with module GRU: 3x BiGRU-512 encoder, GRU-512 decoder and
                LM), amp pinned off: each batch must launch K1 once, K4
                six times (times scan_tc.launches) and K8 once per beam
                step, and no other kernel
  slice_gru_amp - the same with decode.amp at auto (bf16 on the card): K4's
                bf16 variant six times per batch; top-1 share and best-score
                difference against the same batch with amp off; no
                breakdown, cut to keep the script within its limit
  slice_plugin - the slice's batch and weights with the embedding plugin
                fused (a hash table of dim 256, fuse 0.3, temp 1.0) and
                the default step tail: K8 must never launch (its scope
                ends at plugin fusion); kernel route against plain route
  slice_fused_atk - slice_fused with decode.approx_topk 0.95: K8 once per
                beam step and tokens identical to slice_fused's
  slice_sub5k_cand - slice_sub5k with decode.ctc_candidates 128: K6 once
                per beam step (psi over the full vocab, then gathered)
  slice_sub5k_q8 - slice_sub5k with decode.psi_quant int8: K6 never (the
                int8 product replaces it), the early exit off
  slice_sub5k_win - slice_sub5k with decode.ctc_window 32 and psi_kernel
                off: K6 never
  slice_sub5k_f32_cand - slice_sub5k_f32 with ctc_candidates 128: K8 never
                (its scope is the full vocabulary)
                (each of these six: ms per batch, launches per step by
                kernel, best-score difference and top-1 share against the
                plain route and against the phase it extends; no breakdown,
                cut to keep the script within its limit)
  entry       - python -m end_to_end_asr_pytorch_tpu_torch.transcribe on
                two WAVs with a reference-layout checkpoint (amp off)
  entry_gru   - the same with slice_gru's model (a reference-layout nn.GRU
                checkpoint, bias_ih and bias_hh kept apart)
  entry_sub5k - the same with a generated 5120-piece sentencepiece model,
                a V=5120 checkpoint and decode.psi_kernel: true, amp auto
  test_entry  - python -m end_to_end_asr_pytorch_tpu_torch.main --test on a
                generated synthetic corpus (32 dev and 32 test utterances),
                the slice's model and LM as reference-layout checkpoints,
                LM fusion 0.3, CTC 0.3, beam 8, batch 32, amp off, with
                the default step tail (the summary lines must name the
                fused route and count K8 launches) and with fused_step
                false; one row per utterance in every CSV, hypotheses and
                best scores compared
  train       - training main path: the port's solver with bench.py's model
                at full width, Adadelta (lr 1, eps 1e-8, clip 5), joint
                0.5 CTC + 0.5 CE, teacher forcing 0.9, B waves of 7 s with
                U=96 labels: a warm-up step, 5 timed steps (each must
                launch K1 once, K2 and K2b once per encoder scan (in
                launches: times the waves of a grid that does not fit), K3
                once), one profiled step split by the step's own profiler
                ranges, then one step from the same weights and
                generator with the kernels and with the plain versions
                (at tf 1.0 loss rel 1e-4 and every gradient within 1e-3 of
                its max magnitude; at tf 0.9 reported)
  train_att   - the same with attention.use_pallas_train: each step must
                also launch the K7 forward and backward once per label
                step (96 each)
  train_gru   - the same with the GRU model: each step must launch K1 once,
                K4 (with residuals) and K4b once per encoder scan, K3 once,
                and no LSTM kernel
  train_amp   - train with hparas.amp: True (parameters rounded to bf16 and
                bf16 features in the step, f32 optimizer state): each step
                must launch K1
                once, K2's bf16 training variant and K2b's bf16 variant once
                per encoder scan, K3 once, and no f32 scan; the kernel vs
                plain step at tf 1.0 within loss rel 1e-3 and every
                gradient within 1e-2 of its max magnitude
  train_gru_amp - the same with the GRU model (K4's and K4b's bf16 variants)
  train_att_amp - train_amp with attention.use_pallas_train: each step must
                also launch K7's bf16 forward and backward once per label
                step (96 each) and the f32 K7 never
  train_aug   - train with data.audio.augment (SpecAugment, the JAX
                defaults written out): the same launches per step as
                train; every drawn mask within its bounds, the masked
                share of the valid bins; kernel vs plain as train
  train_plugin - train_att with the embedding plugin (a hash table of
                dim 256 for V=31, weight 1.0): K7 96 + 96 launches a step;
                kernel vs plain total loss and emb_loss within rel 1e-5
                (train_att, train_gru_amp, train_att_amp, train_aug and
                train_plugin take no profiled step, cut to keep the script
                within its limit)
  prefetch    - the input pipeline (parallel/mesh.py prefetch_to_device:
                a worker thread pins each batch and copies it on a side
                stream; main, main --lm and main --test take every batch
                through it, so the *_entry phases run it too) at train's
                shapes: (a) 16 loader batches of 32 int16 waves of 7 s, the
                compute stream held back before each is read: every
                prefetched tensor equal to the inline copy
                (torch.from_numpy(a).to(dev), labels int64); (b) the
                staging pinned, and a short trace (K1 and the encoder's K2
                on 3 prefetched batches) with the host-to-device copies on
                streams other than K1's and K2's; (d) an epoch of 50
                batches abandoned after 2: within 2 s the worker and the
                loader's pool threads are gone and the allocated device
                bytes are back where they were; (e) a source that raises
                after one batch, and a batch that cannot be staged, raise
                in the consumer (prefetch_check, prefetch_abandon lines);
                (c) in turns, 3 alternations of 10 train steps through the
                prefetcher and through inline copies, for train's model
                and lm_train's LM (B=64): ms per step, data.wait ms per
                step, and in the last alternation one profiled step each
                with the device idle share (prefetch_turns_asr,
                prefetch_turns_lm lines)
  dist_train  - data parallelism (parallel/mesh.py): a world-1 NCCL group
                in this process, 3 Solver.train_steps of train's batch
                against a solver with no group (deterministic cuDNN and
                PyTorch algorithms in both, which also makes two runs with
                no group equal): losses and parameters within rel 1e-6,
                train's launches a step, the all-reduce of the gradients'
                95 MB timed (CUDA events, device ms by kernel)
  dist_train_w2 - two ranks of 16 rows spawned on the one card in a gloo
                group (NCCL on two cards where there are two), encoder
                dropout 0.1 and SpecAugment: after 3 steps the ranks bit-
                identical to each other and to the same split computed in
                one process with no group; against world 1 loss rel 1e-5
                and parameters within 1e-3 of their max; each rank K1 1,
                K2 6, K3 1, K2b 6 a step; host ms per step and all-reduce
                ms
  dist_pad    - train's batch with 2 rows made zero-length, with
                attention.use_pallas_train (K1, K2, K2b, K3, K7 96 + 96):
                gradients finite and bit-identical whether those rows'
                samples are zero or random; against the 30 real rows loss
                rel 1e-5, gradients within 1e-3 of their max; a zero-
                length row decoded through K5 + K8 and through K6 (amp,
                V=5120): finite top-1, the other rows bit-identical
                whatever the dummy row holds
  dist_entry  - torchrun --standalone --nproc_per_node=1 of ... .main (2
                steps and a validation on a generated corpus: one
                log.jsonl) and of ... .main --test (random weights from
                --seed), beside the same --test without torchrun, the
                three at once: CSVs equal
  options_entry - on a generated corpus: the hash table from python -m
                end_to_end_asr_pytorch_tpu_torch.utils.bert_embedding
                --method hash, ... .main 2 steps with SpecAugment and the
                plugin, then ... .main --test with the plugin fused,
                decode.psi_quant int8 and ctc_candidates 8 (amp auto)
  native_text - the host runtime for text (utils/native.py): the FLAC
                decoder, the edit distance and the BPE encoder built from
                the package's own native/ sources (seconds each); WER and
                CER of 2,703 generated pairs of ~180 characters at ~10%
                CER (dev-clean's size) through the native batch against
                the plain two-row DP on a 10% sample (equal; ms per pair
                both ways, native_text_scoring); python -m
                end_to_end_asr_pytorch_tpu_torch.utils.generate_vocab on
                1,000 generated lines and a corpus's transcripts (a
                500-piece JSON BPE), then its ids on 28,539 generated
                transcripts (train-clean-100's count) native against
                encode_py (equal; ms per line, native_text_encoding); then
                ... .main --test in this process with that vocabulary on
                16 + 16 generated utterances (bench.py's model, random
                weights, beam 8, CTC 0.3, amp off): K1, K2 and K8
                launched, each split's WER and CER equal to the plain
                scorer's over its CSV rows (native_text_entry)
  train_entry - python -m end_to_end_asr_pytorch_tpu_torch.train on a
                generated synthetic corpus (32 train / 8 dev utterances,
                bench.py's model, 4 steps, validation every 2), then
                transcribe of two dev WAVs with its latest.pth, then a
                short run with --amp and attention.use_pallas_train (2
                steps through K7's bf16 variant, f32 weights in its
                latest.pth)
  flac_entry  - a generated corpus (32 train, dev and test utterances)
                converted to FLAC by tests/flac_encoder.py (a test
                helper): every decode equal to its WAV sample for sample,
                the loader's batches int16, then python -m
                end_to_end_asr_pytorch_tpu_torch.main (bench.py's model, 2
                steps) on the FLAC tree
  lm_entry    - ... .main --lm (lm_example.yaml's LM, 20 steps on the
                corpus's lm_text.txt): best_ppx.pth and latest.pth with a
                finite dev perplexity; then ... .main --test on the FLAC
                tree with test_entry's settings and decode.lm_path on that
                best_ppx.pth (the LibriSpeech recipe's chain)
  trained_entry - the experiment's chain on trained weights: python -m
                end_to_end_asr_pytorch_tpu_torch.data.make_synthetic (512
                / 64 / 64 utterances), then ... .main on
                config/synthetic/las.yaml pointed at that corpus with
                ckpt_format: orbax, until max_step 4000 or 50 s of
                training steps (a wrapper on Solver.train_step ends the
                loop, which then validates and saves): K1, K2, K2b, K3
                launched; every event file read back through
                utils/tensorboard.read_events (each CRC checked) with the
                loss, speed, tf_rate, wer, cer, hyp_i, ref_i and align_i
                tags, each align_i a PNG of its alignment's (T', U);
                best_att.pth/, best_ctc.pth/ and latest.pth/ complete
                orbax directories (trained_train: steps, dev CER / WER of
                both heads). Then main --test's Solver on best_att.pth/
                over the 64 test utterances (LM weight 0) through the
                default route (amp auto: K2-bf16), amp off with K8's tail,
                amp off with attention.use_pallas (K5 and K8), and the
                plain versions (USE_KERNELS = False) with amp auto and off:
                per route the CER, the share of rows with the top-1 of
                the plain route, the largest best-score gap (within 1e-2
                of its own plain route) and the differing rows, those
                above 1e-3 listed as not near ties (trained_test); one
                test batch of the default route under utils/profiler.trace
                with benchmark's ms and device_memory (trained_profile)
  jax_orbax_entry - a checkpoint the JAX package wrote with its own
                save_checkpoint(fmt="orbax") (OCDBT, zstd-compressed
                chunks): the committed fixture tests/fixtures/jax_orbax_las
                (config/synthetic/las.yaml's model at seed 0, made by
                tests/make_jax_orbax_fixture.py on the CPU), read by the
                port's own OCDBT and zstd decoders, then main --test's
                Solver with --load on it (amp off, attention.use_pallas,
                beam 4, CTC 0.3, no LM) on the fixture's three waves: K1,
                K2, K5 and K8 launched; encoder output, CTC log-probs and
                the beam's best score held within 1e-4 (absolute) to
                the JAX package's recorded outputs, the identical top-1
                rows counted, and the same for the plain versions
                (USE_KERNELS = False); read_orbax's seconds and
                utils/zstd.decompress's MB/s over the fixture's chunks
                (best of 5, compressed and decompressed bytes) beside the
                host's CPU name
  jax_resume_entry - training resumed across the two packages with the
                optimizer state (utils/optax_state.py). (a) The committed
                fixture tests/fixtures/jax_orbax_lm_resume (made by
                tests/make_jax_resume_fixture.py on the CPU: the JAX
                package's config/synthetic/lm.yaml LM, emb 64, one LSTM
                of 64, V=31, dropout 0, Adam lr 1e-3, after 3 steps, saved
                as OCDBT + zstd with its optax optimizer/): the port's LM
                Solver with --load on it takes the next 3 steps on the
                recorded batches through K2 and K2b; each loss within
                1e-4 (relative) of the JAX package's, every leaf's L2 norm
                after them within 1e-4, the count exactly 6; a control
                that starts the optimizer afresh must miss those bounds.
                (b) config/synthetic/las.yaml's ASR at its widths, 16
                waves of 7 s a batch, teacher forcing 1, deterministic
                algorithms: 3 steps, ckpt_format orbax writes optimizer/
                as the optax tree, a fresh Solver with --load on it takes
                2 more steps through K1, K2, K2b and K3, held to the same
                solver's 2 steps after the save (the 5 steps
                uninterrupted): losses and every parameter within 1e-5
                (relative; a parameter's max difference over its max
                magnitude), with the fresh-optimizer control's gaps beside
                (jax_resume_lm, jax_resume_asr lines)
  tp_train    - tensor parallelism (model_parallel: 2, parallel/tp.py):
                config/synthetic/las_sub16k.yaml's model at full width
                (V=16384) with attention.use_pallas_train, B=32 waves of 7 s,
                U=96, Adam lr 1e-3, teacher forcing 1: 3 steps of two ranks
                on the one card under gloo (--tp-layouts 1x2; 2x2 and the
                like take NCCL with a card a rank where there are enough)
                against world 1 in this process, deterministic algorithms
                in both: loss rel 1e-5, the gathered parameters within 1e-3
                of each tensor's max, the replicated leaves bit-identical
                across the ranks, each rank K1 1, K2 4, K2b 4, K3 1, K7 96 +
                96 a step; bytes held at world 1 and per rank, the step's
                peak, ms per step, and the model group's collectives' ms
                and bytes in one more step, run without deterministic
                algorithms as main runs: the replicated leaves must still
                be bit-identical across the ranks after it
  tp_lm_train - the same for lm_sub16k.yaml's LM (2 x LSTM-256, emb 256,
                dropout 0.1, V=16384), B=64 sentences of 20-80 tokens: each
                rank K2 2 and K2b 2 a step
  tp_test     - the Solver of main --test at model_parallel: 2 on generated
                dev and test splits of 8 utterances (las_sub16k's model with
                attention.use_pallas, lm_sub16k's LM fused 0.3, CTC 0.3,
                beam 8, amp off, a generated 16384-piece sentencepiece
                model) against world 1's CSVs: best scores within 1e-4, the
                identical top-1 rows counted, K5 and K8 (at V=16384) once
                per beam step on each rank; bytes, ms per batch (the dev
                split decoded again, warm), and the collectives' ms over
                the dev split decoded a third time
The entry-point phases (entry, entry_sub5k, entry_gru, dist_entry,
train_entry, options_entry, flac_entry / lm_entry) check what the entry
points write, not how long they take: they run four at a time after
dist_pad, before native_text, whose host timings want a quiet host.
Then a line with the per-kernel measurements ({"kernels": [...]}: K1 and K2
launches counted on the slice's run, K8 on slice_fused's (and its V=5120
row on slice_sub5k_f32's), K5 on
slice_att's, K2's bf16 variant
on slice_amp's, K6 on slice_sub5k's, K2b and K3 on the train run, K7 on
train_att's, K4 on slice_gru's, K4's bf16 variant on slice_gru_amp's, K4b
on train_gru's, the bf16 training variants of K2 and K2b on train_amp's and
of K4 and K4b on train_gru_amp's, K7's bf16 variant on train_att_amp's),
the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed phase
ends the run with a non-zero exit code. Needs CUDA: without it the script
fails before printing a result.
"""
import argparse
import ctypes
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
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
# the GRU family: the same model and LM with module GRU
GRU_MODEL_CFG = {**MODEL_CFG,
                 "encoder": {**MODEL_CFG["encoder"], "module": "GRU"},
                 "decoder": {**MODEL_CFG["decoder"], "module": "GRU"}}
GRU_LM_CFG = {**LM_CFG, "module": "GRU"}
AUDIO_CFG = {"feat_type": "fbank", "feat_dim": 40, "cmvn": True}
# the f32 slices pin amp off ("auto" is bf16 on the card); their step tail
# is K8 unless fused_step is false (the eager plain version, slice's)
DECODE_CFG = {"beam_size": 8, "min_len_ratio": 0.05, "max_len_ratio": 0.6,
              "ctc_weight": 0.3, "lm_weight": 0.3, "amp": False}
UNFUSED_CFG = {**DECODE_CFG, "fused_step": False}
CHARS = list("abcdefghijklmnopqrstuvwxyz'") + ["<space>"]   # V = 3 + 28 = 31
V_CHAR = 3 + len(CHARS)
V_SUB = 5120          # bench_vocab.py's subword workload
SECS = 7.0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s (no tensor
# cores), dense bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12


T_START = time.perf_counter()
CARD = None   # nvidia-smi's name and power limit, set by main


def emit(obj):
    """One JSON line, in one write (phases of run_at_once print from
    threads); a phase's line also gets the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def run_at_once(phases, workers=4):
    """Run ``phases`` (callables) in ``workers`` threads at once: the
    entry-point phases, which drive subprocesses and check what they
    write, not how long they take. A failed phase fails the run once all
    have ended."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futures = [ex.submit(fn) for fn in phases]
    for f in futures:
        f.result()


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


def device_ms(fn, iters=20, by_kernel=False):
    """Device time per call of ``fn``: the profiler's kernel times over
    ``iters`` calls (with ``by_kernel``, a dict by kernel name). Where the
    host enqueues a call more slowly than the card runs it, ``cuda_ms``
    times the host instead. A trace whose launch count is not a whole
    multiple of ``iters`` lost events: it is taken again (three tries);
    then each kernel's mean time per recorded launch is taken times its
    launches per call (recorded launches / iters, rounded, at least 1),
    which the lost events do not bias. None where no kernel was recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms, count = {}, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                k = e.key[:60]
                count[k] = count.get(k, 0) + e.count
                ms[k] = ms.get(k, 0.0) + getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        n = sum(count.values())
        if n and n % iters == 0:
            out = {k: v / iters for k, v in ms.items()}
            return out if by_kernel else sum(out.values())
    if not n:
        return None
    out = {k: ms[k] / count[k] * max(1, round(count[k] / iters)) for k in ms}
    return out if by_kernel else sum(out.values())


# the hand-written kernels' device function names (csrc/*.cu)
KERNEL_FUNCS = ("fbank_kernel", "fbank_split_kernel", "tc_scan_kernel", "tc_bwd_kernel",
                "ctc_kernel", "loc_att_kernel", "loc_att_fwd_kernel",
                "loc_att_bwd_kernel", "psi_kernel",
                "beam_step_kernel")


def kernel_device_ms(evts, dev):
    """Device ms and launches of each of this repository's kernels among
    profiler events ``evts`` (``dev(e)`` their device us), by function name
    (every instantiation of a template summed)."""
    import re
    out = {}
    for e in evts:
        m = re.search(r"\b(" + "|".join(KERNEL_FUNCS) + r")\b[<(]", e.key)
        if m:
            ms, n = out.get(m.group(1), (0.0, 0))
            out[m.group(1)] = (ms + dev(e) / 1e3, n + e.count)
    return {k: {"ms": ms, "launches": n} for k, (ms, n) in out.items()}


def bound(bytes_moved, flops, flops_rate=F32_FLOPS):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = flops / flops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bound(nbytes, prod, f32_ops):
    """A split scan's bound with its recurrent product ``prod`` (operations
    of one f32 product) as the six bf16 passes of the three-part split at
    the dense bf16 tensor rate, and ``f32_ops`` (epilogue, a GEMM outside
    the scan) at the f32 rate."""
    t_ops = (6 * prod / BF16_TC_FLOPS + f32_ops / F32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the tensor-core scans' designs: (scan_tc.CLUSTER = 0 or GRID = 1, rows)
SCAN_DESIGNS = ((0, 8), (0, 16), (1, 8), (1, 16))


def design_name(d):
    return f"{'cluster' if d[0] == 0 else 'grid'}_rows{d[1]}"


def scan_calls(batch, H=512):
    """Kernel launches per call of each tensor-core scan wrapper at the
    main path's width and ``batch``: one, or one per wave where a
    cooperative grid's groups do not all fit at once (scan_tc.launches)."""
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build, scan_tc
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import gru_kernel as gk
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel as lk
    ll = build.load("lstm_scan", lk._SIGNATURES)
    gl = build.load("gru_scan", gk._SIGNATURES)
    bwd = dict(planner=scan_tc.plan_bwd, grid_first=True)
    return {
        "lstm_scan_fused": scan_tc.launches(ll.lstm_tc_f32_max_groups, H, 4,
                                            batch),
        "lstm_scan_bf16": scan_tc.launches(ll.lstm_tc_max_groups, H, 4, batch),
        "gru_scan_fused": scan_tc.launches(gl.gru_tc_f32_max_groups, H, 3,
                                           batch),
        "gru_scan_bf16": scan_tc.launches(gl.gru_tc_max_groups, H, 3, batch),
        "lstm_bwd_fused": scan_tc.launches(ll.lstm_tc_bwd_max_groups, H, 4,
                                           batch, **bwd),
        "gru_bwd_fused": scan_tc.launches(gl.gru_tc_bwd_max_groups, H, 3,
                                          batch, **bwd),
        "lstm_train_bf16": scan_tc.launches(ll.lstm_tc_bf16_res_max_groups,
                                            H, 4, batch),
        "gru_train_bf16": scan_tc.launches(gl.gru_tc_bf16_res_max_groups, H,
                                           3, batch),
        "lstm_bwd_bf16": scan_tc.launches(ll.lstm_tc_bwd_bf16_max_groups, H,
                                          4, batch, **bwd),
        "gru_bwd_bf16": scan_tc.launches(gl.gru_tc_bwd_bf16_max_groups, H, 3,
                                         batch, **bwd)}


def bf16_diff(got, ref):
    """Two bf16 tensors: the largest absolute difference, the largest
    difference beyond 1e-5 in units of one bf16 ulp of the larger magnitude
    (<= 1 passes), and the share of elements that differ. 8 significant
    bits: 2^-7 of the larger magnitude is >= 1 ulp; near 0 the f32 values
    before rounding differ by the f32 kernel's own summation-order
    difference (~1e-6), so 1e-5 absolute is added to the ulp."""
    import torch
    d = (got.float() - ref.float()).abs()
    one_ulp = torch.maximum(got.float().abs(), ref.float().abs()) * 2.0 ** -7
    ulps = float(((d - 1e-5).clamp_min(0.0) / one_ulp.clamp_min(1e-30)).max())
    return float(d.max()), ulps, float((d > 0).float().mean())


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


def stft_mel(frontend, wave):
    """K1's library yardstick: ``torch.stft`` (center reflect pad) of the
    same frames with the Hann window, power, mel product and log."""
    import torch
    window = torch.hann_window(frontend.n_fft, device=wave.device)

    def library():
        spec = torch.stft(wave, frontend.n_fft, frontend.hop, window=window,
                          center=True, pad_mode="reflect", return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2
        return torch.log(power.transpose(1, 2) @ frontend.mel_fb + 1e-10)
    return library


def sass_count(name, op):
    """Lines of ``cuobjdump -sass`` of the built ``csrc/<name>.cu`` library
    that hold instruction ``op``; None where cuobjdump is missing."""
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(build._target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum(op in ln for ln in sass.splitlines())


def phase_k1(frontend, batch, seed):
    """K1 against its plain version at the slice's batch and at B=128 of
    7 s waves (log-mel atol 1e-3), timed beside ``torch.stft`` + mel; its
    bound at the f32 rate and, as the design runs it, with the DFT product
    as six bf16 passes at the tensor rate (bound_ms_tensor). The built
    library must hold HMMA instructions (the tensor cores)."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import fbank_kernel as fk
    hmma = sass_count("fbank", "HMMA")
    check(hmma is None or hmma > 0, "K1's SASS holds no HMMA")
    records = {}
    for B in dict.fromkeys((batch, 128)):
        w, _ = make_waves(B, seed + (B != batch))
        wave = torch.from_numpy(w).cuda()
        kw = dict(n_fft=frontend.n_fft, hop=frontend.hop, log_eps=1e-10)
        args = (wave, frontend.cosw, frontend.msinw, frontend.mel_fb)
        got = fk.fbank_fused(*args, **kw)
        ref = fk.fbank_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all()), "K1 output not finite")
        check(err <= 1e-3, f"K1 B={B} log-mel max abs err {err} > 1e-3")
        library = stft_mel(frontend, wave)
        lib_err = float((library() - ref).abs().max())
        S = wave.shape[1]
        T, n_mels = got.shape[1], got.shape[2]
        n_fft, n_bins = frontend.n_fft, frontend.n_bins
        nbytes = 4 * (B * S + 2 * n_fft * n_bins + n_bins * n_mels
                      + B * T * n_mels)
        prod = B * T * 4 * n_fft * n_bins
        rest = B * T * (3 * n_bins + 2 * n_bins * n_mels)
        b_ms, b_by = bound(nbytes, prod + rest)
        t_ms, t_by = tensor_bound(nbytes, prod, rest)
        fused = lambda: fk.fbank_fused(*args, **kw)
        res = {"name": "fbank_fused", "route": "cuda",
               "source": "end_to_end_asr_pytorch_tpu_torch/csrc/fbank.cu",
               "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/fbank_kernel.py:75",
               "max_abs_err": err,
               "ms": cuda_ms(fused, 20), "device_ms": device_ms(fused),
               "plain_ms": cuda_ms(lambda: fk.fbank_plain(*args, **kw), 20),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": cuda_ms(library, 20)}
        emit({"phase": "k1", "shape": [B, S], "frames": T,
              "library_max_abs_err_vs_plain": lib_err,
              "library_device_ms": device_ms(library),
              "device_ms_by_kernel": device_ms(fused, by_kernel=True),
              "bound_ms_tensor": t_ms, "bound_tensor_by": t_by,
              "sass_hmma_lines": hmma, **res})
        records[B] = res
    return records[batch]


def check_bf16_scan(label, rec, B, T, H, n_gates, scan, plain, run, query,
                    w_hh, nbytes, library):
    """K2-bf16 / K4-bf16 (``scan(w, reverse)``) against its plain version
    (``plain(w, reverse)``), both directions, with W_hh rounded to bf16 as
    decode amp hands it (the row's ms) and with the unrounded f32 W_hh
    (checked, and timed as ms_unrounded_w); ys within 1 bf16 ulp + 1e-5.
    The bound takes the dense bf16 tensor rate for the three passes of the
    main path (rounded W_hh); bound_ms_one_pass is the same for one bf16
    pass, the TPU kernel's own product. Then each design of the
    tensor-core scan (``run(w, mode, rows, reverse)`` -> (ys, launches),
    launches not counted: clusters or a grid of 8 or 16 rows, in waves
    where its groups do not fit at once: clusters in one launch, a grid in
    one launch per wave) is checked in both directions as above, with the
    rounded W_hh, and timed beside the one ``scan_tc.pick`` takes."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import scan_tc
    rounded = w_hh.to(torch.bfloat16).float()
    stats, refs = {}, {}
    for wname, w in (("rounded", rounded), ("unrounded", w_hh)):
        err = ulps = differ = 0.0
        for reverse in (False, True):
            got = scan(w, reverse)
            ref = plain(w, reverse)
            if wname == "rounded":
                refs[reverse] = ref
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all()),
                  f"{label} output not bf16 and finite")
            e, u, dif = bf16_diff(got, ref)
            err, ulps, differ = max(err, e), max(ulps, u), max(differ, dif)
        check(ulps <= 1.0, f"{label} ys beyond 1 bf16 ulp (+1e-5) of the "
              f"plain version with {wname} W_hh ({ulps} of the bound) at B={B}")
        stats[wname] = {"max_abs_err": err, "max_err_over_bf16_ulp_bound": ulps,
                        "share_of_ys_differing": differ,
                        "ms": cuda_ms(lambda: scan(w, True), 10)}
    one_pass = T * 2 * B * H * n_gates * H
    b_ms, b_by = bound(nbytes, 3 * one_pass, BF16_TC_FLOPS)
    b1_ms, _ = bound(nbytes, one_pass, BF16_TC_FLOPS)
    mode, rows = scan_tc.pick(query, H, n_gates, B)
    designs = {}
    for m, r in ((scan_tc.CLUSTER, 8), (scan_tc.CLUSTER, 16),
                 (scan_tc.GRID, 8), (scan_tc.GRID, 16)):
        name = f"{'cluster' if m == scan_tc.CLUSTER else 'grid'}_rows{r}"
        ulps = 0.0
        for reverse in (False, True):
            got, launches = run(rounded, m, r, reverse)
            torch.cuda.synchronize()
            ulps = max(ulps, bf16_diff(got, refs[reverse])[1])
        check(ulps <= 1.0, f"{label} design {name} ys beyond 1 bf16 ulp "
              f"(+1e-5) of the plain version ({ulps} of the bound) at B={B}")
        designs[name] = {"ms": cuda_ms(lambda: run(rounded, m, r, True), 10),
                         "max_err_over_bf16_ulp_bound": ulps,
                         "waves": math.ceil(math.ceil(B / r) / max(
                             1, scan_tc.max_groups(query, H, n_gates, r, m))),
                         "launches": launches}
    rec = {**rec, "max_abs_err": max(v["max_abs_err"] for v in stats.values()),
           "ms": stats["rounded"]["ms"],
           "ms_unrounded_w": stats["unrounded"]["ms"],
           "plain_ms": cuda_ms(lambda: plain(rounded, True), 3),
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_rate": "bf16 tensor cores, 989 TFLOP/s, 3 passes",
           "bound_ms_one_pass": b1_ms,
           "library_ms": cuda_ms(library, 10)}
    emit({"phase": label, "T": T, "B": B, "H": H,
          "design": {"mode": "cluster" if mode == scan_tc.CLUSTER else "grid",
                     "rows": rows},
          "design_ms": designs, "rounded_w": stats["rounded"],
          "unrounded_w": stats["unrounded"], **rec})
    return rec


def check_bf16_widths(label, n_gates, scan, plain, query, rng,
                      extra=lambda H: (), T=176, widths=(300, 320, 1024),
                      batches=(32, 128)):
    """K2-bf16 / K4-bf16 at widths off the main path, against the plain
    version as ``check_bf16_scan`` holds them (both directions, ragged
    masks, rounded and unrounded W_hh, 1 bf16 ulp + 1e-5): H=320 (units per
    block not a multiple of 8 for the LSTM, 8-byte copies), H=300 (H and the
    GRU's gate columns zero-padded to 16, a cluster of 15 blocks) and
    H=1024 (64 blocks: a cooperative grid only, in waves at B=128).
    ``scan`` / ``plain`` are the wrappers, called as (x_proj, w_hh,
    *extra(H), mask, reverse) (the GRU's b_hh); ``query`` is the library's
    ``*_tc_max_groups``."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import scan_tc
    out = {}
    for H in widths:
        s = 1.0 / math.sqrt(H)
        w_hh = torch.from_numpy(rng.uniform(
            -s, s, (H, n_gates * H)).astype(np.float32)).cuda()
        C, U, kw, kg = scan_tc.plan(H, n_gates)
        ex = extra(H)
        for B in batches:
            xb = torch.from_numpy(rng.randn(T, B, n_gates * H).astype(
                np.float32)).cuda().to(torch.bfloat16)
            lens = rng.randint(T // 2, T + 1, size=B)
            lens[0] = T
            mask = torch.from_numpy(np.arange(T)[:, None] < lens[None, :]).cuda()
            res = {"C": C, "U": U, "kw": kw, "kg": kg}
            for wname, w in (("rounded", w_hh.to(torch.bfloat16).float()),
                             ("unrounded", w_hh)):
                ulps = 0.0
                for reverse in (False, True):
                    got = scan(xb, w, *ex, mask, reverse)
                    ref = plain(xb, w, *ex, mask, reverse)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(got).all()),
                          f"{label} output not finite at H={H}, B={B}")
                    ulps = max(ulps, bf16_diff(got, ref)[1])
                check(ulps <= 1.0, f"{label} ys beyond 1 bf16 ulp (+1e-5) of "
                      f"the plain version with {wname} W_hh ({ulps} of the "
                      f"bound) at H={H}, B={B}")
                res[f"{wname}_max_err_over_bf16_ulp_bound"] = ulps
                res[f"{wname}_ms"] = cuda_ms(
                    lambda: scan(xb, w, *ex, mask, True), 5)
            mode, rows = scan_tc.pick(query, H, n_gates, B)
            res["design"] = {"mode": "cluster" if mode == scan_tc.CLUSTER
                             else "grid", "rows": rows}
            out[f"H{H}_B{B}"] = res
    emit({"phase": f"{label}_widths", "T": T, "widths": out})


def bf16_train_bound(nbytes, passes_ops, f32_ops):
    """The bound of a bf16 training scan: ``passes_ops`` (the recurrent
    product's three bf16 passes, and a GEMM of bf16 operands) at the dense
    bf16 tensor rate, ``f32_ops`` (the epilogue) at the f32 rate, or its
    bytes at the HBM rate."""
    t_ops = (passes_ops / BF16_TC_FLOPS + f32_ops / F32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_bf16_train(label, rec, B, T, fused, tc, plain, designs, timed,
                     counter, ulp_outs, rel_outs=()):
    """A bf16 training variant (the forward with residuals, or the backward)
    against its plain version on the same inputs, both directions:
    ``fused(rev)`` through the wrapper (the picked design, counted by
    ``counter``, which this restores), ``tc(rev, mode, rows) -> (outs,
    launches)`` for each of ``designs`` (not counted) and ``plain(rev)``,
    each a tuple of outputs. The outputs at ``ulp_outs`` (bf16: ys and the
    residuals, or dxp) must be within 1 bf16 ulp + 1e-5 of the plain
    version's, those at ``rel_outs`` (dW_hh, db_hh) within 1e-3 of their
    max magnitude. ``timed`` designs are timed with CUDA events."""
    import torch
    ulps = err = rel = 0.0
    launches = {}
    n0 = counter.launches
    for reverse in (False, True):
        ref = plain(reverse)
        for design in (None, *designs):
            if design is None:
                got = fused(reverse)
            else:
                got, launches[design] = tc(reverse, *design)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t.float()).all()) for t in got),
                  f"{label} output not finite (design {design})")
            for i in ulp_outs:
                check(got[i].dtype == torch.bfloat16,
                      f"{label} output {i} is {got[i].dtype}, not bf16")
                e, u, _ = bf16_diff(got[i], ref[i])
                err, ulps = max(err, e), max(ulps, u)
            for i in rel_outs:
                rel = max(rel, float((got[i] - ref[i]).abs().max()
                                     / ref[i].abs().max()))
    counter.launches = n0
    check(ulps <= 1.0, f"{label} beyond 1 bf16 ulp (+1e-5) of the plain "
          f"version ({ulps} of the bound) at B={B}")
    check(rel <= 1e-3, f"{label} dW_hh / db_hh {rel} of max > 1e-3 at B={B}")
    design_ms = {design_name(d): {
        "ms": cuda_ms(lambda: tc(True, *d), 10), "launches": launches[d]}
        for d in designs if d in timed}
    rec = {**rec, "max_abs_err": err,
           "ms": cuda_ms(lambda: fused(True), 10),
           "plain_ms": cuda_ms(lambda: plain(True), 2)}
    counter.launches = n0
    return rec, {"max_err_over_bf16_ulp_bound": ulps,
                 "dw_err_over_max": rel if rel_outs else None,
                 "design_ms": design_ms,
                 "designs_checked": [design_name(d) for d in designs]}


def amp_designs(query, H, n_gates, B, planner=None):
    """The designs of a bf16 training scan whose blocks fit the card (every
    design ``pick`` can take); at B=128 only the picked one is timed."""
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import scan_tc
    kw = {} if planner is None else dict(planner=planner, grid_first=True)
    resident = lambda d: scan_tc.max_groups(query, H, n_gates, d[1], d[0],
                                            planner or scan_tc.plan)
    designs = [d for d in SCAN_DESIGNS if resident(d) >= 1]
    picked = scan_tc.pick(query, H, n_gates, B, **kw)
    return designs, (designs if B <= 32 else [picked]), picked


def scan_case(rng, B, T, H, n_gates):
    """x_proj (T, B, n_gates H), an upstream gradient (T, B, H) and a
    ragged mask (the first row full)."""
    import torch
    xp = torch.from_numpy(rng.randn(T, B, n_gates * H).astype(
        np.float32)).cuda()
    dys = torch.from_numpy(rng.randn(T, B, H).astype(np.float32)).cuda()
    lens = rng.randint(T // 2, T + 1, size=B)
    lens[0] = T
    mask = torch.from_numpy(np.arange(T)[:, None] < lens[None, :]).cuda()
    return xp, dys, mask


def lstm_weights(rng, H):
    import torch
    s = 1.0 / math.sqrt(H)
    return torch.from_numpy(rng.uniform(-s, s, (H, 4 * H)).astype(
        np.float32)).cuda()


def cudnn_lstm(w_hh):
    """cuDNN's nn.LSTM computing K2's function at full length: identity
    input weights and no biases make its gates x_proj + h @ W_hh (it also
    runs a (T*B, 4H) x (4H, 4H) input product that the kernel does not)."""
    import torch
    H = w_hh.shape[0]
    lstm = torch.nn.LSTM(4 * H, H).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H, device="cuda"))
        lstm.weight_hh_l0.copy_(w_hh.T)
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()
    return lstm


def check_f32_scan(label, fused, tc, plain, fwd_plain, designs,
                   directions=(False, True)):
    """An f32 tensor-core scan (K2 or K4; its W_hh unrounded, so the
    remainder passes run) against its plain version, in ``directions``
    (reversed or not; default both),
    without residuals (ys) and with them, all atol 1e-4: through the
    wrapper ``fused(reverse, residuals)`` (the picked design) and ``tc(
    reverse, residuals, mode, rows) -> (out, launches)`` for each of
    ``designs`` (launches not counted); ``plain(reverse)`` gives ys,
    ``fwd_plain(reverse)`` ys and the residuals. Returns the worst ys and
    residual errors and each design's launches."""
    import torch
    err = res_err = 0.0
    launches = {}
    for reverse in directions:
        ref, pres = plain(reverse), fwd_plain(reverse)
        for design in (None, *designs):
            for residuals in (False, True):
                if design is None:
                    got = fused(reverse, residuals)
                else:
                    got, n = tc(reverse, residuals, *design)
                    launches[design, residuals] = n
                torch.cuda.synchronize()
                outs = got if residuals else (got,)
                check(all(bool(torch.isfinite(t).all()) for t in outs),
                      f"{label} output not finite (design {design})")
                if residuals:
                    res_err = max(res_err, *(float((a - b).abs().max())
                                             for a, b in zip(got, pres)))
                else:
                    err = max(err, float((got - ref).abs().max()))
    return err, res_err, launches


def check_k2(lk, w_hh, xp, mask, designs, directions=(False, True)):
    """K2 in f32 against its plain version (``check_f32_scan``): ys, cs and
    gates."""
    return check_f32_scan(
        "K2", lambda rev, res: lk.lstm_scan_fused(xp, w_hh, mask, rev,
                                                  residuals=res),
        lambda rev, res, m, r: lk.lstm_fwd_tc(xp, w_hh, mask, rev, res, m, r),
        lambda rev: lk.lstm_scan_plain(xp, w_hh, mask, rev),
        lambda rev: lk.lstm_scan_fwd_plain(xp, w_hh, mask, rev), designs,
        directions)


def k2_bytes(B, T, H, residuals):
    """K2's bytes: reads x_proj, W_hh and the mask, writes ys (and with
    residuals cs and gates)."""
    return 4 * (T * B * 4 * H + H * 4 * H + T * B + T * B * H
                + (T * B * 5 * H if residuals else 0))


def phase_k2(seed, slice_batch, T=176, H=512):
    """K2 (f32, the tensor-core scan; with and without residuals) and its
    bf16 variant against their plain versions, both directions, ragged
    masks, at B=128 and at the slice's batch (the shape the main path
    gives them; those records are the kernels' lines), every design of the
    f32 route checked and timed; then the f32 route at H=320 and 1024."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build, scan_tc
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel as lk
    rng = np.random.RandomState(seed + 1)
    w_hh = lstm_weights(rng, H)
    cudnn = cudnn_lstm(w_hh)
    lib = build.load("lstm_scan", lk._SIGNATURES)
    query = lib.lstm_tc_f32_max_groups
    records, bf16_records, train_records = {}, {}, {}
    for B in (128, slice_batch):
        xp, _, mask = scan_case(rng, B, T, H, 4)
        designs = [d for d in SCAN_DESIGNS
                   if scan_tc.max_groups(query, H, 4, d[1], d[0]) >= 1]
        err, res_err, launches = check_k2(lk, w_hh, xp, mask, designs)
        check(err <= 1e-4, f"K2 max abs err {err} > 1e-4 at B={B}")
        check(res_err <= 1e-4, f"K2 residuals max abs err {res_err} at B={B}")

        def library():
            with torch.no_grad():
                return cudnn(xp)[0]

        full = torch.ones_like(mask)
        lib_err = float((library() - lk.lstm_scan_fused(xp, w_hh, full)).abs().max())
        prod = T * 2 * B * H * 4 * H
        b_ms, b_by = bound(k2_bytes(B, T, H, False), prod)
        bt_ms, bt_by = tensor_bound(k2_bytes(B, T, H, False), prod,
                                    T * 30 * B * H)
        mode, rows = scan_tc.pick(query, H, 4, B)
        design_ms = {design_name(d): {
            "ms": cuda_ms(lambda: lk.lstm_fwd_tc(xp, w_hh, mask, True, False,
                                                 *d), 10),
            "ms_residuals": cuda_ms(lambda: lk.lstm_fwd_tc(
                xp, w_hh, mask, True, True, *d), 10),
            "launches": launches[d, False],
            "groups_resident": scan_tc.max_groups(query, H, 4, d[1], d[0])}
            for d in designs}
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
              "plan": dict(zip(("C", "U", "kw", "kg"), scan_tc.plan(H, 4))),
              "design": design_name((mode, rows)), "design_ms": design_ms,
              "residual_max_abs_err": res_err,
              "ms_residuals": cuda_ms(lambda: lk.lstm_scan_fused(
                  xp, w_hh, mask, True, residuals=True), 10),
              "bound_ms_tensor": bt_ms, "bound_by_tensor": bt_by,
              "bound_rate_tensor": "recurrent product: 6 bf16 passes at 989 "
                                   "TFLOP/s; epilogue at the f32 rate",
              "bound_ms_residuals": bound(k2_bytes(B, T, H, True), prod)[0],
              "cudnn_full_length_max_abs_err": lib_err, **records[B]})
        # K2-bf16 (decode amp): bf16 x_proj and ys, f32 carries
        xb = xp.to(torch.bfloat16)
        cudnn_bf16 = cudnn_lstm(w_hh).to(torch.bfloat16)
        cudnn_bf16.flatten_parameters()

        def library_bf16():
            with torch.no_grad():
                return cudnn_bf16(xb)[0]

        bf16_records[B] = check_bf16_scan(
            "k2_bf16", {
                "name": "lstm_scan_bf16", "route": "cuda",
                "source": "end_to_end_asr_pytorch_tpu_torch/csrc/lstm_scan.cu",
                "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py:92"},
            B, T, H, 4,
            lambda w, rev: lk.lstm_scan_bf16(xb, w, mask, rev),
            lambda w, rev: lk.lstm_scan_plain(xb, w, mask, rev),
            lambda w, m, r, rev: scan_tc.run(
                lib.lstm_tc_launch, lib.lstm_tc_max_groups, xb, w, (), mask,
                rev, 4, m, r),
            lib.lstm_tc_max_groups, w_hh,
            2 * T * B * 4 * H + 4 * H * 4 * H + 4 * T * B + 2 * T * B * H,
            library_bf16)
        # K2 with residuals in bf16 (amp training): W_hh holds bf16 values
        wr = w_hh.to(torch.bfloat16).float()
        designs, timed, picked = amp_designs(lib.lstm_tc_bf16_res_max_groups,
                                             H, 4, B)
        xr = xb.clone().requires_grad_(True)
        prod = T * 2 * B * H * 4 * H
        b_ms, b_by = bf16_train_bound(
            2 * T * B * 4 * H + 4 * (H * 4 * H + T * B)
            + 2 * T * B * (H + H + 4 * H), 3 * prod, T * 30 * B * H)
        rec, info = check_bf16_train(
            "k2_bf16_train", {
                "name": "lstm_train_bf16", "route": "cuda",
                "source": "end_to_end_asr_pytorch_tpu_torch/csrc/lstm_scan.cu",
                "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py:92"},
            B, T, lambda rev: lk.lstm_train_bf16(xb, wr, mask, rev),
            lambda rev, m, r: lk.lstm_fwd_tc(xb, wr, mask, rev, True, m, r),
            lambda rev: lk.lstm_scan_fwd_plain(xb, wr, mask, rev),
            designs, timed, lk.lstm_train_bf16, (0, 1, 2))
        train_records[B] = {**rec, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": cuda_ms(
                                lambda: cudnn_bf16(xr)[0], 10)}
        emit({"phase": "k2_bf16_train", "T": T, "B": B, "H": H,
              "design": design_name(picked),
              "w_hh_has_bf16_remainder": scan_tc.has_bf16_remainder(wr),
              "bound_rate": "bf16 tensor cores, 989 TFLOP/s, 3 passes; "
                            "epilogue at the f32 rate",
              "library": "cuDNN nn.LSTM in bf16, training forward",
              **info, **train_records[B]})
    check_bf16_widths("k2_bf16", 4, lk.lstm_scan_bf16, lk.lstm_scan_plain,
                      lib.lstm_tc_max_groups, rng)
    widths = {}
    for Hw in (318, 320, 1024):
        w2 = lstm_weights(rng, Hw)
        for B in (32, 128):
            xp, _, mask = scan_case(rng, B, T, Hw, 4)
            err, res_err, _ = check_k2(lk, w2, xp, mask, [])
            check(err <= 1e-4 and res_err <= 1e-4,
                  f"K2 errors {err} / {res_err} at H={Hw}, B={B}")
            before = lk.lstm_scan_fused.launches
            lk.lstm_scan_fused(xp, w2, mask, True)
            widths[f"H{Hw}_B{B}"] = {
                "max_abs_err": err, "residual_max_abs_err": res_err,
                "launches": lk.lstm_scan_fused.launches - before,
                "plan": scan_tc.plan(scan_tc.padded(Hw), 4),
                "design": design_name(scan_tc.pick(
                    query, scan_tc.padded(Hw), 4, B)),
                "ms": cuda_ms(lambda: lk.lstm_scan_fused(xp, w2, mask, True), 5),
                "ms_residuals": cuda_ms(lambda: lk.lstm_scan_fused(
                    xp, w2, mask, True, residuals=True), 5)}
    emit({"phase": "k2_widths", "T": T, "widths": widths})
    return (records[slice_batch], bf16_records[slice_batch],
            train_records[slice_batch])


def phase_scan_floor(T=176, H=512):
    """The floor of the bf16 scans' step exchange: T rounds of nothing but
    the barrier and the exchange of h (csrc/scan_floor.cu), for design (a),
    one cooperative grid with grid.sync() and h through L2, with U=32 and
    U=16 units per block (16 and 32 blocks per group), and design (b), one
    cluster of 16 blocks per group with barrier.cluster and h through
    distributed shared memory; at B=32 in four groups of 8 rows and in two
    of 16. Threads per block as K2-bf16's
    at that U."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import scan_tc
    out = {}
    for label, mode, C, threads in (
            ("grid_U32", scan_tc.GRID, 16, 512),
            ("grid_U16", scan_tc.GRID, 32, 256),
            ("cluster16", scan_tc.CLUSTER, 16, 512)):
        for rows, groups in ((8, 4), (16, 2)):
            ms = cuda_ms(lambda: scan_tc.floor_launch(T, H, C, rows, groups,
                                                      threads, mode), 20)
            out[f"{label}_rows{rows}x{groups}"] = {
                "ms": ms, "us_per_round": ms * 1e3 / T}
    torch.cuda.synchronize()
    emit({"phase": "scan_floor", "T": T, "H": H, "floors": out})


def phase_mma_floor(iters=4000):
    """The ceiling of mma.sync m16n8k16 in bf16 (csrc/mma_floor.cu): one
    block per SM of 4, 8 and 16 warps, each issuing 28 independent products
    per round on register operands, against the dense bf16 tensor peak."""
    import ctypes
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build
    lib = build.load("mma_floor", {"mma_floor_launch": (
        ctypes.c_int, [ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.empty(sms * 32 * 16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for warps in (4, 8, 16):
        run = lambda: build.check(lib.mma_floor_launch(
            sink.data_ptr(), sms, warps, iters, stream), "mma_floor launch")
        ms = cuda_ms(run, 5)
        n = sms * warps * iters * 28
        out[f"warps{warps}"] = {"ms": ms, "tflops": n * 4096 / ms / 1e9,
                                "share_of_dense_peak":
                                    n * 4096 / ms / 1e-3 / BF16_TC_FLOPS}
    emit({"phase": "mma_floor", "sms": sms, "iters": iters, "floors": out})


def k2b_bound(B, T, H):
    """K2b's bound (reads gates, cs, ys, dys, mask, W_hh; writes dxp and
    dW_hh), at the f32 rate for the recurrent product and the dW_hh GEMM
    (2 T B H 4H operations each), and with the recurrent product at the
    dense bf16 tensor rate for the six split passes the kernel runs (the
    GEMM stays f32, TF32 off)."""
    nbytes = 4 * (T * B * (4 * H + 3 * H + 4 * H) + T * B + 2 * H * 4 * H)
    prod = T * 2 * B * 4 * H * H
    return (bound(nbytes, 2 * prod + T * 20 * B * H),
            tensor_bound(nbytes, prod, prod + T * 20 * B * H))


def check_k2b(lk, w_hh, xp, dys, mask, designs, directions=(False, True)):
    """K2's residuals against the plain forward, and K2b against the plain
    backward and against autograd through the plain scan, in ``directions``
    (default both):
    residuals and dxp atol 1e-4, dW_hh within 1e-3 of its max magnitude;
    for the picked design and each of ``designs`` ((mode, rows) forced,
    launches not counted). Returns the worst errors and each design's
    launches."""
    import torch
    errs = {"residuals": 0.0, "dxp": 0.0, "dw": 0.0, "ag_dxp": 0.0,
            "ag_dw": 0.0}
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    launches = {}
    for reverse in directions:
        ys, cs, gates = lk.lstm_scan_fused(xp, w_hh, mask, reverse,
                                           residuals=True)
        ref = pys, pcs, pgates = lk.lstm_scan_fwd_plain(xp, w_hh, mask,
                                                        reverse)
        pdxp, pdw = lk.lstm_scan_bwd_plain(pgates, pcs, pys, mask, w_hh, dys,
                                           reverse)
        x, w = (t.clone().requires_grad_(True) for t in (xp, w_hh))
        lk.lstm_scan_plain(x, w, mask, reverse).backward(dys)
        errs["residuals"] = max(errs["residuals"], *(
            float((a - b).abs().max()) for a, b in zip((ys, cs, gates), ref)))
        for design in (None, *designs):
            if design is None:
                dxp, dw = lk.lstm_bwd_fused(gates, cs, ys, mask, w_hh, dys,
                                            reverse)
            else:
                dxp, n = lk.lstm_bwd_tc(gates, cs, mask, w_hh, dys, reverse,
                                        *design)
                dw = lk.dw_hh(ys, dxp, reverse)
                launches[design] = n
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t).all()) for t in (dxp, dw)),
                  f"K2b output not finite (design {design})")
            for tag, (rx, rw) in (("", (pdxp, pdw)), ("ag_", (x.grad, w.grad))):
                errs[tag + "dxp"] = max(errs[tag + "dxp"],
                                        float((dxp - rx).abs().max()))
                errs[tag + "dw"] = max(errs[tag + "dw"], rel(dw, rw))
    return errs, launches


def k2b_ok(errs):
    return (errs["residuals"] <= 1e-4 and errs["dxp"] <= 1e-4
            and errs["ag_dxp"] <= 1e-4 and errs["dw"] <= 1e-3
            and errs["ag_dw"] <= 1e-3)


def phase_k2b(seed, slice_batch, T=176, H=512):
    """K2's residual outputs and K2b (the tensor-core backward scan)
    against their plain versions, K2b also against autograd through the
    plain scan, both directions, ragged masks, at B=128 and at the slice's
    batch, for the design the wrapper picks and every design whose blocks
    fit (cluster or grid, 8 or 16 rows per group, in waves where the groups
    do not fit at once), each timed; then H=320 and H=1024 (a grid of 64
    blocks) off the main path. cuDNN nn.LSTM fwd+bwd - fwd as the
    yardstick."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build, scan_tc
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel as lk
    rng = np.random.RandomState(seed + 4)
    w_hh = lstm_weights(rng, H)
    cudnn = cudnn_lstm(w_hh)
    lib = build.load("lstm_scan", lk._SIGNATURES)
    query = lib.lstm_tc_bwd_max_groups
    resident = lambda d, Hw: scan_tc.max_groups(query, Hw, 4, d[1], d[0],
                                                scan_tc.plan_bwd)
    records, bf16_records = {}, {}
    for B in (128, slice_batch):
        xp, dys, mask = scan_case(rng, B, T, H, 4)
        designs = [d for d in SCAN_DESIGNS if resident(d, H) >= 1]
        errs, launches = check_k2b(lk, w_hh, xp, dys, mask, designs)
        check(k2b_ok(errs), f"K2 residuals / K2b errors {errs} at B={B}")
        ys, cs, gates = lk.lstm_scan_fused(xp, w_hh, mask, True, residuals=True)
        xl = xp.clone().requires_grad_(True)

        def lib_fwd():
            return cudnn(xl)[0]

        def lib_fwd_bwd():
            cudnn(xl)[0].backward(dys)

        lib_fwd_ms = cuda_ms(lib_fwd, 10)
        lib_ms = cuda_ms(lib_fwd_bwd, 10) - lib_fwd_ms
        (b_ms, b_by), (bt_ms, bt_by) = k2b_bound(B, T, H)
        mode, rows = scan_tc.pick(query, H, 4, B, scan_tc.plan_bwd,
                                  grid_first=True)
        design_ms = {design_name(d): {
            "ms": cuda_ms(lambda: lk.lstm_bwd_tc(gates, cs, mask, w_hh, dys,
                                                 True, *d), 10),
            "launches": launches[d], "groups_resident": resident(d, H)}
            for d in designs}
        records[B] = {
            "name": "lstm_bwd_fused", "route": "cuda",
            "source": "end_to_end_asr_pytorch_tpu_torch/csrc/lstm_scan.cu",
            "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py:185",
            "max_abs_err": errs["dxp"],
            "ms": cuda_ms(lambda: lk.lstm_bwd_fused(gates, cs, ys, mask, w_hh,
                                                    dys, True), 10),
            "plain_ms": cuda_ms(lambda: lk.lstm_scan_bwd_plain(
                gates, cs, ys, mask, w_hh, dys, True), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        emit({"phase": "k2b", "T": T, "B": B, "H": H,
              "plan": dict(zip(("C", "U", "kw", "kg"), scan_tc.plan_bwd(H, 4))),
              "design": design_name((mode, rows)), "design_ms": design_ms,
              "designs_not_fitting": [design_name(d) for d in SCAN_DESIGNS
                                      if d not in designs],
              "kernel_ms": cuda_ms(lambda: lk.lstm_bwd_tc(
                  gates, cs, mask, w_hh, dys, True), 10),
              "bound_ms_tensor": bt_ms, "bound_by_tensor": bt_by,
              "bound_rate_tensor": "recurrent product: 6 bf16 passes at 989 "
                                   "TFLOP/s; dW_hh GEMM at the f32 rate",
              "residual_max_abs_err": errs["residuals"],
              "dw_err_over_max": errs["dw"],
              "autograd_dxp_max_abs_err": errs["ag_dxp"],
              "autograd_dw_err_over_max": errs["ag_dw"],
              "library_fwd_ms": lib_fwd_ms, **records[B]})
        # K2b in bf16 (amp training) on the bf16 residuals of the plain
        # forward, W_hh holding bf16 values
        wr = w_hh.to(torch.bfloat16).float()
        xb, db = xp.to(torch.bfloat16), dys.to(torch.bfloat16)
        designs, timed, picked = amp_designs(lib.lstm_tc_bwd_bf16_max_groups,
                                             H, 4, B, scan_tc.plan_bwd)
        res = {rev: lk.lstm_scan_fwd_plain(xb, wr, mask, rev)
               for rev in (False, True)}

        def tc_bf16(rev, m, r):
            ys_, cs_, g_ = res[rev]
            dxp, n = lk.lstm_bwd_tc(g_, cs_, mask, wr, db, rev, m, r)
            return (dxp, lk.dw_hh(ys_, dxp, rev)), n

        cudnn_bf16 = cudnn_lstm(w_hh).to(torch.bfloat16)
        cudnn_bf16.flatten_parameters()
        xr = xb.clone().requires_grad_(True)
        lib_fwd_bf16 = cuda_ms(lambda: cudnn_bf16(xr)[0], 10)
        lib_bf16 = cuda_ms(lambda: cudnn_bf16(xr)[0].backward(db), 10) \
            - lib_fwd_bf16
        prod = T * 2 * B * 4 * H * H
        b_ms, b_by = bf16_train_bound(
            2 * T * B * (4 * H + 3 * H + 4 * H) + 4 * (T * B + 2 * H * 4 * H),
            4 * prod, T * 20 * B * H)
        rec, info = check_bf16_train(
            "k2b_bf16", {
                "name": "lstm_bwd_bf16", "route": "cuda",
                "source": "end_to_end_asr_pytorch_tpu_torch/csrc/lstm_scan.cu",
                "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py:185"},
            B, T, lambda rev: lk.lstm_bwd_bf16(res[rev][2], res[rev][1],
                                               res[rev][0], mask, wr, db, rev),
            tc_bf16,
            lambda rev: lk.lstm_scan_bwd_plain(res[rev][2], res[rev][1],
                                               res[rev][0], mask, wr, db, rev),
            designs, timed, lk.lstm_bwd_bf16, (0,), (1,))
        bf16_records[B] = {**rec, "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": lib_bf16}
        emit({"phase": "k2b_bf16", "T": T, "B": B, "H": H,
              "design": design_name(picked),
              "designs_not_fitting": [design_name(d) for d in SCAN_DESIGNS
                                      if d not in designs],
              "w_hh_has_bf16_remainder": scan_tc.has_bf16_remainder(wr),
              "bound_rate": "bf16 tensor cores, 989 TFLOP/s: 3 passes of "
                            "the recurrent product and the dW_hh GEMM; "
                            "epilogue at the f32 rate",
              "library": "cuDNN nn.LSTM in bf16, fwd+bwd - fwd",
              "library_fwd_ms": lib_fwd_bf16, **info, **bf16_records[B]})
    widths = {}
    for Hw in (320, 1024):
        w2 = lstm_weights(rng, Hw)
        for B in (32, 128):
            xp, dys, mask = scan_case(rng, B, T, Hw, 4)
            errs, _ = check_k2b(lk, w2, xp, dys, mask, [])
            check(k2b_ok(errs), f"K2b errors {errs} at H={Hw}, B={B}")
            ys, cs, gates = lk.lstm_scan_fused(xp, w2, mask, True,
                                               residuals=True)
            before = lk.lstm_bwd_fused.launches
            lk.lstm_bwd_fused(gates, cs, ys, mask, w2, dys, True)
            widths[f"H{Hw}_B{B}"] = {
                **errs, "launches": lk.lstm_bwd_fused.launches - before,
                "plan": scan_tc.plan_bwd(Hw, 4),
                "design": design_name(scan_tc.pick(
                    query, Hw, 4, B, scan_tc.plan_bwd, grid_first=True)),
                "ms": cuda_ms(lambda: lk.lstm_bwd_fused(
                    gates, cs, ys, mask, w2, dys, True), 5)}
    emit({"phase": "k2b_widths", "T": T, "widths": widths})
    return records[slice_batch], bf16_records[slice_batch]


def cudnn_gru(w_hh, b_hh):
    """cuDNN's nn.GRU computing K4's function: identity input weights and
    no input bias make its gates x_proj + h W_hh + b_hh, with r under the
    n third of the hidden product as in K4 (it also runs a (T*B, 3H) x
    (3H, 3H) input product that the kernel does not)."""
    import torch
    H = w_hh.shape[0]
    gru = torch.nn.GRU(3 * H, H).cuda()
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(3 * H, device="cuda"))
        gru.weight_hh_l0.copy_(w_hh.T)
        gru.bias_ih_l0.zero_()
        gru.bias_hh_l0.copy_(b_hh)
    gru.flatten_parameters()
    return gru


def gru_weights(rng, H):
    import torch
    s = 1.0 / math.sqrt(H)
    t = lambda *shape: torch.from_numpy(
        rng.uniform(-s, s, shape).astype(np.float32)).cuda()
    return t(H, 3 * H), t(3 * H)


def check_k4(gk, w_hh, b_hh, xp, mask, designs, directions=(False, True)):
    """K4 in f32 against its plain version (``check_f32_scan``): ys, gates
    and hp_n."""
    return check_f32_scan(
        "K4", lambda rev, res: gk.gru_scan_fused(xp, w_hh, b_hh, mask, rev,
                                                 residuals=res),
        lambda rev, res, m, r: gk.gru_fwd_tc(xp, w_hh, b_hh, mask, rev, res,
                                             m, r),
        lambda rev: gk.gru_scan_plain(xp, w_hh, b_hh, mask, rev),
        lambda rev: gk.gru_scan_fwd_plain(xp, w_hh, b_hh, mask, rev), designs,
        directions)


def k4_bytes(B, T, H, residuals):
    """K4's bytes: reads x_proj, W_hh, b_hh and the mask, writes ys (and
    with residuals gates and hp_n)."""
    return 4 * (T * B * 3 * H + H * 3 * H + 3 * H + T * B + T * B * H
                + (T * B * 4 * H if residuals else 0))


def phase_k4(seed, slice_batch, T=176, H=512):
    """K4 (f32, the tensor-core scan; with and without residuals) and its
    bf16 variant against their plain versions, both directions, ragged
    masks, at B=128 and at the slice's batch (those records are the
    kernels' lines), every design of the f32 route checked and timed;
    cuDNN nn.GRU in f32 (TF32 off, as resolve_device sets it) and in bf16
    as yardsticks; then the f32 route at H=320 and 1024 (k4_widths)."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build, scan_tc
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import gru_kernel as gk
    rng = np.random.RandomState(seed + 10)
    w_hh, b_hh = gru_weights(rng, H)
    cudnn = cudnn_gru(w_hh, b_hh)
    cudnn_bf16 = cudnn_gru(w_hh, b_hh).to(torch.bfloat16)
    cudnn_bf16.flatten_parameters()
    lib = build.load("gru_scan", gk._SIGNATURES)
    query = lib.gru_tc_f32_max_groups
    records, bf16_records, train_records = {}, {}, {}
    for B in (128, slice_batch):
        xp, _, mask = scan_case(rng, B, T, H, 3)
        designs = [d for d in SCAN_DESIGNS
                   if scan_tc.max_groups(query, H, 3, d[1], d[0]) >= 1]
        err, res_err, launches = check_k4(gk, w_hh, b_hh, xp, mask, designs)
        check(err <= 1e-4, f"K4 max abs err {err} > 1e-4 at B={B}")
        check(res_err <= 1e-4, f"K4 residuals max abs err {res_err} at B={B}")

        def library():
            with torch.no_grad():
                return cudnn(xp)[0]

        full = torch.ones_like(mask)
        lib_err = float((library() - gk.gru_scan_fused(xp, w_hh, b_hh, full)
                         ).abs().max())
        prod = T * 2 * B * H * 3 * H
        b_ms, b_by = bound(k4_bytes(B, T, H, False), prod)
        bt_ms, bt_by = tensor_bound(k4_bytes(B, T, H, False), prod,
                                    T * 20 * B * H)
        mode, rows = scan_tc.pick(query, H, 3, B)
        design_ms = {design_name(d): {
            "ms": cuda_ms(lambda: gk.gru_fwd_tc(xp, w_hh, b_hh, mask, True,
                                                False, *d), 10),
            "ms_residuals": cuda_ms(lambda: gk.gru_fwd_tc(
                xp, w_hh, b_hh, mask, True, True, *d), 10),
            "launches": launches[d, False],
            "groups_resident": scan_tc.max_groups(query, H, 3, d[1], d[0])}
            for d in designs}
        records[B] = {
            "name": "gru_scan_fused", "route": "cuda",
            "source": "end_to_end_asr_pytorch_tpu_torch/csrc/gru_scan.cu",
            "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/gru_kernel.py:109",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: gk.gru_scan_fused(xp, w_hh, b_hh, mask,
                                                    True), 10),
            "plain_ms": cuda_ms(lambda: gk.gru_scan_plain(xp, w_hh, b_hh,
                                                          mask, True), 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(library, 10)}
        emit({"phase": "k4", "T": T, "B": B, "H": H,
              "plan": dict(zip(("C", "U", "kw", "kg"), scan_tc.plan(H, 3))),
              "design": design_name((mode, rows)), "design_ms": design_ms,
              "residual_max_abs_err": res_err,
              "ms_residuals": cuda_ms(lambda: gk.gru_scan_fused(
                  xp, w_hh, b_hh, mask, True, residuals=True), 10),
              "bound_ms_tensor": bt_ms, "bound_by_tensor": bt_by,
              "bound_rate_tensor": "recurrent product: 6 bf16 passes at 989 "
                                   "TFLOP/s; epilogue at the f32 rate",
              "bound_ms_residuals": bound(k4_bytes(B, T, H, True), prod)[0],
              "cudnn_tf32": torch.backends.cudnn.allow_tf32,
              "cudnn_full_length_max_abs_err": lib_err, **records[B]})
        # K4-bf16 (decode amp): bf16 x_proj and ys, f32 carry
        xb = xp.to(torch.bfloat16)

        def library_bf16():
            with torch.no_grad():
                return cudnn_bf16(xb)[0]

        bf16_records[B] = check_bf16_scan(
            "k4_bf16", {
                "name": "gru_scan_bf16", "route": "cuda",
                "source": "end_to_end_asr_pytorch_tpu_torch/csrc/gru_scan.cu",
                "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/gru_kernel.py:109"},
            B, T, H, 3,
            lambda w, rev: gk.gru_scan_bf16(xb, w, b_hh, mask, rev),
            lambda w, rev: gk.gru_scan_plain(xb, w, b_hh, mask, rev),
            lambda w, m, r, rev: scan_tc.run(
                lib.gru_tc_launch, lib.gru_tc_max_groups, xb, w, (b_hh,), mask,
                rev, 3, m, r),
            lib.gru_tc_max_groups, w_hh,
            2 * T * B * 3 * H + 4 * (H * 3 * H + 3 * H + T * B) + 2 * T * B * H,
            library_bf16)
        # K4 with residuals in bf16 (amp training): W_hh and b_hh hold bf16
        # values
        wr, br = (t.to(torch.bfloat16).float() for t in (w_hh, b_hh))
        designs, timed, picked = amp_designs(lib.gru_tc_bf16_res_max_groups,
                                             H, 3, B)
        xr = xb.clone().requires_grad_(True)
        prod = T * 2 * B * H * 3 * H
        b_ms, b_by = bf16_train_bound(
            2 * T * B * 3 * H + 4 * (H * 3 * H + 3 * H + T * B)
            + 2 * T * B * (H + 3 * H + H), 3 * prod, T * 20 * B * H)
        rec, info = check_bf16_train(
            "k4_bf16_train", {
                "name": "gru_train_bf16", "route": "cuda",
                "source": "end_to_end_asr_pytorch_tpu_torch/csrc/gru_scan.cu",
                "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/gru_kernel.py:109"},
            B, T, lambda rev: gk.gru_train_bf16(xb, wr, br, mask, rev),
            lambda rev, m, r: gk.gru_fwd_tc(xb, wr, br, mask, rev, True, m, r),
            lambda rev: gk.gru_scan_fwd_plain(xb, wr, br, mask, rev),
            designs, timed, gk.gru_train_bf16, (0, 1, 2))
        train_records[B] = {**rec, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": cuda_ms(
                                lambda: cudnn_bf16(xr)[0], 10)}
        emit({"phase": "k4_bf16_train", "T": T, "B": B, "H": H,
              "design": design_name(picked),
              "w_hh_has_bf16_remainder": scan_tc.has_bf16_remainder(wr),
              "bound_rate": "bf16 tensor cores, 989 TFLOP/s, 3 passes; "
                            "epilogue at the f32 rate",
              "library": "cuDNN nn.GRU in bf16, training forward",
              **info, **train_records[B]})

    check_bf16_widths(
        "k4_bf16", 3, gk.gru_scan_bf16, gk.gru_scan_plain,
        lib.gru_tc_max_groups, rng,
        lambda H: (torch.from_numpy(rng.uniform(-0.1, 0.1, 3 * H).astype(
            np.float32)).cuda(),))
    widths = {}
    for Hw in (318, 320, 1024):
        w2, b2 = gru_weights(rng, Hw)
        for B in (32, 128):
            xp, _, mask = scan_case(rng, B, T, Hw, 3)
            err, res_err, _ = check_k4(gk, w2, b2, xp, mask, [])
            check(err <= 1e-4 and res_err <= 1e-4,
                  f"K4 errors {err} / {res_err} at H={Hw}, B={B}")
            before = gk.gru_scan_fused.launches
            gk.gru_scan_fused(xp, w2, b2, mask, True)
            widths[f"H{Hw}_B{B}"] = {
                "max_abs_err": err, "residual_max_abs_err": res_err,
                "launches": gk.gru_scan_fused.launches - before,
                "plan": scan_tc.plan(scan_tc.padded(Hw), 3),
                "design": design_name(scan_tc.pick(
                    query, scan_tc.padded(Hw), 3, B)),
                "ms": cuda_ms(lambda: gk.gru_scan_fused(xp, w2, b2, mask,
                                                        True), 5),
                "ms_residuals": cuda_ms(lambda: gk.gru_scan_fused(
                    xp, w2, b2, mask, True, residuals=True), 5)}
    emit({"phase": "k4_widths", "T": T, "widths": widths})
    return (records[slice_batch], bf16_records[slice_batch],
            train_records[slice_batch])


def k4b_bound(B, T, H):
    """K4b's bound (reads gates, hp_n, ys, dys, mask, W_hh; writes dxp,
    dW_hh, db_hh), at the f32 rate for the recurrent product and the dW_hh
    GEMM (2 T B H 3H operations each), and with the recurrent product at
    the dense bf16 tensor rate for the six split passes the kernel runs
    (the GEMM stays f32, TF32 off)."""
    nbytes = 4 * (T * B * (3 * H + 3 * H + 3 * H) + T * B + 2 * H * 3 * H
                  + 3 * H)
    prod = T * 2 * B * 3 * H * H
    return (bound(nbytes, 2 * prod + T * 20 * B * H),
            tensor_bound(nbytes, prod, prod + T * 20 * B * H))


def check_k4b(gk, w_hh, b_hh, xp, dys, mask, designs,
              directions=(False, True)):
    """K4b against the plain backward and against autograd through the
    plain scan, in ``directions`` (default both): dxp atol 1e-4, dW_hh and db_hh within 1e-3
    of their max magnitude; for the picked design and each of ``designs``
    ((mode, rows) forced, launches not counted). Returns the worst errors
    and each design's launches."""
    import torch
    errs = {"dxp": 0.0, "dw": 0.0, "db": 0.0, "ag_dxp": 0.0, "ag_dw": 0.0,
            "ag_db": 0.0}
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    launches = {}
    for reverse in directions:
        ys, gates, hp_n = gk.gru_scan_fused(xp, w_hh, b_hh, mask, reverse,
                                            residuals=True)
        pys, pg, ph = gk.gru_scan_fwd_plain(xp, w_hh, b_hh, mask, reverse)
        pdxp, pdw, pdb = gk.gru_scan_bwd_plain(pg, ph, pys, mask, w_hh, dys,
                                               reverse)
        x, w, b = (t.clone().requires_grad_(True) for t in (xp, w_hh, b_hh))
        gk.gru_scan_plain(x, w, b, mask, reverse).backward(dys)
        for design in (None, *designs):
            if design is None:
                dxp, dw, db = gk.gru_bwd_fused(gates, hp_n, ys, mask, w_hh,
                                               dys, reverse)
            else:
                dxp, dhp, n = gk.gru_bwd_tc(gates, hp_n, ys, mask, w_hh, dys,
                                            reverse, *design)
                dw, db = gk.dw_db(ys, dhp, reverse)
                launches[design] = n
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t).all()) for t in (dxp, dw, db)),
                  f"K4b output not finite (design {design})")
            for tag, (rx, rw, rb) in (("", (pdxp, pdw, pdb)),
                                      ("ag_", (x.grad, w.grad, b.grad))):
                errs[tag + "dxp"] = max(errs[tag + "dxp"],
                                        float((dxp - rx).abs().max()))
                errs[tag + "dw"] = max(errs[tag + "dw"], rel(dw, rw))
                errs[tag + "db"] = max(errs[tag + "db"], rel(db, rb))
    return errs, launches


def phase_k4b(seed, slice_batch, T=176, H=512):
    """K4's residuals and K4b (the tensor-core backward scan) against the
    plain backward and against autograd through the plain scan, both
    directions, ragged masks, at B=128 and at the slice's batch, for the
    design the wrapper picks and for every design (cluster or grid, 8 or
    16 rows per group, in waves where the groups do not fit at once),
    each timed; then H=320 and H=1024 (a grid of 64 blocks) off the main
    path. cuDNN nn.GRU fwd+bwd - fwd as the yardstick."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build, scan_tc
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import gru_kernel as gk
    rng = np.random.RandomState(seed + 11)
    w_hh, b_hh = gru_weights(rng, H)
    cudnn = cudnn_gru(w_hh, b_hh)
    lib = build.load("gru_scan", gk._SIGNATURES)
    query = lib.gru_tc_bwd_max_groups

    def fits(d, B, Hw):
        """Whether a design's blocks fit the card at all (a cluster may
        run in waves; a grid wave needs one group resident)."""
        return scan_tc.max_groups(query, Hw, 3, d[1], d[0],
                                  scan_tc.plan_bwd) >= 1

    records, bf16_records = {}, {}
    for B in (128, slice_batch):
        xp, dys, mask = scan_case(rng, B, T, H, 3)
        designs = [d for d in SCAN_DESIGNS if fits(d, B, H)]
        errs, launches = check_k4b(gk, w_hh, b_hh, xp, dys, mask, designs)
        check(errs["dxp"] <= 1e-4 and errs["ag_dxp"] <= 1e-4,
              f"K4b dxp max abs err {errs} at B={B}")
        check(max(errs["dw"], errs["db"], errs["ag_dw"], errs["ag_db"]) <= 1e-3,
              f"K4b dW_hh / db_hh err over max magnitude {errs} at B={B}")
        ys, gates, hp_n = gk.gru_scan_fused(xp, w_hh, b_hh, mask, True,
                                            residuals=True)
        xl = xp.clone().requires_grad_(True)

        def lib_fwd():
            return cudnn(xl)[0]

        def lib_fwd_bwd():
            cudnn(xl)[0].backward(dys)

        lib_fwd_ms = cuda_ms(lib_fwd, 10)
        lib_ms = cuda_ms(lib_fwd_bwd, 10) - lib_fwd_ms
        (b_ms, b_by), (bt_ms, bt_by) = k4b_bound(B, T, H)
        mode, rows = scan_tc.pick(query, H, 3, B, scan_tc.plan_bwd,
                                  grid_first=True)
        design_ms = {design_name(d): {
            "ms": cuda_ms(lambda: gk.gru_bwd_tc(gates, hp_n, ys, mask, w_hh,
                                                dys, True, *d), 10),
            "launches": launches[d],
            "groups_resident": scan_tc.max_groups(query, H, 3, d[1], d[0],
                                                  scan_tc.plan_bwd)}
            for d in designs}
        records[B] = {
            "name": "gru_bwd_fused", "route": "cuda",
            "source": "end_to_end_asr_pytorch_tpu_torch/csrc/gru_scan.cu",
            "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/gru_kernel.py:149",
            "max_abs_err": errs["dxp"],
            "ms": cuda_ms(lambda: gk.gru_bwd_fused(gates, hp_n, ys, mask, w_hh,
                                                   dys, True), 10),
            "plain_ms": cuda_ms(lambda: gk.gru_scan_bwd_plain(
                gates, hp_n, ys, mask, w_hh, dys, True), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        emit({"phase": "k4b", "T": T, "B": B, "H": H,
              "plan": dict(zip(("C", "U", "kw", "kg"), scan_tc.plan_bwd(H, 3))),
              "design": design_name((mode, rows)), "design_ms": design_ms,
              "kernel_ms": cuda_ms(lambda: gk.gru_bwd_tc(
                  gates, hp_n, ys, mask, w_hh, dys, True), 10),
              "bound_ms_tensor": bt_ms, "bound_by_tensor": bt_by,
              "bound_rate_tensor": "recurrent product: 6 bf16 passes at 989 "
                                   "TFLOP/s; dW_hh GEMM at the f32 rate",
              "dw_err_over_max": errs["dw"], "db_err_over_max": errs["db"],
              "autograd_dxp_max_abs_err": errs["ag_dxp"],
              "autograd_dw_err_over_max": errs["ag_dw"],
              "autograd_db_err_over_max": errs["ag_db"],
              "library_fwd_ms": lib_fwd_ms, **records[B]})
        # K4b in bf16 (amp training) on the bf16 residuals of the plain
        # forward, W_hh and b_hh holding bf16 values
        wr, br = (t.to(torch.bfloat16).float() for t in (w_hh, b_hh))
        xb, db = xp.to(torch.bfloat16), dys.to(torch.bfloat16)
        designs, timed, picked = amp_designs(lib.gru_tc_bwd_bf16_max_groups,
                                             H, 3, B, scan_tc.plan_bwd)
        res = {rev: gk.gru_scan_fwd_plain(xb, wr, br, mask, rev)
               for rev in (False, True)}

        def tc_bf16(rev, m, r):
            ys_, g_, hpn_ = res[rev]
            dxp, dhp, n = gk.gru_bwd_tc(g_, hpn_, ys_, mask, wr, db, rev, m, r)
            return (dxp, *gk.dw_db(ys_, dhp, rev)), n

        cudnn_bf16 = cudnn_gru(w_hh, b_hh).to(torch.bfloat16)
        cudnn_bf16.flatten_parameters()
        xr = xb.clone().requires_grad_(True)
        lib_fwd_bf16 = cuda_ms(lambda: cudnn_bf16(xr)[0], 10)
        lib_bf16 = cuda_ms(lambda: cudnn_bf16(xr)[0].backward(db), 10) \
            - lib_fwd_bf16
        prod = T * 2 * B * 3 * H * H
        b_ms, b_by = bf16_train_bound(
            2 * T * B * (3 * H + 3 * H + 3 * H) + 4 * (T * B + 2 * H * 3 * H
                                                      + 3 * H),
            4 * prod, T * 20 * B * H)
        rec, info = check_bf16_train(
            "k4b_bf16", {
                "name": "gru_bwd_bf16", "route": "cuda",
                "source": "end_to_end_asr_pytorch_tpu_torch/csrc/gru_scan.cu",
                "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/gru_kernel.py:149"},
            B, T, lambda rev: gk.gru_bwd_bf16(res[rev][1], res[rev][2],
                                              res[rev][0], mask, wr, db, rev),
            tc_bf16,
            lambda rev: gk.gru_scan_bwd_plain(res[rev][1], res[rev][2],
                                              res[rev][0], mask, wr, db, rev),
            designs, timed, gk.gru_bwd_bf16, (0,), (1, 2))
        bf16_records[B] = {**rec, "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": lib_bf16}
        emit({"phase": "k4b_bf16", "T": T, "B": B, "H": H,
              "design": design_name(picked),
              "designs_not_fitting": [design_name(d) for d in SCAN_DESIGNS
                                      if d not in designs],
              "w_hh_has_bf16_remainder": scan_tc.has_bf16_remainder(wr),
              "bound_rate": "bf16 tensor cores, 989 TFLOP/s: 3 passes of "
                            "the recurrent product and the dW_hh GEMM; "
                            "epilogue at the f32 rate",
              "library": "cuDNN nn.GRU in bf16, fwd+bwd - fwd",
              "library_fwd_ms": lib_fwd_bf16, **info, **bf16_records[B]})
    widths = {}
    for Hw in (320, 1024):
        w2, b2 = gru_weights(rng, Hw)
        for B in (32, 128):
            xp, dys, mask = scan_case(rng, B, T, Hw, 3)
            errs, _ = check_k4b(gk, w2, b2, xp, dys, mask, [])
            check(errs["dxp"] <= 1e-4 and errs["ag_dxp"] <= 1e-4 and max(
                errs["dw"], errs["db"], errs["ag_dw"], errs["ag_db"]) <= 1e-3,
                f"K4b errors {errs} at H={Hw}, B={B}")
            ys, gates, hp_n = gk.gru_scan_fused(xp, w2, b2, mask, True,
                                                residuals=True)
            before = gk.gru_bwd_fused.launches
            gk.gru_bwd_fused(gates, hp_n, ys, mask, w2, dys, True)
            widths[f"H{Hw}_B{B}"] = {
                **errs, "launches": gk.gru_bwd_fused.launches - before,
                "plan": scan_tc.plan_bwd(Hw, 3),
                "design": design_name(scan_tc.pick(query, Hw, 3, B, scan_tc.plan_bwd,
                                             grid_first=True)),
                "ms": cuda_ms(lambda: gk.gru_bwd_fused(
                    gates, hp_n, ys, mask, w2, dys, True), 5)}
    emit({"phase": "k4b_widths", "T": T, "widths": widths})
    return records[slice_batch], bf16_records[slice_batch]


def ctc_case(B, seed, T=176, U=96, V=31):
    """Log-probs (B, T, V) and int32 labels in [3, V) and lengths for K3:
    ragged logit and label lengths, repeated labels, and one infeasible row
    (the last)."""
    import torch
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(B, T, V).astype(np.float32) * 2.0)
    lp = torch.log_softmax(logits, dim=-1)
    labels = rng.randint(3, V, size=(B, U)).astype(np.int32)
    labels[:, 1::7] = labels[:, 0:-1:7]          # repeats: s -> s+2 skip off
    lab_len = rng.randint(U // 2, U + 1, size=B).astype(np.int32)
    lab_len[0] = U
    logit_len = rng.randint(3 * T // 4, T + 1, size=B).astype(np.int32)
    logit_len[0] = T
    logit_len[-1] = lab_len[-1] // 2                 # no feasible alignment
    for b in range(B):
        labels[b, lab_len[b]:] = 0
    return lp, torch.from_numpy(logit_len), torch.from_numpy(labels), \
        torch.from_numpy(lab_len)


# K3's shapes: (label, B, T, U); V=31. "long": an average LibriSpeech
# utterance (~12 s: T=307 encoder frames after the VGG's 4x, ~200
# characters); "very_long": ~35 s of speech with 600 characters (S=1201);
# "chunked": S=2201, wider than one group, so the kernel walks it in chunks
K3_SHAPES = (("B128", 128, 176, 96), ("slice", None, 176, 96),
             ("long", 32, 307, 200), ("very_long", 8, 875, 600),
             ("chunked", 4, 1400, 1100))


def k3_bytes(lp, ll, lab, lab_len, Sp, in_smem):
    """K3's bytes at these inputs: ``need``, what the function must move
    (each 32-byte sector of log-probs a live state's emission lies in, over
    the frames the walks read; the live labels, the lengths, the (B, T, S)
    gradient, the NLL and the extended labels written), and ``moved``,
    what the kernel moves besides: its gradient rows are Sp wide, the beta
    history is written to and read back from the gradient buffer, and the
    alpha history goes to device memory too where it does not fit in shared
    memory."""
    import torch
    B, T, V = lp.shape
    U = lab.shape[1]
    S = 2 * U + 1
    rows = torch.clamp(ll.long(), 1, T)                       # frames walked
    ext = torch.zeros((B, S), dtype=torch.long, device=lp.device)
    ext[:, 1::2] = lab.long()
    live = torch.arange(S, device=lp.device)[None] < (2 * lab_len.long() + 1)[:, None]
    t = torch.arange(T, device=lp.device)
    elem = ((torch.arange(B, device=lp.device)[:, None, None] * T
             + t[None, :, None]) * V + ext[:, None, :])          # (B, T, S)
    ok = live[:, None, :] & (t[None, :, None] < rows[:, None, None])
    sectors = int(torch.unique((elem * 4 // 32)[ok]).numel())
    idx = lab.element_size()
    need = (32 * sectors + idx * int(lab_len.long().clamp(0, U).sum())
            + 2 * idx * B + 4 * B * T * S + 4 * B + 8 * B * S)
    hist = 4 * Sp * int(rows.sum())                 # one history's rows
    moved = need + 4 * B * T * (Sp - S) + 2 * hist + (0 if in_smem else 2 * hist)
    return need, moved


def phase_k3(seed, slice_batch):
    """K3 against its plain version at B=128 and the slice's batch (T=176,
    U=96), and at "long" (B=32, T=307, U=200) and "very_long" (B=8, T=875,
    U=600), V=31, int32 labels and lengths, ragged lengths, repeated labels,
    one infeasible row (NLL rtol 1e-5, gradient atol 1e-5; exactly zero
    gradient on the infeasible row and at frames at or past each length;
    every output bit-identical over two calls), for the picked design and
    every other one (R states a thread, NW warps a group); CUDA-event and
    device ms, the plain version's and F.ctc_loss forward + backward's (the
    library yardstick); the bound (bytes the function must move, or its
    operations) beside the bytes the kernel moves and the chain floor, the
    shape's frames less one times one step's latency (shuffles, one lse3,
    and across warps the exchange and the group's barrier: ctc_floor_kernel).
    Then the card route's launches: ``CTCLoss.forward`` must launch K3
    alone, against ``prepare``'s launches on the parent's route."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from end_to_end_asr_pytorch_tpu_torch.ops import ctc
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import ctc_kernel as ck
    lib = build.load("ctc_loss", ck._SIGNATURES)
    regs = {}
    for R in ck.STATES:
        out = ctypes.c_int(0)
        build.check(lib.ctc_regs(R, ctypes.byref(out)), "ctc_regs")
        regs[R] = out.value
    floor = {nw: ck.chain_floor_ms(20000, nw) for nw in ck.WARPS}
    mismatches = ck.math_mismatches()
    emit({"phase": "k3_floor", "us_per_step": {nw: 1e3 * v for nw, v in
                                               floor.items()},
          "registers": regs, "exp_log_mismatches": mismatches})
    check(mismatches == (0, 0), f"K3's written-out expf / logf differ from "
          f"the library's on {mismatches} inputs")
    records = {}
    for label, B, T, U in K3_SHAPES:
        B = B or slice_batch
        lp, ll, lab, lab_len = (x.cuda() for x in ctc_case(B, seed + 5, T, U))
        S = 2 * U + 1
        Sp = ck.padded(S)
        nll, grad, ext = ck.ctc_loss_fused(lp, ll, lab, lab_len)
        pnll, pgrad, pext = ck.ctc_loss_plain(lp, ll, lab, lab_len)
        torch.cuda.synchronize()
        check(torch.equal(ext, pext), f"K3 extended labels differ at {label}")
        frame = torch.arange(T, device=lp.device)[None, :, None]
        past = frame >= ll.long()[:, None, None]

        def checked(n, g, what):
            feas = pnll < 1e29
            check(not bool(feas[-1]) and torch.equal(n < 1e29, feas),
                  f"K3 infeasible rows not reported as such ({what})")
            check(bool(torch.isfinite(g).all())
                  and bool((g[~feas] == 0).all()),
                  f"K3 gradient not finite, or non-zero on an infeasible "
                  f"row ({what})")
            check(bool((g.masked_fill(~past, 0) == 0).all()),
                  f"K3 gradient non-zero at frames past a length ({what})")
            rel = float(((n - pnll).abs() / pnll.abs())[feas].max())
            err = float((g - pgrad).abs().max())
            check(rel <= 1e-5, f"K3 NLL max rel err {rel} ({what})")
            check(err <= 1e-5, f"K3 gradient max abs err {err} ({what})")
            return rel, err

        nll_rel, g_err = checked(nll, grad, f"{label}, picked")
        n2, g2, _ = ck.ctc_loss_fused(lp, ll, lab, lab_len)
        check(torch.equal(n2, nll) and torch.equal(g2, grad),
              f"K3 outputs differ between two calls at {label}")
        exact = {"nll": int((nll != pnll).sum()),
                 "grad": int((grad != pgrad).sum())}
        picked = ck.pick(S)
        sweep = {}
        for d in ck.designs(S):
            n, g, _ = ck.ctc_loss_fused(lp, ll, lab, lab_len, design=d)
            rel, err = checked(n, g, f"{label}, R={d[0]} NW={d[1]}")
            sweep[f"R{d[0]}_NW{d[1]}"] = {
                "max_abs_err": err, "nll_max_rel_err": rel,
                "chunks": ck.chunks(S, *d),
                "device_ms": device_ms(lambda: ck.ctc_loss_fused(
                    lp, ll, lab, lab_len, design=d))}
        lpl = lp.transpose(0, 1).contiguous().requires_grad_(True)

        def library():
            F.ctc_loss(lpl, lab, ll, lab_len, reduction="sum",
                       zero_infinity=True).backward()

        in_smem = T * Sp * 4 <= ck._smem_limit(lib, picked[0])
        need, moved = k3_bytes(lp, ll, lab, lab_len, Sp, in_smem)
        cells = int((ll.long().clamp(0, T) * (2 * lab_len.long() + 1)).sum())
        b_ms, b_by = bound(need, 40 * cells)
        fused = lambda: ck.ctc_loss_fused(lp, ll, lab, lab_len)
        records[label] = {
            "name": "ctc_loss_fused", "route": "cuda",
            "source": "end_to_end_asr_pytorch_tpu_torch/csrc/ctc_loss.cu",
            "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/ctc_kernel.py:149",
            "max_abs_err": g_err,
            "ms": cuda_ms(fused, 20), "device_ms": device_ms(fused),
            "plain_ms": cuda_ms(lambda: ck.ctc_loss_plain(
                lp, ll, lab, lab_len), 1 if T > 400 else 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(library, 20)}
        emit({"phase": "k3", "shape": label, "B": B, "T": T, "S": S,
              "V": lp.shape[-1], "design": {"R": picked[0], "NW": picked[1]},
              "chunks": ck.chunks(S, *picked), "alpha_in_smem": in_smem,
              "nll_max_rel_err": nll_rel,
              "infeasible_rows": int((pnll >= 1e29).sum()),
              "bit_identical_over_two_calls": True,
              "differing_from_plain": exact,
              "moved_bytes": moved, "moved_bound_ms": moved / HBM_BPS * 1e3,
              "chain_floor_ms": (T - 1) * floor[1],
              "chain_floor_ms_picked_nw": (T - 1) * floor[picked[1]],
              "library_device_ms": device_ms(library),
              "sweep": sweep, **records[label]})

    # the card route: CTCLoss.forward launches K3 and nothing else
    lp, ll, lab, lab_len = (x.cuda() for x in ctc_case(slice_batch, seed + 5))
    x = lp.clone().requires_grad_(True)

    def kernels_launched(fn, iters=5):
        """Device kernels by name over ``iters`` calls of ``fn`` (the
        profiler's counts; a late trace may add a cycle's events, so the
        names are what is held, and the launches per call come from the
        wrappers' counters)."""
        fn()
        torch.cuda.synchronize()
        counts = {}
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:
                    counts[e.key[:60]] = counts.get(e.key[:60], 0) + e.count
            if counts:
                break
        return counts

    calls = []

    def forward():
        calls.append(1)
        ctc.ctc_loss_k3(x, ll, lab, lab_len)

    before = ck.ctc_loss_fused.launches
    fwd = kernels_launched(forward)
    k3_per_call = (ck.ctc_loss_fused.launches - before) / len(calls)
    prep = kernels_launched(lambda: ck.prepare(lp, lab, lab_len), iters=1)
    check(len(fwd) > 0 and all("ctc_kernel" in k for k in fwd)
          and k3_per_call == 1,
          f"the card route's CTCLoss.forward launched {fwd} "
          f"({k3_per_call} K3 launches a call), not K3 alone")
    emit({"phase": "k3_route", "forward_kernels": fwd,
          "k3_launches_per_forward": k3_per_call,
          "prepare_launches": sum(prep.values()), "prepare": prep})
    return records["slice"]


def att_case(B, seed, T=176):
    """A generator for inputs at the scale of bench.py's model, and ragged
    lengths (the first row full, the second of length 1)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    lens[0], lens[1] = T, 1
    return rng, lens


def att_frames(lens, T):
    """Frames with a valid energy, and frames whose alignment can be
    non-zero (every frame of a zero-length row), summed over the batch."""
    n = np.clip(lens, 0, T)
    return int(n.sum()), int(np.where(n > 0, n, T).sum())


def k5_case(label, B, K, T, d, F, vdim, tau, seed, lens=None, sizes=False):
    """K5 against its plain version on one shape (align atol 1e-5, ctx atol
    1e-4), timed by CUDA events and by the profiler; ``lens`` defaults to
    att_case's ragged lengths. With ``sizes``, every cluster size up to
    slices(T) checked the same way and timed beside the one the wrapper
    picks, with the clusters resident at once. Emits the phase line,
    returns the record."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import att_kernel as ak
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build
    rng, ragged = att_case(B, seed, T)
    lens = ragged if lens is None else np.asarray(lens, np.int32)
    r = lambda *shape, s: torch.from_numpy(
        (rng.randn(*shape) * s).astype(np.float32)).cuda()
    args = (r(B, K, d, s=0.3), r(B, T, d, s=0.3), r(B, K, T, F, s=0.05),
            r(F, d, s=0.3), r(d, s=0.06), r(B, T, vdim, s=0.3),
            torch.from_numpy(lens).cuda())
    ctx, align = ak.loc_attention_fused(*args, tau)
    pctx, palign = ak.loc_attention_plain(*args, tau)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(ctx).all() and torch.isfinite(align).all()),
          f"K5 output not finite ({label})")
    a_err = float((align - palign).abs().max())
    c_err = float((ctx - pctx).abs().max())
    check(a_err <= 1e-5, f"K5 align max abs err {a_err} ({label})")
    check(c_err <= 1e-4, f"K5 ctx max abs err {c_err} ({label})")
    zero = lens <= 0
    if zero.any():
        check(bool(torch.allclose(align[torch.from_numpy(zero).cuda()],
                                  torch.full((), 1.0 / T, device="cuda"),
                                  rtol=1e-6, atol=0)),
              f"K5 zero-length rows not uniform ({label})")
    valid, weighted = att_frames(lens, T)
    nbytes = 4 * (B * K * d + valid * d + K * valid * F + F * d + d
                  + weighted * vdim + B + B * K * vdim + B * K * T)
    flops = K * (valid * d * (2 * F + 5) + weighted * 2 * vdim)
    b_ms, b_by = bound(nbytes, flops)
    rec = {
        "name": "loc_attention_fused", "route": "cuda",
        "source": "end_to_end_asr_pytorch_tpu_torch/csrc/loc_att.cu",
        "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/att_kernel.py:57",
        "max_abs_err": max(a_err, c_err),
        "ms": cuda_ms(lambda: ak.loc_attention_fused(*args, tau), 20),
        "device_ms": device_ms(lambda: ak.loc_attention_fused(*args, tau)),
        "plain_ms": cuda_ms(lambda: ak.loc_attention_plain(*args, tau), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    lib = build.load("loc_att", ak._SIGNATURES)
    size_ms = {}
    for C in (range(1, ak.slices(T) + 1) if sizes else ()):
        sctx, salign = ak.loc_att_tc(*args, tau, slices=C)
        torch.cuda.synchronize()
        err = max(float((salign - palign).abs().max()) / 1e-5,
                  float((sctx - pctx).abs().max()) / 1e-4)
        check(err <= 1.0, f"K5 in clusters of {C}: error {err} of its bound "
              f"({label})")
        resident = ctypes.c_int(0)
        build.check(lib.loc_att_max_clusters(K, T, d, F, vdim, C,
                                             ctypes.byref(resident)),
                    "K5 occupancy query")
        size_ms[C] = {"device_ms": device_ms(
            lambda: ak.loc_att_tc(*args, tau, slices=C)),
            "clusters_resident": resident.value}
    emit({"phase": "k5", "shape": label, "B": B, "K": K, "T": T, "d": d,
          "F": F, "vdim": vdim,
          "slices": ak.pick_slices(lib.loc_att_max_clusters, B, K, T, d, F,
                                   vdim), "slices_ms": size_ms,
          "lens_min": int(lens.min()), "align_max_abs_err": a_err,
          "ctx_max_abs_err": c_err, **rec})
    return rec


def phase_k5(seed, slice_batch, K=8, T=176, d=300, F=10, vdim=300, tau=0.5):
    """K5 against its plain version at B=128 and the slice's batch (the
    main path's shape: that record is the kernel's line), in the cluster
    size the wrapper picks and in every other, then an odd shape
    (B=3, K=5, T=37, d=96, F=3, vdim=80: three slices, a row of length 1
    that ends in the first and a zero-length row), a long one (T=700,
    tiles that stream) and one with F=20 taps and d=70, vdim=38, under the
    same tolerances."""
    records = {B: k5_case(f"B{B}", B, K, T, d, F, vdim, tau, seed + 7,
                          sizes=True)
               for B in (128, slice_batch)}
    k5_case("odd", 3, 5, 37, 96, 3, 80, tau, seed + 17, lens=[37, 1, 0])
    k5_case("long", slice_batch, K, 700, d, F, vdim, tau, seed + 27)
    # more location taps than one tensor-core k-step, and rows of d and
    # vdim that 16-byte copies do not take
    k5_case("wide_f", 4, 3, 50, 70, 20, 38, tau, seed + 37)
    return records[slice_batch]


def k7_bound(B, T, d, vdim, lens, es, backward):
    """K7's bound at ``es`` bytes per element of q, keys, f, v, vals and of
    the gradients (align, ctx, dctx and dalign f32). Forward: reads q, keys
    and f (valid frames), v, vals (weighted frames), lengths; writes ctx and
    align. Backward: reads the same (keys and f of the weighted frames),
    align, dctx and dalign; writes dq, dtarg and dvals (every frame) and
    dv."""
    valid, weighted = att_frames(lens, T)
    if not backward:
        return bound(es * (B * d + 2 * valid * d + d + weighted * vdim)
                     + 4 * (B + B * vdim + B * T),
                     valid * d * 5 + weighted * 2 * vdim)
    return bound(es * (B * d + 2 * weighted * d + d + weighted * vdim
                       + B * d + B * T * d + B * T * vdim + d)
                 + 4 * (B + 2 * B * T + B * vdim),
                 weighted * (10 * d + 2 * vdim) + B * T * vdim)


def k7_inputs(B, T, d, vdim, seed, lens=None):
    """K7's f32 inputs at the scale of bench.py's model: q, keys, f, v,
    vals, the lengths on the card (att_case's ragged ones unless ``lens``),
    the cotangents dctx and dalign, and the lengths as numpy."""
    import torch
    rng, ragged = att_case(B, seed, T)
    lens = ragged if lens is None else np.asarray(lens, np.int32)
    r = lambda *shape, s: torch.from_numpy(
        (rng.randn(*shape) * s).astype(np.float32)).cuda()
    ins = (r(B, d, s=0.3), r(B, T, d, s=0.3), r(B, T, d, s=0.1),
           r(d, s=0.06), r(B, T, vdim, s=0.3))
    el = torch.from_numpy(lens).cuda()
    return ins, el, r(B, vdim, s=1.0), r(B, T, s=1.0), lens


def k7_over_bound(tk, x, el, tau, dctx, dalign, align_in, fwd, bwd):
    """The largest error of a K7 forward ``fwd`` (ctx, align) and backward
    ``bwd`` (dq, dtarg, dvals, dv, from ``align_in``) against the plain
    versions on the same inputs ``x``, over the phase's bounds (<= 1
    passes): f32 ctx / align atol 1e-4, dq / dtarg / dvals atol 1e-5, dv
    1e-4 of its max magnitude; bf16 ctx / align 1e-4 + 2^-7 of their max,
    dq / dtarg / dvals 1 bf16 ulp + 1e-5 (bf16_diff), dv 2^-7 of its max."""
    import torch
    pf = tk.loc_att_fwd_plain(*x, el, tau)
    pb = tk.loc_att_bwd_plain(*x, el, align_in, dctx, dalign, tau)
    check(all(bool(torch.isfinite(t.float()).all()) for t in (*fwd, *bwd)),
          "K7 output not finite")
    dv_rel = float((bwd[3].float() - pb[3].float()).abs().max()
                   / pb[3].float().abs().max())
    if x[0].dtype == torch.bfloat16:
        f_err = max(float((a - b).abs().max() / (1e-4 + 2.0 ** -7
                                                 * b.abs().max()))
                    for a, b in zip(fwd, pf))
        b_err = max(bf16_diff(a, b)[1] for a, b in zip(bwd[:3], pb[:3]))
        return max(f_err, b_err, dv_rel / 2.0 ** -7)
    f_err = max(float((a - b).abs().max()) for a, b in zip(fwd, pf)) / 1e-4
    b_err = max(float((a - b).abs().max())
                for a, b in zip(bwd[:3], pb[:3])) / 1e-5
    return max(f_err, b_err, dv_rel / 1e-4)


def k7_identical(tk, x, el, tau, dctx, dalign):
    """Whether two calls of K7's forward and backward give bit-identical
    outputs, dv included."""
    import torch
    f1, f2 = (tk.loc_att_fwd_tc(*x, el, tau) for _ in range(2))
    b1, b2 = (tk.loc_att_bwd_tc(*x, el, f1[1], dctx, dalign, tau)
              for _ in range(2))
    return all(bool(torch.equal(a, b)) for a, b in zip((*f1, *b1),
                                                       (*f2, *b2)))


def k7_cold_ms(fn, flush):
    """Device ms of K7's kernel per call of ``fn`` with L2 flushed before
    each (``flush`` zeroed: a buffer larger than L2), as the training step
    finds it after the work between two label steps."""
    ms = device_ms(lambda: (flush.zero_(), fn()), by_kernel=True)
    return None if ms is None else sum(v for k, v in ms.items()
                                       if "loc_att_" in k)


def k7_sizes(tk, lib, x, el, tau, dctx, dalign):
    """Every cluster size up to clusters(T) for K7's forward and backward
    on inputs ``x`` (f32 or bf16): checked under the phase's bounds
    (k7_over_bound), device ms of each, and the clusters of each resident
    at once."""
    import torch
    B, T, d = x[1].shape
    vdim = x[4].shape[-1]
    out = {}
    for C in range(1, tk.clusters(T) + 1):
        fwd = lambda: tk.loc_att_fwd_tc(*x, el, tau, clusters=C)
        f = fwd()
        bwd = lambda: tk.loc_att_bwd_tc(*x, el, f[1], dctx, dalign, tau,
                                        clusters=C)
        g = bwd()
        torch.cuda.synchronize()
        err = k7_over_bound(tk, x, el, tau, dctx, dalign, f[1], f, g)
        check(err <= 1.0, f"K7 ({x[0].dtype}) in clusters of {C}: error "
              f"{err} of its bound at B={B}, T={T}")
        resident = {}
        for name, bw in (("fwd", False), ("bwd", True)):
            n = ctypes.c_int(0)
            rc = lib.loc_att_train_max_clusters(
                tk._kind(bw, x[0].dtype, d, vdim, *x), T, d, vdim, C,
                ctypes.byref(n))
            check(rc == 0, f"K7 occupancy query: CUDA error {rc}")
            resident[name] = n.value
        out[C] = {"fwd_device_ms": device_ms(fwd),
                  "bwd_device_ms": device_ms(bwd), "err_over_bound": err,
                  "clusters_resident": resident}
    return out


def k7_picked(tk, lib, x):
    """The cluster sizes the wrappers pick for inputs ``x``."""
    B, T, d = x[1].shape
    vdim = x[4].shape[-1]
    return {name: tk.pick_clusters(lib.loc_att_train_max_clusters,
                                   tk._kind(bw, x[0].dtype, d, vdim, *x), B,
                                   T, d, vdim)
            for name, bw in (("fwd", False), ("bwd", True))}


def k7_bf16_case(tk, B, T, d, vdim, tau, ins, el, dctx, dalign, lens):
    """K7's bf16 variant on the f32 case's inputs rounded to bf16, against
    its plain version: ctx and align within 1e-4 + 2^-7 of their largest
    magnitude; dq, dtarg and dvals within 1 bf16 ulp + 1e-5 (bf16_diff);
    dv within 2^-7 of its largest magnitude. -> the two kernel records
    (bound at bf16 bytes), the errors and the bf16 inputs."""
    import torch
    bins = tuple(t.to(torch.bfloat16) for t in ins)
    ctx, align = tk.loc_att_fwd_bf16(*bins, el, tau)
    pctx, palign = tk.loc_att_fwd_plain(*bins, el, tau)
    grads = tk.loc_att_bwd_bf16(*bins, el, align, dctx, dalign, tau)
    pgrads = tk.loc_att_bwd_plain(*bins, el, align, dctx, dalign, tau)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t.float()).all())
              for t in (ctx, align, *grads)), "K7 bf16 output not finite")
    check(ctx.dtype == align.dtype == torch.float32
          and all(g.dtype == torch.bfloat16 for g in grads),
          "K7 bf16: ctx / align not f32 or gradients not bf16")
    f_err = max(float((a - b).abs().max() / (1e-4 + 2.0 ** -7
                                             * b.abs().max()))
                for a, b in ((ctx, pctx), (align, palign)))
    check(f_err <= 1.0, f"K7 bf16 forward: {f_err} of its bound at B={B}")
    diffs = [bf16_diff(a, b) for a, b in zip(grads[:3], pgrads[:3])]
    ulps = max(u for _, u, _ in diffs)
    check(ulps <= 1.0, f"K7 bf16 backward beyond 1 bf16 ulp (+1e-5) of "
          f"the plain version ({ulps} of the bound) at B={B}")
    e_dv = float((grads[3].float() - pgrads[3].float()).abs().max()
                 / pgrads[3].float().abs().max())
    check(e_dv <= 2.0 ** -7, f"K7 bf16 dv err / max |dv| {e_dv} at B={B}")
    common = {"route": "cuda", "library_ms": None,
              "source": "end_to_end_asr_pytorch_tpu_torch/csrc/loc_att_train.cu"}
    fb_ms, fb_by = k7_bound(B, T, d, vdim, lens, 2, False)
    bb_ms, bb_by = k7_bound(B, T, d, vdim, lens, 2, True)
    fwd = lambda: tk.loc_att_fwd_bf16(*bins, el, tau)
    bwd = lambda: tk.loc_att_bwd_bf16(*bins, el, align, dctx, dalign, tau)
    fwd_rec = {"name": "loc_att_fwd_bf16", **common,
               "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/att_train_kernel.py:161",
               "max_abs_err": max(float((ctx - pctx).abs().max()),
                                  float((align - palign).abs().max())),
               "ms": cuda_ms(fwd, 20), "device_ms": device_ms(fwd),
               "plain_ms": cuda_ms(lambda: tk.loc_att_fwd_plain(
                   *bins, el, tau), 20),
               "bound_ms": fb_ms, "bound_by": fb_by}
    bwd_rec = {"name": "loc_att_bwd_bf16", **common,
               "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/att_train_kernel.py:215",
               "max_abs_err": max(e for e, _, _ in diffs),
               "ms": cuda_ms(bwd, 20), "device_ms": device_ms(bwd),
               "plain_ms": cuda_ms(lambda: tk.loc_att_bwd_plain(
                   *bins, el, align, dctx, dalign, tau), 20),
               "bound_ms": bb_ms, "bound_by": bb_by}
    return fwd_rec, bwd_rec, {
        "fwd_err_over_bound": f_err, "bwd_max_err_over_bf16_ulp_bound": ulps,
        "bwd_differing_share": max(s for _, _, s in diffs),
        "bwd_dv_err_over_max": e_dv}, bins


def k7_sms(tk, x, el, tau, dctx, dalign, picked):
    """The SMs that the blocks of one launch of K7's forward and backward
    ran on, counted (each block records its %smid)."""
    import torch
    B = x[1].shape[0]
    ids = {k: torch.full((B * C,), -1, dtype=torch.int32, device="cuda")
           for k, C in picked.items()}
    align = tk.loc_att_fwd_tc(*x, el, tau, sm_ids=ids["fwd"])[1]
    tk.loc_att_bwd_tc(*x, el, align, dctx, dalign, tau, sm_ids=ids["bwd"])
    torch.cuda.synchronize()
    check(all(bool((t >= 0).all()) for t in ids.values()),
          "K7: a block did not record its SM")
    return {k: int(torch.unique(t).numel()) for k, t in ids.items()}


def k7_timings(tk, lib, x, el, tau, dctx, dalign, flush, sizes):
    """The picked cluster sizes, the SMs a launch spans, the bit-identity
    of two calls, the device ms with L2 flushed before each call, and
    (with ``sizes``) every cluster size checked and timed, for inputs
    ``x``."""
    align = tk.loc_att_fwd_tc(*x, el, tau)[1]
    same = k7_identical(tk, x, el, tau, dctx, dalign)
    check(same, f"K7 ({x[0].dtype}) outputs differ between two calls")
    picked = k7_picked(tk, lib, x)
    return {"clusters": picked,
            "sms_spanned": k7_sms(tk, x, el, tau, dctx, dalign, picked),
            "bit_identical": same,
            "fwd_device_ms_cold_l2": k7_cold_ms(
                lambda: tk.loc_att_fwd_tc(*x, el, tau), flush),
            "bwd_device_ms_cold_l2": k7_cold_ms(
                lambda: tk.loc_att_bwd_tc(*x, el, align, dctx, dalign, tau),
                flush),
            "clusters_ms": (k7_sizes(tk, lib, x, el, tau, dctx, dalign)
                            if sizes else None)}


def k7_case(tk, lib, label, B, T, d, vdim, tau, seed, flush, lens=None):
    """K7 in f32 and bf16 at the cluster size the wrappers pick, on one
    shape off the main path: checked under the phase's bounds, bit-
    identical over two calls, device ms warm and with L2 flushed. Emits
    one k7_case line per dtype."""
    import torch
    ins, el, dctx, dalign, lens = k7_inputs(B, T, d, vdim, seed, lens)
    for x in (ins, tuple(t.to(torch.bfloat16) for t in ins)):
        fwd = lambda: tk.loc_att_fwd_tc(*x, el, tau)
        f = fwd()
        bwd = lambda: tk.loc_att_bwd_tc(*x, el, f[1], dctx, dalign, tau)
        g = bwd()
        torch.cuda.synchronize()
        err = k7_over_bound(tk, x, el, tau, dctx, dalign, f[1], f, g)
        check(err <= 1.0, f"K7 {label} ({x[0].dtype}): error {err} of its "
              f"bound")
        zero = torch.from_numpy(lens <= 0).cuda()
        if bool(zero.any()):
            check(bool(torch.allclose(f[1][zero], torch.full(
                (), 1.0 / T, device="cuda"), rtol=1e-6, atol=0)),
                f"K7 {label}: zero-length rows not uniform")
        emit({"phase": "k7_case", "shape": label, "dtype": str(x[0].dtype),
              "B": B, "T": T, "d": d, "vdim": vdim,
              "lens": lens.tolist() if B <= 8 else None,
              "scalar_variant": bool(tk._kind(False, x[0].dtype, d, vdim, *x)
                                     & tk.SCALAR),
              "err_over_bound": err,
              "fwd_device_ms": device_ms(fwd), "bwd_device_ms": device_ms(bwd),
              **k7_timings(tk, lib, x, el, tau, dctx, dalign, flush, False)})


def phase_k7(seed, slice_batch, T=176, d=300, vdim=300, tau=0.5):
    """The K7 forward and backward against their plain versions, and the
    backward against autograd through the plain forward, at B=128 and the
    slice's batch; then K7's bf16 variant on the same inputs rounded to
    bf16 (k7_bf16 lines). Each line also holds the cluster sizes the
    wrappers pick, the bit-identity of two calls, the device ms with L2
    flushed before each call, and every cluster size checked and timed.
    Then shapes off the main path (k7_case lines): d=38, vdim=70 (the
    scalar variant), rows shorter than the cluster (blocks without a
    frame) and a zero-length row, and a long utterance (B=4, T=900). The
    library's SASS must hold no MUFU.TANH (accurate tanhf). -> the f32 and
    the bf16 records at the slice's batch."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import att_train_kernel as tk
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build
    lib = build.load("loc_att_train", tk._SIGNATURES)
    sass = {op: sass_count("loc_att_train", op)
            for op in ("MUFU.TANH", "MUFU.EX2")}
    check(sass["MUFU.TANH"] in (None, 0) and sass["MUFU.EX2"] != 0,
          f"K7's SASS holds MUFU.TANH, or no MUFU.EX2 (accurate tanhf's): "
          f"{sass}")
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fwd, bwd, fwd16, bwd16 = {}, {}, {}, {}
    for B in (128, slice_batch):
        ins, el, dctx, dalign, lens = k7_inputs(B, T, d, vdim, seed + 8)
        ctx, align = tk.loc_att_fwd_fused(*ins, el, tau)
        pctx, palign = tk.loc_att_fwd_plain(*ins, el, tau)
        grads = tk.loc_att_bwd_fused(*ins, el, align, dctx, dalign, tau)
        pgrads = tk.loc_att_bwd_plain(*ins, el, palign, dctx, dalign, tau)
        xs = [t.clone().requires_grad_(True) for t in ins]
        torch.autograd.backward(tk.loc_att_fwd_plain(*xs, el, tau),
                                (dctx, dalign))
        torch.cuda.synchronize()
        dq_a, dk_a, df_a, dv_a, dvals_a = (x.grad for x in xs)
        check(all(bool(torch.isfinite(t).all())
                  for t in (ctx, align, *grads)), "K7 output not finite")
        f_err = max(float((ctx - pctx).abs().max()),
                    float((align - palign).abs().max()))
        check(f_err <= 1e-4, f"K7 forward max abs err {f_err} at B={B}")
        errs = {}
        for tag, (dq, dtarg, dvals, dv) in (
                ("plain", pgrads), ("autograd", (dq_a, dk_a, dvals_a, dv_a))):
            e = max(float((a - b).abs().max()) for a, b in
                    ((grads[0], dq), (grads[1], dtarg), (grads[2], dvals)))
            e_dv = float((grads[3] - dv).abs().max() / dv.abs().max())
            check(e <= 1e-5, f"K7 backward vs {tag}: dq/dtarg/dvals max abs "
                  f"err {e} at B={B}")
            check(e_dv <= 1e-4, f"K7 backward vs {tag}: dv err / max |dv| "
                  f"{e_dv} at B={B}")
            errs[tag] = (e, e_dv)
        check(bool(torch.equal(df_a, dk_a)),
              "autograd gives keys and f different gradients")
        fb_ms, fb_by = k7_bound(B, T, d, vdim, lens, 4, False)
        bb_ms, bb_by = k7_bound(B, T, d, vdim, lens, 4, True)
        common = {"route": "cuda", "library_ms": None,
                  "source": "end_to_end_asr_pytorch_tpu_torch/csrc/loc_att_train.cu"}
        fwd[B] = {"name": "loc_att_fwd_fused", **common,
                  "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/att_train_kernel.py:161",
                  "max_abs_err": f_err,
                  "ms": cuda_ms(lambda: tk.loc_att_fwd_fused(*ins, el, tau), 20),
                  "plain_ms": cuda_ms(lambda: tk.loc_att_fwd_plain(*ins, el, tau), 20),
                  "bound_ms": fb_ms, "bound_by": fb_by}
        bwd[B] = {"name": "loc_att_bwd_fused", **common,
                  "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/att_train_kernel.py:215",
                  "max_abs_err": errs["plain"][0],
                  "ms": cuda_ms(lambda: tk.loc_att_bwd_fused(
                      *ins, el, align, dctx, dalign, tau), 20),
                  "plain_ms": cuda_ms(lambda: tk.loc_att_bwd_plain(
                      *ins, el, align, dctx, dalign, tau), 20),
                  "bound_ms": bb_ms, "bound_by": bb_by}
        fwd[B]["device_ms"] = device_ms(
            lambda: tk.loc_att_fwd_fused(*ins, el, tau))
        bwd[B]["device_ms"] = device_ms(lambda: tk.loc_att_bwd_fused(
            *ins, el, align, dctx, dalign, tau))
        emit({"phase": "k7", "B": B, "T": T, "d": d, "vdim": vdim,
              "fwd": fwd[B], "bwd": bwd[B],
              "bwd_dv_err_over_max_vs_plain": errs["plain"][1],
              "bwd_max_abs_err_vs_autograd": errs["autograd"][0],
              "bwd_dv_err_over_max_vs_autograd": errs["autograd"][1],
              "sass_lines": sass,
              **k7_timings(tk, lib, ins, el, tau, dctx, dalign, flush, True)})
        fwd16[B], bwd16[B], errs16, bins = k7_bf16_case(
            tk, B, T, d, vdim, tau, ins, el, dctx, dalign, lens)
        emit({"phase": "k7_bf16", "B": B, "T": T, "d": d, "vdim": vdim,
              "fwd": fwd16[B], "bwd": bwd16[B], **errs16,
              **k7_timings(tk, lib, bins, el, tau, dctx, dalign, flush,
                           True)})
    # off the main path: the scalar variant, blocks without a frame (and a
    # zero-length row), a ~36 s utterance
    k7_case(tk, lib, "scalar", 8, 50, 38, 70, tau, seed + 18, flush)
    k7_case(tk, lib, "short_rows", 5, T, d, vdim, tau, seed + 28, flush,
            lens=[T, 1, 3, 5, 0])
    k7_case(tk, lib, "long", 4, 900, d, vdim, tau, seed + 38, flush)
    del flush
    return (fwd[slice_batch], bwd[slice_batch], fwd16[slice_batch],
            bwd16[slice_batch])


def psi_case(B, K, T, V, seed, dtype):
    """K6 inputs at the beam's scale: probs softmax rows with ragged lengths
    (padded frames blank-only) in ``dtype``, step weights wd in (0, 1] with
    each row's maximum 1, row shifts, psi_same and the last tokens (on blank
    and on both sides of every 128 and 256 column edge, the rest random)."""
    import torch
    rng = np.random.RandomState(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((B, T, V), generator=g, device="cuda") * 3.0
    probs = torch.softmax(logits, dim=-1)
    lens = torch.from_numpy(rng.randint(T // 2, T + 1, size=B)).cuda()
    pad = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
    probs[pad] = 0.0
    probs[..., 0][pad] = 1.0
    wd = np.exp(-rng.uniform(0.0, 30.0, (B, K, T))).astype(np.float32)
    wd[:, :, 0] = 1.0
    md = rng.uniform(-150.0, 0.0, (B, K)).astype(np.float32)
    ps = rng.uniform(-150.0, 0.0, (B, K)).astype(np.float32)
    edges = [0] + [e + d for e in range(128, V, 128) for d in (-1, 0)]
    last = rng.randint(1, V, size=(B, K)).astype(np.int32)
    flat = last.reshape(-1)
    flat[:min(len(edges), flat.size)] = edges[:flat.size]
    t = lambda a: torch.from_numpy(a).cuda()
    return (t(wd), probs.to(dtype).contiguous(), t(md), t(ps),
            t(last.reshape(B, K)))


def psi_errors(got, ref, last, blank=0):
    """Largest rtol/atol-2e-5 excess on finite entries; whether the blank
    and last-token columns are bit-equal."""
    import torch
    fin = ref > -1e29
    excess = float(((got - ref).abs() - 2e-5 * ref.abs())[fin].max())
    cols = last.long()[..., None]
    exact = (bool((got[..., blank] == ref[..., blank]).all())
             and bool(torch.equal(torch.gather(got, 2, cols),
                                  torch.gather(ref, 2, cols))))
    return float((got - ref)[fin].abs().max()), excess, exact


def psi_library(wd_r, probs):
    """K6's library yardstick: ``torch.bmm`` of the rounded weights and the
    probs (the product K6 fuses), with an f32 output where this torch has
    it; and the call's name."""
    import torch
    try:
        torch.bmm(wd_r, probs, out_dtype=torch.float32)
        return (lambda: torch.bmm(wd_r, probs, out_dtype=torch.float32),
                "torch.bmm(out_dtype=float32)")
    except (TypeError, RuntimeError):
        return lambda: torch.bmm(wd_r, probs), f"torch.bmm ({probs.dtype} out)"


def phase_k6(seed, slice_batch, K=8, T=176, V=V_SUB):
    """K6 against its plain version: bf16 probs at B=128 and the slice's
    batch, the V=128 edge case, and f32 probs at the slice's batch (the
    non-amp psi_kernel route); then bf16 at V=16384 (las_sub16k's
    vocabulary), K=12 hypotheses (two n8 tiles of one walk) and a long
    input, B=2, T=8000 (more frames than one block could stage whole).
    ``torch.bmm`` of the bf16-rounded weights and the probs (the product K6
    fuses) is the library yardstick, alone and with the epilogue."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import psi_kernel as pk
    records = {}
    cases = [("bf16", 128, V, K, T), ("bf16", slice_batch, V, K, T),
             ("edge", slice_batch, 128, K, T), ("f32", slice_batch, V, K, T),
             ("bf16_v16384", slice_batch, 16384, K, T),
             ("bf16_k12", slice_batch, V, 12, T),
             ("bf16_long", 2, V, K, 8000)]
    for tag, B, Vc, Kc, Tc in cases:
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        args = list(psi_case(B, Kc, Tc, Vc, seed + 9 + B + Vc, dtype))
        if tag == "edge":
            args[1][:, :, 77] = 0.0                    # an all-zero column
            # blank, the zero column, 4- and 8-column edges, the 128-column
            # block edge of both kernels
            args[4][0] = torch.tensor([0, 77, 3, 4, 127, 126, 1, 64],
                                      dtype=torch.int32)
        got = pk.psi_fused(*args)
        ref = pk.psi_plain(*args)
        torch.cuda.synchronize()
        err, excess, exact = psi_errors(got, ref, args[4])
        check(excess <= 2e-5, f"K6 {tag} B={B} V={Vc}: beyond rtol/atol "
              f"2e-5 by {excess}")
        check(exact, f"K6 {tag} B={B} V={Vc}: blank / last-token columns "
              "not bit-equal to the plain version")
        res = {"phase": "k6", "case": tag, "B": B, "K": Kc, "T": Tc, "V": Vc,
               "probs": str(dtype).split(".")[-1], "max_abs_err": err}
        if tag == "edge":
            zero = got[:, :, 77][args[4] != 77]
            want = args[2][args[4] != 77] - 87.4982
            zerr = float((zero - want).abs().max())
            check(bool(torch.isfinite(zero).all()) and zerr <= 1e-3,
                  f"K6 all-zero column: {zerr} from md - 87.4982")
            emit({**res, "zero_column_max_abs_err_vs_md_minus_87_4982": zerr})
            continue
        wd, probs = args[0], args[1]
        lib, lib_call = psi_library(wd.to(dtype), probs)
        col = torch.arange(Vc, device="cuda")
        md, ps, last = args[2], args[3], args[4]

        def lib_epilogue():
            acc = lib().float()
            psi = md[..., None] + torch.log(acc + 1e-38)
            psi = torch.where(col == last[..., None], ps[..., None], psi)
            return torch.where(col == 0, -1e30, psi)

        nbytes = (probs.element_size() * B * Tc * Vc + 4 * B * Kc * Tc
                  + 12 * B * Kc + 4 * B * Kc * Vc)
        b_ms, b_by = bound(nbytes, 2 * B * Kc * Tc * Vc + B * Kc * Vc)
        fused = lambda: pk.psi_fused(*args)
        rec = {"name": "psi_fused", "route": "cuda",
               "source": "end_to_end_asr_pytorch_tpu_torch/csrc/psi.cu",
               "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/psi_kernel.py:75",
               "max_abs_err": err, "ms": cuda_ms(fused, 20),
               "device_ms": device_ms(fused),
               "plain_ms": cuda_ms(lambda: pk.psi_plain(*args), 20),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": cuda_ms(lib, 20)}
        emit({**res, **rec, "library_call": lib_call,
              "library_device_ms": device_ms(lib),
              "library_with_epilogue_ms": cuda_ms(lib_epilogue, 20),
              "gb_per_s": (nbytes / rec["device_ms"] / 1e6
                           if rec["device_ms"] else None)})
        if tag == "bf16":
            records[B] = rec
    return records[slice_batch]


class _Recorded(Exception):
    """Ends a recording decode once every wanted step is captured."""


def record_beam_steps(frontend, model, lm, decode_cfg, wave, wave_len, steps,
                      stop_early=False):
    """Run one fused-route decode whose tails go through the plain version,
    and capture K8's inputs at the steps in ``steps`` ("last" for the final
    call). Returns {step: (args, kwargs)}."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.decode import beam as beam_mod
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import beam_step_kernel as bsk
    got = {}
    want = {s for s in steps if s != "last"}

    def recorder(*args, **kw):
        keep = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        if args[0] in want:
            got[args[0]] = (keep, kw)
        if "last" in steps:
            got["last"] = (keep, kw)
        if stop_early and want <= set(got):
            raise _Recorded
        return bsk.beam_step_plain(*args, **kw)

    decoder = beam_mod.BeamDecoder(model, decode_cfg, lm=lm)
    beam_mod.beam_step_fused = recorder
    try:
        with torch.no_grad():
            decoder.forward(*frontend(wave, wave_len))
    except _Recorded:
        pass
    finally:
        beam_mod.beam_step_fused = bsk.beam_step_fused
    check(want <= set(got), f"recorded steps {sorted(got, key=str)}, "
          f"wanted {steps}")
    return got


def k8_compare(args, kw):
    """K8 against its plain version on one recorded step: winners equal on
    every slot (a differing pair only where the plain scores are a near
    tie, within 1e-5), scores within rtol / atol 1e-5, r within 1e-4."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import beam_step_kernel as bsk
    got = bsk.beam_step_fused(*args, **kw)
    ref = bsk.beam_step_plain(*args, **kw)
    torch.cuda.synchronize()
    cw = kw["cw"]
    same = (got.k_idx == ref.k_idx) & (got.v_idx == ref.v_idx)
    top_got = got.new_base + cw * got.psi_pick
    top_ref = ref.new_base + cw * ref.psi_pick
    tie_err = float((top_got - top_ref)[~same].abs().max()) if (~same).any() else 0.0
    check(tie_err <= 1e-5, f"K8 picks differ beyond a near tie ({tie_err})")
    check(torch.equal(got.new_valid, ref.new_valid), "K8 new_valid differs")
    err = lambda a, b, m: float(((a - b).abs() - 1e-5 * b.abs())[m].max()) \
        if m.any() else 0.0
    base_err = err(got.new_base, ref.new_base, same)
    psi_err = err(got.psi_pick, ref.psi_pick, same)
    fin = ref.fin_norm > -5e29
    fin_err = err(got.fin_norm, ref.fin_norm, fin)
    check(max(base_err, psi_err, fin_err) <= 1e-5,
          f"K8 scores beyond rtol / atol 1e-5: base {base_err}, psi "
          f"{psi_err}, finished {fin_err}")
    check(torch.equal(got.fin_meta[fin], ref.fin_meta[fin]),
          "K8 finished-set metadata differs")
    sane = same[..., None, None] & (ref.r > -5e29)
    r_err = float(((got.r - ref.r).abs() - 1e-4 * ref.r.abs())[sane].max())
    check(r_err <= 1e-4, f"K8 r beyond rtol / atol 1e-4 by {r_err}")
    absd = lambda a, b, m: float((a - b)[m].abs().max()) if m.any() else 0.0
    abs_errs = {"new_base": absd(got.new_base, ref.new_base, same),
                "psi_pick": absd(got.psi_pick, ref.psi_pick, same),
                "fin_norm": absd(got.fin_norm, ref.fin_norm, fin),
                "r": absd(got.r, ref.r, sane)}
    return {"picks_differing": int((~same).sum()), "near_tie_err": tie_err,
            "score_excess": max(base_err, psi_err, fin_err),
            "r_excess": r_err, "max_abs_err": max(abs_errs.values()),
            "max_abs_err_by_output": abs_errs,
            "dead_slots": int((~ref.new_valid).sum())}


def k8_bound(B, K, T, V):
    """K8's bytes (every input read once, every output written once) and
    the psi products' operations."""
    bk = B * K
    nbytes = (4 * 2 * bk * V + 4 * B * T * V + 2 * 4 * bk * T * 2
              + bk * (4 * 2 + 1 + 8 * 2) + 4 * 2 * B
              + bk * (8 * 3 + 1 + 4 * 3))
    return bound(nbytes, 2 * bk * T * V)


V_ODD = 999           # a vocabulary K8's cluster slices unevenly
V_16K = 16384         # config/synthetic/las_sub16k.yaml, bench_vocab.py's widest


def phase_k8(frontend, batch, seed):
    """K8 against its plain version on real beam states of the slice's
    model, LM and config (amp off): at V=31 (one block per utterance)
    recorded at steps 0, 1, 40 and the last, at V=5120 (a cluster of 16
    blocks) at steps 1, 40 and the last, both also without the LM at step
    40; at V=999 (a cluster of 4 uneven slices) at steps 1 and 40; a batch
    of 128 at V=5120, step 1; V=16384 (a cluster of 16 slices of 1024
    columns) at steps 1 and 40, timed at step 40; beams of 16 (two psi passes: V=31 at
    steps 1 and 40, V=5120 at step 1) and of 4 (V=31, steps 1 and 40).
    Times per launch (CUDA events over 20 calls) at step 40 of both widths and step 1 of the batch of 128, the
    plain tail's, and the device time of both per step. Returns the kernels
    line's rows for V=31 and V=5120."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import beam_step_kernel as bsk
    res, rows = {}, {}
    for vocab, B, K, steps, timed in (
            (V_CHAR, batch, 8, (0, 1, 40, "last"), 40),
            (V_SUB, batch, 8, (1, 40, "last"), 40),
            (V_ODD, batch, 8, (1, 40), None),
            (V_SUB, 128, 8, (1,), 1),
            (V_16K, batch, 8, (1, 40), 40),
            (V_CHAR, batch, 16, (1, 40), None),   # two psi passes
            (V_SUB, batch, 16, (1,), None),
            (V_CHAR, batch, 4, (1, 40), None)):
        w, wl = make_waves(B, seed + 2)          # the slice's batch
        wave, wave_len = torch.from_numpy(w).cuda(), torch.from_numpy(wl).cuda()
        model, lm = slice_models(frontend, seed, vocab)
        rec = record_beam_steps(frontend, model, lm,
                                {**DECODE_CFG, "beam_size": K}, wave,
                                wave_len, steps,
                                stop_early="last" not in steps)
        del model, lm
        cases = [(step, args, kw) for step, (args, kw) in rec.items()]
        if "last" in steps:                  # the no-LM kernel path too
            args, kw = rec[40]
            cases.append(("40, no LM", (*args[:2], None, *args[3:]),
                          {**kw, "lw": 0.0}))
        for step, args, kw in cases:
            c = k8_compare(args, kw)
            _, Kr, V = args[1].shape
            check(Kr == K, f"recorded a beam of {Kr}, wanted {K}")
            T = args[8].shape[2]
            emit({"phase": "k8", "vocab": V, "step": args[0],
                  "recorded_as": step, "B": B, "K": K, "T": T,
                  "clusters": bsk.clusters(V), **c})
            res[(vocab, B, K, step)] = c
        if timed is None:
            continue
        args, kw = rec[timed]
        _, _, V = args[1].shape
        T = args[8].shape[2]
        b_ms, b_by = k8_bound(B, K, T, V)
        rec_v = {"name": "beam_step_fused", "route": "cuda",
                 "source": "end_to_end_asr_pytorch_tpu_torch/csrc/beam_step.cu",
                 "replaces": "end_to_end_asr_pytorch_tpu/ops/pallas/"
                             "beam_step_kernel.py:281",
                 "max_abs_err": max(c["max_abs_err"] for (v, b, k, _), c in
                                    res.items() if (v, b, k) == (vocab, B, K)),
                 "ms": cuda_ms(lambda: bsk.beam_step_fused(*args, **kw), 20),
                 "plain_ms": cuda_ms(lambda: bsk.beam_step_plain(*args, **kw), 20),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        emit({"phase": "k8_time", "vocab": V, "step": args[0], "B": B, "K": K,
              "T": T, "clusters": bsk.clusters(V), **rec_v,
              "library": "none: no single PyTorch call computes a beam step",
              "device_ms": device_ms(lambda: bsk.beam_step_fused(*args, **kw)),
              "plain_device_ms": device_ms(
                  lambda: bsk.beam_step_plain(*args, **kw))})
        if B == batch:
            rows[vocab] = rec_v
    return rows[V_CHAR], {**rows[V_SUB], "name": "beam_step_fused (V=5120)"}


def with_attention(**keys):
    """bench.py's model configuration with extra attention keys."""
    return {**MODEL_CFG, "attention": {**MODEL_CFG["attention"], **keys}}


# the launches each decode batch must make: kernel -> calls (each call of a
# tensor-core scan makes scan_calls' launches), "steps" for once per beam
# step; kernels left out must not launch
SLICE_EXPECT = {"fbank_fused": 1, "lstm_scan_fused": 6}
FUSED_EXPECT = {**SLICE_EXPECT, "beam_step_fused": "steps"}


def phase_slice(frontend, batch, seed, device, name="slice",
                model_cfg=MODEL_CFG, decode_cfg=UNFUSED_CFG, vocab=V_CHAR,
                expect=SLICE_EXPECT, n_batches=1, lm_cfg=LM_CFG,
                breakdown=True):
    """Decode batches of bench.py's model (random weights from ``seed``):
    ``n_batches`` timed ones whose launches must be ``expect``'s, one with
    the plain versions (compared), then (``breakdown``) a breakdown of one
    batch. Returns what a comparison with another decode config needs."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
    from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
    from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM
    from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
    model, lm = slice_models(frontend, seed, vocab, device, model_cfg, lm_cfg)
    decoder = BeamDecoder(model, decode_cfg, lm=lm)
    w, wl = make_waves(batch, seed + 2)
    wave, wave_len = torch.from_numpy(w).to(device), torch.from_numpy(wl).to(device)

    def run():
        with torch.no_grad():
            feat, feat_len = frontend(wave, wave_len)
            out = decoder.forward(feat, feat_len)
            return decoder.last_enc, out    # the encoder output decoded from

    run()                                   # warm-up (cuDNN / cuBLAS plans)
    torch.cuda.synchronize()
    counters = launch_counters()
    calls = scan_calls(batch)
    batches = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(n_batches):
            for fn in counters.values():
                fn.launches = 0
            feat, feat_len = frontend(wave, wave_len)
            out_k = decoder.forward(feat, feat_len)
            batches.append({k: fn.launches for k, fn in counters.items()})
            batches[-1]["decode_steps"] = decoder.last_steps
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_batches
    launches = {k: sum(b[k] for b in batches) for k in counters}
    steps = decoder.last_steps
    for b in batches:
        want = {k: (b["decode_steps"] if expect.get(k) == "steps"
                    else expect.get(k, 0) * calls.get(k, 1)) for k in counters}
        check({k: b[k] for k in counters} == want,
              f"{name}: every batch must launch {want}, got {batches}")
    enc_k, _ = run()
    cuda_kernels.USE_KERNELS = False
    try:
        enc_p, out_p = run()
    finally:
        cuda_kernels.USE_KERNELS = True
    torch.cuda.synchronize()
    K = decode_cfg["beam_size"]
    check(tuple(out_k.scores.shape) == (batch, K), "scores shape")
    check(bool(torch.isfinite(out_k.scores[:, 0]).all())
          and bool((out_k.scores[:, 0] > -1e29).all()), "top-1 scores")
    enc_err = float((enc_k.float() - enc_p.float()).abs().max())
    score_err, same = compare_top1(out_k, out_p)
    # bf16 encoder outputs (|h| < 1) may differ by an ulp, at most 2^-8,
    # in each of the three layers
    enc_tol = 3 * 2.0 ** -8 if decoder.last_amp else 1e-3
    check(enc_err <= enc_tol,
          f"encoder kernel vs plain max abs diff {enc_err} > {enc_tol}")
    # random weights leave many hypotheses within ~1e-4 of each other, so
    # tiny differences in the encoder can reorder near-tied beams: the best
    # normalized score is held to 1e-2
    check(score_err <= 1e-2, f"best score kernel vs plain max abs diff {score_err}")
    emit({"phase": name, "batch": batch, "secs": SECS, "vocab": vocab,
          "amp": decoder.last_amp, "enc_frames": int(enc_k.shape[1]),
          "decode_steps": steps, "enc_max_abs_diff": enc_err,
          "best_score_max_abs_diff": score_err, "top1_identical_share": same,
          "batches": n_batches, "utts_per_s": batch / dt,
          "seconds_per_batch": dt, "launches": launches})
    bd = (slice_breakdown(frontend, model, decoder, wave, wave_len, name)
          if breakdown else None)
    return {"model": model, "lm": lm, "wave": wave, "wave_len": wave_len,
            "out": out_k, "launches": launches, "amp": decoder.last_amp,
            "fused": decoder.last_fused, "breakdown": bd,
            "seconds_per_batch": dt}


def compare_top1(a, b):
    """Largest best-score difference of two beam outputs, and the share of
    rows whose top-1 tokens are identical."""
    import torch
    B = a.scores.shape[0]
    diff = float((a.scores[:, 0] - b.scores[:, 0]).abs().max())
    same = [bool(a.lengths[i, 0] == b.lengths[i, 0]) and torch.equal(
        a.tokens[i, 0, :a.lengths[i, 0]], b.tokens[i, 0, :b.lengths[i, 0]])
        for i in range(B)]
    return diff, sum(same) / B


def compare_slices(a, b, name, batch):
    """Two phase_slice runs of the same batch and weights side by side:
    best-score difference and top-1 share, time and launches per batch,
    and their breakdowns."""
    diff, same = compare_top1(a["out"], b["out"])
    check(diff <= 1e-2, f"{name}: best score differs by {diff}")
    keys = ("beam_step_ms", "encode_ms", "frontend_ms", "device_busy_ms",
            "device_ms_per_step", "device_idle_share", "launches_per_step",
            "device_kernel_launches")
    emit({"phase": name, "best_score_max_abs_diff": diff,
          "top1_identical_share": same,
          "seconds_per_batch": [a["seconds_per_batch"], b["seconds_per_batch"]],
          "utts_per_s": [batch / a["seconds_per_batch"],
                         batch / b["seconds_per_batch"]],
          **{k: [a["breakdown"][k], b["breakdown"][k]] for k in keys}})


def phase_slice_other(frontend, sl, decode_cfg, name, expect,
                      breakdown=False, plugin=None, against_plain=False):
    """The slice's batch and weights through another decode config (and
    an embedding ``plugin``): its launches (which must be ``expect``'s),
    the best-score difference and top-1 share against the slice's output,
    optionally against the same config on the plain route
    (``against_plain``: best score within 1e-2) and a breakdown."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
    from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
    decoder = BeamDecoder(sl["model"], decode_cfg, lm=sl["lm"], plugin=plugin)
    counters = launch_counters()
    with torch.no_grad():
        decoder.forward(*frontend(sl["wave"], sl["wave_len"]))     # warm-up
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decoder.forward(*frontend(sl["wave"], sl["wave_len"]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in counters.items()}
    steps = decoder.last_steps
    calls = scan_calls(sl["wave"].shape[0])
    want = {k: (steps if expect.get(k) == "steps"
                else expect.get(k, 0) * calls.get(k, 1)) for k in counters}
    check(got == want, f"{name}: the batch must launch {want}, got {got}")
    diff, same = compare_top1(sl["out"], out)
    fields = {}
    if against_plain:
        cuda_kernels.USE_KERNELS = False
        try:
            with torch.no_grad():
                out_p = decoder.forward(*frontend(sl["wave"], sl["wave_len"]))
        finally:
            cuda_kernels.USE_KERNELS = True
        diff_p, same_p = compare_top1(out, out_p)
        check(bool(torch.isfinite(out.scores[:, 0]).all())
              and bool((out.scores[:, 0] > -1e29).all()), f"{name}: top-1")
        check(diff_p <= 1e-2, f"{name}: best score kernel vs plain {diff_p}")
        fields = {"best_score_max_abs_diff_vs_plain": diff_p,
                  "top1_identical_share_vs_plain": same_p}
    emit({"phase": name, "amp": decoder.last_amp, "fused": decoder.last_fused,
          "early_stop": decoder.early_stop, "decode_steps": steps,
          "seconds_per_batch": dt, "ms_per_batch": dt * 1e3,
          "best_score_max_abs_diff_vs_slice": diff,
          "top1_identical_share_vs_slice": same, **fields, "launches": got,
          "launches_per_step": {k: v / steps for k, v in got.items() if v},
          "card": CARD})
    bd = (slice_breakdown(frontend, sl["model"], decoder, sl["wave"],
                          sl["wave_len"], name) if breakdown else None)
    return {"out": out, "seconds_per_batch": dt, "breakdown": bd,
            "launches": got, "decoder": decoder}


def plugin_config(workdir, dim=256):
    """An embedding plugin block over a hash table (``bert_embedding``'s
    ``--method hash``, dim ``dim``) of the slices' character vocabulary,
    written to ``workdir``: weight 1.0, fuse 0.3, temp 1.0."""
    from end_to_end_asr_pytorch_tpu_torch.utils.bert_embedding import \
        generate_embedding
    (workdir / "vocab.txt").write_text("\n".join(CHARS) + "\n")
    generate_embedding(str(workdir / "vocab.txt"), "character",
                       str(workdir / "emb.npy"), method="hash", dim=dim)
    return {"src": str(workdir / "emb.npy"), "weight": 1.0, "fuse": 0.3,
            "temp": 1.0}


def slice_breakdown(frontend, model, decoder, wave, wave_len, name):
    """Where one kernel-path decode batch spends its time: host-clock split
    into front end, encoder (under amp with the weights rounded to bf16)
    and beam loop, then one profiled decode for the device's busy share and
    its largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from end_to_end_asr_pytorch_tpu_torch.ops.amp import bf16_rounded_copy
    amp = decoder.last_amp

    def encode(feat, feat_len):
        if not amp:
            return model.encode(feat, feat_len)
        return bf16_rounded_copy(model).encode(feat.to(torch.bfloat16),
                                               feat_len)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        (feat, feat_len), front_ms = timed(lambda: frontend(wave, wave_len))
        _, enc_ms = timed(lambda: encode(feat, feat_len))
        _, fwd_ms = timed(lambda: decoder.forward(feat, feat_len))
        # device activity only: the split reads no host event, and a
        # decode's ~35,000 host operators made the trace slow to read
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    res = {"frontend_ms": front_ms, "encode_ms": enc_ms,
           "beam_loop_ms": fwd_ms - enc_ms, "decode_steps": decoder.last_steps,
           "beam_step_ms": (fwd_ms - enc_ms) / decoder.last_steps,
           "device_ms_per_step": busy_ms / decoder.last_steps,
           "profiled_decode_ms": prof_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / prof_ms,
           "device_kernel_launches": sum(e.count for e in evts),
           "launches_per_step": sum(e.count for e in evts) / decoder.last_steps}
    emit({"phase": f"{name}_breakdown", **res, "top_device_ms": top,
          "kernel_device_ms": kernel_device_ms(evts, dev)})
    return res


def sentencepiece_pieces(n):
    """(piece, score, type) of an n-piece unigram model: <pad>, </s>, <unk>,
    then word-initial and inner pieces of one to three letters."""
    from itertools import product
    from end_to_end_asr_pytorch_tpu_torch.utils import sentencepiece_model as spm
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = [("<pad>", 0.0, spm.TYPE_CONTROL), ("</s>", 0.0, spm.TYPE_CONTROL),
           ("<unk>", 0.0, spm.TYPE_UNKNOWN), ("\u2581", -3.0, spm.TYPE_NORMAL)]
    for k in (1, 2, 3):
        for head in ("\u2581", ""):
            for p in product(letters, repeat=k):
                if len(out) == n:
                    return out
                out.append((head + "".join(p), -2.0 * k, spm.TYPE_NORMAL))
    return out


def phase_entry(model, seed, name="entry", decode_cfg=None, vocab=V_CHAR,
                model_cfg=MODEL_CFG):
    """python -m end_to_end_asr_pytorch_tpu_torch.transcribe on two WAVs
    with ``model`` saved as a reference-layout checkpoint: a character
    vocabulary for V=31, else a generated sentencepiece model of ``vocab``
    pieces (the port's own serializer)."""
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch.data.audio_io import write_wav
    from end_to_end_asr_pytorch_tpu_torch.utils.sentencepiece_model import (
        serialize_model_proto)
    from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import asr_state_dict
    if decode_cfg is None:
        decode_cfg = {k: v for k, v in DECODE_CFG.items() if k != "lm_weight"}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        if vocab == V_CHAR:
            (d / "vocab.txt").write_text("\n".join(CHARS) + "\n")
            text = {"mode": "character", "vocab_file": str(d / "vocab.txt")}
        else:
            pieces = sentencepiece_pieces(vocab)
            check(len(pieces) == vocab, f"{len(pieces)} pieces, not {vocab}")
            (d / "sp.model").write_bytes(serialize_model_proto(pieces))
            text = {"mode": "subword", "vocab_file": str(d / "sp.model")}
        cfg = {"data": {"corpus": {"name": "smoke"}, "audio": AUDIO_CFG,
                        "text": text},
               "model": model_cfg, "hparas": {}, "decode": decode_cfg}
        (d / "cfg.yaml").write_text(yaml.safe_dump(cfg))
        torch.save({"model": asr_state_dict(model), "global_step": 0},
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
        emit({"phase": name, "rows": len(rows), "seconds": dt,
              "decode": decode_cfg, "text_mode": text["mode"],
              "first_row_chars": len(rows[0]),
              "stderr_tail": proc.stderr.strip().splitlines()[-1:]})


TRAIN_HPARAS = {"optimizer": "Adadelta", "lr": 1.0, "eps": 1e-8,
                "lr_scheduler": "fixed", "tf_start": 0.9, "tf_end": 0.9,
                "tf_step": 1, "GRAD_CLIP": 5.0}
U_TRAIN = 96


def train_batch(batch, seed, device, U=U_TRAIN, V=3 + len(CHARS)):
    """make_waves' waves with labels in [3, V), lengths proportional to
    each wave's length (the longest U), padded to U."""
    import torch
    w, wl = make_waves(batch, seed)
    rng = np.random.RandomState(seed)
    lab_len = np.maximum(1, np.round(U * wl / wl.max())).astype(np.int64)
    text = rng.randint(3, V, size=(batch, U)).astype(np.int64)
    text[np.arange(U)[None, :] >= lab_len[:, None]] = 0
    return tuple(torch.from_numpy(a).to(device) for a in (w, wl, text, lab_len))


def make_solver(device, seed, workdir, model_cfg=MODEL_CFG, amp=False,
                augment=None):
    """The port's training solver with bench.py's model at full width
    (random weights from ``seed``; ``hparas.amp`` as ``amp``;
    ``data.audio.augment`` as ``augment``), set up as ``train.py`` sets it
    up but without a corpus."""
    from types import SimpleNamespace
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_asr import Solver
    audio = dict(AUDIO_CFG, augment=augment) if augment else AUDIO_CFG
    cfg = {"data": {"corpus": {"name": "none"}, "audio": audio,
                    "text": {"mode": "character"}},
           "model": model_cfg, "hparas": dict(TRAIN_HPARAS, amp=amp)}
    paras = SimpleNamespace(config="smoke_train.yaml", name=None, seed=seed,
                            logdir=str(workdir / "log"),
                            ckpdir=str(workdir / "ckpt"), load=None,
                            njobs=0, no_msg=True, cpu=device.type == "cpu")
    solver = Solver(cfg, paras)
    solver.feat_dim, solver.vocab_size = AUDIO_CFG["feat_dim"], 3 + len(CHARS)
    solver.set_model()
    return solver


def launch_counters():
    """Every kernel wrapper, by name; each counts its own launches."""
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import (
        att_kernel, att_train_kernel, beam_step_kernel, ctc_kernel,
        fbank_kernel, gru_kernel, lstm_kernel, psi_kernel)
    return {"fbank_fused": fbank_kernel.fbank_fused,
            "lstm_scan_fused": lstm_kernel.lstm_scan_fused,
            "lstm_scan_bf16": lstm_kernel.lstm_scan_bf16,
            "psi_fused": psi_kernel.psi_fused,
            "lstm_bwd_fused": lstm_kernel.lstm_bwd_fused,
            "ctc_loss_fused": ctc_kernel.ctc_loss_fused,
            "loc_attention_fused": att_kernel.loc_attention_fused,
            "loc_att_fwd_fused": att_train_kernel.loc_att_fwd_fused,
            "loc_att_bwd_fused": att_train_kernel.loc_att_bwd_fused,
            "loc_att_fwd_bf16": att_train_kernel.loc_att_fwd_bf16,
            "loc_att_bwd_bf16": att_train_kernel.loc_att_bwd_bf16,
            "gru_scan_fused": gru_kernel.gru_scan_fused,
            "gru_scan_bf16": gru_kernel.gru_scan_bf16,
            "gru_bwd_fused": gru_kernel.gru_bwd_fused,
            "lstm_train_bf16": lstm_kernel.lstm_train_bf16,
            "lstm_bwd_bf16": lstm_kernel.lstm_bwd_bf16,
            "gru_train_bf16": gru_kernel.gru_train_bf16,
            "gru_bwd_bf16": gru_kernel.gru_bwd_bf16,
            "beam_step_fused": beam_step_kernel.beam_step_fused}


def phase_train(batch, seed, device, name="train", model_cfg=MODEL_CFG,
                n_steps=5, amp=False, augment=None, breakdown=True):
    """Training steps of bench.py's model at full width (the train main
    path; ``amp``: ``hparas.amp``, the scans through their bf16 training
    variants): one warm-up step, ``n_steps`` timed steps with the kernels
    and their launch counts per step, one profiled step, and one step from
    the same weights and generator with the kernels and with the plain
    versions, compared (at tf 1.0: loss rel 1e-4 and every gradient within
    1e-3 of its max magnitude; under amp, where a one-ulp difference of a
    bf16 value moves the sums after it, rel 1e-3 and 1e-2; with the
    embedding plugin the total loss and emb_loss within rel 1e-5).
    ``augment``: SpecAugment's masks of the last step are checked against
    their bounds (``check_masks``). ``breakdown``: whether the profiled
    step is taken."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        solver = make_solver(device, seed, Path(d), model_cfg, amp, augment)
    data = train_batch(batch, seed + 6, device)
    enc = model_cfg["encoder"]
    n_scans = len(enc["dim"]) * (2 if enc["bidirection"] else 1)
    k7 = data[2].shape[1] if solver.model.attention.use_pallas_train else 0
    scan = enc["module"].lower()                   # lstm or gru
    calls = scan_calls(batch)
    per_step = {k: 0 for k in launch_counters()}
    scans = ((f"{scan}_train_bf16", f"{scan}_bwd_bf16") if amp else
             (f"{scan}_scan_fused", f"{scan}_bwd_fused"))
    att = ("loc_att_fwd_bf16", "loc_att_bwd_bf16") if amp else (
        "loc_att_fwd_fused", "loc_att_bwd_fused")
    per_step.update({"fbank_fused": 1, "ctc_loss_fused": 1,
                     **{k: k7 for k in att},
                     **{k: n_scans * calls[k] for k in scans}})
    solver.train_step(*data)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    steps = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        m = solver.train_step(*data)
        steps.append({k: fn.launches for k, fn in counters.items()})
        for fn in counters.values():
            fn.launches = 0
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    check(all(st == per_step for st in steps),
          f"every train step must launch {per_step}, got {steps}")
    launches = {k: sum(st[k] for st in steps) for k in per_step}
    metrics = {k: float(v) for k, v in m.items()}
    check(all(math.isfinite(v) for v in metrics.values()),
          f"non-finite train metrics {metrics}")
    if augment:
        check_masks(solver, data, name)
    emit({"phase": name, "batch": batch, "secs": SECS, "labels": U_TRAIN,
          "amp": solver.amp, "card": CARD,
          "steps": n_steps, "ms_per_step": dt * 1e3, "utts_per_s": batch / dt,
          "launches_per_step": {k: n / n_steps for k, n in launches.items()},
          "metrics_last_step": metrics,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if breakdown:
        train_breakdown(solver, data, name)
    compare = {tf: train_compare(solver, data, tf, cuda_kernels)
               for tf in (1.0, TRAIN_HPARAS["tf_start"])}
    emit({"phase": f"{name}_compare",
          **{f"tf_{k}": v for k, v in compare.items()}})
    c = compare[1.0]
    loss_tol, grad_tol = (1e-3, 1e-2) if amp else (1e-4, 1e-3)
    if solver.plugin is not None:
        loss_tol = 1e-5
        check(c["emb_rel_diff"] <= 1e-5,
              f"emb_loss kernel vs plain rel diff {c['emb_rel_diff']}")
    check(c["loss_rel_diff"] <= loss_tol,
          f"train loss kernel vs plain rel diff {c['loss_rel_diff']}")
    check(c["worst_grad_err_over_max"] <= grad_tol,
          f"train gradient kernel vs plain {c['worst_grad']}: "
          f"{c['worst_grad_err_over_max']}")
    return launches


# SpecAugment with the JAX package's defaults written out (an empty
# augment block turns it off there and here)
AUG_CFG = {"freq_mask_n": 2, "freq_mask_width": 27, "time_mask_n": 2,
           "time_mask_width": 40, "time_mask_ratio": 0.2}


def check_masks(solver, data, name):
    """The last step's SpecAugment masks within the JAX draws' bounds, and
    the share of the valid (frame, bin) entries they zero."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.augment import (
        apply_masks, mask_params, max_time_width)
    m = solver.last_masks
    with torch.no_grad():
        feat, flen = solver.frontend(data[0], data[1])
    B, T, F = feat.shape
    fn, fw, tn, tw, ratio = mask_params(solver.aug_cfg, F)
    cap = max_time_width(flen, ratio, tn)[:, None]
    ok = {"freq_width": bool(((m.freq_width >= 0)
                              & (m.freq_width <= fw)).all()),
          "freq_start": bool(((m.freq_start >= 0) & (m.freq_start < torch.clamp(
              F - m.freq_width, min=1))).all()),
          "time_width": bool(((m.time_width >= 0) & (m.time_width <= tw)
                              & (m.time_width <= cap)).all()),
          "time_start": bool(((m.time_start >= 0) & (m.time_start < torch.clamp(
              flen[:, None] - m.time_width, min=1))).all())}
    check(all(ok.values()) and m.freq_width.shape == (B, fn)
          and m.time_width.shape == (B, tn), f"{name}: masks out of bounds {ok}")
    valid = (torch.arange(T, device=flen.device)[None, :] < flen[:, None])
    kept = apply_masks(torch.ones_like(feat), m) * valid[..., None]
    share = 1.0 - float(kept.sum()) / float(valid.sum() * F)
    emit({"phase": f"{name}_masks", "masked_share_of_valid_bins": share,
          "freq_width_mean": float(m.freq_width.float().mean()),
          "time_width_mean": float(m.time_width.float().mean()),
          "bounds_ok": ok})


TRAIN_RANGES = ("train.frontend", "asr.encode", "asr.ctc_head",
                "asr.label_scan", "train.loss", "train.backward",
                "train.optimizer")


def train_breakdown(solver, data, name, ranges=TRAIN_RANGES, **fields):
    """One profiled kernel-path step: the host-clock span of each profiler
    range of ``Solver.train_step`` (``ranges``: the ASR step's and
    ``ASR.forward``'s, or the LM step's; the step enqueues work without
    synchronising, so a span is host time), the device busy / idle share,
    device launches and the largest device ops. Returns the step's
    ``kernel_device_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # idle margins around the step: a device-bound step's first
        # kernels went missing from traces taken late in a whole run
        torch.cuda.synchronize()
        time.sleep(0.1)
        t0 = time.perf_counter()
        solver.train_step(*data)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.1)
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    avgs = prof.key_averages()
    host = {e.key: e.cpu_time_total / 1e3 for e in avgs
            if e.key in ranges and e.device_type == DeviceType.CPU}
    check(set(host) == set(ranges),
          f"profiled step lacks ranges {set(ranges) - set(host)}")
    # device-side events only (kernels, copies): an operator's own row
    # repeats the time of the kernels it launched, and a range's device
    # annotation spans the kernels inside it
    evts = [e for e in avgs
            if e.device_type == DeviceType.CUDA and dev(e) > 0
            and e.key not in ranges
            and not getattr(e, "is_user_annotation", False)]
    check(len(evts) > 0, "the profiler recorded no device time")
    busy_ms = sum(dev(e) for e in evts) / 1e3
    top = {}
    for e in evts:
        top[e.key[:90]] = top.get(e.key[:90], 0.0) + dev(e) / 1e3
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:10])
    kdm = kernel_device_ms(evts, dev)
    emit({"phase": f"{name}_breakdown", **fields,
          "host_ms": {k: host[k] for k in ranges},
          "host_ranges_sum_ms": sum(host.values()),
          "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / prof_ms,
          "device_kernel_launches": sum(e.count for e in evts),
          "top_device_ms": top, "kernel_device_ms": kdm})
    return kdm


def train_compare(solver, data, tf_rate, cuda_kernels):
    """One step's loss and raw gradients with the kernels and with their
    plain versions, from the same weights, optimizer state and generator
    state (the weights are restored after each)."""
    import torch
    saved = {k: v.detach().clone() for k, v in solver.params.items()}
    opt_state = (solver.optimizer.count.clone(),
                 {n: {s: v.clone() for s, v in d.items()}
                  for n, d in solver.optimizer.slots.items()})
    gen_state = solver.gen.get_state()
    tf = (solver.tf_start, solver.tf_end)
    solver.tf_start = solver.tf_end = tf_rate
    out = []
    try:
        for use in (True, False):
            cuda_kernels.USE_KERNELS = use
            solver.gen.set_state(gen_state)
            m = solver.train_step(*data)
            out.append((float(m["loss"]), {k: p.grad.detach().clone()
                                           for k, p in solver.params.items()},
                        float(m.get("emb_loss", float("nan")))))
            with torch.no_grad():
                for k, p in solver.params.items():
                    p.copy_(saved[k])
            solver.optimizer.count = opt_state[0].clone()
            solver.optimizer.slots = {n: {s: v.clone() for s, v in d.items()}
                                      for n, d in opt_state[1].items()}
    finally:
        cuda_kernels.USE_KERNELS = True
        solver.tf_start, solver.tf_end = tf
    (lk, gk, ek), (lp, gp, ep) = out
    bad = [k for k, g in gk.items()
           if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    check(not bad, f"kernel-path gradients not finite or all zero: {bad[:5]}")
    errs = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max())
            for k in gk}
    worst = max(errs, key=errs.get)
    emb = ({} if math.isnan(ep) else
           {"emb_loss_kernel": ek, "emb_loss_plain": ep,
            "emb_rel_diff": abs(ek - ep) / abs(ep)})
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel_diff": abs(lk - lp) / abs(lp), **emb,
            "worst_grad": worst, "worst_grad_err_over_max": errs[worst],
            "grads_err_over_max_top5": dict(sorted(
                errs.items(), key=lambda kv: -kv[1])[:5]),
            "n_params": len(gk)}


def slice_models(frontend, seed, vocab=V_CHAR, device="cuda",
                 model_cfg=MODEL_CFG, lm_cfg=LM_CFG):
    """bench.py's model and LM with random weights from ``seed``, as
    phase_slice makes them."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
    from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM
    g = torch.Generator().manual_seed(seed)
    model = ASR(frontend.feat_dim, vocab, model_cfg, generator=g,
                device=device)
    return model, RNNLM(vocab, lm_cfg, generator=g, device=device)


def read_test_csvs(out):
    """(best hypotheses {idx: hyp}, best scores {idx: score}, rows) of one
    split's CSVs."""
    best = dict(ln.split("\t")[:2] for ln in
                out["output"].strip().split("\n")[1:])
    rows = [ln.split("\t") for ln in out["beam"].strip().split("\n")[1:]]
    return best, {r[0]: float(r[2]) for r in rows if r[1] == "0"}, len(rows)


def phase_test_entry(model, lm, seed, n_utts=32):
    """python -m end_to_end_asr_pytorch_tpu_torch.main --test on a generated
    synthetic corpus (n_utts dev and n_utts test utterances) with ``model``
    as a reference-layout ASR checkpoint and ``lm`` as a reference-layout
    LM checkpoint (LM fusion 0.3, CTC 0.3, beam 8, batch n_utts, amp off),
    once as configured by default (K8) and once with decode.fused_step
    false, the two at once: the fused run must name
    the fused route and count K8 launches; both write one row per
    utterance; their hypotheses and best scores are compared."""
    import re
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import (
        asr_state_dict, lm_state_dict)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        corpus = generate_corpus(str(d / "synth"), n_train=0, n_dev=n_utts,
                                 n_test=n_utts, seed=seed)
        (d / "vocab.txt").write_text("\n".join(CHARS) + "\n")
        data = {"corpus": {"name": "synthetic", "path": str(corpus),
                           "dev_split": ["dev-clean"],
                           "test_split": ["test-clean"], "batch_size": n_utts},
                "audio": AUDIO_CFG,
                "text": {"mode": "character", "vocab_file": str(d / "vocab.txt")}}
        (d / "lm.yaml").write_text(yaml.safe_dump(
            {"data": {k: data[k] for k in ("corpus", "text")}, "model": LM_CFG,
             "hparas": {}}))
        torch.save({"model": asr_state_dict(model), "global_step": 0},
                   str(d / "asr.pth"))
        torch.save({"model": lm_state_dict(lm)}, str(d / "lm.pth"))
        for name, cfg in (("fused", DECODE_CFG), ("unfused", UNFUSED_CFG)):
            decode = {**cfg, "lm_config": str(d / "lm.yaml"),
                      "lm_path": str(d / "lm.pth")}
            (d / f"{name}.yaml").write_text(yaml.safe_dump(
                {"data": data, "model": MODEL_CFG, "hparas": {},
                 "decode": decode}))
        # the two runs at once (seconds: from their common start)
        outs = run_mains([(name, [], [
            "--config", str(d / f"{name}.yaml"), "--test", "--load",
            str(d / "asr.pth"), "--outdir", str(d / "out"), "--seed",
            str(seed)]) for name in ("fused", "unfused")])
        runs = {}
        for fused in (True, False):
            name = "fused" if fused else "unfused"
            stdout, secs = outs[name]
            summary = [ln for ln in stdout.splitlines()
                       if re.match(r"\[INFO\] (dev|test): ", ln)]
            check(len(summary) == 2, f"main --test ({name}) summary lines: "
                  f"{stdout[-2000:]}")
            k8 = [int(m) for ln in summary
                  for m in re.findall(r"K8 launches (\d+)", ln)]
            route = "beam fused" if fused else "beam unfused"
            check(all(f"| {route} " in ln for ln in summary) and len(k8) == 2
                  and (all(n > 0 for n in k8) if fused else k8 == [0, 0]),
                  f"main --test ({name}) route: {summary}")
            out = d / "out" / f"{name}_sd{seed}"
            splits = {}
            for split in ("dev", "test"):
                files = {kind: (out / f"{split}_{kind}.csv").read_text()
                         for kind in ("output", "beam")}
                best, scores, n_beam = read_test_csvs(files)
                check(len(best) == n_utts and n_beam == 8 * n_utts,
                      f"main --test ({name}) {split}: {len(best)} rows, "
                      f"{n_beam} n-best rows")
                splits[split] = (best, scores)
            runs[name] = {"seconds": secs, "k8_launches": k8,
                          "summary": summary, "splits": splits}
        same = diff = 0.0
        for split in ("dev", "test"):
            (bf, sf), (bu, su) = (runs["fused"]["splits"][split],
                                  runs["unfused"]["splits"][split])
            same += sum(bf[k] == bu[k] for k in bf) / (2 * n_utts)
            diff = max(diff, max(abs(sf[k] - su[k]) for k in sf))
        check(diff <= 1e-2, f"test_entry: fused vs unfused best score {diff}")
        emit({"phase": "test_entry", "utts_per_split": n_utts,
              "seconds": {k: v["seconds"] for k, v in runs.items()},
              "k8_launches": runs["fused"]["k8_launches"],
              "hyp_identical_share_fused_vs_unfused": same,
              "best_score_max_abs_diff_fused_vs_unfused": diff,
              "summary_fused": runs["fused"]["summary"],
              "summary_unfused": runs["unfused"]["summary"]})


def phase_train_entry(seed):
    """python -m end_to_end_asr_pytorch_tpu_torch.train on a generated
    synthetic corpus with bench.py's model (4 steps, validation every 2),
    then the port's transcribe on two dev WAVs with its latest.pth."""
    import yaml
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        corpus = generate_corpus(str(d / "synth"), n_train=32, n_dev=8,
                                 n_test=0, seed=seed)
        cfg = {"data": {"corpus": {"name": "synthetic", "path": str(corpus),
                                   "train_split": ["train-clean"],
                                   "dev_split": ["dev-clean"],
                                   "bucketing": True, "batch_size": 16},
                        "audio": dict(AUDIO_CFG, frame_length=25, frame_shift=10,
                                      delta_order=0),
                        "text": {"mode": "character",
                                 "vocab_file": str(corpus / "vocab.txt")}},
               "model": MODEL_CFG,
               "hparas": {"curriculum": 0, "valid_step": 2, "max_step": 4,
                          "optimizer": "Adadelta", "lr": 1.0, "eps": 1e-8,
                          "lr_scheduler": "fixed", "tf_start": 1.0,
                          "tf_end": 0.9, "tf_step": 4, "PROGRESS_STEP": 1},
               "decode": {k: v for k, v in DECODE_CFG.items()
                          if k != "lm_weight"}}
        (d / "las.yaml").write_text(yaml.safe_dump(cfg))
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "end_to_end_asr_pytorch_tpu_torch.train",
             "--config", str(d / "las.yaml"), "--seed", str(seed),
             "--logdir", str(d / "log"), "--ckpdir", str(d / "ckpt")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        train_s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"train exited {proc.returncode}: {proc.stderr[-2000:]}")
        exp = f"las_sd{seed}"
        ckpt = d / "ckpt" / exp / "latest.pth"
        check(ckpt.exists(), f"train wrote no {ckpt}")
        log = [json.loads(ln) for ln in
               (d / "log" / exp / "log.jsonl").read_text().splitlines()]
        losses = [v for e in log if e["name"] == "loss"
                  for v in e["value"].values()]
        check(len(losses) > 0 and all(math.isfinite(v) for v in losses),
              f"logged losses {losses}")
        wavs = sorted(str(p) for p in (corpus / "dev-clean").rglob("*.wav"))[:2]
        t0 = time.perf_counter()
        proc2 = subprocess.run(
            [sys.executable, "-m", "end_to_end_asr_pytorch_tpu_torch.transcribe",
             "--config", str(d / "las.yaml"), "--load", str(ckpt),
             "--output", str(d / "out.tsv"), *wavs],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        check(proc2.returncode == 0,
              f"transcribe exited {proc2.returncode}: {proc2.stderr[-2000:]}")
        rows = (d / "out.tsv").read_text().strip().split("\n")
        check(len(rows) == 2 and all("\t" in r for r in rows),
              f"transcribe TSV rows: {rows!r}")
        # a short amp run (--amp) with attention.use_pallas_train: two
        # steps through K7's bf16 variant, validation (f32, as the JAX
        # solver validates) at the second
        cfg["hparas"].update(max_step=2, valid_step=2)
        cfg["model"] = with_attention(use_pallas_train=True)
        (d / "amp.yaml").write_text(yaml.safe_dump(cfg))
        t0 = time.perf_counter()
        proc3 = subprocess.run(
            [sys.executable, "-m", "end_to_end_asr_pytorch_tpu_torch.train",
             "--config", str(d / "amp.yaml"), "--amp", "--seed", str(seed),
             "--logdir", str(d / "log"), "--ckpdir", str(d / "ckpt")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        amp_s = time.perf_counter() - t0
        check(proc3.returncode == 0,
              f"train --amp exited {proc3.returncode}: {proc3.stderr[-2000:]}")
        check("amp (bf16)" in proc3.stdout,
              f"train --amp did not train in bf16: {proc3.stdout[-2000:]}")
        import torch
        ck = torch.load(str(d / "ckpt" / f"amp_sd{seed}" / "latest.pth"),
                        weights_only=True)
        check(ck["global_step"] == 2 and all(
            v.dtype == torch.float32 for v in ck["model"].values()
            if torch.is_tensor(v) and v.is_floating_point()),
            "train --amp checkpoint: not 2 steps of f32 weights")
        amp_log = [json.loads(ln) for ln in
                   (d / "log" / f"amp_sd{seed}" / "log.jsonl").read_text()
                   .splitlines()]
        amp_losses = [v for e in amp_log if e["name"] == "loss"
                      for v in e["value"].values()]
        check(len(amp_losses) > 0 and all(math.isfinite(v)
                                          for v in amp_losses),
              f"train --amp logged losses {amp_losses}")
        emit({"phase": "train_entry", "train_seconds": train_s,
              "amp_train_seconds": amp_s,
              "amp_last_losses": [e["value"] for e in amp_log
                                  if e["name"] == "loss"][-2:],
              "transcribe_seconds": time.perf_counter() - t0,
              "steps_logged": sorted({e["step"] for e in log}),
              "last_losses": [e["value"] for e in log if e["name"] == "loss"][-2:],
              "train_stdout_tail": proc.stdout.strip().splitlines()[-2:],
              "rows": len(rows)})


def phase_options_entry(seed, n_utts=16):
    """The options of this slice through the entry points on a generated
    corpus (32 train, n_utts dev and test utterances, V=31): the hash
    table from ``python -m ...utils.bert_embedding --method hash``, ``main``
    2 steps of bench.py's model with SpecAugment (AUG_CFG) and the
    embedding plugin (weight 1.0, fuse 0.3), then ``main --test`` from its
    latest.pth with the plugin fused, psi_quant int8, ctc_candidates 8 and
    amp auto (bf16 on the card): one row per utterance, the unfused route
    (K8's scope ends at plugin fusion)."""
    import re
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        corpus = generate_corpus(str(d / "synth"), n_train=32, n_dev=n_utts,
                                 n_test=n_utts, seed=seed)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "end_to_end_asr_pytorch_tpu_torch.utils.bert_embedding",
             "--vocab_file", str(corpus / "vocab.txt"), "--mode", "character",
             "--output", str(d / "emb.npy"), "--method", "hash", "--dim",
             "256"], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0, f"bert_embedding exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        table_s = time.perf_counter() - t0
        cfg = {"data": {"corpus": {"name": "synthetic", "path": str(corpus),
                                   "train_split": ["train-clean"],
                                   "dev_split": ["dev-clean"],
                                   "test_split": ["test-clean"],
                                   "batch_size": n_utts},
                        "audio": dict(AUDIO_CFG, augment=AUG_CFG),
                        "text": {"mode": "character",
                                 "vocab_file": str(corpus / "vocab.txt")}},
               "model": {**MODEL_CFG, "plugin": {
                   "src": str(d / "emb.npy"), "weight": 1.0, "fuse": 0.3,
                   "temp": 1.0}},
               "hparas": {"valid_step": 2, "max_step": 2, "PROGRESS_STEP": 1,
                          **TRAIN_HPARAS},
               "decode": {**{k: v for k, v in DECODE_CFG.items()
                             if k not in ("lm_weight", "amp")},
                          "psi_quant": "int8", "ctc_candidates": 8}}
        (d / "opts.yaml").write_text(yaml.safe_dump(cfg))
        _, train_s = run_main(["--config", str(d / "opts.yaml"), "--seed",
                               str(seed), "--logdir", str(d / "log"),
                               "--ckpdir", str(d / "ckpt")],
                              "main (augment, plugin)")
        ckpt = d / "ckpt" / f"opts_sd{seed}" / "latest.pth"
        ck = torch.load(str(ckpt), weights_only=True)
        check(ck["global_step"] == 2
              and tuple(ck["model"]["plugin.w_proj"].shape) == (256, 512),
              "main (augment, plugin): latest.pth lacks 2 steps or the plugin")
        log = [json.loads(ln) for ln in (d / "log" / f"opts_sd{seed}" /
                                         "log.jsonl").read_text().splitlines()]
        emb = [e["value"]["tr_emb_loss"] for e in log
               if e["name"] == "loss" and "tr_emb_loss" in e["value"]]
        check(len(emb) > 0 and all(math.isfinite(v) for v in emb),
              f"main (augment, plugin): emb_loss {emb}")
        stdout, test_s = run_main(["--config", str(d / "opts.yaml"), "--test",
                                   "--load", str(ckpt), "--outdir",
                                   str(d / "out"), "--seed", str(seed)],
                                  "main --test (plugin, psi_quant, candidates)")
        summary = [ln for ln in stdout.splitlines()
                   if re.match(r"\[INFO\] (dev|test): ", ln)]
        check(len(summary) == 2 and all("| beam unfused (K8 launches 0)" in ln
                                        for ln in summary),
              f"main --test (options) summary: {summary}")
        out = d / "out" / f"opts_sd{seed}"
        rows = {}
        for split in ("dev", "test"):
            best, _, n_beam = read_test_csvs(
                {kind: (out / f"{split}_{kind}.csv").read_text()
                 for kind in ("output", "beam")})
            check(len(best) == n_utts and n_beam == 8 * n_utts,
                  f"main --test (options) {split}: {len(best)} rows")
            rows[split] = len(best)
        emit({"phase": "options_entry", "table_seconds": table_s,
              "train_seconds": train_s, "test_seconds": test_s,
              "emb_losses": emb, "rows": rows, "summary": summary,
              "card": CARD})


TRAINED_MAX_STEP = 4000
TRAINED_BUDGET_S = 50.0     # wall seconds of training steps
TRAINED_ROUTES = {          # name: (decode.amp, attention.use_pallas, kernels)
    "default": ("auto", False, True),        # amp auto = bf16: K2-bf16
    "default_plain": ("auto", False, False),
    "k8": (False, False, True),              # f32: K2, K8 a beam step
    "k5": (False, True, True),               # f32: K2, K5 and K8 a step
    "plain": (False, False, False)}          # f32, every plain version
TRAINED_EXPECT = {"default": ("fbank_fused", "lstm_scan_bf16"),
                  "k8": ("fbank_fused", "lstm_scan_fused", "beam_step_fused"),
                  "k5": ("fbank_fused", "lstm_scan_fused", "beam_step_fused",
                         "loc_attention_fused")}


def trained_events(logdir, align_shape, n_examples):
    """Every event file under ``logdir`` read back through the port's own
    reader (each record's CRCs checked): {tag: [(step, value)]} with the
    scalars' values, the texts and each image's PNG size; each ``align_i``
    must be a PNG of the alignment's (T', U), its IHDR as its summary
    says."""
    from end_to_end_asr_pytorch_tpu_torch.utils.png import png_size
    from end_to_end_asr_pytorch_tpu_torch.utils.tensorboard import read_events
    tags, files = {}, sorted(Path(logdir).rglob("events.out.tfevents.*"))
    for f in files:
        run = str(f.parent.relative_to(logdir))
        for ev in read_events(f):
            for v in ev.get("values", []):
                tag = v["tag"] if run == "." else f"{v['tag']}:{run}"
                if "image" in v:
                    im = v["image"]
                    hw = png_size(im["png"])
                    check(hw == (im["height"], im["width"]) == align_shape,
                          f"{tag} at step {ev['step']}: PNG {hw}, summary "
                          f"{im['height']}x{im['width']}, alignment "
                          f"{align_shape}")
                    val = hw
                else:
                    val = v.get("simple_value",
                                v.get("tensor", {}).get("string_val"))
                tags.setdefault(tag, []).append((ev["step"], val))
    main_tags = {t.split(":")[0].split("/")[0] for t in tags}
    want = {"loss", "speed", "tf_rate", "wer", "cer"} | {
        f"{k}_{i}" for k in ("hyp", "ref", "align") for i in range(n_examples)}
    check(want <= main_tags, f"event files lack tags {want - main_tags}")
    return tags, len(files)


def trained_top1(a, b):
    """Two routes' beam outputs over the same batches: the share of rows
    with identical top-1 tokens, the largest best-score gap, and each row
    whose top-1 differs with its gap (those above 1e-3: not near ties)."""
    import torch
    gaps, differ = [], []
    for oa, ob in zip(a, b):
        for i in range(oa.scores.shape[0]):
            gap = float((oa.scores[i, 0] - ob.scores[i, 0]).abs())
            if not (bool(oa.lengths[i, 0] == ob.lengths[i, 0])
                    and torch.equal(oa.tokens[i, 0, :oa.lengths[i, 0]],
                                    ob.tokens[i, 0, :ob.lengths[i, 0]])):
                differ.append([len(gaps), gap])
            gaps.append(gap)
    return {"top1_identical_share": 1.0 - len(differ) / len(gaps),
            "best_score_max_abs_diff": max(gaps), "rows_differing": differ,
            "not_near_ties": [r for r in differ if r[1] > 1e-3]}


def phase_trained_entry(seed, budget_s=TRAINED_BUDGET_S):
    """The experiment's chain on trained weights: the corpus CLI, main
    --config training with TensorBoard events and orbax checkpoints, main
    --test on the trained best_att.pth/ through four routes, one test
    batch profiled (see the module docstring)."""
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch import main as port_main
    from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
    from end_to_end_asr_pytorch_tpu_torch.solvers import test_asr, train_asr
    from end_to_end_asr_pytorch_tpu_torch.utils import profiler
    from end_to_end_asr_pytorch_tpu_torch.utils.orbax import read_orbax
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "end_to_end_asr_pytorch_tpu_torch.data.make_synthetic",
             "--out", str(d / "synth"), "--n_train", "512", "--n_dev", "64",
             "--n_test", "64", "--seed", str(seed)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        corpus_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"make_synthetic exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        cfg = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
        cfg["data"]["corpus"]["path"] = str(d / "synth")
        cfg["data"]["text"]["vocab_file"] = str(d / "synth" / "vocab.txt")
        cfg["hparas"]["max_step"] = TRAINED_MAX_STEP
        cfg["ckpt_format"] = "orbax"
        (d / "las.yaml").write_text(yaml.safe_dump(cfg))
        exp = f"las_sd{seed}"
        # the wall budget: past it, the step in hand is the last one (the
        # loop then validates and saves, as it does at max_step)
        train_step, valid_batch = (train_asr.Solver.train_step,
                                   train_asr.Solver.valid_batch)
        deadline, align_shapes = [], []

        def budgeted(self, *a, **k):
            if not deadline:
                deadline.append(time.perf_counter() + budget_s)
            m = train_step(self, *a, **k)
            if time.perf_counter() > deadline[0]:
                self.max_step = self.step + 1
            return m

        def recorded(self, *a, **k):
            out = valid_batch(self, *a, **k)
            align_shapes.append(tuple(out["att_align"].shape))
            return out

        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        train_asr.Solver.train_step = budgeted
        train_asr.Solver.valid_batch = recorded
        t0 = time.perf_counter()
        try:
            best = port_main.main(["--config", str(d / "las.yaml"), "--seed",
                                   str(seed), "--logdir", str(d / "log"),
                                   "--ckpdir", str(d / "ckpt")])
        finally:
            train_asr.Solver.train_step = train_step
            train_asr.Solver.valid_batch = valid_batch
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = {k: fn.launches for k, fn in counters.items()
                          if fn.launches}
        for k in ("fbank_fused", "lstm_scan_fused", "lstm_bwd_fused",
                  "ctc_loss_fused"):
            check(train_launches.get(k, 0) > 0,
                  f"trained_entry: training launched no {k}: "
                  f"{train_launches}")
        ckpts = {}
        for name in ("best_att.pth", "best_ctc.pth", "latest.pth"):
            p = d / "ckpt" / exp / name
            check(p.is_dir() and (p / "meta.json").is_file()
                  and (p / "model" / "_METADATA").is_file()
                  and (p / "optimizer" / "_METADATA").is_file(),
                  f"{p} is not a complete orbax directory")
            ck = read_orbax(p)
            ckpts[name] = {"global_step": ck["global_step"],
                           "metrics": ck["metrics"],
                           "leaves": len(ck["model"]),
                           "bytes": sum(f.stat().st_size
                                        for f in p.rglob("*") if f.is_file())}
        steps = ckpts["latest.pth"]["global_step"]
        # U and T' of the first dev batch, the one the figures come from
        _, u, _, t_enc = align_shapes[0]
        tags, n_files = trained_events(d / "log" / exp, (t_enc, u), 4)
        dev_cer = {h: tags[f"cer:cer/dv_{h}"][-1][1] for h in ("att", "ctc")}
        dev_wer = {h: tags[f"wer:wer/dv_{h}"][-1][1] for h in ("att", "ctc")}
        emit({"phase": "trained_train", "steps": steps,
              "budget_s": budget_s, "train_seconds": train_s,
              "corpus_seconds": corpus_s,
              "steps_per_s": steps / train_s, "dev_cer": dev_cer,
              "dev_wer": dev_wer, "best_wer": best,
              "checkpoints": ckpts, "event_files": n_files,
              "tags": {t: len(v) for t, v in sorted(tags.items())},
              "align_png": [t_enc, u], "launches": train_launches,
              "card": CARD})

        # main --test's Solver on best_att.pth/, each route in turn
        outs, rates, routes = {}, {}, {}
        for name, (amp, pallas, kernels) in TRAINED_ROUTES.items():
            tcfg = {**cfg, "decode": {**cfg["decode"], "amp": amp,
                                      "lm_weight": 0.0}}
            tcfg["model"] = {**cfg["model"], "attention": {
                **cfg["model"]["attention"], "use_pallas": pallas}}
            (d / f"{name}.yaml").write_text(yaml.safe_dump(tcfg))
            paras = port_main.build_parser().parse_args(
                ["--config", str(d / f"{name}.yaml"), "--test", "--load",
                 str(d / "ckpt" / exp / "best_att.pth"), "--outdir",
                 str(d / "out"), "--seed", str(seed), "--no-msg"])
            solver = test_asr.Solver(tcfg, paras)
            solver.load_data()
            solver.set_model()
            forward, got = solver.decoder.forward, []

            def capture(*a, _f=forward, _got=got, **k):
                out = _f(*a, **k)
                _got.append(out)
                return out

            solver.decoder.forward = capture
            cuda_kernels.USE_KERNELS = kernels
            for fn in counters.values():
                fn.launches = 0
            try:
                t0 = time.perf_counter()
                with torch.no_grad():
                    rates[name] = solver._decode_set("test", solver.tt_set)
                torch.cuda.synchronize()
                rates[name]["seconds"] = time.perf_counter() - t0
            finally:
                cuda_kernels.USE_KERNELS = True
            launches = {k: fn.launches for k, fn in counters.items()
                        if fn.launches}
            for k in TRAINED_EXPECT.get(name, ()):
                check(launches.get(k, 0) > 0, f"trained_entry {name}: no "
                      f"{k} launch: {launches}")
            check(kernels or not launches,
                  f"trained_entry {name}: launches on the plain route "
                  f"{launches}")
            rates[name].update(launches=launches,
                               amp=solver.decoder.last_amp,
                               fused=solver.decoder.last_fused)
            outs[name] = got
            routes[name] = solver
        check(sum(o.scores.shape[0] for o in outs["plain"]) == 64,
              "trained_entry: the test split is not 64 utterances")
        rows = {}
        for name, ref in (("default", "default_plain"), ("default", "plain"),
                          ("default_plain", "plain"), ("k8", "plain"),
                          ("k5", "plain")):
            check(all(bool(torch.isfinite(o.scores[:, 0]).all())
                      for o in outs[name]), f"trained_entry {name}: top-1")
            cmp = trained_top1(outs[name], outs[ref])
            rows.setdefault(name, {})[f"vs_{ref}"] = cmp
            # a kernel route against its own plain route: compare_top1's
            # bound, as phase_slice holds it
            if name != "default_plain" and (name, ref) != ("default",
                                                           "plain"):
                check(cmp["best_score_max_abs_diff"] <= 1e-2,
                      f"trained_entry {name}: best score vs {ref} {cmp}")
        emit({"phase": "trained_test", "utts": 64,
              "routes": {k: {**rates[k], **rows.get(k, {})}
                         for k in TRAINED_ROUTES}, "card": CARD})

        # one test batch of the default route under the profiler
        solver = routes["default"]
        batch = next(iter(solver.tt_set))
        dev = solver.device
        wave = torch.from_numpy(batch["wave"]).to(dev)
        wave_len = torch.from_numpy(batch["wave_len"]).to(dev)

        def decode():
            with torch.no_grad():
                return solver.decoder.forward(*solver.frontend(wave,
                                                               wave_len))

        torch.cuda.reset_peak_memory_stats()
        with profiler.trace(str(d / "trace")) as trace_path:
            decode()
            torch.cuda.synchronize()
        bench = profiler.benchmark(decode, iters=5, warmup=1,
                                   batch_utts=int(wave.shape[0]),
                                   audio_seconds=float(wave_len.float().mean())
                                   / 16000.0)
        mem = profiler.device_memory()
        check(trace_path.is_file() and trace_path.stat().st_size > 0,
              "profiler.trace wrote no trace")
        with open(trace_path) as f:
            trace = json.load(f)
        kernels_in_trace = sum(1 for e in trace.get("traceEvents", [])
                               if e.get("cat") == "kernel")
        check(kernels_in_trace > 0, "the trace holds no kernel event")
        emit({"phase": "trained_profile", "batch": int(wave.shape[0]),
              "trace_bytes": trace_path.stat().st_size,
              "trace_kernel_events": kernels_in_trace, **bench,
              "device_memory": mem,
              "phase_seconds": time.perf_counter() - t_phase, "card": CARD})


JAX_ORBAX_FIXTURE = ROOT / "tests" / "fixtures" / "jax_orbax_las"
# the fixture's outputs against the JAX package's on the CPU, absolute:
# encoder output, CTC log-probs and the beam's best score (random weights
# leave near ties, so the top-1 tokens are counted, not required); an H100
# gave 3.1e-7, 4.8e-7 and 2.4e-7 on the kernel route, 3.6e-7, 4.8e-7 and
# 4.8e-7 on the plain route
JAX_ORBAX_TOL = {"enc": 1e-4, "ctc_log_probs": 1e-4, "best_score": 1e-4}
JAX_ORBAX_EXPECT = ("fbank_fused", "lstm_scan_fused", "loc_attention_fused",
                    "beam_step_fused")


def unpack(d):
    """An array that tests/make_jax_orbax_fixture.py packed."""
    import base64
    return np.frombuffer(base64.b64decode(d["b64"]),
                         np.dtype(d["dtype"])).reshape(d["shape"])


def cpu_name():
    """The host CPU as /proc/cpuinfo names it (vendor, family and model
    where the model name is withheld) and the cores this process sees."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            k, _, v = ln.partition(":")
            info.setdefault(k.strip(), v.strip())
            if not ln.strip():
                break
    name = info.get("model name", "unknown")
    if name in ("", "unknown"):
        name = (f"{info.get('vendor_id', '?')} family "
                f"{info.get('cpu family', '?')} model {info.get('model', '?')}"
                " (model name withheld)")
    return f"{name}, {len(os.sched_getaffinity(0))} cores"


def phase_jax_orbax_entry(seed):
    """A checkpoint the JAX package wrote (OCDBT, zstd; the committed
    fixture of tests/make_jax_orbax_fixture.py) through main --test's
    Solver on the card, held to the JAX package's outputs (module
    docstring)."""
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch import main as port_main
    from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
    from end_to_end_asr_pytorch_tpu_torch.solvers import test_asr
    from end_to_end_asr_pytorch_tpu_torch.utils import zstd
    from end_to_end_asr_pytorch_tpu_torch.utils.ocdbt import read_ocdbt
    from end_to_end_asr_pytorch_tpu_torch.utils.orbax import read_orbax
    t_phase = time.perf_counter()
    ref = json.loads((JAX_ORBAX_FIXTURE / "outputs.json").read_text())
    ckpt = JAX_ORBAX_FIXTURE / "best_att.pth"
    check((ckpt / "model" / "manifest.ocdbt").is_file(),
          f"{ckpt} is not an OCDBT directory")

    # the decoder on the fixture's chunks (host; the library built first)
    zstd.get_lib()
    t0 = time.perf_counter()
    ck = read_orbax(ckpt)
    read_s = time.perf_counter() - t0
    store = read_ocdbt(ckpt / "model")
    chunks = [v for k, v in store.items() if not k.endswith(b".zarray")]
    comp = sum(len(c) for c in chunks)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        raw = sum(len(zstd.decompress(c)) for c in chunks)
        times.append(time.perf_counter() - t0)
    dec_s = min(times)

    cfg = yaml.safe_load((ROOT / ref["config"]).read_text())
    cfg["decode"] = {**ref["decode"], "amp": False}
    cfg["model"]["attention"]["use_pallas"] = True       # K5 a beam step
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        (d / "las.yaml").write_text(yaml.safe_dump(cfg))
        paras = port_main.build_parser().parse_args(
            ["--config", str(d / "las.yaml"), "--test", "--load", str(ckpt),
             "--outdir", str(d / "out"), "--seed", str(seed), "--no-msg"])
        solver = test_asr.Solver(cfg, paras)
        solver.feat_dim, solver.vocab_size = ref["feat_dim"], ref["vocab_size"]
        solver.tokenizer = None
        solver.set_model()
    dev = solver.device
    wave = torch.from_numpy(unpack(ref["pcm16"]).astype(np.float32)
                            / 32768.0).to(dev)
    wave_len = torch.tensor(ref["wave_len"], dtype=torch.int32, device=dev)

    def run():
        with torch.no_grad():
            feat, feat_len = solver.frontend(wave, wave_len)
            enc, enc_len = solver.model.encode(feat, feat_len)
            lp = solver.model.ctc_output(enc)
            out = solver.decoder.forward(feat, feat_len)
        torch.cuda.synchronize()
        return enc, enc_len, lp, out

    def held(enc, enc_len, lp, out):
        check(enc_len.tolist() == ref["enc_len"],
              f"jax_orbax_entry: encoder lengths {enc_len.tolist()}, JAX "
              f"{ref['enc_len']}")
        errs = {"enc": 0.0, "ctc_log_probs": 0.0, "best_score": 0.0}
        same = 0
        for b, u in enumerate(ref["utts"]):
            n = ref["enc_len"][b]
            for key, got in (("enc", enc), ("ctc_log_probs", lp)):
                g = got[b, :n].float().cpu().numpy()
                check(np.isfinite(g).all(), f"jax_orbax_entry: {key} "
                      f"of utterance {b} not finite")
                errs[key] = max(errs[key], float(np.abs(g - unpack(u[key])
                                                        ).max()))
            errs["best_score"] = max(errs["best_score"], abs(
                float(out.scores[b, 0]) - u["beam_scores"][0]))
            L = int(out.lengths[b, 0])
            same += out.tokens[b, 0, :L].tolist() == u["beam_tokens"][0]
        return errs, same

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    enc, enc_len, lp, out = run()
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    for k in JAX_ORBAX_EXPECT:
        check(launches.get(k, 0) > 0, f"jax_orbax_entry: no {k} launch: "
              f"{launches}")
    errs, same = held(enc, enc_len, lp, out)
    cuda_kernels.USE_KERNELS = False
    try:
        plain_errs, plain_same = held(*run())
    finally:
        cuda_kernels.USE_KERNELS = True
    for key, tol in JAX_ORBAX_TOL.items():
        check(errs[key] <= tol, f"jax_orbax_entry: {key} differs from the "
              f"JAX package's by {errs[key]} (tolerance {tol})")
        check(plain_errs[key] <= tol, f"jax_orbax_entry: the plain route's "
              f"{key} differs from the JAX package's by {plain_errs[key]}")
    emit({"phase": "jax_orbax_entry", "leaves": len(ck["model"]),
          "global_step": ck["global_step"],
          "checkpoint_bytes": sum(f.stat().st_size for f in ckpt.rglob("*")
                                  if f.is_file()),
          "read_orbax_s": read_s, "zstd_chunks": len(chunks),
          "zstd_in_bytes": comp, "zstd_out_bytes": raw,
          "zstd_s": dec_s, "zstd_in_mb_s": comp / dec_s / 1e6,
          "zstd_out_mb_s": raw / dec_s / 1e6, "cpu": cpu_name(),
          "utts": len(ref["utts"]), "launches": launches,
          "max_abs_err": errs, "top1_identical": same,
          "plain_max_abs_err": plain_errs, "plain_top1_identical": plain_same,
          "tolerance": JAX_ORBAX_TOL, "run_s": run_s,
          "phase_seconds": time.perf_counter() - t_phase, "card": CARD})


JAX_RESUME_FIXTURE = ROOT / "tests" / "fixtures" / "jax_orbax_lm_resume"
JAX_RESUME_LM_TOL = 1e-4      # loss and leaf norms, relative
JAX_RESUME_ASR_TOL = 1e-5     # loss and parameters, relative
JAX_RESUME_ASR_B = 16


def resume_solver(kind, cfg, workdir, seed, load=None):
    """The port's training solver (``kind`` asr or lm) on ``cfg``, set up
    as ``main`` sets it up with ``--load load`` but without a corpus."""
    from types import SimpleNamespace
    from end_to_end_asr_pytorch_tpu_torch.solvers import train_asr, train_lm
    paras = SimpleNamespace(config=f"resume_{kind}.yaml", name=None,
                            seed=seed, logdir=str(workdir / "log"),
                            ckpdir=str(workdir / "ckpt"),
                            load=None if load is None else str(load),
                            njobs=0, no_msg=True, cpu=False, amp=False)
    if kind == "lm":
        solver = train_lm.Solver(cfg, paras)
        solver.vocab_size = V_CHAR
    else:
        solver = train_asr.Solver(cfg, paras)
        solver.feat_dim, solver.vocab_size = 40, V_CHAR
    solver.set_model()
    return solver


def resume_steps(solver, batches):
    """One train step a batch: the losses (synchronised at the end)."""
    import torch
    out = [solver.train_step(*b)["loss"] for b in batches]
    torch.cuda.synchronize()
    return [float(v) for v in out]


def rel_gaps(got, ref):
    """Each tensor's max |got - ref| over its max |ref|."""
    return {k: float((got[k].detach().float() - v.float()).abs().max()
                     / v.float().abs().max().clamp_min(1e-30))
            for k, v in ref.items()}


def phase_jax_resume_entry(seed):
    """Training resumed with the optimizer state: the JAX-written LM
    checkpoint of tests/fixtures/jax_orbax_lm_resume continued on the card
    and held to the JAX package's next steps, and an ASR round trip
    through an orbax optimizer/ held to the uninterrupted run (module
    docstring); each beside the control that starts the optimizer
    afresh."""
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch.utils.orbax import read_orbax
    t_phase = time.perf_counter()
    counters = launch_counters()

    # (a) the JAX package's LM, resumed from its optax state
    ref = json.loads((JAX_RESUME_FIXTURE / "outputs.json").read_text())
    ckpt = JAX_RESUME_FIXTURE / "latest.pth"
    check((ckpt / "optimizer" / "manifest.ocdbt").is_file(),
          f"{ckpt}/optimizer is not an OCDBT directory")
    lm_cfg = {"data": {"corpus": {"name": "none"},
                       "text": {"mode": "character"}},
              "model": ref["model"], "hparas": dict(ref["hparas"])}
    batches = [tuple(torch.from_numpy(unpack(b[k]).astype(np.int64)).cuda()
                     for k in ("text", "text_len")) for b in ref["batches"]]
    want = [st["loss"] for st in ref["steps"]]
    lm = {}
    for route in ("resumed", "control"):
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            solver = resume_solver("lm", lm_cfg, Path(d), seed, ckpt)
        check(solver.step == ref["saved_at"], f"jax_resume_entry: --load "
              f"took step {solver.step}, the fixture {ref['saved_at']}")
        if route == "control":            # what --load did before: afresh
            solver.optimizer.init(solver.params)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses = resume_steps(solver, batches)
        run_s = time.perf_counter() - t0
        norms = {n: float(p.detach().double().norm())
                 for n, p in solver.params.items()}
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        norm_gap = max(abs(norms[n] - v) / v
                       for n, v in ref["leaf_norms"].items())
        count = int(solver.optimizer.count)
        lm[route] = {"losses": losses, "loss_rel_gap": loss_gap,
                     "leaf_norm_rel_gap": norm_gap, "count": count,
                     "within": bool(loss_gap <= JAX_RESUME_LM_TOL
                                    and norm_gap <= JAX_RESUME_LM_TOL
                                    and count == 2 * ref["saved_at"]),
                     "launches": {k: fn.launches for k, fn in
                                  counters.items() if fn.launches},
                     "steps_s": run_s}
    r = lm["resumed"]
    for k in ("lstm_scan_fused", "lstm_bwd_fused"):
        check(r["launches"].get(k, 0) > 0,
              f"jax_resume_entry: the LM resume launched no {k}: "
              f"{r['launches']}")
    check(r["within"], f"jax_resume_entry: the resumed LM is off the JAX "
          f"package's steps: {r}")
    check(not lm["control"]["within"], "jax_resume_entry: the control "
          f"(optimizer afresh) is within the bounds: {lm['control']}")
    emit({"phase": "jax_resume_lm", "fixture": str(
        JAX_RESUME_FIXTURE.relative_to(ROOT)), "jax_losses": want,
        "tolerance": JAX_RESUME_LM_TOL, **lm, "card": CARD,
        "t_s": time.perf_counter() - T_START})

    # (b) the ASR: 3 steps, orbax optimizer/, a fresh Solver's --load, 2
    # more; against the same solver's 2 steps after its save
    las = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    asr_cfg = {"data": {"corpus": {"name": "none"},
                        "audio": las["data"]["audio"],
                        "text": {"mode": "character"}},
               "model": las["model"],
               "hparas": {**las["hparas"], "tf_end": 1.0},
               "ckpt_format": "orbax"}
    data = [train_batch(JAX_RESUME_ASR_B, seed + 40 + i, torch.device("cuda"))
            for i in range(5)]
    deterministic(True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            d = Path(d)
            base = resume_solver("asr", asr_cfg, d, seed)
            resume_steps(base, data[:3])
            base.step = 3
            base.save("resume.pth", base.model, optimizer=base.optimizer,
                      global_step=3)
            path = base.ckpdir / "resume.pth"
            ck = read_orbax(path)
            check(ck["optimizer"] is not None
                  and ck["optimizer"]["optimizer"] == "adadelta"
                  and int(ck["optimizer"]["count"]) == 3,
                  f"jax_resume_entry: {path}/optimizer is not the optax "
                  "state of 3 Adadelta steps")
            whole = resume_steps(base, data[3:])
            ref_params = {n: p.detach().clone()
                          for n, p in base.params.items()}
            asr = {}
            for route in ("resumed", "control"):
                solver = resume_solver("asr", asr_cfg, d, seed, path)
                if route == "control":
                    solver.optimizer.init(solver.params)
                for fn in counters.values():
                    fn.launches = 0
                losses = resume_steps(solver, data[3:])
                gaps = rel_gaps(dict(solver.params), ref_params)
                worst = max(gaps, key=gaps.get)
                loss_gap = max(abs(a - b) / abs(b)
                               for a, b in zip(losses, whole))
                asr[route] = {
                    "losses": losses, "loss_rel_gap": loss_gap,
                    "worst_param": worst, "param_rel_gap": gaps[worst],
                    "count": int(solver.optimizer.count),
                    "within": bool(loss_gap <= JAX_RESUME_ASR_TOL
                                   and gaps[worst] <= JAX_RESUME_ASR_TOL),
                    "launches": {k: fn.launches for k, fn in
                                 counters.items() if fn.launches}}
    finally:
        deterministic(False)
    r = asr["resumed"]
    for k in ("fbank_fused", "lstm_scan_fused", "lstm_bwd_fused",
              "ctc_loss_fused"):
        check(r["launches"].get(k, 0) > 0,
              f"jax_resume_entry: the ASR resume launched no {k}: "
              f"{r['launches']}")
    check(r["within"] and r["count"] == 5, "jax_resume_entry: the resumed "
          f"ASR is off the uninterrupted run: {r}")
    emit({"phase": "jax_resume_asr", "batch": JAX_RESUME_ASR_B, "secs": SECS,
          "uninterrupted_losses": whole, "tolerance": JAX_RESUME_ASR_TOL,
          **asr, "card": CARD})
    emit({"phase": "jax_resume_entry", "ok": True,
          "phase_seconds": time.perf_counter() - t_phase,
          "t_s": time.perf_counter() - T_START, "card": CARD})
    return {"lm": lm["resumed"]["launches"], "asr": r["launches"]}


# the RNN-LM's scan shapes: config/libri/lm_example.yaml's batch of 64 at its
# two padded text lengths, and a ragged last batch of an epoch
LM_SCAN_SHAPES = ((64, 400), (64, 592), (13, 112))
# config/libri/lm_example.yaml's model and optimizer at full width
LM_TRAIN_CFG = {"module": "LSTM", "dim": 512, "emb_dim": 512, "layer": 2,
                "dropout": 0.2, "emb_tying": False}
LM_HPARAS = {"optimizer": "Adam", "lr": 1e-3, "eps": 1e-8,
             "lr_scheduler": "fixed", "GRAD_CLIP": 5.0}
LM_B = 64


def lm_scan_rows(name, run, plain, nbytes, prod, f32_ops, library, launches,
                 design, err):
    """One lm_scan line's timing fields: CUDA-event and device ms of the
    wrapper ``run``, its plain version's ms, the bound at the f32 rate and
    with the recurrent product as six bf16 passes at the tensor rate
    (``prod``: operations of one f32 product; ``f32_ops``: the rest), and
    cuDNN's ms (``library``)."""
    b_ms, b_by = bound(nbytes, prod + f32_ops)
    bt_ms, bt_by = tensor_bound(nbytes, prod, f32_ops)
    return {"kernel": name, "design": design, "launches": launches,
            "max_abs_err": err, "ms": cuda_ms(run, 10),
            "device_ms": device_ms(run, 10),
            "plain_ms": cuda_ms(plain, 2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_tensor": bt_ms,
            "bound_by_tensor": bt_by, "library_ms": library}


def phase_lm_scan(seed, H=512):
    """K2 (without and with residuals), K2b, K4 (without and with
    residuals) and K4b at the RNN-LM's shapes (LM_SCAN_SHAPES: one
    direction, H=512, ragged masks) against their plain versions at the
    k2 / k2b / k4 / k4b phases' tolerances, each timed beside its bounds and
    cuDNN nn.LSTM / nn.GRU (the forward under no_grad; the backward as
    fwd+bwd - fwd)."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import build, scan_tc
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import gru_kernel as gk
    from end_to_end_asr_pytorch_tpu_torch.ops.cuda import lstm_kernel as lk
    rng = np.random.RandomState(seed + 20)
    w_l = lstm_weights(rng, H)
    w_g, b_g = gru_weights(rng, H)
    cud_l, cud_g = cudnn_lstm(w_l), cudnn_gru(w_g, b_g)
    ll = build.load("lstm_scan", lk._SIGNATURES)
    gl = build.load("gru_scan", gk._SIGNATURES)
    fwd = (False,)

    def design(query, n_gates, B, bwd=False):
        kw = dict(planner=scan_tc.plan_bwd, grid_first=True) if bwd else {}
        return (design_name(scan_tc.pick(query, H, n_gates, B, **kw)),
                scan_tc.launches(query, H, n_gates, B, **kw))

    def library(cudnn, x, dys):
        xl = x.clone().requires_grad_(True)
        with torch.no_grad():
            f_ms = cuda_ms(lambda: cudnn(x)[0], 10)
        fg_ms = cuda_ms(lambda: cudnn(xl)[0], 10)
        return f_ms, cuda_ms(lambda: cudnn(xl)[0].backward(dys), 10) - fg_ms

    rows = []
    for B, T in LM_SCAN_SHAPES:
        shape = {"phase": "lm_scan", "B": B, "T": T, "H": H}
        # LSTM: K2, K2 with residuals, K2b
        xp, dys, mask = scan_case(rng, B, T, H, 4)
        err, res_err, _ = check_k2(lk, w_l, xp, mask, [], fwd)
        errs, _ = check_k2b(lk, w_l, xp, dys, mask, [], fwd)
        check(err <= 1e-4 and res_err <= 1e-4 and k2b_ok(errs),
              f"lm_scan K2 / K2b errors {err}, {res_err}, {errs} at B={B}, "
              f"T={T}")
        ys, cs, gates = lk.lstm_scan_fused(xp, w_l, mask, residuals=True)
        lib_f, lib_b = library(cud_l, xp, dys)
        prod = T * 2 * B * H * 4 * H
        d, n = design(ll.lstm_tc_f32_max_groups, 4, B)
        rows.append({**shape, **lm_scan_rows(
            "lstm_scan_fused", lambda: lk.lstm_scan_fused(xp, w_l, mask),
            lambda: lk.lstm_scan_plain(xp, w_l, mask),
            k2_bytes(B, T, H, False), prod, T * 30 * B * H, lib_f, n, d,
            err)})
        rows.append({**shape, **lm_scan_rows(
            "lstm_scan_fused+residuals",
            lambda: lk.lstm_scan_fused(xp, w_l, mask, residuals=True),
            lambda: lk.lstm_scan_fwd_plain(xp, w_l, mask),
            k2_bytes(B, T, H, True), prod, T * 30 * B * H, lib_f, n, d,
            res_err)})
        (b_ms, _), _ = k2b_bound(B, T, H)
        d, n = design(ll.lstm_tc_bwd_max_groups, 4, B, bwd=True)
        rows.append({**shape, **lm_scan_rows(
            "lstm_bwd_fused",
            lambda: lk.lstm_bwd_fused(gates, cs, ys, mask, w_l, dys),
            lambda: lk.lstm_scan_bwd_plain(gates, cs, ys, mask, w_l, dys),
            4 * (T * B * 11 * H + T * B + 2 * H * 4 * H), prod,
            prod + T * 20 * B * H, lib_b, n, d, errs["dxp"]),
            "dw_err_over_max": errs["dw"]})
        # GRU: K4, K4 with residuals, K4b
        xp, dys, mask = scan_case(rng, B, T, H, 3)
        err, res_err, _ = check_k4(gk, w_g, b_g, xp, mask, [], fwd)
        errs, _ = check_k4b(gk, w_g, b_g, xp, dys, mask, [], fwd)
        check(err <= 1e-4 and res_err <= 1e-4 and errs["dxp"] <= 1e-4
              and errs["ag_dxp"] <= 1e-4
              and max(errs["dw"], errs["db"], errs["ag_dw"],
                      errs["ag_db"]) <= 1e-3,
              f"lm_scan K4 / K4b errors {err}, {res_err}, {errs} at B={B}, "
              f"T={T}")
        ys, gates, hp_n = gk.gru_scan_fused(xp, w_g, b_g, mask,
                                            residuals=True)
        lib_f, lib_b = library(cud_g, xp, dys)
        prod = T * 2 * B * H * 3 * H
        d, n = design(gl.gru_tc_f32_max_groups, 3, B)
        rows.append({**shape, **lm_scan_rows(
            "gru_scan_fused", lambda: gk.gru_scan_fused(xp, w_g, b_g, mask),
            lambda: gk.gru_scan_plain(xp, w_g, b_g, mask),
            k4_bytes(B, T, H, False), prod, T * 30 * B * H, lib_f, n, d,
            err)})
        rows.append({**shape, **lm_scan_rows(
            "gru_scan_fused+residuals",
            lambda: gk.gru_scan_fused(xp, w_g, b_g, mask, residuals=True),
            lambda: gk.gru_scan_fwd_plain(xp, w_g, b_g, mask),
            k4_bytes(B, T, H, True), prod, T * 30 * B * H, lib_f, n, d,
            res_err)})
        d, n = design(gl.gru_tc_bwd_max_groups, 3, B, bwd=True)
        rows.append({**shape, **lm_scan_rows(
            "gru_bwd_fused",
            lambda: gk.gru_bwd_fused(gates, hp_n, ys, mask, w_g, dys),
            lambda: gk.gru_scan_bwd_plain(gates, hp_n, ys, mask, w_g, dys),
            4 * (T * B * 9 * H + T * B + 2 * H * 3 * H + 3 * H), prod,
            prod + T * 20 * B * H, lib_b, n, d, errs["dxp"]),
            "dw_err_over_max": errs["dw"], "db_err_over_max": errs["db"]})
        for r in rows[-6:]:
            emit(r)
    return rows


def lm_batch(seed, device, B=LM_B, lo=96, hi=400, V=V_CHAR):
    """B sentences of lo..hi characters (the longest hi) in [3, V), each
    ending in <eos>, padded to a multiple of 16."""
    import torch
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, size=B)
    lens[0] = hi
    U = -(-hi // 16) * 16
    text = rng.randint(3, V, size=(B, U))
    text[np.arange(U)[None, :] >= lens[:, None]] = 0
    text[np.arange(B), lens - 1] = 1
    return (torch.from_numpy(text).to(device),
            torch.from_numpy(lens.astype(np.int64)).to(device))


def make_lm_solver(device, seed, workdir, module):
    """The port's LM training solver with lm_example.yaml's model at full
    width (``module`` LSTM or GRU; random weights from ``seed``) and Adam,
    set up as ``main --lm`` sets it up but without a corpus."""
    from types import SimpleNamespace
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import Solver
    cfg = {"data": {"corpus": {"name": "none"},
                    "text": {"mode": "character"}},
           "model": {**LM_TRAIN_CFG, "module": module},
           "hparas": dict(LM_HPARAS)}
    paras = SimpleNamespace(config="smoke_lm.yaml", name=None, seed=seed,
                            logdir=str(workdir / "log"),
                            ckpdir=str(workdir / "ckpt"), load=None,
                            njobs=0, no_msg=True, cpu=device.type == "cpu",
                            amp=False)
    solver = Solver(cfg, paras)
    solver.vocab_size = V_CHAR
    solver.set_model()
    return solver


def lm_compare(solver, data, cuda_kernels):
    """One step's loss and gradients at dropout 0 with the kernels and with
    their plain versions, from the same weights (no update)."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import lm_nll
    rate, out = solver.lm.dropout, []
    solver.lm.dropout = 0.0
    try:
        for use in (True, False):
            cuda_kernels.USE_KERNELS = use
            for p in solver.params.values():
                p.grad = None
            total, count = lm_nll(solver.lm, *data, train=True,
                                  generator=solver.gen)
            loss = total / torch.clamp(count, min=1.0)
            loss.backward()
            out.append((float(loss.detach()),
                        {k: p.grad.detach().clone()
                         for k, p in solver.params.items()}))
    finally:
        cuda_kernels.USE_KERNELS = True
        solver.lm.dropout = rate
    (lk, gk), (lp, gp) = out
    # the worst element against rtol 1e-4 / atol 1e-6: |a - b| / (atol +
    # rtol |b|), at most 1 where allclose holds
    excess = {k: float(((gk[k] - gp[k]).abs()
                        / (1e-6 + 1e-4 * gp[k].abs())).max()) for k in gk}
    worst = max(excess, key=excess.get)
    bad = [k for k, g in gk.items()
           if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    check(not bad, f"LM kernel-path gradients not finite or all zero: {bad}")
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel_diff": abs(lk - lp) / abs(lp), "worst_grad": worst,
            "worst_grad_allclose_ratio": excess[worst],
            "grads_err_over_max": {k: float((gk[k] - gp[k]).abs().max()
                                            / gp[k].abs().max()) for k in gk}}


LM_RANGES = ("lm.forward", "lm.backward", "lm.optimizer")


def phase_lm_train(seed, device, name="lm_train", module="LSTM", n_steps=5):
    """LM training steps of lm_example.yaml's model at full width (2 layers
    of 512, emb 512, dropout 0.2, Adam lr 1e-3) on B=64 generated sentences
    of 96-400 characters, V=31: one step with the kernels against one with
    the plain versions at dropout 0 (loss rtol 1e-5, every gradient within
    rtol 1e-4 / atol 1e-6), then ``n_steps`` timed steps, then one
    profiled step; each step must launch the forward scan (K2, or K4 for
    ``module`` GRU) twice and its backward (K2b / K4b) twice, and no other
    kernel of this repository."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        solver = make_lm_solver(device, seed, Path(d), module)
    data = lm_batch(seed + 30, device)
    c = lm_compare(solver, data, cuda_kernels)
    emit({"phase": f"{name}_compare", **c})
    check(c["loss_rel_diff"] <= 1e-5,
          f"{name} loss kernel vs plain rel diff {c['loss_rel_diff']}")
    check(c["worst_grad_allclose_ratio"] <= 1.0,
          f"{name} gradient {c['worst_grad']} kernel vs plain beyond rtol "
          f"1e-4 / atol 1e-6: {c['worst_grad_allclose_ratio']}")
    scan = module.lower()
    per_step = {k: 0 for k in launch_counters()}
    per_step.update({f"{scan}_scan_fused": 2, f"{scan}_bwd_fused": 2})
    solver.train_step(*data)                       # warm-up
    torch.cuda.synchronize()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    steps = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        m = solver.train_step(*data)
        steps.append({k: fn.launches for k, fn in counters.items()})
        for fn in counters.values():
            fn.launches = 0
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    check(all(st == per_step for st in steps),
          f"every {name} step must launch {per_step}, got {steps}")
    loss = float(m["loss"])
    check(math.isfinite(loss), f"{name} loss {loss}")
    tokens = int(data[1].sum())
    emit({"phase": name, "module": module, "batch": LM_B,
          "U": data[0].shape[1], "tokens_per_step": tokens, "steps": n_steps,
          "ms_per_step": dt * 1e3, "tokens_per_s": tokens / dt,
          "launches_per_step": {k: v for k, v in per_step.items() if v},
          "loss_last_step": loss, "grad_norm": float(m["grad_norm"])})
    # a trace that lost events (seen late in a whole run) is taken again
    want = {"tc_scan_kernel": 2, "tc_bwd_kernel": 2}
    for attempt in range(3):
        kdm = train_breakdown(solver, data, name, LM_RANGES, attempt=attempt)
        check({k: fn.launches for k, fn in counters.items()} == per_step,
              f"{name} profiled step's wrapper counts")
        for fn in counters.values():
            fn.launches = 0
        got = {k: v["launches"] for k, v in kdm.items()}
        if got == want:
            break
    check(got == want, f"{name} profiled step launched {got}, want {want}")
    return per_step


def convert_to_flac(root):
    """Every WAV under ``root`` rewritten as a PCM16 FLAC (tests/
    flac_encoder.py, a test helper, loaded by its path: another ``tests``
    package may be installed) and deleted; returns {flac path: the WAV's
    samples}."""
    import importlib.util
    from end_to_end_asr_pytorch_tpu_torch.data.audio_io import read_wav
    spec = importlib.util.spec_from_file_location(
        "flac_encoder", ROOT / "tests" / "flac_encoder.py")
    encoder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(encoder)
    encode_flac = encoder.encode_flac
    waves = {}
    for wav in sorted(Path(root).rglob("*.wav")):
        w, sr = read_wav(str(wav))
        pcm = np.clip(np.round(w * 32768.0), -32768, 32767).astype(np.int16)
        flac = wav.with_suffix(".flac")
        flac.write_bytes(encode_flac(pcm, sr=sr))
        wav.unlink()
        waves[flac] = w
    return waves


TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node=1"]


def run_mains(runs, timeout=600):
    """Run the port's ``main`` once per ``(what, launcher, args)`` at the
    same time (``launcher``: [] or ``TORCHRUN``) -> {what: (stdout,
    seconds)}; a non-zero exit fails."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs = {what: subprocess.Popen(
        [*(launcher or [sys.executable]), "-m",
         "end_to_end_asr_pytorch_tpu_torch.main", *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for what, launcher, args in runs}
    out = {}
    try:
        for what, p in procs.items():
            stdout, stderr = p.communicate(timeout=timeout)
            check(p.returncode == 0, f"{what} exited {p.returncode}: "
                  f"{stderr[-2000:]}")
            out[what] = (stdout, time.perf_counter() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def run_main(args, what, timeout=600):
    """``python -m end_to_end_asr_pytorch_tpu_torch.main`` with ``args``
    from the repository root -> (stdout, seconds); a non-zero exit fails."""
    return run_mains([(what, [], args)], timeout)[what]


NATIVE_DEV_PAIRS = 2703       # LibriSpeech dev-clean's utterances
NATIVE_TRAIN_LINES = 28539    # train-clean-100's transcripts
NATIVE_PLAIN_SHARE = 0.1      # of the pairs the plain DP scores as well
NATIVE_BPE_LINES = 1000       # generated lines the generator trains on
NATIVE_BPE_SIZE = 500


def transcript_lines(n_lines, seed, inventory=3000, mean_words=26):
    """``n_lines`` generated transcripts of ``mean_words`` +- 6 words (~180
    characters, LibriSpeech's dev-clean and train-clean-100 lines) drawn
    Zipf-like from an inventory of pseudo-words of 2-10 letters; one seed
    gives one inventory and the same first lines."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    inv = np.array(["".join(rng.choice(letters, n))
                    for n in rng.randint(2, 11, inventory)])
    p = 1.0 / np.arange(1, inventory + 1)
    counts = rng.randint(mean_words - 6, mean_words + 7, n_lines)
    words = inv[rng.choice(inventory, counts.sum(), p=p / p.sum())]
    ends = np.cumsum(counts)
    return [" ".join(words[e - c:e]) for c, e in zip(counts, ends)]


def garble(text, rng, rate=0.1):
    """``text`` with about ``rate`` of its characters substituted, deleted
    or followed by an inserted letter (a hypothesis at ~``rate`` CER)."""
    out = []
    for c, r in zip(text, rng.rand(len(text))):
        if r < rate / 3:
            out.append(chr(97 + int(r * 1e6) % 26))
        elif r >= 2 * rate / 3:
            out.append(c)
            if r < rate:
                out.append(chr(97 + int(r * 1e6) % 26))
    return "".join(out)


def phase_native_text(seed, n_utts=16):
    """The host runtime for text (see the module docstring): the three host
    libraries, scoring and BPE encoding native against plain, the
    generator, and main --test with its vocabulary on the card."""
    import contextlib
    import io
    import re
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch import main as port_main
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
    from end_to_end_asr_pytorch_tpu_torch.solvers import test_asr
    from end_to_end_asr_pytorch_tpu_torch.utils import metrics, native
    from end_to_end_asr_pytorch_tpu_torch.utils.text import load_text_encoder
    from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import asr_state_dict
    t_phase = time.perf_counter()
    pkg_native = ROOT / "end_to_end_asr_pytorch_tpu_torch" / "native"
    built = {}
    for what, get, src in (("flac_decoder", native.get_lib, native.SOURCE),
                           ("edit_distance", native.get_edit_lib,
                            native.EDIT_SOURCE),
                           ("bpe_encoder", native.get_bpe_lib,
                            native.BPE_SOURCE)):
        check(src.resolve().parent == pkg_native,
              f"native_text: {what} is built from {src}")
        compiled = not native._target(src).exists()
        t0 = time.perf_counter()
        get()
        built[what] = {"seconds": time.perf_counter() - t0,
                       "compiled": compiled}

    rng = np.random.RandomState(seed + 21)
    refs = transcript_lines(NATIVE_DEV_PAIRS, seed + 22)
    hyps = [garble(r, rng) for r in refs]
    sample = sorted(rng.choice(len(refs), int(NATIVE_PLAIN_SHARE * len(refs)),
                               replace=False))
    scoring = {}
    for mode in ("cer", "wer"):
        split = str.split if mode == "wer" else list
        t0 = time.perf_counter()
        rates = metrics.error_rates(hyps, refs, mode)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = [metrics.edit_distance_plain(split(hyps[i]), split(refs[i]))
                 / len(split(refs[i])) for i in sample]
        plain_s = time.perf_counter() - t0
        check([rates[i] for i in sample] == plain,
              f"native_text: {mode} of the native batch differs from the "
              "plain DP's")
        native_ms = 1e3 * native_s / len(refs)
        plain_ms = 1e3 * plain_s / len(sample)
        scoring[mode] = {"native_ms_per_pair": native_ms,
                         "plain_ms_per_pair": plain_ms,
                         "plain_over_native": plain_ms / native_ms,
                         "native_s_all_pairs": native_s,
                         "plain_s_all_pairs_projected":
                             plain_ms * len(refs) / 1e3,
                         "mean": float(np.mean(rates))}
    emit({"phase": "native_text_scoring", "pairs": len(refs),
          "plain_pairs": len(sample),
          "ref_chars_mean": float(np.mean([len(r) for r in refs])),
          "built": built, "scoring": scoring, "card": CARD,
          "cpu": cpu_name()})

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        corpus = generate_corpus(str(d / "synth"), n_train=0, n_dev=n_utts,
                                 n_test=n_utts, seed=seed)
        trans = [ln.split(" ", 1)[1].lower()    # as the loader reads them
                 for f in sorted(corpus.rglob("*.trans.txt"))
                 for ln in f.read_text().splitlines() if " " in ln]
        (d / "text.txt").write_text("\n".join(
            transcript_lines(NATIVE_BPE_LINES, seed + 23) + trans) + "\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "end_to_end_asr_pytorch_tpu_torch.utils.generate_vocab",
             "--input_file", str(d / "text.txt"), "--output_file",
             str(d / "bpe.json"), "--mode", "subword", "--vocab_size",
             str(NATIVE_BPE_SIZE)], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=300)
        generator_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"generate_vocab exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        enc = load_text_encoder("subword", str(d / "bpe.json"))
        lines = transcript_lines(NATIVE_TRAIN_LINES, seed + 23)
        enc.encode(lines[0])                  # the native handle, made once
        t0 = time.perf_counter()
        ids = [enc.encode(ln) for ln in lines]
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = [enc.encode_py(ln) for ln in lines]
        plain_s = time.perf_counter() - t0
        check(ids == plain, "native_text: BPE ids differ from encode_py's")
        emit({"phase": "native_text_encoding", "lines": len(lines),
              "pieces": enc.vocab_size, "generator_seconds": generator_s,
              "ids": sum(len(i) for i in ids),
              "native_ms_per_line": 1e3 * native_s / len(lines),
              "plain_ms_per_line": 1e3 * plain_s / len(lines),
              "plain_over_native": plain_s / native_s,
              "native_s": native_s, "plain_s": plain_s, "card": CARD})

        V = enc.vocab_size
        model = ASR(AUDIO_CFG["feat_dim"], V, MODEL_CFG,
                    generator=torch.Generator().manual_seed(seed),
                    device="cuda")
        torch.save({"model": asr_state_dict(model), "global_step": 0},
                   str(d / "asr.pth"))
        del model
        decode = {k: v for k, v in DECODE_CFG.items() if k != "lm_weight"}
        cfg = {"data": {"corpus": {"name": "synthetic", "path": str(corpus),
                                   "dev_split": ["dev-clean"],
                                   "test_split": ["test-clean"],
                                   "batch_size": n_utts},
                        "audio": AUDIO_CFG,
                        "text": {"mode": "subword",
                                 "vocab_file": str(d / "bpe.json")}},
               "model": MODEL_CFG, "hparas": {}, "decode": decode}
        (d / "bpe.yaml").write_text(yaml.safe_dump(cfg))
        scores, real = {}, test_asr.Solver._decode_set

        def spy(self, split, dataset):
            scores[split] = real(self, split, dataset)
            return scores[split]

        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        test_asr.Solver._decode_set = spy
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                port_main.main(["--config", str(d / "bpe.yaml"), "--test",
                                "--load", str(d / "asr.pth"), "--outdir",
                                str(d / "out"), "--seed", str(seed)])
        finally:
            test_asr.Solver._decode_set = real
        test_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
        summary = [ln for ln in out.getvalue().splitlines()
                   if re.match(r"\[INFO\] (dev|test): ", ln)]
        k8 = [int(m) for ln in summary
              for m in re.findall(r"K8 launches (\d+)", ln)]
        check(all(launches.get(k, 0) > 0 for k in (
            "fbank_fused", "lstm_scan_fused", "beam_step_fused"))
              and sum(k8) == launches["beam_step_fused"],
              f"native_text: main --test launches {launches}, summary "
              f"{summary}")
        er = {}
        for split in ("dev", "test"):
            rows = [ln.split("\t") for ln in (
                d / "out" / f"bpe_sd{seed}" / f"{split}_output.csv"
            ).read_text().split("\n")[1:] if ln]
            check(len(rows) == n_utts, f"native_text: {split} has "
                  f"{len(rows)} rows")
            plain = {}
            for mode, split_fn in (("wer", str.split), ("cer", list)):
                vals = [metrics.edit_distance_plain(split_fn(h), split_fn(r))
                        / len(split_fn(r)) for _, h, r in rows
                        if split_fn(r)]
                total = 0.0
                for v in vals:
                    total += v
                plain[mode] = total / len(vals)
            got = {m: scores[split][m] for m in ("wer", "cer")}
            check(got == plain, f"native_text: {split} scores {got}, the "
                  f"plain scorer's {plain}")
            er[split] = got
    emit({"phase": "native_text_entry", "vocab": V, "utts_per_split": n_utts,
          "launches": launches, "scores": er, "test_seconds": test_s,
          "summary": summary, "phase_seconds": time.perf_counter() - t_phase})


def phase_recipe_entry(seed, phases, n_utts=32):
    """The LibriSpeech recipe's chain on a generated corpus in FLAC
    (n_utts train, dev and test utterances and 1,280 text-only sentences;
    the character vocabulary of the slices, V=31). flac_entry: every FLAC
    the port decodes equals its WAV sample for sample, the test split's
    loader batches are int16, and ``main`` trains bench.py's model for 2
    steps on the FLAC tree. lm_entry: ``main --lm`` trains
    lm_example.yaml's LM (2 x LSTM-512) for 20 steps on lm_text.txt,
    writing best_ppx.pth and latest.pth with a finite dev perplexity; then
    ``main --test`` on the FLAC tree with test_entry's settings (beam 8,
    CTC 0.3, LM 0.3 through decode.lm_path on that best_ppx.pth, amp off,
    K8's step tail) and the ASR checkpoint of flac_entry (or the slice's
    random model where flac_entry is not run)."""
    import re
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch.data.dataset import load_dataset
    from end_to_end_asr_pytorch_tpu_torch.data.flac import read_flac
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        corpus = generate_corpus(str(d / "synth"), n_train=n_utts,
                                 n_dev=n_utts, n_test=n_utts, seed=seed,
                                 text_only=20 * LM_B)
        (d / "vocab.txt").write_text("\n".join(CHARS) + "\n")
        t0 = time.perf_counter()
        waves = convert_to_flac(corpus)
        convert_s = time.perf_counter() - t0
        text = {"mode": "character", "vocab_file": str(d / "vocab.txt")}
        data = {"corpus": {"name": "librispeech", "path": str(corpus),
                           "train_split": ["train-clean"],
                           "dev_split": ["dev-clean"],
                           "test_split": ["test-clean"],
                           "batch_size": n_utts},
                "audio": AUDIO_CFG, "text": text}
        common = ["--seed", str(seed), "--logdir", str(d / "log"),
                  "--ckpdir", str(d / "ckpt"), "--outdir", str(d / "out")]
        asr_ckpt = d / "ckpt" / f"las_sd{seed}" / "latest.pth"
        if "flac_entry" in phases:
            mismatched = [str(p) for p, w in waves.items()
                          if not np.array_equal(read_flac(str(p))[0], w)]
            check(not mismatched, f"FLAC decodes differ from their WAVs: "
                  f"{mismatched[:3]}")
            dv, tt = load_dataset(0, False, mode="test", **data)[:2]
            dtypes = {str(b["wave"].dtype) for s in (dv, tt) for b in s}
            check(dtypes == {"int16"}, f"FLAC batches are {dtypes}")
            cfg = {"data": {**data, "corpus": {**data["corpus"],
                                               "batch_size": 16}},
                   "model": MODEL_CFG,
                   "hparas": {**TRAIN_HPARAS, "max_step": 2, "valid_step": 2,
                              "PROGRESS_STEP": 1, "curriculum": 0}}
            (d / "las.yaml").write_text(yaml.safe_dump(cfg))
            out, train_s = run_main(["--config", str(d / "las.yaml"),
                                     *common], "main on FLAC")
            ck = torch.load(str(asr_ckpt), weights_only=True)
            check(ck["global_step"] == 2, f"main on FLAC: {ck['global_step']}")
            emit({"phase": "flac_entry", "utterances": len(waves),
                  "samples": int(sum(len(w) for w in waves.values())),
                  "flac_bytes": int(sum(p.stat().st_size for p in waves)),
                  "convert_seconds": convert_s, "batch_dtypes": sorted(dtypes),
                  "train_seconds": train_s,
                  "train_stdout_tail": out.strip().splitlines()[-2:]})
        if "lm_entry" not in phases:
            return
        lm_cfg = {"data": {"corpus": {"name": "librispeech",
                                      "path": str(corpus),
                                      "train_split": ["lm_text.txt"],
                                      "dev_split": ["dev-clean"],
                                      "batch_size": LM_B}, "text": text},
                  "model": LM_TRAIN_CFG,
                  "hparas": {**LM_HPARAS, "max_step": 20, "valid_step": 10,
                             "PROGRESS_STEP": 5}}
        (d / "lm.yaml").write_text(yaml.safe_dump(lm_cfg))
        out, lm_s = run_main(["--config", str(d / "lm.yaml"), "--lm",
                              *common], "main --lm")
        lm_dir = d / "ckpt" / f"lm_sd{seed}"
        cks = {n: torch.load(str(lm_dir / f"{n}.pth"), weights_only=True)
               for n in ("best_ppx", "latest")}
        steps_ppx = [(c["global_step"], c["ppx"]) for c in cks.values()]
        check(cks["latest"]["global_step"] == 20
              and all(math.isfinite(p) for _, p in steps_ppx),
              f"main --lm checkpoints (step, ppx): {steps_ppx}")
        lm_log = [json.loads(ln) for ln in (d / "log" / f"lm_sd{seed}" /
                                            "log.jsonl").read_text()
                  .splitlines()]
        if not asr_ckpt.exists():
            from end_to_end_asr_pytorch_tpu_torch.ops.audio import (
                create_transform)
            from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import (
                save_checkpoint)
            frontend, _ = create_transform(AUDIO_CFG, device="cuda")
            save_checkpoint(asr_ckpt, slice_models(frontend, seed)[0])
        decode = {**DECODE_CFG, "lm_config": str(d / "lm.yaml"),
                  "lm_path": str(lm_dir / "best_ppx.pth")}
        (d / "test.yaml").write_text(yaml.safe_dump(
            {"data": data, "model": MODEL_CFG, "hparas": {},
             "decode": decode}))
        out, test_s = run_main(["--config", str(d / "test.yaml"), "--test",
                                "--load", str(asr_ckpt), *common],
                               "main --test with the trained LM")
        summary = [ln for ln in out.splitlines()
                   if re.match(r"\[INFO\] (dev|test): ", ln)]
        k8 = [int(m) for ln in summary
              for m in re.findall(r"K8 launches (\d+)", ln)]
        check(len(summary) == 2 and len(k8) == 2 and all(n > 0 for n in k8)
              and all("| beam fused " in ln for ln in summary)
              and "Loaded LM ckpt for shallow fusion (weight 0.3)" in out,
              f"main --test with the trained LM: {out[-2000:]}")
        for split in ("dev", "test"):
            rows = (d / "out" / f"test_sd{seed}" / f"{split}_output.csv"
                    ).read_text().strip().split("\n")[1:]
            check(len(rows) == n_utts, f"{split}: {len(rows)} rows")
        emit({"phase": "lm_entry", "lm_seconds": lm_s, "test_seconds": test_s,
              "dev_ppx": {n: c["ppx"] for n, c in cks.items()},
              "train_ppx_logged": [e["value"]["tr"] for e in lm_log
                                   if "tr" in e["value"]],
              "k8_launches": k8, "summary": summary})


# ------------------------------------------------------------ data parallel
# --------------------------------------------------------- input pipeline
PREFETCH_BATCHES = 16        # (a): batches held bit for bit
PREFETCH_ABANDON = 50        # (d): the epoch abandoned after 2 batches
PREFETCH_TURNS = 3           # (c): alternations of prefetch and inline
PREFETCH_STEPS = 10          # (c): timed steps a run
PREFETCH_SLEEP = 20_000_000  # (a): cycles the compute stream is held back
PREFETCH_CLOSE_S = 2.0       # (d): the longest the threads may outlive close


class WaveSet:
    """``n`` utterances with the loader's dataset interface (LibriDataset's,
    ascending by size): int16 waves of 60-100% of SECS drawn from ``seed``
    and the index, labels in [3, V_CHAR) proportional to the length (the
    longest U_TRAIN)."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        s = int(SECS * 16000)
        self.seed = seed
        self.lens = np.sort(rng.randint(int(0.6 * s), s + 1, size=n))
        self.texts = [rng.randint(3, V_CHAR, size=max(1, round(
            U_TRAIN * int(n_s) / s))).tolist() for n_s in self.lens]

    def __len__(self):
        return len(self.lens)

    def num_samples(self, i):
        return int(self.lens[i])

    def load_wave(self, i):
        return np.random.RandomState(self.seed * 100_003 + i).randint(
            -3000, 3000, size=int(self.lens[i])).astype(np.int16)

    def text_ids(self, i):
        return self.texts[i]

    def utt_id(self, i):
        return f"utt{i}"

    def text_raw(self, i):
        return ""


def wave_loader(n_batches, seed, batch=32):
    """The port's loader over a ``WaveSet`` of ``n_batches`` batches, two
    assembling threads, no wave cache."""
    from end_to_end_asr_pytorch_tpu_torch.data.dataset import AudioBatchLoader
    return AudioBatchLoader(WaveSet(n_batches * batch, seed), batch,
                            n_jobs=2, cache_bytes=0)


def inline_copy(batch, keys, device):
    """The copy the solvers made on the step's thread before the
    prefetcher: ``torch.from_numpy(a).to(device)``, labels as int64."""
    import torch
    dtypes = {"text": torch.int64, "text_len": torch.int64}
    return {k: torch.from_numpy(batch[k]).to(device, dtypes.get(k))
            for k in keys if k in batch}


def host_train_batch(batch, seed):
    """train_batch's waves and labels as the loader hands them: int16
    waves, int32 lengths and labels."""
    w, wl = make_waves(batch, seed)
    rng = np.random.RandomState(seed)
    lab_len = np.maximum(1, np.round(U_TRAIN * wl / wl.max())).astype(np.int32)
    text = rng.randint(3, V_CHAR, size=(batch, U_TRAIN)).astype(np.int32)
    text[np.arange(U_TRAIN)[None, :] >= lab_len[:, None]] = 0
    return {"wave": np.clip(np.round(w * 32768.0), -32768,
                            32767).astype(np.int16),
            "wave_len": wl, "text": text, "text_len": lab_len}


def host_lm_batch(seed, B=LM_B, lo=96, hi=400):
    """lm_batch's sentences as the loader hands them (int32)."""
    text, lens = (t.numpy() for t in lm_batch(seed, "cpu", B, lo, hi))
    return {"text": text.astype(np.int32), "text_len": lens.astype(np.int32)}


def trace_streams(prof, d):
    """(streams of the host-to-device copies, their names, streams of K1's
    and K2's kernels, the number of ``data.wait`` ranges) in ``prof``'s
    chrome trace."""
    path = Path(d) / "prefetch_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    stream = lambda e: (e.get("args") or {}).get("stream", e.get("tid"))
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and any(k in e.get("name", "") for k in ("fbank_kernel",
                                                         "tc_scan_kernel"))]
    waits = sum(e.get("name") == "data.wait" and e.get("ph") == "X"
                and e.get("cat") == "user_annotation" for e in events)
    return ({stream(e) for e in copies}, sorted({e["name"] for e in copies}),
            {stream(e) for e in kernels}, waits)


def turn_run(step, batches, keys, device, mode, n_steps, profiled):
    """One run of (c): ``n_steps`` steps of ``step`` on ``batches`` (host
    batches, cycled) through the prefetcher or through inline copies
    (``mode``), timed on the host clock, the span each step waited for its
    input (``data.wait``) beside; then, with ``profiled``, one more step
    under the profiler (device activity alone: a step's host events take
    seconds to sum): its device idle share and host-to-device copies."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    source = (batches[i % len(batches)] for i in range(n_steps + 1))
    if mode == "prefetch":
        it = mesh.prefetch_to_device(source, device, keys=keys)
        take = lambda: next(it)[0]
    else:
        def take():
            with record_function("data.wait"):
                return inline_copy(next(source), keys, device)
    torch.cuda.synchronize()
    wait, losses = 0.0, []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        t1 = time.perf_counter()
        dev = take()
        wait += time.perf_counter() - t1
        losses.append(step(*(dev[k] for k in keys))["loss"])
    torch.cuda.synchronize()
    out = {"mode": mode, "ms_per_step": (time.perf_counter() - t0) * 1e3
           / n_steps, "data_wait_ms_per_step": wait * 1e3 / n_steps}
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"{mode} losses {losses}")
    if profiled:
        ranges = TRAIN_RANGES + LM_RANGES + ("data.wait",)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.1)
            t0 = time.perf_counter()
            dev = take()
            wait = time.perf_counter() - t0
            step(*(dev[k] for k in keys))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            time.sleep(0.1)
        dev_t = lambda e: getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0))
        avgs = prof.key_averages()
        busy = sum(dev_t(e) for e in avgs
                   if e.device_type == DeviceType.CUDA and dev_t(e) > 0
                   and e.key not in ranges
                   and not getattr(e, "is_user_annotation", False)) / 1e3
        out.update(profiled_step_ms=ms, device_busy_ms=busy,
                   device_idle_share=1.0 - busy / ms,
                   profiled_data_wait_ms=wait * 1e3,
                   copies={e.key: e.count for e in avgs
                           if e.key.startswith("Memcpy HtoD")})
    if mode == "prefetch":
        it.close()
    return out


def phase_prefetch(batch, seed, device):
    """The input pipeline (parallel/mesh.py prefetch_to_device) at train's
    shapes: (a) 16 batches of the loader (32 int16 waves of 7 s, U up to
    96), the compute stream held back before each is read: every prefetched
    tensor equal to the inline copy; (b) the staging pinned, and a short
    trace (K1 and the encoder's K2 on 3 prefetched batches) with the
    host-to-device copies on streams other than K1's and K2's and the
    consumer's waits as data.wait ranges; (d) an
    epoch of 50 batches abandoned after 2: within 2 s the worker and the
    loader's pool threads are gone and the allocated device bytes are back
    where they were; (e) a source that raises after one batch, and a batch
    that cannot be staged, raise in the consumer; (c) in turns,
    PREFETCH_TURNS alternations of PREFETCH_STEPS train steps through the
    prefetcher and through inline copies, for train's model and for
    lm_train's LM (B=64): ms per step, data.wait ms per step, and in the
    last alternation one profiled step each (device idle share)."""
    import gc
    import threading
    import torch
    from torch.profiler import ProfilerActivity, profile
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import LM_KEYS
    t_phase = time.perf_counter()
    keys = mesh.ASR_KEYS
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        solvers = {"asr": make_solver(device, seed, Path(d)),
                   "lm": make_lm_solver(device, seed, Path(d), "LSTM")}
    frontend, model = solvers["asr"].frontend, solvers["asr"].model
    dtypes = {"wave": torch.int16, "wave_len": torch.int32,
              "text": torch.int64, "text_len": torch.int64}
    # (a) bit equality, the compute stream held back so that a block the
    # side stream took back too early would be overwritten before it is read
    loader = wave_loader(PREFETCH_BATCHES, seed + 40, batch)
    hosts, seen = [], []
    for dev, host in mesh.prefetch_to_device(
            loader.epoch_iter(shuffle=True), device):
        got = {k: (v.dtype, v.device.type) for k, v in dev.items()}
        check(got == {k: (t, "cuda") for k, t in dtypes.items()},
              f"prefetch: device batch {got}")
        torch.cuda._sleep(PREFETCH_SLEEP)
        seen.append({k: v.clone() for k, v in dev.items()})
        hosts.append(host)
    torch.cuda.synchronize()
    check(len(seen) == PREFETCH_BATCHES, f"prefetch: {len(seen)} batches")
    unequal = [(i, k) for i, (got, host) in enumerate(zip(seen, hosts))
               for k, ref in inline_copy(host, keys, device).items()
               if got[k].dtype != ref.dtype or not torch.equal(got[k], ref)]
    check(not unequal, f"prefetch: tensors differ from the inline copy "
          f"{unequal}")
    del seen
    # (b) pinned staging, copies on a side stream
    stream = torch.cuda.Stream(device)
    dev, staged, event = mesh.stage_batch(hosts[0], keys, device, stream)
    event.synchronize()
    pinned = {k: t.is_pinned() for k, t in staged.items()}
    check(all(pinned.values()), f"prefetch: staging not pinned {pinned}")
    check(all(torch.equal(dev[k], v) for k, v in
              inline_copy(hosts[0], keys, device).items()),
          "prefetch: stage_batch differs from the inline copy")
    del dev, staged, event, hosts
    with torch.no_grad():
        for dev, _ in mesh.prefetch_to_device(              # warm-up
                wave_loader(1, seed + 41, batch), device):
            model.encode(*frontend(dev["wave"], dev["wave_len"]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for dev, _ in mesh.prefetch_to_device(
                    wave_loader(3, seed + 42, batch), device):
                model.encode(*frontend(dev["wave"], dev["wave_len"]))
            torch.cuda.synchronize()
    del dev
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        copy_streams, copy_names, kernel_streams, waits = trace_streams(
            prof, d)
    check(copy_streams and kernel_streams,
          f"prefetch: the trace lacks copies {copy_streams} or kernels "
          f"{kernel_streams}")
    check(not copy_streams & kernel_streams,
          f"prefetch: copies on the kernels' streams {copy_streams} "
          f"{kernel_streams}")
    check(all("Pinned" in n for n in copy_names),
          f"prefetch: copies not from pinned memory {copy_names}")
    check(waits >= 3, f"prefetch: {waits} data.wait ranges in the trace")
    emit({"phase": "prefetch_check", "batches": PREFETCH_BATCHES,
          "batch": batch, "bit_equal": True, "pinned": pinned,
          "copy_streams": sorted(copy_streams), "copy_names": copy_names,
          "kernel_streams": sorted(kernel_streams), "data_wait_ranges": waits})
    # (d) abandon after 2 of 50 batches
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    threads = set(threading.enumerate())
    it = mesh.prefetch_to_device(
        wave_loader(PREFETCH_ABANDON, seed + 43, batch).epoch_iter(), device)
    got = [next(it) for _ in range(2)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    started = [t.name for t in set(threading.enumerate()) - threads]
    del got
    t0 = time.perf_counter()
    it.close()
    del it
    left = lambda: [t.name for t in set(threading.enumerate()) - threads]
    while left() and time.perf_counter() - t0 < PREFETCH_CLOSE_S:
        time.sleep(0.01)
    gone_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated() - base
    check(not left(), f"prefetch: threads left {PREFETCH_CLOSE_S} s after "
          f"close: {left()}")
    check(after == 0, f"prefetch: {after} device bytes left after close")
    check(held > 0 and "prefetch_to_device" in started,
          f"prefetch: abandon held {held} bytes, threads {started}")

    # (e) errors raise in the consumer
    def bad():
        yield host_lm_batch(seed)
        raise RuntimeError("prefetch smoke: corrupt utterance")

    errors = {}
    for name, src in (("source", bad()),
                      ("staging", iter([{"text": np.array([object()])}]))):
        it = mesh.prefetch_to_device(src, device, keys=LM_KEYS)
        try:
            if name == "source":
                next(it)
            next(it)
        except (RuntimeError, TypeError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
        it.close()
    check(set(errors) == {"source", "staging"}
          and "corrupt utterance" in errors["source"],
          f"prefetch: errors did not reach the consumer: {errors}")
    emit({"phase": "prefetch_abandon", "batches": PREFETCH_ABANDON,
          "taken": 2, "held_bytes": held, "threads_started": sorted(started),
          "threads_gone_s": gone_s, "bytes_after_close": after,
          "errors": errors})

    # (c) in turns: train's model, then lm_train's LM
    cells = {"asr": ([host_train_batch(batch, seed + 44 + i)
                      for i in range(4)], keys),
             "lm": ([host_lm_batch(seed + 48 + i) for i in range(4)],
                    LM_KEYS)}
    for cell, (batches, cell_keys) in cells.items():
        step = solvers.pop(cell).train_step
        turn_run(step, batches, cell_keys, device, "inline", 1,
                 False)                                    # warm-up
        runs = []
        for r in range(PREFETCH_TURNS):
            order = (("inline", "prefetch") if r % 2 == 0
                     else ("prefetch", "inline"))
            for mode in order:
                runs.append({"turn": r, **turn_run(
                    step, batches, cell_keys, device, mode, PREFETCH_STEPS,
                    r == PREFETCH_TURNS - 1)})
        med = {m: float(np.median([x["ms_per_step"] for x in runs
                                   if x["mode"] == m]))
               for m in ("inline", "prefetch")}
        emit({"phase": f"prefetch_turns_{cell}", "card": CARD,
              "batch": len(batches[0]["text"]), "steps": PREFETCH_STEPS,
              "runs": runs, "median_ms_per_step": med})
        del step
    emit({"phase": "prefetch", "seconds": time.perf_counter() - t_phase})


DIST_STEPS = 3
# dist_train_w2's model: train's with encoder dropout 0.1 (and SpecAugment)
W2_MODEL_CFG = {**MODEL_CFG, "encoder": {**MODEL_CFG["encoder"],
                                         "dropout": [0.1] * 3}}


def train_launches(batch):
    """The kernel launches of one f32 ``train`` step of bench.py's LSTM
    model on ``batch`` rows: K1 1, K3 1, K2 and K2b once per encoder scan
    (times the waves of a grid that does not fit), no other kernel."""
    calls = scan_calls(batch)
    n_scans = len(MODEL_CFG["encoder"]["dim"]) * 2
    out = {k: 0 for k in launch_counters()}
    out.update({"fbank_fused": 1, "ctc_loss_fused": 1,
                "lstm_scan_fused": n_scans * calls["lstm_scan_fused"],
                "lstm_bwd_fused": n_scans * calls["lstm_bwd_fused"]})
    return out


def deterministic(on=True):
    """Deterministic cuDNN algorithms and deterministic PyTorch ops (those
    with no such version warn): the backward's atomics (cuDNN's
    convolution gradients, the embedding's index backward) otherwise
    reorder sums from run to run, which the data-parallel phases'
    comparisons would read as a difference."""
    import torch
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)


def dist_steps(solver, data, rows=None, n_steps=DIST_STEPS):
    """``n_steps`` train steps on ``data`` (a rank's rows, ``rows`` as the
    loaders give them): each step's loss, kernel launches and host ms (the
    step synchronised)."""
    import torch
    counters = launch_counters()
    losses, launches, ms = [], [], []
    for _ in range(n_steps):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = solver.train_step(*data, rows=rows)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: fn.launches for k, fn in counters.items()})
        losses.append(float(m["loss"]))
    return losses, launches, ms


def split_steps(solver, data, world, n_steps=DIST_STEPS):
    """World ``world``'s arithmetic in this process, with no group: each
    step every rank's rows go through the forward and backward from the
    same generator state (draws at the global shape, losses over the
    global counts), the ranks' gradients are summed in rank order and the
    optimizer takes one step. Returns each step's loss (the ranks' sum)."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    text, tl = data[2], data[3]
    B = len(tl)
    per = B // world
    counts = torch.stack([(tl > 0).sum(), (text != 0).sum()]).to(
        torch.float32)
    losses = []
    for _ in range(n_steps):
        state = solver.gen.get_state()
        grads, loss = None, None
        for r in range(world):
            lo, hi = r * per, (r + 1) * per
            solver.gen.set_state(state)
            for p in solver.params.values():
                p.grad = None
            with mesh.batch_rows((lo, hi, B)):
                _, part = solver._forward_loss(
                    *(t[lo:hi].contiguous() for t in data),
                    solver.tf_rate(), counts)
            part.backward()
            g = {k: p.grad for k, p in solver.params.items()}
            grads = g if grads is None else {k: grads[k] + g[k] for k in g}
            loss = part.detach() if loss is None else loss + part.detach()
        for k, p in solver.params.items():
            p.grad = grads[k]
        solver.optimizer.step(solver.params)
        losses.append(float(loss))
    return losses


def params_rel_err(got, ref):
    """The largest, over the parameters, of max |got - ref| over the
    reference's max magnitude, and its parameter."""
    errs = {k: float((got[k].detach().to(ref[k].device) - ref[k]).abs().max()
                     / ref[k].abs().max().clamp(min=1e-30)) for k in ref}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def allreduce_times(solver, iters=5):
    """CUDA-event ms and profiler device ms of one ``all_reduce_grads`` of
    the solver's gradients (every rank must call it as often)."""
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    fn = lambda: mesh.all_reduce_grads(solver.params)
    return {"allreduce_ms": cuda_ms(fn, iters, warmup=1),
            "allreduce_device_ms": device_ms(fn, iters, by_kernel=True),
            "allreduce_mb": 4 * sum(p.numel()
                                    for p in solver.params.values()) / 1e6}


def phase_dist_train(batch, seed, device):
    """A world-1 NCCL group in this process: DIST_STEPS steps of
    ``Solver.train_step`` on train's batch against the same steps of a
    solver with no group (same seed, deterministic algorithms in both):
    losses and parameters within rel 1e-6, the launches of train's step,
    and the all-reduce's ms per step. Also how far two runs with no group
    drift apart without deterministic algorithms."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        data = train_batch(batch, seed + 6, device)
        runs = []
        for det in (False, False, True, True):
            deterministic(det)
            plain = make_solver(device, seed, Path(d))
            ref_losses, _, ref_ms = dist_steps(plain, data)
            runs.append({k: v.detach().clone()
                         for k, v in plain.params.items()})
            del plain
        ref = runs[2]
        mesh.init(device, backend="nccl", init_method=f"file://{d}/store",
                  rank=0, world=1)
        try:
            solver = make_solver(device, seed, Path(d))
            losses, launches, ms = dist_steps(solver, data)
            got = {k: v.detach().clone() for k, v in solver.params.items()}
            times = allreduce_times(solver)
        finally:
            mesh.shutdown()
            deterministic(False)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    p_rel, worst = params_rel_err(got, ref)
    rerun_rel, _ = params_rel_err(runs[3], ref)
    nondet_rel, nondet_worst = params_rel_err(runs[1], runs[0])
    expect = train_launches(batch)
    emit({"phase": "dist_train", "backend": "nccl", "world": 1,
          "batch": batch, "steps": DIST_STEPS, "card": CARD,
          "losses": losses, "loss_rel_diff": loss_rel,
          "params_rel_diff": p_rel, "worst_param": worst,
          "params_rel_diff_no_group_rerun": rerun_rel,
          "params_rel_diff_rerun_nondeterministic": nondet_rel,
          "worst_param_nondeterministic": nondet_worst,
          "ms_per_step": ms, "ms_per_step_no_group": ref_ms, **times,
          "launches_per_step": launches[-1]})
    check(loss_rel <= 1e-6 and p_rel <= 1e-6,
          f"dist_train: world-1 group vs no group loss {loss_rel}, "
          f"params {p_rel} ({worst})")
    check(all(st == expect for st in launches),
          f"dist_train: every step must launch {expect}, got {launches}")


def dist_w2_child(rank, world, backend, store, out_dir, seed, batch):
    """One rank of dist_train_w2: its rows of train's batch, DIST_STEPS
    steps, the all-reduce timed; writes its losses, launches, times and
    parameters to ``out_dir``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    mesh.init(dev, backend=backend, init_method=store, rank=rank,
              world=world, timeout=300)
    deterministic()
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            solver = make_solver(dev, seed, Path(d), W2_MODEL_CFG,
                                 augment=AUG_CFG)
        per = batch // world
        lo, hi = rank * per, (rank + 1) * per
        data = tuple(t[lo:hi].contiguous()
                     for t in train_batch(batch, seed + 6, dev))
        losses, launches, ms = dist_steps(solver, data, rows=(lo, hi, batch))
        times = allreduce_times(solver)
        torch.save({"losses": losses, "launches": launches, "ms": ms,
                    **times, "params": {k: v.detach().cpu() for k, v in
                                        solver.params.items()}},
                   f"{out_dir}/rank{rank}.pt")
    finally:
        mesh.shutdown()


def phase_dist_train_w2(batch, seed, device, world=2):
    """Two ranks of 16 rows each (gloo over CUDA tensors on the one card, or
    NCCL on two cards where there are two), encoder dropout 0.1 and
    SpecAugment on, against world 1 in this process on the same seed
    (deterministic algorithms in both): after DIST_STEPS steps the ranks'
    losses and parameters bit-identical to each other and to the same
    split computed in this process with no group (``split_steps``), and
    against world 1 loss rel <= 1e-5 and parameters within 1e-3 of their
    max (summing two half-batch gradients rounds otherwise than one
    whole-batch sum: ~2e-4 of a bias's max after Adadelta's three steps);
    each rank's launches those of train's step."""
    import torch
    import torch.multiprocessing as mp
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        deterministic()
        ref_solver = make_solver(device, seed, Path(d), W2_MODEL_CFG,
                                 augment=AUG_CFG)
        data = train_batch(batch, seed + 6, device)
        ref_losses, _, ref_ms = dist_steps(ref_solver, data)
        ref = {k: v.detach() for k, v in ref_solver.params.items()}
        del ref_solver
        split = make_solver(device, seed, Path(d), W2_MODEL_CFG,
                            augment=AUG_CFG)
        split_losses = split_steps(split, data, world)
        deterministic(False)
        emul = {k: v.detach() for k, v in split.params.items()}
        del split
        t0 = time.perf_counter()
        ctx = mp.spawn(dist_w2_child, args=(world, backend, f"file://{d}/store",
                                            d, seed, batch),
                       nprocs=world, join=False)
        try:
            while not ctx.join(timeout=5):
                check(time.perf_counter() - t0 < 600,
                      "dist_train_w2: the ranks ran past 600 s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        res = [torch.load(f"{d}/rank{r}.pt") for r in range(world)]
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(res[0]["losses"], ref_losses))
    p_rel, worst = params_rel_err(res[0]["params"], ref)
    split_rel, split_worst = params_rel_err(emul, ref)
    exact = (res[0]["losses"] == split_losses and all(
        torch.equal(res[0]["params"][k].to(device), emul[k]) for k in emul))
    same = all(r["losses"] == res[0]["losses"] and all(
        torch.equal(r["params"][k], res[0]["params"][k]) for k in ref)
        for r in res[1:])
    expect = train_launches(batch // world)
    emit({"phase": "dist_train_w2", "backend": backend, "world": world,
          "cards": min(world, torch.cuda.device_count()),
          "rows_per_rank": batch // world, "steps": DIST_STEPS,
          "card": CARD, "losses": res[0]["losses"],
          "losses_world1": ref_losses, "loss_rel_diff": loss_rel,
          "params_rel_diff": p_rel, "worst_param": worst,
          "ranks_bit_identical": same,
          "equals_split_in_one_process": exact,
          "split_params_rel_diff": split_rel, "split_worst_param": split_worst,
          "ms_per_step": [r["ms"] for r in res],
          "ms_per_step_world1": ref_ms,
          **{k: [r[k] for r in res] for k in ("allreduce_ms",
                                                "allreduce_device_ms")},
          "allreduce_mb": res[0]["allreduce_mb"], "wall_seconds": wall,
          "launches_per_step": [r["launches"][-1] for r in res]})
    check(loss_rel <= 1e-5, f"dist_train_w2: loss rel diff {loss_rel}")
    check(p_rel <= 1e-3, f"dist_train_w2: params rel diff {p_rel} ({worst})")
    check(same, "dist_train_w2: the ranks' parameters differ")
    check(exact, "dist_train_w2: the ranks' losses or parameters differ "
          "from the same split computed in one process")
    check(all(st == expect for r in res for st in r["launches"]),
          f"dist_train_w2: every rank's step must launch {expect}, got "
          f"{[r['launches'] for r in res]}")


def pad_rows(tensors, rows, seed):
    """Two copies of (wave, wave_len, text, text_len) with ``rows`` made
    zero-length (lengths and labels 0): one with zero waves (the padding a
    loader adds), one with random samples there, which a length of 0 must
    hide."""
    import torch
    zero = [t.clone() for t in tensors]
    for t in zero:
        t[rows] = 0
    noisy = [t.clone() for t in zero]
    g = torch.Generator(device=noisy[0].device).manual_seed(seed)
    noisy[0][rows] = (0.1 * torch.randn(
        noisy[0][rows].shape, generator=g, device=noisy[0].device)).to(
        noisy[0].dtype)
    return zero, noisy


def pad_decode(frontend, seed, device, name, model_cfg, decode_cfg, vocab,
               kernel):
    """Beam decoding of 4 waves whose last is zero-length, its samples zero
    and random: finite top-1 scores, ``kernel`` launched, and the real rows'
    tokens, lengths and scores identical whatever the dummy row holds."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.decode.beam import BeamDecoder
    model, lm = slice_models(frontend, seed, vocab, device, model_cfg)
    decoder = BeamDecoder(model, decode_cfg, lm=lm)
    w, wl = make_waves(4, seed + 2)
    rows = torch.tensor([3], device=device)
    outs, launches = [], None
    counters = launch_counters()
    for wave, wave_len in pad_rows(
            [torch.from_numpy(w).to(device), torch.from_numpy(wl).to(device)],
            rows, seed):
        for fn in counters.values():
            fn.launches = 0
        with torch.no_grad():
            outs.append(decoder.forward(*frontend(wave, wave_len)))
        launches = launches or {k: fn.launches for k, fn in counters.items()
                                if fn.launches}
    a, b = outs
    top1 = a.scores[:, 0]
    same = (torch.equal(a.tokens[:3], b.tokens[:3])
            and torch.equal(a.lengths[:3], b.lengths[:3])
            and torch.equal(a.scores[:3], b.scores[:3]))
    ok = bool(torch.isfinite(top1).all()) and bool((top1 > -1e29).all())
    check(ok and same and launches.get(kernel, 0) > 0,
          f"dist_pad {name}: top-1 finite {ok}, real rows identical {same}, "
          f"launches {launches}")
    return {"launches": launches, "dummy_top1": float(top1[3]),
            "real_rows_identical": same}


def phase_dist_pad(frontend, batch, seed, device, n_pad=2):
    """train's batch with ``n_pad`` rows made zero-length (the padding of a
    global batch; attention.use_pallas_train, so K1, K2, K2b, K3 and K7 all
    see them): every gradient finite and bit-identical whether those rows'
    waves are zero or random (they add exactly nothing), and against the
    batch without those rows the loss within rel 1e-5 and the gradients
    within 1e-3 of their max (another batch shape sums in another order);
    then decoding with a zero-length row through K5 + K8 and through K6."""
    import torch
    cfg = with_attention(use_pallas_train=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        solver = make_solver(device, seed, Path(d), cfg)
    data = train_batch(batch, seed + 6, device)
    pad = torch.argsort(data[1])[:n_pad]         # never the longest wave
    keep = torch.tensor([i for i in range(batch) if i not in set(
        pad.tolist())], device=device)
    zero, noisy = pad_rows(data, pad, seed)
    real = [t[keep].contiguous() for t in data]
    counters = launch_counters()
    out = []
    deterministic()
    for rows in (zero, noisy, real):
        for fn in counters.values():
            fn.launches = 0
        solver.gen.manual_seed(seed + 1)
        for p in solver.params.values():
            p.grad = None
        _, loss = solver._forward_loss(*rows, solver.tf_rate(), None)
        loss.backward()
        out.append((float(loss.detach()), {k: p.grad.detach().clone()
                                  for k, p in solver.params.items()},
                    {k: fn.launches for k, fn in counters.items()
                     if fn.launches}))
    deterministic(False)
    (lz, gz, launches), (ln, gn, _), (lr, gr, _) = out
    finite = all(bool(torch.isfinite(g).all())
                 for g in list(gz.values()) + list(gn.values()))
    exact = lz == ln and all(torch.equal(gz[k], gn[k]) for k in gz)
    g_rel, worst = params_rel_err(gz, gr)
    loss_rel = abs(lz - lr) / abs(lr)
    dec = {name: pad_decode(frontend, seed, device, name, *args)
           for name, *args in (
               ("k5_k8", with_attention(use_pallas=True), DECODE_CFG, V_CHAR,
                "beam_step_fused"),
               ("k6", MODEL_CFG, {**DECODE_CFG, "amp": True,
                                  "psi_kernel": True}, V_SUB, "psi_fused"))}
    emit({"phase": "dist_pad", "batch": batch, "zero_length_rows": n_pad,
          "padded_rows": pad.tolist(), "loss_padded": lz, "loss_real": lr,
          "loss_rel_diff": loss_rel, "grads_finite": finite,
          "grads_identical_zero_vs_random_dummy": exact,
          "grads_rel_diff_vs_real_rows": g_rel, "worst_grad": worst,
          "launches": launches, "decode": dec})
    check(finite, "dist_pad: non-finite gradients with zero-length rows")
    check(exact, "dist_pad: the zero-length rows' contents moved the loss "
          "or a gradient")
    check(loss_rel <= 1e-5 and g_rel <= 1e-3,
          f"dist_pad: padded vs real loss {loss_rel}, gradients {g_rel} "
          f"({worst})")
    check(launches.get("loc_att_fwd_fused") == U_TRAIN
          and launches.get("loc_att_bwd_fused") == U_TRAIN
          and launches.get("ctc_loss_fused") == 1
          and launches.get("fbank_fused") == 1,
          f"dist_pad: launches {launches}")


def phase_dist_entry(seed, n_utts=8):
    """``torchrun --standalone --nproc_per_node=1`` for ``main`` (bench.py's
    model, 2 steps and a validation on a generated corpus: a world-1 NCCL
    group, one log.jsonl, a latest.pth) and ``main --test`` (bench.py's
    model, random weights from ``seed``), whose CSVs must equal those of
    ``main --test`` without torchrun (tokens identical, scores within
    1e-4); the three runs at the same time."""
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
    from end_to_end_asr_pytorch_tpu_torch.utils.text import load_text_encoder
    from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import asr_state_dict
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        corpus = generate_corpus(str(d / "synth"), n_train=2 * n_utts,
                                 n_dev=n_utts, n_test=n_utts, seed=seed)
        cfg = {"data": {"corpus": {"name": "synthetic", "path": str(corpus),
                                   "train_split": ["train-clean"],
                                   "dev_split": ["dev-clean"],
                                   "test_split": ["test-clean"],
                                   "batch_size": n_utts},
                        "audio": AUDIO_CFG,
                        "text": {"mode": "character",
                                 "vocab_file": str(corpus / "vocab.txt")}},
               "model": MODEL_CFG,
               "hparas": {**TRAIN_HPARAS, "valid_step": 2, "max_step": 2,
                          "PROGRESS_STEP": 1},
               "decode": {k: v for k, v in DECODE_CFG.items()
                          if k != "lm_weight"}}
        (d / "dp.yaml").write_text(yaml.safe_dump(cfg))
        dirs = ["--config", str(d / "dp.yaml"), "--seed", str(seed),
                "--logdir", str(d / "log"), "--ckpdir", str(d / "ckpt")]
        # --test decodes bench.py's model with random weights from seed, so
        # the three runs go side by side on the card
        vocab = load_text_encoder("character",
                                  str(corpus / "vocab.txt")).vocab_size
        model = ASR(AUDIO_CFG["feat_dim"], vocab, MODEL_CFG,
                    generator=torch.Generator().manual_seed(seed))
        torch.save({"model": asr_state_dict(model), "global_step": 0},
                   str(d / "asr.pth"))
        runs = run_mains([("torchrun main", TORCHRUN, dirs)] + [
            (how, launcher, [*dirs, "--test", "--load", str(d / "asr.pth"),
                             "--outdir", str(d / how)])
            for how, launcher in (("plain", []), ("torchrun", TORCHRUN))])
        out, train_s = runs.pop("torchrun main")
        check("| world 1 (nccl)" in out, f"torchrun main: {out[-1000:]}")
        logs = list((d / "log").rglob("log.jsonl"))
        entries = [json.loads(ln) for ln in logs[0].read_text().splitlines()]
        per_step = sum(e["step"] == 1 and e["name"] == "loss" for e in entries)
        check(len(logs) == 1 and per_step == 1
              and (d / "ckpt" / f"dp_sd{seed}" / "latest.pth").exists(),
              f"torchrun main: logs {logs}, step-1 loss entries {per_step}")
        secs = {how: r[1] for how, r in runs.items()}
        csvs = {how: {s: read_test_csvs({
            k: (d / how / f"dp_sd{seed}" / f"{s}_{k}.csv").read_text()
            for k in ("output", "beam")}) for s in ("dev", "test")}
            for how in runs}
    same = all(csvs["plain"][s][0] == csvs["torchrun"][s][0]
               for s in ("dev", "test"))
    diff = max(abs(csvs["plain"][s][1][k] - csvs["torchrun"][s][1][k])
               for s in ("dev", "test") for k in csvs["plain"][s][1])
    rows = [csvs["torchrun"][s][2] for s in ("dev", "test")]
    emit({"phase": "dist_entry", "utts_per_split": n_utts,
          "train_seconds": train_s, "test_seconds": secs,
          "log_entries": len(entries), "hyps_identical": same,
          "best_score_max_abs_diff": diff, "nbest_rows": rows})
    check(same and diff <= 1e-4,
          f"dist_entry: torchrun --test vs plain: hyps identical {same}, "
          f"best score diff {diff}")
    check(rows == [8 * n_utts] * 2, f"dist_entry: n-best rows {rows}")


# ------------------------------------------------------ tensor parallel
# config/synthetic/las_sub16k.yaml's model and lm_sub16k.yaml's LM at full
# width (V=16384), random weights from --seed
def sub16k_cfg(name):
    import yaml
    return yaml.safe_load((ROOT / "config" / "synthetic" / name).read_text())


V_16K = 16384
TP_STEPS = 3
TP_HPARAS = {"optimizer": "Adam", "lr": 1e-3, "eps": 1e-8,
             "lr_scheduler": "fixed", "tf_start": 1.0, "tf_end": 1.0,
             "GRAD_CLIP": 5.0}


def tp_solver(kind, device, seed, workdir, m, model):
    """The port's ASR (``kind`` "asr") or LM ("lm") training solver at
    ``model_parallel: m`` on ``model``, V=16384, Adam lr 1e-3, set up as
    ``main`` / ``main --lm`` set it up but without a corpus."""
    from types import SimpleNamespace
    from end_to_end_asr_pytorch_tpu_torch.solvers import train_asr, train_lm
    data = {"corpus": {"name": "none"}, "text": {"mode": "subword"}}
    if kind == "asr":
        data["audio"] = AUDIO_CFG
    cfg = {"data": data, "model": model, "hparas": dict(TP_HPARAS),
           "model_parallel": m}
    paras = SimpleNamespace(config=f"tp_{kind}.yaml", name=None, seed=seed,
                            logdir=str(workdir / "log"),
                            ckpdir=str(workdir / "ckpt"), load=None,
                            njobs=0, no_msg=True, cpu=False, amp=False)
    solver = (train_asr if kind == "asr" else train_lm).Solver(cfg, paras)
    solver.vocab_size = V_16K
    if kind == "asr":
        solver.feat_dim = AUDIO_CFG["feat_dim"]
    solver.set_model()
    return solver


def tp_bytes(solver):
    """Bytes of the parameters and of the optimizer slots this rank
    holds."""
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    return {"params": size(solver.params.values()),
            "slots": size(v for d in solver.optimizer.slots.values()
                          for v in d.values())}


def tp_train_run(kind, dev, seed, batch, m, workdir, rank, world):
    """One rank (or world 1, no group) of tp_train / tp_lm_train: its rows
    of the global batch (by data index), TP_STEPS steps, then one more
    with the model group's collectives timed and deterministic algorithms
    off, as ``main`` runs; bytes after setup and the step's peak; the
    whole parameters after TP_STEPS (rank 0) and the replicated ones after
    TP_STEPS and after the last step."""
    import torch
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh, tp
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    if kind == "asr":
        model = sub16k_cfg("las_sub16k.yaml")["model"]
        model["attention"]["use_pallas_train"] = True
        full = train_batch(batch, seed + 6, dev, V=V_16K)
    else:
        model = sub16k_cfg("lm_sub16k.yaml")["model"]
        full = lm_batch(seed + 6, dev, B=batch, lo=20, hi=80, V=V_16K)
    solver = tp_solver(kind, dev, seed, workdir, m, model)
    torch.cuda.synchronize(dev)
    setup = torch.cuda.memory_allocated(dev) - base
    per = batch // (world // m)
    lo = (rank // m) * per
    data = tuple(t[lo:lo + per].contiguous() for t in full)
    rows = (lo, lo + per, batch) if world > 1 else None
    torch.cuda.reset_peak_memory_stats(dev)
    losses, launches, ms = dist_steps(solver, data, rows, TP_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    with tp.whole(solver.params, solver.split, solver.optimizer):
        whole = {k: v.detach().cpu().clone()
                 for k, v in solver.params.items()}
    deterministic(False)
    with mesh.time_collectives() as coll:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        solver.train_step(*data, rows=rows)
        torch.cuda.synchronize(dev)
        timed_ms = (time.perf_counter() - t0) * 1e3
    return {"losses": losses, "launches": launches, "ms": ms,
            "setup_bytes": setup, "held": tp_bytes(solver),
            "peak_bytes": peak, "split": sorted(solver.split),
            "whole": whole if rank == 0 else None,
            "replicated": {k: v for k, v in whole.items()
                           if k not in solver.split},
            "replicated_free": {k: v.detach().cpu().clone()
                                for k, v in solver.params.items()
                                if k not in solver.split},
            "collectives": dict(coll), "timed_step_ms": timed_ms}


def tp_test_run(dev, seed, cfg_path, m, out_dir, rank, world):
    """One rank (or world 1) of tp_test: the Solver of ``main --test`` on
    ``cfg_path`` at ``model_parallel: m``; the launches and the beam steps
    of its run; then the dev split again, warm (ms per batch), and once
    more with the model group's collectives timed."""
    import torch
    from types import SimpleNamespace
    from end_to_end_asr_pytorch_tpu_torch.config import load_config
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    from end_to_end_asr_pytorch_tpu_torch.solvers.test_asr import Solver
    config = load_config(cfg_path)
    config["model_parallel"] = m
    cfg = Path(cfg_path)
    paras = SimpleNamespace(config=str(cfg), name=None, seed=seed,
                            logdir=str(cfg.parent / "log"),
                            ckpdir=str(cfg.parent / "ckpt"),
                            outdir=str(out_dir), load=str(cfg.parent / "asr.pth"),
                            njobs=0, no_msg=True, cpu=False, test=True)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    solver = Solver(config, paras, "test")
    solver.load_data()
    solver.set_model()
    torch.cuda.synchronize(dev)
    setup = torch.cuda.memory_allocated(dev) - base
    steps = []
    decode = solver.decoder.forward

    def counted(*a):
        out = decode(*a)
        steps.append(solver.decoder.last_steps)
        return out
    solver.decoder.forward = counted
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    solver.exec()
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    run_steps = list(steps)
    t0 = time.perf_counter()
    solver._decode_set("dev", solver.dv_set)
    torch.cuda.synchronize(dev)
    warm_ms = (time.perf_counter() - t0) * 1e3 / (len(steps) - len(run_steps))
    with mesh.time_collectives() as coll:
        t0 = time.perf_counter()
        solver._decode_set("dev", solver.dv_set)
        torch.cuda.synchronize(dev)
        timed = time.perf_counter() - t0
    size = lambda mod: sum(p.numel() * p.element_size()
                           for p in mod.parameters())
    return {"launches": launches, "steps": run_steps, "seconds": secs,
            "ms_per_batch": warm_ms, "setup_bytes": setup,
            "held": {"asr": size(solver.model), "lm": size(solver.lm)},
            "peak_bytes": peak, "split": sorted(solver.split),
            "collectives": dict(coll), "timed_dev_split_s": timed}


def tp_child(rank, world, m, backend, store, out_dir, seed, what, arg):
    """One rank of a tensor-parallel phase: joins the group (gloo over CUDA
    tensors on one card, or NCCL with a card a rank), deterministic
    algorithms on, runs ``what`` and writes its result to ``out_dir``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    mesh.init(dev, backend=backend, init_method=store, rank=rank,
              world=world, timeout=300)
    deterministic()
    try:
        if what == "test":
            out = tp_test_run(dev, seed, arg, m, Path(out_dir) / "out",
                              rank, world)
        else:
            out = tp_train_run(what, dev, seed, arg, m, Path(out_dir) / "w",
                               rank, world)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        mesh.shutdown()


def tp_spawn(world, m, d, seed, what, arg, limit=600):
    """``world`` ranks of ``tp_child`` at ``model_parallel: m`` ->
    (backend, their results in rank order, wall seconds)."""
    import torch
    import torch.multiprocessing as mp
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    t0 = time.perf_counter()
    ctx = mp.spawn(tp_child, args=(world, m, backend, f"file://{d}/store",
                                   str(d), seed, what, arg),
                   nprocs=world, join=False)
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() - t0 < limit,
                  f"tp {what}: the ranks ran past {limit} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return (backend, [torch.load(f"{d}/rank{r}.pt") for r in range(world)],
            time.perf_counter() - t0)


def tp_expect(kind, batch):
    """Each rank's launches a step: K1 once, K2 and K2b once per scan (4
    encoder scans of las_sub16k, 2 LM layers; times the waves of a grid
    that does not fit), K3 once, K7's forward and backward once per label
    step; no other kernel."""
    out = {k: 0 for k in launch_counters()}
    calls = scan_calls(batch, H=256)
    n = 4 if kind == "asr" else 2
    out.update({"lstm_scan_fused": n * calls["lstm_scan_fused"],
                "lstm_bwd_fused": n * calls["lstm_bwd_fused"]})
    if kind == "asr":
        out.update({"fbank_fused": 1, "ctc_loss_fused": 1,
                    "loc_att_fwd_fused": U_TRAIN,
                    "loc_att_bwd_fused": U_TRAIN})
    return out


def phase_tp_train(kind, seed, device, layout="1x2", batch=None):
    """tp_train (``kind`` "asr": las_sub16k's model, B=32 waves of 7 s,
    U=96, attention.use_pallas_train) or tp_lm_train ("lm": lm_sub16k's
    LM, B=64 sentences of 20-80 tokens): TP_STEPS Adam steps at the
    ``layout`` D x M (two ranks on the one card under gloo; NCCL with a
    card a rank where there are enough) against world 1 in this process,
    deterministic algorithms in both: loss rel <= 1e-5, the gathered
    parameters within 1e-3 of each tensor's max, the replicated leaves
    bit-identical across the ranks, each rank's launches a step as
    ``tp_expect``; bytes held at M=1 and per rank, the step's peak, ms per
    step and the model group's collectives' ms in one more step, which
    runs without deterministic algorithms, as ``main`` does: the
    replicated leaves must still be bit-identical after it."""
    import torch
    D, m = map(int, layout.split("x"))
    world = D * m
    name = ("tp_train" if kind == "asr" else "tp_lm_train") + (
        "" if layout == "1x2" else f"_{layout}")
    batch = batch or (32 if kind == "asr" else LM_B)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        deterministic()
        try:
            ref = tp_train_run(kind, device, seed, batch, 1, d / "w1", 0, 1)
        finally:
            deterministic(False)
        torch.cuda.empty_cache()
        backend, res, wall = tp_spawn(world, m, d, seed, kind, batch)
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(res[0]["losses"], ref["losses"]))
    p_rel, worst = params_rel_err(res[0]["whole"], ref["whole"])
    same, free = (all(torch.equal(r[key][k], res[0][key][k])
                      for r in res[1:] for k in res[0][key])
                  for key in ("replicated", "replicated_free"))
    expect = tp_expect(kind, batch // D)
    coll = [r["collectives"] for r in res]
    emit({"phase": name, "backend": backend, "layout": layout,
          "world": world, "cards": min(world, torch.cuda.device_count()),
          "batch": batch, "steps": TP_STEPS, "card": CARD, "vocab": V_16K,
          "losses": res[0]["losses"], "losses_world1": ref["losses"],
          "loss_rel_diff": loss_rel, "params_rel_diff": p_rel,
          "worst_param": worst, "replicated_bit_identical": same,
          "replicated_bit_identical_nondeterministic_step": free,
          "replicated_leaves": sorted(res[0]["replicated"]),
          "split_leaves": len(res[0]["split"]),
          "bytes_world1": {"setup": ref["setup_bytes"], **ref["held"],
                           "peak_step": ref["peak_bytes"]},
          "bytes_per_rank": [{"setup": r["setup_bytes"], **r["held"],
                              "peak_step": r["peak_bytes"]} for r in res],
          "ms_per_step": [r["ms"] for r in res],
          "ms_per_step_world1": ref["ms"],
          "collective_ms": [c["ms"] for c in coll],
          "collective_mb": [c["bytes"] / 1e6 for c in coll],
          "collective_calls": [c["calls"] for c in coll],
          "timed_step_ms": [r["timed_step_ms"] for r in res],
          "wall_seconds": wall,
          "launches_per_step": [r["launches"][-1] for r in res],
          "launches_expected": expect})
    check(loss_rel <= 1e-5, f"{name}: loss rel diff {loss_rel}")
    check(p_rel <= 1e-3, f"{name}: params rel diff {p_rel} ({worst})")
    check(same, f"{name}: the ranks' replicated leaves differ")
    check(free, f"{name}: the ranks' replicated leaves differ after a step "
          "without deterministic algorithms")
    check(all(st == expect for r in res for st in r["launches"]),
          f"{name}: every rank's step must launch {expect}, got "
          f"{[r['launches'] for r in res]}")
    check(all(r["held"]["params"] < ref["held"]["params"] for r in res),
          f"{name}: a rank holds as many parameter bytes as world 1")


def phase_tp_test(seed, device, layout="1x2", n_utts=8):
    """The Solver of ``main --test`` at ``layout`` D x M on generated dev and
    test splits of n_utts utterances each (las_sub16k's model and
    lm_sub16k's LM, random weights from ``seed``, a generated 16384-piece
    sentencepiece model; LM fusion 0.3, CTC 0.3, beam 8, amp off,
    attention.use_pallas: K5 and K8 once per beam step) against world 1's
    CSVs: each best score within 1e-4, the identical top-1 rows counted."""
    import torch
    import yaml
    from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
    from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR
    from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM
    from end_to_end_asr_pytorch_tpu_torch.utils.sentencepiece_model import (
        serialize_model_proto)
    from end_to_end_asr_pytorch_tpu_torch.utils.torch_ckpt import (
        asr_state_dict, lm_state_dict)
    D, m = map(int, layout.split("x"))
    name = "tp_test" + ("" if layout == "1x2" else f"_{layout}")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = Path(d)
        corpus = generate_corpus(str(d / "synth"), n_train=0, n_dev=n_utts,
                                 n_test=n_utts, seed=seed)
        (d / "sp.model").write_bytes(serialize_model_proto(
            sentencepiece_pieces(V_16K)))
        text = {"mode": "subword", "vocab_file": str(d / "sp.model")}
        data = {"corpus": {"name": "synthetic", "path": str(corpus),
                           "dev_split": ["dev-clean"],
                           "test_split": ["test-clean"],
                           "batch_size": n_utts},
                "audio": AUDIO_CFG, "text": text}
        las, lm_cfg = sub16k_cfg("las_sub16k.yaml"), sub16k_cfg(
            "lm_sub16k.yaml")
        model = las["model"]
        model["attention"]["use_pallas"] = True
        (d / "lm.yaml").write_text(yaml.safe_dump(
            {"data": {k: data[k] for k in ("corpus", "text")},
             "model": lm_cfg["model"], "hparas": {}}))
        asr = ASR(AUDIO_CFG["feat_dim"], V_16K, model,
                  generator=torch.Generator().manual_seed(seed))
        torch.save({"model": asr_state_dict(asr), "global_step": 0},
                   str(d / "asr.pth"))
        lm = RNNLM(V_16K, lm_cfg["model"],
                   generator=torch.Generator().manual_seed(seed + 1))
        torch.save({"model": lm_state_dict(lm)}, str(d / "lm.pth"))
        decode = {**DECODE_CFG, "min_len_ratio": 0.0,
                  "lm_config": str(d / "lm.yaml"), "lm_path": str(d / "lm.pth")}
        (d / "tp.yaml").write_text(yaml.safe_dump(
            {"data": data, "model": model, "hparas": {}, "decode": decode}))
        deterministic()
        try:
            ref = tp_test_run(device, seed, str(d / "tp.yaml"), 1, d / "w1",
                              0, 1)
        finally:
            deterministic(False)
        torch.cuda.empty_cache()
        backend, res, wall = tp_spawn(D * m, m, d, seed, "test",
                                      str(d / "tp.yaml"))
        csvs = {how: {s: read_test_csvs({
            k: (d / how / f"tp_sd{seed}" / f"{s}_{k}.csv").read_text()
            for k in ("output", "beam")}) for s in ("dev", "test")}
            for how in ("w1", "out")}
    identical = sum(csvs["out"][s][0][k] == csvs["w1"][s][0][k]
                    for s in ("dev", "test") for k in csvs["w1"][s][0])
    diff = max(abs(csvs["out"][s][1][k] - csvs["w1"][s][1][k])
               for s in ("dev", "test") for k in csvs["w1"][s][1])
    rows = [csvs["out"][s][2] for s in ("dev", "test")]
    steps = [sum(r["steps"]) for r in res]
    coll = [r["collectives"] for r in res]
    emit({"phase": name, "backend": backend, "layout": layout,
          "world": D * m, "utts_per_split": n_utts, "card": CARD,
          "vocab": V_16K, "top1_identical": identical,
          "top1_rows": 2 * n_utts, "best_score_max_abs_diff": diff,
          "nbest_rows": rows, "beam_steps": [r["steps"] for r in res],
          "beam_steps_world1": ref["steps"],
          "launches": [r["launches"] for r in res],
          "launches_world1": ref["launches"],
          "bytes_world1": {"setup": ref["setup_bytes"], **ref["held"],
                           "peak_decode": ref["peak_bytes"]},
          "bytes_per_rank": [{"setup": r["setup_bytes"], **r["held"],
                              "peak_decode": r["peak_bytes"]} for r in res],
          "ms_per_batch": [r["ms_per_batch"] for r in res],
          "ms_per_batch_world1": ref["ms_per_batch"],
          "first_run_seconds": [r["seconds"] for r in res],
          "first_run_seconds_world1": ref["seconds"],
          "collective_ms_dev_split": [c["ms"] for c in coll],
          "collective_mb_dev_split": [c["bytes"] / 1e6 for c in coll],
          "collective_calls_dev_split": [c["calls"] for c in coll],
          "timed_dev_split_s": [r["timed_dev_split_s"] for r in res],
          "wall_seconds": wall})
    print(f"tp_test: {identical} of {2 * n_utts} top-1 rows identical to "
          "world 1", flush=True)
    check(diff <= 1e-4, f"{name}: best score diff {diff}")
    check(rows == [8 * n_utts] * 2, f"{name}: n-best rows {rows}")
    check(all(n > 0 for n in steps) and all(
        r["launches"]["beam_step_fused"] == n
        and r["launches"]["loc_attention_fused"] == n
        for r, n in zip(res, steps)),
        f"{name}: K5 and K8 must launch once per beam step: steps {steps}, "
        f"launches {[r['launches'] for r in res]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--phases",
                    default="k1,k2,k2b,k3,k4,k4b,k5,k6,k7,k8,"
                            "slice,slice_plugin,"
                            "slice_fused,slice_fused_atk,slice_att,"
                            "entry,slice_amp,slice_sub5k,slice_sub5k_cand,"
                            "slice_sub5k_q8,slice_sub5k_win,"
                            "slice_sub5k_f32_cand,entry_sub5k,"
                            "slice_gru,entry_gru,slice_gru_amp,test_entry,"
                            "train,train_aug,train_att,train_plugin,"
                            "train_gru,train_amp,"
                            "train_gru_amp,train_att_amp,prefetch,"
                            "dist_train,"
                            "dist_train_w2,dist_pad,dist_entry,train_entry,"
                            "options_entry,native_text,"
                            "lm_scan,lm_train,lm_train_gru,flac_entry,"
                            "lm_entry,trained_entry,jax_orbax_entry,"
                            "jax_resume_entry,tp_train,tp_lm_train,tp_test",
                    help="comma list of phases after build (default: all "
                         "but scan_floor and mma_floor)")
    ap.add_argument("--tp-layouts", default="1x2",
                    help="comma list of D x M layouts the tp phases run "
                         "(1x2: two ranks on one card under gloo; a layout "
                         "of W ranks takes NCCL on W cards where there are "
                         "that many)")
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
    global CARD
    smi = CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    secs = build.build(["fbank", "lstm_scan", "ctc_loss", "loc_att",
                        "loc_att_train", "psi", "gru_scan", "beam_step"]
                       + [f for f in ("scan_floor", "mma_floor")
                          if f in phases])
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Function properties" in ln]
             for k, v in build.build_log.items()}
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas})

    frontend, _ = create_transform(AUDIO_CFG, device=device)
    kernels = {}
    if "k1" in phases:
        kernels["fbank_fused"] = phase_k1(frontend, args.batch, args.seed)
    if "k2" in phases:
        (kernels["lstm_scan_fused"], kernels["lstm_scan_bf16"],
         kernels["lstm_train_bf16"]) = phase_k2(args.seed, args.batch)
    if "scan_floor" in phases:
        phase_scan_floor()
    if "mma_floor" in phases:
        phase_mma_floor()
    if "k2b" in phases:
        (kernels["lstm_bwd_fused"],
         kernels["lstm_bwd_bf16"]) = phase_k2b(args.seed, args.batch)
    if "k3" in phases:
        kernels["ctc_loss_fused"] = phase_k3(args.seed, args.batch)
    if "k4" in phases:
        (kernels["gru_scan_fused"], kernels["gru_scan_bf16"],
         kernels["gru_train_bf16"]) = phase_k4(args.seed, args.batch)
    if "k4b" in phases:
        (kernels["gru_bwd_fused"],
         kernels["gru_bwd_bf16"]) = phase_k4b(args.seed, args.batch)
    if "k5" in phases:
        kernels["loc_attention_fused"] = phase_k5(args.seed, args.batch)
    if "k6" in phases:
        kernels["psi_fused"] = phase_k6(args.seed, args.batch)
    if "k7" in phases:
        (kernels["loc_att_fwd_fused"], kernels["loc_att_bwd_fused"],
         kernels["loc_att_fwd_bf16"],
         kernels["loc_att_bwd_bf16"]) = phase_k7(args.seed, args.batch)
    if "k8" in phases:
        (kernels["beam_step_fused"],
         kernels["beam_step_fused_v5120"]) = phase_k8(frontend, args.batch,
                                                      args.seed)

    if "lm_scan" in phases:
        phase_lm_scan(args.seed)
    if "lm_train" in phases:
        phase_lm_train(args.seed, device)
    if "lm_train_gru" in phases:
        phase_lm_train(args.seed, device, "lm_train_gru", "GRU")

    def record(launches, names):
        for name in names:
            if name in kernels:
                kernels[name]["launches"] = launches[name]

    sl_f32 = None
    at_once = []            # entry-point phases, run together below
    if "slice" in phases:
        sl = sl_f32 = phase_slice(frontend, args.batch, args.seed, device)
        record(sl["launches"], ("fbank_fused", "lstm_scan_fused"))
        if "slice_plugin" in phases:
            from end_to_end_asr_pytorch_tpu_torch.models.plugin import \
                EmbeddingRegularizer
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                plugin = EmbeddingRegularizer(
                    plugin_config(Path(d)), V_CHAR, 512,
                    generator=torch.Generator().manual_seed(args.seed + 7),
                    device=device)
            r = phase_slice_other(frontend, sl, DECODE_CFG, "slice_plugin",
                                  SLICE_EXPECT, plugin=plugin,
                                  against_plain=True)
            check(r["decoder"].last_fused is False,
                  "slice_plugin took K8's route")
        if "entry" in phases:
            at_once.append(functools.partial(phase_entry, sl["model"],
                                             args.seed))
    if "slice_fused" in phases:
        sl = phase_slice(frontend, args.batch, args.seed, device, "slice_fused",
                         decode_cfg=DECODE_CFG, expect=FUSED_EXPECT)
        check(sl["fused"] is True, "slice_fused did not take K8's route")
        record(sl["launches"], ("beam_step_fused",))
        if sl_f32 is not None:
            compare_slices(sl_f32, sl, "slice_fused_vs_slice", args.batch)
        if "slice_fused_atk" in phases:
            r = phase_slice_other(frontend, sl, {**DECODE_CFG,
                                                 "approx_topk": 0.95},
                                  "slice_fused_atk", FUSED_EXPECT,
                                  against_plain=True)
            check(torch.equal(r["out"].tokens, sl["out"].tokens)
                  and torch.equal(r["out"].lengths, sl["out"].lengths),
                  "slice_fused_atk: tokens differ from slice_fused's")
    if "slice_att" in phases:
        sl = phase_slice(frontend, args.batch, args.seed, device, "slice_att",
                         with_attention(use_pallas=True),
                         decode_cfg=DECODE_CFG,
                         expect={**FUSED_EXPECT, "loc_attention_fused": "steps"})
        record(sl["launches"], ("loc_attention_fused",))
    amp_expect = {"fbank_fused": 1, "lstm_scan_bf16": 6}
    auto_cfg = {k: v for k, v in DECODE_CFG.items() if k != "amp"}
    if "slice_amp" in phases:
        sl = phase_slice(frontend, args.batch, args.seed, device, "slice_amp",
                         decode_cfg=auto_cfg, expect=amp_expect)
        check(sl["amp"] is True, "decode.amp: auto did not resolve to bf16 "
              "on the card")
        record(sl["launches"], ("lstm_scan_bf16",))
        phase_slice_other(frontend, sl, DECODE_CFG, "slice_amp_vs_f32",
                          FUSED_EXPECT)
    sub5k = {"slice_sub5k", "entry_sub5k", "slice_sub5k_cand",
             "slice_sub5k_q8", "slice_sub5k_win", "slice_sub5k_f32_cand"}
    if phases & sub5k:
        sub_cfg = {**DECODE_CFG, "amp": True, "psi_kernel": True}
        sl = phase_slice(frontend, args.batch, args.seed, device,
                         "slice_sub5k", decode_cfg=sub_cfg, vocab=V_SUB,
                         expect={**amp_expect, "psi_fused": "steps"})
        record(sl["launches"], ("psi_fused",))
        phase_slice_other(frontend, sl, {**sub_cfg, "psi_kernel": False},
                          "slice_sub5k_no_psi_kernel", amp_expect)
        # f32 at V=5120: K8 (a cluster of 16 blocks per utterance)
        # against its plain version, end to end
        f32 = [phase_slice_other(frontend, sl, cfg, name, exp, breakdown=True)
               for cfg, name, exp in (
                   (DECODE_CFG, "slice_sub5k_f32", FUSED_EXPECT),
                   (UNFUSED_CFG, "slice_sub5k_f32_unfused", SLICE_EXPECT))]
        compare_slices(f32[0], f32[1], "slice_sub5k_f32_vs_unfused",
                       args.batch)
        if "beam_step_fused_v5120" in kernels:
            kernels["beam_step_fused_v5120"]["launches"] = \
                f32[0]["launches"]["beam_step_fused"]
        options = {
            "slice_sub5k_cand": ({**sub_cfg, "ctc_candidates": 128},
                                 {**amp_expect, "psi_fused": "steps"}),
            "slice_sub5k_q8": ({**sub_cfg, "psi_quant": "int8"}, amp_expect),
            "slice_sub5k_win": ({**sub_cfg, "ctc_window": 32,
                                 "psi_kernel": False}, amp_expect),
            "slice_sub5k_f32_cand": ({**DECODE_CFG, "ctc_candidates": 128},
                                     SLICE_EXPECT)}
        for name, (cfg, exp) in options.items():
            if name in phases:
                r = phase_slice_other(frontend, sl, cfg, name, exp,
                                      against_plain=True)
                check(r["decoder"].last_fused is False,
                      f"{name} took K8's route")
                if name == "slice_sub5k_q8":
                    check(r["decoder"].early_stop is False,
                          "slice_sub5k_q8: the early exit is on")
        if "entry_sub5k" in phases:
            at_once.append(functools.partial(
                phase_entry, sl["model"], args.seed, "entry_sub5k",
                {k: v for k, v in sub_cfg.items()
                 if k not in ("lm_weight", "amp")}, V_SUB))
    gru_expect = {"fbank_fused": 1, "gru_scan_fused": 6}
    gru = dict(model_cfg=GRU_MODEL_CFG, lm_cfg=GRU_LM_CFG)
    if "slice_gru" in phases or "entry_gru" in phases:
        sl = phase_slice(frontend, args.batch, args.seed, device, "slice_gru",
                         decode_cfg=DECODE_CFG,
                         expect={**gru_expect, "beam_step_fused": "steps"},
                         **gru)
        record(sl["launches"], ("gru_scan_fused",))
        if "entry_gru" in phases:
            at_once.append(functools.partial(
                phase_entry, sl["model"], args.seed, "entry_gru",
                model_cfg=GRU_MODEL_CFG))
    if "slice_gru_amp" in phases:
        sl = phase_slice(frontend, args.batch, args.seed, device,
                         "slice_gru_amp", decode_cfg=auto_cfg,
                         expect={"fbank_fused": 1, "gru_scan_bf16": 6},
                         breakdown=False, **gru)
        check(sl["amp"] is True, "decode.amp: auto did not resolve to bf16 "
              "on the card (GRU)")
        record(sl["launches"], ("gru_scan_bf16",))
        phase_slice_other(frontend, sl, DECODE_CFG, "slice_gru_amp_vs_f32",
                          {**gru_expect, "beam_step_fused": "steps"})
    if "test_entry" in phases:
        model, lm = ((sl_f32["model"], sl_f32["lm"]) if sl_f32 is not None
                     else slice_models(frontend, args.seed))
        phase_test_entry(model, lm, args.seed)
    if "train" in phases:
        launches = phase_train(args.batch, args.seed, device)
        record(launches, ("lstm_bwd_fused", "ctc_loss_fused"))
    if "train_aug" in phases:
        phase_train(args.batch, args.seed, device, "train_aug",
                    augment=AUG_CFG, breakdown=False)
    if "train_att" in phases:
        launches = phase_train(args.batch, args.seed, device, "train_att",
                               with_attention(use_pallas_train=True),
                               breakdown=False)
        record(launches, ("loc_att_fwd_fused", "loc_att_bwd_fused"))
    if "train_plugin" in phases:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            phase_train(args.batch, args.seed, device, "train_plugin",
                        {**with_attention(use_pallas_train=True),
                         "plugin": plugin_config(Path(d))}, breakdown=False)
    if "train_gru" in phases:
        launches = phase_train(args.batch, args.seed, device, "train_gru",
                               GRU_MODEL_CFG)
        record(launches, ("gru_bwd_fused",))
    if "train_amp" in phases:
        launches = phase_train(args.batch, args.seed, device, "train_amp",
                               amp=True)
        record(launches, ("lstm_train_bf16", "lstm_bwd_bf16"))
    if "train_gru_amp" in phases:
        launches = phase_train(args.batch, args.seed, device, "train_gru_amp",
                               GRU_MODEL_CFG, amp=True, breakdown=False)
        record(launches, ("gru_train_bf16", "gru_bwd_bf16"))
    if "train_att_amp" in phases:
        launches = phase_train(args.batch, args.seed, device, "train_att_amp",
                               with_attention(use_pallas_train=True),
                               amp=True, breakdown=False)
        record(launches, ("loc_att_fwd_bf16", "loc_att_bwd_bf16"))
    if "prefetch" in phases:
        phase_prefetch(args.batch, args.seed, device)
    if "dist_train" in phases:
        phase_dist_train(args.batch, args.seed, device)
    if "dist_train_w2" in phases:
        phase_dist_train_w2(args.batch, args.seed, device)
    if "dist_pad" in phases:
        phase_dist_pad(frontend, args.batch, args.seed, device)
    # the entry-point phases (the transcribe ones deferred from their
    # slices) run at once here, before the phases that time the host
    if "dist_entry" in phases:
        at_once.append(functools.partial(phase_dist_entry, args.seed))
    if "train_entry" in phases:
        at_once.append(functools.partial(phase_train_entry, args.seed))
    if "options_entry" in phases:
        at_once.append(functools.partial(phase_options_entry, args.seed))
    if "flac_entry" in phases or "lm_entry" in phases:
        at_once.append(functools.partial(phase_recipe_entry, args.seed,
                                         phases))
    run_at_once(at_once)
    del at_once
    if "native_text" in phases:
        phase_native_text(args.seed)
    if "trained_entry" in phases:
        phase_trained_entry(args.seed)
    if "jax_orbax_entry" in phases:
        phase_jax_orbax_entry(args.seed)
    if "jax_resume_entry" in phases:
        phase_jax_resume_entry(args.seed)
    for layout in args.tp_layouts.split(","):
        if "tp_train" in phases:
            phase_tp_train("asr", args.seed, device, layout)
        if "tp_lm_train" in phases:
            phase_tp_train("lm", args.seed, device, layout)
        if "tp_test" in phases:
            phase_tp_test(args.seed, device, layout)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    emit({"kernels": [{k: r.get(k) for k in order} for r in kernels.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
