#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``speechbrain_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only depthwise,relpos   # build + those checks
    python3 chip_smoke.py --only ctc                # K3/K4 records alone
    python3 chip_smoke.py --only transducer         # K8/K9 records alone
    python3 chip_smoke.py --phase recipe            # build + that phase
    python3 chip_smoke.py --phase train_crdnn_transducer,recipe_transducer
    python3 chip_smoke.py --phase recipe_timit,recipe_gsc
    python3 chip_smoke.py --phase recipe_voxceleb
    python3 chip_smoke.py --phase recipe_separation
    python3 chip_smoke.py --phase recipe_separation_rnn
    python3 chip_smoke.py --phase recipe_separation_more
    python3 chip_smoke.py --phase recipe_seq2seq
    python3 chip_smoke.py --phase recipe_lm,recipe_timit_seq2seq
    python3 chip_smoke.py --phase recipe_kspon,recipe_transformer,recipe_corpora
    python3 chip_smoke.py --phase recipe_commonvoice,recipe_slu
    python3 chip_smoke.py --phase recipe_st
    python3 chip_smoke.py --phase recipe_wav2vec
    python3 chip_smoke.py --phase recipe_wav2vec_families

Phases, each printing one JSON line when it ends:

1. build   -- compile every CUDA kernel from ``speechbrain_tpu_torch/csrc``.
2. kernels -- each kernel against its plain PyTorch version on the card,
   at the shapes the serving and training paths give it, in float32 and
   bfloat16 (CTC: float32): max |error| against the stated tolerance,
   kernel / plain / library times (CUDA events) and the least time the
   card could take (bound).  K1 (forward, dx), K2, K5 and K7 also give
   their device time and the library call's (profiler), and K1, K2 and
   K7 the host microseconds a call takes; K1's forward and K2 (with the
   bias gradient, as the backward calls it) are timed at every
   main-path shape, K7 at beam steps 200 and 57 and also as the decoder
   calls it (strided q/k/v views, int64 rows: one device kernel).  K3
   and K4 (CTC) give the same (card ms, device ms, host us, device
   kernels a call by name, the library call's device ms), that two calls
   give the same bits, their time at B1 U0 (``chain_floor_ms``, the frame
   chain alone) and ``chain_term_ms``: 251 dependent steps of JAX's
   ``lae(lae(a, a1), a2) + x`` behind one warp shuffle, timed by a
   one-warp loop built here (``_chain_step_ms``); and that the kernels'
   branch-free log1p gives log1pf's bits on all of [0, 1].  K8 and K9
   (RNN-T) give the same fields at U 64 and U 256 (role "wide"), with
   ``chain_term_ms`` from the transducer form of the probe (``lae(a + x,
   a1 + y)``, T + U steps), ``chain_floor_ms`` at B1 U0 T251,
   and ``bit_identical_two_calls``.  The rel-pos kernels K5/K6 also run with attention dropout
   (rate 0.1, role "dropout"): against the plain version with the same
   seed (the same Philox mask), bit-identical across two launches with
   one seed, different at seed + 1.  K5 and K6 run on the tensor cores:
   their bounds divide by the peak of the tensor cores they use; bf16 K5
   is also held to the rounding-point reference.  K3/K4 also run at the
   TIMIT step's lattice (role "timit": B8 T301 C40 U40), the CRDNN
   seq2seq step's (role "seq2seq": B8 T1001 C1000 U48, the warp path)
   and the TIMIT distillation's (role "kd": B8 T301 C42, the teacher's
   path in a (B, 301) label buffer, 236-240 labels live: the block path).
   The lattice kernels also run wider than a block has threads (role
   "wide_lattice": CTC 2U+1 = 1041, RNN-T U+1 = 1100).
3. serve   -- ``ConformerASR(CONFORMER_SMALL)`` (full width, random
   weights from a seed) transcribes 8 synthetic 10 s utterances with
   beam 10 and CTC weight 0.4, in float32 and then bfloat16.  The launch
   counters must rise by 12 per encode (depthwise conv) and 4 per beam
   step (beam cache); the float32 run is compared with the same search
   through the plain versions on the card.  The CTC scores only the
   attention's top 2 x beam tokens ("partial" mode), as in earlier runs.
4. serve_lm -- the same model with a ``TransformerLM`` at the recipe's
   dims (vocab 5000, d_model 768, 12 heads, 12 post-norm layers, d_ffn
   3072, gelu; random weights from the seed) decodes as the recipe does:
   full-vocabulary CTC scoring at 0.4, the LM fused at 0.6, no eos
   threshold, length normalization.  The validation search (B = 8 x 10 s,
   beam 10) in float32 and bfloat16, and the test search (B = 2 x 10 s,
   beam 66) in float32, each capped at a quarter of T_enc (62 steps):
   steps, encode and search ms, utt/s, peak memory,
   the launches (depthwise conv 12, beam cache 4 per step) and, from a
   profiled second run, the busy share and, for the float32 validation
   search, the LM's device ms and share of the busy time (its calls run
   in a ``record_function`` range; the other two trace the card's events
   alone, since the host's take about a minute a search to collect).  The float32
   validation search is repeated through the plain versions from the
   same encoder states, with the same hypotheses.
5. long    -- an utterance long enough for T_enc = 512 is encoded; the
   rel-pos attention kernel must run once per encoder layer, and the
   result must match the plain path.
6. train   -- ``ConformerASRBrain(CONFORMER_SMALL)`` (full width,
   transformer_dropout 0.1) takes 30 AdamW steps on B = 32 synthetic
   10 s utterances in bf16, then in f32: ms/step, utt/s, peak memory,
   launches per step (depthwise 24, its dw 12, CTC alpha 1 and beta 1),
   finite losses that fall; then one f32 step's loss and gradients
   through the kernels against the plain versions (dropout 0), and the
   dropout keep fraction.
7. train_long -- the same step with dropout 0 on B = 8 utterances of
   20.44 s (T_enc = 512): the rel-pos kernels run forward and backward
   12 times per step; kernel vs plain gradients in f32.
8. train_transducer -- ``ConformerTransducerBrain(CONFORMER_TRANSDUCER)``
   (full width, dropout 0.1) takes 30 AdamW steps on B = 12 synthetic
   10 s utterances with up to 40 tokens padded to 64, in bf16 then f32:
   ms/step, utt/s, peak memory, the busy share of a profiled step,
   launches per step (depthwise 24, its dw 12, RNN-T alpha 1 and beta 1),
   finite losses that fall; ``evaluate_batch`` launches the alpha kernel
   only; then one f32 step's loss and gradients through the kernels
   against the plain versions (dropout 0).
9. serve_transducer -- ``ConformerTransducer(CONFORMER_TRANSDUCER)``
   (full width, random weights from the seed, the blank bias of
   ``out_lin`` +4) decodes B = 8 synthetic 10 s utterances in f32 then
   bf16: greedy (a loop over the frames on the card), the recipe's beam
   4 (the host lockstep loop, state_beam and expand_beam 2.3) and the
   device beam 4 (1024 symbols, see ``DEVICE_BEAM_SYMBOLS``): encode and
   search ms, utt/s, lockstep rounds and device iterations,
   ``forced_advance_count`` (must be 0), peak memory, K1's 12 launches
   an encode, the busy share of one profiled host beam search, and the
   device kernels an iteration and the busy share over 64 iterations of
   the device beam's loop; the device beam must give the host beam's
   hypotheses, and the f32 beam through the plain versions the same
   hypotheses (scores within 1e-4).
10. recipe -- ``recipes.librispeech_asr`` end to end at full width: 74
   synthetic 16 kHz 16-bit WAV files of 4-14 s written to a temp dir
   (64 train, 8 dev, 2 test; noise and tones, 20-30 words from a 2000-word
   lexicon), the manifests, a unigram tokenizer trained at vocab 5000 by
   the native library (``native/``, built into ``build/native/``; the
   phase fails unless the native route trained it), then
   ``ConformerASRBrain`` in bf16 with the recipe's settings (accumulation
   2, 200 s batches in 10 buckets, 4 loader threads, staging depth 2,
   dropout 0.1, SpecAugment; validation at beam 10, full CTC scoring at
   0.4, no LM; the searches capped at a quarter of T_enc): ``fit`` for 1
   epoch; a fresh Brain, loaders and counter
   on the same folder run epoch 2 alone, with the recovered module and
   optimizer state equal to the saved one bit for bit and the Noam step,
   optimizer step and epoch carried over; ``evaluate(min_key="WER")`` on
   the test set at beam 66.  It prints the tokenizer's seconds and route,
   batches and steps an epoch, the batch shapes, train ms a batch and
   utt/s, the staging queue's wait, the validation and test seconds and
   utt/s, the WERs (finite, >= 0), checkpoint bytes, save and resume
   ms, peak memory and the launches (K1, K2, K3, K4 and K7 each above
   0).  Outside the counted run: K3/K4 against the plain recursions on a
   recipe batch with a dummy row (length 0: loss 0, no gradient), and
   two steps with staging depth 2 and two with 0 (dropout 0, no
   SpecAugment) giving the same losses bit for bit.

11. train_crdnn_transducer -- ``CRDNNTransducerBrain(CRDNN_TRANSDUCER)``
   (the transducer recipe's ``train.yaml`` at full width: CNN 64/128,
   a bidirectional LiGRU of 4 x 512, DNN 2 x 512; dropout 0.15) takes 4
   AdamW steps on B = 12 synthetic 10 s utterances (T_enc 1001: no time
   pooling) with up to 40 tokens padded to 64, in bf16 then f32:
   ms/step, utt/s, peak memory, the busy share of one profiled step,
   launches per step (RNN-T alpha 1 and beta 1, no depthwise conv),
   finite losses that fall (the LiGRU's recurrence is a PyTorch loop
   over the frames, no kernel of its own: its calls are counted in
   phase 25's transducer step); then one
   f32 step's loss and gradients through the kernels against the plain
   versions (dropout 0): K8/K9 at B12 x T1001 x U+1 65, which the
   kernels phase also checks alone (role "crdnn").
12. recipe_transducer -- ``recipes.librispeech_transducer`` end to end at
   full width in bf16 with both hparams files, on 38 synthetic WAV files
   of 4-10 s (32 train, 4 dev, 2 test): the BPE tokenizer at vocab 1000
   by the native library, the recipe's dynamic batches (120 s, 8
   buckets), tokens_blank and token buckets, 4 loader threads, staging
   depth 2, the yamls' dropout and SpecAugment, the random models' blank
   logit biased +4 (so the beam takes a few rounds a frame).
   ``conformer_transducer.yaml``: 1 epoch, epoch 2 in a fresh Brain
   with the recovered state equal bit for bit, then
   ``evaluate(min_key="loss")`` at beam 4 on the 2 test utterances;
   ``train.yaml`` (the CRDNN): 1 epoch, then the same test.  Each prints
   the tokenizer's route and pieces, batches and shapes, train ms a
   batch and utt/s, validation seconds and losses (no search runs
   there), test seconds, utt/s and WER (finite, >= 0), checkpoint bytes,
   save and resume ms, peak memory and the launches (K1, K2, K8, K9 above
   0 for the conformer; K8, K9 above 0 and K1 0 for the CRDNN).

13. recipe_timit -- ``recipes.timit_ctc`` (the TIMIT CRDNN + CTC recipe,
   ``BASELINE.json`` config 2) at full width in f32: the CRDNN-CTC step
   (120 features: 40 mels with deltas; CNN 128/256, LiGRU 4 x 512
   bidirectional, DNN 2 x 512, 40 outputs, dropout 0.15) takes 4
   Adadelta steps at lr 1.0 on B = 8 x 3 s (T 301) with 20-40 phones a
   row: ms/step, utt/s, peak memory, the busy share of a profiled step,
   launches per step (CTC alpha 1 and beta 1, nothing else), the LiGRU's
   PyTorch calls and device kernels; one step's loss and gradients
   through K3/K4 against the plain recursions, with a dummy row; then
   the recipe end to end on a synthetic TIMIT tree (SPHERE files of
   1.5-6 s with phones from all 61, an SA sentence a speaker; 32 train,
   8 dev, 8 test): 40 labels with the blank, 1 epoch, epoch 2 in a
   fresh Brain with the modules, Adadelta accumulators, NewBob state, lr
   and epoch recovered bit for bit, ``evaluate(min_key="PER")``: batches,
   train ms a batch and utt/s, validation and test seconds, PERs (finite,
   >= 0), lr per epoch, checkpoint bytes, save and resume ms, peak
   memory and the launches (K3, K4 above 0, every other 0).
14. recipe_gsc -- ``recipes.gsc_xvector`` (Google Speech Commands
   x-vector, config 1) at full width in f32: the step (Xvector TDNN 512
   x 4 + 1500, lin 512; Classifier of 12; ``TimeDomainSpecAugment`` on)
   takes 4 Adam steps at 1e-3 on B = 32 x 1 s: ms/step, utt/s, peak
   memory, busy share, launches (none) and the device ms of the
   "time_domain_augment" range, which runs once more under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); then the recipe on a synthetic tree
   (10 commands and 2 unknown words, clips of 0.6-1.0 s; 96 train, 32
   valid, 32 test): 1 epoch, epoch 2 resumed bit for bit,
   ``evaluate(max_key="acc")``: batches, train ms a batch, validation
   and test seconds, accuracies (in [0, 1]), checkpoint bytes, save and
   resume ms, peak memory.
15. recipe_voxceleb -- ``recipes.voxceleb_speaker`` (VoxCeleb speaker
   verification, config 3) at the yamls' widths in f32: the ECAPA step
   (1024 x 4 + 3072, attention 128, 192-d embedding, the AAM head of
   7205 classes, 80 mels, ``TimeDomainSpecAugment`` on) takes 4 Adam
   steps after a warm-up on B = 32 x 3 s: ms/step, utt/s, peak memory,
   GFLOP a step and its f32 bound, busy share, PyTorch calls and device
   kernels a step, the device ms of "time_domain_augment", launches
   (none), and the augmentation, Fbank and sentence normalization under
   ``set_sync_debug_mode("error")``; then the recipes on a synthetic
   VoxCeleb tree (16 speakers x 48 clips of 2-5 s, 256 trials): ECAPA 1
   epoch, epoch 2 resumed bit for bit, ``save_for_pretrained``, cosine
   verification; the x-vector yaml 2 epochs and PLDA verification
   (embeddings and scoring timed apart; EER and minDCF in [0, 1]).
16. recipe_separation -- ``recipes.wsj0mix_separation`` (WSJ0-2mix, 8 kHz)
   at the yamls' widths in f32: the SepFormer step (``sepformer.yaml``:
   encoder 256 x 16 taps, 2 x (8 intra + 8 inter) transformer layers,
   chunks of 250, PIT SI-SNR, Adam) on B = 1 and B = 4 mixtures of 4 s
   (T' 3999, 34 chunks): ms/step, mixtures/s, peak memory, GFLOP a step
   (``FlopCounterMode``) and its f32 bound, busy share, PyTorch calls and
   device kernels a step, launches (none), and the forward, loss and
   backward under ``set_sync_debug_mode("error")``; the conformer-intra
   step (``sepformer-conformerintra.yaml``, B = 1 x 4 s): the same, its
   launches a step (K1 32: forward and dx of 16 conformer layers; K2
   16), and its loss and gradients through K1/K2 against the plain
   versions; the Conv-TasNet step (``convtasnet.yaml``: N 256, B 256, H
   512, X 6, R 4, L 16; B = 1 x 4 s).  Then the recipes on a synthetic
   WSJ0-2mix tree (harmonic sources, mixtures of 2-5 s; 24 train, 6
   valid, 6 test): the SepFormer 1 epoch, epoch 2 in a fresh Brain with
   the modules, Adam's state, the rate, the plateau schedule and the
   generator recovered bit for bit, ``evaluate(min_key="si-snr")``
   (SI-SNR finite); Conv-TasNet 1 epoch through ``run``.  The kernels
   phase also holds K1 (forward and dx) and K2 at the conformer-intra
   shape, 34 x 250 x 256 with 31 taps (roles "separation" and
   "separation_dx").
17. recipe_separation_rnn -- the recipe's recurrent yamls at their
   widths in f32, each step on B = 1 mixture of 4 s as phase 16 times
   it: the DPRNN (``dprnn.yaml``: 6 x (intra + inter) BiLSTMs of 128
   units a direction over 34 chunks of 250), SkiM (``skim.yaml``: 4
   bidirectional SegLSTMs of 256 units over 27 segments of 150, 3
   MemLSTMs) and the RE-SepFormer (``resepformer.yaml``: 2 one-layer
   transformer segment blocks and 1 memory block at d_model 128); the
   LSTMs are cuDNN's, so ``FlopCounterMode`` (no formula for
   ``_cudnn_rnn``) gets their gate products from the shapes
   (``recurrent_forward_gflop``).  Each Brain's recurrences hold their
   weights in one buffer, and no "not part of single contiguous chunk"
   warning is raised.  The port's LSTM on the card against the CPU at
   the DPRNN's intra shape and the SkiM SegLSTM's (outputs, states and
   gradients within ``LSTM_CARD_TOL`` of their float64 scale).  Then the
   recipes on a synthetic tree (12 train, 3 valid, 3 test mixtures of
   2-5 s): the DPRNN 1 epoch, epoch 2 in a fresh Brain recovered bit for
   bit, the test pass; SkiM and the RE-SepFormer 1 epoch each through
   ``run``; every SI-SNR finite.  No port kernel runs here.
18. recipe_separation_more -- the rest of separation at the yamls' widths
   in f32, each step on B = 1 mixture as phase 16 times it: the
   CNN-Transformer spectral masker (``cnntransformer-whamr-DM.yaml``:
   STFT 32 ms at 16 ms, n_fft 512, 8 post-norm layers of d_model 256, 16
   heads, d_ffn 512, the sigmoid mask, resynthesis through the ISTFT;
   4 s), the binaural Conv-TasNet in the "cross" (the ILD's STFT, log and
   linear resize) and "parallel" modes (``convtasnet-{cross,parallel}
   .yaml``: N 256, B 128, H 256, X 6, R 2, L 16; 3 s stereo) and the
   SepFormer on three sources (``sepformer-libri3mix.yaml``, 3 s).  For
   the spectral masker and the "cross" model, the loss and every gradient
   on the card against the same weights on the CPU (eval mode), within
   ``SEP_MORE_CARD_TOL``: in float64 the loss and the gradients, in f32
   the loss (the f32 gradients' distances are reported: a unit at its
   kink takes another slope on one device).  Then the recipes on synthetic trees (6 train,
   2 valid, 2 test mixtures of 2-5 s; REAL-M 8/4/4): the WHAM!
   enhancement with dynamic mixing 1 epoch, epoch 2 in a fresh Brain
   recovered bit for bit (the ``DynamicMix`` at epoch 2), the test pass;
   LibriMix 3-mix, binaural "cross" and REAL-M 1 epoch each through
   ``run``; every SI-SNR and L1 finite.  No port kernel runs here.
19. recipe_seq2seq -- the LibriSpeech CRDNN seq2seq recipe
   (``recipes.librispeech_seq2seq``, ``train_BPE_1000.yaml``: Fbank 40,
   the CRDNN with a bidirectional LSTM of 4 x 1024, the GRU decoder with
   location attention of 1024, ~119 M parameters) at full width: the
   training step on B = 8 synthetic 10 s utterances (T 1001) with 24-48
   tokens each in a CTC epoch (0.5 CTC on K3/K4, warp path, + 0.5 NLL;
   SpecAugment, dropout 0.15, Adadelta at lr 1.0) in bf16 (the yaml's)
   and f32: ms/step, utt/s, peak memory, the launches a step (K3 1, K4
   1, nothing else), PyTorch calls, FLOPs, the profile of one step and
   the teacher-forced decoder's forward and backward alone; the
   ``train_BPE_5000.yaml`` head's step once.  At toy widths in float64,
   the loss and every gradient on the card against the CPU (an epoch
   after the CTC epochs: the CTC runs in float32) and the LM-fused beam
   search's hypotheses (equal) and scores, within ``S2S_CARD_TOL``; its
   control, the card side in float32 against the same CPU float64 run,
   must break both bounds.  At full width in f32 (a CTC epoch, ragged
   lengths, a dummy row, dropout 0), the step's loss and gradients
   through K3/K4 against the plain CTC recursions (``set_kernels``).  The
   LM-fused beam search as the recipe validates (beam 8, temperature
   1.25, coverage 1.5, attention shift 240, eos threshold 1.5, an RNNLM
   of 2 x 2048 fused at 0.5, random weights) on B 8 x 10 s in f32,
   capped at int(1001 x ``S2S_SEARCH_RATIO``) steps: the steps
   run, ms a step, utt/s (encode + search), a profile.  Then the recipe
   on a synthetic tree (16 train, 8 valid, 4 test utterances of 2-4 s,
   the LM from a checkpoint file, bf16, searches capped as above): epoch
   1, epoch 2 in a fresh Brain recovered bit for bit, the test at beam
   80; every WER, CER and loss finite.

20. recipe_lm -- the LM training recipes (``recipes.lm_training``) at the
   LibriSpeech yamls' widths: the ``RNNLM.yaml`` step (RNNLM, LSTM 2 x
   2048, vocab 1000) and the ``transformer.yaml`` step (TransformerLM 12
   x 768, 12 heads, d_ffn 3072, vocab 5000), each on B = 64 rows at the
   max_seq_len cap (255 tokens and the bos) in bf16 and f32: a warm-up, 3
   timed Adam steps (Noam), ms/step, tokens/s, peak memory, GFLOP a step
   and its bound, the PyTorch calls and the profile of one more step (busy
   share, device kernels), no launch of a port kernel; for the RNNLM the
   cuDNN kernels of its LSTM's forward and backward (the recurrence stays
   f32 under bf16).  Then the recipes on synthetic corpora (the ASR
   recipes' tokenizer files trained on a LibriSpeech tree's transcripts,
   vocab 1000 and 5000; 128/64/64 lines of 10-150 words; a
   Timers-and-Such tree of 96 + 32 train, 32 dev and 32 test rows):
   ``HPARAMS_RNNLM``, ``HPARAMS_TRANSFORMER`` and ``HPARAMS_TAS`` each 1
   epoch, epoch 2 in a fresh Brain recovered bit for bit, the test,
   ``lm.ckpt``; the RNNLM's ``lm.ckpt`` fused into
   ``librispeech_seq2seq``'s validation search (full width, bf16, beam 8,
   LM 0.5) and the TransformerLM's into ``librispeech_asr``'s
   (conformer_small, beam 10, CTC 0.4, LM 0.6: K1 and K7 launch), each
   over the dev set's first batch, capped at int(T_enc x
   ``LM_FUSED_RATIO``) steps, its scores held apart from the same search
   at ``lm_weight`` 0.
21. recipe_timit_seq2seq -- the TIMIT seq2seq recipe and its distillation
   (``recipes.timit_seq2seq``, ``recipes.timit_kd``) at ``train.yaml``'s
   widths (120 features, CNN 128/256, LiGRU 4 x 512 bidirectional, DNN 2
   x 512, decoder GRU 256 with location attention 256, 42 outputs;
   dropout 0.15): the seq2seq step (0.5 CTC + 0.5 NLL; K3 1, K4 1 a step)
   and the distillation step (a young teacher's posteriors: its greedy
   path nearly T long; K3 2, K4 2 a step) on B = 8 x 3 s (T 301) with
   20-40 phones, in bf16 (the yaml's) and f32: a warm-up, 3 timed
   Adadelta steps, ms/step, utt/s, peak memory, the PyTorch calls and the
   profile of one more step.  Both steps' loss and gradients through
   K3/K4 against the plain CTC recursions at full width in f32 (the
   seq2seq step with a dummy row; the distillation step with the
   teachers' paths at full length, the block path, and a row whose
   teacher is all blank: its path one label equal to the blank).  At toy
   widths in float64, the seq2seq, distillation and transformer-LM steps'
   loss and every gradient on the card against the CPU (the CTC on its
   plain recursions, which keep float64), within ``TS2S_CARD_TOL``; each
   control, the card in float32 against the same CPU run, must break both
   bounds.  Then the chain on a synthetic TIMIT tree (16 train, 4 dev, 4
   test SPHERE files of 1.5-3 s) at the yaml's widths and 2 of its 4
   recurrent layers, bf16: teachers tea0 (LiGRU) and tea3 (LSTM) one
   epoch each through ``run``, ``save_teachers`` (float16 npz), the
   student 1 epoch, epoch 2 in a fresh Brain recovered bit for bit, the
   test at beam 16; every PER and loss finite.
22. recipe_kspon -- KsponSpeech ``conformer_medium.yaml``
   (``recipes.ksponspeech_asr``: d_model 256, 4 heads, 12 + 6 layers,
   V 5000) at full width: the step on B 8 x 10 s in bf16 and f32, 2
   steps timed (SpecAugment, dropout 0.1; K1 24, K2 12, K3 1, K4 1 a
   step; FLOPs and their f32 bound, PyTorch calls, the profile); one f32
   step at T_enc 512 (B 8 x 20.44 s) through the kernels and the plain
   versions, loss and gradients (K5/K6 at dh 64, 12 launches each); the
   LM-fused search (its 12 x 768 LM at 0.6, CTC 0.4, beam 10, B 8 x 10
   s, 50 steps) in f32, K7 at H4 Dh64 six times a step, hypotheses
   kernel = plain; the recipe on a synthetic KsponSpeech corpus at 2 + 2
   layers (bf16, accumulation 4), epoch 2 resumed in a fresh Brain bit
   for bit, both eval splits with their WER files; and the LM yaml's
   step (12 x 768, B 64 x 256) in bf16.
23. recipe_transformer -- LibriSpeech ``transformer.yaml``
   (``librispeech_asr.HPARAMS_TRANSFORMER``: the transformer encoder,
   regularMHA, d_model 512, 12 + 6 layers) at full width: the step on B
   8 x 10 s in bf16 and f32, 2 steps timed (K3/K4 once a step), kernel
   vs plain in f32, and the search with its 12 x 512 LM (K7 at H8 Dh64)
   in f32.
24. recipe_corpora -- the AISHELL-1 (seq2seq, conformer_small,
   train_ASR_transformer) and Switchboard (seq2seq on the channel of
   each row, transformer at 8 kHz, both LM yamls) recipes through their
   builds and ``run`` on synthetic corpora at full width and reduced depth
   (2 + 2 layers; the CRDNN's LSTM 1 layer), each 1 epoch then epoch 2
   in a fresh Brain recovered bit for bit, then its test split; both
   LMs on the Switchboard transformer recipe's tokenizer.

25. recipe_commonvoice -- the CommonVoice recipes
   (``recipes.commonvoice_asr``) at full width: the seq2seq
   ``train_fr.yaml`` step (CRDNN of 3 CNN blocks, LSTM 5 x 1024, the
   location-attention GRU of 1024, 500 characters; K3/K4 once a step) and
   the conformer ``transformer/train_fr.yaml`` step (d 144, 12 + 4 layers,
   4300 characters; K1 24, K2 12, K3 1, K4 1 a step) on B 12 x 6 s in
   bf16 and f32, the ``transducer/train_fr.yaml`` step (Fbank 40 with
   deltas, CRDNN-LiGRU 4 x 512, V 40 characters, U+1 81; K8/K9 once a
   step) on B 8 x 6 s in f32 and bf16; ms/step, utt/s, peak memory, the
   launches a step, and for the bf16 conformer step (see SHORTENED) the
   FLOPs and their f32 bound, the PyTorch calls and the profile of one
   more step; each family's f32
   step (dropout 0, ragged lengths) through the kernels and the plain
   versions, loss and every gradient; then the three recipes through
   their builds on a synthetic French folder (12 train, 2 dev, 2 test
   clips of 3-6 s, 3-8 words with accented letters) at full width and reduced depth
   (the LSTM and the LiGRU 1 layer, the conformer 2 + 2 layers): epoch 1,
   epoch 2 in a fresh Brain recovered bit for bit, the test (the greedy
   CTC CER; the transducer's beam-4 PER, its blank logit +4).
26. recipe_slu -- the spoken language understanding recipes
   (``recipes.slu_direct``, ``recipes.slu_nlu``) at full width: the
   direct step (FSC yaml, f32) on B 8 x 3 s and the NLU step (SLURP NLU
   yaml, bf16) on B 16 rows of 30 transcript pieces, no port kernel a
   step (the losses are NLL only); then FSC, SLURP and Timers and Such
   direct, the SLURP NLU and Timers and Such decoupled and multistage
   through their builds on synthetic corpora, each epoch 1, epoch 2 in a
   fresh Brain recovered bit for bit, the test (exact-match accuracy, or
   the loss for SLURP direct).
27. recipe_st -- the speech translation recipes (``recipes.taigi_st``,
   ``recipes.fisher_st``) at full width: the Taigi step (the transformer
   12 + 6 at d 256, regularMHA, V 5000; no port kernel) on B 32 x 6 s in
   bf16 and f32, two micro-batches timed (one optimizer step at the
   yaml's accumulation 2); the Fisher transformer step (K3/K4 once a
   step) and conformer step (K1 24, K2 12, K3 1, K4 1) on B 8 x 10 s in
   f32 (the yamls') and bf16; the conformer's f32 step through the
   kernels and the plain versions, loss and every gradient; the Taigi
   search (float32, beam 10 over B 32: 320 rows) run to a fixed 50 steps,
   K7 6 a step, hypotheses kernel = plain; then the Taigi and both Fisher
   recipes on synthetic corpora at reduced depth (2 + 2 layers), each
   epoch 1, epoch 2 in a fresh Brain recovered bit for bit, the test
   (Taigi's BLEU and CER files), and the two tokenizer recipes at their
   yamls' sizes.
28. recipe_wav2vec -- the native wav2vec 2.0 recipes
   (``recipes.wav2vec_ctc``, ``recipes.wav2vec_pretrain``) at full width
   (7 convolutions of 512; 12 pre-norm layers at d 768, 8 heads, d_ffn
   3072): the LibriSpeech CTC step (B 6 x 10 s: T 498 latents, 150
   characters, V 29; K3/K4 once a step on their block path, 2U+1 301) in
   bf16 (the yaml's) and f32, the AISHELL-1 CTC step (B 8 x 6 s, T 298,
   V 5000) in f32, the pretraining step (B 16 x 10 s, bf16, 100
   negatives; no port kernel) as 2 micro-batches and one that closes the
   accumulation window of 8 (the clip and AdamW) timed apart; each with
   ms/step, peak memory, the profile, PyTorch calls and FLOPs of one more
   micro-batch, beside the FLOPs counted from the shapes
   (``_w2v_flops``); the LibriSpeech f32 step (dropout 0, ragged
   lengths) through the kernels and the plain versions, loss and every
   gradient, with the control of the plain route against itself with the
   first convolution's weights one ulp off; then both pretraining recipes
   (LibriSpeech, CommonVoice) and one CTC recipe a corpus (LibriSpeech,
   DVoice, CommonVoice, AISHELL-1, Switchboard) on synthetic corpora at
   full width and 2 encoder layers (the pretraining at batches of 4, no
   accumulation), each epoch 1, epoch 2 in a fresh Brain recovered bit
   for bit, then the CTC recipes' test with its WER file.
29. recipe_wav2vec_families -- the wav2vec 2.0 yamls of the ported
   families and TIMIT's transducers at full width: the CommonVoice
   ``train_fr_with_wav2vec.yaml`` step (the wav2vec base encoder, the
   location-attention GRU of 1024, 500 outputs; K3/K4 once a step) on B
   12 x 6 s in f32 (the yaml's), TIMIT's ``train_with_wav2vec2.yaml``
   step (``enc_dnn`` 2 x 512, GRU 256, V 42; K3/K4) on B 8 x 3 s,
   AISHELL-1's ``train_ASR_transformer_with_wav2vect.yaml`` step (the
   latents into conformer_small's 12 + 4 layers, V 4300; K1 24, K2 12, K3
   1, K4 1 a step) on B 8 x 6 s, the IWSLT22 ``train_w2v2_st.yaml``
   micro-batch (6 wav2vec layers, the decoder-only ``TransformerST``, V
   1000; no port kernel) on B 2 x 10 s in f32, and TIMIT's
   ``transducer/train.yaml`` (CRDNN-LiGRU 4 x 512) and
   ``train_wav2vec.yaml`` steps (V 40; K8/K9 once a step) on B 8 x 3 s;
   the bf16 yamls' steps in bf16 and f32, each step's ms, peak memory and
   launches, and in the yaml's precision its FLOPs, PyTorch calls and
   profile; the CommonVoice, AISHELL-1 and wav2vec transducer f32 steps
   (dropout 0, ragged lengths) through the kernels and the plain
   versions, with the control of the plain route against itself with the
   extractor's first convolution one ulp off; then the 11 recipes on
   synthetic corpora at full width and 2 encoder layers (the LiGRU 2 of
   4; no accumulation; the searches capped at a tenth of T), each epoch
   1, epoch 2 in a fresh Brain recovered bit for bit, then the test.

The kernels phase also holds K5/K6 at dh 64 (role "dh64"), K7 at H4
Dh64 and H8 Dh64 (roles "h4dh64", "h8dh64"), K3/K4 at Switchboard's
2000 pieces (role "swbd"), at the CommonVoice seq2seq step's lattice
(role "commonvoice": B12 T601 V500 U80) and the conformer's (role
"cv_conformer": B12 T151 V4300 U60), and K8/K9 at the CommonVoice
transducer's (role "commonvoice": B8 T601 U96 V40); K1/K2 on the causal
padding of ``ConformerDecoder`` (role "causal": B8 T64 C256 K31), K3/K4
at the Fisher CTC's lattice (role "fisher": B8 T251 V500 U48) and K7 at
the Taigi search's 320 rows (role "taigi": H4 Dh64 L128 pos 50), and
K3/K4 at the wav2vec CTC steps' lattices (role "w2v_librispeech": B6
T498 V29 U150, the block path; role "w2v_aishell": B8 T298 V5000 U40),
K3/K4 at the CommonVoice wav2vec seq2seq step's (role "cv_wav2vec": B12
T298 V500 U80) and K8/K9 at TIMIT's wav2vec transducer's (role
"timit_w2v": B8 T148 U40 V40).

SHORTENED to keep the whole run inside its time limit (torch.profiler's
collection took 5-21 s a profile beyond the traced work, the LiGRU's
call counts 30 s a precision): ``serve_lm`` profiles its f32 repeats at
50 steps (``SERVE_LM_PROFILE_RATIO``), its bf16 search not; the steps of
``train_crdnn_transducer``, ``recipe_seq2seq``,
``recipe_timit_seq2seq``, ``recipe_kspon`` and ``recipe_transformer``
are profiled and their PyTorch calls counted in bf16 only, and the
host beam of ``serve_transducer`` in f32 only; the f32 runs are timed
and checked as before.  ``recipe`` caps its validation and test
searches at a quarter of T_enc (``RECIPE_DECODE_RATIO``),
``recipe_kspon`` and ``recipe_transformer`` time 2 steps a precision,
and the two Switchboard LMs reuse the transformer recipe's tokenizer.
For the CommonVoice and SLU phases: ``serve_lm``'s timed searches stop
at a quarter of T_enc (``SERVE_LM_SEARCH_RATIO``: 62 steps of the ~110-120
its random model runs), ``recipe_seq2seq`` times its LM-fused search in
f32 only, the recipes' resumes run 1 epoch
and a resumed second (``recipe``, ``recipe_transducer``,
``recipe_timit``, ``recipe_gsc``, ``recipe_voxceleb``'s ECAPA,
``recipe_separation``'s SepFormer, ``recipe_lm``'s three LMs and
``recipe_timit_seq2seq``'s student ran 2 and a third), and the LiGRU's
own calls and kernels are counted at the TIMIT step's T 301
(``recipe_timit``) only.  For the speech translation phase: ``serve``
profiles its f32 search only, ``serve_lm`` the valid f32 search only
(not the beam-66 test search), ``serve_transducer`` its device beam in
f32 only, ``recipe_timit_seq2seq`` the KD step only (its bf16 step runs
the seq2seq step's modules and the second CTC), and
``recipe_commonvoice`` profiles no seq2seq step (``recipe_seq2seq``
profiles the same modules at LibriSpeech's shape).  For the wav2vec
phase: the kernels phase times each plain CTC and RNN-T recursion once,
right after the reference call its check makes (it ran a warm-up and 3
timed calls: 7.2 s of the plain recursions a round on an H100 at 700 W,
so ~18 s less).  For the wav2vec families' phase: ``recipe_commonvoice``
profiles no transducer step (``recipe_wav2vec_families`` profiles the same
CRDNN-LiGRU transducer, TIMIT's, at V 40 and T 301; the CommonVoice one
took 15.4 s with its profile and 3.7 s without).

Phases 6 and 8 train with the recipes' SpecAugment (``asr.CONFORMER_SMALL``
/ ``CONFORMER_TRANSDUCER["augmentation"]``), drawn from the brain's
generator; its device ms is the "spec_augment" range of the profiled
steps, and the kernel-vs-plain checks restore the generator between the
routes, so both draw the same masks (phase 6 holds the gradients without
it and the loss with it: see ``phase_train``; phase 7 runs without it).

Then a line with each phase's seconds, one ``{"kernels": [...]}`` line
(launch counts from phases 3 to 29, each counted from 0 just before its
run; the kernel-vs-plain checks' launches left out), and last the device
line.
float32 matmuls and convolutions run without TF32 throughout, and cuDNN
picks deterministic algorithms.  Any
failed check raises, so the exit code is non-zero and the device line
is not printed.  Exits non-zero when no CUDA card is present.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
BLANK_BIAS, EOS_BIAS = 8.0, 5.0  # see phase_serve
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# CUDA-core f32; bf16 and TF32 tensor cores (dense)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
DROPOUT_SEED = (3 << 32) + 7  # uses both words of the Philox key


_T0 = time.perf_counter()


def emit(obj):
    """Print one JSON line and flush it; a phase's line also carries
    ``t_s``, the seconds since the script started (what each part of a
    phase took is the difference between its line's and the previous
    one's)."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def _time_ms(fn, iters=20, warmup=3):
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


def _device_ms(fn, iters=10, warmup=3):
    """Device time per call of ``fn``'s kernels, from the profiler: (total
    ms, {kernel: ms}).  Where the host takes longer to issue a call than
    the card to run it, CUDA events around back-to-back calls time the
    host; this reads the kernels alone."""
    return _device_profile(fn, iters, warmup)[:2]


def _device_profile(fn, iters=10, warmup=3):
    """(device ms a call, {kernel: ms a call}, device kernels a call) of
    ``fn``, from the profiler.  A window in which the profiler recorded
    no kernel at all (seen on the H100 after many windows in one
    process) is profiled again, up to three times; then the time is
    "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per, count = {}, 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0) or 0
            if t > 0:
                name = re.search(r"(\w+)\s*[<(]",
                                 e.key.replace("(anonymous namespace)::", ""))
                key = name.group(1) if name else e.key[:48]
                per[key] = per.get(key, 0.0) + t / iters / 1e3
                count += e.count
        if per:
            return sum(per.values()), per, count / iters
    return "not measured", {}, "not measured"


def _host_us(fn, n=200):
    """Host microseconds a call takes to issue: ``time.perf_counter``
    around ``n`` calls with no synchronisation, over ``n`` (the card runs
    behind the host; its queue does not fill at these sizes)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


def _call_times(fn, library=None):
    """Card ms (CUDA events around back-to-back calls), device ms (the
    kernels alone, profiler) and host us a call, of ``fn`` and of the
    library call beside it."""
    out = {"ms": _time_ms(fn), "device_ms": _device_ms(fn)[0],
           "host_us_per_call": _host_us(fn)}
    if library is not None:
        out.update({"library_ms": _time_ms(library),
                    "library_device_ms": _device_ms(library)[0],
                    "library_host_us_per_call": _host_us(library)})
    return out


def _bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by


def _err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def phase_build():
    """Compile every kernel (one nvcc per source, in parallel)."""
    from speechbrain_tpu_torch.ops import _build

    seconds = _build.build()
    logs = {
        name: (_build.BUILD_DIR / f"{name}.log").read_text()
        if (_build.BUILD_DIR / f"{name}.log").exists() else ""
        for name in _build.KERNELS
    }
    # ptxas register/spill lines, for the record
    ptxas = {
        n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for n, log in logs.items()
    }
    emit({"phase": "build", "seconds": seconds, "kernels": list(_build.KERNELS),
          "ptxas": ptxas})


def _check_depthwise(dtype_name):
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch.ops import depthwise_conv1d, depthwise_conv1d_plain

    dtype = getattr(torch, dtype_name)
    B, T, C, K = 8, 251, 144, 31
    x, w, bias, _ = _depthwise_inputs(dtype, B, T, C, K)
    got = depthwise_conv1d(x, w, bias)
    ref = depthwise_conv1d_plain(x, w, bias)
    torch.cuda.synchronize()
    err = _err(got, ref)
    # f32: same taps, same order, FMA contraction only; bf16: both round
    # the f32 sum, then the bias sum (JAX's order), so the FMA contraction
    # moves a result by one bf16 ulp at most
    tol = 1e-4 if dtype == torch.float32 else _bf16_ulp(ref)
    assert err <= tol, f"depthwise_conv1d {dtype_name}: max|err| {err} > {tol}"
    xc = x.transpose(1, 2).contiguous()
    wc = w.t().contiguous()[:, None, :]
    pad = (K - 1) // 2
    item = x.element_size()
    bound, by = _bound_ms((2 * B * T * C + K * C + C) * item,
                          2 * B * C * _valid_taps(T, K, pad), dtype_name)
    # the other shapes the main paths give it: training (B 32), train_long
    # (T 512), the transducer (B 12)
    shapes = {}
    for Bs, Ts in ((32, 251), (8, 512), (12, 251)):
        xs, ws, bs, _ = _depthwise_inputs(dtype, Bs, Ts, C, K)
        xsc = xs.transpose(1, 2).contiguous()
        shapes[f"B{Bs} T{Ts}"] = _call_times(
            lambda: depthwise_conv1d(xs, ws, bs),
            lambda: F.conv1d(xsc, wc, bs, padding=pad, groups=C))
    return {
        "name": "depthwise_conv1d", "dtype": dtype_name, "shape": [B, T, C, K],
        "max_abs_err": err, "tol": tol,
        **_call_times(lambda: depthwise_conv1d(x, w, bias),
                      lambda: F.conv1d(xc, wc, bias, padding=pad, groups=C)),
        "plain_ms": _time_ms(lambda: depthwise_conv1d_plain(x, w, bias)),
        "bound_ms": bound, "bound_by": by, "other_shapes": shapes,
    }


def _bf16_ulp(t):
    """One bf16 ulp at max|t|: the spacing of bf16 values there."""
    m = float(t.float().abs().max())
    return float(2.0 ** (np.floor(np.log2(m)) - 7)) if m > 0 else 0.0


def _depthwise_inputs(dtype, B, T, C, K):
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + B)
    x = torch.randn(B, T, C, device="cuda", generator=g).to(dtype)
    w = (torch.randn(K, C, device="cuda", generator=g) / K ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(C, device="cuda", generator=g)).to(dtype)
    dy = torch.randn(B, T, C, device="cuda", generator=g).to(dtype)
    return x, w, bias, dy


def _valid_taps(T, K, pad):
    """(t, k) pairs whose input index t+k-pad lies in [0, T)."""
    return sum(min(T, t + K - pad) - max(0, t - pad) for t in range(T))


def _check_depthwise_dx(dtype_name):
    """K1 as the input gradient at the training shape: the kernel
    reading the taps flipped (centered K = 31: the same padding), as the
    backward launches it, and the autograd Function's three gradients
    against the plain route."""
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch.ops import depthwise_conv1d, depthwise_conv1d_plain
    from speechbrain_tpu_torch.ops.depthwise_conv import _fwd_kernel

    dtype = getattr(torch, dtype_name)
    B, T, C, K = 32, 251, 144, 31
    x, w, bias, dy = _depthwise_inputs(dtype, B, T, C, K)
    w_flip = w.flip(0).contiguous()
    pad = (K - 1) // 2  # centered, odd K: the dx's padding is the same

    def dx():  # the backward's launch: K1 reading the taps flipped
        return _fwd_kernel(dy, w, None, pad, flip=True)

    got = dx()
    ref = depthwise_conv1d_plain(dy, w_flip)
    err = _err(got, ref)
    tol = 1e-4 if dtype == torch.float32 else _bf16_ulp(ref)  # as the forward
    assert err <= tol, f"depthwise dx {dtype_name}: max|err| {err} > {tol}"
    # the Function's gradients against autograd through the plain route
    grads = []
    for fn in (depthwise_conv1d, depthwise_conv1d_plain):
        xs, ws, bs = (t.detach().clone().requires_grad_(True) for t in (x, w, bias))
        out = fn(xs, ws, bs)
        assert out.requires_grad, "depthwise_conv1d output has no grad_fn"
        out.backward(dy)
        grads.append((xs.grad, ws.grad, bs.grad))
    torch.cuda.synchronize()
    # relative to each gradient's largest entry: dw sums 8032 products
    # in other orders (f32: ~1e-6); in bf16 both routes round dx and dw
    # once from f32 sums, so they differ by at most a bf16 ulp or two
    grad_tol = 2e-5 if dtype == torch.float32 else 8e-3
    grad_err = max(_err(a, b) / max(1e-6, float(b.float().abs().max()))
                   for a, b in zip(*grads))
    assert grad_err <= grad_tol, (
        f"depthwise grads {dtype_name}: rel err {grad_err} > {grad_tol}")
    item = x.element_size()
    xc = dy.transpose(1, 2).contiguous()
    wc = w_flip.t().contiguous()[:, None, :]
    bound, by = _bound_ms((2 * B * T * C + K * C) * item,
                          2 * B * C * _valid_taps(T, K, pad), dtype_name)
    # dx as the backward issues it (x alone requires grad: no dw, no
    # dbias): the autograd engine, dy's layout, the taps, K1
    xr = x.detach().clone().requires_grad_(True)
    out = depthwise_conv1d(xr, w)

    def backward_dx():
        return torch.autograd.grad(out, xr, dy, retain_graph=True)

    total, by_kernel = _device_ms(backward_dx)
    return {
        "name": "depthwise_conv1d", "role": "dx", "dtype": dtype_name,
        "shape": [B, T, C, K], "max_abs_err": err, "tol": tol,
        "grads_max_rel_err_vs_plain_autograd": grad_err, "grads_tol": grad_tol,
        **_call_times(dx, lambda: F.conv1d(xc, wc, padding=pad, groups=C)),
        "plain_ms": _time_ms(lambda: depthwise_conv1d_plain(dy, w_flip)),
        "bound_ms": bound, "bound_by": by,
        "backward_dx": {"ms": _time_ms(backward_dx), "device_ms": total,
                        "device_ms_by_kernel": by_kernel,
                        "host_us_per_call": _host_us(backward_dx)},
    }


def _check_depthwise_dw(dtype_name):
    """K2 with the bias gradient at the training shape against its plain
    version (dw and dbias; two calls give the same bits), timed at every
    main-path shape beside ``conv1d_weight`` (dw alone); and the conv's
    backward with a bias as autograd issues it (its device kernels,
    profiler)."""
    import torch

    from speechbrain_tpu_torch.ops import (
        depthwise_conv1d, depthwise_conv1d_dw, depthwise_conv1d_dw_plain)

    dtype = getattr(torch, dtype_name)
    B, T, C, K = 32, 251, 144, 31
    x, w, bias, dy = _depthwise_inputs(dtype, B, T, C, K)
    # as the backward of the conformer's conv (it has a bias) calls it
    got, got_db = depthwise_conv1d_dw(x, dy, K, bias_grad=True)
    ref, ref_db = depthwise_conv1d_dw_plain(x, dy, K, bias_grad=True)
    again = depthwise_conv1d_dw(x, dy, K, bias_grad=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again[0]) and torch.equal(got_db, again[1]), (
        "depthwise_conv1d_dw: two calls gave different bits")
    err = max(_err(got, ref), _err(got_db, ref_db))
    # both sum the same f32 products of the same stored values (8032 per
    # output, |dw| ~ 90) in other orders: ~1e-5 relative
    tol = 2e-3
    assert err <= tol, f"depthwise_conv1d_dw {dtype_name}: max|err| {err} > {tol}"
    pad = (K - 1) // 2
    item = x.element_size()
    bound, by = _bound_ms(2 * B * T * C * item + 4 * (K + 1) * C,
                          2 * B * C * _valid_taps(T, K, pad) + B * T * C,
                          dtype_name)

    def times(xs, dys):
        xc, dyc = (t.transpose(1, 2).contiguous() for t in (xs, dys))
        out = _call_times(
            lambda: depthwise_conv1d_dw(xs, dys, K, bias_grad=True),
            lambda: torch.nn.grad.conv1d_weight(xc, (C, 1, K), dyc,
                                                padding=pad, groups=C))
        # the bias gradient as the backward took it beside K2 until K2
        # returned it
        out["dbias_line_device_ms"] = _device_ms(
            lambda: dys.float().sum((0, 1)).to(dtype))[0]
        return out

    shapes = {}
    # train_long's and the transducer's shapes, and B1 T1: the floor of
    # one launch (its chain of staging, partial, ticket and final sum)
    for Bs, Ts in ((8, 512), (12, 251), (1, 1)):
        xs, _, _, dys = _depthwise_inputs(dtype, Bs, Ts, C, K)
        shapes[f"B{Bs} T{Ts}"] = times(xs, dys)
    # the backward of a conv with a bias, as autograd issues it
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, bias)]
    out = depthwise_conv1d(*leaves)

    def backward():
        return torch.autograd.grad(out, leaves, dy, retain_graph=True)

    dev_ms, by_kernel, kernels = _device_profile(backward)
    return {
        "name": "depthwise_conv1d_dw", "dtype": dtype_name, "shape": [B, T, C, K],
        "max_abs_err": err, "tol": tol, "bias_grad": True, **times(x, dy),
        "plain_ms": _time_ms(lambda: depthwise_conv1d_dw_plain(
            x, dy, K, bias_grad=True)),
        "bound_ms": bound, "bound_by": by, "other_shapes": shapes,
        "backward_with_bias": {"device_ms": dev_ms,
                               "device_ms_by_kernel": by_kernel,
                               "device_kernels_per_call": kernels,
                               "host_us_per_call": _host_us(backward)},
    }


def _check_depthwise_separation():
    """K1 (forward, and dx: the taps read flipped) and K2 (with the bias
    gradient) in f32 at the conformer-intra SepFormer's shape: the
    B x S = 34 chunks of 250 frames of a 4 s mixture, 256 channels, 31
    taps; each against its plain version, timed beside the library call.
    Records of roles "separation" and "separation_dx"."""
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch.ops import (
        depthwise_conv1d, depthwise_conv1d_dw, depthwise_conv1d_dw_plain,
        depthwise_conv1d_plain)
    from speechbrain_tpu_torch.ops.depthwise_conv import _fwd_kernel

    B, T, C, K = 34, 250, 256, 31
    pad = (K - 1) // 2
    x, w, bias, dy = _depthwise_inputs(torch.float32, B, T, C, K)
    taps = _valid_taps(T, K, pad)
    out = []
    # forward
    err = _err(depthwise_conv1d(x, w, bias), depthwise_conv1d_plain(x, w, bias))
    assert err <= 1e-4, f"depthwise_conv1d at {B}x{T}x{C}: {err} > 1e-4"
    xc, wc = x.transpose(1, 2).contiguous(), w.t().contiguous()[:, None, :]
    bound, by = _bound_ms(4 * (2 * B * T * C + K * C + C), 2 * B * C * taps,
                          "float32")
    out.append({
        "name": "depthwise_conv1d", "role": "separation", "dtype": "float32",
        "shape": [B, T, C, K], "max_abs_err": err, "tol": 1e-4,
        **_call_times(lambda: depthwise_conv1d(x, w, bias),
                      lambda: F.conv1d(xc, wc, bias, padding=pad, groups=C)),
        "plain_ms": _time_ms(lambda: depthwise_conv1d_plain(x, w, bias)),
        "bound_ms": bound, "bound_by": by})
    # dx: K1 reading the taps flipped, as the backward launches it
    w_flip = w.flip(0).contiguous()
    err = _err(_fwd_kernel(dy, w, None, pad, flip=True),
               depthwise_conv1d_plain(dy, w_flip))
    assert err <= 1e-4, f"depthwise dx at {B}x{T}x{C}: {err} > 1e-4"
    dyc = dy.transpose(1, 2).contiguous()
    wfc = w_flip.t().contiguous()[:, None, :]
    bound, by = _bound_ms(4 * (2 * B * T * C + K * C), 2 * B * C * taps,
                          "float32")
    out.append({
        "name": "depthwise_conv1d", "role": "separation_dx",
        "dtype": "float32", "shape": [B, T, C, K], "max_abs_err": err,
        "tol": 1e-4,
        **_call_times(lambda: _fwd_kernel(dy, w, None, pad, flip=True),
                      lambda: F.conv1d(dyc, wfc, padding=pad, groups=C)),
        "plain_ms": _time_ms(lambda: depthwise_conv1d_plain(dy, w_flip)),
        "bound_ms": bound, "bound_by": by})
    # K2: dw and dbias (8500 products an output, as at the training shape)
    got = depthwise_conv1d_dw(x, dy, K, bias_grad=True)
    ref = depthwise_conv1d_dw_plain(x, dy, K, bias_grad=True)
    err = max(_err(got[0], ref[0]), _err(got[1], ref[1]))
    assert err <= 2e-3, f"depthwise_conv1d_dw at {B}x{T}x{C}: {err} > 2e-3"
    bound, by = _bound_ms(2 * B * T * C * 4 + 4 * (K + 1) * C,
                          2 * B * C * taps + B * T * C, "float32")
    out.append({
        "name": "depthwise_conv1d_dw", "role": "separation",
        "dtype": "float32", "shape": [B, T, C, K], "max_abs_err": err,
        "tol": 2e-3, "bias_grad": True,
        **_call_times(
            lambda: depthwise_conv1d_dw(x, dy, K, bias_grad=True),
            lambda: torch.nn.grad.conv1d_weight(xc, (C, 1, K), dyc,
                                                padding=pad, groups=C)),
        "plain_ms": _time_ms(lambda: depthwise_conv1d_dw_plain(
            x, dy, K, bias_grad=True)),
        "bound_ms": bound, "bound_by": by})
    return out


def _check_depthwise_causal(dtype_name, B=8, T=64, C=256, K=31):
    """K1 and K2 on the causal padding (K - 1, 0) of ``ConformerDecoder``'s
    convolution module, at one decoder shape: B 8 rows of 64 target
    positions at d_model 256 with 31 taps (the Fisher conformer's width
    and kernel).  The forward (K1), the backward through the autograd
    Function (its dx is K1 reading the taps flipped on the anticausal
    padding (0, K - 1), its dw and dbias K2) against the plain route's
    autograd, and K2 alone against its plain version.  Records of role
    "causal"."""
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch.ops import (
        depthwise_conv1d, depthwise_conv1d_dw, depthwise_conv1d_dw_plain,
        depthwise_conv1d_plain)

    dtype = getattr(torch, dtype_name)
    x, w, bias, dy = _depthwise_inputs(dtype, B, T, C, K)
    got = depthwise_conv1d(x, w, bias, causal=True)
    ref = depthwise_conv1d_plain(x, w, bias, causal=True)
    torch.cuda.synchronize()
    err = _err(got, ref)
    tol = 1e-4 if dtype == torch.float32 else _bf16_ulp(ref)
    assert err <= tol, f"causal depthwise_conv1d {dtype_name}: {err} > {tol}"
    grads = []
    for fn in (depthwise_conv1d, depthwise_conv1d_plain):
        xs, ws, bs = (t.detach().clone().requires_grad_(True)
                      for t in (x, w, bias))
        fn(xs, ws, bs, causal=True).backward(dy)
        grads.append((xs.grad, ws.grad, bs.grad))
    torch.cuda.synchronize()
    grad_tol = 2e-5 if dtype == torch.float32 else 8e-3  # as the dx check
    grad_err = max(_err(a, b) / max(1e-6, float(b.float().abs().max()))
                   for a, b in zip(*grads))
    assert grad_err <= grad_tol, (
        f"causal depthwise grads {dtype_name}: {grad_err} > {grad_tol}")
    taps = _valid_taps(T, K, K - 1)
    item = x.element_size()
    # the library's causal conv: pad K - 1 on the left, no padding inside
    xc = x.transpose(1, 2).contiguous()
    wc = w.t().contiguous()[:, None, :]
    bound, by = _bound_ms((2 * B * T * C + K * C + C) * item,
                          2 * B * C * taps, dtype_name)
    fwd = {
        "name": "depthwise_conv1d", "role": "causal", "dtype": dtype_name,
        "shape": [B, T, C, K], "max_abs_err": err, "tol": tol,
        "grads_max_rel_err_vs_plain_autograd": grad_err,
        "grads_tol": grad_tol,
        **_call_times(lambda: depthwise_conv1d(x, w, bias, causal=True),
                      lambda: F.conv1d(F.pad(xc, (K - 1, 0)), wc, bias,
                                       groups=C)),
        "plain_ms": _time_ms(lambda: depthwise_conv1d_plain(
            x, w, bias, causal=True)),
        "bound_ms": bound, "bound_by": by}
    got = depthwise_conv1d_dw(x, dy, K, causal=True, bias_grad=True)
    ref = depthwise_conv1d_dw_plain(x, dy, K, causal=True, bias_grad=True)
    torch.cuda.synchronize()
    err = max(_err(got[0], ref[0]), _err(got[1], ref[1]))
    assert err <= 2e-3, f"causal depthwise_conv1d_dw {dtype_name}: {err}"
    dyc = dy.transpose(1, 2).contiguous()
    bound, by = _bound_ms(2 * B * T * C * item + 4 * (K + 1) * C,
                          2 * B * C * taps + B * T * C, dtype_name)
    dw = {
        "name": "depthwise_conv1d_dw", "role": "causal", "dtype": dtype_name,
        "shape": [B, T, C, K], "max_abs_err": err, "tol": 2e-3,
        "bias_grad": True,
        **_call_times(
            lambda: depthwise_conv1d_dw(x, dy, K, causal=True,
                                        bias_grad=True),
            lambda: torch.nn.grad.conv1d_weight(
                F.pad(xc, (K - 1, 0)), (C, 1, K), dyc, groups=C)),
        "plain_ms": _time_ms(lambda: depthwise_conv1d_dw_plain(
            x, dy, K, causal=True, bias_grad=True)),
        "bound_ms": bound, "bound_by": by}
    return [fwd, dw]


def _ctc_inputs(B, T, C, U, live_u=None):
    """Log-probs of random logits, random labels (no blank), ragged
    frame and label counts, as the training step gives them; with
    ``live_u`` the labels of a (B, U) buffer count up to ``live_u`` of
    them (a distillation path padded to U = T)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    logits = torch.randn(B, T, C, device="cuda", generator=g)
    lp = torch.log_softmax(logits, -1)
    targets = torch.randint(1, C, (B, U), device="cuda", generator=g)
    targets[:, 1] = targets[:, 0]  # a repeated label: the skip rule
    tlen = torch.tensor([T - (i % 8) * 4 for i in range(B)], device="cuda")
    ulen = torch.tensor([(live_u or U) - (i % 5) for i in range(B)],
                        device="cuda")
    return logits, lp, targets, tlen, ulen


# One warp walks a chain of dependent steps of a lattice recursion's
# form, with the neighbour's value shuffled from the next lower lane: the
# least time a step of any kernel that follows JAX's recursion in these
# libm functions can take.  ``ctc``: lae(lae(a, a1), a2) + x, the K3/K4
# warp kernels' step (expf, log1pf); ``transducer``: lae(a + x, a1 + y)
# in the RNN-T kernels' form (max floored at -1e30, exponents clamped at
# -80, expf, expf, logf).
_CHAIN_PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <math.h>
__device__ __forceinline__ float lae(float x, float y) {
  const float m = fmaxf(x, y);
  return m + log1pf(expf(fminf(x, y) - m));
}
__device__ __forceinline__ float lae_rnnt(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), -1.0e30f);
  return m + logf(expf(fmaxf(a - m, -80.f)) + expf(fmaxf(b - m, -80.f)));
}
__global__ void lae_chain_probe(float* out, float x, int steps) {
  float a = -0.01f * threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    const float a1 = __shfl_up_sync(0xffffffffu, a, 1);
    a = lae(lae(a, a1), a) + x;
  }
  out[threadIdx.x] = a;
}
__global__ void lae_rnnt_chain_probe(float* out, float x, int steps) {
  float a = -0.01f * threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    const float a1 = __shfl_up_sync(0xffffffffu, a, 1);
    a = lae_rnnt(a + x, a1 + x);
  }
  out[threadIdx.x] = a;
}
extern "C" int lae_chain_probe_run(void* out, float x, int steps, void* st) {
  lae_chain_probe<<<1, 32, 0, (cudaStream_t)st>>>((float*)out, x, steps);
  return (int)cudaGetLastError();
}
extern "C" int lae_rnnt_chain_probe_run(void* out, float x, int steps,
                                        void* st) {
  lae_rnnt_chain_probe<<<1, 32, 0, (cudaStream_t)st>>>((float*)out, x, steps);
  return (int)cudaGetLastError();
}
"""

# -log 3: lae(lae(a, ~a), a) = a + log 3; -log 2: lae(a - log 2, ~a -
# log 2) = a.  Either way a stays put, so the chain neither overflows nor
# reaches the clamps.
_CHAIN_PROBE_X = {"ctc": -1.0986123, "transducer": -0.6931472}


def _chain_probe_lib():
    """The probe library, built once for each version of
    ``_CHAIN_PROBE_SRC`` and of the compiler flags (their hash names the
    file, as ``_build`` names the kernels' libraries)."""
    import ctypes
    import hashlib

    from speechbrain_tpu_torch.ops import _build

    digest = hashlib.sha1((_CHAIN_PROBE_SRC + " ".join(
        _build.NVCC_FLAGS)).encode()).hexdigest()[:12]
    lib_path = _build.BUILD_DIR / f"liblae_chain_probe_{digest}.so"
    if not lib_path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _build.BUILD_DIR / "lae_chain_probe.cu"
        src.write_text(_CHAIN_PROBE_SRC)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                        str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib_path))


def _chain_step_ms(kind="ctc"):
    """Device ms of one dependent step of ``_CHAIN_PROBE_SRC``'s chain of
    the given kind: CUDA events around 2N and N steps of one warp, the
    difference over N (the launch cancels)."""
    import ctypes

    import torch

    lib = _chain_probe_lib()
    fn = getattr(lib, {"ctc": "lae_chain_probe_run",
                       "transducer": "lae_rnnt_chain_probe_run"}[kind])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    out = torch.empty(32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    x = _CHAIN_PROBE_X[kind]
    n = 100_000

    def run(steps):
        assert fn(out.data_ptr(), x, steps, stream) == 0

    run(n)
    ms = {}
    for steps in (n, 2 * n):
        ms[steps] = _time_ms(lambda: run(steps), iters=5, warmup=1)
    assert bool(torch.isfinite(out).all()), "chain probe diverged"
    return (ms[2 * n] - ms[n]) / n


def _kernel_profile(fn):
    """Device ms by kernel and device kernels a call of ``fn``."""
    _, by_kernel, kernels = _device_profile(fn)
    return {"device_ms_by_kernel": by_kernel, "device_kernels_per_call": kernels}


def _check_ctc(B=32, T=251, C=5000, U=40, role=None, lib_tol=2e-3,
               live_u=None):
    """K3 (alpha + loss) and K4 (beta + gradient) at the training shape
    (or, with a ``role``, at (B, T, C, U): "timit" is the TIMIT recipe's
    step, 40 classes; "seq2seq" the CRDNN seq2seq recipe's, T 1001)
    against their plain recursions, float32 only (the log-probs are f32
    in the JAX package too); two calls give the same bits.  Each timed as a
    call (card ms, device ms, host us, beside ``F.ctc_loss``) with its
    device kernels by name; at B1 U0 (one lattice state) as the floor of the
    frame chain (``chain_floor_ms``); and beside ``chain_term_ms``, T steps
    of ``_chain_step_ms``.  The logits' gradient is held to ``F.ctc_loss``'s
    within ``lib_tol``."""
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch.ops import (
        ctc_alpha, ctc_alpha_plain, ctc_beta_grad, ctc_beta_grad_plain)

    logits, lp, targets, tlen, ulen = _ctc_inputs(B, T, C, U, live_u)
    args = (lp, targets, tlen, ulen, 0)
    alpha, loss, logz = ctc_alpha(*args)
    alpha_p, loss_p, logz_p = ctc_alpha_plain(*args)
    ones = torch.ones(B, device="cuda")
    dlp = ctc_beta_grad(*args, alpha, logz, ones)
    dlp_p = ctc_beta_grad_plain(*args, alpha_p, logz_p, ones)
    torch.cuda.synchronize()
    live = torch.zeros(B, T, 2 * U + 1, dtype=torch.bool, device="cuda")
    # a lattice state is live up to 2 U_b + 1, and on every frame up to
    # T_b (alpha is also written at t 0 past T_b: a row with no frame)
    for b in range(B):
        live[b, : int(tlen[b]), : 2 * int(ulen[b]) + 1] = True
    alpha_err = _err(alpha[live], alpha_p[live])
    loss_err = _err(loss, loss_p)
    grad_err = _err(dlp, dlp_p)
    # the same recursion in the same order on both routes; only the exp
    # and log1p implementations differ.  |alpha| reaches ~2e3, where one
    # f32 ulp is 1.2e-4; the occupancy exp(alpha + beta - logZ) carries
    # that absolute error as a relative one.
    tol_loss, tol_grad = 2e-2, 2e-3
    assert loss_err <= tol_loss and alpha_err <= tol_loss, (loss_err, alpha_err)
    assert grad_err <= tol_grad, f"ctc gradient: max|err| {grad_err} > {tol_grad}"
    alpha2, loss2, logz2 = ctc_alpha(*args)
    dlp2 = ctc_beta_grad(*args, alpha2, logz2, ones)
    torch.cuda.synchronize()
    assert (torch.equal(alpha2[live], alpha[live]) and torch.equal(loss2, loss)
            and torch.equal(logz2, logz)), "ctc_alpha: two calls, other bits"
    assert torch.equal(dlp2, dlp), "ctc_beta_grad: two calls, other bits"
    # the kernels' lae keeps JAX's numerics through a branch-free log1p
    # that must give log1pf's bits on all of [0, 1]
    from speechbrain_tpu_torch.ops.ctc import _log1p_unit_mismatches

    log1p_bad = _log1p_unit_mismatches(lp.device)
    assert log1p_bad == 0, f"branch-free log1p: {log1p_bad} floats differ"
    # the gradient w.r.t. the logits agrees with F.ctc_loss's
    lg = logits.detach().clone().requires_grad_(True)
    lib = F.ctc_loss(torch.log_softmax(lg, -1).transpose(0, 1), targets, tlen,
                     ulen, blank=0, reduction="none")
    lib.sum().backward()
    g_lib = lg.grad
    lg2 = logits.detach().clone().requires_grad_(True)
    from speechbrain_tpu_torch.ops import ctc_loss_per_seq

    ours = ctc_loss_per_seq(torch.log_softmax(lg2, -1), targets, tlen, ulen, 0)
    ours.sum().backward()
    lib_err = {"loss": _err(ours, lib), "logits_grad": _err(lg2.grad, g_lib)}
    assert lib_err["logits_grad"] <= lib_tol, lib_err
    n_live = int(live.sum())
    lat_bytes = 4 * n_live  # gathered lattice values, read once
    k3_bound = _bound_ms(2 * lat_bytes + 4 * B * U + 12 * B, 12 * n_live, "float32")
    k4_bound = _bound_ms(3 * lat_bytes + 4 * B * T * C, 20 * n_live, "float32")
    chain_term = T * _chain_step_ms()
    lpt = lp.detach().transpose(0, 1)
    lp_req = lp.detach().clone().requires_grad_(True)

    def lib_fwd():
        return F.ctc_loss(lpt, targets, tlen, ulen, blank=0, reduction="none")

    def lib_fwd_bwd():
        F.ctc_loss(lp_req.transpose(0, 1), targets, tlen, ulen, blank=0,
                   reduction="none").sum().backward()

    def ours_fwd_bwd():
        ctc_loss_per_seq(lp_req, targets, tlen, ulen, 0).sum().backward()

    def k3():
        return ctc_alpha(*args)

    def k4():
        return ctc_beta_grad(*args, alpha, logz, ones)

    # the frame chain alone: one sequence of one state, T frames
    lp1 = lp[:1].contiguous()
    args1 = (lp1, targets[:1, :0], tlen[:1], torch.zeros_like(ulen[:1]), 0)
    alpha1, _, logz1 = ctc_alpha(*args1)
    floor = {"ctc_alpha": _device_ms(lambda: ctc_alpha(*args1))[0],
             "ctc_beta_grad": _device_ms(lambda: ctc_beta_grad(
                 *args1, alpha1, logz1, ones[:1]))[0]}
    common = {"dtype": "float32", "shape": [B, T, C, U],
              "vs_F_ctc_loss": lib_err, "vs_F_ctc_loss_tol": lib_tol,
              "live_states": n_live,
              "same_bits_twice": True, "log1p_mismatches": log1p_bad,
              "chain_term_ms": chain_term,
              "chain_floor_shape": [1, T, C, 0]}
    if role is not None:
        common["role"] = role
    rows = [
        {"name": "ctc_alpha", **common, "max_abs_err": max(loss_err, alpha_err),
         "tol": tol_loss, **_call_times(k3, lib_fwd), **_kernel_profile(k3),
         "plain_ms": _time_ms(lambda: ctc_alpha_plain(*args), iters=1, warmup=0),
         "library": "F.ctc_loss forward",
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "chain_floor_ms": floor["ctc_alpha"],
         "bound_note": f"plus a chain of up to {T} dependent steps: "
                       "chain_term_ms"},
        {"name": "ctc_beta_grad", **common, "max_abs_err": grad_err,
         "tol": tol_grad, **_call_times(k4, lib_fwd_bwd), **_kernel_profile(k4),
         "plain_ms": _time_ms(lambda: ctc_beta_grad_plain(
             *args, alpha_p, logz_p, ones), iters=1, warmup=0),
         "library": "F.ctc_loss forward + backward",
         "fwd_bwd_ms": _time_ms(ours_fwd_bwd),
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "chain_floor_ms": floor["ctc_beta_grad"]},
    ]
    return rows


def _relpos_inputs(dtype, B, H, T, dh, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: (0.5 * torch.randn(*s, device="cuda", generator=g)).to(dtype)  # noqa: E731
    q, k, v = mk(B, H, T, dh), mk(B, H, T, dh), mk(B, H, T, dh)
    p = mk(H, 2 * T - 1, dh)
    u = 0.1 * torch.randn(H, dh, device="cuda", generator=g)
    vb = 0.1 * torch.randn(H, dh, device="cuda", generator=g)
    madd = torch.zeros(B, T, device="cuda")
    madd[1, T - T // 5:] = -65000.0  # padded tail of the second utterance
    dout = torch.randn(B, H, T, dh, device="cuda", generator=g)
    return q, k, v, p, u, vb, madd, dout


def _materialized_bias(q, p, vb, madd, scale):
    """The position term and key mask as the (B, H, T, T) additive bias
    that a library attention takes (f32)."""
    import torch

    B, H, T, _ = q.shape
    ar = torch.arange(T, device="cuda")
    idx = (T - 1 - ar[:, None] + ar[None, :]).clamp(0, 2 * T - 2)
    ps = torch.einsum("bhqd,hld->bhql", q.float() + vb[None, :, None], p.float())
    return (torch.gather(ps, -1, idx.expand(B, H, T, T)) * scale
            + madd[:, None, None, :])


def _check_relpos_bwd(dtype_name, B=8, T=512, rate=0.0, H=4, dh=36,
                      role=None):
    """K6 at the training shape (B = 8 utterances, T_enc = 512; H x dh 4 x
    36, conformer_small's, or 4 x 64, conformer_medium's, role "dh64")
    against autograd through the plain version; with ``rate > 0`` both
    with the dropout mask of seed DROPOUT_SEED, and the kernel's
    determinism."""
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch.ops import relpos_attention_bwd, relpos_attention_bwd_plain
    from speechbrain_tpu_torch.ops.relpos_attention import _fwd_kernel

    dtype = getattr(torch, dtype_name)
    q, k, v, p, u, vb, madd, dout = _relpos_inputs(dtype, B, H, T, dh, SEED + 3)
    scale = 1.0 / (H * dh) ** 0.5
    seed = DROPOUT_SEED if rate > 0 else 0
    tail = (False, rate, seed)  # causal, dropout rate, its seed
    out, lse = _fwd_kernel(q, k, v, p, u, vb, madd, scale, *tail)
    dsum = (dout * out).sum(-1)
    got = relpos_attention_bwd(q, k, v, p, u, vb, madd, dout, lse, dsum, scale,
                               *tail)
    ref = relpos_attention_bwd_plain(q, k, v, p, u, vb, madd, dout, scale, *tail)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "dp", "du", "dvb")
    rel = {n: _err(a, b) / max(1e-6, float(b.abs().max()))
           for n, a, b in zip(names, got, ref)}
    err = max(_err(a, b) for a, b in zip(got, ref))
    # f32: 3xTF32 products (~f32 rounding) against f32 autograd, sums of up
    # to B*T^2 terms (dp, du, dvb) in other orders.  bf16: JAX's rounding
    # points (q+u, q+vb, dO, dS and the dropped P cast to bf16 before each
    # product, f32 sums) against f32 autograd from the same stored values
    tol = 1e-4 if dtype_name == "float32" else 1e-2
    assert max(rel.values()) <= tol, f"relpos_attention_bwd {dtype_name}: {rel}"
    # no atomics: a second call gives the same bits
    again = relpos_attention_bwd(q, k, v, p, u, vb, madd, dout, lse, dsum,
                                 scale, *tail)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), (
        "relpos_attention_bwd: one seed, two results")
    extra = {"bit_identical_same_seed": True}
    if rate > 0:
        other = relpos_attention_bwd(q, k, v, p, u, vb, madd, dout, lse, dsum,
                                     scale, False, rate, seed + 1)
        torch.cuda.synchronize()
        seed_diff = max(_err(a, b) for a, b in zip(got, other))
        assert seed_diff > 1e-3, f"relpos_attention_bwd: seed + 1 changes {seed_diff}"
        extra.update({"role": "dropout", "rate": rate, "seed": seed,
                      "seed_plus_one_max_abs_diff": seed_diff})
    if role is not None:
        extra["role"] = role
    # library yardstick: SDPA's backward through a materialized bias
    qu = (q.float() + u[None, :, None]).to(dtype).requires_grad_(True)
    kl, vl = k.clone().requires_grad_(True), v.clone().requires_grad_(True)
    bias = _materialized_bias(q, p, vb, madd, scale).to(dtype).requires_grad_(True)
    library_ms, library = None, "none"
    try:
        lib_out = F.scaled_dot_product_attention(qu, kl, vl, attn_mask=bias,
                                                 dropout_p=rate, scale=scale)
        do_l = dout.to(dtype)
        library_ms = _time_ms(lambda: torch.autograd.grad(
            lib_out, (qu, kl, vl, bias), do_l, retain_graph=True))
        library = "SDPA backward with a bias that requires grad"
        if rate > 0:
            library += f", dropout_p {rate} (its own generator)"
    except RuntimeError as e:  # no SDPA backend differentiates the bias
        library = f"none ({str(e).splitlines()[0][:80]})"
    item = q.element_size()
    nbytes = ((3 * B * H * T * dh + H * (2 * T - 1) * dh) * item
              + 4 * (2 * H * dh + B * T + B * H * T * dh + 2 * B * H * T)
              + 4 * (3 * B * H * T * dh + H * (2 * T - 1) * dh + 2 * H * dh))
    # the function's 16 dh FLOPs per (b, h, q, k) at the peak of the tensor
    # cores the kernel uses, beside the CUDA-core f32 bound of the design
    # before it
    flops = 16 * B * H * T * T * dh
    core = "tf32" if dtype_name == "float32" else "bfloat16"
    bound, by = _bound_ms(nbytes, flops, core)
    cc_bound, _ = _bound_ms(nbytes, flops, "float32")
    # MMA work the kernel issues: nine products per (64 x 64) tile pair,
    # dh padded to the MMA depth, PB / dq-position / dBand over 80 band
    # columns (rows); TF32 three times (hi hi, hi lo, lo hi)
    dhp = -(-dh // (8 if core == "tf32" else 16)) * (8 if core == "tf32" else 16)
    pairs = B * H * (T // 64) ** 2
    mma_flops = pairs * 2 * dhp * (6 * 64 * 64 + 3 * 64 * 80) * (3 if core == "tf32" else 1)
    return {
        "name": "relpos_attention_bwd", "dtype": dtype_name, "shape": [B, H, T, dh],
        **extra,
        "max_abs_err": err, "max_rel_err": rel, "tol": tol, "tol_kind": "relative",
        "ms": _time_ms(lambda: relpos_attention_bwd(
            q, k, v, p, u, vb, madd, dout, lse, dsum, scale, *tail), iters=20),
        **dict(zip(("device_ms", "device_ms_by_kernel"), _device_ms(
            lambda: relpos_attention_bwd(q, k, v, p, u, vb, madd, dout, lse,
                                         dsum, scale, *tail)))),
        "plain_ms": _time_ms(lambda: relpos_attention_bwd_plain(
            q, k, v, p, u, vb, madd, dout, scale, *tail), iters=5),
        "library_ms": library_ms, "library": library,
        "bound_ms": bound, "bound_by": by,
        "bound_peak": ("TF32 tensor cores, 495 TFLOP/s" if core == "tf32"
                       else "bf16 tensor cores, 989 TFLOP/s"),
        "cuda_core_f32_bound_ms": cc_bound,
        "mma": ("mma.sync m16n8k8 TF32, 3xTF32" if core == "tf32"
                else "mma.sync m16n8k16 bf16, f32 sums"),
        "kernel_mma_flops": mma_flops,
    }


def _check_relpos(dtype_name, T, B=2, rate=0.0, H=4, dh=36, role=None):
    """K5 against its plain version, and its lse; bf16 also against the
    rounding-point reference; with ``rate > 0`` all with the dropout mask
    of seed DROPOUT_SEED, and the kernel's determinism.  H x dh 4 x 36 is
    conformer_small's, 4 x 64 conformer_medium's (role "dh64")."""
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch.ops import relpos_attention, relpos_attention_plain
    from speechbrain_tpu_torch.ops.relpos_attention import (
        _fwd_kernel, _relpos_attention_rounded)

    dtype = getattr(torch, dtype_name)
    q, k, v, p, u, vb, madd, _ = _relpos_inputs(dtype, B, H, T, dh, SEED + T)
    scale = 1.0 / (H * dh) ** 0.5
    seed = DROPOUT_SEED if rate > 0 else 0
    tail = (False, rate, seed)  # causal, dropout rate, its seed
    args = (q, k, v, p, u, vb, madd, scale, *tail)
    got = relpos_attention(*args)
    ref = relpos_attention_plain(*args)
    _, lse = _fwd_kernel(*args)
    # the rounding-point reference, keys in the kernel's 64-key tiles
    # (weights rounded against the running max) and in one pass (against
    # the row's max, as JAX's kernel)
    rounded, rounded_lse = _relpos_attention_rounded(*args, key_tile=64)
    jax_rounded = _relpos_attention_rounded(*args)[0]
    torch.cuda.synchronize()
    err = _err(got, ref)
    ref_max = float(ref.abs().max())
    extra = {"max_rel_err": err / ref_max}
    bias = _materialized_bias(q, p, vb, madd, scale)
    if dtype == torch.float32:
        # 3xTF32 products (~f32 rounding) against f32 arithmetic from the
        # same stored values; sums in other orders
        tol, tol_kind = 1e-4, "absolute"
        assert err <= tol, f"relpos_attention f32 T={T}: max|err| {err} > {tol}"
        # the log-sum-exp the backward reads (taken before dropout),
        # against the materialized scores
        content = torch.einsum("bhqd,bhkd->bhqk", q.float() + u[None, :, None],
                               k.float())
        lse_ref = torch.logsumexp(content * scale + bias, -1)
    else:
        # the operands of each product rounded to bf16 where JAX's kernel
        # rounds them: against the f32 plain version relative to max|ref|,
        # and against the rounding-point reference of the kernel's tiles
        tol, tol_kind = 1e-2, "relative to max|ref|"
        rel_rounded = _err(got, rounded) / ref_max
        assert err / ref_max <= tol and rel_rounded <= 2e-3, (
            f"relpos_attention bf16 T={T}: rel err {err / ref_max} (tol {tol}), "
            f"vs the rounding-point reference {rel_rounded} (tol 2e-3)")
        extra.update({"max_rel_err_vs_rounded": rel_rounded,
                      "tol_vs_rounded": 2e-3,
                      "max_rel_err_vs_jax_rounding": _err(got, jax_rounded) / ref_max})
        lse_ref = rounded_lse  # the same products, sums in other orders
    lse_err = _err(lse, lse_ref)
    assert lse_err <= 1e-4, f"relpos_attention lse {dtype_name}: {lse_err}"
    if rate > 0:
        again = relpos_attention(*args)
        other = relpos_attention(q, k, v, p, u, vb, madd, scale, False, rate,
                                 seed + 1)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "relpos_attention: one seed, two results"
        seed_diff = _err(got, other)
        assert seed_diff > 1e-3, f"relpos_attention: seed + 1 changes {seed_diff}"
        extra.update({"role": "dropout", "rate": rate, "seed": seed,
                      "bit_identical_same_seed": True,
                      "seed_plus_one_max_abs_diff": seed_diff})
    if role is not None:
        extra["role"] = role
    # library yardstick: SDPA with the materialized position bias
    qu = (q.float() + u[None, :, None]).to(dtype)
    bias = bias.to(dtype)
    item = q.element_size()
    nbytes = ((3 * B * H * T * dh + H * (2 * T - 1) * dh) * item
              + 4 * (2 * H * dh + B * T + B * H * T * dh + B * H * T))  # + lse
    # the function's 6 dh FLOPs per (b, h, q, k) at the peak of the tensor
    # cores the kernel uses, beside the CUDA-core f32 bound of the design
    # before it
    flops = 6 * B * H * T * T * dh
    core = "tf32" if dtype_name == "float32" else "bfloat16"
    bound, by = _bound_ms(nbytes, flops, core)
    cc_bound, _ = _bound_ms(nbytes, flops, "float32")
    # MMA work the kernel issues: per (64-query, 64-key) tile pair PB over
    # 80 band columns, S and PV, dh padded to the MMA depth; TF32 thrice
    dhp = -(-dh // (8 if core == "tf32" else 16)) * (8 if core == "tf32" else 16)
    pairs = B * H * (T // 64) ** 2
    mma_flops = pairs * 2 * dhp * 64 * (80 + 2 * 64) * (3 if core == "tf32" else 1)
    library_ms, library = None, "SDPA with the materialized bias"
    try:
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qu, k, v, attn_mask=bias, dropout_p=rate, scale=scale))
        if rate > 0:
            library += f", dropout_p {rate} (its own generator)"
    except RuntimeError as e:  # no SDPA backend takes this combination
        library = f"none ({str(e).splitlines()[0][:80]})"
    library_device_ms = None
    if library_ms is not None:
        library_device_ms = _device_ms(lambda: F.scaled_dot_product_attention(
            qu, k, v, attn_mask=bias, dropout_p=rate, scale=scale))[0]
    return {
        "name": "relpos_attention", "dtype": dtype_name, "shape": [B, H, T, dh],
        **extra,
        "max_abs_err": err, "tol": tol, "tol_kind": tol_kind,
        "lse_max_abs_err": lse_err, "lse_tol": 1e-4,
        "ms": _time_ms(lambda: relpos_attention(*args)),
        "device_ms": _device_ms(lambda: relpos_attention(*args))[0],
        "plain_ms": _time_ms(lambda: relpos_attention_plain(*args)),
        "library_ms": library_ms, "library": library,
        "library_device_ms": library_device_ms,
        "bound_ms": bound, "bound_by": by,
        "bound_peak": ("TF32 tensor cores, 495 TFLOP/s" if core == "tf32"
                       else "bf16 tensor cores, 989 TFLOP/s"),
        "cuda_core_f32_bound_ms": cc_bound,
        "mma": ("mma.sync m16n8k8 TF32, 3xTF32" if core == "tf32"
                else "mma.sync m16n8k16 bf16, f32 sums"),
        "kernel_mma_flops": mma_flops,
    }


def _beam_ctx_check(ctx, ref, new, H, pos, dtype_name):
    """K7's context against the plain version, which rounds the weights
    to the cache dtype where the kernel does: within 1e-5 (f32: every
    element).  In bf16 CUDA's expf and the sums' order can move a weight
    across a bf16 rounding midpoint, one bf16 step (at most 2^-8 below 1)
    for its whole head: at most 1 % of the heads may pass 1e-5, each
    element within 2^-8 * sum_l |v[l]| over the lanes <= pos.  Returns
    (max |error|, heads past 1e-5)."""
    n, HD = ctx.shape
    L = new.shape[2] // 2
    diff = (ctx - ref).abs()
    far = diff > 1e-5 + 1e-5 * ref.abs()
    bad_heads = int(far.reshape(n, H, -1).any(-1).sum())
    allowed = 0 if dtype_name == "float32" else max(1, n * H // 100)
    v = new[:, :, L:L + pos + 1].float().abs().sum(-1)
    assert bad_heads <= allowed and bool((diff <= 2.0 ** -8 * v + 1e-5).all()), (
        f"beam_attend_step {dtype_name}: ctx max|err| {float(diff.max())}, "
        f"{bad_heads} heads past 1e-5 (allowed {allowed})")
    return float(diff.max()), bad_heads


def _check_beam_cache(dtype_name, pos=200, role=None, H=4, Dh=36, n=80,
                      L=256, n_src=36):
    """K7 at the serving shape (``n`` 80 beam rows drawn from ``n_src`` 36,
    L 256; H x Dh 4 x 36 conformer_small's, 4 x 64 conformer_medium's, 8
    x 64 the LibriSpeech transformer's; the Taigi search's 320 rows, B 32
    x beam 10, drawn from all 320, L 128) against its plain version, which rounds
    the weights to the cache dtype as the kernel does: the cache bit for
    bit, ctx within 1e-5 (``_beam_ctx_check``).
    Timed as a bare call (contiguous q/k/v, int32 rows) and as the
    decoder makes it (``qkv.chunk`` views, int64 rows), with the device
    kernels that call issues (profiler)."""
    import torch

    from speechbrain_tpu_torch.ops.beam_cache import _xla_ref, beam_attend_step

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    HD = H * Dh
    kv = torch.randn(n, HD, 2 * L, device="cuda", generator=g).to(dtype)
    rows = torch.randint(0, n_src, (n,), device="cuda", generator=g)
    rows32 = rows.to(torch.int32)
    q, kn, vn = (torch.randn(n, HD, device="cuda", generator=g).to(dtype) / 6 for _ in range(3))
    dst = torch.empty_like(kv)
    ctx, new = beam_attend_step(kv, rows32, q, kn, vn, pos, H, dst=dst)
    ctx_ref, new_ref = _xla_ref(kv, rows32, pos, q, kn, vn, H)
    torch.cuda.synchronize()
    assert torch.equal(new, new_ref), f"beam_attend_step {dtype_name}: cache not bit-exact"
    err, bad_heads = _beam_ctx_check(ctx, ctx_ref, new, H, pos, dtype_name)
    tol = 1e-5
    # the decoder's call: q scaled (a new tensor), k and v strided views
    # of the fused projection, the search's int64 rows
    qkv = torch.randn(n, 3 * HD, device="cuda", generator=g).to(dtype) / 6
    q_t, k_t, v_t = qkv.chunk(3, dim=-1)
    q_t = q_t * (1.0 / Dh ** 0.5)

    def decoder_call():
        return beam_attend_step(kv, rows, q_t, k_t, v_t, pos, H, dst=dst)

    ctx_d, new_d = decoder_call()
    ctx_dr, new_dr = _xla_ref(kv, rows, pos, q_t, k_t.contiguous(),
                              v_t.contiguous(), H)
    torch.cuda.synchronize()
    assert torch.equal(new_d, new_dr), "beam_attend_step decoder call: cache"
    _beam_ctx_check(ctx_d, ctx_dr, new_d, H, pos, dtype_name)
    dev_ms, by_kernel, kernels = _device_profile(decoder_call)
    item = kv.element_size()
    n_src = int(torch.unique(rows).numel())
    nbytes = (n_src + n) * HD * 2 * L * item + 3 * n * HD * item + 4 * n + 4 * n * HD
    bound, by = _bound_ms(nbytes, 4 * n * HD * (pos + 1), dtype_name)
    rec = {
        "name": "beam_attend_step", "dtype": dtype_name, "shape": [n, H, Dh, L],
        "pos": pos, "source_rows": n_src,
        "max_abs_err": err, "tol": tol, "cache_bit_exact": True,
        "heads_past_tol": bad_heads,
        **_call_times(lambda: beam_attend_step(kv, rows32, q, kn, vn, pos, H, dst=dst)),
        "plain_ms": _time_ms(lambda: _xla_ref(kv, rows32, pos, q, kn, vn, H)),
        "library_ms": None,
        "bound_ms": bound, "bound_by": by,
        "decoder_call": {"ms": _time_ms(decoder_call), "device_ms": dev_ms,
                         "device_ms_by_kernel": by_kernel,
                         "device_kernels_per_call": kernels,
                         "host_us_per_call": _host_us(decoder_call)},
    }
    if role is not None:
        rec["role"] = role
    return rec


def _transducer_inputs(B, T, U, V, seed, max_u=40):
    """Joint-network logits, labels 1..V-1 padded with the pad id 0 past
    U_b, ragged frame counts and label counts of ``max_u`` - 12 to
    ``max_u`` (the training batch's 28 to 40 by default)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(B, T, U + 1, V, device="cuda", generator=g)
    targets = torch.randint(1, V, (B, U), device="cuda", generator=g)
    tlen = torch.tensor([T - 6 * (i % 5) for i in range(B)], device="cuda")
    ulen = torch.tensor([min(U, max_u) - 3 * (i % 5) for i in range(B)],
                        device="cuda")
    targets[torch.arange(U, device="cuda")[None, :] >= ulen[:, None]] = 0
    return logits, targets, tlen, ulen


def _check_transducer(U, role=None, T=251, B=12, V=1000, max_u=40):
    """K8 (alpha + final) and K9 (beta + occupancy gradients) at the
    training shape (B 12, T 251, U 64: the recipe's token bucket, V 1000;
    ``max_u`` labels at most, see ``_transducer_inputs``) or the wide one
    (U 256, the top bucket) against their plain versions,
    float32; two calls give the same bits; and the loss entry (tables,
    K8, K9, fused softmax backward) against its plain route.  Each kernel
    timed as the loss entry launches it (card ms, device ms, host us,
    device kernels a call by name); at B1 U0 T251 (one lattice column) as
    the floor of the diagonal chain (``chain_floor_ms``); and beside
    ``chain_term_ms``, T + U steps of ``_chain_step_ms("transducer")``."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.ops import transducer as ot

    logits, targets, tlen, ulen = _transducer_inputs(B, T, U, V, SEED + U,
                                                     max_u)
    with torch.no_grad():
        tables = ot.transducer_tables(torch.log_softmax(logits, -1), targets,
                                      0, tlen, ulen)
    tl, ul = ot._validated(tlen, ulen, T, U, logits.device, "check")
    alpha, final = ops.transducer_alpha(*tables, tlen, ulen)
    alpha_p, final_p = ops.transducer_alpha_plain(*tables, tlen, ulen)
    grads = ops.transducer_beta_grad(*tables, alpha, tlen, ulen, final)
    grads_p = ops.transducer_beta_grad_plain(*tables, alpha_p, tlen, ulen,
                                             final_p)
    alpha2, final2 = ops.transducer_alpha(*tables, tlen, ulen)
    grads2 = ops.transducer_beta_grad(*tables, alpha2, tlen, ulen, final2)
    torch.cuda.synchronize()
    # the same recursion, cell by cell in the same order on both routes;
    # expf/logf differ in ulps.  |alpha| reaches ~2e3 (251 frames of
    # log(1/1000)), where one f32 ulp is 1.2e-4: alpha and final relative
    # 2e-5; the occupancies exp(alpha + beta - logZ) in [-1, 0] carry that
    # error as a relative one
    rel = max(_err(final, final_p) / float(final_p.abs().max()),
              _err(alpha, alpha_p) / float(alpha_p.abs().max()))
    grad_err = max(_err(a, b) for a, b in zip(grads, grads_p))
    tol_rel, tol_grad = 2e-5, 2e-3
    assert rel <= tol_rel, f"transducer alpha/final: rel err {rel} > {tol_rel}"
    assert grad_err <= tol_grad, f"transducer grads: {grad_err} > {tol_grad}"
    same_bits = (torch.equal(alpha2, alpha) and torch.equal(final2, final)
                 and all(torch.equal(a, b) for a, b in zip(grads2, grads)))
    assert same_bits, "transducer kernels: two calls, other bits"
    # the loss entry, kernels against plain, loss and d loss / d logits
    out = []
    for use_kernels in (True, False):
        x = logits.clone().requires_grad_(True)
        loss = ops.transducer_loss_logits(x, targets, tlen, ulen, 0,
                                          use_kernels=use_kernels)
        loss.sum().backward()
        out.append((loss.detach(), x.grad))
        del x
    entry_err = {"loss_rel": _err(out[0][0], out[1][0])
                 / float(out[1][0].abs().max()),
                 "dlogits": _err(out[0][1], out[1][1])}
    assert entry_err["loss_rel"] <= tol_rel and entry_err["dlogits"] <= tol_grad, (
        entry_err)
    del out
    torch.cuda.empty_cache()
    cells = B * T * (U + 1)
    k8_bound = _bound_ms(4 * (2 * cells + B * T * U) + 12 * B, 12 * cells,
                         "float32")
    k9_bound = _bound_ms(4 * (2 * cells + B * T * U) + 4 * (cells + B * T * U)
                         + 12 * B, 20 * cells, "float32")
    chain_term = (T + U) * _chain_step_ms("transducer")
    x = logits.clone().requires_grad_(True)

    def entry_fwd_bwd():
        ops.transducer_loss_logits(x, targets, tlen, ulen, 0).sum().backward()

    def k8():
        return ot._alpha_kernel(*tables, tl, ul)

    def k9():
        return ot._beta_grad_kernel(*tables, alpha, tl, ul, final)

    # the diagonal chain alone: one utterance of one column, T frames
    t1 = (tables[0][:1, :, :1].contiguous(), tables[1][:1, :, :0].contiguous())
    tl1, ul1 = torch.full_like(tl[:1], T), torch.zeros_like(ul[:1])
    alpha1, final1 = ot._alpha_kernel(*t1, tl1, ul1)
    floor = {"transducer_alpha": _device_ms(lambda: ot._alpha_kernel(
                 *t1, tl1, ul1))[0],
             "transducer_beta_grad": _device_ms(lambda: ot._beta_grad_kernel(
                 *t1, alpha1, tl1, ul1, final1))[0]}
    common = {"dtype": "float32", "shape": [B, T, U, V], "role": role,
              "cells": cells, "library_ms": None,
              "library": "none: no single call (PyTorch has no RNN-T loss)",
              "tol_kind": "alpha/final relative, gradients absolute",
              "bit_identical_two_calls": same_bits,
              "chain_term_ms": chain_term, "chain_floor_shape": [1, T, 0]}
    chain = (f"plus a chain of {T + U} dependent anti-diagonals: "
             "chain_term_ms")
    rows = [
        {"name": "transducer_alpha", **common, "max_abs_err": _err(alpha, alpha_p),
         "max_rel_err": rel, "tol": tol_rel,
         **_call_times(k8), **_kernel_profile(k8),
         "wrapper_ms": _time_ms(lambda: ops.transducer_alpha(*tables, tlen, ulen)),
         "plain_ms": _time_ms(lambda: ops.transducer_alpha_plain(
             *tables, tlen, ulen), iters=1, warmup=0),
         "chain_floor_ms": floor["transducer_alpha"],
         "bound_ms": k8_bound[0], "bound_by": k8_bound[1], "bound_note": chain},
        {"name": "transducer_beta_grad", **common, "max_abs_err": grad_err,
         "tol": tol_grad, "loss_entry_vs_plain": entry_err,
         **_call_times(k9), **_kernel_profile(k9),
         "plain_ms": _time_ms(lambda: ops.transducer_beta_grad_plain(
             *tables, alpha_p, tlen, ulen, final_p), iters=1, warmup=0),
         "loss_fwd_bwd_ms": _time_ms(entry_fwd_bwd, iters=5),
         "chain_floor_ms": floor["transducer_beta_grad"],
         "bound_ms": k9_bound[0], "bound_by": k9_bound[1], "bound_note": chain},
    ]
    del x, logits
    torch.cuda.empty_cache()
    return rows


def _check_lattice_wide():
    """K3/K4 at 2U+1 = 1041 states (character CTC: 520 targets over 1100
    frames) and K8/K9 at U+1 = 1100 columns: more than a block has
    threads, two states or columns a thread.  Against the plain
    recursions, float32, with the tolerances of the training shapes;
    role "wide_lattice"."""
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.ops import transducer as ot

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    B, T, C, U = 4, 1100, 32, 520
    lp = torch.log_softmax(torch.randn(B, T, C, device="cuda", generator=g), -1)
    tg = torch.randint(1, C, (B, U), device="cuda", generator=g)
    tg[:, 1] = tg[:, 0]  # the skip rule
    tlen = torch.tensor([T - 9 * i for i in range(B)], device="cuda")
    ulen = torch.tensor([U - 7 * i for i in range(B)], device="cuda")
    args = (lp, tg, tlen, ulen, 0)
    alpha, loss, logz = ops.ctc_alpha(*args)
    alpha_p, loss_p, logz_p = ops.ctc_alpha_plain(*args)
    ones = torch.ones(B, device="cuda")
    dlp = ops.ctc_beta_grad(*args, alpha, logz, ones)
    dlp_p = ops.ctc_beta_grad_plain(*args, alpha_p, logz_p, ones)
    torch.cuda.synchronize()
    loss_err, grad_err = _err(loss, loss_p), _err(dlp, dlp_p)
    tol_loss, tol_grad = 2e-2, 2e-3  # as at the training shape (_check_ctc)
    assert loss_err <= tol_loss and grad_err <= tol_grad, (loss_err, grad_err)
    n_live = int(sum(int(tlen[b]) * (2 * int(ulen[b]) + 1) for b in range(B)))
    k3 = _bound_ms(8 * n_live + 4 * B * U + 12 * B, 12 * n_live, "float32")
    k4 = _bound_ms(12 * n_live + 4 * B * T * C, 20 * n_live, "float32")
    lpt = lp.transpose(0, 1)
    try:
        lib_ms = _time_ms(lambda: F.ctc_loss(lpt, tg, tlen, ulen, blank=0,
                                             reduction="none"), iters=5)
    except RuntimeError:  # no CUDA CTC path takes this length
        lib_ms = None
    common = {"role": "wide_lattice", "dtype": "float32", "shape": [B, T, C, U],
              "states": 2 * U + 1}
    rows = [
        {"name": "ctc_alpha", **common, "max_abs_err": loss_err, "tol": tol_loss,
         "ms": _time_ms(lambda: ops.ctc_alpha(*args), iters=5),
         "plain_ms": _time_ms(lambda: ops.ctc_alpha_plain(*args), iters=1,
                              warmup=0),
         "library_ms": lib_ms, "bound_ms": k3[0], "bound_by": k3[1]},
        {"name": "ctc_beta_grad", **common, "max_abs_err": grad_err,
         "tol": tol_grad,
         "ms": _time_ms(lambda: ops.ctc_beta_grad(*args, alpha, logz, ones),
                        iters=5),
         "plain_ms": _time_ms(lambda: ops.ctc_beta_grad_plain(
             *args, alpha_p, logz_p, ones), iters=1, warmup=0),
         "library_ms": None, "bound_ms": k4[0], "bound_by": k4[1]},
    ]
    B, T, U, V = 2, 64, 1099, 8
    logits = torch.randn(B, T, U + 1, V, device="cuda", generator=g)
    targets = torch.randint(1, V, (B, U), device="cuda", generator=g)
    tlen = torch.tensor([T, T - 5], device="cuda")
    ulen = torch.tensor([U, U - 30], device="cuda")
    targets[1, U - 30:] = 0
    with torch.no_grad():
        tables = ot.transducer_tables(torch.log_softmax(logits, -1), targets,
                                      0, tlen, ulen)
    alpha, final = ops.transducer_alpha(*tables, tlen, ulen)
    alpha_p, final_p = ops.transducer_alpha_plain(*tables, tlen, ulen)
    grads = ops.transducer_beta_grad(*tables, alpha, tlen, ulen, final)
    grads_p = ops.transducer_beta_grad_plain(*tables, alpha_p, tlen, ulen,
                                             final_p)
    torch.cuda.synchronize()
    rel = max(_err(final, final_p) / float(final_p.abs().max()),
              _err(alpha, alpha_p) / float(alpha_p.abs().max()))
    g_err = max(_err(a, b) for a, b in zip(grads, grads_p))
    tol_rel, tol_grad = 2e-5, 2e-3  # as at the training shape
    assert rel <= tol_rel and g_err <= tol_grad, (rel, g_err)
    # the kernels alone (ms above: the wrappers, one host sync a call)
    tl, ul = ot._validated(tlen, ulen, T, U, logits.device, "check")
    device = {"transducer_alpha": _device_ms(lambda: ot._alpha_kernel(
                  *tables, tl, ul))[0],
              "transducer_beta_grad": _device_ms(lambda: ot._beta_grad_kernel(
                  *tables, alpha, tl, ul, final))[0]}
    cells = B * T * (U + 1)
    k8 = _bound_ms(4 * (2 * cells + B * T * U) + 12 * B, 12 * cells, "float32")
    k9 = _bound_ms(4 * (3 * cells + 2 * B * T * U) + 12 * B, 20 * cells,
                   "float32")
    common = {"role": "wide_lattice", "dtype": "float32", "shape": [B, T, U, V],
              "columns": U + 1, "library_ms": None}
    rows += [
        {"name": "transducer_alpha", **common, "max_abs_err": _err(alpha, alpha_p),
         "max_rel_err": rel, "tol": tol_rel,
         "ms": _time_ms(lambda: ops.transducer_alpha(*tables, tlen, ulen), iters=5),
         "device_ms": device["transducer_alpha"],
         "plain_ms": _time_ms(lambda: ops.transducer_alpha_plain(
             *tables, tlen, ulen), iters=1, warmup=0),
         "bound_ms": k8[0], "bound_by": k8[1]},
        {"name": "transducer_beta_grad", **common, "max_abs_err": g_err,
         "tol": tol_grad,
         "ms": _time_ms(lambda: ops.transducer_beta_grad(
             *tables, alpha, tlen, ulen, final), iters=5),
         "device_ms": device["transducer_beta_grad"],
         "plain_ms": _time_ms(lambda: ops.transducer_beta_grad_plain(
             *tables, alpha_p, tlen, ulen, final_p), iters=1, warmup=0),
         "bound_ms": k9[0], "bound_by": k9[1]},
    ]
    return rows


# wrapper name -> (kernel source, the TPU kernel's pl.pallas_call, the
# check record that gives its row: name and role)
KERNEL_INFO = {
    "depthwise_conv1d": (
        "speechbrain_tpu_torch/csrc/depthwise_conv.cu",
        "speechbrain_tpu/ops/pallas/depthwise_conv.py:57",
        ("depthwise_conv1d", None),
    ),
    "depthwise_conv1d_dw": (
        "speechbrain_tpu_torch/csrc/depthwise_conv.cu",
        "speechbrain_tpu/ops/pallas/depthwise_conv.py:73",
        ("depthwise_conv1d_dw", None),
    ),
    "ctc_alpha": (
        "speechbrain_tpu_torch/csrc/ctc.cu",
        "speechbrain_tpu/ops/pallas/ctc.py:166",
        ("ctc_alpha", None),
    ),
    "ctc_beta_grad": (
        "speechbrain_tpu_torch/csrc/ctc.cu",
        "speechbrain_tpu/ops/pallas/ctc.py:182",
        ("ctc_beta_grad", None),
    ),
    "relpos_attention": (
        "speechbrain_tpu_torch/csrc/relpos_attention.cu",
        "speechbrain_tpu/ops/pallas/relpos_attention.py:295",
        ("relpos_attention", None),
    ),
    "relpos_attention_bwd": (
        "speechbrain_tpu_torch/csrc/relpos_attention_bwd.cu",
        "speechbrain_tpu/ops/pallas/relpos_attention.py:334",
        ("relpos_attention_bwd", None),
    ),
    "beam_attend_step": (
        "speechbrain_tpu_torch/csrc/beam_cache.cu",
        "speechbrain_tpu/ops/pallas/beam_cache.py:184",
        ("beam_attend_step", None),
    ),
    "transducer_alpha": (
        "speechbrain_tpu_torch/csrc/transducer.cu",
        "speechbrain_tpu/ops/pallas/transducer.py:253",
        ("transducer_alpha", None),
    ),
    "transducer_beta_grad": (
        "speechbrain_tpu_torch/csrc/transducer.cu",
        "speechbrain_tpu/ops/pallas/transducer.py:311",
        ("transducer_beta_grad", None),
    ),
}


def phase_kernels(only=None):
    """Each kernel against its plain version; returns the records.
    ``only`` (a set of "depthwise", "relpos", "relpos_bwd", "beam_cache",
    "ctc", "transducer", or None for all) picks the families checked."""
    def want(family):
        return only is None or family in only

    records = []
    for dtype_name in ("float32", "bfloat16"):
        if want("depthwise"):
            records.append(_check_depthwise(dtype_name))
            records.append(_check_depthwise_dx(dtype_name))
            records.append(_check_depthwise_dw(dtype_name))
        if want("relpos"):
            for T in (512, 1024):
                records.append(_check_relpos(dtype_name, T))
            records.append(_check_relpos(dtype_name, 512, B=8))
            # attention dropout at conformer_small's transformer_dropout
            records.append(_check_relpos(dtype_name, 512, B=8, rate=0.1))
            # conformer_medium's heads (KsponSpeech, Switchboard): dh 64
            records.append(_check_relpos(dtype_name, 512, B=8, dh=64,
                                         role="dh64"))
        if want("relpos_bwd"):
            records.append(_check_relpos_bwd(dtype_name))
            records.append(_check_relpos_bwd(dtype_name, rate=0.1))
            records.append(_check_relpos_bwd(dtype_name, dh=64, role="dh64"))
        if want("beam_cache"):
            records.append(_check_beam_cache(dtype_name))
            # the middle of the serve's 115 beam steps
            records.append(_check_beam_cache(dtype_name, pos=57, role="pos57"))
            # conformer_medium's decoder and the LibriSpeech transformer's
            records.append(_check_beam_cache(dtype_name, Dh=64,
                                             role="h4dh64"))
            records.append(_check_beam_cache(dtype_name, H=8, Dh=64,
                                             role="h8dh64"))
            # the Taigi search: B 32 x beam 10 rows, 6 decoder layers at
            # H4 Dh64, the cache of its 76 steps rounded to L 128, at the
            # 50th step
            records.append(_check_beam_cache(dtype_name, pos=50, Dh=64,
                                             n=320, L=128, n_src=320,
                                             role="taigi"))
        if want("depthwise"):
            # ConformerDecoder's causal convolution module
            records.extend(_check_depthwise_causal(dtype_name))
    if want("depthwise"):
        records.extend(_check_depthwise_separation())
    if want("ctc"):
        records.extend(_check_ctc())
        records.extend(_check_ctc(8, 301, 40, 40, role="timit"))
        # the CRDNN seq2seq step's lattice: T_enc 1001, BPE 1000, 48
        # tokens.  |log Z| reaches ~7e3 there (3.5x the 2e3 at which 2e-3
        # was set), and the occupancies carry its f32 ulp (4.9e-4) as a
        # relative error: the logits' gradient lay 5.99e-3 from
        # F.ctc_loss's on an H100 while K4 kept within 2e-3 of the plain
        # recursion
        records.extend(_check_ctc(8, 1001, 1000, 48, role="seq2seq",
                                  lib_tol=1e-2))
        # the TIMIT distillation's second CTC: the teacher's collapsed
        # greedy path in a (B, T) buffer (2U+1 603: the block path), ~240
        # labels long for a young teacher
        records.extend(_check_ctc(8, 301, 42, 301, role="kd", live_u=240))
        # the Switchboard recipes' 2000 pieces (8 kHz audio, 10 ms hop)
        records.extend(_check_ctc(8, 251, 2000, 40, role="swbd"))
        # CommonVoice: the seq2seq step's characters (B 12 x 6 s, no time
        # pooling: T 601; 500 outputs; 80 characters, spaces included;
        # |log Z| ~4e3, as "seq2seq"'s library tolerance) and the
        # conformer's (T_enc 151, 4300 outputs, 60 characters)
        records.extend(_check_ctc(12, 601, 500, 80, role="commonvoice",
                                  lib_tol=1e-2))
        records.extend(_check_ctc(12, 151, 4300, 60, role="cv_conformer"))
        # Fisher-Callhome ST: the CTC of the Spanish transcripts over the
        # 500 English BPE pieces (B 8 x 10 s, T_enc 251, 48 pieces)
        records.extend(_check_ctc(8, 251, 500, 48, role="fisher"))
        # wav2vec + CTC: LibriSpeech's characters (B 6 x 10 s: T 498
        # latents at 50 Hz, 150 characters: 2U+1 301, the block path) and
        # AISHELL-1's 5000 outputs (B 8 x 6 s: T 298, 40 characters; |log
        # Z| ~2.5e3 there, past the 2e3 where 2e-3 was set: the logits'
        # gradient lay 2.72e-3 from F.ctc_loss's on an H100, so the
        # library tolerance of "seq2seq")
        records.extend(_check_ctc(6, 498, 29, 150, role="w2v_librispeech"))
        records.extend(_check_ctc(8, 298, 5000, 40, role="w2v_aishell",
                                  lib_tol=1e-2))
        # the CommonVoice wav2vec seq2seq step's CTC: B 12 x 6 s (T 298
        # latents), 80 characters of 500 outputs (|log Z| ~2e3, at the edge
        # where 2e-3 was set: the library tolerance of "seq2seq")
        records.extend(_check_ctc(12, 298, 500, 80, role="cv_wav2vec",
                                  lib_tol=1e-2))
    if want("transducer"):
        records.extend(_check_transducer(64))
        # the CRDNN-transducer's lattice: T_enc 1001 (no time pooling)
        records.extend(_check_transducer(64, role="crdnn", T=1001))
        records.extend(_check_transducer(256, role="wide"))
        # the CommonVoice transducer's characters: B 8 x 6 s (T 601, no
        # time pooling), V 40, 68-80 characters in a 96-label buffer
        records.extend(_check_transducer(96, role="commonvoice", T=601, B=8,
                                         V=40, max_u=80))
        # TIMIT's wav2vec transducer: B 8 x 3 s (T 148 latents), 28-40 of
        # the 39 phones, V 40
        records.extend(_check_transducer(40, role="timit_w2v", T=148, B=8,
                                         V=40, max_u=40))
        records.extend(_check_lattice_wide())
    for r in records:
        emit({"phase": "kernels", **r})
    return records


def _synthetic(B, samples, seed):
    """B utterances of white noise, relative lengths 1.0 down to 0.825."""
    import torch

    rng = np.random.default_rng(seed)
    sig = (0.1 * rng.standard_normal((B, samples))).astype(np.float32)
    lens = (1.0 - 0.025 * np.arange(B)).astype(np.float32)
    return torch.from_numpy(sig).cuda(), torch.from_numpy(lens).cuda()


def _search(asr, enc, lens, beam, ctc_weight, **options):
    """Run the beam search (``options`` go to ``make_searcher``); returns
    (hyps, scores, steps, seconds).  An LM's calls run inside a
    ``record_function`` range named "lm_forward", which ``_profile``
    reads."""
    import torch

    searcher = asr.make_searcher(beam, ctc_weight, **options)
    steps = [0]
    step = searcher.forward_step

    def counted(*args):
        steps[0] += 1
        return step(*args)

    searcher.forward_step = counted
    if searcher.lm_fn is not None:
        lm_fn = searcher.lm_fn

        def lm_in_range(prefix):
            with torch.profiler.record_function("lm_forward"):
                return lm_fn(prefix)

        searcher.lm_fn = lm_in_range
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = searcher.search_device(enc, lens)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    hyps, scores = searcher.finalize(*store)
    return hyps, scores, steps[0], seconds


def _profile(fn, ranges=(), cpu=True):
    """Run ``fn`` (which returns how many steps it ran) under
    torch.profiler: how much of the wall time the card is busy, how many
    kernels a step launches, the kernels that take the most device
    time, and the device time of the kernels launched inside each
    ``record_function`` range named in ``ranges`` (and its share of the
    busy time).  ``cpu=False`` traces the card alone (no ranges): the
    host's events of a long search take minutes to collect."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    # device kernels and copies; a record_function range is also drawn on
    # the device timeline ("gpu_user_annotation") and would count twice
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    per_name = {}
    for e in events:
        us, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    # the port's own kernels: device ms and share of the busy time
    port = {}
    for name, (us, n) in per_name.items():
        for fn in _PORT_KERNEL_FUNCTIONS:
            if fn in name:
                ms, count = port.get(fn, (0.0, 0))
                port[fn] = (ms + us / 1e3, count + n)
    in_ranges = {}
    for e in prof.events():
        if e.name in ranges and e.device_type == torch.autograd.DeviceType.CPU:
            # the range's kernels and those of the ops inside it
            in_ranges[e.name] = in_ranges.get(e.name, 0.0) + e.device_time_total
    return {
        "ranges": {name: {"device_ms": us / 1e3,
                          "busy_share": us / busy_us if busy_us else "not measured"}
                   for name, us in in_ranges.items()},
        "profiled_steps": steps,
        "profiled_wall_ms": 1e3 * seconds,
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / seconds if busy_us else "not measured",
        "device_kernels_per_step": len(events) / steps if busy_us else "not measured",
        "top_device_kernels_ms": [[name[:60], us / 1e3, n]
                                  for name, (us, n) in top],
        "port_kernels": {fn: {"ms": ms, "launches": count,
                              "busy_share": 1e3 * ms / busy_us}
                         for fn, (ms, count) in port.items()} if busy_us else {},
    }


# the __global__ functions of csrc/*.cu, as the profiler names them
_PORT_KERNEL_FUNCTIONS = (
    "depthwise_conv1d_fwd", "depthwise_conv1d_dw_kernel", "relpos_fwd_kernel", "relpos_bwd_kernel",
    "relpos_bwd_sum_kernel", "relpos_bwd_fold_kernel",
    "relpos_bwd_bias_kernel", "ctc_", "transducer_", "beam_attend_step")


def phase_serve():
    """conformer_small transcribes 8 x 10 s at beam 10, f32 then bf16."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASR

    B, beam, ctc_weight = 8, 10, 0.4
    n_dec = CONFORMER_SMALL["num_decoder_layers"]
    n_enc = CONFORMER_SMALL["num_encoder_layers"]
    sig, lens = _synthetic(B, 160000, SEED)
    runs = {}
    for dtype_name in ("float32", "bfloat16"):
        asr = ConformerASR(CONFORMER_SMALL, dtype=getattr(torch, dtype_name),
                           seed=SEED)
        # Untrained heads get a blank bias (CTC) and an eos bias (seq2seq),
        # as bench.py's decode section does, so the decode has a trained
        # model's shape: mostly-blank CTC posteriors and hypotheses that
        # end.  Without them every beam runs into the CTC's impossible
        # region (a prefix longer than the frames left), where all scores
        # tie at -1e20 and the pick among the ties is arbitrary.
        with torch.no_grad():
            asr.ctc_lin.bias[CONFORMER_SMALL["blank_index"]] += BLANK_BIAS
            asr.seq_lin.bias[CONFORMER_SMALL["eos_index"]] += EOS_BIAS
        # warm-up (untimed): library handles, kernel loads, first-call
        # allocations of every shape the search meets
        _search(asr, asr.encode(sig, lens), lens, beam, ctc_weight,
                ctc_score_mode="partial")
        ops.reset_launch_counters()
        t0 = time.perf_counter()
        enc = asr.encode(sig, lens)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        hyps, scores, steps, search_s = _search(asr, enc, lens, beam, ctc_weight,
                                                ctc_score_mode="partial")
        counts = ops.launch_counters()
        assert enc.shape == (B, 251, CONFORMER_SMALL["d_model"]), enc.shape
        assert bool(torch.isfinite(enc.float()).all()), "non-finite encoder output"
        assert np.isfinite(scores).all(), f"non-finite scores {scores}"
        assert len(hyps) == B
        assert counts["depthwise_conv1d"] == n_enc, counts
        assert counts["beam_attend_step"] == n_dec * steps, (counts, steps)
        assert counts["relpos_attention"] == 0, counts  # T_enc=251 < 512
        run = {
            "dtype": dtype_name, "batch": B, "seconds_audio": 10.0,
            "beam": beam, "ctc_weight": ctc_weight, "ctc_score_mode": "partial",
            "T_enc": enc.shape[1],
            "steps": steps, "launches": counts, "encode_ms": 1e3 * encode_s,
            "search_ms": 1e3 * search_s,
            "utt_per_s": B / (encode_s + search_s),
            "hyp_lens": [len(h) for h in hyps],
        }
        if dtype_name == "float32":
            # the same search through the plain PyTorch versions
            asr.set_kernels(False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc_p = asr.encode(sig, lens)
            torch.cuda.synchronize()
            plain_encode_s = time.perf_counter() - t0
            # the plain search starts from the kernel route's encoder
            # states, so that it holds the beam-cache kernel alone; the
            # two encoders are compared just below
            hyps_p, scores_p, steps_p, plain_search_s = _search(
                asr, enc, lens, beam, ctc_weight, ctc_score_mode="partial")
            asr.set_kernels(True)
            err = _err(enc, enc_p)
            # f32 on both routes; only summation order differs, 12 layers deep
            tol = 1e-3
            assert err <= tol, f"encoder kernel vs plain: {err} > {tol}"
            assert hyps == hyps_p, "hypotheses differ between kernels and plain"
            run.update({
                "enc_max_abs_err_vs_plain": err, "enc_tol": tol,
                "hyps_equal_plain": True,
                "score_max_abs_diff_vs_plain": float(np.abs(scores - scores_p).max()),
                "plain_encode_ms": 1e3 * plain_encode_s,
                "plain_search_ms": 1e3 * plain_search_s,
                "plain_utt_per_s": B / (plain_encode_s + plain_search_s),
            })
        # the card's events alone: no range is read, and the host's
        # events of a search take half a minute to collect; in f32 only
        # (see SHORTENED)
        if dtype_name == "float32":
            run["profile"] = _profile(
                lambda: _search(asr, enc, lens, beam, ctc_weight,
                                ctc_score_mode="partial")[2], cpu=False)
        emit({"phase": "serve", **run})
        runs[dtype_name] = run
        del asr
    return runs


# recipes/LibriSpeech/ASR/transformer/hparams/conformer_small.yaml:59-67
# and train.py:107-143: the searches of the conformer + TransformerLM
# config (BASELINE.json config 4): (name, batch, beam, dtypes)
SERVE_LM_SEARCHES = (("valid", 8, 10, ("float32", "bfloat16")),
                     ("test", 2, 66, ("float32",)))
# the profiled repeat's step cap (50 steps), which keeps the run inside its
# time limit: the host's events of a whole search took about a minute to
# collect; and the timed searches' (62 of the ~110-120 steps the random
# model's searches run)
SERVE_LM_PROFILE_RATIO, SERVE_LM_SEARCH_RATIO = 0.2, 0.25


def phase_serve_lm():
    """conformer_small with a TransformerLM (recipe dims, random weights)
    decodes as the recipe does: full CTC scoring at 0.4, the LM fused at
    0.6, no eos threshold, length normalization.  The validation search
    (B 8 x 10 s, beam 10) in f32 and bf16, the f32 one also through the
    plain versions from the same encoder states; the test search (B 2 x
    10 s, beam 66) in f32."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.asr import (
        CONFORMER_SMALL,
        TRANSFORMER_LM,
        ConformerASR,
        build_transformer_lm,
    )

    ctc_weight, lm_weight = 0.4, 0.6
    n_dec = CONFORMER_SMALL["num_decoder_layers"]
    n_enc = CONFORMER_SMALL["num_encoder_layers"]
    lm = build_transformer_lm(TRANSFORMER_LM, seed=SEED)
    options = {"lm": lm, "lm_weight": lm_weight, "ctc_score_mode": "full",
               "using_eos_threshold": False, "length_normalization": True}
    runs = {}
    for search, B, beam, dtype_names in SERVE_LM_SEARCHES:
        sig, lens = _synthetic(B, 160000, SEED)
        for dtype_name in dtype_names:
            asr = ConformerASR(CONFORMER_SMALL, dtype=getattr(torch, dtype_name),
                               seed=SEED)
            with torch.no_grad():  # as in phase_serve
                asr.ctc_lin.bias[CONFORMER_SMALL["blank_index"]] += BLANK_BIAS
                asr.seq_lin.bias[CONFORMER_SMALL["eos_index"]] += EOS_BIAS
            asr.config["max_decode_ratio"] = SERVE_LM_SEARCH_RATIO
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counters()
            t0 = time.perf_counter()
            enc = asr.encode(sig, lens)
            torch.cuda.synchronize()
            encode_s = time.perf_counter() - t0
            hyps, scores, steps, search_s = _search(asr, enc, lens, beam,
                                                    ctc_weight, **options)
            counts = ops.launch_counters()
            peak = torch.cuda.max_memory_allocated()
            assert enc.shape == (B, 251, CONFORMER_SMALL["d_model"]), enc.shape
            assert bool(torch.isfinite(enc.float()).all()), "non-finite encoder output"
            assert np.isfinite(scores).all(), f"non-finite scores {scores}"
            assert len(hyps) == B
            assert counts["depthwise_conv1d"] == n_enc, counts
            assert counts["beam_attend_step"] == n_dec * steps, (counts, steps)
            run = {
                "search": search, "dtype": dtype_name, "batch": B,
                "seconds_audio": 10.0, "beam": beam, "rows": B * beam,
                "ctc_weight": ctc_weight, "ctc_score_mode": "full",
                "lm_weight": lm_weight, "T_enc": enc.shape[1], "steps": steps,
                "launches": counts, "encode_ms": 1e3 * encode_s,
                "search_ms": 1e3 * search_s,
                "utt_per_s": B / (encode_s + search_s),
                "peak_memory_gib": peak / 2**30,
                "hyp_lens": [len(h) for h in hyps],
                "max_steps": int(251 * SERVE_LM_SEARCH_RATIO),
                "note": "first call of each shape: no warm-up run",
            }
            if dtype_name == "float32" and search == "valid":
                # the plain versions from the kernel route's encoder states
                asr.set_kernels(False)
                hyps_p, scores_p, _, plain_search_s = _search(
                    asr, enc, lens, beam, ctc_weight, **options)
                asr.set_kernels(True)
                assert hyps == hyps_p, "hypotheses differ between kernels and plain"
                run.update({
                    "hyps_equal_plain": True,
                    "score_max_abs_diff_vs_plain":
                        float(np.abs(scores - scores_p).max()),
                    "plain_search_ms": 1e3 * plain_search_s,
                })
            # the LM's range needs the host's events, about a minute to
            # collect a search: read it once, the others the card's alone;
            # the profiled repeat stops at SERVE_LM_PROFILE_RATIO x T_enc
            # steps (the whole search is timed above)
            lm_share = search == "valid" and dtype_name == "float32"
            if lm_share:  # the valid f32 search only: see SHORTENED
                asr.config["max_decode_ratio"] = SERVE_LM_PROFILE_RATIO
                run["profiled_max_steps"] = int(251 * SERVE_LM_PROFILE_RATIO)
                run["profile"] = _profile(
                    lambda: _search(asr, enc, lens, beam, ctc_weight,
                                    **options)[2],
                    ranges=("lm_forward",), cpu=True)
            emit({"phase": "serve_lm", **run})
            runs[f"{search}_{dtype_name}"] = run
            del asr, enc
            torch.cuda.empty_cache()
    return runs


# recipes/LibriSpeech/ASR/transducer/hparams/conformer_transducer.yaml:47-49
# (beam 4, state_beam and expand_beam 2.3: the config's defaults).  With
# random weights and the blank bias +4 (bench.py's), blank is the top
# token of every frame but holds ~2.5-7 % of the mass over vocab 1000, and
# the length-normalised beam emits ~2.5-3 tokens a frame (616-748 over
# 251 frames; +6 and more: none at all), so the device beam's token
# buffer holds 4 x T_enc, where JAX's default of 100 would cut them.
TRANSDUCER_BLANK_BIAS, DEVICE_BEAM_SYMBOLS = 4.0, 1024


def _timed(fn):
    """(fn's result, its seconds), the card synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _transducer_searches(model, enc, lens):
    """The three decodes of ``ConformerTransducer``: greedy (the loop over
    frames on the card), the recipe's beam 4 (host lockstep) and the
    device beam 4; each with its seconds, and the lockstep rounds (one
    joint call a round) and device iterations."""
    searcher = model.make_searcher()
    rounds = [0]
    joint = searcher.joint_fn

    def counted_joint(*args):
        rounds[0] += 1
        return joint(*args)

    searcher.joint_fn = counted_joint
    (hyps, scores), beam_s = _timed(lambda: searcher(enc, lens))
    searcher.joint_fn = joint
    iters = [0]
    step = searcher._beam_device_step

    def counted_step(*args):
        iters[0] += 1
        return step(*args)

    searcher._beam_device_step = counted_step
    (toks, tok_lens, dev_scores), device_s = _timed(
        lambda: searcher.transducer_beam_search_device(
            enc, lens, max_symbols=DEVICE_BEAM_SYMBOLS))
    greedy = model.make_searcher(beam_size=1)
    (g_hyps, g_scores), greedy_s = _timed(lambda: greedy(enc, lens))
    dev_hyps = [toks[b, :tok_lens[b]].tolist() for b in range(len(hyps))]
    return {"beam": (hyps, scores, beam_s, rounds[0],
                     searcher.forced_advance_count),
            "device": (dev_hyps, dev_scores.cpu().numpy(), device_s, iters[0],
                       int(tok_lens.max())),
            "greedy": (g_hyps, g_scores, greedy_s)}


def _device_beam_profile(searcher, enc, lens, warm=32, window=64):
    """The device beam's loop under the profiler, ``window`` iterations
    from the start of a search (after ``warm``): device kernels an
    iteration and the card's busy share (``_profile``'s "per step" is
    per iteration here).  A whole search is ~1300 iterations of ~230
    kernels, too many events to collect in the smoke run's time."""
    carry, cap = searcher._beam_device_init(enc, lens, DEVICE_BEAM_SYMBOLS)
    for _ in range(warm):
        carry = searcher._beam_device_step(carry, enc, cap)

    def steps():
        nonlocal carry
        for _ in range(window):
            carry = searcher._beam_device_step(carry, enc, cap)
        return window

    return _profile(steps, cpu=False)


def phase_serve_transducer():
    """The conformer-transducer (recipe dims, random weights from the
    seed, ``out_lin``'s blank bias +4 as bench.py's decode gives it)
    decodes B = 8 synthetic 10 s utterances in f32 then bf16: greedy, the
    recipe's beam 4 and the device beam 4.  The device beam must give the
    host beam's hypotheses and no frame may be force-advanced; the f32
    beam is repeated through the plain versions (encoder and search)
    with the same hypotheses."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.asr import CONFORMER_TRANSDUCER, ConformerTransducer

    B = 8
    n_enc = CONFORMER_TRANSDUCER["num_encoder_layers"]
    sig, lens = _synthetic(B, 160000, SEED)
    runs = {}
    for dtype_name in ("float32", "bfloat16"):
        model = ConformerTransducer(CONFORMER_TRANSDUCER,
                                    dtype=getattr(torch, dtype_name), seed=SEED)
        with torch.no_grad():
            model.out_lin.bias[CONFORMER_TRANSDUCER["blank_index"]] += (
                TRANSDUCER_BLANK_BIAS)
        model.encode(sig, lens)  # warm-up (untimed)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counters()
        enc, encode_s = _timed(lambda: model.encode(sig, lens))
        out = _transducer_searches(model, enc, lens)
        counts = ops.launch_counters()  # the searches launch no kernel
        peak = torch.cuda.max_memory_allocated()
        hyps, scores, beam_s, rounds, forced = out["beam"]
        dev_hyps, dev_scores, device_s, iters, longest = out["device"]
        g_hyps, g_scores, greedy_s = out["greedy"]
        assert enc.shape == (B, 251, CONFORMER_TRANSDUCER["joint_dim"]), enc.shape
        assert bool(torch.isfinite(enc.float()).all()), "non-finite encoder output"
        assert counts["depthwise_conv1d"] == n_enc, counts
        assert sum(counts.values()) == n_enc, counts
        assert np.isfinite(scores).all() and np.isfinite(g_scores).all()
        assert forced == 0, f"{forced} frames force-advanced"
        assert len(hyps) == B and sum(map(len, hyps)) > 0
        assert longest < DEVICE_BEAM_SYMBOLS, longest
        diff = [b for b in range(B) if dev_hyps[b] != hyps[b]]
        assert not diff, f"device beam vs host beam differ in rows {diff}"
        run = {
            "dtype": dtype_name, "batch": B, "seconds_audio": 10.0,
            "T_enc": enc.shape[1], "beam": 4, "state_beam": 2.3,
            "expand_beam": 2.3, "launches": counts, "encode_ms": 1e3 * encode_s,
            "greedy": {"search_ms": 1e3 * greedy_s,
                       "utt_per_s": B / (encode_s + greedy_s),
                       "hyp_lens": [len(h) for h in g_hyps]},
            "beam_host": {"search_ms": 1e3 * beam_s, "rounds": rounds,
                          "rounds_per_frame": rounds / enc.shape[1],
                          "ms_per_round": 1e3 * beam_s / rounds,
                          "utt_per_s": B / (encode_s + beam_s),
                          "forced_advance_count": forced,
                          "hyp_lens": [len(h) for h in hyps]},
            "beam_device": {"search_ms": 1e3 * device_s, "iterations": iters,
                            "max_symbols": DEVICE_BEAM_SYMBOLS,
                            "utt_per_s": B / (encode_s + device_s),
                            "hyps_equal_host": True,
                            "score_max_abs_diff_vs_host":
                                float(np.abs(dev_scores - scores).max())},
            "peak_memory_gib": peak / 2**30,
        }
        if dtype_name == "float32":
            # the same encode and beam through the plain versions
            model.set_kernels(False)
            enc_p, plain_encode_s = _timed(lambda: model.encode(sig, lens))
            searcher = model.make_searcher()
            (hyps_p, scores_p), plain_beam_s = _timed(
                lambda: searcher(enc_p, lens))
            model.set_kernels(True)
            err = _err(enc, enc_p)
            tol, score_tol = 1e-3, 1e-4  # f32, 12 layers: summation orders
            assert err <= tol, f"encoder kernel vs plain: {err} > {tol}"
            assert hyps == hyps_p, "hypotheses differ between kernels and plain"
            score_diff = float(np.abs(scores - scores_p).max())
            assert score_diff <= score_tol, f"scores: {score_diff} > {score_tol}"
            run.update({"enc_max_abs_err_vs_plain": err, "enc_tol": tol,
                        "hyps_equal_plain": True,
                        "score_max_abs_diff_vs_plain": score_diff,
                        "score_tol": score_tol,
                        "plain_encode_ms": 1e3 * plain_encode_s,
                        "plain_beam_ms": 1e3 * plain_beam_s})
        searcher = model.make_searcher()
        if dtype_name == "float32":  # profiled once: see SHORTENED
            run["profile"] = _profile(lambda: (searcher(enc, lens), 1)[1],
                                      cpu=False)
            run["beam_device"]["profile"] = _device_beam_profile(
                searcher, enc, lens)
        emit({"phase": "serve_transducer", **run})
        runs[dtype_name] = run
        del model, enc
        torch.cuda.empty_cache()
    return runs


def phase_long():
    """Encode an utterance long enough for T_enc = 512 (rel-pos kernel)."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASR

    B = 2
    samples = 160 * 2044  # 20.44 s -> 2045 frames -> 1023 -> 512
    sig, lens = _synthetic(B, samples, SEED + 1)
    lens = torch.tensor([1.0, 0.9], device="cuda")
    asr = ConformerASR(CONFORMER_SMALL, seed=SEED)
    with torch.no_grad():
        t_front = asr.frontend(asr.normalize(asr.fbank(sig), lens)).shape[1]
    asr.encode(sig, lens)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counters()
    t0 = time.perf_counter()
    enc = asr.encode(sig, lens)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    counts = ops.launch_counters()
    n_enc = CONFORMER_SMALL["num_encoder_layers"]
    assert t_front == 512 and enc.shape == (B, 512, CONFORMER_SMALL["d_model"]), (
        t_front, enc.shape)
    assert bool(torch.isfinite(enc).all()), "non-finite encoder output"
    assert counts["relpos_attention"] == n_enc, counts
    assert counts["depthwise_conv1d"] == n_enc, counts
    asr.set_kernels(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_p = asr.encode(sig, lens)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = _err(enc, enc_p)
    tol = 1e-3  # f32 on both routes, 12 layers deep
    assert err <= tol, f"long encode kernel vs plain: {err} > {tol}"
    run = {"phase": "long", "batch": B, "seconds_audio": samples / 16000,
           "T_enc": 512, "launches": counts, "encode_ms": 1e3 * encode_s,
           "plain_encode_ms": 1e3 * plain_s, "enc_max_abs_err_vs_plain": err,
           "enc_tol": tol}
    emit(run)
    return run


def _train_batch(B, samples, U, seed, V=None):
    """bench.py's synthetic training batch (``_synthetic_batch``): white
    noise, U random tokens per utterance (of V, by default
    CONFORMER_SMALL's) with bos 1 / eos 2, every length full."""
    from speechbrain_tpu_torch.asr import CONFORMER_SMALL

    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, V or CONFORMER_SMALL["vocab_size"], (B, U))
    ones = np.ones(B, np.float32)
    return {
        "sig": rng.normal(size=(B, samples)).astype(np.float32),
        "sig_lens": ones, "tokens": tokens, "tokens_lens": ones,
        "tokens_bos": np.concatenate([np.ones((B, 1), np.int64), tokens], 1),
        "tokens_eos": np.concatenate([tokens, np.full((B, 1), 2)], 1),
        "tokens_eos_lens": ones,
    }


def _brain(precision, dropout, augment=True, cfg=None):
    """``ConformerASRBrain(cfg)`` (a recipe's dict, by default
    CONFORMER_SMALL) at full width with the recipe's optimizer settings:
    AdamW (0.9, 0.98, 1e-9, decay 1e-4), clip 5, Noam (``lr_adam``, 25000
    warm-up), the first step at ``lr_adam``; with the recipe's SpecAugment
    unless ``augment`` is false."""
    from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASRBrain

    cfg = dict(cfg or CONFORMER_SMALL, transformer_dropout=dropout)
    if not augment:
        cfg["augmentation"] = None
    return ConformerASRBrain(
        cfg, seed=SEED, hparams={"lr": cfg["lr_adam"]},
        run_opts={"precision": precision, "loss_sync_interval": 10})


def _loss_and_grads(brain, batch):
    """One training forward and backward without an optimizer step; the
    normalization and BatchNorm statistics and the brain's generator (the
    SpecAugment and dropout draws) are put back afterwards, so that two
    calls start from the same state and draw the same values."""
    import torch

    from speechbrain_tpu_torch.core import Stage

    saved = {k: v.clone() for k, v in brain.modules.named_buffers()}
    rng = brain.generator.get_state()
    brain.modules.train()
    loss = brain._loss(batch, Stage.TRAIN)
    names, params = zip(*brain.modules.named_parameters())
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for k, v in brain.modules.named_buffers():
            v.copy_(saved[k])
    brain.generator.set_state(rng)
    return loss.detach(), dict(zip(names, grads))


def _grad_rel_errs(grads, ref, floor=1e-3):
    """Each gradient's max|grads - ref| over (max|ref| + ``floor`` G), G
    the largest entry of any ``ref`` gradient (see ``_compare_routes``)."""
    G = max(float(g.abs().max()) for g in ref.values())
    return {n: _err(grads[n], g) / (float(g.abs().max()) + floor * G)
            for n, g in ref.items()}


def _compare_routes(brain, batch, tol_loss, tol_grad, floor=1e-3):
    """The step's loss and every gradient through the kernels and
    through the plain versions, from the same weights and state.  A
    gradient's error is max|kernel - plain| over (max|plain| + ``floor``
    G), G the largest gradient entry of the model: tensors whose gradient
    is zero analytically (biases removed by a later BatchNorm or by the
    softmax) hold rounding noise only and are held to ``floor`` G.
    ``tol_grad`` None reports the gradients' error and holds the loss
    only."""
    import torch

    loss_k, grads_k = _loss_and_grads(brain.set_kernels(True), batch)
    loss_p, grads_p = _loss_and_grads(brain.set_kernels(False), batch)
    brain.set_kernels(True)
    torch.cuda.synchronize()
    errs = _grad_rel_errs(grads_k, grads_p, floor)
    worst = max(errs, key=errs.get)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    assert loss_err <= tol_loss, f"loss kernel vs plain: rel {loss_err} > {tol_loss}"
    assert tol_grad is None or errs[worst] <= tol_grad, (
        f"gradient kernel vs plain: {worst} {errs[worst]} > {tol_grad}")
    return {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel_err": loss_err, "loss_tol": tol_loss,
            "grad_max_rel_err": errs[worst], "grad_worst": worst,
            "grad_tol": tol_grad, "n_grads": len(errs)}


def _run_steps(brain, batch, steps):
    """``steps`` fit_batch calls on one staged batch; returns (ms per
    step, the losses as floats, peak bytes allocated)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        brain.step += 1
        losses.append(brain.fit_batch(batch))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    return ms, [float(x) for x in losses], torch.cuda.max_memory_allocated()


def _profile_step(brain, batch):
    """One more fit_batch under the profiler (see ``_profile``), with the
    device time of SpecAugment's "spec_augment" range."""
    def one_step():
        brain.step += 1
        brain.fit_batch(batch)
        return 1

    return _profile(one_step, ranges=("spec_augment",))


def _per_step(counts, steps):
    return {k: v / steps for k, v in counts.items()}


# kernel launches of one training step at T_enc 251 (below the rel-pos
# gate) and at T_enc 512 (dropout 0: the rel-pos kernels run)
_N_ENC = 12
TRAIN_LAUNCHES = {"depthwise_conv1d": 2 * _N_ENC, "depthwise_conv1d_dw": _N_ENC,
                  "ctc_alpha": 1, "ctc_beta_grad": 1, "relpos_attention": 0,
                  "relpos_attention_bwd": 0, "beam_attend_step": 0,
                  "transducer_alpha": 0, "transducer_beta_grad": 0}
TRAIN_LONG_LAUNCHES = dict(TRAIN_LAUNCHES, relpos_attention=_N_ENC,
                           relpos_attention_bwd=_N_ENC)


def phase_train():
    """The recipe's training step at full width: B = 32 synthetic 10 s
    utterances with 40 tokens, transformer_dropout 0.1, SpecAugment, 30
    steps in bf16 then f32 on one repeated batch; then kernel route vs
    plain route (f32, dropout 0, the same SpecAugment draws) and the
    dropout keep fraction."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.nnet.dropout import Dropout

    B, samples, U, steps = 32, 160000, 40, 30
    host_batch = _train_batch(B, samples, U, SEED)
    runs = {}
    for precision in ("bf16", "fp32"):
        brain = _brain(precision, 0.1)
        # staged on the card once, as bench.py stages its batches
        batch = brain.prepare_batch(host_batch)
        brain.step = 1
        first = float(brain.fit_batch(batch))  # warm-up, untimed
        ops.reset_launch_counters()
        ms, losses, peak = _run_steps(brain, batch, steps - 1)
        counts = ops.launch_counters()
        per_step = _per_step(counts, steps - 1)
        assert per_step == TRAIN_LAUNCHES, per_step
        assert all(np.isfinite([first] + losses)), losses
        assert losses[-1] < first, f"loss did not fall: {first} -> {losses[-1]}"
        run = {"phase": "train", "precision": precision, "batch": B,
               "seconds_audio": samples / 16000, "tokens": U,
               "transformer_dropout": 0.1, "steps": steps,
               "spec_augment": brain.config["augmentation"],
               "ms_per_step": ms, "utt_per_s": 1e3 * B / ms,
               "peak_mem_bytes": peak, "launches": counts,
               "launches_per_step": per_step,
               "loss_first": first, "loss_last": losses[-1]}
        if precision == "bf16":
            run["profile"] = _profile_step(brain, batch)
        emit(run)
        runs[precision] = run
        del brain, batch
    # kernel route vs plain route, f32 with dropout 0, the same weights;
    # the loss and the gradients reach the plain route through other
    # summation orders (depthwise taps, CTC recursion's exp/log1p, f32
    # throughout), 16 layers deep.  Gradients are held without
    # SpecAugment: with its mean-filled bands the largest error sits in
    # a decoder FFN's first layer, weight and bias, the relu's input
    # side, where a pre-activation near 0 can fall on either side in the
    # two routes' last bits (0.4-1.2 % of the tensor's largest entry over
    # the draws tried; 0.07 % without SpecAugment, 0.04 % with zero
    # fill).  With the recipe's SpecAugment (both routes drawing the
    # same masks) the loss is held and the gradients' error reported.
    brain = _brain("fp32", 0.0, augment=False)
    batch = brain.prepare_batch(host_batch)
    cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=1e-3)
    del brain
    brain = _brain("fp32", 0.0)
    cmp_aug = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=None)
    # dropout draws from the brain's generator on the card
    drop = Dropout(0.1).train()
    drop.generator = brain.generator
    kept = float((drop(torch.ones(1 << 22, device="cuda")) > 0).float().mean())
    assert abs(kept - 0.9) <= 0.01, f"dropout keep fraction {kept}"
    run = {"phase": "train_check", "kernel_vs_plain": cmp,
           "kernel_vs_plain_spec_augment": cmp_aug,
           "dropout_keep_fraction": kept}
    emit(run)
    runs["check"] = run
    del brain, batch
    torch.cuda.empty_cache()
    return runs


def phase_train_long():
    """The same step on B = 8 utterances of 20.44 s (T_enc 512) with
    transformer_dropout 0 and no SpecAugment (see ``phase_train``), where
    the rel-pos kernels run forward and backward: f32 then bf16; kernel
    vs plain gradients in f32 at the seeded weights, before the steps."""
    import torch

    from speechbrain_tpu_torch import ops

    B, samples, U, steps = 8, 160 * 2044, 40, 6
    host_batch = _train_batch(B, samples, U, SEED + 1)
    runs = {}
    for precision in ("fp32", "bf16"):
        brain = _brain(precision, 0.0, augment=False)
        batch = brain.prepare_batch(host_batch)
        check = None
        if precision == "fp32":
            # at the seeded weights: after AdamW steps the weights depend on
            # each route's last bits (Adam turns the rounding noise of
            # near-zero gradients into steps of the learning rate's size)
            check = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=1e-3)
        brain.step = 1
        first = float(brain.fit_batch(batch))  # warm-up, untimed
        ops.reset_launch_counters()
        ms, losses, peak = _run_steps(brain, batch, steps - 1)
        counts = ops.launch_counters()
        per_step = _per_step(counts, steps - 1)
        assert per_step == TRAIN_LONG_LAUNCHES, per_step
        assert all(np.isfinite([first] + losses)), losses
        run = {"phase": "train_long", "precision": precision, "batch": B,
               "seconds_audio": samples / 16000, "T_enc": 512, "tokens": U,
               "transformer_dropout": 0.0, "steps": steps,
               "ms_per_step": ms, "utt_per_s": 1e3 * B / ms,
               "peak_mem_bytes": peak, "launches": counts,
               "launches_per_step": per_step,
               "loss_first": first, "loss_last": losses[-1]}
        if precision == "fp32":
            run["profile"] = _profile_step(brain, batch)
            run["kernel_vs_plain"] = check
        emit(run)
        runs[precision] = run
        del brain, batch
    torch.cuda.empty_cache()
    return runs


TRANSDUCER_LAUNCHES = dict(TRAIN_LAUNCHES, ctc_alpha=0, ctc_beta_grad=0,
                           transducer_alpha=1, transducer_beta_grad=1)


def _transducer_batch(B, samples, U, seed):
    """B utterances of white noise (relative lengths 1.0 down to 0.725),
    up to 40 random tokens each (ids 1..999) padded with 0 to U, their
    relative counts, and tokens_blank = [blank] + tokens."""
    from speechbrain_tpu_torch.asr import CONFORMER_TRANSDUCER

    rng = np.random.default_rng(seed)
    n_tok = 40 - 3 * (np.arange(B) % 5)
    tokens = np.zeros((B, U), np.int64)
    for b, n in enumerate(n_tok):
        tokens[b, :n] = rng.integers(1, CONFORMER_TRANSDUCER["vocab_size"], n)
    return {
        "sig": rng.normal(size=(B, samples)).astype(np.float32),
        "sig_lens": (1.0 - 0.025 * np.arange(B)).astype(np.float32),
        "tokens": tokens, "tokens_lens": (n_tok / U).astype(np.float32),
        "tokens_blank": np.concatenate([np.zeros((B, 1), np.int64), tokens], 1),
    }


def _transducer_brain(precision, dropout):
    """``ConformerTransducerBrain(CONFORMER_TRANSDUCER)`` at full width
    with the recipe's AdamW (0.9, 0.98, 1e-9, decay 1e-4), clip 5 and
    Noam (8e-4, 25000 warm-up), the first step at 8e-4."""
    from speechbrain_tpu_torch.asr import (
        CONFORMER_TRANSDUCER, ConformerTransducerBrain)

    cfg = dict(CONFORMER_TRANSDUCER, transformer_dropout=dropout)
    return ConformerTransducerBrain(
        cfg, seed=SEED, hparams={"lr": cfg["lr_adam"]},
        run_opts={"precision": precision, "loss_sync_interval": 10})


def phase_train_transducer():
    """The transducer recipe's training step at full width: B = 12
    synthetic 10 s utterances (the yaml's 120 s max_batch_length), tokens
    padded to 64, dropout 0.1, SpecAugment, 30 steps in bf16 then f32;
    evaluate_batch; then kernel route vs plain route (f32, dropout 0, the
    same SpecAugment draws)."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.core import Stage

    B, samples, U, steps = 12, 160000, 64, 30
    host_batch = _transducer_batch(B, samples, U, SEED + 2)
    runs = {}
    for precision in ("bf16", "fp32"):
        brain = _transducer_brain(precision, 0.1)
        batch = brain.prepare_batch(host_batch)
        brain.step = 1
        first = float(brain.fit_batch(batch))  # warm-up, untimed
        ops.reset_launch_counters()
        ms, losses, peak = _run_steps(brain, batch, steps - 1)
        counts = ops.launch_counters()
        per_step = _per_step(counts, steps - 1)
        assert per_step == TRANSDUCER_LAUNCHES, per_step
        assert all(np.isfinite([first] + losses)), losses
        assert losses[-1] < first, f"loss did not fall: {first} -> {losses[-1]}"
        run = {"phase": "train_transducer", "precision": precision,
               "batch": B, "seconds_audio": samples / 16000, "tokens_padded": U,
               "tokens": host_batch["tokens_lens"].tolist(),
               "transformer_dropout": 0.1, "steps": steps,
               "spec_augment": brain.config["augmentation"],
               "ms_per_step": ms, "utt_per_s": 1e3 * B / ms,
               "peak_mem_bytes": peak, "launches": counts,
               "launches_per_step": per_step,
               "loss_first": first, "loss_last": losses[-1],
               "profile": _profile_step(brain, batch)}
        ops.reset_launch_counters()
        eval_loss = brain.evaluate_batch(batch, Stage.VALID)
        eval_counts = ops.launch_counters()
        assert eval_counts == dict(TRANSDUCER_LAUNCHES, depthwise_conv1d=12,
                                   depthwise_conv1d_dw=0,
                                   transducer_beta_grad=0), eval_counts
        assert np.isfinite(eval_loss)
        run.update({"eval_loss": eval_loss, "eval_launches": eval_counts})
        emit(run)
        runs[precision] = run
        del brain, batch
        torch.cuda.empty_cache()
    brain = _transducer_brain("fp32", 0.0)
    batch = brain.prepare_batch(host_batch)
    # f32 throughout; the routes differ in the depthwise taps' summation
    # order and the lattice's exp/log implementations, 12 layers deep
    cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=1e-3)
    run = {"phase": "train_transducer_check", "kernel_vs_plain": cmp}
    emit(run)
    runs["check"] = run
    del brain, batch
    torch.cuda.empty_cache()
    return runs


# the synthetic LibriSpeech tree of the recipe phase (utterances a split)
RECIPE_UTTERANCES = {"train-clean-100": 64, "dev-clean": 8, "test-clean": 2}
# the validation and test searches' cap, max_steps = int(T_enc x ratio):
# the random model never emits eos, so each would run T_enc steps
RECIPE_DECODE_RATIO = 0.25
# the kernels the recipe's path runs: K1/K2 and K3/K4 in every training
# step, K7 in every step of the validation and test searches
RECIPE_KERNELS = ("depthwise_conv1d", "depthwise_conv1d_dw", "ctc_alpha",
                  "ctc_beta_grad", "beam_attend_step")


def _snapshot(brain):
    """Copies of the Brain's module and optimizer state and counters."""
    import torch

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        return x

    snap = {"modules": clone(brain.modules.state_dict()),
            "optimizer": clone(brain.optimizer.state_dict()["state"]),
            "optimizer_step": brain.optimizer_step, "lr": brain.lr}
    if hasattr(brain, "noam"):
        snap["noam_n_steps"] = brain.noam.n_steps
    if hasattr(brain, "lr_annealing"):
        s = brain.lr_annealing
        if hasattr(s, "clr_iterations"):  # the cyclic schedule
            snap["cyclic"] = (s.clr_iterations, s.current_lr)
        elif hasattr(s, "n_warmup_steps"):  # Noam (the LM recipes)
            snap["noam"] = (s.n_steps, s.current_lr)
        else:  # NewBob
            snap["newbob"] = (s.hyperparam_value, list(s.metric_values),
                              s.current_patient)
    if hasattr(brain, "lr_scheduler"):  # ReduceLROnPlateau
        s = brain.lr_scheduler
        snap["plateau"] = (s.anchor, s.patience_counter, list(s.losses))
    return snap


def _same_state(a, b):
    """Bit-for-bit equality of two ``_snapshot``s."""
    import torch

    assert a["modules"].keys() == b["modules"].keys()
    for k, v in a["modules"].items():
        assert torch.equal(v, b["modules"][k]), f"module state {k}"
    assert a["optimizer"].keys() == b["optimizer"].keys()
    for i, st in a["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(v.cpu(), b["optimizer"][i][k].cpu()), (i, k)
    assert a.keys() == b.keys()
    for k in a.keys() - {"modules", "optimizer"}:
        assert a[k] == b[k], (k, a[k], b[k])
    return len(a["modules"]) + sum(map(len, a["optimizer"].values()))


def _instrument(brain, log):
    """Wrap the Brain's steps, stages and checkpoint saves to record, in
    ``log``: each training batch's signal shape and batch mask, the
    batches and optimizer steps of each epoch, the seconds and the loss
    of each stage (the card synchronised at its end), and each save's
    milliseconds."""
    import torch

    fit_batch, fit_train = brain.fit_batch, brain._fit_train
    evaluate_stage = brain._evaluate_stage
    save = brain.checkpointer.save_and_keep_only

    def on_fit_batch(batch):
        key = next(k for k in ("sig", "mix_sig", "tokens_bos") if k in batch)
        log["shapes"].add(tuple(batch[key].shape))
        log["masks"].append(batch["batch_mask"])
        log["batches"][-1] += 1
        return fit_batch(batch)

    def on_fit_train(train_set, epoch, progressbar):
        log["batches"].append(0)
        log["epochs"].append(epoch)
        steps0, wait0 = brain.optimizer_step, brain.staging_wait_seconds
        out, seconds = _timed(lambda: fit_train(train_set, epoch, progressbar))
        log["train_s"].append(seconds)
        log["steps"].append(brain.optimizer_step - steps0)
        log["staging_wait_s"].append(brain.staging_wait_seconds - wait0)
        return out

    def on_evaluate_stage(dataset, stage, epoch):
        out, seconds = _timed(lambda: evaluate_stage(dataset, stage, epoch))
        log[f"{stage.name.lower()}_s"].append(seconds)
        log[f"{stage.name.lower()}_loss"].append(out)
        return out

    def on_save(*args, **kwargs):
        t0 = time.perf_counter()
        save(*args, **kwargs)
        log["save_ms"].append(1e3 * (time.perf_counter() - t0))

    brain.fit_batch, brain._fit_train = on_fit_batch, on_fit_train
    brain._evaluate_stage = on_evaluate_stage
    brain.checkpointer.save_and_keep_only = on_save
    for key in ("masks", "batches", "epochs", "train_s", "steps",
                "staging_wait_s", "valid_s", "test_s", "valid_loss",
                "test_loss", "save_ms"):
        log.setdefault(key, [])
    log.setdefault("shapes", set())
    torch.cuda.reset_peak_memory_stats()


def _resume_in_fresh_brain(build, epochs):
    """A fresh Brain, loaders and counter from ``build(epochs + 1)`` (on a
    folder that holds ``epochs`` epochs' checkpoints) run epoch ``epochs +
    1`` alone; returns ``(parts, log, recovered)``: ``build``'s dict, the
    ``_instrument`` log, and ``{"state": the recovered ``_snapshot``,
    "epoch": the epoch counter after recovery, "seconds": the recovery's}``."""
    parts = build(epochs + 1)
    brain, log, recovered = parts["brain"], {}, {}
    _instrument(brain, log)
    fit_start = brain.on_fit_start

    def on_fit_start():
        _, recovered["seconds"] = _timed(fit_start)
        recovered["state"] = _snapshot(brain)
        recovered["epoch"] = parts["epoch_counter"].current

    brain.on_fit_start = on_fit_start
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    assert log["epochs"] == [epochs + 1], log["epochs"]
    return parts, log, recovered


def _recipe_ctc_dummy_rows(brain, parts):
    """K3/K4 on a recipe batch with a dummy row (3 utterances collated by
    the recipe's policy: the batch dim is padded to 4) against the plain
    recursions: per-sequence losses and gradients; the dummy row costs 0
    and gets no gradient on both routes."""
    import torch

    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.nnet.losses import ctc_loss

    loader = parts["train_loader"]
    batch = brain.prepare_batch(
        loader.collate_fn([loader.dataset[i] for i in range(3)]))
    mask = batch["batch_mask"]
    assert mask.tolist() == [1.0, 1.0, 1.0, 0.0], mask
    with torch.no_grad():
        brain.modules.eval()
        ctc_logp, _ = brain.compute_forward(batch, Stage.VALID)
    routes = {}
    for use_kernels in (True, False):
        lp = ctc_logp.detach().clone().requires_grad_()
        per = ctc_loss(lp, batch["tokens"], batch["sig_lens"] * mask,
                       batch["tokens_lens"] * mask, blank_index=0,
                       reduction="none", use_kernels=use_kernels)
        (grad,) = torch.autograd.grad(per.sum(), lp)
        routes[use_kernels] = (per.detach(), grad)
    (loss_k, grad_k), (loss_p, grad_p) = routes[True], routes[False]
    torch.testing.assert_close(loss_k, loss_p, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(grad_k, grad_p, atol=1e-5, rtol=1e-4)
    assert float(loss_k[3]) == 0.0 and bool((grad_k[3] == 0).all())
    return {"shape": list(ctc_logp.shape), "loss_kernel": loss_k.tolist(),
            "loss_max_abs_err": _err(loss_k, loss_p),
            "grad_max_abs_err": _err(grad_k, grad_p),
            "loss_tol": {"atol": 1e-4, "rtol": 1e-5},
            "grad_tol": {"atol": 1e-5, "rtol": 1e-4}}


def _recipe_staging_check(data, tmp, overrides):
    """Staging is only a schedule: with dropout 0 and no SpecAugment, two
    training steps with ``staging_depth`` 2 and two with 0 (fresh Brains
    from the same seed, the same loader order) give the same losses bit
    for bit."""
    from speechbrain_tpu_torch.recipes import librispeech_asr as recipe

    losses = {}
    for depth in (2, 0):
        parts = recipe.build(
            data, f"{tmp}/staging{depth}",
            dict(overrides, number_of_epochs=1, transformer_dropout=0.0,
                 augmentation=None),
            {"staging_depth": depth, "noprogressbar": True, "debug": True,
             "debug_batches": 2, "debug_epochs": 1, "loss_sync_interval": 1})
        brain, got = parts["brain"], []
        end = brain.on_fit_batch_end
        brain.on_fit_batch_end = lambda b, o, l, s: (got.append(l),
                                                     end(b, o, l, s))
        brain.fit(parts["epoch_counter"], parts["train_loader"])
        losses[depth] = got
        del parts, brain
    assert len(losses[2]) == 2 and losses[2] == losses[0], losses
    return {"staging_depth_2": losses[2], "staging_depth_0": losses[0]}


def phase_recipe():
    """The LibriSpeech conformer recipe end to end at full width
    (``recipes.librispeech_asr``: conformer_small, bf16, accumulation 2,
    dynamic batches of 200 s in 10 buckets, 4 loader threads, staging
    depth 2, dropout 0.1 and SpecAugment; validation at beam 10 with full
    CTC scoring at 0.4, no LM) from 16-bit WAV files on disk.  The heads
    keep their random weights (no ``phase_serve`` biases): the model
    never emits eos, so each search runs to its cap, a quarter of T_enc
    (``RECIPE_DECODE_RATIO``)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    try:
        return _recipe_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _recipe_run(tmp):
    import os

    import torch

    from speechbrain_tpu_torch import native, ops
    from speechbrain_tpu_torch.recipes import librispeech_asr as recipe
    from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece

    # the native library (tokenizer, FLAC), built into build/native/
    lib_path, native_s = _timed(native.build)
    assert lib_path.parent == native.BUILD_DIR and native.get_lib() is not None
    data, out = f"{tmp}/LibriSpeech", f"{tmp}/out"
    _, write_s = _timed(lambda: recipe.write_synthetic_librispeech(
        data, RECIPE_UTTERANCES, seed=SEED))
    splits = {"train_splits": ["train-clean-100"],
              "test_splits": ["test-clean"]}
    save = f"{out}/save"
    recipe.prepare_librispeech(data, save, tr_splits=splits["train_splits"],
                               te_splits=splits["test_splits"],
                               merge_lst=splits["train_splits"],
                               merge_name="train.json")
    vocab = recipe.HPARAMS["vocab_size"]
    tok, tok_s = _timed(lambda: SentencePiece(
        model_dir=save, vocab_size=vocab, annotation_train=f"{save}/train.json",
        annotation_read="words", model_type="unigram",
        annotation_format="json"))
    # trained by the native library, and its encoder is the native one
    assert tok.sp.train_route == "native", tok.sp.train_route
    assert tok.sp._native_encoder() is not None
    pieces = tok.sp.get_piece_size()
    assert 0 < pieces <= vocab and len(set(tok.sp.pieces)) == pieces

    # 1. fit, 1 epoch (the tokenizer and manifests above are loaded)
    opts = {"staging_depth": 2, "noprogressbar": True}
    ops.reset_launch_counters()
    splits["max_decode_ratio"] = RECIPE_DECODE_RATIO
    parts = recipe.build(data, out, dict(splits, number_of_epochs=1), opts)
    brain, log = parts["brain"], {}
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    peak_fit = torch.cuda.max_memory_allocated()
    saved = _snapshot(brain)
    valid_wer_2 = brain.stage_stats["VALID"]["WER"]
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    assert brain.config["vocab_size"] == vocab and brain.dtype == torch.bfloat16

    # 2. a fresh Brain, loaders and counter on the same folder: epoch 2
    parts2, log2, recovered = _resume_in_fresh_brain(
        lambda epochs: recipe.build(
            data, out, dict(splits, number_of_epochs=epochs), opts), 1)
    brain2 = parts2["brain"]
    assert recovered["epoch"] == 1
    n_equal = _same_state(saved, recovered["state"])
    valid_wer_3 = brain2.stage_stats["VALID"]["WER"]

    # 3. the test set at the recipe's test beam, from the best checkpoint
    brain2.config["valid_beam_size"] = parts2["hparams"]["test_beam_size"]
    test_loss, test_s = _timed(lambda: brain2.evaluate(
        parts2["test_loader"], min_key="WER"))
    counts = ops.launch_counters()  # the main path's launches, read here
    test_wer = brain2.stage_stats["TEST"]["WER"]
    best = min(c.meta["WER"] for c in brain2.checkpointer.list_checkpoints())
    assert brain2._recovered_ckpt.meta["WER"] == best
    for wer in (valid_wer_2, valid_wer_3, test_wer):
        assert np.isfinite(wer) and wer >= 0, wer
    assert np.isfinite(test_loss)
    assert all(counts[k] > 0 for k in RECIPE_KERNELS), counts
    peak = max(peak_fit, torch.cuda.max_memory_allocated())

    # checks outside the counted run
    ctc_check = _recipe_ctc_dummy_rows(brain2, parts2)
    del brain, brain2, parts, parts2
    torch.cuda.empty_cache()
    staging = _recipe_staging_check(data, tmp, splits)
    torch.cuda.empty_cache()

    steps1, batches1 = log["steps"][0], log["batches"][0]
    train_s = sum(log["train_s"])
    real = sum(int(m.sum()) for m in log["masks"])
    n_valid = RECIPE_UTTERANCES["dev-clean"]
    run = {
        "phase": "recipe", "utterances": RECIPE_UTTERANCES,
        "train_audio_s": sum(d["duration"] for d in json.load(
            open(f"{save}/train.json")).values()),
        "native_library": {"path": os.path.relpath(lib_path), "route": "native",
                           "build_s": native_s},
        "write_wavs_s": write_s,
        "tokenizer": {"route": tok.sp.train_route, "train_s": tok_s,
                      "vocab_size": vocab, "pieces": pieces},
        "precision": "bf16", "grad_accumulation_factor": 2,
        "max_decode_ratio": RECIPE_DECODE_RATIO,
        "batches_per_epoch": batches1, "steps_per_epoch": steps1,
        "batch_shapes": sorted(log["shapes"]),
        "train_s_per_epoch": log["train_s"] + log2["train_s"],
        "train_ms_per_batch": 1e3 * train_s / sum(log["batches"]),
        "train_ms_per_step": 1e3 * train_s / sum(log["steps"]),
        "train_utt_per_s": real / train_s,
        "staging_wait_s_per_batch": sum(log["staging_wait_s"])
        / sum(log["batches"]),
        "valid_s": log["valid_s"] + log2["valid_s"],
        "valid_utt_per_s": n_valid / np.mean(log["valid_s"] + log2["valid_s"]),
        "test_s": test_s,
        "test_utt_per_s": RECIPE_UTTERANCES["test-clean"] / test_s,
        "fit_first_epoch_s": fit_s,
        "valid_wer": [valid_wer_2, valid_wer_3], "test_wer": test_wer,
        "test_loss": test_loss,
        "checkpoint_bytes": ckpt_bytes, "save_ms": log["save_ms"],
        "resume_ms": 1e3 * recovered["seconds"],
        "resume_equal_tensors": n_equal,
        "peak_mem_bytes": peak, "launches": counts,
        "ctc_dummy_rows_kernel_vs_plain": ctc_check,
        "staging_only_a_schedule": staging,
    }
    emit(run)
    return run


# kernel launches of one CRDNN-transducer training step: the RNN-T
# lattice only (the CRDNN has no depthwise conv)
CRDNN_LAUNCHES = dict(TRAIN_LAUNCHES, depthwise_conv1d=0, depthwise_conv1d_dw=0,
                      ctc_alpha=0, ctc_beta_grad=0, transducer_alpha=1,
                      transducer_beta_grad=1)


def _crdnn_brain(precision, dropout):
    """``CRDNNTransducerBrain(CRDNN_TRANSDUCER)`` at full width (the
    transducer recipe's ``train.yaml``: CNN 64/128, LiGRU 4 x 512
    bidirectional, DNN 2 x 512, joint 320, vocab 1000) with the recipe's
    AdamW, clip 5 and Noam, the first step at 8e-4."""
    from speechbrain_tpu_torch.asr import CRDNN_TRANSDUCER, CRDNNTransducerBrain

    cfg = dict(CRDNN_TRANSDUCER, dropout=dropout)
    return CRDNNTransducerBrain(
        cfg, seed=SEED, hparams={"lr": cfg["lr_adam"]},
        run_opts={"precision": precision, "loss_sync_interval": 10})


def _pytorch_calls(fn):
    """The PyTorch calls of ``fn()``: the aten ops dispatched, counted by
    a ``TorchDispatchMode`` (the autograd engine's threads inherit it, so
    a backward's count too)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.calls


def _ligru_calls(rnn, x):
    """One forward and backward of the LiGRU ``rnn`` in training mode on
    ``x`` (the CRDNN's LiGRU input of a step): its PyTorch calls
    (``_pytorch_calls``: the backward's included), its device kernels (the profiler, the card's events only) and card ms.  The
    running statistics are put back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    saved = {k: v.clone() for k, v in rnn.named_buffers()}

    def step():
        y, _ = rnn(x)
        (gx,) = torch.autograd.grad(y.float().sum(), x)
        return gx

    step()  # warm-up
    ms = _time_ms(step, iters=2, warmup=0)
    calls = _pytorch_calls(step)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    with torch.no_grad():
        for k, v in rnn.named_buffers():
            v.copy_(saved[k])
    T = x.shape[1]
    return {"input_shape": list(x.shape), "dtype": str(x.dtype),
            "layers": rnn.num_layers, "frames": T, "fwd_bwd_ms": ms,
            "pytorch_calls": calls, "device_kernels": kernels,
            "pytorch_calls_per_frame_layer": calls / (T * rnn.num_layers),
            "device_kernels_per_frame_layer": kernels / (T * rnn.num_layers)}


def phase_train_crdnn_transducer():
    """The transducer recipe's ``train.yaml`` training step at full width:
    ``CRDNNTransducerBrain`` on B = 12 synthetic 10 s utterances (T_enc
    1001: the CRDNN pools no time), tokens padded to 64, dropout 0.15,
    SpecAugment, 4 AdamW steps in bf16 then f32: ms/step, utt/s, peak
    memory, the busy share of one profiled step (the card's events
    only), the launches a step (RNN-T alpha 1 and beta 1), and finite
    losses that fall (the LiGRU's own calls are counted in
    ``recipe_commonvoice``'s transducer step); then one f32 step
    (dropout 0) through the kernels against the plain versions: the loss
    and every gradient (K8/K9 at B12 x T1001 x U+1 65)."""
    import torch

    from speechbrain_tpu_torch import ops

    B, samples, U, steps = 12, 160000, 64, 4
    host_batch = _transducer_batch(B, samples, U, SEED + 3)
    runs = {}
    for precision in ("bf16", "fp32"):
        brain = _crdnn_brain(precision, 0.15)
        batch = brain.prepare_batch(host_batch)
        brain.step = 1
        first = float(brain.fit_batch(batch))  # warm-up, untimed
        ops.reset_launch_counters()
        ms, losses, peak = _run_steps(brain, batch, steps - 1)
        counts = ops.launch_counters()
        per_step = _per_step(counts, steps - 1)
        assert per_step == CRDNN_LAUNCHES, per_step
        assert all(np.isfinite([first] + losses)), losses
        assert losses[-1] < first, f"loss did not fall: {first} -> {losses[-1]}"

        def one_step():
            brain.step += 1
            brain.fit_batch(batch)
            return 1

        brain.modules.train()
        run = {"phase": "train_crdnn_transducer", "precision": precision,
               "batch": B, "seconds_audio": samples / 16000, "T_enc": 1001,
               "tokens_padded": U, "tokens": host_batch["tokens_lens"].tolist(),
               "dropout": 0.15, "steps": steps,
               "spec_augment": brain.config["augmentation"],
               "ms_per_step": ms, "utt_per_s": 1e3 * B / ms,
               "peak_mem_bytes": peak, "launches": counts,
               "launches_per_step": per_step,
               "loss_first": first, "loss_last": losses[-1]}
        if precision == "bf16":  # profiled once: see SHORTENED
            run["profile"] = _profile(one_step, cpu=False)
        emit(run)
        runs[precision] = run
        del brain, batch
        torch.cuda.empty_cache()
    brain = _crdnn_brain("fp32", 0.0)
    batch = brain.prepare_batch(host_batch)
    # f32 throughout; the routes differ in the lattice's exp/log only
    cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=1e-3)
    run = {"phase": "train_crdnn_transducer_check", "kernel_vs_plain": cmp,
           "lattice": [B, 1001, U + 1]}
    emit(run)
    runs["check"] = run
    del brain, batch
    torch.cuda.empty_cache()
    return runs


# the synthetic LibriSpeech tree of the transducer recipe phase
RECIPE_T_UTTERANCES = {"train-clean-100": 32, "dev-clean": 4, "test-clean": 2}
RECIPE_T_SECONDS = (4.0, 10.0)
RECIPE_T_KERNELS = {"conformer": ("depthwise_conv1d", "depthwise_conv1d_dw",
                                  "transducer_alpha", "transducer_beta_grad"),
                    "crdnn": ("transducer_alpha", "transducer_beta_grad")}


def phase_recipe_transducer():
    """The LibriSpeech transducer recipe end to end
    (``recipes.librispeech_transducer``) with both hparams files, at full
    width in bf16, from 16-bit WAV files on disk (32 train, 4 dev and 2
    test utterances of 4-10 s): the BPE tokenizer at vocab 1000 by the
    native library, dynamic batches of 120 s in 8 buckets, 4 loader
    threads, staging depth 2, the yamls' dropout and SpecAugment, the
    random models' blank logit biased +4.  ``conformer_transducer.yaml``:
    ``fit`` for 1 epoch; a fresh Brain, loaders and counter on the same
    folder run epoch 2 alone, with the recovered state equal to the
    saved one bit for bit; ``evaluate(min_key="loss")`` at beam 4.
    ``train.yaml`` (the CRDNN): ``fit`` for 1 epoch, then the same test
    search."""
    import shutil
    import tempfile

    from speechbrain_tpu_torch.recipes import librispeech_transducer as recipe

    tmp = tempfile.mkdtemp(prefix="chip_smoke_transducer_")
    try:
        data = f"{tmp}/LibriSpeech"
        _, write_s = _timed(lambda: recipe.write_synthetic_librispeech(
            data, RECIPE_T_UTTERANCES, seconds=RECIPE_T_SECONDS, seed=SEED))
        return {name: _recipe_transducer_fit(data, f"{tmp}/{name}", name,
                                             hparams, epochs, write_s)
                for name, hparams, epochs in (
                    ("conformer", recipe.HPARAMS, 1),
                    ("crdnn", recipe.HPARAMS_CRDNN, 1))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _recipe_transducer_fit(data, out, name, hparams, epochs, write_s):
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import librispeech_transducer as recipe

    opts = {"staging_depth": 2, "noprogressbar": True}
    # the main path: build (manifests, tokenizer), fit, resume, test
    ops.reset_launch_counters()
    parts, build_s = _timed(lambda: recipe.build(
        data, out, {"number_of_epochs": epochs}, opts, hparams=hparams))
    brain, log = parts["brain"], {}
    tok = brain.tokenizer
    assert tok.sp.train_route == "native", tok.sp.train_route
    pieces = tok.sp.get_piece_size()
    assert 0 < pieces <= hparams["vocab_size"], pieces
    assert brain.dtype == torch.bfloat16
    with torch.no_grad():
        # the random model's blank logit +4, as in serve_transducer: the
        # recipe's beam 4 then takes ~4 rounds a frame
        brain.model.out_lin.bias[hparams["blank_index"]] += TRANSDUCER_BLANK_BIAS
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    peak_fit = torch.cuda.max_memory_allocated()
    saved = _snapshot(brain)
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    resume, log2 = None, {}
    test_brain, test_parts = brain, parts
    if name == "conformer":
        # a fresh Brain, loaders and counter on the same folder: epoch 2
        parts2, log2, recovered = _resume_in_fresh_brain(
            lambda e: recipe.build(data, out, {"number_of_epochs": e}, opts,
                                   hparams=hparams), epochs)
        brain2 = parts2["brain"]
        assert recovered["epoch"] == epochs
        resume = {"resume_ms": 1e3 * recovered["seconds"],
                  "resume_equal_tensors": _same_state(saved,
                                                      recovered["state"])}
        test_brain, test_parts = brain2, parts2
    test_loss, test_s = _timed(lambda: test_brain.evaluate(
        test_parts["test_loader"], min_key="loss"))
    counts = ops.launch_counters()  # the main path's launches, read here
    test_wer = test_brain.stage_stats["TEST"]["WER"]
    best = min(c.meta["loss"] for c in test_brain.checkpointer.list_checkpoints())
    assert test_brain._recovered_ckpt.meta["loss"] == best
    valid_losses = [float(x) for x in log["valid_loss"] + log2.get("valid_loss", [])]
    assert np.isfinite(test_wer) and test_wer >= 0, test_wer
    assert np.isfinite(test_loss) and all(np.isfinite(valid_losses))
    assert all(counts[k] > 0 for k in RECIPE_T_KERNELS[name]), counts
    if name == "crdnn":
        assert counts["depthwise_conv1d"] == 0, counts
    train_s = sum(log["train_s"])
    real = sum(int(m.sum()) for m in log["masks"])
    save = parts["hparams"]["save_folder"]
    run = {
        "phase": "recipe_transducer", "hparams": name,
        "utterances": RECIPE_T_UTTERANCES, "seconds": RECIPE_T_SECONDS,
        "train_audio_s": sum(d["duration"] for d in json.load(
            open(f"{save}/train-clean-100.json")).values()),
        "write_wavs_s": write_s, "build_s": build_s,
        "tokenizer": {"route": tok.sp.train_route, "type": "bpe",
                      "vocab_size": hparams["vocab_size"], "pieces": pieces},
        "precision": "bf16", "epochs": log["epochs"] + log2.get("epochs", []),
        "blank_bias": TRANSDUCER_BLANK_BIAS,
        "batches_per_epoch": log["batches"][0], "steps_per_epoch": log["steps"][0],
        "batch_shapes": sorted(log["shapes"]),
        "train_s_per_epoch": log["train_s"] + log2.get("train_s", []),
        "train_ms_per_batch": 1e3 * train_s / sum(log["batches"]),
        "train_utt_per_s": real / train_s,
        "staging_wait_s_per_batch": sum(log["staging_wait_s"])
        / sum(log["batches"]),
        "valid_s": log["valid_s"] + log2.get("valid_s", []),
        "valid_loss": valid_losses,
        "test_s": test_s,
        "test_utt_per_s": RECIPE_T_UTTERANCES["test-clean"] / test_s,
        "test_loss": test_loss, "test_wer": test_wer,
        "forced_advance_count": test_brain.searcher.forced_advance_count,
        "fit_s": fit_s, "checkpoint_bytes": ckpt_bytes,
        "save_ms": log["save_ms"] + log2.get("save_ms", []),
        "peak_mem_bytes": max(peak_fit, torch.cuda.max_memory_allocated()),
        "launches": counts,
    }
    if resume is not None:
        run.update(resume)
    emit(run)
    del brain, parts, test_brain, test_parts
    torch.cuda.empty_cache()
    return run


# kernel launches of one TIMIT CRDNN-CTC step: the CTC lattice only
TIMIT_LAUNCHES = dict(TRAIN_LAUNCHES, depthwise_conv1d=0, depthwise_conv1d_dw=0)


def _timit_batch(B, samples, U, seed):
    """B synthetic utterances of white noise (every length full) with up
    to ``U`` phone ids in 1..39 each (at least U / 2), padded to U."""
    rng = np.random.default_rng(seed)
    n = rng.integers(U // 2, U + 1, B)
    phn = rng.integers(1, 40, (B, U))
    phn[np.arange(U)[None, :] >= n[:, None]] = 0
    return {"sig": rng.normal(size=(B, samples)).astype(np.float32),
            "sig_lens": np.ones(B, np.float32), "phn_encoded": phn,
            "phn_encoded_lens": (n / U).astype(np.float32)}


def _timit_brain(dropout):
    """``timit_ctc.CTCBrain`` at the yaml's widths (120 features, CNN
    128/256, LiGRU 4 x 512 bidirectional, DNN 2 x 512, 40 outputs) with
    its Adadelta (rho 0.95, eps 1e-8) at lr 1.0 after the clip to 5."""
    from speechbrain_tpu_torch.recipes.timit_ctc import CTCBrain

    return CTCBrain({"dropout": dropout},
                    run_opts={"seed": SEED, "loss_sync_interval": 10})


def phase_recipe_timit():
    """The TIMIT CRDNN + CTC recipe (``recipes.timit_ctc``, config 2 of
    ``BASELINE.json``) at full width in f32.  First its training step:
    ``CTCBrain`` takes 4 Adadelta steps at lr 1.0 on B = 8 synthetic 3 s
    utterances (T 301: no time pooling) with 20-40 phones each (dropout
    0.15): ms/step, utt/s, peak memory, the busy share of one profiled
    step, the launches a step (CTC alpha 1 and beta 1, nothing else) and
    the LiGRU's PyTorch calls and device kernels for one forward and
    backward; then one step (dropout 0) through K3/K4 against the plain
    recursions, with a dummy row (batch mask 0: no frame, no label).
    Then the recipe end to end on a synthetic TIMIT tree (SPHERE files of
    1.5-6 s, 32 train, 8 dev, 8 test utterances, phones from all 61 and
    an SA sentence a speaker, which must be skipped): 1 epoch; a fresh
    Brain, loaders and counter on the same folder run epoch 2 alone, with
    the recovered modules, Adadelta accumulators, NewBob state, lr and
    epoch equal to the saved ones bit for bit; ``evaluate(min_key=
    "PER")``."""
    import shutil
    import tempfile

    import torch

    from speechbrain_tpu_torch import ops

    B, samples, U, steps = 8, 48000, 40, 4
    host_batch = _timit_batch(B, samples, U, SEED + 5)
    brain = _timit_brain(0.15)
    assert brain.modules.normalize.mean.shape == (120,)
    n_params = sum(p.numel() for p in brain.modules.parameters())
    batch = brain.prepare_batch(host_batch)
    brain.step = 1
    first = float(brain.fit_batch(batch))  # warm-up, untimed
    assert _rnn_weights_flat(brain.modules)
    ops.reset_launch_counters()
    ms, losses, peak = _run_steps(brain, batch, steps - 1)
    counts = ops.launch_counters()
    per_step = _per_step(counts, steps - 1)
    assert per_step == TIMIT_LAUNCHES, per_step
    assert all(np.isfinite([first] + losses)), losses

    def one_step():
        brain.step += 1
        brain.fit_batch(batch)
        return 1

    rnn = brain.modules.model.rnn
    x = torch.randn(B, 301, rnn.layers[0].wx.in_features, device="cuda",
                    requires_grad=True)
    brain.modules.train()
    step_run = {"phase": "recipe_timit_step", "precision": "fp32", "batch": B,
                "seconds_audio": samples / 16000, "T_enc": 301,
                "phones": (host_batch["phn_encoded_lens"] * U).round().tolist(),
                "parameters": n_params, "dropout": 0.15, "steps": steps,
                "lr": brain.lr, "ms_per_step": ms, "utt_per_s": 1e3 * B / ms,
                "peak_mem_bytes": peak, "launches": counts,
                "launches_per_step": per_step, "loss_first": first,
                "loss_last": losses[-1],
                "profile": _profile(one_step, cpu=False),
                "ligru": _ligru_calls(rnn, x)}
    emit(step_run)
    del brain, batch, x
    torch.cuda.empty_cache()
    brain = _timit_brain(0.0)
    host_batch["batch_mask"] = np.ones(B, np.float32)
    host_batch["batch_mask"][-1] = 0.0  # a dummy row: no frame, no label
    batch = brain.prepare_batch(host_batch)
    cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=1e-3)
    check = {"phase": "recipe_timit_check", "kernel_vs_plain": cmp,
             "lattice": [B, 301, 2 * U + 1], "dummy_rows": 1}
    emit(check)
    del brain, batch
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_timit_")
    try:
        recipe_run = _recipe_timit_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"step": step_run, "check": check, "recipe": recipe_run}


RECIPE_TIMIT_UTTERANCES = {"train": 32, "dev": 8, "test": 8}
RECIPE_TIMIT_SECONDS = (1.5, 6.0)


def _recipe_timit_run(tmp):
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import timit_ctc as recipe

    data, out = f"{tmp}/TIMIT", f"{tmp}/out"
    _, write_s = _timed(lambda: recipe.write_synthetic_timit(
        data, RECIPE_TIMIT_UTTERANCES, seconds=RECIPE_TIMIT_SECONDS,
        seed=SEED))
    opts = {"staging_depth": 2, "noprogressbar": True}

    def build(epochs):
        return recipe.build(data, out, {"number_of_epochs": epochs}, opts)

    # the main path: build (manifests, labels), fit, resume, test
    ops.reset_launch_counters()
    parts, build_s = _timed(lambda: build(1))
    brain, log = parts["brain"], {}
    n_labels = len(parts["label_encoder"])
    assert n_labels == recipe.HPARAMS["output_neurons"] == 40, n_labels
    manifests = {s: json.load(open(parts["hparams"][f"{s}_json"]))
                 for s in ("train", "valid", "test")}
    assert [len(m) for m in manifests.values()] == [
        RECIPE_TIMIT_UTTERANCES[s] for s in ("train", "dev", "test")]
    assert not any(k.endswith("_sa1") for m in manifests.values() for k in m)
    _instrument(brain, log)
    lrs = []  # the rate NewBob sets at each validation
    stage_end = brain.on_stage_end

    def on_stage_end(stage, stage_loss, epoch=None):
        stage_end(stage, stage_loss, epoch)
        if stage.name == "VALID":
            lrs.append(brain.lr)

    brain.on_stage_end = on_stage_end
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    peak_fit = torch.cuda.max_memory_allocated()
    saved = _snapshot(brain)
    valid_per = [brain.stage_stats["VALID"]["PER"]]
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    parts2, log2, recovered = _resume_in_fresh_brain(build, 1)
    brain2 = parts2["brain"]
    assert recovered["epoch"] == 1
    n_equal = _same_state(saved, recovered["state"])
    valid_per.append(brain2.stage_stats["VALID"]["PER"])
    lrs.append(brain2.lr)
    test_loss, test_s = _timed(lambda: brain2.evaluate(
        parts2["test_loader"], min_key="PER"))
    counts = ops.launch_counters()  # the main path's launches, read here
    test_per = brain2.stage_stats["TEST"]["PER"]
    best = min(c.meta["PER"] for c in brain2.checkpointer.list_checkpoints())
    assert brain2._recovered_ckpt.meta["PER"] == best
    for per in valid_per + [test_per]:
        assert np.isfinite(per) and per >= 0, per
    assert np.isfinite(test_loss)
    assert counts["ctc_alpha"] > 0 and counts["ctc_beta_grad"] > 0, counts
    assert all(v == 0 for k, v in counts.items()
               if k not in ("ctc_alpha", "ctc_beta_grad")), counts
    train_s = sum(log["train_s"])
    run = {
        "phase": "recipe_timit", "utterances": RECIPE_TIMIT_UTTERANCES,
        "seconds": RECIPE_TIMIT_SECONDS,
        "train_audio_s": sum(d["duration"]
                             for d in manifests["train"].values()),
        "write_sphere_s": write_s, "build_s": build_s, "labels": n_labels,
        "precision": "fp32", "epochs": log["epochs"] + log2["epochs"],
        "batches_per_epoch": log["batches"][0],
        "batch_shapes": sorted(log["shapes"]),
        "train_s_per_epoch": log["train_s"] + log2["train_s"],
        "train_ms_per_batch": 1e3 * train_s / sum(log["batches"]),
        "train_utt_per_s": RECIPE_TIMIT_UTTERANCES["train"]
        * len(log["batches"]) / train_s,
        "valid_s": log["valid_s"] + log2["valid_s"], "valid_per": valid_per,
        "lr_per_epoch": lrs, "test_s": test_s, "test_per": test_per,
        "test_loss": test_loss, "fit_first_epoch_s": fit_s,
        "checkpoint_bytes": ckpt_bytes,
        "save_ms": log["save_ms"] + log2["save_ms"],
        "resume_ms": 1e3 * recovered["seconds"],
        "resume_equal_tensors": n_equal,
        "peak_mem_bytes": max(peak_fit, torch.cuda.max_memory_allocated()),
        "launches": counts,
    }
    emit(run)
    del brain, brain2, parts, parts2
    torch.cuda.empty_cache()
    return run


# no TPU kernel runs in the x-vector recipe
GSC_LAUNCHES = {k: 0 for k in TRAIN_LAUNCHES}


def _gsc_batch(B, samples, seed):
    rng = np.random.default_rng(seed)
    return {"sig": rng.normal(size=(B, samples)).astype(np.float32),
            "sig_lens": rng.uniform(0.6, 1.0, B).astype(np.float32),
            "command_id": rng.integers(0, 11, B)}


def phase_recipe_gsc():
    """The Google Speech Commands x-vector recipe
    (``recipes.gsc_xvector``, config 1 of ``BASELINE.json``) at full
    width in f32.  First its training step: ``SpeakerBrain`` (Xvector:
    TDNN 512 x 4 + 1500, lin 512; Classifier of 12) takes 4 Adam steps at
    1e-3 on B = 32 synthetic 1 s clips with ``TimeDomainSpecAugment``
    (speeds 95/100/105, frequency and chunk drops): ms/step, utt/s, peak
    memory, the busy share of one profiled step, the launches (none) and
    the device ms of the "time_domain_augment" range.  Then the recipe
    end to end on a synthetic tree (the 10 commands and 2 unknown words,
    clips of 0.6-1.0 s; 96 train, 32 valid, 32 test): 1 epoch, epoch 2
    in a fresh Brain with the recovered state equal bit for bit, then
    ``evaluate(max_key="acc")``."""
    import shutil
    import tempfile

    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes.gsc_xvector import SpeakerBrain

    B, samples, steps = 32, 16000, 4
    host_batch = _gsc_batch(B, samples, SEED + 7)
    brain = SpeakerBrain(run_opts={"seed": SEED, "loss_sync_interval": 10})
    n_params = sum(p.numel() for p in brain.modules.parameters())
    batch = brain.prepare_batch(host_batch)
    brain.step = 1
    first = float(brain.fit_batch(batch))  # warm-up, untimed
    assert _rnn_weights_flat(brain.modules)
    ops.reset_launch_counters()
    ms, losses, peak = _run_steps(brain, batch, steps - 1)
    counts = ops.launch_counters()
    assert _per_step(counts, steps - 1) == GSC_LAUNCHES, counts
    assert all(np.isfinite([first] + losses)), losses

    def one_step():
        brain.step += 1
        brain.fit_batch(batch)
        return 1

    # the augmentation makes no synchronising call: the sync debug mode
    # raises on one
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        brain.augment(batch["sig"], batch["sig_lens"], brain.generator)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_run = {"phase": "recipe_gsc_step", "precision": "fp32", "batch": B,
                "seconds_audio": samples / 16000, "parameters": n_params,
                "augmentation": brain.hparams.augmentation, "steps": steps,
                "augment_sync_free": True,
                "ms_per_step": ms, "utt_per_s": 1e3 * B / ms,
                "peak_mem_bytes": peak, "launches": counts,
                "loss_first": first, "loss_last": losses[-1],
                "profile": _profile(one_step,
                                    ranges=("time_domain_augment",))}
    emit(step_run)
    del brain, batch
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gsc_")
    try:
        recipe_run = _recipe_gsc_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"step": step_run, "recipe": recipe_run}


RECIPE_GSC_CLIPS = {"train": 96, "valid": 32, "test": 32}


def _recipe_gsc_run(tmp):
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import gsc_xvector as recipe

    data, out = f"{tmp}/GSC", f"{tmp}/out"
    _, write_s = _timed(lambda: recipe.write_synthetic_gsc(
        data, RECIPE_GSC_CLIPS, seed=SEED))
    opts = {"staging_depth": 2, "noprogressbar": True}

    def build(epochs):
        return recipe.build(data, out, {"number_of_epochs": epochs}, opts)

    ops.reset_launch_counters()
    parts = build(1)
    brain, log = parts["brain"], {}
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    peak_fit = torch.cuda.max_memory_allocated()
    saved = _snapshot(brain)
    valid_acc = [brain.stage_stats["VALID"]["acc"]]
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    parts2, log2, recovered = _resume_in_fresh_brain(build, 1)
    brain2 = parts2["brain"]
    assert recovered["epoch"] == 1
    n_equal = _same_state(saved, recovered["state"])
    valid_acc.append(brain2.stage_stats["VALID"]["acc"])
    test_loss, test_s = _timed(lambda: brain2.evaluate(
        parts2["test_loader"], max_key="acc"))
    counts = ops.launch_counters()
    test_acc = brain2.stage_stats["TEST"]["acc"]
    best = max(c.meta["acc"] for c in brain2.checkpointer.list_checkpoints())
    assert brain2._recovered_ckpt.meta["acc"] == best
    for acc in valid_acc + [test_acc]:
        assert 0.0 <= acc <= 1.0, acc
    assert np.isfinite(test_loss)
    assert all(v == 0 for v in counts.values()), counts
    train_s = sum(log["train_s"])
    run = {
        "phase": "recipe_gsc", "clips": RECIPE_GSC_CLIPS, "write_wavs_s": write_s,
        "precision": "fp32", "epochs": log["epochs"] + log2["epochs"],
        "batches_per_epoch": log["batches"][0],
        "batch_shapes": sorted(log["shapes"]),
        "train_s_per_epoch": log["train_s"] + log2["train_s"],
        "train_ms_per_batch": 1e3 * train_s / sum(log["batches"]),
        "train_utt_per_s": RECIPE_GSC_CLIPS["train"] * len(log["batches"])
        / train_s,
        "valid_s": log["valid_s"] + log2["valid_s"], "valid_acc": valid_acc,
        "test_s": test_s, "test_acc": test_acc, "test_loss": test_loss,
        "fit_first_epoch_s": fit_s, "checkpoint_bytes": ckpt_bytes,
        "save_ms": log["save_ms"] + log2["save_ms"],
        "resume_ms": 1e3 * recovered["seconds"],
        "resume_equal_tensors": n_equal,
        "peak_mem_bytes": max(peak_fit, torch.cuda.max_memory_allocated()),
        "launches": counts,
    }
    emit(run)
    del brain, brain2, parts, parts2
    torch.cuda.empty_cache()
    return run


# no TPU kernel runs in the VoxCeleb recipes either
VOX_LAUNCHES = {k: 0 for k in TRAIN_LAUNCHES}
# the synthetic VoxCeleb tree: more training clips (16 x 43) than the
# x-vector's 512 dimensions, so that the PLDA's total covariance is
# full rank
RECIPE_VOX = dict(speakers=16, clips=48, seconds=(2.0, 5.0),
                  trials_per_speaker=8)


def _vox_batch(B, samples, classes, seed):
    rng = np.random.default_rng(seed)
    return {"sig": (0.1 * rng.normal(size=(B, samples))).astype(np.float32),
            "sig_lens": rng.uniform(0.6, 1.0, B).astype(np.float32),
            "spk_id_encoded": rng.integers(0, classes, B)}


def _model_flops(brain, batch):
    """Multiply-adds x 2 of one forward of ECAPA and its cosine head on
    ``batch``'s features (every ``Conv1d`` and the head's product, from
    the shapes that reach them), and 3x that for a training step (the
    forward and the backward's two products); the elementwise work is
    left out."""
    import torch

    from speechbrain_tpu_torch.lobes.models.ECAPA_TDNN import Classifier
    from speechbrain_tpu_torch.nnet.CNN import Conv1d

    flops = [0]

    def conv(mod, args, out):
        k = mod.weight.shape[1] * mod.weight.shape[2]
        flops[0] += 2 * out.numel() * k

    def head(mod, args, out):
        flops[0] += 2 * out.numel() * mod.weight.shape[0]

    hooks = []
    for m in brain.modules.modules():
        if isinstance(m, Conv1d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, Classifier):
            hooks.append(m.register_forward_hook(head))
    saved = {k: v.clone() for k, v in brain.modules.named_buffers()}
    try:
        with torch.no_grad():
            brain.modules.eval()
            brain.compute_forward(batch, None)
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for k, v in brain.modules.named_buffers():
                v.copy_(saved[k])
    return flops[0], 3 * flops[0]


def phase_recipe_voxceleb():
    """The VoxCeleb speaker recipes (``recipes.voxceleb_speaker``, config
    3 of ``BASELINE.json``) at the yamls' widths in f32.  First the ECAPA
    step: ``SpeakerBrain`` (ECAPA-TDNN 1024 x 4 + 3072, attention 128,
    192-d embedding; the AAM head of 7205 classes; 80 mels;
    ``TimeDomainSpecAugment`` at speeds 95/100/105) takes 4 timed Adam
    steps after a warm-up on B = 32 synthetic 3 s clips (T 301): ms/step,
    utt/s, peak memory, the model's GFLOP a step and its f32 bound, the
    busy share of one profiled step, the device ms of its
    "time_domain_augment" range, the PyTorch calls and device kernels a
    step, the launches (none); the augmentation, ``Fbank`` and the
    sentence normalization run once more under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync).  Then
    the recipes end to end on a synthetic VoxCeleb tree
    (``wav/idXXXXX/<video>/<nnnnn>.wav``, ``RECIPE_VOX``: clips of
    2-5 s, so that some are cropped to 3 s, and a ``veri_test2.txt`` of
    positive and negative trials): ECAPA for 1 epoch, epoch 2 in a
    fresh Brain with the modules, Adam's state, the cyclic schedule, the
    rate and the generator recovered bit for bit, the best checkpoint's
    modules written by ``save_for_pretrained``, cosine verification;
    then the x-vector yaml (``run``, 2 epochs) and PLDA verification.
    EER and minDCF must be finite and in [0, 1]."""
    import shutil
    import tempfile

    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes.voxceleb_speaker import SpeakerBrain

    B, samples, steps = 32, 48000, 4
    brain = SpeakerBrain(run_opts={"seed": SEED, "loss_sync_interval": 10})
    classes = brain.hparams.out_neurons
    params = {name: sum(p.numel() for p in brain.modules[name].parameters())
              for name in ("embedding_model", "classifier")}
    batch = brain.prepare_batch(_vox_batch(B, samples, classes, SEED + 9))
    brain.step = 1
    first = float(brain.fit_batch(batch))  # warm-up, untimed
    assert _rnn_weights_flat(brain.modules)
    ops.reset_launch_counters()
    ms, losses, peak = _run_steps(brain, batch, steps)
    counts = ops.launch_counters()
    assert _per_step(counts, steps) == VOX_LAUNCHES, counts
    assert all(np.isfinite([first] + losses)), losses

    def one_step():
        brain.step += 1
        brain.fit_batch(batch)
        return 1

    calls = _pytorch_calls(one_step)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wavs, lens = brain.augment(batch["sig"], batch["sig_lens"],
                                   brain.generator)
        feats = brain.normalize(brain.modules.compute_features(wavs), lens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert feats.shape == (B, 301, 80), feats.shape
    fwd_flops, step_flops = _model_flops(brain, batch)
    profile = _profile(one_step, ranges=("time_domain_augment",))
    step_run = {"phase": "recipe_voxceleb_step", "precision": "fp32",
                "batch": B, "seconds_audio": samples / 16000, "T": 301,
                "classes": classes, "parameters": params,
                "augmentation": brain.hparams.augmentation, "steps": steps,
                "augment_normalize_sync_free": True,
                "ms_per_step": ms, "utt_per_s": 1e3 * B / ms,
                "peak_mem_bytes": peak, "forward_gflop": fwd_flops / 1e9,
                "step_gflop": step_flops / 1e9,
                "f32_bound_ms": 1e3 * step_flops / PEAK_FLOPS["float32"],
                "pytorch_calls_per_step": calls, "launches": counts,
                "lr_first_steps": [brain.hparams.lr, brain.lr],
                "loss_first": first, "loss_last": losses[-1],
                "profile": profile}
    emit(step_run)
    del brain, batch, wavs, feats
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vox_")
    try:
        recipe_run = _recipe_vox_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"step": step_run, "recipe": recipe_run}


def _recipe_vox_run(tmp):
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.pretrained.training import save_for_pretrained
    from speechbrain_tpu_torch.recipes import voxceleb_speaker as recipe

    data, out = f"{tmp}/VoxCeleb", f"{tmp}/ecapa"
    _, write_s = _timed(lambda: recipe.write_synthetic_voxceleb(
        data, seed=SEED, **RECIPE_VOX))
    opts = {"staging_depth": 2, "noprogressbar": True}

    at_recovery = {}

    def build(epochs):
        parts = recipe.build(data, out, {"number_of_epochs": epochs}, opts)
        b = parts["brain"]
        fit_start = b.on_fit_start

        def on_fit_start():  # the generator as the recovery left it
            fit_start()
            at_recovery["generator"] = b.generator.get_state()

        b.on_fit_start = on_fit_start
        return parts

    ops.reset_launch_counters()
    parts = build(1)
    brain, log = parts["brain"], {}
    manifests = {s: json.load(open(parts["hparams"][f"{s}_json"]))
                 for s in ("train", "valid")}
    durations = [v["duration"] for v in manifests["train"].values()]
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    peak_fit = torch.cuda.max_memory_allocated()
    saved = _snapshot(brain)
    saved_generator = brain.generator.get_state()
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    parts2, log2, recovered = _resume_in_fresh_brain(build, 1)
    brain2 = parts2["brain"]
    assert recovered["epoch"] == 1
    n_equal = _same_state(saved, recovered["state"])
    assert torch.equal(at_recovery["generator"], saved_generator)
    assert brain2.lr_annealing.clr_iterations == (
        saved["cyclic"][0] + log2["steps"][0])
    assert brain2.hparams.crop.epoch == 2
    # what ``run`` does after ``fit``
    _, save_pre_s = _timed(lambda: (
        brain2.checkpointer.recover_if_possible(min_key="loss"),
        save_for_pretrained(brain2, f"{out}/pretrained",
                            module_names=["embedding_model", "classifier"])))
    cosine, cosine_s = _timed(lambda: recipe.verify_cosine(
        data, f"{tmp}/cosine", {"pretrain_path": f"{out}/pretrained"}))
    xvector, xvector_s = _timed(lambda: recipe.run(
        data, f"{tmp}/xvector", {"number_of_epochs": 2}, opts,
        hparams=recipe.HPARAMS_XVECTOR))
    n_train = len(manifests["train"])
    rank_f = min(100, n_train)
    plda, plda_total_s = _timed(lambda: recipe.verify_plda(
        data, f"{tmp}/plda", {"pretrain_path": f"{tmp}/xvector/pretrained",
                              "rank_f": rank_f}))
    counts = ops.launch_counters()  # the main path's launches, read here
    assert all(v == 0 for v in counts.values()), counts
    for res in (cosine, plda):
        assert all(np.isfinite(res["scores"])), res["line"]
        assert 0.0 <= res["eer"] <= 1.0 and 0.0 <= res["min_dcf"] <= 1.0
    valid_losses = log["valid_loss"] + log2["valid_loss"]
    assert all(np.isfinite(valid_losses)), valid_losses
    assert np.isfinite(xvector.stage_stats["VALID"]["loss"])
    train_s = sum(log["train_s"])
    run = {
        "phase": "recipe_voxceleb", "tree": RECIPE_VOX, "write_wavs_s": write_s,
        "clips": {s: len(m) for s, m in manifests.items()},
        "cropped_train_clips": sum(d > 3.0 for d in durations),
        "trials": len(cosine["scores"]), "precision": "fp32",
        "epochs": log["epochs"] + log2["epochs"],
        "batches_per_epoch": log["batches"][0],
        "train_s_per_epoch": log["train_s"] + log2["train_s"],
        "train_ms_per_batch": 1e3 * train_s / sum(log["batches"]),
        "train_utt_per_s": n_train * len(log["batches"]) / train_s,
        "staging_wait_s": log["staging_wait_s"] + log2["staging_wait_s"],
        "valid_s": log["valid_s"] + log2["valid_s"],
        "valid_loss": valid_losses, "lr_after_epochs": brain2.lr,
        "fit_first_epoch_s": fit_s, "checkpoint_bytes": ckpt_bytes,
        "save_ms": log["save_ms"] + log2["save_ms"],
        "resume_ms": 1e3 * recovered["seconds"],
        "resume_equal_tensors": n_equal, "cyclic_at_resume": saved["cyclic"],
        "save_for_pretrained_s": save_pre_s,
        "cosine": {"eer": cosine["eer"], "min_dcf": cosine["min_dcf"],
                   "embed_s": cosine["embed_s"], "score_s": cosine["score_s"],
                   "total_s": cosine_s},
        "xvector": {"run_2_epochs_s": xvector_s,
                    "valid_loss": xvector.stage_stats["VALID"]["loss"]},
        "plda": {"eer": plda["eer"], "min_dcf": plda["min_dcf"],
                 "rank_f": rank_f, "train_embeddings": n_train,
                 "embed_s": plda["embed_s"], "plda_s": plda["plda_s"],
                 "score_s": plda["score_s"], "total_s": plda_total_s},
        "peak_mem_bytes": max(peak_fit, torch.cuda.max_memory_allocated()),
        "launches": counts,
    }
    emit(run)
    del brain, brain2, parts, parts2, xvector
    torch.cuda.empty_cache()
    return run

SEP_CONFORMER_LAUNCHES = dict({k: 0 for k in TRAIN_LAUNCHES},
                              depthwise_conv1d=32, depthwise_conv1d_dw=16)
# the synthetic WSJ0-2mix tree: mixtures a split, and their seconds
RECIPE_SEP = {"tr": 24, "cv": 6, "tt": 6}
RECIPE_SEP_SECONDS = (2.0, 5.0)


def _sep_batch(B, samples, seed, sources=2, stereo=False):
    """B mixtures of ``sources`` sources (noise under random envelopes);
    with ``stereo`` each source also reaches a right ear, 0.7 times it
    and 3 samples later: (B, samples, 2) signals."""
    rng = np.random.default_rng(seed)
    env = np.repeat(rng.uniform(0.1, 1.0, (sources, B, samples // 800 + 1)),
                    800, axis=-1)[..., :samples]
    s = (0.1 * env * rng.standard_normal((sources, B, samples))).astype(
        np.float32)
    if stereo:
        s = np.stack([s, 0.7 * np.roll(s, 3, axis=-1)], -1)
    return {"mix_sig": s.sum(0),
            **{f"s{i + 1}_sig": s[i] for i in range(sources)}}


# gate products of a recurrence's frame and direction: 2 G H (in + H)
_RNN_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _sep_flops(brain, batch, info=None):
    """Floating-point operations of one training forward: the products and
    convolutions PyTorch dispatches (``FlopCounterMode``), plus the
    conformer blocks' depthwise convolutions, which run in the port's
    kernels (2 B T C K each), and the recurrences' gate products (2 G H
    (in + H) a frame and direction, G 4 for an LSTM) where
    ``FlopCounterMode`` counted no recurrent op (it has no formula for
    cuDNN's ``_cudnn_rnn``); and 3x that for a training step (the forward
    and the backward's two products; ``FlopCounterMode`` counts a grouped
    convolution's weight gradient as a dense one).  The elementwise work
    is left out.  Returns (forward, step); ``info`` (a dict) gets the
    recurrences' forward FLOPs and whether ``FlopCounterMode`` counted
    them."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
        ConvolutionModule)

    depthwise, recurrent = [0], [0]

    def conv_module(mod, args, out):
        depthwise[0] += 2 * out.numel() * mod.depthwise_kernel.shape[0]

    def rnn_module(mod, args, out):
        x = args[0]  # (N, T, in): batch_first
        H, D = mod.hidden_size, 2 if mod.bidirectional else 1
        recurrent[0] += (2 * _RNN_GATES[mod.mode] * H * (mod.input_size + H)
                         * x.shape[0] * x.shape[1] * D)

    modules = list(brain.modules.modules())
    hooks = ([m.register_forward_hook(conv_module) for m in modules
              if isinstance(m, ConvolutionModule)]
             + [m.register_forward_hook(rnn_module) for m in modules
                if isinstance(m, torch.nn.RNNBase)])
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            brain.modules.train()
            brain._loss(batch, Stage.TRAIN)
    finally:
        for h in hooks:
            h.remove()
    counted = any("rnn" in str(op) or "lstm" in str(op)
                  for op in counter.get_flop_counts().get("Global", {}))
    forward = (counter.get_total_flops() + depthwise[0]
               + (0 if counted else recurrent[0]))
    if info is not None:
        info.update(recurrent_forward_gflop=recurrent[0] / 1e9,
                    flop_counter_counts_recurrences=counted)
    return forward, 3 * forward


def _rnn_weights_flat(module):
    """Whether every ``torch.nn`` recurrence in ``module`` holds its
    weights (and the zero ``bias_hh`` buffers) as views of one buffer, as
    cuDNN wants them: otherwise each call copies them (PyTorch warns "RNN
    module weights are not part of single contiguous chunk of memory")."""
    import torch

    return all(len({w.untyped_storage().data_ptr() for w in m._flat_weights})
               == 1 for m in module.modules()
               if isinstance(m, torch.nn.RNNBase))


def _sep_step(name, hparams, B, samples, steps, launches, seed,
              phase="recipe_separation_step", brain_class=None, batch=None):
    """One yaml's training step: a ``Separation`` Brain (or
    ``brain_class``) at its widths takes a warm-up and ``steps`` timed
    Adam steps on ``B`` synthetic mixtures (or ``batch``); its launches a
    step must be ``launches``, and its recurrences' weights one buffer
    each.  Returns the record (phase ``phase``) and the Brain."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.recipes.wsj0mix_separation import Separation

    brain = (brain_class or Separation)(
        hparams, run_opts={"seed": SEED, "loss_sync_interval": 10})
    n_params = sum(p.numel() for p in brain.modules.parameters())
    batch = brain.prepare_batch(batch or _sep_batch(B, samples, seed))
    brain.step = 1
    first = float(brain.fit_batch(batch))  # warm-up, untimed
    assert _rnn_weights_flat(brain.modules)
    ops.reset_launch_counters()
    ms, losses, peak = _run_steps(brain, batch, steps)
    counts = ops.launch_counters()
    assert _per_step(counts, steps) == launches, counts
    assert all(np.isfinite([first] + losses)), losses

    def one_step():
        brain.step += 1
        brain.fit_batch(batch)
        return 1

    calls = _pytorch_calls(one_step)
    # the forward, the PIT loss and the backward make no host sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        brain._loss(batch, Stage.TRAIN).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    brain.optimizer.zero_grad(set_to_none=True)
    info = {}
    fwd_flops, step_flops = _sep_flops(brain, batch, info)
    bound = 1e3 * step_flops / PEAK_FLOPS["float32"]
    run = {"phase": phase, "hparams": name,
           "precision": "fp32", "batch": B, "seconds_audio": samples / 8000,
           "parameters": n_params, "steps": steps, "ms_per_step": ms,
           "mixtures_per_s": 1e3 * B / ms, "peak_mem_bytes": peak,
           "peak_gib": peak / 2 ** 30,
           "forward_gflop": fwd_flops / 1e9, "step_gflop": step_flops / 1e9,
           "f32_bound_ms": bound, "bound_share": bound / ms,
           "pytorch_calls_per_step": calls, "step_sync_free": True,
           "launches": counts, "loss_first": first, "loss_last": losses[-1],
           "profile": _profile(one_step, cpu=False)}
    if info["recurrent_forward_gflop"]:
        run.update(info)
    emit(run)
    return run, brain


def phase_recipe_separation():
    """The WSJ0-2mix separation recipe (``recipes.wsj0mix_separation``)
    at the yamls' widths in f32: the SepFormer step at B 1 and B 4 x 4 s,
    the conformer-intra step (K1/K2 launches counted and held to the
    plain versions), the Conv-TasNet step, then the recipes on a
    synthetic tree (see the module docstring, phase 16)."""
    import shutil
    import tempfile

    import torch

    from speechbrain_tpu_torch.recipes import wsj0mix_separation as recipe

    samples, none = 32000, {k: 0 for k in TRAIN_LAUNCHES}
    sep1, brain = _sep_step("sepformer", recipe.HPARAMS_SEPFORMER, 1, samples,
                            4, none, SEED + 11)
    del brain
    torch.cuda.empty_cache()
    sep4, brain = _sep_step("sepformer", recipe.HPARAMS_SEPFORMER, 4, samples,
                            3, none, SEED + 12)
    del brain
    torch.cuda.empty_cache()
    conformer, brain = _sep_step(
        "sepformer-conformerintra", recipe.HPARAMS_SEPFORMER_CONFORMERINTRA,
        1, samples, 3, SEP_CONFORMER_LAUNCHES, SEED + 13)
    batch = brain.prepare_batch(_sep_batch(1, samples, SEED + 14))
    # 1e-2 on the gradients: the inter blocks' ReLU FFNs switch units near
    # their kink on a last-bit difference of their input (the first
    # weights' gradients differed by 1.7e-3 of their scale on an H100)
    check = {"phase": "recipe_separation_check",
             "kernel_vs_plain": _compare_routes(brain, batch, tol_loss=1e-5,
                                                tol_grad=1e-2),
             "depthwise_shape": [34, 250, 256, 31]}
    emit(check)
    del brain, batch
    torch.cuda.empty_cache()
    tasnet, brain = _sep_step("convtasnet", recipe.HPARAMS_CONVTASNET, 1,
                              samples, 4, none, SEED + 15)
    del brain
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sep_")
    try:
        recipe_run = _recipe_sep_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"sepformer_b1": sep1, "sepformer_b4": sep4,
            "conformer": conformer, "check": check, "convtasnet": tasnet,
            "recipe": recipe_run}


def _recipe_sep_run(tmp):
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import wsj0mix_separation as recipe

    data, out = f"{tmp}/wsj", f"{tmp}/sepformer"
    _, write_s = _timed(lambda: recipe.write_synthetic_wsj0mix(
        data, RECIPE_SEP, RECIPE_SEP_SECONDS, seed=SEED))
    opts = {"staging_depth": 2, "noprogressbar": True}
    at_recovery = {}

    def build(epochs):
        parts = recipe.build(data, out, {"number_of_epochs": epochs}, opts)
        b = parts["brain"]
        fit_start = b.on_fit_start

        def on_fit_start():  # the generator as the recovery left it
            fit_start()
            at_recovery["generator"] = b.generator.get_state()

        b.on_fit_start = on_fit_start
        return parts

    ops.reset_launch_counters()
    parts = build(1)
    brain, log = parts["brain"], {}
    durations = [v["duration"] for v in json.load(
        open(parts["hparams"]["train_data"])).values()]
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    peak_fit = torch.cuda.max_memory_allocated()
    saved = _snapshot(brain)
    saved_generator = brain.generator.get_state()
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    parts2, log2, recovered = _resume_in_fresh_brain(build, 1)
    brain2 = parts2["brain"]
    assert recovered["epoch"] == 1
    n_equal = _same_state(saved, recovered["state"])
    assert torch.equal(at_recovery["generator"], saved_generator)
    assert brain2.hparams.crop.epoch == 2
    assert len(brain2.lr_scheduler.losses) == 2
    test_loss, test_s = _timed(lambda: brain2.evaluate(
        parts2["test_loader"], min_key="si-snr"))
    tasnet, tasnet_s = _timed(lambda: recipe.run(
        data, f"{tmp}/convtasnet", {"number_of_epochs": 1}, opts,
        hparams=recipe.HPARAMS_CONVTASNET))
    counts = ops.launch_counters()  # the main path's launches, read here
    assert all(v == 0 for v in counts.values()), counts
    valid_losses = log["valid_loss"] + log2["valid_loss"]
    assert all(np.isfinite(valid_losses + [test_loss])), valid_losses
    assert np.isfinite(tasnet.stage_stats["TEST"]["si-snr"])
    train_s = sum(log["train_s"])
    run = {
        "phase": "recipe_separation", "tree": RECIPE_SEP,
        "seconds": RECIPE_SEP_SECONDS, "write_wavs_s": write_s,
        "cropped_train_mixtures": sum(d > 4.0 for d in durations),
        "precision": "fp32", "epochs": log["epochs"] + log2["epochs"],
        "batches_per_epoch": log["batches"][0],
        "train_s_per_epoch": log["train_s"] + log2["train_s"],
        "train_ms_per_batch": 1e3 * train_s / sum(log["batches"]),
        "train_mixtures_per_s": RECIPE_SEP["tr"] * len(log["batches"])
        / train_s,
        "staging_wait_s": log["staging_wait_s"] + log2["staging_wait_s"],
        "valid_s": log["valid_s"] + log2["valid_s"],
        "valid_si_snr_db": [-v for v in valid_losses],
        "lr_after_epochs": brain2.lr, "plateau_at_resume": saved["plateau"],
        "fit_first_epoch_s": fit_s, "checkpoint_bytes": ckpt_bytes,
        "save_ms": log["save_ms"] + log2["save_ms"],
        "resume_ms": 1e3 * recovered["seconds"],
        "resume_equal_tensors": n_equal, "test_s": test_s,
        "test_si_snr_db": -test_loss,
        "convtasnet": {"run_1_epoch_s": tasnet_s,
                       "valid_si_snr_db": -tasnet.stage_stats["VALID"]["si-snr"],
                       "test_si_snr_db": -tasnet.stage_stats["TEST"]["si-snr"]},
        "peak_mem_bytes": max(peak_fit, torch.cuda.max_memory_allocated()),
        "launches": counts,
    }
    emit(run)
    del brain, brain2, parts, parts2, tasnet
    torch.cuda.empty_cache()
    return run


# the synthetic WSJ0-2mix tree of phase 17: mixtures a split
RECIPE_SEP_RNN = {"tr": 12, "cv": 3, "tt": 3}
# the port's LSTM on the card against the CPU: the largest difference,
# over each output, state and gradient, relative to that tensor's largest
# float64 entry
LSTM_CARD_TOL = 1e-4


def _check_lstm_card():
    """The port's ``LSTM`` (bidirectional, weights and input biases drawn
    as ``wsj0mix_separation.build_model`` draws them) at the DPRNN's intra
    shape (34 chunks x 250 frames x 256, H 128) and the SkiM SegLSTM's (27
    segments x 150 x 128, H 256, from random (h, c)), training forward and
    backward of sum(y R) + sum(h) + sum(c): the card in f32 (TF32 off)
    against the same weights and inputs on the CPU in f32 and in float64.
    Each output, state and gradient's largest difference, relative to its
    float64 scale; the card's ms for the forward and backward."""
    import copy

    import torch

    from speechbrain_tpu_torch.asr import _random_init
    from speechbrain_tpu_torch.nnet.RNN import LSTM
    from speechbrain_tpu_torch.recipes.wsj0mix_separation import (
        _random_biases)

    records = []
    for role, (N, T, C, H), with_state in (
            ("dprnn_intra", (34, 250, 256, 128), False),
            ("skim_segment", (27, 150, 128, 256), True)):
        gen = torch.Generator().manual_seed(SEED + 31)
        base = LSTM(C, H, bidirectional=True)
        _random_init(base, gen)
        _random_biases(base, gen)
        x = torch.randn(N, T, C, generator=gen)
        R = torch.randn(N, T, 2 * H, generator=gen)
        hx = tuple(0.5 * torch.randn(2, N, H, generator=gen)
                   for _ in range(2)) if with_state else None

        def run(dev, dtype, time_it=False):
            m = copy.deepcopy(base).to(dev, dtype).train()
            xi = x.to(dev, dtype).requires_grad_()
            h0 = None if hx is None else tuple(
                v.to(dev, dtype).requires_grad_() for v in hx)
            params = list(m.parameters())

            def fwd_bwd():
                y, (h, c) = m(xi, hx=h0)
                loss = (y * R.to(dev, dtype)).sum() + h.sum() + c.sum()
                wrt = [xi] + list(h0 or ()) + params
                return [y, h, c] + list(torch.autograd.grad(loss, wrt))

            out = [t.detach().double().cpu() for t in fwd_bwd()]
            ms = _time_ms(fwd_bwd, iters=5, warmup=1) if time_it else None
            return out, ms

        f64, _ = run("cpu", torch.float64)
        cpu, _ = run("cpu", torch.float32)
        card, ms = run("cuda", torch.float32, time_it=True)

        def worst(a):
            return max(float((u - w).abs().max()) / max(float(w.abs().max()),
                                                        1e-12)
                       for u, w in zip(a, f64))

        card_cpu = max(float((u - w).abs().max()) / max(float(r.abs().max()),
                                                        1e-12)
                       for u, w, r in zip(card, cpu, f64))
        rec = {"role": role, "shape": [N, T, C, H], "bidirectional": True,
               "initial_state": with_state, "card_vs_cpu": card_cpu,
               "card_vs_float64": worst(card), "cpu_vs_float64": worst(cpu),
               "tolerance": LSTM_CARD_TOL, "card_fwd_bwd_ms": ms}
        assert card_cpu <= LSTM_CARD_TOL, rec
        records.append(rec)
    return records


def phase_recipe_separation_rnn():
    """The WSJ0-2mix recipe's recurrent yamls at their widths in f32: the
    DPRNN (``dprnn.yaml``), SkiM (``skim.yaml``) and RE-SepFormer
    (``resepformer.yaml``) steps at B 1 x 4 s, the port's LSTM on the card
    against the CPU, then the recipes on a synthetic tree (see the module
    docstring, phase 17).  No cuDNN recurrence warns that its weights are
    not one buffer."""
    import shutil
    import tempfile
    import warnings

    import torch

    from speechbrain_tpu_torch.recipes import wsj0mix_separation as recipe

    samples, none = 32000, {k: 0 for k in TRAIN_LAUNCHES}
    runs = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i, (name, hp) in enumerate((
                ("dprnn", recipe.HPARAMS_DPRNN), ("skim", recipe.HPARAMS_SKIM),
                ("resepformer", recipe.HPARAMS_RESEPFORMER))):
            runs[name], brain = _sep_step(name, hp, 1, samples, 3, none,
                                          SEED + 21 + i,
                                          phase="recipe_separation_rnn_step")
            del brain
            torch.cuda.empty_cache()
        check = {"phase": "recipe_separation_rnn_check",
                 "lstm_card_vs_cpu": _check_lstm_card()}
        emit(check)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_sep_rnn_")
        try:
            runs["recipe"] = _recipe_sep_rnn_run(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    unflat = [str(w.message) for w in caught
              if "contiguous chunk" in str(w.message)]
    assert not unflat, unflat
    return dict(runs, check=check)


def _recipe_sep_rnn_run(tmp):
    """The DPRNN 1 epoch, then epoch 2 in a fresh Brain with the modules,
    Adam's state, the rate, the plateau schedule and the generator
    recovered bit for bit, and the test pass; SkiM and the RE-SepFormer 1
    epoch each through ``run``; every SI-SNR finite, no kernel launched."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import wsj0mix_separation as recipe

    data, out = f"{tmp}/wsj", f"{tmp}/dprnn"
    _, write_s = _timed(lambda: recipe.write_synthetic_wsj0mix(
        data, RECIPE_SEP_RNN, RECIPE_SEP_SECONDS, seed=SEED + 1))
    opts = {"staging_depth": 2, "noprogressbar": True}
    at_recovery = {}

    def build(epochs):
        parts = recipe.build(data, out, {"number_of_epochs": epochs}, opts,
                             hparams=recipe.HPARAMS_DPRNN)
        b = parts["brain"]
        fit_start = b.on_fit_start

        def on_fit_start():  # the generator as the recovery left it
            fit_start()
            at_recovery["generator"] = b.generator.get_state()

        b.on_fit_start = on_fit_start
        return parts

    ops.reset_launch_counters()
    parts = build(1)
    brain, log = parts["brain"], {}
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    saved = _snapshot(brain)
    saved_generator = brain.generator.get_state()
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    parts2, log2, recovered = _resume_in_fresh_brain(build, 1)
    brain2 = parts2["brain"]
    assert recovered["epoch"] == 1
    n_equal = _same_state(saved, recovered["state"])
    assert torch.equal(at_recovery["generator"], saved_generator)
    assert len(brain2.lr_scheduler.losses) == 2
    assert _rnn_weights_flat(brain2.modules)
    test_loss, test_s = _timed(lambda: brain2.evaluate(
        parts2["test_loader"], min_key="si-snr"))
    others = {}
    for name, hp in (("skim", recipe.HPARAMS_SKIM),
                     ("resepformer", recipe.HPARAMS_RESEPFORMER)):
        b, seconds = _timed(lambda: recipe.run(
            data, f"{tmp}/{name}", {"number_of_epochs": 1}, opts, hparams=hp))
        others[name] = {"run_1_epoch_s": seconds,
                        "valid_si_snr_db": -b.stage_stats["VALID"]["si-snr"],
                        "test_si_snr_db": -b.stage_stats["TEST"]["si-snr"]}
        del b
    counts = ops.launch_counters()  # the main path's launches, read here
    assert all(v == 0 for v in counts.values()), counts
    valid_losses = log["valid_loss"] + log2["valid_loss"]
    assert all(np.isfinite(valid_losses + [test_loss])), valid_losses
    assert all(np.isfinite([o["valid_si_snr_db"], o["test_si_snr_db"]]).all()
               for o in others.values()), others
    train_s = sum(log["train_s"] + log2["train_s"])
    batches = sum(log["batches"] + log2["batches"])
    run = {
        "phase": "recipe_separation_rnn", "tree": RECIPE_SEP_RNN,
        "seconds": RECIPE_SEP_SECONDS, "write_wavs_s": write_s,
        "precision": "fp32", "epochs": log["epochs"] + log2["epochs"],
        "batches_per_epoch": log["batches"][0],
        "train_s_per_epoch": log["train_s"] + log2["train_s"],
        "train_ms_per_batch": 1e3 * train_s / batches,
        "valid_s": log["valid_s"] + log2["valid_s"],
        "valid_si_snr_db": [-v for v in valid_losses],
        "fit_1_epoch_s": fit_s, "checkpoint_bytes": ckpt_bytes,
        "save_ms": log["save_ms"] + log2["save_ms"],
        "resume_ms": 1e3 * recovered["seconds"],
        "resume_equal_tensors": n_equal, "test_s": test_s,
        "test_si_snr_db": -test_loss, **others,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": counts,
    }
    emit(run)
    del brain, brain2, parts, parts2
    torch.cuda.empty_cache()
    return run


# the synthetic trees of phase 18: mixtures a split
RECIPE_SEP_MORE = {"tr": 6, "cv": 2, "tt": 2}
RECIPE_REALM = {"tr": 8, "cv": 4, "tt": 4}
# phase 18's card-vs-CPU check.  In float64 (the attention's softmax
# stays f32 there, as in JAX: ``nnet/attention._softmax``), the loss's
# difference relative to the CPU's and each gradient's largest difference
# relative to its scale (floored at 5 % of the largest gradient); in f32,
# the loss's alone.  The f32 gradients are reported, not bounded: on an
# H100 the spectral masker's f32 gradients differed from the CPU's by up
# to 5.0e-3 of their scale (layer 5's leaky-ReLU FFN, ``ffn.w_1``: a
# unit within a last bit of its kink takes the other slope on one
# device) while its float64 runs agreed within 1.9e-6 of the scale and
# 2.2e-9 of the loss; the binaural "parallel" model's f32 gradients lie
# 1.5e-2 from float64 on either device.
SEP_MORE_CARD_TOL = {"loss_f32": 1e-5, "loss_float64": 1e-7,
                     "gradients_float64": 1e-4}


def _card_vs_cpu(brain, batch, hparams):
    """The Brain's model in eval mode (no dropout) on the card and on the
    CPU, on the same weights and batch, in f32 (TF32 off) and in float64:
    the capped PIT loss (``Separation``'s, the targets as the Brain stacks
    them, in each run's precision) and every parameter's gradient.  The
    STFT, ISTFT and resynthesis of the spectral masker and the ILD's STFT,
    log and resize of the binaural "cross" model are all inside.  Returns
    the differences beside ``SEP_MORE_CARD_TOL``."""
    import torch

    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.recipes.wsj0mix_separation import build_model

    state = {k: v.detach().cpu()
             for k, v in brain.modules.masknet.state_dict().items()}
    names = [n for n, _ in brain.modules.masknet.named_parameters()]

    def run(dev, dtype):
        model = build_model(hparams).to(dtype)
        model.load_state_dict(state)
        model.to(dev).eval()
        b = {k: v.to(dev, dtype) for k, v in batch.items()}
        saved, saved_dtype = brain.modules.masknet, brain.dtype
        brain.modules.masknet, brain.dtype = model, dtype
        try:
            pred = brain.compute_forward(b, Stage.TRAIN)
        finally:
            brain.modules.masknet, brain.dtype = saved, saved_dtype
        pred = pred.reshape(pred.shape[0], -1, pred.shape[-1])
        per_ex = brain.pit_si_snr(brain.targets(b), pred)[0]
        loss = per_ex.clamp(max=hparams["loss_upper_lim"]).mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return [loss.detach().double().cpu()] + [g.double().cpu()
                                                 for g in grads]

    out = {(dev, str(dt)[6:]): run(dev, dt)
           for dev in (brain.device, "cpu")
           for dt in (torch.float32, torch.float64)}
    card, cpu = brain.device, "cpu"
    f64 = out[cpu, "float64"]
    G = max(float(g.abs().max()) for g in f64[1:])

    def worst(a, b):
        rel = [float((u - w).abs().max()) / max(float(r.abs().max()),
                                                0.05 * G)
               for u, w, r in zip(a[1:], b[1:], f64[1:])]
        i = int(np.argmax(rel))
        return rel[i], names[i]

    def loss_rel(a, b):
        return abs(float(a[0] - b[0])) / abs(float(f64[0]))

    g32, name32 = worst(out[card, "float32"], out[cpu, "float32"])
    rec = {"loss_card_f32": float(out[card, "float32"][0]),
           "loss_cpu_f32": float(out[cpu, "float32"][0]),
           "loss_float64": float(f64[0]),
           "loss_card_vs_cpu_f32": loss_rel(out[card, "float32"],
                                            out[cpu, "float32"]),
           "loss_card_vs_cpu_float64": loss_rel(out[card, "float64"], f64),
           "gradients_card_vs_cpu_float64": worst(out[card, "float64"],
                                                  f64)[0],
           "gradients_card_vs_cpu_f32": g32,
           "gradients_card_vs_cpu_f32_worst": name32,
           "gradients_card_f32_vs_float64": worst(out[card, "float32"],
                                                  f64)[0],
           "gradients_cpu_f32_vs_float64": worst(out[cpu, "float32"], f64)[0],
           "tolerance": SEP_MORE_CARD_TOL}
    assert all(np.isfinite(float(t.abs().max()))
               for t in out[card, "float32"]), rec
    tol = SEP_MORE_CARD_TOL
    assert rec["loss_card_vs_cpu_f32"] <= tol["loss_f32"], rec
    assert rec["loss_card_vs_cpu_float64"] <= tol["loss_float64"], rec
    assert rec["gradients_card_vs_cpu_float64"] <= tol["gradients_float64"], rec
    return rec


def phase_recipe_separation_more():
    """The rest of separation at the yamls' widths in f32: one training
    step of each of ``cnntransformer-whamr-DM.yaml`` (the spectral masker,
    B 1 x 4 s), ``convtasnet-cross.yaml`` and ``convtasnet-parallel.yaml``
    (binaural, B 1 x 3 s stereo) and ``sepformer-libri3mix.yaml`` (three
    sources, B 1 x 3 s); the card's loss and gradients against the CPU's
    for the spectral masker (the ISTFT) and the "cross" model (the ILD's
    resize; "parallel" runs a subset of its operations); then the recipes
    on synthetic trees (see the module docstring, phase 18)."""
    import shutil
    import tempfile

    import torch

    from speechbrain_tpu_torch.recipes import binaural_separation as bi
    from speechbrain_tpu_torch.recipes import librimix_separation as lm
    from speechbrain_tpu_torch.recipes import wham_separation as wham

    none = {k: 0 for k in TRAIN_LAUNCHES}
    runs, checks = {}, {}
    for i, (name, hp, samples, brain_class, kw) in enumerate((
            ("cnntransformer-whamr-DM",
             wham.HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAMR_DM, 32000, None,
             {}),
            ("convtasnet-cross", bi.HPARAMS_CROSS, 24000,
             bi.BinauralSeparation, {"stereo": True}),
            ("convtasnet-parallel", bi.HPARAMS_PARALLEL, 24000,
             bi.BinauralSeparation, {"stereo": True}),
            ("sepformer-libri3mix", lm.HPARAMS_LIBRI3MIX, 24000, None,
             {"sources": 3}))):
        batch = _sep_batch(1, samples, SEED + 41 + i, **kw)
        runs[name], brain = _sep_step(
            name, hp, 1, samples, 3, none, SEED + 41 + i,
            phase="recipe_separation_more_step", brain_class=brain_class,
            batch=batch)
        if name in ("cnntransformer-whamr-DM", "convtasnet-cross"):
            rec, seconds = _timed(lambda: _card_vs_cpu(
                brain, brain.prepare_batch(batch), dict(hp)))
            checks[name] = dict(rec, seconds=seconds)
            emit({"phase": "recipe_separation_more_check", "hparams": name,
                  **checks[name]})
        del brain
        torch.cuda.empty_cache()
    check = {"card_vs_cpu": checks}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sep_more_")
    try:
        runs["recipe"] = _recipe_sep_more_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(runs, check=check)


def _recipe_sep_more_run(tmp):
    """The WHAM! enhancement with dynamic mixing
    (``cnntransformer-whamr-DM.yaml``) 1 epoch, then epoch 2 in a fresh
    Brain with the modules, Adam's state, the rate, the plateau schedule
    and the generator recovered bit for bit, and the test pass; the
    LibriMix 3-mix, binaural "cross" and REAL-M recipes 1 epoch each
    through ``run``; every SI-SNR (and REAL-M's L1) finite, no kernel
    launched."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import binaural_separation as bi
    from speechbrain_tpu_torch.recipes import librimix_separation as lm
    from speechbrain_tpu_torch.recipes import realm_sisnr as rm
    from speechbrain_tpu_torch.recipes import wham_separation as wham
    from speechbrain_tpu_torch.recipes import wsj0mix_separation as ws

    trees = {}
    _, trees["wham"] = _timed(lambda: wham.write_synthetic_wham(
        f"{tmp}/wham", RECIPE_SEP_MORE, RECIPE_SEP_SECONDS, seed=SEED + 2,
        num_spks=1))
    _, trees["libri3mix"] = _timed(lambda: lm.write_synthetic_librimix(
        f"{tmp}/libri3", {"train-100": RECIPE_SEP_MORE["tr"],
                          "dev": RECIPE_SEP_MORE["cv"],
                          "test": RECIPE_SEP_MORE["tt"]},
        RECIPE_SEP_SECONDS, seed=SEED + 3, num_spks=3))
    _, trees["binaural"] = _timed(lambda: bi.write_synthetic_binaural(
        f"{tmp}/bi", RECIPE_SEP_MORE, RECIPE_SEP_SECONDS, seed=SEED + 4))
    _, trees["wsj"] = _timed(lambda: ws.write_synthetic_wsj0mix(
        f"{tmp}/wsj", RECIPE_REALM, RECIPE_SEP_SECONDS, seed=SEED + 5))
    opts = {"staging_depth": 2, "noprogressbar": True}
    at_recovery = {}
    hparams = wham.HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAMR_DM

    def build(epochs):
        parts = wham.build(f"{tmp}/wham", f"{tmp}/wham_out",
                           {"number_of_epochs": epochs}, opts,
                           hparams=hparams)
        b = parts["brain"]
        fit_start = b.on_fit_start

        def on_fit_start():  # the generator as the recovery left it
            fit_start()
            at_recovery["generator"] = b.generator.get_state()

        b.on_fit_start = on_fit_start
        return parts

    ops.reset_launch_counters()
    parts = build(1)
    brain, log = parts["brain"], {}
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    saved = _snapshot(brain)
    saved_generator = brain.generator.get_state()
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    parts2, log2, recovered = _resume_in_fresh_brain(build, 1)
    brain2 = parts2["brain"]
    assert recovered["epoch"] == 1
    n_equal = _same_state(saved, recovered["state"])
    assert torch.equal(at_recovery["generator"], saved_generator)
    assert isinstance(brain2.hparams.crop, wham.DynamicMix)
    assert brain2.hparams.crop.epoch == 2
    assert len(brain2.lr_scheduler.losses) == 2
    test_loss, test_s = _timed(lambda: brain2.evaluate(
        parts2["test_loader"], min_key="si-snr"))
    others = {}
    for name, fn in (
            ("libri3mix", lambda: lm.run(
                f"{tmp}/libri3", f"{tmp}/libri3_out", {"number_of_epochs": 1},
                opts, hparams=lm.HPARAMS_LIBRI3MIX)),
            ("binaural_cross", lambda: bi.run(
                f"{tmp}/bi", f"{tmp}/bi_out", {"number_of_epochs": 1}, opts,
                hparams=bi.HPARAMS_CROSS)),
            ("realm", lambda: rm.run(
                f"{tmp}/wsj", f"{tmp}/realm_out", {"number_of_epochs": 1},
                opts))):
        b, seconds = _timed(fn)
        key = "si-snr-l1" if name == "realm" else "si-snr"
        others[name] = {"run_1_epoch_s": seconds,
                        f"valid_{key}": b.stage_stats["VALID"][key],
                        f"test_{key}": b.stage_stats["TEST"][key]}
        del b
    counts = ops.launch_counters()  # the main path's launches, read here
    assert all(v == 0 for v in counts.values()), counts
    valid_losses = log["valid_loss"] + log2["valid_loss"]
    assert all(np.isfinite(valid_losses + [test_loss])), valid_losses
    assert all(np.isfinite(list(o.values())).all()
               for o in others.values()), others
    train_s = sum(log["train_s"] + log2["train_s"])
    batches = sum(log["batches"] + log2["batches"])
    run = {
        "phase": "recipe_separation_more", "tree": RECIPE_SEP_MORE,
        "realm_tree": RECIPE_REALM, "seconds": RECIPE_SEP_SECONDS,
        "write_wavs_s": trees, "precision": "fp32",
        "epochs": log["epochs"] + log2["epochs"],
        "batches_per_epoch": log["batches"][0],
        "train_s_per_epoch": log["train_s"] + log2["train_s"],
        "train_ms_per_batch": 1e3 * train_s / batches,
        "valid_s": log["valid_s"] + log2["valid_s"],
        "valid_si_snr_db": [-v for v in valid_losses],
        "fit_1_epoch_s": fit_s, "checkpoint_bytes": ckpt_bytes,
        "save_ms": log["save_ms"] + log2["save_ms"],
        "resume_ms": 1e3 * recovered["seconds"],
        "resume_equal_tensors": n_equal, "test_s": test_s,
        "test_si_snr_db": -test_loss, **others,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": counts,
    }
    emit(run)
    del brain, brain2, parts, parts2
    torch.cuda.empty_cache()
    return run


# phase 19: the CRDNN seq2seq recipe.  A CTC-epoch step launches K3 and
# K4 once each and nothing else; its batch's 2U + 1 <= 257 lattice takes
# the warp path of csrc/ctc.cu.
S2S_LAUNCHES = dict(TIMIT_LAUNCHES)
S2S_B, S2S_SAMPLES, S2S_U = 8, 160000, 48
# the LM-fused search's step budget: max_steps = int(1001 frames x 0.1)
S2S_SEARCH_RATIO = 0.1
# the card-vs-CPU checks at toy widths (float64 modules, after the CTC
# epochs: the CTC's recursions, kernels and plain, run in float32): the
# loss relative to the CPU's, each gradient's largest difference relative
# to its scale (floored at 5 % of the largest gradient), the searches'
# scores absolute (the search keeps its scores in float32).  The step is
# float64 throughout (the LayerNorms', BatchNorms' and InputNormalization's
# statistics at least float32, float64 kept); the control, the card side
# in float32, must break both bounds.  On an H100 the float64 step read
# 1.2e-16 (loss) and 3.3e-14 (gradients), the control 1.4e-7 and 4.9e-5:
# each bound lies about three orders below the control and five above
# the reading.
S2S_CARD_TOL = {"loss_float64": 1e-10, "gradients_float64": 1e-8,
                "search_scores": 1e-4}
S2S_TOY = dict(cnn_channels=(4, 6), rnn_layers=1, rnn_neurons=8,
               dnn_blocks=1, dnn_neurons=8, emb_size=8, dec_neurons=16,
               attn_dim=12, vocab_size=40, dropout=0.0, augmentation=None,
               max_attn_shift=20, lm_emb_dim=8, lm_rnn_neurons=16,
               lm_dnn_neurons=12)
RECIPE_S2S_UTTERANCES = {"train-clean-100": 16, "dev-clean": 8,
                         "test-clean": 4}
RECIPE_S2S_SECONDS = (2.0, 4.0)


def _s2s_batch(B, samples, U, V, seed):
    """B synthetic utterances of white noise (every length full) with
    U / 2 to U token ids in 1..V-1 each, padded with 0 (the yaml's blank,
    bos and eos): ``tokens``, ``tokens_bos`` = [0] + tokens, ``tokens_eos``
    = tokens + [0], and their relative lengths."""
    rng = np.random.default_rng(seed)
    n = rng.integers(U // 2, U + 1, B)
    tok = rng.integers(1, V, (B, U))
    tok[np.arange(U)[None, :] >= n[:, None]] = 0
    zero = np.zeros((B, 1), tok.dtype)
    return {"sig": rng.normal(size=(B, samples)).astype(np.float32),
            "sig_lens": np.ones(B, np.float32), "tokens": tok,
            "tokens_lens": (n / U).astype(np.float32),
            "tokens_bos": np.concatenate([zero, tok], 1),
            "tokens_eos": np.concatenate([tok, zero], 1),
            "tokens_eos_lens": ((n + 1) / (U + 1)).astype(np.float32)}


def _s2s_brain(precision, device=None, **hparams):
    """``librispeech_seq2seq.Seq2SeqBrain`` (``train_BPE_1000.yaml``'s
    widths unless ``hparams`` says otherwise) in a CTC epoch."""
    from speechbrain_tpu_torch.recipes.librispeech_seq2seq import Seq2SeqBrain

    brain = Seq2SeqBrain(hparams, run_opts={
        "seed": SEED, "precision": precision, "loss_sync_interval": 10,
        "device": device})
    brain.epoch = 1
    return brain


def _s2s_step(precision, vocab=1000, steps=3, profile=True):
    """The recipe's training step at full width on B 8 x 10 s: a warm-up,
    ``steps`` timed Adadelta steps at lr 1.0 (dropout 0.15, SpecAugment),
    the launches a step (``S2S_LAUNCHES``), and with ``profile`` the
    PyTorch calls and the profile of one more step, the FLOPs, and the
    decoder loop's share."""
    import torch

    from speechbrain_tpu_torch import ops

    brain = _s2s_brain(precision, vocab_size=vocab)
    n_params = sum(p.numel() for p in brain.modules.parameters())
    host = _s2s_batch(S2S_B, S2S_SAMPLES, S2S_U, vocab, SEED + 19)
    batch = brain.prepare_batch(host)
    brain.step = 1
    first = float(brain.fit_batch(batch))  # warm-up, untimed
    assert _rnn_weights_flat(brain.modules)
    ops.reset_launch_counters()
    ms, losses, peak = _run_steps(brain, batch, steps)
    counts = ops.launch_counters()
    per_step = _per_step(counts, steps)
    assert per_step == S2S_LAUNCHES, per_step
    assert all(np.isfinite([first] + losses)), losses
    U = int(host["tokens"].shape[1])
    run = {"phase": "recipe_seq2seq_step", "precision": precision,
           "vocab_size": vocab, "batch": S2S_B,
           "seconds_audio": S2S_SAMPLES / 16000, "T_enc": 1001,
           "tokens": (host["tokens_lens"] * U).round().tolist(),
           "ctc_lattice": [S2S_B, 1001, 2 * U + 1],
           "ctc_path": "warp" if 2 * U + 1 <= 257 else "block",
           "parameters": n_params, "steps": steps, "lr": brain.lr,
           "ms_per_step": ms, "utt_per_s": 1e3 * S2S_B / ms,
           "peak_mem_bytes": peak, "peak_gib": peak / 2 ** 30,
           "launches": counts, "launches_per_step": per_step,
           "loss_first": first, "loss_last": losses[-1]}
    if profile:
        def one_step():
            brain.step += 1
            brain.fit_batch(batch)
            return 1

        info = {}
        fwd, step_flops = _sep_flops(brain, batch, info)
        run.update(pytorch_calls_per_step=_pytorch_calls(one_step),
                   forward_gflop=fwd / 1e9, step_gflop=step_flops / 1e9,
                   profile=_profile(one_step, cpu=False), **info)
        # the teacher-forced decoder alone: forward and backward at the
        # step's shapes, in training mode
        m = brain.modules
        with torch.no_grad():
            enc = m.enc(torch.randn(S2S_B, 1001, 40, device="cuda")
                        .to(brain.dtype))
        enc.requires_grad_()
        emb = m.emb(batch["tokens_bos"]).to(brain.dtype).detach()

        def decoder():
            out, _ = m.dec(emb, enc, batch["sig_lens"])
            (g,) = torch.autograd.grad(out.float().sum(), enc)
            return g

        decoder()
        run["decoder_fwd_bwd_ms"] = _time_ms(decoder, iters=2, warmup=0)
        run["decoder_pytorch_calls"] = _pytorch_calls(decoder)
    emit(run)
    del brain, batch
    torch.cuda.empty_cache()
    return run


def _s2s_routes():
    """The step's loss and every gradient through K3/K4 and through the
    plain CTC recursions (``Seq2SeqBrain.set_kernels``), from the same
    weights: full width, f32, a CTC epoch, B 8 x 10 s with ragged lengths
    and a dummy row (no frame, no token), dropout 0 and SpecAugment (its
    draws put back between the routes)."""
    import torch

    brain = _s2s_brain("fp32", dropout=0.0)
    host = _s2s_batch(S2S_B, S2S_SAMPLES, S2S_U, 1000, SEED + 22)
    host["sig_lens"] = np.linspace(1.0, 0.6, S2S_B).astype(np.float32)
    host["batch_mask"] = np.ones(S2S_B, np.float32)
    host["batch_mask"][-1] = 0.0
    batch = brain.prepare_batch(host)
    cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=1e-3)
    cmp.update(lattice=[S2S_B, 1001, 2 * S2S_U + 1], dummy_rows=1)
    del brain, batch
    torch.cuda.empty_cache()
    return cmp


def _s2s_card_vs_cpu():
    """The step's loss and every gradient at toy widths, float64 modules,
    on the card and on the CPU from the same weights and batch (an epoch
    after the CTC epochs: the CTC runs in float32; training mode without
    dropout), and the LM-fused beam search (beam 4,
    the yaml's options, a toy RNNLM; eval mode) on both: the same
    hypotheses, scores within ``S2S_CARD_TOL``.  The control runs the
    card side in float32 (TF32 off) against the same CPU run: both of
    its readings must break their bounds, or the bounds could not see a
    float32 leak."""
    import torch

    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.recipes.librispeech_seq2seq import build_lm

    host = _s2s_batch(3, 16000, 6, S2S_TOY["vocab_size"], SEED + 20)
    host["sig_lens"] = np.array([1.0, 0.8, 0.6], np.float32)
    lm = build_lm(S2S_TOY, seed=SEED + 1).double()

    def run(dev, dtype):
        brain = _s2s_brain("fp32", device=dev, **S2S_TOY)
        brain.modules.to(dtype)
        brain.dtype = dtype
        # training mode (cuDNN's RNN backward needs it); no dropout, no
        # SpecAugment at these widths
        brain.modules.train()
        brain.epoch = brain.hparams.number_of_ctc_epochs + 1
        brain.lm = lm.to(dev, dtype)
        batch = brain.prepare_batch(
            {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in host.items()})
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
        names, params = zip(*brain.modules.named_parameters())
        preds = brain.compute_forward(batch, Stage.TRAIN)
        loss = brain.compute_objectives(preds, batch, Stage.TRAIN)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g  # ctc_lin's
                 for p, g in zip(params, grads)]
        brain.modules.eval()
        with torch.no_grad():
            enc = brain.modules.enc(
                brain.modules.normalize(brain.modules.compute_features(
                    batch["sig"]), batch["sig_lens"]), batch["sig_lens"])
            hyps, scores = brain.make_searcher(4)(enc, batch["sig_lens"])
        return (names, float(loss.detach()),
                [g.cpu().double() for g in grads], hyps, scores)

    names, lp, gp, hp_, sp = run("cpu", torch.float64)
    G = max(float(g.abs().max()) for g in gp)

    def errors(loss, grads):
        rel = [float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 0.05 * G)
               for a, b in zip(grads, gp)]
        i = int(np.argmax(rel))
        return abs(loss - lp) / abs(lp), rel[i], names[i]

    _, lc, gc, hc, sc = run("cuda", torch.float64)
    loss_err, grad_err, worst = errors(lc, gc)
    _, lf, gf, hf, _ = run("cuda", torch.float32)
    control_loss, control_grad, control_worst = errors(lf, gf)
    live = np.abs(sp) < 1e10
    assert np.array_equal(live, np.abs(sc) < 1e10) and live.any()
    rec = {"loss_card": lc, "loss_cpu": lp,
           "loss_card_vs_cpu_float64": loss_err,
           "gradients_card_vs_cpu_float64": grad_err,
           "gradient_worst": worst,
           "n_gradients": len(gp), "hyps_card": hc, "hyps_cpu": hp_,
           "search_scores_card": sc.tolist(), "search_scores_cpu": sp.tolist(),
           # over the live hypotheses: a beam whose every candidate the
           # attention-shift limit masked scores ~-1e20 / steps
           "search_scores_max_abs_diff": float(np.abs(sc - sp)[live].max()),
           "control_card_float32": {
               "loss": control_loss, "gradients": control_grad,
               "gradient_worst": control_worst, "hyps_equal": hf == hp_},
           "tolerance": S2S_CARD_TOL}
    assert loss_err <= S2S_CARD_TOL["loss_float64"], rec
    assert grad_err <= S2S_CARD_TOL["gradients_float64"], rec
    assert hc == hp_, rec
    tol = S2S_CARD_TOL["search_scores"]
    assert rec["search_scores_max_abs_diff"] <= tol, rec
    assert control_loss > S2S_CARD_TOL["loss_float64"], rec
    assert control_grad > S2S_CARD_TOL["gradients_float64"], rec
    return rec


def _s2s_search(precision):
    """The LM-fused beam search as the recipe validates: beam 8, the
    yaml's options (temperature 1.25, coverage 1.5, attention shift 240,
    eos threshold 1.5) and the RNNLM at 2 x 2048 fused at 0.5 (random
    weights), over B 8 x 10 s encoded by the model, for at most
    int(1001 x ``S2S_SEARCH_RATIO``) steps; the profile of a second
    search (the card's events)."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes.librispeech_seq2seq import build_lm

    brain = _s2s_brain(precision, max_decode_ratio=S2S_SEARCH_RATIO)
    brain.lm = build_lm({}, seed=SEED + 1).to("cuda")
    n_lm = sum(p.numel() for p in brain.lm.parameters())
    host = _s2s_batch(S2S_B, S2S_SAMPLES, S2S_U, 1000, SEED + 21)
    batch = brain.prepare_batch(host)
    m = brain.modules.eval()
    ops.reset_launch_counters()

    @torch.no_grad()
    def encode():
        feats = m.normalize(m.compute_features(batch["sig"]),
                            batch["sig_lens"])
        return m.enc(feats.to(brain.dtype), batch["sig_lens"])

    enc, encode_s = _timed(encode)
    searcher = brain.make_searcher(brain.hparams.valid_beam_size)
    assert type(searcher).__name__ == "S2SRNNBeamSearchLM"
    steps = [0]
    step = searcher.forward_step

    def counted(*args):
        steps[0] += 1
        return step(*args)

    searcher.forward_step = counted
    (hyps, scores), search_s = _timed(lambda: searcher(enc,
                                                        batch["sig_lens"]))
    n_steps = steps[0]
    counts = ops.launch_counters()
    assert all(v == 0 for v in counts.values()), counts
    assert np.isfinite(scores).all() and len(hyps) == S2S_B
    max_steps = int(1001 * S2S_SEARCH_RATIO)
    assert 0 < n_steps <= max_steps

    def search():
        steps[0] = 0
        searcher(enc, batch["sig_lens"])
        return steps[0]

    run = {"phase": "recipe_seq2seq_search", "precision": precision,
           "batch": S2S_B, "beam": brain.hparams.valid_beam_size,
           "rows": S2S_B * brain.hparams.valid_beam_size, "T_enc": 1001,
           "lm_parameters": n_lm, "lm_weight": brain.hparams.lm_weight,
           "max_steps": max_steps, "steps": n_steps,
           "encode_ms": 1e3 * encode_s, "search_ms": 1e3 * search_s,
           "ms_per_step": 1e3 * search_s / n_steps,
           "utt_per_s": S2S_B / (encode_s + search_s),
           "hyp_lengths": [len(h) for h in hyps], "launches": counts,
           "profile": _profile(search, cpu=False)}
    emit(run)
    del brain, enc
    torch.cuda.empty_cache()
    return run


def _recipe_s2s_run(tmp):
    """The recipe through ``build``/``fit``/``evaluate`` on a synthetic
    tree at full width (bf16), the RNNLM fused from a checkpoint file:
    epoch 1, epoch 2 in a fresh Brain recovered bit for bit, the test at
    beam 80; the searches capped at ``S2S_SEARCH_RATIO``."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import librispeech_seq2seq as recipe
    from speechbrain_tpu_torch.recipes.librispeech_asr import (
        write_synthetic_librispeech)

    data, out = f"{tmp}/LibriSpeech", f"{tmp}/out"
    _, write_s = _timed(lambda: write_synthetic_librispeech(
        data, RECIPE_S2S_UTTERANCES, seconds=RECIPE_S2S_SECONDS,
        n_words=(5, 10), seed=SEED))
    lm_ckpt = f"{tmp}/lm.ckpt"
    torch.save(recipe.build_lm({}, seed=SEED + 1).state_dict(), lm_ckpt)
    opts = {"noprogressbar": True, "lm_ckpt": lm_ckpt}
    overrides = {"train_splits": ["train-clean-100"],
                 "max_decode_ratio": S2S_SEARCH_RATIO}

    def build(epochs):
        return recipe.build(data, out, dict(overrides,
                                            number_of_epochs=epochs), opts)

    ops.reset_launch_counters()
    parts, build_s = _timed(lambda: build(1))
    brain, log = parts["brain"], {}
    assert brain.lm is not None and brain.dtype == torch.bfloat16
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    saved = _snapshot(brain)
    valid = [dict(brain.stage_stats["VALID"])]
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    parts2, log2, recovered = _resume_in_fresh_brain(build, 1)
    brain2 = parts2["brain"]
    assert recovered["epoch"] == 1
    n_equal = _same_state(saved, recovered["state"])
    valid.append(dict(brain2.stage_stats["VALID"]))
    test_loss, test_s = _timed(lambda: brain2.evaluate(
        parts2["test_loader"], min_key="WER"))
    counts = ops.launch_counters()
    test = brain2.stage_stats["TEST"]
    for stats in valid + [test]:
        assert all(np.isfinite(v) for v in stats.values()), stats
    assert counts["ctc_alpha"] > 0 and counts["ctc_beta_grad"] > 0, counts
    assert all(v == 0 for k, v in counts.items()
               if k not in ("ctc_alpha", "ctc_beta_grad")), counts
    train_s = sum(log["train_s"] + log2["train_s"])
    batches = sum(log["batches"] + log2["batches"])
    run = {"phase": "recipe_seq2seq", "utterances": RECIPE_S2S_UTTERANCES,
           "seconds": RECIPE_S2S_SECONDS, "write_wav_s": write_s,
           "build_s": build_s, "tokenizer_pieces":
           parts["brain"].tokenizer.sp.get_piece_size(),
           "precision": "bf16", "epochs": log["epochs"] + log2["epochs"],
           "batches_per_epoch": log["batches"][0],
           "batch_shapes": sorted(log["shapes"]),
           "train_s_per_epoch": log["train_s"] + log2["train_s"],
           "train_ms_per_batch": 1e3 * train_s / batches,
           "valid_s": log["valid_s"] + log2["valid_s"], "valid": valid,
           "lr_per_epoch": [brain.lr, brain2.lr], "fit_1_epoch_s": fit_s,
           "checkpoint_bytes": ckpt_bytes,
           "save_ms": log["save_ms"] + log2["save_ms"],
           "resume_ms": 1e3 * recovered["seconds"],
           "resume_equal_tensors": n_equal, "test_s": test_s,
           "test": test, "test_loss": test_loss,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts}
    emit(run)
    del brain, brain2, parts, parts2
    torch.cuda.empty_cache()
    return run


def phase_recipe_seq2seq():
    """The LibriSpeech CRDNN seq2seq recipe (``recipes.librispeech_seq2seq``,
    ``train_BPE_1000.yaml``) at full width: see the module docstring,
    phase 19."""
    import shutil
    import tempfile

    runs = {"bf16": _s2s_step("bf16"),
            "fp32": _s2s_step("fp32", profile=False),  # see SHORTENED
            "bpe5000": _s2s_step("bf16", vocab=5000, steps=1, profile=False)}
    routes = _s2s_routes()
    check = dict(_s2s_card_vs_cpu(), kernel_vs_plain=routes)
    emit(dict(check, phase="recipe_seq2seq_check"))
    runs["search_fp32"] = _s2s_search("fp32")  # f32 only: see SHORTENED
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq2seq_")
    try:
        runs["recipe"] = _recipe_s2s_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs["check"] = check
    return runs


# ------------------------------------------------------------ recipe_lm

# the LibriSpeech LM yamls' batch at the max_seq_len cap: 64 rows of 255
# tokens and the bos
LM_B, LM_L = 64, 256
LM_NAMES = ("rnnlm", "transformer")
RECIPE_LM_UTTERANCES = {"train-clean-100": 32, "dev-clean": 4,
                        "test-clean": 2}
RECIPE_LM_LINES = {"train": 128, "valid": 64, "test": 64}
RECIPE_TAS = {"train-synth": 96, "train-real": 32, "dev-real": 32,
              "test-real": 32}
# the fused searches' cap: max_steps = int(T_enc x ratio)
LM_FUSED_RATIO = 0.5


def _lm_hparams(name):
    from speechbrain_tpu_torch.recipes import lm_training

    return {"rnnlm": lm_training.HPARAMS_RNNLM,
            "transformer": lm_training.HPARAMS_TRANSFORMER,
            "kspon": lm_training.HPARAMS_KSPON}[name]


def _lm_batch(V, seed, B=LM_B, L=LM_L):
    """B rows of L - 1 random tokens in 3..V-1 behind bos 1 (every row at
    the max_seq_len cap), ``tokens_eos`` the tokens and eos 2."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(3, V, (B, L - 1))
    return {"tokens_bos": np.concatenate([np.ones((B, 1), np.int64), tok], 1),
            "tokens_eos": np.concatenate([tok, np.full((B, 1), 2)], 1),
            "tokens_eos_lens": np.ones(B, np.float32)}


def _rnn_kernels(fn):
    """The device kernels of ``fn()`` whose names say cuDNN's recurrence
    runs them (RNN, LSTM, elemWise, gemm), by name with their counts and
    device ms, under the profiler (the card's events only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and re.search(r"RNN|LSTM|lstm|rnn|elemWise|gemm", e.name)):
            ms, n = names.get(e.name[:70], (0.0, 0))
            names[e.name[:70]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return sorted(([k, ms, n] for k, (ms, n) in names.items()),
                  key=lambda r: -r[1])[:8]


def _lm_step(name, precision, steps=3):
    """``lm_training.LM`` at its yaml's widths on B 64 x 256 tokens: a
    warm-up, ``steps`` timed Adam steps (Noam), tokens/s, peak memory,
    FLOPs and their bound, the PyTorch calls and the profile of one more
    step; for the RNNLM the cuDNN kernels of its LSTM's forward and
    backward."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes.lm_training import LM

    hp = _lm_hparams(name)
    brain = LM(hp, run_opts={"seed": SEED, "precision": precision,
                             "loss_sync_interval": 10})
    n_params = sum(p.numel() for p in brain.modules.parameters())
    batch = brain.prepare_batch(_lm_batch(hp["vocab_size"], SEED + 30))
    brain.step = 1
    first = float(brain.fit_batch(batch))
    assert _rnn_weights_flat(brain.modules)
    ops.reset_launch_counters()
    ms, losses, peak = _run_steps(brain, batch, steps)
    counts = ops.launch_counters()
    assert all(v == 0 for v in counts.values()), counts
    assert all(np.isfinite([first] + losses)), losses

    def one_step():
        brain.step += 1
        brain.fit_batch(batch)
        return 1

    info = {}
    fwd, step_flops = _sep_flops(brain, batch, info)
    dtype = "bfloat16" if precision == "bf16" else "float32"
    bound = _bound_ms(0, step_flops, dtype)
    run = {"phase": "recipe_lm_step", "model": name, "precision": precision,
           "batch": LM_B, "tokens_per_row": LM_L, "vocab": hp["vocab_size"],
           "parameters": n_params, "steps": steps, "lr": brain.lr,
           "ms_per_step": ms, "tokens_per_s": 1e3 * LM_B * LM_L / ms,
           "peak_mem_bytes": peak, "peak_gib": peak / 2 ** 30,
           "forward_gflop": fwd / 1e9, "step_gflop": step_flops / 1e9,
           "bound_ms": bound[0], "bound_peak": dtype, **info,
           "pytorch_calls_per_step": _pytorch_calls(one_step),
           "profile": _profile(one_step, cpu=False),
           "launches": counts, "loss_first": first, "loss_last": losses[-1]}
    if name == "rnnlm":
        lstm = brain.modules.model.rnn
        x = torch.randn(LM_B, LM_L, lstm.rnns[0].input_size, device="cuda",
                        dtype=brain.dtype, requires_grad=True)

        def fwd_bwd():
            y, _ = lstm(x)
            torch.autograd.grad(y.float().sum(), x)

        fwd_bwd()
        run["lstm_dtype_in_out"] = str(brain.dtype)
        run["lstm_weight_dtype"] = str(lstm.rnns[0].weight_ih_l0.dtype)
        run["lstm_fwd_bwd_ms"] = _time_ms(fwd_bwd, iters=2, warmup=0)
        run["lstm_cudnn_kernels"] = _rnn_kernels(fwd_bwd)
    emit(run)
    del brain, batch
    torch.cuda.empty_cache()
    return run


def _lm_recipe_run(tmp):
    """The three LM dicts through ``lm_training.build``/``fit``/``evaluate``
    (f32, the yamls' precision) on synthetic corpora, the LibriSpeech LMs
    on the ASR recipes' tokenizer files (vocab 1000 for the RNNLM, the
    seq2seq recipe's; 5000 for the transformer, the conformer recipe's):
    1 epoch, epoch 2 in a fresh Brain recovered bit for bit, the test,
    ``lm.ckpt``; then each LibriSpeech LM's ``lm.ckpt`` fused into its ASR
    recipe's search (full width, ``run_opts["lm_ckpt"]``) for a fixed
    number of steps, against the same search at ``lm_weight`` 0."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import (
        librispeech_asr, librispeech_seq2seq, lm_training)
    from speechbrain_tpu_torch.recipes.timers_and_such_prepare import (
        write_synthetic_tas)
    from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece

    data = f"{tmp}/LibriSpeech"
    # the train split's transcripts train the tokenizers (long ones: its
    # audio is not read here); the dev split's 2-4 s are decoded
    librispeech_asr.write_synthetic_librispeech(
        data, {"train-clean-100": RECIPE_LM_UTTERANCES["train-clean-100"]},
        seconds=(0.2, 0.3), n_words=(40, 60), seed=SEED)
    librispeech_asr.write_synthetic_librispeech(
        data, {k: v for k, v in RECIPE_LM_UTTERANCES.items()
               if k != "train-clean-100"},
        seconds=(2.0, 4.0), n_words=(6, 12), seed=SEED)
    # the ASR recipes' manifests and tokenizers, where their builds find
    # them
    tokenizers = {}
    for name, folder in (("rnnlm", f"{tmp}/s2s/save"),
                         ("transformer", f"{tmp}/asr/save")):
        vocab = _lm_hparams(name)["vocab_size"]
        librispeech_asr.prepare_librispeech(
            data, folder, tr_splits=["train-clean-100"],
            dev_splits=["dev-clean"], te_splits=["test-clean"],
            merge_lst=["train-clean-100"], merge_name="train.json")
        tok, seconds = _timed(lambda: SentencePiece(
            folder, vocab, annotation_train=f"{folder}/train.json",
            annotation_read="words", annotation_format="json"))
        tokenizers[name] = (tok.prefix_model_file, tok.sp.get_piece_size(),
                            tok.sp.train_route, seconds)
    words = [w for r in json.load(open(f"{tmp}/s2s/save/train.json")).values()
             for w in r["words"].split()]
    lm_training.write_synthetic_text(f"{tmp}/text", RECIPE_LM_LINES, words,
                                     n_words=(10, 150), seed=SEED)
    write_synthetic_tas(f"{tmp}/TAS", RECIPE_TAS, seconds=(0.5, 1.0),
                        seed=SEED)
    opts = {"noprogressbar": True, "seed": SEED}
    runs = {}
    ops.reset_launch_counters()
    for name, hp, corpus in (
            ("rnnlm", lm_training.HPARAMS_RNNLM, f"{tmp}/text"),
            ("transformer", lm_training.HPARAMS_TRANSFORMER, f"{tmp}/text"),
            ("tas", lm_training.HPARAMS_TAS, f"{tmp}/TAS")):
        out = f"{tmp}/lm_{name}"
        tok_file = tokenizers[name][0] if name in tokenizers else None

        def build(epochs):
            return lm_training.build(corpus, out, {"number_of_epochs": epochs},
                                     opts, hp, tok_file)

        parts, build_s = _timed(lambda: build(1))
        brain, log = parts["brain"], {}
        _instrument(brain, log)
        _, fit_s = _timed(lambda: brain.fit(
            parts["epoch_counter"], parts["train_loader"],
            parts["valid_loader"]))
        saved = _snapshot(brain)
        ckpt = brain.checkpointer.find_checkpoint()
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
        parts2, log2, recovered = _resume_in_fresh_brain(build, 1)
        brain2 = parts2["brain"]
        assert recovered["epoch"] == 1
        n_equal = _same_state(saved, recovered["state"])
        test_loss, test_s = _timed(lambda: brain2.evaluate(
            parts2["test_loader"], min_key="ppl"))
        torch.save({k: v.detach().cpu() for k, v in
                    brain2.modules.model.state_dict().items()},
                   f"{out}/lm.ckpt")
        stats = [dict(brain.stage_stats["VALID"]),
                 dict(brain2.stage_stats["VALID"]),
                 dict(brain2.stage_stats["TEST"])]
        assert all(np.isfinite(v) for st in stats for v in st.values()), stats
        train_s = sum(log["train_s"] + log2["train_s"])
        batches = sum(log["batches"] + log2["batches"])
        runs[name] = {
            "vocab": hp["vocab_size"], "bos_eos": [hp["bos_index"],
                                                   hp["eos_index"]],
            "tokenizer_file": tok_file is not None,
            "pieces": parts["tokenizer"].sp.get_piece_size(),
            "build_s": build_s, "epochs": log["epochs"] + log2["epochs"],
            "batches_per_epoch": log["batches"][0],
            "batch_shapes": sorted(log["shapes"]),
            "train_ms_per_batch": 1e3 * train_s / batches,
            "valid_s": log["valid_s"] + log2["valid_s"], "test_s": test_s,
            "valid_test": stats, "lr_per_epoch": [brain.lr, brain2.lr],
            "fit_first_epoch_s": fit_s, "checkpoint_bytes": ckpt_bytes,
            "save_ms": log["save_ms"] + log2["save_ms"],
            "resume_ms": 1e3 * recovered["seconds"],
            "resume_equal_tensors": n_equal}
        del brain, brain2, parts, parts2
        torch.cuda.empty_cache()
    counts = ops.launch_counters()
    assert all(v == 0 for v in counts.values()), counts
    run = {"phase": "recipe_lm", "tokenizers": tokenizers,
           "lines": RECIPE_LM_LINES, "tas_rows": RECIPE_TAS,
           "precision": "fp32", "runs": runs, "launches": counts,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(run)
    fused = {"seq2seq": _lm_fused_seq2seq(data, tmp),
             "conformer": _lm_fused_conformer(data, tmp)}
    return run, fused


def _lm_fused_seq2seq(data, tmp):
    """The trained RNNLM's ``lm.ckpt`` through ``librispeech_seq2seq.build``
    (full width, bf16): the validation search (beam 8, the yaml's
    options, the LM at 0.5) over the dev set's first batch, capped at
    int(T_enc x ``LM_FUSED_RATIO``) steps; the same search at
    ``lm_weight`` 0 from the same encoder states."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import librispeech_seq2seq

    ops.reset_launch_counters()
    parts = librispeech_seq2seq.build(
        data, f"{tmp}/s2s", {"train_splits": ["train-clean-100"],
                             "max_decode_ratio": LM_FUSED_RATIO},
        {"noprogressbar": True, "lm_ckpt": f"{tmp}/lm_rnnlm/lm.ckpt"})
    brain = parts["brain"]
    assert brain.lm is not None
    batch = brain.prepare_batch(next(iter(parts["valid_loader"])))
    m = brain.modules.eval()
    with torch.no_grad():
        enc = m.enc(m.normalize(m.compute_features(batch["sig"]),
                                batch["sig_lens"]).to(brain.dtype),
                    batch["sig_lens"])
    steps = [0]

    def search(weight):
        brain.hparams.lm_weight = weight
        searcher = brain.make_searcher(brain.hparams.valid_beam_size)
        step = searcher.forward_step

        def counted(*args):
            steps[0] += 1
            return step(*args)

        searcher.forward_step = counted
        steps[0] = 0
        with torch.no_grad():
            return searcher(enc, batch["sig_lens"])

    (hyps, scores), search_s = _timed(lambda: search(0.5))
    n_steps = steps[0]
    _, plain = search(0.0)
    counts = ops.launch_counters()
    assert all(v == 0 for v in counts.values()), counts
    assert np.isfinite(scores).all()
    diff = float(np.abs(np.asarray(scores) - np.asarray(plain)).max())
    assert diff > 1e-3, diff
    run = {"phase": "recipe_lm_fused_seq2seq", "precision": "bf16",
           "batch": int(batch["sig"].shape[0]), "T_enc": int(enc.shape[1]),
           "beam": brain.hparams.valid_beam_size, "lm_weight": 0.5,
           "steps": n_steps, "search_ms": 1e3 * search_s,
           "ms_per_step": 1e3 * search_s / n_steps,
           "scores_vs_lm_weight_0_max_abs_diff": diff,
           "hyp_lengths": [len(h) for h in hyps], "launches": counts}
    emit(run)
    del brain, parts, enc
    torch.cuda.empty_cache()
    return run


def _lm_fused_conformer(data, tmp):
    """The trained TransformerLM's ``lm.ckpt`` through
    ``librispeech_asr.build`` (conformer_small at full width, bf16): the
    validation search (beam 10, full CTC scoring at 0.4, the LM at the
    yaml's 0.6) of the dev set's first batch, capped at int(T_enc x
    ``LM_FUSED_RATIO``) steps, through ``evaluate_batch``; the same search
    at ``lm_weight`` 0."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.recipes import librispeech_asr

    ops.reset_launch_counters()
    parts = librispeech_asr.build(
        data, f"{tmp}/asr", {"train_splits": ["train-clean-100"],
                             "test_splits": ["test-clean"], "num_workers": 0,
                             "max_decode_ratio": LM_FUSED_RATIO},
        {"noprogressbar": True, "lm_ckpt": f"{tmp}/lm_transformer/lm.ckpt"})
    brain = parts["brain"]
    assert brain.lm is not None and brain.config["lm_weight"] == 0.6
    host = next(iter(parts["valid_loader"]))
    batch = brain.prepare_batch(host)
    brain.on_stage_start(Stage.VALID, 1)
    loss, search_s = _timed(lambda: brain.evaluate_batch(batch, Stage.VALID))
    counts = ops.launch_counters()
    with torch.no_grad():
        _, fused = brain.model.transcribe(
            batch["sig"], batch["sig_lens"], beam_size=10, ctc_weight=0.4,
            lm=brain.lm, lm_weight=0.6)
        _, plain = brain.model.transcribe(
            batch["sig"], batch["sig_lens"], beam_size=10, ctc_weight=0.4,
            lm=brain.lm, lm_weight=0.0)
    diff = float(np.abs(np.asarray(fused) - np.asarray(plain)).max())
    assert diff > 1e-3 and np.isfinite(loss), (diff, loss)
    assert counts["depthwise_conv1d"] > 0 and counts["beam_attend_step"] > 0
    run = {"phase": "recipe_lm_fused_conformer", "precision": "bf16",
           "batch": int(batch["sig"].shape[0]), "beam": 10, "lm_weight": 0.6,
           "max_decode_ratio": LM_FUSED_RATIO, "valid_batch_s": search_s,
           "valid_loss": loss,
           "wer": brain.wer_metric.summarize("error_rate"),
           "scores_vs_lm_weight_0_max_abs_diff": diff, "launches": counts}
    emit(run)
    del brain, parts
    torch.cuda.empty_cache()
    return run


def phase_recipe_lm():
    """The LM training recipes (``recipes.lm_training``): see the module
    docstring, phase 20."""
    import shutil
    import tempfile

    runs = {}
    for name in LM_NAMES:
        for precision in ("bf16", "fp32"):
            runs[f"{name}_{precision}"] = _lm_step(name, precision)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        runs["recipe"], fused = _lm_recipe_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs["fused_seq2seq"] = fused["seq2seq"]
    runs["fused_conformer"] = fused["conformer"]
    return runs


# ------------------------------------------------- recipe_timit_seq2seq

TS2S_B, TS2S_SAMPLES, TS2S_U = 8, 48000, 40
# ctc_loss_kd pads the teacher's path to T frames: 2T + 1 lattice states
TS2S_T_PAD = 301
# a seq2seq step runs K3/K4 once, a distillation step twice
TS2S_LAUNCHES = dict(TIMIT_LAUNCHES)
KD_LAUNCHES = dict(TIMIT_LAUNCHES, ctc_alpha=2, ctc_beta_grad=2)
# the float64 card-vs-CPU checks at toy widths (the CTC on its plain
# recursions, which keep float64): the loss relative to the CPU's, each
# gradient's largest difference relative to its scale (floored at 5 % of
# the largest gradient); the control, the card in float32 against the
# same CPU run, must break both.  On an H100 the float64 steps read loss
# 0.0 and gradients 9.5e-16-9.3e-14 (seq2seq, KD, transformer LM), the
# controls 1.8e-8-7.8e-8 and 5.6e-7-1.2e-4: the gradient bound lies 56x
# under the closest control and 1e5 over the readings
TS2S_CARD_TOL = {"loss_float64": 1e-10, "gradients_float64": 1e-8}
TS2S_TOY = dict(cnn_channels=(4, 6), rnn_layers=1, rnn_neurons=8,
                dnn_blocks=1, dnn_neurons=8, emb_size=8, dec_neurons=16,
                attn_dim=12)
LM_TOY = dict(vocab_size=40, d_model=16, nhead=2, num_layers=2, d_ffn=32,
              dropout=0.0)
RECIPE_TS2S_UTTERANCES = {"train": 16, "dev": 4, "test": 4}
RECIPE_TS2S_SECONDS = (1.5, 3.0)
# the chain's depth: 2 of the yaml's 4 recurrent layers, at its widths
RECIPE_TS2S_DEPTH = {"rnn_layers": 2}


def _ts2s_batch(B, samples, U, seed, kd=False, blank_row=None):
    """B synthetic utterances of white noise (every length full) with U / 2
    to U phones in 3..41 each, padded with 0, their bos 1 / eos 2 forms;
    with ``kd`` also a young teacher's posteriors: ``teacher_ctc`` (B, T,
    42), random (its greedy path nearly T long), row ``blank_row`` all
    blank, and ``teacher_seq`` (B, U + 1, 42), rounded through float16 as
    ``save_teachers`` stores them."""
    rng = np.random.default_rng(seed)
    n = rng.integers(U // 2, U + 1, B)
    phn = rng.integers(3, 42, (B, U))
    phn[np.arange(U)[None, :] >= n[:, None]] = 0
    bos = np.concatenate([np.ones((B, 1), np.int64), phn], 1)
    eos = np.concatenate([phn, np.zeros((B, 1), np.int64)], 1)
    eos[np.arange(B), n] = 2
    out = {"sig": rng.normal(size=(B, samples)).astype(np.float32),
           "sig_lens": np.ones(B, np.float32), "phn_encoded": phn,
           "phn_encoded_lens": (n / U).astype(np.float32),
           "phn_encoded_bos": bos, "phn_encoded_eos": eos,
           "phn_encoded_eos_lens": ((n + 1) / (U + 1)).astype(np.float32)}
    if kd:
        T = samples // 160 + 1

        def probs(shape):
            x = np.exp(2.0 * rng.standard_normal(shape))
            return (x / x.sum(-1, keepdims=True)).astype(np.float16)

        ctc = probs((B, T, 42))
        if blank_row is not None:
            ctc[blank_row] = 0
            ctc[blank_row, :, 0] = 1
        out["teacher_ctc"] = ctc.astype(np.float32)
        out["teacher_seq"] = probs((B, U + 1, 42)).astype(np.float32)
    return out


def _teacher_paths(teacher_ctc, lens):
    """The lengths of the teachers' collapsed greedy paths (as
    ``ctc_loss_kd`` builds them), on the host."""
    pred = teacher_ctc.argmax(-1)
    B, T = pred.shape
    prev = np.concatenate([np.full((B, 1), -1), pred[:, :-1]], 1)
    keep = ((pred != prev) & (pred != 0)
            & (np.arange(T)[None, :] < np.round(lens * T)[:, None]))
    return np.maximum(keep.sum(1), 1).tolist()


def _ts2s_brain(kd, precision, dropout, device=None, **hparams):
    from speechbrain_tpu_torch.recipes import timit_kd, timit_seq2seq

    cls = timit_kd.KD if kd else timit_seq2seq.ASR
    hp = dict(timit_kd.HPARAMS_KD if kd else timit_seq2seq.HPARAMS,
              dropout=dropout, **hparams)
    brain = cls(hp, run_opts={"seed": SEED, "precision": precision,
                              "loss_sync_interval": 10, "device": device})
    brain.epoch = 1
    return brain


def _ts2s_step(kd, precision, steps=3, profile=True):
    """The seq2seq (``kd`` False) or distillation step at the yaml's
    widths (LiGRU 4 x 512 bidirectional, decoder GRU 256, attention 256,
    dropout 0.15) on B 8 x 3 s (T 301) with 20-40 phones: a warm-up,
    ``steps`` timed Adadelta steps, the launches a step, the PyTorch calls
    and the profile of one more step."""
    import torch

    from speechbrain_tpu_torch import ops

    brain = _ts2s_brain(kd, precision, 0.15)
    n_params = sum(p.numel() for p in brain.modules.parameters())
    host = _ts2s_batch(TS2S_B, TS2S_SAMPLES, TS2S_U, SEED + 40, kd=kd)
    batch = brain.prepare_batch(host)
    brain.step = 1
    first = float(brain.fit_batch(batch))
    ops.reset_launch_counters()
    ms, losses, peak = _run_steps(brain, batch, steps)
    counts = ops.launch_counters()
    per_step = _per_step(counts, steps)
    assert per_step == (KD_LAUNCHES if kd else TS2S_LAUNCHES), per_step
    assert all(np.isfinite([first] + losses)), losses

    def one_step():
        brain.step += 1
        brain.fit_batch(batch)
        return 1

    run = {"phase": "recipe_timit_seq2seq_step", "kd": kd,
           "precision": precision, "batch": TS2S_B,
           "seconds_audio": TS2S_SAMPLES / 16000, "T_enc": 301,
           "phones": (host["phn_encoded_lens"] * TS2S_U).round().tolist(),
           "parameters": n_params, "steps": steps, "lr": brain.lr,
           "ms_per_step": ms, "utt_per_s": 1e3 * TS2S_B / ms,
           "peak_mem_bytes": peak, "peak_gib": peak / 2 ** 30,
           "launches": counts, "launches_per_step": per_step,
           **({"pytorch_calls_per_step": _pytorch_calls(one_step),
               "profile": _profile(one_step, cpu=False)} if profile else {}),
           "loss_first": first, "loss_last": losses[-1]}
    if kd:
        paths = _teacher_paths(host["teacher_ctc"], host["sig_lens"])
        run.update(teacher_path_lengths=paths,
                   kd_lattice=[TS2S_B, 301, 2 * TS2S_T_PAD + 1],
                   kd_ctc_path="block")
    emit(run)
    del brain, batch
    torch.cuda.empty_cache()
    return run


def _ts2s_routes():
    """Both steps' loss and gradients through K3/K4 and through the plain
    recursions (full width, f32, dropout 0): the seq2seq step with a dummy
    row; the distillation step with the teachers' paths at their full
    collapsed length (the block path) and one row whose teacher is all
    blank (its path one label equal to the blank)."""
    import torch

    out = {}
    for kd in (False, True):
        brain = _ts2s_brain(kd, "fp32", 0.0)
        host = _ts2s_batch(TS2S_B, TS2S_SAMPLES, TS2S_U, SEED + 41, kd=kd,
                           blank_row=TS2S_B - 1 if kd else None)
        if not kd:
            host["batch_mask"] = np.ones(TS2S_B, np.float32)
            host["batch_mask"][-1] = 0.0
        batch = brain.prepare_batch(host)
        cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=1e-3)
        if kd:
            paths = _teacher_paths(host["teacher_ctc"], host["sig_lens"])
            assert paths[-1] == 1 and max(paths) > 128, paths
            cmp.update(teacher_path_lengths=paths,
                       kd_lattice=[TS2S_B, 301, 2 * TS2S_T_PAD + 1],
                       all_blank_rows=1)
        else:
            cmp.update(lattice=[TS2S_B, 301, 2 * TS2S_U + 1], dummy_rows=1)
        out["kd" if kd else "seq2seq"] = cmp
        del brain, batch
        torch.cuda.empty_cache()
    return out


def _card_vs_cpu_step(make, host, names_filter=None):
    """A training step's loss and every gradient, float64, on the card and
    on the CPU from the same weights and batch, and its float32 control
    (the card in float32 against the same CPU run).  ``make(device,
    dtype)`` returns a Brain in that dtype (training mode, no dropout)."""
    import torch

    from speechbrain_tpu_torch.core import Stage

    def run(dev, dtype):
        brain = make(dev, dtype)
        batch = brain.prepare_batch(
            {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in host.items()})
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
        names, params = zip(*brain.modules.named_parameters())
        loss = brain._loss(batch, Stage.TRAIN)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return names, float(loss.detach()), [g.cpu().double() for g in grads]

    names, lp, gp = run("cpu", torch.float64)
    G = max(float(g.abs().max()) for g in gp)

    def errors(loss, grads):
        rel = [float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 0.05 * G)
               for a, b in zip(grads, gp)]
        i = int(np.argmax(rel))
        return abs(loss - lp) / abs(lp), rel[i], names[i]

    _, lc, gc = run("cuda", torch.float64)
    loss_err, grad_err, worst = errors(lc, gc)
    _, lf, gf = run("cuda", torch.float32)
    c_loss, c_grad, c_worst = errors(lf, gf)
    rec = {"loss_card": lc, "loss_cpu": lp,
           "loss_card_vs_cpu_float64": loss_err,
           "gradients_card_vs_cpu_float64": grad_err,
           "gradient_worst": worst, "n_gradients": len(gp),
           "control_card_float32": {"loss": c_loss, "gradients": c_grad,
                                    "gradient_worst": c_worst},
           "tolerance": TS2S_CARD_TOL}
    assert loss_err <= TS2S_CARD_TOL["loss_float64"], rec
    assert grad_err <= TS2S_CARD_TOL["gradients_float64"], rec
    assert c_loss > TS2S_CARD_TOL["loss_float64"], rec
    assert c_grad > TS2S_CARD_TOL["gradients_float64"], rec
    return rec


def _ts2s_card_vs_cpu():
    """Float64 card-vs-CPU checks with their float32 controls at toy
    widths: the TIMIT seq2seq step and the distillation step (3
    utterances of 1 s with ragged lengths, the CTC on its plain
    recursions: the kernels take float32 only) and the transformer LM's
    step (2 layers of 16, B 3 x 12 tokens)."""
    from speechbrain_tpu_torch.recipes.lm_training import (
        HPARAMS_TRANSFORMER, LM)

    def timit(kd):
        def make(dev, dtype):
            brain = _ts2s_brain(kd, "fp32", 0.0, device=dev, **TS2S_TOY)
            brain.modules.to(dtype)
            brain.dtype = dtype
            brain.modules.train()
            return brain.set_kernels(False)
        return make

    out = {}
    for kd in (False, True):
        host = _ts2s_batch(3, 16000, 6, SEED + 42, kd=kd, blank_row=2)
        host["sig_lens"] = np.array([1.0, 0.8, 0.6], np.float32)
        out["kd" if kd else "seq2seq"] = _card_vs_cpu_step(timit(kd), host)

    def make_lm(dev, dtype):
        brain = LM(dict(HPARAMS_TRANSFORMER, **LM_TOY),
                   run_opts={"seed": SEED, "device": dev})
        brain.modules.to(dtype)
        brain.dtype = dtype
        brain.modules.train()
        return brain

    host = _lm_batch(LM_TOY["vocab_size"], SEED + 43, B=3, L=12)
    host["tokens_eos_lens"] = np.array([1.0, 0.75, 0.5], np.float32)
    out["transformer_lm"] = _card_vs_cpu_step(make_lm, host)
    return out


def _recipe_ts2s_run(tmp):
    """The distillation chain through the recipes' entry points on a
    synthetic TIMIT tree, at the yaml's widths and 2 of its 4 recurrent
    layers (bf16, the yaml's): teachers tea0 (ligru) and tea3 (lstm) one
    epoch each (``timit_seq2seq.run``), ``timit_kd.save_teachers``, the
    student (``timit_kd.build_kd``) 1 epoch, epoch 2 in a fresh Brain
    recovered bit for bit, ``evaluate(min_key="PER")`` at beam 16."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import timit_kd, timit_seq2seq
    from speechbrain_tpu_torch.recipes.timit_ctc import write_synthetic_timit

    data = f"{tmp}/TIMIT"
    _, write_s = _timed(lambda: write_synthetic_timit(
        data, RECIPE_TS2S_UTTERANCES, seconds=RECIPE_TS2S_SECONDS, seed=SEED))
    opts = {"noprogressbar": True}
    ops.reset_launch_counters()
    teachers, teacher_runs = [], {}
    for name in ("tea0", "tea3"):
        overrides = dict(timit_seq2seq.TEACHERS[name], **RECIPE_TS2S_DEPTH,
                         number_of_epochs=1)
        brain, seconds = _timed(lambda: timit_seq2seq.run(
            data, f"{tmp}/{name}", overrides, opts))
        teacher_runs[name] = {
            "rnn_class": type(brain.modules.enc.rnn).__name__,
            "run_s": seconds, "valid": brain.stage_stats["VALID"],
            "test": brain.stage_stats["TEST"]}
        teachers.append((f"{tmp}/{name}", overrides))
        del brain
        torch.cuda.empty_cache()
    paths, save_s = _timed(lambda: timit_kd.save_teachers(
        data, f"{tmp}/ensemble", teachers, opts))
    npz = {s: np.load(p) for s, p in paths.items()}
    assert all(a.dtype == np.float16 for z in npz.values()
               for a in (z[k] for k in z.files))

    def build(epochs):
        return timit_kd.build_kd(data, f"{tmp}/kd", f"{tmp}/ensemble",
                                 dict(RECIPE_TS2S_DEPTH,
                                      number_of_epochs=epochs), opts)

    parts, build_s = _timed(lambda: build(1))
    brain, log = parts["brain"], {}
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    saved = _snapshot(brain)
    valid = [dict(brain.stage_stats["VALID"])]
    ckpt = brain.checkpointer.find_checkpoint()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.path.iterdir())
    parts2, log2, recovered = _resume_in_fresh_brain(build, 1)
    brain2 = parts2["brain"]
    assert recovered["epoch"] == 1
    n_equal = _same_state(saved, recovered["state"])
    valid.append(dict(brain2.stage_stats["VALID"]))
    test_loss, test_s = _timed(lambda: brain2.evaluate(
        parts2["test_loader"], min_key="PER"))
    counts = ops.launch_counters()
    test = brain2.stage_stats["TEST"]
    for stats in valid + [test]:
        assert all(np.isfinite(v) for v in stats.values()), stats
    assert counts["ctc_alpha"] > 0 and counts["ctc_beta_grad"] > 0, counts
    assert all(v == 0 for k, v in counts.items()
               if k not in ("ctc_alpha", "ctc_beta_grad")), counts
    train_s = sum(log["train_s"] + log2["train_s"])
    batches = sum(log["batches"] + log2["batches"])
    run = {"phase": "recipe_timit_seq2seq", "utterances":
           RECIPE_TS2S_UTTERANCES, "seconds": RECIPE_TS2S_SECONDS,
           "depth": RECIPE_TS2S_DEPTH, "write_sphere_s": write_s,
           "teachers": teacher_runs, "save_teachers_s": save_s,
           "npz_bytes": {s: os.path.getsize(p) for s, p in paths.items()},
           "npz_utterances": {s: len(z.files) // 2 for s, z in npz.items()},
           "build_s": build_s, "precision": "bf16",
           "epochs": log["epochs"] + log2["epochs"],
           "batches_per_epoch": log["batches"][0],
           "batch_shapes": sorted(log["shapes"]),
           "train_ms_per_batch": 1e3 * train_s / batches,
           "valid_s": log["valid_s"] + log2["valid_s"], "valid": valid,
           "lr_per_epoch": [brain.lr, brain2.lr], "fit_first_epoch_s": fit_s,
           "checkpoint_bytes": ckpt_bytes,
           "save_ms": log["save_ms"] + log2["save_ms"],
           "resume_ms": 1e3 * recovered["seconds"],
           "resume_equal_tensors": n_equal, "test_s": test_s,
           "test": test, "test_loss": test_loss,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts}
    emit(run)
    del brain, brain2, parts, parts2
    torch.cuda.empty_cache()
    return run


def phase_recipe_timit_seq2seq():
    """The TIMIT seq2seq recipe and its distillation
    (``recipes.timit_seq2seq``, ``recipes.timit_kd``): see the module
    docstring, phase 21."""
    import shutil
    import tempfile

    runs = {}
    for kd in (False, True):
        for precision in ("bf16", "fp32"):
            key = f"{'kd' if kd else 'seq2seq'}_{precision}"
            # the KD step in bf16 profiled only (it runs the seq2seq
            # step's modules and the second CTC): see SHORTENED
            runs[key] = _ts2s_step(kd, precision,
                                   profile=kd and precision == "bf16")
    check = {"kernel_vs_plain": _ts2s_routes(),
             "card_vs_cpu": _ts2s_card_vs_cpu()}
    emit(dict(check, phase="recipe_timit_seq2seq_check"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_timit_s2s_")
    try:
        runs["recipe"] = _recipe_ts2s_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs["check"] = check
    return runs


# ---------------------------------- recipe_kspon, recipe_transformer

# a step of the KsponSpeech conformer_medium model (12 conformer layers)
# below the rel-pos gate, and at T_enc 512 (the rel-pos kernels); the
# LibriSpeech transformer.yaml's step (no depthwise convolution)
KSPON_LAUNCHES = dict(TRAIN_LAUNCHES)
KSPON_LONG_LAUNCHES = dict(TRAIN_LONG_LAUNCHES)
TRANSFORMER_LAUNCHES = dict(TRAIN_LAUNCHES, depthwise_conv1d=0,
                            depthwise_conv1d_dw=0)
ASR_B, ASR_SAMPLES, ASR_U = 8, 160000, 40
# the searches' step caps (the random models' hypotheses do not end):
# int(251 x 0.2) = 50 steps timed, 10 to warm up, 20 profiled
ASR_SEARCH_RATIO, ASR_WARM_RATIO, ASR_PROFILE_RATIO = 0.2, 0.04, 0.08
RECIPE_KSPON = {"train": 24, "dev": 4, "eval_clean": 2, "eval_other": 2}
RECIPE_KSPON_SECONDS = (4.0, 10.0)
# the recipes' runs at reduced depth (full width): encoder and decoder
# layers, and the searches' cap
REDUCED = {"num_encoder_layers": 2, "num_decoder_layers": 2,
           "max_decode_ratio": 0.1}


def _recipe_step(phase, make_brain, host, launches, steps=2, profile=False,
                 extra=None, **info):
    """A recipe's training step at full width on one staged batch: a
    warm-up, ``steps`` timed steps, the launches a step (``launches``),
    finite losses, and with ``profile`` the FLOPs and their f32 bound, the
    PyTorch calls and the profile (the card's events) of one more step;
    ``extra(brain, batch)`` returns more entries of the line."""
    import torch

    from speechbrain_tpu_torch import ops

    brain = make_brain()
    n_params = sum(p.numel() for p in brain.modules.parameters())
    batch = brain.prepare_batch(host)
    brain.step = 1
    first = float(brain.fit_batch(batch))  # warm-up, untimed
    ops.reset_launch_counters()
    ms, losses, peak = _run_steps(brain, batch, steps)
    counts = ops.launch_counters()
    per_step = _per_step(counts, steps)
    assert per_step == launches, per_step
    assert all(np.isfinite([first] + losses)), losses
    B = int(host["sig" if "sig" in host else "tokens"].shape[0])
    run = {"phase": phase, "precision": brain.precision, "batch": B,
           **info, "parameters": n_params, "steps": steps,
           "ms_per_step": ms, "utt_per_s": 1e3 * B / ms,
           "peak_mem_bytes": peak, "peak_gib": peak / 2 ** 30,
           "launches": counts, "launches_per_step": per_step,
           "loss_first": first, "loss_last": losses[-1]}
    if profile:
        def one_step():
            brain.step += 1
            brain.fit_batch(batch)
            return 1

        info_flops = {}
        fwd, step_flops = _sep_flops(brain, batch, info_flops)
        run.update(forward_gflop=fwd / 1e9, step_gflop=step_flops / 1e9,
                   f32_bound_ms=_bound_ms(0, step_flops, "float32")[0],
                   pytorch_calls_per_step=_pytorch_calls(one_step),
                   profile=_profile(one_step, cpu=False), **info_flops)
    if extra is not None:
        run.update(extra(brain, batch))
    emit(run)
    del brain, batch
    torch.cuda.empty_cache()
    return run


def _asr_step(phase, cfg, precision, launches, samples=ASR_SAMPLES,
              steps=2, seed=SEED + 40, dropout=0.1, augment=True):
    """A recipe's training step at full width on B 8 synthetic
    utterances of ``samples`` (``_recipe_step``: a warm-up, ``steps``
    timed AdamW steps, the launches a step (``launches``); in bf16 the
    FLOPs and their float32 bound, the PyTorch calls and the profile of
    one more step)."""
    host = _train_batch(ASR_B, samples, ASR_U, seed, cfg["vocab_size"])
    return _recipe_step(
        phase, lambda: _brain(precision, dropout, augment, cfg), host,
        launches, steps=steps, profile=precision == "bf16",  # see SHORTENED
        seconds_audio=samples / cfg["sample_rate"],
        T_enc=(samples // (cfg["sample_rate"] // 100)) // 4 + 1,
        tokens=ASR_U, vocab=cfg["vocab_size"], d_model=cfg["d_model"],
        nhead=cfg["nhead"], encoder=cfg["encoder_module"],
        attention=cfg["attention_type"], transformer_dropout=dropout,
        spec_augment=augment)


def _asr_routes(phase, cfg, samples=ASR_SAMPLES, tol_grad=1e-3):
    """The step's loss and every gradient through the kernels and through
    the plain versions (``_compare_routes``), f32, dropout 0, no
    SpecAugment, at the seeded weights; ``samples`` 327040 gives T_enc
    512, where the rel-pos kernels run."""
    import torch

    brain = _brain("fp32", 0.0, False, cfg)
    host = _train_batch(ASR_B, samples, ASR_U, SEED + 41, cfg["vocab_size"])
    host["sig_lens"] = np.linspace(1.0, 0.8, ASR_B).astype(np.float32)
    batch = brain.prepare_batch(host)
    from speechbrain_tpu_torch import ops

    ops.reset_launch_counters()
    cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=tol_grad)
    run = {"phase": phase, "precision": "fp32", "batch": ASR_B,
           "seconds_audio": samples / cfg["sample_rate"],
           "kernel_vs_plain": cmp, "launches": ops.launch_counters()}
    emit(run)
    del brain, batch
    torch.cuda.empty_cache()
    return run


def _asr_search(phase, cfg, precision, lm_cfg=None, beam=10):
    """The recipe's validation search at full width (beam 10, full CTC
    scoring at 0.4; with ``lm_cfg`` a ``TransformerLM`` of those dims fused
    at 0.6, random weights) over B 8 x 10 s, capped at
    ``ASR_SEARCH_RATIO`` (a warm-up at ``ASR_WARM_RATIO``): steps, encode
    and search ms, K7's launches (the decoder's layers a step), and the
    profile of a search capped at ``ASR_PROFILE_RATIO``; the f32 search
    repeated through the plain versions from the same encoder states
    gives the same hypotheses."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.asr import ConformerASR, build_transformer_lm

    cfg = dict(cfg, max_decode_ratio=ASR_SEARCH_RATIO)
    asr = ConformerASR(cfg, dtype=getattr(torch, precision), seed=SEED)
    with torch.no_grad():
        asr.ctc_lin.bias[cfg["blank_index"]] += BLANK_BIAS
    options = {}
    if lm_cfg is not None:
        options["lm"] = build_transformer_lm(
            dict(lm_cfg, vocab=cfg["vocab_size"]), seed=SEED + 1)
    sig, lens = _synthetic(ASR_B, ASR_SAMPLES, SEED + 42)
    enc = asr.encode(sig, lens)
    asr.config["max_decode_ratio"] = ASR_WARM_RATIO
    _search(asr, enc, lens, beam, 0.4, **options)  # warm-up
    asr.config["max_decode_ratio"] = ASR_SEARCH_RATIO
    ops.reset_launch_counters()
    enc, encode_s = _timed(lambda: asr.encode(sig, lens))
    hyps, scores, steps, search_s = _search(asr, enc, lens, beam, 0.4,
                                            **options)
    counts = ops.launch_counters()
    n_dec = cfg["num_decoder_layers"]
    assert counts["beam_attend_step"] == n_dec * steps, (counts, steps)
    assert np.isfinite(scores).all() and len(hyps) == ASR_B
    head = cfg["d_model"] // cfg["nhead"]
    run = {"phase": phase, "precision": precision, "batch": ASR_B,
           "beam": beam, "rows": ASR_B * beam, "T_enc": int(enc.shape[1]),
           "heads": cfg["nhead"], "head_dim": head, "lm": lm_cfg,
           "steps": steps, "encode_ms": 1e3 * encode_s,
           "search_ms": 1e3 * search_s, "ms_per_step": 1e3 * search_s / steps,
           "utt_per_s": ASR_B / (encode_s + search_s), "launches": counts,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if precision == "float32":
        asr.set_kernels(False)
        hyps_p, _, _, plain_s = _search(asr, enc, lens, beam, 0.4, **options)
        asr.set_kernels(True)
        assert hyps_p == hyps, "hypotheses differ between kernels and plain"
        run.update(hyps_equal_plain=True, plain_search_ms=1e3 * plain_s)
    asr.config["max_decode_ratio"] = ASR_PROFILE_RATIO
    run["profile"] = _profile(
        lambda: _search(asr, enc, lens, beam, 0.4, **options)[2], cpu=False)
    emit(run)
    del asr, enc
    torch.cuda.empty_cache()
    return run


def _recipe_resumed(phase, build, epochs_first, test,
                    kernels=("ctc_alpha", "ctc_beta_grad")):
    """A recipe's ``build`` at its folder for ``epochs_first`` epochs, then
    a fresh Brain from ``build(epochs_first + 1)`` resuming the next epoch
    with the recovered state equal to the saved one bit for bit, then
    ``test(parts)``: the launches counted from 0 over all of it, each of
    ``kernels`` above 0 and every other kernel at 0 when ``kernels`` is
    empty."""
    import torch

    from speechbrain_tpu_torch import ops

    ops.reset_launch_counters()
    parts, build_s = _timed(lambda: build(epochs_first))
    brain, log = parts["brain"], {}
    _instrument(brain, log)
    _, fit_s = _timed(lambda: brain.fit(
        parts["epoch_counter"], parts["train_loader"], parts["valid_loader"]))
    saved = _snapshot(brain)
    parts2, log2, recovered = _resume_in_fresh_brain(build, epochs_first)
    n_equal = _same_state(saved, recovered["state"])
    stats, test_s = _timed(lambda: test(parts2))
    counts = ops.launch_counters()
    assert all(counts[k] > 0 for k in kernels), counts
    assert kernels or not any(counts.values()), counts
    run = {"phase": phase, "build_s": build_s, "fit_s": fit_s,
           "epochs": log["epochs"] + log2["epochs"],
           "batches": log["batches"] + log2["batches"],
           "batch_shapes": sorted(log["shapes"] | log2["shapes"]),
           "train_s_per_epoch": log["train_s"] + log2["train_s"],
           "valid_loss": log["valid_loss"] + log2["valid_loss"],
           "resume_ms": 1e3 * recovered["seconds"],
           "resume_equal_tensors": n_equal, "test_s": test_s,
           "test": stats, "launches": counts,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(run)
    del brain, parts, parts2
    torch.cuda.empty_cache()
    return run


def _recipe_kspon_run(tmp):
    """``ksponspeech_asr`` through ``build``/``fit``/``fit_and_test`` on a
    synthetic corpus at full width and reduced depth (bf16, the recipe's
    accumulation 4 and 300 s batches, SpecAugment): epoch 1, epoch 2 in a
    fresh Brain, both test splits with their WER files."""
    from speechbrain_tpu_torch.recipes import ksponspeech_asr as recipe
    from speechbrain_tpu_torch.recipes import ksponspeech_prepare as prep
    from speechbrain_tpu_torch.recipes import librispeech_asr

    data, out = f"{tmp}/KsponSpeech", f"{tmp}/out"
    prep.write_synthetic_kspon(data, RECIPE_KSPON,
                               seconds=RECIPE_KSPON_SECONDS, seed=SEED)
    prep.convert_all(data)

    def build(epochs):
        return recipe.build(data, out, dict(REDUCED, number_of_epochs=epochs),
                            {"noprogressbar": True})

    def test(parts):
        brain = librispeech_asr.fit_and_test(parts)  # 2 of 2 epochs done
        for split in RECIPE_KSPON:
            if split.startswith("eval"):
                text = open(f"{out}/wer_{split}.txt").read()
                assert text.count("\nScored ") == 2, split
        for stats in brain.test_stats.values():
            assert all(np.isfinite(v) for v in stats.values()), stats
        return brain.test_stats

    return _recipe_resumed("recipe_kspon_run", build, 1, test)


def phase_recipe_kspon():
    """KsponSpeech conformer_medium (``recipes.ksponspeech_asr``) at full
    width: its training step on B 8 x 10 s in bf16 and f32, one f32 step
    at T_enc 512 (K5/K6 at dh 64) through the kernels and the plain
    versions, the LM-fused search at beam 10 (K7 at H4 Dh64) in f32, the
    recipe run at reduced depth with a resume, and the LM yaml's step
    (d_model 768) in bf16."""
    import shutil
    import tempfile

    from speechbrain_tpu_torch.recipes import ksponspeech_asr

    cfg = ksponspeech_asr.HPARAMS
    runs = {p: _asr_step("recipe_kspon_step", cfg, p, KSPON_LAUNCHES)
            for p in ("bf16", "fp32")}
    runs["long"] = _asr_routes("recipe_kspon_long", cfg, samples=160 * 2044)
    long_counts = runs["long"]["launches"]
    assert long_counts["relpos_attention"] == 12, long_counts
    assert long_counts["relpos_attention_bwd"] == 12, long_counts
    runs["search_fp32"] = _asr_search("recipe_kspon_search", cfg, "float32",
                                      cfg["lm_model"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kspon_")
    try:
        runs["recipe"] = _recipe_kspon_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs["lm"] = _lm_step("kspon", "bf16", steps=2)
    return runs


def phase_recipe_transformer():
    """LibriSpeech ``transformer.yaml`` (``librispeech_asr.
    HPARAMS_TRANSFORMER``: the transformer encoder with regularMHA at
    d_model 512, 6 decoder layers) at full width: the training step on B
    8 x 10 s in bf16 and f32, kernel vs plain route (K3/K4) in f32, and
    the validation search with its LM (d_model 512) at beam 10 (K7 at H8
    Dh64) in f32."""
    from speechbrain_tpu_torch.recipes import librispeech_asr

    cfg = librispeech_asr.HPARAMS_TRANSFORMER
    runs = {p: _asr_step("recipe_transformer_step", cfg, p,
                         TRANSFORMER_LAUNCHES) for p in ("bf16", "fp32")}
    runs["routes"] = _asr_routes("recipe_transformer_check", cfg)
    runs["search_fp32"] = _asr_search("recipe_transformer_search", cfg,
                                      "float32", cfg["lm_model"])
    return runs


# ----------------------------------------------------------- recipe_corpora

RECIPE_AISHELL = {"train": 12, "dev": 2, "test": 2}
RECIPE_CORPORA_SECONDS = (2.0, 5.0)
# the seq2seq recipes' runs: the CRDNN at reduced depth (1 LSTM layer),
# full width
REDUCED_S2S = {"rnn_layers": 1, "max_decode_ratio": 0.1}


def _corpora_aishell(tmp):
    """The three AISHELL-1 yamls through ``aishell_asr``'s builds at reduced
    depth, each 1 epoch then a resumed one, then the test."""
    from speechbrain_tpu_torch.recipes import aishell_asr as recipe
    from speechbrain_tpu_torch.recipes import aishell_prepare as prep

    data = f"{tmp}/aishell"
    prep.write_synthetic_aishell(data, RECIPE_AISHELL,
                                 seconds=RECIPE_CORPORA_SECONDS, seed=SEED)
    runs = {}
    for name, build_family, hp, reduced in (
            ("seq2seq", recipe.build_seq2seq, recipe.HPARAMS_SEQ2SEQ,
             REDUCED_S2S),
            ("conformer", recipe.build_transformer, recipe.HPARAMS_CONFORMER,
             REDUCED),
            ("transformer", recipe.build_transformer,
             recipe.HPARAMS_TRANSFORMER, REDUCED)):
        out = f"{tmp}/aishell_{name}"

        def build(epochs, build_family=build_family, hp=hp, out=out,
                  reduced=reduced):
            return build_family(data, out, dict(reduced,
                                                number_of_epochs=epochs),
                                {"noprogressbar": True}, hp)

        def test(parts):
            parts["brain"].evaluate(parts["test_loader"], min_key="CER")
            stats = parts["brain"].stage_stats["TEST"]
            assert set(stats) == {"loss", "CER"} and np.isfinite(
                stats["loss"]), stats
            return stats

        runs[name] = _recipe_resumed(f"recipe_corpora_aishell_{name}", build,
                                     1, test)
    return runs


def _corpora_switchboard(tmp):
    """The Switchboard yamls through ``switchboard_asr``'s builds (seq2seq,
    transformer) and ``lm_training.run`` (both LM yamls) at reduced
    depth, each 1 epoch then a resumed one, then eval2000."""
    from speechbrain_tpu_torch.recipes import librispeech_asr, lm_training
    from speechbrain_tpu_torch.recipes import switchboard_asr as recipe
    from speechbrain_tpu_torch.recipes import switchboard_prepare as prep

    data = f"{tmp}/Switchboard"
    prep.write_synthetic_switchboard(data, conversations=6, turns=3,
                                     eval_segments=2,
                                     seconds=RECIPE_CORPORA_SECONDS, seed=SEED)
    runs = {}
    for name, build_family, reduced in (
            ("seq2seq", recipe.build_seq2seq, REDUCED_S2S),
            ("transformer", recipe.build_transformer, REDUCED)):
        out = f"{tmp}/swbd_{name}"

        def build(epochs, build_family=build_family, out=out,
                  reduced=reduced):
            return build_family(data, out, dict(reduced, dev_conversations=1,
                                                number_of_epochs=epochs),
                                {"noprogressbar": True})

        def test(parts, out=out, name=name):
            brain = parts["brain"]
            if name == "transformer":
                brain = librispeech_asr.fit_and_test(parts)
                stats = brain.test_stats["eval2000"]
                assert open(f"{out}/wer_eval2000.txt").read().startswith(
                    "%WER")
            else:
                brain.evaluate(parts["test_loaders"]["eval2000"],
                               min_key="WER")
                stats = brain.stage_stats["TEST"]
            assert np.isfinite(stats["loss"]), stats
            return stats

        runs[name] = _recipe_resumed(f"recipe_corpora_switchboard_{name}",
                                     build, 1, test)
    lm = {"num_layers": 2, "batch_size": 8, "dev_conversations": 1,
          "number_of_epochs": 2}
    # both LMs on the transformer recipe's tokenizer (its token ids)
    tokenizer = (f"{tmp}/swbd_transformer/save/"
                 f"{recipe.HPARAMS_TRANSFORMER['vocab_size']}_"
                 f"{recipe.HPARAMS_TRANSFORMER['token_type']}.model.json")
    for name, hp in (("lm", lm_training.HPARAMS_SWITCHBOARD),
                     ("lm_finetune", lm_training.HPARAMS_SWITCHBOARD_FINETUNE)):
        brain, seconds = _timed(lambda hp=hp, name=name: lm_training.run(
            data, f"{tmp}/swbd_{name}", lm, {"noprogressbar": True}, hp,
            tokenizer_file=tokenizer))
        stats = brain.stage_stats
        assert np.isfinite(stats["TEST"]["loss"]), stats
        runs[name] = {"phase": f"recipe_corpora_switchboard_{name}",
                      "seconds": seconds, "stats": stats, "lr": brain.lr,
                      "launches": {}}
        emit(runs[name])
    return runs


def phase_recipe_corpora():
    """The AISHELL-1 (seq2seq, conformer_small, train_ASR_transformer) and
    Switchboard (seq2seq, transformer, LM, LM finetune) recipes through
    their ``build``/``run`` at full width and reduced depth, bf16, each
    resumed in a fresh Brain bit for bit."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpora_")
    try:
        runs = {f"aishell_{k}": v for k, v in _corpora_aishell(tmp).items()}
        runs.update({f"switchboard_{k}": v
                     for k, v in _corpora_switchboard(tmp).items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ------------------------------------------------------- recipe_commonvoice

# B 12 x 6 s (a typical CommonVoice clip; the transducer's yaml batch of
# 8), the characters of its sentence: up to 80 with the spaces (the
# seq2seq and transducer targets), 60 without (the conformer's)
CV_B, CV_T_B, CV_SAMPLES = 12, 8, 96000
CV_U, CV_U_NOSPACE = 80, 60
CV_S2S_LAUNCHES = dict(TIMIT_LAUNCHES)
CV_CONFORMER_LAUNCHES = dict(TRAIN_LAUNCHES)
CV_TRANSDUCER_LAUNCHES = dict(CRDNN_LAUNCHES)
RECIPE_CV = {"train": 12, "dev": 2, "test": 2}
# 3-8 words a clip: CommonVoice reads ~15 characters a second, and a
# clip's characters must fit its 40 ms encoder frames (T_enc 76-151)
RECIPE_CV_SECONDS = (3.0, 6.0)


def _char_batch(B, samples, U, V, seed, blank=False):
    """B synthetic utterances of white noise (lengths 1.0 down to 0.9)
    with U - 12 to U characters (ids 3..V-1) padded with 0: ``tokens``,
    ``tokens_bos`` ([1] + tokens), ``tokens_eos`` (tokens + [2]), or with
    ``blank`` ``tokens_blank`` ([0] + tokens), and their relative
    lengths."""
    rng = np.random.default_rng(seed)
    n = U - 3 * (np.arange(B) % 5)
    tok = rng.integers(3, V, (B, U))
    tok[np.arange(U)[None, :] >= n[:, None]] = 0
    host = {"sig": rng.normal(size=(B, samples)).astype(np.float32),
            "sig_lens": np.linspace(1.0, 0.9, B).astype(np.float32),
            "tokens": tok, "tokens_lens": (n / U).astype(np.float32)}
    if blank:
        host["tokens_blank"] = np.concatenate(
            [np.zeros((B, 1), tok.dtype), tok], 1)
        return host
    eos = tok.copy()
    eos = np.concatenate([eos, np.zeros((B, 1), tok.dtype)], 1)
    eos[np.arange(B), n] = 2
    host.update(tokens_bos=np.concatenate([np.ones((B, 1), tok.dtype), tok],
                                          1),
                tokens_eos=eos,
                tokens_eos_lens=((n + 1) / (U + 1)).astype(np.float32))
    return host


def _cv_brain(family, precision, dropout):
    """A CommonVoice recipe's Brain at full width (the yaml's values; the
    seq2seq's ``train_fr.yaml``)."""
    from speechbrain_tpu_torch.recipes import aishell_asr
    from speechbrain_tpu_torch.recipes import commonvoice_asr as cv

    opts = {"seed": SEED, "precision": precision, "loss_sync_interval": 10}
    if family == "seq2seq":
        brain = aishell_asr.CharSeq2SeqBrain(
            dict(cv.HPARAMS_SEQ2SEQ_FR, dropout=dropout), run_opts=opts)
        brain.epoch = 1
        return brain
    if family == "conformer":
        cfg = dict(cv.HPARAMS_TRANSFORMER_FR, transformer_dropout=dropout)
        return aishell_asr.CharCTCBrain(cfg, seed=SEED, run_opts=opts,
                                        hparams={"lr": cfg["lr_adam"]})
    cfg = dict(cv.HPARAMS_TRANSDUCER_FR, dropout=dropout)
    return cv.CharTransducerBrain(cfg, seed=SEED, run_opts=opts, hparams=cfg)


def _cv_routes(family, host):
    """The step's loss and every gradient through the kernels and the
    plain versions (``_compare_routes``), f32, dropout 0, ragged lengths."""
    import torch

    brain = _cv_brain(family, "fp32", 0.0)
    batch = brain.prepare_batch(host)
    # floor 1e-2: a gradient that is zero analytically (the CRDNN's DNN
    # bias before its training-mode BatchNorm) is held to 1e-5 G, as the
    # CPU tests hold it to JAX's; over the seq2seq step's 7212 frames its
    # rounding noise reached 3.6e-6 G on an H100
    cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=1e-3,
                          floor=1e-2)
    run = {"phase": f"recipe_commonvoice_{family}_check",
           "kernel_vs_plain": cmp}
    emit(run)
    del brain, batch
    torch.cuda.empty_cache()
    return run


def _cv_recipes(tmp):
    """The three CommonVoice families on a synthetic French folder at full
    width and reduced depth (the seq2seq's LSTM and the transducer's LiGRU
    1 layer, the conformer 2 + 2 layers), each 1 epoch, then epoch 2 in a
    fresh Brain recovered bit for bit, then its test split (the greedy
    CTC CER; the transducer's beam-4 PER, its blank logit +4 so that the
    random model's beam takes a few rounds a frame)."""
    import torch

    from speechbrain_tpu_torch.recipes import common_voice_prepare as prep
    from speechbrain_tpu_torch.recipes import commonvoice_asr as cv

    data = f"{tmp}/fr"
    prep.write_synthetic_common_voice(data, RECIPE_CV, language="fr",
                                      seconds=RECIPE_CV_SECONDS,
                                      n_words=(3, 8), seed=SEED)
    runs = {}
    for name, build_family, hp, reduced, metric, kernels in (
            ("seq2seq", cv.build_seq2seq, cv.HPARAMS_SEQ2SEQ_FR, REDUCED_S2S,
             "CER", ("ctc_alpha", "ctc_beta_grad")),
            ("conformer", cv.build_transformer, cv.HPARAMS_TRANSFORMER_FR,
             REDUCED, "CER", ("depthwise_conv1d", "depthwise_conv1d_dw",
                              "ctc_alpha", "ctc_beta_grad")),
            ("transducer", cv.build_transducer, cv.HPARAMS_TRANSDUCER_FR,
             {"rnn_layers": 1}, "PER", ("transducer_alpha",
                                        "transducer_beta_grad"))):
        out = f"{tmp}/cv_{name}"

        def build(epochs, build_family=build_family, hp=hp, out=out,
                  reduced=reduced, name=name):
            parts = build_family(data, out, dict(reduced,
                                                 number_of_epochs=epochs),
                                 {"noprogressbar": True}, hp)
            if name == "transducer":
                with torch.no_grad():
                    parts["brain"].model.out_lin.bias[0] += (
                        TRANSDUCER_BLANK_BIAS)
            return parts

        def test(parts, metric=metric):
            parts["brain"].evaluate(parts["test_loader"], min_key=metric)
            stats = parts["brain"].stage_stats["TEST"]
            assert set(stats) == {"loss", metric} and np.isfinite(
                stats["loss"]), stats
            return stats

        runs[name] = _recipe_resumed(f"recipe_commonvoice_{name}_run", build,
                                     1, test, kernels)
    return runs


def phase_recipe_commonvoice():
    """The CommonVoice recipes (``recipes.commonvoice_asr``) at full width:
    the seq2seq ``train_fr.yaml`` step (CRDNN 3 CNN blocks, LSTM 5 x 1024,
    the location-attention GRU of 1024, 500 outputs; K3/K4 once a step)
    and the conformer ``transformer/train_fr.yaml`` step (d 144, 12 + 4
    layers, 4300 outputs; K1 24, K2 12, K3 1, K4 1 a step) on B 12 x 6 s
    in bf16 and f32, the ``transducer/train_fr.yaml`` step (Fbank 40 with
    deltas, CRDNN-LiGRU 4 x 512, V 40; K8/K9 once a step) on B 8 x 6 s in
    f32 and in bf16 (see SHORTENED: not profiled); each family's f32 step
    through
    the kernels and the plain versions; then the three recipes through
    their builds on a synthetic French folder, resumed bit for bit."""
    import shutil
    import tempfile

    s2s_host = _char_batch(CV_B, CV_SAMPLES, CV_U, 500, SEED + 50)
    conf_host = _char_batch(CV_B, CV_SAMPLES, CV_U_NOSPACE, 4300, SEED + 51)
    t_host = _char_batch(CV_T_B, CV_SAMPLES, CV_U, 40, SEED + 52, blank=True)
    info = {"seconds_audio": CV_SAMPLES / 16000}
    runs = {}
    for precision in ("bf16", "fp32"):
        runs[f"seq2seq_{precision}"] = _recipe_step(
            "recipe_commonvoice_seq2seq_step",
            lambda: _cv_brain("seq2seq", precision, 0.15), s2s_host,
            CV_S2S_LAUNCHES, profile=False, T=601,  # see SHORTENED
            ctc_lattice=[CV_B, 601, 2 * CV_U + 1], **info)
        runs[f"conformer_{precision}"] = _recipe_step(
            "recipe_commonvoice_conformer_step",
            lambda: _cv_brain("conformer", precision, 0.1), conf_host,
            CV_CONFORMER_LAUNCHES, profile=precision == "bf16", T_enc=151,
            ctc_lattice=[CV_B, 151, 2 * CV_U_NOSPACE + 1], **info)
    for precision in ("fp32", "bf16"):
        runs[f"transducer_{precision}"] = _recipe_step(
            "recipe_commonvoice_transducer_step",
            lambda: _cv_brain("transducer", precision, 0.15), t_host,
            CV_TRANSDUCER_LAUNCHES, profile=False,  # see SHORTENED
            T=601, lattice=[CV_T_B, 601, CV_U + 1], **info)
    runs["seq2seq_check"] = _cv_routes("seq2seq", s2s_host)
    runs["conformer_check"] = _cv_routes("conformer", conf_host)
    runs["transducer_check"] = _cv_routes("transducer", t_host)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cv_")
    try:
        runs.update({f"{k}_recipe": v for k, v in _cv_recipes(tmp).items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ---------------------------------------------------------------- recipe_slu

SLU_LAUNCHES = {k: 0 for k in TRAIN_LAUNCHES}
RECIPE_SLU = {"fsc": {"train": 24, "valid": 8, "test": 8},
              "slurp": {"train": 16, "devel": 4, "test": 4},
              "tas": {"train-synth": 16, "train-real": 8, "dev-real": 8,
                      "test-real": 8}}
RECIPE_SLU_SECONDS = (1.5, 3.0)


def _nlu_batch(B, L, U, V, seed):
    """B rows of L - 10 to L transcript pieces and U - 6 to U semantics
    pieces (ids 3..V-1, padded with 0), bos 1 and eos 2."""
    rng = np.random.default_rng(seed)
    host = _char_batch(B, 0, U, V, seed)
    del host["sig"], host["sig_lens"]
    n = L - 2 * (np.arange(B) % 6)
    tt = rng.integers(3, V, (B, L))
    tt[np.arange(L)[None, :] >= n[:, None]] = 0
    host.update(transcript_tokens=tt,
                transcript_tokens_lens=(n / L).astype(np.float32))
    return host


def _slu_recipes(tmp):
    """FSC, SLURP and Timers and Such direct, the SLURP NLU and Timers and
    Such decoupled and multistage through their builds on synthetic
    corpora at full width (the yamls' precisions), each 1 epoch, then
    epoch 2 in a fresh Brain recovered bit for bit, then its test split:
    the exact-match accuracy (the loss for SLURP direct)."""
    from speechbrain_tpu_torch.recipes import fsc_prepare, slurp_prepare
    from speechbrain_tpu_torch.recipes import slu_direct as direct
    from speechbrain_tpu_torch.recipes import slu_nlu as nlu
    from speechbrain_tpu_torch.recipes import timers_and_such_prepare as tas

    writers = {"fsc": fsc_prepare.write_synthetic_fsc,
               "slurp": slurp_prepare.write_synthetic_slurp,
               "tas": tas.write_synthetic_tas}
    for corpus, counts in RECIPE_SLU.items():
        writers[corpus](f"{tmp}/{corpus}", counts,
                        seconds=RECIPE_SLU_SECONDS, seed=SEED)
    runs = {}
    for name, build_family, hp in (
            ("fsc_direct", direct.build, direct.HPARAMS_FSC),
            ("slurp_direct", direct.build, direct.HPARAMS_SLURP),
            ("tas_direct", direct.build, direct.HPARAMS_TAS),
            ("slurp_nlu", nlu.build, nlu.HPARAMS_SLURP_NLU),
            ("tas_decoupled", nlu.build, nlu.HPARAMS_TAS_DECOUPLED),
            ("tas_multistage", nlu.build, nlu.HPARAMS_TAS_MULTISTAGE)):
        data, out = f"{tmp}/{hp['corpus']}", f"{tmp}/out_{name}"

        def build(epochs, build_family=build_family, hp=hp, data=data,
                  out=out):
            return build_family(data, out, {"number_of_epochs": epochs},
                                {"noprogressbar": True}, hp)

        def test(parts):
            brain = parts["brain"]
            best = "max_key" if brain.metric == "acc" else "min_key"
            brain.evaluate(parts["test_loader"], **{best: brain.metric})
            stats = brain.stage_stats["TEST"]
            assert all(np.isfinite(v) for v in stats.values()), stats
            assert set(stats) == ({"loss", "acc"} if hp["search"]
                                  else {"loss"}), stats
            return stats

        runs[name] = _recipe_resumed(f"recipe_slu_{name}_run", build, 1,
                                     test, kernels=())
    return runs


def phase_recipe_slu():
    """The spoken language understanding recipes (``recipes.slu_direct``,
    ``recipes.slu_nlu``): the direct step (FSC yaml: CRDNN 64/128, LSTM 2
    x 256, the content-attention GRU of 256, 58 pieces; f32) on B 8 x 3 s
    and the NLU step (SLURP NLU yaml: the bidirectional GRU 2 x 256, the
    key-value-attention GRU of 256; bf16) on B 16 text rows, no kernel a
    step; then the six recipes through their builds, resumed bit for
    bit."""
    import shutil
    import tempfile

    from speechbrain_tpu_torch.recipes import slu_direct as direct
    from speechbrain_tpu_torch.recipes import slu_nlu as nlu

    opts = {"seed": SEED, "loss_sync_interval": 10}
    runs = {"direct": _recipe_step(
        "recipe_slu_direct_step",
        lambda: direct.SLUBrain(direct.HPARAMS_FSC, run_opts=opts),
        _char_batch(8, 48000, 24, 58, SEED + 60), SLU_LAUNCHES,
        profile=True, seconds_audio=3.0, tokens=24),
        "nlu": _recipe_step(
        "recipe_slu_nlu_step",
        lambda: nlu.NLUBrain(nlu.HPARAMS_SLURP_NLU, run_opts=opts),
        _nlu_batch(16, 30, 24, 58, SEED + 61), SLU_LAUNCHES, profile=True,
        transcript_tokens=30, tokens=24)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slu_")
    try:
        runs.update({f"{k}_recipe": v for k, v in _slu_recipes(tmp).items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ----------------------------------------------------------------- recipe_st

# Taigi: B 32 x 6 s (hop 20 ms: T_enc 76), up to 30 Mandarin pieces a
# translation; Fisher: B 8 x 10 s (hop 10 ms: T_enc 251), up to 48
# English pieces a translation and 48 pieces a Spanish transcript
ST_TAIGI_B, ST_TAIGI_SAMPLES, ST_TAIGI_U = 32, 96000, 30
ST_FISHER_B, ST_FISHER_SAMPLES, ST_FISHER_U = 8, 160000, 48
ST_TAIGI_LAUNCHES = {k: 0 for k in TRAIN_LAUNCHES}
ST_FISHER_LAUNCHES = dict(TRANSFORMER_LAUNCHES)
ST_CONFORMER_LAUNCHES = dict(TRAIN_LAUNCHES)
# the Taigi search: beam 10 run to a fixed 50 steps (no early exit)
ST_SEARCH_B, ST_SEARCH_BEAM, ST_SEARCH_STEPS = 32, 10, 50
# the recipes' corpora: Taigi splits 80 utterances 64/8/8 (two batches of
# 32 an epoch: the accumulation window of 2 closes at the epoch's end)
RECIPE_ST_TAIGI = 80
RECIPE_ST_FISHER = {"train": 16, "dev": 4, "test": 4}
RECIPE_ST_REDUCED = {"num_encoder_layers": 2, "num_decoder_layers": 2,
                     "max_decode_ratio": 0.25, "valid_search_interval": 1}


def _st_batch(fisher, seed):
    """A synthetic ST batch: Taigi's ``tokens*`` (B 32 x 6 s, V 5000), or
    Fisher's ``trans_tokens*`` and ``src_tokens*`` (B 8 x 10 s, V 500)."""
    if not fisher:
        return _char_batch(ST_TAIGI_B, ST_TAIGI_SAMPLES, ST_TAIGI_U, 5000,
                           seed)
    host = _char_batch(ST_FISHER_B, ST_FISHER_SAMPLES, ST_FISHER_U, 500, seed)
    src = _char_batch(ST_FISHER_B, 0, ST_FISHER_U, 500, seed + 1)
    out = {k.replace("tokens", "trans_tokens"): v for k, v in host.items()}
    out.update({k.replace("tokens", "src_tokens"): v for k, v in src.items()
                if "tokens" in k})
    return out


def _st_brain(name, precision, dropout):
    """An ST recipe's Brain at full width (the yaml's values)."""
    from speechbrain_tpu_torch.recipes import fisher_st, taigi_st

    hp, cls = {"taigi": (taigi_st.HPARAMS, taigi_st.ST),
               "transformer": (fisher_st.HPARAMS_TRANSFORMER, fisher_st.ST),
               "conformer": (fisher_st.HPARAMS_CONFORMER, fisher_st.ST)}[name]
    cfg = dict(hp, transformer_dropout=dropout)
    return cls(cfg, seed=SEED, run_opts={
        "seed": SEED, "precision": precision, "loss_sync_interval": 10,
        "grad_accumulation_factor": cfg["grad_accumulation_factor"]})


def _st_search():
    """The Taigi recipe's search as it validates (float32, the JAX
    script's dtype): B 32 x 6 s at beam 10, no CTC, length normalization,
    run to a fixed 50 steps; ms a step, K7's launches (6 decoder layers a
    step), the hypotheses through the kernels equal to those through the
    plain versions from the same encoder states, and the profile of one
    search."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import taigi_st
    from speechbrain_tpu_torch.st import SpeechTranslator

    st = SpeechTranslator(taigi_st.HPARAMS, seed=SEED)
    sig, lens = _synthetic(ST_SEARCH_B, ST_TAIGI_SAMPLES, SEED + 72)
    enc = st.encode(sig, lens)
    T = int(enc.shape[1])
    st.config["max_decode_ratio"] = (ST_SEARCH_STEPS + 0.5) / T
    searcher = st.make_searcher(ST_SEARCH_BEAM)

    def search():
        out = searcher.search_device(enc, lens, early_exit=False)
        return searcher.finalize(*out)

    search()  # warm-up
    ops.reset_launch_counters()
    (hyps, scores), search_s = _timed(search)
    counts = ops.launch_counters()
    n_dec = taigi_st.HPARAMS["num_decoder_layers"]
    assert counts["beam_attend_step"] == n_dec * ST_SEARCH_STEPS, counts
    assert np.isfinite(scores).all() and len(hyps) == ST_SEARCH_B
    st.set_kernels(False)
    (hyps_p, _), plain_s = _timed(search)
    st.set_kernels(True)
    assert hyps_p == hyps, "hypotheses differ between kernels and plain"
    run = {"phase": "recipe_st_search", "precision": "float32",
           "batch": ST_SEARCH_B, "beam": ST_SEARCH_BEAM,
           "rows": ST_SEARCH_B * ST_SEARCH_BEAM, "T_enc": T,
           "heads": st.config["nhead"],
           "head_dim": st.config["d_model"] // st.config["nhead"],
           "steps": ST_SEARCH_STEPS, "search_ms": 1e3 * search_s,
           "ms_per_step": 1e3 * search_s / ST_SEARCH_STEPS,
           "plain_search_ms": 1e3 * plain_s, "hyps_equal_plain": True,
           "mean_hyp_len": float(np.mean([len(h) for h in hyps])),
           "launches": counts,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    run["profile"] = _profile(lambda: (search(), ST_SEARCH_STEPS)[1],
                              cpu=False)
    emit(run)
    del st, enc
    torch.cuda.empty_cache()
    return run


# the Fisher conformer's kernel-vs-plain gradients: the encoder side
# (front end, conformer, CTC head) within 1e-3 of scale; the two relu
# decoders, their embeddings and heads within 2e-2.  There a last-bit
# change in the encoder states flips relu units at their kink: the plain
# route's own gradients moved by up to 4.5e-3 of scale in the ASR
# decoder's last FFN when every depthwise tap was nudged by one float32
# ulp (this step at full width on a CPU, seed 0), and the phase measures
# the same control on the card ("plain_vs_nudged_plain")
ST_DECODER_SIDE = ("transformer.asr_decoder.", "transformer.st.decoder.",
                   "transformer.custom_asr_tgt_module.",
                   "transformer.st.custom_tgt_module.", "seq_lin.", "asr_lin.")
ST_ROUTE_TOL = {"encoder": 1e-3, "decoder": 2e-2}


def _nudged(params, factor):
    """A context: each of ``params`` times ``factor`` (one float32 ulp
    away), put back bit for bit after."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def nudged():
        saved = [p.detach().clone() for p in params]
        with torch.no_grad():
            for p in params:
                p.mul_(factor)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, w in zip(params, saved):
                    p.copy_(w)
    return nudged()


def _nudged_taps(brain, factor):
    """``_nudged`` on every conformer convolution module's depthwise
    taps."""
    from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
        ConvolutionModule)

    return _nudged([m.depthwise_kernel for m in brain.modules.modules()
                    if isinstance(m, ConvolutionModule)], factor)


def _st_routes():
    """The Fisher conformer step's loss and every gradient through K1-K4
    and through the plain versions, f32, dropout 0, ragged lengths: the
    loss within 1e-5 relative, each gradient within ``ST_ROUTE_TOL`` of
    its scale (``_grad_rel_errs``); beside them the control, the plain
    route against itself with the taps nudged one ulp up and down."""
    import torch

    from speechbrain_tpu_torch import ops

    brain = _st_brain("conformer", "fp32", 0.0)
    batch = brain.prepare_batch(_st_batch(True, SEED + 71))
    ops.reset_launch_counters()
    loss_k, grads_k = _loss_and_grads(brain.set_kernels(True), batch)
    counts = ops.launch_counters()
    assert counts == ST_CONFORMER_LAUNCHES, counts
    loss_p, grads_p = _loss_and_grads(brain.set_kernels(False), batch)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    assert loss_err <= 1e-5, f"loss kernel vs plain: rel {loss_err} > 1e-5"
    control = {}
    for name, factor in (("up", 1 + 2.0 ** -23), ("down", 1 - 2.0 ** -23)):
        with _nudged_taps(brain, factor):
            errs = _grad_rel_errs(_loss_and_grads(brain, batch)[1], grads_p)
        worst = max(errs, key=errs.get)
        control[name] = {"grad_max_rel_err": errs[worst], "grad_worst": worst}
    brain.set_kernels(True)
    errs = _grad_rel_errs(grads_k, grads_p)
    sides = {}
    for name, err in errs.items():
        side = ("decoder" if name.startswith(ST_DECODER_SIDE)
                else "encoder")
        if err > sides.get(side, (0.0, None))[0]:
            sides[side] = (err, name)
    for side, (err, name) in sides.items():
        assert err <= ST_ROUTE_TOL[side], (
            f"gradient kernel vs plain ({side} side): {name} {err} > "
            f"{ST_ROUTE_TOL[side]}")
    cmp = {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "loss_rel_err": loss_err, "loss_tol": 1e-5,
           "grad_tol": ST_ROUTE_TOL, "n_grads": len(errs),
           "grad_max_rel_err_by_side": {
               side: {"err": err, "worst": name}
               for side, (err, name) in sides.items()}}
    run = {"phase": "recipe_st_conformer_check", "precision": "fp32",
           "batch": ST_FISHER_B, "kernel_vs_plain": cmp,
           "plain_vs_nudged_plain": control, "launches": counts}
    emit(run)
    del brain, batch
    torch.cuda.empty_cache()
    return run


def _st_recipes(tmp):
    """The Taigi and both Fisher recipes through their builds on synthetic
    corpora at full width and reduced depth (2 + 2 layers; the searches
    capped at a quarter of T_enc, the Taigi one every epoch), each 1
    epoch, then epoch 2 in a fresh Brain recovered bit for bit, then its
    test (Taigi: BLEU and CER with their files; Fisher: the argmax BLEU);
    then the two tokenizer recipes at their yamls' sizes."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.recipes import fisher_st, taigi_st
    from speechbrain_tpu_torch.recipes.taigi_prepare import (
        write_synthetic_taigi)

    write_synthetic_taigi(f"{tmp}/taigi", RECIPE_ST_TAIGI,
                          seconds=(2.0, 6.0), n_chars=(8, 30),
                          n_distinct=3000, seed=SEED)
    fisher_st.write_synthetic_fisher(f"{tmp}/fisher", RECIPE_ST_FISHER,
                                     seconds=(4.0, 10.0), n_words=(8, 20),
                                     seed=SEED)
    runs = {}
    for name, recipe, data, hp, kernels, metrics in (
            ("taigi", taigi_st, "taigi", taigi_st.HPARAMS,
             ("beam_attend_step",), {"loss", "BLEU", "CER"}),
            ("fisher_transformer", fisher_st, "fisher",
             fisher_st.HPARAMS_TRANSFORMER, ("ctc_alpha", "ctc_beta_grad"),
             {"loss", "BLEU"}),
            ("fisher_conformer", fisher_st, "fisher",
             fisher_st.HPARAMS_CONFORMER,
             ("depthwise_conv1d", "depthwise_conv1d_dw", "ctc_alpha",
              "ctc_beta_grad"), {"loss", "BLEU"})):
        out = f"{tmp}/out_{name}"

        def build(epochs, recipe=recipe, data=data, hp=hp, out=out):
            return recipe.build(f"{tmp}/{data}", out,
                                dict(RECIPE_ST_REDUCED,
                                     number_of_epochs=epochs),
                                {"noprogressbar": True}, hp)

        def test(parts, metrics=metrics, out=out, name=name):
            parts["brain"].evaluate(parts["test_loader"], max_key="BLEU")
            stats = parts["brain"].stage_stats["TEST"]
            assert set(stats) == metrics and all(
                np.isfinite(v) for v in stats.values()), stats
            if name == "taigi":
                assert open(f"{out}/bleu.txt").read().startswith("BLEU: ")
                assert "%WER" in open(f"{out}/cer.txt").read()
            return stats

        runs[name] = _recipe_resumed(f"recipe_st_{name}_run", build, 1, test,
                                     kernels)
    ops.reset_launch_counters()
    taigi_tok, taigi_s = _timed(lambda: taigi_st.train_tokenizer(
        f"{tmp}/taigi", f"{tmp}/tok_taigi"))
    fisher_tok, fisher_s = _timed(lambda: fisher_st.train_tokenizer(
        f"{tmp}/fisher", f"{tmp}/tok_fisher"))
    run = {"phase": "recipe_st_tokenizers",
           "taigi_char5k": {"seconds": taigi_s,
                            "pieces": taigi_tok.sp.get_piece_size(),
                            "route": taigi_tok.sp.train_route},
           "fisher_bpe_1k": {"seconds": fisher_s,
                             "pieces": fisher_tok.sp.get_piece_size(),
                             "route": fisher_tok.sp.train_route},
           "launches": ops.launch_counters()}
    assert not any(run["launches"].values()), run
    emit(run)
    runs["tokenizers"] = run
    torch.cuda.empty_cache()
    return runs


def phase_recipe_st():
    """The speech translation recipes (``recipes.taigi_st``,
    ``recipes.fisher_st``) at full width: the Taigi step (transformer
    12 + 6 at d 256, regularMHA, V 5000; no port kernel) on B 32 x 6 s in
    bf16 and f32, two micro-batches timed (one optimizer step at the
    yaml's accumulation 2); the Fisher transformer step (K3/K4 once a
    step) and conformer step (K1 24, K2 12, K3 1, K4 1) on B 8 x 10 s in
    f32 (the yamls') and bf16; the conformer's f32 step through the
    kernels and the plain versions; the Taigi search at beam 10 over B 32
    for 50 steps (K7 6 a step), kernel = plain; then the three recipes
    and the two tokenizer recipes on synthetic corpora."""
    import shutil
    import tempfile

    taigi_host = _st_batch(False, SEED + 70)
    fisher_host = _st_batch(True, SEED + 71)
    runs = {}
    for precision in ("bf16", "fp32"):
        runs[f"taigi_{precision}"] = _recipe_step(
            "recipe_st_taigi_step",
            lambda: _st_brain("taigi", precision, 0.1), taigi_host,
            ST_TAIGI_LAUNCHES, profile=precision == "bf16",
            seconds_audio=ST_TAIGI_SAMPLES / 16000, T_enc=76,
            tokens=ST_TAIGI_U, grad_accumulation_factor=2)
    for name, launches in (("transformer", ST_FISHER_LAUNCHES),
                           ("conformer", ST_CONFORMER_LAUNCHES)):
        for precision in ("fp32", "bf16"):
            runs[f"{name}_{precision}"] = _recipe_step(
                f"recipe_st_fisher_{name}_step",
                lambda: _st_brain(name, precision, 0.1), fisher_host,
                launches, profile=precision == "bf16",
                seconds_audio=ST_FISHER_SAMPLES / 16000, T_enc=251,
                tokens=ST_FISHER_U,
                ctc_lattice=[ST_FISHER_B, 251, 2 * ST_FISHER_U + 1])
    runs["conformer_check"] = _st_routes()
    runs["search_fp32"] = _st_search()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_st_")
    try:
        runs.update({f"{k}_recipe": v for k, v in _st_recipes(tmp).items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


W2V_LAUNCHES = dict({k: 0 for k in TRAIN_LAUNCHES}, ctc_alpha=1,
                    ctc_beta_grad=1)
W2V_PRETRAIN_LAUNCHES = {k: 0 for k in TRAIN_LAUNCHES}
# the steps: LibriSpeech B 6 x 10 s (T 498 latents; ~15 characters a
# second: 150, so 2U+1 301 takes the kernels' block path), AISHELL-1 B 8 x
# 6 s (T 298, 40 characters, 5000 outputs: the warp path), the
# pretraining B 16 x 10 s
W2V_LS = {"B": 6, "samples": 160000, "U": 150, "V": 29}
W2V_AISHELL = {"B": 8, "samples": 96000, "U": 40, "V": 5000}
W2V_PRETRAIN_B, W2V_PRETRAIN_SAMPLES = 16, 160000
# the kernel-vs-plain gradients of the LibriSpeech step, a share of each
# tensor's scale (``_grad_rel_errs``); the control nudges the first
# convolution's weights one float32 ulp
W2V_ROUTE_TOL = 1e-3
# the recipes on synthetic corpora: full width, 2 encoder layers; the
# pretraining recipe at batches of 4 without accumulation (8 clips: two
# batches an epoch, so each epoch steps and a resume is bit for bit at the
# epoch's end)
RECIPE_W2V = {"train": 8, "dev": 2, "test": 2}
RECIPE_W2V_SECONDS = (3.0, 12.0)
RECIPE_W2V_REDUCED = {"encoder_layers": 2}
RECIPE_W2V_PRETRAIN = {"encoder_layers": 2, "batch_size": 4,
                       "grad_accumulation_factor": 1}


def _w2v_brain(name, precision, dropout, device=None):
    """A wav2vec recipe's Brain at full width (the yaml's values):
    "librispeech" and "aishell" the CTC ``ASR``, "pretrain" the
    ``W2VBrain`` at the yaml's accumulation 8."""
    from speechbrain_tpu_torch.recipes import wav2vec_ctc, wav2vec_pretrain

    cls, hp = {"librispeech": (wav2vec_ctc.ASR,
                               wav2vec_ctc.HPARAMS_LIBRISPEECH),
               "aishell": (wav2vec_ctc.ASR, wav2vec_ctc.HPARAMS_AISHELL),
               "pretrain": (wav2vec_pretrain.W2VBrain,
                            wav2vec_pretrain.HPARAMS)}[name]
    cfg = dict(hp, encoder_dropout=dropout)
    return cls(cfg, run_opts={
        "seed": SEED, "precision": precision, "loss_sync_interval": 10,
        "device": device,
        "grad_accumulation_factor": cfg.get("grad_accumulation_factor", 1)})


def _w2v_flops(B, samples, hp, head, pretrain=False):
    """The step's products counted from the shapes (the convolutions, the
    projections, the attention's two products, the FFN, the DNN and the
    head; with ``pretrain`` the quantiser's logits and projection and the
    contrastive dot products instead of the DNN), as (forward, step = 3 x
    forward) FLOPs: the check of ``FlopCounterMode``'s count."""
    n, cin, conv = samples, 1, 0
    for c, k, s in zip(hp["latent_channels"], hp["kernel_sizes"],
                       hp["strides"]):
        n = (n - k) // s + 1
        conv += 2 * B * n * c * cin * k
        cin = c
    T, d, f = n, hp["embedding_dim"], hp["d_ffn"]
    enc = 2 * B * T * cin * d + hp["encoder_layers"] * (
        8 * B * T * d * d + 4 * B * T * T * d + 4 * B * T * d * f)
    if pretrain:
        gv = hp["quantiser_groups"] * hp["quantiser_vars"]
        t = hp["target_dim"]
        rest = (2 * B * T * cin * gv + 2 * B * T * gv * t + 2 * B * T * t * t
                + 2 * B * T * d * t
                + 2 * (hp["num_negatives"] + 1) * B * T * t)
    else:
        h = hp["dnn_neurons"]
        rest = 2 * B * T * (d * h + (hp["dnn_blocks"] - 1) * h * h + h * head)
    forward = conv + enc + rest
    return {"analytic_forward_gflop": forward / 1e9,
            "analytic_conv_gflop": conv / 1e9,
            "analytic_encoder_gflop": enc / 1e9,
            "analytic_step_gflop": 3 * forward / 1e9,
            "analytic_f32_bound_ms": _bound_ms(0, 3 * forward, "float32")[0]}


def _w2v_ctc_step(name, precision):
    """A CTC recipe's step at full width (``_recipe_step``: a warm-up, 2
    timed Adadelta steps, K3/K4 once a step, the profile, FLOPs and calls
    of one more) with the FLOPs counted from the shapes beside it."""
    from speechbrain_tpu_torch.recipes import wav2vec_ctc

    shape = W2V_LS if name == "librispeech" else W2V_AISHELL
    hp = (wav2vec_ctc.HPARAMS_LIBRISPEECH if name == "librispeech"
          else wav2vec_ctc.HPARAMS_AISHELL)
    host = _char_batch(shape["B"], shape["samples"], shape["U"], shape["V"],
                       SEED + 80)
    T = 498 if name == "librispeech" else 298
    return _recipe_step(
        f"recipe_wav2vec_{name}_step",
        lambda: _w2v_brain(name, precision, 0.1), host, W2V_LAUNCHES,
        profile=True, seconds_audio=shape["samples"] / 16000, T=T,
        tokens=shape["U"], vocab=shape["V"],
        ctc_lattice=[shape["B"], T, 2 * shape["U"] + 1],
        **_w2v_flops(shape["B"], shape["samples"], hp, hp["output_neurons"]))


def _w2v_pretrain_step(precision):
    """The pretraining step at full width on B 16 x 10 s: a warm-up
    micro-batch, 2 timed micro-batches (forward and backward into the
    accumulated gradients, no optimizer step at the yaml's accumulation 8),
    then one micro-batch that closes the window (the clip and the AdamW
    step) timed apart; no port kernel; the profile, FLOPs and calls of a
    micro-batch, the FLOPs counted from the shapes beside them, and the
    loss's parts."""
    from speechbrain_tpu_torch.recipes import wav2vec_pretrain

    hp = wav2vec_pretrain.HPARAMS
    rng = np.random.default_rng(SEED + 81)
    host = {"sig": rng.normal(size=(W2V_PRETRAIN_B, W2V_PRETRAIN_SAMPLES)
                              ).astype(np.float32)}

    def optimizer_step(brain, batch):
        steps0 = brain.optimizer_step
        brain.step = hp["grad_accumulation_factor"] - 1
        ms, losses, peak = _run_steps(brain, batch, 1)
        assert brain.optimizer_step == steps0 + 1 and np.isfinite(losses[0])
        return {"optimizer_step_ms": ms, "optimizer_step_peak_gib":
                peak / 2 ** 30, "micro_batches_a_step":
                hp["grad_accumulation_factor"], "lr_after": brain.lr}

    return _recipe_step(
        "recipe_wav2vec_pretrain_step",
        lambda: _w2v_brain("pretrain", precision, 0.1), host,
        W2V_PRETRAIN_LAUNCHES, profile=True, extra=optimizer_step,
        seconds_audio=W2V_PRETRAIN_SAMPLES / 16000, T=498,
        negatives=hp["num_negatives"],
        **_w2v_flops(W2V_PRETRAIN_B, W2V_PRETRAIN_SAMPLES, hp, 0,
                     pretrain=True))


def _w2v_routes():
    """The LibriSpeech CTC step's loss and every gradient through K3/K4
    and through the plain recursions (f32, dropout 0, ragged lengths, the
    block path): the loss within 1e-5 relative, each gradient within
    ``W2V_ROUTE_TOL`` of its scale; beside them the control, the plain
    route against itself with the first convolution's weights nudged one
    ulp up and down."""
    import torch

    from speechbrain_tpu_torch import ops

    brain = _w2v_brain("librispeech", "fp32", 0.0)
    host = _char_batch(W2V_LS["B"], W2V_LS["samples"], W2V_LS["U"],
                       W2V_LS["V"], SEED + 82)
    batch = brain.prepare_batch(host)
    ops.reset_launch_counters()
    cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=W2V_ROUTE_TOL)
    counts = ops.launch_counters()
    assert counts["ctc_alpha"] == 1 and counts["ctc_beta_grad"] == 1, counts
    brain.set_kernels(False)
    _, grads_p = _loss_and_grads(brain, batch)
    control = {}
    conv0 = brain.modules.extractor.convs[0].weight
    for name, factor in (("up", 1 + 2.0 ** -23), ("down", 1 - 2.0 ** -23)):
        with _nudged([conv0], factor):
            errs = _grad_rel_errs(_loss_and_grads(brain, batch)[1], grads_p)
        worst = max(errs, key=errs.get)
        control[name] = {"grad_max_rel_err": errs[worst], "grad_worst": worst}
    brain.set_kernels(True)
    run = {"phase": "recipe_wav2vec_librispeech_check", "precision": "fp32",
           "batch": W2V_LS["B"], "ctc_lattice": [W2V_LS["B"], 498,
                                                 2 * W2V_LS["U"] + 1],
           "kernel_vs_plain": cmp, "plain_vs_nudged_plain": control,
           "launches": counts}
    emit(run)
    del brain, batch
    torch.cuda.empty_cache()
    return run


def _w2v_recipes(tmp):
    """The two pretraining recipes and one CTC recipe a corpus through
    their builds on synthetic corpora at full width and reduced depth
    (``RECIPE_W2V_REDUCED``, ``RECIPE_W2V_PRETRAIN``), each 1 epoch, then
    epoch 2 in a fresh Brain recovered bit for bit, then the CTC recipes'
    test with its WER file."""
    from speechbrain_tpu_torch.recipes import aishell_prepare
    from speechbrain_tpu_torch.recipes import common_voice_prepare
    from speechbrain_tpu_torch.recipes import dvoice_prepare
    from speechbrain_tpu_torch.recipes import librispeech_asr
    from speechbrain_tpu_torch.recipes import switchboard_prepare
    from speechbrain_tpu_torch.recipes import wav2vec_ctc as ctc
    from speechbrain_tpu_torch.recipes import wav2vec_pretrain as pre

    seconds = RECIPE_W2V_SECONDS
    librispeech_asr.write_synthetic_librispeech(
        f"{tmp}/ls", {"train-clean-100": 8, "dev-clean": 2, "test-clean": 2},
        seconds=seconds, n_words=(4, 12), lexicon_size=200, seed=SEED)
    dvoice_prepare.write_synthetic_dvoice(f"{tmp}/dvoice", RECIPE_W2V,
                                          seconds=seconds, seed=SEED)
    common_voice_prepare.write_synthetic_common_voice(
        f"{tmp}/cv", RECIPE_W2V, language="en", seconds=(3.0, 9.0),
        seed=SEED)
    aishell_prepare.write_synthetic_aishell(f"{tmp}/aishell", RECIPE_W2V,
                                            seconds=seconds, seed=SEED)
    switchboard_prepare.write_synthetic_switchboard(
        f"{tmp}/swbd", conversations=4, turns=2, eval_segments=2,
        seconds=(4.0, 8.0), n_words=(2, 5), seed=SEED)
    ls = {"train_splits": ["train-clean-100"]}
    runs = {}
    for name, recipe, data, hp, reduced in (
            ("pretrain_librispeech", pre, "ls", pre.HPARAMS,
             dict(RECIPE_W2V_PRETRAIN, **ls)),
            ("pretrain_commonvoice", pre, "cv", pre.HPARAMS_COMMONVOICE,
             RECIPE_W2V_PRETRAIN),
            ("ctc_librispeech", ctc, "ls", ctc.HPARAMS_LIBRISPEECH,
             dict(RECIPE_W2V_REDUCED, **ls)),
            ("ctc_dvoice", ctc, "dvoice", ctc.HPARAMS_DVOICE_DAR,
             RECIPE_W2V_REDUCED),
            ("ctc_commonvoice", ctc, "cv", ctc.HPARAMS_COMMONVOICE_EN,
             RECIPE_W2V_REDUCED),
            ("ctc_aishell", ctc, "aishell", ctc.HPARAMS_AISHELL,
             RECIPE_W2V_REDUCED),
            ("ctc_switchboard", ctc, "swbd", ctc.HPARAMS_SWITCHBOARD,
             dict(RECIPE_W2V_REDUCED, dev_conversations=1))):
        out = f"{tmp}/out_{name}"

        def build(epochs, recipe=recipe, data=data, hp=hp, out=out,
                  reduced=reduced):
            return recipe.build(f"{tmp}/{data}", out,
                                dict(reduced, number_of_epochs=epochs),
                                {"noprogressbar": True}, hp)

        def test(parts, out=out, pretrain=recipe is pre):
            brain = parts["brain"]
            if pretrain:
                stats = brain.stage_stats["VALID"]
            else:
                brain.evaluate(parts["test_loader"], min_key="WER")
                stats = brain.stage_stats["TEST"]
                assert set(stats) == {"loss", "WER", "CER"}, stats
                assert open(f"{out}/wer.txt").read().startswith("%WER")
            assert all(np.isfinite(v) for v in stats.values()), stats
            return stats

        kernels = () if recipe is pre else ("ctc_alpha", "ctc_beta_grad")
        runs[name] = _recipe_resumed(f"recipe_wav2vec_{name}_run", build, 1,
                                     test, kernels)
        runs[name]["reduced"] = reduced
    return runs


def phase_recipe_wav2vec():
    """The native wav2vec 2.0 recipes (``recipes.wav2vec_ctc``,
    ``recipes.wav2vec_pretrain``) at full width: the LibriSpeech CTC step
    (B 6 x 10 s, T 498, 150 characters: K3/K4 on the block path) in bf16
    (the yaml's) and f32, the AISHELL-1 CTC step (B 8 x 6 s, V 5000) in
    f32, the pretraining step (B 16 x 10 s, bf16; a micro-batch, and one
    closing the accumulation window timed apart); the LibriSpeech f32 step
    through the kernels and the plain versions with the ulp-nudge control;
    then the two pretraining recipes and a CTC recipe a corpus on
    synthetic corpora, each resumed bit for bit."""
    import shutil
    import tempfile

    runs = {}
    for precision in ("bf16", "fp32"):
        runs[f"librispeech_{precision}"] = _w2v_ctc_step("librispeech",
                                                         precision)
    runs["aishell_fp32"] = _w2v_ctc_step("aishell", "fp32")
    runs["pretrain_bf16"] = _w2v_pretrain_step("bf16")
    runs["librispeech_check"] = _w2v_routes()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_w2v_")
    try:
        runs.update({f"{k}_recipe": v for k, v in _w2v_recipes(tmp).items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ------------------------------------------------ recipe_wav2vec_families

# the steps' batches at the yamls' widths: CommonVoice B 12 x 6 s (T 298
# latents at 50 Hz, 80 characters, V 500), TIMIT B 8 x 3 s (T 148; 20-40
# phones; V 42 seq2seq, 40 transducer, whose CRDNN keeps the Fbank's T
# 301), AISHELL-1 B 8 x 6 s (T 298, 40 characters, V 4300), IWSLT22 B 2 x
# 10 s (T 498, 30 pieces of its 1000)
W2VF = {"commonvoice": dict(B=12, samples=96000, U=80, V=500, T=298),
        "timit": dict(B=8, samples=48000, U=40, V=42, T=148),
        "aishell": dict(B=8, samples=96000, U=40, V=4300, T=298),
        "iwslt": dict(B=2, samples=160000, U=30, V=1000, T=498),
        "crdnn_transducer": dict(B=8, samples=48000, U=40, V=40, T=301),
        "w2v_transducer": dict(B=8, samples=48000, U=40, V=40, T=148)}
W2VF_LAUNCHES = {"commonvoice": W2V_LAUNCHES, "timit": W2V_LAUNCHES,
                 "aishell": TRAIN_LAUNCHES, "iwslt": W2V_PRETRAIN_LAUNCHES,
                 "crdnn_transducer": CRDNN_LAUNCHES,
                 "w2v_transducer": CRDNN_LAUNCHES}
# the recipes on synthetic corpora: full width at 2 encoder layers (the
# CRDNN's LiGRU 2 of its 4), no gradient accumulation (a window open at an
# epoch's end is not checkpointed), the TIMIT and Timers and Such searches
# capped at a tenth of T
W2VF_CLIPS = {"train": 6, "dev": 2, "test": 2}
W2VF_SECONDS = (2.0, 5.0)
W2VF_REDUCED = {"encoder_layers": 2, "max_decode_ratio": 0.1}


def _w2vf_brain(name, precision, dropout=None):
    """A new recipe's Brain at full width (the yaml's values; CommonVoice
    ``train_fr_with_wav2vec.yaml``), each optimizer step at once but
    IWSLT22's (the yaml's accumulation 4: a step is a micro-batch);
    ``dropout`` replaces every dropout rate (None: the yaml's)."""
    from speechbrain_tpu_torch.recipes import aishell_asr
    from speechbrain_tpu_torch.recipes import commonvoice_asr as cv
    from speechbrain_tpu_torch.recipes import iwslt22_st, timit_seq2seq
    from speechbrain_tpu_torch.recipes import timit_transducer as tt

    opts = {"seed": SEED, "precision": precision, "loss_sync_interval": 10}
    hp = {"commonvoice": cv.HPARAMS_WAV2VEC_FR,
          "timit": timit_seq2seq.HPARAMS_WAV2VEC,
          "aishell": aishell_asr.HPARAMS_WAV2VECT,
          "iwslt": iwslt22_st.HPARAMS, "crdnn_transducer": tt.HPARAMS,
          "w2v_transducer": tt.HPARAMS_WAV2VEC}[name]
    if dropout is not None:
        hp = dict(hp, **{k: dropout for k in ("dropout", "encoder_dropout",
                                              "transformer_dropout")
                         if k in hp})
    if name == "commonvoice":
        return aishell_asr.CharSeq2SeqBrain(hp, run_opts=opts)
    if name == "timit":
        return timit_seq2seq.ASR(hp, run_opts=opts)
    if name == "aishell":
        return aishell_asr.CharCTCBrain(
            hp, seed=SEED, run_opts=dict(opts, grad_accumulation_factor=1),
            hparams={"lr": hp["lr_adam"]})
    if name == "iwslt":
        return iwslt22_st.ST(hp, run_opts=opts)
    cls = (tt.W2VTransducerBrain if name == "w2v_transducer"
           else cv.CharTransducerBrain)
    return cls(hp, seed=SEED, run_opts=opts, hparams=hp)


def _w2vf_host(name, seed):
    shape = W2VF[name]
    if name == "timit":
        return _ts2s_batch(shape["B"], shape["samples"], shape["U"], seed)
    return _char_batch(shape["B"], shape["samples"], shape["U"], shape["V"],
                       seed, blank=name.endswith("transducer"))


def _w2vf_step(name, precision, profile):
    """A new recipe's step at full width (``_recipe_step``: a warm-up, 2
    timed steps or micro-batches, the launches a step; with ``profile``
    the FLOPs, the PyTorch calls and the profile of one more)."""
    shape = W2VF[name]
    lattice = {}
    if name in ("commonvoice", "timit", "aishell"):
        lattice["ctc_lattice"] = [shape["B"], shape["T"], 2 * shape["U"] + 1]
    elif name.endswith("transducer"):
        lattice["lattice"] = [shape["B"], shape["T"], shape["U"] + 1]
    return _recipe_step(
        f"recipe_wav2vec_families_{name}_step",
        lambda: _w2vf_brain(name, precision), _w2vf_host(name, SEED + 90),
        W2VF_LAUNCHES[name], profile=profile,
        seconds_audio=shape["samples"] / 16000, T=shape["T"],
        tokens=shape["U"], vocab=shape["V"], **lattice)


def _w2vf_routes(name):
    """The step's loss and every gradient through the kernels and the
    plain versions (``_compare_routes``: f32, dropout 0, ragged lengths;
    the loss within 1e-5 relative, each gradient within 1e-3 of its scale,
    floor 1e-2 as ``_cv_routes``), beside the control: the plain route
    against itself with the extractor's first convolution one float32
    ulp up and down."""
    import torch

    from speechbrain_tpu_torch import ops

    brain = _w2vf_brain(name, "fp32", 0.0)
    batch = brain.prepare_batch(_w2vf_host(name, SEED + 91))
    ops.reset_launch_counters()
    cmp = _compare_routes(brain, batch, tol_loss=1e-5, tol_grad=1e-3,
                          floor=1e-2)
    counts = ops.launch_counters()
    brain.set_kernels(False)
    _, grads_p = _loss_and_grads(brain, batch)
    control = {}
    conv0 = brain.modules.extractor.convs[0].weight
    for label, factor in (("up", 1 + 2.0 ** -23), ("down", 1 - 2.0 ** -23)):
        with _nudged([conv0], factor):
            errs = _grad_rel_errs(_loss_and_grads(brain, batch)[1], grads_p,
                                  1e-2)
        worst = max(errs, key=errs.get)
        control[label] = {"grad_max_rel_err": errs[worst],
                          "grad_worst": worst}
    brain.set_kernels(True)
    run = {"phase": f"recipe_wav2vec_families_{name}_check",
           "precision": "fp32", "batch": W2VF[name]["B"],
           "kernel_vs_plain": cmp, "plain_vs_nudged_plain": control,
           "launches": counts}
    emit(run)
    del brain, batch
    torch.cuda.empty_cache()
    return run


def _w2vf_recipes(tmp):
    """The 11 yamls through their builds on synthetic corpora at full width
    and ``W2VF_REDUCED`` depth: the four CommonVoice languages, TIMIT's
    seq2seq and its two transducers, SLURP and Timers and Such direct,
    AISHELL-1's wav2vect and IWSLT22; each 1 epoch, epoch 2 in a fresh Brain
    recovered bit for bit, then the test from the best checkpoint (the
    transducers' blank logit +4, so that the random model's beam takes a
    few rounds a frame)."""
    import torch

    from speechbrain_tpu_torch.recipes import aishell_asr, aishell_prepare
    from speechbrain_tpu_torch.recipes import common_voice_prepare
    from speechbrain_tpu_torch.recipes import commonvoice_asr as cv
    from speechbrain_tpu_torch.recipes import iwslt22_prepare, iwslt22_st
    from speechbrain_tpu_torch.recipes import slu_direct, slurp_prepare
    from speechbrain_tpu_torch.recipes import timers_and_such_prepare
    from speechbrain_tpu_torch.recipes import timit_ctc, timit_seq2seq
    from speechbrain_tpu_torch.recipes import timit_transducer as tt

    clips, seconds = W2VF_CLIPS, W2VF_SECONDS
    for lang in ("en", "fr", "it", "rw"):
        common_voice_prepare.write_synthetic_common_voice(
            f"{tmp}/cv_{lang}", clips, language=lang, seconds=seconds,
            seed=SEED)
    # 10 train clips of 3-6 s hold the 39 phones (10 a second at most)
    timit_ctc.write_synthetic_timit(f"{tmp}/timit", dict(clips, train=10),
                                    seconds=(3.0, 6.0), seed=SEED)
    slurp_prepare.write_synthetic_slurp(
        f"{tmp}/slurp", {"train": 6, "devel": 2, "test": 2},
        seconds=seconds, seed=SEED)
    timers_and_such_prepare.write_synthetic_tas(
        f"{tmp}/tas", {"train-synth": 4, "train-real": 2, "dev-real": 2,
                       "test-real": 2}, seconds=seconds, seed=SEED)
    aishell_prepare.write_synthetic_aishell(f"{tmp}/aishell", clips,
                                            seconds=seconds, seed=SEED)
    iwslt22_prepare.write_synthetic_iwslt22(
        f"{tmp}/iwslt", {"train": 6, "valid": 2, "test": 2},
        seconds=(4.0, 10.0), shared=1, seed=SEED)
    ctc = ("ctc_alpha", "ctc_beta_grad")
    rnnt = ("transducer_alpha", "transducer_beta_grad")
    recipes = [(f"commonvoice_{lang}", cv.build_wav2vec, f"cv_{lang}",
                cv.WAV2VEC_YAMLS[f"train_{lang}_with_wav2vec.yaml"],
                W2VF_REDUCED, ("CER", "min_key"), ctc)
               for lang in ("en", "fr", "it", "rw")]
    recipes += [
        ("timit_seq2seq", timit_seq2seq.build, "timit",
         timit_seq2seq.HPARAMS_WAV2VEC, W2VF_REDUCED, ("PER", "min_key"),
         ctc),
        ("timit_transducer", tt.build, "timit", tt.HPARAMS,
         {"rnn_layers": 2}, ("PER", "min_key"), rnnt),
        ("timit_transducer_wav2vec", tt.build, "timit", tt.HPARAMS_WAV2VEC,
         W2VF_REDUCED, ("PER", "min_key"), rnnt),
        ("slurp_direct", slu_direct.build, "slurp",
         slu_direct.HPARAMS_SLURP_WAV2VEC, W2VF_REDUCED, ("loss", "min_key"),
         ()),
        ("tas_direct", slu_direct.build, "tas",
         slu_direct.HPARAMS_TAS_WAV2VEC, W2VF_REDUCED, ("acc", "max_key"),
         ()),
        ("aishell_wav2vect", aishell_asr.build_transformer, "aishell",
         aishell_asr.HPARAMS_WAV2VECT,
         {"num_encoder_layers": 2, "num_decoder_layers": 2,
          "grad_accumulation_factor": 1}, ("CER", "min_key"),
         ("depthwise_conv1d", "depthwise_conv1d_dw") + ctc),
        ("iwslt22", iwslt22_st.build, "iwslt", iwslt22_st.HPARAMS,
         {"keep_n_layers": 2, "grad_accumulation_factor": 1},
         ("BLEU", "max_key"), ())]
    runs = {}
    for name, build_fn, data, hp, reduced, (metric, best), kernels in (
            recipes):
        out = f"{tmp}/out_{name}"

        def build(epochs, build_fn=build_fn, data=data, hp=hp, out=out,
                  reduced=reduced, name=name):
            parts = build_fn(f"{tmp}/{data}", out,
                             dict(reduced, number_of_epochs=epochs),
                             {"noprogressbar": True}, hp)
            if "transducer" in name:
                with torch.no_grad():
                    parts["brain"].modules.out_lin.bias[0] += (
                        TRANSDUCER_BLANK_BIAS)
            return parts

        def test(parts, metric=metric, best=best):
            brain = parts["brain"]
            brain.evaluate(parts["test_loader"], **{best: metric})
            stats = brain.stage_stats["TEST"]
            assert metric in stats and all(
                np.isfinite(v) for v in stats.values()), stats
            return stats

        runs[name] = _recipe_resumed(
            f"recipe_wav2vec_families_{name}_run", build, 1, test, kernels)
        runs[name]["reduced"] = reduced
    return runs


def phase_recipe_wav2vec_families():
    """The wav2vec 2.0 yamls of the ported families and TIMIT's
    transducers at full width: the CommonVoice wav2vec seq2seq step (B 12
    x 6 s, f32: the yaml's), TIMIT's wav2vec seq2seq step (B 8 x 3 s),
    AISHELL-1's wav2vect step (B 8 x 6 s; K1 24, K2 12, K3 1, K4 1 a
    step), the IWSLT22 micro-batch (B 2 x 10 s, f32; no port kernel) and
    TIMIT's CRDNN and wav2vec transducer steps (B 8 x 3 s; K8/K9 once a
    step), the bf16 yamls' in bf16 and f32, each with ms/step and peak
    memory, and in its yaml's precision the profile and PyTorch calls of
    one more step; the CommonVoice, AISHELL-1 and wav2vec transducer steps
    through the kernels and the plain versions with the ulp-nudge control;
    then the 11 recipes on synthetic corpora (``_w2vf_recipes``), each
    resumed bit for bit."""
    import shutil
    import tempfile

    runs = {}
    for name, precisions in (("commonvoice", ("fp32",)),
                             ("timit", ("bf16", "fp32")),
                             ("aishell", ("bf16", "fp32")),
                             ("iwslt", ("fp32",)),
                             ("crdnn_transducer", ("bf16", "fp32")),
                             ("w2v_transducer", ("bf16", "fp32"))):
        for precision in precisions:
            runs[f"{name}_{precision}"] = _w2vf_step(
                name, precision, profile=precision == precisions[0])
    for name in ("commonvoice", "aishell", "w2v_transducer"):
        runs[f"{name}_check"] = _w2vf_routes(name)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_w2vf_")
    try:
        runs.update({f"{k}_recipe": v
                     for k, v in _w2vf_recipes(tmp).items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def kernels_line(records, main_runs):
    """The summary line: one entry per kernel at its main-path shape
    (float32 record; bfloat16 beside it where there is one), launches
    summed over the main-path runs (serve, serve_lm, long, train,
    train_long, train_transducer, serve_transducer, recipe,
    train_crdnn_transducer, recipe_transducer, and the steps and recipes
    of recipe_timit, recipe_gsc, recipe_voxceleb, recipe_separation,
    recipe_separation_rnn, recipe_separation_more, recipe_seq2seq,
    recipe_lm, recipe_timit_seq2seq, recipe_kspon, recipe_transformer,
    recipe_corpora, recipe_commonvoice, recipe_slu, recipe_st,
    recipe_wav2vec and recipe_wav2vec_families), each counted from 0 just
    before its run."""
    launches = {}
    for run in main_runs:
        for name, c in run["launches"].items():
            launches[name] = launches.get(name, 0) + c
    out = []
    for name, (source, replaces, (rec_name, role)) in KERNEL_INFO.items():
        pick = [r for r in records if r["name"] == rec_name
                and r.get("role") == role
                and (name != "relpos_attention"
                     or (r["shape"][0] == 8 and r["shape"][2] == 512))
                and (name != "relpos_attention_bwd" or r["shape"][0] == 8)]
        by_dtype = {r["dtype"]: r for r in pick}
        main = by_dtype["float32"]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name]}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape"):
            entry[key] = main[key]
        for key in ("device_ms", "library_device_ms", "host_us_per_call",
                    "device_kernels_per_call", "chain_floor_ms",
                    "chain_term_ms"):
            if key in main:
                entry[key] = main[key]
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        if "bfloat16" in by_dtype:
            entry["bfloat16"] = {k: by_dtype["bfloat16"][k] for k in keys}
        # the same kernel in another role (K1 as dx, the wide lattice,
        # K5/K6 with dropout)
        for r in records:
            if r["name"] == rec_name and r.get("role", role) != role:
                entry.setdefault(r["role"], {})[r["dtype"]] = {
                    k: r[k] for k in keys + ("shape", "rate", "seed", "device_ms")
                    if k in r}
        out.append(entry)
    assert all(e["launches"] > 0 for e in out), launches
    return {"kernels": out}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import speechbrain_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the same convolution algorithms in every run, so that a run's
    # decode (a chaotic function of the encoder's last bits) repeats
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "setup", "allow_tf32": {"matmul": False, "cudnn": False},
          "cudnn_deterministic": True,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        # a subset of the kernel checks, and nothing else
        phase_kernels(set(sys.argv[2].split(",")))
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--phase":
        # one or more of the path phases, and nothing else
        for name in sys.argv[2].split(","):
            globals()[f"phase_{name}"]()
        return 0
    seconds = {}

    def timed(name, phase):
        t0 = time.perf_counter()
        out = phase()
        seconds[name] = time.perf_counter() - t0
        return out

    records = timed("kernels", phase_kernels)
    serve = timed("serve", phase_serve)
    serve_lm = timed("serve_lm", phase_serve_lm)
    long_run = timed("long", phase_long)
    train = timed("train", phase_train)
    train_long = timed("train_long", phase_train_long)
    transducer = timed("train_transducer", phase_train_transducer)
    serve_transducer = timed("serve_transducer", phase_serve_transducer)
    recipe = timed("recipe", phase_recipe)
    crdnn = timed("train_crdnn_transducer", phase_train_crdnn_transducer)
    recipe_transducer = timed("recipe_transducer", phase_recipe_transducer)
    timit = timed("recipe_timit", phase_recipe_timit)
    gsc = timed("recipe_gsc", phase_recipe_gsc)
    vox = timed("recipe_voxceleb", phase_recipe_voxceleb)
    sep = timed("recipe_separation", phase_recipe_separation)
    sep_rnn = timed("recipe_separation_rnn", phase_recipe_separation_rnn)
    sep_more = timed("recipe_separation_more", phase_recipe_separation_more)
    s2s = timed("recipe_seq2seq", phase_recipe_seq2seq)
    lm = timed("recipe_lm", phase_recipe_lm)
    ts2s = timed("recipe_timit_seq2seq", phase_recipe_timit_seq2seq)
    kspon = timed("recipe_kspon", phase_recipe_kspon)
    transformer = timed("recipe_transformer", phase_recipe_transformer)
    corpora = timed("recipe_corpora", phase_recipe_corpora)
    commonvoice = timed("recipe_commonvoice", phase_recipe_commonvoice)
    slu = timed("recipe_slu", phase_recipe_slu)
    st = timed("recipe_st", phase_recipe_st)
    w2v = timed("recipe_wav2vec", phase_recipe_wav2vec)
    w2vf = timed("recipe_wav2vec_families", phase_recipe_wav2vec_families)
    main_runs = [serve["float32"], serve["bfloat16"], *serve_lm.values(),
                 long_run, train["bf16"], train["fp32"], train_long["fp32"],
                 train_long["bf16"], transducer["bf16"], transducer["fp32"],
                 *serve_transducer.values(), recipe, crdnn["bf16"],
                 crdnn["fp32"], *recipe_transducer.values(), timit["step"],
                 timit["recipe"], gsc["step"], gsc["recipe"], vox["step"],
                 vox["recipe"], sep["sepformer_b1"], sep["sepformer_b4"],
                 sep["conformer"], sep["convtasnet"], sep["recipe"],
                 sep_rnn["dprnn"], sep_rnn["skim"], sep_rnn["resepformer"],
                 sep_rnn["recipe"], *(sep_more[k] for k in (
                     "cnntransformer-whamr-DM", "convtasnet-cross",
                     "convtasnet-parallel", "sepformer-libri3mix",
                     "recipe")),
                 *(s2s[k] for k in ("bf16", "fp32", "bpe5000", "search_fp32",
                                    "recipe")),
                 *(lm[k] for k in ("rnnlm_bf16", "rnnlm_fp32",
                                   "transformer_bf16", "transformer_fp32",
                                   "recipe", "fused_seq2seq",
                                   "fused_conformer")),
                 *(ts2s[k] for k in ("seq2seq_bf16", "seq2seq_fp32",
                                     "kd_bf16", "kd_fp32", "recipe")),
                 *kspon.values(), *transformer.values(), *corpora.values(),
                 *(v for k, v in commonvoice.items()
                   if not k.endswith("_check")), *slu.values(),
                 *(v for k, v in st.items() if not k.endswith("_check")),
                 *(v for k, v in w2v.items() if not k.endswith("_check")),
                 *(v for k, v in w2vf.items() if not k.endswith("_check"))]
    emit({"phase": "timing", "seconds": seconds})
    emit(kernels_line(records, main_runs))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
