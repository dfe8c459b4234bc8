#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit from ``nvidia-smi``; no
   CUDA card means exit 1 with no result;
2. build: every kernel library (flash-attention forward and backward in
   f32 on FMAs and in bf16 on wgmma fed by TMA, the checkpoint codec, the
   RWKV-6 recurrence, sequential and chunked on mma.sync fed by TMA, its
   backward, sequential and chunked on mma.sync, the Reed-Solomon encode,
   the RG-LRU scan and its backward, each with its loads in registers
   and by TMA) compiled
   with ``nvcc`` for ``sm_90a`` from the sources in this checkout, all at
   once; each library's registers, spills and its ``HGMMA``, ``HMMA`` and
   ``UTMALDG`` instruction counts (``cuobjdump -sass``): wgmma and TMA
   loads must be there in the bf16 flash-attention libraries (wgmma in the
   backward's head-dim-256 kernels too), mma.sync and TMA loads in the
   chunked RWKV-6 forward, mma.sync in its backward, TMA loads in the TMA
   RG-LRU scan and its TMA backward;
3. kernels against their plain PyTorch versions on the card:
   * the flash-attention forward over the reference's sweep plus the
     serving path's shape, and at head dim 256 (MQA, causal) with windows
     of 128 and 2048 at T = 300, recurrentgemma-9b's prefill shape (4, 16,
     1, 512, 512) and T = 2560 (the window hides keys), f32 (atol 3e-5)
     and bf16 (atol 3e-2, and an error norm at most 2^-7 of the plain
     output's), lse atol 1e-4 on rows with an allowed key, and exact zeros
     on rows with none; the bf16 forward at the training path's shape and
     at deepseek-7b's, phi3-medium-14b's, dbrx-132b's (4, 48, 8, 512,
     512, 128) and qwen3-moe-235b-a22b's (4, 64, 4, 512, 512, 64) serving
     shapes too, and forward and backward (two runs bit-equal) at
     qwen3-moe-235b-a22b's training shape (1, 64, 4, 4096, 4096, 64);
     the forward at head dim 160 (pixtral-12b) over the card tests' sm90
     cases and its serving shape (4, 32, 8, 768, 768, causal), f32 and
     bf16 with the tolerances above; seamless-m4t-medium's causal serving
     shape (4, 16, 16, 512, 512, 64), and its non-causal encoder and
     cross-attention calls, (4, 16, 16, 512, 512, 64) served and (1, 16,
     16, 4096, 512, 64) trained (T != S), forward in f32 and bf16 and
     backward in bf16 (two runs bit-equal, within twice SDPA's error);
   * the flash-attention backward over the same sweep plus the training
     path's shape, from the same (q, k, v, out, lse, do): f32 dq, dk, dv
     within atol 1e-4 + rtol 1e-4; bf16 dq, dk, dv each within twice
     SDPA's error (memory-efficient backend) of the plain backward run on
     f32 copies of the inputs, in max abs and in the error norm over each
     tile of 64 rows (``tests/torch_flash_checks.py``; the kernel rounds P
     and dS to bf16 for the tensor cores, as SDPA does; both printed); two
     runs bit-equal;
   * the codec K1-K3 over n in {1, 255, 256, 257, 4096, 100000, the
     training path's largest leaf} x f32/bf16/f16: codes, deltas, scales
     and dequantized values bit-equal (0 mismatches);
   * the RWKV-6 recurrence K6 over the reference's sweep plus the serving
     path's prefill (4, 64, 512, 64) and decode (4, 64, 1, 64) shapes, from
     a carried state, against the plain chunked version: the sequential
     kernel with f32 and bf16 r/k/v, the chunked tensor-core kernel with
     bf16; atol 2e-3 (the reference's kernel tests), plus rtol 2^-7 on a
     bf16 o; two runs bit-equal; log_w x10 and x100, below -30 (clamped),
     in f32 and bf16; [0, T/2) then [T/2, T) equal to one shot within atol
     1e-5 (T/2 a chunk boundary), and a split off a chunk boundary within
     the tolerance above;
   * the RG-LRU scan K7, both kernels (loads in registers, and by TMA
     through an mbarrier ring), over the reference's sweep, two ragged
     cases and the serving path's prefill (4, 512, 4096), ring prefill (1,
     2560, 4096) and decode (4, 1, 4096) shapes, with h0 and without, f32
     and bf16 g, against the plain chunked version: h_final and an f32 h
     within atol 2e-4 (the reference's kernel tests), a bf16 h within atol
     2e-4 + rtol 2^-7; two runs bit-equal; the two kernels bit-equal to
     each other everywhere; through ``ops.rglru``, [0, T/2) then [T/2, T),
     and a prefill followed by one-token steps, equal to one shot;
   * the backward kernels of the recurrent training paths against their
     plain backwards, two runs bit-equal each: K6's, the sequential
     ``rwkv6_bwd`` over the RWKV sweep and rwkv6-7b's training shape (1,
     64, 4096, 64), f32 and bf16, and the chunked tensor-core
     ``rwkv6_bwd_sm90`` (bf16) over the sweep's cases of at least 32
     tokens and the training shape, from s0 and from none, a nonzero dsT,
     atol 2e-3 + rtol 1e-5 (bf16 dr, dk, dv + rtol 2^-7), and log_w x10
     and x100 below -30, unclamped as in the reference (f32 for the
     sequential kernel, bf16 for the chunked one); K7's two, the TMA
     ``rglru_bwd_sm90`` and the register ``rglru_bwd``, over the RG-LRU
     sweep and recurrentgemma-9b's training shape (1, 4096, 4096), with h0
     and without, with a nonzero dh_last and without, atol 2e-4 + rtol
     1e-5 (a bf16 dg + rtol 2^-7), and bit-equal to each other wherever
     TMA can read the rows; K4's backward at head dim 256, f32
     (FMAs) within atol 1e-4 + rtol 1e-4 and bf16 (wgmma) within twice
     SDPA's error as at the lower head dims (both printed), over three
     windowed MQA cases and (1, 16, 1, 4096, 4096, 256) under the window
     of 2048; K4's backward at head dim 160 (pixtral-12b), f32 (FMAs) and
     bf16 (wgmma: 64 keys a dk/dv block, its query tile split between the
     consumers) with the tolerances above, two runs bit-equal, over the
     card tests' cases (GQA, causal and not, a window, T != S both ways),
     the sm90 cases at 160 and pixtral's training shape (1, 32, 8, 4352,
     4352, causal: 256 patches before 4096 tokens); then one call each of
     the two redesigned backwards (K6's
     chunked, K4's at head dim 256) at their training shapes under
     ``torch.profiler``: their device time by kernel (``backward_split``);
4. the serving path: yi-6b at full width (32 layers, bf16, random weights
   from a seeded generator) serves 4 requests of 512 prompt tokens and 32
   new tokens through ``ServeEngine.generate``, committing its KV cache to
   an in-process iCheck cluster.  The kernel launch counts are set to 0 just
   before and read just after: one flash-attention launch per layer.  The
   restored cache must equal a second prefill's bit for bit, and decoding
   from it must give the live run's tokens.  A 2-layer cut of the same
   model in f32 is held against the plain CPU path on a short prompt
   (atol 1e-3); then the weights are freed and the serving numbers
   printed.  4b, 4d, 4e and 4f run the same phase
   (``serve_model_phase``);
4b. the same serving path for rwkv6-7b at full width (32 layers, d_model
   4096, 64 heads of 64, d_ff 14336, vocab 65536, bf16, 7,551,455,232
   params): K6 must run 32 times in prefill and 32 x 31 times in the
   decode steps of ``generate`` (the chunked kernel in prefill, the
   sequential one in the one-token decode steps); the committed recurrent
   state (136,314,884
   bytes whatever the prompt's length) is restored bit-equal to a second
   prefill's, and decoding from it gives the live tokens; a 2-layer f32 cut
   against the plain CPU path; then the weights are freed;
4c. the Reed-Solomon encode K5, bit for bit against the numpy host codec
   (``rs.rs_encode_np``): k in {1, 2, 4, 8} x m in {1, 2} x unaligned
   strides, and k = 4, m = 2 over the RWKV state's bytes split as
   ``rs.split_rows`` splits them (stride 34,078,721).  No serving or
   training path runs K5 (the copied service encodes on the host), so its
   launches are this check's;
4d. the same serving path for recurrentgemma-9b at full width (38 layers:
   12 x (RG-LRU, RG-LRU, attention) + 2 RG-LRU tail layers, d_model 4096,
   16 heads of 256 over one KV head with window 2048, d_ff 12288, vocab
   256,000, bf16, 10,444,771,328 params): K7 must run 26 times in prefill
   (the TMA kernel) and 26 x 31 in the decode steps of ``generate`` (the
   register kernel), K4 (head dim 256) 12
   times in prefill and never in decode; the 30,998,532-byte state (ring
   caches and RG-LRU states) is restored bit-equal to a second prefill's
   and decoding from it gives the live tokens.  Then one 2560-token
   prompt and 16 new tokens (2048 ring slots: prefill rolls the ring,
   decode writes into it), its 26,230,788-byte state checked the same
   way; a 5-layer f32 cut (one super-layer and both tail layers) against
   the plain CPU path within 1e-4, and again with its window cut to 16, a
   40-token prompt (the ring rolls in prefill) and 20 decode steps (their
   writes wrap the ring), prefill and every step's logits within 1e-4;
   then the weights are freed;
4e. the same serving path for deepseek-7b at full width (30 layers,
   d_model 4096, 32 heads of 128 over 32 KV heads (MHA), d_ff 11008,
   vocab 102,400, bf16, 6,910,365,696 params): K4 30 times a prefill and
   never in decode; the 1,069,547,524-byte KV cache restored bit-equal.
   Then the same requests with the int8 KV cache (``kv_quant``: int8
   codes and one f16 scale per 4 head dims, 1.5 bytes a value): its
   802,160,644-byte cache restored bit-equal, decode from it giving the
   live tokens; a 2-layer f32 cut against the plain CPU path, and the
   same cut with the int8 cache over 8 decode steps: after them, the
   card's codes of every layer at most one step from the CPU's on at
   most 1e-3 of them, its f16 scales at most one f16 step from the
   CPU's on at most 1.6e-2 of them (an f16 step of a scale is 1/16 to
   1/8 of a code's), every argmax the CPU's, the logits within 1e-3 plus
   0.164 of the CPU's own int8-against-exact difference
   (``check_against_plain``);
4f. the same serving path for phi3-medium-14b at full width (40 layers,
   d_model 5120, 40 heads of 128 over 10 KV heads, d_ff 17920, vocab
   100,352, bf16, 14,659,507,200 params): its f32 weights (58.6 GB) and a
   bf16 copy would not fit the card together, which is why every serving
   phase casts its drawn weights leaf by leaf (``cast_leaves_``); K4 40
   times a prefill; the 445,644,804-byte KV cache restored bit-equal; a
   2-layer f32 cut against the plain CPU path; the peak memory of the
   cast and of serving in its line;
4g. the same serving path for dbrx-132b (Mixture-of-Experts: 16 experts,
   top 4, d_ff 10752 each; d_model 6144, 48 heads of 128 over 8 KV heads,
   vocab 100,352) at published widths cut to 4 of its 40 layers
   (14,269,470,720 params; the f32 draw and the cast's bf16 copy of the
   stacked expert weights fill the card, ``reduced`` in its line): K4 4
   times a prefill and never in decode, which runs the experts at one
   slot each (the reference's dense dispatch: every expert's weights read
   a token); the KV cache restored bit-equal; a 1-layer f32 cut (a
   64-token prompt, 8 decode steps) against the plain CPU path within
   1e-3, every argmax and every layer's expert ids after prefill and each
   decode step equal to the CPU's (a flipped id is reported with the
   CPU's probability gap at the k-th place, and fails); one profile
   window, over a prefill;
4h. the same for qwen3-moe-235b-a22b (128 experts, top 8, d_ff 1536
   each; d_model 4096, 64 heads of 64 over 4 KV heads) cut to 4 of its 94
   layers (11,054,125,056 params), no profile window;
4i. the same serving path for seamless-m4t-medium at full width (the
   encoder-decoder: 12 encoder + 12 decoder layers, d_model 1024, 16
   heads of 64, d_ff 4096, vocab 256,206 padded to 256,256, bf16,
   978,909,184 params), 512 frames (seeded f32 embeddings) a request: K4
   36 times a prefill (12 non-causal encoder layers, 12 causal decoder
   self-attentions, 12 non-causal cross-attentions over the frames) and
   never in decode; the self + cross cache (207,618,052 bytes) restored
   bit-equal, decoding from it giving the live tokens; then the same
   with int8 self and cross caches (155,713,540 bytes); a 1 + 1-layer f32
   cut against the plain CPU path, and the same with the int8 caches over
   8 decode steps, held as deepseek-7b's (phase 4e);
4j. the same for pixtral-12b at full width (40 layers, d_model 5120, 32
   heads of 160 over 8 KV heads, d_ff 14336, vocab 131,072, 256 projected
   patches before each prompt, bf16, 12,798,284,800 params; its f32 draw
   is 51.2 GB, its largest leaf 23.5 GB): K4 at head dim 160 40 times a
   prefill and never in decode; the 655,360,004-byte KV cache (800 slots:
   256 patches, 512 prompt tokens, 32 new) restored bit-equal; a 2-layer
   f32 cut against the plain CPU path (``flash_fwd.cu``'s head-dim-160
   instance on the card); the peak memory of the cast and of serving in
   its line;
5. the training path: ``ElasticTrainer`` trains qwen2.5-3b at full width
   cut to ``TRAIN_LAYERS`` of its 36 layers (d_model 2048, bf16 compute,
   f32 master weights, full remat)
   on 4096-token sequences, global batch 1 (cut from 256), 4 steps with a
   q8-delta commit every 2 (keyframe, delta) encoded on the card, 2
   more steps as the uninterrupted reference; a fresh trainer restarts from
   the agents, step and data state restored and every float leaf equal to
   its committed codes (which lie within absmax/127 * 0.51 per block of
   the state at commit), and trains 2 steps.  Counts are set to 0 before
   and read after the 4 steps and their commits;
5b. the same training path for rwkv6-7b at published widths cut to 2
   layers (975,286,272 params), bf16 compute, 4 steps of 4096 tokens,
   q8-delta commits at 2 and 4, no restart: K6's chunked forward 2 x 2 x
   4 times (full remat runs each layer's forward twice), its chunked
   backward 2 x 4, the sequential forward and backward never; K1 and K2
   in the commits; then a 2-layer f32 cut's loss and every
   gradient on the card against the plain CPU path (one 64-token
   sequence; each leaf within 1e-3 of its largest element, the loss
   within rtol 1e-5);
5c. the same for recurrentgemma-9b cut to one super-layer (rec, rec,
   attn; 2,753,638,400 params): K7's TMA forward 2 x 2 x 4, its TMA
   backward 2 x 4 (the register backward never), K4 at head dim 256
   forward 2 x 4 and backward 4 (all on the bf16 wgmma library, none on
   the FMA one); the f32 cut is the 5-layer one of phase 4d (both tails)
   with its window cut to 16 over the ring cut's 40 tokens, ``lam`` drawn
   from [-6, 0] (at init its gradient is roundoff): its four RG-LRU
   backwards below ``ops.SM90_BWD_MIN_T``, on the register kernel;
5d. qwen3-moe-235b-a22b cut to one layer (3,697,815,552 params): the
   training path's loss and gradients (``compute_grads``, bf16 compute,
   f32 master weights, full remat) on one 4096-token sequence, 3 calls,
   without the optimizer (the trainer's ~23 B a parameter would not fit
   even this layer); K4 forward 2 and backward 1 a call, on the wgmma
   library; then a 1-layer f32 cut's loss and gradients on the card
   against the plain CPU path, as in 5b;
5e. the training path of 5b for seamless-m4t-medium at full width
   (978,909,184 params, f32 master weights, bf16 compute, full remat):
   one sequence of 4096 decoder tokens over 512 frames a step (global
   batch cut from 256 to 1), 4 steps, q8-delta commits at 2 and 4, no
   restart: K4's forward 2 x 36 a step (encoder, self, cross; remat
   recomputes each), its backward 36, all on the bf16 wgmma libraries;
   then a 1 + 1-layer f32 cut's loss and every gradient leaf (the
   encoder's and the frontend's among them) against the plain CPU path;
5f. the training path of 5b for pixtral-12b at published widths cut to
   2 of its 40 layers (1,939,891,200 params, about 45 GB of state),
   through the sharded trainer: this process joins a one-rank NCCL world
   over a ``FileStore`` (``sharding.init_world``), so ``ElasticTrainer``
   makes its ``DeviceMesh`` (``sharding.make_mesh``: one card), all-reduces
   every gradient leaf over it (one NCCL all-reduce a leaf a step, counted)
   and snapshots its state as DTensors; 4 steps of 4096 tokens after 256
   seeded patches (K4 at T 4352, head dim 160), q8-delta commits at 2 and
   4: K4's forward 2 x 2 a step (remat), its backward 2 a step, all on
   ``flash_bwd_sm90``; then a 1-layer f32 cut's loss and gradients
   (``flash_bwd.cu``'s head-dim-160 instance on the card) against the
   plain CPU path, each leaf within 1e-4 of its largest element;
6. a second training phase at full width cut to 2 layers: int8 gradient
   compression (K1 + K3 in every step) and a 1 -> 2 logical-rank resize
   with ``overlap_resize``;
7. numbers: the serving lines (yi-6b, rwkv6-7b, recurrentgemma-9b,
   deepseek-7b with its int8 subrun, phi3-medium-14b, seamless-m4t-medium
   with its int8 subrun, pixtral-12b, dbrx-132b, qwen3-moe-235b-a22b), the
   training lines (qwen2.5-3b, rwkv6-7b, recurrentgemma-9b,
   seamless-m4t-medium, pixtral-12b; qwen3-moe's loss-and-gradient line),
   step ms,
   tokens/s,
   ``mfu``, commit and restart wall seconds,
   bytes on the wire, peak device memory, host RSS, a ``torch.profiler``
   window over one training step, K7's two backwards timed in turns and
   over T at one and four batch rows (``rglru_bwd_route_ms``: fails
   unless the kernel ``ops.SM90_BWD_MIN_T`` routes to is the faster), and
   the ``kernels`` line (each kernel's
   launches on the path named in ``launches_path``, its time, its plain
   version's, the bound, a library yardstick where one
   PyTorch call computes the same function);
8. report: three cells of the one-H100 report (``repro_torch.launch.
   report``) run on the card as its one-device step at the 16 x 16
   mesh: yi-6b x decode_32k (8 sequences, a 32,768-slot cache), yi-6b x
   prefill_32k (2 sequences of 32,768 tokens) on one draw of its
   weights, and qwen2.5-3b x train_4k (16 sequences in 8 microbatches),
   all at full depth.  Each step runs once under the op counter on the
   card and is traced once on ``meta``: FLOPs, bytes and the kernels'
   records must be equal, K4's records equal to its launches, and
   ``max_memory_allocated`` (after ``reset_peak_memory_stats``) over a
   timed run within 0.8-1.25x of the report's peak; the
   ``report`` line gives the measured ms beside ``bound_s``.
8b. the KV cache over its sequence (``launch.specs.cell_rules``' kv_seq
   fallback): qwen2.5-3b's decode_32k and prefill_32k as rank 0 of a
   ("data" 16, "model" 4) mesh, whose 4 "model" ranks do not divide the
   2 kv heads, at full width and a data rank's 8 and 2 sequences, decode
   at full depth and prefill cut to KV_SEQ_PREFILL_LAYERS of 36 layers.
   The report traces the rank on ``meta`` in this process (a 256-rank
   world on the ``fake`` backend); the rank runs beside its 3
   "model" peers as processes on the card over gloo, each holding a
   quarter of the cache's slots (decode's over a cache drawn from a
   seed, filled to its last slot).  Held: the run's FLOPs, bytes,
   collectives and kernel records equal to the trace's, the peak within
   ``PEAK_BAND``, K4 once a layer in prefill at (2, 4, 1, 32768, 32768,
   128)
   (phase 3 holds K4 at that shape against its plain version, taken
   KV_SEQ_REF_ROWS query rows at a time); the split decode's logits and
   the split prefill's last token's within twice bf16's own distance of
   one process's whole-cache bf16 run of the same inputs (bf16's own:
   its distance from the one-process f32 run); a 2-layer f32 cut's
   logits and greedy tokens (a 64-token prompt in 256 slots: two ranks'
   slots masked throughout) against the plain CPU path within 1e-5.  The
   ``serve_kv_seq`` line gives the numbers, the all-reduces' share of a
   decode step among them.
9. the mesh's "model" axis (``sharding/tp.py``): two processes on the
   one card in a gloo world (``init_world(..., "cuda:gloo", ...)``; NCCL
   refuses two ranks on one card, so every all-reduce is staged through
   the host), a ("data", "model") mesh of 1 x 2.  Each draws yi-6b cut
   to TP_SERVE_LAYERS of its 32 layers (phase 4's seed) and serves it
   split at full width through
   ``ServeEngine(mesh=)``: 16 of the 32 heads and 2 of the 4 KV heads a
   rank (K4 4 times a prefill at (4, 16, 2, 512, 512, 128), never in
   decode), 4 x 512 prompt tokens and 32 new, 11 all-reduces a decode
   step (two a layer, the embedding's, the argmax's two over the vocab
   shards), counted; the KV cache committed as DTensor views (one part a
   rank) and restored on the mesh bit-equal to a second prefill, decoding
   from it to the live tokens; each all-reduce of 8 decode steps timed
   between synchronizations (their share of a step).  This process then
   feeds the split run's tokens to yi-6b in one process on the card, in
   f32 and in bf16: the split bf16 logits must lie within twice the
   one-process bf16 logits' distance from the f32 ones of the one-process
   bf16 logits (max abs difference over max abs, every step: each bf16
   run lies about bf16's own error from f32), and the equal greedy tokens
   are counted; the
   split f32 cut (2 layers, a 64-token prompt, 8 greedy steps) gives the
   plain CPU path's tokens, its logits within 1e-3.  Then qwen2.5-3b cut
   to 2 layers at full width trains split: its f32 cut's loss and
   gradient shards over one 64-token sequence against the plain CPU path
   (each leaf within 1e-4 of its largest, the loss within rtol 1e-5),
   then 3 bf16 train steps of 4096 tokens (``make_train_step(mesh=)``:
   K4 at (1, 8, 1, 4096, 4096, 128), 4 forward and 2 backward a step on
   the wgmma libraries; AdamW's clip over the split leaves).  The
   ``serve_tp`` and ``train_tp`` lines give the numbers; phase 3 checks
   K4 at both local shapes (forward, and backward at the training one)
   and phase 7 times them.
10. the "model" axis for the recurrent models, at full width and depth:
   the two processes of phase 9's world serve rwkv6-7b (10a: K6 at a
   rank's 32 heads, its chunked kernel 32 times a prefill at (4, 32,
   512, 64), its sequential one 32 times a decode step; 99 all-reduces a
   step: three a layer, the time-mix's and the FFN's outputs and the
   receptance's gather) and recurrentgemma-9b (10b: K7 at a rank's 2048
   channels, its TMA kernel 26 times a prefill at (4, 512, 2048), its
   register one 26 times a step; K4 12 times a prefill at (4, 8, 1, 512,
   512, 256), fed the gathered MQA head; 129 all-reduces a step, the
   gates' reduce-scatter among them) split two ways, drawn whole in turn
   (phase 4's seed) and cast leaf by leaf: 4 x 512 prompt tokens, 32 new,
   the state committed (its split leaves as one part a rank, the shift
   states and ring caches whole), restored on the mesh (bit-equal to a
   second prefill, decoding to the live tokens) and whole on one rank
   (equal to every rank's box; one process decodes from it); the
   collectives counted, and timed in the second prefill and the restored
   decode; rank 0 then serves the batch in one process, fed the split
   run's tokens, and the split bf16 logits lie within 0.16 (rwkv6-7b)
   and 0.09 (recurrentgemma-9b) of its, max abs difference over max abs
   (twice bf16's own distance from f32 there).  10c:
   their f32 cuts at full width (rwkv6-7b 2 layers, recurrentgemma-9b 3,
   one super-layer) served split (64 prompt tokens, 8 greedy steps: the
   CPU's tokens, logits within 1e-3) and their loss and gradient shards
   over 64 tokens (K6's, K7's and K4's backwards at the local widths;
   every leaf within 1e-3 of its largest, the loss within rtol 1e-5)
   against the plain CPU path, which this process runs while 10d's ranks
   run (drawn on the card before phase 9's world starts).  10d:
   phi3-medium-14b's f32 cut (2 layers, full width)
   split four ways (a rank's 10 query heads straddle the GQA groups of
   the gathered K/V, so K/V are expanded a head each): logits, 8 greedy
   tokens, loss and gradients over 2 x 64 tokens against the plain CPU
   path (each leaf within 1e-4).  Phase 3 checks and times K6, K7 and K4
   at the ranks' shapes.  The ``serve_tp_rwkv6``,
   ``serve_tp_recurrentgemma`` and ``tp_phi3`` lines give the numbers.
11. Mixture-of-Experts under ``FSDP_RULES``, as the MoE configurations
   name them.  11a: two processes (a new world, as phase 9's) on a 1 x 2
   mesh serve dbrx-132b and qwen3-moe-235b-a22b at full width cut to
   MOE_TP_LAYERS layers (as phases 4g and 4h are): 8 and 64 experts a
   rank, 24 and 32
   query heads over 4 and 2 kv heads (K4 4 times a prefill at (4, 24, 4,
   512, 512, 128) and (4, 32, 2, 512, 512, 64), never in decode); the
   router, dispatch and combine whole on every rank, the dispatch buffer
   sliced to the rank's experts and their outputs gathered (126 MB a
   layer in dbrx's prefill, 168 MB in qwen3-moe's, the prefill's largest
   all-reduce, checked).  The ranks draw the whole f32 model in turn
   (dbrx's is 57 GB), the others' bf16 boxes waiting on the host.  4 x
   512 prompt tokens, 32 new; the cache committed, restored on the mesh
   (bit-equal to a second prefill, decoding to the live tokens) and
   whole on rank 0 (equal to every rank's box, decoding there); the
   collectives counted by mesh axis (2 a layer, the embedding's, the
   argmax's two: 11 a decode step) and timed.  Rank 0 then serves the
   batch in one process in f32 and in bf16, fed the split run's tokens
   and routed by its expert ids (``replaying_routes``; a near tie that
   the split's rounding tips would otherwise change a sequence's logits
   from then on): the split bf16 logits lie within twice the one-process
   bf16 logits' own distance from the f32 ones, the split's router
   probabilities within twice bf16's own distance from f32, no choice
   of the split's routers reverses two experts that one process ranks
   further apart than twice that bound, and the tokens it routes
   otherwise than one process number at most twice those one process's
   bf16 routers route otherwise than its f32 ones.  11b: four processes on a ("data" 2, "model" 2)
   mesh run qwen3-moe's f32 cut at full width, one layer (3,697,815,552
   params, as phase 5d), drawn whole in turn: 64 experts a rank over
   "model", every leaf's embed rows over "data", gathered a layer at a
   time (11 gathers a forward, one broadcast a data rank each, counted)
   with their gradients reduce-scattered; logits and 4 greedy tokens
   over 2 x 64 prompt tokens (within 1e-3), the loss (rtol 1e-5) and
   every gradient box over 2 x 64 tokens (within 1e-4 of each leaf's
   largest) against the plain CPU path, which this process runs
   meanwhile.  The
   ``serve_tp_moe`` (one a model) and ``fsdp_qwen3_moe`` lines give the
   numbers; phase 3 checks K4 at both local shapes and phase 7 times
   them.

Each phase's wall seconds (from the end of the one before) and the total
are printed as the ``phase_wall_s`` line.

To keep the whole run within its 1,200 s, phases 4b, 4d, 4e, 4f and 4j
and phase 10's served models run cut to 4 layers (``SERVE_LAYERS``;
recurrentgemma-9b one super-layer and both tail layers), 4g and 4h to 1
layer, phase 9's yi-6b to 2 and its qwen2.5-3b to 1, phase 11a's MoE
models to 1, phase 5 to 2 layers (``TRAIN_LAYERS``), 5b, 5f and 6 to 1
(``RWKV_TRAIN_LAYERS``, ``PIX_TRAIN_LAYERS``, ``CUT_LAYERS``): the
depths, layer counts, parameter counts and state bytes above are those
before the cuts, the launch counts scale with the layers, and each
line's ``reduced`` names its cut.

The last line is ``{"ok": true, "device": {...}}``.  f32 matmuls run in full
f32 (``allow_tf32`` is False).  A kernel's ``ms``, ``plain_ms`` and
``library_ms`` are device times of warm calls (``device_ms``: CUDA events
around calls queued behind a spin kernel, so the host's cost per call
stays out; for a plain version of thousands of launches a call, of one
CUDA graph of them: ``graph_ms``); ``event_ms`` is the CUDA-event time of back-to-back calls of
the kernel's wrapper, host included.  The profile windows'
busy times come from ``torch.profiler``, which can drop kernel records
(so they are lower bounds).  Other times are wall times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the training path's state nearly fills the card: let the allocator grow
# segments instead of fragmenting (read when torch first touches the card)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the sweep of tests/test_kernels_attention.py; (b, hq, hkv, t, s, d,
# causal, window)
SWEEP = [
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 1, 100, 100, 32, True, None),
    (1, 4, 4, 64, 64, 128, False, None),
    (2, 4, 2, 96, 96, 32, True, 32),
    (1, 2, 1, 1, 160, 64, True, None),
    (1, 2, 2, 72, 200, 32, True, None),
]
BATCH, PROMPT, GEN = 4, 512, 32
ATOL = {"float32": 3e-5, "bfloat16": 3e-2}
LSE_ATOL = 1e-4
BWD_TOL = {"float32": (1e-4, 1e-4)}
# the training path: qwen2.5-3b, one 4096-token sequence a step, 4 steps
# the cut phase (6) runs qwen2.5-3b cut to CUT_LAYERS layers, to keep the
# whole run within its 1,200 s
TRAIN_SEQ, TRAIN_STEPS, COMMIT_EVERY, CUT_LAYERS = 4096, 4, 2, 1
# the training path (phase 5) cut to 2 of qwen2.5-3b's 36 layers, to
# keep the whole run within its 1,200 s: the restart's host decode of the
# whole f32 state (136 s at 36 layers) and the two commits scale with the
# depth
TRAIN_LAYERS = 2
# the cut phase's overlap resize must complete within this wall time
RESIZE_WAIT_S = 300
CODEC_NS = [1, 255, 256, 257, 4096, 100_000]
# the sweep of tests/test_kernels_rwkv6.py plus the serving path's prefill
# and decode shapes; (b, h, t, d)
RWKV_SWEEP = [(2, 3, 130, 64), (1, 2, 64, 32), (1, 1, 7, 16)]
RWKV_TOL = {"float32": (2e-3, 0.0), "bfloat16": (2e-3, 2 ** -7)}
RS_STRIDES = [1, 15, 33, 4097, 100_003]
# the sweep of tests/test_kernels_rglru.py, then ragged cases of the TMA
# kernel: T not a multiple of its chunk (32 tokens where CTAs share SMs,
# 128 where each has one) over several chunks, D a multiple of its
# 32-channel strip and not, and for f32 g a multiple of 4 but not of 8
# (a row that ends halfway into a helper's 8-channel store; bf16 rows of
# that width go to the register kernel alone); the serving path's shapes
# follow; (b, t, d)
RGLRU_SWEEP = [(2, 100, 256), (1, 64, 128), (1, 5, 512), (3, 33, 96),
               (3, 100, 96), (3, 100, 104), (5, 100, 1000), (1, 300, 104),
               (1, 320, 100), (3, 100, 100)]
RGLRU_TOL = {"float32": (2e-4, 0.0), "bfloat16": (2e-4, 2 ** -7)}
# the lower of the two points that bracket ``ops.SM90_MIN_T`` in the K7
# route check lies RGLRU_ROUTE_BELOW tokens below it.  From T = 257 to
# about 300 the two kernels tie (at T = 272 the register kernel has read
# 5.9 % faster and 5.0 % slower than the TMA one in two calls), so the
# points lie outside that band: at 256 the register kernel has led by
# 8-20 %, at 304 the TMA one by 12-15 %
RGLRU_ROUTE_BELOW = 48
# the lengths at which the K7 backward route check times both backward
# kernels, at one batch row and at four (recurrentgemma-9b's width); the
# lower point that brackets ``ops.SM90_BWD_MIN_T`` lies
# RGLRU_BWD_ROUTE_BELOW tokens below it.  From T = 32 to 48 the two
# kernels are within 3-8 % (the lead changes hands there), so the points
# lie outside that band: at 16 the register kernel has led by 23-30 %, at
# 64 the TMA one by 13-34 %
RGLRU_BWD_ROUTE_TS = (1, 128, 512, 4096)
RGLRU_BWD_ROUTE_BELOW = 48
# recurrentgemma-9b's attention at head dim 256 (MQA, causal, window
# 2048): a short window, the serving path's prefill, a window that hides
# keys; (b, hq, hkv, t, s, d, causal, window)
D256_SWEEP = [(1, 4, 1, 300, 300, 256, True, 128),
              (1, 16, 1, 2560, 2560, 256, True, 2048)]
# its ring sub-phase: one sequence longer than the window; its 5-layer
# f32 cut against the plain CPU path with the window cut so that the
# prompt rolls the ring and the decode steps wrap it: (window, prompt,
# decode steps)
RING_PROMPT, RING_GEN = 2560, 16
RING_CUT = (16, 40, 20)
# deepseek-7b's f32 cut with the int8 KV cache: decode steps after its
# prefill, each held to the plain CPU path
INT8_CUT_STEPS = 8
# the share of its codes on which the card's int8 cache may lie one step
# from the CPU's in that cut.  A scale's f16 step is 2^-11 to 2^-10 of
# the scale, 1/16 to 1/8 of a code's step (1/127 of the block's absmax):
# the same f32 difference crosses an f16 edge of a scale up to 2^11/127
# times as often as a code's rounding edge, and each such scale moves its
# values by at most 127 * 2^-10 of a code's step
Q8_SHARE = 1e-3
Q8_SCALE_SHARE = Q8_SHARE * 2 ** 11 / 127
Q8_SCALE_STEP = 127 * 2 ** -10
CODEC_DTYPES = ("float32", "bfloat16", "float16")
# the recurrent training phases (5b, 5c): TRAIN_SEQ tokens a step, steps
# and q8-delta commit interval; rwkv6-7b cut to 1 layer,
# recurrentgemma-9b to one super-layer (rec, rec, attn) without its two
# tail layers
TRAIN_REC_STEPS, TRAIN_REC_COMMIT = 4, 2
RWKV_TRAIN_LAYERS, HYBRID_TRAIN_LAYERS = 1, 3
# the MoE phases: dbrx-132b and qwen3-moe-235b-a22b served cut to 1
# layer, their f32 cuts (1 layer, a 64-token prompt, 8 decode steps)
# against the plain CPU path; qwen3-moe's training loss and gradients cut
# to 1 layer, timed over 3 calls
MOE_SERVE_LAYERS = 1
MOE_PLAIN = dict(layers=1, prompt=64, steps=8)
MOE_GRAD_CALLS = 3
# their f32 cuts against the plain CPU path: one sequence of GRAD_SEQ
# tokens; every gradient leaf within GRAD_TOL of its largest element (f32
# sums in other orders on two devices, through recurrences that the
# kernels step one token at a time and the plain versions by chunks), the
# loss within LOSS_RTOL
GRAD_SEQ, GRAD_TOL, LOSS_RTOL = 64, 1e-3, 1e-5
# K4's backward at head dim 256 beside recurrentgemma-9b's training shape:
# windows shorter than T, T and S ragged at the key tiles, T < S (the
# card tests' cases); (b, hq, hkv, t, s, d, causal, window)
D256_BWD_SWEEP = [(1, 4, 1, 300, 300, 256, True, 128),
                  (2, 8, 1, 200, 333, 256, True, 100),
                  (1, 16, 1, 1100, 1100, 256, True, 1024)]
# K4's forward at head dim 160 (pixtral-12b): the card tests' sm90 cases
# at that head dim (T = 1 under S > T, T and S ragged at the tiles, GQA
# groups 1 to 16, a window whose edge crosses a tile, T > S, no mask);
# pixtral-12b's serving shape follows
D160_SWEEP = [(1, 4, 4, 1, 160, 160, True, None),
              (1, 4, 2, 127, 127, 160, True, None),
              (2, 8, 1, 129, 200, 160, True, None),
              (1, 16, 1, 200, 333, 160, True, 100),
              (1, 4, 2, 96, 40, 160, True, None),
              (1, 2, 2, 200, 200, 160, False, None)]
# K4's backward at head dim 160 (pixtral-12b): the card tests' cases
# (GQA 2:1 and 4:1, T < S ragged at the 64-key blocks, a window,
# non-causal T < S and T > S, a longer causal run), then the sm90 cases
D160_BWD_SWEEP = [(1, 4, 2, 100, 130, 160, True, None),
                  (2, 4, 1, 96, 96, 160, True, 32),
                  (1, 2, 2, 72, 200, 160, False, None),
                  (2, 4, 4, 100, 37, 160, False, None),
                  (1, 8, 2, 520, 520, 160, True, None)] + D160_SWEEP
# pixtral-12b trained (phase 5f): cut to 1 of its 40 layers; its f32 cut
# of 1 layer against the plain
# CPU path, every gradient leaf within PIX_GRAD_TOL of its largest
# element
PIX_TRAIN_LAYERS, PIX_PLAIN_LAYERS, PIX_GRAD_TOL = 1, 1, 1e-4
# the encoder-decoder (seamless-m4t-medium): its served and trained
# layers (12 + 12) and one TRAIN_SEQ-token sequence with its frames a
# training step; its f32 cuts (1 + 1 layers) against the plain CPU path
SEAMLESS_PLAIN_LAYERS = 1
# the report's cells run on the card (phase 8), each at full depth: the
# report puts qwen2.5-3b's training cell's peak at 81.2 GB (its training
# state 54 GB, the f32 logits of a 2 x 4096-token microbatch in the loss's
# backward 25 GB) of the card's 85.0 GB
REPORT_CELLS = (("yi-6b", "decode_32k"), ("yi-6b", "prefill_32k"),
                ("qwen2.5-3b", "train_4k"))
# the serving phases 4b, 4d, 4e, 4f and 4j and phase 10's served
# models run cut to SERVE_LAYERS layers (recurrentgemma-9b: one
# super-layer and both tail layers) to keep the whole run within its
# 1,200 s
SERVE_LAYERS = 4
# phase 8b: the KV cache split over its sequence across "model" (the
# serving cells' kv_seq fallback, ``launch.specs.cell_rules``): KV_SEQ_ARCH's
# serving cells on KV_SEQ_MESH, whose "model" axis of 4 does not divide
# its 2 kv heads.  Rank 0 of the mesh runs with its "model" peers as
# processes on the one card over gloo, at a data rank's rows (8 and 2
# sequences), full width (decode at full depth, prefill cut to
# KV_SEQ_PREFILL_LAYERS): decode over a cache drawn from
# KV_SEQ_SEED and filled to its last slot, KV_SEQ_TIMED steps timed after
# the counted one (the prefill timed by its counted run alone).  Its
# f32 cut (KV_SEQ_PLAIN: a 64-token prompt in a cache of 256 slots, 64 a
# rank: the prompt fills rank 0's, the decode steps write rank 1's, ranks
# 2 and 3 stay masked) against the plain CPU path within KV_SEQ_RTOL of
# each logit and of their max
KV_SEQ_ARCH = "qwen2.5-3b"
KV_SEQ_MESH = {"data": 16, "model": 4}
KV_SEQ_CELLS = ("decode_32k", "prefill_32k")
KV_SEQ_SEED = 3
KV_SEQ_TIMED = 1
KV_SEQ_PLAIN = dict(layers=2, batch=2, prompt=64, max_len=256, steps=8)
# prefill_32k's depth in phase 8b (decode_32k's is full), cut to keep the
# whole run within its 1,200 s: its four ranks' all-reduces go through
# the host, and one process's f32 prefill of the same inputs holds them
KV_SEQ_PREFILL_LAYERS = 18
KV_SEQ_RTOL = 1e-5
# phase 3 holds K4 at phase 8b's prefill shape against its plain version
# taken this many query rows at a time
KV_SEQ_REF_ROWS = 2048
# phase 9: the mesh's "model" axis on the one card: TP_MODEL processes
# over gloo; yi-6b served split at full width and depth, its f32 cut
# (TP_PLAIN, as ``check_against_plain``'s, within TP_PLAIN_ATOL) against
# the plain CPU path; each all-reduce of TP_TIMED_STEPS decode steps
# timed alone; qwen2.5-3b cut to TP_TRAIN_LAYERS layers trained split
# TP_TRAIN_STEPS steps, its f32 cut's gradient shards within TP_GRAD_TOL
# of each leaf's largest
TP_MODEL = 2
# yi-6b's depth in phase 9, cut to keep the whole run within its 1,200 s
TP_SERVE_LAYERS = 2
TP_PLAIN = dict(layers=2, prompt=64, steps=8)
TP_PLAIN_ATOL = 1e-3
# the split bf16 logits lie within TP_BF16_BOUND times the one-process
# bf16 logits' own distance from the f32 ones (max abs over max abs)
TP_BF16_BOUND = 2.0
TP_TIMED_STEPS = 8
# qwen2.5-3b's depth in phase 9b, cut as yi-6b's
TP_TRAIN_LAYERS, TP_TRAIN_STEPS, TP_GRAD_TOL = 1, 3, 1e-4
# phase 10: the "model" axis for the recurrent models, RNN_TP_MODEL
# processes: rwkv6-7b and recurrentgemma-9b served split at full width and
# depth (10a, 10b); their f32 cuts (10c) and phi3-medium-14b's over
# PHI3_TP_MODEL processes (10d), each of ``layers`` layers, served split
# (``serve_batch`` sequences of ``prompt`` tokens, CUT_STEPS greedy steps;
# logits within TP_PLAIN_ATOL) and their loss and gradient shards over
# ``grad_batch`` sequences of ``grad_seq`` tokens (within ``grad_tol`` of
# each leaf's largest: the recurrent cuts' GRAD_TOL, as phases 5b's and
# 5c's) against the plain CPU path
RNN_TP_MODEL = TP_MODEL        # its ranks run in phase 9's world
PHI3_TP_MODEL = 4
RNN_TP_ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
CUT_STEPS = 8
TP10_CUTS = {
    "rwkv6-7b": dict(layers=2, serve_batch=2, prompt=64, grad_batch=1,
                     grad_seq=GRAD_SEQ, grad_tol=GRAD_TOL),
    # one super-layer (rec, rec, attn)
    "recurrentgemma-9b": dict(layers=3, serve_batch=2, prompt=64,
                              grad_batch=1, grad_seq=GRAD_SEQ,
                              grad_tol=GRAD_TOL),
    "phi3-medium-14b": dict(layers=2, serve_batch=2, prompt=64, grad_batch=2,
                            grad_seq=64, grad_tol=TP_GRAD_TOL)}
# phase 10's split bf16 logits lie within these of rank 0's one-process
# bf16 logits, max abs difference over max abs: twice the one-process
# bf16 logits' own distance from the f32 ones on the H100 (0.0793 and
# 0.0443 of the max; flat logits under random weights)
RNN_TP_BF16_BOUND = {"rwkv6-7b": 0.16, "recurrentgemma-9b": 0.09}
# the kernels' shapes on a rank of phase 10's two-way split: half of
# rwkv6-7b's 64 heads of 64, half of recurrentgemma-9b's 4096 channels,
# its attention's 8 of 16 query heads over the gathered kv head (D 256,
# window 2048)
TP10_SHAPES = {"rwkv6_prefill": (BATCH, 32, PROMPT, 64),
               "rwkv6_decode": (BATCH, 32, 1, 64),
               "rglru_prefill": (BATCH, PROMPT, 2048),
               "rglru_decode": (BATCH, 1, 2048),
               "flash_d256": (BATCH, 8, 1, PROMPT, PROMPT, 256, True, 2048)}
# phase 11: Mixture-of-Experts under FSDP_RULES.  11a: dbrx-132b and
# qwen3-moe-235b-a22b cut to MOE_TP_LAYERS layers (as phases 4g and 4h
# are)
# served split over phase 9's TP_MODEL processes (experts and heads over
# "model"), the split bf16 logits within MOE_TP_BF16_BOUND times the
# one-process bf16 logits' own distance from the f32 ones.  11b:
# FSDP_ARCH's f32 cut (FSDP_CUT, one layer as phase 5d's) on a FSDP_MESH
# ("data", "model") mesh of processes (experts over "model", every
# leaf's embed rows over "data"): a prefill and CUT_STEPS_FSDP greedy
# steps (4 tokens), loss and gradient boxes,
# against the plain CPU path
MOE_TP_ARCHS = ("dbrx-132b", "qwen3-moe-235b-a22b")
MOE_TP_LAYERS = 1
MOE_TP_BF16_BOUND = TP_BF16_BOUND
FSDP_ARCH = "qwen3-moe-235b-a22b"
FSDP_MESH = (2, 2)
FSDP_CUT = dict(layers=1, serve_batch=2, prompt=64, grad_batch=2,
                grad_seq=64, grad_tol=TP_GRAD_TOL)
CUT_STEPS_FSDP = 3
# 11b's ranks draw the whole f32 cut (14.8 GB) this many at a time, the
# others' boxes (7.4 GB a rank, the engine's and the training shards)
# held meanwhile
FSDP_DRAWS = 2
# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
# at most the SM clock (1.98 GHz): ``torch.cuda._sleep`` spins at least
# as long as asked
SPIN_CYCLES_PER_S = 2.0e9
# the numbers of each kernel in the ``kernels`` line
TIME_KEYS = ("ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "launch_floor_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def _device_us(evt) -> float:
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0))


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn``: ``iters`` calls queued
    behind a spin kernel (``torch.cuda._sleep``) that keeps the card busy
    until the host has enqueued them all, then timed with CUDA events, so
    the card runs them back to back and the host's cost per call (all that
    back-to-back events measure at a launch-bound shape: ``event_ms``)
    stays out.  Every kernel time in the ``kernels`` line is this (``ms``,
    ``plain_ms``, ``library_ms``), of a graph replay for plain versions of
    thousands of launches (``graph_ms``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if enqueue_s < spin_s / 2:
            return start.elapsed_time(end) / iters
        spin_s *= 4
    raise AssertionError(f"the host took {enqueue_s} s to enqueue {iters} "
                         f"calls: the spin kernel cannot hide it")


def graph_ms(fn, iters: int = 5) -> float:
    """``device_ms`` of ``fn`` captured into one CUDA graph and replayed.
    For a plain version that launches more kernels a call than the card's
    launch queue holds (the chunked plain recurrent backwards: thousands
    at a training shape): queued behind the spin kernel, its launches
    block the host once the queue is full, so ``device_ms`` cannot hide
    the host's cost.  A replay is one launch of the same kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm autograd and the allocator
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    try:
        return device_ms(graph.replay, iters)
    finally:
        del graph
        torch.cuda.empty_cache()


def profile_window(fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time, the summed
    time of the kernels the card ran (its busy time), the idle share, the
    kernels by device time and the host ops by self CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=_device_us, reverse=True)
    host = sorted((e for e in events if e.device_type != DeviceType.CUDA),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
        "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0
        else "not measured",
        "kernels": [[e.key[:70], _device_us(e) / 1e3, e.count]
                    for e in kernels[:top]],
        "host_ops": [[e.key[:70], e.self_cpu_time_total / 1e3, e.count]
                     for e in host[:top]],
    }


# --------------------------------------------------------------------------
# phase 2: build
# --------------------------------------------------------------------------
# the tensor-core and TMA instructions each sm90 library must hold: wgmma
# (``HGMMA``) in the flash-attention ones, mma.sync (``HMMA``) in the
# chunked RWKV-6 ones, TMA loads (``UTMALDG``) in all but the chunked RWKV-6
# backward (which loads its tiles with 16-byte loads)
SASS_REQUIRED = {"flash_fwd_sm90": ("HGMMA", "UTMALDG"),
                 "flash_bwd_sm90": ("HGMMA", "UTMALDG"),
                 "rwkv6_sm90": ("HMMA", "UTMALDG"),
                 "rwkv6_bwd_sm90": ("HMMA",),
                 "rglru_sm90": ("UTMALDG",),
                 "rglru_bwd_sm90": ("UTMALDG",)}
# and in the kernels whose (mangled) names hold these: the head-dim-256
# instances of the bf16 backward
SASS_FUNCTION_REQUIRED = {"flash_bwd_sm90": {"dkdv_d256": "HGMMA",
                                             "dq_sm90_kernelILi256E": "HGMMA",
                                             # and at head dim 160
                                             "dkdv_qsplit": "HGMMA",
                                             "dq_sm90_kernelILi160E": "HGMMA"},
                          # the forward's head-dim-160 instance (pixtral-12b)
                          "flash_fwd_sm90": {
                              "flash_fwd_sm90_kernelILi160E": "HGMMA",
                              "sm90_kernelILi160E": "UTMALDG"}}


def sass_counts(path) -> dict:
    """How many wgmma (``HGMMA``), mma.sync (``HMMA``) and TMA-load
    (``UTMALDG``) instructions ``cuobjdump -sass`` finds in one built
    library, and in each of its kernels (``functions``: name -> counts)."""
    from repro_torch.kernels import common

    tool = Path(common.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops = ("HGMMA", "HMMA", "UTMALDG")
    functions = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        functions[name] = {op: part.count(op) for op in ops}
    return {**{op: sass.count(op) for op in ops}, "functions": functions}


def build_kernels():
    from repro_torch.kernels import common
    from repro_torch.kernels.ckpt_codec import kernel as codec_kernel
    from repro_torch.kernels.ckpt_codec import rs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rwkv6 import kernel as rwkv_kernel

    # the flash-attention libraries: f32 FMA kernels and the bf16 sm90 ones
    builders = {name: (lambda name=name: fa_kernel.build(name))
                for name in fa_kernel.LIBRARIES}
    # K6: the sequential kernel and the chunked sm90 one; K7: the register
    # kernel and the TMA one
    for kernel in (rwkv_kernel, rglru_kernel):
        builders.update({name: (lambda name=name, k=kernel: k.build(name))
                         for name in kernel.LIBRARIES})
    builders.update({"ckpt_codec": codec_kernel.build, "rs": rs_kernel.build})
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {n: pool.submit(b) for n, b in builders.items()}
        for f in futures.values():
            f.result()
    log(f"build: {len(builders)} kernel(s) in "
        f"{time.monotonic() - t0:.2f} s wall")
    for name in builders:
        counts = sass_counts(common.library_paths[name])
        log(f"  {name}: nvcc {common.build_seconds.get(name, 0.0):.2f} s, "
            f"HGMMA {counts['HGMMA']}, HMMA {counts['HMMA']}, "
            f"UTMALDG {counts['UTMALDG']}")
        for line in common.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
        missing = [op for op in SASS_REQUIRED.get(name, ()) if not counts[op]]
        for part, op in SASS_FUNCTION_REQUIRED.get(name, {}).items():
            found = [c[op] for f, c in counts["functions"].items()
                     if part in f]
            log(f"    {part}: {op} {found}")
            if not found or not all(found):
                missing.append(f"{op} in {part}")
        if missing:
            counts.pop("functions")
            raise AssertionError(f"{name} has no {missing} instruction: "
                                 f"{counts}")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def _inputs(seed, b, hq, hkv, t, s, d, dtype, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        .to(device, getattr(torch, dtype))
        for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))


def _ref_by_rows(q, k, v, causal, window, rows):
    """The plain version of a causal call, ``rows`` query rows at a time
    (each over the keys up to its last row's), so that no (T, S) score
    matrix lives whole."""
    import torch

    from repro_torch.kernels.flash_attention import attention_ref

    if not causal:
        raise ValueError("query rows are cut only under the causal mask")
    t, off = q.shape[2], k.shape[2] - q.shape[2]
    outs, lses = [], []
    for r0 in range(0, t, rows):
        r1 = min(r0 + rows, t)
        o, lse = attention_ref(q[:, :, r0:r1], k[:, :, :off + r1],
                               v[:, :, :off + r1], causal=True,
                               window=window)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def check_attention_case(case, dtype, device, rows=None) -> float:
    """Kernel against plain on one case; returns the max abs error of the
    output over rows with an allowed key.  bf16 also holds the output's
    error norm to ``FWD_REL_BF16`` of the plain output's.  ``rows``: the
    plain version taken that many query rows at a time."""
    import torch
    from torch_flash_checks import FWD_REL_BF16, fwd_rel_err

    from repro_torch.kernels.flash_attention import attention, attention_ref
    from repro_torch.kernels.flash_attention.ref import allowed_mask

    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, dtype, device)
    out, lse = attention(q, k, v, causal=causal, window=window,
                         return_lse=True)
    if rows is None:
        ref, rlse = attention_ref(q, k, v, causal=causal, window=window)
    else:
        ref, rlse = _ref_by_rows(q, k, v, causal, window, rows)
    torch.cuda.synchronize()
    live = allowed_mask(t, s, causal, window, s - t, device).any(dim=1)
    err = (out.float() - ref.float())[:, :, live].abs().max().item()
    lerr = (lse - rlse)[:, :, live].abs().max().item()
    if not (err <= ATOL[dtype] and lerr <= LSE_ATOL):
        raise AssertionError(f"flash_fwd {case} {dtype}: max abs err {err} "
                             f"(atol {ATOL[dtype]}), lse err {lerr} "
                             f"(atol {LSE_ATOL})")
    if dtype == "bfloat16":
        rel = fwd_rel_err(out, ref, live)
        log(f"  flash_fwd {case} bf16: error norm {rel:.3e} of the plain "
            f"output's (its rms "
            f"{ref.float()[:, :, live].square().mean().sqrt().item():.3e})")
        if not rel <= FWD_REL_BF16:
            raise AssertionError(f"flash_fwd {case} bf16: error norm {rel} "
                                 f"of the plain output's (at most "
                                 f"{FWD_REL_BF16})")
    return err


def check_kernels(path_case, device, sweep=SWEEP) -> float:
    """Every case of ``sweep`` and the path's shape, both dtypes; returns
    the max abs error at the path's shape in bf16."""
    path_err = None
    for case in sweep + [path_case]:
        for dtype in ("float32", "bfloat16"):
            err = check_attention_case(case, dtype, device)
            log(f"  flash_fwd {case} {dtype}: max abs err {err:.3e}")
            if case == path_case and dtype == "bfloat16":
                path_err = err
    return path_err


def check_empty_rows(device) -> None:
    """T > S: the first T - S query rows see no key and must be exact
    zeros."""
    import torch

    from repro_torch.kernels.flash_attention import attention

    q, k, v = _inputs(3, 2, 4, 2, 96, 40, 128, "bfloat16", device)
    out, lse = attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    if not (torch.all(out[:, :, :56] == 0)
            and torch.all(torch.isneginf(lse[:, :, :56]))):
        raise AssertionError("rows without an allowed key are not zero")
    log("  flash_fwd T=96 > S=40: rows without an allowed key are zeros")


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------
def _check_launches(got: dict, want, what: str) -> None:
    """Each kernel named in ``want`` launched exactly that many times."""
    for name, n in (want or {}).items():
        if got[name] != n:
            raise AssertionError(f"{name} launched {got[name]} times in "
                                 f"{what}, want {n}")


def serve_case(cfg):
    """K4's forward case in a dense model's prefill: (b, hq, hkv, t, s, d,
    causal, window)."""
    return (BATCH, cfg.num_heads, cfg.num_kv_heads, PROMPT, PROMPT,
            cfg.resolved_head_dim, True, cfg.window)


def dense_want(cfg):
    """A dense attention model's launches: K4's forward once a layer in
    prefill, never in a one-token decode step (the cache's plain f32
    softmax)."""
    n = cfg.num_layers
    return lambda gen: {"generate": {"flash_fwd": n},
                        "prefill": {"flash_fwd": n},
                        "decode": {"flash_fwd": 0}}


def request_batch(cfg, rng, batch_size, prompt) -> dict:
    """numpy prompt tokens from ``rng``, and the frames (encoder-decoder)
    or patches (VLM) embeddings that go with them, f32 as the engine takes
    them."""
    import numpy as np

    batch = {"tokens": rng.integers(0, cfg.vocab_size, (batch_size, prompt))
             .astype(np.int32)}
    if cfg.frontend == "frames":
        batch["frames"] = rng.standard_normal(
            (batch_size, cfg.num_frames, cfg.d_model), dtype=np.float32)
    if cfg.frontend == "patches":
        batch["patches"] = rng.standard_normal(
            (batch_size, cfg.num_patches, cfg.d_model), dtype=np.float32)
    return batch


def serve_main_path(cfg, params, device, batch_size=BATCH, prompt=PROMPT,
                    gen=GEN, want=None, profile=("prefill", "decode_8")):
    """Serve one batch with iCheck checkpointing and check the restore.
    ``want`` maps "generate", "prefill" and "decode" (the gen - 1 steps
    from the restored state) to the launches each must count, by kernel.
    ``profile`` names the ``torch.profiler`` windows taken on the card:
    one prefill, 8 decode steps.  Returns a dict of counts and wall
    times."""
    import numpy as np
    import torch

    from repro_torch.core import ICheckClient, ICheckCluster
    from repro_torch.core.snapshot import _flatten, _leaf_name, snapshot_pytree
    from repro_torch.serve import ServeEngine, serve_max_len

    want = want or {}
    batch = request_batch(cfg, np.random.default_rng(0), batch_size, prompt)
    max_len = serve_max_len(cfg, prompt, gen)
    engine = ServeEngine(cfg, params, max_len=max_len, device=device)
    res = {}
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        sync = torch.cuda.synchronize if device.type == "cuda" else (
            lambda: None)

        reset_counts()
        sync()
        t0 = time.monotonic()
        out = engine.generate(batch, gen_len=gen, checkpoint_client=client)
        sync()
        res["generate_s"] = time.monotonic() - t0
        res["launches"] = read_counts()
        _check_launches(res["launches"], want.get("generate"), "generate")
        if out.shape != (batch_size, gen) or out.min() < 0 or \
                out.max() >= cfg.vocab_size:
            raise AssertionError(f"bad tokens {out.shape} "
                                 f"[{out.min()}, {out.max()}]")
        t0 = time.monotonic()
        engine.last_commit.wait(timeout=600)
        res["commit_wait_s"] = time.monotonic() - t0
        # the commit's drains to the lower tiers end before anything below
        # is timed, so that no time read here is that of their threads
        res["drain_wait_s"] = settle(cluster)

        t0 = time.monotonic()
        restored = engine.restore_serving_state(client, batch_size)
        sync()
        res["restore_s"] = time.monotonic() - t0

        reset_counts()
        sync()
        t0 = time.monotonic()
        logits, fresh = engine.prefill(batch)
        sync()
        res["prefill_ms"] = (time.monotonic() - t0) * 1e3
        _check_launches(read_counts(), want.get("prefill"), "prefill")
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite")
        got_leaves, want_leaves = list(_flatten(restored)), list(
            _flatten(fresh))
        if [p for p, _ in got_leaves] != [p for p, _ in want_leaves]:
            raise AssertionError("restored state has other leaves than a "
                                 "second prefill's")
        for (path, got), (_, exp) in zip(got_leaves, want_leaves):
            if got.dtype != exp.dtype or not torch.equal(got, exp):
                raise AssertionError(f"restored {_leaf_name(path)} differs "
                                     f"from a second prefill")
        res["state_bytes"] = sum(t.numel() * t.element_size()
                                 for _, t in want_leaves)
        res["state_leaves"] = {_leaf_name(p): list(t.shape)
                               for p, t in want_leaves}

        reset_counts()
        sync()
        t0 = time.monotonic()
        cont = engine.decode_greedy(restored, out[:, :1], gen - 1)
        res["decode_ms_per_token"] = (time.monotonic() - t0) * 1e3 / (gen - 1)
        _check_launches(read_counts(), want.get("decode"), "decode")
        if not np.array_equal(cont, out[:, 1:]):
            raise AssertionError("decode from the restored cache diverged")

        # a second commit of a cache of the same size, timed end to end:
        # snapshot (D2H), register, commit, wait until it lands in L1
        t0 = time.monotonic()
        snap = snapshot_pytree(fresh, step=1)
        client.add_adapt_snapshot(snap)
        client.commit(1, {n: r.parts for n, r in snap.regions.items()}
                      ).wait(timeout=600)
        res["commit_s"] = time.monotonic() - t0
        res["drain_wait_s"] += settle(cluster)
        # the committed bytes, region after region, for K5's check
        res["state_payload"] = np.concatenate(
            [r.parts[0].reshape(-1).view(np.uint8)
             for r in snap.regions.values()])
        del snap
        if device.type == "cuda" and "prefill" in profile:
            # where the time goes, with the cluster's threads alive as in
            # the timed run: one prefill, then 8 decode steps
            res["profile_prefill"] = profile_window(
                lambda: engine.prefill(batch))
        if device.type == "cuda" and "decode_8" in profile:
            _, cache = engine.prefill(batch)
            res["profile_decode_8"] = profile_window(
                lambda: engine.decode_greedy(cache, out[:, :1], 8))
        client.finalize()
    res["tokens"] = out
    return res


def settle(cluster) -> float:
    """Wait until ``cluster``'s drains and uploads to the lower tiers have
    ended; returns the seconds waited."""
    t0 = time.monotonic()
    for report in (cluster.controller.wait_for_drains(timeout=600),
                   cluster.controller.wait_for_uploads(timeout=600)):
        if not report["ok"]:
            raise AssertionError(f"the cluster did not settle: {report}")
    return time.monotonic() - t0


def serve_model_phase(cfg, device, card, line, n_params, want, *,
                      state_bytes=None, subruns=(), plain=None,
                      numbers=dict, profile=("prefill", "decode_8"),
                      reduced=None):
    """``cfg`` at full width through ``serve_main_path``: its parameter
    count held to ``n_params``; random f32 weights from a seeded
    generator, cast to the compute dtype leaf by leaf as ``cast_params``
    casts them (``cast_leaves_``: the engine then keeps the same tensors
    and makes no copy, and the card never holds both); BATCH x
    PROMPT prompt tokens and GEN new ones, then each of ``subruns``
    ((name, batch, prompt, gen, state bytes, config or None for ``cfg``)),
    each run's launches held to ``want(gen)`` and its committed state's
    size to its bytes (None: not held).  Then each cut of ``plain`` (name
    -> ``check_against_plain`` keywords; by default 2 layers, atol 1e-3)
    against the plain CPU path.  The weights are freed, and ``numbers()``
    (kernel numbers at the path's shapes) goes into the ``line`` JSON line
    beside the serving numbers and ``reduced`` (what was cut, and why);
    the ``profile`` windows of the first run follow.  Returns the runs'
    results by name ("serve" first) and the numbers."""
    import torch

    from repro_torch.models import count_params, init_params

    got = count_params(cfg)
    if got != n_params:
        raise AssertionError(f"{cfg.name}: {got} params, want {n_params}")
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    torch.cuda.synchronize()
    log(f"  params: {n_params} f32 in {time.monotonic() - t0:.1f} s")
    init_peak = torch.cuda.max_memory_allocated()
    cast_leaves_(params, getattr(torch, cfg.dtype))
    torch.cuda.synchronize()
    log(f"  cast to {cfg.dtype} leaf by leaf: peak "
        f"{torch.cuda.max_memory_allocated()} bytes, "
        f"{torch.cuda.memory_allocated()} allocated")
    cast_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, batch, prompt, gen, nbytes, *sub in (
            ("serve", BATCH, PROMPT, GEN, state_bytes), *subruns):
        rcfg = (sub and sub[0]) or cfg
        res = serve_main_path(rcfg, params, device, batch_size=batch,
                              prompt=prompt, gen=gen, want=want(gen),
                              profile=profile if name == "serve" else ())
        # the run's engine and its cache are gone: release their memory
        # before the next engine is built
        gc.collect()
        torch.cuda.empty_cache()
        if nbytes is not None and res["state_bytes"] != nbytes:
            raise AssertionError(f"{name}: state of {res['state_bytes']} "
                                 f"bytes, want {nbytes}")
        res["batch"], res["gen"] = batch, gen
        log(f"  {name}: {batch} x {prompt} prompt tokens, {gen} new"
            f"{', int8 KV cache' if rcfg.kv_quant else ''}: "
            f"launches {res['launches']}; state {res['state_bytes']} bytes "
            f"{json.dumps(res['state_leaves'])} restored bit-equal to a "
            f"second prefill; {gen - 1} decode steps from it give the live "
            f"tokens")
        runs[name] = res
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    errs = {}
    for name, kw in (plain or {"plain_cut": {}}).items():
        got = check_against_plain(cfg, params, device, **kw)
        errs[f"{name}_max_abs_err"] = got.pop("max_abs_err")
        errs.update({f"{name}_{k}": v for k, v in got.items()})
        log(f"  {name} {kw}: card vs plain CPU logits max abs err "
            f"{errs[f'{name}_max_abs_err']:.3e} {json.dumps(got)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    nums = numbers()
    res = runs["serve"]
    serve = {
        "card": card, "params": n_params,
        **({"reduced": reduced} if reduced else {}),
        "prefill_ms": res["prefill_ms"],
        "decode_ms_per_token": res["decode_ms_per_token"],
        "output_tokens_per_s": BATCH * GEN / res["generate_s"],
        "generate_wall_s": res["generate_s"],
        "commit_wall_s": res["commit_s"],
        "commit_wait_s": res["commit_wait_s"],
        "drain_wait_s": res["drain_wait_s"],
        "restore_wall_s": res["restore_s"],
        "state_bytes": res["state_bytes"],
        "max_memory_allocated": peak, "init_max_memory_allocated": init_peak,
        "cast_max_memory_allocated": cast_peak, **errs,
        **{name: {**{k: r[k] for k in (
            "prefill_ms", "decode_ms_per_token", "generate_s", "commit_s",
            "restore_s", "state_bytes")},
            "output_tokens_per_s": r["batch"] * r["gen"] / r["generate_s"]}
           for name, r in runs.items() if name != "serve"},
        **nums,
    }
    log(json.dumps({line: serve}))
    for name in profile:
        log(json.dumps({f"{line}_profile_{name}": res[f"profile_{name}"]}))
    return runs, nums


def cast_leaves_(tree, dtype) -> None:
    """Cast ``tree``'s leaves in place in their dicts, one at a time, as
    ``cast_params`` casts them (the leaves it keeps in f32 stay): each f32
    leaf is freed once its copy is made, so the card never holds a second
    copy of the weights."""
    from repro_torch.models import cast_params

    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            cast_leaves_(leaf, dtype)
        else:
            tree[key] = cast_params({key: leaf}, dtype)[key]
        del leaf


def check_against_plain(cfg, params, device, layers=2, atol=1e-3,
                        window=None, prompt=64, steps=0, kv_quant=False):
    """A cut of the model to its first ``layers`` layers (whole super-layers
    plus the tail layers) in f32 (weights drawn in bf16 are widened),
    ``window`` (if given) in place of the config's: the card's logits (the
    kernels) against the plain CPU path's after a ``prompt``-token prefill
    and after each of ``steps`` decode steps, which both devices take with
    the CPU's greedy tokens.  A prompt longer than the window rolls the
    ring cache in prefill; decode steps past it write across the ring's
    wrap.

    With ``kv_quant`` both run the int8 cache.  Its codes on the card may
    lie a step from the CPU's where the f32 K or V of the two devices fall
    on either side of a rounding edge, and its f16 scales an f16 step
    where the f32 absmax does.  So after the decode steps the card's
    codes and scales of every layer (the prefill's and the decode steps')
    are held to one step of the CPU's, codes on at most ``Q8_SHARE`` of
    them and scales on at most ``Q8_SCALE_SHARE``.  Every code of the
    CPU's own cache lies up to half a step from its value, and those half
    steps (rms 1/sqrt(12) of a step) move the CPU's logits from the exact
    cache's by ``int8_vs_exact`` (measured here); a flipped code is off
    by a whole step, and errors of independent codes add in quadrature,
    so flips on a share p of the codes move the logits by about
    sqrt(12 p) times that, and scales a step apart on a share q by at
    most sqrt(12 q) ``Q8_SCALE_STEP`` times that.  The card's logits are
    held to ``atol`` plus the sum of the two at the shares' bounds, and
    every argmax to the CPU's.

    A MoE model's routing is recorded in every layer of every call on both
    devices (``recording_routes``): the card's expert ids must equal the
    CPU's after prefill and after each decode step, and every argmax the
    CPU's.  A flipped id is reported with the CPU's probability gap
    between the k-th and the (k+1)-th expert of that token, and fails the
    check.  Returns ``max_abs_err`` and, with ``kv_quant`` or a MoE
    model, those numbers."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serve import serve_max_len

    small = cut_config(cfg, layers, window=window or cfg.window,
                       kv_quant=kv_quant)
    cut = cut_params(small, params)
    inputs = request_batch(cfg, np.random.default_rng(1), 2, prompt)
    max_len = serve_max_len(small, prompt, steps)
    runs = [("cpu", small, torch.device("cpu")), ("card", small, device)]
    if kv_quant:
        runs.insert(1, ("exact", dataclasses.replace(small, kv_quant=False),
                        torch.device("cpu")))
    logits, q8, routes = {}, {}, {}
    for name, c, dev in runs:
        p = _map(lambda t: t.to(dev).float(), cut)
        cache = init_cache(c, 2, max_len, device=dev)
        with torch.no_grad(), recording_routes(routes.setdefault(name, [])):
            lg, cache = prefill(c, p, {k: torch.from_numpy(v).to(dev)
                                       for k, v in inputs.items()}, cache)
            out = [lg.float().cpu()]
            greedy = logits.get("cpu", out)     # the CPU's tokens drive all
            for i in range(steps):
                nxt = greedy[i].argmax(-1)[:, None].to(dev)
                lg, cache = decode_step(c, p, cache, nxt)
                out.append(lg.float().cpu())
        if c.kv_quant:
            q8[name] = _int8_leaves(cache)
        logits[name] = out
        del p, cache

    def max_err(a, b):
        return max((x - y).abs().max().item()
                   for x, y in zip(logits[a], logits[b]))
    err = max_err("card", "cpu")
    res = {"max_abs_err": err}
    if cfg.ffn == "moe":
        res.update(_compare_routes(routes["card"], routes["cpu"],
                                   cfg.experts_per_token))
        for i, (g, w) in enumerate(zip(logits["card"], logits["cpu"])):
            if not torch.equal(g.argmax(-1), w.argmax(-1)):
                raise AssertionError(f"MoE cut: argmax differs at step {i}")
    tol = atol
    if kv_quant:
        e_q = max_err("cpu", "exact")
        tol = atol + (math.sqrt(12 * Q8_SHARE) + Q8_SCALE_STEP
                      * math.sqrt(12 * Q8_SCALE_SHARE)) * e_q
        res.update(int8_vs_exact=e_q, atol=tol)
        for what, share in (("codes", Q8_SHARE), ("scales", Q8_SCALE_SHARE)):
            # positive f16 scales order as their bits do: one f16 step
            # is one apart as int16
            step = torch.cat([
                (g.view(torch.int16).int() - w.view(torch.int16).int())
                .abs().reshape(-1) if what == "scales" else
                (g.int() - w.int()).abs().reshape(-1)
                for g, w in zip(q8["card"][what], q8["cpu"][what])])
            res.update({what: step.numel(),
                        f"{what}_one_step_apart": int((step > 0).sum()),
                        f"{what}_max_step": int(step.max())})
            if res[f"{what}_max_step"] > 1 or \
                    res[f"{what}_one_step_apart"] > share * step.numel():
                raise AssertionError(f"int8 cut: card {what} against the "
                                     f"CPU's {res}")
        for i, (g, w) in enumerate(zip(logits["card"], logits["cpu"])):
            if not torch.equal(g.argmax(-1), w.argmax(-1)):
                raise AssertionError(f"int8 cut: argmax differs at step {i}")
    if not err <= tol:
        raise AssertionError(
            f"{layers}-layer f32 cut (window {small.window}, {prompt} prompt "
            f"tokens, {steps} decode steps, kv_quant {kv_quant}): card vs "
            f"plain CPU logits max abs err {err} (atol {tol})")
    return res


@contextlib.contextmanager
def recording_routes(out: list):
    """Within the block, every ``moe.route`` call (a MoE layer's router,
    in layer order, prefill then each decode step) appends its f32
    probabilities and expert ids, on the CPU, to ``out``."""
    from repro_torch.models import moe

    route = moe.route

    def recorded(params, x, k):
        probs, top_p, ids = route(params, x, k)
        out.append((probs.detach().float().cpu(), ids.cpu()))
        return probs, top_p, ids
    moe.route = recorded
    try:
        yield out
    finally:
        moe.route = route


@contextlib.contextmanager
def replaying_routes(ids: list, out: list):
    """Within the block, the i-th ``moe.route`` call routes by the i-th of
    ``ids`` (another run's ``recording_routes``: (probabilities, expert
    ids)), its weights gathered from its own probabilities at them, and
    appends its own probabilities and choice of experts to ``out``."""
    import torch

    from repro_torch.models import moe

    route = moe.route
    calls = iter(ids)

    def replayed(params, x, k):
        probs, _, own = route(params, x, k)
        out.append((probs.detach().float().cpu(), own.cpu()))
        forced = next(calls)[1].to(own.device)
        return probs, torch.gather(probs, -1, forced), forced
    moe.route = replayed
    try:
        yield out
    finally:
        moe.route = route


def _compare_routes(card, cpu, k) -> dict:
    """The card's expert ids against the CPU's, call by call; a token whose
    ids differ is reported with the CPU's gap between its k-th and
    (k+1)-th probabilities, and fails."""
    if len(card) != len(cpu):
        raise AssertionError(f"MoE cut: {len(card)} router calls on the "
                             f"card, {len(cpu)} on the CPU")
    n, flips = 0, []
    for call, ((_, g), (probs, w)) in enumerate(zip(card, cpu)):
        n += w.numel()
        bad = (g != w).any(-1)
        if bad.any():
            top = probs.sort(-1, descending=True).values[bad]
            flips += [{"call": call, "token": list(map(int, idx)),
                       "kth_gap": float(gap)}
                      for idx, gap in zip(bad.nonzero().tolist(),
                                          top[:, k - 1] - top[:, k])]
    res = {"expert_ids": n, "router_calls": len(cpu),
           "expert_id_flips": len(flips), "first_flips": flips[:20]}
    if flips:
        raise AssertionError(f"MoE cut: the card's expert ids differ from "
                             f"the CPU's: {json.dumps(res)}")
    return res


def _int8_leaves(cache) -> dict:
    """The int8 codes (``k``, ``v``) and f16 scales (``ks``, ``vs``) of
    every layer of ``cache``, on the CPU."""
    from repro_torch.models.attention import KVCache

    out = {"codes": [], "scales": []}

    def walk(x):
        if isinstance(x, KVCache):
            out["codes"] += [x.k.cpu(), x.v.cpu()]
            out["scales"] += [x.ks.cpu(), x.vs.cpu()]
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(cache)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cut_config(cfg, layers, **over):
    """``cfg`` cut to ``layers`` layers, and an encoder-decoder's encoder
    to as many, in f32."""
    if cfg.is_encdec:
        over["encoder_layers"] = layers
    return dataclasses.replace(cfg, num_layers=layers, dtype="float32",
                               **over)


def cut_params(small, params):
    """The leaves of ``params`` a cut config ``small`` has: the first
    layers of each stack (views, no copies)."""
    from repro_torch.models import stack_plan

    plan = stack_plan(small)
    lead = {"stack": plan["scan_len"], "enc": plan["enc_layers"]}
    return {k: _map(lambda t, n=lead[k]: t[:n], v) if k in lead else v
            for k, v in params.items()}


# --------------------------------------------------------------------------
# phase 5: kernel numbers at the path's shape
# --------------------------------------------------------------------------
def attention_numbers(path_case, device):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import allowed_mask

    b, hq, hkv, t, s, d, causal, window = path_case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, "bfloat16", device)
    scale = d ** -0.5

    def kernel():
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale)

    plain_ms = device_ms(lambda: attention_ref(q, k, v, causal=causal,
                                               window=window), iters=5)
    # yardstick only, never called by the port; at T = S its top-left
    # causal alignment equals the reference's bottom-right one
    try:
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
    except TypeError:        # a torch without enable_gqa
        g = hq // hkv
        ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=causal))
    pairs = int(allowed_mask(t, s, causal, window, s - t).sum())
    flops = 4 * b * hq * d * pairs             # Q.K^T and P.V, 2 per MAC
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
        + b * hq * t * 4                       # out bf16, lse f32
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"ms": device_ms(kernel), "event_ms": cuda_ms(kernel),
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


# --------------------------------------------------------------------------
# phase 3b: the backward and codec kernels against their plain versions
# --------------------------------------------------------------------------
def check_bwd_case(case, dtype, device, determinism=False) -> float:
    """Backward kernel against the plain backward from the same (q, k, v,
    out, lse, do); returns the max abs error over dq, dk, dv.  f32: within
    ``BWD_TOL``.  bf16: the kernel rounds P and dS to bf16 for its tensor
    cores, as SDPA does, so each of dq, dk, dv must lie within twice SDPA's
    error of the plain backward run on f32 copies of the inputs, in max
    abs and over each tile of rows (``check_bf16_grads``)."""
    import torch
    from torch_flash_checks import check_bf16_grads, sdpa_grads, summary

    from repro_torch.kernels.flash_attention import attention_bwd_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd_cuda

    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, dtype, device)
    dout = _inputs(8, b, hq, hkv, t, s, d, dtype, device)[0]
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    err = 0.0
    if dtype == "float32":
        want = attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        atol, rtol = BWD_TOL[dtype]
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            diff = (g.float() - w.float()).abs()
            err = max(err, diff.max().item())
            if not bool((diff <= atol + rtol * w.float().abs()).all()):
                raise AssertionError(f"flash_bwd {case} {dtype} {name}: max "
                                     f"abs err {diff.max().item()} (atol "
                                     f"{atol}, rtol {rtol})")
    else:
        want = attention_bwd_ref(q.float(), k.float(), v.float(),
                                 out.float(), lse, dout.float(), **kw)
        lib = sdpa_grads(q, k, v, dout, causal, window)
        torch.cuda.synchronize()
        res = check_bf16_grads(f"flash_bwd {case} bf16", got, want, lib)
        err = max(r["max_abs"] for r in res.values())
        log(f"  flash_bwd {case} bf16 against f32: {summary(res)}")
    if determinism:
        again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"flash_bwd {case} {dtype}: two runs differ")
    return err


def check_bwd(path_case, device, sweep=SWEEP) -> float:
    """``sweep`` and the training path's shape, both dtypes, two runs
    bit-equal each; returns the max abs error at the path's shape in
    bf16."""
    import torch

    for case in sweep + [path_case]:
        for dtype in ("float32", "bfloat16"):
            err = check_bwd_case(case, dtype, device, determinism=True)
            log(f"  flash_bwd {case} {dtype}: max abs err {err:.3e}; two "
                f"runs bit-equal")
        torch.cuda.empty_cache()
    return err


def _codec_input(n, dtype, device, seed):
    import numpy as np
    import torch

    if n <= 1 << 20:
        x = np.random.default_rng(seed + n).standard_normal(n) \
            .astype(np.float32) * 3
        return torch.from_numpy(x).to(device, getattr(torch, dtype))
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=g, device=device) \
        .mul_(0.02).to(getattr(torch, dtype))


def check_codec(ns, device) -> int:
    """K1-K3 against their plain versions; returns the total number of
    mismatching codes, deltas, scales and values (must be 0)."""
    import torch

    from repro_torch.kernels.ckpt_codec import kernel as K
    from repro_torch.kernels.ckpt_codec import ref as R
    from repro_torch.kernels.ckpt_codec.ops import _to_blocks

    total = 0
    for n in ns:
        for dtype in CODEC_DTYPES:
            x = _codec_input(n, dtype, device, 0)
            b0 = _to_blocks(x)[0]
            q, s = K.quantize_cuda(b0)
            rq, rs = R.quantize_ref(b0)
            bad = int((q != rq).sum()) + int((s != rs).sum())
            del b0, x, rs
            x1 = _codec_input(n, dtype, device, 1)
            b1 = _to_blocks(x1)[0]
            del x1
            d, s1, q1 = K.quantize_delta_cuda(b1, q)
            rd, rs1, rq1 = R.quantize_delta_ref(b1, rq)
            del b1, rq
            bad += int((d != rd).sum()) + int((s1 != rs1).sum()) \
                + int((q1 != rq1).sum())
            del d, rd, rs1, rq1, q
            for out_dtype in (torch.float32, getattr(torch, dtype)):
                y = K.dequantize_cuda(q1, s1, out_dtype)
                ry = R.dequantize_ref(q1, s1, out_dtype)
                bad += int((y != ry).sum())
                del y, ry
            torch.cuda.synchronize()
            del q1, s1
            log(f"  codec n={n} {dtype}: {bad} mismatches (codes, deltas, "
                f"scales, values)")
            total += bad
    if total:
        raise AssertionError(f"codec kernels: {total} mismatches")
    return total


# --------------------------------------------------------------------------
# phase 3 / 4b / 4c: K6 against its plain version, RWKV-6 serving, K5
# --------------------------------------------------------------------------
def _rwkv_inputs(seed, case, dtype, device, decay_scale=1.0):
    """r/k/v (dtype), log_w, u, s0 (f32) for one (b, h, t, d) case, made
    with numpy from ``seed`` as tests/test_kernels_rwkv6.py makes them."""
    import numpy as np
    import torch

    b, h, t, d = case
    rng = np.random.default_rng(seed)

    def f(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)

    r, k, v = (f((b, h, t, d), 0.5).to(getattr(torch, dtype))
               for _ in range(3))
    lw = -torch.exp(f((b, h, t, d), 1.0)) * decay_scale
    return r, k, v, lw, f((h, d), 0.5), f((b, h, d, d), 0.1)


def _rwkv_err(got, want, dtype, what) -> float:
    import torch

    atol, rtol = RWKV_TOL[dtype]
    err = 0.0
    for name, g, w in (("o", *[x[0].float() for x in (got, want)]),
                       ("sT", got[1], want[1])):
        diff = (g - w).abs()
        err = max(err, diff.max().item())
        tol = atol + (rtol if name == "o" else 0.0) * w.abs()
        if not bool(torch.all(diff <= tol)):
            raise AssertionError(f"rwkv6 {what} {name}: max abs err "
                                 f"{diff.max().item()} (atol {atol}, rtol "
                                 f"{rtol if name == 'o' else 0})")
    return err


def check_rwkv6(path_cases, device) -> dict:
    """K6 against its plain chunked version on the card: the sweep and the
    path's shapes from a carried state, the sequential kernel in f32 and
    bf16 and the chunked sm90 one in bf16, extreme decay, and state
    continuations; returns each kernel's max abs error at the shape where
    the path runs it (prefill for sm90, decode for the sequential one)."""
    import torch

    from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_chunked
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda, rwkv6_sm90_cuda

    kernels = {"rwkv6": rwkv6_cuda, "rwkv6_sm90": rwkv6_sm90_cuda}
    errs = {}
    for case in RWKV_SWEEP + list(path_cases.values()):
        for name, dtype in (("rwkv6", "float32"), ("rwkv6", "bfloat16"),
                            ("rwkv6_sm90", "bfloat16")):
            inputs = _rwkv_inputs(3, case, dtype, device)
            got = kernels[name](*inputs)
            again = kernels[name](*inputs)
            want = rwkv6_chunked(*inputs)
            torch.cuda.synchronize()
            what = f"{name} {case} {dtype}"
            err = _rwkv_err(got, want, dtype, what)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{what}: two runs differ")
            log(f"  {what}: max abs err {err:.3e}")
            path = "prefill" if name == "rwkv6_sm90" else "decode"
            if case == path_cases[path] and dtype == "bfloat16":
                errs[name] = err
    for scale in (10.0, 100.0):
        for name, dtype in (("rwkv6", "float32"), ("rwkv6_sm90", "bfloat16")):
            inputs = _rwkv_inputs(4, (1, 2, 96, 32), dtype, device, scale)
            if not bool((inputs[3] < -30).any()):
                raise AssertionError("the extreme-decay case has no log_w "
                                     "< -30")
            got = kernels[name](*inputs)
            if not (torch.isfinite(got[0]).all()
                    and torch.isfinite(got[1]).all()):
                raise AssertionError(f"{name} decay x{scale}: not finite")
            err = _rwkv_err(got, rwkv6_chunked(*inputs, chunk=32), dtype,
                            f"{name} decay x{scale}")
            log(f"  {name} (1, 2, 96, 32) {dtype} log_w x{scale} (below -30, "
                f"clamped): max abs err {err:.3e}")
    # continuations through the routed op: f32 runs the sequential kernel,
    # bf16 the chunked one (each half has more than one token)
    t = path_cases["prefill"][2]
    for dtype, split, tol in (("float32", t // 2, None),
                              ("bfloat16", t // 2, None),
                              ("bfloat16", 200, RWKV_TOL["bfloat16"])):
        r, k, v, lw, u, s0 = _rwkv_inputs(5, path_cases["prefill"], dtype,
                                          device)
        o, s = rwkv6(r, k, v, lw, u, s0)
        o1, s1 = rwkv6(*(x[:, :, :split] for x in (r, k, v, lw)), u, s0)
        o2, s2 = rwkv6(*(x[:, :, split:] for x in (r, k, v, lw)), u, s1)
        got = (torch.cat([o1, o2], 2), s2)
        if tol is None:      # the same chunks either way
            err = max((got[0].float() - o.float()).abs().max().item(),
                      (got[1] - s).abs().max().item())
            if not err <= 1e-5:
                raise AssertionError(f"rwkv6 {dtype} continuation at {split}"
                                     f": max abs err {err}")
            bound = "atol 1e-5"
        else:
            err = _rwkv_err(got, (o, s), dtype, f"continuation at {split}")
            bound = f"atol {tol[0]}, rtol {tol[1]}"
        log(f"  rwkv6 {dtype} [0, {split}) then [{split}, {t}) vs one shot "
            f"at {path_cases['prefill']}: max abs err {err:.3e} ({bound})")
    return errs


def _rwkv_bwd_inputs(seed, case, dtype, device, decay_scale=1.0):
    """The forward's inputs (``_rwkv_inputs``) and the cotangents do (in
    dtype) and dsT (f32) of (o, sT)."""
    import numpy as np
    import torch

    b, h, t, d = case
    rng = np.random.default_rng(seed + 100)
    do = torch.from_numpy(rng.standard_normal(case).astype(np.float32)).to(
        device, getattr(torch, dtype))
    dsT = torch.from_numpy(rng.standard_normal((b, h, d, d)).astype(
        np.float32)).to(device)
    return _rwkv_inputs(seed, case, dtype, device, decay_scale), do, dsT


def check_rwkv6_bwd(path_case, device) -> dict:
    """K6's two backward kernels against the plain backward (the vjp of
    the chunked form, log_w unclamped) on the card: atol 2e-3 (the
    reference's kernel tests) + rtol 1e-5, bf16 dr, dk, dv + rtol 2^-7;
    from s0 and from none, with a nonzero dsT; two runs bit-equal; log_w
    x10 and x100 (below -30), each gradient also within |L| 2^-23 of the
    call's largest (L the largest cumulative log-decay over a chunk of the
    plain version: its exponents' f32 resolution).  The sequential
    ``rwkv6_bwd`` over the sweep and the training path's shape in f32 and
    bf16, its extreme decays in f32; the chunked ``rwkv6_bwd_sm90`` (bf16)
    over the sweep's cases of at least ``ops.SM90_MIN_T`` tokens and the
    training path's shape, its extreme decays in bf16.  Returns each
    kernel's max abs error at the path's shape in bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rwkv6.kernel import (rwkv6_bwd_cuda,
                                                  rwkv6_bwd_sm90_cuda)
    from repro_torch.kernels.rwkv6.ops import SM90_MIN_T
    from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

    def err_of(got, want, dtype, what, extra=0.0):
        atol, rtol = RWKV_TOL[dtype]
        err = 0.0
        for name, x, w in zip(("dr", "dk", "dv", "dlog_w", "du", "ds0"),
                              got, want):
            if w is None:
                continue
            diff = (x.float() - w.float()).abs()
            rt = 1e-5 + (rtol if name in ("dr", "dk", "dv") else 0.0)
            if not bool(torch.all(diff <= atol + extra
                                  + rt * w.float().abs())):
                raise AssertionError(f"{what} {name}: max abs err "
                                     f"{diff.max().item()}")
            err = max(err, diff.max().item())
        return err

    kernels = {"rwkv6_bwd": (rwkv6_bwd_cuda, ("float32", "bfloat16")),
               "rwkv6_bwd_sm90": (rwkv6_bwd_sm90_cuda, ("bfloat16",))}
    path_err = {}
    for name, (run, dtypes) in kernels.items():
        cases = [c for c in RWKV_SWEEP
                 if name == "rwkv6_bwd" or c[2] >= SM90_MIN_T]
        for case in cases + [path_case]:
            for dtype in dtypes:
                (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(
                    3, case, dtype, device)
                for s0_ in (s0, None):
                    got = run(r, k, v, lw, u, s0_, do, dsT)
                    again = run(r, k, v, lw, u, s0_, do, dsT)
                    want = rwkv6_bwd_ref(r, k, v, lw, u, s0_, do, dsT)
                    torch.cuda.synchronize()
                    what = f"{name} {case} {dtype} s0={s0_ is not None}"
                    err = err_of(got, want, dtype, what)
                    if not all(x is None or torch.equal(x, y)
                               for x, y in zip(got, again)):
                        raise AssertionError(f"{what}: two runs differ")
                    log(f"  {what}: max abs err {err:.3e}")
                    if case == path_case and dtype == "bfloat16":
                        path_err[name] = max(path_err.get(name, 0.0), err)
        for scale in (10.0, 100.0):
            case, dtype = (1, 2, 96, 32), dtypes[0]
            (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(
                4, case, dtype, device, scale)
            if not bool((lw < -30).any()):
                raise AssertionError("the extreme-decay case has no log_w "
                                     "< -30")
            got = run(r, k, v, lw, u, s0, do, dsT)
            want = rwkv6_bwd_ref(r, k, v, lw, u, s0, do, dsT)
            if not all(torch.isfinite(x.float()).all() for x in got):
                raise AssertionError(f"{name} decay x{scale}: not finite")
            L = F.pad(lw, (0, 0, 0, 32)).reshape(1, 2, 2, 64, 32) \
                .cumsum(3).abs().max().item()
            top = max(w.float().abs().max().item() for w in want)
            err = err_of(got, want, dtype, f"{name} decay x{scale}",
                         L * 2.0 ** -23 * top)
            log(f"  {name} {case} {dtype} log_w x{scale} (below -30, "
                f"unclamped): max abs err {err:.3e} (|L| {L:.1f})")
    return path_err


def backward_split(rwkv_case, d256_case, device) -> dict:
    """One call each of K6's chunked backward and K4's bf16 backward at head
    dim 256, at the training paths' shapes, under ``torch.profiler``: the
    device time of each of their kernels.  Taken in phase 3: late in a run
    the profiler drops these launches (PERF.md §7)."""
    import torch

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd_cuda
    from repro_torch.kernels.rwkv6.kernel import rwkv6_bwd_sm90_cuda

    (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(3, rwkv_case,
                                                     "bfloat16", device)
    b, hq, hkv, t, s, d, causal, window = d256_case
    q, kk, vv = _inputs(7, b, hq, hkv, t, s, d, "bfloat16", device)
    dout = _inputs(8, b, hq, hkv, t, s, d, "bfloat16", device)[0]
    out, lse = attention_ref(q, kk, vv, causal=causal, window=window)
    calls = {
        "rwkv6_bwd_sm90": lambda: rwkv6_bwd_sm90_cuda(r, k, v, lw, u, s0,
                                                      do, dsT),
        "flash_bwd_d256": lambda: flash_attention_bwd_cuda(
            q, kk, vv, out, lse, dout, causal=causal, window=window,
            scale=d ** -0.5)}
    res = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        p = profile_window(fn, top=6)
        res[name] = {"device_busy_ms": p["device_busy_ms"],
                     "kernels": p["kernels"]}
    return res


def rwkv6_bwd_numbers(case, device) -> dict:
    """K6's backward at rwkv6-7b's training shape (bf16 r/k/v/do, f32 log_w,
    u, s0 and dsT): the chunked kernel's ``device_ms`` and ``event_ms``,
    the plain backward's ``graph_ms``, and its bound: the larger of the
    bytes (each input read once, each output written once) and the chunked
    form's products at the bf16 rate (a chunk of C = 64 tokens: U, V, do
    S^T, v G'^T and Kd G', each 2 C D^2 FLOP, and dA, A and the three
    intra-chunk products with dA and A, each C^2 D over the lower
    triangle).  ``sequential_design``: the sequential kernel's
    ``device_ms`` at the same inputs, with its bound, the six D x D
    products a token of its recurrence (12 D^2 FLOP) at the f32 rate."""
    from repro_torch.kernels.rwkv6.kernel import (BWD_CHUNK, rwkv6_bwd_cuda,
                                                  rwkv6_bwd_sm90_cuda)
    from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

    b, h, t, d = case
    (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(3, case, "bfloat16",
                                                     device)
    n = b * h * t * d
    nbytes = n * (4 * 2 + 4 + 3 * 2 + 4) + 2 * h * d * 4 \
        + 3 * b * h * d * d * 4
    t_bytes = nbytes / PEAK_HBM_BYTES
    out = {}
    for name, run, flops, peak in (
            ("chunked", rwkv6_bwd_sm90_cuda,
             b * h * -(-t // BWD_CHUNK)
             * (12 * BWD_CHUNK * d * d + 5 * BWD_CHUNK ** 2 * d),
             PEAK_BF16_FLOPS),
            ("sequential", rwkv6_bwd_cuda, 12 * b * h * t * d * d,
             PEAK_F32_FLOPS)):
        def kernel():
            return run(r, k, v, lw, u, s0, do, dsT)

        t_ops = flops / peak
        out[name] = {"ms": device_ms(kernel, iters=5),
                     "event_ms": cuda_ms(kernel, iters=5),
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "flops": flops}
    plain_ms = graph_ms(lambda: rwkv6_bwd_ref(r, k, v, lw, u, s0, do, dsT))
    return {**out["chunked"], "plain_ms": plain_ms, "library_ms": None,
            "sequential_design": {**out["sequential"], "plain_ms": plain_ms,
                                  "library_ms": None}}


def rwkv6_numbers(case, device, name) -> dict:
    """K6's kernel ``name`` at one of the path's shapes (bf16 r/k/v): its
    device time and its plain version's (``device_ms``), the CUDA-event
    time, and its bound: the larger of the bytes (each input read once and
    each output written once) and the chunked form's four products a chunk
    (r exp(Lx) S, the pairwise scores, A v, the state's k^T v) at the bf16
    tensor rate.  ``sequential_bound_ms`` is the sequential design's: 5
    f32 operations per state element per token (the decay's multiply-add,
    k v's product, r S's multiply-add) at the f32 rate; it goes into the
    serving phase's line only, not the ``kernels`` line, whose one bound
    is ``bound_ms``."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda, rwkv6_sm90_cuda

    run = {"rwkv6": rwkv6_cuda, "rwkv6_sm90": rwkv6_sm90_cuda}[name]
    b, h, t, d = case
    inputs = _rwkv_inputs(3, case, "bfloat16", device)
    ms = device_ms(lambda: run(*inputs))
    event_ms = cuda_ms(lambda: run(*inputs))
    plain_ms = device_ms(lambda: rwkv6_chunked(*inputs), iters=3)
    nbytes = b * h * t * d * (3 * 2 + 4 + 2) + h * d * 4 \
        + 2 * b * h * d * d * 4
    chunk = 64
    flops = 4 * 2 * chunk * d * d * -(-t // chunk) * b * h
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    seq_flops = 5 * b * h * t * d * d
    return {"ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "sequential_bound_ms": max(seq_flops / PEAK_F32_FLOPS,
                                       t_bytes) * 1e3}


def rwkv6_route_ms(case, device, ts=(1, 16, 24, 32, 64)) -> dict:
    """Both K6 kernels' ``device_ms`` at (B, H, T, D) = ``case`` with T
    from ``ts``, bf16: the measurement behind ``ops.SM90_MIN_T``.  Fails
    unless the sequential kernel is the faster below ``SM90_MIN_T`` tokens
    and the chunked one from it, so a crossover that moves shows."""
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda, rwkv6_sm90_cuda
    from repro_torch.kernels.rwkv6.ops import SM90_MIN_T

    b, h, _, d = case
    out = {"sm90_min_t": SM90_MIN_T}
    for t in ts:
        inputs = _rwkv_inputs(3, (b, h, t, d), "bfloat16", device)
        sm90 = device_ms(lambda: rwkv6_sm90_cuda(*inputs))
        seq = device_ms(lambda: rwkv6_cuda(*inputs))
        out[str(t)] = {"rwkv6_sm90": sm90, "rwkv6": seq}
        log(f"  rwkv6 route at T = {t}: chunked {sm90:.5f} ms, sequential "
            f"{seq:.5f} ms (ops.SM90_MIN_T = {SM90_MIN_T})")
        if (sm90 < seq) != (t >= SM90_MIN_T):
            raise AssertionError(
                f"rwkv6 at T = {t}: chunked {sm90} ms, sequential {seq} ms; "
                f"ops.SM90_MIN_T = {SM90_MIN_T} routes it to the slower")
    return out


def check_rs(device, payload) -> dict:
    """K5 bit for bit against ``rs.rs_encode_np``: k in {1, 2, 4, 8}, m in
    {1, 2}, unaligned strides, then k = 4, m = 2 over ``payload`` split as
    ``rs.split_rows`` splits it.  Counts are set to 0 before and read
    after; then K5's numbers on the payload."""
    import numpy as np
    import torch

    from repro_torch.kernels.ckpt_codec import (rs_encode, rs_encode_np,
                                                split_rows)
    from repro_torch.kernels.ckpt_codec.rs_kernel import (rs_encode_cuda,
                                                          rs_encode_ref)

    bad = 0
    reset_counts()
    for k in (1, 2, 4, 8):
        for m in (1, 2):
            for n in RS_STRIDES:
                data = np.random.default_rng(10 * k + n).integers(
                    0, 256, (k, n), dtype=np.uint8)
                got = rs_encode(torch.from_numpy(data).to(device), m=m)
                bad += int((got.cpu().numpy() != rs_encode_np(data, m))
                           .sum())
    log(f"  rs_encode k in (1, 2, 4, 8) x m in (1, 2) x strides "
        f"{RS_STRIDES}: {bad} mismatching bytes")
    rows = split_rows(payload.tobytes(), 4)
    dev = torch.from_numpy(rows).to(device)
    got = rs_encode(dev, m=2)
    state_bad = int((got.cpu().numpy() != rs_encode_np(rows, 2)).sum())
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"  rs_encode k=4 m=2 over the {payload.size}-byte RWKV state "
        f"(stride {rows.shape[1]}): {state_bad} mismatching bytes")
    bad += state_bad
    if bad:
        raise AssertionError(f"rs_encode: {bad} bytes differ from the host "
                             f"codec")
    nbytes = (rows.shape[0] + 2) * rows.shape[1]
    numbers = {"k": 4, "m": 2, "stride": int(rows.shape[1]),
               "ms": device_ms(lambda: rs_encode_cuda(dev, 2)),
               "event_ms": cuda_ms(lambda: rs_encode_cuda(dev, 2)),
               "plain_ms": device_ms(lambda: rs_encode_ref(dev, 2), iters=2),
               "library_ms": None,
               "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
               "bound_by": "bytes", "bytes": nbytes}
    return {"launches": launches, "mismatches": bad, "numbers": numbers}


# --------------------------------------------------------------------------
# phase 3 / 4d: K7 against its plain version, recurrentgemma serving
# --------------------------------------------------------------------------
def _rglru_inputs(seed, case, dtype, device):
    """log_a, g (dtype), h0 (f32) for one (b, t, d) case, made with numpy
    from ``seed`` as tests/test_kernels_rglru.py makes them."""
    import numpy as np
    import torch

    b, t, d = case
    rng = np.random.default_rng(seed)
    la = -np.exp(rng.standard_normal((b, t, d))).astype(np.float32)
    g = rng.standard_normal((b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return (torch.from_numpy(la).to(device),
            torch.from_numpy(g).to(device, getattr(torch, dtype)),
            torch.from_numpy(h0).to(device))


def _rglru_err(got, want, dtype, what) -> float:
    import torch

    atol, rtol = RGLRU_TOL[dtype]
    dh = (got[0].float() - want[0].float()).abs()
    dT = (got[1] - want[1]).abs()
    if not (bool(torch.all(dh <= atol + rtol * want[0].float().abs()))
            and dT.max().item() <= atol):
        raise AssertionError(
            f"{what}: max abs err h {dh.max().item()}, h_final "
            f"{dT.max().item()} (atol {atol}, rtol {rtol} on h)")
    return max(dh.max().item(), dT.max().item())


def check_rglru(path_cases, device) -> dict:
    """K7's two kernels against their plain chunked version on the card:
    the sweep and the path's shapes (T = 1 at decode), with h0 and
    without, f32 and bf16 g; each kernel's two runs bit-equal, and the TMA
    kernel bit-equal to the register kernel at every case (the same f32
    steps, below ``ops.SM90_MIN_T`` too).  Through ``ops.rglru``: [0, T/2)
    then [T/2, T), and [0, T - 8) then 8 one-token steps (the prefill to
    decode hand-off, across the two kernels), equal to one shot.  Returns
    each kernel's max abs error at the shape where the path runs it (bf16
    g, with h0): the prefill for ``rglru_sm90``, decode for ``rglru``."""
    import torch

    from repro_torch.kernels.rglru import rglru, rglru_chunked
    from repro_torch.kernels.rglru.kernel import (rglru_cuda,
                                                  rglru_sm90_cuda,
                                                  row_multiple)

    errs = {}
    for case in RGLRU_SWEEP + list(path_cases.values()):
        for dtype in ("float32", "bfloat16"):
            la, g, h0 = _rglru_inputs(3, case, dtype, device)
            kernels = {"rglru": rglru_cuda, "rglru_sm90": rglru_sm90_cuda}
            if case[2] % row_multiple(g.dtype):     # rows TMA cannot read
                del kernels["rglru_sm90"]
            for init in (h0, None):
                want = rglru_chunked(la, g, init)
                got = {name: fn(la, g, init) for name, fn in kernels.items()}
                again = {name: fn(la, g, init)
                         for name, fn in kernels.items()}
                torch.cuda.synchronize()
                what = f"{case} {dtype} h0={init is not None}"
                err = {name: _rglru_err(out, want, dtype, f"{name} {what}")
                       for name, out in got.items()}
                for name in kernels:
                    if not all(torch.equal(x, y)
                               for x, y in zip(got[name], again[name])):
                        raise AssertionError(f"{name} {what}: two runs "
                                             f"differ")
                if "rglru_sm90" not in got:
                    log(f"  rglru {what}: max abs err {err['rglru']:.3e} "
                        f"(rows TMA cannot read: no rglru_sm90)")
                    continue
                if not all(torch.equal(x, y) for x, y in
                           zip(got["rglru_sm90"], got["rglru"])):
                    raise AssertionError(f"rglru_sm90 {what} differs from "
                                         f"rglru")
                log(f"  rglru {what}: max abs err {err['rglru']:.3e}, "
                    f"rglru_sm90 bit-equal to it")
                if dtype == "bfloat16" and init is not None:
                    if case == path_cases["prefill"]:
                        errs["rglru_sm90"] = err["rglru_sm90"]
                    if case == path_cases["decode"]:
                        errs["rglru"] = err["rglru"]
    la, g, h0 = _rglru_inputs(5, path_cases["prefill"], "bfloat16", device)
    t = la.shape[1]
    h, hT = rglru(la, g, h0)
    for pieces in ([(0, t // 2), (t // 2, t)],
                   [(0, t - 8)] + [(i, i + 1) for i in range(t - 8, t)]):
        parts, st = [], h0
        for lo, hi in pieces:
            out, st = rglru(la[:, lo:hi], g[:, lo:hi], st)
            parts.append(out)
        torch.cuda.synchronize()
        if not (torch.equal(torch.cat(parts, 1), h) and torch.equal(st, hT)):
            raise AssertionError(f"rglru in pieces {pieces[:2]}... differs "
                                 f"from one shot")
    log(f"  rglru [0, T/2) then [T/2, T), and [0, T - 8) then 8 one-token "
        f"steps, at {path_cases['prefill']} bf16: equal to one shot")
    return errs


def rglru_numbers(case, device, name) -> dict:
    """K7's kernel ``name`` at one of the path's shapes (bf16 g, f32 log_a
    and h0): its device time and its plain version's (``device_ms``), the
    CUDA-event time, and its bound: log_a (4 B), g and h (2 B each) per
    element, h0 and h_final (4 B) per channel, or an exp and an FMA per
    element (3 f32 operations) at the f32 rate."""
    from repro_torch.kernels.rglru import rglru_chunked
    from repro_torch.kernels.rglru.kernel import rglru_cuda, rglru_sm90_cuda

    run = {"rglru": rglru_cuda, "rglru_sm90": rglru_sm90_cuda}[name]
    b, t, d = case
    la, g, h0 = _rglru_inputs(3, case, "bfloat16", device)
    ms = device_ms(lambda: run(la, g, h0))
    event_ms = cuda_ms(lambda: run(la, g, h0))
    # one call of the plain version at the ring's 2560 tokens queues ~600
    # kernels: more calls than one would fill the launch queue behind the
    # spin kernel
    plain_ms = device_ms(lambda: rglru_chunked(la, g, h0),
                         iters=3 if t <= PROMPT else 1)
    nbytes = b * t * d * (4 + 2 + 2) + 2 * b * d * 4
    flops = 3 * b * t * d
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _rglru_bwd_inputs(case, dtype, device):
    """log_a, the plain forward's h, h0 and the cotangents (dh, dh_last)
    for one (b, t, d) case, made with numpy from fixed seeds."""
    import numpy as np
    import torch

    from repro_torch.kernels.rglru import rglru_chunked

    la, g, h0 = _rglru_inputs(3, case, dtype, device)
    h = rglru_chunked(la, g, h0)[0].contiguous()
    rng = np.random.default_rng(103)
    dh = torch.from_numpy(rng.standard_normal(case).astype(np.float32)).to(
        device, getattr(torch, dtype))
    dh_last = torch.from_numpy(rng.standard_normal(
        (case[0], case[2])).astype(np.float32)).to(device)
    return la, h, h0, dh, dh_last


def check_rglru_bwd(path_case, device) -> dict:
    """K7's two backward kernels against the plain backward on the card:
    the sweep and the training path's shape, with h0 and without, with a
    nonzero dh_last and without, f32 and bf16 h and dh, from the plain
    forward's h; atol 2e-4 (the reference's kernel tests) + rtol 1e-5 (lam
    grows with the memory 1 / (1 - a)), a bf16 dg + rtol 2^-7; each
    kernel's two runs bit-equal, and the TMA kernel (``rglru_bwd_sm90``)
    bit-equal to the register one (``rglru_bwd``) wherever TMA can read
    the rows.  Returns each kernel's max abs error at the path's shape in
    bf16."""
    import torch

    from repro_torch.kernels.rglru.kernel import (rglru_bwd_cuda,
                                                  rglru_bwd_sm90_cuda,
                                                  row_multiple)
    from repro_torch.kernels.rglru.ref import rglru_bwd_ref

    path_err = {}
    for case in RGLRU_SWEEP + [path_case]:
        for dtype in ("float32", "bfloat16"):
            la, h, h0, dh, dh_last = _rglru_bwd_inputs(case, dtype, device)
            kernels = {"rglru_bwd": rglru_bwd_cuda,
                       "rglru_bwd_sm90": rglru_bwd_sm90_cuda}
            if case[2] % row_multiple(h.dtype):     # rows TMA cannot read
                del kernels["rglru_bwd_sm90"]
            for h0_, dl in ((h0, dh_last), (None, dh_last), (h0, None)):
                args = (la, h, h0_, dh, dl)
                got = {name: fn(*args) for name, fn in kernels.items()}
                again = {name: fn(*args) for name, fn in kernels.items()}
                want = rglru_bwd_ref(*args)
                torch.cuda.synchronize()
                what = (f"{case} {dtype} h0={h0_ is not None} "
                        f"dh_last={dl is not None}")
                err = dict.fromkeys(kernels, 0.0)
                for name in kernels:
                    for part, x, w in zip(("dlog_a", "dg", "dh0"),
                                          got[name], want):
                        if w is None:
                            if x is not None:
                                raise AssertionError(f"{name} {what}: "
                                                     f"{part} not None")
                            continue
                        diff = (x.float() - w.float()).abs()
                        rtol = 1e-5 + (RGLRU_TOL[dtype][1] if part == "dg"
                                       else 0.0)
                        if not bool(torch.all(diff <= 2e-4 + rtol
                                              * w.float().abs())):
                            raise AssertionError(
                                f"{name} {what} {part}: max abs err "
                                f"{diff.max().item()}")
                        err[name] = max(err[name], diff.max().item())
                    if not all(x is None or torch.equal(x, y)
                               for x, y in zip(got[name], again[name])):
                        raise AssertionError(f"{name} {what}: two runs "
                                             f"differ")
                if "rglru_bwd_sm90" in got:
                    if not all(x is None or torch.equal(x, y) for x, y in
                               zip(got["rglru_bwd_sm90"], got["rglru_bwd"])):
                        raise AssertionError(f"rglru_bwd_sm90 {what} differs "
                                             f"from rglru_bwd")
                    note = "rglru_bwd_sm90 bit-equal to it"
                else:
                    note = "rows TMA cannot read: no rglru_bwd_sm90"
                log(f"  rglru_bwd {what}: max abs err "
                    f"{err['rglru_bwd']:.3e}, {note}")
                if case == path_case and dtype == "bfloat16":
                    for name in kernels:
                        path_err[name] = max(path_err.get(name, 0.0),
                                             err[name])
    return path_err


def rglru_bwd_numbers(case, device) -> dict:
    """K7's backward at recurrentgemma-9b's training shape (bf16 h and dh,
    f32 log_a, h0 and dh_last): the TMA kernel's ``device_ms`` and
    ``event_ms``, the plain backward's ``graph_ms``, and the bound: log_a
    and dlog_a (4 B), h, dh and dg (2 B) per element, h0, dh_last and dh0
    (4 B) per channel, or an exp and three multiplies per element at the
    f32 rate.  ``register_design``: the register kernel (the earlier
    design, ``rglru_bwd.cu``) at the same inputs in the same run, timed in
    turns with the TMA one."""
    from repro_torch.kernels.rglru.kernel import (rglru_bwd_cuda,
                                                  rglru_bwd_sm90_cuda)
    from repro_torch.kernels.rglru.ref import rglru_bwd_ref

    b, t, d = case
    args = _rglru_bwd_inputs(case, "bfloat16", device)
    nbytes = b * t * d * (4 + 2 + 2 + 2 + 4) + 3 * b * d * 4
    flops = 4 * b * t * d
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    bound = {"bound_ms": max(t_ops, t_bytes) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "flops": flops}
    runs = {"sm90": rglru_bwd_sm90_cuda, "register": rglru_bwd_cuda}
    ms = {name: [] for name in runs}
    for name in ("sm90", "register", "register", "sm90"):
        ms[name].append(device_ms(lambda: runs[name](*args)))
    out = {name: {"ms": sum(v) / len(v), "ms_runs": v,
                  "event_ms": cuda_ms(lambda: runs[name](*args)), **bound}
           for name, v in ms.items()}
    plain_ms = graph_ms(lambda: rglru_bwd_ref(*args))
    return {**out["sm90"], "plain_ms": plain_ms, "library_ms": None,
            "register_design": {**out["register"], "plain_ms": plain_ms,
                                "library_ms": None}}


def launch_floor_ms(device) -> float:
    """The ``device_ms`` of a launch-sized PyTorch op, an in-place add on
    a one-element tensor: the least a launch takes on the card, a
    yardstick the port never calls."""
    import torch

    x = torch.zeros(1, device=device)
    return device_ms(lambda: x.add_(1.0))


def rglru_route_ms(case, device, ts=(1, 64, 256, 384, 512)) -> dict:
    """Both K7 kernels' ``device_ms`` at (B, T, D) = ``case`` with T from
    ``ts`` and at ``SM90_MIN_T`` - RGLRU_ROUTE_BELOW and ``SM90_MIN_T``,
    bf16 g: the measurement behind ``ops.SM90_MIN_T``.  Fails unless the
    register kernel is the faster below ``SM90_MIN_T`` tokens and the TMA
    one from it, so a crossover that moves off the threshold's side
    shows.  Between the two points that bracket the threshold, from T =
    257 to about 300, the two are within a few per cent, and which one
    leads changes from call to call: no point of that band is checked."""
    from repro_torch.kernels.rglru.kernel import rglru_cuda, rglru_sm90_cuda
    from repro_torch.kernels.rglru.ops import SM90_MIN_T

    b, _, d = case
    out = {"sm90_min_t": SM90_MIN_T}
    below = SM90_MIN_T - RGLRU_ROUTE_BELOW
    for t in sorted({*ts, below, SM90_MIN_T}):
        la, g, h0 = _rglru_inputs(3, (b, t, d), "bfloat16", device)
        sm90 = device_ms(lambda: rglru_sm90_cuda(la, g, h0))
        reg = device_ms(lambda: rglru_cuda(la, g, h0))
        out[str(t)] = {"rglru_sm90": sm90, "rglru": reg}
        log(f"  rglru route at T = {t}: TMA {sm90:.6f} ms, registers "
            f"{reg:.6f} ms (ops.SM90_MIN_T = {SM90_MIN_T})")
        routed, other = (sm90, reg) if t >= SM90_MIN_T else (reg, sm90)
        if routed >= other:
            raise AssertionError(
                f"rglru at T = {t}: TMA {sm90} ms, registers {reg} ms; "
                f"ops.SM90_MIN_T = {SM90_MIN_T} routes it to the slower")
    return out


def rglru_bwd_route_ms(d, device, batches=(1, 4),
                       ts=RGLRU_BWD_ROUTE_TS) -> dict:
    """Both K7 backward kernels' ``device_ms`` at (B, T, D) for B in
    ``batches`` and T from ``ts`` and at ``SM90_BWD_MIN_T`` -
    RGLRU_BWD_ROUTE_BELOW and ``SM90_BWD_MIN_T``, bf16 h and dh: the
    measurement behind ``ops.SM90_BWD_MIN_T``.  Fails, once every point is
    measured and printed, unless the register kernel is the faster below
    ``SM90_BWD_MIN_T`` tokens and the TMA one from it at every point."""
    from repro_torch.kernels.rglru.kernel import (rglru_bwd_cuda,
                                                  rglru_bwd_sm90_cuda)
    from repro_torch.kernels.rglru.ops import SM90_BWD_MIN_T

    out = {"sm90_bwd_min_t": SM90_BWD_MIN_T}
    wrong = []
    below = SM90_BWD_MIN_T - RGLRU_BWD_ROUTE_BELOW
    for b in batches:
        for t in sorted({*ts, below, SM90_BWD_MIN_T}):
            args = _rglru_bwd_inputs((b, t, d), "bfloat16", device)
            sm90 = device_ms(lambda: rglru_bwd_sm90_cuda(*args))
            reg = device_ms(lambda: rglru_bwd_cuda(*args))
            out[f"{b}x{t}"] = {"rglru_bwd_sm90": sm90, "rglru_bwd": reg}
            log(f"  rglru_bwd route at (B, T) = ({b}, {t}): TMA {sm90:.6f} "
                f"ms, registers {reg:.6f} ms (ops.SM90_BWD_MIN_T = "
                f"{SM90_BWD_MIN_T})")
            routed, other = (sm90, reg) if t >= SM90_BWD_MIN_T else (reg, sm90)
            if routed >= other:
                wrong.append((b, t, sm90, reg))
    if wrong:
        raise AssertionError(
            f"rglru_bwd (B, T, TMA ms, registers ms) {wrong}: ops."
            f"SM90_BWD_MIN_T = {SM90_BWD_MIN_T} routes them to the slower")
    return out


def gate_product_ms(gcfg, device, tokens) -> float:
    """The RG-LRU's two f32 gate products (``yf @ w_ai``, full f32: TF32
    is off) for ``tokens`` tokens, one layer's worth: device ms."""
    import torch

    n = gcfg.resolved_rnn_width
    gen = torch.Generator(device=device).manual_seed(2)
    yf = torch.randn((tokens, n), generator=gen, device=device)
    w = torch.randn((2, n, n), generator=gen, device=device)
    return device_ms(lambda: (yf @ w[0], yf @ w[1]), iters=10)


def serve_recurrentgemma_phase(gcfg, device, card, reduced=None):
    """recurrentgemma-9b (cut to SERVE_LAYERS layers) through
    ``serve_model_phase``: K7's and K4's launches asserted (the TMA
    kernel once an RG-LRU layer and K4 once an attention layer a
    prefill, the register kernel once an RG-LRU layer a decode step), the
    committed state's size, the ring sub-phase (one prompt longer than the
    window), the 5-layer f32 cut (one super-layer and both tail layers)
    against the plain CPU path, and again with a cut window that the
    prompt and the decode steps overrun; K7's and K4's numbers at the
    path's shapes.  Returns the runs and the numbers."""
    from repro_torch.models import stack_plan

    plan = stack_plan(gcfg)
    kinds = plan["scan_kinds"] * plan["scan_len"] + plan["tail_kinds"]
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
    log(f"  {n_rec} RG-LRU and {n_attn} attention layers")

    # prefill through the TMA kernel, each one-token decode step through
    # the register one
    def want(gen):
        return {"generate": {"rglru_sm90": n_rec, "rglru": n_rec * (gen - 1),
                             "flash_fwd": n_attn},
                "prefill": {"rglru_sm90": n_rec, "rglru": 0,
                            "flash_fwd": n_attn},
                "decode": {"rglru": n_rec * (gen - 1), "rglru_sm90": 0,
                           "flash_fwd": 0}}

    def numbers():
        w = gcfg.resolved_rnn_width
        gate_ms = gate_product_ms(gcfg, device, BATCH * PROMPT)
        shapes = {"prefill": (BATCH, PROMPT, w), "ring": (1, RING_PROMPT, w),
                  "decode": (BATCH, 1, w)}
        # the TMA kernel where the path runs it; the register kernel at
        # every shape (at prefill and ring, the earlier design's yardstick)
        rg = {f"{kernel}_{name}_shape": rglru_numbers(case, device, kernel)
              for name, case in shapes.items()
              for kernel in ("rglru_sm90", "rglru")
              if not (kernel == "rglru_sm90" and name == "decode")}
        rg["rglru_decode_shape"]["launch_floor_ms"] = launch_floor_ms(device)
        return {"f32_gate_products_ms_per_layer": gate_ms,
                "f32_gate_products_ms_per_prefill": gate_ms * n_rec, **rg,
                "rglru_route_ms": rglru_route_ms(shapes["decode"], device),
                "flash_fwd_d256_prefill_shape": attention_numbers(
                    (BATCH, gcfg.num_heads, gcfg.num_kv_heads, PROMPT, PROMPT,
                     gcfg.resolved_head_dim, True, gcfg.window), device)}

    window, prompt, steps = RING_CUT
    runs, nums = serve_model_phase(
        gcfg, device, card, "serve_recurrentgemma", 3_223_465_984, want,
        state_bytes=2_883_588,
        subruns=[("ring", 1, RING_PROMPT, RING_GEN, 2_260_996)],
        plain={"plain_cut": dict(layers=5, atol=1e-4),
               "plain_ring_cut": dict(layers=5, atol=1e-4, window=window,
                                      prompt=prompt, steps=steps)},
        numbers=numbers, reduced=reduced)
    ring_k = runs["ring"]["state_leaves"]["stack/b2/self/k"]
    if ring_k != [plan["scan_len"], 1, gcfg.num_kv_heads, gcfg.window,
                  gcfg.resolved_head_dim]:
        raise AssertionError(f"ring slots {ring_k}")
    log(f"  ring: {RING_PROMPT}-token prompt in {gcfg.window} slots "
        f"{ring_k}")
    return runs, nums


# --------------------------------------------------------------------------
# phase 5/6: the training path
# --------------------------------------------------------------------------
def reset_counts() -> None:
    from repro_torch.kernels.ckpt_codec import kernel as codec_kernel
    from repro_torch.kernels.ckpt_codec import rs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rwkv6 import kernel as rwkv_kernel

    fa_kernel.launches = 0
    fa_kernel.bwd_launches = 0
    fa_kernel.bwd_sm90_launches = 0
    for name in codec_kernel.launches:
        codec_kernel.launches[name] = 0
    rwkv_kernel.launches = 0
    rwkv_kernel.sm90_launches = 0
    rwkv_kernel.bwd_launches = 0
    rwkv_kernel.bwd_sm90_launches = 0
    rs_kernel.launches = 0
    rglru_kernel.launches = 0
    rglru_kernel.sm90_launches = 0
    rglru_kernel.bwd_launches = 0
    rglru_kernel.bwd_sm90_launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.ckpt_codec import kernel as codec_kernel
    from repro_torch.kernels.ckpt_codec import rs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rwkv6 import kernel as rwkv_kernel

    # the flash-attention backward by library: the f32 FMA one and the
    # bf16 wgmma one
    return {"flash_fwd": fa_kernel.launches,
            "flash_bwd": fa_kernel.bwd_launches - fa_kernel.bwd_sm90_launches,
            "flash_bwd_sm90": fa_kernel.bwd_sm90_launches,
            **codec_kernel.launches,
            "rwkv6": rwkv_kernel.launches,
            "rwkv6_sm90": rwkv_kernel.sm90_launches,
            "rwkv6_bwd": rwkv_kernel.bwd_launches,
            "rwkv6_bwd_sm90": rwkv_kernel.bwd_sm90_launches,
            "rs_encode": rs_kernel.launches,
            "rglru": rglru_kernel.launches,
            "rglru_sm90": rglru_kernel.sm90_launches,
            "rglru_bwd": rglru_kernel.bwd_launches,
            "rglru_bwd_sm90": rglru_kernel.bwd_sm90_launches}


def _float_leaves(tree):
    from repro_torch.core.snapshot import _flatten, _leaf_name

    return [(_leaf_name(path), t) for path, t in _flatten(tree)
            if t.is_floating_point()]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def committed_codes(trainer) -> dict:
    """Each float leaf's chain head: (device codes, host scales)."""
    out = {}
    for name, _ in _float_leaves(trainer.state):
        st = trainer.client.delta_chain_lookup(name, 1).parts[0]
        out[name] = (st.codes_dev, st.scales)
    return out


def check_commit_bound(trainer, codes, device, rows=1 << 20) -> float:
    """Every float leaf within absmax/127 * 0.51 per block of its committed
    codes; returns the worst error / bound ratio."""
    import torch

    from repro_torch.kernels.ckpt_codec import dequantize
    from repro_torch.kernels.ckpt_codec.ops import _to_blocks

    worst = 0.0
    with torch.no_grad():
        for name, leaf in _float_leaves(trainer.state):
            q, scales = codes[name]
            scales = torch.from_numpy(scales).to(device)
            blocks = _to_blocks(leaf)[0]
            for i in range(0, blocks.shape[0], rows):
                x = blocks[i:i + rows].float()
                y = dequantize(q[i:i + rows], scales[i:i + rows], x.shape)
                bound = x.abs().amax(1) / 127 * 0.51 + 1e-12
                ratio = ((y - x).abs().amax(1) / bound).max().item()
                worst = max(worst, ratio)
                if ratio > 1:
                    raise AssertionError(f"{name}: committed codes off by "
                                         f"{ratio:.3f} of the bound")
    return worst


def check_restored(trainer, codes, device, rows=1 << 20) -> None:
    """Every restored float leaf equals its committed codes dequantized,
    bit for bit."""
    import torch

    from repro_torch.kernels.ckpt_codec import dequantize
    from repro_torch.kernels.ckpt_codec.ops import _to_blocks

    with torch.no_grad():
        for name, leaf in _float_leaves(trainer.state):
            q, scales = codes[name]
            scales = torch.from_numpy(scales).to(device)
            blocks = _to_blocks(leaf)[0]
            for i in range(0, blocks.shape[0], rows):
                y = dequantize(q[i:i + rows], scales[i:i + rows],
                               blocks[i:i + rows].shape, leaf.dtype)
                if not torch.equal(y, blocks[i:i + rows]):
                    raise AssertionError(f"{name}: restored values differ "
                                         f"from the committed codes")


def host_rss() -> dict:
    pages = int(Path("/proc/self/statm").read_text().split()[1])
    return {"rss_bytes": pages * os.sysconf("SC_PAGE_SIZE"),
            "max_rss_bytes":
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}


def train_main_path(cfg, device, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                    commit_every=COMMIT_EVERY, node_memory=48 << 30,
                    profile=False, restart=True, on_trainer=None) -> dict:
    """ElasticTrainer with q8-delta commits, two more steps (the first's
    launches counted, the second profiled when ``profile``), then, when
    ``restart``, a restart from the agents; else a clean exit.
    ``on_trainer(trainer)``, if given, checks the trainer once it is
    built and returns a dict kept under ``trainer``.  Returns counts,
    losses, wall times and commit records."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import ICheckCluster
    from repro_torch.core import events as E
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import ElasticTrainer

    shape = ShapeConfig("train_4k_1", "train", seq, 1)
    res = {"commits": [], "step_ms": []}
    pfs = tempfile.mkdtemp(prefix="chip-smoke-pfs-")
    res["pfs_free_bytes"] = shutil.disk_usage(pfs).free
    log(f"  PFS {pfs}: {res['pfs_free_bytes']} bytes free")
    kw = dict(app_id="train", seed=0, opt_cfg=AdamWConfig(), commit_every=0,
              probe_every=0, total_steps=100, codec="q8-delta",
              device=device)
    try:
        with ICheckCluster(n_icheck_nodes=2, n_spare_nodes=0,
                           node_memory=node_memory, keep_l1=1,
                           pfs_root=pfs, adaptive_interval=False) as cluster:
            records = []
            cluster.bus.subscribe(
                lambda ev: records.append(dict(ev.payload)),
                events=(E.CKPT_DELTA_COMMITTED,))
            t0 = time.monotonic()
            t1 = ElasticTrainer(cfg, shape, cluster, **kw)
            _sync(device)
            res["init_s"] = time.monotonic() - t0
            if on_trainer is not None:
                res["trainer"] = on_trainer(t1)
            reset_counts()
            for i in range(1, steps + 1):
                t0 = time.monotonic()
                t1.run(1)
                _sync(device)
                res["step_ms"].append((time.monotonic() - t0) * 1e3)
                log(f"  step {i}: {res['step_ms'][-1]:.1f} ms, loss "
                    f"{t1.metrics_log[-1]['loss']:.4f}")
                if i % commit_every == 0:
                    t0 = time.monotonic()
                    t1.commit(blocking=True)
                    wall = time.monotonic() - t0
                    rec = dict(records[-1], wall_s=wall, step=i,
                               **host_rss())
                    res["commits"].append(rec)
                    log(f"  commit at step {i}: {json.dumps(rec)}")
            _sync(device)
            res["launches"] = read_counts()
            res["losses"] = [m["loss"] for m in t1.metrics_log]
            codes = committed_codes(t1)
            res["commit_bound_ratio"] = check_commit_bound(t1, codes, device)
            res["committed_step"] = int(t1.state.step)
            if device.type == "cuda":
                res["encode_ms"] = cuda_ms(lambda: _encode_all(t1, codes),
                                           iters=1, warmup=1)
            # the uninterrupted reference: 2 more steps, the first counted
            reset_counts()
            t1.run(1)
            _sync(device)
            res["launches_per_step"] = read_counts()
            if profile:
                res["profile_step"] = profile_window(lambda: t1.run(1))
            else:
                t1.run(1)
            res["reference_losses"] = [m["loss"]
                                       for m in t1.metrics_log[-2:]]
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
                if device.type == "cuda" else 0
            if not restart:
                del codes
                t1.finalize()
                t1.state = None
                del t1
                return res
            # a "crash": the trainer is dropped without finalize, and with
            # it goes its state on the card
            t1_ref = weakref.ref(t1)
            del t1
            gc.collect()
            if t1_ref() is not None:
                raise AssertionError("the dropped trainer is still alive")
            if device.type == "cuda":
                torch.cuda.empty_cache()
            # the drains finish, and L1 keeps only the newest checkpoint
            cluster.controller.wait_for_drains(timeout=600)
            res["pre_restart_rss"] = host_rss()
            log(f"  before the restart: {json.dumps(res['pre_restart_rss'])}")

            t0 = time.monotonic()
            t2 = ElasticTrainer(cfg, shape, cluster, **kw)
            _sync(device)
            res["restart_s"] = time.monotonic() - t0
            res["restart_rss"] = host_rss()
            if not t2.restarted or int(t2.state.step) != \
                    res["committed_step"] or \
                    t2.data.state.step != res["committed_step"]:
                raise AssertionError(
                    f"restart: restarted={t2.restarted} step "
                    f"{int(t2.state.step)} data {t2.data.state.step}, want "
                    f"{res['committed_step']}")
            log(f"  restart in {res['restart_s']:.1f} s: "
                f"{json.dumps(res['restart_rss'])}")
            check_restored(t2, codes, device)
            del codes
            t2.run(2)
            res["restart_losses"] = [m["loss"] for m in t2.metrics_log]
            if not np.all(np.isfinite(res["restart_losses"])):
                raise AssertionError(f"losses after the restart: "
                                     f"{res['restart_losses']}")
            # a clean exit: the app's chain state (codes on the card) goes
            t2.finalize()
            t2.state = None
            del t2
    finally:
        shutil.rmtree(pfs, ignore_errors=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            res["allocated_after"] = torch.cuda.memory_allocated()
    return res


def _encode_all(trainer, codes) -> None:
    """One delta encode of every float leaf (K2), outputs discarded."""
    from repro_torch.kernels.ckpt_codec import quantize_delta

    for name, leaf in _float_leaves(trainer.state):
        quantize_delta(leaf, codes[name][0])


def train_cut_phase(cfg, device, seq=TRAIN_SEQ, node_memory=48 << 30
                    ) -> dict:
    """Gradient compression (K1 + K3 every step) and a 1 -> 2 logical-rank
    resize with overlap_resize; returns counts, losses and the resize."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import ICheckCluster
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import ElasticTrainer

    shape = ShapeConfig("train_4k_1", "train", seq, 1)
    pfs = tempfile.mkdtemp(prefix="chip-smoke-pfs-")
    res = {}
    try:
        with ICheckCluster(n_icheck_nodes=2, n_spare_nodes=0,
                           node_memory=node_memory, keep_l1=1,
                           pfs_root=pfs, adaptive_interval=False) as cluster:
            t = ElasticTrainer(cfg, shape, cluster, app_id="train-cut",
                               seed=1, opt_cfg=AdamWConfig(
                                   compress_grads=True),
                               commit_every=2, probe_every=0,
                               total_steps=100, codec="q8-delta",
                               overlap_resize=True, device=device)
            reset_counts()
            t0 = time.monotonic()
            t.run(2)
            cluster.rm.schedule_resize("train-cut", 2)
            # the resize completes once the background streams are ready,
            # which takes as long as the host needs: step until then
            deadline = time.monotonic() + RESIZE_WAIT_S
            while not t.resizes and time.monotonic() < deadline:
                t.run(1)
            handles = t._adapt_handles or {}
            res["streams_ready"] = [sum(h.ready() for h in handles.values()),
                                    len(handles)]
            _sync(device)
            res["wall_s"] = time.monotonic() - t0
            res["launches"] = read_counts()
            res["resizes"] = t.resizes
            res["ranks"] = t.app.ranks
            res["steps_during_resize"] = t.steps_during_resize
            res["losses"] = [m["loss"] for m in t.metrics_log]
            t.run(1)
            res["losses_after_resize"] = [m["loss"]
                                          for m in t.metrics_log[-1:]]
            t.finalize()
            del t
    finally:
        shutil.rmtree(pfs, ignore_errors=True)
    if res["resizes"] != 1 or res["ranks"] != 2:
        raise AssertionError(
            f"resize: {res['resizes']} resizes, {res['ranks']} ranks after "
            f"{res['steps_during_resize']} steps and {RESIZE_WAIT_S} s; "
            f"overlap streams ready: {res['streams_ready']}")
    if not np.all(np.isfinite(res["losses"] + res["losses_after_resize"])):
        raise AssertionError(f"cut phase losses: {res['losses']}")
    if device.type == "cuda" and not (res["launches"]["quantize"]
                                      and res["launches"]["dequantize"]):
        raise AssertionError(f"cut phase did not run K1 and K3: "
                             f"{res['launches']}")
    gc.collect()
    return res


def _perturb_lam(params, seed=1) -> None:
    """Every RG-LRU ``lam`` drawn from [-6, 0] in place, from a numpy
    generator: at init a = exp(-8 softplus(lam) r) is about 3e-8, the
    state forgets at once and lam's gradient is a cancellation of roundoff
    (ROADMAP §3); the CPU tests move it the same way."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key == "lam":
                val.copy_(torch.from_numpy(rng.uniform(
                    -6.0, 0.0, tuple(val.shape)).astype(np.float32)))
    walk(params)


def check_grads_against_plain(cfg, device, layers, window=None,
                              seq=GRAD_SEQ, tol=GRAD_TOL) -> dict:
    """A cut of ``cfg`` to its first ``layers`` layers at published widths
    in f32 (``window``, if given, in place of the config's): the loss and
    every gradient leaf of ``compute_grads`` on the card (the kernels,
    forward and backward) against the plain CPU path's, from the same
    seeded parameters (``lam`` moved by ``_perturb_lam``) and one
    ``seq``-token sequence.  Each leaf within ``tol`` of its largest
    element, the loss within LOSS_RTOL.  The parameters are drawn on the
    card (its generator draws billions of values in milliseconds, the
    CPU's in tens of seconds) and copied to the CPU.  Returns the errors,
    the card run's launches and each device's wall seconds."""
    import numpy as np
    import torch

    from repro_torch.models import init_params
    from repro_torch.train.step import compute_grads

    small = cut_config(cfg, layers, window=window or cfg.window)
    t0 = time.monotonic()
    params = _map(lambda t: t.cpu(), init_params(
        small, torch.Generator(device=device).manual_seed(0),
        device=device))
    _perturb_lam(params)
    inputs = request_batch(cfg, np.random.default_rng(2), 1, seq)
    inputs["tokens"] = inputs["tokens"].astype(np.int64)
    inputs["labels"] = inputs["tokens"]
    out, wall = {}, {"draw_s": time.monotonic() - t0}
    for dev in (torch.device("cpu"), device):
        t0 = time.monotonic()
        p = _map(lambda t: t.to(dev), params)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
        reset_counts()
        loss, _, grads = compute_grads(small, p, batch)
        _sync(dev)
        out[dev.type] = (float(loss), {n: g.cpu() for n, g in
                                       _float_leaves(grads)})
        del p, grads
        wall[f"{dev.type}_s"] = time.monotonic() - t0
    launches = read_counts()
    (want_loss, want), (got_loss, got) = out["cpu"], out[device.type]
    loss_err = abs(got_loss - want_loss) / abs(want_loss)
    worst, worst_leaf = 0.0, None
    for name, w in want.items():
        ratio = (got[name] - w).abs().max().item() / max(
            w.abs().max().item(), 1e-30)
        if ratio > worst:
            worst, worst_leaf = ratio, name
    res = {"layers": layers, "window": small.window, "seq": seq,
           "loss": want_loss, "loss_rel_err": loss_err,
           "worst_leaf": worst_leaf, "worst_leaf_err_of_max": worst,
           "launches": launches, **wall}
    if not (loss_err <= LOSS_RTOL and worst <= tol):
        raise AssertionError(f"{layers}-layer f32 cut: card vs plain CPU "
                             f"grads {json.dumps(res)} (loss rtol "
                             f"{LOSS_RTOL}, each leaf {tol} of its "
                             f"largest)")
    return res


def train_recurrent_phase(line, cfg, device, card, n_params, want, reduced,
                          plain, on_trainer=None, extra=None) -> dict:
    """``cfg`` (a cut of a recurrent model at published widths) through
    ``train_main_path``: TRAIN_REC_STEPS steps of TRAIN_SEQ tokens, bf16
    compute, q8-delta commits every TRAIN_REC_COMMIT steps, no restart
    (phase 5 holds that); the launches of those steps and commits held to
    ``want`` (K1 and K2 in the commits); then ``plain`` (keywords of
    ``check_grads_against_plain``).  Prints the ``line`` JSON line and
    its profile; returns its launches and the f32 cut's on the card.
    ``on_trainer`` goes to ``train_main_path``; ``extra()``, called after
    the steps, adds its keys to the line."""
    import torch

    from repro_torch.models import count_params

    got = count_params(cfg)
    if got != n_params:
        raise AssertionError(f"{cfg.name} cut: {got} params, want {n_params}")
    torch.cuda.reset_peak_memory_stats()
    tr = train_main_path(cfg, device, steps=TRAIN_REC_STEPS,
                         commit_every=TRAIN_REC_COMMIT, profile=True,
                         restart=False, on_trainer=on_trainer)
    _check_launches(tr["launches"], want, line)
    if not (tr["launches"]["quantize"] and tr["launches"]["quantize_delta"]):
        raise AssertionError(f"{line}: commits did not run K1 and K2: "
                             f"{tr['launches']}")
    frames = [(c["key_frames"], c["delta_frames"]) for c in tr["commits"]]
    if not frames[0][0] or not any(d for _, d in frames[1:]):
        raise AssertionError(f"{line}: commit frames {frames}")
    losses = tr["losses"] + tr["reference_losses"]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{line}: losses {losses}")
    step_ms = sorted(tr["step_ms"][1:])[len(tr["step_ms"][1:]) // 2]
    log(f"  {line}: {json.dumps(tr['launches'])}")
    grads = check_grads_against_plain(cfg, device, **plain)
    log(f"  {line} f32 cut against the plain CPU path: {json.dumps(grads)}")
    res = {
        "card": card, "arch": cfg.name, "layers": cfg.num_layers,
        "params": n_params, "reduced": reduced, "seq": TRAIN_SEQ,
        "batch": 1, "steps": TRAIN_REC_STEPS,
        "step_ms_median": step_ms, "step_ms": tr["step_ms"],
        "tokens_per_s": TRAIN_SEQ / (step_ms / 1e3),
        "mfu": 6 * n_params * TRAIN_SEQ / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        "init_s": tr["init_s"],
        "commit_wall_s": [c["wall_s"] for c in tr["commits"]],
        "commit_encode_s": [c["encode_s"] for c in tr["commits"]],
        "device_encode_ms": tr["encode_ms"],
        "wire_bytes": [c["encoded_bytes"] for c in tr["commits"]],
        "raw_bytes": [c["raw_bytes"] for c in tr["commits"]],
        "frames_key_delta": frames,
        "commit_bound_ratio": tr["commit_bound_ratio"],
        "losses": losses, "launches": tr["launches"],
        "launches_per_step": tr["launches_per_step"],
        "max_memory_allocated": tr["max_memory_allocated"],
        "plain_grads": grads, "host": host_rss(),
        **({"trainer": tr["trainer"]} if "trainer" in tr else {}),
        **(extra() if extra is not None else {}),
    }
    log(card)
    log(json.dumps({line: res}))
    log(json.dumps({f"profile_{line}_step": tr["profile_step"]}))
    return tr["launches"], grads["launches"]


def train_pixtral_mesh_phase(xcfg, device, card, steps=TRAIN_REC_STEPS):
    """Phase 5f: pixtral-12b cut to PIX_TRAIN_LAYERS layers through
    ``train_recurrent_phase``, its trainer sharded: this process is the
    one rank of an NCCL world (``sharding.init_world`` over a
    ``FileStore``), so the trainer's mesh is a one-card ``DeviceMesh``,
    its state is snapshotted as DTensors, and every step all-reduces each
    gradient leaf, the loss and the token count over the mesh (counted
    here: ``torch.distributed.all_reduce`` wrapped for the phase).
    Returns the launches of the steps and of the f32 cut."""
    import torch.distributed as dist

    from repro_torch.core.snapshot import _flatten, is_dtensor
    from repro_torch.sharding import init_world

    n = PIX_TRAIN_LAYERS
    cut = dataclasses.replace(xcfg, num_layers=n)
    store = tempfile.mkdtemp(prefix="chip-smoke-world-")
    init_world(0, 1, "nccl", store)
    real, calls = dist.all_reduce, []

    def counted(tensor, *a, **k):
        calls.append(tensor.device.type)
        return real(tensor, *a, **k)

    def on_trainer(t) -> dict:
        mesh = t.mesh
        leaves = [x for _, x in _flatten(t._sharded())]
        if mesh is None or mesh.device_type != "cuda" or mesh.size() != 1:
            raise AssertionError(f"the trainer's mesh: {mesh}")
        if not all(is_dtensor(x) and x.to_local().is_cuda for x in leaves):
            raise AssertionError("the trainer's state is not DTensors on "
                                 "the card")
        grads = sum(1 for _ in _flatten(t.state.params))
        info["per_step"] = grads + 2
        return {"mesh": repr(mesh), "backend": dist.get_backend(),
                "world": dist.get_world_size(), "state_leaves": len(leaves),
                "grad_leaves": grads}

    def extra() -> dict:
        # the 4 steps, the counted one and the profiled one
        want = (steps + 2) * info["per_step"]
        if len(calls) != want or set(calls) != {"cuda"}:
            raise AssertionError(f"all-reduces: {len(calls)} on "
                                 f"{set(calls)}, want {want} on the card")
        return {"all_reduces": len(calls),
                "all_reduces_per_step": info["per_step"]}

    info: dict = {}
    dist.all_reduce = counted
    try:
        return train_recurrent_phase(
            "train_pixtral", cut, device, card, 1_654_144_000,
            # each layer's forward twice a step (remat), its backward once,
            # all on the bf16 wgmma libraries
            {"flash_fwd": 2 * n * steps, "flash_bwd_sm90": n * steps,
             "flash_bwd": 0},
            {"num_layers": f"{xcfg.num_layers} -> {n}: the whole model's "
             f"f32 weights, AdamW moments, gradients and codes (about 23 B "
             f"a parameter, 294 GB for 12,798,284,800) do not fit the "
             f"card's 80 GB, and {n} keep the whole run within its 1,200 s",
             "global_batch": f"one sequence of "
             f"{TRAIN_SEQ} tokens after {xcfg.num_patches} patches a step"},
            dict(layers=PIX_PLAIN_LAYERS, tol=PIX_GRAD_TOL),
            on_trainer=on_trainer, extra=extra)
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def serve_moe_phase(cfg, device, card, line, n_params, profile=()):
    """A MoE model at published widths cut to MOE_SERVE_LAYERS layers
    through ``serve_model_phase``: K4's forward once a layer in prefill
    and never in decode (which runs MoE at one slot an expert, reading
    every expert's weights a token, as the reference does); the 1-layer
    f32 cut of ``MOE_PLAIN`` against the plain CPU path with the expert
    ids compared; the ``profile`` windows of ``serve_main_path``.  Returns
    the serving run's launches and K4's numbers at its prefill shape."""
    cut = dataclasses.replace(cfg, num_layers=MOE_SERVE_LAYERS)
    w_gu = cut.num_layers * 2 * cfg.num_experts * cfg.d_model \
        * cfg.resolved_moe_d_ff
    draw, layer = 4 * n_params, 4 * n_params // MOE_SERVE_LAYERS
    reduced = {"num_layers": (
        f"{cfg.num_layers} -> {cut.num_layers}: the weights are drawn in "
        f"f32 ({draw / 1e9:.1f} GB) and cast leaf by leaf, so the cast "
        f"peaks at up to the draw and the bf16 copy of the stacked w_gu "
        f"({2 * w_gu / 1e9:.1f} GB), about {(draw + 2 * w_gu) / 1e9:.0f} "
        f"GB of the card's 80; each more layer adds about "
        f"{layer / 1e9:.1f} GB of f32 draw")}
    runs, nums = serve_model_phase(
        cut, device, card, line, n_params, dense_want(cut),
        plain={"plain_cut": MOE_PLAIN}, profile=profile,
        reduced=reduced,
        numbers=lambda: {"flash_fwd_serve_shape": attention_numbers(
            serve_case(cut), device)})
    return runs["serve"]["launches"], nums["flash_fwd_serve_shape"]


def grad_moe_phase(full, device, card, n_params, layers=1) -> dict:
    """``full`` cut to ``layers`` layers at published widths: the
    training path's loss and gradients (``compute_grads``: bf16
    compute, f32 master weights and gradient buffers, full remat) without
    the optimizer, on one TRAIN_SEQ-token sequence, MOE_GRAD_CALLS calls:
    K4's forward twice a call (the recomputation under remat) and its
    backward once, on the wgmma library; the loss, its aux and every
    gradient finite.  Then an f32 cut's loss and gradients on the card
    against the plain CPU path (``check_grads_against_plain``, ``layers``
    layers).
    Prints the ``grad_qwen3_moe`` line; returns the launches of the timed
    calls and of the f32 cut on the card."""
    import numpy as np
    import torch

    from repro_torch.models import count_params, init_params
    from repro_torch.train.step import compute_grads

    cfg = dataclasses.replace(full, num_layers=layers)
    got = count_params(cfg)
    if got != n_params:
        raise AssertionError(f"{cfg.name} cut: {got} params, want {n_params}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, TRAIN_SEQ)).astype(np.int64)).to(device)
    batch = {"tokens": toks, "labels": toks}
    reset_counts()
    call_ms = []
    for i in range(MOE_GRAD_CALLS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss, metrics, grads = compute_grads(cfg, params, batch)
        torch.cuda.synchronize()
        call_ms.append((time.monotonic() - t0) * 1e3)
        if i < MOE_GRAD_CALLS - 1:
            del grads
    launches = read_counts()
    n = MOE_GRAD_CALLS
    _check_launches(launches, {"flash_fwd": 2 * n, "flash_bwd_sm90": n,
                               "flash_bwd": 0}, "grad_qwen3_moe")
    finite = all(bool(torch.isfinite(g).all()) for _, g in
                 _float_leaves(grads))
    if not (finite and math.isfinite(float(loss))
            and float(metrics["aux"]) > 0):
        raise AssertionError(f"grad_qwen3_moe: loss {float(loss)}, aux "
                             f"{float(metrics['aux'])}, grads finite "
                             f"{finite}")
    peak = torch.cuda.max_memory_allocated()
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    median = sorted(call_ms[1:])[len(call_ms[1:]) // 2]
    plain = check_grads_against_plain(cfg, device, layers=layers)
    log(f"  grad_qwen3_moe f32 cut against the plain CPU path: "
        f"{json.dumps(plain)}")
    res = {
        "card": card, "arch": cfg.name, "layers": cfg.num_layers,
        "params": n_params, "reduced": {
            "num_layers": (
                f"{full.num_layers} -> {layers}, and no optimizer: the "
                f"trainer keeps about 23 B a parameter (f32 weights, AdamW "
                f"moments, gradients, codes; qwen2.5-3b's training phase "
                f"peaked at 78,336,771,584 B for 3,397,627,904 params), "
                f"about {23 * n_params / 1e9:.0f} GB for {layers} layer(s) "
                f"against the card's 80 GB"),
            "global_batch": f"one sequence of {TRAIN_SEQ} tokens a call"},
        "seq": TRAIN_SEQ, "batch": 1, "calls": n,
        "call_ms": call_ms, "call_ms_median": median,
        "tokens_per_s": TRAIN_SEQ / (median / 1e3), "init_s": init_s,
        "loss": float(loss), "xent": float(metrics["xent"]),
        "aux": float(metrics["aux"]), "launches": launches,
        "max_memory_allocated": peak, "plain_grads": plain,
        "host": host_rss(),
    }
    log(card)
    log(json.dumps({"grad_qwen3_moe": res}))
    return launches, plain["launches"]


# --------------------------------------------------------------------------
# phase 8: the report's cells on the card
# --------------------------------------------------------------------------
def report_phase(device, cells=REPORT_CELLS) -> list:
    """Each cell's one-device step at the 16 x 16 mesh run on the card
    and held against the report's ``meta`` trace
    (``report.measure_cell`` and ``check_measure``); a serving cell's
    weights serve the next cell of the same arch.  Returns each cell's
    numbers, with the bytes the card held before the cell
    (``allocated_before``; the prefill cell's include the weights)."""
    import torch

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import report, specs
    from repro_torch.launch.mesh import production_mesh

    mesh = production_mesh()
    out = []
    served = {}            # arch -> its serving weights on the card
    for arch, shape_name in cells:
        cfg, shape = get_config(arch), get_shape(shape_name)
        if shape.kind == "train" or arch not in served:
            served.clear()
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(device)
        t0 = time.monotonic()
        if shape.kind != "train" and not served:
            gen = torch.Generator(device=device).manual_seed(0)
            served[arch] = report.serving_params(cfg, device, gen)
        m = report.measure_cell(
            cfg, shape, report.device_batch(shape, mesh),
            specs.default_microbatches(cfg, shape, mesh), device,
            timed_runs=3 if shape.kind == "decode" else 1,
            params=served.get(arch))
        m.update(allocated_before=before, wall_s=time.monotonic() - t0)
        log(json.dumps({"report_cell": m}))
        report.check_measure(m)
        out.append(m)
    served.clear()
    return out


# --------------------------------------------------------------------------
# phase 8b: the KV cache over its sequence, a rank of the mesh on the card
# --------------------------------------------------------------------------
def kv_seq_config(rehearse: bool = False):
    """Phase 8b's config: KV_SEQ_ARCH (its tiny one computing in bf16 in a
    CPU rehearsal)."""
    return tp_config(KV_SEQ_ARCH, rehearse)


def kv_seq_cell_config(cfg, shape):
    """Phase 8b's config of a cell: ``cfg``, its prefill cut to
    KV_SEQ_PREFILL_LAYERS layers (a shallower config, as a rehearsal's,
    to half its depth)."""
    if shape.kind != "prefill":
        return cfg
    n = cfg.num_layers
    return dataclasses.replace(cfg, num_layers=KV_SEQ_PREFILL_LAYERS if
                               n > KV_SEQ_PREFILL_LAYERS else max(1, n // 2))


def kv_seq_k4_case(cfg) -> tuple:
    """K4's forward case in phase 8b's split prefill: a data rank's rows,
    the rank's query heads over the kv head they read, the whole
    prompt."""
    from repro_torch.configs import get_shape

    shape = get_shape(KV_SEQ_CELLS[1])
    rows = shape.global_batch // KV_SEQ_MESH["data"]
    hq = cfg.num_heads // KV_SEQ_MESH["model"]
    return (rows, hq, max(1, hq * cfg.num_kv_heads // cfg.num_heads),
            shape.seq_len, shape.seq_len, cfg.resolved_head_dim, True,
            cfg.window)


def kv_seq_cells(cfg, rehearse: bool = False) -> dict:
    """Phase 8b's cells, name -> (shape, its rank's rows on KV_SEQ_MESH,
    the rules): the report's ``decode_32k`` and ``prefill_32k``, or in a
    rehearsal their tiny stand-ins (64 slots, a data rank's 2 rows)."""
    from repro_torch.configs import get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import report, specs
    from repro_torch.launch.mesh import production_mesh

    mesh = production_mesh(False, KV_SEQ_MESH)
    out = {}
    for name in KV_SEQ_CELLS:
        shape = get_shape(name)
        if rehearse:
            shape = ShapeConfig(name, shape.kind, 64,
                                2 * KV_SEQ_MESH["data"])
        rules = specs.cell_rules(cfg, shape, mesh)
        out[name] = (shape, report.rank_rows(shape, mesh, rules), rules)
    return out


def _kv_layer_draw(cache_leaf_shape, seed, layer, which, start, n, dtype,
                   device):
    """Layer ``layer``'s whole K (``which`` 0) or V (1) of a cache drawn
    from ``seed`` (normal, one generator a layer and leaf), its slots
    [start, start + n) kept."""
    import torch

    b, h, s, d = cache_leaf_shape
    g = torch.Generator(device=device).manual_seed(
        seed * 100_003 + 2 * layer + which)
    whole = torch.randn((b, h, s, d), generator=g, device=device,
                        dtype=torch.float32)
    return whole[:, :, start:start + n].to(dtype)


def fill_kv_cache_(cache, slots: int, seed: int) -> None:
    """Every slot of a dense model's KV cache (``{"stack": {"b0":
    {"self": ...}}}``, whole or a rank's ``KVSeqShard`` of ``slots``
    slots, under the active rules) drawn from ``seed``, layer by layer,
    the same values at a slot whichever rank holds it."""
    from repro_torch.models.attention import seq_box

    kv = cache["stack"]["b0"]["self"]
    _, start = seq_box(kv)
    for which, leaf in enumerate((kv.k, kv.v)):
        for i in range(leaf.shape[0]):
            b, h, n, d = leaf[i].shape
            leaf[i].copy_(_kv_layer_draw((b, h, slots, d), seed, i, which,
                                         start, n, leaf.dtype, leaf.device))


def _kv_seq_decode_inputs(cfg, shape, rows, params, device, mesh=None,
                          rules=None):
    """(params, cache, tokens) of the decode cell: the cache (the rank's
    slots on ``mesh``, or whole) filled from KV_SEQ_SEED to its last
    slot, the tokens from KV_SEQ_SEED + 1."""
    import torch

    from repro_torch.models import init_cache
    from repro_torch.sharding import use_rules

    cache = init_cache(cfg, rows, shape.seq_len, device=device, mesh=mesh,
                       rules=rules)
    with use_rules(mesh, rules):         # a rank's slots on the mesh
        fill_kv_cache_(cache, shape.seq_len, KV_SEQ_SEED)
    cache["idx"].fill_(shape.seq_len - 1)
    g = torch.Generator(device=device).manual_seed(KV_SEQ_SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (rows, 1), generator=g,
                         dtype=torch.int32, device=device)
    return params, cache, toks


def _kv_seq_cut_run(small, params, device, mesh=None, rules=None):
    """The f32 cut served greedy (KV_SEQ_PLAIN): a prefill of its prompt
    (seed 1) and its steps, the cache of ``max_len`` slots split over
    its sequence on ``mesh`` under ``rules`` (the rank's logits: its
    vocab columns), or whole.  Returns (logits a step on the CPU, the
    greedy tokens)."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.sharding import tp, use_rules

    c = KV_SEQ_PLAIN
    toks = torch.as_tensor(request_batch(small, np.random.default_rng(1),
                                         c["batch"], c["prompt"])["tokens"],
                           device=device)
    cache = init_cache(small, c["batch"], c["max_len"], device=device,
                       mesh=mesh, rules=rules)
    out, greedy = [], []
    with torch.no_grad(), use_rules(mesh, rules):
        logits, cache = prefill(small, params, {"tokens": toks}, cache)
        for i in range(c["steps"] + 1):
            out.append(logits.float().cpu())
            greedy.append(tp.argmax(logits, small.padded_vocab)[:, None]
                          .to(torch.int32))
            if i < c["steps"]:
                logits, cache = decode_step(small, params, cache,
                                            greedy[-1])
    return out, torch.cat(greedy, dim=1).cpu().numpy()


def kv_seq_rank(mesh, device, rehearse: bool = False) -> dict:
    """Phase 8b on one rank of a ("data" 1, "model" m) world standing for
    rank 0 of KV_SEQ_MESH and its "model" peers: the whole model drawn
    (seed 0, f32) one rank at a time, the rank keeping its boxes of it in
    bf16 and of its f32 cut; each cell's step under the counter and timed
    (``report.measure_rank``, which keeps the counted run's logits):
    decode over a cache drawn from the seed, then one more step with each
    all-reduce timed alone; prefill, its K4 launches; then the f32 cut
    served split, its cache over the sequence."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import report
    from repro_torch.models import cast_params, init_params, shard_params
    from repro_torch.sharding import use_rules
    from repro_torch.models import decode_step

    cfg = kv_seq_config(rehearse)
    cells = kv_seq_cells(cfg, rehearse)
    rules = cells[KV_SEQ_CELLS[0]][2]
    small = cut_config(cfg, KV_SEQ_PLAIN["layers"])
    rank = dist.get_rank()
    params = cut = None
    for r in range(dist.get_world_size()):
        if r == rank:
            full = init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device=device)
            # the cut's boxes wait on the host while the cells run
            cut = _map(lambda t: t.cpu(), shard_params(
                cut_params(small, full), small, mesh, rules))
            params = cast_params(shard_params(full, cfg, mesh, rules),
                                 getattr(torch, cfg.dtype))
            del full
            gc.collect()
            _card_reset_peak(device)
        dist.barrier()
    res = {"rank": rank}
    for name, (shape, rows, cell_rules) in cells.items():
        ccfg = kv_seq_cell_config(cfg, shape)
        if ccfg.num_layers < cfg.num_layers:
            # the cut's layers kept alone, so that the rank holds what
            # its trace does
            params = {k: _map(lambda t: t[:ccfg.num_layers].clone(), v)
                      if k == "stack" else v for k, v in params.items()}
        gc.collect()
        _card_reset_peak(device)
        t0 = time.monotonic()
        if shape.kind == "decode":
            inputs = _kv_seq_decode_inputs(ccfg, shape, rows, params,
                                           device, mesh, cell_rules)
        else:
            inputs = report.step_inputs(
                ccfg, shape, rows, device, torch.Generator(
                    device=device).manual_seed(KV_SEQ_SEED + 2),
                params=params, mesh=mesh, rules=cell_rules)
        reset_counts()
        # the prefill (~1 s a layer through gloo) is timed by its counted
        # run
        m = report.measure_rank(
            ccfg, shape, mesh, cell_rules, rows, 1, device,
            timed_runs=KV_SEQ_TIMED if shape.kind == "decode" else 0,
            inputs=inputs)
        m["kernel_launches"] = read_counts()
        if shape.kind == "decode":
            # one more step (the same slot rewritten with the same K/V),
            # the all-reduces' own share of it, each timed alone
            with torch.no_grad(), use_rules(mesh, cell_rules), \
                    CountedAllReduce(timed=True) as ar:
                _sync(device)
                t1 = time.monotonic()
                decode_step(cfg, *inputs)
                _sync(device)
                m["timed_step_ms"] = (time.monotonic() - t1) * 1e3
                m["all_reduces"] = ar.calls
                m["all_reduce_host_ms"] = ar.ms
        m["wall_s"] = time.monotonic() - t0
        m["cache_bytes"] = sum(t.numel() * t.element_size() for _, t in
                               _named(inputs[1 if shape.kind == "decode"
                                             else 2]))
        res[name] = m
        del inputs
    del params
    gc.collect()
    _card_reset_peak(device)
    res["cut_logits"], res["cut_tokens"] = _kv_seq_cut_run(
        small, _map(lambda t: t.to(device), cut), device, mesh, rules)
    return res


def kv_seq_phase(device, card, rehearse: bool = False, ranks=None) -> dict:
    """Phase 8b: rank 0 of KV_SEQ_MESH traced on ``meta`` by the report
    (this process owns no other process group), then run by
    ``kv_seq_rank`` on KV_SEQ_MESH["model"] processes (gloo; ``ranks``:
    their results, when the world has run), and held: its counts against
    the trace (``report.check_measure``: FLOPs, bytes, collectives,
    kernel records, K4's launches, the peak within ``PEAK_BAND``), K4's
    records in prefill at the rank's shape; each cell's split logits
    (decode's, prefill's last token's) against this card's one-process
    bf16 and f32 run of the same inputs (the whole cache), within
    TP_BF16_BOUND times bf16's own distance; the f32 cut's logits and
    tokens against the plain CPU path within KV_SEQ_RTOL."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch import report
    from repro_torch.models import (cast_params, decode_step, init_params,
                                    prefill)

    cfg = kv_seq_config(rehearse)
    cells = kv_seq_cells(cfg, rehearse)
    world = KV_SEQ_MESH["model"]
    arts = {}
    for name, (shape, rows, rules) in cells.items():
        t0 = time.monotonic()
        arts[name] = report.report_cell(kv_seq_cell_config(cfg, shape),
                                        shape, mesh_shape=KV_SEQ_MESH,
                                        rules=rules)
        arts[name]["wall_s"] = time.monotonic() - t0
        if not (arts[name]["split"] and arts[name]["split"]["kv_seq"]):
            raise AssertionError(f"{name}: not traced split over kv_seq: "
                                 f"{arts[name]['split']}")
    t0 = time.monotonic()
    if ranks is None:
        gc.collect()
        _card_reset_peak(device)
        ranks = spawn_tp_world(("kvseq",), world, rehearse,
                               each=lambda r, res: res["kvseq"])
    world_s = time.monotonic() - t0
    r0 = ranks[0]
    line = {"card": card, "arch": cfg.name, "mesh": KV_SEQ_MESH,
            "ranks_on_card": world, "cells": {}}
    for name, (shape, rows, rules) in cells.items():
        ccfg = kv_seq_cell_config(cfg, shape)
        m = report.hold_to_report(ccfg, shape, r0[name], arts[name])
        report.check_measure(m)
        k4 = report.k4_records(m["kernels"])
        if shape.kind == "prefill" and device.type == "cuda":
            # K4 at the rank's heads over the gathered K/V: (B, Hq / m,
            # 1, T, T, D), once a layer
            hq, d = cfg.num_heads // world, cfg.resolved_head_dim
            want = fa.fwd_cost((rows, hq, shape.seq_len, d),
                               (rows, 1, shape.seq_len, d), True, cfg.window,
                               2)
            rec = k4.get("flash_fwd_sm90")
            if rec is None or rec["calls"] != ccfg.num_layers or \
                    rec["flops"] != want[0] * ccfg.num_layers:
                raise AssertionError(f"{name}: K4's records {k4}, want "
                                     f"{ccfg.num_layers} calls of {want}")
        # the counted run and the timed ones: K4 once a layer in prefill
        runs = 1 + (KV_SEQ_TIMED if shape.kind == "decode" else 0)
        if device.type == "cuda" and r0[name]["kernel_launches"][
                "flash_fwd"] != (runs * ccfg.num_layers
                                 if shape.kind == "prefill" else 0):
            raise AssertionError(f"{name}: K4 launched "
                                 f"{r0[name]['kernel_launches']}")
        cell = {k: m[k] for k in ("sequences", "flops", "bytes",
                                  "collectives", "meta_collectives",
                                  "kernels", "k4_launches",
                                  "report_peak_bytes",
                                  "max_memory_allocated", "peak_ratio",
                                  "ms", "bound_s")}
        cell.update(shape=list(map(str, (shape.kind, shape.seq_len))),
                    layers=ccfg.num_layers, wall_s=r0[name]["wall_s"],
                    trace_s=arts[name]["trace_s"],
                    cache_bytes_per_rank=[r[name]["cache_bytes"]
                                          for r in ranks],
                    peak_per_rank=[r[name]["peak"] for r in ranks])
        if shape.kind == "decode":
            cell.update(timed_step_ms=r0[name]["timed_step_ms"],
                        all_reduces=r0[name]["all_reduces"],
                        all_reduce_host_ms=r0[name]["all_reduce_host_ms"],
                        all_reduce_share=r0[name]["all_reduce_host_ms"]
                        / r0[name]["timed_step_ms"])
        line["cells"][name] = cell

    # each cell's split logits against one process's whole-cache run,
    # bf16 and f32, of the same inputs
    t0 = time.monotonic()
    full = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    small = cut_config(cfg, KV_SEQ_PLAIN["layers"])
    cpu_cut = _map(lambda t: t.detach().cpu().clone(),
                   cut_params(small, full))
    one = {name: {} for name in cells}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = full if dtype == "float32" else cast_params(
            full, torch.bfloat16)
        if dtype == "bfloat16":
            del full
        for name, (shape, rows, _) in cells.items():
            cc = kv_seq_cell_config(c, shape)
            if shape.kind == "decode":
                inputs, step = _kv_seq_decode_inputs(
                    cc, shape, rows, p, device), decode_step
            else:
                inputs, step = report.step_inputs(
                    cc, shape, rows, device, torch.Generator(
                        device=device).manual_seed(KV_SEQ_SEED + 2),
                    params=cut_params(cc, p)), prefill
            with torch.no_grad():
                one[name][dtype] = step(cc, *inputs)[0].float().cpu()
            del inputs
            gc.collect()
            _card_reset_peak(device)
        del p
    vocab = cfg.vocab_size
    for name in cells:
        split = torch.cat([r[name]["logits"] for r in ranks],
                          dim=-1)[:, :vocab]
        bf16, f32 = (one[name][d][:, :vocab]
                     for d in ("bfloat16", "float32"))
        kv_rel, bf16_rel = _rel(split, bf16), _rel(bf16, f32)
        if not kv_rel <= TP_BF16_BOUND * bf16_rel:
            raise AssertionError(
                f"{name}: split logits {kv_rel} of their max from one "
                f"process's, beyond {TP_BF16_BOUND} x bf16's own "
                f"{bf16_rel}")
        line["cells"][name].update(
            logits_rel_err_vs_one_process_bf16=kv_rel,
            bf16_rel_err_vs_f32=bf16_rel,
            logits_rel_err_vs_one_process_f32=_rel(split, f32),
            logits_bound=TP_BF16_BOUND * bf16_rel,
            greedy_equal_to_one_process=int(
                (split.argmax(-1) == bf16.argmax(-1)).sum()))
    # the f32 cut against the plain CPU path
    want, want_toks = _kv_seq_cut_run(small, cpu_cut, torch.device("cpu"))
    got = _vocab_whole([r["cut_logits"] for r in ranks])
    cut_err = 0.0
    for g, w in zip(got, want):
        err = ((g - w).abs() - KV_SEQ_RTOL * w.abs()).max().item() / max(
            w.abs().max().item(), 1e-30)
        cut_err = max(cut_err, err)
    if not (np.array_equal(r0["cut_tokens"], want_toks)
            and cut_err <= KV_SEQ_RTOL):
        raise AssertionError(
            f"split f32 cut: tokens {r0['cut_tokens']} against the CPU's "
            f"{want_toks}; logits beyond rtol {KV_SEQ_RTOL} by {cut_err} of "
            f"their max (at most {KV_SEQ_RTOL})")
    line.update(
        plain_cut_excess_of_max=cut_err, plain_cut_tokens_equal=True,
        world_wall_s=world_s, check_s=time.monotonic() - t0,
        reduced={"prefill_32k": f"{cfg.num_layers} -> "
                 f"{line['cells']['prefill_32k']['layers']} layers: cut to "
                 f"keep the whole run within its 1,200 s",
                 "ranks": f"rank 0 of the ('data' {KV_SEQ_MESH['data']}, "
                 f"'model' {world}) mesh and its {world - 1} 'model' peers "
                 f"as processes on one card over gloo (NCCL takes one card "
                 f"a rank): every all-reduce is staged through the host; "
                 f"no 'data' peer runs, as the serving step issues no "
                 f"collective over 'data'",
                 "weights": "random, from seed 0"})
    return line


# --------------------------------------------------------------------------
# phase 7: kernel numbers at the training path's shapes
# --------------------------------------------------------------------------
def bwd_numbers(path_case, device) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref)
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import allowed_mask

    b, hq, hkv, t, s, d, causal, window = path_case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, "bfloat16", device)
    dout = _inputs(8, b, hq, hkv, t, s, d, "bfloat16", device)[0]
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)

    def kernel():
        return flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)

    plain_ms = device_ms(lambda: attention_bwd_ref(q, k, v, out, lse, dout,
                                                   **kw), iters=2)
    # yardstick only, never called by the port: SDPA's backward (at T = S
    # its top-left causal alignment equals the reference's bottom-right)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             enable_gqa=True)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), dout, retain_graph=True), iters=5)
    pairs = int(allowed_mask(t, s, causal, window, s - t).sum())
    flops = 10 * b * hq * d * pairs     # five products, 2 FLOP per MAC
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
              + 2 * out.numel()) * 2 + dout.numel() * 2 + 2 * lse.numel() * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"ms": device_ms(kernel, iters=5),
            "event_ms": cuda_ms(kernel, iters=5), "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


def bwd_d256_numbers(path_case, device) -> dict:
    """K4's backward at recurrentgemma-9b's training shape, head dim 256,
    bf16: ``device_ms`` and ``event_ms``, the plain backward's
    ``device_ms``, and SDPA's backward with the same causal window as a
    boolean mask over K and V expanded to the query heads (a yardstick the
    port never calls); bound as ``bwd_numbers``.  ``f32_fma_design``: the FMA kernel (``flash_bwd.cu``, the earlier
    design, which ran bf16 at head dim 256 until PR 19 on f32 widened from
    the inputs) on f32 copies of the same inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref)
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import allowed_mask

    b, hq, hkv, t, s, d, causal, window = path_case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, "bfloat16", device)
    dout = _inputs(8, b, hq, hkv, t, s, d, "bfloat16", device)[0]
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    def kernel():
        return flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)

    ms, event_ms = device_ms(kernel, iters=3), cuda_ms(kernel, iters=3)
    f32 = [x.float() for x in (q, k, v, out, dout)]
    fma_ms = device_ms(lambda: flash_attention_bwd_cuda(
        *f32[:4], lse, f32[4], **kw), iters=2)
    del f32
    plain_ms = device_ms(lambda: attention_bwd_ref(q, k, v, out, lse, dout,
                                                   **kw), iters=2)
    mask = allowed_mask(t, s, causal, window, s - t, device)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    g = hq // hkv
    lib_out = F.scaled_dot_product_attention(
        qg, kg.repeat_interleave(g, 1), vg.repeat_interleave(g, 1),
        attn_mask=mask)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), dout, retain_graph=True), iters=3)
    pairs = int(mask.sum())
    flops = 10 * b * hq * d * pairs     # five products, 2 FLOP per MAC
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
              + 2 * out.numel()) * 2 + dout.numel() * 2 + 2 * lse.numel() * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes,
            "f32_fma_design": {"ms": fma_ms,
                               "bound_ms": max(t_ops, t_bytes) * 1e3,
                               "bound_by": "bytes" if t_bytes >= t_ops
                               else "operations"}}


def codec_numbers(n, device) -> dict:
    """K1-K3 at the path's largest leaf (f32), beside their plain versions
    and their byte bounds.  One PyTorch call computes K3's function,
    ``torch.mul(codes, scales)`` (int8 x f32 promotes to f32, as
    ``dequantize_ref``): its time is K3's ``library_ms``.  None computes K1
    or K2 (absmax, divide, round and clamp, with an XOR for K2)."""
    import torch

    from repro_torch.kernels.ckpt_codec import kernel as K
    from repro_torch.kernels.ckpt_codec import ref as R
    from repro_torch.kernels.ckpt_codec.ops import _to_blocks

    x = _to_blocks(_codec_input(n, "float32", device, 0))[0]
    q, s = K.quantize_cuda(x)
    nb = x.shape[0]
    out = {}
    for name, fn, plain, lib, nbytes in (
            ("quantize", lambda: K.quantize_cuda(x),
             lambda: R.quantize_ref(x), None, 4 * n + n + 4 * nb),
            ("quantize_delta", lambda: K.quantize_delta_cuda(x, q),
             lambda: R.quantize_delta_ref(x, q), None,
             4 * n + 3 * n + 4 * nb),
            ("dequantize", lambda: K.dequantize_cuda(q, s),
             lambda: R.dequantize_ref(q, s), lambda: torch.mul(q, s),
             n + 4 * nb + 4 * n)):
        out[name] = {"ms": device_ms(fn, iters=5),
                     "event_ms": cuda_ms(fn, iters=5),
                     "plain_ms": device_ms(plain, iters=2),
                     "library_ms": lib and device_ms(lib, iters=5),
                     "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
                     "bound_by": "bytes", "bytes": nbytes}
    return out


# --------------------------------------------------------------------------
# phase 9: the mesh's "model" axis, two ranks on the one card
# --------------------------------------------------------------------------
class CountedAllReduce:
    """Within the block, every ``torch.distributed.all_reduce`` is
    counted; with ``timed`` the card is synchronized before and after
    each, and the host wall time between is summed (``ms``): the
    collective's own cost, with no queued work of the card in it.
    ``groups`` (name -> process group): the all-reduces and broadcasts,
    bytes, largest tensor's bytes and ms of each group apart (``by``;
    "other" for a group not named); ``calls`` counts all-reduces only."""

    def __init__(self, timed: bool = False, groups=None):
        self.timed, self.calls, self.ms = timed, 0, 0.0
        self.groups, self.by = dict(groups or {}), {}

    def __enter__(self):
        import torch.distributed as dist

        self.real = dist.all_reduce, dist.broadcast

        def counting(real, kind):
            def counted(tensor, *a, **k):
                if self.timed:
                    _sync(tensor.device)
                    t0 = time.perf_counter()
                out = real(tensor, *a, **k)
                ms = 0.0
                if self.timed:
                    _sync(tensor.device)
                    ms = (time.perf_counter() - t0) * 1e3
                    self.ms += ms
                if kind == "calls":
                    self.calls += 1
                if self.groups:
                    group = k.get("group", a[1] if len(a) > 1 else None)
                    name = next((n for n, g in self.groups.items()
                                 if g is group), "other")
                    rec = self.by.setdefault(name, {
                        "calls": 0, "broadcasts": 0, "bytes": 0,
                        "largest_bytes": 0, "ms": 0.0})
                    nbytes = tensor.numel() * tensor.element_size()
                    rec[kind] += 1
                    rec["bytes"] += nbytes
                    rec["largest_bytes"] = max(rec["largest_bytes"], nbytes)
                    rec["ms"] += ms
                return out
            return counted
        dist.all_reduce = counting(self.real[0], "calls")
        dist.broadcast = counting(self.real[1], "broadcasts")
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce, dist.broadcast = self.real
        return False


def _card_mem(device, what="max_memory_allocated"):
    """A ``torch.cuda`` memory figure of the card (None on the CPU)."""
    import torch

    return getattr(torch.cuda, what)() if device.type == "cuda" else None


def _card_reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.empty_cache()


def tp_case(cfg, b, t, model=TP_MODEL):
    """K4's case at a rank's local heads of a ``model``-way split."""
    return (b, cfg.num_heads // model, cfg.num_kv_heads // model, t, t,
            cfg.resolved_head_dim, True, cfg.window)


def _greedy_run(engine, batch, steps, feed=None):
    """A prefill of ``batch`` and ``steps`` decode steps through the
    engine's ``step``: each step fed ``feed``'s next column (the whole
    batch's tokens) or, without it, the greedy token.  Returns the
    rank's logits after the prefill and each step (f32 on the CPU) and
    the greedy tokens (B, steps + 1)."""
    import torch

    logits, cache = engine.prefill(batch)
    out, toks = [logits.float().cpu()], [engine.greedy(logits)]
    for i in range(steps):
        tok = toks[-1] if feed is None else torch.as_tensor(
            feed[:, i:i + 1], device=engine.device)
        logits, cache = engine.step(cache, tok)
        out.append(logits.float().cpu())
        toks.append(engine.greedy(logits))
    return out, torch.cat(toks, dim=1).cpu().numpy()


def tp_serve_rank(cfg, mesh, device, batch_size=BATCH, prompt=PROMPT,
                  gen=GEN) -> dict:
    """Phase 9a on one rank: yi-6b drawn whole (the seed of phase 4),
    its f32 cut served split first, then the whole model served split
    in bf16 through ``ServeEngine(mesh=)``, the cache committed on rank
    0 and restored on the mesh; a recording pass of the logits."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import ICheckClient, ICheckCluster
    from repro_torch.core.snapshot import _flatten
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, serve_max_len

    rank = dist.get_rank()
    full = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    _sync(device)
    res = {}
    # the f32 cut, split: its tokens and logits go to the parent, which
    # runs the plain CPU path
    small = cut_config(cfg, TP_PLAIN["layers"])
    eng = ServeEngine(small, cut_params(small, full),
                      max_len=serve_max_len(small, TP_PLAIN["prompt"],
                                            TP_PLAIN["steps"]),
                      device=device, mesh=mesh)
    res["plain_cut_logits"], res["plain_cut_tokens"] = _greedy_run(
        eng, request_batch(cfg, np.random.default_rng(1), 2,
                           TP_PLAIN["prompt"]), TP_PLAIN["steps"])
    del eng
    engine = ServeEngine(cfg, full, max_len=serve_max_len(cfg, prompt, gen),
                         device=device, mesh=mesh)
    del full
    gc.collect()
    _card_reset_peak(device)
    res["weights_bytes"] = _card_mem(device, "memory_allocated")
    batch = request_batch(cfg, np.random.default_rng(0), batch_size, prompt)
    cluster = ICheckCluster(n_icheck_nodes=1) if rank == 0 else None
    try:
        client = ICheckClient("serve_tp", cluster.controller).init() \
            if rank == 0 else None
        reset_counts()
        _sync(device)
        with CountedAllReduce() as ar:
            t0 = time.monotonic()
            out = engine.generate(batch, gen_len=gen,
                                  checkpoint_client=client)
            _sync(device)
            res["generate_s"] = time.monotonic() - t0
        res["launches"] = read_counts()
        res["all_reduces_generate"] = ar.calls
        if device.type == "cuda":
            _check_launches(res["launches"], {"flash_fwd": cfg.num_layers},
                            "the split generate")
        res["tokens"] = out
        if rank == 0:
            t0 = time.monotonic()
            engine.last_commit.wait(timeout=600)
            res["commit_wait_s"] = time.monotonic() - t0
            res["drain_wait_s"] = settle(cluster)
            res["parts"] = {n: r.partition.num_parts
                            for n, r in client.regions.items()}
            res["committed_bytes"] = sum(r.nbytes
                                         for r in client.regions.values())
        dist.barrier()
        t0 = time.monotonic()
        restored = engine.restore_serving_state(client, batch_size)
        _sync(device)
        res["restore_s"] = time.monotonic() - t0
        reset_counts()
        with CountedAllReduce() as ar:
            t0 = time.monotonic()
            logits, fresh = engine.prefill(batch)
            _sync(device)
            res["prefill_ms"] = (time.monotonic() - t0) * 1e3
        res["all_reduces_prefill"] = ar.calls
        if device.type == "cuda":
            _check_launches(read_counts(), {"flash_fwd": cfg.num_layers},
                            "the split prefill")
        res["restored_equal"] = all(
            torch.equal(a, b) for (_, a), (_, b) in
            zip(_flatten(restored), _flatten(fresh)))
        res["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for _, t in _flatten(fresh))
        del fresh, logits
        reset_counts()
        with CountedAllReduce() as ar:
            t0 = time.monotonic()
            cont = engine.decode_greedy(restored, out[:, :1], gen - 1)
            res["decode_ms_per_token"] = \
                (time.monotonic() - t0) * 1e3 / (gen - 1)
        res["all_reduces_decode_step"] = ar.calls / (gen - 1)
        _check_launches(read_counts(), {"flash_fwd": 0}, "the split decode")
        res["restored_decode_equal"] = bool(np.array_equal(cont, out[:, 1:]))
        del restored
        # the collectives' own share of a decode step: each all-reduce
        # timed between synchronizations, over TP_TIMED_STEPS steps
        _, cache = engine.prefill(batch)
        n = min(TP_TIMED_STEPS, gen - 1)
        with CountedAllReduce(timed=True) as ar:
            _sync(device)
            t0 = time.monotonic()
            engine.decode_greedy(cache, out[:, :1], n)
            _sync(device)
            step_ms = (time.monotonic() - t0) * 1e3 / n
        res["timed_step_ms"] = step_ms
        res["all_reduce_host_ms_per_step"] = ar.ms / n
        del cache
        # the logits after the prefill and each step, fed the live tokens,
        # for the parent's one-process runs
        res["logits"], _ = _greedy_run(engine, batch, gen - 1, feed=out)
        res["max_memory_allocated"] = _card_mem(device)
        if rank == 0:
            client.finalize()
    finally:
        if cluster is not None:
            cluster.close()
    return res


def tp_train_rank(tcfg, mesh, device, seq=TRAIN_SEQ) -> dict:
    """Phase 9b on one rank: qwen2.5-3b cut to TP_TRAIN_LAYERS layers at
    full width, drawn whole and split: the f32 cut's loss and gradient
    shards over one GRAD_SEQ-token sequence (for the parent's plain CPU
    path), then TP_TRAIN_STEPS bf16 train steps of one TRAIN_SEQ-token
    sequence (``make_train_step(mesh=)``: AdamW's clip over the split
    leaves)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.models import (init_params, map_axes, param_axes,
                                    param_specs)
    from repro_torch.models.params import local_box, shard_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import NamedSharding, get_rules, use_rules
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train.step import compute_grads

    cut = dataclasses.replace(tcfg, num_layers=TP_TRAIN_LAYERS)
    small = cut_config(tcfg, TP_TRAIN_LAYERS)
    full = init_params(cut, torch.Generator(device=device).manual_seed(0),
                       device=device)
    res = {}
    rules = get_rules(cut.rules)
    # each leaf's box, as (start, stop) rows of an int tensor
    axes = param_axes(small)
    res["boxes"] = dict(_named(map_axes(
        lambda ax, s, t: torch.tensor([(sl.start, sl.stop) for sl in
                                       local_box(NamedSharding(mesh, s),
                                                 t.shape)]).reshape(-1, 2),
        axes, param_specs(axes, rules, mesh, full), full)))
    inputs = request_batch(tcfg, np.random.default_rng(2), 1, GRAD_SEQ)
    batch = {"tokens": torch.from_numpy(inputs["tokens"].astype(np.int64))
             .to(device)}
    batch["labels"] = batch["tokens"]
    params = shard_params(full, small, mesh)
    reset_counts()
    with use_rules(mesh, rules):
        loss, _, grads = compute_grads(small, params, batch)
    _sync(device)
    res["plain_cut_launches"] = read_counts()
    res["plain_cut_loss"] = float(loss)
    res["plain_cut_grads"] = {n: g.cpu() for n, g in _named(grads)}
    del params, grads
    params = shard_params(full, cut, mesh)
    del full
    gc.collect()
    _card_reset_peak(device)
    state = TrainState(params=params, opt=adamw_init(params),
                       step=torch.zeros((), dtype=torch.int32, device=device))
    step = make_train_step(cut, AdamWConfig(), mesh=mesh)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                             (1, seq))
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    batch["labels"] = batch["tokens"]
    res.update(step_ms=[], losses=[], grad_norms=[], all_reduces=[])
    reset_counts()
    for _ in range(TP_TRAIN_STEPS):
        with CountedAllReduce() as ar:
            _sync(device)
            t0 = time.monotonic()
            state, m = step(state, batch)
            _sync(device)
        res["step_ms"].append((time.monotonic() - t0) * 1e3)
        res["losses"].append(float(m["loss"]))
        res["grad_norms"].append(float(m["grad_norm"]))
        res["all_reduces"].append(ar.calls)
    res["launches"] = read_counts()
    res["max_memory_allocated"] = _card_mem(device)
    n = TP_TRAIN_LAYERS * TP_TRAIN_STEPS
    if device.type == "cuda":
        _check_launches(res["launches"], {"flash_fwd": 2 * n,
                                          "flash_bwd_sm90": n,
                                          "flash_bwd": 0},
                        "the split training steps")
    if not all(math.isfinite(x) for x in res["losses"] + res["grad_norms"]):
        raise AssertionError(f"split training: {res['losses']}, "
                             f"{res['grad_norms']}")
    dist.barrier()
    return res


def _named(tree):
    from repro_torch.core.snapshot import _flatten, _leaf_name

    return [(_leaf_name(p), t) for p, t in _flatten(tree)]


def tp_config(arch: str, rehearse: bool = False):
    """Phase 9's config of ``arch``: the published one, or for a CPU
    rehearsal its tiny one computing in bf16, as the card's does."""
    from repro_torch.configs import get_config

    if rehearse:
        return dataclasses.replace(get_config(arch, tiny=True),
                                   dtype="bfloat16")
    return get_config(arch)


def serve_cut(cfg):
    """``cfg`` cut to SERVE_LAYERS layers for its serving phase (the
    RG-LRU hybrid to one super-layer and both tail layers, which its f32
    cuts take), and the line's ``reduced`` entry."""
    n = SERVE_LAYERS
    if cfg.mixer == "rglru_hybrid":
        n = len(cfg.pattern or ("rec", "rec", "attn")) + len(
            cfg.tail_layers or ()) or n
    return (dataclasses.replace(cfg, num_layers=n),
            {"num_layers": f"{cfg.num_layers} -> {n}: cut to keep the "
             f"whole run within its 1,200 s"})


def rnn_tp_config(arch: str, rehearse: bool = False):
    """Phase 10's served config of ``arch``: ``tp_config``'s, cut to
    SERVE_LAYERS layers on the card."""
    cfg = tp_config(arch, rehearse)
    return cfg if rehearse else serve_cut(cfg)[0]


def tp_serve_config(rehearse: bool = False):
    """Phase 9's served config: yi-6b cut to TP_SERVE_LAYERS layers (its
    tiny config in a rehearsal)."""
    cfg = tp_config("yi-6b", rehearse)
    if rehearse:
        return cfg
    return dataclasses.replace(cfg, num_layers=TP_SERVE_LAYERS)


def _tp_sizes(rehearse: bool) -> dict:
    """Phase 9's sizes: the card's, or a CPU rehearsal's (tiny configs)."""
    if rehearse:
        return dict(batch=2, prompt=16, gen=4, seq=64)
    return dict(batch=BATCH, prompt=PROMPT, gen=GEN, seq=TRAIN_SEQ)


def _rel(a, b) -> float:
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _vocab_whole(parts):
    """Logits of every rank (model-rank order) joined over the vocab."""
    import torch

    return [torch.cat(step, dim=-1) for step in zip(*parts)]


def tp_phase(cfg, tcfg, device, card, rehearse=False, ranks=None,
             children_s=None) -> dict:
    """Phase 9: ``tp_world_main``'s "tp9" part on TP_MODEL processes
    (their kernels already built; ``ranks``: their results, when the
    world has run already), then, in this process, the checks that need
    the whole model: the f32 cuts against the plain CPU path, and the
    bf16 logits against this card's one-process runs in bf16 and in f32,
    fed the split run's tokens.  ``rehearse``: all of it on the CPU with
    the tiny configs (``cfg``, ``tcfg`` and ``device`` given so)."""
    import numpy as np
    import torch

    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, serve_max_len
    from repro_torch.train.step import compute_grads

    sz = _tp_sizes(rehearse)
    batch_size, prompt, gen = sz["batch"], sz["prompt"], sz["gen"]
    if ranks is None:
        gc.collect()
        _card_reset_peak(device)
        t0 = time.monotonic()
        ranks = spawn_tp_world(("tp9",), TP_MODEL, rehearse)
        children_s = time.monotonic() - t0
    sv = [r["serve"] for r in ranks]
    tr = [r["train"] for r in ranks]
    out = sv[0]["tokens"]
    for r, s in enumerate(sv):
        if not np.array_equal(s["tokens"], out):
            raise AssertionError(f"rank {r}'s tokens differ from rank 0's")
        if not (s["restored_equal"] and s["restored_decode_equal"]):
            raise AssertionError(f"rank {r}: the restored split cache "
                                 f"{s['restored_equal']}, its decode "
                                 f"{s['restored_decode_equal']}")
    kv = {n: p for n, p in sv[0]["parts"].items() if n != "idx"}
    if set(kv.values()) != {TP_MODEL}:
        raise AssertionError(f"committed parts {sv[0]['parts']}")
    # two all-reduces a layer (attention's and the FFN's outputs), one
    # for the embedding, two for a greedy argmax over the vocab shards
    per_step = 2 * cfg.num_layers + 3
    counts = (sv[0]["all_reduces_prefill"], sv[0]["all_reduces_decode_step"],
              sv[0]["all_reduces_generate"])
    if counts != (per_step - 2, per_step, per_step * gen):
        raise AssertionError(f"all-reduces (prefill, decode step, generate) "
                             f"{counts}, want {per_step - 2}, {per_step}, "
                             f"{per_step * gen}")

    # 9a: the f32 cut against the plain CPU path
    t0 = time.monotonic()
    full = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    small = cut_config(cfg, TP_PLAIN["layers"])
    cpu = ServeEngine(small, _map(lambda t: t.cpu(), cut_params(small, full)),
                      max_len=serve_max_len(small, TP_PLAIN["prompt"],
                                            TP_PLAIN["steps"]), device="cpu")
    want, want_toks = _greedy_run(
        cpu, request_batch(cfg, np.random.default_rng(1), 2,
                           TP_PLAIN["prompt"]), TP_PLAIN["steps"])
    del cpu
    got = _vocab_whole([s["plain_cut_logits"] for s in sv])
    cut_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not (np.array_equal(sv[0]["plain_cut_tokens"], want_toks)
            and cut_err <= TP_PLAIN_ATOL):
        raise AssertionError(f"split f32 cut: tokens {sv[0]['plain_cut_tokens']}"
                             f" against the CPU's {want_toks}, logits max "
                             f"abs err {cut_err} (atol {TP_PLAIN_ATOL})")
    # 9a: the bf16 logits against one process on this card, and the f32
    # run's against them both; every run fed the split run's tokens
    batch = request_batch(cfg, np.random.default_rng(0), batch_size, prompt)
    one = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        if dtype == "bfloat16":
            cast_leaves_(full, torch.bfloat16)
        eng = ServeEngine(c, full, max_len=serve_max_len(cfg, prompt, gen),
                          device=device)
        one[dtype], _ = _greedy_run(eng, batch, gen - 1, feed=out)
        del eng
        gc.collect()
    del full
    gc.collect()
    _card_reset_peak(device)
    split = _vocab_whole([s["logits"] for s in sv])
    vocab = cfg.vocab_size

    def rel(xs, ys):
        return max(_rel(a[:, :vocab], b[:, :vocab]) for a, b in zip(xs, ys))
    tp_rel = rel(split, one["bfloat16"])
    bf16_rel = rel(one["bfloat16"], one["float32"])
    tp_f32_rel = rel(split, one["float32"])
    equal = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(split, one["bfloat16"]))
    # each bf16 run lies about bf16's own error from the f32 logits, so
    # two of them lie within twice it of each other
    if not tp_rel <= TP_BF16_BOUND * bf16_rel:
        raise AssertionError(f"split bf16 logits {tp_rel} of their max from "
                             f"one process's, beyond {TP_BF16_BOUND} x "
                             f"bf16's own {bf16_rel}")
    check_s = time.monotonic() - t0

    # 9b: the f32 cut's gradient shards against the plain CPU path
    t0 = time.monotonic()
    small_t = cut_config(tcfg, TP_TRAIN_LAYERS)
    params = _map(lambda t: t.cpu(), init_params(
        dataclasses.replace(tcfg, num_layers=TP_TRAIN_LAYERS),
        torch.Generator(device=device).manual_seed(0), device=device))
    inputs = request_batch(tcfg, np.random.default_rng(2), 1, GRAD_SEQ)
    tb = {"tokens": torch.from_numpy(inputs["tokens"].astype(np.int64))}
    tb["labels"] = tb["tokens"]
    loss, _, grads = compute_grads(small_t, params, tb)
    want = dict(_named(grads))
    worst, worst_leaf = 0.0, None
    for r in tr:
        for name, g in r["plain_cut_grads"].items():
            w = want[name][tuple(slice(a, b) for a, b in
                                 r["boxes"][name].tolist())]
            e = (g - w).abs().max().item() / max(
                want[name].abs().max().item(), 1e-30)
            if e > worst:
                worst, worst_leaf = e, name
    loss_err = max(abs(r["plain_cut_loss"] - float(loss)) / abs(float(loss))
                   for r in tr)
    if not (loss_err <= LOSS_RTOL and worst <= TP_GRAD_TOL):
        raise AssertionError(f"split f32 cut's gradients: worst leaf "
                             f"{worst_leaf} {worst} of its largest (at most "
                             f"{TP_GRAD_TOL}), loss rel err {loss_err}")
    grad_check_s = time.monotonic() - t0
    del params, grads, want
    s0, t0r = sv[0], tr[0]
    serve = {
        "card": card, "ranks": TP_MODEL, "backend": ranks[0]["backend"],
        "mesh": ranks[0]["mesh"],
        "local_heads": [cfg.num_heads // TP_MODEL,
                        cfg.num_kv_heads // TP_MODEL],
        "prefill_ms": s0["prefill_ms"],
        "decode_ms_per_token": s0["decode_ms_per_token"],
        "output_tokens_per_s": batch_size * gen / s0["generate_s"],
        "generate_wall_s": s0["generate_s"],
        "all_reduces_generate": s0["all_reduces_generate"],
        "all_reduces_prefill": s0["all_reduces_prefill"],
        "all_reduces_decode_step": s0["all_reduces_decode_step"],
        "timed_step_ms": s0["timed_step_ms"],
        "all_reduce_host_ms_per_step": s0["all_reduce_host_ms_per_step"],
        "all_reduce_share": s0["all_reduce_host_ms_per_step"]
        / s0["timed_step_ms"],
        "commit_wait_s": s0["commit_wait_s"],
        "restore_wall_s": s0["restore_s"], "parts": s0["parts"],
        "committed_bytes": s0["committed_bytes"],
        "cache_bytes_per_rank": [s["cache_bytes"] for s in sv],
        "weights_bytes_per_rank": [s["weights_bytes"] for s in sv],
        "max_memory_allocated_per_rank": [s["max_memory_allocated"]
                                          for s in sv],
        "launches": s0["launches"],
        "logits_rel_err_vs_one_process_bf16": tp_rel,
        "bf16_rel_err_vs_f32": bf16_rel,
        "logits_rel_err_vs_one_process_f32": tp_f32_rel,
        "logits_bound": TP_BF16_BOUND * bf16_rel,
        "greedy_equal_to_one_process": equal,
        "greedy_tokens": batch_size * gen,
        "plain_cut_max_abs_err": cut_err,
        "children_wall_s": children_s, "serve_phase_s": s0["phase_s"],
        "check_s": check_s,
        "reduced": {"ranks": f"{TP_MODEL} processes on one card over gloo "
                    f"(NCCL takes one card a rank): every all-reduce is "
                    f"staged through the host",
                    **({} if rehearse else {
                        "num_layers": f"32 -> {cfg.num_layers}: cut "
                        f"to keep the whole run within its 1,200 s"})}}
    train = {
        "card": card, "ranks": TP_MODEL, "layers": TP_TRAIN_LAYERS,
        "seq": sz["seq"], "step_ms": t0r["step_ms"], "losses": t0r["losses"],
        "grad_norms": t0r["grad_norms"],
        "all_reduces_per_step": t0r["all_reduces"],
        "launches": t0r["launches"],
        "max_memory_allocated_per_rank": [r["max_memory_allocated"]
                                          for r in tr],
        "plain_cut_worst_leaf": worst_leaf,
        "plain_cut_worst_leaf_err_of_max": worst,
        "plain_cut_loss_rel_err": loss_err,
        "plain_cut_launches": t0r["plain_cut_launches"],
        "train_phase_s": t0r["phase_s"], "grad_check_s": grad_check_s,
        "reduced": {"num_layers": f"{tcfg.num_layers} -> {TP_TRAIN_LAYERS}:"
                    f" loss and gradients of a cut, as phase 5d's",
                    "global_batch": f"one sequence of {sz['seq']} tokens"}}
    return {"serve_tp": serve, "train_tp": train}


# --------------------------------------------------------------------------
# phase 10: the "model" axis for the recurrent models, and at 4 ranks
# --------------------------------------------------------------------------
def _cut_inputs(small, cut, device) -> tuple:
    """The requests of an f32 cut's serving check (``cut``'s
    ``serve_batch`` sequences of ``prompt`` tokens, seed 1) and the batch
    of its gradient check (``grad_batch`` of ``grad_seq`` tokens, seed 2,
    each its own labels), as numpy and tensors on ``device``."""
    import numpy as np
    import torch

    requests = request_batch(small, np.random.default_rng(1),
                             cut["serve_batch"], cut["prompt"])
    toks = torch.from_numpy(request_batch(
        small, np.random.default_rng(2), cut["grad_batch"],
        cut["grad_seq"])["tokens"].astype(np.int64)).to(device)
    return requests, {"tokens": toks, "labels": toks}


def cut_split_rank(arch, cfg, mesh, device) -> dict:
    """An f32 cut of ``cfg`` (``TP10_CUTS[arch]``) at full width, drawn
    cut from the seed (as the parent draws it) and split over ``mesh`` on
    this rank: its logits over the rank's vocab columns and greedy tokens
    after a prefill and CUT_STEPS steps, then its loss and gradient shards
    (the rank's boxes of each leaf as rows of an int tensor), with the
    kernels' launches of each."""
    import torch

    from repro_torch.models import (init_params, map_axes, param_axes,
                                    param_specs)
    from repro_torch.models.params import local_box, shard_params
    from repro_torch.serve import ServeEngine, serve_max_len
    from repro_torch.sharding import NamedSharding, get_rules, use_rules
    from repro_torch.train.step import compute_grads

    cut = TP10_CUTS[arch]
    small = cut_config(cfg, cut["layers"])
    params = init_params(small, torch.Generator(device=device).manual_seed(0),
                         device=device)
    requests, batch = _cut_inputs(small, cut, device)
    eng = ServeEngine(small, params,
                      max_len=serve_max_len(small, cut["prompt"], CUT_STEPS),
                      device=device, mesh=mesh)
    reset_counts()
    res = {}
    res["plain_cut_logits"], res["plain_cut_tokens"] = _greedy_run(
        eng, requests, CUT_STEPS)
    res["plain_cut_serve_launches"] = read_counts()
    del eng
    rules = get_rules(small.rules)
    axes = param_axes(small)
    res["boxes"] = dict(_named(map_axes(
        lambda ax, s, t: torch.tensor([(sl.start, sl.stop) for sl in
                                       local_box(NamedSharding(mesh, s),
                                                 t.shape)]).reshape(-1, 2),
        axes, param_specs(axes, rules, mesh, params), params)))
    shards = shard_params(params, small, mesh)
    del params
    reset_counts()
    with use_rules(mesh, rules):
        loss, _, grads = compute_grads(small, shards, batch)
    _sync(device)
    res["plain_cut_launches"] = read_counts()
    res["plain_cut_loss"] = float(loss)
    res["plain_cut_grads"] = {n: g.cpu() for n, g in _named(grads)}
    res["max_memory_allocated"] = _card_mem(device)
    return res


def _plain_reference(arch, small, params, cut=None,
                     steps=CUT_STEPS) -> dict:
    """The plain CPU path of an f32 cut ``small`` of ``arch`` (``params``
    whole, on the CPU), on ``cut_split_rank``'s inputs (``cut``, default
    ``TP10_CUTS[arch]``, and ``steps`` greedy steps): its logits and
    greedy tokens, its loss and gradient, and each gradient leaf's
    largest magnitude."""
    from repro_torch.serve import ServeEngine, serve_max_len
    from repro_torch.train.step import compute_grads

    cut = cut or TP10_CUTS[arch]
    requests, batch = _cut_inputs(small, cut, "cpu")
    cpu = ServeEngine(small, params,
                      max_len=serve_max_len(small, cut["prompt"], steps),
                      device="cpu")
    logits, toks = _greedy_run(cpu, requests, steps)
    loss, _, grads = compute_grads(small, params, batch)
    grads = dict(_named(grads))
    return {"logits": logits, "tokens": toks, "loss": float(loss),
            "grads": grads,
            "grad_max": {n: g.abs().max().item() for n, g in grads.items()}}


def _check_cut(arch, ref, tp_ranks) -> dict:
    """Each rank's split f32 cut (``cut_split_rank``) against the plain
    CPU path's ``ref``: the tokens equal, the logits within
    TP_PLAIN_ATOL, the loss within LOSS_RTOL, every gradient shard within
    the cut's ``grad_tol`` of its leaf's largest value."""
    import numpy as np

    tol = TP10_CUTS[arch]["grad_tol"]
    got = _vocab_whole([r["plain_cut_logits"] for r in tp_ranks])
    err = max((g - w).abs().max().item() for g, w in zip(got, ref["logits"]))
    if not (np.array_equal(tp_ranks[0]["plain_cut_tokens"], ref["tokens"])
            and err <= TP_PLAIN_ATOL):
        raise AssertionError(f"{arch} split f32 cut: tokens "
                             f"{tp_ranks[0]['plain_cut_tokens']} against the "
                             f"CPU's {ref['tokens']}, logits max abs err "
                             f"{err} (atol {TP_PLAIN_ATOL})")
    worst, worst_leaf = 0.0, None
    for r in tp_ranks:
        for name, g in r["plain_cut_grads"].items():
            w = ref["grads"][name][tuple(slice(a, b) for a, b in
                                         r["boxes"][name].tolist())]
            e = (g - w).abs().max().item() / max(ref["grad_max"][name],
                                                 1e-30)
            if e > worst:
                worst, worst_leaf = e, name
    loss_err = max(abs(r["plain_cut_loss"] - ref["loss"]) / abs(ref["loss"])
                   for r in tp_ranks)
    grads = {"worst_leaf": worst_leaf, "worst_leaf_err_of_max": worst,
             "loss_rel_err": loss_err}
    if not (loss_err <= LOSS_RTOL and worst <= tol):
        raise AssertionError(f"{arch} split f32 cut's gradients: {grads} "
                             f"(leaf at most {tol} of its largest, loss "
                             f"rtol {LOSS_RTOL})")
    return {"plain_cut_layers": TP10_CUTS[arch]["layers"],
            "plain_cut_max_abs_err": err, "plain_cut_grads": grads,
            "plain_cut_serve_launches": tp_ranks[0]["plain_cut_serve_launches"],
            "plain_cut_launches": tp_ranks[0]["plain_cut_launches"]}


def rnn_tp_serve_rank(arch, cfg, mesh, device, batch_size, prompt,
                      gen) -> dict:
    """Phase 10a / 10b (and 10c) on one rank for a recurrent model.

    10c first: its f32 cut split (``cut_split_rank``), whose backward runs
    K6's or K7's and K4's backwards at the rank's widths.  Then the
    whole model: the ranks draw it in turn
    (phase 4's seed), each casting its f32 draw to bf16 leaf by leaf, so
    the card holds one f32 draw at a time; served split through
    ``ServeEngine(mesh=)``, the state committed after prefill on rank 0,
    restored on the mesh (bit-equal to a second prefill, decoding to the
    live tokens), and restored whole on rank 0 alone, which decodes from
    it in one process and then serves the batch in one process, fed the
    split run's tokens (the logits the split ones are held to); the collectives counted, and timed alone (between
    synchronizations) in the second prefill and the restored decode.  The
    second prefill's logits and the restored decode's (fed the live
    tokens, which it reproduces) go to the parent's one-process runs."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import ICheckClient, ICheckCluster
    from repro_torch.core.snapshot import _flatten, dtensor_sharding
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, serve_max_len

    rank = dist.get_rank()
    res = cut_split_rank(arch, cfg, mesh, device)
    gc.collect()
    _card_reset_peak(device)

    full = None
    for r in range(dist.get_world_size()):
        if r == rank:
            full = init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device=device)
            cast_leaves_(full, torch.bfloat16)
            _sync(device)
            gc.collect()
            _card_reset_peak(device)      # the f32 draw's blocks go back
        dist.barrier()
    max_len = serve_max_len(cfg, prompt, gen)
    engine = ServeEngine(cfg, full, max_len=max_len, device=device,
                         mesh=mesh)
    if rank != 0:
        full = None       # rank 0 keeps its draw for the one-rank restore
    gc.collect()
    _card_reset_peak(device)
    res["weights_bytes"] = _card_mem(device, "memory_allocated")
    batch = request_batch(cfg, np.random.default_rng(0), batch_size, prompt)
    cluster = ICheckCluster(n_icheck_nodes=1) if rank == 0 else None
    try:
        client = ICheckClient(f"serve_tp_{cfg.mixer}",
                              cluster.controller).init() \
            if rank == 0 else None
        reset_counts()
        _sync(device)
        with CountedAllReduce() as ar:
            t0 = time.monotonic()
            out = engine.generate(batch, gen_len=gen,
                                  checkpoint_client=client)
            _sync(device)
            res["generate_s"] = time.monotonic() - t0
        res["launches"] = read_counts()
        res["all_reduces_generate"] = ar.calls
        res["tokens"] = out
        if rank == 0:
            t0 = time.monotonic()
            engine.last_commit.wait(timeout=600)
            res["commit_wait_s"] = time.monotonic() - t0
            res["drain_wait_s"] = settle(cluster)
            res["parts"] = {n: r.partition.num_parts
                            for n, r in client.regions.items()}
            res["committed_bytes"] = sum(r.nbytes
                                         for r in client.regions.values())
        dist.barrier()
        t0 = time.monotonic()
        restored = engine.restore_serving_state(client, batch_size)
        _sync(device)
        res["restore_s"] = time.monotonic() - t0
        reset_counts()
        # each collective timed between synchronizations: the share of a
        # prefill the RG-LRU's gate partial sums, reduce-scattered, take
        with CountedAllReduce(timed=True) as ar:
            _sync(device)
            t0 = time.monotonic()
            logits, fresh = engine.prefill(batch)
            _sync(device)
            res["prefill_ms"] = (time.monotonic() - t0) * 1e3
        res["prefill_launches"] = read_counts()
        res["all_reduces_prefill"] = ar.calls
        res["all_reduce_host_ms_prefill"] = ar.ms
        steps = [logits]
        res["restored_equal"] = all(
            torch.equal(a, b) for (_, a), (_, b) in
            zip(_flatten(restored), _flatten(fresh)))
        res["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for _, t in _flatten(fresh))
        # each leaf's box on the mesh and the rank's restored part of it
        res["restored_boxes"] = {
            n: [(s.start, s.stop) for s in dtensor_sharding(t)
                .devices_indices_map(tuple(t.shape))[rank]]
            for n, t in _named(engine._on_mesh(restored, batch_size))}
        # copies: decode writes into the state in place
        res["restored"] = {n: t.to("cpu", copy=True)
                           for n, t in _named(restored)}
        del fresh
        # the restored state decoded as ``decode_greedy`` does, each
        # step's logits kept on the card until the steps are timed; gloo
        # copies each CUDA tensor it reduces to the host, so the
        # synchronizations around the collectives add little to a step
        reset_counts()
        tok = torch.as_tensor(out[:, :1], device=device)
        toks = []
        with CountedAllReduce(timed=True) as ar:
            _sync(device)
            t0 = time.monotonic()
            for _ in range(gen - 1):
                logits, restored = engine.step(restored, tok)
                tok = engine.greedy(logits)
                steps.append(logits)
                toks.append(tok)
            _sync(device)
            res["decode_ms_per_token"] = \
                (time.monotonic() - t0) * 1e3 / (gen - 1)
        res["decode_launches"] = read_counts()
        res["all_reduces_decode_step"] = ar.calls / (gen - 1)
        res["all_reduce_host_ms_per_step"] = ar.ms / (gen - 1)
        cont = torch.cat(toks, dim=1).cpu().numpy()
        res["restored_decode_equal"] = bool(np.array_equal(cont, out[:, 1:]))
        res["logits"] = [x.float().cpu() for x in steps]
        del steps, logits, restored
        res["max_memory_allocated"] = _card_mem(device)
        dist.barrier()
        del engine
        gc.collect()
        if rank == 0:
            # the committed state restored whole on this rank alone, and
            # decoded from in one process
            one = ServeEngine(cfg, full, max_len=max_len, device=device)
            t0 = time.monotonic()
            whole = one.restore_serving_state(client, batch_size)
            _sync(device)
            res["whole_restore_s"] = time.monotonic() - t0
            res["whole"] = {n: t.to("cpu", copy=True)
                            for n, t in _named(whole)}
            res["whole_decode"] = one.decode_greedy(whole, out[:, :1],
                                                    gen - 1)
            del whole
            # the one-process bf16 run the split logits are held to, fed
            # the split run's tokens
            res["one_logits"], _ = _greedy_run(one, batch, gen - 1,
                                               feed=out)
            del one
            client.finalize()
        full = None
        gc.collect()
        dist.barrier()
    finally:
        if cluster is not None:
            cluster.close()
    return res


def tp_world_main(rank, world, store, out_dir, parts, rehearse=False) -> None:
    """One rank of a world over gloo on the one card (NCCL refuses two
    ranks on one card), a ("data", "model") mesh of 1 x ``world``; or,
    with ``rehearse``, a CPU gloo world with tiny configs.  ``parts``, in
    order: "tp9" serves yi-6b and trains qwen2.5-3b split (phase 9),
    "rnn" serves rwkv6-7b then recurrentgemma-9b split two ways with
    their f32 cuts (10a-10c), "phi3" runs phi3-medium-14b's cut split
    (10d), "moe" serves dbrx-132b and qwen3-moe-235b-a22b split over
    "model" (11a), "fsdp" runs qwen3-moe's f32 cut on a FSDP_MESH
    ("data", "model") mesh (11b).  Its results go to ``out_dir``."""
    sys.path[:0] = [str(SRC), str(ROOT / "tests")]
    import torch
    import torch.distributed as dist

    from repro_torch.sharding import init_world, make_tp_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rehearse:
        torch.set_num_threads(1)
    init_world(rank, world, "gloo" if rehearse else "cuda:gloo", store)
    try:
        mesh = make_tp_mesh(1, world)
        device = torch.device("cpu") if rehearse else torch.device(
            "cuda", torch.cuda.current_device())
        res = {}
        if "tp9" in parts:
            sz = _tp_sizes(rehearse)
            t0 = time.monotonic()
            res["serve"] = tp_serve_rank(
                tp_serve_config(rehearse), mesh, device, sz["batch"],
                sz["prompt"], sz["gen"])
            res["serve"]["phase_s"] = time.monotonic() - t0
            gc.collect()
            _card_reset_peak(device)
            t0 = time.monotonic()
            res["train"] = tp_train_rank(tp_config("qwen2.5-3b", rehearse),
                                         mesh, device, sz["seq"])
            res["train"]["phase_s"] = time.monotonic() - t0
            gc.collect()
            _card_reset_peak(device)
        if "rnn" in parts:
            sz = _tp10_sizes(rehearse)
            for arch in RNN_TP_ARCHS:
                t0 = time.monotonic()
                res[arch] = rnn_tp_serve_rank(
                    arch, rnn_tp_config(arch, rehearse), mesh, device,
                    sz["batch"], sz["prompt"][arch], sz["gen"])
                res[arch]["phase_s"] = time.monotonic() - t0
                gc.collect()
                _card_reset_peak(device)
        if "phi3" in parts:
            t0 = time.monotonic()
            res["phi3"] = cut_split_rank(
                "phi3-medium-14b", tp_config("phi3-medium-14b", rehearse),
                mesh, device)
            res["phi3"]["phase_s"] = time.monotonic() - t0
        if "moe" in parts:
            sz = _moe_sizes(rehearse)
            for arch in MOE_TP_ARCHS:
                t0 = time.monotonic()
                res[arch] = moe_tp_serve_rank(
                    moe_tp_config(arch, rehearse), mesh, device, sz["batch"],
                    sz["prompt"], sz["gen"])
                res[arch]["phase_s"] = time.monotonic() - t0
                gc.collect()
                _card_reset_peak(device)
        if "kvseq" in parts:
            t0 = time.monotonic()
            res["kvseq"] = kv_seq_rank(mesh, device, rehearse)
            res["kvseq"]["phase_s"] = time.monotonic() - t0
            gc.collect()
            _card_reset_peak(device)
        if "fsdp" in parts:
            t0 = time.monotonic()
            res["fsdp"] = fsdp_cut_rank(moe_tp_config(FSDP_ARCH, rehearse),
                                        make_tp_mesh(*FSDP_MESH), device)
            res["fsdp"]["phase_s"] = time.monotonic() - t0
        res["backend"] = dist.get_backend()
        res["mesh"] = repr(mesh)
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tp10_sizes(rehearse: bool) -> dict:
    """Phase 10's serving sizes: the card's, or a CPU rehearsal's (tiny
    configs; recurrentgemma-9b's prompt rolls its window of 16)."""
    if rehearse:
        return dict(batch=2, gen=4, prompt={"rwkv6-7b": 16,
                                             "recurrentgemma-9b": 20})
    return dict(batch=BATCH, gen=GEN,
                prompt={arch: PROMPT for arch in RNN_TP_ARCHS})


def spawn_tp_world(parts, world, rehearse, each=None) -> list:
    """``tp_world_main`` on ``world`` processes; their results, or with
    ``each`` what ``each(rank, result)`` returns of each, the results
    loaded one at a time."""
    import torch
    import torch.multiprocessing as mp

    _trim_host()
    store = Path(tempfile.mkdtemp(prefix="chip-smoke-tp-"))
    try:
        mp.start_processes(tp_world_main, args=(world, str(store / "w"),
                                                str(store), tuple(parts),
                                                rehearse),
                           nprocs=world, join=True, start_method="spawn")
        return [(each or (lambda r, res: res))(
            r, torch.load(store / f"rank{r}.pt", weights_only=False))
            for r in range(world)]
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _trim_host() -> None:
    """Hand this process's freed heap back to the system (glibc keeps it
    otherwise) before a world of processes starts beside it."""
    import ctypes

    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def rnn_tp_all_reduces(cfg) -> int:
    """All-reduces of one split decode step at "model" 2: RWKV-6 three a
    layer (the time-mix's and the FFN's row-split outputs, the receptance
    gather), the RG-LRU three (its gates' reduce-scatter, its output and
    the FFN's), recurrentgemma-9b's attention four (K and V gathered: its
    one kv head splits inside; its output and the FFN's); the embedding's
    one and the greedy argmax's two over the vocab shards."""
    from repro_torch.models import stack_plan

    plan = stack_plan(cfg)
    kinds = list(plan["scan_kinds"]) * plan["scan_len"] + list(
        plan["tail_kinds"])
    per = {"rwkv": 3, "rec": 3, "attn": 4}
    return sum(per[k] for k in kinds) + 3


def _check_rnn_tp(cfg, sv, gen, per_step=None) -> dict:
    """The split serving run's checks that need no model: every rank's
    tokens equal, the restored state equal to a second prefill and
    decoding to the live tokens, the whole state restored on rank 0 equal
    to every rank's box, one committed part a distinct box, and the
    collectives counted.  Returns the counts."""
    import numpy as np
    import torch

    out = sv[0]["tokens"]
    for r, s in enumerate(sv):
        if not np.array_equal(s["tokens"], out):
            raise AssertionError(f"{cfg.name}: rank {r}'s tokens differ "
                                 f"from rank 0's")
        if not (s["restored_equal"] and s["restored_decode_equal"]):
            raise AssertionError(f"{cfg.name} rank {r}: the restored split "
                                 f"state {s['restored_equal']}, its decode "
                                 f"{s['restored_decode_equal']}")
        for name, part in s["restored"].items():
            box = tuple(slice(a, b) for a, b in s["restored_boxes"][name])
            if not torch.equal(sv[0]["whole"][name][box], part):
                raise AssertionError(f"{cfg.name}: {name} restored whole on "
                                     f"one rank differs from rank {r}'s box")
    parts = {}
    for name in sv[0]["restored"]:
        parts[name] = len({tuple(map(tuple, s["restored_boxes"][name]))
                           for s in sv})
    if sv[0]["parts"] != parts:
        raise AssertionError(f"{cfg.name}: committed parts {sv[0]['parts']}"
                             f", want one a distinct box {parts}")
    per_step = per_step or rnn_tp_all_reduces(cfg)
    counts = (sv[0]["all_reduces_prefill"], sv[0]["all_reduces_decode_step"],
              sv[0]["all_reduces_generate"])
    if counts != (per_step - 2, per_step, per_step * gen):
        raise AssertionError(f"{cfg.name}: all-reduces (prefill, decode "
                             f"step, generate) {counts}, want "
                             f"{per_step - 2}, {per_step}, {per_step * gen}")
    return {"per_step": per_step, "parts": parts}


def _rnn_tp_want(cfg, gen) -> dict:
    """K6's or K7's and K4's launches on a rank in the split generate,
    prefill and decode (as phases 4b and 4d: the chunked / TMA kernel in
    prefill, the sequential / register one a decode step)."""
    from repro_torch.models import stack_plan

    plan = stack_plan(cfg)
    kinds = list(plan["scan_kinds"]) * plan["scan_len"] + list(
        plan["tail_kinds"])
    if cfg.mixer == "rwkv6":
        n = kinds.count("rwkv")
        return {"launches": {"rwkv6_sm90": n, "rwkv6": n * (gen - 1),
                             "flash_fwd": 0},
                "prefill_launches": {"rwkv6_sm90": n, "rwkv6": 0},
                "decode_launches": {"rwkv6": n * (gen - 1), "rwkv6_sm90": 0}}
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
    return {"launches": {"rglru_sm90": n_rec, "rglru": n_rec * (gen - 1),
                         "flash_fwd": n_attn},
            "prefill_launches": {"rglru_sm90": n_rec, "rglru": 0,
                                 "flash_fwd": n_attn},
            "decode_launches": {"rglru": n_rec * (gen - 1), "rglru_sm90": 0,
                                "flash_fwd": 0}}


def _draw_cuts(device, rehearse) -> dict:
    """Phase 10's f32 cuts, drawn on ``device`` from the seed as the ranks
    draw them and moved to the host: arch -> (cut config, params)."""
    import torch

    from repro_torch.models import init_params

    cuts = {}
    for arch, cut in TP10_CUTS.items():
        small = cut_config(tp_config(arch, rehearse), cut["layers"])
        cuts[arch] = (small, _map(lambda t: t.cpu(), init_params(
            small, torch.Generator(device=device).manual_seed(0),
            device=device)))
    gc.collect()
    _card_reset_peak(device)
    return cuts


def _bf16_hold(arch, cfg, sv, batch_size, gen) -> dict:
    """The split bf16 logits (every rank's vocab columns joined) against
    rank 0's one-process bf16 run on the card, fed the split run's
    tokens: max abs difference over max abs, every step, within
    RNN_TP_BF16_BOUND; the equal greedy tokens counted."""
    split = _vocab_whole([s["logits"] for s in sv])
    one = sv[0]["one_logits"]
    vocab = cfg.vocab_size
    tp_rel = max(_rel(a[:, :vocab], b[:, :vocab]) for a, b in zip(split, one))
    bound = RNN_TP_BF16_BOUND[arch]
    if not tp_rel <= bound:
        raise AssertionError(f"{arch} split bf16 logits {tp_rel} of their "
                             f"max from one process's, beyond {bound}")
    return {"logits_rel_err_vs_one_process_bf16": tp_rel,
            "logits_bound": bound,
            "greedy_equal_to_one_process": sum(
                int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(split, one)),
            "greedy_tokens": batch_size * gen}


def _rnn_tp_line(arch, sv, card, ranks, sz, hold) -> dict:
    """Phase 10a's or 10b's line from its ranks' results."""
    s0, gen, batch_size = sv[0], sz["gen"], sz["batch"]
    return {
        "card": card, "ranks": RNN_TP_MODEL, "backend": ranks[0]["backend"],
        "mesh": ranks[0]["mesh"], "batch": batch_size,
        "prompt": sz["prompt"][arch], "gen": gen,
        "prefill_ms": s0["prefill_ms"],
        "decode_ms_per_token": s0["decode_ms_per_token"],
        "output_tokens_per_s": batch_size * gen / s0["generate_s"],
        "generate_wall_s": s0["generate_s"],
        "all_reduces_generate": s0["all_reduces_generate"],
        "all_reduces_prefill": s0["all_reduces_prefill"],
        "all_reduces_decode_step": s0["all_reduces_decode_step"],
        "all_reduce_host_ms_per_step": s0["all_reduce_host_ms_per_step"],
        "all_reduce_share": s0["all_reduce_host_ms_per_step"]
        / s0["decode_ms_per_token"],
        "all_reduce_host_ms_prefill": s0["all_reduce_host_ms_prefill"],
        "all_reduce_share_prefill": s0["all_reduce_host_ms_prefill"]
        / s0["prefill_ms"],
        "commit_wait_s": s0["commit_wait_s"],
        "restore_wall_s": s0["restore_s"],
        "whole_restore_wall_s": s0["whole_restore_s"],
        "parts": s0["parts"], "committed_bytes": s0["committed_bytes"],
        "state_bytes_per_rank": [s["cache_bytes"] for s in sv],
        "weights_bytes_per_rank": [s["weights_bytes"] for s in sv],
        "max_memory_allocated_per_rank": [s["max_memory_allocated"]
                                          for s in sv],
        "launches": s0["launches"], "prefill_launches": s0["prefill_launches"],
        "decode_launches": s0["decode_launches"], **hold,
        "whole_decode_equal_tokens": int(
            (s0["whole_decode"] == s0["tokens"][:, 1:]).sum()),
        "rank_phase_s": s0["phase_s"],
        "reduced": {"ranks": f"{RNN_TP_MODEL} processes on one card over "
                    f"gloo (NCCL takes one card a rank): every all-reduce "
                    f"is staged through the host"}}


def tp10_phase(device, card, rehearse=False, ranks=None, cuts=None,
               rnn_children_s=None) -> dict:
    """Phase 10.  ``tp_world_main``'s "rnn" part on RNN_TP_MODEL processes
    (10a-10c; ``ranks``: their results, when the world has run already,
    and ``cuts`` the f32 cuts ``_draw_cuts`` drew before it started), and
    its checks; then its "phi3" part on PHI3_TP_MODEL processes (10d),
    while a thread of this process runs the plain CPU path of every cut;
    each cut's split run against it.  ``rehearse``: all of it on the CPU
    with the tiny configs.  Returns the lines ``serve_tp_rwkv6``,
    ``serve_tp_recurrentgemma`` and ``tp_phi3``."""
    import threading

    import numpy as np

    sz = _tp10_sizes(rehearse)
    gen, batch_size = sz["gen"], sz["batch"]
    t0 = time.monotonic()
    if cuts is None:
        gc.collect()
        _card_reset_peak(device)
        cuts = _draw_cuts(device, rehearse)
    if ranks is None:
        ranks = spawn_tp_world(("rnn",), RNN_TP_MODEL, rehearse)
        rnn_children_s = time.monotonic() - t0
    lines = {}
    for arch in RNN_TP_ARCHS:
        cfg = rnn_tp_config(arch, rehearse)
        sv = [r[arch] for r in ranks]
        counts = _check_rnn_tp(cfg, sv, gen)
        if device.type == "cuda":
            for key, want in _rnn_tp_want(cfg, gen).items():
                _check_launches(sv[0][key], want, f"{arch} split {key}")
        hold = _bf16_hold(arch, cfg, sv, batch_size, gen)
        lines[arch] = {**_rnn_tp_line(arch, sv, card, ranks, sz, hold),
                       **counts}
        if not rehearse:
            lines[arch]["reduced"].update(serve_cut(tp_config(arch))[1])

    # the plain CPU path of every cut, beside 10d's processes on the card
    refs, failed = {}, []

    def plain_refs():
        try:
            for arch in list(cuts):
                small, params = cuts.pop(arch)
                refs[arch] = _plain_reference(arch, small, params)
                del params
        except BaseException as e:          # re-raised below
            failed.append(e)
    t0 = time.monotonic()
    thread = threading.Thread(target=plain_refs)
    thread.start()
    try:
        phi3_ranks = spawn_tp_world(("phi3",), PHI3_TP_MODEL, rehearse)
        phi3_children_s = time.monotonic() - t0
    finally:
        thread.join()
        cpu_s = time.monotonic() - t0
    if failed:
        raise failed[0]
    for arch in RNN_TP_ARCHS:
        lines[arch].update(_check_cut(arch, refs[arch],
                                      [r[arch] for r in ranks]))
    pcfg = tp_config("phi3-medium-14b", rehearse)
    sv = [r["phi3"] for r in phi3_ranks]
    for r, s in enumerate(sv):
        if not np.array_equal(s["plain_cut_tokens"],
                              sv[0]["plain_cut_tokens"]):
            raise AssertionError(f"phi3 rank {r}'s tokens differ")
    cut = TP10_CUTS["phi3-medium-14b"]
    hq = pcfg.num_heads // PHI3_TP_MODEL
    g = pcfg.num_heads // pcfg.num_kv_heads
    phi3 = {"card": card, "ranks": PHI3_TP_MODEL,
            "serve_batch": cut["serve_batch"], "prompt": cut["prompt"],
            "decode_steps": CUT_STEPS, "grad_batch": cut["grad_batch"],
            "grad_seq": cut["grad_seq"],
            # each rank's query heads and the kv heads of their groups
            "query_heads_per_rank": hq,
            "kv_heads_per_rank": [
                len({h // g for h in range(r * hq, (r + 1) * hq)})
                for r in range(PHI3_TP_MODEL)],
            **_check_cut("phi3-medium-14b", refs["phi3-medium-14b"], sv),
            "max_memory_allocated_per_rank": [s["max_memory_allocated"]
                                              for s in sv],
            "rank_phase_s": sv[0]["phase_s"],
            "children_wall_s": phi3_children_s,
            "reduced": {"num_layers": f"{pcfg.num_layers} -> "
                        f"{cut['layers']}: four whole f32 draws of the "
                        f"model (56 GB each) do not fit one card",
                        "ranks": f"{PHI3_TP_MODEL} processes on one card "
                        f"over gloo"}}
    walls = {"rnn_children_s": rnn_children_s,
             "phi3_children_s": phi3_children_s, "cpu_path_s": cpu_s}
    for arch in RNN_TP_ARCHS:
        lines[arch]["walls"] = walls
    return {"serve_tp_rwkv6": lines["rwkv6-7b"],
            "serve_tp_recurrentgemma": lines["recurrentgemma-9b"],
            "tp_phi3": phi3}


# --------------------------------------------------------------------------
# phase 11: Mixture-of-Experts under FSDP_RULES
# --------------------------------------------------------------------------
def moe_tp_config(arch: str, rehearse: bool = False):
    """Phase 11a's config of ``arch``: the published one cut to
    MOE_TP_LAYERS layers, or for a CPU rehearsal its tiny one computing
    in bf16, under ``FSDP_RULES`` as the published one names them."""
    if rehearse:
        return dataclasses.replace(tp_config(arch, True), rules="fsdp")
    return dataclasses.replace(tp_config(arch), num_layers=MOE_TP_LAYERS)


def _moe_sizes(rehearse: bool) -> dict:
    """Phase 11a's serving sizes: the card's, or a CPU rehearsal's."""
    if rehearse:
        return dict(batch=2, prompt=16, gen=4)
    return dict(batch=BATCH, prompt=PROMPT, gen=GEN)


def _mesh_groups(mesh) -> dict:
    return {name: mesh.get_group(name) for name in mesh.mesh_dim_names}


def _engine_in_turn(cfg, mesh, device, max_len):
    """``ServeEngine(mesh=)`` of ``cfg`` on every rank, the ranks drawing
    the whole f32 model (phase 4's seed) in turn: the others' boxes wait
    on the host meanwhile, so the card holds one f32 draw and one rank's
    bf16 boxes at a time where the draw and every rank's boxes would not
    fit (dbrx-132b x 4's draw is 57 GB, its boxes 14.3 GB a rank); the
    last rank to draw keeps its boxes on the card."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    from repro_torch.models import count_params

    rank, world = dist.get_rank(), dist.get_world_size()
    # the f32 draw and every rank's bf16 boxes, against the card
    n = count_params(cfg)
    offload = device.type == "cuda" and rank < world - 1 and 6 * n > 0.85 \
        * torch.cuda.get_device_properties(device).total_memory
    engine = None
    for r in range(world):
        if r == rank:
            full = init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device=device)
            engine = ServeEngine(cfg, full, max_len=max_len, device=device,
                                 mesh=mesh)
            del full
            gc.collect()
            if offload:
                engine.params = _map(lambda t: t.cpu(), engine.params)
            _card_reset_peak(device)
        dist.barrier()
    if offload:
        engine.params = _map(lambda t: t.to(device), engine.params)
    _sync(device)
    return engine


def moe_tp_serve_rank(cfg, mesh, device, batch_size, prompt, gen) -> dict:
    """Phase 11a on one rank: ``cfg`` (a MoE model) served split over the
    "model" axis through ``ServeEngine(mesh=)`` (``_engine_in_turn``):
    the rank's experts and heads, the router, dispatch and combine whole.
    The cache is committed after prefill on rank 0, restored on the mesh
    (bit-equal to a second prefill, decoding to the live tokens); the
    collectives are counted by group, and timed alone in the second
    prefill and the restored decode.  Then rank 0 alone serves the batch
    in one process in f32 and in bf16, fed the split run's tokens and
    routed by its expert ids (``replaying_routes``: the logits the split
    ones are held to, and each router's own choice beside the split
    run's), and restores the committed cache whole and decodes from
    it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import ICheckClient, ICheckCluster
    from repro_torch.core.snapshot import _flatten, dtensor_sharding
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, serve_max_len

    rank = dist.get_rank()
    max_len = serve_max_len(cfg, prompt, gen)
    res = {}
    t0 = time.monotonic()
    engine = _engine_in_turn(cfg, mesh, device, max_len)
    res["draw_s"] = time.monotonic() - t0
    res["weights_bytes"] = _card_mem(device, "memory_allocated")
    groups = _mesh_groups(mesh)
    batch = request_batch(cfg, np.random.default_rng(0), batch_size, prompt)
    cluster = ICheckCluster(n_icheck_nodes=1) if rank == 0 else None
    try:
        client = ICheckClient(f"serve_tp_{cfg.name}",
                              cluster.controller).init() \
            if rank == 0 else None
        reset_counts()
        _sync(device)
        with CountedAllReduce() as ar:
            t0 = time.monotonic()
            out = engine.generate(batch, gen_len=gen,
                                  checkpoint_client=client)
            _sync(device)
            res["generate_s"] = time.monotonic() - t0
        res["launches"] = read_counts()
        res["all_reduces_generate"] = ar.calls
        res["tokens"] = out
        if rank == 0:
            t0 = time.monotonic()
            engine.last_commit.wait(timeout=600)
            res["commit_wait_s"] = time.monotonic() - t0
            res["drain_wait_s"] = settle(cluster)
            res["parts"] = {n: r.partition.num_parts
                            for n, r in client.regions.items()}
            res["committed_bytes"] = sum(r.nbytes
                                         for r in client.regions.values())
        dist.barrier()
        t0 = time.monotonic()
        restored = engine.restore_serving_state(client, batch_size)
        _sync(device)
        res["restore_s"] = time.monotonic() - t0
        reset_counts()
        # the expert ids of the second prefill and the restored decode,
        # for the parent's comparison with one process's
        res["routes"] = routes = []
        with CountedAllReduce(timed=True, groups=groups) as ar, \
                recording_routes(routes):
            _sync(device)
            t0 = time.monotonic()
            logits, fresh = engine.prefill(batch)
            _sync(device)
            res["prefill_ms"] = (time.monotonic() - t0) * 1e3
        res["prefill_launches"] = read_counts()
        res["all_reduces_prefill"] = ar.calls
        res["all_reduce_host_ms_prefill"] = ar.ms
        res["prefill_collectives"] = ar.by
        steps = [logits]
        res["restored_equal"] = all(
            torch.equal(a, b) for (_, a), (_, b) in
            zip(_flatten(restored), _flatten(fresh)))
        res["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for _, t in _flatten(fresh))
        res["restored_boxes"] = {
            n: [(s.start, s.stop) for s in dtensor_sharding(t)
                .devices_indices_map(tuple(t.shape))[rank]]
            for n, t in _named(engine._on_mesh(restored, batch_size))}
        res["restored"] = {n: t.to("cpu", copy=True)
                           for n, t in _named(restored)}
        del fresh
        reset_counts()
        tok = torch.as_tensor(out[:, :1], device=device)
        toks = []
        with CountedAllReduce(timed=True, groups=groups) as ar, \
                recording_routes(routes):
            _sync(device)
            t0 = time.monotonic()
            for _ in range(gen - 1):
                logits, restored = engine.step(restored, tok)
                tok = engine.greedy(logits)
                steps.append(logits)
                toks.append(tok)
            _sync(device)
            res["decode_ms_per_token"] = \
                (time.monotonic() - t0) * 1e3 / (gen - 1)
        res["decode_launches"] = read_counts()
        res["all_reduces_decode_step"] = ar.calls / (gen - 1)
        res["all_reduce_host_ms_per_step"] = ar.ms / (gen - 1)
        res["decode_collectives"] = ar.by
        cont = torch.cat(toks, dim=1).cpu().numpy()
        res["restored_decode_equal"] = bool(np.array_equal(cont, out[:, 1:]))
        res["logits"] = [x.float().cpu() for x in steps]
        del steps, logits, restored
        res["max_memory_allocated"] = _card_mem(device)
        del engine
        gc.collect()
        _card_reset_peak(device)
        dist.barrier()
        if rank == 0:
            # one process on the card: f32, then bf16 (the draw cast leaf
            # by leaf), both fed the split run's tokens; the bf16 engine
            # restores the committed cache whole and decodes from it
            full = init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device=device)
            f32 = ServeEngine(dataclasses.replace(cfg, dtype="float32"),
                              full, max_len=max_len, device=device)
            res["one_f32_routes"] = []
            with replaying_routes(routes, res["one_f32_routes"]):
                res["one_f32_logits"], _ = _greedy_run(f32, batch, gen - 1,
                                                       feed=out)
            del f32
            cast_leaves_(full, torch.bfloat16)
            one = ServeEngine(cfg, full, max_len=max_len, device=device)
            del full
            t0 = time.monotonic()
            whole = one.restore_serving_state(client, batch_size)
            _sync(device)
            res["whole_restore_s"] = time.monotonic() - t0
            res["whole"] = {n: t.to("cpu", copy=True)
                            for n, t in _named(whole)}
            res["whole_decode"] = one.decode_greedy(whole, out[:, :1],
                                                    gen - 1)
            del whole
            res["one_routes"] = []
            with replaying_routes(routes, res["one_routes"]):
                res["one_logits"], _ = _greedy_run(one, batch, gen - 1,
                                                   feed=out)
            del one
            client.finalize()
        gc.collect()
        _card_reset_peak(device)
        dist.barrier()
    finally:
        if cluster is not None:
            cluster.close()
    return res


def fsdp_cut_rank(cfg, mesh, device) -> dict:
    """Phase 11b on one rank of a ("data", "model") mesh: ``cfg``'s f32
    cut (FSDP_CUT) at full width, drawn whole from the seed FSDP_DRAWS
    ranks at a time (each keeping its boxes), served split (``CUT_STEPS_FSDP`` greedy
    steps after a prefill of the rank's rows), then its loss and gradient
    boxes over the rank's rows of FSDP_CUT's batch (``_grads``: the
    "data"-split leaves' gradients reduce-scattered by their gathers, the
    rest all-reduced), the collectives counted by group."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import (init_params, map_axes, param_axes,
                                    param_specs, param_split)
    from repro_torch.models.params import local_box, shard_params
    from repro_torch.serve import ServeEngine, serve_max_len
    from repro_torch.sharding import NamedSharding, get_rules, tp, use_rules
    from repro_torch.train.step import _grads

    cut = FSDP_CUT
    small = cut_config(cfg, cut["layers"])
    rules = get_rules(small.rules)
    requests, batch = _cut_inputs(small, cut, device)
    rank = dist.get_rank()
    res = {"coord": (mesh.get_local_rank("data"),
                     mesh.get_local_rank("model"))}
    for first in range(0, dist.get_world_size(), FSDP_DRAWS):
        if first <= rank < first + FSDP_DRAWS:
            params = init_params(small, torch.Generator(device=device)
                                 .manual_seed(0), device=device)
            axes = param_axes(small)
            res["boxes"] = dict(_named(map_axes(
                lambda ax, s, t: torch.tensor(
                    [(sl.start, sl.stop) for sl in local_box(
                        NamedSharding(mesh, s), t.shape)]).reshape(-1, 2),
                axes, param_specs(axes, rules, mesh, params), params)))
            eng = ServeEngine(small, params, max_len=serve_max_len(
                small, cut["prompt"], CUT_STEPS_FSDP), device=device,
                mesh=mesh)
            shards = shard_params(params, small, mesh)
            del params
            gc.collect()
            _card_reset_peak(device)
        dist.barrier()
    groups = _mesh_groups(mesh)
    reset_counts()
    with CountedAllReduce(groups=groups) as ar:
        t0 = time.monotonic()
        res["plain_cut_logits"], res["plain_cut_tokens"] = _greedy_run(
            eng, requests, CUT_STEPS_FSDP)
        _sync(device)
        res["serve_s"] = time.monotonic() - t0
    res["plain_cut_serve_launches"] = read_counts()
    res["serve_collectives"] = ar.by
    del eng
    gc.collect()
    rows = tp.data_rows(batch["tokens"].shape[0], mesh)
    mine = {k: v[rows] for k, v in batch.items()}
    reset_counts()
    with use_rules(mesh, rules), CountedAllReduce(groups=groups) as ar:
        t0 = time.monotonic()
        loss, _, grads = _grads(small, shards, mine,
                                   mesh.get_group("data"),
                                   param_split(small, mesh, rules))
        _sync(device)
        res["grad_s"] = time.monotonic() - t0
    res["grad_collectives"] = ar.by
    res["plain_cut_launches"] = read_counts()
    res["plain_cut_loss"] = float(loss)
    res["plain_cut_grads"] = {n: g.cpu() for n, g in _named(grads)}
    res["max_memory_allocated"] = _card_mem(device)
    return res


def _fsdp_gathers(cfg, mesh_shape) -> int:
    """The leaves one forward of ``cfg`` gathers over "data" on a
    ("data", "model") mesh of ``mesh_shape``: each layer's split leaves
    and the embedding's, the final norm's and the LM head's."""
    import types

    from repro_torch.models import param_split
    from repro_torch.models.params import tree_paths

    split = param_split(cfg, types.SimpleNamespace(
        shape=dict(zip(("data", "model"), mesh_shape))))
    return sum((cfg.num_layers if path[0] == "stack" else 1)
               for path, axes in tree_paths(split) if "data" in axes)


def _route_flips(split, one, one_f32) -> dict:
    """The split run's routers (``recording_routes``: probabilities and
    expert ids a call) against one process's on the same inputs and
    routes in bf16 (``one``) and f32 (``one_f32``; ``replaying_routes``'
    own), and the checks on them.  A token's margin is the largest
    probability by which one process ranks an expert above another that
    the split ranked first (among its k, or into its k over an expert
    left out); the split can reverse such a pair only where its
    probabilities moved by at least half the margin.  So the split's
    probabilities must lie within MOE_TP_BF16_BOUND times bf16's own
    distance from f32 (max abs, as the logits' bound), every margin
    within twice that, and the tokens it routes otherwise than one
    process within MOE_TP_BF16_BOUND times those bf16 routes otherwise
    than f32: a split that routes to other experts than its own
    probabilities choose, or whose router reads another input, fails."""
    import torch

    if not len(split) == len(one) == len(one_f32):
        raise AssertionError(f"{len(split)} router calls split, {len(one)} "
                             f"and {len(one_f32)} in one process")
    n = flipped = bf16_flipped = 0
    split_err = bf16_err = margin = 0.0
    for (ps, g), (p, w), (pf, wf) in zip(split, one, one_f32):
        n += int(w[..., 0].numel())
        flipped += int((g != w).any(-1).sum())
        bf16_flipped += int((wf != w).any(-1).sum())
        split_err = max(split_err, float((ps - p).abs().max()))
        bf16_err = max(bf16_err, float((p - pf).abs().max()))
        pg = p.gather(-1, g)                              # (B, T, k)
        inside = (pg.unsqueeze(-2) - pg.unsqueeze(-1)).triu(1)
        left = p.scatter(-1, g, float("-inf")).max(-1).values
        margin = max(margin, float(inside.amax((-2, -1)).max()),
                     float((left - pg.min(-1).values).max()))
    out = {"tokens_routed": n, "flipped_tokens": flipped,
           "flipped_tokens_bf16_vs_f32": bf16_flipped,
           "router_err_split_vs_one": split_err,
           "router_err_bf16_vs_f32": bf16_err,
           "router_err_bound": MOE_TP_BF16_BOUND * bf16_err,
           "largest_margin_reversed": margin,
           "margin_bound": 2 * MOE_TP_BF16_BOUND * bf16_err}
    if not split_err <= out["router_err_bound"]:
        raise AssertionError(f"split router probabilities {split_err} from "
                             f"one process's, beyond {MOE_TP_BF16_BOUND} x "
                             f"bf16's own {bf16_err}: {out}")
    if not flipped <= MOE_TP_BF16_BOUND * bf16_flipped:
        raise AssertionError(f"{flipped} tokens routed otherwise split than "
                             f"in one process, beyond {MOE_TP_BF16_BOUND} x "
                             f"bf16's own {bf16_flipped}: {out}")
    if not margin <= out["margin_bound"]:
        raise AssertionError(f"the split reversed one process's ranking of "
                             f"two experts {margin} apart, beyond "
                             f"{out['margin_bound']}: {out}")
    return out


def _mesh_whole(parts, data):
    """Each step's logits of every rank (rank order on a (``data``,
    model) mesh) joined whole: the model ranks' vocab columns, then the
    data ranks' rows."""
    import torch

    model = len(parts) // data
    return [torch.cat([torch.cat(step[d * model:(d + 1) * model], dim=-1)
                       for d in range(data)], dim=0)
            for step in zip(*parts)]


def _check_moe_tp(arch, cfg, sv, sz, card, world_s, on_card) -> dict:
    """Phase 11a's checks of one model from its ranks' results, and its
    line: the ranks' tokens equal, the restored cache equal to a second
    prefill and decoding to the live tokens, the whole cache restored on
    rank 0 equal to every rank's box, one committed part a distinct box,
    the all-reduces counted (two a layer: the attention's output and the
    experts' gather; the embedding's; the argmax's two), K4 once a layer
    in prefill and never in decode on the card, the split bf16 logits
    within MOE_TP_BF16_BOUND times the one-process bf16 logits' own
    distance from the f32 ones."""
    gen, batch_size = sz["gen"], sz["batch"]
    per_step = 2 * cfg.num_layers + 3
    counts = _check_rnn_tp(cfg, sv, gen, per_step=per_step)
    if on_card:
        n = cfg.num_layers
        for key, want in (("launches", {"flash_fwd": n}),
                          ("prefill_launches", {"flash_fwd": n}),
                          ("decode_launches", {"flash_fwd": 0})):
            _check_launches(sv[0][key], want, f"{arch} split {key}")
    split = _vocab_whole([s["logits"] for s in sv])
    vocab = cfg.vocab_size
    one, one_f32 = sv[0]["one_logits"], sv[0]["one_f32_logits"]
    # a token routed to other experts (a near tie that the rounding of
    # the split products tips) changes its sequence's logits from then on
    # by more than rounding: the one-process runs take the split run's
    # routes, and the routers are held to theirs (``_route_flips``)
    flips = _route_flips(sv[0]["routes"], sv[0]["one_routes"],
                         sv[0]["one_f32_routes"])

    def rel(xs, ys):
        return max(_rel(a[:, :vocab], b[:, :vocab]) for a, b in zip(xs, ys))
    tp_rel, bf16_rel = rel(split, one), rel(one, one_f32)
    if not tp_rel <= MOE_TP_BF16_BOUND * bf16_rel:
        raise AssertionError(f"{arch} split bf16 logits {tp_rel} of their "
                             f"max from one process's, beyond "
                             f"{MOE_TP_BF16_BOUND} x bf16's own {bf16_rel}"
                             f" (route flips {flips})")
    s0 = sv[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    from repro_torch.models.moe import capacity

    cap = capacity(sz["prompt"], e, k, cfg.capacity_factor)
    ye_bytes = batch_size * e * cap * cfg.d_model * 2
    gathered = s0["prefill_collectives"]["model"]["largest_bytes"]
    if gathered != ye_bytes:
        raise AssertionError(f"{arch}: the largest all-reduce of a split "
                             f"prefill moved {gathered} bytes, the experts' "
                             f"gather {ye_bytes}")
    return {
        "card": card, "arch": cfg.name, "layers": cfg.num_layers,
        "rules": cfg.rules, "ranks": len(sv), "mesh": [1, len(sv)],
        "local_experts": e // len(sv),
        "local_heads": [cfg.num_heads // len(sv),
                        cfg.num_kv_heads // len(sv)],
        "batch": batch_size, "prompt": sz["prompt"], "gen": gen,
        "prefill_ms": s0["prefill_ms"],
        "decode_ms_per_token": s0["decode_ms_per_token"],
        "output_tokens_per_s": batch_size * gen / s0["generate_s"],
        "generate_wall_s": s0["generate_s"],
        "all_reduces_generate": s0["all_reduces_generate"],
        "all_reduces_prefill": s0["all_reduces_prefill"],
        "all_reduces_decode_step": s0["all_reduces_decode_step"],
        "all_reduce_host_ms_prefill": s0["all_reduce_host_ms_prefill"],
        "all_reduce_share_prefill": s0["all_reduce_host_ms_prefill"]
        / s0["prefill_ms"],
        "all_reduce_host_ms_per_step": s0["all_reduce_host_ms_per_step"],
        "all_reduce_share": s0["all_reduce_host_ms_per_step"]
        / s0["decode_ms_per_token"],
        "prefill_collectives": s0["prefill_collectives"],
        "decode_collectives": s0["decode_collectives"],
        "ye_gather_bytes_per_layer_prefill": ye_bytes,
        "ye_slots": [batch_size, e, cap],
        "commit_wait_s": s0["commit_wait_s"],
        "restore_wall_s": s0["restore_s"],
        "whole_restore_wall_s": s0["whole_restore_s"],
        "parts": s0["parts"], "committed_bytes": s0["committed_bytes"],
        "cache_bytes_per_rank": [s["cache_bytes"] for s in sv],
        "weights_bytes_per_rank": [s["weights_bytes"] for s in sv],
        "max_memory_allocated_per_rank": [s["max_memory_allocated"]
                                          for s in sv],
        "launches": s0["launches"], "prefill_launches": s0["prefill_launches"],
        "decode_launches": s0["decode_launches"],
        "logits_rel_err_vs_one_process_bf16": tp_rel,
        "bf16_rel_err_vs_f32": bf16_rel,
        "logits_rel_err_vs_one_process_f32": rel(split, one_f32),
        "logits_bound": MOE_TP_BF16_BOUND * bf16_rel,
        "route_flips_vs_one_process": flips,
        "greedy_equal_to_one_process": sum(
            int((a.argmax(-1) == b.argmax(-1)).sum())
            for a, b in zip(split, one)),
        "greedy_tokens": batch_size * gen,
        "whole_decode_equal_tokens": int(
            (s0["whole_decode"] == s0["tokens"][:, 1:]).sum()),
        "draw_s": s0["draw_s"], "rank_phase_s": s0["phase_s"],
        "world_wall_s": world_s, **counts,
        "reduced": {"num_layers": f"{tp_config(arch).num_layers} -> "
                    f"{cfg.num_layers}, as phases 4g and 4h are",
                    "ranks": f"{len(sv)} processes on one card over gloo "
                    f"(NCCL takes one card a rank): every all-reduce is "
                    f"staged through the host"}}


def moe_phase(device, card, rehearse=False) -> dict:
    """Phase 11.  11a: ``tp_world_main``'s "moe" part on TP_MODEL
    processes (a 1 x TP_MODEL mesh) and its checks (``_check_moe_tp``).
    11b: its "fsdp" part on FSDP_MESH's processes, while a thread of this
    process runs the plain CPU path of the f32 cut (drawn on ``device``
    first, as the ranks draw it); every rank's tokens, logits, loss and
    gradient boxes against it, and the "data" axis's gathers counted.
    ``rehearse``: all of it on the CPU with the tiny configs.  Returns
    the ``serve_tp_moe`` and ``fsdp_qwen3_moe`` lines."""
    import threading

    import numpy as np
    import torch

    from repro_torch.models import init_params

    sz = _moe_sizes(rehearse)
    gc.collect()
    _card_reset_peak(device)
    t0 = time.monotonic()
    ranks = spawn_tp_world(("moe",), TP_MODEL, rehearse)
    world_s = time.monotonic() - t0
    log(f"  11a: the ranks done in {world_s:.1f} s; host "
        f"{json.dumps(host_rss())}")
    serve = {arch: _check_moe_tp(arch, moe_tp_config(arch, rehearse),
                                 [r[arch] for r in ranks], sz, card,
                                 world_s, device.type == "cuda")
             for arch in MOE_TP_ARCHS}
    del ranks

    # 11b: the f32 cut on FSDP_MESH against the plain CPU path
    arch = FSDP_ARCH
    cfg = moe_tp_config(arch, rehearse)
    small = cut_config(cfg, FSDP_CUT["layers"])
    # the thread takes the parameters, so they go once it has run
    refs, failed = {"params": _map(lambda t: t.cpu(), init_params(
        small, torch.Generator(device=device).manual_seed(0),
        device=device))}, []
    gc.collect()
    _card_reset_peak(device)
    host_start = host_rss()

    def plain_ref():
        try:
            refs[arch] = _plain_reference(arch, small, refs.pop("params"),
                                          FSDP_CUT, CUT_STEPS_FSDP)
        except BaseException as e:          # re-raised below
            failed.append(e)

    def grad_err(r, res):
        """Rank ``r``'s result with its gradient boxes held to the plain
        path's (its worst leaf) in place of the boxes, so the ranks'
        results are not all held at once."""
        thread.join()
        cpu_s.append(time.monotonic() - t0)
        if failed:
            raise failed[0]
        s = res["fsdp"]
        worst, leaf = 0.0, None
        for name, g in s.pop("plain_cut_grads").items():
            w = refs[arch]["grads"][name][tuple(
                slice(a, b) for a, b in s["boxes"][name].tolist())]
            e = (g - w).abs().max().item() / max(
                refs[arch]["grad_max"][name], 1e-30)
            if e > worst:
                worst, leaf = e, name
        s["grad_worst"] = (worst, leaf)
        return s
    t0, cpu_s = time.monotonic(), []
    thread = threading.Thread(target=plain_ref)
    thread.start()
    try:
        world = FSDP_MESH[0] * FSDP_MESH[1]
        fr = spawn_tp_world(("fsdp",), world, rehearse, each=grad_err)
        children_s = time.monotonic() - t0
    finally:
        thread.join()
    ref = refs[arch]
    toks = np.concatenate([fr[d * FSDP_MESH[1]]["plain_cut_tokens"]
                           for d in range(FSDP_MESH[0])])
    for r, s in enumerate(fr):
        d = s["coord"][0]
        if not np.array_equal(s["plain_cut_tokens"],
                              fr[d * FSDP_MESH[1]]["plain_cut_tokens"]):
            raise AssertionError(f"fsdp rank {r}'s tokens differ from its "
                                 f"data row's")
    got = _mesh_whole([s["plain_cut_logits"] for s in fr], FSDP_MESH[0])
    err = max((g - w).abs().max().item() for g, w in zip(got, ref["logits"]))
    if not (np.array_equal(toks, ref["tokens"]) and err <= TP_PLAIN_ATOL):
        raise AssertionError(f"{arch} f32 cut on {FSDP_MESH}: tokens {toks} "
                             f"against the CPU's {ref['tokens']}, logits max "
                             f"abs err {err} (atol {TP_PLAIN_ATOL})")
    worst, worst_leaf = max((s["grad_worst"] for s in fr), key=lambda w: w[0])
    loss_err = max(abs(s["plain_cut_loss"] - ref["loss"]) / abs(ref["loss"])
                   for s in fr)
    if not (loss_err <= LOSS_RTOL and worst <= FSDP_CUT["grad_tol"]):
        raise AssertionError(f"{arch} f32 cut on {FSDP_MESH}: worst leaf "
                             f"{worst_leaf} {worst} of its largest (at most "
                             f"{FSDP_CUT['grad_tol']}), loss rel err "
                             f"{loss_err} (rtol {LOSS_RTOL})")
    # one forward gathers every "data"-split leaf once, one broadcast a
    # data rank: the serving run is a prefill and CUT_STEPS_FSDP steps
    per_fwd = _fsdp_gathers(small, FSDP_MESH)
    data = fr[0]["serve_collectives"]["data"]
    if (data["broadcasts"], data["calls"]) != (
            per_fwd * FSDP_MESH[0] * (CUT_STEPS_FSDP + 1), 0):
        raise AssertionError(f"{arch}: 'data' collectives serving the cut "
                             f"{data}, want {per_fwd} gathers a forward of "
                             f"{FSDP_MESH[0]} broadcasts each")
    fsdp = {
        "card": card, "arch": small.name, "rules": small.rules,
        "mesh": list(FSDP_MESH), "layers": FSDP_CUT["layers"],
        "serve_batch": FSDP_CUT["serve_batch"], "prompt": FSDP_CUT["prompt"],
        "decode_steps": CUT_STEPS_FSDP, "grad_batch": FSDP_CUT["grad_batch"],
        "grad_seq": FSDP_CUT["grad_seq"],
        "plain_cut_max_abs_err": err,
        "plain_cut_grads": {"worst_leaf": worst_leaf,
                            "worst_leaf_err_of_max": worst,
                            "loss_rel_err": loss_err},
        "data_gathers_per_forward": per_fwd,
        "serve_collectives": fr[0]["serve_collectives"],
        "grad_collectives": fr[0]["grad_collectives"],
        "serve_s": fr[0]["serve_s"], "grad_s": fr[0]["grad_s"],
        "plain_cut_serve_launches": fr[0]["plain_cut_serve_launches"],
        "plain_cut_launches": fr[0]["plain_cut_launches"],
        "max_memory_allocated_per_rank": [s["max_memory_allocated"]
                                          for s in fr],
        "rank_phase_s": fr[0]["phase_s"], "children_wall_s": children_s,
        "cpu_path_s": cpu_s[0], "host_rss_at_start": host_start,
        "host_rss_at_end": host_rss(),
        "reduced": {"num_layers": f"{tp_config(arch).num_layers} -> "
                    f"{FSDP_CUT['layers']} in f32, as phase 5d: four ranks "
                    f"on one card",
                    "ranks": f"{world} processes on one card over gloo"}}
    return {"serve_tp_moe": serve, "fsdp_qwen3_moe": fsdp}


def local_kernel_numbers(device) -> dict:
    """K6, K7 and K4 at the rank's local shapes of phase 10's two-way
    split, each against its plain version (max abs error) and timed
    beside its bound: K6's chunked kernel at rwkv6-7b's prefill and its
    sequential one at its decode step, K7's TMA kernel at
    recurrentgemma-9b's prefill and its register one at its decode step,
    K4 at the hybrid's attention (8 query heads over the gathered kv
    head, D 256, window 2048)."""
    import torch

    from repro_torch.kernels.rglru import rglru_chunked
    from repro_torch.kernels.rglru.kernel import rglru_cuda, rglru_sm90_cuda
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda, rwkv6_sm90_cuda

    out = {}
    for name, run, case in (
            ("rwkv6_sm90", rwkv6_sm90_cuda, TP10_SHAPES["rwkv6_prefill"]),
            ("rwkv6", rwkv6_cuda, TP10_SHAPES["rwkv6_decode"])):
        inputs = _rwkv_inputs(3, case, "bfloat16", device)
        err = _rwkv_err(run(*inputs), rwkv6_chunked(*inputs), "bfloat16",
                        f"{name} {case} bfloat16")
        out[name] = {**rwkv6_numbers(case, device, name),
                     "max_abs_err": err, "shape": list(case)}
    for name, run, case in (
            ("rglru_sm90", rglru_sm90_cuda, TP10_SHAPES["rglru_prefill"]),
            ("rglru", rglru_cuda, TP10_SHAPES["rglru_decode"])):
        la, g, h0 = _rglru_inputs(3, case, "bfloat16", device)
        err = _rglru_err(run(la, g, h0), rglru_chunked(la, g, h0),
                         "bfloat16", f"{name} {case} bfloat16")
        out[name] = {**rglru_numbers(case, device, name),
                     "max_abs_err": err, "shape": list(case)}
    case = TP10_SHAPES["flash_d256"]
    err = check_attention_case(case, "bfloat16", device)
    out["flash_fwd_d256"] = {**attention_numbers(case, device),
                             "max_abs_err": err, "shape": list(case)}
    torch.cuda.synchronize()
    for name, v in out.items():
        log(f"  {name} {tuple(v['shape'])} bfloat16 (a rank's of the "
            f"two-way split): max abs err {v['max_abs_err']:.3e}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    # the port, and the bf16 flash-attention checks shared with its tests
    sys.path[:0] = [str(SRC), str(ROOT / "tests")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru.ops import route_bwd
    from repro_torch.models import count_params

    cfg = get_config("yi-6b")
    rcfg = get_config("rwkv6-7b")
    gcfg = get_config("recurrentgemma-9b")
    dcfg = get_config("deepseek-7b")
    pcfg = get_config("phi3-medium-14b")
    bcfg = get_config("dbrx-132b")
    qcfg = get_config("qwen3-moe-235b-a22b")
    scfg = get_config("seamless-m4t-medium")
    xcfg = get_config("pixtral-12b")
    tcfg = get_config("qwen2.5-3b")
    rh = rcfg.d_model // rcfg.rwkv_head_dim
    rwkv_cases = {"prefill": (BATCH, rh, PROMPT, rcfg.rwkv_head_dim),
                  "decode": (BATCH, rh, 1, rcfg.rwkv_head_dim)}
    rglru_cases = {"prefill": (BATCH, PROMPT, gcfg.resolved_rnn_width),
                   "ring": (1, RING_PROMPT, gcfg.resolved_rnn_width),
                   "decode": (BATCH, 1, gcfg.resolved_rnn_width)}
    path_case = serve_case(cfg)
    d256_case = (BATCH, gcfg.num_heads, gcfg.num_kv_heads, PROMPT, PROMPT,
                 gcfg.resolved_head_dim, True, gcfg.window)
    train_case = (1, tcfg.num_heads, tcfg.num_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
                  tcfg.resolved_head_dim, True, tcfg.window)
    # qwen3-moe-235b-a22b's training shape (phase 5d): GQA 16:1 at D 64
    moe_train_case = (1, qcfg.num_heads, qcfg.num_kv_heads, TRAIN_SEQ,
                      TRAIN_SEQ, qcfg.resolved_head_dim, True, qcfg.window)
    # the recurrent training phases' shapes: K6 and K7 at one 4096-token
    # sequence, K4 at head dim 256 under the window of 2048
    rwkv_train_case = (1, rh, TRAIN_SEQ, rcfg.rwkv_head_dim)
    rglru_train_case = (1, TRAIN_SEQ, gcfg.resolved_rnn_width)
    d256_train_case = (1, gcfg.num_heads, gcfg.num_kv_heads, TRAIN_SEQ,
                       TRAIN_SEQ, gcfg.resolved_head_dim, True, gcfg.window)
    # seamless-m4t-medium's K4 calls: the encoder's and the decoder's
    # cross-attention non-causal (T = S = 512 served: one shape), the
    # decoder's self-attention causal; in training the cross-attention
    # takes TRAIN_SEQ queries over the 512 frames
    seamless_self = serve_case(scfg)
    seamless_cross = seamless_self[:6] + (False, None)
    seamless_cross_train = (1, scfg.num_heads, scfg.num_kv_heads, TRAIN_SEQ,
                            scfg.num_frames, scfg.resolved_head_dim, False,
                            None)
    # pixtral-12b's prefill: 256 patches before the 512 prompt tokens
    pix_case = (BATCH, xcfg.num_heads, xcfg.num_kv_heads,
                xcfg.num_patches + PROMPT, xcfg.num_patches + PROMPT,
                xcfg.resolved_head_dim, True, xcfg.window)
    # pixtral-12b's training shape (phase 5f): 256 patches before 4096 tokens
    pix_train_case = (1, xcfg.num_heads, xcfg.num_kv_heads,
                      xcfg.num_patches + TRAIN_SEQ,
                      xcfg.num_patches + TRAIN_SEQ, xcfg.resolved_head_dim,
                      True, xcfg.window)
    # the serving phases' configs at SERVE_LAYERS, and their lines'
    # ``reduced`` entries (phase 4's yi-6b keeps its full depth)
    (rcfg_s, rw_red), (gcfg_s, rg_red), (dcfg_s, ds_red), \
        (pcfg_s, ph_red), (xcfg_s, px_red) = (
            serve_cut(c) for c in (rcfg, gcfg, dcfg, pcfg, xcfg))
    # the training path's largest leaf: phase 5's stacked w_gu
    w_gu = TRAIN_LAYERS * 2 * tcfg.d_model * tcfg.d_ff
    t_start = time.monotonic()
    # each phase's wall seconds, from the end of the one before
    walls, last = {}, [t_start]

    def done(phase):
        now = time.monotonic()
        walls[phase] = now - last[0]
        last[0] = now
        return now - t_start

    log("phase 2: build")
    build_kernels()
    torch.cuda.synchronize()
    log(f"  phase 2 done at {done('2'):.1f} s")

    log("phase 3: kernels against their plain versions")
    path_err = check_kernels(path_case, device)
    train_err = check_attention_case(train_case, "bfloat16", device)
    log(f"  flash_fwd {train_case} bfloat16: max abs err {train_err:.3e}")
    # the bf16 forward at the two dense serving paths' shapes of phases
    # 4e and 4f (MHA 32/32, GQA 40/10)
    # and at the MoE serving paths' of phases 4g and 4h (GQA 48/8 at D
    # 128, 16:1 at D 64)
    dense_errs = {}
    for name, c in (("deepseek", dcfg), ("phi3", pcfg), ("dbrx", bcfg),
                    ("qwen3_moe", qcfg), ("seamless", scfg)):
        dense_errs[name] = check_attention_case(serve_case(c), "bfloat16",
                                                device)
        log(f"  flash_fwd {serve_case(c)} bfloat16: max abs err "
            f"{dense_errs[name]:.3e}")
    d256_err = check_kernels(d256_case, device, D256_SWEEP)
    check_empty_rows(device)
    bwd_err = check_bwd(train_case, device)
    # K4 forward and backward at the MoE training path's shape (phase 5d)
    moe_fwd_err = check_attention_case(moe_train_case, "bfloat16", device)
    log(f"  flash_fwd {moe_train_case} bfloat16: max abs err "
        f"{moe_fwd_err:.3e}")
    moe_bwd_err = check_bwd_case(moe_train_case, "bfloat16", device,
                                 determinism=True)
    log(f"  flash_bwd {moe_train_case} bfloat16: max abs err "
        f"{moe_bwd_err:.3e}; two runs bit-equal")
    torch.cuda.empty_cache()
    codec_bad = check_codec(CODEC_NS + [w_gu], device)
    rwkv_errs = check_rwkv6(rwkv_cases, device)
    rglru_errs = check_rglru(rglru_cases, device)
    rwkv_bwd_err = check_rwkv6_bwd(rwkv_train_case, device)
    rglru_bwd_errs = check_rglru_bwd(rglru_train_case, device)
    # K4's backward at head dim 256, the f32 FMA and the bf16 wgmma
    # libraries (the training path runs bf16)
    d256_bwd_err = check_bwd(d256_train_case, device, D256_BWD_SWEEP)
    log(json.dumps({"backward_split": backward_split(
        rwkv_train_case, d256_train_case, device)}))
    # K4's forward at head dim 160 (pixtral-12b), f32 on FMAs and bf16 on
    # wgmma, over the sm90 cases and the serving shape
    d160_err = check_kernels(pix_case, device, D160_SWEEP)
    # and its backward, f32 on FMAs and bf16 on wgmma, over the card
    # tests' cases and pixtral's training shape
    d160_bwd_err = check_bwd(pix_train_case, device, D160_BWD_SWEEP)
    # the encoder-decoder's non-causal calls: the served encoder and cross
    # shape (T = S), and the training cross-attention (T 4096 over S 512),
    # forward in both dtypes and backward in bf16, two runs bit-equal
    cross_errs = {}
    for case in (seamless_cross, seamless_cross_train):
        for dtype in ("float32", "bfloat16"):
            err = check_attention_case(case, dtype, device)
            log(f"  flash_fwd {case} {dtype}: max abs err {err:.3e}")
        cross_errs[case] = (err, check_bwd_case(case, "bfloat16", device,
                                                determinism=True))
        log(f"  flash_bwd {case} bfloat16: max abs err "
            f"{cross_errs[case][1]:.3e}; two runs bit-equal")
    # K4 at a rank's local heads of the "model" axis's two-way split
    # (phase 9): yi-6b's prefill, qwen2.5-3b's training shape
    tp_serve_case = tp_case(cfg, BATCH, PROMPT)
    tp_train_case = tp_case(tcfg, 1, TRAIN_SEQ)
    tp_errs = {}
    for case in (tp_serve_case, tp_train_case):
        tp_errs[case] = check_attention_case(case, "bfloat16", device)
        log(f"  flash_fwd {case} bfloat16: max abs err {tp_errs[case]:.3e}")
    tp_bwd_err = check_bwd_case(tp_train_case, "bfloat16", device,
                                determinism=True)
    log(f"  flash_bwd {tp_train_case} bfloat16: max abs err "
        f"{tp_bwd_err:.3e}; two runs bit-equal")
    # and of the MoE models' two-way split (phase 11a): dbrx-132b's 24 of
    # 48 query heads over 4 of 8 kv heads at D 128, qwen3-moe's 32 of 64
    # over 2 of 4 at D 64
    moe_tp_cases = {"dbrx": tp_case(bcfg, BATCH, PROMPT),
                    "qwen3_moe": tp_case(qcfg, BATCH, PROMPT)}
    for case in moe_tp_cases.values():
        tp_errs[case] = check_attention_case(case, "bfloat16", device)
        log(f"  flash_fwd {case} bfloat16: max abs err {tp_errs[case]:.3e}")
    # K4 at a rank's shape of phase 8b's split prefill: its 4 of
    # qwen2.5-3b's 16 query heads over the one kv head they read, the
    # whole 32,768-token prompt of each of a data rank's 2 sequences
    kv_seq_case = kv_seq_k4_case(tcfg)
    tp_errs[kv_seq_case] = check_attention_case(
        kv_seq_case, "bfloat16", device, rows=KV_SEQ_REF_ROWS)
    log(f"  flash_fwd {kv_seq_case} bfloat16: max abs err "
        f"{tp_errs[kv_seq_case]:.3e}")
    torch.cuda.empty_cache()
    # K6, K7 and K4 at a rank's shapes of the recurrent models' two-way
    # split (phase 10), checked and timed
    tp10 = local_kernel_numbers(device)
    log(json.dumps({"tp10_kernels": tp10}))
    torch.cuda.empty_cache()
    log(f"  phase 3 done at {done('3'):.1f} s")

    log(f"phase 4: serving, {cfg.name} {cfg.num_layers} layers d_model "
        f"{cfg.d_model} {cfg.dtype}, {BATCH} x {PROMPT} prompt tokens, "
        f"{GEN} new tokens")
    runs, num = serve_model_phase(
        cfg, device, card, "serve", 6_061_035_520, dense_want(cfg),
        numbers=lambda: {"flash_fwd_serve_shape": attention_numbers(
            path_case, device)})
    yi_launches = runs["serve"]["launches"]
    num = num["flash_fwd_serve_shape"]
    del runs
    log(f"  phase 4 done at {done('4'):.1f} s; weights "
        f"freed, {torch.cuda.memory_allocated()} bytes allocated")

    log(f"phase 4b: serving, {rcfg.name} cut to {rcfg_s.num_layers} of "
        f"{rcfg.num_layers} layers d_model {rcfg.d_model} {rcfg.dtype}, "
        f"{BATCH} x {PROMPT} prompt tokens, {GEN} new tokens")
    n = rcfg_s.num_layers
    runs, rw_num = serve_model_phase(
        rcfg_s, device, card, "serve_rwkv6", 1_413_697_536,
        # prefill through the chunked kernel, each one-token decode step
        # through the sequential one
        lambda gen: {"generate": {"rwkv6_sm90": n, "rwkv6": n * (gen - 1),
                                  "flash_fwd": 0},
                     "prefill": {"rwkv6_sm90": n, "rwkv6": 0},
                     "decode": {"rwkv6": n * (gen - 1), "rwkv6_sm90": 0}},
        state_bytes=17_039_364, reduced=rw_red,
        numbers=lambda: {
            **{f"{kernel}_{name}_shape": rwkv6_numbers(
                (BATCH, rh, t, rcfg.rwkv_head_dim), device, kernel)
               for kernel, name, t in (
                   ("rwkv6_sm90", "prefill", PROMPT),
                   ("rwkv6", "prefill", PROMPT),   # the sequential yardstick
                   ("rwkv6", "decode", 1))},
            "rwkv6_route_ms": rwkv6_route_ms(
                (BATCH, rh, 1, rcfg.rwkv_head_dim), device)})
    rw_launches = runs["serve"]["launches"]
    rw_payload = runs["serve"].pop("state_payload")
    del runs
    log(f"  phase 4b done at {done('4b'):.1f} s; weights "
        f"freed, {torch.cuda.memory_allocated()} bytes allocated")

    log("phase 4c: Reed-Solomon encode against the host codec")
    rs = check_rs(device, rw_payload)
    del rw_payload
    log(json.dumps({"rs_encode_state": rs["numbers"]}))
    log(f"  phase 4c done at {done('4c'):.1f} s")

    log(f"phase 4d: serving, {gcfg.name} cut to {gcfg_s.num_layers} of "
        f"{gcfg.num_layers} layers d_model "
        f"{gcfg.d_model} {gcfg.dtype}, {BATCH} x {PROMPT} prompt tokens, "
        f"{GEN} new tokens; then 1 x {RING_PROMPT}, {RING_GEN} new tokens")
    runs, rg_num = serve_recurrentgemma_phase(gcfg_s, device, card, rg_red)
    rg_launches = {name: r["launches"] for name, r in runs.items()}
    del runs
    log(f"  phase 4d done at {done('4d'):.1f} s; weights "
        f"freed, {torch.cuda.memory_allocated()} bytes allocated")

    log(f"phase 4e: serving, {dcfg.name} cut to {dcfg_s.num_layers} of "
        f"{dcfg.num_layers} layers d_model {dcfg.d_model} {dcfg.dtype}, "
        f"{BATCH} x {PROMPT} prompt tokens, {GEN} new tokens; then the same "
        f"with the int8 KV cache")
    runs, ds_num = serve_model_phase(
        dcfg_s, device, card, "serve_deepseek", 1_648_398_336,
        dense_want(dcfg_s), state_bytes=142_606_340, reduced=ds_red,
        subruns=[("int8", BATCH, PROMPT, GEN, 106_954_756,
                  dataclasses.replace(dcfg_s, kv_quant=True))],
        plain={"plain_cut": {},
               "plain_int8_cut": dict(kv_quant=True, steps=INT8_CUT_STEPS)},
        numbers=lambda: {"flash_fwd_serve_shape": attention_numbers(
            serve_case(dcfg), device)})
    ds_launches = {name: r["launches"] for name, r in runs.items()}
    del runs
    log(f"  phase 4e done at {done('4e'):.1f} s; weights "
        f"freed, {torch.cuda.memory_allocated()} bytes allocated")

    log(f"phase 4f: serving, {pcfg.name} cut to {pcfg_s.num_layers} of "
        f"{pcfg.num_layers} layers d_model {pcfg.d_model} {pcfg.dtype}, "
        f"{BATCH} x {PROMPT} prompt tokens, {GEN} new tokens")
    runs, ph_num = serve_model_phase(
        pcfg_s, device, card, "serve_phi3", 2_390_799_360,
        dense_want(pcfg_s), state_bytes=44_564_484, reduced=ph_red,
        numbers=lambda: {"flash_fwd_serve_shape": attention_numbers(
            serve_case(pcfg), device)})
    ph_launches = runs["serve"]["launches"]
    del runs
    log(f"  phase 4f done at {done('4f'):.1f} s; weights "
        f"freed, {torch.cuda.memory_allocated()} bytes allocated")

    moe_launches, moe_nums = {}, {}
    # the MoE phases take one profile window, over a prefill of 4g, to
    # keep the run within its time budget
    for phase, line, c, n_params, profile in (
            ("4g", "serve_dbrx", bcfg, 4_492_216_320, ("prefill",)),
            ("4h", "serve_qwen3_moe", qcfg, 3_697_815_552, ())):
        log(f"phase {phase}: serving, {c.name} cut to {MOE_SERVE_LAYERS} of "
            f"{c.num_layers} layers d_model {c.d_model}, {c.num_experts} "
            f"experts top-{c.experts_per_token}, {c.dtype}, {BATCH} x "
            f"{PROMPT} prompt tokens, {GEN} new tokens")
        moe_launches[line], moe_nums[line] = serve_moe_phase(
            c, device, card, line, n_params, profile)
        log(f"  phase {phase} done at {done(phase):.1f} s; "
            f"weights freed, {torch.cuda.memory_allocated()} bytes "
            f"allocated")

    log(f"phase 4i: serving, {scfg.name} {scfg.encoder_layers} + "
        f"{scfg.num_layers} layers d_model {scfg.d_model} {scfg.dtype}, "
        f"{BATCH} x {PROMPT} prompt tokens over {scfg.num_frames} frames, "
        f"{GEN} new tokens; then the same with the int8 KV cache")
    # K4 three times a layer in prefill (encoder, decoder self- and
    # cross-attention), never in decode
    n = scfg.encoder_layers + 2 * scfg.num_layers
    runs, sm_num = serve_model_phase(
        scfg, device, card, "serve_seamless", 978_909_184,
        lambda gen: {"generate": {"flash_fwd": n}, "prefill": {"flash_fwd": n},
                     "decode": {"flash_fwd": 0}},
        state_bytes=207_618_052,
        subruns=[("int8", BATCH, PROMPT, GEN, 155_713_540,
                  dataclasses.replace(scfg, kv_quant=True))],
        plain={"plain_cut": dict(layers=SEAMLESS_PLAIN_LAYERS),
               "plain_int8_cut": dict(layers=SEAMLESS_PLAIN_LAYERS,
                                      kv_quant=True, steps=INT8_CUT_STEPS)},
        numbers=lambda: {
            "flash_fwd_serve_shape": attention_numbers(seamless_self, device),
            "flash_fwd_noncausal_shape": attention_numbers(seamless_cross,
                                                           device)})
    sm_launches = {name: r["launches"] for name, r in runs.items()}
    del runs
    log(f"  phase 4i done at {done('4i'):.1f} s; weights "
        f"freed, {torch.cuda.memory_allocated()} bytes allocated")

    log(f"phase 4j: serving, {xcfg.name} cut to {xcfg_s.num_layers} of "
        f"{xcfg.num_layers} layers d_model "
        f"{xcfg.d_model} {xcfg.dtype}, {xcfg.num_heads} heads of "
        f"{xcfg.resolved_head_dim} over {xcfg.num_kv_heads} KV heads, "
        f"{BATCH} x ({xcfg.num_patches} patches + {PROMPT} prompt tokens), "
        f"{GEN} new tokens")
    runs, px_num = serve_model_phase(
        xcfg_s, device, card, "serve_pixtral", 2_511_385_600,
        dense_want(xcfg_s), state_bytes=65_536_004, reduced=px_red,
        numbers=lambda: {"flash_fwd_d160_serve_shape": attention_numbers(
            pix_case, device)})
    px_launches = runs["serve"]["launches"]
    del runs
    log(f"  phase 4j done at {done('4j'):.1f} s; weights "
        f"freed, {torch.cuda.memory_allocated()} bytes allocated")

    pcfg5 = dataclasses.replace(tcfg, num_layers=TRAIN_LAYERS)
    n_params = count_params(pcfg5)
    log(f"phase 5: training, {tcfg.name} cut to {TRAIN_LAYERS} of "
        f"{tcfg.num_layers} layers d_model {tcfg.d_model} {tcfg.dtype} "
        f"compute, {n_params} params, {TRAIN_SEQ} tokens a step, q8-delta "
        f"commit every {COMMIT_EVERY} steps")
    torch.cuda.reset_peak_memory_stats()
    tr = train_main_path(pcfg5, device, profile=True)
    frames = [(c["key_frames"], c["delta_frames"]) for c in tr["commits"]]
    ratios = [c["raw_bytes"] / c["encoded_bytes"] for c in tr["commits"]]
    if tr["launches"]["flash_fwd"] != 2 * TRAIN_LAYERS * TRAIN_STEPS or \
            tr["launches"]["flash_bwd_sm90"] != \
            TRAIN_LAYERS * TRAIN_STEPS or tr["launches"]["flash_bwd"]:
        raise AssertionError(f"training launches {tr['launches']}")
    if not (tr["launches"]["quantize"] and tr["launches"]["quantize_delta"]):
        raise AssertionError(f"commits did not run K1 and K2: "
                             f"{tr['launches']}")
    if not any(d for _, d in frames) or not frames[0][0] or \
            min(ratios) <= 3:
        raise AssertionError(f"commit frames {frames}, ratios {ratios}")
    step_ms = sorted(tr["step_ms"][1:])[len(tr["step_ms"][1:]) // 2]
    tokens_per_s = TRAIN_SEQ / (step_ms / 1e3)
    train = {
        "card": card, "params": n_params, "seq": TRAIN_SEQ, "batch": 1,
        "step_ms_median": step_ms, "step_ms": tr["step_ms"],
        "tokens_per_s": tokens_per_s,
        "mfu": 6 * n_params * TRAIN_SEQ / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        "init_s": tr["init_s"],
        "commit_wall_s": [c["wall_s"] for c in tr["commits"]],
        "commit_encode_s": [c["encode_s"] for c in tr["commits"]],
        "device_encode_ms": tr["encode_ms"],
        "wire_bytes": [c["encoded_bytes"] for c in tr["commits"]],
        "raw_bytes": [c["raw_bytes"] for c in tr["commits"]],
        "compression_ratio": ratios, "frames_key_delta": frames,
        "commit_bound_ratio": tr["commit_bound_ratio"],
        "restart_wall_s": tr["restart_s"],
        "losses": tr["losses"], "reference_losses": tr["reference_losses"],
        "restart_losses": tr["restart_losses"],
        "launches": tr["launches"],
        "launches_per_step": tr["launches_per_step"],
        "max_memory_allocated": tr["max_memory_allocated"],
        "host": host_rss(), "restart_host": tr["restart_rss"],
        "pre_restart_host": tr["pre_restart_rss"],
        "pfs_free_bytes": tr["pfs_free_bytes"],
        "reduced": {"num_layers": (
            f"{tcfg.num_layers} -> {TRAIN_LAYERS}: cut to keep the whole "
            f"run within its 1,200 s")},
    }
    log(card)
    log(json.dumps({"train": train}))
    log(json.dumps({"profile_train_step": tr["profile_step"]}))
    log(f"  phase 5 done at {done('5'):.1f} s; "
        f"{tr['allocated_after']} bytes still allocated")

    steps = TRAIN_REC_STEPS
    n = RWKV_TRAIN_LAYERS
    log(f"phase 5b: training, {rcfg.name} cut to {n} layers d_model "
        f"{rcfg.d_model}, {TRAIN_SEQ} tokens a step, {steps} steps, q8-delta "
        f"commit every {TRAIN_REC_COMMIT}")
    # each layer's forward kernel twice a step (full remat recomputes it in
    # the backward), its backward kernel once; a 4096-token bf16 call runs
    # the chunked forward and the chunked backward, never the sequential
    # ones
    rw_train, rw_cut = train_recurrent_phase(
        "train_rwkv6", dataclasses.replace(rcfg, num_layers=n), device, card,
        756_080_640,
        {"rwkv6_sm90": 2 * n * steps, "rwkv6_bwd_sm90": n * steps,
         "rwkv6_bwd": 0, "rwkv6": 0, "flash_fwd": 0, "flash_bwd": 0,
         "flash_bwd_sm90": 0},
        {"num_layers": f"{rcfg.num_layers} -> {n}: the whole model's f32 "
         f"weights, AdamW moments, gradients and codes (about 23 B a "
         f"parameter, 174 GB for {count_params(rcfg)}) do not fit the "
         f"card's 80 GB, and {n} keep the whole run within its 1,200 s",
         "global_batch": f"one sequence of {TRAIN_SEQ} tokens a step"},
        dict(layers=2))
    log(f"  phase 5b done at {done('5b'):.1f} s")

    n = HYBRID_TRAIN_LAYERS
    gcut = dataclasses.replace(gcfg, num_layers=n)
    log(f"phase 5c: training, {gcfg.name} cut to one super-layer (rec, rec, "
        f"attn) d_model {gcfg.d_model}, {TRAIN_SEQ} tokens a step (window "
        f"{gcfg.window}), {steps} steps, q8-delta commit every "
        f"{TRAIN_REC_COMMIT}")
    # K4's bf16 backward at head dim 256 runs the wgmma library, never the
    # FMA one; K7's 4096-token backward the TMA kernel, never the register
    # one
    rg_train, rg_cut = train_recurrent_phase(
        "train_recurrentgemma", gcut, device, card, 2_753_638_400,
        {"rglru_sm90": 2 * 2 * steps, "rglru_bwd_sm90": 2 * steps,
         "rglru_bwd": 0, "rglru": 0, "flash_fwd": 2 * steps,
         "flash_bwd_sm90": steps, "flash_bwd": 0},
        {"num_layers": f"{gcfg.num_layers} -> {n}: one super-layer, the two "
         f"RG-LRU tail layers dropped; with them (3,223,465,984 params) "
         f"the state at about 23 B a parameter and the 256,000-word "
         f"vocabulary's logits would reach the card's 80 GB",
         "global_batch": f"one sequence of {TRAIN_SEQ} tokens a step"},
        dict(layers=5, window=RING_CUT[0], seq=RING_CUT[1]))
    # the f32 cut's four RG-LRU layers (one super-layer, both tails) take
    # the ring cut's 40 tokens (the window of 16 rolls): their backwards go
    # where ``ops.route_bwd`` sends them, once each, the register kernel
    # below SM90_BWD_MIN_T
    cut_bwd = route_bwd(RING_CUT[1], gcfg.resolved_rnn_width, torch.float32)
    other = "rglru_bwd" if cut_bwd == "rglru_bwd_sm90" else "rglru_bwd_sm90"
    _check_launches(rg_cut, {cut_bwd: 4, other: 0},
                    "train_recurrentgemma f32 cut")
    log(f"  phase 5c done at {done('5c'):.1f} s")

    log(f"phase 5d: {qcfg.name} cut to 1 layer d_model {qcfg.d_model}, "
        f"{qcfg.num_experts} experts top-{qcfg.experts_per_token}: loss and "
        f"gradients of one {TRAIN_SEQ}-token sequence, {MOE_GRAD_CALLS} "
        f"calls, no optimizer")
    moe_grad, moe_grad_cut = grad_moe_phase(qcfg, device, card,
                                            3_697_815_552)
    log(f"  phase 5d done at {done('5d'):.1f} s")

    log(f"phase 5e: training, {scfg.name} {scfg.encoder_layers} + "
        f"{scfg.num_layers} layers d_model {scfg.d_model}, {TRAIN_SEQ} "
        f"tokens over {scfg.num_frames} frames a step, {steps} steps, "
        f"q8-delta commit every {TRAIN_REC_COMMIT}")
    # every K4 call twice a step (full remat recomputes each layer in the
    # backward), its backward once, all on the bf16 wgmma libraries
    n = scfg.encoder_layers + 2 * scfg.num_layers
    sm_train, sm_cut = train_recurrent_phase(
        "train_seamless", scfg, device, card, 978_909_184,
        {"flash_fwd": 2 * n * steps, "flash_bwd_sm90": n * steps,
         "flash_bwd": 0},
        {"global_batch": f"256 -> 1: one sequence of {TRAIN_SEQ} tokens "
         f"over {scfg.num_frames} frames a step"},
        dict(layers=SEAMLESS_PLAIN_LAYERS))
    log(f"  phase 5e done at {done('5e'):.1f} s")

    n = PIX_TRAIN_LAYERS
    log(f"phase 5f: training, {xcfg.name} cut to {n} of {xcfg.num_layers} "
        f"layers d_model {xcfg.d_model}, {TRAIN_SEQ} tokens after "
        f"{xcfg.num_patches} patches a step, {steps} steps, q8-delta commit "
        f"every {TRAIN_REC_COMMIT}, through a one-card NCCL mesh")
    px_train, px_cut = train_pixtral_mesh_phase(xcfg, device, card)
    # the f32 cut's one layer: K4's backward at head dim 160 on the FMA
    # library once
    _check_launches(px_cut, {"flash_bwd": PIX_PLAIN_LAYERS,
                             "flash_bwd_sm90": 0}, "train_pixtral f32 cut")
    log(f"  phase 5f done at {done('5f'):.1f} s")

    cut_cfg = dataclasses.replace(tcfg, num_layers=CUT_LAYERS)
    log(f"phase 6: {tcfg.name} cut to {CUT_LAYERS} layers, compressed "
        f"gradients, 1 -> 2 rank resize with overlap")
    cut = train_cut_phase(cut_cfg, device)
    cut["reduced"] = {"num_layers": (
        f"{tcfg.num_layers} -> {CUT_LAYERS}: the phase shows compressed "
        f"gradients and an overlap resize, whose wait grows with the "
        f"state; cut to keep the whole run within its 1,200 s")}
    log(json.dumps({"train_cut": cut}))
    log(f"  phase 6 done at {done('6'):.1f} s")

    log("phase 7: numbers")
    bwd = bwd_numbers(train_case, device)
    fwd_train = attention_numbers(train_case, device)
    codec = codec_numbers(w_gu, device)
    rwkv_bwd = rwkv6_bwd_numbers(rwkv_train_case, device)
    rglru_bwd = rglru_bwd_numbers(rglru_train_case, device)
    rglru_bwd_route = rglru_bwd_route_ms(gcfg.resolved_rnn_width, device)
    d256_bwd = bwd_d256_numbers(d256_train_case, device)
    moe_fwd_train = attention_numbers(moe_train_case, device)
    moe_bwd_train = bwd_numbers(moe_train_case, device)
    cross_fwd_train = attention_numbers(seamless_cross_train, device)
    cross_bwd_train = bwd_numbers(seamless_cross_train, device)
    d160_fwd_train = attention_numbers(pix_train_case, device)
    d160_bwd = bwd_numbers(pix_train_case, device)
    tp_fwd_serve = attention_numbers(tp_serve_case, device)
    tp_fwd_train = attention_numbers(tp_train_case, device)
    tp_bwd_train = bwd_numbers(tp_train_case, device)
    tp_moe_fwd = {name: attention_numbers(case, device)
                  for name, case in moe_tp_cases.items()}
    torch.cuda.synchronize()
    log(json.dumps({"flash_fwd_train_shape": fwd_train,
                    "flash_bwd_train_shape": bwd, "codec_w_gu": codec,
                    "rwkv6_bwd_train_shape": rwkv_bwd,
                    "rglru_bwd_train_shape": rglru_bwd,
                    "rglru_bwd_route_ms": rglru_bwd_route,
                    "flash_bwd_d256_train_shape": d256_bwd,
                    "flash_fwd_qwen3_moe_train_shape": moe_fwd_train,
                    "flash_bwd_qwen3_moe_train_shape": moe_bwd_train,
                    "flash_fwd_seamless_cross_train_shape": cross_fwd_train,
                    "flash_bwd_seamless_cross_train_shape":
                        cross_bwd_train,
                    "flash_fwd_d160_train_shape": d160_fwd_train,
                    "flash_bwd_d160_train_shape": d160_bwd,
                    "flash_fwd_tp_serve_shape": tp_fwd_serve,
                    "flash_fwd_tp_train_shape": tp_fwd_train,
                    "flash_bwd_tp_train_shape": tp_bwd_train,
                    **{f"flash_fwd_tp_{name}_serve_shape": v
                       for name, v in tp_moe_fwd.items()}}))
    log(f"  phase 7 done at {done('7'):.1f} s")

    log("phase 8: report cells on the card against their meta traces")
    t8 = time.monotonic()
    cells = report_phase(device)
    log(json.dumps({"report": [
        {k: m[k] for k in ("arch", "shape", "layers", "sequences",
                           "microbatches", "ms", "bound_s", "flops",
                           "bytes", "report_peak_bytes",
                           "max_memory_allocated", "peak_ratio",
                           "k4_launches")} for m in cells],
        "phase_s": time.monotonic() - t8}))
    log(f"  phase 8 done at {done('8'):.1f} s")

    log(f"phase 8b: the KV cache over its sequence: {KV_SEQ_ARCH}'s "
        f"{', '.join(KV_SEQ_CELLS)} as rank 0 of the "
        f"{KV_SEQ_MESH['data']} x {KV_SEQ_MESH['model']} mesh, "
        f"{KV_SEQ_MESH['model']} processes on the card")
    log(json.dumps({"serve_kv_seq": kv_seq_phase(device, card)}))
    log(f"  phase 8b done at {done('8b'):.1f} s")

    log(f"phase 9: the mesh's \"model\" axis: {TP_MODEL} processes on the "
        f"card over gloo; {cfg.name} served split ({TP_SERVE_LAYERS} layers, "
        f"{BATCH} x {PROMPT} prompt tokens, {GEN} new, the cache committed "
        f"and restored), {tcfg.name} cut to {TP_TRAIN_LAYERS} layers trained "
        f"split ({TP_TRAIN_STEPS} steps of {TRAIN_SEQ} tokens)")
    t9 = time.monotonic()
    # phase 10's f32 cuts are drawn while the card is free, and one world
    # of processes runs phase 9's ranks and then phase 10a-c's
    cuts = _draw_cuts(device, False)
    t_world = time.monotonic()
    tp_ranks = spawn_tp_world(("tp9", "rnn"), TP_MODEL, False)
    world_s = time.monotonic() - t_world
    log(f"  the ranks of phases 9 and 10a-c done in {world_s:.1f} s")
    tp = tp_phase(tp_serve_config(), tcfg, device, card, ranks=tp_ranks,
                  children_s=world_s)
    tp["serve_tp"]["phase_s"] = time.monotonic() - t9
    log(card)
    log(json.dumps({"serve_tp": tp["serve_tp"]}))
    log(json.dumps({"train_tp": tp["train_tp"]}))
    log(f"  phase 9 done at {done('9'):.1f} s")

    log(f"phase 10: the \"model\" axis for the recurrent models: "
        f"{RNN_TP_MODEL} processes on the card over gloo; {rcfg.name} and "
        f"{gcfg.name} served split at full width cut to {SERVE_LAYERS} "
        f"layers ({BATCH} x "
        f"{PROMPT} prompt tokens, {GEN} new, the state committed and "
        f"restored on the mesh and on one rank), their f32 cuts served and "
        f"trained split against the plain CPU path; then {pcfg.name} cut "
        f"to {TP10_CUTS[pcfg.name]['layers']} layers over {PHI3_TP_MODEL} "
        f"processes")
    t10 = time.monotonic()
    tp10_lines = tp10_phase(device, card, ranks=tp_ranks, cuts=cuts,
                            rnn_children_s=world_s)
    del tp_ranks
    log(card)
    for name, line in tp10_lines.items():
        log(json.dumps({name: line}))
    rnn = {"rwkv6-7b": tp10_lines["serve_tp_rwkv6"],
           "recurrentgemma-9b": tp10_lines["serve_tp_recurrentgemma"]}
    phi3_tp = tp10_lines["tp_phi3"]
    log(f"  phase 10 done at {done('10'):.1f} s "
        f"({time.monotonic() - t10:.1f} s)")

    log(f"phase 11: Mixture-of-Experts under FSDP_RULES: {bcfg.name} and "
        f"{qcfg.name} cut to {MOE_TP_LAYERS} layers served split over "
        f"{TP_MODEL} processes ({BATCH} x {PROMPT} prompt tokens, {GEN} "
        f"new, the cache committed and restored); {qcfg.name}'s f32 cut "
        f"({FSDP_CUT['layers']} layer) on a {FSDP_MESH} ('data', 'model') "
        f"mesh of processes against the plain CPU path")
    moe_lines = moe_phase(device, card)
    log(card)
    log(json.dumps({"serve_tp_moe": moe_lines["serve_tp_moe"]}))
    log(json.dumps({"fsdp_qwen3_moe": moe_lines["fsdp_qwen3_moe"]}))
    moe_tp = moe_lines["serve_tp_moe"]
    fsdp = moe_lines["fsdp_qwen3_moe"]
    log(f"  phase 11 done at {done('11'):.1f} s")
    log(card)
    log(json.dumps({"phase_wall_s": walls,
                    "total_s": time.monotonic() - t_start}))
    # ``launches`` is the count from the run of the path named by
    # ``launches_path``; ``launches_by_path`` gives every path's count
    paths = {"serve": yi_launches, "serve_rwkv6": rw_launches,
             "serve_recurrentgemma": rg_launches["serve"],
             "serve_recurrentgemma_ring": rg_launches["ring"],
             "serve_deepseek": ds_launches["serve"],
             "serve_deepseek_int8": ds_launches["int8"],
             "serve_phi3": ph_launches,
             "serve_seamless": sm_launches["serve"],
             "serve_seamless_int8": sm_launches["int8"],
             "serve_pixtral": px_launches, **moe_launches,
             "train": tr["launches"], "train_cut": cut["launches"],
             "train_rwkv6": rw_train, "train_rwkv6_f32_cut": rw_cut,
             "train_recurrentgemma": rg_train,
             "train_recurrentgemma_f32_cut": rg_cut,
             "grad_qwen3_moe": moe_grad,
             "grad_qwen3_moe_f32_cut": moe_grad_cut,
             "train_seamless": sm_train, "train_seamless_f32_cut": sm_cut,
             "train_pixtral": px_train, "train_pixtral_f32_cut": px_cut,
             "serve_tp": tp["serve_tp"]["launches"],
             "train_tp": tp["train_tp"]["launches"],
             "serve_tp_rwkv6": rnn["rwkv6-7b"]["launches"],
             "serve_tp_recurrentgemma": rnn["recurrentgemma-9b"]["launches"],
             "grad_tp_rwkv6_f32_cut": rnn["rwkv6-7b"]["plain_cut_launches"],
             "grad_tp_recurrentgemma_f32_cut":
                 rnn["recurrentgemma-9b"]["plain_cut_launches"],
             "grad_tp_phi3_f32_cut": phi3_tp["plain_cut_launches"],
             "serve_tp_dbrx": moe_tp["dbrx-132b"]["launches"],
             "serve_tp_qwen3_moe": moe_tp["qwen3-moe-235b-a22b"]["launches"],
             "grad_fsdp_qwen3_moe_f32_cut": fsdp["plain_cut_launches"],
             "rs_encode_check": rs["launches"]}

    def counts(name, path):
        return {"launches": paths[path][name], "launches_path": path,
                "launches_by_path": {p: c[name] for p, c in paths.items()
                                     if name in c}}

    def row(name, source, replaces, launches, err, n, **shapes):
        """One kernel's entry: every time is ``device_ms`` (``event_ms``
        beside it); ``shapes`` are its numbers at other shapes, with
        their max abs error where the script checks them there."""
        def times(x):
            return {k: x[k] for k in TIME_KEYS + ("max_abs_err", "shape")
                    if k in x}
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/{source}",
                "replaces": f"src/repro/kernels/{replaces}", **launches,
                "max_abs_err": err, **times(n),
                **{shape: times(v) for shape, v in shapes.items()}}

    # the paths run K4 in bf16: the sm90 kernels (f32 ones only in checks)
    fa = "flash_attention/csrc/"
    kernels = [
        row("flash_fwd", fa + "flash_fwd_sm90.cu",
            "flash_attention/kernel.py:95",
            counts("flash_fwd", "serve"), path_err, num,
            train_shape=fwd_train,
            deepseek_serve_shape={**ds_num["flash_fwd_serve_shape"],
                                  "max_abs_err": dense_errs["deepseek"]},
            phi3_serve_shape={**ph_num["flash_fwd_serve_shape"],
                              "max_abs_err": dense_errs["phi3"]},
            dbrx_serve_shape={**moe_nums["serve_dbrx"],
                              "max_abs_err": dense_errs["dbrx"]},
            qwen3_moe_serve_shape={**moe_nums["serve_qwen3_moe"],
                                   "max_abs_err": dense_errs["qwen3_moe"]},
            qwen3_moe_train_shape={**moe_fwd_train,
                                   "max_abs_err": moe_fwd_err},
            seamless_serve_shape={**sm_num["flash_fwd_serve_shape"],
                                  "max_abs_err": dense_errs["seamless"]},
            seamless_noncausal_shape={
                **sm_num["flash_fwd_noncausal_shape"],
                "max_abs_err": cross_errs[seamless_cross][0]},
            seamless_cross_train_shape={
                **cross_fwd_train,
                "max_abs_err": cross_errs[seamless_cross_train][0]},
            # a rank's heads of the two-way "model" split: yi-6b's prefill
            # (``launches_by_path``'s serve_tp) and qwen2.5-3b's training
            # shape (train_tp)
            tp_serve_shape={**tp_fwd_serve,
                            "max_abs_err": tp_errs[tp_serve_case]},
            tp_train_shape={**tp_fwd_train,
                            "max_abs_err": tp_errs[tp_train_case]},
            # a rank's heads of the MoE models' two-way split (phase 11a,
            # ``launches_by_path``'s serve_tp_dbrx and serve_tp_qwen3_moe)
            **{f"tp_{name}_serve_shape": {
                **tp_moe_fwd[name],
                "max_abs_err": tp_errs[moe_tp_cases[name]]}
               for name in moe_tp_cases}),
        # its head-dim-160 instance, on pixtral-12b's path
        row("flash_fwd_d160", fa + "flash_fwd_sm90.cu",
            "flash_attention/kernel.py:95",
            counts("flash_fwd", "serve_pixtral"), d160_err,
            px_num["flash_fwd_d160_serve_shape"],
            train_shape=d160_fwd_train),
        # the same kernel's head-dim-256 instance, on recurrentgemma-9b's
        # path (its windowed MQA layers)
        row("flash_fwd_d256", fa + "flash_fwd_sm90.cu",
            "flash_attention/kernel.py:95",
            counts("flash_fwd", "serve_recurrentgemma"), d256_err,
            rg_num["flash_fwd_d256_prefill_shape"],
            tp_serve_shape=tp10["flash_fwd_d256"]),
        row("flash_bwd", fa + "flash_bwd_sm90.cu",
            "flash_attention/ops.py:94",
            counts("flash_bwd_sm90", "train"), bwd_err, bwd,
            qwen3_moe_train_shape={**moe_bwd_train,
                                   "max_abs_err": moe_bwd_err},
            seamless_cross_train_shape={
                **cross_bwd_train,
                "max_abs_err": cross_errs[seamless_cross_train][1]},
            tp_train_shape={**tp_bwd_train, "max_abs_err": tp_bwd_err})]
    for name, line in (("quantize", 54), ("quantize_delta", 74),
                       ("dequantize", 98)):
        # K3 runs only where gradients are compressed: the cut phase
        kernels.append(row(
            name, "ckpt_codec/csrc/codec.cu",
            f"ckpt_codec/kernel.py:{line}",
            counts(name, "train_cut" if name == "dequantize" else "train"),
            float(codec_bad), codec[name]))
    kernels += [
        # K6: the chunked tensor-core kernel runs rwkv6-7b's prefill, the
        # sequential one its one-token decode steps (and every f32 call);
        # the sequential kernel's prefill-shape time is the yardstick of
        # the earlier design
        # (tp_*_shape: a rank's heads of phase 10's two-way split,
        # ``launches_by_path``'s serve_tp_rwkv6)
        row("rwkv6_sm90", "rwkv6/csrc/rwkv6_sm90.cu", "rwkv6/kernel.py:86",
            counts("rwkv6_sm90", "serve_rwkv6"), rwkv_errs["rwkv6_sm90"],
            rw_num["rwkv6_sm90_prefill_shape"],
            tp_prefill_shape=tp10["rwkv6_sm90"]),
        row("rwkv6", "rwkv6/csrc/rwkv6.cu", "rwkv6/kernel.py:86",
            counts("rwkv6", "serve_rwkv6"), rwkv_errs["rwkv6"],
            rw_num["rwkv6_decode_shape"],
            prefill_shape=rw_num["rwkv6_prefill_shape"],
            tp_decode_shape=tp10["rwkv6"]),
        # no serving or training path runs K5: its launches are its check's
        row("rs_encode", "ckpt_codec/csrc/rs.cu",
            "ckpt_codec/rs_kernel.py:87",
            counts("rs_encode", "rs_encode_check"), float(rs["mismatches"]),
            rs["numbers"]),
        # K7: the TMA kernel runs recurrentgemma-9b's prefill, the
        # register one its one-token decode steps; the register kernel's
        # prefill and ring times are the yardstick of the earlier design
        row("rglru_sm90", "rglru/csrc/rglru_sm90.cu", "rglru/kernel.py:58",
            counts("rglru_sm90", "serve_recurrentgemma"),
            rglru_errs["rglru_sm90"], rg_num["rglru_sm90_prefill_shape"],
            ring_shape=rg_num["rglru_sm90_ring_shape"],
            tp_prefill_shape=tp10["rglru_sm90"]),
        row("rglru", "rglru/csrc/rglru.cu", "rglru/kernel.py:58",
            counts("rglru", "serve_recurrentgemma"), rglru_errs["rglru"],
            rg_num["rglru_decode_shape"],
            prefill_shape=rg_num["rglru_prefill_shape"],
            ring_shape=rg_num["rglru_ring_shape"],
            tp_decode_shape=tp10["rglru"]),
        # the backwards of the recurrent training phases: K6's and K7's,
        # which the reference runs as the vjp of its chunked form and as
        # its analytic reverse scan, and K4's at head dim 256.  K6's
        # chunked kernel runs the bf16 training path; the sequential one
        # (the earlier design, timed at the same shape) runs f32 and short
        # calls: the f32 cut's
        row("rwkv6_bwd_sm90", "rwkv6/csrc/rwkv6_bwd_sm90.cu",
            "rwkv6/ops.py:90", counts("rwkv6_bwd_sm90", "train_rwkv6"),
            rwkv_bwd_err["rwkv6_bwd_sm90"], rwkv_bwd),
        row("rwkv6_bwd", "rwkv6/csrc/rwkv6_bwd.cu", "rwkv6/ops.py:90",
            counts("rwkv6_bwd", "train_rwkv6_f32_cut"),
            rwkv_bwd_err["rwkv6_bwd"], rwkv_bwd["sequential_design"]),
        # K7's: the TMA kernel runs the bf16 training path, the register
        # one (the earlier design, timed at the same shape) short calls:
        # the f32 cut's
        row("rglru_bwd_sm90", "rglru/csrc/rglru_bwd_sm90.cu",
            "rglru/ops.py:54", counts("rglru_bwd_sm90", "train_recurrentgemma"),
            rglru_bwd_errs["rglru_bwd_sm90"], rglru_bwd),
        row("rglru_bwd", "rglru/csrc/rglru_bwd.cu", "rglru/ops.py:54",
            counts("rglru_bwd", "train_recurrentgemma_f32_cut"),
            rglru_bwd_errs["rglru_bwd"], rglru_bwd["register_design"]),
        row("flash_bwd_d256", fa + "flash_bwd_sm90.cu",
            "flash_attention/ops.py:94",
            counts("flash_bwd_sm90", "train_recurrentgemma"), d256_bwd_err,
            d256_bwd, f32_fma_design=d256_bwd["f32_fma_design"]),
        # its head-dim-160 instance (the query-split dk/dv kernel), on
        # pixtral-12b's training path
        row("flash_bwd_d160", fa + "flash_bwd_sm90.cu",
            "flash_attention/ops.py:94",
            counts("flash_bwd_sm90", "train_pixtral"), d160_bwd_err,
            d160_bwd)]
    log(f"  total {time.monotonic() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
