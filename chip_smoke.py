#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs:

0. the card (``nvidia-smi`` name and power limit) and the kernel build
   (one ``nvcc`` per source, all at once; registers, spills and ptxas's
   wgmma serialization notes printed); then NVML
   (``repro_torch.core.nvml``): the card's NVML device found by torch's
   UUID, its name and UUID equal to torch's, and an energy window with
   the card idle (no kernel has run yet) over 20 counter updates, whose
   median interval is the counter's period;
1. ``flash_decode`` (kernel) against ``flash_decode_plain`` on the card,
   ten cases: (a) the serving shape b=8, hq=hkv=16, d=128, S=1024, bf16,
   ragged pos 100..1000; (b) the same in fp32; (c) GQA 32/8 over a cache
   stored (b, hkv, S, d) and passed as a strided (b, S, hkv, d) view;
   (d) window 256 + softcap 50 over wrapped rings; (e) S=1000; (f) a row
   with no visible slot (every split empty), which must come out 0; (g)
   one long row, b=1, S=4096 (the S axis split over the most blocks);
   (h) rows whose visible slots all lie in one split; (i) a 700-slot
   window of wrapped rings, across every split; (j) a cache view whose
   rows force copies narrower than 16 bytes.  Tolerances: fp32
   atol=rtol=1e-5; bf16 atol 2e-2, because the plain version rounds p to
   bf16 before PV (as the reference does) and the kernel keeps fp32.
   Two calls at (a), and a third after a call of another grid, must give
   the same bits.  At (a) and at the serving step's cache (s: the same
   shape, every row at pos 300) it times the kernel, the plain version
   and, as a yardstick only, ``scaled_dot_product_attention`` (the port
   never calls it), computes the least time the card could take, and
   prints the kernel's split count, copy width and TB/s of visible bytes;
1b. ``flash_decode_quant`` against its plain version (``dequantize_kv``
   then ``decode_attention``): all five formats at shape (a) in bf16;
   fp4 in fp32; GQA 32/8 over a head-major strided cache; window 256 +
   softcap 50 on wrapped rings; a row with no visible slot; (g) one long
   row, (h) one-split rows, (i) a wrapped window across the splits and
   (j) 1-byte copies, as in phase 1.  Same tolerances and the same
   bit-identity check.  At (a) and (s), for fp8 and fp4, it times the
   kernel, the plain version and SDPA over the cache dequantized
   beforehand to bf16 (a yardstick that leaves the dequantization out),
   with the split count, copy widths and TB/s;
1c. ``qmatmul`` (fp8 e4m3 container) and ``qmatmul_packed`` (fp4, fp6
   e2m3, fp6 e3m2) against their plain versions at (m, n, k) =
   (2048, 2048, 2048), (2048, 4096, 8192), (8, 8192, 2048), the ragged
   (200, 1024, 1024), and across the edge of the kernel's narrow (m <=
   64, split k) and wide paths (64, 8192, 2048) and (65, 1024, 1024),
   bf16 out: within 2 bf16 ulps plus 1e-4 * sqrt(k / 1024) (summation
   order).  Packed must be bit-identical to the container kernel on the
   same values.  At 2048^3 and (8, 8192, 2048) it times both kernels,
   their plain versions and ``torch.matmul`` in bf16 over the weight
   dequantized beforehand (a yardstick);
1d. the probe kernels against their plain versions: ``chase`` exact (the
   final index, also against the numpy oracle) over (rows, 128) buffers
   at rows 16, 4096, 2^17 and flat (n, 1) chains at n = 2^12, 2^20,
   2^24; ``dep_chain`` at (chain, ilp) = (10, 1), (100, 2), (57, 4),
   (256, 8) (within (n + 1) ulps: fma against the plain version's
   multiply and add) and every compute workload at lanes 1 and 4096
   (int32, fp32, mixed1 and mixed2 exact: under the reference's
   constants fma and multiply-add round alike, see
   ``probe_dep_chain.assert_chain_close``; mixed2 only up to chain 40,
   where no float -> int32 convert overflows; fp64 within (n + 1)
   ulps); ``mma_probe`` in bf16, fp16 and fp32 (TF32) at ilp 1..8 and
   (m, k, n) = (256, 256, 128), (128, 128, 128) and (48, 48, 72) (off
   the kernel's 32 x 32 block tile), y broadcast over the products as
   ``mma_probe`` passes it (bf16 / fp16 out: within 1 ulp of the type +
   1e-5 sqrt(k); TF32: atol 2^-8 sqrt(k), eight standard deviations of
   the operands' TF32 rounding for N(0, 1) inputs) and the fp32-out
   products the sweep runs, also at (48, 48, 72) (atol 1e-5 sqrt(k)).
   At the characterize path's shapes it times each kernel, its plain
   version and, for ``mma_probe``, ``torch.bmm`` in bf16 (a yardstick);
1e. ``ssd_scan`` against ``ssd_scan_plain`` (``models.ssm.ssd_chunked``)
   on unit-scale inputs with model-like decays (dt_a in [-1.6, -0.001]):
   (a) the serving call (bt 1, s 256, 80 heads, p 64, n 128, fp32 x,
   bf16 b / c, an initial state); (b) bt 8, s 2048 (the carry crosses 8
   chunks inside the kernel); (c) s 100 with chunk 32 (padding); (d)
   bf16 x and b / c; (e) fp32 b / c and no initial state; then the edges
   of ``ssd_scan.plan``: (f) p 48, n 64, chunk 32; (g) chunk 1024 over 4
   heads; (h) bt 8 x 80 heads (640 pairs) at chunk 1024; (i) bt 2 x 1
   head; (j) p 48 over 80 heads (a slice of 32 and one of 16); (k) p 18,
   n 20 (rows off 16 bytes: element copies).  Tolerance atol 2e-4 on y
   and the state (the reference's own kernel test against its oracle), a
   bf16 y also one bf16 ulp.  It times (a) and (b), kernel and plain
   version, beside the least time the card could take and the times of
   the same flops at the fp32 CUDA-core rate and, three products each, at
   the TF32 tensor-core rate (the kernel's split products); no PyTorch
   call computes an SSD scan, so there is no yardstick.  Every case also
   runs ``ssd_scan_states`` (training's forward: the kernel also stores
   the state entering each chunk), whose states are held to the plain
   version's (fp32, atol 2e-4) and whose y and final state must be the
   first call's bits; (a) and (b) are timed with the store too
   (entries ``<case>_states``);
1f. ``wgmma.cuh``'s A-from-registers form with an MN-major B (the
   P V product of the bf16 kernel) on a unit tile, (64, k) @ (k, n) for
   k = 16 .. 64 and n = 64, 128, against an fp32 product (atol 1e-5);
   then ``flash_attention`` against ``flash_attention_plain`` (the
   reference's ``attention()`` dispatch): (a) gptneox-1b's shape b 8,
   s 2048, hq = hkv = 16, d 128, bf16, causal; (b) the same in fp32; (c)
   GQA 32/8 with d 64, sq 384 over skv 1000; (d) window 256 with softcap
   50; (e) non-causal; (f) ragged sq 96 over skv 130; (g) q_offset 512,
   sq 128 over skv 640; (h) d 256.  Tolerances of the reference's kernel
   test: fp32 atol 2e-5; bf16 atol 2e-2 (the plain version rounds the
   normalized p to bf16 before PV, the kernel the running-max p); a row
   that sees no key must be 0.  Every case but (g) also runs
   ``flash_attention_lse`` (the call that stores the LSE, training's
   forward), held to the same tolerance and to the first call's bits.
   At (a) and (b) it times the kernel, that call (``<case>_lse``), the
   plain version and, as a yardstick only, SDPA with ``is_causal``,
   beside the bound (bytes of q, k, v and out at the HBM rate; 4 d flops
   per visible (query, key) pair at the bf16 tensor-core or fp32 vector
   peak);
1g. the shapes seamless-m4t-medium adds, each kernel against its plain
   version with phase 1's and 1f's tolerances, then timed beside its
   bound and SDPA: (x) the decoder's cross-attention step,
   ``flash_decode`` and ``flash_decode_quant`` (fp8, fp4) at b 8 over a
   ring of 1024 source slots, hq = hkv = 16, d 64, query position 2^30,
   sources of 600..1000 frames (a ragged tail of slot_pos -1); (y) the
   encoder's ``flash_attention``, bf16, non-causal, b 8, sq = skv =
   1000; (z) non-causal cross-attention of 16 queries over 1000 keys;
1h. ``flash_attention_bwd`` (the training path's backward kernel)
   against ``flash_attention_bwd_plain`` (the explicit formulas in fp32
   on the same inputs), given the output and LSE that the forward kernel
   stored (``flash_attention_lse``), first held to the plain output
   (1f's tolerances) and the plain LSE (``attention_lse_plain``, fp32,
   atol 1e-4): (a) qwen2.5-3b's
   training shape b 8, s 256, hq 16 over hkv 2, d 128, bf16, causal; (b)
   row 5's b 8, s 2048, hq = hkv = 16, d 128; (c) d 256 with window 512 and softcap 50; (d) non-causal
   d 64 (the seamless encoder, s 1000); (e) fp32; (f) fp32 with softcap 5
   over scores of sd 4 (q scaled by 4), where the chain factor 1 - t^2
   spans ~1 to ~0.  Tolerance: bf16 atol 1e-2 x the largest |grad|,
   fp32 atol 1e-5 x the largest |grad|; two calls bit-identical.  Each
   case's launch plan (``bwd_plan``: blocks, the q-head split), then
   its time (kernel, plain version, and, as a yardstick only, the
   backward of SDPA where it takes the case) beside the bound (q, k, v,
   o, dO, dq, dk, dv at the HBM rate; 10 d flops per visible (query,
   key) pair at the bf16 or fp32 peak), and its passes' device times
   from a profile (D, dK / dV, the split's reduce, dQ);
1i. ``ssd_scan_bwd`` (the SSM training path's backward kernel) against
   ``ssd_scan_bwd_plain`` (the explicit formulas in fp32, chunk by
   chunk) on the same inputs and the plain forward's states: (a)
   mamba2-2.7b's training call, bt 4, s 512, 80 heads, p 64, n 128, fp32
   x, bf16 b / c, chunk 256 (two chunks); (b) bt 8, s 2048 (8 chunks);
   (c) jamba's SSM, 128 heads, n 16, bt 2, s 1024; (d) s 100 at chunk
   32 (padded; dy 0 on the tail), with an initial state and a
   final-state cotangent; (e) bf16 x; (f) p 48, n 64; (g) (a) given the
   states the forward kernel stored (``ssd_scan_states``).  Tolerance:
   each gradient within atol 1e-4 x the plain gradient's largest
   magnitude (a bf16 one also within one bf16 ulp, rtol 2^-7); two calls
   bit-identical.  (a)-(f) timed (kernel, plain version) beside the
   bound (inputs read and gradients written once at the HBM rate; the
   formulas' flops at the fp32 CUDA-core rate or, three products each,
   at the TF32 rate, whichever is less), with the passes' device times
   from a profile; no PyTorch call computes an SSD backward, so there is
   no yardstick;
2. full-width gptneox-1b (16 layers, d_model 2048, vocab 50432, bf16,
   seeded random weights) through ``ServeEngine.run`` on the card: 8
   requests x 256-token prompts x 64 new tokens, batch 8, max_seq 1024,
   prefill_chunk 32, decode_block 16.  Every request must end ``ok``
   with 64 tokens and ``flash_decode`` must have launched once per layer
   per decode step; the kernel is then held against its plain version
   on the engine's own pool (case g).  The served run is an NVML energy
   window (phase 2r reads it);
2b. the same traffic through quantized serving, twice: fp4 weights
   (packed store) with fp4 KV, and fp8 weights with fp8 KV.
   ``flash_decode_quant`` must have launched once per layer per decode
   step and ``flash_decode`` never; measured weight and KV bytes are
   printed, and the kernel is held to its plain version on the engine's
   quantized pool (case g); each served run an energy window, as in 2;
2c. the block-scaled GEMM path of the Tab VII benchmark: the user entry
   points ``quantize_for_qmatmul`` + ``qmatmul`` (fp8) and
   ``pack_for_qmatmul`` + ``qmatmul_packed`` (fp4) at its sizes 512^3 ..
   8192^3, each output held to the plain version; then, per size, the
   port's Tab VII: both kernels' ms and TFLOP/s beside ``torch.matmul``
   in bf16 over the weight dequantized beforehand (a yardstick);
2d. mamba2-2.7b at full width cut to ``CUT_LAYERS`` layers (of 64;
   d_model 2560, 80 SSD heads, ssm_state 128, vocab 50280, bf16,
   seeded random weights) through
   ``ServeEngine.run``: 8 requests x 512-token prompts x 64 new tokens,
   batch 8, max_seq 1024, prefill_chunk 256, decode_block 16.  Every
   request must end ``ok`` with 64 tokens, ``ssd_scan`` must have
   launched once per prefill chunk per layer (8 x 2 x n_layers) and its
   plain version never; the slot-state bytes and the profiled decode
   block are printed as for dense, then one more admission of the 8
   prompts (and a decode step), profiled: its device time and
   ``ssd_scan``'s share of it;
2e. the whole-sequence path at full width, bf16, seeded weights:
   gptneox-1b ``Model.forward`` on 8 x 2048 tokens, ``Model.prefill`` of
   the same prompts (max_seq 2112), then 64 greedy ``Model.decode_step``
   calls; ``flash_attention`` must launch exactly 16 times per forward
   and per prefill and its plain version never, ``flash_decode`` 16 times
   per decode step; prefill's last logits within atol 1e-3 of forward's
   at position 2047.  Then mamba2-2.7b ``Model.prefill`` on 8 x 2048
   tokens and 16 greedy decode steps: ``ssd_scan`` exactly 64 launches
   (one per layer), its plain version never.  Wall and profiled device
   times, prefill tokens/s, ms per decode step, peak memory and
   flash_attention's device ms per call are printed;
2f. gemma2-2b at full width cut to ``CUT_LAYERS`` layers (of 26;
   local / global in turn; d_model 2304, 8 q-heads over 4 KV heads of
   256, d_ff 9216, vocab 256000, tied, bf16, seeded weights)
   through ``ServeEngine.run``: batch 8, max_seq 4608 (rings of 4096
   slots on the local layers, 4608 on the global ones), 2 prompts of
   4200 tokens and 6 of 256 x 64 new tokens, prefill chunks of 256, so
   the local rings wrap in the chunk writes and in decode.  Served with
   dense KV (``flash_decode`` exactly n_layers launches a decode step),
   then with fp4 KV on the local layers and fp8 on the global ones
   (``flash_decode_quant`` n_layers a step); the other kernel and both plain
   versions never; each kernel on both ring kinds of the engine's pool
   (window 4096 and softcap 50 on the local ring) held to its plain
   version (case g).  The unembed (the tied table cast to fp32 every
   call) profiled alone.  Then ``Model.forward`` and ``Model.prefill``
   of 2 x 4608 tokens: ``flash_attention`` exactly n_layers launches each,
   its plain version never, the prefill's last logits within atol 1e-3
   of the forward's; and the kernel against its plain version at that
   shape (window 4096, softcap 50, bf16 atol 2e-2).  Phase 2's metrics
   are printed for each run;
2g. qwen2.5-3b, llama3.2-3b and gemma-2b at full width cut to
   ``CUT_LAYERS`` layers, one after the other: greedy, batch 8, 8 x
   256-token prompts x 64 new tokens,
   max_seq 1024, prefill chunks of 256; ``flash_decode`` exactly
   ``n_layers`` launches a decode step, case (g).  Then gptneox-1b
   sampled (temperature 0.8, top_k 8, seed 3) with phase 2's traffic:
   its kernels and device-busy ms a step beside phase 2's greedy run;
2h. jamba-v0.1-52b at full width (d_model 4096, 16 experts top-2 on
   every second block, an attention block and 7 SSM blocks of 128 heads
   over a state of 16 a period, vocab 65536), cut to 16 layers (two
   periods: 52 GB of bf16 weights; the full 32 do not fit one card),
   seeded weights: batch 8, max_seq 1024, 8 x 256-token prompts x 64
   new tokens, prefill chunks of 256, served with dense KV and with fp8
   KV; ``flash_decode`` (or ``flash_decode_quant``) exactly 2 launches a
   decode step, ``ssd_scan`` exactly 14 a prefill chunk of a slot, every
   plain version never; the MoE calls' share of a 16-step decode
   block's device timeline (CUDA events); then ``Model.forward`` and
   ``Model.prefill`` of 8 x 2048 tokens (2 ``flash_attention`` and 14
   ``ssd_scan`` launches a call) and 16 decode steps, each kernel's
   device ms a call profiled;
2i. kimi-k2-1t-a32b cut to 1 layer (384 experts top-8 and a shared
   expert) and llama4-maverick-400b-a17b cut to 2 (a dense and a MoE
   FFN of 128 experts top-1 with a shared expert), full width, bf16,
   phase 2's traffic in 256-token chunks, each freed before the next;
   ``flash_decode`` exactly n_layers launches a decode step;
2j. robustness on full-width gptneox-1b: a ``logits_nan`` fault armed on
   one request and a cancel of another inside a run, with the next
   16-step block, under ``torch.cuda.set_sync_debug_mode("error")``;
   the six other streams bit-identical to a clean run, the accounting
   balanced, the watchdog clean; a ``poisson_trace`` replayed under the
   virtual clock through a queue of 4 that rejects, twice, with the
   same report;
2k. seamless-m4t-medium at full width cut to ``CUT_LAYERS`` encoder
   and ``CUT_LAYERS`` decoder layers (of 12 and 12; d_model 1024, 16
   heads of 64, vocab 256206, bf16, seeded weights),
   batch 8, max_seq and enc_len 1024: 8 requests of 600..1000 source
   frames + 16-token prompts x 64 new tokens, served with dense, fp8 and
   fp4 KV (the cross rings quantized too); ``flash_decode`` (or
   ``flash_decode_quant``) exactly 2 x n_layers launches a decode step
   (self and cross), the other kernel and every plain version never;
   case (g) on the self and the cross ring; ``cross_kv_bytes``; the
   encode a request (wall and profiled); then forward and prefill of 8 x
   1024 frames + 8 x 1024 tokens (3 x n_layers ``flash_attention``
   launches a call) and 16 decode steps;
2l. internvl2-2b at full depth (24 layers, d_model 2048, 16 q-heads over 8
   KV heads of 128, vocab 92553, bf16): 8 requests of 256 patches + 256
   tokens x 64 new tokens in 256-token chunks, ``flash_decode`` exactly
   24 launches a decode step; forward and prefill of 8 x (256 patches +
   1792 tokens), 24 ``flash_attention`` launches a call;
2m. speculative serving at full width, bf16, seeded weights, batch 8,
   max_seq 1024, prefill chunks of 256, 8 period-3 cyclic 256-token
   prompts (a phase a request) x 64 new tokens: gptneox-1b cut to
   ``CUT_LAYERS`` of its 16 layers with n-gram drafting
   (``SpecConfig()``: 4 drafts, a table of 512) over dense and over fp8
   KV, and drafting for itself (3 drafts); mamba2-2.7b cut to
   ``CUT_LAYERS`` of its 64 layers with n-gram drafting; each beside
   the same traffic without
   speculation.  Decode tok/s, blocks, ``mean_accepted_len``, wall and
   profiled device ms a block, kernels a block, idle share, and per
   request the first index where the speculative stream leaves the
   non-speculative one (reported, not gated: verify reads through the
   plain attention, which rounds p to bf16, decode through
   ``flash_decode``).  Gates: every request ``ok`` with 64 tokens; the
   n-gram target launches neither decode kernel; the self-draft run
   ``flash_decode`` exactly 16 x 3 times a block; mamba2's admission
   ``ssd_scan`` exactly 8 x n_layers times; no plain version called; one
   speculative block (fp8 n-gram, and self-draft) under
   ``set_sync_debug_mode("error")``;
2n. qwen2.5-3b training at full width and full depth (36 layers, 3.09 B
   bf16 params, tied embeddings), seeded weights, the affine stream,
   batch 8 x seq 256, under ``torch.use_deterministic_algorithms``:
   ``run_train_loop`` 3 steps at accum 1, then 3 at accum 2; exactly
   2 x 36 x accum ``flash_attention`` launches a step (block remat runs
   each forward twice, both storing the LSE) and 36 x accum
   ``flash_attention_bwd``, no plain version; a finite loss and grad
   norm every step; host s a step, tokens/s, one step profiled
   (device-busy ms, both kernels' ms, the backward's by pass, idle
   share), peak memory.  Then checkpoint / restart at full width cut to
   ``TRAIN_RESTART_LAYERS`` layers: 2 steps leave a checkpoint, a fresh
   state resumes from it to step 4, and its losses and final params /
   ``m`` / ``v`` / step are bit-identical to 4 uninterrupted steps;
2p. data-parallel training inside 2n: after its accum-2 run, on its
   full-depth model and state, under its deterministic mode, through a
   one-rank group (CPU tensors by gloo, the card's by NCCL, from a
   ``HashStore``): ``make_local_dp_train_step`` at accum 2 through
   ``run_train_loop`` for 3 steps uncompressed, then 3 with the int8
   compressed mean; exactly 2 x 36 x 2 ``flash_attention`` and 36 x 2
   ``flash_attention_bwd`` launches a step, no plain version; finite
   losses and grad norms; host s a step and tokens/s (the median of
   steps 2-3, as 2n), one more step profiled (device-busy ms, idle
   share against its own wall time), peak memory; then the reduction
   alone (``local_dp.reduce_gradients`` on one accum-2 step's fp32
   gradients, compressed and not, each between two CUDA events) and
   its share of the profiled step's busy ms.  After 2n's restart, at
   its 2 layers: the uncompressed one-rank DP step and
   ``make_train_step``, 2 steps at accum 2 from one seed,
   bit-identical params / ``m`` / ``v`` / step;
2o. mamba2-2.7b training at full width and full depth (64 layers, 2.70 B
   bf16 params, fp32 ``m`` / ``v``), seeded weights, the affine stream,
   batch 4 x seq 512 (each row crosses an SSD chunk boundary), under
   ``torch.use_deterministic_algorithms``: ``run_train_loop`` 3 steps
   at accum 1; exactly 2 x 64 ``ssd_scan`` launches a step (block remat
   runs each forward twice, both storing the states) and 64
   ``ssd_scan_bwd``, no plain version; a finite loss and grad norm
   every step; host s a step, tokens/s, one step profiled (device-busy
   ms, both kernels' ms, idle share), peak memory (no 2-layer restart:
   2n's covers the checkpoint path, and the time went to 2p, 2q and
   3k);
2q. the training examples on the card: ``repro_torch.examples.
   quickstart`` whole (60 steps of the 2-layer qwen2.5-3b, a checkpoint
   at 30, then greedy serving of the trained model: k/8 continuations
   of the affine chain), and ``train_100m`` (llama-100m, batch 4 x 256)
   for 40 steps, then a second run to 60 that resumes from the
   checkpoint at 40; every logged loss finite, each run's last below
   its first.  Then the serving examples at their own sizes, from
   weights made on the CPU: ``serve_demo`` (gptneox-1b reduced, five
   weight formats, fused K=16 and per-step): the fused and per-step
   streams identical for each format, ``quantized_bytes`` equal to the
   CPU's and the rel-MSE within 1e-5 relative of it, ``flash_decode``
   launched and its plain version never; ``long_context`` (mamba2 and
   gemma2 reduced, then gemma2 with fp4 KV, decoded to positions 64,
   256, 1024; fp32, TF32 off; each run, and a CPU run of each, in a
   worker process of its own): the cache bytes and ``kv_cache_stats`` at
   each position
   equal to the CPU's, the greedy tokens equal up to position 64, every
   logit finite, and exact launches (``ssd_scan`` n_layers in mamba2's
   prefill, ``flash_attention`` n_layers in gemma2's, ``flash_decode``
   or ``flash_decode_quant`` n_layers a decode step), no plain version;
2r. power and energy (the paper's Tab VI, Fig 12, Tab VIII), read by
   NVML beside ``core.energy.estimate`` for the detected part with the
   same flops and HBM bytes and the measured device time a launch:
   phase 0's idle window against the model's ``idle_watts``; sustained
   loops of ``mma_products`` in TF32, fp16 and bf16 (batch x 4 x 128^3
   with the batch doubled until a launch takes >= 0.5 ms) and of
   ``qmatmul`` fp8 and ``qmatmul_packed`` fp6 e2m3, fp6 e3m2, fp4 at
   2048^3; ``qmatmul`` fp8 at 512^3 .. 8192^3 (J/TFLOP); and the windows
   of phases 2 / 2b beside ``serve_demo``'s estimate for gptneox-1b (W,
   J a generated token).  A sustained window lasts until the counter
   has moved 20 times (a window of a served run says so where it holds
   fewer than 10 updates); each line gives
   the window's updates, busy share (launches x the CUDA-event time a
   launch over the window), SM and memory clocks, temperature and
   clocks-event reasons.  Gates, correctness only: the counter rises in
   every window, mean W in (0, 1.05 x the enforced limit], each looped
   kernel's last output the bits of its first, and the first within
   1c / 1d's tolerances of its plain version; an NVML error fails the
   run;
3. the dense path on the card and on the CPU in fp32 with TF32 off, full
   width, 2 layers, the same seeded weights: 2 requests x 32-token
   prompts x 16 new tokens, decode_block 7.  Greedy streams must be
   identical and the admission logits within atol 1e-3;
3b. the quantized path the same way (fp4 packed weights + fp4 KV, then
   fp8 + fp8): the weight store byte-identical on card and CPU,
   ``quantize_kv`` of one tensor byte-identical for all five formats,
   greedy streams identical, admission logits within atol 1e-3;
3c. mamba2-2.7b cut to 2 layers at full width, fp32, TF32 off, the same
   way: prompts of 300 and 600 tokens in prefill chunks of 512 (an SSD
   chunk boundary inside the kernel, ragged tails, a carry into a second
   call), 16 new tokens; greedy streams identical, the prefill's last
   logits within atol 1e-3, ``ssd_scan`` launched 3 x 2 times;
3d. the whole-sequence path the same way (fp32, TF32 off, 2 layers at
   full width): gptneox-1b, 2 x 300-token prompts, prefill, 16 greedy
   steps, then forward over prompt + stream: streams identical, forward
   and prefill logits within atol 1e-3 and the prefill's K/V within 1e-4
   of the CPU's, the card's decode logits within 5e-4 of its forward's;
   mamba2-2.7b prompts of 300 and 600 tokens: streams identical, prefill
   logits and the SSM carries and state within atol 1e-3;
3e. the sampler and the dense-decoder family the same way: at (8,
   256000), ``random_bits`` and ``uniform`` bit-identical on card and
   CPU, gumbel within atol 2e-6, ``sample_tokens`` equal; gemma2-2b cut
   to 2 layers at full width with its window cut to 64 (the rings wrap
   in a short run), 2 x 300-token prompts x 16 new tokens, greedy and
   sampled (temperature 0.8, top_k 8, seed 3); gemma-2b (MQA) greedy:
   streams identical, admission logits within atol 1e-3,
   ``flash_decode`` once per layer per decode step on the card;
3f. jamba-v0.1-52b, kimi-k2-1t-a32b and llama4-maverick-400b-a17b
   reduced (fp32, TF32 off) at capacity factors 8.0 and 1.25 (the
   padded prefill chunks drop tokens), card against CPU, greedy and
   sampled: streams identical, admission logits within atol 1e-4;
3g. seamless-m4t-medium (dense, fp8 and fp4 KV; sources of 300 and 200
   frames) and internvl2-2b (64 patches a request) at full width cut to
   2 layers (2 encoder layers), fp32, TF32 off, card against CPU:
   streams identical, admission logits within atol = rtol 1e-5 with
   dense KV (atol 1e-3 quantized), ``enc_out`` within atol = rtol 1e-5,
   cross rings equal (quantized bytes but for rounding-boundary flips,
   at most 1 in 1000);
3h. speculative serving the same way (fp32, TF32 off), 2 cyclic 32-token
   prompts x 24 new tokens: gptneox-1b at full width cut to 2 layers
   (dense and fp4 KV; n-gram, and scripted ``draft_fn`` drafts of the
   card's non-speculative stream, accept-all and reject-all),
   mamba2-2.7b cut to 2 layers and jamba-v0.1-52b reduced at capacity
   factor 8.0 (n-gram): the speculative streams identical on card and
   CPU and to the card's non-speculative ones, ``spec_report`` equal on
   card and CPU;
3i. training card against CPU, fp32, TF32 off: qwen2.5-3b at full width
   cut to 2 layers, the same seeded weights and batches (2 x 64 tokens),
   3 steps at accum 1 then 3 at accum 2, each from the CPU's state
   (copied to the card after the step's comparison); after each step loss and
   grad_norm within rtol 1e-5, params rtol 1e-4 / atol 1e-6 (at most 1
   element in 100 of a leaf beyond, within 2 x the summed lr; the K
   bias, whose gradient is tiny, within that bound), ``m`` /
   ``v`` rtol 1e-4 / atol 1e-4 x the leaf's largest magnitude;
3j. SSM training card against CPU the same way (fp32, TF32 off for
   matmuls and cuDNN, at accum 1 each step from the CPU's state, 3i's
   tolerances; mamba2 one step, jamba 3): mamba2-2.7b at full width cut to 2 layers on 2 x
   300-token rows (padding, and two chunks at chunk 256), and
   jamba-v0.1-52b reduced (MoE, attention beside the SSM) on 2 x 64;
   the card's steps launch ``ssd_scan`` twice and ``ssd_scan_bwd`` once
   an SSM layer (and the attention kernels once and twice an attention
   layer), no plain version;
3k. data-parallel training card against CPU (fp32, TF32 off; NCCL on
   the card, gloo on the CPU, one rank): ``compressed_psum_tree`` on 1-D,
   2-D, 3-D, all-zero and outlier-row leaves bit-identical, whole and
   in blocks of 1000; the compressed DP step of qwen2.5-3b reduced (2
   layers) at accum 2, 3 steps each from the CPU's state, within 3i's
   tolerances (``m`` / ``v``: up to 1 element in 100 within one quantum
   of the compressed mean's move);
4. the probe suite ``repro_torch.launch.characterize`` on the card at the
   reference example's sizes, with every probe kernel's launch count and
   every plain version's call count set to 0 just before and read just
   after: each kernel launched, no plain version called; its tables and
   the measured figures beside the paper's GH100 column are printed, and
   a pointer chase over 1 GiB adds the HBM plateau.

Then it prints the card's name and power limit again, the ``kernels``
JSON line and, last, the ``ok`` line.
Any failure raises: the exit code is then non-zero and no result line
is printed.  Without a CUDA device it exits with code 2 at once.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FD_SOURCE = "src/repro_torch/csrc/flash_decode.cu"
FD_REPLACES = "src/repro/kernels/flash_decode.py:120"
FDQ_SOURCE = "src/repro_torch/csrc/flash_decode_quant.cu"
FDQ_REPLACES = "src/repro/kernels/flash_decode.py:182"
QMM_SOURCE = "src/repro_torch/csrc/qmatmul.cu"
QMM_REPLACES = "src/repro/kernels/qmatmul.py:76"
QMMP_REPLACES = "src/repro/kernels/qmatmul.py:106"
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:71"
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:100"
FAB_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
# no Pallas backward exists: the kernel is the backward of row 5's
# forward and computes what differentiating the XLA attention() computes
FAB_REPLACES = ("src/repro/kernels/flash_attention.py:100 (backward; "
                "src/repro/models/attention.py:221 attention(), "
                "differentiated)")
PROBE_SOURCES = {
    "dep_chain": ("src/repro_torch/csrc/probe_dep_chain.cu",
                  "src/repro/kernels/probe_dep_chain.py:40"),
    "chase": ("src/repro_torch/csrc/probe_chase.cu",
              "src/repro/kernels/probe_chase.py:37"),
    "mma_probe": ("src/repro_torch/csrc/probe_mma.cu",
                  "src/repro/kernels/probe_mma.py:48")}
SSDB_SOURCE = "src/repro_torch/csrc/ssd_scan_bwd.cu"
# no Pallas backward exists: the kernel is the backward of row 6's
# forward and computes what differentiating the XLA ssd_chunked computes
SSDB_REPLACES = ("src/repro/kernels/ssd_scan.py:71 (backward; "
                 "src/repro/models/ssm.py:82 ssd_chunked(), "
                 "differentiated)")
SOURCES = ("flash_decode", "flash_decode_quant", "qmatmul", "probe_dep_chain",
           "probe_chase", "probe_mma", "ssd_scan", "flash_attention",
           "flash_attention_bwd", "ssd_scan_bwd")
FORMATS = ("float8_e4m3fn", "float8_e5m2", "float6_e2m3fn",
           "float6_e3m2fn", "float4_e2m1fn")
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
COLD_BYTES = 120e6          # input sets cycled per timing: > the 50 MB L2
# the depth phases 2d (mamba2-2.7b, full: 64), 2f (gemma2-2b, 26), 2g
# (qwen2.5-3b, llama3.2-3b, gemma-2b: 36, 28, 18) and 2k (seamless: 12
# encoder and 12 decoder layers) are cut to, so that the whole run,
# speculation (2m, 3h) included, stays well inside its time limit on a
# slow host; 2m serves gptneox-1b and mamba2-2.7b at the same cut
CUT_LAYERS = 8
# phase 2r's windows: the counter updates a window runs for (the idle
# window and the sustained loops), the longest it may wait for them, and
# the served windows' count below which a line says so
WINDOW_UPDATES = 20
WINDOW_LIMIT_S = 30.0
FEW_UPDATES = 10
# the depth of phase 2n's restart check (a full-depth qwen2.5-3b train
# state is 31 GB a snapshot; at 2 layers ~4.7 GB, the embedding's share)
TRAIN_RESTART_LAYERS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


@dataclasses.dataclass
class Meter:
    """The card's NVML device, its energy counter's update period (an
    energy window polls every tenth of it) and phase 0's idle window."""
    device: object
    period_s: float
    idle: object

    def window(self):
        from repro_torch.core import nvml
        return nvml.EnergyWindow(self.device,
                                 poll_s=min(max(self.period_s / 10, 2e-4),
                                            5e-3))


def phase0_nvml() -> Meter:
    """NVML present, the card's NVML device found by torch's UUID with
    torch's name and UUID (``nvml.Device`` raises otherwise), then an
    energy window with the card idle (no kernel has run) that lasts until
    the counter has moved ``WINDOW_UPDATES`` times: the median time
    between its updates is the counter's period."""
    from repro_torch.core import nvml
    ok, why = nvml.available()
    if not ok:
        raise nvml.NvmlError(why)
    dev = nvml.Device()
    before = dev.readings()
    with nvml.EnergyWindow(dev, poll_s=1e-3) as idle:
        t_end = time.perf_counter() + WINDOW_LIMIT_S
        while (len(idle.points) <= WINDOW_UPDATES
               and time.perf_counter() < t_end):
            time.sleep(0.01)
    check_window("idle", idle)
    meter = Meter(dev, idle.period_s, idle)
    log(f"[nvml] {why}; cuda:{dev.index} {dev.torch_name} {dev.uuid} is "
        f"NVML's {dev.name!r} {dev.nvml_uuid}; before the idle window "
        f"{before.describe()}; the energy counter updates every "
        f"{idle.period_s * 1e3:.2f} ms (median of the window's "
        f"{idle.updates})")
    return meter


def check_window(label: str, w) -> None:
    """Phase 2r's gates on an energy window: the counter rose, and the
    mean power lies in (0, 1.05 x the enforced limit]."""
    if not (w.counter_joules > 0 and w.joules > 0):
        raise AssertionError(f"{label}: the energy counter did not rise "
                             f"({w.counter_joules} J)")
    if not 0 < w.watts <= 1.05 * w.end.limit_w:
        raise AssertionError(f"{label}: mean {w.watts:.1f} W outside (0, "
                             f"1.05 x {w.end.limit_w:.1f} W]")


def ring_slot_pos(pos: int, S: int) -> np.ndarray:
    """slot_pos of a ring of capacity S after writing positions 0..pos."""
    sp = np.full(S, -1, np.int32)
    p = np.arange(max(0, pos - S + 1), pos + 1, dtype=np.int32)
    sp[p % S] = p
    return sp


def decode_case(seed, b, S, hq, hkv, d, dtype, pos, head_major=False,
                pad=0):
    """q (b,1,hq,d), k/v (b,S,hkv,d) and slot_pos/pos on the card.  With
    ``head_major`` the cache is stored (b, hkv, S, d) and handed over as
    a strided (b, S, hkv, d) view; with ``pad`` it is a view into rows of
    d + pad elements (copies narrower than 16 bytes)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32)).to(dev, dtype)

    q = t((b, 1, hq, d))
    if head_major:
        k = t((b, hkv, S, d)).transpose(1, 2)
        v = t((b, hkv, S, d)).transpose(1, 2)
    else:
        k = t((b, S, hkv, d + pad))[..., :d]
        v = t((b, S, hkv, d + pad))[..., :d]
    pos = np.asarray(pos, np.int32)
    sp = np.stack([ring_slot_pos(int(p), S) for p in pos])
    return (q, k, v, torch.from_numpy(sp).to(dev),
            torch.from_numpy(pos).to(dev))


def quant_case(fmt, seed, b, S, hq, hkv, d, dtype, pos, head_major=False,
               pad=0):
    """q, a quantized cache dict (``quantize_kv`` of fp32 K/V on the
    card, in the engine's (b, S, hkv, ...) layout or, ``head_major``,
    stored (b, hkv, S, ...) and handed over as strided views; with
    ``pad``, code and scale rows are views into rows ``pad`` bytes longer)
    and pos."""
    from repro_torch.models.attention import quantize_kv
    q, k, v, sp, pos = decode_case(seed, b, S, hq, hkv, d, torch.float32,
                                   pos, head_major)
    kv = {"slot_pos": sp}
    for name, x in (("k", k), ("v", v)):
        if head_major:
            codes, scales = quantize_kv(x.transpose(1, 2), fmt)
            codes, scales = codes.transpose(1, 2), scales.transpose(1, 2)
        else:
            codes, scales = quantize_kv(x, fmt)
        if pad:
            rows = []
            for t in (codes, scales):
                buf = torch.zeros((*t.shape[:3], t.shape[3] + pad),
                                  dtype=torch.uint8, device=t.device)
                buf[..., :t.shape[3]] = t.view(torch.uint8)
                rows.append(buf[..., :t.shape[3]].view(t.dtype))
            codes, scales = rows
        kv[f"{name}_q"], kv[f"{name}_s"] = codes, scales
    return q.to(dtype), kv, pos


def visible(sp: torch.Tensor, pos: torch.Tensor, window=None):
    ok = (sp >= 0) & (sp <= pos[:, None])
    if window is not None:
        ok &= sp > pos[:, None] - window
    return ok


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def n_sets(set_bytes: int) -> int:
    """Input sets to cycle so that consecutive calls find theirs cold."""
    return max(2, math.ceil(COLD_BYTES / max(set_bytes, 1)))


def time_ms(fn, inputs, reps: int = 25, n: int = 12) -> float:
    """Device time of one call, in ms: the median over ``reps`` of a run
    of ``n`` calls between two CUDA events, divided by ``n``.  Each run
    is queued behind ``torch.cuda._sleep`` so the host's enqueueing
    overlaps it (the events then time the device, not the Python
    wrapper), and consecutive calls cycle through ``inputs`` (sets larger
    together than the 50 MB L2), so each call finds its inputs cold, as a
    decode step does."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(n):
            fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(nbytes_moved: int, flops: int, hbm: float, peak: float):
    """(bound ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate."""
    t_bytes = nbytes_moved / hbm * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_close(case: str, got, want, rows, tol) -> float:
    if not torch.isfinite(got).all():
        raise AssertionError(f"{case}: kernel output is not finite")
    err = (got[rows].float() - want[rows].float()).abs().max().item()
    log(f"[kernel] {case}: max_abs_err {err:.3e} over "
        f"{int(rows.sum())}/{len(rows)} rows (tol {tol})")
    torch.testing.assert_close(got[rows].float(), want[rows].float(), **tol)
    return err


def check_qmm(case: str, got, want, k: int) -> float:
    """bf16 out: within 2 bf16 ulps of the plain version plus the fp32
    summation-order tolerance 1e-4 * sqrt(k / 1024)."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{case}: kernel output is not finite")
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    atol = 1e-4 * math.sqrt(k / 1024)
    diff = (g - w).abs()
    bad = int((diff > 2 * ulp + atol).sum())
    err = diff.max().item()
    log(f"[kernel] {case}: max_abs_err {err:.3e}, {bad} outside 2 bf16 "
        f"ulps + {atol:.1e}")
    if bad:
        raise AssertionError(f"{case}: {bad} elements outside tolerance")
    return err


def profile_fn(fn, kernel_key: str):
    """``fn()`` under ``torch.profiler``: (device busy ms, ``kernel_key``
    device ms, kernel launches, top kernels by device time, ``kernel_key``
    launches) from the CUDA kernel events.  Only the CUDA activity is
    recorded: the CPU's op events are not read, and recording them too
    made the profile of a 16-step gptneox-1b decode block take about four
    times as long on the H100 machine's host, for the same kernels and
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    mine = [e for e in kern if kernel_key in e.key]
    kt = sum(e.self_device_time_total for e in mine) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return busy, kt, sum(e.count for e in kern), [
        (e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top
    ], sum(e.count for e in mine)


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #

def decode_bound(n_vis, hq, hkv, d, row_bytes, q, extra, hbm, peak):
    """(bound ms, bound_by, bytes) of one decode call: the visible K and V
    rows (``row_bytes`` a (slot, kv-head) row: values, or codes and
    scales), q read and the output written (q's size), slot_pos and pos;
    4 d flops per visible (slot, q-head)."""
    moved = 2 * n_vis * hkv * row_bytes + 2 * nbytes(q) + extra
    flops = 4 * n_vis * hq * d
    ms, by = bound(moved, flops, hbm, peak)
    return ms, by, moved


def check_bits(label: str, run, other) -> None:
    """``run()`` twice, then once more after ``other()`` (another grid, so
    the arrival counters must have been reset): the same bits each time."""
    first = run()
    again = run()
    other()
    third = run()
    torch.cuda.synchronize()
    raw = [x.view(torch.int16 if x.element_size() == 2 else torch.int32)
           for x in (first, again, third)]
    if not (torch.equal(raw[0], raw[1]) and torch.equal(raw[0], raw[2])):
        raise AssertionError(f"{label}: two calls are not bit-identical")
    log(f"[kernel] {label}: bit-identical over two calls and after a call "
        f"of another grid")


def _plan_note(pl, moved: int, ms: float) -> str:
    return (f"splits {pl.splits}, copy widths {pl.widths} B, "
            f"{moved / ms / 1e9:.3f} TB/s of visible bytes")


def phase1_flash_decode(hbm, peak_bf16):
    from repro_torch import compat
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain, plan)
    ragged = np.linspace(100, 1000, 8).astype(np.int32)
    wrapped = np.linspace(500, 3000, 8).astype(np.int32)
    serving = dict(b=8, S=1024, hq=16, hkv=16, d=128, dtype=torch.bfloat16)
    cases = {
        "a_serving_bf16": (dict(serving, seed=1, pos=ragged), {}),
        "b_serving_fp32": (dict(serving, seed=1, dtype=torch.float32,
                                pos=ragged), {}),
        "c_gqa_32_8_strided": (dict(serving, seed=2, hq=32, hkv=8,
                                    pos=ragged, head_major=True), {}),
        "d_window_softcap": (dict(serving, seed=3, pos=wrapped),
                             dict(window=256, softcap=50.0)),
        "e_S1000": (dict(serving, seed=4, S=1000, pos=ragged), {}),
        "f_empty_row": (dict(serving, seed=5, pos=ragged), {}),
        # one long row: b = 1, every tile of S = 4096 across the splits
        "g_long_row_S4096": (dict(serving, seed=6, b=1, S=4096,
                                  pos=np.array([4095], np.int32)), {}),
        # every visible slot in tile 0: one split works, the rest are empty
        "h_one_split_rows": (dict(serving, seed=7, pos=np.array(
            [0, 5, 20, 31, 31, 10, 1, 25], np.int32)), {}),
        # a 700-slot window of a wrapped ring, across every split
        "i_window_wrapped_splits": (dict(serving, seed=8, pos=np.linspace(
            1100, 5000, 8).astype(np.int32)), dict(window=700)),
        # rows of 132 bf16 (264 B): 8-byte copies
        "j_narrow_copy": (dict(serving, seed=9, pos=ragged, pad=4), {}),
    }
    sms = compat.sm_count(0)
    errors = {}
    for case, (spec, flags) in cases.items():
        q, k, v, sp, pos = decode_case(**spec)
        if case == "f_empty_row":
            sp[3] = -1
        pl = plan(q, k, v, sp, pos, sms)
        got = flash_decode(q, k, v, sp, pos, **flags)
        torch.cuda.synchronize()
        want = flash_decode_plain(q, k, v, sp, pos, **flags)
        torch.cuda.synchronize()
        rows = visible(sp, pos, flags.get("window")).any(dim=1)
        errors[case] = check_close(
            f"{case} (splits {pl.splits}, width {pl.widths[0]})", got, want,
            rows, TOL[q.dtype])
        if not (got[~rows] == 0).all():
            raise AssertionError(f"{case}: a row with no visible slot is "
                                 f"not 0")
        if case == "j_narrow_copy" and pl.widths[0] >= 16:
            raise AssertionError(f"{case}: copies {pl.widths} B wide")
    a = decode_case(**cases["a_serving_bf16"][0])
    g = decode_case(**cases["g_long_row_S4096"][0])
    check_bits("flash_decode (a)", lambda: flash_decode(*a),
               lambda: flash_decode(*g))

    # timing and bound at the serving shape (a) and at the serving step's
    # cache (s): every row at pos 300.  Input sets (67 MB of K/V each) are
    # cycled so that no call finds its K/V in L2
    entries = []
    for label, pos in (("a", ragged), ("s", np.full(8, 300, np.int32))):
        sets = [decode_case(**dict(serving, seed=s, pos=pos))
                for s in (11, 12, 13)]
        q, k, v, sp, pos_t = sets[0]
        b, _, hq, d = q.shape
        hkv = k.shape[2]
        scale = 1.0 / math.sqrt(d)
        err = errors["a_serving_bf16"]
        if label == "s":
            err = check_close("s_serving_step", flash_decode(*sets[0]),
                              flash_decode_plain(*sets[0]),
                              visible(sp, pos_t).any(dim=1),
                              TOL[torch.bfloat16])
        ms = time_ms(flash_decode, sets)
        plain_ms = time_ms(flash_decode_plain, sets)
        sdpa_sets = [(x[0].transpose(1, 2), x[1].transpose(1, 2),
                      x[2].transpose(1, 2),
                      visible(x[3], x[4])[:, None, None]) for x in sets]
        library_ms = time_ms(
            lambda qt, kt, vt, mask: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale), sdpa_sets)
        n_vis = int(visible(sp, pos_t).sum())   # visible (row, slot) pairs
        bound_ms, bound_by, moved = decode_bound(
            n_vis, hq, hkv, d, d * k.element_size(), q,
            nbytes(sp, pos_t), hbm, peak_bf16)
        pl = plan(q, k, v, sp, pos_t, sms)
        log(f"[kernel] timing at ({label}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {moved} B, {4 * n_vis * hq * d}"
            f" flop; {n_vis} visible slots); {_plan_note(pl, moved, ms)}")
        entries.append({
            "name": ("flash_decode" if label == "a" else
                     "flash_decode[s_b8_hq16_d128_S1024_pos300]"),
            "route": "cuda", "source": FD_SOURCE, "replaces": FD_REPLACES,
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    return entries


def phase1b_flash_decode_quant(hbm, peak_bf16):
    from repro_torch import compat
    from repro_torch.kernels.flash_decode_quant import (
        flash_decode_quant, flash_decode_quant_plain, plan)
    from repro_torch.models.attention import cache_kv
    ragged = np.linspace(100, 1000, 8).astype(np.int32)
    wrapped = np.linspace(500, 3000, 8).astype(np.int32)
    shape_a = dict(b=8, S=1024, hq=16, hkv=16, d=128, pos=ragged)
    bf16 = torch.bfloat16
    cases = {f"a_{fmt}_bf16": (fmt, dict(shape_a, seed=21, dtype=bf16), {})
             for fmt in FORMATS}
    cases.update({
        "b_float4_e2m1fn_fp32": ("float4_e2m1fn", dict(
            shape_a, seed=22, dtype=torch.float32), {}),
        "c_gqa_32_8_strided_fp4": ("float4_e2m1fn", dict(
            shape_a, seed=23, hq=32, hkv=8, dtype=bf16, head_major=True),
            {}),
        "d_window_softcap_fp8": ("float8_e4m3fn", dict(
            shape_a, seed=24, dtype=bf16, pos=wrapped),
            dict(window=256, softcap=50.0)),
        "f_empty_row_fp6": ("float6_e3m2fn", dict(
            shape_a, seed=25, dtype=bf16), {}),
        "g_long_row_S4096_fp8": ("float8_e4m3fn", dict(
            shape_a, seed=26, b=1, S=4096, dtype=bf16,
            pos=np.array([4095], np.int32)), {}),
        "h_one_split_rows_fp4": ("float4_e2m1fn", dict(
            shape_a, seed=27, dtype=bf16,
            pos=np.array([0, 5, 20, 31, 31, 10, 1, 25], np.int32)), {}),
        "i_window_wrapped_splits_fp6": ("float6_e2m3fn", dict(
            shape_a, seed=28, dtype=bf16,
            pos=np.linspace(1100, 5000, 8).astype(np.int32)),
            dict(window=700)),
        # code and scale rows one byte longer: 1-byte copies
        "j_narrow_copy_fp8": ("float8_e5m2", dict(
            shape_a, seed=29, dtype=bf16, pad=1), {}),
    })
    sms = compat.sm_count(0)
    errors = {}
    for case, (fmt, spec, flags) in cases.items():
        q, kv, pos = quant_case(fmt, **spec)
        if case.startswith("f_empty_row"):
            kv["slot_pos"][3] = -1
        pl = plan(q, kv, pos, fmt, sms)
        got = flash_decode_quant(q, kv, pos, fmt=fmt, **flags)
        torch.cuda.synchronize()
        want = flash_decode_quant_plain(q, kv, pos, fmt=fmt, **flags)
        torch.cuda.synchronize()
        rows = visible(kv["slot_pos"], pos, flags.get("window")).any(dim=1)
        errors[case] = check_close(
            f"{case} (splits {pl.splits}, widths {pl.widths})", got, want,
            rows, TOL[q.dtype])
        if not (got[~rows] == 0).all():
            raise AssertionError(f"{case}: a row with no visible slot is "
                                 f"not 0")
        if case.startswith("j_narrow_copy") and max(pl.widths) >= 16:
            raise AssertionError(f"{case}: copies {pl.widths} B wide")
    fmt = "float4_e2m1fn"
    a = quant_case(fmt, **dict(shape_a, seed=21, dtype=bf16))
    g = quant_case(fmt, **cases["g_long_row_S4096_fp8"][1])
    check_bits("flash_decode_quant fp4 (a)",
               lambda: flash_decode_quant(*a, fmt=fmt),
               lambda: flash_decode_quant(*g, fmt=fmt))

    entries = []
    for label, pos in (("a", ragged), ("s", np.full(8, 300, np.int32))):
        for fmt in ("float8_e4m3fn", "float4_e2m1fn"):
            spec = dict(shape_a, dtype=bf16, pos=pos)
            q, kv, pos_t = quant_case(fmt, **dict(spec, seed=30))
            per_set = nbytes(kv["k_q"], kv["k_s"], kv["v_q"], kv["v_s"])
            sets = [(q, kv, pos_t)] + [
                quant_case(fmt, **dict(spec, seed=31 + i))
                for i in range(n_sets(per_set) - 1)]

            def kern(q, kv, pos, fmt=fmt):
                return flash_decode_quant(q, kv, pos, fmt=fmt)

            def plain(q, kv, pos, fmt=fmt):
                return flash_decode_quant_plain(q, kv, pos, fmt=fmt)

            err = errors[f"a_{fmt}_bf16"]
            if label == "s":
                err = check_close(f"s_serving_step {fmt}", kern(*sets[0]),
                                  plain(*sets[0]),
                                  visible(kv["slot_pos"], pos_t).any(dim=1),
                                  TOL[bf16])
            ms = time_ms(kern, sets)
            plain_ms = time_ms(plain, sets)
            d = q.shape[-1]
            dense = []
            for qs, kvs, ps in sets:
                kd, vd = cache_kv(kvs, fmt, d, out_dtype=bf16)
                dense.append((qs.transpose(1, 2), kd.transpose(1, 2),
                              vd.transpose(1, 2),
                              visible(kvs["slot_pos"], ps)[:, None, None]))
            dense = dense[:n_sets(nbytes(*dense[0][1:3]))]
            library_ms = time_ms(
                lambda qt, kt, vt, mask: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=1.0 / math.sqrt(d)),
                dense)
            del dense
            hq = q.shape[2]
            hkv, stored_d = kv["k_q"].shape[2:]
            n_blk = kv["k_s"].shape[3]
            n_vis = int(visible(kv["slot_pos"], pos_t).sum())
            bound_ms, bound_by, moved = decode_bound(
                n_vis, hq, hkv, d, stored_d + n_blk, q,
                nbytes(kv["slot_pos"], pos_t), hbm, peak_bf16)
            pl = plan(q, kv, pos_t, fmt, sms)
            log(f"[kernel] flash_decode_quant {fmt} timing at ({label}): "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa over "
                f"the dequantized bf16 cache {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}: {moved} B, "
                f"{4 * n_vis * hq * d} flop; {n_vis} visible slots; "
                f"{len(sets)} input sets); {_plan_note(pl, moved, ms)}")
            shape = ("b8_hq16_d128_S1024" if label == "a" else
                     "s_b8_hq16_d128_S1024_pos300")
            entries.append({
                "name": f"flash_decode_quant[{fmt},{shape}]",
                "route": "cuda", "source": FDQ_SOURCE,
                "replaces": FDQ_REPLACES, "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "fmt": fmt})
            del sets
    return entries


def _qmm_case(seed, m, n, k):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device="cuda")
    return x, w


def phase1c_qmatmul(hbm, peak_bf16):
    from repro_torch.kernels.qmatmul import (
        pack_for_qmatmul, qmatmul, qmatmul_packed, qmatmul_packed_plain,
        qmatmul_plain, quantize_for_qmatmul)
    from repro_torch.serve.quant import dequantize_blockwise
    shapes = [(2048, 2048, 2048), (2048, 4096, 8192), (8, 8192, 2048),
              (200, 1024, 1024), (64, 8192, 2048), (65, 1024, 1024)]
    errors = {}
    for m, n, k in shapes:
        x, w = _qmm_case(m + n + k, m, n, k)
        for fmt in ("float8_e4m3fn", "float4_e2m1fn", "float6_e2m3fn",
                    "float6_e3m2fn"):
            qw, sc = quantize_for_qmatmul(w, fmt)
            got_c = qmatmul(x, qw, sc)
            torch.cuda.synchronize()
            if fmt == "float8_e4m3fn":
                errors[(fmt, m, n, k)] = check_qmm(
                    f"qmatmul {fmt} {m}x{n}x{k}", got_c,
                    qmatmul_plain(x, qw, sc), k)
                continue
            pw, sc2 = pack_for_qmatmul(w, fmt)
            got = qmatmul_packed(x, pw, sc2, fmt)
            torch.cuda.synchronize()
            errors[(fmt, m, n, k)] = check_qmm(
                f"qmatmul_packed {fmt} {m}x{n}x{k}", got,
                qmatmul_packed_plain(x, pw, sc2, fmt), k)
            if not (torch.equal(sc, sc2) and torch.equal(
                    got.view(torch.int16), got_c.view(torch.int16))):
                raise AssertionError(f"qmatmul_packed {fmt} {m}x{n}x{k} is "
                                     f"not bit-identical to qmatmul")
        log(f"[kernel] {m}x{n}x{k}: packed fp4/fp6 bit-identical to the "
            f"container kernel")

    entries = []
    for (m, n, k), name, fmt in [
            ((2048, 2048, 2048), "qmatmul", "float8_e4m3fn"),
            ((2048, 2048, 2048), "qmatmul_packed", "float4_e2m1fn"),
            ((8, 8192, 2048), "qmatmul", "float8_e4m3fn"),
            ((8, 8192, 2048), "qmatmul_packed", "float4_e2m1fn")]:
        x, w = _qmm_case(7, m, n, k)
        if name == "qmatmul":
            qw, sc = quantize_for_qmatmul(w, fmt)
            kern, plain = qmatmul, qmatmul_plain
            base = (x, qw, sc)
        else:
            qw, sc = pack_for_qmatmul(w, fmt)

            def kern(x, pw, sc, fmt=fmt):
                return qmatmul_packed(x, pw, sc, fmt)

            def plain(x, pw, sc, fmt=fmt):
                return qmatmul_packed_plain(x, pw, sc, fmt)

            base = (x, qw, sc)
        per_set = nbytes(*base)
        sets = [base] + [(x, qw.clone(), sc.clone())
                         for _ in range(n_sets(per_set) - 1)]
        ms = time_ms(kern, sets)
        plain_ms = time_ms(plain, sets[:2])
        wd = dequantize_blockwise(quantize_for_qmatmul(w, fmt)[0], sc,
                                  torch.bfloat16)
        lib_sets = [(x, wd)] + [(x, wd.clone()) for _ in range(
            n_sets(nbytes(x, wd)) - 1)]
        library_ms = time_ms(lambda a, b: torch.matmul(a, b.T), lib_sets)
        moved = nbytes(x, qw, sc) + m * n * 2
        flops = 2 * m * n * k
        bound_ms, bound_by = bound(moved, flops, hbm, peak_bf16)
        log(f"[kernel] {name} {fmt} {m}x{n}x{k}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"torch.matmul bf16 over the dequantized weight "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{moved} B, {flops} flop; {len(sets)} weight sets)")
        entries.append({
            "name": f"{name}[{fmt},{m}x{n}x{k}]", "route": "cuda",
            "source": QMM_SOURCE,
            "replaces": QMM_REPLACES if name == "qmatmul" else
            QMMP_REPLACES, "launches": None,
            "max_abs_err": errors[(fmt, m, n, k)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "kernel": name})
    return entries


def _probe_counters():
    """The probe kernels' launch counters and their plain versions' call
    counters, by kernel name."""
    from repro_torch.kernels import probe_chase as pc
    from repro_torch.kernels import probe_dep_chain as pdc
    from repro_torch.kernels import probe_mma as pm
    return {"dep_chain": (pdc.dep_chain, pdc.dep_chain_plain),
            "chase": (pc.chase, pc.chase_plain),
            "mma_probe": (pm.mma_probe, pm.mma_probe_plain)}


def _check_mma(case, got, want, k, kind):
    """``kind`` "bf16" / "fp16": bf16 / fp16 out, within 1 ulp of the type
    + 1e-5 sqrt(k); "tf32": fp32 inputs rounded to TF32, atol 2^-8
    sqrt(k); "fp32": bf16 inputs, fp32 out (summation order only), atol
    1e-5 sqrt(k)."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{case}: kernel output is not finite")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if kind in ("bf16", "fp16"):
        bits = 8 if kind == "bf16" else 11
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - bits)
        tol = ulp + 1e-5 * math.sqrt(k)
        label = f"1 {kind} ulp + 1e-5 sqrt(k)"
    elif kind == "tf32":
        tol = torch.full_like(w, 2.0 ** -8 * math.sqrt(k))
        label = "2^-8 sqrt(k)"
    else:
        tol = torch.full_like(w, 1e-5 * math.sqrt(k))
        label = "1e-5 sqrt(k)"
    bad = int((diff > tol).sum())
    err = diff.max().item()
    log(f"[probe] {case}: max_abs_err {err:.3e}, {bad} outside {label}")
    if bad:
        raise AssertionError(f"{case}: {bad} elements outside tolerance")
    return err


def phase1d_probes(model):
    """The probe kernels against their plain versions, then their times
    at the characterize path's shapes."""
    from repro_torch.core.probes.memory import _permutation_chain
    from repro_torch.kernels import probe_chase as pc
    from repro_torch.kernels import probe_dep_chain as pdc
    from repro_torch.kernels import probe_mma as pm
    hbm, peak_bf16 = model.hbm.bandwidth_Bps, model.peak_flops["bfloat16"]
    peak_f32 = model.vector_flops["float32"]
    errors = {}

    # chase: exact, against the plain walk and the numpy oracle
    t0 = time.perf_counter()
    for rows in (16, 4096, 1 << 17):
        buf = pc.make_chase_buffer(rows, seed=rows).cuda()
        for steps in (50, 8192):
            got = int(pc.chase(buf, steps))
            torch.cuda.synchronize()
            want = int(pc.chase_plain(buf, steps))
            oracle = pc.chase_reference(buf[:, :1].cpu().numpy(), steps)
            if not got == want == oracle:
                raise AssertionError(f"chase rows={rows} steps={steps}: "
                                     f"kernel {got}, plain {want}, numpy "
                                     f"{oracle}")
    for n in (1 << 12, 1 << 20, 1 << 24):
        nxt = _permutation_chain(n, 0)
        buf = torch.from_numpy(nxt.copy()).view(n, 1).cuda()
        got = int(pc.chase(buf, 8192))
        torch.cuda.synchronize()
        want = int(pc.chase_plain(buf, 8192))
        if not got == want == pc.chase_reference(nxt[:, None], 8192):
            raise AssertionError(f"chase flat n={n}: kernel {got}, plain "
                                 f"{want}")
    errors["chase"] = 0.0
    log(f"[probe] chase: final index exact at rows 16/4096/2^17 and flat "
        f"2^12/2^20/2^24 ({time.perf_counter() - t0:.1f} s)")

    # dep_chain: the public contract, then every compute workload
    for n, ilp in ((10, 1), (100, 2), (57, 4), (256, 8)):
        rng = np.random.default_rng(n)
        x = torch.from_numpy(rng.standard_normal((ilp, 8, 128),
                                                 np.float32)).cuda()
        got = pdc.dep_chain(x, n, ilp)
        torch.cuda.synchronize()
        err = pdc.assert_chain_close(
            {"float": got}, {"float": pdc.dep_chain_plain(x, n)}, n,
            reference_constants=False, case=f"dep_chain ({n}, {ilp})")
        log(f"[probe] dep_chain chain {n} ilp {ilp}: max_abs_err {err:.3e}")
    for w in ("int32", "fp32", "fp64", "mixed1", "mixed2"):
        for lanes in (1, 4096):
            for n in ((0, 1, 7, 40) if w == "mixed2" else (0, 1, 7, 40, 256)):
                run = pdc.run_chain(w, n, lanes, device="cuda")
                torch.cuda.synchronize()
                err = pdc.assert_chain_close(
                    run.values, pdc.chain_plain(w, n, lanes, device="cuda"),
                    n, case=f"{w} lanes {lanes} chain {n}")
                if (w, lanes, n) == ("fp32", 4096, 256):
                    errors["dep_chain"] = err
    log("[probe] dep_chain: 5 workloads x lanes 1/4096 x chains 0..256 "
        "within tolerance (int32, fp32, mixed1 and mixed2 exact, mixed2 up "
        "to 40; fp64 within (n + 1) ulps)")
    run = pdc.run_chain("fp32", 256, 4096, device="cuda")
    per_sm = sorted(collections.Counter(run.smid.tolist()).values())
    log(f"[probe] completion-latency launch: 4096 threads in blocks of "
        f"{pdc.MAX_BLOCK}; threads per SM {per_sm}")

    # mma_probe: every dtype and ilp, shapes on and off the block tile,
    # y broadcast over the products (mma_probe passes y.expand)
    kinds = {torch.bfloat16: "bf16", torch.float16: "fp16",
             torch.float32: "tf32"}
    for dt, kind in kinds.items():
        for ilp in range(1, 9):
            for m, k, n in ((256, 256, 128), (128, 128, 128), (48, 48, 72)):
                g = torch.Generator(device="cuda").manual_seed(m + ilp)
                x = torch.randn((ilp, m, k), generator=g, device="cuda")
                y = torch.randn((k, n), generator=g, device="cuda")
                x, y = x.to(dt), y.to(dt)
                got = pm.mma_probe(x, y, bm=16, bn=8, bk=16, ilp=ilp)
                torch.cuda.synchronize()
                _check_mma(f"{kind} mma_probe ilp {ilp} {m}x{k}x{n}", got,
                           pm.mma_probe_plain(x, y, dt), k, kind)
    g = torch.Generator(device="cuda").manual_seed(3)
    for shape in ((5, 3, 48, 48), (5, 3, 48, 72)):
        a = torch.randn(shape[:3] + (48,), generator=g,
                        device="cuda").bfloat16()
        b = torch.randn(shape[:2] + (48, shape[3]), generator=g,
                        device="cuda").bfloat16()
        _check_mma(f"bf16 products {shape}", pm.mma_products(a, b),
                   pm.mma_probe_plain(a, b, torch.float32), 48, "fp32")
    a = torch.randn((16, 4, 128, 128), generator=g, device="cuda").bfloat16()
    b = torch.randn((16, 4, 128, 128), generator=g, device="cuda").bfloat16()
    got = pm.mma_products(a, b)
    torch.cuda.synchronize()
    errors["mma_probe"] = _check_mma(
        "bf16 products batch 16 ilp 4 128^3", got,
        pm.mma_probe_plain(a, b, torch.float32), 128, "fp32")

    # timing at the characterize path's shapes
    entries = []
    values = {"float": torch.empty((1, 4096), device="cuda")}

    def chain_kernel():
        return pdc._launch("fp32", values, 256, False, unrolled=True)

    ms = time_ms(chain_kernel, [()])
    plain_ms = time_ms(lambda: pdc.chain_plain("fp32", 256, 4096,
                                               device="cuda"), [()],
                       reps=5, n=2)
    moved = 4096 * (4 + 8 + 8 + 4)       # values, cycles, ns, smid out
    flops = 2 * 4096 * 256
    bound_ms, bound_by = bound(moved, flops, hbm, peak_f32)
    log(f"[probe] dep_chain fp32 lanes 4096 chain 256: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
        f"{moved} B, {flops} flop at fp32 {peak_f32 / 1e12:g} TFLOP/s)")
    entries.append(("dep_chain[fp32,lanes4096,chain256]", ms, plain_ms,
                    bound_ms, bound_by, None))

    n = 1 << 24
    buf = torch.from_numpy(_permutation_chain(n, 0).copy()).view(n, 1)
    buf = buf.cuda()
    ms = time_ms(lambda: pc._launch(buf, 8192), [()], reps=7, n=3)
    plain_ms = time_ms(lambda: pc.chase_plain(buf, 8192), [()], reps=3, n=1)
    moved = 8192 * 4 + 3 * 8               # the walk's loads, out
    bound_ms, bound_by = bound(moved, 0, hbm, peak_f32)
    log(f"[probe] chase flat 2^24 (64 MiB) 8192 steps: kernel {ms:.4f} ms "
        f"(warm-up sweep + walk), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}: {moved} B)")
    entries.append(("chase[flat_2^24,steps8192]", ms, plain_ms, bound_ms,
                    bound_by, None))
    del buf

    ms = time_ms(pm.mma_products, [(a, b)])
    plain_ms = time_ms(lambda a, b: pm.mma_probe_plain(a, b, torch.float32),
                       [(a, b)])
    a3, b3 = a.view(-1, 128, 128), b.view(-1, 128, 128)
    library_ms = time_ms(torch.bmm, [(a3, b3)])
    moved = nbytes(a, b) + a.shape[0] * a.shape[1] * 128 * 128 * 4
    flops = 2 * 128 ** 3 * 16 * 4
    bound_ms, bound_by = bound(moved, flops, hbm, peak_bf16)
    log(f"[probe] mma_probe bf16 batch 16 ilp 4 128^3: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"torch.bmm bf16 {library_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}: {moved} B, {flops} flop)")
    entries.append(("mma_probe[bf16,batch16_ilp4_128^3]", ms, plain_ms,
                    bound_ms, bound_by, library_ms))
    out = []
    for name, ms, plain_ms, bound_ms, bound_by, library_ms in entries:
        kernel = name.split("[")[0]
        source, replaces = PROBE_SOURCES[kernel]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": None,
                    "max_abs_err": errors[kernel], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms})
    return out


def ssd_case(seed, bt, s, h, p, n, x_dtype=torch.float32,
             bc_dtype=torch.float32, with_state=True):
    """x, dt_a, b, c and the initial state on the card: unit-scale
    inputs (those of the reference's kernel test) with model-like decays,
    dt_a = dt * -exp(A_log), A_log per head as ``init_ssm`` sets it and
    dt log-uniform in [1e-3, 1e-1] (the range of softplus(dt_bias)):
    dt_a in [-1.6, -0.001]."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=0.5, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * scale).to("cuda", dtype)

    a = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), (bt, s, h)))
    dt_a = torch.from_numpy((dt * a).astype(np.float32)).to("cuda")
    return (t((bt, s, h, p), dtype=x_dtype), dt_a,
            t((bt, s, n), dtype=bc_dtype), t((bt, s, n), dtype=bc_dtype),
            t((bt, h, p, n)) if with_state else None)


def _pad_seq(tensors, chunk):
    s = tensors[0].shape[1]
    pad = (-s) % chunk
    return [F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in tensors]


def ssd_bound(x, dt_a, b, c, state, chunk, hbm, peak):
    """(bound ms, bound_by, bytes, flops) of one call: each input read
    once, y and the final state written once; 2q²n + 2q²p + 4qpn flops
    per (row, head, chunk)."""
    bt, s, h, p = x.shape
    n = b.shape[-1]
    moved = 2 * nbytes(x) + nbytes(dt_a, b, c) + bt * h * p * n * 4 * (
        2 if state is not None else 1)
    flops = bt * h * (s // chunk) * (2 * chunk * chunk * (n + p)
                                     + 4 * chunk * p * n)
    return (*bound(moved, flops, hbm, peak), moved, flops)


def phase1e_ssd_scan(model):
    """``ssd_scan`` against ``ssd_scan_plain`` on the card: the kernel in
    split TF32 on the tensor cores, the plain version in fp32; tolerance
    atol 2e-4 on y and the state, the reference kernel test's own against
    its sequential oracle (a bf16 y may also differ by one bf16 ulp, rtol
    2^-7: both sides round their fp32 y to bf16).  Cases (f)-(k) are the
    edges of ``ssd_scan.plan``.  Then the times at (a) and (b)."""
    from repro_torch.kernels.ssd_scan import (plan, ssd_scan, ssd_scan_plain,
                                              ssd_scan_states)
    hbm, peak_bf16 = model.hbm.bandwidth_Bps, model.peak_flops["bfloat16"]
    peak_f32 = model.vector_flops["float32"]
    peak_tf32 = model.peak_flops["float32"]
    bf16 = torch.bfloat16
    serving = dict(bt=1, s=256, h=80, p=64, n=128, bc_dtype=bf16)
    cases = {
        # the serving path's call: x, dt_a fp32, b / c bf16, a carry in
        "a_serving": (dict(serving, seed=41), 256),
        # the carry inside the kernel crosses 8 chunks
        "b_bt8_s2048": (dict(serving, seed=42, bt=8, s=2048), 256),
        "c_s100_chunk32": (dict(seed=43, bt=2, s=100, h=4, p=64, n=128),
                           32),
        "d_bf16_x_and_bc": (dict(serving, seed=44, x_dtype=bf16), 256),
        "e_fp32_no_state": (dict(serving, seed=45, bc_dtype=torch.float32,
                                 with_state=False), 256),
        # the plan's edges
        "f_p48_n64_chunk32": (dict(seed=46, bt=2, s=96, h=4, p=48, n=64),
                              32),
        "g_chunk1024_h4": (dict(serving, seed=47, s=2048, h=4), 1024),
        "h_bt8_h80_chunk1024": (dict(serving, seed=48, bt=8, s=1024), 1024),
        "i_bt2_h1": (dict(serving, seed=49, bt=2, h=1), 256),
        "j_p48_h80": (dict(serving, seed=50, p=48), 256),
        "k_p18_n20_unaligned": (dict(seed=51, bt=2, s=128, h=3, p=18, n=20,
                                     bc_dtype=bf16), 64),
    }
    errors = {}
    for case, (spec, chunk) in cases.items():
        args = ssd_case(**spec)
        x, dt_a, b, c, state = args
        y, st = ssd_scan(x, dt_a, b, c, chunk=chunk, initial_state=state)
        padded = _pad_seq(args[:4], chunk)
        y_st, st_st, states = ssd_scan_states(*padded, chunk, state)
        torch.cuda.synchronize()
        y_want, st_want, states_want = ssd_scan_plain(*padded, chunk, state,
                                                      states=True)
        torch.cuda.synchronize()
        y_want = y_want[:, :x.shape[1]]
        if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
            raise AssertionError(f"ssd_scan {case}: output is not finite")
        rtol = 2.0 ** -7 if x.dtype == bf16 else 0.0
        err = max((y.float() - y_want.float()).abs().max().item(),
                  (st - st_want).abs().max().item())
        pl = plan(*_pad_seq(args[:4], chunk), chunk, state)
        log(f"[kernel] ssd_scan {case}: max_abs_err {err:.3e} (y and state;"
            f" |y| max {y.float().abs().max().item():.2f}; tol atol 2e-4, "
            f"rtol {rtol}); plan: {pl.splits} slices of {pl.pw}, "
            f"{pl.blocks} blocks, {pl.blocks_per_sm} an SM, "
            f"{pl.smem_bytes} B, {'16-byte' if pl.vec else 'element'} "
            f"copies")
        torch.testing.assert_close(y.float(), y_want.float(), atol=2e-4,
                                   rtol=rtol)
        torch.testing.assert_close(st, st_want, atol=2e-4, rtol=0.0)
        errors[case] = err
        # training's forward: the same y and state, and the entering states
        states_err = (states - states_want).abs().max().item()
        same = (torch.equal(y_st[:, :x.shape[1]], y)
                and torch.equal(st_st, st))
        log(f"[kernel] ssd_scan_states {case}: states max_abs_err "
            f"{states_err:.3e} (tol atol 2e-4; {states.shape[1]} chunks); y "
            f"and the final state the same bits as without the store: "
            f"{same}")
        torch.testing.assert_close(states, states_want, atol=2e-4, rtol=0.0)
        if not same:
            raise AssertionError(f"ssd_scan_states {case}: storing the "
                                 f"states changed y or the final state")
        errors[case + "_states"] = max(err, states_err)
        del y_st, st_st, states, states_want

    entries = []
    for case, reps in (("a_serving", (25, 12)), ("b_bt8_s2048", (7, 3))):
        spec, chunk = cases[case]
        base = ssd_case(**spec)
        per_set = nbytes(*(t for t in base if t is not None))
        sets = [base] + [ssd_case(**dict(spec, seed=spec["seed"] + 100 + i))
                         for i in range(n_sets(per_set) - 1)]

        def kern(x, dt_a, b, c, state, chunk=chunk):
            return ssd_scan(x, dt_a, b, c, chunk=chunk, initial_state=state)

        def plain(x, dt_a, b, c, state, chunk=chunk):
            return ssd_scan_plain(x, dt_a, b, c, chunk, state)

        def kern_states(x, dt_a, b, c, state, chunk=chunk):
            return ssd_scan_states(x, dt_a, b, c, chunk, state)

        ms = time_ms(kern, sets, *reps)
        states_ms = time_ms(kern_states, sets, *reps)
        plain_ms = time_ms(plain, sets[:2], reps=5, n=2)
        bound_ms, bound_by, moved, flops = ssd_bound(*base, chunk, hbm,
                                                     peak_bf16)
        x = base[0]
        states_bytes = (x.shape[0] * (x.shape[1] // chunk) * x.shape[2]
                        * x.shape[3] * base[2].shape[-1] * 4)
        states_bound, states_by = bound(moved + states_bytes, flops, hbm,
                                        peak_bf16)
        log(f"[kernel] ssd_scan {case} timing: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {moved} B, {flops} flop "
            f"at bf16 {peak_bf16 / 1e12:g} TFLOP/s); the same flops at the "
            f"fp32 CUDA-core rate {peak_f32 / 1e12:g} TFLOP/s: "
            f"{flops / peak_f32 * 1e3:.4f} ms; as split TF32 (3 x the "
            f"flops at {peak_tf32 / 1e12:g} TFLOP/s): "
            f"{3 * flops / peak_tf32 * 1e3:.4f} ms; {len(sets)} input sets; "
            f"storing the states ({states_bytes} B) {states_ms:.4f} ms, "
            f"bound {states_bound:.4f} ms")
        for suffix, t, bd, by in (("", ms, bound_ms, bound_by),
                                  ("_states", states_ms, states_bound,
                                   states_by)):
            entries.append({
                "name": f"ssd_scan[{case}{suffix},bt{x.shape[0]}_s"
                        f"{x.shape[1]}_h{x.shape[2]}_p{x.shape[3]}_n"
                        f"{base[2].shape[-1]}]",
                "route": "cuda", "source": SSD_SOURCE,
                "replaces": SSD_REPLACES, "launches": None,
                "max_abs_err": errors[case + suffix], "ms": t,
                "plain_ms": plain_ms, "bound_ms": bd, "bound_by": by,
                # no single PyTorch call computes an SSD scan
                "library_ms": None})
    return entries


def fa_case(seed, b, sq, skv, hq, hkv, d, dtype):
    """q (b, sq, hq, d), k / v (b, skv, hkv, d), N(0, 1), on the card."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32)).to("cuda", dtype)

    return t((b, sq, hq, d)), t((b, skv, hkv, d)), t((b, skv, hkv, d))


def fa_visible(sq, skv, causal=True, window=None, q_offset=0, **_):
    """(rows that see a key (sq,) bool on the card, visible (query, key)
    pairs per (row of the batch, head))."""
    qp = q_offset + torch.arange(sq, device="cuda")[:, None]
    kp = torch.arange(skv, device="cuda")[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device="cuda")
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    return ok.any(dim=1), int(ok.sum())


def phase1f_flash_attention(model):
    """``flash_attention`` against ``flash_attention_plain`` on the card
    (tolerances of the reference's kernel test: fp32 atol 2e-5, bf16 atol
    2e-2, on the rows that see a key; a row that sees none must be 0),
    then the times at (a) and (b): kernel, plain version and SDPA with
    ``is_causal`` (a yardstick; the port never calls it), and the kernel
    again storing each row's LSE as training's forward does
    (``flash_attention_lse``, entries ``<case>_lse``; every case without
    a ``q_offset`` also holds that call's output to the plain version
    and to the call storing no LSE, bit for bit)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_lse, flash_attention_plain,
        wgmma_rs_unit_tile)
    hbm, peak_bf16 = model.hbm.bandwidth_Bps, model.peak_flops["bfloat16"]
    peak_f32 = model.vector_flops["float32"]
    bf16, f32 = torch.bfloat16, torch.float32
    for n in (64, 128):
        for kk in (16, 32, 48, 64):
            g = torch.Generator(device="cuda").manual_seed(kk + n)
            a = torch.randn((64, kk), generator=g, device="cuda").to(bf16)
            b = torch.randn((kk, n), generator=g, device="cuda").to(bf16)
            got = wgmma_rs_unit_tile(a, b)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, a.float() @ b.float(),
                                       rtol=1e-5, atol=1e-5)
    log("[kernel] wgmma.cuh MmaRS + desc_sw128_mn unit tile: (64, k) @ "
        "(k, n), k 16..64, n 64 / 128, within atol 1e-5 of fp32")
    gptneox = dict(b=8, sq=2048, skv=2048, hq=16, hkv=16, d=128)
    cases = {
        "a_gptneox_bf16": (dict(gptneox, seed=51, dtype=bf16), {}),
        "b_gptneox_fp32": (dict(gptneox, seed=52, dtype=f32), {}),
        "c_gqa_32_8_d64": (dict(seed=53, b=4, sq=384, skv=1000, hq=32,
                                hkv=8, d=64, dtype=bf16), {}),
        "d_window256_softcap50": (dict(gptneox, seed=54, b=2, dtype=bf16),
                                  dict(window=256, softcap=50.0)),
        "e_non_causal": (dict(seed=55, b=4, sq=1024, skv=1024, hq=16,
                              hkv=16, d=128, dtype=bf16),
                         dict(causal=False)),
        "f_ragged_sq96_skv130": (dict(seed=56, b=4, sq=96, skv=130, hq=16,
                                      hkv=16, d=128, dtype=bf16), {}),
        "g_q_offset512": (dict(seed=57, b=4, sq=128, skv=640, hq=16, hkv=16,
                               d=128, dtype=bf16), dict(q_offset=512)),
        "h_d256": (dict(seed=58, b=2, sq=1024, skv=1024, hq=8, hkv=4, d=256,
                        dtype=bf16), {}),
    }
    errors = {}
    for case, (spec, flags) in cases.items():
        q, k, v = fa_case(**spec)
        got = flash_attention(q, k, v, **flags)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, **flags)
        torch.cuda.synchronize()
        rows, _ = fa_visible(spec["sq"], spec["skv"], **flags)
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {case}: not finite")
        if (got[:, ~rows] != 0).any():
            raise AssertionError(f"flash_attention {case}: a row that sees "
                                 f"no key is not 0")
        atol = 2e-5 if q.dtype == f32 else 2e-2
        err = (got[:, rows].float() - want[:, rows].float()).abs().max()
        errors[case] = err.item()
        log(f"[kernel] flash_attention {case}: max_abs_err "
            f"{errors[case]:.3e} over {int(rows.sum())}/{len(rows)} rows "
            f"(tol atol {atol})")
        torch.testing.assert_close(got[:, rows].float(),
                                   want[:, rows].float(), atol=atol,
                                   rtol=0.0)
        if not flags.get("q_offset"):
            # the call that also stores the LSE (training's forward): its
            # own error against the plain version, and the same bits
            got_lse, _ = flash_attention_lse(q, k, v, **flags)
            torch.cuda.synchronize()
            err = (got_lse[:, rows].float() - want[:, rows].float()).abs()
            errors[case + "_lse"] = err.max().item()
            log(f"[kernel] flash_attention_lse {case}: max_abs_err "
                f"{errors[case + '_lse']:.3e} (tol atol {atol}); the same "
                f"bits as the call storing no LSE: "
                f"{torch.equal(got_lse, got)}")
            torch.testing.assert_close(got_lse[:, rows].float(),
                                       want[:, rows].float(), atol=atol,
                                       rtol=0.0)
            if not torch.equal(got_lse, got):
                raise AssertionError(f"flash_attention_lse {case}: the "
                                     f"output differs from the call that "
                                     f"stores no LSE")
            del got_lse
        del q, k, v, got, want
    torch.cuda.empty_cache()

    entries = []
    for case, peak, peak_name in (("a_gptneox_bf16", peak_bf16, "bf16"),
                                  ("b_gptneox_fp32", peak_f32, "fp32")):
        spec = cases[case][0]
        base = fa_case(**spec)
        sets = [base] + [fa_case(**dict(spec, seed=spec["seed"] + 100 + i))
                         for i in range(n_sets(nbytes(*base)) - 1)]

        def kern(q, k, v):
            return flash_attention(q, k, v)

        ms = time_ms(kern, sets)
        lse_ms = time_ms(lambda q, k, v: flash_attention_lse(q, k, v), sets)
        plain_ms = time_ms(flash_attention_plain, sets[:2], reps=5, n=2)
        sdpa_sets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                     for s in sets]
        library_ms = time_ms(
            lambda qt, kt, vt: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), sdpa_sets)
        del sdpa_sets
        q = base[0]
        _, pairs = fa_visible(spec["sq"], spec["skv"])
        moved = nbytes(*base) + nbytes(q)          # q, k, v in; out
        flops = 4 * spec["d"] * pairs * spec["b"] * spec["hq"]
        bound_ms, bound_by = bound(moved, flops, hbm, peak)
        log(f"[kernel] flash_attention {case} timing: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"sdpa is_causal {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {moved} B at {hbm / 1e12:g} TB/s, {flops} flop "
            f"at {peak_name} {peak / 1e12:g} TFLOP/s); with the LSE store "
            f"{lse_ms:.4f} ms; {len(sets)} input sets")
        for suffix, t in (("", ms), ("_lse", lse_ms)):
            entries.append({
                "name": f"flash_attention[{case}{suffix},b{spec['b']}_s"
                        f"{spec['sq']}_hq{spec['hq']}_d{spec['d']}_causal]",
                "route": "cuda", "source": FA_SOURCE,
                "replaces": FA_REPLACES, "launches": None,
                "max_abs_err": errors[case + suffix], "ms": t,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms})
        del sets, base, q
        torch.cuda.empty_cache()
    return entries


def cross_case(seed, b, S, h, d, src_lens, dtype=torch.bfloat16):
    """q (b, 1, h, d) at ``dtype``, a cross ring's fp32 K / V (b, S, h,
    d) on the card whose row r holds source positions 0..src_lens[r]-1
    and then slot_pos -1 (a shorter source's tail), and pos (b,) = 2^30:
    the decoder's cross-attention step."""
    q, k, v, _, _ = decode_case(seed, b, S, h, h, d, torch.float32,
                                np.zeros(b, np.int32))
    sp = torch.full((b, S), -1, dtype=torch.int32, device="cuda")
    for r, n in enumerate(src_lens):
        sp[r, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    from repro_torch.models.transformer import CROSS_POS
    pos = torch.full((b,), CROSS_POS, dtype=torch.int32, device="cuda")
    return q.to(dtype), k, v, sp, pos


def phase1g_modal_shapes(hbm, peak_bf16):
    """The shapes the encoder-decoder path adds (seamless-m4t-medium: 16
    heads of 64), each kernel against its plain version with phase 1's
    and 1f's tolerances, then timed beside its bound and SDPA (a
    yardstick): (x) the decoder's cross-attention step, ``flash_decode``
    and ``flash_decode_quant`` (fp8, fp4) at b 8 over a ring of 1024
    source slots, hq = hkv = 16, d 64, query position 2^30, sources of
    600..1000 frames (a ragged tail of slot_pos -1), bf16 q; (y) the
    encoder's ``flash_attention``, bf16, non-causal, b 8, sq = skv =
    1000; (z) whole-sequence cross-attention, non-causal, sq 16 over skv
    1000.  Returns the ``kernels`` entries (launches filled by 2k)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain)
    from repro_torch.kernels.flash_decode_quant import (
        flash_decode_quant, flash_decode_quant_plain)
    from repro_torch.models.attention import cache_kv, quantize_kv
    bf16 = torch.bfloat16
    b, S, h, d = 8, 1024, 16, 64
    src = np.linspace(600, 1000, b).astype(int)
    entries = []
    for fmt in (None, "float8_e4m3fn", "float4_e2m1fn"):
        def make(seed, fmt=fmt):
            q, k, v, sp, pos = cross_case(seed, b, S, h, d, src)
            if fmt is None:
                return q, {"k": k.to(bf16), "v": v.to(bf16),
                           "slot_pos": sp}, pos
            kv = {"slot_pos": sp}
            for name, x in (("k", k), ("v", v)):
                kv[f"{name}_q"], kv[f"{name}_s"] = quantize_kv(x, fmt)
            return q, kv, pos

        def kern(q, kv, pos, fmt=fmt):
            if fmt is None:
                return flash_decode(q, kv["k"], kv["v"], kv["slot_pos"], pos)
            return flash_decode_quant(q, kv, pos, fmt=fmt)

        def plain(q, kv, pos, fmt=fmt):
            if fmt is None:
                return flash_decode_plain(q, kv["k"], kv["v"],
                                          kv["slot_pos"], pos)
            return flash_decode_quant_plain(q, kv, pos, fmt=fmt)

        base = make(61)
        per_set = nbytes(*(t for n, t in base[1].items() if n != "slot_pos"))
        sets = [base] + [make(62 + i) for i in range(n_sets(per_set) - 1)]
        q, kv, pos = base
        rows = visible(kv["slot_pos"], pos).any(dim=1)
        label = f"x_cross_{fmt or 'bf16'}_b8_hq16_d64_S1024_pos2^30"
        err = check_close(label, kern(*base), plain(*base), rows,
                          TOL[bf16])
        ms = time_ms(kern, sets)
        plain_ms = time_ms(plain, sets)
        dense = []
        for qs, kvs, ps in sets:
            kd, vd = cache_kv(kvs, fmt, d, out_dtype=bf16)
            dense.append((qs.transpose(1, 2), kd.transpose(1, 2),
                          vd.transpose(1, 2),
                          visible(kvs["slot_pos"], ps)[:, None, None]))
        dense = dense[:n_sets(nbytes(*dense[0][1:3]))]
        library_ms = time_ms(
            lambda qt, kt, vt, mask: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=1.0 / math.sqrt(d)),
            dense)
        del dense
        n_vis = int(visible(kv["slot_pos"], pos).sum())
        row_bytes = (kv["k_q"].shape[3] + kv["k_s"].shape[3] if fmt
                     else d * kv["k"].element_size())
        bound_ms, bound_by, moved = decode_bound(
            n_vis, h, h, d, row_bytes, q, nbytes(kv["slot_pos"], pos), hbm,
            peak_bf16)
        log(f"[kernel] {label} timing: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {moved} B, {4 * n_vis * h * d} "
            f"flop; {n_vis} visible slots; {len(sets)} input sets)")
        name = "flash_decode_quant" if fmt else "flash_decode"
        entries.append({
            "name": f"{name}[{label}]", "route": "cuda",
            "source": FDQ_SOURCE if fmt else FD_SOURCE,
            "replaces": FDQ_REPLACES if fmt else FD_REPLACES,
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "path": f"2k seamless {fmt or 'dense'} serving"})
        del sets, base, q, kv

    for label, sq, skv in (("y_encoder", 1000, 1000),
                           ("z_cross_prompt", 16, 1000)):
        spec = dict(b=b, sq=sq, skv=skv, hq=h, hkv=h, d=d, dtype=bf16)
        base = fa_case(seed=71 + sq, **spec)
        got = flash_attention(*base, causal=False)
        torch.cuda.synchronize()
        want = flash_attention_plain(*base, causal=False)
        err = (got.float() - want.float()).abs().max().item()
        log(f"[kernel] flash_attention {label} (non-causal, sq {sq}, skv "
            f"{skv}, d 64): max_abs_err {err:.3e} (tol atol 2e-2)")
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {label}: not finite")
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=0.0)
        sets = [base] + [fa_case(seed=171 + sq + i, **spec)
                         for i in range(n_sets(nbytes(*base)) - 1)]

        def kern(q, k, v):
            return flash_attention(q, k, v, causal=False)

        def plain(q, k, v):
            return flash_attention_plain(q, k, v, causal=False)

        ms = time_ms(kern, sets)
        plain_ms = time_ms(plain, sets[:2], reps=5, n=2)
        sdpa_sets = [tuple(t.transpose(1, 2).contiguous() for t in st)
                     for st in sets]
        library_ms = time_ms(
            lambda qt, kt, vt: F.scaled_dot_product_attention(qt, kt, vt),
            sdpa_sets)
        del sdpa_sets
        moved = nbytes(*base) + nbytes(base[0])        # q, k, v in; out
        flops = 4 * d * sq * skv * b * h
        bound_ms, bound_by = bound(moved, flops, hbm, peak_bf16)
        log(f"[kernel] flash_attention {label} timing: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {moved} B, {flops} flop); {len(sets)} input "
            f"sets")
        entries.append({
            "name": f"flash_attention[{label},b8_sq{sq}_skv{skv}_hq16_d64_"
                    f"non_causal]",
            "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "path": "2k seamless whole sequence"})
        del sets, base, got, want
        torch.cuda.empty_cache()
    return entries


def serve(eng, prompts, counter, expected, label: str, also=(),
          modal=None, meter=None) -> dict:
    """Warm up, then serve ``prompts`` x 64 new tokens with the launch
    count of ``counter`` (a kernel wrapper) set to 0 just before and read
    just after.  Checks every request and that the count equals
    ``expected(decode steps)``, and the same for each (wrapper, expected)
    pair of ``also``; prints and returns the end-to-end metrics (the
    launches of ``also`` under ``also_launches``).  ``modal``: one dict
    of ``submit`` keywords a prompt (``frames=`` / ``patches=``).  With a
    :class:`Meter`, the served run is an energy window (under
    ``energy``, with the tokens it generated under ``tokens``)."""
    modal = modal or [{}] * len(prompts)
    eng.submit(list(range(1, 41)), max_new_tokens=4, **modal[0])  # warm-up
    eng.run()
    eng.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for p, kw in zip(prompts, modal):
        eng.submit(p, max_new_tokens=64, **kw)
    for other, _ in also:
        other.launches = 0
    counter.launches = 0
    t_run = time.monotonic()
    with meter.window() if meter else contextlib.nullcontext() as win:
        results = eng.run()
    launches, steps = counter.launches, eng.decode_steps
    also_launches = {other.__name__: other.launches for other, _ in also}
    torch.cuda.synchronize()
    bad = [(r.request_id, r.status, len(r.tokens)) for r in results
           if r.status != "ok" or len(r.tokens) != 64]
    if len(results) != len(prompts) or bad:
        raise AssertionError(f"{label}: {len(results)} requests, not ok: "
                             f"{bad}")
    vocab = eng.model.cfg.vocab_size
    if not all(0 <= t < vocab for r in results for t in r.tokens):
        raise AssertionError(f"{label}: token id out of range")
    if launches != expected(steps) or launches == 0:
        raise AssertionError(f"{label}: {counter.__name__} launched "
                             f"{launches} times; expected "
                             f"{expected(steps)} ({steps} decode steps)")
    for other, want in also:
        got = also_launches[other.__name__]
        if got != want(steps) or got == 0:
            raise AssertionError(f"{label}: {other.__name__} launched {got} "
                                 f"times; expected {want(steps)}")
    t_admitted = max(r.first_token_t for r in results)
    t_done = max(r.finish_t for r in results)
    decode_s = t_done - t_admitted
    out = {"launches": launches, "steps": steps,
           "also_launches": also_launches, "energy": win,
           "tokens": sum(len(r.tokens) for r in results),
           "step_ms": 1e3 * decode_s / steps,
           "tok_s": sum(len(r.tokens) - 1 for r in results) / decode_s,
           "prefill_s": t_admitted - t_run,
           "ttft_ms": 1e3 * statistics.mean(r.ttft for r in results),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[{label}] {len(results)} requests ok x 64 tokens; {steps} decode "
        f"steps in {eng.dispatches} blocks; {counter.__name__} launches "
        f"{launches}" + "".join(f"; {n} launches {c}"
                                for n, c in also_launches.items()))
    log(f"[{label}] prefill {out['prefill_s']:.3f} s ({len(prompts)} "
        f"prompts, {sum(map(len, prompts))} tokens), "
        f"decode {out['tok_s']:.1f} tok/s, {out['step_ms']:.2f} ms per "
        f"decode step, mean TTFT {out['ttft_ms']:.1f} ms, peak memory "
        f"{out['peak_gib']:.2f} GiB")
    if win is not None:
        check_window(label, win)
        log(f"[{label}] energy window: {win.updates} counter updates over "
            f"{win.seconds:.3f} s of the run's {win.wall_s:.3f} s, "
            f"{win.joules:.3f} J, {win.watts:.1f} W; at its end "
            f"{win.end.describe()}")

    # where a decode step's time goes: one more 16-step block, profiled
    eng.reset()
    for p, kw in zip(prompts, modal):
        eng.submit(p, max_new_tokens=40, **kw)
    eng.decode_loop(16)                        # admission + first block
    busy, kt, n_kern, top, _ = profile_fn(lambda: eng.decode_loop(16),
                                          counter.__name__)
    log(f"[{label}] profiled 16-step decode block: device busy "
        f"{busy / 16:.3f} ms per step ({n_kern / 16:.0f} kernels) against "
        f"{out['step_ms']:.2f} ms per step unprofiled: idle share "
        f"{1 - busy / 16 / out['step_ms']:.3f}; {counter.__name__} "
        f"{kt / 16:.3f} ms per step ({kt / busy:.3f} of device time)")
    for key, count, t in top:
        log(f"[{label}]   {t:9.3f} ms  x{count:<5d} {key}")
    out.update(busy_ms_step=busy / 16, kernels_step=n_kern / 16,
               idle_share=1 - busy / 16 / out["step_ms"],
               attn_ms_step=kt / 16)
    return out


def phase2_engine(cfg, prompts, meter):
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain)
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine, quantize_params
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    params, qstats = quantize_params(params, "bfloat16")
    eng = ServeEngine(model, params, batch=8, max_seq=1024,
                      decode_block=16, prefill_chunk=32, device="cuda")
    log(f"[engine] {cfg.name}: {qstats['quantized_bytes'] / 2**30:.3f} GiB "
        f"params, {eng.kv_stats['kv_bytes'] / 2**30:.3f} GiB KV pool")
    out = serve(eng, prompts, flash_decode,
                lambda steps: cfg.n_layers * steps, "engine", meter=meter)

    # case (g): the kernel on the engine's own pool, layer 0
    kv = eng.cache["pos0"]["kv"]
    qg = torch.randn((8, 1, cfg.n_heads, cfg.head_dim), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7)
                     ).to(torch.bfloat16)
    args = (qg, kv["k"][0], kv["v"][0], kv["slot_pos"][0], eng.state["pos"])
    got = flash_decode(*args)
    torch.cuda.synchronize()
    check_close("g_engine_pool", got, flash_decode_plain(*args),
                torch.ones(8, dtype=torch.bool, device="cuda"),
                TOL[torch.bfloat16])
    return out


def phase2b_quant_engine(cfg, prompts, weight_format, kv_format, meter):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_quant import (
        flash_decode_quant, flash_decode_quant_plain)
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine
    label = f"engine {weight_format} weights, {kv_format} KV"
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, batch=8, max_seq=1024,
                      decode_block=16, prefill_chunk=32, device="cuda",
                      weight_format=weight_format, packed=True,
                      kv_format=kv_format)
    torch.cuda.synchronize()
    del params
    ws, ks = eng.weight_stats, eng.kv_stats
    log(f"[{label}] weight store built in {time.perf_counter() - t0:.2f} "
        f"s: weight_stats {json.dumps(ws)}")
    log(f"[{label}] kv_stats {json.dumps(ks)}")
    flash_decode.launches = 0
    out = serve(eng, prompts, flash_decode_quant,
                lambda steps: cfg.n_layers * steps, label, meter=meter)
    if flash_decode.launches:
        raise AssertionError(f"{label}: the dense flash_decode launched "
                             f"{flash_decode.launches} times")
    out.update(weight_bytes=ws["weight_bytes"],
               weight_quantized_bytes=ws["quantized_bytes"],
               kv_bytes=ks["kv_bytes"],
               kv_bytes_per_elem=ks["bytes_per_elem"])

    # case (g): the kernel on the engine's own quantized pool, layer 0
    kv = {n: t[0] for n, t in eng.cache["pos0"]["kv"].items()}
    qg = torch.randn((8, 1, cfg.n_heads, cfg.head_dim), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7)
                     ).to(torch.bfloat16)
    got = flash_decode_quant(qg, kv, eng.state["pos"], fmt=kv_format)
    torch.cuda.synchronize()
    check_close(f"g_engine_pool {kv_format}", got,
                flash_decode_quant_plain(qg, kv, eng.state["pos"],
                                         fmt=kv_format),
                torch.ones(8, dtype=torch.bool, device="cuda"),
                TOL[torch.bfloat16])
    del eng, kv
    torch.cuda.empty_cache()
    return out


def phase2c_gemm_path():
    """The Tab VII GEMM path through the user's entry points, counts set
    to 0 just before and read just after; every output held to the plain
    version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.qmatmul import (
        qmatmul_packed_plain, qmatmul_plain)
    sizes = [(512, 512, 512), (1024, 1024, 1024), (2048, 2048, 2048),
             (2048, 2048, 4096), (2048, 4096, 8192), (4096, 4096, 4096),
             (8192, 8192, 8192)]
    inputs = []
    for m, n, k in sizes:
        x, w = _qmm_case(m * 3 + n + k, m, n, k)
        inputs.append((x, ops.quantize_for_qmatmul(w, "float8_e4m3fn"),
                       ops.pack_for_qmatmul(w, "float4_e2m1fn")))
        del w
    ops.qmatmul.launches = ops.qmatmul_packed.launches = 0
    outs = [(ops.qmatmul(x, *qc), ops.qmatmul_packed(x, *pk,
                                                     "float4_e2m1fn"))
            for x, qc, pk in inputs]
    counts = {"qmatmul": ops.qmatmul.launches,
              "qmatmul_packed": ops.qmatmul_packed.launches}
    torch.cuda.synchronize()
    if counts != {"qmatmul": len(sizes), "qmatmul_packed": len(sizes)}:
        raise AssertionError(f"GEMM path launches {counts}, expected "
                             f"{len(sizes)} each")
    for (m, n, k), (x, qc, pk), (oc, op) in zip(sizes, inputs, outs):
        if oc.shape != (m, n) or op.shape != (m, n):
            raise AssertionError(f"GEMM path {m}x{n}x{k}: shapes "
                                 f"{tuple(oc.shape)}, {tuple(op.shape)}")
        check_qmm(f"gemm path qmatmul fp8 {m}x{n}x{k}", oc,
                  qmatmul_plain(x, *qc), k)
        check_qmm(f"gemm path qmatmul_packed fp4 {m}x{n}x{k}", op,
                  qmatmul_packed_plain(x, *pk, "float4_e2m1fn"), k)
    log(f"[gemm path] {len(sizes)} sizes {sizes[0]}..{sizes[-1]}: launches "
        f"{counts}")

    # the port's Tab VII, after the counted run: device ms per call, inputs
    # cycled through > the L2
    from repro_torch.serve.quant import dequantize_blockwise
    for (m, n, k), (x, qc, pk) in zip(sizes, inputs):
        flops = 2 * m * n * k

        def packed(x, pw, sc):
            return ops.qmatmul_packed(x, pw, sc, "float4_e2m1fn")

        row = []
        for fn, args in ((ops.qmatmul, (x, *qc)), (packed, (x, *pk))):
            sets = [args] + [(x, args[1].clone(), args[2].clone())
                             for _ in range(n_sets(nbytes(*args)) - 1)]
            row.append(time_ms(fn, sets, reps=10, n=6))
            del sets
        wd = dequantize_blockwise(qc[0], qc[1], torch.bfloat16)
        lib_sets = [(x, wd)] + [(x, wd.clone()) for _ in range(
            n_sets(nbytes(x, wd)) - 1)]
        lib = time_ms(lambda a, b: torch.matmul(a, b.T), lib_sets, reps=10,
                      n=6)
        del wd, lib_sets
        log(f"[tab7] {m}x{n}x{k}: qmatmul fp8 {row[0]:.4f} ms "
            f"({flops / row[0] / 1e9:.1f} TFLOP/s), qmatmul_packed fp4 "
            f"{row[1]:.4f} ms ({flops / row[1] / 1e9:.1f} TFLOP/s), "
            f"torch.matmul bf16 {lib:.4f} ms ({flops / lib / 1e9:.1f} "
            f"TFLOP/s)")
    return counts


def phase2d_mamba2(prompts):
    """mamba2-2.7b at full width cut to ``CUT_LAYERS`` layers through
    ``ServeEngine.run``: every prefill chunk of every layer launches
    ``ssd_scan`` (8 requests x 2 chunks x n_layers), its plain version
    never runs; decode is the plain-torch recurrence."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=CUT_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    chunk = 256
    eng = ServeEngine(model, params, batch=8, max_seq=1024,
                      decode_block=16, prefill_chunk=chunk, device="cuda")
    state_bytes = sum(nbytes(*entry["ssm"].values())
                      for entry in eng.cache.values())
    log(f"[engine mamba2] {cfg.name}: "
        f"{nbytes(*flatten(params).values()) / 2**30:.3f} GiB params, "
        f"slot state {state_bytes} B "
        f"({state_bytes / 2**30:.3f} GiB: conv carries + fp32 SSD state), "
        f"KV bytes {eng.kv_stats['kv_bytes']}")
    calls_per_prompt = math.ceil(len(prompts[0]) / chunk)
    ssd_scan_plain.calls = 0
    out = serve(eng, prompts, ssd_scan,
                lambda steps: len(prompts) * calls_per_prompt * cfg.n_layers,
                "engine mamba2")
    if ssd_scan_plain.calls:
        raise AssertionError(f"mamba2 serving: the plain SSD ran "
                             f"{ssd_scan_plain.calls} times")
    log(f"[engine mamba2] ssd_scan launches {out['launches']} "
        f"({len(prompts)} x {calls_per_prompt} x {cfg.n_layers}), plain "
        f"SSD calls 0")
    # where the serving prefill's device time goes: the admission of the
    # prompts (and one decode step), profiled
    eng.reset()
    for p in prompts:
        eng.submit(p, max_new_tokens=40)
    busy, kt, n_kern, top, n_ssd = profile_fn(lambda: eng.decode_loop(1),
                                              "ssd_scan")
    log(f"[engine mamba2] profiled admission of {len(prompts)} x "
        f"{len(prompts[0])} tokens and one decode step: device busy "
        f"{busy:.2f} ms ({n_kern} kernels); ssd_scan {kt:.2f} ms in {n_ssd} "
        f"launches ({kt / busy:.3f} of device time); top: {top}")
    out["admission_device_ms"], out["admission_ssd_ms"] = busy, kt
    out["state_bytes"] = state_bytes
    del eng, params
    torch.cuda.empty_cache()
    return out


def _timed(fn):
    """(result, wall seconds) of ``fn()`` ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase2e_whole_sequence(hbm, peak_bf16):
    """The whole-sequence path at full width, bf16, seeded weights:
    gptneox-1b ``Model.forward`` on 8 x 2048 tokens, ``Model.prefill`` of
    the same prompts (max_seq 2112), then 64 greedy ``Model.decode_step``
    calls; mamba2-2.7b ``Model.prefill`` on 8 x 2048 tokens, then 16
    greedy decode steps.  Counts set to 0 just before each call and read
    just after: ``flash_attention`` 16 launches per forward and per
    prefill, its plain version never; ``flash_decode`` 16 per decode
    step; ``ssd_scan`` 64 per mamba2 prefill (one per layer, the 8 chunks
    carried inside the kernel), its plain version never.  Prefill's last
    logits must match forward's at position 2047 within atol 1e-3: the
    same bf16 activations, only the fp32 unembed's summation order
    differs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.models.model import build_model
    b, s, new = 8, 2048, 64
    cfg = get_config("gptneox-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    batch = {"tokens": tokens}
    model.forward(params, {"tokens": tokens[:, :256]})          # warm-up
    model.prefill(params, {"tokens": tokens[:, :256]}, 320)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def zero():
        flash_attention.launches = flash_attention_plain.calls = 0
        flash_decode.launches = 0

    def counts():
        return (flash_attention.launches, flash_attention_plain.calls,
                flash_decode.launches)

    def expect(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: (flash_attention launches, "
                                 f"plain calls, flash_decode launches) "
                                 f"{got}, expected {want}")

    L = cfg.n_layers
    zero()
    (logits, aux), fwd_s = _timed(lambda: model.forward(params, batch))
    expect("forward", counts(), (L, 0, 0))
    if logits.shape != (b, s, cfg.vocab_size) or not torch.isfinite(
            logits).all() or set(aux) != {"moe_lb_loss", "moe_z_loss",
                                         "moe_dropped"}:
        raise AssertionError(f"forward: logits {tuple(logits.shape)} not "
                             f"finite or aux {sorted(aux)}")
    last = logits[:, -1].clone()
    del logits
    zero()
    (pre, cache), pre_s = _timed(lambda: model.prefill(params, batch,
                                                       s + new))
    expect("prefill", counts(), (L, 0, 0))
    err = (pre - last).abs().max().item()
    log(f"[whole-seq] gptneox-1b prefill logits against forward's at "
        f"position {s - 1}: max_abs_err {err:.3e} (tol atol 1e-3; |logit| "
        f"max {last.abs().max().item():.2f})")
    torch.testing.assert_close(pre, last, atol=1e-3, rtol=0.0)

    def decode():
        tok, stream = pre.argmax(-1), []
        for i in range(new):
            stream.append(tok)
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            lg = model.decode_step(params, cache, tok, pos)
            tok = lg.argmax(-1)
        return lg, torch.stack(stream, 1)

    zero()
    (lg, stream), dec_s = _timed(decode)
    expect("decode", counts(), (0, 0, L * new))
    if not torch.isfinite(lg).all() or not (
            (stream >= 0) & (stream < cfg.vocab_size)).all():
        raise AssertionError("decode: logits not finite or token ids out "
                             "of range")
    peak = torch.cuda.max_memory_allocated() / 2**30
    kv_bytes = model.kv_cache_stats(cache)["kv_bytes"]
    del cache, pre, lg
    # device time, one more call of each under the profiler
    fwd = profile_fn(lambda: model.forward(params, batch), "flash_attention")
    pre_p = profile_fn(lambda: model.prefill(params, batch, s + new),
                       "flash_attention")
    out = {"launches": 2 * L, "forward_s": fwd_s, "prefill_s": pre_s,
           "prefill_tok_s": b * s / pre_s, "decode_step_ms":
           1e3 * dec_s / new, "peak_gib": peak,
           "forward_busy_ms": fwd[0], "prefill_busy_ms": pre_p[0],
           "fa_ms_per_call": pre_p[1] / max(pre_p[4], 1)}
    log(f"[whole-seq] gptneox-1b {b} x {s}: forward {fwd_s:.3f} s wall, "
        f"{fwd[0]:.2f} ms device busy ({fwd[2]} kernels); prefill "
        f"{pre_s:.3f} s wall ({out['prefill_tok_s']:.0f} tok/s), "
        f"{pre_p[0]:.2f} ms device busy; {new} greedy decode steps "
        f"{out['decode_step_ms']:.2f} ms per step; peak memory {peak:.2f} "
        f"GiB (KV pool {kv_bytes} B); launches per call: flash_attention "
        f"{L}, plain 0; flash_decode {L} per step")
    log(f"[whole-seq] flash_attention in the profiled prefill: "
        f"{pre_p[4]} launches, {out['fa_ms_per_call']:.4f} ms device per "
        f"call ({pre_p[1] / pre_p[0]:.3f} of device time); in the forward "
        f"{fwd[1] / max(fwd[4], 1):.4f} ms per call")
    for key, count, t in pre_p[3]:
        log(f"[whole-seq]   prefill {t:9.3f} ms  x{count:<5d} {key}")
    del model, params, tokens, batch
    torch.cuda.empty_cache()

    # mamba2-2.7b: prefill through ssd_scan, then the plain recurrence
    new_m = 16
    cfg = get_config("mamba2-2.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    model.prefill(params, {"tokens": tokens[:, :256]}, 320)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = ssd_scan_plain.calls = 0
    (pre, cache), pre_s = _timed(lambda: model.prefill(
        params, {"tokens": tokens}, s + new_m))
    if (ssd_scan.launches, ssd_scan_plain.calls) != (cfg.n_layers, 0):
        raise AssertionError(f"mamba2 prefill: ssd_scan launches "
                             f"{ssd_scan.launches}, plain calls "
                             f"{ssd_scan_plain.calls}; expected "
                             f"{cfg.n_layers}, 0")

    def decode_m():
        tok = pre.argmax(-1)
        for i in range(new_m):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            lg = model.decode_step(params, cache, tok, pos)
            tok = lg.argmax(-1)
        return lg

    ssd_scan.launches = 0
    lg, dec_s = _timed(decode_m)
    if ssd_scan.launches or ssd_scan_plain.calls or not (
            torch.isfinite(pre).all() and torch.isfinite(lg).all()):
        raise AssertionError("mamba2 decode: ssd_scan ran, or logits not "
                             "finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del cache, pre, lg
    prof = profile_fn(lambda: model.prefill(params, {"tokens": tokens},
                                            s + new_m), "ssd_scan")
    out.update(mamba2_prefill_s=pre_s, mamba2_prefill_tok_s=b * s / pre_s,
               mamba2_decode_step_ms=1e3 * dec_s / new_m,
               mamba2_peak_gib=peak, mamba2_prefill_busy_ms=prof[0],
               ssd_launches=cfg.n_layers)
    log(f"[whole-seq] mamba2-2.7b {b} x {s}: prefill {pre_s:.3f} s wall "
        f"({b * s / pre_s:.0f} tok/s), {prof[0]:.2f} ms device busy "
        f"({prof[2]} kernels; ssd_scan {prof[4]} launches, "
        f"{prof[1] / max(prof[4], 1):.4f} ms per call); {new_m} greedy "
        f"decode steps {out['mamba2_decode_step_ms']:.2f} ms per step; "
        f"peak memory {peak:.2f} GiB; ssd_scan launches {cfg.n_layers} "
        f"(one per layer), plain SSD calls 0")
    for key, count, t in prof[3]:
        log(f"[whole-seq]   mamba2 prefill {t:9.3f} ms  x{count:<5d} {key}")
    del model, params, tokens
    torch.cuda.empty_cache()
    return out


def _pool_check(label: str, eng) -> dict:
    """Case (g) for every position in the period: the decode kernel of
    that position (``flash_decode``, or ``flash_decode_quant`` in its
    KV format) on layer 0 of the engine's own pool, with the window and
    softcap the model passes it, against its plain version; on a cross
    ring, at query position 2^30 with neither."""
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain)
    from repro_torch.kernels.flash_decode_quant import (
        flash_decode_quant, flash_decode_quant_plain)
    from repro_torch.models import transformer as tf
    cfg = eng.model.cfg
    qg = torch.randn((eng.batch, 1, cfg.n_heads, cfg.head_dim), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7)
                     ).to(torch.bfloat16)
    rows = torch.ones(eng.batch, dtype=torch.bool, device="cuda")
    errs = {}
    rings = [(i, part) for i, blk in enumerate(cfg.block_pattern())
             if blk.mixer == "attn" for part in ("kv", "cross_kv")
             if part in eng.cache[f"pos{i}"]]
    for i, part in rings:
        blk = cfg.block_pattern()[i]
        kv = {n: t[0] for n, t in eng.cache[f"pos{i}"][part].items()}
        flags = dict(window=blk.window, softcap=cfg.attn_logit_softcap)
        pos = eng.state["pos"]
        if part == "cross_kv":
            flags = dict(window=None, softcap=None)
            pos = torch.full_like(pos, tf.CROSS_POS)
        fmt = cfg.kv_format_for(i)
        if fmt:
            got = flash_decode_quant(qg, kv, pos, fmt=fmt, **flags)
            want = flash_decode_quant_plain(qg, kv, pos, fmt=fmt, **flags)
        else:
            args = (qg, kv["k"], kv["v"], kv["slot_pos"], pos)
            got, want = flash_decode(*args, **flags), flash_decode_plain(
                *args, **flags)
        torch.cuda.synchronize()
        key = f"pos{i}" + (".cross" if part == "cross_kv" else "")
        errs[key] = check_close(
            f"{label} g_engine_pool {key} ({fmt or 'dense'}, window "
            f"{blk.window}, softcap {cfg.attn_logit_softcap}, S "
            f"{kv['slot_pos'].shape[1]})", got, want, rows,
            TOL[torch.bfloat16])
    return errs


def _serve_dense(cfg, params, prompts, label, max_seq, prefill_chunk,
                 modal=None, per_step=None, **kw) -> dict:
    """One full-width engine through :func:`serve` (``modal``: its
    ``submit`` keywords a prompt): the decode kernel of its KV
    (``flash_decode`` dense, ``flash_decode_quant`` quantized) exactly
    ``per_step`` (default ``n_layers``) launches a decode step, the other
    kernel and both plain versions never; then case (g) on every ring of
    every position in the period.  Returns serve's metrics."""
    per_step = per_step or cfg.n_layers
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain)
    from repro_torch.kernels.flash_decode_quant import (
        flash_decode_quant, flash_decode_quant_plain)
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(build_model(cfg), params, batch=8, max_seq=max_seq,
                      decode_block=16, prefill_chunk=prefill_chunk,
                      device="cuda", **kw)
    quant = bool(kw.get("kv_format"))
    counter, other = ((flash_decode_quant, flash_decode) if quant
                      else (flash_decode, flash_decode_quant))
    ks = eng.kv_stats
    slots = [ring["slot_pos"].shape[2] for entry in eng.cache.values()
             if isinstance(entry, dict) for ring in entry.values()]
    log(f"[{label}] KV pool {ks['kv_bytes']} B ({ks['kv_bytes'] / 2**30:.3f} "
        f"GiB), per position in the period {json.dumps(ks['per_layer'])}, "
        f"ring slots {slots}")
    other.launches = 0
    flash_decode_plain.calls = flash_decode_quant_plain.calls = 0
    out = serve(eng, prompts, counter, lambda steps: per_step * steps,
                label, modal=modal)
    stray = (other.launches, flash_decode_plain.calls,
             flash_decode_quant_plain.calls)
    if stray != (0, 0, 0):
        raise AssertionError(f"{label}: {other.__name__} launches, plain "
                             f"calls (dense, quant) {stray}; expected 0")
    log(f"[{label}] {counter.__name__} {out['launches']} launches = "
        f"{per_step} x {out['steps']} decode steps; "
        f"{other.__name__} and both plain versions 0")
    out["pool_err"] = _pool_check(label, eng)
    out["kv_bytes"] = ks["kv_bytes"]
    out["cross_kv_bytes"] = ks["cross_kv_bytes"]
    del eng
    torch.cuda.empty_cache()
    return out


def phase2f_gemma2(hbm, peak_bf16):
    """gemma2-2b at full width cut to ``CUT_LAYERS`` layers (of 26;
    d_model 2304, 8 x 256 q-heads over 4 KV heads, d_ff 9216, vocab
    256000, tied), bf16, seeded weights.  Serving, batch 8, max_seq 4608
    (the local layers' rings hold 4096 slots, the global layers' 4608): 2
    prompts of 4200 tokens and 6 of 256, 64 new tokens each, prefill
    chunks of 256; the long prompts wrap the local rings in the chunk
    writes and in decode.  Served with dense KV (``flash_decode``:
    n_layers launches a step), then with fp4 KV on the local layers and
    fp8 on the global ones (``flash_decode_quant``: n_layers a step).
    Then a whole-sequence forward and prefill of 2 x 4608 tokens:
    ``flash_attention`` n_layers launches each, its plain version never,
    the prefill's last logits within atol 1e-3 of the forward's; and the
    kernel against its plain version at that shape (window 4096, softcap
    50).  The unembed (the tied table cast to fp32 every call, as the
    reference does) is profiled alone."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.models.layers import unembed
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=CUT_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    log(f"[gemma2] {cfg.name}: {cfg.n_layers} layers, params "
        f"{nbytes(*flatten(params).values()) / 2**30:.3f} GiB "
        f"({cfg.param_count()} parameters)")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (4200, 4200, 256, 256, 256, 256, 256, 256)]
    out = {"dense": _serve_dense(cfg, params, prompts, "gemma2 dense KV",
                                 4608, 256)}
    fmts = ("float4_e2m1fn", "float8_e4m3fn")
    out["mixed"] = _serve_dense(cfg, params, prompts,
                                "gemma2 fp4 local / fp8 global KV", 4608,
                                256, kv_format=fmts)

    # the unembed alone, (8, 1, 2304) bf16 against the tied table: the
    # whole call, its fp32 cast of the table, and the product over a
    # table cast beforehand, by CUDA events (inputs > the L2)
    x = torch.randn((8, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    w = model.unembed_weight(params)
    cap = cfg.final_logit_softcap
    w32 = w.float()
    out["unembed_ms"] = time_ms(lambda: unembed(w, x, cap), [()], 10, 4)
    cast_ms = time_ms(lambda: w.float(), [()], 10, 4)
    gemm_ms = time_ms(lambda: unembed(w32, x, cap), [()], 10, 4)
    log(f"[gemma2] unembed of 8 rows ({tuple(w.shape)} {w.dtype} table): "
        f"{out['unembed_ms']:.4f} ms device a call; its fp32 cast of the "
        f"table alone {cast_ms:.4f} ms, the product and softcap over a "
        f"table cast beforehand {gemm_ms:.4f} ms")
    del x, w, w32

    # the whole-sequence path: forward and prefill of 2 x 4608
    b, s = 2, 4608
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    model.forward(params, {"tokens": tokens[:, :256]})           # warm-up
    model.prefill(params, {"tokens": tokens[:, :256]}, 320)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.n_layers

    def counts(label):
        got = (flash_attention.launches, flash_attention_plain.calls)
        if got != (L, 0):
            raise AssertionError(f"gemma2 {label}: (flash_attention "
                                 f"launches, plain calls) {got}, expected "
                                 f"({L}, 0)")

    flash_attention.launches = flash_attention_plain.calls = 0
    (logits, _), fwd_s = _timed(lambda: model.forward(params,
                                                      {"tokens": tokens}))
    counts("forward")
    if logits.shape != (b, s, cfg.vocab_size) or not torch.isfinite(
            logits).all():
        raise AssertionError("gemma2 forward: logits of the wrong shape or "
                             "not finite")
    last = logits[:, -1].clone()
    del logits
    flash_attention.launches = flash_attention_plain.calls = 0
    (pre, cache), pre_s = _timed(lambda: model.prefill(
        params, {"tokens": tokens}, s))
    counts("prefill")
    peak = torch.cuda.max_memory_allocated() / 2**30
    err = (pre - last).abs().max().item()
    log(f"[gemma2] prefill logits against forward's at position {s - 1}: "
        f"max_abs_err {err:.3e} (tol atol 1e-3; |logit| max "
        f"{last.abs().max().item():.2f}, final softcap 30)")
    torch.testing.assert_close(pre, last, atol=1e-3, rtol=0.0)
    del pre, cache, last
    torch.cuda.empty_cache()
    fwd = profile_fn(lambda: model.forward(params, {"tokens": tokens}),
                     "flash_attention")
    pre_p = profile_fn(lambda: model.prefill(params, {"tokens": tokens}, s),
                       "flash_attention")
    out.update(launches=L, forward_s=fwd_s, prefill_s=pre_s,
               forward_busy_ms=fwd[0], prefill_busy_ms=pre_p[0],
               fa_ms_per_call=pre_p[1] / max(pre_p[4], 1), whole_peak_gib=peak)
    log(f"[gemma2] whole sequence {b} x {s}: forward {fwd_s:.3f} s wall, "
        f"{fwd[0]:.2f} ms device busy ({fwd[2]} kernels); prefill "
        f"{pre_s:.3f} s wall ({b * s / pre_s:.0f} tok/s), {pre_p[0]:.2f} ms "
        f"device busy; peak memory {peak:.2f} GiB; flash_attention {L} "
        f"launches per call, plain 0, {out['fa_ms_per_call']:.4f} ms device "
        f"per call in the prefill ({pre_p[1] / pre_p[0]:.3f} of device "
        f"time)")
    for key, count, t in pre_p[3]:
        log(f"[gemma2]   prefill {t:9.3f} ms  x{count:<5d} {key}")
    del tokens, model, params
    torch.cuda.empty_cache()

    # the kernel against its plain version at the path's shape
    flags = dict(window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
    q, k, v = fa_case(61, b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      torch.bfloat16)
    got = flash_attention(q, k, v, **flags)
    want = flash_attention_plain(q, k, v, **flags)
    torch.cuda.synchronize()
    out["fa_err"] = (got.float() - want.float()).abs().max().item()
    log(f"[kernel] flash_attention gemma2 shape (b {b}, s {s}, hq "
        f"{cfg.n_heads}, hkv {cfg.n_kv_heads}, d {cfg.head_dim}, window "
        f"{cfg.sliding_window}, softcap {cfg.attn_logit_softcap}): "
        f"max_abs_err {out['fa_err']:.3e} (tol atol 2e-2)")
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=0.0)
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def phase2g_dense_family(greedy_gptneox):
    """qwen2.5-3b, llama3.2-3b and gemma-2b at full width cut to
    ``CUT_LAYERS`` layers, bf16, seeded weights, one after the other
    (each freed before the next is built): greedy, batch 8, 8 x
    256-token prompts x 64 new tokens, max_seq 1024, prefill chunks of
    256; ``flash_decode`` exactly ``n_layers``
    launches a decode step, then case (g).  Then gptneox-1b sampled
    (temperature 0.8, top_k 8, seed 3) beside phase 2's greedy run: the
    sampler's kernels and device time a step."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    out = {}
    for arch in ("qwen2.5-3b", "llama3.2-3b", "gemma-2b"):
        cfg = dataclasses.replace(get_config(arch), n_layers=CUT_LAYERS)
        params = build_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(0), "cuda")
        log(f"[{arch}] {cfg.n_layers} layers, hq {cfg.n_heads} / hkv "
            f"{cfg.n_kv_heads}, d {cfg.head_dim}, vocab {cfg.vocab_size}: "
            f"params {nbytes(*flatten(params).values()) / 2**30:.3f} GiB")
        rng = np.random.default_rng(12)
        prompts = [rng.integers(0, cfg.vocab_size, 256).tolist()
                   for _ in range(8)]
        out[arch] = _serve_dense(cfg, params, prompts, f"engine {arch}",
                                 1024, 256)
        del params
        torch.cuda.empty_cache()

    cfg = get_config("gptneox-1b")
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 256).tolist()
               for _ in range(8)]
    sampled = _serve_dense(cfg, params, prompts, "engine gptneox sampled",
                           1024, 32, temperature=0.8, top_k=8, seed=3)
    out["gptneox-1b sampled"] = sampled
    g = greedy_gptneox
    log(f"[engine gptneox sampled] against phase 2's greedy run: "
        f"{sampled['kernels_step']:.0f} kernels and "
        f"{sampled['busy_ms_step']:.3f} ms device busy a step (greedy "
        f"{g['kernels_step']:.0f}, {g['busy_ms_step']:.3f} ms): the sampler "
        f"adds {sampled['kernels_step'] - g['kernels_step']:.0f} kernels and "
        f"{sampled['busy_ms_step'] - g['busy_ms_step']:.3f} ms; "
        f"{sampled['step_ms']:.2f} against {g['step_ms']:.2f} ms a step "
        f"wall")
    del params
    torch.cuda.empty_cache()
    return out


def _moe_share(fn):
    """``fn()`` with CUDA events recorded around every ``apply_moe`` call
    and around the whole: (the MoE calls' share of the window on the
    device timeline, their count, the window's ms)."""
    from repro_torch.models import moe
    apply, marks = moe.apply_moe, []

    def timed(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        out = apply(*args, **kwargs)
        end.record()
        marks.append((start, end))
        return out

    t0, t1 = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    moe.apply_moe = timed
    try:
        t0.record()
        fn()
        t1.record()
    finally:
        moe.apply_moe = apply
    torch.cuda.synchronize()
    total = t0.elapsed_time(t1)
    return sum(a.elapsed_time(b) for a, b in marks) / total, len(marks), total


def phase2h_jamba(hbm, peak_bf16):
    """jamba-v0.1-52b at full width (d_model 4096, 32 q-heads over 8 KV
    heads of 128, d_ff 14336, 16 experts top-2, SSD with 128 heads of
    p 64 over n 16, vocab 65536), cut to 16 layers (2 periods of 8: the
    52 GB of bf16 weights of the cut fit one card, the full 103 GB do
    not), bf16, seeded weights.  Served with dense KV, then fp8 KV:
    batch 8, max_seq 1024, 8 x 256-token prompts x 64 new tokens,
    prefill chunks of 256, decode blocks of 16; ``flash_decode`` (or
    ``flash_decode_quant``) exactly 2 launches a decode step (one per
    attention layer), ``ssd_scan`` exactly 14 a prefill chunk of a slot
    (one per SSM layer), the other decode kernel and every plain version
    never; case (g) on the attention ring.  The MoE calls' share of a
    16-step decode block's device timeline (CUDA events around each
    call).  Then ``Model.forward`` and ``Model.prefill`` of 8 x 2048
    tokens: ``flash_attention`` exactly 2 launches and ``ssd_scan`` 14
    per call, plain versions never, the prefill's last logits within
    atol 1e-3 of the forward's; 16 greedy decode steps (``flash_decode``
    2 a step); device time of each kernel a call, profiled."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain)
    from repro_torch.kernels.flash_decode_quant import (
        flash_decode_quant, flash_decode_quant_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=16)
    model = build_model(cfg)
    pattern = cfg.block_pattern()
    n_attn = cfg.n_periods * sum(b.mixer == "attn" for b in pattern)
    n_ssm = cfg.n_periods * sum(b.mixer == "ssm" for b in pattern)
    n_moe = cfg.n_periods * sum(b.ffn == "moe" for b in pattern)
    (params, init_s) = _timed(lambda: model.init(
        torch.Generator(device="cuda").manual_seed(0), "cuda"))
    log(f"[jamba] {cfg.name} cut to {cfg.n_layers} layers ({n_attn} "
        f"attention, {n_ssm} SSM, {n_moe} MoE FFNs of "
        f"{cfg.moe_num_experts} experts top-{cfg.moe_top_k}): params "
        f"{nbytes(*flatten(params).values()) / 2**30:.3f} GiB "
        f"({cfg.param_count() / 1e9:.2f}B at full depth), seeded init "
        f"{init_s:.1f} s")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, 256).tolist()
               for _ in range(8)]
    out = {}
    for kv_format in (None, "float8_e4m3fn"):
        label = f"engine jamba {kv_format or 'dense'} KV"
        counter, other = ((flash_decode_quant, flash_decode) if kv_format
                          else (flash_decode, flash_decode_quant))
        eng = ServeEngine(model, params, batch=8, max_seq=1024,
                          decode_block=16, prefill_chunk=256, device="cuda",
                          kv_format=kv_format)
        log(f"[{label}] KV pool {eng.kv_stats['kv_bytes']} B, slot state "
            f"{sum(nbytes(*e['ssm'].values()) for e in eng.cache.values() if 'ssm' in e)} B")
        other.launches = 0
        flash_decode_plain.calls = flash_decode_quant_plain.calls = 0
        ssd_scan_plain.calls = 0
        r = serve(eng, prompts, counter, lambda steps: n_attn * steps, label,
                  also=((ssd_scan, lambda steps: len(prompts) * n_ssm),))
        stray = (other.launches, flash_decode_plain.calls,
                 flash_decode_quant_plain.calls, ssd_scan_plain.calls)
        if stray != (0, 0, 0, 0):
            raise AssertionError(f"{label}: {other.__name__} launches, "
                                 f"plain calls (dense, quant, ssd) {stray}")
        eng.reset()
        for p in prompts:
            eng.submit(p, max_new_tokens=40)
        eng.decode_loop(16)                    # admission + first block
        share, calls, window = _moe_share(lambda: eng.decode_loop(16))
        if calls != n_moe * 16:
            raise AssertionError(f"{label}: {calls} MoE calls in 16 steps")
        log(f"[{label}] MoE FFNs: {share:.3f} of a 16-step decode block's "
            f"device timeline ({window:.2f} ms, {calls} calls, "
            f"{share * window / calls:.3f} ms a call)")
        r.update(moe_share=share, pool_err=_pool_check(label, eng))
        out[kv_format or "dense"] = r
        del eng
        torch.cuda.empty_cache()

    # the whole-sequence path
    b, s, new = 8, 2048, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    batch = {"tokens": tokens}
    model.forward(params, {"tokens": tokens[:, :512]})          # warm-up
    model.prefill(params, {"tokens": tokens[:, :512]}, 576)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def zero():
        flash_attention.launches = flash_attention_plain.calls = 0
        ssd_scan.launches = ssd_scan_plain.calls = flash_decode.launches = 0

    def expect(label, want):
        got = (flash_attention.launches, flash_attention_plain.calls,
               ssd_scan.launches, ssd_scan_plain.calls,
               flash_decode.launches)
        if got != want:
            raise AssertionError(f"jamba {label}: (flash_attention, plain, "
                                 f"ssd_scan, plain, flash_decode) {got}, "
                                 f"expected {want}")

    zero()
    (logits, aux), fwd_s = _timed(lambda: model.forward(params, batch))
    expect("forward", (n_attn, 0, n_ssm, 0, 0))
    fa_read, ssd_read = flash_attention.launches, ssd_scan.launches
    if logits.shape != (b, s, cfg.vocab_size) or not torch.isfinite(
            logits).all() or not all(torch.isfinite(v) for v in
                                     aux.values()):
        raise AssertionError("jamba forward: logits or aux not finite")
    last = logits[:, -1].clone()
    del logits
    zero()
    (pre, cache), pre_s = _timed(lambda: model.prefill(params, batch,
                                                       s + new))
    expect("prefill", (n_attn, 0, n_ssm, 0, 0))
    err = (pre - last).abs().max().item()
    log(f"[jamba whole-seq] aux {({k: round(float(v), 4) for k, v in aux.items()})}; "
        f"prefill logits against forward's at position {s - 1}: "
        f"max_abs_err {err:.3e} (tol atol 1e-3)")
    torch.testing.assert_close(pre, last, atol=1e-3, rtol=0.0)

    def decode():
        tok = pre.argmax(-1)
        for i in range(new):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            lg = model.decode_step(params, cache, tok, pos)
            tok = lg.argmax(-1)
        return lg

    zero()
    lg, dec_s = _timed(decode)
    expect("decode", (0, 0, 0, 0, n_attn * new))
    if not torch.isfinite(lg).all():
        raise AssertionError("jamba decode: logits not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del cache, pre, lg, last
    fwd = profile_fn(lambda: model.forward(params, batch), "flash_attention")
    pre_p = profile_fn(lambda: model.prefill(params, batch, s + new),
                       "ssd_scan")
    whole = {"forward_s": fwd_s, "prefill_s": pre_s,
             "prefill_tok_s": b * s / pre_s,
             "decode_step_ms": 1e3 * dec_s / new, "peak_gib": peak,
             "forward_busy_ms": fwd[0], "prefill_busy_ms": pre_p[0],
             "fa_ms_per_call": fwd[1] / max(fwd[4], 1),
             "ssd_ms_per_call": pre_p[1] / max(pre_p[4], 1),
             "fa_launches": fa_read, "ssd_launches": ssd_read}
    log(f"[jamba whole-seq] {b} x {s}: forward {fwd_s:.3f} s wall, "
        f"{fwd[0]:.2f} ms device busy ({fwd[2]} kernels); prefill "
        f"{pre_s:.3f} s wall ({whole['prefill_tok_s']:.0f} tok/s), "
        f"{pre_p[0]:.2f} ms device busy; {new} greedy decode steps "
        f"{whole['decode_step_ms']:.2f} ms per step; peak memory "
        f"{peak:.2f} GiB; flash_attention {whole['fa_ms_per_call']:.4f} ms "
        f"a call ({fwd[4]} launches in the forward), ssd_scan "
        f"{whole['ssd_ms_per_call']:.4f} ms a call ({pre_p[4]} launches in "
        f"the prefill)")
    for key, count, t in pre_p[3]:
        log(f"[jamba whole-seq]   prefill {t:9.3f} ms  x{count:<5d} {key}")
    out["whole"] = whole
    del model, params, tokens, batch
    torch.cuda.empty_cache()
    return out


def phase2i_moe_models():
    """kimi-k2-1t-a32b cut to 1 layer (384 experts top-8 with a shared
    expert, d_model 7168, 64 q-heads, vocab 163840: 38.9 GB in bf16) and
    llama4-maverick-400b-a17b cut to 2 layers (one dense and one MoE
    FFN of 128 experts top-1 with a shared expert, d_model 5120, vocab
    202048: 37.1 GB), full width, bf16, seeded weights, one after the
    other (each freed before the next): phase 2's traffic (batch 8, 8 x
    256-token prompts x 64 new tokens, max_seq 1024) in prefill chunks
    of 256 with dense KV; ``flash_decode`` exactly ``n_layers`` launches
    a decode step, then case (g).  Returns each model's ``flash_decode``
    launches."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    out = {}
    for arch, layers in (("kimi-k2-1t-a32b", 1),
                         ("llama4-maverick-400b-a17b", 2)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        params, init_s = _timed(lambda: build_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(0), "cuda"))
        log(f"[{arch}] cut to {layers} layer(s), {cfg.moe_num_experts} "
            f"experts top-{cfg.moe_top_k}, shared expert "
            f"{cfg.moe_shared_expert}: params "
            f"{nbytes(*flatten(params).values()) / 2**30:.3f} GiB "
            f"({cfg.param_count() / 1e9:.1f}B at full depth), seeded init "
            f"{init_s:.1f} s")
        rng = np.random.default_rng(24)
        prompts = [rng.integers(0, cfg.vocab_size, 256).tolist()
                   for _ in range(8)]
        out[arch] = _serve_dense(cfg, params, prompts, f"engine {arch}",
                                 1024, 256)["launches"]
        del params
        torch.cuda.empty_cache()
    return out


def phase2j_robustness(cfg, prompts):
    """Serving robustness on the card, gptneox-1b at full width, bf16:
    8 requests x 48 new tokens served once clean; then again with, after
    the admission and a first 16-step block, a ``logits_nan`` fault armed
    on request 0 (two tokens later), request 1 cancelled, and the next
    16-step block run, all three under
    ``torch.cuda.set_sync_debug_mode("error")`` (no implicit host
    synchronisation); request 0 ends ``faulted`` with the clean run's
    first 19 tokens, request 1 ``shed`` with its first 17, the other six
    ``ok`` with the clean streams bit for bit, the accounting balanced
    and the watchdog clean.  Then the injector's cost a decode step:
    wall ms, device busy ms and kernels with and without a fault armed
    (far past the stream).  Then a ``poisson_trace`` (32 arrivals at
    400 / s, prompts of 64 to 256 tokens, 16 or 32 new) replayed under
    the virtual clock (2 ms a decode step) with a queue of 4 that
    rejects: requests shed, the accounting exact, a second replay's
    report identical."""
    from repro_torch.models.model import build_model
    from repro_torch.serve import (
        AdmissionConfig, ServeEngine, poisson_trace, replay)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    eng = ServeEngine(model, params, batch=8, max_seq=1024, decode_block=16,
                      prefill_chunk=256, device="cuda")
    for p in prompts:
        eng.submit(p, max_new_tokens=48)
    want = [r.tokens for r in eng.run()]
    eng.reset()
    ids = [eng.submit(p, max_new_tokens=48) for p in prompts]
    eng.decode_loop(16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.inject_fault(ids[0], "logits_nan", delay=2)
        eng.cancel(ids[1])
        toks, emits = eng._decode_block(16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.decode_steps += 16
    eng._harvest(toks, emits)
    res = {r.request_id: r for r in eng.run()}
    got = [(res[i].status, res[i].tokens) for i in ids]
    expected = ([("faulted", want[0][:19]), ("shed", want[1][:17])]
                + [("ok", t) for t in want[2:]])
    if got != expected:
        bad = [i for i, (g, w) in enumerate(zip(got, expected)) if g != w]
        raise AssertionError(f"robustness: requests {bad} differ from the "
                             f"clean run: {[(got[i][0], len(got[i][1])) for i in bad]}")
    acc, watch = eng.accounting(), eng.watchdog_report()
    if not (acc["balanced"] and acc["faulted"] == 1 and acc["shed"] == 1
            and acc["ok"] == 6 and watch["ok"]):
        raise AssertionError(f"robustness: accounting {acc}, watchdog "
                             f"{watch}")
    log("[robust] gptneox-1b full width: logits_nan armed and a cancel "
        "inside a run, under set_sync_debug_mode('error') with the next "
        "16-step block: no synchronisation; request 0 faulted after 19 "
        "tokens, request 1 shed after 17, the 6 survivors bit-identical "
        f"to the clean run; accounting {acc}; watchdog ok")

    # what the logits-fault injector costs a decode step: it runs only
    # while a slot is armed, so a fault armed far past the stream turns
    # it on; off / on / off / on in one process, a 16-step block timed
    # on the wall clock and the next one profiled
    cost = {False: [], True: []}
    for armed in (False, True, False, True):
        eng.reset()
        ids = [eng.submit(p, max_new_tokens=64) for p in prompts]
        eng.decode_loop(16)                    # admission + first block
        if armed:
            eng.inject_fault(ids[0], "logits_nan", delay=10_000)
        _, wall = _timed(lambda: eng.decode_loop(16))
        busy, _, n_kern, _, _ = profile_fn(lambda: eng.decode_loop(16),
                                           "flash_decode")
        cost[armed].append((1e3 * wall / 16, busy / 16, n_kern / 16))
    injector = {k: tuple(statistics.mean(c[i] for c in v) for i in range(3))
                for k, v in cost.items()}
    log(f"[robust] fault injector, a decode step (mean of 2 blocks each): "
        f"disarmed {injector[False][0]:.2f} ms wall, "
        f"{injector[False][1]:.3f} ms device busy, "
        f"{injector[False][2]:.1f} kernels; armed "
        f"{injector[True][0]:.2f} ms wall, {injector[True][1]:.3f} ms "
        f"device busy, {injector[True][2]:.1f} kernels; per block "
        f"{cost}")

    sc = poisson_trace(n=32, rate=400.0, vocab_size=cfg.vocab_size,
                       seed=23, prompt_lens=(64, 128, 256),
                       output_lens=(16, 32))
    adm = AdmissionConfig(queue_limit=4, policy="reject")
    rep, wall = _timed(lambda: replay(eng, sc, k=16, admission=adm,
                                      step_cost_s=2e-3))
    again = replay(eng, sc, k=16, admission=adm, step_cost_s=2e-3)
    shed = rep.by_status.get("shed", 0)
    if not (rep.accounting_ok and rep.submitted == 32 and shed > 0
            and rep.by_status.get("ok", 0) > 0 and again == rep):
        raise AssertionError(f"replay: {rep} / again {again}")
    log(f"[robust] replay {rep.scenario} under the virtual clock (2 ms a "
        f"step), queue 4, reject: {rep.submitted} submitted, by status "
        f"{rep.by_status}, goodput {rep.goodput_tok_s:.1f} tok/s virtual, "
        f"TTFT p50/p99 {rep.ttft_p50:.6f}/{rep.ttft_p99:.6f} s virtual; "
        f"accounting exact, a second replay identical; {wall:.2f} s wall")
    del eng, params
    torch.cuda.empty_cache()
    return {"replay": rep.row(), "replay_wall_s": wall,
            "injector": injector}


def _modal_whole_sequence(label, model, params, batch, fa_per_call,
                          fd_per_step, new=16):
    """``Model.forward`` and ``Model.prefill`` of ``batch`` (after a
    warm-up on a slice of it), then ``new`` greedy decode steps:
    ``flash_attention`` exactly ``fa_per_call`` launches a forward and a
    prefill, ``flash_decode`` ``fd_per_step`` a decode step, their plain
    versions never; the prefill's last logits within atol 1e-3 of the
    forward's.  Returns the figures of phase 2e (wall and profiled
    device times, tok/s, ms a decode step, peak memory, flash_attention's
    ms a call)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain)
    b, s = batch["tokens"].shape
    trunk = s + (batch["patches"].shape[1] if "patches" in batch else 0)
    vocab = model.cfg.vocab_size
    warm = {k: v[:, :128] for k, v in batch.items()}
    model.forward(params, warm)
    model.prefill(params, warm, 256)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def zero():
        flash_attention.launches = flash_attention_plain.calls = 0
        flash_decode.launches = flash_decode_plain.calls = 0

    def expect(what, fa, fd):
        got = (flash_attention.launches, flash_attention_plain.calls,
               flash_decode.launches, flash_decode_plain.calls)
        if got != (fa, 0, fd, 0):
            raise AssertionError(f"{label} {what}: (flash_attention, plain, "
                                 f"flash_decode, plain) {got}, expected "
                                 f"{(fa, 0, fd, 0)}")
        zero()

    zero()
    (logits, _), fwd_s = _timed(lambda: model.forward(params, batch))
    expect("forward", fa_per_call, 0)
    if logits.shape != (b, trunk, vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"{label} forward: logits {tuple(logits.shape)}"
                             f" or not finite")
    last = logits[:, -1].clone()
    del logits
    (pre, cache), pre_s = _timed(lambda: model.prefill(params, batch,
                                                       trunk + new))
    expect("prefill", fa_per_call, 0)
    err = (pre - last).abs().max().item()
    log(f"[{label}] prefill logits against forward's at trunk position "
        f"{trunk - 1}: max_abs_err {err:.3e} (tol atol 1e-3)")
    torch.testing.assert_close(pre, last, atol=1e-3, rtol=0.0)

    def decode():
        tok = pre.argmax(-1)
        for i in range(new):
            pos = torch.full((b,), trunk + i, dtype=torch.int32,
                             device="cuda")
            lg = model.decode_step(params, cache, tok, pos)
            tok = lg.argmax(-1)
        return lg

    lg, dec_s = _timed(decode)
    expect("decode", 0, fd_per_step * new)
    if not torch.isfinite(lg).all():
        raise AssertionError(f"{label} decode: logits not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del cache, pre, lg, last
    fwd = profile_fn(lambda: model.forward(params, batch), "flash_attention")
    pre_p = profile_fn(lambda: model.prefill(params, batch, trunk + new),
                       "flash_attention")
    torch.cuda.empty_cache()
    out = {"forward_s": fwd_s, "prefill_s": pre_s,
           "prefill_tok_s": b * trunk / pre_s,
           "decode_step_ms": 1e3 * dec_s / new, "peak_gib": peak,
           "forward_busy_ms": fwd[0], "prefill_busy_ms": pre_p[0],
           "forward_kernels": fwd[2],
           "fa_ms_per_call": fwd[1] / max(fwd[4], 1),
           "fa_share_prefill": pre_p[1] / max(pre_p[0], 1e-9),
           "fa_launches": fa_per_call, "fd_launches": fd_per_step * new}
    log(f"[{label}] {b} x {trunk}: forward {fwd_s:.3f} s wall, "
        f"{fwd[0]:.2f} ms device busy ({fwd[2]} kernels); prefill "
        f"{pre_s:.3f} s wall ({out['prefill_tok_s']:.0f} tok/s), "
        f"{pre_p[0]:.2f} ms device busy; {new} greedy decode steps "
        f"{out['decode_step_ms']:.2f} ms per step; peak memory "
        f"{peak:.2f} GiB; flash_attention {out['fa_ms_per_call']:.4f} ms a "
        f"call ({fwd[4]} launches in the profiled forward), "
        f"{out['fa_share_prefill']:.3f} of the prefill's device time")
    for key, count, t in pre_p[3]:
        log(f"[{label}]   prefill {t:9.3f} ms  x{count:<5d} {key}")
    return out


def phase2k_seamless():
    """seamless-m4t-medium at full width cut to ``CUT_LAYERS`` encoder and
    ``CUT_LAYERS`` decoder layers (of 12 and 12; d_model 1024, 16 heads
    of 64, d_ff 4096, GELU,
    vocab 256206), bf16, seeded weights.  Served (batch 8, max_seq 1024,
    enc_len 1024, decode blocks of 16) with dense KV, then fp8 and fp4
    KV (the cross rings quantized too): 8 requests, each a source of
    600..1000 frames (lengths and N(0, 0.02^2) frames from
    ``default_rng(2)``), a 16-token prompt and 64 new tokens;
    ``flash_decode`` (or
    ``flash_decode_quant``) exactly 2 x n_layers launches a decode step
    (self and cross), the other kernel and both plain versions never;
    case (g) on the self and the cross ring.  The encode a request, wall
    and profiled (one ``flash_attention`` launch an encoder layer).  Then
    forward and prefill of 8 x 1024 frames + 8 x 1024 tokens: a
    ``flash_attention`` launch an encoder layer and two a decoder layer
    (self, cross) a call, and 16 decode steps."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import build_model, make_batch
    cfg = dataclasses.replace(get_config("seamless-m4t-medium"),
                              n_layers=CUT_LAYERS,
                              n_encoder_layers=CUT_LAYERS)
    model = build_model(cfg)
    params, init_s = _timed(lambda: model.init(
        torch.Generator(device="cuda").manual_seed(0), "cuda"))
    log(f"[seamless] {cfg.name}: {cfg.n_encoder_layers} encoder + "
        f"{cfg.n_layers} decoder layers, params "
        f"{nbytes(*flatten(params).values()) / 2**30:.3f} GiB "
        f"({cfg.param_count() / 1e9:.3f}B), seeded init {init_s:.1f} s")
    rng = np.random.default_rng(2)
    src = rng.integers(600, 1001, 8)
    frames = [rng.standard_normal((int(n), cfg.d_model), np.float32)
              * np.float32(0.02) for n in src]
    prompts = [rng.integers(0, cfg.vocab_size, 16).tolist()
               for _ in range(8)]
    modal = [{"frames": f} for f in frames]
    out = {}
    for kv_format in (None, "float8_e4m3fn", "float4_e2m1fn"):
        label = f"engine seamless {kv_format or 'dense'} KV"
        out[kv_format or "dense"] = _serve_dense(
            cfg, params, prompts, label, 1024, 256, modal=modal,
            per_step=2 * cfg.n_layers, kv_format=kv_format, enc_len=1024)
        log(f"[{label}] sources {src.tolist()} frames; cross_kv_bytes "
            f"{out[kv_format or 'dense']['cross_kv_bytes']}")

    # the encode a request: the engine's encode_slot leg alone
    cache = model.init_cache(8, 1024, "cuda", enc_len=1024)
    dev_frames = [torch.from_numpy(f[None]).to("cuda", torch.bfloat16)
                  for f in frames]

    def encode_all():
        for slot, f in enumerate(dev_frames):
            model.encode_slot(params, cache, f, slot, f.shape[1])

    encode_all()                                   # warm-up
    torch.cuda.synchronize()
    flash_attention.launches = 0
    _, wall = _timed(lambda: (encode_all(), torch.cuda.synchronize()))
    if flash_attention.launches != 8 * cfg.n_encoder_layers:
        raise AssertionError(f"seamless encode: {flash_attention.launches} "
                             f"flash_attention launches for 8 requests")
    busy, fa_ms, n_kern, top, fa_n = profile_fn(encode_all,
                                                "flash_attention")
    out["encode"] = {"wall_ms": 1e3 * wall / 8, "busy_ms": busy / 8,
                     "fa_ms": fa_ms / max(fa_n, 1), "kernels": n_kern / 8}
    log(f"[seamless encode] a request (600..1000 frames, mean "
        f"{src.mean():.0f}): {1e3 * wall / 8:.2f} ms wall, {busy / 8:.3f} "
        f"ms device busy ({n_kern / 8:.0f} kernels), flash_attention "
        f"{fa_ms / max(fa_n, 1):.4f} ms a call ({fa_n} launches)")
    for key, count, t in top:
        log(f"[seamless encode]   {t:9.3f} ms  x{count:<5d} {key}")
    del cache, dev_frames

    batch = make_batch(cfg, 8, 1024, 3, "cuda")
    out["whole"] = _modal_whole_sequence(
        "seamless whole-seq", model, params, batch,
        cfg.n_encoder_layers + 2 * cfg.n_layers, 2 * cfg.n_layers)
    del model, params, batch
    torch.cuda.empty_cache()
    return out


def phase2l_internvl2():
    """internvl2-2b at full width and depth (24 layers, d_model 2048, 16
    q-heads over 8 KV heads of 128, d_ff 8192, SwiGLU, vocab 92553),
    bf16, seeded weights.  Served (batch 8, max_seq 1024, chunks of 256,
    decode blocks of 16) with dense KV: 8 requests of 256 patches
    (N(0, 0.02^2)) + 256 tokens x 64 new tokens, the patches streamed as
    embedding chunks; ``flash_decode`` exactly 24 launches a decode
    step, case (g).  Then forward and prefill of 8 x (256 patches + 1792
    tokens): 24 ``flash_attention`` launches a call, and 16 decode
    steps."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model, make_batch
    cfg = get_config("internvl2-2b")
    model = build_model(cfg)
    params, init_s = _timed(lambda: model.init(
        torch.Generator(device="cuda").manual_seed(0), "cuda"))
    log(f"[internvl2] {cfg.name}: params "
        f"{nbytes(*flatten(params).values()) / 2**30:.3f} GiB "
        f"({cfg.param_count() / 1e9:.3f}B), seeded init {init_s:.1f} s")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, 256).tolist()
               for _ in range(8)]
    modal = [{"patches": rng.standard_normal((256, cfg.d_model), np.float32)
              * np.float32(0.02)} for _ in range(8)]
    out = {"dense": _serve_dense(cfg, params, prompts,
                                 "engine internvl2 dense KV", 1024, 256,
                                 modal=modal)}
    batch = make_batch(cfg, 8, 2048, 5, "cuda")
    out["whole"] = _modal_whole_sequence(
        "internvl2 whole-seq", model, params, batch, cfg.n_layers,
        cfg.n_layers)
    del model, params, batch
    torch.cuda.empty_cache()
    return out


class _Recording:
    """A model whose decode steps keep their logits (for diagnosis)."""

    def __init__(self, model, seen):
        self._model, self._seen = model, seen

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, *args, **kwargs):
        out = self._model.decode_step(*args, **kwargs)
        self._seen.append(out.float().cpu())
        return out


def _serve_both(model3, params3, prompts3, max_seq=64, prefill_chunk=32,
                modal=None, caches=None, **kw):
    """Serve ``prompts3`` on the card and on the CPU (``modal``: the
    ``submit`` keywords of each prompt).  Returns, by device, the
    streams, the admission logits, the decode logits of every step and
    the weight store; with a dict ``caches``, also the engine's cache
    after the run, on the host, by device."""
    from repro_torch.serve import ServeEngine
    modal = modal or [{}] * len(prompts3)
    runs = {}
    for dev in ("cuda", "cpu"):
        e = ServeEngine(model3, params3, batch=2, max_seq=max_seq,
                        decode_block=7, prefill_chunk=prefill_chunk,
                        device=dev, **kw)
        seen, steps = [], []
        prefill = e._prefill_into_slot

        def recording(slot, req, prefill=prefill, seen=seen):
            out = prefill(slot, req)
            seen.append(out.float().cpu())
            return out

        e._prefill_into_slot = recording
        e.model = _Recording(e.model, steps)
        for p, mkw in zip(prompts3, modal):
            e.submit(p, max_new_tokens=16, **mkw)
        runs[dev] = ([(r.status, r.tokens) for r in e.run()], seen, steps,
                     e.weight_store)
        if caches is not None:
            caches[dev] = _to(e.cache, "cpu")
        del e
    return runs


def _check_parity(label: str, runs) -> None:
    """Greedy streams identical and admission logits within 1e-3.  On a
    differing stream, report the first differing index and the CPU's
    top-2 logit gap there (the requests decode in lockstep, slot = request
    index: token 0 comes from the admission logits, token i from decode
    step i - 1)."""
    (streams_c, adm_c, _, _), (streams_h, adm_h, steps_h, _) = (
        runs["cuda"], runs["cpu"])
    if streams_c != streams_h:
        for r, ((_, a), (_, c)) in enumerate(zip(streams_c, streams_h)):
            i = next((i for i, (x, y) in enumerate(zip(a, c)) if x != y),
                     None)
            if i is not None:
                lg = adm_h[r][0] if i == 0 else steps_h[i - 1][r]
                top = lg.topk(2).values
                log(f"[{label}] request {r}: first differing token index "
                    f"{i} (card {a[i]}, CPU {c[i]}); CPU top-2 logit gap "
                    f"there {float(top[0] - top[1]):.3e}")
        raise AssertionError(f"{label}: card vs CPU greedy streams differ")
    for a, c in zip(adm_c, adm_h):
        torch.testing.assert_close(a, c, atol=1e-3, rtol=0.0)
    lerr = max((a - c).abs().max().item() for a, c in zip(adm_c, adm_h))
    log(f"[{label}] card and CPU streams identical "
        f"({[len(t) for _, t in streams_c]} tokens), admission logits "
        f"max_abs_err {lerr:.3e}")


def phase3_parity(cfg):
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg3 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    model3 = build_model(cfg3)
    params3 = model3.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    prompts3 = [rng.integers(0, cfg3.vocab_size, 32).tolist()
                for _ in range(2)]
    _check_parity("parity fp32 2-layer full width",
                  _serve_both(model3, params3, prompts3))
    return model3, params3, prompts3


def _raw(t: torch.Tensor) -> torch.Tensor:
    t = t.cpu()
    return t.view(torch.uint8) if t.element_size() == 1 else t


def phase3b_quant_parity(model3, params3, prompts3):
    from repro_torch.bridge import flatten
    from repro_torch.models.attention import quantize_kv
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 64, 16, 128), generator=g) * 3.0
    for fmt in FORMATS:
        for a, c in zip(quantize_kv(x.cuda(), fmt), quantize_kv(x, fmt)):
            if not torch.equal(_raw(a), _raw(c)):
                raise AssertionError(f"quantize_kv {fmt}: card and CPU "
                                     f"bytes differ")
    log(f"[parity] quantize_kv bytes identical on card and CPU for "
        f"{', '.join(FORMATS)}")
    for fmt in ("float4_e2m1fn", "float8_e4m3fn"):
        label = f"parity fp32 2-layer full width, {fmt} weights and KV"
        runs = _serve_both(model3, params3, prompts3, weight_format=fmt,
                           packed=True, kv_format=fmt)
        card, host = (flatten(runs[d][3]) for d in ("cuda", "cpu"))
        tensors = [k for k, v in card.items() if isinstance(v, torch.Tensor)]
        if card.keys() != host.keys() or any(
                card[k] != host[k] for k in card if k not in tensors):
            raise AssertionError(f"{label}: weight store layouts differ")
        for k in tensors:
            if not torch.equal(_raw(card[k]), _raw(host[k])):
                raise AssertionError(f"{label}: weight store {k} differs "
                                     f"between card and CPU")
        log(f"[{label}] weight store byte-identical on card and CPU "
            f"({len(tensors)} tensors)")
        _check_parity(label, runs)


def phase3c_mamba2_parity():
    """mamba2-2.7b cut to 2 layers at full width, fp32, TF32 off (matmul
    and the cuDNN conv), card against CPU.  Prompts of 300 and 600
    tokens with prefill chunks of 512: the 300-token call spans an SSD
    chunk boundary inside the kernel (2 chunks of 256) and ends in a
    ragged tail; the 600-token prompt carries conv and state into a
    second call with 88 valid tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg3 = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2,
                               param_dtype="float32", compute_dtype="float32")
    model3 = build_model(cfg3)
    params3 = model3.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts3 = [rng.integers(0, cfg3.vocab_size, n).tolist()
                for n in (300, 600)]
    before = ssd_scan.launches
    runs = _serve_both(model3, params3, prompts3, max_seq=1024,
                       prefill_chunk=512)
    launched = ssd_scan.launches - before
    if launched != 3 * cfg3.n_layers:
        raise AssertionError(f"mamba2 parity: ssd_scan launched {launched}"
                             f" times, expected {3 * cfg3.n_layers}")
    _check_parity("parity mamba2 fp32 2-layer full width", runs)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _greedy(model, params, logits, cache, s: int, n: int):
    """``n`` greedy decode steps after a prefill of ``s`` tokens: (the
    stream of n + 1 tokens (b, n + 1), the logits of every step on the
    CPU (n, b, vocab))."""
    tok, stream, seen = logits.argmax(-1), [], []
    for i in range(n):
        stream.append(tok)
        pos = torch.full(tok.shape, s + i, dtype=torch.int32,
                         device=tok.device)
        lg = model.decode_step(params, cache, tok, pos)
        seen.append(lg.cpu())
        tok = lg.argmax(-1)
    stream.append(tok)
    return torch.stack(stream, 1).cpu(), torch.stack(seen)


def phase3d_whole_sequence_parity():
    """The whole-sequence path on the card and on the CPU, fp32, TF32 off,
    full width cut to 2 layers, the same seeded weights (the analog of
    ``tests/test_decode_consistency.py`` on the card).  gptneox-1b: 2 x
    300-token prompts, ``attn_chunk`` 1024 (the CPU's plain version takes
    ``full_attention``): prefill, 16 greedy decode steps, then forward
    over prompt + the first 16 tokens.  Streams identical; forward and
    prefill logits card vs CPU within atol 1e-3, the prefill cache's K/V
    within 1e-4; the card's decode (and prefill) logits against its own
    forward's within 5e-4.  mamba2-2.7b: prompts of 300 and 600 tokens,
    each prefilled alone, then 16 greedy steps: streams identical,
    prefill logits and the SSM carries and state (``ssm_forward``'s
    return_state) within atol 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = 16
    cfg = dataclasses.replace(get_config("gptneox-1b"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    prompts = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 300)))
    runs = {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        flash_attention.launches = flash_attention_plain.calls = 0
        logits, cache = model.prefill(p, {"tokens": prompts.to(dev)}, 320)
        # a copy on both devices: decode then writes into the cache
        kv = {name: cache["pos0"]["kv"][name].to("cpu", copy=True)
              for name in ("k", "v")}
        stream, steps = _greedy(model, p, logits, cache, 300, n)
        full, _ = model.forward(p, {"tokens": torch.cat(
            [prompts, stream[:, :n]], 1).to(dev)})
        counts = (flash_attention.launches, flash_attention_plain.calls)
        want = (2 * cfg.n_layers, 0) if dev == "cuda" else (
            0, 2 * cfg.n_layers)
        if counts != want:
            raise AssertionError(f"parity gptneox {dev}: (flash_attention "
                                 f"launches, plain calls) {counts}, "
                                 f"expected {want}")
        runs[dev] = (logits.cpu(), kv, stream, steps, full.cpu())
        del p, cache, full
    (lc, kvc, sc, stc, fc), (lh, kvh, sh, _, fh) = runs["cuda"], runs["cpu"]
    label = "parity whole-seq gptneox fp32 2-layer full width"
    if not torch.equal(sc, sh):
        raise AssertionError(f"{label}: card vs CPU greedy streams differ: "
                             f"{sc.tolist()} vs {sh.tolist()}")
    errs = {"forward": (fc - fh).abs().max().item(),
            "prefill": (lc - lh).abs().max().item(),
            "cache_kv": max((kvc[x] - kvh[x]).abs().max().item()
                            for x in kvc),
            "decode_vs_forward": max(
                (stc - fc[:, 300:300 + n].transpose(0, 1)).abs().max(),
                (lc - fc[:, 299]).abs().max()).item()}
    log(f"[{label}] streams identical ({sc.shape[1]} tokens x 2); "
        f"max_abs_err card vs CPU: forward {errs['forward']:.3e}, prefill "
        f"{errs['prefill']:.3e} (tol 1e-3), cache K/V {errs['cache_kv']:.3e}"
        f" (tol 1e-4); card decode vs card forward "
        f"{errs['decode_vs_forward']:.3e} (tol 5e-4)")
    for key, tol in (("forward", 1e-3), ("prefill", 1e-3),
                     ("cache_kv", 1e-4), ("decode_vs_forward", 5e-4)):
        if not errs[key] <= tol:
            raise AssertionError(f"{label}: {key} max_abs_err "
                                 f"{errs[key]:.3e} above {tol}")
    del runs, params, model

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(9)
    label = "parity whole-seq mamba2 fp32 2-layer full width"
    for s in (300, 600):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s)))
        runs = {}
        for dev in ("cuda", "cpu"):
            p = _to(params, dev)
            before = ssd_scan.launches
            logits, cache = model.prefill(p, {"tokens": prompt.to(dev)},
                                          s + n)
            launched = ssd_scan.launches - before
            if launched != (cfg.n_layers if dev == "cuda" else 0):
                raise AssertionError(f"{label}: ssd_scan launched "
                                     f"{launched} times on {dev}")
            state = {k: v.to("cpu", copy=True)
                     for k, v in cache["pos0"]["ssm"].items()}
            stream, _ = _greedy(model, p, logits, cache, s, n)
            runs[dev] = (logits.cpu(), state, stream)
            del p, cache
        (lc, stc, sc), (lh, sth, sh) = runs["cuda"], runs["cpu"]
        if not torch.equal(sc, sh):
            raise AssertionError(f"{label} s={s}: card vs CPU greedy "
                                 f"streams differ")
        lerr = (lc - lh).abs().max().item()
        serr = max((stc[k] - sth[k]).abs().max().item() for k in stc)
        log(f"[{label}] s={s}: streams identical ({sc.shape[1]} tokens); "
            f"prefill logits max_abs_err {lerr:.3e}, carries and state "
            f"{serr:.3e} (tol 1e-3); ssd_scan {cfg.n_layers} launches")
        if not (lerr <= 1e-3 and serr <= 1e-3):
            raise AssertionError(f"{label} s={s}: logits {lerr:.3e} or "
                                 f"state {serr:.3e} above 1e-3")


def phase3e_dense_family_parity():
    """The sampler and the dense-decoder family on the card and on the
    CPU, fp32, TF32 off.  The sampler at (8, 256000): ``random_bits`` and
    ``uniform`` bit-identical, gumbel within atol 2e-6 (``log`` may
    differ by an ulp), ``sample_tokens`` equal.  gemma2-2b cut to 2
    layers (one local, one global) at full width, with the window cut
    to 64 so that the rings wrap in a short run: 2 x 300-token prompts,
    16 new tokens, greedy and sampled (temperature 0.8, top_k 8, seed
    3); gemma-2b (MQA) cut to 2 layers, greedy.  Streams identical,
    admission logits within atol 1e-3, ``flash_decode`` once per layer
    per decode step on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.model import build_model
    from repro_torch.serve import prng, sampler
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = (8, 256000)
    key = prng.prng_key(3)
    keys = sampler.fold_slot_keys(key, torch.arange(8, dtype=torch.int32),
                                  torch.arange(300, 308, dtype=torch.int32))
    g_err = 0.0
    for k in (prng.fold_in(key, torch.tensor(7)), keys):
        if not torch.equal(prng.random_bits(k.cuda(), shape[1:]).cpu(),
                           prng.random_bits(k, shape[1:])):
            raise AssertionError("random_bits: card and CPU differ")
        u_c = prng.uniform(k.cuda(), shape[1:], prng.TINY, 1.0).cpu()
        u_h = prng.uniform(k, shape[1:], prng.TINY, 1.0)
        if not torch.equal(u_c.view(torch.int32), u_h.view(torch.int32)):
            raise AssertionError("uniform: card and CPU bits differ")
        g_c, g_h = prng.gumbel(k.cuda(), shape[1:]).cpu(), prng.gumbel(
            k, shape[1:])
        g_err = max(g_err, (g_c - g_h).abs().max().item())
    if not g_err <= 2e-6:
        raise AssertionError(f"gumbel: card vs CPU {g_err:.3e} above 2e-6")
    logits = torch.from_numpy(np.random.default_rng(13).standard_normal(
        shape, np.float32) * 4)
    seed = torch.arange(8, dtype=torch.int32) * 1000
    pos = torch.arange(300, 308, dtype=torch.int32)
    for temperature, top_k in ((0.8, 8), (1.0, 0)):
        args = (key, temperature, top_k)
        got = sampler.sample_tokens(logits.cuda(), args[0].cuda(), *args[1:],
                                    slot_seed=seed.cuda(), pos=pos.cuda())
        want = sampler.sample_tokens(logits, *args, slot_seed=seed, pos=pos)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"sample_tokens (temperature {temperature},"
                                 f" top_k {top_k}): card {got.tolist()}, "
                                 f"CPU {want.tolist()}")
    log(f"[parity sampler] {shape}: random_bits and uniform bit-identical "
        f"on card and CPU (a shared key and 8 folded keys), gumbel "
        f"max_abs_err {g_err:.3e} (tol 2e-6), sample_tokens equal")

    rng = np.random.default_rng(14)
    for arch, over, modes in (
            ("gemma2-2b", {"sliding_window": 64},
             ({}, dict(temperature=0.8, top_k=8, seed=3))),
            ("gemma-2b", {}, ({},))):
        cfg3 = dataclasses.replace(get_config(arch), n_layers=2,
                                   param_dtype="float32",
                                   compute_dtype="float32", **over)
        model3 = build_model(cfg3)
        params3 = model3.init(torch.Generator().manual_seed(0), "cpu")
        prompts3 = [rng.integers(0, cfg3.vocab_size, 300).tolist()
                    for _ in range(2)]
        for kw in modes:
            label = (f"parity {arch} fp32 2-layer full width"
                     f"{', window 64' if over else ''}, "
                     f"{'sampled' if kw else 'greedy'}")
            before = flash_decode.launches
            runs = _serve_both(model3, params3, prompts3, max_seq=320,
                               **kw)
            launched = flash_decode.launches - before
            steps = len(runs["cuda"][2])
            if launched != cfg3.n_layers * steps or not steps:
                raise AssertionError(f"{label}: flash_decode launched "
                                     f"{launched} times in {steps} steps")
            _check_parity(label, runs)
        del model3, params3


def phase3f_moe_parity():
    """jamba-v0.1-52b, kimi-k2-1t-a32b and llama4-maverick-400b-a17b
    reduced (``ArchConfig.reduced()``, fp32), TF32 off, at capacity
    factors 8.0 and 1.25, on the card and on the CPU: 2 x 40-token
    prompts in prefill chunks of 16 (the padded third chunk takes expert
    capacity) x 16 new tokens, greedy and sampled (temperature 0.8,
    top_k 8, seed 3).  Streams identical, admission logits within atol
    1e-4, ``flash_decode`` once per attention layer per decode step on
    the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(25)
    for arch in ("jamba-v0.1-52b", "kimi-k2-1t-a32b",
                 "llama4-maverick-400b-a17b"):
        for cf in (8.0, 1.25):
            cfg3 = dataclasses.replace(get_config(arch).reduced(),
                                       moe_capacity_factor=cf)
            model3 = build_model(cfg3)
            params3 = model3.init(torch.Generator().manual_seed(0), "cpu")
            prompts3 = [rng.integers(0, cfg3.vocab_size, 40).tolist()
                        for _ in range(2)]
            n_attn = cfg3.n_periods * sum(
                b.mixer == "attn" for b in cfg3.block_pattern())
            for kw in ({}, dict(temperature=0.8, top_k=8, seed=3)):
                label = (f"parity {arch} reduced fp32, cf {cf}, "
                         f"{'sampled' if kw else 'greedy'}")
                before = flash_decode.launches
                runs = _serve_both(model3, params3, prompts3, max_seq=64,
                                   prefill_chunk=16, **kw)
                launched = flash_decode.launches - before
                steps = len(runs["cuda"][2])
                if launched != n_attn * steps or not steps:
                    raise AssertionError(f"{label}: flash_decode launched "
                                         f"{launched} times in {steps} "
                                         f"steps")
                _check_parity(label, runs)
                for a, c in zip(runs["cuda"][1], runs["cpu"][1]):
                    torch.testing.assert_close(a, c, atol=1e-4, rtol=0.0)
            del model3, params3
    log("[parity moe] every admission logit within atol 1e-4")


def _ring_parity(label: str, got: dict, want: dict, fmt) -> str:
    """A ring on the card against the CPU's: ``slot_pos`` equal; dense
    fp32 K/V within 1e-5; quantized scale and code bytes equal but where
    an fp32 input sits on a rounding boundary of the format (at most 1
    in 1000 bytes: the two devices sum in different orders)."""
    if not torch.equal(got["slot_pos"], want["slot_pos"]):
        raise AssertionError(f"{label}: slot_pos differs")
    if fmt is None:
        err = max((got[n] - want[n]).abs().max().item() for n in "kv")
        torch.testing.assert_close(got["k"], want["k"], atol=1e-5, rtol=0)
        torch.testing.assert_close(got["v"], want["v"], atol=1e-5, rtol=0)
        return f"K/V max_abs_err {err:.3e}"
    diff = total = 0
    for n in ("k_q", "k_s", "v_q", "v_s"):
        a, c = _raw(got[n]), _raw(want[n])
        diff += int((a != c).sum())
        total += a.numel()
    if diff > total // 1000:
        raise AssertionError(f"{label}: {diff} of {total} bytes differ")
    return f"{diff} of {total} code / scale bytes differ"


def phase3g_modal_parity():
    """seamless-m4t-medium and internvl2-2b at full width cut to 2
    layers (seamless: 2 encoder layers), fp32, TF32 off, card against
    CPU: 2 requests x 16-token prompts x 16 new tokens, decode blocks of
    7; seamless with sources of 300 and 200 frames (enc_len 512) with
    dense, fp8 and fp4 KV, internvl2 with 64 patches each (chunks of
    32).  Streams identical, admission logits within atol = rtol 1e-5
    (dense KV) or atol 1e-3 (quantized: a code flipped at a rounding
    boundary moves a logit by ~1e-4), the ``enc_out`` rows within atol =
    rtol 1e-5 and the cross rings (:func:`_ring_parity`) as the CPU's;
    the decode kernel once a layer a step on the card (twice for
    seamless)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_quant import flash_decode_quant
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(26)
    for arch, fmts in (("seamless-m4t-medium",
                        (None, "float8_e4m3fn", "float4_e2m1fn")),
                       ("internvl2-2b", (None,))):
        cfg3 = dataclasses.replace(
            get_config(arch), n_layers=2, param_dtype="float32",
            compute_dtype="float32",
            n_encoder_layers=2 if get_config(arch).is_encoder_decoder else 0)
        model3 = build_model(cfg3)
        params3 = model3.init(torch.Generator().manual_seed(0), "cpu")
        prompts3 = [rng.integers(0, cfg3.vocab_size, 16).tolist()
                    for _ in range(2)]
        encdec = cfg3.is_encoder_decoder
        modal = [{"frames": rng.standard_normal((n, cfg3.d_model),
                                                np.float32) * 0.02}
                 if encdec else
                 {"patches": rng.standard_normal((64, cfg3.d_model),
                                                 np.float32) * 0.02}
                 for n in (300, 200)]
        per_step = cfg3.n_layers * (2 if encdec else 1)
        for fmt in fmts:
            label = f"parity {arch} 2 layers fp32, {fmt or 'dense'} KV"
            counter = flash_decode_quant if fmt else flash_decode
            before = counter.launches
            caches = {}
            runs = _serve_both(model3, params3, prompts3, max_seq=128,
                               modal=modal, caches=caches, kv_format=fmt,
                               **({"enc_len": 512} if encdec else {}))
            launched = counter.launches - before
            steps = len(runs["cuda"][2])
            if launched != per_step * steps or not steps:
                raise AssertionError(f"{label}: {counter.__name__} "
                                     f"launched {launched} times in "
                                     f"{steps} steps")
            _check_parity(label, runs)
            lerr = max((a - c).abs().max().item()
                       for a, c in zip(runs["cuda"][1], runs["cpu"][1]))
            # dense: summation order only; quantized: a code that flips
            # at a rounding boundary moves a logit by ~1e-4 (phase 3b's
            # tolerance)
            ltol = dict(atol=1e-3, rtol=0.0) if fmt else dict(atol=1e-5,
                                                               rtol=1e-5)
            for a, c in zip(runs["cuda"][1], runs["cpu"][1]):
                torch.testing.assert_close(a, c, **ltol)
            note = f"admission logits max_abs_err {lerr:.3e} (tol {ltol})"
            if encdec:
                got, want = caches["cuda"], caches["cpu"]
                eerr = (got["enc_out"] - want["enc_out"]).abs().max().item()
                torch.testing.assert_close(got["enc_out"], want["enc_out"],
                                           atol=1e-5, rtol=1e-5)
                ring = _ring_parity(label, got["pos0"]["cross_kv"],
                                    want["pos0"]["cross_kv"], fmt)
                note += (f"; enc_out max_abs_err {eerr:.3e} (tol atol = "
                         f"rtol 1e-5); "
                         f"cross rings: {ring}")
            log(f"[{label}] {note}")
        del model3, params3


# --------------------------------------------------------------------- #
# speculative serving (2m at full width, 3h card against CPU)
# --------------------------------------------------------------------- #

def _cyclic_prompts(n: int = 8, length: int = 256):
    """Period-3 cyclic prompts with a per-request phase
    (``benchmarks/serve_spec.py``'s traffic)."""
    return [[1 + (i + j) % 3 for j in range(length)] for i in range(n)]


def _first_diff(a, b):
    """Index of the first differing token of two streams, or
    "identical"."""
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None and len(a) != len(b):
        i = min(len(a), len(b))
    return "identical" if i is None else i


def _spec_leg(eng, prompts, label, counters):
    """Warm up, then serve ``prompts`` x 64 new tokens with every
    (wrapper, expected launches (decode steps, D+1)) of ``counters`` set
    to 0 just before and checked just after; every request must end
    ``ok`` with 64 tokens.  Then one more run of the same traffic: after
    its admission and a first dispatch, one dispatch of 4 blocks (16
    steps without speculation) timed on the wall clock and the next one
    profiled.  Returns the metrics and the streams."""
    spec = eng.spec
    s = spec.draft_tokens + 1 if spec else 1
    eng.submit(list(range(1, 41)), max_new_tokens=4)         # warm-up
    eng.run()
    eng.reset()
    for p in prompts:
        eng.submit(p, max_new_tokens=64)
    for wrapper, _ in counters:
        wrapper.launches = 0
    torch.cuda.synchronize()
    t_run = time.monotonic()
    results = eng.run()
    torch.cuda.synchronize()
    launched = {w.__name__: w.launches for w, _ in counters}
    bad = [(r.request_id, r.status, len(r.tokens)) for r in results
           if r.status != "ok" or len(r.tokens) != 64]
    if len(results) != len(prompts) or bad:
        raise AssertionError(f"{label}: not ok: {bad}")
    vocab = eng.model.cfg.vocab_size
    if not all(0 <= t < vocab for r in results for t in r.tokens):
        raise AssertionError(f"{label}: token id out of range")
    steps = eng.decode_steps
    for wrapper, want in counters:
        if launched[wrapper.__name__] != want(steps, s):
            raise AssertionError(
                f"{label}: {wrapper.__name__} launched "
                f"{launched[wrapper.__name__]} times; expected "
                f"{want(steps, s)} ({steps} decode positions)")
    decode_s = (max(r.finish_t for r in results)
                - max(r.first_token_t for r in results))
    blocks = steps // s
    rep = eng.spec_report()
    out = {"streams": [r.tokens for r in results], "launches": launched,
           "tok_s": sum(len(r.tokens) - 1 for r in results) / decode_s,
           "block_ms": 1e3 * decode_s / blocks,
           "prefill_s": max(r.first_token_t for r in results) - t_run,
           "mean_accepted_len": rep["mean_accepted_len"]}
    units = 4 if spec else 16                  # blocks, or decode steps
    eng.reset()
    for p in prompts:
        eng.submit(p, max_new_tokens=64)
    eng.decode_loop(units * s)                 # admission + first dispatch
    _, wall = _timed(lambda: eng.decode_loop(units * s))
    busy, _, n_kern, top, _ = profile_fn(
        lambda: eng.decode_loop(units * s), "flash_decode")
    out.update(wall_block_ms=1e3 * wall / units,
               busy_block_ms=busy / units, kernels_block=n_kern / units,
               idle_share=1 - busy / (1e3 * wall))
    unit = "block" if spec else "step"
    log(f"[{label}] {len(results)} requests ok x 64 tokens: decode "
        f"{out['tok_s']:.1f} tok/s, {blocks} {unit}s in {eng.dispatches} "
        f"dispatches ({out['block_ms']:.2f} ms a {unit}), prefill "
        f"{out['prefill_s']:.3f} s"
        + (f", mean_accepted_len {rep['mean_accepted_len']:.4f} over "
           f"{rep['blocks']} slot-blocks" if spec else "")
        + f"; launches {launched}")
    log(f"[{label}] a {units}-{unit} dispatch: "
        f"{out['wall_block_ms']:.2f} ms wall and "
        f"{out['busy_block_ms']:.3f} ms device busy a {unit} "
        f"({out['kernels_block']:.0f} kernels), idle share "
        f"{out['idle_share']:.3f}; top {top}")
    return out


def _no_sync_block(eng, prompts, label):
    """Admission and a first dispatch, then one speculative block under
    ``set_sync_debug_mode("error")``; the run then goes on to its end."""
    eng.reset()
    for p in prompts:
        eng.submit(p, max_new_tokens=64)
    eng.decode_loop(eng.spec.draft_tokens + 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emits = eng._spec_block()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.decode_steps += eng.spec.draft_tokens + 1
    eng._harvest(toks.T, emits.T)
    res = eng.run()
    if not all(r.status == "ok" and len(r.tokens) == 64 for r in res):
        raise AssertionError(f"{label}: after the block: "
                             f"{[(r.status, len(r.tokens)) for r in res]}")
    log(f"[{label}] one speculative block under "
        f"set_sync_debug_mode('error'): no synchronisation; the run went "
        f"on, every request ok")


def phase2m_speculation():
    """Speculative serving at full width, bf16, seeded weights: gptneox-1b
    and mamba2-2.7b, both cut to ``CUT_LAYERS`` layers, batch 8,
    max_seq 1024, prefill chunks
    of 256, 8 cyclic 256-token prompts x 64 new tokens, each speculative
    run beside the non-speculative run of the same traffic."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain)
    from repro_torch.kernels.flash_decode_quant import (
        flash_decode_quant, flash_decode_quant_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine, SpecConfig
    plains = (flash_decode_plain, flash_decode_quant_plain, ssd_scan_plain,
              flash_attention_plain)
    for p in plains:
        p.calls = 0
    prompts = _cyclic_prompts()
    none = (lambda steps, s: 0)
    out = {}

    cfg = dataclasses.replace(get_config("gptneox-1b"), n_layers=CUT_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    settings = dict(batch=8, max_seq=1024, decode_block=16,
                    prefill_chunk=256, device="cuda")
    for kv in (None, "float8_e4m3fn"):
        name = "dense" if kv is None else "fp8"
        kernel = flash_decode if kv is None else flash_decode_quant
        base = _spec_leg(
            ServeEngine(model, params, kv_format=kv, **settings), prompts,
            f"spec gptneox {name} KV, no speculation",
            [(kernel, lambda steps, s: cfg.n_layers * steps)])
        eng = ServeEngine(model, params, kv_format=kv, spec=SpecConfig(),
                          **settings)
        got = _spec_leg(eng, prompts, f"spec gptneox {name} KV, n-gram",
                        [(flash_decode, none), (flash_decode_quant, none)])
        if kv is not None:
            _no_sync_block(eng, prompts, f"spec gptneox {name} KV, n-gram")
        out[f"gptneox {name} n-gram"] = (got, base)
        del eng
    eng = ServeEngine(model, params, spec=SpecConfig(
        draft_tokens=3, draft_model=model, draft_params=params), **settings)
    got = _spec_leg(eng, prompts, "spec gptneox dense KV, self-draft D 3",
                    [(flash_decode,
                      lambda steps, s: cfg.n_layers * 3 * (steps // s)),
                     (flash_decode_quant, none)])
    _no_sync_block(eng, prompts, "spec gptneox dense KV, self-draft D 3")
    out["gptneox dense self-draft"] = (got, out["gptneox dense n-gram"][1])
    del eng, params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                              n_layers=CUT_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    admission = (lambda steps, s: len(prompts) * cfg.n_layers)
    base = _spec_leg(ServeEngine(model, params, **settings), prompts,
                     "spec mamba2, no speculation", [(ssd_scan, admission)])
    got = _spec_leg(ServeEngine(model, params, spec=SpecConfig(),
                                **settings), prompts, "spec mamba2, n-gram",
                    [(ssd_scan, admission)])
    out["mamba2 n-gram"] = (got, base)
    del params
    torch.cuda.empty_cache()

    called = {p.__name__: p.calls for p in plains}
    if any(called.values()):
        raise AssertionError(f"speculation: plain versions called {called}")
    for label, (got, base) in out.items():
        diffs = [_first_diff(a, b) for a, b in zip(got["streams"],
                                                   base["streams"])]
        log(f"[spec {label}] {got['tok_s']:.1f} tok/s against "
            f"{base['tok_s']:.1f} without speculation; per request, the "
            f"first index where the streams differ: {diffs}")
    log(f"[spec] plain versions called: {called}")
    return {label: {"launches": got["launches"], "tok_s": got["tok_s"],
                    "base_tok_s": base["tok_s"],
                    "mean_accepted_len": got["mean_accepted_len"]}
            for label, (got, base) in out.items()}


def _spec_parity(label, model3, params3, prompts3, make_spec, n_new=24,
                 **kw):
    """Serve ``prompts3`` x ``n_new`` speculating on the card and on the
    CPU (``make_spec(device)`` gives each its SpecConfig), and without
    speculation on the card: the three streams identical, the
    ``spec_report`` the same on both devices."""
    from repro_torch.serve import ServeEngine
    got = {}
    for dev, spec in (("cuda", None), ("cuda", True), ("cpu", True)):
        eng = ServeEngine(model3, params3, batch=2, max_seq=64,
                          decode_block=8, prefill_chunk=16, device=dev,
                          spec=make_spec(dev) if spec else None, **kw)
        for p in prompts3:
            eng.submit(p, max_new_tokens=n_new)
        streams = [(r.status, r.tokens) for r in eng.run()]
        got[(dev, spec)] = (streams, eng.spec_report())
    (card, rep_c), (cpu, rep_h) = got[("cuda", True)], got[("cpu", True)]
    plain = got[("cuda", None)][0]
    if not all(s == "ok" and len(t) == n_new for s, t in card):
        raise AssertionError(f"{label}: {[(s, len(t)) for s, t in card]}")
    if card != plain or card != cpu:
        diffs = {other: [_first_diff(a, b) for (_, a), (_, b)
                         in zip(card, streams)]
                 for other, streams in (("the card without speculation",
                                         plain), ("the CPU", cpu))}
        raise AssertionError(f"{label}: first differing index against "
                             f"{diffs}")
    if rep_c != rep_h:
        raise AssertionError(f"{label}: spec_report card {rep_c} != CPU "
                             f"{rep_h}")
    log(f"[{label}] speculative streams identical on card and CPU and to "
        f"the card's non-speculative ones; spec_report {rep_c}")
    return rep_c


def phase3h_spec_parity(model3, params3):
    """Speculative serving card against CPU, fp32, TF32 off: gptneox-1b
    at full width cut to 2 layers (phase 3's model) with dense and fp4
    KV, mamba2-2.7b cut the same way and jamba-v0.1-52b reduced at
    capacity factor 8.0, n-gram drafting (3 drafts, a table of 64) on 2
    cyclic 32-token prompts x 24 new tokens; on gptneox also a scripted
    ``draft_fn`` that drafts the non-speculative stream (accept-all) and
    one that never does (reject-all)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine, SpecConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts3 = _cyclic_prompts(2, 32)
    ngram = (lambda dev: SpecConfig(draft_tokens=3, ngram_table=64))
    for kv in (None, "float4_e2m1fn"):
        _spec_parity(f"parity spec gptneox 2-layer fp32, "
                     f"{kv or 'dense'} KV, n-gram", model3, params3,
                     prompts3, ngram, kv_format=kv)

    # scripted drafts: the oracle is the card's non-speculative stream
    eng = ServeEngine(model3, params3, batch=2, max_seq=64, decode_block=8,
                      prefill_chunk=16, device="cuda")
    for p in prompts3:
        eng.submit(p, max_new_tokens=24)
    tbl = np.full((2, 64), -7, np.int32)
    for slot, r in enumerate(eng.run()):
        tbl[slot, 32:32 + len(r.tokens)] = r.tokens
    vocab = model3.cfg.vocab_size

    def scripted(accept):
        def make(dev):
            t = torch.from_numpy(tbl).to(dev)

            def draft_fn(st):
                q = (st["pos"][:, None] + 1 + torch.arange(
                    3, dtype=torch.int32, device=dev)[None, :]).clamp_max(
                        63).long()
                right = t.gather(1, q)
                return right if accept else (right + 1) % vocab
            return SpecConfig(draft_tokens=3, ngram_table=64,
                              draft_fn=draft_fn)
        return make

    for accept in (True, False):
        rep = _spec_parity(f"parity spec gptneox 2-layer fp32, draft_fn "
                           f"{'accept' if accept else 'reject'}-all",
                           model3, params3, prompts3, scripted(accept))
        if (rep["mean_accepted_len"] == 1.0) == accept:
            raise AssertionError(f"scripted drafts: {rep}")

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    mamba = build_model(cfg)
    _spec_parity("parity spec mamba2 2-layer fp32, n-gram", mamba,
                 mamba.init(torch.Generator().manual_seed(0), "cpu"),
                 prompts3, ngram)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              moe_capacity_factor=8.0)
    jamba = build_model(cfg)
    _spec_parity("parity spec jamba reduced fp32 cf 8.0, n-gram", jamba,
                 jamba.init(torch.Generator().manual_seed(0), "cpu"),
                 prompts3, ngram)


def phase4_characterize():
    """``repro_torch.launch.characterize`` at the reference example's
    sizes, the counters set to 0 just before and read just after; then a
    pointer chase over 1 GiB for the HBM plateau."""
    from repro_torch.kernels import probe_chase as pc
    from repro_torch.launch import characterize
    counters = _probe_counters()
    for kern, plain in counters.values():
        kern.launches, plain.calls = 0, 0
    t0 = time.perf_counter()
    out = characterize.run(log=lambda line: log(f"[characterize] {line}"
                                                if line else "[characterize]"))
    counts = {k: kern.launches for k, (kern, _) in counters.items()}
    plain = {k: p.calls for k, (_, p) in counters.items()}
    log(f"[characterize] {time.perf_counter() - t0:.1f} s; kernel launches "
        f"{counts}; plain version calls {plain}")
    if not all(counts.values()) or any(plain.values()):
        raise AssertionError(f"characterize: kernel launches {counts}, "
                             f"plain calls {plain}")
    nums = [out["clock_hz"], out["timer_overhead_cycles"], out["fp64_factor"]]
    nums += [getattr(r, f) for r in out["latency"]
             for f in ("true_cycles", "completion_cycles")]
    nums += [p.cycles_per_load for p in out["chase"]]
    nums += [p.tflops for p in out["matmul"]]
    nums += [r.gbps for r in out["bandwidth"]]
    if len(out["latency"]) != 5 or len(out["chase"]) != 7 \
            or len(out["matmul"]) != 9 or len(out["support"]) != 5 \
            or not all(math.isfinite(v) and v > 0 for v in nums):
        raise AssertionError(f"characterize: results missing or not "
                             f"finite and positive: {nums}")
    n = 1 << 28                                  # 1 GiB, 20x the L2
    buf = torch.from_numpy(pc.chase_cycle(n, 5)).cuda()
    runs = [pc.chase_timed(buf, 8192) for _ in range(3)]
    cyc = statistics.median(r.cycles for r in runs) / 8192
    ns = statistics.median(r.ns for r in runs) / 8192
    log(f"[characterize] chase over 1 GiB (HBM): {cyc:.3f} cycles, "
        f"{ns:.3f} ns per load (paper GH100 global: 658.7 cycles)")
    del buf
    torch.cuda.empty_cache()
    return counts


def _fa_bwd_bound(spec, flags, hbm, peak):
    """(bound ms, bound_by, bytes, flops) of one backward call: q, k, v,
    o, dO read and dq, dk, dv written once; 10 d flops per visible
    (query, key) pair and q head (S and dP recomputed, dV, dQ, dK)."""
    b, s, hq, hkv, d = (spec[n] for n in ("b", "s", "hq", "hkv", "d"))
    elt = 2 if spec["dtype"] == torch.bfloat16 else 4
    moved = elt * (4 * b * s * hq * d + 4 * b * s * hkv * d)
    _, pairs = fa_visible(s, s, **flags)
    flops = 10 * d * pairs * b * hq
    ms, by = bound(moved, flops, hbm, peak)
    return ms, by, moved, flops


def _bwd_passes(prof_kern, prefix: str = "fa_bwd_") -> dict:
    """{backward pass kernel: (device ms, launches)} of a profile's CUDA
    kernel events named ``prefix`` + a word ending in ``_kernel``:
    ``fa_bwd_dot`` (A), ``fa_bwd_dkdv(_tc)`` (B), ``fa_bwd_reduce`` (R),
    ``fa_bwd_dq(_tc)`` (C) of ``flash_attention_bwd``; with ``ssdb_``
    the passes of ``ssd_scan_bwd``."""
    out = {}
    for e in prof_kern:
        m = re.search(prefix + r"\w+?_kernel", e.key)
        if m:
            ms, n = out.get(m.group(0), (0.0, 0))
            out[m.group(0)] = (ms + e.self_device_time_total / 1e3,
                               n + e.count)
    return out


def _profile_bwd(fn, calls: int = 4) -> dict:
    """``fn()`` ``calls`` times under ``torch.profiler`` (CUDA activity),
    queued behind ``torch.cuda._sleep`` (the profiler has dropped the
    first kernels of a window): {pass kernel: (device ms a launch,
    launches recorded)}, each pass launching once a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    passes = _bwd_passes([e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA])
    return {k: (ms / n, n) for k, (ms, n) in passes.items()}


def phase1h_flash_attention_bwd(model):
    """``flash_attention_bwd`` against ``flash_attention_bwd_plain`` (the
    explicit formulas in fp32 on the same inputs, the plain version's own
    LSE), given the output and LSE that ``flash_attention_lse`` (the
    forward kernel) stored, first held to ``flash_attention_plain`` (bf16
    atol 2e-2, fp32 2e-5, as 1f) and ``attention_lse_plain`` (fp32, atol
    1e-4), on the card: (a) the
    training path's shape, qwen2.5-3b at b 8, s 256, hq 16 over hkv 2,
    d 128, bf16, causal; (b) row 5's shape, b 8, s 2048, hq = hkv = 16,
    d 128, bf16, causal; (c) d 256 with window 512 and softcap 50 (gemma2's
    head_dim), b 2, s 1024, hq 8 over hkv 4; (d) non-causal d 64 (the
    seamless encoder), b 4, s 1000, 16 heads; (e) fp32, b 4, s 512, hq 16
    over hkv 2; (f) fp32 with softcap 5 and q scaled by 4, so that the raw
    scores (sd 4) reach the cap and the chain factor ``1 - t^2`` spans
    ~1 to ~0 (at (c) the scores sit near 1 and the factor near 1), b 2,
    s 512, hq 8 over hkv 2.  Tolerance: bf16 atol 1e-2 x the largest |grad| (the
    outputs' bf16 rounding), fp32 atol 1e-5 x the largest |grad|
    (summation order); two calls bit-identical (no atomics).  Each case
    timed (kernel, plain version, the backward of SDPA where SDPA takes
    the case, which it does not under a window or a softcap: a yardstick
    the port never calls) beside its bound, and its passes' device times
    read from a profile (the dQ pass's share of the call)."""
    from repro_torch import compat
    from repro_torch.kernels.flash_attention import (
        attention_lse_plain, bwd_plan, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_lse,
        flash_attention_plain)
    hbm, peak_bf16 = model.hbm.bandwidth_Bps, model.peak_flops["bfloat16"]
    peak_f32 = model.vector_flops["float32"]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {
        "a_qwen_train": (dict(b=8, s=256, hq=16, hkv=2, d=128, dtype=bf16),
                         {}),
        "b_row5": (dict(b=8, s=2048, hq=16, hkv=16, d=128, dtype=bf16), {}),
        "c_d256_window512_softcap50": (
            dict(b=2, s=1024, hq=8, hkv=4, d=256, dtype=bf16),
            dict(window=512, softcap=50.0)),
        "d_non_causal_d64": (dict(b=4, s=1000, hq=16, hkv=16, d=64,
                                  dtype=bf16), dict(causal=False)),
        "e_fp32": (dict(b=4, s=512, hq=16, hkv=2, d=128, dtype=f32), {}),
        "f_fp32_softcap5_q4": (
            dict(b=2, s=512, hq=8, hkv=2, d=128, dtype=f32, q_scale=4.0),
            dict(softcap=5.0)),
    }

    def inputs(spec, seed):
        q, k, v = fa_case(seed, spec["b"], spec["s"], spec["s"], spec["hq"],
                          spec["hkv"], spec["d"], spec["dtype"])
        q = q * spec.get("q_scale", 1.0)
        g = torch.Generator(device="cuda").manual_seed(seed)
        do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
        return q, k, v, do

    entries = []
    for i, (case, (spec, flags)) in enumerate(cases.items()):
        q, k, v, do = inputs(spec, 70 + i)
        o, lse = flash_attention_lse(q, k, v, **flags)
        o_want = flash_attention_plain(q, k, v, **flags)
        lse_want = attention_lse_plain(q, k, **flags)
        torch.cuda.synchronize()
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"flash_attention_lse {case}: not finite")
        o_tol = 2e-2 if spec["dtype"] == bf16 else 2e-5
        o_err = (o.float() - o_want.float()).abs().max().item()
        lse_err = (lse - lse_want).abs().max().item()
        log(f"[kernel] flash_attention_lse {case}: the forward's output "
            f"max_abs_err {o_err:.3e} (tol atol {o_tol}), LSE max_abs_err "
            f"{lse_err:.3e} (tol atol 1e-4)")
        torch.testing.assert_close(o.float(), o_want.float(), rtol=0.0,
                                   atol=o_tol)
        torch.testing.assert_close(lse, lse_want, rtol=0.0, atol=1e-4)
        del o_want
        pl = bwd_plan(q, k, v, o, do, lse, flags.get("window"),
                      compat.sm_count(q.device.index))
        log(f"[kernel] flash_attention_bwd {case} plan: {pl.kv_blocks} dK / "
            f"dV blocks of {pl.keys} keys (head_split {pl.head_split}), "
            f"{pl.dq_blocks} dQ blocks of {pl.dq_rows} queries, "
            f"{pl.launches} launches, shared memory {pl.kv_smem} / "
            f"{pl.dq_smem} B, {pl.part_floats * 4} B of partials")
        got = flash_attention_bwd(q, k, v, o, do, lse=lse, **flags)
        again = flash_attention_bwd(q, k, v, o, do, lse=lse, **flags)
        want = flash_attention_bwd_plain(q, k, v, o, do, **flags)
        torch.cuda.synchronize()
        frac = 1e-2 if spec["dtype"] == bf16 else 1e-5
        err = 0.0
        for name, x, y, z in zip("qkv", got, again, want):
            if not torch.isfinite(x).all():
                raise AssertionError(f"flash_attention_bwd {case}: d{name} "
                                     f"is not finite")
            if not torch.equal(x, y):
                raise AssertionError(f"flash_attention_bwd {case}: d{name} "
                                     f"differs between two calls")
            scale = z.float().abs().max().item()
            e = (x.float() - z.float()).abs().max().item()
            log(f"[kernel] flash_attention_bwd {case}: d{name} max_abs_err "
                f"{e:.3e} (tol {frac:g} x max |d{name}| {scale:.4g})")
            torch.testing.assert_close(x.float(), z.float(), rtol=0.0,
                                       atol=frac * scale)
            err = max(err, e)
        del got, again, want, lse_want
        sets = [(q, k, v, o, do, lse)]
        for j in range(n_sets(nbytes(q, k, v, o, do)) - 1):
            qj, kj, vj, doj = inputs(spec, 170 + 10 * i + j)
            oj, lsej = flash_attention_lse(qj, kj, vj, **flags)
            sets.append((qj, kj, vj, oj, doj, lsej))

        def kern(q, k, v, o, do, lse):
            return flash_attention_bwd(q, k, v, o, do, lse=lse, **flags)

        def plain(q, k, v, o, do, lse):
            return flash_attention_bwd_plain(q, k, v, o, do, **flags)

        ms = time_ms(kern, sets)
        passes = _profile_bwd(lambda: kern(*sets[0]))
        total = sum(t for t, _ in passes.values())
        dq_ms = sum(t for n, (t, _) in passes.items() if "_dq" in n)
        log(f"[kernel] flash_attention_bwd {case} passes (profiled, ms a "
            f"launch, launches recorded in 4 calls): "
            + ", ".join(f"{n} {t:.4f} ({c})" for n, (t, c) in
                        passes.items())
            + f"; dQ {dq_ms / max(total, 1e-9):.3f} of {total:.4f} ms")
        plain_ms = time_ms(plain, sets[:1], reps=3, n=1)
        library_ms = None
        if "window" not in flags and "softcap" not in flags:
            lib_sets = []
            for q_, k_, v_, _, do_, _ in sets:
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                              for t in (q_, k_, v_))
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=flags.get("causal", True),
                    enable_gqa=spec["hq"] != spec["hkv"])
                lib_sets.append((out, qt, kt, vt, do_.transpose(1, 2)))

            def sdpa_bwd(out, qt, kt, vt, dot):
                return torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)

            library_ms = time_ms(sdpa_bwd, lib_sets)
            del lib_sets
        peak, peak_name = ((peak_bf16, "bf16") if spec["dtype"] == bf16
                           else (peak_f32, "fp32"))
        bound_ms, bound_by, moved, flops = _fa_bwd_bound(spec, flags, hbm,
                                                         peak)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"[kernel] flash_attention_bwd {case} timing: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"sdpa backward {lib}, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{moved} B at {hbm / 1e12:g} TB/s, {flops} flop at {peak_name} "
            f"{peak / 1e12:g} TFLOP/s); {len(sets)} input sets")
        causal = "non_causal" if flags.get("causal") is False else "causal"
        entries.append({
            "name": f"flash_attention_bwd[{case},b{spec['b']}_s{spec['s']}_"
                    f"hq{spec['hq']}_hkv{spec['hkv']}_d{spec['d']}_"
                    f"{peak_name}_{causal}]",
            "route": "cuda", "source": FAB_SOURCE, "replaces": FAB_REPLACES,
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
        del sets, q, k, v, o, do, lse
        torch.cuda.empty_cache()
    return entries

def _ssd_bwd_bound(x, b, states, dfinal, chunk, hbm, peak_f32, peak_tf32):
    """(bound ms, bound_by, bytes, flops, fp32 ms, split-TF32 ms) of one
    backward call: x, dy, dt_a, b, c, the states (and dfinal) read and
    dx, d dt_a, db, dc, d initial_state written once; per (row, chunk)
    C·Bᵀ over its causal pairs (2 n a pair), per head M, the quadratic
    dx, dc and db (2 (2 p + 2 n) a pair) and the four (q, p, n) products
    (dS' b, dS'ᵀ x, Sᵀ dy, the dS update: 8 q p n).  The flops bound is
    the fp32 CUDA-core rate or, three products each, the TF32 rate,
    whichever is less."""
    bt, s, h, p = x.shape
    n = b.shape[-1]
    nc, pairs = s // chunk, chunk * (chunk + 1) // 2
    flops = bt * nc * (h * (pairs * (4 * p + 4 * n) + 8 * chunk * p * n)
                       + 2 * pairs * n)
    moved = (3 * nbytes(x) + 2 * bt * s * h * 4 + 4 * nbytes(b)
             + nbytes(states) + bt * h * p * n * 4
             + (nbytes(dfinal) if dfinal is not None else 0))
    t_f32 = flops / peak_f32 * 1e3
    t_tf32 = 3 * flops / peak_tf32 * 1e3
    ms, by = bound(moved, 0, hbm, 1.0)
    t_ops = min(t_f32, t_tf32)
    if t_ops > ms:
        ms, by = t_ops, "operations"
    return ms, by, moved, flops, t_f32, t_tf32


def phase1i_ssd_scan_bwd(model):
    """``ssd_scan_bwd`` against ``ssd_scan_bwd_plain`` (the explicit
    formulas in fp32, chunk by chunk) on the card, on the same inputs
    and the plain forward's states (``ssd_scan_plain(states=True)``):
    (a) mamba2-2.7b's training call, bt 4, s 512, 80 heads, p 64, n 128,
    fp32 x, bf16 b / c, chunk 256; (b) bt 8, s 2048; (c) jamba's SSM, 128
    heads, n 16, bt 2, s 1024; (d) s 100 at chunk 32, padded (dy 0 on
    the tail, as the slice's backward gives it), with an initial state
    and a final-state cotangent; (e) bf16 x; (f) p 48, n 64; (g) (a)
    given the states the forward kernel stored (``ssd_scan_states``).
    Tolerance: each gradient within atol 1e-4 x the plain gradient's
    largest magnitude (the order of fp32 sums over up to q positions,
    80 heads and p; a bf16 gradient also within one bf16 ulp, rtol
    2^-7: both sides round one fp32 sum); two calls bit-identical (no
    atomics).  (a)-(f) timed (kernel, plain version) beside the bound
    (:func:`_ssd_bwd_bound`), the passes' device times from a profile;
    no PyTorch call computes an SSD backward, so there is no
    yardstick."""
    from repro_torch import compat
    from repro_torch.kernels.ssd_scan import (bwd_plan, ssd_scan_bwd,
                                              ssd_scan_bwd_plain,
                                              ssd_scan_plain, ssd_scan_states)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    hbm = model.hbm.bandwidth_Bps
    peak_f32 = model.vector_flops["float32"]
    peak_tf32 = model.peak_flops["float32"]
    bf16 = torch.bfloat16
    train = dict(bt=4, s=512, h=80, p=64, n=128, bc_dtype=bf16,
                 with_state=False)
    # case -> (ssd_case spec, chunk, a final-state cotangent, the forward
    # kernel's states)
    cases = {
        "a_mamba2_train": (dict(train, seed=81), 256, False, False),
        "b_bt8_s2048": (dict(train, seed=82, bt=8, s=2048), 256, False,
                        False),
        "c_jamba_h128_n16": (dict(train, seed=83, bt=2, s=1024, h=128,
                                  n=16), 256, False, False),
        "d_s100_chunk32": (dict(seed=84, bt=2, s=100, h=4, p=64, n=128,
                                bc_dtype=bf16), 32, True, False),
        "e_bf16_x": (dict(train, seed=85, x_dtype=bf16), 256, False, False),
        "f_p48_n64": (dict(train, seed=86, p=48, n=64), 256, False, False),
        "g_kernel_states": (dict(train, seed=87), 256, False, True),
    }

    def inputs(spec, chunk, with_dfinal, kernel_states, shift=0):
        seed = spec["seed"] + shift
        x, dt_a, b, c, h0 = ssd_case(**dict(spec, seed=seed))
        g = torch.Generator(device="cuda").manual_seed(seed)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
        x, dt_a, b, c, dy = _pad_seq([x, dt_a, b, c, dy], chunk)
        bt, _, h, p = x.shape
        dfinal = (torch.randn((bt, h, p, b.shape[-1]), generator=g,
                              device="cuda") if with_dfinal else None)
        _, _, states = ssd_scan_plain(x, dt_a, b, c, chunk, h0, states=True)
        fwd_states = (ssd_scan_states(x, dt_a, b, c, chunk, h0)[2]
                      if kernel_states else states)
        return x, dt_a, b, c, states, fwd_states, dy, dfinal

    entries = []
    names = ("dx", "d dt_a", "db", "dc", "d initial_state")
    for case, (spec, chunk, with_dfinal, kernel_states) in cases.items():
        x, dt_a, b, c, states, fwd_states, dy, dfinal = inputs(
            spec, chunk, with_dfinal, kernel_states)
        if kernel_states:
            torch.cuda.synchronize()
            st_err = (fwd_states - states).abs().max().item()
            log(f"[kernel] ssd_scan_bwd {case}: the forward kernel's states "
                f"max_abs_err {st_err:.3e} against the plain ones")
        pl = bwd_plan(x, dt_a, b, c, fwd_states, dy, dfinal, chunk,
                      compat.sm_count(x.device.index))
        before = ssd_scan_bwd.launches
        got = ssd_scan_bwd(x, dt_a, b, c, fwd_states, dy, dfinal, chunk)
        again = ssd_scan_bwd(x, dt_a, b, c, fwd_states, dy, dfinal, chunk)
        want = ssd_scan_bwd_plain(x, dt_a, b, c, states, dy, dfinal, chunk)
        torch.cuda.synchronize()
        if ssd_scan_bwd.launches != before + 2:
            raise AssertionError(f"ssd_scan_bwd {case}: launches "
                                 f"{ssd_scan_bwd.launches - before}, not 2")
        err = 0.0
        parts = []
        for name, g_, a_, w_ in zip(names, got, again, want):
            if not torch.isfinite(g_).all():
                raise AssertionError(f"ssd_scan_bwd {case}: {name} is not "
                                     f"finite")
            if not torch.equal(g_, a_):
                raise AssertionError(f"ssd_scan_bwd {case}: {name} differs "
                                     f"between two calls")
            scale = w_.float().abs().max().item()
            e = (g_.float() - w_.float()).abs().max().item()
            rtol = 2.0 ** -7 if g_.dtype == bf16 else 0.0
            parts.append(f"{name} {e:.3e} of {scale:.4g}")
            torch.testing.assert_close(g_.float(), w_.float(), rtol=rtol,
                                       atol=1e-4 * scale, msg=lambda m: (
                                           f"ssd_scan_bwd {case}: {name}: "
                                           f"{m}"))
            err = max(err, e)
        log(f"[kernel] ssd_scan_bwd {case}: max_abs_err (of max |grad|) "
            + ", ".join(parts) + f" (tol atol 1e-4 x max |grad|); two "
            f"calls the same bits; plan: {pl.groups} groups of "
            f"{pl.heads_per_group} heads, {pl.quad_blocks} blocks a "
            f"quadratic pass, shared memory {pl.rows_smem} / "
            f"{pl.cols_smem} B, scratch {pl.scratch_floats * 4} B")
        del got, again, want
        if kernel_states:
            continue
        sets = [(x, dt_a, b, c, states, dy, dfinal)]
        per_set = nbytes(*(t for t in sets[0] if t is not None))
        for j in range(n_sets(per_set) - 1):
            xj, dtj, bj, cj, sj, _, dyj, dfj = inputs(
                spec, chunk, with_dfinal, False, shift=100 + j)
            sets.append((xj, dtj, bj, cj, sj, dyj, dfj))

        def kern(x, dt_a, b, c, states, dy, dfinal, chunk=chunk):
            return ssd_scan_bwd(x, dt_a, b, c, states, dy, dfinal, chunk)

        def plain(x, dt_a, b, c, states, dy, dfinal, chunk=chunk):
            return ssd_scan_bwd_plain(x, dt_a, b, c, states, dy, dfinal,
                                      chunk)

        ms = time_ms(kern, sets, 10, 4)
        plain_ms = time_ms(plain, sets[:1], reps=3, n=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(20_000_000)
            for _ in range(2):
                kern(*sets[0])
            torch.cuda.synchronize()
        passes = _bwd_passes(
            [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA], "ssdb_")
        bound_ms, bound_by, moved, flops, t_f32, t_tf32 = _ssd_bwd_bound(
            x, b, states, dfinal, chunk, hbm, peak_f32, peak_tf32)
        log(f"[kernel] ssd_scan_bwd {case} timing: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {moved} B at "
            f"{hbm / 1e12:g} TB/s; {flops} flop: {t_f32:.4f} ms at the fp32 "
            f"CUDA-core rate {peak_f32 / 1e12:g} TFLOP/s, {t_tf32:.4f} ms as "
            f"split TF32, 3 x at {peak_tf32 / 1e12:g}); {len(sets)} input "
            f"sets; passes (profiled, ms a call): "
            + ", ".join(f"{k} {t / 2:.4f} ({c_} launches)"
                        for k, (t, c_) in passes.items()))
        entries.append({
            "name": f"ssd_scan_bwd[{case},bt{x.shape[0]}_s{x.shape[1]}_h"
                    f"{x.shape[2]}_p{x.shape[3]}_n{b.shape[-1]}_chunk"
                    f"{chunk}]",
            "route": "cuda", "source": SSDB_SOURCE,
            "replaces": SSDB_REPLACES, "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes an SSD backward
            "library_ms": None})
        del sets, x, dt_a, b, c, states, fwd_states, dy, dfinal
        torch.cuda.empty_cache()
    return entries


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _train_counters():
    """The training kernels' launches and their plain versions' calls:
    ``flash_attention`` (fwd) and its backward, ``ssd_scan`` (ssd) and
    its backward."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ssd_scan as kss
    return {"fwd": kfa.flash_attention.launches,
            "bwd": kfa.flash_attention_bwd.launches,
            "fwd_plain": kfa.flash_attention_plain.calls,
            "bwd_plain": kfa.flash_attention_bwd_plain.calls,
            "lse_plain": kfa.attention_lse_plain.calls,
            "ssd": kss.ssd_scan.launches,
            "ssd_bwd": kss.ssd_scan_bwd.launches,
            "ssd_plain": kss.ssd_scan_plain.calls,
            "ssd_bwd_plain": kss.ssd_scan_bwd_plain.calls}


def _zero_train_counters():
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ssd_scan as kss
    kfa.flash_attention.launches = kfa.flash_attention_bwd.launches = 0
    kfa.flash_attention_plain.calls = kfa.flash_attention_bwd_plain.calls = 0
    kfa.attention_lse_plain.calls = 0
    kss.ssd_scan.launches = kss.ssd_scan_bwd.launches = 0
    kss.ssd_scan_plain.calls = kss.ssd_scan_bwd_plain.calls = 0


def _dp_group():
    """The default process group of phases 2p and 3k: one rank whose CPU
    tensors are reduced through gloo and the card's through NCCL,
    bootstrapped from a ``HashStore`` over the loopback device (no TCP
    store, no network).  The first call starts it and all-reduces one
    element on the card, so that NCCL's start-up is not a step's time
    and a group that cannot reduce fails here."""
    import torch.distributed as dist
    if not dist.is_initialized():
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        t0 = time.perf_counter()
        dist.init_process_group("cpu:gloo,cuda:nccl",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)
        if float(one) != 1.0:
            raise AssertionError(f"one-rank NCCL all-reduce gave {one}")
        log(f"[dp] one-rank group, backend {dist.get_backend()}, NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))}: started "
            f"and checked in {time.perf_counter() - t0:.2f} s")
    return dist


def phase2p_local_dp(model, opt, state, stream, cfg, b, s):
    """Inside 2n, on its full-depth state: ``make_local_dp_train_step``
    over the one-rank group (:func:`_dp_group`) at accum 2, uncompressed
    then compressed, each through ``run_train_loop`` for 3 steps (counts
    set to 0 just before and read just after: 2 x 36 x 2
    ``flash_attention`` and 36 x 2 ``flash_attention_bwd`` launches a
    step, no plain version): each step's host time (the first a warm-up;
    the median of steps 2-3, as 2n), finite losses and grad norms, the
    peak memory; then one more step profiled, its device-busy ms and
    idle share against its own wall time.  Then the reduction alone:
    one accum-2 step's fp32 gradients on these params, reduced by
    ``local_dp.reduce_gradients`` compressed (under the step's key) and
    then uncompressed, each call between two CUDA events, and its share
    of the profiled step's busy ms.  Returns (the state, {"uncompressed"
    / "compressed": figures})."""
    from repro_torch.serve import prng
    from repro_torch.train import make_local_dp_train_step
    from repro_torch.train.local_dp import reduce_gradients
    from repro_torch.train.step import accumulate_grads, make_grad_fn
    t_start = time.perf_counter()
    _dp_group()
    out = {}
    for compress in (False, True):
        label = "compressed" if compress else "uncompressed"
        step_fn = make_local_dp_train_step(model, opt, accum_steps=2,
                                           compress=compress)
        torch.cuda.reset_peak_memory_stats()
        _zero_train_counters()
        state, rows, secs = _train_run(step_fn, state, stream, 3)
        counts = _train_counters()
        peak = torch.cuda.max_memory_allocated()
        want = dict.fromkeys(counts, 0)
        want.update(fwd=3 * 2 * cfg.n_layers * 2, bwd=3 * cfg.n_layers * 2)
        if counts != want:
            raise AssertionError(f"2p {label}: launches {counts}, "
                                 f"expected {want}")
        batch, metrics, wall = stream.batch(3), [], []

        def one_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(step_fn(state, batch)[1])
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)

        busy = _profile_step(one_step)[0]
        loss, gnorm = (float(metrics[0][k]) for k in ("loss", "grad_norm"))
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"2p {label}: profiled step loss {loss}, "
                                 f"grad_norm {gnorm}")
        step_s = statistics.median(secs[1:])
        log(f"[train 2p] local DP {label}, accum 2, one rank: steps {rows}; "
            f"host s a step {[round(x, 4) for x in secs]} (median of the "
            f"last two {step_s:.4f} s, {b * s / step_s:.1f} tokens/s); "
            f"launches a step fwd {counts['fwd'] // 3} bwd "
            f"{counts['bwd'] // 3}; one profiled step (loss {loss:.4f}, "
            f"grad_norm {gnorm:.4f}): device busy {busy:.2f} ms of "
            f"{wall[0] * 1e3:.2f} ms wall (idle "
            f"{1 - busy / (wall[0] * 1e3):.3f}); peak memory "
            f"{peak / 2**30:.2f} GiB")
        out[label] = {"step_s": step_s, "tok_s": b * s / step_s,
                      "busy_ms": busy, "wall_ms": wall[0] * 1e3,
                      "peak_gib": peak / 2**30,
                      "fwd_launches": counts["fwd"] // 3,
                      "bwd_launches": counts["bwd"] // 3}
        del step_fn, batch, metrics
    _, grads = accumulate_grads(make_grad_fn(model), state["params"],
                                stream.batch(4), 2, torch.float32)
    n = sum(g.numel() for g in grads.values())
    key = prng.fold_in(prng.prng_key(0, "cuda"), state["opt"]["step"])
    for label, k in (("compressed", key), ("uncompressed", None)):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        reduced = reduce_gradients(grads, None, 1, k)
        ev[1].record()
        torch.cuda.synchronize()
        del reduced
        ms = ev[0].elapsed_time(ev[1])
        fig = out[label]
        fig.update(reduce_ms=ms, reduce_share=ms / fig["busy_ms"])
        log(f"[train 2p] the {label} reduction alone over {n} fp32 "
            f"gradients: {ms:.2f} ms (CUDA events), "
            f"{fig['reduce_share']:.3f} of the profiled {label} step's "
            f"device busy {fig['busy_ms']:.2f} ms")
    del grads
    log(f"[time] phase 2p at full depth (inside 2n): "
        f"{time.perf_counter() - t_start:.1f} s")
    return state, out

def _dp_matches_train_step(model, opt, stream, fresh, n_layers: int):
    """Two states from one seed, 2 steps at accum 2: ``make_train_step``
    and the uncompressed one-rank DP step give bit-identical params,
    ``m``, ``v``, step and losses."""
    from repro_torch import bridge
    from repro_torch.train import make_local_dp_train_step, make_train_step
    steps = (make_train_step(model, opt, accum_steps=2),
             make_local_dp_train_step(model, opt, accum_steps=2))
    states = [fresh(), fresh()]
    for i in range(2):
        batch = stream.batch(i)
        losses = []
        for j, f in enumerate(steps):
            states[j], m = f(states[j], batch)
            losses.append(float(m["loss"]))
        if losses[0] != losses[1]:
            raise AssertionError(f"2p bits: step {i} loss {losses}")
    got, want = (bridge.flatten(st) for st in states[::-1])
    for k in want:
        if not torch.equal(_bits(got[k]), _bits(want[k])):
            diff = (got[k].float() - want[k].float()).abs().max()
            raise AssertionError(f"2p bits: {k} differs (max {diff})")
    log(f"[train 2p] at {n_layers} layers, full width, accum 2: the "
        f"one-rank DP step and make_train_step bit-identical after 2 steps "
        f"({len(want)} leaves of params / m / v / step, losses equal)")


def _profile_step(fn):
    """``fn()`` under ``torch.profiler`` (CUDA activity only): (device
    busy ms, forward kernel ms, backward kernels ms, the top kernels, the
    backward's passes as :func:`_bwd_passes`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]

    def ms(pred):
        return sum(e.self_device_time_total for e in kern if pred(e.key)) / 1e3

    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return (ms(lambda k: True), ms(lambda k: "flash_attention" in k),
            ms(lambda k: "fa_bwd" in k),
            [(e.key[:50], e.count, e.self_device_time_total / 1e3)
             for e in top], _bwd_passes(kern))


def _train_run(step_fn, state, stream, total, ckpt_dir=None):
    """``run_train_loop`` to ``total`` steps, logging every step: (state,
    [(step, loss, grad_norm)], [host seconds of each step]).  Every
    step's loss and grad norm must be finite."""
    from repro_torch.train import TrainLoopConfig, run_train_loop
    rows, stamps = [], [time.perf_counter()]

    def on_metrics(step, m):
        stamps.append(time.perf_counter())
        rows.append((step, m["loss"], m["grad_norm"]))
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"training step {step}: loss {m['loss']}, "
                                 f"grad_norm {m['grad_norm']}")

    loop = TrainLoopConfig(total_steps=total, checkpoint_every=10 ** 9,
                           log_every=1, checkpoint_dir=ckpt_dir,
                           async_checkpoint=False)
    state, _ = run_train_loop(step_fn, state, stream, loop,
                              on_metrics=on_metrics)
    return state, rows, [b - a for a, b in zip(stamps, stamps[1:])]


def phase2n_training():
    """qwen2.5-3b training at full width, bf16, seeded weights, the affine
    stream, batch 8 x seq 256, under ``torch.use_deterministic_algorithms``
    (``CUBLAS_WORKSPACE_CONFIG=:4096:8``): at full depth (36 layers),
    through ``run_train_loop``, 3 steps at accum 1 then 3 at accum 2
    (counts set to 0 just before each run and read just after: 2 x 36 x
    accum ``flash_attention`` launches a step, the forward again under
    block remat, and 36 x accum ``flash_attention_bwd``; no plain
    version), each step's host time, tokens/s, one step profiled
    (device-busy ms, both kernels' ms, idle share) and the peak memory.
    Then the restart at full width cut to ``TRAIN_RESTART_LAYERS``
    layers (a full-depth snapshot is 31 GB, written and read twice):
    4 steps at accum 2 uninterrupted, against 2 steps that leave a
    checkpoint and a fresh state that resumes from it to step 4:
    the resumed losses and the final params, ``m``, ``v`` and step
    bit-identical.  Phase 2p runs inside: the DP steps on the full-depth
    state after the accum-2 run (:func:`phase2p_local_dp`), and the DP
    step against ``make_train_step`` at the restart's depth after it
    (:func:`_dp_matches_train_step`).  Returns ({accum: figures}, {2p's
    "uncompressed" / "compressed": figures})."""
    import shutil
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import make_train_step, train_state_init
    torch.use_deterministic_algorithms(True)
    try:
        cfg = get_config("qwen2.5-3b")
        b, s = 8, 256
        opt = AdamWConfig(
            schedule=Schedule(peak_lr=3e-3, warmup_steps=20, decay_steps=6),
            m_dtype="bfloat16" if cfg.fsdp else "float32",
            factored_v=cfg.fsdp)
        stream = SyntheticStream(cfg, b, s, SyntheticConfig(kind="affine"),
                                 device="cuda")
        model = build_model(cfg)
        state = train_state_init(
            model, opt, torch.Generator(device="cuda").manual_seed(0),
            "cuda")
        n_params = sum(t.numel() for t in bridge.flatten(
            state["params"]).values())
        log(f"[train 2n] {cfg.name}: {cfg.n_layers} layers, {n_params} "
            f"params ({cfg.param_dtype}), batch {b} x seq {s}, AdamW m "
            f"{opt.m_dtype}, factored v {opt.factored_v}")
        out = {}
        for accum in (1, 2):
            step_fn = make_train_step(model, opt, accum_steps=accum)
            torch.cuda.reset_peak_memory_stats()
            _zero_train_counters()
            state, rows, secs = _train_run(step_fn, state, stream, 3)
            counts = _train_counters()
            want = dict.fromkeys(counts, 0)
            want.update(fwd=3 * 2 * cfg.n_layers * accum,
                        bwd=3 * cfg.n_layers * accum)
            if counts != want:
                raise AssertionError(f"2n accum {accum}: launches {counts}, "
                                     f"expected {want}")
            peak = torch.cuda.max_memory_allocated()
            batch = stream.batch(3)
            busy, fwd_ms, bwd_ms, top, passes = _profile_step(
                lambda: step_fn(state, batch))
            _, wall = _timed(lambda: step_fn(state, batch))
            step_s = statistics.median(secs[1:])
            log(f"[train 2n] accum {accum}: steps {rows}; host s a step "
                f"{[round(x, 4) for x in secs]} (median of the last two "
                f"{step_s:.4f} s, {b * s / step_s:.1f} tokens/s); "
                f"launches a step fwd {counts['fwd'] // 3} bwd "
                f"{counts['bwd'] // 3}; one profiled step: device busy "
                f"{busy:.2f} ms of {wall * 1e3:.2f} ms wall (idle "
                f"{1 - busy / (wall * 1e3):.3f}), flash_attention "
                f"{fwd_ms:.2f} ms, flash_attention_bwd {bwd_ms:.2f} ms ("
                + ", ".join(f"{n} {t:.2f} ms x {c}" for n, (t, c) in
                            passes.items())
                + f"); peak memory {peak / 2**30:.2f} GiB; top {top}")
            out[accum] = {"step_s": step_s, "tok_s": b * s / step_s,
                          "busy_ms": busy, "fwd_ms": fwd_ms,
                          "bwd_ms": bwd_ms, "bwd_passes": passes,
                          "peak_gib": peak / 2**30,
                          "fwd_launches": counts["fwd"] // 3,
                          "bwd_launches": counts["bwd"] // 3}
            del step_fn, batch
        state, dp = phase2p_local_dp(model, opt, state, stream, cfg, b, s)
        del state
        torch.cuda.empty_cache()

        cut = dataclasses.replace(cfg, n_layers=TRAIN_RESTART_LAYERS)
        model = build_model(cut)
        step_fn = make_train_step(model, opt, accum_steps=2)
        ckpt = str(ROOT / "build" / "ckpt_2n")
        shutil.rmtree(ckpt, ignore_errors=True)

        def fresh():
            return train_state_init(
                model, opt, torch.Generator(device="cuda").manual_seed(1),
                "cuda")

        straight, rows_u, _ = _train_run(step_fn, fresh(), stream, 4)
        _, rows_a, _ = _train_run(step_fn, fresh(), stream, 2, ckpt)
        ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(ckpt) for f in fs)
        resumed, rows_b, _ = _train_run(step_fn, fresh(), stream, 4, ckpt)
        shutil.rmtree(ckpt, ignore_errors=True)
        if rows_a + rows_b != rows_u:
            raise AssertionError(f"2n restart: losses {rows_a + rows_b} != "
                                 f"uninterrupted {rows_u}")
        got, want = bridge.flatten(resumed), bridge.flatten(straight)
        for k in want:
            if not torch.equal(_bits(got[k]), _bits(want[k])):
                raise AssertionError(f"2n restart: {k} is not bit-identical")
        log(f"[train 2n] restart at {TRAIN_RESTART_LAYERS} of "
            f"{cfg.n_layers} layers, full width, accum 2: checkpoint at "
            f"step 2 ({ck_bytes} bytes); resumed losses {rows_b} equal the "
            f"uninterrupted run's, and {len(want)} leaves of params / m / v "
            f"/ step bit-identical")
        del straight, resumed, got, want
        _dp_matches_train_step(model, opt, stream, fresh,
                               TRAIN_RESTART_LAYERS)
        torch.cuda.empty_cache()
        return out, dp
    finally:
        torch.use_deterministic_algorithms(False)


def _ssm_layers(cfg):
    """(SSM layers, attention layers) of ``cfg``'s stack."""
    pattern = cfg.block_pattern()
    mixers = [pattern[i % len(pattern)].mixer for i in range(cfg.n_layers)]
    return mixers.count("ssm"), mixers.count("attn")


def phase2o_ssm_training():
    """mamba2-2.7b training at full width and full depth (64 layers),
    bf16, fp32 ``m`` / ``v``, seeded weights, the affine stream, batch 4
    x seq 512 (each row crosses an SSD chunk boundary inside both
    kernels), under ``torch.use_deterministic_algorithms``: through
    ``run_train_loop``, 3 steps at accum 1 (counts set to 0 just before
    and read just after: 2 x 64 ``ssd_scan`` launches a step, the forward
    again under block remat, both storing the states, and 64
    ``ssd_scan_bwd``; no plain version), each step's host time,
    tokens/s, one step profiled (device-busy ms, both kernels' ms, the
    backward's passes, idle share) and the peak memory.  (No 2-layer
    restart: 2n's covers the checkpoint path, and the run's time went
    to 2p, 2q and 3k.)"""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import make_train_step, train_state_init
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.use_deterministic_algorithms(True)
    try:
        cfg = get_config("mamba2-2.7b")
        b, s = 4, 512
        opt = AdamWConfig(
            schedule=Schedule(peak_lr=3e-3, warmup_steps=20, decay_steps=6),
            m_dtype="bfloat16" if cfg.fsdp else "float32",
            factored_v=cfg.fsdp)
        stream = SyntheticStream(cfg, b, s, SyntheticConfig(kind="affine"),
                                 device="cuda")
        model = build_model(cfg)
        state = train_state_init(
            model, opt, torch.Generator(device="cuda").manual_seed(0),
            "cuda")
        n_params = sum(t.numel() for t in bridge.flatten(
            state["params"]).values())
        n_ssm, _ = _ssm_layers(cfg)
        log(f"[train 2o] {cfg.name}: {cfg.n_layers} layers ({n_ssm} SSM), "
            f"{n_params} params ({cfg.param_dtype}), batch {b} x seq {s}, "
            f"chunk {cfg.ssm_chunk}, AdamW m {opt.m_dtype}, factored v "
            f"{opt.factored_v}")
        step_fn = make_train_step(model, opt, accum_steps=1)
        torch.cuda.reset_peak_memory_stats()
        _zero_train_counters()
        state, rows, secs = _train_run(step_fn, state, stream, 3)
        counts = _train_counters()
        want = dict.fromkeys(counts, 0)
        want.update(ssd=3 * 2 * n_ssm, ssd_bwd=3 * n_ssm)
        if counts != want:
            raise AssertionError(f"2o: launches {counts}, expected {want}")
        peak = torch.cuda.max_memory_allocated()
        batch = stream.batch(3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        fwd_ms = sum(e.self_device_time_total for e in kern
                     if "ssd_scan_kernel" in e.key) / 1e3
        passes = _bwd_passes(kern, "ssdb_")
        bwd_ms = sum(t for t, _ in passes.values())
        top = [(e.key[:50], e.count, e.self_device_time_total / 1e3)
               for e in sorted(kern, key=lambda e: -e.self_device_time_total)
               [:6]]
        _, wall = _timed(lambda: step_fn(state, batch))
        step_s = statistics.median(secs[1:])
        log(f"[train 2o] steps {rows}; host s a step "
            f"{[round(x, 4) for x in secs]} (median of the last two "
            f"{step_s:.4f} s, {b * s / step_s:.1f} tokens/s); launches a "
            f"step ssd_scan {counts['ssd'] // 3} ssd_scan_bwd "
            f"{counts['ssd_bwd'] // 3}; one profiled step: device busy "
            f"{busy:.2f} ms of {wall * 1e3:.2f} ms wall (idle "
            f"{1 - busy / (wall * 1e3):.3f}), ssd_scan {fwd_ms:.2f} ms, "
            f"ssd_scan_bwd {bwd_ms:.2f} ms ({bwd_ms / busy:.3f} of busy; "
            + ", ".join(f"{k} {t:.2f} ms x {c}" for k, (t, c) in
                        passes.items())
            + f"); peak memory {peak / 2**30:.2f} GiB; top {top}")
        out = {"step_s": step_s, "tok_s": b * s / step_s, "busy_ms": busy,
               "wall_ms": wall * 1e3, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
               "peak_gib": peak / 2**30,
               "fwd_launches": counts["ssd"] // 3,
               "bwd_launches": counts["ssd_bwd"] // 3}
        del state, step_fn, batch, prof, kern
        torch.cuda.empty_cache()
        return out
    finally:
        torch.use_deterministic_algorithms(False)


def _compare_train_states(tag: str, n: int, card, cpu, lr_sum: float,
                          m_before=None, opt=None):
    """Phase 3i's comparison of a card train state with the CPU's after
    step ``n``: the step count equal; every param within rtol 1e-4 /
    atol 1e-6 but for at most 1 element in 100 of a leaf, within 2 x
    the summed lr ``lr_sum``; the K bias within that bound; ``m`` and
    ``v`` within rtol 1e-4 / atol 1e-4 x the leaf's largest magnitude.
    With ``m_before`` (the flat ``m`` the step started from) and ``opt``
    (a compressed step, 3k): up to 1 element in 100 of ``m`` / ``v`` may
    lie beyond, each within what one quantum of the compressed mean
    moves it (where ``g / scale`` sits at a rounding boundary, the two
    devices' ulp-level gradients round to neighbouring integers): the
    quantum is at most ``max |c g| / 127`` (``c g`` the clipped gradient,
    from the CPU's ``m`` and ``m_before``), moving ``m`` by ``(1 - b1)``
    of it and ``v`` by ``(1 - b2) (2 max |c g| + q) q``.
    Returns (the card's flat state, the largest difference, (the largest
    share of a leaf beyond rtol / atol, that leaf))."""
    from repro_torch import bridge
    got = bridge.flatten(card)
    want_all = bridge.flatten(cpu)
    worst, worst_frac = 0.0, (0.0, None)
    for k, w in want_all.items():
        g, w = got[k].detach(), w.detach().to("cuda")
        if k == "opt/step":
            if int(g) != int(w):
                raise AssertionError(f"{tag}: step {g} != {w}")
            continue
        diff = (g - w).abs()
        if k.endswith("/attn/bk") and k.startswith("params"):
            ok = bool((diff <= 2 * lr_sum).all())
        elif k.startswith("params"):
            bad = diff > 1e-6 + 1e-4 * w.abs()
            frac = int(bad.sum()) / w.numel()
            ok = frac <= 0.01 and bool((diff[bad] <= 2 * lr_sum).all())
            if frac > worst_frac[0]:
                worst_frac = (frac, k)
        else:
            tol = 1e-4 * float(w.abs().max())
            bad = diff > tol + 1e-4 * w.abs()
            ok = not bool(bad.any())
            if not ok and m_before is not None:
                name = k.split("/", 2)[2]
                cg = ((want_all["opt/m/" + name].detach().to("cuda")
                       - opt.b1 * m_before[name]) / (1 - opt.b1))
                gmax = float(cg.abs().max())
                q = gmax / 127 * (1 + 1e-3)
                bound = ((1 - opt.b1) * q if k.startswith("opt/m/")
                         else (1 - opt.b2) * (2 * gmax + q) * q)
                ok = (int(bad.sum()) <= w.numel() // 100
                      and bool((diff[bad] <= bound).all()))
        if not ok:
            raise AssertionError(
                f"{tag} step {n}: {k} max diff {float(diff.max()):.3e}, "
                f"{int((diff > 1e-6 + 1e-4 * w.abs()).sum())} of "
                f"{w.numel()} beyond rtol 1e-4 / atol 1e-6 (2 x summed lr "
                f"{2 * lr_sum:.3e})")
        worst = max(worst, float(diff.max()))
    return got, worst, worst_frac


def phase3i_train_parity():
    """Training card against CPU in fp32, TF32 off: qwen2.5-3b at full
    width cut to 2 layers, the same seeded weights and batches (2 x 64
    tokens), 3 steps at accum 1 then 3 at accum 2, each step from the
    same state on both sides (the CPU's, copied to the card after the
    comparison).  After each step:
    loss and grad_norm within rtol 1e-5; every param within rtol 1e-4 /
    atol 1e-6 but for at most 1 element in 100 of a leaf, within 2 x the
    summed lr (AdamW steps a gradient near 0 by its sign, so an element
    whose gradient sits at the two devices' rounding moves by up to lr
    either way: the full-width QKV biases hold such elements), and the
    K bias, whose gradient is tiny everywhere (a bias on every key shifts
    a query's scores by nearly one constant), within that bound; ``m``
    and ``v`` within rtol 1e-4 / atol 1e-4 x the leaf's largest
    magnitude; the step count equal."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import make_train_step, train_state_init
    cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        model = build_model(cfg)
        opt = AdamWConfig(schedule=Schedule(peak_lr=3e-3, warmup_steps=0,
                                            decay_steps=10))
        t0 = time.perf_counter()
        cpu = train_state_init(model, opt, torch.Generator().manual_seed(0),
                               "cpu")
        card = bridge.unflatten({k: t.detach().to("cuda", copy=True)
                                 for k, t in bridge.flatten(cpu).items()})
        log(f"[train 3i] init on the CPU and copy to the card: "
            f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(9)
        lr_sum, n = 0.0, 0
        for accum in (1, 2):
            steps = {dev: make_train_step(model, opt, accum_steps=accum)
                     for dev in ("cpu", "cuda")}
            for _ in range(3):
                tokens = torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (2, 64)).astype(np.int32))
                _zero_train_counters()
                (card, mg), t_card = _timed(
                    lambda: steps["cuda"](card, {"tokens": tokens.cuda()}))
                counts = _train_counters()
                t0 = time.perf_counter()
                cpu, mc = steps["cpu"](cpu, {"tokens": tokens})
                t_cpu, t0 = time.perf_counter() - t0, time.perf_counter()
                n += 1
                lr_sum += float(opt.schedule(n))
                want_c = dict.fromkeys(counts, 0)
                want_c.update(fwd=2 * 2 * accum, bwd=2 * accum)
                if counts != want_c:
                    raise AssertionError(f"3i: card launches {counts}, "
                                         f"expected {want_c}")
                for name in ("loss", "grad_norm"):
                    g, w = float(mg[name]), float(mc[name])
                    if abs(g - w) > 1e-5 * abs(w):
                        raise AssertionError(f"3i step {n}: {name} card {g} "
                                             f"cpu {w}")
                got, worst, worst_frac = _compare_train_states(
                    "3i", n, card, cpu, lr_sum)
                log(f"[train 3i] step {n} (accum {accum}): loss card "
                    f"{float(mg['loss']):.7f} cpu {float(mc['loss']):.7f}, "
                    f"grad_norm card {float(mg['grad_norm']):.6f} cpu "
                    f"{float(mc['grad_norm']):.6f}; state max abs diff "
                    f"{worst:.3e}; params beyond rtol 1e-4 / atol 1e-6: at "
                    f"most {worst_frac[0]:.4%} of a leaf ({worst_frac[1]}); "
                    f"s card {t_card:.2f}, CPU {t_cpu:.2f}, compare "
                    f"{time.perf_counter() - t0:.2f}")
                # the next step starts from the same state on both sides,
                # so each step is held alone (AdamW's sign steps above
                # would otherwise move every later gradient)
                with torch.no_grad():
                    for k, w in bridge.flatten(cpu).items():
                        got[k].copy_(w)
        del card, cpu
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def phase3j_ssm_train_parity():
    """SSM training card against CPU in fp32 with TF32 off (matmuls and
    cuDNN: ``causal_conv1d`` reaches it), as 3i: mamba2-2.7b at full
    width cut to 2 layers on 2 x 300-token rows (s padded to 512: two
    chunks at chunk 256), and jamba-v0.1-52b reduced (MoE, attention
    beside the SSM) on 2 x 64 tokens (two chunks of 32); the same seeded
    weights and batches, at accum 1, each step from the CPU's state:
    mamba2 one step (the run's time went to 2p, 2q and 3k), jamba 3;
    3i's tolerances (:func:`_compare_train_states`).  Each card step
    launches ``ssd_scan`` twice and ``ssd_scan_bwd`` once an SSM layer
    (``flash_attention`` twice and its backward once an attention
    layer), no plain version; the CPU's steps run the plain versions."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import make_train_step, train_state_init
    cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = (("mamba2-2.7b", dataclasses.replace(
                    get_config("mamba2-2.7b"), n_layers=2,
                    param_dtype="float32", compute_dtype="float32"),
                 (2, 300), 1),
                ("jamba-v0.1-52b reduced",
                 get_config("jamba-v0.1-52b").reduced(), (2, 64), 3))
        for label, cfg, shape, n_steps in runs:
            model = build_model(cfg)
            opt = AdamWConfig(schedule=Schedule(peak_lr=3e-3,
                                                warmup_steps=0,
                                                decay_steps=10))
            t0 = time.perf_counter()
            cpu = train_state_init(model, opt,
                                   torch.Generator().manual_seed(0), "cpu")
            card = bridge.unflatten({k: t.detach().to("cuda", copy=True)
                                     for k, t in bridge.flatten(cpu).items()})
            n_ssm, n_attn = _ssm_layers(cfg)
            log(f"[train 3j] {label}: {cfg.n_layers} layers ({n_ssm} SSM, "
                f"{n_attn} attention), rows {shape}; init on the CPU and "
                f"copy to the card: {time.perf_counter() - t0:.1f} s")
            rng = np.random.default_rng(10)
            steps = {dev: make_train_step(model, opt, accum_steps=1)
                     for dev in ("cpu", "cuda")}
            lr_sum = 0.0
            for n in range(1, n_steps + 1):
                tokens = torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, shape).astype(np.int32))
                _zero_train_counters()
                (card, mg), t_card = _timed(
                    lambda: steps["cuda"](card, {"tokens": tokens.cuda()}))
                counts = _train_counters()
                t0 = time.perf_counter()
                cpu, mc = steps["cpu"](cpu, {"tokens": tokens})
                t_cpu, t0 = time.perf_counter() - t0, time.perf_counter()
                lr_sum += float(opt.schedule(n))
                want = dict.fromkeys(counts, 0)
                want.update(ssd=2 * n_ssm, ssd_bwd=n_ssm, fwd=2 * n_attn,
                            bwd=n_attn)
                if counts != want:
                    raise AssertionError(f"3j {label}: card launches "
                                         f"{counts}, expected {want}")
                for name in ("loss", "grad_norm"):
                    g, w = float(mg[name]), float(mc[name])
                    if abs(g - w) > 1e-5 * abs(w):
                        raise AssertionError(f"3j {label} step {n}: {name} "
                                             f"card {g} cpu {w}")
                got, worst, worst_frac = _compare_train_states(
                    f"3j {label}", n, card, cpu, lr_sum)
                log(f"[train 3j] {label} step {n}: loss card "
                    f"{float(mg['loss']):.7f} cpu {float(mc['loss']):.7f}, "
                    f"grad_norm card {float(mg['grad_norm']):.6f} cpu "
                    f"{float(mc['grad_norm']):.6f}; state max abs diff "
                    f"{worst:.3e}; params beyond rtol 1e-4 / atol 1e-6: at "
                    f"most {worst_frac[0]:.4%} of a leaf ({worst_frac[1]}); "
                    f"card launches ssd_scan {counts['ssd']} ssd_scan_bwd "
                    f"{counts['ssd_bwd']}; s card {t_card:.2f}, CPU "
                    f"{t_cpu:.2f}, compare {time.perf_counter() - t0:.2f}")
                with torch.no_grad():
                    for k, w in bridge.flatten(cpu).items():
                        got[k].copy_(w)
            del card, cpu, steps
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def phase2q_examples():
    """The training examples on the card (``repro_torch.examples``):
    the quickstart whole, then ``train_100m`` for 40 steps and again to
    60, resuming from the checkpoint at 40.  Every logged loss must be
    finite and each run's last below its first.  Returns {"quickstart":
    (the logged losses, k of 8), "train_100m": (losses of the first run,
    of the resumed run)}."""
    import shutil
    from repro_torch.examples import quickstart, train_100m
    t0 = time.perf_counter()
    qs = quickstart.run("cuda")
    losses = [(h["step"], round(h["loss"], 4)) for h in qs["history"]]
    t_qs, t0 = time.perf_counter() - t0, time.perf_counter()
    ckpt = str(ROOT / "build" / "ckpt_2q")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        args = ["--ckpt", ckpt, "--device", "cuda"]
        runs = [train_100m.main(["--steps", "40", *args])]
        t_a, t0 = time.perf_counter() - t0, time.perf_counter()
        runs.append(train_100m.main(["--steps", "60", *args]))
        t_b = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if runs[1][0]["step"] != 40 or runs[1][-1]["step"] != 59:
        raise AssertionError(f"2q: train_100m did not resume at 40: "
                             f"{[h['step'] for h in runs[1]]}")
    for label, hist in (("quickstart", qs["history"]),
                        ("train_100m to 40", runs[0]),
                        ("train_100m 40 to 60", runs[1])):
        ls = [h["loss"] for h in hist]
        if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
            raise AssertionError(f"2q {label}: losses {ls}")
    log(f"[examples 2q] quickstart: losses {losses}, {qs['hits']}/8 "
        f"continuations correct ({t_qs:.1f} s); train_100m: "
        + "; ".join(f"{a} steps: losses "
                    f"{[(h['step'], round(h['loss'], 4)) for h in hist]}"
                    f" ({t:.1f} s)"
                    for a, hist, t in (("0-40", runs[0], t_a),
                                       ("40-60 resumed", runs[1], t_b))))
    return {"quickstart": (losses, qs["hits"]),
            "train_100m": [[h["loss"] for h in r] for r in runs]}


def _example_counters() -> dict:
    """{kernel: (wrapper, plain version)} of the kernels the serving
    examples reach."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_decode_quant as fdq
    from repro_torch.kernels import ssd_scan as kss
    return {"flash_attention": (kfa.flash_attention,
                                kfa.flash_attention_plain),
            "flash_decode": (fd.flash_decode, fd.flash_decode_plain),
            "flash_decode_quant": (fdq.flash_decode_quant,
                                   fdq.flash_decode_quant_plain),
            "ssd_scan": (kss.ssd_scan, kss.ssd_scan_plain)}


def _launches(counters: dict, label: str) -> dict:
    """The launches counted since the counters were set to 0; raises if
    a plain version ran."""
    plain = {k: p.calls for k, (_, p) in counters.items() if p.calls}
    if plain:
        raise AssertionError(f"2q {label}: plain versions ran: {plain}")
    return {k: kern.launches for k, (kern, _) in counters.items()
            if kern.launches}


def _long_context_worker(arch: str, kv_format: str, device: str):
    """One ``long_context.run`` in a worker process of 2q, so that the
    card's three runs and their CPU references go side by side, each on
    a host core of its own (fp32, TF32 off): (the run, the kernels'
    launches in it (card) or None (CPU), its seconds)."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.examples import long_context
    counters = _example_counters()
    for kern, plain in counters.values():
        kern.launches, plain.calls = 0, 0
    t0 = time.perf_counter()
    run = long_context.run(arch, kv_format=kv_format, device=device,
                           log=lambda _: None)
    launches = (_launches(counters, f"long_context {run['label']}")
                if device == "cuda" else None)
    return run, launches, time.perf_counter() - t0


def phase2q_serving_examples():
    """``serve_demo`` and ``long_context`` on the card at their own sizes
    (see the module docstring, 2q), each against the CPU; the card's and
    the CPU's ``long_context`` runs go in worker processes beside
    ``serve_demo``.  Returns ``serve_demo``'s rows."""
    import multiprocessing
    from repro_torch.configs import get_config
    from repro_torch.examples import long_context, serve_demo
    from repro_torch.serve import quantize_params
    counters = _example_counters()
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(
            2 * len(long_context.RUNS)) as pool:
        jobs = {dev: [pool.apply_async(_long_context_worker,
                                       (arch, fmt, dev))
                      for arch, fmt in long_context.RUNS]
                for dev in ("cuda", "cpu")}
        for kern, plain in counters.values():
            kern.launches, plain.calls = 0, 0
        rows = serve_demo.run("cuda", log=lambda m: log(f"[serve_demo] {m}"))
        launches = _launches(counters, "serve_demo")
        base = serve_demo.init_params("cpu")
        for row in rows:
            fmt = row["format"]
            _, q = quantize_params(base, fmt)
            if row["fused"] != row["per_step"]:
                raise AssertionError(f"2q serve_demo {fmt}: fused and "
                                     f"per-step streams differ")
            if row["quantized_bytes"] != q["quantized_bytes"] or abs(
                    row["mse"] - q["mse"]) > 1e-5 * abs(q["mse"]):
                raise AssertionError(
                    f"2q serve_demo {fmt}: bytes {row['quantized_bytes']} "
                    f"mse {row['mse']!r} on the card, {q['quantized_bytes']} "
                    f"{q['mse']!r} on the CPU")
        if set(launches) != {"flash_decode"}:
            raise AssertionError(f"2q serve_demo launched {launches}")
        log(f"[examples 2q] serve_demo: fused and per-step streams "
            f"identical for {', '.join(serve_demo.FORMATS)}; bytes equal "
            f"and rel-MSE within 1e-5 of the CPU's; flash_decode launches "
            f"{launches['flash_decode']} ({time.perf_counter() - t0:.1f} s)")
        card = [j.get(timeout=600) for j in jobs["cuda"]]
        cpu = [j.get(timeout=600) for j in jobs["cpu"]]
    n64 = 64 - long_context.PROMPT_LEN
    for (arch, fmt), (run, got, t_run), (ref, _, _) in zip(
            long_context.RUNS, card, cpu):
        n_layers = get_config(arch).reduced().n_layers
        want = ({"ssd_scan": n_layers} if arch.startswith("mamba2")
                else {"flash_attention": n_layers,
                      "flash_decode_quant" if fmt else "flash_decode":
                      n_layers * len(run["tokens"])})
        if got != want or not all(run["finite"]):
            raise AssertionError(f"2q long_context {run['label']}: "
                                 f"launches {got}, expected {want}; "
                                 f"finite {run['finite']}")
        if run["cache_bytes"] != ref["cache_bytes"] or run["kv"] != ref["kv"]:
            raise AssertionError(f"2q long_context {run['label']}: cache "
                                 f"bytes {run['cache_bytes']} / "
                                 f"kv_cache_stats differ from the CPU's "
                                 f"{ref['cache_bytes']}")
        if run["tokens"][:n64] != ref["tokens"][:n64]:
            raise AssertionError(f"2q long_context {run['label']}: tokens "
                                 f"to position 64 {run['tokens'][:n64]} vs "
                                 f"the CPU's {ref['tokens'][:n64]}")
        same = next((i for i, (a, b) in enumerate(zip(run["tokens"],
                                                      ref["tokens"]))
                     if a != b), None)
        log(f"[examples 2q] long_context {run['label']}: cache "
            f"{run['cache_bytes'][0]} B at positions "
            f"{list(long_context.POSITIONS)} and kv_cache_stats as the "
            f"CPU's; tokens equal to the CPU's "
            + (f"throughout ({len(run['tokens'])})" if same is None else
               f"to position {long_context.PROMPT_LEN + same}")
            + f"; launches {got}; {t_run:.1f} s on the card")
    log(f"[examples 2q] serve_demo and long_context (the card's and the "
        f"CPU's runs in 6 workers): {time.perf_counter() - t0:.1f} s")
    return rows


def _sustain(meter, fn, args, ms: float):
    """``fn(*args)`` launched back to back inside an energy window until
    the counter has moved ``WINDOW_UPDATES`` times, in chunks of ~20 ms
    of launches with at most two in flight; the card's readings are
    taken while the last chunk runs.  Returns (window, launches, the
    last output, readings under load)."""
    chunk = max(1, math.ceil(20.0 / ms))
    n, prev = 0, None
    torch.cuda.synchronize()
    with meter.window() as w:
        t_end = time.perf_counter() + WINDOW_LIMIT_S
        while (len(w.points) <= WINDOW_UPDATES
               and time.perf_counter() < t_end):
            for _ in range(chunk):
                out = fn(*args)
            ev = torch.cuda.Event()
            ev.record()
            if prev is not None:
                prev.synchronize()
            prev = ev
            n += chunk
        load = meter.device.readings()
        torch.cuda.synchronize()
    return w, n, out, load


def _power_row(label, model, meter, fn, args, ms, flops, moved, keys,
               first) -> dict:
    """One sustained window of ``fn(*args)`` (``ms`` a launch by CUDA
    events), gated and printed beside ``energy.estimate`` of ``model``
    for each dtype key of ``keys`` (flops and HBM bytes a launch, the
    measured seconds a launch)."""
    from repro_torch.core import energy
    w, n, last, load = _sustain(meter, fn, args, ms)
    check_window(label, w)
    if not torch.equal(last.view(torch.uint8), first.view(torch.uint8)):
        raise AssertionError(f"{label}: the last launch's output is not the "
                             f"first's bits")
    busy = n * ms / (w.wall_s * 1e3)
    j_launch = w.watts * w.wall_s / n
    ests = {key: energy.estimate(model, flops=flops, dtype=key,
                                 bytes_by_level={"hbm": moved},
                                 seconds=ms / 1e3) for key in keys}
    log(f"[power 2r] {label}: {n} launches of {ms:.4f} ms in {w.wall_s:.3f} "
        f"s (busy share {busy:.3f}, {flops / ms / 1e9:.1f} TFLOP/s a "
        f"launch); {w.updates} counter updates over {w.seconds:.3f} s: "
        f"{w.watts:.1f} W, {j_launch * 1e3:.4f} mJ a launch, "
        f"{j_launch / (flops / 1e12):.3f} J/TFLOP; under load "
        f"{load.describe()}")
    for key, e in ests.items():
        log(f"[power 2r]   model {model.name} dtype {key}: "
            f"{e.total_watts:.1f} W, {e.total_watts * e.seconds * 1e3:.4f} "
            f"mJ a launch ({e.joules * 1e3:.4f} mJ dynamic); measured / "
            f"model W {w.watts / e.total_watts:.3f}")
    return {"label": label, "launches": n, "ms": ms, "busy": busy,
            "updates": w.updates, "seconds": w.seconds, "wall_s": w.wall_s,
            "watts": w.watts, "j_launch": j_launch,
            "j_tflop": j_launch / (flops / 1e12), "sm_mhz": load.sm_mhz,
            "mem_mhz": load.mem_mhz, "temp_c": load.temp_c,
            "reasons": load.reason_names,
            "model_w": {k: e.total_watts for k, e in ests.items()}}


def phase2r_power(model, meter, served, demo_rows) -> list:
    """Power and energy on the card beside the energy model (see the
    module docstring, 2r); ``served``: {weight format: phase 2 / 2b's
    output}, ``demo_rows``: 2q's ``serve_demo`` rows."""
    from repro_torch.core import energy
    from repro_torch.kernels import probe_mma as pm
    from repro_torch.kernels.qmatmul import (
        pack_for_qmatmul, qmatmul, qmatmul_packed, qmatmul_packed_plain,
        qmatmul_plain, quantize_for_qmatmul)
    rows = []
    w = meter.idle
    idle = energy.estimate(model, flops=0.0, dtype="bfloat16",
                           seconds=w.seconds)
    log(f"[power 2r] idle (phase 0, before any kernel ran): {w.updates} "
        f"counter updates over {w.seconds:.3f} "
        f"s: {w.watts:.1f} W against the model's idle_watts "
        f"{idle.total_watts:.1f} W of {model.name} (measured / model "
        f"{w.watts / idle.total_watts:.3f}); at its end {w.end.describe()}")
    rows.append({"label": "idle", "watts": w.watts, "updates": w.updates,
                 "model_w": {"idle": idle.total_watts}})

    # Tab VI: mma_products at each input dtype, a launch >= 0.5 ms
    for dt, key, kind in ((torch.float32, "tf32", "tf32"),
                          (torch.float16, "float16", "fp32"),
                          (torch.bfloat16, "bfloat16", "fp32")):
        g = torch.Generator(device="cuda").manual_seed(11)
        batch = 1024
        while True:
            a = torch.randn((batch, 4, 128, 128), generator=g,
                            device="cuda").to(dt)
            b = torch.randn((batch, 4, 128, 128), generator=g,
                            device="cuda").to(dt)
            ms = time_ms(pm.mma_products, [(a, b)], reps=5)
            if ms >= 0.5 or 2 * batch > pm.MAX_BATCH:
                break
            batch *= 2
        first = pm.mma_products(a, b)
        torch.cuda.synchronize()
        _check_mma(f"2r {key} mma_products batch {batch} ilp 4 128^3",
                   first, pm.mma_probe_plain(a, b, torch.float32), 128, kind)
        rows.append(_power_row(
            f"Tab VI mma_products {key} batch {batch} ilp 4 128^3", model,
            meter, pm.mma_products, (a, b), ms, 2 * 128 ** 3 * batch * 4,
            nbytes(a, b) + batch * 4 * 128 * 128 * 4, (key,), first))
        del a, b, first

    # Tab VI: the block-scaled GEMM in each format at 2048^3; Fig 12:
    # fp8 from 512^3 to 8192^3
    cases = [("float8_e4m3fn", 2048), ("float6_e2m3fn", 2048),
             ("float6_e3m2fn", 2048), ("float4_e2m1fn", 2048),
             ("float8_e4m3fn", 512), ("float8_e4m3fn", 1024),
             ("float8_e4m3fn", 4096), ("float8_e4m3fn", 8192)]
    for fmt, size in cases:
        x, wt = _qmm_case(size, size, size, size)
        if fmt == "float8_e4m3fn":
            qw, sc = quantize_for_qmatmul(wt, fmt)
            kern, plain, name = qmatmul, qmatmul_plain, "qmatmul"
        else:
            qw, sc = pack_for_qmatmul(wt, fmt)
            name = "qmatmul_packed"

            def kern(x, pw, sc, fmt=fmt):
                return qmatmul_packed(x, pw, sc, fmt)

            def plain(x, pw, sc, fmt=fmt):
                return qmatmul_packed_plain(x, pw, sc, fmt)
        del wt
        args = (x, qw, sc)
        first = kern(*args)
        torch.cuda.synchronize()
        check_qmm(f"2r {name} {fmt} {size}^3", first, plain(*args), size)
        ms = time_ms(kern, [args], reps=5)
        tab = ("Fig 12" if size != 2048 else "Tab VI / Fig 12"
               if fmt == "float8_e4m3fn" else "Tab VI")
        rows.append(_power_row(
            f"{tab} {name} {fmt} {size}^3", model, meter, kern, args, ms,
            2 * size ** 3, nbytes(x, qw, sc) + size * size * 2,
            ("bfloat16", fmt), first))
        del x, qw, sc, args, first

    # Tab VIII: phases 2 / 2b's served runs beside serve_demo's estimate
    demo = {r["format"]: r for r in demo_rows}
    for fmt, out in served.items():
        w, est = out["energy"], demo[fmt]["estimate"]
        j_token = w.watts * w.wall_s / out["tokens"]
        model_j = est.total_watts * est.seconds
        few = (f" (FEWER THAN {FEW_UPDATES} COUNTER UPDATES)"
               if w.updates < FEW_UPDATES else "")
        log(f"[power 2r] Tab VIII gptneox-1b {fmt} weights: {out['tokens']} "
            f"tokens in {w.wall_s:.3f} s; {w.updates} counter updates{few} "
            f"over {w.seconds:.3f} s: {w.watts:.1f} W, {j_token:.4f} J a "
            f"generated token; serve_demo's model for gptneox-1b at full "
            f"width on {model.name}: {est.total_watts:.1f} W, "
            f"{model_j * 1e3:.4f} mJ a token (measured / model W "
            f"{w.watts / est.total_watts:.3f}, J {j_token / model_j:.3f}); "
            f"at its end {w.end.describe()}")
        rows.append({"label": f"Tab VIII {fmt}", "watts": w.watts,
                     "updates": w.updates, "j_token": j_token,
                     "model_w": {fmt: est.total_watts},
                     "model_j_token": model_j})
    log(f"[power 2r] summary {json.dumps(rows)}")
    return rows


def _dp_leaves(rng) -> dict:
    """Phase 3k's gradient leaves: 1-D, 2-D, 3-D (rows of 3200), all
    zero, and one outlier row."""
    outlier = rng.standard_normal((32, 64)).astype(np.float32)
    outlier[0] *= 1e3
    return {"vec": rng.standard_normal(1000).astype(np.float32),
            "mat": rng.standard_normal((64, 300)).astype(np.float32),
            "cube": rng.standard_normal((4, 16, 200)).astype(np.float32),
            "zero": np.zeros((8, 8), np.float32),
            "outlier": outlier}


def phase3k_dp_parity():
    """Data-parallel training card against CPU, fp32, TF32 off, through
    the one-rank group (:func:`_dp_group`: NCCL on the card, gloo on the
    CPU).  ``compressed_psum_tree`` on :func:`_dp_leaves` from the same
    bits and key: bit-identical, whole and in blocks of 1000 elements
    (the 3-D leaf's rows drawn in pieces); then the compressed DP step of
    qwen2.5-3b reduced (2 layers) at accum 2 on 4 x 32 tokens, 3 steps,
    each from the CPU's state: 3i's tolerances with the compressed
    mean's allowance for ``m`` / ``v`` (:func:`_compare_train_states`),
    the card's launches 2 x 2 x 2 ``flash_attention`` and 2 x 2
    ``flash_attention_bwd`` a step, no plain version."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.serve import prng
    from repro_torch.train import make_local_dp_train_step, train_state_init
    t_start = time.perf_counter()
    _dp_group()
    leaves = _dp_leaves(np.random.default_rng(21))
    chunk0 = compression.CHUNK
    try:
        for chunk in (chunk0, 1000):
            compression.CHUNK = chunk
            out = {}
            for dev in ("cpu", "cuda"):
                key = prng.fold_in(prng.prng_key(3, dev),
                                   torch.full((), 2, device=dev))
                out[dev] = compression.compressed_psum_tree(
                    {k: torch.from_numpy(v).to(dev)
                     for k, v in leaves.items()}, key, None, 1)
            for k in leaves:
                if not torch.equal(_bits(out["cuda"][k].cpu()),
                                   _bits(out["cpu"][k])):
                    raise AssertionError(f"3k: compressed leaf {k} at chunk "
                                         f"{chunk} differs card vs CPU")
    finally:
        compression.CHUNK = chunk0
    log(f"[dp 3k] compressed_psum_tree card vs CPU bit-identical: "
        f"{ {k: v.shape for k, v in leaves.items()} }, whole and in blocks "
        f"of 1000")
    cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = get_config("qwen2.5-3b").reduced()
        model = build_model(cfg)
        opt = AdamWConfig(schedule=Schedule(peak_lr=3e-3, warmup_steps=0,
                                            decay_steps=10))
        cpu = train_state_init(model, opt, torch.Generator().manual_seed(0),
                               "cpu")
        card = bridge.unflatten({k: t.detach().to("cuda", copy=True)
                                 for k, t in bridge.flatten(cpu).items()})
        steps = {dev: make_local_dp_train_step(model, opt, accum_steps=2,
                                               compress=True)
                 for dev in ("cpu", "cuda")}
        rng = np.random.default_rng(22)
        lr_sum = 0.0
        for n in range(1, 4):
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (4, 32)).astype(np.int32))
            m_before = {k: t.detach().to("cuda", copy=True) for k, t in
                        bridge.flatten(cpu["opt"]["m"]).items()}
            _zero_train_counters()
            card, mg = steps["cuda"](card, {"tokens": tokens.cuda()})
            counts = _train_counters()
            cpu, mc = steps["cpu"](cpu, {"tokens": tokens})
            lr_sum += float(opt.schedule(n))
            want = dict.fromkeys(counts, 0)
            want.update(fwd=2 * 2 * cfg.n_layers, bwd=2 * cfg.n_layers)
            if counts != want:
                raise AssertionError(f"3k: card launches {counts}, expected "
                                     f"{want}")
            for name in ("loss", "grad_norm"):
                g, w = float(mg[name]), float(mc[name])
                if abs(g - w) > 1e-5 * abs(w):
                    raise AssertionError(f"3k step {n}: {name} card {g} "
                                         f"cpu {w}")
            got, worst, worst_frac = _compare_train_states(
                "3k", n, card, cpu, lr_sum, m_before, opt)
            log(f"[dp 3k] compressed DP step {n} (accum 2): loss card "
                f"{float(mg['loss']):.7f} cpu {float(mc['loss']):.7f}, "
                f"grad_norm card {float(mg['grad_norm']):.6f} cpu "
                f"{float(mc['grad_norm']):.6f}; state max abs diff "
                f"{worst:.3e}; params beyond rtol 1e-4 / atol 1e-6: at most "
                f"{worst_frac[0]:.4%} of a leaf ({worst_frac[1]})")
            with torch.no_grad():
                for k, w in bridge.flatten(cpu).items():
                    got[k].copy_(w)
        del card, cpu, steps
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    log(f"[time] phase 3k: {time.perf_counter() - t_start:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    # cuBLAS's fixed workspace, which deterministic mode (phase 2n)
    # requires; read when cuBLAS starts, so set before any product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.core.device_model import detect_backend_model
    from repro_torch.kernels import _build

    # ---- 0: the card and the build ----------------------------------- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        log(line)
    name = torch.cuda.get_device_name(0)
    # one model of the part gives every phase its peaks
    model = detect_backend_model()
    hbm, peak_bf16 = model.hbm.bandwidth_Bps, model.peak_flops["bfloat16"]
    log(f"[card] {name}; detected part model {model.name}: "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
        f"HBM {hbm / 1e12} TB/s, bf16 {peak_bf16 / 1e12} TFLOP/s, TF32 "
        f"{model.peak_flops['float32'] / 1e12:g} TFLOP/s, fp32 "
        f"{model.vector_flops['float32'] / 1e12:g} TFLOP/s")
    log("[card] " + compat.report().replace("\n", "; "))
    t_start = t0 = time.perf_counter()
    _build.build_all(SOURCES)
    log(f"[build] {', '.join(SOURCES)}: {time.perf_counter() - t0:.2f} s")
    for src in SOURCES:
        lines = collections.Counter(
            line.split(":", 1)[-1].strip()
            for line in _build.build_log.get(src, "").splitlines()
            if "registers" in line or "spill" in line or "C75" in line)
        for line, count in sorted(lines.items()):
            log(f"[build]   {src}: {count} x {line}")

    t_phase = [time.perf_counter()]
    meter = phase0_nvml()

    def stamp(phases: str) -> None:
        now = time.perf_counter()
        log(f"[time] phases {phases}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    stamp("0 NVML")

    # ---- 1: kernels vs plain on the card ----------------------------- #
    fd_entries = phase1_flash_decode(hbm, peak_bf16)
    fdq_entries = phase1b_flash_decode_quant(hbm, peak_bf16)
    qmm_entries = phase1c_qmatmul(hbm, peak_bf16)
    probe_entries = phase1d_probes(model)
    ssd_entries = phase1e_ssd_scan(model)
    fa_entries = phase1f_flash_attention(model)
    modal_entries = phase1g_modal_shapes(hbm, peak_bf16)
    fab_entries = phase1h_flash_attention_bwd(model)
    ssdb_entries = phase1i_ssd_scan_bwd(model)
    stamp("1-1i")

    # ---- 2: full-width serving, then the GEMM path ------------------- #
    cfg = get_config("gptneox-1b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 256).tolist()
               for _ in range(8)]
    dense = phase2_engine(cfg, prompts, meter)
    for e in fd_entries:
        e["launches"] = dense["launches"]
    torch.cuda.empty_cache()
    quant = {fmt: phase2b_quant_engine(cfg, prompts, fmt, fmt, meter)
             for fmt in ("float4_e2m1fn", "float8_e4m3fn")}
    for e in fdq_entries:
        e["launches"] = quant[e.pop("fmt")]["launches"]
    counts = phase2c_gemm_path()
    for e in qmm_entries:
        e["launches"] = counts[e.pop("kernel")]
    torch.cuda.empty_cache()
    vocab = get_config("mamba2-2.7b").vocab_size
    mamba = phase2d_mamba2([rng.integers(0, vocab, 512).tolist()
                            for _ in range(8)])
    for e in ssd_entries:
        e["launches"] = mamba["launches"]
    whole = phase2e_whole_sequence(hbm, peak_bf16)
    for e in fa_entries:
        e["launches"] = whole["launches"]
    stamp("2-2e")
    phase2f_gemma2(hbm, peak_bf16)
    stamp("2f")
    phase2g_dense_family(dense)
    stamp("2g")
    jamba = phase2h_jamba(hbm, peak_bf16)
    stamp("2h")
    moe_models = phase2i_moe_models()
    stamp("2i")
    phase2j_robustness(cfg, prompts)
    stamp("2j")
    seamless = phase2k_seamless()
    stamp("2k")
    internvl2 = phase2l_internvl2()
    stamp("2l")
    spec = phase2m_speculation()
    stamp("2m")
    train, dp = phase2n_training()
    stamp("2n, 2p")
    ssm_train = phase2o_ssm_training()
    stamp("2o")
    phase2q_examples()
    stamp("2q")
    demo_rows = phase2q_serving_examples()
    stamp("2q serve_demo, long_context")
    phase2r_power(model, meter, {"bfloat16": dense, **quant}, demo_rows)
    stamp("2r")
    modal_paths = {
        "2k seamless dense serving": seamless["dense"]["launches"],
        "2k seamless float8_e4m3fn serving": seamless["float8_e4m3fn"][
            "launches"],
        "2k seamless float4_e2m1fn serving": seamless["float4_e2m1fn"][
            "launches"],
        "2k seamless whole sequence": seamless["whole"]["fa_launches"],
        "2k seamless decode after prefill": seamless["whole"][
            "fd_launches"],
        "2l internvl2 serving": internvl2["dense"]["launches"],
        "2l internvl2 whole sequence": internvl2["whole"]["fa_launches"],
        "2l internvl2 decode after prefill": internvl2["whole"][
            "fd_launches"]}
    for e in fd_entries:
        e["paths"] = {"2 gptneox-1b serving": e["launches"],
                      "2h jamba serving": jamba["dense"]["launches"],
                      **{f"2i {arch} serving": n
                         for arch, n in moe_models.items()},
                      **{k: v for k, v in modal_paths.items()
                         if "float" not in k and "whole" not in k},
                      "2m gptneox-1b self-draft serving": spec[
                          "gptneox dense self-draft"]["launches"][
                              "flash_decode"],
                      "2m gptneox-1b n-gram serving": spec[
                          "gptneox dense n-gram"]["launches"][
                              "flash_decode"]}
    for e in fdq_entries:
        e["paths"] = {"2b gptneox-1b serving": e["launches"],
                      "2h jamba serving": jamba["float8_e4m3fn"]["launches"],
                      **{k: v for k, v in modal_paths.items()
                         if "float" in k},
                      "2m gptneox-1b fp8 n-gram serving": spec[
                          "gptneox fp8 n-gram"]["launches"][
                              "flash_decode_quant"]}
    for e in ssd_entries:
        e["paths"] = {"2d mamba2 serving": e["launches"],
                      "2h jamba serving": jamba["dense"]["also_launches"][
                          "ssd_scan"],
                      "2h jamba whole sequence": jamba["whole"][
                          "ssd_launches"],
                      "2m mamba2 n-gram serving": spec["mamba2 n-gram"][
                          "launches"]["ssd_scan"],
                      "2o mamba2-2.7b training": ssm_train["fwd_launches"]}
    for e in ssdb_entries:
        e["launches"] = ssm_train["bwd_launches"]
        e["paths"] = {"2o mamba2-2.7b training": ssm_train["bwd_launches"]}
    train_paths = {f"2n qwen2.5-3b training accum {a}": t for a, t in
                   train.items()}
    train_paths.update({f"2p qwen2.5-3b local DP accum 2 {label}": t
                        for label, t in dp.items()})
    for e in fab_entries:
        e["launches"] = train[1]["bwd_launches"]
        e["paths"] = {k: t["bwd_launches"] for k, t in train_paths.items()}
    for e in fa_entries:
        e["paths"] = {"2e gptneox-1b whole sequence": e["launches"],
                      **{k: t["fwd_launches"]
                         for k, t in train_paths.items()},
                      "2h jamba whole sequence": jamba["whole"][
                          "fa_launches"],
                      "2k seamless whole sequence": modal_paths[
                          "2k seamless whole sequence"],
                      "2l internvl2 whole sequence": modal_paths[
                          "2l internvl2 whole sequence"]}
    for e in modal_entries:
        path = e.pop("path")
        e["launches"] = modal_paths[path]
        e["paths"] = {path: modal_paths[path]}

    # ---- 3: card vs CPU, fp32 ------------------------------------------ #
    model3, params3, prompts3 = phase3_parity(cfg)
    phase3b_quant_parity(model3, params3, prompts3)
    phase3c_mamba2_parity()
    phase3d_whole_sequence_parity()
    phase3e_dense_family_parity()
    phase3f_moe_parity()
    phase3g_modal_parity()
    phase3h_spec_parity(model3, params3)
    phase3i_train_parity()
    phase3j_ssm_train_parity()
    phase3k_dp_parity()
    stamp("3-3k")

    # ---- 4: the probe suite -------------------------------------------- #
    counts = phase4_characterize()
    for e in probe_entries:
        e["launches"] = counts[e["name"].split("[")[0]]
    stamp("4")
    log(f"[time] phases 0 (the build) to 4: "
        f"{time.perf_counter() - t_start:.1f} s")

    import torch.distributed as dist
    dist.destroy_process_group()

    # ---- result lines -------------------------------------------------- #
    for line in smi.splitlines():                # again, near the end
        log(line)
    print(json.dumps({"kernels": [*fd_entries, *fdq_entries, *qmm_entries,
                                  *probe_entries, *ssd_entries,
                                  *fa_entries, *modal_entries,
                                  *fab_entries, *ssdb_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
