#!/usr/bin/env python3
"""Smoke run of the PyTorch port (video_r2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from csrc/ (one nvcc per source, all started
   together) and prints the build time and each kernel's registers / spills;
3. serving kernels: holds the forward kernels against their plain PyTorch
   versions in bf16 at the serving slice's shapes, with the max error, both
   times, the card's bound and the time of one library call
   (F.scaled_dot_product_attention with the same mask), and each flash
   forward launch's blocks per SM beside those resident on one; the window
   forward and SDPA also in a CUDA graph (device times);
4. serving slice: Qwen2.5-VL-7B at full width in bf16 with seeded random
   weights, a DemoRunner answering 3 video questions (8 synthetic frames of
   392x392 each, 32 greedy tokens), with the launch counts set to 0 before
   and read after;
5. times prefill and decode, and holds the last-token logits of the kernel
   path against the plain path (ViT "xla", decoder "xla");
6. training kernels: at the training batch's shapes (decoder B=2 at its
   padded width, causal, ragged lengths; the ViT's full-attention groups
   with segments; its windows) the forward with LSE, the dq and dk/dv
   kernels and the window backward against their plain versions, with the
   library call's forward and backward times (the window backward and
   SDPA's backward also in a CUDA graph: SDPA's forward + backward less its
   forward); the dq + dk/dv pair's time
   beside the SDPA backward on one line, with each launch's blocks per SM
   (grid blocks over the SMs, and those the occupancy calculator keeps
   resident on one); the window backward's persistent grid (blocks,
   resident blocks an SM, (head, window) items a block) and the ptxas
   registers and spills of its instance, beside its device time;
7. training slice: LoRA SFT (r=64, alpha=64) on 2 records of 16 synthetic
   frames at 392x392 (grid (8, 28, 28), 1568 video tokens each) with a
   think-style question and answer: step-1 loss and adapter gradients of
   the kernel path against the plain path, for the frozen tower and for
   adapters in the tower; then apps/train_sft.train takes 3 steps with the
   tower frozen and 1 with adapters in the tower, with the launch counts set
   to 0 before and read after;
8. paged decode kernels: at the batched slice's shapes (B=8 prompts of the
   admitted lengths plus 64 decode steps, 28/4 heads, hd 128, page size 128,
   shuffled page tables over a 28-layer pool, each timed launch on the next
   layer so the pages come cold) the bf16 kernel with W=1 and W=4 (a verify
   chunk), the int8 kernel, fp32 q and pages and the one-layer entry
   against their plain versions, with the library call
   (F.scaled_dot_product_attention over K/V already gathered dense,
   dequantised for int8; the gather is not timed), each timed eagerly and
   in a CUDA graph (device time), and each launch's split plan (splits,
   blocks, blocks an SM) with its instance's registers and spills;
9. batched serving: the paged continuous-batching engine as the eval
   backend builds it (8 slots, page size 128, power-of-two buckets from 128
   to 2048, prefix cache on, bf16 pages) takes 12 video questions (8
   synthetic frames at 392x392 each, ViT embeds through submit_batch,
   ragged greedy budgets of 24-128 tokens) and runs step(steps=8) until
   drained, admitting waiting requests as slots free, with the launch counts
   set to 0 before and read after; request 0's logits after its first
   window are held against the contiguous plain path teacher-forced on its
   tokens, and a 4-request pass with kv_quant="int8" (counted alone) against
   the bf16 engine after one step.
10. MoE kernels: the grouped expert FFN at the judge's shapes (H 2048, I
   768, E 128, top 8, the weights of one full layer: seeded, scaled like
   init_params) against its plain version: bf16 ragged decode (T = 16, A =
   128 slots of C = 16), bf16 GMM prefill (T = 4096, 128-row blocks, slack
   blocks present), int8-weight ragged decode and GMM prefill, and W8A8 GMM
   prefill, with the bound and the library call (torch._grouped_mm over the
   routed rows sorted by expert, where the card's torch takes it; bf16
   only), the ragged decode cases also as device times (CUDA graphs, the
   library call's too); then at the token counts phase 11 gives it: the
   bf16 burst's prefill (16 prompts padded to one width), the int8 pass's
   W8A8 prefill and its decode (T = 4: 32 slots of 8 rows), the paged
   pass's decode (T = 8: 64 slots of 8 rows); then the fp32 instance (fp32
   x over fp32 copies of the weights: ragged decode T = 16, GMM prefill
   T = 512) within FP32_TOL; each int8-weight ragged decode case (T = 16,
   4, 8) also times the bf16 decode kernel at its routing; each case prints
   the kernels it ran (wgmma, the decode kernel, mma.sync or fp32), their
   tile widths, blocks and registers;
11. the judge: every 7B tensor of phases 1-9 freed, Qwen3-30B-A3B
   (qwen3_moe_30b_a3b(), 48 layers, all widths) built in bf16 with seeded
   random weights on the card; EngineJudge(ChatEngine(..., attn_impl=
   "flash"), max_tokens=64).chat_many over 16 TAC-style requests (a rubric
   system prompt and a think/answer excerpt, 512-1024 bytes), greedy, with
   the launch counts set to 0 before and read after (the grouped FFN's
   split into prefill, GMM blocks, and decode, the ragged table, at the
   first decode step); one decode step under the profiler (kernel launches
   and device time per step; the idle share under the profiler and against
   the burst's unprofiled ms per step); request 0's last-token logits after
   its prompt and after one decode step, kernel path (flash, grouped FFN
   kernel) vs plain path (plain attention, the FFN's plain version); then
   quantize_params in place and a 4-request pass with act_quant="int8"
   (W8A8 prefill, int8-weight decode) whose prefill logits are held against
   the bf16 model's; last, 8 requests through PagedContinuousEngine (8
   slots, page size 128) on the int8 model, step(steps=8) until drained.
   Every timed pass notes the (variant, A, C) of each grouped FFN call it
   makes; a short replay of it (the same prompts, 2 new tokens) keeps the
   operands of the first call of each, must give every shape the timed
   pass gave, and the kernel is held against its plain version on exactly
   those inputs. The judge's peak memory is read before the replays.
12. int4 kernels (after phase 9, on the 7B model before it is freed for the
   judge): the int4 matmul at every (rows, K, N) phase 13 gives it (decode
   B = 4: q / o, k / v, gate / up, down, the head; the merger's 784 rows a
   video: fc1 and fc2; B = 1: the head and gate / up) and at the ViT's
   widths for a clip of 784 patches (qkv, proj, gate / up: N = 3420, a
   column tail), seeded weights
   quantized with quantize_kernel_int4 and copies enough to exceed the L2
   cache, so each timed launch reads cold weights as a decode step does,
   with the library call (torch._weight_int4pack_mm over its own packing,
   made once, untimed; "none" and the reason where the card's torch does
   not take it), both timed eagerly and in a CUDA graph (device time), and
   each shape's launch: the decode kernel's stream-K plan (blocks, tiles,
   steps a block; its resident blocks an SM held to the plan's) or the
   staged kernel's split-K plan (S, its blocks), and the scale placement;
   the head-major decode
   kernel at phase 13's batch (B = 4, 28 / 4 heads of 128, its ragged
   prompt lengths and padded width, a 28-layer cache) at decode step 0,
   at step 63 and with the window off, on layers other than 0, each timed
   launch on the next layer, with the library call
   (F.scaled_dot_product_attention over that layer's K / V, GQA expanded
   beforehand, with the boolean mask), both timed eagerly and in a CUDA
   graph, and the launch's split plan and registers;
13. int4 serving: request 0..3's bf16 prefill logits first, then
   quantize_params(model, bits=4) in place (the int4 / int8 / float byte
   split and the peak memory); 4 video questions (8 frames of 392x392 each,
   questions of different lengths) prepared one at a time through
   DemoRunner.prepare / vision_embeds and right-padded into one
   generate(..., attn_impl="flash", decode_impl="kernel") call of 64 greedy
   tokens, eos off, with the launch counts set to 0 before and read after;
   prefill ms, ms per decode step, tok/s; request 0's logits after prefill
   and after one decode step, kernel path vs plain path (the int4 and
   decode kernels' plain versions, plain prefill and ViT attention), and
   the same for a 2-frame clip (784 patches, so the ViT's int4 linears take
   the kernel too, counted); the
   batch's logits after one decode step under decode_impl="kernel" vs
   "xla"; int4 vs bf16 prefill logits (no bound: the weights are random).
14. GMM backward kernels (after phase 10): one seeded judge-width MoE layer
   (MoEMLP: E 128, H 2048, I 768, top 8, scaled like init_params; expert
   77's router column zero, so no token routes to it) under autograd, T =
   4096 tokens, the router and the experts trained, loss = sum(out * cot):
   dX, the router's gradient and dWg / dWu / dWd of the kernel path against
   the plain path (ffn_impl="plain"), the absent expert's dW exactly 0, the
   launches of that run (each backward kernel once, the grouped FFN twice:
   forward and the d_topv recompute); then the dX, dW and dWd kernels
   against their plain versions on the backward's own operands, timed, with
   the bound and the library call (torch._grouped_mm: for dX the three
   products g, u, dh from x and dY, the SwiGLU terms and the two dX
   products, as the dX kernels form them; for dW from dg / du / h and dY;
   where the card's torch takes them), the dX launches' tiles, blocks and
   registers, the weight-gradient kernel's tiles, ring, persistent grid and
   registers / spills; dW and dWd in bf16 (the kernel's epilogue rounds the
   fp32 sum once) held elementwise, with a second call giving the same
   bits, and timed eagerly and in a CUDA graph (device time), the library
   call both ways; dW and dWd again at 48-row blocks with NaN in every slack
   row; the whole backward timed; dX again at phase 15's token count
   (2 x 1024) with its library call; the fp32 instances of the three
   kernels at T = 512 (fp32 copies of the weights) within FP32_TOL;
15. MoE LoRA SFT (inside phase 11, on the bf16 judge before quantize_params):
   LoRA r 64 / alpha 64 on the default targets of Qwen3-30B-A3B (48 layers,
   full width), SFTConfig(attn_impl="flash", gradient_checkpointing=True),
   B = 2 records of the judge's requests (the rendered prompt masked, a
   verdict answer labelled) padded to 1024: step-1 loss and adapter
   gradients, kernel path (flash, grouped FFN, GMM dX) vs plain path
   (set_kernel_impl "plain", attention "xla"); then 3 steps of
   make_lora_sft_step with the launch counts set to 0 before and read after
   (the dX kernel once a MoE layer a step, the dW kernels never); ms per
   step, tokens/s, peak memory.

16. int8 kernels (after phase 11, on a fresh Qwen2.5-VL-7B quantized in
   place with bits=8): the int8 matmul at every (rows, K, N) phase 17 gives
   it (decode B = 16 and B = 1: q / o, k / v, gate / up, down, the head;
   the bench batch's prefill head at 64 rows), at the merger's 1024 rows
   (above the row limit, so phase 17 converts there; held all the same) and
   at the tails (K 300 / N 500; the ViT's gate / up and down at 3420, 784
   rows),
   seeded weights quantized with quantize_kernel, copies past the L2 cache
   so each timed launch reads cold weights, against its plain version,
   with the bound and the library calls (convert + torch.matmul x scale,
   the dispatcher's own path above its row limit; torch._weight_int8pack_mm
   where the card's torch takes it), the kernel and convert + matmul also
   in a CUDA graph (device times); the route each call took (decode, wide
   or element-load kernel, from the wrapper's counts) and its plan; where
   the decode kernel takes a shape, the wide kernel's times there, held
   against the plain version too; the kernel against convert + matmul at
   M = 1 to 1024 at gate / up and q, with each call's route, the
   measurement behind INT8_KERNEL_MAX_ROWS; then scripts/microbench_int8.py's
   comparison at its shape (M 64, K 3584, N 18944, L 28): one all-layers
   launch, 28 stacked launches and 28 convert + matmul, in GB/s, with the
   launch counts set to 0 before and read after (every one on the wide
   kernel, asserted), then the two entries' device times (CUDA graphs),
   the all-layers and stacked outputs held against their plain versions on
   three layers; last the flash kernel at phase
   17's prefill shapes, (a)'s quantized fill (B = 16, Sq = Sk = the padded
   prompt, the batch's lengths) and one (b) chunk (64 full prompts of 256);
17. int8 serving (after phase 16, on the same model; the int8 / float byte
   split and peak memory first): (a) the eval backend's configuration, 16
   video questions (8 frames of 392x392 each, questions of different
   lengths, prepared one at a time through DemoRunner) in one
   generate(attn_impl="flash", kv_quant="int8") of 64 greedy tokens, eos
   off, weight-only, with the launch counts set to 0 before and read after
   (the int8 kernel's count derived from the rows each linear sees and
   INT8_KERNEL_MAX_ROWS, its decode kernel's from the shapes alone:
   every linear and the head at up to 16 rows, and the rest on the wide
   kernel, all asserted); prefill ms,
   ms per decode step, tok/s;
   request 0's logits after prefill and after one decode step, kernel path
   vs plain path (the int8 kernel's plain version, plain prefill and ViT
   attention); the batch's logits after one decode step over the int8 cache
   vs the bf16 cache; the int8-KV decode attention timed against the bf16
   cache's at (a)'s and (b)'s shapes; (b) bench.py's workload, 256 prompts
   of 256 ids from np.random.default_rng(0), 128 new tokens (eos off, as
   bench.py's scan decodes them all), attn_impl="flash", act_quant="int8"
   (W8A8 prefill and, at B >= 192, W8A8 decode), kv_quant="int8",
   prefill_chunk=64: one warm run, then 3 timed runs, decode tok/s (their
   median, and each) under bench.py's metric name, launches (the int8
   kernel's, the prefill chunks' head, all on the wide kernel, asserted),
   peak memory; (c) QLoRA-GRPO over the same int8 base: one cycle through
   apps/train_grpo.train (which takes init_lora_for_quantized, r 64 on the
   int8 linears, and make_lora_grpo_step) on the "batch" backend (1 prompt
   on a 2-frame clip x 4 rollouts x 32 tokens, the default rewards),
   counted: the int8 kernel's decode route (the decode
   steps) and wide route (the merger's 196 rows in the prompt's ViT pass)
   launched, no refusal in the loss (the int8 linears under adapters take
   convert + matmul), KL exactly 0, a finite loss, the adapters moved, its
   metrics.jsonl line and checkpoint written; its peak memory beside phase
   19's bf16 peak.
18. the tiny fp32 model (first, before phase 3): tiny_test_config() (text
   head dim 12, vision 16) with seeded weights on the card and the same
   weights on the CPU; the fp32 instances of the flash forward (serving,
   with LSE), backward and window forward / backward against their plain
   versions at the path's shapes within FP32_TOL, timed beside the bound
   (fp32 CUDA-core peak) and SDPA in fp32 (the window cases eagerly and in
   a CUDA graph); then, counted, a video
   question's prefill logits (relative L2 within FP32_TOL of the CPU's),
   its greedy tokens through DemoRunner.generate (equal) and one
   make_sft_step step with the tower trained (loss within FP32_TOL, the
   gradients' global norm within 1e-3 of the CPU's), then one full-parameter
   make_grpo_step GRPO cycle (greedy batch rollouts, G 2, another seeded
   tiny model as the reference policy): completion tokens equal, loss and
   the gradients' global norm within FP32_TOL of the CPU's; every fp32
   instance launched. Then the eval path on the same two models: evaluate
   over mvbench_think with 3 in-memory-frame docs (56x56), 8 greedy tokens,
   through EngineModel in batch and in paged mode (responses and per-sample
   rows equal to the CPU's, results equal but for the wall time), one
   continuation's loglikelihood within FP32_TOL, and the paged engine's
   regrowth on the card (three prompts of rising length, one admitted a
   pass: at each rebuild the memory allocated is back at its level before
   the first engine, so the old pool was freed before the new one).
19. LoRA-GRPO (after phase 9, on the same 7B before phase 12 quantizes it):
   train_grpo.sh's per-GPU share (1 prompt, num_generations 8, beta 0.04,
   lr 1e-6) with 128 new tokens (the recipe's 1024 cut for time): a
   think-style question on 8 synthetic frames of 392x392 with the default
   system message, LoRA r 64 / alpha 64 on the default targets, rollouts on
   PagedContinuousEngine (step(8)), temperature 1, top_k 50, the default
   rewards (accuracy, format, TAR; weights 1, 1, 1) with a fake judge
   (GroundingJudge) and the HashingEmbedder. (a) on the first rollout batch
   of a GRPORunner (B 8 x prompt + 128): the flash kernels at its shape
   (segment ids for the [prompt_pad | completion] gap) against their plain
   versions; per_token_logps kernel path ("flash") vs plain path ("xla")
   in nats over the completion (max |d| <= LOGP_MAX_ABS, RMS of exp(d) - 1
   <= LOGP_RATIO_RMS, with a control that drops the flash forward's causal
   mask above both), step 1's loss and adapter gradients within phase 7's
   bounds, and a control with the dq kernel's output zeroed above them;
   one decode window of the rollout engine under the profiler (launches,
   busy ms, idle share); (b) two cycles through apps/train_grpo.train
   (init_lora, make_lora_grpo_step, the module as its own reference
   policy, metrics.jsonl, a checkpoint), counted: the window, flash
   (serving and training) and bf16 paged kernels launched, cycle 1's KL
   exactly 0, finite losses, the adapters moved; (c) s a cycle, the phase
   timer's split, rollout tokens/s, peak memory.
20. the eval path (after phase 19, on the same bf16 7B): apps/run_eval's
   path, EngineModel + evaluate with the app's eval defaults (batch 8, 128
   frames at most, pixels in [100352, 151200]), over mvbench_think and
   videomme_think, 8 docs each, each one in-memory clip of 32-36 frames of
   336x448 at 1 fps (kept at their size: the host needs no PIL resize),
   max_new_tokens cut from 1024 to 64; first engine_mode "batch" (the ViT a
   clip at a time, prefill in row chunks), then "paged" (decode_steps 8),
   counted together: every doc answered, both samples files with the
   harness's keys, accuracy in [0, 1]; docs/s, prefill ms a batch, decode
   tok/s, the device loop's wait on the prefetch loader and its share
   (synchronized timers), peak memory, the share of docs whose batch and
   paged responses are equal (printed only); the first batch's request 0,
   teacher-forced on 16 of its tokens, logits through the kernels (the
   ViT's, flash prefill) vs the plain path within LOGITS_TOL; the paged
   decode kernel against its plain version at the paged pass's contexts
   (the first submit_batch's 8 prompts at their full budget). Phase 17(d),
   after 17(b) on the int8 7B: one batch-mode pass of EngineModel(kv_quant=
   "int8") over 8 mvbench_think docs, 32 tokens, every doc answered and the
   int8 decode kernel launched. Phase 20(c), after phase 20 on the same
   model: models/attention_tap.py over the first batch's request 0, its
   prompt and 64-token completion (S ~3.4k, completion_window the
   completion, key chunks of 2048, the ViT from its patches), once with
   attn_impl "flash" and once on the plain path, counted: the two masses
   within TAP_TOL, the flash kernel launched; ms and peak memory of each.
21. the post-hoc judge path (after phase 11, on its int8 Qwen3-30B-A3B,
   phase 11's engines gone): apps/serve's construction (parse_args +
   build_engine) over scripts/serve_judge.sh's MoE stand-in (--paged
   --kv-quant int8 --decode-window 8, 16 slots; --max-len 8192 and 32 new
   tokens, cut for time, no prompt cut; --spec-decode and --prefill-chunk
   not ported)
   served on 127.0.0.1 in a thread, then, counted, apps/test_judge,
   apps/postprocess tac, vas and summarize over phase 20's batch-mode
   samples tree (16 rows); requests served and failed (HTTP errors and
   failed admissions, asserted 0), requests/s, client latency p50 / p95,
   decode tok/s, admissions by route (packed, submit_batch, single) with
   the prompt lengths each took, the kernels' launches, peak memory, the
   TAC and VAS summary keys; the outputs' key sets equal those the same
   functions write under a fixed judge; then, the loop stopped, one decode
   window under the profiler (idle share) and packed admission on the
   served engine: four short judge prompts in one row, each one's logits
   against its solo prefill within PACKED_TOL, a control without segment
   ids above it.
22. speculative decoding and chunked prefill (scripts/serve_judge.sh's
   --spec-decode 8 --prefill-chunk 2048), in four places: (a) the paged
   kernel at the verify chunks the paths give it against its plain version
   (phase 8's tolerance, device ms, the bytes bound, SDPA): bf16 pages at
   the 7B's g = 7 with W = 9 (63 query rows, 22(d)'s rounds) and W = 5 (35
   rows, 22(d)'s GRPO rollouts), and fp32 q and pages at W = 10 (70 rows:
   two row groups, checked only) at phase 8's contexts; int8 pages at the
   judge's g = 8 (72 rows, two row groups) at phase 21's served contexts;
   the int8 matmul at the judge's widths with 22(c)'s 144 verify rows and
   the grouped FFN at its 144 (GMM) and 9 (ragged) tokens; (b) on the tiny
   fp32 config (after phase 18): spec (K = 4) against plain greedy, tokens
   equal, in generate, the slot engine and the paged engine over fp32 and
   int8 pages (mid-stream admission), and chunked against whole prefill,
   tokens equal, on the slot and paged engines; then the paged kernel at
   those verify chunks (W = 5, g = 2, fp32 q over fp32 and int8 pages)
   against its plain version; (c) after phase 21, on its
   int8 judge: apps/serve with SPEC_ARGV (phase 21's flags plus
   --spec-decode 8 --prefill-chunk 2048) over the same TAC / VAS requests
   through HTTP, counted: 0 failed; printed beside phase 21's plain figures:
   requests/s, p50 / p95, slot-tokens/s, tokens a spec round a slot, the
   chunked prefills, and how many answers and tokens agree with phase 21's;
   then, the loop stopped, a verify round's logits (drafts from the
   engine's history) against the engine's plain path teacher-forced on the
   same chunks, at full load (16 served prompts, 144 rows: the int8 wide
   kernel and the GMM route) and with one slot (the longest TAC prompt, 9
   rows: the int8 decode kernel and the ragged route), and a 5k-token
   prompt's logits
   after its chunked prefill against its whole prefill, each within
   JUDGE_LOGITS_TOL; (d) on the bf16 7B: phase 20's batch pass again with
   spec_decode = 8 (docs/s, answers equal to phase 20's, printed), one
   phase-19 GRPO cycle with rollout_spec_decode = 4 (loss finite; cycle s,
   tokens a round), and ms of a verify round against ms of a plain step of
   the paged engine at B = 16 (K = 8), with _reject_all's floor.
23. the Qwen3-Next judge (models/qwen3_next.py, engine/next_continuous.py),
   scripts/serve_judge.sh's default model: (a) its kernels at the judge's
   shapes against their plain versions, with device ms (CUDA graphs), the
   bound and the library call: flash at head dim 256 (B = 1, S = 2048,
   16 / 2 heads, causal; 512 rows at q_offset 1536; SDPA), the grouped FFN
   in bf16 and with int8 weights at E 512, top 10, H 2048, I 512 (ragged
   decode T = 8, GMM prefill T = 2048; torch._grouped_mm), the int8 linears
   at its widths; then the gated delta rule's torch time (one DeltaNet
   layer's prefill at S = 2048 and a decode step: eager and device ms,
   launches); (b) a small fp32 Next config (H 128, expert I 64: widths the
   FFN kernels take) on the card against the same module on the CPU: greedy
   tokens equal for generate_packed, a prefix-store burst, generate_spec and
   the slot engine with chunked prefill and spec; (c) qwen3_next_80b_a3b()
   at full width in bf16, cut to 12 of 48 layers (48 do not fit one card),
   seeded on the card: 4 judge prompts' prefill logits through the kernels
   against the plain path (JUDGE_LOGITS_TOL) and a 16-request prefix-store
   burst, miss then hit; (d) that model quantized to int8 in place and
   served through apps/serve with serve_judge.sh's Next flags (NEXT_ARGV)
   over HTTP: phase 21's test_judge, TAC and VAS requests, counted, 0
   failed: requests/s, p50 / p95, decode tok/s, spec tokens a round, the
   chunked prefills, launches by kernel; then a spec dispatch and a plain
   decode window under the profiler (idle share).
24. Qwen3-Next training (models/qwen3_next.py::next_loss,
   make_next_lora_sft_step): (a) its kernels at its shapes against their
   plain versions: the flash forward with LSE, dq and dk/dv at head dim 256
   (B = 2, S = 2048, 16 / 2 heads, causal, kv lengths (2048, 1536)) with
   their times, bounds, device ms (CUDA graphs) and SDPA's forward /
   backward, a suffix at q_offset 1536 and packed segments; the GMM dX
   kernel at E 512, top 10, T = 4096 (40960 routed rows) with its bound and
   torch._grouped_mm; (b) the small fp32 config's LoRA step on the card
   against the CPU (loss and adapter gradients within 1e-4; the fp32
   flash training, FFN and dX instances launched); (c) on 23(c)'s bf16
   model: LoRA r 64 over NEXT_LORA_TARGETS at B 2 x S 2048, step 1's loss
   and adapter gradients through the kernels against the plain path with
   the kernel path's expert ids replayed (PATH_LOSS_RTOL, PATH_GRAD_REL_L2)
   and a control (the dX kernel's output zeroed) above the bound, then 3
   steps: s/step, tokens/s, peak GiB, launches; (d) after 23(d) served,
   QLoRA over the int8 model (init_lora_for_quantized): 3 steps on the same
   batch, the loss falls, peak GiB, launches.

Phase order: 18 with 22(b), 1-9 with 22(a), 19 and 20 with 22(d), 20(c),
12-13 (one 7B, freed), 10, 14, 11 with 15, then 21 with 22(a) and 22(c)
(the judge, freed), 23 with 24 (the Next judge: 23(a), 23(b), 24(a),
24(b), 23(c), 24(c), 23(d), 24(d); freed), 16-17 with 17(d) and 17(c) (a
new 7B).

Prints a JSON line of per-kernel results (each row's launches on its path,
grpo_launches of phases 19 / 17(c), eval_launches of phase 20,
posthoc_launches of phases 20(c) / 21, spec_launches of phase 22(c),
next_launches of phase 23(c) / (d), next_train_launches of phase 24(c) /
(d); the paged kernel's verify-chunk cases and phase 23(a)'s and 24(a)'s
cases at the Next judge's shapes as rows of their own, each with its case
and its launches: those of 22(b) / (c) / (d)'s verify chunks at that
shape, phase 23's and phase 24's), then the card line, and last
{"ok": true, "device": {...}}. Any failed phase raises, so the exit code is
non-zero and that line is not printed. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
DEVICE = "cuda:0"
N_REQUESTS = 3
N_FRAMES, FRAME_HW = 8, 392       # grid (4, 28, 28): 784 video tokens
NEW_TOKENS = 32
TRAIN_FRAMES = 16                 # grid (8, 28, 28): 1568 video tokens
TRAIN_STEPS = 3
# kernel vs plain, for unit-normal bf16 inputs:
# - outputs: |kernel - plain| <= ATOL + RTOL |plain| elementwise: both round
#   to bf16 (a step is 2**-8 to 2**-7 of the value) and the kernel also
#   rounds P to bf16 before P @ V;
# - the LSE: |kernel - plain| <= 1e-3 (fp32 sums of the same bf16 products);
# - gradients: relative L2 <= 1e-2 per tensor (the kernels round P and dS
#   to bf16 before their products, the plain versions keep fp32).
KERNEL_ATOL, KERNEL_RTOL = 1e-2, 1e-2
LSE_ATOL = 1e-3
GRAD_REL_L2 = 1e-2
LOGITS_TOL = 5e-2    # relative L2 of last-token logits, kernel vs plain path:
                     # bf16 rounding differs at every attention output over
                     # 32 ViT + 28 decoder layers
# training step 1, kernel path vs plain path (bf16 rounding differs at every
# attention output and its gradient, over 28 decoder layers, 32 ViT layers)
PATH_LOSS_RTOL = 1e-2
PATH_GRAD_REL_L2 = 5e-2
# GRPO's per-token log-probs, kernel vs plain path, in nats over the
# completion tokens (phase 19(a)), where the loss reads them through
# exp(lp - old) and exp(ref - lp). On an H100 80GB HBM3 (700 W) the sound
# path read max |d| 6.350e-2 and relative L2 2.288e-3 (|lp| ~12, so an RMS
# near 2.7e-2); at 0.125 the worst token's ratio stays within 14%, under the
# clip's 0.2, and the RMS of exp(d) - 1 within 5%
LOGP_MAX_ABS = 0.125
LOGP_RATIO_RMS = 5e-2
# the least time: the larger of bytes / 3.35 TB/s and operations / 989
# TFLOP/s bf16 (67 TFLOP/s fp32 outside the tensor cores; H100 SXM data
# sheet, dense)
PEAK_BYTES, PEAK_BF16, PEAK_FP32 = 3.35e12, 989e12, 67e12
# fp32 operands, kernel vs plain: both keep every operand and product fp32
# and differ in the order of their fp32 sums and the kernel's fast exp2
FP32_TOL = 1e-4
# batched serving (phase 9)
SERVE_REQUESTS, SERVE_SLOTS, PAGE_SIZE, DECODE_STEPS = 12, 8, 128, 8
SERVE_MAX_LEN = 2048
SERVE_BUCKETS = (128, 256, 512, 1024, 2048)
SERVE_BUDGETS = (128, 24, 96, 40, 64, 112, 32, 80, 56, 128, 48, 72)
INT8_REQUESTS = 4
# int8 pages vs bf16 pages, logits of the same 4 requests after one decode
# step, relative L2: every cached K/V element is rounded to 1/254 of its
# (token, head) absmax (about 0.7% RMS of a Gaussian row), which perturbs
# every attention score and output over 28 layers; 2x the bf16 path's
# LOGITS_TOL, as an int8 cache is a coarser store than bf16 rounding
INT8_LOGITS_TOL = 1e-1
QUESTIONS = ("What is happening in this video?",
             "How many objects move from left to right?",
             "What changes between the first and the last frame?")
TRAIN_QA = (
    ("What is the person in the video doing?",
     "<think>Let me think. The person walks to the table, picks up a red cup, "
     "and lifts it. Wait, the cup is raised to the face, so they drink from "
     "it. Let me verify with the last frames: the cup goes back down on the "
     "table.</think><answer>The person drinks from a red cup.</answer>"),
    ("How many objects move from left to right?",
     "<think>Hmm, let's break it down. A ball rolls from the left edge to the "
     "right, a car crosses behind it, and a bird flies the same way near the "
     "top. Nothing else moves.</think><answer>3</answer>"),
)
# int4 serving (phases 12 and 13)
INT4_NEW_TOKENS = 64
SHORT_FRAMES = 2                  # phase 13's clip: grid (1, 28, 28), 784 patches
SHORT_PATCHES = SHORT_FRAMES // 2 * (FRAME_HW // 14) ** 2
INT4_QUESTIONS = ("What is happening in this video?",
                  "How many objects move from left to right, and which way does each go?",
                  "Why?",
                  "Describe what changes between the first and the last frame of the "
                  "clip, and when each change happens.")
COLD_BYTES = 128 * 2 ** 20        # weight copies past the 50 MB L2 cache
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "flash_attention": ("video_r2_tpu_torch/csrc/flash_attn.cu",
                        "video_r2_tpu/ops/flash.py:80"),
    "window_attention": ("video_r2_tpu_torch/csrc/vit_window_attn.cu",
                         "video_r2_tpu/ops/vit_window_attention.py:36"),
    "flash_attention_fwd_lse": ("video_r2_tpu_torch/csrc/flash_attn.cu",
                                "video_r2_tpu/ops/flash.py:99"),
    "flash_bwd_dq": ("video_r2_tpu_torch/csrc/flash_attn_bwd.cu",
                     "video_r2_tpu/ops/flash.py:116"),
    "flash_bwd_dkv": ("video_r2_tpu_torch/csrc/flash_attn_bwd.cu",
                      "video_r2_tpu/ops/flash.py:164"),
    "window_attention_bwd": ("video_r2_tpu_torch/csrc/vit_window_attn_bwd.cu",
                             "video_r2_tpu/ops/vit_window_attention.py:90"),
    "paged_decode_attention_stacked": ("video_r2_tpu_torch/csrc/paged_attn.cu",
                                       "video_r2_tpu/ops/paged_attention.py:91"),
    "paged_decode_attention_stacked_quant": ("video_r2_tpu_torch/csrc/paged_attn.cu",
                                             "video_r2_tpu/ops/paged_attention.py:166"),
    "paged_decode_attention": ("video_r2_tpu_torch/csrc/paged_attn.cu",
                               "video_r2_tpu/ops/paged_attention.py:30"),
    "moe_ffn_bf16_ragged": ("video_r2_tpu_torch/csrc/moe_ffn.cu",
                            "video_r2_tpu/ops/moe_ragged.py:43"),
    "moe_ffn_bf16_gmm": ("video_r2_tpu_torch/csrc/moe_ffn.cu",
                         "video_r2_tpu/ops/moe_ragged.py:43"),
    "moe_ffn_int8_ragged": ("video_r2_tpu_torch/csrc/moe_ffn.cu",
                            "video_r2_tpu/ops/moe_ragged.py:73"),
    "moe_ffn_int8_gmm": ("video_r2_tpu_torch/csrc/moe_ffn.cu",
                         "video_r2_tpu/ops/moe_ragged.py:73"),
    "moe_ffn_w8a8_gmm": ("video_r2_tpu_torch/csrc/moe_ffn.cu",
                         "video_r2_tpu/ops/moe_ragged.py:107"),
    "int4_matmul": ("video_r2_tpu_torch/csrc/int4_matmul.cu",
                    "video_r2_tpu/ops/int4_matmul.py:65"),
    "decode_attention": ("video_r2_tpu_torch/csrc/decode_attn.cu",
                         "video_r2_tpu/ops/decode_attention.py:42"),
    "moe_gmm_bwd_dx": ("video_r2_tpu_torch/csrc/moe_gmm_bwd.cu",
                       "video_r2_tpu/ops/moe_gmm.py:185"),
    "moe_gmm_bwd_dw": ("video_r2_tpu_torch/csrc/moe_gmm_bwd.cu",
                       "video_r2_tpu/ops/moe_gmm.py:213"),
    "moe_gmm_bwd_dwd": ("video_r2_tpu_torch/csrc/moe_gmm_bwd.cu",
                        "video_r2_tpu/ops/moe_gmm.py:258"),
    "int8_matmul": ("video_r2_tpu_torch/csrc/int8_matmul.cu",
                    "video_r2_tpu/ops/int8_matmul.py:23"),
    # the one-layer entry at 17-256 rows (the wide kernel; phase 16's bench
    # prefill head, launched by phase 17(b)'s prefill chunks)
    "int8_matmul_wide": ("video_r2_tpu_torch/csrc/int8_matmul.cu",
                         "video_r2_tpu/ops/int8_matmul.py:23"),
    "int8_matmul_stacked": ("video_r2_tpu_torch/csrc/int8_matmul.cu",
                            "video_r2_tpu/ops/int8_matmul.py:81"),
    "int8_matmul_all_layers": ("video_r2_tpu_torch/csrc/int8_matmul.cu",
                               "scripts/microbench_int8.py:32"),
    # the fp32 instances of the attention kernels (phase 18)
    "flash_attention_fp32": ("video_r2_tpu_torch/csrc/flash_attn.cu",
                             "video_r2_tpu/ops/flash.py:80"),
    "window_attention_fp32": ("video_r2_tpu_torch/csrc/vit_window_attn.cu",
                              "video_r2_tpu/ops/vit_window_attention.py:36"),
    "flash_attention_fwd_lse_fp32": ("video_r2_tpu_torch/csrc/flash_attn.cu",
                                     "video_r2_tpu/ops/flash.py:99"),
    "flash_bwd_dq_fp32": ("video_r2_tpu_torch/csrc/flash_attn_bwd.cu",
                          "video_r2_tpu/ops/flash.py:116"),
    "flash_bwd_dkv_fp32": ("video_r2_tpu_torch/csrc/flash_attn_bwd.cu",
                           "video_r2_tpu/ops/flash.py:164"),
    "window_attention_bwd_fp32": ("video_r2_tpu_torch/csrc/vit_window_attn_bwd.cu",
                                  "video_r2_tpu/ops/vit_window_attention.py:90"),
    # the fp32 instances of the decode-attention kernels at head dim 12 (phase 18)
    "paged_decode_attention_stacked_fp32": ("video_r2_tpu_torch/csrc/paged_attn.cu",
                                            "video_r2_tpu/ops/paged_attention.py:91"),
    "decode_attention_fp32": ("video_r2_tpu_torch/csrc/decode_attn.cu",
                              "video_r2_tpu/ops/decode_attention.py:42"),
}
# the judge (phases 10 and 11)
PEAK_INT8 = 1979e12               # int8 tensor-core TOP/s (H100 SXM data sheet)
MOE_DECODE_T, MOE_PREFILL_T = 16, 4096
JUDGE_REQUESTS, JUDGE_NEW_TOKENS, JUDGE_INT8_REQUESTS, JUDGE_PAGED_REQUESTS = 16, 64, 4, 8
# request 0's logits, kernel path vs plain path over 48 layers: bf16
# rounding differs at every attention output and expert FFN, and a token
# whose 8th and 9th router probabilities lie within that noise may swap an
# expert (a few percent of its MoE output); twice phase 5's bound
JUDGE_LOGITS_TOL = 1e-1
# W8A8 prefill on int8 weights vs the bf16 model, prefill logits: every
# weight and activation rounded to 1/254 of its row or channel absmax
# (about 0.7% RMS each) over 48 layers, and the rounding moves router
# probabilities enough to swap top-8 experts of some tokens
JUDGE_INT8_TOL = 2.5e-1
JUDGE_SYSTEM = (
    "You are a strict grader of video reasoning. Read the model's reasoning "
    "inside <think></think> and its final answer inside <answer></answer>. Check "
    "that the reasoning supports the answer and fits the question. Reply with one "
    "line, 'Consistent: yes' or 'Consistent: no', then one sentence of reason.")
# the tiny fp32 model (phase 18): frames at their target size (min / max
# pixels keep them), a greedy answer's length; the ByteTokenizer's special
# ids below the tiny vocab of 512
TINY_FRAMES, TINY_HW, TINY_NEW_TOKENS = 4, (112, 168), 12
TINY_SPECIALS = {"<|endoftext|>": 0, "<|im_start|>": 300, "<|im_end|>": 1,
                 "<|vision_start|>": 502, "<|vision_end|>": 503,
                 "<|image_pad|>": 500, "<|video_pad|>": 501}
# MoE training (phases 14 and 15)
GMM_BWD_T = 4096                  # phase 14's tokens (R = 32768 routed rows)
FP32_MOE_T = 512                  # the fp32 instances' GMM cases (phases 10, 14)
ABSENT_EXPERT = 77                # its router column is zero: logit 0, below
                                  # the top 8 of 128 for every token
MOE_LORA_B, MOE_LORA_S, MOE_LORA_STEPS = 2, 1024, 3
# phase 15's step 1 holds the kernel path to phase 7's PATH_GRAD_REL_L2 and,
# as a control, the same path with the dX kernel's output zeroed (the fault
# of a wrong dX kernel, or of an expert FFN that drops its graph) above it
JUDGE_ANSWER = "Consistent: yes. The reasoning follows the frames in order and supports the answer."
JUDGE_STEPS = ("The person enters from the left and walks to the table.",
               "Wait, the cup is lifted before the second person arrives.",
               "Let me check the last frames again: the cup is back on the table.",
               "So the order of events is enter, lift, drink, put down.",
               "Hmm, the timestamps say the drink happens at 00:00:12.")


# int8 serving (phases 16 and 17)
INT8_ROWS = (1, 4, 16, 64, 256, 1024)   # the row counts behind INT8_KERNEL_MAX_ROWS
INT8_NEW_TOKENS = 64
INT8_QUESTIONS = tuple(INT4_QUESTIONS[i % 4] + " Give the time of each event." * (i // 4)
                       for i in range(16))
BENCH_B, BENCH_PROMPT, BENCH_NEW, BENCH_CHUNK = 256, 256, 128, 64   # bench.py's workload
BENCH_METRIC = "decode_tokens_per_sec_chip_qwen25vl7b_int8_w8a8_kv8_b256"
MICRO_M, MICRO_K, MICRO_N, MICRO_L = 64, 3584, 18944, 28   # scripts/microbench_int8.py
# GRPO (phases 19 and 17(c)): train_grpo.sh's per-GPU share (global batch 8
# over 8 GPUs: 1 prompt, num_generations 8, beta 0.04, lr 1e-6, prompts up to
# 32768 tokens), with 128 new tokens where the recipe has 1024 (cut for time)
GRPO_G, GRPO_NEW, GRPO_LR = 8, 128, 1e-6
GRPO_MAX_PROMPT = 32768                   # the recipe's max_prompt_length
QLORA_G, QLORA_NEW = 4, 32                # phase 17(c)
GRPO_QUESTION = ("What does the person pick up first?\nA. a red cup\nB. a book\n"
                 "C. a phone\nD. a pen")
GRPO_ANSWER = ("<think>Let me think. At 00:01 the person walks to the table, then at "
               "00:03 picks up a red cup.</think><answer>A</answer>")
GRPO_GROUNDING = {"00:01": "The person walks to the table.",
                  "00:03": "The person picks up a red cup."}
GRPO_HIT = {"00:01": "The person walks to the table."}     # matches the ground truth
GRPO_MISS = {"00:40": "A bird flies over the house."}      # matches nothing
TAR = "temporal_grounding_sentence_embedding_consistency_reward"
# the eval path (phases 20 and 17(d)): apps/run_eval's defaults (batch 8, 128
# frames at most, pixels in [100352, 151200]); clips of 32-36 frames at
# 336x448 (150528 px, which smart_resize keeps, so no resize on the host) and
# 1 fps; max_new_tokens cut from the tasks' 1024 for time
EVAL_TASKS = ("mvbench_think", "videomme_think")
EVAL_DOCS, EVAL_FRAMES, EVAL_HW = 8, 32, (336, 448)
EVAL_NEW_TOKENS, EVAL_TF_TOKENS, INT8_EVAL_TOKENS = 64, 16, 32
# the attention tap (phase 20(c)): a mass in [0, 1] from the same weights,
# the flash path (bf16 kernels in 27 layers) against the plain path
TAP_KEY_CHUNK, TAP_TOL = 2048, 1e-2
# the post-hoc judge path (phase 21): scripts/serve_judge.sh's MoE stand-in
# (--paged --kv-quant int8 over int8 weights, --decode-window 8) with
# --max-len 8192 (32768 there; the longest VAS prompt over phase 20's rows
# is ~4.7k byte tokens, so none is cut) and 32 new tokens (1024 there), cut
# for time; --spec-decode and --prefill-chunk are not ported
SERVE_ARGV = ("--paged", "--kv-quant", "int8", "--decode-window", "8", "--max-len", "8192",
              "--run.model_preset", "qwen3-moe-30b-a3b", "--run.weight_quant", "int8")
SERVE_SLOTS, SERVE_NEW_TOKENS = 16, 32
PACKED_TOL = 1e-2    # relative L2 of a packed prompt's logits against its solo prefill
# speculative decoding and chunked prefill (phase 22): serve_judge.sh:46-48's
# --spec-decode 8 --prefill-chunk 2048 on phase 21's flags; K = 4 on the
# tiny config and GRPO's rollouts (grpo_runner's spec rollouts), 8 elsewhere
SPEC_K, SPEC_CHUNK, SPEC_K_SMALL, SPEC_B = 8, 2048, 4, 16
SPEC_ARGV = SERVE_ARGV + ("--spec-decode", str(SPEC_K), "--prefill-chunk", str(SPEC_CHUNK))
# the paged kernel's verify-chunk rows of the kernels line: name -> (the
# wrapper's row it extends, the case: its shape, and the run its launches
# come from, at that shape)
VERIFY_KERNELS = {
    "paged_decode_attention_stacked_quant_verify": (
        "paged_decode_attention_stacked_quant",
        "the judge, bf16 q over int8 pages, W = 9, g = 8 (72 rows); launches: 22(c)'s "
        "served run"),
    "paged_decode_attention_stacked_verify": (
        "paged_decode_attention_stacked",
        "the 7B, bf16 pages, W = 9, g = 7 (63 rows); launches: 22(d)'s verify rounds at "
        "B = 16"),
    "paged_decode_attention_stacked_verify_k4": (
        "paged_decode_attention_stacked",
        "the 7B, bf16 pages, W = 5, g = 7 (35 rows); launches: 22(d)'s GRPO cycle"),
    "paged_decode_attention_stacked_fp32_verify": (
        "paged_decode_attention_stacked",
        "the tiny config, fp32 q and pages, W = 5, g = 2, hd 12 (10 rows); launches: "
        "22(b)'s paged engine over fp32 pages"),
    "paged_decode_attention_stacked_quant_fp32_verify": (
        "paged_decode_attention_stacked_quant",
        "the tiny config, fp32 q over int8 pages, W = 5, g = 2, hd 12 (10 rows); "
        "launches: 22(b)'s paged engine over int8 pages"),
}
# the Qwen3-Next judge (phase 23): scripts/serve_judge.sh's flags for the Next
# preset (--continuous --spec-decode 8 --prefill-chunk 2048 --decode-window 8
# over int8 weights) with phase 21's --max-len 8192 (32768 there); 3 slots: a
# verify round's 3 x 9 tokens stay on the ragged FFN route (at most 32
# tokens; at 8 slots the reference's decode route is the exact einsum over
# all 512 experts); 12 of 48 layers at full width (41 GiB in bf16)
NEXT_ARGV = ("--run.model_preset", "qwen3-next-80b-a3b", "--run.weight_quant", "int8",
             "--continuous", "--spec-decode", "8", "--prefill-chunk", "2048",
             "--decode-window", "8", "--max-len", "8192")
NEXT_LAYERS, NEXT_SLOTS, NEXT_CHUNK, NEXT_SUFFIX, NEXT_DECODE_T = 12, 3, 2048, 512, 8
NEXT_BURST_TOKENS = 8
# phase 23(a)'s rows of the kernels line: name -> (the wrapper's row it
# extends, the case)
NEXT_KERNELS = {
    "flash_attention_hd256": ("flash_attention", "hd 256, B=1 S=2048, 16/2 heads, causal"),
    "flash_attention_hd256_offset": ("flash_attention",
                                     "hd 256, 512 rows at q_offset 1536 over 2048 keys"),
    "moe_ffn_bf16_ragged_next": ("moe_ffn_bf16_ragged", "E 512 top 10, H 2048 I 512, T=8"),
    "moe_ffn_bf16_gmm_next": ("moe_ffn_bf16_gmm", "E 512 top 10, H 2048 I 512, T=2048"),
    "moe_ffn_int8_ragged_next": ("moe_ffn_int8_ragged", "E 512 top 10, H 2048 I 512, T=8"),
    "moe_ffn_int8_gmm_next": ("moe_ffn_int8_gmm", "E 512 top 10, H 2048 I 512, T=2048"),
    "int8_matmul_next": ("int8_matmul", "qkvz 2048 -> 12288 at 3 rows"),
}
# Qwen3-Next training (phase 24): LoRA r 64 / alpha 64 over NEXT_LORA_TARGETS
# on phase 23(c)'s bf16 model (24(c)) and QLoRA on 23(d)'s int8 one (24(d)),
# B 2 x S 2048, lengths (2048, 1536), the first 256 labels -100; Adam at a
# constant 1e-3, 3 steps each
NEXT_TRAIN_B, NEXT_TRAIN_S, NEXT_TRAIN_LENGTHS = 2, 2048, (2048, 1536)
NEXT_TRAIN_MASKED, NEXT_TRAIN_STEPS, NEXT_TRAIN_LR = 256, 3, 1e-3
# phase 24(b): the small fp32 config's LoRA step on the card vs the CPU (the
# same fp32 products in other orders; the card's flash and grouped FFN
# instances against the CPU's dense attention and plain FFN)
NEXT_SMALL_TRAIN_TOL = 1e-4
# phase 24(a)'s rows of the kernels line: name -> (the wrapper's row it
# extends, the case); launches: phase 24(c) and (d)'s steps
NEXT_TRAIN_KERNELS = {
    "flash_attention_fwd_lse_hd256": (
        "flash_attention_fwd_lse", "hd 256, B=2 S=2048, 16/2 heads, causal, lengths "
        "(2048, 1536)"),
    "flash_bwd_dq_hd256": ("flash_bwd_dq", "hd 256, B=2 S=2048, 16/2 heads, causal, lengths "
                                           "(2048, 1536)"),
    "flash_bwd_dkv_hd256": ("flash_bwd_dkv", "hd 256, B=2 S=2048, 16/2 heads, causal, lengths "
                                             "(2048, 1536); two launches a call, dV then dK"),
    "moe_gmm_bwd_dx_next": ("moe_gmm_bwd_dx", "E 512 top 10, H 2048 I 512, T=4096 (40960 "
                                              "routed rows)"),
}
READY_MESSAGES = [{"role": "system", "content": "You are a precise assistant."},
                  {"role": "user", "content": "Reply with exactly the word READY."}]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def counters() -> dict:
    """{kernel name: the wrapper whose .launches counts it}."""
    from video_r2_tpu_torch.ops import (
        decode_attention,
        flash,
        int4_matmul,
        int8_matmul,
        moe_gmm,
    )
    from video_r2_tpu_torch.ops import paged_attention as paged
    from video_r2_tpu_torch.ops import vit_window_attention as win

    return {"flash_attention": flash.flash_attention,
            "window_attention": win.window_attention,
            "flash_attention_fwd_lse": flash.flash_attention_fwd_lse,
            "flash_bwd_dq": flash.flash_bwd_dq_cuda,
            "flash_bwd_dkv": flash.flash_bwd_dkv_cuda,
            "window_attention_bwd": win.window_attention_bwd,
            "paged_decode_attention_stacked": paged.paged_decode_attention_stacked,
            "paged_decode_attention_stacked_quant":
                paged.paged_decode_attention_stacked_quant,
            "paged_decode_attention": paged.paged_decode_attention,
            "int4_matmul": int4_matmul.int4_matmul,
            "decode_attention": decode_attention.decode_attention_stacked,
            "moe_gmm_bwd_dx": moe_gmm.gmm_bwd_dx,
            "moe_gmm_bwd_dw": moe_gmm.gmm_bwd_dw,
            "moe_gmm_bwd_dwd": moe_gmm.gmm_bwd_dwd,
            "int8_matmul": int8_matmul.int8_matmul,
            "int8_matmul_stacked": int8_matmul.int8_matmul_stacked,
            "int8_matmul_all_layers": int8_matmul.int8_matmul_all_layers}


def ffn_launches() -> dict:
    """The grouped FFN wrapper's launch counts, {variant: n} (one dict,
    zeroed in place, so a recording stand-in can share it)."""
    from video_r2_tpu_torch.ops import moe_ragged

    return moe_ragged.ragged_expert_ffn.launches


def ffn_paths() -> dict:
    """The grouped FFN wrapper's launch counts per (variant, path of
    csrc/moe_ffn.cu): 0 mma.sync, 1 wgmma, 2 the decode kernel, 3 fp32."""
    from video_r2_tpu_torch.ops import moe_ragged

    return moe_ragged.ragged_expert_ffn.paths


def int8_wide_counters() -> dict:
    """{count name: the int8 wrapper whose .wide_launches counts its launches
    of the wide kernel} (none for a port without it)."""
    from video_r2_tpu_torch.ops import int8_matmul as m

    return {f"{name}_wide": fn for name, fn in (
        ("int8_matmul", m.int8_matmul), ("int8_matmul_stacked", m.int8_matmul_stacked),
        ("int8_matmul_all_layers", m.int8_matmul_all_layers)) if hasattr(fn, "wide_launches")}


def reset_launches() -> None:
    from video_r2_tpu_torch.ops.int8_matmul import int8_matmul

    for fn in counters().values():
        fn.launches = 0
    int8_matmul.decode_launches = 0
    for fn in int8_wide_counters().values():
        fn.wide_launches = 0
    for variant in ffn_launches():
        ffn_launches()[variant] = 0
    ffn_paths().clear()


def read_launches() -> dict:
    """Every wrapper's count; the grouped FFN's per variant, as
    moe_ffn_<variant>, and per variant and path, as moe_ffn_<variant>_path<p>;
    the int8 matmul's launches of its decode kernel as int8_matmul_decode (of
    int8_matmul's), and each int8 wrapper's of the wide kernel as
    <name>_wide."""
    from video_r2_tpu_torch.ops.int8_matmul import int8_matmul

    out = {name: fn.launches for name, fn in counters().items()}
    out.update({f"moe_ffn_{v}": n for v, n in ffn_launches().items()})
    out.update({f"moe_ffn_{v}_path{p}": n for (v, p), n in ffn_paths().items()})
    out["int8_matmul_decode"] = int8_matmul.decode_launches
    out.update({name: fn.wide_launches for name, fn in int8_wide_counters().items()})
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph (after
    warm-up calls on the capture stream), the graph's replays timed with
    CUDA events. Unlike cuda_ms it leaves out the host's time per call,
    which sets an eager loop of launches shorter than it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (5 * iters)


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> dict:
    t_ops, t_mem = flops / peak, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def compare(out, ref, rows=None, tol=KERNEL_ATOL) -> tuple[float, float]:
    """(max |out - ref|, max of |out - ref| / (tol + tol |ref|)) on `rows`
    (tol: KERNEL_ATOL = KERNEL_RTOL, or FP32_TOL for fp32 operands)."""
    out, ref = out.float(), ref.float()
    if rows is not None:
        out, ref = out[rows], ref[rows]
    d = (out - ref).abs()
    return float(d.max()), float((d / (tol + tol * ref.abs())).max())


def rel_l2(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).norm() / ref.norm().clamp(min=1e-30))


def admitted(lengths, Sq, Sk, causal, seg):
    """[B, Sq, Sk] bool: the keys each query row admits (q_offset 0)."""
    import torch

    key = torch.arange(Sk, device=lengths.device)
    ok = (key[None, None, :] < lengths[:, None, None]).expand(len(lengths), Sq, Sk)
    if causal:
        ok = ok & (key[None, :] <= torch.arange(Sq, device=key.device)[:, None])[None]
    if seg is not None:
        ok = ok & (seg[:, :, None] == seg[:, None, :])
    return ok


def library_calls(q, k, v, mask, dout):
    """Forward and backward of F.scaled_dot_product_attention (GQA, boolean
    mask [B, 1, Sq, Sk]) on head-major copies of q / k / v: one call each
    (the backward is one autograd call over the kept forward graph)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    dt = dout.transpose(1, 2).contiguous()
    bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dt, retain_graph=True)  # noqa: E731
    return cuda_ms(fwd), cuda_ms(bwd, iters=10)


def library_device_ms(q, k, v, mask, dout) -> tuple[float, float]:
    """Device times (graph_ms) of F.scaled_dot_product_attention as
    library_calls calls it: (the forward, the forward and its backward in
    one capture; the backward's own time is their difference)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dt = dout.transpose(1, 2).contiguous()

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dt)
    return graph_ms(fwd), graph_ms(fwd_bwd, iters=10)


def report(name: str, what: str, shape, **r) -> None:
    extra = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in r.items())
    print(f"kernel {name} [{what}] shape={shape}: {extra}", flush=True)


def flash_case(gen, what, q, k, v, lengths, causal, seg, training: bool) -> dict:
    """The flash kernels at one shape against their plain versions. Serving:
    the forward. Training: the forward with LSE, then dq and dk/dv from the
    plain forward's (out, lse) and one dout, so each kernel is held alone."""
    import torch

    from video_r2_tpu_torch.ops.flash import (
        attention_delta,
        flash_attention,
        flash_attention_bwd_plain,
        flash_attention_fwd_lse,
        flash_attention_fwd_lse_plain,
        flash_attention_plain,
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_layout,
        flash_fwd_layout,
    )

    B, Sq, nh, hd = q.shape
    Sk, kh = k.shape[1], k.shape[2]
    fp32 = q.dtype == torch.float32              # the fp32 instances: FP32_TOL everywhere
    tol, peak = (FP32_TOL, PEAK_FP32) if fp32 else (KERNEL_ATOL, PEAK_BF16)
    es = q.element_size()
    ok = admitted(lengths, Sq, Sk, causal, seg)
    pairs = float(ok.sum()) * nh                 # admitted (row, key) pairs, all heads
    q_bytes = es * q.numel()
    kv_bytes = es * 2.0 * float(lengths.clamp(max=Sk).sum()) * kh * hd   # k, v rows read
    row_bytes = 4.0 * B * nh * Sq                # one fp32 per row (lse or delta)
    rows = None if seg is None else seg == 1     # pad rows are never read downstream
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    lib_fwd_ms, lib_bwd_ms = library_calls(q, k, v, ok[:, None], dout)
    shape = (B, Sq, Sk, nh, kh, hd)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if fp32:
        blocks = -(-Sq // 64) * nh * B
        print(f"flash forward [{what}]: fp32 instance, {blocks} blocks of 256 threads over "
              f"64 rows, {blocks / sms:.2f} per SM, on {sms} SMs", flush=True)
    else:
        block_rows, wgs, resident = flash_fwd_layout(hd)
        blocks = -(-Sq // block_rows) * nh * B
        print(f"flash forward [{what}]: {blocks} blocks of {wgs} warpgroups over "
              f"{block_rows} rows, {blocks / sms:.2f} per SM, {resident} resident, on "
              f"{sms} SMs", flush=True)
    if not training:
        run = lambda: flash_attention(q, k, v, kv_lengths=lengths, causal=causal,  # noqa: E731
                                      segment_ids=seg)
        plain = lambda: flash_attention_plain(q, k, v, lengths, causal, 0, seg)  # noqa: E731
        err, excess = compare(run(), plain(), rows, tol)
        r = {"max_abs_err": err, "excess": excess, "ms": cuda_ms(run),
             "plain_ms": cuda_ms(plain), "library_ms": lib_fwd_ms,
             **bound(4 * hd * pairs, 2 * q_bytes + kv_bytes, peak)}
        report("flash_attention", what, shape, **r)
        if not excess <= 1.0:
            raise AssertionError(f"flash_attention [{what}] disagrees with its plain "
                                 f"version: {excess} x the tolerance")
        return {"flash_attention": r}

    args = (q, k, v, lengths, causal, 0, seg)
    run = lambda: flash_attention_fwd_lse(*args)  # noqa: E731
    plain = lambda: flash_attention_fwd_lse_plain(*args)  # noqa: E731
    (out, lse), (ref_out, ref_lse) = run(), plain()
    err, excess = compare(out, ref_out, rows, tol)
    has_key = ok.any(-1)[:, None, :].expand(B, nh, Sq)
    lse_err = float((lse - ref_lse)[has_key].abs().max())
    # fp32: the LSE within FP32_TOL elementwise, as the output; bf16: LSE_ATOL
    lse_ok = compare(lse, ref_lse, None, tol)[1] <= 1.0 if fp32 else lse_err <= LSE_ATOL
    fwd = {"max_abs_err": err, "excess": excess, "lse_max_abs_err": lse_err,
           "ms": cuda_ms(run), "plain_ms": cuda_ms(plain), "library_ms": lib_fwd_ms,
           **bound(4 * hd * pairs, 2 * q_bytes + kv_bytes + row_bytes, peak)}
    report("flash_attention_fwd_lse", what, shape, **fwd)
    if not (excess <= 1.0 and lse_ok):
        raise AssertionError(f"flash_attention_fwd_lse [{what}] disagrees with its "
                             f"plain version: out {excess} x the tolerance, lse {lse_err}")

    delta = attention_delta(ref_out, dout)
    bargs = (q, k, v, dout, ref_lse, delta, lengths, causal, 0, seg)
    dq, (dk, dv) = flash_bwd_dq_cuda(*bargs), flash_bwd_dkv_cuda(*bargs)
    plain_bwd = lambda: flash_attention_bwd_plain(q, k, v, ref_out, dout, ref_lse,  # noqa: E731
                                                  lengths, causal, 0, seg)
    ref = plain_bwd()
    rels = [rel_l2(a, b) for a, b in zip((dq, dk, dv), ref)]
    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip((dq, dk, dv), ref)]
    excess = [compare(a, b, None, tol)[1] for a, b in zip((dq, dk, dv), ref)]
    plain_ms = cuda_ms(plain_bwd, iters=5)      # one plain version computes all three
    dq_r = {"max_abs_err": errs[0], "rel_l2": rels[0],
            "ms": cuda_ms(lambda: flash_bwd_dq_cuda(*bargs)), "plain_ms": plain_ms,
            "library_ms": lib_bwd_ms,
            **bound(6 * hd * pairs, 3 * q_bytes + kv_bytes + 2 * row_bytes, peak)}
    dkv_r = {"max_abs_err": max(errs[1:]), "rel_l2": max(rels[1:]),
             "ms": cuda_ms(lambda: flash_bwd_dkv_cuda(*bargs)), "plain_ms": plain_ms,
             "library_ms": lib_bwd_ms,
             **bound(8 * hd * pairs, 2 * q_bytes + kv_bytes + 2 * row_bytes
                     + es * 2.0 * B * Sk * kh * hd, peak)}
    if fp32:
        dq_r["excess"], dkv_r["excess"] = excess[0], max(excess[1:])
    report("flash_bwd_dq", what, shape, **dq_r)
    report("flash_bwd_dkv", what, shape, dk_rel_l2=rels[1], dv_rel_l2=rels[2], **dkv_r)
    pair = dq_r["ms"] + dkv_r["ms"]
    fill = []
    for name, S, dkv in (("dq", Sq, False), ("dk/dv", Sk, True)):
        if fp32:
            blocks = -(-S // 64) * (kh if dkv else nh) * B
            fill.append(f"{name} {blocks} blocks of 256 threads (fp32 instance)")
            continue
        rows, wgs, resident = flash_bwd_layout(hd, dkv)
        blocks = -(-S // rows) * nh * B
        fill.append(f"{name} {blocks} blocks of {wgs} warpgroups, {blocks / sms:.2f} per "
                    f"SM, {resident} resident")
    print(f"flash backward pair [{what}]: dq {dq_r['ms']:.4f} + dk/dv {dkv_r['ms']:.4f} = "
          f"{pair:.4f} ms, SDPA backward {lib_bwd_ms:.4f} ms ({pair / lib_bwd_ms:.2f}x), "
          f"bound {dq_r['bound_ms'] + dkv_r['bound_ms']:.4f} ms; {'; '.join(fill)} on "
          f"{sms} SMs", flush=True)
    if not (max(excess) <= 1.0 if fp32 else max(rels) <= GRAD_REL_L2):
        raise AssertionError(f"flash backward [{what}] disagrees with its plain "
                             f"version: relative L2 dq/dk/dv {rels}, {excess} x the "
                             f"tolerance")
    return {"flash_attention_fwd_lse": fwd, "flash_bwd_dq": dq_r, "flash_bwd_dkv": dkv_r}


def window_case(gen, what, valid, nh, hd, training: bool, dtype=None) -> dict:
    """The window kernel (serving) or its backward (training) at one shape,
    on strided q / k / v views of one qkv, as in the tower (bf16, or fp32:
    the fp32 instances, held to FP32_TOL elementwise). Kernel and library
    call are timed eagerly (ms, library_ms) and in a CUDA graph (device_ms,
    library_device_ms: for the backward, SDPA's forward + backward less its
    forward)."""
    import torch

    from video_r2_tpu_torch.ops.vit_window_attention import (
        WINDOW,
        window_attention,
        window_attention_bwd,
        window_attention_bwd_plain,
        window_attention_plain,
    )

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    tol, peak = (FP32_TOL, PEAK_FP32) if fp32 else (KERNEL_ATOL, PEAK_BF16)
    S = valid.shape[0]
    nw = S // WINDOW
    qkv = torch.randn(S, 3, nh, hd, generator=gen, device=valid.device).to(dtype)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    dout = torch.randn(S, nh, hd, generator=gen, device=valid.device).to(dtype)
    pairs = float(WINDOW * valid.sum()) * nh     # each row attends its window's valid keys
    io_bytes = float(qkv.element_size()) * S * nh * hd   # one [S, nh, hd] tensor
    # the library call: windows as a batch, keys masked by `valid`
    win = lambda x: x.reshape(nw, WINDOW, nh, hd)  # noqa: E731
    mask = valid.reshape(nw, 1, 1, WINDOW).expand(nw, 1, WINDOW, WINDOW)
    lib_fwd_ms, lib_bwd_ms = library_calls(win(q), win(k), win(v), mask, win(dout))
    lib_fwd_dev, lib_fwd_bwd_dev = library_device_ms(win(q), win(k), win(v), mask, win(dout))
    if not training:
        run = lambda: window_attention(q, k, v, valid)  # noqa: E731
        plain = lambda: window_attention_plain(q, k, v, valid)  # noqa: E731
        err, excess = compare(run(), plain(), valid, tol)
        r = {"max_abs_err": err, "excess": excess, "ms": cuda_ms(run),
             "device_ms": graph_ms(run), "plain_ms": cuda_ms(plain),
             "library_ms": lib_fwd_ms, "library_device_ms": lib_fwd_dev,
             **bound(4 * hd * pairs, 4 * io_bytes + S, peak)}
        report("window_attention", what, (S, nh, hd), **r)
        if not excess <= 1.0:
            raise AssertionError(f"window_attention [{what}] disagrees with its plain "
                                 f"version: {excess} x the tolerance")
        return {"window_attention": r}
    run = lambda: window_attention_bwd(q, k, v, valid, dout)  # noqa: E731
    plain = lambda: window_attention_bwd_plain(q, k, v, valid, dout)  # noqa: E731
    grads, ref = run(), plain()
    rels = [rel_l2(a, b) for a, b in zip(grads, ref)]
    excess = max(compare(a, b, None, tol)[1] for a, b in zip(grads, ref))
    r = {"max_abs_err": max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(grads, ref)),
         "rel_l2": max(rels), "ms": cuda_ms(run), "device_ms": graph_ms(run),
         "plain_ms": cuda_ms(plain, iters=5), "library_ms": lib_bwd_ms,
         "library_device_ms": lib_fwd_bwd_dev - lib_fwd_dev,
         "library_fwd_bwd_device_ms": lib_fwd_bwd_dev,
         **bound(12 * hd * pairs, 7 * io_bytes + S, peak)}
    if fp32:
        r["excess"] = excess
    report("window_attention_bwd", what, (S, nh, hd), **r)
    print(f"window backward [{what}]: {window_bwd_grid(nh * nw, hd, fp32)}; device "
          f"{r['device_ms']:.4f} ms", flush=True)
    if not (excess <= 1.0 if fp32 else max(rels) <= GRAD_REL_L2):
        raise AssertionError(f"window_attention_bwd [{what}] disagrees with its plain "
                             f"version: relative L2 dq/dk/dv {rels}, {excess} x the "
                             f"tolerance")
    return {"window_attention_bwd": r}


def window_bwd_grid(items: int, hd: int, fp32: bool) -> str:
    """The window backward's launch: the bf16 kernel's persistent grid
    (blocks, resident blocks an SM, (head, window) items a block) and the
    ptxas line of its instance; the fp32 instance's block a (head, window)."""
    from video_r2_tpu_torch.ops import vit_window_attention as win

    if fp32:
        return f"fp32 instance, {items} blocks of 256 threads, one (head, window) each"
    if not hasattr(win, "window_bwd_layout"):    # a checkout before the persistent grid
        return f"{items} blocks of 128 threads, one (head, window) each"
    threads, resident, sms = win.window_bwd_layout(hd)
    blocks = min(items, resident * sms)
    kernel = f"window_attn_bwd_kernel<{hd}>"
    return (f"{blocks} blocks of {threads} threads ({resident} resident an SM on {sms} "
            f"SMs), {items / blocks:.2f} (head, window) items a block; {kernel}: "
            f"{REGISTERS.get(kernel, 'registers not reported')}")


def vit_full_inputs(gen, layout, nh, hd, device, dtype=None):
    """q / k / v [G, L, nh, hd] (bf16, or dtype) and segment ids of the
    layout's full-attention groups (valid slots 1, pad slots -2), as the
    tower gathers them."""
    import torch

    fg = torch.as_tensor(layout.full_gather, device=device).long()
    valid = torch.as_tensor(layout.valid, device=device)
    seg = torch.where((fg >= 0) & valid[fg.clamp(min=0)], 1, -2).int()
    G, L = fg.shape
    q, k, v = (torch.randn(G, L, nh, hd, generator=gen, device=device).to(
        dtype or torch.bfloat16) for _ in range(3))
    return q, k, v, torch.full((G,), L, dtype=torch.int32, device=device), seg


REGISTERS: dict[str, str] = {}    # kernel<template args> -> its ptxas line (main)


def template_args(mangled: str) -> list[str]:
    """The template arguments of an Itanium-mangled name, from just after its
    'I': integers and bools (L<type><value>E), named types (<length><name>)
    and the builtin types the kernels use (a: int8, f: float)."""
    out, i = [], 0
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] == "L":
            j = mangled.index("E", i)
            out.append(mangled[i + 2:j])
            i = j + 1
        elif mangled[i].isdigit():
            n = re.match(r"\d+", mangled[i:]).group()
            start = i + len(n)
            out.append(mangled[start:start + int(n)])
            i = start + int(n)
        else:
            out.append({"a": "int8", "f": "float"}.get(mangled[i], mangled[i]))
            i += 1
    return out


def register_report(log: Path) -> list[str]:
    """One line per compiled kernel: registers and spill bytes (ptxas -v);
    and every warning of ptxas that it serialised a kernel's wgmma."""
    out, name = [], None
    spill = ""
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?\d+(flash_fwd_kernel|"
                      r"flash_bwd_dq_kernel|flash_bwd_dkv_kernel|window_attn_kernel|"
                      r"window_attn_bwd_kernel|moe_gate_up_kernel|moe_down_kernel|"
                      r"moe_gate_up_wgmma_kernel|moe_down_wgmma_kernel|moe_decode_kernel|"
                      r"moe_int8_wgmma_kernel|"
                      r"gmm_bwd_terms_kernel|gmm_bwd_dx_kernel|gmm_bwd_dw_wgmma_kernel|"
                      r"int4_matmul_kernel|int4_decode_kernel|int8_decode_kernel|"
                      r"int4_matmul_f32_kernel|int8_matmul_kernel|tc_kernel|f32_kernel)"
                      r"I(\w+)'", line)
        if m:
            name, spill = f"{m.group(1)}<{','.join(template_args(m.group(2)))}>", ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "wgmma" in line and "serialized" in line:   # ptxas's C75xx warnings
            out.append(line.strip())
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
            REGISTERS[name] = f"{regs} registers, {spill}"
            name = None
    return out


def split_line(B: int, kh: int, tiles: int, sms: int, kernel: str) -> str:
    """A decode-attention launch: its split plan (S, grid blocks, blocks an
    SM) and the ptxas line of the instance it runs (`kernel`: its name and
    template arguments but the last, e.g. "tc_kernel<128,1,__nv_bfloat16,1")."""
    from video_r2_tpu_torch.ops.split import decode_split_plan

    S, ranges = decode_split_plan(B * kh, tiles, sms)
    kernel = f"{kernel},{int(S > 1)}>"
    runs = sorted({end - begin for begin, end in ranges})
    return (f"split S={S} ({'/'.join(map(str, runs))} tiles of 64 keys each), "
            f"{B * kh * S} blocks, {B * kh * S / sms:.2f} an SM on {sms} SMs; "
            f"{kernel}: {REGISTERS.get(kernel, 'registers not reported')}")


def paged_split_lines(cfg, B: int, max_pages: int, sms: int) -> None:
    """Phase 8's launches: the split plan and ptxas line of each case's
    instance (bf16 pages W = 1 and 4, int8 pages, fp32)."""
    tc = cfg.text
    kh, hd, g = tc.num_key_value_heads, tc.head_dim, \
        tc.num_attention_heads // tc.num_key_value_heads
    tiles = max_pages * PAGE_SIZE // 64
    row_tiles = {R: 1 if R <= 16 else 2 if R <= 32 else 4 for R in (g, 4 * g)}
    for what, instance in (
            ("bf16 pages, W=1", f"tc_kernel<{hd},{row_tiles[g]},__nv_bfloat16,1"),
            ("bf16 pages, W=4", f"tc_kernel<{hd},{row_tiles[4 * g]},__nv_bfloat16,1"),
            ("int8 pages, W=1", f"tc_kernel<{hd},{row_tiles[g]},int8,1"),
            ("fp32 q and pages", f"f32_kernel<{hd},64,float,1")):
        print(f"paged launch [{what}] {split_line(B, kh, tiles, sms, instance)}", flush=True)


def training_records() -> list[dict]:
    """The training slice's records: 16 synthetic frames at 392x392 each, a
    question with the think post-prompt, a think-style answer."""
    import numpy as np

    from video_r2_tpu_torch.apps.demo import THINK_POST_PROMPT

    return [{"video": np.random.default_rng(100 + i).integers(
                 0, 256, (TRAIN_FRAMES, FRAME_HW, FRAME_HW, 3), np.uint8),
             "conversations": [
                 {"from": "human", "value": f"<video>\n{q}{THINK_POST_PROMPT}"},
                 {"from": "gpt", "value": a}]}
            for i, (q, a) in enumerate(TRAIN_QA)]


def training_phase(model, cfg, card, device, kernel_results):
    """Phases 6 and 7. Returns the launch counts of the training run."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.apps.train_sft import train
    from video_r2_tpu_torch.config import AppConfig, RunConfig
    from video_r2_tpu_torch.data.config import DataConfig
    from video_r2_tpu_torch.data.sft import SFTCollator, SFTDataset
    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.train.lora import (
        LoRAConfig,
        attach_lora,
        detach_lora,
        init_lora,
        lora_param_count,
    )
    from video_r2_tpu_torch.train.sft import SFTConfig, sft_loss

    records = training_records()
    dcfg = DataConfig()
    dataset = SFTDataset(records, ByteTokenizer(), cfg, dcfg)
    examples = [dataset[i] for i in range(len(records))]
    batch = SFTCollator(cfg, dcfg)(examples)
    layout = batch.video_layout
    tensors = {k: torch.as_tensor(v, device=device) for k, v in batch.arrays.items()}
    lengths = tensors["attention_mask"].sum(-1).int()
    B, S = batch.arrays["input_ids"].shape
    print(f"training batch: B={B}, padded width {S}, lengths {lengths.tolist()}, "
          f"video grids {[e.video_grid_thw for e in examples]}, "
          f"ViT slots {layout.s_pad}, full-attention groups "
          f"{tuple(layout.full_gather.shape)}", flush=True)

    # phase 6: the training kernels at the batch's shapes
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    tc, vc = cfg.text, cfg.vision
    randn = lambda *s: torch.randn(*s, generator=gen, device=device).to(torch.bfloat16)  # noqa: E731
    q, k, v = randn(B, S, tc.num_attention_heads, tc.head_dim), *(
        randn(B, S, tc.num_key_value_heads, tc.head_dim) for _ in range(2))
    kernel_results.update(flash_case(gen, "decoder training", q, k, v, lengths, True,
                                     None, training=True))
    q, k, v, full_len, seg = vit_full_inputs(gen, layout, vc.num_heads, vc.head_dim, device)
    flash_case(gen, "vit full training", q, k, v, full_len, False, seg, training=True)
    valid = torch.as_tensor(layout.valid, device=device)
    kernel_results.update(window_case(gen, "vit windows training", valid, vc.num_heads,
                                      vc.head_dim, training=True))
    del q, k, v

    # phase 7a: step-1 loss and adapter gradients, kernel path vs plain path
    def path_check(lcfg, what):
        params = attach_lora(model, init_lora(model, lcfg, seed=SEED), lcfg)
        out = {}
        for impl, vit_impl in (("flash", "kernel"), ("xla", "xla")):
            for p in params.values():
                p.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = sft_loss(model, tensors, SFTConfig(attn_impl=impl, vit_attn_impl=vit_impl),
                            layout)
            loss.backward()
            grads = torch.cat([p.grad.flatten() for p in params.values()])
            torch.cuda.synchronize()
            out[impl] = (loss.item(), grads, time.perf_counter() - t0)
        detach_lora(model)
        (lk, gk, tk), (lp, gp, tp) = out["flash"], out["xla"]
        loss_rel, grad_rel = abs(lk - lp) / abs(lp), rel_l2(gk, gp)
        print(f"step 1 [{what}], {lora_param_count(params) / 1e6:.1f} M adapter params: "
              f"loss kernel {lk:.6f} plain {lp:.6f} (rel {loss_rel:.3e}, tol "
              f"{PATH_LOSS_RTOL}); adapter gradients rel L2 {grad_rel:.3e} (tol "
              f"{PATH_GRAD_REL_L2}), |g| {float(gp.norm()):.4e}; fwd+bwd s kernel "
              f"{tk:.3f} plain {tp:.3f}", flush=True)
        if not (np.isfinite(lk) and loss_rel <= PATH_LOSS_RTOL
                and grad_rel <= PATH_GRAD_REL_L2):
            raise AssertionError(f"[{what}] kernel path disagrees with the plain path: "
                                 f"loss rel {loss_rel}, gradient rel L2 {grad_rel}")

    frozen_cfg = LoRAConfig()                    # r=64, alpha=64, tower frozen
    tower_cfg = LoRAConfig(include_vision=True, include_merger=True)
    path_check(frozen_cfg, "tower frozen")
    path_check(tower_cfg, "adapters in the tower")

    # phase 7b: the main path, counted: apps/train_sft.train
    run_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(run_dir, ignore_errors=True)

    def app_for(lcfg, steps, name):
        return AppConfig(run=RunConfig(output_dir=str(run_dir / name), max_steps=steps,
                                       save_steps=10 ** 6, log_steps=1, use_lora=True,
                                       seed=SEED, resume=False),
                         data=dcfg, lora=lcfg)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    _, history = train(app_for(frozen_cfg, TRAIN_STEPS, "lora"), model, dataset, B)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mid = read_launches()
    _, tower_history = train(app_for(tower_cfg, 1, "tower"), model, dataset, B)
    launches = read_launches()
    detach_lora(model)
    shutil.rmtree(run_dir, ignore_errors=True)
    for h in history + tower_history:
        print(f"train step {h['step']}: loss {h['loss']:.6f} grad_norm "
              f"{h['grad_norm']:.6e} s/step {h['s_per_step']:.4f} tokens/s "
              f"{h['tokens'] / h['s_per_step']:.1f} ({h['tokens']} tokens)", flush=True)
    tower = {n: launches[n] - mid[n] for n in launches}
    print(f"LoRA SFT: {TRAIN_STEPS} steps, tower frozen, peak device memory "
          f"{peak:.2f} GiB; launches {mid}; the tower step launched {tower} | {card}",
          flush=True)
    for h in history + tower_history:
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
            raise AssertionError(f"non-finite training step: {h}")
    for name in ("flash_attention", "window_attention", "flash_attention_fwd_lse",
                 "flash_bwd_dq", "flash_bwd_dkv", "window_attention_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"the training path launched no {name} kernel")
    if tower["window_attention_bwd"] <= 0 or tower["flash_bwd_dq"] <= tc.num_hidden_layers:
        raise AssertionError(f"the tower step ran no ViT backward kernel: {tower}")
    return launches


def paged_case(gen, what, cfg, lengths, W, pages="bf16", one_layer=False) -> dict:
    """The paged decode kernel at one shape against its plain version, with
    the library call (SDPA over K/V already gathered dense). The pool has
    the model's layers (28 on the 7B, 48 on the judge); each timed launch
    reads the next layer, so its
    pages come from device memory, as in the decode step, where each
    layer's weights pass through the L2 cache between two calls. pages:
    "bf16" (bf16 q), "int8" (bf16 q over int8 pages), "fp32" (fp32 q and
    pages) or "int8_fp32q" (fp32 q over int8 pages: the fp32 model's int8
    KV). Kernel and library call are timed eagerly (ms, library_ms: at
    these sizes the wrapper's host time sets the eager time) and in a CUDA
    graph (device_ms, library_device_ms)."""
    import torch
    import torch.nn.functional as F

    from video_r2_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_stacked,
        paged_decode_attention_stacked_plain,
    )

    tc = cfg.text
    kh, nh, hd, ps, n_layers = (tc.num_key_value_heads, tc.num_attention_heads,
                                tc.head_dim, PAGE_SIZE, tc.num_hidden_layers)
    dev = gen.device
    quant, fp32 = pages.startswith("int8"), pages in ("fp32", "int8_fp32q")
    B = len(lengths)
    need = [-(-(L + W - 1) // ps) for L in lengths]
    max_pages, n_pages = max(need), 1 + sum(need)       # page 0: the trash page
    perm = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).int()
    tables = torch.zeros(B, max_pages, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[used:used + n]
        used += n
    shape = (n_layers, kh, n_pages, ps, hd)
    dtype = torch.float32 if fp32 else torch.bfloat16
    if quant:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 1e-3
                  for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2))
        ks = vs = None
    qshape = (B, W, nh, hd) if W > 1 else (B, nh, hd)
    q = torch.randn(qshape, generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    layer = [0]

    def call(fn):
        def go():
            layer[0] = (layer[0] + 1) % n_layers
            return fn(layer[0])
        return go

    if one_layer:
        kernel = lambda l: paged_decode_attention(q, k[l], v[l], tables, lens, ps)  # noqa: E731
    else:
        kernel = lambda l: paged_decode_attention_stacked(  # noqa: E731
            q, k, v, tables, lens, l, ps, ks, vs)
    plain = lambda l: paged_decode_attention_stacked_plain(  # noqa: E731
        q, k, v, tables, lens, l, ps, ks, vs)
    err, excess = compare(kernel(n_layers - 1), plain(n_layers - 1),
                          tol=FP32_TOL if fp32 else KERNEL_ATOL)

    # the library: the same attention over K/V gathered dense per layer
    # ([L, B, kh, keys, hd], dequantised for int8) and a boolean mask
    n_keys = max_pages * ps

    def dense(pool, scale):
        x = pool[:, :, tables.long()]                      # [L, kh, B, P, ps, hd]
        if scale is not None:
            x = x.float() * scale[:, :, tables.long()][..., None]
        return x.to(dtype).transpose(1, 2).reshape(n_layers, B, kh, n_keys, hd)

    kd, vd = dense(k, ks), dense(v, vs)
    qd = (q if W > 1 else q[:, None]).transpose(1, 2)      # [B, nh, W, hd]
    limit = lens[:, None].long() + torch.arange(W, device=dev)
    mask = (torch.arange(n_keys, device=dev) < limit[:, :, None])[:, None]
    library = lambda l: F.scaled_dot_product_attention(  # noqa: E731
        qd, kd[l], vd[l], attn_mask=mask, enable_gqa=True)
    with torch.no_grad():
        lib_ms, lib_device_ms = cuda_ms(call(library)), graph_ms(call(library))
    del kd, vd

    rows = sum(L + W - 1 for L in lengths)              # key rows the last query reads
    elt = 1 if quant else k.element_size()
    nbytes = (2.0 * q.element_size() * q.numel() + 2.0 * rows * kh * hd * elt
              + (2 * 4.0 * rows * kh if quant else 0) + 4.0 * (tables.numel() + B))
    pairs = sum(W * L + W * (W - 1) // 2 for L in lengths)   # admitted (query, key)
    r = {"max_abs_err": err, "excess": excess, "ms": cuda_ms(call(kernel)),
         "device_ms": graph_ms(call(kernel)),
         "plain_ms": cuda_ms(call(plain), iters=5), "library_ms": lib_ms,
         "library_device_ms": lib_device_ms,
         **bound(4.0 * nh * hd * pairs, nbytes, PEAK_FP32 if fp32 else PEAK_BF16)}
    name = ("paged_decode_attention" if one_layer else
            "paged_decode_attention_stacked_quant" if quant
            else "paged_decode_attention_stacked")
    report(name, what, (B, W, nh, kh, hd, ps, max_pages), pages=pages, **r)
    if not excess <= 1.0:
        raise AssertionError(f"{name} [{what}] disagrees with its plain version: "
                             f"{excess} x the tolerance")
    return {name: r}


def serve_requests(runner, cfg):
    """The batched slice's 12 requests: (DemoRequest, prompt ids, budget)."""
    import numpy as np

    from video_r2_tpu_torch.video.api import video_features

    out = []
    for i in range(SERVE_REQUESTS):
        feats = video_features(np.random.default_rng(200 + i).integers(
            0, 256, (N_FRAMES, FRAME_HW, FRAME_HW, 3), np.uint8),
            FRAME_HW, FRAME_HW, sample_fps=2.0)
        q = f"{QUESTIONS[i % len(QUESTIONS)]} Answer for clip {i} in {4 + i} words."
        req = runner.prepare(feats, q)
        out.append((req, [int(t) for t in req.input_ids[0, :int(req.lengths[0])]],
                    SERVE_BUDGETS[i], feats))
    return out


def submit_item(runner, entry) -> tuple:
    """One submit_batch item, with its ViT embeds computed now (as the eval
    backend computes them at admission)."""
    req, ids, budget, feats = entry
    vision = (runner.vision_embeds(req), [feats.grid_thw], [feats.second_per_grid_t])
    return (ids, budget, None, None, None, vision)


def serve(eng, runner, requests, steps, first_window=None):
    """Drive the engine as the eval backend does: waiting requests go in
    bursts through submit_batch (ViT embeds computed at admission) whenever
    slots are free, then one step(steps) window. Returns (outputs by request
    index, wall s, TTFT of the first wave, window s, peak pages in use)."""
    import torch

    waiting = list(range(len(requests)))
    rid_of, out, windows = {}, {}, []
    pc = eng.pcache
    usable = pc.k.shape[2] - 1
    peak = 0
    ttft = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while waiting or eng.num_active:
        free = eng.num_slots - eng.num_active
        if waiting and free:
            take = waiting[:free]
            rids = eng.submit_batch([submit_item(runner, requests[i]) for i in take])
            for i, rid in zip(take, rids):
                if rid is not None:
                    rid_of[rid] = i
                    waiting.remove(i)
            if not eng.num_active:
                raise AssertionError(f"no request admitted: rids {rids}")
            peak = max(peak, usable - pc.available_pages())
        t = time.perf_counter()
        for rid, toks in eng.step(steps):
            out[rid_of[rid]] = toks
        windows.append(time.perf_counter() - t)
        peak = max(peak, usable - pc.available_pages())
        if ttft is None:
            ttft = time.perf_counter() - t0
            if first_window is not None:
                first_window(eng, rid_of)
    return out, time.perf_counter() - t0, ttft, windows, peak


def teacher_forced_logits(model, runner, req, tokens, kernels: bool = False):
    """The contiguous plain path (engine/generate.py prefill, then decode
    forwards over the cache) fed the given tokens: the logits after them.
    kernels: the ViT's kernels and the flash prefill instead (the decode
    forwards stay plain, as generate's batch decode runs them)."""
    import torch

    from video_r2_tpu_torch.engine.generate import decode_step_logits, prefill
    from video_r2_tpu_torch.models.decoder import KVCache

    cfg, dev = model.cfg, model.device
    S = req.input_ids.shape[1]
    length = int(req.lengths[0])
    cache = KVCache.init(cfg.text, 1, S + len(tokens),
                         model.model.embed_tokens.embedding.dtype, dev)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        prefill(model, torch.as_tensor(req.input_ids, device=dev).long(),
                torch.as_tensor(req.position_ids, device=dev).long(), lens, cache,
                runner.vision_embeds(req, "kernel" if kernels else "xla"), cfg.video_token_id,
                attn_impl="flash" if kernels else "xla")
        pos0 = int(req.rope_deltas[0]) + S          # rope position of decode step 0
        for t, tok in enumerate(tokens):
            logits = decode_step_logits(model, torch.tensor([tok], device=dev),
                                        torch.tensor([pos0 + t], device=dev), cache, lens,
                                        S, t)
        return logits[0]


def serving_phase(model, runner, requests, card) -> dict:
    """Phase 9. Returns the launch counts of the bf16 run and of the int8
    pass."""
    import torch

    from video_r2_tpu_torch.engine.continuous import PagedContinuousEngine
    from video_r2_tpu_torch.engine.sampling import SamplingParams

    cfg = model.cfg
    eos = cfg.eos_token_id
    sp = SamplingParams(eos_token_ids=(eos,), pad_token_id=cfg.pad_token_id)

    def engine(kv_quant=None):
        return PagedContinuousEngine(model, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                                     sp=sp, attn_impl="flash", prompt_buckets=SERVE_BUCKETS,
                                     page_size=PAGE_SIZE, kv_quant=kv_quant)

    eng = engine()
    avail0 = eng.pcache.available_pages()
    first = {}

    def keep_request0(e, rid_of):
        slot = next(s for s, r in enumerate(e.slot_req)
                    if r is not None and rid_of[r.rid] == 0)
        first["tokens"] = list(e.slot_req[slot].tokens)
        first["logits"] = e.last_logits[slot].clone()

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, wall, ttft, windows, peak_pages = serve(eng, runner, requests, DECODE_STEPS,
                                                 keep_request0)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tok = sum(len(t) for t in out.values())
    full = [w for w in windows[1:]]
    print(f"batched serving: {len(out)} requests, {SERVE_SLOTS} slots, {n_tok} tokens in "
          f"{wall:.3f} s: {n_tok / wall:.2f} generated tok/s, {len(out) / wall:.4f} "
          f"requests/s, TTFT of the first wave {ttft * 1e3:.1f} ms (ViT + prefill + "
          f"first window), {len(windows)} windows of {DECODE_STEPS} steps, "
          f"{1e3 * sum(full) / max(len(full), 1):.2f} ms per window after the first "
          f"(min {1e3 * min(full):.2f}, max {1e3 * max(full):.2f}), peak device memory "
          f"{peak:.2f} GiB, pool pages in use at most {peak_pages} of "
          f"{eng.pcache.k.shape[2] - 1}; launches {launches} | {card}", flush=True)
    for i, (_, _, budget, _) in enumerate(requests):
        toks = out.get(i)
        if toks is None or not (len(toks) == budget or (toks and toks[-1] == eos
                                                        and len(toks) < budget)):
            raise AssertionError(f"request {i} did not finish within its budget {budget}: "
                                 f"{None if toks is None else len(toks)} tokens")
    n_layers = eng.pcache.k.shape[0]
    if launches["paged_decode_attention_stacked"] <= 0 or \
            launches["paged_decode_attention_stacked"] % n_layers:
        raise AssertionError(f"the serving run launched no paged kernel, or not one a "
                             f"layer of each decoder pass: {launches}")
    for name in ("flash_attention", "window_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"the serving run launched no {name} kernel")
    if eng.pcache.available_pages() != avail0:
        raise AssertionError(f"pages not returned: {eng.pcache.available_pages()} of "
                             f"{avail0} available after draining")

    # request 0 after its first window vs the contiguous plain path
    ref = teacher_forced_logits(model, runner, requests[0][0], first["tokens"])
    got = first["logits"]
    rel = rel_l2(got, ref)
    print(f"request 0 after its first window ({len(first['tokens'])} tokens): logits vs "
          f"the contiguous plain path rel_l2={rel:.3e} (tol {LOGITS_TOL}), argmax "
          f"{int(got.argmax())} vs {int(ref.argmax())}", flush=True)
    if not (torch.isfinite(got).all() and got.shape == (cfg.text.vocab_size,)
            and rel <= LOGITS_TOL):
        raise AssertionError(f"paged engine logits disagree with the contiguous path: {rel}")

    # int8 pages: the same first requests, one step on each engine
    def one_step_logits(e):
        rids = e.submit_batch([submit_item(runner, r) for r in requests[:INT8_REQUESTS]])
        e.step(1)
        slots = [next(s for s, r in enumerate(e.slot_req) if r is not None and r.rid == rid)
                 for rid in rids]
        return e.last_logits[slots].clone()

    ref8 = one_step_logits(eng)
    while eng.num_active:
        eng.step(DECODE_STEPS)
    del eng
    reset_launches()
    eng8 = engine("int8")
    avail8 = eng8.pcache.available_pages()
    got8 = one_step_logits(eng8)
    while eng8.num_active:
        eng8.step(DECODE_STEPS)
    launches8 = read_launches()
    rel8 = rel_l2(got8, ref8)
    print(f"int8 pages ({INT8_REQUESTS} requests, drained): logits after one step vs "
          f"the bf16 engine rel_l2={rel8:.3e} (tol {INT8_LOGITS_TOL}); launches "
          f"{launches8}", flush=True)
    if launches8["paged_decode_attention_stacked_quant"] <= 0 or \
            launches8["paged_decode_attention_stacked_quant"] % n_layers:
        raise AssertionError(f"the int8 pass launched no quant kernel, or not one a layer "
                             f"of each decoder pass: {launches8}")
    if not (torch.isfinite(got8).all() and rel8 <= INT8_LOGITS_TOL):
        raise AssertionError(f"int8 pages disagree with bf16 pages: {rel8}")
    if eng8.pcache.available_pages() != avail8:
        raise AssertionError("int8 pass: pages not returned")
    return {"bf16": launches, "int8": launches8}


def video_batch(runner, cfg, questions):
    """Phase 13's and 17's requests: a video for each question (8 frames of
    392x392 from seeds SEED, SEED + 1, ...: phase 4's frames first), each
    prepared alone through DemoRunner.prepare, then right-padded into one
    batch with rope positions over the batch, as the eval backend builds a
    batch. Returns (requests, packed prompts, position_ids [3, B, S],
    rope_deltas [B])."""
    import numpy as np

    from video_r2_tpu_torch.engine.chat import pack_prompts
    from video_r2_tpu_torch.models.mrope import get_rope_index
    from video_r2_tpu_torch.video.api import video_features

    feats = [video_features(np.random.default_rng(SEED + i).integers(
        0, 256, (N_FRAMES, FRAME_HW, FRAME_HW, 3), np.uint8),
        FRAME_HW, FRAME_HW, sample_fps=2.0) for i in range(len(questions))]
    reqs = [runner.prepare(f, q) for f, q in zip(feats, questions)]
    packed = pack_prompts([[int(t) for t in r.input_ids[0, :int(r.lengths[0])]]
                           for r in reqs], cfg.pad_token_id)
    S = packed.input_ids.shape[1]
    mask = (np.arange(S)[None] < packed.lengths[:, None]).astype(np.int64)
    pos, deltas = get_rope_index(
        packed.input_ids, cfg, video_grid_thw=np.array([f.grid_thw for f in feats]),
        second_per_grid_ts=np.array([f.second_per_grid_t for f in feats]),
        attention_mask=mask)
    return reqs, packed, pos, deltas[:, 0]


def int4_library(x, K: int, N: int, copies: int):
    """The library yardstick of the int4 matmul: torch._weight_int4pack_mm
    (tinygemm) over its own packing of a random int4 [K, N] weight with bf16
    scales and zeros (group 128), made once and outside the timing, rotating
    over `copies` copies like the kernel. Returns (callable or None, why
    not)."""
    import torch

    if not hasattr(torch, "_weight_int4pack_mm"):
        return None, "this torch has no _weight_int4pack_mm"
    dev = x.device
    try:           # a capability probe of the yardstick, not of the port
        w = torch.randint(0, 16, (N, K), dtype=torch.int32, device=dev)
        packed = torch._convert_weight_to_int4pack((w[:, ::2] << 4 | w[:, 1::2]).to(torch.uint8),
                                                   8)
        del w
        sz = torch.zeros((K // 128, N, 2), dtype=torch.bfloat16, device=dev)
        sz[..., 0] = 0.01
        torch._weight_int4pack_mm(x, packed, 128, sz)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        return None, str(e).splitlines()[0][:160]
    packs = [packed] + [packed.clone() for _ in range(copies - 1)]
    i = [0]

    def run():
        i[0] = (i[0] + 1) % copies
        return torch._weight_int4pack_mm(x, packs[i[0]], 128, sz)
    return run, ""


def int4_case(gen, what: str, M: int, K: int, N: int) -> dict:
    """The int4 kernel at one shape against its plain version: seeded
    weights with unit-scale products, quantized by quantize_kernel_int4;
    copies of them rotate so that each timed launch reads cold weights.
    Kernel and library call are timed eagerly (ms, library_ms: at decode
    shapes the wrapper's host time sets these) and in a CUDA graph
    (device_ms, library_device_ms)."""
    import math

    import torch

    from video_r2_tpu_torch.models.quant import quantize_kernel_int4
    from video_r2_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain

    dev = gen.device
    leaf = quantize_kernel_int4(torch.randn(K, N, generator=gen, device=dev) * K ** -0.5)
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    wq, sc = leaf["kernel_q4"], leaf["scale4"]
    w_bytes = wq.numel() + 4.0 * sc.numel()
    copies = max(1, math.ceil(COLD_BYTES / w_bytes))
    wqs = [wq] + [wq.clone() for _ in range(copies - 1)]
    scs = [sc] + [sc.clone() for _ in range(copies - 1)]
    i = [0]

    def rot(fn):
        def go():
            i[0] = (i[0] + 1) % copies
            return fn(x, wqs[i[0]], scs[i[0]])
        return go

    out, ref = int4_matmul(x, wq, sc), int4_matmul_plain(x, wq, sc)
    err, excess = compare(out, ref)
    library, why = int4_library(x, K, N, copies)
    r = {"max_abs_err": err, "excess": excess, "ms": cuda_ms(rot(int4_matmul)),
         "device_ms": graph_ms(rot(int4_matmul)),
         "plain_ms": cuda_ms(rot(int4_matmul_plain), iters=5, warmup=1),
         "library_ms": cuda_ms(library) if library is not None else None,
         "library_device_ms": graph_ms(library) if library is not None else None,
         **bound(2.0 * M * K * N, 2.0 * M * K + w_bytes + 2.0 * M * N)}
    report("int4_matmul", what, (M, K, N), copies=copies,
           **{k: v for k, v in r.items() if v is not None},
           **({} if library is not None else {"library": f"none ({why})"}))
    if not (torch.isfinite(out).all() and excess <= 1.0):
        raise AssertionError(f"int4_matmul [{what}] disagrees with its plain version: "
                             f"{excess} x the tolerance")
    return r


def decode_case(gen, what, q, k, v, lens, s_pad: int, slot_end: int, layer: int) -> dict:
    """The head-major decode kernel at one (step, layer) against its plain
    version; timed launches read the next layer each, so the cache comes
    from device memory. The library call: SDPA over that layer's K / V (GQA
    expanded to the query heads beforehand) with the boolean mask."""
    import torch
    import torch.nn.functional as F

    from video_r2_tpu_torch.ops.decode_attention import (
        decode_attention_stacked,
        decode_attention_stacked_plain,
    )

    n_layers, B, kh, smax, hd = k.shape
    nh = q.shape[1]
    kernel = lambda l: decode_attention_stacked(q, k, v, lens, slot_end, l, s_pad)  # noqa: E731
    plain = lambda l: decode_attention_stacked_plain(  # noqa: E731
        q, k, v, lens, slot_end, l, s_pad)
    out, ref = kernel(layer), plain(layer)
    fp32 = q.dtype == torch.float32
    err, excess = compare(out, ref, tol=FP32_TOL if fp32 else KERNEL_ATOL)
    at = [layer]

    def call(fn):
        def go():
            at[0] = (at[0] + 1) % n_layers
            return fn(at[0])
        return go

    kpos = torch.arange(smax, device=q.device)
    valid = (kpos[None] < lens[:, None]) | ((kpos >= s_pad) & (kpos <= slot_end))[None]
    ke, ve = (x.repeat_interleave(nh // kh, dim=2) for x in (k, v))
    qd, mask = q[:, :, None], valid[:, None, None]
    library = lambda l: F.scaled_dot_product_attention(qd, ke[l], ve[l], attn_mask=mask)  # noqa: E731
    with torch.no_grad():
        lib_ms, lib_device_ms = cuda_ms(call(library)), graph_ms(call(library))
    del ke, ve
    keys = float(valid.sum())                   # admitted keys over the batch
    r = {"max_abs_err": err, "excess": excess, "ms": cuda_ms(call(kernel)),
         "device_ms": graph_ms(call(kernel)),
         "plain_ms": cuda_ms(call(plain), iters=5), "library_ms": lib_ms,
         "library_device_ms": lib_device_ms,
         **bound(4.0 * nh * hd * keys, 2.0 * q.element_size() * q.numel()
                 + 2.0 * k.element_size() * keys * kh * hd + 4.0 * B,
                 PEAK_FP32 if fp32 else PEAK_BF16)}
    report("decode_attention", what, (B, nh, kh, hd, smax, layer), keys=int(keys), **r)
    if not (torch.isfinite(out).all() and excess <= 1.0):
        raise AssertionError(f"decode_attention [{what}] disagrees with its plain version: "
                             f"{excess} x the tolerance")
    return r


def int4_launch_line(M: int, K: int, N: int, sms: int, g: int = 128) -> str:
    """The int4 kernel's launch at one shape: the decode kernel's stream-K
    plan (blocks, tiles, steps a block), or the staged kernel's split-K plan
    and blocks; and the scale placement."""
    import torch

    from video_r2_tpu_torch.ops import int4_matmul as m

    placement = getattr(m, "SCALE_PLACEMENT", "a")   # an older checkout under --root: (a)
    plan = None
    if hasattr(m, "int4_decode_plan") and M <= m.DECODE_MAX_ROWS:
        resident = m.int4_decode_resident(torch.cuda.current_device())[M > m.DECODE_TILE_ROWS]
        plan = m.int4_decode_plan(M, K, N, g, sms, resident)
    if plan is not None:
        blocks, tiles, steps = plan
        lengths = sorted({end - begin for begin, end in m.int4_decode_ranges(steps, blocks)})
        return (f"decode kernel, stream-K: {blocks} blocks on {sms} SMs over {tiles} tiles of "
                f"{m.DECODE_COLUMNS} columns, {steps} steps of {m.DECODE_STEP_ROWS} packed "
                f"rows ({'/'.join(map(str, lengths))} a block); scale placement "
                f"({placement})")
    S, ranges = m.int4_split_plan(M, K, N, sms)
    blocks = m.int4_tiles(M, N) * S
    lengths = sorted({end - begin for begin, end in ranges})
    return (f"staged kernel: split S={S} ({'/'.join(map(str, lengths))} stages each"
            f"{', a cluster a tile' if S > 1 and hasattr(m, 'SPLIT_MAX') else ''}), "
            f"{blocks} blocks on {sms} SMs; scale placement ({placement})")


def int4_kernel_phase(cfg, batch, device) -> dict:
    """Phase 12: the int4 matmul at every (rows, K, N) phase 13 gives it
    (the ViT's at its 2-frame clip) and the decode kernel at phase 13's
    batch. Returns the kernels line's rows:
    decode gate / up at B = 4, and decode step 63 with the window on."""
    import torch

    from video_r2_tpu_torch.ops.decode_attention import BLOCK_S
    from video_r2_tpu_torch.ops.int4_matmul import int4_decode_resident

    reqs, packed, _, _ = batch
    tc, vc = cfg.text, cfg.vision
    B = len(reqs)
    H, qd, kvd = tc.hidden_size, tc.num_attention_heads * tc.head_dim, \
        tc.num_key_value_heads * tc.head_dim
    I, V = tc.intermediate_size, tc.vocab_size
    D4 = vc.spatial_merge_unit * vc.hidden_size
    merger_rows = int(reqs[0].layout.seq_len_real) // vc.spatial_merge_unit
    cases = {}
    for what, M, K, N in (("decode q", B, H, qd), ("decode k / v", B, H, kvd),
                          ("decode o", B, qd, H), ("decode gate / up", B, H, I),
                          ("decode down", B, I, H), ("decode head", B, H, V),
                          ("merger fc1", merger_rows, D4, D4),
                          ("merger fc2", merger_rows, D4, vc.out_hidden_size),
                          ("ViT qkv", SHORT_PATCHES, vc.hidden_size, 3 * vc.hidden_size),
                          ("ViT proj", SHORT_PATCHES, vc.hidden_size, vc.hidden_size),
                          ("ViT gate / up", SHORT_PATCHES, vc.hidden_size,
                           vc.intermediate_size),
                          ("B=1 head", 1, H, V), ("B=1 gate / up", 1, H, I)):
        cases.setdefault((M, K, N), []).append(what)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    resident = int4_decode_resident(torch.cuda.current_device())
    print(f"int4 decode kernel: {resident} blocks resident an SM (8 / 16 rows of x), its "
          f"stream-K plan's blocks an SM", flush=True)
    results = {}
    for (M, K, N), names in cases.items():
        print(f"int4 [{', '.join(names)}] {int4_launch_line(M, K, N, sms)}", flush=True)
        results[(M, K, N)] = int4_case(gen, ", ".join(names), M, K, N)
        torch.cuda.empty_cache()

    S = packed.input_ids.shape[1]
    smax = -(-(S + INT4_NEW_TOKENS) // BLOCK_S) * BLOCK_S
    kh, nh, hd, n_layers = (tc.num_key_value_heads, tc.num_attention_heads, tc.head_dim,
                            tc.num_hidden_layers)
    k, v = (torch.randn(n_layers, B, kh, smax, hd, generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(B, nh, hd, generator=gen, device=device).to(torch.bfloat16)
    lens = torch.as_tensor(packed.lengths, dtype=torch.int32, device=device)
    print(f"decode attention: prompt lengths {packed.lengths.tolist()}, padded width {S}, "
          f"cache width {smax}; "
          f"{split_line(B, kh, smax // 64, sms, f'tc_kernel<{hd},1,__nv_bfloat16,0')}",
          flush=True)
    decode_case(gen, "step 0", q, k, v, lens, S, S, n_layers // 5)
    last = decode_case(gen, f"step {INT4_NEW_TOKENS - 1}", q, k, v, lens, S,
                       S + INT4_NEW_TOKENS - 1, n_layers - 1)
    decode_case(gen, "window off", q, k, v, lens, S, S - 1, n_layers // 2)
    del k, v
    torch.cuda.empty_cache()
    return {"int4_matmul": results[(B, H, I)], "decode_attention": last}


def param_split(model) -> dict:
    """Bytes of the model's parameters by storage: int4 leaves (packed
    nibbles and their scales), int8 leaves (with their scales), float."""
    split = {"int4": 0, "int8": 0, "float": 0}
    for mod in model.modules():
        int8 = getattr(mod, "kernel_q", None) is not None
        for leaf, p in mod.named_parameters(recurse=False):
            kind = ("int4" if leaf in ("kernel_q4", "scale4") else
                    "int8" if leaf == "kernel_q" or (int8 and leaf == "scale") else "float")
            split[kind] += p.numel() * p.element_size()
    return split


def int4_request_check(model, runner, req, what: str, T: int) -> int:
    """One request alone on the int4 model, through the kernel path and the
    plain path (set_kernel_impl "plain", prefill and ViT attention "xla"):
    its logits after prefill and after one decode step of the kernel path's
    argmax, within LOGITS_TOL. The plain path must launch no int4 or decode
    kernel. Returns the int4 launches of the kernel path's ViT."""
    import torch

    from video_r2_tpu_torch.engine.generate import decode_step_logits, prefill
    from video_r2_tpu_torch.models.decoder import DecodeKVCache
    from video_r2_tpu_torch.ops.decode_attention import BLOCK_S

    cfg, dev = model.cfg, model.device
    S0, n0 = req.input_ids.shape[1], int(req.lengths[0])
    r_ids = torch.as_tensor(req.input_ids, device=dev).long()
    r_pos = torch.as_tensor(req.position_ids, device=dev).long()
    r_len = torch.as_tensor(req.lengths, dtype=torch.int32, device=dev)
    r_dec = torch.as_tensor(req.rope_deltas + S0, device=dev).long()
    r_max = -(-(S0 + T) // BLOCK_S) * BLOCK_S
    got, counts = {}, {}
    for path in ("kernel", "plain"):
        plain = path == "plain"
        set_kernel_impl(model, path)
        reset_launches()
        with torch.inference_mode():
            vemb = runner.vision_embeds(req, "xla" if plain else "kernel")
            vit = read_launches()["int4_matmul"]
            cache = DecodeKVCache.init(cfg.text, 1, r_max, torch.bfloat16, dev)
            l0 = prefill(model, r_ids, r_pos, r_len, cache, vemb, cfg.video_token_id,
                         "xla" if plain else "flash")
            tok = got["kernel"][0].argmax(-1) if plain else l0.argmax(-1)
            got[path] = (l0, decode_step_logits(model, tok, r_dec, cache, r_len, S0, 0))
        torch.cuda.synchronize()
        n = read_launches()
        counts[path] = (vit, n["int4_matmul"], n["decode_attention"])
    set_kernel_impl(model, "kernel")
    rels = [rel_l2(a, b) for a, b in zip(got["kernel"], got["plain"])]
    print(f"{what} ({n0} tokens, {req.patches.shape[0]} patches) on the int4 model, kernel "
          f"vs plain path: logits after prefill rel_l2={rels[0]:.3e}, after one decode step "
          f"{rels[1]:.3e} (tol {LOGITS_TOL}); argmax {int(got['kernel'][0].argmax())} vs "
          f"{int(got['plain'][0].argmax())}; (ViT int4, int4, decode) launches: kernel path "
          f"{counts['kernel']}, plain path {counts['plain']}", flush=True)
    if not (all(torch.isfinite(x).all() for x in got["kernel"]) and max(rels) <= LOGITS_TOL):
        raise AssertionError(f"int4 kernel path disagrees with the plain path on {what}: "
                             f"{rels}")
    if counts["plain"][1:] != (0, 0) or counts["kernel"][2] != cfg.text.num_hidden_layers:
        raise AssertionError(f"{what}: launches {counts} (the plain path must launch no "
                             f"int4 or decode kernel, the kernel path one decode a layer)")
    return counts["kernel"][0]


def int4_serving_phase(model, runner, batch, card) -> dict:
    """Phase 13. Returns the int4 and decode kernels' launches from the
    counted generate call."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.engine.generate import decode_step_logits, generate, prefill
    from video_r2_tpu_torch.engine.sampling import SamplingParams
    from video_r2_tpu_torch.models.decoder import DecodeKVCache, KVCache
    from video_r2_tpu_torch.models.quant import quantize_params
    from video_r2_tpu_torch.ops.decode_attention import BLOCK_S
    from video_r2_tpu_torch.video.api import video_features

    reqs, packed, pos, deltas = batch
    cfg, dev = model.cfg, model.device
    B, S = packed.input_ids.shape
    T = INT4_NEW_TOKENS
    smax = -(-(S + T) // BLOCK_S) * BLOCK_S
    ids_t = torch.as_tensor(packed.input_ids, device=dev).long()
    pos_t = torch.as_tensor(pos, device=dev).long()
    len_t = torch.as_tensor(packed.lengths, dtype=torch.int32, device=dev)
    dec_pos = torch.as_tensor(deltas + S, device=dev).long()   # rope position of step 0

    def embeds():
        return torch.cat([runner.vision_embeds(r) for r in reqs])

    def first_step(cache, vemb, attn_impl="flash"):
        """Prefill logits [B, V] and the logits after one decode step of
        their argmax tokens, over `cache`."""
        with torch.inference_mode():
            l0 = prefill(model, ids_t, pos_t, len_t, cache, vemb, cfg.video_token_id,
                         attn_impl)
            return l0, decode_step_logits(model, l0.argmax(-1), dec_pos, cache, len_t, S, 0,
                                          attn_impl)

    # 1. the bf16 model's prefill logits
    with torch.inference_mode():
        bf16_logits = prefill(model, ids_t, pos_t, len_t,
                              DecodeKVCache.init(cfg.text, B, smax, torch.bfloat16, dev),
                              embeds(), cfg.video_token_id, "flash")
    before = param_split(model)

    # 2. int4 weights in place
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_params(model, bits=4)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    split = param_split(model)
    gib = lambda n: n / 2 ** 30  # noqa: E731
    print(f"int4 quantize_params in place: {q_s:.2f} s, peak {gib(torch.cuda.max_memory_allocated()):.2f} "
          f"GiB; parameters {gib(sum(before.values())):.3f} GiB before -> int4 "
          f"{gib(split['int4']):.3f} GiB, int8 {gib(split['int8']):.3f} GiB, float "
          f"{gib(split['float']):.3f} GiB", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the slice: 4 videos, one generate call, counted
    sp = SamplingParams(max_new_tokens=T, eos_token_ids=(), pad_token_id=cfg.pad_token_id)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vemb = embeds()
    torch.cuda.synchronize()
    vit_ms = (time.perf_counter() - t0) * 1e3
    marks = []

    def on_embed(module, args):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    hook = model.model.embed_tokens.register_forward_pre_hook(on_embed)
    res = generate(model, packed.input_ids, packed.lengths, sp, position_ids=pos,
                   rope_deltas=deltas, vision_embeds=vemb,
                   vision_token_id=cfg.video_token_id, attn_impl="flash",
                   decode_impl="kernel")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    hook.remove()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = len(marks) - 1
    dec_s = t_end - marks[1]
    n_layers = cfg.text.num_hidden_layers
    per_step = 7 * n_layers + 1
    expect_int4 = (T - 1) * per_step + 1 + 2 * B      # + the prefill head, the merger
    print(f"int4 serving: {B} videos, prompt lengths {packed.lengths.tolist()} padded to "
          f"{S}, {T} greedy tokens each (eos off): ViT {vit_ms:.1f} ms (4 videos), prefill "
          f"{(marks[1] - marks[0]) * 1e3:.1f} ms, {steps} decode steps of "
          f"{dec_s / steps * 1e3:.2f} ms, {B * steps / dec_s:.2f} tok/s ({steps / dec_s:.2f} "
          f"steps/s), peak device memory {peak:.2f} GiB; launches {launches} (int4 expected "
          f"{expect_int4}: {T - 1} x {per_step} + 1 prefill head + 2 x {B} merger; decode "
          f"attention expected {(T - 1) * n_layers}) | {card}", flush=True)
    if res.sequences.shape != (B, T) or steps != T - 1:
        raise AssertionError(f"int4 generate: {res.sequences.shape} tokens, {steps} steps")
    if launches["int4_matmul"] < (T - 1) * per_step + 2 * B:
        raise AssertionError(f"the int4 slice launched {launches['int4_matmul']} int4 "
                             f"kernels, fewer than {(T - 1) * per_step + 2 * B}")
    if launches["decode_attention"] != (T - 1) * n_layers:
        raise AssertionError(f"the int4 slice launched {launches['decode_attention']} "
                             f"decode kernels, not {(T - 1) * n_layers}")
    for name in ("flash_attention", "window_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"the int4 slice launched no {name} kernel")

    # 4. request 0 alone, and a 2-frame clip whose 784 patches take the ViT's
    # int4 linears through the kernel: kernel path vs plain path
    short = runner.prepare(video_features(np.random.default_rng(SEED + 9).integers(
        0, 256, (SHORT_FRAMES, FRAME_HW, FRAME_HW, 3), np.uint8), FRAME_HW, FRAME_HW,
        sample_fps=2.0), INT4_QUESTIONS[0])
    int4_request_check(model, runner, reqs[0], "request 0", T)
    vit = int4_request_check(model, runner, short, f"a {SHORT_FRAMES}-frame clip", T)
    vit_linears = 4 * cfg.vision.depth + 2     # qkv, proj, gate, up a block; the merger
    if vit < vit_linears:
        raise AssertionError(f"the {SHORT_FRAMES}-frame clip's ViT launched {vit} int4 "
                             f"kernels, fewer than {vit_linears}")

    # 5. the batch's first decode step, decode_impl "kernel" vs "xla"
    lk0, lk1 = first_step(DecodeKVCache.init(cfg.text, B, smax, torch.bfloat16, dev), vemb)
    lx0, lx1 = first_step(KVCache.init(cfg.text, B, S + T, torch.bfloat16, dev), vemb)
    rel_kx = rel_l2(lk1, lx1)
    print(f"int4 batch, logits after one decode step, decode_impl kernel vs xla: "
          f"rel_l2={rel_kx:.3e} (tol {LOGITS_TOL}); after prefill {rel_l2(lk0, lx0):.3e}",
          flush=True)
    if not (torch.isfinite(lk1).all() and rel_kx <= LOGITS_TOL):
        raise AssertionError(f"decode_impl='kernel' disagrees with 'xla': {rel_kx}")

    # 6. int4 vs bf16 prefill logits, no bound (random weights)
    agree = int((lk0.argmax(-1) == bf16_logits.argmax(-1)).sum())
    print(f"int4 vs bf16 prefill logits: rel_l2={rel_l2(lk0, bf16_logits):.3e}, argmax "
          f"agrees on {agree} of {B}", flush=True)
    del vemb
    return {"int4_matmul": launches["int4_matmul"],
            "decode_attention": launches["decode_attention"]}


def video_slices(card: str, device) -> tuple[dict, dict]:
    """Phases 3-9 on Qwen2.5-VL-7B. Returns (kernel results, launches by
    kernel name from the path that runs each); every tensor of the slices
    dies with this frame."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.apps.demo import DemoRunner
    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.engine.generate import decode, prefill
    from video_r2_tpu_torch.engine.sampling import SamplingParams
    from video_r2_tpu_torch.models.config import qwen25vl_7b
    from video_r2_tpu_torch.models.decoder import KVCache
    from video_r2_tpu_torch.models.loader import init_params, param_count
    from video_r2_tpu_torch.video.api import video_features

    # the slice's inputs (host side), so the kernel checks use its shapes
    cfg = qwen25vl_7b()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=SEED, dtype="bfloat16", device=device)
    torch.cuda.synchronize()
    print(f"model: qwen25vl_7b bf16, {param_count(model) / 1e9:.3f} B params, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    runner = DemoRunner(model, ByteTokenizer())
    feats = [video_features(
        np.random.default_rng(SEED + i).integers(
            0, 256, (N_FRAMES, FRAME_HW, FRAME_HW, 3), np.uint8),
        FRAME_HW, FRAME_HW, sample_fps=2.0) for i in range(N_REQUESTS)]
    reqs = [runner.prepare(f, q) for f, q in zip(feats, QUESTIONS)]
    S = reqs[0].input_ids.shape[1]
    print(f"slice: grid {feats[0].grid_thw}, {feats[0].num_tokens} video tokens, "
          f"prompt lengths {[int(r.lengths[0]) for r in reqs]}, padded width {S}",
          flush=True)

    # phase 3: the serving kernels at the slice's shapes
    gen = torch.Generator(device=device).manual_seed(SEED)
    tc, vc = cfg.text, cfg.vision
    kernel_results = {}
    B, Sk = 3, S + NEW_TOKENS      # prefill: Sq = padded prompt, Sk = cache width
    q = torch.randn(B, S, tc.num_attention_heads, tc.head_dim, generator=gen,
                    device=device).to(torch.bfloat16)
    k, v = (torch.randn(B, Sk, tc.num_key_value_heads, tc.head_dim, generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([S, S - 97, S // 2], dtype=torch.int32, device=device)
    kernel_results.update(flash_case(gen, "prefill causal", q, k, v, lengths, True, None,
                                     training=False))
    q, k, v, full_len, seg = vit_full_inputs(gen, reqs[0].layout, vc.num_heads,
                                             vc.head_dim, device)
    flash_case(gen, "vit full, segments", q, k, v, full_len, False, seg, training=False)
    valid = torch.as_tensor(reqs[0].layout.valid, device=device)
    kernel_results.update(window_case(gen, "vit windows", valid, vc.num_heads, vc.head_dim,
                                      training=False))
    del q, k, v

    # phase 4: the serving path, counted
    reset_launches()
    latencies, answers = [], []
    for f, q in zip(feats, QUESTIONS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runner.generate(runner.prepare(f, q), NEW_TOKENS)
        answers.append(runner.tok.decode(res.sequences[0][: res.lengths[0]],
                                         skip_special_tokens=True))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    serving = read_launches()
    print(f"answered {N_REQUESTS} requests: latency_s={[round(x, 4) for x in latencies]} "
          f"launches={serving} answer_chars={[len(a) for a in answers]}", flush=True)
    for name in ("flash_attention", "window_attention"):
        if serving[name] <= 0:
            raise AssertionError(f"the serving path launched no {name} kernel")

    # phase 5: phase times and kernel-vs-plain logits on request 0
    req = reqs[0]
    ids = torch.as_tensor(req.input_ids, dtype=torch.long, device=device)
    pos = torch.as_tensor(req.position_ids, dtype=torch.long, device=device)
    lengths = torch.as_tensor(req.lengths, dtype=torch.int32, device=device)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def run_prefill(vit_impl, attn_impl):
        vemb, vit_ms = timed(lambda: runner.vision_embeds(req, vit_impl))
        cache = KVCache.init(cfg.text, 1, S + NEW_TOKENS, torch.bfloat16, device)
        logits, pf_ms = timed(lambda: prefill(
            model, ids, pos, lengths, cache, vemb, cfg.video_token_id, attn_impl))
        return logits, cache, vit_ms, pf_ms

    logits_k, cache, vit_ms, pf_ms = run_prefill("kernel", "flash")
    logits_k, cache, vit_ms, pf_ms = run_prefill("kernel", "flash")   # warm
    logits_p, _, vit_ms_p, pf_ms_p = run_prefill("xla", "xla")
    logits_p, _, vit_ms_p, pf_ms_p = run_prefill("xla", "xla")
    sp = SamplingParams(max_new_tokens=NEW_TOKENS, pad_token_id=cfg.pad_token_id)
    deltas = torch.as_tensor(req.rope_deltas + (S - req.lengths), device=device)
    # the first token is sampled from the prefill logits; the rate counts the
    # decoder forwards the loop ran, timed from the first one's start
    steps = []

    def on_step(module, args):
        if not steps:
            torch.cuda.synchronize()
        steps.append(time.perf_counter())

    hook = model.model.register_forward_pre_hook(on_step)
    toks, _, _ = decode(model, sp, logits_k, cache, lengths, deltas, None,
                        s_pad=S, attn_impl="flash")
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - steps[0]
    hook.remove()
    del cache
    print(f"kernel path: vit_ms={vit_ms:.2f} prefill_ms={pf_ms:.2f} "
          f"decode_tok_s={len(steps) / dec_s:.2f} ({len(steps)} forward steps "
          f"in {dec_s * 1e3:.1f} ms, B=1) | plain path: vit_ms={vit_ms_p:.2f} "
          f"prefill_ms={pf_ms_p:.2f} | {card}", flush=True)
    print(f"peak device memory (serving): {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)

    if logits_k.shape != (1, cfg.text.vocab_size) or not torch.isfinite(logits_k).all():
        raise AssertionError(f"bad logits: shape {tuple(logits_k.shape)}")
    rel = float((logits_k - logits_p).norm() / logits_p.norm())
    top_k, top_p = int(logits_k.argmax()), int(logits_p.argmax())
    print(f"last-token logits, kernel vs plain path: rel_l2={rel:.3e} "
          f"(tol {LOGITS_TOL}) max_abs={float((logits_k - logits_p).abs().max()):.3e} "
          f"argmax {top_k} vs {top_p}; generated {toks.shape[1]} tokens", flush=True)
    if not rel <= LOGITS_TOL:
        raise AssertionError(f"kernel path logits disagree: {rel} > {LOGITS_TOL}")

    # phases 6 and 7: training
    training = training_phase(model, cfg, card, device, kernel_results)

    # phase 8: the paged kernels at the batched slice's decode shapes
    requests = serve_requests(runner, cfg)
    prompt_lens = [len(ids) for _, ids, _, _ in requests]
    print(f"batched slice: {SERVE_REQUESTS} requests, prompt lengths {prompt_lens}, "
          f"budgets {list(SERVE_BUDGETS)}", flush=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    decode_lens = [n + 64 for n in prompt_lens[:SERVE_SLOTS]]
    paged_split_lines(cfg, SERVE_SLOTS, max(-(-n // PAGE_SIZE) for n in decode_lens),
                      torch.cuda.get_device_properties(device).multi_processor_count)
    kernel_results.update(paged_case(gen, "decode, W=1", cfg, decode_lens, 1))
    paged_case(gen, "verify chunk, W=4", cfg, decode_lens, 4)
    kernel_results.update(paged_case(gen, "int8 pages, W=1", cfg, decode_lens, 1, "int8"))
    paged_case(gen, "fp32 q and pages, W=1", cfg, decode_lens, 1, "fp32")
    kernel_results.update(paged_case(gen, "one-layer pool, W=1", cfg, decode_lens, 1,
                                     one_layer=True))
    # phase 22(a): the 7B's verify chunks, rows of the kernels line: SPEC_K +
    # 1 tokens (63 query rows a kv head, 22(d)'s spec rounds) and
    # SPEC_K_SMALL + 1 (35 rows, 22(d)'s GRPO rollouts); and the fp32
    # instance at 70 rows (two row groups), checked only (no path runs it)
    for name, K in (("paged_decode_attention_stacked_verify", SPEC_K),
                    ("paged_decode_attention_stacked_verify_k4", SPEC_K_SMALL)):
        kernel_results[name] = paged_case(
            gen, f"phase 22(a) verify chunk K={K}, W={K + 1}", cfg, decode_lens,
            K + 1)["paged_decode_attention_stacked"]
    paged_case(gen, f"phase 22(a) fp32 q and pages, W={SPEC_K + 2}", cfg, decode_lens,
               SPEC_K + 2, "fp32")

    # phase 9: batched serving through the paged engine
    paged_runs = serving_phase(model, runner, requests, card)

    # phase 19: LoRA-GRPO with paged rollouts (and 22(d)'s spec cycle)
    grpo_launches = grpo_phase(model, card, device)
    gc.collect()
    torch.cuda.empty_cache()
    verify_launches = spec_step_timing(model, card)          # phase 22(d)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 20: the eval path (EngineModel + evaluate), batch then paged,
    # and 20(c), the attention tap; the batch pass's samples tree stays for
    # phase 21
    eval_launches, tap_launches, eval_tree = eval_phase(model, card, device)

    # phases 12 and 13: int4 serving through the head-major decode kernel
    batch = video_batch(runner, cfg, INT4_QUESTIONS)
    kernel_results.update(int4_kernel_phase(cfg, batch, device))
    int4_runs = int4_serving_phase(model, runner, batch, card)

    launches = dict(training)
    launches.update({n: serving[n] for n in ("flash_attention", "window_attention")})
    launches.update({n: v for n, v in paged_runs["bf16"].items() if n.startswith("paged_")})
    launches["paged_decode_attention_stacked_quant"] = \
        paged_runs["int8"]["paged_decode_attention_stacked_quant"]
    launches.update(int4_runs)
    launches["paged_decode_attention_stacked_verify_k4"] = grpo_launches.pop("verify_launches")
    launches["phase19"] = grpo_launches
    launches["phase20"] = eval_launches
    launches["phase20c"] = tap_launches
    launches["phase20_tree"] = eval_tree
    launches["paged_decode_attention_stacked_verify"] = verify_launches
    return kernel_results, launches


FP32_KERNELS = ("flash_attention", "window_attention", "flash_attention_fwd_lse",
                "flash_bwd_dq", "flash_bwd_dkv", "window_attention_bwd",
                "paged_decode_attention_stacked", "decode_attention")


def tiny_fp32_phase(card: str, device) -> tuple[dict, dict]:
    """Phase 18: tiny_test_config() (fp32; text head dim 12, vision 16) on
    the card through the fp32 instances of the flash, window and
    decode-attention kernels. First each instance against its plain version
    at the path's shapes (the prefill, the tower's windows and
    full-attention groups, the SFT batch's decoder and tower, the paged
    engine's and generate's decode steps), timed; then, counted, a video
    question's prefill logits and greedy tokens (DemoRunner.generate), one
    make_sft_step step (the tower trained), three prompts through
    PagedContinuousEngine and the question through generate(decode_impl=
    "kernel"), each against the same weights on the CPU (the plain paths).
    Returns ({<kernel>_fp32: result}, {<kernel>_fp32: launches of the
    counted run})."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.apps.demo import DemoRunner
    from video_r2_tpu_torch.data.config import DataConfig
    from video_r2_tpu_torch.data.sft import SFTCollator, SFTDataset
    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.engine.continuous import PagedContinuousEngine
    from video_r2_tpu_torch.engine.generate import generate, prefill
    from video_r2_tpu_torch.engine.sampling import SamplingParams
    from video_r2_tpu_torch.models.config import tiny_test_config
    from video_r2_tpu_torch.models.decoder import KVCache
    from video_r2_tpu_torch.models.loader import init_params
    from video_r2_tpu_torch.train.optim import OptimConfig
    from video_r2_tpu_torch.train.sft import SFTConfig, init_train_state, make_sft_step
    from video_r2_tpu_torch.video.api import video_features

    cfg = tiny_test_config()
    tc, vc = cfg.text, cfg.vision
    tok = ByteTokenizer(TINY_SPECIALS)
    models = {"cpu": init_params(cfg, seed=SEED, device="cpu")}
    models["kernel"] = init_params(cfg, seed=SEED, device=device)
    models["kernel"].load_state_dict(models["cpu"].state_dict())
    frames = np.random.default_rng(SEED).integers(0, 256, (TINY_FRAMES, *TINY_HW, 3), np.uint8)
    feats = video_features(frames, *TINY_HW, sample_fps=2.0)
    runners = {w: DemoRunner(m, tok) for w, m in models.items()}
    req = runners["kernel"].prepare(feats, QUESTIONS[0])
    data = DataConfig(video_min_pixels=4 * 28 * 28, video_max_pixels=TINY_HW[0] * TINY_HW[1],
                      pad_to_multiple=16)
    records = [{"video": frames, "conversations": [
        {"from": "human", "value": f"<video>\n{q}"},
        {"from": "gpt", "value": a}]} for q, a in TRAIN_QA]
    batch = SFTCollator(cfg, data)([SFTDataset(records, tok, cfg, data)[i]
                                    for i in range(len(records))])
    B, S = batch.arrays["input_ids"].shape
    S0 = req.input_ids.shape[1]
    print(f"phase 18: tiny_test_config fp32 (text {tc.num_attention_heads} / "
          f"{tc.num_key_value_heads} heads of {tc.head_dim}, vision {vc.num_heads} heads of "
          f"{vc.head_dim}); question padded to {S0}, video grid {feats.grid_thw}; SFT batch "
          f"B={B}, padded width {S}", flush=True)

    # each fp32 instance against its plain version at the path's shapes
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=device)  # noqa: E731
    results = {}
    lengths = torch.as_tensor(req.lengths, dtype=torch.int32, device=device)
    q, k, v = rnd(1, S0, tc.num_attention_heads, tc.head_dim), *(
        rnd(1, S0, tc.num_key_value_heads, tc.head_dim) for _ in range(2))
    results.update(flash_case(gen, "tiny fp32 prefill", q, k, v, lengths, True, None,
                              training=False))
    valid = torch.as_tensor(req.layout.valid, device=device)
    results.update(window_case(gen, "tiny fp32 vit windows", valid, vc.num_heads, vc.head_dim,
                               training=False, dtype=torch.float32))
    blens = torch.as_tensor(batch.arrays["attention_mask"], device=device).sum(-1).int()
    q, k, v = rnd(B, S, tc.num_attention_heads, tc.head_dim), *(
        rnd(B, S, tc.num_key_value_heads, tc.head_dim) for _ in range(2))
    results.update(flash_case(gen, "tiny fp32 decoder training", q, k, v, blens, True, None,
                              training=True))
    layout = batch.video_layout
    q, k, v, full_len, seg = vit_full_inputs(gen, layout, vc.num_heads, vc.head_dim, device,
                                             torch.float32)
    flash_case(gen, "tiny fp32 vit full training", q, k, v, full_len, False, seg,
               training=True)
    results.update(window_case(gen, "tiny fp32 vit windows training",
                               torch.as_tensor(layout.valid, device=device), vc.num_heads,
                               vc.head_dim, training=True, dtype=torch.float32))
    # the decode-attention kernels' fp32 instances at head dim 12 (width 32):
    # the paged kernel at the engine's decode shapes, the head-major decode
    # kernel at generate's (the question's width padded to 128 keys)
    results.update(paged_case(gen, "tiny fp32 paged decode", cfg, [S0 + 5, 40, 130], 1,
                              pages="fp32"))
    L_t, kh_t, hd_t = tc.num_hidden_layers, tc.num_key_value_heads, tc.head_dim
    smax = -(-(S0 + TINY_NEW_TOKENS) // 128) * 128
    qd = rnd(2, tc.num_attention_heads, hd_t)
    kd, vd = (rnd(L_t, 2, kh_t, smax, hd_t) for _ in range(2))
    results["decode_attention"] = decode_case(
        gen, "tiny fp32 decode", qd, kd, vd,
        torch.tensor([S0, S0 - 7], dtype=torch.int32, device=device), S0, S0 + 5, L_t - 1)

    # the path, counted: a question (prefill logits, greedy tokens), one SFT
    # step, three prompts through the paged engine (tokens, and the next-token
    # logits after its first window), the question through generate(decode_impl=
    # "kernel") (tokens and their logprobs)
    prompts = [tok.encode(q) for q in QUESTIONS]
    greedy = SamplingParams(max_new_tokens=TINY_NEW_TOKENS, eos_token_ids=(), pad_token_id=0)
    reset_launches()
    logits, tokens, metrics, paged, decoded = {}, {}, {}, {}, {}
    for where, model in models.items():
        runner, dev = runners[where], model.device
        eng = PagedContinuousEngine(model, num_slots=len(prompts), max_len=256, sp=greedy,
                                    attn_impl=runner.impl, page_size=PAGE_SIZE)
        rids = eng.submit_batch([(ids, TINY_NEW_TOKENS - 3 * i) for i, ids in enumerate(prompts)])
        out, first = {}, None
        while eng.num_active:
            for rid, toks in eng.step(4):
                out[rid] = toks
            if first is None:
                first = eng.last_logits.cpu().clone()
        paged[where] = ([out[r] for r in rids], first)
        res = generate(model, req.input_ids, req.lengths, greedy,
                       position_ids=req.position_ids, rope_deltas=req.rope_deltas,
                       vision_embeds=runner.vision_embeds(req),
                       vision_token_id=cfg.video_token_id, attn_impl=runner.impl,
                       decode_impl="kernel")
        decoded[where] = (res.sequences, torch.as_tensor(res.logprobs))
        cache = KVCache.init(tc, 1, S0, torch.float32, dev)
        logits[where] = prefill(
            model, torch.as_tensor(req.input_ids, device=dev),
            torch.as_tensor(req.position_ids, device=dev),
            torch.as_tensor(req.lengths, dtype=torch.int32, device=dev), cache,
            runner.vision_embeds(req), cfg.video_token_id, runner.impl).cpu()
        tokens[where] = runner.generate(req, TINY_NEW_TOKENS).sequences
        model.requires_grad_(True)
        state = init_train_state(dict(model.named_parameters()), OptimConfig())
        scfg = SFTConfig(ce_chunk_size=64, attn_impl="flash" if where == "kernel" else "xla")
        step = make_sft_step(model, scfg, layout)
        tensors = {n: torch.as_tensor(a, device=dev) for n, a in batch.arrays.items()}
        _, m = step(state, tensors)
        metrics[where] = (float(m["loss"]), float(m["grad_norm"]))
    tiny_grpo_cycle(models, tok, data, frames, card)
    torch.cuda.synchronize()
    counted = read_launches()
    rel = rel_l2(logits["kernel"], logits["cpu"])
    same = bool(np.array_equal(tokens["kernel"], tokens["cpu"]))
    (loss, norm), (ref_loss, ref_norm) = metrics["kernel"], metrics["cpu"]
    loss_rel, norm_rel = abs(loss - ref_loss) / abs(ref_loss), abs(norm - ref_norm) / ref_norm
    launches = {f"{n}_fp32": counted[n] for n in FP32_KERNELS}
    paged_same = paged["kernel"][0] == paged["cpu"][0]
    paged_rel = rel_l2(paged["kernel"][1], paged["cpu"][1])
    dec_same = bool(np.array_equal(decoded["kernel"][0], decoded["cpu"][0]))
    dec_rel = rel_l2(decoded["kernel"][1], decoded["cpu"][1])
    print(f"phase 18 tiny fp32 paged engine ({len(prompts)} prompts, page size {PAGE_SIZE}) "
          f"on the card vs the CPU: tokens equal {paged_same}, next-token logits after the "
          f"first window rel_l2={paged_rel:.3e}; generate(decode_impl='kernel'): tokens equal "
          f"{dec_same}, their logprobs rel_l2={dec_rel:.3e} (tol {FP32_TOL}) | {card}",
          flush=True)
    if not (paged_same and dec_same and paged_rel <= FP32_TOL and dec_rel <= FP32_TOL
            and torch.isfinite(paged["kernel"][1]).all()):
        raise AssertionError(f"phase 18: the tiny fp32 paged engine or head-major decode on "
                             f"the card disagrees with the CPU: paged tokens {paged_same}, "
                             f"logits {paged_rel}; decode tokens {dec_same}, logprobs {dec_rel}")
    print(f"phase 18 tiny fp32 on the card vs the CPU: prefill logits rel_l2={rel:.3e} (tol "
          f"{FP32_TOL}); {TINY_NEW_TOKENS} greedy tokens equal: {same}; SFT step loss "
          f"{loss:.6f} vs {ref_loss:.6f} (rel {loss_rel:.3e}, tol {FP32_TOL}), grad_norm "
          f"{norm:.6e} vs {ref_norm:.6e} (rel {norm_rel:.3e}, tol 1e-3); launches {launches} "
          f"| {card}", flush=True)
    if not (torch.isfinite(logits["kernel"]).all() and rel <= FP32_TOL and same
            and loss_rel <= FP32_TOL and norm_rel <= 1e-3):
        raise AssertionError(f"phase 18: the tiny fp32 model on the card disagrees with the "
                             f"CPU: logits {rel}, tokens equal {same}, loss {loss_rel}, "
                             f"grad_norm {norm_rel}")
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"phase 18: the tiny path launched no kernel of {launches}")
    tiny_eval_check(models, tok, card)
    verify, verify_launches = tiny_spec_check(models["kernel"], tok, card)     # 22(b)
    launches.update(verify_launches)
    return {**{f"{n}_fp32": r for n, r in results.items()}, **verify}, launches


def moe_bound(rows: int, n_experts: int, H: int, I: int, variant: str) -> dict:
    """The least time for the grouped FFN: each routed expert's three
    matrices read once (with their scales), the routed rows' x read and y
    written once; 6 H I operations per routed row at the bf16 rate (the
    int8 rate for W8A8, the fp32 CUDA-core rate for fp32)."""
    welem = {"bf16": 2, "fp32": 4}.get(variant, 1)
    xelem, yelem = {"w8a8": (1, 4), "fp32": (4, 4)}.get(variant, (2, 2))
    nbytes = (n_experts * 3.0 * H * I * welem + rows * H * (xelem + yelem)
              + (n_experts * 4.0 * (2 * I + H) if variant in ("int8", "w8a8") else 0)
              + (4.0 * rows if variant == "w8a8" else 0))
    flops = 6.0 * rows * H * I
    t_ops = flops / {"w8a8": PEAK_INT8, "fp32": PEAK_FP32}.get(variant, PEAK_BF16)
    t_mem = nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def grouped_mm_library(x, topi, leaves, E: int):
    """The library yardstick of the bf16 FFN: three torch._grouped_mm calls
    and the SwiGLU over the routed rows sorted by expert. Returns a
    callable, or None where the card's torch has no _grouped_mm that takes
    these operands (probed once, on these inputs)."""
    import torch
    import torch.nn.functional as F

    if not hasattr(torch, "_grouped_mm"):
        return None
    k = topi.shape[-1]
    flat = topi.reshape(-1)
    xr = x.repeat_interleave(k, dim=0)[torch.argsort(flat, stable=True)].contiguous()
    offs = torch.cumsum(torch.bincount(flat, minlength=E), 0).int()
    wg, wu, wd = (leaves[n]["kernel"] for n in ("gate", "up", "down"))

    def run():
        h = F.silu(torch._grouped_mm(xr, wg, offs=offs)) * torch._grouped_mm(xr, wu, offs=offs)
        return torch._grouped_mm(h, wd, offs=offs)

    try:           # a capability probe of the yardstick, not of the port
        run()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        print(f"torch._grouped_mm does not take these operands ({str(e)[:160]}); "
              f"no library time", flush=True)
        return None
    return run


def ffn_launch_line(variant: str, A: int, C: int, H: int, I: int) -> str:
    """The grouped FFN's kernels for one call: the path, tile widths, blocks
    of each launch and their registers (ptxas)."""
    from video_r2_tpu_torch.ops.moe_ragged import ffn_kernel_path

    mode = {"bf16": 0, "fp32": 0, "int8": 1, "w8a8": 2}[variant]
    path, tiles = ffn_kernel_path(mode, C, H, I, variant == "fp32")
    if path == 3:
        zt = A * -(-C // 64)
        return (f"fp32 (CUDA cores): 64 rows x 64 columns a block, gate / up "
                f"{zt * (I // 64)} blocks, down {zt * (H // 64)} blocks")
    if path == 2:
        rows, gu, dn = tiles
        nt = rows // 8
        box = 128 if mode == 1 else 64       # a weight box's columns: 128 bytes
        kgu = f"moe_decode_kernel<{nt},{gu // box},2,{mode}>"
        kdn = f"moe_decode_kernel<{nt},{dn // box},1,{mode}>"
        return (f"decode ({variant}): tokens in boxes of {rows} rows; gate / up {gu} "
                f"columns of I, {A * -(-I // gu)} blocks, "
                f"{REGISTERS.get(kgu, 'registers not reported')}; down {dn} columns of H, "
                f"{A * -(-H // dn)} blocks, {REGISTERS.get(kdn, 'registers not reported')}")
    if path == 1 and mode:
        rows, gu, dn = tiles
        zt = A * (C // rows)
        kgu = f"moe_int8_wgmma_kernel<{mode},{rows},2,1>"
        kdn = f"moe_int8_wgmma_kernel<{mode},{rows},1,{dn // 128}>"
        return (f"int8 wgmma ({variant}): {rows} rows a block, weight columns as M from "
                f"registers; gate / up {gu} columns of I, {zt * -(-I // gu)} blocks, "
                f"{REGISTERS.get(kgu, 'registers not reported')}; down {dn} columns of H, "
                f"{zt * -(-H // dn)} blocks, {REGISTERS.get(kdn, 'registers not reported')}")
    if path == 1:
        rows, gu, dn = tiles
        wg = rows // 64
        zt = A * (C // rows)
        kgu, kdn = f"moe_gate_up_wgmma_kernel<{wg},{gu}>", f"moe_down_wgmma_kernel<{wg},{dn}>"
        return (f"wgmma: {rows} rows ({wg} warpgroups) a block; gate / up {gu} columns of "
                f"I, {zt * (I // gu)} blocks, {REGISTERS.get(kgu, 'registers not reported')}; "
                f"down {dn} columns of H, {zt * (H // dn)} blocks, "
                f"{REGISTERS.get(kdn, 'registers not reported')}")
    mt, wm = (1, 1) if C <= 16 else (2, 1) if C <= 32 else (4, 1) if C <= 64 else (4, 2)
    zt = A * -(-C // (16 * mt * wm))
    kgu, kdn = f"moe_gate_up_kernel<{mode},{mt},{wm}>", f"moe_down_kernel<{mode},{mt},{wm}>"
    return (f"mma.sync: {16 * mt * wm} rows a block; gate / up 64 columns of I, "
            f"{zt * (I // 64)} blocks, {REGISTERS.get(kgu, 'registers not reported')}; down "
            f"64 columns of H, {zt * (H // 64)} blocks, "
            f"{REGISTERS.get(kdn, 'registers not reported')}")


def gmm_dx_launch_line(n_blocks: int, bm: int, H: int, I: int) -> str:
    """The bf16 dX kernels for one call: tiles, blocks of each launch and
    their registers (ptxas)."""
    from video_r2_tpu_torch.ops.moe_gmm import gmm_bwd_dx_tiles

    rows, cols = gmm_bwd_dx_tiles(bm, H)
    wg, tiles = rows // 64, n_blocks * -(-bm // rows)
    kt, kd = f"gmm_bwd_terms_kernel<{wg}>", f"gmm_bwd_dx_kernel<{wg},{cols}>"
    return (f"wgmma: {rows} rows ({wg} warpgroups) a block; terms 64 columns of I, "
            f"{tiles * (I // 64)} blocks, {REGISTERS.get(kt, 'registers not reported')}; "
            f"dX {cols} columns of H, {tiles * (H // cols)} blocks, "
            f"{REGISTERS.get(kd, 'registers not reported')}")


def gmm_dw_launch_line(M: int, N: int, E: int, nb: int) -> str:
    """The bf16 weight-gradient kernel for nb outputs [E, M, N]: its tile,
    ring, persistent grid and registers / spills (ptxas)."""
    from video_r2_tpu_torch.ops.moe_gmm import gmm_bwd_dw_layout

    lay = gmm_bwd_dw_layout(M, N, E, nb)
    kernel = f"gmm_bwd_dw_wgmma_kernel<{lay['cols']},{nb}>"
    return (f"wgmma + TMA, persistent: tiles {lay['rows']} x {lay['cols']} ({nb} "
            f"accumulator{'s' if nb > 1 else ''} a warpgroup), {lay['stages']} stages of 64 "
            f"rows, {lay['smem']} bytes of shared memory; {lay['tiles']} tiles over "
            f"{lay['blocks']} blocks ({lay['tiles'] / lay['blocks']:.1f} a block); "
            f"{kernel}: {REGISTERS.get(kernel, 'registers not reported')}")


def moe_case(gen, layer, T: int, layout: str, variant: str, k: int = 8) -> dict:
    """The grouped FFN kernel at one judge shape (T tokens routed top k, in
    the ragged decode table or the GMM prefill blocks) against its plain
    version, with both times, the library call's and the bound; at decode
    (the ragged table) and for int8 weights or W8A8 also the device time (a
    CUDA graph); for int8 weights or W8A8 the bf16 kernel at the same
    routing beside it (no single PyTorch call computes either)."""
    import torch

    from video_r2_tpu_torch.models.moe import route
    from video_r2_tpu_torch.ops import moe_ragged
    from video_r2_tpu_torch.ops.moe_gmm import auto_block_rows, gmm_layout
    from video_r2_tpu_torch.ops.moe_ragged import (
        _block_i,
        quantize_rows,
        ragged_expert_ffn,
        ragged_expert_ffn_plain,
        ragged_layout,
    )

    router = layer["router"]
    leaves = layer["int8" if variant in ("int8", "w8a8") else variant]
    E, H, I = leaves["gate"][next(iter(leaves["gate"]))].shape
    x = torch.randn(T, H, generator=gen, device=gen.device)
    x = x if variant == "fp32" else x.to(torch.bfloat16)
    _, topi = route(router.to(x.dtype), x, k, True)
    if layout == "ragged":
        xs, ids, valid, _ = ragged_layout(x, topi, E)
    else:
        xs, ids, valid, _ = gmm_layout(x, topi, E, auto_block_rows(T * k, E))
    kw = {}
    xs_float = xs                    # the bf16 kernel's operand at the same routing
    if variant == "w8a8":
        xs, ax = quantize_rows(xs)
        kw["x_scales"] = ax
    g, u, d = (leaves[n] for n in ("gate", "up", "down"))
    bi = _block_i(xs, moe_ragged._weights(g, u, d)[1], kw.get("x_scales"), 512)
    before = ffn_launches()[variant]
    paths_before = dict(ffn_paths())
    run = lambda: ragged_expert_ffn(xs, ids, g, u, d, blk_valid=valid, **kw)  # noqa: E731
    plain = lambda: ragged_expert_ffn_plain(xs, ids, g, u, d, bi, valid,  # noqa: E731
                                            kw.get("x_scales"))
    out, ref = run(), plain()
    err, excess = compare(out, ref, tol=FP32_TOL if variant == "fp32" else KERNEL_ATOL)
    library = grouped_mm_library(x, topi, leaves, E) if variant == "bf16" else None
    n_exp = int(torch.unique(topi).numel())
    A, C = xs.shape[:2]
    slack = int((valid == 0).sum())
    r = {"max_abs_err": err, "excess": excess, "ms": cuda_ms(run),
         "plain_ms": cuda_ms(plain, iters=3, warmup=1),
         "library_ms": cuda_ms(library) if library is not None else None,
         **moe_bound(T * k, n_exp, H, I, variant)}
    if layout == "ragged" or variant in ("int8", "w8a8"):
        r["device_ms"] = graph_ms(run)
    if variant in ("int8", "w8a8"):   # the bf16 kernel at the same routing, and its bound
        bg, bu, bd = (layer["bf16"][n] for n in ("gate", "up", "down"))
        same = lambda: ragged_expert_ffn(xs_float, ids, bg, bu, bd, blk_valid=valid)  # noqa: E731
        r["bf16_kernel_ms"], r["bf16_kernel_device_ms"] = cuda_ms(same), graph_ms(same)
        r["bf16_bound_ms"] = moe_bound(T * k, n_exp, H, I, "bf16")["bound_ms"]
    if layout == "ragged":
        if library is not None:
            try:       # a capability probe of the yardstick, not of the port
                r["library_device_ms"] = graph_ms(library)
            except RuntimeError as e:
                print(f"torch._grouped_mm does not capture in a CUDA graph ({str(e)[:160]}); "
                      f"no library device time", flush=True)
    name = f"moe_ffn_{variant}_{layout}"
    what = f"{variant} {'ragged decode' if layout == 'ragged' else 'GMM prefill'}, T={T}"
    paths = {f"path{pth}": n - paths_before.get((v, pth), 0)
             for (v, pth), n in ffn_paths().items() if v == variant}
    report(name, what, (A, C, H, I), experts=n_exp, slack_blocks=slack, bi=bi,
           launches=ffn_launches()[variant] - before, launches_by_path=paths,
           **{k_: v for k_, v in r.items() if v is not None},
           **({"library": "none: no single PyTorch call computes it"}
              if variant in ("int8", "w8a8") else {}))
    if not (torch.isfinite(out).all() and excess <= 1.0 and not out[valid == 0].any()):
        raise AssertionError(f"{name} [{what}] disagrees with its plain version: "
                             f"{excess} x the tolerance")
    return {**r, "blocks": A, "rows": C}


def moe_ffn_case(gen, layer, T: int, layout: str, variant: str, k: int = 8) -> dict:
    """moe_case, then the kernels it ran: path, tiles, blocks, registers."""
    r = moe_case(gen, layer, T, layout, variant, k)
    H, I = layer["bf16"]["gate"]["kernel"].shape[1:]
    launch = ffn_launch_line(variant, r["blocks"], r["rows"], H, I)
    print(f"moe_ffn_{variant}_{layout} T={T}: {launch}", flush=True)
    return r


def moe_kernel_phase(device) -> dict:
    """Phase 10: the grouped FFN at the judge's shapes, one full layer's
    weights (bf16, and their int8 quantization): first the table's shapes
    (T = 16 decode, T = 4096 prefill; these give the kernels line), then the
    token counts phase 11's passes give it (the bf16 burst's prefill, the
    int8 pass's prefill and decode, the paged pass's decode), phase 22(c)'s
    verify passes and phase 15's LoRA step (its 2 x 1024 tokens, bf16)."""
    import torch

    from video_r2_tpu_torch.engine.chat import ByteTokenizer, pack_prompts
    from video_r2_tpu_torch.models.config import qwen3_moe_30b_a3b
    from video_r2_tpu_torch.models.quant import quantize_kernel

    tc = qwen3_moe_30b_a3b().text
    E, H, I = tc.num_experts, tc.hidden_size, tc.moe_intermediate_size
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    randw = lambda *s: (torch.randn(*s, generator=gen, device=device)  # noqa: E731
                        * s[-2] ** -0.5).to(torch.bfloat16)
    bf16 = {"gate": {"kernel": randw(E, H, I)}, "up": {"kernel": randw(E, H, I)},
            "down": {"kernel": randw(E, I, H)}}
    layer = {"router": randw(H, E), "bf16": bf16,
             "int8": {n: quantize_kernel(leaf["kernel"]) for n, leaf in bf16.items()}}
    results = {}
    for T, layout, variant in ((MOE_DECODE_T, "ragged", "bf16"),
                               (MOE_PREFILL_T, "gmm", "bf16"),
                               (MOE_DECODE_T, "ragged", "int8"),
                               (MOE_PREFILL_T, "gmm", "int8"),
                               (MOE_PREFILL_T, "gmm", "w8a8")):
        results[f"moe_ffn_{variant}_{layout}"] = moe_ffn_case(gen, layer, T, layout, variant)
    # the fp32 instance (fp32 x over fp32 weights): decode and a GMM prefill
    layer["fp32"] = {n: {"kernel": leaf["kernel"].float()} for n, leaf in bf16.items()}
    for T, layout in ((MOE_DECODE_T, "ragged"), (FP32_MOE_T, "gmm")):
        moe_ffn_case(gen, layer, T, layout, "fp32")
    del layer["fp32"]
    # phase 11's token counts: a burst's prompts right-padded to one width
    ids = judge_prompt_ids(ByteTokenizer(), judge_requests())
    burst = lambda n: n * pack_prompts(ids[:n], pad_id=0).input_ids.shape[1]  # noqa: E731
    for T, layout, variant in ((burst(JUDGE_REQUESTS), "gmm", "bf16"),
                               (burst(JUDGE_INT8_REQUESTS), "gmm", "w8a8"),
                               (JUDGE_INT8_REQUESTS, "ragged", "int8"),
                               (JUDGE_PAGED_REQUESTS, "ragged", "int8"),
                               # phase 22(c)'s verify passes: every served
                               # slot's K + 1 tokens, and one slot's
                               (SERVE_SLOTS * (SPEC_K + 1), "gmm", "int8"),
                               (SPEC_K + 1, "ragged", "int8"),
                               (MOE_LORA_B * MOE_LORA_S, "gmm", "bf16")):
        moe_ffn_case(gen, layer, T, layout, variant)
    return results


def judge_requests() -> list[tuple[str, str]]:
    """16 TAC-style (system, user) pairs: the rubric and a think / answer
    excerpt, whole sentences up to the first past 512 + 30 i bytes."""
    out = []
    for i in range(JUDGE_REQUESTS):
        target = 512 + 30 * i
        head = f"Question {i}: what does the person do with the cup? Model output: <think>"
        tail = f"</think><answer>They drink from it ({i}).</answer>"
        think, j = "", i
        while len(JUDGE_SYSTEM) + len(head) + len(think) + len(tail) < target:
            think += JUDGE_STEPS[j % len(JUDGE_STEPS)] + " "
            j += 1
        out.append((JUDGE_SYSTEM, head + think + tail))
    return out


def judge_prompt_ids(tok, requests):
    """The ids ChatEngine renders for (system, user) pairs."""
    from video_r2_tpu_torch.engine.chat import render_messages

    return [tok.encode(render_messages([{"role": "system", "content": s},
                                        {"role": "user", "content": u}],
                                       add_generation_prompt=True, default_system=None))
            for s, u in requests]


def judge_logits(model, ids, attn_impl, act_quant=None, token=None):
    """Last-token logits [B, V] after the right-padded prompts ids (and, with
    token [B], after one more decode step of that token)."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.engine.chat import pack_prompts
    from video_r2_tpu_torch.engine.generate import decode_step_logits, prefill
    from video_r2_tpu_torch.models.decoder import KVCache

    cfg, dev = model.cfg, model.device
    packed = pack_prompts(ids, pad_id=cfg.pad_token_id)
    B, S = packed.input_ids.shape
    lengths = torch.as_tensor(packed.lengths, dtype=torch.int32, device=dev)
    pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S))
    cache = KVCache.init(cfg.text, B, S + 1, torch.bfloat16, dev)
    with torch.inference_mode():
        logits = prefill(model, torch.as_tensor(packed.input_ids, device=dev).long(),
                         torch.as_tensor(pos.copy(), device=dev).long(), lengths, cache,
                         attn_impl=attn_impl, act_quant=act_quant)
        if token is None:
            return logits
        return decode_step_logits(model, token, lengths.long(), cache, lengths, S, 0,
                                  act_quant=act_quant)


def set_kernel_impl(model, impl: str) -> None:
    """"kernel" or "plain" for every kernel choice the model's modules hold:
    the grouped FFN (MoE MLPs), the int4 and int8 matmuls (linears) and the
    decode step's attention (the decoder)."""
    for mod in model.modules():
        for attr in ("ffn_impl", "int4_impl", "int8_impl", "decode_attn_impl"):
            if hasattr(mod, attr):
                setattr(mod, attr, impl)


class FfnRecorder:
    """Stands in for the grouped FFN wrapper (ops/moe_ragged.py, and its
    import in ops/moe_gmm.py) while a judge pass runs: every call goes to
    the wrapper, and the first call of each (variant, A blocks, C rows) is
    noted. With keep=True it also keeps that call's operands, so `check`
    can hold the kernel against its plain version on exactly those inputs;
    a timed pass runs with keep=False (a dict insert per call, no copies, no
    memory), and a short replay of it (the same prompts, 2 new tokens: its
    prefill and a decode step) with keep=True. Shares the wrapper's launch
    counts, by variant and by (variant, csrc/moe_ffn.cu path) in `paths`
    (the wrapper counts them through the name this stand-in takes)."""

    def __init__(self, keep: bool):
        from video_r2_tpu_torch.ops import moe_ragged

        self.real = moe_ragged.ragged_expert_ffn
        self.launches = self.real.launches
        self.paths = self.real.paths
        self.keep = keep
        self.calls = {}

    def __call__(self, x, ids, gate, up, down, block_i=512, blk_valid=None, x_scales=None):
        variant = "w8a8" if x_scales is not None else "int8" if "kernel_q" in gate else "bf16"
        key = (variant, *x.shape[:2])
        if key not in self.calls:
            keep = lambda t: None if t is None else t.clone()  # noqa: E731
            self.calls[key] = (keep(x), keep(ids), gate, up, down, block_i,
                               keep(blk_valid), keep(x_scales)) if self.keep else None
        return self.real(x, ids, gate, up, down, block_i=block_i, blk_valid=blk_valid,
                         x_scales=x_scales)

    def _patch(self, fn) -> None:
        from video_r2_tpu_torch.ops import moe_gmm, moe_ragged

        moe_ragged.ragged_expert_ffn = moe_gmm.ragged_expert_ffn = fn

    def __enter__(self):
        self._patch(self)
        return self

    def __exit__(self, *exc):
        self._patch(self.real)

    def check(self, what: str, timed: FfnRecorder) -> None:
        """Each kept call through the kernel against the plain version;
        raises on a disagreement, or where the timed pass gave the kernel a
        shape this replay did not. Drops the kept operands."""
        import torch

        if not set(timed.calls) <= set(self.calls):
            raise AssertionError(f"{what}: the replay gave the grouped FFN "
                                 f"{sorted(self.calls)}, the timed pass {sorted(timed.calls)}")
        from video_r2_tpu_torch.ops.moe_ragged import (
            _block_i,
            _weights,
            ragged_expert_ffn_plain,
        )

        for (variant, A, C), (x, ids, g, u, d, block_i, valid, xs) in sorted(
                self.calls.items()):
            out = self.real(x, ids, g, u, d, block_i=block_i, blk_valid=valid, x_scales=xs)
            bi = _block_i(x, _weights(g, u, d)[1], xs, block_i)
            ref = ragged_expert_ffn_plain(x, ids, g, u, d, bi, valid, xs)
            err, excess = compare(out, ref)
            slack = valid == 0 if valid is not None else torch.zeros(A, dtype=torch.bool,
                                                                     device=x.device)
            print(f"{what}: grouped FFN call {variant} [A={A}, C={C}] (its first layer's "
                  f"operands) vs plain: max_abs_err={err:.4e} ({excess:.3f} x the tolerance), "
                  f"slack blocks {int(slack.sum())}", flush=True)
            if not (torch.isfinite(out).all() and excess <= 1.0 and not out[slack].any()):
                raise AssertionError(f"{what}: grouped FFN {variant} [A={A}, C={C}] disagrees "
                                     f"with its plain version: {excess} x the tolerance")
        self.calls.clear()


def split_launches(launches: dict, at_decode: dict, variant: str) -> tuple[int, int]:
    """(prefill, decode) launches of one FFN variant in a pass (launches as
    read_launches gives them), from its count when the first decode step
    began: the prefill runs the GMM blocks, the decode steps the ragged
    table."""
    total = launches[f"moe_ffn_{variant}"]
    pre = at_decode.get(variant, total)
    return pre, total - pre


def profile_decode_step(model, batch: int):
    """One decode step of `batch` tokens over a cache of 1088 keys under
    torch.profiler: (kernel launches, device busy ms, wall ms), or None
    where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from video_r2_tpu_torch.models.decoder import KVCache
    from video_r2_tpu_torch.models.model import lm_head
    from video_r2_tpu_torch.models.mrope import mrope_cos_sin

    cfg, dev = model.cfg, model.device
    S = 1088
    cache = KVCache.init(cfg.text, batch, S + 1, torch.bfloat16, dev)
    tok = torch.arange(batch, device=dev) + 1000
    pos3 = torch.full((3, batch, 1), S, device=dev)

    def step():
        with torch.inference_mode():
            emb = model.model.embed_tokens(tok)[:, None]
            cos, sin = mrope_cos_sin(pos3, cfg, dtype=emb.dtype)
            bias = torch.zeros((batch, 1, 1, S + 1), device=dev)
            h = model.model(emb, cos, sin, bias, cache=cache, cache_position=S)
            return lm_head(model, h[:, 0]).float().argmax(-1)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3 if kernels else 0.0
    del cache
    return (len(kernels), busy, wall * 1e3) if kernels else None

def gmm_bwd_bounds(R: int, n_exp: int, E: int, H: int, I: int) -> dict:
    """The least time of each GMM backward wrapper on its own inputs, for R
    routed rows and n_exp routed experts, and of the whole backward (the
    routed experts' weights read once, rows read once, outputs written
    once; bf16 operands, fp32 dX, dW in the weights' bf16 (2 bytes, as
    torch._grouped_mm writes them); at the bf16 rate)."""
    w = n_exp * 3.0 * H * I * 2
    return {"moe_gmm_bwd_dx": bound(10.0 * R * H * I, w + R * H * (2 + 2 + 4)),
            "moe_gmm_bwd_dw": bound(4.0 * R * H * I, R * (H + 2 * I) * 2 + 2.0 * E * H * I * 2),
            "moe_gmm_bwd_dwd": bound(2.0 * R * H * I, R * (I + H) * 2 + E * I * H * 2),
            "backward": bound(16.0 * R * H * I, w + 3.0 * E * H * I * 2 + R * H * (2 + 2 + 4))}


def gmm_bwd_library(xs, dg, du, h, dYs, wg, wu, wd, run):
    """The library yardstick of the GMM backward kernels: torch._grouped_mm
    calls over each expert's run of rows (run: rows per expert, the valid
    prefix of the layout) that compute what each wrapper computes. dX, as
    gmm_bwd_dx, from x and dY: g = x Wg, u = x Wu and dh = dY Wd^T (three
    2d x 3d calls), the SwiGLU terms du = dh silu(g) and dg = dh u silu'(g)
    in fp32 torch ops rounded to bf16, then dX = dg Wg^T + du Wu^T (two
    more); dWg / dWu = x^T dg / x^T du and dWd = h^T dY (2d x 2d calls
    grouped along the rows) from the dg / du / h already formed, as the dW
    wrappers take them. Returns {kernel name: callable or None}; None where
    the card's torch does not take the operands (probed once, the reason
    printed)."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        print("torch has no _grouped_mm: no library time for the GMM backward", flush=True)
        return dict.fromkeys(("moe_gmm_bwd_dx", "moe_gmm_bwd_dw", "moe_gmm_bwd_dwd"))
    offs = torch.cumsum(run, 0).int()
    total = int(offs[-1])
    xr, dgr, dur, hr, dyr = (t.reshape(-1, t.shape[-1])[:total] for t in (xs, dg, du, h, dYs))
    # layouts made once, untimed: x^T and h^T row-major, and column-major
    # copies of the row operands in case the 2d x 2d form wants those
    xT, hT = xr.t().contiguous(), hr.t().contiguous()
    cm = lambda t: t.t().contiguous().t()  # noqa: E731
    dgc, duc, dyc = cm(dgr), cm(dur), cm(dyr)
    wgT, wuT, wdT = wg.transpose(1, 2), wu.transpose(1, 2), wd.transpose(1, 2)
    mm = torch._grouped_mm

    def dx():
        g, u, dh = mm(xr, wg, offs=offs), mm(xr, wu, offs=offs), mm(dyr, wdT, offs=offs)
        gf, dhf = g.float(), dh.float()
        s = torch.sigmoid(gf)
        du_ = (dhf * gf * s).to(g.dtype)
        dg_ = (dhf * u.float() * s * (1.0 + gf * (1.0 - s))).to(g.dtype)
        return mm(dg_, wgT, offs=offs) + mm(du_, wuT, offs=offs)

    candidates = {
        "moe_gmm_bwd_dx": [dx],
        "moe_gmm_bwd_dw": [lambda: (mm(xT, dgr, offs=offs), mm(xT, dur, offs=offs)),
                           lambda: (mm(xT, dgc, offs=offs), mm(xT, duc, offs=offs))],
        "moe_gmm_bwd_dwd": [lambda: mm(hT, dyr, offs=offs), lambda: mm(hT, dyc, offs=offs)],
    }
    out = {}
    for name, fns in candidates.items():
        out[name] = None
        for fn in fns:
            try:       # a capability probe of the yardstick, not of the port
                fn()
                torch.cuda.synchronize()
                out[name] = fn
                break
            except (RuntimeError, TypeError) as e:
                reason = str(e)[:160]
        if out[name] is None:
            print(f"torch._grouped_mm does not take the operands of {name} ({reason}); "
                  f"no library time", flush=True)
    return out


def gmm_bwd_phase(card: str, device) -> dict:
    """Phase 14: the GMM backward kernels at the judge's shapes. One seeded
    judge-width MoE layer (MoEMLP, scaled like init_params), expert
    ABSENT_EXPERT's router column zero; T = 4096 tokens under autograd with
    the router and the experts trained, loss = sum(out * cot): every
    gradient of the kernel path against the plain path (ffn_impl="plain"),
    the absent expert's dW exactly 0, the launches of that run; then each
    kernel against its plain version on the same operands, timed, with its
    bound and the library call; the whole backward timed; the dX kernel
    again at phase 15's token count. Returns the kernels-line entries."""
    import torch

    from video_r2_tpu_torch.models.config import qwen3_moe_30b_a3b
    from video_r2_tpu_torch.models.decoder import MoEMLP
    from video_r2_tpu_torch.models.moe import route
    from video_r2_tpu_torch.ops import moe_gmm as gmm

    tc = qwen3_moe_30b_a3b().text
    E, H, I, k = (tc.num_experts, tc.hidden_size, tc.moe_intermediate_size,
                  tc.num_experts_per_tok)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    mod = MoEMLP(tc, dtype=torch.bfloat16, device=device)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, p.shape[-2] ** -0.5, generator=gen)
        mod.router.kernel[:, ABSENT_EXPERT] = 0.0
    mod.requires_grad_(True)
    bf = lambda *s: torch.randn(*s, generator=gen, device=device).to(torch.bfloat16)  # noqa: E731
    T = GMM_BWD_T
    x, cot = bf(1, T, H).requires_grad_(), bf(1, T, H)
    leaves = [x, mod.router.kernel, mod.experts.gate.kernel, mod.experts.up.kernel,
              mod.experts.down.kernel]
    names = ("dX", "d_router", "dWg", "dWu", "dWd")
    grads = {}
    for impl in ("kernel", "plain"):
        mod.ffn_impl = impl
        reset_launches()
        out = mod(x)
        grads[impl] = torch.autograd.grad((out.float() * cot.float()).sum(), leaves)
        torch.cuda.synchronize()
        if impl == "kernel":
            launches = read_launches()
    mod.ffn_impl = "kernel"
    with torch.no_grad():
        xt = x.detach().reshape(T, H)
        topv, topi = route(mod.router.kernel, xt, k, True)
    counts = torch.bincount(topi.reshape(-1), minlength=E)
    errs = []
    for name, a, b in zip(names, grads["kernel"], grads["plain"]):
        errs.append(rel_l2(a, b))
        print(f"phase 14 gradient {name} {tuple(a.shape)}: kernel vs plain path rel_l2="
              f"{errs[-1]:.3e} (tol {GRAD_REL_L2})", flush=True)
    absent = [float(g[ABSENT_EXPERT].abs().max()) for impl in grads for g in grads[impl][2:]]
    print(f"phase 14: T={T}, experts routed {int((counts > 0).sum())} of {E}, expert "
          f"{ABSENT_EXPERT} rows {int(counts[ABSENT_EXPERT])}, its dW max |.| {max(absent)}; "
          f"launches {launches}", flush=True)
    if not (max(errs) <= GRAD_REL_L2 and counts[ABSENT_EXPERT] == 0 and max(absent) == 0.0
            and all(torch.isfinite(g).all() for g in grads["kernel"])):
        raise AssertionError(f"phase 14: the GMM backward kernels disagree with the plain "
                             f"path: rel L2 {errs}, absent expert dW {absent}")
    want = {"moe_gmm_bwd_dx": 1, "moe_gmm_bwd_dw": 1, "moe_gmm_bwd_dwd": 1, "moe_ffn_bf16": 2}
    if any(launches[n] != c for n, c in want.items()):
        raise AssertionError(f"phase 14: launches {launches}, expected {want}")
    del grads, out

    # each kernel on the backward's operands, against its plain version
    wg, wu, wd = (t.detach() for t in leaves[2:])
    bm = gmm.auto_block_rows(T * k, E)
    with torch.no_grad():
        xs, ids, valid, dst = gmm.gmm_layout(xt, topi, E, bm)
        dy_slot = cot.reshape(T, H).float().repeat_interleave(k, dim=0)
        dYs = gmm.sorted_dy(dy_slot, topv, dst, xs.shape, xs.dtype)
        del dy_slot
        dx, dg, du, h = gmm.gmm_bwd_dx(xs, dYs, ids, valid, wg, wu, wd, keep_h=True)
        pdx, pdg, pdu, ph = gmm.gmm_bwd_dx_plain(xs, dYs, ids, valid, wg, wu, wd, keep_h=True)
        terms = [compare(a, b)[1] for a, b in ((dg, pdg), (du, pdu), (h, ph))]
        dwg, dwu = gmm.gmm_bwd_dw(xs, dg, du, ids, valid, E)
        pwg, pwu = gmm.gmm_bwd_dw_plain(xs, dg, du, ids, valid, E)
        dwd = gmm.gmm_bwd_dwd(h, dYs, ids, valid, E)
        pwd = gmm.gmm_bwd_dwd_plain(h, dYs, ids, valid, E)
        torch.cuda.synchronize()
        checks = {"moe_gmm_bwd_dx": ((dx, pdx),), "moe_gmm_bwd_dw": ((dwg, pwg), (dwu, pwu)),
                  "moe_gmm_bwd_dwd": ((dwd, pwd),)}
        run = torch.zeros(E, dtype=torch.int32, device=device).index_add_(
            0, ids.long(), valid.int()) * bm
        library = gmm_bwd_library(xs, dg, du, h, dYs, wg, wu, wd, run)
        runs = {"moe_gmm_bwd_dx": (lambda: gmm.gmm_bwd_dx(xs, dYs, ids, valid, wg, wu, wd),
                                   lambda: gmm.gmm_bwd_dx_plain(xs, dYs, ids, valid, wg, wu, wd)),
                "moe_gmm_bwd_dw": (lambda: gmm.gmm_bwd_dw(xs, dg, du, ids, valid, E),
                                   lambda: gmm.gmm_bwd_dw_plain(xs, dg, du, ids, valid, E)),
                "moe_gmm_bwd_dwd": (lambda: gmm.gmm_bwd_dwd(h, dYs, ids, valid, E),
                                    lambda: gmm.gmm_bwd_dwd_plain(h, dYs, ids, valid, E))}
        bounds = gmm_bwd_bounds(T * k, int((counts > 0).sum()), E, H, I)
        print(f"phase 14 dW (dWg / dWu, [E, H, I] x 2): {gmm_dw_launch_line(H, I, E, 2)}; "
              f"dWd ([E, I, H]): {gmm_dw_launch_line(I, H, E, 1)}", flush=True)
        results = {}
        for name, (kern, plain) in runs.items():
            err = max(float((a.float() - b.float()).abs().max()) for a, b in checks[name])
            rel = max(rel_l2(a, b) for a, b in checks[name])
            lib = library[name]
            r = {"max_abs_err": err, "rel_l2": rel, "ms": cuda_ms(kern, iters=10),
                 "plain_ms": cuda_ms(plain, iters=2, warmup=1),
                 "library_ms": cuda_ms(lib, iters=10) if lib is not None else None,
                 "launches": launches[name], **bounds[name]}
            if name != "moe_gmm_bwd_dx":   # bf16 out: elementwise, and device times
                r["excess"] = max(compare(a, b)[1] for a, b in checks[name])
                r["device_ms"] = graph_ms(kern, iters=10)
                r["library_device_ms"] = graph_ms(lib, iters=10) if lib is not None else None
            report(name, f"GMM backward, T={T}", (xs.shape[0], bm, H, I),
                   **{n: v for n, v in r.items() if v is not None})
            results[name] = r
        slack = valid == 0
        print(f"phase 14 terms dg / du / h vs plain: {[f'{t:.3f}' for t in terms]} x the "
              f"tolerance; slack blocks {int(slack.sum())}; dX T={T}: "
              f"{gmm_dx_launch_line(xs.shape[0], bm, H, I)}", flush=True)
        zero_ok = not dx[slack].any() and not dg[slack].any()
        twice = (torch.equal(torch.stack(gmm.gmm_bwd_dw(xs, dg, du, ids, valid, E)),
                             torch.stack((dwg, dwu)))
                 and torch.equal(gmm.gmm_bwd_dwd(h, dYs, ids, valid, E), dwd))
        dw_ok = (max(results[n]["excess"] for n in ("moe_gmm_bwd_dw", "moe_gmm_bwd_dwd")) <= 1.0
                 and dwg.dtype == dwd.dtype == wg.dtype and twice)
        print(f"phase 14 dW / dWd: {dwg.dtype}, within {results['moe_gmm_bwd_dw']['excess']:.3f}"
              f" / {results['moe_gmm_bwd_dwd']['excess']:.3f} x the tolerance of the plain "
              f"versions' fp32 sums rounded once; a second call gives the same bits: {twice}",
              flush=True)
        if not (results["moe_gmm_bwd_dx"]["rel_l2"] <= GRAD_REL_L2 and max(terms) <= 1.0
                and zero_ok and dw_ok and not dwg[ABSENT_EXPERT].any()
                and not dwd[ABSENT_EXPERT].any()):
            raise AssertionError(f"phase 14: a GMM backward kernel disagrees with its plain "
                                 f"version: {results}, terms {terms}, same bits {twice}")
        del dx, dg, du, h, pdx, pdg, pdu, ph, dwg, dwu, pwg, pwu, dwd, pwd, library
        gmm_bwd_dw_bm48(xt, topv, topi, cot, wg, wu, wd)

    # the whole backward (the d_topv recompute, dY, dX, dW, the casts)
    out = mod(x)
    loss = (out.float() * cot.float()).sum()
    whole = cuda_ms(lambda: torch.autograd.grad(loss, leaves, retain_graph=True), iters=5,
                    warmup=1)
    print(f"phase 14 whole backward (T={T}, router and experts trained): {whole:.4f} ms, "
          f"bound {bounds['backward']['bound_ms']:.4f} ms ({bounds['backward']['bound_by']}) "
          f"| {card}", flush=True)
    del out, loss

    # dX at phase 15's token count
    T2 = MOE_LORA_B * MOE_LORA_S
    with torch.no_grad():
        xt2 = torch.randn(T2, H, generator=gen, device=device).to(torch.bfloat16)
        topv2, topi2 = route(mod.router.kernel, xt2, k, True)
        bm2 = gmm.auto_block_rows(T2 * k, E)
        xs2, ids2, valid2, dst2 = gmm.gmm_layout(xt2, topi2, E, bm2)
        dys2 = gmm.sorted_dy(torch.randn(T2 * k, H, generator=gen, device=device), topv2, dst2,
                             xs2.shape, xs2.dtype)
        got, dg2, du2, h2 = gmm.gmm_bwd_dx(xs2, dys2, ids2, valid2, wg, wu, wd, keep_h=True)
        ref = gmm.gmm_bwd_dx_plain(xs2, dys2, ids2, valid2, wg, wu, wd)[0]
        rel = rel_l2(got, ref)
        n2 = int(torch.unique(topi2).numel())
        b2 = gmm_bwd_bounds(T2 * k, n2, E, H, I)["moe_gmm_bwd_dx"]
        run2 = torch.zeros(E, dtype=torch.int32, device=device).index_add_(
            0, ids2.long(), valid2.int()) * bm2
        lib2 = gmm_bwd_library(xs2, dg2, du2, h2, dys2, wg, wu, wd, run2)["moe_gmm_bwd_dx"]
        del got, ref, dg2, du2, h2
        report("moe_gmm_bwd_dx", f"GMM backward at phase 15's T={T2}",
               (xs2.shape[0], bm2, H, I), rel_l2=rel,
               ms=cuda_ms(lambda: gmm.gmm_bwd_dx(xs2, dys2, ids2, valid2, wg, wu, wd), iters=10),
               plain_ms=cuda_ms(lambda: gmm.gmm_bwd_dx_plain(xs2, dys2, ids2, valid2, wg, wu,
                                                             wd), iters=2, warmup=1),
               **({"library_ms": cuda_ms(lib2, iters=10)} if lib2 is not None else {}), **b2)
        print(f"phase 14 dX T={T2}: {gmm_dx_launch_line(xs2.shape[0], bm2, H, I)}", flush=True)
        if not rel <= GRAD_REL_L2:
            raise AssertionError(f"phase 14: dX at T={T2} disagrees with plain: {rel}")
        del xs2, dys2, lib2
        gmm_bwd_fp32_case(gen, mod.router.kernel, wg, wu, wd)
    return results


def gmm_bwd_dw_bm48(xt, topv, topi, cot, wg, wu, wd) -> None:
    """Phase 14's tokens in a layout of 48-row blocks (expert runs that end
    inside a 64-row stage of the weight-gradient kernel), with NaN in every
    slack row of x, dY, dg, du and h: dW and dWd within the tolerance of
    their plain versions, finite (no stage added the next expert's rows or
    the slack rows)."""
    import torch

    from video_r2_tpu_torch.ops import moe_gmm as gmm

    E, H, I = wg.shape
    T, k = topi.shape
    with torch.no_grad():
        xs, ids, valid, dst = gmm.gmm_layout(xt, topi, E, 48)
        dys = gmm.sorted_dy(cot.reshape(T, H).float().repeat_interleave(k, dim=0), topv, dst,
                            xs.shape, xs.dtype)
        slack = valid == 0
        xs[slack], dys[slack] = float("nan"), float("nan")
        _, dg, du, h = gmm.gmm_bwd_dx(xs, dys, ids, valid, wg, wu, wd, keep_h=True)
        for t in (dg, du, h):
            t[slack] = float("nan")
        got = (*gmm.gmm_bwd_dw(xs, dg, du, ids, valid, E), gmm.gmm_bwd_dwd(h, dys, ids, valid, E))
        ref = (*gmm.gmm_bwd_dw_plain(xs, dg, du, ids, valid, E),
               gmm.gmm_bwd_dwd_plain(h, dys, ids, valid, E))
        excess = [compare(a, b)[1] for a, b in zip(got, ref)]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        print(f"phase 14 dW at bm 48 ({int(slack.sum())} slack blocks of NaN): dWg / dWu / dWd "
              f"within {[f'{e:.3f}' for e in excess]} x the tolerance, finite {finite}",
              flush=True)
        if not (max(excess) <= 1.0 and finite):
            raise AssertionError(f"phase 14: dW at bm 48 disagrees with its plain version: "
                                 f"{excess}, finite {finite}")


def gmm_bwd_fp32_case(gen, router, wg, wu, wd) -> None:
    """The fp32 instances of the three GMM backward kernels at the judge's
    widths, FP32_MOE_T tokens: fp32 copies of phase 14's weights, x and dY;
    each output within FP32_TOL of its plain version (dg / du / h, dX, dWg /
    dWu, dWd), timed beside it."""
    import torch

    from video_r2_tpu_torch.models.moe import route
    from video_r2_tpu_torch.ops import moe_gmm as gmm

    E, H, I = wg.shape
    T, k = FP32_MOE_T, 8
    wg, wu, wd = wg.float(), wu.float(), wd.float()
    with torch.no_grad():
        x = torch.randn(T, H, generator=gen, device=gen.device)
        topv, topi = route(router.float(), x, k, True)
        bm = gmm.auto_block_rows(T * k, E)
        xs, ids, valid, dst = gmm.gmm_layout(x, topi, E, bm)
        dys = gmm.sorted_dy(torch.randn(T * k, H, generator=gen, device=gen.device), topv, dst,
                            xs.shape, xs.dtype)
        dx, dg, du, h = gmm.gmm_bwd_dx(xs, dys, ids, valid, wg, wu, wd, keep_h=True)
        pdx, pdg, pdu, ph = gmm.gmm_bwd_dx_plain(xs, dys, ids, valid, wg, wu, wd, keep_h=True)
        dwg, dwu = gmm.gmm_bwd_dw(xs, dg, du, ids, valid, E)
        pwg, pwu = gmm.gmm_bwd_dw_plain(xs, dg, du, ids, valid, E)
        dwd = gmm.gmm_bwd_dwd(h, dys, ids, valid, E)
        pwd = gmm.gmm_bwd_dwd_plain(h, dys, ids, valid, E)
        torch.cuda.synchronize()
        cases = {"moe_gmm_bwd_dx": (((dx, pdx), (dg, pdg), (du, pdu), (h, ph)),
                                    lambda: gmm.gmm_bwd_dx(xs, dys, ids, valid, wg, wu, wd),
                                    lambda: gmm.gmm_bwd_dx_plain(xs, dys, ids, valid, wg, wu,
                                                                 wd)),
                 "moe_gmm_bwd_dw": (((dwg, pwg), (dwu, pwu)),
                                    lambda: gmm.gmm_bwd_dw(xs, dg, du, ids, valid, E),
                                    lambda: gmm.gmm_bwd_dw_plain(xs, dg, du, ids, valid, E)),
                 "moe_gmm_bwd_dwd": (((dwd, pwd),),
                                     lambda: gmm.gmm_bwd_dwd(h, dys, ids, valid, E),
                                     lambda: gmm.gmm_bwd_dwd_plain(h, dys, ids, valid, E))}
        for name, (pairs, kern, plain) in cases.items():
            errs = [compare(a, b, tol=FP32_TOL) for a, b in pairs]
            excess = max(e[1] for e in errs)
            report(name, f"GMM backward, fp32, T={T}", (xs.shape[0], bm, H, I),
                   max_abs_err=max(e[0] for e in errs), excess=excess,
                   ms=cuda_ms(kern, iters=3, warmup=1), plain_ms=cuda_ms(plain, iters=2, warmup=1))
            if not (excess <= 1.0 and all(torch.isfinite(a).all() for a, _ in pairs)):
                raise AssertionError(f"phase 14: the fp32 {name} kernel disagrees with its "
                                     f"plain version: {excess} x FP32_TOL")


def moe_lora_batch(tok, cfg, device) -> dict:
    """MOE_LORA_B records of the judge's requests: the rendered prompt
    (masked from the loss) and a verdict answer ending in <|im_end|>
    (labelled), right-padded to MOE_LORA_S."""
    import torch

    from video_r2_tpu_torch.engine.chat import IM_END

    B, S = MOE_LORA_B, MOE_LORA_S
    answer = tok.encode(JUDGE_ANSWER + IM_END)
    ids = torch.full((B, S), cfg.pad_token_id, dtype=torch.long)
    labels = torch.full((B, S), -100, dtype=torch.long)
    mask = torch.zeros((B, S), dtype=torch.int32)
    for b, prompt in enumerate(judge_prompt_ids(tok, judge_requests()[:B])):
        row = prompt + answer
        if len(row) > S:
            raise AssertionError(f"judge record {b}: {len(row)} tokens > {S}")
        ids[b, :len(row)] = torch.tensor(row)
        labels[b, len(prompt):len(row)] = torch.tensor(answer)
        mask[b, :len(row)] = 1
    pos = torch.arange(S).expand(3, B, S).contiguous()
    return {"input_ids": ids.to(device), "labels": labels.to(device),
            "attention_mask": mask.to(device), "position_ids": pos.to(device)}


def moe_training_phase(model, cfg, tok, card: str) -> dict:
    """Phase 15: LoRA SFT (r 64, alpha 64, the default targets) over the
    bf16 judge in place: the flash training kernels at the batch's shape
    against their plain versions; step-1 loss and adapter gradients, kernel
    path vs plain path, and the kernel path with the dX kernel's output
    zeroed as a control the bound must see; then MOE_LORA_STEPS steps of
    make_lora_sft_step with the launch counts set to 0 before and read after
    (the GMM dX kernel once a MoE layer a step, no dW kernel). Leaves the
    model without adapters. Returns the dX kernel's launches."""
    import dataclasses

    import numpy as np
    import torch

    from video_r2_tpu_torch.ops import moe_gmm as gmm
    from video_r2_tpu_torch.train.lora import (
        LoRAConfig,
        attach_lora,
        detach_lora,
        init_lora,
        lora_param_count,
    )
    from video_r2_tpu_torch.train.optim import OptimConfig
    from video_r2_tpu_torch.train.sft import (
        SFTConfig,
        init_train_state,
        make_lora_sft_step,
        sft_loss,
    )

    batch = moe_lora_batch(tok, cfg, model.device)
    n_tok = int(batch["attention_mask"].sum())
    L = cfg.text.num_hidden_layers
    lcfg = LoRAConfig()
    params = attach_lora(model, init_lora(model, lcfg, seed=SEED), lcfg)
    scfg = SFTConfig(attn_impl="flash", gradient_checkpointing=True)
    print(f"phase 15 batch: B={MOE_LORA_B}, padded to {MOE_LORA_S}, real tokens "
          f"{batch['attention_mask'].sum(-1).tolist()}, labelled "
          f"{int((batch['labels'] != -100).sum())}; {lora_param_count(params) / 1e6:.1f} M "
          f"adapter params over {L} layers", flush=True)

    # the flash training kernels at the step's attention shape and lengths
    tc = cfg.text
    gen = torch.Generator(device=model.device).manual_seed(SEED + 5)
    randn = lambda *s: torch.randn(*s, generator=gen, device=model.device).to(  # noqa: E731
        torch.bfloat16)
    B, S = batch["input_ids"].shape
    q, k, v = randn(B, S, tc.num_attention_heads, tc.head_dim), *(
        randn(B, S, tc.num_key_value_heads, tc.head_dim) for _ in range(2))
    flash_case(gen, "judge training", q, k, v, batch["attention_mask"].sum(-1).int(), True,
               None, training=True)
    del q, k, v

    real_dx = gmm._bwd_dx_cuda

    def zero_dx(*args):            # the control: the dX kernel's output zeroed
        dx, *rest = real_dx(*args)
        return (torch.zeros_like(dx), *rest)

    out = {}
    for impl, attn in (("kernel", "flash"), ("plain", "xla"), ("control", "flash")):
        set_kernel_impl(model, "plain" if impl == "plain" else "kernel")
        gmm._bwd_dx_cuda = zero_dx if impl == "control" else real_dx
        for p in params.values():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            loss = sft_loss(model, batch, dataclasses.replace(scfg, attn_impl=attn))
            loss.backward()
        finally:
            gmm._bwd_dx_cuda = real_dx
        grads = torch.cat([p.grad.flatten() for p in params.values()])
        torch.cuda.synchronize()
        out[impl] = (loss.item(), grads, time.perf_counter() - t0)
    set_kernel_impl(model, "kernel")
    (lk, gk, tk), (lp, gp, tp) = out["kernel"], out["plain"]
    loss_rel, grad_rel = abs(lk - lp) / abs(lp), rel_l2(gk, gp)
    control_rel = rel_l2(out["control"][1], gp)
    print(f"phase 15 step 1: loss kernel {lk:.6f} plain {lp:.6f} (rel {loss_rel:.3e}, tol "
          f"{PATH_LOSS_RTOL}); adapter gradients rel L2 {grad_rel:.3e} (tol "
          f"{PATH_GRAD_REL_L2}), |g| {float(gp.norm()):.4e}; fwd+bwd s kernel {tk:.3f} "
          f"plain {tp:.3f}; control (dX zeroed) rel L2 {control_rel:.3e}", flush=True)
    if not (np.isfinite(lk) and loss_rel <= PATH_LOSS_RTOL and grad_rel <= PATH_GRAD_REL_L2
            and torch.isfinite(gk).all()):
        raise AssertionError(f"phase 15: kernel path disagrees with the plain path: loss rel "
                             f"{loss_rel}, gradient rel L2 {grad_rel}")
    if not control_rel > PATH_GRAD_REL_L2:
        raise AssertionError(f"phase 15: the bound {PATH_GRAD_REL_L2} does not see a zeroed "
                             f"dX: control rel L2 {control_rel}")
    del out, gk, gp

    state = init_train_state(params, OptimConfig())
    step = make_lora_sft_step(model, scfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses = [], []
    for _ in range(MOE_LORA_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (t, loss_i) in enumerate(zip(times, losses)):
        print(f"phase 15 step {i + 1}: loss {loss_i:.6f} {t * 1e3:.1f} ms/step, "
              f"{n_tok / t:.1f} tokens/s ({MOE_LORA_B * MOE_LORA_S / t:.1f} padded)", flush=True)
    print(f"phase 15: LoRA SFT over qwen3_moe_30b_a3b ({L} layers, bf16), {MOE_LORA_STEPS} "
          f"steps, peak device memory {peak:.2f} GiB; launches {launches} | {card}", flush=True)
    detach_lora(model)
    del state, step, params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()     # later passes read their own peaks
    steps = MOE_LORA_STEPS
    want = {"moe_gmm_bwd_dx": L * steps, "moe_gmm_bwd_dw": 0, "moe_gmm_bwd_dwd": 0,
            "moe_ffn_bf16": 3 * L * steps}   # forward, remat recompute, d_topv recompute
    if any(launches[n] != c for n, c in want.items()) or not all(np.isfinite(losses)):
        raise AssertionError(f"phase 15: launches {launches} (expected {want}), losses "
                             f"{losses}")
    for name in ("flash_attention_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 15 launched no {name} kernel: {launches}")
    return {"moe_gmm_bwd_dx": launches["moe_gmm_bwd_dx"]}


def judge_phase(card: str, device, tree: Path) -> dict:
    """Phase 11, then phase 21 on its int8 model over phase 20's samples
    `tree`. Returns the launches of the judge's bf16 run (bf16 FFN entries),
    of its int8 pass (int8 and W8A8 entries), as "phase21" and "phase22"
    of the served judge without and with spec decode and chunked prefill
    (phase 22(c)), and phase 22(a)'s judge verify-chunk kernel result."""
    import torch

    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.engine.continuous import PagedContinuousEngine
    from video_r2_tpu_torch.engine.sampling import SamplingParams
    from video_r2_tpu_torch.engine.server import ChatEngine
    from video_r2_tpu_torch.models.config import qwen3_moe_30b_a3b
    from video_r2_tpu_torch.models.loader import init_params, param_count
    from video_r2_tpu_torch.models.quant import quantize_params
    from video_r2_tpu_torch.rewards.judge import EngineJudge

    print(f"before the judge: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"peak so far {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    cfg = qwen3_moe_30b_a3b()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=SEED, dtype="bfloat16", device=device)
    torch.cuda.synchronize()
    print(f"judge model: qwen3_moe_30b_a3b bf16, {param_count(model) / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - t0:.1f} s, vision tower: {model.visual}", flush=True)
    tok = ByteTokenizer()
    requests = judge_requests()
    ids = judge_prompt_ids(tok, requests)
    print(f"judge requests: {len(requests)}, bytes "
          f"{[len(s) + len(u) for s, u in requests]}, prompt tokens "
          f"{[len(x) for x in ids]}", flush=True)

    # the main path: one burst through EngineJudge -> ChatEngine.chat_batch
    judge = EngineJudge(ChatEngine(model, cfg, tok, attn_impl="flash"),
                        max_tokens=JUDGE_NEW_TOKENS)
    marks, at_decode = [], {}

    def on_forward(module, args):
        # generate's first forward is the prefill, the rest are decode steps
        if len(marks) == 1:
            at_decode.update(ffn_launches())
        if len(marks) < 2:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        else:
            marks.append(None)

    hook = model.model.register_forward_pre_hook(on_forward)
    with FfnRecorder(keep=False) as timed:
        judge.chat_many(requests[:2])          # warm-up (not counted)
        marks.clear()
        at_decode.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = judge.chat_many(requests)
        wall = time.perf_counter() - t0
        launches = read_launches()
    hook.remove()
    steps = len(marks) - 1
    prefill_s, decode_s = marks[1] - marks[0], t0 + wall - marks[1]
    launches["moe_ffn_bf16_gmm"], launches["moe_ffn_bf16_ragged"] = split_launches(
        launches, at_decode, "bf16")
    per_step = {n: launches[n] / steps for n in ("moe_ffn_bf16_ragged",)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"judge (bf16): {len(answers)} requests, {steps} decode forwards, prefill "
          f"{prefill_s * 1e3:.1f} ms (B={len(requests)}, padded to "
          f"{-(-max(len(x) for x in ids) // 64) * 64}), decode "
          f"{len(requests) * steps / decode_s:.2f} tok/s ({decode_s * 1e3 / steps:.2f} ms per "
          f"step), {len(answers) / wall:.4f} requests/s, {wall:.3f} s in all; grouped FFN "
          f"launches per decode step {per_step}; launches {launches}; peak device memory "
          f"{peak:.2f} GiB | {card}", flush=True)
    print(f"answer 0: {answers[0][:80]!r}", flush=True)
    if not (len(answers) == len(requests) and all(isinstance(a, str) for a in answers)):
        raise AssertionError(f"judge answers malformed: {answers}")
    for name in ("moe_ffn_bf16_ragged", "moe_ffn_bf16_gmm", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"the judge run launched no {name} kernel: {launches}")
    short = EngineJudge(ChatEngine(model, cfg, tok, attn_impl="flash"), max_tokens=2)
    with FfnRecorder(keep=True) as replay:
        short.chat_many(requests[:2])
        short.chat_many(requests)
    replay.check("judge bf16 burst and its warm-up", timed)
    torch.cuda.reset_peak_memory_stats()       # the check's own tensors are not the judge's
    prof = profile_decode_step(model, len(requests))
    if prof is None:
        print(f"decode step B={len(requests)}: the profiler saw no device time "
              f"(idle share not measured)", flush=True)
    else:
        n_k, busy, wall_p = prof
        step_ms = decode_s * 1e3 / steps
        print(f"decode step B={len(requests)} under the profiler: {n_k} kernel launches, "
              f"{busy:.3f} ms device busy of {wall_p:.3f} ms wall "
              f"({100 * (1 - busy / wall_p):.1f}% idle under the profiler); against the "
              f"unprofiled {step_ms:.2f} ms per step of the burst "
              f"{100 * max(0.0, 1 - busy / step_ms):.1f}% idle", flush=True)

    # request 0: kernel path vs plain path, after the prompt and one step
    ref_tok = None
    got = {}
    for impl, attn in (("kernel", "flash"), ("plain", "xla")):
        set_kernel_impl(model, impl)
        first = judge_logits(model, ids[:1], attn)
        if ref_tok is None:
            ref_tok = first.argmax(-1)
        got[impl] = (first, judge_logits(model, ids[:1], attn, token=ref_tok))
    set_kernel_impl(model, "kernel")
    for i, what in enumerate(("after the prompt", "after one decode step")):
        a, b = got["kernel"][i], got["plain"][i]
        rel = rel_l2(a, b)
        print(f"request 0 logits {what}, kernel vs plain path: rel_l2={rel:.3e} (tol "
              f"{JUDGE_LOGITS_TOL}), argmax {int(a.argmax())} vs {int(b.argmax())}", flush=True)
        if not (torch.isfinite(a).all() and a.shape == (1, cfg.text.vocab_size)
                and rel <= JUDGE_LOGITS_TOL):
            raise AssertionError(f"judge kernel path disagrees with the plain path: {rel}")
    ref8 = judge_logits(model, ids[:JUDGE_INT8_REQUESTS], "flash")
    trained = moe_training_phase(model, cfg, tok, card)     # phase 15, bf16 weights

    # int8: quantize in place, a W8A8 pass of 4 requests
    t0 = time.perf_counter()
    quantize_params(model)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"quantize_params in place: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    got8 = judge_logits(model, ids[:JUDGE_INT8_REQUESTS], "flash", act_quant="int8")
    rel8 = rel_l2(got8, ref8)
    judge8 = EngineJudge(ChatEngine(model, cfg, tok, attn_impl="flash", act_quant="int8"),
                         max_tokens=JUDGE_NEW_TOKENS)
    marks.clear()
    at_decode.clear()
    hook = model.model.register_forward_pre_hook(on_forward)
    with FfnRecorder(keep=False) as timed8:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers8 = judge8.chat_many(requests[:JUDGE_INT8_REQUESTS])
        wall8 = time.perf_counter() - t0
        launches8 = read_launches()
    hook.remove()
    # W8A8 in the prefill, int8 weights with bf16 activations in decode
    launches8["moe_ffn_w8a8_gmm"] = split_launches(launches8, at_decode, "w8a8")[0]
    launches8["moe_ffn_int8_gmm"], launches8["moe_ffn_int8_ragged"] = split_launches(
        launches8, at_decode, "int8")
    agree = float((got8.argmax(-1) == ref8.argmax(-1)).float().mean())
    print(f"judge int8 (W8A8 prefill, int8-weight decode): {len(answers8)} requests in "
          f"{wall8:.3f} s; prefill logits vs the bf16 model rel_l2={rel8:.3e} (tol "
          f"{JUDGE_INT8_TOL}), argmax agreement {agree:.2f}; launches {launches8}; calls by "
          f"(variant, path) {timed8.paths}", flush=True)
    if timed8.paths.get(("int8", 2), 0) != launches8["moe_ffn_int8_ragged"]:
        raise AssertionError(f"the int8 pass's ragged decode did not all take the decode "
                             f"kernel (path 2): {timed8.paths}, {launches8}")
    if not (torch.isfinite(got8).all() and rel8 <= JUDGE_INT8_TOL):
        raise AssertionError(f"W8A8 judge logits disagree with bf16: {rel8}")
    for name in ("moe_ffn_w8a8_gmm", "moe_ffn_int8_ragged"):
        if launches8[name] <= 0:
            raise AssertionError(f"the int8 pass launched no {name} kernel: {launches8}")
    if launches8["moe_ffn_int8_gmm"] or launches8["moe_ffn_w8a8"] != launches8["moe_ffn_w8a8_gmm"]:
        raise AssertionError(f"the int8 pass ran W8A8 in decode or int8 weights with bf16 "
                             f"activations in prefill: {launches8}")
    # every W8A8 prefill launch (one a layer) on the int8 wgmma kernels (path 1)
    print(f"judge int8 pass: W8A8 prefill launches {launches8['moe_ffn_w8a8_gmm']}, on the "
          f"wgmma path {launches8.get('moe_ffn_w8a8_path1', 0)}", flush=True)
    if launches8.get("moe_ffn_w8a8_path1", 0) != launches8["moe_ffn_w8a8_gmm"]:
        raise AssertionError(f"the int8 pass's W8A8 prefill did not all take the wgmma "
                             f"kernels (path 1): {launches8}")

    # the paged engine on the same (int8) model
    sp = SamplingParams(eos_token_ids=(cfg.eos_token_id,), pad_token_id=cfg.pad_token_id)

    def paged_pass(budget: int):
        """8 requests through a new paged engine until drained: (engine, its
        free pages before, rids, FFN launches after the prefill, tokens by
        rid, windows)."""
        eng = PagedContinuousEngine(model, num_slots=JUDGE_PAGED_REQUESTS, max_len=2048,
                                    sp=sp, attn_impl="flash", page_size=PAGE_SIZE)
        avail0 = eng.pcache.available_pages()
        rids = eng.submit_batch([(x, budget) for x in ids[:JUDGE_PAGED_REQUESTS]])
        prefill = dict(ffn_launches())          # submit_batch prefills: the GMM blocks
        out, windows = {}, 0
        while eng.num_active:
            for rid, toks in eng.step(DECODE_STEPS):
                out[rid] = toks
            windows += 1
        return eng, avail0, rids, prefill, out, windows

    with FfnRecorder(keep=False) as timedp:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, avail0, rids, prefill_p, out, windows = paged_pass(JUDGE_NEW_TOKENS)
        wallp = time.perf_counter() - t0
        launchesp = read_launches()
    peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    launchesp["moe_ffn_int8_gmm"], launchesp["moe_ffn_int8_ragged"] = split_launches(
        launchesp, prefill_p, "int8")
    n_tok = sum(len(t) for t in out.values())
    print(f"judge paged engine (int8 weights, bf16 pages): {len(out)} requests, {n_tok} "
          f"tokens in {wallp:.3f} s ({n_tok / wallp:.2f} tok/s, {windows} windows of "
          f"{DECODE_STEPS}); launches {launchesp}; calls by (variant, path) {timedp.paths}",
          flush=True)
    if timedp.paths.get(("int8", 2), 0) < launchesp["moe_ffn_int8_ragged"]:
        raise AssertionError(f"the paged pass's ragged decode did not all take the decode "
                             f"kernel (path 2): {timedp.paths}, {launchesp}")
    # every int8-weight prefill launch (one a layer) on the int8 wgmma kernels
    print(f"judge paged pass: int8-weight prefill launches {launchesp['moe_ffn_int8_gmm']}, "
          f"on the wgmma path {launchesp.get('moe_ffn_int8_path1', 0)}", flush=True)
    if launchesp.get("moe_ffn_int8_path1", 0) != launchesp["moe_ffn_int8_gmm"]:
        raise AssertionError(f"the paged pass's int8-weight prefill did not all take the "
                             f"wgmma kernels (path 1): {launchesp}")
    if None in rids or len(out) != JUDGE_PAGED_REQUESTS:
        raise AssertionError(f"paged judge pass lost requests: {rids}, {len(out)} done")
    if eng.pcache.available_pages() != avail0:
        raise AssertionError("paged judge pass: pages not returned")
    for name in ("paged_decode_attention_stacked", "moe_ffn_int8_ragged", "moe_ffn_int8_gmm"):
        if launchesp[name] <= 0:
            raise AssertionError(f"the paged judge pass launched no {name}: {launchesp}")
    del eng
    short8 = EngineJudge(ChatEngine(model, cfg, tok, attn_impl="flash", act_quant="int8"),
                         max_tokens=2)
    with FfnRecorder(keep=True) as replay:
        short8.chat_many(requests[:JUDGE_INT8_REQUESTS])
    replay.check("judge int8 pass", timed8)
    with FfnRecorder(keep=True) as replay:
        paged_pass(2)
    replay.check("judge paged pass", timedp)
    print(f"peak device memory (judge passes): {peak:.2f} GiB", flush=True)
    del judge, judge8, short, short8, replay     # phase 11's engines and operands
    gc.collect()
    torch.cuda.empty_cache()
    served, plain = posthoc_judge_phase(model, tree, card)        # phase 21
    spec = served_spec_phase(model, tree, card, plain)            # phase 22(c)
    return {"phase21": served, "phase22": spec,
            "paged_decode_attention_stacked_quant_verify": plain["verify_kernel"],
            "moe_ffn_bf16_ragged": launches["moe_ffn_bf16_ragged"],
            "moe_ffn_bf16_gmm": launches["moe_ffn_bf16_gmm"],
            "moe_ffn_int8_ragged": launches8["moe_ffn_int8_ragged"],
            "moe_ffn_int8_gmm": launchesp["moe_ffn_int8_gmm"],
            "moe_ffn_w8a8_gmm": launches8["moe_ffn_w8a8_gmm"], **trained}


def served_window_idle(eng, ids: list) -> str:
    """One decode window of the served engine (its decode_window tokens for
    len(ids) requests admitted by submit_batch) under the profiler."""
    rids = eng.submit_batch([(x, 4 * eng.decode_window) for x in ids])
    return profiled_window(eng, rids, eng.decode_window,
                           f"{sum(r is not None for r in rids)} requests")


def set_int8_impl(model, impl: str) -> None:
    """"kernel" or "plain" for the int8 linears only (models/layers.py)."""
    for mod in model.modules():
        if hasattr(mod, "int8_impl"):
            mod.int8_impl = impl


def packed_check(eng, chat, card: str) -> None:
    """Packed admission on the served engine (its loop stopped): four short
    judge prompts in one row of the top bucket through submit_packed, each
    prompt's last-token logits against its solo prefill (the same prompt
    alone in a row of the same width, so every product has the shapes of
    the packed pass) within PACKED_TOL; a control that drops the segment
    ids must land above PACKED_TOL for every prompt that is not first in
    the row. Printed beside it, the engine's bucket-width solo prefill
    three ways: through the kernels, with the int8 linears on their plain
    version (at 128 rows the kernel route is the int8 wide kernel; 512
    rows take convert + matmul on both routes, as the 2048-row packed pass
    does), and with that and attn_impl "xla" too."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.engine import continuous

    msgs = [READY_MESSAGES]
    msgs += [[{"role": "system", "content": JUDGE_SYSTEM},
              {"role": "user", "content": " ".join(JUDGE_STEPS[:k])}] for k in (1, 2, 3)]
    ids = [chat._encode(m) for m in msgs]
    ps, width = eng._page_size, max(eng.prompt_buckets)
    spans = [-(-len(x) // ps) * ps for x in ids]
    assert sum(spans) <= width and eng.num_active == 0, (spans, eng.num_active)

    def admit(items):
        rids = eng.submit_packed(items)
        slots = [next(i for i, r in enumerate(eng.slot_req) if r is not None and r.rid == rid)
                 for rid in rids]
        logits = eng.last_logits[slots].clone()
        for r in rids:
            eng.request_cancel(r)
        eng.step(1)
        return logits

    @torch.inference_mode()
    def bucket_solo(attn_impl):
        out = []
        for x in ids:
            S = eng._bucket(len(x))
            row = np.full((1, S), eng.cfg.pad_token_id, np.int64)
            row[0, :len(x)] = x
            pos = np.broadcast_to(np.arange(S), (3, 1, S)).copy()
            lens = torch.tensor([len(x)], dtype=torch.int32, device=eng.device)
            hidden, _ = continuous._prefill_rows(eng.model, eng._t(row), eng._t(pos), lens,
                                                 None, attn_impl)
            out.append(continuous._last_logits(eng.model, hidden, lens))
        return torch.cat(out)

    reset_launches()
    packed = admit([(x, 2) for x in ids])
    flash = read_launches()["flash_attention"]
    solo = torch.cat([admit([(x, 2)]) for x in ids])
    reset_launches()
    bucket = bucket_solo(eng.attn_impl)
    wide = read_launches()["int8_matmul_wide"]
    set_int8_impl(eng.model, "plain")
    try:
        bucket_plain8 = bucket_solo(eng.attn_impl)
        bucket_xla = bucket_solo("xla")
    finally:
        set_int8_impl(eng.model, "kernel")
    real = continuous._prefill_packed_into_pages
    continuous._prefill_packed_into_pages = lambda *a, **k: real(*a[:5], None, *a[6:], **k)
    try:
        control = admit([(x, 2) for x in ids])
    finally:
        continuous._prefill_packed_into_pages = real

    def rels(a, b):
        return [rel_l2(a[i], b[i]) for i in range(len(ids))]

    def fmt(r):
        return "[" + ", ".join(f"{x:.3e}" for x in r) + "]"

    rel, rel_ctrl = rels(packed, solo), rels(control, solo)
    print(f"phase 21 packed admission: prompts of {[len(x) for x in ids]} tokens in one row "
          f"of {width} ({flash} flash launches); logits vs the solo prefill rel_l2 "
          f"{fmt(rel)} (tol {PACKED_TOL}); control without segment ids {fmt(rel_ctrl)} "
          f"(prompts after the first must be above the tol) | {card}", flush=True)
    print(f"phase 21 packed vs the bucket-width solo prefill (buckets "
          f"{[eng._bucket(len(x)) for x in ids]}, {wide} int8 wide launches on the kernel "
          f"route): through the kernels {fmt(rels(packed, bucket))}; int8 linears plain "
          f"{fmt(rels(packed, bucket_plain8))}; int8 linears plain and attn xla "
          f"{fmt(rels(packed, bucket_xla))}; kernels vs int8 linears plain at the same width "
          f"{fmt(rels(bucket, bucket_plain8))} | {card}", flush=True)
    if not (torch.isfinite(packed).all() and max(rel) <= PACKED_TOL and flash > 0):
        raise AssertionError(f"phase 21: packed prompts disagree with their solo prefill: "
                             f"{rel}")
    if not min(rel_ctrl[1:]) > PACKED_TOL:
        raise AssertionError(f"phase 21: the control without segment ids stayed within the "
                             f"bound: {rel_ctrl}")


def served_step_check(eng, chat, card: str) -> None:
    """The served engine (its loop stopped, its prefix cache off for the
    check) against its own plain path: test_judge's prompt (a 128-row
    bucket, so the int8 wide kernel) and the longest of phase 11's
    TAC-style requests, admitted one at a time; their logits after the
    prompt and after one decode step over the int8 pages. The plain path is
    the same engine with attn_impl "xla" and every int8 linear, grouped FFN
    and the paged decode attention on its plain version, over pages it
    writes itself; its step is teacher-forced (handed the kernel path's
    prefill logits, so greedy picks the same token). Within
    JUDGE_LOGITS_TOL, the bound phase 11 holds this model's kernel path to."""
    import torch

    from video_r2_tpu_torch.engine import continuous
    from video_r2_tpu_torch.ops.paged_attention import paged_decode_attention_stacked_plain

    ids = [chat._encode(READY_MESSAGES)] + judge_prompt_ids(chat.tok, judge_requests()[-1:])
    assert eng.num_active == 0

    @torch.inference_mode()
    def run(forced=None):
        rids = [eng.submit(x, 4) for x in ids]
        slots = [next(i for i, r in enumerate(eng.slot_req) if r is not None and r.rid == rid)
                 for rid in rids]
        first = eng.last_logits[slots].clone()
        if forced is not None:
            eng.last_logits[slots] = forced
        eng.step(1)
        after = eng.last_logits[slots].clone()
        for r in rids:
            eng.request_cancel(r)
        eng.step(1)
        return first, after

    kept = (eng.prefix_cache, eng.attn_impl, continuous.paged_decode_attention_stacked)
    eng.prefix_cache = False
    try:
        reset_launches()
        kernel = run()
        k_launches = read_launches()
        set_kernel_impl(eng.model, "plain")
        eng.attn_impl = "xla"
        continuous.paged_decode_attention_stacked = paged_decode_attention_stacked_plain
        reset_launches()
        plain = run(forced=kernel[0])
        p_launches = read_launches()
    finally:
        set_kernel_impl(eng.model, "kernel")
        eng.prefix_cache, eng.attn_impl, continuous.paged_decode_attention_stacked = kept
    names = ("flash_attention", "int8_matmul_wide", "int8_matmul_decode",
             "paged_decode_attention_stacked_quant", "moe_ffn_int8")
    rel = [[rel_l2(kernel[i][b], plain[i][b]) for b in range(len(ids))] for i in (0, 1)]
    print(f"phase 21 served engine vs its plain path, prompts of {[len(x) for x in ids]} "
          f"tokens: logits after the prompt rel_l2 {[f'{r:.3e}' for r in rel[0]]}, after one "
          f"decode step over int8 pages {[f'{r:.3e}' for r in rel[1]]} (tol "
          f"{JUDGE_LOGITS_TOL}); argmax {kernel[0].argmax(-1).tolist()} vs "
          f"{plain[0].argmax(-1).tolist()}, after the step {kernel[1].argmax(-1).tolist()} vs "
          f"{plain[1].argmax(-1).tolist()}; launches kernel path "
          f"{ {n: k_launches[n] for n in names} }, plain path "
          f"{ {n: p_launches[n] for n in names} } | {card}", flush=True)
    if any(k_launches[n] <= 0 for n in names) or any(p_launches[n] for n in names):
        raise AssertionError(f"phase 21: the kernel path missed a kernel, or the plain path "
                             f"launched one: {k_launches} / {p_launches}")
    if not (all(torch.isfinite(t).all() for t in (*kernel, *plain))
            and max(max(r) for r in rel) <= JUDGE_LOGITS_TOL):
        raise AssertionError(f"phase 21: the served engine disagrees with its plain path: "
                             f"{rel}")


def serve_http(chat, tree: Path) -> dict:
    """Serve `chat` on 127.0.0.1 in a thread and run apps/test_judge, then
    apps/postprocess tac, vas and summarize over the samples `tree` against
    it; counted (the launch counts set to 0 before, read after). Every HTTP
    request is timed (client latency), its prompt length kept, its errors
    counted; each finished request's tokens are kept by prompt; the
    engine's decode windows (plain windows and spec dispatches) are timed
    and their slot-tokens counted, with the grouped FFN's launches inside
    them. Returns the run's figures."""
    import tempfile

    import numpy as np
    import torch

    from video_r2_tpu_torch.apps import postprocess as pp_app
    from video_r2_tpu_torch.apps import test_judge
    from video_r2_tpu_torch.engine.server import serve
    from video_r2_tpu_torch.rewards import judge as judge_mod

    eng = chat._cont
    torch.cuda.reset_peak_memory_stats()
    server = serve(chat, host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{server.server_address[1]}/v1"

    # the client side: every request timed, every error counted
    latencies, errors, lengths, outputs = [], [], [], {}
    real_chat = judge_mod.OpenAICompatClient.chat

    def timed_chat(self, system, user):
        lengths.append(len(chat._encode([{"role": "system", "content": system},
                                         {"role": "user", "content": user}])))
        t0 = time.perf_counter()
        try:
            out = real_chat(self, system, user)
        except Exception as e:  # noqa: BLE001
            errors.append(f"{type(e).__name__}: {e}")
            raise
        latencies.append(time.perf_counter() - t0)
        return out

    def kept_step(steps=1):
        """The engine's step, its finished requests' tokens kept by prompt
        (trailing pad dropped: the admission routes pad differently)."""
        prompts = {r.rid: r.prompt_ids for r in eng.slot_req if r is not None}
        done = real_step(steps)
        for rid, toks in done:
            ids = [int(x) for x in np.asarray(prompts[rid]).reshape(-1)]
            while ids and ids[-1] == eng.cfg.pad_token_id:
                ids.pop()
            outputs[tuple(ids)] = [int(t) for t in toks]
        return done

    # the server side: the decode windows' slot-tokens, seconds and FFN launches
    decode = {"tokens": 0, "s": 0.0, "windows": 0, "ffn": {}}

    def windowed(fn, tokens):
        def run(active, steps):
            before = dict(ffn_launches())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(active, steps)           # synchronizes (tokens to the host)
            decode["s"] += time.perf_counter() - t0
            decode["tokens"] += tokens(active, steps, out)
            decode["windows"] += 1
            for v, n in ffn_launches().items():
                decode["ffn"][v] = decode["ffn"].get(v, 0) + n - before.get(v, 0)
            return out
        return run

    eng._decode_all = windowed(eng._decode_all,
                               lambda active, steps, _: int(np.asarray(active).sum()) * steps)
    eng._spec_dispatch = windowed(eng._spec_dispatch,
                                  lambda active, steps, out: int(out[1].sum()))
    real_step = eng.step
    eng.step = kept_step
    judge_mod.OpenAICompatClient.chat = timed_chat
    out = Path(tempfile.mkdtemp(prefix="vr2_posthoc_"))
    reset_launches()
    try:
        t0 = time.perf_counter()
        ready = test_judge.main(["--base", base])
        pp_app.main(["tac", "--predictions", str(tree), "--out", str(out / "tac"),
                     "--judge-base", base])
        pp_app.main(["vas", "--predictions", str(tree), "--out", str(out / "vas"),
                     "--judge-base", base])
        summary = pp_app.main(["summarize", "--tac", str(out / "tac"),
                               "--vas", str(out / "vas")])
        wall = time.perf_counter() - t0
    finally:
        judge_mod.OpenAICompatClient.chat = real_chat
        server.shutdown()
        server.server_close()
        chat.shutdown()
        del eng._decode_all, eng._spec_dispatch, eng.step
    lat = sorted(latencies)
    p50, p95 = (lat[min(len(lat) - 1, int(q * len(lat)))] if lat else float("nan")
                for q in (0.5, 0.95))
    return {"launches": read_launches(), "ffn": {v: n for v, n in ffn_launches().items() if n},
            "peak": torch.cuda.max_memory_allocated() / 2 ** 30, "served": len(latencies),
            "errors": errors, "failed": len(errors) + eng.loop_stats["failed"], "wall": wall,
            "p50": p50, "p95": p95, "lengths": lengths, "outputs": outputs,
            "tokens": decode["tokens"], "s": max(decode["s"], 1e-9),
            "windows": decode["windows"], "decode_ffn": decode["ffn"], "ready": ready,
            "summary": summary, "out": out}


def posthoc_judge_phase(model, tree: Path, card: str) -> tuple[dict, dict]:
    """Phase 21: the post-hoc judge path on phase 11's int8 Qwen3-30B-A3B
    (the model apps/common.build_model makes for SERVE_ARGV's config: the
    same seed, quantize_params in place). apps/serve's construction
    (parse_args + build_engine) over SERVE_ARGV with SERVE_SLOTS slots and
    SERVE_NEW_TOKENS tokens an answer, then serve_http: apps/test_judge,
    apps/postprocess tac, vas and summarize over phase 20's samples tree
    (mvbench_think and videomme_think, 8 rows each) against it, counted;
    the loop's admissions by route are engine.loop_stats. Fails on any
    failed request or admission, a TAC / VAS output whose keys differ from
    those the same functions write with a fixed judge, or a kernel of the
    path not launched. Then, on the engine with its loop stopped, one decode
    window under the profiler, the packed admission check and the engine
    against its plain path; with the engine freed, the kernels at the
    served shapes (served_kernel_cases, with phase 22(a)'s verify chunk).
    Returns (the path's launches, the run's figures for phase 22(c))."""
    import torch

    from video_r2_tpu_torch.apps import serve as serve_app
    from video_r2_tpu_torch.apps.common import build_tokenizer
    from video_r2_tpu_torch.evalharness import postprocess
    from video_r2_tpu_torch.rewards.judge import StaticJudge

    t_phase = time.perf_counter()
    app, opts, _, _ = serve_app.parse_args(list(SERVE_ARGV))
    if app.model_config() != model.cfg:
        raise AssertionError("phase 21: the served config is not phase 11's model's")
    tok = build_tokenizer(app)
    chat = serve_app.build_engine(app, model, tok, max_new_tokens=SERVE_NEW_TOKENS,
                                  num_slots=SERVE_SLOTS, **opts)
    eng = chat._cont
    print(f"phase 21: apps/serve {' '.join(SERVE_ARGV)} (num_slots {SERVE_SLOTS}, "
          f"max_new_tokens {SERVE_NEW_TOKENS}; --spec-decode and --prefill-chunk: phase "
          f"22(c)), attn_impl {chat.attn_impl}, page size {eng._page_size}, buckets "
          f"{eng.prompt_buckets}; predictions {sorted(p.name for p in tree.iterdir())} | "
          f"{card}", flush=True)
    run = serve_http(chat, tree)
    launches, ffn, lengths, out = run["launches"], run["ffn"], run["lengths"], run["out"]
    launches["moe_ffn_int8_ragged"] = run["decode_ffn"].get("int8", 0)
    launches["moe_ffn_int8_gmm"] = ffn.get("int8", 0) - launches["moe_ffn_int8_ragged"]
    failed = eng.loop_stats["failed"]
    # the loop packs an idle burst's prompts whose page-rounded span is at
    # most half the top bucket (engine/continuous.py::_run_loop_impl)
    packable = [n for n in lengths
                if 2 * -(-n // eng._page_size) * eng._page_size <= max(eng.prompt_buckets)]
    too_long = [n for n in lengths if n not in packable]
    span_split = lambda v: (len(v), min(v), max(v)) if v else (0,)  # noqa: E731
    kept = ("flash_attention", "paged_decode_attention_stacked_quant", "moe_ffn_int8_ragged",
            "moe_ffn_int8_gmm", "int8_matmul", "int8_matmul_decode", "int8_matmul_wide")
    print(f"phase 21: {run['served']} requests served, {run['failed']} failed "
          f"({len(run['errors'])} HTTP errors, {failed} failed admissions) in "
          f"{run['wall']:.3f} s = {run['served'] / run['wall']:.4f} requests/s; client "
          f"latency p50 {run['p50']:.3f} s, p95 {run['p95']:.3f} s; decode {run['tokens']} "
          f"slot-tokens in {run['windows']} windows, {run['s']:.3f} s = "
          f"{run['tokens'] / run['s']:.2f} tok/s; admissions {dict(eng.loop_stats)}; prompt "
          f"tokens (n, min, max) packable {span_split(packable)}, too long to pack "
          f"{span_split(too_long)}; launches { {k: launches[k] for k in kept} }; grouped FFN "
          f"by variant {ffn}; peak device memory {run['peak']:.2f} GiB | {card}", flush=True)
    summary = run["summary"]
    print(f"phase 21 test_judge answer: {run['ready'][:60]!r}; summary keys: tac "
          f"{ {k: sorted(v) for k, v in summary['tac'].items()} }, vas "
          f"{ {k: sorted(v) for k, v in summary['vas'].items()} }", flush=True)
    if run["failed"] or run["served"] < 1 + 4 * 16:
        raise AssertionError(f"phase 21: failed requests ({run['errors'][:3]}, {failed} "
                             f"failed admissions) or too few served ({run['served']})")
    if max(lengths) + SERVE_NEW_TOKENS + 1 > eng.max_len:
        raise AssertionError(f"phase 21: a prompt of {max(lengths)} tokens was cut to the "
                             f"slot's room ({eng.max_len - SERVE_NEW_TOKENS - 1})")
    for name in ("flash_attention", "paged_decode_attention_stacked_quant",
                 "moe_ffn_int8_ragged", "moe_ffn_int8_gmm", "int8_matmul"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 21 launched no {name}: {launches}")

    # the outputs, with the key sets the same functions write under a fixed judge
    ref = out / "ref"
    postprocess.run_all_tac(tree, StaticJudge("A"), ref / "tac")
    postprocess.run_all_vas(tree, StaticJudge('{"score": 5, "rationale": "r"}'), ref / "vas")

    def keys(root):
        found = {}
        for f in sorted(root.rglob("*.json*")):
            text = f.read_text()
            objs = ([json.loads(line) for line in text.splitlines() if line.strip()]
                    if f.suffix == ".jsonl" else [json.loads(text)])
            found[str(f.relative_to(root))] = sorted({k for o in objs for k in o})
        return found

    for what in ("tac", "vas"):
        got, want = keys(out / what), keys(ref / what)
        if not got or got != want or "error" in json.dumps(json.load(open(
                out / what / ("all_summaries.json" if what == "tac"
                              else "vas_summaries.json")))):
            raise AssertionError(f"phase 21: {what} outputs {got} differ from {want}, or a "
                                 f"benchmark failed")
    print(f"phase 21 outputs: {sum(len(keys(out / w)) for w in ('tac', 'vas'))} files with "
          f"the key sets of the reference functions", flush=True)
    shutil.rmtree(out, ignore_errors=True)

    # the engine, its loop stopped: one decode window, packed admission, and
    # the engine against its plain path
    window = served_window_idle(eng, judge_prompt_ids(tok, judge_requests()))
    print(f"phase 21 decode window under the profiler: {window} | {card}", flush=True)
    packed_check(eng, chat, card)
    served_step_check(eng, chat, card)
    del eng, chat                          # the engine's pools go
    gc.collect()
    torch.cuda.empty_cache()
    verify = served_kernel_cases(model.cfg, lengths, card)
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s in all | {card}", flush=True)
    return launches, {**run, "verify_kernel": verify}


def served_kernel_cases(cfg, lengths: list[int], card: str) -> dict:
    """The kernels of phase 21 that no other phase holds at the judge's
    shapes, against their plain versions: the paged decode over int8 pages
    at 16 served contexts (the served slots at most; 16 of the served
    prompt lengths, evenly spaced in their sorted order from the shortest
    to the longest, each plus SERVE_NEW_TOKENS: the last decode step's),
    and the int8 matmul at the judge's q, k / v, o and head widths with 128
    rows (a 128-row bucket's prefill takes the wide kernel) and with phase
    22(c)'s verify passes' SERVE_SLOTS (K + 1) rows (the wide kernel's two
    row tiles, the second partial); then phase 22(a)'s judge case: the
    paged kernel over int8 pages at the same contexts with verify chunks of
    SPEC_K + 1 tokens (72 query rows a kv head: two row groups). Returns
    that case's result."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    served = sorted(lengths)
    contexts = [served[round(i * (len(served) - 1) / 15)] + SERVE_NEW_TOKENS
                for i in range(16)]
    paged_case(gen, "judge serve decode, int8 pages, W=1", cfg, contexts, 1, "int8")
    verify = paged_case(gen, f"phase 22(a) judge verify chunk K={SPEC_K}, int8 pages, "
                        f"W={SPEC_K + 1}", cfg, contexts, SPEC_K + 1, "int8")
    tc = cfg.text
    H, q_w, kv_w = tc.hidden_size, tc.num_attention_heads * tc.head_dim, \
        tc.num_key_value_heads * tc.head_dim
    verify_rows = SERVE_SLOTS * (SPEC_K + 1)
    for what, K, N in (("q", H, q_w), ("k / v", H, kv_w), ("o", q_w, H),
                       ("head", H, tc.vocab_size)):
        for M in (128, verify_rows):
            int8_case(gen, f"judge {what}, {M} rows", M, K, N)
    print(f"phase 21 kernels at the served shapes: paged decode over int8 pages at "
          f"{len(contexts)} contexts {contexts} (W = 1 and phase 22(a)'s W = {SPEC_K + 1}), "
          f"int8 matmul at q / k / v / o / head widths with 128 rows and 22(c)'s "
          f"{verify_rows} verify rows: each within its tolerance | {card}", flush=True)
    return verify["paged_decode_attention_stacked_quant"]


def int8_weights(gen, K: int, N: int, L: int | None = None):
    """Seeded int8 weights with unit-scale products: quantize_kernel of
    N(0, 1 / K) [(L,) K, N] -> (wq, scale)."""
    import torch

    from video_r2_tpu_torch.models.quant import quantize_kernel

    lead = () if L is None else (L,)
    leaf = quantize_kernel(torch.randn(*lead, K, N, generator=gen, device=gen.device)
                           * K ** -0.5)
    return leaf["kernel_q"], leaf["scale"]


def convert_matmul(x, wq, scale):
    """The library yardstick of the int8 matmul, and the dispatcher's own
    path above its row limit: the int8 weights converted to x's dtype,
    torch.matmul, times the scale in x's dtype."""
    import torch

    return torch.matmul(x, wq.to(x.dtype)) * scale.to(x.dtype)


def int8pack_probe(x, wq, scale):
    """torch._weight_int8pack_mm (weights [N, K] int8, scales [N] in x's
    dtype), where the card's torch takes it: (None, why not) or
    (callable(x, wq_nk, scale), "")."""
    import torch

    if not hasattr(torch, "_weight_int8pack_mm"):
        return None, "this torch has no _weight_int8pack_mm"
    try:           # a capability probe of the yardstick, not of the port
        torch._weight_int8pack_mm(x, wq.t().contiguous(), scale.to(x.dtype))
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        return None, str(e).splitlines()[0][:160]
    return (lambda a, w, s: torch._weight_int8pack_mm(a, w, s)), ""


def rotation(x, wq, scale, copies: int):
    """`rot(fn)`: a call of fn(x, wq', scale') on the next of `copies`
    copies of the weights, so that each timed launch reads them cold."""
    wqs = [wq] + [wq.clone() for _ in range(copies - 1)]
    scs = [scale] + [scale.clone() for _ in range(copies - 1)]
    at = [0]

    def rot(fn):
        def go():
            at[0] = (at[0] + 1) % copies
            return fn(x, wqs[at[0]], scs[at[0]])
        return go
    return rot


def int8_plan(M: int, K: int, N: int):
    """The decode kernel's splits of a tile's K on this card, or None where
    the plan refuses the shape."""
    import torch

    from video_r2_tpu_torch.ops import int8_matmul as m

    if not hasattr(m, "_decode_plan"):     # a port without the decode kernel
        return None
    return m._decode_plan(M, K, N, torch.cuda.current_device())


def int8_other(m):
    """(name, fn(x, wq, scale)) of the int8 kernel a decode shape is timed
    against: the wide kernel (a port with it), else the staged kernel."""
    if hasattr(m, "_wide_plan"):
        def wide(a, w, s_):
            dims = m._check(a, w, s_, 2)
            plan = m._wide_plan(dims[0], dims[1], dims[3], 1, a.get_device())
            return m._launch(a, w, s_, dims, 0, 1, False, plan)
        return "wide", wide
    return "staged", lambda a, w, s_: m._launch("vr2_int8_matmul", a, w, s_, (), False)


def int8_case(gen, what: str, M: int, K: int, N: int, full: bool = True) -> dict:
    """The int8 kernel at one shape against its plain version, cold weights;
    full: also the plain version's and _weight_int8pack_mm's times (else
    the kernel and convert + matmul only, for the row-limit table). The
    route int8_matmul took (decode, wide, element: from the wrapper's
    counts; staged for a port before the wide kernel) and its plan; where
    the decode kernel takes the shape, the wide kernel's times at the same
    shape (held against the plain version too)."""
    import math

    import torch

    from video_r2_tpu_torch.ops import int8_matmul as m
    from video_r2_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

    wq, sc = int8_weights(gen, K, N)
    x = torch.randn(M, K, generator=gen, device=gen.device).to(torch.bfloat16)
    w_bytes = wq.numel() + 4.0 * sc.numel()
    copies = max(1, math.ceil(COLD_BYTES / w_bytes))
    rot = rotation(x, wq, sc, copies)
    counts = lambda: (int8_matmul.decode_launches,  # noqa: E731
                      getattr(int8_matmul, "wide_launches", 0))
    before = counts()
    out, ref = int8_matmul(x, wq, sc), int8_matmul_plain(x, wq, sc)
    dec, wide = (a - b for a, b in zip(counts(), before))
    route = ("decode" if dec else "wide" if wide else
             "element" if hasattr(m, "_wide_plan") else "staged")
    err, excess = compare(out, ref)
    r = {"max_abs_err": err, "excess": excess, "ms": cuda_ms(rot(int8_matmul)),
         "library_ms": cuda_ms(rot(convert_matmul)),
         **bound(2.0 * M * K * N, 2.0 * M * K + w_bytes + 2.0 * M * N)}
    extra = {"kernel": route}
    if route == "decode":
        extra["plan"] = f"{N // m.DECODE_COLUMNS * int8_plan(M, K, N)} blocks x " \
                        f"{int8_plan(M, K, N)} splits"
    elif route == "wide":
        rows, S = m._wide_plan(M, K, N, 1, torch.cuda.current_device())
        extra["plan"] = f"{rows}-row tiles x {S} splits"
    if full:    # device times (a CUDA graph): at decode rows the eager ones are host time
        r["device_ms"] = graph_ms(rot(int8_matmul))
        r["library_device_ms"] = graph_ms(rot(convert_matmul))
        r["plain_ms"] = cuda_ms(rot(int8_matmul_plain), iters=5, warmup=1)
        pack, why = (int8pack_probe(x, wq, sc) if K % 64 == 0 and N % 64 == 0 else
                     (None, "not given tail widths"))
        if pack is None:
            extra["int8pack"] = f"none ({why})"
        else:
            nk = rotation(x, wq.t().contiguous(), sc.to(x.dtype), copies)
            extra["int8pack_ms"] = cuda_ms(nk(pack))
            try:   # a capability probe of the yardstick, not of the port
                extra["int8pack_device_ms"] = graph_ms(nk(pack))
            except RuntimeError as e:
                extra["int8pack_device"] = f"none ({str(e).splitlines()[0][:120]})"
        if route == "decode":   # the other kernel, in the same run
            name, other = int8_other(m)
            excess = max(excess, compare(other(x, wq, sc), ref)[1])
            extra[f"{name}_ms"] = cuda_ms(rot(other))
            extra[f"{name}_device_ms"] = graph_ms(rot(other))
    report("int8_matmul", what, (M, K, N), copies=copies, **r, **extra)
    if not (torch.isfinite(out).all() and excess <= 1.0):
        raise AssertionError(f"int8_matmul [{what}] disagrees with its plain version: "
                             f"{excess} x the tolerance")
    del out, ref, rot
    torch.cuda.empty_cache()
    return {**r, **extra}


def micro_phase(gen) -> dict:
    """scripts/microbench_int8.py's comparison at its shape: one all-layers
    launch, 28 stacked launches and 28 convert + matmul (GB/s over the
    int8 bytes), counted; the outputs on three layers against the plain
    versions. Returns the kernels line's rows of the two entries (per
    launch for the stacked one)."""
    import torch

    from video_r2_tpu_torch.ops.int8_matmul import (
        int8_matmul_all_layers,
        int8_matmul_all_layers_plain,
        int8_matmul_plain,
        int8_matmul_stacked,
    )

    M, K, N, L = MICRO_M, MICRO_K, MICRO_N, MICRO_L
    wq = torch.randint(-127, 128, (L, K, N), generator=gen, device=gen.device,
                       dtype=torch.int8)
    scale = torch.rand(L, N, generator=gen, device=gen.device) * 0.009 + 0.001
    x = torch.randn(M, K, generator=gen, device=gen.device).to(torch.bfloat16) * K ** -0.5
    gb = wq.numel() / 1e9
    bw = lambda ms: gb / (ms * 1e-3)  # noqa: E731
    reset_launches()
    all_ms = cuda_ms(lambda: int8_matmul_all_layers(x, wq, scale), iters=10)
    stacked_ms = cuda_ms(lambda: [int8_matmul_stacked(x, wq, scale, i) for i in range(L)],
                         iters=10)
    counted = read_launches()
    # device times (CUDA graphs: 5 all-layers launches, 2 x 28 stacked), not counted
    all_dev = graph_ms(lambda: int8_matmul_all_layers(x, wq, scale), iters=5)
    stacked_dev = graph_ms(lambda: [int8_matmul_stacked(x, wq, scale, i) for i in range(L)],
                           iters=2)
    wide = {n: counted.get(f"{n}_wide") for n in ("int8_matmul_all_layers",
                                                 "int8_matmul_stacked")}
    conv_ms = cuda_ms(lambda: [convert_matmul(x, wq[i], scale[i]) for i in range(L)],
                      iters=10)
    lib_all = cuda_ms(lambda: torch.matmul(x, wq.to(x.dtype)) * scale[:, None].to(x.dtype),
                      iters=3, warmup=1)
    plain_all = cuda_ms(lambda: int8_matmul_all_layers_plain(x, wq, scale), iters=2, warmup=1)
    out_all = int8_matmul_all_layers(x, wq, scale)
    worst = 0.0
    for i in (0, L // 2, L - 1):
        ref = int8_matmul_plain(x, wq[i], scale[i])
        worst = max(worst, compare(out_all[i], ref)[1],
                    compare(int8_matmul_stacked(x, wq, scale, i), ref)[1])
    err_all = compare(out_all[L - 1], int8_matmul_plain(x, wq[L - 1], scale[L - 1]))[0]
    print(f"microbench_int8 shape [{M},{K}]x[{K},{N}] x{L}: {gb:.2f} GB int8, bound "
          f"{gb * 1e9 / PEAK_BYTES * 1e3:.3f} ms: all-layers (1 launch) {all_ms:.4f} ms "
          f"{bw(all_ms):.0f} GB/s, device {all_dev:.4f} ms {bw(all_dev):.0f} GB/s | stacked "
          f"({L} launches) {stacked_ms:.4f} ms {bw(stacked_ms):.0f} GB/s, device "
          f"{stacked_dev:.4f} ms {bw(stacked_dev):.0f} GB/s | convert + matmul x {L} "
          f"{conv_ms:.4f} ms {bw(conv_ms):.0f} GB/s | one convert + matmul over the stack "
          f"{lib_all:.4f} ms | plain {plain_all:.4f} ms; kernel vs plain on layers 0, "
          f"{L // 2}, {L - 1}: {worst:.3f} x the tolerance; launches "
          f"{counted['int8_matmul_all_layers']} all-layers ({wide['int8_matmul_all_layers']} "
          f"on the wide kernel), {counted['int8_matmul_stacked']} stacked "
          f"({wide['int8_matmul_stacked']} wide)", flush=True)
    if not (torch.isfinite(out_all).all() and worst <= 1.0):
        raise AssertionError(f"the microbench's int8 kernels disagree with plain: {worst}")
    for name, n in wide.items():
        if n is not None and n != counted[name]:
            raise AssertionError(f"{name}: {n} of {counted[name]} launches on the wide kernel")
    per = lambda n_layers: bound(2.0 * M * K * N * n_layers,  # noqa: E731
                                 2.0 * M * K + n_layers * (K * N + 4.0 * N + 2.0 * M * N))
    del wq, out_all
    torch.cuda.empty_cache()
    return {"int8_matmul_all_layers": {
                "max_abs_err": err_all, "ms": all_ms, "device_ms": all_dev,
                "plain_ms": plain_all, "library_ms": lib_all,
                "launches": counted["int8_matmul_all_layers"], **per(L)},
            "int8_matmul_stacked": {
                "max_abs_err": err_all, "ms": stacked_ms / L, "device_ms": stacked_dev / L,
                "plain_ms": plain_all / L, "library_ms": conv_ms / L,
                "launches": counted["int8_matmul_stacked"], **per(1)}}


def int8_kernel_phase(cfg, batch, device) -> dict:
    """Phase 16. Returns the kernels line's rows of the three entries:
    decode gate / up at B = 16; the wide kernel at the bench prefill head;
    the microbench's stacked and all-layers."""
    import torch

    from video_r2_tpu_torch.ops.int8_matmul import INT8_KERNEL_MAX_ROWS

    reqs = batch[0]
    tc, vc = cfg.text, cfg.vision
    B = len(reqs)
    H, qd, kvd = tc.hidden_size, tc.num_attention_heads * tc.head_dim, \
        tc.num_key_value_heads * tc.head_dim
    I, V = tc.intermediate_size, tc.vocab_size
    D4 = vc.spatial_merge_unit * vc.hidden_size
    merger_rows = reqs[0].layout.s_pad // vc.spatial_merge_unit
    cases = {}
    for what, M, K, N in (("decode q / o", B, H, qd), ("decode k / v", B, H, kvd),
                          ("decode gate / up", B, H, I), ("decode down", B, I, H),
                          ("decode and prefill head", B, H, V),
                          ("B=1 q / o", 1, H, qd), ("B=1 k / v", 1, H, kvd),
                          ("B=1 gate / up", 1, H, I), ("B=1 down", 1, I, H),
                          ("B=1 head", 1, H, V), ("bench prefill head", BENCH_CHUNK, H, V),
                          ("merger fc1", merger_rows, D4, D4),
                          ("merger fc2", merger_rows, D4, vc.out_hidden_size),
                          ("K 300 / N 500", 32, 300, 500),
                          ("ViT gate / up (N tail)", SHORT_PATCHES, vc.hidden_size,
                           vc.intermediate_size),
                          ("ViT down (K tail)", SHORT_PATCHES, vc.intermediate_size,
                           vc.hidden_size)):
        cases.setdefault((M, K, N), []).append(what)
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    results = {}
    for (M, K, N), names in cases.items():
        results[(M, K, N)] = int8_case(gen, ", ".join(names), M, K, N)

    # the row limit: kernel vs convert + matmul at gate / up and q
    table = {}
    for M in INT8_ROWS:
        for what, K, N in (("gate / up", H, I), ("q", H, qd)):
            r = int8_case(gen, f"row limit, {what}", M, K, N, full=False)
            table[(M, what)] = (r["ms"], r["library_ms"], r["kernel"])
    wins = [M for M in INT8_ROWS if all(table[(M, w)][0] <= table[(M, w)][1]
                                        for w in ("gate / up", "q"))]
    print("INT8_KERNEL_MAX_ROWS table (ms, kernel / convert + matmul, cold weights; the "
          "kernel's route): "
          + "; ".join(f"M={M}: " + ", ".join(
              f"{w} {table[(M, w)][0]:.4f} / {table[(M, w)][1]:.4f} ({table[(M, w)][2]})"
              for w in ("gate / up", "q")) for M in INT8_ROWS)
          + f"; the kernel no slower at both shapes at M in {wins}: the largest "
          f"{max(wins) if wins else 0}; INT8_KERNEL_MAX_ROWS = {INT8_KERNEL_MAX_ROWS}",
          flush=True)
    if (max(wins) if wins else 0) != INT8_KERNEL_MAX_ROWS:
        print(f"INT8_KERNEL_MAX_ROWS MISMATCH: this run's table gives "
              f"{max(wins) if wins else 0}, the constant is {INT8_KERNEL_MAX_ROWS}", flush=True)
    micro = micro_phase(gen)

    # the flash kernel at phase 17's prefill shapes: (a)'s quantized fill
    # attends over the local k / v (Sk = S) of the padded batch, (b)'s
    # chunks are BENCH_CHUNK full prompts
    nh, kh, hd = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    randn = lambda *s: torch.randn(*s, generator=gen, device=device).to(  # noqa: E731
        torch.bfloat16)
    packed = batch[1]
    for what, lens in (("int8 fill (a)", torch.as_tensor(packed.lengths, dtype=torch.int32,
                                                          device=device)),
                       ("int8 fill (b) chunk", torch.full((BENCH_CHUNK,), BENCH_PROMPT,
                                                          dtype=torch.int32, device=device))):
        Bq, S = lens.shape[0], (packed.input_ids.shape[1] if what.endswith("(a)")
                                else BENCH_PROMPT)
        q, k, v = randn(Bq, S, nh, hd), randn(Bq, S, kh, hd), randn(Bq, S, kh, hd)
        flash_case(gen, what, q, k, v, lens, True, None, training=False)
        del q, k, v
        torch.cuda.empty_cache()
    return {"int8_matmul": results[(B, H, I)],
            "int8_matmul_wide": results[(BENCH_CHUNK, H, V)], **micro}


def int8_expected_launches(cfg, reqs, B: int, S: int, T: int) -> tuple[int, str]:
    """The int8 kernel's launches in phase 17(a)'s run, from the rows each
    int8 linear sees and INT8_KERNEL_MAX_ROWS: the decode steps' 7 linears
    a layer and the head (B rows each), the prefill's head (B rows) and
    decoder linears (B x S rows), and each video's ViT (5 linears a block
    over its padded patches) and merger (2 over a quarter of them)."""
    from video_r2_tpu_torch.ops.int8_matmul import INT8_KERNEL_MAX_ROWS as R

    tc, vc = cfg.text, cfg.vision
    fits = lambda rows: int(0 < rows <= R)  # noqa: E731
    step = 7 * tc.num_hidden_layers + 1
    parts = {"decode": (T - 1) * step * fits(B), "prefill head": fits(B),
             "prefill linears": 7 * tc.num_hidden_layers * fits(B * S),
             "ViT": sum(5 * vc.depth * fits(r.layout.s_pad) for r in reqs),
             "merger": sum(2 * fits(r.layout.s_pad // vc.spatial_merge_unit) for r in reqs)}
    return sum(parts.values()), ", ".join(f"{k} {v}" for k, v in parts.items())


def int8_expected_decode(cfg, B: int, T: int) -> int:
    """Of int8_expected_launches, those the decode kernel takes, from the
    shapes alone (not from the wrapper's plan, so a plan that refused a 7B
    shape fails the count): at 1 to 16 rows every decode step's 7 linears
    a layer and the head, and the prefill's head, as the 7B's widths are
    multiples of 128 with K of at least 4 steps of 64."""
    tc = cfg.text
    H, I, V = tc.hidden_size, tc.intermediate_size, tc.vocab_size
    qd, kvd = tc.num_attention_heads * tc.head_dim, tc.num_key_value_heads * tc.head_dim
    shapes = ((H, qd), (H, kvd), (H, kvd), (qd, H), (H, I), (H, I), (I, H), (H, V))
    if not (0 < B <= 16 and all(N % 128 == 0 and K % 64 == 0 and K >= 256
                                for K, N in shapes)):
        return 0
    return (T - 1) * (7 * tc.num_hidden_layers + 1) + 1


def int8_request_check(model, runner, req, T: int) -> None:
    """Request 0 alone on the int8 model over an int8 cache, kernel path vs
    plain path (set_kernel_impl "plain", prefill and ViT attention "xla"):
    its logits after prefill and after one decode step of the kernel path's
    argmax, within LOGITS_TOL; the plain path launches no int8 kernel."""
    import torch

    from video_r2_tpu_torch.engine.generate import decode_step_logits, prefill
    from video_r2_tpu_torch.models.decoder import QuantKVCache

    cfg, dev = model.cfg, model.device
    S0, n0 = req.input_ids.shape[1], int(req.lengths[0])
    r_ids = torch.as_tensor(req.input_ids, device=dev).long()
    r_pos = torch.as_tensor(req.position_ids, device=dev).long()
    r_len = torch.as_tensor(req.lengths, dtype=torch.int32, device=dev)
    r_dec = torch.as_tensor(req.rope_deltas + S0, device=dev).long()
    got, counts = {}, {}
    for path in ("kernel", "plain"):
        plain = path == "plain"
        set_kernel_impl(model, path)
        reset_launches()
        with torch.inference_mode():
            vemb = runner.vision_embeds(req, "xla" if plain else "kernel")
            cache = QuantKVCache.init(cfg.text, 1, S0 + T, dev)
            l0 = prefill(model, r_ids, r_pos, r_len, cache, vemb, cfg.video_token_id,
                         "xla" if plain else "flash")
            tok = got["kernel"][0].argmax(-1) if plain else l0.argmax(-1)
            got[path] = (l0, decode_step_logits(model, tok, r_dec, cache, r_len, S0, 0))
        torch.cuda.synchronize()
        counts[path] = read_launches()["int8_matmul"]
    set_kernel_impl(model, "kernel")
    rels = [rel_l2(a, b) for a, b in zip(got["kernel"], got["plain"])]
    print(f"request 0 ({n0} tokens) on the int8 model, int8 cache, kernel vs plain path: "
          f"logits after prefill rel_l2={rels[0]:.3e}, after one decode step {rels[1]:.3e} "
          f"(tol {LOGITS_TOL}); argmax {int(got['kernel'][0].argmax())} vs "
          f"{int(got['plain'][0].argmax())}; int8 launches: kernel path {counts['kernel']}, "
          f"plain path {counts['plain']}", flush=True)
    if not (all(torch.isfinite(x).all() for x in got["kernel"]) and max(rels) <= LOGITS_TOL):
        raise AssertionError(f"int8 kernel path disagrees with the plain path: {rels}")
    if counts["plain"] != 0 or counts["kernel"] <= 0:
        raise AssertionError(f"int8 launches {counts}: the plain path must launch none, the "
                             f"kernel path some")


def kv_attention_times(cfg, B: int, smax: int, device) -> str:
    """One layer's decode attention over a full cache of width smax, int8
    (quant_dot_product_attention) vs bf16 (plain_attention), in ms."""
    import torch

    from video_r2_tpu_torch.models.decoder import quantize_kv
    from video_r2_tpu_torch.ops.attention import plain_attention, quant_dot_product_attention

    tc = cfg.text
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    kv = lambda: torch.randn(B, smax, tc.num_key_value_heads, tc.head_dim,  # noqa: E731
                             generator=gen, device=device).to(torch.bfloat16)
    k, v = kv(), kv()
    q = torch.randn(B, 1, tc.num_attention_heads, tc.head_dim, generator=gen,
                    device=device).to(torch.bfloat16)
    bias = torch.zeros(B, 1, 1, smax, device=device)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    with torch.inference_mode():
        q_ms = cuda_ms(lambda: quant_dot_product_attention(q, kq, ks, vq, vs, bias))
        b_ms = cuda_ms(lambda: plain_attention(q, k, v, bias))
        rel = rel_l2(quant_dot_product_attention(q, kq, ks, vq, vs, bias),
                     plain_attention(q, k, v, bias))
    return (f"B={B}, {smax} keys: int8 cache {q_ms:.4f} ms, bf16 cache {b_ms:.4f} ms "
            f"(rel_l2 {rel:.2e})")


def int8_serving_phase(card: str, device, bf16_grpo_peak: float) -> tuple[dict, dict]:
    """Phases 16, 17 and 17(c) on a fresh Qwen2.5-VL-7B, int8 in place.
    Returns (kernels line rows, launches; 17(c)'s under "phase17c")."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.apps.demo import DemoRunner
    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.engine.generate import decode_step_logits, generate, prefill
    from video_r2_tpu_torch.engine.sampling import SamplingParams
    from video_r2_tpu_torch.models.config import qwen25vl_7b
    from video_r2_tpu_torch.models.decoder import KVCache, QuantKVCache
    from video_r2_tpu_torch.models.loader import init_params
    from video_r2_tpu_torch.models.quant import quantize_params

    print(f"before the int8 7B: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    cfg = qwen25vl_7b()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=SEED, dtype="bfloat16", device=device)
    before = param_split(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_params(model)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    split = param_split(model)
    gib = lambda n: n / 2 ** 30  # noqa: E731
    print(f"int8 quantize_params in place: {q_s:.2f} s, peak "
          f"{gib(torch.cuda.max_memory_allocated()):.2f} GiB; parameters "
          f"{sum(before.values()) / 1e9:.3f} GB before -> int8 {split['int8'] / 1e9:.3f} GB, "
          f"float {split['float'] / 1e9:.3f} GB ({sum(split.values()) / 1e9:.3f} GB)",
          flush=True)
    runner = DemoRunner(model, ByteTokenizer())
    batch = video_batch(runner, cfg, INT8_QUESTIONS)
    reqs, packed, pos, deltas = batch

    # phase 16: the int8 kernels
    kernel_results = int8_kernel_phase(cfg, batch, device)
    launches = {n: kernel_results[n].pop("launches")
                for n in ("int8_matmul_stacked", "int8_matmul_all_layers")}

    # phase 17(a): the eval backend's configuration, counted
    B, S = packed.input_ids.shape
    T = INT8_NEW_TOKENS
    sp = SamplingParams(max_new_tokens=T, eos_token_ids=(), pad_token_id=cfg.pad_token_id)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vemb = torch.cat([runner.vision_embeds(r) for r in reqs])
    torch.cuda.synchronize()
    vit_ms = (time.perf_counter() - t0) * 1e3
    marks = []

    def on_embed(module, args):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    hook = model.model.embed_tokens.register_forward_pre_hook(on_embed)
    res = generate(model, packed.input_ids, packed.lengths, sp, position_ids=pos,
                   rope_deltas=deltas, vision_embeds=vemb,
                   vision_token_id=cfg.video_token_id, attn_impl="flash", kv_quant="int8")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    hook.remove()
    counted = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = len(marks) - 1
    dec_s = t_end - marks[1]
    want, parts = int8_expected_launches(cfg, reqs, B, S, T)
    want_dec = int8_expected_decode(cfg, B, T)
    print(f"int8 serving (a): {B} videos, prompt lengths {packed.lengths.tolist()} padded to "
          f"{S}, {T} greedy tokens each (eos off), weight-only, int8 KV: ViT {vit_ms:.1f} ms "
          f"({B} videos), prefill {(marks[1] - marks[0]) * 1e3:.1f} ms, {steps} decode steps "
          f"of {dec_s / steps * 1e3:.2f} ms, {B * steps / dec_s:.2f} tok/s, peak device "
          f"memory {peak:.2f} GiB; launches {counted} (int8 expected {want}: {parts}; of them "
          f"on the decode kernel {want_dec}) | {card}", flush=True)
    if res.sequences.shape != (B, T) or steps != T - 1:
        raise AssertionError(f"int8 generate: {res.sequences.shape} tokens, {steps} steps")
    if not ((res.sequences >= 0) & (res.sequences < cfg.text.vocab_size)).all():
        raise AssertionError("int8 generate: token ids out of the vocabulary")
    if counted["int8_matmul"] != want:
        raise AssertionError(f"the int8 slice launched {counted['int8_matmul']} int8 "
                             f"kernels, not {want} ({parts})")
    if counted["int8_matmul_decode"] != want_dec or not want_dec:
        raise AssertionError(f"the int8 slice launched {counted['int8_matmul_decode']} int8 "
                             f"decode kernels, not {want_dec}")
    # every other int8 launch here is on the wide kernel: the text and merger
    # widths map onto TMA, and the ViT's linears (N or K 3420) see more rows
    # than INT8_KERNEL_MAX_ROWS
    if counted["int8_matmul_wide"] != want - want_dec:
        raise AssertionError(f"the int8 slice launched {counted['int8_matmul_wide']} int8 "
                             f"wide kernels, not {want - want_dec}")
    for name in ("flash_attention", "window_attention"):
        if counted[name] <= 0:
            raise AssertionError(f"the int8 slice launched no {name} kernel")
    launches["int8_matmul"] = counted["int8_matmul"]
    launches["int8_matmul_decode"] = counted["int8_matmul_decode"]

    int8_request_check(model, runner, reqs[0], T)
    ids_t = torch.as_tensor(packed.input_ids, device=device).long()
    pos_t = torch.as_tensor(pos, device=device).long()
    len_t = torch.as_tensor(packed.lengths, dtype=torch.int32, device=device)
    dec_pos = torch.as_tensor(deltas + S, device=device).long()
    got = {}
    for name, cache in (("int8", QuantKVCache.init(cfg.text, B, S + T, device)),
                        ("bf16", KVCache.init(cfg.text, B, S + T, torch.bfloat16, device))):
        with torch.inference_mode():
            l0 = prefill(model, ids_t, pos_t, len_t, cache, vemb, cfg.video_token_id, "flash")
            got[name] = (l0, decode_step_logits(model, l0.argmax(-1), dec_pos, cache, len_t,
                                                S, 0, "flash"))
        del cache
    rel_kv = rel_l2(got["int8"][1], got["bf16"][1])
    print(f"int8 batch, logits after one decode step, int8 cache vs bf16 cache: "
          f"rel_l2={rel_kv:.3e} (tol {INT8_LOGITS_TOL}); after prefill "
          f"{rel_l2(got['int8'][0], got['bf16'][0]):.3e}", flush=True)
    if not (torch.isfinite(got["int8"][1]).all() and rel_kv <= INT8_LOGITS_TOL):
        raise AssertionError(f"the int8 cache disagrees with the bf16 cache: {rel_kv}")
    del vemb, got
    gc.collect()
    torch.cuda.empty_cache()
    print(f"int8-KV decode attention vs the bf16 cache's, one layer: "
          f"{kv_attention_times(cfg, B, S + T, device)}; "
          f"{kv_attention_times(cfg, BENCH_B, BENCH_PROMPT + BENCH_NEW, device)}", flush=True)

    # phase 17(b): bench.py's workload
    ids = np.random.default_rng(0).integers(2, 150000, size=(BENCH_B, BENCH_PROMPT)).astype(
        np.int32)
    lengths = np.full((BENCH_B,), BENCH_PROMPT, np.int32)
    sp = SamplingParams(max_new_tokens=BENCH_NEW, eos_token_ids=(),
                        pad_token_id=cfg.pad_token_id)

    def run(seed):
        return generate(model, ids, lengths, sp, seed=seed, attn_impl="flash",
                        act_quant="int8", kv_quant="int8", prefill_chunk=BENCH_CHUNK)

    run(0)                                        # warm-up
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(i + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    bench_launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tok_s = [BENCH_B * BENCH_NEW / t for t in times]
    print(f"int8 serving (b), bench.py's workload: B={BENCH_B}, {BENCH_PROMPT}-token prompts, "
          f"{BENCH_NEW} new tokens, W8A8 + int8 KV, prefill_chunk={BENCH_CHUNK}: runs "
          f"{[round(t, 4) for t in times]} s, {[round(t, 1) for t in tok_s]} tok/s, peak "
          f"device memory {peak:.2f} GiB; launches of the last run {bench_launches} (the "
          f"int8 kernel {bench_launches['int8_matmul']}: the prefill chunks' head, "
          f"{bench_launches['int8_matmul_wide']} of them on the wide kernel)", flush=True)
    print(json.dumps({"metric": BENCH_METRIC, "value": round(statistics.median(tok_s), 1),
                      "runs": [round(t, 1) for t in tok_s], "unit": "tokens/sec",
                      "card": card}), flush=True)
    if res.sequences.shape != (BENCH_B, BENCH_NEW) or not (
            (res.sequences >= 0) & (res.sequences < cfg.text.vocab_size)).all():
        raise AssertionError(f"bench workload: bad tokens {res.sequences.shape}")
    if bench_launches["flash_attention"] <= 0:
        raise AssertionError("the bench workload launched no flash kernel")
    if not 0 < bench_launches["int8_matmul_wide"] == bench_launches["int8_matmul"]:
        raise AssertionError(f"the bench workload's int8 launches {bench_launches['int8_matmul']}"
                             f", on the wide kernel {bench_launches['int8_matmul_wide']}")
    launches["int8_matmul_wide"] = bench_launches["int8_matmul_wide"]
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # phase 17(d): the eval backend's int8 options (kv_quant) on the int8 base
    int8_eval_pass(model, card)

    # phase 17(c): QLoRA-GRPO over the int8 base
    launches["phase17c"] = qlora_phase(model, card, bf16_grpo_peak)
    return kernel_results, launches


# ---------------------------------------------------------------------------
# the eval path (phases 20, 18's eval and 17(d))
# ---------------------------------------------------------------------------

def eval_docs(task: str, n: int, frames: int, hw: tuple[int, int], seed: int) -> list[dict]:
    """`n` docs of `task` (mvbench_think's or videomme_think's schema), each
    one in-memory clip of `frames` + 2 (i % 3) frames of uint8 noise at `hw`
    and 1 fps, with a four-option question."""
    import numpy as np

    rng = np.random.default_rng(seed)
    opts = ["a red cup", "a book", "a phone", "a pen"]
    docs = []
    for i in range(n):
        clip = rng.integers(0, 256, (frames + 2 * (i % 3), *hw, 3), np.uint8)
        q = f"{QUESTIONS[i % len(QUESTIONS)]} (clip {i})"
        if task.startswith("videomme"):
            docs.append({"videoID": clip, "video_id": f"{i:03d}", "question_id": f"{i:03d}-1",
                         "duration": "short", "domain": "Knowledge",
                         "sub_category": "Humanity & History",
                         "task_type": "Counting Problem", "question": q,
                         "options": [f"{'ABCD'[j]}. {o}" for j, o in enumerate(opts)],
                         "answer": "ABCD"[i % 4]})
        else:
            docs.append({"video": clip, "question": q, "candidates": opts,
                         "answer": opts[i % 4]})
    return docs


def eval_rows(out: dict, task: str) -> tuple[list, dict]:
    """A task's per-sample rows without the doc (frames) and its results
    without the wall time."""
    rows = [{k: v for k, v in r.items() if k != "doc"} for r in out["samples"][task]]
    return rows, {k: v for k, v in out["results"][task].items() if k != "time_s"}


def tiny_eval_check(models: dict, tok, card: str) -> None:
    """Phase 18's eval: evaluate over mvbench_think with 3 in-memory-frame
    docs (56x56, kept at their size), 8 greedy tokens, through EngineModel
    in batch and in paged mode on the card and on the CPU: responses and
    per-sample rows equal, results equal but for the wall time; one
    continuation's loglikelihood within FP32_TOL; then the paged pool's
    regrowth on the card: when the engine grows, the old pool is freed
    before the new one is allocated (memory_allocated back at its level
    before the first engine)."""
    import gc

    import torch

    from video_r2_tpu_torch.evalharness import EngineModel, evaluate, get_task
    from video_r2_tpu_torch.evalharness.api import Instance
    from video_r2_tpu_torch.evalharness.engine_backend import EngineBackend

    docs = eval_docs("mvbench_think", 3, 6, (56, 56), SEED + 20)
    kw = dict(max_num_frames=4, max_pixels=56 * 56, min_pixels=4 * 28 * 28, batch_size=2)
    for mode, extra in (("batch", {}), ("paged", {"page_size": PAGE_SIZE, "decode_steps": 4})):
        got = {}
        for where, model in models.items():
            task = get_task("mvbench_think", docs=docs)
            task.config.generation_kwargs["max_new_tokens"] = TINY_NEW_TOKENS - 4
            got[where] = eval_rows(evaluate(EngineModel(model, tok, engine_mode=mode, **kw,
                                                        **extra), [task]), "mvbench_think")
        (rows, res), (ref_rows, ref_res) = got["kernel"], got["cpu"]
        print(f"phase 18 eval ({mode}, {len(rows)} docs, {TINY_NEW_TOKENS - 4} tokens) on the "
              f"card vs the CPU: rows equal {rows == ref_rows}, results equal "
              f"{res == ref_res}, responses {[len(r['resps'][0][0]) for r in rows]} chars "
              f"| {card}", flush=True)
        if rows != ref_rows or res != ref_res:
            raise AssertionError(f"phase 18: the tiny eval ({mode}) on the card disagrees with "
                                 f"the CPU:\n{rows}\n{ref_rows}")
    inst = Instance(0, {}, "Which object is it?", [docs[0]["video"]], {})
    ll = {w: EngineModel(m, tok, **kw).loglikelihood([inst], [" a red cup"])[0]
          for w, m in models.items()}
    rel = abs(ll["kernel"][0] - ll["cpu"][0]) / max(1.0, abs(ll["cpu"][0]))
    print(f"phase 18 eval loglikelihood on the card {ll['kernel']} vs the CPU {ll['cpu']}: "
          f"rel {rel:.3e} (tol {FP32_TOL}) | {card}", flush=True)
    if not (rel <= FP32_TOL and ll["kernel"][1] == ll["cpu"][1]):
        raise AssertionError(f"phase 18: loglikelihood disagrees: {ll}")

    backend = EngineBackend(models["kernel"], tok, batch_size=2, engine_mode="paged",
                            page_size=64)
    instances = [Instance(i, {}, "x" * n, [], {"max_new_tokens": 4, "temperature": 0.0})
                 for i, n in enumerate([8, 90, 300])]
    gc.collect()
    base = torch.cuda.memory_allocated()
    seen, orig = [], backend._get_cont_engine

    def spy(needed):
        if backend._cont is None and seen:
            gc.collect()          # every alias of the old engine is dropped here
            seen.append(("rebuild", torch.cuda.memory_allocated() - base))
        eng = orig(needed)
        if not seen or seen[-1][0] != eng.max_len:
            pool = sum(t.numel() * t.element_size() for t in (eng.pcache.k, eng.pcache.v))
            seen.append((eng.max_len, torch.cuda.memory_allocated() - base, pool))
        return eng

    backend._get_cont_engine = spy
    from video_r2_tpu_torch.data import prefetch

    class OneAtATime(prefetch.PrefetchLoader):
        """One prepared instance an admission pass, so they arrive in turn."""
        gave = False

        def poll(self):
            if self.gave:
                self.gave = False
                return None
            item = super().poll()
            self.gave = item is not None
            return item

    plain_loader = prefetch.PrefetchLoader
    prefetch.PrefetchLoader = OneAtATime
    try:
        backend.generate_until(instances)
    finally:
        prefetch.PrefetchLoader = plain_loader
    freed = [e[1] for e in seen if e[0] == "rebuild"]
    pools = [e[2] for e in seen if e[0] != "rebuild"]
    print(f"phase 18 paged eval regrowth: (max_len, bytes allocated over the level before "
          f"the first engine, its pool's k / v bytes), and at each rebuild the bytes left "
          f"once the old engine is dropped: {seen} | {card}", flush=True)
    if not freed or max(freed) >= min(pools) // 2:
        raise AssertionError(f"phase 18: the paged engine grew without freeing its old pool "
                             f"first: {seen}")


class EvalTimers:
    """Synchronized timers around the eval backend's device work: the ViT,
    batch mode's prefill (engine/generate.py::prefill) and generate calls,
    paged mode's submit_batch (its prefill) and step windows, and the waits
    of the device loop on the prefetch loader (its blocking __next__). Each
    timer synchronizes the card before and after."""

    def __init__(self):
        import torch

        from video_r2_tpu_torch.data import prefetch
        from video_r2_tpu_torch.engine import continuous
        from video_r2_tpu_torch.engine import generate as genmod
        from video_r2_tpu_torch.evalharness import engine_backend as eb

        self.t = {k: 0.0 for k in ("vit", "prefill", "generate", "submit", "step", "wait")}
        self.n = {k: 0 for k in self.t}
        self.tokens = 0
        self.first = None       # the first batch's (row 0 prepared, its tokens)
        self.contexts = []      # paged mode: each submitted prompt's length + its budget
        timers = self
        sync = torch.cuda.synchronize

        def timed(name, fn):
            def call(*a, **k):
                sync()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                sync()
                timers.t[name] += time.perf_counter() - t0
                timers.n[name] += 1
                return out
            return call

        def counted_generate(*a, **k):
            res = gen_timed(*a, **k)
            timers.tokens += int(res.lengths.sum())
            if timers.first is not None and timers.first[1] is None:
                timers.first = (timers.first[0], [int(x) for x in
                                                  res.sequences[0][: res.lengths[0]]])
            return res

        def counted_step(eng, steps=1):
            out = step_timed(eng, steps)
            timers.tokens += sum(len(toks) for _, toks in out)
            return out

        def first_batch(backend, prepared, indices, gen_kwargs):
            if timers.first is None:
                timers.first = (prepared[0], None)
            return run_batch(backend, prepared, indices, gen_kwargs)

        class WaitTimed(prefetch.PrefetchLoader):
            def __next__(self):
                t0 = time.perf_counter()
                try:
                    return super().__next__()
                finally:
                    timers.t["wait"] += time.perf_counter() - t0
                    timers.n["wait"] += 1

        def recorded_submit(eng, items):
            timers.contexts += [len(it[0]) + int(it[1]) for it in items]
            return submit_timed(eng, items)

        gen_timed = timed("generate", eb.generate)
        submit_timed = timed("submit", continuous.PagedContinuousEngine.submit_batch)
        step_timed = timed("step", continuous.PagedContinuousEngine.step)
        run_batch = eb.EngineBackend._run_batch
        self._saved = [(eb, "vit_forward", eb.vit_forward), (eb, "generate", eb.generate),
                       (genmod, "prefill", genmod.prefill),
                       (continuous.PagedContinuousEngine, "submit_batch",
                        continuous.PagedContinuousEngine.submit_batch),
                       (continuous.PagedContinuousEngine, "step",
                        continuous.PagedContinuousEngine.step),
                       (eb.EngineBackend, "_run_batch", run_batch),
                       (prefetch, "PrefetchLoader", prefetch.PrefetchLoader)]
        eb.vit_forward = timed("vit", eb.vit_forward)
        eb.generate = counted_generate
        genmod.prefill = timed("prefill", genmod.prefill)
        continuous.PagedContinuousEngine.submit_batch = recorded_submit
        continuous.PagedContinuousEngine.step = counted_step
        eb.EngineBackend._run_batch = first_batch
        prefetch.PrefetchLoader = WaitTimed

    def restore(self) -> None:
        for owner, name, value in self._saved:
            setattr(owner, name, value)


def eval_phase(model, card: str, device) -> tuple[dict, dict, Path]:
    """Phase 20: apps/run_eval's path (EngineModel + evaluate) on the bf16
    7B over mvbench_think and videomme_think, EVAL_DOCS docs each (one
    in-memory clip of 32-36 frames at 336x448, 1 fps), the app's eval
    defaults (batch 8, 128 frames at most, pixels in [100352, 151200]) with
    max_new_tokens cut to EVAL_NEW_TOKENS; batch mode, then paged mode
    (decode_steps 8), counted. Asserts every doc answered, the samples files
    with the JAX keys, accuracy in [0, 1], and the first batch's request 0's
    teacher-forced logits through the kernels (ViT kernels, flash prefill)
    against the plain path within LOGITS_TOL, and the paged decode kernel
    against its plain version at the paged pass's contexts (paged_case,
    after the counted passes). Prints docs/s, prefill ms a
    batch, decode tok/s, the device loop's wait on the prefetch loader and
    its share, the peak memory, and the share of docs whose batch and paged
    responses are equal. Then phase 20(c). Returns the kernels' launches
    over both modes, those of 20(c)'s flash run, and the batch pass's
    samples tree (kept for phase 21)."""
    import tempfile

    import numpy as np
    import torch

    from video_r2_tpu_torch.apps.demo import DemoRequest, DemoRunner
    from video_r2_tpu_torch.config import EvalConfig
    from video_r2_tpu_torch.engine.chat import ByteTokenizer, pack_prompts
    from video_r2_tpu_torch.evalharness import EngineModel, evaluate, get_task
    from video_r2_tpu_torch.models.mrope import get_rope_index
    from video_r2_tpu_torch.models.vision import plan_vision_layout

    t_phase = time.perf_counter()
    cfg = model.cfg
    tok = ByteTokenizer()
    ev = EvalConfig()          # apps/run_eval's defaults
    docs = {t: eval_docs(t, EVAL_DOCS, EVAL_FRAMES, EVAL_HW, SEED + 30 + k)
            for k, t in enumerate(EVAL_TASKS)}
    out_dir = Path(tempfile.mkdtemp(prefix="vr2_eval_"))
    print(f"phase 20: eval on the bf16 7B, tasks {list(EVAL_TASKS)}, {EVAL_DOCS} docs each "
          f"({EVAL_FRAMES}-{EVAL_FRAMES + 4} frames of {EVAL_HW[0]}x{EVAL_HW[1]} at 1 fps), "
          f"batch {ev.batch_size}, paged decode_steps {ev.decode_steps}; max_new_tokens cut "
          f"from 1024 to {EVAL_NEW_TOKENS} for time | {card}",
          flush=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    responses, first = {}, None
    for mode in ("batch", "paged"):
        timers = EvalTimers()
        tasks = []
        for t in EVAL_TASKS:
            task = get_task(t, docs=docs[t])
            task.config.generation_kwargs["max_new_tokens"] = EVAL_NEW_TOKENS
            tasks.append(task)
        em = EngineModel(model, tok, max_num_frames=ev.max_num_frames,
                         max_pixels=ev.max_pixels, min_pixels=ev.min_pixels,
                         batch_size=ev.batch_size, system_prompt=ev.system_prompt,
                         attn_impl="flash", engine_mode=mode, decode_steps=ev.decode_steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = evaluate(em, tasks, output_dir=out_dir / mode)
        finally:
            timers.restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_docs = 0
        for t in EVAL_TASKS:
            rows = out["samples"][t]
            res = out["results"][t]
            n_docs += len(rows)
            responses[(mode, t)] = [r["resps"][0][0] for r in rows]
            path = out_dir / mode / f"samples_{t}.jsonl"
            lines = [json.loads(line) for line in open(path)]
            keys = ("doc_id", "doc", "input", "resps", "filtered_resps", "target", "doc_hash",
                    "accuracy")
            if (len(rows) != EVAL_DOCS or len(lines) != EVAL_DOCS
                    or not all(k in r for r in lines for k in keys)
                    or not all(isinstance(x, str) for x in responses[(mode, t)])
                    or not 0.0 <= res["accuracy"] <= 1.0):
                raise AssertionError(f"phase 20 ({mode}, {t}): not every doc answered, or a "
                                     f"bad samples file or result: {res}")
        batches = timers.n["generate"] or timers.n["submit"]
        prefill_s = timers.t["prefill"] if mode == "batch" else timers.t["submit"]
        decode_s = (timers.t["generate"] - timers.t["prefill"] if mode == "batch"
                    else timers.t["step"])
        print(f"phase 20 eval ({mode}): {n_docs} docs in {wall:.3f} s = {n_docs / wall:.4f} "
              f"docs/s; ViT {timers.t['vit']:.3f} s over {timers.n['vit']} clips; prefill "
              f"{1e3 * prefill_s / max(batches, 1):.2f} ms a "
              f"{'batch' if mode == 'batch' else 'submit_batch'} ({batches}); decode "
              f"{timers.tokens} tokens in {decode_s:.3f} s = {timers.tokens / decode_s:.2f} "
              f"tok/s; the device loop waited {timers.t['wait']:.3f} s on the prefetch loader "
              f"({timers.n['wait']} blocking pulls), {100 * timers.t['wait'] / wall:.1f}% of "
              f"the pass; accuracy {[out['results'][t]['accuracy'] for t in EVAL_TASKS]} "
              f"(synchronized timers) | {card}", flush=True)
        if mode == "batch":
            first = timers.first
        else:
            contexts = timers.contexts
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    same = [a == b for t in EVAL_TASKS
            for a, b in zip(responses[("batch", t)], responses[("paged", t)])]
    print(f"phase 20: peak device memory {peak:.2f} GiB; batch and paged responses equal for "
          f"{sum(same)} of {len(same)} docs ({100 * sum(same) / len(same):.1f}%; printed, not "
          f"asserted: the paged prefill pads to other widths, bf16 rounding differs); "
          f"launches {launches} | {card}", flush=True)
    for name in ("flash_attention", "window_attention", "paged_decode_attention_stacked"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 20 launched no {name} kernel: {launches}")
    spec_eval_pass(model, tok, docs, responses, card)          # phase 22(d)

    # the paged decode kernel at the paged pass's contexts (its first
    # submit_batch's prompts at their full budget) against its plain version
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    paged_case(gen, "eval decode, W=1", cfg, contexts[:ev.batch_size], 1)

    # the first batch's request 0: kernels (ViT kernels, flash prefill) vs plain path
    (ids, feats), gen_tokens = first
    packed = pack_prompts([list(ids)], pad_id=cfg.pad_token_id)
    mask = (np.arange(packed.input_ids.shape[1])[None, :]
            < packed.lengths[:, None]).astype(np.int64)
    pos, deltas = get_rope_index(
        packed.input_ids, cfg, video_grid_thw=np.asarray([f.grid_thw for f in feats]),
        second_per_grid_ts=np.asarray([f.second_per_grid_t for f in feats]),
        attention_mask=mask)
    req = DemoRequest(packed.input_ids, packed.lengths, pos, deltas[:, 0],
                      plan_vision_layout([f.grid_thw for f in feats], cfg.vision),
                      np.concatenate([f.patches for f in feats]))
    runner = DemoRunner(model, tok)
    toks = gen_tokens[:EVAL_TF_TOKENS]
    got = teacher_forced_logits(model, runner, req, toks, kernels=True)
    ref = teacher_forced_logits(model, runner, req, toks)
    rel = rel_l2(got, ref)
    print(f"phase 20 request 0 of the first batch (prompt {int(packed.lengths[0])} tokens, "
          f"grid {feats[0].grid_thw}) after {len(toks)} of its tokens: logits through the "
          f"kernels vs the plain path rel_l2={rel:.3e} (tol {LOGITS_TOL}), argmax "
          f"{int(got.argmax())} vs {int(ref.argmax())}; phase {time.perf_counter() - t_phase:.1f} "
          f"s | {card}", flush=True)
    if not (torch.isfinite(got).all() and rel <= LOGITS_TOL):
        raise AssertionError(f"phase 20: kernel path logits disagree: {rel}")
    tap_launches = attention_tap_phase(model, first, card)      # phase 20(c)
    shutil.rmtree(out_dir / "paged", ignore_errors=True)
    return launches, tap_launches, out_dir / "batch"


def attention_tap_phase(model, first, card: str) -> dict:
    """Phase 20(c): models/attention_tap.py on the bf16 7B over phase 20's
    first doc, its prompt and its completion (S tokens, the completion's W
    as completion_window, key chunks of 2048), once with attn_impl="flash"
    (the ViT's kernels and the flash kernel in layers [0, L-1)) and once on
    the plain path, each after a warm call, counted: the two masses within
    TAP_TOL, each in [0, 1], the flash kernel launched on the first and no
    kernel on the second. Prints each run's ms and peak memory. Returns the
    flash run's launches."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.models.attention_tap import attention_to_video_scores
    from video_r2_tpu_torch.models.mrope import get_rope_index
    from video_r2_tpu_torch.models.vision import plan_vision_layout

    cfg, dev = model.cfg, model.device
    (ids, feats), gen_tokens = first
    seq = np.asarray([list(ids) + list(gen_tokens)], np.int64)
    S, W = seq.shape[1], len(gen_tokens)
    pos, _ = get_rope_index(seq, cfg, video_grid_thw=np.asarray([f.grid_thw for f in feats]),
                            second_per_grid_ts=np.asarray([f.second_per_grid_t
                                                           for f in feats]))
    amask = np.ones_like(seq)
    qmask = np.zeros_like(seq)
    qmask[:, S - W:] = 1
    patches = torch.as_tensor(np.concatenate([f.patches for f in feats]), device=dev)
    layout = plan_vision_layout([f.grid_thw for f in feats], cfg.vision)
    runs = {}
    for impl in ("flash", "xla"):
        def tap():
            return attention_to_video_scores(model, seq, pos, amask, qmask,
                                             video_patches=patches, video_layout=layout,
                                             completion_window=W, key_chunk=TAP_KEY_CHUNK,
                                             attn_impl=impl)
        tap()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        score = tap()
        torch.cuda.synchronize()
        runs[impl] = (float(score[0]), (time.perf_counter() - t0) * 1e3,
                      torch.cuda.max_memory_allocated() / 2 ** 30, read_launches())
    (fl, fl_ms, fl_peak, launches), (pl, pl_ms, pl_peak, plain) = runs["flash"], runs["xla"]
    n_video = int((seq == cfg.video_token_id).sum())
    print(f"phase 20(c) attention tap on the bf16 7B: S {S} ({n_video} video tokens), "
          f"completion_window {W}, key_chunk {TAP_KEY_CHUNK}: mass on "
          f"video {fl:.6f} (flash) vs {pl:.6f} (plain), |d| {abs(fl - pl):.3e} (tol {TAP_TOL}); "
          f"flash {fl_ms:.1f} ms, peak {fl_peak:.2f} GiB; plain {pl_ms:.1f} ms, peak "
          f"{pl_peak:.2f} GiB; flash launches flash_attention {launches['flash_attention']}, "
          f"window_attention {launches['window_attention']} | {card}", flush=True)
    if not (0.0 <= fl <= 1.0 and 0.0 <= pl <= 1.0 and abs(fl - pl) <= TAP_TOL):
        raise AssertionError(f"phase 20(c): the tap's masses disagree: {fl} vs {pl}")
    if launches["flash_attention"] <= 0 or any(n for k, n in plain.items()
                                               if k in KERNELS):
        raise AssertionError(f"phase 20(c): the flash path launched no flash kernel, or "
                             f"the plain path launched one: {launches}, {plain}")
    return launches


def int8_eval_pass(model, card: str) -> None:
    """Phase 17(d): one short batch-mode eval on the int8 7B,
    EngineModel(kv_quant="int8"), mvbench_think over EVAL_DOCS docs with
    INT8_EVAL_TOKENS new tokens: every doc answered; the int8 kernel's
    launches printed."""
    import torch

    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.evalharness import EngineModel, evaluate, get_task

    t0 = time.perf_counter()
    task = get_task("mvbench_think", docs=eval_docs("mvbench_think", EVAL_DOCS, EVAL_FRAMES,
                                                    EVAL_HW, SEED + 40))
    task.config.generation_kwargs["max_new_tokens"] = INT8_EVAL_TOKENS
    reset_launches()
    out = evaluate(EngineModel(model, ByteTokenizer(), attn_impl="flash",
                               kv_quant="int8"), [task])
    torch.cuda.synchronize()
    launches = read_launches()
    rows = out["samples"]["mvbench_think"]
    print(f"phase 17(d): eval on the int8 7B (kv_quant int8, batch mode) over {len(rows)} "
          f"docs, {INT8_EVAL_TOKENS} tokens: {time.perf_counter() - t0:.3f} s, int8 kernel "
          f"launches {launches['int8_matmul']} ({launches['int8_matmul_decode']} on the "
          f"decode kernel), flash {launches['flash_attention']}, window "
          f"{launches['window_attention']} | {card}", flush=True)
    if len(rows) != EVAL_DOCS or not all(isinstance(r["resps"][0][0], str) for r in rows):
        raise AssertionError(f"phase 17(d): not every doc answered: {len(rows)} rows")
    if launches["int8_matmul_decode"] <= 0:
        raise AssertionError(f"phase 17(d) launched no int8 decode kernel: {launches}")


# ---------------------------------------------------------------------------
# GRPO (phases 19, 18's GRPO cycle, 17(c))
# ---------------------------------------------------------------------------

def grpo_sample(n_frames: int, seed: int) -> dict:
    """One GRPO prompt as data/grpo.py makes it from a record: a think-style
    multiple-choice question on `n_frames` synthetic frames of 392x392 at 2
    fps (8 frames: grid (4, 28, 28), 784 video tokens), the default system
    message, the answer and a temporal ground truth for the TAR reward."""
    import numpy as np

    from video_r2_tpu_torch.apps.demo import THINK_POST_PROMPT
    from video_r2_tpu_torch.data.config import DataConfig
    from video_r2_tpu_torch.data.grpo import GRPODataset

    frames = np.random.default_rng(seed).integers(
        0, 256, (n_frames, FRAME_HW, FRAME_HW, 3), np.uint8)
    rec = {"video": frames, "video_fps": 2.0,
           "conversations": [{"from": "human",
                              "value": f"<video>\n{GRPO_QUESTION}{THINK_POST_PROMPT}"},
                             {"from": "gpt", "value": GRPO_ANSWER}],
           "temporal_grounding": GRPO_GROUNDING}
    return GRPODataset([rec], DataConfig(fps=2.0))[0]


class GroundingJudge:
    """A fake judge for the TAR reward over any number of rollout batches:
    in each batch its extraction replies alternate by row a claim that
    matches the ground truth and one that matches nothing, so the TAR
    rewards differ within a group, and every consistency reply is TRUE.
    Its `chat_many` answers in row order (chat_many would otherwise fan a
    client out over threads)."""

    def chat_many(self, requests, on_error: str = "raise") -> list[str]:
        from video_r2_tpu_torch.rewards.temporal import EXTRACTION_SYSTEM

        return [json.dumps(GRPO_HIT if i % 2 == 0 else GRPO_MISS)
                if system == EXTRACTION_SYSTEM else "TRUE"
                for i, (system, _) in enumerate(requests)]

    def chat(self, system: str, user: str) -> str:
        return self.chat_many([(system, user)])[0]


def grpo_runner(model, gcfg, step, seed: int):
    """GRPORunner over `model` with the default rewards (accuracy, format,
    TAR; weights 1, 1, 1), the GroundingJudge, the HashingEmbedder, flash
    attention; the reference policy is the same module with its adapters
    removed (phase 19(a); the cycles go through apps/train_grpo.train)."""
    from video_r2_tpu_torch.apps.train_grpo import DEFAULT_REWARDS
    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.rewards.embedding import HashingEmbedder
    from video_r2_tpu_torch.rewards.registry import load_reward_funcs
    from video_r2_tpu_torch.train.grpo_runner import GRPORunner

    return GRPORunner(model, gcfg, ByteTokenizer(), load_reward_funcs(list(DEFAULT_REWARDS)),
                      list(DEFAULT_REWARDS), step, ref_model=model,
                      judge=GroundingJudge(), embedder=HashingEmbedder(),
                      attn_impl="flash", seed=seed)


def grpo_train(model, gcfg, lcfg, sample, cycles: int, what: str, card: str) -> tuple:
    """`cycles` LoRA-GRPO cycles over `model` through apps/train_grpo.train,
    the entry point a user calls: its adapter init (init_lora_for_quantized
    over an int8 base), the module itself as the reference policy, its
    metrics.jsonl and final checkpoint (under build/, removed after), with
    the GroundingJudge and the HashingEmbedder; counted. Returns (per-cycle
    metrics, launches, peak GiB, the largest |lora_b|: 0 at the start)."""
    import torch

    from video_r2_tpu_torch.apps.train_grpo import DEFAULT_REWARDS, train
    from video_r2_tpu_torch.config import AppConfig, RunConfig
    from video_r2_tpu_torch.rewards.embedding import HashingEmbedder
    from video_r2_tpu_torch.train.optim import OptimConfig

    run_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_grpo"
    shutil.rmtree(run_dir, ignore_errors=True)
    app = AppConfig(run=RunConfig(output_dir=str(run_dir), max_steps=cycles,
                                  save_steps=10 ** 6, use_lora=True, seed=SEED,
                                  resume=False),
                    grpo=gcfg, lora=lcfg,
                    optim=OptimConfig(learning_rate=GRPO_LR, total_steps=cycles))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, out = train(app, model, [sample], reward_names=DEFAULT_REWARDS,
                       judge=GroundingJudge(), embedder=HashingEmbedder())
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    logged = (run_dir / "metrics.jsonl").read_text().splitlines()
    ckpts = sorted(p.name for p in run_dir.glob("checkpoint-*"))
    shutil.rmtree(run_dir, ignore_errors=True)
    moved = max(float(p.detach().abs().max()) for n, p in state.params.items()
                if n.endswith("lora_b"))
    G = gcfg.num_generations
    for m in out:
        split = {k.removeprefix("profiling/").removesuffix("_s"): round(v, 4)
                 for k, v in m.items() if k.startswith("profiling/")}
        toks = m["completion_len_mean"] * G
        print(f"{what} cycle {m['cycle']}: {m['s_per_cycle']:.3f} s; loss {m['loss']:.6e} kl "
              f"{m['kl']:.6e} grad_norm {m['grad_norm']:.4e} reward {m['reward_mean']:.3f} "
              f"(accuracy {m['rewards/accuracy_reward/mean']:.3f}, format "
              f"{m['rewards/format_reward/mean']:.3f}, TAR "
              f"{m[f'rewards/{TAR}/mean']:.3f}; embedder {m['embedder']}), completion tokens "
              f"{toks:.0f} (len {m['completion_len_min']:.0f}-{m['completion_len_max']:.0f}), "
              f"rollout {toks / m['profiling/rollout_generate_s']:.1f} tok/s; phase s {split} "
              f"| {card}", flush=True)
    print(f"{what}: apps/train_grpo.train wrote {len(logged)} metrics.jsonl lines and "
          f"{ckpts}; peak device memory {peak:.2f} GiB; adapters moved by {moved:.3e} at "
          f"most over {state.step} steps; launches {launches}", flush=True)
    for m in out:
        if not all(math.isfinite(m[k]) for k in ("loss", "kl", "grad_norm")):
            raise AssertionError(f"{what} cycle {m['cycle']}: non-finite metrics {m}")
    if out[0]["kl"] != 0.0:
        raise AssertionError(f"{what}: cycle 1's KL is {out[0]['kl']}, not 0 (B = 0 makes "
                             f"the policy its base)")
    if len(logged) != cycles or ckpts != [f"checkpoint-{cycles}"]:
        raise AssertionError(f"{what}: the entry point logged {len(logged)} cycles of "
                             f"{cycles} and saved {ckpts}")
    if not moved > 0:
        raise AssertionError(f"{what}: the adapters did not move")
    return out, launches, peak, moved


def grpo_path_check(model, runner, params, batch, card) -> None:
    """Phase 19(a) on the first rollout batch: per_token_logps and step 1's
    loss and adapter gradients, kernel path (attn_impl "flash") against the
    plain path ("xla"), each with its own ref logps (adapters removed). The
    log-probs are held in nats over the completion tokens, where the loss
    reads them through exp(lp - old) and exp(ref - lp), and a control with
    the flash forward's causal mask dropped must read above those bounds; a
    control with the dq kernel's output zeroed must read above the
    gradients' bound."""
    import torch

    from video_r2_tpu_torch.ops import flash as flash_mod
    from video_r2_tpu_torch.train.grpo import grpo_loss, per_token_logps
    from video_r2_tpu_torch.train.lora import adapters_disabled

    gcfg = runner.gcfg
    C = batch["completion_mask"].shape[1]
    keep = batch["completion_mask"] == 1
    args = (batch["input_ids"], batch["position_ids"], batch["attention_mask"], C,
            gcfg.temperature, gcfg.logp_chunk_size)
    real_bwd, real_fwd = flash_mod.flash_attention_bwd, flash_mod._flash_cuda

    def zero_dq(*a, **kw):         # the gradients' control: the dq kernel's output zeroed
        dq, dk, dv = real_bwd(*a, **kw)
        return torch.zeros_like(dq), dk, dv

    def no_causal(q, k, v, kv_lengths, causal, *a, **kw):   # the log-probs' control
        return real_fwd(q, k, v, kv_lengths, False, *a, **kw)

    def logp_error(lp) -> tuple[float, float]:
        """(max |lp - plain|, RMS of exp(lp - plain) - 1) over the completion."""
        d = (lp.float() - lps["plain"].float())[keep]
        return float(d.abs().max()), float((torch.expm1(d) ** 2).mean().sqrt())

    out, lps = {}, {}
    for impl, attn in (("kernel", "flash"), ("plain", "xla"), ("control", "flash")):
        with torch.no_grad():
            lps[impl] = per_token_logps(model, *args, video_embeds=batch["video_embeds"],
                                        attn_impl=attn)
            with adapters_disabled(model):
                ref = per_token_logps(model, *args, video_embeds=batch["video_embeds"],
                                      attn_impl=attn)
        for p in params.values():
            p.grad = None
        flash_mod.flash_attention_bwd = zero_dq if impl == "control" else real_bwd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            loss, _ = grpo_loss(model, gcfg, {**batch, "ref_per_token_logps": ref},
                                attn_impl=attn)
            loss.backward()
        finally:
            flash_mod.flash_attention_bwd = real_bwd
        grads = torch.cat([p.grad.flatten() for p in params.values()])
        torch.cuda.synchronize()
        out[impl] = (loss.item(), grads, time.perf_counter() - t0)
    flash_mod._flash_cuda = no_causal
    try:
        with torch.no_grad():
            lps["no_causal"] = per_token_logps(model, *args,
                                               video_embeds=batch["video_embeds"],
                                               attn_impl="flash")
    finally:
        flash_mod._flash_cuda = real_fwd
    (lk, gk, tk), (lp, gp, tp) = out["kernel"], out["plain"]
    scale = float(batch["advantages"].abs().mean())      # the policy term's size
    loss_rel = abs(lk - lp) / max(abs(lp), scale)
    grad_rel, control_rel = rel_l2(gk, gp), rel_l2(out["control"][1], gp)
    lp_rel = rel_l2(lps["kernel"][keep], lps["plain"][keep])
    lp_abs, lp_rms = logp_error(lps["kernel"])
    ctl_abs, ctl_rms = logp_error(lps["no_causal"])
    print(f"phase 19(a) B={batch['input_ids'].shape[0]} x {batch['input_ids'].shape[1]} "
          f"(prompt + {C}): log-probs kernel vs plain path over the completion: max "
          f"|d| {lp_abs:.3e} nats (tol {LOGP_MAX_ABS}), RMS of exp(d) - 1 {lp_rms:.3e} (tol "
          f"{LOGP_RATIO_RMS}), rel_l2 {lp_rel:.3e} (tol {LOGITS_TOL}); control (causal mask "
          f"dropped) max |d| {ctl_abs:.3e}, RMS {ctl_rms:.3e}; step-1 loss kernel {lk:.6e} "
          f"plain {lp:.6e} (diff over max(|loss|, mean |adv| {scale:.3e}) {loss_rel:.3e}, tol "
          f"{PATH_LOSS_RTOL}); adapter gradients rel L2 {grad_rel:.3e} (tol "
          f"{PATH_GRAD_REL_L2}), |g| {float(gp.norm()):.4e}; fwd+bwd s kernel {tk:.3f} plain "
          f"{tp:.3f}; control (dq zeroed) rel L2 {control_rel:.3e} | {card}", flush=True)
    if not (lp_abs <= LOGP_MAX_ABS and lp_rms <= LOGP_RATIO_RMS and lp_rel <= LOGITS_TOL
            and loss_rel <= PATH_LOSS_RTOL and grad_rel <= PATH_GRAD_REL_L2
            and torch.isfinite(gk).all() and float(gp.norm()) > 0):
        raise AssertionError(f"phase 19(a): kernel path disagrees with the plain path: "
                             f"log-probs max {lp_abs} RMS {lp_rms} rel {lp_rel}, loss "
                             f"{loss_rel}, gradients {grad_rel}")
    if not (ctl_abs > LOGP_MAX_ABS and ctl_rms > LOGP_RATIO_RMS):
        raise AssertionError(f"phase 19(a): the log-prob bounds do not see a forward "
                             f"without its causal mask: max {ctl_abs}, RMS {ctl_rms}")
    if not control_rel > PATH_GRAD_REL_L2:
        raise AssertionError(f"phase 19(a): the bound {PATH_GRAD_REL_L2} does not see a "
                             f"zeroed dq: control rel L2 {control_rel}")
    for p in params.values():
        p.grad = None


def decode_window_idle(eng, prepared, G: int, steps: int) -> str:
    """One decode window (`steps` tokens of G forked rollouts of one prompt)
    of the paged engine under the profiler."""
    from video_r2_tpu_torch.engine.sampling import SamplingParams

    sp = SamplingParams(do_sample=True, top_k=50, max_new_tokens=4 * steps,
                        eos_token_ids=())
    rid = eng.submit(list(prepared.input_ids), max_new_tokens=4 * steps, sp=sp,
                     vision_embeds=prepared.video_embeds,
                     video_grid_thw=prepared.video_grid_thw,
                     second_per_grid_ts=prepared.second_per_grid_ts)
    return profiled_window(eng, [rid] + eng.fork(rid, n=G - 1), steps, f"{G} rollouts")


def profiled_window(eng, rids: list, steps: int, what: str) -> str:
    """A warm window of `steps` tokens, then one under torch.profiler, of
    the paged engine's active requests `rids` (cancelled after): launches,
    device busy ms, wall ms and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.step(steps)                                      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    for r in rids:
        eng.request_cancel(r)
    eng.step(1)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return f"{what}, window of {steps}: {wall:.2f} ms wall (idle share not measured)"
    busy = sum(e.device_time for e in kernels) / 1e3
    return (f"{what}, window of {steps}: {len(kernels)} launches, {busy:.2f} ms busy "
            f"of {wall:.2f} ms under the profiler ({100 * (1 - busy / wall):.1f}% idle)")


def grpo_phase(model, card: str, device) -> dict:
    """Phase 19: LoRA-GRPO on the 7B (bf16) with paged rollouts, then 22(d)'s
    cycle with speculative rollouts. Returns the launches of the counted
    cycles, the peak memory as "peak_gib", and the paged kernel's launches
    in 22(d)'s verify chunks as "verify_launches"."""
    import torch

    from video_r2_tpu_torch.train.grpo import GRPOConfig
    from video_r2_tpu_torch.train.lora import (
        LoRAConfig,
        attach_lora,
        detach_lora,
        init_lora,
        lora_param_count,
        make_lora_grpo_step,
    )

    gcfg = GRPOConfig(num_generations=GRPO_G, beta=0.04, max_completion_length=GRPO_NEW,
                      max_prompt_length=GRPO_MAX_PROMPT, temperature=1.0, top_p=1.0,
                      top_k=50, rollout_backend="paged",
                      rollout_decode_steps=DECODE_STEPS, reward_weights=(1.0, 1.0, 1.0))
    lcfg = LoRAConfig()                                   # r 64, alpha 64
    params = attach_lora(model, init_lora(model, lcfg, seed=SEED), lcfg)
    step = make_lora_grpo_step(model, gcfg, attn_impl="flash")
    runner = grpo_runner(model, gcfg, step, SEED)
    sample = grpo_sample(N_FRAMES, SEED + 19)
    print(f"phase 19: LoRA-GRPO, r {lcfg.r} alpha {lcfg.alpha} "
          f"({lora_param_count(params) / 1e6:.1f} M adapter params), 1 prompt x G "
          f"{GRPO_G}, {GRPO_NEW} new tokens, paged rollouts (step({DECODE_STEPS})), beta "
          f"{gcfg.beta}, lr {GRPO_LR}", flush=True)

    # (a) on the first rollout batch
    batch, m0 = runner.rollout_and_score([sample])
    P = batch["input_ids"].shape[1] - GRPO_NEW
    print(f"phase 19 first rollout batch: prompt {P} (padded), completion lengths "
          f"{batch['completion_mask'].sum(1).tolist()}, rewards mean {m0['reward_mean']:.3f}, "
          f"advantages {[round(a, 3) for a in batch['advantages'].tolist()]}", flush=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    tc = model.cfg.text
    B, S = batch["input_ids"].shape
    randn = lambda *s: torch.randn(  # noqa: E731
        *s, generator=gen, device=device).to(torch.bfloat16)
    seg = torch.where(batch["attention_mask"] == 1, 1, -1).int()
    q, k, v = randn(B, S, tc.num_attention_heads, tc.head_dim), *(
        randn(B, S, tc.num_key_value_heads, tc.head_dim) for _ in range(2))
    full = torch.full((B,), S, dtype=torch.int32, device=device)
    # the no-grad log-prob passes (serving forward) and the loss (training)
    flash_case(gen, "grpo log-probs", q, k, v, full, True, seg, training=False)
    flash_case(gen, "grpo loss", q, k, v, full, True, seg, training=True)
    del q, k, v
    grpo_path_check(model, runner, params, batch, card)
    window = decode_window_idle(runner._rollout_eng, runner.prepare_prompt(sample), GRPO_G,
                                DECODE_STEPS)
    print(f"phase 19: one decode window of the rollout engine: {window} | {card}", flush=True)
    detach_lora(model)
    del batch, runner, step, params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two cycles through apps/train_grpo.train, counted
    _, launches, peak, _ = grpo_train(model, gcfg, lcfg, sample, 2, "phase 19", card)
    for name in ("window_attention", "flash_attention", "paged_decode_attention_stacked",
                 "flash_attention_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 19 launched no {name} kernel: {launches}")
    detach_lora(model)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 22(d): one cycle with speculative rollouts (rejection sampling)
    from dataclasses import replace

    from video_r2_tpu_torch.engine.continuous import PagedContinuousEngine

    with SpecCounter(PagedContinuousEngine) as sc:
        out, spec_launches, _, _ = grpo_train(
            model, replace(gcfg, rollout_spec_decode=SPEC_K_SMALL), lcfg, sample, 1,
            f"phase 22(d) GRPO, rollout_spec_decode {SPEC_K_SMALL}", card)
    verify = sc.verify["paged_decode_attention_stacked"]
    print(f"phase 22(d) GRPO cycle with rollout_spec_decode {SPEC_K_SMALL}: "
          f"{out[0]['s_per_cycle']:.3f} s, loss {out[0]['loss']:.6e}; "
          f"{sc.stat('spec_dispatches')} spec dispatches, {sc.per_round():.3f} tokens a round "
          f"a slot; paged launches {spec_launches['paged_decode_attention_stacked']} "
          f"({verify} in verify chunks) | {card}", flush=True)
    if sc.stat("spec_dispatches") <= 0 or verify <= 0:
        raise AssertionError("phase 22(d): the GRPO rollouts did not speculate")
    detach_lora(model)
    gc.collect()
    torch.cuda.empty_cache()
    return {**launches, "peak_gib": peak, "verify_launches": verify}


def qlora_phase(model, card: str, bf16_peak: float) -> dict:
    """Phase 17(c): QLoRA-GRPO over the int8 7B (after 17(b)): one cycle
    through apps/train_grpo.train (which takes init_lora_for_quantized over
    the int8 linears) on the "batch" backend (1 prompt on a 2-frame clip x
    QLORA_G rollouts x QLORA_NEW tokens), counted. Returns its launches."""
    import torch

    from video_r2_tpu_torch.train.grpo import GRPOConfig
    from video_r2_tpu_torch.train.lora import LoRAConfig, detach_lora

    gcfg = GRPOConfig(num_generations=QLORA_G, beta=0.04, max_completion_length=QLORA_NEW,
                      max_prompt_length=GRPO_MAX_PROMPT, temperature=1.0, top_p=1.0,
                      top_k=50, rollout_backend="batch",
                      reward_weights=(1.0, 1.0, 1.0))
    lcfg = LoRAConfig()
    # 2 frames: 784 patches, so the merger's int8 linears see 196 rows (the
    # wide kernel) in the prompt's ViT pass; the decode steps' 4 rows take the
    # decode kernel; the loss's rows (and the no-grad passes over the same
    # rows) exceed INT8_KERNEL_MAX_ROWS and convert
    sample = grpo_sample(SHORT_FRAMES, SEED + 17)
    print(f"phase 17(c): QLoRA-GRPO over the int8 7B, r {lcfg.r} on the int8 linears, "
          f"1 prompt x G {QLORA_G}, {QLORA_NEW} new tokens, batch rollouts", flush=True)
    _, launches, peak, _ = grpo_train(model, gcfg, lcfg, sample, 1, "phase 17(c)", card)
    print(f"phase 17(c): no refusal in the loss (the int8 linears under adapters took "
          f"convert + matmul); int8 kernel launches {launches['int8_matmul']} (decode kernel "
          f"{launches['int8_matmul_decode']}, wide {launches['int8_matmul_wide']}); peak "
          f"device memory int8 base {peak:.2f} GiB vs the bf16 7B's in phase 19 "
          f"{bf16_peak:.2f} GiB | {card}", flush=True)
    if launches["int8_matmul_decode"] <= 0 or launches["int8_matmul_wide"] <= 0:
        raise AssertionError(f"phase 17(c): the rollouts launched no int8 decode or wide "
                             f"kernel: {launches}")
    detach_lora(model)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def recorded(runner) -> list:
    """Keep every (batch, metrics) that runner.rollout_and_score returns."""
    kept, orig = [], runner.rollout_and_score

    def wrapped(samples):
        kept.append(orig(samples))
        return kept[-1]

    runner.rollout_and_score = wrapped
    return kept


def parity_reward(completions, **kw):
    """A deterministic reward by row (phase 18's GRPO cycle)."""
    return [float(i % 2) for i in range(len(completions))]


def tiny_grpo_cycle(models: dict, tok, data, frames, card: str) -> None:
    """Phase 18's GRPO cycle: one full-parameter make_grpo_step cycle with
    greedy (top_k=1) rollouts on the "batch" backend, the tiny model on the
    card against the same weights on the CPU. The reference policy is
    another seeded tiny model, so the KL term's gradient is real (greedy
    rollouts make a group's G completions one sequence, and the advantages
    of a group sum to 0)."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.data.grpo import GRPODataset
    from video_r2_tpu_torch.models.loader import init_params
    from video_r2_tpu_torch.rewards.format import format_reward
    from video_r2_tpu_torch.train.grpo import GRPOConfig, make_grpo_step
    from video_r2_tpu_torch.train.grpo_runner import GRPORunner
    from video_r2_tpu_torch.train.optim import OptimConfig
    from video_r2_tpu_torch.train.sft import init_train_state

    gcfg = GRPOConfig(num_generations=2, beta=0.04, max_completion_length=TINY_NEW_TOKENS,
                      top_k=1, rollout_backend="batch", logp_chunk_size=64,
                      max_prompt_length=1024)
    sample = GRPODataset([{"video": frames, "conversations": [
        {"from": "human", "value": f"<video>\n{TRAIN_QA[0][0]}"}]}], data)[0]
    snap = {k: v.clone() for k, v in models["cpu"].state_dict().items()}
    ref_state = init_params(models["cpu"].cfg, seed=SEED + 1, device="cpu").state_dict()
    got = {}
    for where, model in models.items():
        model.load_state_dict(snap)
        ref = init_params(model.cfg, seed=SEED + 1, device=model.device)
        ref.load_state_dict(ref_state)
        impl = "flash" if where == "kernel" else "xla"
        model.requires_grad_(True)
        state = init_train_state(dict(model.named_parameters()), OptimConfig())
        step = make_grpo_step(model, gcfg, attn_impl=impl)
        runner = GRPORunner(model, gcfg, tok, [parity_reward, format_reward],
                            ["parity_reward", "format_reward"], step, ref_model=ref,
                            attn_impl=impl)
        kept = recorded(runner)
        _, m = runner.train_cycle(state, [sample])
        got[where] = (kept[0][0]["input_ids"].cpu().numpy(), m["loss"], m["grad_norm"],
                      m["kl"])
    (ids, loss, norm, kl), (ref_ids, ref_loss, ref_norm, ref_kl) = got["kernel"], got["cpu"]
    same = bool(np.array_equal(ids, ref_ids))
    loss_rel, norm_rel = abs(loss - ref_loss) / abs(ref_loss), abs(norm - ref_norm) / ref_norm
    print(f"phase 18 GRPO cycle (full-parameter make_grpo_step, greedy batch rollouts, "
          f"G 2 x {TINY_NEW_TOKENS} tokens) on the card vs the CPU: completion tokens equal "
          f"{same}; loss {loss:.6e} vs {ref_loss:.6e} (rel {loss_rel:.3e}, tol {FP32_TOL}), "
          f"grad_norm {norm:.6e} vs {ref_norm:.6e} (rel {norm_rel:.3e}, tol {FP32_TOL}), kl "
          f"{kl:.6e} vs {ref_kl:.6e} | {card}", flush=True)
    if not (same and loss_rel <= FP32_TOL and norm_rel <= FP32_TOL):
        raise AssertionError(f"phase 18: the tiny GRPO cycle on the card disagrees with the "
                             f"CPU: tokens equal {same}, loss {loss_rel}, grad_norm {norm_rel}")


# ---------------------------------------------------------------------------
# phase 22: speculative decoding and chunked prefill
# ---------------------------------------------------------------------------

class SpecCounter:
    """While active, an engine class's speculative dispatches: the spec_stats
    of the engines they ran on (read against their values at each engine's
    first dispatch), the verify rounds a slot (rounds x active slots), and
    the paged kernels' launches inside them (the verify chunks'), by
    wrapper."""

    def __init__(self, cls):
        self.cls = cls
        self.stats = {}                     # id(spec_stats) -> (spec_stats, at first)
        self.slot_rounds = 0
        self.verify = {}

    def __enter__(self):
        import numpy as np

        from video_r2_tpu_torch.ops import paged_attention as paged

        real = self.real = self.cls._spec_dispatch
        wrappers = {n: getattr(paged, n) for n in ("paged_decode_attention_stacked",
                                                   "paged_decode_attention_stacked_quant")}
        self.verify = dict.fromkeys(wrappers, 0)

        def counted(eng, active, rounds):
            self.stats.setdefault(id(eng.spec_stats), (eng.spec_stats, dict(eng.spec_stats)))
            before = {n: w.launches for n, w in wrappers.items()}
            out = real(eng, active, rounds)
            self.slot_rounds += rounds * int(np.asarray(active).sum())
            for n, w in wrappers.items():
                self.verify[n] += w.launches - before[n]
            return out

        self.cls._spec_dispatch = counted
        return self

    def __exit__(self, *exc):
        self.cls._spec_dispatch = self.real

    def stat(self, key: str) -> int:
        return sum(st[key] - first[key] for st, first in self.stats.values())

    @property
    def verify_launches(self) -> int:
        return sum(self.verify.values())

    def per_round(self) -> float:
        return self.stat("spec_tokens") / max(self.slot_rounds, 1)


class RaggedCounter:
    """While active, counts the grouped FFN's launches made on the MoE
    block's ragged route (models/moe.py: at most RAGGED_MAX_TOKENS tokens);
    the rest of a run's FFN launches took the GMM route."""

    def __enter__(self):
        from video_r2_tpu_torch.ops import moe_ragged

        self.launches, real = {}, moe_ragged.moe_mlp_ragged
        self.mod, self.real = moe_ragged, real

        def counted(*a, **k):
            before = dict(ffn_launches())
            out = real(*a, **k)
            for v, n in ffn_launches().items():
                self.launches[v] = self.launches.get(v, 0) + n - before.get(v, 0)
            return out

        moe_ragged.moe_mlp_ragged = counted
        return self

    def __exit__(self, *exc):
        self.mod.moe_mlp_ragged = self.real


def drive_engine(eng, prompts, T: int, steps: int) -> list:
    """Two prompts admitted, the rest as slots free (mid-stream); every
    answer, in submission order."""
    rids = [eng.submit(p, max_new_tokens=T) for p in prompts[:2]]
    out, left = {}, list(prompts[2:])
    while eng.num_active or left:
        for rid, toks in eng.step(steps):
            out[rid] = [int(t) for t in toks]
        if left and eng.num_active < eng.num_slots:
            rids.append(eng.submit(left.pop(0), max_new_tokens=T))
    return [out[r] for r in rids]


def tiny_spec_check(model, tok, card: str) -> tuple[dict, dict]:
    """Phase 22(b) on the tiny fp32 model on the card: spec (K = 4) against
    plain greedy in generate, the slot engine and the paged engine over fp32
    and int8 pages (three prompts, one lookup-friendly, the third admitted
    mid-stream), then chunked (a chunk of a page) against whole prefill on
    the slot and paged engines, tokens equal each; then the paged kernel at
    the verify chunks it ran (W = K + 1, the two slots' last contexts, fp32
    q over fp32 and over int8 pages) against its plain version. Returns
    ({row of the kernels line: that case}, {row: the launches in the paged
    engines' verify chunks over those pages})."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.engine.chat import pack_prompts
    from video_r2_tpu_torch.engine.continuous import ContinuousEngine, PagedContinuousEngine
    from video_r2_tpu_torch.engine.generate import generate
    from video_r2_tpu_torch.engine.sampling import SamplingParams

    greedy = SamplingParams(max_new_tokens=TINY_NEW_TOKENS, eos_token_ids=(), pad_token_id=0)
    prompts = [tok.encode("the cup is on the table, " * 4)] + [tok.encode(q)
                                                               for q in QUESTIONS[:2]]
    long_p = tok.encode(" ".join(JUDGE_STEPS))                   # > one page of 128
    packed = pack_prompts(prompts, pad_id=0)
    K = SPEC_K_SMALL
    res = {"generate": [generate(model, packed.input_ids, packed.lengths, greedy,
                                 spec_decode=k).sequences for k in (0, K)]}
    kw = dict(num_slots=2, max_len=256, sp=greedy, prompt_buckets=(128, 256))
    with SpecCounter(PagedContinuousEngine) as sc:
        for what, cls, extra in (("slots", ContinuousEngine, {}),
                                 ("paged fp32 pages", PagedContinuousEngine,
                                  {"page_size": PAGE_SIZE}),
                                 ("paged int8 pages", PagedContinuousEngine,
                                  {"page_size": PAGE_SIZE, "kv_quant": "int8"})):
            res[what] = [drive_engine(cls(model, spec_decode=k, **kw, **extra), prompts,
                                      TINY_NEW_TOKENS, 2) for k in (0, K)]
    for what, cls, chunk, extra in (("slots chunked", ContinuousEngine, 64, {}),
                                    ("paged chunked", PagedContinuousEngine, PAGE_SIZE,
                                     {"page_size": PAGE_SIZE})):
        res[what] = [drive_engine(cls(model, prefill_chunk_tokens=c, **kw, **extra),
                                  [long_p, prompts[1]], TINY_NEW_TOKENS, 2)
                     for c in (0, chunk)]
    same = {what: bool(np.array_equal(a, b)) for what, (a, b) in res.items()}
    print(f"phase 22(b) tiny fp32 on the card, K = {K}: spec vs plain greedy tokens equal "
          f"{ {w: v for w, v in same.items() if 'chunked' not in w} }; chunked ({len(long_p)}"
          f"-token prompt) vs whole prefill tokens equal "
          f"{ {w: v for w, v in same.items() if 'chunked' in w} }; paged spec: "
          f"{sc.stat('spec_dispatches')} dispatches, {sc.per_round():.3f} tokens a round a "
          f"slot, verify-chunk launches of the paged kernel {sc.verify} | {card}", flush=True)
    if not all(same.values()) or min(sc.verify.values()) <= 0:
        raise AssertionError(f"phase 22(b): the tiny model's spec or chunked tokens differ "
                             f"from plain greedy on the card, or no verify chunk reached the "
                             f"paged kernel: {same}, {sc.verify}")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    contexts = [len(p) + TINY_NEW_TOKENS for p in prompts[:2]]
    cases, launches = {}, {}
    for row, pages, wrapper in (
            ("paged_decode_attention_stacked_fp32_verify", "fp32",
             "paged_decode_attention_stacked"),
            ("paged_decode_attention_stacked_quant_fp32_verify", "int8_fp32q",
             "paged_decode_attention_stacked_quant")):
        cases[row] = paged_case(gen, f"phase 22(b) tiny verify chunk K={K}, {pages} pages",
                                model.cfg, contexts, K + 1, pages)[wrapper]
        launches[row] = sc.verify[wrapper]
    return cases, launches


def agreement(plain: dict, spec: dict) -> tuple[int, int, int, int]:
    """(answers equal, answers compared, tokens agreeing as a common prefix,
    tokens) between two runs' generated tokens for the same prompts."""
    keys = sorted(set(plain) & set(spec))
    same = sum(plain[k] == spec[k] for k in keys)
    agree = total = 0
    for k in keys:
        a, b = plain[k], spec[k]
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        agree, total = agree + n, total + max(len(a), len(b))
    return same, len(keys), agree, total


def verify_round(eng, prompts: list) -> tuple:
    """One verify round of the served engine (its loop stopped) for
    `prompts`, admitted one by one into free slots with whole prefill: each
    slot's pending token and the K drafts its history gives, at its
    frontier, through the kernels (the paged kernel over int8 pages, the
    int8 linears, the grouped FFN), then through the engine's plain path
    (every kernel on its plain version) teacher-forced on the same chunks.
    Returns (kernel logits [N, K + 1, V], plain logits, chunks, the kernel
    path's launches with the FFN's ragged ones as moe_ffn_int8_ragged, the
    plain path's)."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.engine import continuous
    from video_r2_tpu_torch.engine.spec_decode import embed_chunk
    from video_r2_tpu_torch.models.model import lm_head
    from video_r2_tpu_torch.models.mrope import mrope_cos_sin
    from video_r2_tpu_torch.ops.paged_attention import paged_decode_attention_stacked_plain

    K, ps, pc, model, N = eng.spec_decode, eng._page_size, eng.pcache, eng.model, len(prompts)
    kept = (eng.prefix_cache, eng.prefill_chunk_tokens,
            continuous.paged_decode_attention_stacked)
    eng.prefix_cache, eng.prefill_chunk_tokens = False, 0
    rids = []
    try:
        with torch.inference_mode():
            rids = [eng.submit(ids, 4) for ids in prompts]
            slots = [next(i for i, r in enumerate(eng.slot_req)
                          if r is not None and r.rid == rid) for rid in rids]
            at = eng._t(slots)
            cur = eng._t(eng.cur_len[slots])
            chunk, _ = continuous._spec_draft(eng.hist[at], eng.last_logits[at].argmax(-1),
                                              cur, K, False)
            for slot in slots:
                pc.lengths[slot] = int(eng.cur_len[slot])
                pc.ensure_capacity(slot, K + 1)
            row = pc.page_tables[slots]
            tables = eng._t(np.where(row >= 0, row, eng.trash_page), torch.int32)
            ar = torch.arange(K + 1, device=cur.device)
            tokpos = cur[:, None] + ar
            pid = tables.gather(1, tokpos // ps).long()
            pos = (eng._t(eng.pos_base[slots]) + cur)[:, None] + ar

            def verify():
                emb = embed_chunk(model, chunk)
                cos, sin = mrope_cos_sin(pos[None].expand(3, N, K + 1), model.cfg,
                                         dtype=emb.dtype)
                x = continuous._paged_decoder_pass(model, eng._kv(), emb, cos, sin, pid,
                                                   tokpos % ps, tables, cur, ps)
                return lm_head(model, x).float()                    # [N, K + 1, V]

            reset_launches()
            with RaggedCounter() as rc:
                kernel = verify()
            k_launches = read_launches()
            k_launches["moe_ffn_int8_ragged"] = rc.launches.get("int8", 0)
            set_kernel_impl(model, "plain")
            continuous.paged_decode_attention_stacked = paged_decode_attention_stacked_plain
            reset_launches()
            plain = verify()
            p_launches = read_launches()
    finally:
        set_kernel_impl(model, "kernel")
        (eng.prefix_cache, eng.prefill_chunk_tokens,
         continuous.paged_decode_attention_stacked) = kept
        for rid in rids:
            eng.request_cancel(rid)
        eng.step(1)
    return kernel, plain, chunk, k_launches, p_launches


def verify_round_check(eng, chat, served: list, card: str) -> None:
    """Phase 22(c), the served engine's loop stopped: verify_round at the
    served run's full load (SERVE_SLOTS of its prompts, evenly spaced by
    length from the shortest to the longest: N (K + 1) = 144 rows take the
    int8 wide kernel and the grouped FFN's GMM route) and with one slot (the
    longest of phase 11's TAC-style prompts: K + 1 rows take the int8
    decode kernel and the FFN's ragged route, RAGGED_MAX_TOKENS), each
    against the engine's plain path within JUDGE_LOGITS_TOL, each route
    asserted launched on the kernel path and none on the plain one."""
    import torch

    by_len = sorted(served, key=len)
    full = [list(by_len[round(i * (len(by_len) - 1) / (SERVE_SLOTS - 1))])
            for i in range(SERVE_SLOTS)]
    cases = (("full load", full, ("int8_matmul_wide", "moe_ffn_int8_gmm")),
             ("one slot", judge_prompt_ids(chat.tok, judge_requests()[-1:]),
              ("int8_matmul_decode", "moe_ffn_int8_ragged")))
    names = ("paged_decode_attention_stacked_quant", "int8_matmul", "moe_ffn_int8")
    for what, prompts, routes in cases:
        kernel, plain, chunk, k_launches, p_launches = verify_round(eng, prompts)
        k_launches["moe_ffn_int8_gmm"] = (k_launches["moe_ffn_int8"]
                                          - k_launches["moe_ffn_int8_ragged"])
        N, W = chunk.shape
        rel = rel_l2(kernel, plain)
        worst = max(rel_l2(kernel[b], plain[b]) for b in range(N))
        agree = (kernel.argmax(-1) == plain.argmax(-1)).sum().item()
        print(f"phase 22(c) verify round, {what}: {N} slots x {W} tokens = {N * W} rows "
              f"(prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens; first "
              f"chunk {chunk[0].tolist()}) kernel vs plain path, teacher-forced: logits rel_l2 "
              f"{rel:.3e} (worst slot {worst:.3e}; tol {JUDGE_LOGITS_TOL}), argmax equal at "
              f"{agree} of {N * W} rows; launches kernel path "
              f"{ {n: k_launches[n] for n in names + routes} }, plain "
              f"{ {n: p_launches.get(n, 0) for n in names} } | {card}", flush=True)
        if (any(k_launches[n] <= 0 for n in names + routes)
                or any(p_launches.get(n, 0) for n in names)
                or not (torch.isfinite(kernel).all() and rel <= JUDGE_LOGITS_TOL)):
            raise AssertionError(f"phase 22(c): the verify round ({what}) disagrees with the "
                                 f"plain path ({rel}) or took the wrong route: {k_launches} "
                                 f"/ {p_launches}")
def chunked_prefill_check(eng, chat, card: str) -> None:
    """Phase 22(c), the loop stopped: a ~5k-token judge prompt through the
    served engine's chunked prefill (chunks of 2048: the first through the
    flash prefill, the rest through the suffix prefill over the int8 pages
    so far) against its whole prefill: the last token's logits within
    JUDGE_LOGITS_TOL (the later chunks read the earlier ones' int8-rounded
    pages, the whole prefill its own k / v)."""
    import torch

    user = " ".join(JUDGE_STEPS * 24)
    ids = chat._encode([{"role": "system", "content": JUDGE_SYSTEM},
                        {"role": "user", "content": user}])
    kept = (eng.prefix_cache, eng.prefill_chunk_tokens)
    eng.prefix_cache = False

    def prefilled():
        rid = eng.submit(ids, 4)
        slot = next(i for i, r in enumerate(eng.slot_req) if r is not None and r.rid == rid)
        chunks = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            while eng.prefilling[slot]:
                eng._advance_prefill()
                chunks += 1
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        logits = eng.last_logits[slot].clone()
        eng.request_cancel(rid)
        eng.step(1)
        return logits, chunks, ms

    try:
        chunked, n_chunks, chunk_ms = prefilled()
        eng.prefill_chunk_tokens = 0
        whole, _, _ = prefilled()
    finally:
        eng.prefix_cache, eng.prefill_chunk_tokens = kept
    rel = rel_l2(chunked, whole)
    print(f"phase 22(c) chunked prefill ({len(ids)} tokens in {n_chunks} chunks of "
          f"{eng.prefill_chunk_tokens}, {chunk_ms:.1f} ms) vs the whole prefill: last logits "
          f"rel_l2 {rel:.3e} (tol {JUDGE_LOGITS_TOL}), argmax {int(chunked.argmax())} vs "
          f"{int(whole.argmax())} | {card}", flush=True)
    if not (n_chunks > 1 and torch.isfinite(chunked).all() and rel <= JUDGE_LOGITS_TOL):
        raise AssertionError(f"phase 22(c): the chunked prefill disagrees with the whole "
                             f"one: {rel} over {n_chunks} chunks")


def served_spec_phase(model, tree: Path, card: str, plain: dict) -> dict:
    """Phase 22(c): apps/serve with SPEC_ARGV on phase 21's int8 judge over
    the same TAC / VAS requests through HTTP (serve_http), counted; then
    the verify-round and chunked-prefill checks on the engine. `plain`:
    phase 21's run, printed beside. Returns the launches of the served run
    and, as "verify_launches", the paged kernel's in verify chunks."""
    import torch

    from video_r2_tpu_torch.apps import serve as serve_app
    from video_r2_tpu_torch.apps.common import build_tokenizer
    from video_r2_tpu_torch.engine.continuous import PagedContinuousEngine

    t_phase = time.perf_counter()
    app, opts, _, _ = serve_app.parse_args(list(SPEC_ARGV))
    if (opts["spec_decode"], opts["prefill_chunk_tokens"]) != (SPEC_K, SPEC_CHUNK):
        raise AssertionError(f"phase 22(c): apps/serve parsed {opts}")
    tok = build_tokenizer(app)
    chat = serve_app.build_engine(app, model, tok, max_new_tokens=SERVE_NEW_TOKENS,
                                  num_slots=SERVE_SLOTS, **opts)
    eng = chat._cont
    deferred = []
    real_defer = eng._defer_prefill
    eng._defer_prefill = lambda *a, **k: (deferred.append(a[3]), real_defer(*a, **k))
    with SpecCounter(PagedContinuousEngine) as sc, RaggedCounter() as rc:
        run = serve_http(chat, tree)
    del eng._defer_prefill
    launches = run["launches"]
    launches["moe_ffn_int8_ragged"] = rc.launches.get("int8", 0)
    launches["moe_ffn_int8_gmm"] = run["ffn"].get("int8", 0) - launches["moe_ffn_int8_ragged"]
    st = dict(eng.spec_stats)
    same, n, agree, total = agreement(plain["outputs"], run["outputs"])
    kept = ("flash_attention", "paged_decode_attention_stacked_quant", "int8_matmul",
            "int8_matmul_decode", "int8_matmul_wide", "moe_ffn_int8_ragged", "moe_ffn_int8_gmm")
    print(f"phase 22(c): apps/serve {' '.join(SPEC_ARGV)}: {run['served']} requests, "
          f"{run['failed']} failed, {run['served'] / run['wall']:.4f} requests/s (phase 21 "
          f"plain {plain['served'] / plain['wall']:.4f}); p50 {run['p50']:.3f} s, p95 "
          f"{run['p95']:.3f} s (plain {plain['p50']:.3f} / {plain['p95']:.3f}); slot-tokens "
          f"{run['tokens']} in {run['s']:.3f} s of decode = {run['tokens'] / run['s']:.2f} "
          f"tok/s (plain {plain['tokens'] / plain['s']:.2f}); spec dispatches "
          f"{st['spec_dispatches']}, rounds {st['spec_rounds']}, tokens {st['spec_tokens']} "
          f"({sc.per_round():.3f} tokens a round a slot), plain dispatches "
          f"{st['plain_dispatches']}; chunked prefills {len(deferred)} (prompts "
          f"{sorted(deferred)}); answers equal to phase 21's {same} of {n} prompts, tokens "
          f"agreeing as a prefix {agree} of {total}; admissions {dict(eng.loop_stats)}; launches "
          f"{ {k: launches[k] for k in kept} }, {sc.verify_launches} paged launches in verify "
          f"chunks; peak {run['peak']:.2f} GiB | {card}", flush=True)
    if run["failed"] or run["served"] < 1 + 4 * 16:
        raise AssertionError(f"phase 22(c): failed requests or too few served: {run}")
    # how many prompts chunk varies with the admission route a request
    # takes (a prefix-cache hit or a batched admission prefills whole);
    # chunked_prefill_check holds the chunked prefill itself
    if st["spec_dispatches"] <= 0 or sc.verify_launches <= 0:
        raise AssertionError(f"phase 22(c): no spec dispatch or no verify chunk on the "
                             f"paged kernel: {st}, {sc.verify_launches}")
    # every verify pass carries all SERVE_SLOTS rows (K + 1 tokens each, idle
    # slots too), past RAGGED_MAX_TOKENS: the served run's FFN takes the GMM
    # route; verify_round_check holds that load and, with one slot, the
    # ragged route
    for name in kept:
        if launches[name] <= 0 and name != "moe_ffn_int8_ragged":
            raise AssertionError(f"phase 22(c) launched no {name}: {launches}")
    verify_round_check(eng, chat, list(run["outputs"]), card)
    chunked_prefill_check(eng, chat, card)
    del eng, chat
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 22(c): {time.perf_counter() - t_phase:.1f} s in all | {card}", flush=True)
    return {**launches, "verify_launches": sc.verify["paged_decode_attention_stacked_quant"]}


def spec_eval_pass(model, tok, docs: dict, responses: dict, card: str) -> None:
    """Phase 22(d): phase 20's batch pass again with spec_decode = SPEC_K:
    docs/s and how many answers equal phase 20's (printed: bf16 verify
    chunks and single-token steps round differently)."""
    import torch

    from video_r2_tpu_torch.config import EvalConfig
    from video_r2_tpu_torch.evalharness import EngineModel, evaluate, get_task

    ev = EvalConfig()
    tasks = []
    for t in EVAL_TASKS:
        task = get_task(t, docs=docs[t])
        task.config.generation_kwargs["max_new_tokens"] = EVAL_NEW_TOKENS
        tasks.append(task)
    em = EngineModel(model, tok, max_num_frames=ev.max_num_frames, max_pixels=ev.max_pixels,
                     min_pixels=ev.min_pixels, batch_size=ev.batch_size,
                     system_prompt=ev.system_prompt, attn_impl="flash", engine_mode="batch",
                     spec_decode=SPEC_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = evaluate(em, tasks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {t: [r["resps"][0][0] for r in out["samples"][t]] for t in EVAL_TASKS}
    same = [a == b for t in EVAL_TASKS for a, b in zip(got[t], responses[("batch", t)])]
    n = sum(len(v) for v in got.values())
    print(f"phase 22(d) eval, batch mode with spec_decode = {SPEC_K}: {n} docs in {wall:.3f} s "
          f"= {n / wall:.4f} docs/s; answers equal to phase 20's batch pass {sum(same)} of "
          f"{len(same)} (printed) | {card}", flush=True)
    if n != len(same) or not all(isinstance(x, str) for v in got.values() for x in v):
        raise AssertionError(f"phase 22(d): the spec eval pass lost docs: {n}")


def spec_step_timing(model, card: str) -> int:
    """Phase 22(d): the paged engine (bf16 pages, flash prefill) on the 7B at
    B = SPEC_B, K = SPEC_K: ms of a plain decode step against ms of one
    verify round through _step_spec (9 tokens a slot, the paged kernel at
    63 query rows) and of a round under _reject_all (the zero-acceptance
    floor), medians of 5 after a warm one each. Returns the verify chunks'
    paged launches."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.engine.continuous import PagedContinuousEngine
    from video_r2_tpu_torch.engine.sampling import SamplingParams

    tok = ByteTokenizer()
    sp = SamplingParams(eos_token_ids=(), pad_token_id=0)
    eng = PagedContinuousEngine(model, num_slots=SPEC_B, max_len=2048, sp=sp,
                                attn_impl="flash", page_size=PAGE_SIZE, spec_decode=SPEC_K,
                                prefix_cache=False)
    prompts = [tok.encode((INT4_QUESTIONS[i % 4] + " ") * (2 + i % 3)) for i in range(SPEC_B)]
    rids = eng.submit_batch([(p, 1500) for p in prompts])
    assert None not in rids
    active = np.ones(SPEC_B, bool)

    def plain_step():
        eng._decode_all(active, 1)
        eng.cur_len = eng.cur_len + 1

    def timed(fn):
        fn()
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ms)

    with torch.inference_mode(), SpecCounter(PagedContinuousEngine) as sc:
        plain_ms = timed(plain_step)
        verify_ms = timed(lambda: eng._step_spec(active, 1))
        per_round = sc.per_round()
        eng._spec_reject_all = True
        floor_ms = timed(lambda: eng._step_spec(active, 1))
    print(f"phase 22(d) the 7B's paged engine at B = {SPEC_B}, K = {SPEC_K}: a plain decode step "
          f"{plain_ms:.2f} ms, a verify round {verify_ms:.2f} ms ({per_round:.3f} tokens a "
          f"round a slot before the floor), a _reject_all round {floor_ms:.2f} ms (medians of "
          f"5); {sc.verify_launches} paged launches in verify chunks | {card}", flush=True)
    for r in rids:
        eng.request_cancel(r)
    eng.step(1)
    if sc.verify_launches <= 0:
        raise AssertionError("phase 22(d): no verify chunk reached the paged kernel")
    return sc.verify["paged_decode_attention_stacked"]


# ---------------------------------------------------------------------------
# phase 23: the Qwen3-Next judge (models/qwen3_next.py, engine/next_continuous.py)
# ---------------------------------------------------------------------------

def next_flash_cases(gen, card: str) -> dict:
    """Phase 23(a), flash at head dim 256: the judge's prefill chunk (B = 1,
    S = 2048, 16 / 2 heads, causal; flash_case: vs plain, SDPA, the bound)
    and a prefix continuation (512 suffix rows at q_offset 1536 over 2048
    keys), each also as a device time (a CUDA graph) beside SDPA's."""
    import torch
    import torch.nn.functional as F

    from video_r2_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    B, S, nh, kh, hd = 1, NEXT_CHUNK, 16, 2, 256
    rnd = lambda *s: torch.randn(*s, generator=gen, device=gen.device).to(torch.bfloat16)  # noqa: E731
    q, k, v = rnd(B, S, nh, hd), rnd(B, S, kh, hd), rnd(B, S, kh, hd)
    lengths = torch.full((B,), S, dtype=torch.int32, device=gen.device)
    out = {}
    r = flash_case(gen, "Qwen3-Next prefill chunk, hd 256", q, k, v, lengths, True, None,
                   training=False)["flash_attention"]
    run = lambda: flash_attention(q, k, v, kv_lengths=lengths, causal=True)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                  enable_gqa=True)
    r["device_ms"], r["library_device_ms"] = graph_ms(run), graph_ms(sdpa)
    out["flash_attention_hd256"] = r
    # the continuation: suffix rows [P, S) of the same keys
    P = S - NEXT_SUFFIX
    qs = q[:, P:].contiguous()
    run = lambda: flash_attention(qs, k, v, kv_lengths=lengths, causal=True,  # noqa: E731
                                  q_offset=P)
    plain = lambda: flash_attention_plain(qs, k, v, lengths, True, P)  # noqa: E731
    err, excess = compare(run(), plain())
    mask = (torch.arange(S, device=gen.device)[None, :]
            <= P + torch.arange(NEXT_SUFFIX, device=gen.device)[:, None])
    qst = qs.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qst, kt, vt, attn_mask=mask,  # noqa: E731
                                                  enable_gqa=True)
    pairs = float(mask.sum()) * nh
    r = {"max_abs_err": err, "excess": excess, "ms": cuda_ms(run), "plain_ms": cuda_ms(plain),
         "library_ms": cuda_ms(sdpa), "device_ms": graph_ms(run),
         "library_device_ms": graph_ms(sdpa),
         **bound(4 * hd * pairs, 2 * 2.0 * qs.numel() + 2 * 2.0 * S * kh * hd)}
    report("flash_attention", f"Qwen3-Next prefix continuation, hd 256, q_offset {P}",
           (B, NEXT_SUFFIX, S, nh, kh, hd), **r)
    if not excess <= 1.0:
        raise AssertionError(f"flash_attention hd 256 at q_offset {P} disagrees with its "
                             f"plain version: {excess} x the tolerance")
    out["flash_attention_hd256_offset"] = r
    return out


def next_kernel_cases(card: str, device) -> dict:
    """Phase 23(a): the kernels of the Next path at the judge's shapes, each
    against its plain version: flash at hd 256 (next_flash_cases), the
    grouped FFN in bf16 and with int8 weights at E 512, top 10, H 2048,
    I 512 (ragged decode T = NEXT_DECODE_T, GMM prefill T = NEXT_CHUNK;
    torch._grouped_mm beside the bf16 ones), the int8 linears at the
    served decode's and a prefill chunk's widths; then the delta rule's
    torch time (next_delta_rule_times)."""
    import torch

    from video_r2_tpu_torch.models.qwen3_next import qwen3_next_80b_a3b
    from video_r2_tpu_torch.models.quant import quantize_kernel

    t0 = time.perf_counter()
    cfg = qwen3_next_80b_a3b()
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    results = next_flash_cases(gen, card)
    E, H, I, k = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size, \
        cfg.num_experts_per_tok
    randw = lambda *s: (torch.randn(*s, generator=gen, device=device)  # noqa: E731
                        * s[-2] ** -0.5).to(torch.bfloat16)
    bf16 = {"gate": {"kernel": randw(E, H, I)}, "up": {"kernel": randw(E, H, I)},
            "down": {"kernel": randw(E, I, H)}}
    layer = {"router": randw(H, E), "bf16": bf16,
             "int8": {n: quantize_kernel(leaf["kernel"]) for n, leaf in bf16.items()}}
    for T, layout, variant in ((NEXT_DECODE_T, "ragged", "bf16"), (NEXT_CHUNK, "gmm", "bf16"),
                               (NEXT_DECODE_T, "ragged", "int8"), (NEXT_CHUNK, "gmm", "int8")):
        results[f"moe_ffn_{variant}_{layout}_next"] = moe_ffn_case(gen, layer, T, layout,
                                                                  variant, k)
    del layer, bf16
    torch.cuda.empty_cache()
    # the int8 linears: qkvz (2048 -> 12288) at the served decode's rows and
    # at a verify round's, the DeltaNet out (4096 -> 2048), the gated
    # attention's q (2048 -> 8192)
    kd, vd = cfg.linear_key_dim, cfg.linear_value_dim
    qkvz = 2 * kd + 2 * vd
    results["int8_matmul_next"] = int8_case(gen, "Qwen3-Next qkvz, served decode rows",
                                            NEXT_SLOTS, H, qkvz)
    for what, M, K, N in (("qkvz, a verify round's rows", NEXT_SLOTS * (SPEC_K + 1), H, qkvz),
                          ("DeltaNet out", NEXT_SLOTS, vd, H),
                          ("gated attention q + gate", NEXT_SLOTS, H,
                           2 * cfg.num_attention_heads * cfg.head_dim)):
        int8_case(gen, f"Qwen3-Next {what}", M, K, N, full=False)
    next_delta_rule_times(cfg, device, card)
    print(f"phase 23(a): {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return results


def profiled_launches(fn) -> tuple[int, float]:
    """(CUDA kernel launches, their device ms) of one call of fn under
    torch.profiler (nan ms where it records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), (sum(e.device_time for e in kernels) / 1e3 if kernels
                          else float("nan"))


def next_delta_rule_times(cfg, device, card: str) -> None:
    """The gated delta rule as torch ops (no kernel; the JAX package runs it
    in XLA outside Pallas): one DeltaNet layer's chunked rule over a
    NEXT_CHUNK-token prefill (B = 1, 32 heads of 128 x 128, 64-token
    chunks) and one recurrent decode step at the served slots, and the
    whole layer around each (projections, conv, gated norm), bf16: eager
    ms, device ms (a CUDA graph), launches and device ms under the
    profiler."""
    import torch

    from video_r2_tpu_torch.models import qwen3_next as nx

    gen = torch.Generator(device=device).manual_seed(SEED + 231)
    lp = nx.init_weights_(nx.DeltaNetLayer(cfg, dtype=torch.bfloat16, device=device), gen)
    B, S, H, d = 1, NEXT_CHUNK, cfg.linear_num_value_heads, cfg.linear_key_head_dim
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
    q, k, v = (rnd(B, S, H, d).to(torch.bfloat16) for _ in range(3))
    g, beta = -rnd(B, S, H).abs() * 0.1, torch.rand(B, S, H, generator=gen, device=device)
    h = (rnd(B, S, cfg.hidden_size) * 0.5).to(torch.bfloat16)
    N = NEXT_SLOTS
    st = rnd(N, H, d, d) * 0.01
    conv = torch.zeros(N, cfg.linear_conv_kernel_dim - 1, cfg.conv_dim, dtype=torch.bfloat16,
                       device=device)
    hd_ = h[:1, :1].expand(N, 1, cfg.hidden_size).contiguous()
    cases = {
        f"chunked rule, S={S}": lambda: nx.chunk_gated_delta_rule(q, k, v, g, beta, 64),
        f"recurrent step, B={N}": lambda: nx.recurrent_gated_delta_step(
            q[0, :N], k[0, :N], v[0, :N], g[0, :N], beta[0, :N], st),
        f"DeltaNet layer prefill, S={S}": lambda: nx._deltanet_prefill(
            cfg, lp, h, None, None, 64, True),
        f"DeltaNet layer decode step, B={N}": lambda: nx._deltanet_decode(cfg, lp, hd_, conv, st),
    }
    with torch.inference_mode():
        for what, fn in cases.items():
            n, prof_ms = profiled_launches(fn)
            print(f"delta rule (torch ops, not a kernel) [{what}]: {cuda_ms(fn, iters=5):.4f} "
                  f"ms eager, {graph_ms(fn, iters=5):.4f} ms device (CUDA graph), {n} "
                  f"launches, {prof_ms:.4f} ms busy under the profiler | {card}", flush=True)


def next_small_config():
    """Phase 23(b)'s config: the tiny Next shape at widths the FFN kernels
    take (H 128, expert I 64), fp32, both MoE kernel routes on."""
    from video_r2_tpu_torch.models.qwen3_next import Qwen3NextConfig

    return Qwen3NextConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=8,
        full_attention_interval=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, partial_rotary_factor=0.25, rope_theta=10000.0,
        linear_num_key_heads=2, linear_num_value_heads=4, linear_key_head_dim=32,
        linear_value_head_dim=32, linear_conv_kernel_dim=4, num_experts=8,
        num_experts_per_tok=2, moe_intermediate_size=64, shared_expert_intermediate_size=64,
        moe_ragged_decode=True, moe_gmm_prefill=True, eos_token_id=1, pad_token_id=0,
        dtype="float32")


def next_small_check(card: str, device) -> dict:
    """Phase 23(b): the small fp32 Next model (seeded on the CPU, copied to
    the card) on the card against the same module on the CPU: greedy tokens
    of generate_packed, a NextPrefixStore burst, generate_spec (K = 4) and
    the slot engine (chunked prefill of 32-token chunks, spec K = 4, a
    prompt admitted mid-stream) all equal to the CPU's generate_packed; the
    fp32 flash and grouped-FFN instances launched (counts set to 0 before,
    read after). Returns the launches."""
    import copy

    import numpy as np

    from video_r2_tpu_torch.engine.chat import pack_prompts
    from video_r2_tpu_torch.engine.next_continuous import Qwen3NextContinuousEngine
    from video_r2_tpu_torch.engine.sampling import SamplingParams
    from video_r2_tpu_torch.models import qwen3_next as nx

    t0 = time.perf_counter()
    cfg = next_small_config()
    cpu = nx.init_qwen3_next_params(cfg, seed=SEED + 232, device="cpu")
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(SEED + 23)
    prefix = rng.integers(2, 500, 64).tolist()
    prompts = [prefix + np.tile(rng.integers(2, 500, 5), 8)[:n].tolist() for n in (20, 9, 37)]
    T = 12
    sp = SamplingParams(max_new_tokens=T, eos_token_ids=(), pad_token_id=0)
    packed = pack_prompts(prompts, pad_id=0)
    ref = nx.generate_packed(cpu, cfg, packed.input_ids, packed.lengths, sp).sequences
    reset_launches()
    got = {"generate_packed": nx.generate_packed(gpu, cfg, packed.input_ids, packed.lengths,
                                                 sp).sequences,
           "generate_spec": nx.generate_spec(gpu, cfg, packed.input_ids, packed.lengths, sp,
                                             spec_k=SPEC_K_SMALL).sequences}
    store = nx.NextPrefixStore()
    got["prefix store"] = store.generate(gpu, cfg, prompts, sp).sequences
    eng = Qwen3NextContinuousEngine(gpu, cfg, num_slots=2, max_len=256, sp=sp,
                                    prompt_buckets=(64, 128), prefill_chunk_tokens=32,
                                    spec_decode=SPEC_K_SMALL)
    got["slot engine"] = np.asarray(drive_engine(eng, prompts, T, 2))
    launches = read_launches()
    same = {what: bool(np.array_equal(a, ref)) for what, a in got.items()}
    print(f"phase 23(b) small fp32 Qwen3-Next (H {cfg.hidden_size}, I "
          f"{cfg.moe_intermediate_size}, {cfg.num_hidden_layers} layers) on the card vs the "
          f"CPU: greedy tokens equal {same}; prefix store P = {store.split(prompts)} "
          f"(hits {store.hits}, misses {store.misses}); slot engine spec {eng.spec_stats}; "
          f"launches flash {launches['flash_attention']}, grouped FFN "
          f"{ {v: launches[f'moe_ffn_{v}'] for v in ('fp32',)} }; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    if not all(same.values()) or min(launches["flash_attention"], launches["moe_ffn_fp32"]) <= 0:
        raise AssertionError(f"phase 23(b): the card's tokens differ from the CPU's, or the "
                             f"fp32 flash / FFN instance never ran: {same}, {launches}")
    return launches


class RouteRecorder:
    """While active, models/moe.py's route: "record" keeps every call's
    (weights, expert ids) in order; "replay" returns the recorded ones in
    the same order (the plain path then takes the kernel path's experts);
    "ids" replays the recorded expert ids alone and gathers their weights
    from this call's own router probabilities (so the router keeps its
    gradient path under autograd); "compare" runs the real route and counts
    the tokens whose expert set differs from the recorded call's."""

    def __init__(self, mode: str, calls=None):
        self.mode, self.calls, self.i = mode, calls if calls is not None else [], 0
        self.tokens = self.swapped = 0

    def __enter__(self):
        import torch

        from video_r2_tpu_torch.models import moe

        self.mod, real = moe, moe.route

        def route(router_kernel, x, k, norm_topk_prob):
            if self.mode in ("replay", "ids"):
                self.i += 1
                if self.mode == "replay":
                    return self.calls[self.i - 1]
                topi = self.calls[self.i - 1][1]
                probs = torch.softmax(x.float() @ router_kernel.float(), dim=-1)
                topv = probs.gather(-1, topi)
                if norm_topk_prob:
                    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
                return topv.to(x.dtype), topi
            topv, topi = real(router_kernel, x, k, norm_topk_prob)
            if self.mode == "record":
                self.calls.append((topv.detach(), topi))
            else:
                ref = self.calls[self.i][1]
                self.i += 1
                self.tokens += topi.shape[0]
                self.swapped += int((torch.sort(topi, -1).values
                                     != torch.sort(ref, -1).values).any(-1).sum())
            return topv, topi

        moe.route, self.real = route, real
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real


def next_logits_check(model, tok, card: str) -> None:
    """Phase 23(c): 4 judge prompts' prefill logits (the last valid
    position) through the kernels (flash at hd 256, the grouped FFN) against
    the plain path (dense attention, the FFN's plain version). With noise
    weights, 512 experts and top 10, the 10th and 11th router scores of a
    token lie within bf16 noise of each other, so the two paths' few-ulp
    differences swap experts at many tokens and layers, and the free-running
    logits differ by that chaos (printed, with the tokens whose expert set
    differs). The check holds the plain path to the kernel path's expert
    choices (replayed) and asks relative L2 within JUDGE_LOGITS_TOL there;
    each prefill timed."""
    import torch

    from video_r2_tpu_torch.engine.chat import pack_prompts
    from video_r2_tpu_torch.models import qwen3_next as nx

    ids = judge_prompt_ids(tok, judge_requests()[:4])
    packed = pack_prompts(ids, pad_id=model.cfg.pad_token_id)
    calls = []

    def run(impl, recorder):
        set_kernel_impl(model, impl)
        cfg = model.cfg.replace(attn_impl="auto" if impl == "kernel" else "xla")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorder:
            logits, _ = nx.prefill(model, cfg, packed.input_ids, packed.lengths,
                                   packed.input_ids.shape[1])
        torch.cuda.synchronize()
        set_kernel_impl(model, "kernel")
        return logits.float(), (time.perf_counter() - t0) * 1e3

    kern, k_ms = run("kernel", RouteRecorder("record", calls))
    free = RouteRecorder("compare", calls)
    plain, p_ms = run("plain", free)
    pinned, _ = run("plain", RouteRecorder("replay", calls))
    rel, rel_free = rel_l2(kern, pinned), rel_l2(kern, plain)
    print(f"phase 23(c) prefill logits of 4 judge prompts ({packed.input_ids.shape[1]} "
          f"padded tokens, lengths {[int(n) for n in packed.lengths]}): kernel path "
          f"{k_ms:.1f} ms, plain path {p_ms:.1f} ms; relative L2 {rel:.4e} with the kernel "
          f"path's experts (tolerance {JUDGE_LOGITS_TOL}); free-running {rel_free:.4e}, the "
          f"plain path's expert sets differing at {free.swapped} of {free.tokens} "
          f"(token, layer) routings; argmax equal "
          f"{(kern.argmax(-1) == plain.argmax(-1)).tolist()} | {card}", flush=True)
    if not (torch.isfinite(kern).all() and rel <= JUDGE_LOGITS_TOL):
        raise AssertionError(f"phase 23(c): kernel-path logits off the plain path: {rel}")


def next_prefix_burst(model, tok, card: str) -> None:
    """Phase 23(c): the 16 judge requests (one rubric system prompt) as a
    NextPrefixStore burst, twice: the first prefills the shared prefix
    (a miss), the second continues from the stored state (a hit); each
    burst's wall time and the answers of the two equal."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.engine.sampling import SamplingParams
    from video_r2_tpu_torch.models.qwen3_next import NextPrefixStore

    ids = judge_prompt_ids(tok, judge_requests())
    sp = SamplingParams(max_new_tokens=NEXT_BURST_TOKENS, eos_token_ids=(),
                        pad_token_id=model.cfg.pad_token_id)
    store = NextPrefixStore()
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = store.generate(model, model.cfg, ids, sp)
        runs.append((res.sequences, time.perf_counter() - t0))
    P = store.split(ids)
    print(f"phase 23(c) prefix-store burst: {len(ids)} judge requests, shared prefix P = {P} "
          f"of {min(map(len, ids))}-{max(map(len, ids))} tokens, {NEXT_BURST_TOKENS} tokens "
          f"each: miss {runs[0][1]:.3f} s, hit {runs[1][1]:.3f} s; hits {store.hits}, misses "
          f"{store.misses}; answers equal {bool(np.array_equal(runs[0][0], runs[1][0]))} | "
          f"{card}", flush=True)
    if P <= 0 or (store.hits, store.misses) != (1, 1):
        raise AssertionError(f"phase 23(c): the prefix burst did not hit: P {P}, hits "
                             f"{store.hits}, misses {store.misses}")


def next_judge_phase(card: str, device, tree: Path) -> dict:
    """Phase 23: the Qwen3-Next judge. (a) its kernels at the judge's
    shapes; (b) the small fp32 model on the card vs the CPU; (c)
    qwen3_next_80b_a3b() at full width in bf16, cut to NEXT_LAYERS layers,
    seeded on the card: prefill logits kernel vs plain path, a prefix-store
    burst (launches counted); (d) that model quantized to int8 in place and
    served through apps/serve with NEXT_ARGV (serve_judge.sh's Next flags)
    over HTTP: phase 21's test_judge, TAC and VAS requests (serve_http),
    counted, 0 failed; then a spec dispatch and a plain decode window under
    the profiler (the idle share). Returns ({kernels line row: case},
    {row or wrapper: launches on the Next path})."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.apps import serve as serve_app
    from video_r2_tpu_torch.apps.common import build_tokenizer
    from video_r2_tpu_torch.models import qwen3_next as nx

    t_phase = time.perf_counter()
    results = next_kernel_cases(card, device)
    gc.collect()
    torch.cuda.empty_cache()
    small = next_small_check(card, device)
    results.update(next_train_kernel_cases(card, device))     # phase 24(a)
    small_train = next_small_train_check(card, device)        # phase 24(b)
    # (c): the full-width model, NEXT_LAYERS deep
    app, opts, _, _ = serve_app.parse_args(list(NEXT_ARGV))
    cfg = dataclasses.replace(app.model_config(), num_hidden_layers=NEXT_LAYERS)
    t0 = time.perf_counter()
    model = nx.init_qwen3_next_params(cfg, seed=app.run.seed, device=device)
    torch.cuda.synchronize()
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2 ** 30
    print(f"phase 23(c): qwen3_next_80b_a3b() at full width (H {cfg.hidden_size}, {cfg.num_experts} "
          f"experts top {cfg.num_experts_per_tok}, hd {cfg.head_dim}), bf16, {NEXT_LAYERS} of 48 "
          f"layers ({cfg.num_groups} groups: {cfg.num_groups * 3} DeltaNet + {cfg.num_groups} "
          f"gated attention; 48 layers are ~160 GB in bf16 and ~80 GB with int8 experts, "
          f"more than one card holds): {gib:.1f} GiB of weights built in "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    tok = build_tokenizer(app)
    reset_launches()
    with RaggedCounter() as rc:
        next_logits_check(model, tok, card)
        next_prefix_burst(model, tok, card)
    c_launches = read_launches()
    c_launches["moe_ffn_bf16_ragged"] = rc.launches.get("bf16", 0)
    c_launches["moe_ffn_bf16_gmm"] = c_launches["moe_ffn_bf16"] - c_launches["moe_ffn_bf16_ragged"]
    for name in ("flash_attention", "moe_ffn_bf16_ragged", "moe_ffn_bf16_gmm"):
        if c_launches[name] <= 0:
            raise AssertionError(f"phase 23(c) launched no {name}: {c_launches}")
    train_c = next_lora_phase(model, card)                    # phase 24(c)
    # (d): int8 in place, served as serve_judge.sh serves the Next preset
    t0 = time.perf_counter()
    nx.quantize_qwen3_next_params(model)
    gc.collect()
    torch.cuda.empty_cache()
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2 ** 30
    print(f"phase 23(d): quantize_qwen3_next_params in place: {gib:.1f} GiB in "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    chat = serve_app.build_engine(app, model, tok, max_new_tokens=SERVE_NEW_TOKENS,
                                  num_slots=NEXT_SLOTS, **opts)
    eng = chat._cont
    chunked = []
    real_advance = eng._advance_prefill

    def advance():
        if eng._pending_prefill and eng._pending_prefill[0]["done"] == 0:
            chunked.append(eng._pending_prefill[0]["true_len"])
        real_advance()

    eng._advance_prefill = advance
    with RaggedCounter() as rc:
        run = serve_http(chat, tree)
    del eng._advance_prefill
    launches = run["launches"]
    launches["moe_ffn_int8_ragged"] = rc.launches.get("int8", 0)
    launches["moe_ffn_int8_gmm"] = run["ffn"].get("int8", 0) - launches["moe_ffn_int8_ragged"]
    st = dict(eng.spec_stats)
    kept = ("flash_attention", "moe_ffn_int8_ragged", "moe_ffn_int8_gmm", "int8_matmul",
            "int8_matmul_decode", "int8_matmul_wide")
    print(f"phase 23(d): apps/serve {' '.join(NEXT_ARGV)} (num_slots {NEXT_SLOTS}: a verify "
          f"round's {NEXT_SLOTS} x {SPEC_K + 1} tokens stay within the ragged route's 32) on the "
          f"int8 {NEXT_LAYERS}-layer model: {run['served']} requests, {run['failed']} failed "
          f"in {run['wall']:.3f} s = {run['served'] / run['wall']:.4f} requests/s; client p50 "
          f"{run['p50']:.3f} s, p95 {run['p95']:.3f} s; {run['tokens']} tokens in "
          f"{run['windows']} spec dispatches, {run['s']:.3f} s = {run['tokens'] / run['s']:.2f} "
          f"decode tok/s; spec {st} ({st['spec_tokens'] / max(st['spec_rounds'], 1):.3f} "
          f"tokens a round, all slots); chunked prefills {len(chunked)} (prompts "
          f"{sorted(chunked)}); admissions {dict(eng.loop_stats)}; launches "
          f"{ {k: launches[k] for k in kept} }; peak {run['peak']:.2f} GiB | {card}", flush=True)
    if run["failed"] or run["served"] < 1 + 4 * 16:
        raise AssertionError(f"phase 23(d): failed requests ({run['errors'][:3]}) or too few "
                             f"served ({run['served']})")
    for name in ("flash_attention", "moe_ffn_int8_ragged", "moe_ffn_int8_gmm", "int8_matmul"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 23(d) launched no {name}: {launches}")
    shutil.rmtree(run["out"], ignore_errors=True)
    # the loop stopped: a spec dispatch and a plain decode window under the
    # profiler, counted
    ids = judge_prompt_ids(tok, judge_requests()[:NEXT_SLOTS])
    reset_launches()
    spec_win = profiled_window(eng, [eng.submit(x, 4 * SPEC_K * 8) for x in ids], 8,
                               f"{NEXT_SLOTS} requests, spec K = {SPEC_K} (rounds)")
    eng.spec_decode = 0                    # the same engine, plain decode
    plain_win = profiled_window(eng, [eng.submit(x, 4 * 8) for x in ids], 8,
                                f"{NEXT_SLOTS} requests, plain decode")
    eng.spec_decode = SPEC_K
    win = read_launches()
    print(f"phase 23(d) windows under the profiler: {spec_win}; {plain_win}; launches "
          f"{ {k: win[k] for k in ('moe_ffn_int8', 'int8_matmul', 'int8_matmul_decode', 'int8_matmul_wide')} }"
          f" | {card}", flush=True)
    if win["int8_matmul_decode"] <= 0 or win["moe_ffn_int8"] <= 0:
        raise AssertionError(f"phase 23(d): the decode windows launched no int8 decode "
                             f"kernel or grouped FFN: {win}")
    del eng, chat
    gc.collect()
    torch.cuda.empty_cache()
    train_d = next_qlora_phase(model, card)                   # phase 24(d)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phases 23 and 24: {time.perf_counter() - t_phase:.1f} s in all | {card}",
          flush=True)
    total = {n: c_launches.get(n, 0) + launches.get(n, 0) + win.get(n, 0)
             for n in set(c_launches) | set(launches) | set(win)}
    # phase 24's training launches; every grouped FFN launch there is a GMM one
    train = {n: train_c.get(n, 0) + train_d.get(n, 0) for n in set(train_c) | set(train_d)}
    train["moe_ffn_bf16_gmm"], train["moe_ffn_int8_gmm"] = train_c["moe_ffn_bf16"], \
        train_d["moe_ffn_int8"]
    rows = {"flash_attention_hd256": total["flash_attention"],
            "flash_attention_hd256_offset": c_launches["flash_attention"],
            "moe_ffn_bf16_ragged_next": c_launches["moe_ffn_bf16_ragged"],
            "moe_ffn_bf16_gmm_next": c_launches["moe_ffn_bf16_gmm"],
            "moe_ffn_int8_ragged_next": launches["moe_ffn_int8_ragged"],
            "moe_ffn_int8_gmm_next": launches["moe_ffn_int8_gmm"],
            "int8_matmul_next": total["int8_matmul"],
            **{name: train[base] for name, (base, _) in NEXT_TRAIN_KERNELS.items()}}
    return results, {**rows, "phase23": total, "phase23b": small, "phase24": train,
                     "phase24b": small_train}


# ---------------------------------------------------------------------------
# phase 24: Qwen3-Next training (models/qwen3_next.py::next_loss,
# make_next_lora_sft_step)
# ---------------------------------------------------------------------------

def flash_train_check(what: str, q, k, v, lengths, causal: bool, q_offset: int, seg,
                      dout) -> None:
    """The forward with LSE, dq and dk/dv on one input against their plain
    versions (the backward from the plain forward's out and LSE), at the
    flash bounds; printed, and raised on a miss."""
    from video_r2_tpu_torch.ops.flash import (
        NO_KEY_LSE,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd_lse,
        flash_attention_fwd_lse_plain,
    )

    args = (q, k, v, lengths, causal, q_offset, seg)
    (out, lse), (ref_out, ref_lse) = flash_attention_fwd_lse(*args), \
        flash_attention_fwd_lse_plain(*args)
    bargs = (lengths, causal, q_offset, seg)
    grads = flash_attention_bwd(q, k, v, ref_out, dout, ref_lse, *bargs)
    ref = flash_attention_bwd_plain(q, k, v, ref_out, dout, ref_lse, *bargs)
    err, excess = compare(out, ref_out)
    has_key = ref_lse < NO_KEY_LSE
    lse_err = float((lse - ref_lse)[has_key].abs().max())
    rels = [rel_l2(a, b) for a, b in zip(grads, ref)]
    print(f"kernel flash training kernels [{what}] shape={tuple(q.shape)} x "
          f"{tuple(k.shape)}: out max_abs_err={err:.4g} ({excess:.3f} x the tolerance), lse "
          f"{lse_err:.3e} (tol {LSE_ATOL}), dq / dk / dv rel_l2 "
          f"{' / '.join(f'{r:.3e}' for r in rels)} (tol {GRAD_REL_L2})", flush=True)
    if not (excess <= 1.0 and lse_err <= LSE_ATOL and max(rels) <= GRAD_REL_L2):
        raise AssertionError(f"flash training kernels [{what}] disagree with their plain "
                             f"versions: out {excess}, lse {lse_err}, grads {rels}")


def next_train_kernel_cases(card: str, device) -> dict:
    """Phase 24(a): the kernels of Next training at its shapes, each against
    its plain version. Flash at hd 256 (B = 2, S = 2048, 16 / 2 heads,
    causal, kv lengths (2048, 1536); flash_case: the forward with LSE, dq
    and dk/dv with their times, bounds and SDPA's forward / backward), each
    also as a device time (20 launches in a CUDA graph) beside SDPA's; a
    suffix at q_offset and packed segments checked; then the GMM dX kernel
    at E 512, top 10, T = 4096 (40960 routed rows) with its bound and the
    library call. Returns the kernels-line rows."""
    import torch

    from video_r2_tpu_torch.models.moe import route
    from video_r2_tpu_torch.models.qwen3_next import qwen3_next_80b_a3b
    from video_r2_tpu_torch.ops import moe_gmm as gmm
    from video_r2_tpu_torch.ops.flash import (
        attention_delta,
        flash_attention_fwd_lse,
        flash_attention_fwd_lse_plain,
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
    )

    t0 = time.perf_counter()
    cfg = qwen3_next_80b_a3b()
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    B, S = NEXT_TRAIN_B, NEXT_TRAIN_S
    nh, kh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device).to(torch.bfloat16)  # noqa: E731
    q, k, v, dout = rnd(B, S, nh, hd), rnd(B, S, kh, hd), rnd(B, S, kh, hd), rnd(B, S, nh, hd)
    lengths = torch.tensor(NEXT_TRAIN_LENGTHS, dtype=torch.int32, device=device)
    r = flash_case(gen, "Qwen3-Next training, hd 256", q, k, v, lengths, True, None,
                   training=True)
    out, lse = flash_attention_fwd_lse_plain(q, k, v, lengths, True)
    bargs = (q, k, v, dout, lse, attention_delta(out, dout), lengths, True, 0, None)
    r["flash_attention_fwd_lse"]["device_ms"] = graph_ms(
        lambda: flash_attention_fwd_lse(q, k, v, lengths, True))
    r["flash_bwd_dq"]["device_ms"] = graph_ms(lambda: flash_bwd_dq_cuda(*bargs))
    r["flash_bwd_dkv"]["device_ms"] = graph_ms(lambda: flash_bwd_dkv_cuda(*bargs))
    lib_fwd, lib_fwd_bwd = library_device_ms(q, k, v, admitted(lengths, S, S, True, None)[:, None],
                                             dout)
    r["flash_attention_fwd_lse"]["library_device_ms"] = lib_fwd
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):   # SDPA's backward: fwd + bwd less fwd
        r[name]["library_device_ms"] = lib_fwd_bwd - lib_fwd
    print(f"phase 24(a) hd 256 device ms (CUDA graph): fwd+lse "
          f"{r['flash_attention_fwd_lse']['device_ms']:.4f} (SDPA fwd {lib_fwd:.4f}), dq "
          f"{r['flash_bwd_dq']['device_ms']:.4f} + dk/dv {r['flash_bwd_dkv']['device_ms']:.4f} "
          f"(SDPA bwd {lib_fwd_bwd - lib_fwd:.4f}); bounds "
          f"{r['flash_attention_fwd_lse']['bound_ms']:.4f} / {r['flash_bwd_dq']['bound_ms']:.4f}"
          f" / {r['flash_bwd_dkv']['bound_ms']:.4f} | {card}", flush=True)
    results = {f"{name}_hd256": case for name, case in r.items()}
    del out, lse, bargs
    # a suffix at q_offset over the whole prefix, and packed segments
    P = S - NEXT_SUFFIX
    flash_train_check(f"hd 256, {NEXT_SUFFIX} rows at q_offset {P}", q[:, P:].contiguous(), k,
                      v, torch.full((B,), S, dtype=torch.int32, device=device), True, P, None,
                      dout[:, P:].contiguous())
    pos = torch.arange(S, device=device)
    seg = torch.where(pos < 700, 1, torch.where(pos < 1500, 2, torch.where(pos < 1900, 3, -2)))
    flash_train_check("hd 256, 3 packed segments and padding", q, k, v,
                      torch.full((B,), S, dtype=torch.int32, device=device), True, 0,
                      seg.int()[None].expand(B, S).contiguous(), dout)
    del q, k, v, dout

    # the GMM dX kernel at the Next layer's shapes
    E, H, I, topk = (cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size,
                     cfg.num_experts_per_tok)
    T = NEXT_TRAIN_B * NEXT_TRAIN_S
    randw = lambda *s: (torch.randn(*s, generator=gen, device=device)  # noqa: E731
                        * s[-2] ** -0.5).to(torch.bfloat16)
    wg, wu, wd = randw(E, H, I), randw(E, H, I), randw(E, I, H)
    with torch.no_grad():
        xt = rnd(T, H)
        topv, topi = route(randw(H, E), xt, topk, cfg.norm_topk_prob)
        bm = gmm.auto_block_rows(T * topk, E)
        xs, ids, valid, dst = gmm.gmm_layout(xt, topi, E, bm)
        dys = gmm.sorted_dy(torch.randn(T * topk, H, generator=gen, device=device), topv, dst,
                            xs.shape, xs.dtype)
        dx, dg, du, h = gmm.gmm_bwd_dx(xs, dys, ids, valid, wg, wu, wd, keep_h=True)
        pdx, pdg, pdu, _ = gmm.gmm_bwd_dx_plain(xs, dys, ids, valid, wg, wu, wd)
        rel, terms = rel_l2(dx, pdx), max(compare(a, b)[1] for a, b in ((dg, pdg), (du, pdu)))
        err = float((dx - pdx).abs().max())
        del pdx, pdg, pdu
        n_exp = int(torch.unique(topi).numel())
        run = torch.zeros(E, dtype=torch.int32, device=device).index_add_(
            0, ids.long(), valid.int()) * bm
        lib = gmm_bwd_library(xs, dg, du, h, dys, wg, wu, wd, run)["moe_gmm_bwd_dx"]
        del dx, dg, du, h
        kern = lambda: gmm.gmm_bwd_dx(xs, dys, ids, valid, wg, wu, wd)  # noqa: E731
        dx_r = {"max_abs_err": err, "rel_l2": rel, "ms": cuda_ms(kern, iters=10),
                "device_ms": graph_ms(kern, iters=10),
                "plain_ms": cuda_ms(lambda: gmm.gmm_bwd_dx_plain(xs, dys, ids, valid, wg, wu,
                                                                 wd), iters=2, warmup=1),
                "library_ms": cuda_ms(lib, iters=10) if lib is not None else None,
                **gmm_bwd_bounds(T * topk, n_exp, E, H, I)["moe_gmm_bwd_dx"]}
    report("moe_gmm_bwd_dx", f"Qwen3-Next layer, T={T}, {n_exp} experts routed",
           (xs.shape[0], bm, H, I), **{n: x for n, x in dx_r.items() if x is not None})
    print(f"phase 24(a) dX: {gmm_dx_launch_line(xs.shape[0], bm, H, I)}; terms dg / du "
          f"{terms:.3f} x the tolerance", flush=True)
    if not (rel <= GRAD_REL_L2 and terms <= 1.0):
        raise AssertionError(f"phase 24(a): the dX kernel at the Next shape disagrees with its "
                             f"plain version: rel L2 {rel}, terms {terms}")
    results["moe_gmm_bwd_dx_next"] = dx_r
    del xs, dys, wg, wu, wd, lib
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 24(a): {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return results


def next_small_train_check(card: str, device) -> dict:
    """Phase 24(b): the small fp32 Next model (phase 23(b)'s, seeded on the
    CPU, copied to the card) with the same LoRA adapters (r 8, B drawn
    nonzero) takes one make_next_lora_sft_step step on the card and on the
    CPU: the loss and the adapter gradients within NEXT_SMALL_TRAIN_TOL
    (relative), and the fp32 flash training and grouped FFN / dX instances
    launched (counts set to 0 before, read after). Returns the launches."""
    import copy

    import torch

    from video_r2_tpu_torch.models import qwen3_next as nx
    from video_r2_tpu_torch.train.lora import LoRAConfig, attach_lora, init_lora
    from video_r2_tpu_torch.train.optim import OptimConfig
    from video_r2_tpu_torch.train.sft import init_train_state

    t0 = time.perf_counter()
    cfg = next_small_config()
    cpu = nx.init_qwen3_next_params(cfg, seed=SEED + 241, device="cpu")
    models = {"cpu": cpu, "card": copy.deepcopy(cpu).to(device)}
    lcfg = LoRAConfig(r=8, alpha=16, targets=nx.NEXT_LORA_TARGETS)
    lora = init_lora(cpu, lcfg, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 241)
    for name, t in lora.items():
        if name.endswith("lora_b"):
            t.normal_(0.0, 0.02, generator=gen)
    B, S = 2, 96
    ids = torch.randint(2, cfg.vocab_size, (B, S), generator=gen)
    lengths = torch.tensor([S, 70])
    labels = torch.full_like(ids, -100)
    labels[:, :-1] = ids[:, 1:]
    labels[:, :8] = -100
    labels[1, 69:] = -100
    out, launches = {}, {}
    for where, model in models.items():
        params = attach_lora(model, {n: t.clone().to(model.device) for n, t in lora.items()},
                             lcfg)
        state = init_train_state(params, OptimConfig(learning_rate=NEXT_TRAIN_LR,
                                                     warmup_ratio=0.0, schedule="constant"))
        batch = {n: t.to(model.device) for n, t in
                 (("input_ids", ids), ("labels", labels), ("lengths", lengths))}
        reset_launches()
        state, m = nx.make_next_lora_sft_step(model, cfg)(state, batch)
        if where == "card":
            torch.cuda.synchronize()
            launches = read_launches()
        out[where] = (float(m["loss"]), torch.cat([p.grad.flatten().cpu() for p in
                                                   params.values()]))
    loss_rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = rel_l2(out["card"][1], out["cpu"][1])
    kept = ("flash_attention_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv", "moe_ffn_fp32",
            "moe_gmm_bwd_dx")
    print(f"phase 24(b) small fp32 Qwen3-Next LoRA step on the card vs the CPU (B {B} x S {S}, "
          f"{cfg.num_hidden_layers} layers): loss {out['card'][0]:.6f} vs {out['cpu'][0]:.6f} "
          f"(rel {loss_rel:.3e}), adapter gradients rel L2 {grad_rel:.3e} (tol "
          f"{NEXT_SMALL_TRAIN_TOL}); launches { {n: launches[n] for n in kept} }; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    if not (loss_rel <= NEXT_SMALL_TRAIN_TOL and grad_rel <= NEXT_SMALL_TRAIN_TOL
            and min(launches[n] for n in kept) > 0):
        raise AssertionError(f"phase 24(b): the card's LoRA step differs from the CPU's, or an "
                             f"fp32 instance never ran: loss {loss_rel}, gradients {grad_rel}, "
                             f"{launches}")
    return launches


def next_train_batch(cfg, device) -> dict:
    """NEXT_TRAIN_B rows of seeded token ids, right-padded to NEXT_TRAIN_S at
    NEXT_TRAIN_LENGTHS, the labels the next token (next_loss takes them at
    the same position), -100 over the first NEXT_TRAIN_MASKED positions and
    past each row's end."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 242)
    B, S = NEXT_TRAIN_B, NEXT_TRAIN_S
    lengths = torch.tensor(NEXT_TRAIN_LENGTHS, device=device)
    pos = torch.arange(S, device=device)[None]
    ids = torch.randint(2, cfg.vocab_size, (B, S), generator=gen, device=device)
    ids = torch.where(pos < lengths[:, None], ids, cfg.pad_token_id)
    labels = torch.full_like(ids, -100)
    labels[:, :-1] = ids[:, 1:]
    keep = (pos >= NEXT_TRAIN_MASKED) & (pos < lengths[:, None] - 1)
    return {"input_ids": ids, "labels": torch.where(keep, labels, -100), "lengths": lengths}


def next_train_steps(model, params, batch, what: str, card: str) -> tuple[list, dict, float]:
    """NEXT_TRAIN_STEPS make_next_lora_sft_step steps over `batch` with Adam
    at a constant NEXT_TRAIN_LR, each timed, with the launch counts set to 0
    before and read after: (losses, launches, peak GiB)."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.models import qwen3_next as nx
    from video_r2_tpu_torch.train.optim import OptimConfig
    from video_r2_tpu_torch.train.sft import init_train_state

    state = init_train_state(params, OptimConfig(learning_rate=NEXT_TRAIN_LR, warmup_ratio=0.0,
                                                 schedule="constant"))
    step = nx.make_next_lora_sft_step(model, model.cfg)
    n_tok = int(batch["lengths"].sum())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    for i in range(NEXT_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(float(m["loss"]))
        print(f"{what} step {i + 1}: loss {losses[-1]:.6f}, grad_norm {float(m['grad_norm']):.4e},"
              f" {dt:.3f} s/step, {n_tok / dt:.1f} tokens/s "
              f"({NEXT_TRAIN_B * NEXT_TRAIN_S / dt:.1f} padded)", flush=True)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: losses {losses}")
    return losses, launches, peak


def next_train_want(model, variant: str) -> dict:
    """The launches NEXT_TRAIN_STEPS steps make: per step the flash training
    kernels once a gated attention layer; the grouped FFN twice a MoE layer
    (the forward and the backward's d_topv recompute) and the dX kernel once;
    no dW kernel (no expert trains)."""
    G, L, n = model.cfg.num_groups, model.cfg.num_hidden_layers, NEXT_TRAIN_STEPS
    return {"flash_attention_fwd_lse": G * n, "flash_bwd_dq": G * n, "flash_bwd_dkv": G * n,
            f"moe_ffn_{variant}": 2 * L * n, "moe_gmm_bwd_dx": L * n, "moe_gmm_bwd_dw": 0,
            "moe_gmm_bwd_dwd": 0}


def flash_bwd_bf16_operands(q, k, v, out, dout, lse, kv_lengths, causal=True, q_offset=0,
                            segment_ids=None):
    """ops/flash.py::flash_attention_bwd_plain with P and dS rounded to the
    operands' dtype before the products that take them, where the bf16
    kernels round them (csrc/flash_attn_bwd.cu); the JAX kernels and the
    plain version keep them fp32. The reference that separates a kernel
    fault from that designed rounding in a whole step's gradients."""
    import torch

    from video_r2_tpu_torch.ops.flash import _admitted, _grouped

    B, Sq, nh, hd = q.shape
    Sk, kh = k.shape[1], k.shape[2]
    g, scale = nh // kh, hd ** -0.5
    qf, dof, kf, vf = _grouped(q, kh), _grouped(dout, kh), k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    ok = _admitted(B, Sq, Sk, kv_lengths, causal, q_offset, segment_ids, q.device)
    p = torch.where(ok[:, None, None], torch.exp(s - lse.reshape(B, kh, g, Sq, 1)), 0.0)
    delta = (dof * _grouped(out, kh)).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dof, vf) - delta)
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq.reshape(B, Sq, nh, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class StepKernelChecks:
    """While active, the training step's kernel wrappers (the flash forward
    with LSE and backward, as _FlashFn calls them; the grouped FFN and the
    GMM dX, as _GmmExpertFFN calls them) are stood in for: mode "check"
    returns every kernel's result and holds it against its plain version on
    the same operands (outputs at the kernel tolerance, the LSE at LSE_ATOL,
    gradients at GRAD_REL_L2), keeping the worst of each; mode "plain_bwd"
    runs the backward's plain versions (flash dq / dk / dv and dX) and
    leaves the forwards on the kernels; mode "matched_bwd" the same with
    flash_bwd_bf16_operands for the flash backward; mode "plain" runs the
    flash forward's plain version too (with ffn_impl "plain" on the model:
    the whole plain path). The stand-ins for the forward and dX take the .launches their
    wrappers add to."""

    def __init__(self, mode: str):
        self.mode = mode
        self.worst = {"flash fwd excess": 0.0, "flash lse": 0.0, "flash bwd rel_l2": 0.0,
                      "ffn excess": 0.0, "dX rel_l2": 0.0}
        self.calls = dict.fromkeys(("flash fwd", "flash bwd", "ffn", "dX"), 0)

    def _note(self, key: str, value: float) -> None:
        self.worst[key] = max(self.worst[key], value)

    def __enter__(self):
        from video_r2_tpu_torch.ops import flash as fl
        from video_r2_tpu_torch.ops import moe_gmm as gmm
        from video_r2_tpu_torch.ops import moe_ragged

        self.real = (fl.flash_attention_fwd_lse, fl.flash_attention_bwd,
                     gmm.ragged_expert_ffn, gmm.gmm_bwd_dx)
        real_fwd, real_bwd, real_ffn, real_dx = self.real
        checking = self.mode == "check"

        def fwd(q, k, v, kv_lengths, causal=True, q_offset=0, segment_ids=None):
            if self.mode == "plain":
                return fl.flash_attention_fwd_lse_plain(q, k, v, kv_lengths, causal, q_offset,
                                                        segment_ids)
            out = real_fwd(q, k, v, kv_lengths, causal, q_offset, segment_ids)
            if checking:
                ref = fl.flash_attention_fwd_lse_plain(q, k, v, kv_lengths, causal, q_offset,
                                                       segment_ids)
                self._note("flash fwd excess", compare(out[0], ref[0])[1])
                has_key = ref[1] < fl.NO_KEY_LSE
                self._note("flash lse", float((out[1] - ref[1])[has_key].abs().max()))
                self.calls["flash fwd"] += 1
            return out

        def bwd(q, k, v, out, dout, lse, kv_lengths, causal=True, q_offset=0,
                segment_ids=None):
            args = (q, k, v, out, dout, lse, kv_lengths, causal, q_offset, segment_ids)
            ref = (flash_bwd_bf16_operands if self.mode == "matched_bwd"
                   else fl.flash_attention_bwd_plain)(*args)
            if not checking:
                return ref
            got = real_bwd(*args)
            self._note("flash bwd rel_l2", max(rel_l2(a, b) for a, b in zip(got, ref)))
            self.calls["flash bwd"] += 1
            return got

        def ffn(x, ids, gate, up, down, block_i=512, blk_valid=None, x_scales=None):
            out = real_ffn(x, ids, gate, up, down, block_i=block_i, blk_valid=blk_valid,
                           x_scales=x_scales)
            if checking:
                ref = moe_ragged._plain_ffn(x, ids, gate, up, down, block_i, blk_valid, x_scales)
                self._note("ffn excess", compare(out, ref)[1])
                self.calls["ffn"] += 1
            return out

        def dx(xs, dYs, ids, valid, wg, wu, wd, keep_h=False):
            ref = gmm.gmm_bwd_dx_plain(xs, dYs, ids, valid, wg, wu, wd, keep_h)
            if not checking:
                return ref
            got = real_dx(xs, dYs, ids, valid, wg, wu, wd, keep_h)
            self._note("dX rel_l2", rel_l2(got[0], ref[0]))
            self.calls["dX"] += 1
            return got

        fwd.launches = dx.launches = 0
        fl.flash_attention_fwd_lse, fl.flash_attention_bwd = fwd, bwd
        gmm.ragged_expert_ffn, gmm.gmm_bwd_dx = ffn, dx
        return self

    def __exit__(self, *exc):
        from video_r2_tpu_torch.ops import flash as fl
        from video_r2_tpu_torch.ops import moe_gmm as gmm

        (fl.flash_attention_fwd_lse, fl.flash_attention_bwd, gmm.ragged_expert_ffn,
         gmm.gmm_bwd_dx) = self.real

    def passed(self) -> bool:
        w = self.worst
        return (w["flash fwd excess"] <= 1.0 and w["flash lse"] <= LSE_ATOL
                and w["flash bwd rel_l2"] <= GRAD_REL_L2 and w["ffn excess"] <= 1.0
                and w["dX rel_l2"] <= GRAD_REL_L2 and min(self.calls.values()) > 0)


def next_lora_phase(model, card: str) -> dict:
    """Phase 24(c): LoRA SFT (r 64, alpha 64, NEXT_LORA_TARGETS, B drawn
    nonzero so every adapter has a gradient) over phase 23(c)'s bf16 model
    on next_train_batch, then NEXT_TRAIN_STEPS steps, counted. Step 1,
    every pass with the kernel pass's expert ids (RouteRecorder "ids": the
    pass's own router weights, so the router keeps its gradient):
    - the kernel pass, with every flash forward / backward, grouped FFN and
      dX call of the step held against its plain version on that call's
      own operands (StepKernelChecks "check");
    - the plain path (flash, FFN and the GMM backward all plain): the loss
      within PATH_LOSS_RTOL; its adapter gradients' gap is printed, beside
      the kernel pass run again (the spread from the order of its fp32
      atomic adds alone): at 12 noise-weight layers the step's gradients
      move by more than PATH_GRAD_REL_L2 under any bf16 rounding change
      of the forward (PERF.md §6);
    - the backward's plain versions under the kernel forwards (flash dq /
      dk / dv and dX plain), printed; and the same with the flash backward's
      P and dS rounded where the kernels round them
      (flash_bwd_bf16_operands; the GMM plain versions round where its
      kernels do): adapter gradients within PATH_GRAD_REL_L2 of the kernel
      pass, and the kernel pass with the dX kernel's output zeroed as a
      control the bound must see.
    Leaves the model without adapters. Returns the steps' launches."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.models import qwen3_next as nx
    from video_r2_tpu_torch.ops import moe_gmm as gmm
    from video_r2_tpu_torch.train.lora import (
        LoRAConfig,
        attach_lora,
        detach_lora,
        init_lora,
        lora_param_count,
    )

    t_phase = time.perf_counter()
    lcfg = LoRAConfig(r=64, alpha=64, targets=nx.NEXT_LORA_TARGETS)
    params = attach_lora(model, init_lora(model, lcfg, seed=SEED), lcfg)
    gen = torch.Generator(device=model.device).manual_seed(SEED + 243)
    with torch.no_grad():
        for name, p in params.items():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    batch = next_train_batch(model.cfg, model.device)
    print(f"phase 24(c) batch: B={NEXT_TRAIN_B} x S={NEXT_TRAIN_S}, lengths "
          f"{list(NEXT_TRAIN_LENGTHS)}, labelled {int((batch['labels'] != -100).sum())}; "
          f"{lora_param_count(params) / 1e6:.1f} M adapter params over "
          f"{model.cfg.num_hidden_layers} layers", flush=True)
    real_dx = gmm._bwd_dx_cuda

    def zero_dx(*args):            # the control: the dX kernel's output zeroed
        dx, *rest = real_dx(*args)
        return (torch.zeros_like(dx), *rest)

    checks = StepKernelChecks("check")
    passes = {"kernel": checks, "kernel again": None, "plain": StepKernelChecks("plain"),
              "plain backward": StepKernelChecks("plain_bwd"),
              "matched backward": StepKernelChecks("matched_bwd"), "control": None}
    calls, out = [], {}
    for impl, stand_in in passes.items():
        set_kernel_impl(model, "plain" if impl == "plain" else "kernel")
        gmm._bwd_dx_cuda = zero_dx if impl == "control" else real_dx
        for p in params.values():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with RouteRecorder("record" if impl == "kernel" else "ids", calls), \
                    stand_in or contextlib.nullcontext():
                loss = nx.next_loss(model, model.cfg, batch["input_ids"], batch["labels"],
                                    batch["lengths"])
                loss.backward()
        finally:
            gmm._bwd_dx_cuda = real_dx
        torch.cuda.synchronize()
        out[impl] = (loss.item(), torch.cat([p.grad.flatten() for p in params.values()]),
                     time.perf_counter() - t0)
        del loss
    set_kernel_impl(model, "kernel")
    gk = out["kernel"][1]
    lk, lp = out["kernel"][0], out["plain"][0]
    loss_rel = abs(lk - lp) / abs(lp)
    rel = {impl: rel_l2(out[impl][1], gk) for impl in passes if impl != "kernel"}
    # the control against the bound's reference, as the bound reads it
    control_rel = rel_l2(out["control"][1], out["matched backward"][1])
    print(f"phase 24(c) step 1, every call of the kernel pass vs its plain version on its own "
          f"operands: {checks.calls} calls, worst {checks.worst} (tolerances: x 1.0, "
          f"{LSE_ATOL}, {GRAD_REL_L2})", flush=True)
    print(f"phase 24(c) step 1: loss kernel {lk:.6f} plain path {lp:.6f} (rel {loss_rel:.3e}, "
          f"tol {PATH_LOSS_RTOL}); adapter gradients, relative L2 to the kernel pass: the "
          f"backward's plain versions with the kernels' rounding {rel['matched backward']:.3e} "
          f"(tol {PATH_GRAD_REL_L2}); printed: the backward's plain versions "
          f"{rel['plain backward']:.3e}, the kernel pass again {rel['kernel again']:.3e}, the "
          f"plain path {rel['plain']:.3e}; control (dX zeroed) {control_rel:.3e}; |g| "
          f"{float(gk.norm()):.4e}; "
          f"fwd+bwd s kernel {out['kernel again'][2]:.3f} plain {out['plain'][2]:.3f} | "
          f"{card}", flush=True)
    if not (checks.passed() and np.isfinite(lk) and loss_rel <= PATH_LOSS_RTOL
            and rel["matched backward"] <= PATH_GRAD_REL_L2 and torch.isfinite(gk).all()):
        raise AssertionError(f"phase 24(c): the kernel path disagrees with the plain path: "
                             f"calls {checks.worst}, loss rel {loss_rel}, gradients {rel}")
    if not control_rel > PATH_GRAD_REL_L2:
        raise AssertionError(f"phase 24(c): the bound {PATH_GRAD_REL_L2} does not see a zeroed "
                             f"dX: control rel L2 {control_rel}")
    del out, gk, calls
    losses, launches, peak = next_train_steps(model, params, batch, "phase 24(c) LoRA", card)
    want = next_train_want(model, "bf16")
    print(f"phase 24(c): LoRA SFT over qwen3_next_80b_a3b ({model.cfg.num_hidden_layers} "
          f"layers, bf16), {NEXT_TRAIN_STEPS} steps, peak device memory {peak:.2f} GiB; launches "
          f"{ {n: launches[n] for n in want} }; {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)
    detach_lora(model)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if any(launches[n] != c for n, c in want.items()):
        raise AssertionError(f"phase 24(c): launches {launches}, expected {want}")
    return launches


def next_qlora_phase(model, card: str) -> dict:
    """Phase 24(d): QLoRA over phase 23(d)'s int8 model (after it served):
    init_lora_for_quantized (B = 0) over NEXT_LORA_TARGETS, NEXT_TRAIN_STEPS
    steps over next_train_batch, counted; the loss falls, as the reference's
    test asserts. Leaves the model without adapters. Returns the launches."""
    import torch

    from video_r2_tpu_torch.models import qwen3_next as nx
    from video_r2_tpu_torch.train.lora import (
        LoRAConfig,
        attach_lora,
        detach_lora,
        init_lora_for_quantized,
        lora_param_count,
    )

    t0 = time.perf_counter()
    lcfg = LoRAConfig(r=64, alpha=64, targets=nx.NEXT_LORA_TARGETS)
    params = attach_lora(model, init_lora_for_quantized(model, lcfg, seed=SEED), lcfg)
    batch = next_train_batch(model.cfg, model.device)
    losses, launches, peak = next_train_steps(model, params, batch, "phase 24(d) QLoRA", card)
    want = next_train_want(model, "int8")
    print(f"phase 24(d): QLoRA over the int8 qwen3_next_80b_a3b "
          f"({model.cfg.num_hidden_layers} layers), {lora_param_count(params) / 1e6:.1f} M "
          f"adapter params, {NEXT_TRAIN_STEPS} steps, losses {[f'{x:.6f}' for x in losses]}, "
          f"peak device memory {peak:.2f} GiB; launches { {n: launches[n] for n in want} }; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    detach_lora(model)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if any(launches[n] != c for n, c in want.items()) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 24(d): launches {launches} (expected {want}) or the loss "
                             f"did not fall: {losses}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from video_r2_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = cuda_build.kernels()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({Path(lib._name).name})",
          flush=True)
    for line in register_report(Path(lib._name).with_suffix(".log")):
        print(f"  {line}", flush=True)

    kernel_results, launches = tiny_fp32_phase(card, device)      # phase 18
    gc.collect()
    results, slices = video_slices(card, device)
    kernel_results.update(results)
    launches.update(slices)
    gc.collect()
    torch.cuda.empty_cache()
    kernel_results.update(moe_kernel_phase(device))
    gmm_bwd = gmm_bwd_phase(card, device)
    kernel_results.update(gmm_bwd)
    gc.collect()
    torch.cuda.empty_cache()
    # the dW kernels' launches are phase 14's run (the LoRA step trains no
    # expert and launches none); dX's are phase 15's steps
    launches.update({n: r["launches"] for n, r in gmm_bwd.items()})
    tree = launches.pop("phase20_tree")
    judged = judge_phase(card, device, tree)   # phase 11 with 15, then 21 and 22(c)
    kernel_results["paged_decode_attention_stacked_quant_verify"] = judged.pop(
        "paged_decode_attention_stacked_quant_verify")
    launches.update(judged)
    launches["paged_decode_attention_stacked_quant_verify"] = \
        launches["phase22"]["verify_launches"]
    gc.collect()
    torch.cuda.empty_cache()
    next_results, next_launches = next_judge_phase(card, device, tree)    # phase 23
    kernel_results.update(next_results)
    launches.update(next_launches)
    shutil.rmtree(tree.parent, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    int8_results, int8_launches = int8_serving_phase(    # phases 16, 17 and 17(c)
        card, device, launches["phase19"]["peak_gib"])
    kernel_results.update(int8_results)
    launches.update(int8_launches)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = kernel_results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("device_ms", "library_device_ms") if k in r},
            **({"decode_launches": launches["int8_matmul_decode"]}
               if name == "int8_matmul" else {}),
            # the GRPO paths' launches: phase 19 (LoRA-GRPO, bf16 7B) and 17(c)
            # (QLoRA-GRPO, int8 7B)
            "grpo_launches": {phase: launches[phase].get(name, 0)
                              for phase in ("phase19", "phase17c")},
            # the eval path's launches: phase 20 (batch and paged, bf16 7B)
            "eval_launches": launches["phase20"].get(name, 0),
            # the post-hoc path's: the attention tap (20(c), bf16 7B) and the
            # served judge (21, int8 Qwen3-30B-A3B)
            "posthoc_launches": {phase: launches[phase].get(name, 0)
                                 for phase in ("phase20c", "phase21")},
            # the served judge with spec decode and chunked prefill (22(c))
            "spec_launches": launches["phase22"].get(name, 0),
            # the Qwen3-Next judge (23(c) bf16, 23(d) served int8)
            "next_launches": launches["phase23"].get(name, 0),
            # its training (24(c) LoRA over bf16, 24(d) QLoRA over int8)
            "next_train_launches": launches["phase24"].get(name, 0)})
    for name, (base, case) in VERIFY_KERNELS.items():   # phase 22(a)'s cases
        r = kernel_results[name]
        source, replaces = KERNELS[base]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "case": case, "launches": launches[name],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "device_ms", "library_device_ms")},
            "next_train_launches": launches["phase24"].get(base, 0)})
    # phase 23(a)'s and 24(a)'s cases
    for name, (base, case) in {**NEXT_KERNELS, **NEXT_TRAIN_KERNELS}.items():
        r = kernel_results[name]
        source, replaces = KERNELS[base]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "case": case, "launches": launches[name],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            **{k: r[k] for k in ("device_ms", "library_device_ms") if k in r},
            "next_train_launches": launches["phase24"].get(base, 0)})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
