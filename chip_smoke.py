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
   resident on one);
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
   T = 512) within FP32_TOL; each case prints the kernels it ran (wgmma,
   the decode kernel, mma.sync or fp32), their tile widths, blocks and
   registers;
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
   in a CUDA graph (device times); the kernel against convert + matmul at
   M = 1 to 1024 at gate / up and q, the measurement behind
   INT8_KERNEL_MAX_ROWS; then scripts/microbench_int8.py's comparison at its
   shape (M 64, K 3584, N 18944, L 28): one all-layers launch, 28 stacked
   launches and 28 convert + matmul, in GB/s, with the launch counts set to
   0 before and read after, the all-layers and stacked outputs held against
   their plain versions on three layers; last the flash kernel at phase
   17's prefill shapes, (a)'s quantized fill (B = 16, Sq = Sk = the padded
   prompt, the batch's lengths) and one (b) chunk (64 full prompts of 256);
17. int8 serving (after phase 16, on the same model; the int8 / float byte
   split and peak memory first): (a) the eval backend's configuration, 16
   video questions (8 frames of 392x392 each, questions of different
   lengths, prepared one at a time through DemoRunner) in one
   generate(attn_impl="flash", kv_quant="int8") of 64 greedy tokens, eos
   off, weight-only, with the launch counts set to 0 before and read after
   (the int8 kernel's count derived from the rows each linear sees and
   INT8_KERNEL_MAX_ROWS, asserted); prefill ms, ms per decode step, tok/s;
   request 0's logits after prefill and after one decode step, kernel path
   vs plain path (the int8 kernel's plain version, plain prefill and ViT
   attention); the batch's logits after one decode step over the int8 cache
   vs the bf16 cache; the int8-KV decode attention timed against the bf16
   cache's at (a)'s and (b)'s shapes; (b) bench.py's workload, 256 prompts
   of 256 ids from np.random.default_rng(0), 128 new tokens (eos off, as
   bench.py's scan decodes them all), attn_impl="flash", act_quant="int8"
   (W8A8 prefill and, at B >= 192, W8A8 decode), kv_quant="int8",
   prefill_chunk=64: one warm run, then 3 timed runs, decode tok/s (their
   median, and each) under bench.py's metric name, launches, peak memory.
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
   gradients' global norm within 1e-3 of the CPU's); every fp32 instance
   launched.

Phase order: 18, 1-9, 12-13 (one 7B, freed), 10, 14, 11 with 15 (the
judge, freed), 16-17 (a new 7B).

Prints a JSON line of per-kernel results, then the card line, and last
{"ok": true, "device": {...}}. Any failed phase raises, so the exit code is
non-zero and that line is not printed. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import gc
import json
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


def reset_launches() -> None:
    for fn in counters().values():
        fn.launches = 0
    for variant in ffn_launches():
        ffn_launches()[variant] = 0


def read_launches() -> dict:
    """Every wrapper's count; the grouped FFN's per variant, as moe_ffn_<variant>."""
    out = {name: fn.launches for name, fn in counters().items()}
    out.update({f"moe_ffn_{v}": n for v, n in ffn_launches().items()})
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
    if not (excess <= 1.0 if fp32 else max(rels) <= GRAD_REL_L2):
        raise AssertionError(f"window_attention_bwd [{what}] disagrees with its plain "
                             f"version: relative L2 dq/dk/dv {rels}, {excess} x the "
                             f"tolerance")
    return {"window_attention_bwd": r}


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
    """One line per compiled kernel: registers and spill bytes (ptxas -v)."""
    out, name = [], None
    spill = ""
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?\d+(flash_fwd_kernel|"
                      r"flash_bwd_dq_kernel|flash_bwd_dkv_kernel|window_attn_kernel|"
                      r"window_attn_bwd_kernel|moe_gate_up_kernel|moe_down_kernel|"
                      r"moe_gate_up_wgmma_kernel|moe_down_wgmma_kernel|moe_decode_kernel|"
                      r"gmm_bwd_terms_kernel|gmm_bwd_dx_kernel|gmm_bwd_dw_wgmma_kernel|"
                      r"int4_matmul_kernel|"
                      r"int4_matmul_f32_kernel|int8_matmul_kernel|tc_kernel|f32_kernel)"
                      r"I(\w+)'", line)
        if m:
            name, spill = f"{m.group(1)}<{','.join(template_args(m.group(2)))}>", ""
        elif "spill stores" in line:
            spill = line.strip()
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
    the model's 28 layers; each timed launch reads the next layer, so its
    pages come from device memory, as in the decode step, where each
    layer's weights pass through the L2 cache between two calls. pages:
    "bf16" (bf16 q), "int8" (bf16 q over int8 pages) or "fp32" (fp32 q and
    pages). Kernel and library call are timed eagerly (ms, library_ms: at
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
    quant, fp32 = pages == "int8", pages == "fp32"
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


def teacher_forced_logits(model, runner, req, tokens):
    """The contiguous plain path (engine/generate.py prefill, then decode
    forwards over the cache) fed the given tokens: the logits after them."""
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
                runner.vision_embeds(req, "xla"), cfg.video_token_id, attn_impl="xla")
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
    err, excess = compare(out, ref)
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
         **bound(4.0 * nh * hd * keys, 4.0 * q.numel() + 2.0 * 2 * keys * kh * hd
                 + 4.0 * B)}
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
        answers.append(runner.answer(f, q, max_new_tokens=NEW_TOKENS))
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

    # phase 9: batched serving through the paged engine
    paged_runs = serving_phase(model, runner, requests, card)

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
    return kernel_results, launches


FP32_KERNELS = ("flash_attention", "window_attention", "flash_attention_fwd_lse",
                "flash_bwd_dq", "flash_bwd_dkv", "window_attention_bwd")


def tiny_fp32_phase(card: str, device) -> tuple[dict, dict]:
    """Phase 18: tiny_test_config() (fp32; text head dim 12, vision 16) on
    the card through the fp32 instances of the flash and window kernels.
    First each instance against its plain version at the path's shapes
    (the prefill, the tower's windows and full-attention groups, the SFT
    batch's decoder and tower), timed; then, counted, a video question's
    prefill logits and greedy tokens (DemoRunner.generate) and one
    make_sft_step step (the tower trained), each against the same weights on
    the CPU (the plain paths). Returns ({<kernel>_fp32: result}, {<kernel>
    _fp32: launches of the counted run})."""
    import numpy as np
    import torch

    from video_r2_tpu_torch.apps.demo import DemoRunner
    from video_r2_tpu_torch.data.config import DataConfig
    from video_r2_tpu_torch.data.sft import SFTCollator, SFTDataset
    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.engine.generate import prefill
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

    # the path, counted: a question (prefill logits, greedy tokens), one SFT step
    reset_launches()
    logits, tokens, metrics = {}, {}, {}
    for where, model in models.items():
        runner, dev = runners[where], model.device
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
    torch.cuda.synchronize()
    counted = read_launches()
    rel = rel_l2(logits["kernel"], logits["cpu"])
    same = bool(np.array_equal(tokens["kernel"], tokens["cpu"]))
    (loss, norm), (ref_loss, ref_norm) = metrics["kernel"], metrics["cpu"]
    loss_rel, norm_rel = abs(loss - ref_loss) / abs(ref_loss), abs(norm - ref_norm) / ref_norm
    launches = {f"{n}_fp32": counted[n] for n in FP32_KERNELS}
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
    return {f"{n}_fp32": r for n, r in results.items()}, launches


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
        kgu = f"moe_decode_kernel<{nt},{gu // 64},2>"
        kdn = f"moe_decode_kernel<{nt},{dn // 64},1>"
        return (f"decode: tokens in boxes of {rows} rows; gate / up {gu} columns of I, "
                f"{A * (I // gu)} blocks, {REGISTERS.get(kgu, 'registers not reported')}; "
                f"down {dn} columns of H, {A * (H // dn)} blocks, "
                f"{REGISTERS.get(kdn, 'registers not reported')}")
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


def moe_case(gen, layer, T: int, layout: str, variant: str) -> dict:
    """The grouped FFN kernel at one judge shape (T tokens routed top 8, in
    the ragged decode table or the GMM prefill blocks) against its plain
    version, with both times, the library call's and the bound; at decode
    (the ragged table) also both device times (CUDA graphs)."""
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
    k = 8
    x = torch.randn(T, H, generator=gen, device=gen.device)
    x = x if variant == "fp32" else x.to(torch.bfloat16)
    _, topi = route(router.to(x.dtype), x, k, True)
    if layout == "ragged":
        xs, ids, valid, _ = ragged_layout(x, topi, E)
    else:
        xs, ids, valid, _ = gmm_layout(x, topi, E, auto_block_rows(T * k, E))
    kw = {}
    if variant == "w8a8":
        xs, ax = quantize_rows(xs)
        kw["x_scales"] = ax
    g, u, d = (leaves[n] for n in ("gate", "up", "down"))
    bi = _block_i(xs, moe_ragged._weights(g, u, d)[1], kw.get("x_scales"), 512)
    before = ffn_launches()[variant]
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
    if layout == "ragged":
        r["device_ms"] = graph_ms(run)
        if library is not None:
            try:       # a capability probe of the yardstick, not of the port
                r["library_device_ms"] = graph_ms(library)
            except RuntimeError as e:
                print(f"torch._grouped_mm does not capture in a CUDA graph ({str(e)[:160]}); "
                      f"no library device time", flush=True)
    name = f"moe_ffn_{variant}_{layout}"
    what = f"{variant} {'ragged decode' if layout == 'ragged' else 'GMM prefill'}, T={T}"
    report(name, what, (A, C, H, I), experts=n_exp, slack_blocks=slack, bi=bi,
           launches=ffn_launches()[variant] - before,
           **{k_: v for k_, v in r.items() if v is not None})
    if not (torch.isfinite(out).all() and excess <= 1.0 and not out[valid == 0].any()):
        raise AssertionError(f"{name} [{what}] disagrees with its plain version: "
                             f"{excess} x the tolerance")
    return {**r, "blocks": A, "rows": C}


def moe_ffn_case(gen, layer, T: int, layout: str, variant: str) -> dict:
    """moe_case, then the kernels it ran: path, tiles, blocks, registers."""
    r = moe_case(gen, layer, T, layout, variant)
    H, I = layer["bf16"]["gate"]["kernel"].shape[1:]
    launch = ffn_launch_line(variant, r["blocks"], r["rows"], H, I)
    print(f"moe_ffn_{variant}_{layout} T={T}: {launch}", flush=True)
    return r


def moe_kernel_phase(device) -> dict:
    """Phase 10: the grouped FFN at the judge's shapes, one full layer's
    weights (bf16, and their int8 quantization): first the table's shapes
    (T = 16 decode, T = 4096 prefill; these give the kernels line), then the
    token counts phase 11's passes give it (the bf16 burst's prefill, the
    int8 pass's prefill and decode, the paged pass's decode) and phase 15's
    LoRA step (its 2 x 1024 tokens, bf16)."""
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
    counts."""

    def __init__(self, keep: bool):
        from video_r2_tpu_torch.ops import moe_ragged

        self.real = moe_ragged.ragged_expert_ffn
        self.launches = self.real.launches
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


def judge_phase(card: str, device) -> dict:
    """Phase 11. Returns the launches of the judge's bf16 run (bf16 FFN
    entries) and of its int8 pass (int8 and W8A8 entries)."""
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
          f"{JUDGE_INT8_TOL}), argmax agreement {agree:.2f}; launches {launches8}",
          flush=True)
    if not (torch.isfinite(got8).all() and rel8 <= JUDGE_INT8_TOL):
        raise AssertionError(f"W8A8 judge logits disagree with bf16: {rel8}")
    for name in ("moe_ffn_w8a8_gmm", "moe_ffn_int8_ragged"):
        if launches8[name] <= 0:
            raise AssertionError(f"the int8 pass launched no {name} kernel: {launches8}")
    if launches8["moe_ffn_int8_gmm"] or launches8["moe_ffn_w8a8"] != launches8["moe_ffn_w8a8_gmm"]:
        raise AssertionError(f"the int8 pass ran W8A8 in decode or int8 weights with bf16 "
                             f"activations in prefill: {launches8}")

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
          f"{DECODE_STEPS}); launches {launchesp}", flush=True)
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
    return {"moe_ffn_bf16_ragged": launches["moe_ffn_bf16_ragged"],
            "moe_ffn_bf16_gmm": launches["moe_ffn_bf16_gmm"],
            "moe_ffn_int8_ragged": launches8["moe_ffn_int8_ragged"],
            "moe_ffn_int8_gmm": launchesp["moe_ffn_int8_gmm"],
            "moe_ffn_w8a8_gmm": launches8["moe_ffn_w8a8_gmm"], **trained}


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


def int8_case(gen, what: str, M: int, K: int, N: int, full: bool = True) -> dict:
    """The int8 kernel at one shape against its plain version, cold weights;
    full: also the plain version's and _weight_int8pack_mm's times (else
    the kernel and convert + matmul only, for the row-limit table)."""
    import math

    import torch

    from video_r2_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

    wq, sc = int8_weights(gen, K, N)
    x = torch.randn(M, K, generator=gen, device=gen.device).to(torch.bfloat16)
    w_bytes = wq.numel() + 4.0 * sc.numel()
    copies = max(1, math.ceil(COLD_BYTES / w_bytes))
    rot = rotation(x, wq, sc, copies)
    out, ref = int8_matmul(x, wq, sc), int8_matmul_plain(x, wq, sc)
    err, excess = compare(out, ref)
    r = {"max_abs_err": err, "excess": excess, "ms": cuda_ms(rot(int8_matmul)),
         "library_ms": cuda_ms(rot(convert_matmul)),
         **bound(2.0 * M * K * N, 2.0 * M * K + w_bytes + 2.0 * M * N)}
    extra = {}
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
    report("int8_matmul", what, (M, K, N), copies=copies, **r, **extra)
    if not (torch.isfinite(out).all() and excess <= 1.0):
        raise AssertionError(f"int8_matmul [{what}] disagrees with its plain version: "
                             f"{excess} x the tolerance")
    del out, ref, rot
    torch.cuda.empty_cache()
    return r


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
          f"{bw(all_ms):.0f} GB/s | stacked ({L} launches) {stacked_ms:.4f} ms "
          f"{bw(stacked_ms):.0f} GB/s | convert + matmul x {L} {conv_ms:.4f} ms "
          f"{bw(conv_ms):.0f} GB/s | one convert + matmul over the stack {lib_all:.4f} ms | "
          f"plain {plain_all:.4f} ms; kernel vs plain on layers 0, {L // 2}, {L - 1}: "
          f"{worst:.3f} x the tolerance; launches {counted['int8_matmul_all_layers']} "
          f"all-layers, {counted['int8_matmul_stacked']} stacked", flush=True)
    if not (torch.isfinite(out_all).all() and worst <= 1.0):
        raise AssertionError(f"the microbench's int8 kernels disagree with plain: {worst}")
    per = lambda n_layers: bound(2.0 * M * K * N * n_layers,  # noqa: E731
                                 2.0 * M * K + n_layers * (K * N + 4.0 * N + 2.0 * M * N))
    del wq, out_all
    torch.cuda.empty_cache()
    return {"int8_matmul_all_layers": {
                "max_abs_err": err_all, "ms": all_ms, "plain_ms": plain_all,
                "library_ms": lib_all, "launches": counted["int8_matmul_all_layers"], **per(L)},
            "int8_matmul_stacked": {
                "max_abs_err": err_all, "ms": stacked_ms / L, "plain_ms": plain_all / L,
                "library_ms": conv_ms / L, "launches": counted["int8_matmul_stacked"],
                **per(1)}}


def int8_kernel_phase(cfg, batch, device) -> dict:
    """Phase 16. Returns the kernels line's rows of the three entries:
    decode gate / up at B = 16; the microbench's stacked and all-layers."""
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
            table[(M, what)] = (r["ms"], r["library_ms"])
    wins = [M for M in INT8_ROWS if all(table[(M, w)][0] <= table[(M, w)][1]
                                        for w in ("gate / up", "q"))]
    print("INT8_KERNEL_MAX_ROWS table (ms, kernel / convert + matmul, cold weights): "
          + "; ".join(f"M={M}: gate / up {table[(M, 'gate / up')][0]:.4f} / "
                      f"{table[(M, 'gate / up')][1]:.4f}, q {table[(M, 'q')][0]:.4f} / "
                      f"{table[(M, 'q')][1]:.4f}" for M in INT8_ROWS)
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
    return {"int8_matmul": results[(B, H, I)], **micro}


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


def int8_serving_phase(card: str, device) -> tuple[dict, dict]:
    """Phases 16 and 17 on a fresh Qwen2.5-VL-7B, int8 in place. Returns
    (kernels line rows, launches)."""
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
    print(f"int8 serving (a): {B} videos, prompt lengths {packed.lengths.tolist()} padded to "
          f"{S}, {T} greedy tokens each (eos off), weight-only, int8 KV: ViT {vit_ms:.1f} ms "
          f"({B} videos), prefill {(marks[1] - marks[0]) * 1e3:.1f} ms, {steps} decode steps "
          f"of {dec_s / steps * 1e3:.2f} ms, {B * steps / dec_s:.2f} tok/s, peak device "
          f"memory {peak:.2f} GiB; launches {counted} (int8 expected {want}: {parts}) | "
          f"{card}", flush=True)
    if res.sequences.shape != (B, T) or steps != T - 1:
        raise AssertionError(f"int8 generate: {res.sequences.shape} tokens, {steps} steps")
    if not ((res.sequences >= 0) & (res.sequences < cfg.text.vocab_size)).all():
        raise AssertionError("int8 generate: token ids out of the vocabulary")
    if counted["int8_matmul"] != want:
        raise AssertionError(f"the int8 slice launched {counted['int8_matmul']} int8 "
                             f"kernels, not {want} ({parts})")
    for name in ("flash_attention", "window_attention"):
        if counted[name] <= 0:
            raise AssertionError(f"the int8 slice launched no {name} kernel")
    launches["int8_matmul"] = counted["int8_matmul"]

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
          f"{[round(t, 4) for t in times]} s, peak device memory {peak:.2f} GiB; launches of "
          f"the last run {bench_launches}", flush=True)
    print(json.dumps({"metric": BENCH_METRIC, "value": round(statistics.median(tok_s), 1),
                      "runs": [round(t, 1) for t in tok_s], "unit": "tokens/sec",
                      "card": card}), flush=True)
    if res.sequences.shape != (BENCH_B, BENCH_NEW) or not (
            (res.sequences >= 0) & (res.sequences < cfg.text.vocab_size)).all():
        raise AssertionError(f"bench workload: bad tokens {res.sequences.shape}")
    if bench_launches["flash_attention"] <= 0:
        raise AssertionError("the bench workload launched no flash kernel")
    return kernel_results, launches


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
    launches.update(judge_phase(card, device))
    gc.collect()
    torch.cuda.empty_cache()
    int8_results, int8_launches = int8_serving_phase(card, device)   # phases 16 and 17
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
            **{k: r[k] for k in ("device_ms", "library_device_ms") if k in r}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
