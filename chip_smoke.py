#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card.

  python chip_smoke.py
  python chip_smoke.py --parent OLD_CSRC_DIR
      [--ab tcq2_gemv|tcq2_wide|tcq2mix_wide|tcq1_wide|tcq2mix|tcq1_gemv|
            tcq_lut|vq|vq4|dequant]
  python chip_smoke.py --rows
  python chip_smoke.py --serve
  python chip_smoke.py --msq
  python chip_smoke.py --quant
  python chip_smoke.py --tp
  python chip_smoke.py --recapture N

With --parent it runs only parent_ab (see there): K1 sum2 and the 215
decode (--ab tcq2_gemv, the default), K1 sum2 above 8 rows at the 215
shapes at N = 16/64/256 with the zero-shot run, an a8 512-token 215
prefill and the 215 decode (--ab tcq2_wide, ab_wide), K1 dualmad above 8
rows at Path A's qkv and ug at N = 16/64/256 (exact and a8) with the Path
A zero-shot run, an a8 512-token Path A prefill, the Path A and the 215
decode (--ab tcq2mix_wide, ab_wide), K1 1mad above 8 rows at Path A's o
and down and 2mad at 4096x4096 with the same runs (--ab tcq1_wide,
ab_wide), K1 dualmad at Path A's shapes with
K1 sum2 at the 215 shapes and the Path A a8 decode (--ab tcq2mix), K1
1mad at Path A's shapes with 2mad at 4096x4096 and the Path A a8 decode
(--ab tcq1_gemv), the LUT GEMVs and the flagship decode (--ab tcq_lut),
K8 at Path C's and Path D's shapes, every other ldlq scheme at o and
down, and the Path C decode (--ab vq), or K8 at vec 4 (ldlq_4_8) at Path
F's o and down, summed apart over a 32-layer forward, the other vec-4
bits at o and down, and the Path F decode (--ab vq4), with the source
against the same
source of an older tree's qpalette_tpu_torch/csrc (e.g. unpacked with
`git archive`); --ab dequant (ab_dequant) takes both dequant sources,
arith_dequant.cu and tcq_lut.cu: K3 and K7 at 4096x4096 with K2 and K6
beside them, K3/K2 over the tcq2mix prefill's calls, K2 over the 215's
and K7/K6 over the flagship prefill's, the Path B exact 512-token
prefill and the Path E decode (tokens/s and each replay's time; the
sources and the turns through dequant_turns).  With --rows it runs only
k1_rows (phase 3's K1 dualmad,
1mad and 2mad above 8 rows), with --serve only the serving phases (6b,
6c), with --msq only the MSQ phase (12), with --quant only the
quantization phase (13), with --tp only the tensor-parallel phase (14),
beam and refine (15), and phase 14's comparison at 8 and 32 layers
(printed, not held).
With --recapture N it runs
only recapture:
fresh captures of the 215 step timed over N consecutive windows of
replays.

Phases (each raises on failure):
  1. card: name, count, power limit; no CUDA device -> exit 1
  2. build every CUDA library from qpalette_tpu_torch/csrc, one nvcc each,
     all started together (ptxas -v: registers, shared memory, spills)
  3. the arithmetic trellis GEMV (K1) against its plain PyTorch version:
     sum2 at every Llama-3.1-8B shape of the 215.0thp_cc path (N in
     {1,4,16}: the tensor-core kernel at N <= 8, two launches bit-equal at
     N=4; wide_gemv_kernel at 16); dualmad, 1mad, 2mad and odd-KV sum2
     at every shape of bench.py's tcq2mix scheme plus 4096x4096 and odd
     k/16 shapes (N in {1,8,256}; every mode on its tensor-core kernel at
     N <= 8, two launches bit-equal at N=8); exact and a8; kernel and
     plain times at N=1 on Path A's shapes, kernel times of 2mad (on no
     path) at 4096x4096; K1 sum2 above 8 rows (wide_gemv_kernel, its x
     prologue a second launch) at the 215 shapes: against its plain
     version at N in {9, 16, 49, 64, 191, 256}, exact and a8, two launches
     bit-equal at 191, and timed at N in {16, 64, 256} (a zero-shot
     forward's rows: layers exact, head a8) beside the bound, the dequant
     route (K2 + the f32 product) and, at N=64, the plain version; K1
     dualmad, 1mad and 2mad above 8 rows (wide_gemv_kernel under the V=2
     and V=1 tile policies) against their plain versions at Path A's
     shapes (2mad at 4096x4096) and the odd k/16 ones at N in {9, 16, 49,
     64, 191, 256}, exact and a8, two launches bit-equal at 191, and
     timed at Path A's shapes at N in {16, 64, 256}, exact and a8,
     beside the bound (exact at the tf32 peak), the dequant route and, at
     N=64, the plain version, summed over a Path A forward's calls, with
     the SM clock sampled (k1_rows)
  4. the arithmetic dequants (K2 tcq2, K3 tcq1) bit-equal to their plain
     versions at the tcq2mix and 215 shapes; kernel and plain times
  5. the LUT trellis kernels (K4-K7) against their plain versions at every
     shape of the 3.25-bit flagship and, at KV 3 (tcq_3, tcomb_3_4), at o
     and down: GEMV (N = 1..8, within 1e-4 of max|y|; two launches
     bit-equal), dequant (bit-equal), the dequant + product at N=16; times
     at the flagship's shapes (the GEMV's: ms a call, GB/s of packed
     trellis, share of the bound, the table layout in use)
  5b. the SQ/VQ row-pack kernels (K8 vq_gemv, K9 vq_dequant) against their
     plain versions: ldlq_2_6 (bits 6, vec 2) at the four 8B shapes and
     every ldlq (bits, vec) at o and down; K8 at N = 1..8 within 1e-4 of
     max|y| (and at m = 4100, not a multiple of 16), two launches bit-equal
     at N = 8, K9 bit-equal; times (kernel at every shape, plain at Path
     C's)
  5c. the int8 lm_head GEMVs (K10 int8_gemv_a8 bit-equal, K11 int8_gemv
     within 1e-5) at the 129024x4096 head, N in {1,8}; times with
     torch._int_mm on the same int8 operands as K10's yardstick
  5d. the merged shapes: K4/K5 at m = 2048, 5120, 6144, 28672 (kv, qk/qv,
     qkv, ug; k 4096), K1 sum2/dualmad/1mad and K8 at 2048 and 5120, N in
     {1,8}; comb as two K4 calls (N <= 8) or two K6 calls (N = 12) over
     unequal 16-row halves; the dequant route (impl dequant) of every kind
     at a merged shape, W_hat bit-equal to the plain version's
  6. the 215 path: the 8B model from the 215.0thp_cc solver output (merged
     qkv/ug, 4-bit tcq2s lm_head, impl a8, dummy weights from seed 0) on
     cuda:0; prefill 16 tokens and decode 8 at temperature 0.6, top-k 5,
     129 sum2 K1 calls per forward (the prefill's at 16 rows two launches
     each); then the zero-shot harness on it at impl exact (see 10c) and
     a warm 512-token prefill at a8 (K1 in 256-row chunks)
  6b. serving (runtime/serving.py) on the 215 model: a 16-slot pool step
     captured (129 K1 sum2 calls on wide_gemv_kernel), 2 replays
     bit-equal to 2 eager pool steps, an admission leaving the other
     slots' cache rows bit-unchanged, 32 requests (prompts 24-300 tokens,
     8-64 new, bursts of 16, temperature 0.6, top-k 5) each ending with
     its tokens or at a full cache (tokens/s, admission s, steps, bursts,
     peak memory, SM clock), and a greedy exact run whose every token is
     a B=1 eager forward's argmax or within NEAR_TIE_8B of it
 6c. python -m qpalette_tpu_torch.bench_serving at its defaults (4 slots,
     the rotated int8 head: K10 in the pool step); its JSON line
 7. the flagship path: the 8B model from the 3.25-bit mem-constrained
     solver output (unmerged tcq 6/8/10 and tcomb 8/9, bf16 lm_head, impl
     exact, dummy weights from seed 0); the 16-token prefill launches 194
     tcq + 30 tcomb dequants, each of 8 decode forwards 194 tcq + 30
     tcomb GEMVs; then ctx-8192 perplexity on it at impl dequant (10c)
  8. Path A: the 8B tcq2mix model (merged qkv tcq2_6 and ug tcq2_7 in mode
     dualmad, o/down tcq1_3 in mode 1mad, the 4-bit tcq2s_8 lm_head), impl
     a8 and impl exact; prefill 16 and decode 8, 129 K1 launches per
     decode forward (32 dualmad KV6 + 32 dualmad KV7, 64 1mad KV3, 1
     sum2), 258 in the prefill (every call on wide_gemv_kernel, two
     launches a call); tokens/s and peak memory; then the zero-shot
     harness on it at impl exact (as 10c's: 64 dualmad and 64 1mad calls
     a forward of two launches each, the head's two; examples/s after a
     warm-up pass)
  9. Path B: a 512-token prefill at impl exact on tcq2mix (64 K2 + 64 K3,
     the head as 2 chunked sum2 K1 launches) and on the 215 config (128 K2
     sum2 + 2); prefill time and peak memory
 9b. Path C: the 8B ldlq_2_6 model (3-bit 2-D VQ, merged qkv/ug) with the
     rotated int8 lm_head, impl a8; the 16-token prefill launches 128 K9
     (the head a plain product), each of 8 decode forwards 128 K8 + 1 K10;
     tokens/s and peak memory
 9c. Path D: 8 layers of ldlq_1_4 (4-bit scalar, unmerged) with the int8
     head built here without the rotation: 56 K9 in the prefill, 56 K8 + 1
     K11 a decode forward
 9e. Path E: the 8B with a mixed qdict (path_e_qdict: six schemes, the
     attention merges qkv / qk / kv / qv / none, ug merged on even
     layers, the five impl choices; the dequant route takes ~24% of the
     weight bytes, K2, K3, K6, K7 and K9 in every decode step), impl a8,
     the 4-bit head: its census (projections and bytes by kind x route x
     merge group) predicts each wrapper's launches a prefill and a step
 9d. after its counted eager run, each decode path (6, 7, both impls of
     8, 9b, 9c, 9e) runs through the captured step (runtime/decode.py, one
     CUDA graph replay a token): the launches recorded at capture equal
     the path's per-forward counts; 4 replays give the eager forward's
     logits and caches bit for bit from the same caches and position;
     greedy generate_fast gives the eager loop's 17 tokens; two sampled
     generate_fast runs with one seed, and generate with it, agree;
     tokens/s of the eager loop beside the graph's; a torch.profiler trace
     of 8 replays (device busy share of the wall time, device time a step,
     the top 10 device ops a step, GEMV against glue, host enqueue a
     replay); 64 replays timed while nvidia-smi samples the SM clock and
     power draw
 12. (before 10) MSQ: the qdict solved against the latency table
     measured on this card (msq_results/3_8b/lat_constrained/h100/):
     its census's launches in a counted eager run and at capture, its
     tokens/s through generate() beside the H100 table's estimate, and
     the 215's beside its; fit_latency_coeffs in sample mode over groups
     q and ug x tcq2s_6, tcq_6, ldlq_2_6 (and ldlq's dequant keys), each
     entry against the committed table's
 10. 2-layer models with each path's scheme mix on the CPU (plain
     versions) against the same weights on the card (kernels); the tcq2mix
     one with a 300-token exact prompt (K2/K3) and one decode step; the
     Path C one with a 12-token prompt (K9) and one decode step (K8, K10)
 10b. artifacts: two layers of the 8B (merged tcq and tcomb groups, comb
     with unequal halves, rotfp16, choices "1" and "xla") and a
     999_lm_head tcq2s_8 artifact written to a temporary save_dir with
     random words in the reference's meta schema, loaded with dummy=False
     on the card and on the CPU: a 12-token prefill and 2 decode steps
     within SMALL_TOL
 10d. (after 10) the six schemes outside the palette's GEMV sets
     (OFF_PALETTE: tcq_2, tcomb_5_7, tcq2s_3, tcq1_6, ldlq_1_9,
     ldlq_2_2) on a 1-layer SMALL_CFG model at impl dequant, run by the
     dequant kernels' off-palette instances (K6, K7, K2, K3, K9): card
     against CPU within SMALL_TOL, 14 launches of the kind's dequant
     kernel and no other, each W-hat bit-equal to the plain version's;
     then those instances timed at 4096x4096 beside their bound (K2 sum2
     KV 3, K3 1mad KV 6, K6 KV 2, K7 KV 5/7, K9 at the 10 (bits, vec) no
     GEMV takes) and a palette instance of each kernel beside them
 10c. evaluation (runtime/evaluate.py, runtime/zeroshot.py): eval_ppl
     of the 32-layer flagship at impl dequant over two ctx-8192 windows of
     a synthetic stream from seed 0 (194 K6 + 30 K7 a window, the
     blockwise attention in every layer; s a window, eval tokens/s, peak
     memory, timed after the first window's ce_loss is held within 2e-3
     of the CE of the forward's own logits; torch.profiler over one
     window: device time of the dequant kernels, the f32 copies and
     products of W_hat, attention,
     the head's CE, the rest); eval_multiple_choice of the 32-layer 215
     model at impl exact on 8 synthetic questions x 4 choices of 33-200
     tokens (a byte-level stand-in tokenizer; 129 K1 sum2 calls a forward
     at 8 < N <= 256, 258 launches, one loglikelihood within 1e-4 of the
     forward's log-softmax; examples/s after a warm-up pass over the same
     prompts); the blockwise attention against
     the whole logits at the 8B's heads (S = T = 4096; S = 2048 over T =
     4096 from offset 2048; within 1e-5 of max|out|); a 2-layer model's
     ctx-2560 logits and ce_loss, card against the CPU, within SMALL_TOL
 13. (after 12) quantization (quant/, the entry points, the loader's
     quantize-on-demand) at full 8B width: tcq_6, tcomb_6_7, tcq2s_6 and
     ldlq_2_8 quantize the 4096^2 N(0, 1) matrix of numpy seed 0 within
     1% of assets/quant_err.json (tcq2s_6 at the table's bf16 cross term,
     its float32 value within 1e-3 of the port's recorded one), each
     viterbi_encode call timed with CUDA events beside its bound; their
     words through K6, K7, K2 and K9
     equal the quantizer's W-hat in bf16, tcq2s_6's through K1 sum2 at
     N = 1 within 1e-4, tcq1_3's at 1024x4096 through K3; python -m
     qpalette_tpu_torch.quantize_layer on layer 0 of a 1-layer
     Llama-3.1-8B checkpoint written from random_dense_params (seed 0)
     with the H100 qdict (7 artifacts; a second run skips them); the
     model from them (lm_head_bits 8, impl exact: K4 on the merged tcq_10
     qkv, K8 on o, down and ug, K10 on the head; counted and at capture)
     against the dense model of the quantizers' W-hat (float32 weights)
     within SMALL_TOL over a 16-token prefill and 2 decode steps, the
     dense model of W (unquantized) beyond it; each projection (merged
     groups whole) through its kernel at N = 1 and 16 against x W-hat^T
     within QUANT_PROJ_TOL, x W^T beyond it; the loader quantizing
     the same on demand into an empty save_dir (bit-equal artifacts);
     Hessians over 8 x 512 synthetic tokens, err_coeffs_from_hessians,
     and tcq_10_hess (q) and ldlq_1_4_hess (down) below their _none_
     artifacts in tr(E H E^T); seconds of each step
 9f. (after 9e) Path F: 8 layers of the 8B with ldlq_2_6 merged qkv / ug
     and ldlq_4_8 o / down (vec 4, 2 bits a weight; its codebook made by
     k-means on the card into a temporary QPALETTE_ASSETS), the rotated
     int8 head, impl a8: 32 K9 in the 16-token prefill (16 at vec 4), 32
     K8 + 1 K10 a decode forward (16 K8 at vec 4), counted and through
     the captured step
 14. (after 13) tensor parallelism at full 8B width, 2 layers (TP_LAYERS):
     the flagship (3.25bit.json: tcomb o in layer 0) and the 215 built
     with row_parallel_tp = 2 (o / down block-rotated, tcomb
     block-permuted), impl exact; a greedy decode of 8 steps on the card
     single-device (K4/K5, K6/K7 in the prefill; K1), the same model split
     two ways in one process (two threads, each rank's kernels at its
     local shapes, the float32 partials summed on the card: no gloo),
     then TP = 2 over two gloo processes sharing the one card (gloo's
     all_reduce of CUDA tensors: NCCL takes one rank a GPU), both fed the
     single-device tokens, each rank's launches; gloo's logits equal to
     the split's, the split's within TP_TOL of max|logit| at the prefill
     and every step, each step's argmax the greedy token; host ms a step
     of both (two ranks on one card: not a speed-up).  Its column leg
     (parallel/sharding.py), in the same gloo job: the flagship, the 215
     and the dry run's mixed qdict (K1 dualmad / 1mad, K4, K8) built
     single-device, impl exact, each decoded greedily single-device and
     then by the two ranks column-parallel (each rank's kernels at its
     output rows: K1 sum2 on 3072 qkv rows and 65536 head rows, K4 / K5
     on 2048 q / o rows; all-gathers where a consumer needs the whole
     output, attention on its heads, logits gathered over vocab),
     teacher-forced: each rank's
     logits within TP_COL_TOL of the single-device run's, its argmax the
     greedy token wherever the top-2 gap clears 2 * TP_COL_TOL, its
     launches beside the single-device counts; col_rows: each layer-0
     projection's kernel (and attention, the bf16 head) at the ranks'
     rows against the whole, which names what moves with m
 15. beam and refine: quantize_mat_tcq(beam=16) of a 1024x1024 slice of
     a k weight (tcq_6 with a synthetic Hessian) beside beam 0, and
     refine_artifact_vq of a 4096x4096 o weight after ldlq_1_4 with it:
     seconds and tr(E H E^T) of each
 11. eager and graph tokens/s of every decode path side by side, a JSON
     line of them ("[graph] {...}"), a JSON line of the evaluation
     ("[eval] {...}"), of serving ("[serve] {...}"), of MSQ ("[msq]
     {...}") and of quantization ("[quant] {...}"), the run time, a JSON line of kernels
     (launches in the counted runs, step_launches in their decode
     forwards), the nvidia-smi name/power line, and the final JSON status
     line
"""

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
QDIR = os.path.join(ROOT, "msq_results", "3_8b", "lat_constrained", "v5e",
                    "default_err")
FLAGSHIP_QDICT = os.path.join(ROOT, "msq_results", "3_8b", "mem_constrained",
                              "default", "3.25bit.json")
SHAPES_215 = [("qkv", 6144, 4096, 8), ("o", 4096, 4096, 6),
              ("ug", 28672, 4096, 4), ("ug", 28672, 4096, 6),
              ("down", 4096, 14336, 6), ("lm_head", 131072, 4096, 8)]
EXTRA_KV = [("kv4", 4096, 4096, 4), ("kv8", 4096, 4096, 8)]
# per decode step: qkv, o, ug, down in each of 32 layers, plus the lm_head
CALLS_PER_STEP = {"qkv": 32, "o": 32, "ug": 32, "down": 32, "lm_head": 1}
LAUNCHES_PER_FORWARD = 129
# rows a zero-shot forward gives K1 (its prompts' lengths), timed in phase 3
ZS_ROWS = (16, 64, 256)
# rows at which phase 3 holds wide_gemv_kernel against its plain version:
# whole n-tiles, and 9, 49, 191 ending in a partial one (a8 splits 191 and
# 256 over two row groups)
ZS_CHECK_ROWS = (9, 16, 49, 64, 191, 256)
# bench.py's tcq2mix scheme (3.27 bits/weight): (projection, m, k, mode,
# KV, calls a forward), then 2mad and odd-KV sum2 at 4096x4096 and odd
# k/16 shapes (calls 0: checked, not on a path)
TCQ2MIX = {"self_attn.q_proj": "tcq2_6_none_0.9",
           "self_attn.k_proj": "tcq2_6_none_0.9",
           "self_attn.v_proj": "tcq2_6_none_0.9",
           "self_attn.o_proj": "tcq1_3_none_0.9",
           "mlp.gate_proj": "tcq2_7_none_0.9",
           "mlp.up_proj": "tcq2_7_none_0.9",
           "mlp.down_proj": "tcq1_3_none_0.9"}
SHAPES_ARITH = [("qkv", 6144, 4096, "dualmad", 6, 32),
                ("ug", 28672, 4096, "dualmad", 7, 32),
                ("o", 4096, 4096, "1mad", 3, 32),
                ("down", 4096, 14336, "1mad", 3, 32),
                ("2mad3", 4096, 4096, "2mad", 3, 0),
                ("2mad4", 4096, 4096, "2mad", 4, 0),
                ("sum2_5", 4096, 4096, "sum2", 5, 0),
                ("sum2_7", 4096, 4096, "sum2", 7, 0),
                ("odd_kt", 256, 4112, "1mad", 3, 0),
                ("odd_kt", 256, 4112, "sum2", 5, 0),
                ("odd_kt", 256, 4112, "dualmad", 7, 0),
                ("odd_kt", 256, 4112, "dualmad", 9, 0)]
PATH_A_STEP = {"tcq2_decode_gemv": 64, "tcq1_decode_gemv": 64,
               "tcq2s_decode_gemv": 1}
# the 16-token prefill: every K1 call above 8 rows on wide_gemv_kernel, two
# launches a call
PATH_A_PREFILL = {"tcq2_decode_gemv": 128, "tcq1_decode_gemv": 128,
                  "tcq2s_decode_gemv": 2}
PATH_A_MIX = {("tcq2", "dualmad", 6): 32, ("tcq2", "dualmad", 7): 32,
              ("tcq1", "1mad", 3): 64}
PREFILL_B = 512
# the a8 head in two 256-row chunks of two launches each
PATH_B = {"tcq2mix": {"tcq2_dequant": 64, "tcq1_dequant": 64,
                      "tcq2s_decode_gemv": 4},
          "215": {"tcq2_dequant": 128, "tcq2s_decode_gemv": 4}}
PROMPT_LEN, NEW_TOKENS = 16, 64
# decode forwards of a path's counted eager run (drive), and the tokens of
# its graph phase's eager loop and generate_fast checks; NEW_TOKENS
# replays are still timed
COUNTED_TOKENS, GRAPH_TOKENS = 8, 16
TOL = {False: 1e-4, True: 1e-3}  # GEMV kernel vs plain, of max|y|
SMALL_TOL = 2e-2  # CPU plain vs card kernel through a 2-layer model
# flagship projections per forward, by (shape m x k, KV): 194 tcq, 30 tcomb
FLAGSHIP_TCQ, FLAGSHIP_TCOMB = 194, 30
LUT_TOL = 1e-4  # LUT GEMV kernel vs plain, of max|y|
# dequant + product at N=16: the kernel's W is bit-equal to the plain one,
# so the two products see the same operands
PRODUCT_TOL = 1e-6
# Path C: ldlq_2_6 everywhere, merged qkv / ug, the rotated int8 head
PATH_C_QSTR = "ldlq_2_6_none_1.0"
SHAPES_8B = [("qkv", 6144, 4096), ("o", 4096, 4096), ("ug", 28672, 4096),
             ("down", 4096, 14336)]
PATH_C_PREFILL = {"vq_dequant": 128}
PATH_C_STEP = {"vq_gemv": 128, "int8_gemv_a8": 1}
# Path D: 8 layers of ldlq_1_4, unmerged, the int8 head without rotation
PATH_D_QSTR, PATH_D_LAYERS = "ldlq_1_4_none_1.0", 8
PATH_D_PREFILL = {"vq_dequant": 7 * PATH_D_LAYERS}
PATH_D_STEP = {"vq_gemv": 7 * PATH_D_LAYERS, "int8_gemv": 1}
# (projection, m, k, calls a Path D forward): q/o, k/v, gate/up, down
PATH_D_SHAPES = [("q/o", 4096, 4096, 2 * PATH_D_LAYERS),
                 ("k/v", 1024, 4096, 2 * PATH_D_LAYERS),
                 ("gate/up", 14336, 4096, 2 * PATH_D_LAYERS),
                 ("down", 4096, 14336, PATH_D_LAYERS)]
HEAD = (129024, 4096)  # the int8 head: 128256 padded to 2048s
VQ_TOL = 1e-4  # K8 vs plain, of max|y|
# vec 4: K8 / K9 at (bits 8, vec 4) summed over a 32-layer forward of Path
# F's scheme, 32 o + 32 down calls; other bits checked and timed, on no
# path
VQ4 = (8, 4)
VQ4_QSTR, VQ2_QSTR = "ldlq_4_8_none_1.0", "ldlq_2_6_none_1.0"
PATH_F_LAYERS = 8
PATH_F_PREFILL = {"vq_dequant": 4 * PATH_F_LAYERS}
PATH_F_STEP = {"vq_gemv": 4 * PATH_F_LAYERS, "int8_gemv_a8": 1}
PATH_F_VEC4 = 2 * PATH_F_LAYERS  # vec-4 calls a forward: o and down
# phase 14: the row-parallel 8B models' depth, ranks and decode steps.
# A rank's kernels run at its local shapes, whose float32 sums go in
# another order than the global ones, and the dummy model carries a
# flipped bf16 rounding into later layers.  The in-process split
# (tp_split: the same ranks, no gloo) measures that alone: teacher-forced
# max|d| / max|logit| 9.76e-3 (flagship) and 1.25e-2 (215) at 2 layers,
# 2.50e-2 / 1.86e-2 at 8, 5.06e-2 / 3.22e-2 at 32, and the gloo ranks'
# logits are bit-equal to the split's at every depth (NVIDIA H100 80GB
# HBM3, 700.00 W; the kernels are deterministic: the 2-layer readings
# reproduce to every printed digit from run to run).  So gloo is held to
# the split exactly, and the split to the 2-layer readings with a fifth
# of headroom; deeper models are printed (--tp)
TP_LAYERS, TP_RANKS, TP_STEPS = 2, 2, 8
TP_TOL = 1.5e-2
# the column-parallel leg: every input of every kernel is whole and the
# gathers copy, so a rank's output rows would equal the single-device
# run's but for kernels whose per-row float32 sums depend on m.  On the
# card (col_rows, NVIDIA H100 80GB HBM3, 700.00 W) K4 / K5 at N = 1 (the
# k-split cluster chosen from the m-tiles, csrc/tcq_lut.cu) and K1 above 8
# rows (the cluster chosen from the m-groups, csrc/arith_wide.cuh: the
# prefill's ug) move by 3e-7 to 1.8e-6 of max|y|, as does the dequant
# route's float32 product at a small m (cuBLAS's choice); K1 at N <= 8,
# K8, the 4-bit head, the bf16 head and attention on half the heads are
# bit-equal.  The dummy 8B carries such a
# flipped bf16 rounding to the logits: teacher-forced max|d| / max|logit|
# 1.115e-2 (flagship), 1.171e-2 (215), 6.15e-3 (mixed qdict) at 2
# layers; TP_COL_TOL is the largest plus a fifth.  An argmax is held to
# the greedy token where the single-device top-2 gap exceeds 2 *
# TP_COL_TOL (no deviation within the tolerance can flip it there)
TP_COL_TOL = 1.4e-2
BEAM_WIDTH = 16
I8_TOL = 1e-5  # K11 vs plain, of max|y|
# what sets the bound of the K8-K11 calls timed, name -> "bytes" or
# "operations", filled as they are timed (the trellis kernels' bounds are
# bytes at every shape timed)
BOUND_BY = {}
# {wrapper: launches in the counted runs' decode forwards}, summed over the
# paths (drive)
STEP_LAUNCHES = {}
L2_BYTES = 50_000_000
# the least time for a call: bytes over the H100's 3.35 TB/s, operations
# over its dense peak for their type (NVIDIA's data sheet, SXM, 700 W)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bfloat16": 989e12, "tfloat32": 495e12,
              "float32": 67e12}
# KV 3 of the LUT kernels (tcq_3, tcomb_3_4 of the memory palette) at o and
# down: checked, on no path, (m, k, KV) -> 0 calls a forward
LUT_KV3 = {(4096, 4096, (3,)): 0, (4096, 14336, (3,)): 0,
           (4096, 4096, (3, 4)): 0, (4096, 14336, (3, 4)): 0}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes, ops, kind):
    """(least ms, "bytes" or "operations") for a call's work."""
    tb, to = nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[kind]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def gemv_bound(trellis_bytes, N, m, k, x_bytes, a8, exact_kind="float32"):
    """K1/K4/K5: packed words + x read once, f32 y written once; 2*N*m*k
    operations in int8 (a8) or else exact_kind."""
    return bound_ms(trellis_bytes + N * k * x_bytes + N * m * 4,
                    2 * N * m * k, "int8" if a8 else exact_kind)


def dequant_bound(trellis_bytes, m, k):
    """K2/K3/K6/K7: packed words read once, bf16 W written once; one
    float32 operation a weight."""
    return bound_ms(trellis_bytes + 2 * m * k, m * k, "float32")


def card():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {name}, {count} device(s), nvidia-smi: {smi}", flush=True)
    return name, count, smi


class SmClock:
    """nvidia-smi's SM clock of card 0, sampled every 20 ms while the block
    runs: .mhz (median), .lo, .hi (NaN without a sample)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        log, _ = self.proc.communicate()
        v = [float(t) for t in log.split() if t.isdigit()] or [float("nan")]
        self.mhz, self.lo, self.hi = float(np.median(v)), min(v), max(v)
        return False

    def __str__(self):
        return f"SM {self.mhz:.0f} MHz (min {self.lo:.0f}, max {self.hi:.0f})"


def _words(m, k, W, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, ((m // 16) * (k // 16), W),
                         generator=gen, dtype=torch.int32, device=device)


def _time_ms(fn, reps, graph=False):
    """ms per call: the better of two windows of reps calls each (a window
    can catch the card in another state).  graph: the reps calls are
    captured once in a CUDA graph and the window replays it, so the time
    is the device's alone; launched one by one from Python, a kernel
    shorter than its wrapper's ~20-30 us of host work would time the
    host."""
    fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(2):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        if graph:
            g.replay()
        else:
            for i in range(reps):
                fn(i)
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def _copies(m, k, W, device):
    """Copies of random weights enough to exceed the L2 cache three times,
    so that repeated launches stream from device memory as a forward does."""
    nbytes = (m // 16) * (k // 16) * W * 4
    return [_words(m, k, W, device, seed=100 + i)
            for i in range(min(64, -(-3 * L2_BYTES // nbytes)))], nbytes


def _rel_check(label, y, ref, tol):
    err = (y - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    check(bool(torch.isfinite(y).all()), f"{label} non-finite")
    print(f"[kernel] {label}: max_abs_err={err:.3e} rel={rel:.3e} "
          f"(limit {tol:.0e})", flush=True)
    check(rel <= tol, f"{label}: rel {rel}")
    return err


def sum2_checks(arith, device):
    """K1 sum2 vs plain at every 215 shape; returns (max_abs_err,
    {(name, KV): (ms, plain_ms, bound_ms)} at a8, N=1)."""
    max_abs = 0.0
    for name, m, k, KV in SHAPES_215 + EXTRA_KV:
        words = _words(m, k, 4 * KV, device, seed=m + k + KV)
        for N in (1, 4, 16):
            # decode rows reach the kernel as the f32 rotation output,
            # prefill rows as bf16 (qlinear_apply)
            x_dtype = torch.float32 if N <= 8 else torch.bfloat16
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).to(x_dtype)
            for a8 in (False, True):
                y = arith.tcq2s_decode_gemv(x, words, KV, m, k, a8)
                torch.cuda.synchronize()
                ref = arith.arith_gemv_plain(x, words, "sum2", KV, m, k, a8)
                label = (f"sum2 {name} {m}x{k} KV={KV} N={N} "
                         f"{'a8' if a8 else 'exact'}")
                max_abs = max(max_abs, _rel_check(label, y, ref, TOL[a8]))
                if N == 4:  # the warps' fragments add in a fixed order
                    y2 = arith.tcq2s_decode_gemv(x, words, KV, m, k, a8)
                    check(torch.equal(y.view(torch.int32),
                                      y2.view(torch.int32)),
                          f"{label}: two launches differ")
    times = {}
    for name, m, k, KV in SHAPES_215:
        copies, nbytes = _copies(m, k, 4 * KV, device)
        x = torch.randn((1, k), device=device)
        out = torch.empty((1, m), device=device)

        def kern(i=0):
            arith.tcq2s_decode_gemv(x, copies[i % len(copies)], KV, m, k,
                                    True, out=out)

        def plain(i=0):
            arith.arith_gemv_plain(x, copies[i % len(copies)], "sum2", KV, m,
                                   k, True)

        ms = _time_ms(kern, 200, graph=True)
        pms = _time_ms(plain, 5)
        bms, _ = gemv_bound(nbytes, 1, m, k, 4, True)
        times[(name, KV)] = (ms, pms, bms)
        print(f"[time] sum2 {name} {m}x{k} KV={KV} a8 N=1: kernel {ms:.4f} ms "
              f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of packed trellis), "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms", flush=True)
        del copies
    return max_abs, times


def sum2_row_times(arith, arith_dequant, device):
    """K1 sum2 above 8 rows (wide_gemv_kernel after its x prologue, bf16 x)
    at the 215 shapes: held against its plain version at ZS_CHECK_ROWS,
    exact and a8, two launches bit-equal at 191 rows (a8: two row groups),
    then timed as a zero-shot forward calls it (the layers at exact, the
    4-bit head at a8) beside its yardstick, the dequant route (K2, then
    qlinear._product: impl dequant's f32 product of x and W_hat).  The
    exact rows' bound counts their operations at the bf16 tensor-core
    peak: bf16 x against integer weights in [-256, 254], which bf16 holds
    exactly (the TPU kernel's MXU product).  Returns (max_abs_err, {(N,
    name, KV): (ms, plain_ms or None, bound_ms, route_ms, bound_by)}); the
    plain version is timed at N = 64 only (its time is the decode of W,
    whatever N)."""
    from qpalette_tpu_torch.runtime.qlinear import _product

    times, max_abs = {}, 0.0
    for name, m, k, KV in SHAPES_215:
        copies, nbytes = _copies(m, k, 4 * KV, device)
        for N in ZS_CHECK_ROWS:
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen,
                            device=device).bfloat16()
            for a8 in (False, True):
                label = (f"sum2 wide {name} {m}x{k} KV={KV} N={N} "
                         f"{'a8' if a8 else 'exact'}")
                y = arith.tcq2s_decode_gemv(x, copies[0], KV, m, k, a8)
                torch.cuda.synchronize()
                ref = arith.arith_gemv_plain(x, copies[0], "sum2", KV, m, k,
                                             a8)
                max_abs = max(max_abs, _rel_check(label, y, ref, TOL[a8]))
                if N == 191:  # the cluster's fragments add in rank order
                    y2 = arith.tcq2s_decode_gemv(x, copies[0], KV, m, k, a8)
                    check(torch.equal(y.view(torch.int32),
                                      y2.view(torch.int32)),
                          f"{label}: two launches differ")
                del y, ref
        a8 = name == "lm_head"
        for N in ZS_ROWS:
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen,
                            device=device).bfloat16()
            out = torch.empty((N, m), device=device)

            def kern(i=0):
                arith.tcq2s_decode_gemv(x, copies[i % len(copies)], KV, m,
                                        k, a8, out=out)

            def plain(i=0):
                arith.arith_gemv_plain(x, copies[i % len(copies)], "sum2",
                                       KV, m, k, a8)

            def route(i=0):
                _product(x, arith_dequant.dequant(
                    "sum2", copies[i % len(copies)], KV, m, k))

            ms = _time_ms(kern, 50, graph=True)
            pms = _time_ms(plain, 1) if N == 64 else None
            rms = _time_ms(route, 3)
            bms, by = gemv_bound(nbytes, N, m, k, 2, a8, "bfloat16")
            times[(N, name, KV)] = (ms, pms, bms, rms, by)
            print(f"[time] sum2 wide {name} {m}x{k} KV={KV} N={N} "
                  f"{'a8' if a8 else 'exact'}: kernel {ms:.4f} ms, plain "
                  + (f"{pms:.4f} ms" if pms is not None else "not timed")
                  + f", dequant route {rms:.4f} ms, bound {bms:.4f} ms "
                  f"({by}; {bms / ms:.1%} of it)", flush=True)
        del copies
    return max_abs, times


# Path A's K1 calls of the other V=2 and the V=1 modes above 8 rows, timed
# at ZS_ROWS in phase 3 (k1_rows): (name, m, k, mode, KV, calls a forward);
# 2mad on no path.  Each is also held against its plain version at
# ZS_CHECK_ROWS, at these shapes and at the odd k/16 ones
ROWS_ARITH = [sh for sh in SHAPES_ARITH
              if sh[3] != "sum2" and sh[0] != "odd_kt"]
ROWS_CHECK = [sh for sh in SHAPES_ARITH if sh[3] != "sum2"]


def k1_rows(arith, arith_dequant, device, reps=10):
    """K1 dualmad, 1mad and 2mad above 8 rows (wide_gemv_kernel, bf16 x,
    as a prefill or a zero-shot forward gives them): held against the
    plain version at ZS_CHECK_ROWS, exact and a8, two launches bit-equal
    at 191 rows; then each ROWS_ARITH shape timed at N in ZS_ROWS, exact
    and a8, beside its bound and the dequant route (K2/K3, then
    qlinear._product), and the plain version at N = 64, exact.  Exact's
    bound counts its operations at the tf32 tensor-core peak: bf16 does
    not hold the V=1 and dualmad weights beyond +-256, tf32 holds them
    (the tensor-core kernels' exact MMAs).  Returns ({mode: max_abs_err},
    {(N, name, mode, KV, a8): (ms, plain_ms or None, bound_ms, route_ms,
    bound_by)})."""
    from qpalette_tpu_torch.runtime.qlinear import _product

    max_abs, times = {}, {}
    for name, m, k, mode, KV, _ in ROWS_CHECK:
        words = _words(m, k, arith.words_per_tile(mode, KV), device,
                       seed=m + k + KV)
        for N in ZS_CHECK_ROWS:
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen,
                            device=device).bfloat16()
            for a8 in (False, True):
                label = (f"{mode} wide {name} {m}x{k} KV={KV} N={N} "
                         f"{'a8' if a8 else 'exact'}")
                y = arith.decode_gemv(mode, x, words, KV, m, k, a8)
                torch.cuda.synchronize()
                ref = arith.arith_gemv_plain(x, words, mode, KV, m, k, a8)
                max_abs[mode] = max(max_abs.get(mode, 0.0),
                                    _rel_check(label, y, ref, TOL[a8]))
                if N == 191:  # the cluster's fragments add in rank order
                    y2 = arith.decode_gemv(mode, x, words, KV, m, k, a8)
                    check(torch.equal(y.view(torch.int32),
                                      y2.view(torch.int32)),
                          f"{label}: two launches differ")
                del y, ref
        del words
    with SmClock() as clock:
        for name, m, k, mode, KV, _ in ROWS_ARITH:
            copies, nbytes = _copies(m, k, arith.words_per_tile(mode, KV),
                                     device)
            for N in ZS_ROWS:
                gen = torch.Generator(device=device)
                gen.manual_seed(N)
                x = torch.randn((N, k), generator=gen,
                                device=device).bfloat16()
                out = torch.empty((N, m), device=device)

                def route(i=0):
                    _product(x, arith_dequant.dequant(
                        mode, copies[i % len(copies)], KV, m, k))

                rms = _time_ms(route, 3)
                for a8 in (False, True):
                    def kern(i=0):
                        arith.decode_gemv(mode, x, copies[i % len(copies)], KV,
                                          m, k, a8, out=out)

                    def plain(i=0):
                        arith.arith_gemv_plain(x, copies[i % len(copies)],
                                               mode, KV, m, k, a8)

                    ms = _time_ms(kern, reps, graph=True)
                    pms = _time_ms(plain, 1) if N == 64 and not a8 else None
                    bms, by = gemv_bound(nbytes, N, m, k, 2, a8, "tfloat32")
                    times[(N, name, mode, KV, a8)] = (ms, pms, bms, rms, by)
                    plain = (f"{pms:.4f} ms" if pms is not None
                             else "not timed")
                    print(f"[time] {mode} rows {name} {m}x{k} KV={KV} N={N} "
                          f"{'a8' if a8 else 'exact'}: kernel {ms:.4f} ms, "
                          f"plain {plain}, dequant route {rms:.4f} ms, bound "
                          f"{bms:.4f} ms ({by}; {bms / ms:.1%} of it)",
                          flush=True)
            del copies
    print(f"[time] K1 rows timed at {clock}", flush=True)
    times["sm_clock"] = clock.mhz
    return max_abs, times


def k1_rows_forward(times, card_label):
    """Print and return a Path A forward's sums of k1_rows' times: {(mode,
    N, a8): (ms, plain_ms or None, bound_ms, route_ms, bound_by)} over its
    32 qkv + 32 ug dualmad calls and its 32 o + 32 down 1mad calls; 2mad
    (on no path) as 64 calls at 4096x4096 KV 3."""
    out = {}
    for mode in ("dualmad", "1mad", "2mad"):
        shapes = [(name, KV, calls or 64) for name, _, _, md, KV, calls
                  in ROWS_ARITH if md == mode and (calls or KV == 3)]
        for a8 in (False, True):
            for N in ZS_ROWS:
                rows = [(calls, times[(N, name, mode, KV, a8)])
                        for name, KV, calls in shapes]
                tot = [sum(c * t[j] for c, t in rows) for j in (0, 2, 3)]
                pms = (sum(c * t[1] for c, t in rows)
                       if N == 64 and not a8 else None)
                ops = sum(c * t[2] for c, t in rows if t[4] == "operations")
                by = "operations" if 2 * ops >= tot[1] else "bytes"
                out[(mode, N, a8)] = (tot[0], pms, tot[1], tot[2], by)
                plain = f"plain {pms:.3f} ms, " if pms is not None else ""
                n = sum(c for _, _, c in shapes)
                print(f"[time] a Path A forward's {n} {mode} calls at N={N} {'a8' if a8 else 'exact'}: "
                      f"kernel {tot[0]:.3f} ms, {plain}dequant route "
                      f"{tot[2]:.3f} ms, bound {tot[1]:.3f} ms ({by}; "
                      f"{tot[1] / tot[0]:.1%} of it; {card_label}, SM "
                      f"{times['sm_clock']:.0f} MHz)", flush=True)
    return out


def rows_only():
    """--rows: build, then k1_rows and its Path A sums alone."""
    from qpalette_tpu_torch.kernels import arith, arith_dequant

    _, _, smi = card()
    build_all()
    err, times = k1_rows(arith, arith_dequant, torch.device("cuda:0"))
    fwd = k1_rows_forward(times, smi)
    print(json.dumps({"card": smi, "sm_mhz": times.pop("sm_clock"),
                      "rows_max_abs_err": err,
                      "forward": {f"{md} N={N} {'a8' if a8 else 'exact'}": v
                                  for (md, N, a8), v in fwd.items()},
                      "calls": {f"{N} {name} {md} KV{KV} "
                                f"{'a8' if a8 else 'exact'}": v
                                for (N, name, md, KV, a8), v in
                                times.items()}}), flush=True)


def step_ms(times, qdict):
    """(kernel, plain, bound) ms of one 215 decode step's 129 calls,
    weighting the ug shape by the 215 qdict's KV mix."""
    ug_kv = [int(qdict[f"{i}_mlp.up_proj"][0].split("_")[1])
             for i in range(32)]
    tot = [0.0, 0.0, 0.0]
    for (name, KV), trio in times.items():
        n = (sum(kv == KV for kv in ug_kv) if name == "ug"
             else CALLS_PER_STEP[name])
        for j in range(3):
            tot[j] += n * trio[j]
    return tot


def arith_checks(arith, arith_dequant, device):
    """K1 (dualmad, 1mad, 2mad, odd-KV sum2) and K2/K3 against their plain
    versions at SHAPES_ARITH, and K2 sum2 at the 215 shapes.  Returns
    ({wrapper: max_abs_err}, {wrapper: [ms, plain_ms, bound_ms] summed over
    a Path A decode step's calls (K1, a8, N=1) or a tcq2mix Path B
    prefill's calls (K2/K3)}, {(name, KV): (ms, plain_ms, bound_ms)} of K2
    sum2 at the 215 shapes)."""
    gemv_of = {"sum2": arith.tcq2s_decode_gemv,
               "dualmad": arith.tcq2_decode_gemv,
               "1mad": arith.tcq1_decode_gemv, "2mad": arith.tcq1_decode_gemv}
    names = [f.__name__ for f in arith.KERNELS + arith_dequant.KERNELS]
    err = {n: 0.0 for n in names}
    times = {n: [0.0, 0.0, 0.0] for n in names}
    deq215 = {}
    shapes = [(*sh, True) for sh in SHAPES_ARITH] + [
        (name, m, k, "sum2", KV, 0, False) for name, m, k, KV in SHAPES_215
        if name != "lm_head"]
    for name, m, k, mode, KV, calls, k1 in shapes:
        W = arith.words_per_tile(mode, KV)
        words = _words(m, k, W, device, seed=m + k + KV)
        label = f"{mode} {name} {m}x{k} KV={KV}"
        gemv = gemv_of[mode]
        deq = (arith_dequant.tcq2_dequant if mode in ("sum2", "dualmad")
               else arith_dequant.tcq1_dequant)
        for N in ((1, 8, 256) if k1 else ()):
            x_dtype = torch.float32 if N <= 8 else torch.bfloat16
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).to(x_dtype)
            for a8 in (False, True):
                y = arith.decode_gemv(mode, x, words, KV, m, k, a8)
                torch.cuda.synchronize()
                ref = arith.arith_gemv_plain(x, words, mode, KV, m, k, a8)
                err[gemv.__name__] = max(err[gemv.__name__], _rel_check(
                    f"{label} N={N} {'a8' if a8 else 'exact'}", y, ref,
                    TOL[a8]))
                if N == 8:  # the warps' fragments add in a fixed order
                    y2 = arith.decode_gemv(mode, x, words, KV, m, k, a8)
                    check(torch.equal(y.view(torch.int32),
                                      y2.view(torch.int32)),
                          f"{label} N=8: two launches differ")
        w = arith_dequant.dequant(mode, words, KV, m, k)
        torch.cuda.synchronize()
        w_ref = arith_dequant.arith_dequant_plain(words, mode, KV, m, k)
        same = torch.equal(w.view(torch.int16), w_ref.view(torch.int16))
        print(f"[kernel] {deq.__name__} {label}: bit-equal={same}",
              flush=True)
        check(same, f"{deq.__name__} {label}: not bit-equal")
        del w, w_ref
        on_path = calls or not k1
        if not on_path and mode != "2mad":
            continue  # checked, on no path: no times

        copies, nbytes = _copies(m, k, W, device)
        x1 = torch.randn((1, k), device=device)
        out = torch.empty((1, m), device=device)
        wout = torch.empty((m, k), dtype=torch.bfloat16, device=device)

        def kern(i=0):
            arith.decode_gemv(mode, x1, copies[i % len(copies)], KV, m, k,
                              True, out=out)

        def kern_exact(i=0):
            arith.decode_gemv(mode, x1, copies[i % len(copies)], KV, m, k,
                              False, out=out)

        def plain(i=0):
            arith.arith_gemv_plain(x1, copies[i % len(copies)], mode, KV, m,
                                   k, True)

        def kern_deq(i=0):
            arith_dequant.dequant(mode, copies[i % len(copies)], KV, m, k,
                                  out=wout)

        def plain_deq(i=0):
            arith_dequant.arith_dequant_plain(copies[i % len(copies)], mode,
                                              KV, m, k)

        routes = [(kern, 200), (kern_exact, 200)] if k1 else []
        if on_path:  # 2mad on no path: its GEMV's times alone
            routes += ([(plain, 5)] if k1 else []) + [(kern_deq, 50),
                                                      (plain_deq, 5)]
        res = {}
        for route, reps in routes:
            res[route.__name__] = ms = _time_ms(
                route, reps, graph=route in (kern, kern_exact, kern_deq))
            gb = (f" ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of packed "
                  f"trellis)" if route in (kern, kern_exact, kern_deq) else "")
            print(f"[time] {label} {route.__name__}: {ms:.4f} ms{gb}",
                  flush=True)
        gb_ms, _ = gemv_bound(nbytes, 1, m, k, 4, True)
        db_ms, _ = dequant_bound(nbytes, m, k)
        print(f"[time] {label} bounds: GEMV a8 N=1 {gb_ms:.4f} ms, dequant "
              f"{db_ms:.4f} ms", flush=True)
        if k1 and calls:
            for fn, trio in ((gemv, (res["kern"], res["plain"], gb_ms)),
                             (deq, (res["kern_deq"], res["plain_deq"],
                                    db_ms))):
                for j, v in enumerate(trio):
                    times[fn.__name__][j] += calls * v
        elif not k1:
            deq215[(name, KV)] = (res["kern_deq"], res["plain_deq"], db_ms)
        del copies, wout
    return err, times, deq215


def build_all():
    """One nvcc per CUDA source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from qpalette_tpu_torch.kernels import (_build, arith, arith_dequant,
                                            int8_gemv, tcq_lut, vq)

    names = [*arith.SOURCES, arith_dequant.SOURCE, tcq_lut.SOURCE, vq.SOURCE,
             int8_gemv.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        logs = list(ex.map(_build.build, names))
    print(f"[build] {len(names)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in zip(names, logs):
        entries = ptxas_entries(log)
        spills = [e for e in entries if SPILL.search(e[2])]
        print(f"[build] {name}.cu: {len(entries)} kernels, {len(spills)} "
              f"with spills", flush=True)
        tc = [e for e in entries if TC_GEMV.search(e[0])]
        for fn, used, spill in spills + tc:
            print(f"[build]   {fn}: {used}; {spill}", flush=True)
        check(not any(SPILL.search(e[2]) for e in tc),
              f"{name}.cu: a tensor-core GEMV spills")


SPILL = re.compile(r"[1-9]\d* bytes spill")
# the tensor-core GEMVs' instances: K1's and K8's
TC_GEMV = re.compile(r"(v[12q]|wide)_gemv_kernel")


def ptxas_entries(log):
    """[(kernel, its "Used ..." text, its spill line)] of ptxas -v output."""
    out, fn, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and fn:
            out.append((fn, ln.split("Used", 1)[1].strip(), spill))
            fn = None
    return out


def drive(label, spec, params, device, prompt_len, new_tokens, want_prefill,
          want_step):
    """The counted run of a path: every count is set to 0 just before the
    prefill and read after it and after each decode forward; each must
    match want_prefill / want_step exactly (other kernels 0).  Returns the
    counts of the whole run."""
    from qpalette_tpu_torch.kernels import launch_counts, reset_launches
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import decode

    V = spec.config.vocab_size
    prompt = np.random.default_rng(0).integers(0, V, (1, prompt_len))
    caches = llama.init_kv_caches(spec, 1, prompt_len + new_tokens + 1,
                                  device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    reset_launches()
    logits, caches = decode.prefill(spec, params,
                                    torch.as_tensor(prompt, device=device),
                                    caches)
    seen = [launch_counts()]
    finite = bool(torch.isfinite(logits).all())
    check(logits.shape == (1, prompt_len, V),
          f"{label}: prefill logits shape {tuple(logits.shape)}")
    cur = decode.sample_logits(logits[:, -1], gen, 0.6, 5)[:, None]
    toks = [cur]
    for pos in range(prompt_len, prompt_len + new_tokens):
        logits, caches = llama.forward(spec, params, cur, kv_caches=caches,
                                       cache_pos=pos)
        seen.append(launch_counts())
        finite = finite and bool(torch.isfinite(logits).all())
        cur = decode.sample_logits(logits[:, -1], gen, 0.6, 5)[:, None]
        toks.append(cur)
    torch.cuda.synchronize()
    zero = {k: 0 for k in seen[0]}
    check(seen[0] == {**zero, **want_prefill},
          f"{label}: prefill launches {seen[0]}")
    for a, b in zip(seen, seen[1:]):
        step = {k: b[k] - a[k] for k in b}
        check(step == {**zero, **want_step},
              f"{label}: decode launches per forward {step}")
    if new_tokens:
        check(logits.shape == (1, 1, V), f"logits shape {tuple(logits.shape)}")
    check(finite, f"{label}: non-finite logits")
    toks = torch.cat(toks, dim=1).cpu().numpy()
    check(bool(((toks >= 0) & (toks < V)).all()), "token out of vocab")
    total = {k: v for k, v in seen[-1].items() if v}
    for k in seen[-1]:
        STEP_LAUNCHES[k] = STEP_LAUNCHES.get(k, 0) + seen[-1][k] - seen[0][k]
    print(f"[{label}] prefill {prompt_len}: "
          f"{ {k: v for k, v in seen[0].items() if v} }; {new_tokens} decode "
          f"forwards: {want_step} each; total {total}; logits finite, tokens "
          f"in vocab", flush=True)
    return seen[-1]


def throughput(label, spec, params, device, card_label):
    """Determinism and tokens/s through the user-facing generate() (a
    replay of the captured step a token); the captured steps are dropped
    after, so that the next call captures the kernels then in use."""
    from qpalette_tpu_torch.runtime import decode

    V = spec.config.vocab_size
    prompt = np.random.default_rng(0).integers(0, V, (1, PROMPT_LEN))
    T = PROMPT_LEN + NEW_TOKENS + 1
    torch.cuda.reset_peak_memory_stats(device)
    runs = [decode.generate(spec, params, prompt, NEW_TOKENS + 1,
                            max_seq=T, temperature=0.6, top_k=5, seed=99)
            for _ in range(2)]
    peak = torch.cuda.max_memory_allocated(device)
    decode.release_captured(params)
    check(np.array_equal(runs[0][0], runs[1][0]),
          f"{label}: same seed, different tokens")
    tps = runs[1][1]["tokens_per_sec"]
    mbytes = decode.model_bytes(params)
    streamed = mbytes - decode.model_bytes(params["embed"])
    print(f"[{label}] decode {tps:.2f} tokens/s bs=1 (captured step, host "
          f"clock, {runs[1][1]['timed_tokens']} steps), model "
          f"{mbytes / 1e9:.3f} GB, streamed {streamed / 1e9:.3f} GB/token "
          f"(computed from tensor sizes), {streamed * tps / 1e9:.1f} GB/s, "
          f"peak memory {peak / 1e9:.3f} GB; card {card_label}", flush=True)
    return tps


def eager_loop(spec, params, prompt, n, T, temperature=0.0, top_k=5,
               seed=99):
    """The eager decode loop (one launch an op from Python): a prefill,
    then n - 1 decode_step calls at int positions, the first untimed.
    Returns (tokens (B, S + n), tokens/s over the timed steps)."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import decode

    device = params["embed"].device
    S = prompt.shape[1]
    caches = llama.init_kv_caches(spec, 1, T, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    logits, caches = decode.prefill(
        spec, params, torch.as_tensor(prompt, device=device), caches)
    cur = decode.sample_logits(logits[:, -1], gen, temperature, top_k)[:, None]
    outs = [cur]
    for i in range(n - 1):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        cur, caches = decode.decode_step(spec, params, cur, caches, S + i,
                                         gen, temperature, top_k)
        outs.append(cur)
    torch.cuda.synchronize()
    tps = (n - 2) / (time.perf_counter() - t0)
    seq = np.concatenate([prompt] + [o.cpu().numpy() for o in outs], axis=1)
    return seq, tps


# a decode step's kernels of the port (K1, K4/K5, K8, K10 with its
# quantize kernel, K11; the dequants K2/K3, K6/K7, K9 of the dequant
# route), by their CUDA names; every other device op is glue
PORT_GEMV = re.compile(r"(v1|v2|wide|lut|vq|vq4)_gemv_kernel|wide_x_kernel|"
                       r"i8gemv_kernel|quantize_kernel")
# the dequant kernels by CUDA name, each with the wrappers that launch it
# once a call
DEQUANT_KERNELS = {"arith_dequant_kernel": ("tcq2_dequant",),
                   "v1_dequant_kernel": ("tcq1_dequant",),
                   "lut_ring_kernel": ("tcq_lut_dequant",
                                       "tcomb_lut_dequant"),
                   "vq_dequant_kernel": ("vq_dequant",)}
PORT_DEQUANT = re.compile("|".join(rf"\b{k}\b" for k in DEQUANT_KERNELS))
BIT_STEPS, PROFILE_STEPS = 4, 8
# the glue's kinds of device op, by name (first match; the rest "other")
GLUE_KINDS = [(kind, re.compile(pattern, re.I)) for kind, pattern in (
    ("copy/cast", r"copy_kernel|direct_copy"),
    ("matmul", r"gemm|gemv|cutlass|xmma"),
    ("reduce/softmax", r"reduce|softmax"),
    ("index", r"index|scatter|gather"),
    ("elementwise", r"elementwise"))]


def dequant_ops_check(label, names, want, n=1):
    """The dequant kernels' device ops among `names` (the traced ops of n
    runs), counted by kernel, equal to n times the launches `want` (by
    wrapper) gives each: a kernel renamed past PORT_DEQUANT fails here,
    not as time moved to the glue.  Returns the counts a run."""
    got = {kern: sum(bool(re.search(rf"\b{kern}\b", name))
                     for name in names) / n for kern in DEQUANT_KERNELS}
    need = {kern: sum(want.get(w, 0) for w in wrappers)
            for kern, wrappers in DEQUANT_KERNELS.items()}
    check(got == need, f"{label}: dequant kernels traced {got} a run, "
          f"launched {need}")
    return got


def profile_replays(label, step, pos, n, card_label, want=None):
    """torch.profiler over n replays of a captured step: device time a step
    (the ops' summed durations; the union of their intervals is the busy
    time), GEMV against glue, the top 10 ops.  Then the same n replays
    without the profiler: host clock to enqueue them and to the end of a
    synchronize, and CUDA events around them.  The device's busy share is
    the traced busy time over that unprofiled wall time (the profiler's
    own host work would inflate the wall).  Each window starts at position
    pos.  With want (the step's launches by wrapper), the dequant kernels
    traced must match it (dequant_ops_check).  Returns the summary."""
    from torch.profiler import ProfilerActivity, profile

    step.reset(step.token.clone(), pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.replay(n)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    step.reset(step.token.clone(), pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    step.replay(n)
    e1.record()
    enqueue = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    event_ms = e0.elapsed_time(e1) / n
    timing = {"wall_ms_a_step": wall * 1e3, "enqueue_ms_a_step": enqueue * 1e3,
              "event_ms_a_step": event_ms,
              "traced_wall_ms_a_step": traced * 1e3 / n}
    if not ops:
        print(f"[{label} graph] profiler: no device op in the trace; {n} "
              f"replays without it: wall {wall * 1e3:.3f} ms a step, enqueue "
              f"{enqueue * 1e3:.3f} ms, CUDA events {event_ms:.3f} ms; card "
              f"{card_label}", flush=True)
        return timing
    if want is not None:
        dequant_ops_check(f"{label} graph", [e.name for e in ops], want, n)
    spans = sorted((e.time_range.start, e.time_range.end) for e in ops)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in ops:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    total = sum(t for t, _ in by_name.values()) / n / 1e3
    gemv = sum(t for k, (t, _) in by_name.items()
               if PORT_GEMV.search(k)) / n / 1e3
    deq = sum(t for k, (t, _) in by_name.items()
              if PORT_DEQUANT.search(k)) / n / 1e3
    out = {**timing, "busy_ms_a_step": busy / n / 1e3,
           "busy_share": busy / n / 1e3 / (wall * 1e3),
           "span_share": busy / (spans[-1][1] - spans[0][0]),
           "device_ms_a_step": total, "gemv_ms_a_step": gemv,
           "dequant_ms_a_step": deq, "glue_ms_a_step": total - gemv - deq,
           "ops_a_step": len(ops) / n}
    print(f"[{label} graph] {n} replays: wall {wall * 1e3:.3f} ms a step "
          f"(host clock, to a synchronize), enqueue {enqueue * 1e3:.3f} ms, "
          f"CUDA events {event_ms:.3f} ms; traced: device busy "
          f"{out['busy_ms_a_step']:.3f} ms a step ({out['busy_share']:.1%} of "
          f"the wall, {out['span_share']:.1%} of the ops' span; the traced "
          f"window's wall {traced * 1e3 / n:.3f} ms), device time {total:.3f}"
          f" ms a step (op sum), GEMV {gemv:.3f} ms, dequant {deq:.3f} ms, "
          f"glue {total - gemv - deq:.3f} ms, {len(ops) / n:.0f} device ops "
          f"a step; card {card_label}",
          flush=True)
    kinds = {}
    for name, (t, c) in by_name.items():
        if PORT_GEMV.search(name) or PORT_DEQUANT.search(name):
            continue
        kind = next((k for k, r in GLUE_KINDS if r.search(name)), "other")
        kt, kc = kinds.get(kind, (0.0, 0))
        kinds[kind] = (kt + t, kc + c)
    out["glue_kinds"] = {k: (t / n / 1e3, c / n) for k, (t, c) in
                         kinds.items()}
    print(f"[{label} graph] glue by kind, ms a step (ops a step): " + ", ".join(
        f"{k} {t:.3f} ({c:.0f})" for k, (t, c) in sorted(
            out["glue_kinds"].items(), key=lambda kv: -kv[1][0])), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (t, c) in top:
        print(f"[{label} graph]   {t / n / 1e3:8.4f} ms a step, {c / n:5.1f} "
              f"a step: {name[:110]}", flush=True)
    # the longest single ops (on the flagship: the bf16 head's f32 copy
    # and the f32 head product)
    longest = sorted(ops, key=lambda e: -e.time_range.elapsed_us())[:3 * n]
    for e in longest[::n]:
        print(f"[{label} graph]   longest: {e.time_range.elapsed_us() / 1e3:.4f}"
              f" ms once: {e.name[:110]}", flush=True)
    return out


def clocked_replays(label, step, pos, n, card_label):
    """n replays from position pos timed with CUDA events while nvidia-smi
    samples the SM clock and the power draw every 10 ms (started before,
    stopped after the window).  Returns ms a step and the samples'
    median SM clock (MHz) and power (W)."""
    smi = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "10"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.2)
        step.reset(step.token.clone(), pos)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        step.replay(n)
        e1.record()
        torch.cuda.synchronize()
        time.sleep(0.05)
    finally:
        smi.terminate()
        log, _ = smi.communicate()
    ms = e0.elapsed_time(e1) / n
    samples = [tuple(float(v) for v in ln.split(","))
               for ln in log.splitlines() if ln.count(",") == 1]
    clk = [c for c, _ in samples] or [float("nan")]
    pw = [w for _, w in samples] or [float("nan")]
    out = {"long_ms_a_step": ms, "sm_mhz": float(np.median(clk)),
           "sm_mhz_min": min(clk), "power_w": float(np.median(pw))}
    print(f"[{label} graph] {n} replays: CUDA events {ms:.3f} ms a step; "
          f"nvidia-smi over {len(samples)} samples: SM clock median "
          f"{out['sm_mhz']:.0f} MHz (min {min(clk):.0f}, max {max(clk):.0f}),"
          f" power median {out['power_w']:.0f} W (max {max(pw):.0f}); card "
          f"{card_label}", flush=True)
    return out


def graph_phase(label, spec, params, device, want_step, card_label):
    """The path through the captured step (runtime/decode.py): the launches
    recorded at capture equal want_step; BIT_STEPS replays give the eager
    forward's logits (and caches) bit for bit from the same caches and
    position; greedy generate_fast gives the eager loop's tokens; two
    sampled generate_fast runs with one seed, and generate with it, give
    the same tokens; tokens/s of the eager loop and of the graph; a
    profile of PROFILE_STEPS replays; NEW_TOKENS replays with the SM
    clock and power sampled.  Returns {eager, graph, sampled} tokens/s,
    the profile and the clocked window."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import decode

    V = spec.config.vocab_size
    prompt = np.random.default_rng(0).integers(0, V, (1, PROMPT_LEN))
    n = GRAPH_TOKENS + 1
    T = PROMPT_LEN + NEW_TOKENS + 1
    eager_seq, eager_tps = eager_loop(spec, params, prompt, n, T)
    torch.cuda.reset_peak_memory_stats(device)
    seq0, st0 = decode.generate_fast(spec, params, prompt, n, max_seq=T,
                                     temperature=0.0)
    check(st0["captured"], f"{label}: generate_fast did not capture")
    check(np.array_equal(seq0, eager_seq),
          f"{label}: greedy tokens of the graph differ from the eager loop's "
          f"at {np.nonzero(seq0[0] != eager_seq[0])[0].tolist()}")
    for temperature in (0.0, 0.6):
        got = decode.captured_step(spec, params, 1, T, temperature,
                                   5).launches
        check(got == want_step, f"{label}: launches at capture {got}, want "
              f"{want_step}")
    runs = [decode.generate_fast(spec, params, prompt, n, max_seq=T,
                                 temperature=0.6, top_k=5, seed=99)
            for _ in range(2)]
    seq_g, st_g = decode.generate(spec, params, prompt, n, max_seq=T,
                                  temperature=0.6, top_k=5, seed=99)
    check(np.array_equal(runs[0][0], runs[1][0])
          and np.array_equal(runs[0][0], seq_g),
          f"{label}: same seed, different tokens (generate_fast twice, "
          f"generate)")
    peak = torch.cuda.max_memory_allocated(device)
    step = decode.captured_step(spec, params, 1, T, 0.6, 5)
    tok = torch.as_tensor(prompt, device=device)
    logits, _ = decode.prefill(spec, params, tok, step.caches)
    tok = decode.sample_logits(logits[:, -1], step.generator, 0.6,
                               5)[:, None]
    step.reset(tok, PROMPT_LEN)
    eager = [tuple(t.clone() for t in c) for c in step.caches]
    for i in range(BIT_STEPS):
        step.replay()
        want, eager = llama.forward(spec, params, tok, kv_caches=eager,
                                    cache_pos=PROMPT_LEN + i)
        check(torch.equal(step.logits, want[:, -1]),
              f"{label}: captured step {i} logits differ from eager, max "
              f"{(step.logits - want[:, -1]).abs().max().item()}")
        tok = step.token.clone()
    check(all(torch.equal(a, b) for c, e in zip(step.caches, eager)
              for a, b in zip(c, e)), f"{label}: captured caches differ")
    prof = profile_replays(label, step, PROMPT_LEN, PROFILE_STEPS,
                           card_label, want_step)
    prof.update(clocked_replays(label, step, PROMPT_LEN, NEW_TOKENS,
                                card_label))
    decode.release_captured(params)
    tps = {"eager": eager_tps, "graph": st0["tokens_per_sec"],
           "sampled": runs[1][1]["tokens_per_sec"],
           "generate": st_g["tokens_per_sec"], "peak_gb": peak / 1e9, **prof}
    print(f"[{label} graph] launches at capture {want_step}; {BIT_STEPS} "
          f"replays bit-equal to eager; greedy tokens equal the eager loop's;"
          f" sampled runs repeat; tokens/s bs=1 eager loop {eager_tps:.2f}, "
          f"graph {tps['graph']:.2f} (generate_fast, greedy), sampled "
          f"{tps['sampled']:.2f} (generate_fast) / {tps['generate']:.2f} "
          f"(generate), peak memory {peak / 1e9:.3f} GB; card {card_label}",
          flush=True)
    return tps


def prefill_time(label, spec, params, device, n, card_label):
    """A warm n-token prefill: host clock around a synchronized call, and
    the peak memory during it."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import decode

    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, spec.config.vocab_size, (1, n)), device=device)
    caches = llama.init_kv_caches(spec, 1, n, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    logits, _ = decode.prefill(spec, params, prompt, caches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    print(f"[{label}] warm {n}-token prefill {dt * 1e3:.1f} ms, peak memory "
          f"{peak / 1e9:.3f} GB; card {card_label}", flush=True)
    return dt


def _load_215():
    with open(os.path.join(QDIR, "215.0thp_cc.json")) as f:
        qdict = {k: tuple(v) for k, v in json.load(f).items()}
    with open(os.path.join(QDIR, "215.0thp_cc_merge_info.json")) as f:
        merge_info = json.load(f)
    return qdict, merge_info


_DRAWS = {}


def dummy_dense(num_layers):
    """The embed and head the loader draws for a dummy 8B (numpy seed 0:
    the embed, then the head; float64 * 0.02 cast to float32), drawn once
    for every build of this run, and unit norms: as dense_params they give
    the loader's own params at a fraction of the host time."""
    from qpalette_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama31_8b()
    if not _DRAWS:
        rng = np.random.default_rng(0)
        shape = (cfg.vocab_size, cfg.hidden_size)
        for name in ("embed", "lm_head"):
            _DRAWS[name] = (rng.standard_normal(shape) * 0.02).astype(
                np.float32)
    ones = np.ones(cfg.hidden_size, np.float32)
    return {"embed": _DRAWS["embed"], "lm_head": _DRAWS["lm_head"],
            "ln_f": ones,
            "layers": [{"ln_attn": ones, "ln_mlp": ones}] * num_layers}


def _build(what, qdict, merge_info, impl, lm_head_bits, device):
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    t0 = time.perf_counter()
    spec, params = build_quantized_model(
        LlamaConfig.llama31_8b(), qdict, merge_info=merge_info, dummy=True,
        impl=impl, lm_head_bits=lm_head_bits, seed=0, device=device,
        dense_params=dummy_dense(32))
    torch.cuda.synchronize()
    print(f"[{what}] 8B built in {time.perf_counter() - t0:.1f} s", flush=True)
    return spec, params


def with_impl(spec, impl):
    """The same model with every decoder projection at another impl (the
    4-bit head stays a8, as in the reference)."""
    def proj(ls):
        return dataclasses.replace(ls, impl=impl)
    layers = tuple((dataclasses.replace(a, projs=tuple(
        (n, proj(ls)) for n, ls in a.projs)), dataclasses.replace(
        m, projs=tuple((n, proj(ls)) for n, ls in m.projs)))
        for a, m in spec.layers)
    return dataclasses.replace(spec, layers=layers)


def main_path(device, card_label):
    """The 215 path: 129 sum2 K1 calls per forward (a decode forward's at
    N=1 one launch each, the 16-token prefill's two); then the same model
    through the zero-shot harness (zs_check) and a warm a8 512-token
    prefill; then the serving phase on it (serving_pool).  Returns the
    launch counts of all, the qdict, graph_phase's result and zs_check's
    summary with the prefill's ms and the serving summary."""
    from qpalette_tpu_torch.kernels import arith

    qdict, merge_info = _load_215()
    spec, params = _build("main", qdict, merge_info, "a8", 4, device)
    want = {"tcq2s_decode_gemv": LAUNCHES_PER_FORWARD}
    want_prefill = {"tcq2s_decode_gemv": LAUNCHES_PER_FORWARD
                    * arith.kernel_launches("sum2", PROMPT_LEN)}
    launches = drive("main", spec, params, device, PROMPT_LEN,
                     COUNTED_TOKENS, want_prefill, want)
    graphs = {"215": graph_phase("main", spec, params, device, want,
                                 card_label)}
    zs_counts, zs = zs_check(spec, params, device, card_label)
    for k, v in zs_counts.items():
        launches[k] += v
    zs["a8_prefill_512_ms"] = 1e3 * prefill_time(
        "main a8", spec, params, device, PREFILL_B, card_label)
    serve_counts, serve = serving_pool(spec, params, device, card_label)
    for k, v in serve_counts.items():
        launches[k] += v
    zs["serve"] = serve
    del params
    torch.cuda.empty_cache()
    return launches, qdict, graphs, zs


# the serving phase's 16-slot pool on the 215 model (6b): requests with
# prompts of 24-300 tokens (256-token chunks and mixed tails) and 8-64 new
# tokens, bursts of 16, sampled at temperature 0.6, top-k 5; a cache of
# SERVE_MAX_SEQ positions, so that the longest prompts stop at a full
# cache.  Then a greedy run at impl exact (head exact too: no row of the
# pool moves another's numbers) of (prompt length, new tokens) requests.
SERVE_SLOTS, SERVE_REQUESTS, SERVE_BURST, SERVE_MAX_SEQ = 16, 32, 16, 320
SERVE_PROMPT, SERVE_NEW = (24, 300), (8, 64)
SERVE_GREEDY = ((40, 6), (100, 6), (270, 6))
# a greedy pool token against the argmax of a B=1 eager forward over its
# prefix: equal, or short of it by at most this share of max|logit| (the
# pool's 16-row K1 calls and cached attention sum in another order)
NEAR_TIE_8B = 2e-2


def _pool_state(pool):
    return ([tuple(t.clone() for t in kv) for kv in pool.caches],
            [t.clone() for t in (pool.token, pool.pos, pool.active,
                                 pool.logits, pool.history)],
            pool.generator.get_state())


def _set_pool_state(pool, state):
    caches, bufs, gen = state
    for mine, kv in zip(pool.caches, caches):
        for a, b in zip(mine, kv):
            a.copy_(b)
    for a, b in zip((pool.token, pool.pos, pool.active, pool.logits,
                     pool.history), bufs):
        a.copy_(b)
    pool.generator.set_state(gen)


def _equal_state(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
            and all(torch.equal(x, y) for p, q in zip(a[0], b[0])
                    for x, y in zip(p, q)))


def serving_pool(spec, params, device, card_label):
    """6b. The 215 model (a8, 4-bit head) served from a 16-slot pool
    (runtime/serving.py): the pool step captured at 16 rows (129 K1 sum2
    calls on wide_gemv_kernel, two launches each, counted); two replays
    bit-equal to two eager pool steps from the same buffers (per-row
    positions, inactive rows, the generator's state); an admission that
    leaves the other 14 slots' cache rows bit-unchanged; SERVE_REQUESTS
    requests (every count set to 0 just before, read just after): each
    ends with its max_new_tokens tokens or at a full cache; aggregate
    tokens/s, admission s, steps and bursts, peak memory, SM clock; then
    a greedy
    run at impl exact, each token the argmax of a B=1 eager forward over
    its prefix or within NEAR_TIE_8B of it (its pool's capture, admission
    and forwards counted).  Returns (launch counts, summary)."""
    from qpalette_tpu_torch.kernels import (arith, launch_counts,
                                            reset_launches)
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import serving

    V, B, T = spec.config.vocab_size, SERVE_SLOTS, SERVE_MAX_SEQ
    t_phase = time.perf_counter()
    pool = serving.pool_step(spec, params, B, T, 0.6, 5)
    want = {"tcq2s_decode_gemv": LAUNCHES_PER_FORWARD
            * arith.kernel_launches("sum2", B)}
    check(pool.graph is not None and pool.launches == want,
          f"serve pool: launches at capture {pool.launches}, want {want}")
    rng = np.random.default_rng(7)
    serving.prefill_slots(spec, params, pool.caches,
                          torch.arange(B, device=device),
                          torch.as_tensor(rng.integers(0, V, (B, 24)),
                                          device=device),
                          torch.zeros(B, dtype=torch.int64, device=device))
    pool.load(rng.integers(0, V, (B, 1)), rng.integers(24, 40, B),
              np.arange(B) % 4 != 3)
    state = _pool_state(pool)
    pool.replay(2)
    graph = _pool_state(pool)
    _set_pool_state(pool, state)
    pool.step_eager()
    pool.step_eager()
    eager = _pool_state(pool)
    check(_equal_state(graph, eager), "serve pool: 2 replays differ from 2 "
          "eager pool steps")
    del state, graph
    slots = [13, 2]
    serving.prefill_slots(spec, params, pool.caches,
                          torch.tensor(slots, device=device),
                          torch.as_tensor(rng.integers(0, V, (2, 40)),
                                          device=device),
                          torch.tensor([0, 30], device=device))
    others = [s for s in range(B) if s not in slots]
    check(all(torch.equal(a[others], b[others])
              and not torch.equal(a[slots], b[slots])
              for kv, old in zip(pool.caches, eager[0])
              for a, b in zip(kv, old)),
          "serve admission: other slots' cache rows changed")
    del eager
    print(f"[serve] 16-slot pool of the 215 model: launches at capture "
          f"{pool.launches}; 2 replays bit-equal to 2 eager pool steps "
          f"(per-row positions, 4 rows inactive); an admission of 2 slots "
          f"left the other 14 slots' cache rows bit-unchanged", flush=True)

    rng = np.random.default_rng(0)
    reqs = [(list(rng.integers(0, V, rng.integers(SERVE_PROMPT[0],
                                                 SERVE_PROMPT[1] + 1))),
             int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1)))
            for _ in range(SERVE_REQUESTS)]
    b = serving.ContinuousBatcher(spec, params, n_slots=B, max_seq=T,
                                  temperature=0.6, top_k=5, seed=0)
    rids = [b.submit(p, n) for p, n in reqs]
    stats = {"admit_s": 0.0, "admissions": 0, "bursts": 0, "steps": 0}
    admit0, burst0, step0 = b._admit, b.step_burst, b.step

    def admit():
        t0 = time.perf_counter()
        n = admit0()
        if n:
            torch.cuda.synchronize()
            stats["admit_s"] += time.perf_counter() - t0
            stats["admissions"] += 1
        return n

    def burst(n):
        stats["bursts"] += 1
        stats["steps"] += n
        return burst0(n)

    def step():
        stats["steps"] += 1
        return step0()

    b._admit, b.step_burst, b.step = admit, burst, step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    with SmClock() as clock:
        t0 = time.perf_counter()
        done = b.run(burst=SERVE_BURST)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = launch_counts()
    run_counts = {k: v for k, v in counts.items() if v}
    for k, v in pool.launches.items():
        counts[k] += v
    peak = torch.cuda.max_memory_allocated(device)
    check(set(done) == set(rids), "serve: unfinished requests")
    full = 0
    for rid, (p, n) in zip(rids, reqs):
        out = done[rid].output
        check(len(out) == min(n, T - len(p)),
              f"serve request {rid}: {len(out)} tokens, prompt {len(p)}, "
              f"max_new_tokens {n}")
        check(all(0 <= t < V for t in out), f"serve request {rid}: token "
              f"out of vocab")
        full += n > T - len(p)
    n_tok = sum(len(done[r].output) for r in rids)
    check(run_counts.get("tcq2s_decode_gemv", 0) > 0,
          "serve: admission launched no K1")
    res = {"slots": B, "requests": SERVE_REQUESTS, "tokens": n_tok,
           "seconds": dt, "tokens_s": n_tok / dt,
           "admission_s": stats["admit_s"],
           "admissions": stats["admissions"], "steps": stats["steps"],
           "bursts": stats["bursts"], "full_cache_stops": full,
           "peak_gb": peak / 1e9, "sm_mhz": clock.mhz,
           "run_launches": run_counts, "capture_launches": pool.launches}
    print(f"[serve] {SERVE_REQUESTS} requests (prompts {SERVE_PROMPT[0]}-"
          f"{SERVE_PROMPT[1]}, {SERVE_NEW[0]}-{SERVE_NEW[1]} new tokens, "
          f"bursts of {SERVE_BURST}) through {B} slots: {n_tok} tokens in "
          f"{dt:.3f} s, {n_tok / dt:.2f} tokens/s aggregate, admission "
          f"{stats['admit_s']:.3f} s in {stats['admissions']} passes, "
          f"{stats['steps']} steps in {stats['bursts']} bursts, {full} "
          f"stopped at a full cache, peak memory {peak / 1e9:.3f} GB, "
          f"{clock}; eager launches in the run (admission) "
          f"{res['run_launches']}; card {card_label}", flush=True)

    ex = with_impl(spec, "exact")
    ex = dataclasses.replace(ex, lm_head_spec=dataclasses.replace(
        ex.lm_head_spec, impl="exact"))
    reset_launches()
    g = serving.ContinuousBatcher(ex, params, n_slots=B, max_seq=T,
                                  temperature=0.0)
    prompts = [list(rng.integers(0, V, L)) for L, _ in SERVE_GREEDY]
    ids = [g.submit(p, n) for p, (_, n) in zip(prompts, SERVE_GREEDY)]
    done = g.run(burst=SERVE_BURST)
    agree, worst = 0, 0.0
    for rid, p, (_, n) in zip(ids, prompts, SERVE_GREEDY):
        seq = list(p)
        out = done[rid].output
        check(len(out) == n, f"serve greedy {rid}: {len(out)} tokens")
        for tok in out:
            lg = llama.forward(ex, params, torch.as_tensor(
                [seq], device=device))[0, -1]
            best = int(torch.argmax(lg))
            gap = float(lg[best] - lg[tok]) / float(lg.abs().max())
            agree += tok == best
            worst = max(worst, gap)
            check(gap <= NEAR_TIE_8B, f"serve greedy: token {tok} against "
                  f"argmax {best}, gap {gap:.3e} of max|logit|")
            seq.append(tok)
    for k, v in launch_counts().items():
        counts[k] += v
    n_greedy = sum(n for _, n in SERVE_GREEDY)
    # every K1 call of this phase is above 8 rows (the 16-row pool step,
    # admissions of 23 rows or more, B=1 forwards over 40 or more)
    res.update(greedy_exact_agree=agree, greedy_tokens=n_greedy,
               greedy_worst_gap=worst,
               k1_wide_launches=counts["tcq2s_decode_gemv"])
    print(f"[serve] greedy exact run ({len(SERVE_GREEDY)} requests in the "
          f"16-slot pool): {agree} of {n_greedy} tokens the argmax of a B=1 "
          f"eager forward over the prefix, the largest gap {worst:.3e} of "
          f"max|logit| (limit {NEAR_TIE_8B:.0e}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    serving.release_pools(params)
    return counts, res


def serving_bench(card_label):
    """6c. python -m qpalette_tpu_torch.bench_serving at its defaults (4
    slots, 8 requests of 128 tokens + 64 new, the rotated int8 head: K10
    in the pool step, K1 sum2 at N = 4 in it and above 8 rows in
    admission), every count set to 0 just before, read just after (the
    capture's launches and the eager admissions').  Returns (launch
    counts, its JSON result)."""
    from qpalette_tpu_torch import bench_serving
    from qpalette_tpu_torch.kernels import launch_counts, reset_launches

    t0 = time.perf_counter()
    reset_launches()
    res = bench_serving.main([])
    counts = launch_counts()
    check(res["raw_tokens"] == 8 * 64, f"bench_serving tokens {res}")
    check(counts["int8_gemv_a8"] > 0 and counts["tcq2s_decode_gemv"] > 0,
          f"bench_serving launches {counts}")
    print(f"[serve] bench_serving (4 slots): {res['value']} tokens/s, "
          f"admission {res['admission_s']} s of {res['seconds']} s, "
          f"launches {({k: v for k, v in counts.items() if v})}; "
          f"{time.perf_counter() - t0:.1f} s; card {card_label}", flush=True)
    torch.cuda.empty_cache()
    return counts, res


# the latency table and qdict measured and solved on the H100 (12)
H100_TABLE = os.path.join(ROOT, "assets", "3_8b_latency_coeffs_h100.json")
H100_QDIR = os.path.join(ROOT, "msq_results", "3_8b", "lat_constrained",
                         "h100", "default_err")
FIT_GROUPS = "q,ug"
FIT_QS = "tcq2s_6_none_0.9,tcq_6_none_0.9,ldlq_2_6_none_1.0"


def msq_path(device, card_label, tps_215):
    """12. The H100 qdict (the latency-constrained solve against the
    table measured on this card, committed under H100_QDIR): its census's
    launches in a counted eager run (16-token prefill, 4 decode forwards),
    the launches at capture, its tokens/s through generate() beside the
    table's estimate, and the 215's (tps_215, measured through generate()
    in 9d) beside its; then fit_latency_coeffs in sample mode over
    FIT_GROUPS x FIT_QS (and the ldlq dequant keys), each entry beside the
    committed table's.  Returns (launch counts, summary)."""
    import glob
    import tempfile
    from qpalette_tpu_torch import fit_latency_coeffs
    from qpalette_tpu_torch.msq.latmodel import qdict_latency
    from qpalette_tpu_torch.runtime import decode

    with open(H100_TABLE) as f:
        table = json.load(f)
    (path,) = glob.glob(os.path.join(H100_QDIR, "*thp_cc.json"))
    with open(path) as f:
        qdict = {k: tuple(v) for k, v in json.load(f).items()}
    with open(path.replace(".json", "_merge_info.json")) as f:
        merge_info = json.load(f)
    q215, m215 = _load_215()
    est = {"h100": 1.0 / qdict_latency(table, qdict, merge_info, 32),
           "215": 1.0 / qdict_latency(table, q215, m215, 32)}
    spec, params = _build("h100", qdict, merge_info, "a8", 4, device)
    want, _, _ = census("h100", spec, params, (PROMPT_LEN, 1))
    launches = drive("h100", spec, params, device, PROMPT_LEN, 4,
                     want[PROMPT_LEN], want[1])
    T = PROMPT_LEN + NEW_TOKENS + 1
    got = decode.captured_step(spec, params, 1, T, 0.6, 5).launches
    check(got == want[1], f"h100: launches at capture {got}, want {want[1]}")
    tps = throughput("h100", spec, params, device, card_label)
    del params
    torch.cuda.empty_cache()
    res = {"qdict": os.path.relpath(path, ROOT), "est_tokens_s": est,
           "tokens_s": {"h100": tps, "215": tps_215},
           "table_sm_mhz": table.get("__sm_mhz__")}
    print(f"[msq] tokens/s bs=1 under the H100 table "
          f"({table['__device__']}): the H100 qdict "
          f"({res['qdict']}) estimated {est['h100']:.2f}, measured "
          f"{tps:.2f}; the 215 estimated {est['215']:.2f}, measured "
          f"{tps_215:.2f} (captured step, generate(); card {card_label})",
          flush=True)
    env = {k: os.environ.get(k) for k in ("QPT_FIT_GROUPS", "QPT_FIT_QS")}
    os.environ.update(QPT_FIT_GROUPS=FIT_GROUPS, QPT_FIT_QS=FIT_QS)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            sample = fit_latency_coeffs.main([
                "--constant", str(table["constant"]),
                "--out", os.path.join(tmp, "sample.json")])
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ratios = {}
    for g in FIT_GROUPS.split(","):
        for q in FIT_QS.split(","):
            for fl in (("False", "True") if q.startswith("ldlq")
                       else ("False",)):
                key = f"{g}_{q}_{fl}"
                check(sample[key] > 0, f"fit sample {key}")
                ratios[key] = sample[key] / table[key]
    print(f"[msq] fit_latency_coeffs sample grid ({FIT_GROUPS} x {FIT_QS}):"
          f" this run / the committed table: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
          + f"; SM {sample['__sm_mhz__']} MHz (card {card_label})",
          flush=True)
    res["fit_sample_ratio"] = ratios
    return launches, res


def flagship_shapes(cfg, qdict):
    """{(m, k, KV): projections per forward} of the flagship qdict."""
    from qpalette_tpu_torch.quant.incoherent import parse_quantizer_str
    from qpalette_tpu_torch.runtime.loader import proj_shape

    out = {}
    for key, qstr in qdict.items():
        m, k = proj_shape(cfg, key.split("_", 1)[1])
        q = parse_quantizer_str(qstr)
        check(q.family in ("tcq", "tcomb"), f"{key}: {qstr}")
        out[m, k, q.KV] = out.get((m, k, q.KV), 0) + 1
    return out


def _lut_words(m, k, KV, device, seed):
    return [_words(m, k // len(KV), 4 * kv, device, seed + i)
            for i, kv in enumerate(KV)]


# (label, wrapper, mode, KVs, m, k) of the dequants timed alone: K3 at a
# palette and an off-palette KV (once a run-time instance) and 2mad, K7
# at the palette's 6/7, the off-palette 5/7 and the flagship's 8/9, K6 and
# K2 beside them (the palette's and a run-time KV), all at 4096x4096; then
# the largest path shapes, whose W-hat does not fit L2: K6 at the
# flagship's gate/up and down, K2 at the tcq2mix and 215 ug, K3 at the
# tcq2mix down
DQ_CASES = [("K3 1mad KV3", "tcq1_dequant", "1mad", (3,)),
            ("K3 1mad KV6", "tcq1_dequant", "1mad", (6,)),
            ("K3 2mad KV4", "tcq1_dequant", "2mad", (4,)),
            ("K7 6/7", "tcomb_lut_dequant", None, (6, 7)),
            ("K7 5/7", "tcomb_lut_dequant", None, (5, 7)),
            ("K7 8/9", "tcomb_lut_dequant", None, (8, 9)),
            ("K6 KV6", "tcq_lut_dequant", None, (6,)),
            ("K6 KV2", "tcq_lut_dequant", None, (2,)),
            ("K2 sum2 KV6", "tcq2_dequant", "sum2", (6,)),
            ("K2 sum2 KV3", "tcq2_dequant", "sum2", (3,))]
DQ_CASES = [c + (4096, 4096) for c in DQ_CASES] + [
    ("K6 KV6 14336x4096", "tcq_lut_dequant", None, (6,), 14336, 4096),
    ("K6 KV6 4096x14336", "tcq_lut_dequant", None, (6,), 4096, 14336),
    ("K2 dualmad KV7 28672x4096", "tcq2_dequant", "dualmad", (7,), 28672,
     4096),
    ("K2 sum2 KV4 28672x4096", "tcq2_dequant", "sum2", (4,), 28672, 4096),
    ("K3 1mad KV3 4096x14336", "tcq1_dequant", "1mad", (3,), 4096, 14336)]
# ragged shapes each instance is also checked at: tile-rows of 17, 34 and
# 258 k-tiles (tcomb halves of 17 and 129), so last groups of 1 or 2 tiles
DQ_RAGGED = [(16, 272), (16, 544), (48, 4128)]


def dq_shapes(KV):
    """4096x4096 and the DQ_RAGGED shapes that KV's kernel takes (tcomb: k
    a multiple of 32)."""
    return [(m, k) for m, k in [(4096, 4096)] + DQ_RAGGED
            if k % (16 * len(KV)) == 0]


def dq_case(wrapper, mode, KV, m, k, dev, cycled=False):
    """(run(i, out), plain(), bound ms) of a dequant instance at (m, k):
    run writes W-hat from copy i of the words (one copy, or with `cycled`
    enough to exceed L2 three times), plain() from copy 0."""
    from qpalette_tpu_torch.kernels import arith, arith_dequant, tcq_lut
    from qpalette_tpu_torch.ops.codebooks import tlut_bits_for_kv, trellis_tlut

    if mode is not None:
        W = arith.words_per_tile(mode, KV[0])
        nbytes = (m // 16) * (k // 16) * W * 4
        n = min(64, -(-3 * L2_BYTES // nbytes)) if cycled else 1
        cp = [_words(m, k, W, dev, seed=100 + i) for i in range(n)]
        fn = getattr(arith_dequant, wrapper)

        def run(i, out=None):
            return fn(cp[i % len(cp)], KV[0], m, k, mode, out=out)

        def plain():
            return arith_dequant.arith_dequant_plain(cp[0], mode, KV[0], m, k)
    else:
        tlut = torch.tensor(trellis_tlut(tlut_bits_for_kv(max(KV))),
                            device=dev)
        nbytes = m * k * sum(KV) // (16 * len(KV))
        n = min(64, -(-3 * L2_BYTES // nbytes)) if cycled else 1
        cp = [_lut_words(m, k, KV, dev, seed=100 * i + 1)
              for i in range(n)]
        nbytes += tlut.numel() * 4
        fn = getattr(tcq_lut, wrapper)
        plain_fn = getattr(tcq_lut, wrapper + "_plain")

        def run(i, out=None):
            return fn(*cp[i % len(cp)], tlut, *KV, m, k, out=out)

        def plain():
            return plain_fn(*cp[0], tlut, *KV, m, k)
    return run, plain, dequant_bound(nbytes, m, k)[0]


def lut_kernel_checks(tcq_lut, shapes, device):
    """K4-K7 against their plain versions at every flagship shape; returns
    ({kernel: max_abs_err}, {kernel: [ms, plain ms, bound ms per
    forward]})."""
    from qpalette_tpu_torch.ops.codebooks import tlut_bits_for_kv, trellis_tlut

    err = {f.__name__: 0.0 for f in tcq_lut.KERNELS}
    times = {f.__name__: [0.0, 0.0, 0.0] for f in tcq_lut.KERNELS}
    for (m, k, KV), count in sorted(shapes.items()):
        tcomb = len(KV) == 2
        gemv, gemv_plain, deq, deq_plain = (
            (tcq_lut.tcomb_lut_gemv, tcq_lut.tcomb_lut_gemv_plain,
             tcq_lut.tcomb_lut_dequant, tcq_lut.tcomb_lut_dequant_plain)
            if tcomb else
            (tcq_lut.tcq_lut_gemv, tcq_lut.tcq_lut_gemv_plain,
             tcq_lut.tcq_lut_dequant, tcq_lut.tcq_lut_dequant_plain))
        tlut = torch.tensor(trellis_tlut(tlut_bits_for_kv(max(KV))),
                            device=device)
        words = _lut_words(m, k, KV, device, seed=m + k + sum(KV))
        label = f"{m}x{k} KV={'/'.join(map(str, KV))}"
        for N in (*range(1, 9), 16):
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).bfloat16()
            if N <= 8:
                y = gemv(x, *words, tlut, *KV, m, k)
                torch.cuda.synchronize()
                ref = gemv_plain(x, *words, tlut, *KV, m, k)
                err[gemv.__name__] = max(err[gemv.__name__], _rel_check(
                    f"{gemv.__name__} {label} N={N}", y, ref, LUT_TOL))
                if N == 8:  # the split-k sums are added in a fixed order
                    y2 = gemv(x, *words, tlut, *KV, m, k)
                    same = torch.equal(y.view(torch.int32),
                                       y2.view(torch.int32))
                    print(f"[lut] {gemv.__name__} {label} N=8: two launches "
                          f"bit-equal={same}", flush=True)
                    check(same, f"{gemv.__name__} {label}: launches differ")
                continue
            w = deq(*words, tlut, *KV, m, k)
            torch.cuda.synchronize()
            w_ref = deq_plain(*words, tlut, *KV, m, k)
            same = torch.equal(w.view(torch.int16), w_ref.view(torch.int16))
            y = x.float() @ w.float().T
            ref = x.float() @ w_ref.float().T
            e = (y - ref).abs().max().item()
            rel = e / ref.abs().max().item()
            err[deq.__name__] = max(err[deq.__name__], e)
            print(f"[lut] {deq.__name__} {label}: bit-equal={same}; "
                  f"product N=16 max_abs_err={e:.3e} rel={rel:.3e} (limit "
                  f"{PRODUCT_TOL:.0e})", flush=True)
            check(same, f"{deq.__name__} {label}: not bit-equal")
            check(rel <= PRODUCT_TOL, f"{deq.__name__} {label}: rel {rel}")
        if not count:
            continue  # checked, not on a path: no times

        # cycle through copies of the weights so that repeated launches
        # stream from device memory, as a forward does, not from L2
        nbytes = m * k * sum(KV) // (16 * len(KV))
        copies = [_lut_words(m, k, KV, device, seed=100 * i)
                  for i in range(min(64, -(-3 * L2_BYTES // nbytes)))]
        x1 = torch.randn((1, k), device=device).bfloat16()
        x16 = torch.randn((16, k), device=device).bfloat16()
        out = torch.empty((1, m), device=device)
        wout = torch.empty((m, k), dtype=torch.bfloat16, device=device)

        def kern(i=0):
            gemv(x1, *copies[i % len(copies)], tlut, *KV, m, k, out=out)

        def plain(i=0):
            gemv_plain(x1, *copies[i % len(copies)], tlut, *KV, m, k)

        def kern16(i=0):
            deq(*copies[i % len(copies)], tlut, *KV, m, k, out=wout)
            x16.float() @ wout.float().T

        def plain16(i=0):
            w = deq_plain(*copies[i % len(copies)], tlut, *KV, m, k)
            x16.float() @ w.float().T

        def kern_deq(i=0):
            deq(*copies[i % len(copies)], tlut, *KV, m, k, out=wout)

        def plain_deq(i=0):
            deq_plain(*copies[i % len(copies)], tlut, *KV, m, k)

        # the kernels' entries in the JSON line: the kernel alone (GEMV at
        # N=1, dequant) against its plain version alone, summed over a
        # forward's calls; the dequant + product at N=16 is printed beside
        S = tlut_bits_for_kv(max(KV))
        tbytes = nbytes + 2 * 4 * (1 << S)
        tab_bits = tcq_lut.GEMV_TABLE_BITS
        ncopy = 1 << (tab_bits - 2 - S)
        layout = (f"table {(1 << tab_bits) // 1024} KB: {ncopy} copies of "
                  f"each of the 2^{S} entries, lane l reads copy l % {ncopy}")
        bounds = {gemv: gemv_bound(tbytes, 1, m, k, 2, False)[0],
                  deq: dequant_bound(tbytes, m, k)[0]}
        for fn, route, reps, plain_route in (
                (gemv, kern, 200, False), (gemv, plain, 5, True),
                (deq, kern_deq, 50, False), (deq, plain_deq, 5, True),
                (None, kern16, 50, False), (None, plain16, 5, True)):
            ms = _time_ms(route, reps, graph=not plain_route)
            if fn is not None:
                times[fn.__name__][plain_route] += count * ms
                if not plain_route:
                    times[fn.__name__][2] += count * bounds[fn]
            gbps = nbytes / (ms * 1e-3) / 1e9
            print(f"[time] {label} {route.__name__}: {ms:.4f} ms a call"
                  + (f" ({gbps:.0f} GB/s of packed trellis, bound "
                     f"{bounds[fn]:.4f} ms, {bounds[fn] / ms:.1%} of it)"
                     if route in (kern, kern_deq) else "")
                  + (f"; {layout}" if route is kern else ""), flush=True)
        del copies, wout
    return err, times


def _k1_case(arith, mode, name, m, k, KV, calls, step, device):
    """A parent_ab case of K1 at a8, N=1: its calls in a decode step of
    the path `step`."""
    copies, nbytes = _copies(m, k, arith.words_per_tile(mode, KV), device)

    def run(x, w, out=None):
        return arith.decode_gemv(mode, x, w, KV, m, k, True, out=out)

    def plain(x, w):
        return arith.arith_gemv_plain(x, w, mode, KV, m, k, True)

    return {"label": f"{mode} {name} {m}x{k} KV={KV}", "m": m, "k": k,
            "calls": calls, "step": step,
            "kernel": {"sum2": "tcq2s_decode_gemv",
                       "dualmad": "tcq2_decode_gemv",
                       "1mad": "tcq1_decode_gemv",
                       "2mad": "tcq1_decode_gemv"}[mode],
            "copies": copies, "run": run, "plain": plain,
            "x_dtype": torch.float32, "tol": TOL[True],
            "bound": gemv_bound(nbytes, 1, m, k, 4, True)[0]}


def _sum2_cases(arith, qdict, device):
    """K1 sum2 at the 215 shapes, each with its calls in a 215 decode
    step (ug by the qdict's KV mix)."""
    ug_kv = [int(qdict[f"{i}_mlp.up_proj"][0].split("_")[1])
             for i in range(32)]
    return [_k1_case(arith, "sum2", name, m, k, KV,
                     sum(kv == KV for kv in ug_kv) if name == "ug"
                     else CALLS_PER_STEP[name], "215", device)
            for name, m, k, KV in SHAPES_215]


def _ab_sum2(device, smi):
    """parent_ab's K1 sum2 cases (the 215 shapes) and the 215 decode."""
    from qpalette_tpu_torch.kernels import arith

    qdict, merge_info = _load_215()
    cases = _sum2_cases(arith, qdict, device)
    spec, params = _build("main", qdict, merge_info, "a8", 4, device)
    return arith, "tcq2_gemv", arith.SIGNATURES["tcq2_gemv"], cases, (
        "215", spec, params)


def _ab_tcq2mix(device, smi):
    """parent_ab's K1 dualmad cases (Path A's qkv and ug, 32 calls a
    step each), the 215 sum2 cases beside them (the same source), and
    Path A's a8 decode."""
    from qpalette_tpu_torch.kernels import arith

    cases = [_k1_case(arith, mode, name, m, k, KV, calls, "Path A", device)
             for name, m, k, mode, KV, calls in SHAPES_ARITH
             if mode == "dualmad" and calls]
    cases += _sum2_cases(arith, _load_215()[0], device)
    spec, params = _build("pathA", tcq2mix_qdict(),
                          [["merge_qkv", "merge_ug"]] * 32, "a8", 4, device)
    return arith, "tcq2_gemv", arith.SIGNATURES["tcq2_gemv"], cases, (
        "Path A a8", spec, params)


def _ab_tcq1(device, smi):
    """parent_ab's K1 1mad cases (Path A's o and down, 32 calls a step
    each), 2mad at 4096x4096 KV 3 and 4 (on no path: timed, 0 calls), and
    Path A's a8 decode."""
    from qpalette_tpu_torch.kernels import arith

    cases = [_k1_case(arith, mode, name, m, k, KV, calls, "Path A", device)
             for name, m, k, mode, KV, calls in SHAPES_ARITH
             if mode in ("1mad", "2mad") and name != "odd_kt"]
    spec, params = _build("pathA", tcq2mix_qdict(),
                          [["merge_qkv", "merge_ug"]] * 32, "a8", 4, device)
    return arith, "tcq1_gemv", arith.SIGNATURES["tcq1_gemv"], cases, (
        "Path A a8", spec, params)


def _ab_lut(device, smi):
    """parent_ab's K4/K5 cases: the flagship shapes at N=1, each with its
    calls in a flagship decode forward."""
    from qpalette_tpu_torch.kernels import tcq_lut
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.ops.codebooks import tlut_bits_for_kv, trellis_tlut

    with open(FLAGSHIP_QDICT) as f:
        qdict = json.load(f)
    cases = []
    for (m, k, KV), calls in sorted(flagship_shapes(
            LlamaConfig.llama31_8b(), qdict).items()):
        gemv, plain_fn = (
            (tcq_lut.tcomb_lut_gemv, tcq_lut.tcomb_lut_gemv_plain)
            if len(KV) == 2 else
            (tcq_lut.tcq_lut_gemv, tcq_lut.tcq_lut_gemv_plain))
        S = tlut_bits_for_kv(max(KV))
        tlut = torch.tensor(trellis_tlut(S), device=device)
        nbytes = m * k * sum(KV) // (16 * len(KV))
        copies = [_lut_words(m, k, KV, device, seed=100 * i)
                  for i in range(min(64, -(-3 * L2_BYTES // nbytes)))]

        def run(x, w, out=None, m=m, k=k, KV=KV, gemv=gemv, tlut=tlut):
            return gemv(x, *w, tlut, *KV, m, k, out=out)

        def plain(x, w, m=m, k=k, KV=KV, plain_fn=plain_fn, tlut=tlut):
            return plain_fn(x, *w, tlut, *KV, m, k)

        cases.append({"label": f"{gemv.__name__} {m}x{k} KV={KV}", "m": m,
                      "k": k, "calls": calls, "step": "flagship",
                      "kernel": gemv.__name__,
                      "copies": copies, "run": run, "plain": plain,
                      "x_dtype": torch.bfloat16, "tol": LUT_TOL,
                      "bound": gemv_bound(nbytes + 2 * 4 * (1 << S), 1, m,
                                          k, 2, False)[0]})
    spec, params = _build("flagship", qdict, None, "exact", 16, device)
    return tcq_lut, tcq_lut.SOURCE, tcq_lut.SIGNATURES, cases, (
        "flagship", spec, params)


def _vq_case(vq, name, m, k, bits, vec, calls, step, kernel, device):
    """A parent_ab case of K8 at N=1: its calls in a decode forward of the
    path `step`."""
    lut = _vq_lut(bits, vec, device)
    nbytes = m * vq.row_words(k, bits, vec) * 4 + lut.numel() * 4
    copies = [_vq_words(m, k, bits, vec, device, seed=100 + i)
              for i in range(min(64, -(-3 * L2_BYTES // nbytes)))]

    def run(x, w, out=None):
        return vq.vq_gemv(x, w, lut, bits, vec, m, k, out=out)

    def plain(x, w):
        return vq.vq_gemv_plain(x, w, lut, bits, vec, m, k)

    return {"label": f"vq bits={bits} vec={vec} {name} {m}x{k}", "m": m,
            "k": k, "calls": calls, "step": step, "kernel": kernel,
            "copies": copies, "run": run, "plain": plain,
            "x_dtype": torch.bfloat16, "tol": VQ_TOL,
            "bound": gemv_bound(nbytes, 1, m, k, 2, False)[0]}


def _ab_vq(device, smi):
    """parent_ab's K8 cases: ldlq_2_6 at Path C's four shapes (32 calls a
    forward each), ldlq_1_4 at Path D's (8 layers, unmerged), every other
    ldlq (bits, vec) at o and down (on no path: timed, 0 calls), and Path
    C's a8 decode."""
    from qpalette_tpu_torch.kernels import vq

    cases = [_vq_case(vq, name, m, k, 6, 2, 32, "Path C", "vq_gemv", device)
             for name, m, k in SHAPES_8B]
    cases += [_vq_case(vq, name, m, k, 4, 1, calls, "Path D",
                       "vq_gemv_pathD", device)
              for name, m, k, calls in PATH_D_SHAPES]
    cases += [_vq_case(vq, name, m, k, b, v, 0, "no path", "vq_gemv_other",
                       device)
              for b, v in vq.SUPPORTED if (b, v) not in ((6, 2), (4, 1))
              for name, m, k in SHAPES_8B[1::2]]
    spec, params = _build("pathC", PATH_C_QSTR, [["merge_qkv", "merge_ug"]]
                          * 32, "a8", 8, device)
    return vq, vq.SOURCE, vq.SIGNATURES, cases, ("Path C", spec, params)


def _ab_vq4(device, smi):
    """parent_ab's K8 cases at vec 4: ldlq_4_8 at Path F's o and down (32
    calls a 32-layer forward each, summed apart), the other eight vec-4
    bits at o and down (on no path: timed, 0 calls), and Path F's a8
    decode (its vec-4 codebook made into a temporary QPALETTE_ASSETS)."""
    from qpalette_tpu_torch.kernels import vq

    temp_assets()
    cases = [_vq_case(vq, name, m, k, *VQ4, 32, "32-layer Path F",
                      f"vq_gemv_vec4 {name}", device)
             for name, m, k in SHAPES_8B[1::2]]
    cases += [_vq_case(vq, name, m, k, b, 4, 0, "no path", "vq_gemv_vec4",
                       device)
              for b, v in vq.SUPPORTED if v == 4 and (b, v) != VQ4
              for name, m, k in SHAPES_8B[1::2]]
    spec, params = path_f_model(device)
    return vq, vq.SOURCE, vq.SIGNATURES, cases, ("Path F", spec, params)


AB = {"tcq2_gemv": _ab_sum2, "tcq2mix": _ab_tcq2mix, "tcq1_gemv": _ab_tcq1,
      "tcq_lut": _ab_lut, "vq": _ab_vq, "vq4": _ab_vq4, "tcq2_wide": None,
      "tcq2mix_wide": None, "tcq1_wide": None, "dequant": None}
# ab_wide's mode
WIDE_AB = {"tcq2_wide": "sum2", "tcq2mix_wide": "dualmad", "tcq1_wide": "1mad"}


class _NoWorkspace:
    """A K1 library (tcq2_gemv or tcq1_gemv) built from a tree whose C
    function takes no workspace (before its wide kernel): the wrappers'
    call, the workspace argument dropped."""

    def __init__(self, lib, fn):
        def call(x, x_bf16, tr, out, ws, *rest):
            return getattr(lib, fn)(x, x_bf16, tr, out, *rest)

        setattr(self, fn, call)


def _bind_parent(kb, source, parent_csrc, parent_so, sigs):
    """The parent's library behind the wrappers' C interface."""
    from pathlib import Path

    text = (Path(parent_csrc) / f"{source}.cu").read_text()
    if source in ("tcq2_gemv", "tcq1_gemv") and "void* ws" not in text:
        old = list(sigs[source])
        del old[4]
        return _NoWorkspace(kb.bind(parent_so, {source: old}), source)
    return kb.bind(parent_so, sigs)


def ab_wide(parent_csrc, mode):
    """--ab tcq2_wide (mode sum2), --ab tcq2mix_wide (dualmad) and --ab
    tcq1_wide (1mad): K1 above 8 rows against an older csrc's, in turns
    parent, new, new, parent, on one card.  Each shape's call at N = 16 /
    64 / 256 as a zero-shot forward makes it (CUDA-graph replays, weights
    cycled past L2), summed over a forward's calls: sum2 at the 215 shapes
    (129 calls, layers exact, the 4-bit head a8), dualmad at Path A's qkv
    and ug, 1mad at Path A's o and down (64 calls, exact and a8 each;
    with 1mad, 2mad at 4096x4096 KV 3 and 4, summed as 64 calls of KV 3);
    then, on the 215 model (sum2) or the Path A model, the zero-shot run
    at exact (examples/s), a warm a8 512-token prefill (ms) and the a8
    decode (tokens/s through generate()); on Path A also its 16-token
    prefills at a8 and exact (the median of the last 3 of 4) and the 215
    decode,
    whose kernels did not change.  Each turn's SM clock is sampled.  Both
    libraries are first held against the plain version at N = 49."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from qpalette_tpu_torch.kernels import _build as kb
    from qpalette_tpu_torch.kernels import arith
    from qpalette_tpu_torch.runtime import zeroshot

    _, _, smi = card()
    device = torch.device("cuda:0")
    source = "tcq2_gemv" if arith.ARITH_V[mode] == 2 else "tcq1_gemv"
    sigs = arith.SIGNATURES[source]
    parent_so = kb.BUILD / f"lib{source}_parent.so"
    with ThreadPoolExecutor(2) as ex:
        builds = [ex.submit(kb.build, source),
                  ex.submit(kb.compile_cu, Path(parent_csrc) / f"{source}.cu",
                            parent_so)]
        for label, b in zip(("new", "parent"), builds):
            entries = ptxas_entries(b.result())
            print(f"[ab] {label} {source}.cu: {len(entries)} kernels, "
                  f"{sum(bool(SPILL.search(e[2])) for e in entries)} with "
                  f"spills", flush=True)
    libs = {"parent": _bind_parent(kb, source, parent_csrc, parent_so, sigs),
            "new": kb.bind(kb.lib_path(source), sigs)}
    lib_of = arith._lib

    def use(lib):
        arith._lib = lambda *a: lib if a[0] == source else lib_of(*a)

    qdict, merge_info = _load_215()
    spec215, params215 = _build("main", qdict, merge_info, "a8", 4, device)
    if mode == "sum2":
        ug_kv = [int(qdict[f"{i}_mlp.up_proj"][0].split("_")[1])
                 for i in range(32)]
        # (name, m, k, mode, KV, calls a forward, variants timed: a8 or not)
        shapes = [(name, m, k, mode, KV, sum(kv == KV for kv in ug_kv)
                   if name == "ug" else CALLS_PER_STEP[name],
                   (name == "lm_head",)) for name, m, k, KV in SHAPES_215]
        path, spec, params = "215", spec215, params215
    else:
        modes = ("1mad", "2mad") if mode == "1mad" else (mode,)
        shapes = [(name, m, k, md, KV, calls, (False, True))
                  for name, m, k, md, KV, calls in SHAPES_ARITH
                  if md in modes and name != "odd_kt"]
        path = "Path A"
        spec, params = _build("pathA", tcq2mix_qdict(),
                              [["merge_qkv", "merge_ug"]] * 32, "a8", 4,
                              device)
    exact = with_impl(spec, "exact")
    tok, questions = ByteTok(), zs_questions()
    copies = {sh[:5]: _copies(sh[1], sh[2], arith.words_per_tile(sh[3],
                                                                 sh[4]),
                              device)
              for sh in shapes}
    for label, lib in libs.items():
        use(lib)
        for md in dict.fromkeys(sh[3] for sh in shapes):  # its first shape
            name, m, k, _, KV = next(sh for sh in shapes if sh[3] == md)[:5]
            x = torch.randn((49, k), device=device).bfloat16()
            w = copies[(name, m, k, md, KV)][0][0]
            for a8 in (False, True):
                _rel_check(f"{label} {md} {name} N=49 a8={a8}",
                           arith.decode_gemv(md, x, w, KV, m, k, a8),
                           arith.arith_gemv_plain(x, w, md, KV, m, k, a8),
                           TOL[a8])
    turns = []
    for label in ("parent", "new", "new", "parent"):
        use(libs[label])
        turn = {"lib": label}
        with SmClock() as clock:
            for N in ZS_ROWS:
                fwd = {}
                for name, m, k, md, KV, calls, variants in shapes:
                    cp, nbytes = copies[(name, m, k, md, KV)]
                    x = torch.randn((N, k), device=device).bfloat16()
                    out = torch.empty((N, m), device=device)
                    for a8 in variants:
                        ms = _time_ms(lambda i=0: arith.decode_gemv(
                            md, x, cp[i % len(cp)], KV, m, k, a8,
                            out=out), 20, graph=True)
                        bms, _ = gemv_bound(
                            nbytes, N, m, k, 2, a8,
                            "bfloat16" if md == "sum2" else "tfloat32")
                        key = ("_2mad" if md != mode else "") + (
                            "" if len(variants) == 1 else
                            "_a8" if a8 else "_exact")
                        # 2mad (on no path): 64 calls of KV 3
                        n = calls or (64 if KV == 3 else 0)
                        t = fwd.setdefault(key, [0.0, 0.0])
                        t[0] += n * ms
                        t[1] += n * bms
                        print(f"[ab] {label} {md} {name} {m}x{k} KV={KV} "
                              f"N={N} {'a8' if a8 else 'exact'}: {ms:.4f} "
                              f"ms (bound {bms:.4f})", flush=True)
                for key, (kms, bms) in fwd.items():
                    turn[f"forward_ms_N{N}{key}"] = kms
                    turn[f"bound_ms_N{N}{key}"] = bms
        turn["sm_mhz"] = clock.mhz
        zeroshot.eval_multiple_choice(exact, params, tok, questions)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zeroshot.eval_multiple_choice(exact, params, tok, questions)
        torch.cuda.synchronize()
        turn["zs_examples_s"] = ZS_QUESTIONS / (time.perf_counter() - t0)
        turn["a8_prefill_512_ms"] = 1e3 * prefill_time(
            f"ab {label} a8", spec, params, device, PREFILL_B, smi)
        if mode != "sum2":  # Path A's 16-token prefills: the median of 3
            for impl in ("a8", "exact"):
                sp = with_impl(spec, impl)
                ms = [1e3 * prefill_time(f"ab {label} {impl}", sp, params,
                                         device, PROMPT_LEN, smi)
                      for _ in range(4)][1:]  # the first warms up
                turn[f"prefill_{PROMPT_LEN}_{impl}_ms"] = sorted(ms)[1]
        turn["tokens_per_s"] = throughput(f"{path}, {label} {source}.cu",
                                          spec, params, device, smi)
        if mode != "sum2":
            turn["tokens_per_s_215"] = throughput(
                f"215, {label} {source}.cu", spec215, params215, device, smi)
        turns.append(turn)
        calls = sum(sh[5] for sh in shapes if sh[3] == mode)
        print(f"[ab] {label}: a {path} forward's {calls} {mode} calls "
              + ", ".join(f"{k[len('forward_ms_'):]} {v:.3f} ms"
                          for k, v in turn.items()
                          if k.startswith("forward_ms_"))
              + f" at {clock}; zero-shot {turn['zs_examples_s']:.2f} "
              f"examples/s; a8 512-token prefill "
              f"{turn['a8_prefill_512_ms']:.1f} ms; "
              + "".join(f"{k} {v:.2f} ms; " for k, v in turn.items()
                        if k.startswith(f"prefill_{PROMPT_LEN}_"))
              + f"{path} decode "
              f"{turn['tokens_per_s']:.2f} tokens/s"
              + (f", 215 decode {turn['tokens_per_s_215']:.2f} tokens/s"
                 if mode != "sum2" else "") + f" ({smi})", flush=True)
    arith._lib = lib_of
    print(json.dumps({"card": smi, "source": source, "ab": f"{mode} wide",
                      "turns": turns}))


def _dq_path_cases():
    """{path: [(wrapper, mode, KVs, m, k, calls)]}: K3 and K2 over the
    tcq2mix 512-token exact prefill's calls (Path B), K2 over the 215's
    (its ug KVs as the 215 qdict mixes them), K7 and K6 over the flagship
    16-token prefill's."""
    from qpalette_tpu_torch.models.llama import LlamaConfig

    mix = [("tcq2_dequant" if mode in ("sum2", "dualmad") else
            "tcq1_dequant", mode, (KV,), m, k, calls)
           for _, m, k, mode, KV, calls in SHAPES_ARITH if calls]
    qdict_215, _ = _load_215()
    ug = [int(qdict_215[f"{i}_mlp.up_proj"][0].split("_")[1])
          for i in range(32)]
    p215 = [("tcq2_dequant", "sum2", (KV,), m, k,
             ug.count(KV) if name == "ug" else CALLS_PER_STEP[name])
            for name, m, k, KV in SHAPES_215 if name != "lm_head"]
    with open(FLAGSHIP_QDICT) as f:
        qdict = json.load(f)
    flag = [("tcomb_lut_dequant" if len(KV) == 2 else "tcq_lut_dequant",
             None, KV, m, k, calls)
            for (m, k, KV), calls in sorted(flagship_shapes(
                LlamaConfig.llama31_8b(), qdict).items())]
    return {"tcq2mix prefill": mix, "215 prefill": p215,
            "flagship prefill": flag}


def replay_paces(label, spec, params, card_label, windows=2):
    """ms of each replay of a freshly captured decode step (CUDA events
    around every replay), windows of NEW_TOKENS replays from PROMPT_LEN:
    the captured step replays at one of two paces (PERF.md, section 7), so
    the times are split at their widest gap and each pace is reported with
    its count.  Returns the sorted times."""
    from qpalette_tpu_torch.runtime import decode

    V = spec.config.vocab_size
    T = PROMPT_LEN + NEW_TOKENS + 1
    step = decode.captured_step(spec, params, 1, T, 0.6, 5)
    prompt = np.random.default_rng(0).integers(0, V, (1, PROMPT_LEN))
    logits, _ = decode.prefill(spec, params,
                               torch.as_tensor(prompt, device="cuda"),
                               step.caches)
    tok = decode.sample_logits(logits[:, -1], step.generator, 0.6, 5)[:, None]
    ms = []
    for _ in range(windows):
        step.reset(tok, PROMPT_LEN)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(NEW_TOKENS + 1)]
        ev[0].record()
        for i in range(NEW_TOKENS):
            step.replay()
            ev[i + 1].record()
        torch.cuda.synchronize()
        ms += [ev[i].elapsed_time(ev[i + 1]) for i in range(NEW_TOKENS)]
    decode.release_captured(params)
    ms.sort()
    cut = max(range(1, len(ms)), key=lambda i: ms[i] - ms[i - 1])
    paces = [(float(np.median(part)), len(part))
             for part in (ms[:cut], ms[cut:])]
    print(f"[{label}] {len(ms)} replays, ms each (CUDA events): min "
          f"{ms[0]:.3f}, median {np.median(ms):.3f}, max {ms[-1]:.3f}; "
          f"split at the widest gap ({ms[cut - 1]:.3f} | {ms[cut]:.3f}): "
          + ", ".join(f"{c} at median {m:.3f}" for m, c in paces)
          + f"; card {card_label}", flush=True)
    return ms


def dequant_turns(trees, order, paths=True, unchecked=()):
    """arith_dequant.cu (K2, K3) and tcq_lut.cu (K6, K7) of several trees
    on one card, in turns: trees maps a label to a csrc directory (None:
    the checkout's own sources), order the labels' turns.  Every build is
    first held bit-equal to the plain versions, two launches each, at each
    instance and shape timed and the DQ_RAGGED (but the labels in
    `unchecked`: sources that drop work on purpose).  A turn times each
    DQ_CASES instance (CUDA-graph replays, words cycled past L2) and, with
    `paths`, K3 and K2 summed over the tcq2mix 512-token prefill's calls,
    K2 over the 215's, K7 and K6 over the flagship prefill's, the Path B
    512-token exact prefill (tcq2mix), the Path E decode tokens/s and its
    captured step's replay paces; the SM clock a turn."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from qpalette_tpu_torch.kernels import _build as kb
    from qpalette_tpu_torch.kernels import arith_dequant, tcq_lut

    _, _, smi = card()
    device = torch.device("cuda:0")
    mods = {"arith_dequant": arith_dequant, "tcq_lut": tcq_lut}

    def so(i, label, src):
        return (kb.lib_path(src) if trees[label] is None
                else kb.BUILD / f"lib{src}_tree{i}.so")

    with ThreadPoolExecutor(2 * len(trees)) as ex:
        builds = {(label, src): (
            ex.submit(kb.build, src) if d is None else
            ex.submit(kb.compile_cu, Path(d) / f"{src}.cu",
                      so(i, label, src)))
            for i, (label, d) in enumerate(trees.items()) for src in mods}
        for (label, src), b in builds.items():
            entries = ptxas_entries(b.result())
            print(f"[dq] {label} {src}.cu: {len(entries)} kernels, "
                  f"{sum(bool(SPILL.search(e[2])) for e in entries)} with "
                  f"spills; " + "; ".join(
                      f"{e[0]}: {e[1]}" for e in entries
                      if PORT_DEQUANT.search(e[0])
                      or "dequant" in e[0] or "ring" in e[0]), flush=True)
    libs = {label: {src: kb.bind(so(i, label, src), m.SIGNATURES)
                    for src, m in mods.items()}
            for i, label in enumerate(trees)}
    lib_of = {s: m._lib for s, m in mods.items()}

    def use(label):
        for s, m in mods.items():
            m._lib = lambda lib=libs[label][s]: lib

    dq_paths = _dq_path_cases() if paths else {}
    shapes = ([(w, mode, KV, m, k) for _, w, mode, KV, _, _ in DQ_CASES
               for m, k in dq_shapes(KV)]
              + sorted({c[:5] for cases in dq_paths.values()
                        for c in cases}))
    try:
        for label in trees:
            if label in unchecked:
                continue
            use(label)
            for wrapper, mode, KV, m, k in shapes:
                run, plain, _ = dq_case(wrapper, mode, KV, m, k, device)
                ref = plain()
                same = all(torch.equal(run(0).view(torch.int16),
                                       ref.view(torch.int16))
                           for _ in range(2))
                print(f"[dq] {label} {wrapper} {mode or ''} KV={KV} "
                      f"{m}x{k}: two launches bit-equal to plain={same}",
                      flush=True)
                check(same, f"{label} {wrapper} KV={KV} {m}x{k}: not "
                      f"bit-equal")
                del ref
        timed = {lab: (dq_case(w, mode, KV, m, k, device, cycled=True),
                       (m, k), None) for lab, w, mode, KV, m, k in DQ_CASES}
        for path, cases in dq_paths.items():
            for w, mode, KV, m, k, calls in cases:
                lab = f"{path} {w} KV={'/'.join(map(str, KV))} {m}x{k}"
                timed[lab] = (dq_case(w, mode, KV, m, k, device,
                                      cycled=True), (m, k), (path, w, calls))
        if paths:
            spec_b, params_b = _build(
                "pathB tcq2mix", tcq2mix_qdict(),
                [["merge_qkv", "merge_ug"]] * 32, "exact", 4, device)
            qdict_e, merge_e = path_e_qdict()
            spec_e, params_e = _build("pathE", qdict_e, merge_e, "a8", 4,
                                      device)
        turns = []
        for label in order:
            use(label)
            us, paths_ms, bounds = {}, {}, {}
            with SmClock() as clock:
                for lab, ((run, _, bound), shape, on) in timed.items():
                    out = torch.empty(shape, dtype=torch.bfloat16,
                                      device=device)
                    t = _time_ms(lambda i=0: run(i, out), 50, graph=True)
                    us[lab] = t * 1e3
                    if on is not None:
                        key = f"{on[1]} {on[0]}"
                        paths_ms[key] = paths_ms.get(key, 0.0) + on[2] * t
                        bounds[key] = bounds.get(key, 0.0) + on[2] * bound
                    print(f"[dq] {label} {lab}: {t * 1e3:.2f} us a call, "
                          f"bound {bound * 1e3:.2f} us ({bound / t:.1%})",
                          flush=True)
                    del out
            turn = {"lib": label, "sm_mhz": clock.mhz, "us": us}
            if paths:
                prefill = min(prefill_time(f"pathB tcq2mix, {label}",
                                           spec_b, params_b, device,
                                           PREFILL_B, smi)
                              for _ in range(2))
                tps = throughput(f"pathE, {label}", spec_e, params_e,
                                 device, smi)
                paces = replay_paces(f"pathE, {label}", spec_e, params_e,
                                     smi)
                turn.update(path_ms=paths_ms,
                            pathB_prefill_ms=prefill * 1e3,
                            pathE_tokens_per_s=tps,
                            pathE_replay_ms=paces)
                print(f"[dq] {label}: " + ", ".join(
                    f"{k} {v:.4f} ms ({bounds[k] / v:.1%} of "
                    f"{bounds[k]:.4f})" for k, v in paths_ms.items())
                    + f"; Path B 512-token prefill {prefill * 1e3:.1f} ms;"
                    f" Path E {tps:.2f} tokens/s, replays' median "
                    f"{np.median(paces):.3f} ms", flush=True)
            print(f"[dq] {label}: " + ", ".join(
                f"{lab} {v:.2f}us" for lab, v in us.items())
                + f" ({smi}, {clock})", flush=True)
            turns.append(turn)
    finally:
        for s, m in mods.items():
            m._lib = lib_of[s]
    print(json.dumps({"card": smi, "sources": sorted(mods),
                      "bound_ms": bounds, "turns": turns}))


def ab_dequant(parent_csrc):
    """--ab dequant: dequant_turns of the checkout's sources against an
    older tree's, in turns parent, new, new, parent, with the paths."""
    return dequant_turns({"parent": parent_csrc, "new": None},
                         ("parent", "new", "new", "parent"))


def parent_ab(parent_csrc, which):
    """One CUDA source of the port against the same source of an older
    tree (parent_csrc: that tree's qpalette_tpu_torch/csrc, e.g. unpacked
    from `git archive`, so that the source builds with its own headers),
    on one card, in turns: parent, new, new, parent.  which: "tcq2_gemv"
    (K1 sum2 on the 215 path), "tcq2_wide" (ab_wide: K1 sum2 above 8
    rows), "tcq2mix" (K1 dualmad on Path A, with K1
    sum2 at the 215 shapes), "tcq1_gemv" (K1 1mad on Path A, with 2mad at
    4096x4096), "tcq_lut" (K4/K5 on the flagship), "vq" (K8 on Paths C
    and D, every other ldlq scheme at o and down) or "vq4" (K8 at vec 4 on
    Path F's o and down, the other vec-4 bits beside them).  Both
    libraries are first checked against the plain versions at N = 1 and 8.
    Each turn puts its library behind the wrappers, times every shape's
    calls (CUDA-graph replays at N=1, weights cycled past L2), sums each
    kernel's over a decode step of its path, and then runs the path's
    64-token decode through generate() (tokens/s)."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from qpalette_tpu_torch.kernels import _build as kb

    if which in WIDE_AB:
        return ab_wide(parent_csrc, WIDE_AB[which])
    if which == "dequant":
        return ab_dequant(parent_csrc)
    _, _, smi = card()
    device = torch.device("cuda:0")
    mod, source, sigs, cases, (path, spec, params) = AB[which](device, smi)
    parent_so = kb.BUILD / f"lib{source}_parent.so"
    with ThreadPoolExecutor(2) as ex:
        builds = [ex.submit(kb.build, source),
                  ex.submit(kb.compile_cu, Path(parent_csrc) / f"{source}.cu",
                            parent_so)]
        for label, b in zip(("new", "parent"), builds):
            entries = ptxas_entries(b.result())
            print(f"[ab] {label} {source}.cu: {len(entries)} kernels, "
                  f"{sum(bool(SPILL.search(e[2])) for e in entries)} with "
                  f"spills", flush=True)
    libs = {"parent": _bind_parent(kb, source, parent_csrc, parent_so, sigs),
            "new": kb.bind(kb.lib_path(source), sigs)}
    lib_of = mod._lib

    def use(lib):  # arith's loader serves both K1 sources on Path A
        mod._lib = lambda *a: lib if not a or a[0] == source else lib_of(*a)

    for label, lib in libs.items():
        use(lib)
        for case in cases:
            for N in (1, 8):
                x = torch.randn((N, case["k"]), device=device).to(
                    case["x_dtype"])
                w = case["copies"][0]
                _rel_check(f"{label} {case['label']} N={N}",
                           case["run"](x, w), case["plain"](x, w),
                           case["tol"])
    turns = []
    for label in ("parent", "new", "new", "parent"):
        use(libs[label])
        ms, step = {}, {}
        with SmClock() as clock:
            for case in cases:
                x = torch.randn((1, case["k"]), device=device).to(
                    case["x_dtype"])
                out = torch.empty((1, case["m"]), device=device)
                copies = case["copies"]
                t = _time_ms(lambda i=0: case["run"](
                    x, copies[i % len(copies)], out), 200, graph=True)
                if case["calls"]:
                    ms[case["kernel"]] = (ms.get(case["kernel"], 0.0)
                                          + case["calls"] * t)
                    step[case["kernel"]] = case["step"]
                print(f"[ab] {label} {case['label']}: {t * 1e3:.3f} us a "
                      f"call (bound {case['bound'] * 1e3:.3f} us, "
                      f"{case['calls']} a {case['step']} step)", flush=True)
        tps = throughput(f"{path}, {label} {source}.cu", spec, params, device,
                         smi)
        turns.append({"lib": label, "tokens_per_s": tps, "sm_mhz": clock.mhz,
                      **{f"{n}_ms_a_step": v for n, v in ms.items()}})
        print(f"[ab] {label}: " + ", ".join(
            f"{n} {v:.4f} ms a {step[n]} decode step" for n, v in ms.items())
            + f"; {path} {tps:.2f} tokens/s ({smi}, {clock})", flush=True)
    mod._lib = lib_of
    bound = {}
    for case in cases:
        if case["calls"]:
            bound[case["kernel"]] = (bound.get(case["kernel"], 0.0)
                                     + case["calls"] * case["bound"])
    print(json.dumps({"card": smi, "source": source, "path": path,
                      "bound_ms_a_step": bound, "turns": turns}))


def flagship_path(device, card_label):
    """The 8B model from the 3.25-bit solver output: 194 tcq + 30 tcomb
    dequants in the prefill, 194 + 30 GEMVs in each decode forward; then
    the same model through ctx-8192 perplexity at impl dequant (ppl_check).
    Returns the launch counts of both, graph_phase's result and
    ppl_check's summary."""
    with open(FLAGSHIP_QDICT) as f:
        qdict = json.load(f)
    spec, params = _build("flagship", qdict, None, "exact", 16, device)
    want = {"tcq_lut_gemv": FLAGSHIP_TCQ, "tcomb_lut_gemv": FLAGSHIP_TCOMB}
    launches = drive(
        "flagship", spec, params, device, PROMPT_LEN, COUNTED_TOKENS,
        {"tcq_lut_dequant": FLAGSHIP_TCQ, "tcomb_lut_dequant": FLAGSHIP_TCOMB},
        want)
    graph = graph_phase("flagship", spec, params, device, want, card_label)
    ppl_counts, ppl = ppl_check(spec, params, device, card_label)
    for k, v in ppl_counts.items():
        launches[k] += v
    del params
    torch.cuda.empty_cache()
    return launches, graph, ppl


def _vq_words(m, k, bits, vec, device, seed):
    from qpalette_tpu_torch.kernels.vq import row_words
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (m, row_words(k, bits, vec)),
                         generator=gen, dtype=torch.int32, device=device)


def _vq_lut(bits, vec, device):
    """The committed codebook, or at vec 4 (none is committed) a seeded
    stand-in: the kernels' numbers do not depend on the values."""
    from qpalette_tpu_torch.ops.codebooks import vq_lut

    if vec < 4:
        return torch.tensor(vq_lut(bits, vec), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(400 + bits)
    return torch.randn((1 << bits, vec), generator=gen, device=device)


def vq_kernel_checks(vq, device):
    """K8 / K9 against their plain versions: ldlq_2_6 at the four 8B
    shapes, every other ldlq (bits, vec) at o and down (vec 4 at N = 1
    and 8).  Returns ({kernel: max_abs_err}, {kernel: [ms, plain ms, bound
    ms summed over a Path C decode forward's K8 calls (N=1) or its
    prefill's K9 calls]}, {(bits, vec, name): (K8 ms, K9 ms)} at every
    shape); the vec-4 kernels as vq_gemv_vec4 / vq_dequant_vec4, summed
    over a 32-layer Path F forward's VQ4 calls (32 o + 32 down)."""
    names = [f.__name__ for f in vq.KERNELS]
    names += [n + "_vec4" for n in names]
    err = {n: 0.0 for n in names}
    times = {n: [0.0, 0.0, 0.0] for n in names}
    per_scheme = {}
    cases = [(6, 2, name, m, k, 32) for name, m, k in SHAPES_8B] + [
        (b, v, name, m, k, 32 if (b, v) == VQ4 else 0)
        for b, v in vq.SUPPORTED if (b, v) != (6, 2)
        for name, m, k in SHAPES_8B[1::2]]
    for bits, vec, name, m, k, calls in cases:
        sfx = "_vec4" if vec == 4 else ""
        lut = _vq_lut(bits, vec, device)
        words = _vq_words(m, k, bits, vec, device, seed=m + k + bits)
        label = f"vq bits={bits} vec={vec} {name} {m}x{k}"
        for N in (range(1, 9) if vec < 4 else (1, 8)):
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).bfloat16()
            y = vq.vq_gemv(x, words, lut, bits, vec, m, k)
            torch.cuda.synchronize()
            ref = vq.vq_gemv_plain(x, words, lut, bits, vec, m, k)
            err["vq_gemv" + sfx] = max(err["vq_gemv" + sfx], _rel_check(
                f"vq_gemv {label} N={N}", y, ref, VQ_TOL))
            if N == 8:  # the warps' fragments add in a fixed order
                y2 = vq.vq_gemv(x, words, lut, bits, vec, m, k)
                same = torch.equal(y.view(torch.int32), y2.view(torch.int32))
                print(f"[kernel] vq_gemv {label} N=8: two launches "
                      f"bit-equal={same}", flush=True)
                check(same, f"vq_gemv {label}: two launches differ")
        if name == "o":  # m = 4100: the last m-tile has 4 rows
            rw = _vq_words(4100, k, bits, vec, device, seed=k + bits)
            x = torch.randn((8, k), device=device).bfloat16()
            err["vq_gemv" + sfx] = max(err["vq_gemv" + sfx], _rel_check(
                f"vq_gemv vq bits={bits} vec={vec} 4100x{k} N=8",
                vq.vq_gemv(x, rw, lut, bits, vec, 4100, k),
                vq.vq_gemv_plain(x, rw, lut, bits, vec, 4100, k), VQ_TOL))
            del rw
        w = vq.vq_dequant(words, lut, bits, vec, m, k)
        torch.cuda.synchronize()
        w_ref = vq.vq_dequant_plain(words, lut, bits, vec, m, k)
        same = torch.equal(w.view(torch.int16), w_ref.view(torch.int16))
        print(f"[kernel] vq_dequant {label}: bit-equal={same}", flush=True)
        check(same, f"vq_dequant {label}: not bit-equal")
        del w, w_ref, words

        nbytes = m * vq.row_words(k, bits, vec) * 4 + lut.numel() * 4
        copies = [_vq_words(m, k, bits, vec, device, seed=100 + i)
                  for i in range(min(64, -(-3 * L2_BYTES // nbytes)))]
        x1 = torch.randn((1, k), device=device).bfloat16()
        out = torch.empty((1, m), device=device)
        wout = torch.empty((m, k), dtype=torch.bfloat16, device=device)

        def kern(i=0):
            vq.vq_gemv(x1, copies[i % len(copies)], lut, bits, vec, m, k,
                       out=out)

        def kern_deq(i=0):
            vq.vq_dequant(copies[i % len(copies)], lut, bits, vec, m, k,
                          out=wout)

        def plain(i=0):
            vq.vq_gemv_plain(x1, copies[i % len(copies)], lut, bits, vec, m,
                             k)

        def plain_deq(i=0):
            vq.vq_dequant_plain(copies[i % len(copies)], lut, bits, vec, m,
                                k)

        ms = _time_ms(kern, 200, graph=True)
        dms = _time_ms(kern_deq, 50, graph=True)
        per_scheme[bits, vec, name] = (ms, dms)
        gb, gby = gemv_bound(nbytes, 1, m, k, 2, False)
        db, dby = dequant_bound(nbytes, m, k)
        print(f"[time] {label}: vq_gemv N=1 {ms:.4f} ms "
              f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of row-pack, bound "
              f"{gb:.4f} ms), vq_dequant {dms:.4f} ms (bound {db:.4f} ms)",
              flush=True)
        if calls:
            pms, pdms = _time_ms(plain, 5), _time_ms(plain_deq, 5)
            print(f"[time] {label}: plain vq_gemv {pms:.4f} ms, plain "
                  f"vq_dequant {pdms:.4f} ms", flush=True)
            for kname, trio, by in (("vq_gemv", (ms, pms, gb), gby),
                                    ("vq_dequant", (dms, pdms, db), dby)):
                for j, v in enumerate(trio):
                    times[kname + sfx][j] += calls * v
                if by == "operations":
                    BOUND_BY[kname + sfx] = by
        del copies, wout
    return err, times, per_scheme


def int8_head_checks(ig, device):
    """K10 (bit-equal) and K11 (within 1e-5) against their plain versions
    at the 8B head, N in {1, 8}; times at N=1 beside the plain versions,
    the bound and torch._int_mm on K10's int8 operands (x padded to the 32
    rows it takes).  Returns ({kernel: max_abs_err}, {kernel: [ms, plain
    ms, bound ms]}, {kernel: library ms or None})."""
    m, k = HEAD
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    wq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8,
                       device=device)
    scales = torch.rand(m, generator=gen, device=device) * 1e-3
    err, times = {}, {}
    pairs = ((ig.int8_gemv_a8, ig.int8_gemv_a8_plain, "int8"),
             (ig.int8_gemv, ig.int8_gemv_plain, "float32"))
    for N in (1, 8):
        x = torch.randn((N, k), generator=gen, device=device).bfloat16()
        for fn, plain, _ in pairs:
            y = fn(x, wq, scales)
            torch.cuda.synchronize()
            ref = plain(x, wq, scales)
            e = (y - ref).abs().max().item()
            err[fn.__name__] = max(err.get(fn.__name__, 0.0), e)
            if fn is ig.int8_gemv_a8:
                same = torch.equal(y, ref)
                print(f"[kernel] int8_gemv_a8 {m}x{k} N={N}: bit-equal="
                      f"{same}", flush=True)
                check(same, f"int8_gemv_a8 N={N}: not bit-equal ({e})")
            else:
                _rel_check(f"int8_gemv {m}x{k} N={N}", y, ref, I8_TOL)
    x1 = torch.randn((1, k), generator=gen, device=device).bfloat16()
    out = torch.empty((1, m), device=device)
    nbytes = m * k + m * 4  # weights and scales; the head is 528 MB > L2
    for fn, plain, kind in pairs:
        ms = _time_ms(lambda i=0: fn(x1, wq, scales, out=out), 50,
                      graph=True)
        pms = _time_ms(lambda i=0: plain(x1, wq, scales), 3)
        bms, by = bound_ms(nbytes + 2 * k + 4 * m, 2 * m * k, kind)
        BOUND_BY[fn.__name__] = by
        times[fn.__name__] = [ms, pms, bms]
        print(f"[time] {fn.__name__} {m}x{k} N=1: kernel {ms:.4f} ms "
              f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of weights), plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    xq = torch.zeros((32, k), dtype=torch.int8, device=device)
    xq[0] = torch.randint(-127, 128, (k,), generator=gen, dtype=torch.int8,
                          device=device)
    acc = torch._int_mm(xq, wq.t())
    check(torch.equal(acc[0].double(), wq.double() @ xq[0].double()),
          "torch._int_mm disagrees with the exact integer dot")
    lib = _time_ms(lambda i=0: torch._int_mm(xq, wq.t()), 50)
    print(f"[time] torch._int_mm (32x{k}) x ({k}x{m}) int8 -> int32: "
          f"{lib:.4f} ms (K10's yardstick; the port never calls it)",
          flush=True)
    return err, times, {"int8_gemv_a8": lib, "int8_gemv": None}


def path_c(device, card_label):
    """Path C: the 8B ldlq_2_6 model, merged qkv / ug, the rotated int8
    head, impl a8; 128 K9 in the 16-token prefill, 128 K8 + 1 K10 each
    decode forward.  Returns (launch counts, graph_phase's result)."""
    spec, params = _build("pathC", PATH_C_QSTR, [["merge_qkv", "merge_ug"]]
                          * 32, "a8", 8, device)
    kinds = {(ls.kind, ls.bits, ls.vec) for a, m in spec.layers
             for _, ls in a.projs + m.projs}
    check(kinds == {("vq", 6, 2)} and spec.lm_head_spec is None
          and tuple(params["lm_head_q"].shape) == HEAD
          and "lm_head_su" in params, f"pathC model {kinds}")
    launches = drive("pathC", spec, params, device, PROMPT_LEN,
                     COUNTED_TOKENS, PATH_C_PREFILL, PATH_C_STEP)
    graph = graph_phase("pathC", spec, params, device, PATH_C_STEP,
                        card_label)
    del params
    torch.cuda.empty_cache()
    return launches, graph


def unrotated_int8_head(w):
    """The per-row int8 head without the rotation (the reference's forward
    branch for an int8 head with no lm_head_su): s = max|W|/127 + 1e-12 a
    row, q = round(W / s), the vocab padded to 2048s with scale 1."""
    V, h = w.shape
    VP = -(-V // 2048) * 2048
    q = torch.zeros((VP, h), dtype=torch.int8, device=w.device)
    s = torch.ones(VP, dtype=torch.float32, device=w.device)
    for r0 in range(0, V, 8192):
        wf = w[r0:r0 + 8192].float()
        sr = wf.abs().amax(dim=1) / 127.0 + 1e-12
        q[r0:r0 + wf.shape[0]] = torch.round(wf / sr[:, None]).to(torch.int8)
        s[r0:r0 + wf.shape[0]] = sr
    return q, s


def path_d(device, card_label):
    """Path D: 8 layers of ldlq_1_4 (vec 1), unmerged, with the unrotated
    int8 head; 56 K9 in the prefill, 56 K8 + 1 K11 each decode forward."""
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    t0 = time.perf_counter()
    spec, params = build_quantized_model(
        LlamaConfig.llama31_8b(), PATH_D_QSTR, dummy=True, impl="a8",
        num_layers=PATH_D_LAYERS, lm_head_bits=16, seed=0, device=device,
        dense_params=dummy_dense(PATH_D_LAYERS))
    params["lm_head_q"], params["lm_head_s"] = unrotated_int8_head(
        params.pop("lm_head"))
    torch.cuda.synchronize()
    print(f"[pathD] 8B ({PATH_D_LAYERS} layers) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = drive("pathD", spec, params, device, PROMPT_LEN,
                     COUNTED_TOKENS, PATH_D_PREFILL, PATH_D_STEP)
    graph = graph_phase("pathD", spec, params, device, PATH_D_STEP,
                        card_label)
    del params
    torch.cuda.empty_cache()
    return launches, graph


def path_f_model(device):
    """Path F's PATH_F_LAYERS-layer 8B model: (spec, params)."""
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime.loader import (LAYER_KEYS,
                                                   build_quantized_model)

    qdict = {f"{i}_{key}": (VQ4_QSTR if key in ("self_attn.o_proj",
                                                "mlp.down_proj")
                            else VQ2_QSTR)
             for i in range(PATH_F_LAYERS) for key in LAYER_KEYS}
    t0 = time.perf_counter()
    spec, params = build_quantized_model(
        LlamaConfig.llama31_8b(), qdict,
        merge_info=[["merge_qkv", "merge_ug"]] * PATH_F_LAYERS, dummy=True,
        impl="a8", num_layers=PATH_F_LAYERS, lm_head_bits=8, seed=0,
        device=device, dense_params=dummy_dense(PATH_F_LAYERS))
    torch.cuda.synchronize()
    kinds = sorted({(ls.bits, ls.vec) for a, m in spec.layers
                    for _, ls in a.projs + m.projs})
    check(kinds == [(6, 2), VQ4], f"pathF model {kinds}")
    print(f"[pathF] 8B ({PATH_F_LAYERS} layers, o / down {VQ4_QSTR}) built "
          f"in {time.perf_counter() - t0:.1f} s (its vec-4 codebook made "
          f"or read under {os.environ.get('QPALETTE_ASSETS')})", flush=True)
    return spec, params


def path_f(device, card_label):
    """Path F: PATH_F_LAYERS layers of the 8B, ldlq_2_6 merged qkv / ug and
    ldlq_4_8 o / down (K8 / K9 at vec 4), the rotated int8 head, impl a8;
    counted (the vec-4 launches apart, vq_gemv.by_vec) and through the
    captured step.  Returns (launch counts, graph_phase's result, the
    vec-4 launches of the counted run)."""
    from qpalette_tpu_torch.kernels import vq

    spec, params = path_f_model(device)
    launches = drive("pathF", spec, params, device, PROMPT_LEN,
                     COUNTED_TOKENS, PATH_F_PREFILL, PATH_F_STEP)
    vec4 = {"vq_gemv": vq.vq_gemv.by_vec[4],
            "vq_dequant": vq.vq_dequant.by_vec[4]}
    check(vec4 == {"vq_gemv": PATH_F_VEC4 * COUNTED_TOKENS,
                   "vq_dequant": PATH_F_VEC4},
          f"pathF: vec-4 launches {vec4}")
    print(f"[pathF] vec-4 launches in the counted run: {vec4}", flush=True)
    graph = graph_phase("pathF", spec, params, device, PATH_F_STEP,
                        card_label)
    del params
    torch.cuda.empty_cache()
    return launches, graph, vec4


def tp_decode(spec, params, prompt, force, steps, device):
    """A decode on device: the prefill of prompt (1, S) numpy, then
    `steps` eager forwards, each fed the previous logits' argmax or, with
    `force` (a list of `steps` tokens), the forced token (teacher forcing:
    every run sees the same inputs).  Returns the last-position logits of
    the prefill and each step (float32, on the CPU), the argmax tokens
    and the host ms a step."""
    from qpalette_tpu_torch.models import llama

    S = prompt.shape[1]
    caches = llama.init_kv_caches(spec, 1, S + steps + 1, device)
    logits, caches = llama.forward(spec, params,
                                   torch.as_tensor(prompt, device=device),
                                   kv_caches=caches, cache_pos=0)
    seq, toks = [logits[:, -1].float().cpu()], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None]
        toks.append(int(tok))
        if force is not None:
            tok = torch.full_like(tok, force[i])
        logits, caches = llama.forward(spec, params, tok, kv_caches=caches,
                                       cache_pos=S + i)
        seq.append(logits[:, -1].float().cpu())
    torch.cuda.synchronize()
    return {"logits": torch.cat(seq), "tokens": toks,
            "ms_a_step": (time.perf_counter() - t0) * 1e3 / max(steps, 1)}


def tp_rank(rank, world, builds, prompt, steps, device, forces):
    """One gloo rank of phase 14 (dryrun.run_ranks spawns it; every rank
    shares the one card): for each (build, scheme), the model of
    build_quantized_model(**build, dummy=True) (the embed and head drawn
    once a rank, dummy_dense), this rank's slices and local spec under the
    scheme ("row": parallel/tp.py, its kv heads, the all_reduce of o /
    down over the job's group; "column": parallel/sharding.py, its output
    rows, heads and vocab rows, the all_gathers over the group), the
    forced decode (tp_decode) and its launches."""
    import torch.distributed as dist

    from qpalette_tpu_torch.kernels import launch_counts, reset_launches
    from qpalette_tpu_torch.parallel import sharding
    from qpalette_tpu_torch.parallel import tp as tp_mod
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    device = torch.device(device)
    outs = []
    for (build, scheme), force in zip(builds, forces):
        spec, params = build_quantized_model(
            **build, dense_params=dummy_dense(build["num_layers"]),
            dummy=True, device=device)
        if scheme == "column":
            params = sharding.local_params(params, spec, world, rank)
            spec = sharding.localize_spec(spec, world, dist.group.WORLD)
        else:
            params = tp_mod.shard_params(params, spec, world, rank)
            spec = tp_mod.localize_spec(spec, world, dist.group.WORLD)
        torch.cuda.empty_cache()
        reset_launches()
        out = tp_decode(spec, params, prompt, force, steps, device)
        out["launches"] = {k: v for k, v in launch_counts().items() if v}
        outs.append(out)
        del params
    return outs


class ThreadGroup:
    """A tp group inside one process: `world` threads, each running one
    rank's forward on its slices at its local shapes, whose all_reduce
    sums the float32 partials on the card in rank order (rank 0 + rank 1:
    what a sum of two over gloo gives, in either order) with no gloo and
    no copy through the host.  run() routes torch.distributed.all_reduce
    on this group here while its threads run."""

    def __init__(self, world):
        self.world = world
        self.local = threading.local()
        self.barrier = threading.Barrier(world, timeout=600)
        self.parts = [None] * world
        self.total = None

    def all_reduce(self, t):
        r = self.local.rank
        self.parts[r] = t
        self.barrier.wait()
        if r == 0:  # every rank's partial is queued before this sum
            total = self.parts[0].clone()
            for part in self.parts[1:]:
                total += part
            self.total = total
        self.barrier.wait()
        t.copy_(self.total)

    def run(self, fn):
        """fn(rank) in each of the group's threads; results in rank order
        (a rank that raises breaks the others' barrier and re-raises)."""
        import torch.distributed as dist

        outs, errs = [None] * self.world, []
        orig = dist.all_reduce

        def all_reduce(tensor, op=dist.ReduceOp.SUM, group=None,
                       async_op=False):
            if group is self:
                return self.all_reduce(tensor)
            return orig(tensor, op=op, group=group, async_op=async_op)

        def body(r):
            self.local.rank = r
            try:
                outs[r] = fn(r)
            except BaseException as e:  # noqa: B036 -- re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.world)]
        dist.all_reduce = all_reduce
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            dist.all_reduce = orig
        if errs:
            raise errs[0]
        return outs


def tp_split(spec, params, prompt, force, steps, device):
    """The TP_RANKS-way tensor-parallel forced decode in this process
    (ThreadGroup): each rank's slices of params, its local spec, its
    kernels at its local shapes, the float32 partials of o / down summed
    on the card.  Returns rank 0's tp_decode result."""
    from qpalette_tpu_torch.parallel import tp as tp_mod

    group = ThreadGroup(TP_RANKS)
    ranks = [(tp_mod.localize_spec(spec, TP_RANKS, group),
              tp_mod.shard_params(params, spec, TP_RANKS, r))
             for r in range(TP_RANKS)]
    outs = group.run(lambda r: tp_decode(*ranks[r], prompt, force, steps,
                                         device))
    check(all(torch.equal(o["logits"], outs[0]["logits"]) for o in outs),
          "tp split: the ranks' logits differ")
    return outs[0]


def _share(a, b):
    """max|a - b| / max|b|, and the same per row (the prefill, each step)."""
    scale = b.abs().amax(-1)
    d = (a - b).abs()
    return float(d.max() / scale.max()), (d.amax(-1) / scale).tolist()


def col_rows(spec, params, device):
    """Each projection of layer 0 and the 4-bit head at its whole width
    against the TP_RANKS ranks' outputs at their local rows
    (sharding.local_params / localize_spec, in this process, put together
    as the gathers would), on the same random x at N = 1 and PROMPT_LEN:
    {"name kind mode N": max|d| / max|y|}, 0 where the kernel's output
    rows do not depend on m (or on a grid chosen from m)."""
    from qpalette_tpu_torch.models.llama import _attention, cat_cols
    from qpalette_tpu_torch.parallel import sharding
    from qpalette_tpu_torch.runtime.qlinear import qlinear_apply

    lspec = sharding.localize_spec(spec, TP_RANKS)
    ranks = [sharding.local_params(params, spec, TP_RANKS, r)
             for r in range(TP_RANKS)]
    projs = [(n, ls, lls, params["layers"][0][n],
              [r["layers"][0][n] for r in ranks])
             for (n, ls), (_, lls) in zip(
                 spec.layers[0][0].projs + spec.layers[0][1].projs,
                 lspec.layers[0][0].projs + lspec.layers[0][1].projs)]
    if spec.lm_head_spec is not None:
        projs.append(("lm_head", spec.lm_head_spec, lspec.lm_head_spec,
                      params["lm_head_q4"], [r["lm_head_q4"] for r in ranks]))
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, ls, lls, p, rps in projs:
        for N in (1, PROMPT_LEN):
            x = torch.randn((N, ls.in_features), generator=gen,
                            device=device).to(torch.bfloat16)
            y = qlinear_apply(ls, p, x, luts=params["luts"],
                              out_dtype=torch.float32)
            got = cat_cols([qlinear_apply(lls, rp, x, luts=params["luts"],
                                          out_dtype=torch.float32)
                            for rp in rps],
                           lls.split if lls.kind == "comb" else None)
            out[f"{name} {ls.kind} {ls.mode or ls.KV or ls.bits} N={N}"] = \
                float((got - y).abs().max() / y.abs().max())
    # the glue the ranks run at their own widths: attention on half the
    # heads (head-major halves), the bf16 head on half the vocab rows
    cfg = spec.config
    D, H, hk = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q, k, v = (torch.randn((1, PROMPT_LEN, h, D), generator=gen,
                           device=device).to(torch.bfloat16)
               for h in (H, hk, hk))
    att = _attention(q, k, v, 0, cfg)
    hq, hkv = H // TP_RANKS, hk // TP_RANKS
    got = torch.cat([_attention(q[:, :, r * hq:(r + 1) * hq],
                                k[:, :, r * hkv:(r + 1) * hkv],
                                v[:, :, r * hkv:(r + 1) * hkv], 0, cfg)
                     for r in range(TP_RANKS)], -1)
    out[f"attention S={PROMPT_LEN}"] = float(
        (got.float() - att.float()).abs().max() / att.float().abs().max())
    if "lm_head" in params:
        for N in (1, PROMPT_LEN):
            x = torch.randn((N, cfg.hidden_size), generator=gen,
                            device=device).to(torch.bfloat16).float()
            y = x @ params["lm_head"].float().T
            got = cat_cols([x @ r["lm_head"].float().T for r in ranks])
            out[f"bf16 head N={N}"] = float((got - y).abs().max()
                                            / y.abs().max())
    return out


def tp_path(device, card_label, layers=TP_LAYERS, held=True):
    """Phase 14: the flagship and the 215 at full 8B width (`layers`
    layers) built with row_parallel_tp = TP_RANKS, impl exact.  A greedy
    decode of TP_STEPS steps single-device on the card; the same model
    split TP_RANKS ways in this process (tp_split: the ranks' kernels at
    their local shapes, no gloo); then TP_RANKS gloo ranks sharing the
    card (one job for both models), both fed the single-device tokens.
    held: gloo's logits equal the split's (a sum of two float32 partials
    does not depend on its order), the split's within TP_TOL of the
    single-device max|logit| at the prefill and every step, and every
    argmax the single-device greedy token (else only printed, beside the
    single-device top-2 gap, as --tp does for deeper models).

    The column-parallel leg (parallel/sharding.py) in the same gloo job:
    the flagship, the 215 and the dry run's mixed qdict (merged tcq2 qkv,
    tcq1 o, merged tcq ug, ldlq_2_6 down in layer 0, unmerged in layer 1)
    built single-device (row_parallel_tp = 1), impl exact, each decoded
    greedily on the card single-device, then by the TP_RANKS ranks
    teacher-forced on its tokens; col_rows holds each layer-0 projection's
    kernel at the ranks' rows against the whole.  held: each rank's logits
    within TP_COL_TOL of the single-device run's (bit for bit where it is
    0) and every argmax the greedy token.  Returns {model: summary}, each
    rank's launches among them."""
    from qpalette_tpu_torch.dryrun import DRYRUN_MERGES, dryrun_qdict, \
        run_ranks
    from qpalette_tpu_torch.kernels import launch_counts, reset_launches
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    with open(FLAGSHIP_QDICT) as f:
        flagship = json.load(f)
    q215, m215 = _load_215()
    cfg = LlamaConfig.llama31_8b()
    prompt = np.random.default_rng(0).integers(0, 128256, (1, PROMPT_LEN))
    builds, singles, splits, secs = {}, {}, {}, {}
    for label, qdict, merge, head in (("flagship", flagship, None, 16),
                                      ("215", q215, m215, 4)):
        builds[label] = dict(cfg=cfg, qdict=qdict,
                             merge_info=merge, impl="exact",
                             lm_head_bits=head, num_layers=layers, seed=0,
                             row_parallel_tp=TP_RANKS)
        t0 = time.perf_counter()
        spec, params = build_quantized_model(
            **builds[label], dense_params=dummy_dense(layers), dummy=True,
            device=device)
        reset_launches()
        one = tp_decode(spec, params, prompt, None, TP_STEPS, device)
        one["launches"] = {k: v for k, v in launch_counts().items() if v}
        t1 = time.perf_counter()
        splits[label] = tp_split(spec, params, prompt, one["tokens"],
                                 TP_STEPS, device)
        singles[label] = one
        secs[label] = (t1 - t0, time.perf_counter() - t1)
        del spec, params
        torch.cuda.empty_cache()
    cols, col_singles = {}, {}
    for label, qdict, merge, head in (
            ("flagship", flagship, None, 16), ("215", q215, m215, 4),
            ("mixed", dryrun_qdict(cfg), (DRYRUN_MERGES * layers)[:layers],
             16)):
        cols[label] = dict(cfg=cfg, qdict=qdict, merge_info=merge,
                           impl="exact", lm_head_bits=head,
                           num_layers=layers, seed=0)
        t0 = time.perf_counter()
        spec, params = build_quantized_model(
            **cols[label], dense_params=dummy_dense(layers), dummy=True,
            device=device)
        reset_launches()
        one = tp_decode(spec, params, prompt, None, TP_STEPS, device)
        one["launches"] = {k: v for k, v in launch_counts().items() if v}
        one["rows"] = col_rows(spec, params, device)
        one["s"] = time.perf_counter() - t0
        col_singles[label] = one
        del spec, params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(
        tp_rank, TP_RANKS,
        [(b, "row") for b in builds.values()]
        + [(b, "column") for b in cols.values()], prompt, TP_STEPS,
        str(device), [singles[k]["tokens"] for k in builds]
        + [col_singles[k]["tokens"] for k in cols])
    t_ranks = time.perf_counter() - t0
    out = {}
    for i, label in enumerate(builds):
        one, split = singles[label], splits[label]
        ref = one["logits"]
        gloo = [r[i] for r in ranks]
        rel_split, steps = _share(split["logits"], ref)
        rels = [_share(g["logits"], ref)[0] for g in gloo]
        vs_split = [_share(g["logits"], split["logits"])[0] for g in gloo]
        scale = ref.abs().amax(-1)
        top2 = ref.topk(2, dim=-1).values
        gaps = ((top2[:, 0] - top2[:, 1]) / scale).tolist()
        print(f"[tp {label}] {layers} layers, the in-process split's max|d|"
              f" / max|logit| at the prefill and each step: "
              + ", ".join(f"{v:.2e}" for v in steps)
              + "; the single-device top-2 gap: "
              + ", ".join(f"{v:.2e}" for v in gaps), flush=True)
        print(f"[tp {label}] in-process split ({TP_RANKS} threads, float32 "
              f"partials summed on the card, no gloo): max|d| / max|logit| "
              f"{rel_split:.3e} (budget {TP_TOL:.1e}), tokens "
              f"{split['tokens']}", flush=True)
        for r, g in enumerate(gloo):
            print(f"[tp {label}] rank {r} of {TP_RANKS} (gloo, CUDA tensors "
                  f"on {device}): launches {g['launches']}, max|d| / "
                  f"max|logit| {rels[r]:.3e}, against the in-process split "
                  f"{vs_split[r]:.3e}, host {g['ms_a_step']:.2f} ms a step",
                  flush=True)
        print(f"[tp {label}] single-device: launches {one['launches']}, "
              f"host {one['ms_a_step']:.2f} ms a step; tokens "
              f"{one['tokens']}; {secs[label][0]:.1f} s, the split "
              f"{secs[label][1]:.1f} s, the {TP_RANKS} ranks of all models "
              f"{t_ranks:.1f} s ({card_label})", flush=True)
        check(one["launches"] and all(g["launches"] for g in gloo),
              f"tp {label}: a run launched no kernel")
        same = [split["tokens"] == one["tokens"]] + [
            g["tokens"] == one["tokens"] for g in gloo]
        if held:
            check(max(vs_split) == 0.0,
                  f"tp {label}: gloo against the in-process split {vs_split}")
            check(rel_split <= TP_TOL, f"tp {label}: split {rel_split}")
            check(all(same), f"tp {label}: greedy tokens differ: "
                  f"{[split['tokens']] + [g['tokens'] for g in gloo]} vs "
                  f"{one['tokens']}")
        else:
            print(f"[tp {label}] {layers} layers: argmax tokens equal "
                  f"(split, ranks) {same}", flush=True)
        out[label] = {
            "layers": layers, "rel": rels, "rel_split": rel_split,
            "rel_steps": steps, "gloo_vs_split": vs_split,
            "top2_gap": gaps, "tokens_equal": all(same),
            "single_launches": one["launches"],
            "rank_launches": [g["launches"] for g in gloo],
            "single_ms_a_step": one["ms_a_step"],
            "rank_ms_a_step": [g["ms_a_step"] for g in gloo],
            "tokens_s_one_card_two_ranks": 1e3 / max(
                g["ms_a_step"] for g in gloo)}
    for i, label in enumerate(cols, len(builds)):
        one = col_singles[label]
        ref = one["logits"]
        gloo = [r[i] for r in ranks]
        rels = [_share(g["logits"], ref) for g in gloo]
        equal = [torch.equal(g["logits"], ref) for g in gloo]
        same = [g["tokens"] == one["tokens"] for g in gloo]
        top2 = ref.topk(2, dim=-1).values
        gaps = ((top2[:, 0] - top2[:, 1]) / ref.abs().amax(-1)).tolist()
        # the steps whose argmax a rank flipped, with their top-2 gaps; a
        # flip is held against only where the gap clears 2 * TP_COL_TOL
        flips = sorted({(i, round(gaps[i], 6)) for g in gloo
                        for i, (a, b) in enumerate(zip(g["tokens"],
                                                       one["tokens"]))
                        if a != b})
        print(f"[tp col {label}] {layers} layers, each projection of layer "
              f"0 (and the 4-bit head) at the {TP_RANKS} ranks' rows against "
              f"the whole, max|d| / max|y|: " + json.dumps(one["rows"]),
              flush=True)
        for r, g in enumerate(gloo):
            print(f"[tp col {label}] rank {r} of {TP_RANKS} (gloo, column-"
                  f"parallel): launches {g['launches']} (single-device "
                  f"{one['launches']}); max|d| / max|logit| {rels[r][0]:.3e} "
                  f"(prefill and steps "
                  + ", ".join(f"{v:.2e}" for v in rels[r][1])
                  + f"), bit-equal {equal[r]}, argmax = greedy {same[r]} "
                  f"(flipped at (step, single-device top-2 gap) {flips}), "
                  f"host {g['ms_a_step']:.2f} ms a step (single-device "
                  f"{one['ms_a_step']:.2f}); single-device run "
                  f"{one['s']:.1f} s ({card_label})", flush=True)
        check(one["launches"] and all(g["launches"] for g in gloo),
              f"tp col {label}: a run launched no kernel")
        if held:
            check(all(equal) if TP_COL_TOL == 0.0 else
                  max(r[0] for r in rels) <= TP_COL_TOL,
                  f"tp col {label}: ranks' logits {rels} (limit "
                  f"{TP_COL_TOL})")
            check(all(gap < 2 * TP_COL_TOL for _, gap in flips),
                  f"tp col {label}: an argmax flipped where the top-2 gap "
                  f"clears 2 * TP_COL_TOL: {flips}; "
                  f"{[g['tokens'] for g in gloo]} vs {one['tokens']}")
        out[f"column {label}"] = {
            "layers": layers, "rel": [r[0] for r in rels],
            "rel_steps": [r[1] for r in rels], "bit_equal": equal,
            "tokens_equal": all(same), "flips": flips, "top2_gap": gaps,
            "kernel_rows": one["rows"],
            "single_launches": one["launches"],
            "rank_launches": [g["launches"] for g in gloo],
            "single_ms_a_step": one["ms_a_step"],
            "rank_ms_a_step": [g["ms_a_step"] for g in gloo]}
    print(f"[time] phase 14 column leg: single-device runs "
          f"{sum(o['s'] for o in col_singles.values()):.1f} s; the gloo job "
          f"(both schemes) {t_ranks:.1f} s", flush=True)
    return out


def _proxy(hat, W, H):
    from qpalette_tpu_torch.utils.precision import full_f32

    E = (hat - W).float()
    with full_f32():
        return float(torch.einsum("ij,jk,ik->", E, H, E))


def beam_refine(device, card_label, n=4096, m_k=1024, n_beam=1024,
                samples=8192):
    """Phase 15: quantize_mat_tcq of a 1024x1024 weight (layer-0 k's rows
    and its first 1024 input columns, tcq_6 with the Hessian's block of
    those columns) at beam 0 and BEAM_WIDTH, and refine_artifact_vq of a
    4096x4096 one (o's shape) after LDLQ at ldlq_1_4 with the whole
    Hessian: seconds and tr(E H E^T).  The beam's time goes with the
    column blocks (one LDLQ step each, 128 beam steps a step), not with
    the rows, so the slice keeps a quarter of k's.  Weights: N(0, 1) rows of
    unit RMS; the Hessian: X^T X / n of 8192 activations whose channels
    are scaled by exp(N(0, 1)) (a few large channels, as a layer's input
    has).  The beam must not raise the proxy error, nor refine."""
    from qpalette_tpu_torch.ops.codebooks import vq_lut
    from qpalette_tpu_torch.ops.packing import dequant_lut, words_to_torch
    from qpalette_tpu_torch.quant import quantizers, refine
    from qpalette_tpu_torch.utils.precision import full_f32

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    gen = torch.Generator(device=device)
    gen.manual_seed(15)
    scale = torch.exp(torch.randn(n, generator=gen, device=device))
    X = torch.randn((samples, n), generator=gen, device=device) * scale
    with full_f32():
        H = X.T @ X / X.shape[0]
    del X

    def unit_rows(m, cols):
        W = torch.randn((m, cols), generator=gen, device=device)
        return W / W.pow(2).mean(1, keepdim=True).sqrt()

    out = {}
    Wk, Hk = unit_rows(m_k, n_beam), H[:n_beam, :n_beam]
    for width in (0, BEAM_WIDTH):
        sync()
        t0 = time.perf_counter()
        _, hat = quantizers.quantize_mat_tcq(Wk, Hk, 6, use_hess=True,
                                             beam=width)
        sync()
        out[f"tcq_6 beam {width}"] = {"s": time.perf_counter() - t0,
                                      "proxy": _proxy(hat, Wk, Hk)}
    Wo = unit_rows(n, n)
    sync()
    t0 = time.perf_counter()
    lin, hat = quantizers.quantize_mat_vq(Wo, H, 4, 1, use_hess=True)
    sync()
    out["ldlq_1_4"] = {"s": time.perf_counter() - t0,
                       "proxy": _proxy(hat, Wo, H)}
    art = {"meta": {k: v for k, v in lin.items() if k != "qweight"},
           "qweight": lin["qweight"], "lut": np.asarray(vq_lut(4, 1)),
           "Wscale": np.ones(n, np.float32)}
    t0 = time.perf_counter()
    ref = refine.refine_artifact_vq(Wo, art, H, device=device)
    sync()
    hat2 = dequant_lut(words_to_torch(ref["qweight"], device),
                       torch.tensor(art["lut"], device=device), n, n, 4, 1)
    out["ldlq_1_4 refined"] = {"s": time.perf_counter() - t0,
                               "proxy": _proxy(hat2, Wo, H)}
    for k, v in out.items():
        print(f"[beam/refine] {k}: {v['s']:.2f} s, tr(E H E^T) "
              f"{v['proxy']:.6g} ({card_label})", flush=True)
    check(out[f"tcq_6 beam {BEAM_WIDTH}"]["proxy"]
          <= out["tcq_6 beam 0"]["proxy"] * (1 + 1e-5),
          "the beam raised the proxy error")
    check(out["ldlq_1_4 refined"]["proxy"]
          <= out["ldlq_1_4"]["proxy"] * (1 + 1e-5),
          "refine raised the proxy error")
    return out


def tcq2mix_qdict(num_layers=32):
    return {f"{i}_{key}": q for i in range(num_layers)
            for key, q in TCQ2MIX.items()}


def path_a_b(device, card_label):
    """Path A (tcq2mix decode at a8 and exact, then the zero-shot harness
    at exact: K1 dualmad, 1mad and the sum2 head on wide_gemv_kernel) and
    Path B (512-token exact prefill on tcq2mix and on the 215
    config).  Returns (launch counts summed over the counted runs,
    graph_phase's result by impl, prefill s by config (and Path A's warm
    16-token prefill by impl), zs_check's summary of Path A)."""
    spec, params = _build("pathA", tcq2mix_qdict(), [["merge_qkv",
                                                       "merge_ug"]] * 32,
                          "a8", 4, device)
    mix = {}
    for a, m in spec.layers:
        for _, ls in a.projs + m.projs:
            key = (ls.kind, ls.mode, ls.KV[0])
            mix[key] = mix.get(key, 0) + 1
    head = spec.lm_head_spec
    check(mix == PATH_A_MIX and (head.kind, head.mode, head.KV[0],
                                 head.out_features) ==
          ("tcq2", "sum2", 8, 131072), f"tcq2mix projections {mix}, {head}")
    print(f"[pathA] projections per forward {mix} + the sum2 KV8 head "
          f"(131072x4096)", flush=True)
    total, tps, pre = {}, {}, {}
    for impl in ("a8", "exact"):
        sp = with_impl(spec, impl)
        got = drive(f"pathA {impl}", sp, params, device, PROMPT_LEN,
                    COUNTED_TOKENS, PATH_A_PREFILL, PATH_A_STEP)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        pre[f"pathA {impl} {PROMPT_LEN}"] = prefill_time(
            f"pathA {impl}", sp, params, device, PROMPT_LEN, card_label)
        tps[impl] = graph_phase(f"pathA {impl}", sp, params, device,
                                PATH_A_STEP, card_label)
    got, zs = zs_check(spec, params, device, card_label, "Path A",
                       PATH_A_STEP)
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    sp = with_impl(spec, "exact")
    got = drive("pathB tcq2mix", sp, params, device, PREFILL_B, 0,
                PATH_B["tcq2mix"], {})
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    pre["tcq2mix"] = prefill_time("pathB tcq2mix", sp, params, device,
                                  PREFILL_B, card_label)
    del params
    torch.cuda.empty_cache()
    qdict, merge_info = _load_215()
    spec, params = _build("pathB 215", qdict, merge_info, "exact", 4, device)
    got = drive("pathB 215", spec, params, device, PREFILL_B, 0,
                PATH_B["215"], {})
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    pre["215"] = prefill_time("pathB 215", spec, params, device, PREFILL_B,
                              card_label)
    del params
    torch.cuda.empty_cache()
    return total, tps, pre, zs


# Path E: the 8B with a mixed qdict.  Each layer's groups take the six
# schemes in turn, the attention merge cycles qkv / qk / kv / qv / none
# (7, 7, 6, 6, 6 layers), ug is merged on even layers, and the groups take
# the impl choices in turn from PATH_E_CHOICES: "1" and "xla" are the
# dequant route under the session's a8 (2 of 8 groups, about a quarter
# of the streamed weight bytes), "pallas" exact, "0" and "pallas_a8" a8
PATH_E_SCHEMES = ("tcq_8_none_0.9", "tcomb_8_9_0.5_none_0.9",
                  "tcq2s_6_none_0.9", "tcq2_6_none_0.9", "tcq1_3_none_0.9",
                  "ldlq_2_6_none_1.0")
PATH_E_CHOICES = ("0", "1", "pallas", "xla", "pallas_a8", "0", "pallas", "0")
PATH_E_PARTS = ("qkv", "qk", "kv", "qv", None)
PATH_E_DEQUANT_SHARE = (0.2, 0.3)  # of the streamed weight bytes
# the wrapper each kind launches on the dequant route, and on the GEMV
# class below and above 8 rows (K1 takes up to 256 rows)
DEQUANT_OF = {"tcq2": "tcq2_dequant", "tcq1": "tcq1_dequant",
              "tcq": "tcq_lut_dequant", "comb": "tcq_lut_dequant",
              "tcomb": "tcomb_lut_dequant", "vq": "vq_dequant"}
GEMV_OF = {"sum2": "tcq2s_decode_gemv", "dualmad": "tcq2_decode_gemv",
           "1mad": "tcq1_decode_gemv", "2mad": "tcq1_decode_gemv",
           "tcq": "tcq_lut_gemv", "comb": "tcq_lut_gemv",
           "tcomb": "tcomb_lut_gemv", "vq": "vq_gemv"}


def path_e_qdict(num_layers=32):
    """(qdict, merge_info) of Path E."""
    from qpalette_tpu_torch.runtime.loader import ATTN_GROUPS, LAYER_KEYS

    KO, KG, KU, KD = LAYER_KEYS[3:]
    qdict, merge_info, g = {}, [], 0
    for i in range(num_layers):
        part = PATH_E_PARTS[i % len(PATH_E_PARTS)]
        ug = i % 2 == 0
        groups = [keys for _, keys in ATTN_GROUPS[part]] + [(KO,)] + (
            [(KU, KG)] if ug else [(KU,), (KG,)]) + [(KD,)]
        for j, keys in enumerate(groups):
            scheme = PATH_E_SCHEMES[(i + j) % len(PATH_E_SCHEMES)]
            choice = PATH_E_CHOICES[g % len(PATH_E_CHOICES)]
            g += 1
            for key in keys:
                qdict[f"{i}_{key}"] = (scheme, choice)
        merge_info.append(([f"merge_{part}"] if part else [])
                          + (["merge_ug"] if ug else []))
    return qdict, merge_info


def proj_launches(ls, rows):
    """{wrapper: launches} of one qlinear_apply of ls at rows, as
    runtime/qlinear.py dispatches it."""
    from qpalette_tpu_torch.kernels import arith

    if ls.kind in ("dense", "dense_rot"):
        return {}
    halves = 2 if ls.kind == "comb" else 1
    if ls.impl == "dequant":
        return {DEQUANT_OF[ls.kind]: halves}
    if ls.kind in ("tcq1", "tcq2"):
        if rows <= arith.MAX_ROWS or ls.impl == "a8":  # 256-row chunks
            return {GEMV_OF[ls.mode]: sum(
                arith.kernel_launches(ls.mode, min(arith.MAX_ROWS, rows - r))
                for r in range(0, rows, arith.MAX_ROWS))}
        return {DEQUANT_OF[ls.kind]: 1}
    if rows > 8:
        return {DEQUANT_OF[ls.kind]: halves}
    return {GEMV_OF[ls.kind]: halves}


def kind_label(ls):
    if ls.kind in ("tcq1", "tcq2"):
        return f"{ls.kind} {ls.mode}"
    if ls.kind == "vq":
        return f"vq {ls.bits}/{ls.vec}"
    return ls.kind


def census(label, spec, params, rows):
    """Projections and streamed bytes by kind x route (impl) x group (the
    merged group's name, or "single"), printed; returns ({wrapper:
    launches} of a forward at each of rows, {(kind, route, group): (n,
    bytes)}, the dequant route's share of the weight bytes)."""
    table, want = {}, {r: {} for r in rows}
    projs = [(nm, ls, lp[nm]) for (a, m), lp in zip(spec.layers,
                                                   params["layers"])
             for nm, ls in a.projs + m.projs]
    if spec.lm_head_spec is not None:
        projs.append(("lm_head", spec.lm_head_spec, params["lm_head_q4"]))
    for nm, ls, p in projs:
        group = nm if nm in ("qkv", "qk", "kv", "qv", "ug") else "single"
        key = (kind_label(ls), ls.impl, group)
        nbytes = sum(t.numel() * t.element_size() for t in p.values())
        n, b = table.get(key, (0, 0))
        table[key] = (n + 1, b + nbytes)
        for r in rows:
            for w, c in proj_launches(ls, r).items():
                want[r][w] = want[r].get(w, 0) + c
    total = sum(b for _, b in table.values())
    deq = sum(b for (_, route, _), (_, b) in table.items()
              if route == "dequant")
    print(f"[{label}] census: kind, route, group: projections, MB "
          f"(computed from tensor sizes)", flush=True)
    for key, (n, b) in sorted(table.items()):
        print(f"[{label}]   {key[0]:<13} {key[1]:<8} {key[2]:<7} {n:4d} "
              f"{b / 1e6:10.1f}", flush=True)
    print(f"[{label}] weight bytes {total / 1e9:.3f} GB, dequant route "
          f"{deq / 1e9:.3f} GB ({deq / total:.1%}); launches a forward "
          + "; ".join(f"{r} rows {want[r]}" for r in rows), flush=True)
    return want, table, deq / total


def path_e(device, card_label):
    """Path E: the 8B with the mixed qdict (every attention merge, merged
    tcq / tcomb groups, the five impl choices, the dequant route on K2,
    K3, K6, K7 and K9 in the decode step), impl a8, the 4-bit head.  Its
    census's launches, the counted eager run, the graph phase.  Returns
    (launch counts, graph_phase's result)."""
    from qpalette_tpu_torch.quant.incoherent import parse_quantizer_str

    qdict, merge_info = path_e_qdict()
    choices = {c for _, c in qdict.values()}
    check(choices == {"0", "1", "xla", "pallas", "pallas_a8"},
          f"pathE choices {choices}")
    spec, params = _build("pathE", qdict, merge_info, "a8", 4, device)
    want, table, share = census("pathE", spec, params, (PROMPT_LEN, 1))
    parts = [a.merge for a, _ in spec.layers]
    check(all(parts.count(p) >= 6 for p in PATH_E_PARTS),
          f"pathE attention partitions {parts}")
    check(sum(m.merge_ug for _, m in spec.layers) == 16, "pathE ug merges")
    fams = {}
    for (kind, _, group), _ in table.items():
        fams.setdefault(kind, set()).add(group != "single")
    for kind in ("tcq", "tcomb", "tcq2 sum2", "tcq2 dualmad", "tcq1 1mad",
                 "vq 6/2"):
        check(fams.get(kind) == {True, False},
              f"pathE {kind}: merged and unmerged {fams.get(kind)}")
    for kind in ("tcq", "tcomb"):
        groups = {g for (k, _, g) in table if k == kind and g != "single"}
        check(groups & {"qkv", "qk", "kv", "qv"} and "ug" in groups,
              f"pathE merged {kind} groups {groups}")
    for kname in ("tcq2_dequant", "tcq1_dequant", "tcq_lut_dequant",
                  "tcomb_lut_dequant", "vq_dequant"):
        check(want[1].get(kname, 0) > 0, f"pathE step: no {kname}")
    lo, hi = PATH_E_DEQUANT_SHARE
    check(lo <= share <= hi, f"pathE dequant share {share}")
    check({parse_quantizer_str(q).family for q, _ in qdict.values()}
          == {"tcq", "tcomb", "tcq2s", "tcq2", "tcq1", "ldlq"}, "pathE mix")
    launches = drive("pathE", spec, params, device, PROMPT_LEN,
                     COUNTED_TOKENS, want[PROMPT_LEN], want[1])
    graph = graph_phase("pathE", spec, params, device, want[1], card_label)
    del params
    torch.cuda.empty_cache()
    return launches, graph


def merged_shape_checks(device):
    """The GEMVs at the merged m no other path gives them (kv 2048, qk / qv
    5120, qkv 6144, ug 28672; k 4096), comb as two K4 calls over unequal
    16-row halves, and the dequant route of every kind, each against its
    plain version on the CPU.  Returns {kernel: max_abs_err}."""
    from qpalette_tpu_torch.kernels import arith, launch_counts, tcq_lut, vq
    from qpalette_tpu_torch.ops.codebooks import (tlut_bits_for_kv,
                                                  trellis_tlut, vq_lut)
    from qpalette_tpu_torch.runtime.loader import word_shapes
    from qpalette_tpu_torch.runtime.qlinear import (LinearSpec,
                                                    dequant_weight,
                                                    qlinear_apply)

    err = {}

    def note(name, e):
        err[name] = max(err.get(name, 0.0), e)

    k = 4096
    for m in (2048, 5120, 6144, 28672):
        for KV in ((8,), (8, 9)):
            tlut = torch.tensor(trellis_tlut(tlut_bits_for_kv(max(KV))),
                                device=device)
            words = _lut_words(m, k, KV, device, seed=m + sum(KV))
            gemv, plain = ((tcq_lut.tcq_lut_gemv, tcq_lut.tcq_lut_gemv_plain)
                           if len(KV) == 1 else
                           (tcq_lut.tcomb_lut_gemv,
                            tcq_lut.tcomb_lut_gemv_plain))
            for N in (1, 8):
                x = torch.randn((N, k), device=device).bfloat16()
                note(gemv.__name__, _rel_check(
                    f"{gemv.__name__} merged m={m} KV={KV} N={N}",
                    gemv(x, *words, tlut, *KV, m, k),
                    plain(x, *words, tlut, *KV, m, k), LUT_TOL))
        if m > 5120:
            continue
        for mode, KV in (("sum2", 6), ("dualmad", 6), ("1mad", 3)):
            words = _words(m, k, arith.words_per_tile(mode, KV), device,
                           seed=m + KV)
            for N in (1, 8):
                x = torch.randn((N, k), device=device)
                for a8 in (False, True):
                    note(GEMV_OF[mode], _rel_check(
                        f"{GEMV_OF[mode]} {mode} merged m={m} N={N} a8={a8}",
                        arith.decode_gemv(mode, x, words, KV, m, k, a8),
                        arith.arith_gemv_plain(x, words, mode, KV, m, k, a8),
                        TOL[a8]))
        lut = torch.tensor(vq_lut(6, 2), device=device)
        qw = _vq_words(m, k, 6, 2, device, seed=m)
        for N in (1, 8):
            x = torch.randn((N, k), device=device).bfloat16()
            note("vq_gemv", _rel_check(
                f"vq_gemv merged m={m} N={N}",
                vq.vq_gemv(x, qw, lut, 6, 2, m, k),
                vq.vq_gemv_plain(x, qw, lut, 6, 2, m, k), VQ_TOL))

    def proj(kind, m, seed, impl, split=(), **kw):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        ls = LinearSpec(kind, k, m, split=split, impl=impl, **kw)
        p = {name: torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                                 dtype=torch.int32, device=device)
             for name, shape in word_shapes(ls).items()}
        p["wscale"] = torch.rand(m, generator=gen, device=device) + 0.5
        if kind == "vq":
            p["lut"] = torch.tensor(vq_lut(ls.bits, ls.vec), device=device)
        luts = ({f"tcq{ls.tlut_bits}": torch.tensor(
            trellis_tlut(ls.tlut_bits), device=device)}
            if ls.tlut_bits else {})
        return ls, p, luts

    def on_cpu(d):
        return {n: t.cpu() for n, t in d.items()}

    # comb at the 8B's o (ratio 0.4) and k/v row splits; two K4 calls at
    # N <= 8, two K6 above
    for m, split in ((4096, (1632, 2464)), (1024, (400, 624))):
        ls, p, luts = proj("comb", m, m, "exact", split=split, KV=(6, 7),
                           tlut_bits=9)
        for N in (1, 8, 12):
            x = torch.randn((N, k), device=device).bfloat16()
            before = launch_counts()
            y = qlinear_apply(ls, p, x, out_dtype=torch.float32, luts=luts)
            after = launch_counts()
            wrapper = "tcq_lut_gemv" if N <= 8 else "tcq_lut_dequant"
            check(after[wrapper] - before[wrapper] == 2,
                  f"comb {split} N={N}: {wrapper} not launched twice")
            note(wrapper, _rel_check(
                f"comb {m}x{k} out_part {split} N={N} ({wrapper} x2)", y,
                qlinear_apply(ls, on_cpu(p), x.cpu(), out_dtype=torch.float32,
                              luts=on_cpu(luts)).to(device), LUT_TOL))
    # the dequant route: W_hat bit-equal to the plain version's
    cases = [("tcq2", 2048, dict(KV=(6,), mode="sum2")),
             ("tcq2", 5120, dict(KV=(6,), mode="dualmad")),
             ("tcq1", 6144, dict(KV=(3,), mode="1mad")),
             ("tcq", 2048, dict(KV=(8,), tlut_bits=9)),
             ("comb", 4096, dict(KV=(8, 9), tlut_bits=9,
                                 split=(1632, 2464))),
             ("tcomb", 28672, dict(KV=(8, 9), tlut_bits=10,
                                   split=(k // 2, k // 2))),
             ("vq", 5120, dict(bits=6, vec=2))]
    for kind, m, kw in cases:
        ls, p, luts = proj(kind, m, 7 * m, "dequant", **kw)
        w = dequant_weight(ls, p, luts)
        torch.cuda.synchronize()
        w_ref = dequant_weight(ls, on_cpu(p), on_cpu(luts))
        same = torch.equal(w.cpu().view(torch.int16), w_ref.view(torch.int16))
        print(f"[kernel] dequant route {kind_label(ls)} {m}x{k}: W_hat "
              f"bit-equal to the plain version's: {same}", flush=True)
        check(same, f"dequant route {kind} {m}: W_hat differs")
        x = torch.randn((1, k), device=device).bfloat16()
        y = qlinear_apply(ls, p, x, out_dtype=torch.float32, luts=luts)
        ref = qlinear_apply(ls, on_cpu(p), x.cpu(), out_dtype=torch.float32,
                            luts=on_cpu(luts)).to(device)
        note(DEQUANT_OF[kind], _rel_check(
            f"dequant route {kind_label(ls)} {m}x{k} N=1 (product and "
            f"Wscale, against the CPU's)", y, ref, PRODUCT_TOL))
        del w, w_ref, p
    return err


# Artifacts on the card: two layers of the 8B written with the port's
# save_artifact (random words in the reference's meta schema), loaded with
# dummy=False on the card and on the CPU.  (scheme, choice) a projection;
# comb's out_part is quantize_mat_comb's (ratio 0.4, rows cut to 16s)
ARTIFACT_LAYERS = [
    {"self_attn.q_proj": ("tcq_8_none_0.9", "0"),
     "self_attn.k_proj": ("tcq_8_none_0.9", "0"),
     "self_attn.v_proj": ("comb_6_7_0.4_none_0.9", "0"),
     "self_attn.o_proj": ("rotfp16", "0"),
     "mlp.gate_proj": ("tcomb_8_9_0.5_none_0.9", "0"),
     "mlp.up_proj": ("tcomb_8_9_0.5_none_0.9", "0"),
     "mlp.down_proj": ("tcq2s_6_none_0.9", "1")},
    {"self_attn.q_proj": ("tcq1_3_none_0.9", "1"),
     "self_attn.k_proj": ("tcq_8_none_0.9", "1"),
     "self_attn.v_proj": ("tcq_8_none_0.9", "1"),
     "self_attn.o_proj": ("comb_8_9_0.4_none_0.9", "0"),
     "mlp.gate_proj": ("tcq2_6_none_0.9", "0"),
     "mlp.up_proj": ("ldlq_2_6_none_1.0", "1"),
     "mlp.down_proj": ("tcomb_8_9_0.5_none_0.9", "xla")},
]
ARTIFACT_MERGES = [["merge_qk", "merge_ug"], ["merge_kv"]]


def random_artifact(qstr, m, n, su, seed):
    """An (m, n) artifact of qstr in the reference's meta schema: random
    packed words (a random rotated weight for rotfp16), the SU given, a
    random Wscale."""
    from qpalette_tpu_torch.ops.codebooks import (tlut_bits_for_kv,
                                                  trellis_tlut, vq_lut)
    from qpalette_tpu_torch.ops.hadamard import get_had_factors
    from qpalette_tpu_torch.quant.incoherent import parse_quantizer_str
    from qpalette_tpu_torch.runtime import loader

    q = parse_quantizer_str(qstr)
    rng = np.random.default_rng(seed)
    meta = {"quantizer_str": qstr, "in_features": n, "out_features": m,
            "rot_info": "skip_r", "rot_blocks": 1,
            "had_factors": list(get_had_factors(n))}
    art = {"SU": su, "Wscale": rng.uniform(0.01, 0.03, m).astype(np.float32)}
    if q.family == "rotfp16":
        meta["kind"] = "dense_rot"
        art["w"] = rng.standard_normal((m, n)).astype(np.float32)
        art["meta"] = meta
        return art
    if q.family == "comb":
        m0 = int(m * q.ratio)
        m0 -= m0 % 16
        meta.update(kind="comb", KV1=q.KV[0], KV2=q.KV[1],
                    tlut_bits=tlut_bits_for_kv(q.KV[0]),
                    out_part=(m0, m - m0))
    elif q.family == "tcomb":
        meta.update(kind="tcomb", KV1=q.KV[0], KV2=q.KV[1],
                    tlut_bits=tlut_bits_for_kv(max(q.KV)),
                    in_part=(n // 2, n // 2))
    else:
        meta = {**loader.dummy_artifact(qstr, (m, n))["meta"], **meta}
    if "tlut_bits" in meta:
        art["tlut"] = trellis_tlut(meta["tlut_bits"])
    if meta["kind"] == "vq":
        art["lut"] = vq_lut(q.bits, q.vec)
    art["meta"] = meta
    for name, shape in loader.word_shapes(
            loader._spec_from_meta(meta, "exact")).items():
        art[name] = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    return art


def artifact_check(device, cfg=None):
    """Two layers of the 8B (every attention projection kind of the
    loader: merged tcq and tcomb groups, comb with unequal halves,
    rotfp16, choice "1" and "xla") and the 999_lm_head tcq2s_8 artifact
    written to a temporary save_dir with the port's save_artifact, loaded
    with dummy=False on the card and on the CPU: a 12-token prefill and 2
    decode steps within SMALL_TOL of max|logit|.  Returns the card run's
    launches."""
    import tempfile

    from qpalette_tpu_torch.kernels import launch_counts, reset_launches
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.quant.incoherent import (artifact_path,
                                                     save_artifact)
    from qpalette_tpu_torch.runtime import loader

    cfg = cfg or LlamaConfig.llama31_8b()
    VP = -(-cfg.vocab_size // 4096) * 4096  # the 4-bit head's rows
    qdict = {f"{i}_{k}": v for i, layer in enumerate(ARTIFACT_LAYERS)
             for k, v in layer.items()}
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 12))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as save_dir:
        for i, layer in enumerate(ARTIFACT_LAYERS):
            for key, (qstr, _) in layer.items():
                art = random_artifact(qstr, *loader.proj_shape(cfg, key),
                                      loader.su_for(cfg, i, key, 0),
                                      seed=10 * i + len(key))
                save_artifact(art, artifact_path(save_dir, "3_8b", 0, qstr,
                                                 i, key))
        h = cfg.hidden_size
        su = ((np.random.default_rng(99).standard_normal(h) > 0) * 2.0
              - 1.0).astype(np.float32)  # the head's SU: seed 0 * 7 + 99
        save_artifact(random_artifact(loader.LM_HEAD_QSTR, VP, h, su,
                                      seed=99),
                      artifact_path(save_dir, "3_8b", 0, loader.LM_HEAD_QSTR,
                                    *loader.LM_HEAD_LAYER))
        print(f"[artifacts] 2 layers + the 4-bit head written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out, counts = {}, {}
        for dev in ("cpu", device):
            spec, params = loader.build_quantized_model(
                cfg, qdict, merge_info=ARTIFACT_MERGES, dummy=False,
                impl="a8", num_layers=2, lm_head_bits=4, device=dev,
                model_key="3_8b", save_dir=save_dir)
            caches = llama.init_kv_caches(spec, 1, 15, dev)
            reset_launches()
            l1, caches = llama.forward(spec, params, torch.as_tensor(
                prompt, device=dev), kv_caches=caches, cache_pos=0)
            logits = [l1.cpu()]
            for s in range(2):
                nxt = torch.tensor([[17 + s]], device=dev)
                ls, caches = llama.forward(spec, params, nxt, kv_caches=caches,
                                           cache_pos=12 + s)
                logits.append(ls.cpu())
            out[str(dev)] = logits
            counts = {k: v for k, v in launch_counts().items() if v}
            del params, caches
    kinds = sorted({(nm, ls.kind, ls.impl) for a, m in spec.layers
                    for nm, ls in a.projs + m.projs})
    print(f"[artifacts] projections (name, kind, impl): {kinds}", flush=True)
    check(counts.get("tcq_lut_gemv", 0) >= 4
          and counts.get("tcq_lut_dequant", 0) >= 4,
          f"artifacts: comb's K4/K6 calls {counts}")
    for i, step in enumerate(("prefill 12", "decode step 1",
                              "decode step 2")):
        a, b = out["cpu"][i], out[str(device)][i]
        check(bool(torch.isfinite(b).all()), f"artifacts {step}: non-finite")
        rel = ((a - b).abs().max() / a.abs().max()).item()
        print(f"[artifacts] 8B 2 layers from artifacts {step}: card vs CPU "
              f"plain rel={rel:.3e} (limit {SMALL_TOL}); card launches "
              f"{counts}", flush=True)
        check(rel <= SMALL_TOL, f"artifacts {step}: rel {rel}")
    print(f"[artifacts] check took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return counts


SMALL_CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=1792,
                 num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                 rope_theta=5e5)


def to_device(p, device):
    """A params tree (dicts, lists, tensors) copied to device."""
    if isinstance(p, dict):
        return {k: to_device(v, device) for k, v in p.items()}
    if isinstance(p, list):
        return [to_device(v, device) for v in p]
    return p.to(device)


def small_model_check(device, what, qdict, merge_info, impl, lm_head_bits,
                      prompt_len, seed):
    """A 2-layer model: CPU (plain versions) vs the same weights on the card
    (kernels), prefill and one decode step."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    cfg = LlamaConfig(**SMALL_CFG)
    spec, p_cpu = build_quantized_model(
        cfg, qdict, merge_info=merge_info, dummy=True, impl=impl,
        lm_head_bits=lm_head_bits, seed=seed, device="cpu")

    p_dev = to_device(p_cpu, device)
    prompt = np.random.default_rng(5).integers(0, 512, (1, prompt_len))
    out = {}
    for dev, p in (("cpu", p_cpu), (device, p_dev)):
        caches = llama.init_kv_caches(spec, 1, prompt_len + 2, dev)
        tok = torch.as_tensor(prompt, device=dev)
        l1, caches = llama.forward(spec, p, tok, kv_caches=caches,
                                   cache_pos=0)
        nxt = torch.tensor([[17]], device=dev)
        l2, _ = llama.forward(spec, p, nxt, kv_caches=caches,
                              cache_pos=prompt_len)
        out[str(dev)] = (l1.cpu(), l2.cpu())
    for i, step in enumerate((f"prefill {prompt_len}", "decode step")):
        a, b = out["cpu"][i], out[str(device)][i]
        rel = ((a - b).abs().max() / a.abs().max()).item()
        print(f"[small] 2-layer {what} {step}: card vs CPU plain "
              f"rel={rel:.3e} (limit {SMALL_TOL})", flush=True)
        check(rel <= SMALL_TOL, f"small model {what} {step}: rel {rel}")


# phase 10d: schemes outside the palette's GEMV sets at impl dequant, run by
# the dequant kernels' instances that read their KVs (K2, K3, K6, K7) or
# (bits, vec) (K9) beyond the palette's
OFF_PALETTE = ("tcq_2_none_0.9", "tcomb_5_7_0.5_none_0.9", "tcq2s_3_none_0.9",
               "tcq1_6_none_0.9", "ldlq_1_9_none_1.0", "ldlq_2_2_none_1.0")


def off_palette_check(device):
    """Phase 10d: each OFF_PALETTE scheme on every projection of a 1-layer
    SMALL_CFG model at impl dequant, the card (the kind's dequant kernel)
    against the CPU (its plain version): a 12-token prefill and a decode
    step within SMALL_TOL of max|logit|, the kind's dequant kernel
    launched 14 times (7 projections a forward) and no other; then each
    projection's W-hat from the kernel held to the plain version's, bit
    for bit.  The codebooks of ldlq_1_9 and ldlq_2_2 are not committed:
    seeded stand-ins in the temporary QPALETTE_ASSETS.  Returns ({qstr:
    (rel, max_abs_err of W-hat)}, off_palette_times' times)."""
    from qpalette_tpu_torch.kernels import launch_counts, reset_launches
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.ops import codebooks
    from qpalette_tpu_torch.runtime import qlinear
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    d = codebooks.cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    for bits, vec in ((9, 1), (2, 2)):
        np.save(d / f"vq_kmeans_{bits}_{vec}.npy",
                np.random.default_rng(500 + 16 * bits + vec).standard_normal(
                    (1 << bits, vec)).astype(np.float32))
    codebooks.vq_lut.cache_clear()
    cfg = LlamaConfig(**dict(SMALL_CFG, num_layers=1))
    prompt = np.random.default_rng(5).integers(0, 512, (1, 12))
    out = {}
    for qstr in OFF_PALETTE:
        t0 = time.perf_counter()
        spec, p_cpu = build_quantized_model(cfg, qstr, dummy=True,
                                            impl="dequant", device="cpu")
        p_dev = to_device(p_cpu, device)
        runs = {}
        for dev, p in (("cpu", p_cpu), (device, p_dev)):
            reset_launches()
            caches = llama.init_kv_caches(spec, 1, 13, dev)
            l1, caches = llama.forward(spec, p, torch.as_tensor(
                prompt, device=dev), kv_caches=caches, cache_pos=0)
            l2, _ = llama.forward(spec, p, torch.tensor([[17]], device=dev),
                                  kv_caches=caches, cache_pos=12)
            runs[str(dev)] = ((l1.cpu(), l2.cpu()),
                              {k: v for k, v in launch_counts().items() if v})
        (want, _), (got, launched) = runs["cpu"], runs[str(device)]
        rel = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        projs = [(nm, ls) for a, m in spec.layers for nm, ls in
                 a.projs + m.projs]
        kernel = {DEQUANT_OF[ls.kind] for _, ls in projs}
        err = 0.0
        for nm, ls in projs:
            w_dev = qlinear.dequant_weight(ls, p_dev["layers"][0][nm],
                                           p_dev.get("luts"))
            w_cpu = qlinear.dequant_weight(ls, p_cpu["layers"][0][nm],
                                           p_cpu.get("luts"))
            err = max(err, float((w_dev.cpu().float() - w_cpu.float())
                                 .abs().max()))
        out[qstr] = (rel, err)
        print(f"[off-palette] {qstr} at impl dequant, 1 layer: card vs CPU "
              f"rel={rel:.3e} (limit {SMALL_TOL}); card launches "
              f"{launched}; W-hat kernel vs plain max_abs_err={err:.3e} "
              f"(limit 0); {time.perf_counter() - t0:.1f} s", flush=True)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"off-palette {qstr}: non-finite logits")
        check(len(kernel) == 1 and launched == {kernel.pop(): 14},
              f"off-palette {qstr}: card launches {launched}, want 14 of "
              f"the kind's dequant kernel")
        check(err == 0.0, f"off-palette {qstr}: W-hat err {err}")
        check(rel <= SMALL_TOL, f"off-palette {qstr}: rel {rel}")
        del p_dev
    return out, off_palette_times(device)


# the dequant kernels' off-palette instances timed at 4096x4096 (phase 10d):
# K2 / K3 / K6 at the run-time KV of OFF_PALETTE's scheme, K7 at its
# run-time pair (kernel, mode, KVs), and K9 at the 10 (bits, vec) that no
# GEMV takes; beside each kernel, its instances of palette schemes at the
# same shape (K7 also at the flagship's 8/9)
OFF_PALETTE_TIMED = [("tcq2_dequant", "sum2", (3,)),
                     ("tcq1_dequant", "1mad", (6,)),
                     ("tcq_lut_dequant", None, (2,)),
                     ("tcomb_lut_dequant", None, (5, 7))]
PALETTE_TIMED = [("tcq2_dequant", "sum2", (6,)),
                 ("tcq1_dequant", "1mad", (3,)),
                 ("tcq_lut_dequant", None, (6,)),
                 ("tcomb_lut_dequant", None, (6, 7)),
                 ("tcomb_lut_dequant", None, (8, 9)),
                 ("vq_dequant", 2, (6,))]


def off_palette_times(device, shape=(4096, 4096)):
    """Each OFF_PALETTE_TIMED instance (and PALETTE_TIMED beside it) at
    `shape`, then K2 / K3 summed over the tcq2mix 512-token prefill's calls
    and K6 / K7 over the flagship prefill's (_dq_path_cases): ms a call
    (CUDA-graph replays, words cycled past L2), its bound (the packed
    words read once and the bf16 W-hat written once at 3.35 TB/s) and its
    share of it.  Returns {label: [ms, bound ms, off the palette?]}, a
    path's label "<wrapper> over the <path>'s <n> calls"."""
    from qpalette_tpu_torch.kernels import vq

    m, k = shape
    k9 = [("vq_dequant", v, (b,)) for b, v in vq.DEQUANT
          if (b, v) not in vq.SUPPORTED]
    out = {}

    def timed(run, m, k):
        wout = torch.empty((m, k), dtype=torch.bfloat16, device=device)
        return _time_ms(lambda i=0: run(i, wout), 50, graph=True)

    for off, cases in ((True, OFF_PALETTE_TIMED + k9),
                       (False, PALETTE_TIMED)):
        for kname, mode, KV in cases:
            if kname == "vq_dequant":
                bits, vec = KV[0], mode
                # a seeded stand-in codebook: the time does not depend on it
                gen = torch.Generator(device=device)
                gen.manual_seed(600 + 16 * bits + vec)
                lut = torch.randn((1 << bits, vec), generator=gen,
                                  device=device)
                nbytes = m * vq.row_words(k, bits, vec) * 4 + lut.numel() * 4
                n = min(64, -(-3 * L2_BYTES // nbytes))
                cp = [_vq_words(m, k, bits, vec, device, seed=100 + i)
                      for i in range(n)]
                label = f"vq_dequant bits={bits} vec={vec}"

                def run(i, o, cp=cp, lut=lut, bits=bits, vec=vec):
                    vq.vq_dequant(cp[i % len(cp)], lut, bits, vec, m, k,
                                  out=o)
                bms, _ = dequant_bound(nbytes, m, k)
            else:
                run, _, bms = dq_case(kname, mode, KV, m, k, device,
                                      cycled=True)
                label = (f"{kname} {mode or ''} "
                         f"KV={'/'.join(map(str, KV))}").replace("  ", " ")
            ms = timed(run, m, k)
            out[label] = [ms, bms, off]
            print(f"[time] {'off-palette' if off else 'palette'} {label} "
                  f"{m}x{k}: {ms:.4f} ms, bound {bms:.4f} ms "
                  f"({bms / ms:.1%} of it)", flush=True)
            del run
    for path, cases in _dq_path_cases().items():
        sums = {}
        for w, mode, KV, pm, pk, calls in cases:
            run, _, bms = dq_case(w, mode, KV, pm, pk, device, cycled=True)
            s = sums.setdefault(w, [0.0, 0.0, 0])
            s[0] += calls * timed(run, pm, pk)
            s[1] += calls * bms
            s[2] += calls
            del run
        for w, (ms, bms, n) in sums.items():
            label = f"{w} over the {path}'s {n} calls"
            out[label] = [ms, bms, False]
            print(f"[time] {label}: {ms:.4f} ms, bound {bms:.4f} ms "
                  f"({bms / ms:.1%} of it)", flush=True)
    return out

def small_model_checks(device):
    kvs = [dict(qkv=6, o=4, ug=6, down=8), dict(qkv=8, o=6, ug=4, down=6)]
    group = {"self_attn.q_proj": "qkv", "self_attn.k_proj": "qkv",
             "self_attn.v_proj": "qkv", "self_attn.o_proj": "o",
             "mlp.gate_proj": "ug", "mlp.up_proj": "ug",
             "mlp.down_proj": "down"}
    qdict = {f"{i}_{key}": f"tcq2s_{mix[g]}_none_0.9"
             for i, mix in enumerate(kvs) for key, g in group.items()}
    small_model_check(device, "215 mix (tcq2s, merged, a8)", qdict,
                      [["merge_qkv", "merge_ug"]] * 2, "a8", 4, 6, seed=3)
    # layers 0 and 1 of the flagship: tcq 6/8/10, tcomb 8/9, S 9/10/11;
    # 12 prompt tokens, so the prefill takes the dequant path
    with open(FLAGSHIP_QDICT) as f:
        flagship = json.load(f)
    small_model_check(device, "flagship mix (tcq/tcomb, unmerged, exact)",
                      flagship, None, "exact", 16, 12, seed=4)
    # tcq2mix with a 300-token prompt at exact: K2 (qkv, ug) and K3 (o,
    # down) in the prefill, K1 in the decode step
    small_model_check(device, "tcq2mix (tcq2 dualmad + tcq1 1mad, merged, "
                      "exact)", tcq2mix_qdict(2),
                      [["merge_qkv", "merge_ug"]] * 2, "exact", 4, 300,
                      seed=6)
    # Path C's mix: 12 prompt tokens take K9 and the head's plain product,
    # the decode step K8 and K10
    small_model_check(device, "Path C (ldlq_2_6, merged, rotated int8 head, "
                      "a8)", PATH_C_QSTR, [["merge_qkv", "merge_ug"]] * 2,
                      "a8", 8, 12, seed=7)


# Evaluation (runtime/evaluate.py, runtime/zeroshot.py): ctx-8192
# perplexity windows of the flagship at impl dequant (the reference's
# eval_qdict.py default, xla), and the zero-shot harness on the 215 model
# at impl exact (its pallas)
EVAL_CTX, EVAL_WINDOWS = 8192, 2
ATTN_TOL = 1e-5  # blockwise vs whole-logits attention, of max|out|
# ce_loss against the CE of the forward's own logits, absolute (the
# reference's bound for the same comparison, tests/test_model.py:289)
CE_TOL = 2e-3
# one loglikelihood against the sum of the full forward's log-softmax
LL_TOL = 1e-4
ZS_QUESTIONS, ZS_CHOICES = 8, 4
SMALL_CTX = 2560  # > 2048: S * T above 2^22, the blockwise attention


class ByteTok:
    """A byte-level stand-in for a Hugging Face tokenizer (the card's
    machine has none): Llama-3's BOS with special tokens, then each UTF-8
    byte + 1000."""

    class _Out(list):
        @property
        def input_ids(self):
            return list(self)

    def __call__(self, text, add_special_tokens=True):
        ids = [128000] if add_special_tokens else []
        return self._Out(ids + [1000 + b for b in text.encode()])


def zs_questions(seed=0):
    """ZS_QUESTIONS questions of 32-200 tokens (ByteTok) with ZS_CHOICES
    answers of 1-3 words each, from a seed."""
    rng = np.random.default_rng(seed)
    words = ["the", "river", "stone", "quietly", "red", "machine", "under",
             "seven", "glass", "winter", "carried", "light", "north", "of"]

    def text(n_chars):
        out = ""
        while len(out) < n_chars:
            out += (" " if out else "") + str(rng.choice(words))
        return out[:n_chars]

    return [{"query": text(int(rng.integers(31, 180))),
             "choices": [" " + text(int(rng.integers(3, 19)))
                         for _ in range(ZS_CHOICES)],
             "gold": int(rng.integers(0, ZS_CHOICES))}
            for _ in range(ZS_QUESTIONS)]


def zs_check(spec, params, device, card_label, label="215", calls=None):
    """The zero-shot harness on a model at impl exact: every prompt of
    33-200 tokens sends its rows to K1 above 8 rows (wide_gemv_kernel in
    every mode, two launches a call).  calls: {wrapper: K1 calls a
    forward} (default the 215 model's 129 sum2 calls, 128 exact layers
    and the a8 head); one loglikelihood against the sum of the forward's
    log-softmax.  Returns
    (launch counts, summary)."""
    from qpalette_tpu_torch.kernels import (arith, launch_counts,
                                            reset_launches)
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import zeroshot

    calls = calls or {"tcq2s_decode_gemv": LAUNCHES_PER_FORWARD}
    mode_of = {"tcq2s_decode_gemv": "sum2", "tcq2_decode_gemv": "dualmad",
               "tcq1_decode_gemv": "1mad"}
    spec = with_impl(spec, "exact")
    tok, questions = ByteTok(), zs_questions()
    lengths = [len(tok(q["query"]).input_ids)
               + len(tok(c, add_special_tokens=False).input_ids)
               for q in questions for c in q["choices"]]
    check(8 < min(lengths) and max(lengths) <= 256,
          f"zero-shot prompt lengths {min(lengths)}-{max(lengths)}")
    # warm-up: every prompt once, so that each kernel instance the run
    # takes is loaded and set up before the timed run
    zeroshot.eval_multiple_choice(spec, params, tok, questions)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = zeroshot.eval_multiple_choice(spec, params, tok, questions)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    n_fwd = len(lengths)
    want = {k: 0 for k in counts}
    for kname, n in calls.items():
        want[kname] = (n * arith.kernel_launches(mode_of[kname],
                                                 min(lengths)) * n_fwd)
    check(counts == want, f"{label} zero-shot launches {counts}, want "
          f"{want} ({calls} calls a forward x {n_fwd} forwards)")
    check(0 <= res["acc"] <= 1 and 0 <= res["acc_norm"] <= 1
          and res["n"] == ZS_QUESTIONS, f"zero-shot result {res}")
    q, c = questions[0]["query"], questions[0]["choices"][0]
    got, n_cont = zeroshot.loglikelihood(spec, params, tok, q, c)
    ids = tok(q).input_ids + tok(c, add_special_tokens=False).input_ids
    tokens = torch.as_tensor([ids], device=device)
    logp = torch.log_softmax(llama.forward(spec, params, tokens)[0, :-1],
                             dim=-1)
    tgt = tokens[0, 1:]
    want_ll = float(logp.gather(-1, tgt[:, None])[-n_cont:].sum())
    err = abs(got - want_ll)
    k1 = sum(counts[kname] for kname in calls)
    print(f"[zeroshot] {label} at exact: {ZS_QUESTIONS} questions x "
          f"{ZS_CHOICES} choices, prompts of {min(lengths)}-{max(lengths)} "
          f"tokens, {n_fwd} forwards in {dt:.2f} s ({ZS_QUESTIONS / dt:.2f} "
          f"examples/s, {n_fwd / dt:.2f} forwards/s); acc {res['acc']:.3f} "
          f"acc_norm {res['acc_norm']:.3f} (random weights); K1 {k1} "
          f"launches ({calls} calls a forward, N 9-256); loglikelihood "
          f"{got:.5f} against the forward's log-softmax {want_ll:.5f}: |err| "
          f"{err:.2e} (limit {LL_TOL:.0e}); card {card_label}", flush=True)
    check(err <= LL_TOL, f"loglikelihood {got} against {want_ll}")
    return counts, {"zs_seconds": dt, "zs_examples_s": ZS_QUESTIONS / dt,
                    "zs_k1_launches": {k: counts[k] for k in calls},
                    "zs_forwards": n_fwd, "zs_acc": res["acc"],
                    "zs_acc_norm": res["acc_norm"]}


def _ranged(label, fn):
    """fn inside a torch.profiler range named label."""
    from torch.profiler import record_function

    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def _device_us(event):
    """Device time of a CPU event and the ops under it (us)."""
    total = getattr(event, "device_time_total", None)
    return event.cuda_time_total if total is None else total


def profile_window(spec, params, tokens, card_label, want):
    """torch.profiler over one ce_loss window: device time by kind.  The
    attention, the f32 products of the dequant route (qlinear._product:
    the f32 copies of x and W_hat and the product) and the forward run
    inside ranges for the trace; the dequant kernels are named, and their
    ops must match want (the window's launches, dequant_ops_check); the
    head's CE is the window's device time outside the forward."""
    from torch.profiler import ProfilerActivity, profile

    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import evaluate, qlinear

    ranges = {"attention": (llama, "_attention"),
              "product": (qlinear, "_product"),
              "forward": (llama, "forward")}
    saved = {k: getattr(mod, name) for k, (mod, name) in ranges.items()}
    torch.cuda.synchronize()
    try:
        for k, (mod, name) in ranges.items():
            setattr(mod, name, _ranged(f"eval::{k}", saved[k]))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            evaluate.ce_loss(spec, params, tokens)
            torch.cuda.synchronize()
    finally:
        for k, (mod, name) in ranges.items():
            setattr(mod, name, saved[k])
    t0 = time.perf_counter()
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("eval::")]
    check(ops, "profiler: no device op in the trace of a window")
    dequant_ops_check("eval window", [e.name for e in ops], want)
    total = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    deq = sum(e.time_range.elapsed_us() for e in ops
              if PORT_DEQUANT.search(e.name)) / 1e3
    by = {k: sum(_device_us(e) for e in events
                 if e.name == f"eval::{k}" and e.device_type == cpu) / 1e3
          for k in ranges}
    kinds = {"dequant kernels": deq, "f32 copies and products of W_hat":
             by["product"], "attention": by["attention"],
             "head CE": total - by["forward"]}
    kinds["rest"] = total - sum(kinds.values())
    print(f"[eval] one ctx-{tokens.shape[1]} window, torch.profiler: device "
          f"{total:.1f} ms (ops summed, {len(ops)} device ops; trace read in "
          f"{time.perf_counter() - t0:.1f} s): " + ", ".join(
              f"{k} {v:.1f} ms ({v / total:.1%})" for k, v in kinds.items())
          + f"; card {card_label}", flush=True)
    return {"device_ms": total, "device_ops": len(ops), **{
        k.replace(" ", "_"): v for k, v in kinds.items()}}


def _count_flash():
    """A counting stand-in for llama._attention_flash; (calls, restore)."""
    from qpalette_tpu_torch.models import llama

    calls, real = [], llama._attention_flash

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    llama._attention_flash = counted

    def restore():
        llama._attention_flash = real
    return calls, restore


def ppl_check(spec, params, device, card_label):
    """ctx-8192 perplexity of the flagship at impl dequant over
    EVAL_WINDOWS windows of a synthetic stream from seed 0: ce_loss of the
    first window against the CE of the forward's own logits (which also
    warms the 8192-row shapes up before the timed run); a finite loss,
    194 K6 + 30 K7 a window, the blockwise attention in every layer;
    seconds a window, eval tokens/s, peak memory; the device time of a
    window by kind.  Returns (launch counts, summary)."""
    from qpalette_tpu_torch.kernels import launch_counts, reset_launches
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import evaluate

    spec = with_impl(spec, "dequant")
    nl = spec.config.num_layers
    V = spec.config.vocab_size
    stream = np.random.default_rng(0).integers(0, V, EVAL_WINDOWS * EVAL_CTX)
    want = {"tcq_lut_dequant": FLAGSHIP_TCQ, "tcomb_lut_dequant":
            FLAGSHIP_TCOMB}
    # the first window's ce_loss against the CE of forward's float32
    # logits (8192 x 128256, 4.2 GB)
    tokens = torch.as_tensor(stream[None, :EVAL_CTX], device=device)
    reset_launches()
    ce = float(evaluate.ce_loss(spec, params, tokens))
    one = launch_counts()
    zero = {k: 0 for k in one}
    check(one == {**zero, **want}, f"one window's launches {one}")
    logits = llama.forward(spec, params, tokens)[0, :-1]
    logp = torch.log_softmax(logits, dim=-1)
    del logits
    ref = float(-logp.gather(-1, tokens[0, 1:, None]).mean())
    del logp
    torch.cuda.empty_cache()
    print(f"[eval] window 0: ce_loss {ce:.6f}, CE of the forward's logits "
          f"{ref:.6f}, |diff| {abs(ce - ref):.2e} (limit {CE_TOL:.0e})",
          flush=True)
    check(abs(ce - ref) <= CE_TOL, f"ce_loss {ce} against {ref}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    flash, restore = _count_flash()
    try:
        reset_launches()
        t0 = time.perf_counter()
        ppl, avg = evaluate.eval_ppl(spec, params, stream, ctx_size=EVAL_CTX,
                                     progress=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated(device)
    check(counts == {**zero, **{k: v * EVAL_WINDOWS for k, v in
                                want.items()}},
          f"ppl launches {counts}, want {want} a window")
    check(len(flash) == nl * EVAL_WINDOWS,
          f"blockwise attention taken {len(flash)} times, want {nl} a "
          f"window")
    check(np.isfinite(avg) and np.isfinite(ppl), f"ppl {ppl} loss {avg}")
    n_tok = EVAL_WINDOWS * EVAL_CTX
    print(f"[eval] flagship ppl at impl dequant, ctx {EVAL_CTX}, "
          f"{EVAL_WINDOWS} windows: loss {avg:.4f}, ppl {ppl:.1f} (random "
          f"weights); {dt / EVAL_WINDOWS:.3f} s a window (host clock), "
          f"{n_tok / dt:.0f} eval tokens/s (after a warm window 0), peak "
          f"memory {peak / 1e9:.3f} GB; "
          f"{FLAGSHIP_TCQ} K6 + {FLAGSHIP_TCOMB} K7 a window, blockwise "
          f"attention in all {nl} layers; card {card_label}", flush=True)
    prof = profile_window(spec, params, tokens, card_label, want)
    return counts, {"ppl_window_s": dt / EVAL_WINDOWS,
                    "eval_tokens_s": n_tok / dt, "peak_gb": peak / 1e9,
                    "loss": avg, "ce_diff": abs(ce - ref), **prof}


def attention_checks(device):
    """The port's blockwise attention against its attention over the whole
    logits at the 8B's heads, float32 inputs: S = T = 4096 from offset 0,
    and S = 2048 over T = 4096 from offset 2048 (whole KV chunks
    pruned)."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama31_8b()
    H, hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    worst = 0.0
    for S, T, offset in ((4096, 4096, 0), (2048, 4096, 2048)):
        gen = torch.Generator(device=device)
        gen.manual_seed(S + offset)
        q, k, v = (torch.randn((1, n, h, D), generator=gen, device=device)
                   for n, h in ((S, H), (T, hk), (T, hk)))
        got = llama._attention_flash(q, k, v, offset, cfg)
        want = llama._attention_whole(q, k, v, offset, cfg)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        worst = max(worst, rel)
        print(f"[eval] blockwise attention S={S} T={T} offset {offset} "
              f"against the whole logits: rel {rel:.3e} (limit "
              f"{ATTN_TOL:.0e})", flush=True)
        check(rel <= ATTN_TOL, f"blockwise attention S={S} T={T}: {rel}")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return worst


def small_ce_check(device):
    """A 2-layer model with the flagship's mix at impl dequant over a
    ctx-SMALL_CTX window (blockwise attention): the CPU (plain versions)
    against the card (kernels), the forward's logits within SMALL_TOL of
    max|logit| and ce_loss within SMALL_TOL relative.  Returns the larger
    of the two."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime import evaluate
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    with open(FLAGSHIP_QDICT) as f:
        flagship = json.load(f)
    spec, p_cpu = build_quantized_model(
        LlamaConfig(**SMALL_CFG), flagship, dummy=True, impl="dequant",
        lm_head_bits=16, seed=8, device="cpu")
    p_dev = to_device(p_cpu, device)
    tokens = np.random.default_rng(9).integers(0, 512, (1, SMALL_CTX))
    flash, restore = _count_flash()
    out, logits = [], []
    try:
        for dev, p in (("cpu", p_cpu), (device, p_dev)):
            tok = torch.as_tensor(tokens, device=dev)
            out.append(float(evaluate.ce_loss(spec, p, tok)))
            with torch.inference_mode():
                logits.append(llama.forward(spec, p, tok).cpu())
    finally:
        restore()
    rel = abs(out[0] - out[1]) / abs(out[0])
    rel_l = ((logits[0] - logits[1]).abs().max()
             / logits[0].abs().max()).item()
    print(f"[eval] 2-layer flagship mix, ctx {SMALL_CTX}, dequant: logits "
          f"card vs CPU plain rel {rel_l:.3e} of max|logit| (limit "
          f"{SMALL_TOL}); ce_loss CPU plain {out[0]:.6f}, card "
          f"{out[1]:.6f}, rel {rel:.3e} (limit {SMALL_TOL}); blockwise "
          f"attention {len(flash)} times", flush=True)
    check(len(flash) == 2 * 2 * 2, f"blockwise attention {len(flash)} times")
    check(rel_l <= SMALL_TOL, f"small logits rel {rel_l}")
    check(rel <= SMALL_TOL, f"small ce_loss rel {rel}")
    return max(rel, rel_l)


REPLACES = "qpalette_tpu/kernels/fused.py:"
# --- 13. quantization: the port's quantizers on the card -------------------

QUANT_QDIR = os.path.join(ROOT, "msq_results", "3_8b", "lat_constrained",
                          "h100", "default_err")
QUANT_QDICT = "108.5thp_cc"
# step 1: schemes quantized at 4096^2 against assets/quant_err.json, and
# the dequant kernel that decodes their words
QUANT_PROXY = (("tcq_6_none_0.9", "tcq_lut_dequant"),
               ("tcomb_6_7_0.5_none_0.9", "tcomb_lut_dequant"),
               ("tcq2s_6_none_0.9", "tcq2_dequant"),
               ("ldlq_2_8_none_1.0", "vq_dequant"))
PROXY_TOL = 0.01  # relative, against the committed table
PROXY_SIZE = 4096
# table entries the reference measured on its TPU, whose default float32
# dot takes bf16 operands: the quantizer runs again with the cross term's
# operands so rounded (viterbi._cross_operands replaced) and that run is
# held to the entry (tests/test_torch_viterbi.py holds the rounding to the
# reference's at 256^2); the float32 run is held to the port's own value
# (NVIDIA H100 80GB HBM3, three runs equal to the last digit) within
# PORT_ERR_TOL
TABLE_CROSS = {"tcq2s_6_none_0.9": torch.bfloat16}
PORT_F32_ERR = {"tcq2s_6_none_0.9": 0.019430797547101974}
PORT_ERR_TOL = 1e-3  # relative, the CPU parity tests' PROXY_TOL
QUANT_TCQ1 = ("tcq1_3_none_0.9", 1024, 4096)  # step 2: K3, V=1 k-major
QUANT_PROMPT, QUANT_STEPS = 16, 2

# layer 0 of the H100 qdict (tcq_10 qkv merged, ldlq o / down / ug merged)
# through the model: the prefill's launches and each decode forward's
QUANT_PREFILL = {"tcq_lut_dequant": 1, "vq_dequant": 3}
QUANT_STEP = {"tcq_lut_gemv": 1, "vq_gemv": 3, "int8_gemv_a8": 1}
# layer 0's projections through their kernels (N = 1: K4, K8; N = 16: the
# prefill's K6, K9 dequant route) against x W-hat^T in float32, of its
# max; x W^T (unquantized) must be beyond it.  On an H100 the first read
# 2.6-3.9e-3 (bf16 x and y) and the second 7.3e-2 to 4.5e-1
QUANT_PROJ_ROWS = (1, QUANT_PROMPT)
QUANT_PROJ_TOL = 1e-2
_Q, _K, _V = "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"
_UP, _GATE = "mlp.up_proj", "mlp.gate_proj"
PROJ_PARTS = {"q": (_Q,), "k": (_K,), "v": (_V,), "qkv": (_Q, _K, _V),
              "qk": (_Q, _K), "kv": (_K, _V), "qv": (_Q, _V),
              "o": ("self_attn.o_proj",), "up": (_UP,), "gate": (_GATE,),
              "ug": (_UP, _GATE), "down": ("mlp.down_proj",)}
PROJ_SU = {"o": "su_o", "up": "su_ug", "gate": "su_ug", "ug": "su_ug",
           "down": "su_dp"}  # the rest: su_qkv
HESS_BATCHES, HESS_CTX = 8, 512
QUANT_HESS = (("self_attn.q_proj", "qkv", "tcq_10_hess_0.9"),
              ("mlp.down_proj", "down", "ldlq_1_4_hess_1.0"))


def _sync_s(t0):
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def viterbi_bound_ms(B, S, KV):
    """The least time of one viterbi_encode of B sequences of S states:
    each of its S - 1 steps reads and writes the (B, 2^16) float32 cost
    once and writes the step's backpointers (a byte each up to KV 8, else
    four), over the HBM rate."""
    per_step = 2 * B * (1 << 16) * 4 + B * (1 << (16 - KV)) * (
        1 if KV <= 8 else 4)
    return (S - 1) * per_step / HBM_BYTES_S * 1e3


@contextlib.contextmanager
def dp_timed():
    """Inside the block viterbi.viterbi_encode runs between two CUDA
    events a call; yields a dict that gains, on exit, the calls, their
    device ms summed and their bounds summed (viterbi_bound_ms of each
    call's shape)."""
    from qpalette_tpu_torch.quant import viterbi

    encode, calls, res = viterbi.viterbi_encode, [], {}

    def timed(X, lut, KV, init_c=None, final_c=None, v=viterbi.V):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        states = encode(X, lut, KV, init_c, final_c, v)
        ev[1].record()
        B, S = X.shape[0], X.shape[1] // v
        calls.append((ev, viterbi_bound_ms(B, S, KV)))
        return states

    viterbi.viterbi_encode = timed
    try:
        yield res
    finally:
        viterbi.viterbi_encode = encode
        torch.cuda.synchronize()
        res.update(calls=len(calls),
                   ms=sum(a.elapsed_time(b) for (a, b), _ in calls),
                   bound_ms=sum(bound for _, bound in calls))


def _dp_note(dp):
    return (f"the DP {dp['ms'] / 1e3:.2f} s in {dp['calls']} viterbi_encode "
            f"calls, bound {dp['bound_ms'] / 1e3:.2f} s "
            f"({dp['bound_ms'] / dp['ms']:.1%})" if dp["calls"] else "no DP")


def w_hat(art, device, hat_r=None):
    """W-hat (m, n) float32 in W's frame: the rotated, row-normalised
    estimate (hat_r, or the f32 decode of the artifact's words, which is
    the quantizer's own W-hat: the codebook values at its codes) times
    Wscale, rotated back, times SU."""
    from qpalette_tpu_torch.ops import packing
    from qpalette_tpu_torch.ops.codebooks import trellis_lut
    from qpalette_tpu_torch.ops.hadamard import hadamard_transform_t

    meta = art["meta"]
    m, n = meta["out_features"], meta["in_features"]
    if hat_r is None:
        if meta["kind"] == "tcq":
            hat_r = packing.dequant_tcq(
                packing.words_to_torch(art["trellis"], device),
                trellis_lut(meta["tlut_bits"]).to(device), m, n, meta["KV"])
        elif meta["kind"] == "vq":
            hat_r = packing.dequant_lut(
                packing.words_to_torch(art["qweight"], device),
                torch.tensor(art["lut"], device=device), m, n, meta["bits"],
                meta["vec"])
        else:
            raise ValueError(meta["kind"])
    wscale = torch.tensor(art["Wscale"], device=device)
    su = torch.tensor(art["SU"], device=device)
    return hadamard_transform_t(hat_r * wscale[:, None]) * su[None, :]


def quant_proxy(device, card_label):
    """Steps 1-2: each QUANT_PROXY scheme quantizes the 4096^2 N(0, 1)
    matrix of numpy seed 0 (err_tables.proxy_quantize) within PROXY_TOL of
    assets/quant_err.json; its words, decoded by the scheme's dequant
    kernel, equal the quantizer's own W-hat in bf16 (and their f32 plain
    decode equals it exactly); tcq2s_6's words also through K1 sum2 at
    N = 1 within TOL of max|y|.  tcq1_3 at 1024 x 4096 through K3.
    Returns ({wrapper: max_abs_err}, summary)."""
    from qpalette_tpu_torch.kernels import (arith, arith_dequant, tcq_lut,
                                            vq)
    from qpalette_tpu_torch.msq.err_tables import proxy_quantize
    from qpalette_tpu_torch.ops import packing
    from qpalette_tpu_torch.ops.codebooks import (trellis_lut_arith,
                                                  trellis_tlut, vq_lut)
    from qpalette_tpu_torch.quant import quantizers, viterbi
    from qpalette_tpu_torch.quant.incoherent import (codebook_rms,
                                                     parse_quantizer_str)

    with open(os.path.join(ROOT, "assets", "quant_err.json")) as f:
        table = json.load(f)
    err, out = {}, {}
    for qstr, kname in QUANT_PROXY:
        t0 = time.perf_counter()
        with dp_timed() as dp:
            e, lin, hat = proxy_quantize(qstr, PROXY_SIZE, 0, device)
        dt = _sync_s(t0)
        want = table[qstr]
        print(f"[quant] {qstr} at {PROXY_SIZE}^2: proxy err {e:.6f}, table "
              f"{want:.6f} ({(e - want) / want:+.3%}); {dt:.2f} s, "
              f"{_dp_note(dp)} ({card_label})", flush=True)
        out[qstr] = {"proxy_err": e, "table": want, "s": dt, "dp": dp}
        held = e
        if qstr in TABLE_CROSS:
            own = PORT_F32_ERR[qstr]
            check(abs(e - own) <= PORT_ERR_TOL * own,
                  f"{qstr}: float32 proxy err {e} against the port's {own}")
            dtype = TABLE_CROSS[qstr]
            cross = viterbi._cross_operands
            viterbi._cross_operands = lambda X, T: (
                X.to(dtype).to(torch.float32), T.to(dtype).to(torch.float32))
            try:
                held = proxy_quantize(qstr, PROXY_SIZE, 0, device)[0]
            finally:
                viterbi._cross_operands = cross
            out[qstr]["proxy_err_table_precision"] = held
            print(f"[quant] {qstr}: float32 {e:.6f}, the port's recorded "
                  f"{own:.6f} ({(e - own) / own:+.4%}, limit "
                  f"{PORT_ERR_TOL:.0e}); with the cross term's operands in "
                  f"{dtype} (the table's precision) {held:.6f} "
                  f"({(held - want) / want:+.3%} of the table)", flush=True)
        check(abs(held - want) <= PROXY_TOL * want,
              f"{qstr}: proxy err {held} against the table's {want}")
        words = {k: packing.words_to_torch(v, device) for k, v in lin.items()
                 if isinstance(v, np.ndarray)}
        m = k = PROXY_SIZE
        if lin["kind"] in ("tcq", "tcomb"):
            tlut = torch.tensor(trellis_tlut(lin["tlut_bits"]), device=device)
            lut = tcq_lut.expand_tlut(tlut)
        if lin["kind"] == "tcq":
            got = tcq_lut.tcq_lut_dequant(words["trellis"], tlut, lin["KV"],
                                          m, k)
            plain = packing.dequant_tcq(words["trellis"], lut, m, k,
                                        lin["KV"])
        elif lin["kind"] == "tcomb":
            got = tcq_lut.tcomb_lut_dequant(words["trellis1"],
                                            words["trellis2"], tlut,
                                            lin["KV1"], lin["KV2"], m, k)
            plain = torch.cat([
                packing.dequant_tcq(words["trellis1"], lut, m, k // 2,
                                    lin["KV1"]),
                packing.dequant_tcq(words["trellis2"], lut, m, k // 2,
                                    lin["KV2"])], dim=1)
        elif lin["kind"] == "tcq2":
            got = arith_dequant.tcq2_dequant(words["trellis"], lin["KV"], m,
                                             k, lin["decode_mode"])
            plain = packing.dequant_tcq2(
                words["trellis"],
                trellis_lut_arith(lin["decode_mode"]).to(device), m, k,
                lin["KV"])
            x = torch.randn((1, k), generator=torch.Generator(
                device=device).manual_seed(5), device=device).to(
                torch.bfloat16)
            y = arith.tcq2s_decode_gemv(x, words["trellis"], lin["KV"], m, k,
                                        False)
            err["tcq2s_decode_gemv"] = _rel_check(
                f"K1 sum2 N=1 on {qstr}'s words", y, x.float() @ hat.T,
                TOL[False])
        else:
            lut = torch.tensor(vq_lut(lin["bits"], lin["vec"]),
                               device=device)
            got = vq.vq_dequant(words["qweight"], lut, lin["bits"],
                                lin["vec"], m, k)
            plain = packing.dequant_lut(words["qweight"], lut, m, k,
                                        lin["bits"], lin["vec"])
        check(torch.equal(plain, hat), f"{qstr}: the f32 decode of its "
              f"words is not the quantizer's W-hat")
        check(torch.equal(got, hat.to(torch.bfloat16)),
              f"{kname} on {qstr}'s words differs from W-hat in bf16")
        err[kname] = 0.0
        print(f"[quant] {kname} on {qstr}'s words = the quantizer's W-hat "
              f"in bf16", flush=True)
    qstr, m, k = QUANT_TCQ1
    spec = parse_quantizer_str(qstr)
    sc = torch.tensor(spec.scale_override * codebook_rms(spec),
                      device=device)
    W = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (m, k)).astype(np.float32), device=device)
    t0 = time.perf_counter()
    with dp_timed() as dp:
        lin, hat = quantizers.quantize_mat_tcq1(W * sc, None, spec.KV[0],
                                                mode="1mad")
    dt = _sync_s(t0)
    words = packing.words_to_torch(lin["trellis"], device)
    got = arith_dequant.tcq1_dequant(words, spec.KV[0], m, k, "1mad")
    check(torch.equal(got, hat.to(torch.bfloat16)),
          f"K3 on {qstr}'s words differs from W-hat in bf16")
    err["tcq1_dequant"] = 0.0
    print(f"[quant] {qstr} at {m}x{k} in {dt:.2f} s, {_dp_note(dp)}; K3 on "
          f"its words = the quantizer's W-hat in bf16 ({card_label})",
          flush=True)
    out[f"{qstr} {m}x{k}"] = {"s": dt, "dp": dp}
    return err, out


def write_checkpoint(path, cfg, dense):
    """A local Hugging Face checkpoint of dense (random_dense_params'
    layout): config.json and one float32 safetensors file."""
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
                   "rms_norm_eps": cfg.rms_eps,
                   "tie_word_embeddings": cfg.tie_embeddings,
                   "torch_dtype": "float32",
                   "architectures": ["LlamaForCausalLM"]}, f)
    t = {"model.embed_tokens.weight": dense["embed"],
         "lm_head.weight": dense["lm_head"],
         "model.norm.weight": dense["ln_f"]}
    for i, lp in enumerate(dense["layers"]):
        for key, w in lp.items():
            name = {"ln_attn": "input_layernorm",
                    "ln_mlp": "post_attention_layernorm"}.get(key, key)
            t[f"model.layers.{i}.{name}.weight"] = w
    save_file(t, os.path.join(path, "model.safetensors"))


def _quantize_layer_cli(ckpt, qpath, save_dir, device):
    """python -m qpalette_tpu_torch.quantize_layer on layer 0: its stdout
    and seconds."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "qpalette_tpu_torch.quantize_layer",
         "--model", ckpt, "--qdict_path", qpath, "--num_layers", "1",
         "--save_dir", save_dir, "--device", str(device)], cwd=ROOT,
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    check(res.returncode == 0, f"quantize_layer failed ({res.returncode}):\n"
          f"{res.stdout}{res.stderr}")
    return res.stdout, time.perf_counter() - t0


def _same_artifacts(a_dir, b_dir):
    """Every artifact under a_dir is under b_dir with bit-equal arrays and
    the same meta: the number compared."""
    from qpalette_tpu_torch.quant.incoherent import load_artifact

    files = sorted(os.path.relpath(os.path.join(r, f), a_dir)
                   for r, _, fs in os.walk(a_dir) for f in fs)
    for f in files:
        a = load_artifact(os.path.join(a_dir, f))
        b = load_artifact(os.path.join(b_dir, f))
        check(a.keys() == b.keys(), f"{f}: {sorted(a)} != {sorted(b)}")
        for k in a:
            if k == "meta":
                check(a[k] == b[k], f"{f}: meta {a[k]} != {b[k]}")
            else:
                check(np.array_equal(a[k], b[k]), f"{f}: {k} differs")
    return len(files)


def _dense_f32(cfg, weights, dense, qparams, device):
    """The 1-layer dense model of weights ({key: (m, n) float32}) kept in
    float32 (the dense forward's product is z.float() @ w.float().T), with
    dense's embed and norms and qparams' int8 head."""
    from qpalette_tpu_torch.runtime.loader import build_dense_model

    names = {"self_attn.q_proj": "q", "self_attn.k_proj": "k",
             "self_attn.v_proj": "v", "self_attn.o_proj": "o",
             "mlp.up_proj": "up", "mlp.gate_proj": "gate",
             "mlp.down_proj": "down"}
    spec, params = build_dense_model(
        cfg, {**dense, "layers": [{**dense["layers"][0], **weights}]},
        device=device)
    for key, nm in names.items():
        params["layers"][0][nm]["w"] = torch.as_tensor(
            np.asarray(weights[key], np.float32), device=device)
    params.pop("lm_head")
    for k in ("lm_head_q", "lm_head_s", "lm_head_su"):
        params[k] = qparams[k]
    return spec, params


def _projection_rels(spec, params, refs, rows, device):
    """Each projection of layer 0 (a merged group whole) through
    qlinear_apply, so through its kernel at `rows` rows, on a bf16 N(0, 1)
    x (seed 0), against x @ W^T in float32 for each refs {what: {key:
    (m, n) float32}}: {f"{name} N={rows}": {what: max|y - x W^T| over
    max|x W^T|}}."""
    from qpalette_tpu_torch.runtime.qlinear import qlinear_apply

    aspec, mspec = spec.layers[0]
    lp = params["layers"][0]
    out = {}
    for name, lspec in aspec.projs + mspec.projs:
        x = torch.randn((rows, lspec.in_features), generator=torch.Generator(
            device=device).manual_seed(0), device=device).to(torch.bfloat16)
        y = qlinear_apply(lspec, lp[name], x, pre_rot=lp[PROJ_SU.get(
            name, "su_qkv")], luts=params.get("luts")).float()
        res = {}
        for what, weights in refs.items():
            w = torch.cat([torch.as_tensor(np.asarray(weights[k], np.float32),
                                           device=device)
                           for k in PROJ_PARTS[name]])
            want = x.float() @ w.T
            res[what] = ((y - want).abs().max() / want.abs().max()).item()
        out[f"{name} N={rows}"] = res
    return out


def _teacher_forced(spec, params, tokens, steps):
    """Logits of a prefill of tokens (1, S) and of `steps` decode forwards
    fed the argmax of the previous ones (or, given a (1, S + steps) token
    row, those tokens): (list of logits, the token row used, the launch
    counts of the prefill and of each decode forward)."""
    from qpalette_tpu_torch.kernels import launch_counts, reset_launches
    from qpalette_tpu_torch.models import llama

    S = QUANT_PROMPT
    caches = llama.init_kv_caches(spec, 1, S + steps + 1,
                                  params["embed"].device)
    reset_launches()
    logits, caches = llama.forward(spec, params, tokens[:, :S],
                                   kv_caches=caches, cache_pos=0)
    counts, outs, row = [launch_counts()], [logits], tokens
    for i in range(steps):
        if row.shape[1] <= S + i:
            row = torch.cat([row, logits[:, -1].argmax(-1)[:, None]], dim=1)
        logits, caches = llama.forward(spec, params, row[:, S + i:S + i + 1],
                                       kv_caches=caches, cache_pos=S + i)
        counts.append(launch_counts())
        outs.append(logits)
    torch.cuda.synchronize()
    return outs, row, counts


def quant_model(device, card_label):
    """Steps 3-5: the quantize_layer entry point on layer 0 of a 1-layer
    Llama-3.1-8B checkpoint (random_dense_params, seed 0) with the H100
    qdict (7 artifacts, then a second run that skips them); the model
    from them (K4 on the merged tcq_10 qkv, K8 on o, down and the merged
    ug, K10 on the rotated int8 head) against the dense model of the
    quantizers' own W-hat (SMALL_TOL), its launches in a counted run and
    at capture; the loader quantizing the same into an empty save_dir
    (bit-equal artifacts); Hessians over 8 x 512 synthetic tokens and
    the _hess_ schemes of q and down against their _none_ artifacts by
    tr(E H E^T).  Returns (the counted run's launches, summary)."""
    import tempfile

    from qpalette_tpu_torch.models.hf_weights import load_dense_params
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.quant.hessian import (collect_hessians,
                                                  err_coeffs_from_hessians)
    from qpalette_tpu_torch.quant.incoherent import (artifact_path,
                                                     load_artifact,
                                                     quantize_linear)
    from qpalette_tpu_torch.runtime import decode
    from qpalette_tpu_torch.runtime.loader import (LAYER_KEYS,
                                                   build_dense_model,
                                                   build_quantized_model,
                                                   random_dense_params,
                                                   su_for)

    out = {}
    cfg = dataclasses.replace(LlamaConfig.llama31_8b(), num_layers=1)
    qpath = os.path.join(QUANT_QDIR, f"{QUANT_QDICT}.json")
    with open(qpath) as f:
        qdict = {k: v[0] for k, v in json.load(f).items()
                 if k.startswith("0_")}
    with open(os.path.join(QUANT_QDIR, f"{QUANT_QDICT}_merge_info.json")) as f:
        merge = json.load(f)[:1]
    with open(os.path.join(ROOT, "assets", "quant_err.json")) as f:
        table = json.load(f)
    tmp = tempfile.mkdtemp(prefix="qpt_quant_")
    try:
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "ckpt")
        write_checkpoint(ckpt, cfg, random_dense_params(cfg, seed=0))
        out["checkpoint_s"] = time.perf_counter() - t0
        save = os.path.join(tmp, "quant")
        log, out["quantize_layer_s"] = _quantize_layer_cli(ckpt, qpath, save,
                                                           device)
        check(log.count("quantizing ") == 7 and "skip" not in log,
              f"quantize_layer wrote {log.count('quantizing ')} of 7:\n{log}")
        for line in log.splitlines():
            if "err=" in line:
                print(f"[quant] quantize_layer: {line.strip()}", flush=True)
        errs = {}
        for key in LAYER_KEYS:
            art = load_artifact(artifact_path(save, "custom", 0,
                                              qdict[f"0_{key}"], 0, key))
            errs[key] = art["meta"]["err"]
            print(f"[quant] layer 0 {key} {qdict[f'0_{key}']}: err "
                  f"{art['meta']['err']:.6f}, the table's "
                  f"{table[qdict[f'0_{key}']]:.6f}", flush=True)
        log, out["quantize_layer_resume_s"] = _quantize_layer_cli(
            ckpt, qpath, save, device)
        check(log.count("skip ") == 7 and "quantizing" not in log,
              f"the second quantize_layer run did not skip all 7:\n{log}")
        print(f"[quant] quantize_layer: 7 artifacts in "
              f"{out['quantize_layer_s']:.1f} s (the process included), a "
              f"second run skipped all 7 in "
              f"{out['quantize_layer_resume_s']:.1f} s ({card_label})",
              flush=True)
        out["layer0_err"] = errs

        # step 4: the model from those artifacts
        dense = load_dense_params(ckpt)
        t0 = time.perf_counter()
        spec, params = build_quantized_model(
            cfg, qdict, merge_info=merge, dummy=False, dense_params=dense,
            num_layers=1, lm_head_bits=8, impl="exact", model_key="custom",
            save_dir=save, device=device)
        out["build_s"] = _sync_s(t0)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, QUANT_PROMPT)), device=device)
        logits, row, counts = _teacher_forced(spec, params, tokens,
                                              QUANT_STEPS)
        zero = {k: 0 for k in counts[0]}
        check(counts[0] == {**zero, **QUANT_PREFILL},
              f"quant: prefill launches {counts[0]}")
        for a, b in zip(counts, counts[1:]):
            step = {k: b[k] - a[k] for k in b}
            check(step == {**zero, **QUANT_STEP},
                  f"quant: decode launches per forward {step}")
        launches = counts[-1]
        for k in launches:
            STEP_LAUNCHES[k] = (STEP_LAUNCHES.get(k, 0) + launches[k]
                                - counts[0][k])
        step = decode.captured_step(spec, params, 1,
                                    QUANT_PROMPT + QUANT_STEPS + 1, 0.0, 5)
        check(step.launches == QUANT_STEP,
              f"quant: launches at capture {step.launches}")
        decode.release_captured(params)
        hat = {k: w_hat(load_artifact(artifact_path(
            save, "custom", 0, qdict[f"0_{k}"], 0, k)), device).cpu().numpy()
            for k in LAYER_KEYS}
        refs = {"W-hat": hat, "W": dense["layers"][0]}
        rels = {}
        for what, weights in refs.items():
            dspec, dparams = _dense_f32(cfg, weights, dense, params, device)
            want, _, _ = _teacher_forced(dspec, dparams, row, QUANT_STEPS)
            rels[what] = [((a - b).abs().max() / b.abs().max()).item()
                          for a, b in zip(logits, want)]
            del dparams
        check(max(rels["W-hat"]) <= SMALL_TOL, f"quant: logits against the "
              f"dense model of W-hat, rel {rels['W-hat']}")
        check(min(rels["W"]) > SMALL_TOL, f"quant: logits of the dense "
              f"model of W (unquantized) within {SMALL_TOL}, rel {rels['W']}")
        print(f"[quant] layer-0 model (built in {out['build_s']:.1f} s): "
              f"prefill {QUANT_PROMPT} {QUANT_PREFILL}, {QUANT_STEPS} decode "
              f"forwards {QUANT_STEP} each, the same at capture; logits "
              f"against the float32 dense model of W-hat rel "
              + ", ".join(f"{r:.2e}" for r in rels["W-hat"])
              + f" (limit {SMALL_TOL:.0e}), of W (unquantized) "
              + ", ".join(f"{r:.2e}" for r in rels["W"])
              + f" ({card_label})", flush=True)
        proj = {}
        for rows in QUANT_PROJ_ROWS:
            proj.update(_projection_rels(spec, params, refs, rows, device))
        for name, r in proj.items():
            check(r["W-hat"] <= QUANT_PROJ_TOL < r["W"], f"quant: {name} "
                  f"against x W-hat^T {r['W-hat']}, x W^T {r['W']} (limit "
                  f"{QUANT_PROJ_TOL})")
        print("[quant] layer 0's projections against x W-hat^T in float32 "
              "(and x W^T), of its max: "
              + "; ".join(f"{k} {r['W-hat']:.2e} ({r['W']:.2e})"
                          for k, r in proj.items())
              + f" (limit {QUANT_PROJ_TOL:.0e}; {card_label})", flush=True)
        out["logits_rel"] = rels
        out["projection_rel"] = proj
        del params
        torch.cuda.empty_cache()
        save2 = os.path.join(tmp, "on_demand")
        t0 = time.perf_counter()
        with dp_timed() as dp:
            spec, params = build_quantized_model(
                cfg, qdict, merge_info=merge, dummy=False,
                dense_params=dense, num_layers=1, lm_head_bits=8,
                impl="exact", model_key="custom", save_dir=save2,
                device=device)
        out["on_demand_s"] = _sync_s(t0)
        out["on_demand_dp"] = dp
        n = _same_artifacts(save, save2)
        check(n == 7, f"on demand: {n} artifacts")
        print(f"[quant] an empty save_dir: the loader quantized layer 0 on "
              f"demand in {out['on_demand_s']:.1f} s ({_dp_note(dp)}: q, k "
              f"and v at tcq_10), its 7 artifacts bit-equal to "
              f"quantize_layer's ({card_label})", flush=True)
        del params
        torch.cuda.empty_cache()

        # step 5: Hessians, and the _hess_ schemes against the _none_ ones
        wspec, wparams = build_dense_model(cfg, dense, device=device)
        rng = np.random.default_rng(0)
        batches = [rng.integers(0, cfg.vocab_size, (1, HESS_CTX))
                   for _ in range(HESS_BATCHES)]
        t0 = time.perf_counter()
        H = collect_hessians(wspec, wparams, batches)
        out["hessians_s"] = _sync_s(t0)
        del wparams
        coeffs = err_coeffs_from_hessians(H, dense, 1)
        print(f"[quant] Hessians over {HESS_BATCHES} x {HESS_CTX} tokens in "
              f"{out['hessians_s']:.2f} s: "
              + ", ".join(f"{k} {v.shape}" for k, v in H.items())
              + "; err_coeffs_from_hessians "
              + json.dumps({k: round(v, 6) for k, v in coeffs.items()})
              + f" ({card_label})", flush=True)
        out["err_coeffs"] = coeffs
        for key, group, qstr in QUANT_HESS:
            W = torch.as_tensor(dense["layers"][0][key], device=device)
            Hg = torch.as_tensor(H[f"0_{group}"], device=device)
            t0 = time.perf_counter()
            with dp_timed() as dp:
                art, hat_r = quantize_linear(
                    dense["layers"][0][key], qstr, SU=su_for(cfg, 0, key, 0),
                    H=H[f"0_{group}"], device=device, return_hat=True)
            dt = _sync_s(t0)
            none = load_artifact(artifact_path(save, "custom", 0,
                                               qdict[f"0_{key}"], 0, key))
            tr = {}
            for name, Wh in (("hess", w_hat(art, device, hat_r)),
                             ("none", w_hat(none, device))):
                E = W - Wh
                tr[name] = torch.trace(E @ Hg @ E.T).item()
            check(tr["hess"] < tr["none"], f"{qstr}: tr(E H E^T) "
                  f"{tr['hess']} not below {qdict[f'0_{key}']}'s {tr['none']}")
            print(f"[quant] {key} {qstr} in {dt:.2f} s, {_dp_note(dp)}: "
                  f"tr(E H E^T) "
                  f"{tr['hess']:.6g} against {qdict[f'0_{key}']}'s "
                  f"{tr['none']:.6g} ({tr['hess'] / tr['none']:.3f}x; "
                  f"{card_label})", flush=True)
            out[qstr] = {"s": dt, "dp": dp, "trEHE": tr["hess"],
                         "trEHE_none": tr["none"]}
        del H, Hg
        torch.cuda.empty_cache()
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, out


def quant_path(device, card_label):
    """Phase 13, the quantizers on the card: quant_proxy, then
    quant_model.  Returns (the counted run's launches, {wrapper:
    max_abs_err}, summary)."""
    t0 = time.perf_counter()
    err, proxy = quant_proxy(device, card_label)
    launches, model = quant_model(device, card_label)
    summary = {"card": card_label, "proxy": proxy, "layer0": model,
               "s": time.perf_counter() - t0}
    return launches, err, summary


def quant_only():
    """Phase 13 alone (--quant)."""
    _, _, smi = card()
    build_all()
    _, _, summary = quant_path(torch.device("cuda:0"), smi)
    print("[quant] " + json.dumps(summary), flush=True)


KERNEL_INFO = {  # name: (source, the TPU kernel body it replaces)
    "tcq2s_decode_gemv": ("tcq2_gemv.cu", REPLACES + "508"),
    "tcq2_decode_gemv": ("tcq2_gemv.cu", REPLACES + "508"),
    "tcq1_decode_gemv": ("tcq1_gemv.cu", REPLACES + "508"),
    "tcq2_dequant": ("arith_dequant.cu", REPLACES + "902"),
    "tcq1_dequant": ("arith_dequant.cu", REPLACES + "1007"),
    "tcq_lut_gemv": ("tcq_lut.cu", REPLACES + "253"),
    "tcomb_lut_gemv": ("tcq_lut.cu", REPLACES + "314"),
    "tcq_lut_dequant": ("tcq_lut.cu", REPLACES + "1083"),
    "tcomb_lut_dequant": ("tcq_lut.cu", REPLACES + "1089"),
    "vq_gemv": ("vq.cu", REPLACES + "133"),
    "vq_dequant": ("vq.cu", REPLACES + "1179"),
    "int8_gemv_a8": ("int8_gemv.cu", REPLACES + "1401"),
    "int8_gemv": ("int8_gemv.cu", REPLACES + "1394"),
}


def timed(name, fn, *args):
    """fn(*args), its seconds printed as a [time] line."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name} {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    t_start = time.perf_counter()
    name, count, smi = card()
    temp_assets()
    from qpalette_tpu_torch.kernels import (arith, arith_dequant, int8_gemv,
                                            tcq_lut, vq, wrappers)
    from qpalette_tpu_torch.models.llama import LlamaConfig

    timed("2 build", build_all)
    device = torch.device("cuda:0")
    t0 = time.perf_counter()
    sum2_err, sum2_times = sum2_checks(arith, device)
    row_err, row_times = sum2_row_times(arith, arith_dequant, device)
    err, times, deq215 = arith_checks(arith, arith_dequant, device)
    err["tcq2s_decode_gemv"] = max(sum2_err, row_err)
    rows_err, k1rows = k1_rows(arith, arith_dequant, device)
    err["tcq2_decode_gemv"] = max(err["tcq2_decode_gemv"],
                                  rows_err["dualmad"])
    with open(FLAGSHIP_QDICT) as f:
        shapes = flagship_shapes(LlamaConfig.llama31_8b(), json.load(f))
    check(sum(n for (_, _, KV), n in shapes.items() if len(KV) == 1)
          == FLAGSHIP_TCQ and sum(n for (_, _, KV), n in shapes.items()
                                  if len(KV) == 2) == FLAGSHIP_TCOMB,
          f"flagship shapes {shapes}")
    lut_err, lut_times = lut_kernel_checks(tcq_lut, {**shapes, **LUT_KV3},
                                           device)
    err.update(lut_err)
    times.update(lut_times)
    vq_err, vq_times, vq_schemes = vq_kernel_checks(vq, device)
    i8_err, i8_times, library = int8_head_checks(int8_gemv, device)
    for d, new in ((err, vq_err), (err, i8_err), (times, vq_times),
                   (times, i8_times)):
        d.update(new)
    for kname, e in merged_shape_checks(device).items():
        err[kname] = max(err[kname], e)
    print(f"[time] kernel checks {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches, qdict, graphs, zs = timed("6 the 215 path, 6b serving",
                                        main_path, device, smi)
    fl, graphs["flagship"], ppl = timed("7 flagship, 10c evaluation",
                                        flagship_path, device, smi)
    for k, v in fl.items():
        launches[k] += v
    ab, tps, pre, zs_a = timed("8-9 Path A, Path B", path_a_b, device, smi)
    for k, v in ab.items():
        launches[k] += v
    graphs.update({f"pathA {k}": v for k, v in tps.items()})
    pc, graphs["pathC"] = timed("9b Path C", path_c, device, smi)
    pd, graphs["pathD"] = timed("9c Path D", path_d, device, smi)
    pe, graphs["pathE"] = timed("9e Path E", path_e, device, smi)
    pf, graphs["pathF"], vec4 = timed("9f Path F", path_f, device, smi)
    for k in launches:
        launches[k] += pc[k] + pd[k] + pe[k] + pf[k]
    sb, serve_bench = timed("6c bench_serving", serving_bench, smi)
    pm, msq = timed("12 MSQ", msq_path, device, smi,
                    graphs["215"]["generate"])
    pq, quant_err, quant = timed("13 quantization", quant_path, device, smi)
    for k in launches:
        launches[k] += sb[k] + pm[k] + pq[k]
    for kname, e in quant_err.items():
        err[kname] = max(err[kname], e)
    tp = timed("14 tensor parallelism", tp_path, device, smi)
    beam = timed("15 beam and refine", beam_refine, device, smi)
    timed("10 2-layer models", small_model_checks, device)
    off_palette, off_times = timed("10d off-palette schemes",
                                   off_palette_check, device)
    timed("10b artifacts", artifact_check, device)
    t0 = time.perf_counter()
    attn_rel = attention_checks(device)
    small_rel = small_ce_check(device)
    print(f"[time] attention and 2-layer ce_loss checks "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    times["tcq2s_decode_gemv"] = step_ms(sum2_times, qdict)
    ms, pms, bms = times["tcq2s_decode_gemv"]
    print(f"[time] one 215 decode step's 129 sum2 calls: kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms, bound {bms:.3f} ms (a8, N=1; {smi})",
          flush=True)
    zs_forward = {}
    for N in ZS_ROWS:
        kms, pms, kbms = step_ms({
            (name, KV): tuple(t or 0.0 for t in row_times[(N, name, KV)][:3])
            for name, _, _, KV in SHAPES_215}, qdict)
        rms, _, _ = step_ms({(name, KV): (row_times[(N, name, KV)][3], 0, 0)
                             for name, _, _, KV in SHAPES_215}, qdict)
        ops, _, _ = step_ms({(name, KV): (
            row_times[(N, name, KV)][2]
            * (row_times[(N, name, KV)][4] == "operations"), 0, 0)
            for name, _, _, KV in SHAPES_215}, qdict)
        zs_forward[N] = (kms, pms if N == 64 else None, kbms, rms,
                         "operations" if 2 * ops >= kbms else "bytes")
        plain = f"plain {pms:.3f} ms, " if N == 64 else ""
        print(f"[time] a zero-shot forward's 129 sum2 calls at N={N} "
              f"(wide_gemv_kernel; layers exact, head a8): kernel "
              f"{kms:.3f} ms, {plain}dequant route {rms:.3f} ms, bound "
              f"{kbms:.3f} ms ({kbms / kms:.1%} of it; {smi})", flush=True)
    rows_fwd = k1_rows_forward(k1rows, smi)
    for kname in ("tcq2_decode_gemv", "tcq1_decode_gemv"):
        kms, kpms, kbms = times[kname]
        print(f"[time] Path A decode step's 64 calls of {kname}: kernel "
              f"{kms:.3f} ms, plain {kpms:.3f} ms, bound {kbms:.3f} ms (a8, "
              f"N=1; {smi})", flush=True)
    for kname in ("tcq2_dequant", "tcq1_dequant"):
        kms, kpms, kbms = times[kname]
        print(f"[time] tcq2mix 512-token prefill's 64 calls of {kname}: "
              f"kernel {kms:.3f} ms, plain {kpms:.3f} ms, bound {kbms:.3f} "
              f"ms ({smi})", flush=True)
    kms, kpms, kbms = step_ms(deq215, qdict)
    print(f"[time] 215 512-token prefill's 128 calls of tcq2_dequant (sum2): "
          f"kernel {kms:.3f} ms, plain {kpms:.3f} ms, bound {kbms:.3f} ms "
          f"({smi})", flush=True)
    for kname in ("tcq_lut_gemv", "tcomb_lut_gemv", "tcq_lut_dequant",
                  "tcomb_lut_dequant"):
        kms, kpms, kbms = times[kname]
        print(f"[time] flagship forward's calls of {kname}: kernel "
              f"{kms:.3f} ms, plain {kpms:.3f} ms, bound {kbms:.3f} ms "
              f"({kbms / kms:.1%} of it; {smi})", flush=True)
    print(f"[time] Path C decode forward's 128 vq_gemv calls (N=1): kernel "
          f"{times['vq_gemv'][0]:.3f} ms, plain {times['vq_gemv'][1]:.3f} ms,"
          f" bound {times['vq_gemv'][2]:.3f} ms; its prefill's 128 vq_dequant"
          f" calls: kernel {times['vq_dequant'][0]:.3f} ms, plain "
          f"{times['vq_dequant'][1]:.3f} ms, bound "
          f"{times['vq_dequant'][2]:.3f} ms ({smi})", flush=True)
    print("[time] vq per scheme, ms per call (vq_gemv N=1, vq_dequant): "
          + json.dumps({f"{b}/{v} {n}": [round(a, 5), round(d, 5)]
                        for (b, v, n), (a, d) in vq_schemes.items()}),
          flush=True)
    print(f"[pathB] 512-token exact prefill tcq2mix {pre['tcq2mix'] * 1e3:.1f}"
          f" ms, 215 {pre['215'] * 1e3:.1f} ms; Path A {PROMPT_LEN}-token "
          f"prefill a8 {pre[f'pathA a8 {PROMPT_LEN}'] * 1e3:.2f} ms, exact "
          f"{pre[f'pathA exact {PROMPT_LEN}'] * 1e3:.2f} ms ({smi})",
          flush=True)
    for path, g in graphs.items():
        print(f"[graph] {path}: tokens/s bs=1 eager loop {g['eager']:.2f}, "
              f"captured step {g['graph']:.2f} (greedy generate_fast), "
              f"{g['sampled']:.2f} (sampled); device busy "
              f"{g.get('busy_share', float('nan')):.1%} of a replay window, "
              f"device time {g.get('device_ms_a_step', float('nan')):.3f} ms "
              f"a step (GEMV {g.get('gemv_ms_a_step', float('nan')):.3f}, "
              f"dequant {g.get('dequant_ms_a_step', float('nan')):.3f}, "
              f"glue {g.get('glue_ms_a_step', float('nan')):.3f}), peak "
              f"memory {g['peak_gb']:.3f} GB; "
              f"{NEW_TOKENS} replays {g['long_ms_a_step']:.3f} ms a step at "
              f"SM {g['sm_mhz']:.0f} MHz, {g['power_w']:.0f} W ({smi})",
              flush=True)
    print("[graph] " + json.dumps({"card": smi, "paths": graphs}),
          flush=True)
    print("[eval] " + json.dumps({
        "card": smi, "ppl_window_s": ppl["ppl_window_s"],
        "eval_tokens_s": ppl["eval_tokens_s"], "peak_gb": ppl["peak_gb"],
        "zeroshot_examples_s": zs["zs_examples_s"], "ppl": ppl, "zeroshot": zs,
        "pathA_zeroshot_examples_s": zs_a["zs_examples_s"],
        "pathA_zeroshot": zs_a,
        "k1_rows_pathA_forward": {f"{md} N={N} {'a8' if a8 else 'exact'}": v
                                  for (md, N, a8), v in rows_fwd.items()},
        "k1_rows_pathA_sm_mhz": k1rows["sm_clock"],
        "attention_rel": attn_rel, "small_2layer_rel": small_rel,
        "k1_rows_forward": zs_forward,
        "k1_rows": {f"{N} {name} KV{KV}": t
                    for (N, name, KV), t in row_times.items()}}), flush=True)
    print("[serve] " + json.dumps({"card": smi, "pool16_215": zs["serve"],
                                   "bench_serving": serve_bench}),
          flush=True)
    print("[msq] " + json.dumps({"card": smi, **msq}), flush=True)
    print("[quant] " + json.dumps(quant), flush=True)
    print("[tp] " + json.dumps({"card": smi, **tp}), flush=True)
    print("[beam] " + json.dumps({"card": smi, **beam}), flush=True)
    print("[off-palette] " + json.dumps({
        "card": smi, "rel_and_w_err": off_palette,
        "dequant_4096x4096_ms_bound_ms_off": off_times}), flush=True)
    for kname in ("vq_gemv_vec4", "vq_dequant_vec4"):
        kms, kpms, kbms = times[kname]
        print(f"[time] a 32-layer Path F forward's 64 {kname} calls ({VQ4}, "
              f"32 o + 32 down; N=1 for K8): kernel {kms:.4f} ms, plain "
              f"{kpms:.4f} ms, bound {kbms:.4f} ms ({kbms / kms:.1%} of it; "
              f"{smi})", flush=True)
    print(f"[time] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
          f"({smi})", flush=True)
    kernels = []
    for f in wrappers():
        kname = f.__name__
        check(launches[kname] > 0, f"{kname} launched no time on a path")
        src, where = KERNEL_INFO[kname]
        kms, kpms, kbms = times[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"qpalette_tpu_torch/csrc/{src}", "replaces": where,
            "launches": launches[kname],
            "step_launches": STEP_LAUNCHES.get(kname, 0),
            "max_abs_err": err[kname],
            "ms": kms, "plain_ms": kpms, "bound_ms": kbms,
            "bound_by": BOUND_BY.get(kname, "bytes"),
            "library_ms": library.get(kname)})
    # vec 4 behind the same wrappers: the launches of Path F's counted run
    for kname, n in vec4.items():
        check(n > 0, f"{kname} at vec 4 launched no time")
        src, where = KERNEL_INFO[kname]
        kms, kpms, kbms = times[kname + "_vec4"]
        kernels.append({
            "name": kname + "_vec4", "route": "cuda",
            "source": f"qpalette_tpu_torch/csrc/{src}", "replaces": where,
            "launches": n,
            "step_launches": PATH_F_VEC4 * COUNTED_TOKENS
            if kname == "vq_gemv" else 0,
            "max_abs_err": err[kname + "_vec4"],
            "ms": kms, "plain_ms": kpms, "bound_ms": kbms,
            "bound_by": BOUND_BY.get(kname + "_vec4", "bytes"),
            "library_ms": None})
    # above 8 rows, wide_gemv_kernel (and its x prologue) behind the same
    # wrappers: sum2 with its launches in the 215 zero-shot run (every
    # call at 9-200 rows) and in the 16-slot serving phase, and times a
    # zero-shot forward's 129 calls at N=64; dualmad and 1mad with their launches in the Path A zero-shot
    # run and 16-token prefills (a8 and exact) and times a Path A
    # forward's 64 calls each at N=64, exact
    wide = (zs["zs_k1_launches"]["tcq2s_decode_gemv"]
            + zs["serve"]["k1_wide_launches"])
    check(wide > 0, "wide_gemv_kernel (sum2) launched no time")
    kms, kpms, kbms, _, kby = zs_forward[64]
    kernels.append({
        "name": "tcq2s_decode_gemv_wide", "route": "cuda",
        "source": "qpalette_tpu_torch/csrc/arith_wide.cuh",
        "replaces": KERNEL_INFO["tcq2s_decode_gemv"][1],
        "launches": wide, "step_launches": 0,
        "max_abs_err": row_err, "ms": kms, "plain_ms": kpms,
        "bound_ms": kbms, "bound_by": kby, "library_ms": None})
    for kname, mode in (("tcq2_decode_gemv", "dualmad"),
                        ("tcq1_decode_gemv", "1mad")):
        wide = zs_a["zs_k1_launches"][kname] + 2 * PATH_A_PREFILL[kname]
        check(wide > 0, f"{kname} above 8 rows launched no time")
        kms, kpms, kbms, _, kby = rows_fwd[(mode, 64, False)]
        kernels.append({
            "name": f"{kname}_wide", "route": "cuda",
            "source": "qpalette_tpu_torch/csrc/arith_wide.cuh",
            "replaces": KERNEL_INFO[kname][1], "launches": wide,
            "step_launches": 0,
            "max_abs_err": max(e for md, e in rows_err.items()
                               if arith.ARITH_V[md] == arith.ARITH_V[mode]),
            "ms": kms, "plain_ms": kpms, "bound_ms": kbms, "bound_by": kby,
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


def temp_assets():
    """Codebooks made by k-means in this run (vec 4: none is committed) go
    to a temporary QPALETTE_ASSETS, removed at exit, never into the
    repo's assets (both packages read its committed lut_cache)."""
    import atexit
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="qpt_assets_")
    os.environ["QPALETTE_ASSETS"] = d
    atexit.register(shutil.rmtree, d, ignore_errors=True)


TP_DEPTHS = (8, 32)  # --tp: the same comparison, printed, at full depth


def tp_only():
    """Phases 14 and 15 alone (--tp), then phase 14's comparison at
    TP_DEPTHS layers (printed, not held: the dummy model carries the
    ranks' other sum order further with depth)."""
    _, _, smi = card()
    temp_assets()
    build_all()
    device = torch.device("cuda:0")
    tp = tp_path(device, smi)
    beam = beam_refine(device, smi)
    print("[tp] " + json.dumps({"card": smi, **tp}), flush=True)
    print("[beam] " + json.dumps({"card": smi, **beam}), flush=True)
    for layers in TP_DEPTHS:
        deep = tp_path(device, smi, layers=layers, held=False)
        print("[tp depth] " + json.dumps({"card": smi, **deep}), flush=True)


def serve_only():
    """Phases 6b and 6c alone: the 16-slot pool on the 215 model and
    bench_serving at its defaults."""
    _, _, smi = card()
    build_all()
    device = torch.device("cuda:0")
    qdict, merge_info = _load_215()
    spec, params = _build("serve", qdict, merge_info, "a8", 4, device)
    _, pool = serving_pool(spec, params, device, smi)
    del params
    torch.cuda.empty_cache()
    _, bench = serving_bench(smi)
    print("[serve] " + json.dumps({"card": smi, "pool16_215": pool,
                                   "bench_serving": bench}), flush=True)


def msq_only():
    """Phase 12 alone, beside the 215's tokens/s through generate()."""
    _, _, smi = card()
    build_all()
    device = torch.device("cuda:0")
    qdict, merge_info = _load_215()
    spec, params = _build("main", qdict, merge_info, "a8", 4, device)
    tps = throughput("main", spec, params, device, smi)
    del params
    torch.cuda.empty_cache()
    _, msq = msq_path(device, smi, tps)
    print("[msq] " + json.dumps({"card": smi, **msq}), flush=True)


def recapture(n):
    """What sets a captured step's pace: the 215 path's step (temperature
    0.6, top-k 5) captured afresh and timed over consecutive windows of
    NEW_TOKENS replays (CUDA events), while nvidia-smi samples the SM and
    memory clocks.  Capture B: n windows straight after its capture.
    Capture A, made before B and left idle while B ran: n windows.  B
    again after 6 s with no replay.  Capture C: a torch.profiler session
    (its ops' sum printed) over its first replays, then n windows."""
    from qpalette_tpu_torch.runtime import decode

    _, _, smi = card()
    build_all()
    device = torch.device("cuda:0")
    qdict, merge_info = _load_215()
    spec, params = _build("recapture", qdict, merge_info, "a8", 4, device)
    T = PROMPT_LEN + NEW_TOKENS + 1
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, spec.config.vocab_size, (1, PROMPT_LEN)), device=device)

    def captured():
        step = decode.CapturedStep(spec, params, 1, T, 0.6, 5)
        logits, _ = decode.prefill(spec, params, prompt, step.caches)
        step.reset(logits[:, -1].argmax(dim=-1)[:, None], PROMPT_LEN)
        return step

    def windows(label, step):
        sampler = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.mem",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        t0, ms = time.perf_counter(), []
        try:
            for _ in range(n):
                step.reset(step.token.clone(), PROMPT_LEN)
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                step.replay(NEW_TOKENS)
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1) / NEW_TOKENS)
        finally:
            sampler.terminate()
            log, _ = sampler.communicate()
        clocks = sorted({ln.strip() for ln in log.splitlines()
                         if ln.count(",") == 1})
        print(f"[recapture] {label}: {n} windows of {NEW_TOKENS} replays in "
              f"{time.perf_counter() - t0:.1f} s, ms a step: "
              + ", ".join(f"{m:.3f}" for m in ms)
              + f"; SM, memory MHz seen: {clocks} ({smi})", flush=True)
        return ms

    a = captured()
    t_a = time.perf_counter()
    b = captured()
    out = {"card": smi, "B": windows("B, straight after its capture", b)}
    out["A"] = windows(f"A, idle {time.perf_counter() - t_a:.1f} s since "
                       f"its capture", a)
    time.sleep(6)
    out["B_idle"] = windows("B again, after 6 s with no replay", b)
    c = captured()
    prof = profile_replays("recapture C", c, PROMPT_LEN, PROFILE_STEPS, smi)
    out["op_sum_ms_a_step"] = prof.get("device_ms_a_step")
    out["C"] = windows("C, after a profiler session over its first "
                       "replays", c)
    print("[recapture] " + json.dumps(out), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="an older tree's qpalette_tpu_torch/csrc: run "
                    "parent_ab only")
    ap.add_argument("--ab", default="tcq2_gemv", choices=sorted(AB),
                    help="the kernels and path parent_ab compares (default "
                    "tcq2_gemv)")
    ap.add_argument("--rows", action="store_true",
                    help="run only phase 3's K1 dualmad / 1mad / 2mad "
                    "above 8 rows (k1_rows)")
    ap.add_argument("--serve", action="store_true",
                    help="run only the serving phases (6b, 6c)")
    ap.add_argument("--msq", action="store_true",
                    help="run only the MSQ phase (12)")
    ap.add_argument("--quant", action="store_true",
                    help="run only the quantization phase (13)")
    ap.add_argument("--tp", action="store_true",
                    help="run only the tensor-parallel phase (14) and beam "
                    "and refine (15)")
    ap.add_argument("--recapture", type=int, default=0,
                    help="run recapture only, with this many windows of "
                    "replays a capture of the 215 step")
    args = ap.parse_args()
    if args.parent:
        parent_ab(args.parent, args.ab)
    elif args.rows:
        rows_only()
    elif args.serve:
        serve_only()
    elif args.msq:
        msq_only()
    elif args.quant:
        quant_only()
    elif args.tp:
        tp_only()
    elif args.recapture:
        recapture(args.recapture)
    else:
        main()
