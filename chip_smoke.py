"""Chip smoke test of the PyTorch + CUDA port (mxmoe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (an H100
for the numbers in PERF.md) and nvcc. Phases, one JSON line each; any
failure raises and the script exits non-zero without a result line:

  1. probe    torch / CUDA / nvcc versions, nvidia-smi's name, power limit
  2. build    compile the kernels (csrc/*.cu, one nvcc per source, started
              together) from this checkout
  3. kernels  each kernel against its plain PyTorch version on the card at
              the serving shapes (qwen2_moe: H 2048, N 1408, E 60, top-4;
              decode M = 4 slots x 4, prefill M = 256 x 4), with its time
              (CUDA events, median of 25, the L2 cache overwritten before
              each timed call) and device time (device_ms: the summed
              durations of the kernels the call launched, torch.profiler,
              median of 25) beside the plain version's and
              beside its bound: the larger of the bytes it must move over
              3.35 TB/s and its operations over the card's dense peak.
              First the redesigned bodies at the edges of their schedules:
              K2, K4, K5 and K9 at M 1, 4, 16, 17, 24, 64, 65, 256, routed
              (two empty groups) and as one group (split-K), bitwise their
              plain versions and K4 = K5 = K2 on the same codes (from M 65
              K2 / K4 / K5 on the wgmma body, K9 on K8's body B: the
              schedules' bm printed as k2_k5_bm / k4_bm / k9_bm); K8 and K4f
              (the grouped-scale GEMM's schedules: the m16 ring kernel
              with split-K at whole groups up to M 64, body B above, printed
              as k8_bm / k4f_bm)
              on the same rows at g128 with zero points, bitwise their plain
              versions and K4f = K8 (K 1408: a group spans the packed
              halves); K6, K7 and K10 (the weight-only GEMM's two schedules,
              one for the three: the m16 ring body with split-K over
              byte-tile pairs up to M 64, the 32-row tile above) on the same
              rows at g128 with zero points and per channel, K6 within its
              bound, K7 = K6 and K10's weight-only rows = K6 bitwise, its
              w x a rows = K8 / K2 bitwise; K11 on the same rows with bf16
              weights within its bound (its wgmma body at every M); K3 / K3q
              at
              lengths on the warp-chunk and S-block edges, G 1 / 4 / 7, the
              write bitwise, the read-only form bitwise K3 / K3q after it.
              K1, K2, K4, K5 bitwise (K4 and K5 also against K2 on the
              unpacked codes, K5 against K4 on an all-packed buffer); K3 and
              K3q caches (codes and scales) bitwise and their output per
              slot within K3_REL_BOUND of the slot's scale (+1 ulp for bf16),
              also at the anchor's head dim 32 (G 2) on the same lengths
              and at its decode step (8 slots of 128 positions, f32).
              K8 (without and with zero points) and K9 bitwise, K9 also
              against K8 with one group (K4, K4f and K9 at the chunk's
              gate_up go into the kernels line as `prefill`, with the
              schedule); K6 and K7 within their accumulation
              bound of a float64 product (gmm_weight_only.error_over_bound),
              K7 bitwise K6 on the unpacked codes; K8 and K6 also with one
              group of rows at the shared expert's shapes; each K6 / K7 /
              K10 line prints the schedule it ran (bm 16 at decode).
              K4f (the flex form of gmm_mixed_packed) bitwise its plain
              version and bitwise K8 on the unpacked codes, without and with a
              group that spans the two halves of K, without and with zero
              points; K10 (gmm_mixed_wo_wxa, both bodies; flags alternating,
              all 0, all 1): w x a experts bitwise K8 / K2 and the plain
              version, weight-only experts bitwise K6 and within K6's bound;
              K11 (gmm_bf16) within gmm.error_over_bound of a float64 product,
              timed beside the stock torch._grouped_mm (its library_ms), at
              decode, the prefill chunk (M 1024), the profiler's three
              scales (M 8192 / 32768 / 65536 over 60 experts) and the
              headline's 32762 rows, gate_up and down, each line naming the
              body that ran (ops.gmm.bf16_gmm_schedule); the
              int8 lm_head's product (K1, K2 with one group, N 151936) bitwise.
              Also the sorted combine's time beside the atomic index_add_'s.
              K12 (gmm_ffn_w8a8) over the aligned dispatch, decode and
              prefill: bitwise its plain version, within the reference's
              bounds of the two-launch path (timed beside it) and, on the
              reference test's set-up, within 2e-4 of the f32 oracle; K13
              (gmm_ffn_mixed_packed) bitwise its plain version and K12 on the
              equivalent codes (no expert, every other, every expert packed);
              K12 and K13 also at qwen2_moe_57b's widths (N 2560, H 3584: the
              16-CTA cluster) at decode and a 256-token chunk, bitwise their
              plain versions and each other, timed (the kernels line's
              `wide`), and each model's cluster size (8 at qwen2_moe's and
              ds2's N 1408, 16 at 2560, mixtral's 14336 refused);
              K14 (gmm_w8a8_fusedquant) bitwise its plain version and K1 + K2;
              K15 (gmm_ws, the wgmma body) at the headline workload's shapes
              bitwise K2 / K5, and at mixtral's K 4096 / 14336 (full width,
              int8 and packed; K the earlier full-K slice body refused)
              bitwise its plain version. K2 and K5 above the decode rows
              (the wgmma body over group sizes read on the device) at the
              qwen2_moe and ds2 256-token prefill chunks, the int8 shared
              expert's prefill (one group, M 256) and the headline's 32762
              unaligned rows, bitwise their plain versions (K15 on the
              aligned layout is held against K2 / K5 above); K14 at decode
              (its m16 body), a prefill chunk and the headline's rows (its
              cooperative wgmma body) bitwise its plain version and K1 + K2.
              K1 at the headline's rows (36736 x 2048 / 1408, the shared
              expert's 8192 x 5632) bitwise.
              The read-only decode attention (decode_attention_stacked bf16 /
              int8, decode_attention, decode_attention_q8) at K3's serving
              cache, at the qwen2_moe shape and at ds2's MLA shape (dk 256
              with its zero tail, dv 128, scale 1/sqrt(192)): within
              K3_REL_BOUND per slot of the plain versions, the stacked forms
              bitwise K3 / K3q after their write of the same step, the
              per-layer forms bitwise the stacked ones; the bf16 forms timed
              beside scaled_dot_product_attention. Then 20 profiled runs
              of K1 without device_ms's lead-in, the anchor's training (300
              steps), and 20 runs without and 20 with the lead-in (at most
              2 of 20 with it may lose a marker): the `timing` line
  4. parity   full-width qwen2_moe, 2 layers, the same params and tokens
              through forward_cached on the CPU (plain versions) and on
              CUDA (kernels): one 256-token prefill chunk + 4 decode steps;
              logits within PARITY_BOUND, greedy tokens equal. The inputs
              are chosen on the CPU run so that every compared position's
              top-2 margin exceeds PARITY_BOUND (no tie decides the gate).
              Run for uniform w8a8 + bf16 cache, mixed-packed + int8 KV
              cache, uniform w4a16_g128_asym nibble-packed, a flex mix
              (routed w4a4_g128_asym / w8a8_g-1_sym, shared w8a8_g128_asym),
              flex-wo (routed w4a16_g128_asym / w8a8_g-1_sym through K10),
              flex-packed (routed w4a4_g128_asym nibble-packed / w8a8_g-1_sym
              through K4f), bf16 experts through K11, and with the whole FFN
              in one launch: mixed-packed + int8 KV (K13), uniform w8a8 (K12),
              and uniform w8a8 over the aligned dispatch unfused (K2). Then
              full-width ds2, 3 layers (the dense first layer and two MoE
              layers), mixed-packed + int8 KV (MLA through K3q at dk 256).
              On the card, forward_logits over a 256-token prompt against a
              one-chunk forward_cached prefill into a bf16 cache, within the
              parity bound, for qwen2_moe (2 layers) and ds2 (3 layers),
              mixed-packed
  5. storage  mixed (int8-stored) and mixed-packed params of one seed, 4
              layers, int8 KV cache: prefill + 16 decode steps give bitwise
              equal logits on the card; the same for the flex mix int8-stored
              (K8) and packed (K4f), and for mixed / mixed-packed with the
              fused FFN (K12 / K13). Then the float path's two arms, K11 and
              the stock grouped product, on one 4-layer model: logits within
              the parity bound of each other
  6. serve    the Engine answering 4 requests over qwen2_moe with seeded
              random bf16 weights, 4 layers each: uniform w8a8 + bf16 cache
              (K1, K2, K3), uniform w4a8 nibble-packed (K1, K5, K3),
              alternating w4a4 / w8a8 experts packed with the shared expert
              w8a8 and the int8 KV cache (K1, K2, K3q, K4), uniform
              w4a16_g128_asym nibble-packed (K7, K3), uniform w4a4_g128_sym
              (K8), w8a8_g-1_asym (K1, K9), w4a16_g-1_sym int8-stored (K6),
              the two flex mixes (K8 with zero points; shared expert through
              K8 or K6 with one group), flex-wo (K10), flex-packed with the
              int8 KV cache (K4f, K3q), the per-channel weight-only mix
              (K10's other body), bf16 experts through K11 and through the
              stock arm, uniform w8a8 with the int8 lm_head; with the fused
              FFN: uniform w8a8 (K12, no K2), "auto" (K12 at decode and at the
              256-token prefill chunks), the aligned dispatch unfused (K2, no
              K12) and the flex mix (no K12 / K13: the guard falls through).
              At the full 24 layers: mixed-packed + int8 KV with the fused
              FFN (K13, K1, K3q; shared expert K2; no K4). decode_attn="xla"
              on uniform w8a8 (no K3). ds2 at the full 27 layers, mixed-packed
              + int8 KV + int8 head (K3q, K1, K4, K2), mixtral (32 layers)
              and qwen2_moe_57b (28 layers) at full width and depth, uniform
              w8a8 (K1, K2, K3 at G 4 / 7); qwen2_moe_57b at 4 layers with the
              fused FFN (K12 on the 16-CTA cluster, no K2). Every prompt's
              256-token chunks replay the Engine's captured chunk
              (serving/graph.py PrefillGraph over a one-slot staging cache);
              a serve that did not capture it fails. Each serve prints its peak memory beside the
              bytes reckoned from the config. The launch counts are
              set to 0 before each serve and read after it (a captured
              step's launches counted at every replay); every kernel
              named must have launched. Every serve decodes through the
              Engine's captured step (serving/graph.py: one CUDA graph of
              the cached forward and the sampler a step); a serve that did
              not capture it fails
 6b. graph    on the serves uniform, mixed_fused (24 layers), ds2 (27),
              flex_packed, uniform_xla and int8_head (graph_checks): an
              eager forward_cached greedy loop from a clone of the
              post-prefill cache gives every request's 31 decoded tokens
              and, at the last step, the captured step's logits bitwise;
              its first step on uniform and uniform_xla runs under
              torch.cuda.set_sync_debug_mode("error"); uniform's params
              served twice with temperature 0.8, top_k 50 and one seed give
              the same tokens; on mixed_fused the eager and the captured
              step in turns (eager, captured, captured, eager): wall ms,
              device ms, busy share, kernels and host launch calls a step.
              Each line: warm-up, capture and instantiate seconds, launches
              a replay, peak memory. On mixed_fused, ds2 and a16_packed
              (w4a16, bf16 cache) the `prefill_graph` line: one [4, 256]
              chunk (valid 256 / 256 / 0 / 97) eager and captured from two
              clones of the post-prefill cache, logits and every cache byte
              bitwise; both timed in turns (wall and device ms, busy share,
              host launch calls a chunk), capture seconds, peak memory; on
              mixed_fused also the 512-token time to the first token through
              Engine.submit, eager and captured
  7. bench    the bench_serving entry point, 4 layers: mixed-packed + int8 KV
              (K1, K2, K3q, K4 must be non-zero in its own launch counts),
              --quant w4a16_g128_asym (K6, K3), --quant none (K3),
              --quant w8a8_g-1_sym --int8-head (K1, K2, K3), mixed-packed
              + int8 KV --fused-ffn on (K13, K1, K2, K3q), and --model ds2
              mixed-packed + int8 KV with --decode-attn auto (K3q) and xla
              (no K3 / K3q)
  8. headline bench/headline.py (the counterpart of bench.py) in the
              process: the mixed one-launch and bucketed arms' outputs (K15)
              bitwise their --no-ws arms' (K2; K5 + K2), then both arms as
              the entry point runs them, each printing its JSON line; K15
              must launch
  9. offline  the offline path at full width, 2 layers (offline_phase): a
              seeded HF-schema qwen2_moe checkpoint (models.synth_ckpt, bf16)
              converted (models.convert on the card) into five artifacts,
              each served through generate --artifact (Engine, 2 slots):
              uniform w8a8 (K1, K2, K3; its tokens and logits bitwise those
              of the same shards quantized in memory), the alternating w4a4 /
              w8a8 mix with the w8a8 shared expert by RTN, GPTQ and GPTQ +
              Hadamard (K1, K2, K3, K4; the rotated float model's logits
              beside the float model's), and a w4a8_g128 mix with a
              w8a8_g128 shared expert by GPTQ (K4f, K3; the shared expert
              fake-quantized). Each line: convert seconds, artifact bytes,
              GPTQ seconds a layer (float pass + Hessians, sweep), the share
              of experts whose GPTQ proxy loss is below RTN's
 10. solve    the solve half at full width, 2 layers, on the offline phase's
              checkpoint (written once for both, removed after them;
              solve_phase): the gate trace over 8 x 512 synthetic tokens
              through K11 (every layer's access counts sum to tokens x
              top-k), the calibration losses by RTN over w8a8_g-1_sym,
              w4a4_g-1_sym and w4a16_g128_asym and by GPTQ for w4a4 (every
              entry of an expert the trace routed rows to finite and > 0,
              of one it routed none to exactly 0; w4a4 >= w8a8 on >= 99 %
              of the routed entries), the performance table of those schemes and their
              _packed forms (K2, K5, K6, K7; every inc > 0) and the
              one-launch fit (K1, K2, K4, K6; every rate within the card's
              peak for its kind, the unpack rate only when its slope stands
              above the spread of its rounds, else 0.0 and printed as
              unresolved), each fit's residuals, the analytic
              roofline's agreement with the table; the MILP (r 0.5, 6
              bits, the trace's batch) under the table and under the fit
              (each layer within the budget, gate = up, two schemes or
              more); convert --qconfig of the one-launch solution by RTN on
              the card and generate --artifact (2 slots, 48 + 16 tokens):
              the kernels its storage selects must launch, and its first
              chunk's logits are printed beside quantize_model_fake's
              forward of the same qconfig. Each step's seconds

 11. eval     evaluation and the remaining benches on the same checkpoint
              (eval_phase): eval.run fake-quant and --real-exec with the
              solve phase's served qconfig by RTN, 4 x 512 synthetic tokens
              (real ppl within 1 % of fake; the storage's kernels launch),
              and per token layer 0's MoE output on the card against the
              CPU's plain versions (mean within 0.4 %; a planted 10 % scale
              fault on one expert must fail it); eval_ppl_decode on the
              same real model through its captured step (serving/graph.py
              TeacherForcedGraph; its launches counted and gated), bf16 KV
              (K3, within 0.5 % of the forward ppl) and int8 KV + int8 head
              (K3q, K1 + K2, within 2 %), its nll bitwise the eager twin's
              (the step's body run a token), whose logits are held token
              by token within 0.2 of the forward's (a planted one-position
              cache fault must fail it);
              eval.anchor.run_anchor trained on the card,
              300 steps and 16 eval windows (cut for time), RTN and
              GPTQ-had (ppl_fp below the unigram floor, real w8a8 within
              0.5 % of fake, the decode row within 2 % of the real forward
              row, the root ACCURACY.md unchanged, K1 / K2 / K4 / K3q at
              dk 32 launched); run_mxmoe --check and bench at 8192 tokens
              on the canonical trace with the solved qconfig (its last
              layer: the solve is 2 layers deep) and with w4a4_g-1_sym
              (every bucket PASS, ms / TFLOPS / speedup_vs_bf16 printed);
              bench.fused_ab at 512 / 2048 / 32768 rows (K10 bitwise K6 +
              K2). Each step's seconds

 12. ep       expert parallelism (ep_phase; no new kernel: the ported ones
              per rank). (a) One rank over NCCL: qwen2_moe at full width and
              24 layers, mixed-packed + int8 KV, through Engine(mesh=...) on
              a one-rank DeviceMesh, eager (cuda_graphs=False) and captured
              (its decode step, submit chunk and follower graphs CUDA graphs
              that hold the EP block's NCCL exchanges): the captured tokens
              bitwise the eager mesh Engine's, both against the one-device
              Engine on the same params (K1, K2, K3q, K4 must launch in the
              captured serve); each graph's warm-up, capture and
              instantiate seconds and the memory it keeps, both serves'
              peaks; the mesh decode step and submit's [1, 256] chunk eager
              and captured in turns (profile_decode.abba: wall and device
              ms, busy share, host launch calls a step, at most
              MESH_LAUNCH_CALLS captured; the NCCL kernels a replay ran; the
              chunk bitwise its eager twin) and the 512-token time to the
              first token through the mesh submit; then
              parallel.scale_bench at ep 1, the EP layer and the decode step
              eager and captured (its ep >= 2 rows wait for a
              machine with more cards), and whether NCCL takes two ranks on
              the one card (a 2-process all_reduce, recorded); then the
              tensor-parallel forward (tp_one_rank; `tp` lines): qwen2_moe
              bf16 at full width and 24 layers on a (1, 1) ("data",
              "expert") mesh, [2, 512] tokens, K11 per rank: its logits
              bitwise forward_logits on the card, captured by
              serving.graph.ForwardGraph bitwise eager (K11 launched by a
              replay), eager and captured TP and captured forward_logits in
              turns (wall and device ms, busy share, kernels and host launch
              calls a forward, peak GB); make_sharded_forward (w8a8: K1, K2)
              and make_sp_prefill_forward (K11), 4 layers, each captured
              bitwise eager; the phase's added seconds. (b) Two ranks
              spawned on the one card, the exchange staged through host
              buffers over gloo (the transport every line names; eager: no
              graph holds the host copies), 4 layers:
              uniform w8a8 (K1, K2), mixed-packed (K4), flex (K8) and
              mixed-wo (K10), each with K3, at the capacity the float model's
              gate trace gives (its drops printed: none can at 2 ranks and a
              factor of 2 or more), each rank's peak memory; rank 0 serves
              the same requests on one device first. Then one ring SP prefill
              at 2 ranks against forward_logits (float32, within SP_REL of
              max |logits|), and the tensor-parallel forward on the same
              model over a (1, 2) mesh (30 experts, 8 q and 8 kv heads and
              2816 gate and 2816 up columns of the shared expert a rank;
              K11; within SP_REL of max |logits| on each rank; each rank's
              peak GB). (c) generate --mesh 2 --transport host (eager)
              against generate on one device. Every EP serve's tokens equal the
              one-device serve's, or part first where the one-device model's
              top-2 margin is within PARITY_BOUND (_margin_rule)

Then a {"kernels": [...]} line (each kernel's launches are those of one
serve or run, named beside them, ``offline_launches`` those of each
artifact's serve, ``solve_launches`` those of each solve step,
``eval_launches`` those of each eval step and ``ep_launches`` those of each
EP serve of phase 12; K3 / K3q's ``anchor_decode`` the
anchor's decode shape, dk 32; K14 and
the read-only decode attention are reached by no serve in either package),
the nvidia-smi line, and last
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

_DA_CU = "mxmoe_tpu_torch/csrc/decode_attention.cu"
_DA_Q8_CU = "mxmoe_tpu_torch/csrc/decode_attention_q8.cu"
_DA_PY = "mxmoe_tpu/serving/decode_attention.py:485"
KERNEL_SOURCES = {
    "quantize_rows": ("mxmoe_tpu_torch/csrc/act_quant.cu",
                      "mxmoe_tpu/ops/act_quant.py:43"),
    "gmm_w8a8": ("mxmoe_tpu_torch/csrc/gmm_w8a8.cu",
                 "mxmoe_tpu/ops/pallas_gmm.py:376"),
    "decode_attention_update_stacked": (_DA_CU, _DA_PY),
    "decode_attention_update_stacked_q8": (_DA_Q8_CU, _DA_PY),
    "gmm_mixed_packed": ("mxmoe_tpu_torch/csrc/gmm_mixed_packed.cu",
                         "mxmoe_tpu/ops/pallas_gmm.py:1054"),
    "gmm_w4a8_packed": ("mxmoe_tpu_torch/csrc/gmm_w4a8_packed.cu",
                        "mxmoe_tpu/ops/pallas_gmm.py:599"),
    "gmm_weight_only": ("mxmoe_tpu_torch/csrc/gmm_weight_only.cu",
                        "mxmoe_tpu/ops/pallas_gmm.py:505"),
    "gmm_weight_only_packed": ("mxmoe_tpu_torch/csrc/gmm_weight_only_packed.cu",
                               "mxmoe_tpu/ops/pallas_gmm.py:706"),
    "gmm_w8a8_grouped": ("mxmoe_tpu_torch/csrc/gmm_w8a8_grouped.cu",
                         "mxmoe_tpu/ops/pallas_gmm.py:1332"),
    "gmm_w8a8_asym": ("mxmoe_tpu_torch/csrc/gmm_w8a8_asym.cu",
                      "mxmoe_tpu/ops/pallas_gmm.py:1487"),
    # K4f, the flex form of gmm_mixed_packed: a kernel and a launch count of
    # its own, in K4's source
    "gmm_mixed_packed_flex": ("mxmoe_tpu_torch/csrc/gmm_mixed_packed.cu",
                              "mxmoe_tpu/ops/pallas_gmm.py:930"),
    "gmm_mixed_wo_wxa": ("mxmoe_tpu_torch/csrc/gmm_mixed_wo_wxa.cu",
                         "mxmoe_tpu/ops/pallas_gmm.py:1631"),
    "gmm_bf16": ("mxmoe_tpu_torch/csrc/gmm_bf16.cu",
                 "mxmoe_tpu/ops/pallas_gmm.py:271"),
    "gmm_ffn_w8a8": ("mxmoe_tpu_torch/csrc/gmm_ffn_w8a8.cu",
                     "mxmoe_tpu/ops/pallas_gmm.py:2081"),
    "gmm_ffn_mixed_packed": ("mxmoe_tpu_torch/csrc/gmm_ffn_mixed_packed.cu",
                             "mxmoe_tpu/ops/pallas_gmm.py:2300"),
    "gmm_w8a8_fusedquant": ("mxmoe_tpu_torch/csrc/gmm_w8a8_fusedquant.cu",
                            "mxmoe_tpu/ops/pallas_gmm.py:1752"),
    "gmm_ws": ("mxmoe_tpu_torch/csrc/gmm_ws.cu", "mxmoe_tpu/ops/pallas_gmm.py:1906"),
    # the read-only decode attention: K3 / K3q's bodies without the write
    "decode_attention_stacked": (_DA_CU, "mxmoe_tpu/serving/decode_attention.py:593"),
    "decode_attention_stacked_q8": (_DA_Q8_CU,
                                    "mxmoe_tpu/serving/decode_attention.py:593"),
    "decode_attention": (_DA_CU, "mxmoe_tpu/serving/decode_attention.py:688"),
    "decode_attention_q8": (_DA_Q8_CU, "mxmoe_tpu/serving/decode_attention.py:749"),
}
READ_ONLY_ATTENTION = ("decode_attention_stacked", "decode_attention_stacked_q8",
                       "decode_attention", "decode_attention_q8")
# a serve's optional fields: MoEImpl fields, kernels that must not launch, model
SERVE_DEFAULTS = (None, (), "qwen2_moe")
# the scale group of the grouped schemes on the main path (g128)
GSIZE = 128
# K3 / K3q output bound, held per slot b against that slot's own scale
# max|ref[b]|: |d| <= K3_REL_BOUND * max|ref[b]| for f32 outputs (online
# softmax sums in another order than the plain version's full softmax), plus
# one bf16 ulp of the reference element for bf16 outputs (both round the
# same f32 value once; a value near a rounding boundary may land one ulp
# apart). A dropped or added position moves a long slot's outputs by about
# |v| / length (~5e-4 at 2048 positions), well past both.
K3_REL_BOUND = 1e-5
# parity bound on logits: 4 bf16 ulps at max|logits| of the CPU run, at most
# 0.125 (4 ulps in [4, 8), where the runs' max|logits| ~5.2 lies), and equal
# greedy tokens. The logits are bf16 and the card's bf16 matmuls round at
# other places; runs on an H100 read max|d| = 1 ulp (0.03125)
PARITY_ULPS = 4
PARITY_BOUND = 0.125
# the Hadamard-rotated float32 model against the float32 model: max |d| of
# the logits over max |logits| (the rotation is exact in real arithmetic;
# float32 rounding of the rotated weights and activations stays far below)
ROTATION_REL = 1e-3
# the card's published peaks (H100 SXM, dense): device memory rate and
# operations per second by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
# one PyTorch call that computes the same function, per kernel: K11
# (gmm_bf16) has one, the stock grouped product ``torch._grouped_mm`` that
# ``ops.gmm.gmm``'s "ragged_dot" arm takes; its time is measured beside K11's.
# The bf16 read-only decode attention (decode_attention_stacked,
# decode_attention) has ``scaled_dot_product_attention`` with a boolean
# [B, 1, 1, S] length mask and ``enable_gqa``, timed beside them (used nowhere
# in the port); its int8 forms have none (no library call takes per-position
# scales). For the others there is none (``library_ms`` null): torch has no per-row-bits
# quantizer, no grouped (per-expert) product over expert-sorted rows with int8
# or nibble-packed operands, per-group scales, zero points or in-product
# dequantization, and no single call writes the cache and attends over it;
# none quantizes activations inside a product (K14), runs a whole FFN with an
# in-product requant (K12, K13), or schedules a grouped int8 product (K15)


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (zero counts as the smallest
    normal)."""
    import torch

    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def k3_slot_errors(out, ref):
    """Per-slot max|d| / max|ref[b]|; raises where the K3 bound fails."""
    import torch

    o, r = out.float(), ref.float()
    d = (o - r).abs()
    scale = r.abs().flatten(1).amax(1).clamp_min(1e-30)
    tol = K3_REL_BOUND * scale[:, None, None]
    if out.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(r)
    rel = d.flatten(1).amax(1) / scale
    if not bool((d <= tol).all()):
        raise AssertionError(f"K3 {out.dtype} output outside its per-slot bound: "
                             f"relative errors per slot {rel.tolist()}")
    return rel.tolist()


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median time of one call between CUDA events, the L2 cache overwritten
    before each (``bench.timing.event_ms``)."""
    from mxmoe_tpu_torch.bench.timing import event_ms

    return event_ms(fn, reps, warmup)


def device_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call: the summed durations of the kernels it
    launched (torch.profiler; ``bench.timing.device_ms``)."""
    from mxmoe_tpu_torch.bench.timing import device_ms as dev_ms

    return dev_ms(fn, reps, warmup)


def kernel_times(fn, reps: int = 25, warmup: int = 3) -> dict:
    """A kernel row's two readings: ``ms`` (CUDA events around the call,
    host work of the wrapper included) and ``device_ms``."""
    return {"ms": time_ms(fn, reps, warmup), "device_ms": device_ms(fn, reps, warmup)}


def probe() -> str:
    import torch

    from mxmoe_tpu_torch.utils.device import get_cuda_info

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                         "is False); this script measures the card only")
    info = get_cuda_info()
    smi = smi_line()
    emit("probe", python=sys.version.split()[0], torch=info.torch_version,
         torch_cuda=info.torch_cuda, nvcc=info.nvcc, nvcc_version=info.nvcc_version,
         device=info.name, capability=info.capability, count=info.count,
         memory_bytes=info.memory_bytes, nvidia_smi=smi)
    return smi


def build() -> None:
    from mxmoe_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    emit("build", nvcc_seconds=kernels.build_seconds,
         build_and_load_seconds=time.perf_counter() - t0,
         library=os.path.relpath(path, HERE))


def work_bound(nbytes: float, ops: float, ops_type: str) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[ops_type] * 1e3
    return {"bytes": int(nbytes), "ops": int(ops), "ops_type": ops_type,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def quant_rows_work(m: int, k: int, in_bytes: int) -> dict:
    """K1: the row read once, codes and scale written, ~3 f32 ops a value."""
    return work_bound(m * k * in_bytes + m * 4 + m * k + m * 4, 3 * m * k, "f32")


def gmm_work(gs, k: int, n: int, expert_bytes, out_bytes: int = 2,
             meta_bytes: int = 0, scale_rows: int = 1, lhs_row_bytes=None,
             ops_type: str = "int8") -> dict:
    """A grouped GEMM on THIS routing: only experts with rows stream their
    weights (``expert_bytes[e]``) and their ``scale_rows`` f32 [N] rows of
    scales and zero points (1 per channel; at g128 one or two per 128 codes:
    8 bytes per 128 codes and column with zp); every routed row is read
    (``lhs_row_bytes``: int8 codes and one f32 scale unless given) and
    written once."""
    import torch

    live = gs > 0
    rows = int(gs.sum())
    e = gs.numel()
    w = torch.as_tensor(expert_bytes, device=gs.device).expand(e)
    if lhs_row_bytes is None:
        lhs_row_bytes = k + 4
    nbytes = (rows * lhs_row_bytes + int(w[live].sum())
              + int(live.sum()) * scale_rows * n * 4
              + e * 4 + meta_bytes + rows * n * out_bytes)
    return work_bound(nbytes, 2 * rows * k * n, ops_type)


def decode_attn_work(lengths, valid, s_max, n_h, n_kv, dk, dv, elem_bytes,
                     cache_pos_bytes) -> dict:
    """K3 / K3q on THESE lengths: a slot attends min(len, S-1) + 1 positions,
    all read from the cache except the one it writes (``cache_pos_bytes``
    per kv head and position)."""
    nbytes = ops = 0
    for ln, ok in zip(lengths.tolist(), valid.tolist()):
        n_pos = min(max(ln, 0), s_max - 1) + 1
        wrote = bool(ok) and 0 <= ln < s_max
        nbytes += (n_pos - wrote) * n_kv * cache_pos_bytes        # cache read
        nbytes += wrote * n_kv * cache_pos_bytes                  # cache write
        nbytes += (n_h * dk + n_kv * (dk + dv) + n_h * dv) * elem_bytes
        ops += 2 * n_h * n_pos * (dk + dv)
    return work_bound(nbytes, ops, "bf16")


def _routing_group_sizes(tokens: int, cfg, gen, device):
    import torch

    from mxmoe_tpu_torch.ops.dispatch import make_dispatch, route_topk

    logits = torch.randn((tokens, cfg.num_experts), generator=gen, device=device)
    return make_dispatch(route_topk(logits, cfg.top_k, cfg.norm_topk_prob),
                         cfg.num_experts).group_sizes


def _sched_dict(s) -> dict:
    return {"bm": s.bm, "bn": s.bn, "grid_m": s.grid_m, "splits": s.splits,
            "k_tiles_per_split": s.k_tiles_per_split}


def _grouped_schedule(m: int, k: int, n: int, e: int, mixed: bool = False) -> dict:
    """The grouped-scale GEMM's schedule at g128, for the log: K8's, or K4f's
    over its ragged storage (``mixed``); each on its wgmma body above the
    threshold."""
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import grouped_gmm_schedule

    return _sched_dict(grouped_gmm_schedule(m, k, n, e, GSIZE, wgmma=True, mixed=mixed))


def _k4_schedule(m: int, k: int, n: int, e: int) -> dict:
    """K4's schedule (K2's, over the ragged storage), for the log."""
    from mxmoe_tpu_torch.ops.gmm_w8a8 import int8_gmm_schedule

    return _sched_dict(int8_gmm_schedule(m, k, n, e, wgmma=True, ragged=True))


def _k9_schedule(m: int, k: int, n: int, e: int) -> dict:
    """K9's schedule (body B with one group above the threshold), for the log."""
    from mxmoe_tpu_torch.ops.gmm_w8a8_asym import asym_gmm_schedule

    return _sched_dict(asym_gmm_schedule(m, k, n, e))


def _wo_schedule(m: int, k: int, n: int, e: int, gsize: int = GSIZE) -> dict:
    """The weight-only GEMMs' schedule (K6, K7, K10), for the log."""
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import weight_only_gmm_schedule

    s = weight_only_gmm_schedule(m, k, n, e, k if gsize == -1 else gsize)
    return {"bm": s.bm, "grid_m": s.grid_m, "splits": s.splits,
            "k_tiles_per_split": s.k_tiles_per_split}


def _require_equal(got, ref, what: str) -> None:
    import torch

    if not torch.equal(got, ref):
        d = (got.float() - ref.float()).abs().max().item()
        raise AssertionError(f"{what}: not bitwise, max|d|={d}")


def gmm_kernels_vs_plain(rec: dict) -> None:
    """K1, K2, K4, K5 at the decode and prefill shapes of both expert GEMMs."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.ops import act_quant, gmm_mixed_packed as gmp
    from mxmoe_tpu_torch.ops import gmm_w4a8_packed as g4p, gmm_w8a8 as gmm
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed, pack_int4_halves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    # alternating storage, as the mixed serving config: even experts w4 packed
    pflags = [int(i % 2 == 0) for i in range(e)]
    pf = torch.tensor(pflags, dtype=torch.int32, device=dev)
    pf_all = torch.ones((e,), dtype=torch.int32, device=dev)
    blk_all = torch.arange(e, dtype=torch.int32, device=dev)

    for regime, tokens in (("decode", 4), ("prefill", 256)):
        m = tokens * cfg.top_k
        gs = _routing_group_sizes(tokens, cfg, gen, dev)
        empty = int((gs == 0).sum().item())
        keep = regime == "decode"
        # K1 on both GEMM inputs, with per-row bits as a mixed layer gives them
        for k in (h, n):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            for label, bits in (("a8", torch.full((m,), 8.0, device=dev)),
                                ("a4/a8", torch.tensor([4.0, 8.0], device=dev)
                                 .repeat(m // 2).contiguous())):
                q, s = act_quant.quantize_rows(x, bits)
                qp, sp = act_quant.quantize_rows_plain(x, bits)
                torch.cuda.synchronize()
                if not (torch.equal(q, qp) and torch.equal(s, sp)):
                    raise AssertionError(
                        f"K1 not bitwise at {regime} K={k} bits {label}: "
                        f"{(q != qp).sum().item()} codes differ")
            t = {**kernel_times(lambda: act_quant.quantize_rows(x, bits)),
                 "plain_ms": time_ms(lambda: act_quant.quantize_rows_plain(x, bits)),
                 **quant_rows_work(m, k, 2)}
            emit("kernels", kernel="quantize_rows", regime=regime, M=m, K=k,
                 bitwise=True, **t)
            if keep and k == h:
                rec["quantize_rows"].update(t)
        for k, nn in ((h, 2 * n), (n, h)):
            aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
            wq = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                               dtype=torch.int8)
            wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01
            shape = dict(regime=regime, M=m, K=k, N=nn, empty_groups=empty)
            # K2
            out = gmm.gmm_w8a8(aq, asc, wq, wsc, gs)
            ref = gmm.gmm_w8a8_plain(aq, asc, wq, wsc, gs)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K2 vs plain at {regime} K={k}")
            t = {**kernel_times(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, gs)),
                 "plain_ms": time_ms(lambda: gmm.gmm_w8a8_plain(aq, asc, wq, wsc, gs)),
                 **gmm_work(gs, k, nn, k * nn)}
            emit("kernels", kernel="gmm_w8a8", bitwise=True, **shape, **t)
            if keep and k == h:
                rec["gmm_w8a8"].update(t)
            # K4: the packed experts' codes in the 4-bit range; K2 on the
            # same int8-stored codes is the second reference
            w4 = torch.randint(-8, 8, (e, k, nn), generator=gen, device=dev,
                               dtype=torch.int8)
            wq[::2] = w4[::2]
            cat, blk = build_ragged_mixed(wq, pflags)
            blk = torch.tensor(blk, dtype=torch.int32, device=dev)
            out = gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk)
            ref = gmp.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs, pf, blk)
            k2 = gmm.gmm_w8a8(aq, asc, wq, wsc, gs)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K4 vs plain at {regime} K={k}")
            _require_equal(out, k2, f"K4 vs K2 at {regime} K={k}")
            per_expert = [k * nn // 2 if f else k * nn for f in pflags]
            t = {**kernel_times(lambda: gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs,
                                                            pf, blk)),
                 "plain_ms": time_ms(lambda: gmp.gmm_mixed_packed_plain(
                     aq, asc, cat, wsc, gs, pf, blk)),
                 **gmm_work(gs, k, nn, per_expert, meta_bytes=8 * e)}
            sched = _k4_schedule(m, k, nn, e)
            emit("kernels", kernel="gmm_mixed_packed", bitwise=True,
                 equals_gmm_w8a8=True, packed_experts=sum(pflags), schedule=sched,
                 gmm_w8a8_same_codes_ms=time_ms(
                     lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, gs)), **shape, **t)
            if keep and k == h:
                rec["gmm_mixed_packed"].update(t, schedule=sched)
            if _chunk_gate_up(shape, k, h, False):
                rec["gmm_mixed_packed"]["prefill"] = {**shape, **t, "schedule": sched}
            del cat, wq
            # K5: every expert packed; K4 on the same bytes and K2 on the
            # unpacked codes are the other references
            packed = pack_int4_halves(w4)
            out = g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)
            ref = g4p.gmm_w4a8_packed_plain(aq, asc, packed, wsc, gs)
            k4 = gmp.gmm_mixed_packed(aq, asc, packed.reshape(-1, nn), wsc, gs,
                                      pf_all, blk_all)
            k2 = gmm.gmm_w8a8(aq, asc, w4, wsc, gs)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K5 vs plain at {regime} K={k}")
            _require_equal(out, k4, f"K5 vs K4 at {regime} K={k}")
            _require_equal(out, k2, f"K5 vs K2 at {regime} K={k}")
            t = {**kernel_times(lambda: g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)),
                 "plain_ms": time_ms(lambda: g4p.gmm_w4a8_packed_plain(
                     aq, asc, packed, wsc, gs)),
                 **gmm_work(gs, k, nn, k * nn // 2)}
            emit("kernels", kernel="gmm_w4a8_packed", bitwise=True,
                 equals_gmm_mixed_packed=True, equals_gmm_w8a8=True, **shape, **t)
            if keep and k == h:
                rec["gmm_w4a8_packed"].update(t)
            del packed, w4

    # the real-quantized shared expert: K1 with one bit width expanded over
    # the rows, then K2 with one group, for each of its two dense products
    sn = cfg.shared_expert_intermediate_size
    a8 = torch.tensor(8.0, device=dev)
    for regime, rows in (("decode", 4), ("prefill", 256)):
        one_group = torch.full((1,), rows, dtype=torch.int32, device=dev)
        for k, nn in ((h, 2 * sn), (sn, h)):
            x = torch.randn((rows, k), generator=gen, device=dev).to(torch.bfloat16)
            bits = a8.expand(rows)
            q, s = act_quant.quantize_rows(x, bits)
            qp, sp = act_quant.quantize_rows_plain(x, bits)
            torch.cuda.synchronize()
            _require_equal(q, qp, f"K1 codes (shared expert) at {regime} K={k}")
            _require_equal(s, sp, f"K1 scales (shared expert) at {regime} K={k}")
            emit("kernels", kernel="quantize_rows",
                 use="shared expert, expanded bits", regime=regime, M=rows, K=k,
                 bitwise=True,
                 **kernel_times(lambda: act_quant.quantize_rows(x, bits)),
                 plain_ms=time_ms(lambda: act_quant.quantize_rows_plain(x, bits)),
                 **quant_rows_work(rows, k, 2))
            aq = torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                               dtype=torch.int8)
            asc = torch.rand((rows, 1), generator=gen, device=dev) * 0.05
            wq = torch.randint(-127, 128, (1, k, nn), generator=gen, device=dev,
                               dtype=torch.int8)
            wsc = torch.rand((1, 1, nn), generator=gen, device=dev) * 0.01
            out = gmm.gmm_w8a8(aq, asc, wq, wsc, one_group)
            ref = gmm.gmm_w8a8_plain(aq, asc, wq, wsc, one_group)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K2 (shared expert) at {regime} K={k}")
            emit("kernels", kernel="gmm_w8a8", use="shared expert, one group",
                 regime=regime, M=rows, K=k, N=nn, bitwise=True,
                 **kernel_times(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, one_group)),
                 plain_ms=time_ms(lambda: gmm.gmm_w8a8_plain(aq, asc, wq, wsc,
                                                             one_group)),
                 **gmm_work(one_group, k, nn, k * nn))


def headline_quant_rows() -> None:
    """K1 at the headline's rows (every expert's rows padded to 128: 36736 at
    K 2048 and 1408; the shared expert's 8192 at K 5632, a block a row),
    per-row bits 4 / 8 as the mixed arm gives them: codes and scales bitwise
    the plain version, timed beside it."""
    import torch

    from mxmoe_tpu_torch.bench import workloads
    from mxmoe_tpu_torch.ops import act_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    wl = workloads.qwen2_moe_l10_bs8192()[0]
    m = sum((s + 127) // 128 * 128 for s in wl.group_sizes)
    for rows, k in ((m, 2048), (m, 1408), (wl.shared_m, 5632)):
        x = torch.randn((rows, k), generator=gen, device=dev).to(torch.bfloat16)
        bits = torch.tensor([4.0, 8.0], device=dev).repeat(rows // 2).contiguous()
        q, s = act_quant.quantize_rows(x, bits)
        qp, sp = act_quant.quantize_rows_plain(x, bits)
        torch.cuda.synchronize()
        _require_equal(q, qp, f"K1 codes at the headline's {rows} x {k}")
        _require_equal(s, sp, f"K1 scales at the headline's {rows} x {k}")
        emit("kernels", kernel="quantize_rows", use="headline rows", M=rows, K=k,
             bitwise=True, **kernel_times(lambda: act_quant.quantize_rows(x, bits)),
             plain_ms=time_ms(lambda: act_quant.quantize_rows_plain(x, bits), reps=3),
             **quant_rows_work(rows, k, 2))
        del x, q, qp


def _chunk_gate_up(shape: dict, k: int, h: int, shared: bool) -> bool:
    """Whether a kernels-phase case is the routed gate_up GEMM of a 256-token
    prefill chunk: the shape the last line's ``prefill`` entries keep."""
    return shape.get("regime") == "prefill" and k == h and not shared


def scheme_kernels_vs_plain(rec: dict) -> None:
    """K6-K9 at the decode and prefill shapes of both expert GEMMs and, with
    one group of rows, at the shared expert's shapes. K8 and K9 bitwise
    against their plain versions; K6 and K7 within
    ``gmm_weight_only.error_over_bound`` of the float64 product of the same
    bf16 weights (f32 accumulation over K terms in any order, + 1 bf16 ulp of
    the output), K7 bitwise K6 on the unpacked codes."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.ops import gmm_w8a8 as gmm, gmm_w8a8_asym as gasym
    from mxmoe_tpu_torch.ops import gmm_w8a8_grouped as ggrp
    from mxmoe_tpu_torch.ops import gmm_weight_only as gwo
    from mxmoe_tpu_torch.ops import gmm_weight_only_packed as gwop
    from mxmoe_tpu_torch.quant.packing import pack_int4_halves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    sn = cfg.shared_expert_intermediate_size

    def rand(shape, scale, shift=0.0):
        return torch.rand(shape, generator=gen, device=dev) * scale + shift

    def codes(shape, hi):
        return torch.randint(-hi, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def timed(kernel, plain, work):
        return {**kernel_times(kernel), "plain_ms": time_ms(plain, reps=5, warmup=1),
                **work}

    def int8_kernels(gs, m, k, nn, shape, keep, shared):
        """K9 (routed shapes only) and K8 without / with rhs_zp."""
        ne, g = gs.numel(), k // GSIZE
        aq = codes((m, k), 128).clamp_(min=-127)
        wq = codes((ne, k, nn), 128).clamp_(min=-127)
        if not shared:
            asc, wsc = rand((m, 1), 0.05, 1e-3), rand((ne, 1, nn), 0.01, 1e-4)
            wzp = torch.randn((ne, 1, nn), generator=gen, device=dev) * 0.02
            out = gasym.gmm_w8a8_asym(aq, asc, wq, wsc, wzp, gs)
            ref = gasym.gmm_w8a8_asym_plain(aq, asc, wq, wsc, wzp, gs)
            k8 = ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, gsize=-1, rhs_zp=wzp)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K9 vs plain at {shape}")
            _require_equal(out, k8, f"K9 vs K8 with one group at {shape}")
            t = timed(lambda: gasym.gmm_w8a8_asym(aq, asc, wq, wsc, wzp, gs),
                      lambda: gasym.gmm_w8a8_asym_plain(aq, asc, wq, wsc, wzp, gs),
                      gmm_work(gs, k, nn, k * nn, scale_rows=2))
            sched = _k9_schedule(m, k, nn, ne)
            emit("kernels", kernel="gmm_w8a8_asym", bitwise=True,
                 equals_gmm_w8a8_grouped_one_group=True, schedule=sched,
                 gmm_w8a8_same_codes_ms=time_ms(
                     lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, gs)), **shape, **t)
            if keep:
                rec["gmm_w8a8_asym"].update(t, schedule=sched)
            if _chunk_gate_up(shape, k, h, shared):
                rec["gmm_w8a8_asym"]["prefill"] = {**shape, **t, "schedule": sched}
        asc, wsc = rand((m, g), 0.05, 1e-3), rand((ne, g, nn), 0.01, 1e-4)
        wzp = torch.randn((ne, g, nn), generator=gen, device=dev) * 0.02
        for zp in (None, wzp):
            out = ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, GSIZE, zp)
            ref = ggrp.gmm_w8a8_grouped_plain(aq, asc, wq, wsc, gs, GSIZE, zp)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K8 vs plain at {shape} zp={zp is not None}")
            t = timed(lambda: ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, GSIZE, zp),
                      lambda: ggrp.gmm_w8a8_grouped_plain(aq, asc, wq, wsc, gs,
                                                          GSIZE, zp),
                      gmm_work(gs, k, nn, k * nn, lhs_row_bytes=k + 4 * g,
                               scale_rows=g * (1 if zp is None else 2)))
            emit("kernels", kernel="gmm_w8a8_grouped", bitwise=True, gsize=GSIZE,
                 rhs_zp=zp is not None, schedule=_grouped_schedule(m, k, nn, ne),
                 **shape, **t)
            if keep and zp is None:
                rec["gmm_w8a8_grouped"].update(t, schedule=_grouped_schedule(m, k, nn,
                                                                            ne))
            if _chunk_gate_up(shape, k, h, shared) and zp is None:
                rec["gmm_w8a8_grouped"]["prefill"] = {
                    **shape, **t, "schedule": _grouped_schedule(m, k, nn, ne)}

    def weight_only_kernels(gs, m, k, nn, shape, keep, shared, gsize=GSIZE):
        """K6 and (routed shapes only) K7, 4-bit codes, scale and zp per group."""
        ne, g = gs.numel(), (1 if gsize == -1 else k // gsize)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w4 = codes((ne, k, nn), 8)
        sc = rand((ne, g, nn), 0.02, 1e-3)
        zp = torch.randn((ne, g, nn), generator=gen, device=dev) * 0.05
        out = gwo.gmm_weight_only(x, w4, sc, zp, gs, gsize)
        torch.cuda.synchronize()
        err, ratio = gwo.error_over_bound(out, x, w4, sc, zp, gs, gsize)
        if not ratio <= 1.0:
            raise AssertionError(f"K6 outside its bound at {shape}: max|d|={err}, "
                                 f"{ratio} of the tolerance")
        scales = dict(scale_rows=2 * g, lhs_row_bytes=2 * k, ops_type="bf16")
        t = timed(lambda: gwo.gmm_weight_only(x, w4, sc, zp, gs, gsize),
                  lambda: gwo.gmm_weight_only_plain(x, w4, sc, zp, gs, gsize),
                  gmm_work(gs, k, nn, k * nn, **scales))
        sched = _wo_schedule(m, k, nn, ne, gsize)
        emit("kernels", kernel="gmm_weight_only", gsize=gsize, max_abs_err=err,
             err_over_bound=ratio, schedule=sched,
             bound="K * 2^-24 * sum|lhs||w| + 1 bf16 ulp, vs float64", **shape, **t)
        if keep:
            rec["gmm_weight_only"].update(max_abs_err=err, schedule=sched, **t)
        if _chunk_gate_up(shape, k, h, shared) and gsize != -1:
            rec["gmm_weight_only"]["prefill"] = {**shape, **t, "schedule": sched}
        if shared or gsize == -1:
            return
        packed = pack_int4_halves(w4)
        out_p = gwop.gmm_weight_only_packed(x, packed, sc, zp, gs, gsize)
        torch.cuda.synchronize()
        _require_equal(out_p, out, f"K7 vs K6 at {shape}")
        t = timed(lambda: gwop.gmm_weight_only_packed(x, packed, sc, zp, gs, gsize),
                  lambda: gwop.gmm_weight_only_packed_plain(x, packed, sc, zp, gs,
                                                            gsize),
                  gmm_work(gs, k, nn, k * nn // 2, **scales))
        emit("kernels", kernel="gmm_weight_only_packed", gsize=gsize,
             equals_gmm_weight_only=True, max_abs_err=err, err_over_bound=ratio,
             schedule=sched, **shape, **t)
        if keep:
            rec["gmm_weight_only_packed"].update(max_abs_err=err, schedule=sched, **t)
        if _chunk_gate_up(shape, k, h, shared):
            rec["gmm_weight_only_packed"]["prefill"] = {**shape, **t, "schedule": sched}

    for regime, tokens in (("decode", 4), ("prefill", 256)):
        m = tokens * cfg.top_k
        gs = _routing_group_sizes(tokens, cfg, gen, dev)
        for k, nn in ((h, 2 * n), (n, h)):
            shape = dict(regime=regime, M=m, K=k, N=nn,
                         empty_groups=int((gs == 0).sum().item()))
            keep = regime == "decode" and k == h
            int8_kernels(gs, m, k, nn, shape, keep, shared=False)
            weight_only_kernels(gs, m, k, nn, shape, keep, shared=False)
            if regime == "decode":      # the per-channel a16 serve's K6
                weight_only_kernels(gs, m, k, nn, shape, False, False, gsize=-1)
    # the grouped / asymmetric and the weight-only shared expert: one group
    for regime, rows in (("decode", 4), ("prefill", 256)):
        one_group = torch.full((1,), rows, dtype=torch.int32, device=dev)
        for k, nn in ((h, 2 * sn), (sn, h)):
            shape = dict(use="shared expert, one group", regime=regime, M=rows,
                         K=k, N=nn)
            int8_kernels(one_group, rows, k, nn, shape, False, shared=True)
            weight_only_kernels(one_group, rows, k, nn, shape, False, shared=True)


def mixed_wo_wxa_work(gs, flags, k: int, n: int, groups: int, zp: bool) -> dict:
    """K10 on THIS routing and THESE flags: every routed expert streams its
    int8 codes and its scale (and zp) rows; a weight-only expert's rows are
    read as bf16 and multiplied at the bf16 rate, a w x a expert's as int8
    codes with ``groups`` f32 scales at the int8 rate."""
    live = gs > 0
    rows_wo = int(gs[flags.bool()].sum())
    rows_wxa = int(gs.sum()) - rows_wo
    e = gs.numel()
    nbytes = (int(live.sum()) * (k * n + groups * n * 4 * (2 if zp else 1))
              + rows_wo * 2 * k + rows_wxa * (k + 4 * groups) + 2 * e * 4
              + (rows_wo + rows_wxa) * n * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * rows_wo * k * n / PEAK_OPS_PER_S["bf16"]
             + 2 * rows_wxa * k * n / PEAK_OPS_PER_S["int8"]) * 1e3
    return {"bytes": int(nbytes), "ops": 2 * (rows_wo + rows_wxa) * k * n,
            "ops_type": "bf16 + int8", "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def two_launch_kernels_vs_plain(rec: dict) -> None:
    """K4f, K10 (both bodies) and K11 at the decode and prefill shapes of both
    expert GEMMs. K4f bitwise its plain version and bitwise K8 on the unpacked
    codes (gate_up without a straddling group, down with one; without and with
    zero points; at decode also a layer with no packed expert and one with all
    packed). K10: w x a experts bitwise K8 (flex body) or K2 (per-channel
    body) and bitwise the plain version, weight-only experts bitwise K6 on
    the same codes and within ``gmm_weight_only.error_over_bound``; flags
    alternating (timed), all 0 and all 1. K11 within ``gmm.error_over_bound``
    of the float64 product, timed beside the stock ``torch._grouped_mm``. Then
    the int8 lm_head's product (K1 + K2 with one group, N = vocab) bitwise,
    timed beside the bf16 head's matmul."""
    import torch

    from mxmoe_tpu_torch.bench import workloads
    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.ops import act_quant, gmm as gfl, gmm_mixed_packed as gmp
    from mxmoe_tpu_torch.ops import gmm_mixed_wo_wxa as gmx, gmm_w8a8 as gmm
    from mxmoe_tpu_torch.ops import gmm_w8a8_grouped as ggrp
    from mxmoe_tpu_torch.ops import gmm_weight_only as gwo
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed
    from mxmoe_tpu_torch.trace import profiler

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts

    def rand(shape, scale, shift=0.0):
        return torch.rand(shape, generator=gen, device=dev) * scale + shift

    def codes(shape, hi):
        return torch.randint(-hi, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def timed(kernel, plain, work):
        return {**kernel_times(kernel), "plain_ms": time_ms(plain, reps=5, warmup=1),
                **work}

    alternating = [int(i % 2 == 0) for i in range(e)]

    def flex_packed(gs, m, k, nn, shape, keep, storages):
        g = k // GSIZE
        aq = codes((m, k), 128).clamp_(min=-127)
        asc, wsc = rand((m, g), 0.05, 1e-3), rand((e, g, nn), 0.01, 1e-4)
        wzp = torch.randn((e, g, nn), generator=gen, device=dev) * 0.02
        w8, w4 = codes((e, k, nn), 128).clamp_(min=-127), codes((e, k, nn), 8)
        for label, pflags in storages:
            pfb = torch.tensor(pflags, dtype=torch.bool, device=dev)
            wq = torch.where(pfb[:, None, None], w4, w8)
            cat, blk = build_ragged_mixed(wq, pflags)
            pf = pfb.to(torch.int32)
            blk = torch.tensor(blk, dtype=torch.int32, device=dev)
            for zp in (None, wzp):
                out = gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk, rhs_zp=zp)
                ref = gmp.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs, pf, blk,
                                                 rhs_zp=zp)
                k8 = ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, GSIZE, zp)
                torch.cuda.synchronize()
                what = f"{label} at {shape} zp={zp is not None}"
                _require_equal(out, ref, f"K4f vs plain, {what}")
                _require_equal(out, k8, f"K4f vs K8, {what}")
                per_expert = [k * nn // 2 if f else k * nn for f in pflags]
                t = timed(lambda: gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk,
                                                       rhs_zp=zp),
                          lambda: gmp.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs,
                                                             pf, blk, rhs_zp=zp),
                          gmm_work(gs, k, nn, per_expert, meta_bytes=8 * e,
                                   lhs_row_bytes=k + 4 * g,
                                   scale_rows=g * (1 if zp is None else 2)))
                sched = _grouped_schedule(m, k, nn, e, mixed=True)
                emit("kernels", kernel="gmm_mixed_packed_flex", storage=label,
                     bitwise=True, equals_gmm_w8a8_grouped=True, gsize=GSIZE,
                     straddling_group=(k // 2) % GSIZE != 0, rhs_zp=zp is not None,
                     packed_experts=sum(pflags), schedule=sched,
                     gmm_w8a8_grouped_same_codes_ms=time_ms(
                         lambda: ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, GSIZE, zp)),
                     **shape, **t)
                if keep and label == "alternating" and zp is not None:
                    rec["gmm_mixed_packed_flex"].update(t, schedule=sched)
                if (_chunk_gate_up(shape, k, h, False) and label == "alternating"
                        and zp is not None):
                    rec["gmm_mixed_packed_flex"]["prefill"] = {**shape, **t,
                                                               "schedule": sched}
            del cat, wq

    def wo_wxa(gs, m, k, nn, shape, keep, gsize, with_zp, mixes):
        g = 1 if gsize == -1 else k // gsize
        body = "per-channel" if gsize == -1 else "flex"
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        aq = codes((m, k), 128).clamp_(min=-127)
        asc = rand((m, g), 0.05, 1e-3)
        w4 = codes((e, k, nn), 8)
        wsc = rand((e, g, nn), 0.02, 1e-3)
        wzp = torch.randn((e, g, nn), generator=gen, device=dev) * 0.05
        zp = wzp if with_zp else None
        zp6 = wzp if with_zp else torch.zeros_like(wsc)
        k8 = ggrp.gmm_w8a8_grouped(aq, asc, w4, wsc, gs, gsize, zp)
        k6 = gwo.gmm_weight_only(x, w4, wsc, zp6, gs, gsize)
        k2 = gmm.gmm_w8a8(aq, asc, w4, wsc, gs) if body == "per-channel" else None
        for label, fl in mixes:
            flags = torch.tensor(fl, dtype=torch.int32, device=dev)
            out = gmx.gmm_mixed_wo_wxa(x, aq, asc, w4, wsc, flags, gs, rhs_zp=zp)
            ref = gmx.gmm_mixed_wo_wxa_plain(x, aq, asc, w4, wsc, flags, gs, rhs_zp=zp)
            torch.cuda.synchronize()
            wo = torch.repeat_interleave(flags, gs.long()).bool()
            what = f"{body} body, flags {label}, at {shape}"
            _require_equal(out[~wo], k8[~wo], f"K10 w x a rows vs K8, {what}")
            _require_equal(out[~wo], ref[~wo], f"K10 w x a rows vs plain, {what}")
            if k2 is not None:
                _require_equal(out[~wo], k2[~wo], f"K10 w x a rows vs K2, {what}")
            _require_equal(out[wo], k6[wo], f"K10 weight-only rows vs K6, {what}")
            err, ratio = 0.0, 0.0
            if bool(wo.any()):
                rows = torch.nonzero(wo)[:, 0]
                err, ratio = gwo.error_over_bound(
                    out[rows].contiguous(), x[rows].contiguous(), w4, wsc, zp6,
                    torch.where(flags.bool(), gs, torch.zeros_like(gs)), gsize)
                if not ratio <= 1.0:
                    raise AssertionError(f"K10 weight-only rows outside their bound, "
                                         f"{what}: max|d|={err}, {ratio} of it")
            t = timed(lambda: gmx.gmm_mixed_wo_wxa(x, aq, asc, w4, wsc, flags, gs,
                                                   rhs_zp=zp),
                      lambda: gmx.gmm_mixed_wo_wxa_plain(x, aq, asc, w4, wsc, flags,
                                                         gs, rhs_zp=zp),
                      mixed_wo_wxa_work(gs, flags, k, nn, g, with_zp))
            sched = _wo_schedule(m, k, nn, e, gsize)
            emit("kernels", kernel="gmm_mixed_wo_wxa", body=body, flags=label,
                 schedule=sched, weight_only_experts=sum(fl), wxa_rows_bitwise=True,
                 wo_rows_equal_gmm_weight_only=True, max_abs_err=err,
                 err_over_bound=ratio, gsize=gsize, rhs_zp=with_zp,
                 gmm_w8a8_grouped_same_codes_ms=time_ms(
                     lambda: ggrp.gmm_w8a8_grouped(aq, asc, w4, wsc, gs, gsize, zp)),
                 gmm_weight_only_same_codes_ms=time_ms(
                     lambda: gwo.gmm_weight_only(x, w4, wsc, zp6, gs, gsize)),
                 **shape, **t)
            if keep and body == "flex" and label == "alternating":
                rec["gmm_mixed_wo_wxa"].update(max_abs_err=err, schedule=sched, **t)
            if (_chunk_gate_up(shape, k, h, False) and body == "flex"
                    and label == "alternating"):
                rec["gmm_mixed_wo_wxa"]["prefill"] = {**shape, **t, "schedule": sched}

    def float_gmm(gs, m, k, nn, shape, keep):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((e, k, nn), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        out = gfl.gmm_bf16(x, w, gs)
        lib = gfl.gmm(x, w, gs, backend="ragged_dot")
        torch.cuda.synchronize()
        err, ratio = gfl.error_over_bound(out, x, w, gs)
        lib_err, lib_ratio = gfl.error_over_bound(lib, x, w, gs)
        if not ratio <= 1.0:
            raise AssertionError(f"K11 outside its bound at {shape}: max|d|={err}, "
                                 f"{ratio} of the tolerance")
        t = timed(lambda: gfl.gmm_bf16(x, w, gs),
                  lambda: gfl.gmm_bf16_plain(x, w, gs),
                  gmm_work(gs, k, nn, 2 * k * nn, scale_rows=0, lhs_row_bytes=2 * k,
                           ops_type="bf16"))
        t["library_ms"] = time_ms(lambda: gfl.gmm(x, w, gs, backend="ragged_dot"))
        t["library_device_ms"] = device_ms(lambda: gfl.gmm(x, w, gs,
                                                           backend="ragged_dot"))
        body = gfl.bf16_gmm_schedule(x.dtype).body
        emit("kernels", kernel="gmm_bf16", body=body, max_abs_err=err,
             err_over_bound=ratio,
             bound="(K + 1) * 2^-24 * sum|lhs||rhs| + 1 bf16 ulp, vs float64",
             library="torch._grouped_mm" if gfl.has_grouped_mm() else "masked products",
             library_max_abs_err=lib_err, library_err_over_bound=lib_ratio,
             **shape, **t)
        if keep is True:
            rec["gmm_bf16"].update(max_abs_err=err, body=body, **t)
        elif keep:
            rec["gmm_bf16"][keep] = {"body": body, "max_abs_err": err, **shape, **t}

    all0, all1 = [0] * e, [1] * e
    for regime, tokens in (("decode", 4), ("prefill", 256)):
        m = tokens * cfg.top_k
        gs = _routing_group_sizes(tokens, cfg, gen, dev)
        decode = regime == "decode"
        for k, nn in ((h, 2 * n), (n, h)):
            shape = dict(regime=regime, M=m, K=k, N=nn,
                         empty_groups=int((gs == 0).sum().item()))
            keep = decode and k == h
            storages = [("alternating", alternating)]
            if keep:
                storages += [("none packed", all0), ("all packed", all1)]
            flex_packed(gs, m, k, nn, shape, keep, storages)
            mixes = [("alternating", alternating)]
            if decode:
                mixes += [("all w x a", all0), ("all weight-only", all1)]
            wo_wxa(gs, m, k, nn, shape, keep, GSIZE, True, mixes)
            wo_wxa(gs, m, k, nn, shape, keep, -1, False, mixes)
            float_gmm(gs, m, k, nn, shape,
                      keep or ("prefill" if k == h and not decode else False))

    # K11 at the profiler's three scales (its w16a16 row: gate_up, routed as
    # the table routes them) and at the headline's 32762 unaligned rows,
    # gate_up and down
    large = [(f"profiler {t} tokens", workloads.synthetic_workload(e, t, cfg.top_k, h,
                                                                  2 * n),
              "large" if t == max(profiler.SCALES) else False)
             for t in profiler.SCALES]
    large += [("headline", wl, False) for wl in workloads.qwen2_moe_l10_bs8192()]
    t0 = time.perf_counter()
    for use, wl, keep in large:
        gs = torch.tensor(wl.group_sizes, dtype=torch.int32, device=dev)
        shape = dict(regime=use, M=wl.m_total, K=wl.k, N=wl.n,
                     empty_groups=int((gs == 0).sum().item()))
        float_gmm(gs, wl.m_total, wl.k, wl.n, shape, keep)
        torch.cuda.empty_cache()
    emit("kernels", kernel="gmm_bf16", use="the large-M checks above",
         seconds=time.perf_counter() - t0)

    # the int8 lm_head: K1 + K2 with one group over the whole vocabulary
    v = cfg.vocab_size
    wq = codes((1, h, v), 128).clamp_(min=-127)
    wsc = rand((1, 1, v), 0.001, 1e-5)
    wbf = (wq[0].float() * wsc[0]).to(torch.bfloat16)
    for rows in (4, 256):
        x = torch.randn((rows, h), generator=gen, device=dev).to(torch.bfloat16)
        one_group = torch.full((1,), rows, dtype=torch.int32, device=dev)
        aq, asc = act_quant.quantize_rows_uniform(x, 8)
        out = gmm.gmm_w8a8(aq, asc, wq, wsc, one_group)
        ref = gmm.gmm_w8a8_plain(aq, asc, wq, wsc, one_group)
        torch.cuda.synchronize()
        _require_equal(out, ref, f"K2 (int8 lm_head) at M={rows}")
        emit("kernels", kernel="gmm_w8a8", use="int8 lm_head, one group", M=rows,
             K=h, N=v, bitwise=True,
             **kernel_times(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, one_group)),
             plain_ms=time_ms(lambda: gmm.gmm_w8a8_plain(aq, asc, wq, wsc, one_group),
                              reps=5, warmup=1),
             quantize_rows_ms=time_ms(lambda: act_quant.quantize_rows_uniform(x, 8)),
             bf16_head_matmul_ms=time_ms(lambda: x @ wbf),
             **gmm_work(one_group, h, v, h * v))


def combine_vs_index_add() -> None:
    """What the order-preserving combine costs: ``combine_tokens`` (sorted
    ``index_put_(accumulate=True)``) beside the atomic ``index_add_`` it
    replaced, on the same rows, at the decode and prefill sizes."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.ops.dispatch import (combine_tokens, make_dispatch,
                                              route_topk)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for regime, tokens in (("decode", 4), ("prefill", 256)):
        logits = torch.randn((tokens, cfg.num_experts), generator=gen, device=dev)
        disp = make_dispatch(route_topk(logits, cfg.top_k, cfg.norm_topk_prob),
                             cfg.num_experts)
        rows = torch.randn((tokens * cfg.top_k, cfg.hidden_size), generator=gen,
                           device=dev).to(torch.bfloat16)
        weighted = rows * disp.combine_weights[:, None].to(rows.dtype)
        idx = disp.token_ids.long()

        def zeros():
            return torch.zeros((tokens, cfg.hidden_size), dtype=rows.dtype,
                               device=dev)

        def atomic():
            return zeros().index_add_(0, idx, weighted)

        def sorted_put():
            return zeros().index_put_((idx,), weighted, accumulate=True)

        out = combine_tokens(rows, disp, tokens)
        again = combine_tokens(rows, disp, tokens)
        torch.cuda.synchronize()
        _require_equal(out, again, f"combine_tokens twice at {regime}")
        err = (out.float() - atomic().float()).abs().max().item()
        emit("combine", regime=regime, tokens=tokens, rows=tokens * cfg.top_k,
             reproducible=True, max_abs_diff_vs_index_add=err,
             index_put_ms=time_ms(sorted_put), index_add_ms=time_ms(atomic))


# K3 / K3q's cases: (label, n_h, n_kv, head dim, B, S, lengths, valid, operand
# dtypes). The serving cache of qwen2_moe (dk 128, G 4); the anchor model's
# head dim 32 (G 2) on the same lengths, write mask and cache length; and the
# anchor's real-execution decode step (eval_ppl_decode: 8 windows of 128
# positions, f32 activations) halfway through its windows
def _k3_cases(cfg):
    from mxmoe_tpu_torch.eval.anchor import anchor_config

    acfg = anchor_config()
    lengths, valid = [0, 700, 2048, 1500], [1, 1, 1, 0]
    a = (acfg.num_heads, acfg.num_kv_heads, acfg.head_dim)
    return (("serving", cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 4, 2048,
             lengths, valid, ("float32", "bfloat16")),
            ("dk32", *a, 4, 2048, lengths, valid, ("float32", "bfloat16")),
            ("anchor_decode", *a, 8, 128, [64] * 8, [1] * 8, ("float32",)))


def attention_kernels_vs_plain(rec: dict) -> None:
    """K3 and K3q at the serving cache (B=4 slots, S=2048; lengths 0, mid,
    full, and a slot with valid=0; bf16 operands, the serving path's, and f32
    ones), at the anchor's head dim 32 on the same lengths, and at the
    anchor's decode step (``_k3_cases``)."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.serving import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    nl, layer = 2, 1
    for case, n_h, n_kv, hd, b, s_max, lens, vals, dtypes in _k3_cases(cfg):
        scale = 1.0 / hd ** 0.5
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = torch.tensor(vals, dtype=torch.int32, device=dev)

        def bf16_cache():
            return torch.randn((nl, b, n_kv, s_max, hd), generator=gen,
                               device=dev).to(torch.bfloat16)

        def int8_codes():
            return torch.randint(-127, 128, (nl, b, n_kv, s_max, hd), generator=gen,
                                 device=dev, dtype=torch.int8)

        def f32_scales():
            return (torch.rand((nl, b, n_kv, s_max), generator=gen, device=dev) * 0.03
                    + 1e-3)

        forms = (
            ("decode_attention_update_stacked", "K3",
             lambda: [bf16_cache(), None, bf16_cache(), None], 2 * hd * 2),
            ("decode_attention_update_stacked_q8", "K3q",
             lambda: [int8_codes(), f32_scales(), int8_codes(), f32_scales()],
             2 * hd + 8),
        )
        for name, label, make_caches, pos_bytes in forms:
            for dtype in (getattr(torch, d) for d in dtypes):
                caches = make_caches()
                caches2 = [c if c is None else c.clone() for c in caches]
                q = torch.randn((b, n_h, hd), generator=gen, device=dev).to(dtype)
                kn = torch.randn((b, n_kv, hd), generator=gen, device=dev).to(dtype)
                vn = torch.randn((b, n_kv, hd), generator=gen, device=dev).to(dtype)

                def kernel():
                    return da.decode_attention_update_stacked(
                        q, kn, vn, *caches, lengths, layer, valid=valid)[0]

                def plain():
                    if caches2[1] is None:
                        return da.decode_attention_update_plain(
                            q, kn, vn, caches2[0], caches2[2], lengths, layer, valid,
                            scale)
                    return da.decode_attention_update_q8_plain(
                        q, kn, vn, *caches2, lengths, layer, valid, scale)

                out, ref = kernel(), plain()
                torch.cuda.synchronize()
                for got, want in zip(caches, caches2):
                    if got is not None and not torch.equal(got, want):
                        raise AssertionError(f"{label} cache write not bitwise "
                                             f"({case}, {dtype})")
                rel = k3_slot_errors(out, ref)
                err = (out.float() - ref.float()).abs().max().item()
                t = {**kernel_times(kernel), "plain_ms": time_ms(plain),
                     **decode_attn_work(lengths, valid, s_max, n_h, n_kv, hd, hd,
                                        q.element_size(), pos_bytes)}
                emit("kernels", kernel=name, regime="decode", case=case,
                     dtype=str(dtype).removeprefix("torch."), B=b, S=s_max,
                     n_h=n_h, n_kv=n_kv, dk=hd, lengths=lengths.tolist(),
                     valid=valid.tolist(), cache_bitwise=True,
                     max_abs_err=err, rel_err_per_slot=rel,
                     slot_scale=ref.float().abs().flatten(1).amax(1).tolist(),
                     bound=f"{K3_REL_BOUND} * max|ref[b]|"
                           + (" + 1 bf16 ulp" if dtype == torch.bfloat16 else ""), **t)
                if case == "serving" and dtype == torch.bfloat16:
                    rec[name].update(max_abs_err=err, **t)
                elif case == "anchor_decode":
                    rec[name]["anchor_decode"] = {"max_abs_err": err, **t}
                del caches, caches2


def read_attn_work(lengths, s_max, n_h, n_kv, dk, dv, elem_bytes,
                   cache_pos_bytes) -> dict:
    """The read-only decode attention on THESE lengths: a slot reads
    min(len, S-1) + 1 cached positions (``cache_pos_bytes`` per kv head and
    position, K and V and any scales), q in and the output out; nothing is
    written to the cache."""
    nbytes = ops = 0
    for ln in lengths.tolist():
        n_pos = min(max(ln, 0), s_max - 1) + 1
        nbytes += n_pos * n_kv * cache_pos_bytes + n_h * (dk + dv) * elem_bytes
        ops += 2 * n_h * n_pos * (dk + dv)
    return work_bound(nbytes, ops, "bf16")


def read_only_attention_vs_plain(rec: dict) -> None:
    """decode_attention_stacked (bf16 / int8 cache), decode_attention and
    decode_attention_q8 at K3's serving cache (B 4, S 2048, lengths 0, 700,
    S, 1500; bf16 q), at two shapes: qwen2_moe (n_h = n_kv = 16, dk = dv =
    128) and ds2's MLA (n_h = n_kv = 16, dk 256 whose last 64 lanes are the
    zero padding, dv 128, scale 1/sqrt(192)). Each form within K3_REL_BOUND
    per slot (+ 1 bf16 ulp) of its plain version; the stacked forms run on the
    cache K3 / K3q has just written for the same step with the same q, and
    equal K3 / K3q's output bitwise (one body: K3 takes the new position from
    shared memory, the read-only form from the cache it was written to); the
    per-layer forms equal the stacked one on that layer bitwise. The bf16
    forms are timed beside ``scaled_dot_product_attention`` (boolean length
    mask, ``enable_gqa``). The ds2 shape's numbers go to the kernels line."""
    import torch
    import torch.nn.functional as F

    from mxmoe_tpu_torch.serving import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s_max, nl, layer = 4, 2048, 2, 1
    lengths = torch.tensor([0, 700, s_max, 1500], dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)
    pos = torch.arange(s_max, device=dev)
    mask = (pos[None, :] <= lengths.clamp(max=s_max - 1)[:, None])[:, None, None, :]
    shapes = {"qwen2_moe": (16, 16, 128, 128, 128),
              "ds2_mla": (16, 16, 256, 128, 192)}    # n_h, n_kv, dk, dv, qk dim
    for shape, (n_h, n_kv, dk, dv, d_qk) in shapes.items():
        scale = 1.0 / d_qk ** 0.5

        def zero_tail(t):                  # MLA: the padded lanes hold zeros
            t[..., d_qk:] = 0
            return t

        def randn(*shape_):
            return torch.randn(shape_, generator=gen, device=dev).to(torch.bfloat16)

        def codes(d):
            return torch.randint(-127, 128, (nl, b, n_kv, s_max, d), generator=gen,
                                 device=dev, dtype=torch.int8)

        def scales():
            return torch.rand((nl, b, n_kv, s_max), generator=gen, device=dev) * 0.03 + 1e-3

        q = zero_tail(randn(b, n_h, dk))
        kn, vn = zero_tail(randn(b, n_kv, dk)), randn(b, n_kv, dv)
        for quant in (False, True):
            if quant:
                caches = [zero_tail(codes(dk)), scales(), codes(dv), scales()]
                pos_bytes = dk + dv + 8
            else:
                caches = [zero_tail(randn(nl, b, n_kv, s_max, dk)), None,
                          randn(nl, b, n_kv, s_max, dv), None]
                pos_bytes = 2 * (dk + dv)
            upd, _ = da.decode_attention_update_stacked(q, kn, vn, *caches, lengths,
                                                        layer, valid=valid,
                                                        scale=scale)
            layer_caches = [c if c is None else c[layer] for c in caches]
            stacked_name = "decode_attention_stacked" + ("_q8" if quant else "")
            per_layer_name = "decode_attention_q8" if quant else "decode_attention"

            def stacked():
                return da.decode_attention_stacked(q, *caches, lengths, layer,
                                                   scale=scale)[0]

            def stacked_plain():
                return da.decode_attention_stacked_plain(q, *caches, lengths, layer,
                                                         scale)

            if quant:
                def per_layer():
                    return da.decode_attention_q8(q, *layer_caches, lengths,
                                                  scale=scale)
            else:
                def per_layer():
                    return da.decode_attention(q, layer_caches[0], layer_caches[2],
                                               lengths, scale=scale)

            out, ref, out_l = stacked(), stacked_plain(), per_layer()
            torch.cuda.synchronize()
            bitwise_update = torch.equal(out, upd)
            bitwise_layer = torch.equal(out_l, out)
            lib = {}
            if not quant:
                kk, vv = layer_caches[0], layer_caches[2]

                def library():
                    return F.scaled_dot_product_attention(
                        q[:, :, None, :], kk, vv, attn_mask=mask, scale=scale,
                        enable_gqa=n_h != n_kv)

                lib = {"library_ms": time_ms(library),
                       "library_device_ms": device_ms(library),
                       "library_max_abs_diff": (library()[:, :, 0].float()
                                                - ref.float()).abs().max().item()}
            work = read_attn_work(lengths, s_max, n_h, n_kv, dk, dv, q.element_size(),
                                  pos_bytes)
            # the per-layer forms' plain version is the stacked one's on that layer
            for name, kernel, plain, got in ((stacked_name, stacked, stacked_plain, out),
                                             (per_layer_name, per_layer,
                                              stacked_plain, out_l)):
                rel = k3_slot_errors(got, ref)
                t = {"max_abs_err": (got.float() - ref.float()).abs().max().item(),
                     **kernel_times(kernel), "plain_ms": time_ms(plain), **work,
                     "library_ms": lib.get("library_ms"),
                     "library_device_ms": lib.get("library_device_ms")}
                emit("kernels", kernel=name, shape=shape, regime="decode",
                     dtype="bfloat16", B=b, S=s_max, n_h=n_h, n_kv=n_kv, dk=dk, dv=dv,
                     scale=scale, lengths=lengths.tolist(), rel_err_per_slot=rel,
                     bitwise_k3_after_its_write=bitwise_update,
                     per_layer_bitwise_stacked=bitwise_layer,
                     library_max_abs_diff=lib.get("library_max_abs_diff"),
                     bound=f"{K3_REL_BOUND} * max|ref[b]| + 1 bf16 ulp", **t)
                if shape == "ds2_mla":
                    rec[name].update(t)
            if not (bitwise_update and bitwise_layer):
                raise AssertionError(
                    f"{stacked_name} ({shape}): not bitwise K3 after its write "
                    f"({bitwise_update}) or the per-layer form ({bitwise_layer})")
            del caches, layer_caches


def ffn_work(gs, k: int, n: int, h: int, expert_bytes, out_bytes: int = 2) -> dict:
    """K12 / K13 on THIS layout: every row the kernel is given (the aligned
    dispatch's padding rows included) is read as int8 codes and a scale and
    written once; each live expert streams its gate_up and down codes
    (``expert_bytes[e]``) and its scale rows; the hq intermediate never has
    to leave the chip, so it is not counted. Operations: both int8 GEMMs."""
    import torch

    live = gs > 0
    rows = int(gs.sum())
    e = gs.numel()
    w = torch.as_tensor(expert_bytes, device=gs.device).expand(e)
    nbytes = (rows * (k + 4) + int(w[live].sum()) + int(live.sum()) * (2 * n + h) * 4
              + 2 * e * 4 + rows * h * out_bytes)
    return work_bound(nbytes, 2 * rows * (k * 2 * n + n * h), "int8")


def _reference_ffn_setup(seed: int = 7):
    """The reference test's K12 set-up (tests/test_pallas_gmm.py:766-783: 5
    experts, K = N = H = 256, sizes 64/0/32/64/32, down bits 4/8/8/4/6), made
    from a numpy seed exactly as tests/test_torch_gmm_ffn.py makes it."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.quant.qparams import quantize_act_per_row_bits

    e, k, nh, hout, m = 5, 256, 256, 256, 224
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)

    def qw(w):
        sc = (np.abs(w).max(axis=1, keepdims=True) / np.float32(127.0)).astype(np.float32)
        return np.round(w / sc).astype(np.int8), sc

    wgu_q, wgu_sc = qw((rng.standard_normal((e, k, 2 * nh)) * 0.05).astype(np.float32))
    wd_q, wd_sc = qw((rng.standard_normal((e, nh, hout)) * 0.05).astype(np.float32))
    aq, asc = quantize_act_per_row_bits(torch.from_numpy(x), torch.full((m,), 8.0))
    dev = torch.device("cuda")
    t = [torch.as_tensor(v).to(dev) for v in (wgu_q, wgu_sc, wd_q, wd_sc)]
    return ([aq.to(dev), asc.to(dev)] + t,
            torch.tensor([64, 0, 32, 64, 32], dtype=torch.int32, device=dev),
            torch.tensor([4, 8, 8, 4, 6], dtype=torch.int32, device=dev))


def ffn_row_count_edges(aq, asc, wgu, sgu, wd, sd, bits) -> None:
    """K12 and K13 (no / every other / every expert packed) bitwise their
    plain versions and each other, each launch counted once, at qwen2_moe's
    widths with 1, 16, 17, 32, 33 and 64 rows an expert (an empty expert
    among them), unaligned: the cluster body's one- and two-fragment tiles
    and tiles that straddle two experts."""
    import torch

    from mxmoe_tpu_torch.ops import gmm_ffn, kernels
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed

    counts = [1, 16, 0, 17, 32, 33, 64]
    e, rows = len(counts), sum(counts)
    dev = aq.device
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    a, sa = aq[:rows + 8].contiguous(), asc[:rows + 8].contiguous()
    wg, sg, w2, s2, b = wgu[:e], sgu[:e], wd[:e], sd[:e], bits[:e].contiguous()
    for label, pf in (("none packed", [0] * e),
                      ("alternating", [int(i % 2 == 0) for i in range(e)]),
                      ("all packed", [1] * e)):
        pfb = torch.tensor(pf, dtype=torch.bool, device=dev)[:, None, None]
        wg4, w24 = torch.where(pfb, wg.clamp(-8, 7), wg), torch.where(pfb, w2.clamp(-8, 7), w2)
        gu_cat, gu_blk = build_ragged_mixed(wg4, pf)
        d_cat, d_blk = build_ragged_mixed(w24, pf)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        args = (a, sa, gu_cat, sg, i32(pf), i32(gu_blk), d_cat, s2, i32(pf), i32(d_blk), gs, b)
        n12, n13 = kernels.launches["gmm_ffn_w8a8"], kernels.launches["gmm_ffn_mixed_packed"]
        k12 = gmm_ffn.gmm_ffn_w8a8(a, sa, wg4, sg, w24, s2, gs, b)
        k13 = gmm_ffn.gmm_ffn_mixed_packed(*args)
        once = (kernels.launches["gmm_ffn_w8a8"] == n12 + 1
                and kernels.launches["gmm_ffn_mixed_packed"] == n13 + 1)
        p12 = gmm_ffn.gmm_ffn_w8a8_plain(a, sa, wg4, sg, w24, s2, gs, b)
        p13 = gmm_ffn.gmm_ffn_mixed_packed_plain(*args)
        torch.cuda.synchronize()
        _require_equal(k12[:rows], p12[:rows], f"K12 vs plain at row-count edges, {label}")
        _require_equal(k13[:rows], p13[:rows], f"K13 vs plain at row-count edges, {label}")
        _require_equal(k13[:rows], k12[:rows], f"K13 vs K12 at row-count edges, {label}")
        if not once:
            raise AssertionError("K12 / K13 at the row-count edges: a call did not count "
                                 "exactly one launch")
        emit("kernels", kernel="gmm_ffn_w8a8 / gmm_ffn_mixed_packed", use="row-count edges",
             rows_per_expert=counts, storage=label, bitwise=True, equals_gmm_ffn_w8a8=True)


def fused_kernels_vs_plain(rec: dict) -> None:
    """K12-K15. K12 (gmm_ffn_w8a8) and K13 (gmm_ffn_mixed_packed) at the
    decode and prefill shapes over the aligned dispatch (32 rows): K12
    bitwise its plain version and, with f32 output, within the reference's
    bounds of the two-launch path (K2 -> bf16 -> SwiGLU -> K1 -> K2: mean
    |d| < 1e-2, p99 < 8e-2, max < 0.3), timed beside it; on the reference
    test's set-up also within 2e-4 of the f32 oracle. K13 bitwise its plain
    version and K12 on the equivalent int8 codes (no expert packed, every
    other, all), timed beside its two-launch path (K4 + SwiGLU + K1 + K4).
    K12 and K13 also at row counts on the edges of the cluster body's m16 /
    m32 fragments (1, 16, 17, 32, 33, 64 rows an expert, unaligned: tiles
    straddle experts), bitwise as above; both timed by device time beside
    their two-launch paths. K14 (gmm_w8a8_fusedquant) at the gate_up shape
    bitwise its plain version and K1 + K2, timed beside them. K15 (gmm_ws)
    at the headline workload's shapes, rows padded to 128: bitwise K2
    (int8) and K5 (packed), timed beside them."""
    import torch

    from mxmoe_tpu_torch.bench import workloads
    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.models.layers import silu_mul
    from mxmoe_tpu_torch.ops import act_quant, gmm as gfl, gmm_ffn
    from mxmoe_tpu_torch.ops import gmm_mixed_packed as gmp
    from mxmoe_tpu_torch.ops import gmm_w4a8_packed as g4p, gmm_w8a8 as gmm
    from mxmoe_tpu_torch.ops import gmm_w8a8_fusedquant as gfq, gmm_ws
    from mxmoe_tpu_torch.ops.dispatch import expert_of_rows, make_dispatch, route_topk
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed, pack_int4_halves

    torch.backends.cuda.matmul.allow_tf32 = False      # the oracle's f32 products
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    f32 = torch.float32

    def timed(kernel, plain, work, reps=5):
        return {**kernel_times(kernel), "plain_ms": time_ms(plain, reps=reps, warmup=1),
                **work}

    # the reference test's set-up: K12 against the f32 oracle
    (aq, asc, wgu, sgu, wd, sd), gs, bits = _reference_ffn_setup()
    rows = int(gs.sum())
    out = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits, f32)
    row_bits = bits[expert_of_rows(gs, aq.shape[0])].float()
    gu = gfl.gmm_bf16_plain(aq.float() * asc, wgu.float() * sgu, gs, f32)
    hf = gu[:, :256] * torch.sigmoid(gu[:, :256]) * gu[:, 256:]
    hq, hsc = act_quant.quantize_rows_plain(hf, row_bits)
    oracle = gfl.gmm_bf16_plain(hq.float() * hsc, wd.float() * sd, gs, f32)
    torch.cuda.synchronize()
    err = (out - oracle)[:rows].abs()
    if not bool((err <= 2e-4 + 2e-4 * oracle[:rows].abs()).all()):
        raise AssertionError(f"K12 outside 2e-4 of the f32 oracle: max|d|={err.max()}")
    emit("kernels", kernel="gmm_ffn_w8a8", use="reference test set-up vs f32 oracle",
         M=aq.shape[0], K=256, N=256, H=256, max_abs_err=err.max().item(),
         bound="rtol 2e-4, atol 2e-4")

    # qwen2_moe widths: per-channel int8 weights of seeded normal floats
    def quant_w(shape):
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        sc = w.abs().amax(1, keepdim=True) / 127.0
        return torch.round(w / sc).to(torch.int8), sc

    wgu, sgu = quant_w((e, h, 2 * n))
    wd, sd = quant_w((e, n, h))
    bits = torch.tensor([(4, 6, 8)[i % 3] for i in range(e)], dtype=torch.int32,
                        device=dev)
    alternating = [int(i % 2 == 0) for i in range(e)]
    for regime, tokens in (("decode", 4), ("prefill", 256)):
        logits = torch.randn((tokens, e), generator=gen, device=dev)
        routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob)
        disp = make_dispatch(routing, e, align=32)
        gs, m = disp.group_sizes, disp.token_ids.numel()
        rows = int(gs.sum())
        x = torch.randn((m, h), generator=gen, device=dev).to(torch.bfloat16)
        aq, asc = act_quant.quantize_rows_uniform(x, 8)
        row_bits = bits[expert_of_rows(gs, m)].float()
        shape = dict(regime=regime, M=m, routed_rows=tokens * cfg.top_k, rows=rows,
                     live_experts=int((gs > 0).sum()), K=h, N=n, H=h)
        decode = regime == "decode"

        # K12
        out = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits)
        ref = gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits)
        out32 = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits, f32)

        def two_launch(out_dtype=torch.bfloat16):
            hh = silu_mul(gmm.gmm_w8a8(aq, asc, wgu, sgu, gs))
            q2, s2 = act_quant.quantize_rows(hh, row_bits)
            return gmm.gmm_w8a8(q2, s2, wd, sd, gs, out_dtype=out_dtype)

        d = (out32 - two_launch(f32))[:rows].abs().flatten()
        torch.cuda.synchronize()
        _require_equal(out[:rows], ref[:rows], f"K12 vs plain at {regime}")
        gap = {"mean": d.mean().item(), "p99": torch.quantile(d[:1 << 24], 0.99).item(),
               "max": d.max().item()}
        if not (gap["mean"] < 1e-2 and gap["p99"] < 8e-2 and gap["max"] < 0.3):
            raise AssertionError(f"K12 vs the two-launch path at {regime}: {gap}")
        t = timed(lambda: gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits),
                  lambda: gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits),
                  ffn_work(gs, h, n, h, h * 2 * n + n * h))
        emit("kernels", kernel="gmm_ffn_w8a8", bitwise=True, down_bits="4/6/8",
             resident_clusters=gmm_ffn.resident_clusters(n, h),
             vs_two_launch=gap, two_launch_ms=time_ms(two_launch),
             two_launch_device_ms=device_ms(two_launch), **shape, **t)
        if decode:
            rec["gmm_ffn_w8a8"].update(t)

        # K13 on the equivalent codes: packed experts' codes in the 4-bit range
        storages = [("alternating", alternating)]
        if decode:
            storages += [("none packed", [0] * e), ("all packed", [1] * e)]
        for label, pf in storages:
            pfb = torch.tensor(pf, dtype=torch.bool, device=dev)[:, None, None]
            wgu4 = torch.where(pfb, wgu.clamp(-8, 7), wgu)
            wd4 = torch.where(pfb, wd.clamp(-8, 7), wd)
            gu_cat, gu_blk = build_ragged_mixed(wgu4, pf)
            d_cat, d_blk = build_ragged_mixed(wd4, pf)
            i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
            meta = (i32(pf), i32(gu_blk), i32(pf), i32(d_blk))
            args = (aq, asc, gu_cat, sgu, meta[0], meta[1], d_cat, sd, meta[2],
                    meta[3], gs, bits)
            out = gmm_ffn.gmm_ffn_mixed_packed(*args)
            ref = gmm_ffn.gmm_ffn_mixed_packed_plain(*args)
            k12 = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu4, sgu, wd4, sd, gs, bits)
            torch.cuda.synchronize()
            _require_equal(out[:rows], ref[:rows], f"K13 vs plain, {label} at {regime}")
            _require_equal(out[:rows], k12[:rows], f"K13 vs K12, {label} at {regime}")
            per_expert = [(h * 2 * n + n * h) // (2 if f else 1) for f in pf]
            t = timed(lambda: gmm_ffn.gmm_ffn_mixed_packed(*args),
                      lambda: gmm_ffn.gmm_ffn_mixed_packed_plain(*args),
                      ffn_work(gs, h, n, h, per_expert))

            def two_launch_k4():
                hh = silu_mul(gmp.gmm_mixed_packed(aq, asc, gu_cat, sgu, gs, meta[0],
                                                   meta[1]))
                q2, s2 = act_quant.quantize_rows(hh, row_bits)
                return gmp.gmm_mixed_packed(q2, s2, d_cat, sd, gs, meta[2], meta[3])

            emit("kernels", kernel="gmm_ffn_mixed_packed", storage=label, bitwise=True,
                 equals_gmm_ffn_w8a8=True, packed_experts=sum(pf),
                 resident_clusters=gmm_ffn.resident_clusters(n, h, ragged=True),
                 gmm_ffn_w8a8_same_codes_ms=time_ms(
                     lambda: gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu4, sgu, wd4, sd, gs, bits)),
                 two_launch_ms=time_ms(two_launch_k4),
                 two_launch_device_ms=device_ms(two_launch_k4), **shape, **t)
            if decode and label == "alternating":
                rec["gmm_ffn_mixed_packed"].update(t)
            del gu_cat, d_cat, wgu4, wd4

        if decode:
            ffn_row_count_edges(aq, asc, wgu, sgu, wd, sd, bits)

        # K14 at the gate_up shape, on the unaligned dispatch
        gs_u = make_dispatch(routing, e).group_sizes
        mu = tokens * cfg.top_k
        xu = torch.randn((mu, h), generator=gen, device=dev).to(torch.bfloat16)
        out = gfq.gmm_w8a8_fusedquant(xu, wgu, sgu, gs_u)
        ref = gfq.gmm_w8a8_fusedquant_plain(xu, wgu, sgu, gs_u)

        def k1_k2():
            q1, s1 = act_quant.quantize_rows_uniform(xu, 8)
            return gmm.gmm_w8a8(q1, s1, wgu, sgu, gs_u)

        k12_ref = k1_k2()
        torch.cuda.synchronize()
        _require_equal(out, ref, f"K14 vs plain at {regime}")
        _require_equal(out, k12_ref, f"K14 vs K1 + K2 at {regime}")
        t = timed(lambda: gfq.gmm_w8a8_fusedquant(xu, wgu, sgu, gs_u),
                  lambda: gfq.gmm_w8a8_fusedquant_plain(xu, wgu, sgu, gs_u),
                  gmm_work(gs_u, h, 2 * n, h * 2 * n, lhs_row_bytes=2 * h))
        emit("kernels", kernel="gmm_w8a8_fusedquant", bitwise=True,
             equals_quantize_rows_gmm_w8a8=True, k1_k2_ms=time_ms(k1_k2),
             regime=regime, M=mu, K=h, N=2 * n, **t)
        if decode:
            rec["gmm_w8a8_fusedquant"].update(t)

    ffn_wide_vs_plain(rec, quant_w, gen)

    # K15 at the headline workload's shapes, every expert's rows padded to 128
    for wl in workloads.qwen2_moe_l10_bs8192():
        sizes = [(s + 127) // 128 * 128 for s in wl.group_sizes]
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        m, k, nn = sum(sizes), wl.k, wl.n
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
        wq = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01
        shape = dict(use="headline workload", workload=wl.name, M=m, K=k, N=nn)
        out = gmm_ws.gmm_w8a8_ws(aq, asc, wq, wsc, sizes)
        k2 = gmm.gmm_w8a8(aq, asc, wq, wsc, gs)
        ref = gmm_ws.gmm_w8a8_ws_plain(aq, asc, wq, wsc, sizes)
        torch.cuda.synchronize()
        _require_equal(out, k2, f"K15 vs K2 at {wl.name}")
        _require_equal(out, ref, f"K15 vs plain at {wl.name}")
        t = timed(lambda: gmm_ws.gmm_w8a8_ws(aq, asc, wq, wsc, sizes),
                  lambda: gmm_ws.gmm_w8a8_ws_plain(aq, asc, wq, wsc, sizes),
                  gmm_work(gs, k, nn, k * nn), reps=3)
        emit("kernels", kernel="gmm_ws", form="int8", bitwise=True, equals_gmm_w8a8=True,
             gmm_w8a8_same_codes_ms=time_ms(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, gs)),
             **shape, **t)
        if k == h:
            rec["gmm_ws"].update(t)
        del wq
        w4 = torch.randint(-8, 8, (e, k, nn), generator=gen, device=dev, dtype=torch.int8)
        packed = pack_int4_halves(w4)
        del w4
        out = gmm_ws.gmm_w4a8_packed_ws(aq, asc, packed, wsc, sizes)
        k5 = g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)
        torch.cuda.synchronize()
        _require_equal(out, k5, f"K15 packed vs K5 at {wl.name}")
        t = timed(lambda: gmm_ws.gmm_w4a8_packed_ws(aq, asc, packed, wsc, sizes),
                  lambda: gmm_ws.gmm_w4a8_packed_ws_plain(aq, asc, packed, wsc, sizes),
                  gmm_work(gs, k, nn, k * nn // 2), reps=3)
        emit("kernels", kernel="gmm_ws", form="packed", bitwise=True,
             equals_gmm_w4a8_packed=True,
             gmm_w4a8_packed_same_codes_ms=time_ms(
                 lambda: g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)), **shape, **t)
        del packed, aq

    # K15 at the K the full-K slice body refused: mixtral's (8 experts, top-2)
    # gate_up K 4096 and down K 14336 at full width, 128 rows an expert
    from mxmoe_tpu_torch.models.configs import config_for
    mix = config_for("mixtral")
    for k, nn in ((mix.hidden_size, 2 * mix.moe_intermediate_size),
                  (mix.moe_intermediate_size, mix.hidden_size)):
        ee = mix.num_experts
        sizes = [128] * ee
        m = sum(sizes)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
        wsc = torch.rand((ee, 1, nn), generator=gen, device=dev) * 0.01
        for form in ("int8", "packed"):
            if form == "int8":
                w = torch.randint(-127, 128, (ee, k, nn), generator=gen, device=dev,
                                  dtype=torch.int8)
                out = gmm_ws.gmm_w8a8_ws(aq, asc, w, wsc, sizes)
                ref = gmm_ws.gmm_w8a8_ws_plain(aq, asc, w, wsc, sizes)
            else:
                w = pack_int4_halves(torch.randint(-8, 8, (ee, k, nn), generator=gen,
                                                   device=dev, dtype=torch.int8))
                out = gmm_ws.gmm_w4a8_packed_ws(aq, asc, w, wsc, sizes)
                ref = gmm_ws.gmm_w4a8_packed_ws_plain(aq, asc, w, wsc, sizes)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K15 {form} vs plain at mixtral K={k}")
            emit("kernels", kernel="gmm_ws", form=form, use="mixtral width (a K the "
                 "full-K slice body refused)", M=m, K=k, N=nn, bitwise=True)
            del w, out, ref
        del aq


# the fused FFN's cluster at each model's expert width N: 8 CTAs where a
# CTA's share fits (qwen2_moe, ds2: the instance of PR 8), 16 at
# qwen2_moe_57b's 2560, mixtral's 14336 refused (as the reference refuses it)
FFN_CLUSTERS = {"qwen2_moe": 8, "ds2": 8, "qwen2_moe_57b": 16, "mixtral": 0}


def ffn_wide_vs_plain(rec: dict, quant_w, gen) -> None:
    """K12 and K13 at qwen2_moe_57b's widths (K 3584, N 2560, H 3584, 64
    experts, top-8) on the 16-CTA cluster, decode (4 tokens) and a
    256-token chunk (2048 routed rows) over the aligned dispatch: bitwise
    their plain versions and each other (K13 with every other expert
    packed), timed beside their bound (the kernels line's ``wide``); each
    model's cluster size as the built library computes it."""
    import torch

    from mxmoe_tpu_torch.models.configs import config_for
    from mxmoe_tpu_torch.ops import act_quant, gmm_ffn
    from mxmoe_tpu_torch.ops.dispatch import make_dispatch, route_topk
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed

    dev = torch.device("cuda")
    clusters = {m: gmm_ffn.ffn_cluster_size(config_for(m).moe_intermediate_size)
                for m in FFN_CLUSTERS}
    if clusters != FFN_CLUSTERS:
        raise AssertionError(f"the fused FFN's cluster sizes: {clusters}")
    cfg = config_for("qwen2_moe_57b")
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    wgu, sgu = quant_w((e, h, 2 * n))
    wd, sd = quant_w((e, n, h))
    bits = torch.tensor([(4, 6, 8)[i % 3] for i in range(e)], dtype=torch.int32,
                        device=dev)
    pf = [int(i % 2 == 0) for i in range(e)]
    pfb = torch.tensor(pf, dtype=torch.bool, device=dev)[:, None, None]
    wgu4 = torch.where(pfb, wgu.clamp(-8, 7), wgu)
    wd4 = torch.where(pfb, wd.clamp(-8, 7), wd)
    gu_cat, gu_blk = build_ragged_mixed(wgu4, pf)
    d_cat, d_blk = build_ragged_mixed(wd4, pf)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    meta = (i32(pf), i32(gu_blk), i32(pf), i32(d_blk))
    wide = {}
    for regime, tokens in (("decode", 4), ("prefill", 256)):
        routing = route_topk(torch.randn((tokens, e), generator=gen, device=dev),
                             cfg.top_k, cfg.norm_topk_prob)
        disp = make_dispatch(routing, e, align=32)
        gs, m = disp.group_sizes, disp.token_ids.numel()
        rows = int(gs.sum())
        x = torch.randn((m, h), generator=gen, device=dev).to(torch.bfloat16)
        aq, asc = act_quant.quantize_rows_uniform(x, 8)
        shape = dict(width="qwen2_moe_57b", cluster=clusters["qwen2_moe_57b"],
                     regime=regime, M=m, routed_rows=tokens * cfg.top_k, rows=rows,
                     live_experts=int((gs > 0).sum()), K=h, N=n, H=h)
        k12 = lambda: gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu4, sgu, wd4, sd, gs, bits)
        p12 = lambda: gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu4, sgu, wd4, sd, gs, bits)
        args = (aq, asc, gu_cat, sgu, *meta[:2], d_cat, sd, *meta[2:], gs, bits)
        k13 = lambda: gmm_ffn.gmm_ffn_mixed_packed(*args)
        p13 = lambda: gmm_ffn.gmm_ffn_mixed_packed_plain(*args)
        out12, ref12, out13, ref13 = k12(), p12(), k13(), p13()
        torch.cuda.synchronize()
        _require_equal(out12[:rows], ref12[:rows], f"K12 vs plain at 57b {regime}")
        _require_equal(out13[:rows], ref13[:rows], f"K13 vs plain at 57b {regime}")
        _require_equal(out13[:rows], out12[:rows], f"K13 vs K12 at 57b {regime}")
        per_expert = [(h * 2 * n + n * h) // (2 if f else 1) for f in pf]
        t12 = {**kernel_times(k12), "plain_ms": time_ms(p12, reps=3, warmup=1),
               **ffn_work(gs, h, n, h, h * 2 * n + n * h)}
        t13 = {**kernel_times(k13), "plain_ms": time_ms(p13, reps=3, warmup=1),
               **ffn_work(gs, h, n, h, per_expert)}
        emit("kernels", kernel="gmm_ffn_w8a8", bitwise=True,
             resident_clusters=gmm_ffn.resident_clusters(n, h), **shape, **t12)
        emit("kernels", kernel="gmm_ffn_mixed_packed", storage="alternating",
             bitwise=True, equals_gmm_ffn_w8a8=True,
             resident_clusters=gmm_ffn.resident_clusters(n, h, ragged=True),
             **shape, **t13)
        wide[regime] = (t12, t13)
        del aq, asc, x
    emit("kernels", use="fused FFN cluster sizes", clusters=clusters)
    for i, name in enumerate(("gmm_ffn_w8a8", "gmm_ffn_mixed_packed")):
        rec[name]["wide"] = {"width": "qwen2_moe_57b", "cluster": 16,
                             **{regime: t[i] for regime, t in wide.items()}}


def wgmma_body_vs_plain(rec: dict) -> None:
    """K2 and K5 above the decode rows (the wgmma body over group sizes read
    on the device) at the main path's prefill shapes: qwen2_moe's 256-token
    chunk (M 1024 over 60 experts) and ds2's (M 1536 over 64), gate_up and
    down, the int8 shared expert's prefill (one group, M 256), and the
    headline's 32762 unaligned rows, each bitwise its plain version (K5 on
    4-bit codes also bitwise K2 on them), the schedule printed, timed beside
    its bound; the qwen2_moe chunk's gate_up goes into the kernels line as
    ``prefill``. K14 at the headline's rows, bitwise K1 + K2 and timed beside
    them (its decode and prefill rows are in ``fused_kernels_vs_plain``)."""
    import torch

    from mxmoe_tpu_torch.bench import workloads
    from mxmoe_tpu_torch.models.configs import config_for
    from mxmoe_tpu_torch.ops import act_quant, gmm_w4a8_packed as g4p
    from mxmoe_tpu_torch.ops import gmm_w8a8 as gmm, gmm_w8a8_fusedquant as gfq
    from mxmoe_tpu_torch.ops.dispatch import make_dispatch, route_topk
    from mxmoe_tpu_torch.quant.packing import pack_int4_halves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    shapes = []
    for model in ("qwen2_moe", "ds2"):
        cfg = config_for(model)
        h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
        logits = torch.randn((256, e), generator=gen, device=dev)
        gs = make_dispatch(route_topk(logits, cfg.top_k, cfg.norm_topk_prob),
                           e).group_sizes
        shapes += [(f"{model} prefill chunk {proj}", gs, k, nn)
                   for proj, k, nn in (("gate_up", h, 2 * n), ("down", n, h))]
    qwen = config_for("qwen2_moe")
    sn, h = qwen.shared_expert_intermediate_size, qwen.hidden_size
    one = torch.full((1,), 256, dtype=torch.int32, device=dev)
    shapes += [("shared expert prefill", one, h, 2 * sn),
               ("shared expert prefill", one, sn, h)]
    headline = torch.tensor(workloads.QWEN2_MOE_L10_BS8192_ROUTED_M, dtype=torch.int32,
                            device=dev)
    shapes += [(f"headline unaligned {wl.name}", headline, wl.k, wl.n)
               for wl in workloads.qwen2_moe_l10_bs8192()]
    for use, gs, k, nn in shapes:
        m, e = int(gs.sum()), gs.numel()
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
        wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01
        w4 = torch.randint(-8, 8, (e, k, nn), generator=gen, device=dev, dtype=torch.int8)
        packed = pack_int4_halves(w4)
        w8 = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        k2 = gmm.gmm_w8a8(aq, asc, w8, wsc, gs)
        k5 = g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)
        k2_4 = gmm.gmm_w8a8(aq, asc, w4, wsc, gs)
        torch.cuda.synchronize()
        _require_equal(k2, gmm.gmm_w8a8_plain(aq, asc, w8, wsc, gs), f"K2 at {use}")
        _require_equal(k5, g4p.gmm_w4a8_packed_plain(aq, asc, packed, wsc, gs),
                       f"K5 at {use}")
        _require_equal(k5, k2_4, f"K5 vs K2 on 4-bit codes at {use}")
        del w4, k2_4
        for name, fn, plain, wbytes in (
                ("gmm_w8a8", lambda: gmm.gmm_w8a8(aq, asc, w8, wsc, gs),
                 lambda: gmm.gmm_w8a8_plain(aq, asc, w8, wsc, gs), k * nn),
                ("gmm_w4a8_packed", lambda: g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs),
                 lambda: g4p.gmm_w4a8_packed_plain(aq, asc, packed, wsc, gs),
                 k * nn // 2)):
            sched = gmm.int8_gmm_schedule(m, k, nn, e, name == "gmm_w4a8_packed",
                                          wgmma=True)
            if sched.bm != 128:
                raise AssertionError(f"{name} at {use} did not take the wgmma body")
            t = {**kernel_times(fn), **gmm_work(gs, k, nn, wbytes)}
            if use == "qwen2_moe prefill chunk gate_up":
                t["plain_ms"] = time_ms(plain, reps=3, warmup=1)
                rec[name]["prefill"] = {"use": use, "M": m, "K": k, "N": nn, **t}
            emit("kernels", kernel=name, use=use, bitwise=True, M=m, K=k, N=nn,
                 live_groups=int((gs > 0).sum()), schedule={"bm": sched.bm,
                 "bn": sched.bn}, **t)
        del aq, w8, packed, k2, k5
        torch.cuda.empty_cache()

    # K14 at the headline's rows (the cooperative body), bitwise K1 + K2
    wl = workloads.qwen2_moe_l10_bs8192()[0]
    m, e = int(headline.sum()), headline.numel()
    x = (torch.randn((m, wl.k), generator=gen, device=dev) * 2).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (e, wl.k, wl.n), generator=gen, device=dev,
                       dtype=torch.int8)
    ws = torch.rand((e, 1, wl.n), generator=gen, device=dev) * 0.01 + 1e-4

    def k1_k2():
        q1, s1 = act_quant.quantize_rows_uniform(x, 8)
        return gmm.gmm_w8a8(q1, s1, wq, ws, headline)

    out = gfq.gmm_w8a8_fusedquant(x, wq, ws, headline)
    ref = k1_k2()
    torch.cuda.synchronize()
    _require_equal(out, ref, "K14 vs K1 + K2 at the headline's rows")
    emit("kernels", kernel="gmm_w8a8_fusedquant", use="headline unaligned rows",
         bitwise=True, equals_quantize_rows_gmm_w8a8=True, M=m, K=wl.k, N=wl.n,
         schedule={"bm": gfq.fusedquant_schedule(m, wl.k, wl.n, e).bm},
         k1_k2_ms=time_ms(k1_k2), k1_k2_device_ms=device_ms(k1_k2),
         **kernel_times(lambda: gfq.gmm_w8a8_fusedquant(x, wq, ws, headline)),
         **gmm_work(headline, wl.k, wl.n, wl.k * wl.n, lhs_row_bytes=2 * wl.k))
    del x, wq
    torch.cuda.empty_cache()


def schedule_edges() -> None:
    """The redesigned bodies at the edges of their schedules. The int8
    grouped GEMM (K2, K4, K5, K9) at M 1, 4, 16, 17, 24, 64, 65, 256, routed
    over 12 groups (two empty) and as one group (split-K): each bitwise its
    plain version, K4 and K5 bitwise K2 on the same codes. The grouped-scale
    GEMM (K8, K4f) on the same rows and codes at g128 with zero points: each
    bitwise its plain version, K4f bitwise K8 on the same codes. The
    weight-only GEMM (K6, K7, K10: one schedule) on the same rows, 4-bit
    codes, at g128 with zero points and per channel: K6 within
    ``gmm_weight_only.error_over_bound`` of the float64 product, K7 bitwise
    K6, K10 (experts alternating) weight-only rows bitwise K6 and w x a rows
    bitwise K8 (and K2 per channel). K11 on the same rows with bf16
    weights within ``gmm.error_over_bound`` (its wgmma body at every M).
    K3 / K3q at
    lengths on the warp-chunk and S-block edges, G 1 / 4 / 7: the write
    bitwise, the output within K3_REL_BOUND per slot (+ 1 bf16 ulp), the
    read-only form bitwise K3 / K3q after their write."""
    import torch

    from mxmoe_tpu_torch.ops import gmm as gfl
    from mxmoe_tpu_torch.ops import gmm_mixed_packed as gmp, gmm_w4a8_packed as g4p
    from mxmoe_tpu_torch.ops import gmm_w8a8 as gmm, gmm_w8a8_asym as gas
    from mxmoe_tpu_torch.ops import gmm_w8a8_grouped as ggrp
    from mxmoe_tpu_torch.ops import gmm_mixed_wo_wxa as gmx, gmm_weight_only as gwo
    from mxmoe_tpu_torch.ops import gmm_weight_only_packed as gwop
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed, pack_int4_halves
    from mxmoe_tpu_torch.serving import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    cases, grouped_cases, wo_cases, k11_cases = [], [], [], []
    for m in (1, 4, 16, 17, 24, 64, 65, 256):
        for layout in ("routed", "one_group"):
            if layout == "routed":
                counts = torch.bincount(torch.randint(0, 12, (m,), generator=gen,
                                                      device=dev), minlength=12)
                counts[1] = counts[5] = 0
                counts[0] += m - int(counts.sum())
                k, n = 1408, 2048
            else:
                counts, k, n = torch.tensor([m], device=dev), 2048, 1024
            gs = counts.to(torch.int32)
            e = gs.numel()
            sched = gmm.int8_gmm_schedule(m, k, n, e)
            aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
            w8 = torch.randint(-127, 128, (e, k, n), generator=gen, device=dev,
                               dtype=torch.int8)
            w4 = torch.randint(-8, 8, (e, k, n), generator=gen, device=dev,
                               dtype=torch.int8)
            wsc = torch.rand((e, 1, n), generator=gen, device=dev) * 0.01
            zp = torch.rand((e, 1, n), generator=gen, device=dev) * 0.2 - 0.1
            pflags = [i % 2 for i in range(e)]
            mixed = w8.clone()
            mixed[1::2] = w4[1::2]
            cat, blk = build_ragged_mixed(mixed, pflags)
            pf = torch.tensor(pflags, dtype=torch.int32, device=dev)
            blk = torch.tensor(blk, dtype=torch.int32, device=dev)
            packed = pack_int4_halves(w4)
            k2 = gmm.gmm_w8a8(aq, asc, w8, wsc, gs)
            checks = (
                ("K2", k2, gmm.gmm_w8a8_plain(aq, asc, w8, wsc, gs)),
                ("K9", gas.gmm_w8a8_asym(aq, asc, w8, wsc, zp, gs),
                 gas.gmm_w8a8_asym_plain(aq, asc, w8, wsc, zp, gs)),
                ("K5", g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs),
                 g4p.gmm_w4a8_packed_plain(aq, asc, packed, wsc, gs)),
                ("K5 = K2", g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs),
                 gmm.gmm_w8a8(aq, asc, w4, wsc, gs)),
                ("K4", gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk),
                 gmp.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs, pf, blk)),
                ("K4 = K2", gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk),
                 gmm.gmm_w8a8(aq, asc, mixed, wsc, gs)))
            # the grouped-scale GEMM on the same rows and codes, g128 + zp
            g = k // GSIZE
            gsc = torch.rand((m, g), generator=gen, device=dev) * 0.05
            gwsc = torch.rand((e, g, n), generator=gen, device=dev) * 0.01
            gzp = torch.randn((e, g, n), generator=gen, device=dev) * 0.02
            k4f = gmp.gmm_mixed_packed(aq, gsc, cat, gwsc, gs, pf, blk, rhs_zp=gzp)
            checks += (
                ("K8", ggrp.gmm_w8a8_grouped(aq, gsc, w8, gwsc, gs, GSIZE, gzp),
                 ggrp.gmm_w8a8_grouped_plain(aq, gsc, w8, gwsc, gs, GSIZE, gzp)),
                ("K4f", k4f, gmp.gmm_mixed_packed_plain(aq, gsc, cat, gwsc, gs, pf,
                                                        blk, rhs_zp=gzp)),
                ("K4f = K8", k4f,
                 ggrp.gmm_w8a8_grouped(aq, gsc, mixed, gwsc, gs, GSIZE, gzp)))
            # the weight-only GEMM on the same rows and 4-bit codes: K6, K7
            # and K10 (experts alternating) on one schedule
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            fl = torch.tensor(pflags, dtype=torch.int32, device=dev)
            wo_rows = torch.repeat_interleave(fl, gs.long()).bool()
            for gsize, wsc_w, zp_w, sa_w in ((GSIZE, gwsc, gzp, gsc),
                                             (-1, wsc, None, asc)):
                zp6 = torch.zeros_like(wsc_w) if zp_w is None else zp_w
                k6 = gwo.gmm_weight_only(x, w4, wsc_w, zp6, gs, gsize)
                k10 = gmx.gmm_mixed_wo_wxa(x, aq, sa_w, w4, wsc_w, fl, gs, rhs_zp=zp_w)
                wxa = (gmm.gmm_w8a8(aq, sa_w, w4, wsc_w, gs) if zp_w is None else
                       ggrp.gmm_w8a8_grouped(aq, sa_w, w4, wsc_w, gs, gsize, zp_w))
                checks += (
                    (f"K7 = K6, gsize {gsize}",
                     gwop.gmm_weight_only_packed(x, packed, wsc_w, zp6, gs, gsize), k6),
                    (f"K10 weight-only rows = K6, gsize {gsize}", k10[wo_rows],
                     k6[wo_rows]),
                    (f"K10 w x a rows = {'K2' if zp_w is None else 'K8'}, gsize "
                     f"{gsize}", k10[~wo_rows], wxa[~wo_rows]))
                torch.cuda.synchronize()
                _, ratio = gwo.error_over_bound(k6, x, w4, wsc_w, zp6, gs, gsize)
                if not ratio <= 1.0:
                    raise AssertionError(f"K6 outside its bound at M {m} {layout} "
                                         f"gsize {gsize}: {ratio} of it")
                wo_cases.append({"M": m, "layout": layout, "K": k, "gsize": gsize,
                                 "err_over_bound": ratio,
                                 **_wo_schedule(m, k, n, e, gsize)})
            # K11 on the same rows, bf16 weights (its wgmma body)
            wbf = (torch.randn((e, k, n), generator=gen, device=dev) * 0.02).to(
                torch.bfloat16)
            k11 = gfl.gmm_bf16(x, wbf, gs)
            torch.cuda.synchronize()
            _, ratio = gfl.error_over_bound(k11, x, wbf, gs)
            body = gfl.bf16_gmm_schedule().body
            if not ratio <= 1.0:
                raise AssertionError(f"K11 ({body} body) outside its bound at M {m} "
                                     f"{layout}: {ratio} of it")
            k11_cases.append({"M": m, "layout": layout, "K": k, "N": n, "body": body,
                              "err_over_bound": ratio})
            del wbf, k11
            torch.cuda.synchronize()
            for what, got, ref in checks:
                _require_equal(got, ref, f"{what} at M {m} {layout}")
            cases.append({"M": m, "layout": layout, "bm": sched.bm,
                          "k2_k5_bm": gmm.int8_gmm_schedule(m, k, n, e,
                                                            wgmma=True).bm,
                          "k4_bm": _k4_schedule(m, k, n, e)["bm"],
                          "k9_bm": _k9_schedule(m, k, n, e)["bm"],
                          "splits": sched.splits, "blocks": sched.blocks})
            gsched = ggrp.grouped_gmm_schedule(m, k, n, e, GSIZE)
            grouped_cases.append({"M": m, "layout": layout, "K": k, "bm": gsched.bm,
                                  "k8_bm": ggrp.grouped_gmm_schedule(
                                      m, k, n, e, GSIZE, wgmma=True).bm,
                                  "k4f_bm": _grouped_schedule(m, k, n, e, True)["bm"],
                                  "grid_m": gsched.grid_m, "splits": gsched.splits,
                                  "blocks": gsched.blocks})
    emit("schedule_edges", kernel="int8 grouped GEMM (K2, K4, K5, K9)",
         bitwise=True, cases=cases)
    emit("schedule_edges", kernel="grouped-scale GEMM (K8, K4f)", gsize=GSIZE,
         rhs_zp=True, bitwise=True, k4f_equals_k8=True, cases=grouped_cases)
    emit("schedule_edges", kernel="weight-only GEMM (K6, K7, K10)",
         k7_equals_k6=True, k10_weight_only_rows_equal_k6=True,
         k10_wxa_rows_equal_k8_or_k2=True, cases=wo_cases)
    emit("schedule_edges", kernel="bf16 grouped GEMM (K11)", cases=k11_cases)

    n_kv, s_max, dv, layer = 2, 600, 128, 0
    lens = [0, 15, 16, 31, 32, 33, 63, 64, 65, 255, 256, 257, 511, 599, 600]
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    valid = torch.ones((b,), dtype=torch.int32, device=dev)
    valid[3] = 0
    for groups, dk in ((1, 256), (4, 128), (7, 128)):
        for quant in (False, True):
            if quant:
                caches = [torch.randint(-127, 128, (2, b, n_kv, s_max, d), generator=gen,
                                        device=dev, dtype=torch.int8) if d else
                          torch.rand((2, b, n_kv, s_max), generator=gen, device=dev)
                          * 0.03 + 1e-3 for d in (dk, 0, dv, 0)]
            else:
                caches = [torch.randn((2, b, n_kv, s_max, d), generator=gen, device=dev)
                          .to(torch.bfloat16) if d else None for d in (dk, 0, dv, 0)]
            caches2 = [None if c is None else c.clone() for c in caches]
            q = torch.randn((b, n_kv * groups, dk), generator=gen, device=dev).to(torch.bfloat16)
            kn = torch.randn((b, n_kv, dk), generator=gen, device=dev).to(torch.bfloat16)
            vn = torch.randn((b, n_kv, dv), generator=gen, device=dev).to(torch.bfloat16)
            scale = 1.0 / dk ** 0.5
            out, _ = da.decode_attention_update_stacked(q, kn, vn, *caches, lengths,
                                                        layer, valid=valid, scale=scale)
            if quant:
                ref = da.decode_attention_update_q8_plain(q, kn, vn, *caches2, lengths,
                                                          layer, valid, scale)
            else:
                ref = da.decode_attention_update_plain(q, kn, vn, caches2[0], caches2[2],
                                                       lengths, layer, valid, scale)
            ro, _ = da.decode_attention_stacked(q, *caches, lengths, layer, scale=scale)
            torch.cuda.synchronize()
            for got, want in zip(caches, caches2):
                if got is not None and not torch.equal(got, want):
                    raise AssertionError(f"K3 write not bitwise (G {groups}, {quant})")
            rel = k3_slot_errors(out, ref)
            _require_equal(ro, out, f"read-only vs K3 (G {groups}, int8 {quant})")
            emit("schedule_edges", kernel="K3q" if quant else "K3", G=groups, dk=dk,
                 lengths=lens, cache_bitwise=True, read_only_bitwise=True,
                 rel_err_max=max(rel))


def kernels_vs_plain() -> dict:
    """Each kernel vs its plain version; returns per-kernel records."""
    rec = {name: {"max_abs_err": 0.0} for name in KERNEL_SOURCES}
    schedule_edges()
    gmm_kernels_vs_plain(rec)
    headline_quant_rows()
    scheme_kernels_vs_plain(rec)
    two_launch_kernels_vs_plain(rec)
    attention_kernels_vs_plain(rec)
    read_only_attention_vs_plain(rec)
    fused_kernels_vs_plain(rec)
    wgmma_body_vs_plain(rec)
    combine_vs_index_add()
    return rec


def _to(params, device):
    return {k: (_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def _top2_margin(logits):
    """Per-row gap between the two largest logits ([.., V] -> [..])."""
    top2 = logits.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _full_width_model(layers: int, seed: int, model: str = "qwen2_moe"):
    """``model`` (qwen2_moe, ds2, mixtral, qwen2_moe_57b) at its published
    widths, ``layers`` deep (ds2's dense first layer counts), with seeded
    random bf16 weights made on the card -> (config, float params)."""
    import torch

    from mxmoe_tpu_torch.models.configs import config_for
    from mxmoe_tpu_torch.models.model import init_params

    cfg = dataclasses.replace(config_for(model), num_layers=layers)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    floats = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    return cfg, floats


def _served_model(layers: int, seed: int, model: str, quant: str, pack: bool,
                  int8_head: bool, impl_kw: dict | None):
    """What ``serve`` runs: ``model`` at its published widths, ``layers``
    deep, its seeded random bf16 weights drawn and quantized one MoE layer at
    a time (``bench_serving.init_for_serving``, each layer through
    ``prepare``, so the float model never exists whole) -> (config, params,
    MoEImpl)."""
    import torch

    from mxmoe_tpu_torch.models.configs import config_for
    from mxmoe_tpu_torch.quant.qparams import quantize_lm_head
    from mxmoe_tpu_torch.serving.bench_serving import init_for_serving

    cfg = dataclasses.replace(config_for(model), num_layers=layers)
    dev = torch.device("cuda")
    params, impl = init_for_serving(
        cfg, torch.Generator(device=dev).manual_seed(seed),
        functools.partial(prepare, quant=quant, pack=pack, impl_kw=impl_kw), dev)
    if int8_head:
        params = quantize_lm_head(params)
    return cfg, params, impl


def _init_cache(cfg, batch, max_len, int8_kv, device):
    from mxmoe_tpu_torch.serving.kv_cache import init_kv_cache, init_quant_kv_cache

    if int8_kv:
        return init_quant_kv_cache(cfg, batch, max_len, device=device)
    return init_kv_cache(cfg, batch, max_len, device=device)


# flex per-expert mixes, int8-stored: routed experts alternate a grouped
# asymmetric w4a4 scheme with per-channel w8a8 (K8 with zero points); the
# name picks the shared expert's scheme: grouped asymmetric w x a (K8 with
# one group) or weight-only in every layer (K6 with one group)
FLEX_ROUTED = ("w4a4_g128_asym", "w8a8_g-1_sym")
FLEX_SHARED = {"flex-shared-grouped": "w8a8_g128_asym",
               "flex-shared-a16": "w4a16_g128_asym"}


# the two-launch branches come as ``bench_serving.MIXES`` names (shared expert
# per-channel w8a8):
#   flex-wo      grouped asymmetric weight-only beside w8a8, one launch (K10,
#                flex body): the scheme pair of the reference's fused kernel
#   mixed-wo     per-channel weight-only beside w8a8 (K10, per-channel body)
#   flex-packed  grouped asymmetric w4a4 nibble-packed beside w8a8 in the ragged
#                buffer (K4f); flex: the same codes int8-stored (K8)
# float experts: through K11 (``gmm_backend="pallas"``) or the stock product
FLOAT_ARMS = {"bf16-k11": "pallas", "none": "ragged_dot"}


def flex_mixed_config(num_layers: int, num_experts: int, shared_scheme: str):
    from mxmoe_tpu_torch.quant.schemes import (QLayerConfig, QModelConfig,
                                               build_uniform_expert, parse_scheme)

    experts = {str(i): build_uniform_expert(parse_scheme(FLEX_ROUTED[i % 2]))
               for i in range(num_experts)}
    experts[str(num_experts)] = build_uniform_expert(parse_scheme(shared_scheme))
    return QModelConfig(layers={str(l): QLayerConfig(experts=dict(experts))
                                for l in range(num_layers)})


def prepare(floats: dict, cfg, quant: str, pack: bool = False,
            int8_head: bool = False, impl_kw: dict | None = None):
    """Float params -> (quantized params, MoEImpl). ``quant``: what
    ``bench_serving --quant`` takes, or a ``FLEX_SHARED`` or ``FLOAT_ARMS``
    name; ``pack`` nibble-packs a uniform scheme's codes
    (convert's pack step); ``int8_head`` quantizes the lm_head; ``impl_kw``
    sets MoEImpl fields (``fused_ffn``, ``dispatch_align``)."""
    from mxmoe_tpu_torch.models.convert import pack_int4_experts
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.quant.qparams import (quantize_lm_head,
                                               quantize_model_experts_mixed)
    from mxmoe_tpu_torch.serving.bench_serving import quantize_for_serving

    if quant in FLEX_SHARED:
        qmc = flex_mixed_config(cfg.num_moe_layers, cfg.num_experts, FLEX_SHARED[quant])
        params = quantize_model_experts_mixed(floats, cfg, qmc)
        impl = MoEImpl(quant="mixed")
    elif quant in FLOAT_ARMS:
        params, impl = floats, MoEImpl(gmm_backend=FLOAT_ARMS[quant])
    else:
        params, impl = quantize_for_serving(floats, cfg, quant)
    if pack:
        params = pack_int4_experts(params, impl.quant)
    if int8_head:
        params = quantize_lm_head(params)
    return params, dataclasses.replace(impl, **(impl_kw or {}))


def slice_parity(quant: str, int8_kv: bool, pack: bool = False,
                 impl_kw: dict | None = None, tries: int = 40,
                 model: str = "qwen2_moe", layers: int = 2) -> None:
    """A full-width slice of ``model``, ``layers`` deep, on the CPU (plain
    versions), then the same inputs on CUDA (kernels). The CPU run picks its
    inputs: a prompt, then for each decode step one input token per slot,
    such that every compared position's top-2 margin exceeds PARITY_BOUND.
    ``impl_kw`` as ``prepare`` takes it."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.serving.decode import forward_cached

    cfg, floats = _full_width_model(layers, seed=1, model=model)
    params, impl = prepare(floats, cfg, quant, pack, impl_kw=impl_kw)
    del floats
    cpu_params = _to(params, "cpu")
    rng = np.random.default_rng(1)
    b, chunk, steps = 2, 256, 4
    valid0 = np.asarray([chunk, 200], np.int32)
    rows = np.arange(b)

    # CPU: search the inputs. A retried forward writes the same cache
    # positions again (the cache argument keeps its lengths), so a rejected
    # try leaves nothing behind.
    cache = _init_cache(cfg, b, 512, int8_kv, "cpu")
    t0 = time.perf_counter()
    for n_prompts in range(1, tries + 1):
        prompt = rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
        lg, nxt = forward_cached(cpu_params, torch.from_numpy(prompt), cache, cfg,
                                 impl, valid_lengths=torch.from_numpy(valid0))
        last = lg.float()[rows, valid0 - 1]
        if bool((_top2_margin(last) > PARITY_BOUND).all()):
            break
    else:
        raise AssertionError(f"parity: no prompt in {tries} gave a top-2 margin "
                             f"> {PARITY_BOUND}")
    prefill_s_cpu = (time.perf_counter() - t0) / n_prompts
    cache, cpu_logits, fed, n_tries = nxt, [last], [], []
    for _ in range(steps):
        greedy = cpu_logits[-1].argmax(-1)
        chosen = greedy.clone()
        done = torch.zeros((b,), dtype=torch.bool)
        for j in range(tries):
            cand = torch.where(done, chosen, (greedy + j) % cfg.vocab_size)
            lg, nxt = forward_cached(cpu_params, cand.to(torch.int32)[:, None],
                                     cache, cfg, impl)
            ok = _top2_margin(lg[:, 0]) > PARITY_BOUND
            if bool(ok.all()):
                break
            chosen = torch.where(ok & ~done, cand, chosen)
            done |= ok
        else:
            raise AssertionError(f"parity: no decode input in {tries} gave a "
                                 f"top-2 margin > {PARITY_BOUND}")
        cache = nxt
        fed.append(cand.to(torch.int32))
        cpu_logits.append(lg.float()[:, 0])
        n_tries.append(j + 1)

    # CUDA: replay the chosen inputs
    dev = torch.device("cuda")
    cache = _init_cache(cfg, b, 512, int8_kv, dev)
    t0 = time.perf_counter()
    lg, cache = forward_cached(params, torch.as_tensor(prompt, device=dev), cache,
                               cfg, impl,
                               valid_lengths=torch.as_tensor(valid0, device=dev))
    gpu_logits = [lg.float().cpu()[rows, valid0 - 1]]
    prefill_s_cuda = time.perf_counter() - t0
    for toks in fed:
        lg, cache = forward_cached(params, toks.to(dev)[:, None], cache, cfg, impl)
        gpu_logits.append(lg.float().cpu()[:, 0])

    cpu = torch.stack(cpu_logits)             # [1 + steps, B, V]
    gpu = torch.stack(gpu_logits)
    if not (torch.isfinite(gpu).all() and gpu.shape == (1 + steps, b, cfg.vocab_size)):
        raise AssertionError("non-finite or misshapen CUDA logits")
    err = (gpu - cpu).abs().max().item()
    bound = min(PARITY_BOUND, PARITY_ULPS * bf16_ulp(cpu.abs().max()).item())
    margin = _top2_margin(cpu).min().item()
    tok_cpu, tok_gpu = cpu.argmax(-1), gpu.argmax(-1)
    equal = tok_cpu == tok_gpu
    emit("parity", model=model, quant=quant, packed=pack, int8_kv=int8_kv,
         layers=cfg.num_layers,
         fused_ffn=impl.fused_ffn, dispatch_align=impl.dispatch_align,
         prefill_valid=valid0.tolist(), decode_steps=steps, max_abs_err=err,
         bound=bound, max_abs_logit=cpu.abs().max().item(),
         greedy_equal=int(equal.sum()), greedy_total=equal.numel(),
         min_top2_margin=margin, prompts_tried=n_prompts, decode_inputs_tried=n_tries,
         tokens_cpu=tok_cpu.tolist(), tokens_cuda=tok_gpu.tolist(),
         prefill_s_cuda=prefill_s_cuda, prefill_s_cpu=prefill_s_cpu)
    if not margin > PARITY_BOUND:
        raise AssertionError(f"slice parity: top-2 margin {margin} <= {PARITY_BOUND}")
    if not err <= bound:
        raise AssertionError(f"slice parity: max|d logits|={err} > {bound}")
    if not bool(equal.all()):
        raise AssertionError("slice parity: greedy tokens differ")


def forward_logits_vs_prefill(model: str, layers: int, quant: str = "mixed-packed",
                              seed: int = 4) -> None:
    """On the card, the full forward (``forward_logits`` over a 256-token
    prompt) against a one-chunk ``forward_cached`` prefill of the same prompt
    into an empty bf16 cache: logits within the parity bound (PARITY_ULPS
    bf16 ulps at max|logits|, at most PARITY_BOUND)."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.models.model import forward_logits
    from mxmoe_tpu_torch.serving.decode import forward_cached

    cfg, floats = _full_width_model(layers, seed=seed, model=model)
    params, impl = prepare(floats, cfg, quant)
    del floats
    dev = torch.device("cuda")
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 256)).astype(np.int32), device=dev)
    full = forward_logits(params, prompt, cfg, impl).float()
    cached, _ = forward_cached(params, prompt, _init_cache(cfg, 2, 512, False, dev),
                               cfg, impl)
    cached = cached.float()
    torch.cuda.synchronize()
    err = (full - cached).abs().max().item()
    bound = min(PARITY_BOUND, PARITY_ULPS * bf16_ulp(cached.abs().max()).item())
    finite = bool(torch.isfinite(full).all())
    greedy = (full.argmax(-1) == cached.argmax(-1)).float().mean().item()
    emit("forward_logits", model=model, layers=cfg.num_layers, quant=quant,
         tokens=list(prompt.shape), max_abs_diff_vs_prefill=err, bound=bound,
         max_abs_logit=cached.abs().max().item(), greedy_agree_share=greedy,
         finite=finite)
    if not (finite and full.shape == (2, 256, cfg.vocab_size) and err <= bound):
        raise AssertionError(f"forward_logits ({model}): {err} from the cached "
                             f"prefill > {bound}, or non-finite / misshapen")


def storage_forms_bitwise(stored: str = "mixed", packed: str = "mixed-packed",
                          impl_kw: dict | None = None) -> None:
    """Packing w4 experts changes bytes, not outputs: int8-stored and
    nibble-packed params of one seed give bitwise equal logits on the card
    (``stored`` / ``packed``: what ``prepare`` takes; per channel K2 against
    K4, flex K8 against K4f; with ``impl_kw={"fused_ffn": True}`` K12
    against K13)."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.serving.decode import forward_cached

    cfg, floats = _full_width_model(4, seed=2)
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    b, chunk, steps = 2, 256, 16
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32),
                             device=dev)
    valid0 = torch.tensor([chunk, 200], dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    logits, fed = {}, []
    for quant in (stored, packed):
        params, impl = prepare(floats, cfg, quant, impl_kw=impl_kw)
        cache = _init_cache(cfg, b, 512, True, dev)
        lg, cache = forward_cached(params, prompt, cache, cfg, impl,
                                   valid_lengths=valid0)
        out = [lg[rows, (valid0 - 1).long()]]
        for i in range(steps):
            if quant == stored:               # the first form's greedy tokens
                fed.append(out[-1].argmax(-1).to(torch.int32)[:, None])
            lg, cache = forward_cached(params, fed[i], cache, cfg, impl)
            out.append(lg[:, 0])
        logits[quant] = torch.stack(out)
        del params, cache
    torch.cuda.synchronize()
    same = torch.equal(logits[stored], logits[packed])
    emit("storage", stored=stored, packed=packed, layers=cfg.num_layers,
         fused_ffn=impl.fused_ffn,
         prefill_valid=valid0.tolist(), decode_steps=steps, int8_kv=True,
         bitwise_equal=same,
         max_abs_diff=(logits[stored].float()
                       - logits[packed].float()).abs().max().item(),
         finite=bool(torch.isfinite(logits[stored]).all()))
    if not (same and torch.isfinite(logits[stored]).all()):
        raise AssertionError(f"{stored} and {packed} logits differ on the card")


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _reckoned_bytes(cfg, quant: str, pack: bool, int8_kv: bool, slots: int,
                    max_len: int, int8_head: bool = False) -> dict:
    """The bytes of each part of the served model as the storage code lays
    them out, reckoned from the config: routed experts and the shared expert
    of the MoE layers (codes, f32 scales per channel or per group of GSIZE
    codes, zero points where the form keeps them, the per-expert markers), the
    bf16 attention of every layer (GQA or MLA), ds2's bf16 dense MLP, the
    embedding, the head (bf16 or int8 + f32 scales), norms and routers, the
    KV cache (MLA: one
    K / V per head, K at the padded width), and their total; to print beside
    the measured tensor sizes and the peak."""
    from mxmoe_tpu_torch.quant.schemes import parse_scheme
    from mxmoe_tpu_torch.serving.bench_serving import MIXES

    from mxmoe_tpu_torch.serving.kv_cache import mla_cache_k_dim

    h, n, e, nl = (cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts,
                   cfg.num_moe_layers)
    sn = cfg.shared_expert_intermediate_size
    codes = h * 2 * n + n * h                       # one expert, 1 byte a code
    shared_codes = h * 2 * sn + sn * h
    shared_bf16 = nl * shared_codes * 2

    def scale_bytes(width, grouped):
        """One f32 array of scales (or zero points) for an expert of ``width``."""
        g_h, g_n = (h // GSIZE, width // GSIZE) if grouped else (1, 1)
        return (g_h * 2 * width + g_n * h) * 4

    if quant == "mixed-packed":                     # even experts packed
        packed = (e + 1) // 2
        experts = nl * (packed * codes // 2 + (e - packed) * codes
                        + e * scale_bytes(n, False)
                        + 2 * e * 8 + 2 * e * 4)    # + blk/pf, act bits
        shared = nl * (shared_codes + scale_bytes(sn, False) + 8)
    elif quant in FLEX_SHARED:      # scales and zp per group; act bits, gsize
        experts = nl * e * (codes + 2 * scale_bytes(n, True) + 2 * 4
                            + (h // GSIZE + n // GSIZE) * 4)
        a16 = parse_scheme(FLEX_SHARED[quant]).a_bits >= 16
        shared = nl * (shared_codes + 2 * scale_bytes(sn, True) + 8 + 4 * a16)
    elif quant in MIXES:            # shared expert per-channel w8a8
        _, pack_w4, _ = MIXES[quant]
        flex = quant.startswith("flex")
        packed = (e + 1) // 2 if pack_w4 else 0     # even experts are the w4 ones
        experts = nl * (packed * codes // 2 + (e - packed) * codes
                        + e * 2 * scale_bytes(n, flex)          # scales and zp
                        + e * 2 * 4                             # act bits
                        + flex * e * (h // GSIZE + n // GSIZE) * 4   # act gsize
                        + pack_w4 * 2 * e * 8)                  # blk / pf
        shared = nl * (shared_codes + scale_bytes(sn, False) + 8)
    elif quant in FLOAT_ARMS:
        experts, shared = nl * e * codes * 2, shared_bf16
    else:                           # uniform: codes, scales and zp
        grouped = parse_scheme(quant).w_gsize != -1
        experts = nl * e * (codes // (2 if pack else 1)
                            + 2 * scale_bytes(n, grouped))
        shared = shared_bf16
    if cfg.attention_type == "mla":
        n_h, r, d_v = cfg.num_heads, cfg.kv_lora_rank, cfg.v_head_dim
        attn = (h * n_h * cfg.qk_head_dim + h * (r + cfg.qk_rope_head_dim) + r
                + r * n_h * (cfg.qk_nope_head_dim + d_v) + n_h * d_v * h)
        n_kv, k_dim, v_dim = n_h, mla_cache_k_dim(cfg), d_v
    else:
        attn = (2 * h * cfg.q_dim + 2 * h * cfg.kv_dim
                + cfg.attention_bias * (cfg.q_dim + 2 * cfg.kv_dim))
        n_kv, k_dim, v_dim = cfg.num_kv_heads, cfg.head_dim, cfg.head_dim
    pos = (k_dim + v_dim) * (1 if int8_kv else 2) + (8 if int8_kv else 0)
    out = {"experts": experts, "shared_expert": shared,
           "attention": cfg.num_layers * attn * 2,
           "dense_mlp": cfg.first_dense_layers * 3 * h * cfg.dense_intermediate_size * 2,
           "embed": cfg.vocab_size * h * 2,
           "head": h * cfg.vocab_size * (1 if int8_head else 2)
                   + cfg.vocab_size * 4 * int8_head,
           # norms (two a layer and the final one), routers, shared-expert gates
           "other": 2 * (2 * cfg.num_layers * h + h + nl * h * e
                         + nl * h * (cfg.has_shared_expert_gate and sn > 0)),
           "kv_cache": cfg.num_layers * slots * n_kv * max_len * pos}
    out["total"] = sum(out.values())
    return out


def serve(layers: int, quant: str, int8_kv: bool, expect: tuple,
          pack: bool = False, int8_head: bool = False,
          impl_kw: dict | None = None, absent: tuple = (),
          model: str = "qwen2_moe", name: str = "", graph: tuple = ()) -> dict:
    """The Engine over ``model`` at its published widths, ``layers`` deep
    (set up one MoE layer at a time: ``_served_model``), answering 4
    requests, each prompt's 256-token chunks through the captured chunk
    (``prefill_ms``: the four submits less the first's one-off warm-up,
    capture and instantiate, ``prefill_graph_s``; ``first_submit_ms`` and
    ``prefill_total_ms`` with them); returns the kernels' launch counts of
    this serve.
    ``quant``, ``pack``, ``int8_head`` and ``impl_kw`` as ``prepare`` takes
    them; the kernels in ``expect`` must launch, those in ``absent`` not.
    The Engine decodes through its captured step (``serving/graph.py``);
    ``graph`` names the ``graph`` phase's checks run on this serve
    (``graph_checks``)."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.ops import kernels
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig
    from mxmoe_tpu_torch.serving.kv_cache import clone_cache

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, impl = _served_model(layers, 0, model, quant, pack, int8_head,
                                      impl_kw)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    nbytes = {"experts": 0, "shared_expert": 0, "attention": 0, "dense_mlp": 0,
              "embed": _tensor_bytes([params["embed"]]), "head": 0, "other": 0}
    attn_keys = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "kv_a", "kv_a_norm", "kv_b")
    for stack in (params["layers"], params.get("dense_layers", {})):
        for k, v in stack.items():
            key = ("experts" if k.startswith(("expert_", "act_bits_g", "act_bits_d",
                                              "act_gsize_"))
                   else "shared_expert" if k.startswith(("shared_gate_up",
                                                         "shared_down",
                                                         "act_bits_shared",
                                                         "shared_wo"))
                   else "attention" if k in attn_keys
                   else "dense_mlp" if k.startswith("mlp_")
                   else "other")
            nbytes[key] += _tensor_bytes([v])
    for k, v in params.items():
        if k.startswith("lm_head"):
            nbytes["head"] += _tensor_bytes([v])
        elif k == "final_norm":
            nbytes["other"] += _tensor_bytes([v])
    slots, max_len, max_new = 4, 2048, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(params, cfg, EngineConfig(batch_slots=slots, max_len=max_len,
                                           prefill_chunk=256, int8_kv=int8_kv), impl)
    nbytes["kv_cache"] = _tensor_bytes(
        getattr(eng.cache, f.name) for f in dataclasses.fields(eng.cache)
        if f.name != "lengths")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (48, 200, 300, 512)]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(prompts[0], max_new_tokens=max_new)]
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    rids += [eng.submit(p, max_new_tokens=max_new) for p in prompts[1:]]
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    # the post-prefill cache on the host, so that the serve's peak does not
    # count it
    snap = (clone_cache(eng.cache, "cpu"), eng._last_tokens.copy()) if graph else None
    t0 = time.perf_counter()
    results = eng.run_to_completion(chunk=16)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if eng._graph is None or eng._graph.graph is None:
        raise AssertionError(f"serve ({quant}): the Engine decoded without its "
                             "captured step")
    pg = eng._slot_prefill
    if pg is None or pg.graph is None:
        raise AssertionError(f"serve ({quant}): the Engine prefilled without its "
                             "captured chunk")

    setup_s = pg.warmup_s + pg.capture_s + pg.instantiate_s
    toks = [results[r] for r in rids]
    decoded = sum(len(t) - 1 for t in toks)     # the first token comes from prefill
    nbytes["total"] = sum(nbytes.values())
    emit("serve", model=model, layers=cfg.num_layers, quant=quant, packed=pack,
         int8_kv=int8_kv, decode_attn=impl.decode_attn,
         int8_head=int8_head, mixed_weight_only=impl.mixed_weight_only,
         fused_ffn=impl.fused_ffn, dispatch_align=impl.dispatch_align,
         gmm_backend=impl.gmm_backend, requests=len(prompts), prompt_lens=[len(p) for p in prompts],
         max_new=max_new, tokens=toks, init_s=t_init,
         prefill_ms=(t_prefill - setup_s) * 1e3, first_submit_ms=t_first * 1e3,
         prefill_total_ms=t_prefill * 1e3,
         decode_s=t_decode, decode_tok_s=decoded / t_decode,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         init_max_memory_allocated=init_peak, measured_bytes=nbytes,
         prefill_graph_s={"warmup": pg.warmup_s, "capture": pg.capture_s,
                          "instantiate": pg.instantiate_s},
         reckoned_bytes=_reckoned_bytes(cfg, quant, pack, int8_kv, slots, max_len,
                                        int8_head),
         launches=launches)
    if any(len(t) != max_new or not all(0 <= x < cfg.vocab_size for x in t)
           for t in toks):
        raise AssertionError("serve: a request came back short or out of vocab")
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        raise AssertionError(f"serve ({quant}): kernels never launched on the "
                             f"main path: {missing}")
    stray = [k for k in absent if launches[k]]
    if stray:
        raise AssertionError(f"serve ({quant}, {impl_kw}): kernels launched that "
                             f"this path must not take: {stray}")
    if graph:
        graph_checks(name, graph, eng, snap, [results[r] for r in rids], prompts,
                     max_new, t_decode)
    del eng, params
    return launches


def graph_checks(name: str, checks: tuple, eng, snap, toks: list, prompts: list,
                 max_new: int, t_decode: float) -> None:
    """The ``graph`` phase on one serve (``serve``'s Engine after it answered
    its 4 requests through the captured step; ``snap``: a clone of its cache
    and its last tokens after the prefill). ``checks``:

    - ``eager``: an eager ``forward_cached`` greedy loop from the clone gives
      every request's 31 decoded tokens, and its last step's logits equal
      the captured step's last replay's bitwise;
    - ``sync_debug``: that loop's first step runs under
      ``torch.cuda.set_sync_debug_mode("error")`` (no host read);
    - ``sampled``: the same params served twice with ``temperature=0.8``,
      ``top_k=50`` and one seed give the same tokens, other than the greedy
      serve's; and the first serve's decoded tokens are those of an eager
      ``forward_cached`` + ``sample_tokens`` loop from a clone of its
      post-prefill cache and its generator's state then (the generator is
      registered with the graph: every replay draws fresh noise, as an
      eager step would);
    - ``abba``: the eager and the captured step timed in turns (eager,
      captured, captured, eager; ``profile_decode.abba``): wall ms, device
      ms, busy share, kernels and host launch calls a step;
    - ``prefill``: one 256-token chunk of all 4 slots (valid 256 / 256 / 0
      / 97) from two clones of the post-prefill cache, eager
      (``forward_cached``) and captured (``graph.PrefillGraph``): logits and
      every cache byte equal; then both timed in turns as above, a chunk a
      step, with the captured chunk's warm-up, capture and instantiate
      seconds, each arm's peak memory above what was allocated before it
      and the memory the graph keeps. Printed as a ``prefill_graph`` line;
    - ``ttft`` (with ``prefill``): the time to the first token of a
      512-token prompt through ``Engine.submit`` (256-token chunks, one
      slot), eager and captured Engines in turns (``profile_decode.ttft``,
      one submit a turn): the same first token.

    Prints one ``graph`` line with the captured step's warm-up, capture and
    instantiate seconds, its launches a replay and the serve's peak memory;
    raises on any failed check."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.serving.decode import forward_cached, sample_tokens
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig
    from mxmoe_tpu_torch.serving.kv_cache import clone_cache

    g = eng._graph
    dev = eng.device
    res = {"name": name, "checks": list(checks), "warmup_s": g.warmup_s,
           "capture_s": g.capture_s, "instantiate_s": g.instantiate_s,
           "launches_per_replay": sum(g.counts.values()),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "captured_decode_s": t_decode}
    cache, last = clone_cache(snap[0], dev), snap[1]
    slots = len(prompts)
    valid = torch.ones((slots,), dtype=torch.int32, device=dev)
    if "eager" in checks:
        tok = torch.as_tensor(last[:slots], device=dev)[:, None]
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(max_new - 1):
            if i == 0 and "sync_debug" in checks:
                torch.cuda.set_sync_debug_mode("error")
            try:
                logits, cache = forward_cached(eng.params, tok, cache, eng.cfg,
                                               eng.impl, valid_lengths=valid)
                nxt = sample_tokens(logits[:, -1])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out.append(nxt)
            tok = nxt[:, None]
        eager = torch.stack(out, dim=1).cpu().tolist()
        res["eager_decode_s"] = time.perf_counter() - t0
        res["tokens_equal"] = all(toks[r][1:] == eager[r] for r in range(slots))
        res["logits_bitwise"] = bool(torch.equal(g.logits, logits))
        res["logits_max_abs_diff"] = float((g.logits.float() - logits.float()).abs().max())
        if "sync_debug" in checks:
            res["sync_debug_clean"] = True      # the step raised nothing
    if "sampled" in checks:
        runs = []
        for _ in range(2):
            e2 = Engine(eng.params, eng.cfg, EngineConfig(
                batch_slots=slots, max_len=eng.ecfg.max_len, prefill_chunk=256,
                int8_kv=eng.ecfg.int8_kv, temperature=0.8, top_k=50, seed=11), eng.impl)
            rids = [e2.submit(p, max_new_tokens=max_new) for p in prompts]
            if not runs:
                s_cache = clone_cache(e2.cache, "cpu")
                s_last, s_state = e2._last_tokens.copy(), e2.gen.get_state()
            got = e2.run_to_completion(chunk=16)
            runs.append([got[r] for r in rids])
            del e2
        res["sampled_reproducible"] = runs[0] == runs[1]
        res["sampled_differs_from_greedy"] = runs[0] != toks
        s_cache = clone_cache(s_cache, dev)
        s_gen = torch.Generator(device=dev)
        s_gen.set_state(s_state)
        s_tok = torch.as_tensor(s_last[:slots], device=dev)[:, None]
        out = []
        for _ in range(max_new - 1):
            lg, s_cache = forward_cached(eng.params, s_tok, s_cache, eng.cfg, eng.impl,
                                         valid_lengths=valid)
            nxt = sample_tokens(lg[:, -1], s_gen, 0.8, 50)
            out.append(nxt)
            s_tok = nxt[:, None]
        eager = torch.stack(out, dim=1).cpu().tolist()
        res["sampled_equals_eager"] = all(runs[0][r][1:] == eager[r]
                                          for r in range(slots))
        del s_cache
    if "abba" in checks:
        from mxmoe_tpu_torch.serving import profile_decode

        state = {"cache": cache, "tok": tok}

        def eager_steps(n):
            for _ in range(n):
                lg, state["cache"] = forward_cached(eng.params, state["tok"],
                                                    state["cache"], eng.cfg, eng.impl,
                                                    valid_lengths=valid)
                state["tok"] = lg[:, -1:].argmax(-1).to(torch.int32)

        g.load(torch.as_tensor(np.asarray([t[-1] for t in toks], np.int32),
                               device=dev), valid)

        def captured_steps(n):
            g.run(n)

        turns = profile_decode.abba({"eager": eager_steps, "captured": captured_steps},
                                    order=("eager", "captured", "captured", "eager"),
                                    steps=8)
        for arm in turns.values():
            arm.pop("by_name")
        res["abba"] = turns
    emit("graph", **res)
    failed = [k for k in ("tokens_equal", "logits_bitwise", "sampled_reproducible",
                          "sampled_differs_from_greedy", "sampled_equals_eager")
              if k in res and not res[k]]
    if failed:
        raise AssertionError(f"graph ({name}): {failed}")
    if "prefill" in checks:
        del cache
        torch.cuda.empty_cache()
        prefill_graph_check(name, eng, snap[0], "ttft" in checks)


def prefill_graph_check(name: str, eng, snap_cache, ttft: bool) -> None:
    """``graph_checks``' ``prefill`` check on a serve's Engine (its params,
    config and MoEImpl) from its post-prefill cache ``snap_cache`` (on the
    host); prints one ``prefill_graph`` line, raises on a failed check."""
    import dataclasses

    import torch

    from mxmoe_tpu_torch.serving import profile_decode
    from mxmoe_tpu_torch.serving.kv_cache import clone_cache

    t0 = time.perf_counter()
    dev, cfg = eng.device, eng.cfg
    g = torch.Generator(device=dev).manual_seed(21)
    toks = torch.randint(0, cfg.vocab_size, (4, 256), generator=g, device=dev,
                         dtype=torch.int32)
    valid = torch.tensor([256, 256, 0, 97], dtype=torch.int32, device=dev)
    with torch.no_grad():
        arms, graph, caches = profile_decode.prefill_arms(
            eng.params, cfg, eng.impl, clone_cache(snap_cache, dev), toks, valid,
            eng._pool)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eager = arms["eager"](1).clone()
        peak_eager = torch.cuda.max_memory_allocated() - base
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        captured = arms["captured"](1)
        torch.cuda.synchronize()
        peak_captured = torch.cuda.max_memory_allocated() - base
        kept = torch.cuda.memory_allocated() - base
        res = {"name": name, "layers": cfg.num_layers, "chunk": [4, 256], "valid": valid.tolist(),
               "int8_kv": eng.ecfg.int8_kv,
               "logits_bitwise": bool(torch.equal(eager, captured)),
               "cache_bitwise": all(torch.equal(getattr(caches[0], f.name),
                                                getattr(caches[1], f.name))
                                    for f in dataclasses.fields(caches[0])),
               "warmup_s": graph.warmup_s, "capture_s": graph.capture_s,
               "instantiate_s": graph.instantiate_s,
               "launches_per_replay": sum(graph.counts.values()),
               "peak_bytes_eager": peak_eager, "peak_bytes_captured": peak_captured,
               "graph_kept_bytes": kept}
        del eager, captured
        turns = profile_decode.abba(arms, order=("eager", "captured", "captured", "eager"),
                                    steps=2)
        for arm in turns.values():
            arm.pop("by_name")
        res["abba"] = turns
        del arms, graph, caches
        torch.cuda.empty_cache()
        if ttft:
            res["ttft_512"] = profile_decode.ttft(eng.params, cfg, eng.impl,
                                                  eng.ecfg.int8_kv, eng.ecfg.max_len,
                                                  turns=1)
    res["seconds"] = time.perf_counter() - t0
    emit("prefill_graph", **res)
    failed = [k for k in ("logits_bitwise", "cache_bitwise") if not res[k]]
    if ttft and not res["ttft_512"]["tokens_equal"]:
        failed.append("ttft tokens_equal")
    if failed:
        raise AssertionError(f"prefill_graph ({name}): {failed}")


def _reset_counts():
    from mxmoe_tpu_torch.ops import kernels

    kernels.reset_launch_counts()


def _counts() -> dict:
    from mxmoe_tpu_torch.ops import kernels

    return {k: v for k, v in kernels.launches.items() if v}


# the offline phase's artifacts: name -> (convert arguments, kernels its serve
# must launch). ``mixed``: bench_serving's alternating w4a4 / w8a8 experts,
# w4 nibble-packed in the ragged buffer (K4), with the w8a8 shared expert
# (K2 with one group); ``flex-gptq``: w4a8_g128 experts packed (K4f, its act
# quant per k-group in torch ops: no K1) with a w8a8_g128 asymmetric shared
# expert, which GPTQ fake-quantizes (float products)
OFFLINE_ARTIFACTS = {
    "uniform": (dict(quant="w8a8_g-1_sym"), ("quantize_rows", "gmm_w8a8",
                                             "decode_attention_update_stacked")),
    "mixed-rtn": (dict(qconfig="mixed", method="rtn"),
                  ("quantize_rows", "gmm_w8a8", "decode_attention_update_stacked",
                   "gmm_mixed_packed")),
    "mixed-gptq": (dict(qconfig="mixed", method="gptq"),
                   ("quantize_rows", "gmm_w8a8", "decode_attention_update_stacked",
                    "gmm_mixed_packed")),
    "mixed-gptq-had": (dict(qconfig="mixed", method="gptq-had"),
                       ("quantize_rows", "gmm_w8a8", "decode_attention_update_stacked",
                        "gmm_mixed_packed")),
    "flex-gptq": (dict(qconfig="flex-g128", method="gptq"),
                  ("gmm_mixed_packed_flex", "decode_attention_update_stacked")),
}


def _offline_qconfigs(cfg, root: str) -> dict:
    """The qconfig JSON files of the offline phase -> {name: path}."""
    from mxmoe_tpu_torch.quant.schemes import (QLayerConfig, QModelConfig,
                                               build_uniform_expert, parse_scheme)
    from mxmoe_tpu_torch.serving.bench_serving import alternating_mixed_config

    e = cfg.num_experts
    flex = {str(i): build_uniform_expert(parse_scheme("w4a8_g128_sym"))
            for i in range(e)}
    flex[str(e)] = build_uniform_expert(parse_scheme("w8a8_g128_asym"))
    mixes = {"mixed": alternating_mixed_config(cfg.num_layers, e),
             "flex-g128": QModelConfig(layers={str(l): QLayerConfig(experts=dict(flex))
                                               for l in range(cfg.num_layers)})}
    paths = {}
    for name, qmc in mixes.items():
        paths[name] = os.path.join(root, f"{name}.json")
        qmc.save(paths[name])
    return paths


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


# the offline phase's model: full width, depth cut for the smoke's time and disk
OFFLINE_MODEL, OFFLINE_LAYERS = "qwen2_moe", 2


def _offline_cfg():
    from mxmoe_tpu_torch.models import configs

    return dataclasses.replace(configs.config_for(OFFLINE_MODEL), num_layers=OFFLINE_LAYERS)


def offline_checkpoint(root: str, device: str = "cuda") -> str:
    """The seeded HF-schema checkpoint of the offline and solve phases
    (``synth_ckpt``, bf16, full width, ``OFFLINE_LAYERS`` deep), written once
    under ``root`` -> its directory."""
    import torch

    from mxmoe_tpu_torch.models import synth_ckpt

    ckpt = os.path.join(root, "hf")
    t0 = time.perf_counter()
    nbytes = synth_ckpt.make_checkpoint(_offline_cfg(), ckpt, seed=0, dtype=torch.bfloat16)
    emit("offline_ckpt", model=OFFLINE_MODEL, layers=OFFLINE_LAYERS, bytes_written=nbytes,
         seconds=time.perf_counter() - t0, dtype="bf16",
         card=smi_line() if device.startswith("cuda") else "cpu")
    return ckpt


def offline_phase(ckpt: str, device: str = "cuda") -> dict:
    """The offline path at full width, ``OFFLINE_LAYERS`` deep: the seeded
    HF-schema checkpoint ``ckpt`` (``offline_checkpoint``) -> ``convert``
    (uniform RTN, then a qconfig mix by RTN, GPTQ and GPTQ + Hadamard, and a
    grouped GPTQ mix) -> the artifact served through ``generate --artifact``
    (Engine, 2 slots), in a temporary directory under the git-ignored build
    directory, removed at the end. The uniform artifact's greedy tokens and
    logits must be bitwise those of the same shards quantized in memory;
    every serve on the card must launch the kernels its artifact needs; every
    GPTQ convert must bring each reached expert's proxy loss below RTN's.
    Returns each serve's launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mxmoe_tpu_torch.models import convert, model as model_mod
    from mxmoe_tpu_torch.models.hf_loader import params_from_safetensors
    from mxmoe_tpu_torch.quant.qparams import quantize_model_experts_uniform
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.quant.rotation import rotate_model_hadamard_host
    from mxmoe_tpu_torch.quant.schemes import parse_scheme
    from mxmoe_tpu_torch.serving import generate
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

    dev = torch.device(device)
    check_kernels = dev.type == "cuda"  # a CPU tensor launches no kernel
    model, layers = OFFLINE_MODEL, OFFLINE_LAYERS
    cfg = _offline_cfg()
    build_dir = os.path.join(HERE, "mxmoe_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="offline-", dir=build_dir)
    smi = smi_line() if dev.type == "cuda" else "cpu"
    launches = {}
    try:
        qconfigs = _offline_qconfigs(cfg, root)
        rng = np.random.default_rng(0)
        prompt = rng.integers(0, cfg.vocab_size, 48).tolist()
        max_new = 16
        gen_args = ["--model", model, "--slots", "2", "--max-new", str(max_new),
                    "--prompt", " ".join(map(str, prompt)), "--device", device]
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        for name, (kw, expect) in OFFLINE_ARTIFACTS.items():
            kw = dict(kw)
            if "qconfig" in kw:
                kw["qconfig"] = qconfigs[kw["qconfig"]]
            out = os.path.join(root, name)
            stats = {}
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            convert.convert(ckpt, model, out, layers=layers, device=device,
                            stats=stats, **kw)
            t_convert = time.perf_counter() - t0
            art_bytes = _dir_bytes(out)
            peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
            t0 = time.perf_counter()
            params, cfg_a, impl = generate.load_artifact(out, cfg, dev)
            t_load = time.perf_counter() - t0
            _reset_counts()
            got = generate.main(gen_args + ["--artifact", out])
            launches[name] = _counts()
            if len(got) != max_new or not all(0 <= t < cfg.vocab_size for t in got):
                raise AssertionError(f"offline {name}: a request came back short or "
                                     "out of vocab")
            missing = [k for k in expect if not launches[name].get(k)]
            if check_kernels and missing:
                raise AssertionError(f"offline {name}: kernels never launched on the "
                                     f"artifact's serve: {missing}")
            shown = dict(kw, **({"qconfig": os.path.basename(kw["qconfig"])}
                                if "qconfig" in kw else {}))
            rec = {"artifact": name, "convert": shown,
                   "convert_s": t_convert, "artifact_bytes": art_bytes,
                   "convert_peak_device_bytes": peak, "load_s": t_load,
                   "tokens": got, "launches": launches[name]}
            if stats:
                rec["gptq_layers"] = stats["layers"]
                g = torch.cat(stats["proxy"]["gptq"])
                r = torch.cat(stats["proxy"]["rtn"])
                # an expert (or shared family) no calibration row reached has a
                # zero Hessian: both losses 0, counted apart
                live = r > 0
                rec["proxy_loss_below_rtn_share"] = float((g[live] < r[live]).double().mean())
                rec["proxy_loss_families"] = int(live.sum())
                rec["proxy_loss_unreached"] = int((~live).sum())
                rec["proxy_loss_gptq_over_rtn_median"] = float((g[live] / r[live]).median())
                if (rec["proxy_loss_below_rtn_share"] < 1.0
                        or not rec["proxy_loss_gptq_over_rtn_median"] < 1.0):
                    raise AssertionError(f"offline {name}: GPTQ's proxy loss is not "
                                         f"below RTN's on every reached expert: {rec}")
            with torch.no_grad():
                lg_art = model_mod.forward_logits(params, toks, cfg_a, impl)
            if name == "uniform":
                # the same shards quantized in memory, no artifact between
                mem = params_from_safetensors(ckpt, cfg)
                mem = quantize_model_experts_uniform(mem, parse_scheme(kw["quant"]),
                                                     device=dev)
                mem = _to(mem, dev)
                art, flat = convert._flatten(params), convert._flatten(mem)
                if sorted(art) != sorted(flat):
                    raise AssertionError("offline uniform: the artifact's keys are "
                                         "not the in-memory quantization's")
                for k, v in flat.items():
                    if art[k].dtype != v.dtype or not torch.equal(art[k], v):
                        raise AssertionError(f"offline uniform: {k} differs from the "
                                             "in-memory quantization")
                with torch.no_grad():
                    lg_mem = model_mod.forward_logits(mem, toks, cfg_a, impl)
                eng = Engine(mem, cfg_a, EngineConfig(batch_slots=2, max_len=512,
                                                      prefill_chunk=256), impl)
                rid = eng.submit(prompt, max_new_tokens=max_new)
                want = eng.run_to_completion(chunk=16)[rid]
                rec["in_memory_tokens_equal"] = want == got
                rec["in_memory_logits_bitwise"] = bool(torch.equal(lg_mem, lg_art))
                if want != got or not torch.equal(lg_mem, lg_art):
                    raise AssertionError("offline uniform: the artifact serves other "
                                         "tokens or logits than the in-memory model")
                del mem, eng, art, flat
            if name == "mixed-gptq-had":
                # the rotation (the convert's Q: a generator seeded 0) is exact:
                # the float model against the rotated one, in float32 (held to
                # ROTATION_REL), and stored in bf16 as the artifact stores it
                # (printed: bf16 rounding moves router logits, and a flipped
                # top-k choice moves the logits past any rounding bound)
                for dt in (torch.float32, torch.bfloat16):
                    flt = _to(params_from_safetensors(ckpt, cfg, dtype=dt), dev)
                    with torch.no_grad():
                        lf = model_mod.forward_logits(flt, toks, cfg, MoEImpl()).float()
                        rot = rotate_model_hadamard_host(
                            flt, cfg, torch.Generator().manual_seed(0), device=dev)
                        lr = model_mod.forward_logits(rot, toks, cfg, MoEImpl()).float()
                    tag = "f32" if dt == torch.float32 else "bf16"
                    rec[f"rotation_{tag}_max_abs_logit_diff"] = float((lf - lr).abs().max())
                    rec[f"rotation_{tag}_max_abs_logit"] = float(lf.abs().max())
                    del flt, rot
                if not (rec["rotation_f32_max_abs_logit_diff"]
                        <= ROTATION_REL * rec["rotation_f32_max_abs_logit"]):
                    raise AssertionError(f"offline: the rotated float model is not the "
                                         f"float model: {rec}")
            if not bool(torch.isfinite(lg_art).all()):
                raise AssertionError(f"offline {name}: non-finite logits")
            rec["max_abs_logit"] = float(lg_art.abs().max())
            emit("offline", card=smi, **rec)
            del params
            shutil.rmtree(out)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# the solve phase: the calibrated schemes (RTN), the one calibrated by GPTQ,
# the profiled schemes, the calibration tokens (samples x length) and the
# solve's targets
SOLVE_SCHEMES = ("w8a8_g-1_sym", "w4a4_g-1_sym", "w4a16_g128_asym")
SOLVE_GPTQ_SCHEME = "w4a4_g-1_sym"
SOLVE_PROFILED = SOLVE_SCHEMES + ("w4a4_g-1_sym_packed", "w4a16_g128_asym_packed")
SOLVE_TOKENS = (8, 512)
SOLVE_WBITS, SOLVE_R = 6.0, 0.5
# seconds of HiGHS a runtime model's solve may take before each MILP keeps
# its best mix so far (the measured table's solve took 31-157 s in most
# runs and 513 s in one, past the smoke's time limit)
SOLVE_MILP_BUDGET_S = 90.0
# the share of (layer, expert, linear) entries whose w4a4 loss must reach the
# w8a8 loss
SOLVE_ORDER_SHARE = 0.99
# a fitted one-launch rate's peak: the card's published one for its kind;
# the nibble unpack (elements per second) against the CUDA cores' f32 op rate
# (at least one operation an element)
FIT_PEAKS = {"int8_tflops_eff": PEAK_OPS_PER_S["int8"] / 1e12,
             "bf16_tflops_eff": PEAK_OPS_PER_S["bf16"] / 1e12,
             "hbm_gbps_eff": HBM_BYTES_PER_S / 1e9,
             "quant_gbps_eff": HBM_BYTES_PER_S / 1e9,
             "unpack_gops": PEAK_OPS_PER_S["f32"] / 1e9}


def served_kernels(params: dict, impl) -> list:
    """The kernels a served artifact's storage selects (``models.layers``'s
    branches): K3 for the attention, then per routed family K4 / K4f over the
    ragged packed buffer, K10 with weight-only experts, K8 for a flex family,
    K2 otherwise, with K1 wherever the rows are quantized per token; the
    shared expert's K6 / K8 / K1 + K2 where it is real-quantized."""
    lp = params["layers"]
    out = ["decode_attention_update_stacked"]
    for prefix, ag in (("expert_gate_up", "act_gsize_gateup"),
                       ("expert_down", "act_gsize_down")):
        flex = ag in lp
        if f"{prefix}_qcat" in lp:
            out += ["gmm_mixed_packed_flex"] if flex else ["quantize_rows",
                                                           "gmm_mixed_packed"]
        elif impl.mixed_weight_only:
            out += ["gmm_mixed_wo_wxa"] + ([] if flex else ["quantize_rows"])
        else:
            out += ["gmm_w8a8_grouped"] if flex else ["quantize_rows", "gmm_w8a8"]
    if "shared_gate_up_q" in lp:
        if "shared_wo" in lp:
            out.append("gmm_weight_only")
        elif (lp["shared_gate_up_sc"].shape[-2] > 1 or "shared_gate_up_zp" in lp
              or "shared_down_zp" in lp):
            out.append("gmm_w8a8_grouped")
        else:
            out += ["quantize_rows", "gmm_w8a8"]
    return sorted(set(out))


def _solve_gates(qmc, problems, name: str) -> dict:
    """The solved mix's gates: each layer's size-weighted average weight bits
    within the budget, gate == up for every expert, two schemes or more."""
    from mxmoe_tpu_torch.quant.schemes import LINEAR_NAMES, strategy_bits

    used, avg = set(), {}
    for key, prob in problems:
        experts = qmc.layers[key].experts
        tot = 0.0
        for e, size in enumerate(prob.sizes):
            qm = experts[str(e)].qmap()
            if qm["gate"].scheme_name != qm["up"].scheme_name:
                raise AssertionError(f"solve ({name}): layer {key} expert {e} gate != up")
            for lin in LINEAR_NAMES:
                used.add(qm[lin].scheme_name)
                tot += size * strategy_bits(qm[lin].scheme_name)[0]
        avg[key] = tot / (3.0 * float(sum(prob.sizes)))
        if avg[key] > SOLVE_WBITS + 1e-9:
            raise AssertionError(f"solve ({name}): layer {key} averages {avg[key]} "
                                 f"weight bits, over the budget {SOLVE_WBITS}")
    if len(used) < 2:
        raise AssertionError(f"solve ({name}): one scheme only: {used}")
    return {"avg_wbits": avg, "schemes_used": sorted(used)}


def solve_phase(ckpt: str, device: str = "cuda", profile_kw: dict | None = None,
                keep: dict | None = None) -> dict:
    """The solve half of the co-design loop at full width, ``OFFLINE_LAYERS``
    deep, on the offline phase's checkpoint: trace the gates (K11) -> the
    calibration losses by RTN (and one scheme by GPTQ) -> the performance
    table and the one-launch fit on the card -> the MILP under both runtime
    models -> ``convert --qconfig`` of the solved mix -> ``generate
    --artifact``. Gates as the steps say; returns each step's launch counts.
    ``profile_kw`` overrides the profiler's shapes (a CPU rehearsal). With
    ``keep`` (a dict holding ``"dir"``), the served qconfig is copied there
    and ``keep`` gains its ``"qconfig"`` path and the kernels its storage
    selects (``"expect"``), for the eval phase."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mxmoe_tpu_torch.models import convert, model as model_mod
    from mxmoe_tpu_torch.models.hf_loader import params_from_safetensors
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.quant import calibrate, quantizer
    from mxmoe_tpu_torch.quant.data import synthetic_tokens
    from mxmoe_tpu_torch.quant.schemes import parse_scheme
    from mxmoe_tpu_torch.serving import generate
    from mxmoe_tpu_torch.solver import bits_solver, onelaunch_fit
    from mxmoe_tpu_torch.solver.perf_model import (AnalyticPerfModel, OneLaunchPerfModel,
                                                   validate_analytic_against_measured)
    from mxmoe_tpu_torch.trace import gate, profiler

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = _offline_cfg()
    smi = smi_line() if on_card else "cpu"
    build_dir = os.path.join(HERE, "mxmoe_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="solve-", dir=build_dir)
    launches = {}

    def step():
        if on_card:
            torch.cuda.synchronize()
        _reset_counts()
        return time.perf_counter()

    def done(name, t0):
        if on_card:
            torch.cuda.synchronize()
        launches[name] = _counts()
        return time.perf_counter() - t0

    t_phase = time.perf_counter()
    try:
        params = params_from_safetensors(ckpt, cfg)
        nsamp, seqlen = SOLVE_TOKENS
        tokens = torch.from_numpy(synthetic_tokens(nsamp, seqlen, cfg.vocab_size))
        batch = nsamp * seqlen

        # 1. trace the gates through K11
        t0 = step()
        tr = gate.trace_gate_stats(params, tokens, cfg, backend="pallas", device=dev)
        t_trace = done("trace", t0)
        sums = tr.access_freq.sum(axis=1).tolist()
        if sums != [batch * cfg.top_k] * cfg.num_layers:
            raise AssertionError(f"solve trace: access counts {sums}, not "
                                 f"{batch * cfg.top_k} a layer")
        trace_path = os.path.join(root, "moe-gate.json")
        gate.dump_gate_trace(tr, trace_path)
        emit("solve_trace", card=smi, seconds=t_trace, tokens=batch,
             access_freq_sums=sums, experts_hit=int((tr.access_freq > 0).sum()),
             launches=launches["trace"])

        # 2. calibrate by RTN over the schemes, one scheme by GPTQ
        t0 = step()
        schemes = {s: parse_scheme(s) for s in SOLVE_SCHEMES}
        losses = calibrate.calibrate_model(params, tokens, cfg, schemes,
                                           save_dir=os.path.join(root, "calib"),
                                           model_id=OFFLINE_MODEL, backend="pallas",
                                           device=dev, verbose=False)
        t_rtn = time.perf_counter() - t0
        gptq = calibrate.calibrate_model(
            params, tokens, cfg, {SOLVE_GPTQ_SCHEME: parse_scheme(SOLVE_GPTQ_SCHEME)},
            method="gptq", backend="pallas", device=dev, verbose=False)
        t_cal = done("calibrate", t0)
        # entries in (layer, expert, linear) order; an expert the trace gave no
        # row has nothing to perturb: its loss must be exactly 0, every other
        # entry finite and > 0 (the shared expert sees every row)
        hit = np.concatenate([np.append(tr.access_freq[l] > 0, True)
                              for l in range(cfg.num_layers)]).repeat(3)
        arr = {s: np.array([v for l in sorted(d, key=int) for e in sorted(d[l], key=int)
                            for v in d[l][e]]) for s, d in {**losses, "gptq": gptq[
                                SOLVE_GPTQ_SCHEME]}.items()}
        bad = {s: int((~np.isfinite(a[hit]) | (a[hit] <= 0)).sum() + (a[~hit] != 0).sum())
               for s, a in arr.items()}
        if any(bad.values()):
            raise AssertionError(f"solve calibrate: losses not finite and > 0 where "
                                 f"rows were routed, or not 0 where none were {bad}")
        arr = {s: a[hit] for s, a in arr.items()}
        order = float((arr["w4a4_g-1_sym"] >= arr["w8a8_g-1_sym"]).mean())
        if order < SOLVE_ORDER_SHARE:
            raise AssertionError(f"solve calibrate: w4a4 >= w8a8 on {order} of the "
                                 f"entries, under {SOLVE_ORDER_SHARE}")
        emit("solve_calibrate", card=smi, seconds=t_cal, rtn_seconds=t_rtn,
             gptq_seconds=t_cal - t_rtn, entries=int(hit.size),
             entries_reached=int(hit.sum()),
             w4a4_ge_w8a8_share=order,
             median_loss={s: float(np.median(a)) for s, a in arr.items()},
             gptq_below_rtn_share=float((arr["gptq"] < arr[SOLVE_GPTQ_SCHEME]).mean()),
             launches=launches["calibrate"])

        # 3. the performance table and the one-launch fit on the card
        t0 = step()
        table, fits = profiler.build_performance_table(
            SOLVE_PROFILED, save_path=os.path.join(root, "performance_table.json"),
            device=dev, verbose=False, **(profile_kw or {}))
        t_table = time.perf_counter() - t0
        neg = {s: c.inc for s, t in table.table.items() for c in t.values() if not c.inc > 0}
        if neg:
            raise AssertionError(f"solve profile: inc <= 0 for {neg}")
        k_hid = cfg.hidden_size
        agreement = validate_analytic_against_measured(AnalyticPerfModel(k_hid), table)
        if on_card:
            fit = onelaunch_fit.run(os.path.join(root, "onelaunch_model.json"), dev,
                                    verbose=False)
            rates = {k: fit[k] for k in onelaunch_fit.RATE_KEYS}
            unpack = fit["measurements"]["unpack_fit"]
        else:
            fit, rates, unpack = {"validation": []}, None, {}
        t_prof = done("profile", t0)
        shares = {k: rates[k] / p for k, p in FIT_PEAKS.items()} if rates else {}
        # an unresolved unpack slope (inside the timing noise) writes 0.0, no
        # rate: it is printed, not held to the peak
        gated = {k: v for k, v in shares.items()
                 if k != "unpack_gops" or unpack.get("resolved")}
        over = {k: v for k, v in gated.items() if not 0 <= v <= 1.0}
        emit("solve_profile", card=smi, seconds=t_prof, table_seconds=t_table,
             table={s: {n: dataclasses.asdict(c) for n, c in t.items()}
                    for s, t in table.table.items()},
             residual_ms={s: f["residual_ms"] for s, f in fits.items()},
             onelaunch_rates=rates, peak_share=shares,
             unpack_resolved=unpack.get("resolved"),
             unpack_slopes_ms_per_elem=unpack.get("slopes_ms_per_elem"),
             unpack_slope_median=unpack.get("slope_median"),
             unpack_slope_spread=unpack.get("slope_spread"),
             onelaunch_fit_residual_ms=[r["residual_ms"] for r in unpack.get("rows", [])],
             onelaunch_validation=fit["validation"],
             analytic_vs_measured_agreement=agreement["agreement"],
             analytic_pairs=agreement["pairs"], launches=launches["profile"])
        if over:
            raise AssertionError(f"solve profile: fitted rates past the card's peak {over}")

        # 4. the MILP under the measured table and under the one-launch fit
        t0 = step()
        trace = gate.load_gate_trace(trace_path)
        problems = bits_solver.build_layer_problems(losses, trace, batch, cfg.num_layers)
        models = {"measured_table": table}
        if rates is not None:
            models["onelaunch"] = OneLaunchPerfModel(k_hid, **rates)
        solved = {}
        for name, perf in models.items():
            ts = time.perf_counter()
            qmc, tiles = bits_solver.solve_model(losses, trace, batch, cfg.num_layers,
                                                 SOLVE_WBITS, SOLVE_R, perf,
                                                 time_budget_s=SOLVE_MILP_BUDGET_S)
            rec = _solve_gates(qmc, problems, name)
            path = os.path.join(root, f"qconfig-{name}.json")
            bits_solver.export_qconfig(qmc, tiles, path)
            solved[name] = (qmc, path)
            emit("solve_milp", card=smi, runtime_model=name, seconds=time.perf_counter() - ts,
                 budget_s=SOLVE_MILP_BUDGET_S, wbits=SOLVE_WBITS, r=SOLVE_R, batch=batch, lt=qmc.lt, tiles=tiles,
                 scheme_counts={s: sum(c.scheme_name == s for lay in qmc.layers.values()
                                       for ex in lay.experts.values()
                                       for c in ex.qmap().values())
                                for s in rec["schemes_used"]}, **rec)
        t_solve = done("solve", t0)

        # 5. convert the solved mix (the CLI's default runtime model) and serve it
        qmc, qpath = solved.get("onelaunch", solved["measured_table"])
        a16 = any(c.a_bits >= 16 for lay in qmc.layers.values()
                  for ex in lay.experts.values() for c in ex.qmap().values())
        out = os.path.join(root, "artifact")
        t0 = step()
        convert.convert(ckpt, OFFLINE_MODEL, out, layers=OFFLINE_LAYERS, qconfig=qpath,
                        method="rtn", pack_w4=not a16, device=device)
        t_conv = done("convert", t0)
        params_a, cfg_a, impl = generate.load_artifact(out, cfg, dev)
        expect = served_kernels(params_a, impl)
        if keep is not None:
            keep["qconfig"] = shutil.copy(qpath, os.path.join(keep["dir"],
                                                              "qconfig-solved.json"))
            keep["expect"] = expect
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 48).tolist()
        max_new = 16
        t0 = step()
        got = generate.main(["--model", OFFLINE_MODEL, "--slots", "2", "--max-new",
                             str(max_new), "--prompt", " ".join(map(str, prompt)),
                             "--device", device, "--artifact", out])
        t_serve = done("serve", t0)
        if len(got) != max_new or not all(0 <= t < cfg.vocab_size for t in got):
            raise AssertionError("solve serve: a request came back short or out of vocab")
        missing = [k for k in expect if not launches["serve"].get(k)]
        if on_card and missing:
            raise AssertionError(f"solve serve: kernels the mix selects never launched: "
                                 f"{missing} ({launches['serve']})")
        # the served artifact's first chunk against the fake-quantized forward of
        # the same qconfig (printed, no gate)
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        with torch.no_grad():
            lg_art = model_mod.forward_logits(params_a, toks, cfg_a, impl).float()
            fake = quantizer.quantize_model_fake(params, cfg, qmc, "rtn", device=dev)
            fake = _to(fake, dev)
            lg_fake = model_mod.forward_logits(fake, toks, cfg,
                                               MoEImpl(gmm_backend="pallas")).float()
        del fake, params_a
        if not bool(torch.isfinite(lg_art).all()):
            raise AssertionError("solve serve: non-finite logits")
        emit("solve_serve", card=smi, convert_s=t_conv, serve_s=t_serve,
             runtime_model="onelaunch" if "onelaunch" in solved else "measured_table",
             pack_w4=not a16, mixed_weight_only=impl.mixed_weight_only,
             expected_kernels=expect, tokens=got, launches=launches["serve"],
             fake_vs_served_max_abs_logit_diff=float((lg_art - lg_fake).abs().max()),
             max_abs_logit=float(lg_art.abs().max()),
             fake_vs_served_top1_agreement=float(
                 (lg_art.argmax(-1) == lg_fake.argmax(-1)).float().mean()))
        emit("solve_phase", card=smi, seconds=time.perf_counter() - t_phase,
             step_seconds={"trace": t_trace, "calibrate": t_cal, "profile": t_prof,
                           "solve": t_solve, "convert": t_conv, "serve": t_serve})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# the eval phase: eval.run's windows (samples x length) and its gates: the
# real execution's ppl within EVAL_GAP of the fake-quant ppl (the reference's
# tiny-width test holds 0.5 %), the decode ppl within DECODE_GAP_BF16 (bf16
# KV) and DECODE_GAP_INT8 (int8 KV + int8 head) of the forward ppl; the
# anchor cut to ANCHOR_STEPS training steps and ANCHOR_WINDOWS eval windows
# of its 128 positions, its real w8a8 row within ANCHOR_REAL_GAP of the fake
# one and its decode row within DECODE_GAP_INT8 of the real forward row
EVAL_TOKENS = (4, 512)
EVAL_GAP, DECODE_GAP_BF16, DECODE_GAP_INT8 = 0.01, 5e-3, 2e-2
# the per-token gates on |out - reference| / |reference| (L2 over the row):
# its mean over the tokens of layer 0's MoE output on the card against the
# CPU's plain versions, its max over the decode logits against the forward
# logits (bf16 and int8 KV); the planted faults that must fail them: the
# down scales of layer 0's busiest expert off by EVAL_FAULT_SCALE, and K3 fed
# lengths one position off
EVAL_MOE_BOUND, DECODE_TOKEN_BOUND, EVAL_FAULT_SCALE = 4e-3, 0.2, 1.1
ANCHOR_STEPS, ANCHOR_WINDOWS, ANCHOR_REAL_GAP = 300, 16, 5e-3
# run_mxmoe's canonical workload and fused_ab's row counts
HARNESS_BS, HARNESS_LAYER = 8192, 10
FUSED_AB_MS = (512, 2048, 32768)


def _token_logit_err(test, ref) -> dict:
    """Per-token relative L2 error of rows [..., V] (logits, hidden states)
    against ``ref``: its mean, 99th percentile and max over the tokens, and
    the share of tokens whose top-1 agrees."""
    t, r = test.float().flatten(0, -2), ref.float().flatten(0, -2)
    err = (t - r).norm(dim=-1) / r.norm(dim=-1)
    return {"mean": float(err.mean()), "p99": float(err.quantile(0.99)),
            "max": float(err.max()),
            "top1": float((t.argmax(-1) == r.argmax(-1)).float().mean())}


def _expert_path_tokens(fake, real, tt, cfg, impl) -> dict:
    """Errors of the real model ``real`` (on the card) on tokens ``tt``: its
    ppl and per-token logits against the fake-quant ``fake``'s, and per token
    layer 0's MoE output on the first window against the same block run on
    the CPU (the kernels' plain versions, on the same input); each clean and
    with the planted fault (layer 0's busiest expert's down scales x
    EVAL_FAULT_SCALE on the card, restored after)."""
    import torch

    from mxmoe_tpu_torch.models import layers
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.models.model import forward_logits, layer_stacks

    moe = layers.moe_block

    def run(params, impl):
        first = []

        def keep(x, *a, **k):
            first.append(x)
            layers.moe_block = moe
            return moe(x, *a, **k)

        layers.moe_block = keep
        try:
            with torch.inference_mode():
                return forward_logits(params, tt, cfg, impl).float(), first[0]
        finally:
            layers.moe_block = moe

    def ppl(logits):
        lp = torch.log_softmax(logits[:, :-1], dim=-1)
        return float(torch.exp(-lp.gather(-1, tt[:, 1:].long()[..., None]).mean()))

    ref_logits, _ = run(fake, MoEImpl(kind="ragged"))
    logits, x0 = run(real, impl)
    ref_ppl = ppl(ref_logits)
    out = {"logits_vs_fake": _token_logit_err(logits, ref_logits),
           "ppl_gap": abs(ppl(logits) - ref_ppl) / ref_ppl}
    del logits
    stack, _ = next(iter(layer_stacks(real)))
    lp = {name: t[0] for name, t in stack.items()}
    lp_cpu = {name: t.cpu() for name, t in lp.items()}
    x = x0[:1]
    picks = (x.reshape(-1, x.shape[-1]).float() @ lp["router"].float()).topk(cfg.top_k).indices
    busiest = int(picks.flatten().bincount(minlength=cfg.num_experts).argmax())
    with torch.inference_mode():
        plain = moe(x.cpu(), lp_cpu, cfg, impl).float()
        card = moe(x, lp, cfg, impl).float().cpu()
        lp["expert_down_sc"][busiest] *= EVAL_FAULT_SCALE
        try:
            planted = moe(x, lp, cfg, impl).float().cpu()
            planted_logits, _ = run(real, impl)
        finally:
            lp["expert_down_sc"][busiest] /= EVAL_FAULT_SCALE
    out.update(
        ppl_gap_planted=abs(ppl(planted_logits) - ref_ppl) / ref_ppl,
        logits_planted_vs_fake=_token_logit_err(planted_logits, ref_logits),
        moe0_vs_plain=_token_logit_err(card, plain),
        moe0_planted_vs_plain=_token_logit_err(planted, plain), tokens=x.shape[1],
        fault=f"layer 0 expert {busiest}'s down scales x {EVAL_FAULT_SCALE}")
    return out


@contextlib.contextmanager
def _decode_logits(out: list, shift: bool = False):
    """Keep every decode step's logits [B, V] (f32) in ``out`` while
    ``decode_nll(captured=False)`` runs (the teacher-forced step's body run
    eagerly a token: a captured step's body runs only at its capture);
    ``shift`` plants a fault: K3 / K3q get lengths + 1, so each step writes
    one position late and reads one stale slot."""
    from mxmoe_tpu_torch.serving import decode, graph

    fc, da = graph.forward_cached, decode.decode_attention_update_stacked

    def keep(*a, **k):
        logits, cache = fc(*a, **k)
        out.append(logits[:, 0].float())
        return logits, cache

    def off_by_one(q, k, v, ck, cks, cv, cvs, lengths, layer, **kw):
        return da(q, k, v, ck, cks, cv, cvs, lengths + 1, layer, **kw)

    graph.forward_cached = keep
    if shift:
        decode.decode_attention_update_stacked = off_by_one
    try:
        yield
    finally:
        graph.forward_cached, decode.decode_attention_update_stacked = fc, da


def eval_phase(ckpt: str, qconfig: str, expect: list, device: str = "cuda") -> dict:
    """Phase 11: evaluation and the remaining benches, each step's launch
    counts set to 0 before it and read after it.

    (a) ``eval.run`` on the offline checkpoint (qwen2_moe, full width,
        ``OFFLINE_LAYERS`` deep) with the solve phase's served qconfig by
        RTN, fake-quant and ``--real-exec``: ppl gap within EVAL_GAP, the
        kernels the storage selects (``expect``, less K3) launched;
    (b) ``eval_ppl_decode``'s captured step on the same real model: bf16 KV
        (K3) and int8 KV + int8 head (K3q, K1 + K2) against the forward ppl,
        its kernels counted and gated, its nll bitwise the eager twin's
        (the step's body run a token), which is gated token by token;
    (c) ``eval.anchor.run_anchor`` on the card (steps and windows cut), both
        methods: ppl_fp below the unigram floor, the real rows against the
        fake / forward ones, the root ACCURACY.md unchanged, K1 / K2 / K4 /
        K3q (dk 32) launched;
    (d) ``run_mxmoe --check`` and bench on the canonical trace, with the
        solved qconfig and with w4a4, every bucket PASS and timed; then
        ``bench.fused_ab`` with ``cross_check_max_abs`` 0.
    (a) and (b) are also held per token, each against a planted fault that
    must fail the gate; (d) times with ``device_ms`` after (c)'s training."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mxmoe_tpu_torch import run_mxmoe
    from mxmoe_tpu_torch.bench import fused_ab, timing
    from mxmoe_tpu_torch.eval import anchor
    from mxmoe_tpu_torch.eval import run as eval_run
    from mxmoe_tpu_torch.eval.evaluator import decode_nll, eval_ppl_tokens
    from mxmoe_tpu_torch.models.hf_loader import params_from_safetensors
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.models.model import forward_logits
    from mxmoe_tpu_torch.quant.data import get_calibration_tokens
    from mxmoe_tpu_torch.quant.qparams import quantize_lm_head, quantize_model_experts_mixed
    from mxmoe_tpu_torch.quant.quantizer import quantize_model_fake
    from mxmoe_tpu_torch.quant.schemes import QModelConfig

    dev = torch.device(device)
    cfg = _offline_cfg()
    smi = smi_line()
    launches, seconds = {}, {}
    k3, k3q = "decode_attention_update_stacked", "decode_attention_update_stacked_q8"

    def step():
        torch.cuda.synchronize()
        _reset_counts()
        return time.perf_counter()

    def done(name, t0):
        torch.cuda.synchronize()
        launches[name] = _counts()
        seconds[name] = time.perf_counter() - t0
        return seconds[name]

    def rel(a, b):
        return abs(a - b) / b

    t_phase, lost0 = time.perf_counter(), timing.LOST_TRACES[0]
    nsamp, seqlen = EVAL_TOKENS
    # (a) the CLI, fake-quant then real execution
    ppl = {}
    for arm, extra in (("fake", []), ("real", ["--real-exec"])):
        t0 = step()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = eval_run.main(["--model", OFFLINE_MODEL, "--layers", str(OFFLINE_LAYERS),
                                 "--ckpt", ckpt, "--qconfig", qconfig, "--method", "rtn",
                                 "--nsamples", str(nsamp), "--seqlen", str(seqlen),
                                 "--device", device, *extra])
        t = done(f"run_{arm}", t0)
        ppl[arm] = res["synthetic_ppl"]
        emit("eval_run", card=smi, arm=arm, ppl=ppl[arm], seconds=t,
             tokens_per_s=nsamp * seqlen / t, launches=launches[f"run_{arm}"])
    gap = rel(ppl["real"], ppl["fake"])
    missing = [k for k in expect if k != k3 and not launches["run_real"].get(k)]
    emit("eval_run", card=smi, fake_ppl=ppl["fake"], real_ppl=ppl["real"], rel_gap=gap,
         bound=EVAL_GAP, expected_kernels=[k for k in expect if k != k3])
    if not (np.isfinite(gap) and gap <= EVAL_GAP) or missing:
        raise AssertionError(f"eval run: real {ppl['real']} vs fake {ppl['fake']} "
                             f"(gap {gap} > {EVAL_GAP}?), kernels never launched "
                             f"{missing}")

    # (a) per token and (b): the CLI's models rebuilt as it builds them (the
    # bf16 checkpoint, RTN). The ppl of a random-init model sits near its
    # vocab and hardly depends on the experts, so the real expert path is
    # also held per token: layer 0's MoE output on the card against the
    # kernels' plain versions on the CPU, and a planted fault shows that this
    # gate fails
    qmc = QModelConfig.load(qconfig)
    a16 = any(c.a_bits >= 16 for lay in qmc.layers.values()
              for ekey, ex in lay.experts.items() if int(ekey) < cfg.num_experts
              for c in ex.qmap().values())
    base = params_from_safetensors(ckpt, cfg)
    fake = _to(quantize_model_fake(base, cfg, qmc, method="rtn", device=dev), dev)
    real = _to(quantize_model_experts_mixed(base, cfg, qmc, pack_w4=not a16,
                                            device=dev), dev)
    del base
    impl = MoEImpl(quant="mixed", mixed_weight_only=a16)
    toks = np.asarray(get_calibration_tokens(nsamp, seqlen, vocab_size=cfg.vocab_size))
    tt = torch.as_tensor(toks, dtype=torch.int32, device=dev)
    tok = _expert_path_tokens(fake, real, tt, cfg, impl)
    del fake
    emit("eval_run_tokens", card=smi, **tok, bound=EVAL_MOE_BOUND)
    clean, planted = tok["moe0_vs_plain"]["mean"], tok["moe0_planted_vs_plain"]["mean"]
    if not clean <= EVAL_MOE_BOUND < planted:
        raise AssertionError(f"eval run per token: layer 0 MoE on the card vs plain "
                             f"{clean}, planted {planted}, bound {EVAL_MOE_BOUND}")

    # (b) the serving decode path on the same real model, per token against
    # its forward logits
    with torch.inference_mode():
        fwd_logits = forward_logits(real, tt, cfg, impl).float()[:, :-1]
    fwd = eval_ppl_tokens(real, toks, cfg, impl)
    for arm, int8, fault in (("decode_bf16", False, False), ("decode_int8", True, False),
                             ("decode_bf16_planted", False, True)):
        params = quantize_lm_head(real) if int8 else real
        bound = DECODE_GAP_INT8 if int8 else DECODE_GAP_BF16
        need = (k3q, "quantize_rows", "gmm_w8a8") if int8 else (k3,)
        main = {}
        if not fault:
            # eval_ppl_decode's path, the captured step: its counts are the arm's
            t0 = step()
            nll_c, ntok = decode_nll(params, toks, cfg, impl, int8_kv=int8, batch=nsamp)
            t = done(arm, t0)
            got = float(np.exp(nll_c / ntok))
            main = {"ppl": got, "rel_gap": rel(got, fwd), "bound": bound,
                    "seconds": t, "tokens_per_s": nsamp * (seqlen - 1) / t,
                    "launches": launches[arm], "captured_nll": nll_c}
        # the eager twin (the step's body run a token), whose logits the
        # per-token gate reads; its counts are kept apart from the arm's
        steps = []
        t0 = step()
        with _decode_logits(steps, shift=fault):
            nll, ntok = decode_nll(params, toks, cfg, impl, int8_kv=int8, batch=nsamp,
                                   captured=False)
        t_e = done(f"{arm}_eager", t0)
        eager_launches = launches.pop(f"{arm}_eager")
        err = _token_logit_err(torch.stack(steps, 1), fwd_logits)
        del steps
        emit("eval_decode", card=smi, arm=arm, forward_ppl=fwd, cli_real_ppl=ppl["real"],
             **main, eager_nll=nll, eager_ppl=float(np.exp(nll / ntok)),
             per_token=err, token_bound=DECODE_TOKEN_BOUND, eager_seconds=t_e,
             eager_launches=eager_launches,
             **({"captured_nll_equal": main["captured_nll"] == nll} if main else {}),
             **({"fault": "K3 called with lengths + 1: one cache position off"}
                if fault else {}))
        if fault:
            if not err["max"] > DECODE_TOKEN_BOUND:
                raise AssertionError(f"eval decode: the planted fault passes the per-token "
                                     f"gate ({err['max']} <= {DECODE_TOKEN_BOUND})")
        elif not (main["captured_nll"] == nll and main["rel_gap"] <= bound
                  and err["max"] <= DECODE_TOKEN_BOUND
                  and all(launches[arm].get(k) for k in need)):
            raise AssertionError(f"eval decode {arm}: captured nll {main['captured_nll']} "
                                 f"vs the eager twin's {nll}, ppl {main['ppl']} vs forward "
                                 f"{fwd} (bound {bound}), per token {err['max']} (bound "
                                 f"{DECODE_TOKEN_BOUND}), or {need} never launched in the "
                                 f"captured run")
        del params
    del real, fwd_logits
    torch.cuda.empty_cache()

    build_dir = os.path.join(HERE, "mxmoe_tpu_torch", "_build")
    root = tempfile.mkdtemp(prefix="eval-", dir=build_dir)
    try:
        # (c) the accuracy anchor, trained and scored on the card
        with open(os.path.join(HERE, "ACCURACY.md"), "rb") as f:
            accuracy_md = f.read()
        t0 = step()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = anchor.run_anchor(steps=ANCHOR_STEPS, out_dir=os.path.join(root, "anchor"),
                                    methods=("rtn", "gptq-had"),
                                    eval_windows=ANCHOR_WINDOWS, seqlen=128,
                                    backend="pallas", device=device)
        t = done("anchor", t0)
        with open(os.path.join(HERE, "ACCURACY.md"), "rb") as f:
            md_same = f.read() == accuracy_md
        real_gap = rel(res["ppl_realexec_w8a8"], res["ppl_w8a8_rtn"])
        dec_gap = rel(res["ppl_realexec_decode_mixed_w5"], res["ppl_realexec_mixed_w5"])
        emit("eval_anchor", card=smi, seconds=t, **res, realexec_w8a8_gap=real_gap,
             decode_gap=dec_gap, accuracy_md_unchanged=md_same,
             launches=launches["anchor"])
        need = ("quantize_rows", "gmm_w8a8", "gmm_mixed_packed", k3q)
        if not (res["ppl_fp"] < res["ppl_unigram_floor"] and real_gap <= ANCHOR_REAL_GAP
                and dec_gap <= DECODE_GAP_INT8 and md_same
                and all(launches["anchor"].get(k) for k in need)):
            raise AssertionError(f"eval anchor: a gate failed (fp {res['ppl_fp']} vs "
                                 f"floor {res['ppl_unigram_floor']}, real gap {real_gap}, "
                                 f"decode gap {dec_gap}, ACCURACY.md unchanged {md_same}, "
                                 f"launches {launches['anchor']})")
        # (d) the check / bench harness over the canonical trace, then fused_ab.
        # The solved qconfig is OFFLINE_LAYERS deep: its run puts the canonical
        # counts at its last layer
        for arm, args in (("harness_qconfig", ["--qconfig", qconfig, "--layer",
                                               str(OFFLINE_LAYERS - 1)]),
                          ("harness_w4a4", ["--qstr", "w4a4_g-1_sym", "--layer",
                                            str(HARNESS_LAYER)])):
            t0 = step()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rows = run_mxmoe.main(["--model", OFFLINE_MODEL, "--bs", str(HARNESS_BS),
                                       "--check", "--out_dir", os.path.join(root, arm),
                                       *args])
            t = done(arm, t0)
            checks = [l for l in buf.getvalue().splitlines() if l.startswith("[CHECK]")]
            rows = [r for layer_rows in rows.values() for r in layer_rows]
            for r in rows:
                emit("eval_harness", card=smi, arm=arm, **r)
            emit("eval_harness", card=smi, arm=arm, seconds=t, checks=checks,
                 launches=launches[arm])
            if not (checks and all(l.endswith("PASS") for l in checks)
                    and len(rows) == len(checks)
                    and all(r["ms"] > 0 and r["tflops"] > 0 and r["speedup_vs_bf16"] > 0
                            for r in rows)):
                raise AssertionError(f"eval harness {arm}: checks {checks}, rows {rows}")
        t0 = step()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            lines = fused_ab.main(["--ms", *map(str, FUSED_AB_MS)])
        t = done("fused_ab", t0)
        for line in lines:
            emit("eval_fused_ab", card=smi, **line)
        cross = [l["cross_check_max_abs"] for l in lines if "cross_check_max_abs" in l]
        if cross != [0.0] * len(FUSED_AB_MS):
            raise AssertionError(f"fused_ab: cross checks {cross}")
        emit("eval_fused_ab", card=smi, seconds=t, launches=launches["fused_ab"])

    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("eval_phase", card=smi, seconds=time.perf_counter() - t_phase,
         step_seconds=seconds, device_ms_lost_traces=timing.LOST_TRACES[0] - lost0)
    return launches


# profiled runs counted after a backward pass, without and with device_ms's
# lead-in, and how many with it may lose a marker
PROFILER_RUNS, PROFILER_LOST_MAX = 20, 2


def profiler_after_backward() -> dict:
    """PROFILER_RUNS profiled runs of one kernel without ``timing``'s
    lead-in, then the anchor's training (torch autograd, ANCHOR_STEPS steps)
    on the card, then the same runs without and with the lead-in: once a
    backward pass has run after the profiler, a run's first kernel can be
    missing from its trace, and the lead-in takes that place. Every later
    device_ms call runs in this state."""
    import torch

    from mxmoe_tpu_torch.bench import timing
    from mxmoe_tpu_torch.eval import anchor
    from mxmoe_tpu_torch.ops import act_quant

    dev = torch.device("cuda")
    x = torch.randn((256, 2048), device=dev, dtype=torch.bfloat16)
    bits = torch.full((256,), 8.0, device=dev)

    def one():
        return act_quant.quantize_rows(x, bits)

    def lost(lead):
        torch.cuda.synchronize()
        return sum(timing._profiled_calls(one, timing.SESSION_REPS, lead=lead) is None
                   for _ in range(PROFILER_RUNS))

    before = lost(False)
    anchor.train_anchor_model(anchor.anchor_config(), steps=ANCHOR_STEPS, log_every=0)
    bare, led = lost(False), lost(True)
    if led > PROFILER_LOST_MAX:
        raise AssertionError(f"after a backward pass {led} of {PROFILER_RUNS} profiled "
                             "runs with the lead-in lost a marker")
    return {"profiled_runs": PROFILER_RUNS, "lost_before_training": before,
            "lost_without_lead_in": bare, "lost_with_lead_in": led}


def float_arms_agree() -> None:
    """The two arms of the float path, K11 and the stock grouped product, on
    one 4-layer full-width model and the same tokens (a 256-token prefill
    chunk, then 4 decode steps fed the K11 arm's greedy tokens): each arm's
    grouped products stand within their accumulation bound of the exact
    product (kernels phase), so the bf16 logits agree within the parity bound
    of the CUDA-vs-CPU runs, PARITY_ULPS bf16 ulps at max|logits|."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.ops import kernels
    from mxmoe_tpu_torch.serving.decode import forward_cached

    cfg, floats = _full_width_model(4, seed=3)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    b, chunk, steps = 2, 256, 4
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32),
                             device=dev)
    logits, fed, launches = {}, [], {}
    for arm in ("bf16-k11", "none"):
        params, impl = prepare(floats, cfg, arm)
        cache = _init_cache(cfg, b, 512, False, dev)
        kernels.reset_launch_counts()
        lg, cache = forward_cached(params, prompt, cache, cfg, impl)
        out = [lg[:, -1]]
        for i in range(steps):
            if arm == "bf16-k11":
                fed.append(out[-1].argmax(-1).to(torch.int32)[:, None])
            lg, cache = forward_cached(params, fed[i], cache, cfg, impl)
            out.append(lg[:, 0])
        logits[arm] = torch.stack(out).float()
        launches[arm] = kernels.launches["gmm_bf16"]
    torch.cuda.synchronize()
    a, c = logits["bf16-k11"], logits["none"]
    err = (a - c).abs().max().item()
    bound = min(PARITY_BOUND, PARITY_ULPS * bf16_ulp(a.abs().max()).item())
    emit("float_arms", layers=cfg.num_layers, decode_steps=steps, max_abs_diff=err,
         bound=bound, max_abs_logit=a.abs().max().item(),
         gmm_bf16_launches=launches, finite=bool(torch.isfinite(a).all()))
    if not (torch.isfinite(a).all() and err <= bound):
        raise AssertionError(f"float arms: K11 and the stock product differ by "
                             f"{err} > {bound}")
    if launches["bf16-k11"] != 2 * cfg.num_layers * (1 + steps) or launches["none"]:
        raise AssertionError(f"float arms: unexpected K11 launches {launches}")


def bench_entry_point(quant_args: list, expect: tuple, absent: tuple = ()) -> None:
    """The bench_serving entry point as a user calls it, at a small depth;
    its launch counts are set to 0 before the call and read after it: the
    kernels in ``expect`` must launch, those in ``absent`` not."""
    from mxmoe_tpu_torch.ops import kernels
    from mxmoe_tpu_torch.serving import bench_serving

    kernels.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_serving.main(["--layers", "4", "--slots", "4", "--max-len", "1024",
                            "--prefill", "256", *quant_args])
    launches = dict(kernels.launches)
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    emit("bench", **res, launches=launches)
    missing = [k for k in expect if launches[k] <= 0]
    stray = [k for k in absent if launches[k]]
    if missing or stray:
        raise AssertionError(f"bench_serving {quant_args}: kernels never "
                             f"launched: {missing}; launched but must not: {stray}")
    keys = {"model", "layers", "slots", "quant", "int8_head", "int8_kv",
            "prefill_ms", "prefill_tokens_per_s", "decode_attn", "decode_step_ms",
            "decode_tokens_per_s", "device"}
    if not (keys <= set(res) and res["decode_tokens_per_s"] > 0
            and res["prefill_ms"] > 0
            and res["int8_kv"] is ("--int8-kv" in quant_args)
            and res["int8_head"] is ("--int8-head" in quant_args)
            and res["decode_attn"] == (quant_args[quant_args.index("--decode-attn") + 1]
                                       if "--decode-attn" in quant_args else "auto")):
        raise AssertionError(f"bench_serving: unexpected result {res}")


def headline_bench() -> int:
    """``bench/headline.py`` in the process, at the workload's full shapes:
    the mixed one-launch arm and the bucketed arm. Each arm's outputs (K15)
    are held bitwise against its ``--no-ws`` arm's (K2; K5 + K2) on one call;
    then each arm runs as its entry point does and prints its JSON line.
    Returns K15's launches in the one-launch arm's run."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.bench import headline, workloads
    from mxmoe_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(42)
    operands = [headline.build_fp_operands(wl, gen, dev)
                for wl in workloads.qwen2_moe_l10_bs8192()]
    masks = [np.arange(len(op[2])) % 2 == 0 for op in operands]
    for label, prep, make in (
            ("onelaunch", headline.quantize_weights_mixed_onelaunch,
             headline.mixed_onelaunch_step),
            ("bucketed", headline.quantize_weights_mixed, headline.mixed_bucketed_step)):
        q = prep(operands, masks)
        ws = make(q, ws=True)()
        no_ws = make(q, ws=False)()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(ws, no_ws)):
            _require_equal(a, b, f"headline {label} output {i}: K15 vs --no-ws")
        emit("headline", arm=label, ws_equals_no_ws=True, outputs=len(ws),
             finite=all(bool(torch.isfinite(o).all()) for o in ws))
        del q, ws, no_ws
    del operands
    torch.cuda.empty_cache()
    counts = {}
    for argv in ([], ["--bucketed"]):
        kernels.reset_launch_counts()
        res = headline.main(argv)
        counts[" ".join(argv) or "mixed"] = kernels.launches["gmm_ws"]
        if not (kernels.launches["gmm_ws"] > 0 and res["value"] > 0
                and res["vs_baseline"] > 0):
            raise AssertionError(f"headline {argv}: K15 never launched or no result")
    emit("headline", gmm_ws_launches=counts)
    return counts["mixed"]



# phase 12 (ep): the 2-rank serves on one card, each over a 4-layer
# qwen2_moe: name -> (bench_serving --quant, kernels that must launch)
EP_SERVES = {
    "uniform": ("w8a8_g-1_sym", ("quantize_rows", "gmm_w8a8",
                                 "decode_attention_update_stacked")),
    "mixed_packed": ("mixed-packed", ("quantize_rows", "gmm_w8a8", "gmm_mixed_packed",
                                      "decode_attention_update_stacked")),
    "flex": ("flex", ("gmm_w8a8_grouped", "quantize_rows", "gmm_w8a8",
                      "decode_attention_update_stacked")),
    "mixed_wo": ("mixed-wo", ("quantize_rows", "gmm_mixed_wo_wxa", "gmm_w8a8",
                              "decode_attention_update_stacked")),
}
# the one-rank NCCL serve: qwen2_moe at full depth, mixed-packed + int8 KV
EP_ONE_RANK_EXPECT = ("quantize_rows", "gmm_w8a8", "gmm_mixed_packed",
                      "decode_attention_update_stacked_q8")
EP_PROMPT_LENS = (40, 120, 200, 300)
EP_MAX_NEW = 16
# host calls (graph launches, copies) a captured mesh decode step may make
MESH_LAUNCH_CALLS = 5
# the host-staged serves' note: why they are not captured
HOST_EAGER = "eager: the host-staged exchange copies through host memory in every MoE block"
# ring SP prefill against forward_logits, float32 model: max |d| over
# max |logits| (the ring's online softmax sums in another order than the
# plain softmax; float32 rounding stays far below)
SP_REL = 1e-3


def _ep_model(layers: int, quant: str, device, dtype=None):
    """qwen2_moe at its published widths, ``layers`` deep, seed 0 (every
    serve of the phase and every rank draws the same weights), each MoE
    layer quantized as ``prepare`` takes ``quant`` -> (config, params,
    MoEImpl); ``dtype`` float32 keeps the float model in float32."""
    import torch

    from mxmoe_tpu_torch.models.configs import config_for
    from mxmoe_tpu_torch.models.model import init_params
    from mxmoe_tpu_torch.serving.bench_serving import init_for_serving

    cfg = dataclasses.replace(config_for("qwen2_moe"), num_layers=layers)
    gen = torch.Generator(device=device).manual_seed(0)
    if dtype is not None:
        return cfg, init_params(cfg, gen, dtype=dtype, device=device), None
    params, impl = init_for_serving(
        cfg, gen, functools.partial(prepare, quant=quant), device)
    return cfg, params, impl


def _ep_prompts(vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(12)
    return [rng.integers(0, vocab, n).tolist() for n in EP_PROMPT_LENS]


def _engine_tokens(params, cfg, impl, prompts, int8_kv: bool, mesh=None, ep_cfg=None,
                   cuda_graphs: bool = True, snap=None):
    """4 requests through the Engine (one device, or the mesh; captured, or
    eager with ``cuda_graphs`` False) -> (tokens, engine). ``snap``: a list
    that gets the post-prefill cache (on the host) and last tokens."""
    import torch

    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig
    from mxmoe_tpu_torch.serving.kv_cache import clone_cache

    eng = Engine(params, cfg, EngineConfig(batch_slots=4, max_len=1024,
                                           prefill_chunk=256, int8_kv=int8_kv,
                                           cuda_graphs=cuda_graphs),
                 impl, mesh=mesh, ep_cfg=ep_cfg)
    with torch.inference_mode():
        rids = [eng.submit(p, max_new_tokens=EP_MAX_NEW) for p in prompts]
        if snap is not None:
            snap += [clone_cache(eng.cache, "cpu"), eng._last_tokens.copy()]
        res = eng.run_to_completion(chunk=16)
    return [res[r] for r in rids], eng


def _margin_rule(got: list, ref: list, prompts: list, params, cfg, impl) -> dict:
    """The EP serve's tokens against the one-device serve's: equal, or
    parting first at a position where the one-device model's top-2 logit
    margin (a forward over the prompt and the tokens before it) is within
    PARITY_BOUND, so a tie decided it. Raises otherwise."""
    import torch

    from mxmoe_tpu_torch.models.model import forward_logits

    parted = []
    for i, (g, r) in enumerate(zip(got, ref)):
        j = next((j for j, (a, b) in enumerate(zip(g, r)) if a != b), None)
        if j is None and len(g) == len(r):
            continue
        j = min(len(g), len(r)) if j is None else j
        toks = torch.tensor([prompts[i] + r[:j]], device=params["embed"].device)
        with torch.inference_mode():
            margin = float(_top2_margin(forward_logits(params, toks, cfg, impl)[0, -1]))
        parted.append({"request": i, "position": j, "top2_margin": margin})
        if not margin <= PARITY_BOUND:
            raise AssertionError(f"ep: request {i} parts from the one-device tokens at "
                                 f"{j} where the top-2 margin is {margin} > "
                                 f"{PARITY_BOUND}: {g} against {r}")
    return {"equal": not parted, "parted": parted}


def _ep_two_ranks(rank: int, out: str, device_type: str) -> None:
    """One rank of the 2-rank phase: both ranks on the one card, the
    exchange staged through host buffers over gloo (NCCL refuses two ranks
    on one card). For each EP_SERVES mix: rank 0 serves the requests on one
    device first, then both serve them over the mesh; then the ring SP
    prefill. Writes its results to ``out``/rank<r>.json."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.models.model import forward_logits
    from mxmoe_tpu_torch.ops import kernels
    from mxmoe_tpu_torch.parallel.ep import EPConfig, capacity_factor_from_freq
    from mxmoe_tpu_torch.parallel.sharded import make_sp_prefill_forward
    from mxmoe_tpu_torch.trace.gate import trace_gate_stats

    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kernels.lib()
    mesh = DeviceMesh("cpu", [0, 1], mesh_dim_names=("expert",))
    res = {"rank": rank, "device": str(device), "transport": "host (gloo)"}
    # the capacity the gate trace gives: the float model over the prompts
    cap = [None]
    if rank == 0:
        cfg, floats, _ = _ep_model(4, None, device, torch.bfloat16)
        prompts = _ep_prompts(cfg.vocab_size)
        toks = torch.tensor([p[:EP_PROMPT_LENS[0]] for p in prompts], device=device)
        trace = trace_gate_stats(floats, toks, cfg, device=device)
        cap[0] = max(max(capacity_factor_from_freq(f, 2, margin=1.5)
                         for f in trace.access_freq), 2.0)
        del floats
    dist.broadcast_object_list(cap)
    res["capacity_factor"] = cap[0]
    ep_cfg = EPConfig(capacity_factor=cap[0], return_stats=True, transport="host")
    for name, (quant, expect) in EP_SERVES.items():
        cfg, params, impl = _ep_model(4, quant, device)
        prompts = _ep_prompts(cfg.vocab_size)
        ref = None
        if rank == 0:
            t0 = time.perf_counter()
            ref, eng = _engine_tokens(params, cfg, impl, prompts, False)
            one_device_s = time.perf_counter() - t0
            del eng
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got, eng = _engine_tokens(params, cfg, impl, prompts, False, mesh, ep_cfg,
                                  cuda_graphs=False)
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items() if v}
        row = {"quant": quant, "tokens": got, "seconds": seconds,
               "dropped_assignments": eng.dropped_assignments(),
               "local_slots": int(eng.cache.lengths.shape[0]),
               "launches": launches,
               "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                        if device.type == "cuda" else None)}
        if rank == 0:
            row["vs_one_device"] = _margin_rule(got, ref, prompts, params, cfg, impl)
            row["one_device_serve_s"] = one_device_s
        missing = [k for k in expect if not launches.get(k)]
        if device.type == "cuda" and missing:
            raise AssertionError(f"ep {name}: kernels never launched under EP: {missing}")
        res[name] = row
        del eng, params
    # one ring SP prefill at 2 ranks against forward_logits (float32 model)
    cfg, floats, _ = _ep_model(2, None, device, torch.float32)
    impl = MoEImpl(gmm_backend="pallas")
    toks = torch.tensor([_ep_prompts(cfg.vocab_size)[3][:256]], device=device)
    with torch.inference_mode():
        ref = forward_logits(floats, toks, cfg, impl)
        half = toks.shape[1] // 2
        got = make_sp_prefill_forward(cfg, mesh, "expert", impl, transport="host")(
            floats, toks[:, rank * half:(rank + 1) * half])
    err = float((got - ref[:, rank * half:(rank + 1) * half]).abs().max())
    res["sp_prefill"] = {"tokens": int(toks.shape[1]), "ranks": 2,
                         "max_abs_err": err, "max_abs_logit": float(ref.abs().max()),
                         "bound": SP_REL * float(ref.abs().max())}
    if not err <= SP_REL * float(ref.abs().max()):
        raise AssertionError(f"ep: ring SP prefill on rank {rank}: {err}")
    # the tensor-parallel forward over a (1, 2) ("data", "expert") mesh, the
    # sums staged through host buffers: the rank's heads, experts and shared
    # columns, every token
    from mxmoe_tpu_torch.parallel.mesh import shard_params
    from mxmoe_tpu_torch.parallel.sharded import make_tp_forward

    tp_mesh = DeviceMesh("cpu", [[0, 1]], mesh_dim_names=("data", "expert"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    local = shard_params(floats, tp_mesh)
    with torch.inference_mode():
        got = make_tp_forward(cfg, tp_mesh, impl, transport="host")(local, toks)
    err = float((got - ref).abs().max())
    lp = local["layers"]
    res["tp_forward"] = {
        "tokens": int(toks.shape[1]), "mesh": {"data": 1, "expert": 2},
        "seconds": time.perf_counter() - t0,
        "local": {"experts": int(lp["expert_gate_up"].shape[1]),
                  "q_heads": int(lp["wq"].shape[-1]) // cfg.head_dim,
                  "kv_heads": int(lp["wk"].shape[-1]) // cfg.head_dim,
                  "shared_gate_cols": int(lp["shared_gate_up"].shape[-1]) // 2,
                  "shared_up_cols": int(lp["shared_gate_up"].shape[-1]) // 2},
        "launches": {k: v for k, v in kernels.launches.items() if v},
        "max_abs_err": err, "max_abs_logit": float(ref.abs().max()),
        "bound": SP_REL * float(ref.abs().max()),
        "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                    if device.type == "cuda" else None)}
    if not err <= SP_REL * float(ref.abs().max()):
        raise AssertionError(f"ep: tensor-parallel forward on rank {rank}: {err}")
    if device.type == "cuda" and not res["tp_forward"]["launches"].get("gmm_bf16"):
        raise AssertionError(f"ep: tensor-parallel forward on rank {rank}: no K11")
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


_NCCL_PROBE = """
import os, torch, torch.distributed as dist
rank = int(os.environ["PROBE_RANK"])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="tcp://localhost:" + os.environ["PROBE_PORT"],
                        world_size=2, rank=rank)
t = torch.ones(4, device="cuda:0")
dist.all_reduce(t)
torch.cuda.synchronize()
print("NCCL-ALL-REDUCE-OK", rank, t.tolist(), flush=True)
dist.destroy_process_group()
"""


def nccl_two_ranks_one_card() -> dict:
    """Whether NCCL takes two ranks on the one card: an all_reduce between
    two processes both on cuda:0, each with a time limit (killed at it). The
    phase stages its 2-rank exchange through host buffers either way (the
    transport is the caller's choice); this records NCCL's answer."""
    from mxmoe_tpu_torch.parallel.multihost import free_port

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PROBE_PORT"] = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_PROBE],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env={**env, "PROBE_RANK": str(r)}) for r in (0, 1)]
    outs, codes = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n(timed out after 90 s, killed)"
        outs.append(out)
        codes.append(p.returncode)
    lines = [l for o in outs for l in o.splitlines()
             if "NCCL" in l or "rror" in l or "timed out" in l][:10]
    return {"returncodes": codes, "lines": lines,
            "accepted": all(c == 0 for c in codes)
            and all("NCCL-ALL-REDUCE-OK" in o for o in outs)}


def mesh_graph_checks(eng, eager_eng, snap) -> None:
    """Phase 12 (a)'s checks of the captured one-rank mesh Engine ``eng``
    after its serve (``snap``: its post-prefill cache on the host and its
    last tokens then) beside ``eager_eng``, the same serve eager:

    - ``step``: the mesh decode step eager (``forward_cached`` over a clone
      of the post-prefill cache) and captured (the Engine's graph over its
      own cache, set back to that state) in turns (``profile_decode.abba``,
      8 steps a turn): wall and device ms, busy share, kernels and host
      launch calls a step (at most MESH_LAUNCH_CALLS captured), and the
      exchange kernels a captured step ran (NCCL's, or the copy that NCCL
      makes of an equal-split exchange at one rank);
    - ``chunk``: ``submit``'s chunk, [1, 256] under ``EPMoEBlock.rows`` on a
      staging cache, eager and captured (``profile_decode.prefill_arms``):
      logits and every cache byte bitwise, then in turns, a chunk a turn,
      with its exchange kernels and the graph's set-up seconds and memory;
    - ``ttft``: a 512-token prompt's time to the first token through each
      Engine's ``submit`` (``profile_decode.first_token_times``, one submit
      a turn), the same first token.

    Prints one ``mesh_graph`` line; raises on a failed check."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.serving import profile_decode
    from mxmoe_tpu_torch.serving.decode import forward_cached
    from mxmoe_tpu_torch.serving.kv_cache import clone_cache

    t0 = time.perf_counter()
    dev, cfg = eng.device, eng.cfg
    order = ("eager", "captured", "captured", "eager")
    res = {"layers": cfg.num_layers, "card": smi_line(), "order": order}

    def exchange(turns):
        names = turns["captured"].pop("by_name")
        turns["eager"].pop("by_name")
        return (sorted(k for k in names if "nccl" in k.lower() or "memcpy" in k.lower()),
                any("nccl" in k.lower() for k in names))

    cache0, last0 = snap
    slots = eng.cache.lengths.shape[0]
    valid = torch.ones((slots,), dtype=torch.int32, device=dev)
    last = torch.as_tensor(np.asarray(last0[:slots], np.int32), device=dev)
    with torch.inference_mode():
        for f in dataclasses.fields(eng.cache):
            getattr(eng.cache, f.name).copy_(getattr(cache0, f.name))
        eng._graph.load(last, valid)
        state = {"cache": clone_cache(cache0, dev), "tok": last[:, None]}

        def eager_steps(n):
            for _ in range(n):
                lg, state["cache"] = forward_cached(eng.params, state["tok"],
                                                    state["cache"], cfg, eng.impl,
                                                    valid_lengths=valid)
                state["tok"] = lg[:, -1:].argmax(-1).to(torch.int32)

        res["step"] = profile_decode.abba({"eager": eager_steps,
                                           "captured": eng._graph.run},
                                          order=order, steps=8)
        res["step_exchange_kernels"], res["step_nccl"] = exchange(res["step"])
        del state
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(22)
        toks = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen, device=dev,
                             dtype=torch.int32)
        arms, chunk, caches = profile_decode.prefill_arms(
            eng.params, cfg, eng.impl, eng._new_cache(1), toks,
            torch.tensor([256], dtype=torch.int32, device=dev), eng._pool)
        arms = {k: profile_decode.in_rows(eng._block, [256], f) for k, f in arms.items()}
        eager = arms["eager"](1).clone()
        captured = arms["captured"](1)
        torch.cuda.synchronize()
        res["chunk_bitwise"] = bool(torch.equal(eager, captured)) and all(
            torch.equal(getattr(caches[0], f.name), getattr(caches[1], f.name))
            for f in dataclasses.fields(caches[0]))
        del eager, captured
        res["chunk"] = profile_decode.abba(arms, order=order, steps=1)
        res["chunk_exchange_kernels"], res["chunk_nccl"] = exchange(res["chunk"])
        res["chunk_graph"] = {k: getattr(chunk, k) for k in (
            "warmup_s", "capture_s", "instantiate_s", "kept_bytes", "reserved_bytes")}
        chunk.release()
        del arms, chunk, caches
        torch.cuda.empty_cache()
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 512).tolist()
        res["ttft_512"] = profile_decode.first_token_times(
            {"eager": eager_eng, "captured": eng}, prompt, turns=1, order=order)
    res["seconds"] = time.perf_counter() - t0
    emit("mesh_graph", **res)
    failed = []
    if not res["step"]["captured"]["host_launch_calls_per_step"] <= MESH_LAUNCH_CALLS:
        failed.append("host launch calls a captured step")
    if not res["chunk_bitwise"]:
        failed.append("chunk_bitwise")
    if not res["ttft_512"]["tokens_equal"]:
        failed.append("ttft tokens_equal")
    if failed:
        raise AssertionError(f"mesh_graph: {failed}")


# the tensor-parallel forward at one rank: qwen2_moe bf16 at full width and
# depth on [2, 512] tokens; the captured expert- and sequence-parallel
# forwards at TP_SHARDED_LAYERS (cut for time)
TP_LAYERS, TP_TOKENS, TP_SHARDED_LAYERS = 24, (2, 512), 4
TP_ORDER = ("tp_eager", "tp_captured", "forward_logits_captured",
            "forward_logits_captured", "tp_captured", "tp_eager")
TP_STEPS = 4


def _peak_gb(fn, dev) -> dict | None:
    """What one call of ``fn`` holds on the device, in GB (None on the CPU):
    ``before``, allocated when it starts (the params, the graphs' live
    outputs and what earlier phases keep), and ``added``, its peak above
    that, its own. A replay allocates nothing: its graph's memory is its
    pool's (``graph_setup``'s ``reserved_bytes``)."""
    import torch

    if dev.type != "cuda":
        fn()
        return None
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return {"before": before / 1e9,
            "added": (torch.cuda.max_memory_allocated(dev) - before) / 1e9}


def tp_one_rank(dev) -> dict:
    """Phase 12 (a)'s tensor-parallel checks, on the phase's one-rank process
    group (NCCL on the card):

    - ``tp``: ``parallel.sharded.make_tp_forward`` on a (1, 1) ("data",
      "expert") mesh over ``shard_params``, qwen2_moe bf16 at full width and
      TP_LAYERS deep, ``MoEImpl(gmm_backend="pallas")``, tokens TP_TOKENS:
      eager, and captured by ``serving.graph.ForwardGraph`` (bitwise the
      eager logits; K11 launched by a replay, counted from 0 just before
      it); the logits bitwise ``forward_logits`` on the same card (one rank
      runs the same products in the same order, and a one-rank all-reduce
      copies); then the TP forward eager and captured and ``forward_logits``
      captured in turns (``profile_decode.abba``, TP_ORDER, TP_STEPS
      forwards a window): wall and device ms, busy share, kernels and host
      launch calls a forward, each arm's own peak GB above what it starts
      with (``_peak_gb``);
    - ``sharded`` / ``sp``: ``make_sharded_forward(quantized=True)`` over the
      first TP_SHARDED_LAYERS layers' experts in w8a8 (K1, K2) and
      ``make_sp_prefill_forward`` over the same layers in bf16 (K11), each
      captured by ``ForwardGraph``, bitwise its eager twin, its launches a
      replay.

    Prints one ``tp`` line a step and returns each kernel's launches a
    replay: {kernel: {step: count}}; raises on a failed check."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.models.model import forward_logits
    from mxmoe_tpu_torch.parallel import sharded
    from mxmoe_tpu_torch.parallel.mesh import shard_params
    from mxmoe_tpu_torch.quant.qparams import quantize_model_experts_uniform
    from mxmoe_tpu_torch.quant.schemes import parse_scheme
    from mxmoe_tpu_torch.serving import profile_decode
    from mxmoe_tpu_torch.serving.graph import ForwardGraph

    on_card = dev.type == "cuda"
    launches: dict = {}
    t0 = time.perf_counter()
    cfg, floats = _full_width_model(TP_LAYERS if on_card else 2, 23)
    impl = MoEImpl(gmm_backend="pallas")
    mesh = DeviceMesh(dev.type, [[0]], mesh_dim_names=("data", "expert"))
    local = shard_params(floats, mesh)
    fwd = sharded.make_tp_forward(cfg, mesh, impl)
    gen = torch.Generator(device=dev).manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, TP_TOKENS, generator=gen, device=dev,
                         dtype=torch.int32)

    def plain(params, tokens):
        return forward_logits(params, tokens, cfg, impl)

    def replayed(graph, what: str) -> dict:
        """One replay's launches, counted from 0 (the first run captured)."""
        graph.run(toks)
        _reset_counts()
        graph.run(toks)
        counts = _counts()
        for k, v in counts.items():
            launches.setdefault(k, {})[what] = v
        return counts

    with torch.inference_mode():
        eager = fwd(local, toks)
        ref = plain(floats, toks)
        graphs = {"tp": ForwardGraph(fwd, local, toks),
                  "forward_logits": ForwardGraph(plain, floats, toks)}
        tp_counts = replayed(graphs["tp"], "tp_captured")
        captured = graphs["tp"].logits.clone()
        res = {"model": "qwen2_moe", "layers": cfg.num_layers, "tokens": TP_TOKENS,
               "mesh": {"data": 1, "expert": 1}, "card": smi_line() if on_card else None,
               "params_gb": sum(t.numel() * t.element_size() for t in (
                   floats["embed"], floats["final_norm"], floats["lm_head"],
                   *floats["layers"].values())) / 1e9,
               "captured_bitwise_eager": bool(torch.equal(captured, eager)),
               "vs_forward_logits": {
                   "bitwise": bool(torch.equal(eager, ref)),
                   "max_abs_err": float((eager.float() - ref.float()).abs().max()),
                   "max_abs_logit": float(ref.float().abs().max())},
               "finite": bool(torch.isfinite(captured).all()),
               "launches_per_replay": tp_counts}
        del eager, ref, captured
        if on_card:
            arms = {"tp_eager": lambda: fwd(local, toks),
                    "tp_captured": lambda: graphs["tp"].run(toks),
                    "forward_logits_captured": lambda: graphs["forward_logits"].run(toks)}
            def forwards(f):
                def run(n):
                    for _ in range(n):
                        f()
                return run

            res["turns"] = profile_decode.abba({k: forwards(f) for k, f in arms.items()},
                                               order=TP_ORDER, steps=TP_STEPS)
            for arm in res["turns"].values():
                arm.pop("by_name")
            res["peak_gb"] = {k: _peak_gb(f, dev) for k, f in arms.items()}
            res["graph_setup"] = {name: {k: getattr(g, k) for k in (
                "warmup_s", "capture_s", "instantiate_s", "kept_bytes", "reserved_bytes")}
                for name, g in graphs.items()}
            cap, fl = (res["turns"][k]["device_ms"] for k in ("tp_captured",
                                                               "forward_logits_captured"))
            res["tp_captured_over_forward_logits_device_ms"] = cap / fl
        for g in graphs.values():
            g.release()
        del graphs
    res["seconds"] = time.perf_counter() - t0
    emit("tp", step="tp_forward", **res)
    failed = [k for k in ("captured_bitwise_eager", "finite") if not res[k]]
    if not res["vs_forward_logits"]["bitwise"]:
        failed.append("vs_forward_logits bitwise (one rank: the same products in "
                      "the same order)")
    if on_card and not tp_counts.get("gmm_bf16"):
        failed.append("gmm_bf16 never launched by a replay")
    if failed:
        raise AssertionError(f"tp forward: {failed}")

    # the earlier sharded forwards captured, TP_SHARDED_LAYERS deep
    cut = dataclasses.replace(cfg, num_layers=TP_SHARDED_LAYERS)
    floats = {**floats, "layers": {k: v[:TP_SHARDED_LAYERS]
                                   for k, v in floats["layers"].items()}}
    del local
    if on_card:
        torch.cuda.empty_cache()
    ep_mesh = DeviceMesh(dev.type, [0], mesh_dim_names=("expert",))
    seq_mesh = DeviceMesh(dev.type, [0], mesh_dim_names=("seq",))
    for step, expect in (("sharded", ("quantize_rows", "gmm_w8a8")), ("sp", ("gmm_bf16",))):
        t1 = time.perf_counter()
        if step == "sharded":
            params = quantize_model_experts_uniform(floats, parse_scheme("w8a8_g-1_sym"))
            params = shard_params(params, ep_mesh,
                                  sharded.ep_param_shardings(params, ep_mesh))
            fn = sharded.make_sharded_forward(cut, ep_mesh, quantized=True)
        else:
            params = floats
            fn = sharded.make_sp_prefill_forward(cut, seq_mesh, "seq", impl)
        with torch.inference_mode():
            eager = fn(params, toks)
            graph = ForwardGraph(fn, params, toks)
            counts = replayed(graph, f"{step}_captured")
            row = {"layers": cut.num_layers, "tokens": TP_TOKENS,
                   "captured_bitwise_eager": bool(torch.equal(graph.logits, eager)),
                   "launches_per_replay": counts, "seconds": time.perf_counter() - t1}
            graph.release()
        del graph, eager, params
        emit("tp", step=step, **row)
        missing = [k for k in expect if on_card and not counts.get(k)]
        if not row["captured_bitwise_eager"] or missing:
            raise AssertionError(f"tp {step}: bitwise {row['captured_bitwise_eager']}, "
                                 f"never launched {missing}")
    del floats
    if on_card:
        torch.cuda.empty_cache()
    emit("tp", step="phase", seconds=time.perf_counter() - t0)
    return launches


def ep_phase(device: str = "cuda") -> dict:
    """Phase 12: expert parallelism (module docstring). Returns each
    kernel's launches under EP: {kernel: {serve: count}}."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from mxmoe_tpu_torch.parallel.ep import EPConfig
    from mxmoe_tpu_torch.parallel.multihost import free_port, spawn
    from mxmoe_tpu_torch.parallel import scale_bench

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ep_launches: dict = {}

    def record(serve: str, launches: dict):
        for k, v in launches.items():
            ep_launches.setdefault(k, {})[serve] = v

    # (a) one rank over NCCL: qwen2_moe at full width and depth, mixed-packed
    # + int8 KV, through Engine(mesh=...), eager and captured, against the
    # one-device Engine
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    engines = []
    try:
        t0 = time.perf_counter()
        cfg, params, impl = _ep_model(24 if on_card else 2, "mixed-packed", dev)
        prompts = _ep_prompts(cfg.vocab_size)
        t1 = time.perf_counter()
        ref, eng = _engine_tokens(params, cfg, impl, prompts, True)
        one_device_s = time.perf_counter() - t1
        eng.close()
        del eng
        mesh = DeviceMesh(dev.type, [0], mesh_dim_names=("expert",))
        ep_cfg = EPConfig(capacity_factor=4.0, return_stats=True)
        serves = {}
        for arm in ("eager", "captured"):
            _reset_counts()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            snap = []
            base = torch.cuda.memory_allocated() if on_card else 0
            t1 = time.perf_counter()
            toks, eng = _engine_tokens(params, cfg, impl, prompts, True, mesh, ep_cfg,
                                       cuda_graphs=arm == "captured", snap=snap)
            engines.append(eng)
            serves[arm] = {"tokens": toks, "serve_s": time.perf_counter() - t1,
                           "launches": _counts(), "snap": snap,
                           "dropped_assignments": eng.dropped_assignments(),
                           "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                                    if on_card else None),
                           "peak_bytes_above_start": (torch.cuda.max_memory_allocated()
                                                      - base if on_card else None)}
        eager_eng, eng = engines
        got, launches = serves["captured"]["tokens"], serves["captured"]["launches"]
        rule = _margin_rule(got, ref, prompts, params, cfg, impl)
        graphs = {name: {k: getattr(g, k) for k in ("warmup_s", "capture_s",
                                                     "instantiate_s", "kept_bytes",
                                                     "reserved_bytes")}
                  for name, g in (("decode", eng._graph), ("submit", eng._slot_prefill))
                  if g is not None}
        emit("ep", step="one_rank", model="qwen2_moe", layers=cfg.num_layers,
             quant="mixed-packed", int8_kv=True, transport="nccl (direct)" if on_card
             else "gloo (direct)", ranks=1, graphs="captured", tokens=got,
             eager_mesh_tokens_bitwise=got == serves["eager"]["tokens"],
             vs_one_device=rule, one_device_serve_s=one_device_s,
             **{f"{k}{'' if arm == 'captured' else '_eager'}": v
                for arm, rec in serves.items() for k, v in rec.items()
                if k not in ("tokens", "snap", "launches")},
             eager_launches=serves["eager"]["launches"], launches=launches,
             graph_setup=graphs, seconds=time.perf_counter() - t0)
        record("one_rank_nccl_qwen2_moe_24l_mixed_packed_int8kv", launches)
        missing = [k for k in EP_ONE_RANK_EXPECT if not launches.get(k)]
        if on_card and missing:
            raise AssertionError(f"ep one rank: kernels never launched: {missing}")
        if got != serves["eager"]["tokens"]:
            raise AssertionError(f"ep one rank: the captured mesh Engine's tokens {got} "
                                 f"are not the eager one's {serves['eager']['tokens']}")
        if on_card:
            mesh_graph_checks(eng, eager_eng, serves["captured"]["snap"])
        for e in engines:
            e.close()
        engines.clear()
        del eng, eager_eng, params, serves
        # scale_bench at ep 1 (its ep >= 2 rows need more cards)
        if on_card:
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            layer_cfg = dataclasses.replace(cfg, num_layers=1)
            rows = [scale_bench.bench_ep_scaling(layer_cfg, mesh, 2048, quantized=True,
                                                 device=dev),
                    scale_bench.bench_decode_scaling(
                        dataclasses.replace(cfg, num_layers=2), mesh, 8, 256,
                        quantized=True, steps=16, device=dev)]
            emit("ep", step="scale_bench", rows=rows, card=smi_line(),
                 seconds=time.perf_counter() - t0,
                 waits_for_more_cards="the ep >= 2 rows need one card a rank: "
                                      f"this machine has {torch.cuda.device_count()}")
        # the tensor-parallel forward and the sharded forwards captured
        for k, v in tp_one_rank(dev).items():
            for step, n in v.items():
                ep_launches.setdefault(k, {})[f"one_rank_nccl_{step}"] = n
    except BaseException:
        # NCCL's communicator waits, when destroyed, for every graph that holds
        # its kernels, and the traceback may keep one alive: end here
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    gc.collect()
    dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()
        emit("ep", step="nccl_two_ranks_one_card", **nccl_two_ranks_one_card())

    # (b) two ranks on the one card over the host-staged transport
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "mxmoe_tpu_torch", "_build")
                                     if on_card else None) as out:
        spawn(_ep_two_ranks, 2, (out, dev.type), backend="gloo")
        ranks = []
        for r in (0, 1):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for name in EP_SERVES:
        if ranks[0][name]["tokens"] != ranks[1][name]["tokens"]:
            raise AssertionError(f"ep {name}: the two ranks disagree on the tokens")
        emit("ep", step="two_ranks", serve=name, quant=EP_SERVES[name][0], layers=4,
             transport=ranks[0]["transport"], ranks=2, graphs=HOST_EAGER,
             capacity_factor=ranks[0]["capacity_factor"],
             tokens=ranks[0][name]["tokens"],
             vs_one_device=ranks[0][name]["vs_one_device"],
             one_device_serve_s=ranks[0][name]["one_device_serve_s"],
             dropped_assignments=ranks[0][name]["dropped_assignments"],
             serve_s=[x[name]["seconds"] for x in ranks],
             max_memory_allocated=[x[name]["max_memory_allocated"] for x in ranks],
             launches=[x[name]["launches"] for x in ranks])
        for r, x in enumerate(ranks):
            record(f"two_ranks_host_{name}_rank{r}", x[name]["launches"])
    emit("ep", step="sp_prefill", transport=ranks[0]["transport"],
         per_rank=[x["sp_prefill"] for x in ranks],
         seconds_two_rank_job=time.perf_counter() - t0)
    emit("tp", step="two_ranks", transport=ranks[0]["transport"],
         graphs="eager: the host-staged sums copy through host memory in every layer",
         model="qwen2_moe", layers=2, dtype="float32",
         per_rank=[x["tp_forward"] for x in ranks])
    for r, x in enumerate(ranks):
        record(f"two_ranks_host_tp_forward_rank{r}", x["tp_forward"]["launches"])

    # (c) generate --mesh 2 as a user calls it, against generate on one device
    t0 = time.perf_counter()
    gen_prompt = _ep_prompts(151936)[0][:40]
    gen_args = ["--model", "qwen2_moe", "--layers", "4", "--quant", "mixed-packed",
                "--slots", "2", "--max-new", "16", "--prompt",
                " ".join(str(t) for t in gen_prompt)]
    if not on_card:
        gen_args += ["--device", "cpu"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([HERE, *filter(None, [env.get("PYTHONPATH")])])
    p = subprocess.run([sys.executable, "-m", "mxmoe_tpu_torch.serving.generate",
                        *gen_args, "--mesh", "2", "--transport", "host"],
                       capture_output=True, text=True, timeout=400, cwd=HERE, env=env)
    if p.returncode != 0:
        raise AssertionError(f"generate --mesh 2 failed ({p.returncode}):\n"
                             f"{p.stderr[-3000:]}")
    line = next(l for l in p.stdout.splitlines() if l.startswith("output tokens"))
    mesh_toks = json.loads(line.split(":", 1)[1])
    from mxmoe_tpu_torch.serving import generate

    with contextlib.redirect_stdout(io.StringIO()):
        one = generate.main(gen_args)
    rule = {"equal": True, "parted": []}
    if mesh_toks != one:
        cfg, params, impl = _ep_model(4, "mixed-packed", dev)
        rule = _margin_rule([mesh_toks], [one], [gen_prompt], params, cfg, impl)
    emit("ep", step="generate_mesh", args=gen_args + ["--mesh", "2", "--transport", "host"],
         graphs=HOST_EAGER,
         tokens=mesh_toks, one_device=one, vs_one_device=rule,
         summary=[l for l in p.stdout.splitlines() if "ranks" in l],
         seconds=time.perf_counter() - t0)
    emit("ep", step="phase", seconds=time.perf_counter() - t_phase)
    return ep_launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "mxmoe_tpu_torch")):
        print("chip_smoke.py: mxmoe_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    t_smoke = time.perf_counter()
    smi = probe()
    build()
    rec = kernels_vs_plain()
    from mxmoe_tpu_torch.bench import timing
    emit("timing", device_ms_lost_traces=timing.LOST_TRACES[0], **profiler_after_backward())
    fused, aligned = {"fused_ffn": True}, {"dispatch_align": 32}
    for quant, int8_kv, pack, impl_kw in (("w8a8_g-1_sym", False, False, None),
                                          ("mixed-packed", True, False, None),
                                          ("w4a16_g128_asym", False, True, None),
                                          ("flex-shared-grouped", False, False, None),
                                          ("flex-wo", False, False, None),
                                          ("flex-packed", False, False, None),
                                          ("bf16-k11", False, False, None),
                                          ("mixed-packed", True, False, fused),
                                          ("w8a8_g-1_sym", False, False, fused),
                                          ("w8a8_g-1_sym", False, False, aligned)):
        torch.cuda.empty_cache()
        slice_parity(quant, int8_kv, pack, impl_kw)
    # ds2 at full width, its dense first layer and two MoE layers (MLA over
    # the 256-lane K cache: K3q at dk 256, G 1)
    torch.cuda.empty_cache()
    slice_parity("mixed-packed", True, model="ds2", layers=3)
    for model, layers in (("qwen2_moe", 2), ("ds2", 3)):
        torch.cuda.empty_cache()
        forward_logits_vs_prefill(model, layers)
    torch.cuda.empty_cache()
    storage_forms_bitwise()
    torch.cuda.empty_cache()
    storage_forms_bitwise("flex", "flex-packed")
    torch.cuda.empty_cache()
    storage_forms_bitwise("mixed", "mixed-packed", fused)
    torch.cuda.empty_cache()
    float_arms_agree()
    k1, k3, k3q = ("quantize_rows", "decode_attention_update_stacked",
                   "decode_attention_update_stacked_q8")
    k4f, k10, k11 = "gmm_mixed_packed_flex", "gmm_mixed_wo_wxa", "gmm_bf16"
    k12, k13 = "gmm_ffn_w8a8", "gmm_ffn_mixed_packed"
    # name -> (layers, quant, int8 KV, packed, int8 head, kernels that must
    # launch[, MoEImpl fields[, kernels that must not[, model]]]); a kernel's
    # launches in the last line are those of the serve that `counts` below
    # names for it
    serves = {
        "uniform": (4, "w8a8_g-1_sym", False, False, False, (k1, "gmm_w8a8", k3)),
        "packed_w4": (4, "w4a8_g-1_sym", False, True, False,
                      (k1, "gmm_w4a8_packed", k3)),
        "mixed": (4, "mixed-packed", True, False, False,
                  (k1, "gmm_w8a8", k3q, "gmm_mixed_packed")),
        "a16_packed": (4, "w4a16_g128_asym", False, True, False,
                       ("gmm_weight_only_packed", k3)),
        "grouped": (4, "w4a4_g128_sym", False, False, False,
                    ("gmm_w8a8_grouped", k3)),
        "asym": (4, "w8a8_g-1_asym", False, False, False, (k1, "gmm_w8a8_asym", k3)),
        "a16": (4, "w4a16_g-1_sym", False, False, False, ("gmm_weight_only", k3)),
        "flex": (4, "flex-shared-grouped", False, False, False,
                 ("gmm_w8a8_grouped", k3)),
        "flex_a16": (4, "flex-shared-a16", False, False, False,
                     ("gmm_w8a8_grouped", "gmm_weight_only", k3)),
        # the two-launch branches (4 layers; the 24-layer serve is the fused one)
        "flex_wo": (4, "flex-wo", False, False, False, (k1, "gmm_w8a8", k10, k3)),
        "flex_packed": (4, "flex-packed", True, False, False,
                        (k1, "gmm_w8a8", k4f, k3q)),
        "mixed_wo": (4, "mixed-wo", False, False, False, (k1, k10, k3)),
        "bf16_k11": (4, "bf16-k11", False, False, False, (k11, k3)),
        "bf16_stock": (4, "none", False, False, False, (k3,)),
        "int8_head": (4, "w8a8_g-1_sym", False, False, True, (k1, "gmm_w8a8", k3)),
        # the whole expert FFN in one launch: the full 24 layers for K13
        "mixed_fused": (24, "mixed-packed", True, False, False,
                        (k13, k1, "gmm_w8a8", k3q), fused, ("gmm_mixed_packed",)),
        "uniform_fused": (4, "w8a8_g-1_sym", False, False, False, (k12, k1, k3),
                          fused, ("gmm_w8a8",)),
        "uniform_auto": (4, "w8a8_g-1_sym", False, False, False, (k12, k1, k3),
                         {"fused_ffn": "auto"}, ("gmm_w8a8",)),
        "uniform_aligned": (4, "w8a8_g-1_sym", False, False, False,
                            (k1, "gmm_w8a8", k3), aligned, (k12,)),
        "flex_fused": (4, "flex", False, False, False, ("gmm_w8a8_grouped", k3),
                       fused, (k12, k13)),
        # the plain decode attention (scatter + attention): no K3
        "uniform_xla": (4, "w8a8_g-1_sym", False, False, False, (k1, "gmm_w8a8"),
                        {"decode_attn": "xla"}, (k3, k3q)),
        # ds2 at the full 27 layers (1 dense + 26 MoE): MLA through K3q at dk
        # 256, mixed-packed routed experts, w8a8 shared experts, the int8 head
        "ds2": (27, "mixed-packed", True, False, True,
                (k3q, k1, "gmm_mixed_packed", "gmm_w8a8"), None, (k3,), "ds2"),
        # GQA at G 4 / 7, full width and full depth (mixtral 32 layers, no
        # shared expert; qwen2_moe_57b 28 layers, its experts quantized one
        # slice of experts at a time)
        "mixtral": (32, "w8a8_g-1_sym", False, False, False, (k1, "gmm_w8a8", k3),
                    None, (), "mixtral"),
        "qwen2_57b": (28, "w8a8_g-1_sym", False, False, False, (k1, "gmm_w8a8", k3),
                      None, (), "qwen2_moe_57b"),
        # the whole expert FFN at qwen2_moe_57b's widths (N 2560: the 16-CTA
        # cluster), 4 layers
        "qwen2_57b_fused": (4, "w8a8_g-1_sym", False, False, False, (k12, k1, k3),
                            fused, ("gmm_w8a8",), "qwen2_moe_57b"),
    }
    # the graph phase's checks, on the serves that run them (graph_checks)
    graph = {"uniform": ("eager", "sync_debug", "sampled"),
             "mixed_fused": ("eager", "abba", "prefill", "ttft"),
             "ds2": ("eager", "prefill"),
             "a16_packed": ("prefill",),
             "flex_packed": ("eager",), "uniform_xla": ("eager", "sync_debug"),
             "int8_head": ("eager",)}
    ran = {}
    for name, (layers, quant, int8_kv, pack, head, expect, *extra) in serves.items():
        torch.cuda.empty_cache()
        impl_kw, absent, model = (*extra, *SERVE_DEFAULTS[len(extra):])
        ran[name] = serve(layers, quant, int8_kv, expect, pack, head, impl_kw, absent,
                          model, name, graph.get(name, ()))
    # the flex serves go through K8 only: no K1, K2 or K9 for the routed
    # experts, and the grouped shared expert adds two K8 launches a layer
    if ran["flex"]["gmm_w8a8_grouped"] != 2 * ran["grouped"]["gmm_w8a8_grouped"]:
        raise AssertionError("the grouped shared expert did not go through K8: "
                             f"{ran['flex']} against {ran['grouped']}")
    # the stock arm of the float path launches no kernel of K11's, the int8
    # head one more K1 and K2 a forward than the float head
    if ran["bf16_stock"][k11] or not (ran["int8_head"]["gmm_w8a8"]
                                      > ran["uniform"]["gmm_w8a8"]):
        raise AssertionError(f"unexpected launches: stock float arm "
                             f"{ran['bf16_stock']}, int8 head {ran['int8_head']}")
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "mixed-packed", "--int8-kv"],
                      (k1, "gmm_w8a8", "gmm_mixed_packed", k3q))
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "w4a16_g128_asym"], ("gmm_weight_only", k3))
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "none"], (k3,))
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "w8a8_g-1_sym", "--int8-head"],
                      (k1, "gmm_w8a8", k3))
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "mixed-packed", "--int8-kv", "--fused-ffn", "on"],
                      (k13, k1, "gmm_w8a8", k3q))
    for attn, expect, absent in (("auto", (k3q,), ()), ("xla", (), (k3q, k3))):
        torch.cuda.empty_cache()
        bench_entry_point(["--model", "ds2", "--quant", "mixed-packed", "--int8-kv",
                           "--decode-attn", attn],
                          (k1, "gmm_w8a8", "gmm_mixed_packed", *expect), absent)
    torch.cuda.empty_cache()
    ws_launches = headline_bench()
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    build_dir = os.path.join(HERE, "mxmoe_tpu_torch", "_build")
    ckpt_root = tempfile.mkdtemp(prefix="ckpt-", dir=build_dir)
    try:
        ckpt = offline_checkpoint(ckpt_root)
        offline = offline_phase(ckpt)
        torch.cuda.empty_cache()
        solved = {"dir": ckpt_root}
        solve = solve_phase(ckpt, keep=solved)
        torch.cuda.empty_cache()
        evals = eval_phase(ckpt, solved["qconfig"], solved["expect"])
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    ep = ep_phase()
    # one path per number: a kernel's launches are those of the full-depth
    # serve that runs it, else of the 4-layer serve that does
    counts = {"ds2": (k3q, k1, "gmm_w8a8", "gmm_mixed_packed"), "mixed_fused": (k13,),
              "uniform": (k3,), "flex_wo": (k10,), "flex_packed": (k4f,),
              "packed_w4": ("gmm_w4a8_packed",), "a16_packed": ("gmm_weight_only_packed",),
              "grouped": ("gmm_w8a8_grouped",), "asym": ("gmm_w8a8_asym",),
              "a16": ("gmm_weight_only",), "bf16_k11": (k11,), "uniform_fused": (k12,)}
    launches = {}
    for name, kernel_names in counts.items():
        layers, quant, int8_kv, pack, head, _, *extra = serves[name]
        impl_kw, _, model = (*extra, *SERVE_DEFAULTS[len(extra):])
        label = (f"serve {model} {quant}{' packed' if pack else ''}"
                 f"{' int8-kv' if int8_kv else ''}{' int8-head' if head else ''}"
                 f"{' fused' if impl_kw else ''} {layers} layers")
        for kn in kernel_names:
            launches[kn] = (ran[name][kn], label)
    for name in ("gmm_w8a8_fusedquant", *READ_ONLY_ATTENTION):
        launches[name] = (0, "kernels phase only: no serve reaches it in either "
                             "package")
    launches["gmm_ws"] = (ws_launches, "headline bench, mixed one-launch arm")
    emit("smoke", card=smi, seconds=time.perf_counter() - t_smoke,
         device_ms_lost_traces=timing.LOST_TRACES[0])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name][0], "launches_of": launches[name][1],
         "max_abs_err": rec[name]["max_abs_err"],
         "ms": rec[name]["ms"], "device_ms": rec[name]["device_ms"],
         "plain_ms": rec[name]["plain_ms"],
         "bound_ms": rec[name]["bound_ms"], "bound_by": rec[name]["bound_by"],
         "library_ms": rec[name].get("library_ms"),
         "library_device_ms": rec[name].get("library_device_ms"),
         "offline_launches": {art: n[name] for art, n in offline.items() if n.get(name)},
         "solve_launches": {st: n[name] for st, n in solve.items() if n.get(name)},
         "eval_launches": {st: n[name] for st, n in evals.items() if n.get(name)},
         "ep_launches": ep.get(name, {}),
         **({"schedule": rec[name]["schedule"]} if "schedule" in rec[name] else {}),
         **{key: rec[name][key] for key in ("body", "prefill", "large", "anchor_decode",
                                            "wide")
            if key in rec[name]}}
        for name, (src, rep) in KERNEL_SOURCES.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
