"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit. Phases, each printing one JSON line (the serving phases, the
training phases, then beams, speculative decoding and LoRA):

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: compiles every kernel under containerpilot_tpu_torch/csrc/
   (one nvcc per source, all at once) and prints the seconds;
3. kernels: each hand-written kernel against its plain torch version on
   the card, in bf16, at the shapes the serving and training paths give
   it, with its time, the plain version's, one PyTorch call computing
   the same function (the yardstick; never used by the port) and the
   least time the card could take (bytes at 3.35 TB/s or operations at
   989 TFLOP/s, whichever is larger). K1 (flash forward) is timed
   against SDPA's forward; K3 (flash dq) and K4 (flash dk/dv) share one
   yardstick: SDPA forward+backward minus SDPA forward; K2 (int8 GEMM)
   is held at a decode layer's three projection shapes for row counts
   covering every one of its instantiations, and timed against
   torch.matmul on bf16 weights. Every kernel is also launched twice on
   the same inputs and must give the same bits; the flash kernels report
   their TFLOP/s (kept pairs' FLOPs over kernel time). The windowed
   cases (K1 at the windowed prefill and training shapes, K3/K4 at the
   windowed training shape) are timed against SDPA with an explicit
   window mask, which is not a flash path. K1 is also held at 128
   tokens (a whole and a tp2 rank's heads) and K3/K4 at a 128-token
   row: lengths the H100 table's crossover sends to the kernels;
4. serve_bf16: the 1.2B flagship config (vocab 32768, d_model 2048, 16
   heads, 16 layers, d_ff 8192, max_len 2048), seeded random weights,
   served by the port's InferenceServer over HTTP on 127.0.0.1:0: health,
   greedy 1024-token prompts (the flash kernel's path), a repeat, a
   4-row batch, an 8-row batch (decode tokens/s at 8 rows), a seeded
   sampled request, /v1/model; the flash kernel's launch count is zeroed
   just before and read just after; the logits through the kernel are
   held against the plain attention path;
5. serve_slots_bf16: the same model served with --slots 8 --slot-chunk 8
   --slot-window 4 --prefix-cache 4: graphs captured before /health, 8
   staggered concurrent single-row requests (two 1024-token prompts
   admitted through the flash kernel, short ones, one sampled) and a
   prefix hit (a 1024-token prompt plus 16 tokens), each held against
   solo decoding teacher-forced on the served tokens (at every position
   the solo's choice or a near tie within NEAR_TIE_TOL; where the output
   differs from solo generate, the first differing position with the
   logits' relative error there within E2E_REL_TOL); the same requests
   through a window-1 engine must give the same bits; decode tokens/s
   at 8 concurrent requests beside the batcher's 8-row figure,
   dispatches/token; steady windows dispatched under
   torch.cuda.set_sync_debug_mode("error"); the K1/K2 counts (graph
   replays included) zeroed before the requests and read after;
6. serve_window: the bf16 flagship's first CUT_LAYERS (8) layers with
   --window 1024 at max_len 4096 (cut from 16 for the script's clock),
   served by the Batcher over HTTP, once with the ring alone and once
   with --kv-int8: a greedy 3072-token prompt (windowed K1; the ring
   wraps during prefill) with 64 new tokens, a 4-row batch of 1024-token
   prompts, and a logprobs request whose echo must equal /v1/score on
   the same sequence to 1e-5. The greedy request's logits, teacher-forced
   through the served path, are held against one plain windowed forward
   (flash_min_seq=0, no cache) over prompt + served tokens: the ring
   alone within E2E_REL_TOL, with --kv-int8 within NEAR_TIE_TOL (its
   quantization error). Also the row cache's bytes against a linear
   bf16 cache at max_len;
7. serve_int8: the same model after quantize_model_params, the int8
   kernel's count zeroed before and read after; its decode logits at
   batch 1 and at batch 8 (with a 16-token decode chunk, 128 rows) are
   held against the same model decoded on the CPU (the plain versions);
8. serve_slots_int8: phase 5 on the int8 model with --prefill-chunk 256:
   K2 runs the decode replays at m = 8 and the chunked admission's
   16- and 256-row pieces;
9. serve_slots_window_int8: the int8 flagship's first CUT_LAYERS layers
   with --window 1024
   --kv-int8 --slots 8 --slot-chunk 8 --slot-window 4 --prefill-chunk
   256 at max_len 4096 (constructing it with --prefix-cache must
   raise): 8 staggered concurrent requests (the 3072-token prompt, a
   1000-token prompt whose decode crosses the ring, short ones, one
   sampled, one streamed over SSE), each judged against solo decoding
   under the same config; the streamed deltas equal the same request
   not streamed; a second stream dropped after its first event frees
   its slot within a few windows; steady windows free of host syncs,
   with device ms a step and the idle share under the profiler; one
   graph replay at the slots' positions bit-equal to the eager round;
   and the same steady windows with the ring alone (kv_int8 off);
10. train: the repo's training configuration (bench.py:121-133: vocab
   32768, d_model 1024, 8 heads, 8 layers, d_ff 4096, seq 2048, batch 8,
   flash crossover AUTO, remat "full"), seeded random masters, through
   make_train_step: 2 warm steps, then 5 timed steps on one seeded batch
   (step ms, tokens/s, MFU against 989 TFLOP/s); the K1/K3/K4 launch
   counts are zeroed just before and read just after, and the loss must
   fall; one loss_fn value+grad through the kernels is held against
   plain attention (flash_min_seq=0) at batch 2, and against itself
   under remat "dots" and with the chunked loss; _dot_f32's gradient
   against the float32 product's;
11. train_window: the same configuration with window 1024 (K1, K3 and
   K4 windowed): 2 warm and 3 timed steps, the launch counts around
   them, the loss falls, and one loss value+grad at batch 2 against
   plain windowed attention;
12. train_cli: ``python -m containerpilot_tpu_torch.workload.train
   --device cuda`` at d_model 1024, 2 layers, seq 1024, with
   --ema-decay 0.99, SIGTERM after step 3 (exit 0, "checkpoint saved at
   step N"), then a restart that resumes at step N and finishes; and
   token-shard batches staged on the card by the data prefetcher equal
   the dataset's;
13. serve_ckpt: ``python -m containerpilot_tpu_torch.workload.serve
   --checkpoint-dir`` on that checkpoint, once with the raw params and
   once with --use-ema: a greedy request's tokens equal an in-process
   generate on restore_params(prefer_ema=...);
14. serve_beam: the flagship's width at CUT_LAYERS layers (seeded), bf16 and
   then int8, served with --draft-layers 4 --speculate 4 (beams route
   first): beam_width 4 on the 1024-token prompt with 32 new tokens (K1
   in the prefill, K2 at m = 4 under int8), twice and against one new
   token (beam step ms), the same search in-process, whose score must
   match /v1/score's teacher-forced sum over its tokens within
   BEAM_SCORE_REL_TOL, and beam_width 1 judged against solo greedy
   (judge_served); the bf16 run also times one beam reorder of the
   4-row cache; K1/K2 counts (K2 by row count) around the requests;
15. serve_speculative: the same servers, a greedy 64-token request on
   the 1024-token prompt through the speculative engine, judged against
   solo decoding and compared with the same server's plain greedy
   request (min_new_tokens 1 routes it to the Batcher): rounds, accepted
   drafts a round, tokens/s of both, /v1/model's speculative entry, K1
   in the target and draft prefills, K2 at m = 1 (draft steps) and
   m = k+1 (verify chunks) under int8; then, in-process, 16 tokens with
   the target as its own draft, whose rounds must accept drafts (the
   accept-and-rewind path), judged the same way;
16. train_lora: the training configuration with rank-16 LoRA adapters
   on wq and wv over a frozen base (make_lora_train_step): with B = 0
   the loss equals the base model's bit for bit; 2 warm and 3 timed
   steps (step ms, tokens/s, MFU with the frozen base billed 4 FLOPs a
   parameter) with the K1/K3/K4 counts around them; the loss falls and
   the base keeps its bits; one adapter gradient at batch 2 against
   plain attention within phase 10's bounds;
17. serve_lora: the train CLI fine-tunes rank-16 adapters on phase 12's
   checkpoint (--base-checkpoint-dir), the serve CLI merges them
   (--lora-dir, in bf16 and with --int8: merged, then quantized) and
   its greedy tokens equal an in-process generate on the same params;
   the evaluate CLI's --lora-dir loss equals the in-process one;
18. serve_fleet_face: the serve CLI (serve_cli.main, its K1/K2 counters
   zeroed and read through signals) at the flagship's width and
   CUT_LAYERS of its depth, d_ff 6144 as the CLI derives it, with --slots 8 --text --mux, bf16
   and then --int8: 8 concurrent /v1/completions (a 1023-byte prompt, so
   K1 runs at admission; six short; one streamed) as streams on ONE
   cp-mux/1 connection of the port's MuxConnection and over HTTP/1.1, in
   turns (mux, HTTP/1.1, HTTP/1.1, mux), each with an X-CP-Trace id; every completion equals /v1/generate
   greedy on the encoded ids or passes judge_served, its text is the
   decoded tokens and a stream's text concatenates to it; /metrics counts
   exactly the requests sent by endpoint and code, the ledger's stages
   sum to its uptime within LEDGER_REL_TOL, /v1/goodput's dispatches and
   tokens equal the engine's, /v1/traces holds every id sent with its
   slot_queue_wait, prefill and decode spans; the wall per request over
   each transport, the /metrics scrape ms, the slot step with and
   without the device-time ledger (in-process, in turns), and K2 against
   its plain version at the CLI model's MLP shapes;
19. serve_fleet_handoff: three serve CLIs at the same width and depth
   (FACE_MODEL),
   --int8 --slots 8 --prefix-cache 4 --kv-spill-mb 1024 --mux, in one
   file catalog: A --role prefill, B --role decode, C --standby
   --weights-from A. The catalog shows A's and B's roles (the port's
   notes parser); /v1/prefill of a 1024-id prompt on A launches K1
   exactly n_layers times; B pulls the entry (/v1/kv/pull) and serves
   it greedily with K1 0 times, readmitted +1 and A's tokens (or, past a
   near tie, both held by judge_served); B's time to first token on a
   pulled entry against a local prefill; C's weights equal A's chunk
   digest by chunk digest, and once promoted C serves A's tokens;
   SIGTERM drains B, whose sessions migrate to C (a drain skips the
   prefill pool), its refusal names C in X-CP-Migrated-To, and C then
   serves the first prompt with K1 0 times and readmitted +1; C adopts
   A's kernel build directory from its cc= note. The port's gateway
   (``python -m containerpilot_tpu_torch.fleet --catalog
   file:<handoff_catalog>``, started beside A and B) fronts them: (a) a
   greedy 1024-id /v1/generate through it takes the disaggregated path
   (A launches K1 n_layers times for the gateway's /v1/prefill, B 0
   times and K2 in its 8-slot pool; the tokens A's, or held by
   judge_served past a near tie; one handoff of the entry's bytes on
   its counters); (b) its /fleet shows A prefill, B decode, C standby,
   then C active once promoted; (c) session-pinned requests through it
   see no 5xx while B drains, its migrated-session count equals the
   entries B moved, each drain answer is a retry, and the first
   prompt's session lands on C with K1 0 times; (d) its /metrics parses
   and carries the reference gateway's families; (e) it holds none of
   the card's device files, and exits 0 on SIGTERM. The KV entry's and
   the weights' bytes, seconds and GB/s, the promote latency, the
   gateway's wall against the direct path, and each replica's K1/K2
   launches;
20. moe_expert_half: one layer's feed-forward half (norm, route,
   experts, residual) at the flagship's widths with 4 and 8 experts: at
   a 1024-token prefill against its operations bound (the drop-free
   layer's dense dispatch runs every expert over every token; the top-1
   work beside it), at an 8-row decode against its bytes bound (every
   expert's weights), the int8 layer dequantized per call at the decode
   shape, and the dense SwiGLU half beside each;
21. serve_moe: the flagship's width with 8 switch-routed experts in
   place of its SwiGLU at 8 of its 16 layers (seeded; the full depth,
   4.70 B parameters, cut for the script's clock), served by the
   Batcher over HTTP as in phase 4, in bf16 and then with int8 weights:
   K1 exactly n_layers times a 1024-token prefill, K2 never (an int8 MoE layer
   dequantizes in full); the greedy request judged against the plain
   attention path (flash_min_seq=0) teacher-forced on its tokens, and
   the prompt's logits through K1 against one plain forward whose
   top-1 routes are pinned to the kernel forward's (every route it
   would have taken otherwise a near tie on the router logits); prefill
   ms, decode tokens/s at 1 and 8 rows, resident and peak bytes;
22. serve_slots_moe: the bf16 MoE flagship through the slot engine as
   in phase 5 (two 1024-token admissions launch K1; every request
   judged against solo decoding, the diagnostic's pool steps on the
   solo steps' routes; window 4 bit-equal to window 1; steady
   windows sync-free, with device ms a step and the idle share under
   the profiler; one graph replay bit-equal to the eager round);
23. train_moe: the training configuration with 8 experts through
   make_train_step, drop-free and with capacity factor 1.25: K1/K3/K4
   counted, the loss falls, one loss value+grad at batch 2 against
   plain attention on the kernel run's routes (a free plain run's
   route flips and its distance reported beside); step ms, tokens/s,
   MFU (top-1 expert work billed, as workload/flops.py does), peak
   memory;
24. train_parallel: K1, K3 and K4 at a rank's shard of the training
   shape (b=4, h=4: dp 2 x tp 2) against their plain versions, twice for
   bit equality, with SDPA beside them; then the training configuration
   (full width, an eighth of its depth: PARALLEL_CFG's 2 layers, batch
   8 x 2048)
   across ranks, each layout a
   world of child processes
   (``python3 chip_smoke.py --rank-job SPEC RANK``) on this one card,
   joined with initialize_from_env over gloo (collectives staged through
   host buffers): dp2 --zero1, dp2 --fsdp, tp2, dp2 x tp2, pp2 x tp2
   with 4 microbatches, 8 experts with ep2 on model, drop-free and at
   capacity 1.25, and sp2 x tp2 (data 1 x seq 2 x model 2: the
   context-parallel step, the ring in place of K1/K3/K4). Each starts from the seed-0 masters and one batch
   also run by one rank in this process: the loss within
   TRAIN_LOSS_REL_TOL and every gathered gradient leaf within
   TRAIN_GRAD_REL_TOL (MoE on this process's routes, every flip a near
   tie); K1/K3/K4 counted a rank a step (2 / 1 / 1 per local layer and
   microbatch, 0 under a seq axis); ZeRO-1's moments and FSDP's params and moments at 1/dp
   of one rank's bytes; step ms, bytes staged through the host and peak
   memory per rank (ranks share the card: no step time is a speed
   figure). Beside them the train CLI as 4 ranks through
   initialize_from_catalog on a file catalog with --pipeline-stages 2
   --tensor-parallel 2: the mesh line {'data': 1, 'pipe': 2, 'model': 2}
   and a falling loss (the two worlds and the CLI, two at a time);
25. serve_parallel: K1 at a tp2 rank's 1024-token prefill (b=1, h=8)
   and K2 at a tp2 rank's CLI projections (2048x1024, 1024x2048,
   2048x3072, 3072x2048 at m = 1 and 8) against their plain versions,
   twice for bit equality, with SDPA / torch.matmul beside them; then the
   serve CLI at the flagship CLI's width and a quarter of its depth
   (PAR_MODEL, 4 layers) over ranks on this
   one card (the front spawns its followers; gloo, collectives staged
   through host buffers, the slot engine's round uncaptured): --tp 2
   --slots 8 (a 1024-id greedy prompt, then 8 concurrent short requests
   of 15 new tokens, one sampled); the composed pod P (``--tp 2 --int8
   --slots 8 --prefix-cache 4 --kv-spill-mb 64 --draft-layers 2
   --standby --weights-from E --fleet-catalog``) beside the one-rank E
   it fetches its weights from (drive_composed_pod: promotion, the
   1024-id request and the 8 concurrent ones, all sampled, each with a
   seed of its own, so the int8 pool decodes the shorts together and K2
   a pool step is read over the rows live, a beam of width 2
   and a speculative row on 1024-id prompts, a prefix hit, KV pulled out
   of P by E and into P from E, /v1/weights against E's, a drain
   migrating P's sessions to E; K1/K2 a rank by path, every rank's
   prefix-cache keys equal); and --tp 2 --cp 2 --cp-min-len 1024 --slots
   8 (a 1536-id and a 1031-id prompt, each ringed, the second with a
   1-token remainder, one short prompt, then a beam of width 2 on the
   model axis), these two at once after P. Every request judged against the one-rank model
   (judge_served; beams judge_beam), every rank's tokens equal (the
   lockstep's digests),
   /v1/model's mesh, cp and step-program mode, K1 exactly n_layers times
   a rank for the 1024-id tp prefill and never for a ringed head, K2 on
   every rank's blocks under --int8 (each rank's counters zeroed just
   before the requests and read just after); wall ms a request, the
   ranks' start-up seconds, bytes staged through the host a token;
26. train_resume: the train CLI at PARALLEL_CLI's width and depth
   (RESUME_MODEL) as 4 ranks on the reference's mesh, data 1 x model 4
   (``python3 chip_smoke.py
   --train-rank LOG [--kill-after N] -- ARGS`` children logging every
   step's loss and K1/K3/K4 launches) through a file catalog, with
   --checkpoint-every 2: an uninterrupted 6-step run with --eval-every 3
   on token shards of the port's own source text (every rank the same
   losses and eval_loss); beside it the same run with rank 1 SIGKILLed
   after step 5 (every peer exits non-zero by itself), relaunched: it resumes at
   step 4 and its losses equal the uninterrupted run's within
   RESUME_REL_TOL, the two step-6 checkpoints compared leaf by leaf;
   the step-6 checkpoint restored in this process (one rank), one more
   step within RESUME_ONE_RANK_TOL of the 4-rank continuation, and
   served by the serve CLI (serve_checkpoint); --lora-rank 16 on 2
   ranks (model 2) within RESUME_ONE_RANK_TOL of one rank here; K1/K3/K4
   4 / 2 / 2 a rank a step (2 layers), as the ranks logged them;
   start-up, save (gather, write) and restore seconds, the bytes on
   rank 0's host;
27. serve_pod (run beside train_resume): the pod server (python -m
   containerpilot_tpu_torch.workload.serve_dist) as 2 ranks on this card
   (COUNTED_POD children; gloo, tp2, the slot round uncaptured) on a
   file catalog, the serve CLI flagship's width at 8 layers (POD_MODEL)
   with --slots 8 --int8 --prefix-cache 4 --watchdog 120: a 1024-id
   greedy prompt, 8 concurrent 15-token requests (one sampled),
   /v1/score, a beam of width 2, an SSE stream and a prefix hit, each
   rank's counters zeroed just before; then SIGTERM to the frontend.
   Every rank exits 0; K1 8 times and K2 on every rank's blocks, as the
   ranks log them; the ranks' token digests agree; no capture, build or
   load after warm-up; every answer judged against the one-rank model
   (judge_served), the score within E2E_REL_TOL of the one-rank
   scorer on the plain attention (flash_min_seq 0); rank start-up and
   warm-up seconds, wall ms a request, bytes staged a token, the step
   program's mode. K1's count a rank comes from the flash crossover in
   force (``k1_forwards``): the long prompt's prefill, and /v1/score's
   forward (63 ids padded to 128) where the H100 table puts 128 at or
   above the crossover;
28. autotune (after the kernel checks): ``ops/autotune.measure`` at two
   sequence lengths with K1, K3 and K4 on the card, its table in the
   reference's schema, and the committed
   ``ops/tuned/<card>.json`` found by discovery, with
   ``resolve_min_seq(AUTO, kind)`` answering its crossovers;
29. supervised_serve (run beside train_resume and serve_pod, all three
   mostly waiting on processes of their own): ``python -m
   containerpilot_tpu_torch
   -config containerpilot_tpu_torch/examples/serving-pod.json5`` on the
   port's own ``-catalog-server``, serving the flagship config (d_ff
   8192) through the serve CLI (its counters read through the CLI's
   signals, as COUNTED_SERVE does): the job passes in the catalog; a
   greedy 1024-token request launches K1 n_layers times and its tokens
   equal an in-process generate on the same seeded params; while the
   job serves, it holds the card's /dev/nvidia* device files and the
   supervisor and the catalog server hold none and have no compute
   context in nvidia-smi (neither initialized CUDA); /metrics
   and /status answer on the supervisor's telemetry port; -putmetric,
   -putenv (MAX_BATCH_ROWS, which the -reload's new generation serves
   with), -maintenance enable (the catalog drops the job) and -reload
   (a new job, healthy again); SIGTERM runs the stopping and stopped
   hooks, the supervisor exits 0, and no pid of either job holds the
   card;
30. chaos_promoted (alone, after serve_fleet_handoff):
   ``python -m containerpilot_tpu_torch.chaos --scenario
   kill_under_burst_promoted --device cuda``, the port's harness with
   its gateway and replicas (the harness's tiny float32 model, seeded
   torch generator) in that process, the replicas on the card: the CLI
   exits 0 and every check of the report passes, with the slow boot
   armed once, at least one standby promotion and no client-visible
   5xx; its goodput fraction, TTFT p99 and promotions print on a line
   of their own;
31. lint (started right after phase 1, in a thread beside the kernel
   phases, joined before the summary): the port's lint gate, ``python
   -m containerpilot_tpu_torch.analysis`` (byte-compile, the cpcheck
   and call-graph rules over the port's source against
   ``containerpilot_tpu_torch/analysis/baseline.json``), as a
   subprocess: it must exit 0 and print its clean verdict; its exit
   code, seconds, findings and baselined entries.

Then the kernel summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without CUDA, or without the package beside this file, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak

FLAGSHIP = dict(vocab_size=32768, d_model=2048, n_heads=16, n_layers=16,
                d_ff=8192, max_seq_len=2048)
MAX_LEN = 2048
PROMPT_LEN = 1024
SAMPLED_LEN = 64  # drive_server's sampled prompt, run twice
# the flagship's width at half its depth, for the script's clock: the
# windowed, beam/speculative, serve CLI (face, handoff) and MoE phases
CUT_LAYERS = 8
FLASH_TOL = 2e-2      # abs, bf16 outputs of magnitude <~4 (one bf16 step)
INT8_REL_TOL = 1e-2   # abs err / max|ref|: ~two bf16 rounding steps
E2E_REL_TOL = 5e-2    # logits, kernel path vs plain path, 16 bf16 layers
# a served token vs the solo's choice at the same position: two logits,
# each within E2E_REL_TOL of max|logits| of the solo's
NEAR_TIE_TOL = 2 * E2E_REL_TOL
# K3/K4 vs their plain version, abs err / max|ref|: both accumulate in
# float32 and round once to bf16, so at most a rounding step (2^-8
# relative) at the largest gradient
FLASH_BWD_REL_TOL = 1e-2
# training through the kernels vs plain attention (the bounds of
# test_training_through_auto_flash_matches_causal)
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
DOT_GRAD_REL_TOL = 1e-2  # _dot_f32's bf16 backward vs the float32 product
# remat "dots" vs "full", loss and worst grad leaf: the same arithmetic,
# only the saved tensors differ
REMAT_REL_TOL = 1e-3
# the chunked loss vs the whole-logits loss: the bf16 unembed's gradient
# is summed over the chunks in bf16 (as the reference's scan sums it), a
# rounding step (2^-8) per chunk, where the whole loss has one GEMM
CHUNKED_REL_TOL = 2e-2

TRAIN_CFG = dict(vocab_size=32_768, d_model=1024, n_heads=8, n_layers=8,
                 d_ff=4096, max_seq_len=2048, flash_min_seq=-1, remat="full")
TRAIN_BATCH, TRAIN_SEQ = 8, 2048

# K1 shapes (b, s, h, kv_heads, hd, window); the first is the serving
# path's, TRAIN_FWD_CASE the training path's
FWD_CASES = [
    (1, 1024, 16, 16, 128, 0),    # the serving path's prefill
    (4, 1024, 16, 16, 128, 0),    # the 4-row batch
    (1, 1024, 16, 4, 128, 0),     # GQA
    (1, 1024, 16, 16, 128, 256),  # sliding window
    (1, 1024, 16, 16, 128, 64),   # rows fully masked in a visited tile
    (8, 2048, 8, 8, 128, 0),      # the training path (bench.py:121-133)
    (2, 1024, 8, 8, 64, 0),       # head_dim 64
    (2, 1024, 8, 8, 64, 64),      # head_dim 64, window 64
    (1, 3072, 16, 16, 128, 1024),  # the windowed serving path's prefill
    (8, 2048, 8, 8, 128, 1024),   # the windowed training path
    # lengths the H100 table's crossover (128) sends to K1: a 128-token
    # prefill (a /v1/score row padded to 128), and a tp2 rank's half
    (1, 128, 16, 16, 128, 0),
    (1, 128, 8, 8, 128, 0),
]
TRAIN_FWD_CASE = FWD_CASES[5]
WINDOW_PREFILL_CASE, WINDOW_TRAIN_CASE = FWD_CASES[8], FWD_CASES[9]

# K2: a decode layer's projections (k, n) and how many of each (wq, wk,
# wv, wo; w_gate, w_up; w_down); row counts m covering every rows
# instantiation (8, 16, 32, 64, and 64-row tiles past 64) and ragged
# ones; the per-layer summary at INT8_LAYER_M
INT8_PROJ = {(2048, 2048): 4, (2048, 8192): 2, (8192, 2048): 1}
INT8_M_CASES = (1, 3, 8, 16, 24, 64, 100, 200, 256)
INT8_LAYER_M = (1, 8, 16, 256)

# K3/K4 shapes (b, s, h, hd, window); the first is the training path's
BWD_CASES = [
    (8, 2048, 8, 128, 0),     # the training path (bench.py:121-133)
    (1, 1024, 16, 128, 0),    # the flagship's shape
    (1, 1024, 16, 128, 256),  # sliding window
    (1, 1024, 16, 128, 64),   # rows fully masked in a visited tile
    (2, 1024, 8, 64, 0),      # head_dim 64
    (2, 1024, 8, 64, 64),     # head_dim 64, window 64
    (8, 2048, 8, 128, 1024),  # the windowed training path
    (1, 128, 16, 128, 0),     # a 128-token training row (the H100 table)
]
WINDOW_BWD_CASE = BWD_CASES[6]
# K1 (b, s, h, kv, hd, window) and K3/K4 (b, s, h, hd, window) at a
# dp 2 x tp 2 rank's shard of the training path, held in train_parallel
SHARD_FWD_CASE = (4, 2048, 4, 4, 128, 0)
SHARD_BWD_CASE = (4, 2048, 4, 128, 0)

# the sliding-window phases: Mistral 7B's and Gemma 2's local layers use
# a 4096-token window; the repo's long-context measurement uses window
# 1024 at 8k (bench.py:303-330). Served at max_len 4096 with a 3072-token
# prompt, so the ring wraps during prefill.
WINDOW = 1024
WINDOW_MAX_LEN = 4096
WINDOW_PROMPT_LEN = 3072

# the beam and speculative phases (the flagship, 1024-token prompt): 4
# beams; a draft of the first 4 of 16 layers proposing 4 tokens a round
BEAM_WIDTH = 4
DRAFT_LAYERS, SPECULATE = 4, 4
SPEC_NEW = 64
SELF_DRAFT_NEW = 16  # tokens of the in-process run whose draft is the target
# the beam's score (a sum of 32 float32 log-probs from decode-path
# logits) vs /v1/score's teacher-forced sum over the same tokens: each
# log-prob moves with its position's logits, which agree within a few
# bf16 rounding steps of max|logits| (E2E_REL_TOL bounds the worst), and
# the independent errors partly cancel in the sum
BEAM_SCORE_REL_TOL = 1e-2
# LoRA on the training configuration (rank 16 on wq and wv)
LORA_RANK = 16
LORA_LR = 1e-3


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (seconds
    since the script started)."""
    if "phase" in obj:
        obj = {**obj, "ended_at_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def k1_forwards(cfg, lengths, kind="fwd") -> int:
    """How many forwards at these sequence lengths take K1 under the
    flash crossover in force (``ops/tuning.resolve_min_seq``, the card's
    table where one is committed): a count of launches a layer."""
    from containerpilot_tpu_torch.models import transformer as tf

    return sum(tf.flash_eligible(cfg, n, kind) for n in lengths)


def first_layers(params, n=CUT_LAYERS):
    """The first ``n`` layers of a params tree (views of its stacked
    layer leaves): a depth cut of the same weights."""
    return {**params, "layers": {k: v[:n]
                                 for k, v in params["layers"].items()}}


def cuda_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean device ms of fn over ``iters`` launches, cycling through
    arg_sets (several copies, so inputs come from device memory rather
    than L2). The launches are captured in one CUDA graph and replayed
    between two CUDA events, so host overhead between launches (Python,
    ctypes, dispatch) is not counted: this is kernel time."""
    for args in arg_sets:  # warm pass (lazy init, workspaces)
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()  # first replay uploads the graph
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(1, min(8, math.ceil(200e6 / max(nbytes, 1))))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kept_pairs(s: int, window: int) -> int:
    """(q, k) pairs the causal (and window) mask keeps, per head."""
    pos = torch.arange(s)
    seen = torch.clamp(pos + 1, max=window) if window > 0 else pos + 1
    return int(seen.sum())


def check_flash(gen, b, s, h, kv, hd, window):
    from containerpilot_tpu_torch.ops import flash

    def make():
        shape_q, shape_kv = (b, s, h, hd), (b, s, kv, hd)
        return tuple(
            torch.randn(shp, generator=gen, device="cuda").to(torch.bfloat16)
            for shp in (shape_q, shape_kv, shape_kv)
        )

    q, k, v = make()
    out, lse = flash.flash_attention_forward_with_lse(q, k, v, window=window)
    torch.cuda.synchronize()
    ref, ref_lse = flash.flash_attention_forward_reference(
        q, k, v, window=window
    )
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if not (torch.isfinite(out).all() and err <= FLASH_TOL
            and lse_err <= FLASH_TOL):
        raise AssertionError(
            f"flash kernel disagrees at {(b, s, h, kv, hd, window)}: "
            f"out {err}, lse {lse_err} (tol {FLASH_TOL})"
        )
    # a second launch on the same inputs gives the same bits: no
    # atomics, a fixed order of summation
    out2, lse2 = flash.flash_attention_forward_with_lse(q, k, v, window=window)
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        where = (out != out2).nonzero()[:4].tolist()
        raise AssertionError(
            f"flash kernel changed between two launches at "
            f"{(b, s, h, kv, hd, window)}: {int((out != out2).sum())} out "
            f"values (first at [b, s, h, d] {where}, second launch's error "
            f"{(out2.float() - ref.float()).abs().max().item()}), "
            f"{int((lse != lse2).sum())} lse values")
    sets = [(q, k, v)] + [
        make() for _ in range(copies_for(q.nbytes * 4) - 1)
    ]
    ms = cuda_ms(lambda a, c, d: flash.flash_attention_forward_with_lse(
        a, c, d, window=window), sets)
    plain_ms = cuda_ms(lambda a, c, d: flash.flash_attention_forward_reference(
        a, c, d, window=window), sets[:2], iters=5)
    mask = None
    if window > 0:
        idx = torch.arange(s, device="cuda")
        mask = (idx[:, None] >= idx[None, :]) & (
            idx[:, None] - idx[None, :] < window
        )
    sdpa_sets = [
        tuple(t.transpose(1, 2) for t in st) for st in sets
    ]

    def sdpa(a, c, d):
        return torch.nn.functional.scaled_dot_product_attention(
            a, c, d, attn_mask=mask, is_causal=mask is None,
            enable_gqa=kv != h,
        )

    library_ms = cuda_ms(sdpa, sdpa_sets)
    flops = 4.0 * hd * kept_pairs(s, window) * h * b
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + lse.numel() * 4
    bound_ms, bound_by = bound(nbytes, flops)
    return {
        "shape": {"b": b, "s": s, "h": h, "kv": kv, "hd": hd,
                  "window": window},
        "max_abs_err": err, "lse_max_abs_err": lse_err, "tol": FLASH_TOL,
        "repeat_bit_equal": True,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": ("SDPA with an explicit window mask (not the flash "
                    "path)" if window else "SDPA, is_causal"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "tflops": flops / ms * 1e-9,
    }


def kernel_case(row):
    """A check_flash row's numbers for the summary line."""
    return {key: row[key] for key in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "library", "tflops", "max_abs_err")}


def check_flash_bwd(gen, b, s, h, hd, window):
    """K3 and K4 against flash_attention_backward_reference (split into
    the plain versions of each kernel) on K1's residuals, bf16."""
    from containerpilot_tpu_torch.ops import flash

    def make():
        q, k, v, do = (
            torch.randn((b, s, h, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4)
        )
        with torch.no_grad():
            out, lse = flash.flash_attention_forward_with_lse(
                q, k, v, window=window)
        return q, k, v, do, lse, flash.attention_delta(out, do), out

    q, k, v, do, lse, delta, out = make()
    with torch.no_grad():
        dq = flash.flash_backward_dq(q, k, v, do, lse, delta, window)
        dk, dv = flash.flash_backward_dkdv(q, k, v, do, lse, delta, window)
        torch.cuda.synchronize()
        ref = flash.flash_attention_backward_reference(
            q, k, v, out, lse, do, window)
        # a second launch on the same inputs gives the same bits: no
        # atomics, a fixed order of summation
        again = (flash.flash_backward_dq(q, k, v, do, lse, delta, window),
                 *flash.flash_backward_dkdv(q, k, v, do, lse, delta, window))
    errs, rel = {}, {}
    for name, got, want, rep in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                    again):
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        scale = want.float().abs().max().item()
        if not (torch.isfinite(got).all() and scale > 0
                and err <= FLASH_BWD_REL_TOL * scale):
            at = [int(i) for i in torch.unravel_index(diff.argmax(), diff.shape)]
            raise AssertionError(
                f"flash backward {name} disagrees at {(b, s, h, hd, window)}:"
                f" {err} (tol {FLASH_BWD_REL_TOL} x {scale}) at [b, s, h, d] "
                f"{at}: {got[tuple(at)].item()} vs {want[tuple(at)].item()}"
            )
        if not torch.equal(got, rep):
            raise AssertionError(
                f"flash backward {name} changed between two launches at "
                f"{(b, s, h, hd, window)}")
        errs[name] = err
        rel[name] = err / scale
    sets = [(q, k, v, do, lse, delta)] + [
        make()[:6] for _ in range(copies_for(q.nbytes * 6) - 1)
    ]
    with torch.no_grad():
        dq_ms = cuda_ms(lambda *a: flash.flash_backward_dq(*a, window), sets)
        dkdv_ms = cuda_ms(
            lambda *a: flash.flash_backward_dkdv(*a, window), sets)
        dq_plain = cuda_ms(lambda *a: flash.flash_backward_dq_reference(
            *a, window), sets[:1], iters=3)
        dkdv_plain = cuda_ms(lambda *a: flash.flash_backward_dkdv_reference(
            *a, window), sets[:1], iters=3)

    # yardstick for K3+K4 together: SDPA forward+backward minus forward
    mask = None
    if window > 0:
        idx = torch.arange(s, device="cuda")
        mask = (idx[:, None] >= idx[None, :]) & (
            idx[:, None] - idx[None, :] < window)
    sdpa_sets = [
        tuple(t.transpose(1, 2).detach().requires_grad_(True)
              for t in st[:3]) + (st[3].transpose(1, 2),)
        for st in sets
    ]

    def sdpa(a, c, d):
        return torch.nn.functional.scaled_dot_product_attention(
            a, c, d, attn_mask=mask, is_causal=mask is None)

    def sdpa_fwd_bwd(a, c, d, g):
        torch.autograd.grad(sdpa(a, c, d), (a, c, d), g)

    with torch.no_grad():
        sdpa_fwd = cuda_ms(lambda a, c, d, g: sdpa(a, c, d), sdpa_sets)
    library_ms = cuda_ms(sdpa_fwd_bwd, sdpa_sets) - sdpa_fwd

    pairs = kept_pairs(s, window) * b * h
    n = q.numel()
    rows_bytes = 2 * lse.numel() * 4
    dq_flops, dkdv_flops = 6.0 * hd * pairs, 8.0 * hd * pairs
    dq_bound, dq_by = bound(5 * n * 2 + rows_bytes, dq_flops)
    dkdv_bound, dkdv_by = bound(6 * n * 2 + rows_bytes, dkdv_flops)
    return {
        "shape": {"b": b, "s": s, "h": h, "hd": hd, "window": window},
        "max_abs_err": errs, "err_over_max_ref": rel,
        "tol": f"{FLASH_BWD_REL_TOL} x max|ref|", "repeat_bit_equal": True,
        "dq": {"ms": dq_ms, "plain_ms": dq_plain, "bound_ms": dq_bound,
               "bound_by": dq_by, "tflops": dq_flops / dq_ms * 1e-9},
        "dkdv": {"ms": dkdv_ms, "plain_ms": dkdv_plain,
                 "bound_ms": dkdv_bound, "bound_by": dkdv_by,
                 "tflops": dkdv_flops / dkdv_ms * 1e-9},
        "library_ms_k3_plus_k4": library_ms, "sdpa_fwd_ms": sdpa_fwd,
        "library": ("SDPA fwd+bwd minus fwd, explicit window mask (not "
                    "the flash path)" if window
                    else "SDPA fwd+bwd minus fwd, is_causal"),
    }


def check_int8(gen, m, k, n):
    """K2 against int8_matmul_kernel_reference at x [m, k], w_q [k, n]:
    error, a repeat launch's bit equality (the split-k sum runs in a
    fixed order), kernel ms, GB/s and share of the bound, the plain
    version's ms and torch.matmul on bf16 weights."""
    from containerpilot_tpu_torch.ops import quant

    def make():
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        w_q, scales = quant.quantize_int8(w)
        return w_q.contiguous(), scales.contiguous()

    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w_q, scales = make()
    out = quant.int8_matmul_padded(x, w_q, scales)
    torch.cuda.synchronize()
    ref = quant.int8_matmul_kernel_reference(x, w_q, scales)
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not (torch.isfinite(out).all() and err <= INT8_REL_TOL * scale):
        raise AssertionError(
            f"int8 kernel disagrees at m={m} k={k} n={n}: {err} "
            f"(tol {INT8_REL_TOL} x {scale})"
        )
    again = quant.int8_matmul_padded(x, w_q, scales)
    if not torch.equal(out, again):
        raise AssertionError(
            f"int8 kernel changed between two launches at m={m} k={k} n={n}:"
            f" {int((out != again).sum())} values")
    sets = [(x, w_q, scales)] + [
        (x, *make()) for _ in range(copies_for(k * n) - 1)
    ]
    ms = cuda_ms(quant.int8_matmul_padded, sets, iters=50)
    plain_ms = cuda_ms(quant.int8_matmul_kernel_reference, sets[:2], iters=10)
    dense = [
        (a, (wq.float() * s[None, :]).to(torch.bfloat16))
        for a, wq, s in sets
    ]
    library_ms = cuda_ms(torch.matmul, dense, iters=50)
    nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
    bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n)
    return {
        "shape": {"m": m, "k": k, "n": n},
        "plan": list(quant._plan(m, k, n)[:3]),
        "max_abs_err": err, "ref_max_abs": scale,
        "tol": f"{INT8_REL_TOL} x max|ref|", "repeat_bit_equal": True,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "gb_s": nbytes / ms * 1e-6, "bound_share": bound_ms / ms,
    }


def int8_per_layer(rows, m):
    """K2's numbers summed over one decode layer's 7 projections at m
    rows (``rows`` from check_int8)."""
    return int8_layer_sum(rows, m, INT8_PROJ)


def int8_layer_sum(rows, m, proj):
    """Numbers of check_int8 ``rows`` at m rows summed over one layer's
    projections ``proj`` ((k, n) -> count)."""
    layer = [r for r in rows if r["shape"]["m"] == m
             and (r["shape"]["k"], r["shape"]["n"]) in proj]
    weight = [proj[(r["shape"]["k"], r["shape"]["n"])] for r in layer]
    out = {key: sum(w * r[key] for w, r in zip(weight, layer))
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in layer)
                       else "operations")
    return out


# ---------------------------------------------------------------------------
# phases 4 and 7: the serving path over HTTP
# ---------------------------------------------------------------------------

async def http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
        f"Connection: close\r\nContent-Length: {len(payload)}\r\n\r\n"
        .encode() + payload
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, data = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    if status != 200:
        raise AssertionError(f"{method} {path} -> {status}: {data[:200]!r}")
    return data


async def generate_tokens(port, body):
    t0 = time.perf_counter()
    data = await http(port, "POST", "/v1/generate", body)
    return json.loads(data)["tokens"], time.perf_counter() - t0


def check_rows(rows, n_rows, max_new, vocab):
    if len(rows) != n_rows or any(len(r) != max_new for r in rows):
        raise AssertionError(f"unexpected output shape: {rows!r:.200}")
    if any(not 0 <= t < vocab for r in rows for t in r):
        raise AssertionError("token id outside the vocabulary")


async def drive_server(cfg, params, prompt, label, device="cuda",
                       max_len=MAX_LEN):
    """Serve over HTTP; returns the phase's measurements. Counters are
    zeroed by the caller just before and read just after."""
    from containerpilot_tpu_torch.workload.serve import InferenceServer

    server = InferenceServer(cfg, params, "127.0.0.1", 0, max_len,
                             max_batch_rows=8, device=device)
    t0 = time.perf_counter()
    await server.run()
    warm_s = time.perf_counter() - t0
    try:
        port = server.port
        assert (await http(port, "GET", "/health")) == b"ok\n"
        out = {"phase": label, "warmup_s": warm_s}
        greedy = {"tokens": [prompt], "max_new_tokens": 32}
        rows, t32 = await generate_tokens(port, greedy)
        check_rows(rows, 1, 32, cfg.vocab_size)
        again, t32b = await generate_tokens(port, greedy)
        if again != rows:
            raise AssertionError("repeated greedy request gave other tokens")
        _, t1 = await generate_tokens(port, {**greedy, "max_new_tokens": 1})
        _, t1b = await generate_tokens(port, {**greedy, "max_new_tokens": 1})
        t32, t1 = min(t32, t32b), min(t1, t1b)
        out.update({
            "request_ms_prompt1024_new1": t1 * 1e3,
            "request_ms_prompt1024_new32": t32 * 1e3,
            "decode_tok_s_batch1": 31 / (t32 - t1),
        })
        batch = [prompt] + [
            [(t * 7 + r) % cfg.vocab_size for t in prompt]
            for r in range(1, 4)
        ]
        rows4, t4 = await generate_tokens(
            port, {"tokens": batch, "max_new_tokens": 16}
        )
        check_rows(rows4, 4, 16, cfg.vocab_size)
        out["request_ms_batch4_prompt1024_new16"] = t4 * 1e3
        # 8 rows (max_batch_rows) decode together: 8 * 31 tokens over
        # t(32 new) - t(1 new), each the best of two requests
        batch8 = [prompt] + [
            [(t * 7 + r) % cfg.vocab_size for t in prompt]
            for r in range(1, 8)
        ]
        t8 = {}
        for new in (32, 1):
            times = []
            for _ in range(2):
                rows8, dt = await generate_tokens(
                    port, {"tokens": batch8, "max_new_tokens": new})
                check_rows(rows8, 8, new, cfg.vocab_size)
                times.append(dt)
            t8[new] = min(times)
        out.update({
            "request_ms_batch8_prompt1024_new1": t8[1] * 1e3,
            "request_ms_batch8_prompt1024_new32": t8[32] * 1e3,
            "decode_tok_s_batch8": 8 * 31 / (t8[32] - t8[1]),
        })
        sampled = {"tokens": [prompt[:SAMPLED_LEN]], "max_new_tokens": 16,
                   "temperature": 0.8, "top_k": 40, "seed": 7}
        s1, _ = await generate_tokens(port, sampled)
        s2, _ = await generate_tokens(port, sampled)
        check_rows(s1, 1, 16, cfg.vocab_size)
        if s1 != s2:
            raise AssertionError("seeded sampling is not deterministic")
        info = json.loads(await http(port, "GET", "/v1/model"))
        if (info["n_layers"] != cfg.n_layers
                or not info["device"].startswith(device)):
            raise AssertionError(f"/v1/model says {info}")
        out["greedy_tokens"] = rows[0]
        return out
    finally:
        await server.stop()


def logits_rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


# ---------------------------------------------------------------------------
# phases 5 and 8: the slot engine over HTTP
# ---------------------------------------------------------------------------

def slot_requests(prompt, vocab):
    """The 8 concurrent single-row requests of a slot phase: two
    1024-token prompts (K1 at admission in bf16; 256-row K2 pieces under
    --prefill-chunk 256), a 300-token prompt (under --prefill-chunk 256:
    a 12-row, two 16-row and one 256-row piece), short greedy prompts and
    one short sampled prompt. Prompts shorter than the prefix cache's
    reuse floor (16) stay out of it, so the 1024-token entries survive
    for the prefix hit."""
    def variant(n, r):
        return [(t * 7 + r) % vocab for t in prompt[:n]]

    return [
        {"tokens": [prompt], "max_new_tokens": 32},
        {"tokens": [variant(PROMPT_LEN, 1)], "max_new_tokens": 24},
        {"tokens": [variant(5, 2)], "max_new_tokens": 40},
        {"tokens": [variant(9, 3)], "max_new_tokens": 16},
        {"tokens": [variant(300, 4)], "max_new_tokens": 32},
        {"tokens": [variant(12, 5)], "max_new_tokens": 28},
        {"tokens": [variant(15, 6)], "max_new_tokens": 36},
        {"tokens": [variant(10, 7)], "max_new_tokens": 24,
         "temperature": 0.8, "top_k": 40, "seed": 7},
    ]


def slot_logits_at(cfg, params, row, emitted, prefill_chunk, base=None,
                   max_len=MAX_LEN):
    """Logits before token ``len(emitted)`` of a request, two ways on the
    same inputs: the solo path (one-shot prefill, decode_step) and an
    eager slot path (the engine's admission policy, prefill_row: a
    prefix hit on ``base``'s cache when given, else its cold prefill;
    then a pool of 8 decoded by decode_slots_logits, the step the
    captured graph replays), and the route flips of an MoE model: the
    pool's decode steps take the solo steps' top-1 routes (routes_of),
    so a rounding tie in the router does not move the logits by a
    different expert's output. A diagnostic beside judge_served: it
    does not run the served graph."""
    from containerpilot_tpu_torch.models import decode, slots
    from containerpilot_tpu_torch.workload.serve_prefix import (
        PrefixCache,
        prefill_row,
    )

    routes, flips = {}, []
    with torch.inference_mode():
        solo, cache = decode.prefill(
            params, torch.tensor([row], device="cuda"), cfg, max_len)
        pc = None
        if base is not None:
            pc = PrefixCache(1)
            prefill_row(pc, base, cfg, params, max_len, prefill_chunk)
        pool_logits, row_cache = prefill_row(pc, row, cfg, params, max_len,
                                             prefill_chunk)
        if base is not None and pc.stats["hits"] != 1:
            raise AssertionError(f"no prefix hit on the base: {pc.stats}")
        pool = slots.slot_cache(cfg, 8, max_len)
        slots.insert_row(pool, row_cache, 0)
        del row_cache, pc
        for t in emitted:
            with routes_of(routes):
                solo, cache = decode.decode_step(
                    params, cache, torch.tensor([t], device="cuda"), cfg)
            step = torch.zeros(8, dtype=torch.int64, device="cuda")
            step[0] = t
            with routes_of(routes, pin=True, flips=flips):
                pool_logits = slots.decode_slots_logits(params, pool, step,
                                                        cfg)
            pool["pos"] += 1
        return pool_logits[:1].float(), solo.float(), flips


def judge_served(cfg, params, body, got, max_len=MAX_LEN):
    """Hold a served request's own tokens to solo decoding: teacher-force
    the solo path (one-shot prefill, decode_step) on ``got`` and, at
    every position, take the solo's own choice there exactly as
    ``generate`` makes it (argmax; or sample_logits on the request's
    generator stream, one [vocab] block a step). The served token must
    be that choice or a near tie with it: greedy, top logit minus the
    served token's logit <= NEAR_TIE_TOL * max|logits|; sampled, the
    same on the draw's Gumbel-perturbed scores, scaled by
    max|logits / T|, with the served token no further below the top-k
    cut. A replay that writes k/v to the wrong place or reads a stale
    buffer emits tokens that are not competitive, and fails. Returns
    the first position where the solo's choice differs (None when every
    token is the solo's, i.e. the output equals solo ``generate``), the
    worst gap over all positions, and the median gap of a vocabulary
    entry at position 0 (what a wrong token would show)."""
    from containerpilot_tpu_torch.models import decode

    row = body["tokens"][0]
    dev = params["norm_out"].device
    temp = float(body.get("temperature", 0.0))
    top_k = int(body.get("top_k", 0))
    seed = int(body.get("seed", 0))
    # twin streams: one for the solo's draw, one for the same uniforms
    draw, twin = (decode.row_generator(seed, 0, dev) for _ in range(2))
    # generate passes the filters only when one is set (top_p stays 0)
    knobs = (torch.tensor([temp], device=dev),) + (
        (torch.tensor([top_k], device=dev),
         torch.tensor([0.0], device=dev)) if top_k else (None, None))
    tiny = torch.finfo(torch.float32).tiny
    first, worst, typical = None, 0.0, None
    with torch.inference_mode():
        logits, cache = decode.prefill(
            params, torch.tensor([row], device=dev), cfg, max_len)
        for i, tok in enumerate(got):
            raw = logits[0].float()
            if temp <= 0.0:
                choice = int(torch.argmax(raw))
                score, scale, cut_gap = raw, raw.abs().max(), 0.0
            else:
                choice = int(decode.sample_logits(logits, [draw], *knobs)[0])
                x = raw / temp
                u = torch.rand(cfg.vocab_size, generator=twin,
                               device=dev).clamp_min(tiny)
                score, scale = x - torch.log(-torch.log(u)), x.abs().max()
                cut = torch.topk(x, top_k).values[-1] if top_k else x.min()
                cut_gap = float(torch.clamp_min(cut - x[tok], 0) / scale)
            gaps = (score[choice] - score) / scale
            if typical is None:
                typical = float(gaps.median())
            worst = max(worst, float(gaps[tok]), cut_gap)
            if first is None and choice != tok:
                first = i
            if i + 1 < len(got):
                logits, cache = decode.decode_step(
                    params, cache, torch.tensor([tok], device=dev), cfg)
    return first, worst, typical


def compare_with_solo(cfg, params, bodies, outs, prefill_chunk, bases,
                      max_len=MAX_LEN):
    """Each served output held to solo decoding by judge_served: every
    token the solo's choice or a near tie with it (NEAR_TIE_TOL), and
    the full length. Where the output differs from solo ``generate``,
    the first differing position also carries the logits' relative
    error there between the solo path and an eager slot path
    (slot_logits_at), within E2E_REL_TOL. ``bases``: the prompt whose
    cached prefix a request's admission reused, or None."""
    rows = []
    for body, got, base in zip(bodies, outs, bases):
        row = body["tokens"][0]
        j, worst, typical = judge_served(cfg, params, body, got, max_len)
        entry = {"prompt_len": len(row), "equal": j is None,
                 "worst_gap": worst, "median_vocab_gap_at_0": typical}
        if len(got) != body["max_new_tokens"] or worst > NEAR_TIE_TOL:
            raise AssertionError(
                f"served tokens off solo decoding (prompt {len(row)}): "
                f"worst gap {worst} over {NEAR_TIE_TOL}, first differing "
                f"position {j}, length {len(got)}")
        if j is not None:
            pool_l, solo_l, flips = slot_logits_at(
                cfg, params, row, got[:j], prefill_chunk, base, max_len)
            entry.update(first_diff=j,
                         logits_rel_err=logits_rel_err(pool_l, solo_l))
            if cfg.moe_experts:
                entry["route_flips"] = flip_summary(flips,
                                                    j * cfg.n_layers)
            if entry["logits_rel_err"] > E2E_REL_TOL:
                raise AssertionError(
                    f"slot logits off solo at {j} (prompt {len(row)}): "
                    f"rel err {entry['logits_rel_err']}")
        rows.append(entry)
    return rows


def steady_windows(engine, params, cfg, prompts, n_windows=6,
                   max_len=MAX_LEN, idle_share=False):
    """The server's step program, its engine stopped: 8 slots admitted,
    then steady fused windows dispatched two at a time (the engine's
    lookahead) under torch.cuda.set_sync_debug_mode("error"), which
    raises on a host sync inside dispatch. Returns device ms a window
    (CUDA events around the windows), host us a dispatch call, and the
    tokens a window emits."""
    from containerpilot_tpu_torch.models import decode
    from containerpilot_tpu_torch.workload.serve_slots import _Request

    engine.stop()
    program = engine.program
    program.reset()
    with torch.inference_mode():
        for slot, row in enumerate(prompts):
            logits, cache = decode.prefill(
                params, torch.tensor([row], device="cuda"), cfg, max_len)
            program.admit(slot, _Request(
                tokens=row, max_new=max_len - len(row), temperature=0.0,
                top_k=0, top_p=0.0, eos_id=-1, pad_id=0, seed=0,
                bias_idx=[-1] * decode.BIAS_SLOTS_MAX,
                bias_val=[0.0] * decode.BIAS_SLOTS_MAX), logits, cache)
            del cache
    budgets = [10 ** 6] * program.slots
    tokens = host_s = 0
    pending = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_windows):
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            pending.append(program.dispatch(budgets, True))
            host_s += time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if len(pending) == 2:
            toks, valid, run = program.tokens(pending.pop(0))
            tokens += int(valid.sum())
    end.record()
    for handle in pending:
        toks, valid, run = program.tokens(handle)
        tokens += int(valid.sum())
    torch.cuda.synchronize()
    window_ms = start.elapsed_time(end) / n_windows
    steps = program.rounds * program.chunk
    out = {
        "steady_windows": n_windows, "sync_free_dispatches": n_windows,
        "steady_window_ms": window_ms,
        "steady_step_ms": window_ms / steps,
        "steady_decode_tok_s": program.slots * steps / window_ms * 1e3,
        "dispatch_host_us": host_s / n_windows * 1e6,
        "steady_dispatches_per_token": n_windows / tokens,
    }
    if idle_share:
        out.update(profile_windows(program, budgets))
    return out


def profile_windows(program, budgets, n_windows=2):
    """Steady windows dispatched as the engine dispatches them (the next
    enqueued before the previous one's tokens are fetched) under
    torch.profiler: device kernel ms a step and the device's idle share
    (1 - kernel time / wall), as scripts/torch_decode_profile.py
    --slots reports them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pending = program.dispatch(budgets, True)
        for _ in range(n_windows - 1):
            nxt = program.dispatch(budgets, True)
            program.tokens(pending)
            pending = nxt
        program.tokens(pending)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    steps = n_windows * program.rounds * program.chunk
    return {
        "profiled_windows": n_windows,
        "profiled_wall_ms_per_step": wall * 1e3 / steps,
        "device_kernel_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "kernel_launches_per_step": len(kernels) / steps,
    }


async def drive_slots(cfg, params, prompt, label, prefill_chunk=0,
                      profiled=False):
    """One slot phase: the server with --slots 8 --slot-chunk 8
    --slot-window 4 --prefix-cache 4 (and --prefill-chunk), 8 staggered
    concurrent requests and a prefix hit, each held against a solo
    generate; a window-1 engine's outputs on the same requests, which
    must be bit-equal; decode tokens/s at 8 concurrent requests; steady
    windows free of host syncs (with ``profiled``, also their device ms
    a step and idle share under the profiler, and one graph replay
    against the eager round). The K1/K2 counters are zeroed just before
    the requests and read just after them."""
    from containerpilot_tpu_torch.ops import flash, quant
    from containerpilot_tpu_torch.workload.serve import InferenceServer
    from containerpilot_tpu_torch.workload.serve_prefix import PrefixCache
    from containerpilot_tpu_torch.workload.serve_slots import SlotEngine

    t0 = time.perf_counter()
    server = InferenceServer(
        cfg, params, "127.0.0.1", 0, MAX_LEN, max_batch_rows=8,
        device="cuda", slots=8, slot_chunk=8, slot_window=4,
        prefix_cache_entries=4, prefill_chunk=prefill_chunk,
    )
    await server.run()
    warm_s = time.perf_counter() - t0
    engine, program = server.slot_engine, server.slot_engine.program
    out = {"phase": label, "warmup_s": warm_s,
           "args": {"slots": 8, "slot_chunk": 8, "slot_window": 4,
                    "prefix_cache": 4, "prefill_chunk": prefill_chunk}}
    try:
        port = server.port
        assert (await http(port, "GET", "/health")) == b"ok\n"
        if not (program.graphs == 1
                and program.captured_at < server.ready_at):
            raise AssertionError(
                f"{program.graphs} graphs, captured at "
                f"{program.captured_at}, /health 200 at {server.ready_at}")
        bodies = slot_requests(prompt, cfg.vocab_size)
        hit = {"tokens": [prompt + prompt[:16]], "max_new_tokens": 16}

        async def staggered(i, body):
            await asyncio.sleep(0.03 * i)
            rows, _ = await generate_tokens(port, body)
            return rows[0]

        flash.LAUNCHES = quant.LAUNCHES = 0
        program.replayed_launches = [0] * len(program.replayed_launches)
        outs = await asyncio.gather(*[staggered(i, b)
                                      for i, b in enumerate(bodies)])
        outs.append((await generate_tokens(port, hit))[0][0])
        k1, k2 = flash.LAUNCHES, quant.LAUNCHES
        k2_decode = program.replayed_launches[0]
        info = json.loads(await http(port, "GET", "/v1/model"))
        pc = info["prefix_cache"]
        if pc["hits"] < 1 or not info["prefix_digest"].startswith("v"):
            raise AssertionError(f"no prefix hit: {pc}")
        for body, got in zip(bodies + [hit], outs):
            check_rows([got], 1, body["max_new_tokens"], cfg.vocab_size)
        out.update({
            "k1_launches": k1, "k2_launches": k2,
            "k2_launches_decode_replays": k2_decode,
            "k2_launches_admission": k2 - k2_decode,
            "k2_per_replay": program.replay_launches[0],
            "graphs_captured": program.graphs,
            "capture_s": program.capture_seconds,
            "prefix_cache": pc, "slot_engine": info["slot_engine"],
        })
        # decode tokens/s at 8 concurrent requests: 8 * 63 tokens over
        # t(64 new) - t(1 new), each the best of two rounds of 8
        # concurrent requests. The prompts are 15 tokens (under the
        # prefix cache's floor), so admission is small and steady
        # beside the decode; the pool's decode step costs the same at
        # any position (attention over the full max_len)
        times = {1: [], 64: []}
        for rep in range(2):
            for new in (1, 64):
                t0 = time.perf_counter()
                d0, n0 = engine.dispatches, engine.tokens_out
                await asyncio.gather(*[generate_tokens(port, {
                    "tokens": [[(t * 7 + r + 16 * rep + new)
                                % cfg.vocab_size for t in prompt[:15]]],
                    "max_new_tokens": new}) for r in range(8)])
                times[new].append(time.perf_counter() - t0)
                if new == 64:
                    out["dispatches_per_token"] = (
                        (engine.dispatches - d0) / (engine.tokens_out - n0))
        times = {new: min(ts) for new, ts in times.items()}
        out.update({
            "request_ms_8x_prompt15_new1": times[1] * 1e3,
            "request_ms_8x_prompt15_new64": times[64] * 1e3,
            "decode_tok_s_8_concurrent": 8 * 63 / (times[64] - times[1]),
            "window_wall_ms_median": sorted(engine.round_times_ms())[
                len(engine.round_times_ms()) // 2],
            "window_host_ms_median": sorted(engine.round_host_ms())[
                len(engine.round_host_ms()) // 2],
        })
    finally:
        await server.stop()
    if program.graphs != 1:
        raise AssertionError("a graph was captured after /health")
    out["solo"] = compare_with_solo(
        cfg, params, bodies + [hit], outs, prefill_chunk,
        [None] * len(bodies) + [prompt])
    out.update(steady_windows(engine, params, cfg,
                              [b["tokens"][0] for b in bodies],
                              idle_share=profiled))
    if profiled:
        out.update(replay_matches_eager(program, params, cfg))
    del engine, program, server
    torch.cuda.empty_cache()

    # the same requests through a window-1 engine (one chunk a dispatch)
    one = SlotEngine(cfg, params, MAX_LEN, slots=8, chunk=8, window=1,
                     prefill_chunk=prefill_chunk,
                     prefix_cache=PrefixCache(4))
    try:
        futs = [one.submit(b["tokens"][0], b["max_new_tokens"],
                           **{k: b[k] for k in ("temperature", "top_k",
                                                "seed") if k in b})
                for b in bodies]
        outs1 = [f.result(timeout=300) for f in futs]
        outs1.append(one.submit(hit["tokens"][0], 16).result(timeout=300))
    finally:
        one.stop()
    if outs1 != outs:
        diff = [i for i, (a, b) in enumerate(zip(outs1, outs)) if a != b]
        raise AssertionError(f"window-4 output differs from window-1 in "
                             f"requests {diff}")
    out["window4_bit_equal_window1"] = True
    if not (out["steady_decode_tok_s"] > 0 and all(
            math.isfinite(v) for v in (out["decode_tok_s_8_concurrent"],))):
        raise AssertionError(f"no decode rate: {out}")
    del one
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 6 and 9: a sliding window's ring cache and the int8 KV cache
# ---------------------------------------------------------------------------

async def read_sse(port, body, abort_after=None):
    """POST a streamed /v1/generate and read its SSE events (one JSON
    object each); with ``abort_after``, drop the connection after that
    many events."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        f"POST /v1/generate HTTP/1.1\r\nHost: 127.0.0.1\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    if int(head.split()[1]) != 200:
        raise AssertionError(f"stream -> {head[:100]!r} "
                             f"{(await reader.read())[:200]!r}")
    events, buf = [], b""
    try:
        while abort_after is None or len(events) < abort_after:
            chunk = await reader.read(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                events.append(json.loads(event[len(b"data: "):]))
    finally:
        writer.close()
        await writer.wait_closed()
    return events


def ring_logits(cfg, params, prompt, served, max_len):
    """The served path's logits, teacher-forced: prefill of the prompt
    (the ring and, under kv_int8, the quantized cache), then decode_step
    on each served token -> [len(served), vocab] float32, row i the
    logits that chose served[i]."""
    from containerpilot_tpu_torch.models import decode

    with torch.inference_mode():
        logits, cache = decode.prefill(
            params, torch.tensor([prompt], device="cuda"), cfg, max_len)
        rows = [logits[0].float()]
        for tok in served[:-1]:
            logits, cache = decode.decode_step(
                params, cache, torch.tensor([tok], device="cuda"), cfg)
            rows.append(logits[0].float())
        return torch.stack(rows)


def plain_window_logits(cfg, params, prompt, served):
    """The independent reference: one forward with plain windowed
    attention (flash_min_seq=0, no cache, no int8 KV) over prompt +
    served tokens -> the same rows as ring_logits."""
    import dataclasses

    from containerpilot_tpu_torch.models import transformer as tf

    plain = dataclasses.replace(cfg, flash_min_seq=0, kv_int8=False)
    seq = torch.tensor([prompt + served[:-1]], device="cuda")
    with torch.inference_mode():
        return tf.forward(params, seq, plain)[0, len(prompt) - 1:].float()


async def serve_window_requests(cfg, params, prompt):
    """The window config served by the Batcher over HTTP: a greedy
    3072-token prompt (windowed K1; the ring wraps during prefill) with
    64 new tokens, a 4-row batch of 1024-token prompts, and a logprobs
    request whose echo must equal /v1/score on the same sequence."""
    from containerpilot_tpu_torch.workload.serve import InferenceServer

    vocab = cfg.vocab_size
    server = InferenceServer(cfg, params, "127.0.0.1", 0, WINDOW_MAX_LEN,
                             max_batch_rows=8, device="cuda")
    t0 = time.perf_counter()
    await server.run()
    out = {"warmup_s": time.perf_counter() - t0}
    try:
        port = server.port
        rows, t_long = await generate_tokens(
            port, {"tokens": [prompt], "max_new_tokens": 64})
        check_rows(rows, 1, 64, vocab)
        batch = [[(t * 7 + r) % vocab for t in prompt[:PROMPT_LEN]]
                 for r in range(4)]
        rows4, t4 = await generate_tokens(
            port, {"tokens": batch, "max_new_tokens": 16})
        check_rows(rows4, 4, 16, vocab)
        head = prompt[:PROMPT_LEN]
        echo = json.loads(await http(port, "POST", "/v1/generate", {
            "tokens": [head], "max_new_tokens": 16, "logprobs": True}))
        gen = echo["tokens"][0]
        score = json.loads(await http(port, "POST", "/v1/score",
                                      {"tokens": [head + gen]}))
        tail = score["logprobs"][0][-len(gen):]
        gap = max(abs(a - b) for a, b in zip(echo["logprobs"][0], tail))
        if len(echo["logprobs"][0]) != len(gen) or not gap <= 1e-5:
            raise AssertionError(
                f"logprobs echo off /v1/score by {gap}: "
                f"{echo['logprobs'][0][:4]} vs {tail[:4]}")
        info = json.loads(await http(port, "GET", "/v1/model"))
        if info["stream"] or server.cfg != cfg:
            raise AssertionError(f"/v1/model says {info}")
        out.update({
            "request_ms_prompt3072_new64": t_long * 1e3,
            "request_ms_batch4_prompt1024_new16": t4 * 1e3,
            "logprobs_echo_vs_score_max_abs": gap,
            "greedy_tokens_head": rows[0][:8],
        })
        return out, rows[0]
    finally:
        await server.stop()


def drive_window_server(cfg_int8, params, prompt):
    """serve_window: the bf16 flagship with --window 1024 at max_len
    4096, served by the Batcher, once with the ring alone and once with
    --kv-int8. Each time the greedy 3072-token request's logits,
    teacher-forced through the served path, are held against one plain
    windowed forward over prompt + served tokens: the ring alone within
    E2E_REL_TOL, with kv_int8 within NEAR_TIE_TOL (its quantization
    error). K1 must launch n_layers times a windowed prefill."""
    import dataclasses

    from containerpilot_tpu_torch.models import decode
    from containerpilot_tpu_torch.ops import flash

    out = {"phase": "serve_window", "window": WINDOW,
           "max_len": WINDOW_MAX_LEN, "prompt_len": len(prompt)}
    for label, cfg in (("ring", dataclasses.replace(cfg_int8, kv_int8=False)),
                       ("ring_kv_int8", cfg_int8)):
        flash.LAUNCHES = 0
        served, tokens = asyncio.run(serve_window_requests(cfg, params, prompt))
        k1 = flash.LAUNCHES
        # a windowed prefill of the 3072- and the 1024-token prompts
        if k1 < 2 * cfg.n_layers:
            raise AssertionError(
                f"{label}: K1 launched {k1} times for the windowed prefills")
        got = ring_logits(cfg, params, prompt, tokens, WINDOW_MAX_LEN)
        want = plain_window_logits(cfg, params, prompt, tokens)
        err = logits_rel_err(got, want)
        limit = E2E_REL_TOL if not cfg.kv_int8 else NEAR_TIE_TOL
        agree = int((got.argmax(-1) == torch.tensor(tokens, device="cuda"))
                    .sum())
        if not (torch.isfinite(got).all() and err <= limit):
            raise AssertionError(
                f"{label}: served path's logits off the plain windowed "
                f"forward by {err} (limit {limit})")
        out[label] = {**served, "k1_launches": k1,
                      "logits_rel_err_vs_plain_forward": err,
                      "limit": limit,
                      "served_tokens_argmax_of_served_path": agree}
        del got, want
        torch.cuda.empty_cache()
    row = decode.init_cache(cfg_int8, 1, WINDOW_MAX_LEN, device="cuda")
    out["row_cache_bytes"] = sum(v.nbytes for k, v in row.items()
                                 if k != "pos")
    out["linear_bf16_row_cache_bytes_at_max_len"] = (
        2 * cfg_int8.n_layers * WINDOW_MAX_LEN * cfg_int8.kv_heads
        * cfg_int8.head_dim * 2)
    return out


def window_slot_requests(prompt, vocab):
    """The 8 concurrent single-row requests of the windowed slot phase:
    the 3072-token prompt (chunked admission in 256-row pieces; the ring
    wraps during prefill), a 1000-token prompt whose decode crosses the
    ring's end, a 300-token prompt (index 4, the streamed one), short
    greedy prompts and one short sampled prompt."""
    def variant(n, r):
        return [(t * 7 + r) % vocab for t in prompt[:n]]

    return [
        {"tokens": [prompt], "max_new_tokens": 32},
        {"tokens": [variant(1000, 1)], "max_new_tokens": 48},
        {"tokens": [variant(5, 2)], "max_new_tokens": 40},
        {"tokens": [variant(9, 3)], "max_new_tokens": 16},
        {"tokens": [variant(300, 4)], "max_new_tokens": 32},
        {"tokens": [variant(12, 5)], "max_new_tokens": 28},
        {"tokens": [variant(15, 6)], "max_new_tokens": 36},
        {"tokens": [variant(10, 7)], "max_new_tokens": 24,
         "temperature": 0.8, "top_k": 40, "seed": 7},
    ]


STREAMED = 4  # the index of window_slot_requests' streamed request


def replay_matches_eager(program, params, cfg):
    """One captured round replayed from the program's state (slots at
    the positions admission and the steady windows left them, none of
    them the capture's) against the same round run eagerly
    (slots.gated_round) on a copy of that state: the tokens and every
    pool leaf must be bit-equal. A position frozen into the graph at
    capture would write and mask the wrong slots. The slots decode
    greedily, so the copies' generators only need to exist."""
    from containerpilot_tpu_torch.models import slots

    pool = {k: v.clone() for k, v in program._pool.items()}
    state = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in program._state.items()}
    state["keys"] = [torch.Generator(device="cuda")
                     for _ in state["keys"]]
    if state["temperature"].any():
        raise AssertionError("replay check needs greedy slots")
    positions = pool["pos"].tolist()
    toks, _valid, _run = program.tokens(
        program.dispatch([10 ** 6] * program.slots, False))
    win = slots.window_buffers(program.slots, program.chunk, 1, "cuda")
    with torch.inference_mode():
        slots.begin_window(state, win, force=True)
        slots.gated_round(params, pool, state, cfg, program.chunk, win)
    torch.cuda.synchronize()
    differ = [name for name in pool
              if not torch.equal(pool[name], program._pool[name])]
    if differ or not (win["toks"].cpu().numpy() == toks).all():
        raise AssertionError(
            f"graph replay differs from the eager round at positions "
            f"{positions}: pool leaves {differ}, tokens "
            f"{(win['toks'].cpu().numpy() != toks).sum()}")
    return {"replay_bit_equal_eager_at_positions": positions}


async def serve_slots_window_requests(cfg, params, prompt):
    """The windowed int8 flagship through the slot engine over HTTP:
    the 8 staggered requests (one streamed over SSE), the streamed
    request again without streaming, and a second stream dropped after
    its first event. K1/K2 counts are zeroed just before the 8 requests
    and read just after."""
    from containerpilot_tpu_torch.ops import flash, quant
    from containerpilot_tpu_torch.workload.serve import InferenceServer

    try:
        InferenceServer(cfg, params, "127.0.0.1", 0, WINDOW_MAX_LEN,
                        device="cuda", slots=8, prefix_cache_entries=4)
    except ValueError as exc:
        refused = str(exc)
    else:
        raise AssertionError("--prefix-cache with --window was accepted")
    t0 = time.perf_counter()
    server = InferenceServer(
        cfg, params, "127.0.0.1", 0, WINDOW_MAX_LEN, max_batch_rows=8,
        device="cuda", slots=8, slot_chunk=8, slot_window=4,
        prefill_chunk=256,
    )
    await server.run()
    engine, program = server.slot_engine, server.slot_engine.program
    out = {"warmup_s": time.perf_counter() - t0,
           "prefix_cache_refused": refused,
           "args": {"slots": 8, "slot_chunk": 8, "slot_window": 4,
                    "prefill_chunk": 256, "window": cfg.window,
                    "kv_int8": cfg.kv_int8, "max_len": WINDOW_MAX_LEN}}
    try:
        port = server.port
        if not (program.graphs == 1
                and program.captured_at < server.ready_at):
            raise AssertionError("the round graph was not captured before "
                                 "/health")
        bodies = window_slot_requests(prompt, cfg.vocab_size)

        async def staggered(i, body):
            await asyncio.sleep(0.03 * i)
            if i != STREAMED:
                return (await generate_tokens(port, body))[0][0]
            events = await read_sse(port, {**body, "stream": True})
            if not events[-1].get("done"):
                raise AssertionError(f"stream ended without done: {events}")
            got = sum((e["tokens"] for e in events if "tokens" in e), [])
            if events[-1]["count"] != len(got):
                raise AssertionError(f"stream count {events[-1]}")
            return got, len(events) - 1

        flash.LAUNCHES = quant.LAUNCHES = 0
        program.replayed_launches = [0] * len(program.replayed_launches)
        outs = await asyncio.gather(*[staggered(i, b)
                                      for i, b in enumerate(bodies)])
        k1, k2 = flash.LAUNCHES, quant.LAUNCHES
        k2_decode = program.replayed_launches[0]
        outs[STREAMED], deltas = outs[STREAMED]
        twin = (await generate_tokens(port, bodies[STREAMED]))[0][0]
        if twin != outs[STREAMED]:
            raise AssertionError(
                f"streamed tokens {outs[STREAMED]} differ from the same "
                f"request not streamed {twin}")
        for body, got in zip(bodies, outs):
            check_rows([got], 1, body["max_new_tokens"], cfg.vocab_size)
        # a stream dropped after its first event frees its slot
        dropped = {"tokens": [[(t * 7 + 9) % cfg.vocab_size
                               for t in prompt[:20]]],
                   "max_new_tokens": WINDOW_MAX_LEN - 20, "stream": True}
        first = await read_sse(port, dropped, abort_after=1)
        t_drop = time.perf_counter()
        while engine.stats["active"] and time.perf_counter() - t_drop < 30:
            await asyncio.sleep(0.002)
        free_ms = (time.perf_counter() - t_drop) * 1e3
        walls = sorted(engine.round_times_ms())
        window_ms = walls[len(walls) // 2]
        if engine.stats["active"] or free_ms > max(3 * window_ms, 1000.0):
            raise AssertionError(
                f"dropped stream's slot freed after {free_ms} ms (window "
                f"{window_ms} ms), active {engine.stats['active']}")
        info = json.loads(await http(port, "GET", "/v1/model"))
        if not info["stream"] or info["prefix_cache"] is not None:
            raise AssertionError(f"/v1/model says {info}")
        out.update({
            "k1_launches": k1, "k2_launches": k2,
            "k2_launches_decode_replays": k2_decode,
            "k2_launches_admission": k2 - k2_decode,
            "k2_per_replay": program.replay_launches[0],
            "graphs_captured": program.graphs,
            "capture_s": program.capture_seconds,
            "streamed_events": deltas, "stream_equals_not_streamed": True,
            "dropped_stream_first_event": first[0],
            "dropped_stream_slot_freed_ms": free_ms,
            "window_wall_ms_median": window_ms,
            "slot_engine": info["slot_engine"],
        })
    finally:
        await server.stop()
    if program.graphs != 1:
        raise AssertionError("a graph was captured after /health")
    return out, bodies, outs, engine


def drive_slots_window(cfg, params, prompt):
    """serve_slots_window_int8: the int8 flagship with --window 1024
    --kv-int8 at max_len 4096 through the slot engine (--slots 8
    --slot-chunk 8 --slot-window 4 --prefill-chunk 256). Every served
    token is judged against solo decoding under the same config; then
    steady windows (device ms a step, idle share under the profiler, no
    host sync in a dispatch) and one replay against the eager round."""
    out, bodies, outs, engine = asyncio.run(
        serve_slots_window_requests(cfg, params, prompt))
    out = {"phase": "serve_slots_window_int8", **out}
    out["solo"] = compare_with_solo(cfg, params, bodies, outs, 256,
                                    [None] * len(bodies), WINDOW_MAX_LEN)
    out.update(steady_windows(engine, params, cfg,
                              [b["tokens"][0] for b in bodies],
                              max_len=WINDOW_MAX_LEN, idle_share=True))
    out.update(replay_matches_eager(engine.program, params, cfg))
    del engine
    torch.cuda.empty_cache()
    out["ring_only"] = steady_ring_only(cfg, params,
                                        [b["tokens"][0] for b in bodies])
    return out


def steady_ring_only(cfg, params, prompts):
    """The same steady windows with the ring alone (kv_int8 off, bf16
    k/v): separates the ring's pool length from the int8 cache's
    dequantization in the step's device time."""
    import dataclasses

    from containerpilot_tpu_torch.workload.serve_slots import SlotEngine

    ring = dataclasses.replace(cfg, kv_int8=False)
    engine = SlotEngine(ring, params, WINDOW_MAX_LEN, slots=8, chunk=8,
                        window=4)
    try:
        out = steady_windows(engine, params, ring, prompts,
                             max_len=WINDOW_MAX_LEN, idle_share=True)
    finally:
        engine.stop()
    del engine
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 10-13: training, and serving its checkpoint
# ---------------------------------------------------------------------------

def rel_norm_err(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@contextlib.contextmanager
def routes_of(table, pin=False, flips=None):
    """Within the block, every MoE layer's top-1 routing (models/moe.py's
    _route, which both MoE layers call) is recorded or pinned; a dense
    model is untouched. ``table`` maps a layer (its router view) to the
    router logits [b, m, E] (float32) of each of its calls, in order.
    Recording appends; with ``pin`` each call of a layer takes (and
    removes) the first call recorded for it (the same m), so a later
    pinned block goes on where an earlier one stopped; the first rows of
    each
    (a slot pool's row 0 against a solo row) go to the experts the
    recorded logits pick: the one-hot, the gate (that expert's prob) and
    the aux loss follow them. ``flips`` collects, for every pinned token
    whose own route differs, its gap on its own router logits (the own
    top minus the pinned expert's, over max|router logits|)."""
    from containerpilot_tpu_torch.models import moe

    route = moe._route

    def routed(x, router_w, mesh=None):
        probs, gate, onehot, aux = route(x, router_w, mesh)
        key = router_w.data_ptr()
        with torch.no_grad():
            logits = x.float() @ router_w.float()
        if not pin:
            table.setdefault(key, []).append(logits)
            return probs, gate, onehot, aux
        want = table[key].pop(0).argmax(-1)
        n = want.shape[0]
        if want.shape[1:] != x.shape[1:2]:
            raise AssertionError(
                f"pinned routes of {tuple(want.shape)} for a call of "
                f"{tuple(x.shape)}")
        idx = probs.argmax(-1)
        if flips is not None:
            own = logits[:n]
            differ = idx[:n] != want
            top = own.gather(-1, idx[:n, :, None])[..., 0]
            got = own.gather(-1, want[..., None])[..., 0]
            flips.extend(((top - got) / own.abs().amax(-1))[differ].tolist())
        idx[:n] = want
        n_experts = router_w.shape[-1]
        onehot = (idx[..., None] == torch.arange(
            n_experts, device=x.device)).float()
        gate = probs.gather(-1, idx[..., None])[..., 0]
        fraction, router_mean = onehot.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
        if mesh is not None and mesh.batch_stats:
            from containerpilot_tpu_torch.parallel.collectives import (
                mean_from,
            )

            fraction = mean_from(fraction, mesh)
            router_mean = mean_from(router_mean, mesh)
        aux = n_experts * (fraction * router_mean).sum()
        return probs, gate, onehot, aux

    moe._route = routed
    try:
        yield
    finally:
        moe._route = route


def flip_summary(flips, routed_tokens):
    """Route flips of a pinned run: count, worst gap, and the near-tie
    check (every gap within E2E_REL_TOL of max|router logits|)."""
    worst = max(flips, default=0.0)
    if worst > E2E_REL_TOL:
        raise AssertionError(
            f"a top-1 route flipped {worst} of max|router logits| away "
            f"from a tie ({len(flips)} flips)")
    return {"flipped": len(flips), "tokens_routed": routed_tokens,
            "worst_router_gap": worst}


def drive_training(gen, label="train", over=None, n_timed=5, extra=True):
    """The training path at full width: make_train_step on the repo's
    training configuration (with ``over`` applied, e.g. a window), the
    kernels' launch counts around the timed run, and the kernel path
    held against plain attention; with ``extra``, also remat "dots",
    the chunked loss and _dot_f32's gradient against the main path."""
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import flash
    from containerpilot_tpu_torch.parallel import train as tr
    from containerpilot_tpu_torch.workload.flops import (
        count_params,
        train_flops_per_token,
    )

    train_cfg = {**TRAIN_CFG, **(over or {})}
    cfg = tf.TransformerConfig(**train_cfg)
    state = tr.init_train_state(0, cfg, "cuda")
    step = tr.make_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    n_params = count_params(state.params)
    torch.cuda.reset_peak_memory_stats()
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKDV_LAUNCHES = 0
    losses = []
    for _ in range(2):
        state, loss = step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, loss = step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    launches = {"k1_launches": flash.LAUNCHES,
                "dq_launches": flash.DQ_LAUNCHES,
                "dkdv_launches": flash.DKDV_LAUNCHES}
    n_steps = len(losses)
    # K1 runs in each layer's forward and again in its remat recompute
    for key, per_layer in (("k1_launches", 2), ("dq_launches", 1),
                           ("dkdv_launches", 1)):
        if launches[key] < per_layer * cfg.n_layers * n_steps:
            raise AssertionError(
                f"{key} = {launches[key]} over {n_steps} training steps "
                f"of {cfg.n_layers} layers"
            )
    losses = [float(x) for x in losses]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"training loss did not fall: {losses}")
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    flops_per_token = train_flops_per_token(cfg, n_params, TRAIN_SEQ)
    out = {
        "phase": label, "config": train_cfg, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "params": n_params, "steps": n_steps,
        "step_ms": step_s * 1e3, "tokens_per_s": tokens_s,
        "mfu": tokens_s * flops_per_token / BF16_FLOP_PER_S,
        "flops_per_token": flops_per_token, "losses": losses,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        **launches,
    }

    # one value+grad through the kernels vs plain attention, batch 2;
    # then the kernels under remat "dots" (projections saved) and with
    # the chunked loss, each vs the main path's. An MoE model's later
    # runs take the kernel run's routes (routes_of), so the comparison
    # holds the attention paths against each other and not a top-1
    # route that flipped on a rounding tie; the routes a free plain run
    # takes are counted beside it
    params = state.params
    leaves = tr.tree_leaves(params)
    results = []
    variants = [{}, {"flash_min_seq": 0}]
    if extra:
        variants += [{"remat": "dots"}, {"loss_chunk": 512}]
    routes, flips = {}, []

    def value_and_grad(c, table, pin):
        with routes_of(table, pin, flips if pin else None):
            loss = tf.loss_fn(params, tokens[:2], c)
            return float(loss.detach()), torch.autograd.grad(loss, leaves)

    for variant in variants:
        c = tf.TransformerConfig(**{**train_cfg, **variant})
        results.append(value_and_grad(c, routes, pin=bool(results)))
    if cfg.moe_experts:
        # the plain run's own flips against the kernel run's routes, in
        # its forward and its remat recompute (each token twice)
        out["route_flips_plain_vs_kernel"] = flip_summary(
            flips, 2 * 2 * TRAIN_SEQ * cfg.n_layers)
        free = {}
        results.append(value_and_grad(
            tf.TransformerConfig(**{**train_cfg, "flash_min_seq": 0}),
            free, pin=False))
        out["free_plain_vs_kernel_loss_and_grad_rel"] = (
            abs(results[-1][0] - results[0][0]) / abs(results[-1][0]),
            max(rel_norm_err(a, b)
                for a, b in zip(results[0][1], results[-1][1])))

    def rel(i, j):
        (l_a, g_a), (l_b, g_b) = results[i], results[j]
        return (abs(l_a - l_b) / abs(l_b),
                max(rel_norm_err(a, b) for a, b in zip(g_a, g_b)))

    loss_rel, grad_rel = rel(0, 1)
    if not extra:
        if not (loss_rel <= TRAIN_LOSS_REL_TOL
                and grad_rel <= TRAIN_GRAD_REL_TOL):
            raise AssertionError(
                f"{label}: kernel path vs plain attention: loss rel "
                f"{loss_rel}, worst grad leaf rel {grad_rel}")
        out.update({"kernel_vs_plain_loss_rel": loss_rel,
                    "kernel_vs_plain_worst_grad_rel": grad_rel})
        del results, state, params, leaves
        torch.cuda.empty_cache()
        return out
    dots, chunked = rel(2, 0), rel(3, 0)
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel <= TRAIN_GRAD_REL_TOL
            and max(dots) <= REMAT_REL_TOL
            and max(chunked) <= CHUNKED_REL_TOL):
        raise AssertionError(
            f"kernel path vs plain attention: loss rel {loss_rel}, worst "
            f"grad leaf rel {grad_rel}; vs the main path: remat dots "
            f"{dots}, loss_chunk 512 {chunked}"
        )
    del results, state, params, leaves

    # _dot_f32 (bf16 GEMM, float32 out, its own backward) vs float32
    a = torch.randn((TRAIN_SEQ, 1024), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    w = (torch.randn((1024, 4096), generator=gen, device="cuda") / 32).to(
        torch.bfloat16).requires_grad_(True)
    cot = torch.randn((TRAIN_SEQ, 4096), generator=gen, device="cuda")
    got = torch.autograd.grad((tf._dot_f32(a, w) * cot).sum(), (a, w))
    af, wf = (t.detach().float().requires_grad_(True) for t in (a, w))
    want = torch.autograd.grad(((af @ wf) * cot).sum(), (af, wf))
    dot_rel = max(rel_norm_err(x, y) for x, y in zip(got, want))
    if dot_rel > DOT_GRAD_REL_TOL:
        raise AssertionError(f"_dot_f32 gradient off float32: {dot_rel}")
    out.update({
        "kernel_vs_plain_loss_rel": loss_rel,
        "kernel_vs_plain_worst_grad_rel": grad_rel,
        "remat_dots_vs_full_loss_and_grad_rel": dots,
        "loss_chunk_512_vs_whole_loss_and_grad_rel": chunked,
        "dot_f32_grad_rel_vs_f32": dot_rel,
    })
    torch.cuda.empty_cache()
    return out


def _run_cli(module, args, stop_after=None, timeout=600):
    """Run ``python -m containerpilot_tpu_torch.workload.<module>``; with
    ``stop_after``, SIGTERM it once its progress file reports that step.
    Returns (exit code, stdout)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.Popen(
        [sys.executable, "-m", f"containerpilot_tpu_torch.workload.{module}",
         *args], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )
    try:
        if stop_after is not None:
            progress = args[args.index("--progress-file") + 1]
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline and proc.poll() is None:
                try:
                    with open(progress) as fh:
                        if json.load(fh)["step"] >= stop_after:
                            proc.send_signal(signal.SIGTERM)
                            break
                except (OSError, ValueError, KeyError):
                    pass
                time.sleep(0.05)
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out


def check_prefetcher(tmp):
    """Token-shard batches staged on the card (pinned memory, side
    stream) equal the dataset's own."""
    import numpy as np

    from containerpilot_tpu_torch.workload.data import (
        DevicePrefetcher,
        TokenShardDataset,
        write_token_shards,
    )

    shards = os.path.join(tmp, "shards")
    write_token_shards(np.random.default_rng(0).integers(0, 1024, 200_000),
                       shards, shard_size=50_000)
    dataset = TokenShardDataset(shards, 1024, 4, vocab_size=1024)
    prefetcher = DevicePrefetcher(dataset, start_step=7, device="cuda")
    try:
        for step in range(7, 12):
            got_step, batch = prefetcher.next()
            want = torch.from_numpy(dataset.batch_at(step)).long()
            if got_step != step or not batch.is_cuda or not torch.equal(
                    batch.cpu(), want):
                raise AssertionError(f"prefetched batch {got_step} differs")
    finally:
        prefetcher.stop()


def _serve_cli_tokens(args, body, timeout=300):
    """Start ``python -m containerpilot_tpu_torch.workload.serve`` with
    ``args`` on a free port, POST ``body`` to /v1/generate once it is
    healthy, stop it with SIGTERM -> (tokens, /v1/model, its output)."""
    import socket
    import urllib.request

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "containerpilot_tpu_torch.workload.serve",
         "--host", "127.0.0.1", "--port", str(port), *args],
        cwd=root, env={**os.environ, "PYTHONPATH": root},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + timeout
        while True:
            if proc.poll() is not None:
                raise AssertionError(
                    f"serve CLI exited {proc.returncode}: "
                    f"{proc.communicate()[0][-2000:]}")
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise AssertionError("serve CLI never became healthy")
            time.sleep(0.2)
        req = urllib.request.Request(url + "/v1/generate",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            tokens = json.loads(r.read())["tokens"]
        with urllib.request.urlopen(url + "/v1/model", timeout=30) as r:
            info = json.loads(r.read())
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    return tokens, info, out


def serve_checkpoint(ckpt, model_args, vocab, emas=(False, True)):
    """The serving CLI on the trainer's checkpoint, once with the raw
    params and once with --use-ema (``emas``): each greedy request's
    tokens must equal an in-process generate on
    restore_params(prefer_ema=...), and the server must say which
    weights it loaded."""
    from containerpilot_tpu_torch.models import decode, quantized
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.parallel import (
        abstract_train_state,
        restore_params,
    )
    from containerpilot_tpu_torch.parallel.train import tree_leaves
    from containerpilot_tpu_torch.workload.modelcfg import derive_d_ff

    d_model = int(model_args[model_args.index("--d-model") + 1])
    cfg = tf.TransformerConfig(
        vocab_size=vocab, d_model=d_model,
        n_heads=int(model_args[model_args.index("--n-heads") + 1]),
        n_layers=int(model_args[model_args.index("--n-layers") + 1]),
        d_ff=derive_d_ff(d_model), max_seq_len=1024)
    from concurrent.futures import ThreadPoolExecutor

    prompt = [(7 * i + 3) % vocab for i in range(48)]
    body = {"tokens": [prompt], "max_new_tokens": 24}
    out = {}
    # the servers start at once (each its own process and port)
    with ThreadPoolExecutor(len(emas)) as pool:
        runs = list(pool.map(lambda ema: _serve_cli_tokens(
            ["--device", "cuda", "--checkpoint-dir", ckpt, "--max-len",
             "1024", "--vocab", str(vocab), *model_args]
            + (["--use-ema"] if ema else []), body), emas))
    for ema, (served, info, log_text) in zip(emas, runs):
        restored = restore_params(ckpt, abstract_train_state(cfg),
                                  prefer_ema=ema, device="cuda")
        params = quantized.cast_params(restored[0], cfg.dtype)
        with torch.inference_mode():
            local = decode.generate(params, torch.tensor([prompt],
                                                         device="cuda"),
                                    cfg, 24, 1024).tolist()
        said = f"serving checkpoint step {restored[1]}" + (
            " (EMA weights)" if ema else "")
        if not (restored.ema == ema and info["checkpoint"] == {
                "step": restored[1], "ema": ema} and said in log_text):
            raise AssertionError(
                f"serve --checkpoint-dir (ema={ema}) loaded "
                f"{info['checkpoint']}, restore says step {restored[1]} "
                f"ema={restored.ema}:\n{log_text[-1500:]}")
        if served != local:
            raise AssertionError(
                f"served checkpoint tokens (ema={ema}) {served} differ from "
                f"in-process generate {local}")
        out["ema" if ema else "raw"] = {
            "step": restored[1], "tokens_equal_in_process": True,
            "tokens_head": served[0][:8]}
        del params, restored
    if len(emas) < 2:
        return out
    raw, ema = (restore_params(ckpt, abstract_train_state(cfg),
                               prefer_ema=e, device="cuda")[0]
                for e in (False, True))
    out["ema_vs_raw_max_abs_param_diff"] = max(
        (a - b).abs().max().item() for a, b in zip(
            tree_leaves(raw), tree_leaves(ema)))
    return out


# the train_cli phase's model, whose checkpoint the serve_ckpt and
# serve_lora phases serve
CLI_MODEL = ["--d-model", "1024", "--n-layers", "2", "--n-heads", "8"]


def drive_train_cli(tmp):
    """The trainer CLI on the card: SIGTERM mid-run saves and exits 0; a
    restart resumes at exactly that step and finishes (with an EMA
    shadow, --ema-decay 0.99), leaving its checkpoint in ``tmp``/ckpt
    and token shards in ``tmp``/shards. Also the data prefetcher's
    staging onto the card; then the serving CLI on the checkpoint
    (serve_checkpoint), returned as a phase of its own."""
    check_prefetcher(tmp)
    model = CLI_MODEL
    base = ["--device", "cuda", *model, "--seq-len", "1024",
            "--batch", "4", "--ema-decay", "0.99",
            "--checkpoint-dir", os.path.join(tmp, "ckpt"),
            "--checkpoint-every", "1000",
            "--progress-file", os.path.join(tmp, "progress.json")]
    t0 = time.perf_counter()
    rc, out = _run_cli("train", base + ["--steps", "1000"], stop_after=3)
    saved = re.search(r"checkpoint saved at step (\d+)", out)
    if rc != 0 or saved is None:
        raise AssertionError(f"preempted trainer: exit {rc}\n{out[-2000:]}")
    at = int(saved.group(1))
    rc, out2 = _run_cli("train", base + ["--steps", str(at + 2)])
    if rc != 0 or f"resumed from checkpoint at step {at}" not in out2:
        raise AssertionError(f"resumed trainer: exit {rc}\n{out2[-2000:]}")
    with open(os.path.join(tmp, "progress.json")) as fh:
        final = json.load(fh)
    if final["step"] != at + 2 or not math.isfinite(final["loss"]):
        raise AssertionError(f"resumed trainer ended at {final}")
    train_cli = {
        "phase": "train_cli", "prefetched_batches_equal": True,
        "preempted_at_step": at, "ema_decay": 0.99,
        "resumed_to_step": final["step"], "final_loss": final["loss"],
        "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ckpt = serve_checkpoint(os.path.join(tmp, "ckpt"), model, 1024)
    return train_cli, {"phase": "serve_ckpt", **ckpt,
                       "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phases 14 and 15: beam search and self-speculative decoding over HTTP
# ---------------------------------------------------------------------------

class RowTally:
    """K2 launches by row count m, counted where ``ops.quant._launch``
    runs (beside its own LAUNCHES count). Only around eager paths: a
    CUDA graph replay launches without calling it."""

    def __enter__(self):
        import collections

        from containerpilot_tpu_torch.ops import quant

        self.counts = collections.Counter()
        self._quant, self._launch = quant, quant._launch

        def launch(x, w_q, scales):
            out = self._launch(x, w_q, scales)
            self.counts[x.shape[0]] += 1
            return out

        quant._launch = launch
        return self

    def __exit__(self, *exc):
        self._quant._launch = self._launch

    def by_rows(self):
        return {f"m={m}": n for m, n in sorted(self.counts.items())}


def gather_ms(cfg, width=BEAM_WIDTH, max_len=MAX_LEN, iters=10):
    """Device ms of one beam reorder (models/beam.py::_gather_beams) of a
    ``width``-row cache at ``max_len``, and the bytes it reads."""
    from containerpilot_tpu_torch.models import beam, decode

    cache = decode.init_cache(cfg, width, max_len, device="cuda")
    idx = torch.tensor([1, 0, 3, 2][:width], device="cuda")
    beam._gather_beams(cache, idx)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        cache = beam._gather_beams(cache, idx)
    end.record()
    torch.cuda.synchronize()
    nbytes = sum(t.nbytes for k, t in cache.items() if k != "pos")
    ms = start.elapsed_time(end) / iters
    del cache
    torch.cuda.empty_cache()
    return {"gather_ms": ms, "gather_cache_bytes": nbytes,
            "gather_gb_s": 2 * nbytes / ms / 1e6,
            "gather_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3}


async def beam_requests(cfg, params, server, prompt):
    """The beam half of a dtype's run: width 4 on the 1024-token prompt
    (32 and 1 new tokens, each twice; step ms from the difference), the
    same search in-process for its score, which /v1/score's
    teacher-forced sum over the same tokens must match within
    BEAM_SCORE_REL_TOL, and width 1 judged against solo greedy."""
    from containerpilot_tpu_torch.models import beam
    from containerpilot_tpu_torch.ops import flash, quant

    port = server.port
    body = {"tokens": [prompt], "max_new_tokens": 32,
            "beam_width": BEAM_WIDTH}
    flash.LAUNCHES = quant.LAUNCHES = 0
    with RowTally() as rows:
        times = {32: [], 1: []}
        outs = []
        for _ in range(2):
            for new in (32, 1):
                got, dt = await generate_tokens(
                    port, {**body, "max_new_tokens": new})
                times[new].append(dt)
                if new == 32:
                    outs.append(got[0])
        width1, _ = await generate_tokens(port, {**body, "beam_width": 1})
    k1, k2 = flash.LAUNCHES, quant.LAUNCHES
    if outs[0] != outs[1]:
        raise AssertionError("repeated beam request gave other tokens")
    check_rows([outs[0]], 1, 32, cfg.vocab_size)
    t32, t1 = min(times[32]), min(times[1])
    with torch.inference_mode():
        local, score = beam.beam_search(
            params, torch.tensor([prompt], device="cuda"), cfg, 32, MAX_LEN,
            beam_width=BEAM_WIDTH)
    if local.tolist() != outs[0]:
        raise AssertionError("in-process beam search gave other tokens "
                             "than the server")
    scored = json.loads(await http(port, "POST", "/v1/score", {
        "tokens": [prompt + outs[0]]}))["logprobs"][0]
    teacher = sum(scored[len(prompt) - 1:])
    score_rel = abs(score - teacher) / abs(teacher)
    if not (math.isfinite(score) and score_rel <= BEAM_SCORE_REL_TOL):
        raise AssertionError(f"beam score {score} vs teacher-forced sum "
                             f"{teacher}: rel {score_rel}")
    greedy_body = {"tokens": [prompt], "max_new_tokens": 32}
    first, worst, typical = judge_served(cfg, params, greedy_body,
                                         width1[0])
    if len(width1[0]) != 32 or worst > NEAR_TIE_TOL:
        raise AssertionError(f"beam width 1 off greedy decoding: worst gap "
                             f"{worst}, first difference {first}")
    return {
        "beam_width": BEAM_WIDTH, "prompt_len": len(prompt),
        "request_ms_new1": t1 * 1e3, "request_ms_new32": t32 * 1e3,
        "beam_step_ms": (t32 - t1) * 1e3 / 31,
        "beam_tokens_per_s": 31 / (t32 - t1),
        "score": score, "teacher_forced_sum": teacher,
        "score_rel_err": score_rel, "score_rel_tol": BEAM_SCORE_REL_TOL,
        "width1_first_diff_vs_greedy": first, "width1_worst_gap": worst,
        "median_vocab_gap_at_0": typical,
        "k1_launches": k1, "k2_launches": k2, "k2_by_rows": rows.by_rows(),
        "tokens_head": outs[0][:8],
    }


async def speculative_requests(cfg, params, server, prompt):
    """The speculative half: a greedy request of SPEC_NEW new tokens on
    the 1024-token prompt through the speculative engine (and one of a
    single token: tokens/s from the difference), judged against solo
    decoding; rounds and accepted drafts from the engine's dispatches
    (one an admission, two a round); then the same server's plain greedy
    figure through the Batcher (min_new_tokens 1 keeps the request off
    the speculative route and changes no token); last, in-process, the
    target drafting for itself, so that rounds accept (random weights
    leave a 4-layer draft's proposals rejected), judged the same way."""
    from containerpilot_tpu_torch.ops import flash, quant

    port, engine = server.port, server.spec_engine
    body = {"tokens": [prompt], "max_new_tokens": SPEC_NEW}
    flash.LAUNCHES = quant.LAUNCHES = 0
    with RowTally() as rows:
        d0 = engine.dispatches
        spec, t_new = await generate_tokens(port, body)
        dispatches = engine.dispatches - d0
        _, t_one = await generate_tokens(port, {**body, "max_new_tokens": 1})
    k1, k2 = flash.LAUNCHES, quant.LAUNCHES
    spec = spec[0]
    check_rows([spec], 1, SPEC_NEW, cfg.vocab_size)
    rounds = (dispatches - 1) // 2
    accepted = SPEC_NEW - 1 - rounds
    plain_body = {**body, "min_new_tokens": 1}
    plain, p_new = await generate_tokens(port, plain_body)
    _, p_one = await generate_tokens(port, {**plain_body,
                                            "max_new_tokens": 1})
    plain = plain[0]
    info = json.loads(await http(port, "GET", "/v1/model"))["speculative"]
    first, worst, typical = judge_served(cfg, params, body, spec)
    if worst > NEAR_TIE_TOL:
        raise AssertionError(f"speculative tokens off solo decoding: worst "
                             f"gap {worst}, first difference {first}")
    diff = next((i for i, (a, b) in enumerate(zip(spec, plain)) if a != b),
                None)
    # the accept path on the card: the target drafting for itself agrees
    # with its own verify chunk up to rounding, so whole rounds accept
    from containerpilot_tpu_torch.models import speculative

    self_toks, self_stats = speculative.speculative_generate(
        params, params, torch.tensor([prompt], device="cuda"), cfg, cfg,
        SELF_DRAFT_NEW, MAX_LEN, speculate=SPECULATE)
    self_toks = self_toks[0].tolist()
    self_first, self_worst, _ = judge_served(
        cfg, params, {**body, "max_new_tokens": SELF_DRAFT_NEW}, self_toks)
    if self_stats["accepted_drafts"] < 1 or self_worst > NEAR_TIE_TOL:
        raise AssertionError(f"self-drafted speculative decoding: "
                             f"{self_stats}, worst gap {self_worst}")
    return {
        "draft_layers": DRAFT_LAYERS, "speculate": SPECULATE,
        "prompt_len": len(prompt), "max_new_tokens": SPEC_NEW,
        "rounds": rounds, "accepted_drafts": accepted,
        "accepted_per_round": accepted / rounds,
        "tokens_per_round": (SPEC_NEW - 1) / rounds,
        "request_ms_new1": t_one * 1e3,
        f"request_ms_new{SPEC_NEW}": t_new * 1e3,
        "speculative_tok_s": (SPEC_NEW - 1) / (t_new - t_one),
        "round_ms": (t_new - t_one) * 1e3 / rounds,
        "plain_greedy_tok_s": (SPEC_NEW - 1) / (p_new - p_one),
        "tokens_equal_plain_greedy": sum(a == b for a, b in zip(spec,
                                                                plain)),
        "first_diff_vs_plain_greedy": diff,
        "judge_first_diff": first, "judge_worst_gap": worst,
        "median_vocab_gap_at_0": typical,
        "v1_model_speculative": info,
        "k1_launches": k1, "k2_launches": k2, "k2_by_rows": rows.by_rows(),
        "self_draft": {**self_stats, "judge_first_diff": self_first,
                       "judge_worst_gap": self_worst},
    }


async def drive_beam_spec(cfg, params, prompt):
    """One server with --draft-layers DRAFT_LAYERS --speculate SPECULATE
    (max_batch_rows 8): beams route before the speculative engine, so
    both halves share its warm-up. Returns (beam, speculative) dicts."""
    from containerpilot_tpu_torch.workload.serve import InferenceServer

    t0 = time.perf_counter()
    server = InferenceServer(cfg, params, "127.0.0.1", 0, MAX_LEN,
                             max_batch_rows=8, device="cuda",
                             draft_layers=DRAFT_LAYERS, speculate=SPECULATE)
    await server.run()
    warm_s = time.perf_counter() - t0
    try:
        assert (await http(server.port, "GET", "/health")) == b"ok\n"
        beam = await beam_requests(cfg, params, server, prompt)
        spec = await speculative_requests(cfg, params, server, prompt)
    finally:
        await server.stop()
    spec["warmup_s"] = warm_s
    return beam, spec


def serve_beam_spec(cfg, masters, prompt, card):
    """Phases 14 and 15 on the flagship, bf16 then int8 (the same
    seeded masters, quantized): K1 in the beam, target and draft
    prefills of the 1024-token prompt; under int8, K2 at m = 4 for the
    beams, m = 1 for the draft's steps and m = k+1 for verify chunks."""
    from containerpilot_tpu_torch.models import quantized

    beam_out = {"phase": "serve_beam", **card}
    spec_out = {"phase": "serve_speculative", **card}
    for label in ("bf16", "int8"):
        params = masters if label == "bf16" else (
            quantized.quantize_model_params(masters))
        params = quantized.cast_params(params, cfg.dtype)
        beam, spec = asyncio.run(drive_beam_spec(cfg, params, prompt))
        if label == "bf16":
            beam.update(gather_ms(cfg))
        prefill_k1 = cfg.n_layers + DRAFT_LAYERS
        if beam["k1_launches"] < cfg.n_layers or (
                spec["k1_launches"] < prefill_k1):
            raise AssertionError(
                f"{label}: K1 launched {beam['k1_launches']} times for the "
                f"beam requests, {spec['k1_launches']} for the speculative "
                "ones")
        if label == "int8":
            by_m = spec["k2_by_rows"]
            verify = sum(n for m, n in by_m.items()
                         if 2 <= int(m[2:]) <= SPECULATE + 1)
            if not (beam["k2_by_rows"].get(f"m={BEAM_WIDTH}", 0) > 0
                    and by_m.get("m=1", 0) > 0 and verify > 0):
                raise AssertionError(
                    f"K2 rows: beams {beam['k2_by_rows']}, speculative "
                    f"{by_m}")
        beam_out[label] = beam
        spec_out[label] = spec
        del params
        torch.cuda.empty_cache()
    return beam_out, spec_out


# ---------------------------------------------------------------------------
# phases 16 and 17: LoRA fine-tuning, then the adapter served
# ---------------------------------------------------------------------------

def drive_train_lora(gen):
    """make_lora_train_step at the training configuration (rank
    LORA_RANK on wq and wv, base frozen): with B = 0 the loss equals the
    base model's bit for bit; 2 warm and 3 timed steps with the K1/K3/K4
    counts around them; the loss falls and the base keeps its bits; one
    adapter gradient through the kernels against plain attention at
    batch 2."""
    from containerpilot_tpu_torch.models import lora
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import flash
    from containerpilot_tpu_torch.parallel import train as tr
    from containerpilot_tpu_torch.workload.flops import (
        count_params,
        train_flops_per_token,
    )

    cfg = tf.TransformerConfig(**TRAIN_CFG)
    base = tf.init_params(0, cfg, "cuda")
    init_fn, step, _abstract = tr.make_lora_train_step(
        cfg, LORA_RANK, learning_rate=LORA_LR)
    state = init_fn(1, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    with torch.no_grad():
        base_loss = tf.loss_fn(base, tokens, cfg)
        zero_loss = tf.loss_fn(lora.apply_lora(base, state.params, cfg),
                               tokens, cfg)
    if not torch.equal(base_loss, zero_loss):
        raise AssertionError(f"B = 0 adapter moved the loss: "
                             f"{base_loss.item()} vs {zero_loss.item()}")
    before = [t.clone() for t in tr.tree_leaves(base)]
    n_base, n_lora = count_params(base), count_params(state.params)
    torch.cuda.reset_peak_memory_stats()
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKDV_LAUNCHES = 0
    losses = []
    for _ in range(2):
        state, loss = step(state, base, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, loss = step(state, base, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    launches = {"k1_launches": flash.LAUNCHES,
                "dq_launches": flash.DQ_LAUNCHES,
                "dkdv_launches": flash.DKDV_LAUNCHES}
    for key, per_layer in (("k1_launches", 2), ("dq_launches", 1),
                           ("dkdv_launches", 1)):
        if launches[key] < per_layer * cfg.n_layers * len(losses):
            raise AssertionError(f"LoRA training: {key} = {launches[key]}")
    losses = [float(x) for x in losses]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"LoRA training loss did not fall: {losses}")
    if not all(torch.equal(a, b) for a, b in zip(before,
                                                 tr.tree_leaves(base))):
        raise AssertionError("LoRA training changed the frozen base")
    if any(t.requires_grad for t in tr.tree_leaves(base)):
        raise AssertionError("the frozen base requires grad")
    del before
    peak = torch.cuda.max_memory_allocated()

    # one adapter gradient through the kernels vs plain attention, batch 2
    results = []
    for variant in ({}, {"flash_min_seq": 0}):
        c = tf.TransformerConfig(**{**TRAIN_CFG, **variant})
        loss = tf.loss_fn(lora.apply_lora(base, state.params, c),
                          tokens[:2], c)
        results.append((float(loss.detach()), torch.autograd.grad(
            loss, tr.tree_leaves(state.params))))
    (l_k, g_k), (l_p, g_p) = results
    loss_rel = abs(l_k - l_p) / abs(l_p)
    grad_rel = max(rel_norm_err(a, b) for a, b in zip(g_k, g_p))
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel <= TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"LoRA gradient, kernels vs plain attention: "
                             f"loss rel {loss_rel}, worst leaf {grad_rel}")
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    flops = train_flops_per_token(cfg, n_base + n_lora, TRAIN_SEQ,
                                  n_frozen=n_base)
    del results, state, base
    torch.cuda.empty_cache()
    return {
        "phase": "train_lora", "config": TRAIN_CFG, "rank": LORA_RANK,
        "learning_rate": LORA_LR, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "base_params": n_base, "adapter_params": n_lora,
        "zero_adapter_loss_equals_base": True,
        "base_loss": base_loss.item(), "losses": losses,
        "step_ms": step_s * 1e3, "tokens_per_s": tokens_s,
        "mfu": tokens_s * flops / BF16_FLOP_PER_S, "flops_per_token": flops,
        "peak_memory_bytes": peak, "base_bits_unchanged": True,
        "kernel_vs_plain_loss_rel": loss_rel,
        "kernel_vs_plain_worst_grad_rel": grad_rel, **launches,
    }


def drive_serve_lora(tmp, model):
    """The LoRA chain through the CLIs over the train_cli phase's
    checkpoint: the trainer fine-tunes rank-LORA_RANK adapters on that
    frozen base; the serve CLI merges them (bf16, then --int8: merged,
    then quantized), and its greedy tokens equal an in-process generate
    on the same params; the evaluator's --lora-dir loss equals the
    in-process one."""
    from concurrent.futures import ThreadPoolExecutor

    from containerpilot_tpu_torch.models import decode, quantized
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.workload.modelcfg import (
        average_eval_loss,
        derive_d_ff,
        restore_merged_params,
    )
    from containerpilot_tpu_torch.workload.data import TokenShardDataset

    ckpt, adapter = os.path.join(tmp, "ckpt"), os.path.join(tmp, "adapter")
    shards = os.path.join(tmp, "shards")
    lora_flags = ["--lora-dir", adapter, "--lora-rank", str(LORA_RANK)]
    t0 = time.perf_counter()
    rc, out = _run_cli("train", [
        "--device", "cuda", *model, "--seq-len", "1024", "--batch", "4",
        "--lora-rank", str(LORA_RANK), "--base-checkpoint-dir", ckpt,
        "--checkpoint-dir", adapter, "--steps", "4", "--checkpoint-every",
        "4", "--learning-rate", str(LORA_LR)])
    base_step = re.search(r"lora: frozen base from checkpoint step (\d+)",
                          out)
    if rc != 0 or base_step is None or "lora: rank" not in out:
        raise AssertionError(f"LoRA trainer: exit {rc}\n{out[-2000:]}")
    d_model = int(model[model.index("--d-model") + 1])
    cfg = tf.TransformerConfig(
        vocab_size=1024, d_model=d_model,
        n_heads=int(model[model.index("--n-heads") + 1]),
        n_layers=int(model[model.index("--n-layers") + 1]),
        d_ff=derive_d_ff(d_model), max_seq_len=1024)
    merged = restore_merged_params(cfg, ckpt, lora_dir=adapter,
                                   lora_rank=LORA_RANK, device="cuda")[0]
    prompt = [(5 * i + 1) % 1024 for i in range(40)]
    body = {"tokens": [prompt], "max_new_tokens": 24}
    result = {"phase": "serve_lora", "rank": LORA_RANK,
              "base_step": int(base_step.group(1)),
              "train_s": time.perf_counter() - t0}
    variants = (("bf16", []), ("int8", ["--int8"]))
    # the two servers and the evaluator start at once (processes of
    # their own)
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        evaluated = pool.submit(_run_cli, "evaluate", [
            "--device", "cuda", "--checkpoint-dir", ckpt, *lora_flags,
            "--data-dir", shards, "--eval-holdout", "4", "--batch", "2",
            "--seq-len", "1024", "--vocab", "1024", *model])
        runs = list(pool.map(lambda extra: _serve_cli_tokens(
            ["--device", "cuda", "--checkpoint-dir", ckpt, "--max-len",
             "1024", "--vocab", "1024", *model, *lora_flags, *extra],
            body), [extra for _label, extra in variants]))
        rc, out = evaluated.result()
    for (label, extra), (served, _info, log_text) in zip(variants, runs):
        if f"merged lora adapter (rank {LORA_RANK}, step 4)" not in log_text:
            raise AssertionError(f"serve --lora-dir ({label}):\n"
                                 f"{log_text[-1500:]}")
        params = merged if not extra else quantized.quantize_model_params(
            merged)
        params = quantized.cast_params(params, cfg.dtype)
        with torch.inference_mode():
            local = decode.generate(params, torch.tensor([prompt],
                                                         device="cuda"),
                                    cfg, 24, 1024).tolist()
        if served != local:
            raise AssertionError(f"served LoRA tokens ({label}) {served} "
                                 f"differ from in-process {local}")
        result[label] = {"tokens_equal_in_process": True,
                         "tokens_head": served[0][:8]}
        del params
    if rc != 0:
        raise AssertionError(f"evaluate --lora-dir: exit {rc}\n{out[-2000:]}")
    report = json.loads(out.strip().splitlines()[-1])
    data = TokenShardDataset(shards, 1024, 2, vocab_size=1024,
                             holdout_windows=4)
    want = average_eval_loss(merged, cfg, data.n_eval_batches,
                             data.eval_batch)
    if not (report["lora"] and report["eval_loss"] == round(want, 6)):
        raise AssertionError(f"evaluate --lora-dir said {report}, "
                             f"in-process {want}")
    result.update({"evaluate": report, "in_process_eval_loss": want,
                   "seconds": time.perf_counter() - t0})
    del merged
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 18: the replica's telemetry and wire face, through the serve CLI
# ---------------------------------------------------------------------------

# the serve CLI at the flagship's width and CUT_LAYERS of its depth (its
# d_ff is the CLI's derive_d_ff(2048) = 6144, as in the reference CLI)
FACE_MODEL = ["--vocab", "32768", "--d-model", "2048", "--n-layers", "8",
              "--n-heads", "16", "--max-len", str(MAX_LEN)]
FACE_ARGS = ["--slots", "8", "--text", "--mux"]
# K2 at the CLI model's MLP projections (k, n), beside INT8_PROJ's
FACE_INT8_PROJ = ((2048, 6144), (6144, 2048))
LEDGER_REL_TOL = 1e-2  # ledger stages vs its uptime, across two reads
# the completions' passes over the two transports, in turns
FACE_PASSES = (("mux", 0), ("http11", 0), ("http11", 1), ("mux", 1))

# ``serve_cli.main`` (what ``python -m containerpilot_tpu_torch.workload
# .serve`` runs) with the kernel counters readable from outside: SIGUSR2
# zeroes them, SIGUSR1 reads them; each writes {"k1", "k2"} to argv[1]
COUNTED_SERVE = """
import json, os, signal, sys
from containerpilot_tpu_torch.ops import flash, quant

# a follower rank (--tp/--cp) writes argv[1] + ".rank<r>"
PATH = sys.argv[1]
if "--follower-rank" in sys.argv:
    PATH += ".rank" + sys.argv[sys.argv.index("--follower-rank") + 1]

def dump(*_):
    tmp = PATH + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"k1": flash.LAUNCHES, "k2": quant.LAUNCHES}, fh)
    os.replace(tmp, PATH)

def zero(*_):
    flash.LAUNCHES = quant.LAUNCHES = 0
    dump()

signal.signal(signal.SIGUSR1, dump)
signal.signal(signal.SIGUSR2, zero)
from containerpilot_tpu_torch.workload.serve_cli import main
CODE = sys.orig_argv[sys.orig_argv.index("-c") + 1]
sys.exit(main(sys.argv[2:],
              follower_cmd=[sys.executable, "-c", CODE, sys.argv[1]]))
"""


def child_pids(pid):
    """The pids whose parent is ``pid`` (a serve CLI's followers)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(entry))
    return out


class CountedServe:
    """The serve CLI in a subprocess on a free port (COUNTED_SERVE),
    healthy on entry (a --standby: warm and standing by), stopped with
    SIGTERM (then killed) on exit."""

    def __init__(self, args, tmp, timeout=600, ranks=1):
        self.args, self.timeout, self.ranks = args, timeout, ranks
        self.counts_path = os.path.join(tmp, "kernel_counts.json")
        self.proc = None
        self.log = ""

    def __enter__(self):
        import socket
        import urllib.error
        import urllib.request

        root = os.path.dirname(os.path.abspath(__file__))
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            self.port = sock.getsockname()[1]
        self.proc = subprocess.Popen(
            [sys.executable, "-c", COUNTED_SERVE, self.counts_path,
             "--host", "127.0.0.1", "--port", str(self.port), *self.args],
            cwd=root, env={**os.environ, "PYTHONPATH": root},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        t0 = time.perf_counter()
        deadline = time.monotonic() + self.timeout
        try:
            while True:
                if self.proc.poll() is not None:
                    raise AssertionError(
                        f"serve CLI exited {self.proc.returncode}: "
                        f"{self.proc.communicate()[0][-2000:]}")
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{self.port}/health",
                            timeout=5) as r:
                        if r.status == 200:
                            break
                except urllib.error.HTTPError as exc:
                    # a warm standby answers 503 "standby" until promoted
                    if "--standby" in self.args and exc.code == 503 and (
                            exc.read().startswith(b"standby")):
                        break
                except OSError:
                    pass
                if time.monotonic() > deadline:
                    raise AssertionError("serve CLI never became healthy")
                time.sleep(0.2)
        except BaseException:
            self.__exit__()
            print(f"serve CLI output:\n{self.log[-8000:]}", file=sys.stderr,
                  flush=True)
            raise
        self.ready_s = time.perf_counter() - t0
        return self

    def counts(self, zero=False):
        """The subprocess's K1/K2 counters (zeroed first with zero); over
        ranks, a list of every rank's, in rank order. A follower runs its
        signal handler when its next lockstep op reaches it, so a read of
        /v1/model (a check op) follows the signals."""
        paths = [self.counts_path] + [f"{self.counts_path}.rank{r}"
                                      for r in range(1, self.ranks)]
        for path in paths:
            if os.path.exists(path):
                os.remove(path)
        sig = signal.SIGUSR2 if zero else signal.SIGUSR1
        pids = [self.proc.pid]
        if self.ranks > 1:
            pids += child_pids(self.proc.pid)
            if len(pids) != self.ranks:
                raise AssertionError(f"{len(pids)} processes for "
                                     f"{self.ranks} ranks")
        for pid in pids:
            os.kill(pid, sig)
        if self.ranks > 1:
            asyncio.run(http(self.port, "GET", "/v1/model"))
        deadline = time.monotonic() + 30
        while not all(os.path.exists(p) for p in paths):
            if time.monotonic() > deadline or self.proc.poll() is not None:
                raise AssertionError("serve CLI did not report its counts")
            time.sleep(0.02)
        out = []
        for path in paths:
            with open(path) as fh:
                out.append(json.load(fh))
        return out if self.ranks > 1 else out[0]

    def __exit__(self, *exc):
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            self.log = self.proc.communicate(timeout=60)[0]
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.log = self.proc.communicate()[0]


def face_requests(seed=0):
    """The phase's 8 /v1/completions bodies: one 1023-byte prompt (1024
    ids with BOS, so admission runs K1), six short ones (the tokenizer's
    EOS ends them by default) and one streamed."""
    import random

    rng = random.Random(seed)
    letters = "abcdefghijklmnopqrstuvwxyz     ,.;"

    def text(n):
        return "".join(rng.choice(letters) for _ in range(n))

    bodies = [{"prompt": text(PROMPT_LEN - 1), "max_new_tokens": 32,
               "eos_id": -1}]
    bodies += [{"prompt": text(8 + 5 * i), "max_new_tokens": 24}
               for i in range(6)]
    bodies.append({"prompt": text(40), "max_new_tokens": 32, "eos_id": -1,
                   "stream": True})
    return bodies


def sse_events(data):
    return [json.loads(line[len(b"data: "):]) for line in data.split(b"\n")
            if line.startswith(b"data: ")]


def completion_of(status, data, streamed):
    """(tokens, text, events) of one /v1/completions answer."""
    if status != 200:
        raise AssertionError(f"/v1/completions -> {status}: {data[:200]!r}")
    if streamed:
        events = sse_events(data)
        if not events or events[-1].get("done") is not True:
            raise AssertionError(f"stream without a done event: {events}")
        tokens = sum((e.get("tokens", []) for e in events[:-1]), [])
        return tokens, "".join(e.get("text", "") for e in events), events
    body = json.loads(data)
    return body["tokens"], body["text"], None


async def face_over_mux(port, bodies, tag):
    """The bodies as concurrent streams on ONE cp-mux/1 connection (the
    port's MuxConnection, the gateway's head template with the trace id
    spliced in) -> [(status, headers, body, wall s)]."""
    from containerpilot_tpu_torch.fleet.pool import dial_mux

    conn = await dial_mux("127.0.0.1", port, 30.0)
    if conn is None:
        raise AssertionError("the --mux server declined cp-mux/1")

    async def one(i, body):
        t0 = time.perf_counter()
        stream = await conn.open_stream(
            "POST", "/v1/completions", json.dumps(body).encode(),
            trace_id=f"{tag}-{i}")
        status, headers = await stream.response_head(600.0)
        data = await stream.read_body(600.0, 1 << 24)
        return status, headers, data, time.perf_counter() - t0

    try:
        out = await asyncio.gather(*[one(i, b) for i, b in enumerate(bodies)])
        if conn.streams_opened != len(bodies) or conn.dead:
            raise AssertionError(f"mux connection: {conn.streams_opened} "
                                 f"streams, dead={conn.dead}")
        return out
    finally:
        conn.close()


async def face_over_http(port, bodies, tag):
    """The same bodies over plain HTTP/1.1, one connection each."""
    async def one(i, body):
        t0 = time.perf_counter()
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        payload = json.dumps(body).encode()
        writer.write(
            f"POST /v1/completions HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            f"Connection: close\r\nX-CP-Trace: {tag}-{i}\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, data = raw.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        headers = {k.strip().lower(): v.strip() for k, _, v in
                   (line.partition(":") for line in lines[1:])}
        return int(lines[0].split()[1]), headers, data, (
            time.perf_counter() - t0)

    return await asyncio.gather(*[one(i, b) for i, b in enumerate(bodies)])


def parse_exposition(text):
    """Prometheus text format 0.0.4 -> {family: type} and
    {(sample name, frozenset(labels)): value}."""
    types, samples = {}, {}
    sample_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
        elif line and not line.startswith("#"):
            m = sample_re.match(line)
            if m is None:
                raise AssertionError(f"unparsable /metrics line {line!r}")
            labels = frozenset(label_re.findall(m.group(2) or ""))
            samples[(m.group(1), labels)] = float(m.group(3))
    return types, samples


def slot_step_with_ledger(cfg, params, reps=2):
    """The slot engine (8 slots, chunk 8, window 4) with and without the
    device-time ledger, in turns: 8 concurrent 15-token requests of 64
    new tokens each; the median engine cycle of a fused window over its
    32 steps, and the wall of the 8 requests."""
    from containerpilot_tpu_torch.telemetry.goodput import DeviceTimeLedger
    from containerpilot_tpu_torch.workload.serve_slots import SlotEngine

    engines = {
        "no_ledger": SlotEngine(cfg, params, MAX_LEN, slots=8, chunk=8,
                                window=4),
        "ledger": SlotEngine(cfg, params, MAX_LEN, slots=8, chunk=8,
                             window=4, ledger=DeviceTimeLedger()),
    }
    out = {name: {"step_ms": [], "wall_s": []} for name in engines}
    try:
        for rep in range(reps):
            for name, engine in engines.items():
                prompts = [[(t * 7 + r + 32 * rep) % cfg.vocab_size
                            for t in range(15)] for r in range(8)]
                engine.submit(prompts[0], 2).result(timeout=300)  # warm
                engine._round_times.clear()
                t0 = time.perf_counter()
                futs = [engine.submit(p, 64) for p in prompts]
                for fut in futs:
                    fut.result(timeout=300)
                out[name]["wall_s"].append(time.perf_counter() - t0)
                cycles = sorted(engine.round_times_ms())
                out[name]["step_ms"].append(
                    cycles[len(cycles) // 2] / (engine.window * engine.chunk))
        ledger = engines["ledger"].ledger
        out["ledger"]["transitions"] = ledger.transitions
        out["ledger"]["stages_s"] = ledger.snapshot()["stages_s"]
    finally:
        for engine in engines.values():
            engine.stop()
    return out


def drive_fleet_face(tmp, card, gen, device="cuda"):
    """Phase 18: the serve CLI at FACE_MODEL (the flagship's width) with
    --slots 8 --text --mux (bf16, then --int8), seeded weights. Over ONE
    cp-mux/1 connection (the port's MuxConnection), 8 concurrent
    /v1/completions with X-CP-Trace ids (a 1023-byte prompt for K1, six
    short, one streamed), and the same over HTTP/1.1, in turns
    (FACE_PASSES); each completion's
    tokens equal /v1/generate greedy on the encoded ids (or, where not,
    both pass judge_served), text equals decode(tokens) and a stream's
    text concatenates to it; /metrics counts exactly the requests sent
    by endpoint and code; the ledger's stages sum to its uptime;
    /v1/goodput's dispatches and tokens equal the engine's; /v1/traces
    holds every id sent with slot_queue_wait, prefill and decode spans;
    K1 (and K2 under --int8) launched in the subprocess. Also K2 against
    its plain version at the CLI model's MLP shapes, the slot step with
    and without the ledger (bf16, in-process) and the /metrics scrape
    ms. ``device="cpu"`` runs the same drive on the plain versions (no
    kernel to count or hold), for a small FACE_MODEL."""
    from containerpilot_tpu_torch.workload import serve_cli
    from containerpilot_tpu_torch.workload.text import ByteTokenizer

    bodies = face_requests()
    result = {"phase": "serve_fleet_face", "model": FACE_MODEL,
              "args": FACE_ARGS, **card}
    if device == "cuda":
        result["k2_cli_shapes"] = [check_int8(gen, m, k, n) for m in (1, 8)
                                   for (k, n) in FACE_INT8_PROJ]
    for label, extra in (("bf16", []), ("int8", ["--int8"])):
        args = ["--device", device, *FACE_MODEL, *FACE_ARGS, *extra]
        cfg, params, _ = serve_cli.load_model(
            serve_cli.build_arg_parser().parse_args(args))
        tok = ByteTokenizer(cfg.vocab_size)
        out = {}
        with CountedServe(args, tmp) as srv:
            port = srv.port
            out["ready_s"] = srv.ready_s
            srv.counts(zero=True)
            # the two transports in turns (mux, HTTP/1.1, HTTP/1.1, mux):
            # the first pass also pays the process's first long prefill
            passes = []
            for via, rep in FACE_PASSES:
                drive = face_over_mux if via == "mux" else face_over_http
                passes.append(asyncio.run(drive(
                    port, bodies, f"{label}-{via}{rep}")))
            gen_bodies = [{"tokens": [tok.encode(b["prompt"])],
                           "max_new_tokens": b["max_new_tokens"],
                           "eos_id": b.get("eos_id", tok.EOS)}
                          for b in bodies]

            async def generate_all():
                return await asyncio.gather(*[
                    generate_tokens(port, b) for b in gen_bodies])

            generated = [rows[0] for rows, _ in asyncio.run(generate_all())]
            counts = srv.counts()
            info = json.loads(asyncio.run(http(port, "GET", "/v1/model")))
            scrape_ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                text = asyncio.run(http(port, "GET", "/metrics")).decode()
                scrape_ms.append((time.perf_counter() - t0) * 1e3)
            goodput = json.loads(asyncio.run(http(port, "GET",
                                                  "/v1/goodput")))
            traces = json.loads(asyncio.run(http(port, "GET", "/v1/traces")))
        out.update(check_face(cfg, params, tok, bodies, gen_bodies, passes,
                              generated, info, text, goodput, traces,
                              label))
        walls = {via: [] for via, _ in FACE_PASSES}
        for (via, _rep), answers in zip(FACE_PASSES, passes):
            walls[via].append([w * 1e3 for *_, w in answers])
        out.update({
            "k1_launches": counts["k1"], "k2_launches": counts["k2"],
            "metrics_scrape_ms": scrape_ms,
            "wall_ms_per_request": walls,
            "mean_wall_ms_by_pass": {
                f"{via}{rep}": sum(w for *_, w in answers) * 1e3
                / len(answers)
                for (via, rep), answers in zip(FACE_PASSES, passes)},
            **{f"mean_wall_ms_{via}": sum(map(sum, ms)) / sum(map(len, ms))
               for via, ms in walls.items()},
        })
        if device == "cuda" and (counts["k1"] < cfg.n_layers
                                 or (extra and counts["k2"] <= 0)):
            raise AssertionError(f"{label}: K1 {counts['k1']}, K2 "
                                 f"{counts['k2']} launches in the phase")
        if label == "bf16":
            out["slot_step"] = slot_step_with_ledger(cfg, params)
        result[label] = out
        del params
        torch.cuda.empty_cache()
    return result


def check_face(cfg, params, tok, bodies, gen_bodies, passes, generated,
               info, text, goodput, traces, label):
    """The phase's checks on one server's answers (drive_fleet_face)."""
    judged = []
    for i, (body, gen_body, want) in enumerate(zip(bodies, gen_bodies,
                                                   generated)):
        streamed = bool(body.get("stream"))
        for (via, rep), answers in zip(FACE_PASSES, passes):
            status, headers, data, _wall = answers[i]
            tokens, got_text, events = completion_of(status, data, streamed)
            if got_text != tok.decode(tokens):
                raise AssertionError(f"{via} {i}: text is not "
                                     "decode(tokens)")
            trace_id = f"{label}-{via}{rep}-{i}"
            if streamed:
                done = events[-1]
                if done["trace"] != trace_id or "prefill~" not in (
                        done["spans"]):
                    raise AssertionError(f"stream's done event {done}")
            elif headers.get("x-cp-trace") != trace_id or "prefill~" not in (
                    headers.get("x-cp-span-digest", "")):
                raise AssertionError(f"{via} {i}: trace headers {headers}")
            if tokens != want:
                for got in (tokens, want):
                    first, worst, _ = judge_served(cfg, params, gen_body, got)
                    if worst > NEAR_TIE_TOL:
                        raise AssertionError(
                            f"{via} {i}: completion {tokens} vs generate "
                            f"{want}: worst gap {worst}")
                judged.append({"request": i, "via": f"{via}{rep}",
                               "first_diff": next(
                    (j for j, (a, b) in enumerate(zip(tokens, want))
                     if a != b), min(len(tokens), len(want)))})
    # /metrics: the exact request tally, and the ledger's gauges
    types, samples = parse_exposition(text)
    sent = {("completions", "200"): len(FACE_PASSES) * len(bodies),
            ("generate", "200"): len(bodies), ("model", "200"): 1}
    counted = {(dict(k)["endpoint"], dict(k)["code"]): v
               for (name, k), v in samples.items()
               if name == "containerpilot_serve_requests_total"}
    if counted != sent:
        raise AssertionError(f"/metrics counted {counted}, sent {sent}")
    for family, kind in (("containerpilot_serve_requests_total", "counter"),
                         ("containerpilot_serve_request_seconds",
                          "histogram"),
                         ("cp_device_seconds_total", "gauge"),
                         ("cp_build_info", "gauge"),
                         ("cp_loop_lag_ms", "gauge")):
        if types.get(family) != kind:
            raise AssertionError(f"/metrics {family}: {types.get(family)}")
    stages = {dict(k)["stage"]: v for (name, k), v in samples.items()
              if name == "cp_device_seconds_total"}
    ledger_sum = sum(stages.values())
    if abs(ledger_sum - goodput["uptime_s"]) > LEDGER_REL_TOL * goodput[
            "uptime_s"] or stages["compile_warmup"] <= 0:
        raise AssertionError(f"ledger stages {stages} vs uptime "
                             f"{goodput['uptime_s']}")
    engine = info["slot_engine"]
    if (goodput["dispatches"], goodput["tokens_out"]) != (
            engine["dispatches"], engine["tokens_out"]) or (
            goodput["dispatches_per_token"] != round(
                engine["dispatches"] / engine["tokens_out"], 4)):
        raise AssertionError(f"/v1/goodput {goodput} vs engine {engine}")
    # /v1/traces: every id sent, with the engine's spans
    by_id = {t["trace_id"]: t for t in traces["recent"]}
    for via, rep in FACE_PASSES:
        for i in range(len(bodies)):
            trace = by_id.get(f"{label}-{via}{rep}-{i}")
            names = [s["stage"] for s in trace["spans"]] if trace else []
            if names[:3] != ["slot_queue_wait", "prefill", "decode"]:
                raise AssertionError(f"/v1/traces {label}-{via}{rep}-{i}: "
                                     f"{names}")
    return {
        "completions_equal_generate": (len(FACE_PASSES) * len(bodies)
                                       - len(judged)),
        "judged_near_ties": judged,
        "requests_counted": {f"{e}/{c}": v for (e, c), v in counted.items()},
        "ledger": {"uptime_s": goodput["uptime_s"],
                   "stages_s": goodput["stages_s"],
                   "metrics_stage_sum_s": ledger_sum,
                   "productive_fraction": goodput["productive_fraction"],
                   "transitions": goodput["transitions"]},
        "dispatches": goodput["dispatches"],
        "tokens_out": goodput["tokens_out"],
        "dispatches_per_token": goodput["dispatches_per_token"],
        "traces_found": len(FACE_PASSES) * len(bodies),
        "dominant_stages": sorted({by_id[f"{label}-mux0-{i}"].get(
            "dominant_stage") for i in range(len(bodies))} - {None}),
        "long_prompt_ids": len(gen_bodies[0]["tokens"][0]),
    }


# ---- serve_fleet_handoff: the torch replica in a fleet ------------------

HANDOFF_ARGS = ["--slots", "8", "--prefix-cache", "4", "--kv-spill-mb",
                "1024", "--mux", "--int8", "--fleet-ttl", "2"]
HANDOFF_NEW = 32  # greedy tokens of the judged requests


def http_status(port, method, path, body=None, timeout=60):
    """(status, lowercased headers, body) of one HTTP/1.1 request, any
    status (``http`` raises on non-200)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=json.dumps(body).encode()
                     if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                resp.read())
    finally:
        conn.close()


def timed_post(port, path, body):
    """(parsed JSON answer, wall s) of a POST that must answer 200."""
    t0 = time.perf_counter()
    status, _headers, data = http_status(port, "POST", path, body, 600)
    wall = time.perf_counter() - t0
    if status != 200:
        raise AssertionError(f"POST {path} -> {status}: {data[:200]!r}")
    return json.loads(data), wall


def weights_manifest_of(port):
    """The manifest at the head of a replica's GET /v1/weights (read,
    then the connection dropped)."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=300) as sock:
        sock.sendall(b"GET /v1/weights HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     b"Connection: close\r\n\r\n")
        fh = sock.makefile("rb")
        while fh.readline() not in (b"\r\n", b""):
            pass  # the response head; the body is the raw stream
        n = int.from_bytes(fh.read(8), "big")
        return json.loads(fh.read(n))


def catalog_fields(catalog, ids, absent=(), timeout=60):
    """{instance id: (instance, parsed note fields)} once every id in
    ``ids`` is registered without any field named in ``absent``, read
    with the port's own backend and note parsers."""
    from containerpilot_tpu_torch.discovery import FileCatalogBackend
    from containerpilot_tpu_torch.fleet import notes

    backend = FileCatalogBackend(catalog)
    deadline = time.monotonic() + timeout
    while True:
        seen = {}
        for inst in backend.instances("inference"):
            raw = notes.split_note(inst.notes)
            seen[inst.id] = (inst, {k: notes.parse_field(k, v)
                                    for k, v in raw.items()})
        if all(i in seen and not set(absent) & set(seen[i][1])
               for i in ids):
            return seen
        if time.monotonic() > deadline:
            raise AssertionError(f"catalog never showed {ids}: {seen}")
        time.sleep(0.1)


async def export_split(port, tokens):
    """(s to the response head, s from the head to the last byte, bytes)
    of one ``POST /v1/kv`` over cp-mux/1. The server copies the entry to
    the host and digests every chunk before it answers, so the first
    figure is its plan (plus one dial) and the second the stream alone;
    the bytes are read, not verified."""
    from containerpilot_tpu_torch.fleet.pool import dial_mux

    conn = await dial_mux("127.0.0.1", port, 30.0)
    if conn is None:
        raise AssertionError("the --mux server declined cp-mux/1")
    try:
        t0 = time.perf_counter()
        stream = await conn.open_stream(
            "POST", "/v1/kv", json.dumps({"tokens": [tokens]}).encode())
        status, _headers = await stream.response_head(300.0)
        head_s = time.perf_counter() - t0
        if status != 200:
            raise AssertionError(f"POST /v1/kv -> {status}")
        t0 = time.perf_counter()
        streamed = 0
        while True:
            piece = await stream.read_chunk(300.0)
            if not piece:
                break
            streamed += len(piece)
        return head_s, time.perf_counter() - t0, streamed
    finally:
        conn.close("export timed")


class Counts:
    """A CountedServe's K1/K2 counters: zeroed once when the phase
    starts driving it, read as deltas around each request after."""

    def __init__(self, srv):
        self.srv = srv
        self.last = srv.counts(zero=True)

    def delta(self):
        now = self.srv.counts()
        out = {k: now[k] - self.last[k] for k in now}
        self.last = now
        return out

    def total(self):
        return self.srv.counts()


#: the port's gateway in front of phase 19's replicas
GATEWAY_ARGS = ["--poll-interval", "0.2", "--no-hedge", "--retries", "3",
                "--drain-window", "10"]
#: the families the reference gateway registers (``_created`` companions
#: aside); tests/test_torch_fleet_gateway.py holds this list to it
GATEWAY_FAMILIES = frozenset((
    "containerpilot_gateway_admission_depth",
    "containerpilot_gateway_admission_inflight",
    "containerpilot_gateway_admitted_total",
    "containerpilot_gateway_cache_hint_hits_total",
    "containerpilot_gateway_cache_hint_misses_total",
    "containerpilot_gateway_catalog_flaps_damped_total",
    "containerpilot_gateway_conns_saved_by_mux_total",
    "containerpilot_gateway_deadline_expired_total",
    "containerpilot_gateway_drained_away_total",
    "containerpilot_gateway_fleet_tokens_reused",
    "containerpilot_gateway_handoff_bytes_total",
    "containerpilot_gateway_handoff_ms",
    "containerpilot_gateway_handoffs_failed_total",
    "containerpilot_gateway_handoffs_total",
    "containerpilot_gateway_healthy_replicas",
    "containerpilot_gateway_hedged_total",
    "containerpilot_gateway_migration_failed_total",
    "containerpilot_gateway_migration_timeout_total",
    "containerpilot_gateway_mux_cancels_total",
    "containerpilot_gateway_mux_streams_total",
    "containerpilot_gateway_pool_evicted_total",
    "containerpilot_gateway_pool_hit_total",
    "containerpilot_gateway_pool_miss_total",
    "containerpilot_gateway_replicas_by_role",
    "containerpilot_gateway_request_seconds",
    "containerpilot_gateway_requests_total",
    "containerpilot_gateway_retried_total",
    "containerpilot_gateway_routed_total",
    "containerpilot_gateway_sessions_migrated_total",
    "containerpilot_gateway_shed_total",
    "containerpilot_gateway_standby_replicas",
    "containerpilot_gateway_sticky_evicted_total",
    "cp_build_info",
    "cp_fleet_productive_fraction",
    "cp_loop_lag_ms",
    "cp_request_stage_seconds",
))


class GatewayCLI:
    """``python -m containerpilot_tpu_torch.fleet`` in a subprocess on a
    free port, over a file catalog. Entering only starts it (a thread
    notes ``ready_s``, the seconds until its /fleet first answers), so
    its start-up runs beside the replicas'; ``fleet`` waits for it to
    answer. Exit sends SIGTERM (the gateway drains, then exits) and
    keeps the exit code."""

    def __init__(self, catalog, timeout=120):
        self.catalog, self.timeout = catalog, timeout
        self.proc, self.rc, self.log = None, None, ""
        self.ready_s = None

    def __enter__(self):
        root = os.path.dirname(os.path.abspath(__file__))
        self.port = _free_port()
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "containerpilot_tpu_torch.fleet",
             "--catalog", f"file:{self.catalog}", "--host", "127.0.0.1",
             "--port", str(self.port), *GATEWAY_ARGS],
            cwd=root, env={**os.environ, "PYTHONPATH": root},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def note_ready():
            while self.proc.poll() is None:
                try:
                    http_status(self.port, "GET", "/fleet", timeout=5)
                except OSError:
                    time.sleep(0.05)
                    continue
                self.ready_s = time.perf_counter() - t0
                return

        threading.Thread(target=note_ready, daemon=True).start()
        return self

    def get(self, path):
        status, _headers, data = http_status(self.port, "GET", path)
        if status != 200:
            raise AssertionError(f"gateway GET {path} -> {status}")
        return data.decode()

    def fleet(self):
        deadline = time.monotonic() + self.timeout
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"gateway exited {self.proc.returncode}:"
                                     f" {self.proc.communicate()[0][-2000:]}")
            try:
                return json.loads(self.get("/fleet"))
            except OSError:
                if time.monotonic() > deadline:
                    raise AssertionError("the gateway never answered")
                time.sleep(0.2)

    def wait_roles(self, want, timeout=60):
        """/fleet once its replicas' roles are ``want`` ({id: role})."""
        deadline = time.monotonic() + timeout
        while True:
            fleet = self.fleet()
            roles = {r["id"]: r["role"] for r in fleet["replicas"]}
            if roles == want:
                return fleet
            if time.monotonic() > deadline:
                raise AssertionError(f"gateway roles {roles}, want {want}")
            time.sleep(0.1)

    def metrics(self):
        """/metrics parsed: ({family: type}, {(sample, labels): value})."""
        return parse_exposition(self.get("/metrics"))

    def __exit__(self, *exc):
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            self.log = self.proc.communicate(timeout=60)[0]
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.log = self.proc.communicate()[0]
        self.rc = self.proc.returncode


def counter_by(samples, name, label):
    """{label value: value} of one labelled counter's samples."""
    return {dict(labels).get(label): value
            for (sample, labels), value in samples.items()
            if sample == name}


def drive_fleet_handoff(tmp, card, model=FACE_MODEL, device="cuda",
                        prompt_len=PROMPT_LEN):
    """Phase 19: three serve CLIs at FACE_MODEL (the flagship's width),
    int8, seeded weights, in one file catalog: A (--role prefill), B
    (--role decode) and C (--standby --weights-from A). A prefills a
    1024-id prompt (/v1/prefill: K1 exactly n_layers times); B pulls its
    KV (/v1/kv/pull) and serves the prompt greedily with K1 launched 0
    times and readmitted +1, the tokens A serves; B's time to first
    token on a pulled entry against a local 1024-id prefill; C's
    weights, fetched from A, equal A's chunk digest by chunk digest, and
    C serves A's tokens once promoted; draining B migrates its sessions
    to C (a drain skips the prefill pool, A), its refusal names C in
    X-CP-Migrated-To, and C then serves the first prompt with K1 0 times
    and readmitted +1; C adopts A's kernel build directory (cc=).
    The port's gateway (``python -m containerpilot_tpu_torch.fleet``,
    started beside A and B) fronts them: a greedy 1024-id request
    through it takes the disaggregated path (A's /v1/prefill launches K1
    n_layers times, B decodes the pulled entry with K1 0 times, one
    handoff of the entry's bytes counted), its /fleet shows each role
    (C standby, then active), session-pinned requests through it see no
    5xx while B drains and the first prompt's session lands on C, its
    /metrics carries the reference gateway's families, and it never
    opens the card. Reports the KV entry's and the weights' bytes,
    seconds and GB/s, the promote latency, the gateway's figures and
    each replica's K1/K2 launches. ``device="cpu"`` drives the same path on the plain
    versions (no kernel to count), for a small ``model``."""
    import random

    from containerpilot_tpu_torch.fleet.standby import (
        _chunk_digest,
        fetch_weight_chunks,
    )
    from containerpilot_tpu_torch.kvtier.digest import prefix_fingerprint
    from containerpilot_tpu_torch.kvtier.handoff import (
        encode_kv_manifest,
        fetch_kv_chunks,
        kv_transfer_plan,
        rebuild_kv,
    )
    from containerpilot_tpu_torch.workload import serve_cli

    catalog = os.path.join(tmp, "handoff_catalog")
    base = ["--device", device, *model, *HANDOFF_ARGS,
            "--fleet-catalog", f"file:{catalog}"]
    args = serve_cli.build_arg_parser().parse_args(base)
    n_layers, vocab = args.n_layers, args.vocab
    on_card = device == "cuda"
    rng = random.Random(19)
    p1, p2, p3, p5, p6 = ([rng.randrange(vocab) for _ in range(prompt_len)]
                          for _ in range(5))

    def greedy(row, new=HANDOFF_NEW):
        return {"tokens": [row], "max_new_tokens": new}

    def readmitted(port):
        info = json.loads(asyncio.run(http(port, "GET", "/v1/model")))
        return info["prefix_cache"]["readmitted"]

    def served(port, body):
        rows, wall = asyncio.run(generate_tokens(port, body))
        check_rows(rows, 1, body["max_new_tokens"], vocab)
        return rows[0], wall

    def subdir(name):
        path = os.path.join(tmp, f"handoff_{name}")
        os.makedirs(path, exist_ok=True)
        return path

    result = {"phase": "serve_fleet_handoff", "model": model,
              "args": HANDOFF_ARGS, **card}
    a_args = [*base, "--role", "prefill", "--fleet-id", "A",
              "--migrate-window", "0"]
    b_args = [*base, "--role", "decode", "--fleet-id", "B",
              "--migrate-window", "120"]
    c_args = [*base, "--fleet-id", "C", "--migrate-window", "0"]
    launches = {}
    with GatewayCLI(catalog) as gw, \
            CountedServe(a_args, subdir("a")) as a, \
            CountedServe(b_args, subdir("b")) as b:
        seen = catalog_fields(catalog, ["A", "B"], timeout=120)
        roles = {i: seen[i][1].get("role") for i in ("A", "B")}
        if roles != {"A": "prefill", "B": "decode"}:
            raise AssertionError(f"catalog roles {roles}")
        result["catalog_fields"] = {i: sorted(seen[i][1]) for i in seen}
        ca, cb = Counts(a), Counts(b)

        # -- A prefills; B pulls the entry and decodes from it --------
        pre, result["prefill_wall_s"] = timed_post(
            a.port, "/v1/prefill", {"tokens": [p1]})
        k_prefill = ca.delta()
        if not pre["cached"] or (on_card and k_prefill["k1"] != n_layers):
            raise AssertionError(f"/v1/prefill: {pre}, {k_prefill}")
        t0 = time.perf_counter()
        manifest, chunks = asyncio.run(fetch_kv_chunks(
            "127.0.0.1", a.port, p1, read_timeout=300.0))
        export_s = time.perf_counter() - t0
        kv_bytes = manifest["total_bytes"]
        # the export again, split where the server's work ends: A copies
        # the entry to the host and digests it before the response head
        head_s, stream_s, streamed = asyncio.run(
            export_split(a.port, p1))
        if streamed != len(encode_kv_manifest(manifest)) + kv_bytes:
            raise AssertionError(f"split export streamed {streamed} B")
        # host work the client does after export_s: re-hashing every
        # chunk and reassembly; and A's plan without the device copy
        t0 = time.perf_counter()
        for chunk in chunks:
            _chunk_digest(chunk)
        digest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host_entry = rebuild_kv(manifest, chunks)
        rebuild_s = time.perf_counter() - t0
        del chunks
        t0 = time.perf_counter()
        kv_transfer_plan(host_entry)
        plan_host_s = time.perf_counter() - t0
        del host_entry
        before = readmitted(b.port)
        cb.delta()
        pull, pull_s = timed_post(b.port, "/v1/kv/pull", {
            "tokens": [p1], "from": f"127.0.0.1:{a.port}"})
        if pull["bytes"] != kv_bytes:
            raise AssertionError(f"pulled {pull['bytes']} of {kv_bytes}")
        got_b, wall_b = served(b.port, greedy(p1))
        k_b = cb.delta()
        readmit_b = readmitted(b.port) - before
        if readmit_b != 1 or k_b["k1"] != 0 or (on_card and k_b["k2"] <= 0):
            raise AssertionError(f"B on the pulled prompt: readmitted "
                                 f"+{readmit_b}, launches {k_b}")
        got_a, wall_a = served(a.port, greedy(p1))
        result["kv"] = {
            "total_bytes": kv_bytes, "leaves": manifest["leaves"],
            "chunks": len(manifest["chunks"]),
            "export_s": export_s, "export_gb_s": kv_bytes / export_s / 1e9,
            "split_head_s": head_s, "split_stream_s": stream_s,
            "split_stream_gb_s": streamed / stream_s / 1e9,
            "plan_host_s": plan_host_s,
            "digest_s": digest_s, "rebuild_s": rebuild_s,
            "pull_s": pull_s, "pull_gb_s": kv_bytes / pull_s / 1e9,
            "pull_server_ms": pull["ms"],
            "b_generate_wall_s": wall_b, "a_generate_wall_s": wall_a,
            "b_readmitted": readmit_b, "b_launches": k_b,
            "tokens_equal": got_b == got_a,
        }

        # -- time to first token: local prefill against a pulled entry
        _, ttft_local = served(b.port, greedy(p2, 1))
        k_local = cb.delta()
        timed_post(a.port, "/v1/prefill", {"tokens": [p3]})
        _, pull3_s = timed_post(b.port, "/v1/kv/pull", {
            "tokens": [p3], "from": f"127.0.0.1:{a.port}"})
        cb.delta()
        _, ttft_pulled = served(b.port, greedy(p3, 1))
        k_pulled = cb.delta()
        if on_card and (k_local["k1"] != n_layers or k_pulled["k1"]):
            raise AssertionError(f"TTFT requests: K1 {k_local} local, "
                                 f"{k_pulled} pulled")
        result["ttft"] = {
            "local_prefill_ms": ttft_local * 1e3,
            "pulled_entry_ms": ttft_pulled * 1e3,
            "pull_ms": pull3_s * 1e3,
            "pull_then_first_token_ms": (pull3_s + ttft_pulled) * 1e3,
            "local_launches": k_local, "pulled_launches": k_pulled,
        }

        # -- (a) the gateway's disaggregated path -----------------------
        before = gw.wait_roles({"A": "prefill", "B": "decode"})["handoff"]
        ca.delta()
        cb.delta()
        got_g, wall_g = served(gw.port, greedy(p6))
        k_ga, k_gb = ca.delta(), cb.delta()
        fleet = gw.fleet()
        handoff = {k: fleet["handoff"][k] - before[k] for k in before}
        if (handoff["total"] != 1 or handoff["failed"]
                or handoff["bytes"] != kv_bytes):
            raise AssertionError(f"gateway handoff {handoff}, entry "
                                 f"{kv_bytes} B")
        if k_gb["k1"] != 0 or (on_card and (k_ga["k1"] != n_layers
                                            or k_gb["k2"] <= 0)):
            raise AssertionError(f"through the gateway: A {k_ga}, B {k_gb}")
        got_a6, wall_a6 = served(a.port, greedy(p6))
        # (e) the gateway never opens the card
        held = _nvidia_files(gw.proc.pid)
        if held:
            raise AssertionError(f"the gateway holds {held}")
        result["gateway"] = {
            "ready_s": gw.ready_s, "args": GATEWAY_ARGS,
            "disagg_wall_s": wall_g,
            "direct_prefill_pull_generate_s": (
                result["prefill_wall_s"] + pull_s + wall_b),
            "handoff_bytes": handoff["bytes"],
            "handoff_ms": handoff["ms_sum"],
            "a_launches": k_ga, "b_launches": k_gb,
            "a_direct_wall_s": wall_a6, "tokens_equal": got_g == got_a6,
            "nvidia_files": held,
        }

        # -- C: a standby whose weights come from A --------------------
        t0 = time.perf_counter()
        wm, wchunks = asyncio.run(fetch_weight_chunks(
            "127.0.0.1", a.port, read_timeout=600.0))
        fetch_s = time.perf_counter() - t0
        del wchunks
        c_args += ["--standby", "--weights-from", f"127.0.0.1:{a.port}"]
        with CountedServe(c_args, subdir("c")) as c:
            cc = Counts(c)
            seen = catalog_fields(catalog, ["C"], timeout=120)
            if seen["C"][1].get("role") != "standby":
                raise AssertionError(f"C's note: {seen['C'][1]}")
            gw.wait_roles({"A": "prefill", "B": "decode", "C": "standby"})
            cm = weights_manifest_of(c.port)
            if cm["leaves"] != wm["leaves"] or cm["chunks"] != wm["chunks"]:
                raise AssertionError("C's weight digests differ from A's")
            t0 = time.perf_counter()
            promoted, _ = timed_post(c.port, "/v3/standby/promote", {})
            promote_ms = (time.perf_counter() - t0) * 1e3
            if not promoted["promoted"] or http_status(
                    c.port, "GET", "/health")[0] != 200:
                raise AssertionError(f"promote: {promoted}")
            short = greedy(p5[: prompt_len // 2])
            got_c5, _ = served(c.port, short)
            got_a5, _ = served(a.port, short)
            result["weights"] = {
                "total_bytes": wm["total_bytes"], "leaves": len(wm["leaves"]),
                "chunks": len(wm["chunks"]), "fetch_s": fetch_s,
                "fetch_gb_s": wm["total_bytes"] / fetch_s / 1e9,
                "c_ready_s": c.ready_s, "digests_equal": True,
                "promote_ms": promote_ms,
                "tokens_equal_after_promote": got_c5 == got_a5,
            }
            # the promotion's beat drops role=, so C is now a survivor
            catalog_fields(catalog, ["C"], absent=("role",), timeout=30)
            gw.wait_roles({"A": "prefill", "B": "decode", "C": "active"})
            result["gateway"]["roles_seen"] = [
                "A=prefill B=decode", "C=standby", "C=active"]

            # -- (c) the first prompt's session, pinned to B (its
            # digest is warm), then session traffic through the drain
            first = {**greedy(p1), "session_id": "first"}
            _types, samples = gw.metrics()
            routed0 = counter_by(samples, "containerpilot_gateway_routed_total",
                                 "replica")
            served(gw.port, first)
            _types, samples = gw.metrics()
            routed1 = counter_by(samples, "containerpilot_gateway_routed_total",
                                 "replica")
            if routed1.get("B", 0) - routed0.get("B", 0) != 1:
                raise AssertionError(f"the first session's pin: {routed1}")
            # each background request leaves (end time, status) or
            # (end time, the exception it raised): one record a request
            stop_bg, bg_sent, bg_done = threading.Event(), [0], []

            def session_traffic():
                shorts = [[(7 * i + j) % vocab for j in range(8)]
                          for i in range(4)]
                i = 0
                while not stop_bg.is_set():
                    body = {"tokens": [shorts[i % 4]], "max_new_tokens": 4,
                            "session_id": f"bg{i % 4}"}
                    bg_sent[0] += 1
                    try:
                        got = http_status(gw.port, "POST", "/v1/generate",
                                          body, 120)[0]
                    except Exception as exc:  # noqa: BLE001 - checked below
                        got = repr(exc)
                    bg_done.append((time.perf_counter(), got))
                    i += 1

            first_turns = [http_status(gw.port, "POST", "/v1/generate", {
                "tokens": [[(7 * i + j) % vocab for j in range(8)]],
                "max_new_tokens": 4, "session_id": f"bg{i}"}, 120)[0]
                for i in range(4)]  # the background sessions' first turns
            if first_turns != [200] * 4:
                raise AssertionError(f"the sessions' first turns: "
                                     f"{first_turns}")
            bg = threading.Thread(target=session_traffic, daemon=True)

            # -- drain B: its sessions migrate to C ---------------------
            launches["B"] = cb.total()
            before_c = readmitted(c.port)
            cc.delta()
            bg.start()
            b.proc.send_signal(signal.SIGTERM)
            refusal, landed, t_term = None, {}, time.perf_counter()
            while b.proc.poll() is None and refusal is None:
                try:
                    status, headers, _ = http_status(
                        b.port, "POST", "/v1/generate", greedy(p1, 4), 30)
                    t_alive = time.perf_counter()  # B answered: alive
                    landed = json.loads(http_status(
                        b.port, "POST", "/v1/migrate", {})[2])["landed"]
                except OSError:
                    break
                if status == 503 and "x-cp-migrated-to" in headers:
                    refusal = headers
                if time.perf_counter() - t_term > 150:
                    raise AssertionError("B's drain never finished")
                time.sleep(0.05)
            if refusal is None or refusal["x-cp-migrated-to"] != "C":
                raise AssertionError(f"B's refusal while draining: "
                                     f"{refusal}, landed {landed}")
            # let at least 4 session requests finish while B is seen
            # still draining (its drain took 11-15 s on the card)
            while True:
                n_draining = sum(t_term < t <= t_alive for t, _ in bg_done)
                if (n_draining >= 4 or not bg.is_alive()
                        or time.perf_counter() - t_term > 120):
                    break
                time.sleep(0.05)
                now = time.perf_counter()
                if b.proc.poll() is not None:
                    break
                t_alive = now
            stop_bg.set()
            bg.join(timeout=150)
            bg_status = [got for _, got in bg_done]
            if (bg.is_alive() or len(bg_done) != bg_sent[0]
                    or n_draining < 4
                    or any(not isinstance(x, int) for x in bg_status)):
                raise AssertionError(
                    f"session traffic through the drain: thread alive "
                    f"{bg.is_alive()}, {len(bg_done)} answered of "
                    f"{bg_sent[0]} sent, {n_draining} finished while B "
                    f"drained, {[x for x in bg_status if not isinstance(x, int)][:3]}")
            cc.delta()  # the background turns' launches
            got_c, wall_c = served(gw.port, first)
            k_c = cc.delta()
            readmit_c = readmitted(c.port) - before_c
            if readmit_c != 1 or k_c["k1"] != 0:
                raise AssertionError(f"C on the migrated prompt: readmitted "
                                     f"+{readmit_c}, launches {k_c}")
            # C stays up until B's drain has pushed every session
            b.proc.wait(timeout=300)
            drain_s = time.perf_counter() - t_term
            gw.wait_roles({"A": "prefill", "C": "active"})
            fleet = gw.fleet()
            _types, samples = gw.metrics()
            codes = counter_by(samples, "containerpilot_gateway_requests_total",
                               "code")
            result["gateway"]["drain"] = {
                "session_requests": len(bg_status),
                "session_requests_while_b_drained": n_draining,
                "session_statuses": sorted(set(bg_status)),
                "migration": fleet["migration"],
                "retried": counter_by(
                    samples, "containerpilot_gateway_retried_total",
                    "replica"),
                "requests_by_code": codes,
            }
            fives = {c: n for c, n in codes.items() if c.startswith("5")}
            if fives or any(x >= 500 for x in bg_status):
                raise AssertionError(f"5xx through the gateway: {codes}")
            result["gateway"]["metric_families"] = len(_types)
            families = {f for f in _types if not f.endswith("_created")}
            if families != GATEWAY_FAMILIES:
                raise AssertionError(
                    f"gateway families: {families ^ GATEWAY_FAMILIES}")
            result["migration"] = {
                "drain_s": drain_s,
                "retry_after": refusal.get("retry-after"),
                "migrated_to": refusal["x-cp-migrated-to"],
                "landed": landed.get(f"{prefix_fingerprint(p1):08x}"),
                "c_readmitted": readmit_c, "c_launches": k_c,
                "c_generate_wall_s": wall_c,
                "tokens_equal": got_c == got_a,
            }
            launches["A"] = ca.total()
            launches["C"] = cc.total()
        # C's boot: the peer's weights, and (on the card) A's kernel
        # build directory adopted from its cc= note, so no nvcc ran
        result["c_log"] = [line for line in c.log.splitlines() if any(
            k in line for k in ("weights fetched", "adopted fleet kernel",
                                "CUDA kernels ready"))]
    if gw.rc != 0:
        raise AssertionError(f"gateway exit {gw.rc}: {gw.log[-2000:]}")
    moved = re.findall(r"migration moved (\d+)/(\d+) entries \((\d+) "
                       r"bytes, (\d+) failed, (\d+) timed out", b.log)
    if (not any("weights fetched" in x for x in result["c_log"])
            or (on_card and not any("adopted fleet kernel" in x
                                    for x in result["c_log"]))
            or len(moved) != 1
            or moved[0][0] != moved[0][1] or moved[0][3] != "0"):
        raise AssertionError(f"B's log: {b.log[-1500:]} C's log: "
                             f"{c.log[-1500:]}")
    done, total, moved_bytes, _failed, _late = map(int, moved[0])
    # the reference gateway's accounting: every entry B's drain moved is
    # a migrated session (mg= deltas), each 503 it answered a retry,
    # and the first prompt's pin followed it to C
    drain_g = result["gateway"]["drain"]
    mig = drain_g["migration"]
    if (mig["sessions_migrated"] != done or mig["failed"] or mig["timeout"]
            or mig["pins_repointed"] + mig["drain_answers"] < 1
            or drain_g["retried"].get("B", 0) < mig["drain_answers"]):
        raise AssertionError(f"gateway drain counters {drain_g}, B moved "
                             f"{done}")
    result["migration"].update({
        "entries": total, "bytes": moved_bytes,
        "gb_s_over_drain": moved_bytes / result["migration"]["drain_s"]
        / 1e9})
    # every answer A's (or, past a near tie, each held to solo decoding)
    answers = [("B_pulled", greedy(p1), got_b, got_a),
               ("gateway_disagg", greedy(p6), got_g, got_a6),
               ("C_promoted", short, got_c5, got_a5),
               ("C_migrated", greedy(p1), got_c, got_a)]
    differ = [x for x in answers if x[2] != x[3]]
    if differ:
        if not on_card:
            raise AssertionError(f"tokens differ from A's: {differ}")
        cfg, params, _ = serve_cli.load_model(args)
        judged = {}
        for name, body, got, want in differ:
            for who, toks in ((name, got), (f"A_for_{name}", want)):
                first, worst, typical = judge_served(cfg, params, body, toks)
                if worst > NEAR_TIE_TOL:
                    raise AssertionError(f"{who}: gap {worst} at {first}")
                judged[who] = {"first_diff": first, "worst_gap": worst,
                               "typical_gap": typical}
        result["judged"] = judged
        del params
        torch.cuda.empty_cache()
    launches["A_prefill"] = k_prefill
    launches["A_gateway"] = result["gateway"]["a_launches"]
    launches["B_gateway"] = result["gateway"]["b_launches"]
    launches["C_gateway_migrated"] = k_c
    result["launches"] = launches
    return result


# ---------------------------------------------------------------------------
# phases 20-23: a switch-routed mixture of experts from trainer to server
# ---------------------------------------------------------------------------

# the flagship with 8 experts in place of its SwiGLU (4.70 B parameters),
# trained at the repo's training configuration with 8 experts, drop-free
# and with capacity factor 1.25; the expert half alone at E = 4 and 8
MOE_EXPERTS = 8
MOE_CAPACITY = 1.25
MOE_HALF_EXPERTS = (4, 8)
# drive_server's 1024-token prefills: two greedy 32-token requests, two
# 1-token ones, the 4-row batch and four 8-row batches (one K1 launch a
# layer each)
SERVER_PREFILLS = 9


def judge_against_plain(cfg, params, prompt, served):
    """A greedy serve_moe request held to the plain attention path
    (flash_min_seq=0). judge_served teacher-forces solo decoding on the
    served tokens: each the plain path's choice or a near tie within
    NEAR_TIE_TOL. Then one forward of the 1024-token prompt through K1
    against one plain forward whose routes are pinned to the kernel
    forward's (routes_of): a top-1 route is discontinuous, so a rounding
    difference can send a token to another expert and move its logits
    by far more than the rounding. Every route the plain forward would
    have taken otherwise must be a near tie (flip_summary), and the
    logits at the last 64 positions are held within E2E_REL_TOL."""
    import dataclasses

    from containerpilot_tpu_torch.models import transformer as tf

    plain = dataclasses.replace(cfg, flash_min_seq=0)
    body = {"tokens": [prompt], "max_new_tokens": len(served)}
    first, worst, typical = judge_served(plain, params, body, served)
    toks = torch.tensor([prompt], device="cuda")
    routes, flips = {}, []
    with torch.inference_mode():
        with routes_of(routes):
            via_kernel = tf.forward(params, toks, cfg)[0, -64:]
        with routes_of(routes, pin=True, flips=flips):
            via_plain = tf.forward(params, toks, plain)[0, -64:]
    e2e = logits_rel_err(via_kernel, via_plain)
    if not (torch.isfinite(via_kernel).all() and e2e <= E2E_REL_TOL
            and worst <= NEAR_TIE_TOL):
        raise AssertionError(
            f"MoE served tokens or logits off the plain path: worst gap "
            f"{worst}, first differing position {first}, logits rel err "
            f"{e2e} on pinned routes")
    return {"plain_path": {"equal": first is None, "first_diff": first,
                           "worst_gap": worst,
                           "median_vocab_gap_at_0": typical},
            "route_flips_plain_vs_kernel": flip_summary(
                flips, cfg.n_layers * len(prompt)),
            "logits_rel_err_vs_plain_pinned_routes": e2e}


def drive_serve_moe(prompt):
    """serve_moe and serve_slots_moe: the flagship with MOE_EXPERTS
    experts (seeded float32 masters, cast once), served by the Batcher
    over HTTP in bf16, then through the slot engine in bf16, then by the
    Batcher again with int8 weights (quantized from the same masters).
    K1 must launch n_layers times a 1024-token prefill; K2 never: the
    int8 MoE layer dequantizes in full (can_fuse_int8 refuses an MoE
    tree). Each phase frees its model before the next one is built."""
    from containerpilot_tpu_torch.models import quantized
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import flash, quant
    from containerpilot_tpu_torch.parallel.train import tree_leaves

    moe_cfg = {**FLAGSHIP, "n_layers": CUT_LAYERS}
    cfg = tf.TransformerConfig(**moe_cfg, moe_experts=MOE_EXPERTS)
    masters = tf.init_params(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(masters))
    params = quantized.cast_params(masters, cfg.dtype)
    out = {"phase": "serve_moe",
           "config": {**moe_cfg, "moe_experts": MOE_EXPERTS},
           "params": n_params}
    slots = None
    for label in ("bf16", "int8"):
        if label == "int8":
            del params
            gc.collect()  # a stopped server's reference cycles
            torch.cuda.empty_cache()
            params = quantized.cast_params(
                quantized.quantize_model_params(masters), cfg.dtype)
            del masters
            torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        flash.LAUNCHES = quant.LAUNCHES = 0
        run = asyncio.run(drive_server(cfg, params, prompt,
                                       f"serve_moe_{label}"))
        k1, k2 = flash.LAUNCHES, quant.LAUNCHES
        run.update({
            "k1_launches": k1, "k2_launches": k2,
            "k1_launches_per_prefill": k1 / SERVER_PREFILLS,
            "resident_param_bytes": quantized.param_bytes(params),
            "device_bytes_at_start": resident,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        })
        want_k1 = cfg.n_layers * k1_forwards(
            cfg, [len(prompt)] * SERVER_PREFILLS + [SAMPLED_LEN] * 2)
        if k1 != want_k1 or k2 != 0:
            raise AssertionError(
                f"serve_moe_{label}: K1 {k1} launches (want "
                f"{want_k1}), K2 {k2} (want 0)")
        run.update(judge_against_plain(cfg, params, prompt,
                                       run.pop("greedy_tokens")))
        run.pop("phase")
        out[label] = run
        if label == "bf16":
            slots = asyncio.run(drive_slots(cfg, params, prompt,
                                            "serve_slots_moe",
                                            profiled=True))
            admissions = [len(r["tokens"][0]) for r in
                          slot_requests(prompt, cfg.vocab_size)]
            if slots["k1_launches"] != cfg.n_layers * k1_forwards(
                    cfg, admissions) or slots["k2_launches"] != 0:
                raise AssertionError(
                    f"serve_slots_moe: K1 {slots['k1_launches']} launches "
                    f"(two 1024-token admissions), K2 "
                    f"{slots['k2_launches']}")
            slots["config"] = out["config"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out, slots


def drive_train_moe(gen):
    """train_moe: TRAIN_CFG with MOE_EXPERTS experts through
    drive_training, drop-free and with capacity MOE_CAPACITY: K1/K3/K4
    counted around the steps, the loss falls, one loss value+grad at
    batch 2 against plain attention. MFU bills top-1 expert work only
    (workload/flops.py), so the drop-free step's dense dispatch
    ((E - 1) / E of its expert work) is not in the figure."""
    out = {"phase": "train_moe"}
    for label, over in (
        ("drop_free", {"moe_experts": MOE_EXPERTS}),
        ("capacity", {"moe_experts": MOE_EXPERTS,
                      "moe_train_capacity": MOE_CAPACITY}),
    ):
        run = drive_training(gen, f"train_moe_{label}", over, extra=False)
        run.pop("phase")
        out[label] = run
    return out


def time_expert_half(gen):
    """One layer's feed-forward half (transformer._ffn: norm, route,
    experts, gate, residual) at the flagship's widths, E in
    MOE_HALF_EXPERTS, seeded weights: at a 1024-token prefill against
    its operations bound, the dense dispatch's work (every expert over
    every token) and the top-1 work side by side; at an 8-row decode
    against its bytes bound (every expert's weights read once); the
    int8 layer at the decode shape, dequantized per call as the serving
    path does it, against its bytes bound (int8 weights and scales);
    and the dense SwiGLU half at the same widths beside each."""
    from containerpilot_tpu_torch.models import quantized
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops.quant import quantize_int8_axes

    d, f = FLAGSHIP["d_model"], FLAGSHIP["d_ff"]
    dt = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    dense_cfg = tf.TransformerConfig(**FLAGSHIP)
    dense_lp = {"norm_mlp": torch.ones(d, device="cuda", dtype=dt),
                "w_gate": randn(d, f, scale=d ** -0.5).to(dt),
                "w_up": randn(d, f, scale=d ** -0.5).to(dt),
                "w_down": randn(f, d, scale=f ** -0.5).to(dt)}
    shapes = {"prefill": (1, PROMPT_LEN), "decode": (8, 1)}
    rows = []
    with torch.inference_mode():
        for n_experts in MOE_HALF_EXPERTS:
            cfg = tf.TransformerConfig(**FLAGSHIP, moe_experts=n_experts)
            w_in = randn(n_experts, d, f, scale=d ** -0.5)
            w_out = randn(n_experts, f, d, scale=f ** -0.5)
            lp = {"norm_mlp": dense_lp["norm_mlp"],
                  "router": randn(d, n_experts, scale=d ** -0.5),
                  "moe_w_in": w_in.to(dt), "moe_w_out": w_out.to(dt)}
            qlp = {"norm_mlp": lp["norm_mlp"], "router": lp["router"]}
            for key, w in (("moe_w_in", w_in), ("moe_w_out", w_out)):
                qlp[key + "_q"], qlp[key + "_s"] = quantize_int8_axes(w, (1,))
            del w_in, w_out
            weight_bytes = 2 * n_experts * d * f * 2 + d * n_experts * 4
            row = {"experts": n_experts}
            for label, (b, s) in shapes.items():
                tokens = b * s
                xs = [(randn(b, s, d).to(dt),)
                      for _ in range(copies_for(tokens * d * 2))]
                ms = cuda_ms(lambda x: tf._ffn(x, lp, cfg)[0], xs)
                dense_flops = 2 * 2 * tokens * d * f * n_experts
                nbytes = weight_bytes + 2 * tokens * d * 2
                entry = {
                    "shape": f"b={b} s={s} d={d} f={f} E={n_experts}",
                    "ms": ms,
                    "dense_dispatch_flops": dense_flops,
                    "top1_flops": dense_flops // n_experts,
                    "bound_ms_dense_dispatch_operations":
                        dense_flops / BF16_FLOP_PER_S * 1e3,
                    "bound_ms_top1_operations":
                        dense_flops / n_experts / BF16_FLOP_PER_S * 1e3,
                    "bound_ms_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                    "dense_dispatch_tflops": dense_flops / ms / 1e9,
                    "dense_swiglu_ms": cuda_ms(
                        lambda x: tf._mlp(x, dense_lp, dense_cfg), xs),
                }
                if label == "decode":
                    entry["int8_ms"] = cuda_ms(
                        lambda x: tf._ffn(x, quantized.maybe_dequant_layer(
                            qlp, dt), cfg)[0], xs)
                    int8_bytes = (2 * n_experts * d * f  # int8 weights
                                  + n_experts * (f + d) * 4  # scales
                                  + d * n_experts * 4 + 2 * tokens * d * 2)
                    entry["int8_bound_ms_bytes"] = (
                        int8_bytes / HBM_BYTES_PER_S * 1e3)
                row[label] = entry
            rows.append(row)
            del lp, qlp
            torch.cuda.empty_cache()
    return {"phase": "moe_expert_half", "results": rows}


def drive_moe(gen, prompt, card):
    """Phases 20-23 in order, each emitted as it ends; returns them for
    the kernel summary."""
    half = time_expert_half(gen)
    emit({**half, **card})
    serve_moe, slots_moe = drive_serve_moe(prompt)
    emit({**serve_moe, **card})
    emit({**slots_moe, **card})
    train_moe = drive_train_moe(gen)
    emit({**train_moe, **card})
    return serve_moe, slots_moe, train_moe


# ---------------------------------------------------------------------------
# phase 24: training across ranks (train_parallel)
# ---------------------------------------------------------------------------

# the training configuration at a quarter of its depth (2 layers): its
# full width and shapes, the layouts' worlds inside the script's time
PARALLEL_CFG = {**TRAIN_CFG, "n_layers": 2}
# (name, ranks, mesh plan, options, config overrides of PARALLEL_CFG):
# the layouts of one world size run in one launch of its ranks, in order
PARALLEL_LAYOUTS = [
    ("dp2_zero1", 2, {"data": 2, "model": 1}, {"zero1": True}, {}),
    ("dp2_fsdp", 2, {"data": 2, "model": 1}, {"fsdp": True}, {}),
    ("tp2", 2, {"data": 1, "model": 2}, {}, {}),
    ("ep2_moe_drop_free", 2, {"data": 1, "model": 2}, {},
     {"moe_experts": MOE_EXPERTS}),
    ("ep2_moe_capacity", 2, {"data": 1, "model": 2}, {},
     {"moe_experts": MOE_EXPERTS, "moe_train_capacity": MOE_CAPACITY}),
    ("dp2_tp2", 4, {"data": 2, "model": 2}, {}, {}),
    ("pp2_tp2", 4, {"data": 1, "model": 2, "pipe": 2},
     {"microbatches": 4}, {}),
    # context parallelism: the ring in place of K1/K3/K4
    ("sp2_tp2", 4, {"data": 1, "seq": 2, "model": 2}, {}, {}),
]
RANK_TIMEOUT = 420  # seconds a layout's ranks may take, start to exit
RANK_SCRIPT = os.path.abspath(__file__)  # what a rank runs (--rank-job)
# the train CLI across 4 ranks (file catalog rendezvous, pp2 x tp2)
PARALLEL_CLI = ["--vocab", "32768", "--d-model", "1024", "--n-heads", "8",
                "--n-layers", "2", "--seq-len", "1024", "--batch", "8",
                "--steps", "10", "--learning-rate", "1e-3",
                "--pipeline-stages", "2", "--tensor-parallel", "2"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch_ranks(argvs, envs, log_dir, timeout):
    """Start one child per argv, wait for all (each killed in finally if
    still alive), require exit 0; returns their outputs."""
    procs, logs = [], []
    try:
        for i, (argv, env) in enumerate(zip(argvs, envs)):
            log = open(os.path.join(log_dir, f"rank{i}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                env=env, stdout=log, stderr=subprocess.STDOUT, text=True))
        # a failed rank leaves its peers blocked in a collective: stop
        # waiting at the first failure (the finally kills the rest)
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"ranks still running after {timeout} s: "
                    f"{[p.poll() for p in procs]}")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    # report a rank that failed by itself before one killed above
    for i in sorted(range(len(procs)), key=lambda i: procs[i].returncode < 0):
        if procs[i].returncode != 0:
            raise AssertionError(
                f"rank {i} exited {procs[i].returncode}:\n"
                f"{outs[i][-3000:]}")
    return outs


def _routes_by_layer(table, router):
    """routes_of's table keyed by layer index instead of the router
    view's address (the addresses differ between processes)."""
    base, step = router.data_ptr(), router.stride(0) * router.element_size()
    return {(key - base) // step: [t.cpu() for t in calls]
            for key, calls in table.items()}


def parallel_reference(gen, tmp, device="cuda"):
    """The one-rank side of train_parallel in this process: seeded masters
    (seed 0) and one seeded batch, then for the dense configuration and
    each MoE layout's one loss value+grad through make_train_step's path
    (the kernels). Writes the batch, the gradients (bf16) and, for MoE,
    the routes of every router call; returns each config's loss, moment
    and param bytes."""
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.parallel import train as tr

    tokens = torch.randint(0, PARALLEL_CFG["vocab_size"],
                           (TRAIN_BATCH, TRAIN_SEQ + 1), generator=gen,
                           device=device)
    torch.save(tokens.cpu(), os.path.join(tmp, "tokens.pt"))
    refs = {}
    for over in ({}, *(o for *_r, o in PARALLEL_LAYOUTS if o)):
        key = json.dumps(over, sort_keys=True)
        if key in refs:
            continue
        cfg = tf.TransformerConfig(**{**PARALLEL_CFG, **over})
        state = tr.init_train_state(0, cfg, device)
        leaves = tr.tree_leaves(state.params)
        table = {}
        with routes_of(table):
            loss = tf.loss_fn(state.params, tokens, cfg)
            grads = torch.autograd.grad(loss, leaves)
        name = f"ref{len(refs)}"
        torch.save([g.to(torch.bfloat16).cpu() for g in grads],
                   os.path.join(tmp, f"{name}_grads.pt"))
        if cfg.moe_experts:
            torch.save(_routes_by_layer(table,
                                        state.params["layers"]["router"]),
                       os.path.join(tmp, f"{name}_routes.pt"))
        refs[key] = {"name": name, "loss": float(loss.detach()),
                     "param_bytes": sum(p.numel() * 4 for p in leaves),
                     "moment_bytes": 2 * sum(p.numel() * 4 for p in leaves)}
        del state, leaves, grads, loss
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def rank_job(spec_path: str, rank: int) -> int:
    """One rank of a train_parallel world (``python3 chip_smoke.py
    --rank-job SPEC RANK``): joins the world from COORDINATOR_ADDRESS,
    then runs the spec's layouts in order (parallel_layout); writes
    <layout>/rank<r>.json for each."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from containerpilot_tpu_torch.parallel import initialize_from_env
    from containerpilot_tpu_torch.parallel.mesh import rank_device

    with open(spec_path) as fh:
        spec = json.load(fh)
    initialize_from_env(device=spec["device"])
    device = rank_device(rank, spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    for layout in spec["layouts"]:
        out = parallel_layout(layout, spec, rank, device)
        with open(os.path.join(layout["out"], f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    dist.destroy_process_group()
    return 0


def parallel_layout(layout, spec, rank, device):
    """One layout on this rank: its blocks of the seed-0 masters, one loss
    value+grad (MoE on the reference's routes) whose gathered gradients
    rank 0 holds against the one-rank run's, then one make_train_step
    (or make_pipeline_train_step) step with the K1/K3/K4 counts zeroed
    before it and read after, timed (the value+grad has warmed every
    path it takes)."""
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import flash
    from containerpilot_tpu_torch.parallel import (
        MeshPlan,
        fsdp_sharding_rules,
        gather_params,
        make_mesh,
        make_pipeline_train_step,
        make_train_step,
        param_sharding_rules,
        pipeline_sharding_rules,
        shard_params,
    )
    from containerpilot_tpu_torch.parallel import pipeline as pp
    from containerpilot_tpu_torch.parallel import train as tr

    on_card = device.type == "cuda"
    mesh = make_mesh(MeshPlan(**layout["plan"]), device=device)
    cfg = tf.TransformerConfig(**{**PARALLEL_CFG, **layout["over"]})
    opts = layout["opts"]
    pipeline = "microbatches" in opts
    if pipeline:
        rules = pipeline_sharding_rules(cfg, mesh)
    elif opts.get("fsdp"):
        rules = fsdp_sharding_rules(cfg, mesh)
    else:
        rules = param_sharding_rules(cfg, mesh)
    params = shard_params(tf.init_params(0, cfg, device), mesh, rules=rules)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    state = tr.init_train_state(params, cfg, device, mesh=mesh,
                                zero1=opts.get("zero1", False), rules=rules)
    del params
    tokens = torch.load(spec["tokens"]).to(device)
    if pipeline:
        step = make_pipeline_train_step(cfg, mesh,
                                        n_microbatches=opts["microbatches"])
    else:
        step = make_train_step(cfg, mesh=mesh, zero1=opts.get("zero1", False),
                               fsdp=opts.get("fsdp", False))
    out = {"rank": rank, "coords": mesh.coords, "backend": mesh.backend,
           "host_staging": mesh.staging,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in tr.tree_leaves(state.params)),
           "moment_bytes": sum(
               t.numel() * t.element_size()
               for k in ("mu", "nu")
               for t in tr.tree_leaves(state.opt_state[k]))}

    # the comparison: one loss value+grad, MoE on the one-rank run's routes
    routes, flips = {}, []
    if cfg.moe_experts:
        recorded = torch.load(layout["routes"])
        router = state.params["layers"]["router"]
        base = router.data_ptr()
        stride = router.stride(0) * router.element_size()
        routes = {base + index * stride: [t.to(device) for t in calls]
                  for index, calls in recorded.items()}
    with routes_of(routes, pin=bool(cfg.moe_experts), flips=flips):
        if pipeline:
            loss, grads = pp.pipeline_value_and_grad(
                state.params, tokens, cfg, mesh, opts["microbatches"],
                step.layout)
        else:
            loss, grads = tr.sharded_value_and_grad(
                state.params, tokens, cfg, mesh, 1,
                rules if opts.get("fsdp") else None, step.layout)
    full = gather_params(tr.tree_unflatten(state.params, grads), mesh,
                         rules=rules)
    del grads
    if rank == 0:
        want = torch.load(layout["ref_grads"])
        errs = [rel_norm_err(g, w.to(device))
                for g, w in zip(tr.tree_leaves(full), want)]
        out["loss"] = float(loss)
        out["worst_grad_rel"] = max(errs)
        del want
    if cfg.moe_experts:
        out["route_flips"] = flip_summary(
            flips, 2 * TRAIN_BATCH * TRAIN_SEQ * cfg.n_layers)
    del full
    if on_card:
        torch.cuda.empty_cache()

    # the step, counted and timed
    staged = mesh.traffic["host_bytes"]
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKDV_LAUNCHES = 0
    t0 = time.perf_counter()
    state, loss = step(state, tokens)
    step_loss = float(loss)  # synchronizes
    out.update({
        "step_ms": (time.perf_counter() - t0) * 1e3,
        "step_loss": step_loss,
        "k1_launches": flash.LAUNCHES, "dq_launches": flash.DQ_LAUNCHES,
        "dkdv_launches": flash.DKDV_LAUNCHES,
        "host_staged_bytes_a_step": mesh.traffic["host_bytes"] - staged,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else None),
    })
    return out


def drive_train_parallel(gen, tmp, device="cuda"):
    """train_parallel: every PARALLEL_LAYOUTS world as child ranks on this
    one card (gloo, collectives staged through host buffers), each held
    against the one-rank run in this process: the loss within
    TRAIN_LOSS_REL_TOL and every gradient leaf within TRAIN_GRAD_REL_TOL
    (MoE on pinned routes, their flips near ties), K1/K3/K4 a rank a
    step as the layout implies (2 / 1 / 1 per local layer and
    microbatch), ZeRO-1's moments and FSDP's params and moments at 1/dp
    of the one-rank bytes; beside them, the train CLI as 4 ranks through
    a file catalog (pp2 x tp2): the mesh line and a falling loss."""
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    per_shard = None
    if device == "cuda":
        per_shard = {"flash_fwd": check_flash(gen, *SHARD_FWD_CASE),
                     "flash_bwd": check_flash_bwd(gen, *SHARD_BWD_CASE)}
    refs = parallel_reference(gen, tmp, device)
    root = os.path.dirname(os.path.abspath(__file__))
    layouts = {}
    seconds = {}

    def run_world(world):
        t0 = time.perf_counter()
        world_dir = os.path.join(tmp, f"world{world}")
        os.makedirs(world_dir)
        jobs = []
        for name, n, plan, opts, over in PARALLEL_LAYOUTS:
            if n != world:
                continue
            ref = refs[json.dumps(over, sort_keys=True)]
            jobs.append({
                "name": name, "plan": plan, "opts": opts, "over": over,
                "ref_grads": os.path.join(tmp, f"{ref['name']}_grads.pt"),
                "routes": os.path.join(tmp, f"{ref['name']}_routes.pt"),
                "out": os.path.join(world_dir, name)})
            os.makedirs(jobs[-1]["out"])
        spec = {"layouts": jobs, "device": device,
                "tokens": os.path.join(tmp, "tokens.pt")}
        spec_path = os.path.join(world_dir, "spec.json")
        with open(spec_path, "w") as fh:
            json.dump(spec, fh)
        port = _free_port()
        envs = [{**os.environ, "PYTHONPATH": root,
                 "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                 "NUM_PROCESSES": str(world), "PROCESS_ID": str(r)}
                for r in range(world)]
        _launch_ranks(
            [[sys.executable, RANK_SCRIPT, "--rank-job", spec_path, str(r)]
             for r in range(world)],
            envs, world_dir, RANK_TIMEOUT)
        seconds[f"world_of_{world}"] = time.perf_counter() - t0

    # the worlds and the 4-rank CLI are processes of their own, two
    # launches at a time (the script's clock; the ranks' step times are
    # no speed figure: they share the card)
    with ThreadPoolExecutor(2) as pool:
        launches = [pool.submit(run_world, world) for world in sorted(
            {w for _n, w, *_rest in PARALLEL_LAYOUTS}, reverse=True)]
        cli_run = pool.submit(drive_parallel_cli, tmp, device)
        for launch in launches:
            launch.result()
        cli = cli_run.result()
    for name, world, plan, opts, over in PARALLEL_LAYOUTS:
        ref = refs[json.dumps(over, sort_keys=True)]
        job_dir = os.path.join(tmp, f"world{world}", name)
        ranks = []
        for r in range(world):
            with open(os.path.join(job_dir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        head = ranks[0]
        loss_rel = abs(head["loss"] - ref["loss"]) / abs(ref["loss"])
        if not (loss_rel <= TRAIN_LOSS_REL_TOL
                and head["worst_grad_rel"] <= TRAIN_GRAD_REL_TOL):
            raise AssertionError(
                f"train_parallel {name}: loss rel {loss_rel}, worst grad "
                f"leaf rel {head['worst_grad_rel']} against one rank")
        stages = plan.get("pipe", 1)
        # under a seq axis the ring replaces the flash kernels
        local_layers = (PARALLEL_CFG["n_layers"] // stages
                        if plan.get("seq", 1) == 1 else 0)
        mb = opts.get("microbatches", 1)
        want = {"k1_launches": 2 * local_layers * mb,
                "dq_launches": local_layers * mb,
                "dkdv_launches": local_layers * mb}
        for rk in ranks:
            got = {k: rk[k] for k in want}
            # the plain versions run on the CPU (a rehearsal): no launches
            counted = want if device == "cuda" else dict.fromkeys(want, 0)
            if got != counted or rk["backend"] != "gloo" or (
                    rk["host_staging"] != (device == "cuda")):
                raise AssertionError(
                    f"train_parallel {name} rank {rk['rank']}: launches "
                    f"{got} (want {want}), backend {rk['backend']}, "
                    f"staging {rk['host_staging']}")
            if abs(rk["step_loss"] - ranks[0]["step_loss"]) > 1e-6 * abs(
                    ranks[0]["step_loss"]):
                raise AssertionError(
                    f"train_parallel {name}: ranks disagree on the step's "
                    f"loss ({rk['step_loss']} vs {ranks[0]['step_loss']})")
        dp = plan["data"]
        sharded = {"zero1": ("moment_bytes",),
                   "fsdp": ("moment_bytes", "param_bytes")}
        for opt, keys in sharded.items():
            if opts.get(opt):
                for key in keys:
                    if any(dp * rk[key] != ref[key] for rk in ranks):
                        raise AssertionError(
                            f"train_parallel {name}: {key} "
                            f"{[rk[key] for rk in ranks]} are not 1/{dp} "
                            f"of one rank's {ref[key]}")
        layouts[name] = {
            "ranks": world, "mesh": plan, "options": opts,
            "config_overrides": over, "loss": head["loss"],
            "one_rank_loss": ref["loss"], "loss_rel": loss_rel,
            "worst_grad_rel": head["worst_grad_rel"],
            "route_flips": head.get("route_flips"),
            "launches_a_rank_a_step": want,
            "step_ms": [rk["step_ms"] for rk in ranks],
            "backend": head["backend"],
            "host_staged_bytes_a_step": [rk["host_staged_bytes_a_step"]
                                         for rk in ranks],
            "param_bytes": [rk["param_bytes"] for rk in ranks],
            "moment_bytes": [rk["moment_bytes"] for rk in ranks],
            "one_rank_param_bytes": ref["param_bytes"],
            "one_rank_moment_bytes": ref["moment_bytes"],
            "peak_memory_bytes": [rk["peak_memory_bytes"] for rk in ranks],
        }
    for name in os.listdir(tmp):
        if name.startswith("ref") or name == "tokens.pt":
            os.remove(os.path.join(tmp, name))
    return {"phase": "train_parallel", "config": PARALLEL_CFG,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "per_shard_kernels": per_shard, "layouts": layouts,
            "world_seconds": seconds, "train_cli_4_ranks": cli,
            "seconds": time.perf_counter() - t_phase}


def drive_parallel_cli(tmp, device="cuda"):
    """The train CLI as 4 ranks on the card through initialize_from_catalog
    on a file catalog, --pipeline-stages 2 --tensor-parallel 2: every
    rank prints the mesh {'data': 1, 'pipe': 2, 'model': 2} and the same
    losses, and the loss falls from step 1 to step 10."""
    root = os.path.dirname(os.path.abspath(__file__))
    log_dir = os.path.join(tmp, "cli_ranks")
    os.makedirs(log_dir)
    port = _free_port()
    t0 = time.perf_counter()
    outs = _launch_ranks(
        [[sys.executable, "-m", "containerpilot_tpu_torch.workload.train",
          "--device", device, *PARALLEL_CLI,
          "--catalog", f"file:{os.path.join(tmp, 'catalog')}",
          "--num-processes", "4", "--process-id", str(r),
          "--advertise-address", "127.0.0.1",
          "--coordinator-port", str(port)] for r in range(4)],
        [{**os.environ, "PYTHONPATH": root}] * 4, log_dir, RANK_TIMEOUT)
    losses = []
    for out in outs:
        if f"mesh: {{'data': 1, 'pipe': 2, 'model': 2}} on {device}" \
                not in out:
            raise AssertionError(f"train CLI mesh line:\n{out[-2000:]}")
        losses.append([float(x) for x in re.findall(
            r"step (?:1|10): loss=([\d.]+)", out)])
    if not (len(losses[0]) == 2 and all(x == losses[0] for x in losses)
            and losses[0][1] < losses[0][0]):
        raise AssertionError(f"train CLI losses (steps 1, 10) by rank: "
                             f"{losses}")
    return {"args": PARALLEL_CLI, "mesh": {"data": 1, "pipe": 2, "model": 2},
            "losses_step_1_and_10": losses[0],
            "collectives": re.search(r"collectives over (.*)",
                                     outs[0]).group(1),
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 25: tensor- and context-parallel serving through the serve CLI
# ---------------------------------------------------------------------------

# the serve CLI's flagship at its full width and a quarter of its depth
PAR_MODEL = [*FACE_MODEL[:FACE_MODEL.index("--n-layers") + 1], "4",
             *FACE_MODEL[FACE_MODEL.index("--n-layers") + 2:]]
# K1 at a tp2 rank's 1024-token prefill of the CLI flagship
SHARD_SERVE_FWD_CASE = (1, 1024, 8, 8, 128, 0)
# K2 at a tp2 rank's projections of the CLI flagship: (k, n) -> count a
# layer (wq, wk, wv; wo; gate, up; down)
SHARD_INT8_PROJ = {(2048, 1024): 3, (1024, 2048): 1, (2048, 3072): 2,
                   (3072, 2048): 1}
PAR_ARGS = ["--slots", "8"]
# label -> (extra flags, ranks); a --cp run also gets --cp-min-len.
# Beside them the phase runs the composed pod P (drive_composed_pod),
# its result under "tp2_int8"
PAR_RUNS = (
    ("tp2", ["--tp", "2"], 2),
    ("tp2_cp2", ["--tp", "2", "--cp", "2"], 4),
)
# the composed pod P and the one-rank replica E it fetches its weights
# from, in one file catalog: E --int8 --slots 8 --prefix-cache 4 (with a
# spill tier for the entries it pulls), P the same model over tp2 with
# a spill tier of 64 MiB a rank, a 2-layer draft, a standby
COMPOSED_ARGS = ["--int8", "--prefix-cache", "4", "--fleet-ttl", "2"]
E_ARGS = [*COMPOSED_ARGS, "--kv-spill-mb", "1024", "--migrate-window", "0"]
P_ARGS = [*COMPOSED_ARGS, "--tp", "2", "--kv-spill-mb", "64",
          "--draft-layers", "2", "--standby", "--migrate-window", "120"]
PAR_BEAM_WIDTH = 2
# the rows the composed pod's int8 pool holds live a step, at least,
# over its 8 concurrent sampled shorts (8 when all are admitted at once)
POOL_MIN_ROWS = 4
# a KV entry a pod exported against a solo prefill of its prompt, abs
# err / max|ref|: bf16 k/v of a stack whose tp all-reduces round the
# hidden state once more a block than one rank does, held to the
# script's end-to-end bound
KV_REL_TOL = E2E_REL_TOL
# the long prompts: the tp runs' flash prefill, the cp run's two ringed
# heads (the second with a 1-token remainder)
PAR_LENS = {"tp": (1024,), "cp": (1536, 1031)}
PAR_NEW = 15


def parallel_bodies(ids, lens, shorts=8, sampled=1):
    """(long bodies, short bodies) of one serve_parallel run: greedy long
    prompts (prefixes of ``ids``) and concurrent short prompts of 5-19
    ids, the last ``sampled`` of them sampled (temperature 0.8, seeds 7,
    8, ... from the last back; no top-k, whose cut can split a near
    tie), each PAR_NEW new tokens."""
    longs = [{"tokens": [ids[:n]], "max_new_tokens": PAR_NEW} for n in lens]
    short = [{"tokens": [ids[100 + 7 * i:105 + 9 * i]],
              "max_new_tokens": PAR_NEW} for i in range(shorts)]
    for j in range(sampled):
        short[-1 - j].update(temperature=0.8, seed=7 + j)
    return longs, short


def judge_beam(cfg, params, body, got, max_len=MAX_LEN):
    """Hold a served beam to one rank's plain beam search on the same
    prompt: the same tokens, or (past a near tie between beams, which
    tp's rounding can tip) a sequence whose teacher-forced
    log-probability is no more than BEAM_SCORE_REL_TOL below that of the
    one-rank best beam's tokens. Returns (equal, the relative gap;
    negative when the served beam scores higher)."""
    from containerpilot_tpu_torch.models import beam
    from containerpilot_tpu_torch.workload import modelcfg

    row = body["tokens"][0]
    dev = params["norm_out"].device
    score = modelcfg.score_logprobs_fn(cfg)
    with torch.inference_mode():
        local, _score = beam.beam_search(
            params, torch.tensor([row], device=dev), cfg,
            body["max_new_tokens"], max_len,
            beam_width=body["beam_width"])
        if local.tolist() == got:
            return True, 0.0
        served, best = (
            float(score(params, torch.tensor([row + toks], device=dev))[
                0][len(row) - 1:].sum())
            for toks in (got, local.tolist()))
    gap = (best - served) / abs(best)
    if not gap <= BEAM_SCORE_REL_TOL:
        raise AssertionError(f"beam off one rank's: served log-prob "
                             f"{served}, one rank's best beam's {best}")
    return False, gap


class RankCounts:
    """A CountedServe over ranks: every rank's K1/K2 counters zeroed
    once, read as per-rank deltas around each path."""

    def __init__(self, srv):
        self.srv = srv
        self.last = srv.counts(zero=True)

    def delta(self):
        now = self.srv.counts()
        out = [{k: n[k] - b[k] for k in n} for n, b in zip(now, self.last)]
        self.last = now
        return out


def _log_time(log, text):
    """The epoch seconds of the first line of a serve CLI's ``log`` that
    holds ``text`` (its logging format's asctime, this host's clock)."""
    import datetime

    for line in log.splitlines():
        if text in line:
            stamp = datetime.datetime.strptime(line[:23],
                                               "%Y-%m-%d %H:%M:%S,%f")
            return stamp.timestamp()
    raise AssertionError(f"no {text!r} in the serve CLI's log")


def drive_composed_pod(tmp, card, device="cuda", model=None, lens=None,
                       extra_args=(), timeout=600):
    """serve_parallel's tp2_int8 run: the composed pod P (``--tp 2
    --int8 --slots 8 --prefix-cache 4 --kv-spill-mb 64 --draft-layers 2
    --standby --weights-from E --fleet-catalog``) beside E, a one-rank
    ``--int8 --slots 8 --prefix-cache 4`` replica of the same model in
    the same file catalog, started first. P is driven through, in order:
    the weight wire (E -> P at start-up) and promotion; the phase's
    1024-id request and 8 concurrent short ones, all sampled (a greedy
    row would go to the speculative engine's one slot), so the --int8
    slot pool admits and caches the long one and decodes the shorts
    together: the shorts' K2 launches, 7 x n_layers a pool step at m = 8
    and none at their admissions, give the rows live a step
    (POOL_MIN_ROWS at least); a beam of width 2 and a
    greedy row through the speculative engine, each on a 1024-id
    prompt; the 1024-id request again (a prefix hit); /v1/prefill on P
    and E's /v1/kv/pull of P's entry (export out of tp), held to a solo
    prefill within KV_REL_TOL with the manifest of E's own entry, then
    E serving it; E's entry pulled into P (import into tp) and P
    serving it; P's /v1/weights against E's, chunk digest by chunk
    digest; a SIGTERM drain of P that migrates its sessions to E. Every
    answer is held to one rank's plain path (judge_served; beams to
    judge_beam); every rank's K1/K2 launches are read by path, and
    every rank's token digest and prefix-cache keys must agree."""
    import random

    from containerpilot_tpu_torch.fleet.standby import fetch_weight_chunks
    from containerpilot_tpu_torch.kvtier.digest import prefix_fingerprint
    from containerpilot_tpu_torch.kvtier.handoff import (
        fetch_kv_chunks,
        rebuild_kv,
    )
    from containerpilot_tpu_torch.models import decode
    from containerpilot_tpu_torch.workload import serve_cli

    model = PAR_MODEL if model is None else model
    long_len = (lens or PAR_LENS)["tp"][0]
    catalog = os.path.join(tmp, "composed_catalog")
    base = ["--device", device, *model, *PAR_ARGS, "--fleet-catalog",
            f"file:{catalog}"]
    e_args = [*base, *E_ARGS, "--fleet-id", "E"]
    parsed = serve_cli.build_arg_parser().parse_args(e_args)
    cfg, params, _ = serve_cli.load_model(parsed)  # one rank, whole
    vocab, max_len = cfg.vocab_size, parsed.max_len
    on_card = device == "cuda"
    rng = random.Random(25)
    # ids also feeds the short prompts (ids[100:168])
    ids = [rng.randrange(vocab) for _ in range(max(long_len, 256))]
    p_spec, p_beam, p_a, p_b = (
        [rng.randrange(vocab) for _ in range(long_len)] for _ in range(4))
    bodies, shorts = parallel_bodies(ids, (long_len,), sampled=8)
    long = {**bodies[0], "temperature": 0.8, "seed": 5}
    beam = {"tokens": [p_beam], "max_new_tokens": PAR_NEW,
            "beam_width": PAR_BEAM_WIDTH}
    spec = {"tokens": [p_spec], "max_new_tokens": PAR_NEW}

    def subdir(name):
        path = os.path.join(tmp, f"composed_{name}")
        os.makedirs(path, exist_ok=True)
        return path

    def model_info(port):
        return json.loads(asyncio.run(http(port, "GET", "/v1/model")))

    out = {"args": P_ARGS, "e_args": E_ARGS, "ranks": 2}
    served, launches, walls = [], {}, {}
    with CountedServe(e_args, subdir("e"), timeout=timeout) as e:
        ce = Counts(e)
        p_args = [*base, *P_ARGS, "--fleet-id", "P", "--weights-from",
                  f"127.0.0.1:{e.port}", *extra_args]
        with CountedServe(p_args, subdir("p"), timeout=timeout,
                          ranks=2) as p:
            out["ready_s"] = p.ready_s
            # -- 1. the weight wire came in at start-up; promote -------
            standby = http_status(p.port, "GET", "/health")
            t0 = time.perf_counter()
            promoted, _ = timed_post(p.port, "/v3/standby/promote", {})
            out["promote_ms"] = (time.perf_counter() - t0) * 1e3
            if not (standby[0] == 503 and standby[2].startswith(b"standby")
                    and promoted["promoted"] and http_status(
                        p.port, "GET", "/health")[0] == 200):
                raise AssertionError(f"P's standby {standby[:1]} and "
                                     f"promotion {promoted}")
            before = model_info(p.port)
            cp = RankCounts(p)

            def run(label, body):
                rows, wall = asyncio.run(generate_tokens(p.port, body))
                served.append((label, body, rows[0]))
                walls.setdefault(label, []).append(wall * 1e3)
                return rows[0]

            # -- 2. the phase's requests -------------------------------
            t0 = time.perf_counter()
            run("long", long)
            launches["long"] = cp.delta()
            pool = model_info(p.port)["slot_engine"]

            async def concurrent():
                return await asyncio.gather(*[generate_tokens(p.port, b)
                                              for b in shorts])

            for body, (rows, wall) in zip(shorts, asyncio.run(concurrent())):
                served.append(("concurrent", body, rows[0]))
                walls.setdefault("concurrent", []).append(wall * 1e3)
            out["requests_s"] = time.perf_counter() - t0
            launches["concurrent"] = cp.delta()
            after = model_info(p.port)
            pool = {k: after["slot_engine"][k] - pool[k]
                    for k in ("dispatches", "tokens_out")}
            staged = after["lockstep"]["staged_bytes"]
            tokens = sum(len(x[2]) for x in served)
            out["front_staged_bytes_a_token"] = (
                staged - before["lockstep"]["staged_bytes"]) / tokens
            # -- 3. a beam; 4. the speculative engine -------------------
            beam_got = run("beam", beam)
            launches["beam"] = cp.delta()
            spec_before = model_info(p.port)["speculative"]["engine"]
            run("speculative", spec)
            launches["speculative"] = cp.delta()
            spec_after = model_info(p.port)["speculative"]["engine"]
            out["speculative_dispatches"] = (spec_after["dispatches"]
                                             - spec_before["dispatches"])
            # -- 5. the 1024-id request again: a prefix hit -------------
            hits = model_info(p.port)["prefix_cache"]["hits"]
            run("prefix_hit", long)
            launches["prefix_hit"] = cp.delta()
            if model_info(p.port)["prefix_cache"]["hits"] != hits + 1:
                raise AssertionError("P's repeat of the 1024-id prompt "
                                     "was not a prefix hit")
            # -- 6. KV out of tp, and into tp --------------------------
            pre, out["prefill_wall_s"] = timed_post(
                p.port, "/v1/prefill", {"tokens": [p_a]})
            launches["prefill"] = cp.delta()
            if not pre["cached"]:
                raise AssertionError(f"P's /v1/prefill: {pre}")
            manifest, chunks = asyncio.run(fetch_kv_chunks(
                "127.0.0.1", p.port, p_a, read_timeout=300.0))
            entry = rebuild_kv(manifest, chunks)
            del chunks
            launches["kv_export"] = cp.delta()
            ce.delta()
            pull_e, pull_e_s = timed_post(e.port, "/v1/kv/pull", {
                "tokens": [p_a], "from": f"127.0.0.1:{p.port}"})
            launches["kv_export_pull"] = cp.delta()
            timed_post(e.port, "/v1/prefill", {"tokens": [p_b]})
            e_manifest, _ = asyncio.run(fetch_kv_chunks(
                "127.0.0.1", e.port, p_b, read_timeout=300.0))
            ce.delta()
            readmit_e = model_info(e.port)["prefix_cache"]["readmitted"]
            a_body = {"tokens": [p_a], "max_new_tokens": PAR_NEW}
            e_rows, _ = asyncio.run(generate_tokens(e.port, a_body))
            served.append(("e_on_p_entry", a_body, e_rows[0]))
            k_e = ce.delta()
            readmit_e = model_info(e.port)["prefix_cache"][
                "readmitted"] - readmit_e
            pull_p, pull_p_s = timed_post(p.port, "/v1/kv/pull", {
                "tokens": [p_b], "from": f"127.0.0.1:{e.port}"})
            launches["kv_import_pull"] = cp.delta()
            readmit_p = model_info(p.port)["prefix_cache"]["readmitted"]
            b_body = {"tokens": [p_b], "max_new_tokens": PAR_NEW,
                      "temperature": 0.8, "seed": 9}
            run("p_on_e_entry", b_body)
            launches["kv_import_serve"] = cp.delta()
            readmit_p = model_info(p.port)["prefix_cache"][
                "readmitted"] - readmit_p
            if readmit_e != 1 or readmit_p != 1 or k_e["k1"] or (
                    launches["kv_import_serve"][0]["k1"]):
                raise AssertionError(
                    f"pulled entries: E readmitted +{readmit_e} ({k_e}), "
                    f"P +{readmit_p} ({launches['kv_import_serve']})")
            # -- 7. the weights ----------------------------------------
            pm, em = weights_manifest_of(p.port), weights_manifest_of(e.port)
            if pm["leaves"] != em["leaves"] or pm["chunks"] != em["chunks"]:
                raise AssertionError("P's weight digests differ from E's")
            t0 = time.perf_counter()
            wm, wchunks = asyncio.run(fetch_weight_chunks(
                "127.0.0.1", p.port, read_timeout=600.0))
            weights_s = time.perf_counter() - t0
            del wchunks
            launches["weights"] = cp.delta()
            info = model_info(p.port)
            launches["total"] = [{k: n[k] for k in n} for n in p.counts()]
            # -- 8. drain P: its sessions migrate to E ------------------
            catalog_fields(catalog, ["E", "P"], absent=("role",),
                           timeout=60)
            readmit_e = model_info(e.port)["prefix_cache"]["readmitted"]
            p.proc.send_signal(signal.SIGTERM)
            probe = {"tokens": long["tokens"], "max_new_tokens": 4}
            refusal, t_term = None, time.perf_counter()
            term_wall = time.time()
            while p.proc.poll() is None and refusal is None:
                try:
                    status, headers, _ = http_status(
                        p.port, "POST", "/v1/generate", probe, 30)
                except OSError:
                    break
                if status == 503 and "x-cp-migrated-to" in headers:
                    refusal = headers
                if time.perf_counter() - t_term > 150:
                    raise AssertionError("P's drain never finished")
                time.sleep(0.05)
            if refusal is None or refusal["x-cp-migrated-to"] != "E":
                raise AssertionError(f"P's refusal while draining: "
                                     f"{refusal}")
            ce.delta()
            d_body = {"tokens": long["tokens"], "max_new_tokens": PAR_NEW}
            d_rows, _ = asyncio.run(generate_tokens(e.port, d_body))
            served.append(("e_migrated", d_body, d_rows[0]))
            k_d = ce.delta()
            readmit_d = model_info(e.port)["prefix_cache"][
                "readmitted"] - readmit_e
            if readmit_d != 1 or k_d["k1"]:
                raise AssertionError(f"E on the migrated session: "
                                     f"readmitted +{readmit_d}, {k_d}")
            p.proc.wait(timeout=300)
            drain_s = time.perf_counter() - t_term
            exit_wall = time.time()
        launches["e"] = ce.total()
    fetched = re.findall(r"weights fetched from peer \S+ in ([\d.]+)s",
                         p.log)
    moved = re.findall(r"migration moved (\d+)/(\d+) entries \((\d+) "
                       r"bytes, (\d+) failed", p.log)
    if len(fetched) != 1 or len(moved) != 1:
        raise AssertionError(f"P's log: {p.log[-3000:]}")
    # the drain's seconds split by P's own log clock: SIGTERM to the
    # maintenance line, that to the migration's summary, and the rest
    # (the in-flight wait, deregistration, the followers' shutdown and
    # the process group's teardown) to P's exit
    entered = _log_time(p.log, "serve: entering maintenance (draining)")
    migrated = _log_time(p.log, "serve: migration moved")
    drain = {"drain_s": drain_s,
             "to_maintenance_s": entered - term_wall,
             "migration_s": migrated - entered,
             "migration_to_exit_s": exit_wall - migrated,
             "inflight_wait_timed_out": "drain timed out" in p.log,
             "followers_killed": "did not exit in 30 s; killed" in p.log}
    lockstep = info["lockstep"]
    if not (lockstep["agree"] and len(lockstep["ranks"]) == 2 and len(
            {r["prefix"] for r in lockstep["ranks"]}) == 1):
        raise AssertionError(f"P's ranks disagree: {lockstep}")
    # ranks sharing a card stage through the host (gloo), a card a rank
    # is NCCL; either way the round calls collectives, uncaptured
    own_cards = on_card and torch.cuda.device_count() >= 2
    if (lockstep["backend"] != ("nccl" if own_cards else "gloo")
            or lockstep["staging"] != (on_card and not own_cards)
            or lockstep["step_program"] != ("uncaptured" if on_card
                                            else "eager")
            or info["mesh"] != {"data": 1, "model": 2}):
        raise AssertionError(f"P's mesh {info['mesh']}, lockstep "
                             f"{lockstep}")
    # every answer against one rank's plain path
    judged = []
    for label, body, got in served:
        if label == "beam":
            continue  # judge_beam below
        if len(got) != body["max_new_tokens"]:
            raise AssertionError(f"P {label}: {len(got)} tokens served")
        first, worst, _typical = judge_served(cfg, params, body, got,
                                              max_len)
        if worst > NEAR_TIE_TOL:
            raise AssertionError(f"P {label}: off the one-rank model, worst "
                                 f"gap {worst} at {first}")
        judged.append({"path": label, "prompt_len": len(body["tokens"][0]),
                       "sampled": bool(body.get("temperature")),
                       "equal_one_rank": first is None, "worst_gap": worst})
    beam_equal, beam_gap = judge_beam(cfg, params, beam, beam_got, max_len)
    # P's exported entry against a solo prefill of its prompt
    with torch.inference_mode():
        _logits, solo = decode.prefill(
            params, torch.tensor([p_a], device=params["norm_out"].device),
            cfg, max_len)
    kv_err = {}
    for name in ("k", "v"):
        ref = solo[name].float().cpu()
        kv_err[name] = float((entry[name].float() - ref).abs().max()
                             / ref.abs().max())
    same_layout = (manifest["skeleton"] == e_manifest["skeleton"]
                   and manifest["total_bytes"] == e_manifest["total_bytes"]
                   and [(x["dtype"], x["shape"]) for x in manifest["leaves"]]
                   == [(x["dtype"], x["shape"])
                       for x in e_manifest["leaves"]])
    if (max(kv_err.values()) > KV_REL_TOL or not same_layout
            or entry["pos"] != len(p_a)):
        raise AssertionError(f"P's KV entry: rel err {kv_err}, manifest "
                             f"{manifest['leaves']} vs E's "
                             f"{e_manifest['leaves']}")
    kv_bytes = manifest["total_bytes"]
    if pull_e["bytes"] != kv_bytes or pull_p["bytes"] != kv_bytes:
        raise AssertionError(f"pulled {pull_e} / {pull_p} of {kv_bytes}")
    if on_card:
        # K1 a rank: a 1024-id admission, beam and prefill n_layers; the
        # speculative row's target and draft prefills n_layers + draft;
        # none for a hit's extend or the short prompts
        draft = int(P_ARGS[P_ARGS.index("--draft-layers") + 1])
        want = {"long": cfg.n_layers, "concurrent": 0, "beam": cfg.n_layers,
                "speculative": cfg.n_layers + draft, "prefix_hit": 0,
                "prefill": cfg.n_layers}
        k2_paths = ("long", "concurrent", "beam", "speculative",
                    "prefix_hit", "kv_import_serve")
        bad = [(path, launches[path]) for path, k1 in want.items()
               if [r["k1"] for r in launches[path]] != [k1, k1]]
        bad += [(path, launches[path]) for path in k2_paths
                if not all(r["k2"] > 0 for r in launches[path])]
        if bad:
            raise AssertionError(f"P's launches by path: {bad}")
        # the shorts in the int8 pool: 7 x n_layers K2 a rank a pool
        # step (m = 8), none at a short's one-shot admission (a prefill
        # dequantizes its layers), so the count over 7 x n_layers is
        # the pool steps; the tokens past each short's first (its
        # admission's) over them are the rows live a step
        a_step = 7 * cfg.n_layers
        k2 = [r["k2"] for r in launches["concurrent"]]
        steps = k2[0] // a_step
        rows = sum(len(got) - 1 for label, _b, got in served
                   if label == "concurrent") / max(steps, 1)
        out["pool"] = {**pool, "k2_a_step": a_step,
                       "steps_from_k2": steps, "rows_a_step": rows}
        if k2[0] != k2[1] or k2[0] % a_step or rows < POOL_MIN_ROWS:
            raise AssertionError(f"P's pool: K2 {k2} by rank over the "
                                 f"shorts, {steps} steps, {rows} rows a "
                                 f"step")
    done, total, moved_bytes, failed = map(int, moved[0])
    wbytes = wm["total_bytes"]
    out.update({
        "judged": judged, "beam_equal_one_rank": beam_equal,
        "beam_score_rel_gap": beam_gap,
        "launches_by_path": launches,
        "k1_launches_by_rank": [r["k1"] for r in launches["total"]],
        "k2_launches_by_rank": [r["k2"] for r in launches["total"]],
        "mesh": info["mesh"], "backend": lockstep["backend"],
        "staging": lockstep["staging"],
        "step_program": lockstep["step_program"],
        "ranks_agree": lockstep["agree"],
        "rank_caches_agree": True,
        "rank_digests": [r["digest"] for r in lockstep["ranks"]],
        "lockstep_ops": lockstep["ranks"][0]["ops"],
        "wall_ms_by_path": walls, "prefix_cache": info["prefix_cache"],
        "kv_spill": info["kv_spill"],
        "kv": {"total_bytes": kv_bytes, "rel_err_vs_solo": kv_err,
               "rel_tol": KV_REL_TOL, "manifest_equal_e": same_layout,
               "export_pull_s": pull_e_s,
               "export_pull_gb_s": kv_bytes / pull_e_s / 1e9,
               "import_pull_s": pull_p_s,
               "import_pull_gb_s": kv_bytes / pull_p_s / 1e9,
               "e_readmitted": readmit_e, "p_readmitted": readmit_p},
        "weights": {"total_bytes": wbytes, "digests_equal_e": True,
                    "fetch_into_p_s": float(fetched[0]),
                    "fetch_into_p_gb_s": wbytes / float(fetched[0]) / 1e9,
                    "fetch_from_p_s": weights_s,
                    "fetch_from_p_gb_s": wbytes / weights_s / 1e9},
        "drain": {**drain, "migrated_to": "E",
                  "landed": f"{prefix_fingerprint(long['tokens'][0]):08x}",
                  "entries": total, "moved": done, "failed": failed,
                  "bytes": moved_bytes, "e_readmitted": readmit_d},
    })
    del params
    if on_card:
        torch.cuda.empty_cache()
    return out


def drive_serve_parallel(tmp, card, device="cuda", model=None, lens=None,
                         min_len=1024, extra_args=(), timeout=600):
    """Phase 25 (see the module docstring). ``device="cpu"`` runs the
    same drive on the plain versions for a small ``model`` and ``lens``
    (no kernel to count or hold). ``extra_args`` go to every CLI;
    ``timeout`` bounds each CLI's start-up."""
    from concurrent.futures import ThreadPoolExecutor

    from containerpilot_tpu_torch.workload import serve_cli

    model = PAR_MODEL if model is None else model
    lens = PAR_LENS if lens is None else lens
    t_phase = time.perf_counter()
    result = {"phase": "serve_parallel", "model": model, **card}
    if device == "cuda":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(25)
        result["per_shard_kernels"] = {
            "flash_fwd": check_flash(gen, *SHARD_SERVE_FWD_CASE),
            "int8_matmul": [check_int8(gen, m, k, n) for m in (1, 8)
                            for (k, n) in SHARD_INT8_PROJ],
        }
    cpu = torch.Generator()
    cpu.manual_seed(25)
    result["tp2_int8"] = drive_composed_pod(
        tmp, card, device, model=model, lens=lens, extra_args=extra_args,
        timeout=timeout)

    def serve_run(label, extra, ranks, ids):
        cp = "--cp" in extra
        if cp:
            extra = [*extra, "--cp-min-len", str(min_len)]
        args = ["--device", device, *model, *PAR_ARGS, *extra, *extra_args]
        parsed = serve_cli.build_arg_parser().parse_args(args)
        cfg, params, _ = serve_cli.load_model(parsed)  # one rank, whole
        longs, shorts = parallel_bodies(ids, lens["cp" if cp else "tp"],
                                        shorts=1 if cp else 8)
        # under --cp a beam too: on the model axis, seq ranks repeating it
        beam = ({"tokens": [ids[:64]], "max_new_tokens": PAR_NEW,
                 "beam_width": PAR_BEAM_WIDTH} if cp else None)
        out = {"args": [*PAR_ARGS, *extra], "ranks": ranks}
        if device == "cuda":
            torch.cuda.empty_cache()
        run_dir = os.path.join(tmp, label)
        os.makedirs(run_dir)
        with CountedServe(args, run_dir, timeout=timeout,
                          ranks=ranks) as srv:
            port = srv.port
            out["ready_s"] = srv.ready_s
            before = json.loads(asyncio.run(http(port, "GET", "/v1/model")))
            srv.counts(zero=True)
            t0 = time.perf_counter()
            served, walls = [], []
            for body in longs:
                rows, wall = asyncio.run(generate_tokens(port, body))
                served.append(rows[0])
                walls.append(wall * 1e3)

            async def concurrent():
                return await asyncio.gather(*[generate_tokens(port, b)
                                              for b in shorts])

            for rows, wall in asyncio.run(concurrent()):
                served.append(rows[0])
                walls.append(wall * 1e3)
            if beam is not None:
                rows, wall = asyncio.run(generate_tokens(port, beam))
                beam_got = rows[0]
                walls.append(wall * 1e3)
            drive_s = time.perf_counter() - t0
            counts = srv.counts()
            info = json.loads(asyncio.run(http(port, "GET", "/v1/model")))
        bodies = longs + shorts
        judged = []
        for body, got in zip(bodies, served):
            if len(got) != body["max_new_tokens"]:
                raise AssertionError(f"{label}: {len(got)} tokens served")
            first, worst, _typical = judge_served(cfg, params, body, got,
                                                  parsed.max_len)
            if worst > NEAR_TIE_TOL:
                raise AssertionError(
                    f"{label}: served tokens off the one-rank model (prompt "
                    f"{len(body['tokens'][0])}): worst gap {worst}, first "
                    f"differing position {first}")
            judged.append({"prompt_len": len(body["tokens"][0]),
                           "equal_one_rank": first is None,
                           "worst_gap": worst})
        if beam is not None:
            check_rows([beam_got], 1, PAR_NEW, cfg.vocab_size)
            equal, gap = judge_beam(cfg, params, beam, beam_got,
                                    parsed.max_len)
            judged.append({"prompt_len": len(beam["tokens"][0]),
                           "beam_width": PAR_BEAM_WIDTH,
                           "equal_one_rank": equal,
                           "beam_score_rel_gap": gap})
        lockstep = info["lockstep"]
        want_mesh = ({"data": 1, "seq": 2, "model": 2} if cp
                     else {"data": 1, "model": 2})
        want_cp = {"seq": 2, "min_len": min_len} if cp else None
        # ranks sharing a card stage their collectives through the host
        # (gloo); a card a rank is NCCL; either way a tp round calls
        # collectives and runs uncaptured
        own_cards = device == "cuda" and torch.cuda.device_count() >= ranks
        mode = "uncaptured" if device == "cuda" else "eager"
        backend = "nccl" if own_cards else "gloo"
        if not (info["mesh"] == want_mesh and info["cp"] == want_cp
                and lockstep["step_program"] == mode
                and lockstep["backend"] == backend
                and lockstep["staging"] == (device == "cuda"
                                            and not own_cards)
                and lockstep["agree"] and len(lockstep["ranks"]) == ranks):
            raise AssertionError(
                f"{label}: /v1/model mesh {info['mesh']}, cp {info['cp']}, "
                f"lockstep {lockstep}")
        k1 = [c["k1"] for c in counts]
        k2 = [c["k2"] for c in counts]
        if device == "cuda":
            want_k1 = 0 if cp else cfg.n_layers
            if k1 != [want_k1] * ranks or (
                    "--int8" in extra) != all(n > 0 for n in k2) or (
                    "--int8" not in extra and any(k2)):
                raise AssertionError(f"{label}: K1 {k1}, K2 {k2} launches "
                                     "by rank")
        tokens = sum(len(t) for t in served)
        staged = lockstep["staged_bytes"] - before["lockstep"]["staged_bytes"]
        out.update({
            "judged": judged, "k1_launches_by_rank": k1,
            "k2_launches_by_rank": k2, "mesh": info["mesh"],
            "cp": info["cp"], "backend": lockstep["backend"],
            "staging": lockstep["staging"],
            "step_program": lockstep["step_program"],
            "ranks_agree": lockstep["agree"],
            "lockstep_ops": lockstep["ranks"][0]["ops"],
            "wall_ms_by_request": walls, "drive_s": drive_s,
            "tokens": tokens, "front_staged_bytes_a_token": staged / tokens,
        })
        del params
        if device == "cuda":
            torch.cuda.empty_cache()
        return out

    # each run's prompt ids drawn in PAR_RUNS' order; the runs then serve
    # at once (processes of their own: the script's clock; their walls
    # are no speed figure)
    vocab = serve_cli.build_arg_parser().parse_args(
        ["--device", device, *model, *PAR_ARGS, *extra_args]).vocab
    draws = [torch.randint(0, vocab, (max(lens["cp"]),),
                           generator=cpu).tolist() for _ in PAR_RUNS]
    with ThreadPoolExecutor(len(PAR_RUNS)) as pool:
        runs = [pool.submit(serve_run, *run, ids)
                for run, ids in zip(PAR_RUNS, draws)]
        for (label, *_rest), run in zip(PAR_RUNS, runs):
            result[label] = run.result()
    result["seconds"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# phase 26: the trainer across ranks made whole (train_resume)
# ---------------------------------------------------------------------------

# the train CLI at PARALLEL_CLI's width and depth, as 4 ranks on the
# mesh the reference factors them into (data 1 x model 4)
RESUME_MODEL = ["--vocab", "32768", "--d-model", "1024", "--n-heads", "8",
                "--n-layers", "2", "--seq-len", "1024", "--batch", "8",
                "--learning-rate", "1e-3"]
RESUME_STEPS = 6        # the uninterrupted run
RESUME_EVAL_EVERY = 3
RESUME_KILL = (1, 5)    # (rank, step after which it is SIGKILLed)
RESUME_REL_TOL = 1e-6   # the relaunch's losses against the uninterrupted's
RESUME_LORA_STEPS = 2  # checkpointed every step: both kept (keep 2)
# the 4-rank step-7 loss and the 2-rank LoRA losses against one rank:
# bf16 partial products summed in another order (read 2.49e-5 and
# 3.99e-6 at dp2 x tp2 on the card, up to 1.9e-4 at the rehearsal's
# tiny width on the CPU). A loss hardly sees a wrong LoRA gradient
# (Adam cancels its scale), so the 2-rank run also checkpoints every
# step, and one rank here takes each step from the 2-rank run's state
# before it: the step's Adam first moment (0.1 x the clipped gradient
# plus 0.9 x the shared moment before; A's gradient is 0 at step 1, B
# being 0, and enters at step 2) is held to the 2-rank run's within
# TRAIN_GRAD_REL_TOL (a gradient short of its model-axis sum reads near
# 1 in the CPU rehearsal with that sum removed; PERF.md)
RESUME_ONE_RANK_TOL = 5e-4
RESUME_TIMEOUT = 240    # seconds a world of the phase may take
# the train CLI's kernel launches a rank a step: forward + remat's
# recompute of every local layer, one dq and one dk/dv each
_RESUME_LAYERS = int(RESUME_MODEL[RESUME_MODEL.index("--n-layers") + 1])
RESUME_LAUNCHES = {"k1": 2 * _RESUME_LAYERS, "k3": _RESUME_LAYERS,
                   "k4": _RESUME_LAYERS}


def train_rank(argv) -> int:
    """One rank of a train_resume world (``python3 chip_smoke.py
    --train-rank LOG [--kill-after N] -- ARGS``): the train CLI's main
    on ARGS with its train step (or LoRA step) and restore wrapped to
    append to LOG, as JSON lines, every step's loss, start time, ms and
    K1/K3/K4 launches, and the restore's seconds; ``--kill-after N``
    SIGKILLs this rank right after step N is logged. Deterministic
    algorithms are asked for (a relaunched run is compared to the bit).
    Called in a process of its own's stead (the CPU tests run one rank
    in theirs), it leaves the package and that setting as it found
    them."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from containerpilot_tpu_torch import parallel
    from containerpilot_tpu_torch.ops import flash
    from containerpilot_tpu_torch.workload import train

    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    log_path = argv[argv.index("--train-rank") + 1]
    kill_after = (int(argv[argv.index("--kill-after") + 1])
                  if "--kill-after" in argv else None)
    log = open(log_path, "a")

    def record(**fields):
        log.write(json.dumps(fields) + "\n")
        log.flush()

    def logged(step_fn):
        def run(state, *rest):
            before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKDV_LAUNCHES)
            start = time.time()
            state, loss = step_fn(state, *rest)
            value = float(loss)  # synchronizes
            record(step=int(state.step), loss=value, start=start,
                   ms=(time.time() - start) * 1e3,
                   k1=flash.LAUNCHES - before[0],
                   k3=flash.DQ_LAUNCHES - before[1],
                   k4=flash.DKDV_LAUNCHES - before[2])
            if state.step == kill_after:
                os.kill(os.getpid(), signal.SIGKILL)
            return state, loss

        if hasattr(step_fn, "layout"):
            run.layout = step_fn.layout
        return run

    make_step, make_lora, restore = (parallel.make_train_step,
                                     parallel.make_lora_train_step,
                                     parallel.restore_checkpoint)

    def lora(*a, **k):
        init_fn, step_fn, abstract = make_lora(*a, **k)
        return init_fn, logged(step_fn), abstract

    def timed_restore(*a, **k):
        t0 = time.perf_counter()
        out = restore(*a, **k)
        record(restore_s=time.perf_counter() - t0, restored=out is not None)
        return out

    parallel.make_train_step = lambda *a, **k: logged(make_step(*a, **k))
    parallel.make_lora_train_step = lora
    parallel.restore_checkpoint = timed_restore
    try:
        return train.main(argv[argv.index("--") + 1:])
    finally:
        (parallel.make_train_step, parallel.make_lora_train_step,
         parallel.restore_checkpoint) = make_step, make_lora, restore
        torch.use_deterministic_algorithms(deterministic[0],
                                           warn_only=deterministic[1])
        log.close()


def _run_world(tmp, tag, args, ranks, device, kill=None,
               timeout=RESUME_TIMEOUT):
    """The train CLI as ``ranks`` train_rank children meeting through a
    file catalog of their own; waits for every child to exit BY ITSELF
    (one still alive at the timeout is killed and reported as None).
    Returns (exit codes, outputs, each rank's records, launch time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": root,
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    logs, procs, files = [], [], []
    t0 = time.time()
    try:
        for r in range(ranks):
            logs.append(os.path.join(tmp, f"{tag}.rank{r}.jsonl"))
            extra = (["--kill-after", str(kill[1])]
                     if kill is not None and kill[0] == r else [])
            fh = open(os.path.join(tmp, f"{tag}.rank{r}.log"), "w+")
            files.append(fh)
            procs.append(subprocess.Popen(
                [sys.executable, RANK_SCRIPT, "--train-rank", logs[-1], *extra,
                 "--", "--device", device, *args,
                 "--catalog", f"file:{os.path.join(tmp, 'catalog_' + tag)}",
                 "--num-processes", str(ranks), "--process-id", str(r),
                 "--advertise-address", "127.0.0.1",
                 "--coordinator-port", str(port)],
                cwd=root, env=env, stdout=fh, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and (
                time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        rcs = [p.poll() for p in procs]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for fh in files:
        fh.seek(0)
        outs.append(fh.read())
        fh.close()
    records = []
    for path in logs:
        with open(path) if os.path.exists(path) else open(os.devnull) as fh:
            records.append([json.loads(line) for line in fh])
    return rcs, outs, records, t0


def _steps_of(records):
    return [r for r in records if "step" in r]


def _world_ok(tag, rcs, outs):
    if rcs != [0] * len(rcs):
        i = next(i for i, rc in enumerate(rcs) if rc != 0)
        raise AssertionError(f"train_resume {tag}: exit codes {rcs}; rank "
                             f"{i}:\n{outs[i][-3000:]}")


def _launches_ok(tag, records, device):
    want = RESUME_LAUNCHES if device == "cuda" else dict.fromkeys(
        RESUME_LAUNCHES, 0)
    for r, recs in enumerate(records):
        for rec in _steps_of(recs):
            got = {k: rec[k] for k in want}
            if got != want:
                raise AssertionError(
                    f"train_resume {tag} rank {r} step {rec['step']}: "
                    f"launches {got}, want {want}")


def _launches_read(records):
    """The K1/K3/K4 launches a rank a step as the ranks logged them:
    {kernel: the one count every rank read at every step, or the sorted
    distinct counts}."""
    out = {}
    for k in RESUME_LAUNCHES:
        seen = sorted({rec[k] for recs in records for rec in _steps_of(recs)})
        out[k] = seen[0] if len(seen) == 1 else seen
    return out


def _save_figures(outs):
    """The CLI's save lines of rank 0: [(step, gather s, write s, host
    bytes)]."""
    return [{"step": int(m[0]), "gather_s": float(m[1]),
             "write_s": float(m[2]), "host_bytes": int(m[3])}
            for m in re.findall(
                r"checkpoint: step (\d+) gathered in ([\d.]+) s, written in "
                r"([\d.]+) s, (\d+) bytes", outs[0])]


def _lora_state_at(path, device):
    """A LoRA TrainState from one checkpoint file (adapters replicated:
    the file is every rank's state)."""
    from containerpilot_tpu_torch.parallel.train import TrainState

    raw = torch.load(path, weights_only=True)
    on = lambda tree: {k: torch.as_tensor(v).to(device)
                       for k, v in tree.items()}
    opt = raw["opt_state"]
    return TrainState(
        {k: v.requires_grad_(True) for k, v in on(raw["params"]).items()},
        {**opt, "mu": on(opt["mu"]), "nu": on(opt["nu"])}, int(raw["step"]))


def _resume_shards(tmp, vocab):
    """Token shards of the port's own source text (byte-level ids)."""
    import numpy as np

    from containerpilot_tpu_torch.workload.data import write_token_shards
    from containerpilot_tpu_torch.workload.text import ByteTokenizer

    root = os.path.dirname(os.path.abspath(__file__))
    tok = ByteTokenizer(vocab)
    ids = []
    for base, _dirs, names in sorted(os.walk(os.path.join(
            root, "containerpilot_tpu_torch"))):
        for name in sorted(names):
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(base, name), encoding="utf-8") as fh:
                    ids += tok.encode(fh.read())
    shards = os.path.join(tmp, "shards")
    write_token_shards(np.asarray(ids), shards)
    return shards, len(ids)


def drive_train_resume(tmp, card, device="cuda", model=None):
    """train_resume: the train CLI as 4 ranks (data 1 x model 4, the
    reference's factorization of the world) through a file
    catalog with checkpoints every 2 steps: an uninterrupted run with
    in-loop eval on the port's own source text; beside it, the same run
    with rank 1 SIGKILLed after step 5 (its peers must exit non-zero by
    themselves),
    relaunched (resumes at step 4, one step further): its losses against
    the uninterrupted run's and the two step-6 checkpoints against each
    other; the step-6 checkpoint in one rank here, one more step against
    the 4-rank continuation, and served by the serve CLI; --lora-rank 16
    on 2 ranks (model 2) against one rank here, losses and each step's
    gradient. K1/K3/K4 a rank a step as logged; start-up, save and
    restore seconds and the bytes staged on rank 0's host (none is a
    speed figure: the ranks share the card)."""
    from concurrent.futures import ThreadPoolExecutor

    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.parallel import (
        abstract_train_state,
        make_lora_train_step,
        make_train_step,
        restore_checkpoint,
        restore_params,
    )
    from containerpilot_tpu_torch.parallel.train import tree_leaves
    from containerpilot_tpu_torch.workload.data import TokenShardDataset
    from containerpilot_tpu_torch.workload.modelcfg import derive_d_ff

    t_phase = time.perf_counter()
    model = model or RESUME_MODEL
    arg = lambda name: int(model[model.index(name) + 1])
    vocab, seq, batch = arg("--vocab"), arg("--seq-len"), arg("--batch")
    shards, n_tokens = _resume_shards(tmp, vocab)
    holdout = 2 * batch
    data = ["--data-dir", shards, "--eval-holdout", str(holdout)]
    run = [*model, "--checkpoint-every", "2",
           *data, "--eval-every", str(RESUME_EVAL_EVERY)]
    full_ck, killed_ck = (os.path.join(tmp, n) for n in ("ck_full",
                                                         "ck_killed"))
    result = {"phase": "train_resume", "model": model, "ranks": 4,
              "mesh": {"data": 1, "model": 4}, "tokens": n_tokens, **card}

    # the uninterrupted run, and beside it the same run with rank 1 lost
    # after step 5 (a checkpoint directory and a catalog each)
    def killed_world():
        got = _run_world(tmp, "killed", [*run, "--steps", str(RESUME_STEPS),
                                         "--checkpoint-dir", killed_ck],
                         4, device, kill=RESUME_KILL)
        return (*got, time.time())

    with ThreadPoolExecutor(1) as pool:
        killed_run = pool.submit(killed_world)
        rcs, outs, recs, t0 = _run_world(
            tmp, "full", [*run, "--steps", str(RESUME_STEPS),
                          "--checkpoint-dir", full_ck], 4, device)
        killed = killed_run.result()
    _world_ok("full", rcs, outs)
    _launches_ok("full", recs, device)
    full = _steps_of(recs[0])
    if not all(_steps_of(r) and [x["loss"] for x in _steps_of(r)]
               == [x["loss"] for x in full] for r in recs):
        raise AssertionError("train_resume full: ranks disagree on losses")
    evals = [re.findall(r"step (\d+): eval_loss=([\d.]+)", out)
             for out in outs]
    if not (evals[0] and [int(s) for s, _ in evals[0]] == list(range(
            RESUME_EVAL_EVERY, RESUME_STEPS + 1, RESUME_EVAL_EVERY))
            and all(e == evals[0] for e in evals)):
        raise AssertionError(f"train_resume eval lines by rank: {evals}")
    mesh_line = f"mesh: {{'data': 1, 'model': 4}} on {device}"
    if any(mesh_line not in out for out in outs):
        raise AssertionError(f"train_resume mesh line:\n{outs[0][-2000:]}")
    result["uninterrupted"] = {
        "losses": [x["loss"] for x in full],
        "eval_losses": {s: float(v) for s, v in evals[0]},
        "startup_s": [_steps_of(r)[0]["start"] - t0 for r in recs],
        "step_ms": [[x["ms"] for x in _steps_of(r)] for r in recs],
        "saves": _save_figures(outs),
        "launches_a_rank_a_step": _launches_read(recs)}

    # rank 1 lost after step 5, then the relaunch (one step further)
    rcs, outs, _recs, t0, t_end = killed
    if rcs[RESUME_KILL[0]] != -signal.SIGKILL or any(
            rc in (0, None) for rc in rcs):
        raise AssertionError(
            f"train_resume killed: exit codes {rcs} (rank "
            f"{RESUME_KILL[0]} SIGKILLed, every peer must exit non-zero "
            f"by itself):\n{outs[0][-2000:]}")
    result["killed"] = {"exit_codes": rcs, "rank": RESUME_KILL[0],
                        "after_step": RESUME_KILL[1],
                        "seconds": t_end - t0}
    rcs, outs, recs, t0 = _run_world(
        tmp, "relaunched", [*run, "--steps", str(RESUME_STEPS + 1),
                            "--checkpoint-dir", killed_ck], 4, device)
    _world_ok("relaunched", rcs, outs)
    _launches_ok("relaunched", recs, device)
    resumed_at = RESUME_KILL[1] - RESUME_KILL[1] % 2
    if any(f"resumed from checkpoint at step {resumed_at}" not in out
           for out in outs):
        raise AssertionError(f"train_resume relaunch:\n{outs[0][-2000:]}")
    again = _steps_of(recs[0])
    pairs = [(a["loss"], b["loss"]) for a in full for b in again
             if a["step"] == b["step"]]
    worst = max(abs(a - b) / abs(a) for a, b in pairs)
    if not (len(pairs) == RESUME_STEPS - resumed_at
            and worst <= RESUME_REL_TOL):
        raise AssertionError(
            f"train_resume: relaunched losses {again} against "
            f"{full} (worst rel {worst})")
    a_raw, b_raw = (torch.load(os.path.join(d, f"step_{RESUME_STEPS}",
                                            "state.pt"), weights_only=True)
                    for d in (full_ck, killed_ck))
    diff = {part: max((torch.as_tensor(x).float()
                       - torch.as_tensor(y).float()).abs().max().item()
                      for x, y in zip(tree_leaves(a_raw[part]),
                                      tree_leaves(b_raw[part]))
                      if isinstance(x, torch.Tensor))
            for part in ("params", "opt_state")}
    del a_raw, b_raw
    continued = again[-1]
    result["relaunched"] = {
        "resumed_at": resumed_at, "losses": [x["loss"] for x in again],
        "worst_loss_rel_vs_uninterrupted": worst,
        "step6_max_abs_diff": diff,
        "startup_s": [_steps_of(r)[0]["start"] - t0 for r in recs],
        "restore_s": [next(x["restore_s"] for x in r if "restore_s" in x)
                      for r in recs],
        "saves": _save_figures(outs)}

    # the step-6 checkpoint in one rank: one more step, then served
    cfg = tf.TransformerConfig(
        vocab_size=vocab, d_model=arg("--d-model"), n_heads=arg("--n-heads"),
        n_layers=arg("--n-layers"), d_ff=derive_d_ff(arg("--d-model")),
        max_seq_len=seq)
    dataset = TokenShardDataset(shards, seq, batch, vocab_size=vocab,
                                holdout_windows=holdout)
    t0 = time.perf_counter()
    state = restore_checkpoint(full_ck, abstract_train_state(cfg),
                               device=device)
    restore_one_s = time.perf_counter() - t0
    step = make_train_step(cfg, learning_rate=1e-3)
    toks = torch.from_numpy(dataset.batch_at(RESUME_STEPS)).long().to(device)
    _state, loss = step(state, toks)
    one = float(loss)
    del state, _state
    rel = abs(one - continued["loss"]) / abs(continued["loss"])
    if not (continued["step"] == RESUME_STEPS + 1
            and rel <= RESUME_ONE_RANK_TOL):
        raise AssertionError(
            f"train_resume: one rank's step {RESUME_STEPS + 1} from the "
            f"checkpoint {one} against 4 ranks' {continued}")
    result["one_rank"] = {"step": RESUME_STEPS + 1, "loss": one,
                          "four_rank_loss": continued["loss"],
                          "loss_rel": rel, "restore_s": restore_one_s}
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        result["served"] = serve_checkpoint(
            full_ck, model[model.index("--d-model"):model.index(
                "--d-model") + 2] + ["--n-layers", str(arg("--n-layers")),
                                     "--n-heads", str(arg("--n-heads"))],
            vocab, emas=(False,))

    # LoRA on 2 ranks (model 2) against one rank
    lora_ck = os.path.join(tmp, "ck_lora")
    lora = [*model, *data, "--lora-rank",
            str(LORA_RANK), "--base-checkpoint-dir", full_ck,
            "--steps", str(RESUME_LORA_STEPS), "--checkpoint-dir", lora_ck,
            "--checkpoint-every", "1"]
    rcs, outs, recs, t0 = _run_world(tmp, "lora", lora, 2, device)
    _world_ok("lora", rcs, outs)
    _launches_ok("lora", recs, device)
    got = [x["loss"] for x in _steps_of(recs[0])]
    base, _step = restore_params(full_ck, abstract_train_state(cfg),
                                 device=device)
    init_fn, step_fn, _abstract = make_lora_train_step(cfg, LORA_RANK, 1e-3)
    state = init_fn(0, device)
    want, grad_rel = [], {}
    for i in range(RESUME_LORA_STEPS):
        if i:  # the 2-rank run's state after step i
            state = _lora_state_at(
                os.path.join(lora_ck, f"step_{i}", "state.pt"), device)
        toks = torch.from_numpy(dataset.batch_at(i)).long().to(device)
        state, loss = step_fn(state, base, toks)
        want.append(float(loss))
        got_mu = torch.load(os.path.join(lora_ck, f"step_{i + 1}",
                                         "state.pt"),
                            weights_only=True)["opt_state"]["mu"]
        for k, v in state.opt_state["mu"].items():
            v = v.detach().float().cpu()
            err = (torch.as_tensor(got_mu[k]).float() - v).abs().max().item()
            scale = v.abs().max().item()
            grad_rel[f"step{i + 1}_{k}"] = (
                err / scale if scale else (0.0 if err == 0 else math.inf))
    del base, state
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if not (len(got) == RESUME_LORA_STEPS
            and worst <= RESUME_ONE_RANK_TOL
            and max(grad_rel.values()) <= TRAIN_GRAD_REL_TOL
            and f"mesh: {{'data': 1, 'model': 2}} on {device}" in outs[0]):
        raise AssertionError(
            f"train_resume lora: 2-rank losses {got}, one rank {want}; "
            f"step-1 gradient (Adam's first moment) rel err {grad_rel}:\n"
            f"{outs[0][-2000:]}")
    result["lora_tp2"] = {"rank": LORA_RANK, "losses": got,
                          "one_rank_losses": want, "worst_loss_rel": worst,
                          "grad_rel_by_step_and_leaf": grad_rel,
                          "startup_s": [_steps_of(r)[0]["start"] - t0
                                        for r in recs]}
    result["seconds"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# phase 27: the pod server (serve_pod)
# ---------------------------------------------------------------------------

# the serve CLI flagship's width (d_ff 6144 as the CLI derives it) at 8
# layers, two serve_dist ranks sharing the card (tp2, gloo)
POD_MODEL = [*FACE_MODEL[:FACE_MODEL.index("--n-layers") + 1], "8",
             *FACE_MODEL[FACE_MODEL.index("--n-layers") + 2:]]
POD_ARGS = ["--slots", "8", "--int8", "--prefix-cache", "4",
            "--watchdog", "120"]
POD_RANKS = 2
POD_NEW = 15
POD_TIMEOUT = 300  # seconds the ranks may take to start
# serve_dist's main with the kernel counters zeroable from outside: a
# thread of its own takes SIGUSR2 (a rank's main thread may be waiting
# in gloo, where a Python signal handler would not run), zeroes K1/K2's
# counters and acknowledges by writing argv[1]; each rank logs its
# counters at exit ("pod rank stats")
COUNTED_POD = """
import json, os, signal, sys, threading

ACK = sys.argv[1]
# blocked before torch is imported: every thread made later inherits it
signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGUSR2})

def zeroing():
    while True:
        signal.sigwait({signal.SIGUSR2})
        from containerpilot_tpu_torch.ops import flash, quant
        flash.LAUNCHES = quant.LAUNCHES = 0
        with open(ACK + ".tmp", "w") as fh:
            json.dump({"k1": 0, "k2": 0}, fh)
        os.replace(ACK + ".tmp", ACK)

threading.Thread(target=zeroing, daemon=True).start()
from containerpilot_tpu_torch.workload.serve_dist import main
sys.exit(main(sys.argv[2:]))
"""


def _pod_rank_lines(log):
    """(the rank's exit figures, its start-up line's seconds) from a
    serve_dist log."""
    stats = [ln for ln in log.splitlines()
             if ln.startswith("pod rank stats ")]
    if not stats:
        raise AssertionError(f"a pod rank logged no stats:\n{log[-3000:]}")
    start = re.search(r"joined in ([0-9.]+)s, loaded in ([0-9.]+)s, warm "
                      r"in ([0-9.]+)s", log)
    return (json.loads(stats[-1][len("pod rank stats "):]),
            {k: float(v) for k, v in zip(("joined_s", "loaded_s", "warm_s"),
                                         start.groups())})


def drive_serve_pod(tmp, card, device="cuda", model=None, long_len=PROMPT_LEN,
                    timeout=POD_TIMEOUT, ranks=POD_RANKS, extra_args=()):
    """serve_pod: python -m containerpilot_tpu_torch.workload.serve_dist
    as POD_RANKS processes on this card (COUNTED_POD), rendezvoused on a
    file catalog, POD_MODEL with POD_ARGS. With every rank's counters
    zeroed just before: a ``long_len``-id prompt (the K1 prefill, a
    prefix-cache miss), 8 concurrent 15-token requests (the last
    sampled), /v1/score, a beam of width 2, an SSE stream and a prefix
    hit (the long prompt plus 16 ids); then SIGTERM to the frontend.
    Checks: every rank exits 0; K1 ``n_layers`` times a rank and K2 on
    every rank's blocks, as the ranks log them; the ranks' token
    digests and op counts agree; no capture, kernel build or load after
    warm-up on any rank; every greedy and sampled answer, the stream's
    included, judged against the one-rank model (judge_served); the
    score within E2E_REL_TOL of the one-rank scorer; the prefix hit
    counted. ``device="cpu"`` rehearses it on the plain versions with a
    small ``model`` (no kernel to count). ``ranks`` processes, with
    ``extra_args`` (e.g. ``--dp 2``) added to every one."""
    import dataclasses

    from containerpilot_tpu_torch.workload import modelcfg, serve_cli
    from containerpilot_tpu_torch.workload import serve_dist

    model = POD_MODEL if model is None else model
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cat = os.path.join(tmp, "pod_catalog")
    http_port, coord = _free_port(), _free_port()
    argv = ["--device", device, "--num-processes", str(ranks),
            "--catalog", f"file:{cat}", "--coordinator-port", str(coord),
            "--advertise-address", "127.0.0.1", "--host", "127.0.0.1",
            "--port", str(http_port), *model, *POD_ARGS, *extra_args]
    procs, logs, acks = [], [], []
    try:
        for r in range(ranks):
            acks.append(os.path.join(tmp, f"pod_zeroed{r}.json"))
            logs.append(os.path.join(tmp, f"pod{r}.log"))
            with open(logs[-1], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", COUNTED_POD, acks[-1],
                     "--process-id", str(r), *argv],
                    cwd=root, env={**os.environ, "PYTHONPATH": root},
                    stdout=fh, stderr=subprocess.STDOUT))
        t_boot = time.perf_counter()
        # the one-rank model of the same flags (every rank seeds the same
        # whole params, then cuts its blocks), for the judge
        parsed = serve_dist.build_arg_parser().parse_args(
            ["--process-id", "0", *argv])
        cfg, params, _ = serve_cli.load_model(parsed, say=lambda line: None)
        ids = torch.randint(0, cfg.vocab_size, (long_len + 16,),
                            generator=torch.Generator().manual_seed(27)
                            ).tolist()
        longs, shorts = parallel_bodies(ids, (long_len,), shorts=8)
        for body in longs + shorts:
            body["max_new_tokens"] = POD_NEW
        hit = {"tokens": [ids[:long_len + 16]], "max_new_tokens": POD_NEW}
        stream = {**shorts[0], "stream": True}
        score_row = ids[40:104]
        beam = {"tokens": [ids[20:30]], "max_new_tokens": POD_NEW,
                "beam_width": 2}
        deadline = time.monotonic() + timeout
        while True:
            for r, proc in enumerate(procs):
                if proc.poll() is not None:
                    raise AssertionError(
                        f"pod rank {r} exited {proc.returncode}:\n"
                        + open(logs[r]).read()[-3000:])
            try:
                asyncio.run(http(http_port, "GET", "/health"))
                break
            except (OSError, AssertionError):
                if time.monotonic() > deadline:
                    raise AssertionError("the pod never became healthy")
                time.sleep(0.2)
        ready_s = time.perf_counter() - t_boot
        for ack in acks:
            if os.path.exists(ack):
                os.remove(ack)
        for proc in procs:
            os.kill(proc.pid, signal.SIGUSR2)
        while not all(os.path.exists(a) for a in acks):
            if time.monotonic() > deadline:
                raise AssertionError("a pod rank did not zero its counters")
            time.sleep(0.01)
        t0 = time.perf_counter()
        walls, served, judged_bodies = {}, [], []
        rows, wall = asyncio.run(generate_tokens(http_port, longs[0]))
        walls["long"] = wall * 1e3
        served.append(rows[0])
        judged_bodies.append(longs[0])

        async def concurrent():
            return await asyncio.gather(*[generate_tokens(http_port, b)
                                          for b in shorts])

        walls["concurrent"] = []
        for (rows, wall), body in zip(asyncio.run(concurrent()), shorts):
            walls["concurrent"].append(wall * 1e3)
            served.append(rows[0])
            judged_bodies.append(body)
        t1 = time.perf_counter()
        scored = json.loads(asyncio.run(http(
            http_port, "POST", "/v1/score", {"tokens": [score_row]})))
        walls["score"] = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        beam_rows, _wall = asyncio.run(generate_tokens(http_port, beam))
        walls["beam"] = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        events = asyncio.run(read_sse(http_port, stream))
        walls["stream"] = (time.perf_counter() - t1) * 1e3
        if not events or events[-1].get("done") is not True:
            raise AssertionError(f"the pod's stream ended with {events[-1:]}")
        streamed = sum((e["tokens"] for e in events if "tokens" in e), [])
        served.append(streamed)
        judged_bodies.append(shorts[0])
        rows, wall = asyncio.run(generate_tokens(http_port, hit))
        walls["prefix_hit"] = wall * 1e3
        served.append(rows[0])
        judged_bodies.append(hit)
        drive_s = time.perf_counter() - t0
        info = json.loads(asyncio.run(http(http_port, "GET", "/v1/model")))
        procs[0].send_signal(signal.SIGTERM)
        rcs = [proc.wait(timeout=60) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    texts = [open(path).read() for path in logs]
    if rcs != [0] * ranks:
        raise AssertionError(f"pod ranks exited {rcs}:\n"
                             + "\n".join(t[-2000:] for t in texts))
    rank_stats, startup = zip(*(_pod_rank_lines(t) for t in texts))
    judged = []
    for body, got in zip(judged_bodies, served):
        first, worst, _typical = judge_served(cfg, params, body, got,
                                              parsed.max_len)
        if len(got) != POD_NEW or worst > NEAR_TIE_TOL:
            raise AssertionError(
                f"serve_pod: served tokens off the one-rank model (prompt "
                f"{len(body['tokens'][0])}): {len(got)} tokens, worst gap "
                f"{worst}, first differing position {first}")
        judged.append({"prompt_len": len(body["tokens"][0]),
                       "sampled": bool(body.get("temperature")),
                       "equal_one_rank": first is None,
                       "worst_gap": worst})
    check_rows(beam_rows, 1, POD_NEW, cfg.vocab_size)
    # judged against the plain attention: the pod's score takes K1 under
    # the card's crossover, so an AUTO scorer here would take it too
    with torch.inference_mode():
        want = modelcfg.score_logprobs_fn(
            dataclasses.replace(cfg, flash_min_seq=0))(
            params, torch.tensor([score_row], device=device))[0]
    score_err = rel_norm_err(torch.tensor(scored["logprobs"][0]),
                             want.float().cpu())
    if score_err > E2E_REL_TOL:
        raise AssertionError(f"serve_pod: /v1/score off one rank: "
                             f"{score_err}")
    k1 = [r["k1_launches"] for r in rank_stats]
    k2 = [r["k2_launches"] for r in rank_stats]
    # the long prompt's prefill, and /v1/score's forward over its row
    # padded to the flash block, where the crossover in force takes K1
    score_len = -(-(len(score_row) - 1) // 128) * 128
    want_k1 = cfg.n_layers * (k1_forwards(cfg, [long_len])
                              + k1_forwards(cfg, [score_len], "train"))
    if device == "cuda" and (k1 != [want_k1] * ranks
                             or not all(n > 0 for n in k2)):
        raise AssertionError(f"serve_pod: K1 {k1} (want {want_k1} a "
                             f"rank), K2 {k2} launches by rank")
    mode = "uncaptured" if device == "cuda" else "eager"
    first_use = [(r["captures_after_warm"], r["builds_after_warm"],
                  r["loads_after_warm"]) for r in rank_stats]
    if not (all(r["digest"] == rank_stats[0]["digest"]
                and r["ops"] == rank_stats[0]["ops"] for r in rank_stats)
            and all(r["step_program"] == mode for r in rank_stats)
            and first_use == [(0, 0, 0)] * ranks
            and info["prefix_cache"]["hits"] >= 1
            and info["pod"]["mesh"] == {"data": parsed.dp, "seq": 1,
                                        "model": ranks // parsed.dp}):
        raise AssertionError(f"serve_pod: ranks {rank_stats}, /v1/model "
                             f"{info}")
    tokens = sum(len(t) for t in served) + POD_NEW
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    return {
        "phase": "serve_pod", "model": model,
        "args": [*POD_ARGS, *extra_args],
        "ranks": ranks, "mesh": info["pod"]["mesh"],
        "k1_launches_by_rank": k1, "k1_want_a_rank": want_k1,
        "k2_launches_by_rank": k2,
        "digests": [r["digest"] for r in rank_stats],
        "ops_by_rank": [r["ops"] for r in rank_stats],
        "step_program": rank_stats[0]["step_program"],
        "captures_builds_loads_after_warm": first_use,
        "first_dispatches_after_warm": [r["fresh_after_warm"]
                                        for r in rank_stats],
        "judged": judged, "score_rel_err": score_err,
        "prefix_cache": info["prefix_cache"],
        "ready_s": ready_s, "rank_startup_s": list(startup),
        "wall_ms": walls, "drive_s": drive_s, "tokens": tokens,
        "front_staged_bytes_a_token": rank_stats[0]["staged_bytes"] / tokens,
        "exit_codes": rcs, "seconds": time.perf_counter() - t_phase,
        **card,
    }


# ---------------------------------------------------------------------------
# phase 28: the H100's own flash crossover (ops/autotune.py)
# ---------------------------------------------------------------------------

AUTOTUNE_SEQS = (512, 1024)
TABLE_KEYS = {"platform", "flash_min_seq", "blocks", "speedup_vs_default",
              "measurements"}


def drive_autotune(card):
    """``autotune.measure`` at AUTOTUNE_SEQS (K1 alone for ``fwd``, K1 +
    K3 + K4 through flash_attention's backward for ``train``, against
    the plain causal_attention), its table in the reference's schema;
    then the committed table of this card, found by discovery, and
    ``resolve_min_seq(AUTO, kind)`` answering its crossovers."""
    from containerpilot_tpu_torch.ops import autotune, flash, tuning

    t0 = time.perf_counter()
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKDV_LAUNCHES = 0
    results = autotune.measure(AUTOTUNE_SEQS, n=3, reps=2)
    launches = {"k1": flash.LAUNCHES, "k3": flash.DQ_LAUNCHES,
                "k4": flash.DKDV_LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"autotune.measure launched {launches}")
    slug = tuning.platform_slug()
    table = autotune.build_table(results, slug)
    default = list(autotune.DEFAULT_PAIR)
    if not (set(table) == TABLE_KEYS and table["platform"] == slug
            and all(isinstance(table["flash_min_seq"][k], int)
                    and table["blocks"][k] == {str(n): default
                                               for n in AUTOTUNE_SEQS}
                    and set(table["speedup_vs_default"][k].values()) == {1.0}
                    for k in ("fwd", "train"))
            and all(t > 0 for e in results.values()
                    for t in (e["xla_fwd_ms"], e["xla_train_ms"],
                              *e["flash"]["128x128"].values()))):
        raise AssertionError(f"autotune table off the schema: {table}")
    if os.environ.get("CONTAINERPILOT_FLASH_TABLE"):
        raise AssertionError("CONTAINERPILOT_FLASH_TABLE overrides the "
                             "committed table")
    path = os.path.join(os.path.dirname(os.path.abspath(tuning.__file__)),
                        "tuned", f"{slug}.json")
    if not os.path.exists(path):
        raise AssertionError(f"no committed flash table for {slug}: {path}")
    with open(path) as fh:
        committed = json.load(fh)
    tuning.set_table(None)  # rediscover from disk
    resolved = {kind: tuning.resolve_min_seq(tuning.AUTO, kind)
                for kind in ("fwd", "train")}
    if resolved != committed["flash_min_seq"] or tuning._table_path() != path:
        raise AssertionError(f"AUTO resolves to {resolved}, the committed "
                             f"table says {committed['flash_min_seq']}")
    return {
        "phase": "autotune", "seqs": list(AUTOTUNE_SEQS),
        "measured_min_seq": table["flash_min_seq"],
        "measurements": results, "launches": launches,
        "committed_table": os.path.relpath(
            path, os.path.dirname(os.path.abspath(__file__))),
        "committed_min_seq": committed["flash_min_seq"],
        "committed_card": committed.get("card"),
        "resolved_min_seq": resolved,
        "seconds": time.perf_counter() - t0, **card,
    }


# ---------------------------------------------------------------------------
# phase 29: the port starts as the system starts — its own supervisor
# ---------------------------------------------------------------------------

SUPERVISED_CONFIG = "containerpilot_tpu_torch/examples/serving-pod.json5"
SUPERVISED_NEW = 16
SUPERVISED_TIMEOUT = 300  # s to a passing job: start-up and first check
SUPERVISED_BATCH_ROWS = 8  # what -putenv hands the -reload's generation

# ``python3`` first on the supervisor's PATH: the serve CLI as the
# example execs it (python3 -m containerpilot_tpu_torch.workload.serve)
# runs as COUNTED_SERVE, whose signals zero and read the kernel
# counters; every other python3 command (the health check, the hooks)
# runs unchanged
PYTHON_SHIM = """#!{python}
import os, sys
if sys.argv[1:3] == ["-m", "containerpilot_tpu_torch.workload.serve"]:
    os.execv(sys.executable, [sys.executable, "-c", {code!r}, {counts!r}]
             + sys.argv[3:])
os.execv(sys.executable, [sys.executable] + sys.argv[1:])
"""


def _catalog_passing(port, name):
    return json.loads(asyncio.run(http(
        port, "GET", f"/v1/health/service/{name}?passing=1")))


def _gpu_pids():
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return {int(line) for line in out.split() if line.strip().isdigit()}


def _nvidia_files(pid):
    """The /dev/nvidia* device files ``pid`` holds open, which CUDA
    opens at its initialization (none in a process that only imported
    torch)."""
    fd_dir = f"/proc/{pid}/fd"
    held = set()
    for fd in os.listdir(fd_dir):
        with contextlib.suppress(OSError):
            target = os.readlink(os.path.join(fd_dir, fd))
            if target.startswith("/dev/nvidia"):
                held.add(target)
    return sorted(held)


def drive_chaos_promoted(tmp, card, device="cuda"):
    """The port's chaos CLI (``python -m containerpilot_tpu_torch.chaos``:
    the harness, its gateway and its replicas in that process, the
    replicas on ``device``) running ``kill_under_burst_promoted`` (a
    burst, a SIGKILLed replica repaired by promoting the warm standby
    while every new launch pays the armed slow boot). The CLI must exit
    0 and every check of the scenario's report pass, with the slow boot
    armed once, at least one promotion and no client-visible 5xx."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, "chaos_promoted.json")
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "containerpilot_tpu_torch.chaos",
         "--scenario", "kill_under_burst_promoted", "--seed", "5",
         "--device", device, "--json", out],
        cwd=root, env={**os.environ, "PYTHONPATH": root},
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if not os.path.exists(out):
        raise AssertionError(f"chaos CLI exit {done.returncode}: "
                             f"{done.stderr[-3000:]}")
    with open(out) as fh:
        report = json.load(fh)["scenarios"][0]
    failed = [c for c in report["checks"] if not c["ok"]]
    standby = (report["autoscaler"] or {}).get("standby") or {}
    promotions = standby.get("promotions", 0)
    score = report["score"]
    events = report["goodput_ledger"]["scale_events"]
    summary = {
        "phase": "chaos_promoted", "seconds": seconds, "device": device,
        "checks": [c["name"] for c in report["checks"]],
        "goodput_fraction": score["goodput_fraction"],
        "goodput_rps": score["goodput_rps"],
        "admitted_goodput_fraction": score["goodput_fraction_admitted"],
        "ttft_ms": score["ttft_ms"], "tpot_ms": score["tpot_ms"],
        "requests": score["requests"], "count_5xx": score["count_5xx"],
        "promotions": promotions,
        "cold_launches": standby.get("cold_launches"),
        "promoted_ttfrt_s": [e.get("ttfrt_s") for e in events
                             if e.get("mode") == "promoted"],
        "loop_lag_max_ms": report["loop_lag_max_ms"],
        "fault_counts": report["fault_counts"],
        "productive_fraction":
            report["goodput_ledger"]["productive_fraction"],
        **card,
    }
    if (done.returncode != 0 or failed or not report["passed"]
            or report["fault_counts"].get("slow_boot") != 1
            or promotions < 1 or score["count_5xx"] != 0):
        raise AssertionError(
            f"chaos_promoted: exit {done.returncode}, failed checks "
            f"{failed}, {json.dumps(summary, default=str)}")
    return summary


def drive_supervised_serve(tmp, card, device="cuda", model=None):
    """python -m containerpilot_tpu_torch -config SUPERVISED_CONFIG on the
    port's own -catalog-server, the example's model (the flagship, d_ff
    8192) unless ``model`` overrides its template variables, then every
    control verb of the port's CLI against it. ``device="cpu"`` rehearses
    the path with a small ``model`` (no kernel to count, no card)."""
    from concurrent.futures import ThreadPoolExecutor

    from containerpilot_tpu_torch.models import decode
    from containerpilot_tpu_torch.workload import serve_cli

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    cat_port, tel_port, serve_port = _free_port(), _free_port(), _free_port()
    counts_path = os.path.join(tmp, "kernel_counts.json")
    shim_dir = os.path.join(tmp, "bin")
    os.makedirs(shim_dir)
    shim = os.path.join(shim_dir, "python3")
    with open(shim, "w") as fh:
        fh.write(PYTHON_SHIM.format(python=sys.executable,
                                    code=COUNTED_SERVE, counts=counts_path))
    os.chmod(shim, 0o755)
    env = {**os.environ, "PYTHONPATH": root,
           "PATH": shim_dir + os.pathsep + os.environ.get("PATH", ""),
           "CONSUL": f"127.0.0.1:{cat_port}",
           "CONTROL_SOCKET": os.path.join(tmp, "cp.socket"),
           "TELEMETRY_PORT": str(tel_port), "SERVE_PORT": str(serve_port),
           "DEVICE": device, **(model or {})}
    env.pop("MAX_BATCH_ROWS", None)
    config = os.path.join(root, SUPERVISED_CONFIG)

    def cli(*args):
        done = subprocess.run(
            [sys.executable, "-m", "containerpilot_tpu_torch",
             "-config", config, *args], cwd=root, env=env,
            capture_output=True, text=True, timeout=60)
        if done.returncode != 0:
            raise AssertionError(f"{args}: rc {done.returncode}: "
                                 f"{done.stdout}{done.stderr}")
        return done.stdout

    sup_log = os.path.join(tmp, "supervisor.log")
    catalog = subprocess.Popen(
        [sys.executable, "-m", "containerpilot_tpu_torch",
         "-catalog-server", f"127.0.0.1:{cat_port}"],
        cwd=root, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    sup, job_pids, out = None, [], {"phase": "supervised_serve",
                                    "config": SUPERVISED_CONFIG,
                                    "model": model or "flagship"}

    def log_tail():
        with open(sup_log) as fh:
            return fh.read()[-4000:]

    def wait_job(label, exclude=()):
        """The pid of the job the supervisor started (not one of
        ``exclude``)."""
        deadline = time.monotonic() + SUPERVISED_TIMEOUT
        while True:
            if sup.poll() is not None:
                raise AssertionError(f"supervisor exited {sup.returncode}"
                                     f":\n{log_tail()}")
            jobs = [pid for pid in child_pids(sup.pid)
                    if pid not in exclude and _is_counted(pid)]
            if jobs:
                return jobs[0]
            if time.monotonic() > deadline:
                raise AssertionError(f"{label}: no job started:\n"
                                     f"{log_tail()}")
            time.sleep(0.1)

    def wait_passing(label, since):
        """Seconds from ``since`` until the catalog lists ``inference``
        passing."""
        deadline = time.monotonic() + SUPERVISED_TIMEOUT
        while True:
            if sup.poll() is not None:
                raise AssertionError(f"supervisor exited {sup.returncode}"
                                     f":\n{log_tail()}")
            try:
                if _catalog_passing(cat_port, "inference"):
                    return time.perf_counter() - since
            except (OSError, AssertionError):
                pass
            if time.monotonic() > deadline:
                raise AssertionError(f"{label}: the job never passed:\n"
                                     f"{log_tail()}")
            time.sleep(0.2)

    def counts(sig):
        if os.path.exists(counts_path):
            os.remove(counts_path)
        os.kill(job_pids[-1], sig)
        deadline = time.monotonic() + 30
        while not os.path.exists(counts_path):
            if time.monotonic() > deadline:
                raise AssertionError("the job did not report its counts")
            time.sleep(0.02)
        with open(counts_path) as fh:
            return json.load(fh)

    try:
        # the job registers at its first passing check, long after the
        # catalog server is up: both start at once
        t_start = time.perf_counter()
        with open(sup_log, "w") as fh:
            sup = subprocess.Popen(
                [sys.executable, "-m", "containerpilot_tpu_torch",
                 "-config", config], cwd=root, env=env, stdout=fh,
                stderr=subprocess.STDOUT)
        job_pids.append(wait_job("start"))
        # the same seeded model in this process, loaded while the job
        # loads its own
        parsed = serve_cli.build_arg_parser().parse_args(
            _job_argv(job_pids[-1]))
        cfg, params, _ = serve_cli.load_model(parsed, device=device,
                                              say=lambda line: None)
        out["first_passing_s"] = wait_passing("start", t_start)

        # -- a greedy 1024-token request through the job's port ------------
        prompt = torch.randint(0, cfg.vocab_size, (PROMPT_LEN,),
                               generator=torch.Generator().manual_seed(29)
                               ).tolist()
        counts(signal.SIGUSR2)
        rows, wall = asyncio.run(generate_tokens(
            serve_port, {"tokens": [prompt],
                         "max_new_tokens": SUPERVISED_NEW}))
        k = counts(signal.SIGUSR1)
        check_rows(rows, 1, SUPERVISED_NEW, cfg.vocab_size)
        want_k1 = cfg.n_layers * k1_forwards(cfg, [PROMPT_LEN])
        if device == "cuda" and (k["k1"] != want_k1 or k["k2"] != 0):
            raise AssertionError(f"supervised job: K1 {k['k1']} (want "
                                 f"{want_k1}), K2 {k['k2']}")
        # while the job serves on the card, the supervisor that forked it
        # and the catalog server have not initialized CUDA: no
        # /dev/nvidia* file open, no compute context (the job has both)
        if device == "cuda":
            on_card = _gpu_pids()
            files = {name: _nvidia_files(pid) for name, pid in (
                ("job", job_pids[-1]), ("supervisor", sup.pid),
                ("catalog", catalog.pid))}
            if (not files["job"] or files["supervisor"] or files["catalog"]
                    or {sup.pid, catalog.pid} & on_card):
                raise AssertionError(
                    f"while the job serves: /dev/nvidia* files held "
                    f"{files}; nvidia-smi compute pids {sorted(on_card)} "
                    f"(supervisor {sup.pid}, catalog {catalog.pid})")
            out["while_serving"] = {
                "nvidia_files": files,
                "job_listed_by_nvidia_smi": job_pids[-1] in on_card}
        with torch.inference_mode():
            local = decode.generate(
                params, torch.tensor([prompt], device=device), cfg,
                SUPERVISED_NEW, parsed.max_len).tolist()
        del params
        if device == "cuda":
            torch.cuda.empty_cache()
        if rows != local:
            raise AssertionError(f"supervised tokens {rows} differ from "
                                 f"in-process generate {local}")
        out.update({"cfg": {"vocab": cfg.vocab_size, "d_model": cfg.d_model,
                            "n_heads": cfg.n_heads,
                            "n_layers": cfg.n_layers, "d_ff": cfg.d_ff},
                    "k1_launches": k["k1"], "k1_want": want_k1,
                    "k2_launches": k["k2"], "request_ms": wall * 1e3,
                    "tokens_equal_in_process": True})

        # -- the supervisor's telemetry and control verbs ------------------
        status = json.loads(asyncio.run(http(tel_port, "GET", "/status")))
        if {"Name": "inference", "Status": "healthy"} not in status["Jobs"]:
            raise AssertionError(f"/status: {status}")
        with ThreadPoolExecutor(3) as pool:
            said = list(pool.map(lambda args: cli(*args), [
                ("-ping",), ("-putmetric", "served_requests=1"),
                ("-putenv", f"MAX_BATCH_ROWS={SUPERVISED_BATCH_ROWS}")]))
        if said[0].strip() != "ok":
            raise AssertionError("-ping did not answer ok")
        metrics = asyncio.run(http(tel_port, "GET", "/metrics")).decode()
        for line in ('cp_build_info{role="supervisor",',
                     'containerpilot_events_total{code="metric",'
                     'source="served_requests|1"} 1.0',
                     'containerpilot_control_http_requests_total{'
                     'path="/v3/metric",status="200"} 1.0',
                     "process_resident_memory_bytes "):
            if line not in metrics:
                raise AssertionError(f"/metrics lacks {line!r}")
        cli("-maintenance", "enable")
        deadline = time.monotonic() + 30
        while _catalog_passing(cat_port, "inference"):
            if time.monotonic() > deadline:
                raise AssertionError("maintenance: the catalog still lists "
                                     "the job passing")
            time.sleep(0.2)
        cli("-reload")
        t_reload = time.perf_counter()
        job_pids.append(wait_job("reload", exclude=job_pids))
        out["reload_passing_s"] = wait_passing("reload", t_reload)
        info = json.loads(asyncio.run(http(serve_port, "GET", "/v1/model")))
        if info["batching"]["max_batch_rows"] != SUPERVISED_BATCH_ROWS:
            raise AssertionError(f"the reloaded job serves {info}, not "
                                 f"-putenv's MAX_BATCH_ROWS")
        rows2, _ = asyncio.run(generate_tokens(
            serve_port, {"tokens": [prompt],
                         "max_new_tokens": SUPERVISED_NEW}))
        if rows2 != rows:
            raise AssertionError("the reloaded job answers otherwise")

        # -- SIGTERM: stopping, stopped, exit 0, the card released ---------
        sup.send_signal(signal.SIGTERM)
        rc = sup.wait(timeout=120)
        text = log_tail()
        hooks = [text.find(f"inference {word}") for word in ("stopping",
                                                              "stopped")]
        if rc != 0 or not 0 <= hooks[0] < hooks[1]:
            raise AssertionError(f"supervisor exit {rc}, stopping/stopped "
                                 f"hooks at {hooks}:\n{text}")
        left = json.loads(asyncio.run(http(
            cat_port, "GET", "/v1/health/service/inference")))
        holding = sorted(_gpu_pids() & set(job_pids)) if (
            device == "cuda") else []
        if left or holding or any(_alive(p) for p in job_pids):
            raise AssertionError(f"after SIGTERM: catalog {left}, pids "
                                 f"holding the card {holding}")
        out.update({"supervisor_rc": rc, "job_pids": job_pids,
                    "seconds": time.perf_counter() - t0, **card})
        return out
    finally:
        for proc in (sup, catalog):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
        for pid in job_pids:
            if _alive(pid):
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(pid, signal.SIGKILL)


def _is_counted(pid):
    """Whether ``pid`` runs the serve CLI as COUNTED_SERVE."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return COUNTED_SERVE.encode() in fh.read()
    except OSError:
        return False


def _job_argv(pid):
    """The serve CLI flags of the job ``pid`` (after COUNTED_SERVE's
    code and counts path)."""
    with open(f"/proc/{pid}/cmdline", "rb") as fh:
        argv = fh.read().decode().split("\0")[:-1]
    return argv[argv.index("-c") + 3:]


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def drive_lint() -> dict:
    """The port's lint gate (``python -m containerpilot_tpu_torch.analysis``:
    byte-compile, then the cpcheck and call-graph rules over the port's
    source against its baseline) in a subprocess; run in a thread beside
    the kernel phases. A non-zero exit fails the run."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "containerpilot_tpu_torch.analysis"],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(
            f"the port's lint gate exited {proc.returncode}:\n"
            f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    found = re.search(r"cpcheck: clean \(package; (\d+) finding",
                      proc.stdout)
    if found is None:
        raise AssertionError(f"no verdict from the lint gate: {proc.stdout}")
    with open(os.path.join(root, "containerpilot_tpu_torch", "analysis",
                           "baseline.json")) as fh:
        baselined = len(json.load(fh)["entries"])
    return {"phase": "lint", "rc": proc.returncode, "seconds": seconds,
            "findings": int(found.group(1)), "baselined": baselined}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--rank-job"]:  # a train_parallel child
        return rank_job(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--train-rank"]:  # a train_resume child
        return train_rank(sys.argv[1:])
    from concurrent.futures import ThreadPoolExecutor

    from containerpilot_tpu_torch.models import decode, quantized
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import _build, flash, quant

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = {"kind": kind, "nvidia_smi": smi}
    emit({"phase": "device", **card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    # the lint gate runs on the host beside the kernel phases (joined
    # before the summary)
    lint_pool = ThreadPoolExecutor(1)
    lint_run = lint_pool.submit(drive_lint)

    emit({"phase": "build", "seconds": _build.build_all(),
          "sources": _build.sources()})

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash_rows = [check_flash(gen, *c) for c in FWD_CASES]
    emit({"phase": "kernels", "kernel": "flash_fwd", "results": flash_rows,
          **card})
    int8_rows = [
        check_int8(gen, m, k, n) for m in INT8_M_CASES for (k, n) in INT8_PROJ
    ]
    emit({"phase": "kernels", "kernel": "int8_matmul", "results": int8_rows,
          **card})
    bwd_rows = [check_flash_bwd(gen, *c) for c in BWD_CASES]
    emit({"phase": "kernels", "kernel": "flash_bwd_dq+flash_bwd_dkdv",
          "results": bwd_rows, **card})

    # ---- the card's flash crossover: measured, and the committed table --
    autotune = drive_autotune(card)
    emit(autotune)

    # ---- serve bf16 -----------------------------------------------------
    cfg = tf.TransformerConfig(**FLAGSHIP)
    masters = tf.init_params(0, cfg, device="cuda")
    params = quantized.cast_params(masters, cfg.dtype)
    prompt = torch.randint(
        0, cfg.vocab_size, (PROMPT_LEN,), generator=gen, device="cuda"
    ).tolist()
    flash.LAUNCHES = 0
    serve_bf16 = asyncio.run(drive_server(cfg, params, prompt, "serve_bf16"))
    k1_launches = flash.LAUNCHES
    if k1_launches < cfg.n_layers:
        raise AssertionError(
            f"flash kernel launched {k1_launches} times on the serving path"
        )
    toks = torch.tensor([prompt], device="cuda")
    with torch.inference_mode():
        via_kernel = tf.forward(params, toks, cfg)[0, -64:]
        plain_cfg = tf.TransformerConfig(**FLAGSHIP, flash_min_seq=0)
        via_plain = tf.forward(params, toks, plain_cfg)[0, -64:]
    e2e = logits_rel_err(via_kernel, via_plain)
    if not (torch.isfinite(via_kernel).all() and e2e <= E2E_REL_TOL):
        raise AssertionError(f"flash-path logits off the plain path: {e2e}")
    serve_bf16.update({
        "flash_launches": k1_launches, "logits_rel_err_vs_plain": e2e,
        "resident_param_bytes": quantized.param_bytes(params), **card,
    })
    emit(serve_bf16)
    del via_kernel, via_plain

    # ---- serve slots, bf16 ----------------------------------------------
    slots_bf16 = asyncio.run(drive_slots(cfg, params, prompt,
                                         "serve_slots_bf16"))
    if slots_bf16["k1_launches"] < cfg.n_layers:
        raise AssertionError(
            f"K1 launched {slots_bf16['k1_launches']} times on the slot "
            "path (1024-token admissions)")
    slots_bf16.update({
        "batcher_decode_tok_s_batch8": serve_bf16["decode_tok_s_batch8"],
        **card})
    emit(slots_bf16)

    # ---- serve a sliding window: ring, then ring + int8 KV --------------
    cfg_w = tf.TransformerConfig(**{**FLAGSHIP, "n_layers": CUT_LAYERS,
                                    "max_seq_len": WINDOW_MAX_LEN},
                                 window=WINDOW, kv_int8=True)
    long_prompt = torch.randint(
        0, cfg.vocab_size, (WINDOW_PROMPT_LEN,), generator=gen, device="cuda"
    ).tolist()
    serve_window = drive_window_server(cfg_w, first_layers(params),
                                       long_prompt)
    serve_window.update(card)
    emit(serve_window)
    del params

    # ---- serve int8 -----------------------------------------------------
    qparams = quantized.cast_params(
        quantized.quantize_model_params(masters), cfg.dtype
    )
    del masters
    torch.cuda.empty_cache()
    quant.LAUNCHES = 0
    flash.LAUNCHES = 0
    serve_int8 = asyncio.run(drive_server(cfg, qparams, prompt, "serve_int8"))
    k2_launches = quant.LAUNCHES
    if k2_launches < 7 * cfg.n_layers:
        raise AssertionError(
            f"int8 kernel launched {k2_launches} times on the serving path"
        )
    # small inputs on the card (int8 kernel) and on the CPU (its plain
    # version), same weights: batch 1, prefill 16 tokens + 3 decode steps
    # (m = 1); batch 8, prefill 16 tokens, one 16-token decode_chunk
    # (m = 128) + 3 decode steps (m = 8)
    short = torch.tensor([prompt[:16]])
    short8 = torch.tensor([[(t * 7 + r) % cfg.vocab_size for t in prompt[:16]]
                           for r in range(8)])
    cpu_params = {k: v for k, v in qparams.items() if k != "layers"}
    cpu_params = {k: v.cpu() for k, v in cpu_params.items()}
    cpu_params["layers"] = {k: v.cpu() for k, v in qparams["layers"].items()}
    worst = {}
    with torch.inference_mode():
        for label, toks, chunk in (("batch1", short, False),
                                   ("batch8", short8, True)):
            runs = []
            for p, dev in ((qparams, "cuda"), (cpu_params, "cpu")):
                logits, cache = decode.prefill(p, toks.to(dev), cfg, 64)
                steps = []
                if chunk:
                    logits, cache = decode.decode_chunk(
                        p, cache, toks.to(dev), cfg)
                    steps.append(logits.float().cpu())
                for i in range(3):
                    logits, cache = decode.decode_step(
                        p, cache, toks[:, i].to(dev), cfg
                    )
                    steps.append(logits.float().cpu())
                runs.append(steps)
            worst[label] = 0.0
            for gpu_l, cpu_l in zip(*runs):
                if not torch.isfinite(gpu_l).all():
                    raise AssertionError(
                        f"non-finite int8 decode logits ({label})")
                worst[label] = max(worst[label], logits_rel_err(gpu_l, cpu_l))
    if max(worst.values()) > E2E_REL_TOL:
        raise AssertionError(f"int8 decode logits off the CPU path: {worst}")
    serve_int8.update({
        "int8_launches": k2_launches, "flash_launches": flash.LAUNCHES,
        "decode_logits_rel_err_vs_cpu": worst["batch1"],
        "decode_logits_rel_err_vs_cpu_batch8": worst["batch8"],
        "resident_param_bytes": quantized.param_bytes(qparams), **card,
    })
    emit(serve_int8)
    del cpu_params

    # ---- serve slots, int8 ----------------------------------------------
    slots_int8 = asyncio.run(drive_slots(cfg, qparams, prompt,
                                         "serve_slots_int8",
                                         prefill_chunk=256))
    if not (slots_int8["k2_launches_decode_replays"] > 0
            and slots_int8["k2_launches_admission"] > 0):
        raise AssertionError(
            f"K2 on the int8 slot path: {slots_int8['k2_launches']} "
            f"launches, {slots_int8['k2_launches_decode_replays']} in "
            "decode replays")
    slots_int8.update({
        "batcher_decode_tok_s_batch8": serve_int8["decode_tok_s_batch8"],
        **card})
    emit(slots_int8)

    # ---- serve slots, int8 weights, window ring + int8 KV ---------------
    slots_window = drive_slots_window(cfg_w, first_layers(qparams),
                                      long_prompt)
    if not (slots_window["k2_launches_decode_replays"] > 0
            and slots_window["k2_launches_admission"] > 0):
        raise AssertionError(
            f"K2 on the windowed int8 slot path: "
            f"{slots_window['k2_launches']} launches")
    slots_window.update({
        "steady_step_ms_int8_max_len_2048": slots_int8["steady_step_ms"],
        **card})
    emit(slots_window)

    del qparams
    torch.cuda.empty_cache()

    # ---- train ----------------------------------------------------------
    train = drive_training(gen)
    train.update(card)
    emit(train)

    # ---- train with a sliding window ------------------------------------
    train_window = drive_training(gen, "train_window", {"window": WINDOW},
                                  n_timed=3, extra=False)
    train_window.update(card)
    emit(train_window)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- train CLI: preempt and resume; serve its checkpoint -------
        train_cli, serve_ckpt = drive_train_cli(tmp)
        emit({**train_cli, **card})
        emit({**serve_ckpt, **card})

        # ---- beams and speculative decoding, bf16 then int8 ------------
        cfg_cut = tf.TransformerConfig(**{**FLAGSHIP,
                                          "n_layers": CUT_LAYERS})
        masters = tf.init_params(0, cfg_cut, device="cuda")
        serve_beam, serve_spec = serve_beam_spec(cfg_cut, masters, prompt,
                                                 card)
        emit(serve_beam)
        emit(serve_spec)
        del masters
        torch.cuda.empty_cache()

        # ---- LoRA: fine-tune at full width, then the CLI chain ---------
        train_lora = drive_train_lora(gen)
        train_lora.update(card)
        emit(train_lora)
        serve_lora = drive_serve_lora(tmp, CLI_MODEL)
        emit({**serve_lora, **card})

        # ---- the telemetry and wire face through the serve CLI ---------
        fleet_face = drive_fleet_face(tmp, card, gen)
        emit(fleet_face)

        # ---- the replica in a fleet: KV handoff, drain, standby, the ----
        # port's gateway
        handoff = drive_fleet_handoff(tmp, card)
        emit(handoff)

        # ---- the chaos CLI, alone: its latency floors move with what --
        # shares the host (scripts/torch_chaos_spread.py)
        chaos_promoted = drive_chaos_promoted(tmp, card)
        print(f"chaos_promoted: goodput "
              f"{chaos_promoted['goodput_fraction']}, TTFT p99 "
              f"{chaos_promoted['ttft_ms']['p99']} ms, promotions "
              f"{chaos_promoted['promotions']}", flush=True)
        emit(chaos_promoted)

    # ---- a switch-routed mixture of experts -----------------------------
    serve_moe, slots_moe, train_moe = drive_moe(gen, prompt, card)

    # ---- training across ranks on this card -----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_parallel = drive_train_parallel(gen, tmp)
    emit({**train_parallel, **card})
    parallel_launches = {
        key: {name: layout["launches_a_rank_a_step"][key]
              for name, layout in train_parallel["layouts"].items()}
        for key in ("k1_launches", "dq_launches", "dkdv_launches")}

    # ---- tensor- and context-parallel serving on this card --------------
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        serve_parallel = drive_serve_parallel(tmp, card)
    emit(serve_parallel)
    shard_k1 = serve_parallel["per_shard_kernels"]["flash_fwd"]
    shard_k2 = serve_parallel["per_shard_kernels"]["int8_matmul"]
    par_launches = {
        key: {label: serve_parallel[label][f"{key}_launches_by_rank"]
              for label in ("tp2", "tp2_int8", "tp2_cp2")}
        for key in ("k1", "k2")}
    # the composed pod P: a rank's launches on each of its paths
    pod_paths = {
        key: {path: [r[key] for r in by_rank] for path, by_rank in
              serve_parallel["tp2_int8"]["launches_by_path"].items()
              if path != "e"}
        for key in ("k1", "k2")}

    # ---- the trainer across ranks: checkpoints, crash, resume, LoRA; ----
    # ---- beside it the pod server (serve_dist ranks) and the port under -
    # its own supervisor and catalog server: the three phases are mostly
    # other processes starting up and waiting, so they run at once (the
    # script's clock). None reads this process's kernel counters: each
    # rank, pod rank and supervised job counts its own.
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory() as pod_tmp, \
            tempfile.TemporaryDirectory() as sup_tmp, \
            ThreadPoolExecutor(2) as pool:
        supervised_run = pool.submit(drive_supervised_serve, sup_tmp, card)
        pod_run = pool.submit(drive_serve_pod, pod_tmp, card)
        train_resume = drive_train_resume(tmp, card)
        serve_pod = pod_run.result()
        supervised = supervised_run.result()
    emit(train_resume)
    emit(serve_pod)
    emit(supervised)
    resume_launches = train_resume["uninterrupted"]["launches_a_rank_a_step"]

    emit(lint_run.result())
    lint_pool.shutdown()

    # ---- summary --------------------------------------------------------
    main_flash = flash_rows[0]
    train_flash = flash_rows[FWD_CASES.index(TRAIN_FWD_CASE)]
    window_bwd = bwd_rows[BWD_CASES.index(WINDOW_BWD_CASE)]
    shard_bwd = train_parallel["per_shard_kernels"]["flash_bwd"]
    k2_layer = {f"m={m}": int8_per_layer(int8_rows, m) for m in INT8_LAYER_M}
    k2_main = k2_layer["m=1"]
    kernels = [
        {
            "name": "flash_fwd", "route": "cuda",
            "source": "containerpilot_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "containerpilot_tpu/ops/flash.py:142",
            "launches": k1_launches,
            "max_abs_err": max(r["max_abs_err"] for r in flash_rows + [
                train_parallel["per_shard_kernels"]["flash_fwd"]]),
            "ms": main_flash["ms"], "plain_ms": main_flash["plain_ms"],
            "bound_ms": main_flash["bound_ms"],
            "bound_by": main_flash["bound_by"],
            "library_ms": main_flash["library_ms"],
            "tflops": main_flash["tflops"],
            "shape": "b=1 s=1024 h=16 kv=16 hd=128, one prefill layer",
            "train_launches": train["k1_launches"],
            "train_shape": "b=8 s=2048 h=8 hd=128, one training layer",
            "train_ms": train_flash["ms"],
            "train_tflops": train_flash["tflops"],
            "train_plain_ms": train_flash["plain_ms"],
            "train_library_ms": train_flash["library_ms"],
            "train_bound_ms": train_flash["bound_ms"],
            "train_bound_by": train_flash["bound_by"],
            "slot_launches": {"serve_slots_bf16": slots_bf16["k1_launches"],
                              "serve_slots_int8": slots_int8["k1_launches"]},
            "windowed": {
                "prefill": kernel_case(flash_rows[FWD_CASES.index(
                    WINDOW_PREFILL_CASE)]),
                "train": kernel_case(flash_rows[FWD_CASES.index(
                    WINDOW_TRAIN_CASE)]),
                "launches": {
                    "serve_window_ring": serve_window["ring"]["k1_launches"],
                    "serve_window_ring_kv_int8":
                        serve_window["ring_kv_int8"]["k1_launches"],
                    "serve_slots_window_int8": slots_window["k1_launches"],
                    "train_window": train_window["k1_launches"],
                },
            },
            "beam_speculative_lora_launches": {
                **{f"{phase['phase']}_{label}":
                   phase[label]["k1_launches"]
                   for phase in (serve_beam, serve_spec)
                   for label in ("bf16", "int8")},
                "train_lora": train_lora["k1_launches"],
            },
            "fleet_face_launches": {
                f"serve_fleet_face_{label}": fleet_face[label]["k1_launches"]
                for label in ("bf16", "int8")},
            "fleet_handoff_launches": {
                f"serve_fleet_handoff_{name}": handoff["launches"][name]["k1"]
                for name in ("A", "B", "C", "A_gateway", "B_gateway",
                             "C_gateway_migrated")},
            "moe_launches": {
                "serve_moe_bf16": serve_moe["bf16"]["k1_launches"],
                "serve_moe_int8": serve_moe["int8"]["k1_launches"],
                "serve_slots_moe": slots_moe["k1_launches"],
                **{f"train_moe_{label}": train_moe[label]["k1_launches"]
                   for label in ("drop_free", "capacity")}},
            "per_shard": kernel_case(
                train_parallel["per_shard_kernels"]["flash_fwd"]),
            "train_parallel_launches_a_rank_a_step":
                parallel_launches["k1_launches"],
            "train_resume_launches_a_rank_a_step": resume_launches["k1"],
            "per_shard_serving": {
                **kernel_case(shard_k1),
                "launches_by_rank": par_launches["k1"],
                "composed_pod_launches_by_path": pod_paths["k1"],
                "serve_pod_launches_by_rank":
                    serve_pod["k1_launches_by_rank"]},
            "autotune_launches": autotune["launches"]["k1"],
            "supervised_serve_launches": supervised["k1_launches"],
        },
        *(
            {
                "name": name, "route": "cuda",
                "source": f"containerpilot_tpu_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": train[f"{key}_launches"],
                "max_abs_err": max(r["max_abs_err"][g]
                                   for r in bwd_rows + [shard_bwd]
                                   for g in grads),
                "ms": bwd_rows[0][key]["ms"],
                "plain_ms": bwd_rows[0][key]["plain_ms"],
                "bound_ms": bwd_rows[0][key]["bound_ms"],
                "bound_by": bwd_rows[0][key]["bound_by"],
                "library_ms": bwd_rows[0]["library_ms_k3_plus_k4"],
                "library_covers": "K3+K4: SDPA fwd+bwd minus SDPA fwd",
                "tflops": bwd_rows[0][key]["tflops"],
                "shape": "b=8 s=2048 h=8 hd=128, one training layer",
                "windowed": {
                    "train": {
                        "shape": window_bwd["shape"],
                        **{f: window_bwd[key][f] for f in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "tflops")},
                        "library_ms": window_bwd["library_ms_k3_plus_k4"],
                        "library": window_bwd["library"],
                        "max_abs_err": max(window_bwd["max_abs_err"][g]
                                           for g in grads),
                    },
                    "launches": {"train_window":
                                 train_window[f"{key}_launches"]},
                },
                "train_lora_launches": train_lora[f"{key}_launches"],
                "moe_launches": {
                    f"train_moe_{label}": train_moe[label][f"{key}_launches"]
                    for label in ("drop_free", "capacity")},
                "per_shard": {
                    "shape": shard_bwd["shape"],
                    **{f: shard_bwd[key][f] for f in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "tflops")},
                    "library_ms": shard_bwd["library_ms_k3_plus_k4"],
                    "max_abs_err": max(shard_bwd["max_abs_err"][g]
                                       for g in grads),
                },
                "train_parallel_launches_a_rank_a_step":
                    parallel_launches[f"{key}_launches"],
                "train_resume_launches_a_rank_a_step":
                    resume_launches[short],
                "autotune_launches": autotune["launches"][short],
            }
            for name, key, short, replaces, grads in (
                ("flash_bwd_dq", "dq", "k3",
                 "containerpilot_tpu/ops/flash.py:257", ("dq",)),
                ("flash_bwd_dkdv", "dkdv", "k4",
                 "containerpilot_tpu/ops/flash.py:293", ("dk", "dv")),
            )
        ),
        {
            "name": "int8_matmul", "route": "cuda",
            "source": "containerpilot_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "containerpilot_tpu/ops/quant.py:64",
            "launches": k2_launches,
            "max_abs_err": max(r["max_abs_err"] for r in int8_rows
                               + fleet_face["k2_cli_shapes"] + shard_k2),
            "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
            "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
            "library_ms": k2_main["library_ms"],
            "library_covers": "torch.matmul on bf16 weights",
            "shape": "m=1, one decode layer's 7 projections "
                     "(4x 2048x2048, 2x 2048x8192, 1x 8192x2048)",
            "per_layer": k2_layer,
            "slot_launches": {
                "serve_slots_int8": slots_int8["k2_launches"],
                "serve_slots_int8_decode_replays":
                    slots_int8["k2_launches_decode_replays"],
                "serve_slots_int8_admission":
                    slots_int8["k2_launches_admission"],
                "serve_slots_bf16": slots_bf16["k2_launches"],
            },
            "windowed": {"launches": {
                "serve_slots_window_int8": slots_window["k2_launches"],
                "serve_slots_window_int8_decode_replays":
                    slots_window["k2_launches_decode_replays"],
                "serve_slots_window_int8_admission":
                    slots_window["k2_launches_admission"],
            }},
            "beam_speculative_launches": {
                f"{phase['phase']}_int8": {
                    "launches": phase["int8"]["k2_launches"],
                    "by_rows": phase["int8"]["k2_by_rows"]}
                for phase in (serve_beam, serve_spec)
            },
            "fleet_face_launches": {
                "serve_fleet_face_int8": fleet_face["int8"]["k2_launches"],
                "serve_fleet_face_bf16": fleet_face["bf16"]["k2_launches"]},
            "fleet_handoff_launches": {
                f"serve_fleet_handoff_{name}": handoff["launches"][name]["k2"]
                for name in ("A", "B", "C", "A_gateway", "B_gateway",
                             "C_gateway_migrated")},
            "cli_shapes": fleet_face["k2_cli_shapes"],
            "moe_launches": {
                "serve_moe_int8": serve_moe["int8"]["k2_launches"],
                "serve_moe_bf16": serve_moe["bf16"]["k2_launches"],
                "serve_slots_moe": slots_moe["k2_launches"]},
            "per_shard_serving": {
                "shapes": shard_k2,
                "per_layer": {f"m={m}": int8_layer_sum(shard_k2, m,
                                                       SHARD_INT8_PROJ)
                              for m in (1, 8)},
                "launches_by_rank": par_launches["k2"],
                "composed_pod_launches_by_path": pod_paths["k2"],
                "serve_pod_launches_by_rank":
                    serve_pod["k2_launches_by_rank"]},
        },
    ]
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
