#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: drive its paths on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it puts ``src`` on ``sys.path`` itself).
Phases, each asserted; a failed phase ends the run with a non-zero exit:

1. device  — a CUDA device is present; prints nvidia-smi's name and power
             limit.
2. build   — compiles every hand-written kernel from ``src/repro_torch/
             kernels/csrc`` (one nvcc per source, in parallel).
3. kernels — each kernel against its plain torch version on the card, at
             the main path's shapes: llama3.2-1b's W_in 2048->8192 (fused
             LIF) and W_out 8192->2048 (full sums), M = 4 (decode) and 512
             (prefill), bf16 weights, block density 0.3; at T = 4, and at
             T = 16 and 32 for kernels 1-4 (the deeper planes).  The
             dual-sparse BSR kernel (3) also on an all-silent input and a
             plan with a cnt == 0 column block; the dense-weight kernels (1
             full sums, 2 fused LIF) on the same weights with their pruned
             blocks as zeros.  bf16 payloads and weights take the kernels'
             tensor-core instances (`tc`), f32 ones the SIMT instances.  The
             two instances add the same exact products in other orders, so
             across instances (dense `tc` vs kernel 3) outputs are held by
             the same gate as against the plain version; the two SIMT
             instances add in the same order, so on f32 weights the dense
             kernel must EQUAL kernel 3.  Full sums must agree within
             ``TOL``; a spike word may differ only where the LIF input sits
             within ``TOL`` of v_th.  Times each kernel, its plain version
             and one PyTorch matmul of the same work (CUDA events, L2
             flushed before each); both instances of the dense and of the
             BSR kernels on the same inputs, at T = 4, 16 and 32 (`tc` must
             beat SIMT at T = 4).
4. small   — a smoke-size model served on the card and on the CPU, under
             the dual-sparse and the dense-weight policy: the same tokens.
5. serve   — full-width llama3.2-1b (d_model 2048, d_ff 8192, vocab
             128256; LLAMA_LAYERS of its 16 layers here and in phases 6,
             7, 10 and 11) with spiking FFNs at weight density 0.3, random
             weights from a seed, served by the `Engine` under PACKED_DUAL:
             4 requests of 128 prompt tokens and 16 generated tokens.  Kernel
             3's launch count must be exactly 2 x layers x forwards, all through
             its tensor-core instance (and no other kernel's move); tokens
             must equal the port's own greedy loop;
             the served logits of every step must lie within ``LOGIT_TOL`` of
             the same params run on the CPU (plain versions), teacher-forced
             with the served tokens.  Then every kernel call of that serve is
             replayed on its own inputs: held against the plain version and
             timed against a bound computed from its own activity map, the
             SIMT instance beside it (`tc` must beat it in every group of
             calls, by M and GEMM).  Three
             more serves without logit capture give tok/s and TTFT, and one
             under torch.profiler the device's busy time.
6. dense   — the same params served under ``weight_sparsity='dense'``: no
             join plans, both FFN GEMMs through kernels 2 (W_in) and 1
             (W_out), 16 x forwards launches each, all through the
             tensor-core instance, and none of kernel 3.  Its logits must
             lie within ``LOGIT_TOL`` of the dual-sparse serve's (the
             kernels add the same products in other orders), and its tokens
             equal them except where the dual serve's top two logits lie
             within 2 x LOGIT_TOL (a request's later steps then see another
             context and are not compared).  Its calls are replayed, held
             and timed as in phase 5 (both dense instances), then three
             timed serves and a profiled one.
7. adaptive — kernel 4 (the BSR kernel gated by a timestep-activity map):
             every W_in/W_out call of the dual-sparse serve again through
             `ops.dispatch` under PACKED_DUAL_ADAPTIVE (its launches counted
             on that path, all through `tc`), equal to kernel 3 bit for bit,
             and under
             adaptive(min_spikes=2) equal to kernel 3 on the masked input;
             the same on full-width inputs with silent front planes and on
             the reference's adaptive bench shape (T = 16, M = 128, K = 2304,
             N = 512, element density 0.03, 256-wide blocks, 12 of 16 planes
             silent; its f32 payload runs SIMT, and a bf16 copy `tc`).
             Timed against a bound that counts the live planes and the
             non-silent words (for kernel 3 as for kernel 4: a silent plane
             or word needs no work).

8. train  — full-width, full-depth llama3.2-1b with spiking FFNs (T = 4,
             weight density 0.3), seed 0, trained 5 steps by
             `make_train_step` (default AdamW, warmup-cosine) on
             `SyntheticLMData` at launch/train.py's 8 x 128 tokens: every
             loss and grad norm finite, step 0's loss within 0.5 of
             ln(vocab) + 1/2 (random init), every pruned wu/wd entry still
             exactly 0 and the survivors moved; median step time, tokens/s,
             peak memory and the device's idle share from a profiled step.
             A 2-layer full-width copy: step 0's loss and grad norm on the
             card and on the CPU, and 2 steps + save + restore_latest + 2
             steps == 4 straight steps bit for bit (deterministic
             algorithms on for that check).
9. flash  — kernels 5-7 (flash attention forward, the dq and dk/dv
             backward kernels, the autograd Function over them) on the train
             step's own attention inputs (every layer of phase 8's first
             forward: q (256, 128, 64) bf16, k and v repeated over the GQA
             groups, causal) through `flash_mha` with a seeded do: the
             counted path, every launch through the tensor-core instance
             (`flash_*_tc` = 16, `flash_*_simt` = 0); each layer held
             against the plain versions, layer 0 also against autograd
             through the model's plain attention.  Then BH = 32, S = 4096
             bf16 causal and window 1024 (two runs of the window case equal
             bit for bit), a padded head dim (dh 80 -> 128, bf16), and the
             reference test's f32 cases (SIMT), and dh 160-256 (below).
             Every bf16 case runs `tc`,
             held against the plain versions and against the SIMT instance
             on the same inputs by the same gates (o and gradients 1e-2,
             lse 3e-4).  Each kernel timed (CUDA events, L2 flushed) on
             both instances against its bound, its plain version and
             scaled_dot_product_attention (forward; backward alone for the
             dq and dk/dv kernels; both for kernel 7): `tc` must beat SIMT
             in every bf16 timed case.

10. serve features — run after phase 7, on phase 5's params and prompts:
             (a) the pipelined executor (depth 2) serves phase 5's requests
             under the dual-sparse and the dense-weight policy: tokens and
             every captured logit vector equal to phases 5 and 6 bit for
             bit, all 2 x layers x 16 launches of each route through
             `tc`; (b) a
             pipelined serve whose decode and encode stages (the decode
             dispatch, its token and logit copies to pinned memory, the
             spike encode) run under ``torch.cuda.set_sync_debug_mode
             ("error")``: no host wait there; (c) sync and pipelined served
             in turns, ``TIMED_SERVES`` each (tok/s, TTFT, ``stage_s``), and
             one profiled serve of each (idle share of the unprofiled wall):
             logged, not gated; (d) a staggered two-wave schedule (merges,
             retires) through paged engines (``paged(16)``, max_len 144):
             tokens and logits equal to the dense layout's bit for bit with 0
             page moves and every page back in the pool; with the radix
             prefix index the schedule again: every prompt a prefix hit, no
             prefill, the same tokens; paged + pipelined the same tokens.

11. decode windows — run after phase 10, on phase 5's params and prompts:
             (a) row invariance: every product of one decode step (the q, k,
             v and o projections, the two attention einsums, the unembed;
             the softmax and the means as well) and the FFN's kernel 1-3
             calls, on the S = 1 step's own inputs, placed inside an S = 5
             window (B = 4, k = 4) and inside the 128-token prefill, and at
             the stream's shapes (B = 1, its 120-token prefill): differing
             elements and the largest difference per product, logged; the
             kernels must give 0.  All-zero columns make the gates below
             bit for bit, otherwise logits within ``WINDOW_LOGIT_TOL`` and
             tokens equal but at near ties; the form is printed.  (b) a
             float-draft k = 4 speculative serve of phase 5's requests
             (max_len 160) under {sync, pipelined} x {dense, paged(16)},
             gated against the non-speculative serve at the same max_len;
             proposed == accepted + rejected; after a round of perturbed
             proposals (each shifted by one token: an adversarially wrong
             draft) the rewound pos and kv_pos equal a cohort that never
             speculated.  (c) packed drafts: density 0.2 (kernel 3 on the
             draft's own plans; served again with its proposals perturbed,
             rejections asserted and tokens unchanged) and min_spikes 2
             (kernel 4 the draft's gate); every launch of draft and verify
             held against its plain version, a sample of each group
             timed.  (d) spec vs non-spec in turns (tok/s, TTFT,
             acceptance, ``stage_s``), one profiled serve each, and the
             propose, verify dispatch and rewind under
             ``set_sync_debug_mode("error")`` (a read inside the propose
             must raise).  (e) a 120-frame moving-blob stream ingested
             frame by frame against its frame tokens as one prompt, under
             {sync, pipelined} x {dense, paged(16)} x {full, adaptive}:
             gated as above, frame-to-first-token p50 and p99 printed.

Every profiler pass records the device's activity alone: the host ops'
events took the profiler ~10 s a pass to list.

Phase 9 also runs the flash kernels at dh 192 and 256: bf16 on the wide
`tc` kernels (two warpgroups a tile) at BH 8 x S 4096, causal and window
1024, held against the plain versions and SIMT, timed on both against SDPA
and the bound (`tc` faster), two runs of the window case equal, the
gradients' share of the gate against the plain chain logged; dh 160 padded
to 192; f32 (4, 512) causal on SIMT.  The build asserts that ptxas spills
nothing in any of the 15 `tc` instances (dh 32 to 256), nor in the dense
kernels' 4 `tc` instances or the BSR kernels' 8 (`wgmma`), whose MMAs it
must not serialise.

12. the slice's path, after phase 9:
             (a) gemma-2b at its published width (d_model 2048, 8 heads,
             MQA, head_dim 256, d_ff 16384, vocab 256000, tied
             embeddings), depth cut from 18 to GEMMA_LAYERS (the run's time,
             since phase 13) with spiking FFNs at density 0.3
             under PACKED_DUAL, random weights from a seed: 8 requests of
             128 prompt tokens, 16 generated (two of the first wave stop at
             4 and 6), 4 slots.  The undisturbed serve: kernel 3 launched 2
             x layers x forwards, all `tc`, every call held against its plain
             version, a sample timed; four requests, one of each admission
             wave, held against the CPU (teacher-forced, LOGIT_TOL); the
             serving attention of a lone request timed with and without
             its batch block (gemma-2b and llama3.2-1b widths).  Then
             under {sync, pipelined} x
             {dense, paged(16)}: the notice after 6 steps
             (`PreemptionHandler.trigger`), `drain(step_budget=2)` with
             requests waiting, in flight and finished, the handoff saved to
             a temporary directory, loaded, resumed; the resume ledger holds
             every in-flight request; tokens and every captured logit vector
             equal to the undisturbed serve's bit for bit.  (b) qwen3-14b
             at its published width (d_model 5120, 40 heads, kv 8, d_ff
             17408, vocab 151936, qk-norm, untied head), depth cut to
             QWEN_LAYERS: a PACKED_DUAL serve of 4 x 128 + 16 (kernel 3 on the
             17408-wide plans, every call held, a sample timed), card vs
             CPU, and a speculative (float draft, k 4) and a 120-frame
             streamed serve equal to the single-position serve bit for bit.
             (c) gemma-2b, qwen3-14b and nemotron-4-340b at smoke size,
             float / packed / dual, served on the card and the CPU: the
             same tokens, logits within LOGIT_TOL.

13. the recurrent families, after phase 12: (a) rwkv6-1.6b at its
             published width (d_model 2048, 32 heads x 64, d_ff 7168, vocab
             65536), 8 of its 24 layers, and (b) zamba2-7b likewise (d_model
             3584, 112 SSM heads x 64, state 64; the shared attention + MLP
             block every 6 layers, vocab 32000), 12 of its 81 Mamba2 layers,
             float, random weights from a seed: phase 12a's schedule (8 x
             128 prompt, 16 generated, two stop early, 4 slots; zamba2's
             sixth prompt is 100 tokens: the per-step SSD scan) under
             {sync, pipelined} x {dense, paged(16)}, tokens and every
             captured logit vector equal bit for bit; one request served
             alone equal to itself in its cohort bit for bit; a drain after
             6 steps resumed bit for bit; speculation refused; no FTP or
             flash kernel launched.  Timed: 3 serves of 4 x 128 + 16 (tok/s,
             TTFT, decode step), one profiled serve (idle share, top device
             ops), the device launches of one prefill and one decode step.
             Card vs CPU on copies at the same width cut to 4 (rwkv6, bf16)
             and 7 (zamba2, f32 compute: prefills of a 128- and a 100-token
             prompt; its bf16 copy held to the CPU's own bf16 distance from
             the f32 run, P13_BF16_FACTOR: at random init the model
             amplifies rounding differences with depth) layers, 2 requests
             teacher-forced (P13_CPU_CASES: the run's time), the
             CPU side in a spawned process beside the card's serves: logits
             within LOGIT_TOL, greedy tokens equal but at near ties; the
             card's own drift under other row / batch blocks logged beside
             it.  (c) both archs at smoke size (zamba2 also
             with a spiking shared MLP) on the card and the CPU: the same
             tokens, logits within LOGIT_TOL.

14. the MoE families and the stub front ends, after phase 13, float,
             random weights from a seed, no FTP or flash kernel on their
             paths: (a) phi3.5-moe at its published width (d_model 4096, 16
             experts x d_ff 6400, GQA 32 / 8 x 128, vocab 32064), 4 of its
             32 layers: 4 requests of 96, 112, 128 and 144 prompt tokens
             (distinct: capacity routing couples a cohort's rows, so the
             engine merges no cohorts), 16 new each, 4 slots, under {sync,
             pipelined} x {dense, paged(16)}: every request's tokens equal
             the port's solo loop and the cells equal bit for bit; two
             same-length requests (budgets 2 and 5) in one cohort pipelined
             (depth 4, clamped to 1) equal sync; speculation refused;
             timed (tok/s, TTFT, decode step), profiled (idle share, top
             device ops), the launches of a 4 x 128 prefill and a decode
             step and the (token, k) pairs capacity dropped in each.  (b)
             mixtral-8x22b at its published width (d_model 6144, 8 experts
             x d_ff 16384, window 4096, vocab 32768), 2 of 56 layers:
             prompts of 8192 (two windows: the temporary full-length
             prefill) and 4080 (decodes that wrap the ring), 32 new each,
             the same gates, and the ring witness: each request through a
             full-length cache, teacher-forced, logits within LOGIT_TOL of
             the served ones.  (c) card vs CPU on copies at published width
             (phi3.5-moe and mixtral 1 layer, llava 2, hubert 4; 2
             requests, 8 teacher-forced decodes), the CPU side in a spawned
             process (params drawn on the card from the seed and moved):
             logits within LOGIT_TOL, tokens equal but at near ties, the
             routing choices that differ per layer reported.  (d)
             llava-next-mistral-7b at full depth: a prefill of 2 x (576
             image + 64 text positions) and 16 greedy decodes, finite,
             timed; hubert-xlarge at full depth: an encoder prefill of 4 x
             1024 frames and AdamW train steps, finite, timed.  Phase 12c
             also runs the four at smoke size (window 16; mixtral's prompts
             of 32 and 12 tokens) on the card and the CPU.

15. the paper's SNN track, after phase 14: (a) the four Table II layers
             (A-L4, V-L8, R-L19, T-HFF) at their exact (T, M, N, K) from
             `configs.snn_workloads`: spike words drawn on the card with
             exact counts for the layer's non-silent fraction and spike
             density (measured beside Table II's: silent within 0.01,
             density within 0.02), normal
             weights pruned unstructured to its density, bf16.  Kernel 3
             through `ops.dispatch`'s per-call route (raw weights under
             PACKED_DUAL: a plan built per call), fused and unfused, and
             kernels 1 and 2 on the same operands, each held against
             `ftp_spmspm` by phase 3's gates (full sums within ``TOL``,
             words but near v_th), the unfused sums against
             `sequential_spmspm` too.  T-HFF also: kernel 4 under
             adaptive_t(1) == kernel 3 bit for bit (its words and words with
             plane 0 cleared), and the same weights block-pruned 128 x 128.
             Timed on a prebuilt plan (CUDA events, L2 flushed): kernel 3,
             kernels 1 and 2 and their plain versions, the matmul of the
             unpacked planes, `ftp_spmspm`,
             `sequential_spmspm` and the bound; the plan build's host time,
             the joined-block share and the non-zero MAC share beside ns d_b.
             No speed gate.  (b) AlexNet, VGG16 and ResNet19 from
             `sim.workloads.get_network`, layer by layer at their im2col
             GEMM shapes and sparsities (drawn and held as in (a)), kernel 3
             fused through the same route and gates; each layer timed with
             its plain version, the matmul and its bound, summed per
             network, and the layers on the SIMT instance.  (c) the LTH example (`examples/
             train_snn_lth_torch.py`) at ``P15_LTH`` steps on the card: loss
             finite, the masked weights at the pruned density, the hidden
             layer not all silent, and silent after the preprocessing >=
             before.

16. the dry run and the roofline on the card, after phase 15, its time
             logged against ``P16_BUDGET_S``: (a) every decode and train cell of the
             assignment and llama3.2-1b x prefill_32k counted on meta tensors
             at full width and shape (`launch.dryrun`: counts at a few
             depths, batches and sequence lengths, extrapolated), in spawned
             processes while (d) runs; the table of memory, fits,
             flops, bytes and the three roofline terms printed.  (b) every
             cell whose dry-run total fits ``P16_FIT_SHARE`` of the card's
             memory run for real at full width, depth and batch: its counted
             flops and bytes on the card must EQUAL the dry run's; one step
             timed (median of 3 after a warm-up) against its roofline time;
             max_memory_allocated against the dry run's total.  (c) the main
             path (phase 5's llama3.2-1b, spiking, density 0.3, LLAMA_LAYERS,
             PACKED_DUAL): `attribution_summary` of one 4-row decode step and
             one 4 x 128 prefill, kernel 3 counted by its work formula
             (`roofline.kernel_work`) with its counted calls equal to the
             `launch_counts()` delta, each step's device time against its
             roofline time.  (d) the three serve / train examples on the
             card: `serve_llm_torch`, `serve_dvs_torch` (incremental ==
             one-shot) and `spiking_ffn_llm_torch` at ``P16_FFN_STEPS``
             steps (its loss must drop).

17. the serve mesh (item 12a), after phase 16: phase 5's model and params
             on MESH_LOGICAL logical devices of the card (`launch.mesh`).
             (a) the dual-sparse serve at data=2 x model=2, data=1 x model=4
             and data=4 x model=1: tokens and captured logits EQUAL to the
             single-device serve's, every kernel-3 launch on the tensor-core
             instance (each slab with its parent plan's launch shape), data
             x model launches a GEMM, a sample of the slab calls held
             against the plain version by phase 3's gate; (b) the dense-
             weight route at data=2 x model=2 (kernel 1 as column slabs,
             kernel 2 once a data group) == its single-device serve; (c)
             kernel 4 at min_spikes 1 under the mesh == (a); (d) pipelined x
             paged at data=2 x model=2 == the sync dense single-device
             serve, a skewed cohort re-packed (rebalances > 0), re-mesh
             data=2 x model=2 -> one device -> data=1 x model=2 mid-serve
             with every token kept and no page copied; (e) tok/s and the
             decode step of each mesh beside the single-device ones (four
             logical devices on one card: no multi-card speed is claimed),
             and the f32 unembed over vocab column slabs against the whole
             product (why the unembed runs over fixed column blocks); (f)
             with more than one card, (a) on distinct cards.
18. approximate-TP serving (item 12b), after phase 17: psum tensor
             parallelism on the model axis of MESH_LOGICAL logical devices,
             each approximate serve held to max logit drift <= LOGIT_TOL
             against the bitwise serve on one device.  (a) float
             llama3.2-1b (full width, LLAMA_LAYERS layers) at data=1 x
             model=2, data=2 x model=2 and data=1 x model=4: 2 x 2 == 1 x 2,
             a second 2 x 2 serve == the first and pipelined == sync, bit
             for bit; (b) phase 5's dual-sparse main path at 2 x 2: every
             kernel-3 launch a plan slab on `tc` at phase 17's count, a
             sample held against the plain version, kernel 4 at min_spikes
             1 == (b) bit for bit; (c) the dense-weight route (kernels 1 /
             2) at 2 x 2; (d) gemma-2b (expand_kv off and on), phi3.5-moe,
             rwkv6-1.6b and zamba2-7b (f32) at model = 2, full width, depth
             cut (TP_FAMILIES); (e) with more than one card, (a)'s 2 x 2 on
             distinct cards.  Drift, token match, first flip, decode step
             and tok/s per mesh, TP weights dealt.
19. the train mesh (item 12c), after phase 18, its time logged against
             ``P19_BUDGET_S``: `train.make_train_step(mesh=)` on logical
             devices of the card.  (a) phase 8's llama3.2-1b (full width and
             depth, spiking, T 4, density 0.3, batch 8 x 128) at data=2 x
             model=2 for P19_STEPS steps, each against the one-device step
             from the same state (loss within TRAIN_LOSS_RTOL, grad norm
             within TRAIN_GNORM_RTOL), pruned FFN weights 0 in every shard,
             a repeat of the meshed run bit for bit, the state's card
             memory beyond one device's (0 B: the parts are views), both
             step times (median of P19_STEPS) and the idle share of a
             profiled meshed step; (b) elastic, cut to P19_ELASTIC_LAYERS
             layers (its checkpoint is written to disk): the state to the
             host, `ft.elastic.reshard_state` onto plan_mesh(2, 2) (1 x 2),
             one step, EQUAL to the same step after a restore with
             ``shardings=``; (c) phi3.5-moe (full width, 1 of 32 layers):
             fsdp, EP and Adafactor, one step at 2 x 2 against one device
             with phase 8's bounds, the dropped (token, k) pairs of the
             whole-batch routing EQUAL to one device's; (d)
             `compressed_psum` over the data axis against the exact mean,
             within max|mean| / 100; (e) with more than one card, (a)'s
             step on distinct cards.

Prints a JSON line of phase 13's measurements, one of phase 14's, one of
phase 15's, one of phase 16's (``{"roofline": ...}``), one of phase
17's (``{"mesh": ...}``), one of phase 18's (``{"tp": ...}``) and one of
phase 19's (``{"train_mesh": ...}``), then a JSON line
of per-kernel measurements (the headline numbers are each kernel's mean
launch on its path), and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Full sums of <= 8192 exact products of a {0,1} spike and a bf16 weight,
# summed in f32 in two different orders: rounding differences stay orders
# of magnitude below this.
TOL = 1e-3
T = 4
SEED = 0
PROMPT, GEN, REQUESTS = 128, 16, 4
KERNEL_SRC = "src/repro/kernels/ftp_spmm.py"
FLASH_SRC = "src/repro/kernels/flash_mha.py"
# name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "ftp_bsr": ("src/repro_torch/kernels/csrc/ftp_bsr.cu", f"{KERNEL_SRC}:211"),
    "ftp_bsr_adaptive": ("src/repro_torch/kernels/csrc/ftp_bsr.cu",
                         f"{KERNEL_SRC}:249"),
    "ftp_spmm": ("src/repro_torch/kernels/csrc/ftp_dense.cu", f"{KERNEL_SRC}:83"),
    "ftp_spmm_fused_lif": ("src/repro_torch/kernels/csrc/ftp_dense.cu",
                           f"{KERNEL_SRC}:134"),
    "flash_fwd": ("src/repro_torch/kernels/csrc/flash_mha.cu", f"{FLASH_SRC}:43"),
    "flash_bwd_dq": ("src/repro_torch/kernels/csrc/flash_mha.cu",
                     f"{FLASH_SRC}:123"),
    "flash_bwd_dkv": ("src/repro_torch/kernels/csrc/flash_mha.cu",
                      f"{FLASH_SRC}:152"),
    # kernel 7, the custom_vjp, is an autograd Function over the three above
    "flash_mha": ("src/repro_torch/kernels/flash_mha.py", f"{FLASH_SRC}:241"),
}
# Full-width logits, card vs CPU: the bound tests/test_torch_models.py holds
# the port to against the jitted JAX reference, whose excess precision on
# bf16 residual adds flips FFN spikes the same way other GEMM orders do.
LOGIT_TOL = 0.25
# llama3.2-1b's depth in the serve phases (5-7, 10, 11, 16c-18; 16 layers
# at full depth, which the train steps of phases 8 and 19 keep): at 8 the
# whole run took 1139.2 s of its 1200 on a slow host (PERF.md §6), and
# later passed 1200 s on one, a host 1.4x slower than another between
# calls.  Every gate of those phases holds layer by layer; kernel times
# are per launch.
LLAMA_LAYERS = 4
TIMED_SERVES = 3
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 8, 128  # launch/train.py's batch, seq
# Random-init CE: logits of unit variance give ln V + 1/2 on average; the
# batch moves it by less than this.
LOSS0_TOL = 0.5
# Card vs CPU train step (same params and batch): the bounds
# tests/test_torch_train.py holds the port to against the jitted reference —
# bf16 GEMMs summed in other orders round some values the other way and
# flip a few FFN spikes.
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GNORM_RTOL = 5e-2
# Flash kernels vs plain versions on bf16 inputs: both round an f32 value
# that differs in its last bits to bf16, one bf16 step at most.
FLASH_TOL_BF16 = 1e-2
# Flash vs autograd of the model's own attention, which rounds p to bf16
# before the value product (relative norm of the difference).
FLASH_VS_MODEL_TOL = 2e-2


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - _T0:.1f}s] {msg}", flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit(f"chip_smoke: the port's sources are not at {SRC}")
    sys.path.insert(0, SRC)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # plain versions in full f32; bf16 GEMMs without reduced-precision
    # partial sums, so the card's logits are comparable with the CPU's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    assert set(built) == {"ftp_bsr", "ftp_dense", "flash_mha"}, sorted(built)
    for name, b in built.items():
        log(f"built {name} in {b['seconds']:.1f}s -> {b['path']}")
        for ln in b["log"].splitlines():
            if "registers" in ln or "spill" in ln or "entry function" in ln:
                log(f"  ptxas: {ln.strip()}")
    # every tc flash kernel (dh 32 to 256, fwd, dq, dk/dv) holds its
    # accumulators without spilling; the build's ptxas log (kept beside a
    # cached library) names each kernel
    spills = _ptxas_spills(built["flash_mha"]["log"])
    tc = {f: b for f, b in spills.items() if "_tc_kernel" in f}
    assert len(tc) == 15, sorted(spills)
    assert all(b == (0, 0) for b in tc.values()), tc
    # the wgmma instances of the dense kernels (one or two consumer
    # warpgroups, kernel 1 or 2: four) and of the BSR kernels (those times
    # 64 or 128 columns: eight): no spills, and no MMA that ptxas had to
    # serialise (too few registers, or A fragments built while MMAs run)
    for lib, kernel, n in (("ftp_dense", "ftp_dense_tc_kernel", 4),
                           ("ftp_bsr", "ftp_bsr_tc_kernel", 8)):
        text = built[lib]["log"]
        spills = _ptxas_spills(text)
        tc = {f: b for f, b in spills.items() if kernel in f}
        assert len(tc) == n, sorted(spills)
        assert all(b == (0, 0) for b in tc.values()), tc
        serialised = [ln for ln in text.splitlines()
                      if "wgmma.mma_async instructions are serialized" in ln]
        assert not serialised, serialised
        log(f"{lib} tc instances: 0 spill bytes, registers "
            f"{_ptxas_registers(text, kernel)}")
    log(f"build wall {time.perf_counter() - t0:.1f}s")


def _ptxas_registers(text, name):
    """{kernel: registers a thread} of the kernels whose name holds
    ``name``, from nvcc's -Xptxas -v output."""
    out, entry = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry and name in entry:
            out[entry] = int(m.group(1))
            entry = None
    return out


def _ptxas_spills(text):
    """{kernel: (spill store bytes, spill load bytes)} from nvcc's -Xptxas -v
    output."""
    out, entry = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and entry:
            out[entry] = (int(m.group(1)), int(m.group(2)))
            entry = None
    return out


def _counted(path, fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; returns (result, counts)."""
    import torch

    from repro_torch.kernels import flash_mha, ftp_spmm

    ftp_spmm.reset_launch_counts()
    flash_mha.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = {**ftp_spmm.launch_counts(), **flash_mha.launch_counts()}
    log(f"{path}: launches {counts}")
    return out, counts


# ---------------------------------------------------------------------------
# timing, bounds, parity
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int, flush, busy_cycles: int = 1_000_000) -> float:
    """Median device time of one call: the L2 is flushed before each call
    and the stream is kept busy (``busy_cycles`` of a sleep kernel) while
    the host enqueues it, so the events bracket the call's device work
    only."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(busy_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _flush_buffer():
    """A buffer larger than the H100's 50 MB L2, zeroed before each timed
    call."""
    import torch

    return torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")


def _lif_margin(o, v_th=1.0, tau=0.5):
    """min over t of |x_t - v_th| of the LIF the kernel epilogue runs."""
    import torch

    u = torch.zeros_like(o[0])
    margin = torch.full_like(o[0], float("inf"))
    for t in range(o.shape[0]):
        x = o[t] + u
        margin = torch.minimum(margin, (x - v_th).abs())
        c = x > v_th
        u = tau * x * (1.0 - c.float())
    return margin


def _bound(args, bm, fuse, tmap=None):
    """Least time for one BSR call's work on the card
    (`roofline.kernel_work.bsr_work`: the bytes each input and output needs
    once against 2 T' bn bf16 operations per non-silent word of each
    joined block).  Returns (ms, "bytes" or "operations")."""
    from repro_torch.roofline import kernel_work as kw

    return kw.bound_ms(*kw.bsr_work(*args[:8], bm=bm, fuse_lif=fuse, tmap=tmap))


def _bound_dense(a, w, Tc, fuse):
    """Least time for one dense-weight call (`kernel_work.dense_work`: the
    words and the weight read once, the output written once, against 2 T N
    bf16 operations per non-silent word)."""
    from repro_torch.roofline import kernel_work as kw

    return kw.bound_ms(*kw.dense_work(a, w, Tc, fuse))


def _dense_weight(args):
    """The (K, n_out) bf16 weight a join plan stands for (zeros where a
    block was pruned): the library yardstick's operand."""
    import torch

    a, payload, kidx, vidx, cnt, act, n_out = args[:7]
    nnb, jmax = kidx.shape
    _, bk, bn = payload.shape
    w = torch.zeros((act.shape[1], bk, nnb, bn), dtype=torch.bfloat16,
                    device=a.device)
    j, jj = (torch.arange(jmax, device=a.device)[None] < cnt[:, None].long()
             ).nonzero(as_tuple=True)
    w[kidx[j, jj].long(), :, j, :] = payload[vidx[j, jj].long()].to(torch.bfloat16)
    return w.reshape(act.shape[1] * bk, nnb * bn)[: a.shape[1], :n_out]


def _hold(label, c_k, u_k, o_p, fuse):
    """Kernel outputs against the plain full sums ``o_p``: full sums within
    TOL, spike words equal except where the LIF input is within TOL of v_th.
    Returns (max abs error, spike-word flips)."""
    from repro_torch.kernels.ref import lif_ref

    if fuse:
        c_p, u_p = lif_ref(o_p)
        differ = c_k != c_p
        flips = int(differ.sum())
        near = _lif_margin(o_p) < TOL
        assert not bool((differ & ~near).any()), (
            f"{label}: {int((differ & ~near).sum())} spike words differ away "
            "from the threshold")
        err = float((u_k - u_p)[~differ].abs().max()) if flips < differ.numel() else 0.0
    else:
        flips = 0
        err = float((c_k - o_p).abs().max())
    assert err <= TOL, f"{label}: max |kernel - plain| = {err:.3e} > {TOL}"
    return err, flips


def _bsr_instance(args):
    """The BSR kernels' instance one call's payload routes to."""
    from repro_torch.kernels import ftp_spmm

    p = args[1]
    return ftp_spmm.bsr_instance(p.dtype, p.shape[1], p.shape[2],
                                 p.data_ptr() % 16 == 0)


def _parity(label, args, bm, fuse, tmap=None):
    """BSR kernel (the routed instance; on a `tc` payload the SIMT instance
    too) vs plain version on one call's inputs; returns the larger (max abs
    error, spike-word flips) of the two."""
    import torch

    from repro_torch.kernels import ftp_spmm

    o_p, _ = ftp_spmm.ftp_spmm_bsr_plain(*args, bm=bm, fuse_lif=False, tmap=tmap)
    worst = (0.0, 0)
    for inst in ("tc", "simt") if _bsr_instance(args) == "tc" else ("simt",):
        c_k, u_k = ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=fuse, tmap=tmap,
                                         instance=inst)
        torch.cuda.synchronize()
        if not fuse:
            assert not bool(u_k.any()), f"{label}: U must be zero without the LIF"
        err, flips = _hold(f"{label} ({inst})", c_k, u_k, o_p, fuse)
        worst = (max(worst[0], err), max(worst[1], flips))
    return worst


def _planes(a, Tc, tmap=None):
    """The unpacked bf16 planes a library matmul contracts: all T, or the
    live planes of ``tmap``."""
    import torch

    from repro_torch.core.packing import unpack_spikes

    p = unpack_spikes(a, Tc, torch.bfloat16)
    if tmap is not None:
        p = p[tmap > 0]
    return p.reshape(-1, a.shape[1])


def _measure(args, bm, fuse, flush, w_dense, reps, tmap=None):
    """BSR kernel (the routed instance, ``ms``; on a `tc` payload the SIMT
    instance too, ``simt_ms``), plain version and library yardstick timed
    on one call's inputs, with the call's bound."""
    import torch

    from repro_torch.kernels import ftp_spmm

    planes = _planes(args[0], args[7], tmap)
    row = {
        "instance": _bsr_instance(args),
        "ms": _time_ms(lambda: ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=fuse,
                                                     tmap=tmap), reps, flush),
        "plain_ms": _time_ms(
            lambda: ftp_spmm.ftp_spmm_bsr_plain(*args, bm=bm, fuse_lif=fuse,
                                                tmap=tmap),
            max(1, reps // 5), flush),
        "library_ms": _time_ms(lambda: torch.matmul(planes, w_dense), reps, flush),
    }
    if row["instance"] == "tc":
        row["simt_ms"] = _time_ms(
            lambda: ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=fuse, tmap=tmap,
                                          instance="simt"), reps, flush)
    row["bound_ms"], row["bound_by"] = _bound(args, bm, fuse, tmap)
    return row


def _assert_tc_faster(row):
    """A measured row (one call, or a group's per-launch means) that ran the
    tensor-core instance must beat the SIMT instance on the same inputs."""
    if row.get("instance") == "tc":
        assert row["ms"] < row["simt_ms"], (
            f"{row['case']}: tensor-core instance {row['ms']:.4f} ms not faster "
            f"than SIMT {row['simt_ms']:.4f} ms")


def _dense_instance(w):
    """The dense kernels' instance the weights route to ("tc" or "simt")."""
    from repro_torch.kernels import ftp_spmm

    return ftp_spmm.dense_instance(w.dtype, w.shape[1], w.data_ptr() % 16 == 0)


def _dense_call(a, w, Tc, fuse, instance=None):
    from repro_torch.kernels import ftp_spmm

    if fuse:
        return ftp_spmm.ftp_spmm_fused_lif(a, w, Tc, instance=instance)
    return ftp_spmm.ftp_spmm(a, w, Tc, instance=instance), None


def _dense_parity(label, a, w, Tc, fuse, instance=None):
    """Dense kernel (1 or 2; the routed instance, or ``instance``) vs its
    plain version; returns (err, flips)."""
    import torch

    from repro_torch.kernels import ftp_spmm

    o_p = ftp_spmm.ftp_spmm_plain(a, w, Tc)
    c_k, u_k = _dense_call(a, w, Tc, fuse, instance)
    torch.cuda.synchronize()
    return _hold(label, c_k, u_k, o_p, fuse)


def _dense_measure(a, w, Tc, fuse, flush, reps):
    """The routed dense instance (``ms``) and, on bf16 weights, the SIMT
    instance on the same inputs (``simt_ms``), beside the plain version and
    the library yardstick."""
    import torch

    from repro_torch.kernels import ftp_spmm

    plain = ((lambda: ftp_spmm.ftp_spmm_fused_lif_plain(a, w, Tc)) if fuse
             else (lambda: ftp_spmm.ftp_spmm_plain(a, w, Tc)))
    planes, wb = _planes(a, Tc), w.to(torch.bfloat16)
    row = {"instance": _dense_instance(w),
           "ms": _time_ms(lambda: _dense_call(a, w, Tc, fuse), reps, flush),
           "plain_ms": _time_ms(plain, max(1, reps // 5), flush),
           "library_ms": _time_ms(lambda: torch.matmul(planes, wb), reps, flush)}
    if row["instance"] == "tc":
        row["simt_ms"] = _time_ms(lambda: _dense_call(a, w, Tc, fuse, "simt"),
                                  reps, flush)
        assert row["ms"] < row["simt_ms"], (
            f"tensor-core instance {row['ms']:.4f} ms not faster than SIMT "
            f"{row['simt_ms']:.4f} ms")
    row["bound_ms"], row["bound_by"] = _bound_dense(a, w, Tc, fuse)
    return row


def _fmt(row):
    simt = f", SIMT {row['simt_ms']:.4f} ms" if "simt_ms" in row else ""
    return (f", kernel {row['ms']:.4f} ms{simt}, plain {row['plain_ms']:.4f} ms, "
            f"matmul {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})" if "ms" in row else "")


def _check_case(label, a, plan, n_out, fuse, flush=None, tmap=None, Tc=T):
    """BSR kernel (kernel 4 with ``tmap``) vs plain version on one
    synthetic input of ``Tc`` timesteps; timed when ``flush`` is given.
    Returns the measurement row."""
    from repro_torch.kernels import ftp_spmm, ops

    Tc = tmap.numel() if tmap is not None else Tc
    bm = ftp_spmm.pick_bm(a.shape[0], Tc)
    args = (a, plan.payload, plan.kidx, plan.vidx, plan.cnt,
            ops._activity(a, bm, plan), n_out, Tc)
    err, flips = _parity(label, args, bm, fuse, tmap)
    row = {"case": label, "M": a.shape[0], "T": Tc, "fuse_lif": fuse,
           "max_abs_err": err, "flips": flips}
    if flush is not None:
        row.update(_measure(args, bm, fuse, flush, _dense_weight(args),
                            30 if Tc == T else 10, tmap))
    log(f"{label}: max_abs_err {err:.3e}, flips {flips}{_fmt(row)}")
    if flush is not None and Tc == T:
        _assert_tc_faster(row)
    return row


def _ffn_weights(dev):
    """llama3.2-1b's FFN shapes, block-pruned to density 0.3, bf16, with
    their plans."""
    import torch

    from repro_torch.core.snn_layers import init_spiking_ffn
    from repro_torch.kernels.join_plan import build_weight_plan

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ffn = init_spiking_ffn(gen, 2048, 8192, weight_density=0.3,
                           prune_block=(128, 128))
    w_in, w_out = ffn["w_in"].to(torch.bfloat16), ffn["w_out"].to(torch.bfloat16)
    return gen, w_in, w_out, build_weight_plan(w_in), build_weight_plan(w_out)


def _spikes(gen, M, width, Tc=T, silent=()):
    import torch

    from repro_torch.core.lif import direct_encode
    from repro_torch.core.packing import pack_spikes

    x = torch.randn((M, width), generator=gen, device="cuda").to(torch.bfloat16)
    words = pack_spikes(direct_encode(x, Tc))
    for t in silent:
        words = words & ~(1 << t)
    return words


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def phase_kernel():
    import torch

    from repro_torch.kernels.join_plan import build_weight_plan

    dev = torch.device("cuda")
    gen, w_in, w_out, plan_in, plan_out = _ffn_weights(dev)
    D, F = w_in.shape
    log(f"plans: W_in {plan_in.payload.shape[0]} of {plan_in.nkb * plan_in.nnb} "
        f"blocks, W_out {plan_out.payload.shape[0]} of "
        f"{plan_out.nkb * plan_out.nnb} blocks")
    for w, plan in ((w_in, plan_in), (w_out, plan_out)):
        args = (torch.zeros((1, w.shape[0]), dtype=torch.int32, device=dev),
                plan.payload, plan.kidx, plan.vidx, plan.cnt,
                torch.zeros((1, plan.nkb), dtype=torch.int32, device=dev),
                w.shape[1])
        assert torch.equal(_dense_weight(args), w), "plan does not rebuild W"
    flush = _flush_buffer()

    rows, dense_rows = [], []
    f32_plans = {}
    for M in (4, 512):
        for label, a, w, plan, fuse in (
                (f"W_in fused_lif M={M}", _spikes(gen, M, D), w_in, plan_in, True),
                (f"W_out full_sums M={M}", _spikes(gen, M, F), w_out, plan_out,
                 False)):
            rows.append(_check_case(label, a, plan, w.shape[1], fuse, flush))
            dense_rows.append(_check_dense_case(label, a, w, plan, fuse, flush))
            key = w.data_ptr()
            if key not in f32_plans:
                w32 = w.float()
                f32_plans[key] = (w32, build_weight_plan(w32))
            _check_dense_f32_equals_bsr(label, a, *f32_plans[key], fuse)
    del f32_plans
    silent = torch.zeros((4, D), dtype=torch.int32, device=dev)
    for fuse in (True, False):
        _check_case(f"all-silent fuse_lif={fuse}", silent, plan_in, F, fuse)
    holed = w_in.clone()
    holed[:, 128:256] = 0
    plan_hole = build_weight_plan(holed)
    assert int(plan_hole.cnt[1]) == 0
    for fuse in (True, False):
        _check_case(f"cnt==0 column block fuse_lif={fuse}", _spikes(gen, 4, D),
                    plan_hole, F, fuse)
    for Tc in (16, 32):  # the deeper planes, at full width
        for M in (4, 512):
            for label, width, w, plan, fuse in (
                    (f"W_in fused_lif T={Tc} M={M}", D, w_in, plan_in, True),
                    (f"W_out full_sums T={Tc} M={M}", F, w_out, plan_out, False)):
                bsr, dense = _deep_case(label, gen, M, width, w, plan, fuse, Tc,
                                        flush)
                rows.append(bsr)
                dense_rows.append(dense)
    return rows, dense_rows


def _deep_case(label, gen, M, width, w, plan, fuse, Tc, flush):
    """Kernels 3, 1/2 and 4 at T = ``Tc`` on one full-width shape, each
    against its plain version; kernel 4 (on an input whose planes 0-1 are
    silent) also equal to kernel 3.  Both instances of kernel 3 and of the
    dense kernels timed on the same inputs; returns (kernel 3's row, the
    dense kernels' row)."""
    import torch

    from repro_torch.core.packing import timestep_activity_map
    from repro_torch.kernels import ops
    from repro_torch.serve.policy import PACKED_DUAL, PACKED_DUAL_ADAPTIVE

    n_out = w.shape[1]
    a = _spikes(gen, M, width, Tc)
    bsr = _check_case(label, a, plan, n_out, fuse, flush, Tc=Tc)
    err, flips = _dense_parity(f"dense {label}", a, w, Tc, fuse)
    s_err, s_flips = _dense_parity(f"dense SIMT {label}", a, w, Tc, fuse, "simt")
    row = {"case": f"dense {label}", "M": M, "T": Tc, "fuse_lif": fuse,
           "max_abs_err": max(err, s_err), "flips": flips, "simt_flips": s_flips}
    row.update(_dense_measure(a, w, Tc, fuse, flush, 10))
    log(f"dense {label}: max_abs_err {err:.3e} (SIMT {s_err:.3e}), flips {flips} "
        f"(SIMT {s_flips}){_fmt(row)}")
    a = _spikes(gen, M, width, Tc, (0, 1))
    tmap = timestep_activity_map(a, Tc).to(torch.int32)
    assert int(tmap.sum()) <= Tc - 2
    _check_case(f"adaptive {label} planes 0-1 silent", a, plan, n_out, fuse,
                tmap=tmap)
    kw = dict(n_out=n_out, fuse_lif=fuse)
    got = ops.dispatch(a, plan, PACKED_DUAL_ADAPTIVE, Tc, **kw)
    want = ops.dispatch(a, plan, PACKED_DUAL, Tc, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        f"{label}: kernel 4 != kernel 3 at min_spikes=1"
    return bsr, row


def _check_dense_case(label, a, w, plan, fuse, flush):
    """Kernels 1/2 (bf16 weights: the tensor-core instance; the SIMT one
    too) vs their plain version on one synthetic input; against kernel 3 on
    the same block-pruned weights by the same gate (the two add the same
    products in other orders); both instances timed."""
    from repro_torch.kernels import ops
    from repro_torch.serve.policy import PACKED_DENSE, PACKED_DUAL

    label = f"dense {label}"
    assert _dense_instance(w) == "tc", label
    err, flips = _dense_parity(label, a, w, T, fuse)
    s_err, s_flips = _dense_parity(f"{label} SIMT", a, w, T, fuse, "simt")
    got = ops.dispatch(a, w, PACKED_DENSE, T, fuse_lif=fuse)
    o_bsr, _ = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=w.shape[1])
    if fuse:
        b_err, b_flips = _hold(f"{label} vs kernel 3", *got, o_bsr, True)
    else:
        b_err, b_flips = _hold(f"{label} vs kernel 3", got, None, o_bsr, False)
    row = {"case": label, "M": a.shape[0], "T": T, "fuse_lif": fuse,
           "max_abs_err": max(err, s_err), "flips": flips, "simt_flips": s_flips,
           "vs_bsr_max_abs_err": b_err, "vs_bsr_flips": b_flips}
    row.update(_dense_measure(a, w, T, fuse, flush, 30))
    log(f"{label}: max_abs_err {err:.3e} (SIMT {s_err:.3e}), flips {flips} "
        f"(SIMT {s_flips}); vs kernel 3: max_abs_err {b_err:.3e}, flips "
        f"{b_flips}{_fmt(row)}")
    return row


def _check_dense_f32_equals_bsr(label, a, w32, plan32, fuse):
    """f32 weights route to the dense SIMT instance and their plan to kernel
    3's SIMT instance, which add in the same ascending k order: on
    block-pruned weights their outputs are equal, bit for bit."""
    import torch

    from repro_torch.kernels import ftp_spmm, ops
    from repro_torch.serve.policy import PACKED_DENSE, PACKED_DUAL

    assert _dense_instance(w32) == "simt"
    before = ftp_spmm.launch_counts()
    got = ops.dispatch(a, w32, PACKED_DENSE, T, fuse_lif=fuse)
    want = ops.dispatch(a, plan32, PACKED_DUAL, T, fuse_lif=fuse,
                        n_out=w32.shape[1])
    after = ftp_spmm.launch_counts()
    assert after["ftp_dense_simt"] == before["ftp_dense_simt"] + 1
    assert after["ftp_bsr_simt"] == before["ftp_bsr_simt"] + 1
    same = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            if fuse else torch.equal(got, want[0]))
    assert same, f"dense f32 {label}: SIMT instance != kernel 3"
    log(f"dense f32 {label}: SIMT instance == kernel 3 (SIMT), bit for bit")


# ---------------------------------------------------------------------------
# phase 4: smoke-size model, card vs CPU
# ---------------------------------------------------------------------------

def phase_small_cpu_vs_card():
    """The smoke-size model served on the card and on the CPU (the kernels'
    plain versions) from the same params, under the dual-sparse and the
    dense-weight policy: the same greedy tokens."""
    import numpy as np

    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy

    cfg = build_config("llama3_2_1b", smoke=True, spiking=True, weight_density=0.3)
    model = build_model(cfg)
    params = model.init(SEED, device="cpu")
    prompts = list(np.random.default_rng(1).integers(0, cfg.vocab, size=(3, 8)))
    for ws in ("dual_sparse", "dense"):
        got, traces = {}, {}
        for dev in ("cuda", "cpu"):
            eng = Engine(model, params, max_len=16, max_slots=3, capture_logits=True,
                         policy=ExecutionPolicy.for_arch(cfg, weight_sparsity=ws),
                         device=dev)
            got[dev] = eng.generate_batch(prompts, 6)
            traces[dev] = np.stack([np.stack(eng.logit_traces[r])
                                    for r in sorted(eng.logit_traces)])
        for a, b in zip(got["cuda"], got["cpu"]):
            np.testing.assert_array_equal(a, b)
        # bf16 GEMM and f32 sums in other orders on the two devices: the same
        # bound the CPU tests hold the jitted JAX reference to
        drift = float(np.abs(traces["cuda"] - traces["cpu"]).max())
        assert drift <= 0.25, drift
        log(f"smoke-size model, {ws}: card and CPU emit the same tokens, "
            f"max |logit drift| {drift:.3e}")


# ---------------------------------------------------------------------------
# phases 5 and 6: full-width serves
# ---------------------------------------------------------------------------

def _record(names):
    """Wrap the named kernel wrappers of `ftp_spmm` so every call's inputs
    are kept; returns (calls, restore)."""
    from repro_torch.kernels import ftp_spmm

    calls = []
    orig = {n: getattr(ftp_spmm, n) for n in names}

    def wrap(name):
        def recorded(*args, **kw):
            calls.append((name, args, kw))
            return orig[name](*args, **kw)
        return recorded

    for n in names:
        setattr(ftp_spmm, n, wrap(n))

    def restore():
        for n, f in orig.items():
            setattr(ftp_spmm, n, f)
    return calls, restore


def _serve(engine, prompts, label, record, expect):
    """The counted serve: logits captured, every kernel call recorded, the
    launch counts zeroed just before and read just after."""
    import numpy as np

    from repro_torch.kernels import ftp_spmm

    engine.metrics.reset()
    engine.logit_traces = {}
    calls, restore = _record(record)
    try:
        outs, counts = _counted(f"{label} serve",
                                lambda: engine.generate_batch(prompts, GEN))
    finally:
        restore()
    s = engine.summary()
    forwards = s["prefill_batches"] + s["decode_batches"]
    assert all(len(o) == GEN for o in outs), [len(o) for o in outs]
    want = {k: v * engine.cfg.n_layers * forwards for k, v in expect.items()}
    assert counts == {k: want.get(k, 0) for k in counts}, (counts, forwards)
    assert sum(counts[k] for k in ftp_spmm.KERNEL_NAMES) == len(calls)
    traces = engine.logit_traces
    assert len(traces) == REQUESTS and all(len(v) == GEN for v in traces.values())
    got = np.stack([np.stack(traces[r]) for r in sorted(traces)])  # (B, GEN, V)
    assert got.shape == (REQUESTS, GEN, engine.cfg.vocab) and np.isfinite(got).all()
    return outs, got, calls, counts, forwards


def _timed(engine, prompts, outs, label):
    """TIMED_SERVES serves without logit capture: tokens unchanged; returns
    (all summaries, the median-throughput one)."""
    import numpy as np

    engine.capture_logits = False
    timed = []
    for _ in range(TIMED_SERVES):
        engine.metrics.reset()
        again = engine.generate_batch(prompts, GEN)
        for a, b in zip(again, outs):
            np.testing.assert_array_equal(a, b)
        timed.append(engine.summary())
    tok_s = [t["throughput_tok_s"] for t in timed]
    best = timed[tok_s.index(statistics.median(tok_s))]
    log(f"{label} timed serves (no logit capture): {len(timed)} x "
        f"{best['total_tokens']} tokens: tok/s {[round(x, 1) for x in tok_s]}, "
        f"TTFT p50 ms {[round(t['ttft_s_p50'] * 1e3, 1) for t in timed]}; median "
        f"run {best['wall_s']:.3f}s wall, stages {json.dumps(best['stage_s'])}")
    return timed, best


def phase_serve():
    """The main path: full-width llama3.2-1b (depth cut to LLAMA_LAYERS)
    served by the engine under PACKED_DUAL.  The run whose launches are counted captures its logits and
    records every kernel call's inputs; the timed and profiled serves that
    follow run as `launch/serve.py` does, without logit capture."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch.serve import build_config, generate
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy

    full = build_config("llama3_2_1b", smoke=False, spiking=True, weight_density=0.3)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab) == (16, 2048, 8192, 128256)
    cfg = dataclasses.replace(full, n_layers=LLAMA_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    engine = Engine(model, params, max_len=PROMPT + GEN, max_slots=REQUESTS,
                    policy=ExecutionPolicy.for_arch(cfg), capture_logits=True)
    torch.cuda.synchronize()
    log(f"llama3.2-1b ({cfg.n_layers} of {full.n_layers} layers) init + plans on "
        f"the card: {time.perf_counter() - t0:.3f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(SEED)
    engine.generate_batch([rng.integers(0, cfg.vocab, size=(8,))], 2)  # warm-up
    prompts = [rng.integers(0, cfg.vocab, size=(PROMPT,)).astype(np.int32)
               for _ in range(REQUESTS)]
    outs, got, calls, counts, forwards = _serve(
        engine, prompts, "dual-sparse", ["ftp_spmm_bsr"],
        {"ftp_bsr": 2, "ftp_bsr_tc": 2})
    want = generate(model, engine.params,
                    torch.as_tensor(np.stack(prompts), device="cuda").long(),
                    model.init_cache(REQUESTS, PROMPT + GEN, device="cuda"), GEN,
                    spiking_mode="infer").cpu().numpy()
    for i in range(REQUESTS):
        np.testing.assert_array_equal(outs[i], want[i])
    log(f"counted serve: {forwards} forwards, {counts['ftp_bsr']} kernel launches, "
        f"all {counts['ftp_bsr_tc']} through the tensor-core instance; tokens "
        f"identical to the greedy loop; sample {outs[0][:8].tolist()}")
    cpu_ref = _cpu_reference(model, cfg, params, prompts, outs, got)
    timed, best = _timed(engine, prompts, outs, "dual-sparse")
    prof = _profile(engine, prompts, best["wall_s"])
    return {"launches": counts["ftp_bsr"], "counts": counts, "calls": calls,
            "cpu_reference": cpu_ref,
            "timed": timed, "median": best, "profile": prof,
            "model": model, "params": params, "prompts": prompts, "outs": outs,
            "logits": got, "engine": engine}


def phase_serve_dense(dual):
    """The dense-weight route at full width: the dual-sparse serve's params
    and prompts under weight_sparsity='dense'."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine, ExecutionPolicy

    model, cfg = dual["model"], dual["model"].cfg
    t0 = time.perf_counter()
    engine = Engine(model, dual["params"], max_len=PROMPT + GEN, max_slots=REQUESTS,
                    policy=ExecutionPolicy.for_arch(cfg, weight_sparsity="dense"),
                    capture_logits=True)
    torch.cuda.synchronize()
    assert "plan_in" not in engine.params["layers"][0]["mlp"]
    log(f"dense engine on the card: {time.perf_counter() - t0:.3f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    engine.generate_batch([np.arange(8) % cfg.vocab], 2)  # warm-up
    outs, got, calls, counts, forwards = _serve(
        engine, dual["prompts"], "dense-weight",
        ["ftp_spmm", "ftp_spmm_fused_lif"],
        {"ftp_spmm": 1, "ftp_spmm_fused_lif": 1, "ftp_dense_tc": 2})
    n_dense = counts["ftp_spmm"] + counts["ftp_spmm_fused_lif"]
    assert counts["ftp_dense_tc"] == n_dense and counts["ftp_dense_simt"] == 0
    log(f"dense-weight serve: all {n_dense} launches of kernels 1 and 2 ran the "
        f"tensor-core instance")
    vs_dual = _dense_vs_dual(outs, got, dual["outs"], dual["logits"])
    log(f"dense-weight serve: {forwards} forwards, launches {counts}; vs the "
        f"dual-sparse serve: max |logit difference| "
        f"{vs_dual['max_logit_diff']:.3e} over {vs_dual['steps_compared']} steps "
        f"(<= {LOGIT_TOL}), {vs_dual['tokens_disagree']} of "
        f"{vs_dual['tokens_compared']} tokens differ (each at a near tie)")
    timed, best = _timed(engine, dual["prompts"], outs, "dense-weight")
    prof = _profile(engine, dual["prompts"], best["wall_s"])
    return {"counts": counts, "calls": calls, "outs": outs, "logits": got,
            "max_logit_diff_vs_dual": vs_dual["max_logit_diff"],
            "vs_dual": vs_dual, "timed": timed, "median": best, "profile": prof}


def _dense_vs_dual(outs, got, dual_outs, dual_logits):
    """The dense serve against the dual-sparse serve of the same params and
    prompts.  Their FFN kernels add the same exact products in other orders,
    so logits may differ by rounding that flips a few spikes: within
    LOGIT_TOL, as the card-vs-CPU check holds them.  A token may differ only
    where the dual serve's top two logits lie within 2 x LOGIT_TOL (the rule
    of `_cpu_reference`); after a request's first differing token its later
    steps see another context, so logits are compared up to and including
    that step."""
    import numpy as np

    toks, want = np.stack(outs), np.stack(dual_outs)       # (B, GEN)
    differ = toks != want
    top2 = np.sort(dual_logits, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) <= 2 * LOGIT_TOL
    assert not bool((differ & ~close).any()), (
        f"{int((differ & ~close).sum())} dense-serve tokens differ from the "
        "dual serve's away from a near tie")
    first = np.where(differ.any(1), differ.argmax(1), GEN - 1)
    steps = np.arange(GEN)[None, :] <= first[:, None]      # (B, GEN)
    diff = float(np.abs(got - dual_logits)[steps].max())
    assert diff <= LOGIT_TOL, diff
    return {"max_logit_diff": diff, "steps_compared": int(steps.sum()),
            "tokens_compared": int(differ.size),
            "tokens_disagree": int(differ.sum())}


def _cpu_reference(model, cfg, params, prompts, outs, got):
    """The same params through the port on the CPU (the kernels' plain
    versions, CPU GEMMs), teacher-forced with the served tokens: its prefill
    and decode logits against the card's (``got``: each request's (gen, V)
    logits; requests may have generated different lengths, each is compared
    over its own).  Tokens may disagree only where the reference's top two
    logits lie within 2 x LOGIT_TOL."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine, ExecutionPolicy

    t0 = time.perf_counter()
    outs = [np.asarray(o) for o in outs]
    gens = [len(o) for o in outs]
    n, gen = len(prompts), max(gens)
    ref = Engine(model, params, max_len=PROMPT + gen, max_slots=n,
                 policy=ExecutionPolicy.for_arch(cfg), device="cpu")
    cache = model.init_cache(n, PROMPT + gen, device="cpu")
    forced = torch.zeros((n, gen), dtype=torch.long)
    for b, o in enumerate(outs):
        forced[b, :len(o)] = torch.as_tensor(o).long()
    with torch.no_grad():
        logits, cache = model.prefill(
            ref.params, {"tokens": torch.as_tensor(np.stack(prompts)).long()},
            cache, spiking_mode="infer")
        steps = [logits[:, -1]]
        for k in range(gen - 1):
            logits, cache = model.decode(ref.params, forced[:, k:k + 1], cache,
                                         spiking_mode="infer")
            steps.append(logits[:, -1])
    want_all = torch.stack(steps, dim=1).numpy()             # (B, GEN, V)
    want = np.concatenate([want_all[b, :g] for b, g in enumerate(gens)])
    drift = np.abs(np.concatenate([np.asarray(got[b])[:g]
                                   for b, g in enumerate(gens)]) - want)
    first = np.cumsum([0] + gens[:-1])                       # prefill rows
    top2 = np.sort(want, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) <= 2 * LOGIT_TOL
    differ = want.argmax(-1) != np.concatenate(outs)
    out = {"requests": n, "tokens_per_request": gens,
           "max_abs_drift": float(drift.max()),
           "max_abs_drift_prefill": float(drift[first].max()),
           "mean_abs_drift": float(drift.mean()),
           "logit_std": float(want.std()),
           "tokens_compared": int(differ.size),
           "tokens_disagree": int(differ.sum()),
           "seconds": time.perf_counter() - t0}
    log(f"card vs CPU reference (teacher-forced, {n} requests of {gens} "
        f"steps): max "
        f"|logit drift| {out['max_abs_drift']:.3e} (prefill "
        f"{out['max_abs_drift_prefill']:.3e}, mean {out['mean_abs_drift']:.3e}, "
        f"logit std {out['logit_std']:.3f}); {out['tokens_disagree']} of "
        f"{out['tokens_compared']} tokens disagree; {out['seconds']:.1f}s")
    assert out["max_abs_drift"] <= LOGIT_TOL, out
    assert not bool((differ & ~close).any()), (
        f"{int((differ & ~close).sum())} tokens disagree away from a near tie")
    return out


def _group_rows(groups):
    """Per-launch means of the replay groups, with the bound kind of the
    larger share of the group's bound time."""
    rows = []
    for g in groups.values():
        n = g.pop("launches")
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "active_blocks",
                  "spike_density", "simt_ms"):
            if k in g:
                g[k] /= n
        g["bound_by"] = ("bytes" if g.pop("bytes_bound_ms") / n >= g["bound_ms"] / 2
                         else "operations")
        g["launches"] = n
        rows.append(g)
        simt = f" (SIMT {g['simt_ms']:.4f} ms)" if "simt_ms" in g else ""
        log(f"{g['case']}: {n} launches, max_abs_err {g['max_abs_err']:.3e}, flips "
            f"{g['flips']}, per launch: kernel {g['ms']:.4f} ms{simt}, plain "
            f"{g['plain_ms']:.4f} ms, matmul {g['library_ms']:.4f} ms, bound "
            f"{g['bound_ms']:.4f} ms ({g['bound_by']}); active spike blocks "
            f"{g['active_blocks']:.3f}, spike density {g['spike_density']:.4f}")
    return rows


def _add(groups, label, M, fuse, err, flips, row, active, density):
    g = groups.setdefault(label, {
        "case": label, "M": M, "fuse_lif": fuse,
        "launches": 0, "max_abs_err": 0.0, "flips": 0, "ms": 0.0,
        "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
        "bytes_bound_ms": 0.0, "active_blocks": 0.0, "spike_density": 0.0})
    g["launches"] += 1
    g["max_abs_err"] = max(g["max_abs_err"], err)
    g["flips"] += flips
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "simt_ms"):
        if k in row:
            g[k] = g.get(k, 0.0) + row[k]
    if "instance" in row:
        g["instance"] = row["instance"]
    if row["bound_by"] == "bytes":
        g["bytes_bound_ms"] += row["bound_ms"]
    g["active_blocks"] += active
    g["spike_density"] += density


def _replay(calls, prefix="serve"):
    """Every BSR kernel call of a counted serve again, on its own inputs
    (with its timestep gate, for kernel 4's calls): both instances vs the
    plain version, then the kernel (`tc`), its SIMT instance, the plain
    version and the library yardstick timed against the call's bound.
    Grouped by (M, fuse_lif): W_in runs with the LIF fused, W_out without;
    in every group `tc` must beat SIMT per launch."""
    from repro_torch.serve.batching import spike_sparsity

    flush = _flush_buffer()
    dense, groups = {}, {}
    for n, (_, args, kw) in enumerate(calls):
        args = args[:8]
        bm, fuse, tmap = kw["bm"], kw["fuse_lif"], kw.get("tmap")
        label = (f"{prefix} {'W_in fused_lif' if fuse else 'W_out full_sums'} "
                 f"M={args[0].shape[0]}")
        err, flips = _parity(f"{label} call {n}", args, bm, fuse, tmap)
        key = args[1].data_ptr()
        if key not in dense:
            dense[key] = _dense_weight(args)
        row = _measure(args, bm, fuse, flush, dense[key], 3, tmap)
        _add(groups, label, args[0].shape[0], fuse, err, flips, row,
             float((args[5] > 0).float().mean()), 1.0 - spike_sparsity(args[0], T))
    rows = _group_rows(groups)
    for r in rows:
        assert r.get("instance") == "tc", r["case"]
        _assert_tc_faster(r)
    return rows


def _replay_dense(calls):
    """Every dense-kernel call of the dense serve again, on its own inputs:
    held against the plain version and timed against its bound, the
    tensor-core instance (the one the serve ran) beside the SIMT one."""
    from repro_torch.serve.batching import spike_sparsity

    flush = _flush_buffer()
    groups = {}
    for n, (name, args, _) in enumerate(calls):
        a, w, Tc = args[:3]
        fuse = name == "ftp_spmm_fused_lif"
        label = (f"dense serve {'W_in fused_lif' if fuse else 'W_out full_sums'} "
                 f"M={a.shape[0]}")
        assert _dense_instance(w) == "tc", f"{label} call {n}"
        err, flips = _dense_parity(f"{label} call {n}", a, w, Tc, fuse)
        row = _dense_measure(a, w, Tc, fuse, flush, 3)
        _add(groups, label, a.shape[0], fuse, err, flips, row, 1.0,
             1.0 - spike_sparsity(a, Tc))
    return _group_rows(groups)


def _profile(engine, prompts, unprofiled_wall):
    """One more serve of the same requests under torch.profiler: device
    busy time (kernels and copies of the one stream, summed) against the
    host wall time, and the kernels that take it.  The idle share is given
    against the profiled wall and against the median unprofiled one."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ftp_spmm

    n0 = sum(ftp_spmm.launch_counts()[k] for k in ftp_spmm.KERNEL_NAMES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_batch(prompts, GEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_launch = sum(ftp_spmm.launch_counts()[k] for k in ftp_spmm.KERNEL_NAMES) - n0
    by_name = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.device_time_total * 1e-6
    busy = sum(by_name.values())
    ftp = sum(v for k, v in by_name.items() if "ftp_" in k)
    out = {"wall_s": wall, "device_busy_s": busy, "ftp_device_s": ftp,
           "ftp_launches": n_launch,
           "ftp_ms_per_launch": 1e3 * ftp / n_launch,
           "idle_share_profiled": 1.0 - busy / wall if busy else None,
           "idle_share_unprofiled": 1.0 - busy / unprofiled_wall if busy else None}
    if not busy:
        log("profile: no device time recorded (not measured)")
        return out
    log(f"profile: device busy {busy:.3f}s; idle share {out['idle_share_profiled']:.3f} "
        f"of the profiled wall ({wall:.3f}s), {out['idle_share_unprofiled']:.3f} of "
        f"the unprofiled one ({unprofiled_wall:.3f}s); FTP kernels {ftp:.4f}s, "
        f"{out['ftp_ms_per_launch']:.4f} ms per launch in the serve")
    for name, sec in by_name.most_common(12):
        log(f"  {sec * 1e3:9.3f} ms  {name[:110]}")
    return out


# ---------------------------------------------------------------------------
# phase 7: kernel 4, the adaptive BSR kernel
# ---------------------------------------------------------------------------

def _plans_by_payload(params):
    return {p.payload.data_ptr(): p for lp in params["layers"]
            for p in (lp["mlp"]["plan_in"], lp["mlp"]["plan_out"])}


def phase_adaptive(dual):
    """Kernel 4 on the dual-sparse serve's calls through `ops.dispatch`
    (its own counted path), bit-equal to kernel 3; lossy (min_spikes=2)
    equal to kernel 3 on the masked input; full-width silent-front inputs
    and the reference's T = 16 bench shape; timed."""
    import numpy as np
    import torch

    from repro_torch.core.packing import (
        mask_low_activity_timesteps,
        timestep_activity_map,
    )
    from repro_torch.kernels import ftp_spmm, ops
    from repro_torch.kernels.join_plan import build_weight_plan
    from repro_torch.serve.batching import spike_sparsity
    from repro_torch.serve.policy import (
        PACKED_DUAL,
        PACKED_DUAL_ADAPTIVE,
        ExecutionPolicy,
        adaptive_t,
        approximate,
    )

    plans = _plans_by_payload(dual["engine"].params)
    calls = []
    for _, args, kw in dual["calls"]:
        a, payload, n_out, Tc, v_th, tau = (args[0], args[1], args[6], args[7],
                                            args[8], args[9])
        calls.append((a, plans[payload.data_ptr()], n_out, Tc, v_th, tau,
                      kw["fuse_lif"]))

    def path():
        return [ops.dispatch(a, plan, PACKED_DUAL_ADAPTIVE, Tc, n_out=n_out,
                             fuse_lif=fuse, v_th=v_th, tau=tau)
                for a, plan, n_out, Tc, v_th, tau, fuse in calls]

    outs, counts = _counted("adaptive replay of the serve", path)
    assert counts == dict(dict.fromkeys(counts, 0), ftp_bsr_adaptive=len(calls),
                          ftp_bsr_tc=len(calls)), counts
    lossy = ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                            temporal=adaptive_t(2), exactness=approximate(8.0))
    n_live, n_lossy_differs = [], 0
    for (a, plan, n_out, Tc, v_th, tau, fuse), got in zip(calls, outs):
        kw = dict(n_out=n_out, fuse_lif=fuse, v_th=v_th, tau=tau)
        want = ops.dispatch(a, plan, PACKED_DUAL, Tc, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            "kernel 4 != kernel 3 at min_spikes=1 on a serve call"
        n_live.append(int(timestep_activity_map(a, Tc).sum()))
        lo = ops.dispatch(a, plan, lossy, Tc, **kw)
        masked = mask_low_activity_timesteps(a, Tc, 2)
        n_lossy_differs += int(not torch.equal(masked, a))
        mo = ops.dispatch(masked, plan, PACKED_DUAL, Tc, **kw)
        assert torch.equal(lo[0], mo[0]) and torch.equal(lo[1], mo[1]), \
            "kernel 4 at min_spikes=2 != kernel 3 on the masked input"
    log(f"kernel 4 == kernel 3 on all {len(calls)} serve calls; live planes per "
        f"call {min(n_live)}..{max(n_live)} of {T}; min_spikes=2 == kernel 3 on "
        f"the masked input ({n_lossy_differs} calls had a plane masked)")

    # replay timing, grouped as in phase 5
    flush = _flush_buffer()
    groups, dense = {}, {}
    for n, (a, plan, n_out, Tc, v_th, tau, fuse) in enumerate(calls):
        bm = ftp_spmm.pick_bm(a.shape[0], Tc)
        tmap = timestep_activity_map(a, Tc).to(torch.int32)
        args = (a, plan.payload, plan.kidx, plan.vidx, plan.cnt,
                ops._activity(a, bm, plan), n_out, Tc, v_th, tau)
        label = (f"adaptive serve {'W_in fused_lif' if fuse else 'W_out full_sums'} "
                 f"M={a.shape[0]}")
        err, flips = _parity(f"{label} call {n}", args[:8], bm, fuse, tmap)
        key = plan.payload.data_ptr()
        if key not in dense:
            dense[key] = _dense_weight(args)
        row = _measure(args[:8], bm, fuse, flush, dense[key], 3, tmap)
        _add(groups, label, a.shape[0], fuse, err, flips, row,
             float((args[5] > 0).float().mean()), 1.0 - spike_sparsity(a, Tc))
    served = _group_rows(groups)
    for r in served:
        assert r.get("instance") == "tc", r["case"]
        _assert_tc_faster(r)

    # synthetic: full width with silent front planes, and the bench shape
    dev = torch.device("cuda")
    gen, w_in, w_out, plan_in, plan_out = _ffn_weights(dev)
    cases = []
    for M in (4, 512):
        for label, a, plan, n_out, fuse in (
                (f"W_in fused_lif M={M}", _spikes(gen, M, 2048, T, (0, 1)), plan_in,
                 8192, True),
                (f"W_out full_sums M={M}", _spikes(gen, M, 8192, T, (0, 1)),
                 plan_out, 2048, False)):
            tmap = timestep_activity_map(a, T).to(torch.int32)
            assert int(tmap.sum()) <= T - 2
            cases.append(_check_case(f"adaptive {label} planes 0-1 silent", a,
                                     plan, n_out, fuse, flush, tmap))
            want = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=n_out, fuse_lif=fuse)
            got = ops.dispatch(a, plan, PACKED_DUAL_ADAPTIVE, T, n_out=n_out,
                               fuse_lif=fuse)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the reference's adaptive bench row (benchmarks/kernels_bench.py:127)
    Tb, Mb, Kb, Nb = 16, 128, 2304, 512
    rng = np.random.default_rng(0)
    spk = rng.random((Tb, Mb, Kb)) < 0.15
    spk[:12] = False
    words = torch.zeros((Mb, Kb), dtype=torch.int64)
    for t in range(Tb):
        words |= torch.from_numpy(spk[t]).to(torch.int64) << t
    a = words.to(torch.int32).to(dev)
    from repro_torch.core.snn_layers import prune_by_magnitude

    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(Kb, Nb)).astype(
        np.float32)).to(dev), 0.03)
    tmap = timestep_activity_map(a, Tb).to(torch.int32)
    assert int(tmap.sum()) == 4
    # the reference's f32 payload (SIMT), then a bf16 copy (tensor cores)
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, " bf16")):
        plan = build_weight_plan(w.to(dtype), bk=256, bn=256)
        bench = _check_case(f"adaptive bench{tag} T=16 M=128 K=2304 N=512", a,
                            plan, Nb, True, flush, tmap)
        full = _check_case(f"full bench{tag} T=16 M=128 K=2304 N=512", a, plan,
                           Nb, True, flush, Tc=Tb)
        got = ops.dispatch(a, plan, PACKED_DUAL_ADAPTIVE, Tb, n_out=Nb,
                           fuse_lif=True)
        want = ops.dispatch(a, plan, PACKED_DUAL, Tb, n_out=Nb, fuse_lif=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        lo = ops.dispatch(a, plan, lossy, Tb, n_out=Nb, fuse_lif=True)
        mo = ops.dispatch(mask_low_activity_timesteps(a, Tb, 2), plan,
                          PACKED_DUAL, Tb, n_out=Nb, fuse_lif=True)
        assert torch.equal(lo[0], mo[0]) and torch.equal(lo[1], mo[1])
        log(f"bench shape{tag} ({bench['instance']}): adaptive {bench['ms']:.4f} "
            f"ms vs full {full['ms']:.4f} ms ({full['ms'] / bench['ms']:.2f}x), "
            "both == on the outputs")
        cases += [bench, full]
    return {"launches": counts["ftp_bsr_adaptive"], "counts": counts,
            "served": served, "cases": cases}


# ---------------------------------------------------------------------------
# phase 8: the train step at full width
# ---------------------------------------------------------------------------

def _train_cfg(n_layers=None):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama3_2_1b"), spiking_ffn=True,
                              spiking_T=T, spiking_weight_density=0.3)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def _capture_attention(store, n):
    """Keep the (q, k, v) of the first ``n`` calls of the model's attention
    (one forward's layers, in order: the remat recompute comes later);
    returns the function that undoes the wrapping."""
    from repro_torch.models import layers

    orig = layers.multihead_attention

    def recorded(q, k, v, cfg, **kw):
        if len(store) < n:
            store.append(tuple(t.detach().clone() for t in (q, k, v)))
        return orig(q, k, v, cfg, **kw)

    layers.multihead_attention = recorded
    return lambda: setattr(layers, "multihead_attention", orig)


def _device_busy(fn):
    """fn() under torch.profiler: (host wall s, device busy s, the largest
    device entries by name)."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.device_time_total * 1e-6
    return wall, sum(by_name.values()), by_name.most_common(10)


def phase_train():
    """Full-width, full-depth llama3.2-1b with spiking FFNs (T = 4, weight
    density 0.3), seed 0, trained TRAIN_STEPS steps by `make_train_step`
    with the default optimizer on `SyntheticLMData` (launch/train.py's
    batch and sequence); every step timed with a synchronised host clock.
    Layer by layer, the first forward's attention inputs are kept for
    phase 9."""
    import math

    import torch

    from repro_torch.data import SyntheticLMData, batch_to_torch
    from repro_torch.models.registry import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_paths

    cfg = _train_cfg()
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (16, 2048, 8192, 128256)
    model = build_model(cfg)
    data = SyntheticLMData(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, SEED, device="cuda")
    torch.cuda.synchronize()
    ffn = {p: w.clone() for p, w in tree_paths(state["params"])
           if p.endswith(("mlp/wu", "mlp/wd"))}
    log(f"train state on the card: {time.perf_counter() - t0:.3f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    step = make_train_step(model)
    captured, losses, gnorms, times = [], [], [], []
    for s in range(TRAIN_STEPS):
        batch = batch_to_torch(data.batch(s), "cuda")
        undo = _capture_attention(captured, cfg.n_layers) if s == 0 else None
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        finally:
            if undo:
                undo()
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        log(f"train step {s}: loss {losses[-1]:.5f}, grad norm {gnorms[-1]:.5f}, "
            f"{times[-1] * 1e3:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in losses + gnorms), (losses, gnorms)
    assert len(captured) == cfg.n_layers
    # unit-variance logits at random init: CE ~ ln V + 1/2
    expect0 = math.log(cfg.vocab) + 0.5
    assert abs(losses[0] - expect0) <= LOSS0_TOL, (losses[0], expect0)
    params = dict(tree_paths(state["params"]))
    moved = {}
    for p, w0 in ffn.items():
        pruned = w0 == 0
        assert 0.69 < float(pruned.float().mean()) < 0.71, p
        assert not bool(params[p][pruned].any()), f"{p}: a pruned weight moved"
        moved[p] = float((params[p][~pruned] != w0[~pruned]).float().mean())
    # every wu survivor gets a surrogate gradient; a wd row moves only where
    # its hidden neuron fired in some step
    assert all(m > 0 for m in moved.values()), moved
    assert min(m for p, m in moved.items() if p.endswith("wu")) > 0.5, moved
    del ffn
    median = statistics.median(times)
    wall, busy, top = _device_busy(
        lambda: step(state, batch_to_torch(data.batch(TRAIN_STEPS), "cuda")))
    out = {"losses": losses, "grad_norms": gnorms, "step_s": times,
           "median_step_s": median,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median,
           "peak_memory_gib": peak / 2**30,
           "survivors_moved": {"wu_min": min(m for p, m in moved.items() if p.endswith("wu")),
                               "wd_min": min(m for p, m in moved.items() if p.endswith("wd"))},
           "profiled_step_wall_s": wall, "device_busy_s": busy,
           "idle_share_profiled": 1.0 - busy / wall if busy else None,
           "idle_share_unprofiled": 1.0 - busy / median if busy else None}
    log(f"train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (step 0 expected {expect0:.3f} +- "
        f"{LOSS0_TOL}); median step {median * 1e3:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s, peak memory {out['peak_memory_gib']:.2f} "
        f"GiB; all {len(moved)} pruned FFN patterns still exactly zero; survivors "
        f"moved: {json.dumps(out['survivors_moved'])} (least share per matrix)")
    if busy:
        log(f"train profile: device busy {busy:.3f}s of a {wall:.3f}s profiled step; "
            f"idle share {out['idle_share_profiled']:.3f} profiled, "
            f"{out['idle_share_unprofiled']:.3f} of the median unprofiled step")
        for name, sec in top:
            log(f"  {sec * 1e3:9.3f} ms  {name[:110]}")
    else:
        log("train profile: no device time recorded (not measured)")
    del state
    out["card_vs_cpu"] = _train_card_vs_cpu(data)
    out["restart"] = _train_restart(data)
    return out, captured


def _train_card_vs_cpu(data):
    """Step 0 of a 2-layer full-width copy on the card and on the CPU (the
    same params and batch): loss and grad norm within TRAIN_LOSS_RTOL and
    TRAIN_GNORM_RTOL."""
    import torch

    from repro_torch.data import batch_to_torch
    from repro_torch.models.registry import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_map

    model = build_model(_train_cfg(2))
    card = init_train_state(model, SEED, device="cuda")
    cpu = tree_map(lambda t: t.cpu(), card)
    step = make_train_step(model)
    batch = data.batch(0)
    _, mg = step(card, batch_to_torch(batch, "cuda"))
    t0 = time.perf_counter()
    _, mc = step(cpu, batch_to_torch(batch, "cpu"))
    out = {"loss_card": float(mg["loss"]), "loss_cpu": float(mc["loss"]),
           "grad_norm_card": float(mg["grad_norm"]),
           "grad_norm_cpu": float(mc["grad_norm"]),
           "cpu_step_s": time.perf_counter() - t0}
    out["loss_rel"] = abs(out["loss_card"] - out["loss_cpu"]) / out["loss_cpu"]
    out["grad_norm_rel"] = (abs(out["grad_norm_card"] - out["grad_norm_cpu"])
                            / out["grad_norm_cpu"])
    log(f"2-layer full-width step 0, card vs CPU: loss {out['loss_card']:.6f} vs "
        f"{out['loss_cpu']:.6f} (rel {out['loss_rel']:.2e} <= {TRAIN_LOSS_RTOL}), "
        f"grad norm {out['grad_norm_card']:.5f} vs {out['grad_norm_cpu']:.5f} (rel "
        f"{out['grad_norm_rel']:.2e} <= {TRAIN_GNORM_RTOL}); CPU step "
        f"{out['cpu_step_s']:.1f}s")
    assert out["loss_rel"] <= TRAIN_LOSS_RTOL, out
    assert out["grad_norm_rel"] <= TRAIN_GNORM_RTOL, out
    return out


def _train_restart(data):
    """2 steps, checkpoint, restore into a fresh state, 2 more steps equal 4
    straight steps bit for bit (2 layers, full width).  Deterministic
    algorithms are on for this check only: the embedding and gather
    backwards add with atomics otherwise."""
    import tempfile

    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import batch_to_torch
    from repro_torch.models.registry import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    model = build_model(_train_cfg(2))
    step = make_train_step(model)
    batches = [batch_to_torch(data.batch(s), "cuda") for s in range(4)]
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        start = init_train_state(model, SEED, device="cuda")
        straight = start
        for b in batches:
            straight, _ = step(straight, b)
        resumed = start
        for b in batches[:2]:
            resumed, _ = step(resumed, b)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
            mgr = CheckpointManager(d, interval=1)
            mgr.maybe_save(2, resumed, force=True)
            mgr.wait()
            resumed, at = mgr.restore_latest(
                init_train_state(model, SEED + 1, device="cuda"))
        assert at == 2 and int(resumed["step"]) == 2
        for b in batches[2:]:
            resumed, _ = step(resumed, b)
        leaves = list(zip(tree_leaves(straight), tree_leaves(resumed)))
        equal = sum(bool(torch.equal(a, b)) for a, b in leaves)
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    log(f"restart: 2 steps + save + restore_latest + 2 steps == 4 straight steps "
        f"in {equal} of {len(leaves)} state leaves, bit for bit (deterministic "
        "algorithms on)")
    assert equal == len(leaves)
    return {"leaves": len(leaves), "equal": equal}


# ---------------------------------------------------------------------------
# phase 9: flash attention (kernels 5-7)
# ---------------------------------------------------------------------------

def _to_bh(t, groups=1):
    """(B, S, heads, dh) -> (B * heads * groups, S, dh), each head repeated
    ``groups`` times (k, v over the GQA groups)."""
    if groups > 1:
        t = t.repeat_interleave(groups, dim=2)
    B, S, H, dh = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * H, S, dh).contiguous()


def _flash_bounds(q, Skv, causal, window):
    """{kernel: (bound ms, bound_by)} for one attention call
    (`roofline.kernel_work.flash_work`: the visible pairs' multiply-adds
    against each input read once and each output written once), at the bf16
    tensor-core peak for bf16 inputs and the f32 peak for f32."""
    from repro_torch.roofline import kernel_work as kw

    dtype = kw.flash_dtype(q)
    return {name: kw.bound_ms(nbytes, ops, dtype)
            for name, (nbytes, ops) in kw.flash_work(q, Skv, causal, window).items()}


def _sdpa_args(q, k, v, causal, window, B):
    """The (B, H, S, dh) views and mask arguments of
    scaled_dot_product_attention for the same work."""
    from repro_torch.kernels.ref import _attn_mask

    view = lambda t: t.reshape(B, t.shape[0] // B, t.shape[1], t.shape[2])
    kw = {}
    if causal and window:
        kw["attn_mask"] = _attn_mask(q.shape[1], k.shape[1], True, window, q.device)
    elif causal:
        kw["is_causal"] = True
    return view(q), view(k), view(v), kw


def _flash_outputs(q, k, v, do, causal, window, instance=None, fwd=None):
    """(o, lse, dq, dk, dv) of kernels 5 and 6 on one instance (the routed
    one by default), each kernel launched once on it (asserted by its
    instance count).  The backward takes delta from the instance's own o
    and its lse, or from ``fwd`` = (o, lse) when given (another instance's
    forward: the same inputs for both backward instances)."""
    import torch

    from repro_torch.kernels import flash_mha as fm

    inst = instance or fm.flash_instance(q.dtype, q.shape[-1])
    before = fm.launch_counts()
    kw = dict(causal=causal, window=window, instance=instance)
    o, lse = fm.flash_mha_fwd(q, k, v, **kw)
    o_in, lse_in = fwd if fwd is not None else (o, lse)
    delta = (o_in.float() * do.float()).sum(-1)
    dq = fm.flash_mha_bwd_dq(q, k, v, do, lse_in, delta, **kw)
    dk, dv = fm.flash_mha_bwd_dkv(q, k, v, do, lse_in, delta, **kw)
    torch.cuda.synchronize()
    after = fm.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[f"{name}_{inst}"] == before[f"{name}_{inst}"] + 1, (name, inst)
    return (o, lse, dq, dk, dv), delta


def _flash_case(label, q, k, v, do, causal, window, tol, grad_tol=None,
                flush=None, reps=10, B=1):
    """Kernels 5 and 6 (and 7 around them) against their plain versions on
    one input, through the instance the dtype routes to: o within ``tol``,
    lse within ``tol`` for f32 and 3e-4 for bf16, dq, dk, dv within
    ``grad_tol`` (default ``tol``).  On bf16 inputs (the `tc` instance) the
    SIMT instance on the same inputs too (its backward fed `tc`'s o and
    lse), held to `tc` by the same gates.
    Timed with their bounds and the library yardsticks when ``flush`` is
    given, bf16 also on SIMT (`tc` must be faster in each).  Returns
    {kernel: row}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_mha as fm
    from repro_torch.kernels import ref

    inst = fm.flash_instance(q.dtype, q.shape[-1])
    (o, lse, dq, dk, dv), delta = _flash_outputs(q, k, v, do, causal, window)
    o_p, lse_p = ref.flash_mha_fwd_plain(q, k, v, causal, window)
    dq_p = ref.flash_mha_bwd_dq_plain(q, k, v, do, lse, delta, causal, window)
    dk_p, dv_p = ref.flash_mha_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                            window)
    torch.cuda.synchronize()
    err = lambda a, b: float((a.float() - b.float()).abs().max())
    grad_tol = grad_tol or tol
    lse_tol = tol if q.dtype == torch.float32 else 3e-4  # bf16: f32 sums of exact products

    def hold(got, want, what):
        for a, b, name, t in zip(got, want, ("o", "lse", "dq", "dk", "dv"),
                                 (tol, lse_tol, grad_tol, grad_tol, grad_tol)):
            assert torch.isfinite(a.float()).all(), f"{label}: {what} {name} not finite"
            assert a.shape == b.shape and a.dtype == b.dtype, (label, what, name)
            torch.testing.assert_close(a.float(), b.float(), rtol=t, atol=t,
                                       msg=lambda m: f"{label} {what} {name}: {m}")

    hold((o, lse, dq, dk, dv), (o_p, lse_p, dq_p, dk_p, dv_p), f"{inst} vs plain")
    errs = {"flash_fwd": max(err(o, o_p), err(lse, lse_p)),
            "flash_bwd_dq": err(dq, dq_p),
            "flash_bwd_dkv": max(err(dk, dk_p), err(dv, dv_p))}
    errs["flash_mha"] = max(errs.values())
    rows = {n: {"case": label, "BH": q.shape[0], "S": q.shape[1],
                "Skv": k.shape[1], "dh": q.shape[2], "dtype": str(q.dtype),
                "causal": causal, "window": window, "instance": inst,
                "max_abs_err": e, "tol": tol if n == "flash_fwd" else grad_tol}
            for n, e in errs.items()}
    if inst == "tc":
        simt, _ = _flash_outputs(q, k, v, do, causal, window, instance="simt",
                                 fwd=(o, lse))
        hold((o, lse, dq, dk, dv), simt, "tc vs simt")
        vs = {"flash_fwd": max(err(o, simt[0]), err(lse, simt[1])),
              "flash_bwd_dq": err(dq, simt[2]),
              "flash_bwd_dkv": max(err(dk, simt[3]), err(dv, simt[4]))}
        vs["flash_mha"] = max(vs.values())
        for n, e in vs.items():
            rows[n]["vs_simt_max_abs_err"] = e
    if flush is None:
        log(f"flash {label} ({inst}): max_abs_err {json.dumps({n: float(f'{e:.3e}') for n, e in errs.items()})} "
            f"(tol {tol}, gradients {grad_tol})")
        return rows
    qs, ks, vs_ = (t.clone().requires_grad_() for t in (q, k, v))

    def fwd_bwd(instance=None):
        torch.autograd.grad(fm.flash_mha(qs, ks, vs_, causal, window,
                                         instance=instance), (qs, ks, vs_), do)

    def plain_fwd_bwd():
        op, lp = ref.flash_mha_fwd_plain(q, k, v, causal, window)
        ref.flash_mha_bwd_plain(q, k, v, op, lp, do, causal, window)

    sq, sk, sv, skw = _sdpa_args(*(t.clone().requires_grad_() for t in (q, k, v)),
                                 causal, window, B)
    sdo = do.reshape(sq.shape)
    s_out = F.scaled_dot_product_attention(sq, sk, sv, **skw)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(sq, sk, sv, **skw),
                            (sq, sk, sv), sdo)

    def sdpa_bwd():  # SDPA's backward alone: dq, dk, dv together
        torch.autograd.grad(s_out, (sq, sk, sv), sdo, retain_graph=True)

    plain_reps = max(1, reps // 5)
    # an autograd forward + backward takes the host ~1 ms to enqueue at the
    # train step's small shape: keep the stream busy ~2 ms so that host
    # time stays out of the events
    busy = 4_000_000
    kw = dict(causal=causal, window=window)

    def kernels(instance=None):
        kwi = dict(kw, instance=instance)
        return {"flash_fwd": lambda: fm.flash_mha_fwd(q, k, v, **kwi),
                "flash_bwd_dq": lambda: fm.flash_mha_bwd_dq(q, k, v, do, lse,
                                                            delta, **kwi),
                "flash_bwd_dkv": lambda: fm.flash_mha_bwd_dkv(q, k, v, do, lse,
                                                              delta, **kwi),
                "flash_mha": lambda: fwd_bwd(instance)}

    timed = {
        "flash_fwd": (lambda: ref.flash_mha_fwd_plain(q, k, v, causal, window),
                      lambda: F.scaled_dot_product_attention(
                          sq.detach(), sk.detach(), sv.detach(), **skw)),
        "flash_bwd_dq": (
            lambda: ref.flash_mha_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                               window), sdpa_bwd),
        "flash_bwd_dkv": (
            lambda: ref.flash_mha_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                                window), sdpa_bwd),
        "flash_mha": (plain_fwd_bwd, sdpa_fwd_bwd),
    }
    routed = kernels()
    on_simt = kernels("simt") if inst == "tc" else {}
    bounds = _flash_bounds(q, k.shape[1], causal, window)
    for n, (plain, lib) in timed.items():
        rows[n].update(ms=_time_ms(routed[n], reps, flush, busy),
                       plain_ms=_time_ms(plain, plain_reps, flush, busy),
                       library_ms=_time_ms(lib, reps, flush, busy),
                       bound_ms=bounds[n][0], bound_by=bounds[n][1])
        if n in on_simt:
            rows[n]["simt_ms"] = _time_ms(on_simt[n], reps, flush, busy)
    rows["flash_bwd_dq"]["library"] = rows["flash_bwd_dkv"]["library"] = (
        "scaled_dot_product_attention backward (dq, dk, dv together)")
    for n, r in rows.items():
        simt = f", SIMT {r['simt_ms']:.4f} ms" if "simt_ms" in r else ""
        log(f"flash {label} {n}: max_abs_err {r['max_abs_err']:.3e}, {inst} "
            f"{r['ms']:.4f} ms{simt}, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['ms'] / r['bound_ms']:.1f}x the bound")
    for r in rows.values():
        _assert_tc_faster(r)
    return rows


def _flash_inputs(gen, BH, S, dh, dtype, skv=None, scale_q=1.0):
    import torch

    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")
    skv = skv or S
    return ((mk(BH, S, dh) * scale_q).to(dtype), mk(BH, skv, dh).to(dtype),
            mk(BH, skv, dh).to(dtype), mk(BH, S, dh).to(dtype))


def phase_flash(captured, cfg):
    """Kernels 5-7 on the train step's own attention inputs (every layer of
    phase 8's first forward, k and v repeated over the GQA groups; causal),
    through the autograd Function with a seeded random do: the counted path.
    Layer 0 is also held against autograd through the port's plain
    `multihead_attention` and timed; then the long-sequence and reference
    cases."""
    import torch

    from repro_torch.kernels import flash_mha as fm
    from repro_torch.kernels import ref

    G = cfg.n_heads // cfg.n_kv
    B, S = captured[0][0].shape[:2]
    inputs = [(_to_bh(q), _to_bh(k, G), _to_bh(v, G)) for q, k, v in captured]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    do = torch.randn(inputs[0][0].shape, generator=gen, device="cuda").to(torch.bfloat16)

    def path():
        outs = []
        for q, k, v in inputs:
            qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
            o = fm.flash_mha(qs, ks, vs, True, 0)
            o.backward(do)
            outs.append((o.detach(), qs.grad, ks.grad, vs.grad))
        return outs

    outs, counts = _counted("flash attention on the train step's attention inputs",
                            path)
    n = len(inputs)
    # every launch through the tensor-core instance, none through SIMT
    assert counts == dict(dict.fromkeys(counts, 0), flash_fwd=n, flash_bwd_dq=n,
                          flash_bwd_dkv=n, flash_mha=n, flash_fwd_tc=n,
                          flash_bwd_dq_tc=n, flash_bwd_dkv_tc=n), counts
    # The counted path's gradients against the plain chain (the plain
    # backward fed the plain forward's o and lse), and each kernel against
    # its plain version on the inputs it was given: kernel 5's o and lse
    # against the plain forward, kernel 6's dq, dk, dv against the plain
    # backward fed the forward kernel's own o (through delta = rowsum(o *
    # do)) and lse.  The chain holds o to its last bit: each o element that
    # rounds to the other bf16 neighbour moves a dq row by ulp(o) * do *
    # scale * mean(k).  |diff| / gate of each is logged.
    names = ("o", "lse", "dq", "dk", "dv")
    worst = dict.fromkeys(names, 0.0)
    chain = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    # the witness: the plain backward fed o from f64 math, rounded once,
    # against the plain chain (what the plain o's own rounding takes of the
    # gate); o elements off the plain o, the kernel's and the witness's
    witness, off = dict(chain), {"kernel": 0, "f64": 0}
    for (q, k, v), (o, dq, dk, dv) in zip(inputs, outs):
        o_p, lse_p = ref.flash_mha_fwd_plain(q, k, v, True, 0)
        plain_chain = ref.flash_mha_bwd_plain(q, k, v, o_p, lse_p, do, True, 0)
        o64 = _o_f64(q, k, v)
        off["kernel"] += int((o != o_p).sum())
        off["f64"] += int((o64 != o_p).sum())
        for name, a, b in zip(witness, ref.flash_mha_bwd_plain(
                q, k, v, o64, lse_p, do, True, 0), plain_chain):
            witness[name] = max(witness[name], _over_gate(a, b, FLASH_TOL_BF16))
        _, lse = fm.flash_mha_fwd(q, k, v)  # the backward kernels' lse (uncounted)
        want = (o_p, lse_p, *ref.flash_mha_bwd_plain(q, k, v, o, lse, do, True, 0))
        for a, b, name, t in zip((o, lse, dq, dk, dv), want, names,
                                 (FLASH_TOL_BF16, 3e-4, *[FLASH_TOL_BF16] * 3)):
            torch.testing.assert_close(a.float(), b.float(), rtol=t, atol=t,
                                       msg=lambda m: f"flash {name}: {m}")
            worst[name] = max(worst[name], _over_gate(a, b, t))
        for name, a, b in zip(chain, (dq, dk, dv), plain_chain):
            torch.testing.assert_close(a.float(), b.float(), rtol=FLASH_TOL_BF16,
                                       atol=FLASH_TOL_BF16,
                                       msg=lambda m: f"flash {name} vs the plain chain: {m}")
            chain[name] = max(chain[name], _over_gate(a, b, FLASH_TOL_BF16))
    log(f"flash on all {n} layers' attention inputs (BH {inputs[0][0].shape[0]}, "
        f"S {S}, dh {cfg.head_dim}, bf16, causal): == plain versions within "
        f"{FLASH_TOL_BF16}, lse 3e-4; |diff| / gate per kernel "
        f"{json.dumps({k: round(x, 3) for k, x in worst.items()})}, against the "
        f"plain chain {json.dumps({k: round(x, 3) for k, x in chain.items()})} "
        f"(the f64-o witness {json.dumps({k: round(x, 3) for k, x in witness.items()})}); "
        f"o elements off the plain o: {json.dumps(off)}")
    vs_model = _flash_vs_model_attention(captured[0], outs[0], do, cfg, G)

    flush = _flush_buffer()
    rows = {name: [] for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                  "flash_mha")}

    def add(case_rows):
        for name, r in case_rows.items():
            rows[name].append(r)

    add(_flash_case("train step layer 0", *inputs[0], do, True, 0, FLASH_TOL_BF16,
                    flush=flush, reps=30, B=B))
    for label, window in (("BH=32 S=4096 dh=64 causal", 0),
                          ("BH=32 S=4096 dh=64 window=1024", 1024)):
        q, k, v, g = _flash_inputs(gen, 32, 4096, 64, torch.bfloat16)
        add(_flash_case(label, q, k, v, g, True, window, FLASH_TOL_BF16,
                        flush=flush, reps=5, B=1))
    # two runs equal bit for bit (no atomics)
    runs = []
    for _ in range(2):
        o, lse = fm.flash_mha_fwd(q, k, v, window=1024)
        runs.append((o, lse, *fm.flash_mha_bwd(q, k, v, o, lse, g, window=1024)))
    assert all(torch.equal(a, b) for a, b in zip(*runs)), "two runs differ"
    log("flash: two runs of the S=4096 window case (tc) equal bit for bit")
    # a head dim padded to its template (80 -> 128), bf16 (tc) and SIMT
    q, k, v, g = _flash_inputs(gen, 32, 1024, 80, torch.bfloat16)
    add(_flash_case("BH=32 S=1024 dh=80 (padded to 128) causal", q, k, v, g,
                    True, 0, FLASH_TOL_BF16))
    # the reference test's cases, f32 (SIMT), at its tolerances (outputs
    # 3e-4, large logits 1e-3, gradients 3e-3)
    for label, (BH, Sc, dh, skv, causal, window, scale_q, tol) in {
            "f32 (4,512,128) causal": (4, 512, 128, None, True, 0, 1.0, 3e-4),
            "f32 (4,512,128) none": (4, 512, 128, None, False, 0, 1.0, 3e-4),
            "f32 (4,512,128) window 64": (4, 512, 128, None, True, 64, 1.0, 3e-4),
            "f32 cross 128 vs 512": (2, 128, 64, 512, False, 0, 1.0, 3e-4),
            "f32 logits x30": (1, 256, 64, None, True, 0, 30.0, 1e-3)}.items():
        q, k, v, g = _flash_inputs(gen, BH, Sc, dh, torch.float32, skv, scale_q)
        add(_flash_case(label, q, k, v, g, causal, window, tol, grad_tol=3e-3))
    q, k, v, _ = _flash_inputs(gen, 1, 128, 32, torch.float32)
    o, _ = fm.flash_mha_fwd(q, k, v, bq=64, bk=64)
    torch.testing.assert_close(o[:, 0], v[:, 0], rtol=1e-4, atol=1e-4)
    log("flash: the first causal row == v[:, 0] within 1e-4")
    wide_rows, wide_counts, wide_chain = _flash_wide(gen, flush)
    for name, r in wide_rows.items():
        rows[name] += r
    return {"launches": counts, "rows": rows, "vs_model_attention": vs_model,
            "over_gate": worst, "vs_plain_chain_over_gate": chain,
            "f64_o_witness_over_gate": witness, "o_off_plain": off,
            "wide_launches": wide_counts,
            "wide_vs_plain_chain_over_gate": wide_chain}


def _flash_wide(gen, flush):
    """The head dims above 128 (nemotron's 192, gemma's 256).  bf16 on the
    wide `tc` kernels: BH 8 x S 4096, causal and window 1024, held against
    the plain versions (1e-2, lse 3e-4) and against SIMT on the same inputs,
    timed on both against SDPA and the bound (`tc` must be faster); two
    runs of each window case equal bit for bit; the gradients' |diff| /
    gate against the plain chain (the plain backward fed the plain
    forward's o) logged, not gated; dh 160 padded to 192.  f32 on SIMT at
    the reference test's (4, 512) causal case (3e-4, gradients 3e-3).
    Returns ({kernel: rows}, the launches of these cases by kernel and
    instance, {case: chain |diff| / gate})."""
    import torch

    from repro_torch.kernels import flash_mha as fm
    from repro_torch.kernels import ref

    rows = {name: [] for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                  "flash_mha")}
    chain = {}

    def add(case_rows):
        for name, r in case_rows.items():
            rows[name].append(r)

    def bf16_cases():
        for dh in (192, 256):
            assert fm.flash_instance(torch.bfloat16, dh) == "tc"
            for label, window in ((f"BH=8 S=4096 dh={dh} causal", 0),
                                  (f"BH=8 S=4096 dh={dh} window=1024", 1024)):
                q, k, v, g = _flash_inputs(gen, 8, 4096, dh, torch.bfloat16)
                add(_flash_case(label, q, k, v, g, True, window, FLASH_TOL_BF16,
                                flush=flush, reps=3, B=1))
                o_p, lse_p = ref.flash_mha_fwd_plain(q, k, v, True, window)
                plain = ref.flash_mha_bwd_plain(q, k, v, o_p, lse_p, g, True,
                                                window)
                runs = []
                for _ in range(2 if window else 1):
                    o, lse = fm.flash_mha_fwd(q, k, v, window=window)
                    runs.append((o, lse, *fm.flash_mha_bwd(q, k, v, o, lse, g,
                                                           window=window)))
                chain[label] = {name: round(_over_gate(a, b, FLASH_TOL_BF16), 3)
                                for name, a, b in zip(("dq", "dk", "dv"),
                                                      runs[0][2:], plain)}
                log(f"flash {label}: |diff| / gate against the plain chain "
                    f"{json.dumps(chain[label])}")
            assert all(torch.equal(a, b) for a, b in zip(*runs)), dh
            log(f"flash dh {dh}: two runs of the S=4096 window case (tc) equal "
                "bit for bit")
        q, k, v, g = _flash_inputs(gen, 8, 1024, 160, torch.bfloat16)
        add(_flash_case("BH=8 S=1024 dh=160 (padded to 192) causal", q, k, v, g,
                        True, 0, FLASH_TOL_BF16))

    def f32_cases():
        for dh in (192, 256):
            q, k, v, g = _flash_inputs(gen, 4, 512, dh, torch.float32)
            add(_flash_case(f"f32 (4,512,{dh}) causal", q, k, v, g, True, 0, 3e-4,
                            grad_tol=3e-3))

    _, counts = _counted("flash at head dims 160-256, bf16", bf16_cases)
    _, f32 = _counted("flash at head dims 192-256, f32", f32_cases)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        # each of the 5 bf16 cases on `tc`, SIMT beside it; f32 on SIMT only
        assert counts[f"{name}_tc"] >= 5, counts
        assert f32[f"{name}_simt"] == 2 and f32[f"{name}_tc"] == 0, f32
    return rows, {n: c + f32[n] for n, c in counts.items()}, chain


def _over_gate(a, b, tol):
    """max |a - b| / (tol (1 + |b|)): the share of an rtol = atol = tol gate
    the worst element takes."""
    return float(((a.float() - b.float()).abs() / (tol * (1 + b.float().abs()))).max())


def _o_f64(q, k, v):
    """The plain forward's o (causal) from f64 scores, softmax and value
    product, rounded once to q's dtype."""
    import torch

    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * q.shape[-1] ** -0.5
    S = q.shape[1]
    seen = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = s.masked_fill(~seen, -1e30).softmax(-1)
    return torch.einsum("bqk,bkd->bqd", p, v.double()).to(q.dtype)


def _flash_vs_model_attention(qkv, flash_out, do, cfg, G):
    """Layer 0 through autograd of the port's plain `multihead_attention`
    (the training forward's own attention, which rounds p to bf16 before
    the value product) against the flash kernels' o, dq, dk, dv (dk, dv
    summed over the GQA groups): relative norm of the difference within
    FLASH_VS_MODEL_TOL."""
    import torch

    from repro_torch.models.layers import multihead_attention

    q, k, v = (t.clone().requires_grad_() for t in qkv)
    B, S, H, dh = q.shape
    KV = k.shape[2]
    o = multihead_attention(q, k, v, cfg, q_offset=0,
                            kv_positions=torch.arange(S, device=q.device))
    back = lambda t: t.reshape(B, H, S, dh).permute(0, 2, 1, 3)
    o.backward(back(do))
    fo, fdq, fdk, fdv = flash_out
    per_kv = lambda t: back(t).reshape(B, S, KV, G, dh).sum(3)
    rel = {}
    for name, got, want in (("o", back(fo), o.detach()), ("dq", back(fdq), q.grad),
                            ("dk", per_kv(fdk.float()), k.grad),
                            ("dv", per_kv(fdv.float()), v.grad)):
        d = got.float() - want.float()
        rel[name] = float(d.norm() / want.float().norm())
    log(f"flash vs autograd of the model's plain attention, layer 0: relative "
        f"norm of the difference {json.dumps({k: float(f'{x:.3e}') for k, x in rel.items()})} "
        f"(<= {FLASH_VS_MODEL_TOL})")
    assert max(rel.values()) <= FLASH_VS_MODEL_TOL, rel
    return rel


# ---------------------------------------------------------------------------
# phase 10: the serve features (pipelined executor, paged cache, prefix reuse)
# ---------------------------------------------------------------------------

# Phase 10d's staggered schedule at max_len 144 (9 pages of 16 a row): wave
# 1 at step 0, wave 2 at step 4, when wave 1's cohort has reached position
# 124 (prefill 120 + 4 decodes), so the waves merge; the different budgets
# retire rows at different steps.
PAGE = 16
WAVES = ((0, 120, (12, 20)), (4, 124, (8, 16)))


def _feature_serve(engine, prompts, label, expect):
    """One counted serve with logits captured: (tokens, (B, GEN, V) logits,
    launch counts); every expected kernel launched ``expect[k]`` x layers
    x forwards times and no other kernel."""
    import numpy as np

    engine.metrics.reset()
    engine.logit_traces = {}
    engine.capture_logits = True
    outs, counts = _counted(f"{label} serve",
                            lambda: engine.generate_batch(prompts, GEN))
    s = engine.summary()
    forwards = s["prefill_batches"] + s["decode_batches"]
    want = {k: v * engine.cfg.n_layers * forwards for k, v in expect.items()}
    assert counts == {k: want.get(k, 0) for k in counts}, (counts, forwards)
    traces = engine.logit_traces
    got = np.stack([np.stack(traces[r]) for r in sorted(traces)])
    assert got.shape == (REQUESTS, GEN, engine.cfg.vocab)
    return outs, got, counts


def _bitwise(label, outs, got, want_outs, want_logits):
    import numpy as np

    for a, b in zip(outs, want_outs):
        np.testing.assert_array_equal(a, b, err_msg=label)
    assert np.array_equal(got, want_logits), (
        f"{label}: logits differ from the sync serve's at "
        f"{int((got != want_logits).sum())} of {got.size} elements")


def _check_no_host_sync(engine, prompts):
    """A pipelined serve with the decode and encode stages of every step run
    under torch.cuda.set_sync_debug_mode("error"): a host wait there (a
    device read, a pageable host-to-device copy, a stream or device
    synchronize) raises.  The drain stage, which waits by design, runs
    outside it.  Returns the number of checked decode dispatches."""
    import torch

    from repro_torch.serve import executor as ex_mod

    ex = engine.executor
    checked = {"decode": 0, "encode": 0}

    def strict(fn, name):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                checked[name] += 1
        return run

    engine.metrics.reset()
    launch = ex_mod.PendingStep.__dict__["launch"]
    ex._dispatch_decode = strict(ex._dispatch_decode, "decode")
    ex.encode = strict(ex.encode, "encode")
    ex_mod.PendingStep.launch = staticmethod(
        strict(ex_mod.PendingStep.launch, "decode"))
    try:
        engine.capture_logits = True
        engine.generate_batch(prompts, GEN)
        torch.cuda.synchronize()
    finally:
        del ex._dispatch_decode, ex.encode
        ex_mod.PendingStep.launch = launch
    assert checked["decode"] == 2 * engine.metrics.n_decode_batches > 0, checked
    assert checked["encode"] == engine.metrics.n_decode_batches, checked
    # the mode is a prototype that "does not yet detect all synchronizing
    # operations": it must at least see the waits the executor avoids
    for what, wait in (("a pageable host-to-device copy",
                        lambda: torch.tensor([1, 2], device="cuda")),
                       ("a device-to-host read",
                        lambda: torch.ones(2, device="cuda").cpu())):
        torch.cuda.set_sync_debug_mode("error")
        try:
            wait()
        except RuntimeError:
            pass
        else:
            raise AssertionError(f"sync debug mode did not see {what}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return engine.metrics.n_decode_batches


def _staggered(engine, prompts, gens):
    """Phase 10d's schedule through ``engine``; returns each request's
    tokens in submission order."""
    import numpy as np

    tickets, step, i = [], 0, 0
    arrivals = [w[0] for w in WAVES for _ in w[2]]
    while not (engine.idle and i == len(prompts)):
        while i < len(prompts) and arrivals[i] <= step:
            tickets.append(engine.submit(prompts[i], gens[i]))
            i += 1
        engine.step()
        step += 1
    return [np.asarray(engine.results[t.rid].generated, np.int32)
            for t in tickets]


def _paged_phase(dual, sync_engine):
    """10d: paged serves of a staggered schedule at full width against the
    dense-layout sync engine of phase 5 (max_len 144 = 9 pages of 16)."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine, ExecutionPolicy, paged

    model, params, cfg = dual["model"], dual["params"], dual["model"].cfg
    assert PROMPT + GEN == 9 * PAGE and sync_engine.max_len == 9 * PAGE
    rng = np.random.default_rng(SEED + 10)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
               for _, n, gens in WAVES for _ in gens]
    gens = [g for _, _, wave in WAVES for g in wave]

    def run(engine, label):
        engine.metrics.reset()
        engine.logit_traces = {}
        outs, counts = _counted(f"paged phase {label}",
                                lambda: _staggered(engine, prompts, gens))
        return outs, counts, engine.drain_logit_traces()

    sync_engine.capture_logits = True
    want, _, want_logits = run(sync_engine, "dense-layout sync")
    assert sync_engine.metrics.n_merges >= 1

    def paged_engine(**kw):
        pol = ExecutionPolicy.for_arch(cfg, paging=paged(PAGE),
                                       execution=kw.pop("execution", "sync"))
        return Engine(model, params, max_len=9 * PAGE, max_slots=REQUESTS,
                      policy=pol, **kw)

    # A: no prefix index (capture on), so no page is ever copied
    a = paged_engine(capture_logits=True, prefix_cache=False)
    got, counts_a, logits = run(a, "paged")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y, err_msg="paged vs dense")
    for tx, ty in zip(logits, want_logits):
        assert all(np.array_equal(u, v) for u, v in zip(tx, ty)), (
            "paged logits differ from the dense layout's")
    ma = a.metrics
    assert ma.n_page_moves == 0 and ma.n_merges >= 1, (ma.n_page_moves,
                                                       ma.n_merges)
    assert counts_a["ftp_bsr_tc"] == counts_a["ftp_bsr"] > 0, counts_a
    pool = a.store.summary()
    assert pool["seq_pages_free"] == pool["seq_pages_total"], pool
    del a
    # B: the prefix index on.  The same schedule again: every prompt is a
    # hit, admitted at the step and batch shape of its cold prefill, so
    # every decode sees the shapes of the cold run and the tokens must equal
    # it bit for bit (the projections' GEMMs need not be batch-invariant)
    b = paged_engine()
    got_b, counts_b, _ = run(b, "paged + prefix index")
    for x, y in zip(got_b, want):
        np.testing.assert_array_equal(x, y, err_msg="paged+index vs dense")
    prefills = b.metrics.n_prefill_batches
    again, counts_hits, _ = run(b, "prefix-hit resubmission")
    m = b.metrics
    assert m.n_prefill_batches == 0 and m.n_prefix_hits == len(prompts), (
        m.n_prefill_batches, m.n_prefix_hits)
    assert m.n_prefix_tokens_reused == sum(len(p) for p in prompts)
    for x, y in zip(again, want):
        np.testing.assert_array_equal(x, y, err_msg="prefix hit vs cold")
    index = b.prefix_index.summary()
    moves_b = m.n_page_moves
    del b
    # C: paged + pipelined (+ the index)
    c = paged_engine(execution="pipelined")
    got_c, counts_c, _ = run(c, "paged + pipelined")
    for x, y in zip(got_c, want):
        np.testing.assert_array_equal(x, y, err_msg="paged+pipelined vs dense")
    del c
    torch.cuda.empty_cache()
    out = {"requests": len(prompts), "merges": ma.n_merges,
           "page_moves_no_index": ma.n_page_moves,
           "page_moves_with_index": moves_b, "prefix_hits": len(prompts),
           "prefills_before_hits": prefills,
           "prefix_index": index,
           "launches": {"paged": counts_a, "paged_index": counts_b,
                        "prefix_hits": counts_hits, "paged_pipelined": counts_c}}
    log(f"10d paged (page_size {PAGE}, max_len {9 * PAGE}): {len(prompts)} "
        f"staggered requests in two waves, {ma.n_merges} merge(s): tokens and "
        f"logits equal to the dense layout's bit for bit, 0 page moves, every "
        f"page back in the pool; with the prefix index the schedule again: "
        f"{len(prompts)} of {len(prompts)} prefix hits, no prefill (the cold "
        f"run had {prefills}), the same tokens ({moves_b} page copies: "
        f"copy-on-write of the tail pages); paged + pipelined the same tokens")
    return out


def _alternate(engines, prompts):
    """TIMED_SERVES serves of each engine in turns, no logit capture; per
    label the summaries and the median-throughput one."""
    runs = {label: [] for label in engines}
    for _ in range(TIMED_SERVES):
        for label, engine in engines.items():
            engine.capture_logits = False
            engine.metrics.reset()
            engine.generate_batch(prompts, GEN)
            runs[label].append(engine.summary())
    out = {}
    for label, timed in runs.items():
        tok_s = [t["throughput_tok_s"] for t in timed]
        best = timed[tok_s.index(statistics.median_low(tok_s))]
        out[label] = {"timed": timed, "median": best}
        log(f"10c {label}: tok/s {[round(x, 1) for x in tok_s]}, TTFT p50 ms "
            f"{[round(t['ttft_s_p50'] * 1e3, 1) for t in timed]}, decode stage "
            f"ms per step {[round(t['stage_s']['decode'] * 1e3 / (GEN - 1), 2) for t in timed]}; "
            f"median run {best['wall_s']:.3f}s wall, stages "
            f"{json.dumps(best['stage_s'])}")
    return out


def phase_features(dual, dense):
    """Phase 10 on phase 5's params and prompts: the pipelined executor
    against the sync serves of phases 5 and 6, the host-wait check, sync
    and pipelined timed in turns, and the paged cache with prefix reuse."""
    import torch

    from repro_torch.serve import Engine, ExecutionPolicy

    model, params, prompts = dual["model"], dual["params"], dual["prompts"]
    cfg = model.cfg
    t0 = time.perf_counter()
    res = {}
    # 10a: pipelined, both weight routes, bitwise against phases 5 and 6
    pipes = {}
    for route, expect, ref in (
            ("dual-sparse", {"ftp_bsr": 2, "ftp_bsr_tc": 2}, dual),
            ("dense-weight", {"ftp_spmm": 1, "ftp_spmm_fused_lif": 1,
                              "ftp_dense_tc": 2}, dense)):
        pol = ExecutionPolicy.for_arch(
            cfg, execution="pipelined",
            weight_sparsity="dense" if route == "dense-weight" else None)
        engine = Engine(model, params, max_len=PROMPT + GEN, max_slots=REQUESTS,
                        policy=pol, pipeline_depth=2)
        engine.generate_batch([prompts[0][:8]], 2)  # warm-up
        outs, got, counts = _feature_serve(engine, prompts,
                                           f"10a pipelined {route}", expect)
        _bitwise(f"pipelined {route}", outs, got, ref["outs"], ref["logits"])
        n = sum(counts[k] for k in expect if not k.endswith("_tc"))
        tc = counts["ftp_bsr_tc" if route == "dual-sparse" else "ftp_dense_tc"]
        assert n == tc == 2 * cfg.n_layers * GEN, counts
        log(f"10a pipelined {route} (depth 2): tokens and all {REQUESTS} x {GEN} "
            f"logit vectors equal to the sync serve's bit for bit; {n} kernel "
            f"launches, all {tc} through the tensor-core instance")
        res[f"pipelined_{route}"] = {"launches": counts}
        pipes[route] = engine
    del pipes["dense-weight"]
    torch.cuda.empty_cache()
    pipe = pipes.pop("dual-sparse")
    # 10b: no host wait in the decode and encode stages
    n = _check_no_host_sync(pipe, prompts)
    log(f"10b no host sync: {n} pipelined decode dispatches (+ their token and "
        f"logit copies) and {n} encodes ran under set_sync_debug_mode('error'), "
        f"which raised on a pageable host-to-device copy and on a device-to-"
        f"host read (its controls)")
    res["no_host_sync_decodes"] = n
    # 10c: sync and pipelined in turns, then one profiled serve of each
    sync = dual["engine"]
    timed = _alternate({"sync": sync, "pipelined": pipe}, prompts)
    for label, engine in (("sync", sync), ("pipelined", pipe)):
        timed[label]["profile"] = _profile(engine, prompts,
                                           timed[label]["median"]["wall_s"])
    res["timing"] = {k: {"tok_s": v["median"]["throughput_tok_s"],
                         "ttft_s_p50": v["median"]["ttft_s_p50"],
                         "wall_s": v["median"]["wall_s"],
                         "stage_s": v["median"]["stage_s"],
                         "tok_s_runs": [t["throughput_tok_s"] for t in v["timed"]],
                         "profile": v["profile"]}
                     for k, v in timed.items()}
    del pipe
    torch.cuda.empty_cache()
    # 10d: paged, staggered, prefix hits
    res["paged"] = _paged_phase(dual, sync)
    log(f"phase 10 in {time.perf_counter() - t0:.1f}s: "
        f"{json.dumps(res, default=str)}")
    return res


# ---------------------------------------------------------------------------
# phase 11: decode windows (row invariance, speculative decoding, streams)
# ---------------------------------------------------------------------------

SPEC_K = 4
# 128 prompt + 16 generated + the k positions a verify window may pass a
# row's budget by, rounded up to whole pages of PAGE
SPEC_MAX_LEN = 160
# A row's logits computed inside a wider window against the row alone, where
# the library's products are not row-invariant: the FTP gate's scale, well
# inside the LOGIT_TOL the served logits meet against the CPU.
WINDOW_LOGIT_TOL = 1e-2
STREAM_FRAMES, STREAM_WINDOW_US, SENSOR = 120, 1000, 16
# the library products and reductions of one forward, in call order per
# layer, and the FTP kernels of its FFN
PROJECTIONS = ("q projection", "k projection", "v projection", "o projection")
KERNEL_ROWS = ("kernel 3 ftp_bsr", "kernel 2 ftp_spmm_fused_lif",
               "kernel 1 ftp_spmm")


def _log_ops(fn):
    """Run ``fn`` with every matmul, einsum, softmax and mean it calls
    logged in order (torch function mode: the model code is untouched),
    each `layers.row_blocks` call logged as one op (not the blocks inside
    it), and every BSR kernel call recorded; returns (result, ops, calls)."""
    import torch
    from torch.overrides import TorchFunctionMode

    from repro_torch.models import layers, transformer

    names = {torch.Tensor.__matmul__: "matmul", torch.Tensor.matmul: "matmul",
             torch.matmul: "matmul",
             torch.einsum: "einsum", torch.softmax: "softmax",
             torch.Tensor.softmax: "softmax", torch.Tensor.mean: "mean"}
    ops, inside = [], [0]

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in names and not inside[0]:
                ops.append((names[func], func, args, kwargs))
            return func(*args, **kwargs)

    blocks = layers.row_blocks

    def logged(*args):
        ops.append(("rows", blocks, args, {}))
        inside[0] += 1
        try:
            return blocks(*args)
        finally:
            inside[0] -= 1

    calls, restore = _record(["ftp_spmm_bsr"])
    layers.row_blocks = transformer.row_blocks = logged
    try:
        with torch.no_grad(), Mode():
            out = fn()
    finally:
        layers.row_blocks = transformer.row_blocks = blocks
        restore()
    torch.cuda.synchronize()
    return out, ops, calls


def _label_ops(ops, params, n_layers):
    """Name each logged op of the model's forward: row-blocked ops by their
    function and weight (each layer's q, k, v and o projections, the
    rmsnorms' row mean, the unembed), einsums by their equation, means by
    their axis (the FFN's rate decode over T).  Ops of other code (a plain
    kernel version on the CPU) get None."""
    import torch

    from repro_torch.models import layers

    weights = {id(params["unembed"]): "unembed"}
    for lp in params["layers"]:
        for w, name in zip(("wq", "wk", "wv", "wo"), PROJECTIONS):
            weights[id(lp["attn"][w])] = name
    einsums = {"bqkgd,bskd->bkgqs": "scores einsum",
               "bkgqs,bskd->bqkgd": "values einsum"}
    labels = []
    for kind, _, args, kwargs in ops:
        if kind == "rows":
            labels.append("rmsnorm mean" if args[0] is layers._mean_square
                          else weights.get(id(args[2]))
                          if args[0] in (torch.matmul, layers._vocab_mm)
                          else None)
        elif kind == "einsum":
            labels.append(einsums.get(args[0]))
        elif kind == "softmax":
            labels.append("softmax")
        elif kind == "mean":
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            labels.append({0: "rate_decode mean"}.get(dim))
        else:
            labels.append(None)
    n = sum(lb in PROJECTIONS for lb in labels)
    assert n == 4 * n_layers and labels.count("unembed") == 1, labels
    assert labels.count("rmsnorm mean") == 2 * n_layers + 1, labels
    return labels


# the ops whose operand is (B * S, D) rows: the row-blocked ones, operand 1
ROW_OPS = PROJECTIONS + ("unembed", "rmsnorm mean")


def _put_row(label, big, one, B, S, Bo):
    """``big``'s operands (B batch rows of S positions) with the ``Bo``
    batch rows of an S = 1 dispatch written at sequence index 0 of its
    first ``Bo`` batch rows (and its k/v, for the einsums)."""
    a = list(big)
    if label in ROW_OPS:
        x = a[1].clone()
        x.view(B, S, -1)[:Bo, 0] = one[1].view(Bo, 1, -1)[:, 0]
        a[1] = x
    elif label in ("scores einsum", "values einsum"):
        # the attention operands' batch is padded to B_BLOCK rows: the
        # S = 1 dispatch's first Bo are its real ones
        x, kv = a[1].clone(), a[2].clone()
        if label == "scores einsum":      # q (B, S, KV, G, dh)
            x[:Bo, 0] = one[1][:Bo, 0]
        else:                             # p (B, KV, G, S, Skv)
            x[:Bo, ..., 0, :] = one[1][:Bo, ..., 0, :]
        kv[:Bo] = one[2][:Bo]
        a[1], a[2] = x, kv
    elif label == "softmax":              # scores (B, KV, G, S, Skv)
        x = a[0].clone()
        x[:Bo, ..., 0, :] = one[0][:Bo, ..., 0, :]
        a[0] = x
    else:                                 # rate decode: (T, B * S, D)
        x = a[0].clone()
        Tn = x.shape[0]
        x.view(Tn, B, S, -1)[:, :Bo, 0] = one[0].view(Tn, Bo, 1, -1)[:, :, 0]
        a[0] = x
    return a


def _pick_row(label, out, B, S, Bo):
    """The first ``Bo`` batch rows at sequence index 0 of an op's output."""
    if label in ROW_OPS or label == "rate_decode mean":
        return out.reshape(B, S, -1)[:Bo, 0]
    if label in ("scores einsum", "softmax"):
        return out[:Bo, ..., 0, :]
    return out[:Bo, 0]                    # values einsum


def _count(rows, got, want):
    """Accumulate (elements, differing elements, max |difference|)."""
    d = got.float() - want.float() if got.is_floating_point() else None
    differ = got != want
    r = rows.setdefault("n", [0, 0, 0.0])
    r[0] += differ.numel()
    r[1] += int(differ.sum())
    if d is not None:
        r[2] = max(r[2], float(d.abs().max()))
    elif bool(differ.any()):
        r[2] = float("inf")


def _first_blocks(labels):
    """Indices of the ops to compare: every op, but of an attention call's
    query blocks only the first (a prefill runs several, a decode one)."""
    keep, seen = [], set()
    for i, label in enumerate(labels):
        if label == "q projection":
            seen = set()
        if label in ("scores einsum", "softmax", "values einsum"):
            if label in seen:
                continue
            seen.add(label)
        keep.append(i)
    return keep


def _plain(label, func, args, kw, S, B):
    """The library's own call for a logged op of the serving path: a
    row-blocked op on its whole operand, an attention op on its ``B`` real
    batch rows and ``S`` real query rows alone (without the serving path's
    batch and query blocks)."""
    a = list(args)
    if label in ROW_OPS:
        return a[0](*a[1:])
    if label == "scores einsum":
        a[1], a[2] = a[1][:B, :S], a[2][:B]
    elif label == "values einsum":
        a[1], a[2] = a[1][:B, ..., :S, :], a[2][:B]
    elif label == "softmax":
        a[0] = a[0][:B, ..., :S, :]
    return func(*a, **kw)


def _compare(res, col, labels, ops_1, calls_1, ops_c, calls_c, params, cfg,
             B, S, Bo):
    """Every op and FFN kernel call of one capture (B batch rows, S
    positions) against the S = 1 capture of its first ``Bo`` batch rows,
    on the S = 1 capture's inputs: the serving path's calls (column
    ``col``), and the library's own calls of the same products
    (``library col``; the attention ops over the real rows of the first
    query block, at most Q_BLOCK of a prefill)."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import Q_BLOCK
    from repro_torch.serve.policy import PACKED_DENSE, PACKED_DUAL

    labels_c = _label_ops(ops_c, params, cfg.n_layers)
    keep_1, keep_c = _first_blocks(labels), _first_blocks(labels_c)
    assert [labels[i] for i in keep_1] == [labels_c[i] for i in keep_c]
    for i, j in zip(keep_1, keep_c):
        label, one, big = labels[i], ops_1[i], ops_c[j]
        if label is None:
            continue
        _, func, a1, kw = one
        # rows per batch row of this op (a prefill unembeds its last
        # position alone: M = B there)
        So = big[2][1].shape[0] // B if label in ROW_OPS else S
        ab = _put_row(label, big[2], a1, B, So, Bo)
        want = _pick_row(label, func(*a1, **kw), Bo, 1, Bo)
        got = _pick_row(label, func(*ab, **kw), B, So, Bo)
        _count(res.setdefault(label, {}).setdefault(col, {}), got, want)
        want = _pick_row(label, _plain(label, func, a1, kw, 1, Bo), Bo, 1, Bo)
        got = _pick_row(label, _plain(label, func, ab, kw, min(S, Q_BLOCK), B),
                        B, So, Bo)
        _count(res[label].setdefault(f"library {col}", {}), got, want)
    # the FFN's kernels on the same words: W_in then W_out, per layer
    assert len(calls_c) == len(calls_1) == 2 * cfg.n_layers
    for n, (c1, cb) in enumerate(zip(calls_1, calls_c)):
        mlp = params["layers"][n // 2]["mlp"]
        fuse = n % 2 == 0
        a1 = c1[1][0]
        ab = cb[1][0].clone()
        ab.view(B, S, -1)[:Bo, 0] = a1
        routes = [(KERNEL_ROWS[0], lambda a: ops.dispatch(
            a, mlp["plan_in" if fuse else "plan_out"], PACKED_DUAL,
            cfg.spiking_T, fuse_lif=fuse,
            n_out=(cfg.d_ff if fuse else cfg.d_model)))]
        routes.append((KERNEL_ROWS[1] if fuse else KERNEL_ROWS[2],
                       lambda a: ops.dispatch(
                           a, mlp["wu" if fuse else "wd"], PACKED_DENSE,
                           cfg.spiking_T, fuse_lif=fuse)))
        for label, run in routes:
            # fused: (words, U); W_out: the full sums (kernel 3 also
            # returns a zero U)
            o1, ob = run(a1), run(ab)
            o1 = o1 if isinstance(o1, tuple) else (o1,)
            ob = ob if isinstance(ob, tuple) else (ob,)
            for x1, xb in zip(o1, ob) if fuse else [(o1[0], ob[0])]:
                if x1.ndim == 3:              # (T, M, N) full sums
                    got = xb.view(xb.shape[0], B, S, -1)[:, :Bo, 0]
                else:                         # (M, N) words or U
                    got = xb.view(B, S, -1)[:Bo, 0]
                _count(res.setdefault(label, {}).setdefault(col, {}),
                       got, x1)


def _invariance(engine, prompt, window, batch_columns=True):
    """Row invariance of one forward's products at full width: the rows of
    an S = 1 decode (its own captured inputs) against the same rows placed
    inside a prefill of ``prompt``, inside every decode window S = 2 ..
    ``window.shape[1]`` (a speculative round verifies k + 1 positions, or
    fewer where a row's budget ends), and (``batch_columns``) a row alone
    or in a batch of 2 .. B - 1 rows against the same row in the batch of B
    (rows retire at different steps with and without speculation).  For each
    product, the count of differing elements and the largest absolute
    difference; the FTP kernels (3 through the plans, 2 and 1 through the
    dense bf16 weights on the same words) must give 0."""
    import torch

    model, params, cfg = engine.model, engine.params, engine.cfg
    dev = engine.device
    B, P = prompt.shape
    toks = torch.as_tensor(prompt, device=dev).long()
    win = torch.as_tensor(window, device=dev).long()
    cache = model.init_cache(B, engine.max_len, device=dev)
    (_, cache), ops_p, calls_p = _log_ops(lambda: model.prefill(
        params, {"tokens": toks}, cache, spiking_mode="infer"))

    def decode(rows, S):
        c = {k: (v[:, :rows].clone() if k in ("k", "v")
                 else v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in cache.items()}
        _, o, cl = _log_ops(lambda: model.decode(
            params, win[:rows, :S], c, spiking_mode="infer"))
        return o, cl

    ops_1, calls_1 = decode(B, 1)
    labels = _label_ops(ops_1, params, cfg.n_layers)
    res = {}
    _compare(res, "prefill", labels, ops_1, calls_1, ops_p, calls_p, params,
             cfg, B, P, B)
    for S in range(2, win.shape[1] + 1):
        ops_w, calls_w = decode(B, S)
        _compare(res, f"window S={S}", labels, ops_1, calls_1, ops_w,
                 calls_w, params, cfg, B, S, B)
    if batch_columns:
        for rows in range(1, B):
            ops_r, calls_r = decode(rows, 1)
            _compare(res, f"batch {rows} in {B}", _label_ops(
                ops_r, params, cfg.n_layers), ops_r, calls_r, ops_1, calls_1,
                params, cfg, B, 1, rows)
    torch.cuda.synchronize()
    out = {label: {col: dict(zip(("elements", "differ", "max_abs"), v["n"]))
                   for col, v in cols.items()} for label, cols in res.items()}
    for label, cols in out.items():
        for kind, picked in (("serving", [c for c in cols
                                          if not c.startswith("library")]),
                             ("library", [c for c in cols
                                          if c.startswith("library")])):
            if picked:
                log(f"  {label:28s} {kind}: " + "; ".join(
                    f"{col.removeprefix('library ')}: {cols[col]['differ']}/"
                    f"{cols[col]['elements']} max {cols[col]['max_abs']:.2e}"
                    for col in picked))
    for label in KERNEL_ROWS:
        for col, c in out[label].items():
            assert c["differ"] == 0, (label, col, c)
    return out


def _form(inv, prefix):
    """The gate form the columns of the invariance measurement starting
    with ``prefix`` allow."""
    zero = all(c["differ"] == 0 for cols in inv.values()
               for col, c in cols.items() if col.startswith(prefix))
    return "bitwise" if zero else "tolerance"


def _drift(outs, logits, want_outs, want_logits):
    """Max |logit difference| up to and including each request's first
    differing token (the contexts differ after it), and those first
    differing tokens with the reference's top-two margin there."""
    import numpy as np

    toks, ref = np.stack(outs), np.stack(want_outs)
    assert toks.shape == ref.shape and logits.shape == want_logits.shape
    differ = toks != ref
    first = np.where(differ.any(1), differ.argmax(1), toks.shape[1] - 1)
    steps = np.arange(toks.shape[1])[None, :] <= first[:, None]
    drift = float(np.abs(logits - want_logits)[steps].max())
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    flips = [{"request": int(i), "step": int(first[i]),
              "margin": float(margin[i, first[i]])}
             for i in np.nonzero(differ.any(1))[0]]
    return drift, flips


def _plain_path_control(dual, prompts, float_draft):
    """11a's control: the float-draft speculative serve against the
    non-speculative one with the serving path's row and query blocks
    taken out (every product a plain library call).  Logged, not gated:
    what the blocks buy."""
    import torch

    from repro_torch.models import layers, transformer
    from repro_torch.serve import Engine, ExecutionPolicy

    model, params, cfg = dual["model"], dual["params"], dual["model"].cfg
    saved = layers.row_blocks, layers.Q_BLOCK

    def direct(fn, x, *args):
        return fn(x, *args)

    layers.row_blocks = transformer.row_blocks = direct
    layers.Q_BLOCK = None
    try:
        base = Engine(model, params, max_len=SPEC_MAX_LEN, max_slots=REQUESTS,
                      policy=ExecutionPolicy.for_arch(cfg))
        want, want_logits, _, _ = _traced_serve(base, prompts,
                                                "11a control plain")
        del base
        spec = _spec_engine(model, params, cfg, float_draft)
        outs, got, _, _ = _traced_serve(spec, prompts, "11a control spec")
        del spec
    finally:
        layers.row_blocks = transformer.row_blocks = saved[0]
        layers.Q_BLOCK = saved[1]
        torch.cuda.empty_cache()
    drift, flips = _drift(outs, got, want, want_logits)
    log(f"11a control, the plain library ops: the speculative serve's max "
        f"|logit drift| {drift:.3e} from the non-speculative one, "
        f"{len(flips)} token flips {flips}")
    return {"drift": drift, "flips": flips}


def _gate(label, form, outs, logits, want_outs, want_logits):
    """A windowed serve (speculative verify, or a stream's frame-by-frame
    ingest) against the single-position serve of the same call.  ``bitwise``
    (every product of the window row-invariant): tokens and every logit
    vector equal.  ``tolerance``: logits within WINDOW_LOGIT_TOL up to and
    including each request's first differing token (the contexts differ
    after it), and that token only at a near tie: the single-position
    serve's top two logits within 2 x the measured drift (each of the two
    can move by it).  Returns the drift and the flips with their margins."""
    import numpy as np

    drift, flips = _drift(outs, logits, want_outs, want_logits)
    if form == "bitwise":
        assert not flips, f"{label}: {flips}"
        assert np.array_equal(logits, want_logits), (
            f"{label}: {int((logits != want_logits).sum())} logits differ")
    else:
        assert drift <= WINDOW_LOGIT_TOL, f"{label}: drift {drift:.3e}"
        for f in flips:
            assert f["margin"] <= 2 * drift, f"{label}: flip away from a tie {f}"
    log(f"{label}: gate {form}: max |logit drift| {drift:.3e}, "
        f"{len(flips)} near-tie flips {flips}")
    return {"form": form, "drift": drift, "flips": flips}


def _traced_serve(engine, prompts, label, gen=GEN):
    """A counted serve with logits captured: (tokens, (B, gen, V) logits,
    launch counts, recorded BSR calls)."""
    import numpy as np

    engine.metrics.reset()
    engine.logit_traces = {}
    engine.capture_logits = True
    calls, restore = _record(["ftp_spmm_bsr"])
    try:
        outs, counts = _counted(f"{label} serve",
                                lambda: engine.generate_batch(prompts, gen))
    finally:
        restore()
    traces = engine.drain_logit_traces()
    got = np.stack([np.stack(t) for t in traces])
    assert got.shape == (len(prompts), gen, engine.cfg.vocab), got.shape
    return outs, got, counts, calls


def _spec_engine(model, params, cfg, draft_policy, **kw):
    from repro_torch.serve import Engine, ExecutionPolicy, draft

    spec = draft(draft_policy, SPEC_K,
                 draft_weight_density=kw.pop("draft_weight_density", None))
    pol = ExecutionPolicy.for_arch(cfg, speculation=spec,
                                   execution=kw.pop("execution", "sync"),
                                   paging=kw.pop("paging", None))
    return Engine(model, params, max_len=SPEC_MAX_LEN, max_slots=REQUESTS,
                  policy=pol, **kw)


def _split_calls(engine, calls):
    """Split recorded BSR calls into the target's and the draft's: a draft
    call joins against the draft's own plans, or carries its timestep gate
    (the target's FFNs walk every plane)."""
    target = {p.payload.data_ptr() for lp in engine.params["layers"]
              for p in (lp["mlp"]["plan_in"], lp["mlp"]["plan_out"])}

    def is_target(c):
        return c[1][1].data_ptr() in target and c[2].get("tmap") is None

    return ([c for c in calls if is_target(c)],
            [c for c in calls if not is_target(c)])


def _parity_all(calls, label):
    """Every recorded BSR call against its plain version (both instances),
    within the FTP gate; returns (max abs error, spike-word flips)."""
    worst = (0.0, 0)
    for n, (_, args, kw) in enumerate(calls):
        err, flips = _parity(f"{label} call {n}", args[:8], kw["bm"],
                             kw["fuse_lif"], kw.get("tmap"))
        worst = (max(worst[0], err), worst[1] + flips)
    return worst


def _sample(calls, per_group=16):
    """At most ``per_group`` calls of each (M, fuse_lif) group, for timing."""
    seen, out = {}, []
    for c in calls:
        key = (c[1][0].shape[0], c[2]["fuse_lif"])
        seen[key] = seen.get(key, 0) + 1
        if seen[key] <= per_group:
            out.append(c)
    return out


def _perturb_proposals(engine):
    """Make the engine's draft adversarially wrong: in round r, proposals
    from position r % k on are shifted by one token (on the device, no
    read), so every live row accepts exactly r % k of them.  Every emitted
    token is still the target's argmax.  Returns the undo."""
    import torch

    propose, vocab, rounds = engine.dispatch_propose, engine.cfg.vocab, [0]

    def perturbed(chunk, cache, k):
        toks, cache = propose(chunk, cache, k)
        j = rounds[0] % k
        rounds[0] += 1
        toks = torch.cat([toks[:, :j], torch.remainder(toks[:, j:] + 1, vocab)],
                         dim=1)
        return toks, cache

    engine.dispatch_propose = perturbed
    return lambda: delattr(engine, "dispatch_propose")


def _rewind_exact(model, params, cfg, draft_policy, prompts, **kw):
    """After a speculative round that rejected proposals (the draft's
    proposals perturbed), the cohort's position locals equal, bit for bit,
    those of a cohort that never speculated at the same length."""
    import torch

    from repro_torch.serve import Engine, ExecutionPolicy

    spec = _spec_engine(model, params, cfg, draft_policy, **kw)
    _perturb_proposals(spec)
    for p in prompts:
        spec.submit(p, GEN)
    spec.step()  # the prefill and one round, every proposal rejected
    assert spec.metrics.n_tokens_rejected > 0, spec.summary()
    cohort = spec.cohorts[0]
    ref = Engine(model, params, max_len=SPEC_MAX_LEN, max_slots=REQUESTS,
                 policy=ExecutionPolicy.for_arch(cfg))
    for p in prompts:
        ref.submit(p, GEN)
    ref.step()
    while ref.cohorts[0].length < cohort.length:
        ref.step()
    rc = ref.cohorts[0]
    assert rc.length == cohort.length
    assert cohort.cache["pos"] == rc.cache["pos"] == cohort.length
    assert torch.equal(cohort.cache["kv_pos"], rc.cache["kv_pos"])
    out = {"length": cohort.length,
           "rounds": spec.metrics.n_speculative_rounds,
           "rejected": spec.metrics.n_tokens_rejected}
    log(f"11b rewind: after {out['rounds']} round(s) with perturbed "
        f"proposals ({out['rejected']} rejected) the cohort's pos and kv_pos "
        f"at length {out['length']} equal a cohort that never speculated, "
        "bit for bit")
    return out


def _spec_summary(s):
    return {k: s[k] for k in ("speculative_rounds", "draft_batches",
                              "draft_prefills", "tokens_proposed",
                              "tokens_accepted", "tokens_rejected",
                              "acceptance_rate", "decode_batches",
                              "prefill_batches")}


def _check_round_no_host_sync(engine, prompts):
    """A speculative serve with `dispatch_propose`, the verify
    `dispatch_decode` and `rewind_cache` run under
    set_sync_debug_mode("error"): none waits for the device (the round's
    host read is its sample_sync copy).  Control: a device read inside the
    propose raises."""
    import torch

    seen = {}

    def strict(name, fn, read=False):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
                if read:
                    out[0].cpu()
                return out
            finally:
                torch.cuda.set_sync_debug_mode("default")
                seen[name] = seen.get(name, 0) + 1
        return run

    names = ("dispatch_propose", "dispatch_decode", "rewind_cache")
    engine.capture_logits = False
    for name in names:
        setattr(engine, name, strict(name, getattr(engine, name)))
    try:
        engine.metrics.reset()
        engine.generate_batch(prompts, GEN)
        torch.cuda.synchronize()
        assert all(seen.get(n, 0) > 0 for n in names), seen
        engine.dispatch_propose = strict(
            "control", type(engine).dispatch_propose.__get__(engine), read=True)
        try:
            engine.generate_batch(prompts[:1], 4)
        except RuntimeError as e:
            assert "synchroniz" in str(e), e
        else:
            raise AssertionError("a device read inside the propose did not raise")
    finally:
        for name in names:
            delattr(engine, name)
        torch.cuda.set_sync_debug_mode("default")
        engine.cohorts, engine.scheduler.active_slots = [], 0
    log(f"11d no host sync: {seen['dispatch_propose']} proposes, "
        f"{seen['dispatch_decode']} verify/decode dispatches and "
        f"{seen['rewind_cache']} rewinds ran under set_sync_debug_mode('error');"
        " a device read inside the propose raised (the control)")
    return {k: v for k, v in seen.items() if k != "control"}


def _stream_prompt(cfg):
    """The stream's events, window by window, and its frame tokens (from a
    session run on the host alone: encoding is deterministic)."""
    from repro_torch.data.events import moving_blob_events, split_into_windows
    from repro_torch.serve import EventStream, StreamSession

    events = moving_blob_events(STREAM_FRAMES, height=SENSOR, width=SENSOR,
                                window_us=STREAM_WINDOW_US, seed=SEED)
    chunks = split_into_windows(events, STREAM_FRAMES, STREAM_WINDOW_US)
    stream = EventStream(STREAM_WINDOW_US)
    session = StreamSession(stream, height=SENSOR, width=SENSOR,
                            T=cfg.spiking_T, vocab=cfg.vocab)
    for c in chunks:
        stream.push(c)
        session.poll()
    stream.close()
    session.poll()
    prompt = session.prompt_tokens()
    assert prompt.shape == (STREAM_FRAMES,)
    return chunks, prompt


def _drive_stream(engine, chunks, cfg):
    """One session fed one window per `engine.step()`, closed, drained;
    returns (tokens, session)."""
    from repro_torch.serve import EventStream, StreamSession

    stream = EventStream(STREAM_WINDOW_US)
    session = StreamSession(stream, height=SENSOR, width=SENSOR,
                            T=cfg.spiking_T, vocab=cfg.vocab)
    ticket = engine.submit_stream(session, GEN)
    for c in chunks:
        stream.push(c)
        engine.step()
    stream.close()
    return engine.run()[ticket.rid], session


def _stream_phase(dual, form, chunks, prompt):
    """11e: the stream frame by frame against its frame tokens as one
    prompt, under {sync, pipelined} x {dense, paged} x {full, adaptive}."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine, ExecutionPolicy, adaptive_t, paged

    model, params, cfg = dual["model"], dual["params"], dual["model"].cfg
    max_len = 9 * PAGE
    assert STREAM_FRAMES + GEN <= max_len
    mono = Engine(model, params, max_len=max_len, max_slots=1,
                  policy=ExecutionPolicy.for_arch(cfg))
    want, want_logits, _, _ = _traced_serve(mono, [prompt], "11e monolithic")
    del mono
    cells = {}
    for execution in ("sync", "pipelined"):
        for paging in (None, paged(PAGE)):
            for temporal in (None, adaptive_t()):
                label = (f"11e stream {execution} "
                         f"{'paged' if paging else 'dense'} "
                         f"{'adaptive' if temporal else 'full'}")
                engine = Engine(model, params, max_len=max_len, max_slots=1,
                                capture_logits=True,
                                policy=ExecutionPolicy.for_arch(
                                    cfg, execution=execution, paging=paging,
                                    temporal=temporal))
                (got, session), counts = _counted(
                    label, lambda: _drive_stream(engine, chunks, cfg))
                np.testing.assert_array_equal(session.prompt_tokens(), prompt)
                logits = np.stack(engine.drain_logit_traces()[0])[None]
                res = _gate(label, form, [got], logits, want, want_logits)
                s = engine.summary()
                assert s["stream_windows"] == STREAM_FRAMES, s["stream_windows"]
                assert counts["ftp_bsr_tc"] == counts["ftp_bsr"] > 0, counts
                if temporal is not None:
                    assert s["timesteps_skipped"] >= 0
                res.update(ftt_p50_s=s["frame_to_first_token_s_p50"],
                           ftt_p99_s=s["frame_to_first_token_s_p99"],
                           launches=counts["ftp_bsr"],
                           ingest_s=s["stage_s"].get("ingest"))
                log(f"{label}: frame-to-first-token p50 "
                    f"{res['ftt_p50_s'] * 1e3:.1f} ms, p99 "
                    f"{res['ftt_p99_s'] * 1e3:.1f} ms over {STREAM_FRAMES} "
                    f"frames; {counts['ftp_bsr']} kernel 3 launches")
                cells[label] = res
                del engine
                torch.cuda.empty_cache()
    return cells


def phase_windows(dual):
    """Phase 11 on phase 5's params and prompts: row invariance of the
    window path (a), speculative serves against the non-speculative serve
    (b), packed drafts (c), timing and host waits (d), streams (e)."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine, ExecutionPolicy, adaptive_t, approximate, paged

    model, params, prompts = dual["model"], dual["params"], dual["prompts"]
    cfg = model.cfg
    t0 = time.perf_counter()
    res = {}
    # 11a: row invariance, B = 4, k = 4, a 128-token prefill; and at the
    # stream's shapes (B = 1, a prefill of its 120 frame tokens)
    log(f"11a row invariance, B={REQUESTS}, S=1 vs S={SPEC_K + 1} window vs "
        f"a {PROMPT}-token prefill (same rows, same inputs):")
    inv = _invariance(dual["engine"], np.stack(prompts),
                      np.stack(dual["outs"])[:, : SPEC_K + 1])
    chunks, sprompt = _stream_prompt(cfg)
    log(f"11a row invariance at the stream's shapes, B=1, S=1 vs a "
        f"{STREAM_FRAMES}-token prefill:")
    inv_stream = _invariance(dual["engine"], sprompt[None], sprompt[None, :1],
                             batch_columns=False)
    # speculation: every window width and batch size its rounds run; a
    # stream: its prefill against one frame at a time
    forms = {"window": ("bitwise" if _form(inv, "window") == _form(inv, "batch")
                        == "bitwise" else "tolerance"),
             "stream": _form(inv_stream, "prefill")}
    log(f"11a gate forms: {forms}")
    res["invariance"] = {"spec": inv, "stream": inv_stream, "forms": forms}
    float_draft = ExecutionPolicy.for_arch(cfg, spike_format="float",
                                           weight_sparsity="dense")
    res["plain_path_control"] = _plain_path_control(dual, prompts, float_draft)
    # 11b: the non-speculative serve at the speculative geometry, then the
    # float draft under {sync, pipelined} x {dense, paged}
    base = Engine(model, params, max_len=SPEC_MAX_LEN, max_slots=REQUESTS,
                  policy=ExecutionPolicy.for_arch(cfg))
    want, want_logits, _, _ = _traced_serve(base, prompts, "11b baseline")
    geo = float(np.abs(want_logits - dual["logits"]).max())
    same = all(np.array_equal(a, b) for a, b in zip(want, dual["outs"]))
    log(f"11b baseline (max_len {SPEC_MAX_LEN}) vs phase 5 (max_len "
        f"{PROMPT + GEN}): tokens equal {same}, max |logit diff| {geo:.3e}")
    res["baseline_vs_phase5"] = {"tokens_equal": same, "max_logit_diff": geo}
    spec_calls = None
    res["spec"] = {}
    for execution in ("sync", "pipelined"):
        for paging in (None, paged(PAGE)):
            label = f"11b spec {execution} {'paged' if paging else 'dense'}"
            engine = _spec_engine(model, params, cfg, float_draft,
                                  execution=execution, paging=paging)
            outs, got, counts, calls = _traced_serve(engine, prompts, label)
            gate = _gate(label, forms["window"], outs, got, want, want_logits)
            s = engine.summary()
            assert s["speculative_rounds"] > 0, s
            assert s["tokens_proposed"] == s["tokens_accepted"] + s["tokens_rejected"]
            forwards = s["prefill_batches"] + s["decode_batches"]
            assert counts["ftp_bsr"] == counts["ftp_bsr_tc"] == \
                2 * cfg.n_layers * forwards, (counts, forwards)
            res["spec"][label] = dict(gate, **_spec_summary(s),
                                      launches=counts["ftp_bsr"])
            log(f"{label}: {json.dumps(_spec_summary(s))}; kernel 3 launches "
                f"{counts['ftp_bsr']} (2 x {cfg.n_layers} x {forwards} target "
                f"forwards; the float draft launches none)")
            if spec_calls is None:
                spec_calls = calls
            del engine
            torch.cuda.empty_cache()
    res["rewind"] = _rewind_exact(model, params, cfg, float_draft, prompts)
    # 11c: packed drafts, every launch of draft and verify replayed.  The
    # density-0.2 draft serves again with its proposals perturbed, so its
    # rounds reject (at these random weights the FFNs do not move the
    # argmax: a same-weights draft proposes the target's tokens)
    res["packed"] = {}
    for label, d_pol, kw in (
            ("11c draft density 0.2", ExecutionPolicy.for_arch(cfg),
             {"draft_weight_density": 0.2}),
            ("11c draft min_spikes 2",
             ExecutionPolicy.for_arch(cfg, temporal=adaptive_t(2),
                                      exactness=approximate(LOGIT_TOL)), {})):
        engine = _spec_engine(model, params, cfg, d_pol, **kw)
        outs, got, counts, calls = _traced_serve(engine, prompts, label)
        gate = _gate(label, forms["window"], outs, got, want, want_logits)
        s = engine.summary()
        target, drafted = _split_calls(engine, calls)
        assert counts["ftp_bsr_simt"] == 0 and drafted, counts
        if kw:
            assert counts["ftp_bsr"] == len(calls) and not counts["ftp_bsr_adaptive"]
        else:
            assert counts["ftp_bsr_adaptive"] == len(drafted) > 0, counts
            assert counts["ftp_bsr"] == len(target), counts
        log(f"{label}: {json.dumps(_spec_summary(s))}; launches {counts}: "
            f"{len(target)} target (prefill + verify windows), {len(drafted)} "
            f"draft")
        perturbed = None
        if kw:
            undo = _perturb_proposals(engine)
            p_label = f"{label} perturbed"
            p_outs, p_got, p_counts, p_calls = _traced_serve(engine, prompts,
                                                             p_label)
            undo()
            p_gate = _gate(p_label, forms["window"], p_outs, p_got, want,
                           want_logits)
            ps = engine.summary()
            assert ps["tokens_rejected"] > 0, ps
            assert p_counts["ftp_bsr"] == len(p_calls), p_counts
            log(f"{p_label}: {json.dumps(_spec_summary(ps))}; launches "
                f"{p_counts}")
            p_target, p_drafted = _split_calls(engine, p_calls)
            target, drafted = target + p_target, drafted + p_drafted
            perturbed = dict(p_gate, **_spec_summary(ps),
                             launches=p_counts["ftp_bsr"])
        err, flips = _parity_all(target + drafted, label)
        log(f"{label}: all {len(calls)} launches replayed against the plain "
            f"version (both instances): max |kernel - plain| {err:.3e}, "
            f"{flips} spike words flipped at the threshold")
        rows = (_replay(_sample(target), prefix=f"{label} target")
                + _replay(_sample(drafted), prefix=f"{label} draft"))
        res["packed"][label] = dict(gate, **_spec_summary(s), launches=counts,
                                    target_launches=len(target),
                                    draft_launches=len(drafted),
                                    max_abs_err=err, flips=flips, rows=rows,
                                    perturbed=perturbed)
        del engine, calls, target, drafted
        torch.cuda.empty_cache()
    # the float-draft serve's kernel calls (its prefill and verify windows,
    # M = B (k + 1)): held against the plain version, a sample timed
    err, flips = _parity_all(spec_calls, "11b verify")
    res["verify_rows"] = _replay(_sample(spec_calls), prefix="11b verify")
    res["verify_parity"] = {"launches": len(spec_calls), "max_abs_err": err,
                            "flips": flips}
    del spec_calls
    # 11d: spec vs non-spec in turns, one profiled serve each, host waits
    spec = _spec_engine(model, params, cfg, float_draft)
    timed = _alternate({"non-spec": base, "spec": spec}, prompts)
    res["timing"] = {}
    for label, engine in (("non-spec", base), ("spec", spec)):
        med = timed[label]["median"]
        prof = _profile(engine, prompts, med["wall_s"])
        res["timing"][label] = {
            "tok_s": med["throughput_tok_s"], "ttft_s_p50": med["ttft_s_p50"],
            "wall_s": med["wall_s"], "stage_s": med["stage_s"],
            "acceptance_rate": med["acceptance_rate"],
            "tok_s_runs": [t["throughput_tok_s"] for t in timed[label]["timed"]],
            "profile": prof}
    log(f"11d spec / non-spec tok/s: "
        f"{res['timing']['spec']['tok_s'] / res['timing']['non-spec']['tok_s']:.3f}"
        f" (acceptance {res['timing']['spec']['acceptance_rate']:.3f})")
    res["no_host_sync"] = _check_round_no_host_sync(spec, prompts)
    del spec, base
    torch.cuda.empty_cache()
    # 11e: streams
    res["stream"] = _stream_phase(dual, forms["stream"], chunks, sprompt)
    log(f"phase 11 in {time.perf_counter() - t0:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phase 12: the slice's path at full width (drain and handoff; the dense
# family)
# ---------------------------------------------------------------------------

P12_SLOTS = 4
# 8 requests of 128 prompt tokens, 16 generated, but two of the first wave
# stop at 4 and 6 tokens: when the notice lands after PREEMPT_AFTER steps,
# some requests are finished, some in flight and some still waiting
P12_GENS = (4, 16, 16, 6, 16, 16, 16, 16)
PREEMPT_AFTER, DRAIN_GRACE = 6, 2
# the card-vs-CPU check's requests: one of each admission wave (the first
# four, then the two admitted when requests 0 and 3 stop, then the last
# two), an early stopper among them
P12_CPU_REQUESTS = (0, 1, 5, 7)
QWEN_LAYERS = 2             # qwen3-14b's depth cut (40 at full depth)
# gemma-2b's depth cut (18 at full depth): phase 13 took the whole run past
# 800 s at full depth (929.1 s on one H100, PERF.md §6), and 6 layers past
# 1200 s on a slow host (its card-vs-CPU reference was 34 s of host work);
# every gate of 12a holds layer by layer, and its kernel times are per launch
GEMMA_LAYERS = 3


def _budget_serve(engine, prompts, gens, label):
    """A counted serve of each prompt under its own budget, logits
    captured and BSR calls recorded: (tokens, {rid: (gen, V) logits},
    launch counts, calls, rids), in submit order."""
    import numpy as np

    engine.metrics.reset()
    engine.logit_traces = {}
    engine.capture_logits = True
    calls, restore = _record(["ftp_spmm_bsr"])

    def run():
        tickets = [engine.submit(p, g) for p, g in zip(prompts, gens)]
        out = engine.run()
        return [out[t.rid] for t in tickets], [t.rid for t in tickets]

    try:
        (outs, rids), counts = _counted(f"{label} serve", run)
    finally:
        restore()
    traces = {r: np.stack(engine.logit_traces[r]) for r in rids}
    for o, g, r in zip(outs, gens, rids):
        assert len(o) == g and traces[r].shape == (g, engine.cfg.vocab), r
    return outs, traces, counts, calls, rids


def _all_tc(counts, per_forward, forwards, label):
    """Kernel 3 launched ``per_forward`` times a forward, every launch on
    its tensor-core instance, and no other FTP kernel."""
    n = per_forward * forwards
    assert counts["ftp_bsr"] == counts["ftp_bsr_tc"] == n, (label, counts, n)
    assert counts["ftp_bsr_simt"] == 0, (label, counts)
    for k in ("ftp_spmm", "ftp_spmm_fused_lif", "ftp_bsr_adaptive"):
        assert counts.get(k, 0) == 0, (label, counts)


def _hold_calls(calls, label, per_group=8):
    """Every recorded kernel-3 call against its plain version (both
    instances, the FTP gate), and a sample of each (M, fuse_lif) group
    timed against its bound, its plain version and the library matmul."""
    err, flips = _parity_all(calls, label)
    log(f"{label}: all {len(calls)} kernel 3 calls held against the plain "
        f"version: max_abs_err {err:.3e} (<= {TOL}), {flips} spike-word flips "
        "at the threshold")
    rows = _replay(_sample(calls, per_group), prefix=label)
    return {"launches": len(calls), "max_abs_err": err, "flips": flips,
            "rows": rows}


def _drain_cycle(model, params, cfg, prompts, base, execution, paging, tmp,
                 phase="12a", kernel3=True):
    """Serve ``prompts`` under the policy, deliver the preemption notice
    after PREEMPT_AFTER steps, drain within DRAIN_GRACE steps, save and load
    the handoff, resume a successor and run it: tokens and captured logits
    (the victim's for requests it finished, the successor's for the rest)
    against the undisturbed serve ``base``, bit for bit.  ``kernel3``: the
    successor's FFNs ran kernel 3 (else no FTP kernel ran)."""
    import numpy as np

    from repro_torch.ft import PreemptionHandler
    from repro_torch.serve import Engine, ExecutionPolicy, Handoff

    label = f"{phase} drain {execution} {'paged' if paging else 'dense'}"
    outs_b, traces_b, rids_b = base
    policy = ExecutionPolicy.for_arch(cfg, execution=execution, paging=paging)
    handler = PreemptionHandler(signals=())
    victim = Engine(model, params, max_len=PROMPT + GEN, max_slots=P12_SLOTS,
                    policy=policy, capture_logits=True, preemption=handler)
    tickets = [victim.submit(p, g) for p, g in zip(prompts, P12_GENS)]
    for _ in range(PREEMPT_AFTER):
        victim.step()
    handler.trigger()
    t0 = time.perf_counter()
    handoff = victim.drain(step_budget=DRAIN_GRACE)
    drain_s = time.perf_counter() - t0
    c = handoff.counts()
    assert c["waiting"] > 0 and c["inflight"] > 0 and c["finished"] > 0, c
    assert victim.scheduler._tickets == {} and not victim.cohorts
    finished = {r.rid for r in handoff.requests if r.state == "finished"}
    victim_traces = {r: np.stack(t) for r, t in victim.logit_traces.items()
                     if r in finished}
    handoff.save(tmp)
    loaded = Handoff.load(tmp)
    assert loaded.counts() == c
    del victim
    gc.collect()
    successor = Engine.resume(model, params, loaded, policy=policy,
                              capture_logits=True)
    inflight = {r.rid: r.generated for r in loaded.requests
                if r.state == "inflight"}
    # the ledger holds every in-flight request with its handed-off tokens
    assert set(successor._resume_expect) == set(inflight), (
        sorted(successor._resume_expect), sorted(inflight))
    for rid, gen in inflight.items():
        np.testing.assert_array_equal(successor._resume_expect[rid], gen)
    out, counts = _counted(f"{label} successor", successor.run)
    assert successor._resume_expect == {}
    if kernel3:
        assert counts["ftp_bsr"] == counts["ftp_bsr_tc"] > 0, counts
    else:
        assert not any(counts.values()), counts
    for t, want, rid in zip(tickets, outs_b, rids_b):
        np.testing.assert_array_equal(out[t.rid], want)
        got = (victim_traces[t.rid] if t.rid in finished
               else np.stack(successor.logit_traces[t.rid]))
        assert np.array_equal(got, traces_b[rid]), (
            f"{label}: request {t.rid}: "
            f"{int((got != traces_b[rid]).sum())} logits differ")
    log(f"{label}: notice after {PREEMPT_AFTER} steps, drained in "
        f"{drain_s:.3f}s within {DRAIN_GRACE} steps: {json.dumps(c)}; the "
        f"successor finished every request, tokens and {sum(P12_GENS)} logit "
        f"vectors equal to the undisturbed serve bit for bit; "
        f"{counts['ftp_bsr']} kernel 3 launches")
    del successor
    gc.collect()
    return {"counts": c, "drain_s": drain_s, "successor_launches": counts["ftp_bsr"]}


def _batch_block_cost(cfg, flush, reps=50):
    """The serving attention (`layers.multihead_attention` with ``q_block``)
    of one request alone (B = 1) at ``cfg``'s widths, as served (the batch
    zero-padded to `layers.B_BLOCK` rows) and with blocks of one row: the
    device time of a decode (Sq 1) and a prefill (Sq PROMPT) against a
    PROMPT + GEN cache, timed in turns in this call."""
    import torch

    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    H, KV, dh, skv = cfg.n_heads, cfg.n_kv, cfg.head_dim, PROMPT + GEN
    k, v = (torch.randn(1, skv, KV, dh, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    saved, out = layers.B_BLOCK, {}
    try:
        for name, sq, at in (("decode", 1, PROMPT + GEN - 2), ("prefill", PROMPT, 0)):
            q = torch.randn(1, sq, H, dh, generator=gen,
                            device="cuda").to(torch.bfloat16)
            kv_pos = torch.arange(skv, device="cuda")
            kv_pos = torch.where(kv_pos < at + sq, kv_pos, -1)

            def call():
                return layers.multihead_attention(
                    q, k, v, cfg, q_offset=at, kv_positions=kv_pos,
                    q_block=layers.Q_BLOCK)

            times = {saved: [], 1: []}
            for _ in range(2):          # served, one-row, one-row, served
                for b in ((saved, 1) if not times[1] else (1, saved)):
                    layers.B_BLOCK = b
                    times[b].append(_time_ms(call, reps, flush))
            out[name] = {"served_ms": statistics.mean(times[saved]),
                         "one_row_ms": statistics.mean(times[1])}
    finally:
        layers.B_BLOCK = saved
    log(f"{cfg.name} serving attention of one request (B 1): " + "; ".join(
        f"{n} {r['served_ms']:.4f} ms in blocks of {saved} rows, "
        f"{r['one_row_ms']:.4f} ms in blocks of 1"
        for n, r in out.items()) + " (device time per call and layer)")
    return out


def phase_handoff():
    """12a: gemma-2b at its published width (d_model 2048, 8 heads, MQA,
    head_dim 256, d_ff 16384, vocab 256000, tied embeddings), depth cut to
    GEMMA_LAYERS, with spiking FFNs at weight density 0.3 under
    PACKED_DUAL, served undisturbed, then drained after PREEMPT_AFTER steps
    and resumed under {sync, pipelined} x {dense, paged(16)}."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy, paged

    full = build_config("gemma_2b", smoke=False, spiking=True, weight_density=0.3)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv, full.head_dim,
            full.d_ff, full.vocab, full.tie_embeddings) == (
        18, 2048, 8, 1, 256, 16384, 256000, True)
    cfg = dataclasses.replace(full, n_layers=GEMMA_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    base = Engine(model, params, max_len=PROMPT + GEN, max_slots=P12_SLOTS,
                  policy=ExecutionPolicy.for_arch(cfg), capture_logits=True)
    torch.cuda.synchronize()
    log(f"12a gemma-2b ({cfg.n_layers} of {full.n_layers} layers) init + plans "
        f"on the card: {time.perf_counter() - t0:.3f}s,"
        f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(SEED + 12)
    base.generate_batch([rng.integers(0, cfg.vocab, size=(8,))], 2)  # warm-up
    prompts = [rng.integers(0, cfg.vocab, size=(PROMPT,)).astype(np.int32)
               for _ in P12_GENS]
    t0 = time.perf_counter()
    outs, traces, counts, calls, rids = _budget_serve(base, prompts, P12_GENS,
                                                      "12a gemma-2b undisturbed")
    serve_s = time.perf_counter() - t0
    s = base.summary()
    forwards = s["prefill_batches"] + s["decode_batches"]
    _all_tc(counts, 2 * cfg.n_layers, forwards, "12a undisturbed")
    log(f"12a undisturbed serve: {len(prompts)} requests, {s['total_tokens']} "
        f"tokens in {serve_s:.2f}s with logit capture, {forwards} forwards, "
        f"{counts['ftp_bsr']} kernel 3 launches (all tc); sample "
        f"{outs[1][:8].tolist()}")
    held = _hold_calls(calls, "12a gemma-2b serve")
    assert held["launches"] == counts["ftp_bsr"]
    del calls
    pick = list(P12_CPU_REQUESTS)
    cpu_ref = _cpu_reference(model, cfg, params, [prompts[i] for i in pick],
                             [outs[i] for i in pick],
                             [traces[rids[i]] for i in pick])
    flush = _flush_buffer()
    block_cost = {c.name: _batch_block_cost(c, flush) for c in (
        cfg, build_config("llama3_2_1b", smoke=False, spiking=True,
                          weight_density=0.3))}
    del flush
    cycles = {}
    with tempfile.TemporaryDirectory() as tmp:
        for execution in ("sync", "pipelined"):
            for paging in (None, paged(PAGE)):
                key = f"{execution} {'paged' if paging else 'dense'}"
                cycles[key] = _drain_cycle(
                    model, params, cfg, prompts, (outs, traces, rids),
                    execution, paging, os.path.join(tmp, key.replace(" ", "_")))
    del base, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "requests": len(prompts),
            "gens": list(P12_GENS),
            "forwards": forwards, "launches": counts["ftp_bsr"],
            "serve_s": serve_s, "kernel3": held, "cpu_reference": cpu_ref,
            "attention_batch_block": block_cost, "drain": cycles}


def phase_qwen3():
    """12b: qwen3-14b at its published width (d_model 5120, 40 heads, kv 8,
    head_dim 128, d_ff 17408, vocab 151936, qk-norm, untied head), depth
    cut to QWEN_LAYERS, spiking FFNs at weight density 0.3 under
    PACKED_DUAL: kernel 3 on the 17408-wide plans, card vs CPU logits, and
    a speculative (float draft, k 4) serve and a streamed serve bit for bit
    equal to the single-position serve."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy

    full = build_config("qwen3_14b", smoke=False, spiking=True,
                        weight_density=0.3)
    cfg = dataclasses.replace(full, n_layers=QWEN_LAYERS)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_ff,
            cfg.vocab, cfg.qk_norm, cfg.tie_embeddings) == (
        5120, 40, 8, 128, 17408, 151936, True, False)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    assert "lm_head" in params and "q_norm" in params["layers"][0]["attn"]
    engine = Engine(model, params, max_len=PROMPT + GEN, max_slots=REQUESTS,
                    policy=ExecutionPolicy.for_arch(cfg), capture_logits=True)
    rng = np.random.default_rng(SEED + 13)
    engine.generate_batch([rng.integers(0, cfg.vocab, size=(8,))], 2)  # warm-up
    prompts = [rng.integers(0, cfg.vocab, size=(PROMPT,)).astype(np.int32)
               for _ in range(REQUESTS)]
    outs, got, counts, calls = _traced_serve(engine, prompts, "12b qwen3-14b")
    s = engine.summary()
    forwards = s["prefill_batches"] + s["decode_batches"]
    _all_tc(counts, 2 * cfg.n_layers, forwards, "12b qwen3-14b")
    plan = engine.params["layers"][0]["mlp"]["plan_in"]
    log(f"12b qwen3-14b ({cfg.n_layers} of {full.n_layers} layers): "
        f"{forwards} forwards, {counts['ftp_bsr']} kernel 3 launches (all tc) "
        f"on W_in plans of {tuple(plan.payload.shape)} blocks")
    held = _hold_calls(calls, "12b qwen3-14b serve")
    del calls
    cpu_ref = _cpu_reference(model, cfg, params, prompts, outs, got)
    del engine
    gc.collect()
    # speculative (float draft, k = 4) and streamed serves against the
    # single-position serve, bit for bit
    float_draft = ExecutionPolicy.for_arch(cfg, spike_format="float",
                                           weight_sparsity="dense")
    base = Engine(model, params, max_len=SPEC_MAX_LEN, max_slots=REQUESTS,
                  policy=ExecutionPolicy.for_arch(cfg))
    want, want_logits, _, _ = _traced_serve(base, prompts, "12b non-speculative")
    del base
    spec = _spec_engine(model, params, cfg, float_draft)
    souts, slogits, scounts, _ = _traced_serve(spec, prompts, "12b speculative")
    ss = spec.summary()
    assert ss["tokens_proposed"] == ss["tokens_accepted"] + ss["tokens_rejected"]
    assert ss["speculative_rounds"] > 0
    spec_gate = _gate("12b qwen3-14b speculative (float draft, k 4)", "bitwise",
                      souts, slogits, want, want_logits)
    spec_gate.update(acceptance=ss["acceptance_rate"],
                     rounds=ss["speculative_rounds"],
                     launches=scounts["ftp_bsr"])
    del spec
    gc.collect()
    chunks, sprompt = _stream_prompt(cfg)
    max_len = 9 * PAGE
    mono = Engine(model, params, max_len=max_len, max_slots=1,
                  policy=ExecutionPolicy.for_arch(cfg))
    mwant, mlogits, _, _ = _traced_serve(mono, [sprompt], "12b monolithic")
    del mono
    streamer = Engine(model, params, max_len=max_len, max_slots=1,
                      capture_logits=True, policy=ExecutionPolicy.for_arch(cfg))
    (sgot, session), stcounts = _counted(
        "12b stream", lambda: _drive_stream(streamer, chunks, cfg))
    np.testing.assert_array_equal(session.prompt_tokens(), sprompt)
    stream_logits = np.stack(streamer.drain_logit_traces()[0])[None]
    stream_gate = _gate("12b qwen3-14b stream (120 frames)", "bitwise", [sgot],
                        stream_logits, mwant, mlogits)
    stream_gate.update(launches=stcounts["ftp_bsr"],
                       windows=streamer.summary()["stream_windows"])
    del streamer, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "full_depth": full.n_layers, "forwards": forwards,
            "launches": counts["ftp_bsr"], "kernel3": held,
            "cpu_reference": cpu_ref, "speculative": spec_gate,
            "stream": stream_gate}


def phase_smoke_archs():
    """12c: gemma-2b, qwen3-14b and nemotron-4-340b at the smoke size in
    the float, packed and dual modes (as `tests/test_arch_parity_matrix.py`
    sets them) served on the card and on the CPU from the same params: the
    same tokens, logits within LOGIT_TOL."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy

    modes = {"float": {}, "packed": dict(spiking_ffn=True, spiking_T=4),
             "dual": dict(spiking_ffn=True, spiking_T=4,
                          spiking_weight_density=0.3)}
    out = {}
    for arch in ("gemma_2b", "qwen3_14b", "nemotron_4_340b"):
        for mode, over in modes.items():
            cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
            model = build_model(cfg)
            params = model.init(SEED, device="cpu")
            prompts = list(np.random.default_rng(1).integers(0, cfg.vocab,
                                                             size=(3, 8)))
            got, traces, launches, held = {}, {}, 0, {}
            for dev in ("cuda", "cpu"):
                eng = Engine(model, params, max_len=16, max_slots=3,
                             capture_logits=True, device=dev,
                             policy=ExecutionPolicy.for_arch(cfg))
                res, counts = _counted(f"12c {arch} {mode} {dev}",
                                       lambda: eng.generate_batch(prompts, 6))
                got[dev] = res
                traces[dev] = np.stack([np.stack(t)
                                        for t in eng.drain_logit_traces()])
                if dev == "cuda":
                    launches = counts["ftp_bsr"] + counts["ftp_spmm"]
                    if mode != "float":
                        assert launches > 0, counts
            for a, b in zip(got["cuda"], got["cpu"]):
                np.testing.assert_array_equal(a, b)
            drift = float(np.abs(traces["cuda"] - traces["cpu"]).max())
            assert drift <= LOGIT_TOL, (arch, mode, drift)
            log(f"12c {arch} smoke, {mode}: card and CPU emit the same tokens, "
                f"max |logit drift| {drift:.3e}; FTP kernel launches {launches}")
            out[f"{arch} {mode}"] = {"drift": drift, "launches": launches}
    out.update(_smoke_new_archs())
    return out


def _smoke_new_archs():
    """12c for phase 14's archs at smoke size (4 experts, window 16, 8
    image tokens), float, from the same params on the card and the CPU:
    phi3.5-moe and mixtral served (prompts of 32 and 12 tokens, 6 new
    each: for mixtral the temporary full-length prefill and decodes across
    the ring's wrap), the same tokens, logits within LOGIT_TOL, the routing
    choices that differ reported; llava's prefill with image embeddings and
    6 greedy decodes on the card, the CPU teacher-forced with its tokens,
    and hubert's encoder prefill, within LOGIT_TOL with the same greedy
    tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import SyntheticLMData, batch_to_torch
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy

    out = {}
    for arch in ("phi3_5_moe", "mixtral_8x22b"):
        cfg = smoke_variant(get_config(arch))
        model = build_model(cfg)
        params = model.init(SEED, device="cpu")
        prompts = [np.random.default_rng(n).integers(0, cfg.vocab, size=(n,))
                   for n in (32, 12)]
        got, traces, routes = {}, {}, {}
        for dev in ("cuda", "cpu"):
            eng = Engine(model, params, max_len=40, max_slots=2,
                         capture_logits=True, device=dev,
                         policy=ExecutionPolicy.for_arch(cfg))
            routes[dev] = []
            restore = _record_routes(routes[dev])
            try:
                got[dev], counts = _counted(f"12c {arch} {dev}",
                                            lambda: eng.generate_batch(prompts, 6))
            finally:
                restore()
            _no_kernels(counts, f"12c {arch}")
            traces[dev] = [np.stack(t) for t in eng.drain_logit_traces()]
        flips = sum(int((a.cpu() != b).sum()) for (a, _), (b, _)
                    in zip(routes["cuda"], routes["cpu"]))
        drift = max(float(np.abs(a - b).max())
                    for a, b in zip(traces["cuda"], traces["cpu"]))
        log(f"12c {arch} smoke: card vs CPU max |logit drift| {drift:.3e}, "
            f"{flips} of {sum(e.numel() for e, _ in routes['cpu'])} routing "
            f"choices differ; tokens {[o.tolist() for o in got['cuda']]}")
        for a, b in zip(got["cuda"], got["cpu"]):
            np.testing.assert_array_equal(a, b)
        assert drift <= LOGIT_TOL, (arch, drift)
        out[f"{arch} float"] = {"drift": drift, "routing_flips": flips}
    for arch in ("llava_next_mistral_7b", "hubert_xlarge"):
        cfg = smoke_variant(get_config(arch))
        model = build_model(cfg)
        params = model.init(SEED, device="cpu")
        batch = SyntheticLMData(cfg, seq_len=24, global_batch=2).batch(0)
        batch.pop("labels")
        logits, fed = {}, None
        for dev in ("cuda", "cpu"):
            p = model.prepare(_tree_to(params, dev))
            with torch.no_grad():
                cache = (None if cfg.encoder_only else
                         model.init_cache(2, 32, device=dev))
                lg, cache = model.prefill(p, batch_to_torch(batch, dev), cache)
                steps = [lg[:, -1]]
                for i in range(0 if cfg.encoder_only else 6):
                    tok = (steps[-1].argmax(-1)[:, None] if fed is None
                           else fed[i].to(dev))
                    lg, cache = model.decode(p, tok, cache)
                    steps.append(lg[:, -1])
            logits[dev] = torch.stack(steps, 1).float().cpu().numpy()
            if fed is None:   # the card's greedy tokens, fed to the CPU
                fed = [torch.from_numpy(logits[dev][:, i].argmax(-1))[:, None]
                       for i in range(logits[dev].shape[1] - 1)]
        drift = float(np.abs(logits["cuda"] - logits["cpu"]).max())
        log(f"12c {arch} smoke: card vs CPU ({logits['cpu'].shape[1]} steps) "
            f"max |logit drift| {drift:.3e}")
        np.testing.assert_array_equal(logits["cuda"].argmax(-1),
                                      logits["cpu"].argmax(-1))
        assert drift <= LOGIT_TOL, (arch, drift)
        out[f"{arch} float"] = {"drift": drift}
    return out


# ---------------------------------------------------------------------------
# phase 13: the recurrent families (rwkv6-1.6b, zamba2-7b) at full width
# ---------------------------------------------------------------------------

# zamba2's odd prompt: not a multiple of ssm_chunk (128), so its prefill
# takes the per-step SSD scan while the 128-token ones take the chunked form
P13_SHORT_PROMPT, P13_SHORT_AT = 100, 5
# Card vs CPU at the published width, on depth-cut copies (the CPU's time):
# (arch, layers, compute dtype, teacher-forced decode steps, requests),
# each request a prefill + 15 decodes.  rwkv6 24 -> 4 layers, bf16, within
# LOGIT_TOL.  zamba2 81 -> 7 layers (a group of 6 followed by the shared
# block, its attention decoding through its KV cache, then a tail of 1), a
# 128- and a 100-token prompt (both SSD forms): in f32 compute
# within LOGIT_TOL, and in bf16 held against that f32 run on the CPU (see
# P13_BF16_FACTOR).  At random init zamba2 turns the devices' bf16
# last-bit differences into a card-vs-CPU bf16 drift that grows with depth
# (PERF.md §6 has every depth's readings).  The CPU side is phase 13's
# longest path (one worker, ~190 s of host work at 4 / 9 / 9 layers and 4
# requests, the bf16 copy ~100 s of it; a slow host doubles it), so its
# depths and requests are the run's time: 4 / 7 / 7 layers, 2 requests.
P13_CPU_CASES = {
    "rwkv6_1_6b": ("rwkv6_1_6b", 4, "bfloat16", GEN - 1, 2),
    "zamba2_7b f32": ("zamba2_7b", 7, "float32", GEN - 1, 2),
    "zamba2_7b bf16": ("zamba2_7b", 7, "bfloat16", GEN - 1, 2),
}
# zamba2's bf16 gate: the card's bf16 logits lie no further from the CPU's
# f32 run of the same copy than the CPU's own bf16 run does, by more than
# this factor (max and mean |difference|): a device fault in a bf16 path
# would show as the card alone leaving the f32 run
P13_BF16_FACTOR = 2.0
# 13a / 13b serve depth cuts (the run's time: on a slow host the serves at
# full depth, 24 and 81 layers, took 450 s of the script's 1200 s; every
# gate holds layer by layer): rwkv6-1.6b 8 of 24, zamba2-7b 12 of 81 (two
# shared-attention groups of 6).  The card-vs-CPU copies have their own
# cuts (P13_CPU_CASES).
P13_LAYERS = {"rwkv6_1_6b": 8, "zamba2_7b": 12}
P13_LONE = 1                 # the request served alone for the row gate


def _p13_prompts(cfg, n=len(P12_GENS)):
    import numpy as np

    rng = np.random.default_rng(SEED + 21)
    lens = [PROMPT] * n
    if cfg.family == "hybrid" and n > P13_SHORT_AT:
        lens[P13_SHORT_AT] = P13_SHORT_PROMPT
    return [rng.integers(0, cfg.vocab, size=(L,)).astype(np.int32) for L in lens]


def _no_kernels(counts, label):
    assert not any(counts.values()), (label, counts)


def _p13_cell(model, params, cfg, prompts, execution, paging, label):
    """One counted serve of the 8 requests under ``execution`` x
    ``paging``, logits captured: (tokens, {rid: logits}, rids)."""
    from repro_torch.serve import Engine, ExecutionPolicy

    eng = Engine(model, params, max_len=PROMPT + GEN, max_slots=P12_SLOTS,
                 policy=ExecutionPolicy.for_arch(cfg, execution=execution,
                                                 paging=paging),
                 capture_logits=True)
    outs, traces, counts, _, rids = _budget_serve(eng, prompts, P12_GENS, label)
    _no_kernels(counts, label)
    s = eng.summary()
    del eng
    gc.collect()
    return outs, traces, rids, s


def _same_serve(label, got, want):
    """Two serves of the same requests: tokens and every logit vector equal
    bit for bit (requests in submit order)."""
    import numpy as np

    outs, traces, rids = got[:3]
    w_outs, w_traces, w_rids = want[:3]
    for i, (a, b) in enumerate(zip(outs, w_outs)):
        np.testing.assert_array_equal(a, b, err_msg=f"{label}: request {i}")
        x, y = traces[rids[i]], w_traces[w_rids[i]]
        assert np.array_equal(x, y), (
            f"{label}: request {i}: {int((x != y).sum())} of {x.size} logits "
            "differ")


def _p13_cut(arch, n_layers, compute_dtype, steps, requests):
    """A card-vs-CPU copy of an arch (a `P13_CPU_CASES` entry): its
    published width, depth cut to ``n_layers``, in ``compute_dtype``; the
    last ``requests`` of 4 prompts (zamba2's last one of P13_SHORT_PROMPT
    tokens: the per-step SSD scan) and the ``steps`` tokens each is
    teacher-forced with.  Returns (full cfg, cut cfg, prompts, fed)."""
    import dataclasses

    import numpy as np

    from repro_torch.launch.serve import build_config

    full = build_config(arch, smoke=False, spiking=False, weight_density=1.0)
    cfg = dataclasses.replace(full, n_layers=n_layers, compute_dtype=compute_dtype)
    rng = np.random.default_rng(SEED + 22)
    lens = [PROMPT] * 3 + [P13_SHORT_PROMPT if cfg.family == "hybrid" else PROMPT]
    prompts = [rng.integers(0, cfg.vocab, size=(n,)) for n in lens]
    fed = [rng.integers(0, cfg.vocab, size=(steps,)) for _ in lens]
    return full, cfg, prompts[-requests:], fed[-requests:]


def _teacher_forced(model, params, prompts, fed, device):
    """Each request alone on ``device``: its prefill's last-position logits,
    then one decode per fed token; a (GEN, V) f32 array a request."""
    import torch

    out = []
    with torch.no_grad():
        for p, f in zip(prompts, fed):
            cache = model.init_cache(1, PROMPT + GEN, device=device)
            logits, cache = model.prefill(
                params, {"tokens": torch.as_tensor(p, device=device)[None].long()},
                cache)
            steps = [logits[0, -1]]
            for t in f:
                logits, cache = model.decode(
                    params, torch.full((1, 1), int(t), dtype=torch.long,
                                       device=device), cache)
                steps.append(logits[0, -1])
            out.append(torch.stack(steps).float().cpu().numpy())
    return out


def _p13_cpu_worker(case):
    """In a spawned process: a `P13_CPU_CASES` copy's params drawn on the CPU
    from SEED (the card's copy is drawn the same way), teacher-forced on the
    CPU.  Returns (logits per request, seconds)."""
    t0 = time.perf_counter()
    sys.path.insert(0, SRC)
    import torch

    from repro_torch.models.registry import build_model

    # leave the serving process a core for its dispatch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    _, cfg, prompts, fed = _p13_cut(*case)
    model = build_model(cfg)
    params = model.prepare(model.init(SEED, device="cpu"))
    return _teacher_forced(model, params, prompts, fed, "cpu"), time.perf_counter() - t0


_P13_DRAWN = {}


def _p13_on_card(case):
    """The same copy's logits on the card (params drawn on the CPU, moved;
    one draw a depth, kept for the copy's other compute dtype: the draw
    is in the param dtype)."""
    import torch

    from repro_torch.models.registry import build_model

    _, cfg, prompts, fed = _p13_cut(*case)
    model = build_model(cfg)
    key = case[:2]
    if key not in _P13_DRAWN:
        _P13_DRAWN[key] = model.init(SEED, device="cpu")
    params = model.prepare(_tree_to(_P13_DRAWN[key], "cuda"))
    out = _teacher_forced(model, params, prompts, fed, "cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _p13_drift(card, cpu):
    """Card against CPU logits (lists of per-request (steps, V) arrays)."""
    import numpy as np

    want, got = np.concatenate(cpu), np.concatenate(card)
    top2 = np.sort(want, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) <= 2 * LOGIT_TOL
    differ = want.argmax(-1) != got.argmax(-1)
    return {"max_abs_drift": float(np.abs(got - want).max()),
            "max_abs_drift_per_request": [float(np.abs(a - b).max())
                                          for a, b in zip(card, cpu)],
            "max_abs_drift_prefill": float(max(np.abs(a[0] - b[0]).max()
                                               for a, b in zip(card, cpu))),
            "mean_abs_drift": float(np.abs(got - want).mean()),
            "logit_std": float(want.std()),
            "tokens_compared": int(differ.size),
            "tokens_disagree": int(differ.sum()),
            "tokens_disagree_off_tie": int((differ & ~close).sum())}


def _p13_card_vs_cpu(key, cpu_future):
    """Card vs CPU on a `P13_CPU_CASES` copy: the same params and fed tokens
    through the port on the card and (``cpu_future``) on the CPU.  Logits
    within LOGIT_TOL; a greedy token may differ only where the CPU's top
    two lie within 2 x LOGIT_TOL.  Beside it, a witness: the card again
    with other row and batch blocks (the same math in other summation
    orders, where the library picks other algorithms)."""
    from repro_torch.models import layers

    case = P13_CPU_CASES[key]
    card = _p13_on_card(case)
    saved = layers.ROW_BLOCK, layers.B_BLOCK
    layers.ROW_BLOCK, layers.B_BLOCK = 32, 8
    try:
        witness = _p13_on_card(case)
    finally:
        layers.ROW_BLOCK, layers.B_BLOCK = saved
    cpu, cpu_s = cpu_future.result()
    out = dict(_p13_drift(card, cpu), case=list(case), cpu_seconds=cpu_s,
               witness_max_abs=_p13_drift(card, witness)["max_abs_drift"])
    log(f"13 {key} card vs CPU ({case[1]} layers, {case[2]}, "
        f"{len(cpu)} requests, {case[3]} fed tokens each): max |logit drift| "
        f"{out['max_abs_drift']:.3e} (per request "
        f"{[round(x, 4) for x in out['max_abs_drift_per_request']]}, prefill "
        f"{out['max_abs_drift_prefill']:.3e}, mean {out['mean_abs_drift']:.3e}, "
        f"logit std {out['logit_std']:.3f}); the card against itself in other "
        f"blocks {out['witness_max_abs']:.3e}; {out['tokens_disagree']} of "
        f"{out['tokens_compared']} greedy tokens disagree; CPU {cpu_s:.1f}s")
    assert out["max_abs_drift"] <= LOGIT_TOL, out
    assert out["tokens_disagree_off_tie"] == 0, out
    return out


def _p13_bf16_vs_f32(futures):
    """zamba2's cut copy in bf16: the card's logits and the CPU's, each
    against the CPU's f32 run of the same copy (params, prompts, fed
    tokens).  Gated: the card's distance is at most P13_BF16_FACTOR times
    the CPU's, in max and in mean; the card-vs-CPU bf16 drift is logged."""
    case = P13_CPU_CASES["zamba2_7b bf16"]
    truth, _ = futures["zamba2_7b f32"].result()
    cpu, cpu_s = futures["zamba2_7b bf16"].result()
    card = _p13_on_card(case)
    out = {"case": list(case), "cpu_seconds": cpu_s, "factor": P13_BF16_FACTOR,
           "card_vs_cpu_f32": _p13_drift(card, truth),
           "cpu_vs_cpu_f32": _p13_drift(cpu, truth),
           "card_vs_cpu": _p13_drift(card, cpu)}
    ratio = {k: out["card_vs_cpu_f32"][k] / out["cpu_vs_cpu_f32"][k]
             for k in ("max_abs_drift", "mean_abs_drift")}
    out["ratio"] = ratio
    d_card, d_cpu = out["card_vs_cpu_f32"], out["cpu_vs_cpu_f32"]
    log(f"13 zamba2_7b bf16 ({case[1]} layers, {len(cpu)} requests, {case[3]} "
        f"fed tokens each) against the CPU's f32 run: card max "
        f"{d_card['max_abs_drift']:.4e} mean {d_card['mean_abs_drift']:.4e}, "
        f"CPU max {d_cpu['max_abs_drift']:.4e} mean {d_cpu['mean_abs_drift']:.4e}"
        f" (card / CPU {ratio['max_abs_drift']:.3f} / "
        f"{ratio['mean_abs_drift']:.3f}, <= {P13_BF16_FACTOR}); greedy tokens "
        f"off the f32 run's: card {d_card['tokens_disagree']}, CPU "
        f"{d_cpu['tokens_disagree']} of {d_cpu['tokens_compared']}; bf16 card "
        f"vs CPU {out['card_vs_cpu']['max_abs_drift']:.4e} (not gated), "
        f"{out['card_vs_cpu']['tokens_disagree']} tokens differ; CPU {cpu_s:.1f}s")
    assert all(r <= P13_BF16_FACTOR for r in ratio.values()), out
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _launches_per_call(model, params, cfg):
    """Device launches (kernels, copies, fills) of one prefill (4 x 128)
    and of one decode step of the 4 rows after it, counted from a profiler
    pass over each call; None where the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    toks = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED))
    out = {}
    with torch.no_grad():
        cache = model.init_cache(REQUESTS, PROMPT + GEN, device="cuda")
        for name in ("prefill", "decode"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                if name == "prefill":
                    logits, cache = model.prefill(params, {"tokens": toks}, cache)
                else:
                    logits, cache = model.decode(
                        params, logits[:, -1].argmax(-1)[:, None], cache)
                torch.cuda.synchronize()
            out[name] = sum(1 for e in prof.events()
                            if e.device_type == DeviceType.CUDA) or None
    return out


def _p13_profile(engine, prompts, unprofiled_wall, gen=GEN):
    """One serve of ``gen`` new tokens under torch.profiler: device busy
    time against the host wall, and the five largest device ops by time."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_batch(prompts, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.device_time_total * 1e-6
    busy = sum(by_name.values())
    out = {"wall_s": wall, "device_busy_s": busy,
           "idle_share_profiled": 1.0 - busy / wall if busy else None,
           "idle_share_unprofiled": (1.0 - busy / unprofiled_wall
                                     if busy else None),
           "top_ops_ms": [[n[:100], 1e3 * t] for n, t in by_name.most_common(5)]}
    if busy:
        log(f"profile: device busy {busy:.3f}s, idle {out['idle_share_profiled']:.3f}"
            f" of the profiled wall ({wall:.3f}s), "
            f"{out['idle_share_unprofiled']:.3f} of the unprofiled one")
        for name, ms in out["top_ops_ms"]:
            log(f"  {ms:9.3f} ms  {name}")
    else:
        log("profile: no device time recorded (not measured)")
    return out


def _p13_arch(arch, futures):
    """13a / 13b: one recurrent arch at its published width, depth cut to
    P13_LAYERS, then its card-vs-CPU checks (their CPU sides running in
    ``futures``)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy, draft, paged

    tag = "13a" if arch == "rwkv6_1_6b" else "13b"
    cfg = dataclasses.replace(
        build_config(arch, smoke=False, spiking=False, weight_density=1.0),
        n_layers=P13_LAYERS[arch])
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.prepare(model.init(SEED, device="cuda"))
    gc.collect()
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}) init + prepare on the card: {time.perf_counter() - t0:.3f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompts = _p13_prompts(cfg)
    warm = Engine(model, params, max_len=PROMPT + GEN, max_slots=P12_SLOTS,
                  policy=ExecutionPolicy.for_arch(cfg))
    warm.generate_batch([prompts[0][:8]], 2)
    del warm
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "prompt_lens": [len(p) for p in prompts], "gens": list(P12_GENS)}
    cells = {}
    for execution in ("sync", "pipelined"):
        for paging in (None, paged(PAGE)):
            key = f"{execution} {'paged' if paging else 'dense'}"
            t1 = time.perf_counter()
            cells[key] = _p13_cell(model, params, cfg, prompts, execution,
                                   paging, f"{tag} {key}")
            log(f"{tag} {key}: {cells[key][3]['total_tokens']} tokens, "
                f"{cells[key][3]['prefill_batches']} prefills, "
                f"{cells[key][3]['decode_batches']} decodes in "
                f"{time.perf_counter() - t1:.2f}s with logit capture")
    base = cells["sync dense"]
    for key, cell in cells.items():
        if key != "sync dense":
            _same_serve(f"{tag} {key} vs sync dense", cell, base)
    log(f"{tag}: sync / pipelined x dense / paged({PAGE}) equal bit for bit "
        f"(tokens and {sum(P12_GENS)} logit vectors each); sample "
        f"{base[0][1][:8].tolist()}")
    res["cells_bitwise"] = True
    # the row gate: request P13_LONE served alone
    lone = Engine(model, params, max_len=PROMPT + GEN, max_slots=P12_SLOTS,
                  policy=ExecutionPolicy.for_arch(cfg), capture_logits=True)
    l_outs, l_traces, counts, _, l_rids = _budget_serve(
        lone, [prompts[P13_LONE]], [P12_GENS[P13_LONE]], f"{tag} lone")
    _no_kernels(counts, f"{tag} lone")
    np.testing.assert_array_equal(l_outs[0], base[0][P13_LONE])
    x, y = l_traces[l_rids[0]], base[1][base[2][P13_LONE]]
    assert np.array_equal(x, y), (
        f"{tag}: the lone request's logits differ from its cohort's at "
        f"{int((x != y).sum())} of {x.size} elements")
    log(f"{tag}: request {P13_LONE} served alone equals itself in its cohort "
        f"bit for bit ({x.shape[0]} logit vectors)")
    del lone
    res["lone_equals_cohort"] = True
    with tempfile.TemporaryDirectory() as tmp:
        res["drain"] = _drain_cycle(model, params, cfg, prompts,
                                    (base[0], base[1], base[2]), "sync", None,
                                    tmp, phase=tag, kernel3=False)
    try:
        Engine(model, params, max_len=PROMPT + GEN, policy=ExecutionPolicy.for_arch(
            cfg, speculation=draft(ExecutionPolicy.for_arch(cfg), SPEC_K)))
    except ValueError as e:
        assert "non-rewindable" in str(e), e
        log(f"{tag}: speculation refused: {e}")
        res["speculation_refused"] = str(e)
    else:
        raise AssertionError(f"{tag}: speculation was not refused")
    # timed: 4 x 128 + 16, no logit capture
    timed_prompts = prompts[:REQUESTS]
    engine = Engine(model, params, max_len=PROMPT + GEN, max_slots=REQUESTS,
                    policy=ExecutionPolicy.for_arch(cfg))
    want = engine.generate_batch(timed_prompts, GEN)
    for a, b in zip(want, base[0][:REQUESTS]):
        np.testing.assert_array_equal(a[:len(b)], b[:len(a)])
    timed, best = _timed(engine, timed_prompts, want, tag)
    s = best
    res["serve"] = {
        "tok_s": s["throughput_tok_s"], "ttft_s_p50": s["ttft_s_p50"],
        "wall_s": s["wall_s"], "stage_s": s["stage_s"],
        "decode_step_ms": 1e3 * s["stage_s"]["decode"] / s["decode_batches"],
        "tok_s_runs": [t["throughput_tok_s"] for t in timed],
        "ttft_s_p50_runs": [t["ttft_s_p50"] for t in timed]}
    log(f"{tag}: decode step {res['serve']['decode_step_ms']:.2f} ms "
        f"({s['decode_batches']} decodes of {REQUESTS} rows)")
    res["profile"] = _p13_profile(engine, timed_prompts, best["wall_s"])
    del engine
    gc.collect()
    res["launches_per_call"] = _launches_per_call(model, params, cfg)
    log(f"{tag}: device launches in one prefill ({REQUESTS} x {PROMPT}) "
        f"{res['launches_per_call']['prefill']}, in one decode step "
        f"{res['launches_per_call']['decode']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.family == "hybrid":
        res["cpu_reference"] = _p13_card_vs_cpu("zamba2_7b f32",
                                                futures["zamba2_7b f32"])
        res["cpu_reference_bf16"] = _p13_bf16_vs_f32(futures)
    else:
        res["cpu_reference"] = _p13_card_vs_cpu(arch, futures[arch])
    _P13_DRAWN.clear()
    return res


def _p13_smoke():
    """13c: rwkv6 and zamba2 at the smoke size (zamba2 also with a spiking
    shared MLP, served under `for_arch`'s policy: packed spikes, dense
    weights), on the card and on the CPU from the same params: the same
    tokens, logits within LOGIT_TOL.  Every kernel 1-2 call of the spiking
    card serve is replayed against its plain version."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy

    out = {}
    for arch, over in (("rwkv6_1_6b", {}), ("zamba2_7b", {}),
                       ("zamba2_7b", {"spiking_ffn": True})):
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
        model = build_model(cfg)
        params = model.init(SEED, device="cpu")
        prompts = list(np.random.default_rng(1).integers(0, cfg.vocab,
                                                         size=(3, 8)))
        mode = "spiking" if over else "float"
        got, traces, launches, held = {}, {}, 0, {}
        for dev in ("cuda", "cpu"):
            eng = Engine(model, params, max_len=16, max_slots=3,
                         capture_logits=True, device=dev,
                         policy=ExecutionPolicy.for_arch(cfg))
            calls, restore = _record(["ftp_spmm", "ftp_spmm_fused_lif"])
            try:
                res, counts = _counted(f"13c {arch} {mode} {dev}",
                                       lambda: eng.generate_batch(prompts, 6))
            finally:
                restore()
            got[dev] = res
            traces[dev] = np.stack([np.stack(t) for t in eng.drain_logit_traces()])
            if dev == "cuda":
                launches = sum(counts[k] for k in ("ftp_spmm", "ftp_spmm_fused_lif"))
                assert (launches > 0) == bool(over), counts
                assert len(calls) == launches, (len(calls), counts)
                held = _hold_dense_calls(calls, f"13c {arch} {mode}")
        for a, b in zip(got["cuda"], got["cpu"]):
            np.testing.assert_array_equal(a, b)
        drift = float(np.abs(traces["cuda"] - traces["cpu"]).max())
        assert drift <= LOGIT_TOL, (arch, mode, drift)
        log(f"13c {arch} smoke, {mode}: card and CPU emit the same tokens, "
            f"max |logit drift| {drift:.3e}; dense-weight FTP launches {launches}")
        out[f"{arch} {mode}"] = {"drift": drift, "launches": launches, **held}
    return out


def _hold_dense_calls(calls, label):
    """Every recorded kernel 1-2 call against its plain version (the FTP
    gate), on the instance it was routed to; returns the worst error and
    the spike-word flips."""
    err, flips = 0.0, 0
    for n, (name, args, _) in enumerate(calls):
        a, w, Tc = args[:3]
        e, f = _dense_parity(f"{label} {name} call {n}", a, w, Tc,
                             name == "ftp_spmm_fused_lif")
        err, flips = max(err, e), flips + f
    log(f"{label}: all {len(calls)} kernel 1-2 calls held against the plain "
        f"version: max_abs_err {err:.3e} (<= {TOL}), {flips} spike-word flips "
        "at the threshold")
    return {"held_calls": len(calls), "max_abs_err": err, "flips": flips}


def phase_recurrent():
    """13: rwkv6-1.6b and zamba2-7b at their published widths (depth cut to
    P13_LAYERS), then the smoke cells.  The card-vs-CPU checks' CPU side
    runs in one spawned worker process from the start, beside the card's
    serves."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    res = {}
    archs = ("rwkv6_1_6b", "zamba2_7b")
    with ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = {k: pool.submit(_p13_cpu_worker, case)
                   for k, case in P13_CPU_CASES.items()}
        for arch in archs:
            t1 = time.perf_counter()
            res[arch] = _p13_arch(arch, futures)
            res[arch]["seconds"] = time.perf_counter() - t1
            log(f"13 {arch} done in {res[arch]['seconds']:.1f}s")
    res["smoke"] = _p13_smoke()
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 13 in {res['seconds']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phase 14: the MoE families (phi3.5-moe; mixtral-8x22b through its
# sliding-window ring) and the stub front ends (llava-next-mistral-7b,
# hubert-xlarge) at published width
# ---------------------------------------------------------------------------

# Depth cuts (the card's memory and the run's time; every gate holds layer
# by layer): phi3.5-moe 32 -> 4 layers (1.300 B params a layer), mixtral
# 56 -> 2 (2.504 B a layer); llava (32) and hubert (48) at full depth.
P14_LAYERS = {"phi3_5_moe": 4, "mixtral_8x22b": 2}
# 14a: distinct prompt lengths (capacity routing couples a cohort's rows,
# so the engine merges no cohorts: each request decodes alone, as in the
# solo loop), 16 new tokens each, 4 slots; max_len a multiple of the page
P14A_PROMPTS = (96, 112, 128, 144)
# 14b: a prompt of two windows (8192: the temporary full-length prefill)
# and one of 4080 (the plain prefill, then decodes that wrap the ring at
# 4096), 32 new tokens each
P14B_PROMPTS, P14B_GEN = (8192, 4080), 32
# 14c, card vs CPU (the CPU's time): (arch, layers) at published width, 2
# requests of 64 prompt tokens (llava: 576 image + 64 text positions;
# hubert: 512 frames) in one batch, then 8 teacher-forced decodes
P14_CPU_CASES = {"phi3_5_moe": 1, "mixtral_8x22b": 1,
                 "llava_next_mistral_7b": 2, "hubert_xlarge": 4}
P14C_BATCH, P14C_PROMPT, P14C_DECODES, P14C_FRAMES = 2, 64, 8, 512
# 14d: llava 2 x (576 + 64) then 16 greedy decodes; hubert 4 x 1024 frames
P14D_LLAVA_TEXT, P14D_LLAVA_DECODES = 64, 16
P14D_HUBERT_BATCH, P14D_HUBERT_FRAMES = 4, 1024


def _p14_model(arch, n_layers=None):
    """(cfg, model, prepared params on the card): published width, depth
    cut to ``n_layers``, drawn on the card from SEED."""
    import dataclasses

    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model

    cfg = build_config(arch, smoke=False, spiking=False, weight_density=1.0)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    return cfg, model, model.prepare(model.init(SEED, device="cuda"))


def _free():
    """Collect the caller's dropped model and empty the card's cache."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _record_routes(store):
    """Keep each `layers.moe_route` call's (expert ids, kept mask), device
    tensors as they are (no copy, no sync); returns the undo."""
    from repro_torch.models import layers

    orig = layers.moe_route

    def recorded(router, xt, cfg):
        out = orig(router, xt, cfg)
        store.append((out[2], out[4]))
        return out

    layers.moe_route = recorded
    return lambda: setattr(layers, "moe_route", orig)


def _drops(routes, n_layers):
    """Dropped (token, k) pairs of a list of routes, per layer and all."""
    per = [0] * n_layers
    pairs = [0] * n_layers
    for i, (_, keep) in enumerate(routes):
        per[i % n_layers] += int((~keep).sum())
        pairs[i % n_layers] += keep.numel()
    return {"dropped_per_layer": per, "pairs_per_layer": pairs,
            "dropped": sum(per), "pairs": sum(pairs)}


def _p14_cut_inputs(cfg):
    """14c's inputs for an arch (numpy, from SEED): the prefill batch and
    the teacher-forced tokens (B, 1) of each decode."""
    import numpy as np

    rng = np.random.default_rng(SEED + 23)
    B = P14C_BATCH
    if not cfg.embed_inputs:
        return {"frames": rng.standard_normal((B, P14C_FRAMES, cfg.d_model),
                                              dtype=np.float32)}, []
    S = cfg.n_img_tokens + P14C_PROMPT
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S))}
    if cfg.n_img_tokens:
        batch["img_embed"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model), dtype=np.float32)
    fed = [rng.integers(0, cfg.vocab, size=(B, 1)) for _ in range(P14C_DECODES)]
    return batch, fed


def _p14_forward(cfg, model, params, batch, fed, device):
    """Prefill then one decode per fed token on ``device``: per request a
    (steps, V) f32 array of the last position's logits (an encoder's: the
    logits of every frame, (S, V)), and the routes of every MoE call as
    numpy (expert ids, kept mask)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer

    routes = []
    restore = _record_routes(routes)
    try:
        with torch.no_grad():
            tb = {k: (torch.as_tensor(v, device=device).long() if v.dtype.kind in "iu"
                      else torch.as_tensor(v, device=device)) for k, v in batch.items()}
            if cfg.encoder_only:   # the encoder prefill's path, every frame
                x, _ = transformer.forward(params, cfg, tb)
                out = transformer.unembed(params, cfg, x).float().cpu().numpy()
            else:
                S = next(iter(tb.values())).shape[1]
                cache = model.init_cache(P14C_BATCH, S + len(fed), device=device)
                logits, cache = model.prefill(params, tb, cache)
                steps = [logits[:, -1]]
                for tok in fed:
                    logits, cache = model.decode(
                        params, torch.as_tensor(tok, device=device).long(), cache)
                    steps.append(logits[:, -1])
                out = torch.stack(steps, 1).float().cpu().numpy()
    finally:
        restore()
    routes = [(e.cpu().numpy(), k.cpu().numpy()) for e, k in routes]
    return [out[b] for b in range(out.shape[0])], routes


def _p14_cpu_worker(arch):
    """In a spawned process: a `P14_CPU_CASES` copy's params drawn on the
    card from SEED as the main process draws them, moved to the CPU and run
    there.  Returns (logits per request, routes, seconds)."""
    t0 = time.perf_counter()
    sys.path.insert(0, SRC)
    import dataclasses

    import torch

    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    cfg = dataclasses.replace(build_config(arch, smoke=False, spiking=False,
                                           weight_density=1.0),
                              n_layers=P14_CPU_CASES[arch])
    model = build_model(cfg)
    params = _tree_to(model.init(SEED, device="cuda"), "cpu")
    gc.collect()
    torch.cuda.empty_cache()
    params = model.prepare(params)
    batch, fed = _p14_cut_inputs(cfg)
    logits, routes = _p14_forward(cfg, model, params, batch, fed, "cpu")
    return logits, routes, time.perf_counter() - t0


def _p14_card_vs_cpu(arch, future):
    """14c: the copy on the card against ``future``'s CPU run of the same
    params and inputs: logits within LOGIT_TOL (hubert's at every frame),
    greedy tokens equal but at near ties; for the MoE archs the (token, k)
    routing choices and kept flags that differ, per layer."""
    import numpy as np

    cfg, model, params = _p14_model(arch, P14_CPU_CASES[arch])
    batch, fed = _p14_cut_inputs(cfg)
    card, routes = _p14_forward(cfg, model, params, batch, fed, "cuda")
    del params
    _free()
    cpu, cpu_routes, cpu_s = future.result()
    out = dict(_p13_drift(card, cpu), layers=cfg.n_layers, cpu_seconds=cpu_s,
               steps=card[0].shape[0])
    if cfg.n_experts:
        L = cfg.n_layers
        assert len(routes) == len(cpu_routes) == L * (1 + len(fed))
        flips, kept = [0] * L, [0] * L
        for i, ((e, k), (ce, ck)) in enumerate(zip(routes, cpu_routes)):
            flips[i % L] += int((e != ce).sum())
            kept[i % L] += int((k != ck).sum())
        out.update(routing_flips_per_layer=flips, kept_flips_per_layer=kept,
                   routing_choices=sum(e.size for e, _ in routes))
    log(f"14c {arch} card vs CPU ({cfg.n_layers} layers at published width, "
        f"{P14C_BATCH} requests, {out['steps']} "
        f"{'frames' if cfg.encoder_only else 'steps'}): max |logit drift| "
        f"{out['max_abs_drift']:.3e} (prefill {out['max_abs_drift_prefill']:.3e}, "
        f"mean {out['mean_abs_drift']:.3e}, logit std {out['logit_std']:.3f}); "
        f"{out['tokens_disagree']} of {out['tokens_compared']} greedy tokens "
        f"disagree" + (f"; routing choices that differ per layer "
                       f"{out['routing_flips_per_layer']} of "
                       f"{out['routing_choices']}, kept flags "
                       f"{out['kept_flips_per_layer']}" if cfg.n_experts else "")
        + f"; CPU {cpu_s:.1f}s")
    assert out["max_abs_drift"] <= LOGIT_TOL, out
    assert out["tokens_disagree_off_tie"] == 0, out
    return out


def _p14_solo(model, params, prompts, gen, max_len):
    """The port's own greedy loop, each request alone on the card."""
    import torch

    from repro_torch.launch.serve import generate

    return [generate(model, params, torch.as_tensor(p, device="cuda")[None].long(),
                     model.init_cache(1, max_len, device="cuda"), gen)[0].cpu().numpy()
            for p in prompts]


def _p14_cells(model, params, cfg, prompts, gens, max_len, tag):
    """The four serve cells, {sync, pipelined} x {dense, paged(PAGE)},
    logits captured: each equal to the sync dense one bit for bit."""
    from repro_torch.serve import Engine, ExecutionPolicy, paged

    cells = {}
    for execution in ("sync", "pipelined"):
        for paging in (None, paged(PAGE)):
            key = f"{execution} {'paged' if paging else 'dense'}"
            t1 = time.perf_counter()
            eng = Engine(model, params, max_len=max_len, max_slots=len(prompts),
                         policy=ExecutionPolicy.for_arch(cfg, execution=execution,
                                                         paging=paging),
                         pipeline_depth=4)
            assert not eng.merge_cohorts and eng.batch_align == 1
            outs, traces, counts, _, rids = _budget_serve(eng, prompts, gens,
                                                          f"{tag} {key}")
            _no_kernels(counts, f"{tag} {key}")
            assert eng.metrics.n_merges == 0
            cells[key] = (outs, traces, rids, eng.summary())
            del eng
            gc.collect()
            log(f"{tag} {key}: {cells[key][3]['total_tokens']} tokens, "
                f"{cells[key][3]['decode_batches']} decodes in "
                f"{time.perf_counter() - t1:.2f}s with logit capture")
    base = cells["sync dense"]
    for key, cell in cells.items():
        if key != "sync dense":
            _same_serve(f"{tag} {key} vs sync dense", cell, base)
    return base


def _p14_timed(model, params, cfg, prompts, gen, max_len, tag):
    """3 timed serves (no logit capture) and one profiled, as phase 13's:
    tok/s, TTFT p50, the decode stage per engine step (every one-row cohort
    decodes once a step) and per cohort's decode, the idle share, the top
    device ops."""
    import numpy as np

    from repro_torch.serve import Engine, ExecutionPolicy

    engine = Engine(model, params, max_len=max_len, max_slots=len(prompts),
                    policy=ExecutionPolicy.for_arch(cfg))
    want = engine.generate_batch(prompts, gen)
    timed = []
    for _ in range(TIMED_SERVES):
        engine.metrics.reset()
        again = engine.generate_batch(prompts, gen)
        for a, b in zip(again, want):
            np.testing.assert_array_equal(a, b)
        timed.append(engine.summary())
    tok_s = [t["throughput_tok_s"] for t in timed]
    s = timed[tok_s.index(statistics.median(tok_s))]
    res = {"tok_s": s["throughput_tok_s"], "ttft_s_p50": s["ttft_s_p50"],
           "wall_s": s["wall_s"], "stage_s": s["stage_s"],
           "decode_calls": s["decode_batches"],
           "decode_call_ms": 1e3 * s["stage_s"]["decode"] / s["decode_batches"],
           "decode_step_ms": 1e3 * s["stage_s"]["decode"] / (gen - 1),
           "tok_s_runs": tok_s,
           "ttft_s_p50_runs": [t["ttft_s_p50"] for t in timed]}
    log(f"{tag} timed serves (no logit capture): tok/s "
        f"{[round(x, 1) for x in tok_s]}, TTFT p50 ms "
        f"{[round(t['ttft_s_p50'] * 1e3, 1) for t in timed]}; decode step "
        f"{res['decode_step_ms']:.2f} ms ({len(prompts)} one-row cohorts), "
        f"{res['decode_call_ms']:.2f} ms a cohort's decode; stages "
        f"{json.dumps(s['stage_s'])}")
    res["profile"] = _p13_profile(engine, prompts, s["wall_s"], gen=gen)
    del engine
    gc.collect()
    return res


def _p14_calls(model, params, cfg):
    """Device launches of one prefill (4 x 128) and one decode step of the 4
    rows after it (`_launches_per_call`), and the (token, k) pairs capacity
    dropped in each, per layer (one cohort of 4 rows: capacity 1 at the
    decode for both archs)."""
    routes = []
    restore = _record_routes(routes)
    try:
        launches = _launches_per_call(model, params, cfg)
    finally:
        restore()
    L = cfg.n_layers
    assert len(routes) == 2 * L, len(routes)
    return {"launches": launches, "prefill_drops": _drops(routes[:L], L),
            "decode_drops": _drops(routes[L:], L)}


def _p14_spec_refused(model, params, cfg, tag):
    from repro_torch.serve import Engine, ExecutionPolicy, draft

    try:
        Engine(model, params, max_len=64, policy=ExecutionPolicy.for_arch(
            cfg, speculation=draft(ExecutionPolicy.for_arch(cfg), SPEC_K)))
    except ValueError as e:
        assert "capacity routing" in str(e), e
        log(f"{tag}: speculation refused: {e}")
        return str(e)
    raise AssertionError(f"{tag}: speculation was not refused")


def _p14_prompts(arch, cfg):
    """A served arch's prompts (numpy, from SEED), new tokens each, max_len
    (a multiple of PAGE), and the rng to draw more from."""
    import numpy as np

    lens, gen = ((P14A_PROMPTS, GEN) if arch == "phi3_5_moe" else
                 (P14B_PROMPTS, P14B_GEN))
    rng = np.random.default_rng(SEED + (24 if arch == "phi3_5_moe" else 25))
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
               for n in lens]
    return prompts, gen, -(-(max(lens) + gen) // PAGE) * PAGE, rng


def _p14_speed(arch):
    """14a / 14b's speeds, read once the CPU worker has ended: the served
    arch loaded again from SEED, `_p14_timed` on its prompts."""
    cfg, model, params = _p14_model(arch, P14_LAYERS[arch])
    prompts, gen, max_len, _ = _p14_prompts(arch, cfg)
    out = _p14_timed(model, params, cfg, prompts, gen, max_len,
                     "14a" if arch == "phi3_5_moe" else "14b")
    del params
    _free()
    return out


def _p14_phi():
    """14a: phi3.5-moe at published width, P14_LAYERS deep: the gates and
    the launch and drop counts (its speeds: `_p14_speed`)."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine, ExecutionPolicy

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params = _p14_model("phi3_5_moe", P14_LAYERS["phi3_5_moe"])
    torch.cuda.synchronize()
    log(f"14a {cfg.name} ({cfg.n_layers} of 32 layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts x d_ff {cfg.d_ff}, vocab {cfg.vocab}) init + "
        f"prepare on the card: {time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prompts, _, max_len, rng = _p14_prompts("phi3_5_moe", cfg)
    res = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "prompt_lens": list(P14A_PROMPTS), "gen": GEN}
    solo = _p14_solo(model, params, prompts, GEN, max_len)
    base = _p14_cells(model, params, cfg, prompts, [GEN] * len(prompts),
                      max_len, "14a")
    for i, (a, b) in enumerate(zip(base[0], solo)):
        np.testing.assert_array_equal(a, b, err_msg=f"14a request {i} vs solo")
    log(f"14a: every request's tokens equal the solo loop's, and the four "
        f"cells equal bit for bit (tokens and {len(prompts) * GEN} logit "
        f"vectors each); sample {base[0][0][:8].tolist()}")
    res["cells_bitwise"] = res["equals_solo"] = True
    # two same-length requests in one cohort, budgets 2 and 5: the
    # reference's test_pipelined_moe_clamps_window_and_keeps_identity
    pair = [prompts[2], rng.integers(0, cfg.vocab, size=(P14A_PROMPTS[2],)
                                     ).astype(np.int32)]
    got = {}
    for execution in ("sync", "pipelined"):
        eng = Engine(model, params, max_len=max_len, max_slots=2,
                     policy=ExecutionPolicy.for_arch(cfg, execution=execution),
                     pipeline_depth=4)
        if execution == "pipelined":
            assert eng.executor.depth == 1
        got[execution] = _budget_serve(eng, pair, [2, 5], f"14a pair {execution}")
        del eng
    _same_serve("14a pair pipelined (depth 4 -> 1) vs sync",
                (got["pipelined"][0], got["pipelined"][1], got["pipelined"][4]),
                (got["sync"][0], got["sync"][1], got["sync"][4]))
    log("14a: a same-length pair (budgets 2 and 5) in one cohort: pipelined "
        "(depth asked 4, clamped to 1) equals sync bit for bit")
    res["pair_pipelined_equals_sync"] = True
    res["speculation_refused"] = _p14_spec_refused(model, params, cfg, "14a")
    res["calls"] = _p14_calls(model, params, cfg)
    log(f"14a: device launches in one prefill (4 x {PROMPT}) "
        f"{res['calls']['launches']['prefill']}, one decode step of 4 rows "
        f"{res['calls']['launches']['decode']}; capacity dropped "
        f"{res['calls']['prefill_drops']['dropped']} of "
        f"{res['calls']['prefill_drops']['pairs']} (token, k) pairs in the "
        f"prefill (per layer {res['calls']['prefill_drops']['dropped_per_layer']}), "
        f"{res['calls']['decode_drops']['dropped']} of "
        f"{res['calls']['decode_drops']['pairs']} in the decode step")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params
    _free()
    return res


def _p14_mixtral():
    """14b: mixtral-8x22b at published width, P14_LAYERS deep, through its
    ring cache: the gates, the ring witness, the launch and drop counts."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = _p14_model("mixtral_8x22b", P14_LAYERS["mixtral_8x22b"])
    torch.cuda.synchronize()
    log(f"14b {cfg.name} ({cfg.n_layers} of 56 layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts x d_ff {cfg.d_ff}, window {cfg.window}, vocab "
        f"{cfg.vocab}) init + prepare on the card: {time.perf_counter() - t0:.2f}s,"
        f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prompts, _, max_len, _ = _p14_prompts("mixtral_8x22b", cfg)
    gens = [P14B_GEN] * len(prompts)
    assert model.init_cache(1, max_len, device="cuda")["k"].shape[2] == cfg.window
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "window": cfg.window,
           "prompt_lens": list(P14B_PROMPTS), "gen": P14B_GEN, "max_len": max_len}
    t1 = time.perf_counter()
    solo = _p14_solo(model, params, prompts, P14B_GEN, max_len)
    log(f"14b solo loop: {time.perf_counter() - t1:.2f}s")
    base = _p14_cells(model, params, cfg, prompts, gens, max_len, "14b")
    for i, (a, b) in enumerate(zip(base[0], solo)):
        np.testing.assert_array_equal(a, b, err_msg=f"14b request {i} vs solo")
    log(f"14b: both requests' tokens equal the solo loop's, the four cells "
        f"equal bit for bit; sample {base[0][1][:8].tolist()}")
    res["cells_bitwise"] = res["equals_solo"] = True
    res["ring_witness"] = _p14_ring_witness(model, params, cfg, prompts, base,
                                            max_len)
    res["calls"] = _p14_calls(model, params, cfg)
    log(f"14b: device launches in one prefill (4 x {PROMPT}) "
        f"{res['calls']['launches']['prefill']}, one decode step of 4 rows "
        f"{res['calls']['launches']['decode']}; capacity dropped "
        f"{res['calls']['prefill_drops']['dropped']} of "
        f"{res['calls']['prefill_drops']['pairs']} pairs in the prefill, "
        f"{res['calls']['decode_drops']['dropped']} of "
        f"{res['calls']['decode_drops']['pairs']} in the decode step")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params
    _free()
    return res


def _p14_ring_witness(model, params, cfg, prompts, base, max_len):
    """Each served request again through a full-length cache (no ring, no
    wrap), teacher-forced with its served tokens: under the sliding-window
    mask the same computation but for the order of the attention's sums.
    Logits within LOGIT_TOL of the served ones; the greedy tokens that
    differ are reported."""
    import numpy as np
    import torch

    outs, traces, rids = base[:3]
    diffs, differ = [], 0
    with torch.no_grad():
        for p, toks, rid in zip(prompts, outs, rids):
            cache = model.init_cache(1, max_len, device="cuda", full=True)
            assert cache["k"].shape[2] == max_len
            logits, cache = model.prefill(
                params, {"tokens": torch.as_tensor(p, device="cuda")[None].long()},
                cache)
            steps = [logits[0, -1]]
            for t in toks[:-1]:
                logits, cache = model.decode(
                    params, torch.full((1, 1), int(t), device="cuda",
                                       dtype=torch.long), cache)
                steps.append(logits[0, -1])
            full = torch.stack(steps).float().cpu().numpy()
            diffs.append(float(np.abs(full - traces[rid]).max()))
            differ += int((full.argmax(-1) != np.asarray(toks)).sum())
    out = {"max_abs_logit_diff": max(diffs), "per_request": diffs,
           "tokens_differ": differ, "tokens": int(sum(len(o) for o in outs))}
    log(f"14b ring witness: the served logits against a full-length cache's "
        f"(same requests, teacher-forced): max |diff| {out['max_abs_logit_diff']:.3e}"
        f" (per request {[round(d, 5) for d in diffs]}), {differ} of "
        f"{out['tokens']} greedy tokens differ")
    assert out["max_abs_logit_diff"] <= LOGIT_TOL, out
    return out


def _p14_llava():
    """14d: llava-next-mistral-7b at published width and depth: prefill 2 x
    (576 image + 64 text positions), then 16 greedy decodes."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params = _p14_model("llava_next_mistral_7b")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 26)
    S = cfg.n_img_tokens + P14D_LLAVA_TEXT
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, S)),
                                       device="cuda").long(),
             "img_embed": torch.as_tensor(rng.standard_normal(
                 (2, cfg.n_img_tokens, cfg.d_model), dtype=np.float32), device="cuda")}
    times, logits_all = [], []
    with torch.no_grad():
        for _ in range(2):   # the first call warms the allocator and cuBLAS
            cache = model.init_cache(2, S + P14D_LLAVA_DECODES, device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = model.prefill(params, batch, cache)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        steps = [logits[:, -1]]
        t1 = time.perf_counter()
        for _ in range(P14D_LLAVA_DECODES - 1):
            logits, cache = model.decode(params, steps[-1].argmax(-1)[:, None], cache)
            steps.append(logits[:, -1])
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t1
        got = torch.stack(steps, 1).float().cpu().numpy()
    assert got.shape == (2, P14D_LLAVA_DECODES, cfg.vocab) and np.isfinite(got).all()
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "init_s": init_s,
           "prefill_s": times[1], "prefill_s_first": times[0],
           "decode_step_ms": 1e3 * dec_s / (P14D_LLAVA_DECODES - 1),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "tokens": got.argmax(-1).tolist()}
    log(f"14d {cfg.name} ({cfg.n_layers} layers, published width): init + "
        f"prepare {init_s:.2f}s; prefill 2 x ({cfg.n_img_tokens} image + "
        f"{P14D_LLAVA_TEXT} text) {1e3 * times[1]:.2f} ms (first call "
        f"{1e3 * times[0]:.2f} ms), {P14D_LLAVA_DECODES - 1} greedy decodes "
        f"{res['decode_step_ms']:.2f} ms each; logits finite; peak "
        f"{res['peak_gib']:.2f} GiB")
    del params, cache
    _free()
    return res


def _p14_hubert():
    """14d: hubert-xlarge at published width and depth: an encoder prefill
    of 4 x 1024 frames, then train steps (AdamW, its optimizer)."""
    import numpy as np
    import torch

    from repro_torch.data import SyntheticLMData, batch_to_torch
    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model
    from repro_torch.train import init_train_state, make_train_step

    torch.cuda.reset_peak_memory_stats()
    cfg = build_config("hubert_xlarge", smoke=False, spiking=False,
                       weight_density=1.0)
    assert cfg.optimizer == "adamw" and cfg.encoder_only
    model = build_model(cfg)
    state = init_train_state(model, SEED, device="cuda")
    data = SyntheticLMData(cfg, seq_len=P14D_HUBERT_FRAMES,
                           global_batch=P14D_HUBERT_BATCH)
    batch = batch_to_torch(data.batch(0), "cuda")
    prepared = model.prepare(state["params"])
    with torch.no_grad():
        model.prefill(prepared, {"frames": batch["frames"]}, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, none = model.prefill(prepared, {"frames": batch["frames"]}, None)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    assert none is None and logits.shape == (P14D_HUBERT_BATCH, 1, cfg.vocab)
    assert torch.isfinite(logits).all()
    del prepared
    step_fn = make_train_step(model)
    times, losses, gnorms = [], [], []
    for _ in range(2):   # the first step warms the allocator and cuBLAS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    assert np.isfinite(losses).all() and np.isfinite(gnorms).all(), (losses, gnorms)
    res = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "prefill_s": prefill_s, "frames": [P14D_HUBERT_BATCH, P14D_HUBERT_FRAMES],
           "train_step_s": times[1], "train_step_s_first": times[0],
           "losses": losses, "grad_norms": gnorms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"14d {cfg.name} ({cfg.n_layers} layers, published width): encoder "
        f"prefill {P14D_HUBERT_BATCH} x {P14D_HUBERT_FRAMES} frames "
        f"{1e3 * prefill_s:.2f} ms; train step (AdamW) {1e3 * times[1]:.1f} ms "
        f"(first {1e3 * times[0]:.1f} ms), losses {[round(x, 4) for x in losses]},"
        f" grad norms {[round(x, 4) for x in gnorms]}; peak "
        f"{res['peak_gib']:.2f} GiB")
    del state, batch
    _free()
    return res


def phase_moe_frontends():
    """14: phi3.5-moe and mixtral-8x22b served (a, b), card vs CPU on
    depth-cut copies of all four archs (c), llava and hubert at full depth
    (d).  The CPU side of 14c runs in a spawned process (which draws its
    params on the card) beside the untimed gates of 14a-c alone; every
    speed is read after it has ended, with the host and the card to this
    process."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    res = {}
    with ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = {a: pool.submit(_p14_cpu_worker, a) for a in P14_CPU_CASES}
        for key, fn in (("phi3_5_moe", _p14_phi), ("mixtral_8x22b", _p14_mixtral)):
            t1 = time.perf_counter()
            res[key] = fn()
            res[key]["gate_seconds"] = time.perf_counter() - t1
            log(f"14 {key} gates done in {res[key]['gate_seconds']:.1f}s")
        t1 = time.perf_counter()
        res["card_vs_cpu"] = {a: _p14_card_vs_cpu(a, f) for a, f in futures.items()}
        log(f"14c done in {time.perf_counter() - t1:.1f}s")
    log(f"14: the CPU worker has ended at +{time.perf_counter() - t0:.1f}s; "
        f"the speeds follow")
    for key in ("phi3_5_moe", "mixtral_8x22b"):
        t1 = time.perf_counter()
        res[key]["serve"] = _p14_speed(key)
        res[key]["speed_seconds"] = time.perf_counter() - t1
    for key, fn in (("llava_next_mistral_7b", _p14_llava),
                    ("hubert_xlarge", _p14_hubert)):
        t1 = time.perf_counter()
        res[key] = fn()
        res[key]["seconds"] = time.perf_counter() - t1
        log(f"14 {key} done in {res[key]['seconds']:.1f}s")
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 14 in {res['seconds']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phase 15: the paper's SNN track
# ---------------------------------------------------------------------------

P15_LAYERS = ("A-L4", "V-L8", "R-L19", "T-HFF")
P15_REPS = 30      # timed calls of each kernel and yardstick (median)
P15_NET_REPS = 10  # timed launches of each network layer
# the drawn operands against Table II: silent fraction, per-timestep density
P15_SILENT_TOL, P15_DENSITY_TOL = 0.01, 0.02
# the LTH example at a few steps: 2 rounds of 40 leave a hidden layer that
# still fires (at 1 round of 20 every hidden neuron is silent)
P15_LTH = {"steps": 40, "rounds": 2, "density": 0.05}


def _p15_operands(gen, layer):
    """Packed words and raw f32 weights at one workload layer's sparsity,
    drawn on ``gen``'s device (the card) with exact counts: round(ns M K)
    neurons are non-silent; each fires at one random timestep, and
    round(d_a T M K) less that many further spikes fall on random free
    (neuron, timestep) slots of the non-silent ones, so that the silent
    fraction and the per-timestep density are the layer's up to rounding
    (where ns / T <= d_a <= ns; else the density is clipped, and the gate
    beside the draw fails).  Returns (words, normal weights (K, N),
    measured sparsity beside the table's)."""
    import torch

    from repro_torch.core.packing import pack_spikes

    Tl, M, N, K = layer.T, layer.M, layer.N, layer.K
    dev = gen.device
    n = M * K
    n_live = round(layer.ns * n)
    neuron = torch.randperm(n, generator=gen, device=dev)[:n_live]
    first = torch.randint(0, Tl, (n_live,), generator=gen, device=dev)
    fire = torch.arange(Tl, device=dev)[None] == first[:, None]  # (n_live, T)
    free = (~fire).flatten().nonzero().flatten()
    extra = min(max(0, round(layer.d_a * Tl * n) - n_live), free.numel())
    pick = free[torch.randperm(free.numel(), generator=gen, device=dev)[:extra]]
    fire.view(-1)[pick] = True
    planes = torch.zeros((Tl, n), dtype=torch.bool, device=dev)
    planes[:, neuron] = fire.T
    planes = planes.reshape(Tl, M, K)
    words = pack_spikes(planes)
    w32 = torch.randn((K, N), generator=gen, device=dev)
    stats = {"silent": float((words == 0).float().mean()), "table_silent": 1 - layer.ns,
             "density": float(planes.float().mean()), "table_density": layer.d_a}
    return words, w32, stats


def _p15_held(label, stats):
    """The drawn operands' sparsity against the layer's."""
    assert abs(stats["silent"] - stats["table_silent"]) <= P15_SILENT_TOL, (label, stats)
    assert abs(stats["density"] - stats["table_density"]) <= P15_DENSITY_TOL, (
        label, stats)


def _p15_prune(w32, d_b, block=None):
    import torch

    from repro_torch.core.snn_layers import prune_by_magnitude

    return prune_by_magnitude(w32, d_b, block=block).to(torch.bfloat16)


def _p15_shares(words, w, args):
    """The joined-block share of one kernel-3 call (spike-active joined
    slots over all (row tile, column block, k block) triples), the plan's
    live weight-block share, and the share of the dense MACs whose word and
    weight are both non-zero."""
    import torch

    a, payload, kidx, vidx, cnt, act = args[:6]
    nm, nkb = act.shape
    nnb, jmax = kidx.shape
    live = torch.arange(jmax, device=a.device)[None] < cnt[:, None]
    joined = int(((act[:, kidx.long()] > 0) & live[None]).sum())
    M, K = words.shape
    nz = ((words != 0).sum(0).double() * (w != 0).sum(1).double()).sum()
    return {"joined_block_share": joined / (nm * nnb * nkb),
            "weight_block_share": int(cnt.sum()) / (nkb * nnb),
            "nonzero_mac_share": float(nz) / (M * K * w.shape[1])}


def _p15_args(words, plan, n_out, Tl):
    from repro_torch.kernels import ftp_spmm, ops

    bm = ftp_spmm.pick_bm(words.shape[0], Tl)
    return bm, (words, plan.payload, plan.kidx, plan.vidx, plan.cnt,
                ops._activity(words, bm, plan), n_out, Tl)


def _p15_plan(w):
    """The per-call plan, built as `ops.dispatch` builds it, with the
    host time of the build (best of 3)."""
    import torch

    from repro_torch.kernels.join_plan import build_weight_plan

    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = build_weight_plan(w)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return plan, best


def _p15_only(counts, want, label):
    got = {k: v for k, v in counts.items() if v}
    assert got == want, f"{label}: launches {got}, expected {want}"


def _p15_layer(name, gen, flush):
    """15a: one Table II layer through kernel 3's per-call route (fused
    and unfused), held against the FTP and sequential yardsticks; kernels 1
    and 2 on the same operands; times and shares."""
    import torch

    from repro_torch.configs.snn_workloads import get_snn_workload
    from repro_torch.core.ftp import ftp_spmspm, sequential_spmspm
    from repro_torch.kernels import ftp_spmm, ops
    from repro_torch.serve.policy import PACKED_DUAL

    layer = get_snn_workload(name)
    Tl, M, N, K = layer.T, layer.M, layer.N, layer.K
    words, w32, stats = _p15_operands(gen, layer)
    _p15_held(name, stats)
    w = _p15_prune(w32, layer.d_b)
    plan, build_s = _p15_plan(w)
    bm, args = _p15_args(words, plan, N, Tl)
    inst = _bsr_instance(args)
    (fused, full), counts = _counted(f"15a {name} per-call route", lambda: (
        ops.dispatch(words, w, PACKED_DUAL, Tl, fuse_lif=True),
        ops.dispatch(words, w, PACKED_DUAL, Tl, fuse_lif=False)))
    _p15_only(counts, {"ftp_bsr": 2, f"ftp_bsr_{inst}": 2}, name)
    o_ftp = ftp_spmspm(words, w, Tl)
    o_seq = sequential_spmspm(words, w, Tl)
    torch.cuda.synchronize()
    seq_err = float((o_seq - o_ftp).abs().max())
    assert seq_err <= TOL, f"{name}: sequential vs FTP {seq_err:.3e}"
    err, flips = _hold(f"15a {name} kernel 3 fused", *fused, o_ftp, True)
    err = max(err, _hold(f"15a {name} kernel 3", full[0], full[1], o_ftp, False)[0],
              _hold(f"15a {name} kernel 3 vs sequential", full[0], full[1], o_seq,
                    False)[0])
    assert not bool(full[1].any()), f"{name}: U must be zero without the LIF"
    (d_full, d_fused), dcounts = _counted(f"15a {name} kernels 1-2", lambda: (
        _dense_call(words, w, Tl, False), _dense_call(words, w, Tl, True)))
    dinst = f"ftp_dense_{_dense_instance(w)}"
    _p15_only(dcounts, {"ftp_spmm": 1, "ftp_spmm_fused_lif": 1, dinst: 2}, name)
    d_err = max(_hold(f"15a {name} kernel 1", d_full[0], None, o_ftp, False)[0],
                _hold(f"15a {name} kernel 2", *d_fused, o_ftp, True)[0])
    row = {"case": name, "T": Tl, "M": M, "N": N, "K": K, **stats,
           "d_b": layer.d_b, "weight_density": float((w != 0).float().mean()),
           "ns_d_b": layer.ns * layer.d_b, "instance": inst,
           "plan_blocks": [plan.bk, plan.bn], "plan_build_s": build_s,
           "max_abs_err": err, "flips": flips, "dense_max_abs_err": d_err,
           "sequential_vs_ftp": seq_err, **_p15_shares(words, w, args)}
    row.update(_measure(args, bm, True, flush, w, P15_REPS))
    row["k1_ms"] = _time_ms(lambda: ftp_spmm.ftp_spmm(words, w, Tl), P15_REPS, flush)
    row["k2_ms"] = _time_ms(lambda: ftp_spmm.ftp_spmm_fused_lif(words, w, Tl),
                            P15_REPS, flush)
    row["k1_plain_ms"] = _time_ms(lambda: ftp_spmm.ftp_spmm_plain(words, w, Tl),
                                  max(1, P15_REPS // 5), flush)
    row["k2_plain_ms"] = _time_ms(
        lambda: ftp_spmm.ftp_spmm_fused_lif_plain(words, w, Tl),
        max(1, P15_REPS // 5), flush)
    row["k1_bound_ms"] = _bound_dense(words, w, Tl, False)[0]
    row["k2_bound_ms"] = _bound_dense(words, w, Tl, True)[0]
    row["ftp_ms"] = _time_ms(lambda: ftp_spmspm(words, w, Tl), P15_REPS, flush)
    row["sequential_ms"] = _time_ms(lambda: sequential_spmspm(words, w, Tl),
                                    P15_REPS, flush)
    log(f"15a {name} (T {Tl}, M {M}, N {N}, K {K}): silent {stats['silent']:.4f} "
        f"(Table II {stats['table_silent']:.4f}), density {stats['density']:.4f} "
        f"({stats['table_density']:.4f}); {inst}, plan {plan.bk}x{plan.bn} built in "
        f"{build_s * 1e3:.2f} ms; joined blocks {row['joined_block_share']:.4f}, "
        f"non-zero MACs {row['nonzero_mac_share']:.5f} (ns d_b "
        f"{row['ns_d_b']:.5f}); err {err:.3e}, flips {flips}, dense err "
        f"{d_err:.3e}{_fmt(row)}, kernel 1 {row['k1_ms']:.4f} ms (plain "
        f"{row['k1_plain_ms']:.4f}, bound {row['k1_bound_ms']:.4f}), kernel 2 "
        f"{row['k2_ms']:.4f} ms (plain {row['k2_plain_ms']:.4f}, bound "
        f"{row['k2_bound_ms']:.4f}), ftp "
        f"{row['ftp_ms']:.4f} ms, sequential {row['sequential_ms']:.4f} ms")
    extra = {}
    if name == "T-HFF":
        extra = _p15_thff(gen, words, w, w32, layer, fused, full, flush)
    return row, extra, {"k3": counts["ftp_bsr"], "k1": dcounts["ftp_spmm"],
                        "k2": dcounts["ftp_spmm_fused_lif"]}


def _p15_thff(gen, words, w, w32, layer, fused, full, flush):
    """15a, T-HFF also: kernel 4 (adaptive_t(1)) == kernel 3 bit for bit,
    on the layer's words and on words with plane 0 cleared (both kernels
    timed there); the same weights block-pruned (128 x 128) at the same
    density: the join skips."""
    import torch

    from repro_torch.core.ftp import ftp_spmspm
    from repro_torch.core.packing import timestep_activity_map
    from repro_torch.kernels import ftp_spmm, ops
    from repro_torch.serve.policy import PACKED_DUAL, PACKED_DUAL_ADAPTIVE

    Tl, N = layer.T, layer.N
    cleared = words & ~1

    def adaptive():
        return [ops.dispatch(a, w, PACKED_DUAL_ADAPTIVE, Tl, fuse_lif=f)
                for a in (words, cleared) for f in (True, False)]

    got, counts = _counted("15a T-HFF adaptive_t(1)", adaptive)
    assert counts["ftp_bsr_adaptive"] == 4 and counts["ftp_bsr"] == 0, counts
    want = [fused, full] + [ops.dispatch(cleared, w, PACKED_DUAL, Tl, fuse_lif=f)
                            for f in (True, False)]
    for (c, u), (cw, uw) in zip(got, want):
        assert torch.equal(c, cw) and torch.equal(u, uw), "kernel 4 != kernel 3"
    plan, _ = _p15_plan(w)
    bm, args = _p15_args(cleared, plan, N, Tl)
    tmap = timestep_activity_map(cleared, Tl).to(torch.int32)
    ad = _measure(args, bm, True, flush, w, P15_REPS, tmap)
    ad["k3_ms"] = _time_ms(lambda: ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=True),
                           P15_REPS, flush)
    log(f"15a T-HFF, plane 0 silent: kernel 4 {ad['ms']:.4f} ms, kernel 3 "
        f"{ad['k3_ms']:.4f} ms{_fmt(ad)}")
    wb = _p15_prune(w32, layer.d_b, block=(128, 128))
    plan, build_s = _p15_plan(wb)
    bm, args = _p15_args(words, plan, N, Tl)
    (c, u), bcounts = _counted("15a T-HFF block-pruned per-call route",
                               lambda: ops.dispatch(words, wb, PACKED_DUAL, Tl,
                                                    fuse_lif=True))
    inst = _bsr_instance(args)
    _p15_only(bcounts, {"ftp_bsr": 1, f"ftp_bsr_{inst}": 1}, "T-HFF block")
    err, flips = _hold("15a T-HFF block-pruned", c, u, ftp_spmspm(words, wb, Tl), True)
    row = {"case": "T-HFF block-pruned 128x128", "instance": inst,
           "weight_density": float((wb != 0).float().mean()), "plan_build_s": build_s,
           "max_abs_err": err, "flips": flips, **_p15_shares(words, wb, args)}
    row.update(_measure(args, bm, True, flush, wb, P15_REPS))
    log(f"15a T-HFF block-pruned: joined blocks {row['joined_block_share']:.4f}, "
        f"weight blocks {row['weight_block_share']:.4f}, err {err:.3e}, flips "
        f"{flips}{_fmt(row)}")
    return {"block_pruned": row, "adaptive_equal_bitwise": True,
            "adaptive_plane0_silent": ad, "k4": counts["ftp_bsr_adaptive"],
            "k3": bcounts["ftp_bsr"]}


def _p15_network(name, gen, flush):
    """15b: every layer of one network at its im2col GEMM shape, its
    operands held to its sparsity as in 15a, through kernel 3 (fused LIF,
    per-call route), held against the FTP yardstick; each layer's launch
    timed on a prebuilt plan beside its plain version, the library matmul
    and its bound, summed per network."""
    from repro_torch.core.ftp import ftp_spmspm
    from repro_torch.kernels import ops
    from repro_torch.kernels.join_plan import build_weight_plan
    from repro_torch.serve.policy import PACKED_DUAL
    from repro_torch.sim.workloads import get_network

    net = get_network(name)
    ops_in = [(layer, *_p15_operands(gen, layer)) for layer in net.layers]
    for layer, _, _, stats in ops_in:
        _p15_held(f"15b {name} {layer.name}", stats)
    ops_in = [(layer, words, _p15_prune(w32, layer.d_b), stats)
              for layer, words, w32, stats in ops_in]
    outs, counts = _counted(f"15b {name}", lambda: [
        ops.dispatch(words, w, PACKED_DUAL, layer.T, fuse_lif=True)
        for layer, words, w, _ in ops_in])
    assert counts["ftp_bsr"] == len(net.layers), counts
    rows, err = [], 0.0
    for (layer, words, w, stats), (c, u) in zip(ops_in, outs):
        bm, args = _p15_args(words, build_weight_plan(w), layer.N, layer.T)
        e, flips = _hold(f"15b {name} {layer.name}", c, u,
                         ftp_spmspm(words, w, layer.T), True)
        err = max(err, e)
        rows.append({"layer": layer.name, "shape": [layer.T, layer.M, layer.N, layer.K],
                     **_measure(args, bm, True, flush, w, P15_NET_REPS),
                     "max_abs_err": e, "flips": flips, **stats, "d_b": layer.d_b,
                     **_p15_shares(words, w, args)})
    res = {"layers": rows, "n_layers": len(rows),
           "simt_layers": counts["ftp_bsr_simt"], "tc_layers": counts["ftp_bsr_tc"],
           **{key: sum(r[key] for r in rows)
              for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
           "max_abs_err": err, "k3": counts["ftp_bsr"]}
    log(f"15b {name}: {len(rows)} layers ({res['simt_layers']} SIMT, "
        f"{res['tc_layers']} tc), kernel 3 {res['ms']:.4f} ms in all, plain "
        f"{res['plain_ms']:.4f} ms, matmul {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms, max err {err:.3e}")
    return res


def _p15_lth(device="cuda"):
    """15c: the LTH example's functions on the card at a few steps."""
    import importlib.util

    from repro_torch.core.snn_layers import assert_weight_density

    path = os.path.join(ROOT, "examples", "train_snn_lth_torch.py")
    spec = importlib.util.spec_from_file_location("train_snn_lth_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    out, _ = _counted("15c LTH", lambda: mod.run(**P15_LTH, device=device,
                                                 log=lambda m: log(f"15c {m}")))
    assert math.isfinite(out["loss"]) and math.isfinite(out["loss_ft"]), out
    for w in out["weights"].values():
        assert_weight_density(w, out["density"], tol=1e-6)
    assert out["silent"] < 1.0, "the trained hidden layer is all silent"
    assert out["silent_ft"] >= out["silent"], (out["silent"], out["silent_ft"])
    res = {k: v for k, v in out.items() if k != "weights"}
    res["seconds"] = time.perf_counter() - t0
    return res


def phase_snn_track(device="cuda"):
    """15: the four Table II layers (a), the three networks (b) and the
    LTH example (c).  Returns the phase's results, with the launches of
    kernels 1-4 on its paths."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    flush = _flush_buffer()
    res = {"layers": [], "networks": {}}
    launches = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    for name in P15_LAYERS:
        row, extra, n = _p15_layer(name, gen, flush)
        res["layers"].append(row)
        if extra:
            res["thff"] = extra
            n = dict(n, k3=n["k3"] + extra["k3"], k4=extra["k4"])
        for k, v in n.items():
            launches[k] += v
    log(f"15a done in {time.perf_counter() - t0:.1f}s")
    for name in ("alexnet", "vgg16", "resnet19"):
        res["networks"][name] = _p15_network(name, gen, flush)
        launches["k3"] += res["networks"][name]["k3"]
    log(f"15b done in {time.perf_counter() - t0:.1f}s")
    del flush
    torch.cuda.empty_cache()
    res["lth"] = _p15_lth(device)
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 15 in {res['seconds']:.1f}s, launches {launches}")
    return res


# ---------------------------------------------------------------------------
# phase 16: the dry run and the roofline on the card, and the examples
# ---------------------------------------------------------------------------

P16_BUDGET_S = 90
P16_FIT_SHARE = 0.9     # (b): the share of the card a dry-run total may fill
P16_WORKERS = 6         # (a): processes counting the dry runs' points
P16_FFN_STEPS = 40      # (d): spiking_ffn_llm_torch's steps


def _p16_cells():
    """(a)'s cells: every decode and train cell, and llama3.2-1b's prefill."""
    from repro_torch.launch.specs import runnable_cells

    return ([(a, s) for a, s in runnable_cells() if s != "prefill_32k"]
            + [("llama3_2_1b", "prefill_32k")])


def _p16_row(rec):
    r, st, mem = rec["roofline"], rec["op_stats"], rec["memory"]
    return {"arch": rec["arch"], "shape": rec["shape"],
            "mem_gib": mem["total_bytes"] / 2**30, "fits": rec["fits"],
            "flops": st["flops"], "bytes": st["bytes_accessed"],
            "t_comp_s": r["t_comp_s"], "t_mem_s": r["t_mem_s"],
            "t_coll_s": r["t_coll_s"], "bottleneck": r["bottleneck"],
            "roofline_fraction": r["roofline_fraction"],
            "repeats": st["repeats"], "count_s": rec["count_s"]}


def _p16_step_ms(fn, reps=3):
    """Median device-clock ms of ``fn()`` over ``reps`` calls after one
    warm-up (CUDA events around each call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _p16_on_card(rec, name):
    """(b): one dry-run cell run for real at full size: counted flops and
    bytes equal the dry run's, the step timed, the memory compared."""
    import torch

    from repro_torch.launch.specs import build_cell
    from repro_torch.roofline import count
    from repro_torch.roofline.report import roofline_from_record

    arch, shape = rec["arch"], rec["shape"]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cell = build_cell(arch, shape, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the args stay, init's transients go
    st = count(cell.fn, *cell.args)
    want = rec["op_stats"]
    assert (st.flops, st.bytes_accessed) == (want["flops"], want["bytes_accessed"]), (
        arch, shape, st.flops, want["flops"], st.bytes_accessed, want["bytes_accessed"])
    assert st.flops_by_dtype == want["flops_by_dtype"], (st.flops_by_dtype,
                                                          want["flops_by_dtype"])
    ms = _p16_step_ms(lambda: cell.fn(*cell.args))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    roof = roofline_from_record(dict(rec, device=name))
    row = {"arch": arch, "shape": shape, "flops": st.flops,
           "bytes": st.bytes_accessed, "step_ms": ms,
           "roofline_ms": roof["t_total_us"] / 1e3,
           "share_of_roofline": roof["t_total_us"] / 1e3 / ms,
           "roofline_fraction": roof["roofline_fraction"],
           "roofline_fraction_measured": roof["roofline_fraction"]
           * roof["t_total_us"] / 1e3 / ms,
           "max_memory_allocated_gib": peak / 2**30,
           "memory_over_dry_run": peak / rec["memory"]["total_bytes"]}
    log(f"16b {arch} x {shape} on the card: counted flops {st.flops:.4e} and bytes "
        f"{st.bytes_accessed:.4e} == the dry run's; step {ms:.3f} ms against a "
        f"roofline of {row['roofline_ms']:.4f} ms ({roof['bottleneck']}); "
        f"roofline_fraction {row['roofline_fraction_measured']:.4g} measured "
        f"({roof['roofline_fraction']:.4g} at the roofline); max_memory_allocated "
        f"{row['max_memory_allocated_gib']:.3f} GiB = "
        f"{row['memory_over_dry_run']:.3f} x the dry run's")
    del cell
    torch.cuda.empty_cache()
    return row


def _p16_main_path(name):
    """(c): phase 5's llama3.2-1b under PACKED_DUAL, one 4-row decode step
    and one 4 x 128 prefill counted (kernel 3 by its work formula) and
    timed against their roofline times."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import ftp_spmm
    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model
    from repro_torch.roofline import attribution_summary
    from repro_torch.roofline.report import model_flops_for, roofline_from_record
    from repro_torch.serve import Engine, ExecutionPolicy

    cfg = dataclasses.replace(build_config("llama3_2_1b", smoke=False, spiking=True,
                                           weight_density=0.3), n_layers=LLAMA_LAYERS)
    model = build_model(cfg)
    engine = Engine(model, model.init(SEED, device="cuda"), max_len=PROMPT + GEN,
                    max_slots=REQUESTS, policy=ExecutionPolicy.for_arch(cfg))
    params, mode = engine.params, engine.spiking_mode
    assert mode == "infer"
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, size=(REQUESTS, PROMPT)),
                              device="cuda").long()
    cache = model.init_cache(REQUESTS, PROMPT + GEN, device="cuda")
    _, cache = model.prefill(params, {"tokens": prompts}, cache, spiking_mode=mode)
    token = torch.zeros((REQUESTS, 1), dtype=torch.long, device="cuda")
    steps = {
        "decode": (lambda: model.decode(params, token, cache, spiking_mode=mode),
                   ShapeCell("decode_4", PROMPT + GEN, REQUESTS, "decode")),
        "prefill": (lambda: model.prefill(
            params, {"tokens": prompts},
            model.init_cache(REQUESTS, PROMPT + GEN, device="cuda"),
            spiking_mode=mode), ShapeCell("prefill_4x128", PROMPT, REQUESTS, "prefill")),
    }
    out = {}
    for label, (fn, cell) in steps.items():
        before = ftp_spmm.launch_counts()
        summary = attribution_summary(fn)
        torch.cuda.synchronize()
        after = ftp_spmm.launch_counts()
        k3 = summary["kernels"]["ftp_bsr"]
        launched = after["ftp_bsr"] - before["ftp_bsr"]
        assert k3["calls"] == launched == 2 * cfg.n_layers, (k3, launched)
        assert after["ftp_bsr_tc"] - before["ftp_bsr_tc"] == launched
        assert set(summary["kernels"]) == {"ftp_bsr"}, summary["kernels"]
        ms = _p16_step_ms(fn)
        _, busy_s, top = _device_busy(fn)
        rec = {"device": name, "op_stats": summary, "model_flops": model_flops_for(cfg, cell),
               "cell": dataclasses.asdict(cell),
               "memory": {"total_bytes": torch.cuda.max_memory_allocated()}}
        roof = roofline_from_record(rec)
        t_roof = roof["t_total_us"] / 1e3
        out[label] = dict(
            summary, step_ms=ms, device_busy_ms=busy_s * 1e3, roofline_ms=t_roof,
            bottleneck=roof["bottleneck"], roofline_fraction=roof["roofline_fraction"],
            share_of_roofline=t_roof / ms, busy_share_of_roofline=t_roof / (busy_s * 1e3),
            kernel3_share_of_bytes=k3["bytes"] / summary["bytes_accessed"],
            kernel3_launches=launched, top_device_ops=[(n, t * 1e3) for n, t in top[:5]])
        log(f"16c {label}: {summary['flops']:.4e} flops ({summary['flops_by_dtype']}), "
            f"{summary['bytes_accessed']:.4e} bytes, intensity "
            f"{summary['arithmetic_intensity']:.2f}; kernel 3 {launched} calls == "
            f"launches, {k3['flops']:.4e} ops / {k3['bytes']:.4e} bytes by its formula; "
            f"step {ms:.3f} ms (device busy {busy_s * 1e3:.3f} ms) against a roofline of "
            f"{t_roof:.4f} ms ({roof['bottleneck']}): {t_roof / ms:.4f} of the step")
    del engine, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _p16_example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _p16_examples():
    """(d): the three examples on the card."""
    t0 = time.perf_counter()
    res = {}
    served = _p16_example("serve_llm_torch").main([])
    res["serve_llm"] = {r["arch"]: {"tokens": int(r["summary"]["total_tokens"]),
                                    "merges": int(r["summary"]["cohort_merges"])}
                        for r in served}
    assert all(r["merges"] >= 1 and r["tokens"] == 48 for r in res["serve_llm"].values())
    dvs = _p16_example("serve_dvs_torch").run()  # asserts incremental == one-shot
    res["serve_dvs"] = {"identical": True,
                        "timesteps_skipped": int(dvs["summary"]["timesteps_skipped"])}
    losses = _p16_example("spiking_ffn_llm_torch").run(steps=P16_FFN_STEPS)["losses"]
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0], losses
    res["spiking_ffn_llm"] = {"steps": P16_FFN_STEPS, "loss_first": losses[0],
                              "loss_last": losses[-1]}
    res["seconds"] = time.perf_counter() - t0
    log(f"16d examples on the card in {res['seconds']:.1f}s: {json.dumps(res)}")
    return res


def phase_roofline(smi):
    """16: (a) the dry runs in spawned processes while (d) runs on the card,
    then (c) and (b).  Returns the phase's results."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    import torch

    from repro_torch.launch import dryrun
    from repro_torch.roofline.report import device_peaks, parse_smi

    t0 = time.perf_counter()
    name, watts = parse_smi(smi)
    device_peaks(name)  # a card without the table's numbers fails here
    cells = _p16_cells()
    with ProcessPoolExecutor(max_workers=P16_WORKERS, mp_context=multiprocessing.get_context(
            "spawn")) as pool, ThreadPoolExecutor(max_workers=len(cells)) as threads:
        futures = [threads.submit(dryrun.run_cell, a, s, device=name, pool=pool)
                   for a, s in cells]
        examples = _p16_examples()
        recs = [f.result() for f in futures]
    t_a = time.perf_counter() - t0
    failed = [(r["arch"], r["shape"], r.get("error")) for r in recs if not r["ok"]]
    assert not failed, failed
    rows = [_p16_row(r) for r in recs]
    log(f"16a dry runs of {len(rows)} cells at full width (card {name}, {watts} W; "
        f"the peaks are the data sheet's at 700 W), done {t_a:.1f}s into the phase:")
    log(f"  {'arch':24s} {'shape':12s} {'mem GiB':>8s} fits {'flops':>10s} "
        f"{'bytes':>10s} {'t_comp ms':>10s} {'t_mem ms':>10s} {'t_coll':>6s} bound")
    for r in rows:
        log(f"  {r['arch']:24s} {r['shape']:12s} {r['mem_gib']:8.2f} "
            f"{'Y' if r['fits'] else 'N':4s} {r['flops']:10.3e} {r['bytes']:10.3e} "
            f"{r['t_comp_s'] * 1e3:10.4f} {r['t_mem_s'] * 1e3:10.4f} "
            f"{r['t_coll_s']:6.1f} {r['bottleneck']}")
    main_path = _p16_main_path(name)  # timed with no dry run beside it
    cap = P16_FIT_SHARE * torch.cuda.get_device_properties(0).total_memory
    fit = [r for r in recs if r["memory"]["total_bytes"] <= cap]
    log(f"16b {len(fit)} cells fit {P16_FIT_SHARE} of the card's "
        f"{cap / P16_FIT_SHARE / 2**30:.2f} GiB: {[(r['arch'], r['shape']) for r in fit]}")
    on_card = [_p16_on_card(r, name) for r in fit]
    seconds = time.perf_counter() - t0
    log(f"phase 16 in {seconds:.1f}s (budget {P16_BUDGET_S}s"
        f"{'' if seconds <= P16_BUDGET_S else ': OVER'})")
    return {"device": name, "power_limit_w": watts, "dry_run": rows,
            "dry_run_s": t_a, "on_card": on_card, "main_path": main_path,
            "examples": examples, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 17: the serve mesh, logical devices on the card (item 12a)
# ---------------------------------------------------------------------------

MESH_SPECS = ("data=2,model=2", "data=1,model=4", "data=4,model=1")
MESH_LOGICAL = 4       # logical devices of every phase-17 mesh
MESH_SKEW = (GEN, GEN, GEN, GEN - 6)   # (d): one request retires early
MESH_REMESH_AFTER = 4  # (d): engine steps before each re-mesh


def _mesh_of(spec, distinct=False):
    """A (data, model) mesh of MESH_LOGICAL logical devices: all on cuda:0,
    or (``distinct``) round-robin over the cards."""
    import torch

    from repro_torch.launch.mesh import LogicalDevice
    from repro_torch.serve.sharding import make_serve_mesh

    n = torch.cuda.device_count() if distinct else 1
    return make_serve_mesh(spec, devices=[
        LogicalDevice(i, torch.device("cuda", i % n))
        for i in range(MESH_LOGICAL)])


def _mesh_serve(engine, prompts, label, gens=None):
    """One counted serve (launch counts 0 before, read after; kernel 3's
    calls recorded, logits captured): (outs, logits (B, steps, V), counts,
    calls, forwards)."""
    import numpy as np

    engine.metrics.reset()
    engine.logit_traces = {}
    calls, restore = _record(["ftp_spmm_bsr"])
    try:
        if gens is None:
            run = lambda: engine.generate_batch(prompts, GEN)
        else:
            def run():
                t = [engine.submit(p, g) for p, g in zip(prompts, gens)]
                out = engine.run()
                return [out[x.rid] for x in t]
        outs, counts = _counted(label, run)
    finally:
        restore()
    s = engine.summary()
    forwards = s["prefill_batches"] + s["decode_batches"]
    traces = engine.drain_logit_traces()
    logits = [np.stack(t) for t in traces]
    return outs, logits, counts, calls, forwards


def _mesh_same(label, outs, logits, want_outs, want_logits):
    import numpy as np

    for i, (a, b) in enumerate(zip(outs, want_outs)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (label, i, a, b)
    for i, (a, b) in enumerate(zip(logits, want_logits)):
        assert a.shape == b.shape and np.array_equal(a, b), (
            label, i, float(np.abs(a - b).max()))


def _mesh_speed(engine, prompts, outs):
    """TIMED_SERVES serves without logit capture (tokens unchanged): the
    median run's tok/s and its decode step (wall after the first token
    over GEN - 1 steps of the 4-row cohort)."""
    import numpy as np

    engine.capture_logits = False
    runs = []
    for _ in range(TIMED_SERVES):
        engine.metrics.reset()
        again = engine.generate_batch(prompts, GEN)
        for a, b in zip(again, outs):
            np.testing.assert_array_equal(a, b)
        s = engine.summary()
        runs.append((s["throughput_tok_s"],
                     1e3 * (s["wall_s"] - s["ttft_s_p50"]) / (GEN - 1)))
    engine.capture_logits = True
    tok_s = sorted(r[0] for r in runs)[len(runs) // 2]
    step = next(r[1] for r in runs if r[0] == tok_s)
    return {"tok_s": tok_s, "decode_step_ms": step,
            "tok_s_runs": [r[0] for r in runs],
            "decode_step_ms_runs": [r[1] for r in runs]}


def _vocab_slabs(params):
    """Trouble spot of vocab sharding, measured: one 64-row block of an f32
    unembed product over column slabs V/2, V/4 and V/8 against the whole
    product (the library may pick its algorithm by N), at llama's (D, V)
    and at the smoke size's (64, 512): the elements that differ.  Where any
    differ, a vocab slab is not the whole product's slice, which is why the
    unembedding runs over fixed column blocks on every path
    (`layers.vocab_blocks`)."""
    import torch

    blocks = params["unembed"]
    w_full = torch.cat(list(blocks), dim=1)
    g = torch.Generator(device=blocks.device).manual_seed(SEED)
    w_smoke = torch.randn(64, 512, generator=g, device=blocks.device)
    out = {}
    for name, w in (("llama", w_full), ("smoke", w_smoke)):
        x = torch.randn(64, w.shape[0], generator=g, device=w.device)
        whole = x @ w
        for parts in (2, 4, 8):
            per = w.shape[1] // parts
            sl = torch.cat([x @ w[:, j * per:(j + 1) * per].contiguous()
                            for j in range(parts)], dim=1)
            out[f"{name} V={w.shape[1]} V/{parts}"] = int((sl != whole).sum())
    del w_full
    torch.cuda.synchronize()
    return out


def phase_mesh(smi):
    """Phase 17: bitwise mesh serving on logical devices of the card.  (a)
    the dual-sparse main path (phase 5's model and params) at data=2 x
    model=2, data=1 x model=4 and data=4 x model=1, tokens and captured
    logits equal to the single-device serve bit for bit, every kernel-3
    launch on the tensor-core instance, data x model launches a GEMM, the
    unembedding's column blocks dealt over the model axis, a sample of the
    slab calls held against the plain version; (b) the dense-
    weight route at data=2 x model=2 (kernel 1 as slabs, kernel 2 a data
    group each) == its single-device serve; (c) kernel 4 at min_spikes 1
    under the mesh == (a); (d) pipelined x paged at data=2 x model=2 ==
    the sync dense single-device serve, a skewed cohort re-packed, re-mesh
    data=2 x model=2 -> one device -> data=1 x model=2 mid-serve keeping
    every token and copying no page; (e) the `mesh` line, with the vocab
    slab probe (`_vocab_slabs`); (f) with more than one card, (a) with the
    logical devices on distinct cards."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch.serve import build_config
    from repro_torch.models.layers import VocabSlabs
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy, Placement, paged
    from repro_torch.serve.policy import PACKED_DUAL_ADAPTIVE

    t0 = time.perf_counter()
    full = build_config("llama3_2_1b", smoke=False, spiking=True,
                        weight_density=0.3)
    cfg = dataclasses.replace(full, n_layers=LLAMA_LAYERS)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")  # phase 5's params
    rng = np.random.default_rng(SEED)
    rng.integers(0, cfg.vocab, size=(8,))  # phase 5's warm-up draw
    prompts = [rng.integers(0, cfg.vocab, size=(PROMPT,)).astype(np.int32)
               for _ in range(REQUESTS)]
    L = cfg.n_layers

    def engine(spec=None, distinct=False, **kw):
        mesh = None if spec is None else _mesh_of(spec, distinct)
        pol = ExecutionPolicy.for_arch(cfg, placement=Placement(mesh=mesh),
                                       **kw.pop("policy", {}))
        return Engine(model, params, max_len=PROMPT + GEN,
                      max_slots=REQUESTS, policy=pol, capture_logits=True,
                      **kw)

    res = {"physical_devices": torch.cuda.device_count(),
           "logical_devices": MESH_LOGICAL, "smi": smi, "meshes": {}}
    single = engine()
    single.generate_batch([prompts[0][:8]], 2)  # warm-up
    want, want_l, counts, _, fwd = _mesh_serve(single, prompts,
                                               "17 single-device dual")
    assert counts["ftp_bsr"] == counts["ftp_bsr_tc"] == 2 * L * fwd, counts
    base = {"ftp_bsr_launches_per_decode_step": 2 * L,
            **_mesh_speed(single, prompts, want)}
    res["single_device"] = base
    worst = (0.0, 0)
    launches = 0
    for spec in MESH_SPECS:
        dn, mp = (int(t.split("=")[1]) for t in spec.split(","))
        eng = engine(spec)
        outs, logits, counts, calls, fwd = _mesh_serve(eng, prompts,
                                                       f"17a {spec}")
        _mesh_same(f"17a {spec}", outs, logits, want, want_l)
        vocab = eng.params["unembed"]
        assert isinstance(vocab, VocabSlabs) == (mp > 1), (spec, vocab)
        n = 2 * L * fwd * dn * mp
        assert counts["ftp_bsr"] == counts["ftp_bsr_tc"] == n, (spec, counts)
        assert counts["ftp_bsr_simt"] == 0 and counts["ftp_spmm"] == 0
        launches += counts["ftp_bsr"]
        err, flips = _parity_all(_sample(calls, 2), f"17a {spec}")
        worst = (max(worst[0], err), worst[1] + flips)
        res["meshes"][spec] = {
            "ftp_bsr_launches_per_decode_step": 2 * L * dn * mp,
            "launches": counts["ftp_bsr"], "all_tc": True,
            **_mesh_speed(eng, prompts, outs)}
        log(f"17a {spec}: tokens and logits == single device; "
            f"{counts['ftp_bsr']} kernel-3 launches ({dn * mp} a GEMM), all "
            f"tc; {json.dumps(res['meshes'][spec])}")
        del eng
        gc.collect()
    res["kernel3"] = {"launches": launches, "max_abs_err": worst[0],
                      "flips": worst[1]}
    # (b) the dense-weight route
    d_single = engine(policy={"weight_sparsity": "dense"})
    d_want, d_want_l, _, _, _ = _mesh_serve(d_single, prompts,
                                            "17b single-device dense")
    del d_single
    d_mesh = engine("data=2,model=2", policy={"weight_sparsity": "dense"})
    outs, logits, counts, _, fwd = _mesh_serve(d_mesh, prompts,
                                               "17b dense data=2,model=2")
    _mesh_same("17b", outs, logits, d_want, d_want_l)
    assert counts["ftp_spmm"] == counts["ftp_dense_tc"] - counts[
        "ftp_spmm_fused_lif"] == L * fwd * 4, counts
    assert counts["ftp_spmm_fused_lif"] == L * fwd * 2 and counts["ftp_bsr"] == 0
    res["dense"] = {"ftp_spmm_launches": counts["ftp_spmm"],
                    "ftp_spmm_fused_lif_launches": counts["ftp_spmm_fused_lif"]}
    del d_mesh
    gc.collect()
    # (c) kernel 4 at min_spikes 1 under the mesh
    a_mesh = engine("data=2,model=2")
    for lp in a_mesh.params["layers"]:
        lp["mlp"]["ffn_policy"] = PACKED_DUAL_ADAPTIVE
    outs, logits, counts, _, fwd = _mesh_serve(a_mesh, prompts,
                                               "17c adaptive data=2,model=2")
    _mesh_same("17c", outs, logits, want, want_l)
    assert counts["ftp_bsr_adaptive"] == counts["ftp_bsr_tc"] == 2 * L * fwd * 4
    assert counts["ftp_bsr"] == 0, counts
    res["adaptive"] = {"ftp_bsr_adaptive_launches": counts["ftp_bsr_adaptive"]}
    del a_mesh
    gc.collect()
    # (d) pipelined x paged under the mesh
    feat = {"execution": "pipelined", "paging": paged(PAGE)}
    p_mesh = engine("data=2,model=2", policy=feat, prefix_cache=False)
    outs, logits, _, _, _ = _mesh_serve(p_mesh, prompts, "17d pipelined paged")
    _mesh_same("17d", outs, logits, want, want_l)
    skew, _, _, _, _ = _mesh_serve(p_mesh, prompts, "17d skewed", MESH_SKEW)
    for i, g in enumerate(MESH_SKEW):
        np.testing.assert_array_equal(skew[i], want[i][:g])
    rebalances = p_mesh.metrics.n_rebalances
    assert rebalances > 0, "the skewed cohort did not re-pack"
    p_mesh.metrics.reset()
    tickets = [p_mesh.submit(p, GEN) for p in prompts]
    moves = p_mesh.metrics.n_page_moves
    for target in ("single", "data=1,model=2"):
        for _ in range(MESH_REMESH_AFTER):
            p_mesh.step()
        if target == "single":
            rep = p_mesh.remesh(devices=list(_mesh_of("data=2,model=2")
                                             .devices.flat)[:1])
        else:
            rep = p_mesh.remesh(mesh=_mesh_of("data=1,model=2"))
        assert rep["remeshed"], rep
    out = p_mesh.run()
    for t, w in zip(tickets, want):
        np.testing.assert_array_equal(out[t.rid], w)
    assert p_mesh.metrics.n_page_moves == moves == 0
    assert p_mesh.metrics.n_remeshes == 2
    res["features"] = {"rebalances": rebalances, "remeshes": 2,
                       "page_moves": 0}
    del p_mesh
    gc.collect()
    # (f) distinct cards
    if torch.cuda.device_count() > 1:
        eng = engine("data=2,model=2", distinct=True)
        outs, logits, counts, _, _ = _mesh_serve(eng, prompts, "17f cards")
        _mesh_same("17f", outs, logits, want, want_l)
        res["multi_card"] = {"cards": eng.summary()["mesh_physical_devices"]}
        del eng
    else:
        res["multi_card"] = ("no multi-card run: one card; every logical "
                             "device of this phase shared it")
    # the single-device serve timed again after every mesh: what the
    # phase's own course does to the host-bound decode step
    res["single_device_again"] = _mesh_speed(single, prompts, want)
    del single
    res["vocab_slab_differing_elements"] = _vocab_slabs(model.prepare(params))
    res["note"] = (f"{MESH_LOGICAL} logical devices on "
                   f"{torch.cuda.device_count()} card(s): the times are those "
                   "of one card running every shard's launches; no "
                   "multi-card speed is claimed")
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 17: {json.dumps(res)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


TP_SPECS = ("data=1,model=2", "data=2,model=2", "data=1,model=4")
# (d): the other families at model = 2, published width, depth cut
TP_FAMILIES = (("gemma_2b", 2, {}), ("gemma_2b", 2, {"expand_kv": True}),
               ("phi3_5_moe", 2, {}), ("rwkv6_1_6b", 2, {}),
               ("zamba2_7b", 6, {"compute_dtype": "float32"}))
TP_FAMILY_GEN = 8


def _tp_drift(outs, logits, want_outs, want_logits):
    """Drift of a TP serve from the single-device bitwise one: the max
    logit drift (`serve.policy.drift_report`: compared up to each request's
    first token flip, that step included), the token-match fraction, the
    first flip (request, step) or None, and each step's max drift over the
    requests."""
    import numpy as np

    from repro_torch.serve.policy import drift_report

    flip = None
    for r, (a, b) in enumerate(zip(want_outs, outs)):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if int(x) != int(y)]
        if diff and (flip is None or diff[0] < flip[1]):
            flip = (r, diff[0])
    steps = [float(max(np.abs(np.asarray(a[i], np.float32)
                              - np.asarray(b[i], np.float32)).max()
                       for a, b in zip(want_logits, logits)))
             for i in range(min(len(x) for x in logits))]
    rep = drift_report(want_outs, outs, want_logits, logits)
    return {"max_logit_drift": rep["max_logit_drift"],
            "token_match_fraction": rep["token_match_fraction"],
            "first_flip": flip, "step_drift": steps}


def _tp_engine(model, params, cfg, spec, *, gen=GEN, distinct=False,
               **kw):
    """An engine under the arch's policy, logits captured: bitwise on one
    device (``spec`` None), else approximate(LOGIT_TOL) on the mesh
    ``spec`` (its logical devices on distinct cards with ``distinct``)."""
    from repro_torch.serve import Engine, ExecutionPolicy, Placement, approximate

    pol = dict(kw.pop("policy", {}))
    if spec is not None:
        pol["placement"] = Placement(mesh=_mesh_of(spec, distinct))
        pol["exactness"] = approximate(LOGIT_TOL)
    return Engine(model, params, max_len=PROMPT + gen, max_slots=REQUESTS,
                  policy=ExecutionPolicy.for_arch(cfg, **pol),
                  capture_logits=True, **kw)


def _engine_bytes(make):
    """(``make()``, the card memory its construction kept): what an
    engine's placement holds beyond the params it was given."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng = make()
    torch.cuda.synchronize()
    return eng, torch.cuda.memory_allocated() - before


def _tp_family(arch, n_layers, over, prompts):
    """(d): one family at published width, depth cut to ``n_layers``, its
    TP_FAMILY_GEN-token serve at data=1 x model=2 under approximate held
    to drift <= LOGIT_TOL against its single-device bitwise serve."""
    import dataclasses

    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(
        build_config(arch, smoke=False, spiking=False, weight_density=1.0),
        n_layers=n_layers, **over)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    prompts = [p % cfg.vocab for p in prompts]
    label = f"18d {arch}{' ' + json.dumps(over) if over else ''}"

    def serve(eng):
        eng.generate_batch([prompts[0][:8]], 2)  # warm-up
        eng.logit_traces = {}
        routes = []
        restore = _record_routes(routes)
        try:
            outs, counts = _counted(label, lambda: eng.generate_batch(
                prompts, TP_FAMILY_GEN))
        finally:
            restore()
        _no_kernels(counts, label)
        return outs, eng.drain_logit_traces(), eng.summary(), routes

    one, one_bytes = _engine_bytes(lambda: _tp_engine(
        model, params, cfg, None, gen=TP_FAMILY_GEN))
    want, want_l, _, want_r = serve(one)
    del one
    eng, eng_bytes = _engine_bytes(lambda: _tp_engine(
        model, params, cfg, "data=1,model=2", gen=TP_FAMILY_GEN))
    outs, logits, s, routes = serve(eng)
    del eng
    d = _tp_drift(outs, logits, want, want_l)
    res = dict(d, layers=n_layers, tp_weights_dealt=s["tp_weights_dealt"],
               tp_weights_whole=s["tp_weights_whole"],
               engine_bytes_over_one_device=eng_bytes - one_bytes, **over)
    if cfg.n_experts:
        # row-coupled: attention stays whole (wq wk wv wo), experts dealt
        assert s["tp_weights_whole"] == 4 * n_layers, (label, s)
        # per routing call: the (token, k) expert choices and the kept
        # pairs that differ from one device's
        res["route_diffs"] = [
            [int((e0 != e1).sum()), int((k0 != k1).sum())]
            for (e0, k0), (e1, k1) in zip(want_r, routes)
            if e0.shape == e1.shape]
    log(f"{label}: {json.dumps(res)}")
    assert d["max_logit_drift"] <= LOGIT_TOL, (label, d)
    assert s["tp_weights_dealt"] > 0, (label, s)
    del model, params
    _free()
    return res


def phase_tp(smi):
    """Phase 18: approximate-TP serving (item 12b) on logical devices of
    the card, the port against itself: every approximate serve against the
    bitwise serve on one device, max logit drift <= LOGIT_TOL.  (a) float
    llama3.2-1b (LLAMA_LAYERS layers, full width) at data=1 x model=2,
    data=2 x model=2 and data=1 x model=4, with 2 x 2 == 1 x 2, a second
    2 x 2 serve == the first and pipelined == sync, bit for bit; (b) the
    main path (phase 5's dual-sparse model and params) at 2 x 2: every
    kernel-3 launch a plan slab on `tc` at phase 17's count, a sample held
    against the plain version, kernel 4 at min_spikes 1 == (b); (c) the
    dense-weight route at 2 x 2; (d) gemma-2b (expand_kv off and on),
    phi3.5-moe (attention whole: its rows couple), rwkv6-1.6b and
    zamba2-7b (f32) at model = 2; (e) with more than one card, (a)'s 2 x 2
    on distinct cards.  Each mesh's decode step and tok/s are timed after
    a warm-up, and (a) reads the card memory each engine's placement
    keeps (TP slabs are views of the prepared weights on one card)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch.serve import build_config
    from repro_torch.models.layers import TPSlabs
    from repro_torch.models.registry import build_model
    from repro_torch.serve.policy import PACKED_DUAL_ADAPTIVE

    t0 = time.perf_counter()
    res = {"physical_devices": torch.cuda.device_count(),
           "logical_devices": MESH_LOGICAL, "smi": smi, "float_llama": {}}
    rng = np.random.default_rng(SEED)
    rng.integers(0, 128256, size=(8,))  # phase 5's warm-up draw
    prompts = [rng.integers(0, 128256, size=(PROMPT,)).astype(np.int32)
               for _ in range(REQUESTS)]

    def counted(eng, label, gens=None):
        eng.generate_batch([prompts[0][:8]], 2)  # warm-up
        return _mesh_serve(eng, prompts, label, gens)

    # (a) float llama
    full = build_config("llama3_2_1b", smoke=False, spiking=False,
                        weight_density=1.0)
    cfg = dataclasses.replace(full, n_layers=LLAMA_LAYERS)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    single, one_bytes = _engine_bytes(
        lambda: _tp_engine(model, params, cfg, None))
    want, want_l, counts, _, _ = counted(single, "18a single-device float")
    _no_kernels(counts, "18a single-device float")
    res["float_llama"]["single_device"] = dict(
        _mesh_speed(single, prompts, want), engine_bytes=one_bytes)
    del single
    served = {}
    for spec in TP_SPECS:
        eng, eng_bytes = _engine_bytes(
            lambda: _tp_engine(model, params, cfg, spec))
        outs, logits, counts, _, _ = counted(eng, f"18a {spec}")
        _no_kernels(counts, f"18a {spec}")
        d = _tp_drift(outs, logits, want, want_l)
        assert d["max_logit_drift"] <= LOGIT_TOL, (spec, d)
        attn = eng.params["layers"][0]["attn"]
        assert isinstance(attn["wq"], TPSlabs), spec
        s = eng.summary()
        served[spec] = (outs, logits)
        if spec == "data=2,model=2":
            _mesh_same("18a 2x2 == 1x2", outs, logits,
                       *served["data=1,model=2"])
            again = _mesh_serve(eng, prompts, "18a 2x2 again")
            _mesh_same("18a 2x2 again", again[0], again[1], outs, logits)
        res["float_llama"][spec] = dict(
            d, tp_weights_dealt=s["tp_weights_dealt"],
            tp_weights_whole=s["tp_weights_whole"], engine_bytes=eng_bytes,
            engine_bytes_over_one_device=eng_bytes - one_bytes,
            **_mesh_speed(eng, prompts, outs))
        log(f"18a {spec}: {json.dumps(res['float_llama'][spec])}")
        del eng
        gc.collect()
    eng = _tp_engine(model, params, cfg, "data=2,model=2",
                     policy={"execution": "pipelined"})
    outs, logits, _, _, _ = counted(eng, "18a 2x2 pipelined")
    _mesh_same("18a pipelined == sync", outs, logits,
               *served["data=2,model=2"])
    del eng
    if torch.cuda.device_count() > 1:
        eng = _tp_engine(model, params, cfg, "data=2,model=2", distinct=True)
        outs, logits, _, _, _ = counted(eng, "18e cards")
        d = _tp_drift(outs, logits, want, want_l)
        assert d["max_logit_drift"] <= LOGIT_TOL, d
        res["multi_card"] = dict(d, cards=eng.summary()["mesh_physical_devices"])
        del eng
    else:
        res["multi_card"] = ("no multi-card run: one card; every logical "
                             "device of this phase shared it")
    del model, params, served
    _free()
    # (b) the main path, dual-sparse, phase 5's params
    full = build_config("llama3_2_1b", smoke=False, spiking=True,
                        weight_density=0.3)
    cfg = dataclasses.replace(full, n_layers=LLAMA_LAYERS)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    L = cfg.n_layers
    single = _tp_engine(model, params, cfg, None)
    want, want_l, _, _, _ = counted(single, "18b single-device dual")
    del single
    eng = _tp_engine(model, params, cfg, "data=2,model=2")
    outs, logits, counts, calls, fwd = counted(eng, "18b dual 2x2")
    d = _tp_drift(outs, logits, want, want_l)
    assert d["max_logit_drift"] <= LOGIT_TOL, d
    n = 2 * L * fwd * 4
    assert counts["ftp_bsr"] == counts["ftp_bsr_tc"] == n, (n, counts)
    assert counts["ftp_bsr_simt"] == 0 and counts["ftp_spmm"] == 0
    assert all(c[2].get("parent") is not None for c in calls)
    err, flips = _parity_all(_sample(calls, 2), "18b")
    s = eng.summary()
    res["dual"] = dict(d, ftp_bsr_launches=counts["ftp_bsr"],
                       ftp_bsr_launches_per_decode_step=2 * L * 4,
                       all_tc=True, max_abs_err=err, flips=flips,
                       tp_weights_dealt=s["tp_weights_dealt"],
                       **_mesh_speed(eng, prompts, outs))
    for lp in eng.params["layers"]:
        lp["mlp"]["ffn_policy"] = PACKED_DUAL_ADAPTIVE
    a_outs, a_logits, a_counts, _, _ = _mesh_serve(eng, prompts,
                                                   "18b adaptive 2x2")
    _mesh_same("18b adaptive == dual", a_outs, a_logits, outs, logits)
    assert a_counts["ftp_bsr_adaptive"] == a_counts["ftp_bsr_tc"] == n
    assert a_counts["ftp_bsr"] == 0, a_counts
    res["dual"]["ftp_bsr_adaptive_launches"] = a_counts["ftp_bsr_adaptive"]
    log(f"18b: {json.dumps(res['dual'])}")
    del eng
    gc.collect()
    # (c) the dense-weight route
    dense = {"weight_sparsity": "dense"}
    single = _tp_engine(model, params, cfg, None, policy=dense)
    d_want, d_want_l, _, _, _ = counted(single, "18c single-device dense")
    del single
    eng = _tp_engine(model, params, cfg, "data=2,model=2", policy=dense)
    outs, logits, counts, _, fwd = counted(eng, "18c dense 2x2")
    d = _tp_drift(outs, logits, d_want, d_want_l)
    assert d["max_logit_drift"] <= LOGIT_TOL, d
    assert counts["ftp_spmm"] == L * fwd * 4, counts
    assert counts["ftp_spmm_fused_lif"] == L * fwd * 2 and counts["ftp_bsr"] == 0
    res["dense"] = dict(d, ftp_spmm_launches=counts["ftp_spmm"],
                        ftp_spmm_fused_lif_launches=counts["ftp_spmm_fused_lif"])
    log(f"18c: {json.dumps(res['dense'])}")
    del eng, model, params
    _free()
    # (d) the other families
    res["families"] = [_tp_family(arch, n_layers, over, prompts)
                       for arch, n_layers, over in TP_FAMILIES]
    res["note"] = (f"{MESH_LOGICAL} logical devices on "
                   f"{torch.cuda.device_count()} card(s): the times are those "
                   "of one card running every shard's launches; no "
                   "multi-card speed is claimed")
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 18: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phase 19: the train mesh on logical devices of the card (item 12c)
# ---------------------------------------------------------------------------

P19_BUDGET_S = 120
P19_STEPS = 3
P19_ELASTIC_LAYERS = 2


def _train_mesh(n, mp, distinct=False):
    """`ft.elastic.plan_mesh` over ``n`` logical devices at model ``mp``:
    all on cuda:0, or (``distinct``) round-robin over the cards."""
    import torch

    from repro_torch.ft.elastic import plan_mesh
    from repro_torch.launch.mesh import LogicalDevice

    k = torch.cuda.device_count() if distinct else 1
    return plan_mesh(n, mp, devices=[LogicalDevice(i, torch.device("cuda", i % k))
                                     for i in range(n)])


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _synced_ms(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _beyond_one_device(tree, shardings) -> int:
    """Bytes of the devices' parts of ``tree`` that are not views of its
    leaves (what the placement holds beyond one device's state)."""
    import torch

    from repro_torch.tree import tree_leaves

    extra = 0
    for leaf, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        if not isinstance(leaf, torch.Tensor):
            continue
        base = leaf.untyped_storage().data_ptr()
        for part in sh.parts(leaf).values():
            if part.untyped_storage().data_ptr() != base:
                extra += part.numel() * part.element_size()
    return extra


def _mesh_vs_one(model, state, batches, mesh, label, optimizer=None):
    """Each of ``batches`` through the meshed step, and from the same state
    the one-device step: the per-step losses, grad norms, relative gaps and
    step times, and the meshed run's last state (no other state is kept:
    a full-depth llama state is 15 GB)."""
    from repro_torch.train import make_train_step

    one = make_train_step(model, optimizer)
    meshed = make_train_step(model, optimizer, mesh=mesh)
    rows = []
    for i, batch in enumerate(batches):
        out, one_ms = _synced_ms(lambda: one(state, batch))
        m1 = out[1]
        del out
        (state, mm), mesh_ms = _synced_ms(lambda: meshed(state, batch))
        row = {"loss": float(mm["loss"]), "loss_one_device": float(m1["loss"]),
               "grad_norm": float(mm["grad_norm"]),
               "grad_norm_one_device": float(m1["grad_norm"]),
               "loss_rel": _rel(mm["loss"], m1["loss"]),
               "grad_norm_rel": _rel(mm["grad_norm"], m1["grad_norm"]),
               "step_ms": mesh_ms, "one_device_step_ms": one_ms}
        log(f"{label} step {i}: loss {row['loss']:.6f} vs {row['loss_one_device']:.6f} "
            f"(rel {row['loss_rel']:.2e} <= {TRAIN_LOSS_RTOL}), grad norm "
            f"{row['grad_norm']:.4f} vs {row['grad_norm_one_device']:.4f} (rel "
            f"{row['grad_norm_rel']:.2e} <= {TRAIN_GNORM_RTOL}); meshed "
            f"{mesh_ms:.1f} ms, one device {one_ms:.1f} ms")
        assert row["loss_rel"] <= TRAIN_LOSS_RTOL, (label, i, row)
        assert row["grad_norm_rel"] <= TRAIN_GNORM_RTOL, (label, i, row)
        rows.append(row)
    return rows, state


def phase_train_mesh(smi):
    """Phase 19 (see the module docstring): the train mesh on logical
    devices of the card, the port against its one-device step."""
    import shutil
    import tempfile

    import torch

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.data import SyntheticLMData, batch_to_torch
    from repro_torch.ft.elastic import reshard_state
    from repro_torch.models.layers import record_moe_routing
    from repro_torch.models.registry import build_model
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.sharding import base_rules, tree_shardings
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import meshed_loss_and_grads, train_state_axes
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    t0 = time.perf_counter()
    res = {"physical_devices": torch.cuda.device_count(), "smi": smi}
    # (a) llama3.2-1b, phase 8's model, data=2 x model=2
    cfg = _train_cfg()
    model = build_model(cfg)
    data = SyntheticLMData(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    batches = [batch_to_torch(data.batch(i), "cuda") for i in range(P19_STEPS)]
    rules = base_rules(cfg.fsdp)
    axes = train_state_axes(model)
    mesh = _train_mesh(4, 2)
    state0 = init_train_state(model, SEED, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    placed = reshard_state(state0, axes, mesh, rules)
    torch.cuda.synchronize()
    placed_bytes = torch.cuda.memory_allocated() - before
    sh = tree_shardings(placed, axes, mesh, rules)
    beyond = {k: _beyond_one_device(placed[k], sh[k]) for k in ("params", "opt")}
    assert placed_bytes == 0 and not any(beyond.values()), (placed_bytes, beyond)
    log(f"19a: state placed on {mesh.describe()}: {placed_bytes} B allocated, "
        f"parts beyond one device's {beyond}")
    rows, final = _mesh_vs_one(model, placed, batches, mesh, "19a")
    final = final["params"]  # the optimizer state goes: 10 GB
    # pruned FFN weights stay 0 in every device's part
    pruned_ok = 0
    first = dict(tree_paths(placed["params"]))
    last = dict(tree_paths(final))
    sh_p = dict(zip([p for p, _ in tree_paths(final)],
                    tree_leaves(sh["params"])))
    for p, w0 in first.items():
        if not p.endswith(("mlp/wu", "mlp/wd")):
            continue
        zero = w0 == 0
        for idx, part in sh_p[p].parts(last[p]).items():
            z = zero[sh_p[p].index(idx, w0.shape)]
            assert torch.equal(part[z], torch.zeros_like(part[z])), (p, idx)
            pruned_ok += 1
    # a repeat of the meshed run, bit for bit (its steps timed, warm)
    meshed = make_train_step(model, mesh=mesh)
    state, again_ms = placed, []
    for i, batch in enumerate(batches):
        (state, m), ms = _synced_ms(lambda: meshed(state, batch))
        again_ms.append(ms)
        assert float(m["loss"]) == rows[i]["loss"], (i, float(m["loss"]), rows[i])
        assert float(m["grad_norm"]) == rows[i]["grad_norm"], i
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(final)):
        assert torch.equal(a, b)
    del state, final
    one = make_train_step(model)
    one_ms = [_synced_ms(lambda: one(placed, batches[0]))[1] for _ in range(P19_STEPS)]
    wall, busy, top = _device_busy(lambda: meshed(placed, batches[0]))
    res["llama"] = {
        "mesh": mesh.describe(), "layers": cfg.n_layers, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": rows,
        "meshed_step_ms_median": statistics.median(again_ms),
        "meshed_step_ms_runs": again_ms,
        "one_device_step_ms_median": statistics.median(one_ms),
        "one_device_step_ms_runs": one_ms,
        "profiled_meshed_step_s": wall, "device_busy_s": busy,
        "idle_share_profiled": 1.0 - busy / wall if busy else None,
        "top_device": [(n, s) for n, s in top[:5]],
        "state_bytes_allocated_by_placement": placed_bytes,
        "state_parts_bytes_beyond_one_device": beyond,
        "pruned_parts_checked": pruned_ok, "repeat_bitwise": True}
    log(f"19a: meshed step {res['llama']['meshed_step_ms_median']:.1f} ms, one "
        f"device {res['llama']['one_device_step_ms_median']:.1f} ms (medians of "
        f"{P19_STEPS}); idle {res['llama']['idle_share_profiled']:.3f} of a "
        f"profiled meshed step; {pruned_ok} pruned FFN parts zero")
    del placed, state0, one, meshed
    _free()
    # (b) elastic at P19_ELASTIC_LAYERS layers: the host -> 1 x 2, restore
    cfg2 = _train_cfg(P19_ELASTIC_LAYERS)
    model2 = build_model(cfg2)
    axes2 = train_state_axes(model2)
    s2 = reshard_state(init_train_state(model2, SEED, device="cuda"), axes2,
                       mesh, rules)
    s2, _ = make_train_step(model2, mesh=mesh)(s2, batches[0])
    host = tree_map(lambda t: t.detach().cpu().clone(), s2)
    del s2
    mesh12 = _train_mesh(2, 2)
    sh12 = tree_shardings(host, axes2, mesh12, rules)
    step12 = make_train_step(model2, mesh=mesh12)
    a_state, a_m = step12(reshard_state(host, axes2, mesh12, rules), batches[1])
    tmp = tempfile.mkdtemp(prefix="p19_ckpt_")
    try:
        save_checkpoint(tmp, 1, host)
        restored = restore_checkpoint(tmp, 1, host, shardings=sh12)
        b_state, b_m = step12(restored, batches[1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert torch.equal(a_m["loss"], b_m["loss"]), (a_m, b_m)
    assert torch.equal(a_m["grad_norm"], b_m["grad_norm"])
    for a, b in zip(tree_leaves(a_state), tree_leaves(b_state)):
        assert torch.equal(a, b)
    res["elastic"] = {"layers": P19_ELASTIC_LAYERS, "from": mesh.describe(),
                      "to": mesh12.describe(), "loss": float(a_m["loss"]),
                      "restore_bitwise": True}
    log(f"19b: {json.dumps(res['elastic'])}")
    del a_state, b_state, restored, host, model2
    _free()
    # (c) phi3.5-moe: fsdp + EP + Adafactor at 2 x 2, one of 32 layers
    import dataclasses

    from repro_torch.configs import get_config

    mcfg = dataclasses.replace(get_config("phi3_5_moe"), n_layers=1)
    moe = build_model(mcfg)
    mdata = SyntheticLMData(mcfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    mb = batch_to_torch(mdata.batch(0), "cuda")
    maxes = train_state_axes(moe)
    mrules = base_rules(mcfg.fsdp)
    mstate = reshard_state(init_train_state(moe, SEED, device="cuda"), maxes,
                           mesh, mrules)
    with torch.no_grad():
        with record_moe_routing() as one_keep:
            moe.loss(mstate["params"], mb)
        with record_moe_routing() as mesh_keep:
            meshed_loss_and_grads(moe, mstate["params"], mb, mesh,
                                  need_grads=False)
    assert len(one_keep) == len(mesh_keep) == mcfg.n_layers
    assert all(torch.equal(a, b) for a, b in zip(one_keep, mesh_keep))
    mrows, _ = _mesh_vs_one(moe, mstate, [mb], mesh, "19c")
    specs = tree_shardings(mstate["params"], maxes["params"], mesh, mrules)
    res["moe"] = {"arch": "phi3_5_moe", "layers": 1, "mesh": mesh.describe(),
                  "optimizer": mcfg.optimizer, "step": mrows[0],
                  "pairs": int(one_keep[0].numel()),
                  "dropped_pairs_one_device": int((~one_keep[0]).sum()),
                  "dropped_pairs_meshed": int((~mesh_keep[0]).sum()),
                  "expert_wu_spec": list(specs["layers"][0]["moe"]["wu"].spec),
                  "router_spec": list(specs["layers"][0]["moe"]["router"].spec)}
    log(f"19c: {json.dumps(res['moe'])}")
    del mstate, moe
    _free()
    # (d) compressed_psum over the data axis of the mesh
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gs = [torch.randn(1 << 20, generator=gen, device=mesh.physical(i, 0))
          for i in range(mesh.shape["data"])]
    got = compressed_psum(gs)
    exact = torch.stack([g.to(mesh.lead) for g in gs]).mean(0)
    err = max(float((g.to(mesh.lead) - exact).abs().max()) for g in got)
    atol = float(exact.abs().max()) / 100
    assert err <= atol, (err, atol)
    res["compressed_psum"] = {"devices": len(gs), "elements": gs[0].numel(),
                              "max_abs_err": err, "atol": atol}
    log(f"19d: {json.dumps(res['compressed_psum'])}")
    # (e) across cards
    if torch.cuda.device_count() > 1:
        dmesh = _train_mesh(4, 2, distinct=True)
        s = reshard_state(init_train_state(model, SEED, device="cuda"), axes,
                          dmesh, rules)
        erows, _ = _mesh_vs_one(model, s, batches[:1], dmesh, "19e")
        res["multi_card"] = {"cards": len(dmesh.physical_devices()), "step": erows[0]}
        del s
    else:
        res["multi_card"] = ("no multi-card run: one card; every logical device "
                             "of this phase shared it")
    _free()
    res["note"] = (f"{mesh.size} logical devices on {torch.cuda.device_count()} "
                   "card(s): the times are those of one card running every "
                   "group's and shard's launches; no multi-card speed is claimed")
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 19 in {res['seconds']:.1f}s (budget {P19_BUDGET_S}s"
        f"{'' if res['seconds'] <= P19_BUDGET_S else ': OVER'})")
    return res


def _flash_entries(flash):
    """The kernels-line entries of kernels 5-7: headline numbers from the
    train step's own attention inputs (layer 0; `tc`, with the SIMT
    instance's time on the same inputs), every case listed.  Kernel 7's
    launches by instance are its forward kernel's."""
    entries = []
    counts = flash["launches"]
    for name, rows in flash["rows"].items():
        main = rows[0]
        src, replaces = KERNELS[name]
        by = "flash_fwd" if name == "flash_mha" else name
        wide = flash["wide_launches"]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name],
            "wide_dh_launches": {"simt": wide[f"{by}_simt"],
                                 "tc": wide[f"{by}_tc"]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "instance": main["instance"],
            "instance_launches": {"tc": counts[f"{by}_tc"],
                                  "simt": counts[f"{by}_simt"]},
            "simt_ms": main["simt_ms"], "cases": rows})
    entries[-1]["vs_model_attention"] = flash["vs_model_attention"]
    entries[-1]["over_gate"] = flash["over_gate"]
    for key in ("vs_plain_chain_over_gate", "f64_o_witness_over_gate",
                "o_off_plain", "wide_vs_plain_chain_over_gate"):
        entries[-1][key] = flash[key]
    return entries


def _headline(rows):
    """Per-launch means over a path's replay groups, weighted by launches."""
    n = sum(r["launches"] for r in rows)
    mean = {k: sum(r[k] * r["launches"] for r in rows) / n
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bytes_share = sum(r["bound_ms"] * r["launches"] for r in rows
                      if r["bound_by"] == "bytes") / (mean["bound_ms"] * n)
    mean["bound_by"] = "bytes" if bytes_share >= 0.5 else "operations"
    return n, mean


def _entry(name, launches, rows, extra):
    n, mean = _headline(rows)
    log(f"{name}: {n} replayed launches, kernel {mean['ms']:.4f} ms per launch "
        f"against a bound of {mean['bound_ms']:.4f} ms ({mean['bound_by']})")
    src, replaces = KERNELS[name]
    return dict({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": launches,
                 "max_abs_err": max(r["max_abs_err"] for r in rows + extra),
                 "ms": mean["ms"], "plain_ms": mean["plain_ms"],
                 "bound_ms": mean["bound_ms"], "bound_by": mean["bound_by"],
                 "library_ms": mean["library_ms"]})


def _instances(name, counts, rows):
    """The kernels-line fields of a kernel with two instances: the one its
    path ran (every launch through `tc`), the launches by instance, and the
    SIMT instance's mean time on the same calls."""
    family = "bsr" if name.startswith("ftp_bsr") else "dense"
    n = sum(r["launches"] for r in rows)
    out = {"instance": "tc",
           "instance_launches": {"tc": counts[f"ftp_{family}_tc"],
                                 "simt": counts[f"ftp_{family}_simt"]},
           "simt_ms": sum(r["simt_ms"] * r["launches"] for r in rows) / n}
    log(f"{name}: tensor-core instance "
        f"{sum(r['ms'] * r['launches'] for r in rows) / n:.4f} ms per path "
        f"launch, SIMT instance {out['simt_ms']:.4f} ms on the same calls")
    return out


def _serve_summary(s):
    med = s["median"]
    return {"tok_s": med["throughput_tok_s"], "ttft_s_p50": med["ttft_s_p50"],
            "wall_s": med["wall_s"], "stage_s": med["stage_s"],
            "tok_s_runs": [t["throughput_tok_s"] for t in s["timed"]],
            "ttft_s_p50_runs": [t["ttft_s_p50"] for t in s["timed"]],
            "profile": s["profile"]}


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows, dense_rows = phase_kernel()
    phase_small_cpu_vs_card()
    dual = phase_serve()
    served = _replay(dual["calls"])
    dense = phase_serve_dense(dual)
    dense_served = _replay_dense(dense["calls"])
    adaptive = phase_adaptive(dual)
    phase_features(dual, dense)
    windows = phase_windows(dual)
    import torch

    ratios = {}
    for d in dense_served:
        twin = next(r for r in served if r["case"] == d["case"].removeprefix("dense "))
        ratios[twin["case"]] = d["ms"] / twin["ms"]
    ratios["serve_tok_s_dual_over_dense"] = (dual["median"]["throughput_tok_s"]
                                             / dense["median"]["throughput_tok_s"])
    log(f"dense / dual-sparse kernel time per launch at the serve's shapes: "
        f"{json.dumps({k: round(v, 3) for k, v in ratios.items()})}")
    bsr = _entry("ftp_bsr", dual["launches"], served, rows)
    bsr.update(_instances("ftp_bsr", dual["counts"], served), serve_cases=served,
               cases=rows,
               serve=dict(_serve_summary(dual), cpu_reference=dual["cpu_reference"]),
               windows=windows)
    kernels = [bsr]
    for name, fuse in (("ftp_spmm", False), ("ftp_spmm_fused_lif", True)):
        mine = [r for r in dense_served if r["fuse_lif"] == fuse]
        entry = _entry(name, dense["counts"][name], mine,
                       [r for r in dense_rows if r["fuse_lif"] == fuse])
        entry.update(_instances(name, dense["counts"], mine), serve_cases=mine,
                     cases=[r for r in dense_rows if r["fuse_lif"] == fuse])
        kernels.append(entry)
    kernels[-1].update(serve=dict(_serve_summary(dense),
                                  max_logit_diff_vs_dual=dense["max_logit_diff_vs_dual"],
                                  vs_dual=dense["vs_dual"]),
                       dense_over_dual=ratios)
    ad = _entry("ftp_bsr_adaptive", adaptive["launches"], adaptive["served"],
                adaptive["cases"])
    ad.update(_instances("ftp_bsr_adaptive", adaptive["counts"],
                         adaptive["served"]),
              serve_cases=adaptive["served"], cases=adaptive["cases"],
              draft=windows["packed"]["11c draft min_spikes 2"])
    kernels.append(ad)
    # the serves' params, engines and recorded calls go before training (an
    # engine and its executor refer to each other: collect the cycles)
    del dual, dense, adaptive, windows
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 1-7 done at {time.perf_counter() - t0:.1f}s")
    train, captured = phase_train()
    log(f"phase 8 done at {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    flash = _flash_entries(phase_flash(captured, _train_cfg()))
    flash[-1]["train"] = train
    kernels += flash
    del captured
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9 done at {time.perf_counter() - t0:.1f}s")
    gemma = phase_handoff()
    log(f"phase 12a done at {time.perf_counter() - t0:.1f}s")
    qwen3 = phase_qwen3()
    log(f"phase 12b done at {time.perf_counter() - t0:.1f}s")
    bsr["slice_path"] = {"gemma_2b": gemma, "qwen3_14b": qwen3,
                         "smoke_archs": phase_smoke_archs()}
    bsr["max_abs_err"] = max(bsr["max_abs_err"], gemma["kernel3"]["max_abs_err"],
                             qwen3["kernel3"]["max_abs_err"])
    log(f"phase 12 done at {time.perf_counter() - t0:.1f}s")
    recurrent = phase_recurrent()
    log(f"phase 13 done at {time.perf_counter() - t0:.1f}s")
    moe_frontends = phase_moe_frontends()
    log(f"phase 14 done at {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    snn = phase_snn_track()
    log(f"phase 15 done at {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    roofline = phase_roofline(smi)
    log(f"phase 16 done at {time.perf_counter() - t0:.1f}s")
    mesh = phase_mesh(smi)
    log(f"phase 17 done at {time.perf_counter() - t0:.1f}s")
    tp = phase_tp(smi)
    log(f"phase 18 done at {time.perf_counter() - t0:.1f}s")
    train_mesh = phase_train_mesh(smi)
    log(f"phase 19 done at {time.perf_counter() - t0:.1f}s")
    by_name = {k["name"]: k for k in kernels}
    for name, key in (("ftp_bsr", "k3"), ("ftp_bsr_adaptive", "k4"),
                      ("ftp_spmm", "k1"), ("ftp_spmm_fused_lif", "k2")):
        entry = by_name[name]
        entry["snn_track"] = {"launches": snn["launches"][key]}
        assert snn["launches"][key] > 0, (name, snn["launches"])
    thff = next(r for r in snn["layers"] if r["case"] == "T-HFF")
    by_name["ftp_bsr"]["snn_track"].update(
        {k: thff[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                              "max_abs_err", "instance")},
        networks={n: {k: net[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                  for n, net in snn["networks"].items()})
    for name, key in (("ftp_spmm", "k1"), ("ftp_spmm_fused_lif", "k2")):
        by_name[name]["snn_track"].update(
            {k: thff[f"{key}_{k}"] for k in ("ms", "plain_ms", "bound_ms")},
            library_ms=thff["library_ms"])
    by_name["ftp_bsr"]["max_abs_err"] = max(
        by_name["ftp_bsr"]["max_abs_err"],
        max(r["max_abs_err"] for r in snn["layers"]),
        max(n["max_abs_err"] for n in snn["networks"].values()))
    for name in ("ftp_spmm", "ftp_spmm_fused_lif"):
        by_name[name]["max_abs_err"] = max(
            by_name[name]["max_abs_err"],
            max(r["dense_max_abs_err"] for r in snn["layers"]))
    by_name["ftp_bsr"]["mesh"] = mesh["kernel3"]
    by_name["ftp_bsr_adaptive"]["mesh"] = {
        "launches": mesh["adaptive"]["ftp_bsr_adaptive_launches"]}
    by_name["ftp_spmm"]["mesh"] = {"launches": mesh["dense"]["ftp_spmm_launches"]}
    by_name["ftp_spmm_fused_lif"]["mesh"] = {
        "launches": mesh["dense"]["ftp_spmm_fused_lif_launches"]}
    by_name["ftp_bsr"]["max_abs_err"] = max(by_name["ftp_bsr"]["max_abs_err"],
                                            mesh["kernel3"]["max_abs_err"],
                                            tp["dual"]["max_abs_err"])
    for name, part, key in (
            ("ftp_bsr", "dual", "ftp_bsr_launches"),
            ("ftp_bsr_adaptive", "dual", "ftp_bsr_adaptive_launches"),
            ("ftp_spmm", "dense", "ftp_spmm_launches"),
            ("ftp_spmm_fused_lif", "dense", "ftp_spmm_fused_lif_launches")):
        by_name[name]["tp"] = {"launches": tp[part][key]}
    assert all(k["launches"] > 0 for k in kernels), [k["launches"] for k in kernels]
    print(json.dumps({"recurrent": recurrent}), flush=True)
    print(json.dumps({"moe_frontends": moe_frontends}), flush=True)
    print(json.dumps({"snn_track": snn}), flush=True)
    print(json.dumps({"roofline": roofline}), flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
    print(json.dumps({"tp": tp}), flush=True)
    print(json.dumps({"train_mesh": train_mesh}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
