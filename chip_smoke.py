#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py [--profile] [--out chiprun_out/chip_smoke.json]

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. setup   — build the hand-written CUDA kernels from ``src/repro_torch``
             (one nvcc per source, in parallel); log each kernel's
             registers, spills and shared memory from the ``ptxas``
             report; TF32 off everywhere.
2. kernels — every kernel of the main paths at the Qwen1.5-0.5B, Kimi K2,
             Falcon Mamba 7B, OPT-125M (64 clients), Gemma 3 1B (8
             clients; the tied logits at N = 262,144), Qwen2-72B cut
             (4 clients; the untied logits at K = 8192, N = 152,064) and
             DeepSeek-V2 cut (4 clients: MLA's projections, 20 experts at
             capacity 99, the untied logits at N = 102,400) and Jamba cut
             (3 clients: d8192 with d_inner 16,384 and ff 24,576, 2 experts
             at capacity 330, the untied logits at N = 65,536; the scan at
             D 16,384), MusicGen-medium (8 clients: d1536, ff 6144, the
             untied logits at N = 2048) and InternVL2-26B cut (the pod
             step's: 8 clients over one W expanded with a client stride of
             0, M = 2 x 1057 rows a client, the untied logits at N =
             92,553; the projector, K 3200, N 6144 at M = 2 x 1024, a unit
             of its own; the update of one model; three timed calls a
             shape) shapes the paths give it, and the scan at the
             serving shapes of phase 17 (b) and (c) (8 sequences: a
             512-token prefill and a decode step, T = 1), held against its
             plain PyTorch version (rtol 1e-5, atol 1e-5, float32; the
             rank-1 products against it summed over the K ranges of their
             split-K, since two float32 orders of a 16,384-term sum part
             by more) and timed
             with CUDA events beside the plain version, one PyTorch library
             call computing the same function (none for the scan), and the
             least time the card could take (each shape's ratio to the
             library call and share of the bound are printed, and each
             unit's sums); the rank-1 products and the update kernel (every
             E) are also held bitwise equal across two calls; the update kernel
             runs at every matrix leaf of all six paths and of one
             TinyLlama-1.1B and one Gemma 3 1B (the serving folds, client
             axis 1, E = 2 summed and E = 1 printed; TinyLlama's in bf16
             too, the fold of phase 12 (e)), beside a
             ``copy_`` of the same W; the scan's backward
             (``selective_scan_bwd``) at the scan shapes of phase 9's
             first-order arms (4 and 3 clients x 8 sequences, T 33, D 8192,
             N 16), at T = 197 past its 64-step chunk (the checkpointed
             path) and at small odd shapes, with its plan, the bytes its
             design moves and the TB/s it reaches, bitwise across two
             calls; da, dbx and
             dh0 held against the plain reverse scan and autograd of the
             plain forward, dc (a sum over D = 8192) against a float64
             oracle at the same tolerance, its distance to the plain
             version printed; the bf16 paths (``*_bf16``: x, W and y, or
             the update's W, in bf16), one unit per kernel row at shapes
             phase 19 runs (InternVL2-26B's pod projections, untied logits
             and projector at 8 clients over one W, M = 2 x 1057; its
             model's update; Qwen1.5-0.5B's tied logits and, off the path,
             its replay at E = 2; the Jamba cut's experts at capacity
             330), each within one bf16 ulp (plus atol 1e-5) of its bf16
             plain version, bitwise across two calls, and timed beside
             ``baddbmm`` in bf16 and the bf16 bound (989 TFLOP/s, 3.35
             TB/s); the update at rank 64 (the paper's Fig. 6 sweep: the
             tensor-core kernel, which takes every bf16 update and float32
             past rank 32, its TF32 rate printed) on one Qwen1.5-0.5B in
             float32 and bf16, and its replay at E = 2; then ``prng.normal`` and
             ``prng.gumbel`` on
             the card held bitwise against the CPU on 2^20 draws each.
3. slice   — ``repro_torch.dtrain.runner.run``: SeedFlood, ring of 8
             clients, 3 steps at Qwen1.5-0.5B's full width (24 layers,
             d1024, vocab 151936), random weights from seed 0.  Launch
             counters are zeroed just before and read just after.
4. delayed — the same arch cut to 2 layers, flood_k=1, τ=2, drain, 6
             steps: replays cross τ-epochs, so the epoch kernel runs E >= 2.
5. kimi    — the same entry point on Kimi K2's MoE layer at its published
             widths (d7168, 64/8 heads of 128, expert ff 2048, top-8 + 1
             shared expert, untied head), cut to 1 layer of 61, 32 routed
             experts of 384 and vocab 20480 of 163840: 3 steps, ring of 8;
             ``rank1_matmul_expert`` must launch 6 times per step.
6. falcon  — the same entry point on Falcon Mamba 7B's Mamba-1 layer at its
             published widths (d4096, d_inner 8192, state 16, conv 4,
             dt_rank 256, vocab 65024, untied head), cut to 4 layers of 64:
             3 steps, ring of 8; ``selective_scan`` must launch exactly
             once per layer in every forward.
7. paper   — the paper's own setting: OPT-125M at its full published width
             (12 layers, d768, 12 heads of 64, ff 3072, vocab 50272, tied
             embeddings, learned positions, layernorm, relu, QKV bias), 64
             clients on the 8 x 8 mesh-grid with the bitset flood engine
             (``flood_backend="auto"``), 3 steps; the ledger must be the
             JAX FloodTransport's, ``rank1_matmul`` must launch 432 times
             (6 projections x 12 layers x 2 signed forwards x 3 steps) and
             ``rank1_matmul_t`` 6 times.
8. small   — the same code on small inputs (the dense sim arch, the
             reduced Kimi K2, the reduced Falcon Mamba, and the reduced
             OPT-125M at 64 clients on the mesh-grid, so that the bitset
             engine runs on both sides), every other method of the
             registry on the sim arch (d64, 4 clients on a ring, gossip
             every step) and dsgd on the reduced Falcon Mamba (autograd
             through the scan kernel's backward), the reduced MusicGen
             through ``run`` and the reduced MusicGen and InternVL with
             their embeddings through the pod SeedFlood step (the card's
             coefficients held to the CPU's, the card fed the CPU's), and
             one update with a frozen matrix and a frozen vector (bitwise
             untouched), on the card and on the CPU (the kernels' plain
             versions); results must agree.
9. baselines — first the four kernels at the shapes these paths give
             them (central_zo's dual forward over one OPT-125M expanded to
             16 clients with a client stride of 0, updates of one model),
             held against their plain versions and timed as in phase 2;
             then every baseline of the paper's §4.2 through the same entry
             point at OPT-125M's full published width, 16 clients on a
             ring, 2 steps, gossip every step (``local_iters=1``):
             central_zo (plain and with momentum 0.9), gossip_sr, dzsgd,
             dsgd, choco and the three LoRA variants.  Each arm's ledger
             must be the JAX transport's formula, its losses finite and its
             peak memory under 80 GiB; central_zo must launch
             ``rank1_matmul`` 288 times and ``rank1_matmul_t`` 4 times and
             ``subcge_apply`` at least once in both arms, gossip_sr
             ``subcge_apply_epochs``.  Then the first-order arms through
             Mamba layers: dsgd (4 clients) and choco (3: at 4 its
             surrogates and top-k temporaries overflow the card) on the
             Falcon Mamba cut, on a ring, 2 steps, gossip every step; each
             must
             launch ``selective_scan_bwd`` 4 layers x 2 steps = 8 times,
             keep its losses finite and its peak under 80 GiB, and charge
             the JAX GossipTransport's formula.
10. churn  — the paper's setting of phase 7 under churn: 64 clients on the
             8 x 8 mesh-grid, bitset engine, τ = 2, 6 steps; clients 18,
             19, 26, 27 leave at step 1 and rejoin at 4, the grid splits
             in halves at 2 and heals at 3.  The ledger (messages, bytes,
             sync bytes, syncs) must be the JAX FloodTransport's, the
             rejoin step's catch-up must run ``subcge_apply_epochs`` with
             E >= 2, and all 64 clients must end within 1e-10 consensus;
             the catch-up step's own time is printed.
11. resume — OPT-125M whole, 4 clients on a ring, SeedFlood, τ = 2,
             client 3 offline for steps 1-2, 5 steps with a checkpoint
             every 2 into a temporary directory; a run resumed from the
             step-2 checkpoint must end bitwise equal to the uninterrupted
             one (leaves, loss and consensus curves, ledger).  Prints the
             checkpoint's size and its write and read seconds.
12. serve  — ``repro_torch.serve`` at TinyLlama-1.1B's full width (22
             layers, d2048, 32 heads of 64 over 4 kv heads, ff 5632, vocab
             32000, untied), one model of random float32 weights from seed
             0, 8 slots over a pool of 128 pages of 16 positions: (a) 12
             greedy requests (prompts of 16-192 tokens from seed 0, 12 new
             tokens each) must equal, token for token, their monolithic
             streams (prefill and decode over a ring of 256); steps,
             prefills, decodes, the steady decode step (median, spread),
             prefill times, tok/s and peak memory are printed; (b)
             temperature 0.8 twice must give the same streams; (c) the
             messages of 8 trainer clients over 2 steps at τ = 1 folded
             through a ``LiveUpdateBridge`` at the start of step 3 must
             equal the offline fold (weights bitwise, streams token for
             token), with one ``subcge_apply_epochs`` launch at E = 2 per
             matrix leaf; (d) ``ServeSwarmSim`` (2 trainers and 2 servers
             on a ring of 4, 4 steps, server 3 leaves at 1 and rejoins at
             2) run twice must replay bitwise, with the JAX
             FloodTransport's ledger, and each server's final weights
             must equal, bitwise, the initial weights folded offline over
             the messages of that server's own folds; (e) the same model in
             bf16, as the JAX serve CLI serves it without ``--reduced``:
             (a)'s script, the paged streams equal to the monolithic bf16
             ones wherever a stream's smallest top-2 logit gap exceeds the
             largest paged-vs-monolithic logit gap (printed; at most 4 bf16
             ulps of the largest logit), the decode step against the cost
             model's bound (``roofline.cost_model.step_cost``), temperature
             0.8 twice identical, the live fold at E = 2 through
             ``subcge_apply_epochs_bf16`` bitwise the offline fold (tokens
             equal to the paged server given the offline weights at the
             same boundary), and ``python -m repro_torch.launch.serve``
             without ``--reduced`` (bf16).
13. async  — the event engine through the same entry point
             (``DTrainConfig(trace=...)``) at OPT-125M's full width, τ = 2,
             4 steps each: (a) 16 clients on a ring, client 3 away for
             steps 1-2, the event run on ``TraceSet.constant`` bitwise the
             synchronous run with ``drain`` (loss curve, every leaf,
             consensus) and both ledgers the JAX package's; (b) 64 clients
             on the 8 x 8 mesh-grid under ``TraceSet.two_speed`` (half the
             swarm 4x slower, 1 Gbit/s links, 10 ms latency): the JAX
             package's ledger, virtual time and cohort times exactly, 144
             ``rank1_matmul`` and 2 ``rank1_matmul_t`` launches per cohort
             (each cohort computes every row), a replay with E >= 2, all 64
             clients within 1e-10 after the drain, peak under 80 GiB; the
             wall per cohort, each replay's K, E and seconds, and per-client
             progress beside the barrier schedule are printed; (c) dsgd
             under the same trace, 16 clients on a ring, a mix every 2
             steps: the JAX formula's ledger and mix-delay virtual time.
             Phase 2 also checks the replay at OPT-125M's 64-client leaves
             with E = 2.
14. gemma  — Gemma 3 1B whole (26 layers in two groups: 4 periods of 5
             local slots with a 512-token window and 1 global, then 2
             local; d1152, 4 heads of 256 over 1 kv head, ff 6912 gated
             tanh-gelu, vocab 262,144 tied), random float32 weights from
             seed 0: (a) the main path, 8 clients on a ring, B 8, T 33, 3
             steps: the JAX ledger, 1,092 ``rank1_matmul`` and 6
             ``rank1_matmul_t`` launches, consensus < 1e-10, peak under 80
             GiB; (b) the window binds: 4 clients on a ring, B 2, 641
             tokens, 2 steps, the JAX ledger of a ring of 4, and on one
             model's weights the loss with the windows differs from the
             loss without them; (c) serving past the window: 4 greedy
             requests of 520-700 prompt tokens and 12 new through 8 slots
             over pages of 16 equal their monolithic streams (rings of 512
             in the local slots) token for token, and one of them a
             no-cache recompute; then a live fold at C = 1, E = 2 equals
             the offline fold, as in phase 12 (c).
15. qwen2  — the same entry point on the Qwen2-72B cut: every published
             width (d8192, 64 heads of 128 over 8 kv heads, QKV bias, ff
             29,568) and the untied vocabulary of 152,064, 1 of 80 layers,
             4 clients on a ring, 3 steps: the JAX ledger, 48
             ``rank1_matmul`` launches (the untied logits among them),
             consensus < 1e-10, peak under 80 GiB.
16. deepseek — the same entry point on the DeepSeek-V2 cut: every
             published width (d5120; MLA with 128 heads, nope 128, rope 64,
             values 128, q_lora 1536, kv_lora 512; dense ff 12,288; MoE
             top-6 + 2 shared experts of ff 1536) and the untied vocabulary
             of 102,400, its dense layer and 1 of 59 MoE layers, 20 of 160
             experts (the router cut with them): (a) 4 clients on a ring, 3
             steps: the JAX ledger, 96 ``rank1_matmul`` (``wukv`` is read
             unperturbed and launches nothing), 18 ``rank1_matmul_expert``
             and no ``rank1_matmul_t`` launches, both updates, consensus <
             1e-10, peak under 80 GiB; (b) serving one model of the cut
             (capacity factor 4.0: no expert overflows): 8 greedy
             sequences, a 512-token prefill through ``build_prefill_step``
             into the compressed cache (capacity 528), 16 absorbed decode
             steps through ``build_decode_step``, then a no-cache forward
             over the 528 tokens: the prefill's and every decode step's
             logits within rtol / atol 3e-4 of it; the prefill ms, the
             decode step's median and spread, tok/s, peak and the cache's
             bytes against the expanded K/V's are printed.
17. jamba  — the same entry point on the Jamba-1.5-Large cut: every
             published width (d8192; attention with 64 heads of 128 over 8
             kv heads and a dense ff 24,576; Mamba-1 with d_inner 16,384,
             state 16, conv 4, dt_rank 512 and a top-2 MoE of ff 24,576)
             and the untied vocabulary of 65,536, the period's first two
             slots once each (attention + dense, Mamba + MoE), 2 of 16
             experts: (a) 3 clients on a ring, 3 steps: the JAX ledger, 78
             ``rank1_matmul``, 18 ``rank1_matmul_expert``, one
             ``selective_scan`` per forward (the final accuracy pass and
             validation loss included) and no ``rank1_matmul_t`` launches,
             both updates, consensus < 1e-10, peak under 80 GiB; (b) one
             model of the cut and (c) Falcon Mamba 7B whole (64 layers)
             serve 8 greedy sequences through ``build_prefill_step`` (512
             tokens into the (h, conv) state, and the attention slot's
             ring of 528) and 16 decode steps through
             ``build_decode_step``, then a no-cache forward over the 528
             tokens: the prefill's and every decode step's logits within
             rtol / atol 3e-4 of it, one ``selective_scan`` per Mamba slot
             in each of them and no other launch; prefill ms, the decode
             step's median, spread and bound, tok/s, the cache's bytes and
             the peak are printed.
18. frontend — the frontend archs, random float32 weights from seed 0:
             (a) MusicGen-medium whole (48 layers, d1536, 24 heads of 64,
             plain gelu ff 6144, layernorm, sinusoidal positions, untied
             vocab 2048, the 768 -> 1536 projector) through ``run``, 8
             clients on a ring, 3 steps, text-only as the JAX Trainer: the
             JAX ledger, consensus < 1e-10, 1,734 ``rank1_matmul`` and no
             ``rank1_matmul_t`` launches, both updates, and the projector
             moved by the update though no loss reads it; (b) the
             InternVL2-26B cut (1 of 48 layers at every width: d6144, 48
             heads of 128 over 8 kv, gated silu ff 16,384, the untied
             92,553 vocabulary and the 3200 -> 6144 projector) through
             ``launch.steps``' pod SeedFlood step, 8 clients sharing one
             model, each 2 sequences of 1024 patch embeddings and 33
             tokens, 2 steps: 36 ``rank1_matmul`` (the projector's among
             them) and 20 ``subcge_apply`` launches, then the pod DSGD
             step for 2 steps (no hand-written kernel), in float32
             (``param_dtype=torch.float32``); steady step, peak
             and launches printed; (c) ``python -m
             repro_torch.launch.train`` on MusicGen-medium whole, 2 steps,
             in bf16 as the reference's CLI without ``--reduced`` (bf16
             kernels only), its step-2 checkpoint (``::bf16`` leaves) read
             back bitwise; (d) both served
             through ``build_prefill_step`` with their embeddings (the
             InternVL cut 1024 patches + 32 tokens, MusicGen 64 frames +
             512 tokens) and 16 decode steps, held to one no-cache forward
             at rtol / atol 3e-4; every paged builder refuses both.
19. bf16    — the pod runtime as the JAX pod runs it by default
             (``PodConfig``: bf16 parameters): (a) InternVL2-26B whole (48
             layers, every width, 19.9 G parameters in ~37 GiB of bf16,
             one copy) through the pod SeedFlood step in fold mode, 8
             clients x 2 sequences of 1024 patch embeddings and 33 tokens,
             2 steps and one profiled: every leaf bf16, finite losses,
             exactly the bf16 kernels' launches (676 ``rank1_matmul_bf16``
             and 10 ``subcge_apply_bf16`` a step), peak under 80 GiB,
             steady step and busy share printed, and one leaf's update
             (``g0/s0/w2``, layer 0, 256 rows) within one bf16 ulp of the
             plain update of the same messages; (b) buffer mode against
             fold mode on Qwen1.5-0.5B whole (tied), 8 clients, tau 2, 3
             steps: in float32 the effective weights equal fold mode's
             (rtol 2e-4, atol 2e-5); in bf16 the float32 buffers move, the
             matrix leaves stay bitwise until the step-2 refresh and then
             take the plain fold, and every vector leaf takes its plain
             update bitwise at every step; (c) the Jamba cut in bf16
             through the pod step (3 clients, 1 step): finite losses and
             phase 17's per-forward launches on the bf16 experts and
             products, the scan in float32; (d) 19 (a)'s trained weights
             served in bf16 (``serve_cached``: 4 sequences of 1024 patch
             embeddings and 32 tokens, 16 decode steps), the logits within
             8 bf16 ulps of one no-cache forward's largest logit, at most
             40 % past one, each token the forward's where its top-2 gap
             exceeds the logits' gap, the decode step against the cost
             model's bound.
20. rest    — the JAX package's last modules: (a) the paper's Fig. 5 and
             Table 4 at OPT-125M's full width (one model, float32, rank
             32): MeZO's dense-message replay (``zo.mezo_apply_messages``)
             against SubCGE's ``apply_messages`` at K = 1, 4 and 16, and
             each one's gradient estimate on one 8 x 33 batch, each the
             median of 3 host-clocked calls after a warm-up, beside its
             bound (MeZO: K passes over theta; SubCGE: one), the MeZO /
             SubCGE ratios printed; first the card's MeZO replay of the
             two smallest leaves at K = 4, bitwise the CPU's; (b) the
             per-client reference path (``batched_step=False``) on
             Qwen1.5-0.5B whole beside the batched path, 8 clients on a
             ring, 2 steps each: the ledgers equal, the leaves and losses
             within atol 1e-6 after step 1 and 1e-5 after step 2 (bitwise
             reported), ``subcge_apply`` once per client per matrix leaf,
             ``subcge_apply_epochs`` once per client with a live message
             per matrix leaf, the per-client / batched step ratio printed;
             both runs into ``--out`` through ``RunResult.to_json``.
21. report — one JSON line ``{"kernels": [...]}`` (the bf16 paths as
             kernels of their own, ``*_bf16``), the card's name and power
             limit, and last ``{"ok": true, "device": {...}}``.

A line ``[t] phase N took S s`` follows each phase.

``--profile`` adds a torch.profiler breakdown of one steady full-width step
of each slice (Gemma 3 1B's and the DeepSeek-V2 and Jamba cuts' too), of
the paper's setting, of each phase-9 baseline and
first-order Mamba arm, of phase 10's rejoin step (host spans,
device-busy time and share, device launches, top kernels, and the
hand-written kernels that ran, by name), and of one steady decode step of
phase 12 (busy share, launches, top kernels).

It needs a CUDA device and the repository's ``src/`` next to it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100 SXM's peaks at 700 W (float32 on the CUDA cores, dense bf16 on
# the tensor cores, HBM3) live with the port's cost model, which bounds the
# served steps too
from repro_torch.roofline.cost_model import (  # noqa: E402
    PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_HBM_BYTES, Cost, bound_ms)
RTOL = ATOL = 1e-5
# phase 2: the plain version's and the library call's timed calls and
# warm-ups beside each kernel unit, at most (3 and 2 until phase 20 needed
# the time; the kernels keep theirs)
REF_TIMING = (2, 1)
# what the JAX package's FloodTransport charges a ring of 8
# (tests/test_torch_slice.py pins the port's transport to the same values)
LEDGER_RING8_3STEPS = (368, 2944)
LEDGER_RING8_6STEPS_K1_DRAIN = (768, 6144)
# ... and the 8 x 8 mesh-grid of the paper's setting, bitset engine
# (tests/test_torch_paper_setting.py pins the port to the same values)
LEDGER_MESHGRID64_3STEPS = (43000, 344000)
PAPER_CLIENTS, PAPER_TOPOLOGY = 64, "meshgrid"
# phase 9: the paper's Table 8 runs its baselines with 16 clients; 2 steps
# (3 until the frontend phase needed the time: gossip_sr's steady step is
# 10-15 s)
BASELINE_CLIENTS, BASELINE_STEPS = 16, 2
BASELINE_ARMS = (("central_zo", {}), ("central_zo", {"momentum": 0.9}),
                 ("gossip_sr", {}), ("dzsgd", {}), ("dsgd", {}),
                 ("choco", {}), ("dsgd_lora", {}), ("dzsgd_lora", {}),
                 ("choco_lora", {}))
# one gossip exchange of OPT-125M's 126,755,328 floats on the 16 edges of
# the ring, both ways (the JAX GossipTransport's 2 x edges x floats x 4 B),
# and Choco's top-k payload of 1% of them (values and indices, 8 B each)
DSGD_EXCHANGE_BYTES = 16_224_681_984
CHOCO_EXCHANGE_BYTES = 324_493_568
# phase 9: the first-order arms through the Falcon Mamba cut, and their
# clients on a ring.  Choco takes 3: with 4 (14.2 GiB a stacked copy) it
# holds Setup's init, the trainable, x-hat and the mixed copy (72.8 GiB)
# when its top-k over embed/tok asks for another 3.97 GiB, and the card
# runs out (first call on the card, NVIDIA H100 80GB HBM3, 700.00 W); 2
# steps each (3 until the bf16 serving arms needed the time)
FO_MAMBA_ARMS, FO_MAMBA_STEPS = (("dsgd", 4), ("choco", 3)), 2
# phase 10: the paper's setting under churn, 6 steps at tau = 2; what the
# JAX FloodTransport charges its script (messages, bytes, sync_bytes,
# n_syncs; tests/test_torch_churn.py derives it from the JAX transport)
CHURN_STEPS, CHURN_TAU = 6, 2
LEDGER_MESHGRID64_CHURN_6STEPS = (82602, 668088, 15912, 18)
# phase 11: resume, 4 clients (8 until the bf16 phase needed the time; one
# OPT-125M checkpoint of 64 clients would be 30.2 GiB)
RESUME_CLIENTS, RESUME_STEPS = 4, 5
# phase 12: serving TinyLlama-1.1B whole (float32, random weights from seed
# 0): 12 requests of prompts drawn between 16 and 192 tokens and 12 new
# tokens each (16 and 16 until phase 20 needed the time, 32 new tokens
# until the frontend phase) through 8 slots, so that admission, eviction
# and page reuse all happen; the
# monolithic reference decodes over a ring of SERVE_MAX_SEQ
SERVE_ARCH = "tinyllama-1.1b"
SERVE_GEOMETRY = dict(max_batch=8, page_size=16, max_seq=256, n_pages=128)
SERVE_REQUESTS, SERVE_NEW, SERVE_PROMPT = 12, 12, (16, 192)
# the live-update fold: the messages of 8 trainer clients over 2 steps at
# tau = 1 (so E = 2), folded at the start of server step 3, rank 16
SERVE_FOLD_CLIENTS, SERVE_FOLD_STEPS, SERVE_FOLD_E, SERVE_FOLD_AT = 8, 2, 2, 3
SERVE_RANK, SERVE_SEED = 16, 0
# (e) the same model served in bf16, as the JAX serve CLI serves it without
# --reduced: phase 12's script, geometry and fold.  bf16 logits tie and part
# by an ulp more often than float32 ones: the paged streams must equal the
# monolithic ones wherever a stream's smallest top-2 logit gap exceeds the
# largest paged-vs-monolithic logit gap, and that gap must stay within
# BF16_LOGIT_ULPS bf16 ulps of the largest logit (the CPU tests' limit,
# tests/test_torch_serve_bf16.py).  Then the CLI without --reduced
BF16_LOGIT_ULPS = 4
SERVE_CLI_ARGV = ["--batch", "4", "--requests", "4", "--prompt-len", "32",
                  "--new", "8"]
# the swarm: 2 trainers and 2 servers on a ring of 4, 4 train steps, server
# 3 leaves at step 1 and rejoins at 2; what the JAX FloodTransport charges
# that script (messages, bytes, sync_bytes, n_syncs;
# tests/test_torch_serve_swarm.py derives it from the JAX transport)
SWARM_STEPS, SWARM_LEAVE = 4, ((3,), 1, 2)
LEDGER_SERVE_SWARM_4STEPS = (56, 502, 70, 2)
# phase 13: the event engine at OPT-125M's full width, 4 steps at tau = 2
# each; the constants are the JAX package's (tests/test_torch_async.py
# derives them with stub methods: none depends on the model).  (a) 16
# clients on a ring, client 3 away for steps 1-2, TraceSet.constant against
# the synchronous run with drain: (messages, bytes, sync_bytes, n_syncs)
ASYNC_STEPS, ASYNC_TAU, ASYNC_RING = 4, 2, 16
LEDGER_ASYNC_RING16_CHURN = (1952, 15802, 426, 2)
# (b) the 8 x 8 mesh-grid of 64 under two_speed (half the swarm 4x slower,
# 1 Gbit/s links, 10 ms latency): (messages, bytes), the virtual time, the
# cohorts' virtual times
ASYNC_TRACE = dict(fast_s=1.0, slow_s=4.0, bandwidth_bps=1e9, latency_s=0.01)
LEDGER_ASYNC_MESHGRID64 = (57344, 458752)
VTIME_ASYNC_MESHGRID64 = 16.300001152000018
COHORTS_ASYNC_MESHGRID64 = (1.0, 2.0, 3.0, 4.0, 4.0, 8.0, 12.0, 16.0)
# (c) dsgd, 16 clients on a ring, a mix every 2 steps, the same trace: two
# exchanges of DSGD_EXCHANGE_BYTES, each a barrier of 2 x 10 ms + 1.01 GB
# per edge at 1 Gbit/s
LEDGER_ASYNC_DSGD16 = 2 * DSGD_EXCHANGE_BYTES
VTIME_ASYNC_DSGD16 = 24.132340992
# phase 14: Gemma 3 1B whole (random float32 weights from seed 0).  (b) the
# window binds: 4 clients on a ring, B 2, 640 tokens and the label slot, 2
# steps, a short evaluation (at 128 rows of 641 tokens the logits alone
# would be 86 GB); what the JAX FloodTransport charges a ring of 4
# (tests/test_torch_slice.py derives it from the JAX transport)
GEMMA_ARCH = "gemma3-1b"
LONG_CLIENTS, LONG_B, LONG_STEPS = 4, 2, 2
LONG_TASK = dict(seq_len=640, n_valid=8, n_test=8)
LEDGER_RING4_2STEPS = (56, 448)
# (c) serving past the window: 4 greedy requests (8 until the bf16 serving
# arms needed the time) of 520-700 prompt tokens
# (every one past the 512-token window) and SERVE_NEW new, through 8 slots
# over pages of 16; the monolithic reference decodes over rings of 768
# (512 in the local slots)
GEMMA_SERVE = dict(max_batch=8, page_size=16, max_seq=768, n_pages=384)
GEMMA_REQUESTS, GEMMA_PROMPT = 4, (520, 700)
# phase 15: the Qwen2-72B cut (archs.qwen2_cut: 1 of 80 layers, every width,
# the untied 152,064 vocabulary), 4 clients on a ring, 3 steps
QWEN2_CLIENTS = 4
LEDGER_RING4_3STEPS = (88, 704)
# ... and on a ring of 3 (the Jamba cut, phase 17)
LEDGER_RING3_3STEPS = (42, 336)
# phase 16: the DeepSeek-V2 cut (archs.deepseek_cut: the dense layer, 1 of
# 59 MoE layers, 20 of 160 experts, every width, the untied 102,400
# vocabulary; 8.2 GB of float32 a client).  (a) 4 clients on a ring, 3 steps
DEEPSEEK_CLIENTS = 4
# (b) serving one model of the cut: 8 greedy sequences, a 512-token prefill
# into a compressed cache of 528, 16 absorbed decode steps (32 until the
# bf16 phase needed the time), then a no-cache forward over all 528 tokens
# that the prefill's and every decode step's
# logits are held to (the JAX package holds its prefill and decode to its
# forward at 2e-4 and 3e-4, tests/test_models.py)
DEEPSEEK_SERVE_B, DEEPSEEK_PROMPT, DEEPSEEK_NEW = 8, 512, 16
FORWARD_TOL = 3e-4
# ... and in bf16 (phase 19 (d)), in bf16 ulps of the forward's largest
# logit: at most BF16_FORWARD_ULPS every logit, at most BF16_FORWARD_PAST of
# them past one, and every decode row's token the forward's wherever the
# forward's top-2 gap exceeds the largest logit gap.  Set from the first
# measurement (InternVL2-26B whole, 48 layers of bf16 activations; NVIDIA
# H100 80GB HBM3, 700.00 W): the prefill bitwise, the 16 decode steps at
# most 5.25 ulps and 26.8 % of the logits past one, the limits 1.5x that,
# as test_bf16_lm_loss_matches_jax's are.  The cause, measured since
# (``gemm_witness``, ``serve_cached(witness=True)``): a T = 1 step runs other
# GEMM shapes than the forward, and cuBLAS's bf16 products of the same row
# differ at them (layer 0: 0-0.8 % of outputs, up to 0.5 ulp); the hidden
# state is bitwise at layer 0's input, 1 ulp off after it and grows layer
# by layer to 7.5 ulps at the final norm, with no step between layers; a
# second prompt seed reads 5.28 ulps and 26.3 %
BF16_FORWARD_ULPS, BF16_FORWARD_PAST = 8, 0.4
# capacity dispatch drops tokens by batch size and order, so at the
# published 1.25 a prefill of 4096 tokens, a decode of 8 and a forward of
# 4352 route differently and no comparison across them holds; 4.0 >= 20
# experts / top-6, so no expert can overflow (the JAX package's reduced
# variants take 8 for the same reason).  Training, (a), keeps 1.25
DEEPSEEK_SERVE_CAPACITY = 4.0
# phase 17: the Jamba-1.5-Large cut (archs.jamba_cut: the period's attention
# + dense slot and Mamba + MoE slot, 2 of 16 experts, every width, the
# untied 65,536 vocabulary; 13.8 GB of float32 a client).  (a) 3 clients on
# a ring, 3 steps: with 4 (51.5 GiB of params and the 12.9 GiB averaged
# model) the final accuracy pass's Mamba inputs a and bx (4.1 GiB each at
# 128 rows) overflow the card (first call on the card, NVIDIA H100 80GB
# HBM3, 700.00 W)
JAMBA_CLIENTS = 3
# (b) one model of the cut and (c) Falcon Mamba 7B whole (64 layers, 29.1
# GB) serve as 16 (b) does: 8 greedy sequences, a 512-token prefill into
# the (h, conv) state (and the attention slot's ring of 528), 16 decode
# steps, held to one no-cache forward at FORWARD_TOL.  The MoE sends every
# token to both of its 2 experts (top-2), so the published capacity factor
# of 1.25 drops none and prefill, decode and forward route alike
MAMBA_SERVE_B, MAMBA_PROMPT, MAMBA_NEW = 8, 512, 16
# phase 18: the frontend archs, random float32 weights from seed 0.  (a)
# MusicGen-medium whole (48 layers, 1,366,723,584 parameters, 5.09 GiB a
# client) through run with the DTrainConfig defaults: 8 clients on a ring,
# B 8, T 33, 3 steps, text-only as the JAX Trainer (its projector takes
# updates no loss reads: the reference's behaviour); 40.7 GiB of params
MUSICGEN_ARCH = "musicgen-medium"
# (b) the InternVL2-26B cut (archs.internvl_cut: 1 of 48 layers at every
# width, the untied 92,553 vocabulary and the 3200 x 6144 projector; 5.76
# GiB) through the pod steps: 8 clients share one model, each with B 2
# sequences of 1024 patch embeddings and 33 tokens; 2 SeedFlood steps (3
# and one profiled until the bf16 phase, which profiles the pod step, needed
# the time), then 2 DSGD steps, in float32 at the other PodConfig defaults
# (lr 1e-5, rank 32, tau 1000)
POD_CLIENTS, POD_B, POD_TEXT = 8, 2, 33
POD_SF_STEPS, POD_DSGD_STEPS = 2, 2
# (c) the launch.train CLI on MusicGen-medium whole: 2 steps of 8 clients x
# 2 sequences of 64 conditioning frames and 33 tokens, a checkpoint at
# step 2, read back bitwise
CLI_ARGV = ["--arch", MUSICGEN_ARCH, "--steps", "2", "--batch", "16",
            "--seq", "97", "--n-clients", "8", "--ckpt-every", "2"]
# (d) serving one model of each: 8 greedy sequences, the embeddings and a
# prompt prefilled, 16 decode steps, held to one no-cache forward at
# FORWARD_TOL: the InternVL cut 1024 patches + 32 tokens, MusicGen 64
# frames + 512 tokens (608 positions: past no table, sinusoidal positions
# are unclipped)
FRONTEND_SERVE_B, FRONTEND_NEW = 8, 16
INTERNVL_PROMPT, MUSICGEN_PROMPT = 32, 512
# phase 19: the pod runtime as the JAX pod runs it by default, bf16
# parameters through the kernels' bf16 paths.  (a) InternVL2-26B whole (48
# layers, every width, the untied 92,553 vocabulary and the 3200 -> 6144
# projector; 19.9 G parameters, ~37 GiB in bf16) at the PodConfig defaults
# (bf16, fold mode, lr 1e-5, rank 32, tau 1000): POD_CLIENTS clients
# sharing one model, each POD_B sequences of 1024 patch embeddings and
# POD_TEXT tokens, BF16_STEPS steps (3 until the bf16 serving arms needed
# the time) and one profiled; the update check
# reads the first BF16_CHECK_ROWS rows of layer 0 of BF16_CHECK_LEAF
BF16_ARCH, BF16_STEPS = "internvl2-26b", 2
BF16_CHECK_LEAF, BF16_CHECK_ROWS = "g0/s0/w2", 256
# (d) then the same weights serve BF16_SERVE_B greedy sequences of 1024
# patches and INTERNVL_PROMPT tokens, FRONTEND_NEW decode steps, against one
# no-cache forward (the bf16 limits BF16_FORWARD_ULPS / _PAST)
BF16_SERVE_B = 4
# (b) buffer mode against fold mode on Qwen1.5-0.5B whole (tied logits: the
# transposed path), 8 clients x 2 sequences of 33 tokens, tau 2 (a fold at
# step 2), 3 steps, in float32 and in bf16
BUFFER_ARCH, BUFFER_TAU, BUFFER_STEPS, BUFFER_B = "qwen1.5-0.5b", 2, 3, 2
# (c) the Jamba cut in bf16 through the pod step: JAMBA_CLIENTS clients
# sharing one model, 8 sequences of 33 tokens each (the expert capacity
# then is phase 2's, 330 rows), 1 step (2 until the bf16 serving arms
# needed the time)
JAMBA_POD_STEPS = 1
SOURCES = {
    "rank1_matmul": ("src/repro_torch/kernels/csrc/rank1_matmul.cu",
                     "src/repro/kernels/rank1_matmul.py:63"),
    "rank1_matmul_t": ("src/repro_torch/kernels/csrc/rank1_matmul.cu",
                       "src/repro/kernels/rank1_matmul.py:128"),
    "subcge_apply": ("src/repro_torch/kernels/csrc/subcge_apply.cu",
                     "src/repro/kernels/subcge_apply.py:53"),
    "subcge_apply_epochs": ("src/repro_torch/kernels/csrc/subcge_apply.cu",
                            "src/repro/kernels/subcge_apply.py:70"),
    "rank1_matmul_expert": ("src/repro_torch/kernels/csrc/rank1_matmul.cu",
                            "src/repro/kernels/rank1_matmul.py:191"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:67"),
    # no Pallas kernel: the JAX package differentiates _ssm_chunked
    "selective_scan_bwd": ("src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
                           "src/repro/models/layers.py:327"),
}
# the bf16 paths of the same kernels (rank1_gemm_bf16, subcge_stream_kernel
# on bf16 W), which the same TPU kernels take bf16 parameters through
SOURCES.update({name + "_bf16": SOURCES[name] for name in (
    "rank1_matmul", "rank1_matmul_t", "subcge_apply", "subcge_apply_epochs",
    "rank1_matmul_expert")})
# the update's rank in the paper's Fig. 6 sweep (benchmarks/paper_tables.py),
# past the float32 stream's 32: phase 2 holds the tensor-core kernel to the
# plain rank-64 update
RANK_SWEEP = 64
# phase 8: steps of each small-input run (3 until the frontend phase, 2
# until the bf16 serving arms needed the time: one step runs the dual
# forward, the update, the flood or gossip and the replay on both devices)
SMALL_STEPS = 1
# phase 20 (a): the paper's Fig. 5 / Table 4 setting (benchmarks/
# paper_tables.py: rank 32, one tau-epoch, 1e-4 coefficients) at OPT-125M's
# full width: messages K per replay and timed calls per unit
FIG5_KS = (1, 4, 16)
FIG5_RANK = 32
FIG5_REPS = 3
# phase 20 (b): the per-client reference path beside the batched one, 2
# steps each
PER_CLIENT_STEPS = 2
# batch of the final accuracy pass (``data.synthetic.accuracy``)
EVAL_BATCH = 128
# the test split of the slices' runs (run_slice) and of phase 20 (b): one
# accuracy batch (1,000 samples, 8 batches, until phase 20 needed the
# time; the training split comes first from the task's rng, so it is the
# same)
SLICE_TEST = EVAL_BATCH
# the slices' runs: clients on a ring and sequences per client (32 tokens and
# the label slot each)
SLICE_CLIENTS, SLICE_B = 8, 8
# the update check compares the kernel's result with the plain version on
# slices of W of at most this many bytes (the kernel runs on the whole leaf)
CHECK_SLICE_BYTES = 2 * 2**30


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn()`` (CUDA events per call)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS):
    """The least ms the card takes to move ``nbytes`` and do ``flops`` at
    ``peak``, and which of the two sets it."""
    by = "bytes" if nbytes / PEAK_HBM_BYTES >= flops / peak else "operations"
    return bound_ms(Cost(flops=flops, bytes=nbytes), peak), by


def speed(ms, plain_ms, library_ms, b_ms, b_by) -> str:
    """A kernel's times, its ratio to the library call and its share of the
    bound, as one log fragment."""
    lib = "none" if library_ms is None else \
        f"{library_ms:.4f} ms (kernel/library {ms / library_ms:.2f}x)"
    return (f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {lib} bound "
            f"{b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} reached)")


def ptxas_report(name: str) -> list:
    """Registers, spills and static shared memory of each kernel in
    ``csrc/<name>.cu``, from the ``ptxas -v`` report of its build."""
    from repro_torch.kernels import build
    path = build.log_path(name)
    if not path.exists():
        return []
    out, cur = [], None
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


#: the tensor-core witness of every bf16 product unit (``Entry.witness``)
WITNESS: list = []


def bf16_excess(got, want, acc_atol: float) -> dict:
    """How far bf16 ``got`` lies from bf16 ``want``: past one bf16 ulp (of
    ``want``) + ATOL, the count (``past_ulp``), the largest excess as a
    fraction of the accumulation allowance ``acc_atol`` · max |want|
    (``excess``), the count past that allowance (``bad``), the share
    bitwise (``same``) and the farthest element (``at``)."""
    import torch
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{got.dtype} against {want.dtype}, not bf16")
    w = want.float()
    diff = (got.float() - w).abs()
    err, amax = float(diff.max()), float(w.abs().max())
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
    over = diff.sub_(ulp).sub_(ATOL)
    del ulp
    acc = acc_atol * amax
    worst = int(over.argmax())
    out = {"err": err, "amax": amax, "acc": acc,
           "past_ulp": int((over > 0).sum()), "bad": int((over > acc).sum()),
           "excess": max(0.0, float(over.reshape(-1)[worst]) / acc)
           if acc else 0.0,
           "at": (float(w.reshape(-1)[worst]),
                  float(got.reshape(-1)[worst])),
           "same": float((got.view(torch.int16) == want.view(torch.int16))
                         .float().mean())}
    del w, over
    return out


class Entry:
    """Accumulates one kernel's numbers over the shapes the path gives it.
    A bf16 entry (its name ends in ``_bf16``) is held to one bf16 ulp of the
    plain version plus ATOL, and bounded by the bf16 tensor-core peak."""

    def __init__(self, name):
        self.name = name
        self.bf16 = name.endswith("_bf16")
        self.peak = PEAK_BF16_FLOPS if self.bf16 else PEAK_F32_FLOPS
        self.err = 0.0
        self.ms = self.plain_ms = 0.0
        self.library_ms = 0.0           # None: no PyTorch call computes it
        self.nbytes = self.flops = 0.0
        # bf16 products: the float32 accumulation error of K / 16
        # tensor-core steps, per unit of max |y| (``tensor_core_atol``)
        self.acc_atol = 0.0
        # the update's tensor-core kernel: its TF32 operations (three
        # products of k = E rp an element), for its rate
        self.tc_flops = 0.0
        self.last = None                # check_bf16's counts, for witness

    def add_library(self, ms):
        self.library_ms = None if ms is None or self.library_ms is None \
            else self.library_ms + ms

    def check(self, got, want, what) -> tuple:
        """(max |got - want|, max |want|); raises unless every element of
        ``got`` is within tolerance of ``want``."""
        import torch
        if self.bf16:
            return self.check_bf16(got, want, what)
        diff = (got - want).abs()
        err = float(diff.max())
        if not bool(torch.all(diff <= ATOL + RTOL * want.abs())):
            raise AssertionError(f"{self.name} {what}: kernel disagrees with "
                                 f"its plain version (max abs {err})")
        return err, float(want.abs().max())

    def check_bf16(self, got, want, what) -> tuple:
        """bf16 ``got`` within one bf16 ulp of ``want`` (bf16) plus ATOL
        plus ``acc_atol`` · max |want|: both sum in float32 and cast once,
        in other orders (ATOL is the float32 paths' own tolerance for
        that), so a sum near a rounding boundary may land on the
        neighbouring bf16; the tensor cores' float32 accumulation adds
        ``acc_atol`` (``tensor_core_atol``).  Prints the share of elements
        that agree bitwise, and how many lie past one ulp + ATOL alone."""
        x = bf16_excess(got, want, self.acc_atol)
        self.last = x
        log(f"    {self.name} {what}: {x['same']:.4%} of elements bitwise "
            f"the plain version's, {x['past_ulp']} past one ulp + atol "
            f"{ATOL} (the farthest: plain {x['at'][0]!r}, kernel "
            f"{x['at'][1]!r}; {x['excess']:.3f} of the accumulation's "
            f"{x['acc']:.2e}), {x['bad']} past that + the accumulation's")
        if x["bad"]:
            raise AssertionError(f"{self.name} {what}: kernel disagrees with "
                                 f"its plain version ({x['bad']} elements "
                                 f"past one bf16 ulp, max abs {x['err']})")
        return x["err"], x["amax"]

    def witness(self, library, want, what) -> None:
        """The tensor-core witness of a bf16 product: ``library`` (cuBLAS in
        bf16, float32 accumulation on the same tensor cores) measured
        against the same plain version as the kernel just was, by the same
        counts.  Not a check: the allowance rests on it (``WITNESS``)."""
        x = bf16_excess(library, want, self.acc_atol)
        k = self.last
        WITNESS.append({"kernel": self.name, "shape": what,
                        "past_ulp": k["past_ulp"], "excess": k["excess"],
                        "lib_past_ulp": x["past_ulp"],
                        "lib_excess": x["excess"], "lib_bad": x["bad"],
                        "n": want.numel()})
        log(f"    witness baddbmm bf16 {what}: {x['past_ulp']} past one ulp "
            f"+ atol (kernel {k['past_ulp']}), largest excess "
            f"{x['excess']:.3f} of the accumulation allowance (kernel "
            f"{k['excess']:.3f}), {x['bad']} past it")

    def add(self, got, want, ms, plain_ms, library_ms, nbytes, flops, what,
            count=1):
        """Check one shape (``count`` uses of it per unit) and add it."""
        self.add_checked(self.check(got, want, what), ms, plain_ms,
                         library_ms, nbytes, flops, what, count)

    def add_checked(self, checked, ms, plain_ms, library_ms, nbytes, flops,
                    what, count=1):
        """Add one shape whose result ``check`` passed: ``checked`` is its
        (max abs error, max |want|)."""
        err, want_max = checked
        b_ms, b_by = bound(nbytes, flops, self.peak)
        tol = "1 bf16 ulp + atol" if self.bf16 else f"rtol {RTOL} atol"
        log(f"  {self.name:20s} {what:36s} x{count} max_abs {err:.3e} "
            f"(|want| max {want_max:.3e}; tol {tol} "
            f"{ATOL}) | {speed(ms, plain_ms, library_ms, b_ms, b_by)}")
        self.err = max(self.err, err)
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.add_library(None if library_ms is None else count * library_ms)
        self.nbytes += count * nbytes
        self.flops += count * flops

    def line(self) -> str:
        """The unit's sums: times, ratio to the library, share of the
        bound, and the update's TF32 rate on the tensor cores."""
        b_ms, b_by = bound(self.nbytes, self.flops, self.peak)
        rate = "" if not self.tc_flops else \
            f"; TF32 {self.tc_flops / self.ms / 1e9:.1f} TFLOP/s"
        return f"{self.name} unit: " + speed(self.ms, self.plain_ms,
                                             self.library_ms, b_ms,
                                             b_by) + rate

    def summary(self) -> dict:
        b_ms, b_by = bound(self.nbytes, self.flops, self.peak)
        return {"max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": self.library_ms}


def record(name: str, parts: list, launches: int) -> dict:
    """One kernel's line of the report: its numbers summed over the units of
    every path that runs it (``parts``), its launches over those runs."""
    e = Entry(name)
    for p in parts:
        e.err = max(e.err, p.err)
        e.add_library(p.library_ms)
        for k in ("ms", "plain_ms", "nbytes", "flops"):
            setattr(e, k, getattr(e, k) + getattr(p, k))
    src, rep = SOURCES[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, **e.summary()}


def bits(t):
    """A float32 or bf16 tensor's bits, for bitwise comparisons."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def same_bits(a, b, what: str) -> None:
    """Two calls on the same inputs must give the same bits (no atomics)."""
    import torch
    if a.dtype != b.dtype or not torch.equal(bits(a), bits(b)):
        raise AssertionError(f"{what}: two calls on the same inputs differ")


def tensor_core_atol(K: int) -> float:
    """The float32 accumulation error of a bf16 product over K, per unit of
    max |y|: the tensor cores (``wgmma``'s k16 steps, as ``mma.sync``'s
    m16n8k16 did) add each step's 16 exact products to the float32
    accumulator and truncate the sum toward zero (up to one float32 ulp
    of the running sum a step), where the plain version's
    float32 FMAs round to nearest: K / 16 steps of at most 2^-23 ·
    |partial sum|, the partial sums taken as large as max |y|.  Phase 2
    prints the kernel's largest excess as a share of it beside cuBLAS's
    ``baddbmm`` in bf16 at the same shapes (``Entry.witness``)."""
    return K / 16 * 2.0 ** -23


def cublas_f32_sums(fn):
    """``fn()`` with cuBLAS's bf16 products summed in float32 throughout
    (no reduced-precision split-K reduction): the library's tensor-core
    arithmetic, the same as the kernel's accumulation."""
    import torch
    m = torch.backends.cuda.matmul
    old = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        return fn()
    finally:
        m.allow_bf16_reduced_precision_reduction = old


def plain_split(chunk, K: int, kper: int):
    """The plain version summed over the K ranges a split-K launch takes
    (``kper`` each, the last shorter), in float32 and ascending order, as
    ``rank1_reduce`` sums the kernel's partial sums: ``chunk(k0, k1)`` is
    the plain version on the inputs cut to ``k0:k1`` along K.  The check
    then compares the kernel's arithmetic, not two summation orders of one
    long dot product, which part by more than rtol / atol 1e-5 at K =
    16,384 (the DeepSeek-V2 cut's wo: the unsplit plain version's distance
    to the kernel is printed beside).  One range is the plain version
    itself."""
    want = chunk(0, kper)
    for k0 in range(kper, K, kper):
        want += chunk(k0, min(K, k0 + kper))
    return want


def check_rank1(e: Entry, C: int, M: int, shapes, randn,
                trans: bool = False, shared: bool = False,
                reps: int = 3, warmup: int = 2) -> None:
    """rank1_matmul (rank1_matmul_t when ``trans``) at (K, N) shapes,
    ``count`` uses each per unit, held against the plain version summed
    over the kernel's K ranges (``plain_split``) and bitwise equal across
    two calls.  W and the contracted vector are scaled by K^-1/2.  ``shared``:
    one W for all C clients, expanded with a client stride of 0 (central_zo's
    dual forward over its one model, and the pod step's over its one).
    ``reps`` timed calls each after ``warmup`` (fewer where one call takes
    a tenth of a second or more).  A bf16
    entry (``e.bf16``) takes x and W in bf16: its plain version is summed
    over the K ranges in float32 and cast once, and the library call is
    ``baddbmm`` in bf16, also held to that plain version as the
    tensor-core witness."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rank1_matmul as r1
    s = torch.tensor(([1e-3, -1e-3] * C)[:C], device="cuda")
    fn = ops.rank1_matmul_t if trans else ops.rank1_matmul
    plain = r1.rank1_matmul_t_plain if trans else r1.rank1_matmul_plain
    dt, esz = (torch.bfloat16, 2) if e.bf16 else (torch.float32, 4)
    for (K, N), count in shapes:
        x = randn(C, M, K).to(dt)
        CW = 1 if shared else C
        W = randn(CW, N, K, scale=K ** -0.5) if trans else \
            randn(CW, K, N, scale=K ** -0.5)
        W = W.to(dt).expand(C, -1, -1)
        u, v = (randn(C, N), randn(C, K, scale=K ** -0.5)) if trans else \
            (randn(C, K, scale=K ** -0.5), randn(C, N))
        got = fn(x, W, u, v, s)
        same_bits(got, fn(x, W, u, v, s), e.name)
        splits, kper = r1.gemm_plan(
            C, 1, M, N, K, bf16=e.bf16,
            fold=r1.folds(C, 1, M, K, x.stride(0), W.stride(0)))
        # the float32 operands the plain version reads (one W copy shared)
        xf, Wf = r1.to_f32(x), r1.to_f32(W)
        if trans:
            def chunk(k0, k1):
                return plain(xf[..., k0:k1], Wf[..., k0:k1], u, v[:, k0:k1],
                             s)
        else:
            def chunk(k0, k1):
                return plain(xf[..., k0:k1], Wf[:, k0:k1], u[:, k0:k1], v, s)
        want = plain_split(chunk, K, kper).to(dt)
        whole = "" if splits == 1 else " unsplit plain " + format(
            float((plain(x, W, u, v, s).float() - got.float()).abs().max()),
            ".1e")
        cvec, ovec = (v, u) if trans else (u, v)
        R = ((s[:, None, None] * torch.bmm(xf, cvec[..., None]))
             * ovec[:, None, :]).to(dt)
        del xf, Wf
        Wn = W.transpose(1, 2) if trans else W
        ref = (min(reps, REF_TIMING[0]), min(warmup, REF_TIMING[1]))
        ms = time_ms(lambda: fn(x, W, u, v, s), reps, warmup)
        p_ms = time_ms(lambda: plain(x, W, u, v, s), *ref)
        l_ms = time_ms(lambda: torch.baddbmm(R, x, Wn), *ref)
        nbytes = esz * (C * M * K + CW * K * N + C * M * N) \
            + 4 * (C * K + C * N + C)
        flops = 2 * C * M * K * (N + 1) + 3 * C * M * N
        shape = f"W({CW},{N},{K})" if trans else f"W({CW},{K},{N})"
        shape += " expanded to C" if shared else ""
        e.acc_atol = tensor_core_atol(K) if e.bf16 else 0.0
        what = f"x({C},{M},{K}) {shape} S={splits}{whole}"
        e.add(got, want, ms, p_ms, l_ms, nbytes, flops, what, count)
        if e.bf16:
            e.witness(cublas_f32_sums(lambda: torch.baddbmm(R, x, Wn)), want,
                      what)
        del x, W, got, want, R, Wn
        torch.cuda.empty_cache()


def update_leaves(arch, C: int) -> list:
    """(batch, n, m, count) of every matrix leaf one update of ``arch``'s
    stacked C-client params visits."""
    from repro_torch.core.subcge import update_shapes
    from repro_torch.models.params import subcge_meta
    from repro_torch.models.transformer import arch_spec
    return update_shapes(subcge_meta(arch_spec(arch)), C)


def check_update(e: Entry, leaves, E: int, randn, r: int = 16) -> None:
    """The update kernel through ``e.name``'s wrapper (``subcge_apply``, or
    ``subcge_apply_epochs`` with E epochs) at each leaf, launched on the
    whole leaf as the main path launches it: held against the plain version
    on every instance (in slices of W of at most CHECK_SLICE_BYTES), bitwise
    across two calls, and timed beside the plain version,
    ``baddbmm`` (the library call) and a ``copy_`` of W (the rate at which
    this card streams the same bytes).  A bf16 entry takes W in bf16 (made
    and, for the plain version, timed slice by slice: the plain version's
    float32 temporaries of a whole 48-layer leaf would not fit), and the
    library call is ``baddbmm`` in bf16."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import subcge_apply as sa
    dt, esz = (torch.bfloat16, 2) if e.bf16 else (torch.float32, 4)
    for batch, n, m, count in leaves:
        nb = math.prod(batch)
        step = max(1, CHECK_SLICE_BYTES // (4 * n * m))
        if e.bf16:
            W = torch.empty((nb, n, m), dtype=dt, device="cuda")
            for lo in range(0, nb, step):
                W[lo:lo + step] = randn(min(nb, lo + step) - lo, n, m,
                                        scale=0.05)
        else:
            W = randn(nb, n, m, scale=0.05)
        U, Vm = randn(E, n, r), randn(E, m, r)
        # coefficients of a few messages: deltas comparable to W itself
        A = randn(E, nb, r, r, scale=1e-2)
        if "epochs" not in e.name:
            def fn():
                return ops.subcge_apply(W, U[0], A[0], Vm[0])

            def plain(lo=0, hi=nb):
                return sa.subcge_apply_plain(W[lo:hi], U[0], A[0, lo:hi],
                                             Vm[0])
        else:
            def fn():
                return ops.subcge_apply_epochs(W, U, A, Vm)

            def plain(lo=0, hi=nb):
                return sa.subcge_apply_epochs_plain(W[lo:hi], U, A[:, lo:hi],
                                                    Vm)
        # the plan of the launch: the tensor-core kernel's (bf16 W, or r >
        # 32) or the float32 stream's
        tc = sa.uses_tensor_cores(e.bf16, r)
        if tc:
            plan = sa.stream_plan(nb, n, m, r, E, esz)
            geo = f"tc k={plan.k} sub={plan.sub} groups={plan.groups}"
        else:
            geo = f"bc={sa.update_plan(nb, n, m, r, E).bc}"
        shape = f"E={E} W({','.join(map(str, batch))},{n},{m}) r={r} {geo}"
        got = fn()
        same_bits(got, fn(), e.name)
        err = want_max = 0.0
        for lo in range(0, nb, step):
            hi = min(nb, lo + step)
            want = plain(lo, hi)
            se, sw = e.check(got[lo:hi], want, f"{shape} [{lo}:{hi}]")
            err, want_max = max(err, se), max(want_max, sw)
            del want
        ms = time_ms(fn, 3)
        c_ms = time_ms(lambda: got.copy_(W), *REF_TIMING)   # got is checked
        del got
        torch.cuda.empty_cache()
        if e.bf16:
            p_ms = sum(time_ms(lambda lo=lo: plain(lo, min(nb, lo + step)),
                               *REF_TIMING)
                       for lo in range(0, nb, step))
        else:
            p_ms = time_ms(plain, *REF_TIMING)
        UA = torch.einsum("enr,ebrs->bnes", U, A).reshape(nb, n, E * r)
        Vt = Vm.permute(0, 2, 1).reshape(E * r, m).expand(nb, E * r, m)
        UA, Vt = UA.to(dt), Vt.to(dt)
        l_ms = time_ms(lambda: torch.baddbmm(W, UA, Vt), *REF_TIMING)
        nbytes = esz * 2 * nb * n * m \
            + 4 * E * (n * r + m * r + nb * r * r)
        flops = 2 * E * nb * (n * m * r + n * r * r)
        e.add_checked((err, want_max), ms, p_ms, l_ms, nbytes, flops, shape,
                      count)
        # the tensor-core kernel's TF32 work: three products of k = E rp
        tf32 = 3 * 2 * nb * n * m * plan.k if tc else 0
        e.tc_flops += count * tf32
        gbs = 2 * nb * n * m * esz / ms / 1e6   # W read + written, per second
        rate = f"; TF32 {tf32 / ms / 1e9:.1f} TFLOP/s" if tc else ""
        log(f"    update {shape}: {gbs:.1f} GB/s = "
            f"{gbs * 1e9 / PEAK_HBM_BYTES:.1%} of 3.35 TB/s; kernel/baddbmm "
            f"{ms / l_ms:.3f}x{rate}; copy_ of W {c_ms:.4f} ms (kernel/copy_ "
            f"{ms / c_ms:.3f}x); checked in {-(-nb // step)} slice(s)")
        del W, UA, Vt
        torch.cuda.empty_cache()


def run_slice(arch, what, phase, card: str, clients: int = SLICE_CLIENTS,
              topology="ring", ledger=LEDGER_RING8_3STEPS,
              engine="FloodNetwork", steps: int = 3, batch: int = SLICE_B,
              task=None, inspect=None):
    """``steps`` SeedFlood steps through ``run`` (3 steps of 8 clients on a
    ring, B 8, T 33, unless told otherwise), launch counters zeroed just
    before and read just after; returns the launches and the run's
    numbers (with ``inspect(result)``'s, when given)."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.kernels import build
    task = task or synthetic.TaskConfig(vocab=arch.vocab, n_test=SLICE_TEST)
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run(DTrainConfig(arch=arch, n_clients=clients,
                           topology=topology, steps=steps,
                           batch_size=batch, task=task, device="cuda"))
    launches = dict(build.LAUNCHES)
    wall = time.perf_counter() - t0
    check_run(res, ledger, what, engine)
    steady = res.extra["step_wall_s"]
    out = {"step_ms": 1e3 * sum(steady) / len(steady),
           "steady_step_s": steady, "first_step_ms": 1e3 * res.compile_wall_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "n_params": res.extra["n_params"], "losses": res.loss_curve,
           "gmp": res.gmp, "valid_loss": res.extra["valid_loss"],
           "consensus": res.consensus_error, "run_s": wall,
           "launches": launches, **(inspect(res) if inspect else {})}
    log(f"[{phase}] {what}: {arch.name} ({out['n_params']} params) x "
        f"{clients} clients, {topology}, {res.extra['engine']}, {steps} "
        f"steps of {batch} x "
        f"{task.seq_len + 1} tokens in "
        f"{wall:.1f} s; losses {res.loss_curve}; consensus "
        f"{res.consensus_error:.3e}; gmp {res.gmp}; valid_loss "
        f"{out['valid_loss']}; ledger {res.extra['n_messages']} msgs / "
        f"{res.total_bytes} B; first step {out['first_step_ms']:.1f} ms, "
        f"steady step {out['step_ms']:.1f} ms ({steady}); peak mem "
        f"{out['peak_gib']:.2f} GiB; launches {launches} ({card})")
    del res
    torch.cuda.empty_cache()
    return launches, out


def check_expert(e: Entry, C: int, M: int, mo, d: int, randn) -> None:
    """rank1_matmul_expert at one MoE layer's shapes: w1 and w3 (d -> the
    expert ff) and w2 (back) over the capacity buffer of every client and
    expert (M tokens a client, top-k, the capacity factor of ``mo``), each
    held against the plain version summed over the kernel's K ranges
    (``plain_split``) and bitwise equal across two calls."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rank1_matmul as r1
    dev = torch.device("cuda")
    E, ff = mo.n_experts, mo.d_ff_expert
    cap = max(1, math.ceil(M * mo.top_k / E * mo.capacity_factor))
    s = torch.tensor(([1e-3, -1e-3] * C)[:C], device=dev)
    dt, esz = (torch.bfloat16, 2) if e.bf16 else (torch.float32, 4)
    for (K, N), count in (((d, ff), 2), ((ff, d), 1)):
        x = randn(C, E, cap, K).to(dt)
        W = randn(C, E, K, N, scale=K ** -0.5).to(dt)
        u, v = randn(C, E, K), randn(C, E, N)
        got = ops.rank1_matmul_expert(x, W, u, v, s)
        same_bits(got, ops.rank1_matmul_expert(x, W, u, v, s), e.name)
        splits, kper = r1.gemm_plan(C, E, cap, N, K, bf16=e.bf16)
        xf, Wf = x.float(), W.float()

        def chunk(k0, k1):
            return r1.rank1_matmul_expert_plain(
                xf[..., k0:k1], Wf[:, :, k0:k1], u[..., k0:k1], v, s)
        want = plain_split(chunk, K, kper).to(dt)
        xb, Wb = x.reshape(C * E, cap, K), W.reshape(C * E, K, N)
        R = ((s[:, None, None, None] * torch.matmul(xf, u[..., None]))
             * v[:, :, None, :]).reshape(C * E, cap, N).to(dt)
        del xf, Wf
        ms = time_ms(lambda: ops.rank1_matmul_expert(x, W, u, v, s), 3)
        p_ms = time_ms(lambda: r1.rank1_matmul_expert_plain(x, W, u, v, s),
                       *REF_TIMING)
        l_ms = time_ms(lambda: torch.baddbmm(R, xb, Wb), *REF_TIMING)
        B = C * E
        nbytes = esz * (B * cap * K + B * K * N + B * cap * N) \
            + 4 * (B * K + B * N + C)
        flops = 2 * B * cap * K * (N + 1) + 3 * B * cap * N
        e.acc_atol = tensor_core_atol(K) if e.bf16 else 0.0
        what = f"x({C},{E},{cap},{K}) W({C},{E},{K},{N}) S={splits}"
        e.add(got, want, ms, p_ms, l_ms, nbytes, flops, what, count)
        if e.bf16:
            e.witness(cublas_f32_sums(lambda: torch.baddbmm(R, xb, Wb))
                      .reshape(got.shape), want, what)
        del x, W, got, want, R, xb, Wb
        torch.cuda.empty_cache()


def phase_kernels_kimi(kimi, C: int, M: int) -> dict:
    """rank1_matmul, rank1_matmul_expert and the update kernel at the Kimi
    K2 cut's shapes.  The update: one update of every matrix leaf.  The
    products: each summed over what one training step's forward gives it
    per layer: the
    attention, router, shared-expert and head projections, and the three
    expert products (w1, w3 of 7168 -> 2048, w2 of 2048 -> 7168) over the
    capacity buffer of every client and expert."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    slot = kimi.groups[0].slots[0]
    a, mo, d = slot.attn, slot.moe, kimi.d_model
    q, kv, fs = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim, \
        mo.n_shared * mo.d_ff_expert
    entries = {n: Entry(n) for n in ("rank1_matmul", "rank1_matmul_expert",
                                     "subcge_apply")}
    check_update(entries["subcge_apply"], update_leaves(kimi, C), 1, randn)
    check_rank1(entries["rank1_matmul"], C, M,
                (((d, q), 1), ((d, kv), 2), ((q, d), 1), ((d, mo.n_experts), 1),
                 ((d, fs), 2), ((fs, d), 1), ((d, kimi.vocab), 1)), randn)
    check_expert(entries["rank1_matmul_expert"], C, M, mo, d, randn)
    return entries


def mla_launches(arch) -> tuple:
    """(rank1_matmul, rank1_matmul_expert) launches of one signed forward
    of a DeepSeek-style decoder, counted from the code: in each MLA slot
    ``wdq`` and ``wuq`` (or one ``wq``), ``wdkv`` and ``wo`` through
    ``Bundle.dense`` (``wukv`` is read unperturbed and launches nothing);
    a dense FFN's w1, w2 and (gated) w3; an MoE's router and shared w1,
    w3, w2, and its experts' w1, w3, w2 through ``Bundle.expert_dense``;
    the untied head."""
    dense = expert = 0
    for g in arch.groups:
        for s in g.slots:
            n = (2 if s.attn.q_lora else 1) + 2
            if s.ffn == "dense":
                n += 2 + arch.gated_mlp
            else:
                n += 1 + 3 * (s.moe.n_shared > 0)
                expert += 3 * g.reps
            dense += n * g.reps
    return dense + (not arch.tie_embeddings), expert


def phase_kernels_deepseek(ds, C: int, M: int) -> dict:
    """rank1_matmul, rank1_matmul_expert and both updates at the DeepSeek-V2
    cut's shapes.  The updates: one update of every matrix leaf (``wukv``
    included), the own update and the replay at E = 1.  The products: each
    summed over one signed forward: in each of the two layers the MLA
    projections (wdq d -> q_lora, wuq q_lora -> heads x (nope + rope),
    wdkv d -> kv_lora + rope, wo heads x v -> d; ``wukv`` launches
    nothing), the dense layer's w1, w3, w2, the MoE layer's router and
    shared-expert w1, w3, w2, the untied head, and the three expert
    products over the capacity buffer of every client and expert."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    entries = {n: Entry(n) for n in ("rank1_matmul", "rank1_matmul_expert",
                                     "subcge_apply", "subcge_apply_epochs")}
    leaves = update_leaves(ds, C)
    for name in ("subcge_apply", "subcge_apply_epochs"):
        check_update(entries[name], leaves, 1, randn)
    d = ds.d_model
    shapes: dict = {}
    for grp in ds.groups:
        for slot in grp.slots:
            a = slot.attn
            nope, rd = a.head_dim, a.rope_head_dim
            vd = a.v_head_dim or a.head_dim
            used = [(d, a.q_lora), (a.q_lora, a.n_heads * (nope + rd)),
                    (d, a.kv_lora + rd), (a.n_heads * vd, d)]
            if slot.ffn == "dense":
                used += [(d, slot.d_ff)] * 2 + [(slot.d_ff, d)]
            else:
                fs = slot.moe.n_shared * slot.moe.d_ff_expert
                used += [(d, slot.moe.n_experts), (d, fs), (d, fs), (fs, d)]
            for shape in used:
                shapes[shape] = shapes.get(shape, 0) + grp.reps
    shapes[(d, ds.vocab)] = 1
    if sum(shapes.values()) != mla_launches(ds)[0]:
        raise AssertionError(f"deepseek: {shapes} is not one forward's "
                             "projections")
    check_rank1(entries["rank1_matmul"], C, M, tuple(shapes.items()), randn)
    mo = next(s.moe for grp in ds.groups for s in grp.slots if s.moe)
    check_expert(entries["rank1_matmul_expert"], C, M, mo, d, randn)
    return entries


def hybrid_shapes(arch) -> tuple:
    """(rank1_matmul's (K, N) shapes with their launches, rank1_matmul_expert
    launches, selective_scan launches) of one signed forward of a decoder of
    GQA and Mamba slots (Jamba's), counted from the code: ``wq``, ``wk``,
    ``wv``, ``wo`` of an attention slot and ``in_proj``, ``x_proj``,
    ``dt_proj``, ``out_proj`` of a Mamba slot through ``Bundle.dense``
    (``conv_w`` and ``A_log`` are materialised by ``Bundle.matw``); a dense
    FFN's w1, w2 and (gated) w3; an MoE's router and shared w1, w3, w2, its
    experts' w1, w3, w2 through ``Bundle.expert_dense``; one scan per Mamba
    slot; the untied head."""
    d = arch.d_model
    shapes: dict = {}
    expert = scans = 0
    for grp in arch.groups:
        for slot in grp.slots:
            if slot.mixer == "mamba":
                m = slot.mamba
                Di, N = m.d_inner, m.d_state
                dtr = m.dt_rank or -(-d // 16)
                used = [(d, 2 * Di), (Di, dtr + 2 * N), (dtr, Di), (Di, d)]
                scans += grp.reps
            else:
                a = slot.attn
                q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
                used = [(d, q), (d, kv), (d, kv), (q, d)]
            if slot.ffn == "dense":
                used += [(d, slot.d_ff)] * (1 + arch.gated_mlp) \
                    + [(slot.d_ff, d)]
            elif slot.ffn == "moe":
                fs = slot.moe.n_shared * slot.moe.d_ff_expert
                used += [(d, slot.moe.n_experts)]
                used += [(d, fs), (d, fs), (fs, d)] if fs else []
                expert += 3 * grp.reps
            for shape in used:
                shapes[shape] = shapes.get(shape, 0) + grp.reps
    if not arch.tie_embeddings:
        shapes[(d, arch.vocab)] = shapes.get((d, arch.vocab), 0) + 1
    return shapes, expert, scans


def phase_kernels_jamba(jamba, C: int, B: int, T: int) -> dict:
    """rank1_matmul, rank1_matmul_expert, selective_scan and both updates at
    the Jamba cut's shapes.  The updates: one update of every matrix leaf,
    the own update and the replay at E = 1.  The products: each summed over
    one signed forward (``hybrid_shapes``: the attention slot's four
    projections and dense FFN, the Mamba slot's in_proj, x_proj, dt_proj and
    out_proj, the router of 2 experts, the untied head; the three expert
    products over the capacity buffer of every client and expert, 330 rows
    at top-2 of 2); one scan over the C·B folded batch."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    entries = {n: Entry(n) for n in ("rank1_matmul", "rank1_matmul_expert",
                                     "selective_scan", "subcge_apply",
                                     "subcge_apply_epochs")}
    leaves = update_leaves(jamba, C)
    for name in ("subcge_apply", "subcge_apply_epochs"):
        check_update(entries[name], leaves, 1, randn)
    shapes, _, _ = hybrid_shapes(jamba)
    check_rank1(entries["rank1_matmul"], C, B * T, tuple(shapes.items()),
                randn)
    mam = next(s for grp in jamba.groups for s in grp.slots if s.moe)
    check_expert(entries["rank1_matmul_expert"], C, B * T, mam.moe,
                 jamba.d_model, randn)
    check_scan(entries["selective_scan"],
               (C * B, T, mam.mamba.d_inner, mam.mamba.d_state), randn)
    return entries


def phase_kernels_mamba_serve(arch, B: int, P: int) -> dict:
    """selective_scan at the shapes serving ``arch`` gives it (phase 17 (b)
    and (c)): a prefill of B sequences of P tokens and one decode step (T
    = 1), each from a nonzero state; the unit is one of each."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    m = next(s.mamba for grp in arch.groups for s in grp.slots if s.mamba)
    e = Entry("selective_scan")
    for T in (P, 1):
        check_scan(e, (B, T, m.d_inner, m.d_state), randn)
    return {"selective_scan": e}


def phase_kernels_falcon(falcon, C: int, B: int, T: int) -> dict:
    """rank1_matmul, selective_scan and the update kernel at the Falcon Mamba
    cut's shapes.  The update: one update of every matrix leaf.  The others:
    each summed over what one layer of one signed forward gives it: in_proj,
    x_proj (N = 288 and dt_proj K = 256 are ragged against the tiles),
    dt_proj, out_proj and the head; one scan over the C·B folded batch.
    The scan is also held at a small odd shape (T off the 8-step prefetch,
    D·N off the 256-thread block), printed but not summed."""
    import torch
    from repro_torch.kernels import selective_scan as ss

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    m, d = falcon.groups[0].slots[0].mamba, falcon.d_model
    Di, N = m.d_inner, m.d_state
    dtr = m.dt_rank or -(-d // 16)
    entries = {n: Entry(n) for n in ("rank1_matmul", "selective_scan",
                                     "selective_scan_bwd", "subcge_apply")}
    check_update(entries["subcge_apply"], update_leaves(falcon, C), 1, randn)
    check_rank1(entries["rank1_matmul"], C, B * T,
                (((d, 2 * Di), 1), ((Di, dtr + 2 * N), 1), ((dtr, Di), 1),
                 ((Di, d), 1), ((d, falcon.vocab), 1)), randn)

    check_scan(entries["selective_scan"], (C * B, T, Di, N), randn)
    check_scan(Entry("selective_scan"), (3, 37, 200, N), randn,
               " (not summed)")
    # the backward at the scan shapes of phase 9's first-order arms (their
    # clients folded into the batch; the unit is dsgd's), and at small odd
    # shapes
    (_, c_dsgd), (_, c_choco) = FO_MAMBA_ARMS
    for rep in ptxas_report("selective_scan_bwd"):
        log(f"    ptxas selective_scan_bwd: {rep}")
    check_scan_bwd(entries["selective_scan_bwd"], (c_dsgd * B, T, Di, N),
                   randn)
    # choco's unit; T past a chunk at the full width (the checkpointed
    # path, 4 chunks); small odd shapes, one of them D·N = 74 (rows not
    # 16-byte aligned: the masked copies)
    chunk = ss.BWD_CHUNK
    for shape in ((c_choco * B, T, Di, N), (4, 3 * chunk + 5, Di, N),
                  (3, 37, 200, N), (2, 7, 8, 4), (2, 9, 40, 1), (1, 5, 24, 32),
                  (2, 11, 37, 2)):
        check_scan_bwd(entries["selective_scan_bwd"], shape, randn,
                       summed=False)
    return entries


def check_scan(e: Entry, shape, randn, note: str = "") -> None:
    """selective_scan at (B, T, D, N) on the JAX kernel test's inputs
    (decays in (0, 1), small drives), y and h_last held together against
    the plain version and timed beside it; added to ``e``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss
    Bs, Ts, D, Ns = shape
    a = torch.sigmoid(randn(Bs, Ts, D, Ns))
    bx, c, h0 = randn(Bs, Ts, D, Ns, scale=0.1), randn(Bs, Ts, Ns), \
        randn(Bs, D, Ns)
    got = torch.cat([t.flatten() for t in ops.selective_scan(a, bx, c, h0)])
    want = torch.cat([t.flatten()
                      for t in ss.selective_scan_plain(a, bx, c, h0)])
    ms = time_ms(lambda: ops.selective_scan(a, bx, c, h0))
    p_ms = time_ms(lambda: ss.selective_scan_plain(a, bx, c, h0))
    nbytes = 4 * (2 * Bs * Ts * D * Ns + Bs * Ts * Ns + 2 * Bs * D * Ns
                  + Bs * Ts * D)
    flops = 4 * Bs * Ts * D * Ns
    e.add(got, want, ms, p_ms, None, nbytes, flops,
          f"a({Bs},{Ts},{D},{Ns}) y+h_last{note}")
    del a, bx, c, h0, got, want
    torch.cuda.empty_cache()


def scan_bwd_design_bytes(plan, B: int, T: int, D: int, N: int) -> int:
    """HBM bytes the backward's design moves at (B, T, D, N) under
    ``plan``: a and bx read once, da and dbx written once, dy, c, h0,
    dh_last read, dc and dh0 written, the float64 dc partials written and
    read back; past a chunk also the pre-pass (a and bx up to the last
    checkpoint), the checkpoints written and read, and the carry parked in
    dh0 between chunks, written and read."""
    BDN = B * D * N
    nbytes = 4 * (4 * B * T * D * N + B * T * D + 2 * B * T * N + 3 * BDN)
    nbytes += 2 * 8 * B * T * plan.partials * N
    if plan.chunks > 1:
        nbytes += 4 * 2 * B * (plan.chunks - 1) * plan.chunk * D * N
        nbytes += 2 * 2 * 4 * (plan.chunks - 1) * BDN
    return nbytes


def check_scan_bwd(e: Entry, shape, randn, summed: bool = True) -> None:
    """selective_scan_bwd at (B, T, D, N), bitwise equal across two calls
    and timed beside the plain version.  da, dbx and dh0 are held against
    the plain reverse scan and against autograd of the plain forward (rtol
    1e-5, atol 1e-5).  dc sums D products whose partial sums run far above
    the result, so float32 sums (the plain version's, autograd's) stray
    from the exact value by more than that tolerance allows at D = 8192:
    dc is held, at the same rtol and atol, against a float64 oracle (the
    plain reverse scan in float64), and its distance to the plain version
    is printed.  ``summed`` False: printed, not added to the unit."""
    import torch
    from repro_torch.kernels import selective_scan as ss
    Bs, Ts, D, N = shape
    a = torch.sigmoid(randn(Bs, Ts, D, N))
    bx, c, h0 = randn(Bs, Ts, D, N, scale=0.1), randn(Bs, Ts, N), \
        randn(Bs, D, N)
    dy, dh = randn(Bs, Ts, D), randn(Bs, D, N)
    args = (a, bx, c, h0, dy, dh)
    got = ss.selective_scan_bwd(*args)
    for g, again, name in zip(got, ss.selective_scan_bwd(*args),
                              ("da", "dbx", "dc", "dh0")):
        same_bits(g, again, f"selective_scan_bwd {name}")
    want = ss.selective_scan_bwd_plain(*args)
    leaves = [x.clone().requires_grad_(True) for x in (a, bx, c, h0)]
    y, h = ss.selective_scan_plain(*leaves)
    auto = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    del y, h, leaves
    oracle = ss.selective_scan_bwd_plain(*(x.double() for x in args))[2]
    log(f"    scan bwd {shape}: dc max |kernel - float64| "
        f"{float((got[2].double() - oracle).abs().max()):.3e}, |plain - "
        f"float64| {float((want[2].double() - oracle).abs().max()):.3e}, "
        f"|kernel - plain| {float((got[2] - want[2]).abs().max()):.3e}, "
        f"|float64| max {float(oracle.abs().max()):.3e}")
    err = want_max = 0.0
    for g, w, au, name in zip(got, want, auto, ("da", "dbx", "dc", "dh0")):
        if name == "dc":
            ce, cw = e.check(g.double(), oracle, "dc vs a float64 oracle")
        else:
            e.check(g, au, f"{name} vs autograd of the plain scan")
            ce, cw = e.check(g, w, f"{name} vs the plain reverse scan")
        err, want_max = max(err, ce), max(want_max, cw)
    del got, want, auto, oracle
    torch.cuda.empty_cache()
    ms = time_ms(lambda: ss.selective_scan_bwd(*args))
    p_ms = time_ms(lambda: ss.selective_scan_bwd_plain(*args), 3, 1)
    BTDN = Bs * Ts * D * N
    # what the function must move, once each (4 B): a, bx, c, h0, dy and
    # dh_last in; da, dbx, dc and dh0 out.  The kernel's own traffic (dc's
    # float64 block partials; past a chunk the checkpoints) is its
    # design's, not the function's, and is left out of the bound
    nbytes = 4 * (4 * BTDN + 2 * Bs * Ts * N + 3 * Bs * D * N + Bs * Ts * D)
    plan = ss.scan_bwd_plan(*shape)
    moved = scan_bwd_design_bytes(plan, *shape)
    log(f"    scan bwd {shape}: plan {plan}; the design moves {moved} B "
        f"({moved / BTDN:.2f} B per state element), the function {nbytes} B;"
        f" {moved / ms / 1e9:.3f} TB/s moved, {nbytes / ms / 1e9:.3f} TB/s "
        f"of the function's bytes, in {ms:.4f} ms")
    flops = 8 * BTDN
    target = e if summed else Entry(e.name)
    target.add_checked((err, want_max), ms, p_ms, None, nbytes, flops,
                       f"a({Bs},{Ts},{D},{N}) da+dbx+dc+dh0"
                       + ("" if summed else " (not summed)"))
    del a, bx, c, h0, dy, dh, args
    torch.cuda.empty_cache()


def phase_kernels_baselines(opt, C: int, M: int) -> dict:
    """The four kernels at the shapes the phase-9 baselines give them, per
    steady step: central_zo's dual forward over one OPT-125M expanded to C
    = 16 clients (one layer's six projections, the tied logits), and one
    update of every matrix leaf of ONE model, by ``subcge_apply``
    (central_zo, C = 1, a dense A as the momentum arm's μ) and by
    ``subcge_apply_epochs`` (gossip_sr's replay of one client)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    entries = {n: Entry(n) for n in ("rank1_matmul", "rank1_matmul_t",
                                     "subcge_apply", "subcge_apply_epochs")}
    d, ff, V = opt.d_model, opt.groups[0].slots[0].d_ff, opt.vocab
    check_rank1(entries["rank1_matmul"], C, M,
                (((d, d), 4), ((d, ff), 1), ((ff, d), 1)), randn, shared=True)
    check_rank1(entries["rank1_matmul_t"], C, M, (((d, V), 1),), randn,
                trans=True, shared=True)
    leaves = update_leaves(opt, 1)
    for name in ("subcge_apply", "subcge_apply_epochs"):
        check_update(entries[name], leaves, 1, randn)
    return entries


def phase_kernels_serve(arch, tag: str = "serve", bf16: bool = False) -> dict:
    """The update kernel at the serving fold's shapes: every matrix leaf of
    ONE model (client axis 1; TinyLlama-1.1B for phase 12, Gemma 3 1B for
    phase 14), as ``LiveUpdateBridge.fold`` launches it once per leaf, on
    float32 or (``bf16``: phase 12 (e)) bf16 W.  E = 2 (the folds of
    phases 12 and 14: two τ-epochs) is the main path's and is summed; E =
    1 is checked and printed."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    name = "subcge_apply_epochs" + "_bf16" * bf16
    entries = {name: Entry(name)}
    one = Entry(name)
    leaves = update_leaves(arch, 1)
    check_update(one, leaves, 1, randn)
    check_update(entries[name], leaves, SERVE_FOLD_E, randn)
    log(f"[2] {tag} E=1 (not summed) {one.line()}")
    return entries


def phase_kernels_dense(arch, C: int, M: int, seed: int, tag: str,
                        extra: tuple = ()) -> dict:
    """The four kernels of a dense decoder's SeedFlood path at ``arch``'s
    shapes for C clients (Qwen1.5-0.5B, OPT-125M at 64 clients, Gemma 3
    1B, the Qwen2-72B cut), summed over what one training step gives each:
    one layer's projections (wq, wk, wv, wo, w1, w3 when gated, w2) and,
    for an untied head, the logits (``rank1_matmul``), the tied logits
    (``rank1_matmul_t``), one update of every matrix leaf by the own
    update (``subcge_apply``) and by the replay (``subcge_apply_epochs``,
    E = 1).  Every slot of these decoders has the same widths (Gemma's
    local and global slots differ only in their window).  The replay at
    each E of ``extra`` (delayed flooding, stale arrivals across τ-epochs)
    is checked and printed, not summed.  OPT-125M's ``embed/tok`` alone is
    64 x 50272 x 768 floats, past 2^31: the update is checked in slices."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    slot = arch.groups[0].slots[0]
    a, d, ff = slot.attn, arch.d_model, slot.d_ff
    q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    names = ["rank1_matmul", "subcge_apply", "subcge_apply_epochs"]
    if arch.tie_embeddings:
        names.insert(1, "rank1_matmul_t")
    entries = {n: Entry(n) for n in names}
    # one timed shape per distinct (K, N), counted as often as the layer
    # uses it
    layer: dict = {}
    for shape in ([(d, q), (d, kv), (d, kv), (q, d), (d, ff)]
                  + [(d, ff)] * arch.gated_mlp + [(ff, d)]
                  + [(d, arch.vocab)] * (not arch.tie_embeddings)):
        layer[shape] = layer.get(shape, 0) + 1
    check_rank1(entries["rank1_matmul"], C, M, tuple(layer.items()), randn)
    if arch.tie_embeddings:
        check_rank1(entries["rank1_matmul_t"], C, M, (((d, arch.vocab), 1),),
                    randn, trans=True)
    leaves = update_leaves(arch, C)
    for name in ("subcge_apply", "subcge_apply_epochs"):
        check_update(entries[name], leaves, 1, randn)
    for E in extra:
        ex = Entry("subcge_apply_epochs")
        check_update(ex, leaves, E, randn)
        log(f"[2] {tag} E={E} (not summed) {ex.line()}")
    return entries


def phase_prng(n: int = 1 << 20, rows: int = 64) -> None:
    """prng.normal and prng.gumbel in float32 and bf16, and the server's
    temperature sampling (``serve.server.sample`` at 0.8 on ``rows`` rows
    of TinyLlama's vocabulary, float32 and bf16 logits) on the card,
    bitwise the CPU's (which is bitwise ``jax.random`` on the CPU,
    tests/test_torch_{prng,serve,serve_bf16}.py).  Also printed: how many
    of those rows a division by the temperature as a host scalar changes
    on the card (CUDA multiplies by its reciprocal)."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.server import sample
    keys = prng.PRNGKey(torch.arange(16) * 65536 + 7)
    for name, dt in (("normal", torch.float32), ("gumbel", torch.float32),
                     ("gumbel", torch.bfloat16)):
        fn = getattr(prng, name)
        want = fn(keys, (n // 16,), dtype=dt)
        got = fn(keys.cuda(), (n // 16,), dtype=dt).cpu()
        bad = int((bits(got) != bits(want)).sum())
        log(f"  prng.{name} {dt} card vs CPU on {n} draws: {bad} differ "
            "(must be 0)")
        if bad:
            raise AssertionError(f"prng.{name} {dt}: {bad} of {n} draws "
                                 "differ between the card and the CPU")
    serve = ServeConfig(**SERVE_GEOMETRY, sampling="temperature",
                        temperature=0.8)
    rng = np.random.default_rng(SERVE_SEED)
    logits = torch.as_tensor(3 * rng.standard_normal((rows, 32000)),
                             dtype=torch.float32)
    rids, pos = list(range(rows)), [40 + r % 7 for r in range(rows)]
    for dt in (torch.float32, torch.bfloat16):
        x = logits.to(dt)
        want, got = sample(x, serve, rids, pos), sample(x.cuda(), serve,
                                                       rids, pos)
        temp = prng.rounded(serve.temperature, dt)
        host = int((bits((x.cuda() / temp).cpu()) != bits(
            x / torch.tensor(temp, dtype=dt))).any(-1).sum())
        bad = sum(a != b for a, b in zip(got, want))
        log(f"  serve.server.sample {dt} at temperature 0.8, card vs CPU on "
            f"{rows} rows: {bad} tokens differ (must be 0); a host scalar's "
            f"division would change {host} of the rows on the card")
        if bad:
            raise AssertionError(f"sample {dt}: {bad} of {rows} tokens "
                                 "differ between the card and the CPU")


def phase_profile(arch, C: int, B: int, device: str, steps: int = 3,
                  topology: str = "ring", method: str = "seedflood",
                  **kw) -> dict:
    """Where one steady step of ``method`` goes: the pieces ``run`` calls
    (method, transport) driven by hand, the last step under
    ``torch.profiler`` (with ``churn=`` a schedule in ``kw``, its events
    applied at the start of each step, as the Trainer does).  Returns
    host-span milliseconds (SeedFlood's
    ``seedflood.*`` ranges), device-busy milliseconds, the busy share of the
    step's wall time, the device launches, and the kernels that took the
    most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.dtrain.api import Setup
    from repro_torch.dtrain.methods import METHOD_SPECS
    from repro_torch.dtrain.runner import DTrainConfig, validate_config

    cfg = DTrainConfig(method=method, arch=arch, n_clients=C,
                       topology=topology, steps=steps, batch_size=B,
                       device=device, **kw)
    validate_config(cfg)
    spec = METHOD_SPECS[method]
    setup = Setup(cfg)
    meth = spec.make_method(cfg)
    transport = spec.make_transport(cfg, setup)
    state = meth.init(setup)
    transport.bind(meth.initial_payload(state))
    cuda = device == "cuda"

    def step(t):
        nonlocal state
        if cfg.churn is not None and cfg.churn.events_at(t):
            transport.apply_churn(cfg.churn.events_at(t))
        active = transport.active_mask()
        state, outbox = meth.local_step(state, setup.batches(t), active, t)
        inbox = transport.exchange(outbox.payload, t, active)
        del outbox
        state = meth.apply_inbox(state, inbox)
        if cuda:
            torch.cuda.synchronize()

    for t in range(steps - 1):
        step(t)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(steps - 1)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # host spans: the CPU-side seedflood.* ranges; device busy: the kernel
    # and copy events on the card (the ranges' device-side mirrors, also
    # named seedflood.*, are left out so nothing counts twice)
    from torch.autograd import DeviceType
    spans, kernels = {}, {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        on_card = e.device_type == DeviceType.CUDA
        if e.name.startswith("seedflood."):
            if not on_card:
                spans[e.name] = spans.get(e.name, 0.0) + us / 1e3
        elif on_card:
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + us / 1e3, n + 1)
    top = sorted(((k[:90], ms, n) for k, (ms, n) in kernels.items()),
                 key=lambda k: -k[1])
    busy_ms = sum(ms for ms, _ in kernels.values())
    # the hand-written kernels that ran, by name: rank1_matmul_t runs
    # rank1_gemm, and the older transposed tile (rank1_matmul_kernel) must
    # not appear
    ours = {k.split("namespace)::")[-1].split("(")[0]: (ms, n)
            for k, (ms, n) in kernels.items()
            if any(w in k for w in ("rank1_", "subcge_", "selective_scan",
                                    "scan_bwd", "dc_sum"))}
    if any("rank1_matmul_kernel" in k for k in ours):
        raise AssertionError(f"profile: the old rank-1 tile still runs: {ours}")
    del state, setup, transport
    return {"wall_ms": wall_ms, "spans_ms": spans, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "device_launches": sum(n for _, n in kernels.values()),
            "top_kernels": top[:12], "hand_written_kernels": ours}


def check_run(res, ledger, what: str, engine: str = "FloodNetwork") -> None:
    losses = res.loss_curve
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if not res.consensus_error < 1e-10:
        raise AssertionError(f"{what}: consensus error {res.consensus_error}")
    got = (res.extra["n_messages"], res.total_bytes)
    if got != ledger:
        raise AssertionError(f"{what}: ledger {got} != JAX FloodTransport's "
                             f"{ledger}")
    if res.extra["engine"] != engine:
        raise AssertionError(f"{what}: flood engine {res.extra['engine']}, "
                             f"not {engine}")


def baseline_ledger(method: str, n_params: int, lora_floats: int,
                    n: int = BASELINE_CLIENTS,
                    steps: int = BASELINE_STEPS) -> int:
    """Bytes the JAX package's transports charge a ring of n over ``steps``
    exchanges, from their formulas: gossip sends every client's trainable
    floats (4 B) both ways on every edge, Choco the top-k of 1 % of them
    (value and index, 8 B), gossip-SR every neighbour's whole history of
    8-byte messages (before exchange t a client holds the n·t averaged
    uids and its own new one), central_zo nothing."""
    from repro_torch.core.messages import MESSAGE_BYTES
    edges = n                                  # a ring
    floats = lora_floats if method.endswith("_lora") else n_params
    if method == "central_zo":
        return 0
    if method == "gossip_sr":
        return 2 * edges * MESSAGE_BYTES * sum(n * t + 1 for t in range(steps))
    if method.startswith("choco"):
        return steps * 2 * edges * max(1, int(floats * 0.01)) * 8
    return steps * 2 * edges * floats * 4


def phase_baselines(opt, B: int, card: str):
    """Phase 9: every §4.2 baseline at OPT-125M's full width; returns the
    launches summed over the arms (each arm's counters zeroed just before
    its run and read just after) and each arm's numbers."""
    import torch
    from repro_torch.dtrain import lora
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf

    n_layers, d = opt.n_layers, opt.d_model
    lora_floats = lora.n_lora_params(lora.lora_spec(tf.arch_spec(opt)))
    if lora_floats != n_layers * 2 * (d * 8 + 8 * d):   # wq, wv at r = 8
        raise AssertionError(f"n_lora_params {lora_floats} != the adapters'"
                             " count of wq and wv at r = 8")
    if (lora_floats, 2 * BASELINE_CLIENTS * 126_755_328 * 4,
            2 * BASELINE_CLIENTS * max(1, int(126_755_328 * 0.01)) * 8) != \
            (294_912, DSGD_EXCHANGE_BYTES, CHOCO_EXCHANGE_BYTES):
        raise AssertionError("baseline ledger constants disagree")
    total, out = {}, {}
    for method, kw in BASELINE_ARMS:
        arm = method + "".join(f"-{k}{v}" for k, v in kw.items())
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run(DTrainConfig(method=method, arch=opt,
                               n_clients=BASELINE_CLIENTS, topology="ring",
                               steps=BASELINE_STEPS, batch_size=B,
                               local_iters=1, device="cuda", **kw))
        launches = dict(build.LAUNCHES)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = res.extra["step_wall_s"]
        want = baseline_ledger(method, res.extra["n_params"], lora_floats)
        out[arm] = {
            "step_ms": 1e3 * sum(steady) / len(steady),
            "steady_step_s": steady, "first_step_ms": 1e3 * res.compile_wall_s,
            "peak_gib": peak, "total_bytes": res.total_bytes,
            "losses": res.loss_curve, "gmp": res.gmp,
            "valid_loss": res.extra["valid_loss"],
            "consensus": res.consensus_error, "run_s": wall,
            "launches": launches,
            "reconstructions": res.extra.get("reconstructions")}
        log(f"[9] {arm}: {opt.name} x {BASELINE_CLIENTS} clients, ring, "
            f"{BASELINE_STEPS} steps in {wall:.1f} s; losses "
            f"{res.loss_curve}; consensus {res.consensus_error:.3e}; gmp "
            f"{res.gmp}; valid_loss {out[arm]['valid_loss']}; ledger "
            f"{res.total_bytes} B (JAX formula {want}); first step "
            f"{out[arm]['first_step_ms']:.1f} ms, steady step "
            f"{out[arm]['step_ms']:.1f} ms ({steady}); peak mem {peak:.2f} "
            f"GiB; launches {launches}; reconstructions "
            f"{out[arm]['reconstructions']} ({card})")
        if not all(math.isfinite(v) for v in res.loss_curve):
            raise AssertionError(f"baselines {arm}: non-finite loss")
        if res.total_bytes != want:
            raise AssertionError(f"baselines {arm}: ledger {res.total_bytes}"
                                 f" != the JAX formula's {want}")
        if not peak < 80:
            raise AssertionError(f"baselines {arm}: peak memory {peak} GiB")
        if method == "central_zo":
            for name, n in (("rank1_matmul",
                             6 * n_layers * 2 * BASELINE_STEPS),
                            ("rank1_matmul_t", 2 * BASELINE_STEPS)):
                if launches.get(name, 0) != n:
                    raise AssertionError(
                        f"baselines {arm}: {name} launched "
                        f"{launches.get(name, 0)} times, not {n}")
            if launches.get("subcge_apply", 0) < 1:
                raise AssertionError(f"baselines {arm}: subcge_apply never "
                                     "launched")
        if method == "gossip_sr" and launches.get("subcge_apply_epochs",
                                                  0) < 1:
            raise AssertionError("baselines gossip_sr: subcge_apply_epochs "
                                 "never launched")
        for name, k in launches.items():
            total[name] = total.get(name, 0) + k
        del res
        torch.cuda.empty_cache()
    return total, out


def phase_mamba_fo(falcon, B: int, card: str):
    """Phase 9, first-order arms through Mamba layers: dsgd and choco on
    the Falcon Mamba cut (4 of 64 layers at the published widths), their
    FO_MAMBA_ARMS clients on a ring, gossip every step.  Each step's
    backward runs the scan's reverse-scan kernel once per layer; returns
    the launches summed over both arms and each arm's numbers."""
    import torch
    from repro_torch.configs import archs
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.kernels import build

    total, out = {}, {}
    for method, clients in FO_MAMBA_ARMS:
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run(DTrainConfig(method=method, arch=falcon,
                               n_clients=clients, topology="ring",
                               steps=FO_MAMBA_STEPS, batch_size=B,
                               local_iters=1, device="cuda"))
        launches = dict(build.LAUNCHES)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = res.extra["step_wall_s"]
        want = baseline_ledger(method, res.extra["n_params"], 0,
                               n=clients, steps=FO_MAMBA_STEPS)
        out[method] = {
            "step_ms": 1e3 * sum(steady) / len(steady),
            "steady_step_s": steady, "first_step_ms": 1e3 * res.compile_wall_s,
            "peak_gib": peak, "total_bytes": res.total_bytes,
            "losses": res.loss_curve, "gmp": res.gmp,
            "valid_loss": res.extra["valid_loss"],
            "consensus": res.consensus_error, "run_s": wall,
            "clients": clients, "launches": launches}
        log(f"[9] {method} through Mamba: {falcon.name} x "
            f"{clients} clients, ring, {FO_MAMBA_STEPS} steps in "
            f"{wall:.1f} s; losses {res.loss_curve}; consensus "
            f"{res.consensus_error:.3e}; ledger {res.total_bytes} B (JAX "
            f"formula {want}); first step {out[method]['first_step_ms']:.1f}"
            f" ms, steady step {out[method]['step_ms']:.1f} ms ({steady}); "
            f"peak mem {peak:.2f} GiB; launches {launches} ({card})")
        if not all(math.isfinite(v) for v in res.loss_curve):
            raise AssertionError(f"mamba {method}: non-finite loss")
        if res.total_bytes != want:
            raise AssertionError(f"mamba {method}: ledger {res.total_bytes} "
                                 f"!= the JAX formula's {want}")
        if not peak < 80:
            raise AssertionError(f"mamba {method}: peak memory {peak} GiB")
        n_bwd = archs.FALCON_LAYERS * FO_MAMBA_STEPS
        if launches.get("selective_scan_bwd", 0) != n_bwd:
            raise AssertionError(
                f"mamba {method}: selective_scan_bwd launched "
                f"{launches.get('selective_scan_bwd', 0)} times, not {n_bwd}")
        for name, k in launches.items():
            total[name] = total.get(name, 0) + k
        del res
        torch.cuda.empty_cache()
    return total, out


def churn_schedule():
    """Phase 10's script on the 8 x 8 mesh-grid: four clients of its middle
    leave at step 1 and rejoin at 4 (their catch-up spans τ-epochs 0-2 at
    τ = 2); the grid splits in halves at step 2 and heals at 3."""
    from repro_torch.topology.dynamic import ChurnSchedule
    return (ChurnSchedule.leave_rejoin((18, 19, 26, 27), leave_at=1,
                                       rejoin_at=4)
            + ChurnSchedule.partition((range(0, 32), range(32, 64)), at=2,
                                      heal_at=3))


def phase_churn(opt, B: int, card: str):
    """Phase 10: the paper's setting under churn (OPT-125M whole, 64
    clients on the 8 x 8 mesh-grid, the bitset engine, τ = 2, 6 steps).
    The ledger must be the JAX FloodTransport's, the rejoin step's replay
    must run the epoch kernel with E >= 2, and all 64 clients must end in
    consensus.  Returns the launches and the run's numbers."""
    import torch
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.kernels import build

    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run(DTrainConfig(arch=opt, n_clients=PAPER_CLIENTS,
                           topology=PAPER_TOPOLOGY, steps=CHURN_STEPS,
                           batch_size=B, subcge_tau=CHURN_TAU,
                           churn=churn_schedule(), device="cuda"))
    launches = dict(build.LAUNCHES)
    epochs = dict(build.EPOCH_LAUNCHES)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = res.extra["step_wall_s"]          # steps 1 .. CHURN_STEPS - 1
    catchup_s = steady[4 - 1]                  # the rejoin step, t = 4
    others = [v for k, v in enumerate(steady) if k != 4 - 1]
    ledger = (res.extra["n_messages"], res.total_bytes,
              res.extra["sync_bytes"], res.extra["n_syncs"])
    out = {"steady_step_s": steady, "catchup_step_s": catchup_s,
           "step_ms": 1e3 * sorted(others)[len(others) // 2],
           "first_step_ms": 1e3 * res.compile_wall_s, "peak_gib": peak,
           "ledger": ledger, "losses": res.loss_curve, "gmp": res.gmp,
           "valid_loss": res.extra["valid_loss"],
           "consensus": res.consensus_error, "run_s": wall,
           "launches": launches, "epoch_launches": epochs}
    log(f"[10] churn: {opt.name} x {PAPER_CLIENTS} clients, "
        f"{PAPER_TOPOLOGY}, {res.extra['engine']}, tau {CHURN_TAU}, "
        f"{CHURN_STEPS} steps in {wall:.1f} s; losses {res.loss_curve}; "
        f"consensus {res.consensus_error:.3e}; ledger (msgs, B, sync B, "
        f"syncs) {ledger}; first step {out['first_step_ms']:.1f} ms, "
        f"median steady step {out['step_ms']:.1f} ms, catch-up step "
        f"{1e3 * catchup_s:.1f} ms ({steady}); peak mem {peak:.2f} GiB; "
        f"epoch launches by E {epochs}; launches {launches} ({card})")
    if not all(math.isfinite(v) for v in res.loss_curve):
        raise AssertionError("churn: non-finite loss")
    if ledger != LEDGER_MESHGRID64_CHURN_6STEPS:
        raise AssertionError(f"churn: ledger {ledger} != JAX FloodTransport's "
                             f"{LEDGER_MESHGRID64_CHURN_6STEPS}")
    if res.extra["engine"] != "VectorFloodNetwork":
        raise AssertionError(f"churn: flood engine {res.extra['engine']}")
    if not any(E >= 2 for E in epochs):
        raise AssertionError(f"churn: subcge_apply_epochs never ran with "
                             f"E >= 2 ({epochs})")
    if not res.consensus_error < 1e-10:
        raise AssertionError(f"churn: consensus error {res.consensus_error}")
    if not peak < 80:
        raise AssertionError(f"churn: peak memory {peak} GiB")
    # every client runs both signed forwards each step, offline or not
    for name, want in (("rank1_matmul", 6 * opt.n_layers * 2 * CHURN_STEPS),
                       ("rank1_matmul_t", 2 * CHURN_STEPS)):
        if launches.get(name, 0) != want:
            raise AssertionError(f"churn: {name} launched "
                                 f"{launches.get(name, 0)} times, not {want}")
    del res
    torch.cuda.empty_cache()
    return launches, out


def phase_resume(opt, B: int, card: str):
    """Phase 11: OPT-125M whole, RESUME_CLIENTS clients on a ring, τ = 2,
    client 3 offline for steps 1-2, RESUME_STEPS steps with a checkpoint
    every 2 into a temporary directory (removed after); a second run
    resumed from the step-2 checkpoint must end bitwise equal to the
    uninterrupted one: every final stacked leaf, the loss and consensus
    curves and the ledger.  Returns the launches of both runs and the
    numbers."""
    import os
    import tempfile
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.kernels import build
    from repro_torch.topology.dynamic import ChurnSchedule

    times = {"save": [], "load": []}
    save, load = ckpt.save, ckpt.load

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                times[key].append(time.perf_counter() - t0)
        return wrapper

    base = dict(arch=opt, n_clients=RESUME_CLIENTS, topology="ring",
                steps=RESUME_STEPS, batch_size=B, subcge_tau=2, eval_every=1,
                churn=ChurnSchedule.leave_rejoin((3,), 1, 3), device="cuda")
    build.reset_launches()
    ckpt.save, ckpt.load = timed(save, "save"), timed(load, "load")
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            whole = run(DTrainConfig(checkpoint_every=2, checkpoint_dir=d,
                                     **base))
            path = os.path.join(d, "step000002.npz")
            size = os.path.getsize(path)
            resumed = run(DTrainConfig(resume_from=path, **base))
    finally:
        ckpt.save, ckpt.load = save, load
    launches = dict(build.LAUNCHES)
    got, want = resumed.extra["final_stacked"], whole.extra["final_stacked"]
    differ = [p for p, w in want.items()
              if not torch.equal(got[p].view(torch.int32),
                                 w.view(torch.int32))]
    out = {"ckpt_bytes": size, "save_s": times["save"],
           "load_s": times["load"], "losses": whole.loss_curve,
           "consensus_curve": whole.extra["consensus_curve"],
           "ledger": whole.total_bytes, "launches": launches}
    log(f"[11] resume: {opt.name} x {RESUME_CLIENTS} clients, ring, "
        f"{RESUME_STEPS} steps, resumed from step 2: checkpoint "
        f"{size} B ({size / 2**30:.2f} GiB), written in {times['save']} s, "
        f"read in {times['load']} s; leaves differing {differ}; losses "
        f"{whole.loss_curve} / {resumed.loss_curve}; consensus "
        f"{whole.extra['consensus_curve']} / "
        f"{resumed.extra['consensus_curve']}; ledger {whole.total_bytes} / "
        f"{resumed.total_bytes} B, syncs {whole.extra['n_syncs']} / "
        f"{resumed.extra['n_syncs']} ({card})")
    if differ or resumed.loss_curve != whole.loss_curve \
            or resumed.extra["consensus_curve"] != \
            whole.extra["consensus_curve"] \
            or resumed.total_bytes != whole.total_bytes \
            or resumed.extra["n_messages"] != whole.extra["n_messages"] \
            or resumed.extra["sync_bytes"] != whole.extra["sync_bytes"]:
        raise AssertionError("resume: the resumed run is not bitwise the "
                             "uninterrupted one")
    if whole.extra["n_syncs"] < 1:
        raise AssertionError("resume: the rejoin ran no anti-entropy")
    del whole, resumed, got, want
    torch.cuda.empty_cache()
    return launches, out


class CohortLog:
    """Records, while installed, each SeedFlood dispatch of an event run: a
    cohort's step (its members, step index, wall seconds) and each replay
    (padded K, τ-epochs, wall seconds), every wall ending in
    ``torch.cuda.synchronize()``.  Reporting only: the wrapped methods run
    unchanged."""

    def __init__(self, tau: int):
        self.tau, self.steps, self.replays = tau, [], []

    def __enter__(self):
        import numpy as np
        import torch
        from repro_torch.dtrain.methods.seedflood import SeedFloodMethod
        self.cls = SeedFloodMethod
        self.orig = (SeedFloodMethod.local_step, SeedFloodMethod.apply_inbox)
        local_step, apply_inbox = self.orig
        log_ = self

        def timed_step(meth, state, tokens, active, t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = local_step(meth, state, tokens, active, t)
            torch.cuda.synchronize()
            log_.steps.append((np.flatnonzero(np.asarray(active) > 0).tolist(),
                               t, time.perf_counter() - t0))
            return out

        def timed_replay(meth, state, inbox):
            if inbox is None or inbox.seeds.shape[1] == 0:
                return apply_inbox(meth, state, inbox)
            live = inbox.steps[inbox.steps >= 0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = apply_inbox(meth, state, inbox)
            torch.cuda.synchronize()
            log_.replays.append((int(inbox.seeds.shape[1]),
                                 len(set((live // log_.tau).tolist())),
                                 time.perf_counter() - t0))
            return out

        SeedFloodMethod.local_step = timed_step
        SeedFloodMethod.apply_inbox = timed_replay
        return self

    def __exit__(self, *exc):
        self.cls.local_step, self.cls.apply_inbox = self.orig


def phase_async(opt, B: int, card: str):
    """Phase 13: the event engine (``run(DTrainConfig(trace=...))``) at
    OPT-125M's full width.  (a) the oracle: 16 clients on a ring under
    churn, the event run on ``TraceSet.constant`` bitwise the synchronous
    run with ``drain`` (curve, leaves, consensus, the JAX ledger); (b) the
    paper's grid point under heterogeneity: 64 clients on the 8 x 8
    mesh-grid, half of them 4x slower, on 1 Gbit/s links with 10 ms latency
    (the JAX package's ledger, virtual time and cohorts, 144 rank-1 launches
    per cohort, a replay across τ-epochs, consensus after the drain); (c)
    dsgd under the same trace (the JAX formula's ledger and mix-delay
    virtual time).  Returns the launches of the three parts' runs and the
    numbers."""
    import torch
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.kernels import build
    from repro_torch.sim import TraceSet, barrier_schedule
    from repro_torch.topology.dynamic import ChurnSchedule

    total, out = {}, {}

    def count(launches):
        for name, k in launches.items():
            total[name] = total.get(name, 0) + k

    def finite(res, what):
        if not all(math.isfinite(v) for v in res.loss_curve):
            raise AssertionError(f"async {what}: non-finite loss "
                                 f"{res.loss_curve}")

    # (a) the oracle on the card
    base = dict(arch=opt, n_clients=ASYNC_RING, topology="ring",
                steps=ASYNC_STEPS, batch_size=B, subcge_tau=ASYNC_TAU,
                flood_backend="python", device="cuda",
                churn=ChurnSchedule.leave_rejoin([3], 1, 3))
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sync = run(DTrainConfig(drain=True, **base))
    t1 = time.perf_counter()
    ev = run(DTrainConfig(trace=TraceSet.constant(ASYNC_RING), **base))
    t2 = time.perf_counter()
    launches = dict(build.LAUNCHES)
    count(launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ledgers = [(r.extra["n_messages"], r.total_bytes, r.extra["sync_bytes"],
                r.extra["n_syncs"]) for r in (sync, ev)]
    got, want = ev.extra["final_stacked"], sync.extra["final_stacked"]
    differ = [p for p, w in want.items()
              if not torch.equal(got[p].view(torch.int32), w.view(torch.int32))]
    out["oracle"] = {"sync_s": t1 - t0, "event_s": t2 - t1, "peak_gib": peak,
                     "ledger": ledgers[1], "losses": ev.loss_curve,
                     "consensus": ev.consensus_error,
                     "virtual_time_s": ev.extra["virtual_time_s"],
                     "launches": launches}
    log(f"[13] (a) oracle: {opt.name} x {ASYNC_RING} clients, ring, tau "
        f"{ASYNC_TAU}, {ASYNC_STEPS} steps, client 3 away for steps 1-2: "
        f"sync (drain) {t1 - t0:.1f} s, event (TraceSet.constant) "
        f"{t2 - t1:.1f} s; leaves differing {differ}; losses "
        f"{sync.loss_curve} / {ev.loss_curve}; consensus "
        f"{sync.consensus_error:.3e} / {ev.consensus_error:.3e}; ledger (msgs,"
        f" B, sync B, syncs) {ledgers[0]} / {ledgers[1]} (JAX "
        f"{LEDGER_ASYNC_RING16_CHURN}); virtual time "
        f"{ev.extra['virtual_time_s']}; peak mem {peak:.2f} GiB; launches "
        f"{launches} ({card})")
    finite(ev, "oracle")
    if differ or sync.loss_curve != ev.loss_curve \
            or sync.consensus_error != ev.consensus_error:
        raise AssertionError("async oracle: the event run is not bitwise the "
                             "synchronous run")
    if not ledgers[0] == ledgers[1] == LEDGER_ASYNC_RING16_CHURN:
        raise AssertionError(f"async oracle: ledgers {ledgers} != the JAX "
                             f"package's {LEDGER_ASYNC_RING16_CHURN}")
    if ev.extra["virtual_time_s"] != float(ASYNC_STEPS):
        raise AssertionError(f"async oracle: virtual time "
                             f"{ev.extra['virtual_time_s']}")
    del sync, ev, got, want
    torch.cuda.empty_cache()

    # (b) the paper's grid point under heterogeneity
    trace = TraceSet.two_speed(PAPER_CLIENTS, **ASYNC_TRACE)
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CohortLog(ASYNC_TAU) as clog:
        res = run(DTrainConfig(arch=opt, n_clients=PAPER_CLIENTS,
                               topology=PAPER_TOPOLOGY, steps=ASYNC_STEPS,
                               batch_size=B, subcge_tau=ASYNC_TAU, trace=trace,
                               device="cuda"))
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    epochs = dict(build.EPOCH_LAUNCHES)
    count(launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ledger = (res.extra["n_messages"], res.total_bytes)
    vt = res.extra["virtual_time_s"]
    cohorts = tuple(v for v, _ in res.extra["loss_vs_virtual_time"])
    n_cohorts = len(cohorts)
    # per-client progress on the virtual clock: when each half finished
    # its last step, beside the barrier schedule of the same trace
    done_at = {}
    for (members, t, _), v in zip(clog.steps, cohorts):
        for i in members:
            done_at[i] = v
    fast = [i for i in range(PAPER_CLIENTS) if trace.compute_s[i] ==
            ASYNC_TRACE["fast_s"]]
    slow = [i for i in range(PAPER_CLIENTS) if i not in fast]
    barrier = barrier_schedule(trace, ASYNC_STEPS)
    e_hist = {}
    for _, E, _ in clog.replays:
        e_hist[E] = e_hist.get(E, 0) + 1
    out["paper"] = {
        "run_s": wall, "cohort_s": wall / n_cohorts, "n_cohorts": n_cohorts,
        "cohort_step_s": [s for _, _, s in clog.steps],
        "cohort_sizes": [len(m) for m, _, _ in clog.steps],
        "replays": clog.replays, "max_k": max(k for k, _, _ in clog.replays),
        "e_hist": e_hist, "epoch_launches": epochs, "peak_gib": peak,
        "ledger": ledger, "virtual_time_s": vt, "cohorts": cohorts,
        "losses": res.loss_curve, "consensus": res.consensus_error,
        "valid_loss": res.extra["valid_loss"],
        "fast_done_s": max(done_at[i] for i in fast),
        "slow_done_s": max(done_at[i] for i in slow),
        "barrier_s": barrier[-1], "launches": launches}
    o = out["paper"]
    log(f"[13] (b) {opt.name} x {PAPER_CLIENTS} clients, {PAPER_TOPOLOGY}, "
        f"{res.extra['engine']}, tau {ASYNC_TAU}, {ASYNC_STEPS} steps, "
        f"two_speed {ASYNC_TRACE}: {wall:.1f} s of wall, {n_cohorts} cohorts "
        f"({o['cohort_s']:.2f} s each; steps {[round(s, 3) for s in o['cohort_step_s']]}"
        f" s over {o['cohort_sizes']} clients); replays (K, E, s) "
        f"{[(k, e, round(s, 3)) for k, e, s in clog.replays]}, largest K "
        f"{o['max_k']}, E histogram {e_hist}, epoch launches by E {epochs}; "
        f"losses {res.loss_curve}; consensus {res.consensus_error:.3e}; "
        f"ledger {ledger} (JAX {LEDGER_ASYNC_MESHGRID64}); virtual time {vt!r}"
        f" (JAX {VTIME_ASYNC_MESHGRID64!r}); cohorts at {cohorts}; peak mem "
        f"{peak:.2f} GiB; launches {launches} ({card})")
    log(f"[13] (b) progress on the virtual clock: the fast half ends step "
        f"{ASYNC_STEPS} at {o['fast_done_s']} s, the slow half at "
        f"{o['slow_done_s']} s; the barrier schedule of the same trace ends "
        f"step {ASYNC_STEPS} at {barrier[-1]} s ({barrier})")
    finite(res, "paper")
    if ledger != LEDGER_ASYNC_MESHGRID64:
        raise AssertionError(f"async paper: ledger {ledger} != the JAX "
                             f"package's {LEDGER_ASYNC_MESHGRID64}")
    if vt != VTIME_ASYNC_MESHGRID64 or cohorts != COHORTS_ASYNC_MESHGRID64:
        raise AssertionError(f"async paper: virtual time {vt!r}, cohorts "
                             f"{cohorts}")
    if res.extra["engine"] != "FloodNetwork":
        raise AssertionError(f"async paper: flood engine {res.extra['engine']}")
    # every cohort runs both signed forwards over all 64 rows
    for name, n in (("rank1_matmul", 6 * opt.n_layers * 2 * n_cohorts),
                    ("rank1_matmul_t", 2 * n_cohorts)):
        if launches.get(name, 0) != n:
            raise AssertionError(f"async paper: {name} launched "
                                 f"{launches.get(name, 0)} times, not {n}")
    if not any(E >= 2 for E in epochs):
        raise AssertionError(f"async paper: subcge_apply_epochs never ran "
                             f"with E >= 2 ({epochs})")
    if not res.consensus_error < 1e-10:
        raise AssertionError(f"async paper: consensus error "
                             f"{res.consensus_error}")
    if not peak < 80:
        raise AssertionError(f"async paper: peak memory {peak} GiB")
    if o["fast_done_s"] != float(ASYNC_STEPS):
        raise AssertionError(f"async paper: the fast half ended at "
                             f"{o['fast_done_s']} s")
    del res
    torch.cuda.empty_cache()

    # (c) gossip under the same trace
    trace = TraceSet.two_speed(ASYNC_RING, **ASYNC_TRACE)
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run(DTrainConfig(method="dsgd", arch=opt, n_clients=ASYNC_RING,
                           topology="ring", steps=ASYNC_STEPS, batch_size=B,
                           local_iters=2, trace=trace, device="cuda"))
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    count(launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    vt = res.extra["virtual_time_s"]
    out["dsgd"] = {"run_s": wall, "peak_gib": peak,
                   "total_bytes": res.total_bytes, "virtual_time_s": vt,
                   "cohorts": [v for v, _ in res.extra["loss_vs_virtual_time"]],
                   "losses": res.loss_curve,
                   "consensus": res.consensus_error, "launches": launches}
    log(f"[13] (c) dsgd: {opt.name} x {ASYNC_RING} clients, ring, a mix "
        f"every 2 steps, {ASYNC_STEPS} steps, same trace: {wall:.1f} s of "
        f"wall; losses {res.loss_curve}; consensus "
        f"{res.consensus_error:.3e}; ledger {res.total_bytes} B (JAX formula "
        f"{LEDGER_ASYNC_DSGD16}); virtual time {vt!r} (JAX mix-delay formula "
        f"{VTIME_ASYNC_DSGD16!r}) against seedflood's "
        f"{out['paper']['virtual_time_s']!r} on the 8 x 8 grid; cohorts at "
        f"{out['dsgd']['cohorts']}; peak mem {peak:.2f} GiB ({card})")
    finite(res, "dsgd")
    if res.total_bytes != LEDGER_ASYNC_DSGD16:
        raise AssertionError(f"async dsgd: ledger {res.total_bytes} != the "
                             f"JAX formula's {LEDGER_ASYNC_DSGD16}")
    if vt != VTIME_ASYNC_DSGD16:
        raise AssertionError(f"async dsgd: virtual time {vt!r} != "
                             f"{VTIME_ASYNC_DSGD16!r}")
    if not peak < 80:
        raise AssertionError(f"async dsgd: peak memory {peak} GiB")
    del res
    torch.cuda.empty_cache()
    return total, out


def serve_prompts(vocab: int, n: int = SERVE_REQUESTS,
                  lens: tuple = SERVE_PROMPT) -> list:
    """A request script (phase 12's by default): n prompts whose lengths
    are drawn from seed 0 between lens[0] and lens[1] tokens."""
    import numpy as np
    rng = np.random.default_rng(SERVE_SEED)
    lens = rng.integers(lens[0], lens[1] + 1, n)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def monolithic_stream(arch, params, prompt, n_new: int, fold_at=None,
                      capacity: int = SERVE_GEOMETRY["max_seq"]):
    """One request's greedy stream through the monolithic steps of
    ``launch/steps.py``: prefill and a decode loop over ring caches of
    ``capacity`` positions (a sliding-window slot's: of its window, if
    shorter), switching
    to ``fold_at[i]`` at decode-step boundary i (0 = before the prefill).
    Returns the tokens, the smallest gap between the two largest logits of
    any step (how far the stream is from an argmax tie) and the logits
    rows (n_new, vocab)."""
    import torch
    from repro_torch.launch import steps as steplib
    fold_at = fold_at or {}
    prefill = steplib.build_prefill_step(arch, 1, capacity)
    decode = steplib.build_decode_step(arch)

    def view(p):
        return {k: t[None] for k, t in p.items()}

    p = view(fold_at.get(0, params))
    toks = torch.as_tensor(prompt, device="cuda").long()
    last, cache = prefill(p, toks[None])
    rows, out = [last[0]], []
    for i in range(n_new):
        out.append(rows[-1].argmax())
        if i == n_new - 1:
            break
        if i + 1 in fold_at:
            p = view(fold_at[i + 1])
        lg, cache = decode(p, cache, out[-1].reshape(1, 1), len(prompt) + i)
        rows.append(lg[0])
    rows = torch.stack(rows)
    top2 = torch.topk(rows, 2, dim=-1).values
    return (torch.stack(out).tolist(), float((top2[:, 0] - top2[:, 1]).min()),
            rows)


def serve_run(arch, params, prompts, serve, n_new: int = SERVE_NEW,
              bridge=None, before_step=None, rows=None) -> tuple:
    """Drive a DecodeServer over ``prompts`` (rid = index) step by step,
    timing each step (synchronised) and each prefill; ``before_step(srv)``
    runs before every step; ``rows``, a dict, receives the logits row each
    token was sampled from, keyed by (rid, position).  Returns (results,
    stats, numbers)."""
    import torch
    from repro_torch.serve import DecodeServer, Request
    srv = DecodeServer(arch, params, serve, bridge=bridge, device="cuda")
    for rid, p in enumerate(prompts):
        srv.submit(Request(rid=rid, prompt=p, max_new=n_new))
    prefill_ms, steady_ms, admit_ms = [], [], []
    prefill = srv._prefill_group

    def timed_prefill(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(*a)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
    srv._prefill_group = timed_prefill
    if rows is not None:
        sample = srv._sample

        def recorded(logits, rids, emit_pos):
            host = logits.cpu()      # kept off the card (peak memory)
            rows.update({(r, p): host[i]
                         for i, (r, p) in enumerate(zip(rids, emit_pos))})
            return sample(logits, rids, emit_pos)
        srv._sample = recorded
    t_all = time.perf_counter()
    while not srv.sched.done:
        if before_step is not None:
            before_step(srv)
        n_pre = srv.n_prefills
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        (admit_ms if srv.n_prefills > n_pre else steady_ms).append(
            1e3 * (time.perf_counter() - t0))
    wall = time.perf_counter() - t_all
    st = srv.stats()
    med = sorted(steady_ms)[len(steady_ms) // 2] if steady_ms else None
    nums = {"wall_s": wall, "tok_s": st["emitted"] / wall,
            "steady_step_ms": med,
            "steady_spread_ms": (min(steady_ms), max(steady_ms))
            if steady_ms else None, "n_steady": len(steady_ms),
            "admit_step_ms": admit_ms, "prefill_ms": prefill_ms}
    return srv.results, st, nums


def record_folds(bridge) -> list:
    """Wrap ``bridge`` so that each fold logs the (seeds, coefs, steps)
    arrays its ingest_arrays took in since the fold before."""
    import numpy as np
    folds, taken = [], []
    ingest, fold = bridge.ingest_arrays, bridge.fold

    def rec_ingest(*arrays):
        taken.append(tuple(np.array(a) for a in arrays))
        return ingest(*arrays)

    def rec_fold(params):
        folds.append(list(taken))
        taken.clear()
        return fold(params)
    bridge.ingest_arrays, bridge.fold = rec_ingest, rec_fold
    return folds


def own_weights_differ(arch, scfg, seed: int, servers, folds) -> dict:
    """For each server of a swarm, the leaves of its weights that are not
    bitwise the initial weights (seed 0, as ServeSwarmSim makes them)
    folded offline over the messages of that server's own folds, and the
    number of those folds."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import LiveUpdateBridge
    out = {}
    for node, srv in servers.items():
        want = tf.init_params(arch, 0, "cuda")
        offline = LiveUpdateBridge(arch, scfg, seed, node)
        for taken in folds[node]:
            for arrays in taken:
                offline.ingest_arrays(*arrays)
            offline.fold(want)
        out[node] = (len(folds[node]),
                     [k for k, t in want.items()
                      if not torch.equal(srv.params[k].view(torch.int32),
                                         t.view(torch.int32))])
        del want
    return out


def serve_fold(arch, base, prompts, geometry: dict, capacity: int, greedy,
               card: str, tag: str, dtype=None) -> tuple:
    """A live-update fold at a step boundary against the offline fold: the
    messages of SERVE_FOLD_CLIENTS trainer clients over SERVE_FOLD_STEPS
    steps at tau = 1 (so E = 2) folded through a ``LiveUpdateBridge`` at
    the start of server step SERVE_FOLD_AT while ``prompts`` decode (rid =
    index) over ``geometry``, weights and pool in ``dtype`` (float32 by
    default).  The folded weights must be bitwise the offline fold's, the
    streams token for token the monolithic streams of the same fold
    offline (rings of ``capacity``): in float32 every stream, in bf16
    (where paged and monolithic logits part by an ulp) every stream whose
    smallest top-2 gap exceeds the largest paged-vs-monolithic logit gap,
    itself within BF16_LOGIT_ULPS; and the fold one E = 2
    ``subcge_apply_epochs`` launch per matrix leaf (``_bf16`` in bf16).
    ``greedy``: the unfolded streams (the tokens the fold moved are
    counted).  Every request takes a slot at step 1, so the fold lands at
    the same decode step of each.  Returns the serve run's launches and
    the numbers."""
    import numpy as np
    import torch
    from repro_torch.core.seeds import client_seeds
    from repro_torch.core.subcge import SubCGEConfig
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import subcge_meta
    from repro_torch.serve import LiveUpdateBridge, ServeConfig

    if len(prompts) > geometry["max_batch"]:
        raise ValueError(f"{tag}: more requests than slots")
    scfg = SubCGEConfig(rank=SERVE_RANK, refresh_period=1)
    msgs = [np.concatenate(a) for a in zip(*(
        (client_seeds(SERVE_SEED, t, SERVE_FOLD_CLIENTS),
         np.float32([0.01 / (1 + t + i) for i in range(SERVE_FOLD_CLIENTS)]),
         np.full(SERVE_FOLD_CLIENTS, t, np.int32))
        for t in range(SERVE_FOLD_STEPS)))]
    own = {k: t.clone() for k, t in base.items()}
    bridge = LiveUpdateBridge(arch, scfg, SERVE_SEED, 0)
    fold_ms = []
    fold = bridge.fold

    def timed_fold(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fold(params)
        torch.cuda.synchronize()
        fold_ms.append(1e3 * (time.perf_counter() - t0))
        return params
    bridge.fold = timed_fold

    def ingest(srv):
        if srv.n_steps == SERVE_FOLD_AT - 1:
            bridge.ingest_arrays(*msgs)
    dtype = dtype or torch.float32
    serve = ServeConfig(**geometry, param_dtype=dtype)
    kernel = "subcge_apply_epochs" + "_bf16" * (dtype == torch.bfloat16)
    rows = {} if dtype == torch.bfloat16 else None
    build.reset_launches()
    live, lst, _ = serve_run(arch, own, prompts, serve, bridge=bridge,
                             before_step=ingest, rows=rows)
    fold_launches = dict(build.LAUNCHES)
    epochs = dict(build.EPOCH_LAUNCHES)
    folded = {k: t.clone() for k, t in base.items()}
    offline = LiveUpdateBridge(arch, scfg, SERVE_SEED, 0)
    offline.ingest_arrays(*msgs)
    offline.fold(folded)
    differ = [k for k, t in folded.items()
              if not torch.equal(bits(own[k]), bits(t))]
    del own
    ref_c, margins, mono = {}, {}, {}
    for rid, p in enumerate(prompts):
        ref_c[rid], margins[rid], m = monolithic_stream(
            arch, base, p, SERVE_NEW, {SERVE_FOLD_AT: folded}, capacity)
        mono[rid] = m.cpu()
    del folded
    sure, gap = list(ref_c), None
    if rows is not None:
        gap, amax = logit_gap(prompts, live, ref_c, rows, mono)
        sure = [rid for rid in ref_c if margins[rid] > gap]
        if gap > BF16_LOGIT_ULPS * ulp_bf16(amax):
            raise AssertionError(f"{tag}: the live fold's logits part from "
                                 f"the monolithic ones by {gap}")
    del rows, mono
    bad = [rid for rid in sure if live[rid] != ref_c[rid]]
    moved = sum(a != b for rid in live for a, b in zip(live[rid],
                                                       greedy[rid]))
    n_matrix = sum(m.is_matrix for m in subcge_meta(tf.arch_spec(arch)).values())
    out = {"fold_ms": fold_ms, "launches": fold_launches,
           "epoch_launches": epochs, "differ": bad, "leaves_differ": differ,
           "moved_vs_greedy": moved, "stats": lst, "logit_gap": gap,
           "checked": len(sure)}
    rule = "" if gap is None else (
        f" ({len(sure)} of {len(ref_c)} streams checked: their smallest "
        f"top-2 gap exceeds the largest live-vs-monolithic logit gap "
        f"{gap:.4e})")
    log(f"[{tag}] live update: {SERVE_FOLD_CLIENTS} clients x "
        f"{SERVE_FOLD_STEPS} steps at tau 1 folded at step {SERVE_FOLD_AT} "
        f"in {fold_ms} ms; launches {fold_launches}, epoch launches by E "
        f"{epochs} ({n_matrix} matrix leaves); live vs offline fold: "
        f"{len(bad)} streams{rule} and {len(differ)} leaves differ (must be "
        f"0); {moved} tokens moved from the unfolded greedy streams ({card})")
    if bad or differ:
        raise AssertionError(f"{tag}: decoding under a live fold differs from "
                             f"the offline fold (streams {bad}, leaves "
                             f"{differ})")
    if fold_launches.get(kernel) != n_matrix \
            or epochs != {SERVE_FOLD_E: n_matrix} or len(fold_ms) != 1:
        raise AssertionError(f"{tag}: the fold launched {fold_launches} "
                             f"({epochs}), not one E={SERVE_FOLD_E} update "
                             f"per matrix leaf")
    return fold_launches, out


def profile_step(fn, host: bool = False) -> dict:
    """Device-busy share, device launches and top kernels of one ``fn()``
    (host wall around it, synchronised) under torch.profiler, recording
    the device's activity only (host ops would add their own overhead to
    the wall), read from the raw kineto events (building the profiler's
    Python events took ~20 s at a step of ~60,000 launches).  ``host``
    records the host's ops as well, as every profiled step did before this
    measure: the wall then carries their tracing overhead, and the busy
    share reads lower."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = kernels.get(e.name(), (0.0, 0))
            dur = e.duration_ns() / 1e6 if hasattr(e, "duration_ns") \
                else e.duration_us() / 1e3
            kernels[e.name()] = (ms + dur, n + 1)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(((k[:90], ms, n) for k, (ms, n) in kernels.items()),
                 key=lambda k: -k[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_share": busy / wall_ms,
            "device_launches": sum(n for _, n in kernels.values()),
            "top_kernels": top[:12]}


def phase_serve(arch, card: str, profile: bool):
    """Phase 12: the serving path at TinyLlama-1.1B's full width on one
    model: (a) greedy paged streams equal the monolithic ones, (b)
    temperature sampling replays, (c) a live-update fold at a step boundary
    equals the offline fold, (d) the serve swarm under churn replays with
    the JAX ledger.  Returns the launches (counts zeroed before (c) and (d)
    and read after each) and the numbers."""
    import collections
    import torch
    from repro_torch.core.subcge import SubCGEConfig
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import n_params
    from repro_torch.serve import Request, ServeConfig, ServeSwarmSim
    from repro_torch.topology.dynamic import ChurnSchedule

    out, launches = {}, collections.Counter()
    prompts = serve_prompts(arch.vocab)
    t0 = time.perf_counter()
    base = tf.init_params(arch, SERVE_SEED, "cuda")
    torch.cuda.synchronize()
    out["n_params"] = n_params(tf.arch_spec(arch))
    out["init_s"] = time.perf_counter() - t0
    log(f"[12] serve: {arch.name} ({out['n_params']} params, float32) "
        f"initialised on the card in {out['init_s']:.1f} s; prompt lengths "
        f"{[len(p) for p in prompts]}")

    # (a) greedy: paged continuous batching against the monolithic streams
    torch.cuda.reset_peak_memory_stats()
    paged_rows = {}
    res, st, nums = serve_run(arch, base, prompts,
                              ServeConfig(**SERVE_GEOMETRY), rows=paged_rows)
    nums["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ref, margin = {}, math.inf
    # logits of the paged path against the monolithic one: the prefill
    # (token 0) and the decode steps, max |difference| and rows bitwise
    logit_gap = {"prefill": [0.0, 0, 0], "decode": [0.0, 0, 0]}
    for rid, p in enumerate(prompts):
        ref[rid], m, mono = monolithic_stream(arch, base, p, SERVE_NEW)
        margin, mono = min(margin, m), mono.cpu()
        for i in range(SERVE_NEW):
            got = paged_rows[(rid, len(p) + i)]
            g = logit_gap["prefill" if i == 0 else "decode"]
            g[0] = max(g[0], float((got - mono[i]).abs().max()))
            g[1] += int(torch.equal(got, mono[i]))
            g[2] += 1
    del paged_rows
    bad = [rid for rid in ref if res[rid] != ref[rid]]
    out["greedy"] = {**nums, "stats": st, "min_top2_gap": margin,
                     "logits_vs_monolithic": logit_gap, "differ": bad}
    log(f"[12a] greedy: {st['steps']} steps, {st['prefills']} prefills, "
        f"{st['decodes']} decodes, {st['emitted']} tokens in "
        f"{nums['wall_s']:.2f} s = {nums['tok_s']:.1f} tok/s; steady decode "
        f"step median {nums['steady_step_ms']:.2f} ms (spread "
        f"{nums['steady_spread_ms']}, {nums['n_steady']} steps); admission "
        f"steps {nums['admit_step_ms']} ms; prefills {nums['prefill_ms']} ms; "
        f"peak {nums['peak_gib']:.2f} GiB; paged vs monolithic: {len(bad)} of "
        f"{len(ref)} streams differ (must be 0), smallest top-2 logit gap "
        f"{margin:.3e}; logits paged vs monolithic (max |diff|, rows "
        f"bitwise, rows) {logit_gap} ({card})")
    if bad:
        raise AssertionError(f"serve: paged greedy streams {bad} differ from "
                             "their monolithic streams")
    if st["evicted"] != SERVE_REQUESTS or st["prefills"] < 2:
        raise AssertionError(f"serve: no queueing behind the slots ({st})")

    # (b) temperature sampling, twice
    temp = ServeConfig(**SERVE_GEOMETRY, sampling="temperature",
                       temperature=0.8)
    ta, _, tnums = serve_run(arch, base, prompts, temp)
    tb, _, _ = serve_run(arch, base, prompts, temp)
    same = ta == tb
    moved = sum(a != b for rid in ta for a, b in zip(ta[rid], res[rid]))
    out["temperature"] = {**tnums, "replays": same, "moved_vs_greedy": moved}
    log(f"[12b] temperature 0.8: two runs identical {same}; "
        f"{tnums['tok_s']:.1f} tok/s, steady step median "
        f"{tnums['steady_step_ms']:.2f} ms; {moved} tokens differ from "
        f"greedy ({card})")
    if not same or not all(0 <= t < arch.vocab for v in ta.values()
                           for t in v):
        raise AssertionError("serve: temperature sampling does not replay")

    # (c) a live-update fold at a step boundary against the offline fold
    n_fold = SERVE_GEOMETRY["max_batch"]
    fold_launches, out["live_update"] = serve_fold(
        arch, base, prompts[:n_fold], SERVE_GEOMETRY,
        SERVE_GEOMETRY["max_seq"], res, card, "12c")
    launches.update(fold_launches)
    del base
    torch.cuda.empty_cache()

    # (d) the swarm under churn, twice
    swarm_scfg = SubCGEConfig(rank=SERVE_RANK, refresh_period=2)

    def swarm():
        sim = ServeSwarmSim(
            arch, swarm_scfg,
            ServeConfig(max_batch=2, page_size=16, max_seq=256, n_pages=32),
            n_trainers=2, n_servers=2, train_steps=SWARM_STEPS,
            global_seed=SERVE_SEED,
            churn=ChurnSchedule.leave_rejoin(*SWARM_LEAVE), device="cuda")
        folds = {node: record_folds(srv.bridge)
                 for node, srv in sim.servers.items()}
        for rid in range(4):
            sim.submit(2 if rid < 2 else 3,
                       Request(rid=rid, prompt=prompts[rid], max_new=16))
        t0 = time.perf_counter()
        r = sim.run()
        r["wall_s"] = time.perf_counter() - t0
        return r, sim.servers, folds

    build.reset_launches()
    a, servers, folds = swarm()
    b = swarm()[0]
    torch.cuda.empty_cache()
    swarm_launches = dict(build.LAUNCHES)
    launches.update(swarm_launches)
    # the offline folds launch after the counts are read
    own = own_weights_differ(arch, swarm_scfg, SERVE_SEED, servers, folds)
    del servers, folds
    torch.cuda.empty_cache()
    led = a["ledger"]
    ledger = (led["n_messages"], led["total_bytes"], led["sync_bytes"],
              led["n_syncs"])
    replay = (a["tokens"] == b["tokens"] and a["ledger"] == b["ledger"]
              and a["servers"] == b["servers"])
    out["swarm"] = {"ledger": ledger, "replays": replay,
                    "servers": a["servers"], "own_weights": own,
                    "wall_s": (a["wall_s"], b["wall_s"])}
    log(f"[12d] swarm: 2 trainers + 2 servers on a ring of 4, "
        f"{SWARM_STEPS} steps, server 3 leaves at 1 and rejoins at 2: "
        f"replays bitwise {replay}; ledger (msgs, B, sync B, syncs) "
        f"{ledger}; servers {a['servers']}; each server's (folds, leaves "
        f"that differ from its offline fold) {own}; runs "
        f"{a['wall_s']:.1f} / {b['wall_s']:.1f} s; launches "
        f"{swarm_launches} ({card})")
    if not replay:
        raise AssertionError("serve: the swarm does not replay bitwise")
    if ledger != LEDGER_SERVE_SWARM_4STEPS:
        raise AssertionError(f"serve: swarm ledger {ledger} != JAX "
                             f"FloodTransport's {LEDGER_SERVE_SWARM_4STEPS}")
    if any(n < 1 or bad for n, bad in own.values()):
        raise AssertionError(f"serve: a server's weights are not its own "
                             f"folds of the initial weights ({own})")
    s3 = a["servers"][3]
    if s3["suspends"] < 1 or s3["prefills"] < 2 \
            or s3["bridge"]["messages_folded"] < 1:
        raise AssertionError(f"serve: the churn did not bite ({s3})")

    if profile:
        from repro_torch.serve import DecodeServer
        params = tf.init_params(arch, SERVE_SEED, "cuda")
        srv = DecodeServer(arch, params, ServeConfig(**SERVE_GEOMETRY),
                           device="cuda")
        for rid, p in enumerate(prompts[:n_fold]):
            srv.submit(Request(rid=rid, prompt=p, max_new=SERVE_NEW))
        for _ in range(3):
            srv.step()
        out["profile"] = profile_step(srv.step)
        log(f"[p] one steady decode step of {arch.name}, "
            f"{SERVE_GEOMETRY['max_batch']} slots ({card}): "
            f"{out['profile']}")
        del srv, params
        torch.cuda.empty_cache()
    return dict(launches), out


def ulp_bf16(x: float) -> float:
    """One bf16 ulp at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def logit_gap(prompts, got: dict, ref: dict, rows: dict,
              mono: dict) -> tuple:
    """The largest gap between the paged server's logits ``rows`` (keyed by
    (rid, position)) and the monolithic ones ``mono`` (rid: (new, vocab)),
    over each stream's rows of one context (up to the first token where
    the streams ``got`` and ``ref`` part), and the largest monolithic
    logit there."""
    gap = amax = 0.0
    for rid, p in enumerate(prompts):
        m = mono[rid].float()
        part = next((i for i, (a, b) in enumerate(zip(got[rid], ref[rid]))
                     if a != b), len(ref[rid]) - 1)
        for i in range(part + 1):
            gap = max(gap, float((rows[(rid, len(p) + i)].float()
                                  - m[i]).abs().max()))
            amax = max(amax, float(m[i].abs().max()))
    return gap, amax


def phase_serve_bf16(arch, card: str) -> tuple:
    """Phase 12 (e): the serving path at TinyLlama-1.1B's full width in
    bf16 (weights, KV pool, logits and sampling), as the JAX serve CLI
    serves it without ``--reduced``: (a)'s script against the monolithic
    bf16 streams under the margin rule (BF16_LOGIT_ULPS), the decode step
    against the cost model's bound, (b) temperature 0.8 twice, (c) the
    live fold at E = 2 on the bf16 kernel path, and the CLI without
    ``--reduced``.  Returns the launches (the fold's) and the numbers."""
    import io
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer as tf
    from repro_torch.roofline.cost_model import step_cost
    from repro_torch.serve import ServeConfig

    bf16, out = torch.bfloat16, {}
    serve = ServeConfig(**SERVE_GEOMETRY, param_dtype=bf16)
    prompts = serve_prompts(arch.vocab)
    base = tf.init_params(arch, SERVE_SEED, "cuda", bf16)
    gib = sum(t.numel() * t.element_size() for t in base.values()) / 2**30

    # greedy: paged continuous batching against the monolithic streams
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_rows = {}
    res, st, nums = serve_run(arch, base, prompts, serve, rows=paged_rows)
    nums["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ref, margins, mono = {}, {}, {}
    for rid, p in enumerate(prompts):
        ref[rid], margins[rid], m = monolithic_stream(arch, base, p,
                                                      SERVE_NEW)
        mono[rid] = m.cpu()
    gap, amax = logit_gap(prompts, res, ref, paged_rows, mono)
    del paged_rows, mono
    ulp = ulp_bf16(amax)
    sure = [rid for rid in ref if margins[rid] > gap]
    bad = [rid for rid in sure if res[rid] != ref[rid]]
    differ = [rid for rid in ref if res[rid] != ref[rid]]
    cost = step_cost(arch, InputShape("serve", SERVE_GEOMETRY["max_seq"],
                                      SERVE_GEOMETRY["max_batch"], "decode"),
                     "decode", db=2)
    b_ms = bound_ms(cost, PEAK_BF16_FLOPS)
    out["greedy"] = {**nums, "stats": st, "param_gib": gib,
                     "logit_gap": gap, "logit_gap_ulps": gap / ulp,
                     "max_logit": amax, "margins": margins,
                     "checked": len(sure), "differ": differ, "bad": bad,
                     "decode_bound_ms": b_ms, "decode_cost": (cost.flops,
                                                              cost.bytes)}
    log(f"[12e] bf16 greedy: {arch.name} in bf16 ({gib:.2f} GiB of "
        f"weights), {st['steps']} steps, {st['prefills']} prefills, "
        f"{st['decodes']} decodes, {st['emitted']} tokens in "
        f"{nums['wall_s']:.2f} s = {nums['tok_s']:.1f} tok/s; steady decode "
        f"step median {nums['steady_step_ms']:.2f} ms (spread "
        f"{nums['steady_spread_ms']}, {nums['n_steady']} steps; cost-model "
        f"bound {b_ms:.4f} ms at B {SERVE_GEOMETRY['max_batch']}, context "
        f"{SERVE_GEOMETRY['max_seq']}: {cost.bytes:.4e} B, {cost.flops:.4e} "
        f"FLOP; {b_ms / nums['steady_step_ms']:.1%} reached); prefills "
        f"{nums['prefill_ms']} ms; peak {nums['peak_gib']:.2f} GiB; paged vs "
        f"monolithic logits: largest gap {gap:.4e} = {gap / ulp:.2f} bf16 "
        f"ulps of the largest logit {amax:.4f} (limit {BF16_LOGIT_ULPS}); "
        f"{len(sure)} of {len(ref)} streams' smallest top-2 gap exceeds it "
        f"({len(ref) - len(sure)} left out), {len(bad)} of those differ "
        f"(must be 0); {len(differ)} of {len(ref)} differ in all ({card})")
    if bad or gap > BF16_LOGIT_ULPS * ulp:
        raise AssertionError(f"serve bf16: paged streams {bad} differ from "
                             f"their monolithic streams, or the logits part "
                             f"by {gap / ulp:.2f} ulps")
    if st["evicted"] != SERVE_REQUESTS or not nums["peak_gib"] < 80:
        raise AssertionError(f"serve bf16: {st}, peak {nums['peak_gib']}")

    # temperature sampling (bf16 Gumbels), twice
    temp = ServeConfig(**SERVE_GEOMETRY, param_dtype=bf16,
                       sampling="temperature", temperature=0.8)
    ta, _, tnums = serve_run(arch, base, prompts, temp)
    tb = serve_run(arch, base, prompts, temp)[0]
    moved = sum(a != b for rid in ta for a, b in zip(ta[rid], res[rid]))
    out["temperature"] = {**tnums, "replays": ta == tb,
                          "moved_vs_greedy": moved}
    log(f"[12e] bf16 temperature 0.8: two runs identical {ta == tb}; "
        f"{tnums['tok_s']:.1f} tok/s, steady step median "
        f"{tnums['steady_step_ms']:.2f} ms; {moved} tokens differ from "
        f"greedy ({card})")
    if ta != tb or not all(0 <= t < arch.vocab for v in ta.values()
                           for t in v):
        raise AssertionError("serve bf16: temperature sampling does not "
                             "replay")

    # the live fold on bf16 weights
    n_fold = SERVE_GEOMETRY["max_batch"]
    launches, out["live_update"] = serve_fold(
        arch, base, prompts[:n_fold], SERVE_GEOMETRY,
        SERVE_GEOMETRY["max_seq"], res, card, "12e", dtype=bf16)
    del base
    torch.cuda.empty_cache()

    # the CLI without --reduced: bf16, as the JAX CLI
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(SERVE_CLI_ARGV)
    cli_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    out["cli"] = {"rc": rc, "s": cli_s, "first_line": lines[0]}
    log(f"[12e] CLI {' '.join(SERVE_CLI_ARGV)} in {cli_s:.1f} s: rc {rc}; "
        f"{lines[0]} ({card})")
    if rc != 0 or "bfloat16 weights" not in lines[0] or len(lines) != 5:
        raise AssertionError(f"serve bf16: the CLI printed {lines}")
    torch.cuda.empty_cache()
    return launches, out


def window_binds(arch, task, card: str) -> dict:
    """Phase 14 (b)'s last check: on one model's weights (seed 0) and the
    first validation rows of ``task``, the loss with ``arch``'s windows
    must differ from the loss with every window taken away (plain
    forwards: no kernel launches)."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tf
    glob = dataclasses.replace(arch, groups=tuple(
        dataclasses.replace(g, slots=tuple(
            dataclasses.replace(s, attn=dataclasses.replace(s.attn,
                                                            window=None))
            for s in g.slots)) for g in arch.groups))
    params = {k: t[None] for k, t in tf.init_params(arch, 0, "cuda").items()}
    toks = torch.as_tensor(synthetic.make_splits(task)[1].tokens,
                           device="cuda")[None]
    with torch.no_grad():
        losses = [float(tf.lm_loss(a, params, toks)[0]) for a in (arch, glob)]
    del params
    torch.cuda.empty_cache()
    log(f"[14b] the window binds: {tuple(toks.shape[1:])} tokens, loss with "
        f"the windows {losses[0]!r}, without {losses[1]!r} (must differ) "
        f"({card})")
    if losses[0] == losses[1]:
        raise AssertionError("14b: the windows do not change the loss")
    return {"windowed_loss": losses[0], "global_loss": losses[1]}


def phase_serve_window(arch, card: str):
    """Phase 14 (c): serving Gemma 3 1B whole past its window.  Greedy
    paged streams of GEMMA_REQUESTS prompts of 520-700 tokens must equal
    their monolithic streams (rings of 512 in the local slots, of 768 in
    the global ones) token for token, and request 0's stream a no-cache
    recompute (a full ``forward`` over prompt + generated at every step):
    ring eviction, the paged mask and the plain mask against each other.
    Then a live fold at C = 1, E = 2 (``serve_fold``).  Returns the fold
    run's launches and the numbers."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeConfig

    out = {}
    cap = GEMMA_SERVE["max_seq"]
    window = max(s.attn.window or 0 for g in arch.groups for s in g.slots)
    prompts = serve_prompts(arch.vocab, GEMMA_REQUESTS, GEMMA_PROMPT)
    if min(len(p) for p in prompts) <= window:
        raise AssertionError("14c: a prompt does not reach past the window")
    rings = {k: c["k"].shape[2]
             for k, c in tf.init_cache(arch, 1, cap, device="cuda").items()}
    base = tf.init_params(arch, SERVE_SEED, "cuda")
    torch.cuda.reset_peak_memory_stats()
    rows = {}
    res, st, nums = serve_run(arch, base, prompts, ServeConfig(**GEMMA_SERVE),
                              rows=rows)
    nums["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ref, margin, gap = {}, math.inf, 0.0
    for rid, p in enumerate(prompts):
        ref[rid], m, mono = monolithic_stream(arch, base, p, SERVE_NEW,
                                              capacity=cap)
        margin, mono = min(margin, m), mono.cpu()
        gap = max(gap, max(float((rows[(rid, len(p) + i)] - mono[i]).abs()
                                 .max()) for i in range(SERVE_NEW)))
    del rows
    bad = [rid for rid in ref if res[rid] != ref[rid]]
    view = {k: t[None] for k, t in base.items()}
    seq = torch.as_tensor(prompts[0], device="cuda").long()
    plain = []
    with torch.no_grad():
        for _ in range(SERVE_NEW):
            lg, _ = tf.forward(arch, view, seq[None, None])
            tok = lg[0, 0, -1].argmax()
            del lg
            plain.append(int(tok))
            seq = torch.cat([seq, tok[None]])
    out["greedy"] = {**nums, "stats": st, "rings": rings,
                     "min_top2_gap": margin, "logit_gap_vs_monolithic": gap,
                     "differ": bad, "recompute_equal": plain == ref[0]}
    log(f"[14c] serving past the window: prompts {[len(p) for p in prompts]}"
        f", rings {rings}; {st['steps']} steps, {st['prefills']} prefills, "
        f"{st['decodes']} decodes, {st['emitted']} tokens in "
        f"{nums['wall_s']:.2f} s = {nums['tok_s']:.1f} tok/s; steady decode "
        f"step median {nums['steady_step_ms']:.2f} ms (spread "
        f"{nums['steady_spread_ms']}, {nums['n_steady']} steps); prefills "
        f"{nums['prefill_ms']} ms; peak {nums['peak_gib']:.2f} GiB; paged vs "
        f"monolithic: {len(bad)} of {len(ref)} streams differ (must be 0), "
        f"max |logit diff| {gap:.3e}, smallest top-2 gap {margin:.3e}; "
        f"request 0 recomputed without a cache equal {plain == ref[0]} "
        f"({card})")
    if bad or plain != ref[0]:
        raise AssertionError(f"14c: paged streams {bad} differ from the "
                             "monolithic ones, or the monolithic stream from "
                             "a no-cache recompute")
    if st["evicted"] != GEMMA_REQUESTS:
        raise AssertionError(f"14c: not every request ran to its end ({st})")
    n_fold = GEMMA_SERVE["max_batch"]
    launches, out["live_update"] = serve_fold(arch, base, prompts[:n_fold],
                                              GEMMA_SERVE, cap, res, card,
                                              "14c")
    del base, view
    torch.cuda.empty_cache()
    return launches, out


def phase_gemma(gemma, card: str) -> dict:
    """Phase 14: Gemma 3 1B whole.  (a) the main path (T = 33: the
    512-token window runs but never binds); (b) the window binds, 641
    tokens; (c) serving past the window, and a live fold.  Returns, per
    arm ("gemma", "gemma_long", "gemma_serve"), its launches (counts zeroed
    just before its run and read just after) and its numbers."""
    from repro_torch.data import synthetic
    out = {"gemma": run_slice(gemma, "gemma", "14a", card)}
    launches = out["gemma"][0]
    # the seven projections of each of the 26 layers in both signed
    # forwards of 3 steps, and the tied logits of each signed forward
    for name, want in (("rank1_matmul", 7 * gemma.n_layers * 2 * 3),
                       ("rank1_matmul_t", 2 * 3)):
        if launches.get(name, 0) != want:
            raise AssertionError(f"gemma: {name} launched "
                                 f"{launches.get(name, 0)} times, not {want}")
    long_task = synthetic.TaskConfig(vocab=gemma.vocab, **LONG_TASK)
    out["gemma_long"] = run_slice(
        gemma, "gemma past the window", "14b", card, LONG_CLIENTS,
        ledger=LEDGER_RING4_2STEPS, steps=LONG_STEPS, batch=LONG_B,
        task=long_task)
    launches = out["gemma_long"][0]
    for name, want in (("rank1_matmul", 7 * gemma.n_layers * 2 * LONG_STEPS),
                       ("rank1_matmul_t", 2 * LONG_STEPS)):
        if launches.get(name, 0) != want:
            raise AssertionError(f"gemma past the window: {name} launched "
                                 f"{launches.get(name, 0)} times, not {want}")
    out["gemma_long"][1]["window"] = window_binds(gemma, long_task, card)
    for key in ("gemma", "gemma_long"):
        check_dense_run(key, *out[key])
    out["gemma_serve"] = phase_serve_window(gemma, card)
    return out


def phase_qwen2(qwen2, card: str) -> tuple:
    """Phase 15: the Qwen2-72B cut, every width and the untied 152,064
    vocabulary, 4 clients on a ring, 3 steps."""
    launches, out = run_slice(qwen2, "qwen2", 15, card, QWEN2_CLIENTS,
                              ledger=LEDGER_RING4_3STEPS)
    # the seven projections of its one layer and the untied logits, in both
    # signed forwards of 3 steps; no tied logits
    for name, want in (("rank1_matmul", (7 * qwen2.n_layers + 1) * 2 * 3),
                       ("rank1_matmul_t", 0)):
        if launches.get(name, 0) != want:
            raise AssertionError(f"qwen2: {name} launched "
                                 f"{launches.get(name, 0)} times, not {want}")
    check_dense_run("qwen2", launches, out)
    return launches, out


@contextlib.contextmanager
def layer_inputs(into):
    """Within the block, record each layer's input (``transformer.forward``
    passes it to the mixer's norm, "ln_attn") and the final norm's, at the
    last position, into the list ``into`` (nothing when it is None)."""
    from repro_torch.models import transformer as tf
    norm = tf.L.norm

    def recording(b, key, x, kind):
        if key in ("ln_attn", "ln_f"):
            into.append(x[0, :, -1].float().cpu())
        return norm(b, key, x, kind)
    if into is not None:
        tf.L.norm = recording
    try:
        yield
    finally:
        tf.L.norm = norm


def hidden_gap(got, want) -> tuple:
    """(max |got - want| in bf16 ulps of want's largest magnitude, the share
    of elements not bitwise equal)."""
    gap = (got - want).abs()
    return (float(gap.max()) / ulp_bf16(float(want.abs().max())),
            float((gap > 0).float().mean()))


def serve_cached(arch, card: str, tag: str, B: int, P: int,
                 new: int, params=None, seed: int = SERVE_SEED,
                 witness: bool = False) -> tuple:
    """One model of ``arch`` (random float32 weights from SERVE_SEED, or
    ``params``, one model's flat tree: phase 19 (d) serves the bf16 pod's)
    serves B greedy sequences through the monolithic steps: a P-token prefill
    through ``build_prefill_step`` into a cache of P + new positions (an
    MLA slot's is the compressed ring, a Mamba slot's its (h, conv)
    state), ``new`` decode steps through ``build_decode_step``, then one
    no-cache forward over every token fed; the prefill's logits and each
    decode step's must lie within FORWARD_TOL of that forward's at the
    same positions.  Launch counters are zeroed just before and read just
    after: the projections are unperturbed (``torch.bmm``, no kernel), and
    each Mamba slot launches ``selective_scan`` once in the prefill, in
    each decode step and in the forward.  A frontend arch's prefill takes
    B x n_embeds stubbed embeddings (standard normal, from SERVE_SEED)
    ahead of the prompt: the cache then holds n_embeds + P + new
    positions, decoding starts at n_embeds + P, and the forward takes the
    same embeddings (in the weights' type).  In bf16 the logits must lie
    within BF16_FORWARD_ULPS bf16 ulps of the forward's largest logit, at
    most BF16_FORWARD_PAST of them past one, each row's token the
    forward's where its top-2 gap exceeds that.  ``seed`` draws the prompts
    and embeddings; with ``witness``, the last decode step's and the
    forward's hidden state at that position are compared layer by layer
    (each layer's input, and the final norm's).  The decode step's bound
    is the larger of the cost model's (``step_cost``: decode at B against
    the cache's capacity, in the weights' type), which counts an MoE
    layer's weights for one expert and the KV cache once for all B
    sequences, and the step's bytes counted by hand (every weight read
    once, every expert's included, of the token embedding only B rows and
    not the projector, which a decode step does not read; a KV or MLA ring
    read once and one position of it written; a Mamba slot's (h, conv)
    read and written).  Returns the launches and the numbers."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steplib
    from repro_torch.configs.base import InputShape
    from repro_torch.models import params as plib
    from repro_torch.models import transformer as tf
    from repro_torch.roofline.cost_model import step_cost

    fe = arch.frontend
    n_e = fe.n_embeds if fe is not None else 0
    cap = n_e + P + new
    spec = tf.arch_spec(arch)
    if params is None:
        params = tf.init_params(arch, SERVE_SEED, "cuda")
    view = {k: t[None] for k, t in params.items()}
    del params
    dt = view["embed/tok"].dtype
    esz = view["embed/tok"].element_size()
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, arch.vocab, (B, P)),
                              device="cuda")
    embeds = None if fe is None else torch.as_tensor(
        rng.standard_normal((B, n_e, fe.embed_dim)), dtype=torch.float32,
        device="cuda").to(dt)
    prefill = steplib.build_prefill_step(arch, B, cap)
    decode = steplib.build_decode_step(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        last, cache = prefill(view, prompts, embeds)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        rows, fed, step_ms, hidden = [last], [], [], ([], [])
        for i in range(new):
            fed.append(rows[-1].argmax(-1)[:, None])
            with layer_inputs(hidden[0] if witness and i == new - 1
                              else None):
                t0 = time.perf_counter()
                lg, cache = decode(view, cache, fed[-1], n_e + P + i)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            rows.append(lg)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for key, c in cache.items():
            if "kpos" in c and not torch.equal(c["kpos"][0].cpu(),
                                               torch.arange(cap)):
                raise AssertionError(f"{tag}: the ring of {key} holds "
                                     f"positions {c['kpos'][0].tolist()}, "
                                     f"not 0..{cap - 1}")
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in cache.values() for k, t in c.items()
                          if k != "kpos")
        state_bytes = sum(t.numel() * t.element_size()
                          for c in cache.values() for k, t in c.items()
                          if k in ("h", "conv"))
        del cache
        with layer_inputs(hidden[1] if witness else None):
            full = tf.forward(arch, view, torch.cat([prompts] + fed, 1)[None],
                              embeds=None if fe is None else embeds[None])[0]
        ref = full[0, :, n_e + P - 1:].transpose(0, 1)    # (new + 1, B, V)
        del full
    launches = dict(build.LAUNCHES)
    got, ref = torch.stack(rows).float(), ref.float()
    diff = (got - ref).abs()
    if dt == torch.bfloat16:
        ulp = ulp_bf16(float(ref.abs().max()))
        past = float((diff > ulp).float().mean())
        top2 = torch.topk(ref, 2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > float(diff.max())
        tokens = got.argmax(-1) == ref.argmax(-1)
        ok = float(diff.max()) <= BF16_FORWARD_ULPS * ulp \
            and past <= BF16_FORWARD_PAST and bool(tokens[sure].all())
        tol = (f"{float(diff.max()) / ulp:.2f} bf16 ulps of the largest "
               f"logit, {past:.2%} of the logits past one (limits "
               f"{BF16_FORWARD_ULPS}, {BF16_FORWARD_PAST:.0%}); the "
               f"forward's token at {int(tokens[sure].sum())} of "
               f"{int(sure.sum())} rows whose top-2 gap exceeds that, "
               f"{int(tokens.sum())} of {tokens.numel()} in all")
        del top2, sure, tokens
    else:
        ok = bool(torch.all(diff <= FORWARD_TOL * (1 + ref.abs())).item())
        tol = f"tol rtol / atol {FORWARD_TOL}"
    gaps = [float(d.max()) for d in diff]
    finite = bool(torch.isfinite(got).all())
    n_params = plib.n_params(spec)
    del got, ref, diff, rows, view
    torch.cuda.empty_cache()
    layers = [hidden_gap(a, b) for a, b in zip(*hidden)]
    slots = [(g.reps, s) for g in arch.groups for s in g.slots]
    expanded = sum(reps * B * cap * s.attn.n_heads
                   * (s.attn.head_dim + s.attn.rope_head_dim
                      + (s.attn.v_head_dim or s.attn.head_dim)) * 4
                   for reps, s in slots if s.attn and s.attn.is_mla)
    scans = sum(reps for reps, s in slots if s.mixer == "mamba")
    cost = step_cost(arch, InputShape("serve", cap, B, "decode"), "decode",
                     db=esz)
    model_ms = bound_ms(cost, PEAK_BF16_FLOPS if esz == 2 else PEAK_F32_FLOPS)
    ring_bytes = cache_bytes - state_bytes
    hand_bytes = esz * (n_params - (arch.vocab - B) * arch.d_model
                        - (fe.embed_dim * arch.d_model if fe else 0)) \
        + ring_bytes + ring_bytes // cap + 2 * state_bytes
    hand_ms = hand_bytes / PEAK_HBM_BYTES * 1e3
    b_ms = max(model_ms, hand_ms)
    steady = sorted(step_ms[1:])
    out = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
           "steady_median_ms": steady[len(steady) // 2],
           "steady_spread_ms": (steady[0], steady[-1]),
           "decode_bound_ms": b_ms, "decode_cost": (cost.flops, cost.bytes),
           "cost_model_ms": model_ms, "hand_bytes": hand_bytes,
           "hand_ms": hand_ms, "seed": seed, "layer_gaps": layers,
           "dtype": str(dt),
           "tok_s": B * new / (sum(step_ms) / 1e3),
           "tok_s_with_prefill": B * (new + 1)
           / ((prefill_ms + sum(step_ms)) / 1e3),
           "peak_gib": peak, "cache_bytes": cache_bytes,
           "expanded_kv_bytes": expanded, "launches": launches,
           "prefill_gap": gaps[0], "max_decode_gap": max(gaps[1:])}
    caps = sorted({s.moe.capacity_factor for _, s in slots if s.moe})
    kv = (f" against {expanded} B of expanded K/V "
          f"({expanded / cache_bytes:.1f}x)") if expanded else ""
    front = f"{n_e} embeddings and a " if fe else "a "
    if layers:
        log(f"[{tag}] witness: the last decode step's hidden state against "
            f"the forward's at position {cap - 1}, layer by layer (max gap "
            f"in bf16 ulps of the layer's largest value, share of elements "
            f"not bitwise): {[(round(u, 2), round(f, 4)) for u, f in layers]}")
    log(f"[{tag}] serving {arch.name} ({n_params} params"
        f"{f', capacity factor {caps}' if caps else ''}): {B} sequences, "
        f"{front}{P}-token prefill in {prefill_ms:.1f} ms into a cache of "
        f"{cap}, "
        f"{new} decode steps: median {out['steady_median_ms']:.2f} ms "
        f"(spread {out['steady_spread_ms'][0]:.2f}-"
        f"{out['steady_spread_ms'][1]:.2f}, first {step_ms[0]:.2f}; bound "
        f"{b_ms:.4f} ms, the larger of the cost model's {model_ms:.4f} and "
        f"{hand_bytes} B counted by hand, {hand_ms:.4f}; "
        f"{b_ms / out['steady_median_ms']:.1%} reached); seed {seed}; "
        f"{out['tok_s']:.1f} tok/s decoding, "
        f"{out['tok_s_with_prefill']:.1f} with the prefill; peak "
        f"{peak:.2f} GiB; cache {cache_bytes} B{kv}; against a no-cache "
        f"forward over {cap} tokens: prefill max |gap| {gaps[0]:.3e}, "
        f"decode max |gap| {out['max_decode_gap']:.3e} ({tol}); {dt}; "
        f"launches {launches} ({card})")
    if not (ok and finite):
        raise AssertionError(f"{tag}: cached logits off the no-cache forward "
                             f"(gaps {gaps}) or not finite")
    want = {"selective_scan": scans * (new + 2)} if scans else {}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, not {want}")
    if not peak < 80:
        raise AssertionError(f"{tag}: peak memory {peak} GiB")
    return launches, out


def phase_deepseek(ds, card: str) -> tuple:
    """Phase 16: the DeepSeek-V2 cut.  (a) SeedFlood, DEEPSEEK_CLIENTS on a
    ring, 3 steps, at the published capacity factor; (b) serving one model
    of the cut from the compressed cache (``serve_cached``) at
    DEEPSEEK_SERVE_CAPACITY.  Returns (a)'s launches and both arms'
    numbers."""
    launches, out = run_slice(ds, "deepseek", "16a", card, DEEPSEEK_CLIENTS,
                              ledger=LEDGER_RING4_3STEPS)
    dense, expert = mla_launches(ds)
    for name, want in (("rank1_matmul", dense * 2 * 3),
                       ("rank1_matmul_expert", expert * 2 * 3),
                       ("rank1_matmul_t", 0)):
        if launches.get(name, 0) != want:
            raise AssertionError(f"deepseek: {name} launched "
                                 f"{launches.get(name, 0)} times, not {want}")
    check_dense_run("deepseek", launches, out)
    _, out["serve"] = serve_cached(deepseek_serving(ds), card, "16b",
                                   DEEPSEEK_SERVE_B, DEEPSEEK_PROMPT,
                                   DEEPSEEK_NEW)
    return launches, out


def phase_jamba(jamba, falcon_whole, card: str) -> dict:
    """Phase 17: (a) SeedFlood on the Jamba cut, JAMBA_CLIENTS on a ring, 3
    steps: the JAX ledger, the launches ``hybrid_shapes`` counts in both
    signed forwards of each step (and one scan per Mamba slot in every
    forward of the final accuracy pass and validation loss), no tied
    logits, both updates, peak under 80 GiB; (b) one model of the cut and
    (c) Falcon Mamba 7B whole served through the monolithic steps
    (``serve_cached``).  Returns {key: (launches, numbers)}."""
    launches, out = run_slice(jamba, "jamba", "17a", card, JAMBA_CLIENTS,
                              ledger=LEDGER_RING3_3STEPS)
    shapes, expert, scans = hybrid_shapes(jamba)
    n_eval = -(-SLICE_TEST // EVAL_BATCH)
    for name, want in (("rank1_matmul", sum(shapes.values()) * 2 * 3),
                       ("rank1_matmul_expert", expert * 2 * 3),
                       ("selective_scan", scans * (2 * 3 + n_eval + 1)),
                       ("rank1_matmul_t", 0)):
        if launches.get(name, 0) != want:
            raise AssertionError(f"jamba: {name} launched "
                                 f"{launches.get(name, 0)} times, not {want}")
    check_dense_run("jamba", launches, out)
    return {"jamba": (launches, out),
            "jamba_serve": serve_cached(jamba, card, "17b", MAMBA_SERVE_B,
                                        MAMBA_PROMPT, MAMBA_NEW),
            "falcon_serve": serve_cached(falcon_whole, card, "17c",
                                         MAMBA_SERVE_B, MAMBA_PROMPT,
                                         MAMBA_NEW)}


def phase_kernels_pod(arch, C: int, B: int, T: int) -> dict:
    """The kernels of the pod SeedFlood step (phase 18 (b)) at ``arch``'s
    shapes: C clients sharing one model (W expanded with a client stride
    of 0), each with B sequences of the frontend's P embeddings and T
    tokens.  ``rank1_matmul``: one layer's seven projections and the
    untied logits at M = B (P + T) per client; the projector at M = B P,
    K = embed_dim, as a unit of its own (key ``proj``); ``subcge_apply``:
    one update of every matrix leaf of the one model.  One timed call a
    shape after one warm-up: at the logits one call computes 19 TFLOP."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    slot = arch.groups[0].slots[0]
    a, d, ff = slot.attn, arch.d_model, slot.d_ff
    q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    P = arch.frontend.n_embeds
    layer: dict = {}
    for shape in ([(d, q), (d, kv), (d, kv), (q, d), (d, ff)]
                  + [(d, ff)] * arch.gated_mlp + [(ff, d), (d, arch.vocab)]):
        layer[shape] = layer.get(shape, 0) + 1
    units = {"pod": {"rank1_matmul": Entry("rank1_matmul"),
                     "subcge_apply": Entry("subcge_apply")},
             "proj": {"rank1_matmul": Entry("rank1_matmul")}}
    check_rank1(units["pod"]["rank1_matmul"], C, B * (P + T),
                tuple(layer.items()), randn, shared=True, reps=1, warmup=1)
    check_rank1(units["proj"]["rank1_matmul"], C, B * P,
                (((arch.frontend.embed_dim, d), 1),), randn, shared=True,
                reps=1, warmup=1)
    check_update(units["pod"]["subcge_apply"], update_leaves(arch, 1), 1,
                 randn)
    return units


def phase_kernels_bf16(vl, qwen, jamba) -> dict:
    """Phase 2's bf16 units, one per kernel row, at shapes phase 19 runs:
    ``rank1_matmul_bf16`` at InternVL2-26B's pod shapes (POD_CLIENTS clients
    over one W, M = POD_B (1024 + POD_TEXT) rows a client: one layer's
    seven projections and the untied logits; the projector at M = POD_B x
    1024, K = 3200, a unit of its own), ``rank1_matmul_t_bf16`` at
    Qwen1.5-0.5B's tied logits (8 clients over one W, M = 264),
    ``rank1_matmul_expert_bf16`` at the Jamba cut's experts (JAMBA_CLIENTS
    clients, capacity 330), ``subcge_apply_bf16`` at every matrix leaf of
    one InternVL2-26B, and ``subcge_apply_epochs_bf16`` at E = 2 over one
    Qwen1.5-0.5B (not on phase 19's path: the pod does not replay).  Each
    within one bf16 ulp of its bf16 plain version, bitwise across two
    calls, timed beside ``baddbmm`` in bf16."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    slot = vl.groups[0].slots[0]
    a, d, ff = slot.attn, vl.d_model, slot.d_ff
    q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    P = vl.frontend.n_embeds
    layer: dict = {}
    for shape in ([(d, q), (d, kv), (d, kv), (q, d), (d, ff)]
                  + [(d, ff)] * vl.gated_mlp + [(ff, d), (d, vl.vocab)]):
        layer[shape] = layer.get(shape, 0) + 1
    units = {"internvl_pod_bf16": {"rank1_matmul_bf16":
                                   Entry("rank1_matmul_bf16"),
                                   "subcge_apply_bf16":
                                   Entry("subcge_apply_bf16")},
             "internvl_proj_bf16": {"rank1_matmul_bf16":
                                    Entry("rank1_matmul_bf16")},
             "qwen_bf16": {"rank1_matmul_t_bf16":
                           Entry("rank1_matmul_t_bf16"),
                           "subcge_apply_epochs_bf16":
                           Entry("subcge_apply_epochs_bf16")},
             "jamba_bf16": {"rank1_matmul_expert_bf16":
                            Entry("rank1_matmul_expert_bf16")}}
    pod = units["internvl_pod_bf16"]
    check_rank1(pod["rank1_matmul_bf16"], POD_CLIENTS, POD_B * (P + POD_TEXT),
                tuple(layer.items()), randn, shared=True, reps=1, warmup=1)
    check_rank1(units["internvl_proj_bf16"]["rank1_matmul_bf16"], POD_CLIENTS,
                POD_B * P, (((vl.frontend.embed_dim, d), 1),), randn,
                shared=True, reps=1, warmup=1)
    check_update(pod["subcge_apply_bf16"], update_leaves(vl, 1), 1, randn)
    check_rank1(units["qwen_bf16"]["rank1_matmul_t_bf16"], SLICE_CLIENTS,
                SLICE_B * 33, (((qwen.d_model, qwen.vocab), 1),), randn,
                trans=True, shared=True)
    check_update(units["qwen_bf16"]["subcge_apply_epochs_bf16"],
                 update_leaves(qwen, 1), 2, randn)
    mam = next(s for grp in jamba.groups for s in grp.slots if s.moe)
    check_expert(units["jamba_bf16"]["rank1_matmul_expert_bf16"],
                 JAMBA_CLIENTS, SLICE_B * 33, mam.moe, jamba.d_model, randn)
    return units


def phase_kernels_rank64(qwen) -> dict:
    """The update at RANK_SWEEP (the paper's Fig. 6 sweep), past the float32
    stream's rank 32, on the tensor-core kernel: ``subcge_apply`` (float32)
    and ``subcge_apply_bf16`` on every matrix leaf of one Qwen1.5-0.5B, and
    the replay at E = 2 (``subcge_apply_epochs`` and its bf16 form, k =
    128); within the phase-2 tolerance of the plain rank-r update and
    bitwise across two calls.  The bound is the rank-r update's
    (``check_update``)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    units = {"qwen_r64": {"subcge_apply": Entry("subcge_apply"),
                          "subcge_apply_bf16": Entry("subcge_apply_bf16")},
             "qwen_r64_e2": {
                 "subcge_apply_epochs": Entry("subcge_apply_epochs"),
                 "subcge_apply_epochs_bf16":
                     Entry("subcge_apply_epochs_bf16")}}
    for E, key in ((1, "qwen_r64"), (2, "qwen_r64_e2")):
        for e in units[key].values():
            check_update(e, update_leaves(qwen, 1), E, randn, r=RANK_SWEEP)
    return units


def pod_steps(arch, pod, state, steps: int, seq: int, gb: int,
              before_step=None, after_step=None) -> dict:
    """``steps`` pod SeedFlood steps of ``state`` (``make_train_batch``
    seeded by the step), launch counters zeroed just before and read just
    after; ``before_step(t, state)`` and ``after_step(t, state)`` run
    around each step, untimed.  Returns the state, the step walls, the
    metrics, the launches and the peak GiB."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steplib

    step_fn = steplib.build_seedflood_train_step(arch, pod)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    wall, metrics = [], []
    for t in range(steps):
        batch = steplib.make_train_batch(arch, seq, gb, pod, seed=t,
                                         device="cuda")
        if before_step:
            before_step(t, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, t)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if after_step:
            after_step(t, state)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"pod {arch.name}: non-finite loss {losses}")
    return {"state": state, "step_fn": step_fn, "step_s": wall,
            "metrics": metrics, "launches": launches, "peak_gib": peak,
            "losses": losses}


def bf16_internvl(arch, card: str) -> dict:
    """Phase 19 (a): InternVL2-26B whole through the pod SeedFlood step at the
    PodConfig defaults (bf16 parameters, fold mode): BF16_STEPS steps and
    one profiled; then (d) the trained weights served in bf16
    (``serve_cached`` with its embeddings). Every leaf bf16 (no float32
    copy of a weight), the losses finite, the launches exactly the bf16
    kernels' (the projector, seven projections a layer and the logits in
    each signed forward, one update per matrix leaf a step), the peak under
    80 GiB, and the last step's update of BF16_CHECK_LEAF's first
    BF16_CHECK_ROWS rows of layer 0 held to the plain update of that step's
    messages (within one bf16 ulp; the elements it changed and the share
    equal bitwise printed)."""
    import torch
    from repro_torch.core import subcge
    from repro_torch.kernels import subcge_apply as sa
    from repro_torch.launch import steps as steplib
    from repro_torch.models import params as plib
    from repro_torch.models import transformer as tf

    pod = steplib.PodConfig(n_clients=POD_CLIENTS)
    if pod.param_dtype != torch.bfloat16 or pod.apply_mode != "fold":
        raise AssertionError(f"PodConfig defaults {pod}")
    seq, gb = arch.frontend.n_embeds + POD_TEXT, POD_CLIENTS * POD_B
    spec = tf.arch_spec(arch)
    meta = plib.subcge_meta(spec)
    n_params = plib.n_params(spec)
    n_matrix = sum(m.is_matrix for m in meta.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(arch, 0, "cuda", pod.param_dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    wrong = [p for p, t in params.items() if t.dtype != torch.bfloat16]
    if wrong:
        raise AssertionError(f"bf16 pod: leaves {wrong} are not bf16")
    gib = sum(t.numel() * t.element_size() for t in params.values()) / 2**30
    rows = slice(0, BF16_CHECK_ROWS)
    seen, apply = {}, subcge.apply_messages

    def recording(params_, meta_, scfg_, sub_, seeds_, coefs_):
        seen["msgs"] = (sub_[BF16_CHECK_LEAF], seeds_.clone(), coefs_.clone())
        return apply(params_, meta_, scfg_, sub_, seeds_, coefs_)

    def before_step(t, state):
        if t == BF16_STEPS - 1:
            seen["before"] = state[BF16_CHECK_LEAF][0, rows].clone()
            subcge.apply_messages = recording

    def after_step(t, state):
        subcge.apply_messages = apply
        if t == BF16_STEPS - 1:
            seen["after"] = state[BF16_CHECK_LEAF][0, rows].clone()

    try:
        run = pod_steps(arch, pod, params, BF16_STEPS, seq, gb, before_step,
                        after_step)
    finally:
        subcge.apply_messages = apply
    params = run["state"]
    batch = steplib.make_train_batch(arch, seq, gb, pod, seed=BF16_STEPS,
                                     device="cuda")
    t0 = time.perf_counter()
    prof = profile_step(lambda: run["step_fn"](params, batch, BF16_STEPS))
    prof_s = time.perf_counter() - t0
    del batch
    # the checked slice's update against the plain one of the same messages
    (U, V), seeds, coefs = seen["msgs"]
    i, j = subcge.sample_coords(meta, pod.subcge(), seeds)[BF16_CHECK_LEAF]
    A = subcge.scatter_A(i, j, coefs.float(), pod.rank)      # (1, L, r, r)
    before, got = seen["before"], seen["after"]
    want = sa.subcge_apply_plain(before, U[rows], A[0, 0], V)
    Entry("subcge_apply_bf16").check_bf16(
        got, want, f"19a update of {BF16_CHECK_LEAF}[0, :{BF16_CHECK_ROWS}]")
    changed = (int((got != before).sum()), int((want != before).sum()))
    steady = run["step_s"][1:]
    want_l = {"rank1_matmul_bf16": (arch.n_layers * 7 + 2) * 2 * BF16_STEPS,
              "subcge_apply_bf16": n_matrix * BF16_STEPS}
    out = {"n_params": n_params, "param_gib": gib, "init_s": init_s,
           "profile_s": prof_s,
           "step_s": run["step_s"], "steady_step_ms":
           1e3 * sum(steady) / len(steady), "metrics": run["metrics"],
           "peak_gib": run["peak_gib"], "launches": run["launches"],
           "profile": prof, "update_changed": changed}
    log(f"[19a] bf16 pod: {arch.name} whole ({n_params} params, "
        f"{gib:.2f} GiB of bf16, one copy, made in {init_s:.1f} s) x "
        f"{POD_CLIENTS} clients x {POD_B} sequences of "
        f"{arch.frontend.n_embeds} embeddings + {POD_TEXT} tokens, "
        f"{BF16_STEPS} steps: metrics {run['metrics']}; steps "
        f"{run['step_s']} s, steady {out['steady_step_ms']:.1f} ms; peak "
        f"{run['peak_gib']:.2f} GiB; launches {run['launches']}; elements "
        f"of the checked slice the update changed (kernel, plain) {changed}"
        f" of {before.numel()}; one profiled step ({prof_s:.1f} s with the "
        f"profiler's processing) {prof} ({card})")
    if run["launches"] != want_l:
        raise AssertionError(f"bf16 pod: launches {run['launches']}, not "
                             f"{want_l}")
    if not run["peak_gib"] < 80:
        raise AssertionError(f"bf16 pod: peak memory {run['peak_gib']} GiB")
    del run, seen, before, got, want, U, V, A
    torch.cuda.empty_cache()
    # (d) the pod's weights served in bf16: only bf16 fits them on one card
    # (74 GiB in float32), and a second init would take another ~43 s.
    # Two prompt seeds; the first with its witnesses of where the decode
    # departs from the forward: layer by layer, and layer 0's products of
    # one row at the decode's shape against the forward's
    cap = arch.frontend.n_embeds + INTERNVL_PROMPT + FRONTEND_NEW
    out["gemm_witness"] = gemm_witness(params, BF16_SERVE_B, cap, card)
    _, out["served"] = serve_cached(arch, card, "19d", BF16_SERVE_B,
                                    INTERNVL_PROMPT, FRONTEND_NEW,
                                    params=params, witness=True)
    _, out["served_seed2"] = serve_cached(
        arch, card, "19d", BF16_SERVE_B, INTERNVL_PROMPT, FRONTEND_NEW,
        params=params, seed=SERVE_SEED + 1)
    del params
    torch.cuda.empty_cache()
    return out


def gemm_witness(params, B: int, T: int, card: str,
                 leaves=("wq", "wk", "wo", "w1", "w2")) -> dict:
    """Layer 0's projections (``Bundle.dense``'s ``torch.bmm``) of random
    bf16 rows (seed SERVE_SEED), at the decode step's shape (B rows)
    against the forward's (B x T rows, the same rows last): the max gap
    in bf16 ulps of the largest output and the share of outputs not
    bitwise equal, per leaf."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
    out = {}
    with torch.no_grad():
        for leaf in leaves:
            W = params[f"g0/s0/{leaf}"][0][None]
            x = torch.randn((1, B, T, W.shape[1]), generator=gen,
                            device="cuda").to(W.dtype)
            full = torch.bmm(x.reshape(1, -1, W.shape[1]), W).reshape(
                B, T, -1)[:, -1]
            one = torch.bmm(x[:, :, -1], W)[0]
            out[leaf] = hidden_gap(one.float(), full.float())
            del x, full, one
    torch.cuda.empty_cache()
    log(f"[19d] witness: layer 0's products of one row at the decode's "
        f"shape ({B} rows) against the forward's ({B} x {T}), (max gap in "
        f"bf16 ulps of the largest output, share not bitwise): {out} "
        f"({card})")
    return out


def buffer_vs_fold(arch, card: str) -> dict:
    """Phase 19 (b): buffer mode against fold mode on ``arch`` whole
    through the pod step, 8 clients x BUFFER_B sequences of 33 tokens, tau
    BUFFER_TAU, BUFFER_STEPS steps from the same weights.  float32: buffer
    mode's effective weights (W + U A V^T under the last step's subspace)
    equal fold mode's weights at rtol 2e-4, atol 2e-5 (the reference's
    test_buffer_mode_matches_fold_mode).  bf16, as the reference's buffer
    mode behaves: the buffers float32 and moved; every matrix leaf
    bitwise unchanged until the step-BUFFER_TAU refresh, then the fold of
    the buffers under the previous subspace (within one bf16 ulp of the
    plain fold); every vector leaf, at every step, bitwise its value plus
    the plain update of that step's messages."""
    import torch
    from repro_torch.core import subcge
    from repro_torch.kernels import subcge_apply as sa
    from repro_torch.launch import steps as steplib
    from repro_torch.models import params as plib
    from repro_torch.models import transformer as tf

    meta = plib.subcge_meta(tf.arch_spec(arch))
    matrix = [p for p, m in meta.items() if m.is_matrix]
    vector = [p for p, m in meta.items() if not (m.is_matrix or m.frozen)]
    seq, gb = 33, SLICE_CLIENTS * BUFFER_B
    out, launches = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        runs = {}
        for mode in ("fold", "buffer"):
            pod = steplib.PodConfig(n_clients=SLICE_CLIENTS, tau=BUFFER_TAU,
                                    param_dtype=dt, apply_mode=mode)
            scfg = pod.subcge()
            params = tf.init_params(arch, 0, "cuda", dt)
            state = (params, steplib.init_buffers(arch, pod, "cuda")) \
                if mode == "buffer" else params
            kept, vec_msgs, apply_vec = {}, {}, subcge.apply_vector_messages
            checks = {"matrix_unchanged": [], "vectors": [], "fold": None}

            def rec_vec(params_, meta_, scfg_, seeds_, coefs_):
                vec_msgs["last"] = (seeds_.clone(), coefs_.clone())
                return apply_vec(params_, meta_, scfg_, seeds_, coefs_)

            def before_step(t, state, mode=mode, dt=dt):
                if mode == "buffer" and dt == torch.bfloat16:
                    p, b = state
                    kept["W"] = {k: p[k].clone() for k in matrix}
                    kept["v"] = {k: p[k].clone() for k in vector}
                    kept["bufs"] = {k: x.clone() for k, x in b.items()}

            def after_step(t, state, mode=mode, dt=dt, scfg=scfg):
                if not (mode == "buffer" and dt == torch.bfloat16):
                    return
                p, b = state
                seeds, coefs = vec_msgs["last"]
                for k in vector:
                    upd = subcge._vector_update(k, meta[k], seeds,
                                                coefs.float())[0]
                    if not torch.equal(bits(p[k]),
                                       bits(kept["v"][k] + upd.to(dt))):
                        raise AssertionError(f"buffer bf16: vector leaf {k} "
                                             f"at step {t} is not its plain "
                                             "update")
                checks["vectors"].append(t)
                if t == 0 or t % BUFFER_TAU:
                    same = all(torch.equal(bits(p[k]), bits(kept["W"][k]))
                               for k in matrix)
                    if not same:
                        raise AssertionError(f"buffer bf16: a matrix leaf "
                                             f"moved at step {t}")
                    checks["matrix_unchanged"].append(t)
                    return
                old = subcge.subspace_at_step(meta, scfg, 0, t - 1, "cuda")
                e = Entry("subcge_apply_bf16")
                for k in matrix:
                    U, V = old[k]
                    want = sa.subcge_apply_plain(kept["W"][k][None], U,
                                                 kept["bufs"][k], V)[0]
                    e.check_bf16(p[k], want, f"19b fold of {k} at step {t}")
                checks["fold"] = t
                if not all(x.dtype == torch.float32 and bool(x.abs().sum() > 0)
                           for x in b.values()):
                    raise AssertionError("buffer bf16: the buffers are not "
                                         "float32 or did not move")

            subcge.apply_vector_messages = rec_vec
            try:
                run = pod_steps(arch, pod, state, BUFFER_STEPS, seq, gb,
                                before_step, after_step)
            finally:
                subcge.apply_vector_messages = apply_vec
            kept.clear()
            state = run.pop("state")
            run.pop("step_fn")
            if mode == "buffer":
                params, bufs = state
                sub = subcge.subspace_at_step(meta, scfg, 0,
                                              BUFFER_STEPS - 1, "cuda")
                one = {k: t[None] for k, t in params.items()}
                eff = subcge.effective_params(one, meta, sub, bufs)
                state = {k: t[0] for k, t in eff.items()}
                if not all(b.dtype == torch.float32 for b in bufs.values()):
                    raise AssertionError("buffer mode: buffers not float32")
                del one, eff, bufs
            runs[mode] = (state, run, checks)
            launches[f"{mode}_{str(dt)[6:]}"] = run["launches"]
        fold, buf = runs["fold"][0], runs["buffer"][0]
        gap = max(float((buf[k].float() - fold[k].float()).abs().max())
                  for k in fold)
        key = str(dt)[6:]
        out[key] = {mode: {k: v for k, v in r[1].items()}
                    for mode, r in runs.items()}
        out[key]["max_weight_gap"] = gap
        out[key]["checks"] = runs["buffer"][2]
        log(f"[19b] {arch.name} {key}, fold vs buffer mode, "
            f"{SLICE_CLIENTS} clients x {BUFFER_B} x 33 tokens, tau "
            f"{BUFFER_TAU}, {BUFFER_STEPS} steps: losses "
            f"{runs['fold'][1]['losses']} / {runs['buffer'][1]['losses']}; "
            f"steady step ms {[1e3 * sum(r[1]['step_s'][1:]) / (BUFFER_STEPS - 1) for r in runs.values()]}; "
            f"max |effective buffer W - fold W| {gap:.3e}; buffer checks "
            f"{runs['buffer'][2]}; peak GiB "
            f"{[r[1]['peak_gib'] for r in runs.values()]}; launches "
            f"{[r[1]['launches'] for r in runs.values()]} ({card})")
        if dt == torch.float32:
            for k, w in fold.items():
                if not torch.allclose(buf[k], w, rtol=2e-4, atol=2e-5):
                    raise AssertionError(f"buffer mode: effective {k} "
                                         "differs from fold mode's")
        elif runs["buffer"][2]["fold"] != BUFFER_TAU \
                or len(runs["buffer"][2]["vectors"]) != BUFFER_STEPS:
            raise AssertionError(f"buffer bf16: checks {runs['buffer'][2]}")
        del runs, fold, buf
        torch.cuda.empty_cache()
    return launches, out


def bf16_jamba(jamba, card: str) -> tuple:
    """Phase 19 (c): the Jamba cut in bf16 through the pod step (bf16
    experts, float32 scan inputs inside a bf16 model), JAMBA_CLIENTS
    clients sharing one model, 8 sequences of 33 tokens each,
    JAMBA_POD_STEPS steps: losses finite, and the launches exactly what
    phase 17 counts in a signed forward (``hybrid_shapes``), in both signed
    forwards of each step, on the bf16 kernels, with one bf16 update per
    matrix leaf a step."""
    import torch
    from repro_torch.launch import steps as steplib
    from repro_torch.models import params as plib
    from repro_torch.models import transformer as tf

    pod = steplib.PodConfig(n_clients=JAMBA_CLIENTS)
    meta = plib.subcge_meta(tf.arch_spec(jamba))
    params = tf.init_params(jamba, 0, "cuda", pod.param_dtype)
    run = pod_steps(jamba, pod, params, JAMBA_POD_STEPS, 33,
                    JAMBA_CLIENTS * SLICE_B)
    shapes, expert, scans = hybrid_shapes(jamba)
    fwd = 2 * JAMBA_POD_STEPS
    want = {"rank1_matmul_bf16": sum(shapes.values()) * fwd,
            "rank1_matmul_expert_bf16": expert * fwd,
            "selective_scan": scans * fwd,
            "subcge_apply_bf16": sum(m.is_matrix for m in meta.values())
            * JAMBA_POD_STEPS}
    out = {k: run[k] for k in ("step_s", "metrics", "launches", "peak_gib")}
    log(f"[19c] bf16 pod: {jamba.name} x {JAMBA_CLIENTS} clients x "
        f"{SLICE_B} x 33 tokens, {JAMBA_POD_STEPS} steps: metrics "
        f"{run['metrics']}; steps {run['step_s']} s; peak "
        f"{run['peak_gib']:.2f} GiB; launches {run['launches']} ({card})")
    if run["launches"] != want:
        raise AssertionError(f"bf16 jamba: launches {run['launches']}, not "
                             f"{want}")
    del params, run
    torch.cuda.empty_cache()
    return out["launches"], out


def pod_run(arch, card: str) -> dict:
    """Phase 18 (b): ``launch.steps``' pod SeedFlood step on one model of
    ``arch`` shared by POD_CLIENTS clients, each with POD_B sequences of
    the frontend's embeddings and POD_TEXT tokens (``make_train_batch``,
    seeded by the step), in float32, POD_SF_STEPS steps, launch counters
    zeroed just before and read just after, then one step profiled by the
    device's activity alone (the measure phase 19 (a) reads).  Then the
    pod DSGD step, POD_DSGD_STEPS steps in float32
    and one in bf16 (the clients' bf16 gradients summed in float32), which
    launches no hand-written kernel (autograd through plain products).
    Each signed forward runs the projector, the layer's seven projections
    and the logits through ``rank1_matmul``, and each step one
    ``subcge_apply`` per matrix leaf; losses finite, the projector moved,
    peak under 80 GiB."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steplib
    from repro_torch.models import params as plib
    from repro_torch.models import transformer as tf

    seq, gb = arch.frontend.n_embeds + POD_TEXT, POD_CLIENTS * POD_B
    spec = tf.arch_spec(arch)
    n_params = plib.n_params(spec)
    n_matrix = sum(m.is_matrix for m in plib.subcge_meta(spec).values())
    params = tf.init_params(arch, 0, "cuda")
    out = {}
    for kind, build_step, steps, dtype in (
            ("seedflood", steplib.build_seedflood_train_step, POD_SF_STEPS,
             torch.float32),
            ("dsgd", steplib.build_dsgd_train_step, POD_DSGD_STEPS,
             torch.float32),
            ("dsgd_bf16", steplib.build_dsgd_train_step, 1, torch.bfloat16)):
        pod = steplib.PodConfig(n_clients=POD_CLIENTS, param_dtype=dtype)
        if dtype != torch.float32:
            params = {p: t.to(dtype) for p, t in params.items()}
            torch.cuda.empty_cache()
        init_proj = params["frontend/proj"].clone()
        step_fn = build_step(arch, pod)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        wall, metrics = [], []
        t_run = time.perf_counter()
        for t in range(steps):
            batch = steplib.make_train_batch(arch, seq, gb, pod, seed=t,
                                             device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, m = step_fn(params, batch, t)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        moved = float((params["frontend/proj"].float()
                       - init_proj.float()).abs().max())
        losses = [m["loss"] for m in metrics]
        # steps after the first; one step alone is its own
        o = {"step_s": wall, "steady_step_ms": 1e3 * sum(wall[1:] or wall)
             / len(wall[1:] or wall), "first_step_ms": 1e3 * wall[0],
             "metrics": metrics, "peak_gib": peak, "launches": launches,
             "proj_moved": moved, "run_s": time.perf_counter() - t_run}
        if kind == "seedflood":
            o["profile"] = profile_step(lambda: step_fn(params, batch, steps))
        log(f"[18b] pod {kind}: {arch.name} ({n_params} params, one copy, "
            f"{str(dtype)[6:]}) x {POD_CLIENTS} clients x {POD_B} sequences "
            f"of {arch.frontend.n_embeds} embeddings + {POD_TEXT} tokens, "
            f"{steps} steps: metrics {metrics}; first step "
            f"{o['first_step_ms']:.1f} ms, steady {o['steady_step_ms']:.1f} "
            f"ms ({wall}); peak {peak:.2f} GiB; projector moved by "
            f"{moved:.3e}; launches {launches} ({card})")
        if kind == "seedflood":
            for key, what in (("profile", "device activity only"),):
                pr = o[key]
                log(f"[18b] pod seedflood, one profiled step ({what}): wall "
                    f"{pr['wall_ms']:.1f} ms, device busy "
                    f"{pr['device_busy_ms']:.1f} ms "
                    f"({pr['busy_share']:.1%}), {pr['device_launches']} "
                    f"device launches; top {pr['top_kernels'][:4]} ({card})")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"pod {kind}: non-finite loss {losses}")
        if kind == "seedflood":
            want = {"rank1_matmul": (arch.n_layers * 7 + 2) * 2 * steps,
                    "subcge_apply": n_matrix * steps}
        else:
            want = {}
        if launches != want:
            raise AssertionError(f"pod {kind}: launches {launches}, not "
                                 f"{want}")
        if not moved > 0:
            raise AssertionError(f"pod {kind}: the projector did not move")
        if any(t.dtype != dtype for t in params.values()):
            raise AssertionError(f"pod {kind}: a leaf left {dtype}")
        if not peak < 80:
            raise AssertionError(f"pod {kind}: peak memory {peak} GiB")
        out[kind] = o
        del batch, init_proj
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def cli_run(card: str) -> dict:
    """Phase 18 (c): ``python -m repro_torch.launch.train`` on
    MusicGen-medium whole (``CLI_ARGV``, no ``--reduced``: bf16 parameters
    through the kernels' bf16 paths, as the reference's CLI), in this
    process, checkpoints into a temporary directory: every leaf bf16, the
    losses finite, the test accuracy printed, the step-2 checkpoint (its
    leaves stored as ``::bf16`` bits) read back bitwise equal to the
    parameters the CLI ended with, then removed."""
    import tempfile
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels import build
    from repro_torch.launch import train as trainlib
    from repro_torch.models import params as plib

    build.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = trainlib.run(CLI_ARGV + ["--ckpt-dir", tmp])
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        (path,) = res["checkpoints"]
        nbytes = Path(path).stat().st_size
        t0 = time.perf_counter()
        tree, meta = ckpt.load(path)
        read_s = time.perf_counter() - t0
        flat = plib.flatten(tree)
        if set(flat) != set(res["params"]) or meta.get("step") != 2:
            raise AssertionError(f"cli: checkpoint holds {sorted(flat)} at "
                                 f"step {meta.get('step')}")
        for p, t in res["params"].items():
            got = torch.as_tensor(flat[p])
            if t.dtype != torch.bfloat16 or got.dtype != t.dtype \
                    or not torch.equal(bits(got), bits(t.cpu())):
                raise AssertionError(f"cli: checkpoint leaf {p} differs "
                                     f"({got.dtype}, {t.dtype})")
    out = {"losses": res["losses"], "accuracy": res["accuracy"],
           "train_s": res["seconds"], "wall_s": wall, "ckpt_bytes": nbytes,
           "ckpt_read_s": read_s, "launches": launches}
    log(f"[18c] cli: {' '.join(CLI_ARGV)}: losses {res['losses']}, test "
        f"accuracy {res['accuracy']}, {res['seconds']:.1f} s of training, "
        f"{wall:.1f} s in all; checkpoint {nbytes} B read back bitwise in "
        f"{read_s:.1f} s; launches {launches} ({card})")
    if not all(math.isfinite(v) for v in res["losses"]):
        raise AssertionError(f"cli: non-finite loss {res['losses']}")
    if launches.get("rank1_matmul_bf16", 0) <= 0 \
            or launches.get("subcge_apply_bf16", 0) <= 0 \
            or launches.get("rank1_matmul", 0) \
            or launches.get("subcge_apply", 0):
        raise AssertionError(f"cli: launches {launches}")
    del res, tree, flat
    torch.cuda.empty_cache()
    return out


def phase_frontend(musicgen, internvl, card: str) -> dict:
    """Phase 18: the frontend archs.  (a) MusicGen-medium whole through
    ``run``: the JAX ledger of the ring of 8, consensus < 1e-10, six
    projections a layer and the untied logits through ``rank1_matmul`` in
    both signed forwards of 3 steps, no tied logits, both updates, and the
    projector ``frontend/proj`` moved by the update though no loss reads
    it; (b) the InternVL cut through the pod steps (``pod_run``); (c) the
    train CLI (``cli_run``); (d) both served with their embeddings
    (``serve_cached``), and every paged builder refusing both.  Returns
    {key: (launches, numbers)}."""
    import torch
    from repro_torch.launch import steps as steplib
    from repro_torch.models import params as plib
    from repro_torch.models import transformer as tf

    spec = tf.arch_spec(musicgen)
    init_proj = plib.init_params({"frontend/proj": spec["frontend/proj"]}, 0,
                                 "cuda")["frontend/proj"]

    def proj_moved(res):
        fin = res.extra["final_stacked"]["frontend/proj"]
        return {"proj_moved": float((fin - init_proj).abs().max())}

    launches, a = run_slice(musicgen, "musicgen", "18a", card,
                            inspect=proj_moved)
    for name, want in (("rank1_matmul", (6 * musicgen.n_layers + 1) * 2 * 3),
                       ("rank1_matmul_t", 0)):
        if launches.get(name, 0) != want:
            raise AssertionError(f"musicgen: {name} launched "
                                 f"{launches.get(name, 0)} times, not {want}")
    check_dense_run("musicgen", launches, a)
    if not a["proj_moved"] > 0:
        raise AssertionError("musicgen: the projector did not move")
    del init_proj
    torch.cuda.empty_cache()
    out = {"musicgen": (launches, a)}
    pod = pod_run(internvl, card)
    out["internvl_pod"] = (pod["seedflood"]["launches"], pod)
    cli = cli_run(card)
    out["cli"] = (cli["launches"], cli)
    for arch in (musicgen, internvl):
        for refuse in (lambda: steplib.build_paged_prefill_step(arch, 8, 64,
                                                                16),
                       lambda: steplib.build_paged_decode_step(arch)):
            try:
                refuse()
            except ValueError:
                continue
            raise AssertionError(f"{arch.name}: a paged builder took it")
    out["internvl_serve"] = serve_cached(internvl, card, "18d",
                                         FRONTEND_SERVE_B, INTERNVL_PROMPT,
                                         FRONTEND_NEW)
    out["musicgen_serve"] = serve_cached(musicgen, card, "18d",
                                         FRONTEND_SERVE_B, MUSICGEN_PROMPT,
                                         FRONTEND_NEW)
    log(f"[18d] both paged builders refuse both frontend archs ({card})")
    return out


def phase_small_frontend() -> None:
    """Phase 8's frontend half, on the card and on the CPU (the kernels'
    plain versions): the reduced MusicGen-medium through ``run``
    (text-only, 4 clients on a ring, SMALL_STEPS steps), and the reduced MusicGen
    and InternVL2-26B with their embeddings through the pod SeedFlood
    step (2 clients x 2 sequences of 8 embeddings + 9 tokens, made on the
    CPU, 3 steps): losses rel 1e-4, params abs 1e-4 (phase 8's
    tolerances).  The pod runs hold the card's own coefficients within
    1e-4 of the CPU's largest, and the card run is fed the CPU run's:
    with lr 1e-2 and rank-4 updates the ZO coefficient (L+ - L-) / 2 eps
    turns float32 summation-order differences into parameter gaps past
    1e-4 within 3 steps (1.06e-4 on the reduced InternVL in the first card
    call, NVIDIA H100 80GB HBM3, 700.00 W), as it does between the JAX
    package and the port (tests/test_torch_frontend.py); then one update of the reduced InternVL with a frozen
    matrix (``frontend/proj``) and a frozen vector (``embed/ln_f_scale``):
    both bitwise untouched on the card, every other leaf within 1e-5 of
    the CPU's."""
    import torch
    from repro_torch.configs import archs
    from repro_torch.core import subcge
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.launch import steps as steplib
    from repro_torch.models import params as plib
    from repro_torch.models import transformer as tf

    def agree(what, card_params, cpu_params, card_losses, cpu_losses):
        err = max(float((card_params[p].cpu() - t).abs().max())
                  for p, t in cpu_params.items())
        lrel = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))
        log(f"[8] small input {what}, card vs CPU: loss rel {lrel:.3e} (tol "
            f"1e-4), params max abs {err:.3e} (tol 1e-4)")
        if not (lrel <= 1e-4 and err <= 1e-4):
            raise AssertionError(f"small-input {what} on the card disagrees "
                                 "with the CPU run")

    mg = archs.reduced(archs.get(MUSICGEN_ARCH))
    vl = archs.reduced(archs.get("internvl2-26b"))
    small = dict(arch=mg, n_clients=4, topology="ring", steps=SMALL_STEPS,
                 batch_size=2)
    on = {dev: run(DTrainConfig(device=dev, **small))
          for dev in ("cuda", "cpu")}
    agree(f"run of {mg.name}, 4 clients, ring",
          on["cuda"].extra["final_stacked"], on["cpu"].extra["final_stacked"],
          on["cuda"].loss_curve, on["cpu"].loss_curve)
    pod = steplib.PodConfig(n_clients=2, lr=1e-2, rank=4, tau=2,
                            param_dtype=torch.float32)
    apply = subcge.apply_messages
    for arch in (mg, vl):
        seq = arch.frontend.n_embeds + 9
        batches = [steplib.make_train_batch(arch, seq, 4, pod, seed=t)
                   for t in range(3)]
        got, coefs = {}, {"cpu": [], "cuda": []}
        for dev in ("cpu", "cuda"):
            def recorded(params, meta, scfg, sub, seeds, c, dev=dev):
                coefs[dev].append(c.cpu())
                if dev == "cuda":   # fed the CPU run's coefficients
                    c = coefs["cpu"][len(coefs[dev]) - 1].to(c.device)
                return apply(params, meta, scfg, sub, seeds, c)

            params, losses = tf.init_params(arch, 0, dev), []
            step = steplib.build_seedflood_train_step(arch, pod)
            subcge.apply_messages = recorded
            try:
                for t, batch in enumerate(batches):
                    params, m = step(params, {k: v.to(dev)
                                              for k, v in batch.items()}, t)
                    losses.append(float(m["loss"]))
            finally:
                subcge.apply_messages = apply
            got[dev] = (params, losses)
        gap = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(coefs["cuda"], coefs["cpu"]))
        log(f"[8] pod step of {arch.name}: card's own coefficients vs the "
            f"CPU's, max gap {gap:.3e} of the largest (tol 1e-4)")
        if not gap <= 1e-4:
            raise AssertionError(f"small-input pod step of {arch.name}: the "
                                 "card's coefficients disagree with the CPU's")
        agree(f"pod step of {arch.name} with embeddings, 2 clients, fed the "
              f"CPU's coefficients", got["cuda"][0], got["cpu"][0],
              got["cuda"][1], got["cpu"][1])
    frozen = ("frontend/proj", "embed/ln_f_scale")
    meta = {p: dataclasses.replace(m, frozen=p in frozen)
            for p, m in plib.subcge_meta(tf.arch_spec(vl)).items()}
    scfg = subcge.SubCGEConfig(rank=4, refresh_period=2)
    seeds = torch.tensor([[7, 8, 9]])
    coefs = torch.tensor([[0.5, -1.0, 2.0]])
    upd = {}
    for dev in ("cuda", "cpu"):
        params = {p: t[None] for p, t in tf.init_params(vl, 0, dev).items()}
        before = {p: params[p].clone() for p in frozen}
        subcge.apply_messages(params, meta, scfg,
                              subcge.subspace_at_step(meta, scfg, 3, 0, dev),
                              seeds.to(dev), coefs.to(dev))
        for p in frozen:
            if not torch.equal(params[p].view(torch.int32),
                               before[p].view(torch.int32)):
                raise AssertionError(f"frozen leaf {p} moved on {dev}")
        upd[dev] = params
    err = max(float((upd["cuda"][p].cpu() - t).abs().max())
              for p, t in upd["cpu"].items())
    log(f"[8] frozen leaves {frozen} bitwise untouched by an update on the "
        f"card and the CPU; the other leaves card vs CPU max abs {err:.3e} "
        f"(tol 1e-5)")
    if not err <= 1e-5:
        raise AssertionError("the update with frozen leaves disagrees "
                             "between card and CPU")
    torch.cuda.empty_cache()


def deepseek_serving(ds):
    """``ds`` with every MoE slot at DEEPSEEK_SERVE_CAPACITY (phase 16 (b))."""
    return dataclasses.replace(ds, groups=tuple(
        dataclasses.replace(g, slots=tuple(
            s if s.moe is None else dataclasses.replace(
                s, moe=dataclasses.replace(
                    s.moe, capacity_factor=DEEPSEEK_SERVE_CAPACITY))
            for s in g.slots)) for g in ds.groups))


def host_ms(fn, reps: int = FIG5_REPS) -> float:
    """Median host milliseconds of ``reps`` calls of ``fn()``, each ended by
    ``torch.cuda.synchronize()`` (the caller warms up first)."""
    import torch
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def phase_fig5(opt, card: str) -> dict:
    """Phase 20 (a): the paper's Fig. 5 and Table 4 at ``opt``'s full width
    (one model, float32, rank FIG5_RANK, one τ-epoch): the message-apply
    phase (MA) of MeZO's dense replay (``zo.mezo_apply_messages``) against
    SubCGE's (``subcge.apply_messages``) at each K of FIG5_KS, and the
    gradient-estimate phase (GE) of each on one batch of 8 x 33 tokens
    (``zo.mezo_alpha`` against the dual forward through the rank-1
    kernels; the subspace, made once per τ-epoch, outside it, as the
    reference's Table 4).  Each time is the median of FIG5_REPS calls after
    a warm-up, beside its bound: MeZO's MA moves θ in and out once per
    message, SubCGE's once for all K.  First, the card's MeZO replay of
    the two smallest leaves at K = 4 is held bitwise to the CPU's."""
    import numpy as np
    import torch
    from repro_torch.core import subcge, zo
    from repro_torch.core.messages import fmt_bytes
    from repro_torch.models import params as plib
    from repro_torch.models import transformer as tf
    from repro_torch.models.perturb import sample_pert
    from repro_torch.roofline.cost_model import forward_cost

    meta = plib.subcge_meta(tf.arch_spec(opt))
    scfg = subcge.SubCGEConfig(rank=FIG5_RANK, refresh_period=10_000)
    params = {p: t[None] for p, t in tf.init_params(opt, 0, "cuda").items()}
    n = sum(t.numel() for t in params.values())
    theta_bytes = 4 * n
    sub = subcge.subspace_at_step(meta, scfg, 0, 0, "cuda")
    out = {"n_params": n, "rank": FIG5_RANK, "reps": FIG5_REPS, "ma": {}}

    small = sorted(params, key=lambda p: (params[p].numel(), p))[:2]
    seeds = torch.arange(1, 5, dtype=torch.int64)[None]
    coefs = torch.tensor([[1e-4, -2e-4, 3e-4, -4e-4]])
    on_card = zo.mezo_apply_messages({p: params[p].clone() for p in small},
                                     seeds.to("cuda"), coefs.to("cuda"))
    on_cpu = zo.mezo_apply_messages({p: params[p].cpu() for p in small},
                                    seeds, coefs)
    for p in small:
        if not torch.equal(bits(on_card[p].cpu()), bits(on_cpu[p])):
            raise AssertionError(f"fig5: mezo_apply_messages of {p} on the "
                                 "card differs from the CPU's")
    out["bitwise_leaves"] = {p: tuple(params[p].shape) for p in small}
    log(f"[20] fig5: {opt.name} ({n} params, {fmt_bytes(theta_bytes)} of "
        f"float32), rank {FIG5_RANK}; mezo_apply_messages at K = 4 on "
        f"{out['bitwise_leaves']}: card bitwise the CPU ({card})")

    def ma(fn, K):
        s = torch.arange(1, K + 1, dtype=torch.int64, device="cuda")[None]
        c = torch.full((1, K), 1e-4, device="cuda")
        return lambda: fn(params, s, c)

    mezo = zo.mezo_apply_messages

    def sub_ma(p, s, c):
        return subcge.apply_messages(p, meta, scfg, sub, s, c)

    ma(mezo, 1)()
    ma(sub_ma, 1)()
    torch.cuda.synchronize()
    for K in FIG5_KS:
        t_mezo, t_sub = host_ms(ma(mezo, K)), host_ms(ma(sub_ma, K))
        b_mezo = 1e3 * K * 2 * theta_bytes / PEAK_HBM_BYTES
        b_sub = 1e3 * 2 * theta_bytes / PEAK_HBM_BYTES
        out["ma"][K] = {"mezo_ms": t_mezo, "subcge_ms": t_sub,
                        "mezo_bound_ms": b_mezo, "subcge_bound_ms": b_sub,
                        "ratio": t_mezo / t_sub}
        log(f"[20] fig5 MA, K = {K}: mezo {t_mezo:.3f} ms (bound {b_mezo:.4f}"
            f" ms: {fmt_bytes(K * 2 * theta_bytes)} at 3.35 TB/s, "
            f"{b_mezo / t_mezo:.2%} reached), subcge {t_sub:.3f} ms (bound "
            f"{b_sub:.4f} ms: {fmt_bytes(2 * theta_bytes)}, "
            f"{b_sub / t_sub:.2%} reached); mezo / subcge "
            f"{t_mezo / t_sub:.1f}x ({card})")

    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, opt.vocab, (1, 8, 33)), device="cuda")
    one = torch.ones((1,), dtype=torch.int64, device="cuda")

    def loss(p):
        return tf.lm_loss(opt, p, toks)

    def ge_sub():
        pert = sample_pert(meta, scfg, one, scfg.eps)
        lp = tf.lm_loss(opt, params, toks, sub=sub, pert=pert)
        lm = tf.lm_loss(opt, params, toks, sub=sub,
                        pert=pert.with_scale(-scfg.eps))
        return (lp - lm) / (2 * scfg.eps)

    def ge_mezo():
        return zo.mezo_alpha(loss, params, one, scfg.eps)

    with torch.no_grad():
        a_sub, a_mezo = ge_sub(), ge_mezo()
        torch.cuda.synchronize()
        t_ge_sub, t_ge_mezo = host_ms(ge_sub), host_ms(ge_mezo)
    if not (torch.isfinite(a_sub).all() and torch.isfinite(a_mezo).all()):
        raise AssertionError("fig5: a non-finite gradient estimate")
    fwd = forward_cost(opt, 8, 33, 33, db=4)
    b_ge_sub, by = bound(2 * fwd.bytes, 2 * fwd.flops)
    # MeZO also forms θ ± εz: θ and z read, the copy written, twice
    b_ge_mezo, _ = bound(2 * fwd.bytes + 2 * 3 * theta_bytes, 2 * fwd.flops)
    out["ge"] = {"mezo_ms": t_ge_mezo, "subcge_ms": t_ge_sub,
                 "mezo_bound_ms": b_ge_mezo, "subcge_bound_ms": b_ge_sub,
                 "bound_by": by, "ratio": t_ge_mezo / t_ge_sub,
                 "alpha": [float(a_mezo[0]), float(a_sub[0])]}
    log(f"[20] fig5 GE, one batch of 8 x 33: mezo {t_ge_mezo:.3f} ms (bound "
        f"{b_ge_mezo:.4f} ms), subcge {t_ge_sub:.3f} ms (bound "
        f"{b_ge_sub:.4f} ms, {by}); mezo / subcge "
        f"{t_ge_mezo / t_ge_sub:.1f}x; Table 4 at K = {FIG5_KS[-1]}: mezo "
        f"GE + MA {t_ge_mezo + out['ma'][FIG5_KS[-1]]['mezo_ms']:.1f} ms, "
        f"subcge {t_ge_sub + out['ma'][FIG5_KS[-1]]['subcge_ms']:.1f} ms "
        f"({card})")
    del params, sub
    torch.cuda.empty_cache()
    return out


def phase_per_client(arch, card: str) -> tuple:
    """Phase 20 (b): SeedFlood's per-client reference path
    (``batched_step=False``) beside the batched path on ``arch`` whole, 8
    clients on a ring, PER_CLIENT_STEPS steps from the same weights: the
    ledgers equal, the leaves and losses within the reference's atol 1e-6
    after step 1 (tests/test_epoch_replay.py; bitwise reported) and 1e-5
    after the last, and the per-client launches pinned: ``subcge_apply``
    once per online client per matrix leaf (the own update, a client axis
    of 1), ``subcge_apply_epochs`` once per client with a live message per
    matrix leaf (the replay), the dual forward's products as the batched
    path's.  Both runs' results go into ``--out`` through
    ``RunResult.to_json``."""
    import torch
    from repro_torch.core.messages import fmt_bytes
    from repro_torch.data import synthetic
    from repro_torch.dtrain.methods.seedflood import SeedFloodMethod
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.kernels import build
    from repro_torch.models import params as plib
    from repro_torch.models import transformer as tf

    meta = plib.subcge_meta(tf.arch_spec(arch))
    n_matrix = sum(m.is_matrix and not m.frozen for m in meta.values())
    task = synthetic.TaskConfig(vocab=arch.vocab, n_test=SLICE_TEST)
    apply_inbox = SeedFloodMethod.apply_inbox
    seen = {}

    def hooked(self, stacked, inbox):
        stacked = apply_inbox(self, stacked, inbox)
        live = int((inbox.coefs != 0).any(axis=1).sum()) \
            if inbox is not None and inbox.seeds.shape[1] else 0
        seen["live"] = seen.get("live", 0) + live
        if inbox is not None and inbox.t == 0:
            seen["step1"](stacked)
        return stacked

    runs, launches, gaps = {}, {}, {}
    for batched in (True, False):
        tag = "batched" if batched else "per_client"
        seen["live"] = 0
        if batched:
            seen["step1"] = lambda st: seen.update(
                snap={p: t.clone() for p, t in st.items()})
        else:
            def step1(st):
                snap = seen.pop("snap")
                gaps["step1"] = max(float((st[p] - snap[p]).abs().max())
                                    for p in st)
                gaps["step1_bitwise"] = all(torch.equal(bits(st[p]),
                                                        bits(snap[p]))
                                            for p in st)
            seen["step1"] = step1
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        SeedFloodMethod.apply_inbox = hooked
        try:
            t0 = time.perf_counter()
            res = run(DTrainConfig(arch=arch, n_clients=SLICE_CLIENTS,
                                   topology="ring", steps=PER_CLIENT_STEPS,
                                   batch_size=SLICE_B, task=task,
                                   batched_step=batched, device="cuda"))
            wall = time.perf_counter() - t0
        finally:
            SeedFloodMethod.apply_inbox = apply_inbox
        launches[tag] = dict(build.LAUNCHES)
        runs[tag] = res
        steady = res.extra["step_wall_s"]
        log(f"[20] {tag}: {arch.name} x {SLICE_CLIENTS} clients, ring, "
            f"{PER_CLIENT_STEPS} steps of {SLICE_B} x 33 tokens in "
            f"{wall:.1f} s; losses {res.loss_curve}; ledger "
            f"{res.extra['n_messages']} msgs / {fmt_bytes(res.total_bytes)}; "
            f"first step {1e3 * res.compile_wall_s:.1f} ms, steady step "
            f"{1e3 * steady[-1]:.1f} ms; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{launches[tag]}; live client rows {seen['live']} ({card})")
        if not all(math.isfinite(v) for v in res.loss_curve):
            raise AssertionError(f"per-client {tag}: non-finite loss")
        if not res.consensus_error < 1e-10:
            raise AssertionError(f"per-client {tag}: consensus error "
                                 f"{res.consensus_error}")
        if tag == "batched":
            continue
        b, c = runs["batched"], res
        if (b.extra["n_messages"], b.total_bytes) != \
                (c.extra["n_messages"], c.total_bytes):
            raise AssertionError("per-client: the ledger differs from the "
                                 "batched path's")
        fb, fc = b.extra["final_stacked"], c.extra["final_stacked"]
        gaps["last"] = max(float((fc[p] - fb[p]).abs().max()) for p in fb)
        gaps["last_bitwise"] = all(torch.equal(bits(fc[p]), bits(fb[p]))
                                   for p in fb)
        gaps["loss"] = [abs(x - y) for x, y in zip(c.loss_curve,
                                                   b.loss_curve)]
        if not (gaps["step1"] <= 1e-6 and gaps["loss"][0] <= 1e-6
                and gaps["last"] <= 1e-5):
            raise AssertionError(f"per-client: gaps to the batched path "
                                 f"{gaps} past atol 1e-6 / 1e-5")
        want = {"subcge_apply": PER_CLIENT_STEPS * SLICE_CLIENTS * n_matrix,
                "subcge_apply_epochs": seen["live"] * n_matrix}
        for name in ("rank1_matmul", "rank1_matmul_t"):
            want[name] = launches["batched"].get(name, 0)
        for name, k in want.items():
            if launches[tag].get(name, 0) != k or k <= 0:
                raise AssertionError(f"per-client: {name} launched "
                                     f"{launches[tag].get(name, 0)} times, "
                                     f"not {k}")
    ratio = runs["per_client"].extra["step_wall_s"][-1] / \
        runs["batched"].extra["step_wall_s"][-1]
    log(f"[20] per-client vs batched: leaves after step 1 max gap "
        f"{gaps['step1']:.3e} (bitwise {gaps['step1_bitwise']}), after "
        f"step {PER_CLIENT_STEPS} {gaps['last']:.3e} (bitwise "
        f"{gaps['last_bitwise']}); loss gaps {gaps['loss']}; steady step "
        f"per-client / batched {ratio:.2f}x ({card})")
    out = {"gaps": gaps, "step_ratio": ratio, "n_matrix_leaves": n_matrix,
           "launches": launches,
           **{k: r.to_json() for k, r in runs.items()}}
    del runs
    torch.cuda.empty_cache()
    return launches["per_client"], out


def check_dense_run(what: str, launches: dict, out: dict) -> None:
    """Both updates launched, and the run's peak under the card's 80 GiB."""
    for name in ("subcge_apply", "subcge_apply_epochs"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{what}: kernel {name} never launched")
    if not out["peak_gib"] < 80:
        raise AssertionError(f"{what}: peak memory {out['peak_gib']} GiB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write details as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one steady full-width step")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import archs
    from repro_torch.configs.base import Group
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.kernels import build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    t_start = time.perf_counter()
    t_last = [t_start]

    phase_s = {}        # each phase's seconds, also in the --out JSON

    def clock(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = now - t_last[0]
        log(f"[t] phase {phase} took {now - t_last[0]:.1f} s "
            f"({now - t_start:.1f} s in all)")
        t_last[0] = now

    # 1. setup
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_s = build.build_all()
    libs = ("rank1_matmul", "subcge_apply", "selective_scan",
            "selective_scan_bwd")
    for name in libs:
        build.load(name)
    log(f"[1] kernels built in {build_s:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    ptxas = {n: ptxas_report(n) for n in libs}
    for name, reports in ptxas.items():
        for r in reports:
            log(f"    ptxas {name}: {r}")
    clock("1")

    # 2. kernels at the main paths' shapes
    qwen = archs.get("qwen1.5-0.5b")
    kimi, falcon = archs.kimi_cut(), archs.falcon_cut()
    C, B, T = SLICE_CLIENTS, SLICE_B, 33   # 32 tokens + the label slot
    log(f"[2] kernels vs plain versions at Qwen1.5-0.5B shapes ({card})")
    entries = {"qwen": phase_kernels_dense(qwen, C, B * T, 0, "qwen",
                                           (2, 4))}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[2] kernels vs plain versions at Kimi K2 cut shapes ({card})")
    entries["kimi"] = phase_kernels_kimi(kimi, C, B * T)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[2] kernels vs plain versions at Falcon Mamba 7B cut shapes ({card})")
    entries["falcon"] = phase_kernels_falcon(falcon, C, B, T)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    opt = archs.get("opt-125m")
    log(f"[2] kernels vs plain versions at OPT-125M shapes, "
        f"{PAPER_CLIENTS} clients ({card})")
    entries["opt"] = phase_kernels_dense(opt, PAPER_CLIENTS, B * T, 3, "opt",
                                         (2,))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tiny = archs.get(SERVE_ARCH)
    log(f"[2] the update kernel at the serving fold's shapes: one "
        f"{tiny.name} ({card})")
    entries["serve"] = phase_kernels_serve(tiny)
    torch.cuda.empty_cache()
    log(f"[2] the update kernel at the bf16 serving fold's shapes: one "
        f"{tiny.name} in bf16 ({card})")
    entries["serve_bf16"] = phase_kernels_serve(tiny, "serve bf16", True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gemma, qwen2 = archs.get(GEMMA_ARCH), archs.qwen2_cut()
    log(f"[2] kernels vs plain versions at Gemma 3 1B shapes, {C} clients, "
        f"and the update at its serving fold's ({card})")
    entries["gemma"] = phase_kernels_dense(gemma, C, B * T, 6, "gemma")
    torch.cuda.empty_cache()
    entries["gemma_serve"] = phase_kernels_serve(gemma, "gemma serve")
    torch.cuda.empty_cache()
    log(f"[2] kernels vs plain versions at Qwen2-72B cut shapes, "
        f"{QWEN2_CLIENTS} clients ({card})")
    entries["qwen2"] = phase_kernels_dense(qwen2, QWEN2_CLIENTS, B * T, 7,
                                           "qwen2")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    deepseek = archs.deepseek_cut()
    log(f"[2] kernels vs plain versions at DeepSeek-V2 cut shapes, "
        f"{DEEPSEEK_CLIENTS} clients ({card})")
    entries["deepseek"] = phase_kernels_deepseek(deepseek, DEEPSEEK_CLIENTS,
                                                 B * T)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    jamba, falcon_whole = archs.jamba_cut(), archs.get("falcon-mamba-7b")
    log(f"[2] kernels vs plain versions at Jamba cut shapes, "
        f"{JAMBA_CLIENTS} clients, and the scan at the serving shapes of the "
        f"Jamba cut and Falcon Mamba 7B ({card})")
    entries["jamba"] = phase_kernels_jamba(jamba, JAMBA_CLIENTS, B, T)
    torch.cuda.empty_cache()
    for key, arch in (("jamba_serve", jamba), ("falcon_serve", falcon_whole)):
        entries[key] = phase_kernels_mamba_serve(arch, MAMBA_SERVE_B,
                                                 MAMBA_PROMPT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    musicgen, internvl = archs.get(MUSICGEN_ARCH), archs.internvl_cut()
    log(f"[2] kernels vs plain versions at MusicGen-medium shapes, {C} "
        f"clients, and at the InternVL2-26B cut's pod shapes, "
        f"{POD_CLIENTS} clients sharing one model ({card})")
    entries["musicgen"] = phase_kernels_dense(musicgen, C, B * T, 8,
                                              "musicgen")
    torch.cuda.empty_cache()
    entries.update({"internvl_" + k: es for k, es in phase_kernels_pod(
        internvl, POD_CLIENTS, POD_B, POD_TEXT).items()})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    internvl_whole = archs.get(BF16_ARCH)
    log(f"[2] the bf16 paths: InternVL2-26B's pod shapes and one model's "
        f"update, Qwen1.5-0.5B's tied logits and replay at E = 2, the "
        f"Jamba cut's experts ({card})")
    entries.update(phase_kernels_bf16(internvl_whole, qwen, jamba))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[2] the update at rank {RANK_SWEEP} on one Qwen1.5-0.5B, float32 "
        f"and bf16, and its replay at E = 2 ({card})")
    entries.update(phase_kernels_rank64(qwen))
    torch.cuda.empty_cache()
    log("[2] tensor-core witness (bf16 products; cuBLAS baddbmm in bf16 with "
        "float32 sums, held to the same plain versions as the kernels): "
        + json.dumps(WITNESS))
    for key, es in entries.items():
        for e in es.values():
            log(f"[2] {key} {e.line()}")
    phase_prng()
    clock("2")


    # 3. the Qwen slice: full width
    launches, details = {}, {}
    launches["qwen"], details["qwen"] = run_slice(qwen, "slice", 3, card)
    for name in ("rank1_matmul", "rank1_matmul_t", "subcge_apply",
                 "subcge_apply_epochs"):
        if launches["qwen"].get(name, 0) <= 0:
            raise AssertionError(f"slice: kernel {name} never launched")

    clock("3")

    # 4. delayed flooding across τ-epochs, 2 layers
    slot = qwen.groups[0].slots[0]
    qwen_2l = dataclasses.replace(qwen, name=qwen.name + "-2l",
                                  groups=(Group((slot,), 2),))
    build.reset_launches()
    res = run(DTrainConfig(arch=qwen_2l, n_clients=C, topology="ring", steps=6,
                           batch_size=B, flood_k=1, subcge_tau=2, drain=True,
                           device="cuda"))
    check_run(res, LEDGER_RING8_6STEPS_K1_DRAIN, "delayed")
    multi = {E: k for E, k in build.EPOCH_LAUNCHES.items() if E >= 2}
    if not multi:
        raise AssertionError("delayed: subcge_apply_epochs never ran with E >= 2")
    log(f"[4] delayed flood: losses {res.loss_curve}; consensus "
        f"{res.consensus_error:.3e}; epoch launches by E "
        f"{dict(build.EPOCH_LAUNCHES)}; launches {dict(build.LAUNCHES)}")
    del res
    torch.cuda.empty_cache()

    clock("4")

    # 5. the Kimi K2 slice: the MoE layer at its published widths
    launches["kimi"], details["kimi"] = run_slice(kimi, "kimi", 5, card)
    for name in ("rank1_matmul", "rank1_matmul_expert", "subcge_apply",
                 "subcge_apply_epochs"):
        if launches["kimi"].get(name, 0) <= 0:
            raise AssertionError(f"kimi: kernel {name} never launched")
    # w1, w3 and w2 of one layer in each of the two signed forwards
    want = 6 * archs.KIMI_LAYERS * 3
    if launches["kimi"]["rank1_matmul_expert"] != want:
        raise AssertionError(f"kimi: rank1_matmul_expert launched "
                             f"{launches['kimi']['rank1_matmul_expert']} "
                             f"times, not {want}")

    clock("5")

    # 6. the Falcon Mamba 7B slice: the Mamba-1 layer at its published widths
    launches["falcon"], details["falcon"] = run_slice(falcon, "falcon", 6, card)
    for name in ("rank1_matmul", "subcge_apply", "subcge_apply_epochs"):
        if launches["falcon"].get(name, 0) <= 0:
            raise AssertionError(f"falcon: kernel {name} never launched")
    # one scan per Mamba layer in every forward: the two signed forwards of
    # each of the 3 steps, the final accuracy pass of the averaged model
    # (``RunResult.gmp``) over the SLICE_TEST-sample test split in batches of 128,
    # and its validation loss (one batch of 128 rows)
    n_eval = -(-SLICE_TEST // EVAL_BATCH)
    want = archs.FALCON_LAYERS * (2 * 3 + n_eval + 1)
    if launches["falcon"].get("selective_scan", 0) != want:
        raise AssertionError(f"falcon: selective_scan launched "
                             f"{launches['falcon'].get('selective_scan', 0)} "
                             f"times, not {want}")

    clock("6")

    # 7. the paper's setting: OPT-125M at full width, 64 clients on the
    # 8 x 8 mesh-grid, the bitset flood engine chosen by "auto"
    launches["opt"], details["opt"] = run_slice(
        opt, "paper", 7, card, PAPER_CLIENTS, PAPER_TOPOLOGY,
        LEDGER_MESHGRID64_3STEPS, "VectorFloodNetwork")
    # the six projections of each of the 12 layers in both signed forwards
    # of 3 steps, and the tied logits of each signed forward; the accuracy
    # pass and the validation loss are unperturbed (torch.bmm)
    n_layers = opt.n_layers
    for name, want in (("rank1_matmul", 6 * n_layers * 2 * 3),
                       ("rank1_matmul_t", 2 * 3)):
        if launches["opt"].get(name, 0) != want:
            raise AssertionError(f"paper: {name} launched "
                                 f"{launches['opt'].get(name, 0)} times, "
                                 f"not {want}")
    for name in ("subcge_apply", "subcge_apply_epochs"):
        if launches["opt"].get(name, 0) <= 0:
            raise AssertionError(f"paper: kernel {name} never launched")
    if not details["opt"]["peak_gib"] < 80:
        raise AssertionError(f"paper: peak memory {details['opt']['peak_gib']}"
                             " GiB")

    clock("7")

    # 8. the same code on small inputs, card against the CPU (the kernels'
    # plain versions): loss rtol 1e-4, params atol 1e-4 — the ZO
    # coefficient (L+ - L-) / 2 eps amplifies float32 summation-order
    # differences ~1e3-fold (tests/test_torch_slice.py sees 3e-5 between
    # the JAX package and the port)
    from repro_torch.dtrain.api import sim_arch
    for arch, clients, topology in (
            (sim_arch(d_model=64, n_layers=2, n_heads=4, d_ff=128), 4, "ring"),
            (archs.reduced(archs.get("kimi-k2-1t-a32b")), 4, "ring"),
            (archs.reduced(archs.get("falcon-mamba-7b")), 4, "ring"),
            (archs.reduced(opt), PAPER_CLIENTS, PAPER_TOPOLOGY)):
        small = dict(arch=arch, n_clients=clients, topology=topology,
                     steps=SMALL_STEPS, batch_size=2)
        on_card = run(DTrainConfig(device="cuda", **small))
        on_cpu = run(DTrainConfig(device="cpu", **small))
        if on_card.extra["engine"] != on_cpu.extra["engine"]:
            raise AssertionError(f"small-input run of {arch.name}: flood "
                                 "engines differ between card and CPU")
        err = max(float((on_card.extra["final_stacked"][p].cpu() - t).abs()
                        .max())
                  for p, t in on_cpu.extra["final_stacked"].items())
        lrel = max(abs(a - b) / abs(b) for a, b in zip(on_card.loss_curve,
                                                       on_cpu.loss_curve))
        log(f"[8] small input {arch.name}, {clients} clients, {topology} "
            f"({on_card.extra['engine']}), card vs CPU: loss rel {lrel:.3e} "
            f"(tol 1e-4), params max abs {err:.3e} (tol 1e-4)")
        if not (lrel <= 1e-4 and err <= 1e-4):
            raise AssertionError(f"small-input run of {arch.name} on the card "
                                 "disagrees with the CPU run")
    sim = sim_arch(d_model=64, n_layers=2, n_heads=4, d_ff=128)
    small_falcon = archs.reduced(archs.get("falcon-mamba-7b"))
    for method, kw, arch in ([(m, k, sim) for m, k in BASELINE_ARMS]
                             + [("dsgd", {}, small_falcon)]):
        small = dict(method=method, arch=arch, n_clients=4, topology="ring",
                     steps=SMALL_STEPS, batch_size=2, local_iters=1, **kw)
        on_card = run(DTrainConfig(device="cuda", **small))
        on_cpu = run(DTrainConfig(device="cpu", **small))
        err = max(float((on_card.extra["final_stacked"][p].cpu() - t).abs()
                        .max())
                  for p, t in on_cpu.extra["final_stacked"].items())
        lrel = max(abs(a - b) / abs(b) for a, b in zip(on_card.loss_curve,
                                                       on_cpu.loss_curve))
        log(f"[8] small input {method} {kw or ''} on {arch.name}, 4 clients, "
            f"ring, card vs CPU: ledger {on_card.total_bytes} / "
            f"{on_cpu.total_bytes} B, loss rel {lrel:.3e} (tol 1e-4), params "
            f"max abs {err:.3e} (tol 1e-4)")
        if not (lrel <= 1e-4 and err <= 1e-4
                and on_card.total_bytes == on_cpu.total_bytes):
            raise AssertionError(f"small-input {method} run on the card "
                                 "disagrees with the CPU run")

    phase_small_frontend()
    clock("8")

    # 9. every §4.2 baseline at OPT-125M's full width, 16 clients: the
    # kernels at the shapes these paths give them, then the runs
    log(f"[9] kernels vs plain versions at the baselines' shapes: OPT-125M "
        f"expanded to {BASELINE_CLIENTS} clients, updates of one model "
        f"({card})")
    entries["baselines"] = phase_kernels_baselines(opt, BASELINE_CLIENTS,
                                                   B * T)
    for e in entries["baselines"].values():
        log(f"[9] baselines {e.line()}")
    torch.cuda.empty_cache()
    launches["baselines"], details["baselines"] = phase_baselines(opt, B, card)
    launches["mamba_fo"], details["mamba_fo"] = phase_mamba_fo(falcon, B,
                                                                card)

    clock("9")

    # 10. the paper's setting under churn; 11. bitwise resume
    launches["churn"], details["churn"] = phase_churn(opt, B, card)
    clock("10")
    launches["resume"], details["resume"] = phase_resume(opt, B, card)
    clock("11")

    # 12. serving TinyLlama-1.1B whole (the serve profile runs here too),
    # in float32 and (e) in bf16
    launches["serve"], details["serve"] = phase_serve(tiny, card,
                                                      args.profile)
    launches["serve_bf16"], details["serve_bf16"] = phase_serve_bf16(tiny,
                                                                     card)

    clock("12")

    # 13. the event engine at OPT-125M's full width
    launches["async"], details["async"] = phase_async(opt, B, card)
    clock("13")

    # 14. Gemma 3 1B whole; 15. the Qwen2-72B cut
    for key, (ln, dt) in phase_gemma(gemma, card).items():
        launches[key], details[key] = ln, dt
    clock("14")
    launches["qwen2"], details["qwen2"] = phase_qwen2(qwen2, card)
    clock("15")

    # 16. the DeepSeek-V2 cut: MLA in training and serving
    launches["deepseek"], details["deepseek"] = phase_deepseek(deepseek, card)
    clock("16")

    # 17. the Jamba cut trained and served; Falcon Mamba 7B served whole
    for key, (ln, dt) in phase_jamba(jamba, falcon_whole, card).items():
        launches[key], details[key] = ln, dt
    clock("17")

    # 18. the frontend archs: MusicGen-medium whole through run and the
    # train CLI, the InternVL2-26B cut through the pod steps, both served
    # with their embeddings
    for key, (ln, dt) in phase_frontend(musicgen, internvl, card).items():
        launches[key], details[key] = ln, dt
    clock("18")

    # 19. the pod runtime in bf16: InternVL2-26B whole, buffer mode against
    # fold mode, the Jamba cut
    details["bf16_internvl"] = bf16_internvl(internvl_whole, card)
    launches["bf16_internvl"] = details["bf16_internvl"]["launches"]
    buf_launches, details["buffer_vs_fold"] = buffer_vs_fold(qwen, card)
    launches.update({"buffer_vs_fold_" + k: ln
                     for k, ln in buf_launches.items()})
    launches["bf16_jamba"], details["bf16_jamba"] = bf16_jamba(jamba, card)
    clock("19")

    # 20. the JAX package's last modules: MeZO's dense replay against
    # SubCGE (Fig. 5 / Table 4) at OPT-125M's full width, and the per-client
    # reference path on Qwen1.5-0.5B whole beside the batched one
    details["fig5"] = phase_fig5(opt, card)
    launches["per_client"], details["per_client"] = phase_per_client(qwen,
                                                                     card)
    clock("20")

    if args.profile:
        for key, arch, clients, topology in (
                ("qwen", qwen, C, "ring"), ("kimi", kimi, C, "ring"),
                ("falcon", falcon, C, "ring"),
                ("opt", opt, PAPER_CLIENTS, PAPER_TOPOLOGY),
                ("gemma", gemma, C, "ring"),
                ("deepseek", deepseek, DEEPSEEK_CLIENTS, "ring"),
                ("jamba", jamba, JAMBA_CLIENTS, "ring")):
            details[key]["profile"] = phase_profile(arch, clients, B, "cuda",
                                                    topology=topology)
            torch.cuda.empty_cache()
            log(f"[p] one steady {arch.name} step ({card}): "
                f"{details[key]['profile']}")
        for method, kw in BASELINE_ARMS:
            arm = method + "".join(f"-{k}{v}" for k, v in kw.items())
            prof = phase_profile(opt, BASELINE_CLIENTS, B, "cuda",
                                 method=method, local_iters=1, **kw)
            details["baselines"][arm]["profile"] = prof
            torch.cuda.empty_cache()
            log(f"[p] one steady {arm} step, {opt.name} x {BASELINE_CLIENTS} "
                f"clients ({card}): {prof}")
        for method, clients in FO_MAMBA_ARMS:
            prof = phase_profile(falcon, clients, B, "cuda", method=method,
                                 local_iters=1)
            details["mamba_fo"][method]["profile"] = prof
            torch.cuda.empty_cache()
            log(f"[p] one steady {method} step through Mamba, {falcon.name} "
                f"x {clients} clients ({card}): {prof}")
        # the churn cell's rejoin step (t = 4: the catch-up replay)
        prof = phase_profile(opt, PAPER_CLIENTS, B, "cuda", steps=5,
                             topology=PAPER_TOPOLOGY, subcge_tau=CHURN_TAU,
                             churn=churn_schedule())
        details["churn"]["profile"] = prof
        torch.cuda.empty_cache()
        log(f"[p] the rejoin step under churn, {opt.name} x {PAPER_CLIENTS} "
            f"clients ({card}): {prof}")

    # 21. report: each kernel over the paths that run it
    report = {"kernels": [
        record(n, [e[n] for e in entries.values() if n in e],
               sum(ln.get(n, 0) for ln in launches.values()))
        for n in SOURCES]}
    if args.out:
        for key, es in entries.items():
            details.setdefault(key, {})["kernels"] = {
                n: e.summary() for n, e in es.items()}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {**report, "card": card, "ptxas": ptxas, "phase_s": phase_s,
             **details}, indent=1))
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
