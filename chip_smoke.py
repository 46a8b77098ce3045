#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Phases 1-12 and seven steps between them (2b, 2c, 3b, 4b, 8b, 9b, 9c); any failure
exits non-zero, and without CUDA the script exits non-zero before doing
anything:

1. build: nvcc builds every kernel under src/repro_torch/kernels/csrc/ for
   sm_90a (one nvcc per source, started together);
2. kernels: each kernel's wrapper runs on the card at the main path's shapes
   and is held against its plain PyTorch version on the same inputs with
   exact integer equality, timed with CUDA events (mod_lift also beside
   the one torch.remainder call that computes it) and set beside its bound:
   the largest of its bytes over 3.35 TB/s and its integer multiplies and
   ALU instructions, each over SMs x 64 lanes x the card's maximum SM
   clock.  The flat NTTs are also held exact at keygen's [L, N] and at
   N = 256, 1024 and 16384.  A small round on the card is held bit for
   bit against the same draws on the CPU: keygen,
   public-key and seeded encrypt, `a` expansion for both derive ids,
   weighted_sum, rescale, decrypt, a StreamIngest of two small packed
   blobs, and a transcipher provision, mask and ingest.  The 4-step NTT
   kernels run at every split the tuner sweeps (3 at N=8192), each exact
   against the flat kernel's output and the plain 4-step version and
   timed (the default split's and the best split's times beside the
   bound), and exact at keygen's [L, N] and at every split of N = 256,
   1024 and 16384;
2b. tuner sweep: kernels/tune.py's sweep_op for ntt_fwd and ntt_inv at
   every (N, L, B) the in-memory round dispatches its NTTs at; the cache is
   saved to a temporary file, cleared, reloaded and cleared again, so
   phases 3-6 run with an empty cache (the flat NTT kernels);
2c. mask kernels: the selection mask's split and merge (kernels/mask.py)
   at the benchmark's update sizes, hubert-xlarge's 945,808,640 and
   mamba2-370m's 368,252,416 parameters, under a random mask of
   P_RATIO: the layout's build timed, the split held bit for bit against
   its plain version (boolean indexing), the merge against the vector and
   the plain merge, from enc contiguous and as the real part of a
   complex64 tensor (the decode's output, read at stride 2), with one
   split and two merge launches a size; both kernels and their plain
   versions timed beside the bound of their bytes;
3. in-memory round: the paper's Algorithm 1 round at full width --
   make_context() (N=8192, L=2, delta=2^26), keygen, three clients'
   Qwen1.5-0.5B-sized updates (463,987,712 float32 parameters, top 10%
   encrypted in 11,328 ciphertexts each) through client_protect,
   server_aggregate and client_recover_params;
3b. 4-step round: phase 3 again with a tuning cache that puts the sweep's
   best 4-step configuration at each of those NTT shapes, so every NTT of
   the round runs the ntt4 kernels; keys, ciphertexts, the aggregate and
   the recovered parameters must equal phase 3's bit for bit;
4. wire round: the same clients, keys and mask over the wire (the
   quickstart's step 5) -- client_protect_seeded, seed_compress and
   pack_update_frames with an f16 plain segment, a BandwidthLedger of every
   blob, StreamIngest.ingest of each blob and finalize, a serialize_update
   downlink, and client_recover_params from the parsed downlink;
4b. checkpoint step, outside phase 4's counted run: the serve crash/resume
   case at full width -- a fresh StreamIngest takes phase 4's blobs 0 and 1,
   a CheckpointManager (keep=1) saves its export_state after each (only
   step 2 may remain), a second fresh StreamIngest restores step 2 and
   ingests blob 2, and its finalize must equal phase 4's aggregate bit for
   bit; each ingest's registry series must equal its properties, and
   wire_bytes_total phase 4's BandwidthLedger;
5. transcipher round: the same clients, keys and mask through the thin-
   client uplink (DESIGN.md §15) -- transcipher.provision per client
   (DERIVE_CTR, a_seed 200+i), client_protect_transcipher (mask_values) and
   pack_masked_update_frames with an f16 plain segment, one StreamIngest
   with the server materials, finalize and client_recover_params.  Then,
   outside the counted run: the aggregate must equal, bit for bit, the
   weighted_sum of seeded encryptions of the same coefficients with the
   same gaussian draws and a_seeds, and every escrow frame must decrypt to
   its client's keystream seed;
6. sharded round: the sharded HE engine (DESIGN.md §8) on a (data 2,
   model 2) mesh of four slots, the visible cards round-robin (one card
   four times on a one-card machine) -- ShardedHe.keygen, server_aggregate
   (sharded=) of phase 3's updates, a weighted_accum fold of them from a
   broadcast zero accumulator, launch.fl_step's limb-sharded step,
   client_protect_seeded (sharded=) of one client, StreamIngest (sharded=)
   of phase 4's three blobs with finalize, and client_recover_params
   (sharded=).  Every result must equal its single-device counterpart bit
   for bit (the plaintext step within float32 rounding), every block must
   lie on its slot's device, and the engine must gather exactly twice
   (decrypt and the ingest's hand-off);
7. threshold round (paper Appendix B), with obs enabled and traced to a
   file: ThresholdKeyAuthority(3) on make_context(), phase 3's clients
   through client_protect under the joint pk, server_aggregate, each
   party's partial_decrypt, combine_partials, decode, merge_by_mask and
   unflatten_params.  The trace must hold one he.<op> kernel span per
   counted launch and load in tools/round_report.py, and
   kernel_op_launches_total must equal the launch counts.  Then, outside
   the counted run: the combine of zero-smudge partials equals the joint
   secret's decrypt bit for bit, the smudged combine differs from it by
   exactly the smudging draws, two of three partials decrypt to garbage,
   and a Shamir 3-of-5 sharing of phase 3's sk decrypts phase 3's
   aggregate;
8. model round: the round on a real model -- build_model of Qwen1.5-0.5B
   on the card, initialised from --seed (its tree must be QWEN_LEAVES);
   three clients of synthetic non-IID streams (make_client_streams, B = 2,
   S = 256), each with a two-probe sensitivity_jvp map of the global model
   on one batch (the FL client's soft-label loss) and two local AdamW
   steps (bf16 compute, remat); the top-10% mask of the maps' plain mean
   (the orchestrator's threshold-mode branch), keygen, client_protect of
   each local model, server_aggregate and client_recover_params.  The mean
   loss over the clients' training batches must fall; a fresh batch's
   loss is printed.  Then one local step again under torch.profiler;
8b. model checks outside the counted run: a full-width
   granite-moe-3b-a800m loss and gradient at B = 1, S = 512 (loss in
   (0, 3 ln V), finite gradients, the dropped token-expert share by layer
   from obs), and a Qwen1.5-0.5B prefill of 128 tokens plus 4 decode_steps
   against a prefill of all 132, in float32, within DECODE_MAX_ERR;
9. the FL loop at full width, through its entry point: FLTask.run() of
   Qwen1.5-0.5B (built on the card from --seed) with phase 8's three
   FLClients and streams (two local AdamW steps of B = 2 x S = 256, a
   two-probe sensitivity map), AggregatorConfig(top_p, 0.1) and
   FLRunConfig(FL_ROUNDS = 2 rounds over the wire: seeded ciphertexts, an
   f16 plain segment; a checkpoint every round) on make_context().  Stage
   1 is the key authority's keygen; stage 2 the clients' maps, HE-folded by
   agree_sensitivity in blocks of SENSITIVITY_BLOCK_ROWS ciphertexts (10
   blocks of 113,279 rows a client), and the top-10% mask; stage 3 the
   rounds.  The script wraps (never edits) the clients' local_train to
   capture the plaintext FedAvg, and the stages to count and profile
   them.  Held: each round's recovered model within 1e-2 of the FedAvg of
   its local models; the decrypted global map within 1e-2 of the maps'
   plaintext mean and a mask of round(0.1 x 463,987,712) = 46,398,771
   entries; RoundLog's bytes measured and equal to 3 x the frame layout's
   uplink and downlink blobs; every stage's and round's launch counts;
   and a fresh FLTask on the same checkpoints resumes at round 2, runs no
   round and holds round 1's global model bit for bit.  Printed: each
   stage's and round's host clock, device busy share and peak memory,
   RoundLog's loss and bytes, and the HE mask's overlap with the plaintext
   mean's mask;
9b. the ssm family through the FL loop: mamba2-370m at full width and
   depth (368,252,416 parameters, bf16 compute, remat), one in-memory
   FLTask round of three clients, two local AdamW steps of B = 2 x S = 512
   (two SSD chunks of 256: the inter-chunk recurrence), the HE mask and
   top-10% (8,991 ciphertexts a client): FedAvg error under 1e-2 and the
   launch counts held, step times and tokens/s printed; then mamba2-370m's
   decode against its prefill (128 + 4 tokens, float32) within
   DECODE_MAX_ERR;
9c. the hybrid family at full width: zamba2-7b (6,674,390,608 parameters,
   float32 master weights, bf16 compute, remat), one loss and gradient at
   B = 1, S = 512 (loss in (0, 3 ln 32000), every gradient finite, the
   peak printed), then a prefill of 128 tokens and 4 decode_steps against
   a prefill of all 132 on the same weights in float32, within
   DECODE_MAX_ERR.  No AdamW step at this width: its two float32 moments
   would add 53 GB to the 53 GB of weights and gradients;
10. the aggregation service (DESIGN.md §14) at full width, on phase 4's
   three blobs (kept on the host since phase 4) and make_context():
   (a) in memory, on the service's worker thread (start/stop): open_round,
   the three blobs and a fourth -- blob 0 re-labelled cid 3 by
   sim.rewrite_begin with one CT_CHUNK dropped by faults.corrupt_blob --
   which passes the door and fails at fold time; seal, and the round must
   end DONE with one fold reject and one refold, its aggregate (residues,
   plain sum, scale) equal to phase 4's bit for bit;
   (b) with a checkpoint directory (a temporary one, removed at the end)
   and fold_batch 2, a FaultInjector crash at after_fold_step: the worker
   folds blobs 0 and 1, checkpoints and crashes; AggregationService.resume
   rebuilds the service from that checkpoint and the spooled blobs and
   finishes the round, equal to phase 4's aggregate bit for bit, with the
   replayed BandwidthLedger equal to phase 4's uplink bytes.  Each of the
   three runs is counted (SERVE_LAUNCHES) and profiled; the resume is
   timed, and each checkpoint save by its serve.checkpoint span.  A worker
   error is re-raised after stop();
11. the training driver at full width: launch.train.main of Qwen1.5-0.5B
   (--no-smoke, B = 2, S = 256, TRAIN_STEPS steps, a checkpoint every
   TRAIN_CKPT_EVERY) on the card; its checkpoints are copied without the
   last step and the same command resumes from the copy ("resumed from
   step 2", steps 3-5).  The restored {"p", "o"} must equal the saved
   bytes, and the resumed losses and final {"p", "o"} the uninterrupted
   run's, bit for bit.  Each step's time and tokens/s, each save's and the
   restore's time (the driver's train.* spans) and the peak are printed;
12. the multi-card remainder on the one card: (a) make_production_mesh()
   raises RuntimeError with its counts (256 ranks needed, 0 and then 1
   present; 512 for the two-pod mesh); (b) a one-rank NCCL group and a
   (1, 1) ("data", "model") make_model_mesh on the card: full-width
   Qwen1.5-0.5B (fresh seeded weights, B = 2 x S = 256 batches) through
   launch.steps.jit_train_step for PLACED_STEPS steps, jit_prefill_step
   and jit_decode_step (every op a DTensor op), each held bit for bit
   against make_train_step / make_prefill_step / make_decode_step run
   unplaced on the same inputs (loss, metrics, every parameter and both
   moments; logits and every cache buffer); step times, peak memory and
   the replicate-before sites are printed and the group destroyed; (c) in
   a subprocess, `python -m repro_torch.launch.dryrun` for Qwen1.5-0.5B
   train_4k on both production meshes (fake ranks, meta tensors) and
   --he-agg on the single pod; each artifact's per-rank parameter and
   optimiser bytes must equal the spec arithmetic, and its memory and
   collective lines are printed.  No HE kernel runs in this phase: its
   launch counts must be 0.

Phases 3, 3b, 4, 5, 6, 7 and 8, each stage and round of phase 9, step
9b and the three runs of phase 10 run with the launch counters set to 0
just before and read just after; 3-7, phase 9's stages and rounds and
phase 10's runs under torch.profiler (device busy share, time by kernel),
phase 8 and step 9b without it (their step times are the card's); phases
3-6, 8, 9 and 10(a) with obs disabled, 10(b) and 11 with obs on in
memory (its spans time the saves and steps; its kernel hooks synchronize
each kernel op).
Each must recover the plaintext FedAvg within 1e-2 (the quickstart's
bound; phase 7 within THRESHOLD_MAX_ERR) with exactly its expected launch
counts of every kernel its expectation names (the HE kernels everywhere,
the mask's split and merge where EXPECTED_LAUNCHES names them; all counts
are printed); the wire round must also
fold with one accumulate launch per client and hold at most one update's
11,328 rows, with blob sizes equal to the frame layout's; so must the
transcipher round.

The last lines are the threshold round's, the model round's, the FL
loop's, steps 9b/9c's, the service's, the training driver's and the placed
steps' summaries, the card's name and power limit
(nvidia-smi), one JSON line with every kernel's numbers, and the JSON
result line.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs, interop, models, obs, serve  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import (  # noqa: E402
    packing, secure_agg, selection, sensitivity)
from repro_torch.core.ckks import (  # noqa: E402
    cipher, encoding, params, sharded, threshold, transcipher)
from repro_torch.core.secure_agg import (  # noqa: E402
    AggregatorConfig, ProtectedUpdate, SelectiveHEAggregator)
from repro_torch.kernels import (  # noqa: E402
    build, he_agg, lift, mask, ntt, ops, pointwise, ref, tune)
from repro_torch.fl import (  # noqa: E402
    ClientConfig, FLClient, FLRunConfig, FLTask, ThresholdKeyAuthority)
from repro_torch.launch import fl_step, mesh as he_mesh  # noqa: E402
from repro_torch.launch import steps as model_steps  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.serve import faults as serve_faults  # noqa: E402
from repro_torch.serve import sim as serve_sim  # noqa: E402
from repro_torch.wire import budget, compress, format as wf  # noqa: E402
from repro_torch.wire import stream  # noqa: E402
from repro_torch.data import make_client_streams  # noqa: E402
from repro_torch.models import sharding, transformer  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, adamw_init, adamw_update)

# Qwen1.5-0.5B (src/repro/configs/qwen1_5_0_5b.py: 24 layers, d_model 1024,
# d_ff 2816, vocab 151936, QKV bias, tied embeddings): the 14 parameter
# leaves of the JAX package's transformer.init_abstract, 463,987,712 values.
D, F, NL, V = 1024, 2816, 24, 151936
QWEN_LEAVES = {
    "embed": (V, D),
    "layers": {
        "bk": (NL, D), "bq": (NL, D), "bv": (NL, D),
        "ln1": (NL, D), "ln2": (NL, D),
        "w_down": (NL, F, D), "w_gate": (NL, D, F), "w_up": (NL, D, F),
        "wk": (NL, D, D), "wo": (NL, D, D), "wq": (NL, D, D),
        "wv": (NL, D, D),
    },
    "ln_f": (D,),
}
N_PARAMS = 463_987_712
N_CLIENTS = 3
P_RATIO = 0.1
# launches per path: the in-memory round runs keygen (2 ntt_fwd), three
# public-key encrypts (4 ntt_fwd, 2 mul_add each), weighted_sum and decrypt
# (mul_add, ntt_inv); the wire round reuses the keys, runs three seeded
# encrypts (2 ntt_fwd, 1 mul_add each), one accumulate launch per ingested
# blob, and decrypt; the transcipher round runs three provisions (D: one
# mod_lift, ntt_fwd and mul_add; the escrow encrypt: 2 ntt_fwd, 1 mul_add),
# no kernel on the clients, one mod_lift, ntt_fwd and accumulate launch per
# ingested blob, and decrypt; the sharded round launches once per block of
# its four: keygen (2 ntt_fwd), server_aggregate and the fl_step step (one
# weighted_sum each), the three-client fold (3 weighted_accum), one seeded
# encrypt (2 ntt_fwd, 1 mul_add), one accumulate per ingested blob, and
# decrypt (mul_add, ntt_inv); the threshold round runs three parties' keygen
# (2 ntt_fwd each: the share and the noise), three public-key encrypts (4
# ntt_fwd, 2 mul_add each), weighted_sum, three partial decryptions (the
# smudging noise's ntt_fwd and one mul_add each) and the combine (ntt_inv).
# With an empty tuning cache no path launches the 4-step kernels; the
# 4-step round is the in-memory round with every NTT resolved to them.
# The mask kernels: one split a client's protect, one merge the recover,
# in the rounds whose expectation names them.
MASK_ROUND = {"mask_split": N_CLIENTS, "mask_merge": 1}
EXPECTED_LAUNCHES = {
    "in_memory": {"ntt_fwd": 14, "ntt_inv": 1, "ntt4_fwd": 0, "ntt4_inv": 0,
                  "mul_add": 7, "weighted_sum": 1, "weighted_accum": 0,
                  "weighted_accum_chunks": 0, "mod_lift": 0,
                  **MASK_ROUND},
    "ntt4_round": {"ntt_fwd": 0, "ntt_inv": 0, "ntt4_fwd": 14, "ntt4_inv": 1,
                   "mul_add": 7, "weighted_sum": 1, "weighted_accum": 0,
                   "weighted_accum_chunks": 0, "mod_lift": 0,
                   **MASK_ROUND},
    "wire": {"ntt_fwd": 6, "ntt_inv": 1, "ntt4_fwd": 0, "ntt4_inv": 0,
             "mul_add": 4, "weighted_sum": 0, "weighted_accum": 0,
             "weighted_accum_chunks": 3, "mod_lift": 0, **MASK_ROUND},
    "transcipher": {"ntt_fwd": 12, "ntt_inv": 1, "ntt4_fwd": 0,
                    "ntt4_inv": 0, "mul_add": 7, "weighted_sum": 0,
                    "weighted_accum": 0, "weighted_accum_chunks": 3,
                    "mod_lift": 6, **MASK_ROUND},
    "sharded": {"ntt_fwd": 16, "ntt_inv": 4, "ntt4_fwd": 0, "ntt4_inv": 0,
                "mul_add": 8, "weighted_sum": 8, "weighted_accum": 12,
                "weighted_accum_chunks": 12, "mod_lift": 0},
    "threshold": {"ntt_fwd": 21, "ntt_inv": 1, "ntt4_fwd": 0, "ntt4_inv": 0,
                  "mul_add": 9, "weighted_sum": 1, "weighted_accum": 0,
                  "weighted_accum_chunks": 0, "mod_lift": 0},
    # the model round's HE part is the in-memory round's: keygen, three
    # public-key encrypts, weighted_sum, decrypt; local training and the
    # sensitivity maps launch no HE kernel
    "model_round": {"ntt_fwd": 14, "ntt_inv": 1, "ntt4_fwd": 0,
                    "ntt4_inv": 0, "mul_add": 7, "weighted_sum": 1,
                    "weighted_accum": 0, "weighted_accum_chunks": 0,
                    "mod_lift": 0, **MASK_ROUND},
}
# the NTT dispatches of the in-memory round, (op, B) at N=8192, L=2, read
# off core/ckks/cipher.py: keygen's s and e are [L, N] (B = 1), each
# encrypt's m, u, e0, e1 and the decrypt's phase are [11328, L, N]
ROUND_NTT_SHAPES = (("ntt_fwd", 1), ("ntt_fwd", "rows"), ("ntt_inv", "rows"))
N_NTT4_CONFIGS = 3     # the tuner's splits at N=8192; radix and block_b
                       # change no launch of the register-pass kernel
MESH_SLOTS = 4         # the sharded round's mesh: data 2 x model 2 at L = 2
EXPECTED_GATHERS = 2   # decrypt's gather of limb shards, finalize's hand-off
MAX_ERR = 1e-2
PLAIN_CODEC = "f16"
A_SEED0 = 100          # client i seeds its public `a` with A_SEED0 + i
TC_A_SEED0 = 200       # ... and with TC_A_SEED0 + i in the transcipher round
# Phase 7 (Appendix B).  Each of the N_PARTIES partial decryptions adds a
# rounded gaussian of sigma_s = 2**12 (threshold.DEFAULT_SMUDGE_SIGMA) to
# every coefficient, so the combine carries coefficient noise of std
# sigma_s * sqrt(N_PARTIES) = 7,094.  A slot is the real part of an N-point
# evaluation of the coefficients over the scale: std sigma_s *
# sqrt(N_PARTIES) * sqrt(N / 2) / scale, 6.8e-3 at a fresh ciphertext's
# scale delta = 2**26 and 1.0e-10 at the FedAvg aggregate's delta**2.  The
# bound takes the fresh scale, the most the smudging can add at any scale
# >= delta: over the round's 46.4 M encrypted values the largest such error
# is about 5.9 std = 0.040, and THRESHOLD_STDS = 15 std = 0.10 leaves room
# for the joint key's encryption noise (sqrt(N_PARTIES) times the
# single-key round's, which stays under 1e-2).  A missing party leaves
# c1 (*) s_i in the phase: garbage, above MISSING_PARTY_MIN_ERR.
N_PARTIES = 3
THRESHOLD_STDS = 15
MISSING_PARTY_MIN_ERR = 1.0
SHAMIR_N, SHAMIR_T, SHAMIR_ACTIVE = 5, 3, (0, 2, 4)
# Phase 8: Qwen1.5-0.5B, three clients of synthetic non-IID streams
# (Dirichlet alpha 0.5 over the vocab), B = 2 x S = 256 a batch, two local
# AdamW steps at FLClient's lr 1e-3 and no weight decay, and a two-probe
# sensitivity map each.  Step 8b: granite-moe-3b-a800m at B = 1, S = 512,
# and decode against prefill in float32.  The decode bound: prefill and
# decode sum the same float32 products in other orders, which moves a
# logit by about 1e-6 of the residual stream's scale per layer; 1e-3 is
# far above that and far below the logits' spread (std ~0.6 at init).
MODEL_ARCH = "qwen1.5-0.5b"
MODEL_SEQ, MODEL_BATCH = 256, 2
LOCAL_STEPS, LOCAL_LR = 2, 1e-3
SENS_PROBES = 2
DIRICHLET_ALPHA = 0.5
MOE_ARCH, MOE_SEQ = "granite-moe-3b-a800m", 512
DECODE_PREFIX, DECODE_STEPS = 128, 4
DECODE_MAX_ERR = 1e-3
# Phase 9: FLTask.run() of Qwen1.5-0.5B with phase 8's clients and streams,
# the HE mask (stage 2) and FL_ROUNDS wire rounds, checkpointed every
# round.  Step 9b: one in-memory round of mamba2-370m at B = 2 x S =
# SSM_SEQ (two SSD chunks of 256).  Step 9c: zamba2-7b's loss and gradient
# at B = 1, S = HYBRID_SEQ.
FL_ROUNDS = 2
SSM_ARCH, SSM_SEQ, SSM_PARAMS = "mamba2-370m", 512, 368_252_416
HYBRID_ARCH, HYBRID_SEQ, HYBRID_PARAMS = "zamba2-7b", 512, 6_674_390_608

# Phase 2c: the benchmark's update sizes (chipbench/configs), the sims'
# top-p mask replaced by a random one of the same share.
MASK_SIZES = (("hubert-xlarge", 945_808_640), ("mamba2-370m", 368_252_416))
MASK_SOURCE = "src/repro_torch/kernels/csrc/mask.cu"

# Published H100 SXM peak (NVIDIA data sheet): HBM3 3.35 TB/s.  Integer
# work is counted per pipe, each pipe at 64 lanes an SM (Hopper white
# paper) times the SM count and the card's maximum SM clock, both read off
# the card: the multiply pipe (32-bit multiplies and multiply-adds) and the
# ALU pipe (adds, compares, selects, min/max).  Per operation, the least
# instructions Hopper needs, as (multiplies, ALU): a 64-bit REDC's three
# multiplies, and for a modular add, subtract or final reduction its add
# plus one VIADDMNMX, which adds and takes the unsigned min in one
# instruction (the SASS of csrc/ntt.cu: tools/ptxas_report.py --sass).
PEAK_BYTES_PER_S = 3.35e12
INT_LANES_PER_SM = 64
MONT = (3, 1)        # a*b, lo(t)*(-q^-1), m*q; r = min(r, r - q)
MOD_ADD = (0, 2)     # s = a + b; min(s, s - q)
MOD_SUB = (0, 2)     # d = a - b; min(d, d + q)
BUTTERFLY = (3, 5)   # one of each
# mod_lift's `%` by a per-limb q (lift.cu): the reciprocal of q once per
# limb and four words, then per word at least a high multiply, a
# multiply-subtract and one correction (a fused add-min)
REMAINDER = (2, 1)

KERNELS = {
    # name: (CUDA source, the TPU kernel it replaces)
    "ntt_fwd": ("src/repro_torch/kernels/csrc/ntt.cu",
                "src/repro/kernels/ntt.py:46"),
    "ntt_inv": ("src/repro_torch/kernels/csrc/ntt.cu",
                "src/repro/kernels/ntt.py:66"),
    "ntt4_fwd": ("src/repro_torch/kernels/csrc/ntt4.cu",
                 "src/repro/kernels/ntt.py:213"),
    "ntt4_inv": ("src/repro_torch/kernels/csrc/ntt4.cu",
                 "src/repro/kernels/ntt.py:228"),
    "mul_add": ("src/repro_torch/kernels/csrc/pointwise.cu",
                "src/repro/kernels/pointwise.py:26"),
    "weighted_sum": ("src/repro_torch/kernels/csrc/he_agg.cu",
                     "src/repro/kernels/he_agg.py:32"),
    "weighted_accum": ("src/repro_torch/kernels/csrc/he_agg.cu",
                       "src/repro/kernels/he_agg.py:103"),
    "weighted_accum_chunks": ("src/repro_torch/kernels/csrc/he_agg.cu",
                              "src/repro/kernels/he_agg.py:162"),
    "mod_lift": ("src/repro_torch/kernels/csrc/lift.cu",
                 "src/repro/kernels/lift.py:27"),
}


def log(msg):
    print(msg, flush=True)


def leaves(tree, out=None):
    """Leaves of a nested dict in sorted-key order."""
    out = [] if out is None else out
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            leaves(tree[k], out)
        else:
            out.append(tree[k])
    return out


def map_tree(fn, tree):
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def n_ciphertexts(slots):
    n_enc = int(round(N_PARAMS * P_RATIO))
    return -(-n_enc // slots)


def time_ms(fn, reps):
    """Mean device time of fn() over reps launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_int_rate():
    """(SM count, max SM clock in MHz, integer ops/s of one pipe) of card 0:
    the pipe's 64 lanes an SM at the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    return sms, mhz, sms * INT_LANES_PER_SM * mhz * 1e6


def int_ops(*terms):
    """(multiplies, ALU instructions) of `count` operations of each kind,
    for terms (count, (multiplies, ALU)) of one kernel call."""
    return (sum(c * op[0] for c, op in terms),
            sum(c * op[1] for c, op in terms))


def bound(nbytes, ops, int_rate):
    """(ms, "bytes" or "operations", the pipe that sets it): the largest of
    the bytes over the memory rate and each integer pipe's count over its
    rate."""
    muls, alu = ops
    t = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
         "multiply": muls / int_rate * 1e3, "alu": alu / int_rate * 1e3}
    pipe = max(t, key=t.get)
    return t[pipe], "bytes" if pipe == "bytes" else "operations", pipe


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def check_kernels(ctx, gen, n_rows, int_rate):
    """Returns {name: row of the kernels JSON line} (launches filled later);
    int_rate: one integer pipe's ops/s (card_int_rate)."""
    dev = ctx.device
    t = ctx.device_tables
    l, n = ctx.n_limbs, ctx.n_poly
    log_n = n.bit_length() - 1
    n1, n2 = params.ntt4_split(n)

    def uniform(shape):
        return cipher.sample_uniform(gen, shape, ctx)

    x = uniform((n_rows, n))                                    # [B, L, N]
    z = uniform((n_rows, n))
    y = uniform((1, n))                                         # pk, bcast
    cts = torch.stack([uniform((n_rows, 2, n)).movedim(-2, -3).contiguous()
                       for _ in range(N_CLIENTS)])              # [C,B,L,2,N]
    w = torch.from_numpy(encoding.encode_weights_mont(
        [1.0 / N_CLIENTS] * N_CLIENTS, ctx).view(np.int32).copy()).to(dev)
    # the flush: one update's rows against a running accumulator, each row
    # weighted as if from a different client
    acc = uniform((n_rows, 2, n)).movedim(-2, -3).contiguous()  # [K,L,2,N]
    w_rows = torch.from_numpy(encoding.encode_weights_mont(
        [0.2, 0.3, 0.5], ctx).view(np.int32).copy()).to(dev)[
            torch.arange(n_rows, device=dev) % N_CLIENTS].contiguous()
    # the sharded fold: one client into a running accumulator, one weight
    w_one = w[0].contiguous()
    # the transcipher's masked words span the whole u32 range: random
    # int32 bits with the edges 0, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1
    words = torch.randint(-2 ** 31, 2 ** 31, (n_rows, n), generator=gen,
                          device=dev, dtype=torch.int32)
    words.view(-1)[:5] = torch.tensor([0, 2 ** 31 - 1, -2 ** 31, -2, -1],
                                      dtype=torch.int32, device=dev)
    words64 = words.to(torch.int64) & 0xFFFFFFFF    # widened beforehand
    q64 = t.qs.to(torch.int64)[:, None]
    elems = x.numel()
    butterflies = (n // 2) * log_n * (elems // n)
    per_client = cts[0].numel()
    # name: (kernel, plain version, shape, bytes, (multiplies, ALU),
    # library call)
    cases = {
        "ntt_fwd": (
            lambda: ntt.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs),
            lambda: ref.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs),
            x.shape, 4 * (2 * elems + l * n + 2 * l),
            int_ops((butterflies, BUTTERFLY))),
        "ntt_inv": (
            lambda: ntt.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts,
                                      t.qs, t.qinv_negs),
            lambda: ref.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts,
                                      t.qs, t.qinv_negs),
            x.shape, 4 * (2 * elems + l * n + 3 * l),
            int_ops((butterflies, BUTTERFLY), (elems, MONT))),
        # both 4-step kernels at the default split (64 x 128 at N=8192;
        # check_ntt4_configs times every split).  Bytes: x and out once
        # each, the psi1, psi2 and corr tables once; operations: the flat
        # NTT's butterflies plus the twist's product an element (and the
        # inverse's N^{-1} scale)
        "ntt4_fwd": (
            lambda: ntt.ntt4_fwd_fused(x, t.ntt4_psi1_mont, t.ntt4_psi2_mont,
                                       t.ntt4_corr_mont, t.qs, t.qinv_negs),
            lambda: ref.ntt4_fwd_fused(x, t.ntt4_psi1_mont, t.ntt4_psi2_mont,
                                       t.ntt4_corr_mont, t.qs, t.qinv_negs),
            x.shape, 4 * (2 * elems + l * (n1 + n2 + n) + 2 * l),
            int_ops((butterflies, BUTTERFLY), (elems, MONT))),
        "ntt4_inv": (
            lambda: ntt.ntt4_inv_fused(
                x, t.ntt4_psi1_inv_mont, t.ntt4_psi2_inv_mont,
                t.ntt4_corr_inv_mont, t.n_inv_monts, t.qs, t.qinv_negs),
            lambda: ref.ntt4_inv_fused(
                x, t.ntt4_psi1_inv_mont, t.ntt4_psi2_inv_mont,
                t.ntt4_corr_inv_mont, t.n_inv_monts, t.qs, t.qinv_negs),
            x.shape, 4 * (2 * elems + l * (n1 + n2 + n) + 3 * l),
            int_ops((butterflies, BUTTERFLY), (2 * elems, MONT))),
        "mul_add": (
            lambda: pointwise.mul_add_fused(x, y, z, t.qs, t.qinv_negs),
            lambda: ref.mul_add_fused(x, y, z, t.qs, t.qinv_negs),
            x.shape, 4 * (3 * elems + l * n + 2 * l),
            int_ops((elems, MONT), (elems, MOD_ADD))),
        "weighted_sum": (
            lambda: he_agg.he_weighted_sum_fused(cts, w, t.qs, t.qinv_negs,
                                                 limb_axis=-3),
            lambda: ref.he_weighted_sum_fused(cts, w, t.qs, t.qinv_negs,
                                              limb_axis=-3),
            cts.shape,
            4 * ((N_CLIENTS + 1) * per_client + N_CLIENTS * l + 2 * l),
            int_ops((N_CLIENTS * per_client, MONT),
                    ((N_CLIENTS - 1) * per_client, MOD_ADD))),
        "weighted_accum": (
            lambda: he_agg.he_weighted_accum_fused(
                acc, cts[0], w_one, t.qs, t.qinv_negs, limb_axis=-3),
            lambda: ref.he_weighted_accum_fused(
                acc, cts[0], w_one, t.qs, t.qinv_negs, limb_axis=-3),
            acc.shape, 4 * (3 * acc.numel() + 3 * l),
            int_ops((acc.numel(), MONT), (acc.numel(), MOD_ADD))),
        "weighted_accum_chunks": (
            lambda: he_agg.he_weighted_accum_chunks_fused(
                acc, cts[0], w_rows, t.qs, t.qinv_negs, limb_axis=-3),
            lambda: ref.he_weighted_accum_chunks_fused(
                acc, cts[0], w_rows, t.qs, t.qinv_negs, limb_axis=-3),
            acc.shape, 4 * (3 * acc.numel() + w_rows.numel() + 2 * l),
            int_ops((acc.numel(), MONT), (acc.numel(), MOD_ADD))),
        # one remainder per output word
        "mod_lift": (
            lambda: lift.mod_lift_fused(words, t.qs),
            lambda: ref.mod_lift_fused(words, t.qs),
            words.shape, 4 * (words.numel() * (1 + l) + l),
            int_ops((words.numel() * l, REMAINDER)),
            lambda: torch.remainder(words64[:, None, :], q64)),
    }
    rows = {}
    for name, (kern, plain, shape, nbytes, ops, *library) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: kernel gives {got.shape} "
                                 f"{got.dtype}, plain {want.shape} "
                                 f"{want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max |diff| {err})")
        library_ms = None
        if library:
            if not torch.equal(library[0]().to(torch.int32), want):
                raise AssertionError(f"{name}: the library call differs")
            library_ms = time_ms(library[0], 10)
        del got, want
        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 2)
        bound_ms, bound_by, pipe = bound(nbytes, ops, int_rate)
        source, replaces = KERNELS[name]
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": None,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bound_pipe": pipe, "library_ms": library_ms}
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"kernel {name}: exact at {tuple(shape)}  ms={ms:.4f}  "
            f"plain_ms={plain_ms:.4f}  bound_ms={bound_ms:.4f} (set by "
            f"{pipe}: {nbytes / 1e9:.3f} GB, {ops[0] / 1e9:.3f} G "
            f"multiplies, {ops[1] / 1e9:.3f} G ALU)  library call: {lib}")
    check_accum_variants(acc, cts[0], w_one, t, int_rate)
    check_ntt_shapes(ctx, gen)
    check_ntt4_configs(ctx, x, rows)
    log("kernels: " + ", ".join(rows))
    return rows


# ---------------------------------------------------------------------------
# phase 2c: the selection mask's split and merge at the benchmark's sizes
# ---------------------------------------------------------------------------


def check_mask_kernels(seed, slots):
    """Returns ({name: row of the kernels JSON line}, the phase's launch
    counts); a row's times are at the first of MASK_SIZES, and
    row["by_size"] holds every size's."""
    dev = torch.device("cuda")
    rows, launched = {}, {"mask_split": 0, "mask_merge": 0}
    for label, p in MASK_SIZES:
        gen = torch.Generator(device=dev).manual_seed(seed)
        part = packing.make_partition(
            torch.rand(p, generator=gen, device=dev) < P_RATIO, slots)
        vec = torch.randn(p, generator=gen, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lay = part.layout(dev)
        torch.cuda.synchronize()
        layout_ms = (time.perf_counter() - t) * 1e3
        ops.reset_launch_counts()
        enc, plain = mask.mask_split(vec, part)
        want_enc, want_plain = mask.split_plain(vec, part)
        if not (torch.equal(enc, want_enc) and torch.equal(plain,
                                                           want_plain)):
            raise AssertionError(f"mask_split at {label}: kernel differs "
                                 "from its plain version")
        del want_enc, want_plain
        # the decode's output is the real part of a complex64 tensor
        real = torch.complex(enc, torch.zeros_like(enc)).real
        for what, e in (("contiguous", enc), ("stride 2", real)):
            out = mask.mask_merge(e, plain, part)
            if not (torch.equal(out, vec) and torch.equal(
                    out, mask.merge_plain(e, plain, part))):
                raise AssertionError(f"mask_merge at {label} from {what} "
                                     "enc: kernel differs")
            del out
        counts = ops.launch_counts()
        check_launches(f"mask_kernels {label}", counts,
                       {"mask_split": 1, "mask_merge": 2})
        for k in launched:
            launched[k] += counts[k]
        # bytes: the vector once, the layout once, the encrypted part (with
        # the split's pad) and the plain part once
        layout_bytes = 4 * lay.words.numel() + 8 * lay.tile_enc.numel()
        cases = {
            "mask_split": (lambda: mask.mask_split(vec, part),
                           lambda: mask.split_plain(vec, part),
                           4 * (p + part.n_enc_padded + part.n_plain)
                           + layout_bytes),
            "mask_merge": (lambda: mask.mask_merge(real, plain, part),
                           lambda: mask.merge_plain(real, plain, part),
                           4 * (p + part.n_enc + part.n_plain)
                           + layout_bytes),
        }
        for name, (kern, plain_fn, nbytes) in cases.items():
            ms = time_ms(kern, 10)
            plain_ms = time_ms(plain_fn, 2)
            bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            size = {"p": p, "n_enc": part.n_enc, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "layout_ms": layout_ms}
            row = rows.setdefault(name, {
                "name": name, "route": "cuda", "source": MASK_SOURCE,
                "replaces": None, "launches": None, "max_abs_err": 0,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "bound_pipe": "bytes",
                "library_ms": None, "by_size": {}})
            row["by_size"][label] = size
            log(f"kernel {name} at {label} (P = {p}, {part.n_enc} "
                f"encrypted): exact  ms={ms:.4f}  plain_ms={plain_ms:.4f}  "
                f"bound_ms={bound_ms:.4f} (bytes: {nbytes / 1e9:.3f} GB)  "
                f"layout build {layout_ms:.1f} ms")
        del part, lay, vec, enc, plain, real, cases
        torch.cuda.empty_cache()
    log("mask kernels: " + ", ".join(rows))
    return rows, launched


def check_ntt4_configs(ctx, x, rows):
    """Both 4-step kernels at every split the tuner sweeps at x's shape,
    each exact against the flat kernel's output and the plain 4-step
    version on x and timed with CUDA events over 10 launches; the fastest
    is added to its kernel's row as best_ms / best_config."""
    t = ctx.device_tables
    n_rows = x.shape[0]
    flat = {"ntt_fwd": ntt.ntt_fwd_fused(x, t.psi_rev_mont, t.qs,
                                         t.qinv_negs),
            "ntt_inv": ntt.ntt_inv_fused(x, t.psi_inv_rev_mont,
                                         t.n_inv_monts, t.qs, t.qinv_negs)}
    plain = {"ntt_fwd": lambda s: ref.ntt4_fwd_fused(
                 x, s.ntt4_psi1_mont, s.ntt4_psi2_mont, s.ntt4_corr_mont,
                 s.qs, s.qinv_negs),
             "ntt_inv": lambda s: ref.ntt4_inv_fused(
                 x, s.ntt4_psi1_inv_mont, s.ntt4_psi2_inv_mont,
                 s.ntt4_corr_inv_mont, s.n_inv_monts, s.qs, s.qinv_negs)}
    for op, name in (("ntt_fwd", "ntt4_fwd"), ("ntt_inv", "ntt4_inv")):
        configs = [c.config for c in tune.candidates(op, ctx.n_poly,
                                                     ctx.n_limbs, n_rows)
                   if c.backend == "ntt4"]
        if len(configs) != N_NTT4_CONFIGS:
            raise AssertionError(f"{name}: {len(configs)} configurations, "
                                 f"expected {N_NTT4_CONFIGS}")
        times = {}
        for cfg in configs:
            tables = ctx.split_device_tables(cfg.ntt4_split)

            def run(cfg=cfg, tables=tables):
                return ops.run_config(op, "ntt4", cfg, tables, x)

            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, flat[op]):
                raise AssertionError(f"{name} {cfg} differs from the flat "
                                     "kernel's output")
            if not torch.equal(got, plain[op](tables)):
                raise AssertionError(f"{name} {cfg} differs from its plain "
                                     "version")
            del got
            times[cfg] = time_ms(run, 10)
            n1, n2 = cfg.ntt4_split
            log(f"kernel {name} split {n1}x{n2}: exact against the flat "
                f"kernel and the plain version, ms={times[cfg]:.4f}")
        best = min(times, key=times.get)
        rows[name]["best_ms"] = times[best]
        rows[name]["best_config"] = best.to_json()
        log(f"kernel {name}: all {len(configs)} splits exact; default "
            f"{rows[name]['ms']:.4f} ms, best {times[best]:.4f} ms at split "
            f"{best.ntt4_split[0]}x{best.ntt4_split[1]}, bound "
            f"{rows[name]['bound_ms']:.4f} ms")


def check_ntt_shapes(ctx, gen):
    """The NTT kernels beside the main path's [11328, L, N]: keygen's
    [L, N] (B = 1) and five rows at N = 256, 1024 and 16384 (the last
    takes the 66 KiB shared-memory path), the flat kernels exact against
    their plain versions in both directions and round-tripping, and the
    4-step kernels exact against the flat output at every split of N (at
    keygen's shape, the tuner's splits)."""
    cases = [(ctx, (ctx.n_limbs, ctx.n_poly))]
    cases += [(params.make_test_context(n_poly=n, n_limbs=ctx.n_limbs,
                                        device=ctx.device),
               (5, ctx.n_limbs, n)) for n in (256, 1024, 16384)]
    n_splits = 0
    for c, shape in cases:
        t = c.device_tables
        n = c.n_poly
        x = cipher.sample_uniform(gen, shape[:-2] + shape[-1:], c)
        fwd = ntt.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs)
        inv = ntt.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                                t.qinv_negs)
        back = ntt.ntt_inv_fused(fwd, t.psi_inv_rev_mont, t.n_inv_monts,
                                 t.qs, t.qinv_negs)
        torch.cuda.synchronize()
        if not (torch.equal(fwd, ref.ntt_fwd_fused(x, t.psi_rev_mont, t.qs,
                                                   t.qinv_negs))
                and torch.equal(inv, ref.ntt_inv_fused(
                    x, t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                    t.qinv_negs))
                and torch.equal(back, x)):
            raise AssertionError(f"flat NTT kernels differ from their plain "
                                 f"versions at {tuple(x.shape)}")
        splits = (params.ntt4_split_candidates(n) if c is ctx else
                  [(1 << k, n >> k) for k in range(1, n.bit_length() - 1)])
        for split in splits:
            s = c.split_device_tables(split)
            fwd4 = ntt.ntt4_fwd_fused(x, s.ntt4_psi1_mont, s.ntt4_psi2_mont,
                                      s.ntt4_corr_mont, s.qs, s.qinv_negs)
            inv4 = ntt.ntt4_inv_fused(x, s.ntt4_psi1_inv_mont,
                                      s.ntt4_psi2_inv_mont,
                                      s.ntt4_corr_inv_mont, s.n_inv_monts,
                                      s.qs, s.qinv_negs)
            torch.cuda.synchronize()
            if not (torch.equal(fwd4, fwd) and torch.equal(inv4, inv)):
                raise AssertionError(f"4-step NTT kernels at split {split} "
                                     f"differ from the flat output at "
                                     f"{tuple(x.shape)}")
            n_splits += 1
    log("kernel ntt_fwd / ntt_inv: exact and round-tripping also at "
        + ", ".join(str(shape) for _, shape in cases)
        + f"; ntt4_fwd / ntt4_inv exact against them at {n_splits} "
        "(shape, split) points")


def check_accum_variants(acc, ct, w, t, int_rate):
    """weighted_accum with its accumulator broadcast (one row, read for
    every row of ct) and folded in place (out=acc), exact against the plain
    version; the broadcast's time is printed beside the full one's."""
    one = acc[:1].contiguous()
    got = he_agg.he_weighted_accum_fused(one, ct, w, t.qs, t.qinv_negs,
                                         limb_axis=-3)
    want = ref.he_weighted_accum_fused(one, ct, w, t.qs, t.qinv_negs,
                                       limb_axis=-3)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("weighted_accum with a broadcast accumulator "
                             "differs from its plain version")
    del got
    want = ref.he_weighted_accum_fused(acc, ct, w, t.qs, t.qinv_negs,
                                       limb_axis=-3)
    folded = acc.clone()
    he_agg.he_weighted_accum_fused(folded, ct, w, t.qs, t.qinv_negs,
                                   limb_axis=-3, out=folded)
    torch.cuda.synchronize()
    if not torch.equal(folded, want):
        raise AssertionError("weighted_accum in place (out=acc) differs "
                             "from its plain version")
    del folded, want
    ms = time_ms(lambda: he_agg.he_weighted_accum_fused(
        one, ct, w, t.qs, t.qinv_negs, limb_axis=-3), 10)
    bound_ms, _, _ = bound(
        4 * (2 * ct.numel() + one.numel() + 3 * ct.shape[1]),
        int_ops((ct.numel(), MONT), (ct.numel(), MOD_ADD)), int_rate)
    log(f"kernel weighted_accum: exact with a broadcast [1, L, 2, N] "
        f"accumulator (ms={ms:.4f}, bound_ms={bound_ms:.4f}) and in place")


def small_round(c, draws, a, vals, plain):
    """The small round on context c: every output that must agree between
    the card and the CPU, and the keys, as (outputs, sk)."""
    d = {k: torch.from_numpy(v.astype(np.int32)).to(c.device)
         for k, v in draws.items()}
    sk, pk = cipher.keygen_from_samples(
        c, d["s"], torch.from_numpy(a.astype(np.int32)).to(c.device), d["e"])
    m = torch.from_numpy(encoding.encode_np(vals, c).view(np.int32).copy()
                         ).to(c.device)
    ct = cipher.encrypt_coeffs_from_samples(c, pk, m, d["u"], d["e0"],
                                            d["e1"])
    agg = cipher.weighted_sum(c, cipher.Ciphertext(
        torch.stack([ct.data, ct.data]), ct.scale), [0.25, 0.75])
    out = {"ciphertexts": ct.data, "aggregate": agg.data,
           "decryption": cipher.decrypt_to_coeffs(c, sk, agg),
           "rescale": cipher.rescale(c, agg).data}
    ing = stream.StreamIngest(c)
    blobs = []
    for derive, codec, w in ((compress.DERIVE_FOLD_CHUNK, "f16", 0.25),
                             (compress.DERIVE_CTR, "i8", 0.75)):
        out[f"expand_a derive={derive}"] = cipher.expand_a_rows(
            c, 2 ** 40 + 3, 5, 3, derive)
        sct = cipher.encrypt_coeffs_seeded_from_samples(
            c, sk, m, d["e0"], a_seed=77 + derive, derive=derive)
        out[f"seeded ciphertexts derive={derive}"] = sct.data
        blobs.append(stream.pack_update_frames(
            ProtectedUpdate(ct=sct, plain=torch.from_numpy(plain).to(
                c.device)),
            cid=derive, n_samples=1, seeded=compress.seed_compress(
                sct, 77 + derive, derive), plain_codec=codec))
        ing.ingest(blobs[-1], w)
    glob = ing.finalize()
    out["stream aggregate"] = glob.ct.data
    out["stream plain"] = glob.plain.view(torch.int32)
    # the transcipher uplink: provisioned with e0 as the zero encryption's
    # noise, its unmasked aggregate is the seeded encryption's with e0
    cm, sm = transcipher.provision_from_samples(
        c, sk, d["e0"], d["e1"][:1], 2 ** 64 - 3, 300,
        derive=compress.DERIVE_CTR)
    blobs.append(stream.pack_masked_update_frames(
        compress.MaskedChunk(masked=transcipher.mask_values(c, cm, vals),
                             a_seed=cm.a_seed, scale=cm.scale,
                             derive=cm.derive),
        compress.seed_compress(cm.seed_ct, cm.escrow_a_seed, cm.derive),
        torch.from_numpy(plain).to(c.device), cid=9, n_samples=1,
        plain_codec="f16"))
    ing = stream.StreamIngest(c, transcipher_materials={(9, 0): sm})
    ing.ingest(blobs[-1], 0.5)
    sct = cipher.encrypt_coeffs_seeded_from_samples(
        c, sk, m, d["e0"], a_seed=300, derive=compress.DERIVE_CTR)
    want = cipher.weighted_sum(c, cipher.Ciphertext(sct.data[None],
                                                    sct.scale), [0.5])
    out["transcipher D"] = sm.d
    out["escrow ciphertext"] = cm.seed_ct.data
    out["transcipher aggregate"] = ing.finalize().ct.data
    if not torch.equal(out["transcipher aggregate"], want.data):
        raise AssertionError(f"small round on {c.device}: the transcipher "
                             "aggregate differs from the seeded one")
    return {k: v.cpu() for k, v in out.items()}, blobs, sk


def check_small_round_against_cpu(ctx, seed):
    """A few ciphertexts through every op of both rounds with the same draws
    on the card (kernels) and on the CPU (plain versions): bit-identical,
    and the packed blobs byte-identical."""
    cpu_ctx = params.make_context(n_poly=ctx.n_poly, n_limbs=ctx.n_limbs,
                                  delta_bits=ctx.delta_bits, device="cpu")
    rng = np.random.RandomState(seed)
    n, b = ctx.n_poly, 4
    draws = {"s": rng.randint(-1, 2, n), "e": np.rint(3.2 * rng.randn(n)),
             "u": rng.randint(-1, 2, (b, n)),
             "e0": np.rint(3.2 * rng.randn(b, n)),
             "e1": np.rint(3.2 * rng.randn(b, n))}
    a = np.stack([rng.randint(0, q, n) for q in ctx.primes])
    vals = rng.randn(b, ctx.slots).astype(np.float32)
    plain = rng.randn(1000).astype(np.float32)
    card, card_blobs, _ = small_round(ctx, draws, a, vals, plain)
    cpu, cpu_blobs, sk = small_round(cpu_ctx, draws, a, vals, plain)
    for what, want in cpu.items():
        if not torch.equal(card[what], want):
            raise AssertionError(f"small round: {what} on the card differ "
                                 "from the CPU's")
    if card_blobs != cpu_blobs:
        raise AssertionError("small round: packed blobs differ")
    dec = cipher.decrypt_values_np(
        cpu_ctx, sk, cipher.Ciphertext(cpu["aggregate"], ctx.delta ** 2))
    err = float(np.abs(dec - vals).max())
    if not err < MAX_ERR:
        raise AssertionError(f"small round: decode error {err}")
    log(f"small round ({b} ciphertexts, N={n}): card == CPU bit for bit "
        f"({', '.join(cpu)}), blobs byte-identical, decode error "
        f"{err:.3e}")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def traced(what, stats=None):
    """torch.profiler over one path: prints the device time by kernel name
    and the device's busy share of the host clock (the union of the
    device-side events' intervals); fills `stats` (a dict) with wall_ms,
    busy_ms and busy_share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    if not spans:
        raise AssertionError(f"{what}: the profiler recorded no device "
                             "events")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    log(f"{what} profile: device busy {busy / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms host clock (idle share "
        f"{1 - busy / wall_us:.4f}), {len(spans)} device events")
    if stats is not None:
        stats.update(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                     busy_share=busy / wall_us)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"{what} profile: {us / 1e3:10.3f} ms  {name[:100]}")


def flat_leaves(tree):
    return torch.cat([p.reshape(-1) for p in leaves(tree)])


def check_recovered(what, recovered, expect, bound=MAX_ERR,
                    shapes=QWEN_LEAVES):
    """Leaf shapes, finiteness and the FedAvg bound; returns the error."""
    got_leaves = leaves(recovered)
    if [tuple(p.shape) for p in got_leaves] != leaves(shapes):
        raise AssertionError(f"{what}: recovered leaves have the wrong "
                             "shapes")
    got = torch.cat([p.reshape(-1) for p in got_leaves])
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: recovered parameters are not finite")
    err = float((got - expect).abs().max())
    log(f"{what} max |recovered - plaintext FedAvg| = {err:.3e} "
        f"(bound {bound:.4g})")
    if not err < bound:
        raise AssertionError(f"{what}: FedAvg error {err} >= {bound}")
    return err


def check_launches(what, counts, want=None):
    """Every count the expectation names must be exact; all are printed."""
    want = EXPECTED_LAUNCHES[what] if want is None else want
    log(f"{what} launches: {json.dumps(counts)}")
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what} launch counts {got} != {want}")


def report_times(what, times, t0):
    for name, s in times.items():
        log(f"{what} time {name}: {s:.3f} s")
    log(f"{what} total: {time.perf_counter() - t0:.3f} s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def in_memory_round(seed, what="in_memory"):
    """The Algorithm 1 round at Qwen1.5-0.5B width; returns its launch
    counts and the state the later phases reuse."""
    sync = torch.cuda.synchronize
    times = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()

    ctx = params.make_context()
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    sk, pk = cipher.keygen(ctx, gen)
    sync()
    times["keygen"] = time.perf_counter() - t0

    t = time.perf_counter()
    model = map_tree(lambda s: torch.randn(s, generator=gen,
                                           device=ctx.device), QWEN_LEAVES)
    sens = torch.randn(N_PARAMS, generator=gen, device=ctx.device).abs_()
    agg = SelectiveHEAggregator.build(
        ctx, model, sens, AggregatorConfig(p_ratio=P_RATIO, strategy="top_p"))
    del sens
    sync()
    times["build (top-p mask)"] = time.perf_counter() - t
    rep = agg.overhead_report()
    if rep["n_total"] != N_PARAMS or rep["n_ciphertexts"] != \
            n_ciphertexts(ctx.slots):
        raise AssertionError(f"unexpected partition: {rep}")
    log(f"{what}: {rep['n_enc']}/{rep['n_total']} parameters encrypted "
        f"in {rep['n_ciphertexts']} ciphertexts per client")

    updates, expect = [], 0
    for i in range(N_CLIENTS):
        client = map_tree(lambda p: p + 0.1 * i, model)
        t = time.perf_counter()
        updates.append(agg.client_protect(
            client, pk, torch.Generator(device=ctx.device).manual_seed(
                seed + 10 + i)))
        sync()
        times[f"client_protect[{i}]"] = time.perf_counter() - t
        expect = expect + flat_leaves(client)
        del client
    for u in updates:
        if tuple(u.ct.data.shape) != (rep["n_ciphertexts"], 2, 2,
                                      ctx.n_poly):
            raise AssertionError(f"ciphertext shape {u.ct.data.shape}")

    t = time.perf_counter()
    glob = agg.server_aggregate(updates, [1 / N_CLIENTS] * N_CLIENTS)
    sync()
    times["server_aggregate"] = time.perf_counter() - t

    t = time.perf_counter()
    recovered = agg.client_recover_params(glob, sk)
    sync()
    times["client_recover_params"] = time.perf_counter() - t
    counts = ops.launch_counts()
    report_times(what, times, t0)
    expect = expect / N_CLIENTS           # plaintext FedAvg, flat
    check_recovered(what, recovered, expect)
    check_launches(what, counts)
    # the sharded round (phase 6) aggregates the same updates; the 4-step
    # round is held against all of it
    return counts, {"ctx": ctx, "sk": sk, "pk": pk, "agg": agg,
                    "model": model, "expect": expect,
                    "n_rows": rep["n_ciphertexts"], "updates": updates,
                    "aggregate": glob, "recovered": flat_leaves(recovered)}


# ---------------------------------------------------------------------------
# phase 2b: the tuner's sweep; phase 3b: the round on the 4-step kernels
# ---------------------------------------------------------------------------


def tuner_sweep(seed):
    """sweep_op at each NTT shape of the in-memory round; checks the cache's
    save / clear / load round trip and leaves the cache empty.  Returns
    {(op, B): the fastest 4-step KernelConfig}."""
    ctx = params.make_context()
    gen = torch.Generator(device=ctx.device).manual_seed(seed + 5)
    rows = n_ciphertexts(ctx.slots)
    tune.clear_cache()
    best4, winners = {}, {}
    t0 = time.perf_counter()
    for op, b in ROUND_NTT_SHAPES:
        b = rows if b == "rows" else b
        res = tune.sweep_op(op, ctx, b, gen, reps=10)
        if not res.tuned_ms <= res.default_ms:
            raise AssertionError(f"sweep {op} B={b}: tuned {res.tuned_ms} "
                                 f"ms > default {res.default_ms} ms")
        ntt4 = {c: ms for c, ms in res.times_ms.items()
                if c.backend == "ntt4"}
        if not ntt4:
            raise AssertionError(f"sweep {op} B={b}: no 4-step candidate "
                                 "was measured")
        best4[(op, b)] = min(ntt4, key=ntt4.get).config
        winners[(op, b)] = (res.winner.backend, res.winner.config)
        log(f"sweep {json.dumps(res.to_row())}")
        log(f"sweep {op} B={b}: best 4-step {best4[(op, b)].to_json()} at "
            f"{min(ntt4.values()):.4f} ms")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tune_cache.json")
        tune.save_cache(path)
        tune.clear_cache()
        if tune.n_entries() != 0:
            raise AssertionError("clear_cache left entries")
        loaded = tune.load_cache(path)
    if loaded != len(ROUND_NTT_SHAPES):
        raise AssertionError(f"the saved cache reloads {loaded} entries, "
                             f"expected {len(ROUND_NTT_SHAPES)}")
    for (op, b), want in winners.items():
        got = tune.resolve(op, ctx.n_poly, ctx.n_limbs, b, ctx.device.type)
        if got != want:
            raise AssertionError(f"reloaded cache resolves {op} B={b} to "
                                 f"{got}, the sweep chose {want}")
    tune.clear_cache()
    log(f"sweep: {len(ROUND_NTT_SHAPES)} points, cache saved, cleared and "
        f"reloaded with {loaded} entries, then cleared; "
        f"{time.perf_counter() - t0:.1f} s")
    return best4


def ntt4_round(seed, state, best4):
    """Phase 3 again with every NTT shape resolved to its best 4-step
    configuration; returns its launch counts.  Everything it makes must
    equal phase 3's bit for bit."""
    ctx = state["ctx"]
    for (op, b), cfg in best4.items():
        tune.put(op, ctx.n_poly, ctx.n_limbs, b, ctx.device.type, "ntt4",
                 cfg)
    try:
        with traced("ntt4_round"):
            counts, got = in_memory_round(seed, "ntt4_round")
    finally:
        tune.clear_cache()
    pairs = {f"sk {k}": (got["sk"][k], state["sk"][k]) for k in state["sk"]}
    pairs.update({f"pk {k}": (got["pk"][k], state["pk"][k])
                  for k in state["pk"]})
    for i, (u, v) in enumerate(zip(got["updates"], state["updates"])):
        pairs[f"client {i} ciphertexts"] = (u.ct.data, v.ct.data)
        pairs[f"client {i} plain"] = (u.plain, v.plain)
    pairs["aggregate"] = (got["aggregate"].ct.data,
                          state["aggregate"].ct.data)
    pairs["aggregate plain"] = (got["aggregate"].plain,
                                state["aggregate"].plain)
    pairs["recovered parameters"] = (got["recovered"], state["recovered"])
    for what, (a, b) in pairs.items():
        if not torch.equal(a, b):
            raise AssertionError(f"ntt4_round: {what} differ from phase "
                                 "3's")
    log(f"ntt4_round: {', '.join(pairs)} equal phase 3's bit for bit")
    return counts


def uplink_blob_bytes(n_rows, n_limbs, n_poly, n_plain):
    """Bytes of one seeded uplink blob with an f16 plain segment, from the
    frame layout (DESIGN.md §6, §9.2): 16-byte headers; a CT_CHUNK is its
    u32 index plus a v2 seeded frame (f64 scale, u64 seed, u32 offset, u8
    derive, then a 3-d u32 array); the plain segment is u8 codec, f64 scale
    and a 1-d f16 array; UPDATE_BEGIN carries 17 bytes, UPDATE_END none."""
    h = wf.HEADER_BYTES
    chunk = h + 4 + h + 21 + (2 + 3 * 4) + 4 * n_limbs * n_poly
    return (h + 17) + n_rows * chunk + (h + 9 + 2 + 4 + 2 * n_plain) + h


def downlink_blob_bytes(n_rows, n_limbs, n_poly, n_plain):
    """Bytes of the serialize_update downlink (full ciphertext, f32
    plain)."""
    h = wf.HEADER_BYTES
    ct = h + 8 + (2 + 4 * 4) + 4 * n_rows * n_limbs * 2 * n_poly
    return h + ct + (h + 9 + 2 + 4 + 4 * n_plain)


def wire_round(seed, st):
    """The round over the wire, with the in-memory round's keys and mask;
    returns its launch counts."""
    sync = torch.cuda.synchronize
    ctx, sk, agg, model = st["ctx"], st["sk"], st["agg"], st["model"]
    times = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ledger = budget.BandwidthLedger()
    blobs = []
    for i in range(N_CLIENTS):
        client = map_tree(lambda p: p + 0.1 * i, model)
        t = time.perf_counter()
        upd = agg.client_protect_seeded(
            client, sk, torch.Generator(device=ctx.device).manual_seed(
                seed + 20 + i), a_seed=A_SEED0 + i)
        sync()
        times[f"client_protect_seeded[{i}]"] = time.perf_counter() - t
        del client
        t = time.perf_counter()
        blobs.append(stream.pack_update_frames(
            upd, cid=i, n_samples=1, rnd=0,
            seeded=compress.seed_compress(upd.ct, A_SEED0 + i),
            plain_codec=PLAIN_CODEC))
        times[f"seed_compress + pack_update_frames[{i}]"] = \
            time.perf_counter() - t
        del upd
        ledger.record_blob(blobs[-1], rnd=0, cid=i, direction=budget.UPLINK)

    ingest = stream.StreamIngest(ctx)
    for i, blob in enumerate(blobs):
        t = time.perf_counter()
        ingest.ingest(blob, 1 / N_CLIENTS)
        sync()
        times[f"StreamIngest.ingest[{i}]"] = time.perf_counter() - t
    t = time.perf_counter()
    glob = ingest.finalize()
    sync()
    times["finalize"] = time.perf_counter() - t
    up_sizes = [len(b) for b in blobs]
    # for the checkpoint step and phase 6
    st["blobs"], st["wire_aggregate"] = blobs, glob.ct.data
    st["wire_scale"] = glob.ct.scale
    st["wire_plain"], st["ledger"] = glob.plain, ledger

    t = time.perf_counter()
    down = wf.serialize_update(glob)
    times["serialize_update (downlink)"] = time.perf_counter() - t
    del glob
    ledger.record_blob(down, rnd=0, cid=0, direction=budget.DOWNLINK)
    t = time.perf_counter()
    received, _ = wf.deserialize(down, ctx)
    sync()
    times["deserialize (downlink)"] = time.perf_counter() - t
    down_size = len(down)
    del down
    t = time.perf_counter()
    recovered = agg.client_recover_params(received, sk)
    sync()
    times["client_recover_params"] = time.perf_counter() - t
    counts = ops.launch_counts()
    report_times("wire", times, t0)

    n_rows, part = st["n_rows"], agg.part
    want_up = uplink_blob_bytes(n_rows, ctx.n_limbs, ctx.n_poly,
                                part.n_plain)
    want_down = downlink_blob_bytes(n_rows, ctx.n_limbs, ctx.n_poly,
                                    part.n_plain)
    log(f"wire bytes: uplink blobs {up_sizes} (frame layout {want_up} "
        f"each), downlink {down_size} (frame layout {want_down})")
    log(f"wire ledger round 0: {json.dumps(ledger.round_summary(0))}")
    log(f"wire compression: {json.dumps(ledger.compression_summary(ctx, part, 0))}")
    log(f"wire ingest: accum_launches={ingest.accum_launches} "
        f"clients_ingested={ingest.clients_ingested} "
        f"peak_chunk_buffers={ingest.peak_chunk_buffers} "
        f"bytes_ingested={ingest.bytes_ingested}")
    if up_sizes != [want_up] * N_CLIENTS or down_size != want_down:
        raise AssertionError("wire blob sizes differ from the frame layout")
    if not ingest.accum_launches == N_CLIENTS == ingest.clients_ingested:
        raise AssertionError("wire: not one accumulate launch per client")
    if ingest.peak_chunk_buffers != n_rows:
        raise AssertionError(f"wire: peak_chunk_buffers "
                             f"{ingest.peak_chunk_buffers} != {n_rows}")
    check_recovered("wire", recovered, st["expect"])
    check_launches("wire", counts)
    return counts


def masked_blob_bytes(n_rows, n_limbs, n_poly, n_plain):
    """Bytes of one transcipher uplink blob with an f16 plain segment, from
    the frame layout (DESIGN.md §6, §15): a CT_CHUNK is its u32 index plus
    a masked-chunk frame (f64 scale, u64 a_seed, u32 offset, u8 derive, then
    a 2-d u32 array [1, N]); the TRANSCIPHER_SEED frame nests a one-row v2
    seeded frame of all L limbs."""
    h = wf.HEADER_BYTES
    chunk = h + 4 + h + 21 + (2 + 2 * 4) + 4 * n_poly
    escrow = h + h + 21 + (2 + 3 * 4) + 4 * n_limbs * n_poly
    return ((h + 17) + escrow + n_rows * chunk
            + (h + 9 + 2 + 4 + 2 * n_plain) + h)


def tc_generator(ctx, seed, i):
    """Client i's provisioning generator; provision draws the zero
    encryption's gaussian noise from it first."""
    return torch.Generator(device=ctx.device).manual_seed(seed + 30 + i)


def transcipher_round(seed, st):
    """The round over the thin-client uplink, with the in-memory round's
    keys and mask; returns its launch counts and what the checks after it
    need."""
    sync = torch.cuda.synchronize
    ctx, sk, agg, model = st["ctx"], st["sk"], st["agg"], st["model"]
    n_rows = st["n_rows"]
    times = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    mats = []
    for i in range(N_CLIENTS):
        t = time.perf_counter()
        mats.append(transcipher.provision(ctx, sk, tc_generator(ctx, seed, i),
                                          TC_A_SEED0 + i, n_rows))
        sync()
        times[f"provision[{i}]"] = time.perf_counter() - t
    blobs = []
    for i, (cm, _) in enumerate(mats):
        client = map_tree(lambda p: p + 0.1 * i, model)
        t = time.perf_counter()
        masked, plain = agg.client_protect_transcipher(
            client, cm, torch.Generator(device=ctx.device).manual_seed(
                seed + 40 + i))
        sync()
        times[f"client_protect_transcipher[{i}]"] = time.perf_counter() - t
        del client
        t = time.perf_counter()
        blobs.append(stream.pack_masked_update_frames(
            compress.MaskedChunk(masked=masked, a_seed=cm.a_seed,
                                 scale=cm.scale, chunk_offset=cm.chunk_offset,
                                 derive=cm.derive),
            compress.seed_compress(cm.seed_ct, cm.escrow_a_seed, cm.derive),
            plain, cid=i, n_samples=1, rnd=0, plain_codec=PLAIN_CODEC))
        times[f"pack_masked_update_frames[{i}]"] = time.perf_counter() - t
        del masked, plain

    ingest = stream.StreamIngest(ctx, transcipher_materials={
        (i, 0): sm for i, (_, sm) in enumerate(mats)})
    for i, blob in enumerate(blobs):
        t = time.perf_counter()
        ingest.ingest(blob, 1 / N_CLIENTS)
        sync()
        times[f"StreamIngest.ingest[{i}]"] = time.perf_counter() - t
    t = time.perf_counter()
    glob = ingest.finalize()
    sync()
    times["finalize"] = time.perf_counter() - t
    t = time.perf_counter()
    recovered = agg.client_recover_params(glob, sk)
    sync()
    times["client_recover_params"] = time.perf_counter() - t
    counts = ops.launch_counts()
    report_times("transcipher", times, t0)

    up_sizes = [len(b) for b in blobs]
    want_up = masked_blob_bytes(n_rows, ctx.n_limbs, ctx.n_poly,
                                agg.part.n_plain)
    seeded_up = uplink_blob_bytes(n_rows, ctx.n_limbs, ctx.n_poly,
                                  agg.part.n_plain)
    log(f"transcipher bytes: uplink blobs {up_sizes} (frame layout "
        f"{want_up} each; the seeded uplink's {seeded_up}, ratio "
        f"{want_up / seeded_up:.4f})")
    log(f"transcipher ingest: accum_launches={ingest.accum_launches} "
        f"clients_ingested={ingest.clients_ingested} "
        f"peak_chunk_buffers={ingest.peak_chunk_buffers} "
        f"bytes_ingested={ingest.bytes_ingested}")
    if up_sizes != [want_up] * N_CLIENTS:
        raise AssertionError("transcipher blob sizes differ from the frame "
                             "layout")
    if not ingest.accum_launches == N_CLIENTS == ingest.clients_ingested:
        raise AssertionError("transcipher: not one accumulate launch per "
                             "client")
    if ingest.peak_chunk_buffers != n_rows:
        raise AssertionError(f"transcipher: peak_chunk_buffers "
                             f"{ingest.peak_chunk_buffers} != {n_rows}")
    check_recovered("transcipher", recovered, st["expect"])
    check_launches("transcipher", counts)
    return counts, {"aggregate": glob.ct.data, "escrow": ingest.escrow_seeds,
                    "seeds": [cm.keystream_seed for cm, _ in mats]}


def check_transcipher_reference(seed, st, out):
    """The transcipher aggregate against the weighted_sum of seeded
    encryptions of the same coefficients, with the same gaussian draws and
    a_seeds (bit for bit), and each stored escrow frame against its
    client's keystream seed."""
    ctx, sk, agg, model = st["ctx"], st["sk"], st["agg"], st["model"]
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    cts = []
    for i in range(N_CLIENTS):
        e = cipher.sample_gaussian(tc_generator(ctx, seed, i),
                                   (st["n_rows"], ctx.n_poly), ctx.device,
                                   ctx.error_sigma)
        vec, _ = packing.flatten_params(map_tree(lambda p: p + 0.1 * i,
                                                 model))
        enc_vals, _ = packing.split_by_mask(vec, agg.part)
        del vec
        m = interop.residues_from_np(
            encoding.encode_np(enc_vals.cpu().numpy(), ctx), ctx.device)
        cts.append(cipher.encrypt_coeffs_seeded_from_samples(
            ctx, sk, m, e, TC_A_SEED0 + i, derive=compress.DERIVE_CTR).data)
        del e, m, enc_vals
    stacked = cipher.Ciphertext(torch.stack(cts), ctx.delta)
    del cts
    want = cipher.weighted_sum(ctx, stacked, [1 / N_CLIENTS] * N_CLIENTS)
    del stacked
    if not torch.equal(out["aggregate"], want.data):
        raise AssertionError("transcipher aggregate differs from the seeded "
                             "weighted_sum reference")
    del want
    for i, ks in enumerate(out["seeds"]):
        ct = out["escrow"][(i, 0)].expand(ctx)
        dig = cipher.decrypt_values_np(ctx, sk, ct).ravel()[:4]
        got = sum(int(round(float(v))) << (16 * j) for j, v in enumerate(dig))
        if got != ks:
            raise AssertionError(f"escrow frame of client {i} decrypts to "
                                 f"{got}, not its keystream seed {ks}")
    log(f"transcipher reference: aggregate == weighted_sum of {N_CLIENTS} "
        f"seeded encryptions bit for bit (launches "
        f"{json.dumps(ops.launch_counts())}); {N_CLIENTS} escrow frames "
        f"decrypt to their keystream seeds; "
        f"{time.perf_counter() - t0:.3f} s")


def sharded_round(seed, st):
    """The sharded engine at full width over the in-memory round's updates
    and the wire round's blobs; returns its launch counts and the results
    the checks after it need."""
    sync = torch.cuda.synchronize
    ctx, agg, model = st["ctx"], st["agg"], st["model"]
    weights = [1 / N_CLIENTS] * N_CLIENTS
    devices = [torch.device("cuda", i % torch.cuda.device_count())
               for i in range(MESH_SLOTS)]
    mesh = he_mesh.make_he_mesh(ctx.n_limbs, devices=devices)
    log(f"sharded mesh {mesh.shape}: " + "; ".join(
        f"slot ({d}, {m}) on {mesh.device(d, m)}"
        for d in range(mesh.n_data) for m in range(mesh.n_model)))
    eng = sharded.ShardedHe(ctx, mesh)
    times, out = {}, {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()

    t = time.perf_counter()
    sk, pk = eng.keygen(torch.Generator(device=ctx.device).manual_seed(seed))
    sync()
    times["ShardedHe.keygen"] = time.perf_counter() - t
    out["keys"] = (sk, pk)

    t = time.perf_counter()
    out["aggregate"] = agg.server_aggregate(st["updates"], weights,
                                            sharded=eng)
    sync()
    times["server_aggregate(sharded=)"] = time.perf_counter() - t

    t = time.perf_counter()
    zero = cipher.Ciphertext(torch.zeros(
        (ctx.n_limbs, 2, ctx.n_poly), dtype=torch.int32, device=ctx.device),
        ctx.delta)
    acc = zero
    for u, w in zip(st["updates"], weights):
        acc = eng.weighted_accum(acc, u.ct, w)
    sync()
    times["weighted_accum fold x3"] = time.perf_counter() - t
    out["fold"] = acc
    del acc

    t = time.perf_counter()
    spec = fl_step.HeAggSpec(N_CLIENTS, st["n_rows"], agg.part.n_plain, ctx)
    if not spec.limb_sharded(mesh):
        raise AssertionError("fl_step: the mesh should shard the limbs")
    out["step"] = fl_step.make_he_agg_step(spec, weights, mesh)(
        torch.stack([u.ct.data for u in st["updates"]]),
        torch.stack([u.plain for u in st["updates"]]))
    sync()
    times["fl_step (limb-sharded)"] = time.perf_counter() - t

    t = time.perf_counter()
    out["seeded"] = agg.client_protect_seeded(
        model, sk, torch.Generator(device=ctx.device).manual_seed(seed + 50),
        a_seed=A_SEED0 + 50, sharded=eng)
    sync()
    times["client_protect_seeded(sharded=)"] = time.perf_counter() - t

    ingest = stream.StreamIngest(ctx, sharded=eng)
    for i, blob in enumerate(st["blobs"]):
        t = time.perf_counter()
        ingest.ingest(blob, 1 / N_CLIENTS)
        sync()
        times[f"StreamIngest(sharded=).ingest[{i}]"] = time.perf_counter() - t
    t = time.perf_counter()
    out["ingest"] = ingest.finalize()
    sync()
    times["finalize (gather)"] = time.perf_counter() - t
    out["ingest_acc"] = ingest._acc

    t = time.perf_counter()
    out["recovered"] = agg.client_recover_params(out["aggregate"], sk,
                                                 sharded=eng)
    sync()
    times["client_recover_params(sharded=)"] = time.perf_counter() - t
    counts = ops.launch_counts()
    report_times("sharded", times, t0)
    log(f"sharded ingest: accum_launches={ingest.accum_launches} "
        f"peak_chunk_buffers={ingest.peak_chunk_buffers}; engine gathers "
        f"{eng.gathers}")
    if not ingest.accum_launches == N_CLIENTS == ingest.clients_ingested:
        raise AssertionError("sharded: not one accumulate flush per client")
    if ingest.peak_chunk_buffers != st["n_rows"]:
        raise AssertionError(f"sharded: peak_chunk_buffers "
                             f"{ingest.peak_chunk_buffers} != {st['n_rows']}")
    if eng.gathers != EXPECTED_GATHERS:
        raise AssertionError(f"sharded: {eng.gathers} gathers, expected "
                             f"{EXPECTED_GATHERS} (decrypt, finalize)")
    return counts, out


def check_sharded(seed, st, out):
    """Every sharded result against its single-device counterpart, and
    every block on its slot's device."""
    ctx, agg, model = st["ctx"], st["agg"], st["model"]
    t0 = time.perf_counter()
    sk, pk = out["keys"]
    want = st["aggregate"].ct.data
    checks = {
        "keygen s": (sk["s_mont"], st["sk"]["s_mont"]),
        "keygen pk0": (pk["pk0_mont"], st["pk"]["pk0_mont"]),
        "keygen pk1": (pk["pk1_mont"], st["pk"]["pk1_mont"]),
        "server_aggregate": (out["aggregate"].ct.data, want),
        "weighted_accum fold": (out["fold"].data, want),
        "fl_step ciphertext": (out["step"][0], want),
    }
    ref_seeded = agg.client_protect_seeded(
        model, st["sk"], torch.Generator(device=ctx.device).manual_seed(
            seed + 50), a_seed=A_SEED0 + 50)
    checks["client_protect_seeded"] = (out["seeded"].ct.data,
                                       ref_seeded.ct.data)
    for what, (grid, ref_t) in checks.items():
        if not grid.on_slot_devices():
            raise AssertionError(f"sharded {what}: a block is not on its "
                                 "slot's device")
        if not grid.equals(ref_t):
            raise AssertionError(f"sharded {what} differs from the "
                                 "single-device result")
    if not torch.equal(out["seeded"].plain, ref_seeded.plain):
        raise AssertionError("sharded client_protect_seeded: plain differs")
    if not out["ingest_acc"].on_slot_devices():
        raise AssertionError("sharded ingest: an accumulator block is not "
                             "on its slot's device")
    if not torch.equal(out["ingest"].ct.data, st["wire_aggregate"]):
        raise AssertionError("sharded ingest aggregate differs from the "
                             "wire round's")
    if not torch.equal(out["aggregate"].plain, st["aggregate"].plain):
        raise AssertionError("sharded server_aggregate plain differs")
    pt, ref_pt = out["step"][1], st["aggregate"].plain
    if not pt.on_slot_devices():
        raise AssertionError("fl_step plain: a block is not on its slot's "
                             "device")
    pt = pt.assemble(ctx.device)
    tol = 4 * float(torch.finfo(torch.float32).eps) * float(
        ref_pt.abs().max())
    pt_err = float((pt - ref_pt).abs().max())
    if not pt_err <= tol:
        raise AssertionError(f"fl_step plain part off the einsum by {pt_err}"
                             f" (float32 rounding bound {tol})")
    err = check_recovered("sharded", out["recovered"], st["expect"])
    log(f"sharded: {', '.join(checks)}, the ingest aggregate (vs the wire "
        f"round's) bit-identical to the single-device results, every block "
        f"on its slot's device; fl_step plain within {pt_err:.3e} of the "
        f"einsum (bound {tol:.3e}); FedAvg error {err:.3e}; "
        f"{time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# step 4b: the serve crash/resume case through ckpt at full width
# ---------------------------------------------------------------------------

INGEST_SERIES = (("wire_ingest_accum_launches", "accum_launches"),
                 ("wire_ingest_clients", "clients_ingested"),
                 ("wire_ingest_bytes", "bytes_ingested"),
                 ("wire_ingest_peak_chunk_buffers", "peak_chunk_buffers"),
                 ("wire_ingest_rejected_updates", "rejected_updates"))


def check_ingest_series(what, ing):
    """Each of the ingest's counters is its labelled registry series."""
    for series, prop in INGEST_SERIES:
        got = obs.REGISTRY.get(series, ingest=ing.ingest_id).value
        if got != getattr(ing, prop):
            raise AssertionError(f"{what}: {series} {got} != {prop} "
                                 f"{getattr(ing, prop)}")


def checkpoint_step(st):
    """Phase 4's blobs 0 and 1 into a fresh StreamIngest, checkpointed after
    each (keep=1); a second fresh ingest restores step 2, takes blob 2, and
    must finalize to phase 4's aggregate bit for bit."""
    sync = torch.cuda.synchronize
    ctx, blobs = st["ctx"], st["blobs"]
    w = 1 / N_CLIENTS
    times = {}
    t0 = time.perf_counter()
    first = stream.StreamIngest(ctx)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=1)
        for step, blob in enumerate(blobs[:2], 1):
            t = time.perf_counter()
            first.ingest(blob, w)
            sync()
            times[f"ingest[{step - 1}]"] = time.perf_counter() - t
            t = time.perf_counter()
            arrays, meta = first.export_state()
            times[f"export_state (step {step})"] = time.perf_counter() - t
            t = time.perf_counter()
            mgr.save(step, arrays, meta)
            times[f"CheckpointManager.save (step {step})"] = \
                time.perf_counter() - t
            nbytes = sum(a.nbytes for a in arrays.values())
            del arrays
        check_ingest_series("checkpoint: the first ingest", first)
        kept = sorted(os.listdir(d))
        if kept != ["step_00000002"]:
            raise AssertionError(f"checkpoint: rotation kept {kept}")
        del first
        t = time.perf_counter()
        tree, step, extra = mgr.restore({"acc_ct": 0, "acc_plain": 0,
                                         "chunk_idx": 0})
        times["CheckpointManager.restore (read step 2)"] = \
            time.perf_counter() - t
    if step != 2 or extra != meta:
        raise AssertionError(f"checkpoint: restored step {step} with "
                             f"{extra}, expected step 2 with {meta}")
    resumed = stream.StreamIngest(ctx)
    t = time.perf_counter()
    resumed.restore_state(tree, extra)
    sync()
    times["restore_state"] = time.perf_counter() - t
    del tree
    check_ingest_series("checkpoint: the restored ingest", resumed)
    if resumed.clients_ingested != 2 or resumed.accum_launches != 2:
        raise AssertionError("checkpoint: the restored counters are not "
                             "the checkpoint's")
    t = time.perf_counter()
    resumed.ingest(blobs[2], w)
    sync()
    times["ingest[2]"] = time.perf_counter() - t
    glob = resumed.finalize()
    sync()
    check_ingest_series("checkpoint: the resumed ingest", resumed)
    if resumed.bytes_ingested != sum(len(b) for b in blobs):
        raise AssertionError("checkpoint: bytes_ingested differs")
    if not torch.equal(glob.ct.data, st["wire_aggregate"]):
        raise AssertionError("checkpoint: the resumed aggregate differs "
                             "from phase 4's")
    if not torch.equal(glob.plain.view(torch.int32),
                       st["wire_plain"].view(torch.int32)):
        raise AssertionError("checkpoint: the resumed plain sum differs "
                             "from phase 4's")
    del glob, resumed
    ledger = st["ledger"]
    wire_bytes = obs.REGISTRY.series("wire_bytes_total")
    for series in wire_bytes:
        lab = dict(series.labels)
        if series.value != ledger.total(direction=lab["direction"],
                                        kind=lab["kind"]):
            raise AssertionError(f"wire_bytes_total{lab} {series.value} != "
                                 "the ledger's")
    if obs.REGISTRY.total("wire_bytes_total") != ledger.total():
        raise AssertionError("wire_bytes_total differs from the ledger")
    for name, sec in times.items():
        log(f"checkpoint time {name}: {sec:.3f} s")
    log(f"checkpoint: {nbytes / 1e9:.3f} GB a step, rotation kept step 2 "
        f"only, the resumed aggregate and plain sum == phase 4's bit for "
        f"bit, every ingest's registry series == its properties, "
        f"wire_bytes_total == the ledger's {ledger.total()} bytes in "
        f"{len(wire_bytes)} series; {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 7: the threshold round (Appendix B), obs enabled
# ---------------------------------------------------------------------------


def threshold_bound(ctx):
    """THRESHOLD_STDS x the smudging's slot std at the fresh scale delta."""
    return THRESHOLD_STDS * (threshold.DEFAULT_SMUDGE_SIGMA
                             * math.sqrt(N_PARTIES)
                             * math.sqrt(ctx.n_poly / 2) / ctx.delta)


def smudge_generator(ctx, seed, i):
    """Party i's smudging generator in the threshold round."""
    return torch.Generator(device=ctx.device).manual_seed(seed + 60 + i)


def recover_from_coeffs(agg, coeffs, glob):
    """decode, merge_by_mask and unflatten_params of combined coefficients."""
    enc = encoding.decode(coeffs, agg.ctx, glob.ct.scale)
    return packing.unflatten_params(
        packing.merge_by_mask(enc, glob.plain, agg.part), agg.spec)


def kernel_spans(events):
    """{op: count} of the trace's ops-hook spans on the card."""
    out = {}
    for e in events:
        if e.get("cat") == "kernel" and e["args"].get("backend") == "cuda":
            out[e["args"]["op"]] = out.get(e["args"]["op"], 0) + 1
    return out


def hooked_launches():
    """{op: kernel_op_launches_total} of the ops hook on the card."""
    return {dict(c.labels)["op"]: c.value
            for c in obs.REGISTRY.series("kernel_op_launches_total")
            if dict(c.labels)["backend"] == "cuda"}


def threshold_round(seed, st, trace_path):
    """Three parties' keys, phase 3's clients under the joint pk, the
    aggregate, three partial decryptions and the combine, with obs on and
    traced to `trace_path`; returns its launch counts and what the checks
    after it need."""
    sync = torch.cuda.synchronize
    ctx, agg, model = st["ctx"], st["agg"], st["model"]
    times = {}
    before = hooked_launches()
    torch.cuda.reset_peak_memory_stats()
    obs.configure(enabled=True, trace_path=trace_path, reset=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with obs.span("round", round=0):
        t = time.perf_counter()
        with obs.span("keygen", parties=N_PARTIES):
            ta = ThresholdKeyAuthority(N_PARTIES, ctx, seed)
        sync()
        times["ThresholdKeyAuthority (keygen)"] = time.perf_counter() - t
        updates = []
        for i in range(N_CLIENTS):
            client = map_tree(lambda p: p + 0.1 * i, model)
            t = time.perf_counter()
            with obs.span("client", cid=i):
                updates.append(obs.maybe_block(agg.client_protect(
                    client, ta.public_key(), torch.Generator(
                        device=ctx.device).manual_seed(seed + 10 + i))))
            times[f"client_protect[{i}]"] = time.perf_counter() - t
            del client
        t = time.perf_counter()
        with obs.span("aggregate"):
            glob = obs.maybe_block(agg.server_aggregate(
                updates, [1 / N_CLIENTS] * N_CLIENTS))
        times["server_aggregate"] = time.perf_counter() - t
        del updates
        with obs.span("recover"):
            partials = []
            for i in range(N_PARTIES):
                t = time.perf_counter()
                with obs.span("partial_decrypt", party=i):
                    partials.append(obs.maybe_block(ta.partial_decrypt(
                        i, glob.ct, smudge_generator(ctx, seed, i))))
                times[f"partial_decrypt[{i}]"] = time.perf_counter() - t
            t = time.perf_counter()
            coeffs = obs.maybe_block(ta.combine(glob.ct, partials))
            times["combine_partials"] = time.perf_counter() - t
            t = time.perf_counter()
            recovered = obs.maybe_block(recover_from_coeffs(agg, coeffs,
                                                            glob))
            times["decode + merge_by_mask + unflatten_params"] = \
                time.perf_counter() - t
    counts = ops.launch_counts()
    host_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    obs.flush()
    after = hooked_launches()
    report_times("threshold", times, t0)
    err = check_recovered("threshold", recovered, st["expect"],
                          threshold_bound(ctx))
    del recovered
    check_launches("threshold", counts)
    return counts, {"ta": ta, "glob": glob, "partials": partials,
                    "coeffs": coeffs, "err": err, "host_s": host_s,
                    "peak_gib": peak,
                    "hooked": {op: after.get(op, 0) - before.get(op, 0)
                               for op in after}}


def check_threshold_obs(trace_path, counts, hooked):
    """One he.<op> span per counted launch of an HE op (the ops the hooks
    time; the mask's split and merge have their he.split / he.merge spans),
    the registry's launch series equal to those counts, and the trace loads
    in tools/round_report.py."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import round_report

    events = round_report.parse_trace(trace_path)
    roots = round_report.build_tree(events)
    want = {op: n for op, n in counts.items() if n and op in KERNELS}
    spans = kernel_spans(events)
    if spans != want:
        raise AssertionError(f"threshold trace: he.<op> spans {spans} != "
                             f"the launch counts {want}")
    if {op: n for op, n in hooked.items() if n} != want:
        raise AssertionError(f"kernel_op_launches_total {hooked} != the "
                             f"launch counts {want}")
    rows = round_report.round_rows(roots)
    if len(rows) != 1:
        raise AssertionError(f"round_report found {len(rows)} rounds")
    p50 = {dict(h.labels)["op"]: h.percentile(50) * 1e3
           for h in obs.REGISTRY.series("kernel_op_seconds")
           if dict(h.labels)["backend"] == "cuda"}
    log(f"threshold trace: {len(events)} events, one he.<op> span per "
        f"launch ({json.dumps(spans)}), kernel_op_launches_total == the "
        f"launch counts; round_report: wall {rows[0]['wall_ms']:.3f} ms, "
        f"coverage {rows[0]['coverage']:.4f}")
    log("threshold kernel_op_seconds p50 (ms, synchronized before and "
        "after): " + ", ".join(f"{op} {ms:.4f}" for op, ms in
                               sorted(p50.items())))


def check_threshold(seed, st, out):
    """Outside the counted run: zero-smudge partials combine to the joint
    secret's decrypt bit for bit, the smudged combine is that plus exactly
    the smudging draws, two of three partials give garbage, and a Shamir
    3-of-5 sharing of phase 3's sk decrypts phase 3's aggregate."""
    ctx, agg = st["ctx"], st["agg"]
    ta, glob = out["ta"], out["glob"]
    t0 = time.perf_counter()
    rows = glob.ct.data.shape[0]
    zero = torch.zeros((rows, ctx.n_poly), dtype=torch.int32,
                       device=ctx.device)
    exact = threshold.combine_partials(ctx, glob.ct, [
        threshold.partial_decrypt_from_samples(ctx, p, glob.ct, zero)
        for p in ta.parties])
    s = ta.parties[0].s_mont
    for p in ta.parties[1:]:
        s = ops.mod_add(s, p.s_mont, ctx)
    if not torch.equal(exact, cipher.decrypt_to_coeffs(ctx, {"s_mont": s},
                                                       glob.ct)):
        raise AssertionError("threshold: the zero-smudge combine differs "
                             "from the joint secret's decrypt")
    e = sum(cipher.sample_gaussian(smudge_generator(ctx, seed, i),
                                   (rows, ctx.n_poly), ctx.device,
                                   threshold.DEFAULT_SMUDGE_SIGMA)
            for i in range(N_PARTIES))
    if not torch.equal(ops.mod_sub(out["coeffs"], exact, ctx),
                       cipher.centered_residues(e, ctx)):
        raise AssertionError("threshold: the smudged combine is not the "
                             "joint decrypt plus the smudging draws")
    e_max = int(e.abs().max())
    del exact, e, zero
    bound = threshold_bound(ctx)
    missing = recover_from_coeffs(agg, threshold.combine_partials(
        ctx, glob.ct, out["partials"][:2]), glob)
    got = flat_leaves(missing)
    del missing
    miss_err = float(torch.nan_to_num((got - st["expect"]).abs(),
                                      nan=float("inf")).max())
    del got
    if not miss_err > MISSING_PARTY_MIN_ERR:
        raise AssertionError(f"threshold: two of three partials decrypt "
                             f"(error {miss_err})")
    parties = threshold.shamir_share_secret(
        ctx, st["sk"], torch.Generator(device=ctx.device).manual_seed(
            seed + 70), SHAMIR_N, SHAMIR_T)
    ct = st["aggregate"].ct
    partials = [threshold.shamir_partial_decrypt(
        ctx, parties[i], list(SHAMIR_ACTIVE), ct,
        torch.Generator(device=ctx.device).manual_seed(seed + 80 + i))
        for i in SHAMIR_ACTIVE]
    shamir_err = check_recovered(
        f"shamir {SHAMIR_T}-of-{SHAMIR_N} (parties {SHAMIR_ACTIVE})",
        recover_from_coeffs(agg, threshold.combine_partials(ctx, ct,
                                                            partials),
                            st["aggregate"]), st["expect"], bound)
    log(f"threshold checks: zero-smudge combine == joint-secret decrypt bit "
        f"for bit; smudged combine == it + the {N_PARTIES} parties' draws "
        f"(max |sum| {e_max}); missing party error {miss_err:.3e} (> "
        f"{MISSING_PARTY_MIN_ERR}); Shamir error {shamir_err:.3e}; "
        f"{time.perf_counter() - t0:.3f} s")
    return miss_err, shamir_err


# ---------------------------------------------------------------------------
# phase 8: the model round; step 8b: MoE gradients and decode
# ---------------------------------------------------------------------------


def client_soft_label_loss(cfg, ax):
    """The FL client's sensitivity loss (src/repro/fl/client.py,
    sensitivity_map): log-softmax of the logits' real-vocab columns against
    soft labels.  torch.func refuses checkpointing, so the forward runs
    with remat off (the same values)."""
    cfg = dataclasses.replace(cfg, remat=False)

    def loss_of_y(p, feats, y):
        logits, _ = transformer.forward_logits(p, dict(feats), cfg, ax)
        logp = torch.log_softmax(logits[..., :cfg.vocab].float(), dim=-1)
        return -torch.mean(torch.sum(y * logp, dim=-1))
    return loss_of_y


def on_device(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def one_hot(labels, vocab):
    y = torch.zeros(*labels.shape, vocab, dtype=torch.float32,
                    device=labels.device)
    return y.scatter_(-1, labels.long()[..., None], 1.0)


def model_round(seed, cfg, make_ctx, dev, want_leaves):
    """Phase 8: the paper's round on a real model.  Build and initialise
    `cfg` on `dev`; each client's sensitivity map of the global model (one
    batch, SENS_PROBES probes); the top-p mask of their plain mean (the
    orchestrator's threshold-mode branch); LOCAL_STEPS AdamW steps per
    client from the global model (FLClient's local_train); then keygen,
    client_protect, server_aggregate and client_recover_params.  Returns
    its launch counts and numbers."""
    sync = torch.cuda.synchronize
    times, steps = {}, []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()

    t = time.perf_counter()
    model = models.build_model(cfg, device=dev)
    glob = model.init(torch.Generator(device=dev).manual_seed(seed))
    sync()
    times["build_model + init"] = time.perf_counter() - t
    shapes = map_tree(lambda p: tuple(p.shape), glob)
    n_params = sum(math.prod(s) for s in leaves(shapes))
    if shapes != want_leaves or n_params != cfg.param_count():
        raise AssertionError(f"model_round: parameter tree {shapes} "
                             f"({n_params}) is not the expected layout")
    streams = make_client_streams(N_CLIENTS, cfg.vocab, seq_len=MODEL_SEQ,
                                  batch_size=MODEL_BATCH,
                                  alpha=DIRICHLET_ALPHA, seed=seed)

    loss_of_y = client_soft_label_loss(cfg, model.ax)
    sens = 0
    for i, stream in enumerate(streams):
        batch = on_device(stream.next_batch(), dev)
        t = time.perf_counter()
        smap = sensitivity.sensitivity_jvp(
            loss_of_y, glob, {"tokens": batch["tokens"]},
            one_hot(batch["labels"], cfg.vocab),
            torch.Generator(device=dev).manual_seed(seed + 20 + i),
            n_probes=SENS_PROBES)
        vec, _ = packing.flatten_params(smap)
        del smap
        sens = sens + vec / N_CLIENTS
        sync()
        times[f"sensitivity_jvp[{i}]"] = time.perf_counter() - t
    del vec

    t = time.perf_counter()
    ctx = make_ctx()
    sk, pk = cipher.keygen(ctx, torch.Generator(device=ctx.device)
                           .manual_seed(seed))
    sync()
    times["make_context + keygen"] = time.perf_counter() - t
    t = time.perf_counter()
    agg = SelectiveHEAggregator.build(
        ctx, glob, sens, AggregatorConfig(p_ratio=P_RATIO, strategy="top_p"))
    del sens
    sync()
    times["build (top-p mask of the mean map)"] = time.perf_counter() - t
    rep = agg.overhead_report()
    log(f"model_round: {rep['n_enc']}/{rep['n_total']} parameters "
        f"encrypted in {rep['n_ciphertexts']} ciphertexts per client")
    if rep["n_ciphertexts"] != n_ciphertexts(ctx.slots):
        raise AssertionError(f"model_round: unexpected partition {rep}")

    opt_cfg = AdamWConfig(lr=LOCAL_LR, weight_decay=0.0)
    step = models.value_and_grad(model.loss_fn)
    updates, expect, seen = [], 0, []
    for i, stream in enumerate(streams):
        params, opt_state = glob, adamw_init(glob)
        for s in range(LOCAL_STEPS):
            batch = on_device(stream.next_batch(), dev)
            seen.append(batch)
            t = time.perf_counter()
            loss, grads = step(params, batch)
            params, opt_state, _ = adamw_update(grads, opt_state, params,
                                                opt_cfg)
            sync()
            dt = time.perf_counter() - t
            steps.append(dt)
            log(f"model_round client {i} step {s}: loss {float(loss):.4f}, "
                f"{dt * 1e3:.1f} ms, {MODEL_BATCH * MODEL_SEQ / dt:.0f} "
                "tokens/s")
        del grads, opt_state
        t = time.perf_counter()
        updates.append(agg.client_protect(
            params, pk, torch.Generator(device=ctx.device).manual_seed(
                seed + 10 + i)))
        sync()
        times[f"client_protect[{i}]"] = time.perf_counter() - t
        expect = expect + packing.flatten_params(params)[0]
        del params

    t = time.perf_counter()
    aggregate = agg.server_aggregate(updates, [1 / N_CLIENTS] * N_CLIENTS)
    sync()
    times["server_aggregate"] = time.perf_counter() - t
    del updates
    t = time.perf_counter()
    recovered = agg.client_recover_params(aggregate, sk)
    sync()
    times["client_recover_params"] = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    report_times("model_round", times, t0)
    err = check_recovered("model_round", recovered, expect / N_CLIENTS)
    check_launches("model_round", counts)

    # The federation's objective: the mean loss over the batches the
    # clients trained on must fall.  A fresh batch's loss is printed, not
    # held: in two steps nothing in these streams carries over to unseen
    # tokens (PERF.md §6).
    fresh = on_device(streams[0].next_batch(), dev)
    with torch.no_grad():
        mean_loss = lambda p: sum(float(model.loss_fn(p, b))
                                  for b in seen) / len(seen)
        loss0, loss1 = mean_loss(glob), mean_loss(recovered)
        fresh0 = float(model.loss_fn(glob, fresh))
        fresh1 = float(model.loss_fn(recovered, fresh))
    log(f"model_round: mean loss over the clients' {len(seen)} training "
        f"batches {loss0:.4f} (initial model) -> {loss1:.4f} (encrypted "
        f"FedAvg of {N_CLIENTS} clients); on a fresh batch {fresh0:.4f} -> "
        f"{fresh1:.4f}")
    if not (math.isfinite(loss1) and loss1 < loss0
            and math.isfinite(fresh1)):
        raise AssertionError(f"model_round: loss {loss1} (fresh {fresh1}) "
                             f"is not finite and below the initial {loss0}")
    return counts, {"err": err, "loss0": loss0, "loss1": loss1,
                    "fresh0": fresh0, "fresh1": fresh1,
                    "peak_gib": peak, "steps": steps,
                    "sens_s": [times[f"sensitivity_jvp[{i}]"]
                               for i in range(N_CLIENTS)],
                    "n_ciphertexts": rep["n_ciphertexts"],
                    "model": model, "glob": glob, "batch": fresh}


def profiled_step(mr, stats):
    """One local AdamW step of the global model under torch.profiler (the
    round's own steps run unprofiled, for their times)."""
    model, glob, batch = mr.pop("model"), mr.pop("glob"), mr.pop("batch")
    with traced("model_step", stats):
        _, grads = models.value_and_grad(model.loss_fn)(glob, batch)
        adamw_update(grads, adamw_init(glob), glob,
                     AdamWConfig(lr=LOCAL_LR, weight_decay=0.0))


def moe_gradients(seed, dev):
    """Step 8b: a full-width MoE loss and gradient (bf16 compute, remat) at
    B = 1, S = MOE_SEQ; the dropped share from obs's MoE counters."""
    cfg = configs.get_config(MOE_ARCH)
    model = models.build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    n_params = sum(p.numel() for p in leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{MOE_ARCH}: {n_params} parameters")
    batch = on_device(make_client_streams(1, cfg.vocab, seq_len=MOE_SEQ,
                                          batch_size=1, seed=seed)[0]
                      .next_batch(), dev)
    series = [(obs.counter("moe_token_assignments_total", layer=i,
                           kept="true"),
               obs.counter("moe_token_assignments_total", layer=i,
                           kept="false")) for i in range(cfg.n_layers)]
    before = [(k.value, d.value) for k, d in series]
    torch.cuda.reset_peak_memory_stats()
    obs.configure(enabled=True)
    try:
        t = time.perf_counter()
        loss, grads = models.value_and_grad(model.loss_fn)(params, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    finally:
        obs.configure(enabled=False)
    loss = float(loss)
    finite = all(bool(torch.isfinite(g).all()) for g in leaves(grads))
    kept = [k.value - k0 for (k, _), (k0, _) in zip(series, before)]
    dropped = [d.value - d0 for (_, d), (_, d0) in zip(series, before)]
    share = sum(dropped) / max(1, sum(kept) + sum(dropped))
    by_layer = [d / max(1, k + d) for k, d in zip(kept, dropped)]
    log(f"moe {MOE_ARCH}: {n_params} parameters, loss {loss:.4f} at B=1 "
        f"S={MOE_SEQ}, gradients finite: {finite}, dropped token-expert "
        f"assignments {share:.4f} (by layer: "
        f"{', '.join(f'{x:.3f}' for x in by_layer)}), loss+grad {dt:.3f} s, "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (math.isfinite(loss) and 0 < loss < 3 * math.log(cfg.vocab)
            and finite):
        raise AssertionError(f"moe: loss {loss} or gradients out of range")
    return share


def decode_check(seed, dev, arch=MODEL_ARCH, params=None):
    """DECODE_PREFIX tokens of prefill and DECODE_STEPS decode_steps against
    one prefill of all of them, float32 compute (step 8b for Qwen, 9b and
    9c for the ssm and hybrid families; `params`: weights to reuse)."""
    cfg = dataclasses.replace(configs.get_config(arch), dtype="float32")
    model = models.build_model(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    total = DECODE_PREFIX + DECODE_STEPS
    toks = on_device(make_client_streams(1, cfg.vocab, seq_len=total,
                                         batch_size=MODEL_BATCH, seed=seed)[0]
                     .next_batch(), dev)["tokens"]
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": toks[:, :DECODE_PREFIX]}, cache_len=total)
        for t in range(DECODE_PREFIX, total):
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": toks[:, t]})
        want, _ = model.prefill(params, {"tokens": toks}, cache_len=total)
    err = float((logits - want).abs().max())
    log(f"decode {arch} (float32): prefill {DECODE_PREFIX} + "
        f"{DECODE_STEPS} decode_steps vs prefill {total}: max |logit diff| "
        f"{err:.3e} (bound {DECODE_MAX_ERR}, logit std "
        f"{float(want.std()):.3f})")
    if not err < DECODE_MAX_ERR:
        raise AssertionError(f"decode {arch}: logits differ by {err}")
    return err


# ---------------------------------------------------------------------------
# phase 9: the FL loop at full width; steps 9b and 9c: the ssm and hybrid
# families
# ---------------------------------------------------------------------------


def launches(**counts):
    """A launch-count dict over every kernel, 0 where not given."""
    return {name: counts.get(name, 0) for name in KERNELS}


def fl_stage_launches(n_params, slots, n_clients=N_CLIENTS):
    """Predicted launches of the FL loop's stages for a model of n_params:
    stage 1 is keygen (2 ntt_fwd); stage 2 folds the sensitivity maps in
    blocks of SENSITIVITY_BLOCK_ROWS ciphertexts, each block three
    public-key encrypts (4 ntt_fwd, 2 mul_add each), one weighted_sum and a
    decrypt (mul_add, ntt_inv); a wire round is phase 4's (three seeded
    encrypts, one accumulate per blob, the decrypt) and an in-memory round
    phase 3's without keygen."""
    rows = -(-n_params // slots)
    blocks = -(-rows // secure_agg.SENSITIVITY_BLOCK_ROWS)
    enc = lambda k: dict(ntt_fwd=4 * k, mul_add=2 * k)
    mask = launches(ntt_fwd=enc(n_clients)["ntt_fwd"] * blocks,
                    mul_add=(enc(n_clients)["mul_add"] + 1) * blocks,
                    weighted_sum=blocks, ntt_inv=blocks)
    in_memory = launches(ntt_fwd=4 * n_clients, mul_add=2 * n_clients + 1,
                         weighted_sum=1, ntt_inv=1)
    return {"keys": launches(ntt_fwd=2), "mask": mask, "blocks": blocks,
            "rows": rows,
            "wire_round": launches(**EXPECTED_LAUNCHES["wire"]),
            "in_memory_round": in_memory}


def fl_clients(model, cfg, seed, seq):
    """N_CLIENTS FL clients on phase 8's synthetic non-IID streams."""
    streams = make_client_streams(N_CLIENTS, cfg.vocab, seq_len=seq,
                                  batch_size=MODEL_BATCH,
                                  alpha=DIRICHLET_ALPHA, seed=seed)
    return [FLClient(i, model, streams[i],
                     ClientConfig(local_steps=LOCAL_STEPS, lr=LOCAL_LR,
                                  sensitivity_probes=SENS_PROBES))
            for i in range(N_CLIENTS)]


class FedAvgProbe:
    """Wraps each client's local_train and local step (the package is not
    edited): the n_samples-weighted sum of a round's local models, the
    plaintext FedAvg the recovered global model is held against, and each
    local step's time (synchronized)."""

    def __init__(self, clients):
        self.acc, self.n, self.steps = None, 0, []
        for c in clients:
            self._wrap(c)

    def _wrap(self, c):
        train, step = c.local_train, c._step

        def timed_step(*args):
            t = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            self.steps.append(time.perf_counter() - t)
            return out

        def capture(glob):
            local, loss = train(glob)
            flat = packing.flatten_params(local)[0] * float(c.n_samples)
            self.acc = flat if self.acc is None else self.acc.add_(flat)
            self.n += c.n_samples
            return local, loss

        c._step, c.local_train = timed_step, capture

    def take(self):
        """The plaintext FedAvg of the round so far; starts the next."""
        expect = self.acc / self.n
        self.acc, self.n = None, 0
        return expect


def counted(what, fn, want, by_path, stats):
    """fn under the launch counters (0 just before, read just after),
    torch.profiler (host clock, device busy share) and the peak memory."""
    def run(*args):
        torch.cuda.reset_peak_memory_stats()
        st = {}
        ops.reset_launch_counts()
        with traced(what, st):
            out = fn(*args)
        by_path[what] = ops.launch_counts()
        st["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        stats[what] = st
        log(f"{what}: host clock {st['wall_ms'] / 1e3:.3f} s, device busy "
            f"share {st['busy_share']:.4f}, peak device memory "
            f"{st['peak_gib']:.2f} GiB")
        check_launches(what, by_path[what], want)
        return out
    return run


def fl_loop(seed, cfg, make_ctx, dev, want_leaves, ckpt_dir):
    """Phase 9: FLTask.run() of `cfg` -- keys, the encryption mask agreed
    over HE, FL_ROUNDS wire rounds with checkpoints -- then a fresh FLTask
    resuming from the checkpoints.  Returns its launch counts by stage and
    its numbers."""
    model = models.build_model(cfg, device=dev)
    clients = fl_clients(model, cfg, seed, MODEL_SEQ)
    probe = FedAvgProbe(clients)
    agg_cfg = AggregatorConfig(strategy="top_p", p_ratio=P_RATIO)
    run_cfg = FLRunConfig(
        n_rounds=FL_ROUNDS, ckpt_dir=ckpt_dir, ckpt_every=1, seed=seed,
        wire_policy=compress.WirePolicy(seed_ciphertexts=True,
                                        plain_codec=PLAIN_CODEC))
    ctx = make_ctx()
    want = fl_stage_launches(cfg.param_count(), ctx.slots)
    by_path, stats, out = {}, {}, {"map_s": []}
    task = counted("fl_keys", FLTask, want["keys"], by_path, stats)(
        model, clients, agg_cfg, run_cfg, ctx)
    n_params = sum(p.numel() for p in leaves(task.global_params))
    if n_params != cfg.param_count():
        raise AssertionError(f"fl_loop: {n_params} parameters")

    # stage 2: time each map and the HE fold; keep the maps for the checks
    for c in clients:
        def timed_map(p, real=c.sensitivity_map):
            t = time.perf_counter()
            smap = real(p)
            torch.cuda.synchronize()
            out["map_s"].append(time.perf_counter() - t)
            return smap
        c.sensitivity_map = timed_map
    real_agree = secure_agg.agree_sensitivity
    held = {}

    def agree(ctx_, pk, sk, maps, weights, gen):
        t = time.perf_counter()
        glob = real_agree(ctx_, pk, sk, maps, weights, gen)
        torch.cuda.synchronize()
        out["he_fold_s"] = time.perf_counter() - t
        held.update(maps=list(maps), glob=glob)
        return glob

    stage2 = counted("fl_mask", task.agree_encryption_mask, want["mask"],
                     by_path, stats)

    def agree_encryption_mask():
        secure_agg.agree_sensitivity = agree
        try:
            result = stage2()
        finally:
            secure_agg.agree_sensitivity = real_agree
        out.update(check_fl_mask(task, held.pop("maps"), held.pop("glob"),
                                 n_params))
        return result

    real_round = task.run_round

    def run_round(rnd):
        log_ = counted(f"fl_round_{rnd}", real_round, want["wire_round"],
                       by_path, stats)(rnd)
        out.setdefault("round_err", []).append(check_recovered(
            f"fl_round_{rnd}", task.global_params, probe.take(),
            shapes=want_leaves))
        return log_

    task.agree_encryption_mask = agree_encryption_mask
    task.run_round = run_round
    logs = task.run()
    part = task.aggregator.part
    up = uplink_blob_bytes(part.n_chunks, ctx.n_limbs, ctx.n_poly,
                           part.n_plain)
    down = downlink_blob_bytes(part.n_chunks, ctx.n_limbs, ctx.n_poly,
                               part.n_plain)
    for lg in logs:
        log(f"fl RoundLog: {json.dumps(dataclasses.asdict(lg))}")
    if [lg.round for lg in logs] != list(range(FL_ROUNDS)):
        raise AssertionError(f"fl_loop: rounds {[lg.round for lg in logs]}")
    for lg in logs:
        if not (lg.comm_measured and lg.n_participating == N_CLIENTS
                and lg.comm_up_bytes == N_CLIENTS * up
                and lg.comm_down_bytes == N_CLIENTS * down
                and lg.comm_bytes == lg.comm_up_bytes + lg.comm_down_bytes
                and math.isfinite(lg.loss)):
            raise AssertionError(
                f"fl_loop round {lg.round}: {lg} against {N_CLIENTS} x "
                f"({up} up, {down} down) bytes of the frame layout")

    # resume: a fresh task on the same checkpoints runs no round
    t = time.perf_counter()
    task2 = FLTask(model, clients, agg_cfg, run_cfg, ctx)
    task2.aggregator, task2.server = task.aggregator, task.server
    if task2.run() or task2._start_round != FL_ROUNDS:
        raise AssertionError(f"fl_loop: the fresh task resumed at round "
                             f"{task2._start_round}, not {FL_ROUNDS}")
    same = all(torch.equal(a, b) for a, b in zip(
        leaves(task.global_params), leaves(task2.global_params)))
    log(f"fl resume: a fresh FLTask on the checkpoints starts at round "
        f"{task2._start_round} and runs no round; global parameters "
        f"bit-identical to round {FL_ROUNDS - 1}'s: {same} "
        f"({time.perf_counter() - t:.3f} s)")
    if not same:
        raise AssertionError("fl_loop: resumed parameters differ")
    out.update(logs=logs, stats=stats, steps=probe.steps,
               n_chunks=part.n_chunks, up=up, down=down)
    return by_path, out


def check_fl_mask(task, maps, glob, n_params):
    """Stage 2's checks: the decrypted global map within the CKKS bound of
    the maps' plaintext mean; the mask's size; its overlap with the
    plaintext mean's mask (printed: at init the maps may sit near the CKKS
    noise)."""
    plain = sum(maps) / len(maps)
    del maps
    err = float((glob - plain).abs().max())
    part = task.aggregator.part
    n_mask = int(round(P_RATIO * n_params))
    overlap = int((part.mask.to(plain.device)
                   & selection.top_p_mask(plain, P_RATIO)).sum())
    log(f"fl_mask: HE global map vs the plaintext mean of {N_CLIENTS} maps: "
        f"max |diff| {err:.3e} (bound {MAX_ERR}; map max "
        f"{float(plain.abs().max()):.3e}, mean {float(plain.mean()):.3e}); "
        f"mask {part.n_enc} of {part.n_total} in {part.n_chunks} "
        f"ciphertexts a client; overlap with the plaintext mean's mask "
        f"{overlap / max(1, n_mask):.4f}")
    if not err < MAX_ERR:
        raise AssertionError(f"fl_mask: global map error {err}")
    if part.n_enc != n_mask or part.n_total != n_params:
        raise AssertionError(f"fl_mask: the mask holds {part.n_enc} of "
                             f"{part.n_total}, not {n_mask}")
    return {"map_err": err, "overlap": overlap / max(1, n_mask)}


def ssm_fl(seed, cfg, ctx, dev, n_params):
    """Step 9b: one in-memory FLTask round of `cfg` (three clients, two
    local AdamW steps of B x SSM_SEQ, the HE mask); returns its launch
    counts and numbers."""
    model = models.build_model(cfg, device=dev)
    clients = fl_clients(model, cfg, seed, SSM_SEQ)
    probe = FedAvgProbe(clients)
    want = fl_stage_launches(n_params, ctx.slots)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    task = FLTask(model, clients,
                  AggregatorConfig(strategy="top_p", p_ratio=P_RATIO),
                  FLRunConfig(n_rounds=1, seed=seed), ctx)
    logs = task.run()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    counts = ops.launch_counts()
    shapes = map_tree(lambda p: tuple(p.shape), task.global_params)
    if sum(math.prod(s) for s in leaves(shapes)) != n_params:
        raise AssertionError(f"ssm_fl: not {n_params} parameters")
    err = check_recovered(f"ssm_fl ({cfg.name})", task.global_params,
                          probe.take(), shapes=shapes)
    check_launches("ssm_fl", counts, {
        k: want["keys"][k] + want["mask"][k] + want["in_memory_round"][k]
        for k in KERNELS})
    n_chunks = task.aggregator.part.n_chunks
    if n_chunks != -(-int(round(P_RATIO * n_params)) // ctx.slots):
        raise AssertionError(f"ssm_fl: {n_chunks} ciphertexts a client")
    tokens = MODEL_BATCH * SSM_SEQ
    log(f"ssm_fl {cfg.name}: {n_params} parameters, {n_chunks} ciphertexts "
        f"a client, local steps "
        f"{', '.join(f'{s * 1e3:.1f}' for s in probe.steps)} ms "
        f"({tokens / min(probe.steps):.0f} tokens/s at the fastest), "
        f"RoundLog loss {logs[0].loss:.4f}, FedAvg error {err:.3e}, host "
        f"clock {host_s:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, {"err": err, "steps": probe.steps, "host_s": host_s,
                    "n_chunks": n_chunks}


def hybrid_gradients(seed, arch, dev, n_params):
    """Step 9c: the loss and gradient of `arch` at B = 1, S = HYBRID_SEQ
    (bf16 compute, float32 master weights, remat), then decode against
    prefill on the same weights in float32."""
    cfg = configs.get_config(arch)
    model = models.build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    got = sum(p.numel() for p in leaves(params))
    if not got == n_params == cfg.param_count():
        raise AssertionError(f"{cfg.name}: {got} parameters")
    batch = on_device(make_client_streams(1, cfg.vocab, seq_len=HYBRID_SEQ,
                                          batch_size=1, seed=seed)[0]
                      .next_batch(), dev)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, grads = models.value_and_grad(model.loss_fn)(params, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(loss)
    finite = all(bool(torch.isfinite(g).all()) for g in leaves(grads))
    del grads
    log(f"hybrid {cfg.name}: {got} parameters, loss {loss:.4f} at B=1 "
        f"S={HYBRID_SEQ}, gradients finite: {finite}, loss+grad {dt:.3f} s, "
        f"peak device memory {peak:.2f} GiB")
    if not (math.isfinite(loss) and 0 < loss < 3 * math.log(cfg.vocab)
            and finite):
        raise AssertionError(f"hybrid: loss {loss} or gradients out of "
                             "range")
    err = decode_check(seed, dev, arch, params)
    return {"loss": loss, "grad_s": dt, "peak_gib": peak, "decode_err": err}



# ---------------------------------------------------------------------------
# phase 10: the aggregation service at full width
# ---------------------------------------------------------------------------

# Phase 10 sends phase 4's three blobs through serve.AggregationService,
# with a fourth: blob 0 re-labelled cid 3 (sim.rewrite_begin) with one
# CT_CHUNK frame dropped (faults.corrupt_blob "drop").  Each good blob
# folds in one weighted_accum_chunks launch (the wire round's count); the
# fourth fails StreamIngest's chunk-count check before its flush, so it
# launches nothing.  (a) one fold_batch takes all four: blobs 0-2 (3
# launches), the reject, then one refold of the three survivors (3 more).
# (b) folds SERVE_FOLD_BATCH blobs a step: the crashed service folds blobs
# 0 and 1 (2 launches) and crashes after that step's checkpoint; the
# resumed one restores the accumulator (no kernel) and folds blob 2 (1).
# Nothing else launches: the result is the ingest's finalize, a gather.
SERVE_FOLD_BATCH = 2
SERVE_LAUNCHES = {
    "serve_fault": launches(weighted_accum_chunks=3 + N_CLIENTS),
    "serve_crash": launches(weighted_accum_chunks=SERVE_FOLD_BATCH),
    "serve_resume": launches(
        weighted_accum_chunks=N_CLIENTS - SERVE_FOLD_BATCH),
}
SERVE_WAIT_S = 900.0    # a round that is not DONE by then fails the phase


def wait_for(svc, done, what):
    """Poll until done() holds or the worker parks an error; raise on
    timeout."""
    t_end = time.perf_counter() + SERVE_WAIT_S
    while not done() and svc.worker_error is None:
        if time.perf_counter() > t_end:
            raise AssertionError(f"{what}: not done in {SERVE_WAIT_S} s")
        time.sleep(0.01)


def check_serve_result(what, glob, ref):
    """The service's aggregate against phase 4's, bit for bit."""
    if not torch.equal(glob.ct.data.cpu(), ref["ct"]):
        raise AssertionError(f"{what}: the aggregate's residues differ "
                             "from phase 4's")
    if not torch.equal(glob.plain.cpu().view(torch.int32),
                       ref["plain"].view(torch.int32)):
        raise AssertionError(f"{what}: the plain sum differs from phase "
                             "4's")
    if glob.ct.scale != ref["scale"]:
        raise AssertionError(f"{what}: scale {glob.ct.scale} != "
                             f"{ref['scale']}")


@contextlib.contextmanager
def obs_spans(out):
    """Telemetry on, in memory, over a block (obs's kernel hooks then
    synchronize each kernel op); at its end each span is appended to
    `out` as (name, args, seconds), and telemetry is off again."""
    obs.configure(enabled=True, trace_path=None, reset=True)
    try:
        yield
        out.extend((e["name"], e["args"], e["dur"] / 1e6)
                   for e in obs.get_tracer().events if e.get("ph") == "X")
    finally:
        obs.configure(enabled=False, trace_path=None, reset=True)


def serve_phase(seed, ref, by_path):
    """Phase 10: (a) a faulty fourth blob rejected at fold time and one
    refold, on the worker thread, in memory; (b) a crash after the first
    fold step, checkpointed to a temporary directory, resumed from it.
    Both aggregates must equal phase 4's bit for bit."""
    ctx = params.make_context()
    blobs, stats = ref["blobs"], {}
    bad_cid = N_CLIENTS
    t = time.perf_counter()
    bad = serve_faults.corrupt_blob(
        serve_sim.rewrite_begin(blobs[0], cid=bad_cid), "drop",
        np.random.RandomState(seed))
    log(f"serve: the faulty blob (cid {bad_cid}, one CT_CHUNK dropped) "
        f"{len(bad)} bytes in {time.perf_counter() - t:.3f} s")
    pol = serve.QuorumPolicy(min_clients=N_CLIENTS)

    # (a) fault and refold, in memory, on the worker thread
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    st = {}
    with traced("serve_fault", st):
        svc = serve.AggregationService(ctx, pol)
        svc.start()
        try:
            rnd = svc.open_round()
            for b in blobs + [bad]:
                if not svc.submit(b).accepted:
                    raise AssertionError("serve_fault: a blob was refused "
                                         "at the door")
            svc.seal()
            wait_for(svc, lambda: svc.status(rnd) in (serve.ST_DONE,
                                                      serve.ST_FAILED),
                     "serve_fault")
        finally:
            svc.stop()
        if svc.worker_error is not None:
            raise svc.worker_error
        glob = svc.result(rnd)
    by_path["serve_fault"] = ops.launch_counts()
    st["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    stats["serve_fault"] = st
    info = svc.round_info(rnd)
    log(f"serve_fault: round_info {json.dumps(info)}")
    if not (info["bad_after_accept"] == 1 and info["refolds"] == 1
            and info["folded"] == N_CLIENTS
            and info["rejected"] == {"wire:WireError": 1}):
        raise AssertionError("serve_fault: not one fold reject and one "
                             "refold")
    check_serve_result("serve_fault", glob, ref)
    check_launches("serve_fault", by_path["serve_fault"],
                   SERVE_LAUNCHES["serve_fault"])
    del svc, glob
    torch.cuda.empty_cache()

    # (b) crash after the first fold step, resume from the checkpoint
    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        log(f"serve_crash: checkpoint directory with {free / 1e9:.1f} GB "
            "free")
        spans, ledger = [], budget.BandwidthLedger()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        st = {}
        with obs_spans(spans), traced("serve_crash", st):
            inj = serve.FaultInjector(crash_at=["after_fold_step"])
            svc = serve.AggregationService(
                ctx, pol, ckpt_dir=d, fold_batch=SERVE_FOLD_BATCH,
                faults=inj, ledger=ledger)
            svc.start()
            try:
                rnd = svc.open_round()
                for i, b in enumerate(blobs):
                    t = time.perf_counter()
                    if not svc.submit(b).accepted:
                        raise AssertionError("serve_crash: a blob was "
                                             "refused at the door")
                    log(f"serve_crash: submit[{i}] (spool + ledger) "
                        f"{time.perf_counter() - t:.3f} s")
                svc.seal()
                wait_for(svc, lambda: False, "serve_crash")
            finally:
                svc.stop()
        by_path["serve_crash"] = ops.launch_counts()
        st["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        stats["serve_crash"] = st
        if not (isinstance(svc.worker_error, serve.SimulatedCrash)
                and inj.fired == ["after_fold_step"]):
            raise AssertionError(f"serve_crash: the worker ended with "
                                 f"{svc.worker_error!r}, not the crash")
        check_launches("serve_crash", by_path["serve_crash"],
                       SERVE_LAUNCHES["serve_crash"])
        del svc
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        st = {}
        with obs_spans(spans), traced("serve_resume", st):
            led2 = budget.BandwidthLedger()
            t = time.perf_counter()
            svc = serve.AggregationService.resume(
                d, ctx, pol, fold_batch=SERVE_FOLD_BATCH, ledger=led2)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t
            svc.start()
            try:
                wait_for(svc, lambda: svc.status(rnd) in (serve.ST_DONE,
                                                          serve.ST_FAILED),
                         "serve_resume")
            finally:
                svc.stop()
            if svc.worker_error is not None:
                raise svc.worker_error
            glob = svc.result(rnd)
        by_path["serve_resume"] = ops.launch_counts()
        st["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        stats["serve_resume"] = st
        info = svc.round_info(rnd)
        log(f"serve_resume: round_info {json.dumps(info)}")
        check_serve_result("serve_resume", glob, ref)
        check_launches("serve_resume", by_path["serve_resume"],
                       SERVE_LAUNCHES["serve_resume"])
        up = led2.total(budget.UPLINK)
        if not up == ref["up_bytes"] == N_CLIENTS * ref["blob_bytes"]:
            raise AssertionError(f"serve_resume: the ledger's {up} uplink "
                                 f"bytes != phase 4's {ref['up_bytes']}")
        spool = sum(os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(os.path.join(d, "spool"))
                    for f in fs)
        ckpt_bytes = {name: os.path.getsize(os.path.join(d, name,
                                                         "payload.npz"))
                      for name in sorted(os.listdir(d))
                      if name.startswith("step_")}
        del svc, glob
    saves = [(args["label"], sec) for name, args, sec in spans
             if name == "serve.checkpoint"]
    for label, sec in saves:
        log(f"serve checkpoint save ({label}): {sec:.3f} s")
    log(f"serve: resume (restore + spool reload) {resume_s:.3f} s; "
        f"spool {spool} bytes; checkpoints kept {json.dumps(ckpt_bytes)}; "
        f"ledger uplink {up} bytes == phase 4's")
    for what in ("serve_fault", "serve_crash", "serve_resume"):
        s_ = stats[what]
        log(f"{what}: host clock {s_['wall_ms'] / 1e3:.3f} s, device busy "
            f"share {s_['busy_share']:.4f}, peak device memory "
            f"{s_['peak_gib']:.2f} GiB")
    return {"stats": stats, "saves": saves, "resume_s": resume_s,
            "up": up}


# ---------------------------------------------------------------------------
# phase 11: the training driver at full width
# ---------------------------------------------------------------------------

# launch.train's run: Qwen1.5-0.5B at full width and depth, B = 2 x S =
# 256, TRAIN_STEPS AdamW steps with a checkpoint every TRAIN_CKPT_EVERY
# (steps 2 and 5); then the same command on a copy of the checkpoints
# without step 5 resumes at step 3.  Restored state, the resumed losses
# and the final {"p", "o"} are held bit for bit: the card repeats them.
TRAIN_STEPS, TRAIN_CKPT_EVERY = 6, 3


class Tee:
    """Write to stdout and keep a copy."""

    def __init__(self):
        self.out, self.lines = sys.stdout, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def train_phase(dev):
    """Phase 11: launch.train.main twice on one checkpoint directory's
    history; returns its numbers."""
    argv = ["--arch", MODEL_ARCH, "--no-smoke", "--batch", str(MODEL_BATCH),
            "--seq", str(MODEL_SEQ), "--steps", str(TRAIN_STEPS),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--log-every", "1",
            "--device", dev.type]
    resume_at = TRAIN_CKPT_EVERY - 1
    last = f"step_{TRAIN_STEPS - 1:08d}"
    kept = f"step_{resume_at:08d}"
    spans1, spans2 = [], []
    with tempfile.TemporaryDirectory() as root:
        d1, d2 = os.path.join(root, "run1"), os.path.join(root, "run2")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with obs_spans(spans1):
            full = train_driver.main(argv + ["--ckpt-dir", d1])
        full_s = time.perf_counter() - t
        peak1 = torch.cuda.max_memory_allocated() / 2 ** 30
        n = sum(p.numel() for p in leaves(full["params"]))
        if n != N_PARAMS:
            raise AssertionError(f"train: {n} parameters, not {N_PARAMS}")
        if sorted(os.listdir(d1)) != [kept, last]:
            raise AssertionError(f"train: checkpoints {os.listdir(d1)}")
        shutil.rmtree(os.path.join(d1, last))
        shutil.copytree(d1, d2)
        # the restored {"p", "o"} against the bytes run 1 saved
        with open(os.path.join(d1, kept, "manifest.json")) as f:
            names = json.load(f)["names"]
        t = time.perf_counter()
        got_p, got_o, s = train_driver.restore(
            CheckpointManager(d2), full["params"], full["opt"], dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        got = packing.tree_leaves({"o": got_o, "p": got_p})
        with np.load(os.path.join(d1, kept, "payload.npz")) as saved:
            if s != resume_at or len(got) != len(names):
                raise AssertionError(f"train: restored step {s}")
            for i, (name, leaf) in enumerate(zip(names, got)):
                want = saved[f"a{i}"]
                host = leaf.cpu().numpy()
                if host.dtype != want.dtype or \
                        host.tobytes() != want.tobytes():
                    raise AssertionError(f"train: restored {name} differs "
                                         "from the saved bytes")
        del got_p, got_o, got
        shutil.rmtree(d1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tee = Tee()
        t = time.perf_counter()
        with obs_spans(spans2), contextlib.redirect_stdout(tee):
            resumed = train_driver.main(argv + ["--ckpt-dir", d2])
        resumed_s = time.perf_counter() - t
        peak2 = torch.cuda.max_memory_allocated() / 2 ** 30
    printed = "".join(tee.lines).splitlines()
    if printed[0] != f"resumed from step {resume_at}" or \
            resumed["start"] != resume_at + 1:
        raise AssertionError(f"train: the second run began with "
                             f"{printed[0]!r}")
    steps_after = list(range(resume_at + 1, TRAIN_STEPS))
    if sorted(resumed["losses"]) != steps_after:
        raise AssertionError(f"train: resumed steps {resumed['losses']}")
    for i in steps_after:
        if not torch.equal(resumed["losses"][i], full["losses"][i]):
            raise AssertionError(
                f"train: step {i}'s resumed loss "
                f"{float(resumed['losses'][i])!r} != the uninterrupted "
                f"run's {float(full['losses'][i])!r}")
    state = lambda run: packing.tree_leaves({"o": run["opt"],
                                             "p": run["params"]})
    for i, (a, b) in enumerate(zip(state(resumed), state(full))):
        if not torch.equal(a, b):
            raise AssertionError(
                f"train: final state leaf {i} differs from the "
                f"uninterrupted run's by {float((a - b).abs().max()):.3e}")
    tokens = MODEL_BATCH * MODEL_SEQ
    step_s = {}
    for what, run, spans in (("run 1", full, spans1),
                             ("run 2", resumed, spans2)):
        step_s = {a["step"]: sec for name, a, sec in spans
                  if name == "train.step"}
        if sorted(step_s) != sorted(run["losses"]):
            raise AssertionError(f"train {what}: step spans {step_s}")
        log(f"train {what}: " + "; ".join(
            f"step {i} loss {float(run['losses'][i]):.6f} "
            f"{step_s[i]:.3f} s ({tokens / step_s[i]:.0f} tokens/s)"
            for i in sorted(step_s)))
        log(f"train {what}: checkpoint saves " + ", ".join(
            f"step {a['step']} {sec:.3f} s" for name, a, sec in spans
            if name == "train.checkpoint"))
    driver_restore_s = next(sec for name, _, sec in spans2
                            if name == "train.restore")
    log(f"train: run 1 {full_s:.3f} s (peak {peak1:.2f} GiB), restore "
        f"check {restore_s:.3f} s, run 2 {resumed_s:.3f} s (its restore "
        f"{driver_restore_s:.3f} s, peak {peak2:.2f} GiB); resumed losses "
        "and final parameters and moments bit-equal")
    return {"start": resumed["start"], "resumed_step_s": step_s,
            "peak_gib": max(peak1, peak2), "restore_s": restore_s}


# ---------------------------------------------------------------------------
# phase 12: the placed steps on a one-rank mesh, and the dry-run
# ---------------------------------------------------------------------------

PLACED_STEPS = 2
DRYRUN_CELLS = (("--arch", MODEL_ARCH, "--shape", "train_4k", "--mesh",
                 "both"),
                ("--he-agg", "--mesh", "single"))
MESH_AXIS_SIZES = {"single": {"data": 16, "model": 16},
                   "multi": {"pod": 2, "data": 16, "model": 16}}


def bit_equal(what, got, want):
    """Every leaf of got (a DTensor's local value on the one-rank mesh)
    equals want's, dtype, shape and bits."""
    g, w = packing.tree_leaves(got), packing.tree_leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{what}: {len(g)} leaves, not {len(w)}")
    for i, (a, b) in enumerate(zip(g, w)):
        a = a.to_local() if hasattr(a, "to_local") else a
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            err = float((a.float() - b.float()).abs().max()) \
                if a.shape == b.shape else float("nan")
            raise AssertionError(f"{what}: leaf {i} {tuple(b.shape)} "
                                 f"differs by {err:.3e}")


def production_mesh_error(multi_pod):
    try:
        he_mesh.make_production_mesh(multi_pod=multi_pod)
    except RuntimeError as e:
        return str(e)
    raise AssertionError("make_production_mesh built a mesh on one card")


def timed_steps(step, p, o, batches):
    times, out = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, o, met = step(p, o, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        out.append(met)
    return p, o, out, times


def spec_bytes(tree, specs, sizes):
    """Per-rank bytes of a nested dict of tensors placed by its specs (the
    JAX package's spec arithmetic: each dim over the product of the sizes
    its entry names)."""
    total = 0
    for leaf, spec in zip(leaves(tree), leaves(specs)):
        n = 1
        for i, size in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= size // math.prod(sizes[a] for a in axes)
        total += n * leaf.element_size()
    return total


def check_dryrun(out_dir):
    """Run the dry-run cells in a subprocess; hold each model artifact's
    per-rank parameter and optimiser bytes against the spec arithmetic."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    for args in DRYRUN_CELLS:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
             out_dir, "--force", *args], env=env, capture_output=True,
            text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"dryrun {' '.join(args)}: exit "
                                 f"{proc.returncode}\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith(("OK", "done")):
                log(f"dryrun: {line}")
        log(f"dryrun {' '.join(args)}: {time.perf_counter() - t:.1f} s")
    cfg = configs.get_config(MODEL_ARCH)
    p_abs = transformer.init_abstract(cfg)
    for mesh_name, sizes in MESH_AXIS_SIZES.items():
        with open(os.path.join(out_dir, f"{MODEL_ARCH}_train_4k_"
                                        f"{mesh_name}.json")) as f:
            art = json.load(f)
        data = tuple(a for a in ("pod", "data") if a in sizes)
        ax = sharding.AxisEnv(data=data, data_size=math.prod(
            sizes[a] for a in data), model_size=sizes["model"])
        pspecs = sharding.param_specs(p_abs, ax)
        want_p = spec_bytes(p_abs, pspecs, sizes)
        f32 = lambda t: torch.empty(t.shape, dtype=torch.float32,
                                    device="meta")
        want_o = 2 * spec_bytes(packing.tree_map(f32, p_abs), pspecs,
                                sizes) + 4
        mem, by = art["memory"], art["memory"]["argument_bytes_by_input"]
        if (by["params"], by["opt"]) != (want_p, want_o) or \
                art["n_devices"] != math.prod(sizes.values()):
            raise AssertionError(
                f"dryrun {mesh_name}: params {by['params']} / opt "
                f"{by['opt']} bytes a rank, spec arithmetic {want_p} / "
                f"{want_o}")
        colls = art["collectives"]
        log(f"dryrun {MODEL_ARCH} train_4k {mesh_name} "
            f"({art['n_devices']} fake ranks): per rank params {want_p} B, "
            f"opt {want_o} B, batch {by['batch']} B (argument "
            f"{mem['argument_bytes']} B), output {mem['output_bytes']} B, "
            f"peak live {mem['peak_hbm_bytes']} B; collectives "
            f"{json.dumps(colls['counts'])}, bytes "
            f"{json.dumps(colls['by_op_bytes'])}; roofline (H100 peaks) "
            f"compute {art['roofline']['compute_s'] * 1e3:.1f} ms, memory "
            f"{art['roofline']['memory_s'] * 1e3:.1f} ms, collective "
            f"{art['roofline']['collective_s'] * 1e3:.1f} ms")
    with open(os.path.join(out_dir, f"{MODEL_ARCH}_he_agg_single.json")) \
            as f:
        he = json.load(f)["he"]
    log(f"dryrun he_agg single: {he['n_chunks']} ciphertexts and "
        f"{he['n_plain']} plain values a client, "
        f"{he['wire_bytes_per_client']} wire bytes a client, slot grid "
        f"{he['slot_grid']}, slot in/out bytes {max(he['slot_in_bytes'])}"
        f" / {max(he['slot_out_bytes'])}, launches a block "
        f"{he['launches_per_block']}")


def placed_phase(seed, dev):
    """Phase 12; returns its numbers."""
    import torch.distributed as dist
    out = {}
    msg = production_mesh_error(False)
    if "mesh (16, 16) needs 256 ranks but only 0 exist" not in msg:
        raise AssertionError(f"make_production_mesh: {msg!r}")
    log(f"placed: make_production_mesh() without a group: {msg}")
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            for multi, want in ((False, "mesh (16, 16) needs 256 ranks but "
                                        "only 1 exist"),
                                (True, "mesh (2, 16, 16) needs 512 ranks "
                                       "but only 1 exist")):
                msg = production_mesh_error(multi)
                if want not in msg:
                    raise AssertionError(f"make_production_mesh: {msg!r}")
            mesh = he_mesh.make_model_mesh((1, 1), ("data", "model"))
            out.update(placed_steps(seed, dev, mesh))
        finally:
            dist.destroy_process_group()
        check_launches("placed", ops.launch_counts(), launches())
        t = time.perf_counter()
        check_dryrun(os.path.join(d, "dryrun"))
        out["dryrun_s"] = time.perf_counter() - t
    return out


def placed_steps(seed, dev, mesh):
    """Phase 12(b): the jit_* steps on the (1, 1) mesh against the same
    steps unplaced."""
    cfg = configs.get_config(MODEL_ARCH)
    plain = models.build_model(cfg, device=dev)
    placed = models.build_model(cfg, sharding.axis_env_from_mesh(mesh),
                                device=dev)
    p0 = plain.init(torch.Generator(device=dev).manual_seed(seed))
    o0 = adamw_init(p0)
    stream = make_client_streams(1, cfg.vocab, seq_len=MODEL_SEQ,
                                 batch_size=MODEL_BATCH, seed=seed)[0]
    batches = [on_device(stream.next_batch(), dev)
               for _ in range(PLACED_STEPS)]
    opt_cfg = AdamWConfig()
    want_p, want_o, want_m, plain_s = timed_steps(
        model_steps.make_train_step(plain, opt_cfg), p0, o0, batches)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got_p, got_o, got_m, placed_s = timed_steps(
        model_steps.jit_train_step(placed, mesh, opt_cfg, batches[0]), p0,
        o0, batches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (g, w) in enumerate(zip(got_m, want_m)):
        bit_equal(f"placed step {i} metrics", g, w)
    bit_equal("placed parameters", got_p, want_p)
    bit_equal("placed moments", got_o, want_o)
    del got_p, got_o, want_p, want_o
    torch.cuda.empty_cache()
    prompt = {"tokens": batches[0]["tokens"]}
    with torch.no_grad():
        t = time.perf_counter()
        want = model_steps.make_prefill_step(plain)(p0, prompt)
        torch.cuda.synchronize()
        pre_plain_s = time.perf_counter() - t
        t = time.perf_counter()
        got = model_steps.jit_prefill_step(placed, mesh, prompt)(p0, prompt)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t
        bit_equal("placed prefill", got, want)
        _, cache = plain.prefill(p0, prompt, cache_len=MODEL_SEQ + 1)
        tok = {"tokens": batches[0]["tokens"][:, -1]}
        t = time.perf_counter()
        want = model_steps.make_decode_step(plain)(p0, cache, tok)
        torch.cuda.synchronize()
        dec_plain_s = time.perf_counter() - t
        t = time.perf_counter()
        got = model_steps.jit_decode_step(placed, mesh, cache, tok,
                                          MODEL_BATCH)(p0, cache, tok)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t
        bit_equal("placed decode", got, want)
    tokens = MODEL_BATCH * MODEL_SEQ
    log(f"placed ({MODEL_ARCH} on a (1, 1) NCCL mesh, {tokens} tokens a "
        f"step): jit_train_step "
        + ", ".join(f"{s * 1e3:.1f}" for s in placed_s)
        + " ms (unplaced " + ", ".join(f"{s * 1e3:.1f}" for s in plain_s)
        + f" ms), loss {float(want_m[-1]['loss']):.6f}; prefill "
        f"{pre_s * 1e3:.1f} ms (unplaced {pre_plain_s * 1e3:.1f}), decode "
        f"{dec_s * 1e3:.1f} ms (unplaced {dec_plain_s * 1e3:.1f}); peak "
        f"{peak:.2f} GiB; losses, parameters, moments, logits and caches "
        "bit-equal to the unplaced steps")
    log("placed: replicate-before sites: "
        + "; ".join(sharding.REPLICATE_BEFORE))
    return {"steps_s": placed_s, "plain_s": plain_s, "prefill_s": pre_s,
            "decode_s": dec_s, "peak_gib": peak}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if sum(math.prod(s) for s in leaves(QWEN_LEAVES)) != N_PARAMS:
        raise AssertionError("Qwen1.5-0.5B leaf shapes do not add up")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    t = time.perf_counter()
    build.load_all()
    log(f"phase 1 build: {time.perf_counter() - t:.1f} s "
        f"({', '.join(build.SOURCES)} for sm_90a)")

    sms, mhz, int_rate = card_int_rate()
    log(f"card: {sms} SMs, max SM clock {mhz:.0f} MHz, "
        f"{int_rate / 1e12:.2f} T integer ops/s a pipe (multiply, ALU)")
    ctx = params.make_context()
    gen = torch.Generator(device=ctx.device).manual_seed(args.seed)
    rows = check_kernels(ctx, gen, n_ciphertexts(ctx.slots), int_rate)
    check_small_round_against_cpu(ctx, args.seed)
    slots = ctx.slots
    del ctx, gen
    torch.cuda.empty_cache()
    mask_rows, mask_launches = check_mask_kernels(args.seed, slots)
    rows.update(mask_rows)

    best4 = tuner_sweep(args.seed)
    torch.cuda.empty_cache()

    by_path = {"mask_kernels": mask_launches}
    with traced("in_memory"):
        by_path["in_memory"], state = in_memory_round(args.seed)
    by_path["ntt4_round"] = ntt4_round(args.seed, state, best4)
    del state["recovered"]
    torch.cuda.empty_cache()
    with traced("wire"):
        by_path["wire"] = wire_round(args.seed, state)
    checkpoint_step(state)
    # phase 10's reference: phase 4's blobs and aggregate, kept on the host
    serve_ref = {"plain": state.pop("wire_plain").cpu(),
                 "scale": state["wire_scale"],
                 "up_bytes": state.pop("ledger").total(budget.UPLINK),
                 "blob_bytes": len(state["blobs"][0])}
    torch.cuda.empty_cache()
    with traced("transcipher"):
        by_path["transcipher"], tc_out = transcipher_round(args.seed, state)
    check_transcipher_reference(args.seed, state, tc_out)
    del tc_out
    torch.cuda.empty_cache()
    with traced("sharded"):
        by_path["sharded"], sh_out = sharded_round(args.seed, state)
    check_launches("sharded", by_path["sharded"])
    check_sharded(args.seed, state, sh_out)
    del sh_out
    serve_ref.update(blobs=state["blobs"],
                     ct=state["wire_aggregate"].cpu())
    state = {k: state[k] for k in ("ctx", "sk", "agg", "model", "expect",
                                   "aggregate")}
    torch.cuda.empty_cache()
    th_stats = {}
    with tempfile.TemporaryDirectory() as d:
        trace_path = os.path.join(d, "threshold_trace.jsonl")
        try:
            with traced("threshold", th_stats):
                by_path["threshold"], th_out = threshold_round(
                    args.seed, state, trace_path)
            check_threshold_obs(trace_path, by_path["threshold"],
                                th_out["hooked"])
        finally:
            obs.configure(enabled=False, trace_path=None, reset=True)
    miss_err, shamir_err = check_threshold(args.seed, state, th_out)
    th_bound = threshold_bound(state["ctx"])
    del state, th_out["glob"], th_out["partials"], th_out["coeffs"]
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    by_path["model_round"], mr = model_round(
        args.seed, configs.get_config(MODEL_ARCH), params.make_context, dev,
        QWEN_LEAVES)
    step_stats = {}
    profiled_step(mr, step_stats)
    torch.cuda.empty_cache()
    moe_share = moe_gradients(args.seed, dev)
    torch.cuda.empty_cache()
    decode_err = decode_check(args.seed, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        fl_paths, fl = fl_loop(args.seed, configs.get_config(MODEL_ARCH),
                               params.make_context, dev, QWEN_LEAVES, d)
    by_path.update(fl_paths)
    gc.collect()          # the wrapped clients' closures hold cycles
    torch.cuda.empty_cache()
    by_path["ssm_fl"], ssm = ssm_fl(args.seed, configs.get_config(SSM_ARCH),
                                    params.make_context(), dev, SSM_PARAMS)
    ssm_decode = decode_check(args.seed, dev, SSM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    hyb = hybrid_gradients(args.seed, HYBRID_ARCH, dev, HYBRID_PARAMS)
    gc.collect()
    torch.cuda.empty_cache()
    srv = serve_phase(args.seed, serve_ref, by_path)
    del serve_ref
    gc.collect()
    torch.cuda.empty_cache()
    trn = train_phase(dev)
    by_path["train"] = launches()   # training launches no HE kernel
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    plc = placed_phase(args.seed, dev)
    plc["s"] = time.perf_counter() - t
    by_path["placed"] = launches()  # counted in placed_phase: none
    for name, row in rows.items():
        row["launches"] = sum(c.get(name, 0) for c in by_path.values())
        row["launches_by_path"] = {p: c.get(name, 0)
                                   for p, c in by_path.items()}

    log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    log(f"threshold round ({N_PARTIES} parties, Qwen1.5-0.5B width, obs "
        f"enabled): host clock {th_out['host_s']:.3f} s, device busy share "
        f"{th_stats['busy_share']:.4f} ({th_stats['busy_ms']:.3f} of "
        f"{th_stats['wall_ms']:.3f} ms), peak device memory "
        f"{th_out['peak_gib']:.2f} GiB, FedAvg error {th_out['err']:.3e} "
        f"(bound {th_bound:.4g}); Shamir {SHAMIR_T}-of-{SHAMIR_N} error "
        f"{shamir_err:.3e}; missing-party error {miss_err:.3e}")
    tokens = MODEL_BATCH * MODEL_SEQ
    log(f"model round ({MODEL_ARCH}, {N_CLIENTS} clients, {LOCAL_STEPS} "
        f"AdamW steps of {tokens} tokens each, bf16 compute, remat): local "
        f"steps {', '.join(f'{s * 1e3:.1f}' for s in mr['steps'])} ms "
        f"({tokens / min(mr['steps']):.0f} tokens/s at the fastest), "
        f"sensitivity_jvp ({SENS_PROBES} probes) "
        f"{', '.join(f'{s:.3f}' for s in mr['sens_s'])} s, "
        f"{mr['n_ciphertexts']} ciphertexts a client, FedAvg error "
        f"{mr['err']:.3e}, training-batch loss {mr['loss0']:.4f} -> "
        f"{mr['loss1']:.4f} (fresh batch {mr['fresh0']:.4f} -> "
        f"{mr['fresh1']:.4f}), peak device memory {mr['peak_gib']:.2f} GiB, "
        f"a profiled step's device busy share "
        f"{step_stats['busy_share']:.4f}; {MOE_ARCH} "
        f"dropped share {moe_share:.4f}; decode error {decode_err:.3e}")
    st = fl["stats"]
    log(f"FL loop ({MODEL_ARCH}, FLTask.run(), {N_CLIENTS} clients, "
        f"{LOCAL_STEPS} local AdamW steps of {tokens} tokens a round, "
        f"{FL_ROUNDS} wire rounds): keys {st['fl_keys']['wall_ms'] / 1e3:.3f}"
        f" s; mask {st['fl_mask']['wall_ms'] / 1e3:.3f} s (maps "
        f"{', '.join(f'{s:.3f}' for s in fl['map_s'])} s, HE fold "
        f"{fl['he_fold_s']:.3f} s, busy share "
        f"{st['fl_mask']['busy_share']:.4f}, peak "
        f"{st['fl_mask']['peak_gib']:.2f} GiB, map error {fl['map_err']:.3e},"
        f" mask overlap {fl['overlap']:.4f}); rounds "
        + "; ".join(
            f"{r}: {st[f'fl_round_{r}']['wall_ms'] / 1e3:.3f} s, busy share "
            f"{st[f'fl_round_{r}']['busy_share']:.4f}, peak "
            f"{st[f'fl_round_{r}']['peak_gib']:.2f} GiB, loss "
            f"{fl['logs'][r].loss:.4f}, FedAvg error {fl['round_err'][r]:.3e}"
            for r in range(FL_ROUNDS))
        + f"; {fl['n_chunks']} ciphertexts a client, bytes a round "
        f"{fl['logs'][0].comm_up_bytes} up / {fl['logs'][0].comm_down_bytes} "
        f"down (measured); local steps "
        f"{', '.join(f'{s * 1e3:.1f}' for s in fl['steps'])} ms")
    log(f"ssm and hybrid ({SSM_ARCH} in-memory FL round: local steps "
        f"{', '.join(f'{s * 1e3:.1f}' for s in ssm['steps'])} ms, "
        f"{MODEL_BATCH * SSM_SEQ / min(ssm['steps']):.0f} tokens/s at the "
        f"fastest, host clock {ssm['host_s']:.3f} s, FedAvg error "
        f"{ssm['err']:.3e}, decode error {ssm_decode:.3e}; {HYBRID_ARCH}: "
        f"loss {hyb['loss']:.4f}, loss+grad {hyb['grad_s']:.3f} s, peak "
        f"{hyb['peak_gib']:.2f} GiB, decode error {hyb['decode_err']:.3e})")
    sv = srv["stats"]
    log(f"aggregation service (phase 4's {N_CLIENTS} blobs): fault and "
        f"refold {sv['serve_fault']['wall_ms'] / 1e3:.3f} s (busy share "
        f"{sv['serve_fault']['busy_share']:.4f}, peak "
        f"{sv['serve_fault']['peak_gib']:.2f} GiB); crash "
        f"{sv['serve_crash']['wall_ms'] / 1e3:.3f} s (busy share "
        f"{sv['serve_crash']['busy_share']:.4f}); resume "
        f"{sv['serve_resume']['wall_ms'] / 1e3:.3f} s (its restore "
        f"{srv['resume_s']:.3f} s, busy share "
        f"{sv['serve_resume']['busy_share']:.4f}); checkpoint saves "
        + ", ".join(f"{lab} {sec:.3f} s" for lab, sec in srv["saves"])
        + f"; both aggregates == phase 4's bit for bit, ledger {srv['up']} "
        f"uplink bytes")
    ts = trn["resumed_step_s"]
    log(f"training driver ({MODEL_ARCH}, {TRAIN_STEPS} steps of "
        f"{MODEL_BATCH * MODEL_SEQ} tokens, resumed at step "
        f"{trn['start']}): resumed steps "
        + ", ".join(f"{ts[i] * 1e3:.1f}" for i in sorted(ts))
        + f" ms, losses and final parameters and moments bit-equal, peak "
        f"{trn['peak_gib']:.2f} GiB")
    log(f"placed steps ({MODEL_ARCH}, (1, 1) mesh): jit_train_step "
        + ", ".join(f"{x * 1e3:.1f}" for x in plc["steps_s"])
        + " ms against unplaced "
        + ", ".join(f"{x * 1e3:.1f}" for x in plc["plain_s"])
        + f" ms, prefill {plc['prefill_s'] * 1e3:.1f} ms, decode "
        f"{plc['decode_s'] * 1e3:.1f} ms, peak {plc['peak_gib']:.2f} GiB, "
        f"all bit-equal; dry-run {plc['dryrun_s']:.1f} s; phase 12 "
        f"{plc['s']:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(f"card: {sms} SMs, max SM clock {mhz:.0f} MHz")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
